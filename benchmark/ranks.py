"""The ranks of a sharded cell, one process a card: rank 0 is the
harness's own process, ranks 1 .. world - 1 are ``torch.multiprocessing``
children (method ``spawn``) that run ``worker``. All join one process
group through a ``FileStore`` in a fresh temporary directory.

Every rank makes the cell's texts from the seed on its own device, then
runs what rank 0 broadcasts, one ``int64`` a command: a job over text
``i >= 0``, the window's open or close, or stop. A job is the user's call,
``build_index(text, BuildConfig(sharded=True, n_devices=world))``, on
every rank.

This module is importable by name (a ``spawn`` child unpickles its
function from it); the runner is loaded by path and cannot be.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
import time
import traceback

OPEN, CLOSE, STOP = -1, -2, -3


def device_of(device_type: str, rank: int):
    import torch

    if device_type == "cuda":
        return torch.device("cuda", rank)
    return torch.device("cpu")


def share_threads(world: int) -> None:
    """The ranks share the host's cores: a full thread pool each would
    oversubscribe them."""
    import torch

    share = max(1, (os.cpu_count() or 1) // world)
    torch.set_num_threads(min(torch.get_num_threads(), share))


def make_texts(root: str, config: dict, seed: int, n_texts: int,
               device) -> list[bytes]:
    """The cell's texts of run seed ``seed``, made on ``device``."""
    from pathlib import Path

    from benchmark.spec import BENCH, load_module

    corpus = load_module(Path(root) / BENCH / "corpora"
                         / f"{config['corpus']}.py",
                         f"corpus_{config['corpus']}")
    texts = [corpus.make(config, seed, i, device) for i in range(n_texts)]
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    return texts


def digest(text: bytes) -> int:
    """A 63-bit digest of a text, for the ranks to compare theirs."""
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def join(device_type: str, rank: int, world: int, store_path: str) -> None:
    import torch.distributed as dist

    from suffix_torch.parallel.mesh import init_group

    init_group(device_type, rank, world, dist.FileStore(store_path, world))


def digests(texts: list[bytes], device) -> list[list[int]]:
    """Every rank's digest of each text, by rank (a collective)."""
    import torch
    import torch.distributed as dist

    mine = torch.tensor([digest(t) for t in texts], dtype=torch.int64,
                        device=device)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return [o.tolist() for o in out]


def job(text: bytes, world: int, device):
    """One index job on this rank: the user's entry point."""
    from suffix_torch.utils.config import BuildConfig, build_index

    return build_index(text, BuildConfig(sharded=True, n_devices=world),
                       device=device.type)


def broadcast(op: int, device) -> int:
    """Rank 0's command ``op`` on every rank (a collective)."""
    import torch
    import torch.distributed as dist

    cmd = torch.tensor([op], dtype=torch.int64, device=device)
    dist.broadcast(cmd, 0)
    return int(cmd)


def peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def max_over_ranks(value: int, device) -> int:
    """The largest ``value`` of any rank (a collective)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t)


def open_window(device) -> int:
    """Every rank's peak of set-up, the largest; each rank's peak is
    reset for the window."""
    most = max_over_ranks(peak(device), device)
    reset_peak(device)
    return most


def close_window(device) -> int:
    """The largest of every rank's peak in the window."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return max_over_ranks(peak(device), device)


def watch_parent(parent: int) -> None:
    """Leave at once when the harness's process is gone, so no rank is
    left waiting in a collective."""
    def loop():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=loop, daemon=True).start()


def worker(index: int, world: int, device_type: str, store_path: str,
           root: str, config: dict, seed: int, n_texts: int,
           parent: int) -> None:
    """Rank ``index + 1``: make the texts, join the group, compare
    digests, then run rank 0's commands until stop."""
    rank = index + 1
    watch_parent(parent)
    import torch

    from suffix_torch.parallel.mesh import destroy_group

    share_threads(world)
    device = device_of(device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        texts = make_texts(root, config, seed, n_texts, device)
        join(device_type, rank, world, store_path)
        digests(texts, device)
        while True:
            op = broadcast(0, device)
            if op >= 0:
                job(texts[op], world, device)
            elif op == OPEN:
                open_window(device)
            elif op == CLOSE:
                close_window(device)
            elif op == STOP:
                break
    except BaseException:
        print(f"rank {rank} of {world}:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        os._exit(1)
    destroy_group()
