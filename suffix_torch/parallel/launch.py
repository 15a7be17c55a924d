"""Start the ranks of a sharded program.

JAX is single-controller: one process drives every device of a mesh. The
port runs one process per device, so something has to start them; this
module has no JAX counterpart. ``spawn`` starts ``world_size`` processes
with ``torch.multiprocessing`` (method ``spawn``), joins them into one
group through a ``FileStore`` in a fresh temporary directory (a file, not
a TCP port, so that concurrent launches cannot collide), and calls
``fn(mesh, *args)`` on every rank. ``run`` is what the entry points call:
it runs in the caller's own group where one exists, in this process for
one rank, and through ``spawn`` otherwise.

``fn`` and ``args`` are pickled to the children, so ``fn`` is a
module-level function; a child imports the module that defines it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from suffix_torch.parallel.mesh import (backend_for, default_world_size,
                                        destroy_group, init_group, make_mesh)


def _rank_main(rank: int, world_size: int, device_type: str, tmp: str,
               fn, args) -> None:
    """One child: join the group, run ``fn``, leave. Rank 0 pickles the
    result; a rank that raises pickles its exception before it leaves the
    group (its peers fail only once it has left). The ranks share the
    host's cores: a full thread pool each would oversubscribe them."""
    share = max(1, (os.cpu_count() or 1) // world_size)
    torch.set_num_threads(min(torch.get_num_threads(), share))
    try:
        init_group(device_type, rank, world_size,
                   dist.FileStore(os.path.join(tmp, "store"), world_size))
        out = fn(make_mesh(world_size, device=device_type), *args)
        if rank == 0:
            _dump(os.path.join(tmp, "result.pkl"), out)
    except Exception as exc:
        exc.add_note(f"on rank {rank} of {world_size}:\n"
                     + traceback.format_exc())
        try:
            _dump(os.path.join(tmp, f"error.{rank}.pkl"), exc)
        except (pickle.PicklingError, TypeError, AttributeError):
            _dump(os.path.join(tmp, f"error.{rank}.pkl"),
                  RuntimeError(traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            destroy_group()


def _dump(path: str, obj) -> None:
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def _first_error(tmp: str, world_size: int):
    """The exception of the rank that failed first (by its file's time,
    then by rank), or None."""
    found = []
    for r in range(world_size):
        path = os.path.join(tmp, f"error.{r}.pkl")
        if os.path.exists(path):
            found.append((os.stat(path).st_mtime_ns, r, path))
    if not found:
        return None
    with open(min(found)[2], "rb") as f:
        return pickle.load(f)


def spawn(fn, world_size: int, *args, device=None):
    """``fn(mesh, *args)`` on ``world_size`` new processes, one a rank,
    on ``device``'s type (``None`` = CUDA: rank r on ``cuda:r`` over
    NCCL; ``"cpu"``: gloo). Returns rank 0's result and re-raises the
    first failing rank's exception; a rank that dies without one (a
    signal) raises ``torch.multiprocessing.ProcessExitedException``."""
    dev_type, _ = backend_for(device)
    if dev_type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks need {world_size} CUDA "
                           f"devices; this machine has "
                           f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(prefix="suffix_torch_ranks_") as tmp:
        try:
            mp.start_processes(_rank_main, nprocs=world_size, join=True,
                               start_method="spawn",
                               args=(world_size, dev_type, tmp, fn, args))
        except ProcessException as exc:
            err = _first_error(tmp, world_size)
            if err is None:
                raise
            raise err from exc
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def is_lead() -> bool:
    """True in a process outside any group and on global rank 0: the
    process that prints and writes an entry point's output."""
    return not dist.is_initialized() or dist.get_rank() == 0


def run(fn, n_devices: int | None, *args, device=None):
    """``fn(mesh, *args)`` over ``n_devices`` ranks (``None`` = one a
    card, or one on the CPU), returning rank 0's result.

    Inside an initialised group every rank calls this and it runs there
    (a rank outside the mesh gets ``None``); otherwise one rank runs in
    this process over a group made and left for the call, and more go
    through ``spawn``."""
    if dist.is_initialized():
        mesh = make_mesh(n_devices, device=device)
        return None if mesh is None else fn(mesh, *args)
    n = default_world_size(device) if n_devices is None else int(n_devices)
    if n != 1:
        return spawn(fn, n, *args, device=device)
    mesh = make_mesh(1, device=device)
    try:
        return fn(mesh, *args)
    finally:
        destroy_group()
