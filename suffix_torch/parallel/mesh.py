"""The process-group mesh of the sharded build.

Port of ``suffix_tpu/parallel/mesh.py``. JAX runs one controller over a
1-D device ``Mesh`` with one named axis (``AXIS = "d"``); torch runs one
process per device. A :class:`Mesh` is one process's view of the mesh:
its index ``rank`` among ``world_size`` members, its device and the
process group that the collectives run on. Member ``r`` is global rank
``r`` and runs on ``cuda:r`` over NCCL, or on the CPU over gloo (the
tests' backend); there is no other backend and no fallback between them.

A group of several ranks is started by ``parallel/launch.py::spawn`` (or
by the caller's own launcher); ``make_mesh`` only reads it.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from suffix_torch.device import resolve_device

AXIS = "d"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# A collective that waits longer than this raises instead of hanging.
TIMEOUT = datetime.timedelta(minutes=10)

_SUBGROUPS: dict[int, object] = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's member of a 1-D mesh: global ranks
    ``0 .. world_size - 1`` of the process group ``group`` (``None`` =
    the whole world)."""

    world_size: int
    rank: int
    device: torch.device
    group: object = None


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of global rank ``rank``: ``cuda:rank``, or the CPU.
    Raises where the machine has no card for the rank."""
    if device_type == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if rank >= count:
        raise RuntimeError(f"rank {rank} runs on cuda:{rank}, and this "
                           f"machine has {count} CUDA device(s)")
    return torch.device("cuda", rank)


def backend_for(device) -> tuple[str, str]:
    """(device type, backend) of ``device`` (``None`` = CUDA)."""
    dev_type = resolve_device(device).type
    if dev_type not in BACKENDS:
        raise ValueError(f"the sharded build runs on cuda or cpu, not "
                         f"{dev_type}")
    return dev_type, BACKENDS[dev_type]


def init_group(device_type: str, rank: int, world_size: int, store) -> None:
    """Join the process group as ``rank`` of ``world_size`` and run one
    all-reduce on it, so that NCCL's communicator exists before any
    batch of point-to-point transfers."""
    dev = rank_device(device_type, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(BACKENDS[device_type], store=store, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    dist.all_reduce(torch.zeros(1, device=dev))


def destroy_group() -> None:
    """Leave the process group (and forget its subgroups)."""
    _SUBGROUPS.clear()
    dist.destroy_process_group()


def default_world_size(device=None) -> int:
    """Ranks a sharded entry point starts when the caller names none:
    one a card, or one on the CPU."""
    dev_type, _ = backend_for(device)
    return torch.cuda.device_count() if dev_type == "cuda" else 1


def make_mesh(n_devices: int | None = None, device=None) -> Mesh | None:
    """The mesh over the first ``n_devices`` ranks (``None`` = all) of the
    initialised process group, on ``device``'s type (``None`` = CUDA).

    Without a group, ``n_devices`` of ``None`` or 1 makes a one-rank
    group in this process; more raises, since the other ranks must be
    processes of their own (``launch.spawn``). With a group, every rank
    must call this; the ranks past ``n_devices`` are not in the mesh and
    get ``None``."""
    dev_type, backend = backend_for(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"make_mesh({n_devices}) needs a process group of "
                f"{n_devices} ranks: start them with "
                "suffix_torch.parallel.launch.spawn")
        init_group(dev_type, 0, 1, dist.HashStore())
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}; "
                           f"{dev_type} tensors need {backend}")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} devices, have {world}")
    me = dist.get_rank()
    group = None if n == world else _subgroup(n, dev_type, me)
    if me >= n:
        return None
    return Mesh(n, me, rank_device(dev_type, me), group)


def _subgroup(n: int, dev_type: str, me: int):
    """The group of ranks 0 .. n-1, made once (every rank takes part)."""
    group = _SUBGROUPS.get(n)
    if group is None:
        group = _SUBGROUPS[n] = dist.new_group(list(range(n)))
        if me < n:
            dist.all_reduce(torch.zeros(1, device=rank_device(dev_type, me)),
                            group=group)
    return group
