"""Streamed corpus input for large builds.

Port of ``suffix_tpu/utils/io.py``. Reading a whole file into host memory
and then into an int32 staging copy costs five times the corpus; here

- ``open_corpus`` is a read-only ``np.memmap`` of the file;
- ``device_corpus`` stages a PAD-padded int32 corpus on the device. With
  a mesh, each rank converts and uploads only its own block, so the host
  holds one block, not the corpus.
"""

from __future__ import annotations

import numpy as np
import torch

from suffix_torch.device import resolve_device
from suffix_torch.ops.padding import PAD, bucket_size


def open_corpus(path: str) -> np.ndarray:
    """Read-only uint8 view of ``path`` (the OS page cache buffers it)."""
    return np.memmap(path, dtype=np.uint8, mode="r")


def _block_span(n_pad: int, mesh, device) -> tuple[int, int, torch.device]:
    """(lo, hi, device) of this process's block of an ``n_pad`` array:
    the mesh rank's block on its device, or all of it on ``device``."""
    if mesh is None:
        return 0, n_pad, resolve_device(device)
    n_local = n_pad // mesh.world_size
    lo = mesh.rank * n_local
    return lo, lo + n_local, mesh.device


def device_corpus(path_or_bytes, mesh=None, n_pad: int | None = None,
                  lut: np.ndarray | None = None, fill: int = PAD,
                  device=None):
    """(int32 tensor, n): the PAD-padded corpus of ``n`` bytes.

    With ``mesh``, ``n_pad`` rounds up to a multiple of the mesh size and
    the tensor is this rank's block ``[rank * L, (rank + 1) * L)`` on its
    device; without, the whole padded corpus on ``device`` (``None`` =
    CUDA). ``lut`` recodes each byte through a 256-entry table (the
    alphabet-adaptive dense codes) and ``fill`` is the padding value (0
    for coded corpora), still one block of host memory at a time."""
    if isinstance(path_or_bytes, str):
        raw = open_corpus(path_or_bytes)
    elif isinstance(path_or_bytes, np.ndarray):
        if path_or_bytes.dtype != np.uint8:
            raise TypeError("array corpora must be uint8")
        raw = path_or_bytes  # no copy (memmaps included)
    else:
        raw = np.frombuffer(bytes(path_or_bytes), dtype=np.uint8)
    n = int(raw.shape[0])
    if n_pad is None:
        n_pad = bucket_size(max(n, 1))
    if mesh is not None:
        n_pad = -(-n_pad // mesh.world_size) * mesh.world_size
    lo, hi, dev = _block_span(n_pad, mesh, device)
    out = np.full((hi - lo,), fill, dtype=np.int32)
    take = min(hi, n) - lo
    if take > 0:
        seg = raw[lo:lo + take]
        out[:take] = lut[seg] if lut is not None else seg
    return torch.from_numpy(out).to(dev), n


def device_table(sa: np.ndarray, n_pad: int, mesh) -> torch.Tensor:
    """This rank's block of the zero-padded int32 suffix table of length
    ``n_pad`` (a multiple of the mesh size), staged one block at a
    time."""
    n = int(sa.shape[0])
    lo, hi, dev = _block_span(n_pad, mesh, None)
    out = np.zeros((hi - lo,), dtype=np.int32)
    take = min(hi, n) - lo
    if take > 0:
        out[:take] = sa[lo:lo + take]
    return torch.from_numpy(out).to(dev)
