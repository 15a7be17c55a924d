"""Collective bucket layout over a mesh.

Port of ``suffix_tpu/parallel/collective_bins.py``: the distributed form
of the reference's ``Bins`` (src/table.rs:671-750). Each rank histograms
the symbols of its own block with the port's CUDA ``byte_histogram``
(``ops/kernels.py``; its plain version only for a CPU tensor), one
all-reduce sums the 258 counts over the mesh, and the head and tail
pointers follow from a prefix sum of the reduced counts. Every rank ends
with the same global bucket boundaries, equal to the single-process
values (``ops/sais.py::bucket_layout``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from suffix_torch.ops.kernels import byte_histogram
from suffix_torch.parallel.mesh import Mesh

N_SYM = 258


def bins_shard(text_local: torch.Tensor, mesh: Mesh):
    """(counts, heads, tails), int32 tensors on the rank's device, of the
    text whose block ``text_local`` (PAD-padded int32) this rank holds."""
    sym = (text_local + 1).to(torch.int32)
    counts = byte_histogram(sym, N_SYM)
    if mesh.world_size > 1:
        dist.all_reduce(counts, group=mesh.group)
    tails = torch.cumsum(counts, 0, dtype=torch.int32)
    return counts, tails - counts, tails


def global_bucket_layout(text_padded: np.ndarray, mesh: Mesh):
    """(counts, heads, tails), int32 numpy, for a text sharded across
    ``mesh``; each rank reads only its block of ``text_padded``, whose
    length must divide evenly by the mesh size."""
    n = int(text_padded.shape[0])
    if n % mesh.world_size:
        raise ValueError(f"text length {n} does not divide over "
                         f"{mesh.world_size} ranks")
    n_local = n // mesh.world_size
    lo = mesh.rank * n_local
    block = np.ascontiguousarray(text_padded[lo:lo + n_local], dtype=np.int32)
    out = bins_shard(torch.from_numpy(block).to(mesh.device), mesh)
    return tuple(t.cpu().numpy() for t in out)
