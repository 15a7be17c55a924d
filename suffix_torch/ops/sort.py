"""Lexicographic multi-key sort on top of ``torch.sort``.

``jax.lax.sort(operands, num_keys=k)`` orders rows by the first ``k``
operands and carries the rest. ``torch.sort`` takes one key, so the port
runs stable least-significant-digit passes: the last key first, each pass
a stable ``torch.sort`` of that key gathered through the permutation so
far. Two int32 keys fuse into one int64 as ``(a << 32) + (b + 2**31)``,
which keeps signed order (the ``-1``/``PAD`` fill stays lowest), so ``k``
int32 keys cost ``ceil(k / 2)`` passes.

The JAX sorts are unstable; this one is stable, a stricter contract. Only
outputs are compared, never the order inside tie groups.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _fuse(keys: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Pair consecutive int32 keys into int64 keys of the same order."""
    fused = []
    i = 0
    while i < len(keys):
        a = keys[i]
        if (a.dtype == torch.int32 and i + 1 < len(keys)
                and keys[i + 1].dtype == torch.int32):
            b = keys[i + 1]
            fused.append((a.long() << 32) + (b.long() + (1 << 31)))
            i += 2
        else:
            fused.append(a)
            i += 1
    return fused


def lexsort_perm(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable permutation (int64) that sorts rows by ``keys``, first
    key most significant."""
    fused = _fuse(keys)
    perm = None
    for key in reversed(fused):
        k = key if perm is None else key[perm]
        _, order = torch.sort(k, stable=True)
        perm = order if perm is None else perm[order]
    return perm


def lexsort(keys: Sequence[torch.Tensor],
            payloads: Sequence[torch.Tensor] = ()) -> tuple[torch.Tensor, ...]:
    """Sorted ``keys`` followed by ``payloads`` in the same row order:
    the counterpart of ``jax.lax.sort((*keys, *payloads),
    num_keys=len(keys))``."""
    perm = lexsort_perm(keys)
    return tuple(t[perm] for t in (*keys, *payloads))
