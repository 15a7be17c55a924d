"""O(n) suffix-array certificate, port of ``suffix_tpu/utils/verify.py``:
the host form (numpy) and the device form (torch sorts and reductions).

``sa`` is THE suffix array of ``t`` iff

  (a) sa is a permutation of [0, n);
  (b) first bytes are non-decreasing along sa;
  (c) for adjacent ranks with equal first bytes, the successor suffixes
      are ordered: rank_of[sa[i]+1] < rank_of[sa[i+1]+1], where the
      one-past-the-end (empty) suffix ranks below all.

(b)+(c) force strict lexicographic order by induction on suffix length;
with (a) every suffix appears exactly once. The device form takes the
ranks from one sort (sorting sa gives rank_of as the sort's permutation)
and the successor ranks in rank order from a second; every check is a
vector reduction, and one readback gives the answer.
"""

from __future__ import annotations

import numpy as np
import torch

from suffix_torch.device import resolve_device


def verify_suffix_array(text, sa, device=False) -> bool:
    """True iff ``sa`` is exactly the suffix array of ``text``.

    ``device=False`` (default) runs the host form: vectorized numpy, three
    O(n) passes and one scatter, the fastest for arrays already on the
    host. Otherwise the sort-based form runs on a torch device: ``True``
    means CUDA, or pass the device (``"cpu"`` runs it on the host's torch).
    """
    t = (np.frombuffer(text, np.uint8) if isinstance(text, (bytes, bytearray))
         else np.asarray(text, np.uint8))
    sa = np.asarray(sa)
    n = int(t.size)
    if sa.shape != (n,):
        return False
    if n == 0:
        return True
    if device is not False:
        return _verify_device(t, sa, resolve_device(
            None if device is True else device))
    sa64 = sa.astype(np.int64)
    # (a) permutation
    seen = np.zeros(n, bool)
    if sa64.min(initial=0) < 0 or sa64.max(initial=0) >= n:
        return False
    seen[sa64] = True
    if not seen.all():
        return False
    # (b) first bytes non-decreasing
    first = t[sa64]
    if np.any(first[1:] < first[:-1]):
        return False
    # (c) successor-rank order within equal first bytes; rank_of[n] (the
    # empty suffix) = -1, below every real rank.
    rank_of = np.empty(n + 1, np.int64)
    rank_of[sa64] = np.arange(n)
    rank_of[n] = -1
    eq = first[1:] == first[:-1]
    succ_l = rank_of[sa64[:-1] + 1]
    succ_r = rank_of[sa64[1:] + 1]
    return not np.any(eq & (succ_l >= succ_r))


def _tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a CPU tensor, copied only when it is read-only or strided
    (torch.from_numpy warns on a read-only array)."""
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy()
    return torch.from_numpy(a)


def _verify_device(t: np.ndarray, sa: np.ndarray, dev: torch.device) -> bool:
    n = int(t.size)
    # A uint32 table goes up as int32 (its bits): entries of 2^31 or more
    # turn negative and fail (a) like any entry out of [0, n).
    if sa.dtype in (np.uint32, np.int32) and n < (1 << 31):
        sa_h = _tensor(sa.view(np.int32))
    else:
        sa_h = torch.from_numpy(sa.astype(np.int64))
    sa_d = sa_h.to(dev)
    t_d = _tensor(t).to(dev)
    r = torch.arange(n, dtype=sa_d.dtype, device=dev)
    # (a) and rank_of in one sort: the sorted keys are 0..n-1 iff sa is a
    # permutation, and the sort's permutation is then rank_of.
    keys, rank_of = torch.sort(sa_d)
    is_perm = (keys == r).all()
    # (b)
    first = t_d[sa_d.clamp(0, n - 1).long()]
    mono = (first[1:] >= first[:-1]).all()
    # (c): rank_of[i + 1] for each position i (-1 past the end), brought
    # into rank order by sorting on rank_of itself.
    succ = torch.cat([rank_of[1:], rank_of.new_full((1,), -1)])
    order = torch.sort(rank_of).indices
    succ_by_rank = succ[order]
    eq = first[1:] == first[:-1]
    ok_succ = (~eq | (succ_by_rank[:-1] < succ_by_rank[1:])).all()
    return bool(is_perm & mono & ok_succ)
