"""O(n) suffix-array certificate on the host (numpy), copied from the
host form of ``suffix_tpu/utils/verify.py``.

``sa`` is THE suffix array of ``t`` iff

  (a) sa is a permutation of [0, n);
  (b) first bytes are non-decreasing along sa;
  (c) for adjacent ranks with equal first bytes, the successor suffixes
      are ordered: rank_of[sa[i]+1] < rank_of[sa[i+1]+1], where the
      one-past-the-end (empty) suffix ranks below all.

(b)+(c) force strict lexicographic order by induction on suffix length;
with (a) every suffix appears exactly once.
"""

from __future__ import annotations

import numpy as np


def verify_suffix_array(text, sa) -> bool:
    """True iff ``sa`` is exactly the suffix array of ``text``."""
    t = (np.frombuffer(text, np.uint8) if isinstance(text, (bytes, bytearray))
         else np.asarray(text, np.uint8))
    sa = np.asarray(sa)
    n = int(t.size)
    if sa.shape != (n,):
        return False
    if n == 0:
        return True
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
