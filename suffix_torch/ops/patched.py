"""Defect-tolerant periodic construction (the "patched periodic" engine),
in PyTorch.

Port of ``suffix_tpu/ops/patched.py``. A corpus that repeats a period q
with a few verified defects D = {x : T[x] != T[x+q]} is sorted by

phase A  the adaptive initial sort, plus quadrupling rounds only while a
         surviving tie group holds suffixes of different phases (i mod q);
closed   same-phase order follows from D alone: rows T[aq:(a+1)q] differ
form     only at the defect columns, so a suffix's order inside its tie
         group is a pure function of its index (column interval x row
         class rank, then the walk rank over the following rows), read
         from small host tables. That key rides every sort as one trailing
         key, so the sort that reaches phase purity emits the SA.

Soundness never rests on the period being right: the defect set is exact,
purity is checked on the device every round, and an impure state keeps
doubling to completion (the classic engine's output).

What changes from JAX to PyTorch:

- ``lax.sort`` of ``words + (small, idx)`` becomes ``ops.sort.lexsort``
  (up to PATCH_MAX_WORDS + 1 keys; int32 keys pair into int64, an int64
  ``small`` sorts alone).
- The ``while_loop`` becomes a host loop with one ``done | pure`` readback
  a round.
- ``_rotation_width`` sorts the first two tiles with the port's own default
  build and takes the direct LCPs of consecutive rotations by windowed
  compares (JAX: native SA-IS + Kasai + range minima; the same number,
  since the LCP of two suffixes is the least adjacent LCP between them).
- ``jax.named_scope`` becomes ``record_function``: ``PP_small_key`` beside
  the doubling engine's ``P0_``..``P6_`` names.
- The text is staged as the doubling routes stage it: its bytes go up
  once and the device widens, counts (``byte_histogram``) and codes them
  (JAX: ``np.bincount`` and the packed codes on the host).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from suffix_torch.device import resolve_device
from suffix_torch.ops.padding import bucket_size
from suffix_torch.ops.sort import lexsort, lexsort_perm
from suffix_torch.utils.profiling import count, root, span

I32 = torch.int32

# Routing gates, copied from the JAX package (checked by
# prefix_doubling.device_build_closure): enough tiles that doubling would
# pay real rounds, few enough that the host tables stay trivial.
PATCH_MIN_TILES = 8
PATCH_KMAX = 4096
# Phase A may widen the initial packed sort to this many words to reach
# purity without a quadrupling round.
PATCH_MAX_WORDS = 16
# Host table work is O(n_intervals * n_classes * |cols|); corpora past this
# budget are refused and take the doubling engines.
PATCH_TABLE_BUDGET = 1 << 26


def _host_suffix_ranks(s: np.ndarray) -> np.ndarray:
    """Suffix ranks of a tiny integer string (host doubling); a proper
    prefix sorts first (the shifted key past the end is -1)."""
    s = np.asarray(s, np.int64)
    m = int(s.size)
    if m == 0:
        return np.zeros((0,), np.int32)
    rank = np.unique(s, return_inverse=True)[1].astype(np.int64)
    h = 1
    while h < m and int(rank.max()) < m - 1:
        key2 = np.full(m, -1, np.int64)
        key2[:m - h] = rank[h:]
        order = np.lexsort((key2, rank))
        r1, r2 = rank[order], key2[order]
        neq = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        newr = np.zeros(m, np.int64)
        newr[1:] = np.cumsum(neq)
        rank = np.empty(m, np.int64)
        rank[order] = newr
        h *= 2
    return rank.astype(np.int32)


def _patch_tables(arr: np.ndarray, q: int, defects: np.ndarray):
    """Host tables of the closed form, or None when over budget:

      bnds     interval boundaries over the column c = i mod q (a defect
               column col leaves the set {cols >= c} at col+1, the tail row
               dies at its length t); interval id v(c) = #(bnds <= c)
      cls      class id of each row, the tail row as class n_cls-1
      rankT    (n_intervals x n_classes) dense rank with ties of the row
               tails from any column of the interval
      rank_s   walk order: suffix ranks of the row-symbol string, then -1
               for the empty walk
    """
    n = int(arr.size)
    k = n // q
    t = n - k * q
    cols = np.unique(np.asarray(defects, np.int64) % q)
    U = int(cols.size)
    if (k + 2) * (U + 2) * (U + 2) > PATCH_TABLE_BUDGET:
        return None
    if U:
        Sig = arr[np.arange(k, dtype=np.int64)[:, None] * q + cols[None, :]]
    else:
        Sig = np.zeros((k, 0), np.uint8)
    uniq, cls_of_row = np.unique(Sig, axis=0, return_inverse=True)
    cls_of_row = cls_of_row.reshape(-1)
    C = int(uniq.shape[0])
    n_cls = C + 1  # + the (possibly absent) tail-row class
    ut = int(np.searchsorted(cols, t))  # cols[:ut] lie inside the tail row
    tail_sig = (arr[k * q + cols[:ut]].astype(np.int32)
                if t > 0 else np.zeros((0,), np.int32))
    bnds = np.unique(np.concatenate([cols + 1, np.asarray([t], np.int64)]))
    bnds = bnds[(bnds > 0) & (bnds < q)]
    n_int = int(bnds.size) + 1
    los = np.concatenate([np.zeros((1,), np.int64), bnds])
    rankT = np.zeros((n_int, n_cls), np.int32)
    uniq32 = uniq.astype(np.int32)
    for r in range(n_int):
        lo = int(los[r])
        u0 = int(np.searchsorted(cols, lo, side="left"))
        W = (U - u0) + 1
        M = np.zeros((n_cls, W), np.int32)
        M[:C, :W - 1] = uniq32[:, u0:]
        # Full rows carry 0 in the trailing slot, the tail row -1 from its
        # truncation on: an equal prefix then ranks the tail first (the
        # sentinel rule), and full rows tie there (equal strings).
        if t > 0 and lo < t:
            row_t = np.full((W,), -1, np.int32)
            tb = tail_sig[u0:ut]
            row_t[:tb.size] = tb
            M[C] = row_t
        else:
            M[C] = -1  # tail row dead here; never queried (c >= t)
        order = np.lexsort(M[:, ::-1].T)
        Ms = M[order]
        neq = (Ms[1:] != Ms[:-1]).any(axis=1)
        dr = np.zeros(n_cls, np.int32)
        dr[1:] = np.cumsum(neq)
        rankT[r, order] = dr
    # Walk order: row symbols are the full-string ranks; the tail symbol
    # (t > 0) ends every walk it appears in.
    sym = rankT[0, cls_of_row]
    if t > 0:
        sym = np.concatenate([sym, rankT[0, C:C + 1]])
    rank_walk = _host_suffix_ranks(sym)
    rank_s = np.concatenate([rank_walk, np.asarray([-1], np.int32)])
    cls = np.concatenate([cls_of_row.astype(np.int32),
                          np.asarray([C], np.int32)])
    return {
        "bnds": bnds.astype(np.int32),
        "cls": cls,
        "rankT": rankT.reshape(-1),
        "rank_s": rank_s.astype(np.int32),
        "n_cls": n_cls,
        "k": k,
    }


def _staged(x: np.ndarray, fill: int, device) -> torch.Tensor:
    """A small host table on ``device``, padded to a bucket with ``fill``
    (the padded ``bnds``, filled with q, is what ``searchsorted`` reads)."""
    from suffix_torch.ops import prefix_doubling as pd

    b = bucket_size(max(int(x.size), 1))
    out = np.full((b,), fill, np.int32)
    out[:x.size] = x
    return pd._upload(out, device)


def _purity(dense: torch.Tensor, sa: torch.Tensor, n: int,
            q: int) -> torch.Tensor:
    """Every surviving tie group is same-residue mod q; the all-PAD group
    (suffixes past the text) is exempt."""
    res = sa % q
    grp = dense[1:] == dense[:-1]
    pads = sa >= n
    ok = ~grp | (res[1:] == res[:-1]) | (pads[1:] & pads[:-1])
    return ok.all()


def _rerank_pure(cols, sa: torch.Tensor, n: int, q: int):
    """(dense, done, pure) of sorted key columns, with one readback."""
    from suffix_torch.ops import prefix_doubling as pd

    dense = pd._dense_rank(pd._adjacent_diff(cols), sa.dtype)
    with pd._readback():
        done, pure = torch.stack([dense[-1] == dense.shape[0] - 1,
                                  _purity(dense, sa, n, q)]).tolist()
    return dense, done, pure


def _patched_core(words, h0: int, index_dtype, n: int, q: int,
                  bnds: torch.Tensor, cls_arr: torch.Tensor,
                  rankT_flat: torch.Tensor, rank_s: torch.Tensor, n_cls: int,
                  rs_cap: int):
    """Adaptive initial sort, then quadrupling rounds with a per-round
    phase-purity check; the closed-form key ``small`` rides every sort, so
    the sort that reaches purity (or completion) emits the SA.

    Returns (sa, k_final, done, pure)."""
    from suffix_torch.ops import prefix_doubling as pd

    n_pad = words[0].shape[0]
    idx = torch.arange(n_pad, dtype=index_dtype, device=words[0].device)

    with record_function("PP_small_key"):
        # Closed-form in-group key per suffix index (home order).
        real = idx < n
        pos = torch.where(real, idx, 0)
        c = (pos % q).to(I32)
        a = torch.clamp(pos // q, max=cls_arr.shape[0] - 1).long()
        v = torch.searchsorted(bnds, c, right=True)
        cls = cls_arr[a]
        tc = rankT_flat[v * n_cls + cls.long()]
        rs = rank_s[torch.clamp(a + 1, max=rank_s.shape[0] - 1)]
        small = (tc * rs_cap + (rs + 1)).to(index_dtype)
        # Pads: distinct keys, longer pad suffixes first.
        small = torch.where(real, small, (n_pad - 1) - idx)

    with record_function("P1_initial_sort"):
        *cols, _, sa = lexsort(list(words) + [small], (idx,))
    with record_function("P2_initial_rank"):
        dense, done, pure = _rerank_pure(cols, sa, n, q)

    # The state is the sorted view (dense ranks + suffix order); a round
    # derives the home-order ranks first, so a build that ends on purity
    # never pays the inversion.
    k = h0
    while not (done or pure) and k < 2 * n_pad:
        count("rounds")
        with record_function("P6_route_home"):
            rank = pd._invert_permutation(sa, dense)
        with record_function("P3_shift_ranks"):
            s1, s2, s3 = pd._shifted_ranks(rank, k)
        with record_function("P4_round_sort"):
            perm = lexsort_perm((rank, s1, s2, s3, small))
            keys = [x[perm] for x in (rank, s1, s2, s3)]
            sa = idx[perm]
        with record_function("P5_dense_rerank"):
            dense, done, pure = _rerank_pure(keys, sa, n, q)
        k *= 4

    # done: all ranks distinct, small never consulted; pure: every tie
    # group is same-phase and ordered by small. Either way sa is the SA.
    return sa, k, done, pure


def _rotation_width(arr: np.ndarray, q: int, device) -> int | None:
    """Measured rotation-separation depth: the max LCP between two
    different rotations of the (defect-bearing) period, from the first two
    tiles T[:2q]. An initial packed width beyond it separates every
    cross-phase pair, so phase A reaches purity at the first sort (defects
    elsewhere may stretch a tie a little; purity is checked on the
    device). None when 2q > n, 0 for fewer than two rotations.

    The SA of T[:2q] comes from the port's default build on ``device``;
    the max over consecutive rotation suffixes (sa < q, in rank order) of
    their direct LCP, by 128-byte windowed compares, equals the JAX
    package's range minima over the Kasai LCP."""
    from suffix_torch.ops import lcp as lcp_ops
    from suffix_torch.ops import prefix_doubling as pd

    m = 2 * q
    if m > arr.size:
        return None
    pp = np.ascontiguousarray(arr[:m])
    # A build of its own: its spans and counters stay out of the job's.
    with root("build.rotation", n=m):
        sa = pd.suffix_array_bytes(pp, device=device).astype(np.int64)
    rot = sa[sa < q]  # rotation suffixes in rank order
    if rot.size < 2:
        return 0
    dev = resolve_device(device)
    text = torch.from_numpy(pp.astype(np.int32)).to(dev)
    a = torch.from_numpy(rot[:-1]).to(dev)
    b = torch.from_numpy(rot[1:]).to(dev)
    best, off, block = 0, 0, 128
    while a.numel():
        run = lcp_ops._equal_run(lcp_ops._window(text, m, a, off, block),
                                 lcp_ops._window(text, m, b, off, block))
        full = run == block
        done = run[~full]
        if done.numel():
            best = max(best, off + int(done.max()))
        a, b = a[full], b[full]
        off += block
    return best


def patched_dispatch(arr: np.ndarray, q: int, defects: np.ndarray,
                     n_pad: int, index_dtype=I32, stats=None, device=None):
    """(dispatch, label) for a verified near-periodic corpus on ``device``
    (``None`` = CUDA), or None when the host tables refuse (over budget):
    the caller then falls through to the doubling engines.

    ``stats`` (optional dict): routing facts now (``engine_family``,
    ``period``, ``defects``, ``tiles``), and per dispatch the phase-A stop
    state (``rounds``, ``h_final``, ``h0``, ``closed_form``)."""
    from suffix_torch.ops import prefix_doubling as pd

    with span("build.pack"):
        tabs = _patch_tables(arr, q, defects)
    if tabs is None:
        return None
    dev = resolve_device(device)
    n = int(arr.size)
    bnds_d = _staged(tabs["bnds"], q, dev)
    cls_d = _staged(tabs["cls"], 0, dev)
    rank_s_d = _staged(tabs["rank_s"], -1, dev)
    rankT_d = _staged(tabs["rankT"], 0, dev)
    n_cls = tabs["n_cls"]
    rs_cap = tabs["k"] + 3
    label = f"patched(q={q},defects={int(defects.size)})"
    if stats is not None:
        stats.update(engine_family="patched", period=int(q),
                     defects=int(defects.size), tiles=tabs["k"])

    def run(words, h0: int):
        sa, k, done, pure = _patched_core(words, h0, index_dtype, n, q,
                                          bnds_d, cls_d, rankT_d, rank_s_d,
                                          n_cls, rs_cap)
        if stats is not None:
            rounds, h = 0, h0
            while h < k:
                h *= 4
                rounds += 1
            stats.update(rounds=rounds, h_final=k, h0=h0,
                         closed_form=pure and not done)
        return sa

    # The text is staged, counted and coded on the device, as the
    # doubling routes do (pd.device_build_closure).
    t_dev = pd._stage_text(arr, n_pad, dev)
    # Phase A only separates period rotations: the random-text width
    # estimate (no repeat lever), widened to the measured rotation depth
    # when that costs at most 3 more words.
    with span("build.plan"):
        plan = pd._adaptive_plan(arr, n_pad, lcp_lb=None,
                                 counts=pd._device_byte_counts(t_dev))
    with span("build.probe"):
        w_rot = _rotation_width(arr, q, dev)
    if plan is not None:
        lut, bits, cpw, n_words = plan
        if w_rot is not None:
            want = -(-(w_rot + 12) // cpw)  # slack: defect-local ties
            if n_words < want <= min(n_words + 3, PATCH_MAX_WORDS):
                n_words = want
        with span("build.pack"):
            c_dev = pd._code_text(t_dev, n, lut)
        del t_dev  # the rounds read the codes alone
        return (lambda: run(pd._packed_words(c_dev, n_words, bits, cpw),
                            n_words * cpw), label)
    iw = pd.pick_init_words(n_pad)
    return (lambda: run(pd._initial_words(t_dev, iw), 3 * iw), label)
