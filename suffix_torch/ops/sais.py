"""SA-IS as sample + stratified induced derivation, in PyTorch.

Port of ``suffix_tpu/ops/sais.py``: the recursive pipeline
(``suffix_array_sais_recursive``, what ``engine="sais"`` runs) and the
hybrid one (``suffix_array_sais``), whose LMS sample order comes from the
doubling engine instead of the recursion. The
algorithm is the same: decompose every suffix as c^m·γ (m = its maximal
same-character run, γ = the suffix after the run). L-suffixes order
inside their bucket by (m ascending, order of γ), S-suffixes by
(m descending, order of γ); γ always lies in a strictly smaller (L) or
larger (S) bucket, so each phase resolves in at most (longest strictly
monotone character chain) rounds, each round one full-width sort. The
LMS sample order comes from sorting and naming LMS substrings and, when
names repeat, recursing on the reduced string of names.

What changes from JAX to PyTorch:

- ``jax.lax.while_loop`` becomes a host loop with one scalar readback per
  round; the rounds are counted in ``stats``.
- ``jax.lax.associative_scan`` becomes ``torch.cummax`` / ``torch.cummin``
  (a reverse ``cummin`` over planted indices finds "the first non-zero to
  the right").
- ``jax.lax.sort`` with several keys becomes ``ops.sort.lexsort``.
- ``torch.cumsum`` of int32 returns int64; results are cast back to int32
  where the JAX code relies on it.

The byte histograms of the bucket layout run the port's CUDA kernel
(``ops/kernels.py::byte_histogram``) on the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from suffix_torch.device import resolve_device
from suffix_torch.ops.kernels import byte_histogram
from suffix_torch.ops.padding import PAD, bucket_size
from suffix_torch.ops.sort import lexsort

INF = 0x7FFFFFFF
N_SYM = 258  # symbol alphabet 0..257 (PAD+1=0, bytes 1..256), one spare
I32 = torch.int32


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    """out[i] = min(x[i:]) — the reverse min scan."""
    return torch.cummin(x.flip(0), 0).values.flip(0)


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=I32)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _bump(stats: dict | None, key: str, by: int) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + by


def classify_types(text: torch.Tensor):
    """(is_s, is_lms) masks: reference P2 (src/table.rs:592-615). Each
    position takes the sign of the first strict comparison to its right."""
    n = text.shape[0]
    nxt = torch.cat([text[1:], text.new_full((1,), -2)])
    c = torch.sign(text - nxt).to(I32)  # +1 L, -1 S, 0 inherit
    idx = _arange(n, text.device)
    # The last position always compares against -2 < any symbol, so the
    # first non-zero at or right of i always exists.
    first = _suffix_min(torch.where(c != 0, idx, n))
    is_s = c[first.long()] == -1
    prev_s = torch.cat([is_s.new_ones((1,)), is_s[:-1]])
    is_lms = is_s & ~prev_s
    return is_s, is_lms


def _int_histogram(values: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Histogram over an integer alphabet. Up to 512 bins it is the
    kernel; the recursion's wider name alphabets use a scatter-add."""
    if n_bins <= 512:
        return byte_histogram(values, n_bins)
    ok = (values >= 0) & (values < n_bins)
    safe = torch.where(ok, values, 0).long()
    out = torch.zeros(n_bins, dtype=I32, device=values.device)
    return out.index_add_(0, safe, ok.to(I32))


def bucket_layout(text: torch.Tensor, n_sym: int = N_SYM):
    """(counts, heads, tails) per symbol: the reference's Bins
    (src/table.rs:686-720), generalized to name alphabets by ``n_sym``."""
    sym = (text + 1).to(I32)
    counts = _int_histogram(sym, n_sym)
    tails = _cumsum32(counts)
    heads = tails - counts
    return counts, heads, tails


def run_decompose(text: torch.Tensor):
    """(m, gamma): maximal same-char run length at each position and the
    index right after the run."""
    n = text.shape[0]
    nxt = torch.cat([text[1:], text.new_full((1,), -2)])
    run_end = text != nxt
    idx = _arange(n, text.device)
    end = _suffix_min(torch.where(run_end, idx, n))
    m = end - idx + 1
    gamma = idx + m
    return m, gamma


def _own_segment_end_value(seg_key: torch.Tensor, values: torch.Tensor):
    """For each element of a segment-sorted array: ``values`` at the last
    element of its own segment."""
    n = seg_key.shape[0]
    is_end = torch.cat([seg_key[1:] != seg_key[:-1],
                        seg_key.new_ones((1,), dtype=torch.bool)])
    idx = _arange(n, seg_key.device)
    end = _suffix_min(torch.where(is_end, idx, n))
    return values[end.long()]


def _segment_positions(seg_key: torch.Tensor):
    """For a sorted key array: position of each element within its
    equal-key segment, and the segment-start index array."""
    n = seg_key.shape[0]
    idx = _arange(n, seg_key.device)
    is_start = torch.cat([seg_key.new_ones((1,), dtype=torch.bool),
                          seg_key[1:] != seg_key[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    return idx - seg_start, seg_start


def _derive_sa(text: torch.Tensor, lms_class_rank: torch.Tensor,
               max_rounds: int = N_SYM, n_sym: int = N_SYM,
               stats: dict | None = None) -> torch.Tensor:
    """Full padded SA from LMS class ranks via stratified L/S derivation.

    ``n_sym`` is the symbol-alphabet size (258 at the byte level, the
    padded name count + 2 at recursion levels); the round bound follows
    the strictly monotone chain depth, which is < n_sym."""
    n = text.shape[0]
    dev = text.device
    idx = _arange(n, dev)
    sym = (text + 1).to(I32)

    with record_function("S1_classify_buckets"):
        is_s, is_lms = classify_types(text)
        is_l = ~is_s
        m, gamma = run_decompose(text)
        _, heads, tails = bucket_layout(text, n_sym)
    g_clip = torch.clamp(gamma, max=n - 1).long()
    past_end = gamma >= n
    g_sym = torch.where(past_end, -1, sym[g_clip])  # -1: text end
    g_is_lms = is_lms[g_clip] & ~past_end
    g_lms_rank = lms_class_rank[g_clip]
    inf = torch.full((n,), INF, dtype=I32, device=dev)

    # ---------------- L-phase ----------------
    # Surrogate γ-key of an L-suffix: (bucket*2 + class, rank) with class
    # L=0 < LMS=1; rank = resolved L-rank or LMS class rank.
    l_seg_key = torch.where(is_l, sym, n_sym)  # non-L sink segment
    g_hi = torch.where(past_end, -1, g_sym * 2 + g_is_lms.to(I32))
    l_rank = inf
    rounds = 0
    while rounds < max_rounds and bool((is_l & (l_rank == INF)).any()):
        with record_function("S2_L_phase_round"):
            g_lrank = l_rank[g_clip]
            g_lo = torch.where(past_end, 0,
                               torch.where(g_is_lms, g_lms_rank, g_lrank))
            ready = past_end | g_is_lms | (g_lrank != INF)
            not_ready = (~ready).to(I32)
            sk, srdy, _, _, _, sidx = lexsort(
                (l_seg_key, not_ready, m, g_hi, g_lo), (idx,))
            pos, _ = _segment_positions(sk)
            # A bucket finalizes only when every candidate in it is ready;
            # unready ones sort to the segment end (2 = ready end, 1 =
            # unready end).
            seg_end_ready = _own_segment_end_value(sk, 2 - srdy)
            cand = heads[torch.clamp(sk, max=n_sym - 1).long()] + pos
            ok = (sk < n_sym) & (seg_end_ready == 2)
            l_rank = inf.clone()
            l_rank[sidx.long()] = torch.where(ok, cand, INF)
        rounds += 1
    _bump(stats, "l_rounds", rounds)

    # ---------------- S-phase ----------------
    # γ of an S-suffix is an L-suffix (absolute rank final) or an S-suffix
    # of a larger bucket; absolute ranks compare directly.
    s_count = _int_histogram(torch.where(is_s, sym, -1), n_sym)
    s_part_start = tails - s_count
    s_seg_key = torch.where(is_s, sym, n_sym)
    g_l = is_l[g_clip]
    g_lrank_final = l_rank[g_clip]
    neg_m = -m
    s_rank = inf
    rounds = 0
    while rounds < max_rounds and bool((is_s & (s_rank == INF)).any()):
        with record_function("S3_S_phase_round"):
            g_abs = torch.where(g_l, g_lrank_final, s_rank[g_clip])
            not_ready = (g_abs == INF).to(I32)
            sk, srdy, _, _, sidx = lexsort(
                (s_seg_key, not_ready, neg_m, g_abs), (idx,))
            pos, _ = _segment_positions(sk)
            seg_end_ready = _own_segment_end_value(sk, 2 - srdy)
            cand = s_part_start[torch.clamp(sk, max=n_sym - 1).long()] + pos
            ok = (sk < n_sym) & (seg_end_ready == 2)
            s_rank = inf.clone()
            s_rank[sidx.long()] = torch.where(ok, cand, INF)
        rounds += 1
    _bump(stats, "s_rounds", rounds)

    rank = torch.where(is_l, l_rank, s_rank)
    sa = torch.zeros(n, dtype=I32, device=dev)
    sa[rank.long()] = idx
    return sa


def _lms_class_rank_from_doubling(text: torch.Tensor) -> torch.Tensor:
    """LMS class ranks from the doubling engine's suffix array (the
    hybrid pipeline's stand-in for the recursion): each LMS position's
    rank among the LMS suffixes, scattered to its position."""
    from suffix_torch.ops.prefix_doubling import _suffix_array_padded

    _, is_lms = classify_types(text)
    sa = _suffix_array_padded(text).long()
    flag = is_lms[sa].to(I32)
    out = torch.zeros(text.shape[0], dtype=I32, device=text.device)
    out[sa] = _cumsum32(flag) - flag
    return out


def _as_u8(data) -> np.ndarray:
    return (np.frombuffer(bytes(data), dtype=np.uint8)
            if isinstance(data, (bytes, bytearray))
            else np.asarray(data, dtype=np.uint8))


def _padded_on(arr: np.ndarray, device) -> tuple[torch.Tensor, int]:
    """(PAD-padded int32 text on ``device``, its power-of-two size)."""
    n = int(arr.shape[0])
    n_pad = bucket_size(n)
    padded = np.full((n_pad,), PAD, dtype=np.int32)
    padded[:n] = arr
    return torch.from_numpy(padded).to(device), n_pad


def suffix_array_sais(data: bytes | np.ndarray, device=None) -> np.ndarray:
    """Suffix array (uint32 offsets) via the hybrid SA-IS pipeline on
    ``device`` (``None`` = CUDA): the LMS sample order from the doubling
    engine, then the stratified induced derivation."""
    dev = resolve_device(device)
    arr = _as_u8(data)
    n = int(arr.shape[0])
    if n == 0:
        return np.empty((0,), dtype=np.uint32)
    t, n_pad = _padded_on(arr, dev)
    lms_rank = _lms_class_rank_from_doubling(t)
    sa_full = _derive_sa(t, lms_rank).cpu().numpy()
    return sa_full[n_pad - n:].astype(np.uint32)


# ---------------------------------------------------------------------------
# SA-IS recursion: LMS-substring sort -> naming -> reduced string
# ---------------------------------------------------------------------------
#
# LMS substrings are sorted by prefix tripling over (char, type) symbols
# (char+1)*2 + is_S, so L < S at equal characters and the substring end (0)
# is below everything. Equal names = equal (char, type) sequences of equal
# length, the reference's wstring_equal (src/table.rs:802-820).


def _lms_setup(text: torch.Tensor):
    """(idx, is_lms, sym_at) shared by both substring-naming widths."""
    n = text.shape[0]
    idx = _arange(n, text.device)
    is_s, is_lms = classify_types(text)
    sym2 = ((text + 1) * 2 + is_s.to(I32)).to(I32)
    # Inclusive substring end: next LMS position strictly after i (n if
    # none).
    nxt_incl = _suffix_min(torch.where(is_lms, idx, n))
    sub_end = torch.cat([nxt_incl[1:], nxt_incl.new_full((1,), n)])
    sym_ext = torch.cat([sym2, torch.zeros_like(sym2)])

    def sym_at(off: int) -> torch.Tensor:
        """Substring symbol at offset ``off`` from each LMS start (0 past
        the substring end)."""
        pos = idx + off
        v = sym_ext[torch.clamp(pos, max=2 * n - 1).long()]
        return torch.where(pos <= sub_end, v, 0)

    return idx, is_lms, sym_at


def _names(rank: torch.Tensor, is_lms: torch.Tensor):
    """(num_names, w_lms): distinct ranks over LMS positions, LMS count."""
    lms_sorted = torch.sort(torch.where(is_lms, rank, INF)).values
    uniq = torch.cat([
        lms_sorted[:1] != INF,
        (lms_sorted[1:] != lms_sorted[:-1]) & (lms_sorted[1:] != INF),
    ])
    counts = torch.stack([uniq.sum(), is_lms.sum()]).tolist()
    return counts[0], counts[1]


def _dense_rank(order: torch.Tensor, first_key: torch.Tensor,
                flag: torch.Tensor) -> torch.Tensor:
    """Scatter back dense ranks (cumsum of ``flag``) in text order; rows
    whose first key is INF (non-LMS) keep INF."""
    n = order.shape[0]
    dense = _cumsum32(flag)
    rank = torch.full((n,), INF, dtype=I32, device=order.device)
    rank[order.long()] = torch.where(first_key == INF, INF, dense)
    return rank


def _lms_substring_ranks(text: torch.Tensor, max_rounds: int = 2048,
                         stats: dict | None = None):
    """(rank, is_lms, num_names, w_lms): dense substring rank per LMS
    position (equal substrings share a rank), byte alphabet: three 10-bit
    symbols pack into one int32 word per round."""
    n = text.shape[0]
    idx, is_lms, sym_at = _lms_setup(text)

    def word_at(off: int) -> torch.Tensor:
        out = torch.zeros(n, dtype=I32, device=text.device)
        for j in range(3):
            out = (out << 10) | sym_at(off + j)
        return out

    key0 = torch.where(is_lms, word_at(0), INF)
    k_s, order = lexsort((key0,), (idx,))
    flag = torch.cat([k_s.new_zeros((1,)), (k_s[1:] != k_s[:-1]).to(I32)])
    rank = _dense_rank(order, k_s, flag)
    # A group stays active while its members tie AND their substrings
    # have not both ended (word != 0 at the next offset).
    off, rounds, active = 3, 0, True
    while active and rounds < max_rounds:
        word = torch.where(is_lms, word_at(off), 0)
        r_s, w_s, order = lexsort((rank, word), (idx,))
        tie = (r_s[1:] == r_s[:-1]) & (w_s[1:] == w_s[:-1])
        flag = torch.cat([r_s.new_zeros((1,)), (~tie).to(I32)])
        rank = _dense_rank(order, r_s, flag)
        still = tie & (w_s[1:] != 0) & (r_s[1:] != INF)
        active = bool(still.any())
        off += 3
        rounds += 1
    _bump(stats, "substring_rounds", rounds)
    num_names, w_lms = _names(rank, is_lms)
    return rank, is_lms, num_names, w_lms


def _lms_substring_ranks_wide(text: torch.Tensor, max_rounds: int = 1 << 30,
                              stats: dict | None = None):
    """Like ``_lms_substring_ranks`` for integer name alphabets, where
    (char, type) symbols no longer fit a 10-bit packing: each round sorts
    by three separate int32 symbol keys."""
    idx, is_lms, sym_at = _lms_setup(text)

    k0 = torch.where(is_lms, sym_at(0), INF)
    k1 = torch.where(is_lms, sym_at(1), 0)
    k2 = torch.where(is_lms, sym_at(2), 0)
    k0s, k1s, k2s, order = lexsort((k0, k1, k2), (idx,))
    diff = ((k0s[1:] != k0s[:-1]) | (k1s[1:] != k1s[:-1])
            | (k2s[1:] != k2s[:-1]))
    flag = torch.cat([k0s.new_zeros((1,)), diff.to(I32)])
    rank = _dense_rank(order, k0s, flag)

    off, rounds, active = 3, 0, True
    while active and rounds < max_rounds:
        wa = torch.where(is_lms, sym_at(off), 0)
        wb = torch.where(is_lms, sym_at(off + 1), 0)
        wc = torch.where(is_lms, sym_at(off + 2), 0)
        r_s, a_s, b_s, c_s, order = lexsort((rank, wa, wb, wc), (idx,))
        tie = ((r_s[1:] == r_s[:-1]) & (a_s[1:] == a_s[:-1])
               & (b_s[1:] == b_s[:-1]) & (c_s[1:] == c_s[:-1]))
        flag = torch.cat([r_s.new_zeros((1,)), (~tie).to(I32)])
        rank = _dense_rank(order, r_s, flag)
        # Still active: tied AND some symbol in the window was real.
        cont = (a_s[1:] != 0) | (b_s[1:] != 0) | (c_s[1:] != 0)
        still = tie & cont & (r_s[1:] != INF)
        active = bool(still.any())
        off += 3
        rounds += 1
    _bump(stats, "substring_rounds", rounds)
    num_names, w_lms = _names(rank, is_lms)
    return rank, is_lms, num_names, w_lms


def _build_reduced(sub_rank: torch.Tensor, is_lms: torch.Tensor, w_pad: int):
    """Reduced string of LMS-substring names in text order (padded with -1
    to ``w_pad``) and each position's LMS ordinal (reference P13 list,
    src/table.rs:512-530)."""
    lms_i = is_lms.to(I32)
    lms_ord = _cumsum32(lms_i) - lms_i
    reduced = torch.full((w_pad,), -1, dtype=I32, device=sub_rank.device)
    keep = is_lms & (lms_ord < w_pad)
    reduced[lms_ord[keep].long()] = sub_rank[keep]
    return reduced, lms_ord


def _rank_from_reduced_sa(is_lms: torch.Tensor, lms_ord: torch.Tensor,
                          sa_reduced: torch.Tensor, w_lms: int):
    """Map reduced-suffix ranks back to LMS class ranks per position."""
    w_pad = sa_reduced.shape[0]
    # Pads (-1) sort first and occupy the lowest (w_pad - w_lms) ranks.
    red_rank = torch.zeros(w_pad, dtype=I32, device=sa_reduced.device)
    red_rank[sa_reduced.long()] = (_arange(w_pad, sa_reduced.device)
                                   - (w_pad - w_lms))
    got = red_rank[torch.clamp(lms_ord, max=w_pad - 1).long()]
    return torch.where(is_lms, got, 0)


def _mask_lms_rank(is_lms: torch.Tensor, sub_rank: torch.Tensor):
    return torch.where(is_lms, sub_rank, 0)


_MAX_RECURSION_DEPTH = 64  # w halves per level; 64 covers any int32 text


def _lms_rank_via_reduction(text: torch.Tensor, w_pad: int, *,
                            depth: int = 0,
                            stats: dict | None = None) -> torch.Tensor:
    """LMS class ranks via the SA-IS reduction, host-stepped and
    recursive (reference src/table.rs:496-506): sort and name LMS
    substrings; if names repeat, suffix-sort the reduced string of names
    with this same pipeline and map the ranks back. ``stats["depth"]``
    records the deepest level taken."""
    if depth >= _MAX_RECURSION_DEPTH:  # pragma: no cover - log2 bound
        raise RuntimeError("SA-IS recursion exceeded its log2(n) bound")
    if stats is not None:
        stats["depth"] = max(stats.get("depth", 0), depth)
    if depth == 0:
        sub_rank, is_lms, num_names, w_lms = _lms_substring_ranks(
            text, stats=stats)
    else:
        sub_rank, is_lms, num_names, w_lms = _lms_substring_ranks_wide(
            text, stats=stats)
    if num_names == w_lms:
        return _mask_lms_rank(is_lms, sub_rank)
    reduced, lms_ord = _build_reduced(sub_rank, is_lms, w_pad)
    sa_reduced = _sa_padded_sais_ints(reduced, depth=depth + 1, stats=stats)
    return _rank_from_reduced_sa(is_lms, lms_ord, sa_reduced, w_lms)


def _sa_padded_sais_ints(vals: torch.Tensor, *, depth: int,
                         stats: dict | None = None) -> torch.Tensor:
    """Full padded SA of an int32 name string (values >= 0, -1 padding at
    the end) via one SA-IS level over the integer alphabet."""
    n_pad = vals.shape[0]
    w_pad = bucket_size(max(n_pad // 2, 8))
    lms_rank = _lms_rank_via_reduction(vals, w_pad, depth=depth, stats=stats)
    # Name alphabet: PAD+1 = 0 plus names shifted to 1..n_pad.
    n_sym = n_pad + 2
    return _derive_sa(vals, lms_rank, max_rounds=n_sym, n_sym=n_sym,
                      stats=stats)


def suffix_array_sais_recursive(data: bytes | np.ndarray,
                                stats: dict | None = None,
                                device=None) -> np.ndarray:
    """Suffix array (uint32 offsets) via the full SA-IS pipeline on
    ``device`` (``None`` = CUDA). ``stats`` (optional dict) receives
    ``depth`` (deepest recursion level, 0 = no reduction) and the rounds
    taken: ``l_rounds``, ``s_rounds``, ``substring_rounds``, summed over
    levels."""
    dev = resolve_device(device)
    arr = _as_u8(data)
    n = int(arr.shape[0])
    if n == 0:
        return np.empty((0,), dtype=np.uint32)
    t, n_pad = _padded_on(arr, dev)
    w_pad = bucket_size(max(n_pad // 2, 8))
    lms_rank = _lms_rank_via_reduction(t, w_pad, stats=stats)
    sa_full = _derive_sa(t, lms_rank, stats=stats).cpu().numpy()
    return sa_full[n_pad - n:].astype(np.uint32)
