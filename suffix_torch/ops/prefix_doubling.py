"""Suffix-array construction by prefix doubling, in PyTorch.

Port of ``suffix_tpu/ops/prefix_doubling.py``, the JAX package's default
build (``engine="device"``). The algorithm and every routing decision are
the same, so both packages take the same route on the same corpus and
return the same array:

  initial: sort suffixes by their first h0 characters (packed words);
  round:   key(i) = (rank[i], rank[i+k], rank[i+2k], rank[i+3k]),
           sort, dense rerank by a flag cumsum, k *= 4;
  stop when every rank is distinct.

One departure from the JAX package: the padding slots (positions ``>= n``
of the padded text) take distinct negative initial keys, shortest padding
suffix lowest (``_key_pads``). In the JAX package they tie in groups of
``h0`` that no round splits, so a padded text runs full-width rounds until
``k >= 2 n_pad``; here the rounds stop once the text's own suffixes are
distinct. On a padded text the round trajectory (``rounds``, ``h_final``,
the tie masses) is therefore shorter than the JAX package's; the route
labels and the arrays stay equal, and a text with no padding slot (``n`` a
power of two) takes the same trajectory in both.

Routes (``device_build_closure``): the exact-periodic closed form, the
patched near-periodic engine (``ops/patched.py``; a corpus whose host
tables are over budget falls through), the alphabet-adaptive dense-coded
initial sort, the two-phase tie-compacted engine, and the byte ladder.

What changes from JAX to PyTorch:

- ``lax.while_loop`` / ``lax.cond`` become host loops with one scalar
  readback per round; the final round skips the route-home scatter.
- ``lax.sort`` with several keys becomes ``ops.sort.lexsort`` (stable
  where JAX's is not; only outputs are compared).
- ``_invert_permutation`` is the scatter ``out[sa] = values``: ``sa`` is
  a permutation, so it equals JAX's key-sort.
- ``lax.cummax`` of ``where(flag, j, 0)`` becomes ``_last_flag_index``, a
  scan plus a gather; ``torch.cummax`` scans a 1-D tensor in one thread
  block on CUDA.
- ``torch.cumsum`` of int32 returns int64, so every cumsum names its
  dtype.
- ``jax.named_scope`` phases become ``torch.profiler.record_function``
  scopes with the same ``P0_``..``P6_`` names; the two-phase engine's
  host-stepped parts, unnamed in JAX, are ``T1_``..``T3_``.
- ``index_dtype="u64"`` runs int64 indices; it needs no global switch.

Staging (the doubling routes): the host probes the text for a period,
then uploads its ``n`` bytes once; the card widens them to the PAD-padded
int32 text, counts them for the adaptive plan (``kernels.byte_histogram``,
one readback of 256 counts) and, on the adaptive route, codes them
through the plan's LUT. The JAX package stages the same arrays on its
host.

The build's layers are spans of the recorder (``utils/profiling.py``)
inside ``SuffixTable.new``'s ``build`` root: ``build.probe``,
``build.upload`` (the text's bytes), ``build.pack`` (the widening and
the coding on the device) and ``build.plan`` (the count, its readback and
``_adaptive_plan``) in ``device_build_closure``; ``build.dispatch`` (the
rounds, to the device's end), ``build.download`` (the suffix array's
``n`` kept slots, the padding sliced off on the device, copied once into
the host array the table keeps) and ``build.finish`` (that array taken as
unsigned by a view, no cast) in ``suffix_array_bytes``;
``build.readback`` around each host read of a device value. Counters:
``rounds`` (quadrupling rounds of both phases), ``host_syncs`` (one a
readback), ``pad_slots`` (padding slots given distinct keys, read with
the initial sort's readback; 0 when the text fills its bucket),
``h2d_bytes`` and ``d2h_bytes`` (the pageable copies of the staged input
and of the suffix array's ``n`` kept slots; 0 on the CPU, where nothing
is copied; the 1 KiB LUT and the readbacks are not counted). The patched
route's rotation-width build (``ops/patched.py``) is a ``build.rotation``
root of its own, inside the job's ``build.probe``.

One hand-written kernel lies on this path, ``byte_histogram`` for the
plan's counts; the rest is library sorts, scans, slices, gathers and
scatters, in JAX as here.
"""

from __future__ import annotations

import contextlib
import functools
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from suffix_torch.device import resolve_device
from suffix_torch.ops import kernels, patched
from suffix_torch.ops.padding import PAD, bucket_size, bucket_size_fine
from suffix_torch.ops.sort import lexsort
from suffix_torch.utils.profiling import annotate, count, span

I32 = torch.int32

INIT_WORDS = 2  # initial sort orders by INIT_WORDS * 3 characters


def pick_init_words(n_pad: int) -> int:
    """Size-dependent initial sort width, copied from the JAX package so
    that both take the same route: 4 words up to 2^20 padded bytes, 3
    from 2^24, INIT_WORDS between."""
    if n_pad <= (1 << 20):
        return 4
    if n_pad >= (1 << 24):
        return 3
    return INIT_WORDS


def _initial_words(text: torch.Tensor, init_words: int) -> list[torch.Tensor]:
    """Pack the leading 3*init_words bytes into int32 words (3 x 9 bits).

    Symbols are byte + 1, so PAD (-1) and the past-the-end fill both
    become 0 and compare below every real byte (the sentinel rule)."""
    n = text.shape[0]
    sym = (text + 1).to(I32)
    sym_ext = torch.cat([sym, sym.new_zeros((3 * init_words - 1,))])
    s = [sym_ext[j:j + n] for j in range(3 * init_words)]
    return [(s[3 * w] << 18) | (s[3 * w + 1] << 9) | s[3 * w + 2]
            for w in range(init_words)]


def _invert_permutation(sa: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[sa[j]] = values[j] (``sa`` is a permutation)."""
    out = torch.empty_like(values)
    out[sa.long()] = values
    return out


def _last_flag_index(flag: torch.Tensor) -> torch.Tensor:
    """For each j, the index of the last True of ``flag`` at or before j
    (``flag[0]`` must be True), int64: JAX's
    ``lax.cummax(where(flag, j, 0))`` as ``starts[cumsum(flag) - 1]``."""
    with _readback():  # nonzero reads its output size back
        starts = torch.nonzero(flag).flatten()
    return starts[torch.cumsum(flag, 0) - 1]


def _adjacent_diff(cols) -> torch.Tensor:
    """True where sorted row i+1 differs from row i in any column."""
    diff = cols[0][1:] != cols[0][:-1]
    for col in cols[1:]:
        diff = diff | (col[1:] != col[:-1])
    return diff


def _dense_rank(diff: torch.Tensor, dtype) -> torch.Tensor:
    """Dense rank of each sorted row: cumsum of [0, diff]."""
    flag = torch.cat([diff.new_zeros((1,)), diff])
    return torch.cumsum(flag, 0, dtype=dtype)


def _tie_mass(diff: torch.Tensor) -> torch.Tensor:
    """Number of rows in tie groups of size >= 2."""
    one = diff.new_ones((1,))
    flag = torch.cat([one, diff])
    nxt = torch.cat([diff, one])
    return diff.shape[0] + 1 - (flag & nxt).sum()


def _shifted_ranks(rank: torch.Tensor, k: int):
    """rank[i + m*k] for m = 1, 2, 3, with -1 past the end: contiguous
    slices of [rank | -1 ...]."""
    n = rank.shape[0]
    rank_ext = torch.cat([rank, torch.full_like(rank, -1)])
    out = []
    for mult in (1, 2, 3):
        off = min(mult * k, n)
        out.append(rank_ext[off:off + n])
    return out


TRAJ_SLOTS = 24  # >= max quadrupling rounds for any 2^31-byte corpus


@contextlib.contextmanager
def _readback():
    """A host read of a device value: a ``build.readback`` span and one
    ``host_syncs``."""
    count("host_syncs")
    with span("build.readback"):
        yield


def _rerank(cols, dtype, with_mass: bool, pads=None):
    """(dense, done, mass) of sorted key columns: dense ranks, whether
    every row is distinct, and (``with_mass``) the tie mass, with one
    readback. ``pads``, a device count, rides in the same readback into
    the counter ``pad_slots``."""
    diff = _adjacent_diff(cols)
    dense = _dense_rank(diff, dtype)
    probe = [dense[-1]] + ([_tie_mass(diff)] if with_mass else [])
    if pads is not None:
        probe.append(pads)
    with _readback():
        read = torch.stack([p.to(torch.int64) for p in probe]).tolist()
    if pads is not None:
        count("pad_slots", read[-1])
    return (dense, read[0] == dense.shape[0] - 1,
            read[1] if with_mass else None)


def _key_pads(words) -> torch.Tensor:
    """Give every padding slot a distinct negative word 0, in place, and
    return their number (a device scalar).

    A padding slot is one whose word 0 is 0: every character it packs is
    PAD or past the end, while a real byte codes to at least 1. The slots
    ``>= n`` get ``n - 1 - i``, so the shortest padding suffix is the
    lowest, the order of the padded string with past-the-end lowest, and
    every real suffix stays above them. Without this the padding suffixes
    tie in groups of ``h0`` that no round splits. ``words`` are the
    engine's own tensors, made from the staged input for this dispatch."""
    w0 = words[0]
    below = torch.cumsum(w0 == 0, 0, dtype=w0.dtype)
    w0.sub_(below)
    return below[-1]


def _initial_round(words, idx: torch.Tensor, with_mass: bool):
    """Key the padding slots, then sort by the initial words. Returns
    (rank, sa, dense, done, mass): ``rank`` in text order (the dense
    ranks themselves when done)."""
    with record_function("P1_initial_sort"):
        pads = _key_pads(words)
        *cols, sa = lexsort(words, (idx,))
    with record_function("P2_initial_rank"):
        dense, done, mass = _rerank(cols, idx.dtype, with_mass, pads)
        rank = dense if done else _invert_permutation(sa, dense)
    return rank, sa, dense, done, mass


def _quadrupling_round(rank: torch.Tensor, k: int, idx: torch.Tensor,
                       with_mass: bool):
    """One round: sort by (rank[i], rank[i+k], rank[i+2k], rank[i+3k]).
    Returns (rank, sa, dense, done, mass); the route-home scatter that
    feeds the next round is skipped when the round is the last."""
    count("rounds")
    with record_function("P3_shift_ranks"):
        s1, s2, s3 = _shifted_ranks(rank, k)
    with record_function("P4_round_sort"):
        r1, r2, r3, r4, sa = lexsort((rank, s1, s2, s3), (idx,))
    with record_function("P5_dense_rerank"):
        dense, done, mass = _rerank((r1, r2, r3, r4), idx.dtype, with_mass)
    if not done:
        with record_function("P6_route_home"):
            rank = _invert_permutation(sa, dense)
    return rank, sa, dense, done, mass


# ---------------------------------------------------------------------------
# One doubling loop for both engines. The classic engine runs it until
# every rank is distinct (m_cap = 0); the two-phase engine stops it once the
# tie mass fits a compact budget, then runs tie-compacted rounds over just
# the tied lanes, with POSITIONAL ranks (rank = sorted index of the first
# member of the suffix's tie class), so tie groups refine inside disjoint
# intervals.
# ---------------------------------------------------------------------------

TWO_PHASE_MIN = 1 << 20   # below: the classic engine
TIE_CAP_FRAC = 8          # phase 2 starts once ties <= n / 8


class _Doubled(NamedTuple):
    """The state a doubling loop stops in."""
    sa: torch.Tensor     # the suffixes, sorted by their first k characters
    dense: torch.Tensor  # their dense ranks
    k: int
    done: bool           # every rank is distinct
    mass: int | None     # the tie mass, None where it was not read
    rounds: int          # quadrupling rounds run
    traj: list           # the mass after the initial sort and each round
    m_cap: int           # the loop's stop mass (0: the classic engine)


def _doubling(words, h0: int, index_dtype, m_cap: int = 0,
              stats=None) -> _Doubled:
    """Dense-rank doubling given initial key words that order suffixes by
    their first ``h0`` characters. ``idx`` rides as a payload: tied keys
    get equal dense ranks, so its order inside a tie is irrelevant.

    Stops when every rank is distinct, once ``k >= 2 n``, or once the TIE
    MASS (suffixes in tie groups of size >= 2) is at most ``m_cap``: 0
    only when the ranks are distinct, so ``m_cap = 0`` (the classic
    engine) runs to distinct ranks. The mass is read, in each round's one
    readback, where something reads it: ``m_cap > 0`` or a ``stats`` dict
    (for the trajectory ``_two_phase_build`` records)."""
    n = words[0].shape[0]
    idx = torch.arange(n, dtype=index_dtype, device=words[0].device)
    with_mass = m_cap > 0 or stats is not None
    rank, sa, dense, done, mass = _initial_round(words, idx, with_mass)
    traj, k, rounds = [mass], h0, 0
    while not done and k < 2 * n and (mass is None or mass > m_cap):
        rank, sa, dense, done, mass = _quadrupling_round(rank, k, idx,
                                                         with_mass)
        traj.append(mass)
        k *= 4
        rounds += 1
    return _Doubled(sa, dense, k, done, mass, rounds, traj, m_cap)


def _packed_words(codes: torch.Tensor, n_words: int, bits: int,
                  cpw: int) -> list[torch.Tensor]:
    """Dense-coded initial words: a pair-packing ladder, then ``cpw``
    composed from the ladder's binary components (10 = 8 + 2)."""
    n = codes.shape[0]

    def shifted(arr, off):
        if off == 0:
            return arr
        return torch.cat([arr, arr.new_zeros((off,))])[off:off + n]

    with record_function("P0_dense_pack"):
        ladder = [codes]
        width = 1
        while 2 * width <= cpw:
            prev = ladder[-1]
            ladder.append((prev << (bits * width)) | shifted(prev, width))
            width *= 2
        comp = None
        off = 0
        for kk in range(len(ladder) - 1, -1, -1):
            w = 1 << kk
            if cpw & w:
                part = shifted(ladder[kk], off)
                comp = part if comp is None else (comp << (bits * w)) | part
                off += w
        return [shifted(comp, w * cpw) for w in range(n_words)]


def _to_positional(dense_sorted: torch.Tensor, sa_sorted: torch.Tensor):
    """Phase boundary: dense ids -> positional ranks, the tied suffix ids
    compacted to the front (stable), and the exact tie mass (int)."""
    dtype = dense_sorted.dtype
    diff = dense_sorted[1:] != dense_sorted[:-1]
    one = diff.new_ones((1,))
    flag = torch.cat([one, diff])
    nxt = torch.cat([diff, one])
    prank_sorted = _last_flag_index(flag).to(dtype)
    tied = ~(flag & nxt)
    rank_pos = _invert_permutation(sa_sorted, prank_sorted)
    order = torch.sort(torch.where(tied, 0, 1).to(I32), stable=True).indices
    with _readback():
        mass = int(tied.sum())
    return rank_pos, sa_sorted[order], mass


def _phase2_round(rank: torch.Tensor, tied_idx: torch.Tensor, k: int):
    """One tie-compacted quadrupling round over the lanes ``tied_idx``:
    each tie group refines inside its positional interval [r0, r0+g).
    Returns (rank, k * 4, done); ``rank`` is updated in place."""
    count("rounds")
    n = rank.shape[0]
    lanes = tied_idx.long()
    r0 = rank[lanes]

    def sh(mult):
        p = lanes + mult * k
        v = rank[torch.clamp(p, max=n - 1)]
        return torch.where(p < n, v, -1)

    s0, s1, s2, s3, sidx = lexsort((r0, sh(1), sh(2), sh(3)), (tied_idx,))
    one = torch.ones((1,), dtype=torch.bool, device=rank.device)
    diff_g = torch.cat([one, s0[1:] != s0[:-1]])
    diff_any = torch.cat([one, _adjacent_diff((s0, s1, s2, s3))])
    group_start = _last_flag_index(diff_g)
    class_start = _last_flag_index(diff_any)
    new_rank = s0 + (class_start - group_start).to(rank.dtype)
    rank[sidx.long()] = new_rank
    with _readback():
        done = bool(diff_any[1:].all())
    return rank, k * 4, done


def _final_sa(rank: torch.Tensor) -> torch.Tensor:
    """The SA from final (all distinct) positional ranks."""
    idx = torch.arange(rank.shape[0], dtype=rank.dtype, device=rank.device)
    return _invert_permutation(rank, idx)


def _two_phase_build(state: _Doubled, n_pad: int, stats=None) -> torch.Tensor:
    """Host loop: finish a doubling state to the full SA. A done state is
    its sorted suffixes (always so for ``m_cap = 0``); otherwise phase 2
    refines the ties. ``stats`` receives the engine's internals: the
    classic engine's rounds, ``h_final`` and tie trajectory, or the
    two-phase engine's stop state and phase-2 rounds."""
    k = state.k
    if stats is not None:
        if state.m_cap == 0:
            stats.update(rounds=state.rounds, h_final=k,
                         tie_trajectory=state.traj[:TRAJ_SLOTS])
        else:
            stats.update(h_phase1=k, tie_mass_at_switch=state.mass,
                         phase2_rounds=0)
    if state.done:
        return state.sa
    with record_function("T1_to_positional"):
        rank, tied_idx_full, mass = _to_positional(state.dense, state.sa)
    m_pad = min(bucket_size(max(mass, 1), minimum=256), n_pad)
    tied_idx = tied_idx_full[:m_pad]
    rounds = 0
    while True:
        with record_function("T2_phase2_round"):
            rank, k, done = _phase2_round(rank, tied_idx, k)
        rounds += 1
        if done or k >= 2 * n_pad:
            break
    if stats is not None:
        stats["phase2_rounds"] = rounds
        stats["m_pad"] = m_pad
        stats["h_final"] = int(k)
    with record_function("T3_final_sa"):
        return _final_sa(rank)


def _suffix_array_padded(text: torch.Tensor, init_words: int = INIT_WORDS,
                         index_dtype=I32) -> torch.Tensor:
    """Suffix array of a PAD-padded int32 text: the full permutation of
    [0, n_pad), the exact suffix array of the padded sequence with
    past-the-end lowest. Its first ``pad_len`` slots are the all-PAD
    suffixes in a defined order, shortest first (``n_pad - 1`` down to
    ``n``); the text's suffixes follow."""
    return _doubling(_initial_words(text, init_words), 3 * init_words,
                     index_dtype).sa


# Routing constants, copied from the JAX package so that both take the
# same route on the same corpus.
ADAPTIVE_PACK_MIN = 1 << 17
ADAPTIVE_SLACK_CHARS = 12
ADAPTIVE_MAX_WORDS = 6
ADAPTIVE_MAX_WORDS_REPEAT = 8
PROBE_LEN = 64
PROBE_WINDOW = 8 << 20


def _repeat_lcp_lower_bound(arr: np.ndarray) -> int | None:
    """Lower bound on the corpus' max LCP from self-repetition, or None:
    if the leading PROBE_LEN bytes recur at offset p, suffixes 0 and p
    share the common prefix of arr[p:] and arr."""
    n = int(arr.size)
    if n < 4 * PROBE_LEN:
        return None
    window = arr[:min(n, PROBE_WINDOW)].tobytes()
    p = window.find(window[:PROBE_LEN], 1)
    if p == -1:
        return None
    eq = arr[p:] == arr[:n - p]
    return int(np.argmin(eq)) if not eq.all() else n - p


def _adaptive_plan(arr: np.ndarray, n_pad: int, with_meta: bool = False,
                   lcp_lb="auto", counts: np.ndarray | None = None):
    """(lut, bits, cpw, n_words) for the dense-coded initial sort, or
    None when the byte ladder is at least as good. ``with_meta=True``
    returns (plan, sigma, repeat_hit). ``lcp_lb``: "auto" probes for a
    long self-repeat; callers that probed pass the bound (or None).
    ``counts``: the 256 byte counts of ``arr``, where the caller has them
    (``device_build_closure`` counts on the device, the sharded build sums
    its ranks' blocks); else counted here."""
    if counts is None:
        counts = np.bincount(arr, minlength=256)
    present = np.flatnonzero(counts)
    sigma = int(present.size)
    if sigma < 1:
        return (None, sigma, False) if with_meta else None
    bits = max(1, int(np.ceil(np.log2(sigma + 1))))
    cpw = 30 // bits
    est = int(np.ceil(2 * np.log(max(n_pad, 2))
                      / np.log(max(sigma, 2)))) + ADAPTIVE_SLACK_CHARS
    n_words = max(1, -(-est // cpw))
    if n_words > ADAPTIVE_MAX_WORDS:
        n_words = None
    if lcp_lb == "auto":
        with span("build.probe"):
            lcp_lb = _repeat_lcp_lower_bound(arr)
    if lcp_lb is not None and lcp_lb > cpw * ADAPTIVE_MAX_WORDS:
        # A long repeat cannot be cleared by the one-shot sort: pick the
        # width that minimizes quadrupling rounds instead.

        def rounds(h0: int) -> int:
            r, h = 0, h0
            while h <= lcp_lb:
                h *= 4
                r += 1
            return r

        n_words = min(range(1, ADAPTIVE_MAX_WORDS_REPEAT + 1),
                      key=lambda w: (rounds(cpw * w), w))
    repeat_hit = (lcp_lb is not None
                  and lcp_lb > cpw * ADAPTIVE_MAX_WORDS)
    plan = None
    if (n_words is not None
            and cpw * n_words > 3 * pick_init_words(n_pad)):
        lut = np.zeros(256, np.int32)
        lut[present] = np.arange(1, sigma + 1, dtype=np.int32)
        plan = (lut, bits, cpw, n_words)
    return (plan, sigma, repeat_hit) if with_meta else plan


_INDEX_DTYPES = {"u32": (I32, np.uint32), "u64": (torch.int64, np.uint64)}


def suffix_array_bytes(data, padding: str = "pow2", index_dtype: str = "u32",
                       device=None, stats=None) -> np.ndarray:
    """Suffix array (unsigned byte offsets) of ``data``, built on
    ``device`` (``None`` = CUDA): strict byte-lexicographic order of all
    suffixes.

    ``padding``: "pow2" or "fine" (<= 12.5 % padded overhead).
    ``index_dtype``: "u32" (texts < 2^31 padded bytes), "u64" (int64
    indices on the device, ``uint64`` out) or "auto" (u64 from 2^31).
    ``stats`` (optional dict) gains the keys of
    ``suffix_tpu/utils/metrics.py::build_stats`` for this engine: the
    route label as ``engine``, ``n_pad``, the closure's routing facts and
    engine internals, and the dispatch's ``elapsed_s`` and ``bytes_per_s``.
    """
    dev = resolve_device(device)
    arr = (np.frombuffer(bytes(data), dtype=np.uint8)
           if isinstance(data, (bytes, bytearray))
           else np.asarray(data, dtype=np.uint8))
    n = int(arr.shape[0])
    n_pad0 = (bucket_size(n) if padding == "pow2"
              else bucket_size_fine(max(n, 1)))
    if index_dtype == "auto":
        index_dtype = "u64" if n_pad0 >= (1 << 31) else "u32"
    if index_dtype not in _INDEX_DTYPES:
        raise ValueError(f"unknown index_dtype: {index_dtype!r}")
    if index_dtype == "u32" and n_pad0 >= (1 << 31):
        raise ValueError(
            "text needs >= 2^31 padded bytes: pass index_dtype='u64'")
    dtype, out_dtype = _INDEX_DTYPES[index_dtype]
    if n == 0 and stats is None:
        return np.empty((0,), dtype=out_dtype)
    dispatch, label = device_build_closure(arr, n_pad0, index_dtype=dtype,
                                           stats=stats, device=dev)
    annotate(route=label, n_pad=n_pad0)
    t0 = time.perf_counter()
    with span("build.dispatch"):
        sa_dev = dispatch()
        if sa_dev.device.type == "cuda":
            # The rounds' end on the device: the download is timed alone.
            torch.cuda.synchronize(sa_dev.device)
    # Padding suffixes (all-PAD) sort strictly first: the text's are the
    # last n slots, a view on the device. Only they come down, once, into
    # the host array the table keeps (on the CPU a copy of its own, so the
    # table shares no memory with the dispatch).
    with span("build.download"):
        sa = sa_dev[n_pad0 - n:].to("cpu", copy=True).numpy()
    count("d2h_bytes", sa.nbytes if sa_dev.device.type != "cpu" else 0)
    dt = time.perf_counter() - t0
    if stats is not None:
        stats.update(engine=label, n_pad=n_pad0)
        stats.setdefault("engine_family", "device")
        stats.update(elapsed_s=round(dt, 6),
                     bytes_per_s=round(n / max(dt, 1e-12), 1))
    # Positions are below 2^31 (2^63 on u64): the signed values are the
    # unsigned ones, taken by a view with no host copy.
    with span("build.finish"):
        return sa.view(out_dtype)


# Two-phase routing gate, copied from the JAX package.
TWO_PHASE_SIGMA_MIN = 16
TWO_PHASE_FORCE = False  # tests flip this to cover every class

# ---------------------------------------------------------------------------
# Periodic-corpus closed form: for a verified exact minimal period q, the
# SA follows from the small SA of V = T[:2q] ++ T[n-q+1:] (rotation order
# and the q-1 short tail suffixes) plus an arithmetic-chain expansion,
# each residue class in descending start order. The derivation is in
# suffix_tpu/ops/prefix_doubling.py.
# ---------------------------------------------------------------------------

PERIODIC_MIN_TILES = 8
PERIODIC_MAX_PERIOD = 1 << 22


_PROBE_ANCHORS = (0, 7 * PROBE_LEN + 1, (1 << 16) + 13)
PATCH_MAX_DEFECTS = 512


def _period_probe(arr: np.ndarray):
    """(anchor0_candidate, best_candidate), each (p, n_defects,
    first_defect_or_lcp, defect_positions_or_None) or None: a candidate
    period from one ``bytes.find`` per anchor, verified with one
    vectorized compare."""
    n = int(arr.size)
    if n < 4 * PROBE_LEN:
        return None, None
    window = arr[:min(n, PROBE_WINDOW)].tobytes()
    out0 = None
    best = None
    for a in _PROBE_ANCHORS:
        if a + PROBE_LEN >= len(window):
            break
        j = window.find(window[a:a + PROBE_LEN], a + 1)
        if j == -1:
            continue
        p = j - a
        if p <= 0:
            continue
        neq = arr[p:] != arr[:n - p]
        cnt = int(np.count_nonzero(neq))
        first = int(np.argmax(neq)) if cnt else (n - p)
        defects = (np.flatnonzero(neq).astype(np.int64)
                   if 0 < cnt <= PATCH_MAX_DEFECTS else None)
        cand = (p, cnt, first, defects)
        if a == 0:
            out0 = cand
        if best is None or cnt < best[1]:
            best = cand
        if cnt == 0 or defects is not None:
            break
    return out0, best


def _periodic_expand(sa_v: torch.Tensor, q: int, n: int,
                     n_pad: int) -> torch.Tensor:
    """Expand the padded SA of the PAD-padded V = T[:2q] ++ T[n-q+1:]
    into the full padded SA."""
    b_v = sa_v.shape[0]
    dtype = sa_v.dtype
    dev = sa_v.device
    len_v = 3 * q - 1
    pad_v = b_v - len_v
    pos = torch.arange(b_v, dtype=dtype, device=dev)
    keep = (pos >= pad_v) & ((sa_v < q) | ((sa_v >= 2 * q) & (sa_v < len_v)))
    # Compaction of the kept entries in SA order: exactly 2q - 1 survive.
    key = torch.where(keep, pos, pos + b_v)
    order = sa_v[torch.sort(key).indices]
    valid = pos < 2 * q - 1
    rot = valid & (order < q)
    # Class size of rotation phi: members phi, phi+q, ... <= n - q.
    m = torch.where(rot, (n - q - torch.clamp(order, max=q - 1)) // q + 1,
                    valid.to(dtype))
    start = torch.cumsum(m, 0, dtype=dtype) - m + (n_pad - n)
    val0 = torch.where(rot, order + (m - 1) * q, n - q + 1 + (order - 2 * q))
    val0 = torch.where(valid, val0, 0)
    # Step functions over the output slots: a delta index_add_ over the
    # in-range starts (JAX's .at[start].add(mode="drop")), then a cumsum.
    in_range = start < n_pad
    slot_of = torch.where(in_range, start, 0).long()

    def rep(x):
        prev = torch.cat([x.new_zeros((1,)), x[:-1]])
        delta = torch.zeros((n_pad,), dtype=dtype, device=dev)
        delta.index_add_(0, slot_of, torch.where(valid & in_range, x - prev, 0))
        return torch.cumsum(delta, 0, dtype=dtype)

    slot = torch.arange(n_pad, dtype=dtype, device=dev)
    out = rep(val0) - (slot - rep(start)) * q
    return torch.where(slot < n_pad - n, n_pad - 1 - slot, out)


def _periodic_dispatch(arr: np.ndarray, q: int, n_pad: int, index_dtype,
                       device):
    """Build closure for a verified exact-period corpus: the device SA of
    the 3q-1-byte V plus the closed-form expansion."""
    n = int(arr.size)
    with span("build.pack"):
        v = np.concatenate([arr[:2 * q], arr[n - q + 1:]])
        b_v = bucket_size(int(v.size))
        v_pad = np.full((b_v,), PAD, np.int32)
        v_pad[:v.size] = v
    v_dev = _upload(v_pad, device)
    iw = pick_init_words(b_v)

    def dispatch():
        sa_v = _suffix_array_padded(v_dev, init_words=iw,
                                    index_dtype=index_dtype)
        return _periodic_expand(sa_v, q, n, n_pad)

    return dispatch, f"periodic(q={q})"


def _upload(host: np.ndarray | torch.Tensor, device) -> torch.Tensor:
    """A staged host array on ``device``: one pageable copy, the span
    ``build.upload``. ``host`` may be a CPU tensor over a host array."""
    with span("build.upload"):
        src = host if isinstance(host, torch.Tensor) else \
            torch.from_numpy(host)
        out = src.to(device)
    count("h2d_bytes", host.nbytes if out.device.type != "cpu" else 0)
    return out


def _stage_text(arr: np.ndarray, n_pad: int, device) -> torch.Tensor:
    """The PAD-padded int32 text (``n_pad`` slots) on ``device``, from one
    upload of its ``n`` bytes, widened there. A read-only ``arr`` (the
    caller's text) is read in place and never written, on the CPU too."""
    host = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        src = torch.from_numpy(host)
    raw = _upload(src, device)
    with span("build.pack"):
        padded = torch.full((n_pad,), PAD, dtype=I32, device=raw.device)
        padded[:raw.shape[0]] = raw
    return padded


COUNT_SLICE = 1 << 30  # values a byte_histogram call counts: < 2^31 a bin


def _device_byte_counts(padded: torch.Tensor) -> np.ndarray:
    """The 256 byte counts of a PAD-padded int32 text on its device, int64,
    with one readback. ``byte_histogram`` drops PAD and counts into int32
    bins, so it counts slices of COUNT_SLICE values, summed in int64."""
    total = torch.zeros(256, dtype=torch.int64, device=padded.device)
    for lo in range(0, padded.shape[0], COUNT_SLICE):
        total += kernels.byte_histogram(padded[lo:lo + COUNT_SLICE], 256)
    with _readback():
        return total.cpu().numpy()


def _code_text(padded: torch.Tensor, n: int, lut: np.ndarray) -> torch.Tensor:
    """The dense codes of a PAD-padded text on its device: ``lut`` of each
    of its ``n`` bytes, 0 in the padding (the host's ``lut[arr]`` padded
    with 0). The index is the int32 text itself: a uint8 index would read
    as a mask."""
    codes = torch.zeros_like(padded)
    lut_dev = torch.as_tensor(lut, dtype=I32, device=padded.device)
    torch.index_select(lut_dev, 0, padded[:n], out=codes[:n])
    return codes


def device_build_closure(arr: np.ndarray, n_pad: int, index_dtype=I32,
                         stats=None, device=None):
    """(dispatch, label): the production build for this corpus. Stages
    the input on ``device`` once and returns a re-dispatchable closure
    (what ``suffix_array_bytes`` runs) and the route label, letter for
    letter the JAX package's.

    ``stats`` (optional dict): routing facts now, and per dispatch the
    engine internals (rounds, h_final, tie trajectory, or the two-phase
    switch state), the keys ``suffix_tpu/utils/metrics.py`` fills."""
    dev = resolve_device(device)
    n = int(arr.shape[0])
    lcp_lb = None
    if n_pad >= ADAPTIVE_PACK_MIN:
        with span("build.probe"):
            cand0, best = _period_probe(arr)
        if cand0 is not None:
            p0, cnt0, first0, _ = cand0
            lcp_lb = first0  # first defect (or n - p0 when exact)
            if (cnt0 == 0 and p0 <= PERIODIC_MAX_PERIOD
                    and n // p0 >= PERIODIC_MIN_TILES):
                if stats is not None:
                    stats.update(engine_family="periodic", period=p0,
                                 defects=0)
                return _periodic_dispatch(arr, p0, n_pad, index_dtype, dev)
        if best is not None:
            pb, cntb, _, defb = best
            if (defb is not None and cntb > 0
                    and patched.PATCH_MIN_TILES <= n // pb
                    <= patched.PATCH_KMAX):
                # Nearly periodic (sparse verified defects): the
                # phase-pure closed-form engine, unless its host tables
                # refuse.
                disp = patched.patched_dispatch(arr, pb, defb, n_pad,
                                                index_dtype, stats=stats,
                                                device=dev)
                if disp is not None:
                    return disp
    t_dev = _stage_text(arr, n_pad, dev)
    plan, sigma, repeat_hit = None, 0, False
    if n_pad >= ADAPTIVE_PACK_MIN:
        with span("build.plan"):
            plan, sigma, repeat_hit = _adaptive_plan(
                arr, n_pad, with_meta=True, lcp_lb=lcp_lb,
                counts=_device_byte_counts(t_dev))
    two_phase = n_pad >= TWO_PHASE_MIN and (
        TWO_PHASE_FORCE or plan is None
        or (sigma >= TWO_PHASE_SIGMA_MIN and not repeat_hit))
    if plan is not None:
        lut, bits, cpw, n_words = plan
        with span("build.pack"):
            c_dev = _code_text(t_dev, n, lut)
        del t_dev  # the rounds read the codes alone
        h0 = cpw * n_words
        label = f"adaptive({bits}b x {h0}ch)"
        words = functools.partial(_packed_words, c_dev, n_words, bits, cpw)
    else:
        iw = pick_init_words(n_pad)
        h0 = 3 * iw
        label = f"ladder({iw}w)"
        words = functools.partial(_initial_words, t_dev, iw)
    m_cap = 0
    if two_phase:
        m_cap = n_pad // TIE_CAP_FRAC
        label += "+2phase"
    if stats is not None:
        stats.update(engine_family="two_phase" if two_phase else "classic",
                     sigma=sigma, repeat_hit=bool(repeat_hit), h0=h0)

    def dispatch():
        # The words are made anew each dispatch: _key_pads writes them.
        state = _doubling(words(), h0, index_dtype, m_cap, stats)
        return _two_phase_build(state, n_pad, stats)

    return dispatch, label
