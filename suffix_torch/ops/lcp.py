"""LCP arrays, in PyTorch.

Port of ``suffix_tpu/ops/lcp.py``. Contract (reference
src/table.rs:348-361): ``lcp[0] = 0`` and ``lcp[i]`` is the number of
equal leading bytes of the suffixes at ranks i-1 and i.

The device route reads the first 18 bytes of every adjacent pair from the
packed rank-order prefix keys (no gathers), then refines the pairs equal
through all of them ("survivors"): at most LCP_SURV_CHUNKED survivors by
windowed byte compares in chunks of 2048 lanes; up to n/64 by the staged
bulk ladder (``_lcp_bulk``: base compaction, packed-symbol stages, row
stages, finish); more go to the linear host Kasai. The thresholds are the
JAX package's, so both packages take the same route.

What changes from JAX to PyTorch:

- ``lax.while_loop`` / ``fori_loop`` become host loops with one readback
  a round (a block's round in the bulk stages).
- Survivor compaction is ``nonzero`` (a stable compaction) and the
  un-permute is a scatter, where JAX key-sorts both ways.
- ``cumprod(eq).sum(axis=1)`` (equal leading bytes of a window) is a
  first-mismatch ``argmax``.
- The native C++ Kasai is not ported, so the Kasai route is the host
  numpy ``kasai_host`` (JAX's own route when its native library is
  missing).
- The bulk stages run under ``record_function`` scopes ``L1_base_compact``,
  ``L2_packed_stage``, ``L3_rows_stage`` and ``L4_finish``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from suffix_torch.device import resolve_device
from suffix_torch.ops import search2
from suffix_torch.ops.padding import PAD, bucket_size

I32 = torch.int32

# Routing thresholds, copied from the JAX package.
LCP_SURV_CHUNKED = 2048      # one refine chunk
LCP_MAX_OFF = 8192           # chunked path: ~64 refine rounds of 128 B
LCP_SAMPLE_DENSE_FRAC = 2 / 64
LCP_SAMPLE_K = 1 << 16
LCP_BULK_MAX_OFF = 1 << 16   # bulk budget: deeper LCPs -> Kasai
# The bulk ladder: (kind, window, rounds) stages with a compaction of the
# live lanes between them; "packed" windows count symbols (3 a gathered
# int32), "rows" windows bytes (aligned 128-byte text rows). Rounds 0 on
# the last stage means "to LCP_BULK_MAX_OFF".
LCP_BULK_LADDER = (("packed", 15, 1), ("packed", 15, 2), ("packed", 45, 3),
                   ("rows", 2048, 4), ("rows", 16384, 0))


def _window(text: torch.Tensor, n_text: int, base: torch.Tensor, off: int,
            width: int) -> torch.Tensor:
    """(lanes, width) bytes text[base + off + j], PAD at and past
    ``n_text``."""
    pos = (base.long() + off)[:, None] + torch.arange(
        width, device=text.device)[None, :]
    w = text[torch.clamp(pos, max=text.shape[0] - 1)]
    return torch.where(pos < n_text, w, PAD)


def _run_length(eq: torch.Tensor) -> torch.Tensor:
    """Number of leading True entries of each row, int32."""
    ne = ~eq
    first = ne.to(torch.uint8).argmax(dim=1).to(I32)
    return torch.where(ne.any(dim=1), first, eq.shape[1])


def _equal_run(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Number of equal leading entries of each row pair, int32."""
    return _run_length(wa == wb)


def _lcp_padded(text: torch.Tensor, n_text: int, table: torch.Tensor,
                n_table: int, block: int = 128) -> torch.Tensor:
    """LCP of a padded table by windowed compares over every pair; entry
    0 and padded entries are 0."""
    n_pad = table.shape[0]
    prev = torch.cat([table[:1], table[:-1]])
    idx = torch.arange(n_pad, device=table.device)
    active0 = (idx > 0) & (idx < n_table)
    lcp = torch.zeros((n_pad,), dtype=I32, device=table.device)
    active = active0
    off = 0
    while bool(active.any()):
        run = _equal_run(_window(text, n_text, prev, off, block),
                         _window(text, n_text, table, off, block))
        lcp = torch.where(active, lcp + run, lcp)
        # The off guard ends the loop on duplicate table entries too.
        active = active & (run == block) & (off + block < n_text)
        off += block
    return torch.where(active0 | (idx == 0), lcp, 0)


def _survivor_count(pk, n_table: int) -> int:
    """Adjacent valid rank pairs equal through all packed key words."""
    n_pad = pk[0].shape[0]
    idx = torch.arange(n_pad, device=pk[0].device)
    eq = (idx > 0) & (idx < n_table)
    for word in pk:
        eq = eq & (word == torch.cat([word[:1], word[:-1]]))
    return int(eq.sum())


def _keyed_base(pk, n_table: int):
    """(lcp, undecided, valid): per-pair LCP over the first KEY_SYMS bytes
    from the packed keys, and the pairs equal through all of them."""
    n_pad = pk[0].shape[0]
    idx = torch.arange(n_pad, device=pk[0].device)
    valid = (idx > 0) & (idx < n_table)
    lcp = torch.zeros((n_pad,), dtype=I32, device=pk[0].device)
    undecided = valid
    for word in pk:
        prev = torch.cat([word[:1], word[:-1]])
        eq_word = word == prev
        # First differing symbol inside the word (3 x 9 bits, most
        # significant first). A 0 (past the end) symbol on one side
        # mismatches the other's real byte, so matched counts real bytes.
        s_cur = [(word >> (18 - 9 * j)) & 0x1FF for j in range(2)]
        s_prv = [(prev >> (18 - 9 * j)) & 0x1FF for j in range(2)]
        within = torch.where(s_cur[0] != s_prv[0], 0,
                             torch.where(s_cur[1] != s_prv[1], 1, 2))
        matched = torch.where(eq_word, 3, within).to(I32)
        lcp = torch.where(undecided, lcp + matched, lcp)
        undecided = undecided & eq_word
    return lcp, undecided, valid


def _lcp_keyed(text: torch.Tensor, n_text: int, table: torch.Tensor,
               n_table: int, pk, block: int = 128, max_off: int = 0):
    """(lcp, unresolved): LCP via the packed rank-order prefix keys, the
    survivors refined by ``block``-byte window rounds in chunks of
    2048 lanes. ``max_off`` > 0 stops a chunk at that byte offset; the
    lanes it leaves active are counted in ``unresolved``."""
    n_pad = table.shape[0]
    idx = torch.arange(n_pad, device=table.device)
    lcp, undecided, valid = _keyed_base(pk, n_table)
    prev_t = torch.cat([table[:1], table[:-1]])
    surv = torch.nonzero(undecided).flatten()
    cap = min(n_pad, 2048)
    unresolved = 0
    for c0 in range(0, surv.shape[0], cap):
        lanes = surv[c0:c0 + cap]
        ca, cp, cl = table[lanes], prev_t[lanes], lcp[lanes]
        active = torch.ones_like(lanes, dtype=torch.bool)
        off = search2.KEY_SYMS
        while bool(active.any()) and not (max_off and off >= max_off):
            run = _equal_run(_window(text, n_text, cp, off, block),
                             _window(text, n_text, ca, off, block))
            cl = torch.where(active, cl + run, cl)
            active = active & (run == block) & (off + block < n_text)
            off += block
        lcp[lanes] = cl
        unresolved += int(active.sum())
    return torch.where(valid | (idx == 0), lcp, 0), unresolved


# ---------------------------------------------------------------------------
# The staged bulk ladder: a constant number of stages over all survivors at
# once, the live lanes compacted to a dense prefix between stages. Rows
# (suffix, predecessor suffix, partial lcp, flag, original rank) move as a
# unit; the finish scatters the LCPs back by rank.
# ---------------------------------------------------------------------------


def _lcp_base_compact(table: torch.Tensor, n_table: int, pk):
    """Stage 0: the keyed base over the packed keys, then the survivor
    rows moved to the front (a stable compaction). Returns (a, b, lcp,
    flag, perm, num_surv): suffix, predecessor suffix, lcp so far and the
    live flag in compacted order, ``perm`` the original rank of each row
    (int64), ``num_surv`` an int."""
    lcp, undecided, _ = _keyed_base(pk, n_table)
    prev_t = torch.cat([table[:1], table[:-1]])
    surv = torch.nonzero(undecided).flatten()
    perm = torch.cat([surv, torch.nonzero(~undecided).flatten()])
    num_surv = int(surv.shape[0])
    flag = torch.arange(perm.shape[0], device=table.device) < num_surv
    return table[perm], prev_t[perm], lcp[perm], flag, perm, num_surv


def _pow2_block(budget: int, s_pad: int) -> int:
    """Lanes a row block: the budget rounded down to a power of two (so
    blocks tile the power-of-two ``s_pad``), at least 256."""
    return min(s_pad, max(256, 1 << (budget.bit_length() - 1)))


def _refine_blocks(a, b, lcp, flag, s_pad: int, width: int, row_block: int,
                   max_rounds: int, n_text: int, equal_run):
    """Extend the live lanes (``flag``) of the first ``s_pad`` rows by
    ``width``-wide windows at byte offset a + lcp vs b + lcp, ``row_block``
    rows at a time; a block loops until its lanes resolve or
    ``max_rounds`` rounds pass, one readback a round. ``equal_run(pa,
    pb)`` gives each lane's equal leading window entries. ``lcp`` and
    ``flag`` are updated in place; returns (lcp, flag, live lanes left)."""
    # s_pad is a power of two (bucket_size); a block grid that does not
    # tile it would leave tail lanes unrefined.
    assert s_pad % row_block == 0, (s_pad, row_block)
    for st in range(0, s_pad, row_block):
        blk = slice(st, st + row_block)
        ba, bb = a[blk].long(), b[blk].long()
        bl, bf = lcp[blk], flag[blk]
        rounds = 0
        while rounds < max_rounds and bool(bf.any()):
            run = equal_run(ba + bl, bb + bl)
            bl = torch.where(bf, bl + run, bl)
            # bl < n_text ends the loop on duplicate table entries too.
            bf = bf & (run == width) & (bl < n_text)
            rounds += 1
        lcp[blk], flag[blk] = bl, bf
    return lcp, flag, int(flag[:s_pad].sum())


def _bulk_refine_prefix(text: torch.Tensor, n_text: int, a, b, lcp, flag,
                        s_pad: int, w: int, row_block: int, max_rounds: int):
    """Row stage: ``w``-byte windows fetched as aligned 128-byte text rows
    (w // 128 + 1 a lane) and shifted in-row; element gathers where the
    padded text is not a multiple of 128 (tiny corpora)."""
    n_pad_t = text.shape[0]
    offs = torch.arange(w, device=text.device)
    aligned = n_pad_t % 128 == 0 and n_pad_t >= 256
    text2d = text.view(-1, 128) if aligned else None
    row_offs = torch.arange(w // 128 + 1, device=text.device)

    def gat(base):
        pos = base[:, None] + offs[None, :]
        if aligned:
            rows = torch.clamp((base // 128)[:, None] + row_offs[None, :],
                               max=n_pad_t // 128 - 1)
            wide = text2d[rows].reshape(base.shape[0], -1)
            v = wide.gather(1, (base % 128)[:, None] + offs[None, :])
        else:
            v = text[torch.clamp(pos, max=n_pad_t - 1)]
        return torch.where(pos < n_text, v, PAD)

    return _refine_blocks(a, b, lcp, flag, s_pad, w, row_block, max_rounds,
                          n_text, lambda pa, pb: _equal_run(gat(pa), gat(pb)))


def _text_words3(text: torch.Tensor) -> torch.Tensor:
    """9-bit symbols of the padded text, 3 an int32 (symbol = byte + 1;
    PAD and past the end are 0)."""
    n_pad = text.shape[0]
    sym = torch.where(text >= 0, text + 1, 0).to(I32)
    n_w = n_pad // 3 + 2
    s = torch.cat([sym, sym.new_zeros((3 * n_w - n_pad,))])
    return (s[0::3] << 18) | (s[1::3] << 9) | s[2::3]


def _packed_window(tw: torch.Tensor, base: torch.Tensor, S: int):
    """(lanes, S) symbols from byte offset ``base``: S // 3 + 2 gathered
    words a lane, then one static extraction per phase (base mod 3)."""
    dev = tw.device
    k = S // 3 + 2
    r = base % 3
    w = tw[torch.clamp((base // 3)[:, None]
                       + torch.arange(k, device=dev)[None, :],
                       0, tw.shape[0] - 1)]
    j = torch.arange(S, device=dev)
    outs = [(w[:, (p + j) // 3] >> (18 - 9 * ((p + j) % 3)).to(I32)) & 0x1FF
            for p in range(3)]
    return torch.where((r == 0)[:, None], outs[0],
                       torch.where((r == 1)[:, None], outs[1], outs[2]))


def _bulk_refine_packed(tw: torch.Tensor, n_text: int, a, b, lcp, flag,
                        s_pad: int, S: int, row_block: int, max_rounds: int):
    """Packed stage: ``S``-symbol windows, 3 bytes a gathered element. Two
    past-the-end symbols (0) would match; the in-bounds masks give the
    boundary mismatch instead."""
    offs = torch.arange(S, device=tw.device)

    def equal_run(pa, pb):
        in_a = pa[:, None] + offs[None, :] < n_text
        in_b = pb[:, None] + offs[None, :] < n_text
        eq = (_packed_window(tw, pa, S) == _packed_window(tw, pb, S))
        return _run_length(eq & in_a & in_b)

    return _refine_blocks(a, b, lcp, flag, s_pad, S, row_block, max_rounds,
                          n_text, equal_run)


def _bulk_compact_prefix(a, b, lcp, flag, perm, s_pad: int) -> None:
    """Move the live rows of the first ``s_pad`` rows to its front, rows
    as a unit, in place."""
    f = flag[:s_pad]
    order = torch.cat([torch.nonzero(f).flatten(),
                       torch.nonzero(~f).flatten()])
    for x in (a, b, lcp, flag, perm):
        x[:s_pad] = x[:s_pad][order]


def _bulk_finish(lcp_perm: torch.Tensor, perm: torch.Tensor,
                 n_table: int) -> torch.Tensor:
    """Scatter the LCPs back to rank order; entry 0 and pads are 0."""
    lcp = torch.empty_like(lcp_perm)
    lcp[perm] = lcp_perm
    idx = torch.arange(lcp.shape[0], device=lcp.device)
    return torch.where((idx > 0) & (idx < n_table), lcp, 0)


def _lcp_bulk(text_dev: torch.Tensor, n: int, tab_dev: torch.Tensor, pk,
              trace: list | None = None):
    """The bulk ladder: the final uint32 LCP array, or None when
    lanes deeper than LCP_BULK_MAX_OFF remain (the caller takes Kasai).

    ``trace`` (optional list) receives one dict a stage: its kind, window,
    lanes, round cap, live lanes in and left, and host seconds (each stage
    ends on a readback)."""
    n_pad = int(tab_dev.shape[0])
    t0 = time.perf_counter()
    with record_function("L1_base_compact"):
        a, b, lcp, flag, perm, n_act = _lcp_base_compact(tab_dev, n, pk)
    if trace is not None:
        trace.append({"stage": "base", "survivors": n_act,
                      "s": time.perf_counter() - t0})
    tw = None
    prev_act = n_act
    for i, (kind, w, rounds) in enumerate(LCP_BULK_LADDER):
        if n_act == 0:
            break
        t0 = time.perf_counter()
        scope = "L2_packed_stage" if kind == "packed" else "L3_rows_stage"
        with record_function(scope):
            if i > 0:
                _bulk_compact_prefix(a, b, lcp, flag, perm,
                                     min(bucket_size(prev_act, minimum=256),
                                         n_pad))
            s_pad = min(bucket_size(n_act, minimum=256), n_pad)
            if i == len(LCP_BULK_LADDER) - 1 and rounds == 0:
                rounds = max(1, LCP_BULK_MAX_OFF // w)
            if kind == "packed":
                if tw is None:
                    tw = _text_words3(text_dev)
                lcp, flag, n_left = _bulk_refine_packed(
                    tw, n, a, b, lcp, flag, s_pad, w,
                    _pow2_block((1 << 25) // w, s_pad), rounds)
            else:
                lcp, flag, n_left = _bulk_refine_prefix(
                    text_dev, n, a, b, lcp, flag, s_pad, w,
                    _pow2_block((1 << 27) // w, s_pad), rounds)
        if trace is not None:
            trace.append({"stage": kind, "w": w, "lanes": s_pad,
                          "rounds": rounds, "survivors": n_act,
                          "left": n_left, "s": time.perf_counter() - t0})
        prev_act, n_act = n_act, n_left
    if n_act > 0:
        return None  # beyond the bulk budget: linear Kasai wins
    with record_function("L4_finish"):
        out = _bulk_finish(lcp, perm, n)[:n].cpu().numpy()
    return out.astype(np.uint32)


def _kasai_route(text_bytes: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Linear-time host route for the auto fallback (numpy; the native
    C++ Kasai is not ported, ROADMAP.md Queue 1 item 4)."""
    return kasai_host(text_bytes, sa)


def _sampled_survivor_rate(t_np: np.ndarray, sa: np.ndarray,
                           k: int = LCP_SAMPLE_K) -> float:
    """Estimated fraction of adjacent SA pairs sharing >= KEY_SYMS bytes,
    from ``k`` sampled ranks on the host. Pairs where a suffix ends inside
    the window count as survivors (conservative)."""
    n = int(sa.shape[0])
    if n < 2:
        return 0.0
    k = min(k, n - 1)
    rng = np.random.default_rng(0x5A17)
    ranks = rng.integers(1, n, size=k)
    offs = np.arange(search2.KEY_SYMS, dtype=np.int64)
    a = sa[ranks].astype(np.int64)[:, None] + offs
    b = sa[ranks - 1].astype(np.int64)[:, None] + offs
    in_a = a < n
    in_b = b < n
    wa = t_np[np.minimum(a, n - 1)]
    wb = t_np[np.minimum(b, n - 1)]
    eq = (wa == wb) & in_a & in_b
    surv = np.all(eq | ~in_a | ~in_b, axis=1)
    return float(surv.mean())


def lcp_from_sa(text_bytes: np.ndarray, sa: np.ndarray, block: int = 128,
                pk=None, method: str = "auto", device=None) -> np.ndarray:
    """LCP array (uint32) of ``text_bytes`` and its SA, on ``device``
    (``None`` = CUDA).

    ``method="auto"`` routes by the survivor census, as the JAX package
    does: at most LCP_SURV_CHUNKED survivors -> the chunked keyed refine
    with a LCP_MAX_OFF budget (Kasai if lanes stay unresolved); else at
    most n/64 -> the bulk ladder (Kasai if lanes outlast
    LCP_BULK_MAX_OFF); else the host Kasai. A corpus of >= 2^20 bytes without ``pk``
    is first sampled on the host and sent to Kasai when clearly dense.
    ``method="device"`` runs the unbounded keyed refine.

    ``pk``: the table's flat rank-order key words, when its query index
    exists (else they are built here)."""
    n = int(sa.shape[0])
    if n == 0:
        return np.empty((0,), dtype=np.uint32)
    dev = resolve_device(device)
    n_pad = bucket_size(n)
    t_np = np.asarray(text_bytes, dtype=np.uint8)
    if method == "auto" and pk is None and n >= (1 << 20):
        if _sampled_survivor_rate(t_np, sa) > LCP_SAMPLE_DENSE_FRAC:
            return _kasai_route(t_np, sa)
    t_pad = np.full((n_pad,), PAD, dtype=np.int32)
    t_pad[:n] = t_np
    sa_pad = np.zeros((n_pad,), dtype=np.int32)
    sa_pad[:n] = sa
    t_dev = torch.from_numpy(t_pad).to(dev)
    tab_dev = torch.from_numpy(sa_pad).to(dev)
    if pk is None:
        pk = search2.packed_keys_rank_order(t_dev, tab_dev, n)
    if method == "auto":
        n_surv = _survivor_count(pk, n)
        if n_surv <= LCP_SURV_CHUNKED:
            out, unresolved = _lcp_keyed(t_dev, n, tab_dev, n, pk,
                                         block=block, max_off=LCP_MAX_OFF)
            if unresolved > 0:
                return _kasai_route(t_np, sa)
        elif n_surv <= n // 64:
            res = _lcp_bulk(t_dev, n, tab_dev, pk)
            if res is None:
                return _kasai_route(t_np, sa)
            return res
        else:
            return _kasai_route(t_np, sa)
    elif method == "device":
        out, _ = _lcp_keyed(t_dev, n, tab_dev, n, pk, block=block)
    else:
        raise ValueError(f"unknown LCP method: {method!r}")
    return out[:n].cpu().numpy().astype(np.uint32)


def kasai_host(text_bytes: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Linear-time Kasai LCP on the host (numpy scalar loop), over raw
    bytes: the test oracle and the auto route's fallback."""
    t = np.asarray(text_bytes, dtype=np.uint8)
    n = int(sa.shape[0])
    lcp = np.zeros(n, dtype=np.uint32)
    if n == 0:
        return lcp
    rank = np.zeros(n, dtype=np.int64)
    rank[sa.astype(np.int64)] = np.arange(n)
    h = 0
    for i in range(n):
        r = rank[i]
        if r == 0:
            h = 0
            continue
        j = int(sa[r - 1])
        while i + h < n and j + h < n and t[i + h] == t[j + h]:
            h += 1
        lcp[r] = h
        if h > 0:
            h -= 1
    return lcp
