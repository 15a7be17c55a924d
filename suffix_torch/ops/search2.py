"""Batched query engine: packed prefix keys + merge-join bounds.

Port of ``suffix_tpu/ops/search2.py``'s merge-join engine, on all three of
its index layouts (routed by ``table.SuffixTable._ensure_device``):

- flat keys (``build_query_index``, with_keys=True): every key word in
  rank order plus fences and blocks;
- deep keyless (``build_query_index_keyless``): 8 fence words (exact to 24
  bytes) and a second block of 6 ext words, so patterns to 42 bytes never
  byte-refine (``bounds_batch_merge_deep``);
- lean keyless (``build_query_index(with_keys=False)`` from LEAN_MIN_PAD
  on): fences and blocks written one word at a time.

The engine:

1. **Packed prefix keys** (built once per index, ``packed_keys_rank_order``
   — also the LCP engine's input): for every rank r, the
   first 18 bytes of its suffix packed as six int32 words of three 9-bit
   symbols (symbol = byte+1, 0 = past the end); batches with longer
   patterns widen to 12 words (36 bytes) on demand.
2. **Merge-join bounds**: zero-padded query keys make the masked lower
   bound ``(pk & mask) < qk`` equal the unmasked ``pk < qk``, and the
   upper bound ``pk > qk_hi`` with masked symbols max-filled, so both
   bounds are a plain searchsorted, resolved for the whole batch by ONE
   sort of [fence keys ++ lower queries ++ upper queries] with tie codes.
   Past 4096 keys the fences are strided and one block count per query
   finishes the job.
3. **Refine** (only for queries longer than the key depth): a lockstep
   binary search by byte comparison inside the key-equal range, a host
   loop with one readback per round over the long queries only. The deep
   index first probes its ext words (``_deep_probe``), then byte-refines
   only patterns past their 42-byte coverage, from that offset on.

Where JAX sorts a lane selector into static buckets, the port compacts
the long lanes with ``nonzero`` (exact counts).

The probe-chain engine (``bounds_batch_fast``, with the 2-symbol LUT of
``probe_lut``) is kept, as in JAX, for cross-checking: a LUT jump, then a
fused lower/upper binary search over the first two key words, and the
byte refine past 6 bytes. No user path calls it.
"""

from __future__ import annotations

import warnings

import torch

from suffix_torch.ops.search import _cmp_suffix_query, _table_at
from suffix_torch.ops.sort import lexsort_perm

SYM_BITS = 9
SYMS_PER_WORD = 3
KEY_WORDS = 6
KEY_SYMS = KEY_WORDS * SYMS_PER_WORD  # 18
EXT_KEY_WORDS = 12  # on-demand wide keys: exact merge join to 36 bytes
LUT_SIDE = 257  # symbol alphabet: 0 (end) + 256 byte values
WORD_MASK = (1 << (SYM_BITS * SYMS_PER_WORD)) - 1  # 27 bits
PAD_KEY = 0x7FFFFFFF  # above every real key word
I32 = torch.int32


# Above this padded size the index is built one word at a time
# (``_build_query_index_lean``); the one-program build's peak was measured
# past a 16 GB chip's memory there. Copied from the JAX package.
LEAN_MIN_PAD = 1 << 28
# Deep keyless index: 8 fence words, 6 ext block words (coverage 42 B),
# up to this padded size. Copied from the JAX package.
DEEP_FENCE_WORDS = 8
DEEP_EXT_WORDS = 6
DEEP_EXT_MAX_PAD = 1 << 27


def _pack3(s0, s1, s2):
    return (s0 << 18) | (s1 << 9) | s2


def _fence_stride(n_pad: int) -> int:
    """Fence stride ladder, copied from the JAX package so that both take
    the same route: pure merge (stride 1) only for tiny indexes, blocked
    fences otherwise. The ladder was tuned on another device; the port's
    own tuning is later work."""
    if n_pad <= (1 << 12):
        return 1
    if n_pad <= (1 << 22):
        return 16
    if n_pad <= (1 << 24):
        return 64
    return 128


def build_query_index(text: torch.Tensor, table: torch.Tensor, n_table: int,
                      key_words: int = KEY_WORDS, stride: int | None = None,
                      with_keys: bool = True):
    """(pk, pk_fence, pk_block): flat rank-order key words (``None`` when
    ``with_keys`` is False), fence words (every ``stride``-th key) and the
    blocked layout (``None`` at stride 1), whose row b holds word w of
    ranks [b*stride, (b+1)*stride) at columns [w*stride, (w+1)*stride).

    ``text`` is the PAD-padded int32 text, ``table`` the padded int32
    suffix table (entries past ``n_table`` are ignored). A keyless build
    at n_pad >= LEAN_MIN_PAD with stride > 1 takes the one-word-at-a-time
    ``_build_query_index_lean``; any other build that large warns."""
    n_pad = text.shape[0]
    if stride is None:
        stride = _fence_stride(n_pad)
    if not with_keys and stride > 1 and n_pad >= LEAN_MIN_PAD:
        return _build_query_index_lean(text, table, n_table, key_words,
                                       stride)
    if n_pad >= LEAN_MIN_PAD:
        warnings.warn(
            f"one-program query-index build at n_pad={n_pad} "
            f"(>= LEAN_MIN_PAD={LEAN_MIN_PAD}) may exceed the device "
            "memory; pass with_keys=False (and stride>1) for the memory-lean "
            "stepped build", RuntimeWarning, stacklevel=2)
    isa = _isa_padded(table, n_table)
    pk, fences = [], []
    block = _new_block(n_pad, key_words, stride, text.device)
    for w in range(key_words):
        (word,) = _words_rank_order(text, isa, n_table, w, w + 1, key_words)
        if with_keys:
            pk.append(word)
        fences.append(word[::stride].contiguous() if stride > 1 else word)
        if block is not None:
            _blk_write(block, word, w, stride)
    return (tuple(pk) if with_keys else None), tuple(fences), block


def _new_block(n_pad: int, words: int, stride: int, device):
    """A zeroed (n_pad / stride, words * stride) block, None at stride 1."""
    if stride == 1:
        return None
    return torch.zeros((n_pad // stride, words * stride), dtype=I32,
                       device=device)


def _blk_write(block: torch.Tensor, word: torch.Tensor, w: int,
               stride: int) -> None:
    """Write ``word`` into column group ``w`` of ``block``, in place."""
    block.view(block.shape[0], -1, stride)[:, w] = word.view(-1, stride)


def _packed_word(text: torch.Tensor, table: torch.Tensor, n_table: int,
                 w: int, key_words: int) -> torch.Tensor:
    """Key word ``w`` alone, in rank order, by a gather through the table
    (one step of the lean build); rows past ``n_table`` hold PAD_KEY."""
    n_pad = text.shape[0]
    word = _text_word(text, w, key_words)[table.long()]
    real = torch.arange(n_pad, device=text.device) < n_table
    return torch.where(real, word, PAD_KEY)


def _build_query_index_lean(text: torch.Tensor, table: torch.Tensor,
                            n_table: int, key_words: int, stride: int):
    """The keyless index as ``key_words`` steps: the block, one word in
    flight and its temporaries are the peak (no inverse SA, no word
    list). Returns (None, pk_fence, pk_block), as build_query_index."""
    n_pad = text.shape[0]
    block = _new_block(n_pad, key_words, stride, text.device)
    fences = []
    for w in range(key_words):
        word = _packed_word(text, table, n_table, w, key_words)
        fences.append(word[::stride].contiguous())
        _blk_write(block, word, w, stride)
        del word
    return None, tuple(fences), block


def _batch_query_keys(queries: torch.Tensor, qlens: torch.Tensor,
                      key_words: int = KEY_WORDS):
    """(qk, qk_hi): lists of ``key_words`` packed words per query. qk
    zero-fills symbols past qlen (lower-bound form); qk_hi max-fills them
    (upper-bound form)."""
    n_q, m = queries.shape
    key_syms = 3 * key_words
    cols = torch.arange(m, dtype=I32, device=queries.device)
    syms = torch.where(cols[None, :] < qlens[:, None], queries + 1, 0)
    syms = syms.to(I32)
    pad = syms.new_zeros((n_q, key_syms))
    full = torch.cat([syms, pad], dim=1)[:, :key_syms]
    one = torch.ones_like(qlens)
    qk, qk_hi = [], []
    for w in range(key_words):
        word = _pack3(full[:, 3 * w], full[:, 3 * w + 1], full[:, 3 * w + 2])
        k = torch.clamp(qlens - 3 * w, 0, 3)
        mask = WORD_MASK & ~((one << (SYM_BITS * (3 - k))) - 1)
        qk.append(word)
        qk_hi.append(word | (WORD_MASK & ~mask))
    return qk, qk_hi


def _fence_ranks_both(fk: list, qk: list, qk_hi: list):
    """Both searchsorted ranks for the whole batch from one sort.

    Rows are [fences ++ lower queries ++ upper queries]; the last key
    packs the tie code and the query id into one int32: tie in bits 28-29
    (lower 0 < fence 1 < upper 2, i.e. side='left' then side='right'),
    qid in the low 27 bits, so a batch holds at most 2^27 queries. Each
    query row's count of fences before it is its rank. Only query rows
    are written back (no duplicate-index scatter)."""
    n_f = fk[0].shape[0]
    n_q = qk[0].shape[0]
    dev = fk[0].device
    ks = [torch.cat([f, lo, hi]) for f, lo, hi in zip(fk, qk, qk_hi)]
    qids = torch.arange(n_q, dtype=I32, device=dev)
    code = torch.cat([torch.full((n_f,), 1 << 28, dtype=I32, device=dev),
                      qids, (2 << 28) + qids])
    scode = code[lexsort_perm(ks + [code])]
    tie = scode >> 28
    is_fence = (tie == 1).to(I32)
    fences_before = torch.cumsum(is_fence, 0, dtype=I32) - is_fence
    is_query = tie != 1
    qid = (scode & ((1 << 27) - 1)) + torch.where(tie == 2, n_q, 0)
    out = torch.zeros(2 * n_q, dtype=I32, device=dev)
    out[qid[is_query].long()] = fences_before[is_query]
    return out[:n_q], out[n_q:]


def _block_count(pk_block: torch.Tensor, blocks: torch.Tensor, qk: list,
                 less_equal: bool) -> torch.Tensor:
    """Count of keys in block ``blocks[q]`` below (or, with
    ``less_equal``, not above) query q's key: one row gather per query,
    then vector compares on column slices."""
    stride = pk_block.shape[1] // len(qk)
    rows = pk_block[blocks.long()]  # (Q, W*S)
    lt = torch.zeros((blocks.shape[0], stride), dtype=torch.bool,
                     device=pk_block.device)
    eq = torch.ones_like(lt)
    for w, q in enumerate(qk):
        vals = rows[:, w * stride:(w + 1) * stride]
        qc = q[:, None]
        lt = lt | (eq & (vals < qc))
        eq = eq & (vals == qc)
    if less_equal:
        lt = lt | eq
    return lt.sum(dim=1, dtype=I32)


def _refine(text: torch.Tensor, n_text: int, table: torch.Tensor,
            queries: torch.Tensor, qlens: torch.Tensor,
            start: torch.Tensor, end: torch.Tensor, sufi_off: int = 0):
    """Byte-level lower/upper bounds inside [start, end) for every row, in
    lockstep: one host readback per round; rows leave when both of their
    searches have converged.

    ``sufi_off`` shifts the suffix side: when the range is already exact
    through ``sufi_off`` bytes (the deep index), pass the query tails
    (queries[:, sufi_off:], qlens - sufi_off) and each probe compares
    suffix(sufi + sufi_off) with the tail."""

    def sufi_at(mid):
        return _table_at(table, mid) + sufi_off

    ll, lr = start.clone(), end.clone()
    ul, ur = start.clone(), end.clone()
    while bool(((ll < lr) | (ul < ur)).any()):
        l_act, u_act = ll < lr, ul < ur
        lmid = (ll + lr) // 2
        umid = (ul + ur) // 2
        lt, _ = _cmp_suffix_query(text, n_text, sufi_at(lmid), queries, qlens)
        _, gt = _cmp_suffix_query(text, n_text, sufi_at(umid), queries, qlens)
        # lower: first suffix >= query; upper: first suffix > query[:qlen]
        ll = torch.where(l_act & lt, lmid + 1, ll)
        lr = torch.where(l_act & ~lt, lmid, lr)
        ul = torch.where(u_act & ~gt, umid + 1, ul)
        ur = torch.where(u_act & gt, umid, ur)
    return ll, ul


def _merge_bounds(pk_fence, pk_block, queries: torch.Tensor,
                  qlens: torch.Tensor, n_table: int):
    """(start, end) exact through 3*len(pk_fence) bytes: the fence merge
    join, then a block count where the fences are strided."""
    key_words = len(pk_fence)
    qk, qk_hi = _batch_query_keys(queries, qlens, key_words)
    r_lo, r_up = _fence_ranks_both(list(pk_fence), qk, qk_hi)
    if pk_block is None:
        start = r_lo  # first rank with pk >= qk
        end = r_up    # first rank with pk > qk_hi
    else:
        stride = pk_block.shape[1] // key_words
        b_lo = torch.clamp(r_lo - 1, min=0)
        start = b_lo * stride + _block_count(pk_block, b_lo, qk,
                                             less_equal=False)
        b_up = torch.clamp(r_up - 1, min=0)
        end = b_up * stride + _block_count(pk_block, b_up, qk_hi,
                                           less_equal=True)
    return torch.clamp(start, max=n_table), torch.clamp(end, max=n_table)


def _start_count(start, end, qlens, n_table: int):
    """(start, count); an empty query or table matches nothing."""
    empty = (qlens == 0) | (n_table == 0)
    start = torch.where(empty, 0, start)
    count = torch.where(empty, 0, torch.clamp(end - start, min=0))
    return start, count


def bounds_batch_merge(text: torch.Tensor, n_text: int, table: torch.Tensor,
                       n_table: int, pk_fence, pk_block, queries: torch.Tensor,
                       qlens: torch.Tensor, max_qlen: int):
    """(start, count) per query, int32, via the merge-join engine.

    Exact for qlen <= 3*len(pk_fence); longer queries go through the
    byte refine on their key-equal range."""
    key_syms = 3 * len(pk_fence)
    start, end = _merge_bounds(pk_fence, pk_block, queries, qlens, n_table)
    if max_qlen > key_syms:
        long_q = torch.nonzero(qlens > key_syms).flatten()
        if long_q.numel():
            r_start, r_end = _refine(text, n_text, table, queries[long_q],
                                     qlens[long_q], start[long_q],
                                     end[long_q])
            start = start.index_put((long_q,), r_start)
            end = end.index_put((long_q,), r_end)
    return _start_count(start, end, qlens, n_table)


def _isa_padded(table: torch.Tensor, n_table: int) -> torch.Tensor:
    """Inverse SA (rank per position) of a padded table, int32: entries
    past ``n_table`` keep their own index, as the JAX package's one-sort
    form leaves them. A scatter here: the table is a permutation."""
    n_pad = table.shape[0]
    isa = torch.arange(n_pad, dtype=I32, device=table.device)
    isa[table[:n_table].long()] = isa[:n_table].clone()
    return isa


def _text_word(text: torch.Tensor, w: int, key_words: int) -> torch.Tensor:
    """Key word ``w`` of every position (home order): the symbols (byte +
    1; PAD and past the end are 0) at p + 3w .. p + 3w + 2."""
    n_pad = text.shape[0]
    sym = (text + 1).to(I32)
    sym_ext = torch.cat([sym, sym.new_zeros((3 * key_words,))])
    return _pack3(*(sym_ext[k:k + n_pad] for k in range(3 * w, 3 * w + 3)))


def _words_rank_order(text: torch.Tensor, isa: torch.Tensor, n_table: int,
                      w_lo: int, w_hi: int, key_words: int):
    """Key words [w_lo, w_hi) in rank order: each computed in position
    order and scattered through the inverse SA; rows past ``n_table``
    hold PAD_KEY."""
    n_pad = text.shape[0]
    dest = isa.long()
    real = torch.arange(n_pad, device=text.device) < n_table
    out = []
    for w in range(w_lo, w_hi):
        word = torch.empty((n_pad,), dtype=I32, device=text.device)
        word[dest] = _text_word(text, w, key_words)
        out.append(torch.where(real, word, PAD_KEY))
    return tuple(out)


def packed_keys_rank_order(text: torch.Tensor, table: torch.Tensor,
                           n_table: int, key_words: int = KEY_WORDS):
    """Flat rank-order packed keys: word w of rank r packs the symbols at
    table[r] + 3w .. +3w+2. The query index's keys and the LCP engine's
    input."""
    return _words_rank_order(text, _isa_padded(table, n_table), n_table, 0,
                             key_words, key_words)


def build_query_index_keyless(text: torch.Tensor, table: torch.Tensor,
                              n_table: int, key_words: int = KEY_WORDS,
                              stride: int | None = None, ext_words: int = 0):
    """(fences, block, ext_block): the keyless index of huge corpora.

    ``ext_words`` > 0 also builds a second block of words key_words ..
    key_words + ext_words - 1 in the same layout (the deep tier of
    ``bounds_batch_merge_deep``); fences stay ``key_words`` wide. Two
    passes over the same inverse SA, so at most ``key_words`` word arrays
    are alive beside the blocks."""
    n_pad = text.shape[0]
    if stride is None:
        stride = _fence_stride(n_pad)
    if stride == 1 and ext_words:
        raise ValueError("the ext tier needs a blocked layout (stride > 1)")
    total = key_words + ext_words
    isa = _isa_padded(table, n_table)
    words = _words_rank_order(text, isa, n_table, 0, key_words, total)
    if stride == 1:
        return words, None, None
    fences = tuple(w[::stride].contiguous() for w in words)
    block = _new_block(n_pad, key_words, stride, text.device)
    for w, wv in enumerate(words):
        _blk_write(block, wv, w, stride)
    del words
    ext_block = None
    if ext_words:
        ext = _words_rank_order(text, isa, n_table, key_words, total, total)
        ext_block = _new_block(n_pad, ext_words, stride, text.device)
        for w, wv in enumerate(ext):
            _blk_write(ext_block, wv, w, stride)
        del ext
    return fences, block, ext_block


def _ext_word_at(ext_block: torch.Tensor, stride: int, ranks: torch.Tensor,
                 w: int) -> torch.Tensor:
    """Ext word ``w`` at each rank: rank r lives at row r // stride, column
    w * stride + r % stride of the block."""
    flat = ext_block.view(-1)
    r = ranks.long()
    idx = (r // stride) * ext_block.shape[1] + w * stride + r % stride
    return flat[torch.clamp(idx, 0, flat.shape[0] - 1)]


def _deep_probe(ext_block: torch.Tensor, stride: int, qke: list,
                qke_hi: list, start: torch.Tensor, end: torch.Tensor):
    """Narrow [start, end) (exact through the fence words) to exactness
    through the ext words: a fused lower/upper binary search, one host
    readback a step; each probe gathers len(qke) words a lane."""

    def cmp(mid, keys, less: bool):
        out = torch.zeros(mid.shape, dtype=torch.bool, device=mid.device)
        eq = torch.ones_like(out)
        for w, key in enumerate(keys):
            v = _ext_word_at(ext_block, stride, mid, w)
            out = out | (eq & ((v < key) if less else (v > key)))
            eq = eq & (v == key)
        return out

    ll, lr = start.clone(), end.clone()
    ul, ur = start.clone(), end.clone()
    while bool(((ll < lr) | (ul < ur)).any()):
        l_act, u_act = ll < lr, ul < ur
        lmid = (ll + lr) // 2
        umid = (ul + ur) // 2
        lt = cmp(lmid, qke, True)       # key < qk: lower bound is right
        gt = cmp(umid, qke_hi, False)   # key > qk_hi: upper bound is left
        ll = torch.where(l_act & lt, lmid + 1, ll)
        lr = torch.where(l_act & ~lt, lmid, lr)
        ul = torch.where(u_act & ~gt, umid + 1, ul)
        ur = torch.where(u_act & gt, umid, ur)
    return ll, ul


def bounds_batch_merge_deep(text: torch.Tensor, n_text: int,
                            table: torch.Tensor, n_table: int, pk_fence,
                            pk_block: torch.Tensor, ext_block: torch.Tensor,
                            queries: torch.Tensor, qlens: torch.Tensor,
                            max_qlen: int):
    """(start, count) per query, int32, on the deep keyless index.

    The merge join is exact to 3*len(pk_fence) bytes; longer patterns
    (compacted) probe the ext words, exact to the coverage 3*(fence +
    ext words); patterns past the coverage (compacted again) byte-refine
    from that offset on."""
    key_words = len(pk_fence)
    key_syms = 3 * key_words
    stride = pk_block.shape[1] // key_words
    ext_words = ext_block.shape[1] // stride
    cov = 3 * (key_words + ext_words)
    start, end = _merge_bounds(pk_fence, pk_block, queries, qlens, n_table)
    if max_qlen > key_syms:
        lane = torch.nonzero(qlens > key_syms).flatten()
        if lane.numel():
            q_sel, ql_sel = queries[lane], qlens[lane]
            qke, qke_hi = _batch_query_keys(q_sel, ql_sel,
                                            key_words + ext_words)
            s2, e2 = _deep_probe(ext_block, stride, qke[key_words:],
                                 qke_hi[key_words:], start[lane], end[lane])
            if max_qlen > cov:
                lane2 = torch.nonzero(ql_sel > cov).flatten()
                if lane2.numel():
                    r_s, r_e = _refine(text, n_text, table,
                                       q_sel[lane2][:, cov:],
                                       ql_sel[lane2] - cov, s2[lane2],
                                       e2[lane2], sufi_off=cov)
                    s2 = s2.index_put((lane2,), r_s)
                    e2 = e2.index_put((lane2,), r_e)
            start = start.index_put((lane,), s2)
            end = end.index_put((lane,), e2)
    return _start_count(start, end, qlens, n_table)


# ---------------------------------------------------------------------------
# Probe-chain engine (kept for cross-checks)
# ---------------------------------------------------------------------------

def probe_lut(pk0: torch.Tensor, n_table: int) -> torch.Tensor:
    """int32 ``(LUT_SIDE**2 + 1,)``: entry v is the first rank whose two
    leading symbols s0, s1 have ``s0 * LUT_SIDE + s1 >= v`` (rows past
    ``n_table`` count as LUT_SIDE**2). ``pk0`` is key word 0 in rank
    order: the JAX index build's fourth value."""
    n_pad = pk0.shape[0]
    s0 = pk0 >> (2 * SYM_BITS)
    s1 = (pk0 >> SYM_BITS) & (2**SYM_BITS - 1)
    real = torch.arange(n_pad, device=pk0.device) < n_table
    v = torch.where(real, s0 * LUT_SIDE + s1, LUT_SIDE * LUT_SIDE).to(I32)
    targets = torch.arange(LUT_SIDE * LUT_SIDE + 1, dtype=I32,
                           device=pk0.device)
    return torch.searchsorted(v, targets, side="left").to(I32)


def _probe_bounds(pk1, pk2, lut, n_table: int, queries, qlens,
                  n_iters: int):
    """Fused (lower, upper) probe search over the first two key words
    from the LUT's bucket, every row in lockstep. Exact for qlen <= 6;
    longer queries get their 6-symbol prefix-equal range."""
    (qk1, qk2), hi = _batch_query_keys(queries, qlens, 2)
    # A word's live-symbol mask: the bits that max-filling left alone.
    m1, m2 = (WORD_MASK ^ (h ^ q) for q, h in zip((qk1, qk2), hi))
    s0 = (qk1 >> 18) & 0x1FF
    s1 = (qk1 >> 9) & 0x1FF
    two = qlens >= 2
    v_lo = torch.where(two, s0 * LUT_SIDE + s1, s0 * LUT_SIDE)
    v_hi = torch.where(two, v_lo + 1, (s0 + 1) * LUT_SIDE)
    lo0 = torch.clamp(lut[v_lo.long()], max=n_table)
    hi0 = torch.clamp(lut[v_hi.long()], max=n_table)
    ll, lr, ul, ur = lo0, hi0, lo0, hi0
    for _ in range(n_iters):
        lmid = (ll + lr) // 2
        umid = (ul + ur) // 2
        la1 = _table_at(pk1, lmid) & m1
        la2 = _table_at(pk2, lmid) & m2
        ua1 = _table_at(pk1, umid) & m1
        ua2 = _table_at(pk2, umid) & m2
        l_lt = (la1 < qk1) | ((la1 == qk1) & (la2 < qk2))
        u_gt = (ua1 > qk1) | ((ua1 == qk1) & (ua2 > qk2))
        l_act = ll < lr
        u_act = ul < ur
        ll = torch.where(l_act & l_lt, lmid + 1, ll)
        lr = torch.where(l_act & ~l_lt, lmid, lr)
        ul = torch.where(u_act & ~u_gt, umid + 1, ul)
        ur = torch.where(u_act & u_gt, umid, ur)
    return ll, ul


def bounds_batch_fast(text: torch.Tensor, n_text: int, table: torch.Tensor,
                      n_table: int, pk1: torch.Tensor, pk2: torch.Tensor,
                      lut: torch.Tensor, queries: torch.Tensor,
                      qlens: torch.Tensor, n_iters: int, max_qlen: int):
    """(start, count) per query, int32, via the LUT and probe chains over
    the packed keys; queries longer than 6 bytes (compacted) finish
    through the byte refine on their 6-symbol range."""
    start, end = _probe_bounds(pk1, pk2, lut, n_table, queries, qlens,
                               n_iters)
    if max_qlen > 6:
        long_q = torch.nonzero(qlens > 6).flatten()
        if long_q.numel():
            r_start, r_end = _refine(text, n_text, table, queries[long_q],
                                     qlens[long_q], start[long_q],
                                     end[long_q])
            start = start.index_put((long_q,), r_start)
            end = end.index_put((long_q,), r_end)
    return _start_count(start, end, qlens, n_table)
