"""Batched query engine: packed prefix keys + merge-join bounds.

Port of the flat-key route of ``suffix_tpu/ops/search2.py``:

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
   loop with one readback per round over the long queries only.

Not ported yet: the probe engine (``bounds_batch_fast``) and its LUT,
the keyless/deep routes and the memory-lean build.
"""

from __future__ import annotations

import torch

from suffix_torch.ops.search import _cmp_suffix_query
from suffix_torch.ops.sort import lexsort_perm

SYM_BITS = 9
SYMS_PER_WORD = 3
KEY_WORDS = 6
KEY_SYMS = KEY_WORDS * SYMS_PER_WORD  # 18
EXT_KEY_WORDS = 12  # on-demand wide keys: exact merge join to 36 bytes
WORD_MASK = (1 << (SYM_BITS * SYMS_PER_WORD)) - 1  # 27 bits
PAD_KEY = 0x7FFFFFFF  # above every real key word
I32 = torch.int32


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
                      key_words: int = KEY_WORDS, stride: int | None = None):
    """(pk, pk_fence, pk_block): flat rank-order key words
    (``packed_keys_rank_order``), fence words (every ``stride``-th key)
    and the blocked layout (``None`` at stride 1), whose row b holds word
    w of ranks [b*stride, (b+1)*stride) at columns [w*stride, (w+1)*stride).

    ``text`` is the PAD-padded int32 text, ``table`` the padded int32
    suffix table (entries past ``n_table`` are ignored)."""
    n_pad = text.shape[0]
    pk = packed_keys_rank_order(text, table, n_table, key_words)
    if stride is None:
        stride = _fence_stride(n_pad)
    if stride == 1:
        return pk, pk, None
    pk_fence = tuple(word[::stride].contiguous() for word in pk)
    pk_block = torch.stack([word.view(-1, stride) for word in pk], dim=1)
    return pk, pk_fence, pk_block.reshape(n_pad // stride, key_words * stride)


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
            start: torch.Tensor, end: torch.Tensor):
    """Byte-level lower/upper bounds inside [start, end) for every row, in
    lockstep: one host readback per round; rows leave when both of their
    searches have converged."""
    n_tab = table.shape[0]

    def sufi_at(mid):
        got = table[torch.clamp(mid, 0, n_tab - 1).long()]
        return torch.where(mid < n_tab, got, 0).to(I32)

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


def bounds_batch_merge(text: torch.Tensor, n_text: int, table: torch.Tensor,
                       n_table: int, pk_fence, pk_block, queries: torch.Tensor,
                       qlens: torch.Tensor, max_qlen: int):
    """(start, count) per query, int32, via the merge-join engine.

    Exact for qlen <= 3*len(pk_fence); longer queries go through the
    byte refine on their key-equal range."""
    key_words = len(pk_fence)
    key_syms = 3 * key_words
    qk, qk_hi = _batch_query_keys(queries, qlens, key_words)
    stride = 1 if pk_block is None else pk_block.shape[1] // key_words

    r_lo, r_up = _fence_ranks_both(list(pk_fence), qk, qk_hi)
    if stride == 1:
        start = r_lo  # first rank with pk >= qk
        end = r_up    # first rank with pk > qk_hi
    else:
        b_lo = torch.clamp(r_lo - 1, min=0)
        start = b_lo * stride + _block_count(pk_block, b_lo, qk,
                                             less_equal=False)
        b_up = torch.clamp(r_up - 1, min=0)
        end = b_up * stride + _block_count(pk_block, b_up, qk_hi,
                                           less_equal=True)
    start = torch.clamp(start, max=n_table)
    end = torch.clamp(end, max=n_table)

    if max_qlen > key_syms:
        long_q = torch.nonzero(qlens > key_syms).flatten()
        if long_q.numel():
            r_start, r_end = _refine(text, n_text, table, queries[long_q],
                                     qlens[long_q], start[long_q],
                                     end[long_q])
            start = start.index_put((long_q,), r_start)
            end = end.index_put((long_q,), r_end)

    empty = (qlens == 0) | (n_table == 0)
    start = torch.where(empty, 0, start)
    count = torch.where(empty, 0, torch.clamp(end - start, min=0))
    return start, count


def _isa_padded(table: torch.Tensor, n_table: int) -> torch.Tensor:
    """Inverse SA (rank per position) of a padded table, int32: entries
    past ``n_table`` keep their own index, as the JAX package's one-sort
    form leaves them. A scatter here: the table is a permutation."""
    n_pad = table.shape[0]
    isa = torch.arange(n_pad, dtype=I32, device=table.device)
    isa[table[:n_table].long()] = isa[:n_table].clone()
    return isa


def packed_keys_rank_order(text: torch.Tensor, table: torch.Tensor,
                           n_table: int, key_words: int = KEY_WORDS):
    """Flat rank-order packed keys: word w of rank r packs the symbols
    (byte + 1; PAD and past the end are 0) at table[r] + 3w .. +3w+2.
    The words are computed in position order and scattered to rank order
    through the inverse SA; rows past ``n_table`` hold PAD_KEY. The query
    index's keys and the LCP engine's input."""
    n_pad = text.shape[0]
    isa = _isa_padded(table, n_table).long()
    sym = (text + 1).to(I32)
    sym_ext = torch.cat([sym, sym.new_zeros((3 * key_words,))])
    real = torch.arange(n_pad, device=text.device) < n_table
    out = []
    for w in range(key_words):
        s = [sym_ext[k:k + n_pad] for k in range(3 * w, 3 * w + 3)]
        word = torch.empty_like(sym)
        word[isa] = _pack3(s[0], s[1], s[2])
        out.append(torch.where(real, word, PAD_KEY))
    return tuple(out)
