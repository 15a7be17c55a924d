"""Sharded query serving: the index spread over the ranks of a mesh.

Port of ``suffix_tpu/parallel/dist_query.py``. The reference serves
queries from one in-process table (src/table.rs:197-293); this layer
serves the same contract from a suffix array sharded over a
:class:`~suffix_torch.parallel.mesh.Mesh`:

- the suffix table and its packed 18-symbol rank keys (``ops/search2.py``)
  are cut into contiguous *rank blocks*, one a rank;
- the text is cut into contiguous *position blocks*, so every array a rank
  holds scales as 1/D (about 32/D bytes a character: text 4, table 4,
  keys 24);
- a query batch is replicated; every rank runs the merge-join fence
  engine over its own key block and counts its keys below each query's
  lower and upper bound. Rank blocks are contiguous and ordered, so the
  global bounds are the sum of the local counts: one all-reduce;
- queries longer than the 18 packed symbols refine by the lockstep binary
  search of the single-card engine, each probe resolving ``table[mid]``
  and the suffix windows by "the owner contributes, the others give 0,
  one all-reduce".

**Every rank of the mesh** constructs the index and calls each method
with the same arguments, in the same order, and gets the same result:
the methods run collectives. Results are bit-identical to ``SuffixTable``
(the same unordered-slice, empty-query and byte-offset semantics).

What changes from JAX to PyTorch:

- JAX runs one ``shard_map`` program over the mesh; here each rank is a
  process and every ``psum`` is a ``dist.all_reduce(SUM)`` on int32 over
  ``mesh.group`` (NCCL takes no bool: a flag is an int32 reduction).
- A ``ppermute`` is one ``batch_isend_irecv`` (``dist_build._exchange``);
  the ring collect passes each block left ``n_dev - 1`` times.
- Each ``lax.while_loop`` is a host loop whose exit every rank computes
  alike: the refine's state is replicated after each all-reduce, and the
  LCP survivor loop reads one all-reduced count a round.
- The refine runs only the rows longer than 18 bytes (compacted, as
  ``ops/search2.py::bounds_batch_merge`` does), not all Q rows.
- The sharded LCP gathers text windows for the rows still active only, in
  chunks of bounded size, with a window that doubles each round (see
  ``_survivor_lcps``); JAX gathers byte windows for every row each round.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from suffix_torch.ops import search2 as s2
from suffix_torch.ops.padding import PAD, bucket_size
from suffix_torch.ops.search import _cmp_window
from suffix_torch.parallel import dist_build
from suffix_torch.parallel.mesh import Mesh

I32 = torch.int32
I64 = torch.int64

# The sharded LCP's survivor loop (``_survivor_lcps``): the first round
# compares windows of LCP_WINDOW0 packed 8-byte words, each later round
# twice as many, at most LCP_WINDOW_MAX; one fetch gathers at most
# LCP_FETCH_WORDS words. The port's choice, not the JAX package's
# (``block=128`` bytes a round): the output does not depend on them.
LCP_WINDOW0 = 8              # 64 bytes
LCP_WINDOW_MAX = 1 << 13     # 64 KiB
LCP_FETCH_WORDS = 1 << 25    # 256 MiB of int64 words a fetch


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _all_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the mesh, in place (int32)."""
    if mesh.world_size > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def _all_max(value: int, mesh: Mesh) -> int:
    """The largest of every rank's ``value``."""
    if mesh.world_size == 1:
        return value
    t = torch.tensor([value], dtype=I32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t)


def _gather_sharded(x_local: torch.Tensor, gpos: torch.Tensor,
                    n_local: int, mesh: Mesh) -> torch.Tensor:
    """x[gpos] over a block-sharded array for REPLICATED global positions
    (the same ``gpos`` on every rank, any shape): the owner contributes
    the value, the others 0, one all-reduce sums them. JAX's
    ``_gather_sharded``, ``_probe_table`` and ``_take_ranks_shard``. Not
    valid for positions that differ per rank: use
    ``_collect_by_position``."""
    base = mesh.rank * n_local
    local = (gpos >= base) & (gpos < base + n_local)
    li = torch.clamp(gpos - base, 0, n_local - 1).long()
    return _all_sum(torch.where(local, x_local[li], 0).to(I32), mesh)


def _ring(blk: torch.Tensor, mesh: Mesh):
    """Yield (source rank, block) for every block of the mesh, starting
    with this rank's own: each step passes the held block left (rank j
    sends to j - 1) in one exchange, so after k steps rank ``me`` holds
    block ``(me + k) % n_dev``. O(n_local) transient: the array is never
    replicated."""
    n_dev, me = mesh.world_size, mesh.rank
    for k in range(n_dev):
        yield (me + k) % n_dev, blk
        if k < n_dev - 1:
            nxt = torch.empty_like(blk)
            dist_build._exchange([((me - 1) % n_dev, blk)],
                                 [((me + 1) % n_dev, nxt)], mesh)
            blk = nxt


def _collect_by_position(x_home: torch.Tensor, gpos: torch.Tensor,
                         n_local: int, mesh: Mesh) -> torch.Tensor:
    """x[gpos] over a block-sharded array where every rank asks for its
    OWN positions (``gpos`` in [0, n_pad), differing per rank): a ring of
    ``n_dev`` steps, each picking the elements the held block owns. Each
    position has one owner, so the result is the plain gather. At one rank
    it is a plain gather."""
    owner = gpos // n_local
    li = (gpos - owner * n_local).long()
    if mesh.world_size == 1:
        return x_home[li]
    out = torch.zeros(gpos.shape, dtype=x_home.dtype, device=x_home.device)
    for src, blk in _ring(x_home, mesh):
        out = torch.where(owner == src, blk[li], out)
    return out


def _fetch_text(text_local: torch.Tensor, pos: torch.Tensor, n_text: int,
                n_local: int, mesh: Mesh) -> torch.Tensor:
    """text[pos] for replicated positions; PAD (-1) outside [0, n_text),
    the sentinel semantics of the single-card engine."""
    n_pad = n_local * mesh.world_size
    v = _gather_sharded(text_local, torch.clamp(pos, 0, n_pad - 1),
                        n_local, mesh)
    return torch.where((pos >= 0) & (pos < n_text), v, PAD)


def _right_halo(x: torch.Tensor, halo: int, n_local: int,
                mesh: Mesh) -> torch.Tensor:
    """The ``halo`` values past this rank's block (0 past the global
    padded end). They may span several ranks when the block is short, so
    the ring resolves them."""
    if mesh.world_size == 1:
        return x.new_zeros((halo,))
    gpos = ((mesh.rank + 1) * n_local
            + torch.arange(halo, dtype=I64, device=x.device))
    valid = gpos < n_local * mesh.world_size
    v = _collect_by_position(x, torch.where(valid, gpos, 0), n_local, mesh)
    return torch.where(valid, v, 0)


# ---------------------------------------------------------------------------
# Keys, bounds and the refine
# ---------------------------------------------------------------------------

def _grank(n_local: int, mesh: Mesh) -> torch.Tensor:
    """Global ranks (or positions) of this rank's block, int64."""
    return (mesh.rank * n_local
            + torch.arange(n_local, dtype=I64, device=mesh.device))


def _build_keys(text_local: torch.Tensor, table_local: torch.Tensor,
                n_table: int, n_local: int, mesh: Mesh):
    """(fences, block): this rank block's packed keys in the layout of
    ``ops/search2.build_query_index`` at the shard-local
    ``_fence_stride(n_local)`` (block ``None`` at stride 1, where the
    fences are the words).

    Words of three 9-bit symbols pack in home layout (a right halo of
    KEY_SYMS - 1 symbols), then route to the rank block by the ring at
    ``table_local``; ranks at or past ``n_table`` get PAD_KEY. Each word
    goes into the block as it is made, so one word is alive at a time."""
    sym = (text_local + 1).to(I32)  # PAD -> 0, the past-end sentinel
    ext = torch.cat([sym, _right_halo(sym, s2.KEY_SYMS - 1, n_local, mesh)])
    del sym
    real = _grank(n_local, mesh) < n_table
    stride = s2._fence_stride(n_local)
    block = s2._new_block(n_local, s2.KEY_WORDS, stride, text_local.device)
    fences = []
    for w in range(s2.KEY_WORDS):
        home = s2._pack3(*(ext[k:k + n_local]
                           for k in range(3 * w, 3 * w + 3)))
        word = torch.where(
            real, _collect_by_position(home, table_local, n_local, mesh),
            s2.PAD_KEY)
        del home
        if block is None:
            fences.append(word)
            continue
        fences.append(word[::stride].contiguous())
        s2._blk_write(block, word, w, stride)
        del word
    return tuple(fences), block


def _key_word(fences, block, w: int) -> torch.Tensor:
    """Rank-order key word ``w``: the fence word at stride 1, else read
    back from the blocked layout (the stride from the block's shape,
    never from a constant)."""
    if block is None:
        return fences[w]
    stride = block.shape[1] // len(fences)
    return block.view(block.shape[0], len(fences), stride)[:, w].reshape(-1)


def _refine_dist(text_local: torch.Tensor, n_text: int,
                 table_local: torch.Tensor, queries: torch.Tensor,
                 qlens: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                 n_local: int, mesh: Mesh):
    """Byte-level (lower, upper) bounds inside [start, end) over the
    sharded table and text: the lockstep binary search of
    ``ops/search2.py::_refine``. Each step resolves ``table[mid]`` of both
    searches by one all-reduce and their suffix windows by another; the
    state is then the same on every rank, so every rank reads the same
    exit test. Comparator: ``_cmp_suffix_query``'s (the first mismatch
    decides; PAD past the end sorts first)."""
    n_q, m = queries.shape
    cols = torch.arange(m, dtype=I32, device=queries.device)[None, :]
    q2, ql2 = torch.cat([queries, queries]), torch.cat([qlens, qlens])
    ll, lr = start.clone(), end.clone()
    ul, ur = start.clone(), end.clone()
    while bool(((ll < lr) | (ul < ur)).any()):
        l_act, u_act = ll < lr, ul < ur
        lmid = (ll + lr) // 2
        umid = (ul + ur) // 2
        sufi = _gather_sharded(table_local, torch.cat([lmid, umid]),
                               n_local, mesh)
        window = _fetch_text(text_local, sufi[:, None] + cols, n_text,
                             n_local, mesh)
        lt, gt = _cmp_window(window, q2, ql2)
        lt, gt = lt[:n_q], gt[n_q:]
        # lower: first suffix >= query; upper: first suffix > query[:qlen]
        ll = torch.where(l_act & lt, lmid + 1, ll)
        lr = torch.where(l_act & ~lt, lmid, lr)
        ul = torch.where(u_act & ~gt, umid + 1, ul)
        ur = torch.where(u_act & gt, umid, ur)
    return ll, ul


def _bounds(text_local, n_text: int, table_local, fences, block, queries,
            qlens, n_table: int, n_local: int, mesh: Mesh, max_qlen: int):
    """Global (start, count) per query, the same on every rank."""
    # Local counts of keys below each bound (the single-card merge join
    # on this rank's block; they never exceed n_local), summed over the
    # mesh by one all-reduce of both rows.
    lo, up = s2._merge_bounds(fences, block, queries, qlens, n_local)
    both = _all_sum(torch.stack([lo, up]), mesh)
    start = torch.clamp(both[0], max=n_table)
    end = torch.clamp(both[1], max=n_table)
    if max_qlen > s2.KEY_SYMS:
        long_q = torch.nonzero(qlens > s2.KEY_SYMS).flatten()
        if long_q.numel():
            r_start, r_end = _refine_dist(
                text_local, n_text, table_local, queries[long_q],
                qlens[long_q], start[long_q], end[long_q], n_local, mesh)
            start = start.index_put((long_q,), r_start)
            end = end.index_put((long_q,), r_end)
    return s2._start_count(start, end, qlens, n_table)


def _align(sa_block: torch.Tensor, n: int, n_local: int,
           mesh: Mesh) -> torch.Tensor:
    """The device-resident build's layout (padding suffixes in the first
    n_pad - n ranks) shifted left by n_pad - n, the tail zero-filled:
    out[r] = sa[r + n_pad - n] for r < n. The source positions differ per
    rank, so the ring resolves them; at one rank it is one shifted
    take."""
    n_pad = n_local * mesh.world_size
    grank = _grank(n_local, mesh)
    src = grank + (n_pad - n)
    v = _collect_by_position(sa_block, torch.where(src < n_pad, src, 0),
                             n_local, mesh)
    return torch.where(grank < n, v, 0).to(I32)


# ---------------------------------------------------------------------------
# LCP
# ---------------------------------------------------------------------------

def _position_words(text_local: torch.Tensor, n_local: int, mesh: Mesh,
                    tail: int) -> torch.Tensor:
    """Flat int64 words of this block: the 8 bytes at every position,
    big-endian (PAD as 0), laid out by phase: entry ``r * (L / 8) + i``
    holds position ``8 i + r``, so the words at p, p + 8, p + 16, ... lie
    side by side. A 7-byte right halo comes by the ring; ``tail`` zero
    words follow (room for a window read past the last phase)."""
    byte = torch.clamp(text_local, min=0).to(I64)
    ext = torch.cat([byte, _right_halo(byte, 7, n_local, mesh)])
    word = torch.zeros((n_local,), dtype=I64, device=text_local.device)
    for k in range(8):
        word |= ext[k:k + n_local] << (56 - 8 * k)
    out = word.new_zeros((n_local + tail,))
    out[:n_local] = word.view(n_local // 8, 8).t().reshape(-1)
    return out


def _fetch_words(words: torch.Tensor, bases: torch.Tensor, w: int,
                 n_local: int, mesh: Mesh) -> torch.Tensor:
    """(rows, w) int64: row i holds the words at bases[i] + 8 j, j < w
    (global positions; anything past the text may be read as any value).

    One rank: each row is one contiguous run of its phase (a strided
    view, no index tensor; ``bases`` lie below the text's end). More
    ranks: positions are resolved by the ring, each rank picking what the
    held block owns, so every rank makes the same ``n_dev - 1``
    exchanges whatever its number of rows."""
    span = n_local // 8
    if mesh.world_size == 1:
        start = (bases % 8) * span + bases // 8
        return words.as_strided((n_local, w), (1, 1))[start]
    pos = bases[:, None] + 8 * torch.arange(w, dtype=I64,
                                            device=bases.device)
    owner = pos // n_local
    loc = pos - owner * n_local
    flat = (loc % 8) * span + loc // 8
    del pos, loc
    out = torch.zeros(flat.shape, dtype=I64, device=bases.device)
    for src, blk in _ring(words, mesh):
        out = torch.where(owner == src, blk[flat], out)
    return out


def _lead_zero_bytes(x: torch.Tensor) -> torch.Tensor:
    """Index of the first nonzero byte of each nonzero big-endian word."""
    shifts = torch.arange(56, -1, -8, dtype=I64, device=x.device)
    return (((x[:, None] >> shifts) & 0xFF) != 0).to(torch.uint8).argmax(1)


def _survivor_lcps(text_local: torch.Tensor, n_text: int, a: torch.Tensor,
                   b: torch.Tensor, off0: int, n_local: int, mesh: Mesh,
                   trace: dict) -> torch.Tensor:
    """LCP of each survivor pair (a[i], b[i]) (int64 global positions, the
    pairs equal through their first ``off0`` bytes) by comparing packed
    8-byte words of the position-sharded text.

    Each rank keeps the rows still active and compares them from the
    round's common offset: a window of LCP_WINDOW0 words in the first
    round, doubled each round up to LCP_WINDOW_MAX. The LCP is the first
    mismatching byte, capped by the shorter suffix's length
    ``n_text - max(a, b)``, so bytes read past the text never matter.
    Doubling keeps the rounds at O(log max LCP) (24 at a 920,665-byte
    LCP) and the compared words within about twice the LCP sum; rows
    with short LCPs leave in the first, narrow round.

    Memory: rows are fetched in chunks of at most LCP_FETCH_WORDS words,
    so the transient memory is a few times ``8 * LCP_FETCH_WORDS`` bytes
    (the fetched words and their comparison, about 1.2 times; at more
    than one rank also the int64 position, owner and index arrays: at
    most about 6 times, 1.5 GiB) beside the flat words (8 bytes a text
    position), whatever the number of survivors. No window array over
    all rows is ever built. One all-reduce a round (the largest active
    count of any rank) decides the exit and the number of chunks, so
    every rank runs the same rounds and ring exchanges."""
    limit = n_text - torch.maximum(a, b)
    out = limit.clone()
    live = torch.nonzero(limit > off0).flatten()
    count = _all_max(live.numel(), mesh)
    trace.update(survivors=int(a.numel()), rounds=0)
    if not count:
        return out
    tail = LCP_WINDOW_MAX if mesh.world_size == 1 else 0
    words = _position_words(text_local, n_local, mesh, tail)
    off, w = off0, LCP_WINDOW0
    while count:
        per = max(1, LCP_FETCH_WORDS // (2 * w))
        keep = []
        for c0 in range(0, count, per):
            rows = live[c0:c0 + per]
            k = rows.numel()
            win = _fetch_words(words, torch.cat([a[rows], b[rows]]) + off,
                               w, n_local, mesh)
            ne = (win[:k] != win[k:]).view(torch.uint8)
            j = ne.argmax(1)[:, None]  # the first mismatch, 0 if none
            hit = ne.gather(1, j)[:, 0].bool()
            x = win[:k].gather(1, j)[:, 0] ^ win[k:].gather(1, j)[:, 0]
            del win, ne
            reach = torch.where(hit, off + 8 * j[:, 0] + _lead_zero_bytes(x),
                                off + 8 * w)
            lim = limit[rows]
            out[rows] = torch.minimum(reach, lim)
            keep.append(rows[~hit & (off + 8 * w < lim)])
        live = torch.cat(keep)
        off, w = off + 8 * w, min(2 * w, LCP_WINDOW_MAX)
        trace["rounds"] += 1
        count = _all_max(live.numel(), mesh)
    return out


def _lcp_shard(text_local: torch.Tensor, n_text: int,
               table_local: torch.Tensor, fences, block, n_table: int,
               n_local: int, mesh: Mesh, trace: dict) -> torch.Tensor:
    """This rank block's LCP slice, keyed like ``ops/lcp.py``.

    The first 18 bytes come from the packed key words, read back from the
    blocked layout one at a time: a pair's first differing symbol is the
    highest 9-bit field of the xor of its words. Adjacent ranks lie side
    by side, except each block's first, whose predecessor is the left
    neighbour's last rank: one point-to-point exchange carries the last
    entry of each word and of the table. Pairs equal through all 18
    symbols go to ``_survivor_lcps``."""
    grank = _grank(n_local, mesh)
    valid = (grank > 0) & (grank < n_table)
    del grank
    kw = len(fences)
    edge = dist_build._left_boundary(
        [_key_word(fences, block, w)[-1:] for w in range(kw)]
        + [table_local[-1:]], mesh, fill=s2.PAD_KEY)
    lcp = torch.zeros((n_local,), dtype=I32, device=table_local.device)
    undecided = valid.clone()
    for w in range(kw):
        word = _key_word(fences, block, w)
        x = torch.cat([edge[w], word[:-1]]).bitwise_xor_(word)
        del word
        # Symbols equal from the left: 0 to 3 (x < 2^18: the first,
        # x < 2^9: the first two, x == 0: all three).
        same = x == 0
        matched = ((x < 1 << 18).to(I32) + (x < 1 << 9).to(I32)
                   + same.to(I32))
        lcp += torch.where(undecided, matched, 0)
        undecided &= same
        del x, same, matched
    rows = torch.nonzero(undecided).flatten()
    del undecided
    prev = table_local[torch.clamp(rows - 1, min=0)]
    prev = torch.where(rows > 0, prev, edge[kw])
    deep = _survivor_lcps(text_local, n_text, prev.to(I64),
                          table_local[rows].to(I64), 3 * kw, n_local, mesh,
                          trace)
    lcp[rows] = deep.to(I32)
    return torch.where(valid, lcp, 0)


# ---------------------------------------------------------------------------
# The index
# ---------------------------------------------------------------------------

class ShardedQueryIndex:
    """Serve positions()/contains()/count()/any_position() mesh-sharded.

    Matches ``SuffixTable``'s query semantics bit for bit
    (src/table.rs:197-293): unordered SA-slice positions, byte offsets,
    the empty query matches nothing. Text, table and rank keys are all
    sharded: a rank holds about 32/D bytes a character
    (``_resident_bytes``).

    Each rank stages only its own blocks (``utils/io.py::device_corpus``,
    ``device_table``). ``sa=None`` builds device-resident
    (``dist_build.suffix_array_sharded_device``, then a realignment on the
    card): no host table exists unless ``host_sa``, and ``positions``
    takes its SA slice from the rank shards by a collective. A given
    ``sa`` keeps a host copy for slicing without collectives unless
    ``host_sa is False``. Every method is collective: every rank of the
    mesh calls it with the same arguments."""

    MAX_QUERY_BATCH = 1 << 18
    # Collective slices: ranks pad to power-of-two (rows, cap) buckets,
    # and a chunk ceiling bounds the replicated result of one all-reduce.
    MAX_SLICE_ELEMS = 1 << 22

    def __init__(self, data, mesh: Mesh, sa: np.ndarray | None = None,
                 host_sa: bool | None = None):
        from suffix_torch.utils.io import device_corpus, device_table

        arr = dist_build._as_u8(data)
        self.mesh = mesh
        self.n = int(arr.shape[0])
        self.n_dev = dist_build._check_pow2(mesh)
        self.n_local = max(dist_build._local_bucket(self.n, self.n_dev), 8)
        self.n_pad = self.n_local * self.n_dev
        self._lcp_trace: dict = {}
        self._text, _ = device_corpus(arr, mesh, n_pad=self.n_pad)
        if sa is None:
            sa_block, n_total, n_local_b, _ = \
                dist_build.suffix_array_sharded_device(arr, mesh)
            assert (n_total, n_local_b) == (self.n_pad, self.n_local)
            self._table = _align(sa_block.to(I32), self.n, self.n_local,
                                 mesh)
            del sa_block
            self._sa_host = None
            if host_sa:
                self._sa_host = self.table()
        else:
            self._sa_host = (np.asarray(sa, dtype=np.uint32)
                             if host_sa is not False else None)
            self._table = device_table(np.asarray(sa), self.n_pad, mesh)
        self._pk_fence, self._pk_block = _build_keys(
            self._text, self._table, self.n, self.n_local, mesh)

    def _resident_bytes(self) -> int:
        """Bytes this rank holds of text, table and keys (the blocked
        layout, or the fence words where the stride is 1)."""
        keys = ([self._pk_block] if self._pk_block is not None
                else list(self._pk_fence))
        return sum(t.numel() * t.element_size()
                   for t in [self._text, self._table, *keys])

    def bounds_batch(self, queries: np.ndarray, qlens: np.ndarray):
        """(start, count) int32 arrays for a (Q, m) int batch.

        Shapes bucket to powers of two (the JAX package's policy, so the
        same refine rows run); batches past MAX_QUERY_BATCH go in
        chunks."""
        queries = np.asarray(queries, np.int32)
        qlens = np.asarray(qlens, np.int32)
        nq = int(queries.shape[0])
        if nq > self.MAX_QUERY_BATCH:
            parts = [self.bounds_batch(queries[i:i + self.MAX_QUERY_BATCH],
                                       qlens[i:i + self.MAX_QUERY_BATCH])
                     for i in range(0, nq, self.MAX_QUERY_BATCH)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        m_pad = bucket_size(max(int(queries.shape[1]), 1), minimum=8)
        q_pad = bucket_size(max(nq, 1), minimum=8)
        full_q = np.zeros((q_pad, m_pad), np.int32)
        full_q[:nq, :queries.shape[1]] = queries
        full_lens = np.zeros((q_pad,), np.int32)
        full_lens[:nq] = qlens
        dev = self.mesh.device
        start, count = _bounds(
            self._text, self.n, self._table, self._pk_fence, self._pk_block,
            torch.from_numpy(full_q).to(dev),
            torch.from_numpy(full_lens).to(dev), self.n, self.n_local,
            self.mesh, m_pad)
        return start.cpu().numpy()[:nq], count.cpu().numpy()[:nq]

    def _encode(self, queries):
        qb = [np.frombuffer(q.encode() if isinstance(q, str) else bytes(q),
                            np.uint8) for q in queries]
        m = max(max((len(q) for q in qb), default=1), 1)
        out = np.zeros((len(qb), m), np.int32)
        for i, q in enumerate(qb):
            out[i, :len(q)] = q
        return out, np.array([len(q) for q in qb], np.int32)

    def table(self) -> np.ndarray:
        """Host copy of the suffix table (uint32), gathered from the rank
        blocks where no host copy is kept: O(n) on this host, for
        whole-index consumers (tree folds); serving never calls it."""
        if self._sa_host is not None:
            return self._sa_host
        return dist_build._gather_sa(self._table, self.mesh)[
            :self.n].astype(np.uint32)

    def _text_bytes(self) -> bytes:
        """The text, gathered from the rank blocks."""
        return dist_build._gather_sa(self._text, self.mesh)[
            :self.n].astype(np.uint8).tobytes()

    def lcp_lens(self) -> np.ndarray:
        """LCP array (uint32), computed across the mesh (definition of
        ``SuffixTable.lcp_lens``, src/table.rs:348-361). ``_lcp_trace``
        then holds this rank's survivor count and the rounds run."""
        self._lcp_trace = {}
        out = _lcp_shard(self._text, self.n, self._table, self._pk_fence,
                         self._pk_block, self.n, self.n_local, self.mesh,
                         self._lcp_trace)
        return dist_build._gather_sa(out, self.mesh)[
            :self.n].astype(np.uint32)

    def _gather_slices(self, start: np.ndarray,
                       count: np.ndarray) -> list[np.ndarray]:
        """SA slices [start, start + count) per query from the rank
        shards: (rows, cap) rank buckets of at most MAX_SLICE_ELEMS ranks
        (one row at least), made on the device, each resolved by one
        collective; only the live ranks come back to the host."""
        dev = self.mesh.device
        cap = bucket_size(max(int(count.max(initial=0)), 1), minimum=8)
        rows_per = max(1, self.MAX_SLICE_ELEMS // cap)
        offs = torch.arange(cap, dtype=I32, device=dev)
        out: list[np.ndarray] = []
        for i in range(0, len(start), rows_per):
            c_blk = count[i:i + rows_per]
            rows = bucket_size(len(c_blk), minimum=1)
            sc = np.zeros((2, rows), np.int32)
            sc[0, :len(c_blk)] = start[i:i + rows_per]
            sc[1, :len(c_blk)] = c_blk
            s_t, c_t = torch.from_numpy(sc).to(dev)
            live = offs[None, :] < c_t[:, None]
            ranks = torch.where(live, s_t[:, None] + offs[None, :], 0)
            vals = _gather_sharded(self._table, ranks, self.n_local,
                                   self.mesh)[live]
            flat = vals.cpu().numpy().astype(np.uint32)
            out.extend(np.split(flat, np.cumsum(c_blk)[:-1]))
        return out

    def positions_batch(self, queries) -> list[np.ndarray]:
        q, ql = self._encode(queries)
        start, count = self.bounds_batch(q, ql)
        if self._sa_host is not None:
            return [self._sa_host[s:s + c] for s, c in zip(start, count)]
        return self._gather_slices(start, count)

    def positions(self, query) -> np.ndarray:
        return self.positions_batch([query])[0]

    def count_batch(self, queries) -> np.ndarray:
        q, ql = self._encode(queries)
        return self.bounds_batch(q, ql)[1]

    def contains_batch(self, queries) -> np.ndarray:
        return self.count_batch(queries) > 0

    def contains(self, query) -> bool:
        return bool(self.contains_batch([query])[0])

    def any_position_batch(self, queries) -> list:
        """One byte offset per query, or None (src/table.rs:279-293): the
        first row of the SA slice, as ``SuffixTable.any_position``."""
        q, ql = self._encode(queries)
        start, count = self.bounds_batch(q, ql)
        if self._sa_host is not None:
            return [int(self._sa_host[s]) if c else None
                    for s, c in zip(start, count)]
        ranks = np.zeros((bucket_size(len(start), minimum=8),), np.int32)
        ranks[:len(start)] = start
        vals = _gather_sharded(
            self._table, torch.from_numpy(ranks).to(self.mesh.device),
            self.n_local, self.mesh).cpu().numpy()
        return [int(vals[j]) if c else None for j, c in enumerate(count)]

    def any_position(self, query):
        return self.any_position_batch([query])[0]
