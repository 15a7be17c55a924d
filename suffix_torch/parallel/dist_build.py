"""Sharded suffix-array construction over a process group.

Port of ``suffix_tpu/parallel/dist_build.py``. The text is cut along the
sequence axis into one block a rank, and prefix doubling runs SPMD, each
rank on its own block:

- each round's global sort of (rank, rank[i+k], rank[i+2k], rank[i+3k],
  i) rows is a **block-bitonic sort**: every rank sorts its L rows, then
  log^2(D) merge-split stages exchange whole blocks with a partner
  (``j ^ stride``) and keep the low or the high half of the 2L rows by
  the bitonic direction bits: both partners find the same merge-path
  split of the two sorted blocks, and each sorts only the L rows it
  keeps;
- the dense re-rank after the sort takes the left neighbour's last row
  (one transfer), a local cumsum and the exclusive sum of every rank's
  flag count (an all-gather of one number a rank);
- ranks go home to their suffix's block by a second block-bitonic sort
  keyed on the suffix index;
- the shifted ranks rank[i + mk] come from the two blocks that each
  window spans.

Where JAX's ``shard_map`` body reads the round's ``k`` as a traced value
and decomposes block shifts bit by bit, here ``k`` and the ``done`` flag
are host values: each rank fetches the blocks it needs directly, and every
rank reads the same ``done`` (it comes from the all-gather) once a round,
so the ranks leave the loop together. A JAX ``ppermute`` is one
collective; here each rank posts its sends and receives of one exchange
in one ``batch_isend_irecv``, and a rank with nothing to send or receive
posts nothing. Sorts are ``ops/sort.py::lexsort``: the global row index
``gidx`` is a key, so the key set is a total order and both partners of
a merge-split agree on the split.

The result is bit-identical to the single-device engine: the suffix array
is the unique byte-lexicographic permutation, PAD (-1) below every byte
acting as the implicit sentinel. Every rank returns the whole array.

Each ``build_table`` call is a ``sharded_build`` root of the recorder
(``utils/profiling.py``) on every rank, with attributes ``rank``,
``world``, ``n``, ``n_total`` and ``route`` (``coded`` or ``packed``;
``device`` for a one-rank mesh, which runs the single-device build). Its
spans: ``sharded.plan`` (the adaptive plan and its probe),
``sharded.stage`` (``device_corpus``), ``sharded.rounds`` (the first
round to the host's read of the last round's ``done``),
``sharded.exchange`` (each ``_exchange`` and ``_all_gather``),
``sharded.gather`` (the table's all-gather and copy to the host) and
``sharded.finish`` (the slice, viewed in the output type). Its counters: ``rounds``,
``merge_stages``, ``exchange_bytes`` (the bytes this rank sends, point to
point and in all-gathers) and ``host_syncs``.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from suffix_torch.ops import prefix_doubling as pd
from suffix_torch.ops.padding import bucket_size
from suffix_torch.ops.sort import lexsort
from suffix_torch.parallel.mesh import Mesh
from suffix_torch.utils.io import device_corpus, open_corpus
from suffix_torch.utils.profiling import annotate, count, root, span


def _local_bucket(n: int, n_dev: int) -> int:
    """Block length a rank holds for a text of ``n`` bytes: the
    ceil-divided share rounded up to a power of two (>= 8), the JAX
    package's bucketing, so that both cut the same blocks."""
    return bucket_size(max(8, -(-n // n_dev)), minimum=8)


def _check_pow2(mesh: Mesh) -> int:
    """The merge-split network pairs partners by j ^ stride, a
    permutation only for a power-of-two mesh."""
    n_dev = mesh.world_size
    if n_dev & (n_dev - 1):
        raise ValueError(
            f"sharded construction needs a power-of-two device count, got "
            f"{n_dev}; use make_mesh(n) with the largest power of two")
    return n_dev


def _exchange(sends, recvs, mesh: Mesh) -> None:
    """One exchange: ``sends`` and ``recvs`` are (peer rank, tensor)
    pairs, posted together and waited for; the i-th message to a peer
    carries tag i."""
    ops = [dist.P2POp(dist.isend, t, peer, mesh.group, tag)
           for tag, (peer, t) in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, t, peer, mesh.group, tag)
            for tag, (peer, t) in enumerate(recvs)]
    with span("sharded.exchange"):
        count("exchange_bytes", sum(t.nbytes for _, t in sends))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()


def _bitonic_global_sort(arrays: list, num_keys: int, n_local: int,
                         mesh: Mesh):
    """Sort rows held as L per rank globally: afterwards rank d holds
    sorted rows [d * L, (d + 1) * L). The first ``num_keys`` arrays are
    the keys; they must be a total order (include a unique column). The
    list ``arrays`` is emptied, so that its columns are freed once the
    first local sort has read them."""
    cols = list(lexsort(arrays[:num_keys], arrays[num_keys:]))
    arrays.clear()
    n_dev, me = mesh.world_size, mesh.rank
    size = 2
    while size <= n_dev:
        stride = size // 2
        while stride >= 1:
            peer = me ^ stride
            count("merge_stages")
            theirs = [torch.empty_like(a) for a in cols]
            _exchange([(peer, a) for a in cols],
                      [(peer, b) for b in theirs], mesh)
            keep_low = ((me & size) == 0) == ((me & stride) == 0)
            lower, upper = (cols, theirs) if me < peer else (theirs, cols)
            kept = _merge_split(lower, upper, num_keys, keep_low)
            del cols, theirs, lower, upper
            cols = list(lexsort(kept[:num_keys], kept[num_keys:]))
            del kept
            stride //= 2
        size *= 2
    return cols


def _merge_split(lower, upper, num_keys: int, keep_low: bool):
    """The L rows that one partner of a merge-split keeps, as two sorted
    runs (unsorted as a whole). ``lower`` and ``upper`` are the lower and
    the higher rank's sorted blocks, columns of L rows whose first
    ``num_keys`` are the keys of a total order. The L smallest of the 2L
    rows are ``lower[:p]`` and ``upper[:L - p]``, where p counts the i
    with lower[i] < upper[L - 1 - i] (true up to p, false after): the
    merge path's split, the same on both partners, found on the device
    with no host sync. The L largest are the rest."""
    n = lower[0].shape[0]
    less = None
    for x, y in zip(reversed(lower[:num_keys]), reversed(upper[:num_keys])):
        y = y.flip(0)
        less = x < y if less is None else (x < y) | ((x == y) & less)
    p = less.sum()
    del less
    j = torch.arange(n, device=lower[0].device)
    if keep_low:  # lower[:p], then upper[:n - p]
        first = j < p
        at = (j - p).clamp_(min=0)
        return [torch.where(first, a, b[at]) for a, b in zip(lower, upper)]
    first = j < n - p  # lower[p:], then upper[n - p:]
    at = (j + p).clamp_(max=n - 1)
    return [torch.where(first, a[at], b) for a, b in zip(lower, upper)]


def _left_boundary(cols, mesh: Mesh, fill: int):
    """Each column shifted right by one row of the global order: the left
    neighbour's last row in front, the local last row dropped; rank 0
    takes ``fill``. One transfer carries every column."""
    last = torch.stack([c[-1] for c in cols]).long()
    incoming = torch.full_like(last, fill)
    me = mesh.rank
    if mesh.world_size > 1:
        _exchange([(me + 1, last)] if me < mesh.world_size - 1 else [],
                  [(me - 1, incoming)] if me > 0 else [], mesh)
    return [torch.cat([incoming[i:i + 1].to(c.dtype), c[:-1]])
            for i, c in enumerate(cols)]


def _halo_fetch3(rank_home: torch.Tensor, k: int, n_local: int,
                 mesh: Mesh):
    """(rank[i+k], rank[i+2k], rank[i+3k]) for this rank's block, -1 past
    the end. Window [gidx + mk, gidx + mk + L) spans blocks me + s and
    me + s + 1 (s = mk // L); each block distance any window needs moves
    once, rank j sending its block to j - d and receiving j + d's."""
    ks = (k, 2 * k, 3 * k)
    if mesh.world_size == 1:
        ext = torch.cat([rank_home, torch.full_like(rank_home, -1)])
        return tuple(ext[min(s, n_local):min(s, n_local) + n_local]
                     for s in ks)
    n_dev, me = mesh.world_size, mesh.rank
    shifts = [(mk // n_local, mk % n_local) for mk in ks]
    blocks = {0: rank_home}
    sends, recvs = [], []
    for d in sorted({b for s, _ in shifts for b in (s, s + 1)} - {0}):
        if me - d >= 0:
            sends.append((me - d, rank_home))
        if me + d < n_dev:
            blocks[d] = torch.empty_like(rank_home)
            recvs.append((me + d, blocks[d]))
    _exchange(sends, recvs, mesh)
    past = torch.full_like(rank_home, -1)
    rows = []
    for s, off in shifts:
        rows.append(torch.cat([blocks.get(s, past)[off:],
                               blocks.get(s + 1, past)[:off]]))
    return tuple(rows)


def _halo_from_right(x: torch.Tensor, halo_len: int, mesh: Mesh):
    """The first ``halo_len`` values of the right neighbour's block
    (zeros on the last rank: the sentinel past the global end)."""
    halo = x.new_zeros((halo_len,))
    me = mesh.rank
    if mesh.world_size > 1:
        _exchange([(me - 1, x[:halo_len].contiguous())] if me > 0 else [],
                  [(me + 1, halo)] if me < mesh.world_size - 1 else [],
                  mesh)
    return halo


def _coded_initial_words(codes_local: torch.Tensor, mesh: Mesh,
                         n_words: int, bits: int, cpw: int):
    """This block's dense-coded initial key words (the sharded form of
    ``ops/prefix_doubling._packed_words``): each word packs ``cpw`` codes
    of ``bits`` bits, n_words * cpw leading characters in all; the
    (n_words * cpw - 1)-code halo comes from the right neighbour."""
    n_local = codes_local.shape[0]
    halo_len = n_words * cpw - 1
    if halo_len >= n_local:
        raise ValueError("shard shorter than the initial key window")
    ext = torch.cat([codes_local,
                     _halo_from_right(codes_local, halo_len, mesh)])
    return [w[:n_local] for w in pd._packed_words(ext, n_words, bits, cpw)]


def _all_gather(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every rank's ``x``, in rank order."""
    if mesh.world_size == 1:
        return [x]
    out = [torch.empty_like(x) for _ in range(mesh.world_size)]
    with span("sharded.exchange"):
        count("exchange_bytes", x.nbytes * (mesh.world_size - 1))
        dist.all_gather(out, x.contiguous(), group=mesh.group)
    return out


def _rerank_and_home(key_cols, idx: torch.Tensor, n_local: int, mesh: Mesh,
                     dtype):
    """Dense re-rank of globally sorted key columns, and the ranks routed
    home. Returns (rank in home layout, done): done when every suffix
    has its own rank."""
    n_total = n_local * mesh.world_size
    flag = torch.zeros((n_local,), dtype=torch.bool, device=idx.device)
    for col, prev in zip(key_cols, _left_boundary(key_cols, mesh, fill=-2)):
        flag |= col != prev
    if mesh.rank == 0:
        flag[0] = False
    local_cum = torch.cumsum(flag, 0, dtype=dtype)
    totals = torch.cat(_all_gather(local_cum[-1:], mesh))
    dense = local_cum + totals[:mesh.rank].sum().to(dtype)
    done = int(totals.sum()) + 1 == n_total
    count("host_syncs")
    _, rank_new = _bitonic_global_sort([idx, dense], 1, n_local, mesh)
    return rank_new, done


def _global_index(n_local: int, mesh: Mesh, dtype, device) -> torch.Tensor:
    return (torch.arange(n_local, dtype=dtype, device=device)
            + mesh.rank * n_local)


def _coded_first_round(codes_local: torch.Tensor, n_local: int, mesh: Mesh,
                       n_words: int, bits: int, cpw: int, index_dtype):
    """First round over dense-coded words: the global sort by the word
    tuple (and gidx), then the dense re-rank. Returns the state of
    ``_round_body`` with k = n_words * cpw."""
    count("rounds")
    gidx = _global_index(n_local, mesh, index_dtype, codes_local.device)
    words = _coded_initial_words(codes_local, mesh, n_words, bits, cpw)
    sorted_ops = _bitonic_global_sort(words + [gidx], n_words + 1, n_local,
                                      mesh)
    idx = sorted_ops[-1]
    rank_new, done = _rerank_and_home(sorted_ops[:-1], idx, n_local, mesh,
                                      index_dtype)
    return rank_new, idx, n_words * cpw, done


def _packed_initial_rank(text_local: torch.Tensor, mesh: Mesh):
    """Packed 3-byte starting keys of this block (order = first-3-char
    order); the 2-symbol halo comes from the right neighbour."""
    sym = (text_local + 1).to(torch.int32)  # PAD -> 0, bytes -> 1..256
    ext = torch.cat([sym, _halo_from_right(sym, 2, mesh)])
    return (ext[:-2] << 18) | (ext[1:-1] << 9) | ext[2:]


def _round_body(rank_home: torch.Tensor, k: int, n_local: int, mesh: Mesh):
    """One quadrupling round on this rank: sorting by (rank[i], rank[i+k],
    rank[i+2k], rank[i+3k]) orders by 4k characters. Returns (rank_new,
    sa_sorted, next_k, done); sa_sorted is this rank's block of the
    current order (rank d holds ranks [d*L, (d+1)*L))."""
    count("rounds")
    dtype = rank_home.dtype  # int32, or int64 for u64 builds
    gidx = _global_index(n_local, mesh, dtype, rank_home.device)
    with record_function("D1_halo_shift"):
        cols = [rank_home, *_halo_fetch3(rank_home, k, n_local, mesh),
                gidx]
    del rank_home, gidx
    with record_function("D2_global_bitonic_sort"):
        r, c1, c2, c3, idx = _bitonic_global_sort(cols, 5, n_local, mesh)
    with record_function("D3_rerank_route_home"):
        rank_new, done = _rerank_and_home((r, c1, c2, c3), idx, n_local,
                                          mesh, dtype)
    # k == 0 (a resumed legacy checkpoint) ordered by single characters.
    return rank_new, idx, 1 if k == 0 else 4 * k, done


def _dist_build(block: torch.Tensor, n_local: int, mesh: Mesh,
                index_dtype=torch.int32, plan: tuple | None = None):
    """The one-shot SPMD build of this rank's block: bytes, or with
    ``plan`` = (n_words, bits, cpw) dense codes for the coded first
    round. Returns this rank's block of the suffix array (sorted
    layout)."""
    n_total = n_local * mesh.world_size
    if plan is not None:
        state = _coded_first_round(block, n_local, mesh, *plan, index_dtype)
    else:
        rank0 = _packed_initial_rank(block, mesh).to(index_dtype)
        # Always one round: packed keys order by 3 characters, so the
        # round orders by 12.
        state = _round_body(rank0, 3, n_local, mesh)
    while not state[3] and state[2] < n_total:
        rank, k = state[0], state[2]
        state = None  # the last round's order is dead
        state = _round_body(rank, k, n_local, mesh)
    return state[1]


def _resolve_index_dtype(index_dtype: str, n_total: int):
    """(torch dtype, numpy output dtype) for n_total slots; u64 is int64
    on the device."""
    if index_dtype == "auto":
        index_dtype = "u64" if n_total >= (1 << 31) else "u32"
    if index_dtype == "u64":
        return torch.int64, np.uint64
    if n_total >= (1 << 31):
        raise ValueError(
            "text needs >= 2^31 padded bytes: pass index_dtype='u64'")
    return torch.int32, np.uint32


def _as_u8(data) -> np.ndarray:
    if isinstance(data, str):
        return open_corpus(data)
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def _gather_sa(sa_local: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The whole suffix array on every rank, as numpy: each gathered
    block is copied into its slice of one host array."""
    with span("sharded.gather"):
        blocks = _all_gather(sa_local, mesh)
        count("host_syncs", len(blocks))
        out = torch.empty((sum(b.shape[0] for b in blocks),),
                          dtype=sa_local.dtype)
        at = 0
        for b in blocks:
            out[at:at + b.shape[0]].copy_(b)
            at += b.shape[0]
        return out.numpy()


def _finish(sa: np.ndarray, n: int, out_dtype) -> np.ndarray:
    """The ``n`` text suffixes of the padded array, in the output type:
    a view, since the positions are non-negative and the signed and
    unsigned types have one width."""
    with span("sharded.finish"):
        return sa[sa.shape[0] - n:].view(out_dtype)


def suffix_array_sharded(data, mesh: Mesh,
                         index_dtype: str = "u32") -> np.ndarray:
    """Suffix array built across the ranks of ``mesh``; every rank calls
    this and gets the whole array.

    ``data``: bytes, a uint8 array, or a file path (read block by block
    from an mmap, never as a whole int32 copy). ``index_dtype``: "u32"
    (padded size < 2^31), "u64" (int64 on the device, uint64 out) or
    "auto"."""
    arr = _as_u8(data)
    n = int(arr.shape[0])
    if n == 0:
        return np.empty((0,), dtype=np.uint32)
    sa_local, _, _, out_dtype = suffix_array_sharded_device(
        arr, mesh, index_dtype)
    return _finish(_gather_sa(sa_local, mesh), n, out_dtype)


def build_table(mesh: Mesh, data, checkpoint_path: str | None = None,
                resume: bool = False, index_dtype: str = "u32") -> np.ndarray:
    """The suffix array of ``data`` (bytes, uint8 array or file path) on
    ``mesh``: the stepped build when ``checkpoint_path`` is given, else
    the one-shot one. What ``BuildConfig(sharded=True)`` and the CLI's
    ``build --engine sharded`` run on every rank (``launch.run``); a
    ``sharded_build`` root of the recorder."""
    arr = _as_u8(data)
    n = int(arr.shape[0])
    n_total = _local_bucket(n, mesh.world_size) * mesh.world_size
    with root("sharded_build", rank=mesh.rank, world=mesh.world_size, n=n,
              n_total=n_total):
        if checkpoint_path:
            return suffix_array_sharded_stepped(
                arr, mesh, checkpoint_path=checkpoint_path, resume=resume,
                index_dtype=index_dtype)
        return suffix_array_sharded(arr, mesh, index_dtype=index_dtype)


def suffix_array_sharded_device(data, mesh: Mesh, index_dtype: str = "u32"):
    """Device-resident sharded build: (sa_local, n_total, n_local,
    out_dtype). ``sa_local`` is this rank's block of the padded suffix
    array (the padding suffixes fill its first ``n_total - n`` slots
    globally); the host never holds the table. A one-rank mesh runs the
    single-device build (``device_build_closure``), as JAX does: same
    layout, same output, and its class routes."""
    arr = _as_u8(data)
    n_dev = _check_pow2(mesh)
    n_local = _local_bucket(int(arr.shape[0]), n_dev)
    n_total = n_local * n_dev
    dtype, out_dtype = _resolve_index_dtype(index_dtype, n_total)
    if n_dev == 1:
        annotate(route="device")
        dispatch, _ = pd.device_build_closure(arr, n_total, index_dtype=dtype,
                                              device=mesh.device)
        return dispatch(), n_total, n_local, out_dtype
    block, plan = _plan_and_stage(arr, mesh, n_total, n_local)
    with span("sharded.rounds"):
        sa_local = _dist_build(block, n_local, mesh, dtype, plan)
    return sa_local, n_total, n_local, out_dtype


def _plan_and_stage(arr: np.ndarray, mesh: Mesh, n_total: int, n_local: int):
    """(this rank's block on its device, plan): dense codes under the
    adaptive plan (n_words, bits, cpw), or bytes and None."""
    with span("sharded.plan"):
        plan_full = _sharded_adaptive_plan(arr, n_total, n_local, mesh)
    annotate(route="packed" if plan_full is None else "coded")
    with span("sharded.stage"):
        if plan_full is None:
            return device_corpus(arr, mesh, n_pad=n_total)[0], None
        lut, plan = plan_full
        return (device_corpus(arr, mesh, n_pad=n_total, lut=lut, fill=0)[0],
                plan)


def _byte_counts(arr: np.ndarray, n_local: int, mesh: Mesh) -> np.ndarray:
    """The 256 byte counts of the whole text: each rank counts its own
    block, and one all-reduce sums them."""
    lo = mesh.rank * n_local
    counts = torch.from_numpy(np.bincount(arr[lo:lo + n_local],
                                          minlength=256)).to(mesh.device)
    if mesh.world_size > 1:
        dist.all_reduce(counts, group=mesh.group)
    count("host_syncs")
    return counts.cpu().numpy()


def _sharded_adaptive_plan(arr: np.ndarray, n_total: int, n_local: int,
                           mesh: Mesh | None = None):
    """(lut, (n_words, bits, cpw)) for the dense-coded first round, or
    None: the single-device policy (``prefix_doubling._adaptive_plan``),
    with the key window inside one block's halo. With ``mesh`` (every
    rank calls this) the byte counts come from the ranks' own blocks."""
    if n_total < pd.ADAPTIVE_PACK_MIN:
        return None
    plan = pd._adaptive_plan(
        arr, n_total,
        counts=None if mesh is None else _byte_counts(arr, n_local, mesh))
    if plan is None:
        return None
    lut, bits, cpw, n_words = plan
    if n_words * cpw >= n_local:
        return None  # degenerate: window wider than a block
    return lut, (n_words, bits, cpw)


# ---------------------------------------------------------------------------
# The stepped build: checkpoint and resume between rounds
# ---------------------------------------------------------------------------

def _ckpt_path(checkpoint_path: str, mesh: Mesh) -> str:
    """This rank's checkpoint file: ``{path}.p{rank}`` on a mesh of more
    than one rank (each persists its own block), else ``path``."""
    if mesh.world_size > 1:
        return f"{checkpoint_path}.p{mesh.rank}"
    return checkpoint_path


def _save_ckpt(checkpoint_path: str, mesh: Mesh, rank: torch.Tensor,
               sa: torch.Tensor, k: int, done: bool, n_total: int) -> None:
    """Atomic persist of one round (write, then rename); the previous
    round stays as ``.prev``, so a rank that ran one round ahead of a
    crashed peer can rewind to the last round all ranks completed."""
    path = _ckpt_path(checkpoint_path, mesh)
    tmp = path + ".tmp.npz"
    np.savez(tmp, los=np.asarray([mesh.rank * rank.shape[0]], np.int64),
             rank=rank.cpu().numpy()[None], sa=sa.cpu().numpy()[None],
             k=np.int64(k), done=np.bool_(done), n_total=np.int64(n_total))
    if os.path.exists(path):
        os.replace(path, path + ".prev")
    os.replace(tmp, path)


def _load_ckpt_file(path: str, n_total: int):
    """(los, rank_blocks, sa_blocks, k, done) or None."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["n_total"]) != n_total:
                return None
            return (z["los"], z["rank"], z["sa"], int(z["k"]),
                    bool(z["done"]))
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None  # corrupt or partial checkpoint: the caller restarts


def _own_blocks(state, lo: int, n_local: int):
    """(rank, sa) numpy of [lo, lo + n_local) when the file's blocks tile
    exactly that span (one block of this rank, or a one-rank run of a
    JAX checkpoint's blocks), else None."""
    los, rblocks, sblocks = state[:3]
    order = np.argsort(los)
    width = rblocks.shape[1]
    if (len(los) * width != n_local
            or not np.array_equal(los[order],
                                  lo + width * np.arange(len(los)))):
        return None
    return rblocks[order].reshape(-1), sblocks[order].reshape(-1)


def _all_min(value: int, mesh: Mesh) -> int:
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    if mesh.world_size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return int(t)


def _resume_state(checkpoint_path: str, mesh: Mesh, n_total: int,
                  n_local: int, dtype):
    """(rank, sa, k, done) from this rank's checkpoints, or None.

    The ranks agree on the latest round completed by all (a crash can
    leave one rank a round ahead; its ``.prev`` holds the common round).
    A rank with no usable file makes every rank restart clean.
    Deterministic rounds make the resumed build bit-identical."""
    path = _ckpt_path(checkpoint_path, mesh)
    states = {}
    for p in (path, path + ".prev"):
        st = _load_ckpt_file(p, n_total)
        if st is not None:
            own = _own_blocks(st, mesh.rank * n_local, n_local)
            if own is not None:
                states.setdefault(st[3], (*own, st[4]))
    k_common = _all_min(max(states, default=-1), mesh)
    if k_common < 0:
        return None
    if _all_min(int(k_common in states), mesh) == 0:
        raise RuntimeError(
            f"cannot resume: rank {mesh.rank}'s checkpoints cover rounds "
            f"{sorted(states)} and the slowest rank is at {k_common}")
    rank, sa, done = states[k_common]
    return (torch.from_numpy(rank.astype(np.int64)).to(mesh.device, dtype),
            torch.from_numpy(sa.astype(np.int64)).to(mesh.device, dtype),
            k_common, done)


def suffix_array_sharded_stepped(data, mesh: Mesh,
                                 checkpoint_path: str | None = None,
                                 resume: bool = False, round_hook=None,
                                 index_dtype: str = "u32") -> np.ndarray:
    """Host-driven sharded build with checkpoint and resume between
    rounds; every rank calls this and gets the whole array.

    Each round runs the SPMD round body (on any mesh, one rank included);
    after it, (rank, sa, k, done) is persisted atomically, and a
    restarted build with ``resume`` continues from the last round every
    rank completed, bit-identical to an uninterrupted one.
    ``round_hook(k, done)`` runs after each persisted round."""
    arr = (np.frombuffer(bytes(data), dtype=np.uint8)
           if isinstance(data, (bytes, bytearray))
           else np.asarray(data, dtype=np.uint8))
    n = int(arr.shape[0])
    if n == 0:
        return np.empty((0,), dtype=np.uint32)
    n_dev = _check_pow2(mesh)
    n_local = _local_bucket(n, n_dev)
    n_total = n_local * n_dev
    dtype, out_dtype = _resolve_index_dtype(index_dtype, n_total)

    def persist(state) -> None:
        rank, sa, k, done = state
        if checkpoint_path:
            _save_ckpt(checkpoint_path, mesh, rank, sa, k, done, n_total)
        if round_hook is not None:
            round_hook(k, done)

    state = None
    if resume and checkpoint_path:
        state = _resume_state(checkpoint_path, mesh, n_total, n_local, dtype)
    if state is None:
        block, plan = _plan_and_stage(arr, mesh, n_total, n_local)
    with span("sharded.rounds"):
        if state is None and plan is not None:
            # The coded first round is step 0: its state (k = n_words *
            # cpw) resumes through the normal quadrupling rounds.
            state = _coded_first_round(block, n_local, mesh, *plan, dtype)
            persist(state)
        elif state is None:
            state = (_packed_initial_rank(block, mesh).to(dtype), None, 3,
                     False)
        while not state[3] and state[2] < n_total:
            state = _round_body(state[0], state[2], n_local, mesh)
            persist(state)
    return _finish(_gather_sa(state[1], mesh), n, out_dtype)
