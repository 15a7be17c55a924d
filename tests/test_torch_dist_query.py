"""The port's sharded serving (``suffix_torch/parallel/dist_query.py``)
against the JAX package's (``suffix_tpu/parallel/dist_query.py``): every
case of ``tests/test_dist_query.py``, its hypothesis property as 15
seeded cases, a collective slice in several chunks, an LCP whose
survivors run many rounds, and the multi-rank dry run
(``parallel/dryrun.py``).

Every case runs in ONE 8-rank gloo world started by ``launch.spawn`` (a
module fixture); meshes of 1 and 2 are its first ranks, as JAX's
``make_mesh(n)`` takes the first n of its 8 virtual CPU devices. Every
rank of a case's mesh must return the same result (checked by digest
inside the world); rank 0's come back and are held against JAX's
``ShardedQueryIndex`` on a mesh of the same size, against the port's and
JAX's ``SuffixTable`` and against the bytes. Tolerance: exact equality.
"""

import hashlib
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.parallel import launch  # noqa: E402

MESHES = (1, 2, 8)
SMALL = b"the quick brown fox was quick."
SMALL_QS = ["quick", "q", "fox", "zebra", "", "the quick brown fox was",
            "quick.", ".", "ick"]
LONG = (b"abracadabra" * 40)[:440]
LONG_QS = [LONG[7:7 + 25], LONG[0:30], b"abracadabra" * 3, LONG[3:3 + 19],
           b"x" * 22]
MISS = b"mississippi river mississippi delta"
MISS_QS = ["issi", "mississippi", "delta", "x", "i"]
RESIDENT = MISS + b" "
RESIDENT_QS = ["issi", "delta", "x", "i", "mississippi river mississippi",
               "", " m"]
ABRA = b"abracadabra" * 20
ANY_QS = ["quick", "q", "zebra", "", "the", "."]
# The collective slice in chunks: MAX_SLICE_ELEMS, passed to the ranks.
SLICE_ELEMS = 16
# The survivor loop in many rounds and chunks: (LCP_WINDOW0,
# LCP_WINDOW_MAX, LCP_FETCH_WORDS), passed to the ranks.
LCP_SMALL = (1, 2, 96)


def random_text() -> bytes:
    return (np.random.default_rng(0xC0FFEE).integers(
        0, 4, size=3000, dtype=np.uint8) + 97).tobytes()


def random_queries(data: bytes) -> list:
    rng = np.random.default_rng(0xBEE)
    out = []
    for qlen in [1, 2, 3, 7, 13, 18]:
        for _ in range(8):
            s = int(rng.integers(0, 3000 - qlen))
            out.append(data[s:s + qlen])
    return out + [b"zzz", b"aaaaaaaaaaaaaaaaaa", bytes([0, 1, 2])]


def lcp_text() -> bytes:
    return (b"abracadabra" * 30) + np.random.default_rng(0x1C9).integers(
        0, 256, size=500, dtype=np.uint8).tobytes()


def nearrep_text() -> bytes:
    """A 300-byte block tiled 7 times with two bytes flipped: LCPs of
    hundreds of bytes, so a small window runs many survivor rounds."""
    rep = bytearray(np.random.default_rng(5).integers(
        97, 101, size=300, dtype=np.uint8).tobytes() * 7)
    rep[700] ^= 1
    rep[1501] ^= 1
    return bytes(rep)


def nul_text() -> bytes:
    """NUL runs to the end: past the text the packed words read 0 too, so
    only the cap at the shorter suffix's length ends these LCPs."""
    return b"\x00" * 70 + b"a\x00" * 40 + b"\x00" * 90


def split_text() -> tuple[bytes, list]:
    """40 copies of one 24-byte prefix, each followed by one of four
    letters and 6 random bytes: every query past 18 bytes shares its key
    range with the other copies, and the refine must split it."""
    rng = np.random.default_rng(0x5917)
    head = b"prefix-shared-by-all-40!"
    text = b"".join(head + bytes([b"acgt"[int(rng.integers(4))]])
                    + rng.integers(97, 123, 6, dtype=np.uint8).tobytes()
                    for _ in range(40))
    qs = [head + b"c", head + b"a", head + b"z", head[:19], head,
          text[31 * 5:31 * 5 + 29], head + b"g" + text[31 * 7 + 25:31 * 8]]
    return text, qs


def slice_text() -> bytes:
    return b"ab" * 40 + b"abc" * 9 + b"zab"


SLICE_QS = ["ab", "abc", "b", "zab", "q", ""]


def prop_cases() -> list:
    """15 seeded (text, queries) pairs: the counterpart of JAX's
    hypothesis ``test_prop_sharded_queries`` (texts of 4-200 bytes, 1-6
    queries of 0-24 bytes, some cut from the text)."""
    rng = np.random.default_rng(0x51AD)
    out = []
    for _ in range(15):
        sigma = int(rng.choice([2, 4, 26, 256]))
        text = rng.integers(0, sigma, size=int(rng.integers(4, 201)),
                            dtype=np.uint8).tobytes()
        qs = []
        for _ in range(int(rng.integers(1, 7))):
            m = int(rng.integers(0, 25))
            if rng.random() < 0.5 and m <= len(text):
                s = int(rng.integers(0, len(text) - m + 1))
                qs.append(text[s:s + m])
            else:
                qs.append(rng.integers(0, sigma, size=m,
                                       dtype=np.uint8).tobytes())
        out.append((text, qs))
    return out


def bytes_text() -> bytes:
    return np.random.default_rng(7).integers(0, 256, size=16384,
                                             dtype=np.uint8).tobytes()


def _agreed(value, mesh) -> tuple:
    """(value, True when every rank of ``mesh`` returned the same)."""
    import torch.distributed as dist

    digest = hashlib.sha256(pickle.dumps(value)).hexdigest()
    seen = [None] * mesh.world_size
    dist.all_gather_object(seen, digest, group=mesh.group)
    return value, len(set(seen)) == 1


def _mesh_cases(m, dq) -> dict:
    """The per-mesh cases of tests/test_dist_query.py on mesh ``m``."""
    import torch.distributed as dist

    def table(text):
        return SuffixTable.new(text, device="cpu").table()

    def index(text, **kw):
        return dq.ShardedQueryIndex(text, m, **kw)

    out = {}
    idx = index(SMALL, sa=table(SMALL))
    out["directed"] = ([idx.positions(q) for q in SMALL_QS],
                       [idx.contains(q) for q in SMALL_QS])
    out["any_position"] = ([idx.any_position(q) for q in ANY_QS],
                           idx.any_position_batch(["quick", "nope"]))
    idx = index(b"banana", sa=table(b"banana"))
    out["duplicates"] = [idx.positions("ana"), idx.positions("a")]
    out["lcp_banana"] = idx.lcp_lens()
    data = random_text()
    out["random"] = index(np.frombuffer(data, np.uint8),
                          sa=table(data)).positions_batch(
                              random_queries(data))
    out["long"] = index(LONG, sa=table(LONG)).positions_batch(LONG_QS)
    data, qs = split_text()
    out["split"] = index(data, host_sa=False).positions_batch(qs)
    text = "☃abc☃"
    out["unicode"] = index(text.encode(), sa=table(text)).positions("☃")
    idx = index(MISS)
    out["scratch"] = ([idx.positions(q) for q in MISS_QS],
                      [int(idx.count_batch([q])[0]) for q in MISS_QS])
    idx = index(RESIDENT * 30)
    out["resident"] = (idx._sa_host is None,
                       idx.positions_batch(RESIDENT_QS),
                       idx.any_position_batch(["issi", "nope"]),
                       idx.lcp_lens(), idx.table())
    idx = index(ABRA, sa=table(ABRA), host_sa=False)
    out["host_sa"] = (idx._sa_host is None,
                      idx.positions_batch(["abra", "cad", "zzz"]),
                      index(ABRA, host_sa=True)._sa_host is not None)
    data = lcp_text()
    out["lcp"] = index(data, sa=table(data)).lcp_lens()
    out["lcp_nul"] = index(nul_text()).lcp_lens()

    idx = index(slice_text(), host_sa=False)
    idx.MAX_SLICE_ELEMS = SLICE_ELEMS
    out["slices"] = (idx.positions_batch(SLICE_QS),
                     idx.any_position_batch(SLICE_QS))
    saved = dq.LCP_WINDOW0, dq.LCP_WINDOW_MAX, dq.LCP_FETCH_WORDS
    dq.LCP_WINDOW0, dq.LCP_WINDOW_MAX, dq.LCP_FETCH_WORDS = LCP_SMALL
    try:
        data = nearrep_text()
        idx = index(data, sa=table(data))
        lcp = idx.lcp_lens()
        survivors = [None] * m.world_size
        dist.all_gather_object(survivors, idx._lcp_trace["survivors"],
                               group=m.group)
        out["lcp_rounds"] = (lcp, idx._lcp_trace["rounds"], survivors)
    finally:
        dq.LCP_WINDOW0, dq.LCP_WINDOW_MAX, dq.LCP_FETCH_WORDS = saved
    return out


def _world_cases(mesh) -> dict:
    """Every case of this file on each rank of an 8-rank world."""
    from suffix_torch.parallel import dist_query as dq
    from suffix_torch.parallel.dryrun import dryrun_multichip
    from suffix_torch.parallel.mesh import make_mesh

    out = {"dryrun": dryrun_multichip(2, n_bytes=1 << 16, rep_tiles=256,
                                      device="cpu")}
    for n in MESHES:
        m = make_mesh(n, device="cpu")
        if m is None:
            continue
        for key, value in _mesh_cases(m, dq).items():
            out[key, n] = _agreed(value, m)
    m8 = make_mesh(8, device="cpu")
    out["prop"] = _agreed(
        [dq.ShardedQueryIndex(t, m8, sa=SuffixTable.new(
            t, device="cpu").table()).positions_batch(qs)
         for t, qs in prop_cases()], m8)
    tiny = []
    for data in [b"", b"a", b"ab"]:
        idx = dq.ShardedQueryIndex(data, m8, sa=SuffixTable.new(
            data, device="cpu").table())
        tiny.append([idx.positions(q) for q in ["", "a", "b", "ab"]])
    out["tiny"] = _agreed(tiny, m8)
    data = bytes_text()
    sa = SuffixTable.new(data, device="cpu").table()
    per_rank = {}
    for d in (1, 8):
        m = make_mesh(d, device="cpu")
        if m is not None:
            idx = dq.ShardedQueryIndex(data, m, sa=sa)
            per_rank[d] = _agreed((idx._resident_bytes(), idx.n_pad), m)
    out["bytes"] = per_rank
    return out


@pytest.fixture(scope="module")
def world():
    return launch.spawn(_world_cases, 8, device="cpu")


def whole(world, key):
    value, agreed = world[key]
    assert agreed, f"the ranks of {key} returned different results"
    return value


@pytest.fixture(scope="module")
def jax_dq():
    """(JAX SuffixTable, ShardedQueryIndex, make_mesh)."""
    pytest.importorskip("jax")
    from suffix_tpu import SuffixTable as JTable
    from suffix_tpu.parallel.dist_query import ShardedQueryIndex
    from suffix_tpu.parallel.mesh import make_mesh

    return JTable, ShardedQueryIndex, make_mesh


def jax_index(jax_dq, text, n, **kw):
    JTable, JIndex, jmesh = jax_dq
    if "sa" not in kw:
        kw["sa"] = JTable.new(text).table()
    elif kw["sa"] is None:
        del kw["sa"]
    return JIndex(text, jmesh(n), **kw)


def same(got: list, want: list) -> bool:
    return len(got) == len(want) and all(
        np.asarray(g).dtype == np.asarray(w).dtype
        and np.array_equal(g, w) for g, w in zip(got, want))


def occurrences(raw: bytes, q: bytes) -> list:
    out, i = [], raw.find(q) if q else -1
    while i != -1:
        out.append(i)
        i = raw.find(q, i + 1)
    return out


def check_bytes(text: bytes, queries, got: list) -> None:
    """Each positions array holds the query's occurrences (as a set)."""
    for q, g in zip(queries, got):
        qb = q.encode() if isinstance(q, str) else q
        assert sorted(np.asarray(g).tolist()) == occurrences(text, qb), q


@pytest.mark.parametrize("n", MESHES)
def test_directed_small(world, jax_dq, n):
    pos, contains = whole(world, ("directed", n))
    want = jax_index(jax_dq, SMALL, n)
    assert same(pos, [want.positions(q) for q in SMALL_QS])
    assert contains == [want.contains(q) for q in SMALL_QS]
    st = SuffixTable.new(SMALL, device="cpu")
    assert same(pos, [st.positions(q) for q in SMALL_QS])
    check_bytes(SMALL, SMALL_QS, pos)


@pytest.mark.parametrize("n", MESHES)
def test_duplicate_matches_sa_order(world, jax_dq, n):
    got = whole(world, ("duplicates", n))
    want = jax_index(jax_dq, b"banana", n)
    assert same(got, [want.positions("ana"), want.positions("a")])
    assert [g.tolist() for g in got] == [[3, 1], [5, 3, 1]]


@pytest.mark.parametrize("n", MESHES)
def test_random_bytes_batch(world, jax_dq, n):
    data = random_text()
    qs = random_queries(data)
    got = whole(world, ("random", n))
    want = jax_index(jax_dq, np.frombuffer(data, np.uint8), n,
                     sa=SuffixTable.new(data, device="cpu").table())
    assert same(got, want.positions_batch(qs))
    check_bytes(data, qs, got)


@pytest.mark.parametrize("n", MESHES)
def test_long_queries_refine(world, jax_dq, n):
    got = whole(world, ("long", n))
    assert same(got, jax_index(jax_dq, LONG, n).positions_batch(LONG_QS))
    st = SuffixTable.new(LONG, device="cpu")
    assert same(got, st.positions_batch(LONG_QS))
    check_bytes(LONG, LONG_QS, got)


@pytest.mark.parametrize("n", MESHES)
def test_refine_splits_key_range(world, jax_dq, n):
    """Queries of 19-29 bytes whose 18-byte key range holds all 40
    copies of a prefix: the lockstep refine narrows both bounds."""
    data, qs = split_text()
    got = whole(world, ("split", n))
    want = jax_index(jax_dq, data, n, sa=None, host_sa=False)
    assert same(got, want.positions_batch(qs))
    assert same(got, SuffixTable.new(data, device="cpu")
                .positions_batch(qs))
    check_bytes(data, qs, got)
    assert 0 < len(got[0]) < 40 and len(got[4]) == 40


@pytest.mark.parametrize("n", MESHES)
def test_unicode_byte_offsets(world, jax_dq, n):
    got = whole(world, ("unicode", n))
    assert got.tolist() == [6, 0]
    text = "☃abc☃"
    JTable, JIndex, jmesh = jax_dq
    want = JIndex(text.encode(), jmesh(n), sa=JTable.new(text).table())
    assert np.array_equal(got, want.positions("☃"))


@pytest.mark.parametrize("n", MESHES)
def test_any_position(world, jax_dq, n):
    singles, batch = whole(world, ("any_position", n))
    want = jax_index(jax_dq, SMALL, n)
    assert singles == [want.any_position(q) for q in ANY_QS]
    assert batch == want.any_position_batch(["quick", "nope"])
    st = SuffixTable.new(SMALL, device="cpu")
    assert singles == [st.any_position(q) for q in ANY_QS]
    assert batch == [st.any_position("quick"), None]


@pytest.mark.parametrize("n", MESHES)
def test_build_from_scratch(world, jax_dq, n):
    pos, counts = whole(world, ("scratch", n))
    want = jax_index(jax_dq, MISS, n, sa=None)
    assert same(pos, [want.positions(q) for q in MISS_QS])
    assert counts == [int(want.count_batch([q])[0]) for q in MISS_QS]
    assert counts == [len(p) for p in pos]
    check_bytes(MISS, MISS_QS, pos)


@pytest.mark.parametrize("n", MESHES)
def test_device_resident_no_host_sa(world, jax_dq, n):
    """sa=None: the device-resident build, realigned on the device;
    positions take their SA slice from the rank shards."""
    no_host, pos, anyp, lcp, table = whole(world, ("resident", n))
    text = RESIDENT * 30
    want = jax_index(jax_dq, text, n, sa=None)
    assert no_host and want._sa_host is None
    assert same(pos, want.positions_batch(RESIDENT_QS))
    assert anyp == want.any_position_batch(["issi", "nope"])
    assert lcp.dtype == np.uint32 and np.array_equal(lcp, want.lcp_lens())
    assert table.dtype == np.uint32 and np.array_equal(table, want.table())
    st = SuffixTable.new(text, device="cpu")
    assert np.array_equal(table, st.table())
    assert np.array_equal(lcp, st.lcp_lens("kasai"))
    check_bytes(text, RESIDENT_QS, pos)


@pytest.mark.parametrize("n", MESHES)
def test_host_sa_flag(world, jax_dq, n):
    no_host, pos, kept = whole(world, ("host_sa", n))
    assert no_host and kept
    want = jax_index(jax_dq, ABRA, n, host_sa=False)
    assert same(pos, want.positions_batch(["abra", "cad", "zzz"]))
    check_bytes(ABRA, ["abra", "cad", "zzz"], pos)


@pytest.mark.parametrize("n", MESHES)
def test_sharded_lcp(world, jax_dq, n):
    data = lcp_text()
    got = whole(world, ("lcp", n))
    assert np.array_equal(got, jax_index(jax_dq, data, n).lcp_lens())
    assert np.array_equal(got, SuffixTable.new(data, device="cpu")
                          .lcp_lens("kasai"))


@pytest.mark.parametrize("n", MESHES)
def test_sharded_lcp_nul_runs(world, jax_dq, n):
    data = nul_text()
    got = whole(world, ("lcp_nul", n))
    assert np.array_equal(got, jax_index(jax_dq, data, n).lcp_lens())
    assert np.array_equal(got, SuffixTable.new(data, device="cpu")
                          .lcp_lens("kasai"))


@pytest.mark.parametrize("n", MESHES)
def test_sharded_lcp_banana(world, jax_dq, n):
    got = whole(world, ("lcp_banana", n))
    assert got.tolist() == [0, 1, 3, 0, 0, 2]
    assert np.array_equal(got, jax_index(jax_dq, b"banana", n).lcp_lens())


@pytest.mark.parametrize("n", MESHES)
def test_gather_slices_in_chunks(world, jax_dq, n):
    """host_sa=False with MAX_SLICE_ELEMS = 16: the slices of "ab" (89
    rows) and "b" come back in several collective chunks, in SA order."""
    pos, anyp = whole(world, ("slices", n))
    text = slice_text()
    want = jax_index(jax_dq, text, n, sa=None, host_sa=False)
    assert same(pos, want.positions_batch(SLICE_QS))
    assert anyp == want.any_position_batch(SLICE_QS)
    st = SuffixTable.new(text, device="cpu")
    assert same(pos, st.positions_batch(SLICE_QS))
    assert max(len(p) for p in pos) > SLICE_ELEMS
    check_bytes(text, SLICE_QS, pos)


@pytest.mark.parametrize("n", MESHES)
def test_lcp_survivors_many_rounds(world, jax_dq, n):
    """A window of 1-2 words and 96-word fetches over a near-periodic
    text: the survivor loop runs many rounds, several fetches a round,
    and ranks with different survivor counts stay in step."""
    data = nearrep_text()
    got, rounds, survivors = whole(world, ("lcp_rounds", n))
    assert np.array_equal(got, SuffixTable.new(data, device="cpu")
                          .lcp_lens("kasai"))
    assert np.array_equal(got, jax_index(jax_dq, data, n).lcp_lens())
    # The 18-byte keys leave every pair with an LCP of 18 or more.
    assert sum(survivors) == int((got >= 18).sum())
    assert rounds > 20 and int(got.max()) > 400


@pytest.mark.parametrize("case", range(15))
def test_prop_sharded_queries(world, jax_dq, case):
    text, qs = prop_cases()[case]
    got = whole(world, "prop")[case]
    JTable, JIndex, jmesh = jax_dq
    want = JIndex(text, jmesh(8), sa=JTable.new(text).table())
    assert same(got, want.positions_batch(qs))
    st = SuffixTable.new(text, device="cpu")
    assert same(got, st.positions_batch(qs))
    check_bytes(text, qs, got)


def test_empty_and_tiny_texts(world, jax_dq):
    JTable, JIndex, jmesh = jax_dq
    for data, got in zip([b"", b"a", b"ab"], whole(world, "tiny")):
        want = JIndex(data, jmesh(8), sa=JTable.new(data).table())
        for q, g in zip(["", "a", "b", "ab"], got):
            assert np.array_equal(g, want.positions(q)), (data, q)
            assert g.tolist() == SuffixTable.new(
                data, device="cpu").positions(q).tolist()


def test_per_rank_memory_scales(world, jax_dq):
    """Text (4 B), table (4) and keys (24) are all sharded: about 32/D
    bytes a character, and 8 ranks hold 1/8 each of one rank's bytes;
    JAX's index holds the same bytes a device."""
    per = {}
    for d, (value, agreed) in world["bytes"].items():
        assert agreed
        per[d] = value
    assert per[8][0] * 8 == per[1][0]
    assert abs(per[1][0] / per[1][1] - 32.0) < 2.0
    data = bytes_text()
    JTable, JIndex, jmesh = jax_dq
    sa = JTable.new(data).table()
    for d in (1, 8):
        idx = JIndex(data, jmesh(d), sa=sa)
        shard = sum(a.addressable_shards[0].data.nbytes
                    for a in (idx._text, idx._table, idx._pk_block))
        assert shard == per[d][0]


def test_dryrun_multichip(world):
    """The dry run at 2 ranks inside the world (ranks past the mesh get
    None): every surface checked, JAX's keys."""
    got = world["dryrun"]
    assert sorted(got) == sorted([
        "devices", "mesh", "n", "n_local", "build_s_1MB",
        "stepped_rounds_64K_repetitive", "per_round_collectives",
        "surfaces"])
    assert got["devices"] == 2 and got["mesh"] == {"d": 2}
    assert got["n"] == 1 << 16 and got["n_local"] == 1 << 15
    assert got["surfaces"] == {
        "build_1MB": "ok", "stepped+checkpoint_64K": "ok",
        "query(13 patterns)": "ok", "lcp_1MB": "ok"}
    assert got["stepped_rounds_64K_repetitive"] > 0
    per = got["per_round_collectives"]
    assert per["all_gathers"] == 1 and per["p2p_exchanges"] >= 3
