"""The port's sharded build (``suffix_torch/parallel/``) and streamed input
(``suffix_torch/utils/io.py``) against the JAX package's, the cases of
``tests/test_sharded.py``, ``tests/test_io.py`` and the sharded half of
``tests/test_u64.py``.

Every build case runs in ONE 8-rank gloo world started by ``launch.spawn``
(a module fixture); worlds of 1, 2 and 4 are its first ranks
(``make_mesh(n)``), as JAX's ``make_mesh(n)`` takes the first n of its 8
virtual CPU devices. Each rank of a case's mesh must return the same
whole result (checked by digest inside the world); rank 0's results
come back to the tests, which hold them against the naive oracle, the
single-device engine and JAX's results on its 8-device mesh. A second,
2-rank world checks that a failing rank's exception comes back; one rank
runs in the test's own process. Tolerance: exact equality.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch.ops.naive import naive_table  # noqa: E402
from suffix_torch.ops.padding import PAD  # noqa: E402
from suffix_torch.ops.prefix_doubling import suffix_array_bytes  # noqa: E402
from suffix_torch.parallel import dist_build as db  # noqa: E402
from suffix_torch.parallel import launch  # noqa: E402
from suffix_torch.utils.io import device_corpus, open_corpus  # noqa: E402

WORLDS = (1, 2, 4, 8)
DIRECTED = [
    b"banana",
    b"mississippi",
    b"a",
    b"aa",
    b"ab" * 37,
    b"\x00" * 19,
    bytes(range(256)),
    b"tgtgtgtgcaccg",
    "☃abc☃".encode("utf-8"),
]
RANDOM_SIZES = (5, 64, 200, 1000)
U64_CASES = [b"banana", b"mississippi" * 23,
             np.random.default_rng(11).integers(0, 256, size=3000,
                                                dtype=np.uint8).tobytes()]
ADAPTIVE = [(n_dev, n) for n_dev in (2, 8) for n in (700, 4096)]


def random_bytes(size: int) -> bytes:
    return np.random.default_rng(size).integers(
        0, 256, size=size, dtype=np.uint8).tobytes()


def skewed() -> bytes:
    # Heavy rank ties stress the bitonic merge-split and re-ranking.
    return np.random.default_rng(777).integers(
        0, 2, size=777, dtype=np.uint8).tobytes()


def prop_texts() -> list[bytes]:
    """30 seeded texts of 1-120 bytes over alphabets of 1 to 256 symbols:
    the counterpart of JAX's hypothesis ``test_prop_sharded_8dev``."""
    rng = np.random.default_rng(0x5AD)
    out = []
    for _ in range(30):
        sigma = int(rng.choice([1, 2, 3, 4, 26, 256]))
        size = int(rng.integers(1, 121))
        out.append(rng.integers(0, sigma, size=size,
                                dtype=np.uint8).tobytes())
    return out


def adaptive_text(n: int) -> np.ndarray:
    return np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8) + 97


def bins_text() -> np.ndarray:
    return np.random.default_rng(1024).integers(
        0, 256, size=1024, dtype=np.uint8).astype(np.int32)


def _agreed(value, mesh) -> tuple:
    """(value, True when every rank of ``mesh`` returned the same)."""
    import pickle

    import torch.distributed as dist

    digest = hashlib.sha256(pickle.dumps(value)).hexdigest()
    seen = [None] * mesh.world_size
    dist.all_gather_object(seen, digest, group=mesh.group)
    return value, len(set(seen)) == 1


def _world_cases(mesh, dna: bytes, corpus_path: str, dna_path: str):
    """Every case of this file on each rank of an 8-rank world."""
    import torch.distributed as dist

    from suffix_torch.ops import kernels
    from suffix_torch.ops import prefix_doubling as pd
    from suffix_torch.parallel.collective_bins import global_bucket_layout
    from suffix_torch.parallel.mesh import make_mesh
    from suffix_torch.utils.io import device_table
    from suffix_torch.utils.metrics import build_stats

    plain_calls = [0]
    plain = kernels.byte_histogram_plain

    def counting(values, n_bins):
        plain_calls[0] += 1
        return plain(values, n_bins)

    kernels.byte_histogram_plain = counting
    out = {}
    for n in WORLDS:
        m = make_mesh(n, device="cpu")
        if m is None:
            continue
        for i, data in enumerate(DIRECTED):
            out["directed", n, i] = _agreed(db.suffix_array_sharded(data, m), m)
        for size in RANDOM_SIZES:
            out["random", n, size] = _agreed(
                db.suffix_array_sharded(random_bytes(size), m), m)
        out["skewed", n] = _agreed(db.suffix_array_sharded(skewed(), m), m)
        out["dna", n] = _agreed(db.suffix_array_sharded(dna, m), m)
        for i, data in enumerate(U64_CASES):
            out["u64", n, i] = _agreed(
                db.suffix_array_sharded(data, m, index_dtype="u64"), m)
        before = plain_calls[0]
        out["bins", n] = _agreed(global_bucket_layout(bins_text(), m), m)
        calls = [None] * n
        dist.all_gather_object(calls, plain_calls[0] - before, group=m.group)
        out["bins_calls", n] = calls

    m8 = make_mesh(8, device="cpu")
    out["prop"] = _agreed([db.suffix_array_sharded(t, m8)
                           for t in prop_texts()], m8)
    out["path"] = _agreed(db.suffix_array_sharded(dna_path, m8), m8)
    block, n = device_corpus(corpus_path, m8)
    lut = np.arange(256, dtype=np.int32)[::-1].copy()
    coded, _ = device_corpus(corpus_path, m8, n_pad=1000, lut=lut, fill=0)
    sa = suffix_array_bytes(bytes(open_corpus(corpus_path)), device="cpu")
    table = device_table(sa.astype(np.int32), 1024, m8)
    out["corpus"] = _agreed(
        (n, [torch.cat(db._all_gather(b, m8)).numpy()
             for b in (block, coded, table)]), m8)
    stats = build_stats(dna, engine="sharded", device="cpu", mesh=m8)[1]
    out["stats"] = _agreed({k: v for k, v in stats.items()
                            if k not in ("elapsed_s", "bytes_per_s")}, m8)

    # The coded first round, with the size floor lowered in this process.
    floor = pd.ADAPTIVE_PACK_MIN
    pd.ADAPTIVE_PACK_MIN = 16
    try:
        for n_dev, size in ADAPTIVE:
            m = make_mesh(n_dev, device="cpu")
            if m is None:
                continue
            arr = adaptive_text(size)
            n_local = db._local_bucket(size, n_dev)
            planned = db._sharded_adaptive_plan(arr, n_local * n_dev,
                                                n_local) is not None
            out["adaptive", n_dev, size] = _agreed(
                (planned, db.suffix_array_sharded(arr, m)), m)
    finally:
        pd.ADAPTIVE_PACK_MIN = floor

    # A mesh of 6 ranks: the build refuses it; more ranks than the world.
    m6 = make_mesh(6, device="cpu")
    if m6 is not None:
        try:
            db.suffix_array_sharded(b"banana", m6)
        except ValueError as exc:
            out["pow2"] = str(exc)
    try:
        make_mesh(9, device="cpu")
    except ValueError as exc:
        out["too_many"] = str(exc)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, dna_10k):
    tmp = tmp_path_factory.mktemp("sharded")
    corpus = tmp / "c.bin"
    corpus.write_bytes(np.random.default_rng(777).integers(
        0, 256, size=777, dtype=np.uint8).tobytes())
    dna_path = tmp / "dna.fasta"
    dna_path.write_bytes(dna_10k)
    out = launch.spawn(_world_cases, 8, dna_10k, str(corpus), str(dna_path),
                       device="cpu")
    return out, str(corpus)


def whole(world, key):
    value, agreed = world[0][key]
    assert agreed, f"the ranks of {key} returned different results"
    return value


@pytest.fixture(scope="module")
def jax_sharded():
    """(suffix_array_sharded, suffix_tpu.parallel.mesh.make_mesh)."""
    pytest.importorskip("jax")
    from suffix_tpu.parallel.dist_build import suffix_array_sharded
    from suffix_tpu.parallel.mesh import make_mesh

    return suffix_array_sharded, make_mesh


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("i", range(len(DIRECTED)),
                         ids=[repr(d)[:18] for d in DIRECTED])
def test_directed(world, n, i):
    got = whole(world, ("directed", n, i))
    assert got.dtype == np.uint32
    assert np.array_equal(got, naive_table(DIRECTED[i]))


@pytest.mark.parametrize("n", WORLDS)
def test_random_bytes(world, n):
    for size in RANDOM_SIZES:
        data = random_bytes(size)
        assert np.array_equal(whole(world, ("random", n, size)),
                              suffix_array_bytes(data, device="cpu"))


@pytest.mark.parametrize("n", WORLDS)
def test_skewed_small_alphabet(world, n):
    assert np.array_equal(whole(world, ("skewed", n)),
                          suffix_array_bytes(skewed(), device="cpu"))


@pytest.mark.parametrize("n", WORLDS)
def test_dna_sharded_matches_jax(world, jax_sharded, dna_10k, n):
    jax_build, jax_mesh = jax_sharded
    got = whole(world, ("dna", n))
    assert np.array_equal(got, jax_build(dna_10k, jax_mesh(n)))


def test_prop_sharded_8dev_matches_jax(world, jax_sharded):
    jax_build, jax_mesh = jax_sharded
    mesh = jax_mesh(8)
    for text, got in zip(prop_texts(), whole(world, "prop")):
        assert np.array_equal(got, jax_build(text, mesh)), text
        assert np.array_equal(got, naive_table(text)), text


@pytest.mark.parametrize("n", WORLDS)
def test_u64_matches_u32(world, n):
    for i, data in enumerate(U64_CASES):
        got = whole(world, ("u64", n, i))
        assert got.dtype == np.uint64
        assert np.array_equal(got, suffix_array_bytes(data, device="cpu"))


def test_non_pow2_mesh_rejected(world):
    assert "power-of-two" in world[0]["pow2"]
    assert "requested 9 devices, have 8" in world[0]["too_many"]


def test_local_bucket_matches_jax():
    pytest.importorskip("jax")
    from suffix_tpu.parallel import dist_build as jdb

    for n in (1, 7, 64, 700, 799, 901, 5000, 10001, 1 << 20):
        for n_dev in WORLDS:
            assert db._local_bucket(n, n_dev) == jdb._local_bucket(n, n_dev)
    assert db._local_bucket(700, 8) == db._local_bucket(901, 8) == 128


@pytest.mark.parametrize("n_dev,size", ADAPTIVE)
def test_sharded_adaptive_coded_first_round(world, n_dev, size):
    planned, got = whole(world, ("adaptive", n_dev, size))
    assert planned
    assert np.array_equal(got, naive_table(adaptive_text(size).tobytes()))


def test_adaptive_plan_matches_jax(monkeypatch):
    pytest.importorskip("jax")
    from suffix_tpu.ops import prefix_doubling as jpd
    from suffix_tpu.parallel import dist_build as jdb
    from suffix_torch.ops import prefix_doubling as pd

    monkeypatch.setattr(jpd, "ADAPTIVE_PACK_MIN", 16)
    monkeypatch.setattr(pd, "ADAPTIVE_PACK_MIN", 16)
    for n_dev, size in ADAPTIVE + [(8, 40), (1, 1 << 12)]:
        arr = adaptive_text(size)
        n_local = db._local_bucket(size, n_dev)
        got = db._sharded_adaptive_plan(arr, n_local * n_dev, n_local)
        want = jdb._sharded_adaptive_plan(arr, n_local * n_dev, n_local)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("n", WORLDS)
def test_collective_bins_match_jax(world, n):
    """All-reduced bucket layout == the single-process Bins values and
    JAX's psum layout; each rank histogrammed its block once (the CPU
    path of byte_histogram: its plain version)."""
    pytest.importorskip("jax")
    from suffix_tpu.parallel.collective_bins import global_bucket_layout
    from suffix_tpu.parallel.mesh import make_mesh
    from suffix_torch.ops.sais import bucket_layout

    text = bins_text()
    got = whole(world, ("bins", n))
    want = global_bucket_layout(text, make_mesh(8))
    single = bucket_layout(torch.from_numpy(text))
    for g, w, s in zip(got, want, single):
        assert g.dtype == np.int32
        assert np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, s.numpy())
    assert world[0]["bins_calls", n] == [1] * n


def test_device_corpus_blocks_match_jax(world):
    pytest.importorskip("jax")
    from suffix_tpu.parallel.mesh import make_mesh
    from suffix_tpu.utils import io as jio

    (n, (plain, coded, table)), agreed = world[0]["corpus"]
    assert agreed and n == 777
    path = world[1]
    lut = np.arange(256, dtype=np.int32)[::-1].copy()
    mesh = make_mesh(8)
    assert np.array_equal(plain, np.asarray(jio.device_corpus(path, mesh)[0]))
    assert np.array_equal(coded, np.asarray(jio.device_corpus(
        path, mesh, n_pad=1000, lut=lut, fill=0)[0]))
    sa = naive_table(bytes(open_corpus(path)))
    assert np.array_equal(table, np.asarray(jio.device_table(sa, 1024, mesh)))
    assert plain.shape[0] % 8 == 0 and (plain[777:] == PAD).all()
    assert coded.shape == (1000,) and (coded[777:] == 0).all()


def test_sharded_build_from_path(world, dna_10k):
    assert np.array_equal(whole(world, "path"),
                          suffix_array_bytes(dna_10k, device="cpu"))


def test_sharded_stats_match_jax(world, dna_10k):
    pytest.importorskip("jax")
    from suffix_tpu.parallel.mesh import make_mesh
    from suffix_tpu.utils.metrics import build_stats

    got = whole(world, "stats")
    want = build_stats(dna_10k, engine="sharded", mesh=make_mesh(8))[1]
    assert got.pop("device") == "cpu"
    assert got == {k: v for k, v in want.items()
                   if k not in ("elapsed_s", "bytes_per_s", "device")}
    assert got["engine"] == "sharded(d=8)"


def test_open_and_device_corpus_single(tmp_path):
    p = tmp_path / "c.bin"
    p.write_bytes(b"mississippi")
    v = open_corpus(str(p))
    assert bytes(v) == b"mississippi" and not v.flags.writeable
    p.write_bytes(b"banana")
    arr, n = device_corpus(str(p), device="cpu")
    assert n == 6 and arr.dtype == torch.int32 and arr.shape == (16,)
    assert arr[:6].tolist() == list(b"banana") and (arr[6:] == PAD).all()
    arr2, _ = device_corpus(b"banana", device="cpu", n_pad=8, fill=0)
    assert arr2.tolist() == list(b"banana") + [0, 0]
    with pytest.raises(TypeError):
        device_corpus(np.zeros(4, np.int32), device="cpu")


def _fail_on_rank_1(mesh):
    import torch.distributed as dist

    if mesh.rank == 1:
        raise KeyError("rank 1 failed")
    dist.barrier()  # rank 0 waits for its peer, which has left


def test_spawn_reraises_the_failing_rank():
    """The second world of this file: rank 1's exception comes back, not
    rank 0's lost connection, with the rank's traceback as a note."""
    with pytest.raises(KeyError, match="rank 1 failed") as info:
        launch.spawn(_fail_on_rank_1, 2, device="cpu")
    assert any("on rank 1 of 2" in note
               for note in getattr(info.value, "__notes__", []))


def test_one_rank_runs_in_process_and_leaves_no_group():
    import torch.distributed as dist

    from suffix_torch.parallel.mesh import make_mesh

    assert launch.run(db.build_table, None, b"mississippi", device="cpu") \
        .tolist() == naive_table(b"mississippi").tolist()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="launch.spawn"):
        make_mesh(4, device="cpu")
    assert not dist.is_initialized()
