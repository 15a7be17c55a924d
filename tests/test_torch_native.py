"""The port's native engine (``suffix_torch/native``) against the JAX
package's (``suffix_tpu/native``) and the naive oracle: SA-IS, Kasai, the
batched bounds, the CPython extension's single-query operations, and the
build (into ``suffix_torch/_build/``, keyed by sources, flags and host
CPU, its own copy of each library beside the JAX package's in one
process). The cases of ``tests/test_native.py``. JAX is imported by a
fixture. Tolerance: exact equality.
"""

import ctypes
import hashlib
import pathlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable, native  # noqa: E402
from suffix_torch.ops import lcp as lcp_ops  # noqa: E402
from suffix_torch.ops.naive import naive_table  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
GOLDEN = {  # tests/test_golden.py: SA and LCP digests
    "AP009048_10000": (
        "335641df720e6a760955d891723fa48fc1554248ac89a44b1a3f4a36eaa0fdc3",
        "427e0d914a5e7c62d4b06e9b360ced03da1889f4c3fc488169e3faf83d29be57"),
    "AP009048_100000": (
        "d674074d481d76d7ac4e4ae4fe5df93a458a3b6fcb483ac92190babc52029694",
        "10992fb21e4db240c0024acd3661b1a3af997c0fb7a1591352a89e3e1aba373d"),
}
DIRECTED = [b"banana", b"mississippi", b"", b"a", b"aa", b"ab", b"\x00",
            b"tgtgtgtgcaccg", "☃abc☃".encode()]


@pytest.fixture(scope="module")
def jnative():
    pytest.importorskip("jax")
    from suffix_tpu import native as jn

    return jn


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.uint32).tobytes()).hexdigest()


@pytest.mark.parametrize("text", DIRECTED)
def test_directed(jnative, text):
    got = native.sais(text)
    assert got.dtype == np.uint32
    assert np.array_equal(got, naive_table(text))
    assert np.array_equal(got, jnative.sais(text))
    assert np.array_equal(native.kasai(text, got), jnative.kasai(text, got))


@settings(max_examples=200, deadline=None)
@given(st.binary(max_size=128))
def test_prop_sais(jnative, b):
    got = native.sais(b)
    assert np.array_equal(got, naive_table(b))
    assert np.array_equal(got, jnative.sais(b))


@settings(max_examples=100, deadline=None)
@given(st.binary(max_size=96))
def test_prop_kasai(jnative, b):
    sa = native.sais(b)
    got = native.kasai(b, sa)
    assert got.dtype == np.uint32
    assert np.array_equal(got, lcp_ops.kasai_host(np.frombuffer(b, np.uint8),
                                                  sa))
    assert np.array_equal(got, jnative.kasai(b, sa))


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_fixtures_golden(jnative, name):
    data = (FIXTURES / f"{name}.fasta").read_bytes()
    sa_digest, lcp_digest = GOLDEN[name]
    sa = native.sais(data)
    lcp = native.kasai(data, sa)
    assert _sha(sa) == sa_digest and _sha(lcp) == lcp_digest
    assert np.array_equal(sa, jnative.sais(data))
    assert np.array_equal(lcp, jnative.kasai(data, sa))
    # The numpy array input takes the same route as bytes.
    arr = np.frombuffer(data, np.uint8)
    assert np.array_equal(native.sais(arr), sa)
    assert np.array_equal(native.kasai(arr, sa), lcp)


@settings(max_examples=60, deadline=None)
@given(st.binary(max_size=64), st.binary(min_size=1, max_size=5))
def test_prop_bounds(jnative, hay, needle):
    table = native.sais(hay)
    starts, counts = native.bounds_batch(hay, table, [needle])
    want = jnative.bounds_batch(hay, table, [needle])
    assert np.array_equal(counts, want[1])
    if counts[0]:
        assert np.array_equal(starts, want[0])
    dev = SuffixTable.new(hay, device="cpu")
    dev.query_route = "device"
    got = sorted(table[starts[0]:starts[0] + counts[0]].tolist())
    assert got == sorted(dev.positions(needle).tolist())


def test_bounds_batch_many(jnative, dna_10k):
    table = native.sais(dna_10k)
    queries = ([dna_10k[i:i + 9] for i in range(0, 3000, 83)]
               + [b"zzz", b"", "ACG", bytearray(b"TT")])
    starts, counts = native.bounds_batch(dna_10k, table, queries)
    jstarts, jcounts = jnative.bounds_batch(dna_10k, table, queries)
    assert starts.dtype == counts.dtype == np.uint32
    assert np.array_equal(counts, jcounts)
    assert np.array_equal(starts[counts > 0], jstarts[jcounts > 0])
    dev = SuffixTable.new(dna_10k, device="cpu")
    dev.query_route = "device"
    ds, dc = dev._bounds_batch(queries)
    assert np.array_equal(counts, dc)
    assert np.array_equal(starts[counts > 0], ds[dc > 0])
    assert native.bounds_batch(dna_10k, table, [])[0].shape == (0,)


# ---------------------------------------------------------------- fastpath
# The CPython extension: one C call per whole positions / contains / count
# / any_position, and the SA builds without marshalling. Each must equal
# the ctypes and batch routes bit for bit.


@pytest.fixture(scope="module")
def fastpath():
    fp = native._load_fastpath()
    assert fp is not None, native.fastpath_error
    return fp


def test_fastpath_builds_match_oracles(fastpath, dna_10k):
    for text in [b"", b"a", b"banana", b"mississippi", b"\x00\x00a\x00",
                 bytes(range(256)) * 2, dna_10k[:3000]]:
        golden = naive_table(text)
        assert np.array_equal(fastpath.sais(text), golden)
        assert np.array_equal(fastpath.naive(text), golden)


def test_fastpath_ops_match_batch_route(fastpath, dna_10k):
    table = native.sais(dna_10k)
    handle = native.BoundsHandle(dna_10k, table)
    assert handle._ext is not None
    queries = ([dna_10k[i:i + 7] for i in range(0, 2000, 61)]
               + [b"", b"zzz", b"C", dna_10k[-4:], dna_10k[:40]])
    starts, counts = native.bounds_batch(dna_10k, table, queries)
    for q, s, c in zip(queries, starts, counts):
        assert handle._ext.bounds(q) == (s, c)
        assert handle.bounds_one(q) == (s, c)
        got = handle._ext.positions(q)
        assert got.dtype == np.uint32 and not got.flags.writeable
        assert np.array_equal(got, table[s:s + c])
        assert handle._ext.contains(q) == (c > 0)
        assert handle._ext.count(q) == c
        expected_any = int(table[s]) if c else None
        assert handle._ext.any_position(q) == expected_any


def test_ctypes_route_matches_extension(monkeypatch, dna_10k):
    """BoundsHandle without the extension: the ctypes bounds_one."""
    table = native.sais(dna_10k)
    with_ext = native.BoundsHandle(dna_10k, table)
    monkeypatch.setattr(native, "_load_fastpath", lambda: None)
    plain = native.BoundsHandle(dna_10k, table)
    assert plain._ext is None and plain.bench_c_only(b"AC") is None
    assert np.array_equal(native.sais(dna_10k), table)  # ctypes sais
    for q in [dna_10k[5:19], b"", "GATC", b"\xff", dna_10k[:60]]:
        assert plain.bounds_one(q) == with_ext.bounds_one(q)


def test_fastpath_positions_view_outlives_handle(fastpath):
    text = b"abracadabra"
    table = native.sais(text)
    handle = native.BoundsHandle(text, table)
    view = handle._ext.positions(b"a")
    expected = view.copy()
    del handle, table  # the view keeps the sa buffer alive (base ref)
    assert np.array_equal(view, expected)


def test_fastpath_query_coercion(fastpath):
    """The extension coerces str (UTF-8) and buffers in C, and rejects
    queries that are not bytes-like."""
    text = b"ab\xc3\xa9c"
    handle = native.BoundsHandle(text, native.sais(text))
    assert handle._ext.bounds("é") == handle._ext.bounds(b"\xc3\xa9")
    assert handle._ext.bounds(bytearray(b"ab")) == handle._ext.bounds(b"ab")
    assert handle._ext.bounds(memoryview(b"c")) == handle._ext.bounds(b"c")
    with pytest.raises(TypeError):
        handle._ext.bounds(123)
    assert handle.bench_c_only("ab", iters=1000) > 0
    assert handle.bench_c_only(b"ab", iters=1000, op="contains") > 0


def test_table_host_route_uses_ext_and_matches_device(dna_10k):
    table = SuffixTable.new(dna_10k, engine="native", device="cpu")
    table.query_route = "host"
    dev = SuffixTable.new(dna_10k, engine="native", device="cpu")
    dev.query_route = "device"
    for q in [dna_10k[100:114], b"", b"C", b"zzz", dna_10k[:30],
              dna_10k[-5:]]:
        assert np.array_equal(table.positions(q), dev.positions(q))
        assert table.contains(q) == dev.contains(q)
        assert table.count(q) == dev.count(q)
        assert table.any_position(q) == dev.any_position(q)
    # The host route binds the extension's methods; toggling the route
    # unbinds them, and the device route binds nothing.
    assert table.count.__self__ is table._host_handle._ext
    table.query_route = "device"
    assert "count" not in table.__dict__
    assert table.count(b"C") == dev.count(b"C")
    assert "count" not in table.__dict__
    table.query_route = "host"
    assert table.count(b"C") == dev.count(b"C")
    assert table.count.__self__ is table._host_handle._ext


# ------------------------------------------------------------------ build


def test_build_lands_in_build_dir(jnative, fastpath):
    build_dir = ROOT / "suffix_torch" / "_build"
    lib, ext = native.library_path(), native.extension_path()
    assert native.BUILD_DIR == build_dir
    assert lib.parent == build_dir and lib.exists()
    assert ext.parent == build_dir and ext.exists()
    assert pathlib.Path(fastpath.__file__) == ext
    assert fastpath.__name__ == "suffix_torch.native._fastpath"
    assert not list(native.CSRC.glob("*.so"))  # nothing beside the sources
    # Both packages' copies live in one process, each handle calling its
    # own library and extension.
    assert jnative.available() and jnative._load_fastpath() is not None
    assert jnative._load_fastpath() is not fastpath
    assert native._load()._name == str(lib)
    assert jnative._load()._name != native._load()._name
    assert (ctypes.cast(native._load().stpu_sais_u8, ctypes.c_void_p).value
            != ctypes.cast(jnative._load().stpu_sais_u8,
                           ctypes.c_void_p).value)


def test_sources_are_the_jax_packages(jnative):
    """Byte-for-byte copies: what keeps the two packages' outputs equal."""
    jax_csrc = pathlib.Path(jnative.__file__).parent / "csrc"
    for name in ("saistpu.cpp", "sais_core.h", "bounds_core.h",
                 "fastpath.cpp"):
        assert (native.CSRC / name).read_bytes() == \
            (jax_csrc / name).read_bytes(), name


def test_build_key_and_atomic_rename(monkeypatch, tmp_path):
    """Another host CPU (another expansion of -march=native) names
    another library; a build writes a temporary file and renames it."""
    path = native.library_path()
    monkeypatch.setattr(native, "_target", "-march=some-other-cpu")
    assert native.library_path() != path
    assert native.library_path().name.startswith("libsaistpu-")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    out = native.library_path()
    assert out.parent == tmp_path / "b"
    native._compile(native._SRC, out)
    assert out.exists()
    assert [p.name for p in out.parent.iterdir()] == [out.name]
    lib = ctypes.CDLL(str(out))
    assert hasattr(lib, "stpu_kasai_u8")


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "CXX", "no-such-compiler-xyz")
    with pytest.raises(native.NativeUnavailable, match="cannot run"):
        native._compile(native._SRC, tmp_path / "x.so")
    monkeypatch.setattr(native, "_target", None)
    with pytest.raises(native.NativeUnavailable, match="cannot run"):
        native.library_path()
