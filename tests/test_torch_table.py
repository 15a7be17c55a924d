"""The port's slice end to end: ``suffix_torch.SuffixTable`` against
``suffix_tpu.SuffixTable`` (SA-IS build, device query route), checkpoint
cross-load, the no-silent-CPU rule and the import boundary.
Tolerance: exact equality.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

import suffix_tpu  # noqa: E402
from suffix_tpu.utils import checkpoint as jax_checkpoint  # noqa: E402
from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.utils import checkpoint  # noqa: E402
from suffix_torch.utils.verify import verify_suffix_array  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _batch(text: bytes, rng: np.random.Generator) -> list[bytes]:
    n = len(text)
    qs = [text[s:s + m] for m in (1, 2, 5, 14, 20, 40)
          for s in rng.integers(0, n - m, size=20)]
    qs += [bytes(rng.integers(97, 123, size=m, dtype=np.uint8))
           for m in (3, 8, 14)]
    return qs + [b"", b"ACGT" * 12, text[-7:], text[:25]]


@pytest.fixture(scope="module")
def pair(dna_10k):
    port = SuffixTable.new(dna_10k, engine="sais", device="cpu")
    ref = suffix_tpu.SuffixTable.new(dna_10k, engine="sais")
    ref.query_route = "device"
    return port, ref


def test_table_and_batch_queries_match_jax(pair, rng):
    port, ref = pair
    assert np.array_equal(port.table(), ref.table())
    assert port.table().dtype == np.uint32
    queries = _batch(port.text_bytes(), rng)
    got, want = port.positions_batch(queries), ref.positions_batch(queries)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)  # same SA-slice order
    assert np.array_equal(port.count_batch(queries), ref.count_batch(queries))
    assert np.array_equal(port.contains_batch(queries),
                          ref.contains_batch(queries))


def test_single_queries_match_jax(pair, rng):
    port, ref = pair
    for q in _batch(port.text_bytes(), rng)[::7]:
        assert port.count(q) == ref.count(q)
        assert port.contains(q) == ref.contains(q)
        assert port.any_position(q) == ref.any_position(q)
        assert np.array_equal(port.positions(q), ref.positions(q))


def test_chunked_batches_match_unchunked(pair, rng):
    port, _ = pair
    queries = _batch(port.text_bytes(), rng)
    small = SuffixTable.from_parts(port.text(), port.table(), device="cpu")
    small.MAX_QUERY_BATCH = 16
    assert np.array_equal(small.count_batch(queries),
                          port.count_batch(queries))


@pytest.mark.parametrize("text", ["banana", "☃abc☃", "", "the quick brown fox was quick."])
def test_repr_and_accessors_match_jax(text):
    port = SuffixTable.new(text, device="cpu")
    ref = suffix_tpu.SuffixTable.new(text)
    assert repr(port) == repr(ref)
    assert port.len() == ref.len() and port.is_empty() == ref.is_empty()
    assert port.text() == ref.text() and port.text_bytes() == ref.text_bytes()
    for i in range(len(port)):
        assert _outcome(port.suffix, i) == _outcome(ref.suffix, i)
        assert port.suffix_bytes(i) == ref.suffix_bytes(i)


def _outcome(fn, *args):
    """fn's result, or its exception type (a str suffix that starts inside
    a UTF-8 sequence does not decode, in either package)."""
    try:
        return fn(*args)
    except UnicodeDecodeError as e:
        return type(e)


@pytest.mark.parametrize("text", [b"", b"a" * 40, b"\x00\xff" * 9])
def test_degenerate_texts_match_jax(text):
    queries = [b"a" * k for k in (0, 1, 18, 19, 36, 37, 40, 41)]
    queries += [b"\x00", b"\xff\x00" * 10, b"\x00\xff" * 9]
    port = SuffixTable.new(text, device="cpu")
    ref = suffix_tpu.SuffixTable.new(text, engine="sais")
    ref.query_route = "device"
    assert np.array_equal(port.table(), ref.table())
    assert np.array_equal(port.count_batch(queries), ref.count_batch(queries))
    assert port.count_batch([]).shape == (0,)


def test_snowman_byte_offsets():
    st = SuffixTable.new("☃abc☃", device="cpu")
    assert sorted(st.positions("☃").tolist()) == [0, 6]
    assert st.positions("").tolist() == [] and not st.contains("")
    assert st.any_position("zz") is None


def test_parts_round_trip_and_naive():
    st = SuffixTable.new("mississippi", device="cpu")
    text, table = st.into_parts()
    back = SuffixTable.from_parts(text, table, device="cpu")
    assert back == st and hash(back) == hash(st)
    assert SuffixTable.new_naive("mississippi", device="cpu") == st
    with pytest.raises(ValueError, match="unknown engine: 'naive'"):
        SuffixTable.new("mississippi", engine="naive", device="cpu")
    with pytest.raises(ValueError, match="unknown engine: 'naive'"):
        suffix_tpu.SuffixTable.new("mississippi", engine="naive")
    with pytest.raises(ValueError):
        SuffixTable.from_parts("abc", np.array([0, 1], np.uint32),
                               device="cpu")


def test_collect_stats():
    """The SA-IS build's stats follow the JAX package's schema: the same
    keys and values but for the timings (the SA-IS round counters stay
    in ``ops/sais.py``'s own ``stats``, tests/test_torch_sais.py)."""
    text = b"abaabababbabbb" * 8
    st = SuffixTable.new(text, engine="sais", device="cpu",
                         collect_stats=True)
    stats = st.build_stats
    assert stats["engine"] == "sais-device" and stats["device"] == "cpu"
    assert stats["n_bytes"] == 112 and stats["recursion_depth"] >= 1
    want = suffix_tpu.SuffixTable.new(text, engine="sais",
                                      collect_stats=True).build_stats
    timing = ("elapsed_s", "bytes_per_s")
    assert ({k: v for k, v in stats.items() if k not in timing}
            == {k: v for k, v in want.items() if k not in timing})


def test_checkpoint_cross_load(tmp_path, dna_10k, rng):
    queries = _batch(dna_10k, rng)
    ref = suffix_tpu.SuffixTable.new(dna_10k, engine="sais")
    ref.query_route = "device"
    a = str(tmp_path / "from_jax.npz")
    jax_checkpoint.save_index(a, ref, build_stats={"engine": "sais-device"})
    port = checkpoint.load_index(a, device="cpu")
    assert port.build_stats == {"engine": "sais-device"}
    assert np.array_equal(port.table(), ref.table())
    assert np.array_equal(port.count_batch(queries), ref.count_batch(queries))

    b = str(tmp_path / "from_torch.npz")
    checkpoint.save_index(b, SuffixTable.new("☃abc☃", device="cpu"),
                          build_stats={"n_bytes": 8})
    back = jax_checkpoint.load_index(b)
    assert back.text() == "☃abc☃" and back.build_stats == {"n_bytes": 8}
    assert back.positions("☃").tolist() == \
        SuffixTable.new("☃abc☃", device="cpu").positions("☃").tolist()


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SuffixTable.new("x")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SuffixTable.from_parts("x", np.zeros(1, np.uint32))


def _near_periodic() -> bytes:
    """A 1000-byte period with two defects over 2^17 bytes: both packages
    send it to their patched engines."""
    rng = np.random.default_rng(11)
    block = rng.integers(0, 26, 1000, dtype=np.uint8) + 97
    arr = np.tile(block, 132)[:(1 << 17) + 500].copy()
    arr[50_000] ^= 1
    return arr.tobytes()


@pytest.mark.parametrize("engine", ["device", "native", "auto"])
def test_unported_engines_raise(engine):
    """Each engine builds the patched route's corpus as the JAX package
    does, with its label: "device" the patched route, "native" and "auto"
    (2^17 bytes, under AUTO_NATIVE_MAX) the native SA-IS."""
    text = _near_periodic()
    st = SuffixTable.new(text, engine=engine, device="cpu",
                         collect_stats=True)
    ref = suffix_tpu.SuffixTable.new(text, engine=engine, collect_stats=True)
    assert st.build_stats["engine"] == ref.build_stats["engine"]
    if engine == "device":
        assert st.build_stats["engine"].startswith("patched(q=1000,")
    else:
        assert st.build_stats["engine"] == "native-sais"
    assert np.array_equal(st.table(), ref.table())


def test_keyless_size_raises():
    """Past FLAT_KEYS_MAX_PAD: formerly a raise; now the keyless routes
    answer, as the JAX package's do."""
    text = "banana" * 700  # past 2^12 padded bytes: a strided index
    st = SuffixTable.new(text, device="cpu")
    st.FLAT_KEYS_MAX_PAD = 16
    ref = suffix_tpu.SuffixTable.new(text)
    ref.query_route = "device"
    ref.FLAT_KEYS_MAX_PAD = 16
    queries = ["ana", "banana" * 7, "nab" * 15, "x", "a" * 30, ""]
    assert np.array_equal(st.count_batch(queries), ref.count_batch(queries))
    assert st._pk is None and st._ext_block is not None
    assert st.count("ana") == 1400


def test_certificate(dna_10k):
    st = SuffixTable.new(dna_10k[:3000], device="cpu")
    assert verify_suffix_array(st.text_bytes(), st.table())
    bad = st.table().copy()
    bad[[10, 11]] = bad[[11, 10]]
    assert not verify_suffix_array(st.text_bytes(), bad)


def test_import_pulls_in_no_jax():
    code = ("import sys, suffix_torch, suffix_torch.utils.checkpoint, "
            "suffix_torch.utils.verify, suffix_torch.ops.naive, "
            "suffix_torch.ops.patched, suffix_torch.ops.lcp, "
            "suffix_torch.ops.search2, suffix_torch.utils.textgen, "
            "suffix_torch.native, suffix_torch.utils.metrics, "
            "suffix_torch.cli, suffix_torch.serve, suffix_torch.multidoc, "
            "suffix_torch.tree, suffix_torch.tree.atree, "
            "suffix_torch.utils.config, suffix_torch.utils.profiling, "
            "suffix_torch.utils.warmup, suffix_torch.examples.basic\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'suffix_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import_in_port_sources():
    # _build/ holds build outputs (git-ignored), not sources of the port.
    files = sorted(p for p in (ROOT / "suffix_torch").rglob("*.py")
                   if "_build" not in p.relative_to(ROOT).parts) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 5
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "suffix_tpu"), \
                (path, name)
