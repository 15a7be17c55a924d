"""The port's LCP (``suffix_torch/ops/lcp.py``, ``SuffixTable.lcp_lens``)
against the JAX package's (``suffix_tpu/ops/lcp.py``), the quadratic
reference definition and Kasai.

``lcp_from_sa`` takes the same route as JAX's on the corpora of
``tests/test_lcp.py`` that stay off the bulk arm, with and without the
table's packed keys; ``_lcp_keyed``, ``_lcp_padded``, ``_survivor_count``,
the rank-order keys and the sampled census are held against their JAX
counterparts on the same inputs; the bulk arm's own battery is
``tests/test_torch_lcp_bulk.py``. JAX is imported by a fixture, so that
the CUDA legs (marker
``gpu``) run on a machine without it:
``python -m pytest tests/test_torch_lcp.py -m gpu --noconftest``.
Tolerance: exact equality (integer arrays; the sampled rate is the same
float from the same samples).
"""

import hashlib
import pathlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.ops import lcp as lcp_ops  # noqa: E402
from suffix_torch.ops import search2  # noqa: E402
from suffix_torch.ops.padding import PAD, bucket_size  # noqa: E402
from suffix_torch.utils import checkpoint  # noqa: E402

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
GOLDEN_LCP = {  # tests/test_golden.py
    "AP009048_10000":
        "427e0d914a5e7c62d4b06e9b360ced03da1889f4c3fc488169e3faf83d29be57",
    "AP009048_100000":
        "10992fb21e4db240c0024acd3661b1a3af997c0fb7a1591352a89e3e1aba373d",
}


@pytest.fixture(scope="module")
def jax_mods():
    """(jax.numpy, suffix_tpu.ops.lcp, suffix_tpu.ops.search2,
    suffix_tpu.SuffixTable)."""
    jnp = pytest.importorskip("jax.numpy")
    import suffix_tpu
    from suffix_tpu.ops import lcp as jlcp
    from suffix_tpu.ops import search2 as js2

    return jnp, jlcp, js2, suffix_tpu.SuffixTable


def quadratic_lcp(text: bytes, table: np.ndarray) -> np.ndarray:
    """The reference definition (src/table.rs:348-365)."""
    out = np.zeros(len(table), dtype=np.uint32)
    for i in range(len(table) - 1):
        a, b = text[int(table[i]):], text[int(table[i + 1]):]
        k = 0
        for ca, cb in zip(a, b):
            if ca != cb:
                break
            k += 1
        out[i + 1] = k
    return out


def _cpu(text) -> SuffixTable:
    return SuffixTable.new(text, device="cpu")


def _padded(raw: bytes, table: np.ndarray):
    n = len(raw)
    n_pad = bucket_size(n)
    t = np.full(n_pad, PAD, np.int32)
    t[:n] = np.frombuffer(raw, np.uint8)
    tab = np.zeros(n_pad, np.int32)
    tab[:n] = table
    return t, tab


@pytest.mark.parametrize("name", sorted(GOLDEN_LCP))
def test_golden_lcp(name):
    st_ = _cpu((FIXTURES / f"{name}.fasta").read_bytes())
    lcp = st_.lcp_lens()
    assert lcp.dtype == np.uint32
    assert hashlib.sha256(lcp.tobytes()).hexdigest() == GOLDEN_LCP[name]


DIRECTED = ["banana", "mississippi", "", "a", "aa", "aaaaaaaaab", "☃abc☃",
            "the quick brown fox was quick.", "a" * 700, "ab" * 400]


@pytest.mark.parametrize("text", DIRECTED, ids=lambda t: repr(t)[:16])
def test_directed_matches_jax_and_definition(jax_mods, text):
    st_ = _cpu(text)
    want = quadratic_lcp(st_.text_bytes(), st_.table())
    for method in ("auto", "device", "kasai"):
        assert np.array_equal(st_.lcp_lens(method=method), want), method
    assert np.array_equal(st_.lcp_lens(), jax_mods[3].new(text).lcp_lens())


@settings(max_examples=80, deadline=None)
@given(st.binary(max_size=64))
def test_prop_lcp_bytes(b):
    st_ = _cpu(b)
    assert np.array_equal(st_.lcp_lens(), quadratic_lcp(b, st_.table()))


@settings(max_examples=60, deadline=None)
@given(st.text(max_size=48))
def test_prop_lcp_text(s):
    st_ = _cpu(s)
    assert np.array_equal(st_.lcp_lens(),
                          quadratic_lcp(st_.text_bytes(), st_.table()))


def _budget_corpus() -> bytes:
    """tests/test_lcp.py: two copies of a 1 KiB block, LCPs up to 1 KiB."""
    rng = np.random.default_rng(7)
    blk = rng.integers(0, 4, size=1024, dtype=np.uint8) + 97
    filler = rng.integers(0, 26, size=8192, dtype=np.uint8) + 65
    return (bytes(filler[:4096]) + bytes(blk) + bytes(filler[4096:])
            + bytes(blk))


LCP_CORPORA = {
    "dna_10k": lambda: (FIXTURES / "AP009048_10000.fasta").read_bytes(),
    "fixture_100k": lambda: (FIXTURES / "AP009048_100000.fasta").read_bytes(),
    "repetitive": lambda: b"abracadabra-zyx!" * 512,  # survivors ~ n: Kasai
    "deep_pairs": _budget_corpus,
    "random_bytes": lambda: np.random.default_rng(9).integers(
        0, 256, 20000, dtype=np.uint8).tobytes(),
}


def _spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("max_off", [8192, 256])
@pytest.mark.parametrize("with_pk", [False, True], ids=["no_pk", "pk"])
@pytest.mark.parametrize("name", sorted(LCP_CORPORA))
def test_lcp_from_sa_matches_jax(jax_mods, monkeypatch, name, with_pk,
                                 max_off):
    """Same array and same route (keyed refine or Kasai) in both
    packages; a 256-byte budget sends deep pairs to Kasai in both."""
    _, jlcp, _, JTable = jax_mods
    raw = LCP_CORPORA[name]()
    port, ref = _cpu(raw), JTable.new(raw)
    ref.query_route = "device"
    if with_pk:
        port.count(b"a")
        ref.count(b"a")
    for mod in (lcp_ops, jlcp):
        monkeypatch.setattr(mod, "LCP_MAX_OFF", max_off)
    routes, jroutes = [], []
    _spy(monkeypatch, lcp_ops, "_kasai_route", routes)
    _spy(monkeypatch, jlcp, "_kasai_route", jroutes)
    got = port.lcp_lens()
    assert np.array_equal(got, ref.lcp_lens())
    assert routes == jroutes
    assert np.array_equal(got, lcp_ops.kasai_host(
        np.frombuffer(raw, np.uint8), port.table()))


@pytest.mark.parametrize("max_off", [0, 256])
@pytest.mark.parametrize("name", ["dna_10k", "repetitive", "deep_pairs"])
def test_lcp_keyed_matches_jax(jax_mods, name, max_off):
    jnp, jlcp, js2, _ = jax_mods
    raw = LCP_CORPORA[name]()
    n = len(raw)
    table = _cpu(raw).table()
    t, tab = _padded(raw, table)
    pk = search2.packed_keys_rank_order(torch.from_numpy(t),
                                        torch.from_numpy(tab), n)
    jpk = js2.packed_keys_rank_order(jnp.asarray(t), jnp.asarray(tab), n)
    for w, jw in zip(pk, jpk):
        assert np.array_equal(w.numpy(), np.asarray(jw))
    got, unresolved = lcp_ops._lcp_keyed(torch.from_numpy(t), n,
                                         torch.from_numpy(tab), n, pk,
                                         max_off=max_off)
    want, j_unres = jlcp._lcp_keyed(jnp.asarray(t), jnp.int32(n),
                                    jnp.asarray(tab), jnp.int32(n),
                                    tuple(jpk), max_off=max_off)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert unresolved == int(j_unres)
    assert lcp_ops._survivor_count(pk, n) == int(
        jlcp._survivor_count(tuple(jpk), jnp.int32(n)))


@pytest.mark.parametrize("text", [b"banana", b"a" * 300, b"abcab" * 70])
def test_lcp_padded_matches_jax(jax_mods, text):
    jnp, jlcp, _, _ = jax_mods
    n = len(text)
    t, tab = _padded(text, _cpu(text).table())
    got = lcp_ops._lcp_padded(torch.from_numpy(t), n, torch.from_numpy(tab),
                              n)
    want = jlcp._lcp_padded(jnp.asarray(t), jnp.int32(n), jnp.asarray(tab),
                            jnp.int32(n))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_rank_order_keys_match_query_index_and_jax(jax_mods, dna_10k):
    jnp, _, js2, _ = jax_mods
    n = len(dna_10k)
    t, tab = _padded(dna_10k, _cpu(dna_10k).table())
    tt, ttab = torch.from_numpy(t), torch.from_numpy(tab)
    isa = search2._isa_padded(ttab, n)
    assert np.array_equal(isa.numpy(), np.asarray(
        js2._isa_padded(jnp.asarray(tab), jnp.int32(n))))
    keys = search2.packed_keys_rank_order(tt, ttab, n)
    flat, _, _ = search2.build_query_index(tt, ttab, n)
    assert len(keys) == search2.KEY_WORDS
    for a, b in zip(keys, flat):
        assert torch.equal(a, b)


def test_kasai_host_matches_jax(jax_mods, dna_10k):
    _, jlcp, _, _ = jax_mods
    for raw in (dna_10k[:3000], b"mississippi", b"", b"zzzz"):
        table = _cpu(raw).table()
        arr = np.frombuffer(raw, np.uint8)
        got = lcp_ops.kasai_host(arr, table)
        assert np.array_equal(got, jlcp.kasai_host(arr, table))
        assert np.array_equal(got, quadratic_lcp(raw, table))


def test_sampled_rate_matches_jax(jax_mods):
    _, jlcp, _, _ = jax_mods
    rng = np.random.default_rng(2)
    for arr in (np.tile(np.frombuffer(b"abcdefgh" * 4, np.uint8), 2000),
                rng.integers(0, 256, size=1 << 16, dtype=np.uint8),
                rng.integers(0, 4, size=1 << 16, dtype=np.uint8) + 97):
        table = _cpu(arr.tobytes()).table()
        got = lcp_ops._sampled_survivor_rate(arr, table)
        assert got == jlcp._sampled_survivor_rate(arr, table)


def test_sampled_dense_short_circuit(monkeypatch):
    """>= 2^20 survivor-dense bytes without keys go to Kasai from the
    host census, before any device staging."""
    text = b"abracadabra-zyx!" * (1 << 16)
    table = _cpu(text).table()

    def boom(*a, **k):
        raise AssertionError("the exact census ran")

    monkeypatch.setattr(lcp_ops, "_survivor_count", boom)
    monkeypatch.setattr(lcp_ops, "_kasai_route", lambda t, sa: "kasai")
    assert lcp_ops.lcp_from_sa(np.frombuffer(text, np.uint8), table,
                               device="cpu") == "kasai"


def test_bulk_arm_raises(jax_mods, monkeypatch):
    """Survivors in (LCP_SURV_CHUNKED, n/64]: formerly the port raised
    here; now both packages take their bulk ladders, and the arrays are
    equal."""
    _, jlcp, _, JTable = jax_mods
    rng = np.random.default_rng(11)
    pieces = []
    for _ in range(10):  # doubled 24-byte blocks: 70 survivors, n/64 = 101
        b = bytes(rng.integers(0, 4, size=24, dtype=np.uint8) + 97)
        f1 = bytes(rng.integers(0, 26, size=300, dtype=np.uint8) + 65)
        f2 = bytes(rng.integers(0, 26, size=300, dtype=np.uint8) + 65)
        pieces += [b, f1, b, f2]
    text = b"".join(pieces)
    for mod in (lcp_ops, jlcp):
        monkeypatch.setattr(mod, "LCP_SURV_CHUNKED", 4)
    bulk, jbulk = [], []
    _spy(monkeypatch, lcp_ops, "_lcp_bulk", bulk)
    _spy(monkeypatch, jlcp, "_lcp_bulk", jbulk)
    port = _cpu(text)
    got = port.lcp_lens()
    assert np.array_equal(got, JTable.new(text).lcp_lens())
    assert bulk and jbulk
    assert np.array_equal(got, quadratic_lcp(text, port.table()))


def test_lcp_methods(jax_mods):
    st_ = _cpu("banana")
    assert st_.lcp_lens().tolist() == [0, 1, 3, 0, 0, 2]
    ref = jax_mods[3].new("banana")
    assert np.array_equal(st_.lcp_lens(method="native"),
                          ref.lcp_lens(method="native"))
    assert st_.lcp_lens(method="native").dtype == np.uint32
    with pytest.raises(ValueError):
        st_.lcp_lens(method="bogus")
    with pytest.raises(ValueError):
        lcp_ops.lcp_from_sa(np.frombuffer(b"ab", np.uint8),
                            st_.table()[:2], method="bogus", device="cpu")


def test_checkpoint_lcp_cross_load(jax_mods, tmp_path, dna_10k):
    from suffix_tpu.utils import checkpoint as jax_checkpoint

    port = _cpu(dna_10k)
    lcp = port.lcp_lens()
    a = str(tmp_path / "from_torch.npz")
    checkpoint.save_index(a, port, lcp=lcp)
    back = jax_checkpoint.load_index(a)
    assert np.array_equal(back.table(), port.table())
    assert np.array_equal(back.lcp_lens(), lcp)
    with np.load(a) as z:
        assert z["lcp"].dtype == np.uint32 and np.array_equal(z["lcp"], lcp)

    ref = jax_mods[3].new(dna_10k)
    b = str(tmp_path / "from_jax.npz")
    jax_checkpoint.save_index(b, ref, lcp=ref.lcp_lens())
    loaded = checkpoint.load_index(b, device="cpu")
    assert loaded == port
    with np.load(b) as z:
        assert np.array_equal(z["lcp"], lcp)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("text", [
    b"banana-mississippi" * 300, b"abracadabra-zyx!" * 512,
    (np.random.default_rng(1).integers(0, 4, 1 << 17, dtype=np.uint8)
     + 97).tobytes()], ids=["ladder", "repetitive", "dna128k"])
def test_cuda_lcp_matches_cpu(cuda_device, text):
    st_ = SuffixTable.new(text, device=cuda_device)
    want = SuffixTable.new(text, device="cpu").lcp_lens()
    assert np.array_equal(st_.lcp_lens(), want)  # keys built for LCP
    st_.count(b"ab")
    assert np.array_equal(st_.lcp_lens(), want)  # the query index's keys
    assert np.array_equal(st_.lcp_lens(method="device"), want)
