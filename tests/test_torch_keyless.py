"""The port's keyless query routes (``suffix_torch/ops/search2.py``: the
deep keyless index and ``bounds_batch_merge_deep``, the lean build, and
``SuffixTable._ensure_device``'s three-way route) against the JAX
package's (``suffix_tpu/ops/search2.py``, ``suffix_tpu/table.py``).

The cases of ``tests/test_search2.py`` (huge index without flat keys, lean
build equal to the one-program build, the lean route through the public
entry, the warning, deep keyless parity over pattern lengths 1-90 on
repeat-heavy text), with the size gates lowered on both packages so that
indexes under 2^14 bytes take the huge-index routes: every (start, count)
equal to JAX's ``_bounds_batch`` on the same table. JAX is imported by a
fixture, so that the CUDA leg (marker ``gpu``) runs on a machine without
it: ``python -m pytest tests/test_torch_keyless.py -m gpu --noconftest``.
Tolerance: exact equality (every array is integer).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.ops import search2  # noqa: E402
from suffix_torch.ops.padding import PAD, bucket_size  # noqa: E402
from suffix_torch.ops.search import pack_queries  # noqa: E402


@pytest.fixture(scope="module")
def jax_mods():
    """(jax.numpy, suffix_tpu.ops.search2, suffix_tpu.SuffixTable)."""
    jnp = pytest.importorskip("jax.numpy")
    import suffix_tpu
    from suffix_tpu.ops import search2 as js2

    return jnp, js2, suffix_tpu.SuffixTable


@pytest.fixture
def gates(monkeypatch, jax_mods):
    """Set a size gate on both packages' table class or search2."""
    _, js2, JTable = jax_mods

    def set_gates(table=None, **search2_values):
        for cls in (SuffixTable, JTable):
            if table is not None:
                monkeypatch.setattr(cls, "FLAT_KEYS_MAX_PAD", table)
        for mod in (search2, js2):
            for name, value in search2_values.items():
                monkeypatch.setattr(mod, name, value)

    return set_gates


def _pair(jax_mods, text: bytes):
    """(port, JAX) tables of ``text``, the JAX one on its device route."""
    port = SuffixTable.new(text, device="cpu")
    ref = jax_mods[2].new(text)
    ref.query_route = "device"
    return port, ref


def _assert_bounds_equal(port, ref, queries) -> None:
    s_p, c_p = port._bounds_batch(queries)
    s_r, c_r = ref._bounds_batch(queries)
    assert np.array_equal(np.asarray(c_p), np.asarray(c_r))
    assert np.array_equal(np.asarray(s_p), np.asarray(s_r))


def _drawn(text: bytes, spans) -> list[bytes]:
    return [text[i:i + m] for i, m in spans] + [b"ZZZ", b"A", b""]


def repeat_heavy(dna_10k: bytes) -> bytes:
    """tests/test_search2.py: 6,000 DNA bytes with 8 planted copies of a
    300-byte block (deep equal ranges)."""
    rng = np.random.default_rng(0xDEE9)
    text = bytearray(dna_10k[:6000])
    blk = bytes(text[100:400])
    for at in rng.integers(0, 5000, size=8):
        text[at:at + 300] = blk
    return bytes(text)


def test_huge_index_route_no_flat_keys(jax_mods, gates, dna_10k):
    """Past FLAT_KEYS_MAX_PAD the index drops the flat keys (the deep
    keyless layout at this size); every pattern length answers as JAX's,
    and LCP rebuilds its keys."""
    text = dna_10k[:8192]
    gates(table=1 << 10)
    port, ref = _pair(jax_mods, text)
    port._ensure_device()
    ref._ensure_device()
    assert port._pk is None and port._pk_block is not None
    assert port._ext_block is not None and ref._ext_block is not None
    queries = _drawn(text, [(3, 2), (50, 14), (100, 19), (200, 30),
                            (400, 64)])
    _assert_bounds_equal(port, ref, queries)
    for q in queries:
        assert np.array_equal(port.positions(q), ref.positions(q)), q
    assert np.array_equal(port.lcp_lens(), ref.lcp_lens())


def test_keyless_build_matches_jax(jax_mods, dna_10k):
    jnp, js2, _ = jax_mods
    text = dna_10k[:5000]
    n = len(text)
    t, tab = _padded(text)
    for stride, ext in ((16, 6), (4, 0), (1, 0)):
        got = search2.build_query_index_keyless(
            torch.from_numpy(t), torch.from_numpy(tab), n, key_words=8,
            stride=stride, ext_words=ext)
        want = js2.build_query_index_keyless(
            jnp.asarray(t), jnp.asarray(tab), jnp.int32(n), key_words=8,
            stride=stride, ext_words=ext)
        for g_part, w_part in zip(got[1:], want[1:]):
            assert (g_part is None) == (w_part is None)
            if w_part is not None:
                assert np.array_equal(g_part.numpy(), np.asarray(w_part))
        assert len(got[0]) == len(want[0]) == 8
        for g, w in zip(got[0], want[0]):
            assert np.array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="blocked layout"):
        search2.build_query_index_keyless(
            torch.from_numpy(t), torch.from_numpy(tab), n, stride=1,
            ext_words=2)


def _padded(text: bytes):
    n = len(text)
    n_pad = bucket_size(n)
    t = np.full((n_pad,), PAD, np.int32)
    t[:n] = np.frombuffer(text, np.uint8)
    tab = np.zeros((n_pad,), np.int32)
    tab[:n] = SuffixTable.new(text, device="cpu").table()
    return t, tab


def test_lean_index_build_matches_monolithic(jax_mods, dna_10k):
    """The lean build's fences and blocks are bit-equal to the one-program
    with_keys=False build's, and to the JAX package's lean build."""
    jnp, js2, _ = jax_mods
    text = dna_10k[:5000]
    n = len(text)
    t, tab = _padded(text)
    tt, ttab = torch.from_numpy(t), torch.from_numpy(tab)
    pk, fence_a, blk_a = search2.build_query_index(tt, ttab, n,
                                                   with_keys=False)
    assert pk is None
    stride = blk_a.shape[1] // search2.KEY_WORDS
    none, fence_b, blk_b = search2._build_query_index_lean(
        tt, ttab, n, search2.KEY_WORDS, stride)
    assert none is None and torch.equal(blk_a, blk_b)
    _, fence_j, blk_j, _ = js2._build_query_index_lean(
        jnp.asarray(t), jnp.asarray(tab), jnp.int32(n), js2.KEY_WORDS,
        stride)
    assert np.array_equal(blk_b.numpy(), np.asarray(blk_j))
    for fa, fb, fj in zip(fence_a, fence_b, fence_j):
        assert torch.equal(fa, fb)
        assert np.array_equal(fb.numpy(), np.asarray(fj))
    # The flat keys' build gives the same fences and blocks.
    keys, fence_k, blk_k = search2.build_query_index(tt, ttab, n)
    assert len(keys) == search2.KEY_WORDS and torch.equal(blk_k, blk_a)
    for fa, fk in zip(fence_a, fence_k):
        assert torch.equal(fa, fk)


def test_lean_route_through_public_entry(jax_mods, gates, monkeypatch,
                                         dna_10k):
    """LEAN_MIN_PAD lowered: the public entry takes the lean build and
    serves JAX's bounds."""
    text = dna_10k[:8192]
    gates(table=1 << 9, LEAN_MIN_PAD=1 << 10)
    took_lean = []
    orig = search2._build_query_index_lean

    def spy(*a, **k):
        took_lean.append(True)
        return orig(*a, **k)

    monkeypatch.setattr(search2, "_build_query_index_lean", spy)
    port, ref = _pair(jax_mods, text)
    port._ensure_device()
    assert took_lean, "public entry did not route to the lean build"
    assert port._pk is None and port._ext_block is None
    queries = _drawn(text, [(3, 2), (50, 14), (100, 19), (200, 30)])
    _assert_bounds_equal(port, ref, queries)


def test_monolithic_route_past_lean_min_pad_warns(monkeypatch, dna_10k):
    text = dna_10k[:5000]
    t, tab = _padded(text)
    tt, ttab = torch.from_numpy(t), torch.from_numpy(tab)
    monkeypatch.setattr(search2, "LEAN_MIN_PAD", 1 << 10)
    with pytest.warns(RuntimeWarning, match="with_keys=False"):
        search2.build_query_index(tt, ttab, len(text), with_keys=True)
    with pytest.warns(RuntimeWarning, match="with_keys=False"):
        search2.build_query_index(tt, ttab, len(text), with_keys=False,
                                  stride=1)


def _deep_battery(text: bytes, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    queries = []
    for m in (1, 3, 8, 14, 18, 19, 24, 25, 36, 37, 40, 42, 43, 64, 90):
        for _ in range(6):
            s = int(rng.integers(0, len(text) - m))
            queries.append(text[s:s + m])
        queries.append(bytes(rng.integers(65, 91, size=m).tolist()))
    return queries


def test_deep_keyless_engine_parity(jax_mods, gates, dna_10k):
    """Every coverage tier (<= 24 B fences, 25-42 B ext probe, > 42 B byte
    tail) on repeat-heavy text: JAX's deep bounds, and the flat-key
    route's."""
    text = repeat_heavy(dna_10k)
    queries = _deep_battery(text, 0xDEE9)
    flat = SuffixTable.new(text, device="cpu")
    want = flat._bounds_batch(queries)
    gates(table=1 << 10)
    port, ref = _pair(jax_mods, text)
    _assert_bounds_equal(port, ref, queries)
    assert port._ext_block is not None
    got = port._bounds_batch(queries)
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[0], want[0])


def test_bounds_batch_merge_deep_matches_jax(jax_mods, dna_10k):
    """The engine alone on JAX's own index arrays, the long lanes mixed
    with short ones and padding rows."""
    jnp, js2, _ = jax_mods
    text = repeat_heavy(dna_10k)
    n = len(text)
    t, tab = _padded(text)
    queries = _deep_battery(text, 7)
    q, qlens = pack_queries(queries)
    fence, block, ext = js2.build_query_index_keyless(
        jnp.asarray(t), jnp.asarray(tab), jnp.int32(n), key_words=8,
        ext_words=6)
    n_long = int((qlens > 24).sum())
    n_deep = int((qlens > 42).sum())
    want = js2.bounds_batch_merge_deep(
        jnp.asarray(t), jnp.int32(n), jnp.asarray(tab), jnp.int32(n), fence,
        block, ext, jnp.asarray(q), jnp.asarray(qlens), q.shape[1],
        bucket_size(n_long, minimum=8), bucket_size(n_deep, minimum=8))
    got = search2.bounds_batch_merge_deep(
        torch.from_numpy(t), n, torch.from_numpy(tab), n,
        [torch.from_numpy(np.array(f)) for f in fence],
        torch.from_numpy(np.array(block)),
        torch.from_numpy(np.array(ext)), torch.from_numpy(q),
        torch.from_numpy(qlens), q.shape[1])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_ext_word_at_matches_jax(jax_mods):
    jnp, js2, _ = jax_mods
    rng = np.random.default_rng(3)
    block = rng.integers(0, 1 << 27, (8, 6 * 16)).astype(np.int32)
    ranks = rng.integers(0, 8 * 16, 50).astype(np.int32)
    for w in range(6):
        got = search2._ext_word_at(torch.from_numpy(block), 16,
                                   torch.from_numpy(ranks), w)
        want = js2._ext_word_at(jnp.asarray(block), 16, jnp.asarray(ranks),
                                w)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_refine_suffix_offset(dna_10k):
    """``_refine`` with ``sufi_off`` on query tails gives the bounds of
    the whole patterns inside a range exact through the offset."""
    text = repeat_heavy(dna_10k)
    n = len(text)
    t, tab = _padded(text)
    tt, ttab = torch.from_numpy(t), torch.from_numpy(tab)
    queries = [q for q in _deep_battery(text, 11) if len(q) > 24]
    q, qlens = pack_queries(queries)
    qt, lt = torch.from_numpy(q), torch.from_numpy(qlens)
    _, fence, block = search2.build_query_index(tt, ttab, n, key_words=8)
    start, end = search2._merge_bounds(fence, block, qt, lt, n)
    got = search2._refine(tt, n, ttab, qt[:, 24:], lt - 24, start, end,
                          sufi_off=24)
    want = search2._refine(tt, n, ttab, qt, lt, start, end)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("lean", [False, True], ids=["deep", "lean"])
def test_cuda_keyless_matches_cpu(cuda_device, monkeypatch, lean):
    # The fixture file directly: the CUDA legs run without conftest.py.
    text = repeat_heavy((pathlib.Path(__file__).resolve().parent / "fixtures"
                         / "AP009048_10000.fasta").read_bytes())
    queries = _deep_battery(text, 0xDEE9)
    want = SuffixTable.new(text, device="cpu")._bounds_batch(queries)
    monkeypatch.setattr(SuffixTable, "FLAT_KEYS_MAX_PAD", 1 << 10)
    if lean:
        monkeypatch.setattr(search2, "LEAN_MIN_PAD", 1 << 10)
    st_ = SuffixTable.new(text, device=cuda_device)
    got = st_._bounds_batch(queries)
    assert st_._pk is None and (st_._ext_block is None) == lean
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
