"""The port's staged bulk LCP ladder (``suffix_torch/ops/lcp.py``:
``_lcp_bulk`` and its stages) against the JAX package's
(``suffix_tpu/ops/lcp.py``) and Kasai, and the port's ``textgen`` against
the JAX package's.

The cases of ``tests/test_lcp.py`` (sparse repeats with
``LCP_SURV_CHUNKED`` set on both packages, the first stage alone, the text
class straight through ``_lcp_bulk``, the packed-window stage in
isolation) at sizes under 2^14 bytes: the same arrays and the same route
(bulk or Kasai) in both packages. JAX is imported by a fixture, so that
the CUDA leg (marker ``gpu``) runs on a machine without it:
``python -m pytest tests/test_torch_lcp_bulk.py -m gpu --noconftest``.
Tolerance: exact equality (every array is integer).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.ops import lcp as lcp_ops  # noqa: E402
from suffix_torch.ops import search2  # noqa: E402
from suffix_torch.ops.padding import PAD, bucket_size  # noqa: E402
from suffix_torch.utils import textgen  # noqa: E402


@pytest.fixture(scope="module")
def jax_mods():
    """(jax.numpy, suffix_tpu.ops.lcp, suffix_tpu.ops.search2,
    suffix_tpu.SuffixTable)."""
    jnp = pytest.importorskip("jax.numpy")
    import suffix_tpu
    from suffix_tpu.ops import lcp as jlcp
    from suffix_tpu.ops import search2 as js2

    return jnp, jlcp, js2, suffix_tpu.SuffixTable


def _spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)


def _padded(raw: bytes, table: np.ndarray):
    n = len(raw)
    n_pad = bucket_size(n)
    t = np.full(n_pad, PAD, np.int32)
    t[:n] = np.frombuffer(raw, np.uint8)
    tab = np.zeros(n_pad, np.int32)
    tab[:n] = table
    return t, tab


def sparse_repeats() -> bytes:
    """tests/test_lcp.py::test_bulk_engine_sparse_repeats at 16,000 bytes:
    6 doubled 24-byte blocks and one 210-byte repeat, 238 survivors (n/64
    is 250), LCPs past the packed stages' 198 bytes."""
    rng = np.random.default_rng(3)
    n = 16000
    base = rng.integers(0, 4, size=n, dtype=np.uint8) + 97
    for _ in range(6):
        src = int(rng.integers(0, n - 2048))
        dst = src + 24 + int(rng.integers(0, 64))
        base[dst:dst + 24] = base[src:src + 24]
    src = int(rng.integers(0, n - 4096))
    base[src + 310:src + 520] = base[src:src + 210]
    return base.tobytes()


def doubled_blocks(copies: int, filler: int) -> bytes:
    """Doubled random 24-byte DNA blocks between random capital fillers."""
    rng = np.random.default_rng(11)
    pieces = []
    for _ in range(copies):
        b = bytes(rng.integers(0, 4, size=24, dtype=np.uint8) + 97)
        f1 = bytes(rng.integers(0, 26, size=filler, dtype=np.uint8) + 65)
        f2 = bytes(rng.integers(0, 26, size=filler, dtype=np.uint8) + 65)
        pieces += [b, f1, b, f2]
    return b"".join(pieces)


CORPORA = {
    "sparse_repeats": sparse_repeats,
    "stage_a_only": lambda: doubled_blocks(60, 32),   # tests/test_lcp.py
    "doubled_300": lambda: doubled_blocks(10, 300),   # 70 survivors
}


def _routes(jax_mods, monkeypatch, raw: bytes, **consts):
    """``lcp_lens()`` in both packages with ``consts`` set on both LCP
    modules: equal arrays, equal to Kasai; returns the port's routes."""
    _, jlcp, _, JTable = jax_mods
    for mod in (lcp_ops, jlcp):
        for name, value in consts.items():
            monkeypatch.setattr(mod, name, value)
    routes, jroutes = [], []
    for mod, calls in ((lcp_ops, routes), (jlcp, jroutes)):
        _spy(monkeypatch, mod, "_lcp_bulk", calls)
        _spy(monkeypatch, mod, "_kasai_route", calls)
    port = SuffixTable.new(raw, device="cpu")
    got = port.lcp_lens()
    ref = JTable.new(raw)
    assert np.array_equal(got, ref.lcp_lens())
    assert routes == jroutes
    assert np.array_equal(got, lcp_ops.kasai_host(
        np.frombuffer(raw, np.uint8), port.table()))
    return routes


@pytest.mark.parametrize("name,route", [
    ("sparse_repeats", ["_lcp_bulk"]), ("doubled_300", ["_lcp_bulk"]),
    ("stage_a_only", ["_kasai_route"])])  # 425 survivors > n/64 = 105
def test_bulk_route_matches_jax(jax_mods, monkeypatch, name, route):
    """LCP_SURV_CHUNKED at 4 in both packages: survivors up to n/64 take
    the bulk ladder and no Kasai, more take Kasai."""
    assert _routes(jax_mods, monkeypatch, CORPORA[name](),
                   LCP_SURV_CHUNKED=4) == route


def test_bulk_budget_exhausted_falls_back(jax_mods, monkeypatch):
    """Lanes deeper than LCP_BULK_MAX_OFF: the ladder returns None and
    both packages take Kasai."""
    routes = _routes(jax_mods, monkeypatch, sparse_repeats(),
                     LCP_SURV_CHUNKED=4, LCP_BULK_MAX_OFF=128,
                     LCP_BULK_LADDER=(("rows", 128, 0),))
    assert routes == ["_lcp_bulk", "_kasai_route"]


def _both_bulk(jax_mods, raw: bytes, trace=None):
    """(port, JAX) ``_lcp_bulk`` on the same padded text and table."""
    jnp, jlcp, js2, _ = jax_mods
    n = len(raw)
    table = SuffixTable.new(raw, device="cpu").table()
    t, tab = _padded(raw, table)
    tt, ttab = torch.from_numpy(t), torch.from_numpy(tab)
    pk = search2.packed_keys_rank_order(tt, ttab, n)
    got = lcp_ops._lcp_bulk(tt, n, ttab, pk, trace=trace)
    jt, jtab = jnp.asarray(t), jnp.asarray(tab)
    want = jlcp._lcp_bulk(jt, n, jtab,
                          tuple(js2.packed_keys_rank_order(jt, jtab, n)))
    return got, want, table


def test_text_class_through_bulk(jax_mods):
    """tests/test_lcp.py::test_packed_bulk_on_text_class_parity at 2^13
    bytes: survivor-dense text straight through the ladder, every stage
    kind run."""
    arr = textgen.text_corpus(1 << 13, boilerplate_bytes=1024,
                              boilerplate_copies=3)
    trace = []
    got, want, table = _both_bulk(jax_mods, arr.tobytes(), trace)
    assert got is not None and want is not None
    assert np.array_equal(got, want)
    assert np.array_equal(got, lcp_ops.kasai_host(arr, table))
    assert trace[0]["stage"] == "base"
    assert {"packed", "rows"} <= {s["stage"] for s in trace}
    assert trace[-1]["left"] == 0


def test_stage_a_only_through_bulk(jax_mods):
    """tests/test_lcp.py::test_bulk_engine_stagea_only: shallow survivors
    only, the first packed stage resolves them all."""
    raw = doubled_blocks(60, 32)
    trace = []
    got, want, table = _both_bulk(jax_mods, raw, trace)
    assert np.array_equal(got, want)
    assert np.array_equal(got, lcp_ops.kasai_host(
        np.frombuffer(raw, np.uint8), table))
    assert [s["stage"] for s in trace] == ["base", "packed"]
    assert trace[1]["left"] == 0


def test_base_compact_matches_jax(jax_mods):
    jnp, jlcp, js2, _ = jax_mods
    raw = sparse_repeats()
    n = len(raw)
    t, tab = _padded(raw, SuffixTable.new(raw, device="cpu").table())
    ttab = torch.from_numpy(tab)
    pk = search2.packed_keys_rank_order(torch.from_numpy(t), ttab, n)
    a, b, lcp, flag, perm, num = lcp_ops._lcp_base_compact(ttab, n, pk)
    ja, jb, jl, jf, jperm, jnum = jlcp._lcp_base_compact(
        jnp.asarray(tab), jnp.int32(n),
        tuple(js2.packed_keys_rank_order(jnp.asarray(t), jnp.asarray(tab),
                                         n)))
    assert num == int(jnum) == int(flag.sum())
    # Rows are a unit: the same (rank -> row) map, whatever the order.
    order, jorder = perm.numpy(), np.asarray(jperm)
    for x, jx in ((a, ja), (b, jb), (lcp, jl)):
        want = np.empty_like(np.asarray(jx))
        want[jorder] = np.asarray(jx)
        got = np.empty_like(x.numpy())
        got[order] = x.numpy()
        assert np.array_equal(got, want)
    assert sorted(order[:num].tolist()) == sorted(jorder[:num].tolist())


def test_words3_and_packed_window_match_jax(jax_mods):
    jnp, jlcp, _, _ = jax_mods
    rng = np.random.default_rng(5)
    t = np.full(512, PAD, np.int32)
    t[:450] = rng.integers(0, 256, 450)
    tw = lcp_ops._text_words3(torch.from_numpy(t))
    jtw = jlcp._text_words3(jnp.asarray(t))
    assert np.array_equal(tw.numpy(), np.asarray(jtw))
    base = rng.integers(0, 520, 300).astype(np.int32)
    for s_syms in (6, 15, 45):
        got = lcp_ops._packed_window(tw, torch.from_numpy(base), s_syms)
        want = jlcp._packed_window(jtw, jnp.asarray(base), s_syms)
        assert np.array_equal(got.numpy(), np.asarray(want)), s_syms


@pytest.mark.parametrize("trial", range(6))
def test_packed_window_stage(jax_mods, trial):
    """tests/test_lcp.py::test_packed_window_stage_parity: every pair
    active from lcp 0, every phase alignment, end-of-text boundaries."""
    jnp, jlcp, _, _ = jax_mods
    rng = np.random.default_rng(9 + 100 * trial)
    n = int(rng.integers(64, 900))
    arr = rng.integers(0, 3, size=n, dtype=np.uint8) + 97
    sa = SuffixTable.new(arr.tobytes(), device="cpu").table()
    n_pad = bucket_size(n)
    t = np.full((n_pad,), PAD, np.int32)
    t[:n] = arr
    a = np.zeros((n_pad,), np.int32)
    b = np.zeros((n_pad,), np.int32)
    a[1:n] = sa[1:n]
    b[1:n] = sa[:n - 1]
    flag = np.zeros((n_pad,), np.int32)
    flag[1:n] = 1
    s_syms = int(rng.choice([6, 15, 45]))
    lcp, fl, left = lcp_ops._bulk_refine_packed(
        lcp_ops._text_words3(torch.from_numpy(t)), n, torch.from_numpy(a),
        torch.from_numpy(b), torch.zeros(n_pad, dtype=torch.int32),
        torch.from_numpy(flag.astype(bool)), n_pad, s_syms,
        row_block=n_pad, max_rounds=4096)
    jl, jf, jleft = jlcp._bulk_refine_packed(
        jlcp._text_words3(jnp.asarray(t)), jnp.int32(n), jnp.asarray(a),
        jnp.asarray(b), jnp.zeros(n_pad, jnp.int32), jnp.asarray(flag),
        n_pad, s_syms, row_block=n_pad, max_rounds=4096)
    assert left == int(jleft) == 0
    assert np.array_equal(lcp.numpy(), np.asarray(jl))
    assert np.array_equal(fl.numpy().astype(np.int32), np.asarray(jf))
    assert np.array_equal(lcp.numpy()[1:n],
                          lcp_ops.kasai_host(arr, sa)[1:n].astype(np.int32))


@pytest.mark.parametrize("n,w,row_block,rounds", [
    (900, 128, 256, 2), (1024, 256, 512, 1), (1500, 2048, 1024, 3)],
    ids=["unaligned", "aligned_blocks", "wide"])
def test_rows_stage_matches_jax(jax_mods, n, w, row_block, rounds):
    """The row stage on every adjacent pair, round-capped, over a text
    with long repeats; unaligned pads take element gathers."""
    jnp, jlcp, _, _ = jax_mods
    rng = np.random.default_rng(n)
    arr = rng.integers(0, 2, size=n, dtype=np.uint8) + 97
    arr[n // 2:n // 2 + 300] = arr[:300]
    sa = SuffixTable.new(arr.tobytes(), device="cpu").table()
    n_pad = bucket_size(n)
    t = np.full((n_pad if n != 900 else 900 + 60,), PAD, np.int32)
    t[:n] = arr
    a = np.zeros((n_pad,), np.int32)
    b = np.zeros((n_pad,), np.int32)
    a[1:n] = sa[1:n]
    b[1:n] = sa[:n - 1]
    flag = np.zeros((n_pad,), np.int32)
    flag[1:n] = 1
    lcp0 = rng.integers(0, 3, n_pad).astype(np.int32) * flag
    lcp, fl, left = lcp_ops._bulk_refine_prefix(
        torch.from_numpy(t), n, torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(lcp0.copy()), torch.from_numpy(flag.astype(bool)),
        n_pad, w, row_block, rounds)
    jl, jf, jleft = jlcp._bulk_refine_prefix(
        jnp.asarray(t), jnp.int32(n), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(lcp0), jnp.asarray(flag), n_pad, w, row_block, rounds)
    assert left == int(jleft)
    assert np.array_equal(lcp.numpy(), np.asarray(jl))
    assert np.array_equal(fl.numpy().astype(np.int32), np.asarray(jf))


def test_finish_and_compact(jax_mods):
    jnp, jlcp, _, _ = jax_mods
    rng = np.random.default_rng(4)
    n_pad = 64
    perm = rng.permutation(n_pad)
    lcp = rng.integers(0, 50, n_pad).astype(np.int32)
    got = lcp_ops._bulk_finish(torch.from_numpy(lcp),
                               torch.from_numpy(perm), 50)
    want = jlcp._bulk_finish(jnp.asarray(lcp), jnp.asarray(perm.astype(
        np.int32)), jnp.int32(50))
    assert np.array_equal(got.numpy(), np.asarray(want))
    cols = [torch.from_numpy(rng.integers(0, 99, n_pad).astype(np.int32))
            for _ in range(3)]
    flag = torch.from_numpy(rng.random(n_pad) < 0.3)
    rows = list(zip(*(c.tolist() for c in cols), flag.tolist(),
                      perm.tolist()))
    p = torch.from_numpy(perm.copy())
    lcp_ops._bulk_compact_prefix(*cols, flag, p, 32)
    live = sum(r[3] for r in rows[:32])
    assert flag[:live].all() and not flag[live:32].any()
    moved = list(zip(*(c.tolist() for c in cols), flag.tolist(), p.tolist()))
    assert sorted(moved[:32]) == sorted(rows[:32])
    assert moved[32:] == rows[32:]


@pytest.mark.parametrize("seed", [0x3E77, 12345])
def test_textgen_matches_jax(seed):
    from suffix_tpu.utils import textgen as jtextgen

    got = textgen.text_corpus(1 << 16, seed=seed)
    want = jtextgen.text_corpus(1 << 16, seed=seed)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert textgen.corpus_stats(got) == jtextgen.corpus_stats(want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sparse_repeats", "doubled_300"])
def test_cuda_bulk_matches_cpu(cuda_device, monkeypatch, name):
    monkeypatch.setattr(lcp_ops, "LCP_SURV_CHUNKED", 4)
    calls = []
    _spy(monkeypatch, lcp_ops, "_lcp_bulk", calls)
    _spy(monkeypatch, lcp_ops, "_kasai_route", calls)
    raw = CORPORA[name]()
    got = SuffixTable.new(raw, device=cuda_device).lcp_lens()
    assert calls == ["_lcp_bulk"]
    assert np.array_equal(got, SuffixTable.new(raw, device="cpu").lcp_lens())
