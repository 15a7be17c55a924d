"""The hybrid query route and the host build route of the port's
``SuffixTable`` against the JAX package's, and the host route against the
device route: the same bounds, the same unordered ``positions()`` slice
(src/table.rs:223-259), the same empty-query rejects. The cases of
``tests/test_hybrid.py``, plus the routing at HOST_QUERY_MAX and one past
it, the ``query_route`` setter, the lazy fields of fast-path tables and the
``engine="auto"`` labels on both sides of AUTO_NATIVE_MAX. JAX is imported
by a fixture, so the CUDA legs (marker ``gpu``) run without it:
``python -m pytest tests/test_torch_hybrid.py -m gpu --noconftest``.
Tolerance: exact equality.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable, native  # noqa: E402
from suffix_torch import table as table_mod  # noqa: E402

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"

QUERY_BATTERY = [
    "",  # the empty query matches nothing (tests/tests.rs:100-126)
    "a",
    "an",
    "ana",
    "nana",
    "banana",
    "bananaz",  # longer than any suffix match
    "zzz",  # above every suffix
    "\x00",  # below every suffix
    "b" * 100,  # longer than the text
]
OPS = ("positions", "contains", "count", "any_position")


@pytest.fixture(scope="module")
def JTable():
    pytest.importorskip("jax")
    import suffix_tpu

    return suffix_tpu.SuffixTable


def _routes(text):
    host = SuffixTable.new(text, engine="native", device="cpu")
    host.query_route = "host"
    dev = SuffixTable.new(text, device="cpu")
    dev.query_route = "device"
    return host, dev


def _answers(st, queries):
    return {op: [getattr(st, op)(q) for q in queries] for op in OPS}


def _assert_same(a, b):
    for op in OPS:
        for x, y in zip(a[op], b[op]):
            if op == "positions":
                assert x.dtype == y.dtype == np.uint32
                assert np.array_equal(x, y)  # the same slice, same order
            else:
                assert x == y and type(x) is type(y), (op, x, y)


@pytest.mark.parametrize("text", ["banana", "", "a", "aa", "☃abc☃",
                                  "mississippi"])
def test_bounds_parity_small(JTable, text):
    host, dev = _routes(text)
    ref = JTable.new(text, engine="native")
    ref.query_route = "host"
    for q in QUERY_BATTERY:
        hs, hc = host._bounds_batch([q])
        ds, dc = dev._bounds_batch([q])
        assert hs.dtype == hc.dtype == np.int64
        assert int(hc[0]) == int(dc[0]), (text, q)
        if int(hc[0]):
            assert int(hs[0]) == int(ds[0]), (text, q)
    _assert_same(_answers(host, QUERY_BATTERY), _answers(dev, QUERY_BATTERY))
    _assert_same(_answers(host, QUERY_BATTERY), _answers(ref, QUERY_BATTERY))


def test_positions_slice_semantics_host_route():
    # positions() is the UNORDERED table slice on both routes.
    host, dev = _routes("aaa")
    assert np.array_equal(host.positions("a"), dev.positions("a"))
    assert host.positions("a").tolist() == [2, 1, 0]
    assert host.positions_batch(["a", "aa"])[1].tolist() == [1, 0]


def test_bounds_parity_random(JTable, dna_10k):
    rng = np.random.default_rng(7)
    host, dev = _routes(dna_10k)
    ref = JTable.new(dna_10k, engine="native")
    ref.query_route = "host"
    data = np.frombuffer(dna_10k, np.uint8)
    queries = []
    for m in (1, 2, 7, 14, 19, 37, 64):  # merge, extended and refine tiers
        for _ in range(8):
            s = int(rng.integers(0, len(data) - m))
            queries.append(data[s : s + m].tobytes())
    queries += [b"NOTINTHERE", b"\xff\xff", b""]
    hs, hc = host._bounds_batch(queries)
    ds, dc = dev._bounds_batch(queries)
    js, jc = ref._bounds_batch(queries)
    assert np.array_equal(hc, dc) and np.array_equal(hc, jc)
    hit = hc > 0
    assert np.array_equal(hs[hit], ds[hit]) and np.array_equal(hs[hit],
                                                               js[hit])
    _assert_same(_answers(host, queries), _answers(dev, queries))
    _assert_same(_answers(host, queries), _answers(ref, queries))
    assert np.array_equal(host.count_batch(queries), ref.count_batch(queries))


def test_engine_auto_routes_and_matches(JTable, dna_10k):
    st_auto = SuffixTable.new(dna_10k, engine="auto", device="cpu")
    st_dev = SuffixTable.new(dna_10k, engine="device", device="cpu")
    assert np.array_equal(st_auto.table(), st_dev.table())
    assert np.array_equal(st_auto.table(),
                          JTable.new(dna_10k, engine="auto").table())
    assert len(dna_10k) <= table_mod.AUTO_NATIVE_MAX  # took the native route
    assert set(st_auto.__dict__) == {"_raw", "_table", "_was_str", "device"}


def test_query_route_auto_is_device_on_cpu_table():
    # A CPU table's device costs no round trip: "auto" keeps the device
    # route, so the CPU tests still cover the merge-join engine.
    st = SuffixTable.new("banana", device="cpu")
    assert st.query_route == "auto"
    assert not st._route_host(1)
    assert st.count("an") == 2
    assert st._dev_text is not None and "count" not in st.__dict__


@pytest.mark.parametrize("nq,route", [(1, "host"), (64, "host"),
                                      (65, "device")])
def test_auto_routes_small_batches_to_host(monkeypatch, dna_10k, nq, route):
    """Where dispatch is expensive (a CUDA table), singles and batches of
    at most HOST_QUERY_MAX answer on the host, larger ones on the device,
    with the same bounds."""
    monkeypatch.setattr(table_mod, "dispatch_is_expensive", lambda d: True)
    calls = []
    batch = native.bounds_batch
    monkeypatch.setattr(native, "bounds_batch",
                        lambda *a: calls.append(1) or batch(*a))
    st = SuffixTable.new(dna_10k, device="cpu")
    queries = [dna_10k[i:i + 11] for i in range(0, 97 * nq, 97)]
    starts, counts = st._bounds_batch(queries)
    assert (st._dev_text is None) == (route == "host")
    assert len(calls) == (1 if route == "host" and nq > 1 else 0)
    ref = SuffixTable.new(dna_10k, device="cpu")
    ref.query_route = "device"
    rs, rc = ref._bounds_batch(queries)
    assert np.array_equal(counts, rc) and np.array_equal(starts, rs)
    assert starts.dtype == counts.dtype == np.int64


def test_auto_singles_bind_extension_methods(monkeypatch, dna_10k):
    monkeypatch.setattr(table_mod, "dispatch_is_expensive", lambda d: True)
    st = SuffixTable.new(dna_10k, device="cpu")
    dev = SuffixTable.new(dna_10k, device="cpu")
    dev.query_route = "device"
    queries = [dna_10k[300:314], b"", "ACGT", bytearray(b"GG"),
               memoryview(b"TTA"), b"\xff"]
    got = _answers(st, queries)
    assert all(op in st.__dict__ for op in OPS)  # bound C methods
    assert st._dev_text is None  # no device state for singles
    _assert_same(got, _answers(dev, queries))


def test_host_route_without_extension(monkeypatch, dna_10k):
    """Without the CPython extension the host route binds the ctypes
    handle's four methods, with the same answers as the device route."""
    monkeypatch.setattr(native, "_load_fastpath", lambda: None)
    st = SuffixTable.new(dna_10k, engine="native", device="cpu")
    st.query_route = "host"
    dev = SuffixTable.new(dna_10k, device="cpu")
    dev.query_route = "device"
    queries = [dna_10k[300:314], b"", "ACGT", bytearray(b"GG"),
               memoryview(b"TTA"), b"\xff", dna_10k[:70]]
    got = _answers(st, queries)
    assert st._host_handle._ext is None
    assert all(st.__dict__[op].__self__ is st._host_handle for op in OPS)
    _assert_same(got, _answers(dev, queries))


def test_explicit_host_route_requires_no_device_state():
    st = SuffixTable.new(b"banana", engine="native", device="cpu")
    st.query_route = "host"
    assert st.contains("nan")
    assert st.count_batch(["an", "x", ""]).tolist() == [2, 0, 0]
    assert st._dev_text is None  # never touched a device


def test_query_route_setter_unbinds():
    st = SuffixTable.new(b"banana", engine="native", device="cpu")
    st.query_route = "host"
    assert st.count("a") == 3 and "count" in st.__dict__
    st.query_route = "device"
    assert not any(op in st.__dict__ for op in OPS)
    assert st.count("a") == 3 and st._dev_text is not None
    assert "count" not in st.__dict__  # the device route binds nothing
    # Per instance: another table keeps the class default.
    assert SuffixTable.new(b"x", device="cpu").query_route == "auto"


def test_fast_path_table_is_whole():
    """A small native build skips __init__: its lazy fields appear on
    first touch, and it behaves as a fully built table."""
    st = SuffixTable.new(b"mississippi", engine="native", device="cpu")
    assert set(st.__dict__) == {"_raw", "_table", "_was_str", "device"}
    full = SuffixTable.new(b"mississippi", device="cpu")
    assert st == full and repr(st) == repr(full)
    assert st.build_stats is None and st._host_handle is None
    assert st._pk is None and st._ext is None and st._ext_block is None
    assert st.count_batch(["ss", "i"]).tolist() == [2, 4]
    assert st._pk is not None  # the device index, built lazily
    assert np.array_equal(st.lcp_lens(), full.lcp_lens())
    assert st.verify() and st.verify(device=True)


def test_lazy_state_under_threads(dna_10k):
    """Threads racing a fast-path table's first queries agree on one init
    lock and one host handle, and every answer is right."""
    import sys
    import threading

    want = SuffixTable.new(dna_10k, device="cpu")
    want.query_route = "device"
    queries = [dna_10k[i:i + 8] for i in range(0, 4000, 250)]
    counts = [want.count(q) for q in queries]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            st = SuffixTable.new(dna_10k, engine="native", device="cpu")
            st.query_route = "host"
            seen, errors = [], []
            start = threading.Barrier(16)

            def work():
                try:
                    start.wait(timeout=60)
                    lock = st._init_lock
                    handle = st._ensure_host_handle()
                    seen.append((id(lock), id(handle)))
                    if [st.count(q) for q in queries] != counts:
                        errors.append("wrong count")
                except Exception as e:  # reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert not errors and len(seen) == 16
            assert len(set(seen)) == 1
    finally:
        sys.setswitchinterval(old)


def test_fast_path_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("native", "auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SuffixTable.new(b"banana", engine=engine)


@pytest.mark.parametrize("size", [999, 1000, 1001])
@pytest.mark.parametrize("as_str", [False, True])
def test_auto_labels_across_auto_native_max(JTable, monkeypatch, size,
                                            as_str):
    """engine="auto" takes native up to AUTO_NATIVE_MAX and the device
    build past it, in both packages, with the same labels and tables (str
    texts skip the fast path, bytes without stats take it)."""
    import suffix_tpu.table as jtable_mod

    for mod in (table_mod, jtable_mod):
        monkeypatch.setattr(mod, "AUTO_NATIVE_MAX", 1000)
    raw = bytes(np.random.default_rng(size).integers(97, 101, size,
                                                     dtype=np.uint8))
    text = raw.decode() if as_str else raw
    st = SuffixTable.new(text, engine="auto", device="cpu",
                         collect_stats=True)
    ref = JTable.new(text, engine="auto", collect_stats=True)
    want = "native-sais" if size <= 1000 else ref.build_stats["engine"]
    assert st.build_stats["engine"] == ref.build_stats["engine"] == want
    assert st.build_stats["engine_family"] == ref.build_stats["engine_family"]
    assert (want == "native-sais") == (size <= 1000)
    assert np.array_equal(st.table(), ref.table())
    fast = SuffixTable.new(text, engine="auto", device="cpu")
    assert np.array_equal(fast.table(), ref.table())
    assert ("_bytes" in fast.__dict__) == (as_str or size > 1000)


# ---------------------------------------------------------------- CUDA leg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_auto_route_answers_singles_on_host(cuda_device):
    """A CUDA table under "auto": singles and a batch of 64 on the host
    (no device state), 65 on the device, every answer equal to the device
    route's."""
    data = (FIXTURES / "AP009048_10000.fasta").read_bytes()
    st = SuffixTable.new(data, device=cuda_device)
    dev = SuffixTable.new(data, device=cuda_device)
    dev.query_route = "device"
    rng = np.random.default_rng(5)
    queries = [data[s:s + m] for m in (3, 14, 40, 64)
               for s in rng.integers(0, len(data) - m, size=8)]
    queries += [b"", b"zzz", "ACGT"]
    _assert_same(_answers(st, queries), _answers(dev, queries))
    assert all(op in st.__dict__ for op in OPS) and st._dev_text is None
    batch = [data[i:i + 9] for i in range(0, 650, 10)]
    assert np.array_equal(st.count_batch(batch[:64]),
                          dev.count_batch(batch[:64]))
    assert st._dev_text is None
    assert np.array_equal(st.count_batch(batch), dev.count_batch(batch))
    assert st._dev_text is not None
