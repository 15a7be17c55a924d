"""The port's serving runtime (``suffix_torch/serve.py``) against the JAX
package's (``suffix_tpu/serve.py``): ``handle_request`` answers a fixed
request list (every op, ``q`` and ``q_b64``, lists, the empty query, bad
types, unknown ops, ``ping`` and ``info``) with the same JSON, errors
included; ``serve_stdio`` writes the same lines; the ``Batcher`` merges
concurrent requests and hands each its own bounds; ``serve_tcp`` on port
0 answers and drops a connection whose line is too long, as JAX's does;
concurrent first calls build the device index once; the ``stats`` op
reads the Batcher's drains and queue waits. JAX is imported by a
fixture, so the CUDA leg (marker ``gpu``: a TCP round trip on a CUDA
table) runs without it:
``python -m pytest tests/test_torch_serve.py -m gpu --noconftest``.
Tolerance: exact equality.
"""

import base64
import io
import json
import socket
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable, serve  # noqa: E402
from suffix_torch.ops import search2  # noqa: E402
from suffix_torch.serve import Batcher, handle_request, serve_stdio  # noqa: E402

TEXT = b"the quick brown fox was quick." * 20


def b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


REQUESTS = [
    {"id": 7, "op": "count", "q": "quick"},
    {"op": "contains", "q": ["fox", "cat"]},
    {"op": "positions", "q": "zebra"},
    {"op": "positions", "q": "fox"},
    {"id": 1, "op": "positions", "q": ["fox", "quick", ""]},
    {"op": "any_position", "q": ["quick", ""]},
    {"op": "any_position", "q": "zzz"},
    {"op": "count", "q_b64": b64(b"quick.")},
    {"op": "contains", "q_b64": [b64(b"the"), b64(b"\xff"), b64(b"")]},
    {"op": "count", "q": []},
    {"op": "count", "q": ""},
    {"op": "count", "q": "x" * 100},
    {"op": "count", "q": "quick." * 7},
    {"q": "brown"},  # op defaults to positions
    {"id": "s", "op": "ping"},
    {"op": "info"},
    {"op": "nope", "q": "x"},
    {"op": "count"},
    {"op": "count", "q": 3},
    {"op": "count", "q": ["ok", 5]},
    {"op": "count", "q_b64": [7]},
    {"op": "count", "q_b64": "abc"},  # bad padding
    {"id": None, "op": "contains", "q": "☃"},
]


@pytest.fixture(scope="module")
def table():
    st = SuffixTable.new(TEXT, device="cpu")
    st.query_route = "device"
    return st


@pytest.fixture(scope="module")
def jax_serve():
    """(JAX table over TEXT, suffix_tpu.serve)."""
    pytest.importorskip("jax")
    import suffix_tpu
    from suffix_tpu import serve as jserve

    st = suffix_tpu.SuffixTable.new(TEXT)
    st.query_route = "device"
    return st, jserve


@pytest.mark.parametrize("req", REQUESTS, ids=range(len(REQUESTS)))
def test_handle_request_matches_jax(table, jax_serve, req):
    jtable, jserve = jax_serve
    got = handle_request(table, None, dict(req))
    want = jserve.handle_request(jtable, None, dict(req))
    assert json.dumps(got) == json.dumps(want)


def test_handle_request_answers(table):
    r = handle_request(table, None, {"id": 7, "op": "count", "q": "quick"})
    assert r == {"id": 7, "result": 40}
    r = handle_request(table, None, {"op": "positions", "q": "fox"})
    assert sorted(r["result"]) == [i for i in range(len(TEXT))
                                   if TEXT[i:i + 3] == b"fox"]
    r = handle_request(table, None, {"op": "any_position", "q": ["quick", ""]})
    hit, miss = r["result"]
    assert TEXT[hit:hit + 5] == b"quick" and miss is None
    assert "must be strings" in handle_request(
        table, None, {"op": "count", "q": 3})["error"]


def test_serve_stdio_matches_jax(table, jax_serve):
    jtable, jserve = jax_serve
    lines = [json.dumps(r) for r in REQUESTS[:8]] + [
        "", "not json", json.dumps({"id": 9, "op": "quit"}),
        json.dumps({"op": "count", "q": "after quit"})]
    text = "\n".join(lines) + "\n"
    got, want = io.StringIO(), io.StringIO()
    serve_stdio(table, infile=io.StringIO(text), outfile=got)
    jserve.serve_stdio(jtable, infile=io.StringIO(text), outfile=want)
    assert got.getvalue() == want.getvalue()
    out = [json.loads(x) for x in got.getvalue().splitlines()]
    assert len(out) == 10 and "bad json" in out[-2]["error"]
    assert out[-1] == {"id": 9, "result": "bye"}


def test_batcher_coalesces_and_demuxes(table, monkeypatch):
    calls = []
    real = table._bounds_batch

    def counted(queries):
        calls.append(len(queries))
        return real(queries)

    monkeypatch.setattr(table, "_bounds_batch", counted)
    b = Batcher(table, max_batch=4096, max_wait_ms=200.0)
    gate = threading.Barrier(16)
    results, expect = {}, {}

    def client(i, queries):
        gate.wait(timeout=30)
        results[i] = b.submit(queries)

    threads = []
    for i in range(16):
        qs = [f"q{i}", "quick", "fox", "", "the quick"][i % 3:]
        expect[i] = real(qs)
        threads.append(threading.Thread(target=client, args=(i, qs)))
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        b.close()
    for i, (s_want, c_want) in expect.items():
        s_got, c_got = results[i]
        assert np.array_equal(c_got, c_want), i
        hit = c_want > 0  # starts are defined only where there is a match
        assert np.array_equal(s_got[hit], s_want[hit]), i
    assert sum(calls) == sum(len(c) for _, c in expect.values())
    assert len(calls) < 16  # merged into shared dispatches
    empty = Batcher(table)
    s, c = empty.submit([])
    empty.close()
    assert len(s) == 0 and len(c) == 0
    with pytest.raises(RuntimeError, match="closed"):
        empty.submit(["x"])


def test_batcher_stats_and_drain_roots(table):
    from suffix_torch.utils.profiling import finished

    zeros = handle_request(table, None, {"id": 3, "op": "stats"})
    assert zeros["id"] == 3 and set(zeros["result"]) == {
        "drains", "queries", "queries_per_drain", "queue_wait_ms_p50",
        "queue_wait_ms_p99", "drain_ms_p50", "drain_ms_p99"}
    assert not any(zeros["result"].values())
    seen = {r["id"] for r in finished("serve.drain")}
    b = Batcher(table, max_batch=4096, max_wait_ms=50.0)
    gate = threading.Barrier(12)
    sizes = [1 + i % 4 for i in range(12)]

    def client(k):
        gate.wait(timeout=30)
        b.submit(["quick", "fox", "the", "zebra"][:k])

    threads = [threading.Thread(target=client, args=(k,)) for k in sizes]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        got = handle_request(table, b, {"op": "stats"})["result"]
    finally:
        b.close()
    assert got == b.stats()
    drains = [r for r in finished("serve.drain") if r["id"] not in seen]
    assert got["drains"] == len(drains) < 12
    assert got["queries"] == sum(sizes) == sum(
        r["attrs"]["queries"] for r in drains)
    assert sum(r["attrs"]["requests"] for r in drains) == 12
    assert got["queries_per_drain"] == pytest.approx(sum(sizes) / len(drains))
    assert 0 <= got["queue_wait_ms_p50"] <= got["queue_wait_ms_p99"]
    assert 0 < got["drain_ms_p50"] <= got["drain_ms_p99"]
    assert got["drain_ms_p99"] <= 1e3 * max(r["seconds"] for r in drains)
    # The first request of a drain waits the collection window out.
    assert got["queue_wait_ms_p99"] >= 40.0


def _exchange(addr, lines):
    with socket.create_connection(addr, timeout=30) as conn:
        f = conn.makefile("rw", encoding="utf-8")
        for line in lines:
            f.write(line + "\n")
        f.flush()
        return [json.loads(x) for x in f]


ROUND_TRIP = [
    json.dumps({"id": 1, "op": "count", "q": "quick"}),
    json.dumps({"id": 2, "op": "positions", "q": ["fox"]}),
    "{broken",
    json.dumps({"id": 3, "op": "quit"}),
    json.dumps({"id": 4, "op": "ping"}),  # after quit: never read
]
OVERSIZED = [
    json.dumps({"id": 5, "op": "ping"}),
    json.dumps({"op": "count", "q": "x" * 100}),  # past a MAX_LINE of 64
    json.dumps({"id": 6, "op": "ping"}),
]


def tcp_round_trip(module, table, monkeypatch, port=0):
    """ROUND_TRIP, then OVERSIZED under a MAX_LINE of 64, to
    ``module.serve_tcp`` over ``table`` with a Batcher; returns the two
    connections' answers. Port 0 reads the bound port off the server the
    port's serve_tcp attaches to its ready event."""
    b = module.Batcher(table, max_wait_ms=1.0)
    ready = threading.Event()
    t = threading.Thread(target=module.serve_tcp, args=(table, port),
                         kwargs={"batcher": b, "ready_event": ready},
                         daemon=True)
    t.start()
    assert ready.wait(timeout=30)
    addr = ready.server.server_address if port == 0 else ("127.0.0.1", port)
    try:
        answers = _exchange(addr, ROUND_TRIP)
        monkeypatch.setattr(module, "MAX_LINE", 64)
        oversized = _exchange(addr, OVERSIZED)
    finally:
        if port == 0:
            ready.server.shutdown()
            t.join(timeout=30)
            assert not t.is_alive()
        b.close()
    return answers, oversized


def test_tcp_port_zero_and_oversized_line(table, jax_serve, monkeypatch):
    answers, oversized = tcp_round_trip(serve, table, monkeypatch)
    assert answers[0] == {"id": 1, "result": 40}
    assert answers[1]["id"] == 2 and len(answers[1]["result"][0]) == 20
    assert "bad json" in answers[2]["error"]
    assert answers[3] == {"id": 3, "result": "bye"} and len(answers) == 4
    # The line past MAX_LINE is reported and the connection dropped.
    assert oversized == [{"id": 5, "result": "pong"},
                         {"error": "line exceeds 64 bytes"}]
    # JAX's server (no way to read a port-0 address: a free port).
    jtable, jserve = jax_serve
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    free = probe.getsockname()[1]
    probe.close()
    assert tcp_round_trip(jserve, jtable, monkeypatch, port=free) == (
        answers, oversized)


def test_concurrent_first_calls_build_index_once(monkeypatch):
    st = SuffixTable.new(TEXT, device="cpu")
    st.query_route = "device"
    builds = []
    real = search2.build_query_index

    def counted(*args, **kw):
        builds.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(search2, "build_query_index", counted)
    b = Batcher(st, max_wait_ms=1.0)
    gate = threading.Barrier(24)
    out, errors = [], []

    def worker(i):
        try:
            gate.wait(timeout=30)
            for _ in range(5):
                qs = ["quick", "fox", "zebra"]
                got = b.submit(qs) if i % 2 else st._bounds_batch(qs)
                out.append(got[1].tolist())
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        b.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert builds == [1]
    assert out == [[40, 20, 0]] * 120


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_tcp_round_trip(cuda_device, monkeypatch):
    st = SuffixTable.new(TEXT, device=cuda_device)
    answers, oversized = tcp_round_trip(serve, st, monkeypatch)
    assert answers[0] == {"id": 1, "result": 40}
    assert sorted(answers[1]["result"][0]) == sorted(
        st.positions_batch(["fox"])[0].tolist())
    assert oversized[1] == {"error": "line exceeds 64 bytes"}
