"""The metric readers on fixed records, and the trace summary on a fixed
Chrome trace."""

import pytest

from benchmark import trace
from benchmark.spec import Cell, load_spec

BASE = 1_000_000_000_000


def reader(name):
    return Cell("dna200m.index").reader(name).read


def index_rec():
    return {"setup_s": 9.0, "window_s": 30.0, "text_bytes": 2**26,
            "peak_window_bytes": 111 * 2**26,
            "counters": {"jobs": 10, "jobs_bytes": 10 * 2**26,
                         "last_job_end_s": 20.0},
            "spans": {"build.job": [1.0, 1.5]},
            "trace": {"window_s": 4.0, "busy_s": 1.0, "jobs": 2,
                      "scopes_ms": {"T2_phase2_round": 99.0},
                      "ops_ms": {"aten::sort": 40.0, "aten::index": 7.0}}}


@pytest.mark.parametrize("name,want", [
    ("setup_s", 9.0), ("index_mib_s", 32.0),
    ("device_bytes_per_text_byte", 111.0), ("build.job_s", 1.25),
    ("build.sort_ms", 20.0), ("device_idle_pct.index", 75.0)])
def test_index_readers(name, want):
    assert reader(name)(index_rec()) == pytest.approx(want)


def test_readers_find_nothing_untraced():
    rec = index_rec()
    rec["trace"] = None
    assert reader("build.sort_ms")(rec) is None
    assert reader("device_idle_pct.index")(rec) is None
    rec["counters"] = {"jobs": 0, "jobs_bytes": 0, "last_job_end_s": None}
    assert reader("index_mib_s")(rec) is None
    rec["peak_window_bytes"] = 0
    assert reader("device_bytes_per_text_byte")(rec) is None


def test_readers_find_nothing_without_device_time():
    rec = index_rec()
    rec["trace"] = {"window_s": 4.0, "busy_s": 0.0, "jobs": 2,
                    "scopes_ms": {}, "ops_ms": {}}
    assert reader("device_idle_pct.index")(rec) is None
    assert reader("build.sort_ms")(rec) is None


def test_every_metric_has_a_reader():
    spec = load_spec()
    cell = Cell("dna200m.index")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(cell.reader(m["name"]).read)


def chrome():
    """Two kernels under P4_round_sort (launched on thread 1 inside it),
    one outside, a memcpy; times in microseconds after BASE ns."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "P4_round_sort",
         "tid": 1, "ts": 100, "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "tid": 1,
         "ts": 105, "dur": 40},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 110, "dur": 2, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 120, "dur": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 300, "dur": 2, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "radix_sort", "tid": 7,
         "ts": 200, "dur": 100, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "radix_sort", "tid": 7,
         "ts": 300, "dur": 100, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gather", "tid": 7,
         "ts": 600, "dur": 50, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "tid": 8,
         "ts": 640, "dur": 60, "args": {"correlation": 4}},
    ]
    return {"baseTimeNanoseconds": BASE, "traceEvents": ev}


def test_trace_summary():
    t0, t1 = BASE + 0, BASE + 1_000_000  # 1 ms window
    spans = [("build.job", BASE + 50_000, BASE + 450_000),
             ("build.job", BASE + 450_000, BASE + 900_000)]
    s = trace.summarize(chrome(), t0, t1, spans)
    assert s["window_s"] == pytest.approx(1e-3)
    # busy: [200, 400] and [600, 700] microseconds
    assert s["busy_s"] == pytest.approx(300e-6)
    assert s["scopes_ms"]["P4_round_sort"] == pytest.approx(0.2)
    # aten::sort covers launches 1 and 2; the gather is outside it.
    assert s["ops_ms"] == {"aten::sort": pytest.approx(0.2)}
    assert s["device_ops"][0] == ["radix_sort", pytest.approx(200e-6)]
    gaps = dict(s["idle_gaps"])
    # idle: [0, 200] (midpoint 100: build.job, inside P4_round_sort),
    # [400, 600] (midpoint 500: the second job), [700, 1000] (the same)
    assert gaps["build.job > P4_round_sort"] == pytest.approx(200e-6)
    assert gaps["build.job"] == pytest.approx(500e-6)
    assert sum(gaps.values()) == pytest.approx(700e-6)


def test_trace_summary_clips_to_the_window():
    s = trace.summarize(chrome(), BASE + 250_000, BASE + 350_000)
    assert s["busy_s"] == pytest.approx(100e-6)
    assert s["idle_gaps"] == []
