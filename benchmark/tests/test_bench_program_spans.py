"""The per-layer metrics that read the program's own spans and counters
(``program_spans.py``): a traced run of each cell on the CPU, at a size
whose builds run the period probe and the adaptive plan, reports all
seven; their readers take exactly the window's completed jobs; and the
layers' seconds add up to the benchmark's own span around each job."""

import pytest

from benchmark import program_spans
from conftest import tiny_run

SPAN_METRICS = ("build.host_s", "build.copy_s", "build.dispatch_s",
                "build.readback_wait_s")
COUNTER_METRICS = ("build.host_syncs", "build.rounds", "build.copy_bytes")


@pytest.mark.parametrize("cell", ["dna200m.index", "english200m.index"])
def test_traced_run_reports_the_program_spans(cell):
    # 2^16 + 4,464 bytes: n_pad 2^17 = ADAPTIVE_PACK_MIN.
    out = tiny_run(cell, trace=True, n_bytes=70000, seconds=1.0)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_METRICS + COUNTER_METRICS) <= set(m)
    jobs = out["diagnostics"]["counters"]["jobs"]
    assert jobs >= 1
    roots = program_spans.window_roots(
        {"attempted": out["attempted"],
         "counters": out["diagnostics"]["counters"]})
    assert len(roots) == jobs
    assert all(r["attrs"]["n"] == 70000 and r["attrs"]["n_pad"] == 1 << 17
               for r in roots)
    assert all({"build.probe", "build.plan"} <= set(r["span_n"])
               for r in roots)
    assert m["build.rounds"] == pytest.approx(
        sum(r["counters"]["rounds"] for r in roots) / jobs)
    assert m["build.host_syncs"] >= m["build.rounds"]
    assert m["build.copy_bytes"] == 0  # a CPU build copies nothing
    assert 0 < m["build.readback_wait_s"] < m["build.dispatch_s"]
    layers = m["build.host_s"] + m["build.copy_s"] + m["build.dispatch_s"]
    assert layers == pytest.approx(m["build.job_s"], rel=0.05)


def test_no_recorder_reads_nothing(monkeypatch):
    import suffix_torch.utils.profiling as prof

    rec = {"attempted": 2, "counters": {"jobs": 1}}
    monkeypatch.setattr(prof, "finished", lambda name=None: [])
    assert program_spans.mean_span_s(rec, ("build.dispatch",)) is None
    monkeypatch.delattr(prof, "finished")
    assert program_spans.window_roots(rec) is None
    assert program_spans.mean_counter(rec, ("rounds",)) is None
    assert program_spans.window_roots({"attempted": 0,
                                       "counters": {"jobs": 0}}) is None
