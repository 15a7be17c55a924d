"""The sharded cell on the CPU: four gloo ranks, this process rank 0 (the
harness's own), three spawned. A sound run is ``correct`` and reads the
sharded build's spans and counters; a run whose program is broken
underneath on rank 0 reads ``correct`` false, for each fault a sharded
index cell can have; texts that differ between the ranks fail
``text_mismatch``."""

import numpy as np
import pytest

from benchmark import ranks, sharded_spans
from benchmark.spec import Cell
from conftest import tiny_run
from suffix_torch.parallel import dist_build as db
from test_bench_faults import half_sorted, swapped, unchanged

CELL = "english1g.sharded_index"
PROGRAM = ("sharded.host_s", "sharded.rounds_s", "sharded.gather_s",
           "sharded.rounds", "sharded.exchange_bytes")


def run(**kw):
    # 2^17 bytes: 2^15 rows a rank, and the adaptive plan runs.
    return tiny_run(CELL, n_bytes=1 << 17, **kw)


def test_sound_run_is_correct_and_reads_the_program():
    out = run(trace=True, seconds=5.0)  # jobs done in the window, loaded
    assert out["correct"], out["checks"]
    assert {k: c["value"] for k, c in out["checks"].items()} == {
        "sa_defects": 0, "text_mismatch": 0}
    assert out["device"]["count"] == 4
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(PROGRAM) <= set(m)
    assert all(m[k] > 0 for k in PROGRAM)
    # The CPU runs no device kernel: the device trace's reader finds
    # nothing here, and reads a fixed trace below.
    assert "sharded.exchange_ms" not in m
    jobs = out["diagnostics"]["counters"]["jobs"]
    roots = sharded_spans.window_roots(
        {"attempted": out["attempted"],
         "counters": out["diagnostics"]["counters"]})
    assert jobs >= 1 and len(roots) == jobs
    assert all(r["attrs"]["rank"] == 0 and r["attrs"]["world"] == 4
               and r["attrs"]["n"] == 1 << 17 for r in roots)
    assert m["sharded.rounds"] == sum(
        r["counters"]["rounds"] for r in roots) / jobs
    assert set(out["diagnostics"]["setup_split_s"]) == {
        "start", "texts", "ranks_start", "warmup_job"}


def test_untraced_run_reports_the_cells_end_to_end_metrics():
    out = run(seconds=5.0)
    assert out["correct"]
    # On the CPU there is no device peak to read.
    assert set(out["metrics"]) == {"index_mib_s", "setup_s"}


def patch_build(monkeypatch, change):
    """Rank 0's table altered where the sharded build returns it."""
    orig = db.build_table

    def broken(mesh, data, *a, **k):
        sa = orig(mesh, data, *a, **k)
        return change(data, sa.copy()) if mesh.rank == 0 else sa

    monkeypatch.setattr(db, "build_table", broken)


@pytest.mark.parametrize("fault", [swapped, unchanged, half_sorted])
def test_table_faults(monkeypatch, fault):
    patch_build(monkeypatch, fault)
    out = run()
    assert not out["correct"]
    assert out["checks"]["sa_defects"]["value"] > 0


def test_dropped_exchange(monkeypatch):
    """Rank 0 posts its transfers but keeps its own block in place of
    each one it receives from the same peer."""
    orig = db._exchange

    def dropped(sends, recvs, mesh):
        orig(sends, recvs, mesh)
        for peer in {p for p, _ in recvs}:
            mine = [t for p, t in sends if p == peer]
            theirs = [t for p, t in recvs if p == peer]
            for a, b in zip(mine, theirs):
                b.copy_(a)

    monkeypatch.setattr(db, "_exchange", dropped)
    out = run()
    assert not out["correct"]
    assert out["checks"]["sa_defects"]["value"] > 0


def test_texts_that_differ_between_ranks(monkeypatch):
    """Rank 0's second text with two neighbouring bytes swapped: the
    same bytes, so every rank still takes the same plan."""
    orig = ranks.make_texts

    def altered(*a, **k):
        texts = orig(*a, **k)
        t = bytearray(texts[1])
        i = next(i for i in range(len(t) // 3, len(t)) if t[i] != t[i + 1])
        t[i], t[i + 1] = t[i + 1], t[i]
        texts[1] = bytes(t)
        return texts

    monkeypatch.setattr(ranks, "make_texts", altered)
    out = run()
    assert not out["correct"]
    assert out["checks"]["text_mismatch"]["value"] == 1


def trace_rec(**tr):
    return {"trace": {"window_s": 4.0, "busy_s": 1.0, "jobs": 2,
                      "scopes_ms": {}, "ops_ms": {}, **tr}}


def test_exchange_ms_reads_the_exchange_scopes():
    read = Cell(CELL).reader("sharded.exchange_ms").read
    rec = trace_rec(scopes_ms={"sharded.exchange": 90.0,
                               "sharded.rounds": 500.0})
    assert read(rec) == pytest.approx(45.0)
    assert read(trace_rec()) is None
    assert read({"trace": None}) is None


def test_readers_find_nothing_without_sharded_roots(monkeypatch):
    """The parent's program keeps no ``sharded_build`` roots: every
    reader of them gives nothing and raises nothing."""
    import suffix_torch.utils.profiling as prof

    rec = {"attempted": 2, "counters": {"jobs": 1}, "trace": None}
    monkeypatch.setattr(prof, "finished", lambda name=None: [])
    cell = Cell(CELL)
    for name in PROGRAM:
        assert cell.reader(name).read(rec) is None
    monkeypatch.delattr(prof, "finished")
    assert sharded_spans.window_roots(rec) is None


def test_the_cells_configuration_scales_english_200m():
    """The whole 2^30-byte file, at english_200m's density of copies and
    rare bytes."""
    one, big = Cell("english200m.index").config, Cell(CELL).config
    assert big["published"]["n_bytes"] == 2**30
    assert big["n_bytes"] == 2**30 and big["reduced"] == []
    assert big["published"]["max_lcp_at_least"] == \
        one["published"]["max_lcp"]
    scale = big["n_bytes"] / one["n_bytes"]
    assert [length for length, _ in big["repeats"]] == \
        [length for length, _ in one["repeats"]]
    assert [c for _, c in big["repeats"]] == \
        [round(c * scale) for _, c in one["repeats"]]
    assert big["sprinkle"]["count"] == round(one["sprinkle"]["count"] * scale)
    for key in ("background", "margin", "guarantees"):
        assert big[key] == one[key]
    assert np.isclose(scale, 5.12)
