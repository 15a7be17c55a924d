"""BENCHMARK.json keeps to its format: names, units and
texts in their characters, every file it names present, every cell with
its metrics."""

import json
import re

import pytest

from benchmark.spec import BENCH, ROOT, Cell, load_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# A width may never be cut (for a text index the
# shapes: alphabet, pattern and record widths).
WIDTHS = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per|alphabet)")

SPEC = load_spec()


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert not w.startswith("/") and ".." not in w
            assert any(w.startswith(p + "/") for p in paths)


def test_names_are_unique_and_allowed():
    groups = [SPEC["configs"], SPEC["workloads"],
              SPEC["end_to_end"] + SPEC["per_layer"]]
    for g in groups:
        names = [e["name"] for e in g]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
        assert (ROOT / BENCH / "corpora" / f"{cfg['corpus']}.py").exists()
        # A size is cut from the published one only where `reduced` says.
        if "n_bytes" not in c["reduced"]:
            assert cfg["n_bytes"] == cfg["published"]["n_bytes"]


def test_workloads():
    ws = SPEC["workloads"]
    assert 1 <= len(ws) <= 24
    pairs = {(w["config"], w["traffic"]) for w in ws}
    assert len(pairs) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (ROOT / BENCH / "traffic" / f"{w['traffic']}.json").exists()


def test_metrics():
    e2e, per = SPEC["end_to_end"], SPEC["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
    for m in e2e + per:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / BENCH / "metrics" / f"{m['name']}.py").exists()
        assert not ("roofline" in m["name"] or "mfu" in m["name"])


def test_layers_name_one_layer_each_way():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    c = Cell(cell)
    e2e = {m["name"] for m in c.metrics(trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = c.metrics(trace=True)
    assert per
    for m in per:  # what a per-layer metric moves, this cell reports
        assert m["moves"] in e2e
    assert c.config["n_bytes"] > 0
