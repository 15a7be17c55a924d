"""A configuration, a traffic mix and a metric that are added as new files
(with their BENCHMARK.json entries) are found and run without an edit to
any file the benchmark has."""

import json
import shutil

from benchmark.spec import BENCH, ROOT, Cell
from conftest import tiny_run


def copy_tree(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / BENCH, tmp_path / BENCH,
                    ignore=shutil.ignore_patterns("_cache", "_work",
                                                  "__pycache__"))
    return tmp_path


def test_new_files_are_found(tmp_path):
    root = copy_tree(tmp_path)
    (root / BENCH / "configs" / "dna_small.json").write_text(json.dumps({
        "name": "dna_small", "source": "test", "corpus": "repeats",
        "n_bytes": 4096, "reduced": [], "margin": "AC",
        "background": {"kind": "iid", "symbols": "ACGT",
                       "weights": [1, 1, 1, 1]},
        "repeats": [[100, 2]]}))
    (root / BENCH / "traffic" / "index_once.json").write_text(json.dumps({
        "runner": "index", "texts": 1}))
    (root / BENCH / "metrics" / "build.job_max_s.py").write_text(
        "def read(rec):\n"
        "    s = rec.get('spans', {}).get('build.job')\n"
        "    return max(s) if s else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dna_small", "source": "test",
                            "file": "benchmark/configs/dna_small.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dnasmall.index", "config": "dna_small",
                              "traffic": "index_once", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "build.job_max_s", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "table API", "moves": "index_mib_s",
                              "workloads": ["dnasmall.index"]})
    spec["end_to_end"][[m["name"] for m in spec["end_to_end"]]
                       .index("index_mib_s")]["workloads"].append(
                           "dnasmall.index")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Cell("dnasmall.index", root)
    assert cell.config["n_bytes"] == 4096
    assert cell.traffic == {"runner": "index", "texts": 1}
    assert "build.job_max_s" in [m["name"] for m in cell.metrics(True)]
    out = tiny_run("dnasmall.index", root=root, trace=True, config={})
    assert out["correct"]
    assert out["metrics"]["build.job_max_s"]["value"] > 0
    out = tiny_run("dnasmall.index", root=root, config={})
    # On the CPU there is no device peak to read.
    assert set(out["metrics"]) == {"index_mib_s", "setup_s"}
