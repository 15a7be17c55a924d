"""Finds what ``BENCHMARK.json`` names: a cell's configuration, its traffic
mix, its corpus generator, its runner and the readers of its metrics.

Every lookup is by name under a root, so a cell, a mix or a metric that a
later change adds as new files is found without an edit here.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = "benchmark"


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_module(path: Path, tag: str):
    """Import the file at ``path`` as a module of its own (metric names
    hold dots, so they cannot be imported by name)."""
    name = "_bench_" + re.sub(r"\W", "_", tag)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with the files it names."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.spec = load_spec(self.root)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (self.root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (self.root / BENCH / "traffic" / f"{self.entry['traffic']}.json")
            .read_text())

    def runner(self):
        name = self.traffic["runner"]
        return load_module(self.root / BENCH / "runners" / f"{name}.py",
                           f"runner_{name}")

    def corpus(self):
        name = self.config["corpus"]
        return load_module(self.root / BENCH / "corpora" / f"{name}.py",
                           f"corpus_{name}")

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: the end-to-end ones with
        ``trace`` off, the per-layer ones with it on; an entry with a
        ``workloads`` key only in the cells it lists."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        return load_module(self.root / BENCH / "metrics" / f"{metric}.py",
                           f"metric_{metric}")
