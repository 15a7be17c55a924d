"""Time the bandwidth and histogram batteries of several source trees in
turns on one card.

    python3 -m suffix_torch.bench_probes TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout of this repository (``.`` for this
one). The trees run in the order given, each in a process of its own that
builds that tree's kernels and runs its ``ops/probes.py`` battery, then
this tree's ``ops/kernels.py::histogram_battery`` (its source is sent to
the process) on that tree's ``byte_histogram``, so a tree that lacks the
histogram battery runs the same inputs and timing loop. Give the trees in
turns (parent, change, change, parent) to compare two versions on one
card. Prints the card's name and power limit, one JSON line a run, then a
summary: for each tree and row, the median of its runs' medians, their
range, and the row's time as a multiple of the same run's ``torch_copy1``
(a copy of the same bytes by PyTorch, which takes the card out of the
comparison); a histogram row's times also as a multiple of its own
``torch_sum1`` (a read of the same values by PyTorch) after the same
flush. ``--out`` also writes everything to FILE. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

from suffix_torch.ops import kernels

_CHILD = "\n".join((
    "from __future__ import annotations",
    "import json, sys",
    "sys.path.insert(0, '.')",
    "from suffix_torch.ops import probes",
    inspect.getsource(kernels.histogram_inputs),
    inspect.getsource(kernels.histogram_battery),
    "print(json.dumps(probes.bandwidth_battery() + histogram_battery()))",
))
# Times of a battery row that the summary reports, where the row has them.
TIMES = ("warm_ms", "ms", "read_flush_ms", "library_ms",
         "library_read_flush_ms", "bincount_ms", "torch_sum1_warm_ms",
         "torch_sum1_ms", "torch_sum1_read_flush_ms")
# A histogram row's time and the read of the same values after the same
# flush: the summary gives their ratio as x_torch_sum1.
SUM1_OF = {"warm_ms": "torch_sum1_warm_ms", "ms": "torch_sum1_ms",
           "read_flush_ms": "torch_sum1_read_flush_ms"}


def run_tree(tree: Path) -> list[dict]:
    """The battery rows of the checkout at ``tree``, from a new process."""
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def summarize(runs: list[tuple[str, list[dict]]]) -> dict:
    """{tree: {op: {time: {median, min, max, runs, x_torch_copy1[,
    x_torch_sum1]}}}}."""
    out: dict = {}
    for tree, rows in runs:
        base = next(r["ms"] for r in rows if r["op"] == "torch_copy1")
        for r in rows:
            per_op = out.setdefault(tree, {}).setdefault(r["op"], {})
            for key in TIMES:
                if r.get(key) is not None:
                    entry = per_op.setdefault(key, {"runs": [],
                                                    "x_torch_copy1": []})
                    entry["runs"].append(r[key])
                    entry["x_torch_copy1"].append(r[key] / base)
                    if r.get(SUM1_OF.get(key)) is not None:
                        entry.setdefault("x_torch_sum1", []).append(
                            r[key] / r[SUM1_OF[key]])
    for per_op in out.values():
        for times in per_op.values():
            for entry in times.values():
                entry.update(median=statistics.median(entry["runs"]),
                             min=min(entry["runs"]), max=max(entry["runs"]))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", type=Path)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lines = [json.dumps({"card": card.splitlines()[0]})]
    print(lines[-1], flush=True)
    runs = []
    for turn, tree in enumerate(args.trees):
        rows = run_tree(tree)
        runs.append((str(tree), rows))
        lines.append(json.dumps({"turn": turn, "tree": str(tree),
                                 "rows": rows}))
        print(lines[-1], flush=True)
    lines.append(json.dumps({"summary": summarize(runs)}))
    print(lines[-1], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
