#!/usr/bin/env python3
"""The control of ``correct``: the reference put in the program's place
with one guarantee broken (``reference.CONTROL_WIDTH``: suffixes read to
their first 16 bytes only), judged by the same numbers as a run, on the
first text a run of the cell makes from each seed.

    python3 benchmark/control.py --workload dna200m.index --seeds 1,2,3

Prints one JSON line a seed with each compared number the control reads;
a limit holds only where every control reading is above it. The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, device, config=None) -> dict:
    """The control's numbers for one seed of ``cell``."""
    from benchmark import reference
    from benchmark.harness import Context

    ctx = Context(cell, seed, 0.0, False, device, time.monotonic(), config)
    text = ctx.corpus.make(ctx.config, seed, 0, device)
    t = reference.as_text(text, device)
    return {"seed": seed,
            "sa_defects": reference.sa_defects(t, reference.control_sa(t))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark.spec import Cell

    cell = Cell(args.workload, ROOT)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.monotonic()
        r = readings(cell, seed, torch.device(args.device))
        r["seconds"] = time.monotonic() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
