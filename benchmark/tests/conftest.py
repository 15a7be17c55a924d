"""Tests of the benchmark itself, on the CPU at small sizes:
``pytest benchmark/tests``. Tests marked ``gpu`` need the card and skip
here."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def small_config(config: dict, n_bytes: int) -> dict:
    """The overrides that shrink a configuration to ``n_bytes``: a short
    ladder of repeats, short runs, each sprinkled byte once."""
    out = {"n_bytes": n_bytes, "repeats": [[64, 4], [300, 1]]}
    if config.get("runs"):
        out["runs"] = [[r[0], 8, 4] for r in config["runs"]]
    if config.get("sprinkle"):
        out["sprinkle"] = {**config["sprinkle"], "count": 1}
    return out


def tiny_run(cell_name: str, seed: int = 4242, seconds: float = 1.0,
             trace: bool = False, root: Path = ROOT, n_bytes: int = 20000,
             config: dict | None = None):
    """One run of a cell on the CPU at ``n_bytes``, or with ``config``'s
    overrides."""
    import time

    import torch

    from benchmark.harness import run_cell
    from benchmark.spec import Cell

    torch.set_num_threads(1)
    cell = Cell(cell_name, root)
    return run_cell(cell, seed, seconds, trace, "cpu", time.monotonic(),
                    config=small_config(cell.config, n_bytes)
                    if config is None else config)
