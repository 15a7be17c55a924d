"""On the card: one short run of a cell through ``run.py``, its last line
the result naming the card. Skips without CUDA."""

import json
import subprocess
import sys

import pytest

from benchmark.spec import BENCH, ROOT


@pytest.mark.gpu
def test_run_on_the_card(cuda):
    import torch

    out = subprocess.run([sys.executable, str(ROOT / BENCH / "run.py"),
                          "--workload", "dna200m.index", "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert list(res)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
