"""No module the benchmark runs imports JAX or the JAX package (whole
top-level names: ``suffix_torch`` is not ``suffix_tpu``), and the
reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from benchmark.spec import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "suffix_tpu"}
SOURCES = sorted(p for p in (ROOT / BENCH).rglob("*.py")
                 if "_cache" not in p.parts and "_work" not in p.parts)


def top_imports(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "rng.py", "trace.py",
                                  "words.py", "corpora/repeats.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    tops = top_imports(ROOT / BENCH / name)
    assert "suffix_torch" not in tops and not tops & FORBIDDEN


def test_top_level_names_are_compared_whole():
    sys.path.insert(0, str(ROOT / BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / BENCH))
    sys.modules["suffix_torch_like_name"] = sys
    try:
        found = run.forbidden_modules()
    finally:
        del sys.modules["suffix_torch_like_name"]
    assert "suffix_torch" not in found and not set(found) - FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole run of a cell, in a process of its own, on the CPU."""
    code = (
        "import sys, time, torch; torch.set_num_threads(1);"
        f"sys.path.insert(0, {str(ROOT)!r});"
        f"sys.path.insert(0, {str(ROOT / BENCH)!r});"
        f"sys.path.insert(0, {str(ROOT / BENCH / 'tests')!r});"
        "from benchmark.harness import run_cell;"
        "from benchmark.spec import Cell; import run;"
        "from conftest import small_config; c = Cell('dna200m.index');"
        "out = run_cell(c, 5, 0.5, False, 'cpu',"
        " time.monotonic(), config=small_config(c.config, 5000));"
        "assert out['correct'];"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'suffix_tpu'}), run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] []"


def test_run_without_a_card_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(ROOT / BENCH / "run.py"),
                          "--workload", "dna200m.index", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_run_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / BENCH, tmp_path / BENCH,
                    ignore=shutil.ignore_patterns("_cache", "_work"))
    out = subprocess.run([sys.executable, str(tmp_path / BENCH / "run.py"),
                          "--workload", "dna200m.index", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
