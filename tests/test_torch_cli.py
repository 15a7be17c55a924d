"""The port's CLI (``suffix_torch/cli.py``) against the JAX package's
(``suffix_tpu/cli.py``), in process under ``capsys``: ``build``,
``build --stats``, ``search``, ``stree``, ``stree --array`` and ``info``
print what ``suffix_tpu.cli.main`` prints for the same argv (a stats
line's timings and device name aside); saved indexes cross-load both
ways, ``doc_starts`` included; ``warmup`` runs; the sharded build and
sharded warmup (one rank in process, two started for the command) print
what JAX's do and save the same index; ``search --sharded`` (two ranks)
prints what JAX's does; a missing card raises; and one subprocess runs
``python -m suffix_torch``.
Tolerance: exact equality.
"""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.cli import main  # noqa: E402
from suffix_torch.utils import checkpoint  # noqa: E402

import doubling_oracle as oracle  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "tests" / "fixtures" / "AP009048_10000.fasta")
# Fields of a build-stats line that the run itself decides.
VOLATILE = ("elapsed_s", "bytes_per_s", "device")


@pytest.fixture(scope="module")
def jax_cli():
    """(suffix_tpu.cli.main, suffix_tpu.utils.checkpoint)."""
    pytest.importorskip("jax")
    from suffix_tpu.cli import main as jax_main
    from suffix_tpu.utils import checkpoint as jax_checkpoint

    return jax_main, jax_checkpoint


def run(fn, argv, capsys):
    assert fn(argv) == 0
    return capsys.readouterr().out


def stable(out: str) -> list:
    """Output lines with each JSON stats line's run-decided fields
    dropped."""
    lines = []
    for line in out.splitlines():
        head, sep, tail = line.partition("{")
        if sep and tail.endswith("}"):
            stats = json.loads(sep + tail)
            lines.append((head, {k: v for k, v in stats.items()
                                 if k not in VOLATILE}))
        else:
            lines.append(line)
    return lines


@pytest.mark.parametrize("argv", [
    ["build", FIXTURE],
    ["build", FIXTURE, "-e", "device"],
    ["build", FIXTURE, "-e", "native", "--stats"],
    ["build", FIXTURE, "-e", "device", "--stats"],
    ["build", FIXTURE, "-e", "naive"],
    ["stree", "banana"],
    ["stree", "banana", "--array"],
    ["stree", "mississippi", "river"],
    ["stree"],
    ["search", "--file", FIXTURE, "AGCTT", "GATTACA", "A", "CCAGG"],
])
def test_output_matches_jax(jax_cli, capsys, argv):
    jax_main, _ = jax_cli
    got = run(main, ["--platform", "cpu", *argv], capsys)
    want = run(jax_main, ["--platform", "cpu", *argv], capsys)
    got_lines, want_lines = stable(got), stable(want)
    for line, jline in zip(got_lines, want_lines):
        if isinstance(line, tuple):
            _padded_trajectory_to_oracle(argv[1], line[1], jline[1])
    assert got_lines == want_lines
    assert got.count("\n") == want.count("\n")


def _padded_trajectory_to_oracle(path: str, stats: dict, jstats: dict):
    """A device build over padding slots: the port keys them apart, so its
    trajectory keys are held to the LCP oracle and taken out of both
    stats lines; the JAX package's rounds also run on the padding's ties."""
    if (stats.get("engine_family") not in ("classic", "two_phase")
            or stats["n_bytes"] == stats["n_pad"]):
        return
    raw = pathlib.Path(path).read_bytes()
    sa = SuffixTable.new(raw, engine="native", device="cpu").table()
    traj = {k: stats.pop(k) for k in oracle.TRAJECTORY_KEYS if k in stats}
    assert traj == oracle.trajectory(raw, sa, stats)
    for k in oracle.TRAJECTORY_KEYS:
        jstats.pop(k, None)


def test_save_search_info_match_jax(jax_cli, capsys, tmp_path):
    jax_main, _ = jax_cli
    qfile = tmp_path / "q.txt"
    qfile.write_text("AGCTT\n\nGATTACA\nTTTT\n")
    outs = []
    for fn, name in ((main, "port.npz"), (jax_main, "jax.npz")):
        idx = str(tmp_path / name)
        run(fn, ["--platform", "cpu", "build", FIXTURE, "--stats", "-o", idx],
            capsys)
        outs.append([
            run(fn, ["--platform", "cpu", "search", "--index", idx,
                     "--queries-file", str(qfile), "A"], capsys),
            stable(run(fn, ["--platform", "cpu", "info", idx], capsys))])
    assert outs[0] == outs[1]
    search, info = outs[0]
    assert search.splitlines()[1].startswith("AGCTT\t8\t0,67,1102")
    assert info[0] == "text bytes:   10001"
    # Each package reads the other's index.
    st = checkpoint.load_index(str(tmp_path / "jax.npz"), device="cpu")
    assert st.build_stats["engine"] == "native-sais"
    assert run(main, ["--platform", "cpu", "info", str(tmp_path / "jax.npz")],
               capsys).startswith("text bytes:   10001")


def test_checkpoints_cross_load_with_doc_starts(jax_cli, tmp_path):
    _, jax_checkpoint = jax_cli
    import suffix_tpu

    text = "the quick fox\x00a lazy dog\x00quick quick"
    starts = np.array([0, 14, 25])
    port = SuffixTable.new(text, device="cpu")
    ref = suffix_tpu.SuffixTable.new(text)
    p_port, p_jax = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    checkpoint.save_index(p_port, port, lcp=port.lcp_lens(),
                          doc_starts=starts)
    jax_checkpoint.save_index(p_jax, ref, lcp=ref.lcp_lens(),
                              doc_starts=starts)
    with np.load(p_port) as zp, np.load(p_jax) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for key in zj.files:
            assert zp[key].dtype == zj[key].dtype, key
            assert np.array_equal(zp[key], zj[key]), key
        assert zp["doc_starts"].dtype == np.int64
    in_jax = jax_checkpoint.load_index(p_port)
    in_port = checkpoint.load_index(p_jax, device="cpu")
    assert in_jax.text() == in_port.text() == text
    assert np.array_equal(in_jax.table(), port.table())
    assert np.array_equal(in_port.table(), ref.table())
    assert in_port.positions("quick").tolist() == \
        ref.positions("quick").tolist()


def test_warmup_names_match_jax(jax_cli, capsys):
    from suffix_torch.utils.warmup import warm

    assert main(["--platform", "cpu", "warmup", "--size", "4096",
                 "--batches", "8,16", "--qlens", "8"]) == 0
    out = capsys.readouterr().out
    assert "warmed build n=4096 (init_words=4)" in out
    assert out.rstrip().splitlines()[-1].startswith("warmed 5 programs in ")
    from suffix_tpu.utils.warmup import warm as jax_warm

    kw = dict(query_batches=(8,), query_lens=(8,), verbose=False)
    got = [name for name, _ in warm(500, device="cpu", **kw)]
    want = [name for name, _ in jax_warm(500, **kw)]
    assert got == want


@pytest.mark.parametrize("argv", [
    ["build", FIXTURE, "-e", "sharded"],
    ["build", FIXTURE, "-e", "sharded", "--devices", "2", "--checkpoint",
     "ck.npz", "--resume"],
    ["search", "--file", FIXTURE, "--sharded", "--devices", "2", "AGCTT",
     "GATTACA", "ACGTACGTACGTACGTACGTA", "", "CGCTGG"],
    ["warmup", "--size", "500", "--devices", "2"],
])
def test_sharded_options_raise(jax_cli, capsys, tmp_path, monkeypatch, argv):
    """The sharded build, sharded search (two ranks started for the
    command) and sharded warmup print what JAX's CLI prints (the test's
    name dates from when they raised), and the builds save the same
    index."""
    jax_main, _ = jax_cli
    monkeypatch.chdir(tmp_path)  # the relative checkpoint path lands here
    out = argv + (["-o", "{}.npz"] if argv[0] == "build" else [])
    outs = []
    for fn, name in ((main, "port"), (jax_main, "jax")):
        args = [a.format(name) for a in out]
        if "ck.npz" in args:
            args[args.index("ck.npz")] = f"ck_{name}.npz"
        text = run(fn, ["--platform", "cpu", *args], capsys)
        outs.append(re.sub(r"\d+\.\d+s", "Xs", text))
    assert outs[0] == outs[1]
    if argv[0] == "search":
        assert outs[0].splitlines()[0] == (
            "AGCTT\t8\t0,67,1102,3458,3772,4800,5995,8912")
        return
    if argv[0] == "warmup":
        assert outs[0].splitlines()[-1] == "warmed 3 programs in Xs"
        return
    assert outs[0] == "Suffixes: 10001\n"
    with np.load("port.npz") as zp, np.load("jax.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for key in zj.files:
            assert np.array_equal(zp[key], zj[key]), key
    if "--checkpoint" in argv:
        with np.load("ck_jax.npz") as zj:
            last = int(zj["k"]), bool(zj["done"])
        for r in range(2):  # one file a rank, at JAX's last round
            with np.load(f"ck_port.npz.p{r}") as z:
                assert (int(z["k"]), bool(z["done"])) == last
                assert z["los"].tolist() == [r * 8192]


def test_default_platform_needs_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("SUFFIX_TORCH_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["stree", "banana"])
    monkeypatch.setenv("SUFFIX_TORCH_PLATFORM", "cpu")
    assert main(["stree", "banana"]) == 0


def test_missing_inputs(capsys, tmp_path):
    assert main(["--platform", "cpu", "build", str(tmp_path / "nope")]) == 1
    assert "cannot read" in capsys.readouterr().err
    assert main(["--platform", "cpu", "search", "x"]) == 2
    assert main(["--platform", "cpu", "serve"]) == 2


def test_module_entry_point(jax_cli, capsys):
    jax_main, _ = jax_cli
    proc = subprocess.run(
        [sys.executable, "-m", "suffix_torch", "--platform", "cpu", "stree",
         "banana"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == run(jax_main, ["--platform", "cpu", "stree",
                                         "banana"], capsys)


def test_serve_stdio_matches_jax(jax_cli, capsys, monkeypatch, tmp_path):
    import io

    jax_main, _ = jax_cli
    corpus = tmp_path / "c.txt"
    corpus.write_bytes(b"banana band bandana")
    reqs = "\n".join([
        json.dumps({"id": 1, "op": "count", "q": "ban"}),
        json.dumps({"id": 2, "op": "positions", "q": "ana"}),
        json.dumps({"id": 3, "op": "contains", "q": ["nd", "zz", ""]}),
        "not json",
        json.dumps({"id": 4, "op": "quit"}),
    ]) + "\n"
    argv = ["--platform", "cpu", "serve", "--file", str(corpus), "--warm",
            "--batch", "--max-batch", "16"]
    outs = []
    for fn in (main, jax_main):
        monkeypatch.setattr(sys, "stdin", io.StringIO(reqs))
        assert fn(argv) == 0
        cap = capsys.readouterr()
        assert "--batch has no effect over stdio" in cap.err
        outs.append(cap.out)
    assert outs[0] == outs[1]
    lines = [json.loads(x) for x in outs[0].splitlines()]
    assert lines[0] == {"id": 1, "result": 3}
    assert sorted(lines[1]["result"]) == [1, 3, 16]
    assert lines[2]["result"] == [True, False, False]
    assert lines[4] == {"id": 4, "result": "bye"}
