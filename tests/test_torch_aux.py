"""The port's auxiliary modules against the JAX package's, mirroring
``tests/test_aux.py``: ``BuildConfig`` / ``build_index``
(``suffix_torch/utils/config.py``), ``device_trace``
(``utils/profiling.py``; its recorder in ``test_torch_profiling.py``) on
the CPU, ``warm`` and ``warm_sharded`` (``utils/warmup.py``) at a small
size, and the examples
(``suffix_torch/examples/``) run on the CPU. The sharded build of
``BuildConfig(sharded=True)`` and ``warm_sharded`` run over 4 gloo ranks
started for the call (``parallel/launch.py``). Tolerance: exact
equality.
"""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch.utils.config import (DEFAULT_BUILD, DEFAULT_QUERY,  # noqa: E402
                                       BuildConfig, QueryConfig, build_index)
from suffix_torch.utils.profiling import device_trace  # noqa: E402
from suffix_torch.utils.warmup import warm, warm_sharded  # noqa: E402


@pytest.fixture(scope="module")
def jax_config():
    pytest.importorskip("jax")
    from suffix_tpu.utils import config

    return config


@pytest.mark.parametrize("engine", ["device", "sais", "native", "auto"])
def test_config_build_engines(jax_config, engine):
    st = build_index("banana", BuildConfig(engine=engine), device="cpu")
    assert st.table().tolist() == [5, 3, 1, 0, 4, 2]
    text = "mississippi" * 9
    ref = jax_config.build_index(text, jax_config.BuildConfig(engine=engine))
    got = build_index(text, BuildConfig(engine=engine), device="cpu")
    assert np.array_equal(got.table(), ref.table())


def test_config_fields_match_jax(jax_config):
    import dataclasses

    for port, ref in ((DEFAULT_BUILD, jax_config.DEFAULT_BUILD),
                      (DEFAULT_QUERY, jax_config.DEFAULT_QUERY),
                      (QueryConfig(max_batch=8),
                       jax_config.QueryConfig(max_batch=8))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    with pytest.raises(dataclasses.FrozenInstanceError):
        DEFAULT_BUILD.engine = "sais"


def test_config_sharded_raises(jax_config, tmp_path):
    # Once a stub that raised; now JAX's test_config_sharded, stepped with
    # a checkpoint over 4 ranks (one file a rank).
    want = [10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2]
    ref = jax_config.build_index("mississippi", jax_config.BuildConfig(
        sharded=True, n_devices=4, checkpoint_path=str(tmp_path / "j.npz")))
    st = build_index("mississippi", BuildConfig(
        sharded=True, n_devices=4, checkpoint_path=str(tmp_path / "ck.npz")),
        device="cpu")
    assert st.table().tolist() == ref.table().tolist() == want
    assert st.text() == ref.text() == "mississippi"
    assert sorted(p.name for p in tmp_path.glob("ck.npz.p?")) == [
        f"ck.npz.p{r}" for r in range(4)]


def test_device_trace_writes_chrome_trace(tmp_path):
    from torch.profiler import record_function

    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)):
        with record_function("P1_initial_sort"):
            torch.sort(torch.arange(1000, 0, -1))
    trace = json.loads((log_dir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "P1_initial_sort" in names


def test_warm_small(capsys):
    timings = warm(1 << 17, query_batches=(8,), query_lens=(8, 16),
                   device="cpu")
    names = [n for n, _ in timings]
    assert names == [
        "build n=131072 (init_words=4)",
        "adaptive build n=131072 sigma=4 (3b x 30ch)",
        "query_index n=131072",
        "queries q=8 m=8 n=131072",
        "queries q=8 m=16 n=131072",
        "lcp n=131072",
    ]
    assert all(dt >= 0 for _, dt in timings)
    assert "warmed query_index n=131072" in capsys.readouterr().out
    assert [n for n, _ in warm(100, query_batches=(), lcp=False,
                                verbose=False, device="cpu")] == [
        "build n=128 (init_words=4)", "query_index n=128"]
    # warm_sharded over 4 ranks: JAX's program names at the same bucket.
    pytest.importorskip("jax")
    from suffix_tpu.utils.warmup import warm_sharded as jax_warm_sharded

    got = warm_sharded(1000, 4, verbose=False, device="cpu")
    assert [n for n, _ in got] == [
        n for n, _ in jax_warm_sharded(1000, 4, verbose=False)] == [
        "sharded build L=256 D=4", "sharded initial rank L=256 D=4",
        "sharded round step L=256 D=4"]


@pytest.mark.parametrize("name", ["basic", "anatomy", "batched_search",
                                  "multidoc"])
def test_examples_run_on_cpu(capsys, name):
    mod = importlib.import_module(f"suffix_torch.examples.{name}")
    out = mod.main(device="cpu")
    printed = capsys.readouterr().out
    assert printed
    if name == "batched_search":
        assert f"total occurrences: {out}" in printed
    if name == "multidoc":
        assert "[(0, 4), (2, 0), (2, 6)]" in printed
