"""The port's suffix-array certificate (``suffix_torch/utils/verify.py``,
host and device forms, ``SuffixTable.verify``) and build metrics
(``suffix_torch/utils/metrics.py``) against the JAX package's: the cases
and perturbations of ``tests/test_verify.py`` and the schema of
``tests/test_aux.py``. The device form runs on the CPU's torch here and
on CUDA in the ``gpu`` leg (``python -m pytest
tests/test_torch_verify_metrics.py -m gpu --noconftest``). JAX is
imported by a fixture. Tolerance: exact equality (stats: every value but
the timings).
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.utils import metrics  # noqa: E402
from suffix_torch.utils.verify import verify_suffix_array  # noqa: E402

CASES = ["banana", "mississippi", "", "a", "aa", "aaaa", "abab",
         "tgtgtgtgcaccg", "\x00\x00a", "☃abc☃"]
FORMS = [False, "cpu"]  # the host form, the device form on the CPU
TIMING = ("elapsed_s", "bytes_per_s")


@pytest.fixture(scope="module")
def jax_side():
    """(suffix_tpu.SuffixTable, JAX's verify_suffix_array, JAX's
    utils.metrics)."""
    pytest.importorskip("jax")
    import suffix_tpu
    from suffix_tpu.utils import metrics as jmetrics
    from suffix_tpu.utils.verify import verify_suffix_array as jverify

    return suffix_tpu.SuffixTable, jverify, jmetrics


@pytest.mark.parametrize("device", FORMS)
@pytest.mark.parametrize("text", CASES)
def test_accepts_true_sa(jax_side, text, device):
    JTable, jverify, _ = jax_side
    st_ = SuffixTable.new(text, device="cpu")
    raw = st_.text_bytes()
    assert verify_suffix_array(raw, st_.table(), device=device)
    assert jverify(raw, st_.table(), device=bool(device))
    assert st_.verify(device=bool(device))
    assert JTable.new(text).verify(device=bool(device))


@pytest.mark.parametrize("device", FORMS)
def test_rejects_perturbations(jax_side, device):
    _, jverify, _ = jax_side
    rng = np.random.default_rng(4)
    for _ in range(20):
        n = int(rng.integers(2, 200))
        sigma = int(rng.choice([2, 4, 26]))
        raw = bytes(rng.integers(97, 97 + sigma, size=n,
                                 dtype=np.uint8).tolist())
        sa = SuffixTable.new(raw, device="cpu").table().astype(np.int64)
        i = int(rng.integers(0, n - 1))
        swapped = sa.copy()  # two adjacent entries swapped: not sorted
        swapped[i], swapped[i + 1] = swapped[i + 1], swapped[i]
        dup = sa.copy()  # an entry duplicated: not a permutation
        dup[i] = dup[i + 1]
        out = sa.copy()  # an entry out of range
        out[i] = n
        for bad in (swapped, dup, out):
            assert not verify_suffix_array(raw, bad, device=device)
            assert not jverify(raw, bad, device=bool(device))
        assert verify_suffix_array(raw, sa, device=device)
    assert not verify_suffix_array(b"abc", np.array([0, 1], np.uint32),
                                   device=device)


@pytest.mark.parametrize("device", FORMS)
def test_rejects_wide_entries(device):
    """Entries past int32 (a uint32 table's top bit, an int64 that would
    wrap to a valid offset) fail (a) on both forms."""
    raw = b"abracadabra"
    sa = SuffixTable.new(raw, device="cpu").table()
    top = sa.copy()
    top[3] = 0x80000000 + int(sa[3])
    assert not verify_suffix_array(raw, top, device=device)
    wrap = sa.astype(np.int64)
    wrap[3] += 1 << 32
    assert not verify_suffix_array(raw, wrap, device=device)
    neg = sa.astype(np.int64)
    neg[0] = -1
    assert not verify_suffix_array(raw, neg, device=device)


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=2, max_size=80), st.integers(0, 10**9))
def test_qc_reject_random_permutations(jax_side, raw, seed):
    _, jverify, _ = jax_side
    rng = np.random.default_rng(seed)
    sa = SuffixTable.new(raw, device="cpu").table().astype(np.int64)
    perm = rng.permutation(len(raw))
    expect = bool(np.array_equal(perm, sa))
    assert verify_suffix_array(raw, perm) == expect
    assert verify_suffix_array(raw, perm, device="cpu") == expect
    assert jverify(raw, perm) == expect


def test_prefix_suffix_ordering_cases():
    # Prefix suffixes (the sentinel rule): in "aa...a" every suffix is a
    # prefix of the one ranked above it.
    for raw in (b"aaaaaaa", b"abababab", b"aabaab"):
        sa = SuffixTable.new(raw, device="cpu").table()
        assert verify_suffix_array(raw, sa, device="cpu")
        rev = sa[::-1].copy()
        assert not verify_suffix_array(raw, rev)
        assert not verify_suffix_array(raw, rev, device="cpu")


def test_verify_on_loaded_parts(dna_10k):
    st_ = SuffixTable.new(dna_10k, engine="native", device="cpu")
    bad = st_.table().copy()
    bad[[500, 501]] = bad[[501, 500]]
    broken = SuffixTable.from_parts(dna_10k, bad, device="cpu")
    assert st_.verify() and st_.verify(device=True)
    assert not broken.verify() and not broken.verify(device=True)


# ---------------------------------------------------------------- metrics


def _near_periodic() -> bytes:
    """tests/test_aux.py's near-periodic corpus: the patched engine."""
    block = bytes(np.random.default_rng(9).integers(97, 123, 257,
                                                    dtype=np.uint8))
    arr = np.tile(np.frombuffer(block, np.uint8), 700)[: 1 << 17].copy()
    arr[70000] ^= 1
    return arr.tobytes()


def _same_stats(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in metrics.REQUIRED_KEYS:
        assert key in got, key
    assert got["elapsed_s"] >= 0
    assert (got["bytes_per_s"] > 0) == (got["n_bytes"] > 0)
    assert ({k: v for k, v in got.items() if k not in TIMING}
            == {k: v for k, v in want.items() if k not in TIMING})


@pytest.mark.parametrize("engine,data", [
    ("device", np.random.default_rng(0).integers(
        65, 91, 4096, dtype=np.uint8).tobytes()),
    ("device", _near_periodic()),
    ("native", b"mississippi" * 30),
    ("sais", b"mississippi" * 30),
    ("native", b""),
], ids=["classic", "patched", "native", "sais", "native_empty"])
def test_build_stats_match_jax(jax_side, engine, data):
    _, _, jmetrics = jax_side
    assert metrics.REQUIRED_KEYS == jmetrics.REQUIRED_KEYS
    assert metrics.SCHEMA_VERSION == jmetrics.SCHEMA_VERSION
    sa, stats = metrics.build_stats(data, engine=engine, device="cpu")
    jsa, jstats = jmetrics.build_stats(data, engine=engine)
    assert np.array_equal(sa, jsa) and sa.dtype == jsa.dtype
    _same_stats(stats, jstats)
    assert json.loads(metrics.stats_json(stats)) == json.loads(
        metrics.stats_json(stats))
    assert metrics.stats_json(stats) == jmetrics.stats_json(
        {**jstats, **{k: stats[k] for k in TIMING}})


def test_build_stats_two_phase_matches_jax(jax_side, monkeypatch):
    _, _, jmetrics = jax_side
    from suffix_torch.ops import prefix_doubling as pd
    from suffix_tpu.ops import prefix_doubling as jpd

    data = np.random.default_rng(3).integers(32, 127, 1 << 17,
                                             dtype=np.uint8).tobytes()
    for mod in (pd, jpd):
        monkeypatch.setattr(mod, "TWO_PHASE_MIN", 1 << 16)
    sa, stats = metrics.build_stats(data, device="cpu")
    jsa, jstats = jmetrics.build_stats(data)
    assert stats["engine_family"] == "two_phase"
    assert np.array_equal(sa, jsa)
    _same_stats(stats, jstats)


def test_build_stats_engines(jax_side):
    with pytest.raises(ValueError, match="ROADMAP"):
        metrics.build_stats(b"abc", engine="sharded", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        metrics.build_stats(b"abc", engine="naive", device="cpu")
    _, stats = metrics.build_stats(b"abc", engine="device",
                                   index_dtype="u64", device="cpu")
    _, jstats = jax_side[2].build_stats(b"abc", engine="device",
                                        index_dtype="u64")
    _same_stats(stats, jstats)


def test_collect_stats_table_and_checkpoint(jax_side, tmp_path):
    from suffix_torch.utils.checkpoint import load_index, save_index

    text = b"abracadabra" * 50
    st_ = SuffixTable.new(text, engine="native", device="cpu",
                          collect_stats=True)
    ref = jax_side[0].new(text, engine="native", collect_stats=True)
    _same_stats(st_.build_stats, ref.build_stats)
    assert st_.build_stats["engine"] == "native-sais"
    p = str(tmp_path / "idx.npz")
    save_index(p, st_, build_stats=st_.build_stats)
    st2 = load_index(p, device="cpu")
    assert st2.build_stats == st_.build_stats
    assert np.array_equal(st2.table(), ref.table())


# ---------------------------------------------------------------- CUDA leg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("text", CASES + ["ab" * 5000])
def test_cuda_verify_device(cuda_device, text):
    st_ = SuffixTable.new(text, device=cuda_device)
    assert st_.verify(device=True) and st_.verify()
    if len(st_) >= 2:
        bad = st_.table().copy()
        bad[[0, 1]] = bad[[1, 0]]
        broken = SuffixTable.from_parts(text, bad, device=cuda_device)
        assert not broken.verify(device=True) and not broken.verify()
    _, stats = metrics.build_stats(st_.text_bytes(), device=cuda_device)
    assert stats["device"] == torch.cuda.get_device_name(cuda_device)
