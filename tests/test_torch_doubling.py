"""The port's default build (``suffix_torch/ops/prefix_doubling.py``,
``engine="device"``) against the JAX package's
(``suffix_tpu/ops/prefix_doubling.py``) and the naive oracle.

Every corpus class of the JAX package's own tests (``test_adaptive_pack``,
``test_two_phase``, ``test_periodic``, ``test_conformance``) goes through
both packages with the same routing gates: the suffix arrays and the route
labels must be equal. ``collect_stats`` is held against
``suffix_tpu.utils.metrics.build_stats``. The patched route's own battery
is ``tests/test_torch_patched.py``. JAX is imported by a fixture, so that
the CUDA legs
(marker ``gpu``) run on a machine without it:
``python -m pytest tests/test_torch_doubling.py -m gpu --noconftest``.
Tolerance: exact equality (every array is integer).
"""

import hashlib
import pathlib
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.ops import prefix_doubling as pd  # noqa: E402
from suffix_torch.ops.naive import naive_table  # noqa: E402
from suffix_torch.ops.padding import PAD  # noqa: E402
from suffix_torch.utils import profiling as P  # noqa: E402
from suffix_torch.utils.verify import verify_suffix_array  # noqa: E402

import doubling_oracle as oracle  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
GOLDEN_SA = {  # tests/test_golden.py
    "AP009048_10000":
        "335641df720e6a760955d891723fa48fc1554248ac89a44b1a3f4a36eaa0fdc3",
    "AP009048_100000":
        "d674074d481d76d7ac4e4ae4fe5df93a458a3b6fcb483ac92190babc52029694",
}


@pytest.fixture(scope="module")
def jpd():
    """suffix_tpu's prefix_doubling module."""
    pytest.importorskip("jax")
    from suffix_tpu.ops import prefix_doubling

    return prefix_doubling


@pytest.fixture
def gates(monkeypatch, jpd):
    """Set routing gates on both packages at once."""

    def set_gates(**values):
        for mod in (pd, jpd):
            for name, value in values.items():
                monkeypatch.setattr(mod, name, value)

    return set_gates


def _port_sa(arr: np.ndarray, **kw) -> np.ndarray:
    return pd.suffix_array_bytes(arr, device="cpu", **kw)


def _assert_parity(jpd, arr: np.ndarray, oracle: bool = True) -> str:
    """Port and JAX agree on the SA and the route label; returns it."""
    n_pad = pd.bucket_size(arr.size)
    _, label = pd.device_build_closure(arr, n_pad, device="cpu")
    _, jlabel = jpd.device_build_closure(arr, n_pad)
    assert label == jlabel
    got = _port_sa(arr)
    assert got.dtype == np.uint32
    assert np.array_equal(got, jpd.suffix_array_bytes(arr)), label
    if oracle:
        assert np.array_equal(got, naive_table(arr.tobytes())), label
    return label


def _tiled(block: bytes, n: int) -> np.ndarray:
    b = np.frombuffer(block, np.uint8)
    return np.tile(b, n // b.size + 1)[:n]


def _planted(rng, n):
    """tests/test_two_phase.py sparse_repeats."""
    base = rng.integers(0, 26, n, dtype=np.uint8) + 97
    for _ in range(max(1, n // 200)):
        src = int(rng.integers(0, max(1, n - 64)))
        dst = int(rng.integers(0, max(1, n - 64)))
        base[dst:dst + 24] = base[src:src + 24]
    return base


def _textish(rng, n):
    from suffix_tpu.utils.textgen import text_corpus

    return text_corpus(max(n, 64), seed=int(rng.integers(1 << 30)),
                       boilerplate_bytes=64, boilerplate_copies=4)[:n]


ADAPTIVE_CASES = {  # tests/test_adaptive_pack.py
    "dna": lambda rng, n: rng.integers(0, 4, n, dtype=np.uint8) + 97,
    "binary_alpha": lambda rng, n: rng.integers(0, 2, n, dtype=np.uint8) + 65,
    "sigma17": lambda rng, n: rng.integers(100, 117, n, dtype=np.uint8),
    "all_equal": lambda rng, n: np.full(n, 97, dtype=np.uint8),
    "period7": lambda rng, n: _tiled(b"abcabz!", n),
}

TWO_PHASE_CASES = {  # tests/test_two_phase.py
    "text_like": _textish,
    "dna": lambda rng, n: rng.integers(0, 4, n, dtype=np.uint8) + 97,
    "tiled": lambda rng, n: _tiled(b"abracadabra-zyx!", n),
    "all_equal": lambda rng, n: np.full(n, 97, np.uint8),
    "binary": lambda rng, n: rng.integers(0, 2, n, dtype=np.uint8) + 48,
    "random_bytes": lambda rng, n: rng.integers(0, 256, n, dtype=np.uint8),
    "sparse_repeats": _planted,
}


@pytest.mark.parametrize("name", sorted(ADAPTIVE_CASES))
def test_adaptive_parity(jpd, gates, name):
    gates(ADAPTIVE_PACK_MIN=16)
    rng = np.random.default_rng(len(name))
    for n in (31, 300, 2048, 5000):
        _assert_parity(jpd, ADAPTIVE_CASES[name](rng, n), oracle=n <= 2048)


@pytest.mark.parametrize("name", sorted(TWO_PHASE_CASES))
def test_two_phase_parity(jpd, gates, name):
    gates(ADAPTIVE_PACK_MIN=16, TWO_PHASE_MIN=16, TWO_PHASE_FORCE=True)
    rng = np.random.default_rng(len(name) + 100)
    for n in (33, 500, 2048, 6000):
        label = _assert_parity(jpd, TWO_PHASE_CASES[name](rng, n),
                               oracle=n <= 2048)
        assert label.endswith("+2phase") or label.startswith("periodic")


def test_two_phase_engages(gates, monkeypatch):
    gates(ADAPTIVE_PACK_MIN=16, TWO_PHASE_MIN=16, TWO_PHASE_FORCE=True)
    rounds = []
    orig = pd._phase2_round

    def spy(*a, **k):
        rounds.append(True)
        return orig(*a, **k)

    monkeypatch.setattr(pd, "_phase2_round", spy)
    arr = _planted(np.random.default_rng(5), 4096)
    assert np.array_equal(_port_sa(arr), naive_table(arr.tobytes()))
    assert rounds, "phase 2 never ran on a sparse-repeat corpus"


def test_two_phase_tie_mass_not_tie_count(jpd, gates):
    """tests/test_two_phase.py: all-size-2 tie groups."""
    gates(ADAPTIVE_PACK_MIN=16, TWO_PHASE_MIN=16, TWO_PHASE_FORCE=True)
    rng = np.random.default_rng(8)
    pieces = []
    for _ in range(300):
        b = bytes(rng.integers(0, 4, size=24, dtype=np.uint8) + 97)
        f1 = bytes(rng.integers(0, 26, size=8, dtype=np.uint8) + 65)
        f2 = bytes(rng.integers(0, 26, size=8, dtype=np.uint8) + 65)
        pieces += [b, f1, b, f2]
    _assert_parity(jpd, np.frombuffer(b"".join(pieces), np.uint8),
                   oracle=False)


PERIODIC_CASES = [  # tests/test_periodic.py
    (b"a", 300), (b"ab", 257), (b"abc", 300), (b"aab", 1000),
    (b"abracadabra-zyx!", 16 * 40 + 7), (b"x" * 63 + b"y", 64 * 12 + 31),
    (bytes(range(97, 104)), 7 * 40 + 5), (bytes([0, 255, 3, 17, 0]), 322),
    (b"abab", 4 * 80 + 3), (b"mississippi-", 12 * 30 + 5),
]


@pytest.mark.parametrize("block,n", PERIODIC_CASES,
                         ids=[f"{b[:6]!r}x{n}" for b, n in PERIODIC_CASES])
def test_periodic_parity(jpd, gates, block, n):
    gates(ADAPTIVE_PACK_MIN=16)
    label = _assert_parity(jpd, _tiled(block, n))
    assert label.startswith("periodic(q=")


def test_periodic_long_period_and_fallthroughs(jpd, gates):
    gates(ADAPTIVE_PACK_MIN=16)
    rng = np.random.default_rng(997)
    block = bytes(rng.integers(0, 26, 997, dtype=np.uint8) + 97)
    assert _assert_parity(jpd, _tiled(block, 997 * 9 + 311)) == \
        "periodic(q=997)"
    # One flipped byte: no exact period; both packages take the patched
    # engine.
    flipped = _tiled(bytes(rng.integers(0, 4, 64, dtype=np.uint8) + 97),
                     64 * 20).copy()
    flipped[700] ^= 1
    assert _assert_parity(jpd, flipped).startswith("patched(q=64,")
    # Too few tiles for the closed form.
    few = _tiled(bytes(rng.integers(0, 4, 300, dtype=np.uint8) + 97), 1200)
    assert not _assert_parity(jpd, few).startswith("periodic")


def test_periodic_at_scale_matches_doubling(jpd, gates):
    gates(ADAPTIVE_PACK_MIN=16)
    rng = np.random.default_rng(1021)
    arr = _tiled(bytes(rng.integers(0, 4, 1021, dtype=np.uint8) + 97),
                 1021 * 60 + 123)
    assert _assert_parity(jpd, arr, oracle=False) == "periodic(q=1021)"
    assert verify_suffix_array(arr, _port_sa(arr))


def test_adaptive_plan_matches_jax(jpd):
    rng = np.random.default_rng(3)
    block = rng.integers(0, 4, 100_001, dtype=np.uint8) + 97
    corpora = [
        (rng.integers(0, 4, 4096, dtype=np.uint8) + 97, 1 << 22),
        (rng.integers(0, 256, 65536, dtype=np.uint8), 1 << 26),
        (np.tile(block, 42)[:1 << 22], 1 << 22),  # the repeat lever
        (np.tile(block[:1000], 50), 1 << 16),
    ]
    for arr, n_pad in corpora:
        got = pd._adaptive_plan(arr, n_pad, with_meta=True)
        want = jpd._adaptive_plan(arr, n_pad, with_meta=True)
        assert got[1:] == want[1:]
        if want[0] is None:
            assert got[0] is None
        else:
            assert np.array_equal(got[0][0], want[0][0])
            assert got[0][1:] == want[0][1:]
        assert (pd._repeat_lcp_lower_bound(arr)
                == jpd._repeat_lcp_lower_bound(arr))
        got_probe, want_probe = pd._period_probe(arr), jpd._period_probe(arr)
        for g, w in zip(got_probe, want_probe):
            assert (g is None) == (w is None)
            if w is not None:
                assert g[:3] == w[:3]


def _near_periodic() -> np.ndarray:
    """>= ADAPTIVE_PACK_MIN bytes, a 1000-byte period with two defects:
    both packages route it to their patched engines."""
    rng = np.random.default_rng(11)
    arr = _tiled(bytes(rng.integers(0, 26, 1000, dtype=np.uint8) + 97),
                 (1 << 17) + 500).copy()
    arr[50_000] ^= 1
    return arr


def test_patched_route_raises(jpd):
    """Formerly the port raised here; now it takes the patched route at
    the default gates, as the JAX package does, and returns its SA."""
    arr = _near_periodic()
    label = _assert_parity(jpd, arr, oracle=False)
    assert label.startswith("patched(q=1000,")
    table = SuffixTable.new(arr.tobytes(), device="cpu").table()
    assert np.array_equal(table, _port_sa(arr))
    assert verify_suffix_array(arr, table)


@pytest.mark.parametrize("padding", ["pow2", "fine"])
def test_padding_matches_jax(jpd, padding):
    rng = np.random.default_rng(7)
    for n in (17, 1100, 4500):
        arr = rng.integers(0, 3, n, dtype=np.uint8) + 97
        got = _port_sa(arr, padding=padding)
        assert np.array_equal(got, jpd.suffix_array_bytes(arr,
                                                          padding=padding))


@pytest.mark.parametrize("name,arr,gate", [
    ("ladder", np.frombuffer(b"banana-mississippi" * 40, np.uint8), {}),
    ("adaptive", np.random.default_rng(1).integers(
        97, 101, 600, dtype=np.uint8), {"ADAPTIVE_PACK_MIN": 16}),
    ("two_phase", _planted(np.random.default_rng(2), 1500),
     {"ADAPTIVE_PACK_MIN": 16, "TWO_PHASE_MIN": 16,
      "TWO_PHASE_FORCE": True}),
    ("periodic", _tiled(b"abcz", 402), {"ADAPTIVE_PACK_MIN": 16}),
])
def test_u64_against_u32_and_oracle(monkeypatch, name, arr, gate):
    for key, value in gate.items():
        monkeypatch.setattr(pd, key, value)
    got = _port_sa(arr, index_dtype="u64")
    assert got.dtype == np.uint64
    assert np.array_equal(got, _port_sa(arr).astype(np.uint64))
    assert np.array_equal(got.astype(np.uint32), naive_table(arr.tobytes()))
    assert _port_sa(arr, index_dtype="auto").dtype == np.uint32


def test_index_dtype_errors():
    with pytest.raises(ValueError, match="index_dtype"):
        _port_sa(np.zeros(4, np.uint8), index_dtype="u16")
    assert _port_sa(np.zeros(0, np.uint8), index_dtype="u64").dtype == \
        np.uint64


@pytest.mark.parametrize("collect_stats", [False, True])
def test_table_index_dtype_errors(collect_stats):
    with pytest.raises(ValueError, match="index_dtype"):
        SuffixTable.new(b"banana", device="cpu", index_dtype="bogus",
                        collect_stats=collect_stats)


DIRECTED = ["apple", "banana", "mississippi", "tgtgtgtgcaccg", "", "a", "ab",
            "aa", "\x00", "☃abc☃"]  # tests/test_conformance.py


@pytest.mark.parametrize("text", DIRECTED, ids=lambda t: repr(t)[:20])
def test_directed_matches_naive(text):
    got = SuffixTable.new(text, device="cpu")
    assert got == SuffixTable.new_naive(text, device="cpu")


@settings(max_examples=150, deadline=None)
@given(st.binary(max_size=96))
def test_prop_bytes_match_naive(b):
    assert np.array_equal(SuffixTable.new(b, device="cpu").table(),
                          naive_table(b))


@settings(max_examples=80, deadline=None)
@given(st.text(alphabet="ab\x00", max_size=48))
def test_prop_small_alphabet(s):
    assert np.array_equal(SuffixTable.new(s, device="cpu").table(),
                          SuffixTable.new_naive(s, device="cpu").table())


@settings(max_examples=30, deadline=None)
@given(st.binary(min_size=1, max_size=40),
       st.integers(min_value=280, max_value=1500))
def test_prop_tiled_forced_gate(block, n):
    # tests/test_periodic.py: the periodic, adaptive or ladder route,
    # whichever the block's structure picks.
    orig = pd.ADAPTIVE_PACK_MIN
    pd.ADAPTIVE_PACK_MIN = 16
    try:
        arr = _tiled(block, n)
        assert np.array_equal(_port_sa(arr), naive_table(arr.tobytes()))
    finally:
        pd.ADAPTIVE_PACK_MIN = orig


@pytest.mark.parametrize("name", sorted(GOLDEN_SA))
def test_golden_sa(name):
    data = (FIXTURES / f"{name}.fasta").read_bytes()
    table = SuffixTable.new(data, device="cpu").table()
    assert hashlib.sha256(table.astype(np.uint32).tobytes()).hexdigest() == \
        GOLDEN_SA[name]


def test_table_matches_jax(jpd, dna_10k):
    import suffix_tpu

    for text in (dna_10k, "the quick brown fox was quick.", b"\xff" * 33):
        assert np.array_equal(SuffixTable.new(text, device="cpu").table(),
                              suffix_tpu.SuffixTable.new(text).table())


def _fixture_pow2() -> bytes:
    """2^17 bytes of the 100 KB fixture: its head again after its end."""
    raw = (FIXTURES / "AP009048_100000.fasta").read_bytes()
    return (raw + raw)[:1 << 17]


STATS_CASES = [
    ("fixture_10k", lambda: (FIXTURES / "AP009048_10000.fasta").read_bytes(),
     {}),
    ("fixture_100k", lambda: (FIXTURES / "AP009048_100000.fasta")
     .read_bytes(), {}),
    ("two_phase", lambda: _planted(np.random.default_rng(4), 3000).tobytes(),
     {"ADAPTIVE_PACK_MIN": 16, "TWO_PHASE_MIN": 16,
      "TWO_PHASE_FORCE": True}),
    ("two_phase_ladder", lambda: np.random.default_rng(6).integers(
        0, 256, 3000, dtype=np.uint8).tobytes(),
     {"TWO_PHASE_MIN": 16, "TWO_PHASE_FORCE": True}),
    ("periodic", lambda: _tiled(b"abracadabra-zyx!", 700).tobytes(),
     {"ADAPTIVE_PACK_MIN": 16}),
    ("empty", lambda: b"", {}),
    # The same classes with no padding slot (n a power of two, n_pad = n).
    ("fixture_8k", lambda: (FIXTURES / "AP009048_10000.fasta")
     .read_bytes()[:1 << 13], {}),
    ("fixture_128k", _fixture_pow2, {}),
    ("two_phase_pow2", lambda: _planted(np.random.default_rng(4), 4096)
     .tobytes(), {"ADAPTIVE_PACK_MIN": 16, "TWO_PHASE_MIN": 16,
                  "TWO_PHASE_FORCE": True}),
    ("two_phase_ladder_pow2", lambda: np.random.default_rng(6).integers(
        0, 256, 4096, dtype=np.uint8).tobytes(),
     {"TWO_PHASE_MIN": 16, "TWO_PHASE_FORCE": True}),
    ("min_bucket", lambda: b"abcabcabcabcabca", {}),
]


@pytest.mark.parametrize("name,text,gate", STATS_CASES,
                         ids=[c[0] for c in STATS_CASES])
def test_collect_stats_match_jax(jpd, gates, name, text, gate):
    """The routing keys and the array are the JAX package's; the
    trajectory is the LCP oracle's. The padding slots take distinct keys
    in the port only, so the trajectories agree where there is none."""
    from suffix_tpu.utils.metrics import build_stats

    gates(**gate)
    raw = text()
    st_ = SuffixTable.new(raw, device="cpu", collect_stats=True)
    sa, want = build_stats(raw)
    got = dict(st_.build_stats)
    assert np.array_equal(st_.table(), sa)
    for key in ("elapsed_s", "bytes_per_s", "device"):
        assert key in got
        got.pop(key)
        want.pop(key)
    if got.get("engine_family") in ("classic", "two_phase"):
        traj = {k: got[k] for k in oracle.TRAJECTORY_KEYS if k in got}
        assert traj == oracle.trajectory(raw, sa, got)
    if len(raw) == got["n_pad"]:
        assert got == want
    else:
        assert ({k: v for k, v in got.items()
                 if k not in oracle.TRAJECTORY_KEYS}
                == {k: v for k, v in want.items()
                    if k not in oracle.TRAJECTORY_KEYS})


def _with_copies(rng, n: int, sigma: int) -> np.ndarray:
    """Random bytes with a few copies of up to 300 bytes planted."""
    arr = rng.integers(0, sigma, n, dtype=np.uint8) + 97
    for _ in range(3):
        length = int(rng.integers(20, min(300, n // 3)))
        src, dst = rng.integers(0, n - length, 2)
        arr[dst:dst + length] = arr[src:src + length]
    return arr


@pytest.mark.parametrize("seed", range(4))
def test_rounds_do_not_depend_on_padding(seed):
    """A text takes the rounds its own LCPs need under either padding:
    the padding slots never tie."""
    rng = np.random.default_rng(100 + seed)
    arr = _with_copies(rng, (1100, 1500, 2300, 2900)[seed],
                       (2, 4, 26)[seed % 3])
    raw = arr.tobytes()
    runs = {}
    for padding in ("pow2", "fine"):
        stats = {}
        before = P.finished("job")
        with P.root("job"):
            sa = pd.suffix_array_bytes(arr, padding=padding, device="cpu",
                                       stats=stats)
        (job,) = [r for r in P.finished("job")
                  if r["id"] not in {b["id"] for b in before}]
        assert np.array_equal(sa, naive_table(raw))
        want = oracle.trajectory(raw, sa, stats)
        assert stats["rounds"] == want["rounds"] >= 1
        assert job["counters"].get("rounds", 0) == want["rounds"]
        runs[padding] = stats
    assert runs["pow2"]["n_pad"] != runs["fine"]["n_pad"]
    assert runs["pow2"]["rounds"] == runs["fine"]["rounds"]
    assert runs["pow2"]["tie_trajectory"] == runs["fine"]["tie_trajectory"]


@pytest.mark.parametrize("gate,route", [({}, "ladder(4w)"),
                                        ({"ADAPTIVE_PACK_MIN": 16},
                                         "adaptive(3b x ")],
                         ids=["ladder", "adaptive"])
def test_classic_route_reads_the_tie_mass_for_stats_only(monkeypatch, gate,
                                                         route):
    """The classic route reads the tie mass only where something reads
    it: never in a plain build, once for the initial sort and once a
    round with ``collect_stats``. The array, the label, the rounds and
    the readbacks are the same either way."""
    for key, value in gate.items():
        monkeypatch.setattr(pd, key, value)
    calls = []
    tie_mass = pd._tie_mass

    def spy(diff):
        calls.append(True)
        return tie_mass(diff)

    monkeypatch.setattr(pd, "_tie_mass", spy)
    raw = _with_copies(np.random.default_rng(7), 3000, 4).tobytes()
    runs = []
    for collect_stats in (False, True):
        calls.clear()
        before = {r["id"] for r in P.finished("build")}
        st_ = SuffixTable.new(raw, device="cpu", collect_stats=collect_stats)
        (job,) = [r for r in P.finished("build") if r["id"] not in before]
        assert job["attrs"]["route"].startswith(route)
        runs.append((st_, job, len(calls)))
    (plain, job0, calls0), (stats_st, job1, calls1) = runs
    assert np.array_equal(plain.table(), naive_table(raw))
    assert np.array_equal(plain.table(), stats_st.table())
    assert job0["attrs"]["route"] == job1["attrs"]["route"] \
        == stats_st.build_stats["engine"]
    rounds = job0["counters"]["rounds"]
    assert rounds == job1["counters"]["rounds"] \
        == stats_st.build_stats["rounds"] >= 1
    assert job0["counters"]["host_syncs"] == job1["counters"]["host_syncs"]
    assert calls0 == 0
    assert calls1 == rounds + 1


@pytest.mark.parametrize("n", [0, 1, 5, 16, 100, 600])
def test_padded_sa_orders_the_padding(n):
    """``_suffix_array_padded`` is the suffix array of the whole padded
    sequence: the padding suffixes first, shortest first, then the text's."""
    rng = np.random.default_rng(n)
    n_pad = pd.bucket_size(n)
    padded = np.full(n_pad, PAD, np.int32)
    padded[:n] = rng.integers(97, 100, n)
    if n >= 100:
        padded[60:90] = padded[0:30]
    for iw in (2, 4):
        got = pd._suffix_array_padded(torch.from_numpy(padded), iw).numpy()
        want = sorted(range(n_pad), key=lambda i: padded[i:].tolist())
        assert got.tolist() == want
        assert got[:n_pad - n].tolist() == list(range(n_pad - 1, n - 1, -1))


def test_last_flag_index_matches_cummax(jpd):
    import jax

    rng = np.random.default_rng(12)
    for n in (1, 7, 1000):
        flag = rng.random(n) < 0.2
        flag[0] = True
        j = np.arange(n)
        want = np.maximum.accumulate(np.where(flag, j, 0))
        got = pd._last_flag_index(torch.from_numpy(flag)).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got, np.asarray(jax.lax.cummax(
            jax.numpy.asarray(np.where(flag, j, 0).astype(np.int32)))))


def test_to_positional_matches_jax(jpd):
    rng = np.random.default_rng(13)
    n = 4096
    dense = np.sort(rng.integers(0, 900, n)).astype(np.int32)
    dense -= dense[0]
    sa = rng.permutation(n).astype(np.int32)
    rank, tied, mass = pd._to_positional(torch.from_numpy(dense),
                                         torch.from_numpy(sa))
    j_rank, j_tied, j_mass = jpd._to_positional(jpd.jnp.asarray(dense),
                                                jpd.jnp.asarray(sa))
    assert mass == int(j_mass) > 0
    assert np.array_equal(rank.numpy(), np.asarray(j_rank))
    # Tied ids first, untied after; the order inside each part is free.
    tied, j_tied = tied.numpy(), np.asarray(j_tied)
    assert np.array_equal(np.sort(tied[:mass]), np.sort(j_tied[:mass]))
    assert np.array_equal(np.sort(tied[mass:]), np.sort(j_tied[mass:]))


def test_word_packing_matches_jax(jpd):
    rng = np.random.default_rng(14)
    text = np.full(256, -1, np.int32)
    text[:200] = rng.integers(0, 256, 200)
    for iw in (2, 3, 4):
        got = pd._initial_words(torch.from_numpy(text), iw)
        want = jpd._initial_words(jpd.jnp.asarray(text), iw)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    codes = np.zeros(256, np.int32)
    codes[:200] = rng.integers(1, 5, 200)
    for n_words, bits, cpw in ((4, 3, 10), (2, 5, 6), (3, 2, 15)):
        got = pd._packed_words(torch.from_numpy(codes), n_words, bits, cpw)
        want = jpd._packed_words(jpd.jnp.asarray(codes), n_words, bits, cpw)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    for n_pad in (16, 1 << 20, 1 << 21, 1 << 24, 1 << 26):
        assert pd.pick_init_words(n_pad) == jpd.pick_init_words(n_pad)


def test_invert_permutation():
    sa = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    vals = torch.tensor([10, 11, 12, 13], dtype=torch.int32)
    assert pd._invert_permutation(sa, vals).tolist() == [11, 13, 10, 12]


def test_chip_smoke_labels_match_jax(jpd):
    """The route labels chip_smoke.py pins for its generated texts and
    the fixtures are the JAX package's."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    dna = np.frombuffer(cs.dna_text(np.random.default_rng(cs.SEED)),
                        np.uint8)
    cases = [(dna, cs.LABEL_DNA),
             (np.frombuffer(cs.dna_repeats(), np.uint8), cs.LABEL_DNA_REPEATS),
             (np.frombuffer(cs.text_repeats(), np.uint8),
              cs.LABEL_TEXT_REPEATS),
             (np.frombuffer(cs.nearrep_text(), np.uint8), cs.LABEL_NEARREP)]
    for name, (_, _, label) in cs.GOLDEN_DEVICE.items():
        cases.append((np.frombuffer((FIXTURES / f"{name}.fasta").read_bytes(),
                                    np.uint8), label))
    for arr, label in cases:
        n_pad = pd.bucket_size(arr.size)
        assert jpd.device_build_closure(arr, n_pad)[1] == label
        assert pd.device_build_closure(arr, n_pad, device="cpu")[1] == label


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CUDA_CORPORA = {
    "ladder": lambda: b"banana-mississippi" * 300,
    "adaptive": lambda: (np.random.default_rng(1).integers(
        0, 4, (1 << 17) + 9, dtype=np.uint8) + 97).tobytes(),
    "periodic": lambda: _tiled(b"abracadabra-zyx!", (1 << 17) + 3).tobytes(),
    "two_phase": lambda: _planted(np.random.default_rng(2),
                                  (1 << 20) + 77).tobytes(),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CUDA_CORPORA))
def test_cuda_default_build(cuda_device, name):
    raw = CUDA_CORPORA[name]()
    st_ = SuffixTable.new(raw, device=cuda_device, collect_stats=True)
    cpu = SuffixTable.new(raw, device="cpu", collect_stats=True)
    assert st_.build_stats["engine"] == cpu.build_stats["engine"]
    assert np.array_equal(st_.table(), cpu.table())
    assert verify_suffix_array(raw, st_.table())
    u64 = pd.suffix_array_bytes(raw, index_dtype="u64", device=cuda_device)
    assert np.array_equal(u64, st_.table().astype(np.uint64))


# Staging on the device: the text's bytes go up once, and the device
# widens them, counts them for the plan and codes them. Each case against
# the host staging that the JAX package does, with the route it takes.
_DNA16 = np.frombuffer(b"ACGTNRYKMSWBDHVX", np.uint8)
STAGING_CASES = {
    "dna_sigma16": (lambda rng: rng.choice(_DNA16, 70_001), {}, "adaptive"),
    # Sigma 225 with a plan of at most 2 words: the plan comes out empty,
    # as it does for English at 2^28 padded slots, so the ladder route
    # runs after the count.
    "sigma225": (lambda rng: rng.integers(16, 241, 70_003, dtype=np.uint8),
                 {"ADAPTIVE_MAX_WORDS": 2}, "ladder"),
    "all_bytes": (lambda rng: np.concatenate([
        np.arange(256, dtype=np.uint8),
        rng.integers(0, 256, 70_000, dtype=np.uint8),
        np.array([0, 255], np.uint8)]), {}, "adaptive"),
    "no_padding": (lambda rng: rng.integers(97, 101, 1 << 17, dtype=np.uint8),
                   {}, "adaptive"),
    "below_plan": (lambda rng: rng.integers(97, 101, 5_000, dtype=np.uint8),
                   {}, "ladder"),
}


def _host_staging(arr: np.ndarray, n_pad: int, lut=None) -> np.ndarray:
    """The host staging: ``arr`` padded with PAD, or ``lut[arr]`` padded
    with 0."""
    if lut is None:
        out = np.full((n_pad,), PAD, np.int32)
        out[:arr.size] = arr
    else:
        out = np.zeros((n_pad,), np.int32)
        out[:arr.size] = lut[arr]
    return out


def _check_staging(arr: np.ndarray, device) -> tuple:
    """Stage ``arr`` on ``device`` as the build does and hold each array to
    the host staging; returns (n_pad, counts or None, plan meta)."""
    n_pad = pd.bucket_size(arr.size)
    padded = pd._stage_text(arr, n_pad, device)
    assert padded.dtype == torch.int32 and padded.device.type == device.type
    assert np.array_equal(padded.cpu().numpy(), _host_staging(arr, n_pad))
    if n_pad < pd.ADAPTIVE_PACK_MIN:
        return n_pad, None, None
    counts = pd._device_byte_counts(padded)
    assert counts.dtype == np.int64
    assert np.array_equal(counts, np.bincount(arr, minlength=256))
    meta = pd._adaptive_plan(arr, n_pad, with_meta=True, counts=counts)
    plan = meta[0]
    if plan is not None:
        codes = pd._code_text(padded, arr.size, plan[0])
        assert np.array_equal(codes.cpu().numpy(),
                              _host_staging(arr, n_pad, plan[0]))
    return n_pad, counts, meta


@pytest.mark.parametrize("name", sorted(STAGING_CASES))
def test_device_staging_matches_host_and_jax(jpd, gates, name):
    make, gate, route = STAGING_CASES[name]
    gates(**gate)
    arr = make(np.random.default_rng(17))
    n_pad, counts, meta = _check_staging(arr, torch.device("cpu"))
    if meta is not None:
        want = jpd._adaptive_plan(arr, n_pad, with_meta=True)
        assert meta[1:] == want[1:]
        assert (meta[0] is None) == (want[0] is None)
        if want[0] is not None:
            assert np.array_equal(meta[0][0], want[0][0])
            assert meta[0][1:] == want[0][1:]
    assert _assert_parity(jpd, arr, oracle=False).startswith(route)


def test_byte_counts_in_slices(monkeypatch):
    # Slices of COUNT_SLICE values each, summed in int64: the u64 route's
    # counts, which one int32 histogram could overflow at 2^31 values.
    arr = np.random.default_rng(5).integers(0, 256, 10_007, dtype=np.uint8)
    padded = pd._stage_text(arr, 1 << 14, torch.device("cpu"))
    want = np.bincount(arr, minlength=256)
    for size in (1000, 4096, 1 << 14, 1 << 30):
        monkeypatch.setattr(pd, "COUNT_SLICE", size)
        assert np.array_equal(pd._device_byte_counts(padded), want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STAGING_CASES))
def test_cuda_staging_matches_host(cuda_device, monkeypatch, name):
    make, gate, _ = STAGING_CASES[name]
    for key, value in gate.items():
        monkeypatch.setattr(pd, key, value)
    arr = make(np.random.default_rng(17))
    n_pad, counts, _ = _check_staging(arr, cuda_device)
    if counts is not None:
        monkeypatch.setattr(pd, "COUNT_SLICE", 1001)
        padded = pd._stage_text(arr, n_pad, cuda_device)
        assert np.array_equal(pd._device_byte_counts(padded), counts)
    got = pd.suffix_array_bytes(arr, device=cuda_device)
    assert np.array_equal(got, _port_sa(arr))


@pytest.mark.gpu
def test_cuda_staging_frees_the_text_and_counts_its_copies(cuda_device):
    from suffix_torch.ops import kernels

    arr = np.random.default_rng(9).choice(_DNA16, 70_001)
    n, n_pad = arr.size, pd.bucket_size(arr.size)
    kernels.byte_histogram(torch.zeros(4, dtype=torch.int32,
                                       device=cuda_device), 256)
    torch.cuda.synchronize(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    dispatch, label = pd.device_build_closure(arr, n_pad, device=cuda_device)
    assert label.startswith("adaptive")
    # The closure holds the coded words alone: not the bytes (n) and not
    # the widened text (another 4 * n_pad).
    held = torch.cuda.memory_allocated(cuda_device) - base
    assert 4 * n_pad <= held < 4 * n_pad + n // 2
    assert np.array_equal(dispatch().cpu().numpy()[n_pad - n:],
                          _port_sa(arr))
    del dispatch

    launches = kernels.byte_histogram.launches
    before = P.finished("build")
    SuffixTable.new(arr.tobytes(), device=cuda_device)
    (got,) = [r for r in P.finished("build")
              if r["id"] not in {b["id"] for b in before}]
    assert got["counters"]["h2d_bytes"] == n
    # The padding slots stay on the card: only the n kept slots come down.
    assert got["counters"]["d2h_bytes"] == 4 * n
    assert kernels.byte_histogram.launches == launches + 1


def _near_periodic_small() -> np.ndarray:
    """A 101-byte period with one defect: the patched route at
    ``ADAPTIVE_PACK_MIN = 16``."""
    block = np.random.default_rng(11).integers(97, 123, 101, dtype=np.uint8)
    arr = _tiled(block.tobytes(), 101 * 37 + 19).copy()
    arr[2020] = ord("!")
    return arr


# The array each route returns is the table as the table keeps it. Each
# case: (text, gates, index_dtype, route label prefix).
KEPT_CASES = {
    "periodic": (lambda: _tiled(b"abcz", 402), {"ADAPTIVE_PACK_MIN": 16},
                 "u32", "periodic"),
    "patched": (_near_periodic_small, {"ADAPTIVE_PACK_MIN": 16}, "u32",
                "patched"),
    "adaptive": (lambda: np.random.default_rng(1).integers(
        97, 101, 600, dtype=np.uint8), {"ADAPTIVE_PACK_MIN": 16}, "u32",
        "adaptive"),
    "two_phase": (lambda: _planted(np.random.default_rng(2), 1500),
                  {"ADAPTIVE_PACK_MIN": 16, "TWO_PHASE_MIN": 16,
                   "TWO_PHASE_FORCE": True}, "u32", "adaptive"),
    "ladder": (lambda: np.frombuffer(b"banana-mississippi" * 40, np.uint8),
               {}, "u32", "ladder"),
    "full_bucket": (lambda: np.random.default_rng(3).integers(
        97, 101, 4096, dtype=np.uint8), {}, "u32", "ladder"),
    "u64": (lambda: np.frombuffer(b"banana-mississippi" * 40, np.uint8),
            {}, "u64", "ladder"),
    "empty": (lambda: np.zeros(0, np.uint8), {}, "u32", "ladder"),
}


def _host_bytes(arr: np.ndarray) -> int:
    """Bytes of the host memory behind ``arr``: the buffer of the array
    that owns it, or the storage of the tensor it views."""
    base = arr
    while isinstance(base, np.ndarray) and base.base is not None:
        base = base.base
    if isinstance(base, torch.Tensor):
        return base.untyped_storage().nbytes()
    return base.nbytes


def _check_kept_table(monkeypatch, name: str, device) -> None:
    """Build ``KEPT_CASES[name]`` twice on ``device``: each array is the
    oracle's SA, unsigned, of length n, C-contiguous and writable, shares
    no memory with the other, and holds exactly its n slots of host
    memory (no padding kept alive)."""
    make, gate, index_dtype, route = KEPT_CASES[name]
    for key, value in gate.items():
        monkeypatch.setattr(pd, key, value)
    arr = make()
    n = arr.size
    out_dtype = np.uint64 if index_dtype == "u64" else np.uint32
    stats: dict = {}
    got = pd.suffix_array_bytes(arr, index_dtype=index_dtype,
                                device=device, stats=stats)
    assert stats["engine"].startswith(route), stats["engine"]
    if name == "full_bucket":
        assert stats["n_pad"] == n
    assert got.dtype == out_dtype and got.shape == (n,)
    assert got.flags["C_CONTIGUOUS"] and got.flags["WRITEABLE"]
    assert np.array_equal(got, naive_table(arr.tobytes()))
    assert _host_bytes(got) == got.itemsize * n
    again = pd.suffix_array_bytes(arr, index_dtype=index_dtype,
                                  device=device)
    assert np.array_equal(again, got)
    assert not np.shares_memory(got, again)


@pytest.mark.parametrize("name", sorted(KEPT_CASES))
def test_returned_table_is_its_own_n_slots(monkeypatch, name):
    _check_kept_table(monkeypatch, name, torch.device("cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(KEPT_CASES))
def test_cuda_returned_table_is_its_own_n_slots(cuda_device, monkeypatch,
                                                name):
    _check_kept_table(monkeypatch, name, cuda_device)
