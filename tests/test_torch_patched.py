"""The port's patched near-periodic engine (``suffix_torch/ops/patched.py``)
against the JAX package's (``suffix_tpu/ops/patched.py``) and the naive
oracle.

The cases of ``tests/test_patched.py`` drive both engines directly on the
same corpus and period: equal suffix arrays, equal labels, and equal
phase-A stats (``h0``, ``rounds``, ``closed_form``) where JAX's native
library is present, since its rotation width comes from there. The
routing cases go through both routers with ``ADAPTIVE_PACK_MIN`` set on
both packages. JAX is imported by a fixture, so that the CUDA leg (marker
``gpu``) runs on a machine without it:
``python -m pytest tests/test_torch_patched.py -m gpu --noconftest``.
Tolerance: exact equality (every array is integer).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.ops import patched  # noqa: E402
from suffix_torch.ops import prefix_doubling as pd  # noqa: E402
from suffix_torch.ops.naive import naive_table  # noqa: E402
from suffix_torch.utils.verify import verify_suffix_array  # noqa: E402


@pytest.fixture(scope="module")
def jax_mods():
    """(suffix_tpu.ops.patched, suffix_tpu.ops.prefix_doubling,
    suffix_tpu.native)."""
    pytest.importorskip("jax")
    from suffix_tpu import native
    from suffix_tpu.ops import patched as jpatched
    from suffix_tpu.ops import prefix_doubling as jpd

    return jpatched, jpd, native


@pytest.fixture
def gates(monkeypatch, jax_mods):
    """Set a routing gate on both packages at once."""

    def set_gates(module_name, **values):
        for mod in (pd if module_name == "pd" else patched,
                    jax_mods[1] if module_name == "pd" else jax_mods[0]):
            for name, value in values.items():
                monkeypatch.setattr(mod, name, value)

    return set_gates


def near_periodic(block: bytes, n: int, mutations) -> np.ndarray:
    """tests/test_patched.py: tile ``block`` to ``n`` bytes, then patch."""
    b = np.frombuffer(block, np.uint8)
    arr = np.tile(b, n // b.size + 1)[:n].copy()
    for p, v in mutations:
        arr[p] = v
    return arr


def _defects(arr: np.ndarray, q: int) -> np.ndarray:
    return np.flatnonzero(arr[q:] != arr[:arr.size - q]).astype(np.int64)


def assert_engines_agree(jax_mods, arr: np.ndarray, q: int) -> dict:
    """Both engines on (arr, q): SA equal to each other and to the oracle,
    labels equal, stats equal where JAX has its native library. Returns
    the port's stats."""
    jpatched, jpd, native = jax_mods
    n = int(arr.size)
    n_pad = pd.bucket_size(n)
    defects = _defects(arr, q)
    stats, jstats = {}, {}
    disp, label = patched.patched_dispatch(arr, q, defects, n_pad,
                                           stats=stats, device="cpu")
    jdisp, jlabel = jpatched.patched_dispatch(arr, q, defects, n_pad,
                                              stats=jstats)
    assert label == jlabel and label.startswith("patched(")
    sa = disp().numpy()[n_pad - n:].astype(np.uint32)
    jsa = np.asarray(jdisp())[n_pad - n:].astype(np.uint32)
    assert np.array_equal(sa, jsa), label
    assert np.array_equal(sa, naive_table(arr.tobytes())), label
    if native.available():
        assert stats == jstats
    else:
        for key in ("engine_family", "period", "defects", "tiles"):
            assert stats[key] == jstats[key]
    return stats


BLOCK16 = b"gattacacgtagGCA!"
BLOCK7 = b"zyx?abc"

PARITY_CASES = [  # tests/test_patched.py:45-71
    (BLOCK16, 16 * 40 + 7, [(333, ord("Q"))]),
    (BLOCK16, 16 * 40 + 7, [(0, ord("Q")), (16 * 40 + 6, ord("R"))]),
    (BLOCK16, 16 * 40 + 9, [(16 * 40 + 2, ord("T"))]),
    (BLOCK16, 16 * 32, [(16 * 10 - 1, ord("#")), (16 * 10, ord("%"))]),
    (BLOCK7, 7 * 64 + 3, [(100, ord("J")), (101, ord("K"))]),
    (BLOCK16, 16 * 24, [(16 * 5 + 3, BLOCK16[3])]),
    (BLOCK16, 16 * 48, [(77, ord("Q"))]),
    (BLOCK16, 16 * 48, []),
    (BLOCK7, 7 * 100 + 5, []),
    (BLOCK16, 16 * 40, [(16 * r + 5, ord("0") + r % 8)
                        for r in range(0, 40, 2)]),
    (b"x" * 13 + b"y", 14 * 50 + 6, [(200, ord("z"))]),
    (bytes([0, 255, 3, 17, 0, 128, 9]), 7 * 60 + 2, [(150, 254), (151, 1)]),
]


@pytest.mark.parametrize("block,n,mutations", PARITY_CASES,
                         ids=[f"case{i}" for i in range(len(PARITY_CASES))])
def test_patched_parity(jax_mods, block, n, mutations):
    assert_engines_agree(jax_mods, near_periodic(block, n, mutations),
                         len(block))


def test_patched_q1(jax_mods):
    arr = near_periodic(b"m", 500, [(100, ord("a")), (399, ord("z"))])
    assert_engines_agree(jax_mods, arr, 1)


def test_patched_internal_repeat_block(jax_mods):
    """The period is itself repetitive: rotations share long prefixes."""
    block = b"aab" * 5 + b"x"
    assert_engines_agree(
        jax_mods, near_periodic(block, 16 * 33 + 4, [(250, ord("q"))]), 16)


def test_patched_wrong_q_falls_back(jax_mods):
    """A deliberately wrong period on random text: the defect set is
    dense and exact for it, and the SA is still exact."""
    arr = np.random.default_rng(7).integers(97, 110, 700, dtype=np.uint8)
    assert_engines_agree(jax_mods, arr, 13)


def test_patched_table_budget_refuses(jax_mods):
    jpatched = jax_mods[0]
    rng = np.random.default_rng(3)
    q, k = 4096, 40
    arr = rng.integers(0, 256, q * k, dtype=np.uint8)
    defects = _defects(arr, q)
    assert defects.size > 100_000
    assert patched._patch_tables(arr, q, defects) is None
    assert patched.patched_dispatch(arr, q, defects, q * k,
                                    device="cpu") is None
    assert jpatched.patched_dispatch(arr, q, defects, q * k) is None


def test_patch_tables_match_jax(jax_mods):
    jpatched = jax_mods[0]
    for block, n, mutations in PARITY_CASES:
        arr = near_periodic(block, n, mutations)
        q = len(block)
        got = patched._patch_tables(arr, q, _defects(arr, q))
        want = jpatched._patch_tables(arr, q, _defects(arr, q))
        assert got.keys() == want.keys()
        for key in got:
            assert np.array_equal(got[key], want[key]), key
    sym = np.random.default_rng(2).integers(0, 5, 300)
    assert np.array_equal(patched._host_suffix_ranks(sym),
                          jpatched._host_suffix_ranks(sym))


def _route(jax_mods, arr: np.ndarray) -> str:
    """Both routers on ``arr``: equal labels and suffix arrays; returns
    the label."""
    jpd = jax_mods[1]
    n = int(arr.size)
    n_pad = pd.bucket_size(n)
    disp, label = pd.device_build_closure(arr, n_pad, device="cpu")
    jdisp, jlabel = jpd.device_build_closure(arr, n_pad)
    assert label == jlabel
    got = disp().numpy()[n_pad - n:].astype(np.uint32)
    assert np.array_equal(got, np.asarray(jdisp())[n_pad - n:]
                          .astype(np.uint32)), label
    assert np.array_equal(got, naive_table(arr.tobytes())), label
    return label


def test_routing_picks_patched(jax_mods, gates):
    gates("pd", ADAPTIVE_PACK_MIN=16)
    block = bytes(np.random.default_rng(11).integers(97, 123, 101,
                                                     dtype=np.uint8))
    arr = near_periodic(block, 101 * 37 + 19, [(2020, ord("!"))])
    assert _route(jax_mods, arr).startswith("patched(q=101,defects=")


def test_routing_exact_still_periodic(jax_mods, gates):
    gates("pd", ADAPTIVE_PACK_MIN=16)
    arr = near_periodic(b"abracadabra-zyx!", 16 * 40 + 7, [])
    assert _route(jax_mods, arr).startswith("periodic(")


def test_routing_mutation_near_head_uses_backup_anchor(jax_mods, gates):
    gates("pd", ADAPTIVE_PACK_MIN=16)
    block = bytes(np.random.default_rng(5).integers(97, 123, 211,
                                                    dtype=np.uint8))
    arr = near_periodic(block, 211 * 41 + 55, [(40, ord("@"))])
    assert _route(jax_mods, arr).startswith("patched(q=211,")


def test_routing_random_text_untouched(jax_mods, gates):
    gates("pd", ADAPTIVE_PACK_MIN=16)
    arr = np.random.default_rng(23).integers(0, 256, 5000, dtype=np.uint8)
    label = _route(jax_mods, arr)
    assert not label.startswith(("patched", "periodic")), label


def test_routing_over_budget_falls_through(jax_mods, gates):
    """A corpus that passes the route gate but whose tables are over
    budget takes the doubling engines in both packages."""
    gates("pd", ADAPTIVE_PACK_MIN=16)
    gates("patched", PATCH_TABLE_BUDGET=100)
    block = bytes(np.random.default_rng(11).integers(97, 123, 101,
                                                     dtype=np.uint8))
    arr = near_periodic(block, 101 * 37 + 19, [(2020, ord("!"))])
    label = _route(jax_mods, arr)
    assert not label.startswith(("patched", "periodic")), label


def test_routing_stats_match_jax(jax_mods, gates):
    """``collect_stats`` on a patched corpus: metrics.build_stats' keys."""
    from suffix_tpu.utils.metrics import build_stats

    gates("pd", ADAPTIVE_PACK_MIN=16)
    block = bytes(np.random.default_rng(11).integers(97, 123, 101,
                                                     dtype=np.uint8))
    raw = near_periodic(block, 101 * 37 + 19, [(2020, ord("!"))]).tobytes()
    st_ = SuffixTable.new(raw, device="cpu", collect_stats=True)
    sa, want = build_stats(raw)
    got = dict(st_.build_stats)
    assert np.array_equal(st_.table(), sa)
    for key in ("elapsed_s", "bytes_per_s", "device"):
        got.pop(key)
        want.pop(key)
    if not jax_mods[2].available():
        for key in ("h0", "h_final", "rounds", "closed_form"):
            got.pop(key)
            want.pop(key)
    assert got == want and got["engine_family"] == "patched"


@pytest.mark.parametrize("seed", range(6))
def test_patched_fuzz(jax_mods, seed):
    """tests/test_patched.py::test_patched_fuzz."""
    rng = np.random.default_rng(seed)
    q = int(rng.integers(4, 61))
    k = int(rng.integers(8, 31))
    n = q * k + int(rng.integers(0, q))
    sigma = int(rng.choice([2, 4, 26]))
    block = rng.integers(97, 97 + sigma, q, dtype=np.uint8)
    muts = [(int(rng.integers(0, n)), int(rng.integers(32, 127)))
            for _ in range(int(rng.integers(0, 9)))]
    assert_engines_agree(jax_mods, near_periodic(block.tobytes(), n, muts),
                         q)


@pytest.mark.parametrize("q", [16, 211, 997])
def test_rotation_width_matches_jax(jax_mods, q):
    jpatched, _, native = jax_mods
    if not native.available():
        pytest.skip("JAX's rotation width needs its native library")
    rng = np.random.default_rng(q)
    block = rng.integers(97, 101, q, dtype=np.uint8).tobytes()
    arr = near_periodic(block, q * 9 + 5, [(q + 3, ord("!"))])
    got = patched._rotation_width(arr, q, "cpu")
    assert got == jpatched._rotation_width(arr, q)
    assert patched._rotation_width(arr[:q + 1], q, "cpu") is None
    assert patched._rotation_width(near_periodic(b"a", 40, []), 1,
                                   "cpu") == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("index_dtype", ["u32", "u64"])
def test_cuda_patched_build(cuda_device, monkeypatch, index_dtype):
    monkeypatch.setattr(pd, "ADAPTIVE_PACK_MIN", 16)
    block = bytes(np.random.default_rng(11).integers(97, 123, 1001,
                                                     dtype=np.uint8))
    arr = near_periodic(block, 1001 * 12 + 19,
                        [(2020, ord("!")), (9000, ord("?"))])
    st_ = SuffixTable.new(arr.tobytes(), device=cuda_device,
                          index_dtype=index_dtype, collect_stats=True)
    cpu = SuffixTable.new(arr.tobytes(), device="cpu", collect_stats=True)
    assert st_.build_stats["engine"].startswith("patched(q=1001,")
    for key in ("engine", "h0", "rounds", "closed_form"):
        assert st_.build_stats[key] == cpu.build_stats[key]
    assert np.array_equal(st_.table(), cpu.table())
    assert verify_suffix_array(arr.tobytes(), st_.table())


def _staging_calls(monkeypatch) -> tuple[list, list, list]:
    """Record the sizes ``pd._stage_text`` stages, the counts
    ``pd._device_byte_counts`` returns and the sizes ``pd._code_text``
    codes."""
    staged, counted, coded = [], [], []
    stage, counts, code = (pd._stage_text, pd._device_byte_counts,
                           pd._code_text)

    def stage_rec(arr, n_pad, device):
        staged.append(int(arr.size))
        return stage(arr, n_pad, device)

    def counts_rec(padded):
        counted.append(counts(padded))
        return counted[-1]

    def code_rec(padded, n, lut):
        coded.append(n)
        return code(padded, n, lut)

    monkeypatch.setattr(pd, "_stage_text", stage_rec)
    monkeypatch.setattr(pd, "_device_byte_counts", counts_rec)
    monkeypatch.setattr(pd, "_code_text", code_rec)
    return staged, counted, coded


@pytest.mark.parametrize("max_words", [None, 0], ids=["adaptive", "ladder"])
def test_patched_stages_on_the_device(monkeypatch, max_words):
    """The patched route stages the text as the doubling routes do: one
    staging of the whole text, its byte counts from the device, then the
    codes (adaptive) or the widened text (no plan) on the device."""
    if max_words is not None:
        monkeypatch.setattr(pd, "ADAPTIVE_MAX_WORDS", max_words)
    staged, counted, coded = _staging_calls(monkeypatch)
    arr = near_periodic(BLOCK16, 16 * 40 + 7, [(333, ord("Q"))])
    n_pad = pd.bucket_size(arr.size)
    stats = {}
    disp, label = patched.patched_dispatch(arr, 16, _defects(arr, 16), n_pad,
                                           stats=stats, device="cpu")
    assert label.startswith("patched(q=16,")
    # The job's own staging, then the rotation build's of T[:2q].
    assert staged == [arr.size, 32]
    assert np.array_equal(counted[0], np.bincount(arr, minlength=256))
    sa = disp().numpy()[n_pad - arr.size:].astype(np.uint32)
    assert np.array_equal(sa, naive_table(arr.tobytes()))
    assert coded == ([] if max_words == 0 else [arr.size])


@pytest.mark.gpu
def test_cuda_patched_counts_on_the_card(cuda_device, monkeypatch):
    from suffix_torch.ops import kernels

    monkeypatch.setattr(pd, "ADAPTIVE_PACK_MIN", 16)
    staged, counted, coded = _staging_calls(monkeypatch)
    block = bytes(np.random.default_rng(11).integers(97, 123, 1001,
                                                     dtype=np.uint8))
    arr = near_periodic(block, 1001 * 12 + 19, [(2020, ord("!"))])
    launches = kernels.byte_histogram.launches
    st_ = SuffixTable.new(arr.tobytes(), device=cuda_device,
                          collect_stats=True)
    assert st_.build_stats["engine"].startswith("patched(q=1001,")
    # One count of the job's text, one of the rotation build's T[:2q].
    assert staged == [arr.size, 2002]
    assert kernels.byte_histogram.launches == launches + 2
    assert np.array_equal(counted[0], np.bincount(arr, minlength=256))
    assert coded[-1] == arr.size  # after the rotation build's own
    assert verify_suffix_array(arr.tobytes(), st_.table())
