"""The bandwidth battery's probes (``suffix_torch/ops/probes.py``): each
plain version against the Pallas kernel of ``scripts/round3_study.py``
``section_bw``, copied here and run with ``interpret=True`` at
(4096, 128) int32: 2 blocks of (2048, 128) for the copy and the min/max
kernels, 8 blocks of (512, 128) for the five-stream copy. The roll's
direction is pinned against ``np.roll``. The CUDA legs (marker ``gpu``)
hold each hand-written kernel against its plain version on a card.
Tolerance: exact equality (int32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch.ops import probes  # noqa: E402

R = 4096
BR = 2048   # round3_study.py section_bw: copy and min/max block rows
BR5 = 512   # five-stream copy block rows
K = 16      # min/max stages


@pytest.fixture(scope="module")
def pallas():
    """The three kernels of section_bw, at R rows, in interpret mode."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def spec(rows):
        return pl.BlockSpec((rows, 128), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)

    def copy_kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:]

    def pallas_copy(x):
        return pl.pallas_call(
            copy_kernel,
            out_shape=jax.ShapeDtypeStruct((R, 128), jnp.int32),
            grid=(R // BR,), in_specs=[spec(BR)], out_specs=spec(BR),
            interpret=True)(x)

    def copy_kernel5(a, b, c, d, e, oa, ob, oc, od, oe):
        oa[:] = a[:]
        ob[:] = b[:]
        oc[:] = c[:]
        od[:] = d[:]
        oe[:] = e[:]

    def pallas_copy5(*arrs):
        return pl.pallas_call(
            copy_kernel5,
            out_shape=tuple(jax.ShapeDtypeStruct((R, 128), jnp.int32)
                            for _ in range(5)),
            grid=(R // BR5,), in_specs=[spec(BR5)] * 5,
            out_specs=tuple([spec(BR5)] * 5), interpret=True)(*arrs)

    def vpu_kernel(x_ref, o_ref):
        v = x_ref[:]
        for s in range(K):
            w = pltpu.roll(v, shift=1 + s, axis=0)
            lo = jnp.minimum(v, w)
            hi = jnp.maximum(v, w)
            v = jnp.where((jax.lax.broadcasted_iota(
                jnp.int32, v.shape, 0) & 1) == 0, lo, hi)
        o_ref[:] = v

    def pallas_vpu(x):
        return pl.pallas_call(
            vpu_kernel,
            out_shape=jax.ShapeDtypeStruct((R, 128), jnp.int32),
            grid=(R // BR,), in_specs=[spec(BR)], out_specs=spec(BR),
            interpret=True)(x)

    def run(fn, *xs):
        out = fn(*(jnp.asarray(x) for x in xs))
        if isinstance(out, tuple):
            return tuple(np.asarray(o) for o in out)
        return np.asarray(out)

    return {"copy": lambda x: run(pallas_copy, x),
            "copy5": lambda *xs: run(pallas_copy5, *xs),
            "vpu": lambda x: run(pallas_vpu, x)}


def _inputs(k: int, seed: int = 3) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 22, size=(R, 128), dtype=np.int32)
            for _ in range(k)]


def test_copy_blocks_matches_pallas(pallas):
    x = _inputs(1)[0]
    got = probes.copy_blocks(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (R, 128)
    assert np.array_equal(got.numpy(), pallas["copy"](x))


def test_copy5_blocks_matches_pallas(pallas):
    xs = _inputs(5)
    got = probes.copy5_blocks(*(torch.from_numpy(x) for x in xs))
    want = pallas["copy5"](*xs)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", [3, 4])
def test_minmax_stages_matches_pallas(pallas, seed):
    x = _inputs(1, seed)[0]
    got = probes.minmax_stages(torch.from_numpy(x), K, BR)
    assert np.array_equal(got.numpy(), pallas["vpu"](x))


def _minmax_numpy(x: np.ndarray, stages: int, block_rows: int) -> np.ndarray:
    """The stages with np.roll per block, written out."""
    v = x.reshape(-1, block_rows, x.shape[1]).copy()
    odd = (np.arange(block_rows) % 2 == 1)[None, :, None]
    for s in range(stages):
        w = np.roll(v, 1 + s, axis=1)
        v = np.where(odd, np.maximum(v, w), np.minimum(v, w))
    return v.reshape(x.shape)


def test_roll_direction_pinned():
    # One stage on one 4-row block: w[r] = v[r - 1 mod 4], so row 0 reads
    # row 3 (the wrap) and row 1 reads row 0.
    x = np.array([[5], [1], [7], [3]], np.int32)
    got = probes.minmax_stages(torch.from_numpy(x), 1, 4).numpy()
    # rows: 0 even min(5, v[3]=3) = 3; 1 odd max(1, v[0]=5) = 5;
    #       2 even min(7, v[1]=1) = 1; 3 odd max(3, v[2]=7) = 7.
    assert got[:, 0].tolist() == [3, 5, 1, 7]
    assert np.array_equal(got, _minmax_numpy(x, 1, 4))


@pytest.mark.parametrize("rows,width,stages,block_rows", [
    (64, 128, 16, 8),     # shifts past the block wrap modulo its rows
    (4096, 20, 5, 1024),  # a width that is no multiple of 8
    (30, 3, 3, 5),        # odd block rows
])
def test_minmax_plain_matches_numpy(rows, width, stages, block_rows):
    x = np.random.default_rng(rows).integers(-9, 9, size=(rows, width),
                                             dtype=np.int32)
    got = probes.minmax_stages(torch.from_numpy(x), stages, block_rows)
    assert np.array_equal(got.numpy(), _minmax_numpy(x, stages, block_rows))


def test_cpu_runs_plain_and_counts_nothing():
    x = torch.arange(40, dtype=torch.int32).view(8, 5)
    before = (probes.copy_blocks.launches, probes.copy5_blocks.launches,
              probes.minmax_stages.launches,
              dict(probes.minmax_stages.path_launches))
    assert torch.equal(probes.copy_blocks(x), x)
    assert all(torch.equal(o, x) for o in probes.copy5_blocks(*[x] * 5))
    probes.minmax_stages(x, 2, 4)
    probes.minmax_stages(torch.zeros((2048, 16), dtype=torch.int32))
    assert before == (probes.copy_blocks.launches,
                      probes.copy5_blocks.launches,
                      probes.minmax_stages.launches,
                      probes.minmax_stages.path_launches)


# ---- the register path's strip layout, emulated -------------------------

LANES = 32


def _strip_shift(v: np.ndarray, d: int) -> np.ndarray:
    """w for one stage of shift d, as the register path builds it from a
    warp's strips v (LANES, K): w[l, i] = v[l, i - d] for i >= d, else the
    previous lane's v[l - 1, K + i - d] (lane 0 from lane 31)."""
    k = v.shape[1]
    assert d <= k, "the shift reaches past the previous lane"
    w = np.empty_like(v)
    w[:, d:] = v[:, :k - d]
    w[:, :d] = np.roll(v, 1, axis=0)[:, k - d:]
    return w


@pytest.mark.parametrize("k", [64, 4])
@pytest.mark.parametrize("d", range(1, 17))
def test_strip_index_map_is_the_roll(k, d):
    # Row lane * K + i of a block of LANES * K rows sits in lane `lane`,
    # register i; the strip map equals np.roll inside the block.
    col = np.random.default_rng(d).integers(0, 1 << 30, size=LANES * k)
    v = col.reshape(LANES, k)
    assert np.array_equal(v.reshape(-1), col)
    if d > k:
        # Past one strip the map would need lane - 2: the picker never
        # sends such a shape to the register path.
        assert probes.minmax_path(128, LANES * k, d) == "shared"
        with pytest.raises(AssertionError):
            _strip_shift(v, d)
        return
    want = np.roll(col, d)
    assert np.array_equal(_strip_shift(v, d).reshape(-1), want)


def test_register_stages_emulated():
    # The register path's 16 stages on whole strips, parity from the
    # register index (K is even), against the plain stages.
    k, stages = probes.REGISTER_BLOCK_ROWS // LANES, probes.REGISTER_STAGES
    x = np.random.default_rng(5).integers(-(1 << 30), 1 << 30,
                                          size=(2 * LANES * k, 3),
                                          dtype=np.int32)
    out = np.empty_like(x)
    odd = (np.arange(k) % 2 == 1)[None, :]
    for b in range(2):
        for c in range(x.shape[1]):
            v = x[b * LANES * k:(b + 1) * LANES * k, c].reshape(LANES, k)
            for s in range(stages):
                w = _strip_shift(v, 1 + s)
                v = np.where(odd, np.maximum(v, w), np.minimum(v, w))
            out[b * LANES * k:(b + 1) * LANES * k, c] = v.reshape(-1)
    assert np.array_equal(out, _minmax_numpy(x, stages,
                                             probes.REGISTER_BLOCK_ROWS))


@pytest.mark.parametrize("width,block_rows,stages,path", [
    (128, 2048, 16, "registers"),   # the battery, 16 blocks and 2
    (16, 2048, 16, "registers"),    # one slab
    (128, 2048, 15, "shared"),      # another stage count
    (24, 2048, 16, "shared"),       # a width of no whole 16-column slabs
    (128, 8, 16, "shared"),         # shifts past the block
    (20, 1024, 5, "shared"),
    (3, 5, 3, "shared"),
])
def test_minmax_path(width, block_rows, stages, path):
    assert probes.minmax_path(width, block_rows, stages) == path
    if path == "registers":
        assert stages <= block_rows // LANES


@pytest.mark.parametrize("n,pairs,plan", [
    (1 << 22, 5, (512, 132)),   # the battery: 2,560 chunks, one CTA an SM
    (1 << 22, 1, (512, 132)),
    (1, 5, (0, 1)),
    (5, 5, (0, 1)),
    (4099, 5, (0, 21)),         # less than one chunk
    (8191, 5, (0, 40)),
    (8192, 5, (1, 5)),          # exactly one chunk a pair
    (3 * 8192 + 4099, 5, (3, 36)),  # no multiple of the chunk
    (266 * 8192 + 77, 5, (266, 132)),
])
def test_copy_plan(n, pairs, plan):
    chunks, grid = probes.copy_plan(n, pairs, 132)
    assert (chunks, grid) == plan
    assert chunks * probes.COPY_CHUNK_INTS <= n
    assert n - chunks * probes.COPY_CHUNK_INTS < probes.COPY_CHUNK_INTS
    assert 1 <= grid <= 132


@pytest.mark.parametrize("call", [
    lambda: probes.copy_blocks(torch.zeros(8, dtype=torch.int64)),
    lambda: probes.copy_blocks(torch.zeros(16, dtype=torch.int32)[::2]),
    lambda: probes.copy5_blocks(*[torch.zeros(8, dtype=torch.int32)] * 4),
    lambda: probes.copy5_blocks(*[torch.zeros(8, dtype=torch.int32)] * 4,
                                torch.zeros(9, dtype=torch.int32)),
    lambda: probes.minmax_stages(torch.zeros(8, dtype=torch.int32)),
    lambda: probes.minmax_stages(torch.zeros((12, 4), dtype=torch.int32),
                                 2, 8),
    lambda: probes.minmax_stages(torch.zeros((8, 4), dtype=torch.int32),
                                 0, 8),
    lambda: probes.minmax_stages(torch.zeros((4096, 4), dtype=torch.int32),
                                 1, 4096),
], ids=["int64", "strided", "four", "shapes", "1d", "rows", "stages0",
        "block4096"])
def test_probes_reject(call):
    with pytest.raises(ValueError):
        call()


def test_battery_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        probes.bandwidth_battery("cpu")


def test_minmax_bound_terms():
    by_bytes, by_ops = probes.minmax_bound(1 << 22, 16)
    assert by_bytes == pytest.approx(2 * 4 * (1 << 22) / 3.35e12 * 1e3)
    assert by_ops == pytest.approx(16 * (1 << 22)
                                   / (132 * 64 * 1.98e9) * 1e3)
    assert by_bytes > by_ops  # the probe is bound by bytes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_ints(shape, seed, device):
    vals = np.random.default_rng(seed).integers(-(1 << 30), 1 << 30,
                                                size=shape, dtype=np.int32)
    return torch.from_numpy(vals).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1 << 15, 128), (1,), (5,), (4099,),
                                   (8191,), (3 * 8192 + 4099,),
                                   (266 * 8192 + 77,)])
def test_cuda_copies_match_plain(cuda_device, shape):
    xs = [_cuda_ints(shape, k, cuda_device) for k in range(5)]
    before = probes.copy_blocks.launches, probes.copy5_blocks.launches
    assert torch.equal(probes.copy_blocks(xs[0]), xs[0])
    for got, want in zip(probes.copy5_blocks(*xs), xs):
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert (probes.copy_blocks.launches, probes.copy5_blocks.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,width,stages,block_rows", [
    (1 << 15, 128, 16, 2048), (4096, 128, 16, 2048), (2048, 16, 16, 2048),
    (4096, 128, 15, 2048), (4096, 24, 16, 2048), (64, 128, 16, 8),
    (4096, 20, 5, 1024), (30, 3, 3, 5)])
def test_cuda_minmax_matches_plain(cuda_device, rows, width, stages,
                                   block_rows):
    x = _cuda_ints((rows, width), rows + width, cuda_device)
    path = probes.minmax_path(width, block_rows, stages)
    before = dict(probes.minmax_stages.path_launches)
    got = probes.minmax_stages(x, stages, block_rows)
    want = probes.minmax_stages_plain(x, stages, block_rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    before[path] += 1
    assert probes.minmax_stages.path_launches == before


@pytest.mark.gpu
def test_cuda_battery_rows(cuda_device):
    rows = probes.bandwidth_battery(cuda_device)
    assert [r["op"] for r in rows] == [
        "torch_copy1", "cuda_copy1", "torch_copy5", "cuda_copy5",
        "cuda_minmax_x16", "lexsort5", "lexsort2"]
    assert all(r["ms"] > 0 for r in rows)
    assert all(r["read_flush_ms"] > 0 for r in rows[:5])


@pytest.mark.gpu
def test_cuda_battery_waves(cuda_device):
    waves = probes.battery_waves(cuda_device)
    assert waves["copy5_blocks"]["ctas_per_sm"] >= 1
    assert waves["minmax_stages"]["grid"] == 128
    assert all(w["waves"] > 0 for w in waves.values())


def test_bench_probes_summary():
    from suffix_torch.bench_probes import summarize

    def rows(copy1, kernel):
        return [{"op": "torch_copy1", "ms": copy1},
                {"op": "cuda_copy5", "ms": kernel, "read_flush_ms": None}]

    out = summarize([("a", rows(0.02, 0.08)), ("b", rows(0.02, 0.06)),
                     ("b", rows(0.01, 0.04)), ("a", rows(0.02, 0.10))])
    a, b = out["a"]["cuda_copy5"]["ms"], out["b"]["cuda_copy5"]["ms"]
    assert a["runs"] == [0.08, 0.10] and a["median"] == pytest.approx(0.09)
    assert (b["min"], b["max"]) == (0.04, 0.06)
    assert b["x_torch_copy1"] == pytest.approx([3.0, 4.0])
    assert "read_flush_ms" not in out["a"]["cuda_copy5"]


def test_bench_probes_summary_histogram_rows():
    from suffix_torch.bench_probes import summarize

    def rows(copy1, kernel, sum1):
        return [{"op": "torch_copy1", "ms": copy1},
                {"op": "hist_dna_sym", "warm_ms": kernel / 2, "ms": kernel,
                 "read_flush_ms": kernel, "torch_sum1_warm_ms": sum1 / 2,
                 "torch_sum1_ms": sum1, "torch_sum1_read_flush_ms": sum1 * 2,
                 "library_ms": 0.05, "bincount_ms": 0.3, "plain_ms": 1.6}]

    out = summarize([("p", rows(0.02, 0.014, 0.007)),
                     ("c", rows(0.02, 0.008, 0.008))])
    p, c = out["p"]["hist_dna_sym"], out["c"]["hist_dna_sym"]
    assert p["ms"]["x_torch_sum1"] == pytest.approx([2.0])
    assert p["read_flush_ms"]["x_torch_sum1"] == pytest.approx([1.0])
    assert c["warm_ms"]["x_torch_sum1"] == pytest.approx([1.0])
    assert c["ms"]["x_torch_copy1"] == pytest.approx([0.4])
    # The yardsticks are summarized, but not as multiples of the read.
    assert "x_torch_sum1" not in p["library_ms"]
    assert p["bincount_ms"]["median"] == 0.3
    assert "plain_ms" not in p


def test_bench_probes_child_runs_the_histogram_battery():
    import ast

    from suffix_torch.bench_probes import _CHILD

    tree = ast.parse(_CHILD)
    defs = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)]
    assert defs == ["histogram_inputs", "histogram_battery"]
    assert _CHILD.splitlines()[-1] == (
        "print(json.dumps(probes.bandwidth_battery() + histogram_battery()))")
