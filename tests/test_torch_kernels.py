"""Port kernels: byte_histogram's plain version against numpy and the JAX
package's histogram (XLA path and Pallas interpret mode), the kernel's
split of its input (``histogram_plan``) and a numpy emulation of its walk
and per-warp counting; the CUDA legs (marker ``gpu``) compare the
hand-written kernel with the plain version on a card (misaligned, ragged,
one-bin, 512-bin, repeated and two-stream calls), check that a call is one
device operation and that the SA-IS build launches it.

JAX is imported only by the CPU parity tests, so that the CUDA legs run
on a machine without it:
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``.
Tolerance: exact equality (integer counts).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.ops import kernels  # noqa: E402
from suffix_torch.ops.kernels import (  # noqa: E402
    byte_histogram, byte_histogram_plain, histogram_plan)
from suffix_torch.ops.naive import naive_table  # noqa: E402

CHUNK = 1024  # suffix_tpu/ops/pallas_kernels.py CHUNK: one (8, 128) tile
BATTERY = ("dna_sym", "dna_s_sym", "bytes_sym", "one_bin", "bins512")


@pytest.fixture(scope="module")
def jax_histogram():
    """suffix_tpu's byte_histogram, numpy in and out."""
    jnp = pytest.importorskip("jax.numpy")
    from suffix_tpu.ops.pallas_kernels import byte_histogram

    return lambda vals, n_bins, force: np.asarray(
        byte_histogram(jnp.asarray(vals), n_bins, force=force))


def _port(vals: np.ndarray, n_bins: int) -> np.ndarray:
    return byte_histogram(torch.from_numpy(vals), n_bins).numpy()


@pytest.mark.parametrize("n", [CHUNK, CHUNK * 3, CHUNK * 4 - 7, 100])
def test_histogram_vs_numpy_and_jax(n, rng, jax_histogram):
    vals = rng.integers(0, 258, size=n, dtype=np.int32)
    got = _port(vals, 258)
    assert got.dtype == np.int32
    assert np.array_equal(got, np.bincount(vals, minlength=258))
    assert np.array_equal(got, jax_histogram(vals, 258, "xla"))
    if n >= CHUNK:
        assert np.array_equal(got, jax_histogram(vals, 258, "interpret"))


@pytest.mark.parametrize("n_bins", [258, 512])
def test_histogram_out_of_range(n_bins, rng, jax_histogram):
    vals = rng.integers(-5, 300, size=CHUNK * 2, dtype=np.int32)
    got = _port(vals, n_bins)
    in_range = vals[(vals >= 0) & (vals < n_bins)]
    assert np.array_equal(got, np.bincount(in_range, minlength=n_bins))
    assert np.array_equal(got, jax_histogram(vals, n_bins, "xla"))
    if n_bins == 258:
        # At 512 bins the interpret path keeps its sink bin 511 (values
        # out of range land there); the port follows the drop contract.
        assert np.array_equal(got, jax_histogram(vals, n_bins, "interpret"))


def test_histogram_empty(jax_histogram):
    got = _port(np.empty(0, np.int32), 258)
    assert np.array_equal(got, np.zeros(258, np.int32))
    assert np.array_equal(got, jax_histogram(np.empty(0, np.int32), 258,
                                             "xla"))


@pytest.mark.parametrize("values,n_bins", [
    (torch.zeros(8, dtype=torch.int64), 258),
    (torch.zeros((2, 4), dtype=torch.int32), 258),
    (torch.zeros(8, dtype=torch.int32), 513),
    (torch.zeros(8, dtype=torch.int32), 0),
    (torch.zeros(16, dtype=torch.int32)[::2], 258),
], ids=["int64", "2d", "bins513", "bins0", "strided"])
def test_histogram_rejects(values, n_bins):
    with pytest.raises(ValueError):
        byte_histogram(values, n_bins)


def test_plain_is_not_counted(rng):
    before = byte_histogram.launches
    _port(rng.integers(0, 258, size=CHUNK, dtype=np.int32), 258)
    assert byte_histogram.launches == before


@pytest.mark.parametrize("name", BATTERY)
def test_battery_inputs_match_jax(name, jax_histogram):
    vals, n_bins = kernels.histogram_inputs(CHUNK * 4, "cpu")[name]
    got = byte_histogram(vals, n_bins).numpy()
    v = vals.numpy()
    in_range = v[(v >= 0) & (v < n_bins)]
    assert np.array_equal(got, np.bincount(in_range, minlength=n_bins))
    assert np.array_equal(got, jax_histogram(v, n_bins, "xla"))
    if n_bins == 258:  # ROADMAP Queue 3: the interpret path keeps bin 511
        assert np.array_equal(got, jax_histogram(v, n_bins, "interpret"))


def test_battery_inputs_shape():
    inputs = kernels.histogram_inputs(CHUNK * 16, "cpu")
    assert tuple(inputs) == BATTERY
    live = {name: int((byte_histogram(v, nb) > 0).sum())
            for name, (v, nb) in inputs.items()}
    # DNA: 4 live bins; its S positions never hold the largest letter.
    assert live == {"dna_sym": 4, "dna_s_sym": 3, "bytes_sym": 256,
                    "one_bin": 1, "bins512": 512}
    v = inputs["dna_s_sym"][0]
    assert int((v == -1).sum()) > 0 and int(v.max()) <= 101


@pytest.mark.parametrize("n_bins", [258, 512])
def test_histc_counts_like_the_kernel(n_bins, rng):
    # The battery's library yardstick: torch.histc on the in-range values
    # as float32, bins of width 1 on [0, n_bins).
    v = rng.integers(-5, n_bins + 8, size=CHUNK * 8, dtype=np.int32)
    v = np.concatenate([v, np.arange(n_bins, dtype=np.int32)])
    x = torch.from_numpy(v)
    in_range = x[(x >= 0) & (x < n_bins)].float()
    lib = torch.histc(in_range, bins=n_bins, min=0, max=n_bins)
    assert torch.equal(lib.int(), byte_histogram_plain(x, n_bins))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 17, CHUNK, CHUNK * 4 - 7,
                               (1 << 20) + 3])
def test_histogram_plan(n, offset):
    addr = 0x7F00_0000_0100 + 4 * offset
    sms, ctas = 132, 1
    plan = histogram_plan(addr, n, sms, ctas)
    head, vecs, chunks, tail, grid = plan
    # [0, n) once: head scalars, then whole vectors from a 16-byte
    # boundary, then the tail scalars.
    assert head + 4 * vecs + tail == n
    assert 0 <= head <= 3 and 0 <= tail <= 3 and vecs >= 0
    if vecs:
        assert (addr + 4 * head) % 16 == 0
    if n >= 3:
        assert head == (4 - offset) % 4
    if vecs == 0:
        assert head + tail == n
    # The ring takes the whole chunks, plain loads the rest.
    assert chunks == vecs // kernels.HIST_CHUNK_VECS
    # A persistent grid: at most a wave, no CTA without a chunk or a piece
    # of HIST_THREADS vectors of the rest, at least one CTA.
    rest = vecs - chunks * kernels.HIST_CHUNK_VECS
    units = chunks + -(-rest // kernels.HIST_THREADS)
    assert grid == max(1, min(sms * ctas, units))
    assert 1 <= grid <= sms * ctas


def test_histogram_plan_at_the_sais_size():
    # 2^22 values, 16-byte aligned: 512 chunks, no rest, one CTA an SM.
    assert histogram_plan(0x7F00_0000_0000, 1 << 22, 132, 1) == (
        0, 1 << 20, 512, 0, 132)
    # A view x[1:] of 2^22 + 3 values: a head of 3, a tail of 3.
    assert histogram_plan(0x7F00_0000_0004, (1 << 22) + 2, 132, 1) == (
        3, (1 << 20) - 1, 511, 3, 132)


def test_histogram_plan_rejects_unaligned():
    with pytest.raises(ValueError, match="aligned"):
        histogram_plan(0x1002, 16, 132, 1)


def _emulate_kernel(vals: np.ndarray, n_bins: int, offset: int,
                    sms: int) -> tuple[np.ndarray, np.ndarray]:
    """csrc/histogram.cu's byte_histogram_kernel in numpy: the plan; chunk
    g to CTA g mod grid, its vector k x HIST_THREADS + t to thread t; the
    rest's vectors grid-stride over the threads; the head on lanes 0-3 and
    the tail on lanes 4-7 of warp 0 of CTA 0; each warp's table; the CTAs'
    sum of their warps' tables. Returns (bins, how often each value was
    counted)."""
    n = vals.size
    head, vecs, chunks, tail, grid = histogram_plan(0x1000 + 4 * offset, n,
                                                    sms, 1)
    threads, chunk = kernels.HIST_THREADS, kernels.HIST_CHUNK_VECS
    tables = np.zeros((grid, threads // 32, kernels.NB), np.int64)
    seen = np.zeros(n, np.int64)

    def count(cta, thread, index):
        v = vals[index]
        ok = (v >= 0) & (v < n_bins)
        np.add.at(tables[cta], (thread[ok] // 32, v[ok]), 1)
        np.add.at(seen, index, 1)

    def vectors(cta, thread, vec):
        index = head + 4 * vec[:, None] + np.arange(4)
        count(cta, np.repeat(thread, 4), index.ravel())

    t = np.arange(threads)
    for g in range(chunks):
        for k in range(chunk // threads):
            vectors(g % grid, t, g * chunk + k * threads + t)
    for cta in range(grid):
        for start in range(chunks * chunk + cta * threads, vecs,
                           grid * threads):
            vec = start + t
            live = vec < vecs
            vectors(cta, t[live], vec[live])
    lanes = np.concatenate([np.arange(head), 4 + np.arange(tail)])
    index = np.concatenate([np.arange(head), head + 4 * vecs
                            + np.arange(tail)]).astype(np.int64)
    count(0, lanes, index)
    return tables.sum((0, 1))[:n_bins], seen


@pytest.mark.parametrize("kind", ["dna", "one_bin", "uniform", "bins512"])
def test_kernel_walk_emulated(kind, rng):
    # Five chunks over three CTAs (two CTAs take two), a rest of 1,500
    # vectors (two pieces), a head of 3 (offset 1) and a tail of 2.
    chunk = kernels.HIST_CHUNK_VECS
    n, offset = 3 + 4 * (5 * chunk + 1500) + 2, 1
    n_bins = 512 if kind == "bins512" else 258
    vals = {"dna": lambda: rng.integers(98, 102, size=n),
            "one_bin": lambda: np.full(n, 98),
            "uniform": lambda: rng.integers(1, 257, size=n),
            "bins512": lambda: rng.integers(-5, 520, size=n)}[kind]()
    vals = vals.astype(np.int32)
    plan = histogram_plan(0x1000 + 4 * offset, n, 3, 1)
    assert (plan.head, plan.chunks, plan.tail, plan.grid) == (3, 5, 2, 3)
    got, seen = _emulate_kernel(vals, n_bins, offset, sms=3)
    assert np.array_equal(seen, np.ones(n, np.int64))  # each value once
    in_range = vals[(vals >= 0) & (vals < n_bins)]
    assert np.array_equal(got, np.bincount(in_range, minlength=n_bins))


def test_battery_is_self_contained():
    # bench_probes sends these two functions' source to a process of
    # another checkout: they may read no global of ops/kernels.py but
    # each other, in their own code or in the functions nested in them.
    import inspect
    import types

    def names(code):
        # Names read as globals (or attributes): not bound in the function.
        out = set(code.co_names) - set(code.co_varnames) - set(
            code.co_cellvars)
        for const in code.co_consts:
            if isinstance(const, types.CodeType):
                out |= names(const)
        return out

    module_globals = set(vars(kernels))
    for fn, allowed in ((kernels.histogram_inputs, set()),
                        (kernels.histogram_battery, {"histogram_inputs"})):
        assert inspect.getclosurevars(fn).nonlocals == {}
        used = names(fn.__code__) & module_globals
        # Attribute names that happen to share a global's name.
        used -= {"build", "device", "torch"}
        assert used == allowed, (fn.__name__, used)


def test_histogram_battery_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.histogram_battery("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,lo,hi,n_bins", [
    (100, 0, 258, 258), (CHUNK * 4 - 7, 0, 258, 258),
    (CHUNK * 2, -5, 300, 258), (CHUNK * 2, -5, 600, 512),
    (1 << 22, -1, 6, 258), (0, 0, 1, 258),
])
def test_cuda_kernel_matches_plain(cuda_device, n, lo, hi, n_bins):
    vals = np.random.default_rng(n).integers(lo, hi, size=n, dtype=np.int32)
    x = torch.from_numpy(vals).to(cuda_device)
    before = byte_histogram.launches
    got = byte_histogram(x, n_bins)
    want = byte_histogram_plain(x, n_bins)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert byte_histogram.launches == before + (1 if n else 0)


def _cuda_check(got, x, n_bins):
    want = byte_histogram_plain(x, n_bins)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (n_bins,)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 5, 17, 8, 1 << 22])
@pytest.mark.parametrize("offset", [1, 3])
def test_cuda_misaligned_views(cuda_device, n, offset):
    vals = np.random.default_rng(n + offset).integers(
        -5, 520, size=n + offset, dtype=np.int32)
    x = torch.from_numpy(vals).to(cuda_device)[offset:]
    assert x.data_ptr() % 16 != 0
    before = byte_histogram.launches
    _cuda_check(byte_histogram(x, 512), x, 512)
    assert byte_histogram.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", BATTERY)
def test_cuda_battery_inputs(cuda_device, name):
    # one_bin at 2^22 is the worst contention: one group a warp step.
    x, n_bins = kernels.histogram_inputs(device=cuda_device)[name]
    _cuda_check(byte_histogram(x, n_bins), x, n_bins)


@pytest.mark.gpu
def test_cuda_calls_in_a_row(cuda_device):
    # No sync between calls: each finds the accumulator at rest, whatever
    # the last call's bin count.
    inputs = kernels.histogram_inputs(device=cuda_device)
    calls = [inputs[k] for k in ("bins512", "dna_s_sym", "dna_s_sym",
                                 "one_bin", "bins512")]
    outs = [byte_histogram(x, nb) for x, nb in calls]
    for got, (x, nb) in zip(outs, calls):
        _cuda_check(got, x, nb)


@pytest.mark.gpu
def test_cuda_two_streams(cuda_device):
    inputs = kernels.histogram_inputs(device=cuda_device)
    pairs = (inputs["one_bin"], inputs["bins512"])
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(4):
        for s, (x, nb) in zip(streams, pairs):
            with torch.cuda.stream(s):
                outs.append((byte_histogram(x, nb), x, nb))
    torch.cuda.synchronize()
    for got, x, nb in outs:
        _cuda_check(got, x, nb)


@pytest.mark.gpu
def test_cuda_one_device_op_a_call(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, n_bins = kernels.histogram_inputs(1 << 20, cuda_device)["dna_s_sym"]
    byte_histogram(x, n_bins)  # the stream's accumulator exists
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        byte_histogram(x, n_bins)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(ops) == 1 and "byte_histogram" in ops[0], ops


@pytest.mark.gpu
def test_cuda_histogram_battery(cuda_device):
    rows = kernels.histogram_battery(cuda_device)
    assert [r["input"] for r in rows] == list(BATTERY)
    for r in rows:
        assert all(r[k] > 0 for k in ("warm_ms", "ms", "read_flush_ms",
                                      "library_ms", "bincount_ms",
                                      "torch_sum1_ms"))


@pytest.mark.gpu
def test_cuda_sais_build_launches_kernel(cuda_device):
    text = bytes(np.random.default_rng(5).integers(97, 101, size=3000,
                                                    dtype=np.uint8))
    before = byte_histogram.launches
    st = SuffixTable.new(text, engine="sais", device=cuda_device)
    assert byte_histogram.launches >= before + 2
    assert np.array_equal(st.table(), naive_table(text))
    assert st.count(text[100:114]) == sum(
        text.startswith(text[100:114], i) for i in range(len(text)))


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__c2c3656a_9_probes_cu_5aecca0616copy_ring_kernelENS_9CopyPairsEill' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__c2c3656a_9_probes_cu_5aecca0616copy_ring_kernelENS_9CopyPairsEill
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 32 bytes smem, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_Z21byte_histogram_kernelPKiiPi' for 'sm_90a'
ptxas info    : Function properties for _Z21byte_histogram_kernelPKiiPi
    80 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 18 registers, 380 bytes cmem[0]
"""


def test_ptxas_report():
    from suffix_torch.ops.kernels import ptxas_report

    assert ptxas_report(PTXAS_LOG) == [
        {"kernel": "copy_ring_kernel", "registers": 32, "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "smem": 32},
        {"kernel": "byte_histogram_kernel", "registers": 18, "stack": 80,
         "spill_stores": 8, "spill_loads": 4, "smem": 0},
    ]
