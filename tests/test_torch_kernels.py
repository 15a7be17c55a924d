"""Port kernels: byte_histogram's plain version against numpy and the JAX
package's histogram (XLA path and Pallas interpret mode); the CUDA legs
(marker ``gpu``) compare the hand-written kernel with the plain version on
a card and check that the SA-IS build launches it.

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
from suffix_torch.ops.kernels import (  # noqa: E402
    byte_histogram, byte_histogram_plain)
from suffix_torch.ops.naive import naive_table  # noqa: E402

CHUNK = 1024  # suffix_tpu/ops/pallas_kernels.py CHUNK: one (8, 128) tile


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
