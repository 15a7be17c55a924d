"""The bandwidth battery: hand-written CUDA probes of the card's memory
and int32 rates, beside the doubling round's own sorts.

Port of ``scripts/round3_study.py`` ``section_bw``, whose three Pallas
kernels become the kernels of ``csrc/probes.cu``:

- ``copy_blocks``   <- ``pallas_copy``  (``pl.pallas_call`` at :114);
- ``copy5_blocks``  <- ``pallas_copy5`` (``pl.pallas_call`` at :140);
- ``minmax_stages`` <- ``pallas_vpu``   (``pl.pallas_call`` at :169).

Each wrapper runs its kernel for a CUDA tensor and its plain PyTorch
version (``*_plain``) only for a CPU tensor; a failed build or launch
raises. Each counts its launches in ``<wrapper>.launches``.

``bandwidth_battery`` times the section's rows on the card: the copy
kernel gives the device-memory rate the card really reaches, and the
5-operand and 2-operand sorts are the doubling round's sort
(``ops/prefix_doubling.py`` P4) and a one-key sort with payload.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from suffix_torch.device import resolve_device
from suffix_torch.ops.kernels import _library
from suffix_torch.ops.sort import lexsort

MAX_BLOCK_ROWS = 2048  # csrc/probes.cu: 2 x block_rows x 8 int32 of smem
N_COPIES = 5

# NVIDIA H100 SXM data sheet: device memory 3.35 TB/s; float32 outside
# the tensor cores 67 TFLOP/s = 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz.
# An SM has half as many int32 lanes (64, Hopper white paper), so one
# int32 operation a lane a clock gives 132 x 64 x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The function needs one int32 operation an element a stage: a row's
# parity fixes whether it takes min or max.
MINMAX_OPS_PER_ELEMENT_STAGE = 1

# The battery's inputs: five int32 arrays of BATTERY_N values from
# BATTERY_SEED; the min/max probe runs BATTERY_STAGES stages.
BATTERY_N = 1 << 22
BATTERY_SEED = 3
BATTERY_STAGES = 16

# Every time is the median of TIMING_REPS timed runs after TIMING_WARMUP.
TIMING_REPS = 30
TIMING_WARMUP = 5


def _check_int32(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.int32:
        raise ValueError(f"{name} takes int32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned CUDA storage")


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(_library("probes"), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def copy_blocks_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``copy_blocks``."""
    return x.clone()


def copy_blocks(x: torch.Tensor) -> torch.Tensor:
    """A copy of the int32 tensor ``x``."""
    _check_int32(x, "copy_blocks")
    if x.device.type == "cpu":
        return copy_blocks_plain(x)
    out = torch.empty_like(x)
    if x.numel():
        _launch("copy_blocks_launch", x.device, x.data_ptr(), out.data_ptr(),
                x.numel())
        copy_blocks.launches += 1
    return out


copy_blocks.launches = 0


def copy5_blocks_plain(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain version of ``copy5_blocks``."""
    return tuple(x.clone() for x in xs)


def copy5_blocks(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Copies of five int32 tensors of one shape, in one launch."""
    if len(xs) != N_COPIES:
        raise ValueError(f"copy5_blocks takes {N_COPIES} tensors, got "
                         f"{len(xs)}")
    for x in xs:
        _check_int32(x, "copy5_blocks")
        if x.shape != xs[0].shape or x.device != xs[0].device:
            raise ValueError("copy5_blocks takes tensors of one shape on "
                             "one device")
    if xs[0].device.type == "cpu":
        return copy5_blocks_plain(*xs)
    outs = tuple(torch.empty_like(x) for x in xs)
    if xs[0].numel():
        _launch("copy5_blocks_launch", xs[0].device,
                *(x.data_ptr() for x in xs), *(o.data_ptr() for o in outs),
                xs[0].numel())
        copy5_blocks.launches += 1
    return outs


copy5_blocks.launches = 0


def _check_minmax(x: torch.Tensor, stages: int, block_rows: int) -> None:
    _check_int32(x, "minmax_stages")
    if x.dim() != 2:
        raise ValueError(f"minmax_stages takes a 2-D tensor, got {x.dim()}-D")
    if not 1 <= block_rows <= MAX_BLOCK_ROWS or x.shape[0] % block_rows:
        raise ValueError(f"block_rows must be in [1, {MAX_BLOCK_ROWS}] and "
                         f"divide the {x.shape[0]} rows")
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")


def minmax_stages_plain(x: torch.Tensor, stages: int = 16,
                        block_rows: int = 2048) -> torch.Tensor:
    """Plain version of ``minmax_stages``: per-block ``torch.roll``."""
    _check_minmax(x, stages, block_rows)
    rows, width = x.shape
    v = x.view(rows // block_rows, block_rows, width)
    odd = (torch.arange(block_rows, device=x.device) % 2 == 1)[None, :, None]
    for s in range(stages):
        w = torch.roll(v, 1 + s, dims=1)
        v = torch.where(odd, torch.maximum(v, w), torch.minimum(v, w))
    return v.reshape(rows, width)


def minmax_stages(x: torch.Tensor, stages: int = 16,
                  block_rows: int = 2048) -> torch.Tensor:
    """``stages`` compare-exchange stages on ``(rows, width)`` int32: at
    stage s, w = v rolled down by 1+s rows inside each ``block_rows``-row
    block (``w[r] = v[(r - 1 - s) mod block_rows]``, ``jnp.roll``'s
    direction); even rows of a block take min(v, w), odd rows max(v, w).
    """
    _check_minmax(x, stages, block_rows)
    if x.device.type == "cpu":
        return minmax_stages_plain(x, stages, block_rows)
    out = torch.empty_like(x)
    if x.numel():
        _launch("minmax_stages_launch", x.device, x.data_ptr(),
                out.data_ptr(), x.shape[0], x.shape[1], block_rows, stages)
        minmax_stages.launches += 1
    return out


minmax_stages.launches = 0


HOLD_CYCLES = 1_000_000  # about 0.5 ms of spinning at the H100's clock


def time_ms(fn, flush=None) -> float:
    """Median device time of ``fn`` over TIMING_REPS runs, by CUDA
    events, after TIMING_WARMUP runs. ``flush`` (optional) runs before
    each timed run, outside the events: the battery evicts L2 with it.

    Before each start event the card spins for HOLD_CYCLES, so the host
    has queued ``fn``'s kernels and the stop event by the time the start
    event runs: the events then bracket device work only, not the host's
    launch overhead (tens of microseconds for a ctypes launch, as long as
    the kernels measured here)."""
    for _ in range(TIMING_WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        if flush is not None:
            flush()
        torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def copy_bound_ms(n_bytes_moved: int) -> float:
    return n_bytes_moved / HBM_BYTES_PER_S * 1e3


def minmax_bound(n: int, stages: int) -> tuple[float, float]:
    """(bytes term, operations term) in ms of the min/max probe."""
    ops = MINMAX_OPS_PER_ELEMENT_STAGE * stages * n
    return copy_bound_ms(2 * 4 * n), ops / INT32_OPS_PER_S * 1e3


def bandwidth_battery(device=None) -> list[dict]:
    """The section's rows, timed on the CUDA ``device`` by events
    (``time_ms``), L2 evicted before each timed run.

    Inputs: five int32 arrays of BATTERY_N values in [0, 2^22) from
    BATTERY_SEED, viewed as ``(BATTERY_N / 128, 128)`` for the kernels.
    Rows: ``torch_copy1``/``torch_copy5`` (``x + 1``), ``cuda_copy1``,
    ``cuda_copy5``, ``cuda_minmax_x16`` (with ``plain_ms`` and
    ``library_ms``: ``copy_`` for the copies, none for min/max), then
    ``lexsort5`` (4 int32 keys + payload) and ``lexsort2`` (1 + 1)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("bandwidth_battery times the card by CUDA events "
                         "and needs a CUDA device")
    n, stages = BATTERY_N, BATTERY_STAGES
    rng = np.random.default_rng(BATTERY_SEED)
    xs = [torch.from_numpy(rng.integers(0, 1 << 22, size=n, dtype=np.int32))
          .to(dev) for _ in range(N_COPIES)]
    x2 = [x.view(n // 128, 128) for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    scratch = torch.empty(1 << 27, dtype=torch.uint8, device=dev)  # > L2

    def ms(fn):
        return time_ms(fn, flush=scratch.zero_)

    def copies(k):
        for x, o in zip(xs[:k], outs[:k]):
            o.copy_(x)

    rows = []
    for k in (1, N_COPIES):
        moved = 2 * 4 * n * k
        t = ms(lambda: [x + 1 for x in xs[:k]])
        rows.append({"op": f"torch_copy{k}", "ms": t,
                     "gbps": moved / t / 1e6, "bound_ms": copy_bound_ms(moved),
                     "bound_by": "bytes"})
        kernel = ((lambda: copy_blocks(x2[0])) if k == 1
                  else (lambda: copy5_blocks(*x2)))
        plain = ((lambda: copy_blocks_plain(x2[0])) if k == 1
                 else (lambda: copy5_blocks_plain(*x2)))
        t = ms(kernel)
        rows.append({"op": f"cuda_copy{k}", "ms": t, "gbps": moved / t / 1e6,
                     "bound_ms": copy_bound_ms(moved), "bound_by": "bytes",
                     "plain_ms": ms(plain),
                     "library_ms": ms(lambda: copies(k))})
    t = ms(lambda: minmax_stages(x2[0], stages))
    by_bytes, by_ops = minmax_bound(n, stages)
    rows.append({"op": f"cuda_minmax_x{stages}", "ms": t,
                 "stage_ms": t / stages,
                 "el_per_s_per_stage": n * stages / t * 1e3,
                 "bound_ms": max(by_bytes, by_ops),
                 "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                 "bound_bytes_ms": by_bytes, "bound_ops_ms": by_ops,
                 "plain_ms": ms(lambda: minmax_stages_plain(x2[0], stages)),
                 "library_ms": None})
    rows.append({"op": "lexsort5",
                 "ms": ms(lambda: lexsort(xs[:4], (xs[4],)))})
    rows.append({"op": "lexsort2", "ms": ms(lambda: lexsort(xs[:1], (xs[1],)))})
    return rows
