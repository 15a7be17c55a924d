"""The bandwidth battery: hand-written CUDA probes of the card's memory
and int32 rates, beside the doubling round's own sorts.

Port of ``scripts/round3_study.py`` ``section_bw``, whose three Pallas
kernels become the kernels of ``csrc/probes.cu``:

- ``copy_blocks``   <- ``pallas_copy``  (``pl.pallas_call`` at :114);
- ``copy5_blocks``  <- ``pallas_copy5`` (``pl.pallas_call`` at :140);
- ``minmax_stages`` <- ``pallas_vpu``   (``pl.pallas_call`` at :169).

All three are bound by device memory (2 x 4 B an element). Both copies
run one persistent grid that walks the pairs' 32 KiB chunks through a
ring of TMA bulk copies (``copy_plan`` cuts the work), so the card is not
left waiting on CTAs that each wait out a memory latency alone.
``minmax_stages`` holds a block column in registers, a lane 64 rows of
it, at the battery's shape, and the whole block in shared memory
otherwise (``minmax_path`` picks by shape). The source note in
``csrc/probes.cu`` says more.

Each wrapper runs its kernel for a CUDA tensor and its plain PyTorch
version (``*_plain``) only for a CPU tensor; a failed build or launch
raises, and no other path is tried. Each counts its launches in
``<wrapper>.launches``; ``minmax_stages`` also by path in
``minmax_stages.path_launches``.

``bandwidth_battery`` times the section's rows on the card: the copy
kernel gives the device-memory rate the card really reaches, and the
5-operand and 2-operand sorts are the doubling round's sort
(``ops/prefix_doubling.py`` P4) and a one-key sort with payload.
"""

from __future__ import annotations

import ctypes
import statistics

import numpy as np
import torch

from suffix_torch.device import resolve_device
from suffix_torch.ops.kernels import _library
from suffix_torch.ops.sort import lexsort

MAX_BLOCK_ROWS = 2048  # csrc/probes.cu: 2 x block_rows x 8 int32 of smem
N_COPIES = 5

# csrc/probes.cu's bulk-copy ring (both copies): 32 KiB chunks, one CTA
# an SM (a 128 KiB ring each); the values past a pair's last whole chunk
# go on plain loads, at most COPY_REST_PER_CTA of them to a CTA.
COPY_CHUNK_INTS = 8192
COPY_REST_PER_CTA = 1024

# csrc/probes.cu's register path of minmax_stages, compiled for one shape:
# 2048-row blocks (64 rows a lane), 16 stages, 16-column slabs.
REGISTER_BLOCK_ROWS = 2048
REGISTER_STAGES = 16
REGISTER_SLAB = 16
MINMAX_PATHS = ("registers", "shared")

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
BATTERY_SHAPE = (BATTERY_N // 128, 128)

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


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def copy_blocks_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``copy_blocks``."""
    return x.clone()


def copy_blocks(x: torch.Tensor) -> torch.Tensor:
    """A copy of the int32 tensor ``x``."""
    _check_int32(x, "copy_blocks")
    if x.device.type == "cpu":
        return copy_blocks_plain(x)
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        chunks, grid = copy_plan(n, 1, _sm_count(x.device))
        _launch("copy_blocks_launch", x.device, x.data_ptr(), out.data_ptr(),
                n, chunks, grid)
        copy_blocks.launches += 1
    return out


copy_blocks.launches = 0


def copy_plan(n: int, n_pairs: int, sms: int) -> tuple[int, int]:
    """(whole chunks a pair, CTAs) of the bulk-copy ring for ``n_pairs``
    copies of ``n`` int32 on a card of ``sms`` SMs. The chunks go through
    the ring; each pair's ``n - chunks * COPY_CHUNK_INTS`` values past them
    go on plain loads. The grid is one CTA an SM, fewer when there are
    fewer chunks and rest pieces than that, and at least one."""
    chunks = n // COPY_CHUNK_INTS
    rest = n_pairs * (n - chunks * COPY_CHUNK_INTS)
    units = n_pairs * chunks + -(-rest // COPY_REST_PER_CTA)
    return chunks, max(1, min(sms, units))


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
    n = xs[0].numel()
    if n:
        chunks, grid = copy_plan(n, N_COPIES, _sm_count(xs[0].device))
        _launch("copy5_blocks_launch", xs[0].device,
                *(x.data_ptr() for x in xs), *(o.data_ptr() for o in outs),
                n, chunks, grid)
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


def minmax_path(width: int, block_rows: int, stages: int) -> str:
    """The kernel ``minmax_stages`` runs for a valid shape: ``registers``
    for the shape the register path is compiled for (REGISTER_BLOCK_ROWS,
    REGISTER_STAGES, a width that is whole REGISTER_SLAB slabs), else
    ``shared``. The register path needs every shift inside one lane's
    strip and its neighbour's, so stages <= block_rows / 32."""
    if (block_rows == REGISTER_BLOCK_ROWS and stages == REGISTER_STAGES
            and width % REGISTER_SLAB == 0):
        return "registers"
    return "shared"


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
        rows, width = x.shape
        path = minmax_path(width, block_rows, stages)
        if path == "registers":
            _launch("minmax_registers_launch", x.device, x.data_ptr(),
                    out.data_ptr(), rows, width)
        else:
            _launch("minmax_stages_launch", x.device, x.data_ptr(),
                    out.data_ptr(), rows, width, block_rows, stages)
        minmax_stages.launches += 1
        minmax_stages.path_launches[path] += 1
    return out


minmax_stages.launches = 0
minmax_stages.path_launches = dict.fromkeys(MINMAX_PATHS, 0)


def battery_waves(device=None) -> dict:
    """Each probe kernel at the battery's shape on the CUDA ``device``:
    threads a CTA, grid, CTAs an SM (the occupancy calculator) and waves
    (grid over CTAs an SM times SMs). ``minmax_stages (shared)`` is the
    shared path at the same shape, for comparison."""
    dev = resolve_device(device)
    sms = _sm_count(dev)
    n, (rows, width) = BATTERY_N, BATTERY_SHAPE
    blocks = rows // REGISTER_BLOCK_ROWS
    shapes = {  # name: (kernel id in probes_ctas_per_sm, threads, grid)
        "copy_blocks": (0, 128, copy_plan(n, 1, sms)[1]),
        "copy5_blocks": (0, 128, copy_plan(n, N_COPIES, sms)[1]),
        "minmax_stages": (1, 32 * REGISTER_SLAB,
                          blocks * width // REGISTER_SLAB),
        "minmax_stages (shared)": (2, 1024, blocks * -(-width // 8)),
    }
    fn = _library("probes").probes_ctas_per_sm
    out = {}
    with torch.cuda.device(dev):
        for name, (kernel, threads, grid) in shapes.items():
            ctas = ctypes.c_int(0)
            err = fn(kernel, REGISTER_BLOCK_ROWS, ctypes.byref(ctas))
            if err != 0:
                raise RuntimeError(f"probes_ctas_per_sm({name}) failed: "
                                   f"CUDA error {err}")
            out[name] = {"threads": threads, "grid": grid,
                         "ctas_per_sm": ctas.value, "sms": sms,
                         "waves": grid / max(1, ctas.value * sms)}
    return out


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

    Two evictions: ``ms`` (and ``plain_ms``, ``library_ms``) after zeroing
    a 128 MiB scratch, which leaves L2 full of dirty lines that the timed
    run may have to write back; ``read_flush_ms`` (and
    ``library_read_flush_ms``) after reading a 128 MiB scratch filled
    once, which leaves only clean lines.

    Inputs: five int32 arrays of BATTERY_N values in [0, 2^22) from
    BATTERY_SEED, viewed as BATTERY_SHAPE for the kernels. Rows:
    ``torch_copy1``/``torch_copy5`` (``x + 1``), ``cuda_copy1``,
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
    x2 = [x.view(BATTERY_SHAPE) for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    scratch = torch.empty(1 << 27, dtype=torch.uint8, device=dev)  # > L2
    clean = torch.ones(1 << 25, dtype=torch.int32, device=dev)  # 128 MiB

    def ms(fn):
        return time_ms(fn, flush=scratch.zero_)

    def read_ms(fn):
        return time_ms(fn, flush=clean.max)

    def copies(k):
        for x, o in zip(xs[:k], outs[:k]):
            o.copy_(x)

    rows = []
    for k in (1, N_COPIES):
        moved = 2 * 4 * n * k
        torch_copy = (lambda: [x + 1 for x in xs[:k]])
        t = ms(torch_copy)
        rows.append({"op": f"torch_copy{k}", "ms": t,
                     "gbps": moved / t / 1e6, "bound_ms": copy_bound_ms(moved),
                     "bound_by": "bytes", "read_flush_ms": read_ms(torch_copy)})
        kernel = ((lambda: copy_blocks(x2[0])) if k == 1
                  else (lambda: copy5_blocks(*x2)))
        plain = ((lambda: copy_blocks_plain(x2[0])) if k == 1
                 else (lambda: copy5_blocks_plain(*x2)))
        t = ms(kernel)
        rows.append({"op": f"cuda_copy{k}", "ms": t, "gbps": moved / t / 1e6,
                     "bound_ms": copy_bound_ms(moved), "bound_by": "bytes",
                     "plain_ms": ms(plain),
                     "library_ms": ms(lambda: copies(k)),
                     "read_flush_ms": read_ms(kernel),
                     "library_read_flush_ms": read_ms(lambda: copies(k))})
    minmax = (lambda: minmax_stages(x2[0], stages))
    t = ms(minmax)
    by_bytes, by_ops = minmax_bound(n, stages)
    rows.append({"op": f"cuda_minmax_x{stages}", "ms": t,
                 "stage_ms": t / stages,
                 "el_per_s_per_stage": n * stages / t * 1e3,
                 "bound_ms": max(by_bytes, by_ops),
                 "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                 "bound_bytes_ms": by_bytes, "bound_ops_ms": by_ops,
                 "plain_ms": ms(lambda: minmax_stages_plain(x2[0], stages)),
                 "library_ms": None, "read_flush_ms": read_ms(minmax)})
    rows.append({"op": "lexsort5",
                 "ms": ms(lambda: lexsort(xs[:4], (xs[4],)))})
    rows.append({"op": "lexsort2", "ms": ms(lambda: lexsort(xs[:1], (xs[1],)))})
    return rows
