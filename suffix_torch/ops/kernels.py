"""Hand-written CUDA kernels of the port, their plain versions, and the
build that compiles them from ``suffix_torch/csrc`` at first use.

Kernel inventory:

- ``byte_histogram`` (``csrc/histogram.cu``) replaces the Pallas kernel of
  ``suffix_tpu/ops/pallas_kernels.py`` (``_hist_kernel`` / ``_hist_pallas``
  / ``byte_histogram``). It feeds the SA-IS bucket layout
  (``ops/sais.py::_int_histogram``). The source note in the ``.cu`` file
  gives its bound and what the design does about it; ``histogram_plan``
  cuts the input for it, and ``histogram_battery`` times it on the card.
- ``copy_blocks``, ``copy5_blocks`` and ``minmax_stages``
  (``csrc/probes.cu``, wrappers in ``ops/probes.py``) replace the three
  Pallas kernels of ``scripts/round3_study.py`` ``section_bw``: the
  bandwidth battery.

A wrapper runs its kernel for a CUDA tensor and the plain PyTorch version
only for a CPU tensor: there is no fallback when a build or launch fails.
Each wrapper counts its launches in ``<wrapper>.launches``.

Build: every ``csrc/*.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all sources at once, into ``suffix_torch/_build/``, keyed by a
hash of the sources and flags. The libraries load with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NB = 512  # most bins byte_histogram takes (the TPU kernel's padded count)

# C entry points of each library: {source stem: {name: (argtypes, restype)}}.
# Pointers and the stream are c_void_p, or ctypes would cut them to 32 bits.
_P = ctypes.c_void_p
_SIGNATURES = {
    "histogram": {
        "byte_histogram_launch": ([_P, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int, _P, _P, _P],
                                  ctypes.c_int),
        "byte_histogram_occupancy": ([ctypes.POINTER(ctypes.c_int)] * 2,
                                     ctypes.c_int),
    },
    "probes": {
        "copy_blocks_launch": ([_P, _P, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int, _P], ctypes.c_int),
        "copy5_blocks_launch": ([_P] * 10 + [ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_int, _P],
                                ctypes.c_int),
        "minmax_stages_launch": ([_P, _P, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, _P],
                                 ctypes.c_int),
        "minmax_registers_launch": ([_P, _P, ctypes.c_int64, ctypes.c_int,
                                     _P], ctypes.c_int),
        "probes_ctas_per_sm": ([ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels of suffix_torch cannot be built")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing: one ``nvcc``
    per source, all started together. Returns {source stem: library}.
    Raises with the compiler's stderr if any build fails; the compiler's
    report (``-Xptxas -v``) is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: _lib_path(src) for src in sorted(CSRC.glob("*.cu"))}
    todo = [(src, libs[src.stem]) for src in sorted(CSRC.glob("*.cu"))
            if not libs[src.stem].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for src, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {src.name} "
                            f"(exit {proc.returncode}):\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def _library(stem: str) -> ctypes.CDLL:
    """The built library of ``csrc/<stem>.cu``, loaded once, with the
    argument types of its entry points set."""
    lib = _LIBS.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build()[stem]))
        for name, (argtypes, restype) in _SIGNATURES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIBS[stem] = lib
    return lib


def _kernel_name(mangled: str) -> str:
    """The first name of an Itanium-mangled function that is not an
    anonymous namespace (``_ZN41_GLOBAL__N__..._9probes_cu_...12copy_kernel
    Ev`` -> ``copy_kernel``), or the name as given."""
    i = 3 if mangled.startswith("_ZN") else 2
    while m := re.match(r"\d+", mangled[i:]):
        size = int(m.group())
        i += m.end()
        ident = mangled[i:i + size]
        i += size
        if not ident.startswith("_GLOBAL__N"):
            return ident
    return mangled


def ptxas_report(log: str) -> list[dict]:
    """Each kernel (entry function) of an ``nvcc -Xptxas -v`` log: its
    name, registers, stack frame, spill stores and loads and static shared
    memory in bytes, in the order compiled."""
    kernels: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = kernels.setdefault(m.group(1), {
                "kernel": _kernel_name(m.group(1)), "registers": None,
                "stack": 0, "spill_stores": 0, "spill_loads": 0, "smem": 0})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = kernels.get(m.group(1))
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current["stack"], current["spill_stores"], current[
                "spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["smem"] = int(smem.group(1)) if smem else 0
    return list(kernels.values())


# csrc/histogram.cu's kThreads and kChunkVecs: a CTA's threads, and the
# int4 vectors (32 KiB) of a chunk its bulk-copy ring loads at once.
HIST_THREADS = 1024
HIST_CHUNK_VECS = 2048


class HistogramPlan(NamedTuple):
    """How ``byte_histogram``'s kernel splits ``n`` int32 values: ``head``
    scalar values up to the first 16-byte boundary, ``vecs`` aligned int4
    vectors (the first ``chunks`` x HIST_CHUNK_VECS through the bulk-copy
    ring, the rest on plain loads), ``tail`` scalar values after them
    (head and tail at most 3 each), over ``grid`` CTAs."""
    head: int
    vecs: int
    chunks: int
    tail: int
    grid: int


def histogram_plan(addr: int, n: int, sms: int,
                   ctas_per_sm: int) -> HistogramPlan:
    """The split of ``n`` int32 values at device address ``addr`` (a
    multiple of 4) for a card of ``sms`` SMs that fits ``ctas_per_sm``
    CTAs of the kernel on each. The grid is ``sms * ctas_per_sm``, fewer
    when the chunks and the rest's pieces of HIST_THREADS vectors are
    fewer than that, and at least one CTA."""
    if addr % 4:
        raise ValueError(f"int32 values at address {addr:#x} are not "
                         "4-byte aligned")
    head = min(n, (-addr % 16) // 4)
    vecs = (n - head) // 4
    chunks = vecs // HIST_CHUNK_VECS
    units = chunks + -(-(vecs - chunks * HIST_CHUNK_VECS) // HIST_THREADS)
    return HistogramPlan(head, vecs, chunks, n - head - 4 * vecs,
                         max(1, min(sms * ctas_per_sm, units)))


_HIST_OCCUPANCY: dict[int, tuple[int, int]] = {}
_HIST_ACCUM: dict[tuple[int, int], torch.Tensor] = {}


def histogram_occupancy(device: torch.device) -> tuple[int, int]:
    """(SMs, CTAs an SM) of ``byte_histogram``'s kernel on the CUDA
    ``device``, by the occupancy calculator; asked once a device."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    found = _HIST_OCCUPANCY.get(index)
    if found is None:
        threads, ctas = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _library("histogram").byte_histogram_occupancy(
                ctypes.byref(threads), ctypes.byref(ctas))
        if err != 0:
            raise RuntimeError(f"byte_histogram_occupancy failed: CUDA "
                               f"error {err}")
        if threads.value != HIST_THREADS or ctas.value < 1:
            raise RuntimeError(f"byte_histogram's kernel has {threads.value}"
                               f" threads and fits {ctas.value} CTAs an SM;"
                               f" the plan expects {HIST_THREADS} and >= 1")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        found = _HIST_OCCUPANCY[index] = (sms, ctas.value)
    return found


def _histogram_accum(device: torch.device,
                     stream: torch.cuda.Stream) -> torch.Tensor:
    """The kernel's accumulator for one (device, stream): NB bins and a
    ticket, allocated zeroed once; each launch leaves it zero again, and
    launches on one stream never overlap."""
    key = (device.index, stream.cuda_stream)
    accum = _HIST_ACCUM.get(key)
    if accum is None:
        accum = _HIST_ACCUM[key] = torch.zeros(NB + 1, dtype=torch.int32,
                                               device=device)
    return accum


def byte_histogram_plain(values: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain PyTorch version of ``byte_histogram``: a scatter-add of the
    in-range mask. Used for CPU tensors, and as the reference for the
    kernel on the card."""
    ok = (values >= 0) & (values < n_bins)
    safe = torch.where(ok, values, 0).long()
    out = torch.zeros(n_bins, dtype=torch.int32, device=values.device)
    return out.index_add_(0, safe, ok.to(torch.int32))


def byte_histogram(values: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Histogram of 1-D int32 ``values`` in [0, n_bins), n_bins <= 512;
    values outside the range are dropped. int32 ``(n_bins,)``.

    A CUDA tensor runs the kernel of ``csrc/histogram.cu`` on the current
    stream, one launch and no other device operation (no synchronisation);
    a CPU tensor runs the plain version."""
    if values.dim() != 1:
        raise ValueError(f"byte_histogram takes a 1-D tensor, got "
                         f"{values.dim()}-D")
    if values.dtype != torch.int32:
        raise ValueError(f"byte_histogram takes int32, got {values.dtype}")
    if not 1 <= n_bins <= NB:
        raise ValueError(f"n_bins must be in [1, {NB}], got {n_bins}")
    if not values.is_contiguous():
        raise ValueError("byte_histogram takes a contiguous tensor")
    if values.device.type == "cpu":
        return byte_histogram_plain(values, n_bins)
    if values.device.type != "cuda":
        raise ValueError(f"byte_histogram runs on cuda or cpu, not "
                         f"{values.device}")
    n = values.shape[0]
    if n == 0:
        return torch.zeros(n_bins, dtype=torch.int32, device=values.device)
    out = torch.empty(n_bins, dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream()
        accum = _histogram_accum(values.device, stream)
        plan = histogram_plan(values.data_ptr(), n,
                              *histogram_occupancy(values.device))
        err = _library("histogram").byte_histogram_launch(
            values.data_ptr(), n, n_bins, plan.head, plan.vecs, plan.chunks,
            plan.grid, out.data_ptr(), accum.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"byte_histogram launch failed: CUDA error {err}")
    byte_histogram.launches += 1
    return out


byte_histogram.launches = 0


# ---- the histogram battery -------------------------------------------------
# histogram_inputs and histogram_battery import what they use inside and
# read no global of this module but each other: bench_probes runs their
# source in a process of another checkout, so that a tree without them
# (the parent) times its own byte_histogram on the same inputs, by the
# same loop.

def histogram_inputs(n: int = 1 << 22, device=None) -> dict:
    """{name: (values, n_bins)}: the battery's five int32 inputs of ``n``
    values from seed 0x4157. ``dna_sym`` is random DNA (``a``-``d``) as
    the SA-IS bucket layout sees it (byte + 1, 4 live bins of 258);
    ``dna_s_sym`` its S-phase counts' input (L positions at -1, from
    ``sais.classify_types``); ``bytes_sym`` uniform bytes + 1; ``one_bin``
    every value equal (the worst contention); ``bins512`` uniform over
    -5..519 into 512 bins (out-of-range values on both sides)."""
    import numpy as np
    import torch

    from suffix_torch.device import resolve_device
    from suffix_torch.ops.sais import classify_types

    dev = resolve_device(device)
    rng = np.random.default_rng(0x4157)

    def ints(lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, size=n,
                                             dtype=np.int32)).to(dev)

    text = ints(97, 101)
    sym = text + 1
    is_s, _ = classify_types(text)
    return {"dna_sym": (sym, 258),
            "dna_s_sym": (torch.where(is_s, sym, -1), 258),
            "bytes_sym": (ints(1, 257), 258),
            "one_bin": (torch.full((n,), 98, dtype=torch.int32, device=dev),
                        258),
            "bins512": (ints(-5, 520), 512)}


def histogram_battery(device=None) -> list[dict]:
    """``byte_histogram`` on each of ``histogram_inputs()`` at 2^22 values,
    timed on the CUDA ``device`` by CUDA events: the median of 30 runs
    after 5, the card spinning 10^6 cycles before each start event so the
    window holds device work only (as ``probes.time_ms``).

    Rows (one an input): ``warm_ms`` with nothing evicted (the input left
    in L2 by the last run: the SA-IS caller's state); ``ms`` after zeroing
    a 128 MiB scratch (L2 full of dirty lines); ``read_flush_ms`` after
    reading a 128 MiB scratch (clean lines only). Yardsticks: ``plain_ms``
    (``byte_histogram_plain``); ``library_ms`` and
    ``library_read_flush_ms``, ``torch.histc`` on the in-range values as
    float32 (converted outside the window; no host sync, the same counts);
    ``bincount_ms``, ``torch.bincount`` on the in-range values, which
    reads min and max back to the host (two syncs inside the window);
    ``torch_sum1_*``, an int32 ``sum`` of the same values, the read-rate
    reference, under each of the three states. ``bound_ms``: the values
    read once and the bins written once over 3.35 TB/s. Raises if the
    kernel, the plain version or ``histc`` disagree on any input."""
    import statistics

    import torch

    from suffix_torch.device import resolve_device
    from suffix_torch.ops.kernels import byte_histogram, byte_histogram_plain

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("histogram_battery times the card by CUDA events "
                         "and needs a CUDA device")
    zeroed = torch.empty(1 << 27, dtype=torch.uint8, device=dev)  # > L2
    clean = torch.ones(1 << 25, dtype=torch.int32, device=dev)  # 128 MiB
    flushes = {"warm_ms": None, "ms": zeroed.zero_,
               "read_flush_ms": clean.max}

    def time_ms(fn, flush=None):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(30):
            if flush is not None:
                flush()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    rows = []
    for name, (v, n_bins) in histogram_inputs(device=dev).items():
        ok = (v >= 0) & (v < n_bins)
        in_range = v[ok]
        as_float = in_range.float()
        want = byte_histogram_plain(v, n_bins)
        got = byte_histogram(v, n_bins)
        lib = torch.histc(as_float, bins=n_bins, min=0, max=n_bins)
        if not (torch.equal(got, want) and torch.equal(lib.int(), want)):
            raise AssertionError(f"byte_histogram, its plain version and "
                                 f"torch.histc disagree on {name}")

        def kernel():
            return byte_histogram(v, n_bins)

        def histc():
            return torch.histc(as_float, bins=n_bins, min=0, max=n_bins)

        def sum1():  # an int32 sum: torch's int64 one reads 3 times slower
            return v.sum(dtype=torch.int32)

        row = {"op": f"hist_{name}", "input": name, "n": v.numel(),
               "n_bins": n_bins}
        for key, flush in flushes.items():
            row[key] = time_ms(kernel, flush)
        for key, flush in flushes.items():
            row["torch_sum1_" + key] = time_ms(sum1, flush)
        row.update(
            plain_ms=time_ms(lambda: byte_histogram_plain(v, n_bins),
                             zeroed.zero_),
            library_ms=time_ms(histc, zeroed.zero_),
            library_read_flush_ms=time_ms(histc, clean.max),
            bincount_ms=time_ms(
                lambda: torch.bincount(in_range, minlength=n_bins),
                zeroed.zero_),
            bound_ms=4 * (v.numel() + n_bins) / 3.35e12 * 1e3,
            bound_by="bytes")
        rows.append(row)
    return rows
