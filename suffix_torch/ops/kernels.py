"""Hand-written CUDA kernels of the port, their plain versions, and the
build that compiles them from ``suffix_torch/csrc`` at first use.

Kernel inventory:

- ``byte_histogram`` (``csrc/histogram.cu``) replaces the Pallas kernel of
  ``suffix_tpu/ops/pallas_kernels.py`` (``_hist_kernel`` / ``_hist_pallas``
  / ``byte_histogram``). It feeds the SA-IS bucket layout
  (``ops/sais.py::_int_histogram``). The source note in the ``.cu`` file
  gives its bound and what the design does about it.
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
        "byte_histogram_launch": ([_P, ctypes.c_int64, ctypes.c_int, _P, _P],
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
    stream (no synchronisation); a CPU tensor runs the plain version."""
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
    out = torch.zeros(n_bins, dtype=torch.int32, device=values.device)
    n = values.shape[0]
    if n == 0:
        return out
    launch = _library("histogram").byte_histogram_launch
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(values.data_ptr(), n, n_bins, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"byte_histogram launch failed: CUDA error {err}")
    byte_histogram.launches += 1
    return out


byte_histogram.launches = 0
