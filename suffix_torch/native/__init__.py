"""Native (C++) host components of the port: SA-IS, Kasai and query bounds.

Port of ``suffix_tpu/native/__init__.py``. The sources in ``csrc/`` are
byte-for-byte copies of the JAX package's, so both packages give the same
arrays. Two builds, each on first use, with ``g++`` and CXX_FLAGS:

- ``libsaistpu`` from ``csrc/saistpu.cpp``, loaded with ``ctypes``
  (``sais``, ``kasai``, ``bounds_batch`` and ``BoundsHandle``'s fallback);
- the CPython extension ``_fastpath`` from ``csrc/fastpath.cpp`` (one C
  method call per single query or small build), loaded under its own spec
  name, ``suffix_torch.native._fastpath``, so it lives beside the JAX
  package's extension in one process. Without Python or numpy headers it
  is missing and the ctypes route answers, as in the JAX package.

Both land in ``suffix_torch/_build/`` (git-ignored), named by a hash of the
sources, the flags and the host CPU as the compiler resolves
``-march=native``, so a tree copied to another machine never loads a
library built for another CPU. A build writes a temporary file and renames
it into place, so processes that race the first build each load a whole
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
CSRC = _DIR / "csrc"
BUILD_DIR = _DIR.parent / "_build"
_SRC = CSRC / "saistpu.cpp"
_FAST_SRC = CSRC / "fastpath.cpp"
_HDRS = (CSRC / "bounds_core.h", CSRC / "sais_core.h")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_load_error: "NativeUnavailable | None" = None  # cached failure: no retries
_fastpath = None  # the CPython extension module, or False if unbuildable
fastpath_error: str | None = None  # why the extension did not load
_target: str | None = None


class NativeUnavailable(RuntimeError):
    pass


def _cpu_target() -> str:
    """What ``-march=native`` means on this host: the compiler's own
    expansion of it (its cc1plus command line), memoized."""
    global _target
    if _target is None:
        try:
            proc = subprocess.run(
                [CXX, "-march=native", "-E", "-v", "-x", "c++", "-"],
                input="", capture_output=True, text=True)
        except OSError as e:  # no compiler at all
            raise NativeUnavailable(f"cannot run {CXX}: {e}") from e
        lines = [ln for ln in proc.stderr.splitlines() if "cc1plus" in ln]
        if proc.returncode != 0 or not lines:
            raise NativeUnavailable(
                f"{CXX} -march=native failed:\n{proc.stderr}")
        # The first token is the cc1plus path; the rest are the flags.
        _target = " ".join(lines[0].split()[1:])
    return _target


def _out_path(src: Path, stem: str, suffix: str, extra: tuple) -> Path:
    h = hashlib.sha256()
    for path in (src, *_HDRS):
        h.update(path.read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS, *extra)).encode())
    h.update(_cpu_target().encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{suffix}"


def _compile(src: Path, out: Path, extra: tuple = ()) -> None:
    """Build ``src`` into ``out`` unless it is there: into a temporary
    name first, then renamed into place."""
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, *extra, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeUnavailable(f"cannot run {CXX}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(
            f"failed to build {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)


def library_path() -> Path:
    """Where ``libsaistpu`` for this host and these sources lives."""
    return _out_path(_SRC, "libsaistpu", ".so", ())


def _ext_flags() -> tuple:
    return (f"-I{sysconfig.get_paths()['include']}",
            f"-I{np.get_include()}")


def extension_path() -> Path:
    """Where the ``_fastpath`` extension for this host, this Python, this
    numpy and these sources lives."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    # numpy's version joins the key: the extension compiles against its
    # C API headers.
    return _out_path(_FAST_SRC, "_fastpath", suffix,
                     _ext_flags() + (np.__version__,))


def _load() -> ctypes.CDLL:
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise _load_error
        try:
            path = library_path()
            _compile(_SRC, path)
        except NativeUnavailable as e:
            _load_error = e
            raise
        except OSError as e:
            _load_error = NativeUnavailable(f"cannot build native lib: {e}")
            raise _load_error from e
        # ctypes opens with RTLD_LOCAL: the JAX package's copy of the same
        # stpu_* symbols, loaded in the same process, stays apart.
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.stpu_sais_u8.argtypes = [u8p, ctypes.c_uint32, u32p]
        lib.stpu_sais_u8.restype = ctypes.c_int
        lib.stpu_kasai_u8.argtypes = [u8p, u32p, ctypes.c_uint32, u32p]
        lib.stpu_kasai_u8.restype = None
        lib.stpu_bounds_batch.argtypes = [
            u8p, ctypes.c_uint32, u32p, u8p, u32p, ctypes.c_uint32, u32p, u32p,
        ]
        lib.stpu_bounds_batch.restype = None
        lib.stpu_bounds_one.argtypes = [
            u8p, ctypes.c_uint32, u32p, ctypes.c_char_p, ctypes.c_uint32, u32p,
        ]
        lib.stpu_bounds_one.restype = None
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _load_fastpath():
    """The CPython extension for single queries and small builds, or None.

    ctypes costs microseconds of marshalling per foreign call; a METH_O
    extension method about a tenth of one. Any failure to build or load
    leaves the ctypes route, as in the JAX package; ``fastpath_error``
    says why.
    """
    global _fastpath, fastpath_error
    # Lock-free after the first load: one global read.
    fp = _fastpath
    if fp is not None:
        return fp or None
    with _lock:
        if _fastpath is not None:
            return _fastpath or None
        try:
            path = extension_path()
            _compile(_FAST_SRC, path, _ext_flags())
            name = "suffix_torch.native._fastpath"
            loader = importlib.machinery.ExtensionFileLoader(name, str(path))
            spec = importlib.util.spec_from_file_location(name, str(path),
                                                          loader=loader)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _fastpath = mod
        except Exception as e:  # no headers, odd platform: ctypes answers
            fastpath_error = f"{type(e).__name__}: {e}"
            _fastpath = False
            return None
        return _fastpath


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _as_u8(data) -> np.ndarray:
    return np.ascontiguousarray(
        np.frombuffer(bytes(data), dtype=np.uint8)
        if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8))


def sais(data: bytes | np.ndarray) -> np.ndarray:
    """Suffix array (uint32) via native SA-IS: linear time, one core.

    Goes through the CPython extension when it is built (one C call; the
    ctypes route pays microseconds of marshalling, which dominate small
    builds).
    """
    fp = _load_fastpath()
    if fp is not None:
        return fp.sais(data if type(data) is bytes else
                       (bytes(data) if isinstance(data, (bytes, bytearray))
                        else np.asarray(data, np.uint8).tobytes()))
    lib = _load()
    arr = _as_u8(data)
    n = arr.shape[0]
    out = np.empty(n, dtype=np.uint32)
    if n:
        lib.stpu_sais_u8(_u8(arr), n, _u32(out))
    return out


def kasai(data: bytes | np.ndarray, sa: np.ndarray) -> np.ndarray:
    """LCP array (uint32) via native Kasai: linear time."""
    lib = _load()
    arr = _as_u8(data)
    sa = np.ascontiguousarray(sa, dtype=np.uint32)
    n = arr.shape[0]
    out = np.zeros(n, dtype=np.uint32)
    if n:
        lib.stpu_kasai_u8(_u8(arr), _u32(sa), n, _u32(out))
    return out


class BoundsHandle:
    """Cached single-query handle over one (text, sa) pair.

    Pins the text and SA buffers and their ctypes pointers once, so each
    ``bounds_one`` call is one foreign call with no per-call array
    marshalling: the microsecond-scale serving path for single queries.
    """

    def __init__(self, data: bytes | np.ndarray, sa: np.ndarray):
        self._lib = _load()
        self._text = _as_u8(data)
        self._sa = np.ascontiguousarray(sa, dtype=np.uint32)
        if self._sa.shape[0] != self._text.shape[0]:
            raise ValueError("text/sa length mismatch")
        self._n = self._text.shape[0]
        self._tp = _u8(self._text)
        self._sp = _u32(self._sa)
        self._fn = self._lib.stpu_bounds_one
        # Preferred route: the CPython extension (one C method call).
        fp = _load_fastpath()
        self._ext = fp.Bounds(self._text, self._sa) if fp else None
        if self._ext is not None:
            self.bounds_one = self._bounds_one_ext  # instance-level rebind

    _OUT2 = ctypes.c_uint32 * 2

    def _bounds_one_ext(self, query) -> tuple[int, int]:
        if type(query) is not bytes:
            query = (query.encode("utf-8") if isinstance(query, str)
                     else bytes(query))
        return self._ext.bounds(query)

    def bench_c_only(self, query, iters: int = 200_000,
                     op: str = "bounds") -> float | None:
        """Pure-C ns per call for one query, or None without the extension.

        No interpreter or FFI cost: ``op`` "bounds" (both binary searches,
        the positions path) or "contains" (early-exit existence test).
        """
        if self._ext is None:
            return None
        q = query.encode("utf-8") if isinstance(query, str) else bytes(query)
        fn = (self._ext.bench_contains if op == "contains"
              else self._ext.bench)
        return fn(q, iters)

    def bounds_one(self, query) -> tuple[int, int]:
        """(start, count) rank bounds for one query.

        Thread-safe: the output scratch is per call, only the pinned text
        and SA are shared. The scratch is a raw ctypes array, not numpy
        (``ndarray.ctypes`` costs microseconds per cast). This ctypes route
        is the fallback; instances rebind to the extension when it builds.
        """
        q = query.encode("utf-8") if isinstance(query, str) else bytes(query)
        out = self._OUT2()
        self._fn(self._tp, self._n, self._sp, q, len(q), out)
        return out[0], out[1]

    # The extension's four single-query methods on the ctypes route, for
    # SuffixTable's host route when the extension did not build.
    def positions(self, query) -> np.ndarray:
        s, c = self.bounds_one(query)
        return self._sa[s : s + c]

    def contains(self, query) -> bool:
        return self.bounds_one(query)[1] > 0

    def count(self, query) -> int:
        return self.bounds_one(query)[1]

    def any_position(self, query) -> int | None:
        s, c = self.bounds_one(query)
        return int(self._sa[s]) if c else None


def bounds_batch(data: bytes | np.ndarray, sa: np.ndarray,
                 queries) -> tuple[np.ndarray, np.ndarray]:
    """(start, count) rank bounds (uint32) per query, on the host."""
    lib = _load()
    arr = _as_u8(data)
    sa = np.ascontiguousarray(sa, dtype=np.uint32)
    qbytes = [q.encode("utf-8") if isinstance(q, str) else bytes(q)
              for q in queries]
    offsets = np.zeros(len(qbytes) + 1, dtype=np.uint32)
    for i, q in enumerate(qbytes):
        offsets[i + 1] = offsets[i] + len(q)
    blob = np.frombuffer(b"".join(qbytes) or b"\x00", dtype=np.uint8).copy()
    starts = np.zeros(len(qbytes), dtype=np.uint32)
    counts = np.zeros(len(qbytes), dtype=np.uint32)
    if len(qbytes):
        lib.stpu_bounds_batch(
            _u8(arr), arr.shape[0], _u32(sa), _u8(blob), _u32(offsets),
            len(qbytes), _u32(starts), _u32(counts),
        )
    return starts, counts
