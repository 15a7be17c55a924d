"""SuffixTable — the index + query API of the PyTorch port.

Port of ``suffix_tpu/table.py`` with the same behavioural contract
(reference: src/table.rs:54-312):

- ``new`` builds the sorted suffix table (byte-lexicographic, u32 byte
  offsets, at most 2^32-1 bytes); ``new_naive`` is the oracle build.
- ``from_parts`` / ``into_parts`` (de)construct without checking the
  suffix-table invariant, as the reference does.
- ``positions`` returns the UNORDERED SA slice ``table[start:end]``; an
  empty query matches nothing; offsets are byte offsets (a ``str`` text is
  indexed as its UTF-8 bytes).
- ``repr`` mirrors the reference Debug impl (src/table.rs:296-312).

The table carries its torch ``device``; ``device=None`` means CUDA and
raises where there is none. Engines: ``"device"`` (the default, prefix
doubling, ops/prefix_doubling.py), ``"sais"`` (the recursive SA-IS
pipeline, ops/sais.py), ``"native"`` (C++ SA-IS on the host, native/) and
``"auto"`` (native up to AUTO_NATIVE_MAX bytes, else device).

Queries take one of two routes (``query_route``). The device route is the
merge-join engine (ops/search2.py) on the index layout the JAX package
picks for the size: flat keys up to FLAT_KEYS_MAX_PAD, the deep keyless
index up to search2.DEEP_EXT_MAX_PAD, the lean keyless build past it. The
host route is the native binary search; under ``"auto"`` a CUDA table
answers single queries and batches of at most HOST_QUERY_MAX there, where
a device round trip would cost far more than the search. ``lcp_lens`` goes
through ops/lcp.py.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from suffix_torch import native
from suffix_torch.device import dispatch_is_expensive, resolve_device
from suffix_torch.ops import lcp as lcp_ops
from suffix_torch.ops import prefix_doubling
from suffix_torch.ops import sais
from suffix_torch.ops import search2
from suffix_torch.ops.naive import naive_table
from suffix_torch.ops.padding import PAD, bucket_size
from suffix_torch.ops.search import pack_queries
from suffix_torch.utils.profiling import annotate, root, span

MAX_TEXT_LEN = 0xFFFFFFFF  # u32 offsets, same cap as the reference

# Guards creation of an instance's _init_lock when the instance came
# through the small-build fast path (two threads racing __getattr__ must
# agree on ONE lock object).
_LOCK_CREATE = threading.Lock()

# Resolved once on the first small build: the raw C sais entry (the
# extension's METH_O function when built, else the Python wrapper), or
# False when no native library exists. Re-resolving per build would cost
# more than the C build of a short text.
_SMALL_SAIS = None


def _resolve_small_sais():
    global _SMALL_SAIS
    if not native.available():
        _SMALL_SAIS = False
        return False
    fp = native._load_fastpath()
    _SMALL_SAIS = fp.sais if fp is not None else native.sais
    return _SMALL_SAIS


# engine="auto": texts at or below this build on the host with the native
# SA-IS, larger ones on the device. The JAX package's value, measured on a
# TPU host (the parity rule of ROADMAP.md); the port's own crossover waits
# for the port bench.
AUTO_NATIVE_MAX = 1 << 22


def _as_bytes(text) -> tuple[bytes, bool]:
    """Normalize input text; returns (raw_bytes, was_str)."""
    if isinstance(text, str):
        return text.encode("utf-8"), True
    if isinstance(text, (bytes, bytearray, memoryview)):
        return bytes(text), False
    arr = np.asarray(text)
    if arr.dtype != np.uint8:
        raise TypeError("array texts must be uint8")
    return arr.tobytes(), False


class SuffixTable:
    """A lexicographically sorted table of suffix byte-offsets over a text."""

    # Queries per device dispatch. Hard cap 2^27: the qid field of the
    # merge-join tie word is 27 bits (ops/search2.py _fence_ranks_both).
    MAX_QUERY_BATCH = 1 << 18

    # Largest padded index that keeps the flat key copy (and the lazy
    # 12-word keys); larger ones keep fences and blocks only. The JAX
    # package's value, set for a 16 GB device; the port's own tuning is
    # later work.
    FLAT_KEYS_MAX_PAD = 1 << 26

    def __init__(self, text, table: np.ndarray, *, _was_str: bool | None = None,
                 device=None):
        raw, was_str = _as_bytes(text)
        if _was_str is not None:
            was_str = _was_str
        table = np.ascontiguousarray(np.asarray(table, dtype=np.uint32))
        if len(raw) != table.shape[0]:
            raise ValueError(
                f"text length ({len(raw)}) != table length ({table.shape[0]})"
            )
        self.device = resolve_device(device)
        self._raw = raw
        self._bytes = np.frombuffer(raw, dtype=np.uint8)
        self._table = table
        self._was_str = was_str
        # Device-side query index, created lazily on the first query.
        self._dev_text = None
        self._dev_table = None
        self._pk = self._pk_fence = self._pk_block = None
        self._ext = None  # 12-word (fences, blocks), on the first long query
        self._ext_block = None  # the deep keyless index's ext words
        self._host_handle = None  # native single-query handle (host route)
        self._init_lock = threading.RLock()  # guards the lazy device state
        # Per-instance routing (the class attribute is the default):
        # assigning one table's route must not re-route every table.
        self._query_route = type(self)._QUERY_ROUTE_DEFAULT
        # utils/metrics.py stats, from new(..., collect_stats=True) or a
        # checkpoint saved with them.
        self.build_stats = None

    # Lazily materialized state for fast-path instances (_new_small skips
    # __init__; __getattr__ below fills these on first touch).
    _LAZY_NONE = frozenset((
        "_dev_text", "_dev_table", "_pk", "_pk_fence", "_pk_block", "_ext",
        "_ext_block", "_host_handle", "build_stats",
    ))

    def __getattr__(self, name):
        # Only called for attributes missing from the instance: no cost
        # for fully initialized tables.
        if name in type(self)._LAZY_NONE:
            self.__dict__[name] = None
            return None
        if name == "_bytes":
            v = np.frombuffer(self._raw, dtype=np.uint8)
            self.__dict__[name] = v
            return v
        if name == "_query_route":
            v = type(self)._QUERY_ROUTE_DEFAULT
            self.__dict__[name] = v
            return v
        if name == "_init_lock":
            with _LOCK_CREATE:
                if "_init_lock" not in self.__dict__:
                    self.__dict__["_init_lock"] = threading.RLock()
            return self.__dict__["_init_lock"]
        raise AttributeError(name)

    @classmethod
    def _new_small(cls, raw: bytes, table: np.ndarray,
                   device: torch.device) -> "SuffixTable":
        """Minimal construction for the host small-build path: four fields
        (the device among them), the rest lazy (``__getattr__``), since
        the full ``__init__`` costs more than the C build of a short
        text."""
        st = cls.__new__(cls)
        d = st.__dict__
        d["_raw"] = raw
        d["_table"] = table
        d["_was_str"] = False
        d["device"] = device
        return st

    # ----------------------------------------------------------------- build

    @classmethod
    def new(cls, text, engine: str = "device", padding: str = "pow2",
            index_dtype: str = "u32", collect_stats: bool = False,
            device=None) -> "SuffixTable":
        """Build the suffix table; the table lives on ``device`` (``None``
        = CUDA).

        Engines (all give the same, unique suffix array):

        - ``"device"`` (default): prefix doubling, ops/prefix_doubling.py,
          with the JAX package's routes (periodic, patched, adaptive,
          two-phase, ladder); ``padding`` and ``index_dtype``
          ("u32"/"u64"/"auto") apply to it;
        - ``"sais"``: the SA-IS pipeline on the device, ops/sais.py;
        - ``"native"``: linear-time C++ SA-IS on the host CPU (native/);
        - ``"auto"``: native for texts of at most AUTO_NATIVE_MAX bytes
          when the native library builds, device otherwise.

        ``collect_stats=True`` builds through utils/metrics.py and attaches
        its stats dict as ``build_stats`` (route label, family, rounds,
        bytes/s, ...).

        Each call but the small-build fast path is a ``build`` root of the
        recorder (utils/profiling.py; attrs ``engine``, ``route``, ``n``,
        ``n_pad``); the device engine's layers are its spans and counters
        (ops/prefix_doubling.py).
        """
        if (type(text) is bytes and not collect_stats
                and index_dtype == "u32"
                and (engine == "native"
                     or (engine == "auto"
                         and len(text) <= AUTO_NATIVE_MAX))):
            # Small-build fast path: one C call and a four-field instance.
            fn = _SMALL_SAIS
            if fn is None:
                fn = _resolve_small_sais()
            if fn:
                if len(text) > MAX_TEXT_LEN:
                    raise ValueError("text is too large (max 2^32 - 1 bytes)")
                return cls._new_small(text, fn(text), resolve_device(device))
        with root("build", engine=engine):
            dev = resolve_device(device)
            raw, was_str = _as_bytes(text)
            if engine == "auto":
                engine = "device"
                if len(raw) <= AUTO_NATIVE_MAX and native.available():
                    engine = "native"
            if engine not in ("device", "sais", "native"):
                raise ValueError(f"unknown engine: {engine!r}")
            if len(raw) > MAX_TEXT_LEN:
                raise ValueError("text is too large (max 2^32 - 1 bytes)")
            annotate(engine=engine, n=len(raw))
            if collect_stats:
                from suffix_torch.utils.metrics import build_stats

                table, stats = build_stats(raw, engine=engine,
                                           index_dtype=index_dtype,
                                           padding=padding, device=dev)
                annotate(route=stats["engine"], n_pad=stats["n_pad"])
                with span("build.finish"):
                    st = cls(raw, table.astype(np.uint32), _was_str=was_str,
                             device=dev)
                st.build_stats = stats
                return st
            if engine == "device":
                table = prefix_doubling.suffix_array_bytes(
                    raw, padding=padding, index_dtype=index_dtype, device=dev)
            elif engine == "sais":
                annotate(route="sais-device",
                         n_pad=bucket_size(max(len(raw), 1)))
                table = sais.suffix_array_sais_recursive(raw, device=dev)
            else:
                annotate(route="native-sais", n_pad=len(raw))
                table = native.sais(raw)
            with span("build.finish"):
                return cls(raw, table, _was_str=was_str, device=dev)

    @classmethod
    def new_naive(cls, text, device=None) -> "SuffixTable":
        """Oracle construction (reference: src/table.rs:92-100)."""
        raw, was_str = _as_bytes(text)
        if len(raw) > MAX_TEXT_LEN:
            raise ValueError("text is too large (max 2^32 - 1 bytes)")
        return cls(raw, naive_table(raw), _was_str=was_str, device=device)

    @classmethod
    def from_parts(cls, text, table, device=None) -> "SuffixTable":
        """Reconstruction from parts (reference: src/table.rs:111-119).

        The suffix-table invariant is NOT checked, matching the reference.
        """
        return cls(text, table, device=device)

    def into_parts(self):
        """(text, table) — reference: src/table.rs:125-127."""
        return self.text(), self._table

    # ------------------------------------------------------------- accessors

    def table(self) -> np.ndarray:
        """The sorted suffix offsets (uint32)."""
        return self._table

    def text(self):
        """The indexed text (str if constructed from str, else bytes)."""
        return self._raw.decode("utf-8") if self._was_str else self._raw

    def text_bytes(self) -> bytes:
        return self._raw

    def __len__(self) -> int:
        return int(self._table.shape[0])

    def len(self) -> int:
        """Number of suffixes == number of bytes (src/table.rs:156-158)."""
        return len(self)

    def is_empty(self) -> bool:
        return len(self) == 0

    def suffix(self, i: int) -> str:
        """The i-th smallest suffix, as text (src/table.rs:168-170)."""
        s = self._raw[int(self._table[i]):]
        return s.decode("utf-8") if self._was_str else s

    def suffix_bytes(self, i: int) -> bytes:
        return self._raw[int(self._table[i]):]

    # ------------------------------------------------------------------- lcp

    def lcp_lens(self, method: str = "auto") -> np.ndarray:
        """LCP array (uint32), reference definition src/table.rs:348-361.

        ``method``: "auto" (the keyed device refine or the bulk ladder by
        survivor count, the native Kasai on survivor-dense corpora or LCPs
        past the ladder's budget, ops/lcp.py), "device" (the unbounded
        keyed refine), "native" (C++ Kasai on the host, linear time) or
        "kasai" (host numpy oracle). All give the same array."""
        if method in ("auto", "device"):
            # Reuse the query index's packed keys when already built.
            pk = self._pk if self._dev_text is not None else None
            return lcp_ops.lcp_from_sa(self._bytes, self._table, pk=pk,
                                       method=method, device=self.device)
        if method == "native":
            return native.kasai(self._raw, self._table)
        if method == "kasai":
            return lcp_ops.kasai_host(self._bytes, self._table)
        raise ValueError(f"unknown LCP method: {method!r}")

    # ----------------------------------------------------------------- query

    def _ensure_device(self):
        if self._dev_text is not None:
            return
        with self._init_lock:
            if self._dev_text is not None:
                return
            n = len(self)
            n_pad = bucket_size(max(n, 1))
            t = np.full((n_pad,), PAD, dtype=np.int32)
            t[:n] = self._bytes
            tab = np.zeros((n_pad,), dtype=np.int32)
            tab[:n] = self._table
            dev_text = torch.from_numpy(t).to(self.device)
            self._dev_table = torch.from_numpy(tab).to(self.device)
            if n_pad <= self.FLAT_KEYS_MAX_PAD:
                self._pk, self._pk_fence, self._pk_block = (
                    search2.build_query_index(dev_text, self._dev_table, n))
            elif (n_pad <= search2.DEEP_EXT_MAX_PAD
                  and n_pad < search2.LEAN_MIN_PAD):
                # Deep keyless: 8 fence words and a 6-word ext block, so
                # long patterns probe ext words instead of byte-refining.
                self._pk_fence, self._pk_block, self._ext_block = (
                    search2.build_query_index_keyless(
                        dev_text, self._dev_table, n,
                        key_words=search2.DEEP_FENCE_WORDS,
                        ext_words=search2.DEEP_EXT_WORDS))
            else:
                # Past the ext tier's gate: fences and blocks only, built
                # one word at a time from LEAN_MIN_PAD on.
                _, self._pk_fence, self._pk_block = (
                    search2.build_query_index(dev_text, self._dev_table, n,
                                              with_keys=False))
            # Published last: readiness is keyed off _dev_text.
            self._dev_text = dev_text

    def _ext_index(self):
        """(fences, blocks) of the 12-word keys, built once per table."""
        with self._init_lock:
            if self._ext is None:
                _, fence, block = search2.build_query_index(
                    self._dev_text, self._dev_table, len(self),
                    key_words=search2.EXT_KEY_WORDS)
                self._ext = (fence, block)
        return self._ext

    # Hybrid serving: on CUDA a device query is launches, copies and a
    # synchronising readback, so single queries and small batches answer
    # faster on the host (the native binary search, microseconds). Both
    # routes give the same bounds. The JAX package's values.
    _QUERY_ROUTE_DEFAULT = "auto"  # "auto" | "device" | "host"
    HOST_QUERY_MAX = 64  # "auto": batches up to this size go to the host

    # The single-query methods _host_ops binds onto the instance.
    _EXT_BOUND_OPS = ("positions", "contains", "count", "any_position")

    @property
    def query_route(self) -> str:
        return self._query_route

    @query_route.setter
    def query_route(self, value: str) -> None:
        # A new route unbinds the methods _host_ops bound onto the instance.
        self._query_route = value
        for name in self._EXT_BOUND_OPS:
            self.__dict__.pop(name, None)

    def _route_host(self, nq: int) -> bool:
        if self.query_route == "device":
            return False
        if self.query_route == "host":
            return True  # explicit: raises NativeUnavailable if unbuilt
        if nq > self.HOST_QUERY_MAX:
            return False
        return dispatch_is_expensive(self.device) and native.available()

    def _host_ops(self):
        """The host route's single-query operations (the extension's, or
        the ctypes handle's without it), bound onto the instance: the next
        ``st.positions(q)`` is one instance-dict lookup and one call (the
        extension takes bytes, str and buffers in C). The ``query_route``
        setter unbinds them."""
        handle = self._ensure_host_handle()
        ops = handle._ext if handle._ext is not None else handle
        for name in self._EXT_BOUND_OPS:
            self.__dict__[name] = getattr(ops, name)
        return ops

    def _bounds_batch(self, queries: Sequence) -> tuple[np.ndarray, np.ndarray]:
        """(start, count) rank bounds, int64, for a query batch.

        Query length and batch size are bucketed to powers of two as in
        the JAX package; batches beyond MAX_QUERY_BATCH go in chunks.
        Small batches of a CUDA table answer on the host (``query_route``).
        """
        nq = len(queries)
        if self._route_host(nq):
            if nq == 1:  # microsecond path: cached pointers, one call
                s, c = self._ensure_host_handle().bounds_one(queries[0])
                return np.array([s], np.int64), np.array([c], np.int64)
            starts, counts = native.bounds_batch(self._raw, self._table,
                                                 queries)
            return starts.astype(np.int64), counts.astype(np.int64)
        self._ensure_device()
        if nq > self.MAX_QUERY_BATCH:
            starts, counts = [], []
            for i in range(0, nq, self.MAX_QUERY_BATCH):
                s, c = self._bounds_batch(queries[i:i + self.MAX_QUERY_BATCH])
                starts.append(s)
                counts.append(c)
            return np.concatenate(starts), np.concatenate(counts)
        q, qlens = pack_queries(queries)
        m_pad = bucket_size(q.shape[1], minimum=8)
        q_pad = bucket_size(nq, minimum=8)
        full_q = np.full((q_pad, m_pad), PAD, dtype=np.int32)
        full_q[:nq, : q.shape[1]] = q
        full_lens = np.zeros((q_pad,), dtype=np.int32)
        full_lens[:nq] = qlens
        pk_fence, pk_block = self._pk_fence, self._pk_block
        max_live_qlen = int(qlens.max(initial=0))
        n = len(self)
        q_dev = torch.from_numpy(full_q).to(self.device)
        lens_dev = torch.from_numpy(full_lens).to(self.device)
        if max_live_qlen > 3 * len(pk_fence) and self._ext_block is not None:
            # Deep keyless route: merge join, ext-word probe on the long
            # lanes, byte tail past the ext coverage.
            starts, counts = search2.bounds_batch_merge_deep(
                self._dev_text, n, self._dev_table, n, pk_fence, pk_block,
                self._ext_block, q_dev, lens_dev, m_pad)
        else:
            if max_live_qlen > search2.KEY_SYMS and self._pk is not None:
                # Long patterns: exact merge join to 36 bytes instead of
                # byte-refining from 18; past that the refine still
                # applies.
                pk_fence, pk_block = self._ext_index()
            starts, counts = search2.bounds_batch_merge(
                self._dev_text, n, self._dev_table, n, pk_fence, pk_block,
                q_dev, lens_dev, m_pad)
        return (starts.cpu().numpy()[:nq].astype(np.int64),
                counts.cpu().numpy()[:nq].astype(np.int64))

    def _ensure_host_handle(self):
        if self._host_handle is None:
            with self._init_lock:  # double-checked: creation is idempotent
                if self._host_handle is None:
                    self._host_handle = native.BoundsHandle(self._raw,
                                                            self._table)
        return self._host_handle

    def positions(self, query) -> np.ndarray:
        """All byte offsets where ``query`` occurs, in SA (unordered) order
        (reference: src/table.rs:223-259). With the extension built, the
        host route is one C call returning a read-only view of the
        table."""
        if self._route_host(1):
            return self._host_ops().positions(query)
        starts, counts = self._bounds_batch([query])
        s = int(starts[0])
        return self._table[s : s + int(counts[0])]

    def positions_batch(self, queries: Sequence) -> list[np.ndarray]:
        """``positions`` for many queries in one device dispatch."""
        starts, counts = self._bounds_batch(queries)
        return [self._table[int(s) : int(s) + int(c)] for s, c in zip(starts, counts)]

    def contains(self, query) -> bool:
        """Existence test (reference: src/table.rs:197-199)."""
        if self._route_host(1):
            return self._host_ops().contains(query)
        _, counts = self._bounds_batch([query])
        return bool(counts[0] > 0)

    def contains_batch(self, queries: Sequence) -> np.ndarray:
        _, counts = self._bounds_batch(queries)
        return counts > 0

    def count(self, query) -> int:
        """Number of occurrences (no slice materialization)."""
        if self._route_host(1):
            return self._host_ops().count(query)
        _, counts = self._bounds_batch([query])
        return int(counts[0])

    def count_batch(self, queries: Sequence) -> np.ndarray:
        _, counts = self._bounds_batch(queries)
        return counts

    def any_position(self, query):
        """An arbitrary matching byte offset, or None
        (reference: src/table.rs:279-293)."""
        if self._route_host(1):
            return self._host_ops().any_position(query)
        starts, counts = self._bounds_batch([query])
        if counts[0] == 0:
            return None
        return int(self._table[int(starts[0])])

    def verify(self, device: bool = False) -> bool:
        """Certify that ``table()`` is exactly the suffix array of the
        text: O(n) on the host (permutation, first-byte monotonicity,
        successor-rank induction; utils/verify.py), or with
        ``device=True`` two sorts and reductions on the table's device."""
        from suffix_torch.utils.verify import verify_suffix_array

        return verify_suffix_array(self._raw, self._table,
                                   device=self.device if device else False)

    # ------------------------------------------------------------------ misc

    def __eq__(self, other) -> bool:
        if not isinstance(other, SuffixTable):
            return NotImplemented
        return self._raw == other._raw and np.array_equal(self._table, other._table)

    def __hash__(self):
        return hash((self._raw, self._table.tobytes()))

    def __repr__(self) -> str:
        # Mirrors the reference Debug impl (src/table.rs:296-312).
        lines = ["", "-----------------------------------------", "SUFFIX TABLE"]
        try:
            lines.append(f"text: {self.text()}")
        except UnicodeDecodeError:
            lines.append(f"text: {self._raw!r}")
        for rank, sufstart in enumerate(self._table):
            suf = self._raw[int(sufstart):]
            shown = suf.decode("utf-8", errors="replace") if self._was_str else suf
            lines.append(f"suffix[{rank}] {int(sufstart)}, {shown}")
        lines.append("-----------------------------------------")
        return "\n".join(lines) + "\n"
