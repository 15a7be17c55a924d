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
pipeline, ops/sais.py), ``"auto"`` and ``"naive"``. Every query goes
through the device merge-join engine (ops/search2.py) on the index layout
the JAX package picks for the size: flat keys up to FLAT_KEYS_MAX_PAD, the
deep keyless index up to search2.DEEP_EXT_MAX_PAD, the lean keyless build
past it; ``lcp_lens`` through ops/lcp.py.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from suffix_torch.device import resolve_device
from suffix_torch.ops import lcp as lcp_ops
from suffix_torch.ops import prefix_doubling
from suffix_torch.ops import sais
from suffix_torch.ops import search2
from suffix_torch.ops.naive import naive_table
from suffix_torch.ops.padding import PAD, bucket_size
from suffix_torch.ops.search import pack_queries

MAX_TEXT_LEN = 0xFFFFFFFF  # u32 offsets, same cap as the reference

_NATIVE_UNPORTED = ("the native C++ engine is not ported to suffix_torch "
                    "yet; see ROADMAP.md Queue 1 item 4")


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


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


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
        self._init_lock = threading.RLock()  # guards the lazy device state
        self.build_stats = None

    # ----------------------------------------------------------------- build

    @classmethod
    def new(cls, text, engine: str = "device", padding: str = "pow2",
            index_dtype: str = "u32", collect_stats: bool = False,
            device=None) -> "SuffixTable":
        """Build the suffix table on ``device`` (``None`` = CUDA).

        Engines (all give the same, unique suffix array):

        - ``"device"`` (default): prefix doubling, ops/prefix_doubling.py,
          with the JAX package's routes (periodic, patched, adaptive,
          two-phase, ladder); ``padding`` and ``index_dtype``
          ("u32"/"u64"/"auto") apply to it;
        - ``"sais"``: the SA-IS pipeline on the device, ops/sais.py;
        - ``"auto"``: the JAX package takes its native engine for small
          texts when that library is present; the native engine is not
          ported, so ``"auto"`` is ``"device"`` here;
        - ``"naive"``: the host oracle.

        ``"native"`` raises ``NotImplementedError``. ``collect_stats=True``
        attaches a dict as ``build_stats``: for ``"device"`` the keys of
        ``suffix_tpu/utils/metrics.py::build_stats`` (route label, family,
        h0, sigma, rounds, h_final, tie trajectory or the two-phase switch
        state); for ``"sais"`` the recursion depth and rounds per phase.
        """
        dev = resolve_device(device)
        if engine == "native":
            raise NotImplementedError(f"engine='native': {_NATIVE_UNPORTED}")
        if engine == "auto":
            engine = "device"
        if engine not in ("device", "sais", "naive"):
            raise ValueError(f"unknown engine: {engine!r}")
        raw, was_str = _as_bytes(text)
        if len(raw) > MAX_TEXT_LEN:
            raise ValueError("text is too large (max 2^32 - 1 bytes)")
        n = len(raw)
        stats = ({"schema": 1, "n_bytes": n, "index_dtype": index_dtype,
                  "device": _device_name(dev)} if collect_stats else None)
        counters: dict = {}
        t0 = time.perf_counter()
        if engine == "device":
            table = prefix_doubling.suffix_array_bytes(
                raw, padding=padding, index_dtype=index_dtype, device=dev,
                stats=stats)
        elif engine == "sais":
            table = sais.suffix_array_sais_recursive(raw, stats=counters,
                                                     device=dev)
        else:
            table = naive_table(raw)
        dt = time.perf_counter() - t0
        st = cls(raw, table, _was_str=was_str, device=dev)
        if collect_stats and engine != "device":
            stats.update(
                n_pad=bucket_size(max(n, 1)), index_dtype="u32",
                engine="sais-device" if engine == "sais" else "naive",
                engine_family=engine, elapsed_s=round(dt, 6),
                bytes_per_s=round(n / max(dt, 1e-12), 1))
            if engine == "sais":
                stats["recursion_depth"] = counters.get("depth", 0)
                for key in ("l_rounds", "s_rounds", "substring_rounds"):
                    stats[key] = counters.get(key, 0)
        st.build_stats = stats
        return st

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
        survivor count, the host Kasai on survivor-dense corpora or LCPs
        past the ladder's budget, ops/lcp.py), "device" (the
        unbounded keyed refine) or "kasai" (host numpy). "native" raises:
        that engine is not ported. All give the same array."""
        if method in ("auto", "device"):
            # Reuse the query index's packed keys when already built.
            pk = self._pk if self._dev_text is not None else None
            return lcp_ops.lcp_from_sa(self._bytes, self._table, pk=pk,
                                       method=method, device=self.device)
        if method == "kasai":
            return lcp_ops.kasai_host(self._bytes, self._table)
        if method == "native":
            raise NotImplementedError(f"method='native': {_NATIVE_UNPORTED}")
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

    def _bounds_batch(self, queries: Sequence) -> tuple[np.ndarray, np.ndarray]:
        """(start, count) rank bounds, int64, for a query batch.

        Query length and batch size are bucketed to powers of two as in
        the JAX package; batches beyond MAX_QUERY_BATCH go in chunks.
        """
        nq = len(queries)
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

    def positions(self, query) -> np.ndarray:
        """All byte offsets where ``query`` occurs, in SA (unordered) order
        (reference: src/table.rs:223-259)."""
        starts, counts = self._bounds_batch([query])
        s, c = int(starts[0]), int(counts[0])
        return self._table[s : s + c]

    def positions_batch(self, queries: Sequence) -> list[np.ndarray]:
        """``positions`` for many queries in one device dispatch."""
        starts, counts = self._bounds_batch(queries)
        return [self._table[int(s) : int(s) + int(c)] for s, c in zip(starts, counts)]

    def contains(self, query) -> bool:
        """Existence test (reference: src/table.rs:197-199)."""
        _, counts = self._bounds_batch([query])
        return bool(counts[0] > 0)

    def contains_batch(self, queries: Sequence) -> np.ndarray:
        _, counts = self._bounds_batch(queries)
        return counts > 0

    def count(self, query) -> int:
        """Number of occurrences (no slice materialization)."""
        _, counts = self._bounds_batch([query])
        return int(counts[0])

    def count_batch(self, queries: Sequence) -> np.ndarray:
        _, counts = self._bounds_batch(queries)
        return counts

    def any_position(self, query):
        """An arbitrary matching byte offset, or None
        (reference: src/table.rs:279-293)."""
        starts, counts = self._bounds_batch([query])
        if counts[0] == 0:
            return None
        return int(self._table[int(starts[0])])

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
