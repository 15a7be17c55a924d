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
raises where there is none. Engines ported so far: ``"sais"`` (the
recursive SA-IS pipeline, ops/sais.py) and ``"naive"``. Every query goes
through the device merge-join engine (ops/search2.py).
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np
import torch

from suffix_torch.device import resolve_device
from suffix_torch.ops import sais
from suffix_torch.ops import search2
from suffix_torch.ops.naive import naive_table
from suffix_torch.ops.padding import PAD, bucket_size
from suffix_torch.ops.search import pack_queries

MAX_TEXT_LEN = 0xFFFFFFFF  # u32 offsets, same cap as the reference

# Engines of the JAX package that this port does not have yet, with the
# ROADMAP.md item that ports each.
_UNPORTED_ENGINES = {
    "device": "Queue 1 item 3 (classic prefix-doubling engine)",
    "native": "Queue 1 item 4 (native C++ SA-IS engine)",
    "auto": "Queue 1 items 3 and 4 (doubling and native engines)",
}


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

    # Largest padded index whose flat key copy the port builds; larger
    # indexes need the keyless routes, which are not ported yet.
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
        self._pk_fence = self._pk_block = None
        self._ext = None  # 12-word (fences, blocks), on the first long query
        self._init_lock = threading.RLock()  # guards the lazy device state
        self.build_stats = None

    # ----------------------------------------------------------------- build

    @classmethod
    def new(cls, text, engine: str = "sais", device=None,
            collect_stats: bool = False) -> "SuffixTable":
        """Build the suffix table on ``device`` (``None`` = CUDA).

        Engines: ``"sais"`` (SA-IS on the device, ops/sais.py) and
        ``"naive"`` (the host oracle). ``collect_stats=True`` attaches a
        dict as ``build_stats``: engine, sizes, elapsed seconds and, for
        ``"sais"``, the recursion depth and the rounds of each phase.
        """
        dev = resolve_device(device)
        if engine in _UNPORTED_ENGINES:
            raise NotImplementedError(
                f"engine={engine!r} is not ported to suffix_torch yet; see "
                f"ROADMAP.md {_UNPORTED_ENGINES[engine]}")
        if engine not in ("sais", "naive"):
            raise ValueError(f"unknown engine: {engine!r}")
        raw, was_str = _as_bytes(text)
        if len(raw) > MAX_TEXT_LEN:
            raise ValueError("text is too large (max 2^32 - 1 bytes)")
        counters: dict = {}
        t0 = time.perf_counter()
        if engine == "sais":
            table = sais.suffix_array_sais_recursive(raw, stats=counters,
                                                     device=dev)
        else:
            table = naive_table(raw)
        dt = time.perf_counter() - t0
        st = cls(raw, table, _was_str=was_str, device=dev)
        if collect_stats:
            n = len(raw)
            st.build_stats = {
                "schema": 1, "n_bytes": n, "n_pad": bucket_size(max(n, 1)),
                "index_dtype": "u32", "device": _device_name(dev),
                "engine": "sais-device" if engine == "sais" else "naive",
                "engine_family": engine,
                "elapsed_s": round(dt, 6),
                "bytes_per_s": round(n / max(dt, 1e-12), 1),
            }
            if engine == "sais":
                st.build_stats["recursion_depth"] = counters.get("depth", 0)
                for key in ("l_rounds", "s_rounds", "substring_rounds"):
                    st.build_stats[key] = counters.get(key, 0)
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

    # ----------------------------------------------------------------- query

    def _ensure_device(self):
        if self._dev_text is not None:
            return
        with self._init_lock:
            if self._dev_text is not None:
                return
            n = len(self)
            n_pad = bucket_size(max(n, 1))
            if n_pad > self.FLAT_KEYS_MAX_PAD:
                raise NotImplementedError(
                    f"padded index size {n_pad} > FLAT_KEYS_MAX_PAD="
                    f"{self.FLAT_KEYS_MAX_PAD} needs the keyless query "
                    "routes, which are not ported yet (ROADMAP.md Queue 1)")
            t = np.full((n_pad,), PAD, dtype=np.int32)
            t[:n] = self._bytes
            tab = np.zeros((n_pad,), dtype=np.int32)
            tab[:n] = self._table
            dev_text = torch.from_numpy(t).to(self.device)
            self._dev_table = torch.from_numpy(tab).to(self.device)
            _, self._pk_fence, self._pk_block = search2.build_query_index(
                dev_text, self._dev_table, n)
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
        if int(qlens.max(initial=0)) > search2.KEY_SYMS:
            # Long patterns: exact merge join to 36 bytes instead of
            # byte-refining from 18; past that the refine still applies.
            pk_fence, pk_block = self._ext_index()
        n = len(self)
        starts, counts = search2.bounds_batch_merge(
            self._dev_text, n, self._dev_table, n, pk_fence, pk_block,
            torch.from_numpy(full_q).to(self.device),
            torch.from_numpy(full_lens).to(self.device), m_pad)
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
