"""Generalized (multi-document) suffix index, ported from
``suffix_tpu/multidoc.py``.

The reference punts on generalized suffix arrays and documents a
compromise (README.md:60-74): concatenate the documents separated by a
character that appears in none of them (NUL), record per-document offsets,
and binary-search the offsets to map a global match position back to its
document. This module promotes that scheme to a first-class API on top of
:class:`suffix_torch.table.SuffixTable`, built on the caller's device.

Matches that span a separator are suppressed (a query can never contain
the separator byte unless the caller opts in), which removes the
"technically incorrect" caveat of the reference's description for any
query that does not contain NUL.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from suffix_torch.table import SuffixTable, _as_bytes


class MultiDocIndex:
    """Suffix index over multiple documents with doc-id mapping."""

    SEPARATOR = b"\x00"

    def __init__(self, docs: Sequence, *, build: bool = True, mesh=None,
                 device=None):
        """Index ``docs`` (str or bytes each) on ``device`` (``None`` =
        CUDA). With ``mesh`` (``parallel/mesh.py``; every rank of it
        calls this) the table is built by the sharded build, for corpora
        larger than one card, and lives on ``device`` or, by default, on
        the rank's device."""
        self._was_str = [isinstance(d, str) for d in docs]
        self._docs = [_as_bytes(d)[0] for d in docs]
        for d in self._docs:
            if self.SEPARATOR in d:
                raise ValueError(
                    "documents must not contain the NUL separator byte; "
                    "strip or re-encode them first"
                )
        joined = self.SEPARATOR.join(self._docs)
        # starts[i] = global byte offset of document i; ends[i] exclusive.
        starts = [0]
        for d in self._docs[:-1]:
            starts.append(starts[-1] + len(d) + 1)
        self._starts = np.asarray(starts, dtype=np.int64)
        self._ends = self._starts + np.asarray([len(d) for d in self._docs], dtype=np.int64)
        if build and mesh is not None:
            from suffix_torch.parallel.dist_build import suffix_array_sharded

            self._st = SuffixTable.from_parts(
                joined, suffix_array_sharded(joined, mesh),
                device=mesh.device if device is None else device)
        else:
            self._st = (SuffixTable.new(joined, device=device) if build
                        else None)
        self._joined = joined

    @property
    def suffix_table(self) -> SuffixTable:
        return self._st

    @property
    def num_docs(self) -> int:
        return len(self._docs)

    def doc(self, i: int):
        d = self._docs[i]
        return d.decode("utf-8") if self._was_str[i] else d

    def locate(self, global_pos: int) -> tuple[int, int]:
        """(doc_id, offset_in_doc) for a global byte offset.

        The reference README's "binary search on your list of documents"
        (README.md:71-74), vectorized below in :meth:`positions`.
        """
        doc_id = int(np.searchsorted(self._starts, global_pos, side="right")) - 1
        return doc_id, int(global_pos - self._starts[doc_id])

    def positions(self, query) -> list[tuple[int, int]]:
        """All (doc_id, offset) pairs where ``query`` occurs within a doc."""
        return self.positions_batch([query])[0]

    def positions_batch(self, queries: Sequence) -> list[list[tuple[int, int]]]:
        raw_qs = [_as_bytes(q)[0] for q in queries]
        for q in raw_qs:
            if self.SEPARATOR in q:
                raise ValueError("queries must not contain the NUL separator byte")
        out: list[list[tuple[int, int]]] = []
        for hits, q in zip(self._st.positions_batch(queries), raw_qs):
            pairs = []
            if hits.size:
                doc_ids = np.searchsorted(self._starts, hits.astype(np.int64), side="right") - 1
                offsets = hits.astype(np.int64) - self._starts[doc_ids]
                # A NUL-free query can only cross a boundary if it would
                # contain the separator — impossible — so every hit that
                # starts inside a doc lies fully inside it.
                inside = hits.astype(np.int64) + len(q) <= self._ends[doc_ids]
                pairs = [
                    (int(d), int(o))
                    for d, o, ok in zip(doc_ids, offsets, inside)
                    if ok
                ]
            out.append(pairs)
        return out

    def contains(self, query) -> bool:
        return len(self.positions(query)) > 0

    def docs_containing(self, query) -> list[int]:
        """Sorted unique document ids containing ``query``."""
        return sorted({d for d, _ in self.positions(query)})
