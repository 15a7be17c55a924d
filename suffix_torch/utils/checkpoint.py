"""Index checkpoint / resume in the JAX package's ``.npz`` format
(``suffix_tpu/utils/checkpoint.py``, format_version 1): ``text``,
``table``, ``was_str`` and, when given, the ``lcp`` array (uint32), the
multi-document offsets ``doc_starts`` (int64) and ``build_stats`` as its
JSON text. An index saved by either package loads in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np

from suffix_torch.table import SuffixTable

FORMAT_VERSION = 1


def save_index(path: str, st, *, lcp: np.ndarray | None = None,
               doc_starts: np.ndarray | None = None,
               build_stats: dict | None = None) -> None:
    payload = {
        "format_version": np.int64(FORMAT_VERSION),
        "text": np.frombuffer(st.text_bytes(), dtype=np.uint8),
        "table": st.table(),
        "was_str": np.bool_(isinstance(st.text(), str)),
    }
    if lcp is not None:
        payload["lcp"] = np.asarray(lcp, dtype=np.uint32)
    if doc_starts is not None:
        payload["doc_starts"] = np.asarray(doc_starts, dtype=np.int64)
    if build_stats is not None:
        text = json.dumps(build_stats, sort_keys=True, default=str)
        payload["build_stats"] = np.frombuffer(text.encode("utf-8"),
                                               dtype=np.uint8)
    # Atomic: never leave a half-written index (np.savez appends .npz to
    # bare names, so the temp name keeps the suffix).
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def load_index(path: str, device=None) -> SuffixTable:
    """The saved index as a ``SuffixTable`` on ``device`` (``None`` =
    CUDA)."""
    with np.load(path) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"index format {version} is newer than supported "
                             f"({FORMAT_VERSION})")
        text = z["text"].tobytes()
        table = z["table"]
        was_str = bool(z["was_str"])
        stats = (z["build_stats"].tobytes().decode("utf-8")
                 if "build_stats" in z else None)
    st = SuffixTable(text, table, _was_str=was_str, device=device)
    if stats is not None:
        st.build_stats = json.loads(stats)
    return st
