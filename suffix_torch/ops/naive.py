"""Naive-oracle suffix-array construction (host numpy), copied from
``suffix_tpu/ops/naive.py``: a trivially-correct sort of suffixes that
every engine of the port is diffed against in the tests.
"""

from __future__ import annotations

import numpy as np


def naive_table(data: bytes | np.ndarray) -> np.ndarray:
    """Byte-lexicographically sorted suffix start offsets (uint32).

    O(n^2) memory for the materialized suffixes: small inputs only.
    """
    b = bytes(data) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8).tobytes()
    n = len(b)
    if n > 0xFFFFFFFF:
        raise ValueError("text is too large (max 2^32 - 1 bytes)")
    order = sorted(range(n), key=lambda i: b[i:])
    return np.asarray(order, dtype=np.uint32)
