"""Padding policy, copied from ``suffix_tpu/ops/padding.py``.

Texts are padded with ``PAD = -1``, strictly below every real byte
(0..255), so a suffix that runs off the end of the text compares below
any suffix that still has real bytes: "shorter prefix sorts first".
Eager PyTorch does not compile per shape, but the port pads to the same
sizes so that every routing decision (fence stride, key width, chunking)
matches the JAX package bit for bit.
"""

from __future__ import annotations

PAD = -1  # sorts strictly below every real byte value


def bucket_size(n: int, minimum: int = 16) -> int:
    """Round ``n`` up to the next power of two (>= minimum)."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


def bucket_size_fine(n: int, minimum: int = 16) -> int:
    """Next multiple of a power-of-two step with at most 12.5% padding."""
    if n <= minimum:
        return minimum
    # step = 2^(bit_length-3) -> between 1/8 and 1/4 of n
    step = 1 << max(0, n.bit_length() - 3)
    return ((n + step - 1) // step) * step
