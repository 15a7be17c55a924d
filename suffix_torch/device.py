"""Device selection for the PyTorch port.

Counterpart of ``suffix_tpu/utils/platform.py``. Every public entry point
takes ``device=None``, which means CUDA. There is no silent fallback: a
caller that wants the CPU says ``device="cpu"``, and a request for CUDA on
a machine without it raises. Eager PyTorch has no jit, so there is no
compilation cache to set up.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` means ``cuda``; a missing CUDA device raises ``RuntimeError``
    instead of dropping to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "suffix_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def sync(device: torch.device) -> None:
    """Wait for all queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
