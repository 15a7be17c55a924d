"""The plain reference that decides ``correct``: PyTorch and NumPy only,
nothing of the program.

It takes the text that the benchmark made, and judges the program's
suffix array by the linear-time certificate: a permutation whose
neighbours are ordered by their first byte, then by the rank of the
suffix one byte on. Every function runs on the device of the text tensor
it is given.

The control (``control_sa``) is a reference suffix array with one
guarantee broken: it reads only the first 16 bytes of a suffix, the
shortcut of a sort that stops at a fixed key width.
"""

from __future__ import annotations

import numpy as np
import torch

CONTROL_WIDTH = 16


def as_text(text: bytes, device) -> torch.Tensor:
    return torch.frombuffer(bytearray(text), dtype=torch.uint8).to(device)


def _long(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def sa_defects(t: torch.Tensor, sa) -> int:
    """How far ``sa`` is from the suffix array of ``t``: entries out of
    range or repeated, plus neighbouring pairs in the wrong order."""
    n = t.numel()
    sa = _long(sa, t.device)
    if sa.numel() != n:
        return abs(sa.numel() - n) + n
    bad = int(((sa < 0) | (sa >= n)).sum())
    if bad:
        return bad
    seen = torch.zeros(n, dtype=torch.bool, device=t.device)
    seen[sa] = True
    bad = n - int(seen.sum())
    if bad:
        return bad
    rank = torch.empty(n + 1, dtype=torch.int64, device=t.device)
    rank[sa] = torch.arange(n, device=t.device)
    rank[n] = -1  # the empty suffix sorts first
    a, b = sa[:-1], sa[1:]
    ca, cb = t[a].to(torch.int16), t[b].to(torch.int16)
    ok = (ca < cb) | ((ca == cb) & (rank[a + 1] < rank[b + 1]))
    return int((~ok).sum())


def control_sa(t: torch.Tensor, width: int = CONTROL_WIDTH) -> np.ndarray:
    """The control's suffix array: suffixes sorted by their first
    ``width`` bytes only (bytes past the end read 0), ties by position."""
    n = t.numel()
    pad = torch.cat([t, torch.zeros(width, dtype=torch.uint8,
                                    device=t.device)]).to(torch.int64)
    order = torch.arange(n, device=t.device)
    for lo in reversed(range(0, width, 7)):  # 7 bytes a key, LSD
        key = torch.zeros(n, dtype=torch.int64, device=t.device)
        for j in range(lo, min(lo + 7, width)):
            key = key * 256 + pad[j:j + n]
        key = key[order]
        order = order[torch.sort(key, stable=True).indices]
    return order.cpu().numpy()
