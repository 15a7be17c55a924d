"""An exact oracle for the doubling engine's trajectory
(``suffix_torch/ops/prefix_doubling.py``), from the LCP array of the text.

The padding slots take distinct keys, so the engine's ties are the
text's own: two suffixes tie at depth ``h`` iff their LCP is ``>= h``;
the tie mass at depth ``h`` counts the sorted positions whose LCP with
either neighbour is ``>= h``; after ``r`` rounds the depth is
``h0 * 4**r``. The engine stops when no tie is left.
"""

from __future__ import annotations

import numpy as np

from suffix_torch.ops import prefix_doubling as pd
from suffix_torch.ops.padding import bucket_size

TRAJECTORY_KEYS = ("rounds", "h_final", "tie_trajectory", "h_phase1",
                   "tie_mass_at_switch", "phase2_rounds", "m_pad")


def lcp_array(text: bytes, sa) -> np.ndarray:
    """Kasai: ``lcp[j]`` is the LCP of suffixes ``sa[j-1]`` and ``sa[j]``,
    ``lcp[0] = 0``."""
    n = len(text)
    sa = [int(x) for x in sa]
    rank = [0] * n
    for j, i in enumerate(sa):
        rank[i] = j
    lcp = [0] * n
    h = 0
    for i in range(n):
        if rank[i] == 0:
            h = 0
            continue
        p = sa[rank[i] - 1]
        while i + h < n and p + h < n and text[i + h] == text[p + h]:
            h += 1
        lcp[rank[i]] = h
        h = max(h - 1, 0)
    return np.asarray(lcp, dtype=np.int64)


def tie_mass(lcp: np.ndarray, h: int) -> int:
    """Sorted positions in tie groups of size >= 2 at depth ``h``."""
    if lcp.size == 0:
        return 0
    tied = lcp >= h
    return int(np.count_nonzero(tied | np.append(tied[1:], False)))


def trajectory(text: bytes, sa, stats: dict) -> dict:
    """The trajectory keys that a device build of ``text`` fills, for the
    engine family, ``h0`` and ``n_pad`` in ``stats``."""
    lcp = lcp_array(text, sa)
    n_pad = stats["n_pad"]
    k = stats["h0"]
    mass = tie_mass(lcp, k)
    if stats["engine_family"] == "classic":
        traj, rounds = [mass], 0
        while mass and k < 2 * n_pad:
            k *= 4
            rounds += 1
            mass = tie_mass(lcp, k)
            traj.append(mass)
        return {"rounds": rounds, "h_final": k,
                "tie_trajectory": traj[:pd.TRAJ_SLOTS]}
    assert stats["engine_family"] == "two_phase", stats["engine_family"]
    while mass and k < 2 * n_pad and mass > n_pad // pd.TIE_CAP_FRAC:
        k *= 4
        mass = tie_mass(lcp, k)
    out = {"h_phase1": k, "tie_mass_at_switch": mass, "phase2_rounds": 0}
    if not mass:
        return out
    m_pad = min(bucket_size(mass, minimum=256), n_pad)
    rounds = 0
    while True:
        k *= 4
        rounds += 1
        if not tie_mass(lcp, k) or k >= 2 * n_pad:
            break
    return {**out, "phase2_rounds": rounds, "m_pad": m_pad, "h_final": k}


def total_rounds(traj: dict, h0: int) -> int:
    """Quadrupling rounds of both phases: the recorder's ``rounds``."""
    if "h_phase1" not in traj:
        return traj["rounds"]
    phase1 = 0
    while h0 * 4 ** phase1 < traj["h_phase1"]:
        phase1 += 1
    return phase1 + traj["phase2_rounds"]
