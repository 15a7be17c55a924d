"""Structured per-build metrics: the stats surface a deployment scrapes.

Port of ``suffix_tpu/utils/metrics.py``, same schema: every dict carries
REQUIRED_KEYS; engine-specific extras (rounds, tie_trajectory, period,
recursion_depth, ...) appear when the engine that ran produces them.

    sa, stats = build_stats(data, device="cpu")
    SuffixTable.new(text, collect_stats=True).build_stats

``device`` is the torch device the build runs on (``None`` = CUDA) and
names the card in ``stats["device"]``; a sharded build runs on its
mesh's device.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from suffix_torch.device import resolve_device

SCHEMA_VERSION = 1

REQUIRED_KEYS = (
    "schema", "engine", "engine_family", "n_bytes", "n_pad",
    "index_dtype", "elapsed_s", "bytes_per_s", "device",
)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def stats_header(n: int, index_dtype: str, dev: torch.device) -> dict:
    """The keys every stats dict opens with; the build fills the rest."""
    return {"schema": SCHEMA_VERSION, "n_bytes": n,
            "index_dtype": index_dtype, "device": _device_name(dev)}


def build_stats(data, engine: str = "device", index_dtype: str = "u32",
                padding: str = "pow2", device=None, mesh=None):
    """(suffix array, stats dict) for one instrumented build on ``device``.

    ``engine``: "device" (prefix doubling with its routes: periodic,
    patched, adaptive, two-phase, classic), "native" (C++ SA-IS on the
    host), "sais" (the recursive SA-IS pipeline on the device), "auto"
    (``SuffixTable.new``'s choice; these four run ``table.build_array``,
    the build ``SuffixTable.new`` runs) or "sharded" (block-bitonic SPMD
    over ``mesh``, whose ranks all call this; ``None`` = this process
    alone, a one-rank mesh on ``device``).
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    arr = (np.frombuffer(bytes(data), np.uint8)
           if isinstance(data, (bytes, bytearray))
           else np.asarray(data, np.uint8))
    n = int(arr.size)
    stats = stats_header(n, index_dtype, dev)
    if engine != "sharded":
        from suffix_torch.table import build_array

        sa = build_array(arr, engine, padding, index_dtype, dev, stats)
        return np.asarray(sa), stats
    from suffix_torch.parallel import launch

    sa, dt, d = (_timed_sharded(mesh, arr, index_dtype) if mesh is not None
                 else launch.run(_timed_sharded, 1, arr, index_dtype,
                                 device=dev))
    logd = max(1, d).bit_length() - 1
    stats.update(
        engine=f"sharded(d={d})", engine_family="sharded", n_pad=n,
        devices=d,
        collective={
            # The analytic per-round volume: bitonic merge-split
            # stages and halo window shifts, bytes a rank.
            "bitonic_stages_per_round": logd * (logd + 1) // 2,
            "bytes_per_device_per_stage": 3 * 8 * (n // max(d, 1)),
        },
        elapsed_s=round(dt, 6), bytes_per_s=round(n / max(dt, 1e-12), 1))
    return np.asarray(sa), stats


def _timed_sharded(mesh, arr: np.ndarray, index_dtype: str):
    """(table, seconds, ranks) of one sharded build on ``mesh``."""
    from suffix_torch.parallel.dist_build import suffix_array_sharded

    t0 = time.perf_counter()
    sa = suffix_array_sharded(arr, mesh, index_dtype=index_dtype)
    return sa, time.perf_counter() - t0, mesh.world_size


def stats_json(stats: dict) -> str:
    """One deterministic JSON line (stable key order for log scraping)."""
    return json.dumps(stats, sort_keys=True, default=str)
