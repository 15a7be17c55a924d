"""Structured per-build metrics: the stats surface a deployment scrapes.

Port of ``suffix_tpu/utils/metrics.py``, same schema: every dict carries
REQUIRED_KEYS; engine-specific extras (rounds, tie_trajectory, period,
recursion_depth, ...) appear when the engine that ran produces them.

    sa, stats = build_stats(data, device="cpu")
    SuffixTable.new(text, collect_stats=True).build_stats

``device`` is the torch device the build runs on (``None`` = CUDA) and
names the card in ``stats["device"]``. The JAX package's ``"sharded"``
engine is not ported (ROADMAP.md Queue 1 item 15).
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


def build_stats(data, engine: str = "device", index_dtype: str = "u32",
                padding: str = "pow2", device=None):
    """(suffix array, stats dict) for one instrumented build on ``device``.

    ``engine``: "device" (prefix doubling with its routes: periodic,
    patched, adaptive, two-phase, classic), "native" (C++ SA-IS on the
    host) or "sais" (the recursive SA-IS pipeline on the device).
    """
    from suffix_torch.ops.padding import bucket_size

    if engine == "sharded":
        raise ValueError("engine='sharded' is not ported to suffix_torch; "
                         "see ROADMAP.md Queue 1 item 15")
    if engine not in ("device", "native", "sais"):
        raise ValueError(f"unknown engine: {engine!r}")
    dev = resolve_device(device)
    arr = (np.frombuffer(bytes(data), np.uint8)
           if isinstance(data, (bytes, bytearray))
           else np.asarray(data, np.uint8))
    n = int(arr.size)
    stats: dict = {"schema": SCHEMA_VERSION, "n_bytes": n,
                   "index_dtype": index_dtype, "device": _device_name(dev)}
    if engine == "device":
        from suffix_torch.ops import prefix_doubling

        # The route label, n_pad, the engine's internals and the timing
        # of the dispatch alone, as the JAX package reports them.
        sa = prefix_doubling.suffix_array_bytes(
            arr, padding=padding, index_dtype=index_dtype, device=dev,
            stats=stats)
        return sa, stats
    if engine == "native":
        from suffix_torch import native

        t0 = time.perf_counter()
        sa = native.sais(arr)
        dt = time.perf_counter() - t0
        stats.update(engine="native-sais", engine_family="native", n_pad=n)
    else:
        from suffix_torch.ops.sais import suffix_array_sais_recursive

        s: dict = {}
        t0 = time.perf_counter()
        sa = suffix_array_sais_recursive(arr, stats=s, device=dev)
        dt = time.perf_counter() - t0
        stats.update(engine="sais-device", engine_family="sais",
                     n_pad=bucket_size(max(n, 1)),
                     recursion_depth=s.get("depth", 0))
    stats.update(elapsed_s=round(dt, 6),
                 bytes_per_s=round(n / max(dt, 1e-12), 1))
    return np.asarray(sa), stats


def stats_json(stats: dict) -> str:
    """One deterministic JSON line (stable key order for log scraping)."""
    return json.dumps(stats, sort_keys=True, default=str)
