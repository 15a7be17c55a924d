"""Per-pass profiling and metrics, ported from
``suffix_tpu/utils/profiling.py``.

Every construction or query phase can be timed with device
synchronization (``torch.cuda.synchronize`` on a CUDA tensor; CPU work is
synchronous), and ``device_trace`` wraps a region in ``torch.profiler``
and writes a Chrome trace. The build and LCP code marks its passes with
``torch.profiler.record_function`` scopes, which show in that trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class PassMetrics:
    name: str
    seconds: float
    bytes_processed: int = 0

    @property
    def mb_per_s(self) -> float:
        return self.bytes_processed / max(self.seconds, 1e-12) / 1e6


def _sync(tree) -> None:
    """Wait for every CUDA tensor in ``tree`` (a tensor, or a list,
    tuple or dict of them); CPU tensors are already done."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _sync(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _sync(v)


@dataclass
class Profile:
    """Accumulates named pass timings; printable as a structured report."""

    passes: list[PassMetrics] = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str, bytes_processed: int = 0, sync=None):
        """Time a region; ``sync`` is a tensor (or a list, tuple or dict
        of them) to wait for before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _sync(sync)
        self.passes.append(
            PassMetrics(name, time.perf_counter() - t0, bytes_processed)
        )

    def record(self, name: str, seconds: float, bytes_processed: int = 0):
        self.passes.append(PassMetrics(name, seconds, bytes_processed))

    def total_seconds(self) -> float:
        return sum(p.seconds for p in self.passes)

    def report(self) -> str:
        lines = [f"{'pass':<28} {'seconds':>10} {'MB/s':>10}"]
        for p in self.passes:
            rate = f"{p.mb_per_s:10.1f}" if p.bytes_processed else " " * 10
            lines.append(f"{p.name:<28} {p.seconds:>10.4f} {rate}")
        lines.append(f"{'TOTAL':<28} {self.total_seconds():>10.4f}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(
            [
                {"pass": p.name, "seconds": p.seconds, "bytes": p.bytes_processed}
                for p in self.passes
            ]
        )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Wrap a region in ``torch.profiler`` (CPU, plus CUDA when present)
    and write its Chrome trace to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed_build(data: bytes, device=None):
    """Build an index on ``device`` (``None`` = CUDA) with per-phase
    metrics; returns (SuffixTable, Profile)."""
    from suffix_torch.device import sync
    from suffix_torch.table import SuffixTable

    prof = Profile()
    with prof.span("suffix_array.build", bytes_processed=len(data)):
        st = SuffixTable.new(data, device=device)
    with prof.span("device_upload"):
        st._ensure_device()
        sync(st.device)
    return st, prof
