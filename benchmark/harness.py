"""Runs one cell once: its runner, then its metric readers, into the
result line of ``run.py``.

A runner (``runners/<name>.py``) gets a ``Context`` and returns a record:
plain numbers, spans and counters of its window, the trace summary of a
traced run, and the checks that decide ``correct``, each
``[value, limit]``. A reader (``metrics/<name>.py``) turns the record into
one metric, or into ``None`` when it finds nothing to read.
"""

from __future__ import annotations

import time

from benchmark import trace as trace_mod
from benchmark.spec import Cell


# Record fields the result line carries for the reader of a run.
DIAGNOSTICS = ("setup_split_s", "reference_s", "counters")


class Context:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_process: float, config=None):
        self.cell = cell
        self.config = {**cell.config, **(config or {})}
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_process = t_process
        self.corpus = cell.corpus()


class Window:
    """The measured window: set-up ends where it opens; the device's peak
    is reset there and read where it closes; a traced run profiles it."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.capture = None
        self.cuda = ctx.device.type == "cuda"
        self.peak_setup = self._peak()

    def _peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated()) if self.cuda else 0

    def open(self) -> None:
        import torch

        if self.ctx.trace:
            self.capture = trace_mod.Capture().__enter__()
        if self.cuda:
            torch.cuda.synchronize()
            self.peak_setup = max(self.peak_setup, self._peak())
            torch.cuda.reset_peak_memory_stats()
        self.start = time.monotonic()
        self.wall_start = time.time_ns()

    def close(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.wall_end = time.time_ns()
        self.peak_window = self._peak()
        if self.capture is not None:
            self.capture.__exit__(None, None, None)

    def record(self, text_bytes: int) -> dict:
        return {"setup_s": self.start - self.ctx.t_process,
                "window_s": self.ctx.seconds,
                "text_bytes": int(text_bytes),
                "peak_setup_bytes": self.peak_setup,
                "peak_window_bytes": self.peak_window,
                "trace": None}

    def summarize(self, spans) -> dict:
        return trace_mod.summarize(self.capture.export(), self.wall_start,
                                   self.wall_end, spans)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, config=None) -> dict:
    """One run of ``cell``: the result object of ``run.py``'s last line,
    its checks under ``checks``."""
    import torch

    device = torch.device(device)
    ctx = Context(cell, seed, seconds, trace, device, t_process, config)
    rec = cell.runner().run(ctx)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(rec["peak_setup_bytes"],
                                    rec["peak_window_bytes"])}
    out = {"correct": all(v <= lim for v, lim in rec["checks"].values())
           and rec["failed"] == 0,
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["diagnostics"] = {k: rec[k] for k in DIAGNOSTICS if k in rec}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in rec["checks"].items()}
    return out
