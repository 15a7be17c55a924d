"""Device trace of a window: ``torch.profiler`` around it, reduced to the
few numbers the per-layer readers and the result's ``breakdown`` take.

``summarize`` is pure: it reads a Chrome trace (the profiler's export)
and the benchmark's own host spans, so the readers can be tested on fixed
data. Times in the export are microseconds after ``baseTimeNanoseconds``
(absolute microseconds in older exports); host spans are wall-clock
nanoseconds, ``time.time_ns()``.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
LABELLED = 2000  # longest idle gaps named one by one


class Capture:
    """``with Capture() as cap:`` profiles CPU and CUDA activity;
    ``cap.export()`` afterwards gives the Chrome trace as a dict."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def export(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)
        finally:
            os.unlink(path)


def _merge(iv: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(chrome: dict, t0_ns: int, t1_ns: int,
              host_spans: list[tuple[str, int, int]] = ()) -> dict:
    """The window [t0_ns, t1_ns] of a Chrome trace: its length, the
    seconds some device operation ran (``busy_s``), the device
    milliseconds launched under each ``record_function`` scope
    (``scopes_ms``) and under each profiled op, such as ``aten::sort``
    (``ops_ms``), the device operations that took most time and the
    longest idle gaps, each gap named by the host span and the innermost
    profiled scope or op running at its middle."""
    base = chrome.get("baseTimeNanoseconds")

    def ns(ts) -> float:
        return (base + float(ts) * 1e3) if base is not None else float(ts) * 1e3

    dev, launches, annots, ops = [], {}, [], []
    for e in chrome.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        s = ns(e["ts"])
        d = float(e.get("dur", 0)) * 1e3
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            dev.append((s, s + d, e.get("name", "?"), args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), s)
        elif cat == "user_annotation":
            annots.append((s, s + d, e.get("name", "?"), e.get("tid")))
        elif cat == "cpu_op":
            ops.append((s, s + d, e.get("name", "?"), e.get("tid")))
    clipped = [(max(s, t0_ns), min(e, t1_ns), name, c)
               for s, e, name, c in dev if e > t0_ns and s < t1_ns]
    busy = _merge([(s, e) for s, e, _, _ in clipped])
    busy_ns = sum(e - s for s, e in busy)

    by_name: dict = defaultdict(float)
    for s, e, name, _ in clipped:
        by_name[name[:200]] += (e - s) / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    # Kernels under each scope: launched from the scope's thread inside it.
    launch_by_tid: dict = defaultdict(list)
    for corr, (tid, s) in launches.items():
        launch_by_tid[tid].append((s, corr))
    for v in launch_by_tid.values():
        v.sort()
    dev_ms = defaultdict(float)
    for s, e, _, c in clipped:
        dev_ms[c] += (e - s) / 1e6

    def launched_ms(events) -> dict:
        """Device ms of the kernels launched inside each event, by the
        event's name; a kernel under nested events of one name once."""
        corr: dict = defaultdict(set)
        for s, e, name, tid in events:
            v = launch_by_tid.get(tid, [])
            i = bisect.bisect_left(v, (s, -float("inf")))
            while i < len(v) and v[i][0] <= e:
                corr[name].add(v[i][1])
                i += 1
        return {name: sum(dev_ms.get(c, 0.0) for c in cs)
                for name, cs in corr.items()}

    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = sorted((s, e, n) for n, s, e in host_spans)
    prof = sorted((s, e, n) for s, e, n, _ in annots + ops)
    named: dict = defaultdict(float)
    for g0, g1 in gaps[:LABELLED]:
        t = (g0 + g1) / 2
        label = _covering(spans, t) or "outside benchmark spans"
        inner = _covering(prof, t)
        named[label + (" > " + inner if inner else "")] += (g1 - g0) / 1e9
    if len(gaps) > LABELLED:
        named["shorter gaps"] += sum(g1 - g0 for g0, g1 in gaps[LABELLED:]) / 1e9
    idle_gaps = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (t1_ns - t0_ns) / 1e9, "busy_s": busy_ns / 1e9,
            "scopes_ms": launched_ms(annots), "ops_ms": launched_ms(ops),
            "device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in idle_gaps]}


def _covering(iv: list, t: float, reach: int = 4096) -> str | None:
    """Name of the latest-starting interval of ``iv`` (sorted by start)
    that covers ``t``: the innermost of nested scopes."""
    i = bisect.bisect_right(iv, (t, float("inf"), ""))
    for j in range(i - 1, max(-1, i - 1 - reach), -1):
        if iv[j][1] >= t:
            return iv[j][2]
    return None
