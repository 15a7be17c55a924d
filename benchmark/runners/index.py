"""The indexing runner: index jobs back to back.

Set-up makes the mix's ``texts`` texts of the configuration from the seed
and runs one warm-up job. The window then runs jobs until it closes,
cycling over the texts: a job is ``SuffixTable.new(text)``, host bytes in
and host table out. Each job is a benchmark span (``build.job``), also
marked for the profiler. The job that runs past the close finishes, is
judged, and is not counted in the rate.

``correct``: the first output of each text by the suffix-array
certificate; every later output of a text must equal the judged one, or
is judged itself.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from benchmark import reference
from benchmark.harness import Window


def run(ctx) -> dict:
    import torch
    from torch.profiler import record_function
    from suffix_torch.table import SuffixTable

    n = int(ctx.config["n_bytes"])
    split = {"start": time.monotonic() - ctx.t_process}
    t = time.monotonic()
    texts = [ctx.corpus.make(ctx.config, ctx.seed, i, ctx.device)
             for i in range(int(ctx.traffic["texts"]))]
    split["texts"] = time.monotonic() - t

    def job(text):
        t0, w0 = time.monotonic(), time.time_ns()
        with record_function("bench.build_job"):
            st = SuffixTable.new(text, device=ctx.device)
        return st.table(), (t0, time.monotonic(), w0, time.time_ns())

    t = time.monotonic()
    job(texts[0])  # warm-up
    gc.collect()
    split["warmup_job"] = time.monotonic() - t
    win = Window(ctx)
    win.open()
    deadline = win.start + ctx.seconds
    jobs, failed = [], 0
    while time.monotonic() < deadline:
        k = len(jobs)
        try:
            sa, tm = job(texts[k % len(texts)])
        except Exception as e:  # judged below: a job that raised failed
            failed += 1
            jobs.append((k % len(texts), None, None))
            print(f"job {k} raised {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            continue
        jobs.append((k % len(texts), sa, tm))
    win.close()
    done = [j for j in jobs if j[2] is not None and j[2][1] <= deadline]
    rec = win.record(text_bytes=n)
    rec.update(
        counters={"jobs": len(done),
                  "jobs_bytes": n * len(done),
                  "last_job_end_s": (done[-1][2][1] - win.start
                                     if done else None)},
        spans={"build.job": [j[2][1] - j[2][0] for j in done]},
        attempted=len(jobs), failed=failed, setup_split_s=split)
    if win.capture is not None:
        spans = [("build.job", j[2][2], j[2][3]) for j in jobs
                 if j[2] is not None]
        rec["trace"] = win.summarize(spans)
        rec["trace"]["jobs"] = len(spans)

    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    sa_bad = 0
    judged: dict = {}
    for i, sa, _ in jobs:
        if sa is None:
            sa_bad += n
            continue
        ref = judged.get(i)
        if ref is not None and np.array_equal(ref, sa):
            continue
        t = reference.as_text(texts[i], ctx.device)
        bad = reference.sa_defects(t, sa)
        sa_bad += bad
        if ref is None and bad == 0:
            judged[i] = sa
        del t
    rec["checks"] = {"sa_defects": [sa_bad, 0]}
    rec["reference_s"] = time.monotonic() - t_ref
    return rec
