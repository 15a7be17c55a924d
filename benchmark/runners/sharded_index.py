"""The sharded indexing runner: index jobs back to back over the mix's
``ranks`` cards, one process a rank (``benchmark/ranks.py``).

This process is rank 0 on the first card; it starts ranks 1 .. ranks - 1
with ``torch.multiprocessing`` (``spawn``), and all join one group. Set-up
makes the mix's ``texts`` texts of the configuration from the seed on
every rank's own card, compares their digests across the ranks, and runs
one warm-up job. The window then runs jobs until it closes, cycling over
the texts: rank 0 broadcasts the text's index and every rank calls
``build_index(text, BuildConfig(sharded=True, n_devices=ranks))``, host
bytes in and rank 0's host table out. The job that runs past the close
finishes, is judged, and is not counted in the rate; the others' seconds
are the record's ``build.job`` spans, as in ``runners/index.py``. The
device's peak is the largest of the ranks' window peaks.

A rank that dies, a job that raises, or a step that makes no progress
for ``STALL_S`` seconds ends the run at once with exit code 1, the other
ranks killed: a group that has lost a rank can only hang.

``correct``: after the window, with the group gone and the card's cache
emptied, the first output of each text by the suffix-array certificate;
every later output of a text must equal the judged one, or is judged
itself. ``text_mismatch``: the texts whose digest on some rank differs
from rank 0's.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

from benchmark import ranks, reference
from benchmark.harness import Window

STALL_S = 300.0


class Guard:
    """Watches the child ranks and the run's progress from a thread of
    its own; ``abort`` kills the children and leaves."""

    def __init__(self, procs):
        self.procs = procs
        self.mark = time.monotonic()
        self.watching = True
        threading.Thread(target=self._loop, daemon=True).start()

    def beat(self) -> None:
        self.mark = time.monotonic()

    def _loop(self) -> None:
        while self.watching:
            for r, p in enumerate(self.procs.processes, 1):
                if p.exitcode not in (None, 0):
                    self.abort(f"rank {r} exited with code {p.exitcode}")
            if time.monotonic() - self.mark > STALL_S:
                self.abort(f"no progress in {STALL_S:.0f} s")
            time.sleep(0.2)

    def abort(self, why: str) -> None:
        print(f"sharded run stopped: {why}", file=sys.stderr, flush=True)
        for p in self.procs.processes:
            if p.is_alive():
                p.kill()
        os._exit(1)


def run(ctx) -> dict:
    import torch
    import torch.multiprocessing as mp
    from torch.profiler import record_function

    from suffix_torch.parallel.mesh import destroy_group

    world = int(ctx.traffic["ranks"])
    n_texts = int(ctx.traffic["texts"])
    n = int(ctx.config["n_bytes"])
    device = ranks.device_of(ctx.device.type, 0)
    split = {"start": time.monotonic() - ctx.t_process}
    tmp = tempfile.mkdtemp(prefix="bench_ranks_")
    store = os.path.join(tmp, "store")
    t = time.monotonic()
    procs = mp.start_processes(
        ranks.worker, nprocs=world - 1, join=False, start_method="spawn",
        args=(world, device.type, store, str(ctx.cell.root), ctx.config,
              ctx.seed, n_texts, os.getpid()))
    guard = Guard(procs)
    try:
        ranks.share_threads(world)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        t_texts = time.monotonic()
        texts = ranks.make_texts(str(ctx.cell.root), ctx.config, ctx.seed,
                                 n_texts, device)
        split["texts"] = time.monotonic() - t_texts
        ranks.join(device.type, 0, world, store)
        split["ranks_start"] = time.monotonic() - t
        guard.beat()
        seen = ranks.digests(texts, device)
        mismatch = sum(any(d[i] != seen[0][i] for d in seen[1:])
                       for i in range(n_texts))

        def job(i: int):
            ranks.broadcast(i, device)
            t0, w0 = time.monotonic(), time.time_ns()
            with record_function("bench.sharded_job"):
                st = ranks.job(texts[i], world, device)
            guard.beat()
            return st.table(), (t0, time.monotonic(), w0, time.time_ns())

        t = time.monotonic()
        job(0)  # warm-up
        gc.collect()
        split["warmup_job"] = time.monotonic() - t
        win = Window(ctx)
        ranks.broadcast(ranks.OPEN, device)
        peak_setup = ranks.open_window(device)
        win.open()
        win.peak_setup = max(win.peak_setup, peak_setup)
        deadline = win.start + ctx.seconds
        jobs = []
        while time.monotonic() < deadline:
            i = len(jobs) % n_texts
            sa, tm = job(i)
            jobs.append((i, sa, tm))
        win.close()
        ranks.broadcast(ranks.CLOSE, device)
        peak_window = ranks.close_window(device)
        ranks.broadcast(ranks.STOP, device)
        # Every rank leaves the group together (NCCL's teardown waits for
        # all of them) before this one waits for the children to exit.
        destroy_group()
        while not procs.join():
            pass
        guard.watching = False
    except BaseException:
        traceback.print_exc()
        guard.abort("rank 0 raised")
    shutil.rmtree(tmp, ignore_errors=True)

    done = [j for j in jobs if j[2][1] <= deadline]
    rec = win.record(text_bytes=n)
    rec["peak_window_bytes"] = max(rec["peak_window_bytes"], peak_window)
    rec.update(
        counters={"jobs": len(done),
                  "jobs_bytes": n * len(done),
                  "last_job_end_s": (done[-1][2][1] - win.start
                                     if done else None)},
        spans={"build.job": [j[2][1] - j[2][0] for j in done]},
        attempted=len(jobs), failed=0, setup_split_s=split)
    if win.capture is not None:
        spans = [("sharded.job", j[2][2], j[2][3]) for j in jobs]
        rec["trace"] = win.summarize(spans)
        rec["trace"]["jobs"] = len(spans)

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    sa_bad = 0
    judged: dict = {}
    for i, sa, _ in jobs:
        ref = judged.get(i)
        if ref is not None and np.array_equal(ref, sa):
            continue
        t = reference.as_text(texts[i], device)
        bad = reference.sa_defects(t, sa)
        sa_bad += bad
        if ref is None and bad == 0:
            judged[i] = sa
        del t
    rec["checks"] = {"sa_defects": [sa_bad, 0],
                     "text_mismatch": [mismatch, 0]}
    rec["reference_s"] = time.monotonic() - t_ref
    return rec
