"""The sharded build's own spans and counters of a window's jobs, for the
per-layer readers that name them.

Each ``build_table`` call of the sharded build is a ``sharded_build`` root
of the program's recorder (``suffix_torch.utils.profiling``) on every
rank; the readers take rank 0's, kept in the harness's own process, where
the runner runs rank 0. The window's jobs are the last
``rec["attempted"]`` roots, in order; the jobs completed before the close
are the first ``rec["counters"]["jobs"]`` of those. A program without
these roots, or a run with fewer roots than jobs attempted, gives nothing
to read.
"""

from __future__ import annotations

ROOT = "sharded_build"


def window_roots(rec: dict) -> list[dict] | None:
    """Rank 0's ``sharded_build`` roots of the window's completed jobs,
    or None."""
    try:
        from suffix_torch.utils.profiling import finished
    except ImportError:
        return None
    attempted = int(rec.get("attempted") or 0)
    jobs = int((rec.get("counters") or {}).get("jobs") or 0)
    if not attempted or not jobs:
        return None
    roots = finished(ROOT)
    if len(roots) < attempted:
        return None
    return roots[len(roots) - attempted:][:jobs]


def mean_span_s(rec: dict, names) -> float | None:
    """Mean seconds a job inside the spans ``names``, or None where no
    job has any of them."""
    roots = window_roots(rec)
    if not roots or not any(n in r["span_s"] for r in roots for n in names):
        return None
    return sum(r["span_s"].get(n, 0.0) for r in roots
               for n in names) / len(roots)


def mean_counter(rec: dict, name: str) -> float | None:
    """Mean a job of the counter ``name``, or None where no job has it."""
    roots = window_roots(rec)
    if not roots or not any(name in r["counters"] for r in roots):
        return None
    return sum(r["counters"].get(name, 0) for r in roots) / len(roots)
