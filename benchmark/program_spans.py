"""The program's own spans and counters of a window's jobs, for the
per-layer readers that name them.

Each ``SuffixTable.new`` is a ``build`` root of the program's recorder
(``suffix_torch.utils.profiling``), kept in the process after the run.
The window's jobs are the last ``rec["attempted"]`` roots, in order; the
jobs completed before the close are the first ``rec["counters"]["jobs"]``
of those. A program without the recorder, or a run with fewer roots than
jobs attempted, gives nothing to read.
"""

from __future__ import annotations


def window_roots(rec: dict) -> list[dict] | None:
    """The ``build`` roots of the window's completed jobs, or None."""
    try:
        from suffix_torch.utils.profiling import finished
    except ImportError:
        return None
    attempted = int(rec.get("attempted") or 0)
    jobs = int((rec.get("counters") or {}).get("jobs") or 0)
    if not attempted or not jobs:
        return None
    roots = finished("build")
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


def mean_counter(rec: dict, names) -> float | None:
    """Mean a job of the counters ``names``, added, or None where no job
    has any of them."""
    roots = window_roots(rec)
    if not roots or not any(n in r["counters"] for r in roots for n in names):
        return None
    return sum(r["counters"].get(n, 0) for r in roots
               for n in names) / len(roots)
