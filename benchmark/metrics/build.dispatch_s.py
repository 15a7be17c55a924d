"""build.dispatch_s: mean seconds a job from the dispatch of the
doubling rounds to the card finishing them, from the program's span
``build.dispatch`` (its readbacks included)."""

from benchmark.program_spans import mean_span_s


def read(rec: dict):
    return mean_span_s(rec, ("build.dispatch",))
