"""sharded.gather_s: mean seconds a job on rank 0 of gathering the whole
table from every rank and copying it to the host, from the program's
span ``sharded.gather``."""

from benchmark.sharded_spans import mean_span_s


def read(rec: dict):
    return mean_span_s(rec, ("sharded.gather",))
