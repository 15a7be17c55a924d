"""sharded.rounds_s: mean seconds a job on rank 0 from the first
doubling round to the host's read of the last round's ``done``, from the
program's span ``sharded.rounds`` (the exchanges inside it included)."""

from benchmark.sharded_spans import mean_span_s


def read(rec: dict):
    return mean_span_s(rec, ("sharded.rounds",))
