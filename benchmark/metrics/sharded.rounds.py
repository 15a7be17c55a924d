"""sharded.rounds: mean doubling rounds a job (each a global sort and a
re-rank), from the program's counter ``rounds`` on rank 0."""

from benchmark.sharded_spans import mean_counter


def read(rec: dict):
    return mean_counter(rec, "rounds")
