"""sharded.exchange_bytes: mean bytes a job that rank 0 sends to the
other ranks, point to point and in all-gathers, from the program's
counter ``exchange_bytes``."""

from benchmark.sharded_spans import mean_counter


def read(rec: dict):
    return mean_counter(rec, "exchange_bytes")
