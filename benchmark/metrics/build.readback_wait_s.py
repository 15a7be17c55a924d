"""build.readback_wait_s: mean seconds a job that the host waits on
reads of device values inside the rounds, from the program's spans
``build.readback``."""

from benchmark.program_spans import mean_span_s


def read(rec: dict):
    return mean_span_s(rec, ("build.readback",))
