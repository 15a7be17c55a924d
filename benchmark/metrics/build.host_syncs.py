"""build.host_syncs: mean host reads of device values a job, from the
program's counter ``host_syncs`` (one a ``build.readback``)."""

from benchmark.program_spans import mean_counter


def read(rec: dict):
    return mean_counter(rec, ("host_syncs",))
