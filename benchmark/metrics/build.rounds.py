"""build.rounds: mean quadrupling rounds a job, both phases, from the
program's counter ``rounds``."""

from benchmark.program_spans import mean_counter


def read(rec: dict):
    return mean_counter(rec, ("rounds",))
