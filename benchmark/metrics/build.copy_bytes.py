"""build.copy_bytes: mean bytes a job of the build's pageable copies,
from the program's counters: the staged input to the card
(``h2d_bytes``) and the suffix array back (``d2h_bytes``)."""

from benchmark.program_spans import mean_counter


def read(rec: dict):
    return mean_counter(rec, ("h2d_bytes", "d2h_bytes"))
