"""build.copy_s: mean seconds a job of the build's pageable copies, from
the program's spans: the staged input to the card (``build.upload``) and
the suffix array back (``build.download``)."""

from benchmark.program_spans import mean_span_s


def read(rec: dict):
    return mean_span_s(rec, ("build.upload", "build.download"))
