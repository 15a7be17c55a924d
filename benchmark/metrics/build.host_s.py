"""build.host_s: mean seconds a job of the build's host steps, from the
program's spans: the period probe (``build.probe``), the adaptive plan
(``build.plan``), staging the codes or the padded text (``build.pack``),
and the slice, cast and table construction (``build.finish``)."""

from benchmark.program_spans import mean_span_s


def read(rec: dict):
    return mean_span_s(rec, ("build.probe", "build.plan", "build.pack",
                             "build.finish"))
