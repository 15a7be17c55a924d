"""sharded.host_s: mean seconds a job of the sharded build's host steps
on rank 0, from the program's spans: the adaptive plan and its probe
(``sharded.plan``), staging this rank's block on its card
(``sharded.stage``), and the slice and cast of the table
(``sharded.finish``)."""

from benchmark.sharded_spans import mean_span_s


def read(rec: dict):
    return mean_span_s(rec, ("sharded.plan", "sharded.stage",
                             "sharded.finish"))
