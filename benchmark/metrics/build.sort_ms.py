"""build.sort_ms: device milliseconds a job of the kernels that the
build's sorts launch, from the traced window: each ``torch.sort`` (the
profiled op ``aten::sort``), those of the ``ops/sort.py`` lexsort and the
two of ``ops/prefix_doubling.py``. The gathers and scatters around them
are not counted."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr.get("jobs"):
        return None
    ms = tr.get("ops_ms", {}).get("aten::sort", 0.0)
    if ms <= 0:
        return None
    return ms / tr["jobs"]
