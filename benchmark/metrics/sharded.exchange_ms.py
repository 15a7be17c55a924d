"""sharded.exchange_ms: device milliseconds a job of the kernels launched
inside the program's ``sharded.exchange`` scopes on rank 0's card (the
point-to-point transfers and all-gathers between the ranks, each
kernel's time waiting for its peer included), from the traced window."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr.get("jobs"):
        return None
    ms = tr.get("scopes_ms", {}).get("sharded.exchange", 0.0)
    if ms <= 0:
        return None
    return ms / tr["jobs"]
