"""device_idle_pct.index: the share of the traced window in which no
operation ran on the card, in percent."""


def read(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
