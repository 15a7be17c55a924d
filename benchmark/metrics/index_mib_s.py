"""index_mib_s: MiB of text of the jobs completed in the window, over the
seconds from the window's start to the end of the last of them."""


def read(rec: dict):
    c = rec.get("counters", {})
    if not c.get("jobs"):
        return None
    return c["jobs_bytes"] / 2**20 / c["last_job_end_s"]
