"""build.job_s: mean seconds of ``SuffixTable.new`` over the jobs
completed in the window."""


def read(rec: dict):
    spans = rec.get("spans", {}).get("build.job")
    if not spans:
        return None
    return sum(spans) / len(spans)
