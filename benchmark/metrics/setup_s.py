"""setup_s: seconds from the start of the process to the opening of the
window: CUDA start, inputs, the build, the index, warm-up, load start."""


def read(rec: dict):
    return rec["setup_s"]
