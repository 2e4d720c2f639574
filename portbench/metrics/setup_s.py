"""setup_s: from the process's start to the first timed call (imports,
CUDA start, kernel builds or loads, data, index, warm-up)."""


def read(rec):
    return rec.setup_s
