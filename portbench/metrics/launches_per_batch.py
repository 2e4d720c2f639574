"""launches_per_batch: CUDA kernels that ran in the traced window over its
calls (copies and memsets not counted). Reads ``launches_per_batch.<part>``."""


def read(rec):
    if rec.trace is None or not rec.calls:
        return None
    return rec.trace.count(lambda name, kind: kind == "kernel") / rec.calls
