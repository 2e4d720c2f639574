"""rescanned_per_batch: queries a call that the containment scan scans a
second time because their match count passed the answer cap (the
program's ``ensemble.rescanned`` counter, 0 in a call with none) over the
traced window. Reads ``rescanned_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    n = load_module("metrics", "_program").counter(rec, "ensemble.rescanned")
    if n is None or not rec.calls:
        return None
    return n / rec.calls
