"""passes_per_batch: containment scan passes a call (the program's
``ensemble.passes`` counter: the first pass and each rerun at a larger k)
over the traced window. Reads ``passes_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    passes = load_module("metrics", "_program").counter(rec, "ensemble.passes")
    if passes is None or not rec.calls:
        return None
    return passes / rec.calls
