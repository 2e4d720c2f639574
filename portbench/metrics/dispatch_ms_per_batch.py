"""dispatch_ms_per_batch: host ms a call in which the port enqueues its
device work: the union of its torch glue spans (``dstt.glue.*``: probes,
selection) and kernel wrappers (``dstt.kernel.*``) over the traced
window. Reads ``dispatch_ms_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    prog = load_module("metrics", "_program")
    return prog.ms_per_batch(
        rec, lambda n: n.startswith("dstt.glue.") or n.startswith("dstt.kernel."))
