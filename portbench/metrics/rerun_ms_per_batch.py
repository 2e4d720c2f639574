"""rerun_ms_per_batch: host ms a call in a containment scan's passes after
its first, each with its fetch (the ``dstt.facade.rerun`` span), over the
traced window. Reads ``rerun_ms_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    prog = load_module("metrics", "_program")
    return prog.ms_per_batch(rec, prog.named("dstt.facade.rerun"))
