"""decode_ms_per_batch: host ms a call in the port's decode of a batch's
results into keys and scores (the ``dstt.facade.decode`` span) over the
traced window. Reads ``decode_ms_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    prog = load_module("metrics", "_program")
    return prog.ms_per_batch(rec, prog.named("dstt.facade.decode"))
