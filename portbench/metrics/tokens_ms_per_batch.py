"""tokens_ms_per_batch: host ms a call in the port's token walk into a
pinned buffer, its hasher's call left out (the ``dstt.front.tokens`` span
less its ``dstt.front.sha1`` child) over the traced window. Reads
``tokens_ms_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    prog = load_module("metrics", "_program")
    return prog.ms_per_batch(rec, prog.named("dstt.front.tokens"),
                             minus=prog.named("dstt.front.sha1"))
