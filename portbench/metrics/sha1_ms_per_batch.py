"""sha1_ms_per_batch: host ms a call in the port's native token hasher
(the ``dstt.front.sha1`` span) over the traced window. Reads
``sha1_ms_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    prog = load_module("metrics", "_program")
    return prog.ms_per_batch(rec, prog.named("dstt.front.sha1"))
