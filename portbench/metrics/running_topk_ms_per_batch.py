"""running_topk_ms_per_batch: host ms a call in the tiled running top-k
over kernel 4 of a scan past k = 128 (the ``dstt.glue.running_topk``
span), over the traced window. Reads ``running_topk_ms_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    prog = load_module("metrics", "_program")
    return prog.ms_per_batch(rec, prog.named("dstt.glue.running_topk"))
