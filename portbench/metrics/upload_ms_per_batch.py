"""upload_ms_per_batch: host ms a call in the port's upload of a query
batch to the device (the ``dstt.upload.queries`` span) over the traced
window. Reads ``upload_ms_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    prog = load_module("metrics", "_program")
    return prog.ms_per_batch(rec, prog.named("dstt.upload.queries"))
