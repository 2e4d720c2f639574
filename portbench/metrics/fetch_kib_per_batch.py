"""fetch_kib_per_batch: KiB of result tensors the port copies back from
the device a call (its ``upload.fetch_bytes`` counter) over the traced
window. Reads ``fetch_kib_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    fetched = load_module("metrics", "_program").counter(rec, "upload.fetch_bytes")
    if fetched is None or not rec.calls:
        return None
    return fetched / 1024 / rec.calls
