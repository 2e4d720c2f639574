"""h2d_ms_per_batch: device ms of host-to-device copies over the traced
window's calls. Reads ``h2d_ms_per_batch.<part>``."""


def read(rec):
    if rec.trace is None or not rec.calls:
        return None
    return 1e3 * rec.trace.device_s(lambda name, kind: kind == "h2d") / rec.calls
