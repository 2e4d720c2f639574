"""qps: queries answered over the window's host seconds (all of its calls).
Reads ``qps.<part>``, the rate split by cells that hold it to their own
bounds."""


def read(rec):
    if rec.unit != "queries" or not rec.calls:
        return None
    return (rec.units - rec.failed) / rec.window_s
