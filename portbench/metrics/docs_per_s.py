"""docs_per_s: documents sketched over the window's host seconds (all of
its calls)."""


def read(rec):
    if rec.unit != "docs" or not rec.calls:
        return None
    return (rec.units - rec.failed) / rec.window_s
