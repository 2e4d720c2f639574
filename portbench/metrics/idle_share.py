"""idle_share: percent of the traced window in which no kernel, copy or
memset ran on the device. Reads ``idle_share.<part>``, the same quantity
split by the end-to-end metric that each cell reports."""


def read(rec):
    if rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
