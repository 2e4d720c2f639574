"""Shared reading of the program's own spans and counters (not a metric).

The port marks its steps with ``torch.profiler.record_function`` spans
named ``dstt.<layer>.<step>`` and counts bytes and slots in
``datasketch_tpu_torch.utils.profiling.counters()``, both only while a
profiler records: in a run, the traced window. A checkout whose port has
neither gives None here, and the metric is left out of the line.
"""

from portbench.harness.trace import union_us


def _spans(rec, pred) -> list:
    """(start, end) of the host spans whose name ``pred`` takes, clipped
    to the traced window."""
    lo, hi = rec.trace.start, rec.trace.end
    return [(max(s, lo), min(t, hi)) for n, s, t in rec.trace.host
            if pred(n) and t > lo and s < hi]


def ms_per_batch(rec, pred, minus=None):
    """Milliseconds a call of the union of the spans ``pred`` takes (spans
    nested in spans of the same kind count once), less the part that
    spans ``minus`` takes cover; None without a trace or such a span."""
    if rec.trace is None or not rec.calls:
        return None
    spans = _spans(rec, pred)
    if not spans:
        return None
    us = union_us(spans)
    if minus is not None:
        inner = _spans(rec, minus)
        us = union_us(spans + inner) - union_us(inner)
    return 1e-3 * us / rec.calls


def named(name: str):
    return lambda n: n == name


def counter(rec, name: str):
    """The program's counter ``name`` over the traced window, or None."""
    if rec.trace is None:
        return None
    try:
        from datasketch_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters().get(name)
