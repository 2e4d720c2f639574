"""fetch_used_share: percent of the id slots copied back that hold an
answer (the port's ``facade.answers`` over its ``facade.fetched_slots``
counter) over the traced window. Reads ``fetch_used_share.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    prog = load_module("metrics", "_program")
    slots = prog.counter(rec, "facade.fetched_slots")
    if not slots:
        return None
    return 100.0 * (prog.counter(rec, "facade.answers") or 0) / slots
