"""A kernel's share of its roofline, from the counts in
``portbench/roofline/<kernel>.py`` and the fixed peaks in
``portbench/roofline/peaks.json`` (published and architectural numbers of
the H100 SXM; none is read off the card).

A roofline module defines ``KERNELS`` (the ``__global__`` names whose
device time is the kernel's) and ``counts(config, traffic, units)``: from
the cell's configuration and traffic objects and the units one call
served, the work that call gives the kernel, whatever implements it, or
None where the cell's traffic gives the kernel no work it counts. The work
is 32-bit integer operations by
the pipes that can issue them (``alu``: the INT32 pipe only; ``imad``: the
FMA-heavy pipe's integer multiplier only; ``either``: one or the other),
``f32`` operations and ``bytes`` (each input read once, each output
written once). The least time is the largest of bytes over the memory
bandwidth, each pipe's operations over its lanes, all integer operations
over the SM's issue lanes, and f32 operations over the f32 peak.
"""

from __future__ import annotations

import os

from portbench.harness.spec import BENCH_DIR, load_module, read_json


def peaks() -> dict:
    return read_json(os.path.join(BENCH_DIR, "roofline", "peaks.json"))


def bound_s(counts: dict, pk: dict) -> float:
    """Least seconds for ``counts`` on the card of ``pk``."""
    per_lane = pk["sms"] * pk["sm_clock_hz"]
    alu, imad, either = (counts.get(k, 0) for k in ("alu", "imad", "either"))
    return max(
        counts.get("bytes", 0) / pk["hbm_bytes_per_s"],
        alu / (pk["alu_lanes_per_sm"] * per_lane),
        imad / (pk["imad_lanes_per_sm"] * per_lane),
        (alu + imad + either) / (pk["issue_lanes_per_sm"] * per_lane),
        counts.get("f32", 0) / pk["f32_flops_per_s"],
    )


def share(rec, kernel: str):
    """Percent of ``kernel``'s roofline over a traced window: the least
    time of all its calls' work over its device time; None when the
    window gave it no work it counts or no device time."""
    if rec.trace is None or not rec.call_units:
        return None
    mod = load_module("roofline", kernel)
    work = [mod.counts(rec.config, rec.traffic, n) for n in rec.call_units]
    if any(c is None for c in work):
        return None
    pk = peaks()
    least = sum(bound_s(c, pk) for c in work)
    from portbench.harness.trace import matches

    spent = rec.trace.device_s(lambda name, kind: kind == "kernel" and matches(name, mod.KERNELS))
    if spent <= 0:
        return None
    return 100.0 * least / spent
