"""One run of one cell: set-up, warm-up, the closed-loop window, the check.

The driver named by the cell's configuration builds the cell (its data
from the seed, the program's objects), warms the cell's own shapes, and
serves call i of the window; the runner times each call on the host clock
(each call ends in a synchronise), traces the window when asked, reads the
metrics through their readers, frees the program's state and has the
driver compare what the window produced with the plain reference.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
import traceback

import torch

from portbench.harness import spec as spec_mod
from portbench.harness.trace import CALL, WINDOW, Trace, profiled, span

# A traced run's window is at most this long: its per-layer metrics are
# shares and per-batch means, and a host-bound cell's profile of a whole
# 50 s window holds millions of events.
TRACE_CAP_S = 10.0


class Record:
    """What a run measured; metric readers read it.

    Attributes:
        unit: what a call serves (``"queries"`` or ``"docs"``).
        config, traffic: the cell's configuration and traffic objects.
        units, failed: units attempted in the window, and in calls that raised.
        call_units: the units of each call that returned.
        window_s: host seconds from the first call's start to the last's end.
        call_s: each call's host seconds.
        setup_s: process start to the first timed call.
        peak_bytes: ``torch.cuda.max_memory_allocated`` over the run so far.
        trace: the traced window (:class:`Trace`) or None.
        device: the run's device.
    """

    def __init__(self, unit: str, device, config: dict = None, traffic: dict = None):
        self.unit = unit
        self.device = device
        self.config = config or {}
        self.traffic = traffic or {}
        self.units = 0
        self.failed = 0
        self.window_s = 0.0
        self.call_s = []
        self.call_units = []
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.trace = None

    @property
    def calls(self) -> int:
        return len(self.call_s)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def run_cell(spec, cell_name: str, seed: int, seconds: float, trace: bool, device,
             setup_clock, scale: dict = None, log=None) -> dict:
    """Run ``cell_name`` once; returns the result object (the contract's
    last line, with ``checks`` last).

    ``setup_clock()`` gives the seconds since the process started;
    ``scale`` overrides configuration and traffic keys (CPU tests). A
    traced window lasts ``min(seconds, TRACE_CAP_S)``."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = spec.cell(cell_name)
    config = dict(spec.config(cell["config"]))
    traffic = dict(spec.traffic(cell["traffic"]))
    for key, value in (scale or {}).items():
        (config if key in config else traffic)[key] = value
    driver = spec_mod.load_module("drivers", config["driver"])
    work = driver.Workload(config, traffic, seed, device, log)
    work.setup()
    work.warm()
    sync(device)
    rec = Record(work.unit, device, config, traffic)
    rec.setup_s = setup_clock()
    log("[portbench] %s seed %d: set-up %.3f s" % (cell_name, seed, rec.setup_s))

    if trace:
        seconds = min(seconds, TRACE_CAP_S)
    error = None
    mark = span if trace else (lambda name: contextlib.nullcontext())
    with profiled(trace) as prof:
        with mark(WINDOW):
            cpu0 = time.process_time()
            t_start = time.perf_counter()
            i = 0
            while True:
                n = work.units_of(i)
                rec.units += n
                t0 = time.perf_counter()
                try:
                    with mark(CALL):
                        out = work.call(i)
                        sync(device)
                except Exception:  # a failed call ends the window and the run's correctness
                    rec.failed += n
                    error = traceback.format_exc()
                    break
                t1 = time.perf_counter()
                rec.call_s.append(t1 - t0)
                rec.call_units.append(n)
                work.keep(i, out)
                i += 1
                if t1 - t_start >= seconds:
                    break
            rec.window_s = time.perf_counter() - t_start
    rec.peak_bytes = peak_bytes(device)
    cpu_s = time.process_time() - cpu0
    if rec.calls:
        ms = sorted(1e3 * s for s in rec.call_s)
        log("[portbench] window %.3f s, %d calls, ms a call p50 %.3f p95 %.3f max %.3f; "
            "process CPU %.3f s" % (rec.window_s, rec.calls, ms[len(ms) // 2],
                                    ms[int(0.95 * (len(ms) - 1))], ms[-1], cpu_s))
    if error:
        log("[portbench] call %d raised:\n%s" % (i, error))
    if prof is not None:
        t0 = time.perf_counter()
        rec.trace = Trace.from_profiler(prof)
        del prof
        log("[portbench] trace read in %.1f s: %d device and %d host events" % (
            time.perf_counter() - t0, len(rec.trace.device), len(rec.trace.host)))

    metrics = {}
    for entry in spec.metrics(cell_name, trace):
        value = spec_mod.metric_reader(entry["name"]).read(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    work.free()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = work.check() if rec.calls else {}
    log("[portbench] reference check in %.1f s" % (time.perf_counter() - t0))
    correct = bool(checks) and error is None and rec.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": correct,
        "attempted": rec.units,
        "failed": rec.failed,
        "metrics": metrics,
        "device": device_info(rec),
    }
    if rec.trace is not None:
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = checks
    return result


def device_info(rec: Record) -> dict:
    dev = torch.device(rec.device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = rec.peak_bytes
    if rec.trace is not None:
        info["busy_s"] = rec.trace.busy_s
        info["window_s"] = rec.trace.window_s
    return info
