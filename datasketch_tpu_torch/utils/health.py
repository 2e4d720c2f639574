"""Device failure detection for serving deployments.

Port of ``datasketch_tpu/utils/health.py``, probing ``torch.cuda``. A
device-resident index has a failure mode the reference library never had:
a wedged card makes a dispatch HANG rather than raise, so a serving
process silently stops answering. :func:`device_healthcheck` turns that
hang into a bounded, reportable diagnosis, and :class:`HealthMonitor`
tracks consecutive failures for load-balancer-style eviction decisions.

A probe sums ``torch.tensor([1.0, 2.0, 3.0])`` on the device it is given
and checks 6.0, the JAX package's probe op (``device=None``: the current
CUDA device). It never moves to the CPU on its own: on a machine with no
card it reports ``ok: False`` with the reason. Pass ``device="cpu"`` to
probe the CPU.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import torch

__all__ = ["device_healthcheck", "HealthMonitor"]

# Child probe: imports torch only, takes the device as its one argument,
# measures only the device op (imports excluded), prints one JSON line and
# os._exit's so no teardown of the CUDA runtime can hang it.
_PROBE_SRC = """
import json, os, sys, time
import torch
dev = torch.device(sys.argv[1])
out = {"ok": False, "latency_s": None, "error": None}
if dev.type == "cuda" and not torch.cuda.is_available():
    out["error"] = "no CUDA device: torch.cuda.is_available() is false"
elif dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
    out["error"] = "no CUDA device %s (device_count %d)" % (
        dev, torch.cuda.device_count())
else:
    try:
        t0 = time.perf_counter()
        v = torch.tensor([1.0, 2.0, 3.0], device=dev).sum().item()
        out["ok"] = v == 6.0
        out["latency_s"] = time.perf_counter() - t0
        if v != 6.0:
            out["error"] = "wrong result: %r" % v
    except Exception as exc:
        out["error"] = repr(exc)
print(json.dumps(out), flush=True)
os._exit(0)
"""


def _probe_device(device) -> str:
    """The device a probe targets, as a string for the child's argument.
    ``None`` is the current CUDA device: read from the runtime only if this
    process has already initialized CUDA (a probe must not start it here),
    else ``"cuda"``, which is the child's current device."""
    if device is not None:
        return str(torch.device(device))
    if torch.cuda.is_initialized():
        return f"cuda:{torch.cuda.current_device()}"
    return "cuda"


def device_healthcheck(timeout: Optional[float] = None, device=None,
                       isolate: bool = True) -> dict:
    """Probe a device with a trivial dependent op, bounded by `timeout`.

    Default timeout: 120s for ``isolate=True`` (the bound covers the
    child's WHOLE lifetime: interpreter, ``import torch`` and CUDA context
    creation take a few seconds on a healthy card), 10s for the
    in-process thread probe.

    ``isolate=True`` (default) probes in a SUBPROCESS: a wedged device can
    block inside a C call while holding the GIL, in which case no
    in-process thread or signal can fire; killing a child process group is
    the only reliable bound. Each probe costs an interpreter, a torch
    import and a CUDA context (a few hundred MB on the card until the
    child exits); the reported latency covers only the device op.

    ``isolate=False`` probes in a daemon thread: near-zero overhead for
    high-frequency monitoring of a device that is currently healthy, but
    it only bounds hangs that happen with the GIL released.

    Returns ``{"ok": bool, "latency_s": float | None, "error": str | None}``.
    """
    if timeout is None:
        timeout = 120.0 if isolate else 10.0
    target = _probe_device(device)
    if isolate:
        result = {"ok": False, "latency_s": None, "error": None}
        # Child stdout/stderr go to TEMP FILES, not pipes, and the child
        # gets its own process group: a helper process that inherits the
        # pipes would make a pipe drain (subprocess.run's behavior) block
        # on the still-open write end after a timeout-kill of the direct
        # child. killpg + files cannot.
        with tempfile.TemporaryFile() as out_f, \
                tempfile.TemporaryFile() as err_f:
            try:
                proc = subprocess.Popen(
                    [sys.executable, "-c", _PROBE_SRC, target],
                    stdout=out_f,
                    stderr=err_f,
                    start_new_session=True,
                )
            except OSError as exc:
                result["error"] = repr(exc)
                return result
            try:
                rc = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    proc.kill()
                proc.wait()
                result["error"] = (
                    f"device probe exceeded {timeout}s (hung dispatch)"
                )
                return result
            out_f.seek(0)
            stdout = out_f.read().decode("utf-8", "replace").strip()
            err_f.seek(0)
            stderr = err_f.read().decode("utf-8", "replace").strip()
        line = stdout.splitlines()[-1] if stdout else ""
        try:
            result.update(json.loads(line))
        except ValueError:
            result["error"] = "probe exited rc=%d: %s" % (rc, stderr[-300:])
        return result
    # The probe thread writes its OWN dict; the returned dict is built
    # after the wait. A late-finishing thread must not mutate the
    # already-returned timeout verdict into a self-contradictory one.
    probe_result: dict = {"ok": False, "latency_s": None, "error": None}
    done = threading.Event()

    def _probe() -> None:
        try:
            dev = torch.device(target)
            if dev.type == "cuda" and not torch.cuda.is_available():
                probe_result["error"] = (
                    "no CUDA device: torch.cuda.is_available() is false"
                )
                return
            if dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
                probe_result["error"] = "no CUDA device %s (device_count %d)" % (
                    dev, torch.cuda.device_count())
                return
            t0 = time.perf_counter()
            value = torch.tensor([1.0, 2.0, 3.0], device=dev).sum().item()
            if value != 6.0:
                probe_result["error"] = f"wrong result: {value}"
            else:
                probe_result["ok"] = True
                probe_result["latency_s"] = time.perf_counter() - t0
        except Exception as exc:  # noqa: BLE001 - report, don't crash
            probe_result["error"] = repr(exc)
        finally:
            done.set()

    thread = threading.Thread(target=_probe, daemon=True)
    thread.start()
    if not done.wait(timeout):
        return {
            "ok": False,
            "latency_s": None,
            "error": f"device probe exceeded {timeout}s (hung dispatch)",
        }
    return dict(probe_result)


class HealthMonitor:
    """Consecutive-failure tracker around :func:`device_healthcheck`.

    >>> mon = HealthMonitor(max_failures=3)
    >>> if not mon.check()["ok"] and mon.unhealthy:
    ...     evict_replica()
    """

    def __init__(self, timeout: Optional[float] = None, max_failures: int = 3,
                 device=None, isolate: bool = True) -> None:
        # None -> device_healthcheck's mode-appropriate default (120s for
        # subprocess probes)
        self.timeout = timeout
        self.max_failures = max_failures
        self.device = device
        self.isolate = isolate
        self.consecutive_failures = 0
        self.last_result: Optional[dict] = None
        self.history: list = []  # (timestamp, ok, latency_s)

    def check(self) -> dict:
        result = device_healthcheck(self.timeout, self.device,
                                    isolate=self.isolate)
        self.last_result = result
        self.history.append((time.time(), result["ok"], result["latency_s"]))
        if len(self.history) > 256:
            del self.history[:-256]
        if result["ok"]:
            self.consecutive_failures = 0
        else:
            self.consecutive_failures += 1
        return result

    @property
    def unhealthy(self) -> bool:
        return self.consecutive_failures >= self.max_failures

    def status(self) -> dict:
        ok_lat = [l for _, ok, l in self.history if ok and l is not None]
        return {
            "checks": len(self.history),
            "consecutive_failures": self.consecutive_failures,
            "unhealthy": self.unhealthy,
            "median_latency_s": (
                sorted(ok_lat)[len(ok_lat) // 2] if ok_lat else None
            ),
            "last": self.last_result,
        }
