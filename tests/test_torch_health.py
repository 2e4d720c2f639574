"""Health probes of the port: bounded subprocess and thread probes, failure
accounting, and the default device's report on a host without a card.
Probes of a device use ``device="cpu"`` here; each subprocess probe that
runs the real child imports torch, so there are few of them."""

import time

import pytest
import torch

import datasketch_tpu_torch.utils.health as health
from datasketch_tpu_torch.utils import HealthMonitor, device_healthcheck


def test_cpu_probes_in_and_out_of_process():
    res = device_healthcheck(timeout=30.0, device="cpu", isolate=False)
    assert res["ok"] and res["latency_s"] is not None and res["error"] is None, res
    res = device_healthcheck(timeout=120.0, device="cpu", isolate=True)
    assert res["ok"] and res["latency_s"] is not None and res["error"] is None, res


def test_default_device_without_a_card_reports_not_ok():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for isolate in (False, True):
        res = device_healthcheck(timeout=120.0, isolate=isolate)
        assert not res["ok"] and res["latency_s"] is None, res
        assert "no CUDA device" in res["error"], res
    res = device_healthcheck(timeout=30.0, device="cuda:3", isolate=False)
    assert not res["ok"] and "no CUDA device" in res["error"]
    assert not torch.cuda.is_initialized()


def test_subprocess_timeout_bound(monkeypatch):
    """A wedged probe child is killed at the bound: the path that works
    even when the hung dispatch holds the GIL."""
    monkeypatch.setattr(health, "_PROBE_SRC", "import time; time.sleep(60)")
    t0 = time.perf_counter()
    res = device_healthcheck(timeout=1.0, device="cpu", isolate=True)
    assert time.perf_counter() - t0 < 10
    assert not res["ok"] and "exceeded" in res["error"]


def test_subprocess_timeout_with_pipe_holding_grandchild(monkeypatch):
    """Killing the probe's process group does not wait on pipe EOF: a
    helper process that inherits the child's stdout would hold it open."""
    grandchild_src = (
        "import subprocess, sys, time\n"
        "subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'])\n"
        "time.sleep(60)\n"
    )
    monkeypatch.setattr(health, "_PROBE_SRC", grandchild_src)
    t0 = time.perf_counter()
    res = device_healthcheck(timeout=1.0, device="cpu", isolate=True)
    assert time.perf_counter() - t0 < 10
    assert not res["ok"] and "exceeded" in res["error"]


def test_subprocess_crash_reported(monkeypatch):
    monkeypatch.setattr(health, "_PROBE_SRC",
                        "import sys; sys.stderr.write('boom'); sys.exit(3)")
    res = device_healthcheck(timeout=30.0, device="cpu", isolate=True)
    assert not res["ok"] and "rc=3" in res["error"] and "boom" in res["error"]


def test_child_gets_the_device_as_its_argument(monkeypatch):
    monkeypatch.setattr(health, "_PROBE_SRC", (
        "import json, sys\n"
        "print(json.dumps({'ok': True, 'latency_s': 0.0, 'error': sys.argv[1]}))\n"))
    assert device_healthcheck(device="cpu")["error"] == "cpu"
    assert device_healthcheck(device=torch.device("cuda", 2))["error"] == "cuda:2"
    if not torch.cuda.is_initialized():
        assert device_healthcheck()["error"] == "cuda"


def test_thread_timeout_bound(monkeypatch):
    real_thread = health.threading.Thread

    class HangingThread(real_thread):
        def run(self):
            time.sleep(60)

    monkeypatch.setattr(health.threading, "Thread", HangingThread)
    t0 = time.perf_counter()
    res = device_healthcheck(timeout=0.2, device="cpu", isolate=False)
    assert time.perf_counter() - t0 < 5
    assert not res["ok"] and "exceeded" in res["error"]


def test_monitor_failure_accounting(monkeypatch):
    outcomes = iter([False, False, False, True])
    calls = []

    def fake_check(timeout, device=None, isolate=True):
        calls.append((timeout, device, isolate))
        ok = next(outcomes)
        return {"ok": ok, "latency_s": 0.01 if ok else None,
                "error": None if ok else "boom"}

    monkeypatch.setattr(health, "device_healthcheck", fake_check)
    mon = HealthMonitor(max_failures=3, device="cpu", isolate=False)
    mon.check()
    mon.check()
    assert not mon.unhealthy and mon.consecutive_failures == 2
    mon.check()
    assert mon.unhealthy
    mon.check()
    assert not mon.unhealthy and mon.consecutive_failures == 0
    st = mon.status()
    assert st["checks"] == 4 and st["median_latency_s"] == 0.01
    assert st["last"]["ok"] and calls[0] == (None, "cpu", False)
