"""The traced window: ``torch.profiler`` over the measured loop, reduced to
device intervals by name and kind, host ops, and what readers need.

Device time is the union of the CUDA kernel, copy and memset intervals
inside the window (``tools/profile_torch.py::device_time``'s rule); the
window is the span the runner records around its loop. GPU user
annotations (the device mirror of a ``record_function``) are not device
work and are left out.
"""

from __future__ import annotations

import contextlib
import glob
import heapq
import os
import re

from portbench.harness.spec import ROOT

WINDOW = "portbench.window"
CALL = "portbench.call"


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` with CPU and CUDA activity over the block, or
    nothing; yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def span(name: str):
    """A host span in the trace (a no-op when nothing profiles)."""
    from torch.profiler import record_function

    return record_function(name)


def kind_of(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for start, end in sorted(spans):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def gaps(spans, lo: float, hi: float) -> list:
    """(start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for start, end in sorted(spans):
        if start > cur:
            out.append((cur, min(start, hi)))
        cur = max(cur, end)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def port_kernel_names() -> list:
    """Names of the port's hand-written kernels (``__global__`` functions
    of ``datasketch_tpu_torch/csrc/*.cu``)."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, "datasketch_tpu_torch", "csrc", "*.cu")):
        with open(path) as fh:
            names.update(_GLOBAL.findall(fh.read()))
    return sorted(names)


def matches(event_name: str, kernel_names) -> bool:
    return any(re.search(r"(?<!\w)%s(?!\w)" % re.escape(k), event_name)
               for k in kernel_names)


class Trace:
    """One traced window.

    Attributes:
        start, end: the window in the trace's clock (us).
        device: [(name, kind, start, end)] device intervals clipped to it.
        host: [(name, start, end)] host ops that overlap it.
    """

    def __init__(self, start: float, end: float, device: list, host: list):
        self.start, self.end = start, end
        self.device = device
        self.host = host

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        window, device, host = None, [], []
        for e in prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CPU:
                if e.name == WINDOW:
                    window = (s, t)
                host.append((e.name, s, t))
            elif not getattr(e, "is_user_annotation", False) and not e.name.startswith(
                    "portbench."):
                device.append((e.name, kind_of(e.name), s, t))
        if window is None:
            raise RuntimeError("the profiler recorded no %s span" % WINDOW)
        lo, hi = window
        device = [(n, k, max(s, lo), min(t, hi)) for n, k, s, t in device if t > lo and s < hi]
        host = [(n, s, t) for n, s, t in host if t > lo and s < hi and n != WINDOW]
        return cls(lo, hi, device, host)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us([(s, t) for _, _, s, t in self.device]) / 1e6

    def device_s(self, pred) -> float:
        """Device seconds of the intervals whose (name, kind) ``pred`` takes
        (summed, not unioned)."""
        return sum(t - s for n, k, s, t in self.device if pred(n, k)) / 1e6

    def count(self, pred) -> int:
        return sum(1 for n, k, _, _ in self.device if pred(n, k))

    def by_name(self) -> list:
        """[(name, device seconds)], largest first."""
        tot = {}
        for n, _, s, t in self.device:
            tot[n] = tot.get(n, 0.0) + (t - s) / 1e6
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def idle_by_host_op(self) -> list:
        """[(host op, idle seconds)], largest first: each idle stretch of
        the device goes to the innermost host op running at its midpoint
        (the runner's spans when no op of the program is)."""
        idle = gaps([(s, t) for _, _, s, t in self.device], self.start, self.end)
        events = sorted(self.host, key=lambda e: e[1])
        heap, i, tot = [], 0, {}
        for s, t in sorted(idle, key=lambda g: g[0] + g[1]):
            mid = (s + t) / 2
            while i < len(events) and events[i][1] <= mid:
                name, es, ee = events[i]
                heapq.heappush(heap, (-es, ee, name))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            label = heap[0][2] if heap else "(no host op)"
            tot[label] = tot.get(label, 0.0) + (t - s) / 1e6
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def breakdown(self, n: int = 10) -> dict:
        return {
            "device_ops": [[name[:160], sec] for name, sec in self.by_name()[:n]],
            "idle_gaps": [[name[:160], sec] for name, sec in self.idle_by_host_op()[:n]],
        }
