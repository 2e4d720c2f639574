"""Tracing and timing utilities for the CUDA port.

Port of ``datasketch_tpu/utils/profiling.py``: :func:`trace` records a
``torch.profiler`` trace (host and, with a card, CUDA activity) as a
Chrome trace in a directory, :func:`time_op` takes the best wall time of a
call with its result's devices synced, ``device_sync`` waits for the card,
and :func:`cuda_time_ms` times a callable with CUDA events (host clocks
around asynchronous launches measure only the enqueue).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

__all__ = ["trace", "time_op", "device_sync", "cuda_time_ms"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block into ``log_dir``
    (a ``*.pt.trace.json`` Chrome trace, viewable in Perfetto or
    TensorBoard); yields the profiler.

    >>> with trace("traces/serving"):
    ...     index.query_batch(queries)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def device_sync(device=None) -> None:
    """Wait until every kernel queued on ``device`` (a CUDA device, or
    None for the current one) has finished. A no-op for the CPU."""
    if device is not None and torch.device(device).type != "cuda":
        return
    torch.cuda.synchronize(device)


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (nested lists, tuples and
    dict values)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (list, tuple)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    return found


def time_op(fn: Callable, *args, warmup: int = 1, iters: int = 3, **kwargs):
    """Best-of-``iters`` wall time of ``fn(*args, **kwargs)``, each call's
    result synced on the CUDA devices of its tensors (nothing to wait for
    on the CPU). Returns ``(best_seconds, last_output)``."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        for dev in _cuda_devices(out, set()):
            device_sync(dev)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        for dev in _cuda_devices(out, set()):
            device_sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def cuda_time_ms(fn: Callable, *args, warmup: int = 1, iters: int = 5,
                 **kwargs) -> float:
    """Mean milliseconds per call of ``fn(*args, **kwargs)`` on the current
    CUDA stream, from CUDA events around ``iters`` back-to-back calls
    after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args, **kwargs)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters
