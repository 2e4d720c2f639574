"""Timing helpers for the CUDA port.

Port of ``datasketch_tpu/utils/profiling.py``: ``device_sync`` waits for
the card, and :func:`cuda_time_ms` times a callable with CUDA events
(host clocks around asynchronous launches measure only the enqueue).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["device_sync", "cuda_time_ms"]


def device_sync(device=None) -> None:
    """Wait until every kernel queued on ``device`` (a CUDA device, or
    None for the current one) has finished. A no-op for the CPU."""
    if device is not None and torch.device(device).type != "cuda":
        return
    torch.cuda.synchronize(device)


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
