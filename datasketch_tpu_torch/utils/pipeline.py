"""Dispatch pipelining for batched serving on the card.

Port of ``datasketch_tpu/utils/pipeline.py``. PyTorch enqueues kernels
asynchronously; :func:`stream_batches` keeps up to ``depth`` batches in
flight: each dispatch enqueues its work on the current CUDA stream and
starts ``non_blocking`` copies of its CUDA results into pinned host
buffers, with one event recorded after them, so batch i's copy overlaps
batches i+1.. i+depth's compute. Finishing a batch waits on its own event
only. On the CPU everything runs in order.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

import torch

__all__ = ["stream_batches"]


def _to_host(tree, devices: set):
    """``tree`` (tensors inside tuples and lists) with every CUDA tensor
    replaced by a pinned host tensor that its copy is in flight to; the
    tensors' devices are added to ``devices``."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(x, devices) for x in tree)
    if isinstance(tree, torch.Tensor) and tree.device.type == "cuda":
        host = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
        host.copy_(tree, non_blocking=True)
        devices.add(tree.device)
        return host
    return tree


def _start_copies(tree):
    """(host tree with its copies in flight, the events that mark their end)."""
    devices: set = set()
    host = _to_host(tree, devices)
    events = []
    for dev in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        events.append(event)
    return host, events


def stream_batches(
    batches: Iterable,
    dispatch: Callable,
    finish: Callable,
    depth: int = 4,
) -> Iterator:
    """Yield ``finish(host(dispatch(batch)))`` per batch, pipelined.

    Args:
        batches: iterable of per-batch inputs.
        dispatch: batch -> tensors (in tuples or lists) and static values;
            must not synchronize. Called in order.
        finish: the same structure with every CUDA tensor copied to the
            host -> the final host result. Called in order, ``depth``
            batches behind dispatch, once that batch's copies have landed.
        depth: max batches in flight.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    inflight: deque = deque()

    def _done():
        host, events = inflight.popleft()
        for event in events:
            event.synchronize()
        return finish(host)

    for batch in batches:
        inflight.append(_start_copies(dispatch(batch)))
        if len(inflight) >= depth:
            yield _done()
    while inflight:
        yield _done()
