"""Tracing and timing utilities for the CUDA port.

Port of ``datasketch_tpu/utils/profiling.py``: :func:`trace` records a
``torch.profiler`` trace (host and, with a card, CUDA activity) as a
Chrome trace in a directory, :func:`time_op` takes the best wall time of a
call with its result's devices synced, ``device_sync`` waits for the card,
and :func:`cuda_time_ms` times a callable with CUDA events (host clocks
around asynchronous launches measure only the enqueue).

Spans and counters of the library's own steps record while a
``torch.profiler`` session records (:func:`trace`, or any
``torch.profiler.profile`` of the caller's) and at no other time: there is
no switch. A span is a ``record_function`` range on the profiler's host
timeline, beside the CUDA activity it enqueues; with no profiler running,
:func:`span` returns one shared null context and :func:`count` returns at
once. Span names are ``dstt.<layer>.<step>``:

- ``dstt.facade.top_k``, ``dstt.facade.query_batch``: a whole
  ``TorchMinHashLSH``, ``TorchMinHashLSHEnsemble`` or ``TorchBBitIndex``
  call;
  ``dstt.facade.decode``: the host decode of a batch's results into keys
  (and scores); ``dstt.facade.rerun``: a containment scan's second pass,
  over the queries whose match count exceeded the answer cap, with its
  selection;
- ``dstt.facade.bulk_signatures``: a whole ``MinHash.bulk_signatures``
  call; ``dstt.facade.order``: its document normalisation, length sort
  and chunking; ``dstt.facade.scatter``: a chunk's rows put back in input
  order;
- ``dstt.front.tokens``: a chunk's bytes tokens walked into a pinned
  buffer, and ``dstt.front.sha1`` inside it: for ``sha1_hash32`` the
  native pack of the tokens' bytes and offsets (the wait for a free pack
  slot is the rest of ``front.tokens``), for ``xxhash_hash32`` the native
  hasher's call;
- ``dstt.upload.queries``: a query batch sent to the device;
  ``dstt.upload.chunk``: a sketching chunk's tokens, lengths or row
  positions sent to the device; ``dstt.upload.fetch``: a batch's results
  copied back (the wait for the device included);
- ``dstt.glue.probe``: band fingerprints and bucket probes;
  ``dstt.glue.select``: dedupe, cutoff and compaction of candidates;
  ``dstt.glue.sign``: a sketching chunk's offsets and token widening;
  ``dstt.glue.select_hits``: the row sort of a containment pass's hits,
  the top-k of a second pass's rows, and the compaction of the answers;
  ``dstt.glue.running_topk``: the tiled running top-k over kernel 4 of a
  top-k scan past k = 128; ``dstt.glue.pack``: a b-bit query batch packed
  into words; ``dstt.glue.fold_topk``: one tile of a b-bit scan, its
  counts made hit keys and folded into the running top-k;
- ``dstt.kernel.<module>``: a kernel wrapper of
  :mod:`datasketch_tpu_torch.kernels` (the launch's enqueue on a card, the
  plain twin on the CPU).

Counters (:func:`counters`): ``upload.fetch_bytes``, the bytes of the
result tensors a ``TorchMinHashLSH``, ``TorchMinHashLSHEnsemble`` or
``TorchBBitIndex`` batch copies back;
``facade.fetched_slots``, the id slots among them (a threshold batch's are
its answers alone: it is compacted on the device first);
``facade.answers``, the entries the host decode returned;
``ensemble.passes``, the containment scan passes (the first and each
chunk of the second); ``ensemble.rescanned``, the queries a containment
batch scans a second time (counted in every batch, 0 included);
``ensemble.matches``, the match counts of a containment batch's queries,
summed; ``front.card_sha1_tokens``, the bytes tokens that kernel 9 hashed
(its plain twin on the CPU) for ``bulk_signatures``; ``bbit.tiles``, the
steps of a b-bit scan (one kernel 5 launch each on a card).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "time_op", "device_sync", "cuda_time_ms", "span", "count",
           "recording", "counters", "reset_counters"]

_OFF = contextlib.nullcontext()
_counters: dict = {}


def span(name: str):
    """A context that marks its block as ``name`` on the profiler's host
    timeline while a ``torch.profiler`` session records, else a shared
    null context (nothing is made)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a ``torch.profiler`` session
    records; a no-op otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


def recording() -> bool:
    """Whether a ``torch.profiler`` session records (spans and counters are
    on): a caller checks it before work done only to feed a counter."""
    return bool(_autograd_profiler._is_profiler_enabled)


def counters() -> dict:
    """A copy of the counters, summed over every profiled stretch since
    :func:`reset_counters` (or the process's start)."""
    return dict(_counters)


def reset_counters() -> None:
    """Set every counter back to nothing."""
    _counters.clear()


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
