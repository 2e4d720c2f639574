"""Kernel 8 wrapper: ragged compaction of a padded threshold result.

CUDA source: ``datasketch_tpu_torch/csrc/compact.cu`` (replaces no TPU
kernel: the JAX package copies its padded result to the host whole). CPU
tensors take the plain PyTorch version; CUDA tensors launch the kernel or
raise. ``launches`` counts calls on the card (each is two launches: count,
then place).
"""

from __future__ import annotations

import torch

from datasketch_tpu_torch.kernels import build
from datasketch_tpu_torch.utils.profiling import span

__all__ = ["compact_rows", "compact_rows_plain", "launches"]

launches = 0


def compact_rows_plain(ids, sc=None):
    """The compaction in PyTorch ops: a filled slot's place is its rank
    among the filled slots of the row-major [Q * W] (one cumsum), and every
    empty slot is written to one spare place ahead of the answers, so one
    unmasked scatter a tensor places them."""
    filled = ids >= 0
    counts = filled.sum(dim=1, dtype=torch.int32)
    rank = filled.reshape(-1).cumsum(0, dtype=torch.int64)
    pos = torch.where(filled.reshape(-1), rank, 0)
    cap = ids.numel() + 1

    def place(x):
        return torch.empty(cap, dtype=x.dtype, device=x.device).scatter_(
            0, pos, x.reshape(-1))[1:]

    return counts, place(ids), None if sc is None else place(sc)


def compact_rows(ids, sc=None):
    """The filled slots (id >= 0, anywhere in a row) of a padded result,
    row after row, each row in its own order.

    Args:
        ids: int32[Q, W], -1 = empty.
        sc: optional f32[Q, W] scores beside them.

    Returns:
        (counts int32[Q], flat_ids int32[Q * W], flat_sc f32[Q * W] or
        None): the first ``counts.sum()`` places of the flat tensors hold
        the answers; the rest is not written.
    """
    with span("dstt.kernel.compact"):
        if ids.device.type == "cpu":
            return compact_rows_plain(ids, sc)
        build.require_cuda("compact_rows", *((ids,) if sc is None else (ids, sc)))
        if ids.dim() != 2 or ids.dtype != torch.int32 or (
                sc is not None and (sc.dtype != torch.float32 or sc.shape != ids.shape)):
            raise ValueError("compact_rows: want int32 ids [Q, W] and f32 scores [Q, W]")
        nq, w = ids.shape
        counts = torch.empty(nq, dtype=torch.int32, device=ids.device)
        flat_ids = torch.empty(nq * w, dtype=torch.int32, device=ids.device)
        flat_sc = None if sc is None else torch.empty(nq * w, dtype=torch.float32,
                                                      device=ids.device)
        global launches
        launches += 1
        err = build.library().ds_compact_rows(
            ids.data_ptr(), None if sc is None else sc.data_ptr(), nq, w, counts.data_ptr(),
            flat_ids.data_ptr(), None if flat_sc is None else flat_sc.data_ptr(),
            build.stream_ptr(ids),
        )
        build.check(err, "ds_compact_rows")
        return counts, flat_ids, flat_sc
