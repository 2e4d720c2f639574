"""Kernel 4 wrapper: all-pairs signature-equality score matrix.

CUDA source: ``datasketch_tpu_torch/csrc/score.cu`` (replaces
``datasketch_tpu/ops/pallas_kernels.py::_score_kernel``). CPU tensors take
the plain PyTorch version; CUDA tensors launch the kernel or raise. The
grid is :func:`~datasketch_tpu_torch.kernels.tiling.grid`'s, as kernel 2's.
"""

from __future__ import annotations

import torch

from datasketch_tpu_torch.device import counts_to_scores
from datasketch_tpu_torch.kernels import build, tiling

__all__ = ["score_matrix", "score_matrix_plain", "eq_counts_plain", "launches"]

launches = 0

_PLAIN_ELEMS = 1 << 24  # [Q, rows, P] bool compare per step


def eq_counts_plain(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """int64[Q, T] equal-slot counts, chunked over db rows."""
    nq, p = q.shape
    nt = db.shape[0]
    out = torch.empty((nq, nt), dtype=torch.int64, device=q.device)
    step = max(1, _PLAIN_ELEMS // max(1, nq * p))
    for r0 in range(0, nt, step):
        r1 = min(nt, r0 + step)
        out[:, r0:r1] = (q[:, None, :] == db[None, r0:r1, :]).sum(dim=-1, dtype=torch.int32)
    return out


def score_matrix_plain(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    return counts_to_scores(eq_counts_plain(q, db), q.shape[1])


def score_matrix(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """f32[Q, T] = mean slot equality of int32[Q, P] x int32[T, P]."""
    if q.device.type == "cpu":
        return score_matrix_plain(q, db)
    build.require_cuda("score_matrix", q, db)
    nq, p = q.shape
    nt = db.shape[0]
    if db.shape[1] != p or q.dtype != torch.int32 or db.dtype != torch.int32:
        raise ValueError("score_matrix: want int32 [Q, P] and [T, P]")
    out = torch.empty((nq, nt), dtype=torch.float32, device=q.device)
    lib = build.library()
    splits, rows = tiling.grid(nq, nt, build.num_sms(q),
                               tiling.blocks_per_sm(lib, "ds_score_blocks_per_sm", q.device, p))
    global launches
    launches += 1
    err = lib.ds_score_matrix(q.data_ptr(), db.data_ptr(), nq, nt, p, splits, rows,
                              out.data_ptr(), build.stream_ptr(q))
    build.check(err, "ds_score_matrix")
    return out
