"""Kernel 3 wrapper: band-candidate rerank with the gather fused in.

CUDA source: ``datasketch_tpu_torch/csrc/rerank.cu`` (replaces
``datasketch_tpu/ops/pallas_kernels.py::_rerank_kernel`` plus the
``db_sigs[cand_ids]`` gather of ``lsh_ops.rerank_jaccard``). CPU tensors
take the plain PyTorch version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from datasketch_tpu_torch.device import counts_to_scores
from datasketch_tpu_torch.kernels import build

__all__ = ["rerank_scores", "rerank_scores_plain", "launches"]

launches = 0

_PLAIN_ELEMS = 1 << 24  # gathered [rows, C, P] slots per step


def rerank_scores_plain(db, q, cand):
    nq, c = cand.shape
    p = q.shape[1]
    out = torch.empty((nq, c), dtype=torch.float32, device=q.device)
    step = max(1, _PLAIN_ELEMS // max(1, c * p))
    for r0 in range(0, nq, step):
        r1 = min(nq, r0 + step)
        ids = cand[r0:r1].to(torch.int64)
        valid = ids >= 0
        rows = db[torch.where(valid, ids, 0)]  # [rows, C, P]
        cnt = (rows == q[r0:r1, None, :]).sum(dim=-1)
        out[r0:r1] = torch.where(valid, counts_to_scores(cnt, p), 0.0)
    return out


def rerank_scores(db, q, cand):
    """f32[Q, C]: mean slot equality of query i against db row cand[i, c],
    0 where cand is -1.

    Args:
        db: int32[N, P] indexed signatures.
        q: int32[Q, P] query signatures.
        cand: int32[Q, C] candidate row ids, -1 = none.
    """
    if q.device.type == "cpu":
        return rerank_scores_plain(db, q, cand)
    build.require_cuda("rerank_scores", db, q, cand)
    nq, c = cand.shape
    p = q.shape[1]
    if db.shape[1] != p or cand.dtype != torch.int32 or db.dtype != torch.int32:
        raise ValueError("rerank_scores: want int32 db [N, P], q [Q, P], cand [Q, C]")
    out = torch.empty((nq, c), dtype=torch.float32, device=q.device)
    global launches
    launches += 1
    err = build.library().ds_rerank(
        db.data_ptr(), q.data_ptr(), cand.data_ptr(), db.shape[0], nq, c, p,
        out.data_ptr(), build.stream_ptr(q),
    )
    build.check(err, "ds_rerank")
    return out
