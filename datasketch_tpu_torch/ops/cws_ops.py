"""Consistent weighted sampling batches and the (k, t) -> slot mix.

Port of ``datasketch_tpu/ops/cws_ops.py``. :func:`cws_many` and
:func:`cws_many_sparse` keep the JAX package's contracts and dispatch by
tensor device to kernels 6 and 7 (:mod:`datasketch_tpu_torch.kernels.cws`):
the plain PyTorch versions for CPU tensors, the Hopper kernels for CUDA
tensors. :func:`kt_slots` mixes each (k, t) pair to one uint32 slot, so
weighted sketches ride the same band tables, scans and reranks as MinHash
signatures; :func:`kt_slots_np` is its host twin (a copy of the JAX
package's), bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from datasketch_tpu_torch.device import u32_to_i32
from datasketch_tpu_torch.kernels import cws

__all__ = ["cws_many", "cws_many_sparse", "kt_slots", "kt_slots_np"]

# splitmix64-style odd constants of the slot mix (the JAX package's)
_KT_C1 = 0x9E3779B97F4A7C15
_KT_C2 = 0xC2B2AE3D27D4EB4F
_LOW32 = 0xFFFFFFFF


def _i64(c: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def cws_many(weights, rs, ln_cs, betas):
    """CWS sketches of a dense weight batch.

    Args:
        weights: f32[B, D] non-negative; entries <= 0 are inactive, and
            rows with none are the caller's to exclude.
        rs, ln_cs, betas: f32[S, D] generator parameters (on the weights'
            device).

    Returns:
        int32[B, S, 2] (k, t) rows, on the weights' device.
    """
    tables = [p.t().contiguous() for p in (rs, ln_cs, betas)]
    return cws.cws_dense(weights.contiguous(), *tables)


def cws_many_sparse(vals, idx, rs_t, lncs_t, betas_t):
    """CWS sketches of padded sparse rows; equal to :func:`cws_many` on
    the densified rows.

    Args:
        vals: f32[B, NZ] weights, zero-padded on the right (entries <= 0
            are inactive).
        idx: int32[B, NZ] dims, ascending per row (CSR order).
        rs_t, lncs_t, betas_t: f32[D, S] TRANSPOSED generator parameters.

    Returns:
        int32[B, S, 2] (k, t) rows.
    """
    b, nz = vals.shape
    indptr = torch.arange(b + 1, dtype=torch.int64, device=vals.device) * nz
    return cws.cws_sparse(vals.reshape(-1).contiguous(),
                          idx.to(torch.int32).reshape(-1).contiguous(), indptr,
                          rs_t, lncs_t, betas_t)


def kt_slots(kt: torch.Tensor) -> torch.Tensor:
    """(k, t) pairs -> slots: int[..., S, 2] -> int32[..., S] (uint32 bits),
    on ``kt``'s device, bit for bit :func:`kt_slots_np`.

    ``((k * C1 + t) * C2) mod 2**64`` folded hi ^ lo, in int64: the
    products wrap mod 2**64 as two's complement does, ``k`` and ``t`` are
    sign-extended as NumPy's int64 -> uint64 cast wraps them (``t`` may be
    negative), and the high word is masked after the arithmetic shift.
    """
    k = kt[..., 0].to(torch.int64)
    t = kt[..., 1].to(torch.int64)
    mixed = (k * _i64(_KT_C1) + t) * _i64(_KT_C2)
    return u32_to_i32(((mixed >> 32) & _LOW32) ^ (mixed & _LOW32))


def kt_slots_np(kt) -> np.ndarray:
    """Host (k, t) pair -> uint32 slot mix: ``[..., S, 2] int -> uint32[..., S]``.

    One uint32 per CWS sample with slot equality iff (k, t) equality (up to
    a 2^-32 mix collision): ``((k * C1 + t) * C2)`` folded hi ^ lo. The
    equal-slot fraction of two sketches is then the weighted-Jaccard
    estimate (the fraction of equal (k, t) rows).
    """
    k = np.asarray(kt)[..., 0].astype(np.int64).astype(np.uint64)
    t = np.asarray(kt)[..., 1].astype(np.int64).astype(np.uint64)
    mixed = (k * np.uint64(_KT_C1) + t) * np.uint64(_KT_C2)
    return ((mixed >> np.uint64(32)) ^ mixed).astype(np.uint32)
