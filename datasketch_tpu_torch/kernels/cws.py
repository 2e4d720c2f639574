"""Kernels 6 and 7 wrappers: Ioffe CWS (k, t) sketches of weight rows.

CUDA source: ``datasketch_tpu_torch/csrc/cws.cu`` (replaces
``datasketch_tpu/ops/pallas_kernels.py::_cws_kernel``, dense rows, with
:func:`cws_dense`, and ``::_cws_sparse_kernel``, CSR rows, with
:func:`cws_sparse`). Both take the generator's parameter tables TRANSPOSED,
f32 ``[D, S]``. CPU tensors take the plain PyTorch versions; CUDA tensors
launch the kernel or raise. ``launches`` counts kernel 6, ``launches_sparse``
kernel 7.

The plain versions transcribe the JAX package's ``cws_ops.cws_many`` and
``cws_many_sparse`` (sample blocks, first-minimum ``argmin``): every f32
step is its own tensor operation, in the JAX op order. A row with no
positive weight gives (0, 0) on every path (the JAX package's XLA sparse
form gives its first entry's dim instead); callers exclude such rows.
"""

from __future__ import annotations

import torch

from datasketch_tpu_torch.kernels import build
from datasketch_tpu_torch.utils.profiling import span

__all__ = [
    "cws_dense",
    "cws_dense_plain",
    "cws_sparse",
    "cws_sparse_plain",
    "launches",
    "launches_sparse",
]

launches = 0  # kernel 6 (dense rows)
launches_sparse = 0  # kernel 7 (CSR rows)

# [rows, samples, dims] temporaries of the plain versions stay under this
# many elements per step
_PLAIN_ELEMS = 1 << 22
_PLAIN_SAMPLES = 16


def _argmin_kt(t, ln_a, active, dims, axis: int):
    """(k, t) of the first minimum of ``ln_a`` along ``axis`` (inactive
    entries +inf); ``dims`` maps positions along ``axis`` to dims."""
    ln_a = torch.where(active, ln_a, torch.inf)
    pos = torch.argmin(ln_a, dim=axis, keepdim=True)
    t_k = torch.gather(t, axis, pos).squeeze(axis)
    k = pos.squeeze(axis) if dims is None else torch.gather(dims, 1, pos.squeeze(axis))
    return k.to(torch.int32), t_k.to(torch.int32)


def _vlog(w):
    active = w > 0
    return torch.where(active, torch.log(torch.where(active, w, 1.0)), 0.0), active


def cws_dense_plain(weights, rs_t, lncs_t, betas_t):
    """Plain PyTorch twin of kernel 6 (same arguments, same result)."""
    b, d = weights.shape
    s = rs_t.shape[1]
    out = torch.empty((b, s, 2), dtype=torch.int32, device=weights.device)
    vlog, active = _vlog(weights)
    rows = max(1, _PLAIN_ELEMS // (_PLAIN_SAMPLES * max(1, d)))
    for s0 in range(0, s, _PLAIN_SAMPLES):
        s1 = min(s, s0 + _PLAIN_SAMPLES)
        r = rs_t[:, s0:s1].t()[None]  # [1, sb, D]
        lc = lncs_t[:, s0:s1].t()[None]
        be = betas_t[:, s0:s1].t()[None]
        for r0 in range(0, b, rows):
            r1 = min(b, r0 + rows)
            t = torch.floor(vlog[r0:r1, None, :] / r + be)
            ln_a = lc - (t - be) * r - r
            out[r0:r1, s0:s1, 0], out[r0:r1, s0:s1, 1] = _argmin_kt(
                t, ln_a, active[r0:r1, None, :], None, 2)
    return out


def cws_sparse_plain(vals, idx, indptr, rs_t, lncs_t, betas_t):
    """Plain PyTorch twin of kernel 7 (same arguments, same result): rows
    are padded to [rows, NZ] a chunk at a time and the parameter columns
    gathered to [rows, NZ, sb], as the JAX package's XLA form does."""
    b = indptr.shape[0] - 1
    s = rs_t.shape[1]
    dev = vals.device
    out = torch.empty((b, s, 2), dtype=torch.int32, device=dev)
    if b <= 0:
        return out
    if not vals.numel():  # every row empty: one inactive slot each
        vals, idx = vals.new_zeros(1), idx.new_zeros(1)
    lengths = indptr[1:] - indptr[:-1]
    nz_all = max(1, int(lengths.max()))
    rows = max(1, _PLAIN_ELEMS // (_PLAIN_SAMPLES * nz_all))
    col = torch.arange(nz_all, device=dev)
    for r0 in range(0, b, rows):
        r1 = min(b, r0 + rows)
        nz = max(1, int(lengths[r0:r1].max()))
        valid = col[None, :nz] < lengths[r0:r1, None]
        pos = torch.where(valid, indptr[r0:r1, None] + col[None, :nz], 0)
        w = torch.where(valid, vals[pos], 0.0)
        vlog, active = _vlog(w)
        # inactive entries never win; a row with none gives k = 0
        dims = torch.where(active, idx[pos], 0).long()
        for s0 in range(0, s, _PLAIN_SAMPLES):
            s1 = min(s, s0 + _PLAIN_SAMPLES)
            r = rs_t[:, s0:s1][dims]  # [rows, NZ, sb]
            lc = lncs_t[:, s0:s1][dims]
            be = betas_t[:, s0:s1][dims]
            t = torch.floor(vlog[:, :, None] / r + be)
            ln_a = lc - (t - be) * r - r
            out[r0:r1, s0:s1, 0], out[r0:r1, s0:s1, 1] = _argmin_kt(
                t, ln_a, active[:, :, None], dims, 1)
    return out


def _check_tables(name, d, rs_t, lncs_t, betas_t):
    for p in (rs_t, lncs_t, betas_t):
        if p.dtype != torch.float32 or p.dim() != 2 or p.shape != rs_t.shape:
            raise ValueError("%s: want f32 parameter tables [D, S] of one shape" % name)
    if d is not None and rs_t.shape[0] != d:
        raise ValueError("%s: weights have %d dims, the tables %d" % (name, d, rs_t.shape[0]))


def _vec(s, *tensors) -> int:
    """1 when the kernel may move 4 samples as one 16-byte word."""
    return int(s % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def cws_dense(weights, rs_t, lncs_t, betas_t):
    """(k, t) sketches int32[B, S, 2] of dense weight rows.

    Args:
        weights: f32[B, D]; entries <= 0 are inactive.
        rs_t, lncs_t, betas_t: f32[D, S] transposed generator parameters.
    """
    with span("dstt.kernel.cws"):
        if weights.device.type == "cpu":
            return cws_dense_plain(weights, rs_t, lncs_t, betas_t)
        build.require_cuda("cws_dense", weights, rs_t, lncs_t, betas_t)
        if weights.dtype != torch.float32 or weights.dim() != 2:
            raise ValueError("cws_dense: want f32 weights [B, D]")
        _check_tables("cws_dense", weights.shape[1], rs_t, lncs_t, betas_t)
        b, d = weights.shape
        s = rs_t.shape[1]
        out = torch.empty((b, s, 2), dtype=torch.int32, device=weights.device)
        global launches
        launches += 1
        err = build.library().ds_cws_dense(
            weights.data_ptr(), rs_t.data_ptr(), lncs_t.data_ptr(), betas_t.data_ptr(),
            b, d, s, _vec(s, rs_t, lncs_t, betas_t, out), out.data_ptr(),
            build.stream_ptr(weights),
        )
        build.check(err, "ds_cws_dense")
        return out


def cws_sparse(vals, idx, indptr, rs_t, lncs_t, betas_t):
    """(k, t) sketches int32[B, S, 2] of CSR weight rows.

    Args:
        vals: f32[nnz] weights; entries <= 0 are inactive.
        idx: int32[nnz] dims (< D), ascending within each row for the
            lowest-dim tie rule (the first entry wins a tie; rows in any
            order give the first minimum in entry order).
        indptr: int64[B + 1] row offsets into ``vals`` / ``idx``.
        rs_t, lncs_t, betas_t: f32[D, S] transposed generator parameters.
    """
    with span("dstt.kernel.cws"):
        if vals.device.type == "cpu":
            return cws_sparse_plain(vals, idx, indptr, rs_t, lncs_t, betas_t)
        build.require_cuda("cws_sparse", vals, idx, indptr, rs_t, lncs_t, betas_t)
        if (vals.dtype != torch.float32 or idx.dtype != torch.int32
                or indptr.dtype != torch.int64 or vals.dim() != 1
                or idx.shape != vals.shape or indptr.dim() != 1):
            raise ValueError("cws_sparse: want f32 vals[nnz], int32 idx[nnz], int64 indptr[B + 1]")
        _check_tables("cws_sparse", None, rs_t, lncs_t, betas_t)
        b = indptr.shape[0] - 1
        if b < 0:
            raise ValueError("cws_sparse: indptr needs at least one offset")
        # one fetch: the dim range and the offsets' order and ends, so the
        # kernel never reads outside vals / idx or the tables
        dims = torch.stack(list(torch.aminmax(idx))) if idx.numel() else idx.new_zeros(2)
        stats = torch.cat([dims.long(), indptr[[0, -1]],
                           (indptr[1:] < indptr[:-1]).sum().reshape(1)]).tolist()
        if stats[0] < 0 or stats[1] >= rs_t.shape[0]:
            raise ValueError("cws_sparse: dims must lie in [0, %d)" % rs_t.shape[0])
        if stats[2] < 0 or stats[3] > vals.numel() or stats[4]:
            raise ValueError("cws_sparse: indptr must rise from >= 0 to <= nnz")
        s = rs_t.shape[1]
        out = torch.empty((b, s, 2), dtype=torch.int32, device=vals.device)
        global launches_sparse
        launches_sparse += 1
        err = build.library().ds_cws_sparse(
            vals.data_ptr(), idx.data_ptr(), indptr.data_ptr(), rs_t.data_ptr(),
            lncs_t.data_ptr(), betas_t.data_ptr(), b, s,
            _vec(s, rs_t, lncs_t, betas_t, out), out.data_ptr(), build.stream_ptr(vals),
        )
        build.check(err, "ds_cws_sparse")
        return out
