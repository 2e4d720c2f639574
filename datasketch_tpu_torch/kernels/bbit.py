"""Kernel 5 wrapper: packed b-bit equal-slot counts.

CUDA source: ``datasketch_tpu_torch/csrc/bbit.cu`` (replaces
``datasketch_tpu/ops/pallas_kernels.py::_bbit_kernel``). CPU tensors take
the plain PyTorch version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from datasketch_tpu_torch.kernels import build

__all__ = ["bbit_counts", "bbit_counts_plain", "lsb_mask", "SLOT_SIZES", "MAX_WORDS", "launches"]

launches = 0

SLOT_SIZES = (1, 2, 4, 8, 16, 32)
MAX_WORDS = 256  # W at num_perm 256 and s = 32
_MAX_QUERIES = 65535 * 32  # the grid's y extent times the query block

_PLAIN_ELEMS = 1 << 24  # [Q, rows, W] words per step
_LOW32 = 0xFFFFFFFF


def lsb_mask(s: int) -> int:
    """Bit 1 at every slot's lowest bit (bits 0, s, 2s, ...)."""
    m = 0
    for j in range(0, 32, s):
        m |= 1 << j
    return m


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values 0..2**32-1 (SWAR; torch has no popcount)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _LOW32) >> 24


def _equal_slot_count(x: torch.Tensor, s: int) -> torch.Tensor:
    """Per-word count of all-zero s-bit slots of int64 ``x`` (0..2**32-1):
    ``datasketch_tpu.ops.bbit_ops._equal_slot_count`` in torch."""
    if s == 32:
        return (x == 0).to(torch.int64)
    y = x
    sh = 1
    while sh < s:
        y = y | (y >> sh)
        sh *= 2
    return _popcount32(~y & lsb_mask(s))


def bbit_counts_plain(q_packed: torch.Tensor, db_packed: torch.Tensor, s: int) -> torch.Tensor:
    """int32[Q, T] equal-slot counts, padding slots included, chunked over
    db rows."""
    _check_s(s)
    nq, w = q_packed.shape
    nt = db_packed.shape[0]
    out = torch.empty((nq, nt), dtype=torch.int32, device=q_packed.device)
    q64 = q_packed.to(torch.int64) & _LOW32
    step = max(1, _PLAIN_ELEMS // max(1, nq * w))
    for r0 in range(0, nt, step):
        r1 = min(nt, r0 + step)
        d64 = db_packed[r0:r1].to(torch.int64) & _LOW32
        x = q64[:, None, :] ^ d64[None, :, :]
        out[:, r0:r1] = _equal_slot_count(x, s).sum(dim=2).to(torch.int32)
    return out


def bbit_counts(q_packed: torch.Tensor, db_packed: torch.Tensor, s: int) -> torch.Tensor:
    """int32[Q, T] counts of equal s-bit slots of int32[Q, W] x int32[T, W]
    packed rows, the zero padding slots past num_perm included (callers
    subtract them), s in :data:`SLOT_SIZES`."""
    if q_packed.device.type == "cpu":
        return bbit_counts_plain(q_packed, db_packed, s)
    build.require_cuda("bbit_counts", q_packed, db_packed)
    _check_s(s)
    nq, w = q_packed.shape
    nt = db_packed.shape[0]
    if (db_packed.dim() != 2 or db_packed.shape[1] != w or q_packed.dtype != torch.int32
            or db_packed.dtype != torch.int32):
        raise ValueError("bbit_counts: want int32 [Q, W] and [T, W]")
    if not 1 <= w <= MAX_WORDS or nq > _MAX_QUERIES:
        raise ValueError("bbit_counts: takes 1 <= W <= %d and Q <= %d, got W %d, Q %d"
                         % (MAX_WORDS, _MAX_QUERIES, w, nq))
    out = torch.empty((nq, nt), dtype=torch.int32, device=q_packed.device)
    if nq == 0 or nt == 0:
        return out
    global launches
    launches += 1
    err = build.library().ds_bbit_counts(
        q_packed.data_ptr(), db_packed.data_ptr(), nq, nt, w, s, out.data_ptr(),
        build.stream_ptr(q_packed),
    )
    build.check(err, "ds_bbit_counts")
    return out


def _check_s(s: int) -> None:
    if s not in SLOT_SIZES:
        raise ValueError("slot size must be one of %s, got %r" % (SLOT_SIZES, s))
