"""Functional HyperLogLog ops: a batch of sketches is one int8[B, m] tensor.

Port of ``datasketch_tpu/ops/hll_ops.py``. Updates are a scatter-max of
ranks into the registers, merges an elementwise max. Hashes are int tensors
of uint32 values (int32 bit patterns or int64 0..2**32-1); 64-bit hashes
stay (hi, lo) limb pairs, as :func:`datasketch_tpu_torch.ops.hashing.mix64`
returns them. Every function runs on the device of its tensors; padding
slots (column >= length) are masked out, as in the JAX package.

No Pallas kernel stands behind these in the JAX package (plain ``jax.jit``),
so they stay torch ops here. ``device_calls`` counts the calls that ran on
a CUDA device, so a caller can show that its device path ran there.
"""

from __future__ import annotations

import torch

from datasketch_tpu_torch.device import u32_values
from datasketch_tpu_torch.ops.hashing import mix64

__all__ = [
    "bit_length32",
    "ranks_and_indices32",
    "ranks_and_indices64",
    "update_regs",
    "sketch_batch32",
    "sketch_batch64",
    "sketch_batch64_ids",
    "merge_regs",
    "raw_estimate",
    "count_batch",
    "device_calls",
]

device_calls = 0  # calls of this module's functions on a CUDA device

_LOW32 = 0xFFFFFFFF


def _count(t: torch.Tensor) -> None:
    global device_calls
    if t.device.type == "cuda":
        device_calls += 1


def bit_length32(x: torch.Tensor) -> torch.Tensor:
    """Per-element ``int.bit_length()`` of uint32 values, int64 (branchless)."""
    x = u32_values(x)
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        y = x >> shift
        big = y > 0
        n = n + torch.where(big, shift, 0)
        x = torch.where(big, y, x)
    return n + (x > 0).to(torch.int64)


def ranks_and_indices32(hashes: torch.Tensor, p: int):
    """(register index int64, rank int8) of 32-bit hashes: index =
    ``h & (m - 1)``, rank = ``(32 - p) - bit_length(h >> p) + 1``."""
    h = u32_values(hashes)
    idx = h & ((1 << p) - 1)
    rank = (32 - p) - bit_length32(h >> p) + 1
    return idx, rank.to(torch.int8)


def ranks_and_indices64(hash_hi: torch.Tensor, hash_lo: torch.Tensor, p: int):
    """The same for 64-bit hashes in (hi, lo) uint32 limbs (HLL++), for
    4 <= p <= 16."""
    hi, lo = u32_values(hash_hi), u32_values(hash_lo)
    idx = lo & ((1 << p) - 1)
    bits_lo = ((lo >> p) | (hi << (32 - p))) & _LOW32
    bits_hi = hi >> p
    bl = torch.where(bits_hi > 0, 32 + bit_length32(bits_hi), bit_length32(bits_lo))
    rank = (64 - p) - bl + 1
    return idx, rank.to(torch.int8)


def update_regs(regs: torch.Tensor, idx: torch.Tensor, rank: torch.Tensor,
                valid: torch.Tensor, m: int) -> torch.Tensor:
    """Scatter-max ranks into registers, in place; returns ``regs``.

    Args:
        regs: int8[B, m]; idx: int64[B, T] in [0, m); rank: int8[B, T];
        valid: bool[B, T] (padding slots rank 0, so they never raise a
        register).
    """
    _count(regs)
    if regs.shape[1] != m:
        raise ValueError("regs has %d registers, expected %d" % (regs.shape[1], m))
    rank = torch.where(valid, rank, torch.zeros((), dtype=torch.int8, device=rank.device))
    return regs.scatter_reduce_(1, idx, rank, "amax")


def _valid_mask(shape, lengths: torch.Tensor) -> torch.Tensor:
    col = torch.arange(shape[1], device=lengths.device)
    return col[None, :] < lengths.to(torch.int64)[:, None]


def sketch_batch32(hashes: torch.Tensor, lengths: torch.Tensor, p: int) -> torch.Tensor:
    """Fresh int8[B, 2**p] registers of a padded [B, T] batch of 32-bit
    hashes (``lengths`` int[B] masks the padding)."""
    _count(hashes)
    idx, rank = ranks_and_indices32(hashes, p)
    regs = torch.zeros((hashes.shape[0], 1 << p), dtype=torch.int8, device=hashes.device)
    return update_regs(regs, idx, rank, _valid_mask(hashes.shape, lengths), 1 << p)


def sketch_batch64(hash_hi: torch.Tensor, hash_lo: torch.Tensor, lengths: torch.Tensor,
                   p: int) -> torch.Tensor:
    """:func:`sketch_batch32` for 64-bit hashes as (hi, lo) limbs (HLL++)."""
    _count(hash_hi)
    idx, rank = ranks_and_indices64(hash_hi, hash_lo, p)
    regs = torch.zeros((hash_hi.shape[0], 1 << p), dtype=torch.int8, device=hash_hi.device)
    return update_regs(regs, idx, rank, _valid_mask(hash_hi.shape, lengths), 1 << p)


def sketch_batch64_ids(ids: torch.Tensor, lengths: torch.Tensor, p: int) -> torch.Tensor:
    """HLL++ registers straight from raw uint32 token ids [B, T]: the
    64-bit device hash (:func:`~datasketch_tpu_torch.ops.hashing.mix64` of
    the zero-extended id, equal to ``hashfunc.device_hash64``) runs on the
    ids' device, so only the 4-byte (or narrower) ids are uploaded."""
    _count(ids)
    lo = u32_values(ids)
    hi, lo = mix64(torch.zeros_like(lo), lo)
    return sketch_batch64(hi, lo, lengths, p)


def merge_regs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Union of two register batches: the elementwise max."""
    _count(a)
    return torch.maximum(a, b)


def _alpha(p: int) -> float:
    if p == 4:
        return 0.673
    if p == 5:
        return 0.697
    if p == 6:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / (1 << p))


def raw_estimate(regs: torch.Tensor, p: int) -> torch.Tensor:
    """f32 ``alpha * m**2 / sum(2**-reg)`` per row. The f32 sum's order is
    torch's, so it agrees with the JAX package's to f32 rounding, not
    bit for bit."""
    _count(regs)
    m = 1 << p
    s = torch.exp2(-regs.to(torch.float32)).sum(dim=-1)
    return _alpha(p) * float(m) ** 2 / s


def count_batch(regs: torch.Tensor, p: int) -> torch.Tensor:
    """f32 HLL count per row of int8[B, m], with the small-range (linear
    counting) and large-range corrections."""
    _count(regs)
    m = 1 << p
    e = raw_estimate(regs, p)
    num_zero = (regs == 0).sum(dim=-1)
    lc = m * torch.log(m / num_zero.clamp_min(1).to(torch.float32))
    small = e <= 2.5 * m
    out = torch.where(small & (num_zero > 0), lc, e)
    large = out > (1.0 / 30.0) * (1 << 32)
    lr = -(2.0 ** 32) * torch.log1p(-out / 2.0 ** 32)
    return torch.where(large, lr, out)
