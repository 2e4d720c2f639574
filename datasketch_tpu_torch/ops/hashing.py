"""Token mixing and the MinHash permutation, as plain torch on int64.

Ports ``datasketch_tpu/ops/hashing.py::mix32`` / ``mix64`` and
``datasketch_tpu/ops/u64.py::permute_hash``. The JAX package emulates
64-bit arithmetic in uint32 limb pairs for the TPU; here every value is an
int64 tensor holding a u32 (0..2**32-1) or a u64 bit pattern. ``a*h + b``
wraps mod 2**64 exactly as two's complement int64 does, and ``>>`` on int64
is arithmetic, so every shift is masked.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MERSENNE_PRIME",
    "MAX_HASH",
    "mix32",
    "mix32_np",
    "mix64",
    "mix64_np",
    "permute_hash",
]

MERSENNE_PRIME = (1 << 61) - 1
MAX_HASH = (1 << 32) - 1
_LOW32 = 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 over int64 tensors holding uint32 values."""
    x = x & _LOW32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _LOW32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _LOW32
    return x ^ (x >> 16)


def mix32_np(x) -> np.ndarray:
    """Host NumPy twin of :func:`mix32` on uint32 arrays, bit-identical (a
    copy of the JAX package's)."""
    x = np.asarray(x).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = np.multiply(x, np.uint32(0x85EBCA6B), dtype=np.uint32)
    x = x ^ (x >> np.uint32(13))
    x = np.multiply(x, np.uint32(0xC2B2AE35), dtype=np.uint32)
    return x ^ (x >> np.uint32(16))


def mix64(hi: torch.Tensor, lo: torch.Tensor):
    """Two-round 64-bit finalizer over (hi, lo) int64 tensors holding
    uint32 limbs: fmix32 rounds that mix the limbs against each other, so
    every input bit reaches both output limbs. Returns (hi, lo)."""
    hi = mix32(hi ^ (lo >> 16) ^ ((lo << 16) & _LOW32))
    lo = mix32(lo ^ hi)
    hi = mix32(hi ^ (lo >> 13))
    return hi, lo


def mix64_np(x) -> np.ndarray:
    """Host NumPy twin of :func:`mix64` over uint64 values, bit-identical
    (a copy of the JAX package's)."""
    x = np.asarray(x).astype(np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = mix32_np(hi ^ (lo >> np.uint32(16)) ^ np.left_shift(lo, np.uint32(16), dtype=np.uint32))
    lo = mix32_np(lo ^ hi)
    hi = mix32_np(hi ^ (lo >> np.uint32(13)))
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def permute_hash(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``((a*h + b) mod 2**64) mod (2**61 - 1) & 0xFFFFFFFF``, bit-exact.

    ``h`` holds uint32 token hashes, ``a``/``b`` the permutation parameters
    (< 2**61) as int64; shapes broadcast. Multiples of the prime map to 0,
    as NumPy's ``%`` does.
    """
    s = a * h + b  # mod 2**64 in two's complement
    y = (s & MERSENNE_PRIME) + ((s >> 61) & 7)
    y = torch.where(y >= MERSENNE_PRIME, y - MERSENNE_PRIME, y)
    return y & _LOW32
