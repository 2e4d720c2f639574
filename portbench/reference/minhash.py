"""Plain MinHash signatures: the reference's values, worked out anew.

datasketch's ``MinHash`` (``datasketch/minhash.py``): token hash h (the low
4 bytes of SHA1, little-endian), and per permutation j the value ``((a_j * h + b_j) mod 2**64) mod (2**61 - 1)``
cut to its low 32 bits; a signature slot is the least such value over the
document's tokens. (a, b) are datasketch's draw from ``RandomState(seed)``.

The products are taken in 16- and 32-bit limbs held in int64, so no
intermediate overflows; this runs on the CPU or, in blocks of documents,
on the card. Imports nothing of the program.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

MERSENNE = (1 << 61) - 1
MAX_HASH = (1 << 32) - 1
M32 = 0xFFFFFFFF


def permutations(seed: int, num_perm: int):
    """datasketch's (a, b): for each permutation a = randint(1, p), then
    b = randint(0, p), from one ``RandomState(seed)``; two int64 arrays."""
    gen = np.random.RandomState(seed)
    a, b = [], []
    for _ in range(num_perm):
        a.append(int(gen.randint(1, MERSENNE, dtype=np.uint64)))
        b.append(int(gen.randint(0, MERSENNE, dtype=np.uint64)))
    return np.array(a, dtype=np.int64), np.array(b, dtype=np.int64)


def sha1_table(words) -> np.ndarray:
    """SHA1 low 32 bits (little-endian) of each token, by ``hashlib``."""
    return np.array(
        [int.from_bytes(hashlib.sha1(w).digest()[:4], "little") for w in words],
        dtype=np.int64,
    )


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer over int64 values 0..2**32-1 (the LSH
    band keys' fold)."""
    x = x & M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def permuted(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             mersenne: bool = True) -> torch.Tensor:
    """``((a*h + b) mod 2**64) mod (2**61 - 1) & 0xFFFFFFFF`` for int64 h
    (0..2**32-1) and a, b (< 2**61), broadcast. ``mersenne=False`` stops at
    ``(a*h + b) mod 2**32``: the 32-bit universal hash, the control's
    cheaper arithmetic."""
    a_lo, a_hi = a & M32, a >> 32
    b_lo, b_hi = b & M32, b >> 32
    h_lo, h_hi = h & 0xFFFF, h >> 16
    x = a_lo * h_lo  # < 2**48
    y = a_lo * h_hi  # < 2**48; a_lo * h = x + y * 2**16
    lo = (x & M32) + ((y & 0xFFFF) << 16) + b_lo
    if not mersenne:
        return lo & M32
    hi = (x >> 32) + (y >> 16) + ((a_hi * h) & M32) + b_hi + (lo >> 32)
    s_lo, s_hi = lo & M32, hi & M32
    v = ((s_hi & 0x1FFFFFFF) << 32) + s_lo + (s_hi >> 29)  # < 2**61 + 8
    v = torch.where(v >= MERSENNE, v - MERSENNE, v)
    return v & M32


def signatures(token_hash: torch.Tensor, ids: torch.Tensor, seed: int, num_perm: int,
               block: int = 256, mersenne: bool = True) -> torch.Tensor:
    """Signature rows of documents that all have the same token count.

    Args:
        token_hash: int64[V] hash of each vocabulary token, on the device
            the work runs on.
        ids: int64[D, T] token ids (indexes into ``token_hash``).
        seed, num_perm: the permutation family.

    Returns int32[D, num_perm] (uint32 bits) on ``token_hash``'s device.
    """
    dev = token_hash.device
    a_np, b_np = permutations(seed, num_perm)
    a = torch.from_numpy(a_np).to(dev)
    b = torch.from_numpy(b_np).to(dev)
    ids = ids.to(dev)
    out = torch.empty((ids.shape[0], num_perm), dtype=torch.int64, device=dev)
    if ids.shape[1] == 0:
        out.fill_(MAX_HASH)
    for d0 in range(0, ids.shape[0], block):
        h = token_hash[ids[d0: d0 + block]]  # [d, T]
        out[d0: d0 + block] = permuted(h[..., None], a, b, mersenne).amin(dim=1)
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(torch.int32)
