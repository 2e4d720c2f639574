"""k-shingle hashing on the card, straight from raw text bytes.

Port of ``datasketch_tpu/ops/text_ops.py``: the raw text is uploaded (1
byte per character, where host-hashed shingles ship 4 bytes per
shingle), every overlapping k-byte window is hashed on the card by a
k-step polynomial roll finalized with murmur3's fmix32, and kernel 1
signs each text's windows. The values equal the JAX package's bit for
bit; like ``hashfunc="device"`` for token ids, they are not the
reference's SHA1 shingle values (the estimator's statistics are the
same).

The JAX package gathers each text into a padded [B, width] row and pads
the flat byte axis to a power of two to bound its compiles. Here the roll
runs once over the flat bytes of the whole batch, and kernel 1 reads each
text's windows in place, through the text's start and its window count.
"""

from __future__ import annotations

import numpy as np
import torch

from datasketch_tpu_torch.device import u32_to_i32
from datasketch_tpu_torch.kernels import minhash_sign
from datasketch_tpu_torch.ops.hashing import mix32, mix32_np
from datasketch_tpu_torch.ops.minhash_ops import perm_tensors

__all__ = ["window_hashes_np", "window_hashes", "shingle_signatures_ragged"]

# FNV-32 prime: odd multiplier of the polynomial accumulator; fmix32 gives
# the final avalanche (the JAX package's constant)
_POLY_C = 0x01000193
_LOW32 = 0xFFFFFFFF


def window_hashes_np(text: bytes, k: int) -> np.ndarray:
    """Host twin of the device shingle hash, bit-identical.

    Returns uint32[max(0, len(text)-k+1)] -- the hash of every overlapping
    k-byte window of ``text``.
    """
    n = max(0, len(text) - k + 1)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    chars = np.frombuffer(text, dtype=np.uint8).astype(np.uint32)
    h = np.zeros(n, dtype=np.uint32)
    c = np.uint32(_POLY_C)
    for j in range(k):
        h = np.multiply(h, c, dtype=np.uint32) + chars[j : j + n]
    return mix32_np(h)


def window_hashes(chars: torch.Tensor, k: int) -> torch.Tensor:
    """int64[total] hash (0..2**32-1) of the k-byte window that starts at
    each position of the flat uint8 bytes ``chars``, on their device:
    ``fmix32(sum_j C**(k-1-j) * chars[i+j])`` mod 2**32. Bytes past the end
    read as 0; a window that crosses from one text into the next is never
    read by :func:`shingle_signatures_ragged`."""
    n = chars.shape[0]
    c = torch.nn.functional.pad(chars.to(torch.int64), (0, k - 1))
    h = torch.zeros(n, dtype=torch.int64, device=chars.device)
    for j in range(k):
        h = (h * _POLY_C + c[j : j + n]) & _LOW32
    return mix32(h)


def shingle_signatures_ragged(flat_bytes: torch.Tensor, text_lengths: torch.Tensor,
                              k: int, seed: int, num_perm: int,
                              permutations=None) -> torch.Tensor:
    """MinHash signatures of every text's k-shingle set, from raw bytes.

    Args:
        flat_bytes: uint8[total] all texts' bytes back to back, on the
            target device.
        text_lengths: int[B] bytes per text (any device).
        k: shingle width in bytes.
        permutations: optional explicit (a, b) uint64 arrays.
    Returns:
        int32[B, num_perm] (uint32 bits) on ``flat_bytes``' device (kernel
        1 on a card); texts shorter than ``k`` give the empty-sketch row
        (all MAX_HASH), as ``MinHash()`` of an empty set.
    """
    dev = flat_bytes.device
    lengths = text_lengths.to(device=dev, dtype=torch.int64)
    starts = torch.zeros_like(lengths)
    if lengths.shape[0] > 1:
        starts[1:] = torch.cumsum(lengths[:-1], dim=0)
    windows = (lengths - (k - 1)).clamp_min(0).to(torch.int32)
    if flat_bytes.numel():
        flat = u32_to_i32(window_hashes(flat_bytes, k))
    else:
        flat = torch.zeros(1, dtype=torch.int32, device=dev)
    a, b = perm_tensors(seed, num_perm, dev, permutations)
    return minhash_sign.minhash_sign(flat, starts, windows, a, b)
