"""C-MinHash: one circulant permutation in place of num_perm of them.

Port of ``datasketch_tpu/ops/cminhash.py`` (Li & Li, arXiv:2109.03337 and
arXiv:2109.04595): ``sig_k = min over tokens of pi((sigma(h) + k) mod
2**32)``, with sigma and pi seeded fmix32 bijections. The signatures are
not value-compatible with the permutation scheme's. Plain torch ops on
int64 holding uint32 values; the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import torch

from datasketch_tpu_torch.device import u32_to_i32, u32_values
from datasketch_tpu_torch.ops.hashing import MAX_HASH, mix32

__all__ = ["cminhash_signatures"]

_LOW32 = 0xFFFFFFFF

# Tokens folded per step: the [B, TILE, num_perm] working set of one step
# is the largest tensor built (the whole [B, T, num_perm] would be
# gigabytes at a 2**21-token chunk).
TILE = 32


def cminhash_signatures(hashes: torch.Tensor, lengths: torch.Tensor, num_perm: int,
                        seed: int = 1) -> torch.Tensor:
    """C-MinHash signatures of a padded token batch, on ``hashes``' device.

    Args:
        hashes: [B, T] uint32 token hashes (int32 bit patterns, int64 or
            narrower unsigned); slots at or past ``lengths`` are ignored.
        lengths: int[B].
        num_perm: number of circular shifts K (any positive int).
    Returns:
        int32[B, num_perm] (uint32 bits); an empty document gives an
        all-MAX_HASH row.
    """
    salt_sigma = (0x9E3779B1 ^ (int(seed) * 0x45D9F3B)) & _LOW32
    salt_pi = (0x7F4A7C15 ^ (int(seed) * 0x2545F491)) & _LOW32
    b, t = hashes.shape
    dev = hashes.device
    sigma = mix32(u32_values(hashes) ^ salt_sigma)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    k = torch.arange(num_perm, dtype=torch.int64, device=dev)
    out = torch.full((b, num_perm), MAX_HASH, dtype=torch.int64, device=dev)
    for t0 in range(0, t, TILE):
        tile = sigma[:, t0: t0 + TILE]
        mask = (t0 + torch.arange(tile.shape[1], device=dev))[None, :] < lengths[:, None]
        vals = mix32(((tile[..., None] + k) & _LOW32) ^ salt_pi)  # [B, tile, K]
        vals = torch.where(mask[..., None], vals, MAX_HASH)
        out = torch.minimum(out, vals.amin(dim=1))
    return u32_to_i32(out)
