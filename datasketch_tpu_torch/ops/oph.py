"""One-permutation hashing with densification (DOPH): a MinHash scheme.

Port of ``datasketch_tpu/ops/oph.py``. Each token is hashed once; the hash
range is split into ``num_perm`` bins, each bin keeps its least value, and
empty bins borrow from the nearest non-empty bin to their left (circulant
densification, Shrivastava & Li 2014), salted by their bin index. The
signatures estimate Jaccard like the permutation scheme's but are not
value-compatible with it. Plain torch ops on int64 holding uint32 values;
the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import torch

from datasketch_tpu_torch.device import u32_to_i32, u32_values
from datasketch_tpu_torch.ops.hashing import MAX_HASH, mix32

__all__ = ["oph_signatures"]

_LOW32 = 0xFFFFFFFF


def _mix(h: torch.Tensor, salt: int) -> torch.Tensor:
    """fmix32 of ``h ^ salt`` (a uniform rehash)."""
    return mix32(h ^ (salt & _LOW32))


def oph_signatures(hashes: torch.Tensor, lengths: torch.Tensor, num_perm: int,
                   seed: int = 1) -> torch.Tensor:
    """DOPH signatures of a padded token batch, on ``hashes``' device.

    Args:
        hashes: [B, T] uint32 token hashes (int32 bit patterns, int64 or
            narrower unsigned); slots at or past ``lengths`` are ignored.
        lengths: int[B].
        num_perm: number of bins, 1 <= num_perm < 2**31 (the bin index
            ``(h * num_perm) >> 32`` is one exact int64 product).
    Returns:
        int32[B, num_perm] (uint32 bits); an empty document gives an
        all-MAX_HASH row.
    """
    if not 1 <= num_perm < (1 << 31):
        raise ValueError("oph needs 1 <= num_perm < 2**31, got %d" % num_perm)
    b, t = hashes.shape
    dev = hashes.device
    h = _mix(u32_values(hashes), 0x9E3779B1 ^ (int(seed) * 0x45D9F3B))
    mask = torch.arange(t, device=dev)[None, :] < lengths.to(device=dev, dtype=torch.int64)[:, None]
    bins = torch.where(mask, (h * num_perm) >> 32, 0)  # floor(h * k / 2**32) in [0, k)
    # a second, independent mix decorrelates the bin from the stored value
    vals = torch.where(mask, _mix(h, 0x27D4EB2F ^ int(seed)), MAX_HASH)
    state = torch.full((b, num_perm), MAX_HASH, dtype=torch.int64, device=dev)
    state.scatter_reduce_(1, bins, vals, "amin")

    # circulant densification: each empty bin takes the nearest non-empty
    # bin to its left, found by log2(num_perm) doubling steps
    empty = state == MAX_HASH
    filled = state
    shift = 1
    while shift < num_perm:
        cand = torch.roll(filled, shift, dims=1)
        cand_empty = torch.roll(empty, shift, dims=1)
        filled = torch.where(empty & ~cand_empty, cand, filled)
        empty = empty & cand_empty
        shift *= 2
    # borrowed values are salted by their bin index, so two documents that
    # share one token do not agree on every empty bin
    col = torch.arange(num_perm, dtype=torch.int64, device=dev)
    was_empty = (state == MAX_HASH) & ~empty
    densified = (_mix(filled, 0x165667B1) + col * 0x9E3779B9) & _LOW32
    out = torch.where(was_empty, densified, filled)
    return u32_to_i32(torch.where(empty, MAX_HASH, out))  # empty documents stay MAX_HASH
