"""Functional MinHash core: a batch of sketches is one int32[B, P] tensor
of uint32 bit patterns.

Port of ``datasketch_tpu/ops/minhash_ops.py``. ``init_permutations`` is the
same numpy draw (bit-identical (a, b) at equal seed); signatures come from
kernel 1 (:mod:`datasketch_tpu_torch.kernels.minhash_sign`), which reads
the flat ragged token buffer directly -- no padded [B, T] matrix is built
on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from datasketch_tpu_torch.device import counts_to_scores, u32_bits, u32_to_i32
from datasketch_tpu_torch.kernels import minhash_sign, score
from datasketch_tpu_torch.ops.hashing import MAX_HASH, MERSENNE_PRIME
from datasketch_tpu_torch.utils.profiling import span

__all__ = [
    "MERSENNE_PRIME",
    "MAX_HASH",
    "init_permutations",
    "perm_tensors",
    "empty_signatures",
    "compute_signatures",
    "compute_signatures_ragged",
    "jaccard_pairwise",
    "jaccard_matrix",
    "merge_signatures",
    "pad_token_hashes",
]


@functools.lru_cache(maxsize=64)
def init_permutations(seed: int, num_perm: int):
    """(a, b) universal-hash parameters as numpy uint64[num_perm].

    The interleaved draw of ``datasketch_tpu.ops.minhash_ops.
    init_permutations`` (a_i then b_i from one ``RandomState(seed)``), so
    signatures match the JAX package and the reference at equal seed.
    """
    gen = np.random.RandomState(seed)
    params = np.array(
        [
            (
                gen.randint(1, MERSENNE_PRIME, dtype=np.uint64),
                gen.randint(0, MERSENNE_PRIME, dtype=np.uint64),
            )
            for _ in range(num_perm)
        ],
        dtype=np.uint64,
    ).T
    a, b = params[0], params[1]
    a.setflags(write=False)
    b.setflags(write=False)
    return a, b


def empty_signatures(batch: int, num_perm: int, device="cuda") -> torch.Tensor:
    """Initial sketch state on ``device``: every slot MAX_HASH, as an
    int32[batch, num_perm] tensor of uint32 bits."""
    return torch.full((batch, num_perm), MAX_HASH - (1 << 32), dtype=torch.int32,
                      device=device)


def pad_token_hashes(hash_arrays, pad_multiple: int = 128):
    """Host helper: ragged list of uint32 token-hash arrays -> padded batch.

    Returns (hashes uint32[B, T], lengths int32[B]) with T padded up to a
    multiple of ``pad_multiple`` (the JAX package's padded layout; the
    port's signers read the flat ragged buffer instead).
    """
    lengths = np.array([len(h) for h in hash_arrays], dtype=np.int32)
    max_len = max(1, int(lengths.max()) if len(lengths) else 1)
    t = ((max_len + pad_multiple - 1) // pad_multiple) * pad_multiple
    out = np.zeros((len(hash_arrays), t), dtype=np.uint32)
    for i, h in enumerate(hash_arrays):
        out[i, : len(h)] = h
    return out, lengths


def _as_tensors(permutations, device):
    return tuple(
        torch.from_numpy(np.asarray(x, dtype=np.uint64).astype(np.int64)).to(device)
        for x in permutations
    )


@functools.lru_cache(maxsize=64)
def _seed_perm_tensors(seed: int, num_perm: int, device: torch.device):
    return _as_tensors(init_permutations(seed, num_perm), device)


def perm_tensors(seed: int, num_perm: int, device, permutations=None):
    """(a, b) as int64[P] tensors on ``device`` (all values < 2**61); the
    seed-derived family is uploaded once per device."""
    if permutations is not None:
        return _as_tensors(permutations, device)
    return _seed_perm_tensors(seed, num_perm, torch.device(device))


def _widen_u32(flat: torch.Tensor) -> torch.Tensor:
    """Token tensor -> int32 uint32 bits, on its own device: uint8/uint16
    zero-extend (narrow id uploads), int32/uint32 are taken as bit
    patterns."""
    if flat.dtype == torch.int32:
        return flat
    if flat.dtype == torch.uint32:
        return flat.view(torch.int32)
    if flat.dtype == torch.uint8:
        return flat.to(torch.int32)
    if flat.dtype == torch.uint16:
        return flat.view(torch.int16).to(torch.int32) & 0xFFFF
    raise TypeError("unsupported token dtype %s" % flat.dtype)


def compute_signatures_ragged(flat: torch.Tensor, lengths: torch.Tensor,
                              seed: int, num_perm: int, permutations=None,
                              mix: bool = False) -> torch.Tensor:
    """Fresh signatures from flat concatenated token hashes.

    Args:
        flat: [total] tokens, all docs back to back, on the target device
            (uint8/uint16 raw ids are widened there).
        lengths: int32[B] tokens per doc, same device.
        permutations: optional explicit (a, b) uint64 arrays.
        mix: ``flat`` holds raw token ids; hash them on the card (fmix32).
    Returns:
        int32[B, num_perm] (uint32 bits) on ``flat``'s device.

    The ``dstt.glue.sign`` span covers the offsets, the widening and the
    kernel's ``dstt.kernel.minhash_sign``.
    """
    with span("dstt.glue.sign"):
        dev = flat.device
        lengths = lengths.to(device=dev, dtype=torch.int32)
        starts = torch.zeros(lengths.shape[0], dtype=torch.int64, device=dev)
        if lengths.shape[0] > 1:
            starts[1:] = torch.cumsum(lengths[:-1], dim=0)
        a, b = perm_tensors(seed, num_perm, dev, permutations)
        flat = _widen_u32(flat).contiguous()
        if flat.numel() == 0:
            flat = torch.zeros(1, dtype=torch.int32, device=dev)
        return minhash_sign.minhash_sign(flat, starts, lengths.contiguous(), a, b, mix)


def compute_signatures(hashes: torch.Tensor, lengths: torch.Tensor, seed: int,
                       num_perm: int, permutations=None,
                       mix: bool = False) -> torch.Tensor:
    """Fresh signatures for a padded [B, T] batch (tokens >= lengths are
    ignored): the ragged kernel over the rows laid end to end."""
    n, t = hashes.shape
    dev = hashes.device
    starts = torch.arange(n, dtype=torch.int64, device=dev) * t
    a, b = perm_tensors(seed, num_perm, dev, permutations)
    flat = _widen_u32(hashes.reshape(-1)).contiguous()
    if flat.numel() == 0:
        flat = torch.zeros(1, dtype=torch.int32, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int32).clamp(0, t).contiguous()
    return minhash_sign.minhash_sign(flat, starts, lengths, a, b, mix)


def jaccard_pairwise(sig_a: torch.Tensor, sig_b: torch.Tensor) -> torch.Tensor:
    """Rowwise Jaccard estimate between two [B, P] batches, f32[B]."""
    return counts_to_scores((sig_a == sig_b).sum(dim=-1), sig_a.shape[-1])


def jaccard_matrix(sig_q: torch.Tensor, sig_d: torch.Tensor) -> torch.Tensor:
    """All-pairs Jaccard estimates f32[Q, D] (kernel 4)."""
    return score.score_matrix(sig_q.contiguous(), sig_d.contiguous())


def merge_signatures(sig_a: torch.Tensor, sig_b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned min (union semantics)."""
    return u32_to_i32(torch.minimum(u32_bits(sig_a), u32_bits(sig_b)))
