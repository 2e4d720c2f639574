"""Kernel 1 wrapper: MinHash signatures from flat ragged tokens.

CUDA source: ``datasketch_tpu_torch/csrc/minhash_sign.cu`` (replaces
``datasketch_tpu/ops/pallas_kernels.py::_sign_kernel``). The wrapper takes
the plain PyTorch version only for CPU tensors; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from datasketch_tpu_torch.device import u32_bits, u32_to_i32
from datasketch_tpu_torch.kernels import build
from datasketch_tpu_torch.ops.hashing import MAX_HASH, mix32, permute_hash
from datasketch_tpu_torch.utils.profiling import span

__all__ = ["minhash_sign", "minhash_sign_plain", "launches"]

launches = 0  # kernel launches (not plain-version calls)

# [rows, T, P] int64 temporaries of the plain version stay under this many
# elements per step
_PLAIN_ELEMS = 1 << 23


def minhash_sign_plain(flat, starts, lengths, a, b, mix: bool = False):
    """Plain PyTorch twin of the kernel (same arguments, same result)."""
    n_docs, p = lengths.shape[0], a.shape[0]
    out = torch.full((n_docs, p), MAX_HASH, dtype=torch.int64, device=flat.device)
    t = int(lengths.max()) if n_docs else 0
    if t:
        col = torch.arange(t, device=flat.device)
        step = max(1, _PLAIN_ELEMS // (t * p))
        for r0 in range(0, n_docs, step):
            r1 = min(n_docs, r0 + step)
            valid = col[None, :] < lengths[r0:r1, None]
            idx = torch.where(valid, starts[r0:r1, None] + col[None, :], 0)
            h = u32_bits(flat[idx])
            if mix:
                h = mix32(h)
            phv = permute_hash(h[..., None], a, b)  # [rows, T, P]
            phv = torch.where(valid[..., None], phv, MAX_HASH)
            out[r0:r1] = phv.amin(dim=1)
    return u32_to_i32(out)


def minhash_sign(flat, starts, lengths, a, b, mix: bool = False):
    """Signatures int32[B, P] (uint32 bits) of B docs in a flat buffer.

    Args:
        flat: int32[total] token hashes (or raw ids with ``mix``), uint32 bits.
        starts: int64[B] offset of each doc in ``flat``.
        lengths: int32[B] tokens per doc (0 gives an all-MAX_HASH row).
        a, b: int64[P] permutation parameters (< 2**61).
        mix: apply fmix32 to each token first (raw token ids).
    """
    with span("dstt.kernel.minhash_sign"):
        if flat.device.type == "cpu":
            return minhash_sign_plain(flat, starts, lengths, a, b, mix)
        build.require_cuda("minhash_sign", flat, starts, lengths, a, b)
        if flat.dtype != torch.int32 or starts.dtype != torch.int64 or (
            lengths.dtype != torch.int32
            or a.dtype != torch.int64
            or b.dtype != torch.int64
        ):
            raise TypeError("minhash_sign: want int32 flat/lengths, int64 starts/a/b")
        n_docs, p = lengths.shape[0], a.shape[0]
        out = torch.empty((n_docs, p), dtype=torch.int32, device=flat.device)
        global launches
        launches += 1
        err = build.library().ds_minhash_sign(
            flat.data_ptr(), starts.data_ptr(), lengths.data_ptr(), a.data_ptr(),
            b.data_ptr(), n_docs, p, int(mix), out.data_ptr(), build.stream_ptr(flat),
        )
        build.check(err, "ds_minhash_sign")
        return out
