"""Kernel 9 wrapper: ``sha1_hash32`` of bytes tokens packed back to back.

CUDA source: ``datasketch_tpu_torch/csrc/sha1.cu`` (replaces no TPU kernel:
the JAX package hashes SHA1 on the host). The card reads the packed bytes
and offsets in place from pinned host memory; only the hashes are written
to device memory. The output's device picks the route: a CPU ``out`` takes
the plain PyTorch version; a CUDA ``out`` launches the kernel or raises.
``launches`` counts launches on the card.
"""

from __future__ import annotations

import ctypes

import torch

from datasketch_tpu_torch.device import u32_to_i32
from datasketch_tpu_torch.kernels import build
from datasketch_tpu_torch.utils.profiling import span

__all__ = ["sha1_hash32", "sha1_hash32_plain", "launches"]

launches = 0

_MASK = 0xFFFFFFFF
_H0 = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
# [rows, 64 * blocks] int64 message temporaries of the plain version stay
# under this many elements per step
_PLAIN_ELEMS = 1 << 22


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _compress(h: list, w: list) -> list:
    """One SHA1 compression of the 16 words ``w`` (int64 [rows] each, 32-bit
    values) into the state ``h``."""
    a, b, c, d, e = h
    w = list(w)
    for t in range(80):
        if t >= 16:
            w[t % 16] = _rotl(w[(t + 13) % 16] ^ w[(t + 8) % 16] ^ w[(t + 2) % 16]
                              ^ w[t % 16], 1)
        if t < 20:
            f, k = (b & c) | (~b & d), 0x5A827999
        elif t < 40:
            f, k = b ^ c ^ d, 0x6ED9EBA1
        elif t < 60:
            f, k = (b & c) | (b & d) | (c & d), 0x8F1BBCDC
        else:
            f, k = b ^ c ^ d, 0xCA62C1D6
        tmp = (_rotl(a, 5) + f + e + k + w[t % 16]) & _MASK
        a, b, c, d, e = tmp, a, _rotl(b, 30), c, d
    return [(x + y) & _MASK for x, y in zip(h, (a, b, c, d, e))]


def sha1_hash32_plain(data: torch.Tensor, offsets: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: int32[n] (uint32 bits), token t's
    hash at t. Tokens are grouped by their number of 64-byte blocks, and
    each group is padded into big-endian message words and compressed block
    by block, all its tokens at once."""
    dev = data.device
    off = offsets[: n + 1].to(torch.int64)
    start, length = off[:-1], off[1:] - off[:-1]
    nblk = (length + 8) // 64 + 1
    src = data if data.numel() else torch.zeros(1, dtype=torch.uint8, device=dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    for nb in torch.unique(nblk).tolist():
        rows = torch.nonzero(nblk == nb).flatten()
        width = 64 * nb
        pos = torch.arange(width, device=dev)
        step = max(1, _PLAIN_ELEMS // width)
        for r0 in range(0, rows.numel(), step):
            ix = rows[r0: r0 + step]
            s, ln = start[ix, None], length[ix, None]
            inside = pos < ln
            msg = torch.where(inside, src[torch.where(inside, s + pos, 0)].to(torch.int64), 0)
            msg = torch.where(pos == ln, 0x80, msg).view(-1, width // 4, 4)
            words = (msg[..., 0] << 24) | (msg[..., 1] << 16) | (msg[..., 2] << 8) | msg[..., 3]
            bits = ln[:, 0] * 8
            words[:, -2] = bits >> 32
            words[:, -1] = bits & _MASK
            h = [torch.full((ix.numel(),), v, dtype=torch.int64, device=dev) for v in _H0]
            for blk in range(nb):
                h = _compress(h, words[:, 16 * blk: 16 * blk + 16].unbind(1))
            h0 = h[0]  # its bytes, big-endian, are the digest's first four
            out[ix] = (((h0 & 0xFF) << 24) | ((h0 & 0xFF00) << 8) | ((h0 >> 8) & 0xFF00)
                       | (h0 >> 24))
    return u32_to_i32(out)


def _mapped(t: torch.Tensor) -> int:
    """The device pointer of a pinned host tensor's memory."""
    ptr = ctypes.c_void_p()
    build.check(build.library().ds_host_device_ptr(t.data_ptr(), ctypes.byref(ptr)),
                "cudaHostGetDevicePointer")
    return ptr.value


def sha1_hash32(data: torch.Tensor, offsets: torch.Tensor, n: int,
                out: torch.Tensor) -> torch.Tensor:
    """``sha1_hash32`` of n tokens packed back to back, into ``out``.

    Args:
        data: uint8 tokens back to back: a pinned host tensor, 16-byte
            aligned, read in place by the card, for a CUDA ``out``.
        offsets: int32, at least n + 1 entries: token t is
            ``data[offsets[t]:offsets[t + 1]]``; pinned for a CUDA ``out``.
        n: tokens to hash.
        out: int32[n] (uint32 bits), on the card or the CPU.

    Returns ``out``. On the card the kernel reads ``data`` and ``offsets``
    after this returns: they must not be written or freed until the
    stream has passed the launch (an event recorded after it).
    """
    with span("dstt.kernel.sha1"):
        if out.device.type == "cpu":
            return out.copy_(sha1_hash32_plain(data, offsets, n))
        build.require_cuda("sha1_hash32", out)
        if data.dtype != torch.uint8 or offsets.dtype != torch.int32 or out.dtype != torch.int32:
            raise TypeError("sha1_hash32: want uint8 data, int32 offsets and out")
        if not (data.is_pinned() and offsets.is_pinned() and data.is_contiguous()
                and offsets.is_contiguous()):
            raise ValueError("sha1_hash32: data and offsets must be contiguous pinned "
                             "host tensors")
        if offsets.numel() < n + 1 or out.numel() != n or data.data_ptr() % 16:
            raise ValueError("sha1_hash32: want n + 1 offsets, n outputs and 16-byte "
                             "aligned data")
        if n == 0:
            return out
        global launches
        launches += 1
        err = build.library().ds_sha1_hash32(
            _mapped(data), data.numel(), _mapped(offsets), n, out.data_ptr(),
            build.stream_ptr(out),
        )
        build.check(err, "ds_sha1_hash32")
        return out
