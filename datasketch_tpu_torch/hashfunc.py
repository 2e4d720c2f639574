"""Token hash functions of the port.

``sha1_hash32`` is the reference default (SHA1, low 32 bits,
little-endian): bulk paths hash with the native batch hasher
(:mod:`datasketch_tpu_torch.native`), bit-identical to it.
``device_hash`` marks pre-tokenized integer corpora: the bulk paths then
upload the raw ids and apply fmix32 on the card, fused into the signature
kernel; the callable itself is the host twin of that mix.
Ported from ``datasketch_tpu/hashfunc.py``.
"""

from __future__ import annotations

import hashlib
import struct

__all__ = ["sha1_hash32", "device_hash"]

_LOW32 = 0xFFFFFFFF


def sha1_hash32(data: bytes) -> int:
    """A 32-bit hash of ``data``: the low 4 bytes of its SHA1, little-endian."""
    return struct.unpack("<I", hashlib.sha1(data).digest()[:4])[0]


def device_hash(token_id) -> int:
    """Murmur3 fmix32 of an integer token id (the host twin of the mix that
    runs on the card when ``MinHash(hashfunc="device")``)."""
    x = int(token_id) & _LOW32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _LOW32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _LOW32
    return x ^ (x >> 16)
