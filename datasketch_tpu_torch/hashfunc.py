"""Token hash functions of the port.

``sha1_hash32`` is the reference default (SHA1, low 32 bits,
little-endian): bulk paths hash with the native batch hasher
(:mod:`datasketch_tpu_torch.native`), bit-identical to it, as they do for
``xxhash_hash32`` (XXH32, seed 0). ``device_hash`` marks pre-tokenized
integer corpora: the bulk paths then upload the raw ids and apply fmix32
on the card, fused into the signature kernel; the callable itself is the
host twin of that mix. ``device_hash64`` is its 64-bit sibling.
Ported from ``datasketch_tpu/hashfunc.py``.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

__all__ = [
    "sha1_hash32",
    "sha1_hash64",
    "batch_sha1_hash32",
    "batch_sha1_hash64",
    "device_hash",
    "device_hash64",
    "xxhash_hash32",
]


def sha1_hash32(data: bytes) -> int:
    """A 32-bit hash of ``data``: the low 4 bytes of its SHA1, little-endian."""
    return struct.unpack("<I", hashlib.sha1(data).digest()[:4])[0]


def sha1_hash64(data: bytes) -> int:
    """A 64-bit hash of ``data``: the low 8 bytes of its SHA1, little-endian."""
    return struct.unpack("<Q", hashlib.sha1(data).digest()[:8])[0]


def batch_sha1_hash32(tokens) -> np.ndarray:
    """:func:`sha1_hash32` of every bytes token, uint32, in one native call."""
    from datasketch_tpu_torch import native

    return native.hash_flat(list(tokens), native.ALGO_SHA1_32)


def batch_sha1_hash64(tokens) -> np.ndarray:
    """:func:`sha1_hash64` of every bytes token, uint64, in one native call."""
    from datasketch_tpu_torch import native

    return native.hash_flat(list(tokens), native.ALGO_SHA1_64)


def xxhash_hash32(data: bytes) -> int:
    """XXH32 (seed 0) of ``data`` -- the canonical spec's value, so
    signatures interoperate with sketches hashed by the ``xxhash``
    package's ``xxh32_intdigest``. Pass ``hashfunc=xxhash_hash32`` (or
    ``"xxh32"``) to :class:`~datasketch_tpu_torch.models.minhash.MinHash`:
    the bulk paths then hash in the native batch hasher."""
    from datasketch_tpu_torch import native

    if isinstance(data, int):
        # bytes(int) would hash that many zero bytes; the SHA1 hashes raise
        raise TypeError("a bytes-like object is required, not 'int'")
    return int(native.hash_flat([bytes(data)], native.ALGO_XXH32)[0])


def device_hash(token_id) -> int:
    """Murmur3 fmix32 of an integer token id (the host twin of the mix that
    runs on the card when ``MinHash(hashfunc="device")``)."""
    from datasketch_tpu_torch.ops.hashing import mix32_np

    return int(mix32_np(int(token_id) & 0xFFFFFFFF))


def device_hash64(token_id) -> int:
    """64-bit token hash of an integer id: fmix32 rounds over its two
    32-bit limbs (:func:`datasketch_tpu_torch.ops.hashing.mix64_np`), equal
    to the JAX package's."""
    from datasketch_tpu_torch.ops.hashing import mix64_np

    return int(mix64_np(int(token_id) & 0xFFFFFFFFFFFFFFFF))
