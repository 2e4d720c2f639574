"""MinHash bulk signatures on the card.

Port of ``MinHash.bulk_signatures`` from ``datasketch_tpu/models/
minhash.py`` for ``scheme="permutation"``: a corpus becomes one
int32[N, num_perm] tensor of uint32 bit patterns, bit-identical to the JAX
package (and the reference) at equal ``(seed, num_perm, hashfunc)``.
The per-object API (``update``, ``jaccard``, ...) is not ported yet.

Two token paths, as in the JAX package:

- ``hashfunc=sha1_hash32`` (default): bytes tokens are hashed on the host
  by the native SHA1 batch hasher straight into a pinned buffer, which is
  uploaded with a ``non_blocking`` copy; the host hashes chunk i+1 while
  the card signs chunk i.
- ``hashfunc="device"``: integer token ids are uploaded raw (as uint8 or
  uint16 when they fit) and mixed with fmix32 inside kernel 1.

Raw text takes the same two engines: SHA1 of every shingle in the native
module on the host, or the raw bytes uploaded and the shingles hashed on
the card (``hashfunc="device"``, :mod:`datasketch_tpu_torch.ops.text_ops`).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from datasketch_tpu_torch import native
from datasketch_tpu_torch.device import resolve_device, to_numpy_u32
from datasketch_tpu_torch.hashfunc import device_hash, sha1_hash32
from datasketch_tpu_torch.ops import minhash_ops, text_ops

__all__ = ["MinHash"]

# Padded-token budget per chunk (B_pow2 * T_pow2), as in the JAX package:
# length-sorted chunks bound the plain version's memory and keep each
# upload a few MB.
_TOKEN_BUDGET = 1 << 21


def pow2_at_least(x: int, floor: int = 128) -> int:
    """The least power of two >= x, starting from ``floor``."""
    p = floor
    while p < x:
        p *= 2
    return p


def _budget_chunks(sorted_lengths, budget: int = _TOKEN_BUDGET):
    """Cut a length-sorted corpus into (start, end) ranges whose padded
    [B_pow2, T_pow2] area stays within ``budget`` tokens."""
    chunks = []
    n = len(sorted_lengths)
    i = 0
    while i < n:
        t = pow2_at_least(int(sorted_lengths[i]))
        j = i + 1
        while j < n:
            t_next = pow2_at_least(int(sorted_lengths[j]), t)
            b_next = pow2_at_least(j - i + 1)
            if b_next * t_next > budget:
                break
            t = t_next
            j += 1
        chunks.append((i, j))
        i = j
    return chunks


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``dev``; CUDA uploads go through pinned
    memory with a ``non_blocking`` copy."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _id_tokens(chunk) -> np.ndarray:
    """Raw integer ids of a chunk, flat, in the narrowest unsigned dtype
    the JAX package would ship (uint8/uint16 zero-extend on the card)."""
    arrays = [np.asarray(d) for d in chunk]
    if arrays and all(a.dtype in (np.uint8, np.uint16) for a in arrays):
        tgt = np.uint8 if all(a.dtype == np.uint8 for a in arrays) else np.uint16
        return np.concatenate([a.astype(tgt, copy=False) for a in arrays])
    flat = (
        np.concatenate([a.astype(np.uint32) for a in arrays])
        if arrays
        else np.zeros(0, dtype=np.uint32)
    )
    if flat.size and int(flat.max()) < (1 << 16):
        flat = flat.astype(np.uint16)
    return flat


def _sha1_tokens(chunk, dev: torch.device) -> torch.Tensor:
    """SHA1-low-32 of a chunk's bytes tokens, flat, on ``dev``: hashed
    straight into pinned memory when ``dev`` is a card."""
    chunk = [d if isinstance(d, list) else list(d) for d in chunk]
    total = sum(map(len, chunk))
    buf = torch.empty(
        max(1, total), dtype=torch.int32, pin_memory=dev.type == "cuda"
    )
    native.hash_ragged(chunk, out=buf.numpy().view(np.uint32))
    buf = buf[:total]
    return buf.to(dev, non_blocking=True) if dev.type == "cuda" else buf


def _sha1_shingles(chunk, k: int, width: int, dev: torch.device):
    """SHA1-low-32 of a chunk's k-byte shingles, padded [B, width] on
    ``dev`` (``width`` >= every text's shingle count), and the shingle
    counts int32[B]: hashed straight into pinned memory when ``dev`` is a
    card."""
    width = max(1, width)
    buf = torch.empty(
        max(1, len(chunk) * width), dtype=torch.int32, pin_memory=dev.type == "cuda"
    )
    host, lengths = native.hash_shingles_padded(chunk, k, out=buf.numpy().view(np.uint32))
    hashes = buf[: host.size].view(host.shape)
    return (hashes.to(dev, non_blocking=True) if dev.type == "cuda" else hashes), lengths


class MinHash:
    """MinHash parameters (and, in a later port, the per-object sketch).

    Args:
        num_perm: number of permutation functions.
        seed: seed of the permutation family; sketches compare only at
            equal seeds.
        hashfunc: ``sha1_hash32`` (default) or ``device_hash`` / the
            string ``"device"`` for pre-tokenized integer corpora.
        permutations: optional explicit (a, b) uint64 arrays.
    """

    def __init__(self, num_perm: int = 128, seed: int = 1,
                 hashfunc=sha1_hash32, permutations=None) -> None:
        if hashfunc == "device":
            hashfunc = device_hash
        if hashfunc not in (sha1_hash32, device_hash):
            raise ValueError(
                "the port hashes with sha1_hash32 or 'device' only, got %r"
                % (hashfunc,)
            )
        self.num_perm = num_perm
        self.seed = seed
        self.hashfunc = hashfunc
        if permutations is None:
            permutations = minhash_ops.init_permutations(seed, num_perm)
        if len(permutations[0]) != num_perm:
            raise ValueError("Numbers of hash values and permutations mismatch")
        self.permutations = permutations

    def _custom_permutations(self):
        """This sketch's (a, b) iff they differ from the seed-derived family."""
        default = minhash_ops.init_permutations(self.seed, self.num_perm)
        if self.permutations is default:
            return None
        a, b = self.permutations
        if np.array_equal(a, default[0]) and np.array_equal(b, default[1]):
            return None
        return self.permutations

    @classmethod
    def bulk_signatures(cls, b: Iterable, scheme: str = "permutation",
                        out: str = "host", device="cuda", **minhash_kwargs):
        """Signature matrix of a corpus: uint32[N, num_perm], input order.

        Args:
            b: documents -- lists of bytes tokens (SHA1 path) or integer
                token-id arrays (``hashfunc="device"``).
            scheme: only ``"permutation"`` is ported.
            out: ``"host"`` returns ``np.ndarray`` uint32; ``"device"``
                returns the int32 (uint32 bits) tensor on ``device``
                without a copy back.
            device: ``"cuda"`` (default) runs kernel 1; ``"cpu"`` runs its
                plain PyTorch twin. No silent fallback.
            **minhash_kwargs: ``num_perm``, ``seed``, ``hashfunc``,
                ``permutations`` as for :class:`MinHash`.
        """
        if out not in ("host", "device"):
            raise ValueError("out must be 'host' or 'device'")
        if scheme != "permutation":
            raise ValueError("only scheme='permutation' is ported, got %r" % (scheme,))
        dev = resolve_device(device)
        proto = cls(**minhash_kwargs)
        docs = b if isinstance(b, list) else list(b)
        docs = [d if hasattr(d, "__len__") else list(d) for d in docs]
        n, p = len(docs), proto.num_perm
        result = torch.empty((n, p), dtype=torch.int32, device=dev)
        perms = proto._custom_permutations()
        use_ids = proto.hashfunc is device_hash
        order = sorted(range(n), key=lambda i: len(docs[i]))
        for start, stop in _budget_chunks([len(docs[i]) for i in order]):
            idx = order[start:stop]
            chunk = [docs[i] for i in idx]
            lengths = np.fromiter(map(len, chunk), np.int32, count=len(chunk))
            if use_ids:
                flat = _upload(_id_tokens(chunk), dev)
            else:
                flat = _sha1_tokens(chunk, dev)
            sigs = minhash_ops.compute_signatures_ragged(
                flat, _upload(lengths, dev), proto.seed, p,
                permutations=perms, mix=use_ids,
            )
            result[_upload(np.asarray(idx, dtype=np.int64), dev)] = sigs
        return result if out == "device" else to_numpy_u32(result)

    @classmethod
    def bulk_from_text(cls, texts: Iterable, k: int = 9, scheme: str = "permutation",
                       out: str = "host", device="cuda", **minhash_kwargs):
        """Signature matrix of raw byte strings' k-shingle sets, input order.

        Two engines, picked by ``hashfunc``:

        - ``sha1_hash32`` (default): every overlapping k-byte shingle is
          hashed in C straight out of the text (the native module), then
          kernel 1 signs the padded batch. Equal to the reference's values.
        - ``"device"``: the raw text is uploaded and the shingles are
          hashed on the card (polynomial window roll + fmix32), then
          kernel 1 signs them in place. Not value-compatible with the SHA1
          engine (the same estimator statistics).

        Args:
            texts: bytes or str (encoded as UTF-8) documents.
            k: shingle width in bytes.
            scheme: only ``"permutation"`` is ported.
            out: ``"host"`` (uint32 numpy) or ``"device"`` (int32 tensor
                on ``device``).
            device: ``"cuda"`` (default) or ``"cpu"`` (plain versions).
            **minhash_kwargs: as for :class:`MinHash`.

        Returns uint32[N, num_perm]; a text shorter than k gives the
        empty-sketch row (all MAX_HASH). Equal to hashing
        ``[text[i:i+k] for i in range(len(text)-k+1)]`` per text.
        """
        if out not in ("host", "device"):
            raise ValueError("out must be 'host' or 'device'")
        if scheme != "permutation":
            raise ValueError("only scheme='permutation' is ported, got %r" % (scheme,))
        if k <= 0:
            raise ValueError("k must be positive")
        dev = resolve_device(device)
        proto = cls(**minhash_kwargs)
        texts = texts if isinstance(texts, list) else list(texts)
        texts = [t.encode("utf-8") if isinstance(t, str) else t for t in texts]
        n, p = len(texts), proto.num_perm
        result = torch.empty((n, p), dtype=torch.int32, device=dev)
        perms = proto._custom_permutations()
        order = sorted(range(n), key=lambda i: len(texts[i]))
        counts = [max(0, len(texts[i]) - k + 1) for i in order]
        for start, stop in _budget_chunks(counts):
            idx = order[start:stop]
            chunk = [texts[i] for i in idx]
            if proto.hashfunc is device_hash:
                lengths = np.fromiter(map(len, chunk), np.int32, count=len(chunk))
                flat = np.frombuffer(bytearray().join(chunk), dtype=np.uint8)
                sigs = text_ops.shingle_signatures_ragged(
                    _upload(flat, dev), _upload(lengths, dev), k, proto.seed, p,
                    permutations=perms,
                )
            else:
                hashes, lengths = _sha1_shingles(chunk, k, counts[stop - 1], dev)
                sigs = minhash_ops.compute_signatures(
                    hashes, _upload(lengths, dev), proto.seed, p, permutations=perms,
                )
            result[_upload(np.asarray(idx, dtype=np.int64), dev)] = sigs
        return result if out == "device" else to_numpy_u32(result)
