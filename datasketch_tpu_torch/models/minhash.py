"""MinHash: the per-object sketch, and bulk signatures on the card.

Port of ``datasketch_tpu/models/minhash.py``. The object API (``update``,
``update_batch``, ``jaccard``, ``merge``, ``union``, ``bulk``,
``generator``, pickling) keeps its state as a host
uint64 array, equal to the JAX package's and the reference's at equal
``(seed, num_perm, hashfunc)``; ``update_batch`` of many tokens (and
``bulk``) sign on the card through kernel 1. The bulk classmethods turn a
corpus into one int32[N, num_perm] tensor of uint32 bit patterns.

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

The bulk paths also take ``scheme="oph"`` (:mod:`datasketch_tpu_torch.ops.
oph`) and ``scheme="cminhash"`` (:mod:`datasketch_tpu_torch.ops.cminhash`):
tokens are hashed on the host, then the scheme runs on the device. Their
signatures are not value-compatible with the permutation scheme's.
"""

from __future__ import annotations

import copy
import warnings
from typing import Iterable

import numpy as np
import torch

from datasketch_tpu_torch import native
from datasketch_tpu_torch.device import as_sig_tensor, resolve_device, to_numpy_u32
from datasketch_tpu_torch.hashfunc import device_hash, sha1_hash32, xxhash_hash32
from datasketch_tpu_torch.ops import cminhash, minhash_ops, oph, text_ops
from datasketch_tpu_torch.ops.hashing import mix32_np

__all__ = ["MinHash"]

_MERSENNE = np.uint64(minhash_ops.MERSENNE_PRIME)
_MAX_HASH = np.uint64(minhash_ops.MAX_HASH)
_HASH_RANGE = 1 << 32

# Below this many tokens update_batch (and a bulk chunk) stays on the host.
_DEVICE_BATCH_THRESHOLD = 4096

# Tokens that the native module hashes, by hashfunc.
_NATIVE_ALGO = {sha1_hash32: native.ALGO_SHA1_32, xxhash_hash32: native.ALGO_XXH32}

# Padded-token budget per chunk (B_pow2 * T_pow2), as in the JAX package:
# length-sorted chunks bound the plain version's memory and keep each
# upload a few MB.
_TOKEN_BUDGET = 1 << 21


_SCHEMES = ("permutation", "oph", "cminhash")


def _alt_scheme_signatures(scheme: str, padded: torch.Tensor, lengths: torch.Tensor,
                           num_perm: int, seed: int) -> torch.Tensor:
    """Signatures of a padded [B, T] hash batch by a non-default scheme."""
    if scheme == "oph":
        return oph.oph_signatures(padded, lengths, num_perm, seed=seed)
    return cminhash.cminhash_signatures(padded, lengths, num_perm, seed=seed)


def _check_scheme(scheme: str, custom_perms) -> None:
    if scheme not in _SCHEMES:
        raise ValueError("unknown signature scheme: %r" % (scheme,))
    if scheme != "permutation" and custom_perms is not None:
        raise ValueError("custom permutations are meaningless for scheme %r" % (scheme,))


def _pad_flat(flat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Docs' hashes back to back -> uint32[B, T], T the longest doc (at
    least 1), zero past each length."""
    t = max(1, int(lengths.max(initial=0)))
    padded = np.zeros((lengths.shape[0], t), dtype=np.uint32)
    padded[np.arange(t)[None, :] < lengths[:, None]] = flat
    return padded


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


def _native_tokens(chunk, algo: int, dev: torch.device) -> torch.Tensor:
    """Native hashes (``algo``) of a chunk's bytes tokens, flat, on
    ``dev``: hashed straight into pinned memory when ``dev`` is a card."""
    chunk = [d if isinstance(d, list) else list(d) for d in chunk]
    total = sum(map(len, chunk))
    buf = torch.empty(
        max(1, total), dtype=torch.int32, pin_memory=dev.type == "cuda"
    )
    native.hash_ragged(chunk, out=buf.numpy().view(np.uint32), algo=algo)
    buf = buf[:total]
    return buf.to(dev, non_blocking=True) if dev.type == "cuda" else buf


def _native_shingles(chunk, k: int, width: int, algo: int, dev: torch.device):
    """Native hashes (``algo``) of a chunk's k-byte shingles, padded [B,
    width] on ``dev`` (``width`` >= every text's shingle count), and the
    shingle counts int32[B]: hashed straight into pinned memory when
    ``dev`` is a card."""
    width = max(1, width)
    buf = torch.empty(
        max(1, len(chunk) * width), dtype=torch.int32, pin_memory=dev.type == "cuda"
    )
    host, lengths = native.hash_shingles_padded(
        chunk, k, out=buf.numpy().view(np.uint32), algo=algo
    )
    hashes = buf[: host.size].view(host.shape)
    return (hashes.to(dev, non_blocking=True) if dev.type == "cuda" else hashes), lengths


class MinHash:
    """A MinHash sketch: estimates the Jaccard similarity of token sets.

    Args:
        num_perm: number of permutation functions.
        seed: seed of the permutation family; sketches compare only at
            equal seeds.
        hashfunc: token hash: a callable that maps the value given to
            :meth:`update` to an int of 32 bits. ``sha1_hash32`` (default)
            and ``xxhash_hash32`` (``"xxh32"``) hash in the native batch
            hasher; ``device_hash`` (``"device"``) marks integer token ids,
            which the bulk paths mix on the card.
        hashobj: deprecated, ignored (the reference's old spelling).
        hashvalues: initial state (another sketch's); sets ``num_perm``.
        permutations: explicit (a, b) uint64 arrays instead of the
            seed-derived family.
        device_mode: ``"disable"`` | ``"auto"`` | ``"always"``: whether
            :meth:`update_batch` signs on ``device`` (``"auto"``: from
            4,096 tokens on). ``gpu_mode`` (``"disable"`` / ``"detect"`` /
            ``"always"``) is the reference's spelling of it.
        device: where that signing runs: ``"cuda"`` (default; raises
            without a card of capability >= 9.0) or ``"cpu"`` (the
            kernel's plain twin). Nothing else touches a device.
    """

    def __init__(self, num_perm: int = 128, seed: int = 1, hashfunc=sha1_hash32,
                 hashobj=None, hashvalues=None, permutations=None,
                 device_mode: str = "auto", gpu_mode=None, device="cuda") -> None:
        if hashvalues is not None:
            num_perm = len(hashvalues)
        if num_perm > _HASH_RANGE:
            raise ValueError(
                "Cannot have more than %d number of permutation functions" % _HASH_RANGE
            )
        self.seed = seed
        self.num_perm = num_perm
        if isinstance(hashfunc, str):
            hashfunc = {"device": device_hash, "xxh32": xxhash_hash32}.get(hashfunc, hashfunc)
        if not callable(hashfunc):
            raise ValueError("The hashfunc must be a callable.")
        self.hashfunc = hashfunc
        if hashobj is not None:
            warnings.warn("hashobj is deprecated, use hashfunc instead.",
                          DeprecationWarning, stacklevel=2)
        if gpu_mode is not None:
            modes = {"disable": "disable", "detect": "auto", "always": "always"}
            if gpu_mode not in modes:
                raise ValueError("gpu_mode must be 'disable', 'detect' or 'always'")
            device_mode = modes[gpu_mode]
        if device_mode not in ("disable", "auto", "always"):
            raise ValueError("device_mode must be 'disable', 'auto' or 'always'")
        self._device_mode = device_mode
        self.device = device
        if hashvalues is not None:
            self.hashvalues = self._parse_hashvalues(hashvalues)
        else:
            self.hashvalues = self._init_hashvalues(num_perm)
        if permutations is None:
            permutations = minhash_ops.init_permutations(seed, num_perm)
        self.permutations = permutations
        if len(self) != len(self.permutations[0]):
            raise ValueError("Numbers of hash values and permutations mismatch")

    @property
    def _gpu_mode(self) -> str:
        """``device_mode`` in the reference's ``gpu_mode`` spelling."""
        return {"disable": "disable", "auto": "detect", "always": "always"}[self._device_mode]

    def _custom_permutations(self):
        """This sketch's (a, b) iff they differ from the seed-derived family."""
        default = minhash_ops.init_permutations(self.seed, self.num_perm)
        if self.permutations is default:
            return None
        a, b = self.permutations
        if np.array_equal(a, default[0]) and np.array_equal(b, default[1]):
            return None
        return self.permutations

    def _init_hashvalues(self, num_perm: int) -> np.ndarray:
        return np.ones(num_perm, dtype=np.uint64) * _MAX_HASH

    def _parse_hashvalues(self, hashvalues) -> np.ndarray:
        return np.array(hashvalues, dtype=np.uint64)

    def _permuted_min(self, hv: np.ndarray) -> np.ndarray:
        """Min over tokens of ``((a*h + b) mod (2**61 - 1)) & 0xFFFFFFFF``,
        with numpy's uint64 wrap of ``a*h`` (the reference formula)."""
        a, bb = self.permutations
        phv = np.bitwise_and((hv.astype(np.uint64)[:, None] * a + bb) % _MERSENNE, _MAX_HASH)
        return phv.min(axis=0)

    def update(self, b) -> None:
        """Fold one value into the sketch (hashed with ``hashfunc``)."""
        hv = self.hashfunc(b)
        a, bb = self.permutations
        phv = np.bitwise_and((a * np.uint64(hv) + bb) % _MERSENNE, _MAX_HASH)
        self.hashvalues = np.minimum(phv, self.hashvalues)

    def update_batch(self, b: Iterable) -> None:
        """Fold many values into the sketch: hashed on the host, then
        permuted and reduced there, or on ``device`` by kernel 1 (one
        document; per ``device_mode``) and merged with the state."""
        hv = self._hash_tokens(list(b))
        if hv.size == 0:
            return
        if self._device_mode == "always" or (
            self._device_mode == "auto" and hv.size >= _DEVICE_BATCH_THRESHOLD
        ):
            dev = resolve_device(self.device)
            sig = minhash_ops.compute_signatures_ragged(
                _upload(hv.view(np.int32), dev), _upload(np.array([hv.size], np.int32), dev),
                self.seed, self.num_perm, permutations=self._custom_permutations(),
            )[0]
            state = as_sig_tensor(self.hashvalues[None, :], dev)[0]
            merged = minhash_ops.merge_signatures(state, sig)
            self.hashvalues = to_numpy_u32(merged).astype(np.uint64)
            return
        self.hashvalues = np.minimum(self.hashvalues, self._permuted_min(hv))

    def _hash_tokens(self, tokens: list) -> np.ndarray:
        """uint32 hashes of a token list: the native batch hasher for
        SHA1 / XXH32, the vectorized fmix32 for ``device_hash``, else the
        callable per token."""
        algo = _NATIVE_ALGO.get(self.hashfunc)
        if algo is not None and tokens:
            return native.hash_flat(tokens, algo)
        if self.hashfunc is device_hash and tokens:
            return mix32_np(np.asarray(tokens).astype(np.uint32))
        return np.array([self.hashfunc(t) for t in tokens], dtype=np.uint64).astype(np.uint32)

    def _hash_flat(self, docs: list) -> np.ndarray:
        """uint32 hashes of every token of ``docs``, back to back: one
        native call for SHA1 / XXH32, one vectorized fmix32 for
        ``device_hash``, else :meth:`_hash_tokens` per doc."""
        algo = _NATIVE_ALGO.get(self.hashfunc)
        if algo is not None:
            return native.hash_ragged([d if isinstance(d, list) else list(d) for d in docs],
                                      algo=algo)[0]
        if self.hashfunc is device_hash:
            return mix32_np(np.concatenate(
                [np.asarray(d).astype(np.uint32) for d in docs] or [np.zeros(0, np.uint32)]))
        return np.concatenate(
            [self._hash_tokens(list(d)) for d in docs] or [np.zeros(0, np.uint32)])

    def jaccard(self, other: "MinHash") -> float:
        """Estimate Jaccard similarity against another sketch."""
        if other.seed != self.seed:
            raise ValueError("Cannot compute Jaccard given MinHash with different seeds")
        if len(self) != len(other):
            raise ValueError(
                "Cannot compute Jaccard given MinHash with different numbers of "
                "permutation functions"
            )
        return float(np.count_nonzero(self.hashvalues == other.hashvalues)) / float(len(self))

    def count(self) -> float:
        """Cardinality estimate (Cohen's estimator)."""
        return float(len(self)) / np.sum(self.hashvalues / float(_MAX_HASH)) - 1.0

    def merge(self, other: "MinHash") -> None:
        """Merge another sketch into this one (set-union semantics)."""
        if other.seed != self.seed:
            raise ValueError("Cannot merge MinHash with different seeds")
        if len(self) != len(other):
            raise ValueError(
                "Cannot merge MinHash with different numbers of permutation functions"
            )
        self.hashvalues = np.minimum(other.hashvalues, self.hashvalues)

    def digest(self) -> np.ndarray:
        """A copy of the hash values."""
        return copy.copy(self.hashvalues)

    def is_empty(self) -> bool:
        """True if no value has ever been folded in."""
        return not np.any(self.hashvalues != _MAX_HASH)

    def clear(self) -> None:
        """Reset to the just-initialized state."""
        self.hashvalues = self._init_hashvalues(len(self))

    def copy(self) -> "MinHash":
        return MinHash(seed=self.seed, hashfunc=self.hashfunc, hashvalues=self.digest(),
                       permutations=self.permutations, device_mode=self._device_mode,
                       device=self.device)

    def __len__(self) -> int:
        return len(self.hashvalues)

    def __eq__(self, other) -> bool:
        return (type(self) is type(other) and self.seed == other.seed
                and np.array_equal(self.hashvalues, other.hashvalues))

    @classmethod
    def union(cls, *mhs: "MinHash") -> "MinHash":
        """A new sketch of the union of the given sketches."""
        if len(mhs) < 2:
            raise ValueError("Cannot union less than 2 MinHash")
        num_perm, seed = len(mhs[0]), mhs[0].seed
        if any((seed != m.seed or num_perm != len(m)) for m in mhs):
            raise ValueError(
                "The unioning MinHash must have the same seed and number of "
                "permutation functions"
            )
        return cls(num_perm=num_perm, seed=seed, hashfunc=mhs[0].hashfunc,
                   hashvalues=np.minimum.reduce([m.hashvalues for m in mhs]),
                   permutations=mhs[0].permutations, device_mode=mhs[0]._device_mode,
                   device=mhs[0].device)

    @classmethod
    def bulk(cls, b: Iterable, scheme: str = "permutation", **minhash_kwargs) -> list:
        """Sketches of many documents, in input order: documents are
        grouped by length and signed in chunks (:meth:`generator`)."""
        docs = b if isinstance(b, list) else list(b)
        docs = [d if hasattr(d, "__len__") else list(d) for d in docs]
        order = sorted(range(len(docs)), key=lambda i: len(docs[i]))
        out: list = [None] * len(docs)
        gen = cls.generator((docs[i] for i in order), scheme=scheme, **minhash_kwargs)
        for pos, m in zip(order, gen):
            out[pos] = m
        return out

    @classmethod
    def generator(cls, b: Iterable, scheme: str = "permutation", **minhash_kwargs):
        """Generator form of :meth:`bulk`: sketches in chunks of 1,024
        documents, each chunk signed on ``device`` (by kernel 1, or by the
        ``scheme``'s torch ops) once it holds 4,096 tokens
        (``device_mode="auto"``), else on the host (the CPU)."""
        proto = cls(**minhash_kwargs)
        _check_scheme(scheme, proto._custom_permutations())
        chunk: list = []
        for doc in b:
            chunk.append(doc)
            if len(chunk) >= 1024:
                yield from proto._bulk_chunk(chunk, scheme)
                chunk = []
        if chunk:
            yield from proto._bulk_chunk(chunk, scheme)

    def _bulk_chunk(self, docs: list, scheme: str = "permutation"):
        hashed = [self._hash_tokens(list(doc)) for doc in docs]
        total = sum(h.size for h in hashed)
        on_host = self._device_mode == "disable" or (
            total < _DEVICE_BATCH_THRESHOLD and self._device_mode != "always"
        )
        if scheme != "permutation":
            dev = torch.device("cpu") if on_host else resolve_device(self.device)
            lengths = np.fromiter((h.size for h in hashed), np.int32, count=len(hashed))
            padded = _pad_flat(np.concatenate(hashed), lengths)
            sigs = _alt_scheme_signatures(
                scheme, _upload(padded.view(np.int32), dev), _upload(lengths, dev),
                self.num_perm, self.seed,
            )
            yield from self._rows(to_numpy_u32(sigs).astype(np.uint64))
            return
        if on_host:
            for hv in hashed:
                m = self.copy()
                if hv.size:
                    m.hashvalues = np.minimum(m.hashvalues, self._permuted_min(hv))
                yield m
            return
        dev = resolve_device(self.device)
        lengths = np.fromiter((h.size for h in hashed), np.int32, count=len(hashed))
        sigs = minhash_ops.compute_signatures_ragged(
            _upload(np.concatenate(hashed).view(np.int32), dev), _upload(lengths, dev),
            self.seed, self.num_perm, permutations=self._custom_permutations(),
        )
        yield from self._rows(to_numpy_u32(sigs).astype(np.uint64))

    def _rows(self, sigs: np.ndarray):
        for row in sigs:
            yield MinHash(seed=self.seed, hashfunc=self.hashfunc, hashvalues=row,
                          permutations=self.permutations, device_mode=self._device_mode,
                          device=self.device)

    @classmethod
    def bulk_signatures(cls, b: Iterable, scheme: str = "permutation",
                        out: str = "host", device="cuda", **minhash_kwargs):
        """Signature matrix of a corpus: uint32[N, num_perm], input order.

        Args:
            b: documents -- lists of bytes tokens (SHA1 / XXH32, hashed by
                the native module), integer token-id arrays
                (``hashfunc="device"``), or tokens for any other callable
                (hashed by it on the host).
            scheme: ``"permutation"`` (default; kernel 1, equal to the
                reference's values), ``"oph"`` or ``"cminhash"`` (tokens
                hashed on the host, the scheme's torch ops on ``device``).
            out: ``"host"`` returns ``np.ndarray`` uint32; ``"device"``
                returns the int32 (uint32 bits) tensor on ``device``
                without a copy back.
            device: ``"cuda"`` (default) runs kernel 1; ``"cpu"`` runs its
                plain PyTorch twin. No silent fallback.
            **minhash_kwargs: as for :class:`MinHash`;
                ``device_mode="disable"`` signs on the host (the object
                path) and touches ``device`` only for ``out="device"``.
        """
        if out not in ("host", "device"):
            raise ValueError("out must be 'host' or 'device'")
        proto = cls(**minhash_kwargs)
        perms = proto._custom_permutations()
        _check_scheme(scheme, perms)
        docs = b if isinstance(b, list) else list(b)
        docs = [d if hasattr(d, "__len__") else list(d) for d in docs]
        n, p = len(docs), proto.num_perm
        if proto._device_mode == "disable":
            host = np.zeros((n, p), dtype=np.uint32)
            for i, m in enumerate(cls.bulk(docs, scheme=scheme, **minhash_kwargs)):
                host[i] = m.hashvalues
            return as_sig_tensor(host, resolve_device(device)) if out == "device" else host
        dev = resolve_device(device)
        result = torch.empty((n, p), dtype=torch.int32, device=dev)
        use_ids = proto.hashfunc is device_hash
        order = sorted(range(n), key=lambda i: len(docs[i]))
        for start, stop in _budget_chunks([len(docs[i]) for i in order]):
            idx = order[start:stop]
            chunk = [docs[i] for i in idx]
            lengths = np.fromiter(map(len, chunk), np.int32, count=len(chunk))
            if scheme != "permutation":
                # never the flat or ids paths: hashed on the host, padded
                padded = _pad_flat(proto._hash_flat(chunk), lengths)
                sigs = _alt_scheme_signatures(
                    scheme, _upload(padded.view(np.int32), dev), _upload(lengths, dev),
                    p, proto.seed,
                )
                result[_upload(np.asarray(idx, dtype=np.int64), dev)] = sigs
                continue
            if use_ids:
                flat = _upload(_id_tokens(chunk), dev)
            elif proto.hashfunc in _NATIVE_ALGO:
                flat = _native_tokens(chunk, _NATIVE_ALGO[proto.hashfunc], dev)
            else:
                flat = _upload(proto._hash_flat(chunk).view(np.int32), dev)
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

        - ``sha1_hash32`` (default) or ``xxhash_hash32`` (``"xxh32"``):
          every overlapping k-byte shingle is hashed in C straight out of
          the text (the native module), then kernel 1 signs the padded
          batch. Equal to the reference's values.
        - ``"device"``: the raw text is uploaded and the shingles are
          hashed on the card (polynomial window roll + fmix32), then
          kernel 1 signs them in place. Not value-compatible with the SHA1
          engine (the same estimator statistics).

        Args:
            texts: bytes or str (encoded as UTF-8) documents.
            k: shingle width in bytes.
            scheme: ``"permutation"`` (default), or ``"oph"`` /
                ``"cminhash"`` with the SHA1 or XXH32 engine (the on-card
                shingle hash signs by permutation only).
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
        if k <= 0:
            raise ValueError("k must be positive")
        dev = resolve_device(device)
        proto = cls(**minhash_kwargs)
        perms = proto._custom_permutations()
        _check_scheme(scheme, perms)
        if proto.hashfunc is not device_hash and proto.hashfunc not in _NATIVE_ALGO:
            raise ValueError(
                "bulk_from_text hashes shingles natively and supports only the "
                "sha1_hash32 (default), xxhash_hash32/'xxh32' and 'device' hash "
                "functions; shingle and hash with your callable and use "
                "bulk_signatures instead"
            )
        if proto.hashfunc is device_hash and scheme != "permutation":
            raise ValueError(
                "hashfunc='device' shingling supports only the default 'permutation' scheme"
            )
        texts = texts if isinstance(texts, list) else list(texts)
        texts = [t.encode("utf-8") if isinstance(t, str) else t for t in texts]
        n, p = len(texts), proto.num_perm
        result = torch.empty((n, p), dtype=torch.int32, device=dev)
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
                hashes, lengths = _native_shingles(
                    chunk, k, counts[stop - 1], _NATIVE_ALGO[proto.hashfunc], dev
                )
                if scheme != "permutation":
                    sigs = _alt_scheme_signatures(scheme, hashes, _upload(lengths, dev), p,
                                                  proto.seed)
                else:
                    sigs = minhash_ops.compute_signatures(
                        hashes, _upload(lengths, dev), proto.seed, p, permutations=perms,
                    )
            result[_upload(np.asarray(idx, dtype=np.int64), dev)] = sigs
        return result if out == "device" else to_numpy_u32(result)
