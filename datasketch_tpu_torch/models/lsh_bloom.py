"""MinHashLSHBloom: membership-only LSH (LSHBloom, arXiv:2411.04257).

Port of ``datasketch_tpu/models/lsh_bloom.py``. :class:`BloomTable` and
:class:`MinHashLSHBloom` are the host classes, copied: one numpy bitmap per
band with double-hashed probes, persisted as ``band-<i>.bf`` files.
:class:`TorchMinHashLSHBloom` keeps every band's bitmap as one
``int32[b, num_words]`` tensor of uint32 words on ``device``, with the same
band keys (``sum(band) % (2**61 - 1)``) and probe positions, so its bits
and answers equal the JAX package's ``TpuMinHashLSHBloom`` and the host
class's. Band keys and probe positions are computed on the host in uint64.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Optional

import numpy as np
import torch

from datasketch_tpu_torch.device import resolve_device, to_numpy_u32, upload_bits
from datasketch_tpu_torch.models.lsh_params import optimal_param

logger = logging.getLogger(__name__)

_mersenne_prime = np.uint64((1 << 61) - 1)

__all__ = ["MinHashLSHBloom", "BloomTable", "TorchMinHashLSHBloom"]


def _probe_positions(x: np.ndarray, num_hashes: int, num_bits: int) -> np.ndarray:
    """``num_hashes`` probe positions per key by double hashing: uint64 keys
    [...] -> uint64 positions [..., num_hashes] in [0, num_bits)."""
    x = x.astype(np.uint64)
    h1 = x * np.uint64(0x9E3779B97F4A7C15)
    h1 ^= h1 >> np.uint64(29)
    h1 *= np.uint64(0xBF58476D1CE4E5B9)
    h1 ^= h1 >> np.uint64(32)
    h2 = x * np.uint64(0xC2B2AE3D27D4EB4F)
    h2 ^= h2 >> np.uint64(33)
    h2 = h2 | np.uint64(1)  # odd stride
    i = np.arange(num_hashes, dtype=np.uint64)
    return (h1[..., None] + i * h2[..., None]) % np.uint64(num_bits)


class BloomTable:
    """A Bloom filter modeling one band of the signature matrix.

    Args:
        item_count: expected number of inserts (sizes the bitmap).
        fp: target false-positive rate in (0, 1).
        band_size: r, the hash values per band.
        fname: optional path; if it exists the filter is loaded from it,
            else a new filter is created (and :meth:`sync` saves there).
    """

    _MAGIC = 0x42463031  # "BF01"

    def __init__(self, item_count: int, fp: float, band_size: int,
                 fname: Optional[str] = None):
        self.r = band_size
        self.fname = fname
        if fname is not None and os.path.exists(fname):
            logger.info("Loading Bloom Filter at %s...", fname)
            self._load(fname)
        else:
            # standard sizing: m = -n ln p / (ln 2)^2 ; k = m/n ln 2
            n = max(1, int(item_count))
            m = int(np.ceil(-n * np.log(fp) / (np.log(2.0) ** 2)))
            m = max(64, m)
            self.num_bits = m
            self.num_hashes = max(1, int(round(m / n * np.log(2.0))))
            self.bits = np.zeros((m + 63) // 64, dtype=np.uint64)

    def _positions(self, x: np.ndarray) -> np.ndarray:
        """Probe positions per key: [N] -> [N, k]."""
        return _probe_positions(x, self.num_hashes, self.num_bits)

    @staticmethod
    def _band_key(hashvalues) -> np.uint64:
        return np.uint64(
            int(np.sum(np.asarray(hashvalues, dtype=np.uint64), dtype=np.uint64))
            % int(_mersenne_prime)
        )

    def assert_size(self, hashvalues) -> None:
        if not len(hashvalues) == self.r:
            raise RuntimeError(
                f"Invalid length for indices, {len(hashvalues)}, expected "
                f"{self.r} hashvalues in band"
            )

    def insert(self, hashvalues) -> None:
        """Add one band's hashvalues to the filter."""
        self.assert_size(hashvalues)
        self.insert_keys(np.array([self._band_key(hashvalues)], dtype=np.uint64))

    def query(self, hashvalues) -> bool:
        """Whether one band's hashvalues were (probably) inserted."""
        self.assert_size(hashvalues)
        return bool(self.query_keys(np.array([self._band_key(hashvalues)], dtype=np.uint64))[0])

    def insert_keys(self, keys: np.ndarray) -> None:
        pos = self._positions(keys).reshape(-1)
        word = (pos >> np.uint64(6)).astype(np.int64)
        bit = np.uint64(1) << (pos & np.uint64(63))
        np.bitwise_or.at(self.bits, word, bit)

    def query_keys(self, keys: np.ndarray) -> np.ndarray:
        pos = self._positions(keys)
        word = (pos >> np.uint64(6)).astype(np.int64)
        bit = np.uint64(1) << (pos & np.uint64(63))
        hits = (self.bits[word] & bit) != 0
        return hits.all(axis=1)

    def sync(self) -> None:
        """Persist to ``fname`` (an in-memory filter warns and does nothing)."""
        if self.fname is not None:
            header = np.array(
                [self._MAGIC, self.num_bits, self.num_hashes, self.r], dtype=np.uint64
            )
            with open(self.fname, "wb") as f:
                np.save(f, header)
                np.save(f, self.bits)
        else:
            warnings.warn(
                "Attempting to save in-memory Bloom filter, this is a no-op.",
                RuntimeWarning,
                stacklevel=2,
            )

    def _load(self, fname: str) -> None:
        with open(fname, "rb") as f:
            header = np.load(f)
            if int(header[0]) != self._MAGIC:
                raise ValueError(f"{fname} is not a datasketch_tpu bloom file")
            self.num_bits = int(header[1])
            self.num_hashes = int(header[2])
            self.r = int(header[3])
            self.bits = np.load(f)


class MinHashLSHBloom:
    """Membership-only LSH: answers "is this a likely duplicate?" in O(b)
    bloom probes, with no key storage.

    Args:
        threshold: Jaccard threshold the banding is optimized for.
        num_perm: signature length.
        n: expected number of inserted sets (sizes each filter).
        fp: per-filter false-positive rate in (0, 1).
        save_dir: directory for the band filter files (``band-<i>.bf``);
            None keeps the index in memory only (warns).
        weights / params: as in ``MinHashLSH``.
    """

    def __init__(self, threshold: float = 0.9, num_perm: int = 128, n: Optional[int] = None,
                 fp: Optional[float] = None, save_dir: Optional[str] = None,
                 weights: tuple = (0.5, 0.5), params: Optional[tuple] = None) -> None:
        if threshold > 1.0 or threshold < 0.0:
            raise ValueError("threshold must be in [0.0, 1.0]")
        if num_perm < 2:
            raise ValueError("Too few permutation functions")
        if n is None or n <= 0:
            raise ValueError("n for LSHBloom must be >= 0")
        if fp is None or fp >= 1.0 or fp <= 0.0:
            raise ValueError("fp must be in (0.0, 1.0)")
        if save_dir is None:
            warnings.warn(
                "Creating LSHBloom index without save directory, this index "
                "will not be persisted.",
                RuntimeWarning,
                stacklevel=2,
            )
        if any(w < 0.0 or w > 1.0 for w in weights):
            raise ValueError("Weight must be in [0.0, 1.0]")
        if sum(weights) != 1.0:
            raise ValueError("Weights must sum to 1.0")
        self.h = num_perm
        if params is not None:
            self.b, self.r = params
            if self.b * self.r > num_perm:
                raise ValueError(
                    "The product of b and r in params is "
                    f"{self.b} * {self.r} = {self.b * self.r} -- it must be "
                    f"less than num_perm {num_perm}. "
                    "Did you forget to specify num_perm?"
                )
        else:
            fpw, fnw = weights
            self.b, self.r = optimal_param(threshold, num_perm, fpw, fnw)
        if self.b < 2:
            raise ValueError("The number of bands are too small (b < 2)")
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
        self.hashtables = [
            BloomTable(
                item_count=n, fp=fp, band_size=self.r,
                fname=os.path.join(save_dir, f"band-{i}.bf") if save_dir is not None else None,
            )
            for i in range(self.b)
        ]
        self.hashranges = [(i * self.r, (i + 1) * self.r) for i in range(self.b)]

    def _check_len(self, width: int) -> None:
        if width != self.h:
            raise ValueError("Expecting minhash with length %d, got %d" % (self.h, width))

    def insert(self, minhash) -> None:
        """Insert a MinHash / WeightedMinHash into every band filter."""
        self._check_len(len(minhash))
        for (start, end), hashtable in zip(self.hashranges, self.hashtables):
            hashtable.insert(minhash.hashvalues[start:end])

    def _sigs(self, minhashes) -> np.ndarray:
        sigs = np.stack([np.asarray(m.hashvalues, dtype=np.uint64) for m in minhashes])
        self._check_len(sigs.shape[1])
        return sigs

    def insert_batch(self, minhashes) -> None:
        """Vectorized insert of many sketches: one scatter per band."""
        sigs = self._sigs(minhashes)
        for i, (start, end) in enumerate(self.hashranges):
            keys = sigs[:, start:end].sum(axis=1, dtype=np.uint64) % _mersenne_prime
            self.hashtables[i].insert_keys(keys)

    def query(self, minhash) -> bool:
        """True if any band collides: a likely duplicate was inserted."""
        self._check_len(len(minhash))
        for (start, end), hashtable in zip(self.hashranges, self.hashtables):
            if hashtable.query(minhash.hashvalues[start:end]):
                return True
        return False

    def query_batch(self, minhashes) -> np.ndarray:
        """Vectorized duplicate test: bool[N]."""
        sigs = self._sigs(minhashes)
        out = np.zeros(sigs.shape[0], dtype=bool)
        for i, (start, end) in enumerate(self.hashranges):
            keys = sigs[:, start:end].sum(axis=1, dtype=np.uint64) % _mersenne_prime
            out |= self.hashtables[i].query_keys(keys)
        return out

    def sync(self) -> None:
        """Persist all band filters."""
        logger.info("Saving Bloom Index...")
        for table in self.hashtables:
            table.sync()


def _batch(minhashes):
    """Matrices and tensors as they are; any other iterable as a list."""
    return minhashes if isinstance(minhashes, (np.ndarray, torch.Tensor)) else list(minhashes)


def _host_sigs(minhashes) -> np.ndarray:
    """uint64[N, P] signatures on the host: a uint32 matrix, an int32
    (uint32 bits) tensor on any device, or a sequence of rows / sketch
    objects."""
    if isinstance(minhashes, torch.Tensor):
        return to_numpy_u32(minhashes).astype(np.uint64)
    if isinstance(minhashes, np.ndarray) and minhashes.ndim == 2:
        return minhashes.astype(np.uint64)
    rows = []
    for m in minhashes:
        m = m.hashvalues if hasattr(m, "hashvalues") else m
        rows.append(to_numpy_u32(m) if isinstance(m, torch.Tensor) else m)
    return np.stack([np.asarray(r, dtype=np.uint64) for r in rows])


class TorchMinHashLSHBloom:
    """LSHBloom with every band's bitmap on ``device``.

    The bitmaps are one ``int32[b, num_words]`` tensor of uint32 words (1
    bit per filter bit, bit ``pos`` at ``1 << (pos & 31)`` of word
    ``pos >> 5``). An insert ORs each unique (band, word) mask of its batch
    in with one gather and one ``index_put_`` (the indices are unique, so
    nothing races); a query is one gather and a bit test.

    Args:
        threshold, num_perm, weights, params: the banding, as in
            ``MinHashLSH``.
        n: expected number of inserted sets; fp: per-band false-positive
            rate (they size the bitmaps and the probe count).
        device: ``"cuda"`` (default; raises without a card of capability
            >= 9.0) or ``"cpu"``.
    """

    # Bumped when the probe-position scheme changes: a bitmap probed with
    # another scheme would load cleanly and then miss everything inserted.
    _PROBE_SCHEME = 2

    def __init__(self, threshold: float = 0.9, num_perm: int = 128,
                 weights: tuple = (0.5, 0.5), params: Optional[tuple] = None,
                 n: int = 1_000_000, fp: float = 0.01, device="cuda") -> None:
        self.device = resolve_device(device)
        self._set_params(threshold, num_perm, weights, params, n, fp)
        self._words = torch.zeros((self.b, self.num_words), dtype=torch.int32,
                                  device=self.device)

    def _set_params(self, threshold: float, num_perm: int, weights: tuple,
                    params: Optional[tuple], n: int, fp: float) -> None:
        """The banding, the bitmap size and the probe count (no storage)."""
        if threshold > 1.0 or threshold < 0.0:
            raise ValueError("threshold must be in [0.0, 1.0]")
        self.threshold = threshold
        self.h = num_perm
        if params is not None:
            self.b, self.r = params
            if self.b * self.r > num_perm:
                raise ValueError("b*r must be <= num_perm")
        else:
            self.b, self.r = optimal_param(threshold, num_perm, *weights)
        m = int(np.ceil(-max(1, n) * np.log(fp) / (np.log(2.0) ** 2)))
        self.num_bits = max(64, m)
        self.num_hashes = max(1, int(round(self.num_bits / max(1, n) * np.log(2.0))))
        # the tail of the last word past num_bits is never addressed
        self.num_words = -(-self.num_bits // 32)
        self.hashranges = [(i * self.r, (i + 1) * self.r) for i in range(self.b)]

    def _positions(self, minhashes) -> np.ndarray:
        """Probe positions int64[N, b, k] of a batch: each band's key
        ``sum(band) % (2**61 - 1)``, double-hashed."""
        sigs = _host_sigs(minhashes)
        bands = sigs[:, : self.b * self.r].reshape(sigs.shape[0], self.b, self.r)
        keys = bands.sum(axis=2, dtype=np.uint64) % _mersenne_prime
        return _probe_positions(keys, self.num_hashes, self.num_bits).astype(np.int64)

    def _word_updates(self, minhashes):
        """(band int64[M], word int64[M], OR-combined mask uint32[M]) of a
        batch's unique (band, word) pairs."""
        pos = self._positions(minhashes)
        band = np.broadcast_to(np.arange(self.b, dtype=np.int64)[None, :, None], pos.shape)
        gid = (band * self.num_words + (pos >> 5)).ravel()  # global word id
        mask_all = (np.uint32(1) << (pos & 31).astype(np.uint32)).ravel()
        order = np.argsort(gid)  # OR is order-free: any sort will do
        gid = gid[order]
        starts = np.flatnonzero(np.r_[True, gid[1:] != gid[:-1]])
        masks = np.bitwise_or.reduceat(mask_all[order], starts)
        uniq = gid[starts]
        return uniq // self.num_words, uniq % self.num_words, masks

    def insert(self, minhash) -> None:
        self.insert_batch([minhash])

    def insert_batch(self, minhashes) -> None:
        """Insert a batch: a uint32 matrix, an int32 (uint32 bits) tensor,
        or rows / MinHash objects. One gather and one unique-index write."""
        minhashes = _batch(minhashes)
        if len(minhashes) == 0:
            return
        band, word, mask = (upload_bits(a, self.device) for a in self._word_updates(minhashes))
        self._words.index_put_((band, word), self._words[band, word] | mask)

    def insert_tokens(self, token_docs, seed: int = 1) -> None:
        """Insert pre-tokenized integer documents, their ids hashed on
        ``device`` (``hashfunc="device"``; membership only, so no keys).
        Query with ``hashfunc="device"`` sketches at equal seed."""
        from datasketch_tpu_torch.models.minhash import MinHash

        self.insert_batch(MinHash.bulk_signatures(
            token_docs, num_perm=self.h, seed=seed, hashfunc="device", device=self.device,
        ))

    def insert_text(self, texts, k: int = 9, seed: int = 1) -> None:
        """Insert raw texts, their k-byte shingles hashed on ``device``."""
        from datasketch_tpu_torch.models.minhash import MinHash

        self.insert_batch(MinHash.bulk_from_text(
            texts, k=k, num_perm=self.h, seed=seed, hashfunc="device", device=self.device,
        ))

    def query(self, minhash) -> bool:
        return bool(self.query_batch([minhash])[0])

    def query_batch(self, minhashes) -> np.ndarray:
        """bool[N]: True where any band's filter hits (a likely duplicate)."""
        minhashes = _batch(minhashes)
        if len(minhashes) == 0:
            return np.zeros(0, dtype=bool)
        pos = self._positions(minhashes)  # [N, b, k]
        band = torch.arange(self.b, device=self.device)[None, :, None]
        mask = upload_bits(np.uint32(1) << (pos & 31).astype(np.uint32), self.device)
        w = self._words[band, upload_bits(pos >> 5, self.device)]
        return ((w & mask) != 0).all(dim=2).any(dim=1).cpu().numpy()

    def save(self, path: str) -> None:
        """Persist the word bitmaps and the parameters to ``.npz`` in the
        JAX package's layout (``bits_packed`` uint32, ``meta``,
        ``probe_scheme``, ``threshold``), which either package loads."""
        from datasketch_tpu_torch.persist import atomic_savez, npz_path

        atomic_savez(
            npz_path(path),
            bits_packed=to_numpy_u32(self._words),
            meta=np.array([self.h, self.b, self.r, self.num_bits, self.num_hashes],
                          dtype=np.int64),
            probe_scheme=np.int64(self._PROBE_SCHEME),
            threshold=np.float64(self.threshold),
        )

    @staticmethod
    def _pack_bool(bits: np.ndarray, num_words: int) -> np.ndarray:
        """bool[b, num_bits] -> uint32[b, num_words], LSB first (the mask
        convention ``1 << (pos & 31)``)."""
        b, num_bits = bits.shape
        padded = np.zeros((b, num_words * 32), dtype=bool)
        padded[:, :num_bits] = bits
        cube = padded.reshape(b, num_words, 32).astype(np.uint32)
        return (cube << np.arange(32, dtype=np.uint32)).sum(axis=2, dtype=np.uint32)

    @classmethod
    def load(cls, path: str, device="cuda") -> "TorchMinHashLSHBloom":
        """Load a filter saved by either package (word-packed, or the older
        bool ``bits`` layout) onto ``device``. A file of another probe
        scheme is refused: its bit positions no longer match."""
        from datasketch_tpu_torch.persist import npz_path

        data = np.load(npz_path(path), allow_pickle=False)
        saved_scheme = int(data["probe_scheme"]) if "probe_scheme" in data else 1
        if saved_scheme != cls._PROBE_SCHEME:
            raise ValueError(
                "bloom bitmap was built with probe scheme v%d (current v%d): its bit "
                "positions no longer match and every membership query would silently "
                "return False; rebuild the filter from source data"
                % (saved_scheme, cls._PROBE_SCHEME)
            )
        h, b, r, num_bits, num_hashes = (int(x) for x in data["meta"])
        obj = cls.__new__(cls)
        obj.device = resolve_device(device)
        obj.threshold = float(data["threshold"])
        obj.h = h
        obj.b, obj.r = b, r
        obj.num_bits = num_bits
        obj.num_hashes = num_hashes
        obj.num_words = -(-num_bits // 32)
        if "bits_packed" in data:
            words = data["bits_packed"]
        else:  # bool bitmap checkpoints
            words = cls._pack_bool(data["bits"], obj.num_words)
        obj._words = upload_bits(np.asarray(words, dtype=np.uint32), obj.device)
        obj.hashranges = [(i * r, (i + 1) * r) for i in range(b)]
        return obj
