"""MinHashLSH — the host-side, storage-backed Jaccard-threshold index.

Copied from the JAX package's ``models/lsh.py`` (API parity with upstream
``datasketch/lsh.py:51``: insert / query / remove / merge, sessions,
buffered queries, counts, pluggable storage, prepickle). It is numpy only
and has no device path: band keys are the big-endian bytes of each band's
``hashvalues`` (host numpy in the port's ``MinHash``, ``LeanMinHash`` and
``WeightedMinHash``), so keys, buckets and answers equal the JAX package's
for the same signatures and ``basename``. :meth:`insert_batch` and
:meth:`query_batch` band-hash a whole signature matrix in one pass.

The (b, r) optimizer is :func:`datasketch_tpu_torch.models.lsh_params.
optimal_param`. The device-resident index is
:class:`datasketch_tpu_torch.models.torch_lsh.TorchMinHashLSH`.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Callable, Hashable, Optional

import numpy as np

from datasketch_tpu_torch.models.lsh_params import optimal_param
from datasketch_tpu_torch.storage import (
    ordered_storage,
    unordered_storage,
)

__all__ = ["MinHashLSH"]


def _random_name(length: int) -> bytes:
    return os.urandom(length).hex()[:length].encode("ascii")


class MinHashLSH:
    """Jaccard-threshold LSH index.

    Args:
        threshold: Jaccard threshold in [0, 1] the banding is optimized for.
        num_perm: Signature length of the MinHashes to be indexed.
        weights: (false_positive_weight, false_negative_weight), sum to 1.
        params: Optional explicit (b, r) bypassing the optimizer.
        storage_config: ``{'type': 'dict'}`` (default) or
            ``{'type': 'redis', 'redis': {...}, 'basename': bytes}``.
        prepickle: Pickle keys to bytes before storing (defaults True for
            redis storage).
        hashfunc: Optional bytes->bytes compressor applied to band keys.
    """

    def __init__(
        self,
        threshold: float = 0.9,
        num_perm: int = 128,
        weights: tuple = (0.5, 0.5),
        params: Optional[tuple] = None,
        storage_config: Optional[dict] = None,
        prepickle: Optional[bool] = None,
        hashfunc: Optional[Callable[[bytes], bytes]] = None,
    ) -> None:
        storage_config = storage_config if storage_config else {"type": "dict"}
        self._buffer_size = 50000
        if threshold > 1.0 or threshold < 0.0:
            raise ValueError("threshold must be in [0.0, 1.0]")
        if num_perm < 2:
            raise ValueError("Too few permutation functions")
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

        self.prepickle = (
            storage_config["type"] == "redis" if prepickle is None else prepickle
        )
        self._require_bytes_keys = not (
            storage_config["type"] == "dict" or self.prepickle
        )

        self.hashfunc = hashfunc
        if hashfunc:
            self._H = self._hashed_byteswap
        else:
            self._H = self._byteswap

        basename = storage_config.get("basename", _random_name(11))
        if isinstance(basename, str):
            basename = basename.encode("ascii")
        self.hashtables = [
            unordered_storage(
                storage_config,
                name=b"".join([basename, b"_bucket_", struct.pack(">H", i)]),
            )
            for i in range(self.b)
        ]
        self.hashranges = [(i * self.r, (i + 1) * self.r) for i in range(self.b)]
        self.keys = ordered_storage(storage_config, name=b"".join([basename, b"_keys"]))

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @buffer_size.setter
    def buffer_size(self, value: int) -> None:
        self.keys.buffer_size = value
        for t in self.hashtables:
            t.buffer_size = value
        self._buffer_size = value

    # ------------------------------------------------------------------ band keys

    def _byteswap(self, hs) -> bytes:
        # Big-endian byte serialization of the band's hashvalues
        # (lsh.py:537-538) — keeps band keys identical to the reference's.
        # Native dtype preserved: WeightedMinHash rows are signed (k, t).
        return bytes(np.asarray(hs).byteswap().data)

    def _hashed_byteswap(self, hs) -> bytes:
        if self.hashfunc is None:
            raise RuntimeError("Hash function not configured.")
        return self.hashfunc(bytes(np.asarray(hs).byteswap().data))

    def _band_keys(self, minhash) -> list:
        hv = minhash.hashvalues
        return [self._H(hv[start:end]) for start, end in self.hashranges]

    # ------------------------------------------------------------------ mutation

    def insert(self, key: Hashable, minhash, check_duplication: bool = True) -> None:
        """Index `key` under the given MinHash/WeightedMinHash signature."""
        self._insert(key, minhash, check_duplication=check_duplication, buffer=False)

    def insert_batch(self, keys, minhashes, check_duplication: bool = True) -> None:
        """Insert many (key, minhash) pairs with one vectorized band-key pass.

        Band keys for the whole batch are produced from
        the stacked signature matrix, then written storage-buffer-style.
        """
        minhashes = list(minhashes)
        keys = list(keys)
        if len(keys) != len(minhashes):
            raise ValueError("keys and minhashes must have equal length")
        for m in minhashes:
            if len(m) != self.h:
                raise ValueError(
                    "Expecting minhash with length %d, got %d" % (self.h, len(m))
                )
        if not keys:
            return
        if self.hashfunc is not None:
            # custom band-key compressor: fall back to the per-key path
            for key, m in zip(keys, minhashes):
                self._insert(key, m, check_duplication=check_duplication)
            return
        # One byteswap over the stacked signature matrix, then per-band
        # byte-string views — identical bytes to per-key _H calls.
        # WeightedMinHash state is [num_perm, 2] (k, t) pairs, so one
        # "hash value" may span several array elements: val_bytes below.
        sigs = np.stack([np.asarray(m.hashvalues) for m in minhashes])
        swapped = np.ascontiguousarray(sigs.byteswap())
        raw = swapped.tobytes()
        val_bytes = swapped.dtype.itemsize * int(
            np.prod(swapped.shape[2:], dtype=np.int64)
        )
        row_bytes = swapped.shape[1] * val_bytes
        stored_keys = keys
        if self.prepickle:
            stored_keys = [pickle.dumps(k) for k in keys]
        elif self._require_bytes_keys:
            for k in keys:
                if not isinstance(k, bytes):
                    raise TypeError(
                        "prepickle=False requires bytes keys for non-dict "
                        f"storage, got {type(k).__name__}."
                    )
        if check_duplication:
            seen = set()
            for sk in stored_keys:
                if sk in self.keys or sk in seen:
                    raise ValueError("The given key already exists")
                seen.add(sk)
        for i, sk in enumerate(stored_keys):
            base = i * row_bytes
            Hs = [
                raw[base + start * val_bytes : base + end * val_bytes]
                for start, end in self.hashranges
            ]
            self.keys.insert(sk, *Hs, buffer=False)
            for H, hashtable in zip(Hs, self.hashtables):
                hashtable.insert(H, sk, buffer=False)

    def _insert(self, key, minhash, check_duplication=True, buffer=False) -> None:
        if len(minhash) != self.h:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.h, len(minhash))
            )
        if self._require_bytes_keys and not isinstance(key, bytes):
            raise TypeError(
                f"prepickle=False requires bytes keys for non-dict storage, "
                f"got {type(key).__name__}. Either pass bytes keys or use "
                "prepickle=True for automatic serialization."
            )
        if self.prepickle:
            key = pickle.dumps(key)
        if check_duplication and key in self.keys:
            raise ValueError("The given key already exists")
        Hs = self._band_keys(minhash)
        self.keys.insert(key, *Hs, buffer=buffer)
        for H, hashtable in zip(Hs, self.hashtables):
            hashtable.insert(H, key, buffer=buffer)

    def remove(self, key: Hashable) -> None:
        """Remove `key` and prune emptied buckets (lsh.py:497-528)."""
        self._remove(key, buffer=False)

    def _remove(self, key, buffer=False) -> None:
        if self.prepickle:
            key = pickle.dumps(key)
        if key not in self.keys:
            raise ValueError("The given key does not exist")
        for H, hashtable in zip(self.keys[key], self.hashtables):
            hashtable.remove_val(H, key, buffer=buffer)
            if not hashtable.get(H):
                hashtable.remove(H, buffer=buffer)
        self.keys.remove(key, buffer=buffer)

    def merge(self, other: "MinHashLSH", check_overlap: bool = False) -> None:
        """Union another index into this one (equivalence-checked on
        (h, b, r) only, lsh.py:233-251)."""
        self._merge(other, check_overlap=check_overlap, buffer=False)

    def __equivalent(self, other) -> bool:
        return (
            type(self) is type(other)
            and self.h == other.h
            and self.b == other.b
            and self.r == other.r
        )

    def _merge(self, other, check_overlap=False, buffer=False) -> None:
        if self.__equivalent(other):
            if check_overlap and set(self.keys).intersection(set(other.keys)):
                raise ValueError("The keys are overlapping, duplicate key exists.")
            for key in other.keys:
                Hs = other.keys.get(key)
                self.keys.insert(key, *Hs, buffer=buffer)
                for H, hashtable in zip(Hs, self.hashtables):
                    hashtable.insert(H, key, buffer=buffer)
        else:
            if type(self) is not type(other):
                raise ValueError(
                    f"Cannot merge type MinHashLSH and type {type(other).__name__}."
                )
            raise ValueError(
                "Cannot merge MinHashLSH with different initialization parameters."
            )

    # ------------------------------------------------------------------ queries

    def query(self, minhash) -> list:
        """Keys whose sets likely exceed the Jaccard threshold (union of
        band-bucket members; rerank with MinHash.jaccard for precision)."""
        if len(minhash) != self.h:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.h, len(minhash))
            )
        candidates = set()
        for H, hashtable in zip(self._band_keys(minhash), self.hashtables):
            for key in hashtable.get(H):
                candidates.add(key)
        if self.prepickle:
            return [pickle.loads(key) for key in candidates]
        return list(candidates)

    def query_batch(self, minhashes) -> list:
        """Query many MinHashes; returns a list of candidate lists.

        Band keys for the whole batch come from ONE byteswap over the
        stacked signature matrix (the :meth:`insert_batch` trick) and each
        band's buckets are fetched with one ``getmany`` — a single storage
        round trip per band instead of one per (query, band).
        """
        minhashes = list(minhashes)
        for m in minhashes:
            if len(m) != self.h:
                raise ValueError(
                    "Expecting minhash with length %d, got %d"
                    % (self.h, len(m))
                )
        if not minhashes:
            return []
        if self.hashfunc is not None:
            # custom band-key compressor: per-query path
            return [self.query(m) for m in minhashes]
        sigs = np.stack([np.asarray(m.hashvalues) for m in minhashes])
        swapped = np.ascontiguousarray(sigs.byteswap())
        raw = swapped.tobytes()
        val_bytes = swapped.dtype.itemsize * int(
            np.prod(swapped.shape[2:], dtype=np.int64)
        )
        row_bytes = swapped.shape[1] * val_bytes
        results = [set() for _ in minhashes]
        for band, ((start, end), hashtable) in enumerate(
            zip(self.hashranges, self.hashtables)
        ):
            Hs = [
                raw[i * row_bytes + start * val_bytes
                    : i * row_bytes + end * val_bytes]
                for i in range(len(minhashes))
            ]
            for res, bucket in zip(results, hashtable.getmany(*Hs)):
                res.update(bucket)
        if self.prepickle:
            return [[pickle.loads(k) for k in res] for res in results]
        return [list(res) for res in results]

    def _query_b(self, minhash, b) -> set:
        """Query using only the first b bands (used by LSHEnsemble)."""
        if len(minhash) != self.h:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.h, len(minhash))
            )
        if b > len(self.hashtables):
            raise ValueError("b must be less or equal to the number of hash tables")
        candidates = set()
        for (start, end), hashtable in zip(self.hashranges[:b], self.hashtables[:b]):
            H = self._H(minhash.hashvalues[start:end])
            if H in hashtable:
                for key in hashtable[H]:
                    candidates.add(key)
        if self.prepickle:
            return {pickle.loads(key) for key in candidates}
        return candidates

    def add_to_query_buffer(self, minhash) -> None:
        """Buffer a query for batched execution via
        :meth:`collect_query_buffer`."""
        if len(minhash) != self.h:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.h, len(minhash))
            )
        for H, hashtable in zip(self._band_keys(minhash), self.hashtables):
            hashtable.add_to_select_buffer([H])

    def collect_query_buffer(self) -> list:
        """Execute buffered queries: union across bands per query, then
        intersection across the buffered queries (lsh.py:452-483)."""
        collected_result_lists = [
            hashtable.collect_select_buffer() for hashtable in self.hashtables
        ]
        if not any(collected_result_lists):
            return []
        per_query_result_sets = [
            set().union(*query_result_lists)
            for query_result_lists in zip(*collected_result_lists)
        ]
        if not per_query_result_sets:
            return []
        candidates = set.intersection(*per_query_result_sets)
        if self.prepickle:
            return [pickle.loads(key) for key in candidates]
        return list(candidates)

    # ------------------------------------------------------------------ misc

    def __contains__(self, key: Hashable) -> bool:
        if self.prepickle:
            key = pickle.dumps(key)
        return key in self.keys

    def is_empty(self) -> bool:
        return any(t.size() == 0 for t in self.hashtables)

    def get_counts(self) -> list:
        """Bucket-occupancy histograms, one dict per hashtable."""
        return [hashtable.itemcounts() for hashtable in self.hashtables]

    def get_subset_counts(self, *keys) -> list:
        """Bucket counts restricted to the given keys."""
        if self.prepickle:
            key_set = [pickle.dumps(key) for key in set(keys)]
        else:
            key_set = list(set(keys))
        hashtables = [unordered_storage({"type": "dict"}) for _ in range(self.b)]
        Hss = self.keys.getmany(*key_set)
        for key, Hs in zip(key_set, Hss):
            for H, hashtable in zip(Hs, hashtables):
                hashtable.insert(H, key)
        return [hashtable.itemcounts() for hashtable in hashtables]

    def insertion_session(self, buffer_size: int = 50000):
        """Context manager for buffered bulk insertion."""
        return MinHashLSHInsertionSession(self, buffer_size=buffer_size)

    def deletion_session(self, buffer_size: int = 50000):
        """Context manager for buffered bulk deletion."""
        return MinHashLSHDeletionSession(self, buffer_size=buffer_size)


class _BufferedSession:
    """Shared machinery for the buffered bulk-mutation context managers.

    Covers the session contract of the reference (lsh.py:592-668): entering
    widens the index's storage buffers to ``buffer_size``, every mutation goes
    through the buffered path, and leaving the ``with`` block (or calling
    ``close()``) drains the keys table plus every band table.
    """

    def __init__(self, lsh: MinHashLSH, buffer_size: int):
        self.lsh = lsh
        self.lsh.buffer_size = buffer_size

    def close(self):
        for storage in (self.lsh.keys, *self.lsh.hashtables):
            storage.empty_buffer()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False


class MinHashLSHInsertionSession(_BufferedSession):
    """Buffered-insert session (reference lsh.py:592-631)."""

    def insert(self, key, minhash, check_duplication=True):
        self.lsh._insert(
            key, minhash, check_duplication=check_duplication, buffer=True
        )


class MinHashLSHDeletionSession(_BufferedSession):
    """Buffered-delete session (reference lsh.py:634-668)."""

    def remove(self, key):
        self.lsh._remove(key, buffer=True)
