"""AsyncMinHashLSH — asyncio MinHash LSH over async storage.

Parity target: ``datasketch/aio/lsh.py`` (awaitable /
async-context init at lines 95-168, async insert/query/remove with
per-band gather fan-out at 248-354, sessions flushing buffers on
``__aexit__`` at 357-398). The banding scheme, (b, r) optimizer, and band
byte keys are shared with :class:`datasketch_tpu_torch.models.lsh.MinHashLSH`.

Unlike the reference (which requires MongoDB/Redis), the default storage
here is the in-memory ``aiodict`` backend, so the async API works
standalone; pass ``{'type': 'aiomongo', ...}`` / ``{'type': 'aioredis',
...}`` for service-backed indexes.

Usage::

    async with AsyncMinHashLSH(threshold=0.5, num_perm=128) as lsh:
        await lsh.insert("doc1", mh1)
        result = await lsh.query(mh2)
"""

from __future__ import annotations

import asyncio
import pickle
import struct
from typing import Callable, Hashable, Optional

import numpy as np

from datasketch_tpu_torch.models.lsh import _random_name
from datasketch_tpu_torch.models.lsh_params import optimal_param
from datasketch_tpu_torch.aio.storage import (
    async_ordered_storage,
    async_unordered_storage,
)

__all__ = [
    "AsyncMinHashLSH",
    "AsyncMinHashLSHInsertionSession",
    "AsyncMinHashLSHDeleteSession",
]


class AsyncMinHashLSH:
    """Asyncio Jaccard-threshold LSH index.

    Args:
        threshold / num_perm / weights / params: as
            :class:`datasketch_tpu_torch.models.lsh.MinHashLSH`.
        storage_config: ``{'type': 'aiodict'}`` (default), ``'aioredis'``,
            or ``'aiomongo'`` configs.
        prepickle: Pickle keys to bytes before storing (defaults True for
            aioredis, mirroring ``datasketch/aio/lsh.py:66``).
        hashfunc: Optional bytes->bytes compressor for band keys.
        batch_size: Write-buffer depth for service-backed storages.
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
        batch_size: int = 10000,
    ) -> None:
        storage_config = storage_config if storage_config else {"type": "aiodict"}
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
                raise ValueError("b*r must be <= num_perm")
        else:
            fpw, fnw = weights
            self.b, self.r = optimal_param(threshold, num_perm, fpw, fnw)

        self.prepickle = (
            storage_config["type"] == "aioredis" if prepickle is None else prepickle
        )
        # Service-backed storages need bytes keys when prepickle is off
        # (reference aio/lsh.py:67,251-254); the in-memory aiodict is
        # exempt, mirroring the host class's dict exemption.
        self._require_bytes_keys = (
            not self.prepickle and storage_config["type"] != "aiodict"
        )
        self.hashfunc = hashfunc

        self._storage_config = storage_config
        self._batch_size = batch_size
        basename = storage_config.get("basename", _random_name(11))
        if isinstance(basename, str):
            basename = basename.encode("ascii")
        self._basename = basename
        self.hashranges = [(i * self.r, (i + 1) * self.r) for i in range(self.b)]
        self._make_storages()
        self._initialized = False
        self._init_lock = asyncio.Lock()

    def _make_storages(self) -> None:
        """(Re)create the storage objects from the persisted identity
        (basename + config) — also the unpickle path, where reconnected
        storages must resolve the SAME namespaces the data was written
        under."""
        self.hashtables = [
            async_unordered_storage(
                self._storage_config,
                name=b"".join(
                    [self._basename, b"_bucket_", struct.pack(">H", i)]
                ),
                batch_size=self._batch_size,
            )
            for i in range(self.b)
        ]
        self.keys = async_ordered_storage(
            self._storage_config,
            name=b"".join([self._basename, b"_keys"]),
            batch_size=self._batch_size,
        )

    def __getstate__(self):
        """Pickling parity (reference aio/lsh.py:111-126): drop live
        connections and locks; service-backed storages are rebuilt on
        unpickle from the persisted basename/config (the data lives
        server-side). The in-memory aiodict backend's data lives IN the
        storages, so those pickle along — dropping them would silently
        lose the whole index."""
        state = self.__dict__.copy()
        state["_initialized"] = False
        state.pop("_init_lock", None)
        if self._storage_config["type"] != "aiodict":
            state.pop("hashtables", None)
            state.pop("keys", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._init_lock = asyncio.Lock()
        if "hashtables" not in self.__dict__:
            self._make_storages()

    # ------------------------------------------------------------ lifecycle

    async def _init_storages(self):
        async with self._init_lock:
            if not self._initialized:
                await asyncio.gather(
                    self.keys.init(), *[t.init() for t in self.hashtables]
                )
                self._initialized = True
        return self

    def __await__(self):
        return self._init_storages().__await__()

    async def __aenter__(self):
        return await self._init_storages()

    async def __aexit__(self, exc_type, exc_val, exc_tb):
        await self.close()

    async def close(self):
        await asyncio.gather(
            self.keys.close(), *[t.close() for t in self.hashtables]
        )

    # ------------------------------------------------------------- band keys

    def _H(self, hs) -> bytes:
        data = bytes(np.asarray(hs).byteswap().data)
        return self.hashfunc(data) if self.hashfunc else data

    def _band_keys(self, minhash) -> list:
        hv = minhash.hashvalues
        return [self._H(hv[start:end]) for start, end in self.hashranges]

    # --------------------------------------------------------------- mutation

    async def insert(self, key: Hashable, minhash, check_duplication: bool = True):
        """Index `key` under the given signature (aio/lsh.py:248-270)."""
        await self._insert(key, minhash, check_duplication=check_duplication)

    async def _insert(self, key, minhash, check_duplication=True, buffer=False):
        await self._init_storages()
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
        if check_duplication and await self.keys.has_key(key):
            raise ValueError("The given key already exists")
        Hs = self._band_keys(minhash)
        await asyncio.gather(
            self.keys.insert(key, *Hs, buffer=buffer),
            *[
                table.insert(H, key, buffer=buffer)
                for H, table in zip(Hs, self.hashtables)
            ],
        )

    async def remove(self, key: Hashable):
        """Remove `key`, pruning emptied buckets (aio/lsh.py:294-318)."""
        await self._remove(key)

    async def _remove(self, key, buffer=False):
        await self._init_storages()
        if self.prepickle:
            key = pickle.dumps(key)
        if not await self.keys.has_key(key):
            raise ValueError("The given key does not exist")
        Hs = await self.keys.get(key)

        async def _remove_band(H, table):
            await table.remove_val(H, key, buffer=buffer)
            if not await table.get(H):
                await table.remove(H, buffer=buffer)

        await asyncio.gather(
            *[_remove_band(H, t) for H, t in zip(Hs, self.hashtables)]
        )
        await self.keys.remove(key, buffer=buffer)

    # ----------------------------------------------------------------- query

    async def query(self, minhash) -> list:
        """Candidate keys whose Jaccard with `minhash` likely >= threshold."""
        await self._init_storages()
        if len(minhash) != self.h:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.h, len(minhash))
            )
        Hs = self._band_keys(minhash)
        buckets = await asyncio.gather(
            *[table.get(H) for H, table in zip(Hs, self.hashtables)]
        )
        candidates = set()
        for bucket in buckets:
            candidates.update(bucket)
        if self.prepickle:
            return [pickle.loads(k) for k in candidates]
        return list(candidates)

    async def _query_b(self, minhash, b) -> set:
        """First-b-bands query used by containment search (lsh.py:545-558)."""
        await self._init_storages()
        if len(minhash) != self.h:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.h, len(minhash))
            )
        if b > len(self.hashtables):
            raise ValueError("b must be less or equal to the number of hash tables")
        Hs = self._band_keys(minhash)[:b]
        buckets = await asyncio.gather(
            *[table.get(H) for H, table in zip(Hs, self.hashtables[:b])]
        )
        candidates = set()
        for bucket in buckets:
            candidates.update(bucket)
        return candidates

    async def has_key(self, key) -> bool:
        await self._init_storages()
        if self.prepickle:
            key = pickle.dumps(key)
        return await self.keys.has_key(key)

    async def is_empty(self) -> bool:
        await self._init_storages()
        sizes = await asyncio.gather(*[t.size() for t in self.hashtables])
        return any(s == 0 for s in sizes)

    async def get_counts(self) -> list:
        """Bucket-size histogram per table (lsh.py:560-570)."""
        await self._init_storages()
        return list(
            await asyncio.gather(*[t.itemcounts() for t in self.hashtables])
        )

    async def get_subset_counts(self, *keys) -> list:
        """Bucket counts restricted to the given keys (lsh.py:572-589).

        Input keys are deduplicated and each bucket counts distinct keys
        (set semantics) — matching the host class and the reference,
        which insert into set-valued dict storage.
        """
        await self._init_storages()
        if self.prepickle:
            key_set = [pickle.dumps(k) for k in set(keys)]
        else:
            key_set = list(set(keys))
        key_hs = await asyncio.gather(*[self.keys.get(k) for k in key_set])
        members = [dict() for _ in self.hashtables]
        for key, Hs in zip(key_set, key_hs):
            for i, H in enumerate(Hs):
                members[i].setdefault(H, set()).add(key)
        return [
            {H: len(ks) for H, ks in table.items()} for table in members
        ]

    # -------------------------------------------------------------- sessions

    def insertion_session(self, batch_size: Optional[int] = None):
        """``async with lsh.insertion_session() as s: await s.insert(...)``."""
        return AsyncMinHashLSHInsertionSession(self, batch_size)

    def deletion_session(self, batch_size: Optional[int] = None):
        return AsyncMinHashLSHDeletionSession(self, batch_size)

    def delete_session(self, batch_size: Optional[int] = None):
        """Reference spelling (``aio/lsh.py:214``) of
        :meth:`deletion_session`."""
        return self.deletion_session(batch_size)


class AsyncMinHashLSHInsertionSession:
    """Buffered inserts, flushed on exit (aio/lsh.py:357-379)."""

    def __init__(self, lsh: AsyncMinHashLSH, batch_size: Optional[int]):
        self.lsh = lsh
        if batch_size:
            for t in lsh.hashtables:
                t._batch_size = batch_size
            lsh.keys._batch_size = batch_size

    async def __aenter__(self):
        await self.lsh._init_storages()
        return self

    async def __aexit__(self, exc_type, exc_val, exc_tb):
        await self.close()

    async def close(self):
        await asyncio.gather(
            self.lsh.keys.empty_buffer(),
            *[t.empty_buffer() for t in self.lsh.hashtables],
        )

    async def insert(self, key, minhash, check_duplication=True):
        await self.lsh._insert(
            key, minhash, check_duplication=check_duplication, buffer=True
        )


class AsyncMinHashLSHDeletionSession:
    """Buffered removals, flushed on exit (aio/lsh.py:382-398)."""

    def __init__(self, lsh: AsyncMinHashLSH, batch_size: Optional[int]):
        self.lsh = lsh
        if batch_size:
            for t in lsh.hashtables:
                t._batch_size = batch_size
            lsh.keys._batch_size = batch_size

    async def __aenter__(self):
        await self.lsh._init_storages()
        return self

    async def __aexit__(self, exc_type, exc_val, exc_tb):
        await self.close()

    async def close(self):
        await asyncio.gather(
            self.lsh.keys.empty_buffer(),
            *[t.empty_buffer() for t in self.lsh.hashtables],
        )

    async def remove(self, key):
        await self.lsh._remove(key, buffer=True)


# Name parity with the reference (aio/lsh.py:379 calls this class
# AsyncMinHashLSHDeleteSession).
AsyncMinHashLSHDeleteSession = AsyncMinHashLSHDeletionSession
