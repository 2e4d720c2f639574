"""Async storage backends for AsyncMinHashLSH.

Mirrors the reference's async storage layer (``datasketch/
aio/storage.py``): factories dispatch on ``config["type"]`` —

- ``aiodict``   — in-memory asyncio-safe dict storage (new in this build;
  the async analogue of ``{'type': 'dict'}``),
- ``aioredis``  — redis.asyncio, gated on the ``redis`` package
  (reference ``aio/storage.py:31-38,313-472``),
- ``aiomongo``  — motor, gated on the ``motor`` package
  (reference ``aio/storage.py:24-29,73-308``).

Like the reference, writes are buffered per-storage and flushed by
``empty_buffer`` (motor command buffers at ``aio/storage.py:75-127``,
redis pipelines at ``aio/storage.py:330-360``).
"""

from __future__ import annotations

import os
from abc import ABCMeta, abstractmethod
from collections import defaultdict

__all__ = [
    "async_ordered_storage",
    "async_unordered_storage",
    "AsyncStorage",
    "AsyncOrderedStorage",
    "AsyncUnorderedStorage",
    "AsyncDictListStorage",
    "AsyncDictSetStorage",
]


def async_ordered_storage(config, name=None, batch_size=10000):
    """Factory mirroring ``datasketch/aio/storage.py:47-57``."""
    tp = config.get("type", "aiodict")
    if tp == "aiodict":
        return AsyncDictListStorage(config, name=name)
    if tp == "aioredis":
        return AsyncRedisListStorage(config, name=name, batch_size=batch_size)
    if tp == "aiomongo":
        return AsyncMongoListStorage(config, name=name, batch_size=batch_size)
    raise ValueError("Unknown async storage type: %r" % (tp,))


def async_unordered_storage(config, name=None, batch_size=10000):
    """Factory mirroring ``datasketch/aio/storage.py:60-70``."""
    tp = config.get("type", "aiodict")
    if tp == "aiodict":
        return AsyncDictSetStorage(config, name=name)
    if tp == "aioredis":
        return AsyncRedisSetStorage(config, name=name, batch_size=batch_size)
    if tp == "aiomongo":
        return AsyncMongoSetStorage(config, name=name, batch_size=batch_size)
    raise ValueError("Unknown async storage type: %r" % (tp,))


class AsyncStorage(metaclass=ABCMeta):
    """Async mirror of :class:`datasketch_tpu_torch.storage.Storage`."""

    def __init__(self, config, name=None):
        self._config = config
        self._name = name or b"storage"
        self._initialized = False

    async def init(self):
        """Connect/create resources. Idempotent."""
        self._initialized = True
        return self

    async def close(self):
        return None

    @abstractmethod
    async def keys(self):
        ...

    @abstractmethod
    async def get(self, key):
        ...

    async def getmany(self, *keys):
        return [await self.get(k) for k in keys]

    @abstractmethod
    async def insert(self, key, *vals, buffer=False):
        ...

    @abstractmethod
    async def remove(self, *keys, buffer=False):
        ...

    @abstractmethod
    async def remove_val(self, key, val, buffer=False):
        ...

    @abstractmethod
    async def size(self):
        ...

    @abstractmethod
    async def itemcounts(self):
        ...

    @abstractmethod
    async def has_key(self, key):
        ...

    async def empty_buffer(self):
        return None

    async def status(self):
        return {"keyspace_size": await self.size()}


class AsyncOrderedStorage(AsyncStorage):
    pass


class AsyncUnorderedStorage(AsyncStorage):
    pass


# --------------------------------------------------------------- in-memory


class AsyncDictListStorage(AsyncOrderedStorage):
    """defaultdict(list) behind the async interface.

    The async analogue of ``DictListStorage``
    (``datasketch/storage.py:209-243``); all operations are
    synchronous under the hood but awaitable, so AsyncMinHashLSH works with
    no external services.
    """

    def __init__(self, config, name=None):
        super().__init__(config, name=name)
        self._dict = defaultdict(list)

    async def keys(self):
        return list(self._dict.keys())

    async def get(self, key):
        return self._dict.get(key, [])

    async def insert(self, key, *vals, buffer=False):
        self._dict[key].extend(vals)

    async def remove(self, *keys, buffer=False):
        for key in keys:
            self._dict.pop(key, None)

    async def remove_val(self, key, val, buffer=False):
        if key in self._dict:
            try:
                self._dict[key].remove(val)
            except ValueError:
                pass
            if not self._dict[key]:
                del self._dict[key]

    async def size(self):
        return len(self._dict)

    async def itemcounts(self):
        return {k: len(v) for k, v in self._dict.items()}

    async def has_key(self, key):
        return key in self._dict


class AsyncDictSetStorage(AsyncUnorderedStorage, AsyncDictListStorage):
    """defaultdict(set) behind the async interface
    (cf. ``datasketch/storage.py:246-259``)."""

    def __init__(self, config, name=None):
        AsyncDictListStorage.__init__(self, config, name=name)
        self._dict = defaultdict(set)

    async def get(self, key):
        return self._dict.get(key, set())

    async def insert(self, key, *vals, buffer=False):
        self._dict[key].update(vals)

    async def remove_val(self, key, val, buffer=False):
        if key in self._dict:
            self._dict[key].discard(val)
            if not self._dict[key]:
                del self._dict[key]


# ------------------------------------------------------------------ aioredis


def _parse_env_config(cfg):
    """Env-var indirection, mirroring ``storage.py:907-919`` of the ref
    (same mechanism for redis AND mongo configs — the reference resolves
    ``{'env': ..., 'default': ...}`` dicts in both)."""
    out = {}
    for key, value in cfg.items():
        if isinstance(value, dict) and "env" in value:
            value = os.environ.get(value["env"], value.get("default"))
        out[key] = value
    return out


_parse_redis_config = _parse_env_config  # historical name


class AsyncRedisStorage(AsyncStorage):
    """Base for redis.asyncio-backed storages (requires ``redis>=4.2``).

    Mirrors ``datasketch/aio/storage.py:313-382``: keys are
    namespaced as ``<name>/<key>``; writes optionally buffer into a pipeline
    flushed at ``batch_size`` or by ``empty_buffer``.
    """

    def __init__(self, config, name=None, batch_size=10000):
        super().__init__(config, name=name)
        try:
            import redis.asyncio as aioredis  # noqa: F401
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError(
                "aioredis storage requested but the 'redis' package "
                "(>=4.2, with redis.asyncio) is not installed"
            ) from exc
        self._aioredis = aioredis
        self._params = _parse_redis_config(config.get("redis", {}))
        self._batch_size = batch_size
        self._redis = None
        self._pipe = None

    async def init(self):
        if self._redis is None:
            self._redis = self._aioredis.Redis(**self._params)
            self._pipe = self._redis.pipeline()
            self._pipe_len = 0
        self._initialized = True
        return self

    async def close(self):
        if self._redis is not None:
            await self.empty_buffer()
            await self._redis.aclose()
            self._redis = None

    def redis_key(self, key):
        name = self._name if isinstance(self._name, bytes) else self._name.encode()
        return name + b"/" + key

    async def _maybe_flush(self):
        self._pipe_len += 1
        if self._pipe_len >= self._batch_size:
            await self.empty_buffer()

    async def empty_buffer(self):
        if self._pipe is not None and self._pipe_len:
            await self._pipe.execute()
            self._pipe_len = 0

    async def keys(self):
        from datasketch_tpu_torch.storage import glob_escaped_prefix_pattern

        name = self._name if isinstance(self._name, bytes) else self._name.encode()
        ks = await self._redis.keys(glob_escaped_prefix_pattern(name + b"/"))
        return [k[len(name) + 1 :] for k in ks]

    async def size(self):
        return len(await self.keys())

    async def has_key(self, key):
        return bool(await self._redis.exists(self.redis_key(key)))


class AsyncRedisListStorage(AsyncRedisStorage, AsyncOrderedStorage):
    async def get(self, key):
        return await self._redis.lrange(self.redis_key(key), 0, -1)

    async def insert(self, key, *vals, buffer=False):
        target = self._pipe if buffer else self._redis
        if vals:
            await target.rpush(self.redis_key(key), *vals)
        if buffer:
            await self._maybe_flush()

    async def remove(self, *keys, buffer=False):
        if not keys:
            return
        target = self._pipe if buffer else self._redis
        await target.delete(*[self.redis_key(k) for k in keys])
        if buffer:
            await self._maybe_flush()

    async def remove_val(self, key, val, buffer=False):
        target = self._pipe if buffer else self._redis
        await target.lrem(self.redis_key(key), 1, val)
        if buffer:
            await self._maybe_flush()

    async def itemcounts(self):
        return {k: await self._redis.llen(self.redis_key(k)) for k in await self.keys()}


class AsyncRedisSetStorage(AsyncRedisStorage, AsyncUnorderedStorage):
    async def get(self, key):
        return await self._redis.smembers(self.redis_key(key))

    async def insert(self, key, *vals, buffer=False):
        target = self._pipe if buffer else self._redis
        if vals:
            await target.sadd(self.redis_key(key), *vals)
        if buffer:
            await self._maybe_flush()

    async def remove(self, *keys, buffer=False):
        if not keys:
            return
        target = self._pipe if buffer else self._redis
        await target.delete(*[self.redis_key(k) for k in keys])
        if buffer:
            await self._maybe_flush()

    async def remove_val(self, key, val, buffer=False):
        target = self._pipe if buffer else self._redis
        await target.srem(self.redis_key(key), val)
        if buffer:
            await self._maybe_flush()

    async def itemcounts(self):
        return {
            k: await self._redis.scard(self.redis_key(k)) for k in await self.keys()
        }


# ------------------------------------------------------------------ aiomongo


class AsyncMongoStorage(AsyncStorage):
    """Base for motor-backed storages (requires ``motor``).

    Mirrors ``datasketch/aio/storage.py:129-308``: one
    collection ``lsh_<name>`` per storage, documents ``{key, vals}``, an
    index on ``key``, and command-typed write buffers flushed at
    ``batch_size``.
    """

    def __init__(self, config, name=None, batch_size=10000):
        super().__init__(config, name=name)
        try:
            import motor.motor_asyncio as motor_asyncio  # noqa: F401
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError(
                "aiomongo storage requested but the 'motor' package is not installed"
            ) from exc
        self._motor = motor_asyncio
        # env-dict values ({'env': ..., 'default': ...}) resolve here, not
        # at DSN build time — a raw dict in the DSN is a garbage URL
        self._mongo_cfg = _parse_env_config(config.get("mongo", {}))
        self._batch_size = batch_size
        self._client = None
        self._collection = None
        self._buffer = []

    def _collection_name(self):
        """Reference collection-naming contract
        (``datasketch/aio/storage.py:158-163``):
        explicit ``collection_name`` > ``collection_prefix + name`` >
        ``lsh_<name>``."""
        cfg = self._mongo_cfg
        if "collection_name" in cfg:
            return cfg["collection_name"]
        name = self._name
        if isinstance(name, bytes):
            name = name.decode("latin1")
        if "collection_prefix" in cfg:
            return cfg["collection_prefix"] + name
        return "lsh_" + name

    def _dsn(self) -> str:
        """The reference's DSN forms (aio/storage.py:165-175): url >
        replica set > username/password > host:port."""
        cfg = self._mongo_cfg
        if "url" in cfg:
            return cfg["url"]
        if "replica_set" in cfg:
            return "mongodb://{replica_set_nodes}/?replicaSet={replica_set}".format(
                **cfg
            )
        if "username" in cfg or "password" in cfg:
            return "mongodb://{username}:{password}@{host}:{port}".format(**cfg)
        return "mongodb://{host}:{port}".format(
            host=cfg.get("host", "localhost"), port=cfg.get("port", 27017)
        )

    async def init(self):
        if self._client is None:
            cfg = self._mongo_cfg
            db_name = cfg.get("db", "db_0")
            self._client = self._motor.AsyncIOMotorClient(
                self._dsn(), **cfg.get("args", {})
            )
            # a db embedded in the url path takes precedence over db_name
            db = self._client.get_default_database(db_name)
            self._collection = db.get_collection(self._collection_name())
            await self._collection.create_index("key", background=True)
        self._initialized = True
        return self

    async def close(self):
        if self._client is not None:
            await self.empty_buffer()
            self._client.close()
            self._client = None

    async def empty_buffer(self):
        if self._buffer:
            ops, self._buffer = self._buffer, []
            await self._collection.bulk_write(ops, ordered=False)

    async def _push(self, op, buffer):
        if buffer:
            self._buffer.append(op)
            if len(self._buffer) >= self._batch_size:
                await self.empty_buffer()
        else:
            await self._collection.bulk_write([op], ordered=False)

    async def keys(self):
        return await self._collection.distinct("key")

    async def size(self):
        keys = await self.keys()
        return len(keys)

    async def has_key(self, key):
        return await self._collection.count_documents({"key": key}, limit=1) > 0

    async def itemcounts(self):
        out = {}
        pipeline = [{"$group": {"_id": "$key", "count": {"$sum": 1}}}]
        async for doc in self._collection.aggregate(pipeline):
            out[doc["_id"]] = doc["count"]
        return out


class AsyncMongoListStorage(AsyncMongoStorage, AsyncOrderedStorage):
    async def get(self, key):
        return [
            doc["val"]
            async for doc in self._collection.find({"key": key}, {"val": 1})
        ]

    async def insert(self, key, *vals, buffer=False):
        import pymongo

        for val in vals:
            await self._push(
                pymongo.InsertOne({"key": key, "val": val}), buffer=buffer
            )

    async def remove(self, *keys, buffer=False):
        import pymongo

        for key in keys:
            await self._push(pymongo.DeleteMany({"key": key}), buffer=buffer)

    async def remove_val(self, key, val, buffer=False):
        import pymongo

        await self._push(
            pymongo.DeleteOne({"key": key, "val": val}), buffer=buffer
        )


class AsyncMongoSetStorage(AsyncMongoStorage, AsyncUnorderedStorage):
    async def get(self, key):
        return {
            doc["val"]
            async for doc in self._collection.find({"key": key}, {"val": 1})
        }

    async def insert(self, key, *vals, buffer=False):
        import pymongo

        for val in vals:
            await self._push(
                pymongo.UpdateOne(
                    {"key": key, "val": val},
                    {"$setOnInsert": {"key": key, "val": val}},
                    upsert=True,
                ),
                buffer=buffer,
            )

    async def remove(self, *keys, buffer=False):
        import pymongo

        for key in keys:
            await self._push(pymongo.DeleteMany({"key": key}), buffer=buffer)

    async def remove_val(self, key, val, buffer=False):
        import pymongo

        await self._push(
            pymongo.DeleteOne({"key": key, "val": val}), buffer=buffer
        )
