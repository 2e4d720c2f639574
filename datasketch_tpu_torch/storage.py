"""Pluggable storage layer for the LSH indexes.

Mirrors the abstract interface of ``datasketch/storage.py:106-205``
(``Storage`` / ``OrderedStorage`` / ``UnorderedStorage`` with config-dict
factories) so user code written against the reference drops in unchanged.

Backends:
- ``dict`` — in-memory defaultdict backends (storage.py:209-259 parity).
- ``redis`` — optional, gated on the ``redis`` package being importable.
- ``cassandra`` — optional, gated on ``cassandra-driver``.

Copied from the JAX package's ``storage.py``. The card-side scale-out path
does NOT live here: device-resident band tables
(:mod:`datasketch_tpu_torch.ops.lsh_ops`) replace the reference's
Redis/Cassandra story for on-card serving. This module exists for
API-compatible host-side indexes and external persistence. The optional
client packages are imported only when such a storage is created; the
Cassandra keyspace default stays the JAX package's, so both read one table.
"""

from __future__ import annotations

import os
from abc import ABCMeta, abstractmethod
from collections import defaultdict

__all__ = [
    "ordered_storage",
    "unordered_storage",
    "Storage",
    "OrderedStorage",
    "UnorderedStorage",
    "DictListStorage",
    "DictSetStorage",
    "CassandraListStorage",
    "CassandraSetStorage",
]


def ordered_storage(config, name=None):
    """Create an ordered storage (list-valued) from a config dict.

    Config parity with ``datasketch/storage.py:29-64``:
    ``{'type': 'dict'}`` or ``{'type': 'redis', 'redis': {...}}``.
    """
    tp = config["type"]
    if tp == "dict":
        return DictListStorage(config)
    if tp == "redis":
        return RedisListStorage(config, name=name)
    if tp == "cassandra":
        return CassandraListStorage(config, name=name)
    raise ValueError("Unknown storage type: %s" % tp)


def unordered_storage(config, name=None):
    """Create an unordered storage (set-valued) from a config dict."""
    tp = config["type"]
    if tp == "dict":
        return DictSetStorage(config)
    if tp == "redis":
        return RedisSetStorage(config, name=name)
    if tp == "cassandra":
        return CassandraSetStorage(config, name=name)
    raise ValueError("Unknown storage type: %s" % tp)


class Storage(metaclass=ABCMeta):
    """Key -> container-of-values store (storage.py:106-198 interface)."""

    def __getitem__(self, key):
        return self.get(key)

    def __delitem__(self, key):
        return self.remove(key)

    def __len__(self):
        return self.size()

    def __iter__(self):
        for key in self.keys():
            yield key

    def __contains__(self, item):
        return self.has_key(item)

    @abstractmethod
    def keys(self):
        """Return an iterator of all keys."""

    @abstractmethod
    def get(self, key):
        """Get the container of values for `key`; empty container if absent."""

    def getmany(self, *keys):
        return [self.get(key) for key in keys]

    @abstractmethod
    def insert(self, key, *vals, **kwargs):
        """Add `vals` to the container at `key`, creating it if absent."""

    @abstractmethod
    def remove(self, *keys, **kwargs):
        """Remove `keys` entirely."""

    @abstractmethod
    def remove_val(self, key, val, **kwargs):
        """Remove `val` from the container at `key`."""

    @abstractmethod
    def size(self):
        """Number of keys."""

    @abstractmethod
    def itemcounts(self, **kwargs):
        """Dict of key -> number of values."""

    @abstractmethod
    def has_key(self, key):
        """Whether `key` exists."""

    def status(self):
        return {"keyspace_size": len(self)}

    def empty_buffer(self):
        pass

    def add_to_select_buffer(self, keys):
        """Queue keys for a batched select (parity: storage.py:185-192)."""
        if not hasattr(self, "_select_buffer"):
            self._select_buffer = []
        self._select_buffer.extend(keys)

    def collect_select_buffer(self):
        """Fetch all buffered selects and clear the buffer."""
        if not hasattr(self, "_select_buffer"):
            return []
        results = self.getmany(*self._select_buffer)
        self._select_buffer = []
        return results


class OrderedStorage(Storage):
    """Storage whose value containers preserve insertion order."""


class UnorderedStorage(Storage):
    """Storage whose value containers are sets."""


class DictListStorage(OrderedStorage):
    """defaultdict(list)-backed ordered storage (storage.py:209-233)."""

    def __init__(self, config):
        self._dict = defaultdict(list)

    def keys(self):
        return self._dict.keys()

    def get(self, key):
        return self._dict.get(key, [])

    def remove(self, *keys, **kwargs):
        for key in keys:
            del self._dict[key]

    def remove_val(self, key, val, **kwargs):
        self._dict[key].remove(val)

    def insert(self, key, *vals, **kwargs):
        self._dict[key].extend(vals)

    def size(self):
        return len(self._dict)

    def itemcounts(self, **kwargs):
        return {k: len(v) for k, v in self._dict.items()}

    def has_key(self, key):
        return key in self._dict


class DictSetStorage(UnorderedStorage, DictListStorage):
    """defaultdict(set)-backed unordered storage (storage.py:236-259)."""

    def __init__(self, config):
        self._dict = defaultdict(set)

    def get(self, key):
        return self._dict.get(key, set())

    def insert(self, key, *vals, **kwargs):
        self._dict[key].update(vals)


def glob_escaped_prefix_pattern(prefix: bytes) -> bytes:
    """Redis KEYS pattern matching exactly ``prefix*``.

    Storage names embed ``struct.pack('>H', band_index)`` bytes, so for
    b >= 43 bands the prefix contains glob metacharacters ('*' at 42,
    '?' at 63, '[' at 91, '\\\\' at 92) — unescaped, bucket 42's pattern
    would match EVERY bucket's keys. Shared by the sync and async redis
    storages so the escaping rules cannot drift.
    """
    specials = frozenset(b"*?[]\\")
    out = bytearray()
    for byte in prefix:
        if byte in specials:
            out.append(0x5C)  # backslash-escape (redis glob syntax)
        out.append(byte)
    out.append(0x2A)  # b"*"
    return bytes(out)


def _parse_redis_config(cfg):
    """Resolve env-var indirection in redis connection params.

    Parity with ``datasketch/storage.py:907-919``: values of
    the form ``{'env': 'NAME', 'default': x}`` are read from the process
    environment at parse time.
    """
    resolved = {}
    for key, value in cfg.items():
        if isinstance(value, dict) and "env" in value:
            value = os.getenv(value["env"], value.get("default", None))
        resolved[key] = value
    return resolved


class RedisStorage:
    """Base for Redis-backed storages (requires the ``redis`` package).

    Keys are namespaced under a ``name`` prefix the way the reference
    namespaces with ``basename`` (storage.py:856-905).
    """

    def __init__(self, config, name=None):
        try:
            import redis
        except ImportError as e:  # pragma: no cover - optional dep
            raise RuntimeError(
                "redis storage requested but the 'redis' package is not installed"
            ) from e
        self.config = config
        self._redis_params = _parse_redis_config(config["redis"])
        self._redis = redis.Redis(**self._redis_params)
        self._name = name if name is not None else os.urandom(8).hex().encode("ascii")
        if isinstance(self._name, str):
            self._name = self._name.encode("ascii")
        # Write pipeline auto-executed at buffer_size — the reference's
        # RedisBuffer (storage.py:821-844); used by insertion sessions.
        self._buffer_size = 50000
        self._pipe = self._redis.pipeline()
        self._pipe_len = 0

    @property
    def buffer_size(self):
        return self._buffer_size

    @buffer_size.setter
    def buffer_size(self, value):
        self._buffer_size = value

    def _target(self, buffer):
        """The connection to write through: pipeline when buffering."""
        return self._pipe if buffer else self._redis

    def _after_write(self, buffer):
        if buffer:
            self._pipe_len += 1
            if self._pipe_len >= self._buffer_size:
                self.empty_buffer()

    def empty_buffer(self):
        if self._pipe_len:
            self._pipe.execute()
            self._pipe_len = 0

    def redis_key(self, key):
        if not isinstance(key, bytes):
            # bytes(5) is b'\x00'*5 (silent collisions) and bytes('x')
            # raises a confusing encoding error — fail loudly instead;
            # MinHashLSH prepickles keys to bytes before they reach here.
            raise TypeError(
                "redis storage keys must be bytes, got %s"
                % type(key).__name__
            )
        return self._name + b"/" + key

    def _keys_pattern(self) -> bytes:
        return glob_escaped_prefix_pattern(self._name + b"/")

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_redis", None)
        state.pop("_pipe", None)
        return state

    def __setstate__(self, state):
        import redis  # reconnect on unpickle (storage.py:929-932)

        self.__dict__.update(state)
        self._redis = redis.Redis(**self._redis_params)
        self._pipe = self._redis.pipeline()
        self._pipe_len = 0


class RedisListStorage(RedisStorage, OrderedStorage):
    def keys(self):
        return [
            k[len(self._name) + 1 :]
            for k in self._redis.keys(self._keys_pattern())
        ]

    def get(self, key):
        return self._redis.lrange(self.redis_key(key), 0, -1)

    def getmany(self, *keys):
        # one pipelined round trip for the whole batch — the default
        # base-class loop would pay one network RTT per key
        pipe = self._redis.pipeline(transaction=False)
        for k in keys:
            pipe.lrange(self.redis_key(k), 0, -1)
        return pipe.execute()

    def insert(self, key, *vals, buffer=False, **kwargs):
        if vals:
            self._target(buffer).rpush(self.redis_key(key), *vals)
            self._after_write(buffer)

    def remove(self, *keys, buffer=False, **kwargs):
        if keys:
            self._target(buffer).delete(*[self.redis_key(k) for k in keys])
            self._after_write(buffer)

    def remove_val(self, key, val, buffer=False, **kwargs):
        self._target(buffer).lrem(self.redis_key(key), 1, val)
        self._after_write(buffer)

    def size(self):
        return len(self.keys())

    def itemcounts(self, **kwargs):
        return {k: self._redis.llen(self.redis_key(k)) for k in self.keys()}

    def has_key(self, key):
        return bool(self._redis.exists(self.redis_key(key)))


class RedisSetStorage(RedisStorage, UnorderedStorage):
    def keys(self):
        return [
            k[len(self._name) + 1 :]
            for k in self._redis.keys(self._keys_pattern())
        ]

    def get(self, key):
        return self._redis.smembers(self.redis_key(key))

    def getmany(self, *keys):
        pipe = self._redis.pipeline(transaction=False)
        for k in keys:
            pipe.smembers(self.redis_key(k))
        return pipe.execute()

    def insert(self, key, *vals, buffer=False, **kwargs):
        if vals:
            self._target(buffer).sadd(self.redis_key(key), *vals)
            self._after_write(buffer)

    def remove(self, *keys, buffer=False, **kwargs):
        if keys:
            self._target(buffer).delete(*[self.redis_key(k) for k in keys])
            self._after_write(buffer)

    def remove_val(self, key, val, buffer=False, **kwargs):
        self._target(buffer).srem(self.redis_key(key), val)
        self._after_write(buffer)

    def size(self):
        return len(self.keys())

    def itemcounts(self, **kwargs):
        return {k: self._redis.scard(self.redis_key(k)) for k in self.keys()}

    def has_key(self, key):
        return bool(self._redis.exists(self.redis_key(key)))


# ---------------------------------------------------------------- cassandra


class CassandraSharedSession:
    """One shared Cassandra cluster session per process.

    Mirrors ``datasketch/storage.py:264-313``: the client's
    session is expensive, so every CassandraStorage shares one, keyed by the
    frozen seed/keyspace config. Also hosts the optional process-wide write
    and select buffers (``shared_buffer: True`` lets every storage pool its
    statements so flush thresholds are reached sooner).
    """

    _session = None
    _session_config = None
    _shared_write_buffer: list = []
    _shared_select_buffer: list = []

    QUERY_CREATE_KEYSPACE = (
        "CREATE KEYSPACE IF NOT EXISTS {} WITH replication = {}"
    )
    QUERY_DROP_KEYSPACE = "DROP KEYSPACE IF EXISTS {}"

    @classmethod
    def get_session(cls, config):
        try:
            from cassandra.cluster import Cluster
        except ImportError as exc:  # pragma: no cover - gated dependency
            raise ImportError(
                "cassandra storage requested but the 'cassandra-driver' "
                "package is not installed"
            ) from exc
        frozen = tuple(sorted((k, str(v)) for k, v in config.items()))
        if cls._session is None or cls._session_config != frozen:
            cluster = Cluster(
                contact_points=config.get("seeds", ["localhost"]),
                port=config.get("port", 9042),
            )
            session = cluster.connect()
            keyspace = config.get("keyspace", "datasketch_tpu")
            replication = config.get(
                "replication",
                {"class": "SimpleStrategy", "replication_factor": "1"},
            )
            repl_cql = (
                "{"
                + ", ".join(
                    "'%s': '%s'" % (k, v) for k, v in sorted(replication.items())
                )
                + "}"
            )
            if config.get("drop_keyspace", False):
                session.execute(cls.QUERY_DROP_KEYSPACE.format(keyspace))
            session.execute(cls.QUERY_CREATE_KEYSPACE.format(keyspace, repl_cql))
            session.set_keyspace(keyspace)
            cls._session = session
            cls._session_config = frozen
        return cls._session


class CassandraStorage:
    """Base for Cassandra-backed storages (requires ``cassandra-driver``).

    Table layout parity with ``datasketch/storage.py:316-418``:
    one table ``lsh_<name>`` per storage with
    ``(key blob, value blob, ts bigint, PRIMARY KEY (key, value))``;
    upsert-as-set semantics with a monotonic timestamp ordering list values.

    Mechanics parity: every statement is PREPARED once per table; writes
    (and buffered writes honoring the ``buffer=`` kwarg) flush through
    ``execute_concurrent`` in chunks of :attr:`CONCURRENCY`; ``keys()``
    paginates with TOKEN() ranges so the full-scan can't time out; and
    ``itemcounts`` issues all COUNT queries in one concurrent pass.
    """

    DEFAULT_BUFFER_SIZE = 5000
    CONCURRENCY = 100
    PAGE_SIZE = 1024
    MIN_TOKEN = -(2**63)

    QUERY_CREATE_TABLE = (
        "CREATE TABLE IF NOT EXISTS {} "
        "(key blob, value blob, ts bigint, PRIMARY KEY (key, value)) "
        "WITH CLUSTERING ORDER BY (value DESC)"
    )
    QUERY_DROP_TABLE = "DROP TABLE IF EXISTS {}"
    QUERY_INSERT = "INSERT INTO {} (key, value, ts) VALUES (?, ?, ?)"
    QUERY_UPSERT = "UPDATE {} SET ts = ? WHERE key = ? AND value = ?"
    QUERY_SELECT = "SELECT key, value, ts FROM {} WHERE key = ?"
    QUERY_SELECT_ONE = "SELECT key FROM {} WHERE key = ? LIMIT 1"
    QUERY_COUNT = "SELECT key, COUNT(value) AS count FROM {} WHERE key = ?"
    QUERY_KEYS_PAGE = (
        "SELECT DISTINCT key, TOKEN(key) AS f_token FROM {} "
        "WHERE TOKEN(key) >= ? LIMIT ?"
    )
    QUERY_DELETE_KEY = "DELETE FROM {} WHERE key = ?"
    QUERY_DELETE_VAL = "DELETE FROM {} WHERE key = ? AND value = ?"

    def __init__(self, config, name=None, buffer_size=None):
        self._config = config
        self._name = name if name is not None else b"storage"
        self._buffer_size = (
            buffer_size if buffer_size is not None else self.DEFAULT_BUFFER_SIZE
        )
        self._connect()

    def _connect(self):
        cass_cfg = _parse_redis_config(self._config["cassandra"])
        raw = self._name
        if isinstance(raw, bytes):
            raw = raw.hex()
        self._table = "lsh_" + raw
        self._session = CassandraSharedSession.get_session(cass_cfg)
        if cass_cfg.get("drop_tables", False):
            self._session.execute(self.QUERY_DROP_TABLE.format(self._table))
        self._session.execute(self.QUERY_CREATE_TABLE.format(self._table))
        prepare = self._session.prepare
        self._stmt_insert = prepare(self.QUERY_INSERT.format(self._table))
        self._stmt_upsert = prepare(self.QUERY_UPSERT.format(self._table))
        self._stmt_select = prepare(self.QUERY_SELECT.format(self._table))
        self._stmt_select_one = prepare(self.QUERY_SELECT_ONE.format(self._table))
        self._stmt_count = prepare(self.QUERY_COUNT.format(self._table))
        self._stmt_keys_page = prepare(self.QUERY_KEYS_PAGE.format(self._table))
        self._stmt_delete_key = prepare(self.QUERY_DELETE_KEY.format(self._table))
        self._stmt_delete_val = prepare(self.QUERY_DELETE_VAL.format(self._table))
        self._ts = self._make_ts_generator()
        if cass_cfg.get("shared_buffer", False):
            self._write_buffer = CassandraSharedSession._shared_write_buffer
            self._select_pending = CassandraSharedSession._shared_select_buffer
        else:
            self._write_buffer = []
            self._select_pending = []

    @staticmethod
    def _make_ts_generator():
        """Wall-clock monotonic timestamps: values inserted by a later
        session must sort after an earlier session's (a plain counter
        restarts at 0 and breaks list ordering across reconnects)."""
        try:
            from cassandra.cluster import MonotonicTimestampGenerator

            return MonotonicTimestampGenerator()
        except Exception:
            import itertools
            import time

            return itertools.count(time.time_ns() // 1000).__next__

    @property
    def buffer_size(self):
        return self._buffer_size

    @buffer_size.setter
    def buffer_size(self, value):
        self._buffer_size = value

    def __getstate__(self):
        state = self.__dict__.copy()
        for ephemeral in [k for k in state if k not in
                          ("_config", "_name", "_buffer_size")]:
            state.pop(ephemeral)
        return state

    def __setstate__(self, state):
        self.__dict__ = state
        self._connect()

    # write/select pipelines -------------------------------------------------

    def _execute_concurrent(self, statements_and_params):
        """Fan statements out through the client's concurrent executor in
        bounded chunks; returns per-statement row lists (raises if any
        statement failed)."""
        from cassandra.concurrent import execute_concurrent

        out = []
        for i in range(0, len(statements_and_params), self.CONCURRENCY):
            chunk = statements_and_params[i : i + self.CONCURRENCY]
            for success, rows in execute_concurrent(
                self._session, chunk, concurrency=self.CONCURRENCY
            ):
                if not success:
                    raise RuntimeError("cassandra statement failed: %r" % (rows,))
                out.append(rows)
        return out

    def _write(self, statements_and_params, buffer=False):
        if buffer:
            self._write_buffer.extend(statements_and_params)
            if len(self._write_buffer) >= self._buffer_size:
                self.empty_buffer()
        else:
            self._execute_concurrent(statements_and_params)

    def empty_buffer(self):
        pending, self._write_buffer[:] = list(self._write_buffer), []
        if pending:
            self._execute_concurrent(pending)

    def add_to_select_buffer(self, keys):
        self._select_pending.extend(keys)

    def collect_select_buffer(self):
        if not self._select_pending:
            return []
        pending, self._select_pending[:] = list(self._select_pending), []
        results = self._execute_concurrent(
            [(self._stmt_select, (key,)) for key in pending]
        )
        return [self._rows_to_container(rows) for rows in results]

    # shared ops -------------------------------------------------------------

    def keys(self):
        """All keys via TOKEN()-paginated scans (an unpaged SELECT DISTINCT
        contacts every node at once and times out on real clusters)."""
        keys, token = [], self.MIN_TOKEN
        seen = set()
        while True:
            rows = list(
                self._session.execute(self._stmt_keys_page, (token, self.PAGE_SIZE))
            )
            if not rows:
                break
            for row in rows:
                if row.key not in seen:
                    seen.add(row.key)
                    keys.append(row.key)
                token = row.f_token + 1
        return keys

    def size(self):
        return len(self.keys())

    def has_key(self, key):
        rows = self._session.execute(self._stmt_select_one, (key,))
        return next(iter(rows), None) is not None

    def remove(self, *keys, **kwargs):
        self._write(
            [(self._stmt_delete_key, (key,)) for key in keys],
            buffer=kwargs.pop("buffer", False),
        )

    def remove_val(self, key, val, **kwargs):
        self._write(
            [(self._stmt_delete_val, (key, val))],
            buffer=kwargs.pop("buffer", False),
        )

    def itemcounts(self, **kwargs):
        """key -> value count in ONE concurrent pass (not N round trips)."""
        results = self._execute_concurrent(
            [(self._stmt_count, (key,)) for key in self.keys()]
        )
        return {row.key: row.count for rows in results for row in rows}

    def getmany(self, *keys):
        results = self._execute_concurrent(
            [(self._stmt_select, (key,)) for key in keys]
        )
        return [self._rows_to_container(rows) for rows in results]

    def get(self, key):
        return self.getmany(key)[0]

    def status(self):
        return {"keyspace_size": self.size()}


class CassandraListStorage(CassandraStorage, OrderedStorage):
    """Ordered (ts-sorted) values per key (storage.py:745-806 parity)."""

    @staticmethod
    def _rows_to_container(rows):
        return [r.value for r in sorted(rows, key=lambda r: r.ts)]

    def insert(self, key, *vals, **kwargs):
        self._write(
            [(self._stmt_insert, (key, val, self._ts())) for val in vals],
            buffer=kwargs.pop("buffer", False),
        )


class CassandraSetStorage(CassandraStorage, UnorderedStorage):
    """Set semantics via the (key, value) primary-key UPSERT: duplicates
    overwrite their own row's ts (storage.py:809-834 parity)."""

    @staticmethod
    def _rows_to_container(rows):
        return {r.value for r in rows}

    def insert(self, key, *vals, **kwargs):
        self._write(
            [(self._stmt_upsert, (self._ts(), key, val)) for val in vals],
            buffer=kwargs.pop("buffer", False),
        )
