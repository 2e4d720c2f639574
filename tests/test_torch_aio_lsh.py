"""Port parity: AsyncMinHashLSH on the in-memory ``aiodict`` backend and on
the fake motor client of the JAX package's tests, against the JAX
package's AsyncMinHashLSH on the same seeded signatures -- answers, counts
and membership exactly equal; the deprecated ``experimental`` paths warn
and forward. Async code runs via ``asyncio.run`` (no plugin)."""

import asyncio
import sys
import types
import warnings

import numpy as np
import pytest

import datasketch_tpu as J
import datasketch_tpu_torch as T
from tests import fake_motor

P = 128


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 4, size=(n, P)).astype(np.uint64) * np.uint64(0x85EBCA6B)


def _objs(pkg, rows):
    return [pkg.MinHash(num_perm=P, hashvalues=r) for r in rows]


@pytest.fixture()
def fake_motor_modules(monkeypatch):
    fake_motor.FakeMotorClient._dbs = {}
    motor_mod = types.ModuleType("motor")
    motor_asyncio = types.ModuleType("motor.motor_asyncio")
    motor_asyncio.AsyncIOMotorClient = fake_motor.FakeMotorClient
    motor_mod.motor_asyncio = motor_asyncio
    pymongo_mod = types.ModuleType("pymongo")
    pymongo_mod.InsertOne = fake_motor.FakeInsertOne
    pymongo_mod.UpdateOne = fake_motor.FakeUpdateOne
    pymongo_mod.DeleteMany = fake_motor.FakeDeleteMany
    pymongo_mod.DeleteOne = fake_motor.FakeDeleteOne
    monkeypatch.setitem(sys.modules, "motor", motor_mod)
    monkeypatch.setitem(sys.modules, "motor.motor_asyncio", motor_asyncio)
    monkeypatch.setitem(sys.modules, "pymongo", pymongo_mod)


async def _drive(pkg, config, rows, keys):
    """One fixed sequence of calls; returns every answer it read."""
    objs = _objs(pkg, rows)
    seen = []
    async with pkg.AsyncMinHashLSH(threshold=0.5, num_perm=P, prepickle=True,
                                   storage_config=config) as lsh:
        seen.append((lsh.b, lsh.r))
        for key, m in zip(keys[:40], objs[:40]):
            await lsh.insert(key, m)
        async with lsh.insertion_session(batch_size=7) as session:
            for key, m in zip(keys[40:], objs[40:]):
                await session.insert(key, m)
        with pytest.raises(ValueError):
            await lsh.insert(keys[0], objs[0])
        seen.append([sorted(await lsh.query(m)) for m in objs[::5]])
        seen.append(sorted(await lsh._query_b(objs[3], 4)))
        seen.append(await lsh.get_counts())
        seen.append(await lsh.get_subset_counts(*keys[::9]))
        for key in keys[::4]:
            await lsh.remove(key)
        async with lsh.delete_session(batch_size=5) as session:
            for key in keys[1::4]:
                await session.remove(key)
        seen.append([sorted(await lsh.query(m)) for m in objs[::5]])
        seen.append([await lsh.has_key(k) for k in keys])
        seen.append(await lsh.is_empty())
    return seen


def test_async_lsh_on_aiodict_matches_jax_and_host_lsh():
    rows = _rows(100, 1)
    keys = [f"a{i}" for i in range(len(rows))]
    config = {"type": "aiodict", "basename": b"x"}
    want = asyncio.run(_drive(J, dict(config), rows, keys))
    got = asyncio.run(_drive(T, dict(config), rows, keys))
    assert got == want
    host = T.MinHashLSH(threshold=0.5, num_perm=P)
    host.insert_batch(keys, _objs(T, rows))
    assert [sorted(a) for a in host.query_batch(_objs(T, rows[::5]))] == got[1]


def test_async_lsh_on_fake_mongo_matches_jax(fake_motor_modules):
    rows = _rows(60, 2)
    keys = [f"m{i}" for i in range(len(rows))]
    want = asyncio.run(_drive(J, {"type": "aiomongo", "mongo": {"db": "jx"},
                                  "basename": b"j"}, rows, keys))
    got = asyncio.run(_drive(T, {"type": "aiomongo", "mongo": {"db": "pt"},
                                 "basename": b"t"}, rows, keys))
    assert got == want


def test_async_storages_and_gating():
    from datasketch_tpu_torch.aio.storage import async_ordered_storage, async_unordered_storage

    async def go():
        s = async_ordered_storage({"type": "aiodict"}, name=b"t")
        await s.init()
        await s.insert(b"k", b"v1", b"v2")
        u = async_unordered_storage({"type": "aiodict"}, name=b"t2")
        await u.init()
        await u.insert(b"k", b"v", b"v")
        return await s.get(b"k"), await s.itemcounts(), await u.get(b"k")

    assert asyncio.run(go()) == ([b"v1", b"v2"], {b"k": 2}, {b"v"})
    with pytest.raises(ValueError):
        async_ordered_storage({"type": "bogus"})
    with pytest.raises(ImportError):
        T.ordered_storage({"type": "cassandra", "cassandra": {}}, name=b"x")


def test_experimental_paths_warn_and_forward():
    import datasketch_tpu_torch.aio.lsh as real
    import datasketch_tpu_torch.experimental as exp
    import datasketch_tpu_torch.experimental.aio.lsh as shim

    exp.__dict__.pop("aio", None)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        aio = exp.aio
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert aio.AsyncMinHashLSH is T.AsyncMinHashLSH
    for name in shim.__all__:
        shim.__dict__.pop(name, None)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert getattr(shim, name) is getattr(real, name)
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert real.AsyncMinHashLSHDeleteSession is real.AsyncMinHashLSHDeletionSession
    with pytest.raises(AttributeError):
        shim.does_not_exist
