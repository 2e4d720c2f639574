"""Port parity: the host MinHashLSH (dict, Redis and Cassandra storages),
its sessions and query buffer, WeightedMinHash rows and the host
MinHashLSHEnsemble against the JAX package's classes on the same seeded
signatures and ``basename`` -- answers, counts and band keys exactly equal.
The optional clients are the in-process fakes of the JAX package's own
storage tests, injected into ``sys.modules`` as those tests inject them."""

import hashlib
import sys
import types

import numpy as np
import pytest

import datasketch_tpu as J
import datasketch_tpu_torch as T
from datasketch_tpu import storage as jax_storage
from datasketch_tpu_torch import storage as torch_storage
from tests.fake_redis import FakeRedis
from tests.test_cassandra_storage import (
    FakeCluster,
    FakeMonotonicTs,
    FakeSession,
    fake_execute_concurrent,
)

P = 128


def _rows(n, seed, values=4):
    """uint64[n, P] signatures over a small slot alphabet, so band buckets
    collide and answers are not all singletons."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, values, size=(n, P)).astype(np.uint64) * np.uint64(0x9E3779B1)


def _objs(pkg, rows, lean=False):
    objs = [pkg.MinHash(num_perm=P, hashvalues=r) for r in rows]
    return [pkg.LeanMinHash(m) for m in objs] if lean else objs


def _sorted(answers):
    return [sorted(a, key=repr) for a in answers]


def _band_keys(lsh):
    return [sorted(t.keys()) for t in lsh.hashtables]


def _pair(config, **kw):
    return (J.MinHashLSH(threshold=0.5, num_perm=P, storage_config=dict(config), **kw),
            T.MinHashLSH(threshold=0.5, num_perm=P, storage_config=dict(config), **kw))


def _same_answers(j, t, q_rows, keys_subset):
    jq, tq = _objs(J, q_rows), _objs(T, q_rows)
    assert _sorted([j.query(m) for m in jq]) == _sorted([t.query(m) for m in tq])
    assert _sorted(j.query_batch(jq)) == _sorted(t.query_batch(tq))
    assert j.get_counts() == t.get_counts()
    assert j.get_subset_counts(*keys_subset) == t.get_subset_counts(*keys_subset)
    assert _band_keys(j) == _band_keys(t)
    for b in (1, 3):
        assert sorted(j._query_b(jq[0], b), key=repr) == sorted(t._query_b(tq[0], b), key=repr)


@pytest.mark.parametrize("variant", ["dict", "prepickle", "hashfunc", "lean"])
def test_host_lsh_matches_jax(variant):
    lean = variant == "lean"
    kw = {}
    if variant == "prepickle":
        kw["prepickle"] = True
    if variant == "hashfunc":
        kw["hashfunc"] = lambda b: hashlib.sha1(b).digest()[:8]
    j, t = _pair({"type": "dict", "basename": b"tst"}, **kw)
    assert (j.b, j.r) == (t.b, t.r)
    rows = _rows(240, 1)
    keys = [f"k{i}" for i in range(len(rows))]
    j.insert_batch(keys[:200], _objs(J, rows[:200], lean))
    t.insert_batch(keys[:200], _objs(T, rows[:200], lean))
    for key, jm, tm in zip(keys[200:], _objs(J, rows[200:], lean), _objs(T, rows[200:], lean)):
        j.insert(key, jm)
        t.insert(key, tm)
    q = np.concatenate([rows[:10], _rows(6, 2)])
    _same_answers(j, t, q, keys[::7])
    for key in keys[::5]:
        j.remove(key)
        t.remove(key)
    _same_answers(j, t, q, keys[1::7])
    assert [k in j for k in keys] == [k in t for k in keys]
    assert j.is_empty() == t.is_empty()
    with pytest.raises(ValueError):
        t.insert(keys[1], _objs(T, rows[:1])[0])
    with pytest.raises(ValueError):
        t.remove(keys[0])


def test_merge_sessions_and_query_buffer_match_jax():
    rows = _rows(160, 3)
    keys = [f"m{i}" for i in range(len(rows))]
    j, t = _pair({"type": "dict", "basename": b"a"})
    j2, t2 = _pair({"type": "dict", "basename": b"b"})
    for lsh, pkg in ((j, J), (t, T)):
        with lsh.insertion_session(buffer_size=16) as session:
            for key, m in zip(keys[:80], _objs(pkg, rows[:80])):
                session.insert(key, m)
    for lsh, pkg in ((j2, J), (t2, T)):
        lsh.insert_batch(keys[80:], _objs(pkg, rows[80:]))
    j.merge(j2)
    t.merge(t2)
    _same_answers(j, t, rows[::9], keys[::11])
    with pytest.raises(ValueError):
        t.merge(t2, check_overlap=True)
    for lsh in (j, t):
        with lsh.deletion_session(buffer_size=8) as session:
            for key in keys[::3]:
                session.remove(key)
    _same_answers(j, t, rows[::9], keys[1::11])
    for lsh, pkg in ((j, J), (t, T)):
        for m in _objs(pkg, rows[1:4]):
            lsh.add_to_query_buffer(m)
    assert sorted(j.collect_query_buffer()) == sorted(t.collect_query_buffer())


def test_weighted_rows_match_jax():
    rng = np.random.RandomState(4)
    kt = rng.randint(-3, 3, size=(120, P, 2)).astype(np.int64)
    kt[60:] = kt[:60]
    kt[60:, :5] = 9
    j, t = _pair({"type": "dict", "basename": b"w"})
    assert J.WeightedMinHashLSH is J.MinHashLSH and T.WeightedMinHashLSH is T.MinHashLSH
    keys = list(range(len(kt)))
    j.insert_batch(keys, [J.WeightedMinHash(1, r) for r in kt])
    t.insert_batch(keys, [T.WeightedMinHash(1, r) for r in kt])
    qj = [J.WeightedMinHash(1, r) for r in kt[:20]]
    qt = [T.WeightedMinHash(1, r) for r in kt[:20]]
    assert _sorted(j.query_batch(qj)) == _sorted(t.query_batch(qt))
    assert _band_keys(j) == _band_keys(t)


@pytest.fixture()
def fake_redis_module(monkeypatch):
    mod = types.ModuleType("redis")
    mod.Redis = FakeRedis
    monkeypatch.setitem(sys.modules, "redis", mod)
    return mod


@pytest.fixture()
def fake_cassandra(monkeypatch):
    FakeCluster._session = FakeSession()
    cass = types.ModuleType("cassandra")
    cluster_mod = types.ModuleType("cassandra.cluster")
    cluster_mod.Cluster = FakeCluster
    cluster_mod.MonotonicTimestampGenerator = FakeMonotonicTs
    concurrent_mod = types.ModuleType("cassandra.concurrent")
    concurrent_mod.execute_concurrent = fake_execute_concurrent
    cass.cluster = cluster_mod
    cass.concurrent = concurrent_mod
    monkeypatch.setitem(sys.modules, "cassandra", cass)
    monkeypatch.setitem(sys.modules, "cassandra.cluster", cluster_mod)
    monkeypatch.setitem(sys.modules, "cassandra.concurrent", concurrent_mod)
    for module in (jax_storage, torch_storage):
        shared = module.CassandraSharedSession
        monkeypatch.setattr(shared, "_session", None)
        monkeypatch.setattr(shared, "_session_config", None)
        monkeypatch.setattr(shared, "_shared_write_buffer", [])
        monkeypatch.setattr(shared, "_shared_select_buffer", [])


@pytest.mark.parametrize("backend", ["redis", "cassandra"])
def test_service_storages_match_jax(backend, request):
    request.getfixturevalue("fake_redis_module" if backend == "redis" else "fake_cassandra")
    rows = _rows(90, 5)
    keys = [f"s{i}" for i in range(len(rows))]
    answers = []
    for pkg, name in ((J, b"jx"), (T, b"pt")):
        config = {"type": backend, "basename": name}
        config[backend] = ({"host": "fake", "port": 0} if backend == "redis"
                           else {"keyspace": "ks"})
        lsh = pkg.MinHashLSH(threshold=0.5, num_perm=P, storage_config=config,
                             prepickle=True)
        objs = _objs(pkg, rows)
        lsh.insert_batch(keys[:60], objs[:60])
        with lsh.insertion_session(buffer_size=7) as session:
            for key, m in zip(keys[60:], objs[60:]):
                session.insert(key, m)
        got = [_sorted(lsh.query_batch(objs[::4])), lsh.get_counts()]
        for key in keys[::6]:
            lsh.remove(key)
        got += [_sorted([lsh.query(m) for m in objs[::4]]), [k in lsh for k in keys]]
        answers.append(got)
    assert answers[0] == answers[1]


def test_storage_factories_match_jax(fake_redis_module):
    for pkg in (jax_storage, torch_storage):
        ls = pkg.ordered_storage({"type": "dict"})
        us = pkg.unordered_storage({"type": "dict"})
        ls.insert(b"k", b"a", b"b")
        us.insert(b"k", b"a", b"a")
        assert (ls.get(b"k"), us.get(b"k")) == ([b"a", b"b"], {b"a"})
        r = pkg.unordered_storage({"type": "redis", "redis": {"host": "f"}}, name=b"n*[")
        r.insert(b"x", b"v")
        assert r.itemcounts() == {b"x": 1}
        with pytest.raises(ValueError):
            pkg.ordered_storage({"type": "nope"})
    for prefix in (b"plain", b"a*b?c[d]\\e"):
        assert (torch_storage.glob_escaped_prefix_pattern(prefix)
                == jax_storage.glob_escaped_prefix_pattern(prefix))


def test_host_ensemble_matches_jax():
    rng = np.random.RandomState(6)
    rows = _rows(200, 7, values=3)
    sizes = rng.randint(5, 400, size=len(rows))
    keys = [f"e{i}" for i in range(len(rows))]
    config = {"type": "dict", "basename": b"ens"}
    j = J.MinHashLSHEnsemble(threshold=0.6, num_perm=P, num_part=4, storage_config=config)
    t = T.MinHashLSHEnsemble(threshold=0.6, num_perm=P, num_part=4, storage_config=config)
    np.testing.assert_array_equal(j.params, t.params)
    j.index(zip(keys, _objs(J, rows), sizes))
    t.index(zip(keys, _objs(T, rows), sizes))
    assert (j.lowers, j.uppers) == (t.lowers, t.uppers)
    for jm, tm, size in zip(_objs(J, rows[::10]), _objs(T, rows[::10]), sizes[::10]):
        for q_size in (int(size), 3, 1000):
            assert sorted(j.query(jm, q_size)) == sorted(t.query(tm, q_size))
    assert [k in j for k in keys[:20]] == [k in t for k in keys[:20]]
    assert j.is_empty() == t.is_empty() is False
    with pytest.raises(ValueError):
        t.index([("x", _objs(T, rows[:1])[0], 3)])
