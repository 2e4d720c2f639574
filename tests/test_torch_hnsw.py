"""TorchHNSW and the host HNSW of the port against the JAX package's
TpuHNSW and HNSW on the CPU.

Every comparison is exact: under ``minhash_jaccard`` (P 66, slot
alphabets of 4: heavy ties) and on integer-valued ``l2`` points the answers
(keys and float distances) equal the JAX package's bit for bit. The port
pads nothing, so ``status()``'s capacity and byte counts are the only
fields that differ, by design.
"""

import numpy as np
import pytest
import torch

from datasketch_tpu import HNSW as JaxHNSW
from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu import TpuHNSW
from datasketch_tpu_torch import HNSW, MinHash, TorchHNSW
from datasketch_tpu_torch.ops import knn_graph

torch.set_num_threads(2)

_PADDED = ("capacity", "bytes_points", "bytes_adj")


def _sigs(n, seed, p=66, alphabet=4):
    return np.random.RandomState(seed).randint(0, alphabet, (n, p)).astype(np.uint32)


def _ints(n, seed, d=10):
    return np.random.RandomState(seed).randint(-8, 9, (n, d)).astype(np.float32)


METRICS = [("minhash_jaccard", _sigs), ("l2", _ints)]


def _pair(metric, **kw):
    return (TpuHNSW(distance_metric=metric, m=8, ef=32, **kw),
            TorchHNSW(distance_metric=metric, m=8, ef=32, device="cpu", **kw))


def _same_status(t, j):
    st, sj = t.status(), j.status()
    assert {k: v for k, v in st.items() if k not in _PADDED} == \
        {k: v for k, v in sj.items() if k not in _PADDED}
    if "capacity" in st:
        assert st["capacity"] == st["n"]
        assert st["bytes_adj"] == st["n"] * st["degree0"] * 4


@pytest.mark.parametrize("metric,points", METRICS)
def test_index_query_and_status(metric, points):
    pts = points(300, 1)
    keys = ["p%d" % i for i in range(300)]
    j, t = _pair(metric)
    j.index(keys, pts)
    t.index(keys, pts)
    q = points(330, 1)[270:]  # 30 stored rows and 30 others
    for k, ef in ((10, None), (3, 64)):
        assert t.query_batch(q, k, ef) == j.query_batch(q, k, ef)
    assert t.query(q[0], k=5) == j.query(q[0], k=5)
    assert t.query(torch.from_numpy(q[0].view(np.int32) if q.dtype == np.uint32 else q[0]),
                   k=5) == j.query(q[0], k=5)
    _same_status(t, j)
    assert len(t) == 300 and "p3" in t and "x" not in t and not t.is_empty()


@pytest.mark.parametrize("metric,points", METRICS)
def test_add_flush_rebuild_route(metric, points):
    """Below 256 rows every flush rebuilds; index() on a built graph
    rebuilds over old + new rows."""
    pts = points(160, 2)
    j, t = _pair(metric)
    for ix in (j, t):
        ix.index(range(100), pts[:100])
        for i in range(100, 130):
            ix.add(i, pts[i])
        assert len(ix) == 130 and 120 in ix
        ix.flush()
        ix.index(range(130, 160), pts[130:])
    assert t.status()["appended_since_build"] == 0
    q = points(40, 3)
    assert t.query_batch(q, 10) == j.query_batch(q, 10)
    _same_status(t, j)


@pytest.mark.parametrize("metric,points", METRICS)
def test_append_route_with_overflow_reprune(metric, points, monkeypatch):
    base = points(400, 4)
    rng = np.random.RandomState(5)
    # near-copies of a few rows: their neighbors' rows overflow
    new = base[rng.randint(0, 6, 70)].copy()
    flip = rng.rand(*new.shape) < 0.1
    new[flip] = points(70, 6)[flip]
    widths = []
    real = knn_graph.prune_candidates

    def counted(node_pts, cand_ids, all_pts, m, dist, tile=128):
        widths.append(cand_ids.shape[1])
        return real(node_pts, cand_ids, all_pts, m, dist, tile)

    monkeypatch.setattr(knn_graph, "prune_candidates", counted)
    j, t = _pair(metric)
    for ix in (j, t):
        ix.index(range(400), base)
        for i in range(70):
            ix.add(1000 + i, new[i])
        ix.flush()
    assert t.status()["appended_since_build"] == 70
    assert max(widths) > 16  # the overflow re-prune ran (deg_cap 16 + newcomers)
    jg, tg = j._graph, t._graph
    assert np.array_equal(tg.adj0.numpy(), np.asarray(jg.adj0)[:470])
    assert np.array_equal(t._adj0_host, tg.adj0.numpy())
    q = np.concatenate([new[:20], points(20, 7)])
    assert t.query_batch(q, 10) == j.query_batch(q, 10)
    _same_status(t, j)
    # a second append, then one past rebuild_fraction (a full rebuild)
    for i in range(10):
        j.add(2000 + i, q[20 + i])
        t.add(2000 + i, q[20 + i])
    assert t.query_batch(q, 10) == j.query_batch(q, 10)
    assert t.status()["appended_since_build"] == 80
    for i in range(20):
        j.add(3000 + i, base[i] + 1)
        t.add(3000 + i, base[i] + 1)
    assert t.query_batch(q, 10) == j.query_batch(q, 10)
    assert t.status()["appended_since_build"] == 0
    _same_status(t, j)


@pytest.mark.parametrize("metric,points", METRICS)
def test_remove_and_queries(metric, points):
    pts = points(300, 8)
    j, t = _pair(metric)
    for ix in (j, t):
        ix.index(range(300), pts)
        for key in range(0, 300, 7):
            ix.remove(key)
        with pytest.raises(ValueError):
            ix.remove(0)
        ix.add("new", pts[0])  # a pending add flushes before the remove
        ix.remove(1)
    assert 0 not in t and "new" in t and len(t) == len(j)
    q = pts[:40]
    got = t.query_batch(q, 10)
    assert got == j.query_batch(q, 10)
    assert all(key not in range(0, 300, 7) for row in got for key, _ in row)
    _same_status(t, j)


def _host(cls, pts, seed=3):
    ix = cls(distance_func=lambda x, y: float(np.linalg.norm(x - y)),
             batch_distance_func=lambda q, m: np.linalg.norm(np.asarray(m) - q, axis=1),
             m=6, ef_construction=32, seed=seed)
    for i, p in enumerate(pts):
        ix[i] = p
    return ix


def test_from_hnsw():
    pts = _ints(120, 9)
    hj, ht = _host(JaxHNSW, pts), _host(HNSW, pts)
    for h in (hj, ht):
        h.remove(3)
        h.remove(50)
        h.remove(7, hard=True)
    j = TpuHNSW.from_hnsw(hj, distance_metric="l2", ef=32)
    t = TorchHNSW.from_hnsw(ht, distance_metric="l2", ef=32, device="cpu")
    q = pts[:30]
    assert t.query_batch(q, 5) == j.query_batch(q, 5)
    assert 3 not in t and 4 in t and len(t) == len(j)
    _same_status(t, j)
    for ix in (j, t):  # a rebuild keeps the tombstoned keys out
        ix.index(["x"], pts[:1] + 1)
    assert t.query_batch(q, 5) == j.query_batch(q, 5)


@pytest.mark.parametrize("metric,points", METRICS)
def test_query_stream(metric, points):
    pts = points(300, 10)
    j, t = _pair(metric)
    j.index(range(300), pts)
    t.index(range(300), pts)
    batches = [points(24, s) for s in (11, 12, 13)]
    want = [j.query_batch(b, 6) for b in batches]
    assert list(t.query_stream(batches, 6, depth=2)) == want
    assert list(t.query_stream(batches, 6, depth=4)) == list(j.query_stream(batches, 6))
    empty = TorchHNSW(device="cpu")
    assert empty.query_batch(batches[0], 4) == [[] for _ in range(24)]
    assert empty.status() == TpuHNSW().status()


def test_save_load_across_packages(tmp_path):
    pts = _sigs(400, 14)
    j, t = _pair("minhash_jaccard")
    for ix in (j, t):
        ix.index(range(400), pts)
        for i in range(30):  # the append path: JAX's file carries capacity rows
            ix.add(1000 + i, pts[i] ^ 1)
        ix.remove(5)
    q = np.concatenate([pts[:30], pts[:30] ^ 1])
    want = j.query_batch(q, 10)
    j.save(str(tmp_path / "jax"))
    t.save(str(tmp_path / "torch.npz"))
    with np.load(str(tmp_path / "jax.npz")) as data:
        assert data["points"].shape[0] == 512  # JAX's power-of-two capacity
    with np.load(str(tmp_path / "torch.npz")) as data:
        assert data["points"].shape[0] == 430 and data["points"].dtype == np.uint32
    from_jax = TorchHNSW.load(str(tmp_path / "jax.npz"), device="cpu")
    from_torch = TpuHNSW.load(str(tmp_path / "torch"))
    assert from_jax.query_batch(q, 10) == want
    assert from_torch.query_batch(q, 10) == want
    assert TorchHNSW.load(str(tmp_path / "torch"), device="cpu").query_batch(q, 10) == want
    _same_status(from_jax, from_torch)
    assert 5 not in from_jax and len(from_jax) == 429
    for ix in (from_jax, from_torch):  # appends go on after a load
        for i in range(20):
            ix.add(5000 + i, pts[100 + i] ^ 2)
    assert from_jax.query_batch(q, 10) == from_torch.query_batch(q, 10)


@pytest.mark.parametrize("entry", ["tokens", "text"])
def test_index_tokens_and_text(entry):
    rng = np.random.RandomState(15)
    if entry == "tokens":
        docs = [rng.randint(0, 2000, rng.randint(20, 80)).astype(np.int32) for _ in range(300)]
        want_sigs = JaxMinHash.bulk_signatures(docs, num_perm=64, hashfunc="device")
        got_sigs = MinHash.bulk_signatures(docs, num_perm=64, hashfunc="device", device="cpu")
    else:
        docs = [bytes(rng.randint(97, 101, rng.randint(30, 90)).astype(np.uint8))
                for _ in range(300)]
        want_sigs = JaxMinHash.bulk_from_text(docs, k=5, num_perm=64, hashfunc="device")
        got_sigs = MinHash.bulk_from_text(docs, k=5, num_perm=64, hashfunc="device",
                                          device="cpu")
    assert np.array_equal(np.asarray(got_sigs), np.asarray(want_sigs, dtype=np.uint32))
    j, t = _pair("minhash_jaccard")
    if entry == "tokens":
        j.index_tokens(range(300), docs, num_perm=64)
        t.index_tokens(range(300), docs, num_perm=64)
    else:
        j.index_text(range(300), docs, k=5, num_perm=64)
        t.index_text(range(300), docs, k=5, num_perm=64)
    q = np.asarray(want_sigs)[:40]
    assert t.query_batch(q, 10) == j.query_batch(q, 10)


def test_errors(tmp_path):
    with pytest.raises(ValueError, match="m must be"):
        TorchHNSW(m=1, device="cpu")
    t = TorchHNSW(distance_metric="l2", m=4, device="cpu")
    with pytest.raises(ValueError, match="equal length"):
        t.index([1, 2], _ints(3, 0))
    with pytest.raises(ValueError, match="minhash_jaccard"):
        t.index_tokens([1], [np.arange(5)])
    with pytest.raises(ValueError, match="minhash_jaccard"):
        t.index_text([1], [b"abcdefghijk"])
    with pytest.raises(ValueError, match="Cannot save an empty"):
        t.save(str(tmp_path / "e"))
    t.add("a", _ints(1, 0)[0])
    with pytest.raises(ValueError, match="already exists"):
        t.add("a", _ints(1, 0)[0])
    with pytest.raises(ValueError, match="already exists"):
        t.index(["a"], _ints(1, 0))  # clashes with a pending add
    t.index(["b", "c"], _ints(2, 1))
    with pytest.raises(ValueError, match="already exists"):
        t.index(["b"], _ints(1, 0))
    with pytest.raises(ValueError, match="does not exist"):
        t.remove("zz")
    custom = TorchHNSW(distance_metric=lambda q, p: ((p - q.unsqueeze(-2)) ** 2).sum(-1),
                       m=4, device="cpu")
    custom.index(range(40), _ints(40, 2))
    custom.save(str(tmp_path / "c"))
    with pytest.raises(ValueError, match="custom distance"):
        TorchHNSW.load(str(tmp_path / "c"), device="cpu")
    back = TorchHNSW.load(str(tmp_path / "c"), distance_metric=custom.metric, device="cpu")
    assert back.query_batch(_ints(5, 3), 3) == custom.query_batch(_ints(5, 3), 3)
    np.savez(str(tmp_path / "other.npz"), kind=np.array("tpu_forest"))
    with pytest.raises(ValueError, match="not a TpuHNSW"):
        TorchHNSW.load(str(tmp_path / "other.npz"), device="cpu")


# ----------------------------------------------------------- the host HNSW


def _host_pair(reversed_edges, seed=21):
    kw = dict(distance_func=lambda x, y: float(np.linalg.norm(x - y)),
              batch_distance_func=lambda q, m: np.linalg.norm(np.asarray(m) - q, axis=1),
              m=5, ef_construction=24, seed=seed, reversed_edges=reversed_edges)
    return JaxHNSW(**kw), HNSW(**kw)


def _same_host(t, j):
    assert list(t._nodes) == list(j._nodes)
    assert all(t._nodes[k].is_deleted == j._nodes[k].is_deleted for k in j._nodes)
    assert t._entry_point == j._entry_point
    assert [layer._graph for layer in t._graphs] == [layer._graph for layer in j._graphs]


@pytest.mark.parametrize("reversed_edges", [False, True])
def test_host_hnsw_random_op_sequences(reversed_edges):
    rng = np.random.RandomState(22 + reversed_edges)
    j, t = _host_pair(reversed_edges)
    live = []
    for step in range(220):
        op = rng.choice(["insert", "insert", "insert", "update", "soft", "hard", "query",
                         "merge", "clean"], p=[.3, .15, .1, .1, .1, .08, .1, .03, .04])
        if op in ("insert", "update") or not live:
            key = int(rng.randint(0, 10_000)) if op == "insert" or not live else \
                live[rng.randint(len(live))]
            point = rng.randint(-6, 7, 6).astype(np.float64)
            j.insert(key, point)
            t.insert(key, point)
            if key not in live:
                live.append(key)
        elif op in ("soft", "hard"):
            key = live.pop(rng.randint(len(live)))
            j.remove(key, hard=op == "hard")
            t.remove(key, hard=op == "hard")
        elif op == "query":
            q = rng.randint(-6, 7, 6).astype(np.float64)
            k = int(rng.randint(1, 8))
            assert t.query(q, k=k, ef=16) == j.query(q, k=k, ef=16)
        elif op == "merge":
            oj, ot = _host_pair(reversed_edges, seed=step)
            for i in range(5):
                point = rng.randint(-6, 7, 6).astype(np.float64)
                oj.insert(20_000 + step * 10 + i, point)
                ot.insert(20_000 + step * 10 + i, point)
                live.append(20_000 + step * 10 + i)
            j, t = j.merge(oj), t.merge(ot)
        else:
            j.clean()
            t.clean()
        _same_host(t, j)
    assert len(t) == len(j) == len(live)
    assert sorted(t.keys()) == sorted(j.keys()) == sorted(live)
    assert t == t.copy()


@pytest.mark.parametrize("metric", ["minhash_jaccard", "l2"])
def test_host_hnsw_from_points(metric):
    pts = _sigs(300, 30) if metric == "minhash_jaccard" else _ints(300, 30).astype(np.float64)
    keys = ["k%d" % i for i in range(300)]
    j = JaxHNSW.from_points(pts, keys=keys, metric=metric, m=8, ef_construction=32)
    t = HNSW.from_points(pts, keys=keys, metric=metric, m=8, ef_construction=32, device="cpu")
    _same_host(t, j)
    assert len(t._graphs) == 2
    q = pts[:10]
    assert [t.query(x, k=5) for x in q] == [j.query(x, k=5) for x in q]
    for ix in (j, t):  # the mutable surface goes on (from_points seeds no level draw)
        ix.insert("new", pts[3], level=0)
        ix.remove("k4", hard=True)
    _same_host(t, j)
    assert HNSW.from_points(np.zeros((0, 4)), device="cpu")._entry_point is None
    with pytest.raises(ValueError, match="provide distance_func"):
        HNSW.from_points(pts, metric=lambda q, p: p.sum(-1), device="cpu")
