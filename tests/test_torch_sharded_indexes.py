"""Port parity: the sharded b-bit, LSHBloom, LSH Ensemble, LSH Forest and
HNSW indexes against the JAX package's on its virtual CPU mesh.

Meshes as in ``tests/test_torch_parallel.py`` (2 x 2, 4 x 2, 8 x 1, 2 x 4),
each JAX mesh beside a port mesh of CPU positions. Sizes leave shards short
and empty: 300 rows over 8 shards of 64, 5 partitions over 4 or 8 shards, a
2-word bitmap over 8 shards. Answers, order, scores, ``last_truncated``,
``status()`` (but for ``n_padded`` / ``device_bytes``) and ``.npz`` files
loaded in the other package -- and by the other package's single-device
class -- are compared exactly. HNSW pads, as the JAX class does, with
filler points drawn in the data's bounding box: ``minhash_jaccard`` runs at
300 signatures (filler in the last shard), ``l2`` on integer-valued points
at 256 (no filler: float sums in another order would round otherwise).
"""

import numpy as np
import pytest
import torch

import datasketch_tpu as JP
import datasketch_tpu.parallel as J
import datasketch_tpu_torch as TP
import datasketch_tpu_torch.parallel as T

torch.set_num_threads(2)

MESHES = {"2x2": (4, None), "4x2": (8, None), "8x1": (8, (8, 1)), "2x4": (8, (2, 4))}
P = 32
N = 300


def _meshes(name):
    n, shape = MESHES[name]
    return J.make_mesh(n, shape=shape), T.make_mesh(n, shape=shape, device="cpu")


def _corpus(n=N, seed=5):
    """Near-copies in the second half, slots of 0..3 in every fifth row
    (ties), and 40 copies of row 1 one slot apart (deep overlaps)."""
    rng = np.random.RandomState(seed)
    sigs = rng.randint(0, 1 << 32, size=(n, P), dtype=np.uint64).astype(np.uint32)
    half = n // 2
    sigs[half:] = np.where(rng.rand(n - half, P) < 0.7, sigs[: n - half], sigs[half:])
    sigs[::5] = rng.randint(0, 4, size=(len(sigs[::5]), P))
    sigs[20:60] = sigs[1]
    sigs[20:60, -1] = np.arange(40)
    return sigs


SIGS = _corpus()
KEYS = ["d%d" % i for i in range(N)]
Q = SIGS[[0, 1, 2, 5, 21, 150, 151, 299]]


def _status(ix):
    return {k: v for k, v in ix.status().items() if k not in ("n_padded", "device_bytes")}


def _files_equal(a, b):
    a, b = np.load(a), np.load(b)
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# ----------------------------------------------------------------- b-bit


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_bbit_matches_jax(mesh_name, b):
    jm, tm = _meshes(mesh_name)
    j = J.ShardedBBitIndex(jm, b=b, num_perm=P)
    t = T.ShardedBBitIndex(tm, b=b, num_perm=P)
    for ix in (j, t):
        ix.insert_batch(KEYS[:200], SIGS[:200])
        ix.insert_batch(KEYS[200:], SIGS[200:])
    for k in (5, 40):
        assert t.query_batch(Q, k, return_scores=True) == j.query_batch(Q, k, return_scores=True)
    for ix in (j, t):
        ix.remove_batch(KEYS[::3])
    assert t.query_batch(Q, 7, return_scores=True) == j.query_batch(Q, 7, return_scores=True)
    assert _status(t) == _status(j)
    assert list(t.query_stream([Q[:4], Q[4:]], 5, depth=2)) == \
        [t.query_batch(Q[:4], 5), t.query_batch(Q[4:], 5)]
    with pytest.raises(ValueError):
        t.remove_batch(["d0"])
    for ix in (j, t):
        ix.compact()
    assert t.query_batch(Q, 7, return_scores=True) == j.query_batch(Q, 7, return_scores=True)


def test_bbit_checkpoints_both_ways(tmp_path):
    jm, tm = _meshes("4x2")
    jd, td = _meshes("8x1")
    j = J.ShardedBBitIndex(jm, b=2, num_perm=P)
    t = T.ShardedBBitIndex(tm, b=2, num_perm=P)
    for ix in (j, t):
        ix.insert_batch(KEYS, SIGS)
        ix.remove_batch(["d4"])
    j.save(str(tmp_path / "jax.npz"))
    t.save(str(tmp_path / "port.npz"))
    _files_equal(tmp_path / "jax.npz", tmp_path / "port.npz")
    want = j.query_batch(Q, 6, return_scores=True)
    for loaded in (T.ShardedBBitIndex.load(str(tmp_path / "jax.npz"), td),
                   TP.TorchBBitIndex.load(str(tmp_path / "port.npz"), device="cpu"),
                   J.ShardedBBitIndex.load(str(tmp_path / "port.npz"), jd),
                   JP.TpuBBitIndex.load(str(tmp_path / "port.npz"))):
        assert loaded.query_batch(Q, 6, return_scores=True) == want
    single = TP.TorchBBitIndex(b=2, num_perm=P, device="cpu")
    single.insert_batch(KEYS, SIGS)
    single.remove_batch(["d4"])
    single.save(str(tmp_path / "single.npz"))
    assert T.ShardedBBitIndex.load(str(tmp_path / "single.npz"), td).query_batch(
        Q, 6, return_scores=True) == want


# ------------------------------------------------------------------ bloom


@pytest.mark.parametrize("n", [64, 2000])
@pytest.mark.parametrize("mesh_name", ["4x2", "8x1", "2x4"])
def test_bloom_matches_jax(mesh_name, n, tmp_path):
    jm, tm = _meshes(mesh_name)
    j = J.ShardedMinHashLSHBloom(jm, threshold=0.5, num_perm=P, n=n, fp=0.01)
    t = T.ShardedMinHashLSHBloom(tm, threshold=0.5, num_perm=P, n=n, fp=0.01)
    assert (t.num_words, t._local_words) == (j.num_words, j._local_words)
    j.insert_batch(list(SIGS[:100]))
    t.insert_batch(SIGS[:100])
    hits = t.query_batch(SIGS)
    np.testing.assert_array_equal(hits, j.query_batch(list(SIGS)))
    assert hits[:100].all()
    j.save(str(tmp_path / "jax.npz"))
    t.save(str(tmp_path / "port.npz"))
    _files_equal(tmp_path / "jax.npz", tmp_path / "port.npz")
    _, td = _meshes("2x2")
    for loaded in (T.ShardedMinHashLSHBloom.load(str(tmp_path / "jax.npz"), td),
                   TP.TorchMinHashLSHBloom.load(str(tmp_path / "port.npz"), device="cpu"),
                   JP.TpuMinHashLSHBloom.load(str(tmp_path / "port.npz"))):
        np.testing.assert_array_equal(np.asarray(loaded.query_batch(list(SIGS))), hits)
    single = TP.TorchMinHashLSHBloom(threshold=0.5, num_perm=P, n=n, fp=0.01, device="cpu")
    single.insert_batch(SIGS[:100])
    single.save(str(tmp_path / "single.npz"))
    _files_equal(tmp_path / "single.npz", tmp_path / "port.npz")


# --------------------------------------------------------------- ensemble


SIZES = np.random.RandomState(8).randint(10, 300, size=N)
SIZES[20:60] = 50  # the copies of row 1 share a size (one partition)
QS = [int(x) for x in SIZES[[0, 1, 2, 5, 21, 150, 151, 299]]]


def _ensembles(mesh_name, **kw):
    jm, tm = _meshes(mesh_name)
    args = dict(threshold=0.5, num_perm=P, num_part=5, bucket_cap=4, **kw)
    j = J.ShardedMinHashLSHEnsemble(jm, **args)
    t = T.ShardedMinHashLSHEnsemble(tm, **args)
    j.index([(KEYS[i], JP.MinHash(num_perm=P, hashvalues=SIGS[i]), int(SIZES[i]))
             for i in range(N)])
    t.index_batch(KEYS, SIGS, SIZES)
    return j, t


def _jq():
    return [(JP.MinHash(num_perm=P, hashvalues=s), z) for s, z in zip(Q, QS)]


@pytest.mark.parametrize("max_results", [2048, 20])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_ensemble_matches_jax(mesh_name, max_results):
    j, t = _ensembles(mesh_name, max_results=max_results)
    tq = (Q, QS)
    got = t.query_batch(tq, method="scan")
    assert got == j.query_batch(_jq(), method="scan")
    assert t.last_truncated == j.last_truncated
    got = t.query_batch(tq, method="bands")
    assert [sorted(r) for r in got] == [sorted(r) for r in j.query_batch(_jq(), method="bands")]
    assert t.last_truncated == j.last_truncated
    assert [sorted(r) for r in t.query_batch(tq)] == [sorted(r) for r in j.query_batch(_jq())]
    if max_results == 20:  # 40 sets contain row 1's query: the scan reruns, then truncates
        assert t.query_batch(tq, method="scan") and t.last_truncated > 0
    assert list(t.query_stream([tq, (Q[:3], QS[:3])], depth=2)) == \
        [t.query_batch(tq, method="scan"), t.query_batch((Q[:3], QS[:3]), method="scan")]


@pytest.mark.parametrize("mesh_name", ["2x2", "8x1"])
def test_ensemble_scan_counts_the_padding_rows_as_jax(mesh_name):
    """Slots of 0..2 make JAX's zero padding queries (size 1) match: its
    sharded scan counts their overflow in ``last_truncated`` and in its
    rerun rule, and so does the port's."""
    jm, tm = _meshes(mesh_name)
    rng = np.random.RandomState(12)
    sigs = rng.randint(0, 3, size=(200, P)).astype(np.uint32)
    sizes = rng.randint(1, 300, size=200)
    args = dict(threshold=0.3, num_perm=P, num_part=3, bucket_cap=16, max_results=3)
    j = J.ShardedMinHashLSHEnsemble(jm, **args)
    t = T.ShardedMinHashLSHEnsemble(tm, **args)
    j.index([(i, JP.MinHash(num_perm=P, hashvalues=sigs[i]), int(sizes[i]))
             for i in range(200)])
    t.index_batch(range(200), sigs, sizes)
    q, qs = sigs[:5], [int(x) for x in sizes[:5]]
    got = t.query_batch((q, qs), method="scan")
    assert got == j.query_batch([(JP.MinHash(num_perm=P, hashvalues=x), z)
                                 for x, z in zip(q, qs)], method="scan")
    assert t.last_truncated == j.last_truncated > 0


@pytest.mark.parametrize("mesh_name", ["2x2", "8x1"])
def test_ensemble_scan_passes_once_a_shard_and_rescans_real_queries_only(mesh_name,
                                                                        monkeypatch):
    """The sharded scan runs kernel 2s's emit variant once on every shard
    that holds rows, at the per-shard cap, and again only over the real
    queries past the cap in their shard: the zero row that stands for the
    padding queries passes it in every shard and is never rescanned. It
    calls neither kernel 2s's top-k variant nor kernel 4."""
    from datasketch_tpu_torch.kernels import lsh_scan, score

    jm, tm = _meshes(mesh_name)
    rng = np.random.RandomState(12)
    sigs = rng.randint(0, 3, size=(200, P)).astype(np.uint32)
    sizes = rng.randint(1, 300, size=200)
    args = dict(threshold=0.5, num_perm=P, num_part=3, bucket_cap=16, max_results=3)
    j = J.ShardedMinHashLSHEnsemble(jm, **args)
    t = T.ShardedMinHashLSHEnsemble(tm, **args)
    j.index([(i, JP.MinHash(num_perm=P, hashvalues=sigs[i]), int(sizes[i]))
             for i in range(200)])
    t.index_batch(range(200), sigs, sizes)
    real, runs = lsh_scan.containment_hits, []

    def counted(db, sizes, q, q_sizes, cutoff, cap):
        out = real(db, sizes, q, q_sizes, cutoff, cap)
        runs.append((q.shape[0], cap, out[1]))
        return out

    def banned(*args, **kwargs):
        raise AssertionError("the sharded scan ran a top-k scan")

    monkeypatch.setattr(lsh_scan, "containment_hits", counted)
    monkeypatch.setattr(lsh_scan, "containment_topk", banned)
    monkeypatch.setattr(score, "score_matrix", banned)
    got = t.query_batch((sigs[:5], [299] * 5), method="scan")
    holding = [s for s, shard in t._tables.items() if shard["sigs"].shape[0]]
    assert len(holding) == min(3, t.n_shards)  # 3 partitions
    first, rescans = runs[: len(holding)], runs[len(holding):]
    assert [r[:2] for r in first] == [(6, 3)] * len(holding)  # 5 queries and the zero row
    assert all(int(n[5]) > 3 for _, _, n in first)
    # real queries past the cap, shard by shard: on 8 x 1 the first shard
    # holds none, only the zero row, and rescans nothing
    want = [int((n[:5] > 3).sum()) for _, _, n in first]
    assert want == {"2x2": [2, 5], "8x1": [0, 2, 5]}[mesh_name]
    assert [r[0] for r in rescans] == [w for w in want if w]
    assert got == j.query_batch([(JP.MinHash(num_perm=P, hashvalues=x), 299)
                                 for x in sigs[:5]], method="scan")
    assert t.last_truncated == j.last_truncated > 0


def test_ensemble_checkpoints_both_ways(tmp_path):
    j, t = _ensembles("4x2")
    j.save(str(tmp_path / "jax.npz"))
    t.save(str(tmp_path / "port.npz"))
    _files_equal(tmp_path / "jax.npz", tmp_path / "port.npz")
    jd, td = _meshes("8x1")
    # the scan's order is shard by shard: equal on meshes of one shape,
    # equal as sets across shapes and against the single-device classes
    want = J.ShardedMinHashLSHEnsemble.load(str(tmp_path / "port.npz"), jd).query_batch(
        _jq(), method="scan")
    assert T.ShardedMinHashLSHEnsemble.load(str(tmp_path / "jax.npz"), td).query_batch(
        (Q, QS), method="scan") == want
    want = [sorted(r) for r in want]
    assert [sorted(r) for r in j.query_batch(_jq(), method="scan")] == want
    assert [sorted(r) for r in TP.TorchMinHashLSHEnsemble.load(
        str(tmp_path / "port.npz"), device="cpu").query_batch((Q, QS), method="scan")] == want
    assert [sorted(r) for r in JP.TpuMinHashLSHEnsemble.load(
        str(tmp_path / "port.npz")).query_batch(_jq(), method="scan")] == want
    single = TP.TorchMinHashLSHEnsemble(threshold=0.5, num_perm=P, num_part=5, bucket_cap=4,
                                        device="cpu")
    single.index_batch(KEYS, SIGS, SIZES)
    single.save(str(tmp_path / "single.npz"))
    _files_equal(tmp_path / "single.npz", tmp_path / "port.npz")
    assert [sorted(r) for r in T.ShardedMinHashLSHEnsemble.load(
        str(tmp_path / "single.npz"), td).query_batch((Q, QS), method="scan")] == want


# ----------------------------------------------------------------- forest


@pytest.mark.parametrize("rank", ["forest", "jaccard"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_forest_matches_jax(mesh_name, rank):
    jm, tm = _meshes(mesh_name)
    j = J.ShardedMinHashLSHForest(jm, num_perm=P, l=4, cap=4, rank=rank)
    t = T.ShardedMinHashLSHForest(tm, num_perm=P, l=4, cap=4, rank=rank)
    for ix in (j, t):
        ix.index(KEYS[:180], SIGS[:180])
        ix.index(KEYS[180:], SIGS[180:])  # re-sharded
    for method, k in (("forest", 5), ("auto", 5), ("scan", 5), ("scan", 150)):
        if method == "scan" and rank == "forest":
            # JAX answers in Jaccard order here; the port refuses the pair
            with pytest.raises(ValueError, match="rank='forest'"):
                t.query_batch(Q, k, method=method)
            continue
        got = t.query_batch(Q, k, return_scores=True, method=method)
        assert got == j.query_batch(Q, k, return_scores=True, method=method), (method, k)
        assert t.last_truncated == j.last_truncated, method
    for ix in (j, t):
        ix.query_batch(Q, 5, method="forest")
    assert t.last_truncated > 0  # cap 4 against the 40 copies of row 1
    assert _status(t) == _status(j)
    assert list(t.query_stream([Q[:3], Q[3:]], 5, depth=2)) == \
        [t.query_batch(Q[:3], 5), t.query_batch(Q[3:], 5)]


def test_forest_checkpoints_both_ways(tmp_path):
    jm, tm = _meshes("2x4")
    j = J.ShardedMinHashLSHForest(jm, num_perm=P, l=4, cap=8, rank="jaccard", pool=64)
    t = T.ShardedMinHashLSHForest(tm, num_perm=P, l=4, cap=8, rank="jaccard", pool=64)
    for ix in (j, t):
        ix.index(KEYS, SIGS)
    j.save(str(tmp_path / "jax.npz"))
    t.save(str(tmp_path / "port.npz"))
    _files_equal(tmp_path / "jax.npz", tmp_path / "port.npz")
    # a walk's answers depend on the shard layout: compared on one mesh shape
    jd, td = _meshes("4x2")
    want = J.ShardedMinHashLSHForest.load(str(tmp_path / "port.npz"), jd).query_batch(
        Q, 6, method="forest")
    assert T.ShardedMinHashLSHForest.load(str(tmp_path / "jax.npz"), td).query_batch(
        Q, 6, method="forest") == want
    single = TP.TorchMinHashLSHForest.load(str(tmp_path / "port.npz"), device="cpu")
    assert single.query_batch(Q, 6, method="forest") == \
        JP.TpuMinHashLSHForest.load(str(tmp_path / "port.npz")).query_batch(Q, 6,
                                                                            method="forest")
    single.save(str(tmp_path / "single.npz"))
    _files_equal(tmp_path / "single.npz", tmp_path / "port.npz")
    assert T.ShardedMinHashLSHForest.load(str(tmp_path / "single.npz"), td).query_batch(
        Q, 6, method="forest") == want
    assert T.ShardedMinHashLSHForest.load(str(tmp_path / "single.npz"), td).query_batch(
        Q, 6, method="scan") == j.query_batch(Q, 6, method="scan")


# ------------------------------------------------------------------- HNSW


def _points(metric):
    if metric == "l2":
        return np.random.RandomState(3).randint(-8, 8, size=(256, 6)).astype(np.float32)
    return SIGS


@pytest.mark.parametrize("mesh_name,metric", [(name, "minhash_jaccard") for name in MESHES]
                         + [("2x2", "l2"), ("8x1", "l2")])
def test_hnsw_matches_jax(mesh_name, metric):
    jm, tm = _meshes(mesh_name)
    pts = _points(metric)
    keys = KEYS[: pts.shape[0]]
    j = J.ShardedHNSW(jm, distance_metric=metric, m=4, ef=16)
    t = T.ShardedHNSW(tm, distance_metric=metric, m=4, ef=16)
    for ix in (j, t):
        ix.index(keys, pts)
    q = pts[:24]
    assert t.query_batch(q, k=10) == j.query_batch(q, k=10)
    for ix in (j, t):
        ix.remove(keys[1])
        ix.remove(keys[2])
    assert t.query_batch(q, k=9) == j.query_batch(q, k=9)
    assert t.status() == j.status()
    for ix in (j, t):  # re-index: tombstones drop out, the corpus re-shards
        ix.index(["x0", "x1"], pts[:2] + 1)
    assert t.query_batch(q, k=10) == j.query_batch(q, k=10)
    assert list(t.query_stream([q[:8], q[8:]], k=4, depth=2)) == \
        [t.query_batch(q[:8], k=4), t.query_batch(q[8:], k=4)]


def test_hnsw_filler_matches_jax():
    """The filler rows: the same points (float32, the data's bounding
    box) in the last shard's graph, routable and never returned."""
    jm, tm = _meshes("4x2")
    j = J.ShardedHNSW(jm, distance_metric="minhash_jaccard", m=4, ef=16)
    t = T.ShardedHNSW(tm, distance_metric="minhash_jaccard", m=4, ef=16)
    for ix in (j, t):
        ix.index(KEYS, SIGS)
    local_n = t.status()["local_n"]
    assert local_n * 4 == 512  # 300 rows, 212 filler
    jpts = np.asarray(j._points).reshape(-1, P)
    tpts = np.concatenate([t._graphs[s].points.numpy() for s in range(4)]).view(np.float32)
    np.testing.assert_array_equal(tpts, jpts)
    np.testing.assert_array_equal(np.concatenate([t._graphs[s].adj0.numpy() for s in range(4)]),
                                  np.asarray(j._adj0).reshape(512, -1))
    assert [t._graphs[s].entry for s in range(4)] == np.asarray(j._entry).tolist()
    dead = np.concatenate([t._graphs[s].deleted.numpy() for s in range(4)])
    assert dead[300:].all() and not dead[:300].any()
    rows = t.query_batch(SIGS[200:300], k=10, ef=32)
    assert all(key in KEYS for row in rows for key, _ in row)


def test_hnsw_checkpoints_tokens_and_errors(tmp_path):
    jm, tm = _meshes("2x2")
    rng = np.random.RandomState(4)
    docs = [rng.randint(0, 5000, 40).astype(np.uint32) for _ in range(150)]
    j = J.ShardedHNSW(jm, distance_metric="minhash_jaccard", m=4, ef=16)
    t = T.ShardedHNSW(tm, distance_metric="minhash_jaccard", m=4, ef=16)
    j.index_tokens(KEYS[:150], docs, num_perm=P)
    t.index_tokens(KEYS[:150], docs, num_perm=P)
    qs = TP.MinHash.bulk_signatures(docs[:10], num_perm=P, hashfunc="device", device="cpu")
    assert t.query_batch(qs, k=4) == j.query_batch(qs, k=4)
    t.remove(KEYS[0])
    j.remove(KEYS[0])
    j.save(str(tmp_path / "jax"))
    t.save(str(tmp_path / "port"))
    _files_equal(tmp_path / "jax.npz", tmp_path / "port.npz")
    jd, td = _meshes("8x1")
    want = J.ShardedHNSW.load(str(tmp_path / "port.npz"), jd).query_batch(qs, k=4)
    assert T.ShardedHNSW.load(str(tmp_path / "jax.npz"), td).query_batch(qs, k=4) == want
    with pytest.raises(ValueError, match="minhash_jaccard"):
        T.ShardedHNSW(tm).index_tokens(["a"], docs[:1])
    with pytest.raises(ValueError, match="empty"):
        T.ShardedHNSW(tm).save(str(tmp_path / "empty"))
    assert T.ShardedHNSW(tm).query_batch(np.zeros((2, 3), np.float32)) == [[], []]
