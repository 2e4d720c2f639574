"""Port parity: TorchMinHashLSHForest (device="cpu", the kernels' plain
versions) against TpuMinHashLSHForest, and the host MinHashLSHForest
against the JAX package's, on the same rows: answers (keys, order and
scores) and ``last_truncated`` for every method and rank, at a power-of-two
row count (the JAX facade adds no filler rows) and at one that is not;
cascade rows, (k, t) input, the add / index lifecycle, errors, streams and
``.npz`` files written by one package and loaded by the other."""

import numpy as np
import pytest
import torch

from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu import MinHashLSHForest as JaxForest
from datasketch_tpu import WeightedMinHash as JaxWMH
from datasketch_tpu.models.tpu_forest import TpuMinHashLSHForest
from datasketch_tpu_torch import (
    MinHash,
    MinHashLSHForest,
    TorchMinHashLSHForest,
    WeightedMinHash,
    WeightedMinHashLSHForest,
)

torch.set_num_threads(2)

P = 128


def _sigs(n, p, seed):
    """Random rows from a small slot alphabet (long shared prefixes), 1/4 of
    them near-copies of earlier rows."""
    rng = np.random.RandomState(seed)
    sigs = rng.randint(0, 64, size=(n, p), dtype=np.uint64).astype(np.uint32)
    dst = rng.choice(n, n // 4, replace=False)
    src = rng.randint(0, n, n // 4)
    keep = rng.rand(n // 4, p) < 0.8
    sigs[dst] = np.where(keep, sigs[src], sigs[dst])
    return sigs


def _queries(sigs, nq, seed):
    rng = np.random.RandomState(seed)
    q = sigs[rng.randint(0, sigs.shape[0], nq)]
    keep = rng.rand(*q.shape) < 0.75
    return np.where(keep, q, rng.randint(0, 64, q.shape, dtype=np.uint64).astype(np.uint32))


def _pair(sigs, keys=None, **kw):
    keys = list(range(len(sigs))) if keys is None else keys
    ours = TorchMinHashLSHForest(device="cpu", **kw)
    ref = TpuMinHashLSHForest(**kw)
    ours.index(keys, sigs)
    ref.index(keys, sigs)
    return ours, ref


def _same(pair, call):
    ours, ref = pair
    got, want = call(ours), call(ref)
    assert got == want
    assert ours.last_truncated == ref.last_truncated
    return got


ROUTES = [("forest", "forest"), ("forest", "jaccard"), ("scan", "jaccard"),
          ("auto", "forest"), ("auto", "jaccard")]


@pytest.fixture(scope="module", params=[1024, 1500])
def forest(request):
    n = request.param
    sigs = _sigs(n, P, n)
    return _pair(sigs, num_perm=P, l=8, cap=16), sigs, _queries(sigs, 37, n + 1)


@pytest.mark.parametrize("method,rank", ROUTES)
def test_query_batch_matches(forest, method, rank):
    pair, sigs, q = forest
    for k in (1, 10, 40):
        got = _same(pair, lambda ix: ix.query_batch(q, k, return_scores=True, rank=rank,
                                                    method=method))
    assert all(len(row) == 40 for row in got)
    _same(pair, lambda ix: ix.query_batch(q[:8], 5, rank=rank, method=method))
    _same(pair, lambda ix: ix.query(q[3], 5, rank=rank, method=method))
    if method == "forest":
        assert pair[0].last_truncated > 0


def test_auto_routes_as_the_jax_facade(forest):
    """rank 'jaccard' scans when the padded table fits the walk's gather
    volume q_pad * l * k * cap; rank 'forest' always walks."""
    (ours, ref), sigs, _ = forest
    routes = set()
    for cap in (1, 4, 16):
        pair = (ours, ref) if cap == 16 else _pair(sigs, num_perm=P, l=8, cap=cap)
        for rank in ("forest", "jaccard"):
            for q_pad in (8, 16, 64):
                got = pair[0]._resolve_method("auto", rank, q_pad)
                assert got == pair[1]._resolve_method("auto", rank, q_pad)
                routes.add((rank, got))
    assert ("jaccard", "scan") in routes and ("forest", "scan") not in routes


def test_scan_with_rank_forest_is_refused(forest):
    """The JAX facade answers method='scan' with rank='forest' in Jaccard
    order (a fault); the port refuses the pair."""
    (ours, _), _, q = forest
    with pytest.raises(ValueError, match="rank='forest'"):
        ours.query_batch(q, 10, method="scan", rank="forest")
    scan_forest = TorchMinHashLSHForest(num_perm=P, method="scan", device="cpu")
    scan_forest.index(range(10), forest[1][:10])
    with pytest.raises(ValueError, match="rank='forest'"):
        scan_forest.query_batch(q, 10)
    assert scan_forest.query_batch(q[:2], 3, rank="jaccard")


@pytest.mark.parametrize("pool", [64, 512])
def test_cascade_and_pool_match(pool):
    sigs = _sigs(1500, 256, 3)
    q = _queries(sigs, 20, 4)
    pair = _pair(sigs, num_perm=P, l=8, cap=32, cascade_perm=256, pool=pool, rank="jaccard")
    assert pair[0].score_width == 256
    for method in ("forest", "scan"):
        _same(pair, lambda ix: ix.query_batch(q, 10, return_scores=True, method=method))
    with pytest.raises(ValueError, match="out of range"):
        pair[0].query_batch(q[:, :P], 10)


def test_p66_scores_are_quantized_as_the_jax_facade():
    sigs = _sigs(1024, 66, 5)
    q = _queries(sigs, 20, 6)
    pair = _pair(sigs, num_perm=66, l=6, cap=16)
    got = _same(pair, lambda ix: ix.query_batch(q, 10, return_scores=True))
    scores = [s for row in got for _, s in row]
    assert any(s != float(np.float32(round(s * 66)) * np.float32(1 / 66)) for s in scores)
    assert all(s * (1 << 20) == int(s * (1 << 20)) for s in scores)
    _same(pair, lambda ix: ix.query_batch(q, 10, return_scores=True, rank="jaccard",
                                          method="scan"))


def test_weighted_input_and_objects():
    rng = np.random.RandomState(7)
    kt = np.stack([rng.randint(0, 20, (600, P)), rng.randint(-3, 3, (600, P))], axis=-1)
    pair = (TorchMinHashLSHForest(num_perm=P, device="cpu"), TpuMinHashLSHForest(num_perm=P))
    for ix in pair:
        ix.index(range(600), kt)
    q_ours = [WeightedMinHash(1, kt[i]) for i in range(0, 600, 40)]
    q_ref = [JaxWMH(1, kt[i]) for i in range(0, 600, 40)]
    for method, rank in (("forest", "forest"), ("scan", "jaccard")):
        assert pair[0].query_batch(q_ours, 5, True, rank=rank, method=method) == \
            pair[1].query_batch(q_ref, 5, True, rank=rank, method=method)
    dev = TorchMinHashLSHForest(num_perm=P, device="cpu")
    dev.index(range(600), torch.from_numpy(kt))  # a (k, t) tensor batch
    assert dev.query_batch(q_ours, 5, True) == pair[0].query_batch(q_ours, 5, True)


def test_add_index_lifecycle_and_plumbing():
    sigs = _sigs(1024, P, 9)
    q = _queries(sigs, 16, 10)
    pair = (TorchMinHashLSHForest(num_perm=P, cap=16, device="cpu"),
            TpuMinHashLSHForest(num_perm=P, cap=16))
    objs = [(MinHash(hashvalues=r), JaxMinHash(hashvalues=r)) for r in sigs[:300]]
    for i, (o, r) in enumerate(objs):
        pair[0].add(i, o)
        pair[1].add(i, r)
    for ix in pair:
        assert ix.is_empty() and len(ix) == 300 and 5 in ix
        assert ix.query_batch(q, 5) == [[]] * 16
    np.testing.assert_array_equal(pair[0].get_minhash_hashvalues(7),
                                  pair[1].get_minhash_hashvalues(7))
    for ix in pair:
        ix.index()
        ix.index(range(300, 800), sigs[300:800])
        ix.add(800, sigs[800])
    _same(pair, lambda ix: ix.query_batch(q, 10, return_scores=True))
    for ix in pair:
        ix.index(range(801, 1024), sigs[801:])  # also indexes the staged row 800
    _same(pair, lambda ix: ix.query_batch(q, 10, return_scores=True))
    for key in (0, 555, 800, 1023):
        np.testing.assert_array_equal(pair[0].get_minhash_hashvalues(key),
                                      pair[1].get_minhash_hashvalues(key))
    s0, s1 = pair[0].status(), pair[1].status()
    for name in ("n_indexed", "n_pending", "trees", "prefix_len", "cap", "max_leaf_run",
                 "last_truncated"):
        assert s0[name] == s1[name], name
    assert s0["n_padded"] == 0 and s0["device_bytes"] > 0
    for ix in pair:
        ix.warmup(batch_sizes=(8, 3), k=4)
    assert pair[0].last_truncated == pair[1].last_truncated
    ours = pair[0]
    for bad in (lambda: ours.add(1, sigs[1]), lambda: ours.index([1], sigs[:1]),
                lambda: ours.index(keys=[5000]), lambda: ours.query_batch(q, 0),
                lambda: ours.query_batch(q, 5, rank="x"), lambda: ours.query_batch(q, 5, method="x"),
                lambda: ours.add(9999, sigs[0, :64]),
                lambda: TorchMinHashLSHForest(l=0, device="cpu"),
                lambda: TorchMinHashLSHForest(num_perm=4, l=8, device="cpu"),
                lambda: TorchMinHashLSHForest(pool=-1, device="cpu"),
                lambda: TorchMinHashLSHForest(cascade_perm=64, device="cpu")):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(KeyError):
        ours.get_minhash_hashvalues("missing")
    assert ours.query_batch(np.zeros((0, P), np.uint32), 5) == []


def test_query_stream_matches(forest):
    pair, sigs, q = forest
    batches = [q[i: i + 10] for i in range(0, len(q), 10)]
    for kw in ({"rank": "forest"}, {"rank": "jaccard", "method": "scan"}):
        want = list(pair[1].query_stream(batches, 10, return_scores=True, depth=2, **kw))
        got = []
        for batch, rows in zip(batches, pair[0].query_stream(batches, 10, return_scores=True,
                                                              depth=2, **kw)):
            trunc = pair[0].last_truncated
            assert rows == pair[0].query_batch(batch, 10, return_scores=True, **kw)
            assert trunc == pair[0].last_truncated
            got.append(rows)
        assert got == want
    with pytest.raises(ValueError, match="positive"):
        pair[0].query_stream(batches, 0)
    empty = TorchMinHashLSHForest(num_perm=P, device="cpu")
    assert list(empty.query_stream(batches[:2], 5)) == [[[]] * 10] * 2


def _npz_arrays(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def test_npz_files_load_across_packages(tmp_path):
    sigs = _sigs(1500, 256, 11)
    q = _queries(sigs, 20, 12)
    keys = [("doc", i) for i in range(1500)]
    pair = _pair(sigs, keys=keys, num_perm=P, l=8, cap=32, rank="jaccard", cascade_perm=256,
                 pool=128, method="forest")
    for ix in pair:
        ix.add(("late", 0), sigs[0])  # staged: save indexes it first
        ix.save(str(tmp_path / type(ix).__name__))
    a = _npz_arrays(str(tmp_path / "TorchMinHashLSHForest.npz"))
    b = _npz_arrays(str(tmp_path / "TpuMinHashLSHForest.npz"))
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name])
    loaded = (TorchMinHashLSHForest.load(str(tmp_path / "TpuMinHashLSHForest.npz"),
                                         device="cpu"),
              TpuMinHashLSHForest.load(str(tmp_path / "TorchMinHashLSHForest")))
    assert (loaded[0].rank, loaded[0].pool, loaded[0].method) == ("jaccard", 128, "forest")
    _same(loaded, lambda ix: ix.query_batch(q, 10, return_scores=True))
    empty = TorchMinHashLSHForest(num_perm=P, device="cpu")
    empty.save(str(tmp_path / "empty"))
    assert TpuMinHashLSHForest.load(str(tmp_path / "empty.npz")).is_empty()


def _host_pair(n=400, l=8, seed=13):
    sigs = _sigs(n, P, seed)
    ours, ref = MinHashLSHForest(num_perm=P, l=l), JaxForest(num_perm=P, l=l)
    for i, row in enumerate(sigs):
        ours.add(i, MinHash(hashvalues=row))
        ref.add(i, JaxMinHash(hashvalues=row))
    ours.index()
    ref.index()
    return ours, ref, sigs


def test_host_forest_matches():
    ours, ref, sigs = _host_pair()
    q = _queries(sigs, 20, 14)
    for k in (1, 5, 30):
        assert ours.query_batch([MinHash(hashvalues=r) for r in q], k) == \
            ref.query_batch([JaxMinHash(hashvalues=r) for r in q], k)
    assert ours.query(MinHash(hashvalues=q[0]), 5) == ref.query(JaxMinHash(hashvalues=q[0]), 5)
    np.testing.assert_array_equal(ours.get_minhash_hashvalues(3), ref.get_minhash_hashvalues(3))
    assert 3 in ours and not ours.is_empty()
    assert WeightedMinHashLSHForest is MinHashLSHForest
    w = WeightedMinHashLSHForest(num_perm=P)
    kt = np.random.RandomState(1).randint(0, 9, (50, P, 2))
    for i in range(50):
        w.add(i, WeightedMinHash(1, kt[i]))
    w.index()
    assert 0 in w.query(WeightedMinHash(1, kt[0]), 3)
    with pytest.raises(ValueError):
        ours.add(3, MinHash(hashvalues=sigs[3]))


def test_front_ends_and_a_width_below_num_perm():
    """``index_tokens`` / ``index_text`` (ids and shingles hashed by the
    kernel's plain twin here) answer as the JAX facade's; num_perm 100 with
    l 8 reads only the first 96 slots, as the reference does."""
    rng = np.random.RandomState(21)
    docs = [rng.randint(0, 3000, rng.randint(5, 80)) for _ in range(300)]
    texts = [bytes(rng.randint(97, 105, rng.randint(20, 120), dtype=np.uint8)) for _ in range(300)]
    for call, data, kw in (("index_tokens", docs, {}), ("index_text", texts, {"k": 4})):
        pair = (TorchMinHashLSHForest(num_perm=100, l=8, device="cpu"),
                TpuMinHashLSHForest(num_perm=100, l=8))
        for ix in pair:
            getattr(ix, call)(list(range(300)), data, **kw)
        assert pair[0].score_width == 96
        if call == "index_tokens":
            q = JaxMinHash.bulk_signatures(docs[:20], num_perm=100, hashfunc="device")
        else:
            q = JaxMinHash.bulk_from_text(texts[:20], k=4, num_perm=100, hashfunc="device")
        for rank in ("forest", "jaccard"):
            _same(pair, lambda ix: ix.query_batch(q, 5, True, rank=rank))
        np.testing.assert_array_equal(pair[0].get_minhash_hashvalues(7),
                                      pair[1].get_minhash_hashvalues(7))
    with pytest.raises(ValueError, match="equal length"):
        pair[0].index_text([1, 2], texts[:1])
