"""The HNSW graph ops of the port against the JAX package on the CPU.

``datasketch_tpu_torch.ops.hnsw_ops`` / ``knn_graph`` (``device="cpu"``:
kernels 2 and 4 run their plain twins) against
``datasketch_tpu.ops.hnsw_ops`` / ``knn_graph`` on the same seeded numpy
inputs. Under ``minhash_jaccard`` and on integer-valued ``l2`` points every
result is equal bit for bit; ``cosine`` and ``l2`` on random floats sum in
another order than XLA, so their distances are held within rtol 1e-6 and
their ids exactly, on data whose distance gaps the test checks first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datasketch_tpu import HNSW as JaxHNSW
from datasketch_tpu.ops import hnsw_ops as jh
from datasketch_tpu.ops import knn_graph as jk
from datasketch_tpu_torch import HNSW
from datasketch_tpu_torch.ops import hnsw_ops as th
from datasketch_tpu_torch.ops import knn_graph as tk

torch.set_num_threads(2)

RTOL = 1e-6


def _sigs(n, p, seed, alphabet=3):
    """uint32 signatures over a small slot alphabet: heavy distance ties."""
    return np.random.RandomState(seed).randint(0, alphabet, (n, p)).astype(np.uint32)


def _int_points(n, d, seed):
    """Integer-valued f32 points: every partial l2 sum is exact."""
    return np.random.RandomState(seed).randint(-8, 9, (n, d)).astype(np.float32)


def _float_points(n, d, seed):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def _t(x):
    return th.as_points(x, "cpu")


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("p", [66, 128])
def test_minhash_distance_rounds_as_jax(p):
    q, pts = _sigs(5, p, 1), _sigs(300, p, 2)
    pts[:p + 1] = 0
    for c in range(p + 1):  # every count once
        pts[c, c:] = 7
    q[0] = 0
    want = _np(jax.jit(jh._distance_fn("minhash_jaccard"))(q, pts[None]))
    got = th.distance_fn("minhash_jaccard")(_t(q), _t(pts)[None]).numpy()
    assert np.array_equal(got, want)
    # outside jit (on JAX arrays) the JAX package rounds the product first
    want = _np(jh._distance_fn("minhash_jaccard")(jnp.asarray(q), jnp.asarray(pts)[None]))
    got = th.eager_distance_fn("minhash_jaccard")(_t(q), _t(pts)[None]).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("metric,points,exact", [
    ("l2", _int_points, True), ("l2", _float_points, False), ("cosine", _float_points, False),
])
def test_float_distances(metric, points, exact):
    q, pts = points(7, 24, 3), points(200, 24, 4)
    jit = jax.jit(jh._distance_fn(metric))
    want = _np(jit(q, pts[None]))
    got = th.distance_fn(metric)(_t(q), _t(pts)[None]).numpy()
    if exact:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL)
    # the broadcast form the pruning uses: [R, C, D] against [R, 1, C, D]
    c = pts[:60].reshape(3, 20, 24)
    want = _np(jit(c, c[:, None]))
    got = th.distance_fn(metric)(_t(c), _t(c)[:, None]).numpy()
    np.testing.assert_allclose(got, want, rtol=0 if exact else RTOL, atol=0 if exact else 1e-6)


def test_unknown_metric_raises():
    for resolve in (th.distance_fn, th.eager_distance_fn):
        with pytest.raises(ValueError, match="unknown metric"):
            resolve("hamming")


@pytest.mark.parametrize("p,alphabet", [(66, 2), (66, 4), (128, 3)])
@pytest.mark.parametrize("route", ["scan", "score", "tiles"])
def test_knn_adjacency_minhash_routes(p, alphabet, route):
    pts = _sigs(300, p, p + alphabet, alphabet)
    pts[40:50] = pts[7]  # ten copies of row 7 beside it: more than k + 1 at count P
    for k in (3, 24):
        want = _np(jk.knn_adjacency(pts, k=k, metric="minhash_jaccard"))
        got = tk.knn_adjacency(pts, k=k, metric="minhash_jaccard", device="cpu", _route=route)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), (route, k)
    rows = np.array([45, 7, 0, 299])
    got = tk.knn_adjacency(pts, k=24, metric="minhash_jaccard", device="cpu", _route=route,
                           rows=rows, tile=1)
    assert np.array_equal(got.numpy(), want[rows])


def test_knn_route_dispatch():
    sig = _t(_sigs(20, 128, 0))
    assert tk.knn_route(sig, 127, "minhash_jaccard") == "scan"
    assert tk.knn_route(sig, 128, "minhash_jaccard") == "score"
    assert tk.knn_route(_t(_sigs(20, 300, 0)), 16, "minhash_jaccard") == "score"
    assert tk.knn_route(_t(_sigs(20, 700, 0)), 16, "minhash_jaccard") == "tiles"
    assert tk.knn_route(_t(_float_points(20, 8, 0)), 16, "minhash_jaccard") == "tiles"
    assert tk.knn_route(sig, 16, "l2") == "tiles"


def _check_no_near_ties(metric, pts, q, k):
    """Every query's k + 1 nearest distances lie more than 4 x RTOL apart,
    so a few ulps of another summation order cannot reorder them."""
    d = np.sort(_np(jax.jit(jh._distance_fn(metric))(q, pts[None])), axis=1)[:, : k + 2]
    assert (np.diff(d, axis=1) > 4 * RTOL * np.abs(d[:, 1:])).all()


@pytest.mark.parametrize("metric,points", [("l2", _int_points), ("l2", _float_points),
                                           ("cosine", _float_points)])
def test_knn_adjacency_float_metrics(metric, points):
    pts = points(200, 16, 0)
    if points is _float_points:
        _check_no_near_ties(metric, pts, pts, 10)
    want = _np(jk.knn_adjacency(pts, k=10, metric=metric, tile=64))
    for tile in (1, 256):
        got = tk.knn_adjacency(pts, k=10, metric=metric, tile=tile, device="cpu")
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_batch_query_float_metrics(metric):
    """The same graph (built by the JAX package) queried by both packages:
    equal ids, distances within RTOL."""
    pts, q = _float_points(200, 16, 0), _float_points(30, 16, 1)
    _check_no_near_ties(metric, pts, q, 10)
    gj = jk.build_nsw_graph(pts, m=8, metric=metric)
    gt = th.DeviceGraph(
        points=_t(pts), adj0=torch.tensor(_np(gj.adj0)),
        upper_nodes=[torch.tensor(_np(u).astype(np.int64)) for u in gj.upper_nodes],
        upper_adj=[torch.tensor(_np(a)) for a in gj.upper_adj],
        entry=gj.entry, keys=gj.keys, deleted=torch.zeros(200, dtype=torch.bool))
    want = jh.batch_query(gj, q, k=10, ef=32, metric=metric)
    got = th.batch_query(gt, q, k=10, ef=32, metric=metric)
    for rg, rw in zip(got, want):
        assert [k for k, _ in rg] == [k for k, _ in rw]
        np.testing.assert_allclose([d for _, d in rg], [d for _, d in rw], rtol=RTOL)


@pytest.mark.parametrize("metric,points", [
    ("minhash_jaccard", lambda n, s: _sigs(n, 66, s, 3)),
    ("minhash_jaccard", lambda n, s: _sigs(n, 128, s, 4)),
    ("l2", lambda n, s: _int_points(n, 12, s)),
])
def test_prune_diverse(metric, points):
    pts = points(300, 21)
    cands = _np(jk.knn_adjacency(pts, k=24, metric=metric))
    want = _np(jk._prune_diverse(pts, cands, 8, 128, jh._distance_fn(metric)))
    for tile in (1, 128):
        got = tk._prune_diverse(_t(pts), torch.from_numpy(cands), 8, tile,
                                th.distance_fn(metric))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric,points", [
    ("minhash_jaccard", lambda n, s: _sigs(n, 66, s, 3)),
    ("l2", lambda n, s: _int_points(n, 12, s)),
])
def test_prune_candidates_with_invalid_and_unsorted_ids(metric, points):
    all_pts = points(200, 5)
    node_pts = points(40, 6)
    rng = np.random.RandomState(7)
    cands = rng.randint(0, 200, (40, 30)).astype(np.int32)
    cands[rng.rand(40, 30) < 0.3] = -1
    cands[3] = -1  # a row with no candidate
    cands[5, :] = 11  # one candidate many times
    def run(m):
        return tk.prune_candidates(_t(node_pts), torch.from_numpy(cands), _t(all_pts), m,
                                   th.distance_fn(metric), tile=16).numpy()

    for m in (4, 30):
        want = _np(jk.prune_candidates(node_pts, cands, all_pts, m, jh._distance_fn(metric)))
        assert np.array_equal(run(m), want), m
    # m above the 30 candidates: the JAX package's output reshapes rows of
    # 30 as rows of m (its quirk at n - 1 < m, below); the port pads
    assert np.array_equal(run(32), np.pad(want, ((0, 0), (0, 2)), constant_values=-1))


def _same_graph(gt, gj):
    assert np.array_equal(gt.adj0.numpy(), _np(gj.adj0))
    assert gt.entry == gj.entry
    assert len(gt.upper_nodes) == len(gj.upper_nodes)
    for a, b in zip(gt.upper_nodes, gj.upper_nodes):
        assert np.array_equal(a.numpy(), _np(b))
    for a, b in zip(gt.upper_adj, gj.upper_adj):
        assert np.array_equal(a.numpy(), _np(b))
    assert gt.keys == gj.keys


@pytest.mark.parametrize("n", [1, 40, 300, 1500])
@pytest.mark.parametrize("metric,points", [
    ("minhash_jaccard", lambda n: _sigs(n, 66, n, 4)),
    ("l2", lambda n: _int_points(n, 10, n)),
])
def test_build_nsw_graph(n, metric, points):
    pts = points(n)
    keys = ["k%d" % i for i in range(n)]
    gj = jk.build_nsw_graph(pts, keys=keys, m=8, metric=metric)
    gt = tk.build_nsw_graph(pts, keys=keys, m=8, metric=metric, device="cpu")
    _same_graph(gt, gj)
    if n == 1500:
        assert len(gt.upper_nodes) == 2
    if n > 1:
        q = pts[: min(n, 24)]
        for ef in (8, 32):
            want = jh.batch_query(gj, q, k=10, ef=ef, metric=metric)
            assert th.batch_query(gt, q, k=10, ef=ef, metric=metric) == want


def test_build_nsw_graph_m48_takes_the_score_route():
    pts = _sigs(300, 66, 48, 3)
    gj = jk.build_nsw_graph(pts, m=48, metric="minhash_jaccard")
    gt = tk.build_nsw_graph(pts, m=48, metric="minhash_jaccard", device="cpu")
    _same_graph(gt, gj)


def test_build_nsw_graph_at_n_at_most_m_keeps_its_rows():
    """With n - 1 < m the JAX package's pruning reshapes its [tile, n - 1]
    output as rows of m and so mixes up rows (self-loops, lost edges); the
    port keeps each node's own pruned edges, -1 padded."""
    pts = _int_points(2, 4, 0)
    gj = jk.build_nsw_graph(pts, m=8, metric="l2")
    gt = tk.build_nsw_graph(pts, m=8, metric="l2", device="cpu")
    assert (_np(gj.adj0)[0] == 0).any()  # the JAX package's self-loop
    want = np.full((2, 16), -1, np.int32)
    want[0, 0], want[1, 0] = 1, 0
    assert np.array_equal(gt.adj0.numpy(), want)
    assert gt.entry == 0 and gt.upper_nodes == []
    pts = _int_points(5, 4, 1)
    cands = _np(jk.knn_adjacency(pts, k=4))
    dist = jh._distance_fn("l2")
    # JAX pruning at m = n - 1 (where its rows stay whole), -1 padded to m
    want = np.pad(_np(jk._prune_diverse(pts, cands, 4, 256, dist)), ((0, 0), (0, 4)),
                  constant_values=-1)
    got = tk._prune_diverse(_t(pts), torch.from_numpy(cands), 8, 256, th.distance_fn("l2"))
    assert np.array_equal(got.numpy(), want)


def test_build_nsw_graph_zero_points_raises():
    with pytest.raises(ValueError, match="zero points"):
        tk.build_nsw_graph(np.zeros((0, 4), np.float32), device="cpu")


@pytest.mark.parametrize("metric,points", [
    ("minhash_jaccard", lambda n: _sigs(n, 66, 3, 4)),
    ("l2", lambda n: _int_points(n, 10, 3)),
])
def test_batch_query_with_tombstones(metric, points):
    pts = points(500)
    gj = jk.build_nsw_graph(pts, m=8, metric=metric)
    gt = tk.build_nsw_graph(pts, m=8, metric=metric, device="cpu")
    dead = np.random.RandomState(1).rand(500) < 0.3
    gj.deleted = jnp.asarray(dead)
    gt.deleted = torch.from_numpy(dead)
    q = points(540)[480:540]  # 20 stored rows (some dead) and 40 others
    for k, ef, iters in ((10, 16, None), (5, 64, 20), (64, 64, None)):
        want = jh.batch_query(gj, q, k=k, ef=ef, metric=metric, iters=iters)
        got = th.batch_query(gt, q, k=k, ef=ef, metric=metric, iters=iters)
        assert got == want
        assert all(not dead[key] for row in got for key, _ in row)


def _host_index(cls, pts, seed=5):
    def l2(x, y):
        return float(np.linalg.norm(x - y))

    def batch_l2(q, m):
        return np.linalg.norm(np.asarray(m) - q, axis=1)

    index = cls(distance_func=l2, batch_distance_func=batch_l2, m=8, ef_construction=64,
                seed=seed)
    for i in range(pts.shape[0]):
        index.insert(i, pts[i])
    return index


def test_export_graph_and_query():
    pts = _float_points(200, 12, 5)
    ij, it = _host_index(JaxHNSW, pts), _host_index(HNSW, pts)
    for key in (3, 17, 90):
        ij.remove(key)
        it.remove(key)
    ij.remove(40, hard=True)
    it.remove(40, hard=True)
    gj, gt = jh.export_graph(ij), th.export_graph(it, device="cpu")
    assert gt.entry == gj.entry and gt.keys == gj.keys
    assert np.array_equal(gt.points.numpy(), _np(gj.points))
    assert np.array_equal(gt.adj0.numpy(), _np(gj.adj0))
    assert np.array_equal(gt.deleted.numpy(), _np(gj.deleted))
    for a, b, c, d in zip(gt.upper_nodes, gj.upper_nodes, gt.upper_adj, gj.upper_adj):
        assert np.array_equal(a.numpy(), _np(b)) and np.array_equal(c.numpy(), _np(d))
    q = _float_points(30, 12, 6)
    want = jh.batch_query(gj, q, k=8, ef=32, metric="l2")
    got = th.batch_query(gt, q, k=8, ef=32, metric="l2")
    for rg, rw in zip(got, want):
        assert [k for k, _ in rg] == [k for k, _ in rw]
        np.testing.assert_allclose([d for _, d in rg], [d for _, d in rw], rtol=RTOL)
