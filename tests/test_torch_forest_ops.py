"""Port parity: ``ops/forest_ops.py`` against the JAX package's forest ops on
the CPU -- prefix fingerprints, the forest build (the card's per-level
stable sorts against ``np.lexsort``), the per-level run narrowing with its
truncation count, and the two-phase top-k at both ranks over pools 0 / 64
/ 512 and k 1 / 10 / 200. Everything must be equal: ids, levels, f32
scores and counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datasketch_tpu.ops import forest_ops as jax_forest
from datasketch_tpu_torch.ops import forest_ops

torch.set_num_threads(2)


def _sigs(n, p, seed, values=0):
    """uint32[n, p]: random rows, 1/4 of them near-copies of earlier rows
    (shared prefixes of every length); ``values`` > 0 draws slots from
    0..values-1 (long equal runs)."""
    rng = np.random.RandomState(seed)
    hi = values or (1 << 32)
    sigs = rng.randint(0, hi, size=(n, p), dtype=np.uint64).astype(np.uint32)
    dst = rng.choice(n, n // 4, replace=False)
    src = rng.randint(0, n, n // 4)
    cut = rng.randint(0, p, n // 4)
    for d, s, c in zip(dst, src, cut):
        sigs[d, :c] = sigs[s, :c]
    return sigs


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("n,p,l", [(1024, 128, 8), (1500, 66, 6), (300, 64, 4)])
def test_prefix_fingerprints_and_build_match(n, p, l):
    sigs = _sigs(n, p, n, values=16 if n == 300 else 0)
    k = p // l
    fps = forest_ops.prefix_fingerprints(_t(sigs), l, k)
    want = np.asarray(jax_forest.prefix_fingerprints(jnp.asarray(sigs), l, k))
    np.testing.assert_array_equal(forest_ops.fingerprints_u32(fps), want)
    got_fps, got_ids = forest_ops.build_forest(fps)
    host_fps, host_ids = forest_ops.build_forest_host(sigs, l, k)
    ref_fps, ref_ids = jax_forest.build_forest_host(sigs, l, k)
    np.testing.assert_array_equal(host_fps, ref_fps)
    np.testing.assert_array_equal(host_ids, ref_ids)
    np.testing.assert_array_equal(forest_ops.fingerprints_u32(got_fps), ref_fps)
    np.testing.assert_array_equal(got_ids.numpy(), ref_ids)
    assert got_ids.dtype == torch.int32 and got_fps.dtype == torch.int32


def test_build_matches_the_jax_device_sort():
    sigs = _sigs(500, 32, 3, values=4)
    fps = forest_ops.prefix_fingerprints(_t(sigs), 8, 4)
    got_fps, got_ids = forest_ops.build_forest(fps)
    ref_fps, ref_ids = jax_forest.build_forest(
        jax_forest.prefix_fingerprints(jnp.asarray(sigs), 8, 4))
    np.testing.assert_array_equal(forest_ops.fingerprints_u32(got_fps), np.asarray(ref_fps))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))


def _tables(sigs, l, k):
    ours = forest_ops.build_forest(forest_ops.prefix_fingerprints(_t(sigs), l, k))
    ref = tuple(jnp.asarray(x) for x in jax_forest.build_forest_host(sigs, l, k))
    return ours, ref


def _queries(sigs, nq, seed):
    rng = np.random.RandomState(seed)
    q = sigs[rng.randint(0, sigs.shape[0], nq)].copy()
    keep = rng.rand(*q.shape) < rng.uniform(0.3, 1.0, (nq, 1))
    q = np.where(keep, q, rng.randint(0, 1 << 32, q.shape, dtype=np.uint64).astype(np.uint32))
    q[-1] = rng.randint(0, 1 << 32, q.shape[1], dtype=np.uint64)  # matches nothing
    return q


@pytest.mark.parametrize("cap", [4, 64])
def test_query_forest_matches(cap):
    sigs = _sigs(1024, 128, 5, values=64)
    q = _queries(sigs, 24, 6)
    (fps, ids), (rfps, rids) = _tables(sigs, 8, 16)
    got, trunc = forest_ops.query_forest(fps, ids, forest_ops.prefix_fingerprints(_t(q), 8, 16),
                                         cap)
    want, rtrunc = jax_forest.query_forest(
        rfps, rids, jax_forest.prefix_fingerprints(jnp.asarray(q), 8, 16), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(trunc) == int(rtrunc)
    assert (int(trunc) > 0) == (cap == 4)


@pytest.fixture(scope="module")
def walk():
    """One walk over 1,500 rows at P 66 (l 6, k 11; scores are
    f32(count) * f32(1/66)) and one at P 128, 40 queries each."""
    out = {}
    for p, l in ((66, 6), (128, 8)):
        sigs = _sigs(1500, p, p, values=256)
        q = _queries(sigs, 40, p + 1)
        k = p // l
        (fps, ids), (rfps, rids) = _tables(sigs, l, k)
        level, _ = forest_ops.query_forest(fps, ids, forest_ops.prefix_fingerprints(_t(q), l, k),
                                           32)
        rlevel, _ = jax_forest.query_forest(
            rfps, rids, jax_forest.prefix_fingerprints(jnp.asarray(q), l, k), 32)
        out[p] = (sigs, q, level, rlevel)
    return out


@pytest.mark.parametrize("p", [66, 128])
@pytest.mark.parametrize("rank", ["forest", "jaccard"])
@pytest.mark.parametrize("pool,k_out", [(0, 10), (64, 1), (64, 200), (512, 10), (0, 200)])
def test_forest_topk_matches(walk, p, rank, pool, k_out):
    sigs, q, level, rlevel = walk[p]
    got = forest_ops.forest_topk(_t(sigs), _t(q), level, k_out, pool=pool, rank=rank)
    want = jax_forest.forest_topk(jnp.asarray(sigs), jnp.asarray(q), rlevel, k_out,
                                  pool=pool, rank=rank)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.float32 and (got[0][:, 0] >= 0).sum() > len(q) // 2


def test_forest_topk_n_valid_and_bad_rank(walk):
    sigs, q, level, rlevel = walk[128]
    got = forest_ops.forest_topk(_t(sigs), _t(q), level, 10, n_valid=700, rank="jaccard")
    want = jax_forest.forest_topk(jnp.asarray(sigs), jnp.asarray(q), rlevel, 10,
                                  n_valid=jnp.int32(700), rank="jaccard")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="rank"):
        forest_ops.forest_topk(_t(sigs), _t(q), level, 10, rank="depth")


@pytest.mark.parametrize("nq", [5, 8])
def test_forest_query_fused_counts_zero_rows(nq):
    sigs = _sigs(1024, 128, 7, values=32)
    sigs[:20, :16] = 0  # rows a zero query walks into
    q = _queries(sigs, nq, 8)
    (fps, ids), (rfps, rids) = _tables(sigs, 8, 16)
    q_pad = 8
    got = forest_ops.forest_query_fused(fps, ids, _t(sigs), _t(q), 8, 16, 4, 16,
                                        rank="jaccard", zero_rows=q_pad - nq)
    padded = np.pad(q, ((0, q_pad - nq), (0, 0)))
    want = jax_forest.forest_query_fused(rfps, rids, jnp.asarray(sigs), jnp.asarray(padded), 8,
                                         16, 4, 16, rank="jaccard")
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:nq])
    assert int(got[3]) == int(want[3]) > 0
