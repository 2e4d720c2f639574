"""Port parity: LSH band tables, reranks, selections and scans (kernels 2,
3 and 4 through their plain versions) against the JAX package's
lsh_ops on the same numpy inputs -- exact, f32 scores included. The JAX
Pallas bodies are reached in interpret mode through the package's
SCORE_KERNEL_INTERPRET switch."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from datasketch_tpu.ops import lsh_ops as jax_lsh
from datasketch_tpu_torch.ops import lsh_ops

torch.set_num_threads(2)

P = 128
B, R = 8, 4  # 32 banded slots: small buckets collide often


def _sigs(n, seed, values=0):
    """uint32[n, P]: full-range, or 0..values-1 (planted ties)."""
    rng = np.random.RandomState(seed)
    hi = values or (1 << 32)
    return rng.randint(0, hi, size=(n, P), dtype=np.uint64).astype(np.uint32)


def _near(rows, keep, seed):
    rng = np.random.RandomState(seed)
    noise = rng.randint(0, 1 << 32, size=rows.shape, dtype=np.uint64).astype(np.uint32)
    return np.where(rng.rand(*rows.shape) < keep, rows, noise)


def _t(x):
    x = np.array(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def corpus():
    """A clustered table: 600 random rows, 200 near-copies of them, and a
    tie-heavy block of low-cardinality rows; queries are near-copies."""
    base = _sigs(600, 1)
    near = _near(base[np.random.RandomState(2).randint(0, 600, 200)], 0.8, 3)
    ties = _sigs(224, 4, values=2)
    db = np.concatenate([base, near, ties])
    q = np.concatenate([_near(db[:40], 0.7, 5), _sigs(8, 6, values=2)])
    return db, q


def _tables(db, b=B, r=R):
    fps = lsh_ops.band_fingerprints(_t(db), b, r)
    return fps, lsh_ops.build_tables(fps)


def test_band_fingerprints_and_tables_match_jax(corpus):
    db, _ = corpus
    fps, (sf, si) = _tables(db)
    jfps = jax_lsh.band_fingerprints(db, B, R)
    _eq(fps, jfps)
    jsf, jsi = jax_lsh.build_tables(jfps)
    _eq(sf, jsf)
    _eq(si, jsi)
    for got, want in zip(lsh_ops.bucket_stats(sf), jax_lsh.bucket_stats(jsf)):
        _eq(got, want)


@pytest.mark.parametrize("cap", [4, 64])
def test_query_tables_matches_jax_with_truncation(corpus, cap):
    db, q = corpus
    _, (sf, si) = _tables(db)
    qf = lsh_ops.band_fingerprints(_t(q), B, R)
    ids, trunc = lsh_ops.query_tables(sf, si, qf, cap=cap)
    jsf, jsi = jax_lsh.build_tables(jax_lsh.band_fingerprints(db, B, R))
    jids, jtrunc = jax_lsh.query_tables(jsf, jsi, jax_lsh.band_fingerprints(q, B, R),
                                        cap=cap)
    _eq(ids, jids)
    assert int(trunc) == int(jtrunc)
    if cap == 4:
        assert int(trunc) > 0  # the tie block overflows small caps


def test_rerank_jaccard_matches_jax_and_pallas_branch(corpus):
    db, q = corpus
    rng = np.random.RandomState(8)
    cand = rng.randint(-1, db.shape[0], size=(q.shape[0], 70)).astype(np.int32)
    cand[3] = -1
    got = lsh_ops.rerank_jaccard(_t(db), _t(q), _t(cand))
    _eq(got, jax_lsh.rerank_jaccard(db, q, cand))
    jax_lsh.rerank_jaccard.clear_cache()
    jax_lsh.SCORE_KERNEL_INTERPRET = True
    try:
        want = jax_lsh.rerank_jaccard(jnp.asarray(db), jnp.asarray(q), jnp.asarray(cand))
        _eq(got, want)
    finally:
        jax_lsh.SCORE_KERNEL_INTERPRET = False
        jax_lsh.rerank_jaccard.clear_cache()


@pytest.mark.parametrize("p", [66, 100, 128])
@pytest.mark.parametrize("c", [1, 33, 333])
def test_rerank_plain_matches_jax_on_edge_lists(p, c):
    """Kernel 3's plain twin against the JAX package's ``rerank_jaccard`` on
    ``chip_smoke.rerank_edge_case``'s lists (a query of -1 slots only, one
    id in every slot, -1 between live slots, three ids in turn) over a
    tie-heavy table, at widths that are and are not multiples of 4."""
    import chip_smoke

    rng = np.random.RandomState(p * 7 + c)
    db = rng.randint(0, 4, size=(500, p)).astype(np.uint32)
    q = rng.randint(0, 4, size=(9, p)).astype(np.uint32)
    cand = chip_smoke.rerank_edge_case(torch, 500, 9, c, "cpu", seed=p + c)
    got = lsh_ops.rerank_jaccard(_t(db), _t(q), cand)
    assert (got[0] == 0).all()
    _eq(got, jax_lsh.rerank_jaccard(db, q, cand.numpy()))


def _band_scores(db, q, cap=16):
    """Candidates and rerank scores of the band path, from the JAX side."""
    jsf, jsi = jax_lsh.build_tables(jax_lsh.band_fingerprints(db, B, R))
    ids, _ = jax_lsh.query_tables(jsf, jsi, jax_lsh.band_fingerprints(q, B, R), cap=cap)
    flat = np.asarray(ids).reshape(q.shape[0], -1)
    return np.asarray(jax_lsh.rerank_jaccard(db, q, flat)), flat


@pytest.mark.parametrize("k,max_dup", [(3, B), (10, 0), (200, B)])
def test_topk_candidates_matches_jax(corpus, k, max_dup):
    scores, flat = _band_scores(*corpus)
    got = lsh_ops.topk_candidates(_t(scores), _t(flat), k, max_dup=max_dup)
    want = jax_lsh.topk_candidates(scores, flat, k, max_dup=max_dup)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("cutoff,max_out", [(0.5, 16), (0.3, 200), (-1.0, 64)])
def test_threshold_select_matches_jax(corpus, cutoff, max_out):
    scores, flat = _band_scores(*corpus)
    got = lsh_ops.threshold_select(_t(scores), _t(flat), cutoff, max_out)
    want = jax_lsh.threshold_select(scores, flat, jnp.float32(cutoff), max_out)
    for g, w in zip(got, want):
        _eq(g, w)
    got = lsh_ops.unique_compact(_t(flat), max_out)
    for g, w in zip(got, jax_lsh.unique_compact(flat, max_out)):
        _eq(g, w)


@pytest.mark.parametrize("k", [1, 10, 128, 200])
@pytest.mark.parametrize("masked", [False, True])
def test_topk_scan_matches_jax(corpus, k, masked):
    db, q = corpus
    n = db.shape[0]
    alive = np.random.RandomState(9).rand(n) > 0.2 if masked else None
    n_valid = n - 30 if masked else n
    ta = None if alive is None else torch.from_numpy(alive)
    ja = None if alive is None else jnp.asarray(alive)
    got = lsh_ops.topk_scan(_t(db), _t(q), k, n_valid=n_valid, alive=ta)
    want = jax_lsh.topk_scan(db, q, k, n_valid=jnp.int32(n_valid), alive=ja)
    for g, w in zip(got, want):
        _eq(g, w)
    got = lsh_ops.topk_scan(_t(db), _t(q), k, n_valid=n_valid, alive=ta, count_ge=0.5)
    want = jax_lsh.topk_scan(db, q, k, n_valid=jnp.int32(n_valid), alive=ja,
                             count_ge=jnp.float32(0.5))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("k,tile", [(7, 8192), (200, 256)])
def test_topk_scan_matches_jax_pallas_branch(corpus, k, tile):
    """k <= 128 reaches the fused Pallas scan, k > 128 the Pallas score
    matrix under the running top-k (interpret mode)."""
    db, q = corpus
    got = lsh_ops.topk_scan(_t(db), _t(q), k, count_ge=0.25)
    jax_lsh.topk_scan.clear_cache()
    jax_lsh.SCORE_KERNEL_INTERPRET = True
    try:
        want = jax_lsh.topk_scan(jnp.asarray(db), jnp.asarray(q), k, tile=tile,
                                 count_ge=jnp.float32(0.25))
        want = [np.asarray(w) for w in want]
    finally:
        jax_lsh.SCORE_KERNEL_INTERPRET = False
        jax_lsh.topk_scan.clear_cache()
    for g, w in zip(got, want):
        _eq(g, w)


def test_fused_pipelines_match_jax(corpus):
    db, q = corpus
    n_valid = db.shape[0] - 50
    _, (sf, si) = _tables(db)
    jsf, jsi = jax_lsh.build_tables(jax_lsh.band_fingerprints(db, B, R))
    tq, tdb = _t(q), _t(db)
    got = lsh_ops.topk_fused(sf, si, tdb, tq, B, R, 16, 5, n_valid=n_valid)
    want = jax_lsh.topk_fused(jsf, jsi, db, q, B, R, 16, 5, n_valid=jnp.int32(n_valid))
    for g, w in zip(got, want):
        _eq(g, w)
    got = lsh_ops.query_fused(sf, si, tdb, tq, B, R, 16, 0.5, 100, n_valid=n_valid)
    want = jax_lsh.query_fused(jsf, jsi, db, q, B, R, 16, jnp.float32(0.5), 100,
                               n_valid=jnp.int32(n_valid))
    for g, w in zip(got, want):
        _eq(g, w)
    got = lsh_ops.query_candidates_fused(sf, si, tq, B, R, 16, 100, n_valid=n_valid)
    want = jax_lsh.query_candidates_fused(jsf, jsi, q, B, R, 16, 100,
                                          n_valid=jnp.int32(n_valid))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("p", [66, 100])
def test_scores_match_jax_at_widths_that_are_not_powers_of_two(p):
    """Scores are f32(count) * f32(1/p) on both sides, not count / p."""
    from datasketch_tpu.ops import minhash_ops as jax_minhash
    from datasketch_tpu_torch.ops import minhash_ops

    rng = np.random.RandomState(p)
    db = rng.randint(0, 2, size=(700, p)).astype(np.uint32)
    q = rng.randint(0, 2, size=(9, p)).astype(np.uint32)
    cand = rng.randint(-1, 700, size=(9, 50)).astype(np.int32)
    _eq(lsh_ops.rerank_jaccard(_t(db), _t(q), _t(cand)),
        jax_lsh.rerank_jaccard(db, q, cand))
    _eq(minhash_ops.jaccard_matrix(_t(q), _t(db)), jax_minhash.jaccard_matrix(q, db))
    _eq(minhash_ops.jaccard_pairwise(_t(q), _t(db[:9])),
        jax_minhash.jaccard_pairwise(q, db[:9]))
    for k in (5, 200):
        got = lsh_ops.topk_scan(_t(db), _t(q), k, count_ge=0.5)
        want = jax_lsh.topk_scan(db, q, k, count_ge=jnp.float32(0.5))
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("n_buckets", [1, 64, 1000, 4096])
def test_build_offsets_and_direct_lookup_match_jax(corpus, n_buckets):
    """Half the fingerprints have bit 31 set: the bucket index is the
    unsigned shift of the int64 fingerprint, as JAX shifts its uint32."""
    db, q = corpus
    _, (sf, si) = _tables(db)
    assert bool((sf >= (1 << 31)).any())
    jsf, jsi = jax_lsh.build_tables(jax_lsh.band_fingerprints(db, B, R))
    off = lsh_ops.build_offsets(sf, n_buckets)
    joff = jax_lsh.build_offsets(jsf, n_buckets)
    _eq(off, joff)
    qf = lsh_ops.band_fingerprints(_t(q), B, R)
    jqf = jax_lsh.band_fingerprints(q, B, R)
    for cap in (4, 64):
        got = lsh_ops.query_tables_direct(sf, si, off, qf, cap, n_buckets)
        want = jax_lsh.query_tables_direct(jsf, jsi, joff, jqf, cap, n_buckets)
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("n_buckets", [64, 4096])
def test_fused_routes_by_direct_address_match_jax(corpus, n_buckets):
    db, q = corpus
    n_valid = db.shape[0] - 50
    _, (sf, si) = _tables(db)
    jsf, jsi = jax_lsh.build_tables(jax_lsh.band_fingerprints(db, B, R))
    off, joff = lsh_ops.build_offsets(sf, n_buckets), jax_lsh.build_offsets(jsf, n_buckets)
    tq, tdb = _t(q), _t(db)
    got = lsh_ops.topk_fused(sf, si, tdb, tq, B, R, 16, 5, offsets=off,
                             n_buckets=n_buckets, n_valid=n_valid)
    want = jax_lsh.topk_fused(jsf, jsi, db, q, B, R, 16, 5, offsets=joff,
                              n_buckets=n_buckets, n_valid=jnp.int32(n_valid))
    for g, w in zip(got, want):
        _eq(g, w)
    got = lsh_ops.query_fused(sf, si, tdb, tq, B, R, 16, 0.5, 100, offsets=off,
                              n_buckets=n_buckets)
    want = jax_lsh.query_fused(jsf, jsi, db, q, B, R, 16, jnp.float32(0.5), 100,
                               offsets=joff, n_buckets=n_buckets)
    for g, w in zip(got, want):
        _eq(g, w)
