"""Port parity: ``ops.lsh_ops.containment_scan`` (kernel 2's sizes mode for
k <= 128 and the emit variant's pass and rescan above, through their plain
versions) against the JAX package's ``containment_scan`` in its lax.scan
form and in its fused Pallas form (interpret mode, through the package's
SCORE_KERNEL_INTERPRET switch) -- exact: ids, f32 containment scores and
match counts."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from datasketch_tpu.ops import lsh_ops as jax_lsh
from datasketch_tpu_torch.kernels import lsh_scan
from datasketch_tpu_torch.ops import lsh_ops

torch.set_num_threads(2)


def _case(p, n=700, nq=21, seed=44):
    """3-valued signatures (many equal-count rows), sizes 20..399 with
    every 17th row padding (size 0), a tie block of 2-valued rows of equal
    size, queries drawn from the table with 40 slots redrawn, one of size
    1 and one of size 0 (counted as 1)."""
    rng = np.random.RandomState(seed)
    db = rng.randint(0, 3, size=(n, p)).astype(np.uint32)
    db[600:] = rng.randint(0, 2, size=(n - 600, p))
    sizes = rng.randint(20, 400, size=n).astype(np.int32)
    sizes[600:] = 150
    sizes[::17] = 0
    q = db[rng.randint(0, n, size=nq)].copy()
    q[:, :40] = rng.randint(0, 3, size=(nq, 40))
    q[-3:] = db[600:603]
    q_sizes = rng.randint(20, 400, size=nq).astype(np.int32)
    q_sizes[:2] = [1, 0]
    return db, sizes, q, q_sizes


def _port(db, sizes, q, q_sizes, cutoff, k):
    t = [torch.from_numpy(x.view(np.int32)) for x in (db, sizes, q, q_sizes)]
    return [x.numpy() for x in lsh_ops.containment_scan(*t, cutoff, k)]


def _jax(db, sizes, q, q_sizes, cutoff, k, fused, tile=128):
    args = (jnp.asarray(db), jnp.asarray(sizes), jnp.asarray(q), jnp.asarray(q_sizes),
            jnp.float32(cutoff))
    jax_lsh.containment_scan.clear_cache()
    jax_lsh.SCORE_KERNEL_INTERPRET = fused
    try:
        return [np.asarray(x) for x in jax_lsh.containment_scan(*args, k, tile=tile)]
    finally:
        jax_lsh.SCORE_KERNEL_INTERPRET = False
        jax_lsh.containment_scan.clear_cache()


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("p,k", [(128, 9), (128, 128), (384, 9), (384, 128)])
def test_containment_scan_matches_both_jax_forms(p, k):
    case = _case(p)
    got = _port(*case, 0.6, k)
    _eq(got, _jax(*case, 0.6, k, fused=False))
    _eq(got, _jax(*case, 0.6, k, fused=True))
    ids, sc, cnt = got
    assert (cnt > k).any() and (cnt <= k).any()  # truncated and complete rows
    sizes = case[1]
    assert not np.isin(ids[ids >= 0], np.nonzero(sizes == 0)[0]).any()
    assert (sc[ids >= 0] >= np.float32(0.6)).all()


@pytest.mark.parametrize("cutoff", [0.0, 0.95])
def test_containment_scan_large_k_matches_jax_scan_form(cutoff):
    """k > 128 at P = 66: the emission route (one pass of the emit
    variant's plain twin at cap 200, a rescan of the queries past it)
    against the lax.scan form in 256-row tiles."""
    case = _case(66)
    got = _port(*case, cutoff, 200)
    _eq(got, _jax(*case, cutoff, 200, fused=False, tile=256))
    assert got[0].shape == (21, 200)


def test_containment_scan_cpu_tensors_take_the_plain_version():
    db, sizes, q, q_sizes = (torch.from_numpy(x.view(np.int32)) for x in _case(128))
    before = (lsh_scan.launches, lsh_scan.launches_sizes)
    got = lsh_scan.containment_topk(db, sizes, q, q_sizes, 5, 0.5)
    want = lsh_scan.containment_topk_plain(db, sizes, q, q_sizes, 5, 0.5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (lsh_scan.launches, lsh_scan.launches_sizes) == before
    with pytest.raises(ValueError, match="1 <= k <= 128"):
        lsh_scan.containment_topk(db, sizes, q, q_sizes, 129, 0.5)
