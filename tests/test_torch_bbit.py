"""Port parity: the b-bit ops (``datasketch_tpu_torch.ops.bbit_ops``) and
kernel 5's plain twin against the JAX package on the same numpy inputs.
Every comparison is exact: packed words, counts, ids and their tie order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datasketch_tpu.ops import bbit_ops as jax_bbit
from datasketch_tpu.ops import pallas_kernels
from datasketch_tpu_torch.kernels import bbit
from datasketch_tpu_torch.ops import bbit_ops

torch.set_num_threads(2)

B_SWEEP = [1, 2, 3, 4, 5, 8, 12, 16, 32]
SLOTS = [1, 2, 4, 8, 16, 32]


def _rand_sigs(rng, n, p, low_bits=0):
    x = rng.randint(0, 1 << 32, size=(n, p), dtype=np.uint64)
    if low_bits:
        x &= np.uint64((1 << low_bits) - 1)
    return x.astype(np.uint32)


def _t(x):
    """uint32 numpy -> int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def test_slot_size_and_words_per_sig():
    for b in range(33):
        assert bbit_ops.slot_size(b) == jax_bbit.slot_size(b)
        for p in (1, 67, 100, 128, 256):
            assert bbit_ops.words_per_sig(p, b) == jax_bbit.words_per_sig(p, b)
    for fn in (bbit_ops.slot_size, jax_bbit.slot_size):
        with pytest.raises(ValueError):
            fn(33)


@pytest.mark.parametrize("b", B_SWEEP)
def test_pack_matches_jax(b):
    rng = np.random.RandomState(7 + b)
    for n, p in ((9, 67), (5, 128), (3, 100)):  # odd shapes give padding slots
        sigs = _rand_sigs(rng, n, p)
        want = np.asarray(jax_bbit.pack_bbit(jnp.asarray(sigs), b))
        np.testing.assert_array_equal(_u32(bbit_ops.pack_bbit(_t(sigs), b)), want)
        np.testing.assert_array_equal(bbit_ops.pack_bbit_host(sigs, b), want)


@pytest.mark.parametrize("b", SLOTS)
def test_counts_plain_matches_pallas_interpret(b):
    """Kernel 5's plain twin against the Pallas kernel in interpret mode,
    padding slots included, on low-cardinality bits (slots collide)."""
    rng = np.random.RandomState(31 + b)
    qp = jax_bbit.pack_bbit_host(_rand_sigs(rng, 8, 128, low_bits=2), b)
    dbp = jax_bbit.pack_bbit_host(_rand_sigs(rng, 128, 128, low_bits=2), b)
    s = jax_bbit.slot_size(b)
    want = np.asarray(pallas_kernels.bbit_scores_pallas(qp, dbp, s, interpret=True))
    got = bbit.bbit_counts(_t(qp), _t(dbp), s)  # a CPU tensor takes the twin
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(bbit.bbit_counts_plain(_t(qp), _t(dbp), s).numpy(), want)


@pytest.mark.parametrize("num_perm", [128, 100])
@pytest.mark.parametrize("b", B_SWEEP)
def test_match_counts_match_jax(b, num_perm):
    rng = np.random.RandomState(3 + b)
    db = _rand_sigs(rng, 23, num_perm, low_bits=3)
    q = _rand_sigs(rng, 6, num_perm, low_bits=3)
    q[0] = db[4]
    qp, dbp = (jax_bbit.pack_bbit_host(x, b) for x in (q, db))
    want = np.asarray(jax_bbit.match_counts(jnp.asarray(qp), jnp.asarray(dbp), b, num_perm))
    got = bbit_ops.match_counts(_t(qp), _t(dbp), b, num_perm)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 4]) == num_perm


def test_counts_plain_s32_is_word_equality():
    rng = np.random.RandomState(2)
    q = _rand_sigs(rng, 5, 40, low_bits=1)
    db = _rand_sigs(rng, 70, 40, low_bits=1)
    got = bbit.bbit_counts_plain(_t(q), _t(db), 32).numpy()
    np.testing.assert_array_equal(got, (q[:, None, :] == db[None, :, :]).sum(-1))
    with pytest.raises(ValueError, match="slot size"):
        bbit.bbit_counts_plain(_t(q), _t(db), 3)


@pytest.mark.parametrize("b,num_perm,low_bits", [(1, 128, 0), (4, 100, 2), (16, 64, 1),
                                                  (32, 32, 1)])
@pytest.mark.parametrize("case", ["plain", "n_valid", "alive", "k_above_live"])
def test_topk_scan_matches_jax(b, num_perm, low_bits, case):
    """Ids and counts in the JAX scan's order (count desc, id asc) over
    several port tiles, with ``n_valid``, with ``alive``, and with k above
    the live row count (empty slots (-1, -1))."""
    rng = np.random.RandomState(b * 7 + num_perm)
    n, nq = 300, 13
    db = _rand_sigs(rng, n, num_perm, low_bits)
    q = _rand_sigs(rng, nq, num_perm, low_bits)
    q[:3] = db[[5, 150, 299]]
    alive = rng.rand(n) > 0.3
    k, n_valid, al = 10, None, None
    if case == "n_valid":
        n_valid = 211
    elif case == "alive":
        al = alive
    elif case == "k_above_live":
        k, n_valid, al = 200, 250, alive  # fewer than 200 live rows below 250
    qp, dbp = (jax_bbit.pack_bbit_host(x, b) for x in (q, db))
    want_ids, want_cnt = jax_bbit.bbit_topk_scan(
        jnp.asarray(dbp), jnp.asarray(qp), k, b, num_perm,
        n_valid=None if n_valid is None else jnp.int32(n_valid),
        alive=None if al is None else jnp.asarray(al), tile=512,
    )
    got_ids, got_cnt = bbit_ops.bbit_topk_scan(
        _t(dbp), _t(qp), k, b, num_perm, n_valid=n_valid,
        alive=None if al is None else torch.from_numpy(al), tile=64,
    )
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    if case == "k_above_live":
        assert (got_ids.numpy() == -1).any()
    with pytest.raises(ValueError):
        bbit_ops.bbit_topk_scan(_t(dbp), _t(qp), 0, b, num_perm)


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("r1,r2", [(0.0, 0.0), (0.3, 0.3), (0.1, 0.7)])
def test_estimator_constants_match_jax(b, r1, r2):
    assert bbit_ops.estimator_constants(b, r1, r2) == jax_bbit.estimator_constants(b, r1, r2)
