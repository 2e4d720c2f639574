"""Port parity: the CWS batches (kernels 6 and 7's plain versions, on the
CPU) and the (k, t) -> slot mix against the JAX package's ``cws_ops`` and
its Pallas kernels in interpret mode, on the same numpy inputs. The bar is
exact equality of every (k, t) pair; on a mismatch the message says whether
the pair's floor argument lay within 4 ulp of an integer (a near-tie, where
one ulp of ``log`` moves ``t``)."""

import numpy as np
import pytest
import torch

from datasketch_tpu.ops import cws_ops as jax_cws
from datasketch_tpu.ops import pallas_kernels as pk
from datasketch_tpu_torch.kernels import cws
from datasketch_tpu_torch.ops import cws_ops

torch.set_num_threads(2)


def _tables(s, d, seed):
    """(rs, ln_cs, betas) f32[S, D] as the generator draws them, with dims
    1 and 2 copies of dim 0: rows that weigh dims 0-2 equally tie there."""
    rng = np.random.RandomState(seed)
    rs = rng.gamma(2, 1, (s, d)).astype(np.float32)
    ln_cs = np.log(rng.gamma(2, 1, (s, d))).astype(np.float32)
    betas = rng.uniform(0, 1, (s, d)).astype(np.float32)
    for p in (rs, ln_cs, betas):
        p[:, 1:3] = p[:, :1]
    return rs, ln_cs, betas


def _weights(b, d, seed):
    """f32[B, D], ~4 % dense |N(0, 1)| weights; row 0 all zero, row 1 one
    active dim, row 2 dims 0-2 tied, row 3 only tiny weights (negative t),
    row 4 huge ones."""
    rng = np.random.RandomState(seed)
    w = np.where(rng.rand(b, d) < 0.04, np.abs(rng.randn(b, d)), 0.0).astype(np.float32)
    w[0] = 0.0
    w[1] = 0.0
    w[1, d - 1] = 3.0
    w[2, :3] = 0.5
    w[3] = 0.0
    w[3, 5:30] = 1e-30
    w[4, ::9] = 1e30
    return w


def near_ties(got, want, w, rs, betas):
    """Describe each differing (row, sample): whether log(w)/r + beta at
    either side's dim is within 4 ulp of an integer."""
    out = []
    for row, s in np.argwhere((got != want).any(-1))[:10]:
        for k in {int(got[row, s, 0]), int(want[row, s, 0])}:
            x = np.float32(np.log(np.float32(w[row, k])) / rs[s, k] + betas[s, k])
            gap = abs(x - np.round(x)) / np.spacing(np.float32(max(abs(x), 1.0)))
            out.append("row %d sample %d dim %d: floor argument %r, %.1f ulp from "
                       "an integer (%s)" % (row, s, k, x, gap,
                                           "near-tie" if gap <= 4 else "NOT a near-tie"))
    return "; ".join(out)


def assert_kt_equal(got, want, w, rs, betas):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if not np.array_equal(got, want):
        n = int((got != want).any(-1).sum())
        raise AssertionError("%d (row, sample) pairs differ: %s"
                             % (n, near_ties(got, want, w, rs, betas)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("b,s,d", [(8, 128, 300), (32, 100, 1000), (16, 128, 1000)])
def test_cws_many_matches_jax_and_pallas(b, s, d):
    rs, ln_cs, betas = _tables(s, d, seed=d + s)
    w = _weights(b, d, seed=b)
    got = cws_ops.cws_many(_t(w), _t(rs), _t(ln_cs), _t(betas)).numpy()
    assert got.dtype == np.int32 and got.shape == (b, s, 2)
    assert_kt_equal(got, jax_cws.cws_many(w, rs, ln_cs, betas), w, rs, betas)
    assert_kt_equal(got, pk.cws_many_pallas(w, rs, ln_cs, betas, interpret=True),
                    w, rs, betas)
    assert (got[0] == 0).all()  # no active dim: (0, 0)
    assert (got[1, :, 0] == d - 1).all()
    assert (got[2, :, 0] != 1).all() and (got[2, :, 0] != 2).all()  # ties to dim 0
    assert (got[3, :, 1] < 0).all()


@pytest.mark.parametrize("b,s,d", [(8, 129, 300), (8, 256, 700), (7, 128, 1000)])
def test_cws_dense_plain_matches_jax_and_pallas_on_dense_rows(b, s, d):
    """Kernel 6's plain twin against the JAX package's ``cws_many`` and the
    Pallas kernel in interpret mode past one 128-sample block and on fully
    dense rows (rows 5 and 6: every dim active, row 6 at one weight so
    that dims 0-2 tie)."""
    rs, ln_cs, betas = _tables(s, d, seed=d + s + 1)
    w = _weights(b, d, seed=b + s)
    w[5] = np.abs(np.random.RandomState(s).randn(d)) + 1e-3
    w[6] = 0.5
    got = cws_ops.cws_many(_t(w), _t(rs), _t(ln_cs), _t(betas)).numpy()
    assert_kt_equal(got, jax_cws.cws_many(w, rs, ln_cs, betas), w, rs, betas)
    assert_kt_equal(got, pk.cws_many_pallas(w, rs, ln_cs, betas, interpret=True),
                    w, rs, betas)
    assert (got[6, :, 0] != 1).all() and (got[6, :, 0] != 2).all()  # ties to dim 0


@pytest.mark.parametrize("d,s", [(1, 1), (333, 6), (400, 129)])
def test_cws_dense_case_matches_jax(d, s):
    """Kernel 6's plain twin on ``chip_smoke.cws_dense_case``'s rows (one
    active dim at the end, fully dense rows, ties across chunks and across
    warps' segments, tiny, huge and negative weights) against the JAX
    package's ``cws_many``; the forced ties go to the lower dim."""
    import chip_smoke

    tabs, w, ties = chip_smoke.cws_dense_case(torch, d, s, "cpu", 16)
    got = cws.cws_dense(w, *tabs).numpy()
    for row, dim in ties:
        assert (got[row, :, 0] == dim).all()
    assert (got[0] == 0).all() and (got[1, :, 0] == d - 1).all()
    rs, ln_cs, betas = (np.ascontiguousarray(t.numpy().T) for t in tabs)
    w = w.numpy()
    assert_kt_equal(got[1:], np.asarray(jax_cws.cws_many(w, rs, ln_cs, betas))[1:],
                    w[1:], rs, betas)


def _padded(w):
    """Right-padded CSR form of dense rows: vals/idx [B, NZ]."""
    nnz = (w > 0).sum(1)
    nz = max(1, int(nnz.max()))
    vals = np.zeros((w.shape[0], nz), np.float32)
    idx = np.zeros((w.shape[0], nz), np.int32)
    for i, row in enumerate(w):
        cols = np.nonzero(row > 0)[0]
        vals[i, : cols.size] = row[cols]
        idx[i, : cols.size] = cols
    return vals, idx


def _csr_padded(vals, idx, indptr):
    """The JAX package's [B, NZ] form of CSR rows: each row right-padded
    with (dim 0, weight 0), which is inactive."""
    lengths = (indptr[1:] - indptr[:-1]).numpy()
    nz = max(1, int(lengths.max()))
    vals_p = np.zeros((lengths.size, nz), np.float32)
    idx_p = np.zeros((lengths.size, nz), np.int32)
    for i, n in enumerate(lengths):
        lo = int(indptr[i])
        vals_p[i, :n] = vals[lo: lo + n].numpy()
        idx_p[i, :n] = idx[lo: lo + n].numpy()
    return vals_p, idx_p


@pytest.mark.parametrize("b,s,d", [(8, 128, 300), (24, 100, 1000)])
def test_cws_many_sparse_matches_jax_pallas_and_dense(b, s, d):
    rs, ln_cs, betas = _tables(s, d, seed=7 * d + s)
    w = _weights(b, d, seed=3 * b)
    vals, idx = _padded(w)
    tables = [np.ascontiguousarray(p.T) for p in (rs, ln_cs, betas)]
    got = cws_ops.cws_many_sparse(_t(vals), _t(idx), *map(_t, tables)).numpy()
    assert_kt_equal(got, jax_cws.cws_many_sparse(vals, idx, *tables), w, rs, betas)
    assert_kt_equal(got, pk.cws_sparse_pallas(vals, idx, *tables, interpret=True),
                    w, rs, betas)
    dense = cws_ops.cws_many(_t(w), _t(rs), _t(ln_cs), _t(betas)).numpy()
    assert_kt_equal(got, dense, w, rs, betas)


def test_cws_sparse_ragged_rows_equal_padded():
    """Kernel 7's flat CSR form (ragged rows, an empty row, entries <= 0
    inactive) equals the padded form row for row."""
    s, d = 100, 500
    rs, ln_cs, betas = _tables(s, d, seed=11)
    tables = [_t(np.ascontiguousarray(p.T)) for p in (rs, ln_cs, betas)]
    w = _weights(12, d, seed=5)
    w[7, ::50] = -2.0  # negative entries: inactive
    rows = [np.nonzero(r)[0] for r in w]
    indptr = np.concatenate([[0], np.cumsum([r.size for r in rows])]).astype(np.int64)
    idx = np.concatenate(rows).astype(np.int32)
    vals = np.concatenate([w[i, r] for i, r in enumerate(rows)]).astype(np.float32)
    got = cws.cws_sparse(_t(vals), _t(idx), _t(indptr), *tables).numpy()
    vals_p, idx_p = _padded(w)
    want = cws_ops.cws_many_sparse(_t(vals_p), _t(idx_p), *tables).numpy()
    assert_kt_equal(got, want, w, rs, betas)
    assert (got[0] == 0).all()


def test_kt_slots_match_jax():
    rng = np.random.RandomState(1)
    kt = np.stack([rng.randint(0, 10000, size=(16, 128)),
                   rng.randint(-(1 << 30), 1 << 30, size=(16, 128))], axis=-1).astype(np.int32)
    kt[0, :4] = [[0, -1], [2**31 - 1, -(2**31)], [9999, 2**31 - 1], [0, 0]]
    want = jax_cws.kt_slots_np(kt)
    assert np.array_equal(np.asarray(jax_cws.kt_slots(kt)), want)
    got = cws_ops.kt_slots(_t(kt))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(cws_ops.kt_slots_np(kt), want)
    assert np.array_equal(cws_ops.kt_slots(_t(kt.astype(np.int64))).numpy().view(np.uint32),
                          want)


@pytest.mark.parametrize("s,d", [(6, 400), (100, 333)])
def test_cws_sparse_entry_order_matches_jax(s, d):
    """Kernel 7's plain twin on rows whose entry order matters (a tie
    between distant dims, falling dims, inactive entries anywhere, a long
    row) equals the JAX package's padded sparse form: the first minimum in
    entry order. Row 0 is empty, where the two forms differ by design."""
    import chip_smoke

    tabs, (vals, idx, indptr), ties = chip_smoke.cws_order_case(torch, d, s, "cpu", 16)
    got = cws.cws_sparse(vals, idx, indptr, *tabs).numpy()
    assert (got[0] == 0).all()
    for row, dim in ties:
        assert (got[row, :, 0] == dim).all()
    vals_p, idx_p = _csr_padded(vals, idx, indptr)
    want = np.asarray(jax_cws.cws_many_sparse(vals_p, idx_p, *[t.numpy() for t in tabs]))
    w = np.zeros((16, d), np.float32)  # for the near-tie message only
    for i in range(16):
        for j, v in zip(idx_p[i], vals_p[i]):
            if v > 0 and w[i, j] <= 0:
                w[i, j] = v
    rs, betas = tabs[0].numpy().T, tabs[2].numpy().T
    assert_kt_equal(got[1:], want[1:], w[1:], rs, betas)
    padded = cws_ops.cws_many_sparse(_t(vals_p), _t(idx_p), *tabs).numpy()
    assert np.array_equal(padded, got)


# Kernel 7's edge cases (``chip_smoke.cws_block_case`` and ``cws_odd_case``):
# the plain twin against the JAX package's padded sparse form. The card tests
# hold the CUDA kernel to the same plain twin on these rows.


def _jax_kt(vals, idx, indptr, tabs):
    vals_p, idx_p = _csr_padded(vals, idx, indptr)
    return np.asarray(jax_cws.cws_many_sparse(vals_p, idx_p, *[t.numpy() for t in tabs]))


def _active_rows(vals, indptr):
    pos = (vals > 0).numpy()
    return [i for i in range(indptr.numel() - 1)
            if pos[int(indptr[i]): int(indptr[i + 1])].any()]


@pytest.mark.parametrize("n_rows,d,s", [(12, 333, 6), (1, 200, 1), (14, 1001, 32),
                                        (13, 300, 129)])
def test_block_case_plain_matches_jax(n_rows, d, s):
    """Shuffled rows, a fully dense shuffled row, ties within and across
    64-dim chunks and at ln_a = +0.0: the plain twin equals the JAX form on
    every row with an active entry, and the forced ties go to the first
    entry."""
    import chip_smoke

    tabs, (vals, idx, indptr), ties = chip_smoke.cws_block_case(torch, d, s, "cpu", n_rows)
    got = cws.cws_sparse(vals, idx, indptr, *tabs).numpy()
    want = _jax_kt(vals, idx, indptr, tabs)
    rows = _active_rows(vals, indptr)
    assert rows and np.array_equal(got[rows], want[rows])
    if n_rows >= 12:  # the special rows lead and close the batch
        assert len(ties) == 2 * (3 if d > 200 else 2)
    for row, dim in ties:
        assert (got[row, :, 0] == dim).all()


def test_block_case_zero_ln_a_ties():
    """Dims 20 and 21 at weight 1.0 with r 1, beta 0.5 and ln c 0.5 give
    ln_a = +0.0 and t = 0 for both: the first entry, 20, wins."""
    import chip_smoke

    tabs, (vals, idx, indptr), ties = chip_smoke.cws_block_case(torch, 333, 6, "cpu", 12)
    row = next(r for r, k in ties if k == 20)
    lo, hi = int(indptr[row]), int(indptr[row + 1])
    assert idx[lo:hi].tolist() == [20, 21] and vals[lo:hi].tolist() == [1.0, 1.0]
    rs, lncs, betas = tabs
    for j in (20, 21):
        t = torch.floor(torch.log(vals[lo]) / rs[j] + betas[j])
        ln_a = lncs[j] - (t - betas[j]) * rs[j] - rs[j]
        assert (t == 0).all() and (ln_a == 0).all()
    got = cws.cws_sparse(vals, idx, indptr, *tabs)
    assert (got[row, :, 0] == 20).all() and (got[row, :, 1] == 0).all()


def test_odd_case_masked_rows_match_jax():
    """``cws_odd_case`` with the NaN (r = 0) and +inf (ln c = +inf) dims
    made inactive, the rows the card compares the kernel against: the
    plain twin equals the JAX form on every row but the +inf-weight one,
    whose t of +inf each framework converts in its own way."""
    import chip_smoke

    tabs, _, (vals, idx, indptr) = chip_smoke.cws_odd_case(torch, "cpu")
    got = cws.cws_sparse(vals, idx, indptr, *tabs).numpy()
    want = _jax_kt(vals, idx, indptr, tabs)
    rows = [r for r in _active_rows(vals, indptr) if r != 41]
    assert len(rows) == 41 and np.array_equal(got[rows], want[rows])
    assert (got[42, :, 0] == 11).all() and not got[40].any()
