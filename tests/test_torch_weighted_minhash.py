"""Port parity: the weighted MinHash path (device="cpu", kernels 6 and 7's
plain versions) against the JAX package on the same numpy inputs:
generator parameters, ``minhash`` and ``minhash_many`` (dense and CSR,
objects and device batches, several chunks, zero rows, entries <= 0,
unsorted CSR indices), and the answers of ``TorchMinHashLSH`` and
``TorchMinHashLSHEnsemble`` indexed from WeightedMinHash objects, host
(k, t) arrays and (k, t) tensors. Every comparison is exact."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from datasketch_tpu import WeightedMinHashGenerator as JaxGenerator
from datasketch_tpu.models.tpu_ensemble import TpuMinHashLSHEnsemble
from datasketch_tpu.models.tpu_lsh import TpuMinHashLSH
from datasketch_tpu_torch import (
    TorchMinHashLSH,
    TorchMinHashLSHEnsemble,
    WeightedMinHash,
    WeightedMinHashGenerator,
)

torch.set_num_threads(2)

DIM = 400


def _corpus(n=240, n_queries=40, seed=0):
    """CSR rows ~3 % dense with |N(0, 1)| weights plus dim i % DIM at 1.0
    (``bench.py``'s law at a small size); queries scale the active weights
    of indexed rows by U(0.85, 1.15)."""
    rng = np.random.RandomState(seed)
    w = np.where(rng.rand(n, DIM) < 0.03, np.abs(rng.randn(n, DIM)), 0.0)
    w[np.arange(n), np.arange(n) % DIM] = 1.0
    x = sp.csr_matrix(w.astype(np.float32))
    q = x[rng.choice(n, n_queries, replace=False)].copy()
    q.data *= rng.uniform(0.85, 1.15, q.nnz).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def sketches():
    x, q = _corpus()
    ours = WeightedMinHashGenerator(DIM, 128, seed=1, device="cpu")
    ref = JaxGenerator(DIM, 128, seed=1)
    out = {}
    for name, gen in (("ours", ours), ("ref", ref)):
        out[name] = dict(objs=gen.minhash_many(x), kt=gen.minhash_many(x, out="device"),
                         q_objs=gen.minhash_many(q), q_kt=gen.minhash_many(q, out="device"))
    return x, q, out


@pytest.mark.parametrize("dim,s,seed", [(DIM, 128, 1), (33, 100, 7)])
def test_generator_params_bit_equal(dim, s, seed):
    ours = WeightedMinHashGenerator(dim, s, seed=seed, device="cpu")
    ref = JaxGenerator(dim, s, seed=seed)
    for a, b in ((ours.rs, ref.rs), (ours.ln_cs, ref.ln_cs), (ours.betas, ref.betas)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    for t, p in zip(ours.params_t(), (ref.rs, ref.ln_cs, ref.betas)):
        assert t.device.type == "cpu" and np.array_equal(t.numpy(), p.T)


def test_minhash_and_object_api_match():
    ours = WeightedMinHashGenerator(50, 64, seed=3, device="cpu")
    ref = JaxGenerator(50, 64, seed=3)
    rng = np.random.RandomState(2)
    for _ in range(5):
        v = np.where(rng.rand(50) < 0.4, rng.randn(50), 0.0)  # negatives too
        v[0] = 1.0
        a, b = ours.minhash(v), ref.minhash(v)
        assert np.array_equal(a.hashvalues, b.hashvalues)
        assert a.hashvalues.dtype == b.hashvalues.dtype
    a, b = ours.minhash(np.ones(50)), ours.minhash(np.arange(1, 51))
    assert a == a.copy() and a != b and a.jaccard(a.copy()) == 1.0
    assert a.jaccard(b) == ref.minhash(np.ones(50)).jaccard(ref.minhash(np.arange(1, 51)))
    assert np.array_equal(a.digest(), a.hashvalues) and len(a) == 64
    with pytest.raises(ValueError):
        a.jaccard(WeightedMinHash(9, a.hashvalues))
    with pytest.raises(ValueError):
        ours.minhash(np.zeros(50))
    with pytest.raises(ValueError):
        ours.minhash(np.ones(49))


def _awkward():
    """Rows for the edge cases: zero rows, a row of only negative entries,
    explicit zeros and negatives among positives; as dense and as a CSR
    matrix with unsorted indices."""
    rng = np.random.RandomState(5)
    w = np.where(rng.rand(37, 60) < 0.2, np.abs(rng.randn(37, 60)), 0.0).astype(np.float32)
    w[3] = 0.0
    w[20] = 0.0
    w[11] = np.where(w[11] > 0, -w[11], 0.0)
    w[11, 0] = -1.0
    w[15, ::6] = -0.5
    x = sp.csr_matrix(w)
    x.data[::5] = 0.0  # explicit zeros
    for i in range(x.shape[0]):  # shuffle each row's indices
        lo, hi = x.indptr[i], x.indptr[i + 1]
        perm = lo + rng.permutation(hi - lo)
        x.indices[lo:hi], x.data[lo:hi] = x.indices[perm].copy(), x.data[perm].copy()
    x.has_sorted_indices = False
    return np.asarray(x.todense()), x


def _same_objects(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.seed == b.seed and a.hashvalues.dtype == b.hashvalues.dtype
            assert np.array_equal(a.hashvalues, b.hashvalues)


@pytest.mark.parametrize("form", ["dense", "csr"])
def test_minhash_many_matches(form):
    dense, csr = _awkward()
    x = dense if form == "dense" else csr
    ours = WeightedMinHashGenerator(60, 96, seed=2, device="cpu")
    ref = JaxGenerator(60, 96, seed=2)
    ours._CHUNK_ELEMS = ref._CHUNK_ELEMS = 600  # several chunks
    ref._SPARSE_CHUNK_ELEMS = 8 * 16 * 96
    got, want = ours.minhash_many(x), ref.minhash_many(x)
    _same_objects(got, want)
    assert got[3] is None and got[20] is None
    assert (got[11] is None) == (form == "csr")  # dense: only zeros count as zero
    with pytest.raises(ValueError, match="row 3"):
        ours.minhash_many(x, out="device")
    with pytest.raises(ValueError, match="row 3"):
        ref.minhash_many(x, out="device")
    keep = [i for i in range(x.shape[0]) if i not in (3, 11, 20)]
    kt = ours.minhash_many(x[keep], out="device")
    assert isinstance(kt, torch.Tensor) and kt.dtype == torch.int32
    assert np.array_equal(kt.numpy(), np.asarray(ref.minhash_many(x[keep], out="device")))
    assert np.array_equal(kt.numpy(), np.stack([got[i].hashvalues for i in keep]))


def test_minhash_many_validation_and_empty():
    gen = WeightedMinHashGenerator(10, 16, seed=1, device="cpu")
    with pytest.raises(ValueError):
        gen.minhash_many(np.ones((2, 10)), out="bogus")
    with pytest.raises(TypeError):
        gen.minhash_many([[1.0] * 10])
    with pytest.raises(ValueError):
        gen.minhash_many(np.ones((2, 9)))
    assert gen.minhash_many(np.zeros((0, 10))) == []
    assert gen.minhash_many(sp.csr_matrix((0, 10), dtype=np.float32)) == []
    assert gen.minhash_many(np.zeros((0, 10)), out="device").shape == (0, 16, 2)


def test_kt_batch_index_repairs_crash(sketches):
    """A (k, t) batch indexes where the port raised: a host array, a
    tensor and WeightedMinHash objects give one index."""
    _, _, sk = sketches
    kt = sk["ours"]["kt"]
    ixs = []
    for batch in (kt.numpy(), kt, sk["ours"]["objs"]):
        ix = TorchMinHashLSH(threshold=0.5, num_perm=128, device="cpu")
        ix.index(range(kt.shape[0]), batch)
        ixs.append(ix)
    assert all(torch.equal(ixs[0]._sigs, ix._sigs) for ix in ixs[1:])
    ix = TorchMinHashLSH(threshold=0.5, num_perm=128, device="cpu")
    for i, m in enumerate(sk["ours"]["objs"][:16]):
        ix.insert(i, m)
    assert ix.query(sk["ours"]["objs"][4])[0] == 4


@pytest.mark.parametrize("kind", ["objects", "host_kt", "tensor_kt"])
def test_lsh_answers_match_jax(sketches, kind):
    _, _, sk = sketches
    ours_sk, ref_sk = sk["ours"], sk["ref"]
    batch = {
        "objects": (ours_sk["objs"], ref_sk["objs"], ours_sk["q_objs"], ref_sk["q_objs"]),
        "host_kt": (ours_sk["kt"].numpy(), np.asarray(ref_sk["kt"]),
                    ours_sk["q_kt"].numpy(), np.asarray(ref_sk["q_kt"])),
        "tensor_kt": (ours_sk["kt"], ref_sk["kt"], ours_sk["q_kt"], ref_sk["q_kt"]),
    }[kind]
    n = len(ours_sk["objs"])
    ours = TorchMinHashLSH(threshold=0.5, num_perm=128, bucket_cap=16, device="cpu")
    ref = TpuMinHashLSH(threshold=0.5, num_perm=128, bucket_cap=16)
    ours.index(range(n), batch[0])
    ref.index(range(n), batch[1])
    for method in ("scan", "bands"):
        got = ours.top_k(batch[2], 5, method=method)
        assert got == ref.top_k(batch[3], 5, method=method)
        assert ours.last_truncated == ref.last_truncated
        got = ours.query_batch(batch[2], return_scores=True, method=method)
        assert got == ref.query_batch(batch[3], return_scores=True, method=method)
    hits = ours.top_k(batch[2], 1, method="scan")
    assert sum(bool(r) and r[0][1] > 0.5 for r in hits) >= 0.9 * len(hits)


def test_ensemble_from_kt_matches_jax(sketches):
    x, q, sk = sketches
    sizes = np.diff(x.indptr)
    q_sizes = np.diff(q.indptr)
    keys = ["w%d" % i for i in range(x.shape[0])]
    ours = TorchMinHashLSHEnsemble(threshold=0.6, num_perm=128, num_part=4, device="cpu")
    ref = TpuMinHashLSHEnsemble(threshold=0.6, num_perm=128, num_part=4)
    ours.index_batch(keys, sk["ours"]["kt"], sizes)
    ref.index_batch(keys, sk["ref"]["kt"], sizes)
    via_objs = TorchMinHashLSHEnsemble(threshold=0.6, num_perm=128, num_part=4,
                                       device="cpu")
    via_objs.index(zip(keys, sk["ours"]["objs"], sizes))
    assert torch.equal(via_objs._sigs, ours._sigs)
    for method in ("bands", "scan"):
        got = ours.query_batch((sk["ours"]["q_kt"], q_sizes), method=method)
        want = ref.query_batch((sk["ref"]["q_kt"], q_sizes), method=method)
        objs = ours.query_batch(list(zip(sk["ours"]["q_objs"], q_sizes)), method=method)
        if method == "bands":
            got, want, objs = ([set(r) for r in g] for g in (got, want, objs))
        assert got == want == objs
        assert ours.last_truncated == ref.last_truncated


def test_pickle_drops_cached_device_tables():
    """A generator pickled after dense and CSR ``minhash_many`` calls (which
    cache its [D, S] tables on its device) pickles only its parameters:
    it unpickles without the tables, is no larger than one never used, and
    sketches the same."""
    import pickle

    x, q = _corpus(n=60, n_queries=8, seed=3)
    fresh = WeightedMinHashGenerator(DIM, 64, seed=4, device="cpu")
    used = WeightedMinHashGenerator(DIM, 64, seed=4, device="cpu")
    want_dense = used.minhash_many(x[:20].toarray(), out="device")
    want_csr = used.minhash_many(q, out="device")
    assert used._params_t is not None
    blob = pickle.dumps(used)
    assert len(blob) <= len(pickle.dumps(fresh))
    back = pickle.loads(blob)
    assert back._params_t is None and used._params_t is not None
    assert torch.equal(back.minhash_many(x[:20].toarray(), out="device"), want_dense)
    assert torch.equal(back.minhash_many(q, out="device"), want_csr)
