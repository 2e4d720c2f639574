"""Port parity: TorchMinHashLSHEnsemble (device="cpu", the kernels' plain
versions) against TpuMinHashLSHEnsemble on the same token documents, built
by ``index_tokens`` in both packages: parameters, partitions, stacked
tables and per-query band counts; band results as sets and scan results
as ordered lists, with equal ``last_truncated``; the auto choice;
checkpoints written by one package and loaded by the other; validation."""

import numpy as np
import pytest
import torch

from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu.models.tpu_ensemble import TpuMinHashLSHEnsemble
from datasketch_tpu.ops import lsh_ops as jax_lsh
from datasketch_tpu_torch import MinHash, TorchMinHashLSHEnsemble
from datasketch_tpu_torch.models.torch_ensemble import _distinct_counts
from datasketch_tpu_torch.ops import lsh_ops

torch.set_num_threads(2)

P = 128


def _corpus(n=600, n_queries=40, seed=3):
    """Token documents: lognormal lengths around 60, Zipf(0.8) ids over a
    2,000-id vocabulary (duplicates left in, so a set's size is its
    distinct count). Queries: subsets of indexed documents at keep rates
    U(0.3, 1.0), plus three tiny sets of the most common ids, which many
    documents contain (match counts past 16 and past 128)."""
    rng = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, 2001) ** 0.8
    cum = np.cumsum(w / w.sum())
    lengths = np.maximum(8, rng.lognormal(np.log(60), 0.5, n)).astype(int)
    docs = [np.searchsorted(cum, rng.rand(m)).astype(np.int64) for m in lengths]
    queries = []
    for i in rng.choice(n, n_queries, replace=False):
        s = np.unique(docs[i])
        q = s[rng.rand(s.size) < rng.uniform(0.3, 1.0)]
        queries.append(q if q.size else s[:1])
    queries += [np.array([0, 1]), np.array([0, 1, 2]), np.array([1, 3, 0, 1])]
    return docs, queries


@pytest.fixture(scope="module")
def corpus():
    docs, queries = _corpus()
    q_sizes = np.array([np.unique(q).size for q in queries])
    ours_q = MinHash.bulk_signatures(queries, num_perm=P, hashfunc="device",
                                     out="device", device="cpu")
    ref_q = JaxMinHash.bulk_signatures(queries, num_perm=P, hashfunc="device")
    return docs, (ours_q, q_sizes), (ref_q, q_sizes)


def _pair(docs, **kw):
    ours = TorchMinHashLSHEnsemble(num_perm=P, device="cpu", **kw)
    ref = TpuMinHashLSHEnsemble(num_perm=P, **kw)
    keys = ["d%d" % i for i in range(len(docs))]
    ours.index_tokens(keys, docs)
    ref.index_tokens(keys, docs)
    return ours, ref


@pytest.fixture(scope="module")
def pair05(corpus):
    return _pair(corpus[0], threshold=0.5, num_part=4)


def _jax_b_keep(ref, sizes, q_pad):
    """The JAX facade's per-(query, partition) band counts (computed
    inline in its query_batch)."""
    out = {r: np.zeros((q_pad, ref.num_part), dtype=np.int32) for r in ref.rs}
    for qi, size in enumerate(sizes):
        for part in range(ref.num_part):
            if ref.uppers[part] is not None:
                bb, rr = ref._get_optimal_param(ref.uppers[part], size)
                out[int(rr)][qi, part] = int(bb)
    return out


@pytest.mark.parametrize("threshold,num_part", [(0.5, 4), (0.8, 8), (0.8, 1)])
def test_build_state_matches(corpus, threshold, num_part):
    docs, (_, q_sizes), _ = corpus
    ours, ref = _pair(docs, threshold=threshold, num_part=num_part)
    np.testing.assert_array_equal(ours.xqs, ref.xqs)
    np.testing.assert_array_equal(ours.params, ref.params)
    assert ours.rs == ref.rs
    assert ours.lowers == ref.lowers and ours.uppers == ref.uppers
    assert ours._n_pad == ref._n_pad
    np.testing.assert_array_equal(ours._n_valid, ref._n_valid)
    np.testing.assert_array_equal(ours._sizes_host, ref._sizes_host)
    np.testing.assert_array_equal(ours._sigs.numpy().view(np.uint32),
                                  np.asarray(ref._sigs_dev))
    assert ours._keys_per_part == ref._keys_per_part
    for r in ours.rs:
        for got, want in zip(ours._tables[r], ref._tables[r]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got, want = ours._b_keep(q_sizes, 64), _jax_b_keep(ref, q_sizes, 64)
    assert got.keys() == want.keys()
    for r in got:
        np.testing.assert_array_equal(got[r], want[r])


def test_stacked_and_masked_probes_match_jax():
    """The band path's ops on a low-cardinality stack (large buckets, cap
    overflow), with per-(query, partition) band counts and an empty and a
    partly filled partition."""
    rng = np.random.RandomState(5)
    b, r, cap = 8, 4, 4
    stack = rng.randint(0, 2, size=(3, 256, P)).astype(np.uint32)
    q = stack[0, :12].copy()
    q[:, ::3] = rng.randint(0, 2, size=(12, (P + 2) // 3))
    b_keep = rng.randint(0, b + 1, size=(12, 3)).astype(np.int32)
    n_valid = np.array([256, 100, 0], dtype=np.int32)
    ours = lsh_ops.build_tables_stacked(torch.from_numpy(stack.view(np.int32)), b, r)
    ref = jax_lsh.build_tables_stacked(stack, b, r)
    for got, want in zip(ours, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tq = torch.from_numpy(q.view(np.int32))
    got = lsh_ops.query_stacked_masked(*ours, tq, b, r, cap, torch.from_numpy(b_keep),
                                       torch.from_numpy(n_valid))
    want = jax_lsh.query_stacked_masked(*ref, q, b, r, cap, b_keep, n_valid)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1]) > 0
    got = lsh_ops.query_bands_masked(ours[0][1], ours[1][1], tq, b, r, cap, 5)
    want = jax_lsh.query_bands_masked(ref[0][1], ref[1][1], q, b, r, cap, np.int32(5))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1]) > 0


def test_distinct_counts_match_np_unique():
    rng = np.random.RandomState(1)
    docs = [rng.randint(0, 50, size=rng.randint(1, 90)) for _ in range(200)]
    docs += [np.array([], dtype=np.int64), np.array([7, 7, 7], dtype=np.uint8),
             np.array([-5, 2**40, -5], dtype=np.int64), [3, 1, 3]]
    want = [np.unique(np.asarray(d)).size for d in docs]
    np.testing.assert_array_equal(_distinct_counts(docs, torch.device("cpu")), want)


def _same(ours, ref, q_ours, q_ref, method, as_sets=False):
    got = ours.query_batch(q_ours, method=method)
    want = ref.query_batch(q_ref, method=method)
    if as_sets:
        got, want = [set(r) for r in got], [set(r) for r in want]
    assert got == want
    assert ours.last_truncated == ref.last_truncated
    return got


@pytest.mark.parametrize("method", ["bands", "scan", "auto"])
def test_queries_match(corpus, pair05, method):
    _, q_ours, q_ref = corpus
    ours, ref = pair05
    got = _same(ours, ref, q_ours, q_ref, method, as_sets=method == "bands")
    assert max(map(len, got)) > 128  # the scan escalated 16 -> 128 -> max_results
    n = len(q_ours[1])
    for lo, hi in ((0, 1), (n - 9, n)):  # smaller batches, other pads
        _same(ours, ref, (q_ours[0][lo:hi], q_ours[1][lo:hi]),
              (q_ref[0][lo:hi], q_ref[1][lo:hi]), method, as_sets=method == "bands")


def test_small_caps_count_truncation(corpus):
    docs, q_ours, q_ref = corpus
    ours, ref = _pair(docs, threshold=0.5, num_part=4, bucket_cap=2, max_results=40)
    for method in ("bands", "scan"):
        _same(ours, ref, q_ours, q_ref, method, as_sets=method == "bands")
        assert ours.last_truncated > 0


def test_auto_choice_matches(corpus):
    docs, q_ours, q_ref = corpus
    for cap in (1, 128):
        ours, ref = _pair(docs, threshold=0.8, num_part=1, bucket_cap=cap)
        for q_pad in (8, 16, 64, 1024):
            assert ours._resolve_scan_method("auto", q_pad) == \
                ref._resolve_scan_method("auto", q_pad)
        small = ((q_ours[0][:5], q_ours[1][:5]), (q_ref[0][:5], q_ref[1][:5]))
        assert ours._resolve_scan_method("auto", 8) == ("bands" if cap == 1 else "scan")
        _same(ours, ref, *small, "auto", as_sets=cap == 1)


def test_single_query_and_generator(corpus, pair05):
    _, (sigs, sizes), (ref_sigs, _) = corpus
    ours, ref = pair05
    row, size = sigs[3].numpy().view(np.uint32), int(sizes[3])
    want = ours.query_batch([(row, size)], method="scan")
    # one (signature, size) pair is one query (the JAX facade misreads it
    # as a (batch, sizes) pair)
    assert ours.query_batch((row, size), method="scan") == want
    assert ours.query_batch((row, np.int64(size)), method="scan") == want
    assert list(ours.query(row, size, method="scan")) == want[0]
    assert set(ours.query(row, size, method="bands")) == \
        set(ref.query(np.asarray(ref_sigs)[3], size, method="bands"))
    with pytest.raises(ValueError, match="one size per row"):
        ours.query_batch((sigs[:4], 5))


def test_save_and_load_across_packages(corpus, pair05, tmp_path):
    _, q_ours, q_ref = corpus
    ours, ref = pair05
    ours.save(tmp_path / "ours")
    ref.save(str(tmp_path / "ref"))
    ref_from_ours = TpuMinHashLSHEnsemble.load(str(tmp_path / "ours.npz"))
    ours_from_ref = TorchMinHashLSHEnsemble.load(tmp_path / "ref", device="cpu")
    for method in ("bands", "scan"):
        _same(ours_from_ref, ref_from_ours, q_ours, q_ref, method, method == "bands")
    _same(ours, ref_from_ours, q_ours, q_ref, "scan")
    assert len(ours_from_ref) == len(ref) and "d5" in ours_from_ref


def test_presizes_checkpoint_is_bands_only(pair05, tmp_path):
    ours, _ = pair05
    ours.save(tmp_path / "full")
    data = dict(np.load(tmp_path / "full.npz"))
    del data["sizes"]
    np.savez(tmp_path / "old.npz", **data)
    for cls, kw in ((TorchMinHashLSHEnsemble, {"device": "cpu"}), (TpuMinHashLSHEnsemble, {})):
        old = cls.load(str(tmp_path / "old.npz"), **kw)
        with pytest.raises(ValueError, match="pre-sizes checkpoint"):
            old.query_batch([(np.zeros(P, np.uint32), 10)], method="scan")
        assert old._resolve_scan_method("auto", 8) == "bands"


@pytest.mark.parametrize("kwargs", [
    dict(threshold=1.5), dict(num_part=0), dict(m=1), dict(m=200),
    dict(weights=(1.5, -0.5)), dict(weights=(0.3, 0.3)),
])
def test_constructor_validation_matches(kwargs):
    with pytest.raises(ValueError) as ours:
        TorchMinHashLSHEnsemble(device="cpu", **kwargs)
    with pytest.raises(ValueError) as ref:
        TpuMinHashLSHEnsemble(**kwargs)
    assert str(ours.value) == str(ref.value)


def test_index_and_query_validation(pair05):
    sigs = np.random.RandomState(0).randint(0, 1 << 32, size=(6, P),
                                            dtype=np.uint64).astype(np.uint32)
    ix = TorchMinHashLSHEnsemble(threshold=0.5, num_part=2, device="cpu")
    with pytest.raises(ValueError, match="entries is empty"):
        ix.index([])
    with pytest.raises(ValueError, match="Set size must be positive"):
        ix.index([("a", sigs[0], 0)])
    with pytest.raises(ValueError, match="equal length"):
        ix.index_batch(["a", "b"], sigs[:3], [1, 2, 3])
    with pytest.raises(ValueError, match="Expecting minhash with length"):
        ix.index_batch(["a"], sigs[:1, :64], [3])
    with pytest.raises(ValueError, match="Expecting minhash with length"):
        ix.index_batch(["a"], np.zeros((1, 64, 2), dtype=np.int32), [3])  # (k, t)
    with pytest.raises(ValueError, match="equal length"):
        ix.index_tokens(["a"], [[1, 2], [3]])
    assert ix.query_batch([(sigs[0], 4)]) == [[]]  # empty index
    ix.index_batch("abcdef", sigs, [4, 9, 9, 30, 31, 80])
    with pytest.raises(ValueError, match="Cannot call index again"):
        ix.index([("g", sigs[0], 3)])
    with pytest.raises(ValueError, match="method must be"):
        ix.query_batch([(sigs[0], 4)], method="walk")
    with pytest.raises(ValueError, match="Expecting minhash with length"):
        ix.query_batch([(sigs[0][:64], 4)])
    with pytest.raises(ValueError, match="Expecting minhash with length"):
        ix.query_batch((np.zeros((2, 64, 2), dtype=np.int32), [3, 4]))  # (k, t)
    with pytest.raises(ValueError, match="pairs"):
        ix.query_batch([(sigs[0], 4, 1)])
    assert ix.query_batch((sigs[:2], [4, 9]), method="scan")[0][0] == "a"
    ix.warmup(batch_sizes=(3,), sizes=(5, 50))
    assert len(ix) == 6 and "c" in ix and not ix.is_empty()
    with pytest.raises(ValueError, match="empty index"):
        TorchMinHashLSHEnsemble(device="cpu").save("unused")
