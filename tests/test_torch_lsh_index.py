"""Port parity: TorchMinHashLSH (device="cpu", the kernels' plain versions)
against TpuMinHashLSH on one signature matrix, and the whole slice --
SHA1 docs -> signatures -> index -> queries -- through both packages.
Answers must be equal: keys, order and f32 scores."""

import numpy as np
import pytest
import torch

from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu.models.tpu_lsh import TpuMinHashLSH
from datasketch_tpu_torch import MinHash, TorchMinHashLSH

torch.set_num_threads(2)

P = 128


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 32, size=(n, P), dtype=np.uint64).astype(np.uint32)


def _near(rows, keep, seed):
    rng = np.random.RandomState(seed)
    noise = _rows(rows.shape[0], seed + 1000)
    return np.where(rng.rand(*rows.shape) < keep, rows, noise)


@pytest.fixture(scope="module")
def data():
    """700 rows: 450 random, 100 near-copies of them, 150 near-copies of
    row 0 (a threshold scan then matches > 128 rows); 40 queries."""
    base = _rows(450, 1)
    dups = _near(base[np.random.RandomState(2).randint(0, 450, 100)], 0.75, 3)
    crowd = _near(np.repeat(base[:1], 150, axis=0), 0.9, 4)
    sigs = np.concatenate([base, dups, crowd])
    queries = _near(sigs[np.random.RandomState(5).randint(0, 700, 40)], 0.7, 6)
    return sigs, queries


def _pair(sigs, keys=None, **kw):
    keys = list(range(len(sigs))) if keys is None else keys
    ours = TorchMinHashLSH(num_perm=P, device="cpu", **kw)
    ref = TpuMinHashLSH(num_perm=P, **kw)
    ours.index(keys, sigs)
    ref.index(keys, sigs)
    return ours, ref


def _same(ours, ref, call):
    got, want = call(ours), call(ref)
    assert got == want
    assert ours.last_truncated == ref.last_truncated
    return got


@pytest.mark.parametrize("method", ["auto", "bands", "scan"])
@pytest.mark.parametrize("cap", [128, 8])
def test_top_k_and_query_batch_match(data, method, cap):
    sigs, queries = data
    ours, ref = _pair(sigs, threshold=0.5, bucket_cap=cap)
    for q in (queries, queries[:1]):  # 'auto' picks bands for 1 query at cap 8
        _same(ours, ref, lambda ix: ix.top_k(q, 10, method=method))
        _same(ours, ref, lambda ix: ix.query_batch(q, method=method))
        _same(ours, ref, lambda ix: ix.query_batch(q, return_scores=True,
                                                   threshold=0.4, method=method))


def test_large_k_escalation_and_max_results(data):
    sigs, queries = data
    ours, ref = _pair(sigs, threshold=0.5)
    _same(ours, ref, lambda ix: ix.top_k(queries, 200, method="scan"))
    crowd = _same(ours, ref, lambda ix: ix.query_batch(sigs[:1], method="scan"))
    assert len(crowd[0]) > 128  # escalated past the kernel-sized k
    capped = _pair(sigs, threshold=0.5, max_results=100)
    got = _same(*capped, lambda ix: ix.query_batch(sigs[:2], return_scores=True,
                                                   method="scan"))
    assert len(got[0]) == 100 and capped[0].last_truncated > 0


def test_remove_insert_and_status_match(data):
    sigs, queries = data
    ours, ref = _pair(sigs[:600], keys=["k%d" % i for i in range(600)], threshold=0.5)
    for i in range(0, 600, 9):
        ours.remove("k%d" % i)
        ref.remove("k%d" % i)
    for i in range(600, 700):  # buffered until the next query
        ours.insert("k%d" % i, sigs[i])
        ref.insert("k%d" % i, sigs[i])
    assert len(ours) == len(ref) and ("k9" in ours) == ("k9" in ref)
    for method in ("scan", "bands"):
        _same(ours, ref, lambda ix: ix.top_k(queries, 10, method=method))
        _same(ours, ref, lambda ix: ix.query_batch(queries, return_scores=True,
                                                   method=method))
    s_ours, s_ref = ours.status(), ref.status()
    for key in ("n_live", "n_tombstoned", "bands", "rows_per_band", "bucket_cap",
                "last_truncated", "max_bucket"):
        assert s_ours[key] == s_ref[key], key
    with pytest.raises(ValueError):
        ours.remove("k0")


def test_candidates_only_path_matches(data):
    sigs, queries = data
    ours, ref = _pair(sigs, threshold=0.5, rerank=False)
    _same(ours, ref, lambda ix: ix.query_batch(queries))
    ours.remove(3)
    ref.remove(3)
    _same(ours, ref, lambda ix: ix.query_batch(queries))
    with pytest.raises(ValueError):
        ours.query_batch(queries, method="scan")


def test_whole_slice_sha1_docs_to_queries():
    rng = np.random.RandomState(12)
    vocab = [bytes(rng.randint(0, 256, size=10, dtype=np.uint8)) for _ in range(2000)]
    docs = [[vocab[j] for j in rng.randint(0, 2000, size=60)] for _ in range(300)]
    docs += [d[:45] + [vocab[j] for j in rng.randint(0, 2000, size=15)] for d in docs[:60]]
    ours_sigs = MinHash.bulk_signatures(docs, num_perm=P, seed=1, out="device",
                                        device="cpu")
    ref_sigs = JaxMinHash.bulk_signatures(docs, num_perm=P, seed=1)
    ours = TorchMinHashLSH(threshold=0.5, num_perm=P, device="cpu")
    ref = TpuMinHashLSH(threshold=0.5, num_perm=P)
    ours.index(range(len(docs)), ours_sigs)
    ref.index(range(len(docs)), ref_sigs)
    q_ours, q_ref = ours_sigs[300:], ref_sigs[300:]
    for method in ("auto", "bands", "scan"):
        got = ours.top_k(q_ours, 5, method=method)
        assert got == ref.top_k(q_ref, 5, method=method)
        # each query is indexed itself; the exact scan also finds its source
        assert all(row[0][1] == 1.0 for row in got)
        if method == "scan":
            assert all(i in [k for k, _ in row] for i, row in enumerate(got))
        assert ours.query_batch(q_ours, return_scores=True, method=method) == \
            ref.query_batch(q_ref, return_scores=True, method=method)
