"""The ragged compaction of threshold answers on the device
(``lsh_ops.compact_rows``) and the facade that fetches and decodes only the
answers (``TorchMinHashLSH._query_finish`` / ``_decode_ragged``).

The reference is the padded form that the compaction replaced: the same
``query_fused`` / ``threshold_select`` / ``unique_compact`` / ``topk_scan``
outputs, all ``[Q, max_out]`` slots decoded on the host by
``_decode_rows``. Answers, their order, scores and ``last_truncated`` must
be equal (``device="cpu"``, the kernels' plain versions)."""

import numpy as np
import pytest
import torch

from datasketch_tpu_torch import TorchMinHashLSH
from datasketch_tpu_torch.models.minhash import pow2_at_least
from datasketch_tpu_torch.models.torch_lsh import _decode_ragged, _decode_rows
from datasketch_tpu_torch.ops import lsh_ops

torch.set_num_threads(2)

P = 128


# ------------------------------------------------------------------- the op


def _padded_rows(ids, sc):
    """Each row's filled slots in order, by a plain loop: ([ids], [scores])."""
    out_ids, out_sc = [], []
    for i, row in enumerate(ids.tolist()):
        keep = [j for j, x in enumerate(row) if x >= 0]
        out_ids.append([row[j] for j in keep])
        out_sc.append(None if sc is None else [sc[i, j].item() for j in keep])
    return out_ids, out_sc


def _result(q, w, fill, seed, scores=True):
    """A padded result int32[q, w] whose slots are filled with probability
    ``fill`` (anywhere in a row) and f32 scores, -1 where empty."""
    rng = np.random.RandomState(seed)
    filled = rng.rand(q, w) < fill
    ids = np.where(filled, rng.randint(0, 10_000, (q, w)), -1).astype(np.int32)
    sc = np.where(filled, rng.rand(q, w), -1.0).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(sc) if scores else None


def _holes_in_the_middle():
    ids = torch.tensor([[5, -1, 7, -1, 9, -1], [-1, -1, 3, 4, -1, 8], [1, 2, 3, -1, -1, 6]],
                       dtype=torch.int32)
    return ids, torch.where(ids >= 0, ids.float() / 10, -1.0)


def _some_rows_empty_some_full():
    ids, sc = _result(9, 16, 0.4, 3)
    ids[[0, 4, 8]] = -1
    sc[[0, 4, 8]] = -1.0
    ids[[2, 6]] = torch.arange(32, dtype=torch.int32).reshape(2, 16)
    sc[[2, 6]] = 0.5
    return ids, sc


OP_CASES = {
    "rows-empty-and-full": _some_rows_empty_some_full,
    "holes-in-the-middle": _holes_in_the_middle,
    "no-scores": lambda: _result(12, 40, 0.3, 4, scores=False),
    "one-query": lambda: _result(1, 50, 0.5, 5),
    "one-query-empty": lambda: _result(1, 50, 0.0, 6),
    "all-empty": lambda: _result(16, 20, 0.0, 7),
    "all-full": lambda: _result(8, 24, 1.0, 8),
    "sparse-wide": lambda: _result(64, 3200, 0.002, 9),
    "no-queries": lambda: _result(0, 30, 0.5, 10),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_compact_rows_keeps_each_rows_filled_slots_in_order(case):
    ids, sc = OP_CASES[case]()
    want_ids, want_sc = _padded_rows(ids, sc)
    counts, flat_ids, flat_sc = lsh_ops.compact_rows(ids, sc)
    assert counts.dtype == torch.int32 and counts.tolist() == [len(r) for r in want_ids]
    assert flat_ids.dtype == torch.int32 and flat_ids.shape == (ids.numel(),)
    total = int(counts.sum())
    assert flat_ids[:total].tolist() == [x for r in want_ids for x in r]
    if sc is None:
        assert flat_sc is None
    else:
        assert flat_sc.dtype == sc.dtype and flat_sc.shape == (sc.numel(),)
        assert flat_sc[:total].tolist() == [x for r in want_sc for x in r]
    # the host decode of the compacted form is the padded decode
    keys = ["k%d" % i for i in range(10_000)]
    for return_scores in ((False, True) if sc is not None else (False,)):
        got = _decode_ragged(flat_ids[:total].numpy(),
                             None if sc is None else flat_sc[:total].numpy(),
                             counts.numpy(), keys, return_scores)
        want = _decode_rows(ids.numpy(), None if sc is None else sc.numpy(), keys,
                            return_scores)
        assert got == want


# --------------------------------------------------------------- the facade


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 32, size=(n, P), dtype=np.uint64).astype(np.uint32)


def _near(rows, keep, seed):
    rng = np.random.RandomState(seed)
    return np.where(rng.rand(*rows.shape) < keep, rows, _rows(rows.shape[0], seed + 1000))


@pytest.fixture(scope="module")
def corpus():
    """1,300 rows: random ones and 300 near-copies of row 0 (a threshold
    scan of row 0 then matches > 128 rows, and its buckets overflow a cap
    of 16). Queries: row 0's copies, near-copies of other stored rows, and
    unrelated rows that match nothing."""
    sigs = _rows(1300, 1)
    sigs[1000:] = _near(np.repeat(sigs[:1], 300, axis=0), 0.9, 2)
    pick = np.random.RandomState(3).randint(1, 1000, 20)
    queries = np.concatenate([_near(sigs[[0, 0]], 0.95, 4), _near(sigs[pick], 0.75, 5),
                              _rows(10, 6)])
    return sigs, queries


def _index(sigs, remove=(), **kw):
    ix = TorchMinHashLSH(threshold=0.5, num_perm=P, bucket_cap=16, device="cpu", **kw)
    ix.index(range(len(sigs)), sigs)
    for key in remove:
        ix.remove(key)
    return ix


def _padded_answers(ix, queries, method, return_scores):
    """A threshold batch as the padded path answered it: the selection ops'
    [Q, max_out] result decoded whole by ``_decode_rows``, and its
    ``last_truncated``."""
    q = ix._queries(queries)
    cutoff = ix.threshold
    if method == "auto" and not ix.rerank:
        method = "bands"
    method = ix._pick(method, q.shape[0])
    alive, all_alive = ix._alive_state()
    trunc = 0
    sc = None
    if method == "scan":
        max_out = min(ix.max_results or 1024, pow2_at_least(ix._n_real))
        k = min(max_out, lsh_ops.lsh_scan.MAX_K)
        ids, sc, n = lsh_ops.topk_scan(ix._sigs, q, k, alive=alive, count_ge=cutoff)
        if (n > k).any():
            k = max_out
            ids, sc, n = lsh_ops.topk_scan(ix._sigs, q, k, alive=alive, count_ge=cutoff)
        max_out = k
    else:
        max_out = ix.b * ix.bucket_cap
        if ix.max_results is not None:
            max_out = min(ix.max_results, max_out)
        q_fps = lsh_ops.band_fingerprints(q, ix.b, ix.r)
        flat, trunc = lsh_ops.query_tables(ix._sorted_fp, ix._sorted_ids, q_fps,
                                           cap=ix.bucket_cap)
        flat = ix._mask_dead(flat.reshape(q.shape[0], -1))
        if ix.rerank or return_scores:
            scores = lsh_ops.rerank_jaccard(ix._sigs, q, flat)
            cut = float(cutoff) if ix.rerank else -1.0
            ids, sc, n = lsh_ops.threshold_select(scores, flat, cut, max_out)
        else:
            ids, n = lsh_ops.unique_compact(flat, max_out)
    answers = _decode_rows(ids.numpy(), None if sc is None else sc.numpy(), ix._keys,
                           return_scores)
    last_truncated = int(trunc) + int((n.long() - max_out).clamp_min(0).sum())
    return answers, last_truncated


# (index options, tombstoned keys, method, return_scores)
FACADE_CASES = {
    "bands-scores": ({}, (), "bands", True),
    "bands-ids": ({}, (), "bands", False),
    "scan-scores": ({}, (), "scan", True),
    "scan-ids": ({}, (), "scan", False),
    "auto-scores": ({}, (), "auto", True),
    "bands-tombstones-scores": ({}, (0, 5, 1003, 1200), "bands", True),
    "bands-tombstones-ids": ({}, (0, 5, 1003, 1200), "bands", False),
    "scan-tombstones-scores": ({}, (0, 5, 1003, 1200), "scan", True),
    "bands-candidates-only": ({"rerank": False}, (), "bands", False),
    "bands-candidates-only-tombstones": ({"rerank": False}, (7, 1001), "bands", False),
    "bands-no-rerank-scores": ({"rerank": False}, (), "bands", True),
    "bands-max-results": ({"max_results": 20}, (), "bands", True),
    "scan-max-results": ({"max_results": 20}, (), "scan", True),
    "scan-escalation-max-results": ({"max_results": 200}, (), "scan", True),
}


@pytest.mark.parametrize("case", list(FACADE_CASES))
def test_query_batch_answers_as_the_padded_decode(corpus, case):
    sigs, queries = corpus
    opts, remove, method, return_scores = FACADE_CASES[case]
    ix = _index(sigs, remove, **opts)
    want, want_trunc = _padded_answers(ix, queries, method, return_scores)
    got = ix.query_batch(queries, return_scores=return_scores, method=method)
    assert got == want
    assert ix.last_truncated == want_trunc
    assert any(got) and not all(got)  # answers to decode, and rows with none


def test_the_scan_escalates_past_128_matches(corpus):
    sigs, queries = corpus
    ix = _index(sigs)
    got = ix.query_batch(queries[:2], return_scores=True, method="scan")
    assert min(map(len, got)) > lsh_ops.lsh_scan.MAX_K
    assert got == _padded_answers(ix, queries[:2], "scan", True)[0]


@pytest.mark.parametrize("method", ["bands", "scan"])
@pytest.mark.parametrize("depth", [1, 4])
def test_query_stream_answers_as_the_padded_decode(corpus, method, depth):
    sigs, queries = corpus
    ix = _index(sigs, (5,))
    batches = [queries[:2], queries[2:13], queries[13:], queries[25:26]]
    got = list(ix.query_stream(batches, return_scores=True, method=method, depth=depth))
    assert got == [_padded_answers(ix, b, method, True)[0] for b in batches]


@pytest.mark.parametrize("method", ["bands", "scan"])
def test_an_empty_index_answers_nothing(corpus, method):
    _, queries = corpus
    ix = TorchMinHashLSH(threshold=0.5, num_perm=P, device="cpu")
    assert ix.query_batch(queries[:3], method=method) == [[], [], []]
    ix.index(["a"], queries[:1])
    ix.remove("a")
    ix.compact()
    assert ix.query_batch(queries[:3], return_scores=True, method=method) == [[], [], []]
    assert list(ix.query_stream([queries[:2]], method=method)) == [[[], []]]
