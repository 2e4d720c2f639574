"""Port parity: the pipelined query streams of TorchMinHashLSH
(``query_stream``, ``top_k_stream``) and TorchMinHashLSHEnsemble
(``query_stream``) on the CPU. Each yields, batch by batch, what the batch
call returns (``last_truncated`` included), and what the JAX package's
stream yields -- also where a threshold scan or a containment scan reruns
past its first k inside the pipeline, and on an empty index."""

import numpy as np
import pytest
import torch

from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu.models.tpu_ensemble import TpuMinHashLSHEnsemble
from datasketch_tpu.models.tpu_lsh import TpuMinHashLSH
from datasketch_tpu_torch import MinHash, TorchMinHashLSH, TorchMinHashLSHEnsemble

torch.set_num_threads(2)

P = 128


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 32, size=(n, P), dtype=np.uint64).astype(np.uint32)


@pytest.fixture(scope="module")
def lsh():
    """1,200 rows, 200 of them near-copies of row 0 (a threshold scan of
    row 0 matches > 128 rows and escalates); batches of 16 queries, the
    last one short, and one batch that holds row 0."""
    sigs = _rows(1200, 1)
    keep = np.random.RandomState(2).rand(200, P) < 0.9
    sigs[1:201] = np.where(keep, sigs[0], sigs[1:201])
    q = np.where(np.random.RandomState(3).rand(70, P) < 0.7,
                 sigs[np.random.RandomState(4).randint(0, 1200, 70)], _rows(70, 5))
    q[20] = sigs[0]
    batches = [q[i: i + 16] for i in range(0, 70, 16)]
    pair = (TorchMinHashLSH(threshold=0.5, num_perm=P, bucket_cap=16, device="cpu"),
            TpuMinHashLSH(threshold=0.5, num_perm=P, bucket_cap=16))
    for ix in pair:
        ix.index(range(1200), sigs)
        ix.remove(7)
    return pair, batches


def _stream_equals_batches(stream, index, call, batches, ref_rows):
    for batch, got, want in zip(batches, stream, ref_rows, strict=True):
        trunc = index.last_truncated
        assert got == call(batch) == want
        assert trunc == index.last_truncated


@pytest.mark.parametrize("method", ["auto", "bands", "scan"])
@pytest.mark.parametrize("depth", [1, 3])
def test_lsh_query_stream_matches_batches(lsh, method, depth):
    (ours, ref), batches = lsh
    want = list(ref.query_stream(batches, return_scores=True, method=method, depth=depth))
    stream = ours.query_stream(batches, return_scores=True, method=method, depth=depth)
    _stream_equals_batches(
        stream, ours,
        lambda b: ours.query_batch(b, return_scores=True, method=method), batches, want)
    if method == "scan":
        assert max(len(r) for r in want[1]) > 128  # the rerun happened in the stream


@pytest.mark.parametrize("method", ["auto", "bands", "scan"])
def test_lsh_top_k_stream_matches_batches(lsh, method):
    (ours, ref), batches = lsh
    want = list(ref.top_k_stream(batches, 10, method=method, depth=2))
    _stream_equals_batches(ours.top_k_stream(iter(batches), 10, method=method, depth=2),
                           ours, lambda b: ours.top_k(b, 10, method=method), batches, want)
    tensors = [torch.from_numpy(b.view(np.int32)) for b in batches]
    assert list(ours.top_k_stream(tensors, 10, method=method)) == want


def test_lsh_streams_on_an_empty_index_and_bad_method(lsh):
    (ours, _), batches = lsh
    empty = TorchMinHashLSH(threshold=0.5, num_perm=P, device="cpu")
    ref = TpuMinHashLSH(threshold=0.5, num_perm=P)
    for ix in (empty, ref):
        assert list(ix.query_stream(batches)) == [[[]] * len(b) for b in batches]
        assert list(ix.top_k_stream(batches, 5)) == [[[]] * len(b) for b in batches]
    for call in (lambda: ours.query_stream(batches, method="x"),
                 lambda: ours.top_k_stream(batches, 5, method="x")):
        with pytest.raises(ValueError, match="method"):
            call()
    assert list(ours.query_stream([np.zeros((0, P), np.uint32)])) == [[]]


def _token_corpus(n=500, seed=3):
    rng = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, 1501) ** 0.8
    cum = np.cumsum(w / w.sum())
    lengths = np.maximum(8, rng.lognormal(np.log(50), 0.5, n)).astype(int)
    docs = [np.searchsorted(cum, rng.rand(m)).astype(np.int64) for m in lengths]
    queries = []
    for i in rng.choice(n, 40, replace=False):
        s = np.unique(docs[i])
        queries.append(s[rng.rand(s.size) < rng.uniform(0.3, 1.0)] if s.size > 1 else s)
    queries += [np.array([0, 1]), np.array([0, 1, 2])]  # many matches: staged k
    return docs, [q if q.size else np.array([0]) for q in queries]


def test_ensemble_query_stream_matches_batches():
    docs, queries = _token_corpus()
    sizes = np.array([np.unique(q).size for q in queries])
    ours = TorchMinHashLSHEnsemble(threshold=0.3, num_perm=P, num_part=4, device="cpu")
    ref = TpuMinHashLSHEnsemble(threshold=0.3, num_perm=P, num_part=4)
    for ix in (ours, ref):
        ix.index_tokens(range(len(docs)), docs)
    q_ours = MinHash.bulk_signatures(queries, num_perm=P, hashfunc="device", device="cpu")
    q_ref = JaxMinHash.bulk_signatures(queries, num_perm=P, hashfunc="device")
    cuts = [(0, 16), (16, 32), (32, len(queries))]
    b_ours = [(q_ours[i:j], sizes[i:j]) for i, j in cuts]
    b_ref = [[(row, int(s)) for row, s in zip(q_ref[i:j], sizes[i:j])] for i, j in cuts]
    want = list(ref.query_stream(b_ref, depth=2))
    _stream_equals_batches(ours.query_stream(b_ours, depth=2), ours,
                           lambda b: ours.query_batch(b, method="scan"), b_ours, want)
    assert max(len(r) for r in want[-1]) > 16  # the staged k reran in the stream
    pairs = [[(row, int(s)) for row, s in zip(q_ours[i:j], sizes[i:j])] for i, j in cuts]
    assert list(ours.query_stream(pairs)) == want
    assert list(ours.query_stream([[]])) == [[]]
    empty = TorchMinHashLSHEnsemble(threshold=0.3, num_perm=P, device="cpu")
    assert list(empty.query_stream(b_ours[:1])) == [[[]] * 16]
