"""The sharded classes on a 4-position mesh on the card against the same
classes on a 4-position CPU mesh.

Marked ``cuda``: they skip where no card of capability >= 9.0 is present.
This file imports no JAX, so on a machine with the card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py
"""

import numpy as np
import pytest
import torch

from datasketch_tpu_torch import MinHash
from datasketch_tpu_torch.parallel import (
    ShardedBBitIndex,
    ShardedHNSW,
    ShardedMinHashLSH,
    ShardedMinHashLSHBloom,
    ShardedMinHashLSHEnsemble,
    ShardedMinHashLSHForest,
    distributed_hll_union,
    distributed_minhash_union,
    make_mesh,
    sharded_compute_signatures,
)

pytestmark = pytest.mark.cuda

P = 128
N = 3000  # over 4 shards of 1,024: the last one short


@pytest.fixture
def meshes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a card of capability >= 9.0 (sm_90a kernels)")
    return [make_mesh(4, shape=(4, 1), device=d) for d in ("cuda:0", "cpu")]


def _corpus(n=N, seed=1):
    rng = np.random.RandomState(seed)
    sigs = rng.randint(0, 1 << 32, size=(n, P), dtype=np.uint64).astype(np.uint32)
    half = n // 2
    sigs[half:] = np.where(rng.rand(n - half, P) < 0.7, sigs[: n - half], sigs[half:])
    sigs[100:400] = sigs[0]
    sigs[100:400, -1] = np.arange(300)  # 300 copies one slot apart: overflow
    return sigs


SIGS = _corpus()
Q = SIGS[[0, 1, 2, 101, 1500, 1501, 2999]]


def _both(meshes, build, call):
    """``call`` of the index ``build`` makes on the card and on the CPU."""
    out = []
    for mesh in meshes:
        ix = build(mesh)
        out.append((call(ix), getattr(ix, "last_truncated", None)))
    return out


def test_sketch_and_unions_on_the_card(meshes):
    rng = np.random.RandomState(2)
    hashes = rng.randint(0, 1 << 32, size=(64, 50), dtype=np.uint64).astype(np.uint32)
    lengths = rng.randint(0, 51, size=64).astype(np.int32)
    got = [np.asarray(sharded_compute_signatures(hashes, lengths, 1, P, make_mesh(
        4, device=m.home))) for m in meshes]
    np.testing.assert_array_equal(got[0], got[1])
    full = torch.from_numpy(got[0].view(np.int32).copy())
    unions = [distributed_minhash_union(full.to(m.home), m).cpu() for m in meshes]
    assert torch.equal(unions[0], unions[1])
    regs = torch.from_numpy(rng.randint(0, 40, size=(64, 256)).astype(np.int8))
    assert torch.equal(distributed_hll_union(regs.to("cuda"), meshes[0]).cpu(),
                       regs.max(dim=0).values)


@pytest.mark.parametrize("method", ["bands", "scan"])
def test_sharded_lsh_on_the_card(meshes, method):
    def build(mesh):
        ix = ShardedMinHashLSH(mesh, threshold=0.5, num_perm=P, bucket_cap=16)
        ix.index(range(N), SIGS)
        for key in range(0, N, 11):
            ix.remove(key)
        return ix

    for call in (lambda ix: ix.top_k(Q, 10, method=method),
                 lambda ix: ix.top_k(Q, 200, method=method),
                 lambda ix: ix.query_batch(Q, return_scores=True, method=method)):
        card, cpu = _both(meshes, build, call)
        assert card == cpu


def test_sharded_indexes_on_the_card(meshes):
    def bbit(mesh):
        ix = ShardedBBitIndex(mesh, b=1, num_perm=P)
        ix.insert_batch(range(N), SIGS)
        ix.remove_batch([0, 5])
        return ix

    card, cpu = _both(meshes, bbit, lambda ix: ix.query_batch(Q, 10, return_scores=True))
    assert card == cpu

    def forest(mesh):
        ix = ShardedMinHashLSHForest(mesh, num_perm=P, l=8, cap=16)
        ix.index(range(N), SIGS)
        return ix

    for kw in (dict(method="forest"), dict(method="scan", rank="jaccard"),
               dict(method="scan", rank="jaccard", k=200)):
        k = kw.pop("k", 10)
        card, cpu = _both(meshes, forest,
                          lambda ix: ix.query_batch(Q, k, return_scores=True, **kw))
        assert card == cpu

    def bloom(mesh):
        ix = ShardedMinHashLSHBloom(mesh, threshold=0.8, num_perm=P, n=100000)
        ix.insert_batch(SIGS[:1000])
        return ix

    card, cpu = _both(meshes, bloom, lambda ix: ix._host_words())
    np.testing.assert_array_equal(card[0], cpu[0])


def test_sharded_ensemble_and_hnsw_on_the_card(meshes):
    rng = np.random.RandomState(3)
    docs = [rng.randint(0, 3000, rng.randint(20, 200)).astype(np.uint32) for _ in range(2000)]
    queries = [d[: max(1, len(d) // 2)] for d in docs[:32]]
    qb = (MinHash.bulk_signatures(queries, num_perm=P, hashfunc="device", device="cpu"),
          np.array([np.unique(q).size for q in queries]))

    def ens(mesh):
        ix = ShardedMinHashLSHEnsemble(mesh, threshold=0.5, num_perm=P, num_part=6,
                                       max_results=64)
        ix.index_tokens(range(len(docs)), docs)
        return ix

    card, cpu = _both(meshes, ens, lambda ix: ix.query_batch(qb, method="scan"))
    assert card == cpu
    card, cpu = _both(meshes, ens, lambda ix: [sorted(r) for r in ix.query_batch(
        qb, method="bands")])
    assert card == cpu

    def hnsw(mesh):
        ix = ShardedHNSW(mesh, distance_metric="minhash_jaccard", m=8, ef=32)
        ix.index_tokens(range(1000), docs[:1000], num_perm=P)
        ix.remove(3)
        return ix

    pts = MinHash.bulk_signatures(docs[:40], num_perm=P, hashfunc="device", device="cpu")
    card, cpu = _both(meshes, hnsw, lambda ix: ix.query_batch(pts, k=10))
    assert card == cpu
