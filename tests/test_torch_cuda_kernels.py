"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where no card of capability >= 9.0 is present.
This file imports no JAX, so on a machine with the card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import hashlib

import numpy as np
import pytest
import torch

from datasketch_tpu_torch import (
    LeanMinHash,
    MinHash,
    TorchBBitIndex,
    TorchMinHashLSH,
    TorchMinHashLSHEnsemble,
    TorchMinHashLSHForest,
    WeightedMinHashGenerator,
)
from datasketch_tpu_torch.kernels import (
    bbit,
    compact,
    cws,
    lsh_scan,
    minhash_sign,
    rerank,
    score,
    sha1,
    tiling,
)
from datasketch_tpu_torch import native
from datasketch_tpu_torch.ops import bbit_ops, cws_ops, forest_ops, lsh_ops
from datasketch_tpu_torch.ops.minhash_ops import compute_signatures_ragged, perm_tensors

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a card of capability >= 9.0 (sm_90a kernels)")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _sigs(dev, n, p, seed, values=0):
    g = _gen(dev, seed)
    if values:
        return torch.randint(0, values, (n, p), generator=g, device=dev, dtype=torch.int32)
    return torch.randint(-(1 << 31), 1 << 31, (n, p), generator=g, device=dev,
                         dtype=torch.int32)


def _launched(mod, fn):
    before = mod.launches
    out = fn()
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    return out


@pytest.mark.parametrize("p", [64, 128, 200])
@pytest.mark.parametrize("mix", [False, True])
def test_sign_kernel_matches_plain(dev, p, mix):
    g = _gen(dev, p)
    lengths = torch.randint(0, 300, (257,), generator=g, device=dev, dtype=torch.int32)
    lengths[:3] = 0
    lengths[100] = 1500  # longer than the kernel's token tile
    starts = torch.zeros(257, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(lengths[:-1], 0)
    flat = torch.randint(-(1 << 31), 1 << 31, (int(lengths.sum()),), generator=g,
                         device=dev, dtype=torch.int32)
    a, b = perm_tensors(1, p, dev)
    got = _launched(minhash_sign, lambda: minhash_sign.minhash_sign(
        flat, starts, lengths, a, b, mix))
    assert torch.equal(got, minhash_sign.minhash_sign_plain(flat, starts, lengths, a, b, mix))


@pytest.mark.parametrize("p", [66, 128])
@pytest.mark.parametrize("k,cutoff,masked", [
    (1, 0.0, False), (10, 0.0, True), (128, 0.0, False), (16, 0.5, True),
])
def test_topk_scan_kernel_matches_plain(dev, p, k, cutoff, masked):
    db = _sigs(dev, 20011, p, 1, values=2)
    q = _sigs(dev, 45, p, 2, values=2)
    alive = torch.rand(20011, generator=_gen(dev, 3), device=dev) > 0.1 if masked else None
    n_valid = 20011 - 500 if masked else 20011
    got = _launched(lsh_scan, lambda: lsh_scan.topk_scan(db, q, k, n_valid, alive, cutoff))
    want = lsh_scan.topk_scan_plain(db, q, k, n_valid, alive, cutoff)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("p", [66, 100, 128])
@pytest.mark.parametrize("nq", [1, 33, 1000])
@pytest.mark.parametrize("k", [1, 128])
def test_topk_scan_kernel_edge_shapes(dev, p, nq, k):
    """P not a multiple of 4 or 64, N not a whole number of tiles, ragged
    Q, k at both ends, 2-valued slots (ties everywhere), an alive mask and
    n_valid < N."""
    n = 20011
    db = _sigs(dev, n, p, 40 + p, values=2)
    q = _sigs(dev, nq, p, 41 + nq, values=2)
    alive = torch.rand(n, generator=_gen(dev, 42), device=dev) > 0.2
    cutoff = 0.5 if k == 128 else 0.0
    got = _launched(lsh_scan, lambda: lsh_scan.topk_scan(db, q, k, n - 2857, alive, cutoff))
    want = lsh_scan.topk_scan_plain(db, q, k, n - 2857, alive, cutoff)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("sizes_mode", [False, True])
def test_scan_kernel_single_split(dev, sizes_mode):
    """A table small enough that the grid scans it in one split."""
    from datasketch_tpu_torch.kernels import build

    n, nq = 1000, 33
    assert tiling.grid(nq, n, build.num_sms(_sigs(dev, 1, 4, 0)), 4)[0] == 1
    db = _sigs(dev, n, 128, 50, values=2)
    q = _sigs(dev, nq, 128, 51, values=2)
    if sizes_mode:
        sizes = _sizes(dev, n, 52)
        sizes[:250] = 120
        q_sizes = _sizes(dev, nq, 53)
        got = _launched_sizes(lambda: lsh_scan.containment_topk(db, sizes, q, q_sizes, 16, 0.8))
        want = lsh_scan.containment_topk_plain(db, sizes, q, q_sizes, 16, 0.8)
    else:
        got = _launched(lsh_scan, lambda: lsh_scan.topk_scan(db, q, 16, n - 100))
        want = lsh_scan.topk_scan_plain(db, q, 16, n - 100, None, 0.0)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _sizes(dev, n, seed, lo=1, hi=400):
    return torch.randint(lo, hi, (n,), generator=_gen(dev, seed), device=dev,
                         dtype=torch.int32)


@pytest.mark.parametrize("p", [66, 128])
@pytest.mark.parametrize("k,cutoff", [(1, 0.8), (37, 0.0), (128, 0.5), (16, 1.0)])
def test_containment_kernel_matches_plain(dev, p, k, cutoff):
    """Sizes mode: ragged N and Q, padding rows (size 0), query sizes 0
    and 1, sizes up to 2**30, and a tie block (2-valued signatures with
    equal sizes, so scores tie)."""
    n, nq = 20011, 45
    db = _sigs(dev, n, p, 11, values=3)
    db[:3000] = _sigs(dev, 3000, p, 12, values=2)
    sizes = _sizes(dev, n, 13)
    sizes[:3000] = 120
    sizes[::17] = 0
    sizes[5000:5100] = 1 << 30
    q = torch.cat([db[:20], _sigs(dev, nq - 20, p, 14, values=3)])
    q_sizes = _sizes(dev, nq, 15)
    q_sizes[:3] = torch.tensor([0, 1, 1 << 30], dtype=torch.int32)
    got = _launched_sizes(lambda: lsh_scan.containment_topk(db, sizes, q, q_sizes, k, cutoff))
    want = lsh_scan.containment_topk_plain(db, sizes, q, q_sizes, k, cutoff)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("p", [66, 100])
@pytest.mark.parametrize("nq", [1, 33, 1000])
@pytest.mark.parametrize("k", [1, 128])
def test_containment_kernel_edge_shapes(dev, p, nq, k):
    """Sizes mode at P 66 and 100, ragged N and Q, k at both ends, on
    2-valued slots with a block of equal sizes (tied scores)."""
    n = 20011
    db = _sigs(dev, n, p, 60 + p, values=2)
    q = _sigs(dev, nq, p, 61 + nq, values=2)
    sizes = _sizes(dev, n, 62)
    sizes[:5000] = 120
    sizes[::13] = 0
    q_sizes = _sizes(dev, nq, 63, lo=0, hi=300)
    got = _launched_sizes(lambda: lsh_scan.containment_topk(db, sizes, q, q_sizes, k, 0.8))
    want = lsh_scan.containment_topk_plain(db, sizes, q, q_sizes, k, 0.8)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _launched_sizes(fn):
    before = (lsh_scan.launches, lsh_scan.launches_sizes)
    out = fn()
    torch.cuda.synchronize()
    assert (lsh_scan.launches, lsh_scan.launches_sizes) == (before[0], before[1] + 1)
    return out


def test_rerank_kernel_matches_plain(dev):
    db = _sigs(dev, 5000, 128, 4, values=4)
    q = _sigs(dev, 33, 128, 5, values=4)
    cand = torch.randint(-1, 5000, (33, 333), generator=_gen(dev, 6), device=dev,
                         dtype=torch.int32)
    cand[7] = -1
    got = _launched(rerank, lambda: rerank.rerank_scores(db, q, cand))
    assert torch.equal(got, rerank.rerank_scores_plain(db, q, cand))


@pytest.mark.parametrize("p", [66, 100, 128, 512, 600])
@pytest.mark.parametrize("c", [1, 31, 32, 33, 333, 3200])
def test_rerank_kernel_edge_lists(dev, p, c):
    """Kernel 3 against its plain twin on ``chip_smoke.rerank_edge_case``'s
    lists (a query of -1 slots only, one id in every slot, -1 between live
    slots, three ids in turn, random ids with -1 columns) at C around the
    32-slot chunk and at P that do and do not move as 16-byte words."""
    import chip_smoke

    db = _sigs(dev, 5003, p, 20 + p, values=4)
    q = _sigs(dev, 38, p, 21 + p, values=4)[1:]
    cand = chip_smoke.rerank_edge_case(torch, 5003, 37, c, dev, seed=p + c)
    got = _launched(rerank, lambda: rerank.rerank_scores(db, q, cand))
    assert torch.equal(got, rerank.rerank_scores_plain(db, q, cand))
    assert (got[0] == 0).all() and (got[1] == got[1, 0]).all()


@pytest.mark.parametrize("p", [100, 128])
def test_rerank_kernel_unaligned_table(dev, p):
    """A table or queries 4 bytes past a 16-byte boundary take the kernel's
    word-by-word form and give the same scores."""
    db = _sigs(dev, 3000, p, 30, values=4)
    q = _sigs(dev, 50, p, 31, values=4)
    cand = torch.randint(-1, 3000, (50, 700), generator=_gen(dev, 32), device=dev,
                         dtype=torch.int32)
    want = rerank.rerank_scores_plain(db, q, cand)
    for t in (db, q):
        buf = torch.empty(t.numel() + 1, dtype=torch.int32, device=dev)
        moved = buf[1:].view(t.shape).copy_(t)
        args = (moved, q, cand) if t is db else (db, moved, cand)
        got = _launched(rerank, lambda: rerank.rerank_scores(*args))
        assert torch.equal(got, want)


@pytest.mark.parametrize("p", [66, 100, 128])
@pytest.mark.parametrize("nq", [1, 33, 1000])
def test_score_kernel_edge_shapes(dev, p, nq):
    """Kernel 4 at P not a multiple of 4 or 64, ragged Q, and T cut inside
    and at the edges of a 64-row tile, from one split (T 1) to many (T
    8,192 at Q 1,000), on 2-valued slots (ties everywhere)."""
    db = _sigs(dev, 8192, p, 70 + p, values=2)
    q = _sigs(dev, nq, p, 71 + nq, values=2)
    for t in (1, 63, 64, 65, 8191, 8192):
        got = _launched(score, lambda: score.score_matrix(q, db[:t]))
        assert torch.equal(got, score.score_matrix_plain(q, db[:t])), t


@pytest.mark.parametrize("p", [512, 600])
def test_score_kernel_and_large_k_scan_at_wide_p(dev, p):
    """Kernel 4 at P 512 and at 600, the largest P whose block (96 rows of
    round4(P) + 4 ints) fits the H100's 232,448 bytes of shared memory, and
    the k = 200 scan built on it."""
    db = _sigs(dev, 8192, p, 77 + p, values=2)
    q = _sigs(dev, 70, p, 78 + p, values=2)
    for t in (65, 8192):
        got = _launched(score, lambda: score.score_matrix(q, db[:t]))
        assert torch.equal(got, score.score_matrix_plain(q, db[:t])), t
    got = lsh_ops.topk_scan(db, q, 200, n_valid=8000, count_ge=0.5)
    want = lsh_scan.running_topk(q, db, 200, 8000, None, 0.5, score.score_matrix_plain)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_score_kernel_grid_of_one_split(dev):
    """Query blocks that fill the card alone: one split, each block walking
    every tile of the table."""
    from datasketch_tpu_torch.kernels import build

    q = _sigs(dev, 20000, 128, 72, values=3)
    db = _sigs(dev, 4096, 128, 73, values=3)
    blocks = tiling.blocks_per_sm(build.library(), "ds_score_blocks_per_sm", q.device, 128)
    assert tiling.grid(20000, 4096, build.num_sms(q), blocks)[0] == 1
    got = _launched(score, lambda: score.score_matrix(q, db))
    assert torch.equal(got, score.score_matrix_plain(q, db))


def test_containment_rerun_past_128_matches_plain(dev):
    """The containment scan at k = 2,048 (the emit variant's pass and
    rescan) against the plain running top-k."""
    db = _sigs(dev, 20011, 128, 74, values=3)
    q = db[:40].clone()
    sizes = _sizes(dev, 20011, 75)
    sizes[::13] = 0
    q_sizes = _sizes(dev, 40, 76)
    got = lsh_ops.containment_scan(db, sizes, q, q_sizes, 0.3, 2048)
    want = lsh_scan.containment_topk_plain(db, sizes, q, q_sizes, 2048, 0.3)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("p", [66, 128])
def test_score_kernel_and_large_k_scan_match_plain(dev, p):
    db = _sigs(dev, 3001, p, 7, values=3)
    q = _sigs(dev, 37, p, 8, values=3)
    got = _launched(score, lambda: score.score_matrix(q, db))
    assert torch.equal(got, score.score_matrix_plain(q, db))
    got = lsh_ops.topk_scan(db, q, 200, n_valid=2900, count_ge=0.3)
    want = lsh_scan.running_topk(q, db, 200, 2900, None, 0.3, score.score_matrix_plain)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_cuda_index_matches_cpu_index(dev):
    rng = np.random.RandomState(9)
    sigs = rng.randint(0, 1 << 32, size=(3000, 128), dtype=np.uint64).astype(np.uint32)
    sigs[2000:] = np.where(rng.rand(1000, 128) < 0.8, sigs[:1000], sigs[2000:])
    queries = sigs[2000:2064]
    pair = [TorchMinHashLSH(threshold=0.5, device=d) for d in (dev, "cpu")]
    for ix in pair:
        ix.index(range(3000), sigs)
        ix.remove(5)
    for method in ("scan", "bands"):
        got = [ix.top_k(queries, 10, method=method) for ix in pair]
        assert got[0] == got[1]
        got = [ix.query_batch(queries, return_scores=True, method=method) for ix in pair]
        assert got[0] == got[1]


@pytest.mark.parametrize("fill", [0.0, 0.002, 0.3, 1.0])
def test_compact_rows_on_the_card_matches_the_cpu(dev, fill):
    """Kernel 8 on a [1,024, 3,200] result (the bands cell's shape), empty
    slots anywhere in a row: counts and the answers equal to the plain
    version's, with and without scores, and to the CPU's."""
    g = _gen(dev, 31)
    filled = torch.rand((1024, 3200), generator=g, device=dev) < fill
    ids = torch.where(filled, torch.randint(0, 1 << 20, filled.shape, generator=g,
                                            device=dev, dtype=torch.int32), -1)
    sc = torch.where(filled, torch.rand(filled.shape, generator=g, device=dev), -1.0)
    for scores in (sc, None):
        got = _launched(compact, lambda: lsh_ops.compact_rows(ids, scores))
        want = compact.compact_rows_plain(ids, scores)
        on_cpu = compact.compact_rows_plain(ids.cpu(), None if scores is None else scores.cpu())
        total = int(want[0].sum())
        assert torch.equal(got[0], want[0]) and torch.equal(got[0].cpu(), on_cpu[0])
        assert (got[2] is None) == (scores is None)
        for i in (1, 2) if scores is not None else (1,):
            assert torch.equal(got[i][:total], want[i][:total])
            assert torch.equal(got[i][:total].cpu(), on_cpu[i][:total])


def test_cuda_threshold_paths_match_cpu(dev):
    """Every threshold path returns its compacted answers as the CPU index
    does: bands fused and with tombstones, candidates only, the scan and
    its escalation past 128 matches, a ``max_results`` cap, and streams."""
    rng = np.random.RandomState(32)
    sigs = rng.randint(0, 1 << 32, size=(3000, 128), dtype=np.uint64).astype(np.uint32)
    sigs[2000:2300] = np.where(rng.rand(300, 128) < 0.9, sigs[:1], sigs[2000:2300])
    queries = np.concatenate([sigs[:2], sigs[2300:2340]])
    for opts in ({}, {"rerank": False}, {"max_results": 20}):
        pair = [TorchMinHashLSH(threshold=0.5, bucket_cap=32, device=d, **opts)
                for d in (dev, "cpu")]
        for ix in pair:
            ix.index(range(3000), sigs)
        methods = ("bands",) if opts.get("rerank") is False else ("scan", "bands")
        for removed in (False, True):
            if removed:
                for ix in pair:
                    ix.remove(2001)
            for method in methods:
                for scores in (False, True):
                    got = [ix.query_batch(queries, return_scores=scores, method=method)
                           for ix in pair]
                    assert got[0] == got[1]
                    assert pair[0].last_truncated == pair[1].last_truncated
                got = [list(ix.query_stream([queries[:2], queries[2:]], return_scores=True,
                                            method=method, depth=2)) for ix in pair]
                assert got[0] == got[1]


def test_lists_of_device_rows_answer_as_the_batch(dev):
    """Rows of a ``bulk_signatures(out="device")`` tensor, one by one or in
    lists, answer as the batch does: ``TorchMinHashLSH`` insert / query /
    top_k, ``TorchBBitIndex`` insert / query, the ensemble's (key, row,
    size) entries and (row, size) queries."""
    rng = np.random.RandomState(30)
    docs = [rng.randint(0, 5000, rng.randint(20, 200)) for _ in range(600)]
    docs[300:] = [np.concatenate([d[: len(d) * 4 // 5], rng.randint(0, 5000, 5)])
                  for d in docs[:300]]
    sigs = MinHash.bulk_signatures(docs, hashfunc="device", out="device", device=dev)
    assert sigs.device.type == "cuda"
    batch = TorchMinHashLSH(threshold=0.5, device=dev)
    rows = TorchMinHashLSH(threshold=0.5, device=dev)
    batch.index(range(600), sigs)
    for i in range(600):
        rows.insert(i, sigs[i])
    queries = sigs[280:330]
    for method in ("scan", "bands"):
        want = batch.top_k(queries, 5, method=method)
        assert rows.top_k(list(queries), 5, method=method) == want
        assert batch.query_batch(list(queries), method=method) == \
            batch.query_batch(queries, method=method)
    assert rows.query(sigs[310]) == batch.query_batch(sigs[310:311])[0]
    bb = [TorchBBitIndex(b=4, num_perm=128, device=dev) for _ in range(2)]
    bb[0].insert_batch(range(600), sigs)
    for i in range(600):
        bb[1].insert(i, sigs[i])
    assert bb[1].query_batch(list(queries), 5) == bb[0].query_batch(queries, 5)
    assert bb[1].query(sigs[5], 3) == bb[0].query_batch(sigs[5:6], 3)[0]
    sizes = [len(np.unique(d)) for d in docs]
    ens = [TorchMinHashLSHEnsemble(threshold=0.8, num_part=4, device=dev) for _ in range(2)]
    ens[0].index_batch(range(600), sigs, sizes)
    ens[1].index([(i, sigs[i], sizes[i]) for i in range(600)])
    want = ens[0].query_batch((queries, sizes[280:330]), method="scan")
    assert ens[1].query_batch(list(zip(queries, sizes[280:330])), method="scan") == want
    assert ens[1].query_batch((sigs[300], sizes[300]), method="scan") == [want[20]]


def test_cuda_ensemble_matches_cpu_ensemble(dev):
    rng = np.random.RandomState(21)
    docs = [np.unique(rng.zipf(1.3, size=rng.randint(20, 200)) % 3000) for _ in range(2000)]
    keep = [d[rng.rand(d.size) < rng.uniform(0.3, 1.0)] for d in docs[:64]]
    queries = [d if d.size else docs[i][:1] for i, d in enumerate(keep)]
    pair = [TorchMinHashLSHEnsemble(threshold=0.8, num_part=8, device=d) for d in (dev, "cpu")]
    for ix in pair:
        ix.index_tokens(range(len(docs)), docs)
    q_sigs = [_token_sigs(ix, queries) for ix in pair]
    sizes = [d.size for d in queries]
    for method in ("scan", "bands", "auto"):
        got = [ix.query_batch((qs, sizes), method=method) for ix, qs in zip(pair, q_sigs)]
        if method == "bands":
            got = [[set(r) for r in g] for g in got]
        assert got[0] == got[1]
        assert pair[0].last_truncated == pair[1].last_truncated


def _token_sigs(ix, docs):
    return MinHash.bulk_signatures(docs, num_perm=ix.h, hashfunc="device", out="device",
                                   device=ix.device)


def _cws_tables(dev, d, s, seed):
    """Transposed f32[D, S] tables drawn as the generator draws them, with
    dims 1 and 2 copies of dim 0 (forced ties for rows that weigh them
    equally)."""
    gen = WeightedMinHashGenerator(d, s, seed=seed, device="cpu")
    tables = [np.ascontiguousarray(p.T) for p in (gen.rs, gen.ln_cs, gen.betas)]
    for t in tables:
        t[1:3] = t[0]
    return [torch.from_numpy(t).to(dev) for t in tables]


def _cws_rows(n, d, seed):
    """f32[n, d] rows about 3 % dense with |N(0, 1)| weights, and ragged
    cases: an empty row, one-dim rows, tied dims 0-2, weights 1e-30 and
    1e30 (negative t), negative and zero entries."""
    rng = np.random.RandomState(seed)
    w = np.where(rng.rand(n, d) < 0.03, np.abs(rng.randn(n, d)), 0.0).astype(np.float32)
    w[0] = 0.0
    w[1] = 0.0
    w[1, d - 1] = 2.5
    w[2, :3] = 0.75
    w[3] = 0.0
    w[3, :40] = 1e-30
    w[4, ::7] = 1e30
    w[5] = -np.abs(w[5])
    w[6, 5] = -1.0
    return w


@pytest.mark.parametrize("d,s", [(1000, 128), (10001, 100), (333, 6)])
def test_cws_kernels_match_plain(dev, d, s):
    """Kernels 6 and 7 against their plain twins on the same CUDA tensors,
    and kernel 7 on CSR rows against kernel 6 on the same rows densified."""
    tables = _cws_tables(dev, d, s, seed=d)
    w_host = _cws_rows(97, d, seed=s)
    w = torch.from_numpy(w_host).to(dev)
    dense = _launched(cws, lambda: cws.cws_dense(w, *tables))
    assert torch.equal(dense, cws.cws_dense_plain(w, *tables))
    assert (dense[3, :, 1] < 0).all()
    import scipy.sparse as sp

    x = sp.csr_matrix(w_host)
    args = [torch.from_numpy(a).to(dev) for a in (x.data, x.indices.astype(np.int32),
                                                  x.indptr.astype(np.int64))]
    before = cws.launches_sparse
    sparse = cws.cws_sparse(*args, *tables)
    torch.cuda.synchronize()
    assert cws.launches_sparse == before + 1
    assert torch.equal(sparse, cws.cws_sparse_plain(*args, *tables))
    assert torch.equal(sparse, dense)


@pytest.mark.parametrize("d,s", [(10000, 1), (10000, 6), (10001, 100), (10000, 128),
                                 (333, 6)])
def test_cws_sparse_entry_order(dev, d, s):
    """Kernel 7 against its plain twin on rows whose entry order matters
    (``chip_smoke.cws_order_case``): a tie between distant dims, falling
    dims (the first minimum in entry order wins), inactive entries
    anywhere, long rows, an empty row; and the padded form, equal to
    kernel 6 on the rows densified where their dims ascend."""
    import chip_smoke

    tabs, (vals, idx, indptr), ties = chip_smoke.cws_order_case(torch, d, s, dev, 300)
    want = cws.cws_sparse_plain(vals, idx, indptr, *tabs)
    for row, dim in ties:
        assert (want[row, :, 0] == dim).all()
    before = cws.launches_sparse
    got = cws.cws_sparse(vals, idx, indptr, *tabs)
    torch.cuda.synchronize()
    assert cws.launches_sparse == before + 1
    assert torch.equal(got, want)
    lengths = indptr[1:] - indptr[:-1]
    col = torch.arange(int(lengths.max()), device=dev)
    valid = col[None, :] < lengths[:, None]
    pos = torch.where(valid, indptr[:-1, None] + col[None, :], 0)
    padded = cws_ops.cws_many_sparse(torch.where(valid, vals[pos], 0.0),
                                     torch.where(valid, idx[pos], 0), *tabs)
    assert torch.equal(padded, want)
    dense = cws.cws_dense(chip_smoke.densify(torch, vals, idx, indptr, d), *tabs)
    assert torch.equal(dense[[0, 1, 2, 6]], want[[0, 1, 2, 6]])


@pytest.mark.parametrize("d,s", [(10000, 128), (10001, 100), (333, 6), (1, 1), (10000, 129),
                                 (10001, 256), (10000, 6), (333, 1030)])
def test_cws_dense_kernel_cases(dev, d, s):
    """Kernel 6 against its plain twin and kernel 7 on
    ``chip_smoke.cws_dense_case``'s rows: an empty row, one active dim at
    the end, fully dense rows, ties across 1,024-dim chunks and list
    flushes and across warps' segments, tiny, huge and negative weights; at
    S from 1 to past 1,024 (a second block of sample groups), D odd and
    even."""
    import chip_smoke

    tabs, w, ties = chip_smoke.cws_dense_case(torch, d, s, dev, 64)
    got = _launched(cws, lambda: cws.cws_dense(w, *tabs))
    assert torch.equal(got, cws.cws_dense_plain(w, *tabs))
    for row, dim in ties:
        assert (got[row, :, 0] == dim).all()
    vals, idx, indptr = chip_smoke.to_csr(torch, w)
    assert torch.equal(got, cws.cws_sparse(vals, idx, indptr, *tabs))


@pytest.mark.parametrize("d,s", [(10000, 1), (10001, 100), (10000, 128), (333, 6)])
def test_cws_dense_kernel_on_densified_order_rows(dev, d, s):
    """``chip_smoke.cws_order_case``'s rows densified through kernel 6: the
    tie of dims 64 and 192 (row 2) lies in two warps' segments and goes to
    64; and weights 4 bytes past a 16-byte boundary give the same."""
    import chip_smoke

    tabs, (vals, idx, indptr), _ = chip_smoke.cws_order_case(torch, d, s, dev, 300)
    w = chip_smoke.densify(torch, vals, idx, indptr, d)
    got = _launched(cws, lambda: cws.cws_dense(w, *tabs))
    assert torch.equal(got, cws.cws_dense_plain(w, *tabs))
    assert (got[2, :, 0] == 64).all()
    buf = torch.empty(w.numel() + 1, dtype=torch.float32, device=dev)
    moved = buf[1:].view(w.shape).copy_(w)
    assert torch.equal(_launched(cws, lambda: cws.cws_dense(moved, *tabs)), got)


@pytest.mark.parametrize("n_rows,d,s", [(1, 10001, 1), (511, 333, 6), (513, 10001, 100),
                                         (513, 10001, 128), (1100, 333, 129), (600, 333, 256),
                                         (300, 333, 1030), (65537, 333, 128)])
def test_cws_sparse_row_blocks(dev, n_rows, d, s):
    """Kernel 7 against its plain twin on ``chip_smoke.cws_block_case``'s
    rows: batches of 1, 511, 513 and 65,537 rows, S from 1 to 1,030, D of
    333 and 10,001, rows in shuffled order, a fully dense row of D dims
    among ~2 % rows, ties within a 64-dim chunk, across chunks and at
    ln_a = +0.0 (the first entry wins)."""
    import chip_smoke

    tabs, csr, ties = chip_smoke.cws_block_case(torch, d, s, dev, n_rows)
    want = cws.cws_sparse_plain(*csr, *tabs)
    assert ties or d < 41 or n_rows < 2
    for row, dim in ties:
        assert (want[row, :, 0] == dim).all()
    before = cws.launches_sparse
    got = cws.cws_sparse(*csr, *tabs)
    torch.cuda.synchronize()
    assert cws.launches_sparse == before + 1
    assert torch.equal(got, want)


def test_cws_sparse_unaligned_tables_and_no_entries(dev):
    """Kernel 7 on tables 4 bytes past a 16-byte boundary (its scalar
    loads, vec = 0) equals the aligned call; a batch with nnz 0, and rows of
    only inactive entries, give (0, 0)."""
    import chip_smoke

    tabs, csr, _ = chip_smoke.cws_block_case(torch, 10001, 128, dev, 513)
    aligned = cws.cws_sparse(*csr, *tabs)
    moved = [chip_smoke.unaligned_copy(torch, t) for t in tabs]
    assert cws._vec(128, *moved) == 0
    assert torch.equal(cws.cws_sparse(*csr, *moved), aligned)
    assert torch.equal(aligned, cws.cws_sparse_plain(*csr, *tabs))
    empty = (torch.zeros(0, dtype=torch.float32, device=dev),
             torch.zeros(0, dtype=torch.int32, device=dev),
             torch.zeros(6, dtype=torch.int64, device=dev))
    before = cws.launches_sparse
    got = cws.cws_sparse(*empty, *tabs)
    torch.cuda.synchronize()
    assert cws.launches_sparse == before + 1
    assert got.shape == (5, 128, 2) and not got.any()
    vals = -torch.ones(9, device=dev)
    vals[4] = 0.0
    idx = torch.arange(9, dtype=torch.int32, device=dev)
    indptr = torch.tensor([0, 4, 9], device=dev)
    assert not cws.cws_sparse(vals, idx, indptr, *tabs).any()


def test_cws_sparse_nan_and_inf_ln_a_never_win(dev):
    """Parameters that make ln_a NaN (r = 0) or +inf (ln c = +inf) leave
    the entry unchosen, as a strict < against a +inf carry does: rows equal
    the plain twin on the rows with those entries inactive (the plain
    argmin would take a NaN), a row of only such entries gives (0, 0);
    weights of +inf give ln_a = -inf, the first entry wins, t = INT32_MAX."""
    import chip_smoke

    tabs, csr, masked = chip_smoke.cws_odd_case(torch, dev)
    got = cws.cws_sparse(*csr, *tabs)
    want = cws.cws_sparse_plain(*masked, *tabs)
    keep = [i for i in range(got.shape[0]) if i != 41]
    assert torch.equal(got[keep], want[keep])
    assert not got[40].any()
    assert (got[41, :, 0] == 3).all() and (got[41, :, 1] == 2 ** 31 - 1).all()
    assert (got[42, :, 0] == 11).all()


def test_kt_slots_on_the_card_match_host(dev):
    rng = np.random.RandomState(3)
    kt = np.stack([rng.randint(0, 10000, (4096, 128)),
                   rng.randint(-(1 << 20), 1 << 20, (4096, 128))], axis=-1).astype(np.int32)
    got = cws_ops.kt_slots(torch.from_numpy(kt).to(dev)).cpu().numpy().view(np.uint32)
    assert np.array_equal(got, cws_ops.kt_slots_np(kt))


def test_cuda_weighted_index_matches_cpu_index(dev):
    import scipy.sparse as sp

    rng = np.random.RandomState(4)
    base = np.where(rng.rand(600, 2000) < 0.02, np.abs(rng.randn(600, 2000)), 0.0)
    base[:, 7] = 1.0
    x = sp.csr_matrix(base.astype(np.float32))
    q = x[:48].copy()
    q.data *= rng.uniform(0.85, 1.15, q.nnz).astype(np.float32)
    gens = [WeightedMinHashGenerator(2000, 128, seed=1, device=d) for d in (dev, "cpu")]
    kts = [g.minhash_many(x, out="device") for g in gens]
    assert torch.equal(kts[0].cpu(), kts[1])
    pair = [TorchMinHashLSH(threshold=0.5, device=d) for d in (dev, "cpu")]
    for ix, kt in zip(pair, kts):
        ix.index(range(600), kt)
    qs = [g.minhash_many(q, out="device") for g in gens]
    for method in ("scan", "bands"):
        got = [ix.top_k(qq, 5, method=method) for ix, qq in zip(pair, qs)]
        assert got[0] == got[1]
        got = [ix.query_batch(qq, return_scores=True, method=method)
               for ix, qq in zip(pair, qs)]
        assert got[0] == got[1]


def test_cws_sparse_rejects_bad_csr(dev):
    """Offsets or dims that would read outside the arrays raise before any
    launch."""
    tables = _cws_tables(dev, 50, 8, seed=1)
    vals = torch.ones(6, device=dev)
    idx = torch.arange(6, dtype=torch.int32, device=dev)
    bad = [
        (vals, idx, torch.tensor([0, 4, 7], device=dev)),  # past nnz
        (vals, idx, torch.tensor([0, 4, 2, 6], device=dev)),  # falling
        (vals, idx + 45, torch.tensor([0, 6], device=dev)),  # dim >= D
    ]
    before = cws.launches_sparse
    for args in bad:
        with pytest.raises(ValueError):
            cws.cws_sparse(*args, *tables)
    assert cws.launches_sparse == before


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("num_perm", [128, 100, 256])
def test_bbit_kernel_matches_plain(dev, b, num_perm):
    """Kernel 5 against its plain twin: every slot size, padding slots
    (num_perm 100), W up to 256, ragged Q and T, low-cardinality bits."""
    s = bbit_ops.slot_size(b)
    sigs = _sigs(dev, 1000 + 40, num_perm, b, values=4)
    packed = bbit_ops.pack_bbit(sigs, b)
    db, q = packed[:1000], packed[1000:]
    q[0] = db[17]
    for nq, nt in ((1, 1), (33, 1000), (40, 33), (1, 1000)):
        got = _launched(bbit, lambda: bbit.bbit_counts(q[:nq], db[:nt], s))
        want = bbit.bbit_counts_plain(q[:nq], db[:nt], s)
        assert torch.equal(got, want)
    full = bbit_ops.match_counts(q, db, b, num_perm)
    assert int(full[0, 17]) == num_perm


def test_cuda_bbit_index_matches_cpu_index(dev):
    rng = np.random.RandomState(12)
    sigs = rng.randint(0, 1 << 32, size=(5000, 128), dtype=np.uint64).astype(np.uint32)
    sigs[4000:] = np.where(rng.rand(1000, 128) < 0.7, sigs[:1000], sigs[4000:])
    queries = sigs[3950:4050]
    for b in (1, 4):
        pair = [TorchBBitIndex(b=b, num_perm=128, device=d) for d in (dev, "cpu")]
        for ix in pair:
            ix.insert_batch(range(4000), sigs[:4000])
            ix.insert_batch(range(4000, 5000), torch.from_numpy(sigs[4000:].view(np.int32)))
            ix.remove_batch(range(0, 5000, 13))
        for k in (1, 10, 300):
            got = [ix.query_batch(queries, k, return_scores=True) for ix in pair]
            assert got[0] == got[1]
        got = [list(ix.query_stream([queries[:30], queries[30:]], 5)) for ix in pair]
        assert got[0] == got[1]


@pytest.mark.parametrize("hashfunc", ["sha1", "device"])
def test_bulk_from_text_on_the_card_matches_cpu(dev, hashfunc):
    rng = np.random.RandomState(13)
    texts = [bytes(rng.randint(97, 110, rng.randint(0, 3000), dtype=np.uint8))
             for _ in range(700)]
    kw = {} if hashfunc == "sha1" else {"hashfunc": "device"}
    got = MinHash.bulk_from_text(texts, k=9, out="device", device=dev, **kw)
    want = MinHash.bulk_from_text(texts, k=9, out="device", device="cpu", **kw)
    assert torch.equal(got.cpu(), want)


def _forest_rows(n, p, seed):
    rng = np.random.RandomState(seed)
    sigs = rng.randint(0, 64, size=(n, p), dtype=np.uint64).astype(np.uint32)
    sigs[n // 2:] = np.where(rng.rand(n - n // 2, p) < 0.8, sigs[: n - n // 2], sigs[n // 2:])
    return sigs


@pytest.mark.parametrize("n", [4096, 5000])
def test_cuda_forest_matches_cpu_forest(dev, n, tmp_path):
    sigs = _forest_rows(n, 256, n)
    q = np.where(np.random.RandomState(1).rand(70, 256) < 0.75, sigs[:70], 7)
    kw = dict(num_perm=128, cap=16, cascade_perm=256)
    pair = [TorchMinHashLSHForest(device=d, **kw) for d in (dev, "cpu")]
    for ix in pair:
        ix.index(range(n), sigs)
    for rank, method, k in (("forest", "forest", 10), ("jaccard", "forest", 10),
                            ("jaccard", "scan", 10), ("jaccard", "scan", 200),
                            ("jaccard", "auto", 10)):
        got = [ix.query_batch(q, k, True, rank=rank, method=method) for ix in pair]
        assert got[0] == got[1]
        assert pair[0].last_truncated == pair[1].last_truncated
    assert pair[0].status()["max_leaf_run"] == pair[1].status()["max_leaf_run"]
    pair[0].save(str(tmp_path / "f"))
    back = TorchMinHashLSHForest.load(str(tmp_path / "f.npz"), device="cpu")
    assert back.query_batch(q, 10, True) == pair[0].query_batch(q, 10, True)
    stream = list(pair[0].query_stream([q[:32], q[32:]], 10, True))
    assert stream == [pair[0].query_batch(q[:32], 10, True), pair[0].query_batch(q[32:], 10, True)]


def test_forest_build_on_the_card_matches_host_lexsort(dev):
    sigs = _forest_rows(20000, 128, 3)
    fps = forest_ops.prefix_fingerprints(torch.from_numpy(sigs.view(np.int32)).to(dev), 8, 16)
    got_fps, got_ids = forest_ops.build_forest(fps)
    want_fps, want_ids = forest_ops.build_forest_host(sigs, 8, 16)
    assert np.array_equal(forest_ops.fingerprints_u32(got_fps), want_fps)
    assert np.array_equal(got_ids.cpu().numpy(), want_ids)


def test_cuda_lsh_facade_matches_cpu(dev, tmp_path):
    rng = np.random.RandomState(4)
    sigs = rng.randint(0, 1 << 32, size=(3000, 256), dtype=np.uint64).astype(np.uint32)
    sigs[2000:] = np.where(rng.rand(1000, 256) < 0.8, sigs[:1000], sigs[2000:])
    q = sigs[1990:2053]
    pair = []
    for d in (dev, "cpu"):
        a = TorchMinHashLSH(threshold=0.5, cascade_perm=256, bucket_cap=8, device=d)
        b = TorchMinHashLSH(threshold=0.5, cascade_perm=256, bucket_cap=8, device=d)
        a.index(range(1500), sigs[:1500])
        b.index(range(1500, 3000), sigs[1500:])
        a.merge(b)
        for key in range(0, 3000, 7):
            a.remove(key)
        pair.append(a)
    for call in (lambda ix: ix.top_k(q, 10, method="bands"),
                 lambda ix: ix.query_batch(q, return_scores=True, method="scan"),
                 lambda ix: [ix.query_b(q, b) for b in (1, 3, ix.b)]):
        got = [call(ix) for ix in pair]
        assert got[0] == got[1] and pair[0].last_truncated == pair[1].last_truncated
    for ix in pair:
        ix.compact()
    assert pair[0].top_k(q, 10) == pair[1].top_k(q, 10)
    pair[0].save(str(tmp_path / "lsh"))
    back = TorchMinHashLSH.load(str(tmp_path / "lsh"), device="cpu")
    assert back.query_batch(q, method="bands") == pair[0].query_batch(q, method="bands")
    batches = [q[:30], q[30:]]
    assert list(pair[0].query_stream(batches, method="scan")) == \
        [pair[0].query_batch(b, method="scan") for b in batches]
    assert list(pair[0].top_k_stream(batches, 5)) == [pair[0].top_k(b, 5) for b in batches]


def test_update_batch_on_the_card_matches_host(dev):
    toks = [b"token-%d" % i for i in range(5000)]
    card = MinHash(num_perm=100, device_mode="always", device=dev)
    before = minhash_sign.launches
    card.update_batch(toks[:10])
    card.update_batch(toks)
    assert minhash_sign.launches == before + 2
    host = MinHash(num_perm=100, device_mode="disable")
    host.update_batch(toks)
    assert card == host
    bulk = MinHash.bulk([toks[:3000], toks[3000:]], num_perm=100, device=dev)
    assert LeanMinHash(MinHash.union(*bulk)) == LeanMinHash(host)


@pytest.mark.parametrize("p", [4, 14])
def test_hll_registers_on_the_card_match_cpu(dev, p):
    from datasketch_tpu_torch import HyperLogLog, HyperLogLogPlusPlus
    from datasketch_tpu_torch.ops import hll_ops

    rng = np.random.RandomState(p)
    docs = [rng.randint(0, 1 << 24, size=rng.randint(0, 700)).astype(np.uint32)
            for _ in range(300)]
    before = hll_ops.device_calls
    for cls in (HyperLogLog, HyperLogLogPlusPlus):
        kw = dict(p=p, hashfunc="device", device_mode="always")
        card = cls.bulk_registers(docs, device=dev, **kw)
        np.testing.assert_array_equal(card, cls.bulk_registers(docs, device="cpu", **kw))
        np.testing.assert_array_equal(
            card, cls.bulk_registers(docs, p=p, hashfunc="device", device_mode="disable"))
    assert hll_ops.device_calls > before
    regs = torch.from_numpy(card)
    np.testing.assert_allclose(hll_ops.count_batch(regs.to(dev), p).cpu().numpy(),
                               hll_ops.count_batch(regs, p).numpy(), rtol=1e-5)
    toks = [b"u-%d" % i for i in range(1 << 15)]
    for cls in (HyperLogLog, HyperLogLogPlusPlus):
        on_card = cls(p=p, device_mode="always", device=dev)
        on_card.update_batch(toks)
        host = cls(p=p, device_mode="disable")
        host.update_batch(toks)
        assert on_card == host


@pytest.mark.parametrize("scheme", ["oph", "cminhash"])
def test_scheme_signatures_on_the_card_match_cpu(dev, scheme):
    rng = np.random.RandomState(3)
    docs = [[b"w%d" % x for x in rng.randint(0, 9000, size=rng.randint(0, 300))]
            for _ in range(700)]
    kw = dict(scheme=scheme, num_perm=129, seed=5)
    card = MinHash.bulk_signatures(docs, out="device", device=dev, **kw)
    assert card.device.type == "cuda"
    np.testing.assert_array_equal(card.cpu().numpy().view(np.uint32),
                                  MinHash.bulk_signatures(docs, device="cpu", **kw))
    texts = [bytes(rng.randint(97, 123, size=n, dtype=np.uint8)) for n in (0, 5, 40, 900)]
    np.testing.assert_array_equal(MinHash.bulk_from_text(texts, k=5, device=dev, **kw),
                                  MinHash.bulk_from_text(texts, k=5, device="cpu", **kw))


def test_bloom_words_on_the_card_match_cpu(dev, tmp_path):
    from datasketch_tpu_torch import TorchMinHashLSHBloom

    sigs = _sigs(dev, 5000, 128, 41)
    pair = [TorchMinHashLSHBloom(threshold=0.8, n=20000, fp=0.01, device=d)
            for d in (dev, "cpu")]
    pair[0].insert_batch(sigs)
    pair[1].insert_batch(sigs.cpu().numpy().view(np.uint32))
    assert torch.equal(pair[0]._words.cpu(), pair[1]._words)
    probe = torch.cat([sigs[:100], _sigs(dev, 100, 128, 42)])
    np.testing.assert_array_equal(pair[0].query_batch(probe), pair[1].query_batch(probe))
    pair[0].save(str(tmp_path / "bloom"))
    back = TorchMinHashLSHBloom.load(str(tmp_path / "bloom"), device="cpu")
    assert torch.equal(back._words, pair[1]._words)


@pytest.mark.parametrize("p", [66, 128])
@pytest.mark.parametrize("k", [5, 47, 127])
def test_knn_scan_route_matches_plain_tiles(dev, p, k):
    """The HNSW build's kNN rows through kernel 2 (k + 1 <= 128) against
    the plain distance tiles, with 160 copies of one row (its own id falls
    out of the scan's k + 1)."""
    from datasketch_tpu_torch.ops import knn_graph

    pts = _sigs(dev, 3000, p, 1000 + p + k, values=3)
    pts[40:200] = pts[7]
    assert knn_graph.knn_route(pts, k, "minhash_jaccard") == "scan"
    before = lsh_scan.launches
    got = knn_graph.knn_adjacency(pts, k, "minhash_jaccard")
    assert lsh_scan.launches > before
    assert torch.equal(got, knn_graph.knn_adjacency(pts, k, "minhash_jaccard", _route="tiles"))


@pytest.mark.parametrize("p", [66, 128, 512])
def test_knn_score_route_matches_plain_tiles(dev, p):
    """The kNN rows through kernel 4 (k + 1 > 128, or P > 256)."""
    from datasketch_tpu_torch.ops import knn_graph

    pts = _sigs(dev, 2000, p, 2000 + p, values=3)
    pts[40:200] = pts[7]
    for k in (150,) if p <= 256 else (16, 150):
        assert knn_graph.knn_route(pts, k, "minhash_jaccard") == "score"
        before = score.launches
        got = knn_graph.knn_adjacency(pts, k, "minhash_jaccard")
        assert score.launches > before
        assert torch.equal(got, knn_graph.knn_adjacency(pts, k, "minhash_jaccard",
                                                        _route="tiles"))


@pytest.mark.parametrize("metric", ["minhash_jaccard", "l2"])
def test_torch_hnsw_on_the_card_matches_the_cpu(dev, metric):
    """A CUDA TorchHNSW against a device="cpu" one: the built graph, an
    append with overflow re-prunes, removals and the answers."""
    from datasketch_tpu_torch import TorchHNSW

    rng = np.random.RandomState(5)
    if metric == "minhash_jaccard":
        pts = rng.randint(0, 4, (2000, 66)).astype(np.uint32)
    else:
        pts = rng.randint(-8, 9, (2000, 32)).astype(np.float32)
    new = pts[rng.randint(0, 8, 200)].copy()
    pair = [TorchHNSW(distance_metric=metric, m=8, ef=32, device=d) for d in (dev, "cpu")]
    for ix in pair:
        ix.index(range(2000), pts)
        for i in range(200):
            ix.add(5000 + i, new[i])
        ix.flush()
        for key in range(0, 2000, 9):
            ix.remove(key)
    a, b = pair[0]._graph, pair[1]._graph
    assert pair[0].status()["appended_since_build"] == 200
    assert torch.equal(a.adj0.cpu(), b.adj0) and a.entry == b.entry
    assert all(torch.equal(x.cpu(), y) for x, y in zip(a.upper_adj, b.upper_adj))
    q = np.concatenate([pts[:64], new[:64]])
    assert pair[0].query_batch(q, 10) == pair[1].query_batch(q, 10)


def _packed_random_tokens(lens, seed):
    """Random bytes for tokens of ``lens`` bytes, back to back, and their
    int32 offsets, both pinned."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8)
    offs = np.zeros(lens.size + 1, dtype=np.int32)
    np.cumsum(lens, out=offs[1:])
    return raw, offs, torch.from_numpy(raw).pin_memory(), torch.from_numpy(offs).pin_memory()


def test_sha1_kernel_matches_hashlib_on_3m_tokens(dev):
    rng = np.random.default_rng(11)
    lens = rng.integers(0, 131, 3_000_000)
    lens[:8] = [0, 1, 55, 56, 63, 64, 119, 120]  # the padding edges
    lens[1000:1256] = 1000  # one block's range past the staging window
    lens[5000] = 40000  # one token past it alone
    raw, offs, data, offsets = _packed_random_tokens(lens, 12)
    out = torch.empty(lens.size, dtype=torch.int32, device=dev)
    got = _launched(sha1, lambda: sha1.sha1_hash32(data, offsets, lens.size, out))
    want = np.fromiter(
        (int.from_bytes(hashlib.sha1(raw[offs[i]: offs[i + 1]]).digest()[:4], "little")
         for i in range(lens.size)), dtype=np.uint32, count=lens.size)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want)
    head = sha1.sha1_hash32_plain(data, offsets, 20000)
    assert torch.equal(got[:20000].cpu(), head)


@pytest.mark.parametrize("last", [5, 17, 20000])
def test_sha1_kernel_reads_a_buffer_that_ends_inside_its_last_16_bytes(dev, last):
    """The buffer ends with the last token, at no multiple of 16 bytes: the
    staging window's last 16-byte load is cut at the buffer's end."""
    lens = np.concatenate([np.random.default_rng(last).integers(0, 131, 700), [last]])
    if lens.sum() % 16 == 0:
        lens[0] += 1
    raw, offs, data, offsets = _packed_random_tokens(lens, 16)
    assert data.numel() == offs[-1] and data.numel() % 16
    out = torch.empty(lens.size, dtype=torch.int32, device=dev)
    got = _launched(sha1, lambda: sha1.sha1_hash32(data, offsets, lens.size, out))
    assert torch.equal(got.cpu(), sha1.sha1_hash32_plain(data, offsets, lens.size))


def test_sha1_kernel_refuses_pageable_and_unaligned_buffers(dev):
    out = torch.empty(2, dtype=torch.int32, device=dev)
    offsets = torch.tensor([0, 3, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="pinned"):
        sha1.sha1_hash32(torch.zeros(64, dtype=torch.uint8), offsets, 2, out)
    data = torch.zeros(64, dtype=torch.uint8).pin_memory()
    with pytest.raises(ValueError, match="aligned"):
        sha1.sha1_hash32(data[1:], offsets.pin_memory(), 2, out)


def _word_corpus(n_docs, seed, long_share=0.0):
    """Bytes documents of 0-299 tokens: 10-byte words of a 5,000-word
    vocabulary, a ``long_share`` of them 0-130 random bytes instead."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(w) for w in rng.integers(0, 256, (5000, 10), dtype=np.uint8)]
    docs = []
    for _ in range(n_docs):
        ids = rng.integers(0, 5000, int(rng.integers(0, 300)))
        doc = [vocab[i] for i in ids]
        for j in np.nonzero(rng.random(len(doc)) < long_share)[0]:
            doc[j] = bytes(rng.integers(0, 256, int(rng.integers(0, 131)), dtype=np.uint8))
        docs.append(doc)
    return docs


def _host_hashed_signatures(docs, dev, num_perm=128, seed=1):
    """Kernel 1 over the host hasher's hashes of ``docs``, in input order."""
    flat, lengths = native.hash_ragged(docs)
    return compute_signatures_ragged(torch.from_numpy(flat.view(np.int32)).to(dev),
                                     torch.from_numpy(lengths).to(dev), seed, num_perm)


def test_bulk_signatures_hash_sha1_on_the_card(dev):
    docs = _word_corpus(20000, 13, long_share=0.05)
    before = (sha1.launches, minhash_sign.launches)
    got = MinHash.bulk_signatures(docs, num_perm=128, out="device", device=dev)
    torch.cuda.synchronize()
    k9, k1 = sha1.launches - before[0], minhash_sign.launches - before[1]
    assert k9 == k1 >= 2  # one launch of each a chunk
    assert torch.equal(got, _host_hashed_signatures(docs, dev))


def test_back_to_back_sha1_calls_keep_their_pinned_buffers(dev):
    """The stream is held ~0.5 s first, so the host packs every chunk of
    three calls while kernel 9 has read none of them: a slot may be refilled
    only after the launch that reads it has run."""
    a, b = _word_corpus(20000, 14), _word_corpus(20000, 15)
    torch.cuda._sleep(int(1e9))
    got = [MinHash.bulk_signatures(x, num_perm=128, out="device", device=dev)
           for x in (a, b, a)]
    torch.cuda.synchronize()
    want_a, want_b = _host_hashed_signatures(a, dev), _host_hashed_signatures(b, dev)
    assert torch.equal(got[0], want_a) and torch.equal(got[1], want_b)
    assert torch.equal(got[2], want_a)
