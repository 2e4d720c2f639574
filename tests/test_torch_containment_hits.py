"""Port parity: ``ops.lsh_ops.containment_hits`` (one pass of kernel 2s's
emit variant, a row sort, and an exact rescan of the queries past the cap,
through the plain twin on the CPU) against the plain running top-k at
k = cap (``lsh_scan.containment_topk_plain``) and against the JAX
package's ``containment_scan``: ids, f32 containment
scores and match counts, exact. The facade's scan path built on it against
``TpuMinHashLSHEnsemble``. The card's emit variant against the plain twin
(``-m cuda``; the card's machine has no JAX, so only the CPU tests import
it)."""

import numpy as np
import pytest
import torch

from datasketch_tpu_torch import MinHash, TorchMinHashLSHEnsemble
from datasketch_tpu_torch.kernels import lsh_scan
from datasketch_tpu_torch.ops import lsh_ops

torch.set_num_threads(2)

CAP = 2048


def _case(p, seed=5):
    """6,000 rows of random slots, but for three planted blocks: 2,600
    near-copies of signature A (each with 0-7 slots redrawn, the first 1,000
    of size 150: tied estimates at equal counts), 500 exact copies of B of
    size 150 (all tied), 10 copies of C; every 17th row is padding (size 0).
    Queries: A at sizes 150, 120, 100 and 400 (past the cap), B and
    a 5-slot-redrawn B (17-2,048 matches), C (at most 16), random rows (no
    match), and sizes 0 and 1."""
    rng = np.random.RandomState(seed)
    n = 6000

    def rand(m):
        return rng.randint(0, 1 << 32, size=(m, p), dtype=np.uint64).astype(np.uint32)

    db = rand(n)
    a, b, c = rand(3)
    db[:2600] = a
    for i in range(2600):
        redraw = rng.choice(p, rng.randint(0, 8), replace=False)
        db[i, redraw] = rand(1)[0, redraw]
    db[2600:3100] = b
    db[3100:3110] = c
    sizes = rng.randint(100, 200, size=n).astype(np.int32)
    sizes[:1000] = 150
    sizes[2600:3100] = 150
    sizes[::17] = 0
    b5 = b.copy()
    b5[:5] = rand(1)[0, :5]
    q = np.stack([a, a, a, a, b, b5, c, *rand(3), a, c])
    q_sizes = np.array([150, 120, 100, 400, 150, 150, 150, 150, 120, 90, 0, 1], np.int32)
    return db, sizes, q, q_sizes


def _tensors(case, device="cpu"):
    return [torch.from_numpy(x.view(np.int32)).to(device) for x in case]


def _jax(case, cutoff, k):
    import jax.numpy as jnp
    from datasketch_tpu.ops import lsh_ops as jax_lsh

    db, sizes, q, q_sizes = case
    args = (jnp.asarray(db), jnp.asarray(sizes), jnp.asarray(q), jnp.asarray(q_sizes),
            jnp.float32(cutoff))
    jax_lsh.containment_scan.clear_cache()
    try:
        return [np.asarray(x) for x in jax_lsh.containment_scan(*args, k)]
    finally:
        jax_lsh.containment_scan.clear_cache()


def _scans(monkeypatch):
    """The emit-variant scans a call runs: (queries, row capacity) each."""
    real, runs = lsh_scan.containment_hits, []

    def counted(db, sizes, q, q_sizes, cutoff, cap):
        runs.append((q.shape[0], cap))
        return real(db, sizes, q, q_sizes, cutoff, cap)

    monkeypatch.setattr(lsh_scan, "containment_hits", counted)
    return runs


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("p", [66, 128, 256])
@pytest.mark.parametrize("cutoff", [0.5, 0.8])
def test_containment_hits_match_the_scan_and_jax(p, cutoff, monkeypatch):
    case = _case(p)
    runs = _scans(monkeypatch)
    got = [x.numpy() for x in lsh_ops.containment_hits(*_tensors(case), cutoff, CAP)]
    n = got[2]
    # every class of match count, and ties: equal scores at equal counts
    assert (n == 0).any() and ((n > 0) & (n <= 16)).any()
    assert ((n > 16) & (n <= CAP)).any() and (n > CAP).sum() >= 3
    row = got[1][0]
    assert (np.diff(row[row >= 0]) == 0).any()
    # pass 1 over the batch, one pass 2 over the queries past the cap
    assert runs == [(len(n), CAP), (int((n > CAP).sum()), int(n.max()))]
    _eq(got, [x.numpy() for x in lsh_scan.containment_topk_plain(*_tensors(case), CAP, cutoff)])
    _eq(got, _jax(case, cutoff, CAP))


@pytest.mark.parametrize("p", [66, 128, 256])
def test_a_small_budget_rescans_in_several_chunks(p, monkeypatch):
    """A budget below one query's row: each chunk takes as many queries
    as N keys hold (the budget's floor), largest count first."""
    case = _case(p)
    want = lsh_ops.containment_hits(*_tensors(case), 0.5, CAP)
    runs = _scans(monkeypatch)
    got = lsh_ops.containment_hits(*_tensors(case), 0.5, CAP, budget=1)
    _eq(got, want)
    n = want[2].numpy()
    over = np.sort(n[n > CAP])[::-1]
    assert len(runs) >= 3 and sum(q for q, _ in runs[1:]) == over.size
    assert [w for _, w in runs[1:]] == sorted((w for _, w in runs[1:]), reverse=True)
    assert all(q * w <= 6000 or q == 1 for q, w in runs[1:])


@pytest.mark.parametrize("cap", [1, 16, 300, CAP])
def test_the_plain_twin_writes_every_hit_or_its_first_cap(cap):
    """The emit variant's contract on its plain twin: exact counts (those of
    the top-k scan); a row with at most ``cap`` hits holds exactly its
    hits' keys, one past it ``cap`` distinct hits (the first in row
    order)."""
    t = _tensors(_case(128))
    keys, n = lsh_scan.containment_hits_plain(*t, 0.5, cap)
    full, n_all = lsh_scan.containment_hits_plain(*t, 0.5, 6000)
    ids, _, n_scan = lsh_ops.containment_scan(*t, 0.5, 1)
    assert torch.equal(n, n_scan) and torch.equal(n_all, n)
    for i in range(keys.shape[0]):
        row, every = keys[i][keys[i] >= 0], full[i][full[i] >= 0]
        assert row.numel() == min(int(n[i]), cap) == row.unique().numel()
        assert torch.equal(row, every[:cap])
    # keys order as (c desc, row asc): the top key is the top-1 scan's row
    top = lsh_ops.hit_ids(torch.sort(keys, dim=1, descending=True).values)[:, 0]
    hit = n > 0
    if cap >= int(n.max()):
        assert torch.equal(top[hit], ids[hit, 0])


def test_cpu_tensors_take_the_plain_twin():
    t = _tensors(_case(66))
    before = (lsh_scan.launches, lsh_scan.launches_sizes, lsh_scan.launches_hits)
    got = lsh_scan.containment_hits(*t, 0.5, 40)
    want = lsh_scan.containment_hits_plain(*t, 0.5, 40)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (lsh_scan.launches, lsh_scan.launches_sizes, lsh_scan.launches_hits) == before
    with pytest.raises(ValueError, match="cap must be at least 1"):
        lsh_scan.containment_hits(*t, 0.5, 0)
    keys, n = lsh_ops.containment_first_pass(*t, 0.5, 40)
    assert lsh_ops.containment_rescan(*t, 0.5, keys, np.minimum(n.numpy(), 40)) == 0


# ------------------------------------------------------------ the facade


def _lake(n=1500, seed=3):
    """Token sets of Zipf(0.8) ids over 2,000 (lognormal lengths around
    60), and queries: subsets of stored sets at keep rates U(0.3, 1.0) (a
    handful of matches each), and tiny sets of the commonest ids, which
    most sets contain (matches past ``max_results``)."""
    rng = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, 2001) ** 0.8
    cum = np.cumsum(w / w.sum())
    lengths = np.maximum(8, rng.lognormal(np.log(60), 0.5, n)).astype(int)
    docs = [np.searchsorted(cum, rng.rand(m)).astype(np.int64) for m in lengths]
    subsets = []
    for i in rng.choice(n, 30, replace=False):
        s = np.unique(docs[i])
        keep = s[rng.rand(s.size) < rng.uniform(0.3, 1.0)]
        subsets.append(keep if keep.size else s[:1])
    common = [np.array([0, 1]), np.array([0]), np.array([1, 2, 0])]
    return docs, subsets, common


@pytest.fixture(scope="module")
def lake():
    from datasketch_tpu import MinHash as JaxMinHash
    from datasketch_tpu.models.tpu_ensemble import TpuMinHashLSHEnsemble

    docs, subsets, common = _lake()
    pair = [TorchMinHashLSHEnsemble(threshold=0.8, num_perm=128, num_part=8,
                                    max_results=200, device="cpu"),
            TpuMinHashLSHEnsemble(threshold=0.8, num_perm=128, num_part=8, max_results=200)]
    for ix in pair:
        ix.index_tokens(range(len(docs)), docs)

    def batches(queries):
        sizes = np.array([np.unique(q).size for q in queries])
        ours = MinHash.bulk_signatures(queries, num_perm=128, hashfunc="device",
                                       out="device", device="cpu")
        return (ours, sizes), (JaxMinHash.bulk_signatures(queries, num_perm=128,
                                                          hashfunc="device"), sizes)

    return pair, batches(subsets[:15] + common + subsets[15:]), batches(subsets)


@pytest.mark.parametrize("overflow", [True, False])
def test_the_facade_scan_matches_jax(lake, overflow, monkeypatch):
    """``query_batch(method="scan")`` and ``query_stream`` give the JAX
    ensemble's keys in order and its ``last_truncated``, on a batch with
    queries past ``max_results`` (one pass 2 over exactly them) and on one
    with none (no pass 2)."""
    (ours, ref), with_common, subsets = lake
    b_ours, b_ref = with_common if overflow else subsets
    runs = _scans(monkeypatch)
    got = ours.query_batch(b_ours, method="scan")
    want = ref.query_batch(b_ref, method="scan")
    assert got == want and ours.last_truncated == ref.last_truncated
    n_past = sum(len(r) == 200 for r in got)
    assert (ours.last_truncated > 0) == overflow == (n_past > 0)
    assert [q for q, _ in runs] == [len(got)] + ([n_past] if overflow else [])
    assert max(map(len, got)) > 16
    half = [(s[:20], z[:20]) for s, z in (b_ours, b_ref)] + \
        [(s[20:], z[20:]) for s, z in (b_ours, b_ref)]
    stream = list(ours.query_stream([half[0], half[2]], depth=2))
    assert stream == list(ref.query_stream([half[1], half[3]], depth=2))
    assert stream[0] + stream[1] == got


# ------------------------------------------------------------ the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a card of capability >= 9.0 (sm_90a kernels)")
    return torch.device("cuda")


def _rows_agree(keys, n, plain_keys, plain_n, cap):
    """The card's emit rows against the twin's: equal counts; each row
    with at most ``cap`` hits holds the same keys in some order; one past
    it holds ``cap`` distinct keys among its hits."""
    assert torch.equal(n.cpu(), plain_n)
    keys = torch.sort(keys.cpu(), dim=1, descending=True).values
    plain = torch.sort(plain_keys, dim=1, descending=True).values
    for i in range(keys.shape[0]):
        if int(plain_n[i]) <= cap:
            assert torch.equal(keys[i], plain[i]), i
        else:
            row = keys[i]
            assert (row >= 0).all() and row.unique().numel() == cap


@pytest.mark.cuda
@pytest.mark.parametrize("p", [66, 128, 256])
@pytest.mark.parametrize("cutoff", [0.5, 0.8])
def test_the_emit_variant_on_the_card_matches_the_twin(dev, p, cutoff):
    case = _case(p)
    cpu, card = _tensors(case), _tensors(case, dev)
    for cap in (1, 16, CAP):
        before = (lsh_scan.launches_sizes, lsh_scan.launches_hits)
        keys, n = lsh_scan.containment_hits(*card, cutoff, cap)
        torch.cuda.synchronize()
        assert (lsh_scan.launches_sizes, lsh_scan.launches_hits) == (before[0], before[1] + 1)
        _rows_agree(keys, n, *lsh_scan.containment_hits_plain(*cpu, cutoff, cap), cap)
    want = lsh_ops.containment_hits(*cpu, cutoff, CAP)
    for budget in (lsh_ops.RESCAN_BUDGET, 1):
        got = lsh_ops.containment_hits(*card, cutoff, CAP, budget=budget)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 33, 1000])
def test_the_emit_variant_on_the_card_at_many_splits(dev, nq):
    """200,003 rows of 2-valued slots at P 256 (many matches a query, ties)
    and 3-valued ones at P 128, ragged Q: the first 33 queries' rows
    against the twin, and the whole op against the plain running top-k on
    the card."""
    for p, values in ((256, 2), (128, 3)):
        g = torch.Generator(device=dev).manual_seed(nq + p)
        n = 200003
        db = torch.randint(0, values, (n, p), generator=g, device=dev, dtype=torch.int32)
        q = torch.randint(0, values, (nq, p), generator=g, device=dev, dtype=torch.int32)
        sizes = torch.randint(1, 400, (n,), generator=g, device=dev, dtype=torch.int32)
        sizes[: n // 4] = 120
        sizes[::13] = 0
        q_sizes = torch.randint(0, 300, (nq,), generator=g, device=dev, dtype=torch.int32)
        card = (db, sizes, q, q_sizes)
        cutoff = 0.7 if values == 2 else 0.3
        keys, n_match = lsh_scan.containment_hits(*card, cutoff, 256)
        head = [x.cpu() for x in (db, sizes, q[:33], q_sizes[:33])]
        _rows_agree(keys[:33], n_match[:33],
                    *lsh_scan.containment_hits_plain(*head, cutoff, 256), 256)
        got = lsh_ops.containment_hits(*card, cutoff, 256)
        want = lsh_scan.containment_topk_plain(*card, 256, cutoff)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_the_facade_on_the_card_matches_the_cpu(dev):
    """A CUDA ensemble's ``query_batch(method="scan")`` and ``query_stream``
    (depth 1 and 3) equal a CPU one's, with queries past ``max_results``
    in a batch of the stream: its copies bring back the counts only, and
    the rescan and compaction run on the card."""
    docs, subsets, common = _lake()
    pair = [TorchMinHashLSHEnsemble(threshold=0.8, num_perm=128, num_part=8, max_results=200,
                                    device=d) for d in ("cpu", dev)]
    for ix in pair:
        ix.index_tokens(range(len(docs)), docs)
    queries = subsets[:15] + common + subsets[15:]
    sizes = np.array([np.unique(q).size for q in queries])
    sigs = MinHash.bulk_signatures(queries, num_perm=128, hashfunc="device", out="host",
                                   device="cpu")
    want = pair[0].query_batch((sigs, sizes), method="scan")
    assert pair[0].last_truncated > 0
    assert pair[1].query_batch((sigs, sizes), method="scan") == want
    assert pair[1].last_truncated == pair[0].last_truncated
    batches = [(sigs[:20], sizes[:20]), (sigs[20:], sizes[20:]), (sigs[:15], sizes[:15])]
    for depth in (1, 3):
        got = list(pair[1].query_stream(batches, depth=depth))
        assert got == list(pair[0].query_stream(batches, depth=depth))
        assert got[0] + got[1] == want
