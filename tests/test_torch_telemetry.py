"""The port's spans and counters (``utils/profiling.py``): under a CPU
``torch.profiler`` the serving and sketching paths record their
``dstt.<layer>.<step>`` spans, nested as the layers are; with no profiler
running nothing is recorded and no counter moves; the counters equal the
bytes copied back and the answers returned."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from datasketch_tpu_torch import MinHash, TorchMinHashLSH
from datasketch_tpu_torch.models import torch_lsh
from datasketch_tpu_torch.utils import profiling

torch.set_num_threads(2)

P = 128

SERVE = {
    "scan": {"dstt.upload.queries", "dstt.kernel.lsh_scan", "dstt.upload.fetch",
             "dstt.facade.decode"},
    "bands": {"dstt.upload.queries", "dstt.glue.probe", "dstt.kernel.rerank",
              "dstt.glue.select", "dstt.upload.fetch", "dstt.facade.decode"},
}
# a threshold query compacts its answers on the device by either method
COMPACT = {"dstt.kernel.compact"}
SKETCH = {"dstt.facade.bulk_signatures", "dstt.facade.order", "dstt.front.tokens",
          "dstt.front.sha1", "dstt.kernel.sha1", "dstt.upload.chunk", "dstt.glue.sign",
          "dstt.kernel.minhash_sign", "dstt.facade.scatter"}


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 32, size=(n, P), dtype=np.uint64).astype(np.uint32)


@pytest.fixture(scope="module")
def index():
    """1,000 rows; queries are 24 near-copies of stored rows and 8
    unrelated rows, so every path has answers to decode."""
    sigs = _rows(1000, 1)
    src = np.random.RandomState(2).randint(0, 1000, 24)
    near = np.where(np.random.RandomState(3).rand(24, P) < 0.8, sigs[src], _rows(24, 4))
    ix = TorchMinHashLSH(threshold=0.5, num_perm=P, bucket_cap=16, device="cpu")
    ix.index(range(1000), sigs)
    return ix, np.concatenate([near, _rows(8, 5)])


def _serve(ix, queries, op, method):
    if op == "top_k":
        return ix.top_k(queries, 5, method=method)
    return ix.query_batch(queries, return_scores=True, method=method)


def _spans(prof):
    """[(name, start, end)] of the ``dstt.`` host spans a profile holds."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("dstt.")]


def _inside(spans, child, parent) -> bool:
    """Every ``child`` span lies inside some ``parent`` span."""
    outer = [(s, t) for n, s, t in spans if n == parent]
    inner = [(s, t) for n, s, t in spans if n == child]
    return bool(inner) and all(any(ps <= s and t <= pt for ps, pt in outer)
                               for s, t in inner)


@pytest.mark.parametrize("op", ["top_k", "query_batch"])
@pytest.mark.parametrize("method", ["scan", "bands"])
def test_serving_records_its_spans_inside_the_facade_call(index, op, method):
    ix, queries = index
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(ix, queries, op, method)
    spans = _spans(prof)
    facade = "dstt.facade." + op
    compact = COMPACT if op == "query_batch" else set()
    assert {n for n, _, _ in spans} == SERVE[method] | compact | {facade}
    assert [n for n, _, _ in spans].count(facade) == 1
    for name in SERVE[method]:
        assert _inside(spans, name, facade), name
    if method == "bands":
        for name in ("dstt.kernel.rerank", "dstt.glue.select", "dstt.upload.fetch"):
            assert not _inside(spans, name, "dstt.glue.probe"), name


def test_a_tombstoned_index_probes_under_the_same_span(index):
    ix, queries = index
    small = TorchMinHashLSH(threshold=0.5, num_perm=P, bucket_cap=16, device="cpu")
    small.index(range(200), _rows(200, 6))
    small.remove(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        small.query_batch(queries, return_scores=True, method="bands")
    spans = _spans(prof)
    assert {n for n, _, _ in spans} == SERVE["bands"] | COMPACT | {"dstt.facade.query_batch"}
    assert _inside(spans, "dstt.glue.probe", "dstt.facade.query_batch")


def test_streams_record_the_batch_spans(index):
    ix, queries = index
    batches = [queries[:16], queries[16:]]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        list(ix.top_k_stream(batches, 5, method="scan"))
        list(ix.query_stream(batches, return_scores=True, method="bands"))
    names = [n for n, _, _ in _spans(prof)]
    assert set(names) == SERVE["scan"] | SERVE["bands"] | COMPACT
    assert names.count("dstt.facade.decode") == 4


def _docs(n, seed):
    rng = np.random.default_rng(seed)
    return [[b"w%05d" % t for t in rng.integers(0, 5000, rng.integers(1, 60))]
            for _ in range(n)]


def test_sketching_records_its_spans_in_layer_order():
    docs = _docs(300, 7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = MinHash.bulk_signatures(docs, device="cpu", out="device")
    spans = _spans(prof)
    assert {n for n, _, _ in spans} == SKETCH
    assert [n for n, _, _ in spans].count("dstt.facade.bulk_signatures") == 1
    nesting = [("dstt.front.sha1", "dstt.front.tokens"),
               ("dstt.front.tokens", "dstt.facade.bulk_signatures"),
               ("dstt.kernel.sha1", "dstt.facade.bulk_signatures"),
               ("dstt.kernel.minhash_sign", "dstt.glue.sign"),
               ("dstt.glue.sign", "dstt.facade.bulk_signatures"),
               ("dstt.facade.order", "dstt.facade.bulk_signatures"),
               ("dstt.upload.chunk", "dstt.facade.bulk_signatures"),
               ("dstt.facade.scatter", "dstt.facade.bulk_signatures")]
    for child, parent in nesting:
        assert _inside(spans, child, parent), (child, parent)
    assert not _inside(spans, "dstt.upload.chunk", "dstt.front.tokens")
    assert not _inside(spans, "dstt.kernel.sha1", "dstt.front.tokens")
    assert torch.equal(got, MinHash.bulk_signatures(docs, device="cpu", out="device"))


def test_nothing_records_without_a_profiler(index, monkeypatch):
    ix, queries = index
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: made.append(name))
    before = profiling.counters()
    for op in ("top_k", "query_batch"):
        for method in ("scan", "bands"):
            _serve(ix, queries, op, method)
    MinHash.bulk_signatures(_docs(50, 8), device="cpu")
    assert made == []
    assert profiling.counters() == before
    assert profiling.span("dstt.facade.top_k") is profiling.span("dstt.glue.probe")


@pytest.mark.parametrize("op", ["top_k", "query_batch"])
@pytest.mark.parametrize("method", ["scan", "bands"])
def test_counters_equal_the_bytes_fetched_and_the_answers(index, op, method, monkeypatch):
    ix, queries = index
    copied = []
    real = torch_lsh._host

    def host(x):
        if isinstance(x, torch.Tensor):
            copied.append(x)
        return real(x)

    monkeypatch.setattr(torch_lsh, "_host", host)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = _serve(ix, queries, op, method)
    got = profiling.counters()
    profiling.reset_counters()
    assert got["upload.fetch_bytes"] == sum(x.numel() * x.element_size() for x in copied)
    answers = sum(map(len, out))
    assert answers > 0 and got["facade.answers"] == answers
    if op == "top_k":  # the id slots: [Q, k]
        ids = [x for x in copied if x.dim() == 2 and x.dtype == torch.int32]
        assert got["facade.fetched_slots"] == sum(x.numel() for x in ids) >= answers
    else:  # only the answers' ids, compacted on the device: a used share of 100 %
        ids = [x for x in copied if x.dim() == 1 and x.dtype == torch.int32]
        assert got["facade.fetched_slots"] == sum(x.numel() for x in ids) == answers


def test_counters_are_a_copy_and_reset():
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("x.y", 3)
        profiling.count("x.y")
    got = profiling.counters()
    got["x.y"] = 0
    assert profiling.counters() == {"x.y": 4}
    profiling.reset_counters()
    assert profiling.counters() == {}


# ------------------------------------------------ the ensemble's scan path

ENSEMBLE_SCAN = {"dstt.facade.query_batch", "dstt.upload.queries", "dstt.kernel.lsh_scan",
                 "dstt.glue.select_hits", "dstt.upload.fetch", "dstt.facade.rerun",
                 "dstt.kernel.compact", "dstt.facade.decode"}


@pytest.fixture(scope="module")
def ensemble():
    """300 sets of uniform ids and 150 copies of one core set, with
    ``max_results`` 140: a batch that asks the core twice rescans those 2
    queries (150 matches each) and has 2 x 10 matches cut; one of subset
    queries alone rescans none."""
    from datasketch_tpu_torch import TorchMinHashLSHEnsemble

    rng = np.random.RandomState(9)
    core = rng.choice(4000, 14, replace=False)
    docs = [rng.randint(0, 4000, rng.randint(8, 60)) for _ in range(300)] + [core] * 150
    ix = TorchMinHashLSHEnsemble(threshold=0.8, num_perm=P, num_part=4, max_results=140,
                                 device="cpu")
    ix.index_tokens(range(len(docs)), docs)
    subsets = [np.unique(d)[: max(1, len(np.unique(d)) // 2)] for d in docs[:12]]

    def batch(queries):
        sigs = MinHash.bulk_signatures(queries, num_perm=P, hashfunc="device", device="cpu",
                                       out="host")
        return sigs, np.array([len(np.unique(q)) for q in queries])

    return ix, batch(subsets + [core, core]), batch(subsets)


def _scan_calls(monkeypatch):
    """Count the emit-variant scans a batch runs: (queries, row capacity,
    match counts) of each."""
    from datasketch_tpu_torch.kernels import lsh_scan

    real, runs = lsh_scan.containment_hits, []

    def counted(db, sizes, q, q_sizes, cutoff, cap):
        out = real(db, sizes, q, q_sizes, cutoff, cap)
        runs.append((q.shape[0], cap, out[1]))
        return out

    monkeypatch.setattr(lsh_scan, "containment_hits", counted)
    return runs


def _within(span_, outer) -> bool:
    return any(ps <= span_[0] and span_[1] <= pt for ps, pt in outer)


@pytest.mark.parametrize("reruns", [2, 0])
def test_ensemble_scan_records_its_spans_inside_the_facade_call(ensemble, reruns, monkeypatch):
    """``reruns``: the batch's queries past the cap, which one pass 2
    scans again."""
    ix, rerun_batch, first_pass = ensemble
    batch = rerun_batch if reruns else first_pass
    runs = _scan_calls(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ix.query_batch(batch, method="scan")
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    assert [r[0] for r in runs] == [len(batch[1])] + ([reruns] if reruns else [])
    if reruns:
        assert set(names) == ENSEMBLE_SCAN
    else:
        assert set(names) == ENSEMBLE_SCAN - {"dstt.facade.rerun"}
    assert names.count("dstt.facade.query_batch") == names.count("dstt.upload.queries") == 1
    assert names.count("dstt.upload.fetch") == 2  # the match counts, then the answers
    assert names.count("dstt.facade.rerun") == int(bool(reruns))
    assert names.count("dstt.kernel.lsh_scan") == len(runs)
    # the first pass's row sort, the rescan's top-k, the answers' compaction
    assert names.count("dstt.glue.select_hits") == 2 + int(bool(reruns))
    for name in ENSEMBLE_SCAN - {"dstt.facade.query_batch"}:
        if name in names:
            assert _inside(spans, name, "dstt.facade.query_batch"), name
    for child, parent in [("dstt.kernel.compact", "dstt.glue.select_hits")]:
        assert _inside(spans, child, parent), (child, parent)
    of = {name: [(s, t) for n, s, t in spans if n == name] for name in set(names)}
    rerun, counts = of.get("dstt.facade.rerun", []), of["dstt.upload.fetch"][0]
    kernel, select = of["dstt.kernel.lsh_scan"], of["dstt.glue.select_hits"]
    # pass 1 and its sort, before the count fetch
    assert kernel[0][1] <= select[0][0] and select[0][1] <= counts[0]
    assert all(_within(s, rerun) for s in kernel[1:] + select[1:-1])  # pass 2 and its top-k
    # the compaction, after both
    assert select[-1][0] >= counts[1] and not _within(select[-1], rerun)
    assert not _inside(spans, "dstt.facade.decode", "dstt.facade.rerun")


def test_ensemble_counters_equal_the_passes_matches_and_bytes(ensemble, monkeypatch):
    from datasketch_tpu_torch.models import torch_ensemble

    ix, rerun_batch, _ = ensemble
    runs = _scan_calls(monkeypatch)
    copied = []
    real = torch_lsh._host

    def host(x):
        if isinstance(x, torch.Tensor):
            copied.append(x)
        return real(x)

    monkeypatch.setattr(torch_lsh, "_host", host)
    assert torch_ensemble._fetch is torch_lsh._fetch
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = ix.query_batch(rerun_batch, method="scan")
    got = profiling.counters()
    profiling.reset_counters()
    nq = len(rerun_batch[1])
    n_match = runs[0][2].long()
    over = (n_match > 140).nonzero().flatten()
    # pass 1 over the batch at the cap; one pass 2 over exactly the queries
    # past it, each in a row as wide as the largest count among them
    assert got["ensemble.passes"] == len(runs) == 2
    assert [r[:2] for r in runs] == [(nq, 140), (2, int(n_match.max()))]
    assert got["ensemble.rescanned"] == over.numel() == 2
    assert torch.equal(runs[1][2].long(), n_match[over])
    assert got["ensemble.matches"] == int(n_match.sum()) > 300
    assert ix.last_truncated == 20
    assert got["facade.answers"] == sum(map(len, out)) == int(n_match.clamp_max(140).sum())
    assert got["upload.fetch_bytes"] == sum(x.numel() * x.element_size() for x in copied)
    # the match counts, then the answers' row ids alone
    assert [(x.dtype, x.numel()) for x in copied] == [(torch.int32, nq),
                                                       (torch.int32, got["facade.answers"])]


def test_ensemble_rescanned_is_counted_in_every_batch(ensemble, monkeypatch):
    """A batch with no query past the cap counts 0 rescanned queries and
    runs one pass; off the profiler no counter moves."""
    ix, _, first_pass = ensemble
    runs = _scan_calls(monkeypatch)
    profiling.reset_counters()
    ix.query_batch(first_pass, method="scan")
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        ix.query_batch(first_pass, method="scan")
    got = profiling.counters()
    profiling.reset_counters()
    assert len(runs) == 2 and got["ensemble.rescanned"] == 0
    assert got["ensemble.passes"] == 1 and ix.last_truncated == 0


def test_ensemble_spans_off_record_nothing_and_cost_under_10us_a_call(ensemble, monkeypatch):
    import timeit

    from datasketch_tpu_torch.kernels import lsh_scan
    from datasketch_tpu_torch.models import torch_ensemble

    ix, rerun_batch, _ = ensemble
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: made.append(name))
    calls = {"span": 0, "count": 0, "recording": 0}

    def counting(mod, name):
        real = getattr(mod, name)

        def wrapper(*args):
            calls[name] += 1
            return real(*args)

        monkeypatch.setattr(mod, name, wrapper)

    for mod, names in ((torch_ensemble, ("span", "count", "recording")),
                       (torch_lsh, ("span", "count")), (lsh_scan, ("span",))):
        for name in names:
            counting(mod, name)
    before = profiling.counters()
    ix.query_batch(rerun_batch, method="scan")
    assert made == [] and profiling.counters() == before
    assert calls["recording"] == 1 and calls["span"] > 0

    def off_span():
        with profiling.span("dstt.facade.rerun"):
            pass

    reps = 20000
    cost = {"span": timeit.timeit(off_span, number=reps) / reps,
            "count": timeit.timeit(lambda: profiling.count("ensemble.passes"),
                                   number=reps) / reps,
            "recording": timeit.timeit(profiling.recording, number=reps) / reps}
    assert sum(calls[k] * cost[k] for k in calls) < 10e-6, (calls, cost)


# ------------------------------------------------------- the b-bit scan path

BBIT = {"dstt.facade.query_batch", "dstt.upload.queries", "dstt.glue.pack", "dstt.kernel.bbit",
        "dstt.glue.fold_topk", "dstt.upload.fetch", "dstt.facade.decode"}


@pytest.fixture(scope="module")
def bbit_index():
    """1,000 rows at b 1; 32 queries, 24 of them near-copies of stored
    rows."""
    from datasketch_tpu_torch import TorchBBitIndex

    ix = TorchBBitIndex(b=1, num_perm=P, device="cpu")
    sigs = _rows(1000, 11)
    ix.insert_batch(range(1000), sigs)
    src = np.random.RandomState(12).randint(0, 1000, 24)
    near = np.where(np.random.RandomState(13).rand(24, P) < 0.8, sigs[src], _rows(24, 14))
    return ix, np.concatenate([near, _rows(8, 15)])


@pytest.mark.parametrize("tile", [None, 300])
def test_bbit_batch_records_its_spans_tiles_and_fetched_bytes(bbit_index, tile, monkeypatch):
    """Each tile of the scan is one ``bbit.tiles`` and one fold span; the
    fetch counts the [Q, k] ids and counts copied back."""
    from datasketch_tpu_torch.ops import bbit_ops

    ix, queries = bbit_index
    if tile is not None:
        monkeypatch.setattr(bbit_ops, "_scan_tile", lambda nq: tile)
    steps = -(-1000 // (tile or bbit_ops._scan_tile(len(queries))))
    copied = []
    real = torch_lsh._host

    def host(x):
        if isinstance(x, torch.Tensor):
            copied.append(x)
        return real(x)

    monkeypatch.setattr(torch_lsh, "_host", host)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = ix.query_batch(queries, 5, return_scores=True)
    got = profiling.counters()
    profiling.reset_counters()
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    assert set(names) == BBIT
    assert names.count("dstt.facade.query_batch") == 1
    assert names.count("dstt.glue.fold_topk") == names.count("dstt.kernel.bbit") == steps
    for name in BBIT - {"dstt.facade.query_batch"}:
        assert _inside(spans, name, "dstt.facade.query_batch"), name
    assert not _inside(spans, "dstt.kernel.bbit", "dstt.glue.fold_topk")
    assert got["bbit.tiles"] == steps
    assert [(x.dtype, tuple(x.shape)) for x in copied] == [(torch.int32, (32, 5))] * 2
    assert got["upload.fetch_bytes"] == 2 * 32 * 5 * 4
    assert got["facade.answers"] == sum(map(len, out)) == 32 * 5


def test_bbit_records_nothing_without_a_profiler(bbit_index, monkeypatch):
    ix, queries = bbit_index
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a: made.append(name))
    before = profiling.counters()
    out = ix.query_batch(queries, 5, return_scores=True)
    assert list(ix.query_stream([queries[:16], queries[16:]], 5, return_scores=True)) == [
        out[:16], out[16:]]
    assert made == [] and profiling.counters() == before
