"""Port parity: the mesh, the collectives, sharded sketching and unions, and
``ShardedMinHashLSH`` against the JAX package's on its virtual CPU mesh.

Each JAX mesh (the conftest's 8 virtual CPU devices) is paired with a port
mesh of the same shape whose positions share the CPU
(``make_mesh(..., device="cpu")``): 2 x 2, 4 x 2, 8 x 1 and 2 x 4, so the
shard count is 2, 4 or 8. At 100 rows and 8 shards the last shard is
empty, at 700 the last ones are short. Answers, their order, scores,
``last_truncated``, ``status()`` (but for ``n_padded`` and
``device_bytes``) and ``.npz`` files loaded in the other package on
another mesh shape are compared exactly.
"""

import numpy as np
import pytest
import torch

import datasketch_tpu.parallel as J
import datasketch_tpu_torch.parallel as T
from datasketch_tpu import MinHash as JMinHash
from datasketch_tpu import FailoverIndex as JFailover
from datasketch_tpu.ops import minhash_ops as jops
from datasketch_tpu_torch import FailoverIndex, MinHash
from datasketch_tpu_torch.parallel import collectives
from datasketch_tpu_torch.parallel.mesh import Mesh, rows_per_shard, shard_span

torch.set_num_threads(2)

MESHES = {"2x2": (4, None), "4x2": (8, None), "8x1": (8, (8, 1)), "2x4": (8, (2, 4))}
P = 32


def _meshes(name):
    n, shape = MESHES[name]
    return J.make_mesh(n, shape=shape), T.make_mesh(n, shape=shape, device="cpu")


def _corpus(n, seed, dup=0):
    """uint32[n, P]: near-copies in the second half, slots of 0..3 in every
    fifth row (ties), and ``dup`` exact copies of row 0 (bucket overflow)."""
    rng = np.random.RandomState(seed)
    sigs = rng.randint(0, 1 << 32, size=(n, P), dtype=np.uint64).astype(np.uint32)
    half = n // 2
    sigs[half:] = np.where(rng.rand(n - half, P) < 0.6, sigs[: n - half], sigs[half:])
    sigs[::5] = rng.randint(0, 4, size=(len(sigs[::5]), P))
    if dup:
        sigs[10: 10 + dup] = sigs[0]
        sigs[10: 10 + dup, -1] = np.arange(dup)  # one slot apart: one band stays equal
    return sigs


CORPORA = {"100": (100, 1, 0), "700": (700, 2, 300)}
_CACHE = {}


def _built(mesh_name, corpus):
    """(JAX index, port index, sigs) over a corpus, built once per module."""
    key = (mesh_name, corpus)
    if key not in _CACHE:
        jm, tm = _meshes(mesh_name)
        sigs = _corpus(*CORPORA[corpus])
        keys = ["k%d" % i for i in range(sigs.shape[0])]
        j = J.ShardedMinHashLSH(jm, threshold=0.5, num_perm=P, bucket_cap=4)
        t = T.ShardedMinHashLSH(tm, threshold=0.5, num_perm=P, bucket_cap=4)
        j.index(keys, sigs)
        t.index(keys, sigs)
        _CACHE[key] = (j, t, sigs)
    return _CACHE[key]


def _same(j, t, call, *args, **kwargs):
    got = getattr(t, call)(*args, **kwargs)
    want = getattr(j, call)(*args, **kwargs)
    assert got == want, (call, args, kwargs)
    assert t.last_truncated == j.last_truncated, (call, t.last_truncated, j.last_truncated)
    return got


def _status(ix):
    return {k: v for k, v in ix.status().items() if k not in ("n_padded", "device_bytes")}


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("n,axes,shape", [(1, ("data", "model"), None),
                                          (4, ("data", "model"), None),
                                          (6, ("data", "model"), None),
                                          (7, ("data", "model"), None),
                                          (8, ("data", "model"), (2, 4)),
                                          (4, ("data",), None),
                                          (8, ("data", "model", "x"), None)])
def test_make_mesh_layout_matches_jax(n, axes, shape):
    jm = J.make_mesh(n, axis_names=axes, shape=shape)
    tm = T.make_mesh(n, axis_names=axes, shape=shape, device="cpu")
    assert dict(tm.shape) == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.size == n and not tm.is_multiprocess and tm.home == torch.device("cpu")
    for axis in axes:
        assert tm.local_shards(axis) == list(range(tm.shape[axis]))


def test_mesh_errors():
    with pytest.raises(ValueError):
        T.make_mesh(8, shape=(3, 2), device="cpu")
    with pytest.raises(ValueError):
        Mesh([torch.device("cpu")] * 4, ("data", "model"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.make_mesh(4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.make_mesh(4, device="cuda:0")


def test_row_layout_reads_jax_padded_shape():
    # JAX pads to the least power of two >= max(128, n), then to a multiple of S
    for n, s, rows in [(0, 4, 32), (100, 8, 16), (129, 4, 64), (700, 3, 342), (1 << 20, 4,
                                                                               1 << 18)]:
        assert rows_per_shard(n, s) == rows
        spans = [shard_span(n, rows, i) for i in range(s)]
        assert sum(hi - lo for lo, hi in spans) == n
    assert shard_span(100, 16, 7) == (100, 100)  # the empty last shard


def test_collectives_in_one_process():
    mesh = T.make_mesh(8, shape=(4, 2), device="cpu")
    local = {s: torch.full((2, 3), s, dtype=torch.int32) for s in range(4)}
    g = collectives.all_gather_cat(mesh, "data", local, dim=1)
    assert g[0].tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]
    assert int(collectives.psum(mesh, {s: s + 1 for s in range(4)})) == 10
    vals = {s: torch.tensor([s, -s]) for s in range(4)}
    assert collectives.pmin(mesh, vals).tolist() == [0, -3]
    assert collectives.pmax(mesh, vals).tolist() == [3, 0]
    assert [collectives.position_index(mesh, "data", p) for p in range(8)] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    assert [collectives.position_index(mesh, "model", p) for p in range(8)] == [0, 1] * 4


# -------------------------------------------------------- sketching, unions


def _tokens(batch=32, tokens=64, seed=0):
    rng = np.random.RandomState(seed)
    hashes = rng.randint(0, 1 << 32, size=(batch, tokens), dtype=np.uint64).astype(np.uint32)
    lengths = rng.randint(1, tokens + 1, size=(batch,)).astype(np.int32)
    lengths[3] = 0  # an empty document: every slot MAX_HASH
    return hashes, lengths


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_signatures_and_unions_match_jax(mesh_name):
    jm, tm = _meshes(mesh_name)
    hashes, lengths = _tokens(seed=3)
    got = T.sharded_compute_signatures(hashes, lengths, seed=1, num_perm=128, mesh=tm)
    want = J.sharded_compute_signatures(hashes, lengths, seed=1, num_perm=128, mesh=jm)
    assert got.shape == (32, 128)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(jops.compute_signatures(hashes, lengths, 1, 128)))
    union = T.distributed_minhash_union(got, tm).numpy().view(np.uint32)
    np.testing.assert_array_equal(union, np.asarray(J.distributed_minhash_union(want, jm)))
    np.testing.assert_array_equal(union, np.asarray(want).min(axis=0))
    # a full tensor is split over the mesh first
    full = torch.from_numpy(np.asarray(want).view(np.int32).copy())
    assert torch.equal(T.distributed_minhash_union(full, tm), torch.from_numpy(union.view(
        np.int32)))
    regs = np.random.RandomState(7).randint(0, 30, size=(32, 256)).astype(np.int8)
    merged = T.distributed_hll_union(torch.from_numpy(regs), tm)
    assert merged.dtype == torch.int8
    np.testing.assert_array_equal(merged.numpy(),
                                  np.asarray(J.distributed_hll_union(regs, jm)))


def test_sharded_signatures_refuse_uneven_splits():
    tm = T.make_mesh(8, device="cpu")  # 4 x 2
    hashes, lengths = _tokens(batch=30)
    with pytest.raises(ValueError, match="data axis"):
        T.sharded_compute_signatures(hashes, lengths, seed=1, num_perm=128, mesh=tm)
    hashes, lengths = _tokens(batch=32)
    with pytest.raises(ValueError, match="model axis"):
        T.sharded_compute_signatures(hashes, lengths, seed=1, num_perm=127, mesh=tm)


# ------------------------------------------------------------ ShardedMinHashLSH


@pytest.mark.parametrize("corpus", list(CORPORA))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_lsh_answers_match_jax(mesh_name, corpus):
    j, t, sigs = _built(mesh_name, corpus)
    q = sigs[[0, 1, 5, 10, 11, 60, 70, 99]]
    for method in ("bands", "scan", "auto"):
        for k in (5, 150):
            _same(j, t, "top_k", q, k, method=method)
        _same(j, t, "query_batch", q, method=method, return_scores=True)
        _same(j, t, "query_batch", q, threshold=0.3, method=method)
    _same(j, t, "query_batch", q, method="bands", rerank=False, return_scores=True)
    _same(j, t, "top_k", q, 5, method="bands")
    if corpus == "700":  # 300 near-copies of row 0: per-shard bucket overflow
        assert t.last_truncated > 0
    assert _status(t) == _status(j)
    assert t.status()["n_padded"] == 0


@pytest.mark.parametrize("mesh_name", ["4x2", "8x1"])
def test_lsh_removals_compact_merge_and_reindex(mesh_name):
    jm, tm = _meshes(mesh_name)
    sigs = _corpus(700, 5, dup=200)
    keys = ["k%d" % i for i in range(700)]
    j = J.ShardedMinHashLSH(jm, threshold=0.5, num_perm=P, bucket_cap=8, max_results=50)
    t = T.ShardedMinHashLSH(tm, threshold=0.5, num_perm=P, bucket_cap=8, max_results=50)
    for ix in (j, t):
        ix.index(keys[:300], sigs[:300])
        ix.index(keys[300:], sigs[300:])  # incremental: re-sharded
        for key in keys[::7]:
            ix.remove(key)
    q = sigs[:16]
    for method in ("bands", "scan"):
        _same(j, t, "top_k", q, 10, method=method)
        _same(j, t, "query_batch", q, method=method, return_scores=True)
    assert _status(t) == _status(j)
    with pytest.raises(ValueError):
        t.remove("k0")
    for ix in (j, t):
        ix.compact()
    assert len(t) == len(j) and _status(t) == _status(j)
    _same(j, t, "top_k", q, 10, method="bands")
    other = _corpus(120, 9)
    ok = ["o%d" % i for i in range(120)]
    jo = J.ShardedMinHashLSH(jm, threshold=0.5, num_perm=P, bucket_cap=8)
    to = T.ShardedMinHashLSH(tm, threshold=0.5, num_perm=P, bucket_cap=8)
    for ix in (jo, to):
        ix.index(ok, other)
        ix.remove("o3")
    j.merge(jo)
    t.merge(to)
    assert "o3" not in t and "o4" in t and len(t) == len(j)
    q2 = np.concatenate([q, other[:8]])
    for method in ("bands", "scan"):
        _same(j, t, "top_k", q2, 10, method=method)
        _same(j, t, "query_batch", q2, method=method)
    assert _status(t) == _status(j)
    with pytest.raises(ValueError):
        t.merge(T.ShardedMinHashLSH(tm, threshold=0.5, num_perm=64))
    with pytest.raises(ValueError, match="overlapping"):
        t.merge(to, check_overlap=True)


def test_lsh_merges_an_unsharded_index():
    from datasketch_tpu_torch import TorchMinHashLSH

    tm = T.make_mesh(8, device="cpu")
    sigs = _corpus(300, 11)
    t = T.ShardedMinHashLSH(tm, threshold=0.5, num_perm=P, bucket_cap=8)
    t.index(["a%d" % i for i in range(200)], sigs[:200])
    single = TorchMinHashLSH(threshold=0.5, num_perm=P, bucket_cap=8, device="cpu")
    single.index(["b%d" % i for i in range(100)], sigs[200:])
    single.insert("b-late", sigs[250])  # buffered: flushed by the merge
    single.remove("b7")
    t.merge(single)
    whole = T.ShardedMinHashLSH(tm, threshold=0.5, num_perm=P, bucket_cap=8)
    whole.index(["a%d" % i for i in range(200)] + ["b%d" % i for i in range(100)] +
                ["b-late"], np.concatenate([sigs, sigs[250:251]]))
    whole.remove("b7")
    assert t.top_k(sigs[195:215], 5) == whole.top_k(sigs[195:215], 5)
    assert len(t) == 300


@pytest.mark.parametrize("src,dst", [("4x2", "2x4"), ("8x1", "2x2"), ("2x2", "8x1")])
def test_lsh_checkpoints_load_both_ways_and_reshard(tmp_path, src, dst):
    j, t, sigs = _built(src, "700")
    jd, td = _meshes(dst)
    q = sigs[:12]
    for ix in (j, t):
        ix.remove("k3") if "k3" in ix else None
    j.save(str(tmp_path / "jax"))
    t.save(str(tmp_path / "port"))
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name])
    from_jax = T.ShardedMinHashLSH.load(str(tmp_path / "jax.npz"), td)
    from_port = J.ShardedMinHashLSH.load(str(tmp_path / "port.npz"), jd)
    assert from_jax.n_shards == td.shape["data"] and "k3" not in from_jax
    for method in ("bands", "scan"):
        _same(from_port, from_jax, "top_k", q, 7, method=method)
        _same(from_port, from_jax, "query_batch", q, method=method, return_scores=True)
    assert _status(from_jax) == _status(from_port)


def test_lsh_streams_match_batches():
    j, t, sigs = _built("4x2", "700")
    q = sigs[20:44]
    batches = [q[:8], q[8:16], q[16:]]
    want = [t.top_k(b, 6) for b in batches]
    assert list(t.top_k_stream(batches, 6, depth=2)) == want
    assert list(t.top_k_stream(batches, 6, method="bands", depth=3)) == \
        list(j.top_k_stream(batches, 6, method="bands", depth=3))
    assert [t.top_k(b, 6, return_scores=False) for b in batches] == \
        list(t.top_k_stream(batches, 6, return_scores=False))


def test_lsh_token_front_ends_match_jax():
    jm, tm = _meshes("4x2")
    rng = np.random.RandomState(9)
    docs = [rng.randint(0, 1 << 31, 60).astype(np.uint32) for _ in range(40)]
    queries = [np.concatenate([d[:50], rng.randint(0, 1 << 31, 10).astype(np.uint32)])
               for d in docs[:6]]
    j = J.ShardedMinHashLSH(jm, threshold=0.5, num_perm=64, bucket_cap=8)
    t = T.ShardedMinHashLSH(tm, threshold=0.5, num_perm=64, bucket_cap=8)
    keys = ["t%d" % i for i in range(40)]
    j.index_tokens(keys, docs)
    t.index_tokens(keys, docs)
    _same(j, t, "query_tokens", queries, return_scores=True)
    _same(j, t, "top_k_tokens", queries, 3)
    assert t.top_k_tokens(queries, 3)[0][0][0] == "t0"


def test_lsh_empty_index_errors_and_warmup():
    tm = T.make_mesh(8, shape=(8, 1), device="cpu")
    t = T.ShardedMinHashLSH(tm, threshold=0.5, num_perm=P)
    assert t.is_empty() and t.top_k(_corpus(3, 1), 2) == [[], [], []]
    assert t.query_batch(_corpus(2, 1)) == [[], []]
    t.warmup()  # no-op while empty
    st = t.status()
    assert st["n_shards"] == 8 and st["rows_per_shard"] == 0 and st["max_bucket"] == 0
    with pytest.raises(ValueError):
        T.ShardedMinHashLSH(tm, threshold=1.5)
    with pytest.raises(ValueError):
        T.ShardedMinHashLSH(tm, params=(10, 10), num_perm=P)
    sigs = _corpus(10, 2)
    t.index(["a%d" % i for i in range(10)], sigs)
    with pytest.raises(ValueError, match="already exists"):
        t.index(["a1"], sigs[:1])
    with pytest.raises(ValueError, match="length"):
        t.index(["z"], np.zeros((1, 16), np.uint32))
    with pytest.raises(ValueError):
        t.top_k(sigs, 3, method="nope")
    with pytest.raises(ValueError, match="rerank"):
        t.query_batch(sigs, method="scan", rerank=False)
    t.warmup(batch_sizes=(4,))
    # 10 rows over 8 shards of 16: shard 0 holds them all, shards 1-7 are empty
    assert t.top_k(sigs[:2], 1) == [[("a0", 1.0)], [("a1", 1.0)]]
    assert t.query(sigs[4])[0] == "a4" and "a4" in t and len(t) == 10


# ------------------------------------------------------------- failover


class _Fixed:
    """A monitor whose outcomes are scripted instead of probing a device."""

    def __init__(self, base, outcomes):
        self.__class__ = type("Scripted", (base,), {"check": _Fixed._check})
        base.__init__(self, max_failures=1)
        self._outcomes = list(outcomes)

    def _check(self):
        ok = self._outcomes.pop(0) if self._outcomes else True
        self.consecutive_failures = 0 if ok else self.consecutive_failures + 1
        return {"ok": ok, "latency_s": 0.001 if ok else None, "error": None if ok else "x"}


def test_failover_wraps_sharded_index_scripted_monitor():
    """tests/test_serving.py's first ``test_failover_wraps_sharded_index``
    (pytest runs only the second of two tests with one name there): the
    device path while healthy, the exact host scan once the monitor
    trips, tombstones respected."""
    from datasketch_tpu.utils.health import HealthMonitor as JMonitor
    from datasketch_tpu_torch.utils.health import HealthMonitor

    rng = np.random.RandomState(31)
    raw = rng.randint(0, 1 << 32, size=(24, 32), dtype=np.uint64)
    rows = {}
    for pkg, mesh, cls, fo_cls, mon in (
            ("jax", J.make_mesh(8), J.ShardedMinHashLSH, JFailover, JMonitor),
            ("port", T.make_mesh(8, device="cpu"), T.ShardedMinHashLSH, FailoverIndex,
             HealthMonitor)):
        index = cls(mesh, threshold=0.3, num_perm=32, bucket_cap=64)
        index.index(["doc%d" % i for i in range(24)], raw.astype(np.uint32))
        index.remove("doc5")
        fo = fo_cls(index, monitor=_Fixed(mon, [True]))
        fo.check()
        dev = fo.top_k(raw[:3].astype(np.uint32), k=3)
        assert fo.last_path == "device" and dev[0][0][0] == "doc0"
        fo.monitor._outcomes = [False]
        fo.check()
        host = fo.top_k(raw[:3].astype(np.uint32), k=3)
        assert fo.last_path == "host"
        assert [r[0][0] for r in host] == ["doc0", "doc1", "doc2"]
        top5 = fo.top_k(raw[5:6].astype(np.uint32), k=3)[0]
        assert all(kk != "doc5" for kk, _ in top5)
        rows[pkg] = (dev, host, top5, fo.query_batch(raw[:4].astype(np.uint32),
                                                     return_scores=True))
    assert rows["port"] == rows["jax"]


def test_failover_wraps_sharded_index_tripped_monitor():
    """tests/test_serving.py's second ``test_failover_wraps_sharded_index``:
    a 4-position mesh, ``HealthMonitor(max_failures=1)`` tripped by hand;
    host answers agree with the device's, threshold answers hold."""
    from datasketch_tpu_torch.utils.health import HealthMonitor

    rng = np.random.RandomState(31)
    docs = [rng.choice(20000, 100, replace=False).astype(np.uint32) for _ in range(48)]
    sigs = MinHash.bulk_signatures(docs, num_perm=128, hashfunc="device", device="cpu")
    mesh = Mesh([torch.device("cpu")] * 4, ("data",))
    index = T.ShardedMinHashLSH(mesh, threshold=0.5, num_perm=128, bucket_cap=32)
    index.index(list(range(48)), sigs)
    fo = FailoverIndex(index, monitor=HealthMonitor(max_failures=1))
    queries = [MinHash(hashvalues=r, hashfunc="device") for r in sigs[:4]]
    dev_rows = fo.top_k(queries, k=3)
    assert fo.last_path == "device"
    fo.monitor.consecutive_failures = 99
    host_rows = fo.top_k(queries, k=3)
    assert fo.last_path == "host"
    for d, h in zip(dev_rows, host_rows):
        assert d[0][0] == h[0][0]
    thr = fo.query_batch(queries)
    assert all(i in row for i, row in enumerate(thr))
    # the JAX package's sharded index answers the device path the same
    jidx = J.ShardedMinHashLSH(J.make_mesh(4, axis_names=("data",)), threshold=0.5,
                               num_perm=128, bucket_cap=32)
    jidx.index(list(range(48)), sigs)
    assert jidx.top_k([JMinHash(hashvalues=r, hashfunc="device") for r in sigs[:4]],
                      k=3) == dev_rows
