"""Port parity: the rest of the TorchMinHashLSH facade (device="cpu", the
kernels' plain versions) against TpuMinHashLSH on the same rows --
cascade_perm, merge, compact, is_empty, warmup, host_snapshot, query_b and
.npz checkpoints written by one package and loaded by the other. Answers,
``last_truncated`` and the arrays inside the files must be equal."""

import numpy as np
import pytest
import torch

from datasketch_tpu.models.tpu_lsh import TpuMinHashLSH
from datasketch_tpu_torch import TorchMinHashLSH

torch.set_num_threads(2)

P = 128


def _rows(n, p, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 32, size=(n, p), dtype=np.uint64).astype(np.uint32)


def _near(rows, keep, seed):
    rng = np.random.RandomState(seed)
    return np.where(rng.rand(*rows.shape) < keep, rows, _rows(rows.shape[0], rows.shape[1],
                                                              seed + 1000))


def _corpus(n, p=P, seed=1):
    """n rows: random, a crowd of near-copies of row 0 (a threshold scan
    then matches > 128 rows, and bands overflow small caps), and 12 rows
    whose first 40 slots are 0 (the zero rows that pad a JAX query batch
    fall into their buckets)."""
    sigs = _rows(n, p, seed)
    sigs[1:161] = _near(np.repeat(sigs[:1], 160, axis=0), 0.9, seed + 1)
    sigs[200:212, :40] = 0
    return sigs


def _queries(sigs, n, seed):
    pick = np.random.RandomState(seed).randint(0, sigs.shape[0], n)
    return _near(sigs[pick], 0.7, seed + 7)


def _pair(sigs, keys=None, **kw):
    keys = list(range(len(sigs))) if keys is None else keys
    ours = TorchMinHashLSH(num_perm=P, device="cpu", **kw)
    ref = TpuMinHashLSH(num_perm=P, **kw)
    ours.index(keys, sigs)
    ref.index(keys, sigs)
    return ours, ref


def _same(pair, call):
    ours, ref = pair
    got, want = call(ours), call(ref)
    assert got == want
    assert ours.last_truncated == ref.last_truncated
    return got


def _all_queries(pair, q):
    for method in ("auto", "bands", "scan"):
        _same(pair, lambda ix: ix.top_k(q, 10, method=method))
        _same(pair, lambda ix: ix.query_batch(q, return_scores=True, method=method))


@pytest.mark.parametrize("n", [1024, 1500])
def test_cascade_perm_matches(n):
    sigs = _corpus(n, p=256, seed=n)
    pair = _pair(sigs, threshold=0.5, cascade_perm=256, bucket_cap=16)
    assert pair[0].in_width == 256 and (pair[0].b, pair[0].r) == (pair[1].b, pair[1].r)
    q = _queries(sigs, 37, n + 3)
    _all_queries(pair, q)
    _same(pair, lambda ix: ix.top_k(q, 200, method="scan"))
    _same(pair, lambda ix: ix.query_batch(sigs[:1], method="scan"))  # escalates
    for b in (1, pair[0].b):
        _same(pair, lambda ix: ix.query_b(q[:5], b))
    for ix in pair:
        with pytest.raises(ValueError, match="length 256"):
            ix.query_batch(q[:, :P])
        with pytest.raises(ValueError, match="length 256"):
            ix.insert("x", sigs[0, :P])
    with pytest.raises(ValueError, match="cascade_perm"):
        TorchMinHashLSH(num_perm=P, cascade_perm=64, device="cpu")


def test_merge_matches_with_tombstones():
    sigs = _corpus(1500, seed=5)
    q = _queries(sigs, 40, 6)
    a = _pair(sigs[:900], threshold=0.5)
    b = _pair(sigs[900:], keys=list(range(900, 1500)), threshold=0.5)
    for ix in a + b:
        for key in (3, 7, 950, 1400):
            if key in ix:
                ix.remove(key)
    b[0].insert("late", sigs[5])  # a pending row of the merged index
    b[1].insert("late", sigs[5])
    a[0].merge(b[0])
    a[1].merge(b[1])
    assert len(a[0]) == len(a[1]) == 1497
    _all_queries(a, q)
    _same(a, lambda ix: ix.query_b(q[:9], 3))
    empty = _pair(sigs[:0], threshold=0.5)  # merging into an empty index
    for e, other in zip(empty, a):
        e.merge(other)
    _all_queries(empty, q)
    with pytest.raises(ValueError, match="overlapping"):
        a[0].merge(b[0], check_overlap=True)
    with pytest.raises(ValueError, match="different initialization"):
        a[0].merge(TorchMinHashLSH(threshold=0.5, num_perm=64, device="cpu"))
    with pytest.raises(ValueError, match="Cannot merge type"):
        a[0].merge(a[1])


def test_compact_is_empty_snapshot_and_warmup():
    sigs = _corpus(1024, seed=9)
    q = _queries(sigs, 24, 10)
    pair = _pair(sigs, threshold=0.5, bucket_cap=8)
    assert not pair[0].is_empty()
    snap = [ix.host_snapshot() for ix in pair]
    assert snap[0]["alive"] is None and snap[1]["alive"] is None
    np.testing.assert_array_equal(snap[0]["sigs"], snap[1]["sigs"])
    assert snap[0]["sigs"].dtype == np.uint32
    for key in range(0, 1024, 3):
        for ix in pair:
            ix.remove(key)
    snap = [ix.host_snapshot() for ix in pair]
    assert snap[0]["keys"] == snap[1]["keys"]
    np.testing.assert_array_equal(snap[0]["alive"], snap[1]["alive"])
    for ix in pair:
        ix.compact()
    assert pair[0].status()["n_tombstoned"] == pair[1].status()["n_tombstoned"] == 0
    snap = [ix.host_snapshot() for ix in pair]
    assert snap[0]["keys"] == snap[1]["keys"] and snap[0]["alive"] is None
    np.testing.assert_array_equal(snap[0]["sigs"], snap[1]["sigs"])
    _all_queries(pair, q)
    for ix in pair:
        ix.warmup(batch_sizes=(8, 5), k=7)
    assert pair[0].last_truncated == pair[1].last_truncated
    for key in list(pair[0]._key_to_pos):
        for ix in pair:
            ix.remove(key)
    assert pair[0].is_empty() and pair[1].is_empty()
    for ix in pair:
        ix.compact()
    assert pair[0].query_b(q[:3], 2) == pair[1].query_b(q[:3], 2) == [set()] * 3
    _same(pair, lambda ix: ix.top_k(q, 5))
    fresh = TorchMinHashLSH(num_perm=P, device="cpu")
    assert fresh.is_empty() and fresh.host_snapshot()["sigs"].shape == (0, P)
    fresh.warmup()  # no-op on an empty index


def test_status_and_queries_on_a_compacted_empty_table():
    """index two keys, remove both, compact: status() answers (0 rows, no
    bucket), and the table still serves and takes inserts like JAX's."""
    sigs = _corpus(1024, seed=13)
    q = _queries(sigs, 6, 14)
    pair = _pair(sigs[:2], threshold=0.5)
    for ix in pair:
        for key in (0, 1):
            ix.remove(key)
        ix.compact()
    got, want = (ix.status() for ix in pair)
    assert (got["n_live"], got["n_tombstoned"]) == (want["n_live"], want["n_tombstoned"]) == (0, 0)
    assert got["max_bucket"] == got["distinct_buckets_min"] == 0
    _same(pair, lambda ix: ix.top_k(q, 3))
    _same(pair, lambda ix: ix.query_batch(q, return_scores=True))
    for ix in pair:
        ix.insert("late", sigs[5])
    _same(pair, lambda ix: ix.top_k(q, 3))
    _same(pair, lambda ix: ix.query_batch(sigs[5:6]))
    assert pair[0].status()["n_live"] == pair[1].status()["n_live"] == 1
    assert pair[0].status()["max_bucket"] == 1


def test_forest_status_on_zero_rows():
    """The forest's public calls never leave a 0-row table, but status()
    guards the bucket count the same way."""
    from datasketch_tpu_torch import TorchMinHashLSHForest
    from datasketch_tpu_torch.ops import forest_ops

    forest = TorchMinHashLSHForest(num_perm=P, device="cpu")
    forest._sigs = torch.zeros((0, P), dtype=torch.int32)
    forest._sorted_fps, forest._sorted_ids = forest_ops.build_forest(
        forest_ops.prefix_fingerprints(forest._sigs, forest.l, forest.k)
    )
    assert forest.status()["max_leaf_run"] == 0
    assert forest.status()["n_indexed"] == 0


@pytest.mark.parametrize("nq", [1, 5, 8, 13])
def test_query_b_matches_including_padding_rows(nq):
    sigs = _corpus(1024, seed=11)
    q = _queries(sigs, nq, 12)
    q[0] = sigs[1]  # a crowd row: its buckets overflow the cap
    pair = _pair(sigs, threshold=0.5, bucket_cap=4)
    for b in range(1, pair[0].b + 1):
        got = _same(pair, lambda ix: ix.query_b(q, b))
        assert all(isinstance(s, set) for s in got)
    assert pair[0].last_truncated > 0
    for key in (0, 1, 200, 201):
        for ix in pair:
            ix.remove(key)
    _same(pair, lambda ix: ix.query_b(q, 2))
    out = pair[0].query_b_dispatch(q, 2)
    assert pair[0].query_b_finish(out) == pair[1].query_b(q, 2)
    with pytest.raises(ValueError, match="number of bands"):
        pair[0].query_b(q, pair[0].b + 1)


def _npz_arrays(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("cascade", [None, 256])
def test_npz_files_load_across_packages(tmp_path, cascade):
    width = cascade or P
    sigs = _corpus(1500, p=width, seed=13)
    q = _queries(sigs, 30, 14)
    keys = [("k", i) for i in range(1500)]
    pair = _pair(sigs, keys=keys, threshold=0.6, bucket_cap=32, cascade_perm=cascade)
    for key in keys[::7]:
        for ix in pair:
            ix.remove(key)
    ours_path, ref_path = str(tmp_path / "ours"), str(tmp_path / "ref")
    pair[0].save(ours_path)
    pair[1].save(ref_path)
    a, b = _npz_arrays(ours_path + ".npz"), _npz_arrays(ref_path + ".npz")
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name])
    loaded = (TorchMinHashLSH.load(ref_path, device="cpu"), TpuMinHashLSH.load(ours_path))
    _all_queries(loaded, q)
    _same(loaded, lambda ix: ix.query_b(q[:6], 2))
    assert loaded[0].in_width == width


def test_empty_save_and_old_meta_load(tmp_path):
    ours = TorchMinHashLSH(threshold=0.5, num_perm=P, device="cpu")
    ours.save(str(tmp_path / "empty"))
    ref = TpuMinHashLSH.load(str(tmp_path / "empty.npz"))
    assert ref.is_empty() and len(ref) == 0
    sigs = _corpus(1024, seed=15)
    ref = TpuMinHashLSH(threshold=0.5, num_perm=P)
    ref.index(range(1024), sigs)
    ref.save(str(tmp_path / "full"))
    data = _npz_arrays(str(tmp_path / "full.npz"))
    data["meta"] = data["meta"][:5]  # a file from before the width field
    np.savez(str(tmp_path / "old"), **data)
    ours = TorchMinHashLSH.load(str(tmp_path / "old.npz"), device="cpu")
    assert ours.in_width == P and ours.cascade_perm is None
    q = _queries(sigs, 16, 16)
    assert ours.top_k(q, 10) == ref.top_k(q, 10)
