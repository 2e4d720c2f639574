"""Port parity: TorchBBitIndex (device="cpu", kernel 5's plain twin) against
TpuBBitIndex, and bBitMinHash against the JAX package's. Answers must be
equal: keys, order and float64 scores; index files load in both classes."""

import pickle

import numpy as np
import pytest
import torch

from datasketch_tpu import TpuBBitIndex
from datasketch_tpu import bBitMinHash as JaxBBit
from datasketch_tpu_torch import TorchBBitIndex, bBitMinHash

torch.set_num_threads(2)


class _MH:
    """MinHash stand-in (hashvalues + seed), as the JAX package's tests use."""

    def __init__(self, hashvalues, seed=1):
        self.hashvalues = np.asarray(hashvalues, dtype=np.uint64)
        self.seed = seed


def _rows(rng, n, p, low_bits=0):
    x = rng.randint(0, 1 << 32, size=(n, p), dtype=np.uint64)
    if low_bits:
        x &= np.uint64((1 << low_bits) - 1)
    return x.astype(np.uint32)


@pytest.fixture(scope="module")
def data():
    """400 rows (100 near-copies of earlier rows), 30 queries (near-copies
    of indexed rows)."""
    rng = np.random.RandomState(4)
    db = _rows(rng, 400, 100)
    src = rng.randint(0, 300, 100)
    db[300:] = np.where(rng.rand(100, 100) < 0.7, db[src], db[300:])
    q = np.where(rng.rand(30, 100) < 0.6, db[rng.randint(0, 400, 30)], _rows(rng, 30, 100))
    return db, q


def _pair(b, db, num_perm=100, keys=None, **kw):
    keys = ["k%d" % i for i in range(len(db))] if keys is None else keys
    ours = TorchBBitIndex(b=b, num_perm=num_perm, device="cpu", **kw)
    ref = TpuBBitIndex(b=b, num_perm=num_perm, **kw)
    ours.insert_batch(keys, db)
    ref.insert_batch(keys, db)
    return ours, ref


def _same(ours, ref, call):
    got, want = call(ours), call(ref)
    assert got == want
    return got


@pytest.mark.parametrize("b", [1, 2, 4, 16, 32])
@pytest.mark.parametrize("r", [0.0, 0.4])
def test_query_batch_matches(data, b, r):
    db, q = data
    ours, ref = _pair(b, db, r=r)
    for k in (1, 10, 37):
        _same(ours, ref, lambda ix: ix.query_batch(q, k))
        rows = _same(ours, ref, lambda ix: ix.query_batch(q, k, return_scores=True))
        assert all(isinstance(s, float) for row in rows for _, s in row)
    _same(ours, ref, lambda ix: ix.query(q[3], 5))
    _same(ours, ref, lambda ix: ix.query_batch(q, 500))  # k above the row count


def test_low_cardinality_ties_and_wider_rows():
    """Two-valued low bits at b = 1: nearly every top-k boundary is a tie,
    broken by insertion order; a signature wider than num_perm is cut."""
    rng = np.random.RandomState(8)
    db = _rows(rng, 500, 130, low_bits=1)
    q = _rows(rng, 20, 130, low_bits=1)
    ours, ref = _pair(1, db, num_perm=128)
    for k in (5, 64):
        _same(ours, ref, lambda ix: ix.query_batch(q, k, return_scores=True))


def test_remove_compact_status_match(data):
    db, q = data
    ours, ref = _pair(4, db)
    for i in range(0, 400, 7):
        ours.remove("k%d" % i)
        ref.remove("k%d" % i)
    ours.remove_batch(["k1", "k2"])
    ref.remove_batch(["k1", "k2"])
    for ix in (ours, ref):
        with pytest.raises(ValueError):
            ix.remove_batch(["k3", "k1"])  # k3 goes, then k1 is missing
    assert "k3" not in ours and len(ours) == len(ref)
    # the JAX class leaves its device mask stale after that error (it would
    # still return k3); the port's mask follows at once
    assert not any(key == "k3" for row in ours.query_batch(q, 40) for key in row)
    for ix in (ours, ref):
        ix.remove("k5")
    _same(ours, ref, lambda ix: ix.query_batch(q, 10, return_scores=True))
    s_ours, s_ref = ours.status(), ref.status()
    for key in ("n_live", "n_removed", "b", "slot_bits", "words_per_sig", "compression_x"):
        assert s_ours[key] == s_ref[key], key
    assert s_ours["n_padded"] == 0 and s_ours["device_bytes"] == 400 * ours.width * 4 + 400
    ours.compact()
    ref.compact()
    assert ours.status()["n_removed"] == 0
    _same(ours, ref, lambda ix: ix.query_batch(q, 10, return_scores=True))
    more = _rows(np.random.RandomState(5), 20, 100)
    ours.insert_batch(range(1000, 1020), more)
    ref.insert_batch(range(1000, 1020), more)
    _same(ours, ref, lambda ix: ix.query_batch(np.concatenate([q, more[:3]]), 12,
                                               return_scores=True))


def test_query_stream_matches(data):
    db, q = data
    ours, ref = _pair(2, db)
    batches = [q[:8], q[8:11], q[11:30]]
    want = [ref.query_batch(bt, 4, return_scores=True) for bt in batches]
    for depth in (1, 2, 4):
        got = list(ours.query_stream(iter(batches), 4, return_scores=True, depth=depth))
        assert got == want
    assert list(ours.query_stream(iter(batches), 4)) == list(ref.query_stream(iter(batches), 4))
    with pytest.raises(ValueError):
        ours.query_stream(iter(batches), 0)


def test_errors_and_edges():
    """The JAX package's ``test_index_errors_and_edges`` against the port."""
    idx = TorchBBitIndex(b=4, num_perm=32, device="cpu")
    assert idx.is_empty()
    assert idx.query_batch([np.zeros(32, dtype=np.uint32)], 3) == [[]]
    assert idx.query_batch(np.zeros((0, 32), dtype=np.uint32), 3) == []
    for kw in ({"b": 0}, {"b": 33}, {"r": 1.5}, {"num_perm": 0}):
        with pytest.raises(ValueError):
            TorchBBitIndex(device="cpu", **kw)
    idx.insert("a", np.arange(32, dtype=np.uint32))
    with pytest.raises(ValueError, match="already exists"):
        idx.insert("a", np.arange(32, dtype=np.uint32))
    with pytest.raises(ValueError, match="out of range"):
        idx.insert("b", np.arange(16, dtype=np.uint32))
    with pytest.raises(ValueError, match="positive"):
        idx.query(np.arange(32, dtype=np.uint32), 0)
    with pytest.raises(ValueError, match="does not exist"):
        idx.remove("nope")
    with pytest.raises(ValueError, match="already exists"):
        idx.insert_batch(["c", "c"], np.zeros((2, 32), dtype=np.uint32))
    assert "c" not in idx and len(idx) == 1
    with pytest.raises(ValueError, match="equal length"):
        idx.insert_batch(["d", "e"], np.zeros((1, 32), dtype=np.uint32))
    assert idx.status()["compression_x"] == 8.0
    assert TorchBBitIndex(b=1, num_perm=128, device="cpu").status()["compression_x"] == 32.0


def test_files_load_in_both_classes(data, tmp_path):
    db, q = data
    ours, ref = _pair(4, db, keys=[("t", i) for i in range(400)], tile=512)
    for i in range(0, 400, 11):
        ours.remove(("t", i))
        ref.remove(("t", i))
    ours.save(str(tmp_path / "ours"))
    ref.save(str(tmp_path / "ref"))
    for path in ("ours", "ref"):
        a = TorchBBitIndex.load(str(tmp_path / path), device="cpu")
        b = TpuBBitIndex.load(str(tmp_path / path))
        assert (a.b, a.num_perm, a.r, a.tile) == (4, 100, 0.0, 512)
        assert a.query_batch(q, 10, return_scores=True) == \
            b.query_batch(q, 10, return_scores=True) == \
            ref.query_batch(q, 10, return_scores=True)
        a.insert(999, db[0])  # incremental insert after a load
        assert a.query(db[0], 1) == [999]  # ("t", 0) was removed
    empty = TorchBBitIndex(b=2, num_perm=16, device="cpu")
    empty.save(str(tmp_path / "empty.npz"))
    assert TpuBBitIndex.load(str(tmp_path / "empty.npz")).is_empty()
    assert TorchBBitIndex.load(str(tmp_path / "empty"), device="cpu").query_batch(q[:2, :16], 3) \
        == [[], []]


def test_device_tensor_kt_and_bbit_inputs(data):
    db, q = data
    ours, ref = _pair(2, db)
    tensor_ix = TorchBBitIndex(b=2, num_perm=100, device="cpu")
    tensor_ix.insert_batch(["k%d" % i for i in range(400)],
                           torch.from_numpy(db.view(np.int32)))
    want = ref.query_batch(q, 8, return_scores=True)
    assert tensor_ix.query_batch(torch.from_numpy(q.view(np.int32)), 8,
                                 return_scores=True) == want
    # bBitMinHash objects of either package
    objs = [bBitMinHash(_MH(row), b=2) for row in q[:5]]
    assert ours.query_batch(objs, 8) == ref.query_batch([JaxBBit(_MH(r), b=2) for r in q[:5]], 8)
    # (k, t) pairs: a batch and objects, mixed to slots as the JAX package does
    rng = np.random.RandomState(6)
    kt = np.stack([rng.randint(0, 50, (120, 64)), rng.randint(-20, 20, (120, 64))], -1)
    kt = kt.astype(np.int32)
    kt[60:] = np.where(rng.rand(60, 64, 1) < 0.7, kt[:60], kt[60:])
    pair = [TorchBBitIndex(b=4, num_perm=64, device="cpu"), TpuBBitIndex(b=4, num_perm=64)]
    for ix in pair:
        ix.insert_batch(range(120), kt)
    qkt = kt[55:70]
    assert pair[0].query_batch(qkt, 5, return_scores=True) == \
        pair[1].query_batch(qkt, 5, return_scores=True)
    as_objs = [_MH(x) for x in qkt]  # hashvalues [64, 2]
    for o in as_objs:
        o.hashvalues = o.hashvalues.astype(np.int64)
    assert pair[0].query_batch(as_objs, 5) == pair[1].query_batch(qkt, 5)
    assert pair[0].query_batch(torch.from_numpy(qkt), 5) == pair[1].query_batch(qkt, 5)


@pytest.mark.parametrize("b", [0, 1, 2, 3, 4, 7, 8, 16, 32])
def test_bbit_minhash_matches_jax(b):
    rng = np.random.RandomState(40 + b)
    hv1 = _rows(rng, 1, 100)[0].astype(np.uint64)
    hv2 = np.where(rng.rand(100) < 0.5, hv1, _rows(rng, 1, 100)[0])
    for r in (0.0, 0.25):
        ours = [bBitMinHash(_MH(h, seed=3), b=b, r=r) for h in (hv1, hv2)]
        ref = [JaxBBit(_MH(h, seed=3), b=b, r=r) for h in (hv1, hv2)]
        np.testing.assert_array_equal(ours[0].hashvalues, ref[0].hashvalues)
        if b == 0:  # the reference's quirk: C2 = 1 (or A divides by 0)
            for pair in (ours, ref):
                with pytest.raises(ZeroDivisionError):
                    pair[0].jaccard(pair[1])
        else:
            assert ours[0].jaccard(ours[1]) == ref[0].jaccard(ref[1])
        state = ours[0].__getstate__()
        assert bytes(state) == bytes(ref[0].__getstate__())
        assert ours[0].bytesize() == ref[0].bytesize() == len(state)
        back = pickle.loads(pickle.dumps(ours[1]))
        assert back == ours[1] and bytes(back.__getstate__()) == bytes(ours[1].__getstate__())
    with pytest.raises(ValueError):
        bBitMinHash(_MH(hv1), b=b).jaccard(bBitMinHash(_MH(hv1), b=b + 1))
    with pytest.raises(ValueError):
        bBitMinHash(_MH(hv1, seed=1), b=b).jaccard(bBitMinHash(_MH(hv1, seed=2), b=b))


def test_bbit_minhash_argument_checks():
    for kw in ({"b": 33}, {"b": -1}, {"r": 1.5}):
        with pytest.raises(ValueError):
            bBitMinHash(_MH(np.arange(8)), **kw)
