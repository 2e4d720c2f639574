"""Port parity: HyperLogLog / HyperLogLog++ and the functional HLL ops
against the JAX package, on seeded numpy inputs.

Registers, ``count()``, serialized bytes and pickled state must be equal.
The one tolerance is the f32 device estimate (``raw_estimate`` /
``count_batch``): it sums 2**p f32 terms, and XLA and torch reduce them in
different orders, so it is held at ``rtol=1e-5`` (a few f32 ulps of the
sum); its input, the registers, is held exact. Device branches run here
with ``device="cpu"``.
"""

import pickle

import numpy as np
import pytest
import torch

from datasketch_tpu import hyperloglog_const as jax_const
from datasketch_tpu.models import hyperloglog as jax_hll
from datasketch_tpu.ops import hll_ops as jax_ops
from datasketch_tpu_torch import HyperLogLog, HyperLogLogPlusPlus, hyperloglog_const
from datasketch_tpu_torch.ops import hll_ops

torch.set_num_threads(2)

F32_RTOL = 1e-5  # f32 sum of 2**p terms, reduced in another order than XLA's

JAX_CLASSES = {HyperLogLog: jax_hll.HyperLogLog, HyperLogLogPlusPlus: jax_hll.HyperLogLogPlusPlus}


def byte_hash(token):
    """A custom 32-bit hashfunc (module level, so sketches that hold it pickle)."""
    return (int.from_bytes(token[:4].ljust(4, b"\0"), "little") * 2654435761) & 0xFFFFFFFF


def _docs(n, seed, max_len=60):
    rng = np.random.RandomState(seed)
    return [[b"d%d-t%d" % (i, j) for j in rng.randint(0, 5000, size=rng.randint(0, max_len))]
            for i in range(n)]


def _id_docs(n, seed, vocab=1 << 20, max_len=60):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(0, max_len)).astype(np.uint64)
            for _ in range(n)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("p", [4, 12, 14])
def test_hll_ops_match_jax(p):
    rng = np.random.RandomState(p)
    b, t = 9, 70
    h32 = rng.randint(0, 1 << 32, size=(b, t), dtype=np.uint64).astype(np.uint32)
    h32[0, :5] = [0, 1, (1 << p) - 1, 1 << 31, 0xFFFFFFFF]
    hi = rng.randint(0, 1 << 32, size=(b, t), dtype=np.uint64).astype(np.uint32)
    hi[1, :3] = 0  # ranks past 32 bits
    lengths = np.array([70, 3, 0, 70, 1, 35, 69, 2, 70], dtype=np.int32)
    np.testing.assert_array_equal(hll_ops.bit_length32(_t(h32.view(np.int32))).numpy(),
                                  np.asarray(jax_ops.bit_length32(h32)))
    for got, want in ((hll_ops.ranks_and_indices32(_t(h32.view(np.int32)), p),
                       jax_ops.ranks_and_indices32(h32, p)),
                      (hll_ops.ranks_and_indices64(_t(hi.view(np.int32)),
                                                   _t(h32.view(np.int32)), p),
                       jax_ops.ranks_and_indices64(hi, h32, p))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lens = _t(lengths)
    regs32 = hll_ops.sketch_batch32(_t(h32.view(np.int32)), lens, p)
    regs64 = hll_ops.sketch_batch64(_t(hi.view(np.int32)), _t(h32.view(np.int32)), lens, p)
    regs_ids = hll_ops.sketch_batch64_ids(_t(h32.view(np.int32)), lens, p)
    np.testing.assert_array_equal(regs32.numpy(), np.asarray(jax_ops.sketch_batch32(h32, lengths, p)))
    np.testing.assert_array_equal(regs64.numpy(),
                                  np.asarray(jax_ops.sketch_batch64(hi, h32, lengths, p)))
    np.testing.assert_array_equal(regs_ids.numpy(),
                                  np.asarray(jax_ops.sketch_batch64_ids(h32, lengths, p)))
    assert regs32.dtype == torch.int8 and not regs32[2].any()  # a 0-length row
    small = (h32 & 0xFFFF).astype(np.uint16)  # narrow id uploads zero-extend
    np.testing.assert_array_equal(hll_ops.sketch_batch64_ids(_t(small), lens, p).numpy(),
                                  np.asarray(jax_ops.sketch_batch64_ids(small, lengths, p)))
    merged = hll_ops.merge_regs(regs32, regs64)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jax_ops.merge_regs(
        np.asarray(regs32), np.asarray(regs64))))
    idx, rank = hll_ops.ranks_and_indices32(_t(h32.view(np.int32)), p)
    valid = torch.arange(t)[None, :] < lens[:, None]
    np.testing.assert_array_equal(
        hll_ops.update_regs(regs64.clone(), idx, rank, valid, 1 << p).numpy(),
        np.asarray(jax_ops.update_regs(np.asarray(regs64), *jax_ops.ranks_and_indices32(h32, p),
                                       valid.numpy(), 1 << p)))
    # saturated rows reach the large-range branch's neighbourhood
    full = np.full((2, 1 << p), 30, dtype=np.int8)
    for regs in (merged.numpy(), full):
        np.testing.assert_allclose(hll_ops.raw_estimate(_t(regs), p).numpy(),
                                   np.asarray(jax_ops.raw_estimate(regs, p)), rtol=F32_RTOL)
        np.testing.assert_allclose(hll_ops.count_batch(_t(regs), p).numpy(),
                                   np.asarray(jax_ops.count_batch(regs, p)), rtol=F32_RTOL)


def _hashfunc_case(cls, name, seed):
    """(constructor kwargs, corpus) for a stock hashfunc, 'device' or a callable."""
    if name == "device":
        return {"hashfunc": "device"}, _id_docs(24, seed)
    if name == "callable":
        return {"hashfunc": byte_hash}, _docs(24, seed)
    return {}, _docs(24, seed)


@pytest.mark.parametrize("cls", [HyperLogLog, HyperLogLogPlusPlus], ids=["hll", "hllpp"])
@pytest.mark.parametrize("p", [4, 12, 14])
@pytest.mark.parametrize("hashfunc", ["stock", "device", "callable"])
def test_sketches_match_jax(cls, p, hashfunc):
    jcls = JAX_CLASSES[cls]
    kw, docs = _hashfunc_case(cls, hashfunc, p)
    want = jcls.bulk_registers(docs, p=p, **kw)
    for mode in ("disable", "always"):
        got = cls.bulk_registers(docs, p=p, device_mode=mode, device="cpu", **kw)
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
    tokens = [t for d in docs for t in d]
    ref = jcls(p=p, device_mode="disable", **kw)
    ref.update_batch(tokens)
    for mode in ("disable", "always"):
        ours = cls(p=p, device_mode=mode, device="cpu", **kw)
        ours.update_batch(tokens[: len(tokens) // 3])
        ours.update_batch(tokens[len(tokens) // 3:])
        np.testing.assert_array_equal(ours.reg, ref.reg)
        assert ours.count() == ref.count()
    one, ref_one = cls(p=p, **kw), jcls(p=p, **kw)
    for tok in tokens[:50]:
        one.update(tok)
        ref_one.update(tok)
    np.testing.assert_array_equal(one.reg, ref_one.reg)
    assert one.count() == ref_one.count()
    bulk = cls.bulk(docs[:5], p=p, device="cpu", **kw)
    assert [b.reg.tolist() for b in bulk] == [r.reg.tolist() for r in
                                             jcls.bulk(docs[:5], p=p, **kw)]


@pytest.mark.parametrize("cls", [HyperLogLog, HyperLogLogPlusPlus], ids=["hll", "hllpp"])
def test_serialize_and_pickle_across_packages(cls):
    jcls = JAX_CLASSES[cls]
    ours, ref = cls(p=12), jcls(p=12)
    tokens = [b"t%d" % i for i in range(3000)]
    ours.update_batch(tokens)
    ref.update_batch(tokens)
    buf, ref_buf = bytearray(ours.bytesize()), bytearray(ref.bytesize())
    ours.serialize(buf)
    ref.serialize(ref_buf)
    assert buf == ref_buf and ours.bytesize() == ref.bytesize()
    assert cls.deserialize(ref_buf) == ours
    np.testing.assert_array_equal(jcls.deserialize(buf).reg, ref.reg)
    assert ours.__getstate__() == ref.__getstate__()
    back = pickle.loads(pickle.dumps(ours))
    assert back == ours and back.count() == ref.count()
    u = cls.union(ours, cls(p=12))
    assert u == ours and cls.union(ours, ours).count() == jcls.union(ref, ref).count()
    assert ours.copy() == ours and ours.digest().tolist() == ref.digest().tolist()
    ours.clear()
    assert ours.is_empty() and len(ours) == 4096
    with pytest.raises(ValueError):
        ours.merge(cls(p=10))
    with pytest.raises(ValueError):
        ours.serialize(bytearray(10))


def test_sparse_transitions_and_merges_match_jax():
    rng = np.random.RandomState(7)
    batches = [[b"s%d" % x for x in rng.randint(0, 5000, size=n)] for n in (30, 30, 200, 900)]
    ours = HyperLogLogPlusPlus(p=12, sparse=True, device="cpu")
    ref = jax_hll.HyperLogLogPlusPlus(p=12, sparse=True)
    states = []
    for batch in batches:  # stays sparse, then outgrows 4096 / 8 keys
        ours.update_batch(batch)
        ref.update_batch(batch)
        assert ours.is_sparse == ref.is_sparse
        assert ours.count() == ref.count() and ours.digest().tolist() == ref.digest().tolist()
        states.append(ours.is_sparse)
    assert states[0] and not states[-1]
    for tok in (b"one", b"two"):
        ours.update(tok)
        ref.update(tok)
    assert ours.count() == ref.count()

    def sparse_pair(tokens):
        a = HyperLogLogPlusPlus(p=12, sparse=True, device="cpu")
        b = jax_hll.HyperLogLogPlusPlus(p=12, sparse=True)
        for tok in tokens:
            a.update(tok)
            b.update(tok)
        return a, b

    s1, r1 = sparse_pair([b"a%d" % i for i in range(100)])
    s2, r2 = sparse_pair([b"b%d" % i for i in range(120)])
    s1.merge(s2)  # sparse <- sparse
    r1.merge(r2)
    assert s1.is_sparse and r1.is_sparse and s1.count() == r1.count()
    dense, rdense = HyperLogLogPlusPlus(p=12), jax_hll.HyperLogLogPlusPlus(p=12)
    dense.merge(s1)  # dense <- sparse
    rdense.merge(r1)
    np.testing.assert_array_equal(dense.reg, rdense.reg)
    s2.merge(ours)  # sparse <- dense
    r2.merge(ref)
    assert not s2.is_sparse and s2.count() == r2.count()
    cp = s1.copy()
    assert cp.is_sparse and cp == s1
    cp.clear()
    assert cp.is_sparse and cp.is_empty() and cp.count() == 0.0
    assert pickle.loads(pickle.dumps(s1)).digest().tolist() == r1.digest().tolist()
    assert pickle.dumps(r1) and s1.is_sparse == r1.is_sparse  # pickling densifies both


def test_empty_corpora_overflow_and_wide_ids():
    for cls in (HyperLogLog, HyperLogLogPlusPlus):
        for mode in ("disable", "always"):
            assert cls.bulk_registers([], p=8, device_mode=mode, device="cpu").shape == (0, 256)
            regs = cls.bulk_registers([[], []], p=8, device_mode=mode, device="cpu")
            assert regs.shape == (2, 256) and not regs.any()
        h = cls(p=8, device="cpu")
        h.update_batch([])
        assert h.is_empty()
    wide = [lambda t: 1 << 32, lambda t: 1 << 40]
    for mode in ("disable", "always"):
        h = HyperLogLog(p=8, hashfunc=wide[0], device_mode=mode, device="cpu")
        with pytest.raises(ValueError, match="overflow"):
            h.update_batch([b"x"])
        with pytest.raises(ValueError, match="overflow"):
            HyperLogLog.bulk_registers([[b"x"]], p=8, hashfunc=wide[1], device_mode=mode,
                                       device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        HyperLogLog(p=8, hashfunc=wide[0]).update(b"x")
    with pytest.raises(ValueError):
        HyperLogLog(p=3)
    with pytest.raises(ValueError):
        HyperLogLog(device_mode="sometimes")
    # ids past 2**32 take the host mix even with device_mode="always"
    docs = _id_docs(12, 3, vocab=1 << 20)
    docs[4] = docs[4] + np.uint64(1 << 35)
    want = jax_hll.HyperLogLogPlusPlus.bulk_registers(docs, p=12, hashfunc="device",
                                                      device_mode="always")
    got = HyperLogLogPlusPlus.bulk_registers(docs, p=12, hashfunc="device",
                                             device_mode="always", device="cpu")
    np.testing.assert_array_equal(got, want)


def test_auto_mode_takes_the_device_branch_from_32768_tokens():
    ids = np.random.RandomState(5).randint(0, 1 << 30, size=40000).astype(np.uint64)
    ref = jax_hll.HyperLogLogPlusPlus(p=14, hashfunc="device", device_mode="disable")
    ref.update_batch(ids)
    for cls_kw in ({"hashfunc": "device"}, {"hashfunc": hll_ids_hash}):
        ours = HyperLogLogPlusPlus(p=14, device="cpu", **cls_kw)
        before = hll_ops.device_calls
        ours.update_batch(ids)
        np.testing.assert_array_equal(ours.reg, ref.reg)
        assert hll_ops.device_calls == before  # device calls count CUDA tensors only


def hll_ids_hash(token_id):
    from datasketch_tpu_torch.hashfunc import device_hash64

    return device_hash64(token_id)


def test_bias_constants_match_jax():
    assert hyperloglog_const._thresholds == jax_const._thresholds
    assert hyperloglog_const._raw_estimate == jax_const._raw_estimate
    assert hyperloglog_const._bias == jax_const._bias
