"""Port parity: the per-object MinHash API, LeanMinHash and the rest of
``hashfunc`` against the JAX package. Hash values, estimates, serialized
bytes and pickles must be equal; ``update_batch``'s device branch runs on
the CPU here (``device="cpu"``, kernel 1's plain twin)."""

import pickle

import numpy as np
import pytest
import torch

from datasketch_tpu import LeanMinHash as JaxLean
from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu import hashfunc as jax_hashfunc
from datasketch_tpu.ops import hashing as jax_hashing
from datasketch_tpu_torch import LeanMinHash, MinHash, hashfunc
from datasketch_tpu_torch.ops import hashing

torch.set_num_threads(2)


def _tokens(n, seed):
    rng = np.random.RandomState(seed)
    return [bytes(rng.randint(0, 256, rng.randint(1, 24), dtype=np.uint8)) for _ in range(n)]


def first_byte_hash(token):
    """A custom hashfunc (module level, so sketches that hold it pickle)."""
    return (token[0] * 2654435761 + len(token)) & 0xFFFFFFFF


HASHFUNCS = {
    "sha1": ({}, {}),
    "xxh32": ({"hashfunc": "xxh32"}, {"hashfunc": "xxh32"}),
    "callable": ({"hashfunc": first_byte_hash}, {"hashfunc": first_byte_hash}),
}


@pytest.mark.parametrize("name", sorted(HASHFUNCS))
@pytest.mark.parametrize("n_tokens", [3, 5000])
def test_update_and_update_batch_match(name, n_tokens):
    ours_kw, ref_kw = HASHFUNCS[name]
    tokens = _tokens(n_tokens, n_tokens)
    ref = JaxMinHash(num_perm=100, seed=3, device_mode="disable", **ref_kw)
    ref.update_batch(tokens)
    for mode in ("disable", "auto", "always"):  # host, host or device, device
        ours = MinHash(num_perm=100, seed=3, device_mode=mode, device="cpu", **ours_kw)
        ours.update_batch(tokens[: n_tokens // 2])
        ours.update_batch(tokens[n_tokens // 2:])
        np.testing.assert_array_equal(ours.hashvalues, ref.hashvalues)
        assert ours.hashvalues.dtype == np.uint64
    one = MinHash(num_perm=100, seed=3, **ours_kw)
    ref_one = JaxMinHash(num_perm=100, seed=3, **ref_kw)
    for t in tokens[:40]:
        one.update(t)
        ref_one.update(t)
    np.testing.assert_array_equal(one.hashvalues, ref_one.hashvalues)


def test_device_hash_tokens_and_the_device_branch():
    ids = np.random.RandomState(1).randint(0, 1 << 31, 6000)
    ref = JaxMinHash(num_perm=64, hashfunc="device")
    ref.update_batch(ids)
    ours = MinHash(num_perm=64, hashfunc="device", device_mode="always", device="cpu")
    ours.update_batch(ids)
    np.testing.assert_array_equal(ours.hashvalues, ref.hashvalues)
    custom = JaxMinHash(num_perm=64, seed=9).permutations  # explicit (a, b)
    a = MinHash(num_perm=64, permutations=custom, device_mode="always", device="cpu")
    b = JaxMinHash(num_perm=64, permutations=custom)
    a.update_batch(_tokens(50, 2))
    b.update_batch(_tokens(50, 2))
    np.testing.assert_array_equal(a.hashvalues, b.hashvalues)


def test_estimates_merge_union_copy_and_equality():
    pairs = []
    for seed in (1, 2, 3):
        toks = _tokens(300, seed) + _tokens(200, 9)
        ours, ref = MinHash(num_perm=128), JaxMinHash(num_perm=128)
        ours.update_batch(toks)
        ref.update_batch(toks)
        pairs.append((ours, ref))
    (a, ra), (b, rb), (c, rc) = pairs
    assert a.jaccard(b) == ra.jaccard(rb) and a.count() == ra.count()
    u, ru = MinHash.union(a, b, c), JaxMinHash.union(ra, rb, rc)
    np.testing.assert_array_equal(u.hashvalues, ru.hashvalues)
    assert u.count() == ru.count()
    m = a.copy()
    assert m == a and m is not a and m.device == a.device
    m.merge(b)
    ra2 = ra.copy()
    ra2.merge(rb)
    np.testing.assert_array_equal(m.hashvalues, ra2.hashvalues)
    assert m != a and len(m) == 128
    d = m.digest()
    d[0] = 0
    assert m.hashvalues[0] != 0
    assert not m.is_empty()
    m.clear()
    assert m.is_empty() and m == MinHash(num_perm=128)
    assert MinHash(num_perm=128, gpu_mode="detect")._gpu_mode == "detect"
    for bad in (lambda: a.jaccard(MinHash(num_perm=64)),
                lambda: a.merge(MinHash(num_perm=128, seed=2)),
                lambda: MinHash.union(a),
                lambda: MinHash(hashfunc=3),
                lambda: MinHash(device_mode="x"),
                lambda: MinHash(gpu_mode="x")):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("n_docs,doc_len", [(30, 20), (1500, 12)])
def test_bulk_and_generator_match(n_docs, doc_len):
    rng = np.random.RandomState(n_docs)
    docs = [_tokens(int(rng.randint(0, doc_len)), i) for i in range(n_docs)]
    ref = JaxMinHash.bulk(docs, num_perm=64, seed=2)
    for mode in ("auto", "disable"):  # 1500 x ~6 tokens: the first chunk signs "on device"
        ours = MinHash.bulk(docs, num_perm=64, seed=2, device_mode=mode, device="cpu")
        assert [o.hashvalues.tolist() for o in ours] == [r.hashvalues.tolist() for r in ref]
    gen = list(MinHash.generator(iter(docs), num_perm=64, seed=2, device="cpu"))
    ref_gen = list(JaxMinHash.generator(iter(docs), num_perm=64, seed=2))
    assert [g.hashvalues.tolist() for g in gen] == [r.hashvalues.tolist() for r in ref_gen]
    with pytest.raises(ValueError, match="unknown signature scheme"):
        list(MinHash.generator(docs, scheme="nope"))


def test_pickle_round_trip():
    m = MinHash(num_perm=32, hashfunc=first_byte_hash, device_mode="always", device="cpu")
    m.update_batch(_tokens(40, 5))
    back = pickle.loads(pickle.dumps(m))
    assert back == m and back.hashfunc is first_byte_hash
    assert back._device_mode == "always" and back.device == "cpu"
    assert back.permutations[0].tolist() == m.permutations[0].tolist()


@pytest.mark.parametrize("name", ["xxh32", "callable", "disable"])
def test_bulk_signatures_with_other_hashfuncs(name):
    docs = [_tokens(n, n) for n in (0, 3, 40, 7)]
    kw = {"disable": {"device_mode": "disable"}}.get(name, HASHFUNCS.get(name, ({},))[0])
    got = MinHash.bulk_signatures(docs, num_perm=64, device="cpu", **kw)
    want = JaxMinHash.bulk_signatures(docs, num_perm=64, **kw)
    np.testing.assert_array_equal(got, want)
    dev = MinHash.bulk_signatures(docs, num_perm=64, device="cpu", out="device", **kw)
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), want)


def test_bulk_from_text_xxh32_and_refusal():
    texts = [b"the quick brown fox jumps", "naïve café text", b"short"]
    got = MinHash.bulk_from_text(texts, k=4, num_perm=64, hashfunc="xxh32", device="cpu")
    want = JaxMinHash.bulk_from_text(texts, k=4, num_perm=64, hashfunc="xxh32")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="natively"):
        MinHash.bulk_from_text(texts, hashfunc=first_byte_hash, device="cpu")


@pytest.mark.parametrize("byteorder", ["@", "<", ">", "!"])
def test_lean_minhash_bytes_match(byteorder):
    m, r = MinHash(num_perm=50, seed=7), JaxMinHash(num_perm=50, seed=7)
    toks = _tokens(80, 3)
    m.update_batch(toks)
    r.update_batch(toks)
    lean, ref = LeanMinHash(m), JaxLean(r)
    assert lean.bytesize(byteorder) == ref.bytesize(byteorder)
    ours_buf, ref_buf = bytearray(lean.bytesize(byteorder)), bytearray(ref.bytesize(byteorder))
    lean.serialize(ours_buf, byteorder)
    ref.serialize(ref_buf, byteorder)
    assert ours_buf == ref_buf
    back = LeanMinHash.deserialize(ref_buf, byteorder)
    assert back == lean and hash(back) == hash(lean)
    np.testing.assert_array_equal(JaxLean.deserialize(ours_buf, byteorder).hashvalues,
                                  lean.hashvalues)


def test_lean_minhash_api():
    m = MinHash(num_perm=40)
    m.update_batch(_tokens(30, 1))
    lean = LeanMinHash(m)
    assert lean.jaccard(m) == 1.0 and lean.count() == m.count()
    assert pickle.loads(pickle.dumps(lean)) == lean
    assert LeanMinHash(seed=1, hashvalues=m.hashvalues) == lean
    other = LeanMinHash(MinHash(num_perm=40))
    u, ru = LeanMinHash.union(lean, other), JaxLean.union(JaxLean(seed=1, hashvalues=m.hashvalues),
                                                          JaxLean(JaxMinHash(num_perm=40)))
    np.testing.assert_array_equal(u.hashvalues, ru.hashvalues)
    assert lean.copy() == lean and {lean: 1}[lean.copy()] == 1
    for bad in (lambda: lean.update(b"x"), lambda: lean.update_batch([b"x"])):
        with pytest.raises(TypeError):
            bad()
    with pytest.raises(ValueError):
        LeanMinHash()
    with pytest.raises(ValueError, match="space"):
        lean.serialize(bytearray(4))


def test_hashfuncs_match():
    toks = _tokens(200, 11) + [b""]
    for t in toks[:50]:
        assert hashfunc.sha1_hash64(t) == jax_hashfunc.sha1_hash64(t)
        assert hashfunc.xxhash_hash32(t) == jax_hashfunc.xxhash_hash32(t)
        assert hashfunc.xxhash_hash32(bytearray(t)) == jax_hashfunc.xxhash_hash32(t)
    np.testing.assert_array_equal(hashfunc.batch_sha1_hash32(toks),
                                  jax_hashfunc.batch_sha1_hash32(toks))
    np.testing.assert_array_equal(hashfunc.batch_sha1_hash64(toks),
                                  jax_hashfunc.batch_sha1_hash64(toks))
    assert hashfunc.batch_sha1_hash64(toks).dtype == np.uint64
    for x in (0, 1, 12345, (1 << 32) + 7, (1 << 64) - 1, -5):
        assert hashfunc.device_hash64(x) == jax_hashfunc.device_hash64(x)
        assert hashfunc.device_hash(x) == jax_hashfunc.device_hash(x)
    with pytest.raises(TypeError):
        hashfunc.xxhash_hash32(5)


def test_mix64_matches():
    x = np.random.RandomState(4).randint(0, 1 << 63, 1000, dtype=np.int64).astype(np.uint64)
    x[:3] = [0, (1 << 64) - 1, 1 << 32]
    want = jax_hashing.mix64_np(x)
    np.testing.assert_array_equal(hashing.mix64_np(x), want)
    hi = torch.from_numpy((x >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((x & np.uint64(0xFFFFFFFF)).astype(np.int64))
    h, lw = hashing.mix64(hi, lo)
    got = (h.numpy().astype(np.uint64) << np.uint64(32)) | lw.numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, want)
