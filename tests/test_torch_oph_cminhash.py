"""Port parity: the OPH and C-MinHash signature schemes against the JAX
package, op by op and through every bulk path (``bulk``, ``generator``,
``bulk_signatures``, ``bulk_from_text``) and both ``index_tokens(scheme=)``
facades. Signatures and answers must be equal; device branches run with
``device="cpu"``."""

import numpy as np
import pytest
import torch

from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu.models.tpu_forest import TpuMinHashLSHForest
from datasketch_tpu.models.tpu_lsh import TpuMinHashLSH
from datasketch_tpu.ops import cminhash as jax_cminhash
from datasketch_tpu.ops import oph as jax_oph
from datasketch_tpu_torch import MinHash, TorchMinHashLSH, TorchMinHashLSHForest
from datasketch_tpu_torch.ops import cminhash, oph

torch.set_num_threads(2)

OPS = {"oph": (oph.oph_signatures, jax_oph.oph_signatures),
       "cminhash": (cminhash.cminhash_signatures, jax_cminhash.cminhash_signatures)}


def _tokens(n, seed):
    rng = np.random.RandomState(seed)
    return [b"w%d" % x for x in rng.randint(0, 3000, size=n)]


def _id_docs(n, seed, vocab=5000):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(0, 90)).astype(np.uint32) for _ in range(n)]


@pytest.mark.parametrize("scheme", sorted(OPS))
@pytest.mark.parametrize("num_perm", [1, 7, 128, 129])
def test_signatures_match_jax(scheme, num_perm):
    ours, ref = OPS[scheme]
    rng = np.random.RandomState(num_perm)
    hashes = rng.randint(0, 1 << 32, size=(9, 70), dtype=np.uint64).astype(np.uint32)
    hashes[8, :3] = [0, 0xFFFFFFFF, 0]  # extreme values, a repeated token
    lengths = np.array([0, 1, 31, 32, 33, 63, 64, 65, 70], dtype=np.int32)
    for seed in (1, 7, 1 << 33):
        got = ours(torch.from_numpy(hashes.view(np.int32)), torch.from_numpy(lengths),
                   num_perm, seed=seed)
        want = np.asarray(ref(hashes, lengths, num_perm, seed=seed))
        assert got.dtype == torch.int32 and got.shape == (9, num_perm)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        assert (want[0] == 0xFFFFFFFF).all()  # the empty document
    narrow = (hashes & 0xFFFF).astype(np.uint16)
    np.testing.assert_array_equal(
        ours(torch.from_numpy(narrow), torch.from_numpy(lengths), num_perm).numpy().view(np.uint32),
        np.asarray(ref(narrow.astype(np.uint32), lengths, num_perm)))


def test_oph_refuses_num_perm_past_int64_product():
    with pytest.raises(ValueError, match="num_perm"):
        oph.oph_signatures(torch.zeros((1, 4), dtype=torch.int32), torch.ones(1), 1 << 31)


@pytest.mark.parametrize("scheme", ["oph", "cminhash"])
@pytest.mark.parametrize("mode", ["disable", "auto", "always"])
def test_bulk_paths_match_jax(scheme, mode):
    rng = np.random.RandomState(3)
    docs = [_tokens(int(rng.randint(0, 40)), i) for i in range(150)]
    docs += [_tokens(2500, 1000 + i) for i in range(2)]  # 4,096+ tokens: "auto" signs on device
    kw = dict(num_perm=64, seed=4, device_mode=mode)
    want = JaxMinHash.bulk_signatures(docs, scheme=scheme, num_perm=64, seed=4)
    got = MinHash.bulk_signatures(docs, scheme=scheme, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    dev = MinHash.bulk_signatures(docs, scheme=scheme, out="device", device="cpu", **kw)
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), want)
    bulk = MinHash.bulk(docs, scheme=scheme, device="cpu", **kw)
    assert np.array_equal(np.stack([m.hashvalues for m in bulk]), want.astype(np.uint64))
    gen = list(MinHash.generator(iter(docs[:40]), scheme=scheme, device="cpu", **kw))
    ref_gen = list(JaxMinHash.generator(iter(docs[:40]), scheme=scheme, num_perm=64, seed=4))
    assert [g.hashvalues.tolist() for g in gen] == [r.hashvalues.tolist() for r in ref_gen]
    ids = _id_docs(60, 5)
    np.testing.assert_array_equal(
        MinHash.bulk_signatures(ids, scheme=scheme, hashfunc="device", device="cpu", **kw),
        JaxMinHash.bulk_signatures(ids, scheme=scheme, num_perm=64, seed=4, hashfunc="device"))


@pytest.mark.parametrize("scheme", ["oph", "cminhash"])
def test_bulk_from_text_matches_jax(scheme):
    rng = np.random.RandomState(8)
    texts = [bytes(rng.randint(97, 123, size=n, dtype=np.uint8)) for n in (0, 4, 9, 40, 300)]
    for hf in ({}, {"hashfunc": "xxh32"}):
        got = MinHash.bulk_from_text(texts, k=5, scheme=scheme, num_perm=48, device="cpu", **hf)
        want = JaxMinHash.bulk_from_text(texts, k=5, scheme=scheme, num_perm=48, **hf)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="permutation"):
        MinHash.bulk_from_text(texts, scheme=scheme, hashfunc="device", device="cpu")


def test_custom_permutations_refused_with_other_schemes():
    a = np.arange(1, 9, dtype=np.uint64)
    perms = (a, a + 1)
    for call in (lambda: MinHash.bulk_signatures([[b"x"]], scheme="oph", num_perm=8,
                                                 permutations=perms, device="cpu"),
                 lambda: list(MinHash.generator([[b"x"]], scheme="cminhash", num_perm=8,
                                                permutations=perms)),
                 lambda: MinHash.bulk_from_text([b"abcdefghij"], scheme="oph", num_perm=8,
                                                permutations=perms, device="cpu")):
        with pytest.raises(ValueError, match="meaningless"):
            call()


@pytest.mark.parametrize("scheme", ["oph", "cminhash"])
def test_index_tokens_facades_match_jax(scheme):
    docs = _id_docs(400, 11)
    rng = np.random.RandomState(12)
    queries = []
    for i in rng.randint(0, len(docs), 24):
        q = docs[i].copy()
        q[rng.rand(q.size) < 0.15] = rng.randint(0, 5000)
        queries.append(q)
    q_ours = MinHash.bulk_signatures(queries, scheme=scheme, num_perm=128, hashfunc="device",
                                     device="cpu")
    q_ref = JaxMinHash.bulk_signatures(queries, scheme=scheme, num_perm=128, hashfunc="device")
    np.testing.assert_array_equal(q_ours, q_ref)
    ours = TorchMinHashLSH(threshold=0.5, num_perm=128, device="cpu")
    ref = TpuMinHashLSH(threshold=0.5, num_perm=128)
    for ix in (ours, ref):
        ix.index_tokens(range(len(docs)), docs, scheme=scheme)
    for method in ("bands", "scan"):
        assert ours.top_k(q_ours, 5, method=method) == ref.top_k(q_ref, 5, method=method)
        assert (ours.query_batch(q_ours, return_scores=True, method=method)
                == ref.query_batch(q_ref, return_scores=True, method=method))
    forest = TorchMinHashLSHForest(num_perm=128, device="cpu")
    ref_forest = TpuMinHashLSHForest(num_perm=128)
    for ix in (forest, ref_forest):
        ix.index_tokens(range(len(docs)), docs, scheme=scheme)
    assert (forest.query_batch(q_ours, 5, return_scores=True)
            == ref_forest.query_batch(q_ref, 5, return_scores=True))
