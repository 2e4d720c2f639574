"""Port parity: the raw-text and token-id front ends against the JAX
package on the same inputs -- the on-card window roll, the shingle
signatures, ``MinHash.bulk_from_text`` with both engines, the six
``TorchMinHashLSH`` front ends and ``TorchBBitIndex.insert_tokens`` /
``insert_text``. Every comparison is exact."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu import TpuBBitIndex
from datasketch_tpu.models.tpu_lsh import TpuMinHashLSH
from datasketch_tpu.ops import text_ops as jax_text
from datasketch_tpu_torch import MinHash, TorchBBitIndex, TorchMinHashLSH
from datasketch_tpu_torch.ops import text_ops
from datasketch_tpu_torch.ops.minhash_ops import init_permutations

torch.set_num_threads(2)

P = 64


def _texts(n, seed, lo=0, hi=300):
    """Random byte texts of lengths lo..hi (some shorter than any k used,
    one empty), with the bytes of a small alphabet so shingles repeat."""
    rng = np.random.RandomState(seed)
    out = [bytes(rng.randint(97, 105, size=rng.randint(lo, hi), dtype=np.uint8))
           for _ in range(n)]
    out[0] = b""
    return out


@pytest.fixture(scope="module")
def corpus():
    """120 texts, 40 near-copies (a suffix replaced) and 30 queries of the
    same kind; integer-token docs beside them."""
    rng = np.random.RandomState(1)
    base = _texts(120, 2, lo=40, hi=400)
    base[0] = b"short"
    near = [t[: max(0, len(t) - 30)] + bytes(rng.randint(97, 123, 30, dtype=np.uint8))
            for t in base[1:41]]
    queries = [t[: max(0, len(t) - 20)] + b"zzzzzzzzzzzzzzzzzzzz" for t in base[50:80]]
    docs = [rng.randint(0, 3000, rng.randint(1, 150)) for _ in range(160)]
    docs += [np.concatenate([d[: len(d) // 2], rng.randint(0, 3000, 20)]) for d in docs[:40]]
    return base + near, queries, docs


@pytest.mark.parametrize("k", [1, 5, 9])
def test_window_hashes_match_jax(k):
    texts = _texts(12, k)
    for t in texts:
        np.testing.assert_array_equal(text_ops.window_hashes_np(t, k),
                                      jax_text.window_hashes_np(t, k))
    lengths = np.array([len(t) for t in texts], dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    flat = np.frombuffer(b"".join(texts), dtype=np.uint8)
    width = 512
    want = np.asarray(jax_text._window_hashes_device(
        jnp.asarray(np.pad(flat, (0, 1024))), jnp.asarray(starts), k, width))
    got = text_ops.window_hashes(torch.from_numpy(flat.copy()), k).numpy()
    for i, (s, n) in enumerate(zip(starts, lengths)):
        m = max(0, n - k + 1)
        np.testing.assert_array_equal(got[s: s + m], want[i, :m])
        np.testing.assert_array_equal(got[s: s + m], jax_text.window_hashes_np(texts[i], k))


@pytest.mark.parametrize("k", [3, 9])
def test_shingle_signatures_match_jax(k):
    texts = _texts(40, 10 + k, hi=200)
    texts[1] = b"ab"  # shorter than k: the empty sketch
    lengths = np.array([len(t) for t in texts], dtype=np.int32)
    flat = np.frombuffer(b"".join(texts), dtype=np.uint8)
    want = np.asarray(jax_text.shingle_signatures_ragged(flat, lengths, k, 3, P))
    got = text_ops.shingle_signatures_ragged(torch.from_numpy(flat.copy()),
                                             torch.from_numpy(lengths), k, 3, P)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want[:2] == 0xFFFFFFFF).all()
    empty = text_ops.shingle_signatures_ragged(torch.zeros(0, dtype=torch.uint8),
                                               torch.zeros(3, dtype=torch.int32), k, 3, P)
    assert (empty.numpy().view(np.uint32) == 0xFFFFFFFF).all()


@pytest.mark.parametrize("hashfunc", ["sha1", "device"])
def test_bulk_from_text_matches_jax(hashfunc):
    texts = _texts(70, 21, hi=500)
    texts[5] = "unicode ünïcödé text, long enough"  # str is UTF-8 encoded
    kw = {} if hashfunc == "sha1" else {"hashfunc": "device"}
    for k in (4, 9):
        want = JaxMinHash.bulk_from_text(texts, k=k, num_perm=P, seed=7, **kw)
        got = MinHash.bulk_from_text(texts, k=k, num_perm=P, seed=7, device="cpu", **kw)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        dev = MinHash.bulk_from_text(texts, k=k, num_perm=P, seed=7, out="device",
                                     device="cpu", **kw)
        np.testing.assert_array_equal(dev.numpy().view(np.uint32), want)
    perms = tuple(np.asarray(x)[::-1].copy() for x in init_permutations(5, P))
    want = JaxMinHash.bulk_from_text(texts, k=6, num_perm=P, permutations=perms, **kw)
    got = MinHash.bulk_from_text(texts, k=6, num_perm=P, permutations=perms, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert MinHash.bulk_from_text([], num_perm=P, device="cpu", **kw).shape == (0, P)


def test_bulk_from_text_sha1_is_the_reference_formula():
    texts = _texts(6, 31, lo=10, hi=80)
    k = 5
    got = MinHash.bulk_from_text(texts, k=k, num_perm=P, seed=1, device="cpu")
    a, b = init_permutations(1, P)
    for t, row in zip(texts, got):
        sh = [t[i: i + k] for i in range(len(t) - k + 1)]
        if not sh:
            assert (row == 0xFFFFFFFF).all()
            continue
        hv = np.array([int.from_bytes(hashlib.sha1(s).digest()[:4], "little") for s in sh],
                      dtype=np.uint64)[:, None]
        want = np.bitwise_and((hv * a + b) % np.uint64((1 << 61) - 1),
                              np.uint64(0xFFFFFFFF)).min(axis=0)
        np.testing.assert_array_equal(row, want.astype(np.uint32))


def test_bulk_from_text_argument_checks():
    for kw in ({"out": "gpu"}, {"scheme": "nope"}, {"scheme": "oph", "hashfunc": "device"},
               {"k": 0}, {"hashfunc": len}):
        with pytest.raises(ValueError):
            MinHash.bulk_from_text([b"abcdefghijk"], device="cpu", **kw)


def test_lsh_front_ends_match_jax(corpus):
    texts, queries, docs = corpus
    ours = TorchMinHashLSH(threshold=0.5, num_perm=P, device="cpu")
    ref = TpuMinHashLSH(threshold=0.5, num_perm=P)
    for ix in (ours, ref):
        ix.index_text(range(len(texts)), texts, k=5, seed=2)
    for method in ("scan", "bands"):
        assert ours.top_k_text(queries, 5, shingle_k=5, seed=2, method=method) == \
            ref.top_k_text(queries, 5, shingle_k=5, seed=2, method=method)
        assert ours.query_text(queries, shingle_k=5, seed=2, method=method,
                               return_scores=True) == \
            ref.query_text(queries, shingle_k=5, seed=2, method=method, return_scores=True)
    with pytest.raises(ValueError, match="equal length"):
        ours.index_text([1, 2], texts[:1])
    ours = TorchMinHashLSH(threshold=0.5, num_perm=P, device="cpu")
    ref = TpuMinHashLSH(threshold=0.5, num_perm=P)
    for ix in (ours, ref):
        ix.index_tokens(["d%d" % i for i in range(len(docs))], docs, seed=3)
    q_docs = docs[160:]
    for method in ("scan", "bands"):
        assert ours.top_k_tokens(q_docs, 4, seed=3, method=method) == \
            ref.top_k_tokens(q_docs, 4, seed=3, method=method)
        assert ours.query_tokens(q_docs, seed=3, method=method) == \
            ref.query_tokens(q_docs, seed=3, method=method)


def test_bbit_front_ends_match_jax(corpus):
    texts, queries, docs = corpus
    ours = TorchBBitIndex(b=4, num_perm=P, device="cpu")
    ref = TpuBBitIndex(b=4, num_perm=P)
    for ix in (ours, ref):
        ix.insert_text(list(range(len(texts))), texts, k=5, seed=2)
        ix.insert_tokens(["d%d" % i for i in range(len(docs))], docs, seed=2)
    q_sigs = MinHash.bulk_from_text(queries, k=5, num_perm=P, seed=2, hashfunc="device",
                                    device="cpu")
    assert ours.query_batch(q_sigs, 6, return_scores=True) == \
        ref.query_batch(q_sigs, 6, return_scores=True)
    q_tok = MinHash.bulk_signatures(docs[170:], num_perm=P, seed=2, hashfunc="device",
                                    device="cpu")
    assert ours.query_batch(q_tok, 6) == ref.query_batch(q_tok, 6)
    for call in (lambda: ours.insert_text([1], []), lambda: ours.insert_tokens([1], [])):
        with pytest.raises(ValueError, match="equal length"):
            call()
