"""Port parity: signatures (kernel 1's plain version and the ops around it)
against the JAX package's compute_signatures, its Pallas signature kernel
in interpret mode, and MinHash.bulk_signatures -- exact equality."""

import numpy as np
import pytest
import torch

from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu.ops import minhash_ops as jax_ops
from datasketch_tpu.ops import pallas_kernels
from datasketch_tpu_torch import MinHash
from datasketch_tpu_torch.device import to_numpy_u32
from datasketch_tpu_torch.ops import minhash_ops

torch.set_num_threads(2)

P = 128


def _hashes(b, t, seed):
    rng = np.random.RandomState(seed)
    hashes = rng.randint(0, 1 << 32, size=(b, t), dtype=np.uint64).astype(np.uint32)
    lengths = rng.randint(0, t + 1, size=b).astype(np.int32)
    lengths[:2] = 0  # empty docs stay MAX_HASH
    return hashes, lengths


def _port_padded(hashes, lengths, seed, mix=False):
    out = minhash_ops.compute_signatures(
        torch.from_numpy(hashes.view(np.int32)), torch.from_numpy(lengths), seed, P,
        mix=mix,
    )
    return to_numpy_u32(out)


def test_init_permutations_bit_identical():
    for seed in (1, 7):
        for ours, theirs in zip(minhash_ops.init_permutations(seed, P),
                                jax_ops.init_permutations(seed, P)):
            np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("b,t,mix", [(16, 128, False), (8, 256, True)])
def test_compute_signatures_matches_jax_and_pallas(b, t, mix):
    hashes, lengths = _hashes(b, t, b + t)
    got = _port_padded(hashes, lengths, 1, mix=mix)
    want = np.asarray(jax_ops.compute_signatures(hashes, lengths, 1, P, mix=mix))
    np.testing.assert_array_equal(got, want)
    limbs = [np.asarray(x) for x in jax_ops.perm_limbs(1, P)]
    pallas = np.asarray(pallas_kernels.sign_batch_pallas(
        hashes, lengths, *limbs, interpret=True, mix=mix))
    np.testing.assert_array_equal(got, pallas)
    assert (got[:2] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("dtype,mix", [
    (np.uint32, False), (np.uint32, True), (np.uint8, True), (np.uint16, True),
])
def test_compute_signatures_ragged_matches_jax(dtype, mix):
    rng = np.random.RandomState(5)
    lengths = rng.randint(0, 90, size=40).astype(np.int32)
    lengths[[0, 17]] = 0
    hi = np.iinfo(dtype).max if dtype != np.uint32 else (1 << 32) - 1
    flat = rng.randint(0, int(hi) + 1, size=int(lengths.sum()), dtype=np.uint64).astype(dtype)
    got = minhash_ops.compute_signatures_ragged(
        torch.from_numpy(flat), torch.from_numpy(lengths), 3, P, mix=mix
    )
    want = np.asarray(jax_ops.compute_signatures_ragged(flat, lengths, 3, P, mix=mix))
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_compute_signatures_explicit_permutations():
    hashes, lengths = _hashes(8, 128, 2)
    perms = jax_ops.init_permutations(9, P)
    got = minhash_ops.compute_signatures(
        torch.from_numpy(hashes.view(np.int32)), torch.from_numpy(lengths), 1, P,
        permutations=perms,
    )
    want = np.asarray(jax_ops.compute_signatures(hashes, lengths, 1, P, permutations=perms))
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_jaccard_and_merge_match_jax():
    rng = np.random.RandomState(4)
    a = rng.randint(0, 6, size=(9, P)).astype(np.uint32)
    b = rng.randint(0, 6, size=(9, P)).astype(np.uint32)
    b[0, 0] = 0xFFFFFFF0  # unsigned order in the merge
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    np.testing.assert_array_equal(
        minhash_ops.jaccard_pairwise(ta, tb).numpy(),
        np.asarray(jax_ops.jaccard_pairwise(a, b)))
    np.testing.assert_array_equal(
        minhash_ops.jaccard_matrix(ta, tb[:5]).numpy(),
        np.asarray(jax_ops.jaccard_matrix(a, b[:5])))
    np.testing.assert_array_equal(
        to_numpy_u32(minhash_ops.merge_signatures(ta, tb)),
        np.asarray(jax_ops.merge_signatures(a, b)))


def _bytes_corpus(n_docs, seed):
    rng = np.random.RandomState(seed)
    vocab = [bytes(rng.randint(0, 256, size=10, dtype=np.uint8)) for _ in range(400)]
    return [[vocab[j] for j in rng.randint(0, 400, size=rng.randint(0, 70))]
            for _ in range(n_docs)]


def test_bulk_signatures_sha1_matches_jax():
    docs = _bytes_corpus(60, 1)
    docs[3] = []
    got = MinHash.bulk_signatures(docs, num_perm=P, seed=1, device="cpu")
    want = JaxMinHash.bulk_signatures(docs, num_perm=P, seed=1)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    dev = MinHash.bulk_signatures(docs, num_perm=P, seed=1, out="device", device="cpu")
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy_u32(dev), want)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint8])
def test_bulk_signatures_device_ids_match_jax(dtype):
    rng = np.random.RandomState(2)
    hi = 250 if dtype == np.uint8 else 90000
    docs = [rng.randint(0, hi, size=rng.randint(0, 50)).astype(dtype) for _ in range(30)]
    got = MinHash.bulk_signatures(docs, num_perm=P, seed=5, hashfunc="device",
                                  device="cpu")
    want = JaxMinHash.bulk_signatures(docs, num_perm=P, seed=5, hashfunc="device")
    np.testing.assert_array_equal(got, want)


def test_bulk_signatures_rejects_unported_options():
    with pytest.raises(ValueError):
        MinHash.bulk_signatures([[b"a"]], scheme="nope", device="cpu")
    with pytest.raises(ValueError):
        MinHash.bulk_signatures([[b"a"]], hashfunc="nope", device="cpu")


def test_empty_signatures_and_pad_token_hashes_match_jax():
    got = minhash_ops.empty_signatures(3, 7, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(to_numpy_u32(got), np.asarray(jax_ops.empty_signatures(3, 7)))
    rng = np.random.RandomState(3)
    ragged = [rng.randint(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
              for n in (0, 5, 130, 1)]
    for arrays, pad in ((ragged, 128), (ragged, 7), ([], 128), ([ragged[0]], 16)):
        for g, w in zip(minhash_ops.pad_token_hashes(arrays, pad),
                        jax_ops.pad_token_hashes(arrays, pad)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
