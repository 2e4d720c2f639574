"""Port parity: permute_hash and mix32 on int64 torch tensors against
NumPy uint64 and the JAX package's uint32-limb forms, bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from datasketch_tpu.ops import hashing as jax_hashing
from datasketch_tpu.ops import u64
from datasketch_tpu_torch.ops import hashing

torch.set_num_threads(2)

P = np.uint64(u64.MERSENNE_PRIME)
MAXH = np.uint64(u64.MAX_HASH)


def _edge_cases():
    """(h, a, b) triples at the arithmetic's edges, plus random ones."""
    rng = np.random.RandomState(7)
    n = 2048
    h = rng.randint(0, 1 << 32, size=n, dtype=np.uint64)
    a = rng.randint(1, u64.MERSENNE_PRIME, size=n, dtype=np.uint64)
    b = rng.randint(0, u64.MERSENNE_PRIME, size=n, dtype=np.uint64)
    edges_h = np.array([0, 1, 2**32 - 1, 2**32 - 1, 12345, 2**31, 7, 2**32 - 1],
                       dtype=np.uint64)
    edges_a = np.array([2**61 - 2, 2**61 - 2, 2**61 - 2, 1, 1, 2**61 - 3, 1, 3],
                       dtype=np.uint64)
    # b chosen so a*h + b is 0, p, 2p (multiples of p map to 0, as numpy's %)
    edges_b = np.array([0, P - np.uint64(2**61 - 2), 2**61 - 2, P - np.uint64(2**32 - 1),
                        2 * P - np.uint64(12345), 2**61 - 2, P - np.uint64(7),
                        5], dtype=np.uint64)
    return (np.concatenate([h, edges_h]), np.concatenate([a, edges_a]),
            np.concatenate([b, edges_b]))


def _i64(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.uint64).view(np.int64).copy())


def test_permute_hash_matches_numpy_and_jax():
    h, a, b = _edge_cases()
    want = np.bitwise_and((a * h + b) % P, MAXH)
    got = hashing.permute_hash(_i64(h), _i64(a), _i64(b)).numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, want)
    ah, al = u64.split_u64(a)
    bh, bl = u64.split_u64(b)
    jax_got = np.asarray(u64.permute_hash(
        jnp.asarray(h.astype(np.uint32)), jnp.asarray(ah), jnp.asarray(al),
        jnp.asarray(bh), jnp.asarray(bl),
    ))
    np.testing.assert_array_equal(got.astype(np.uint32), jax_got)


def test_permute_hash_broadcasts_tokens_against_permutations():
    rng = np.random.RandomState(3)
    h = rng.randint(0, 1 << 32, size=(5, 33), dtype=np.uint64)
    a = rng.randint(1, u64.MERSENNE_PRIME, size=128, dtype=np.uint64)
    b = rng.randint(0, u64.MERSENNE_PRIME, size=128, dtype=np.uint64)
    want = np.bitwise_and((h[..., None] * a + b) % P, MAXH)
    got = hashing.permute_hash(_i64(h)[..., None], _i64(a), _i64(b))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


@pytest.mark.parametrize("values", [
    np.array([0, 1, 2**16, 2**31, 2**32 - 1], dtype=np.uint64),
    np.random.RandomState(11).randint(0, 1 << 32, size=4096, dtype=np.uint64),
])
def test_mix32_matches_numpy_and_jax(values):
    got = hashing.mix32(_i64(values)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, jax_hashing.mix32_np(values.astype(np.uint32)))
    jax_got = np.asarray(jax_hashing.mix32(jnp.asarray(values.astype(np.uint32))))
    np.testing.assert_array_equal(got, jax_got)
