"""Kernel 1, MinHash signatures (``csrc/minhash_sign.cu``): per document,
the least of ``((a_j * h + b_j) mod 2**64) mod (2**61 - 1)``, cut to 32
bits, over its token hashes h, for each permutation j.

The 32-bit operations any implementation needs for one (token,
permutation) pair, a < 2**61 held as two words and h one word:

- 3 multiplies, each with its add fused: the low and high words of
  a_lo * h (+ b), the low word of a_hi * h (+ the high word). Integer
  multiplies issue only on the FMA-heavy pipe (``imad``).
- the fold (s & p) + (s >> 61) and the one conditional subtraction,
  kept to the low word: the shift of the high word, the masked high
  word (``alu``), the low word's add with its carry out, the high word's
  add of that carry, the shift that tests y + 1 >= 2**61 (``alu``), and
  the low word's correction (adds: ``either``): 2 + 2 + 1 + 1 = 6.
- the running min (``alu``).

10 operations, 4 on the INT32 pipe only, 3 on the multiplier only, 3 on
either: the SM's 128 issue lanes bind (10 / 128 > 4 / 64 > 3 / 64).
Bytes: each token's 4-byte hash read once, each document's offset and
length, (a, b), and the 4 x P-byte signature written.

A call is counted where the traffic asks ``bulk_signatures`` of byte
tokens (hashed on the host): ``units`` documents of the configuration's
``corpus.tokens_per_doc`` tokens each.

At 8,192 documents x 200 tokens x 128 permutations a call is bounded at
0.0627 ms. The smoke's earlier count (8 integer operations over the
INT32 pipe's 64 lanes, 0.1003 ms) put today's kernel at 84 % and one a
tenth faster past 100 %: it was not a bound, because the multiplies and
adds also issue on the FMA-heavy pipe.
"""

KERNELS = ("minhash_sign_kernel",)


def counts(config: dict, traffic: dict, units: int):
    if traffic.get("op") != "bulk_signatures" or traffic.get("tokens") != "bytes":
        return None
    docs, p = units, config["num_perm"]
    tokens = docs * config["corpus"]["tokens_per_doc"]
    pairs = tokens * p
    return {
        "alu": 4 * pairs,
        "imad": 3 * pairs,
        "either": 3 * pairs,
        "bytes": 4 * tokens + 12 * docs + 16 * p + 4 * docs * p,
    }
