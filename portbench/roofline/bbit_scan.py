"""The b-bit top-k scan (kernel 5, ``csrc/bbit.cu``, under the running
top-k of ``ops/bbit_ops.py::bbit_topk_scan``): per call, every query's
packed slots against every stored row's, once.

Work of a call of Q queries over N rows of W packed words (slots of s
bits, 32 / s a word), whatever implements it on the integer pipes:

- per (query, row, word) 4 operations: the XOR of the two words and the
  mask of each slot's low bit (logic operations issue only on the INT32
  pipe: ``alu``), a popcount of the mask and the count's add. peaks.json
  has no pipe of the popcount's own; it and the add are counted where
  they bind least (``either``), so the count stays a floor whatever
  reduces the bits (the POPC unit, or carry-save trees of logic
  operations, each slower). A scan of binary matrix products on the
  tensor cores would be other work, against another peak.
- bytes: the N x W table and the Q x W queries read once (4 bytes a
  word), and the Q x k (id, count) answers written.

At Q 1,024, N 2**24, W 4 (b 1, num_perm 128) this bounds a call at
8.217 ms: the 2**38 operations over the 128 issue lanes x 132 SMs x
1,980 MHz, and as much from the 2**37 logic operations over the INT32
pipe's 64 lanes; the bytes take 0.08 ms.

A call is counted where the traffic asks ``top_k`` by ``scan`` of a b-bit
index (the ``minhash_bbit`` driver's configurations). ``KERNELS`` names
kernel 5 and the names kept for a b-bit scan that holds the top-k in the
kernel (a scan and its merge), so that the share keeps reading when such a
kernel takes kernel 5's place.
"""

KERNELS = ("bbit_kernel", "bbit_scan_kernel", "bbit_merge_kernel")
OPS_PER_WORD = 4
LOGIC_PER_WORD = 2
SLOT_SIZES = (1, 2, 4, 8, 16, 32)


def slot_size(b: int) -> int:
    """Storage bits of a slot: the least of ``SLOT_SIZES`` that holds b."""
    return next(s for s in SLOT_SIZES if s >= b)


def counts(config: dict, traffic: dict, units: int):
    if config.get("driver") != "minhash_bbit":
        return None
    if traffic.get("op") != "top_k" or traffic.get("method") != "scan":
        return None
    q, n = units, config["rows"]
    w = -(-config["num_perm"] // (32 // slot_size(config["b"])))
    words = q * n * w
    return {"alu": LOGIC_PER_WORD * words,
            "either": (OPS_PER_WORD - LOGIC_PER_WORD) * words,
            "bytes": 4 * (n * w + q * w) + 8 * q * traffic["k"]}
