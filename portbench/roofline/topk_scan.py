"""Kernel 2, the exact-scan top-k (``csrc/lsh_scan.cu``: the scan and its
split merge): per call, every query's slots against every row's.

Work of a call of Q queries over N rows of P slots:

- Q x N x P equal-slot compares. A 32-bit equality compare issues only on
  the INT32 pipe (``alu``); the count's add may issue on either pipe.
- bytes: the N x P table and the Q x P queries read once (4 bytes a
  slot), and the Q x 128 (id, score) candidates of at most 128 written.

At Q 1,024, N 1,048,576, P 128 this bounds a call at 8.217 ms (the
compares over 64 lanes x 132 SMs x 1,980 MHz); the bytes take 0.16 ms.

A call is counted where the traffic asks ``top_k`` by ``scan`` with k of
at most 128, the calls that kernel 2 alone serves (a larger k runs kernel
4; a threshold scan may rerun at a larger k, which its answers decide).
"""

KERNELS = ("topk_scan_kernel", "topk_merge_kernel")
MAX_K = 128


def counts(config: dict, traffic: dict, units: int):
    if traffic.get("op") != "top_k" or traffic.get("method") != "scan":
        return None
    if traffic["k"] > MAX_K:
        return None
    q, n, p = units, config["rows"], config["num_perm"]
    compares = q * n * p
    return {"alu": compares, "either": compares, "bytes": 4 * (n * p + q * p) + 8 * q * 128}
