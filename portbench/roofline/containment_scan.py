"""The containment scan of an LSH Ensemble (kernel 2's sizes mode,
``csrc/lsh_scan.cu``: the scan and its split merge; kernel 4,
``csrc/score.cu``, under the running top-k past k = 128): per call, every
query against every stored set, once.

Work of a call of Q queries over N stored sets of P slots, whatever
implements it:

- Q x N x P equal-slot compares. A 32-bit equality compare issues only on
  the INT32 pipe (``alu``); the count's add may issue on either pipe.
- the f32 estimate of each (query, set): j = count x 1/P, x + q,
  j x (x + q), 1 + j, (1 + j) x q and the divide: 6 operations (``f32``).
- bytes: the N x P table and its N sizes, the Q x P queries and their Q
  sizes read once (4 bytes each), and per query its match count and the
  first pass's 16 (id, estimate) slots written.

A pass that reruns at a larger k scans the same pairs again: reruns are
time, not work, so the share falls when a batch reruns and cannot pass
100 %. At Q 1,024, N 1,048,576, P 128 this bounds a call at 8.217 ms (the
compares over 64 lanes x 132 SMs x 1,980 MHz), as kernel 2's plain count.

A call is counted where the traffic asks ``query_batch`` by ``scan`` of a
containment index (the ``minhash_ensemble`` driver's configurations).
"""

KERNELS = ("topk_scan_kernel", "topk_merge_kernel", "score_kernel")
F32_OPS = 6
FIRST_K = 16


def counts(config: dict, traffic: dict, units: int):
    if config.get("driver") != "minhash_ensemble":
        return None
    if traffic.get("op") != "query_batch" or traffic.get("method") != "scan":
        return None
    q, n, p = units, config["rows"], config["num_perm"]
    compares = q * n * p
    return {"alu": compares, "either": compares, "f32": F32_OPS * q * n,
            "bytes": 4 * (n * p + n + q * p + q) + q * (4 + 8 * FIRST_K)}
