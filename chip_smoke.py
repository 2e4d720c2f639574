#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: MinHash -> LSH serving,
its host failover and the host LSH classes, LSH Ensemble containment
serving, weighted MinHash (CWS) serving, b-bit MinHash serving, the
raw-text front ends, LSH Forest serving, the rest of the LSH facade, the
per-object MinHash API, HyperLogLog, the OPH and C-MinHash schemes,
LSHBloom, HNSW, and the sharded classes of ``parallel/`` on a mesh of
positions on the card and across child processes.

Usage, from the root of a checkout, on a machine with one CUDA card of
capability >= 9.0 (Hopper):

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. environment: torch / CUDA versions, the card, its power limit;
2. build: the CUDA kernels (nvcc) and the host SHA1 module (g++);
3. kernel parity: each kernel (kernel 2 in its plain and its sizes mode)
   against its plain PyTorch version on the same CUDA tensors, exact, at
   the main paths' shapes and ragged edges (kernel 2 also at P 66 and 100,
   Q 1, 33 and 1,000, k 1 and 128, and a table scanned in one split;
   kernel 4 at P 66, 100 and 128, Q 1, 33 and 1,000, T 1 to 8,192 around
   the 64-row tile, one split and many, and the k = 256 scan and k = 2,048
   containment rerun on it; kernel 3 at P 66, 100, 128, 512 and 600 and C
   1, 31, 32, 33, 333 and 3,200 with -1 and duplicated slots; kernel 6 at S
   1 to 1,030 and D 1, 333, 10,000 and 10,001 with fully dense rows and ties
   across chunks and segments; kernel 7 on rows whose entry order matters,
   at S 1, 6, 100 and 128, flat and padded),
   timed with CUDA events, with each timed call's bound (the largest of
   bytes over 3.35 TB/s, integer operations over the integer ALU rate and
   f32 operations over 67 TFLOP/s) and, where one PyTorch call computes
   the same function, that call's time; kernel 5 at every slot size,
   num_perm 128, 100 and 256 and ragged shapes, and timed at Q 1,024 x T
   1,048,576 at b = 1 and b = 4 beside ``torch.cdist(p=0)``;
4. signatures: ``MinHash.bulk_signatures`` over the bench corpus (16,384
   docs x 200 SHA1 tokens), checked against the plain version and a host
   numpy evaluation of the reference formula;
5. index: a 1,048,576-row ``TorchMinHashLSH`` (the signatures plus
   planted near-duplicates);
6. serving: 1,024-query ``top_k`` (scan, bands, auto; k = 10 and 256),
   threshold ``query_batch`` (bands, scan, and a scan that escalates past
   128 matches), then 1,000 removals and the queries again;
6a. failover-1m: the served index (its removals included) behind
    ``FailoverIndex(monitor=HealthMonitor(max_failures=1))``: a real
    subprocess probe of the card (must be ok), the 1,024 queries through
    the wrapper (top_k k = 10 scan and bands, query_batch 0.5 scan, top_k k
    = 256 scan) on the device, equal to the index's own answers, with
    kernels 2, 3 and 4's launches read around them alone; a real failed
    probe of ``cuda:<device_count>`` trips it; 16 queries answered from the
    host snapshot launch no kernel and agree with the device's (score
    columns equal, ids above the k-th score equal, threshold answers equal,
    no removed key); ``resume_device()`` returns to the device;
6b. host-lsh-262k: the index's first 262,144 rows in the host
    ``MinHashLSH`` (``insert_batch``) and a ``rerank=False``
    ``TorchMinHashLSH``; 1,024 edited signature-corpus docs signed on the
    card (kernel 1) and 16 near-copies of row 0 by ``query_batch``: every
    host answer a subset of the device's, the source in both, nothing
    truncated; 16,384 rows in an ``AsyncMinHashLSH`` on ``aiodict`` equal
    to the host class; on the served index's tables ``topk_fused`` by
    direct address (``build_offsets``, kernel 3); the launch counts are
    read around these calls alone, then the checks run: the query docs
    re-signed by kernel 1's plain twin equal the card's signatures, and
    the direct route equals the binary search for every query whose
    windows fit;
7. facade parity: a 65,536-row CUDA index against a ``device="cpu"`` one,
   and an index built from rows of a device tensor (a list, then single
   inserts) queried by lists of device rows against the batch index;
8. launch counts of kernels 1-4 during phases 4-6 (each must be > 0);
9. ensemble: 1,048,576 integer-token sets (lognormal sizes around 120,
   Zipf(0.8) ids over 50,000) indexed by ``TorchMinHashLSHEnsemble.
   index_tokens`` (threshold 0.8, 8 partitions), 1,024 subset queries by
   scan, bands and auto, with the launch counts of kernels 1, 2 (sizes
   mode) and 4 read around it (each must be > 0); then the scan's answer
   for 64 queries against the plain version at full size, its truncation
   count against exact match counts, and a small CUDA ensemble against a
   ``device="cpu"`` one;
10. weighted-1m: 1,048,576 CSR rows at dim 10,000 (about 2 % dense,
    ``bench.py::bench_cws``'s law, drawn on the card) sketched by
    ``WeightedMinHashGenerator.minhash_many`` (kernel 7; 1,024 sampled rows
    against a ``device="cpu"`` generator, and the first 16,384 rows
    densified through kernel 6 against the CSR result), indexed in a
    ``TorchMinHashLSH``, and 1,024 perturbed-row queries served by
    ``top_k`` (scan, bands) and threshold ``query_batch`` (bands), with the
    launch counts of kernels 6, 7, 2 and 3 read around it (each must be
    > 0); then ``kt_slots`` on the card against the host mix on 1M pairs,
    and an 8,192-set CUDA ensemble built from (k, t) batches against a
    ``device="cpu"`` one;
11. bbit-1m: the index phase's 1,048,576 rows in a ``TorchBBitIndex`` at
    b = 1 and b = 4 (``insert_batch`` of the int32 device tensor), 1,024
    planted queries by ``query_batch`` k = 10 (recall >= 0.99), 64 of them
    against the plain version on the card, 16 scores against
    ``bBitMinHash.jaccard``, 1,000 removals, save / load, the status, with
    kernel 5's launches read around it;
12. bbit-16m: 16,777,216 rows at b = 1 drawn on the card in 1,048,576-row
    chunks (``benchmarks/scale_benchmark.py::synth_signatures``' law), each
    inserted as a device tensor, 1,024 planted queries (recall >= 0.98), 16
    of them against the plain version;
13. text-16k: the signature corpus as raw texts, ``MinHash.bulk_from_text``
    (k = 9) with the on-card and the SHA1 engine against ``device="cpu"``
    runs (and SHA1 against ``hashlib``), ``TorchMinHashLSH.index_text`` /
    ``top_k_text`` (scan, bands) and ``TorchBBitIndex.insert_text`` /
    ``query_batch`` on texts with their last 100 bytes replaced (recall >=
    0.99 each), and ``index_tokens`` / ``top_k_tokens`` against a
    ``device="cpu"`` index, with kernels 1, 2 and 3's launches read around
    it;
14. forest-1m: the index phase's 1,048,576 rows in a
    ``TorchMinHashLSHForest`` (num_perm 128, l 8, cap 64), 1,024 planted
    queries at k 10 by the prefix walk (rank 'forest', and rank 'jaccard'
    with pool 512), the scan and 'auto' (scan recall >= 0.99), a k 256 scan
    (kernel 4), with kernels 2, 3 and 4's launches read around it; then 64
    queries against the forest ops run with the kernels' plain twins, a
    65,536-row CUDA forest against a ``device="cpu"`` one, and save / load;
15. forest-16k: ``bench.py::bench_forest``'s forest (cascade 256, pool 512,
    rank 'jaccard') over sign-16k's docs sketched at num_perm 256, 256-query
    batches by ``query_batch`` and ``query_stream(depth=4)`` against a
    ``device="cpu"`` forest;
16. facade-2: a cascade-256 ``TorchMinHashLSH`` over the same rows, built
    by ``merge``, against a ``device="cpu"`` one: bands, scans, threshold,
    removals and ``compact``, ``query_b``, a card checkpoint loaded on the
    CPU, and the streams against the batch calls (the ensemble's
    ``query_stream`` runs in phase 9);
17. minhash-objects: ``MinHash.update_batch`` of 64 docs on the card
    (kernel 1) against the host path, ``MinHash.bulk``, ``LeanMinHash``
    bytes, ``union`` / ``merge`` / ``count``;
18. hll: ``bench.py::bench_hll``'s configuration (``HyperLogLogPlusPlus``
    p 14, 2,048 docs x 512 tokens) on the host path, its 131,072-unique
    stream (relative error < 0.03) and its ids path; then
    ``bulk_registers`` of 65,536 docs x 512 ids (seed 23, over 2**24) on the
    card (``hashfunc="device"``, an int8[65,536, 16,384] register matrix)
    with 1,024 sampled rows against the host path, ``hll_ops.count_batch``
    on the card against the CPU and float64 (rtol 1e-5), the ``merge_regs``
    fold against one sketch of the union, and ``HyperLogLog.update_batch``
    on the card against the host; ``hll_ops``' device calls must grow;
19. schemes: ``scheme="oph"`` and ``"cminhash"`` through
    ``MinHash.bulk_signatures`` over the signature corpus (2,048 docs
    against ``device="cpu"``; beside the permutation scheme's rate), a
    ``TorchMinHashLSH`` built by ``index_tokens(scheme=)`` over 262,144
    docs x 200 ids (seed 29, over 2**20) and served by ``top_k`` k = 10
    (scan and bands, recall >= 0.99) to 1,024 queries with 10 % of their
    ids replaced, and a 4,096-doc CUDA index against a ``device="cpu"``
    one, with kernels 1, 2 and 3's launches read around it;
20. bloom: a ``TorchMinHashLSHBloom`` (threshold 0.8, n 100,000,000, fp
    0.01: b 9, r 13, 1.0 GiB of words on the card) holding the index
    phase's 1,048,576 rows, inserted in 4 batches and all queried back,
    1,024 fresh signatures (hits <= b x fp), and a 65,536-row filter at n
    1,000,000 against a ``device="cpu"`` one word for word, saved on the
    card and loaded on the card and on the CPU;
21. hnsw-1m: 1,048,576 token sets of ``bench_hnsw``'s clustered law
    (``benchmarks/utils.py::generate_sets``, drawn on the card, seed 41) in
    a ``TorchHNSW(minhash_jaccard, m 16, ef 64)`` by ``index_tokens``
    (kernel 1 signs, kernel 2 finds each node's 48 nearest rows), 1,024
    corpus members queried by ``query_batch`` and ``query_stream`` (4
    batches, depth 4), with kernels 1 and 2's launches read around the build
    and the queries alone; then recall@10 against kernel 2's exact scan
    (floor 0.5, a guard), the signatures of 4,096 sampled sets against the
    plain signer on the CPU and their kNN rows against the plain distance
    tiles, 64 answers against the same graph on the CPU, 2,048 adds and a
    flush (the append path) and 1,000 removals;
22. hnsw-16k: ``bench_hnsw``'s protocol (16,384 sets, 256-query batches),
    its launches read around the build and the queries alone; then a
    ``device="cpu"`` ``index_tokens`` over the same sets against it
    (signatures, adjacency, levels, entry, answers), ``HNSW.from_points`` of
    2,048 points on the card against the CPU, ``from_hnsw`` and a save /
    load round trip;
23. hnsw-65k-l2: 65,536 x 128 float32 points in Gaussian clusters of 16
    (seed 31) under ``l2`` (plain distance tiles), 1,024 queries, recall@10
    against a float64 brute force; 8,192 integer-valued points built on the
    card and on the CPU, equal;
24. hnsw m 48: 8,192 signature rows whose 144 candidates a node take kernel
    4's route (its launches read around the build alone), equal to the
    plain tiles;
25. sharded-lsh-1m (after phase 6b): the served index's 1,048,576 device rows
    in a ``ShardedMinHashLSH(threshold 0.5)`` over 4 mesh positions on the
    card, the served index's 1,000 removals, the 1,024 queries by ``top_k``
    k 10 (scan, bands, auto) and k 256 (scan), ``query_batch`` 0.5 (bands,
    scan), ``top_k_stream``, ``compact``, ``status``, ``save`` and ``load``
    onto 2 positions, kernels 2, 3 and 4 counted around it; then the scans
    against the unsharded index (score columns, ids above the k-th score,
    threshold lists while nothing is truncated), the bands against the same
    class on the CPU over 65,536 rows (answers and ``last_truncated``), the
    reloaded index's answers, and ``FailoverIndex`` over the sharded index
    (device path, a real failed probe, 16 host answers equal the device's);
26. sharded-sketch: ``sharded_compute_signatures`` of sign-16k's corpus on a
    (2, 2) mesh (kernel 1 per block) against ``MinHash.bulk_signatures`` and
    the plain signer, ``distributed_minhash_union`` and
    ``distributed_hll_union`` over the 4 positions against numpy's min and
    max;
27. sharded-bbit, sharded-forest, sharded-bloom: ``ShardedBBitIndex`` b 1 and
    ``ShardedMinHashLSHForest`` (l 8, cap 64) over lsh-1m's rows,
    ``ShardedMinHashLSHBloom`` (n 100M, fp 0.01) holding its first 262,144,
    each over 4 positions with 1,024 queries, its launches read around it,
    then the same class on the card and on the CPU at a cut size, equal;
28. sharded-2proc: two child processes (``chip_smoke.py --sharded-worker``)
    in a gloo group, 2 positions each on the card, over host-lsh-262k's rows:
    collectives, a ``ShardedMinHashLSH`` equal to the 4-position mesh in one
    process, save -> barrier -> load onto 3 positions; then one child in a
    one-rank NCCL group (``distributed_minhash_union``, one ``top_k``);
29. sharded-ensemble (after phase 9's path): ``ShardedMinHashLSHEnsemble``
    (threshold 0.8, 8 partitions) over 4 positions by ``index_tokens`` of
    ensemble-1m's sets, its queries by scan and bands, then the card against
    the CPU at 8,192 sets;
30. sharded-hnsw (after phase 24): ``ShardedHNSW(minhash_jaccard, m 16, ef
    64)`` over 4 positions by ``index_tokens`` of hnsw-1m's first 262,144
    sets (4 graphs of 65,536), 1,024 members as queries, then the card
    against the CPU at 4,096 sets.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a usable card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

NUM_PERM = 128
TOKENS_PER_DOC = 200
SIG_DOCS = 16384
N_INDEX = 1 << 20
N_QUERIES = 1024
TOP_K = 10
BIG_K = 256
N_REMOVE = 1000
N_NEAR = 300  # near-copies of one doc: a threshold scan with > 128 matches
PARITY_ROWS = 65536
PARITY_QUERIES = 256
ENS_SETS = 1 << 20
ENS_QUERIES = 1024
ENS_PLAIN_QUERIES = 64  # scan answers held against the plain version
ENS_PARITY_SETS = 8192
ENS_THRESHOLD = 0.8
W_ROWS = 1 << 20
W_DIM = 10000
W_SAMPLES = 128
W_QUERIES = 1024
W_TOP_K = 5
W_CPU_ROWS = 1024  # rows held against a device="cpu" generator
W_DENSE_ROWS = 16384  # rows densified through kernel 6
# kernel 7's edges (phase_kernels_cws_blocks), (rows, D, S): one row and one
# sample; row counts one off a power of two (511, 513, 65,537); D not a
# multiple of 64 (333, 10,001); S not a multiple of 4 (1, 6, 129, 1,030) or
# of 32 (100), and past one warp's 128 samples (129, 256, 1,030)
CWS_BLOCK_SHAPES = ((513, 10001, 128), (1, 10001, 1), (511, 333, 6), (513, 10001, 100),
                    (1100, 333, 129), (600, 333, 256), (300, 333, 1030), (65537, 333, 128))
W_ENS_SETS = 8192
W_SLOT_PAIRS = 1 << 20
BBIT_ROWS = 1 << 24
BBIT_CHUNK = 1 << 20
FOREST_L = 8
FOREST_CAP = 64
FOREST_POOL = 512
FOREST_BIG_K = 256  # the scan's k_pad is 256 > 128: kernel 4
FOREST_PLAIN_QUERIES = 64  # answers held against the plain twins on the card
FOREST16_PERM = 256
FOREST16_BATCH = 256
HLL_P = 14
HLL_BENCH_DOCS = 2048  # bench.py::bench_hll's corpus: docs x HLL_TOKENS b"d%d-t%d"
HLL_TOKENS = 512
HLL_STREAM = 1 << 17  # unique tokens of bench_hll's stream
HLL_DOCS = 1 << 16  # the full-size device run: docs x HLL_TOKENS ids over 2**24
HLL_SAMPLE = 1024  # rows held against a device_mode="disable" run
SCHEMES = ("oph", "cminhash")
SCH_CPU_DOCS = 2048  # sign-16k docs held against a device="cpu" run
SCH_DOCS = 1 << 18  # the schemes' index: docs x TOKENS_PER_DOC ids over 2**20
SCH_QUERIES = 1024
SCH_REPLACE = 0.1  # share of a query's ids replaced (Jaccard ~0.82 to its source)
SCH_PARITY_DOCS = 4096
BLOOM_N = 100_000_000  # designed keys: LSHBloom's 100M-document dedup corpora
BLOOM_FP = 0.01
BLOOM_THRESHOLD = 0.8
BLOOM_BATCHES = 4
BLOOM_FRESH = 1024
BLOOM_PARITY_ROWS = 1 << 16
BLOOM_PARITY_N = 1_000_000
HNSW_SETS = 1 << 20  # bench_hnsw's clustered law at 1M sets
HNSW_M, HNSW_EF = 16, 64
HNSW_QUERIES = 1024
HNSW_SAMPLE = 4096  # nodes whose kNN rows are held against the plain route
HNSW_CPU_QUERIES = 64  # answers held against the same graph on the CPU
HNSW_ADDS = 2048
HNSW_REMOVES = 1000
HNSW_RECALL_FLOOR = 0.5  # a guard against a broken graph, not a quality target
HNSW16_SETS = 16384  # bench.py::bench_hnsw's protocol
HNSW16_BATCH = 256
HNSW_PTS = 2048  # HNSW.from_points on the card against the CPU
L2_POINTS, L2_DIM, L2_CLUSTER = 65536, 128, 16
L2_CPU_POINTS = 8192
HNSW_M48_ROWS = 8192
FO_HOST_QUERIES = 16  # answered by the host scan over the 1M-row snapshot
HOST_LSH_ROWS = 1 << 18
HOST_LSH_ASYNC_ROWS = 1 << 14
HOST_LSH_CAP = 512  # above the 300 near-copies of row 0: no truncation
HOST_LSH_REPLACE = 0.02  # share of a query doc's tokens replaced (Jaccard ~0.96)
HOST_LSH_NEAR = 16  # near-copies of row 0 among the queries
SH_POSITIONS = 4  # mesh positions of the sharded phases, all on one card
SH_HLL_ROWS = 4096  # register rows of sharded-sketch's HLL union
SH_HNSW_SETS = 1 << 18  # hnsw-1m's first sets in the sharded HNSW: 4 shards of 65,536
SH_HNSW_PARITY_SETS = 4096  # held against the same class on the CPU

# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# integer ALU lanes per SM per clock (16 in each of the SM's 4 partitions);
# off the card, for a rehearsal, the H100 SXM's SMs and maximum SM clock
INT_LANES_PER_SM = 64
H100_SMS, H100_MAX_SM_MHZ = 132, 1980
# f32 operations that cannot fuse into an FMA (the CWS fold keeps the JAX
# op order, each step rounded on its own): one per FP32 lane per clock,
# 128 lanes an SM, half of PEAK_F32_OPS, which counts an FMA as two
PEAK_F32_UNFUSED_OPS = 128 * H100_SMS * H100_MAX_SM_MHZ * 1e6
# Integer ALU instructions per unit of work, read from the SASS of the
# kernels' inner loops (``tools/scan_steps.py --sass``). An equal-slot count
# (kernels 2, 2s, 3 and 4) needs one compare per (query, row, slot): kernel
# 2's loop issues 129 ISETP per 128 slots and sends the count's add to the
# FMA pipe as a predicated f32 FADD. Kernel 5's loop spends, per (query,
# row, word), 2.5 + 2 log2(s) (XOR and mask in LOP3s, a shift and an OR per
# fold, the POPC, half an IADD3).
SLOT_INT_OPS = 1.0


def bbit_word_int_ops(s: int) -> float:
    return 2.5 + 2 * math.log2(s)

KERNELS = [
    {
        "name": "minhash_sign",
        "module": "minhash_sign",
        "source": "datasketch_tpu_torch/csrc/minhash_sign.cu",
        "replaces": "datasketch_tpu/ops/pallas_kernels.py:95",
    },
    {
        "name": "topk_scan",
        "module": "lsh_scan",
        "source": "datasketch_tpu_torch/csrc/lsh_scan.cu",
        "replaces": "datasketch_tpu/ops/pallas_kernels.py:642",
    },
    {
        "name": "containment_scan",
        "module": "lsh_scan",
        "counter": "launches_sizes",
        "source": "datasketch_tpu_torch/csrc/lsh_scan.cu",
        "replaces": "datasketch_tpu/ops/pallas_kernels.py:682",
    },
    {
        "name": "rerank",
        "module": "rerank",
        "source": "datasketch_tpu_torch/csrc/rerank.cu",
        "replaces": "datasketch_tpu/ops/pallas_kernels.py:487",
    },
    {
        "name": "score_matrix",
        "module": "score",
        "source": "datasketch_tpu_torch/csrc/score.cu",
        "replaces": "datasketch_tpu/ops/pallas_kernels.py:201",
    },
    {
        "name": "bbit_scores",
        "module": "bbit",
        "source": "datasketch_tpu_torch/csrc/bbit.cu",
        "replaces": "datasketch_tpu/ops/pallas_kernels.py:536",
    },
    {
        "name": "cws_dense",
        "module": "cws",
        "source": "datasketch_tpu_torch/csrc/cws.cu",
        "replaces": "datasketch_tpu/ops/pallas_kernels.py:262",
    },
    {
        "name": "cws_sparse",
        "module": "cws",
        "counter": "launches_sparse",
        "source": "datasketch_tpu_torch/csrc/cws.cu",
        "replaces": "datasketch_tpu/ops/pallas_kernels.py:366",
    },
]
LSH_PATH = ("minhash_sign", "topk_scan", "rerank", "score_matrix")
ENSEMBLE_PATH = ("minhash_sign", "containment_scan", "score_matrix")
WEIGHTED_PATH = ("cws_sparse", "cws_dense", "topk_scan", "rerank")
BBIT_PATH = ("bbit_scores",)
TEXT_PATH = ("minhash_sign", "topk_scan", "rerank")
FOREST_PATH = ("topk_scan", "rerank", "score_matrix")
FOREST16_PATH = ("topk_scan", "rerank")
FACADE2_PATH = ("topk_scan", "rerank", "score_matrix")
MINHASH_PATH = ("minhash_sign",)
SCHEMES_PATH = ("minhash_sign", "topk_scan", "rerank")
HNSW_PATH = ("minhash_sign", "topk_scan")
HNSW_M48_PATH = ("score_matrix",)
FAILOVER_PATH = ("topk_scan", "rerank", "score_matrix")
HOST_LSH_PATH = ("minhash_sign", "rerank")
SHARDED_LSH_PATH = ("topk_scan", "rerank", "score_matrix")
SHARDED_SKETCH_PATH = ("minhash_sign",)
SHARDED_BBIT_PATH = ("bbit_scores",)
SHARDED_FOREST_PATH = ("topk_scan", "rerank", "score_matrix")
SHARDED_ENSEMBLE_PATH = ("minhash_sign", "containment_scan", "score_matrix")
SHARDED_HNSW_PATH = ("minhash_sign", "topk_scan")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


class Smoke:
    """Runs the phases on ``device`` and keeps the per-kernel record.

    The main-path phases (signatures, index, serving, facade parity) also
    run with ``device="cpu"`` at small sizes, on the kernels' plain
    versions: ``tests/test_torch_smoke_phases.py`` rehearses them there.
    """

    def __init__(self, torch, device: str = "cuda"):
        self.torch = torch
        self.device = torch.device(device)
        self.record = {k["name"]: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                                   "bound_ms": None, "bound_by": None, "library_ms": None}
                       for k in KERNELS}
        self.bbit = {}  # b -> the bbit-1m figures
        self.sharded_idx = {}  # the sharded indexes' figures
        self.int_rate = int_rate(torch, self.device)

    # ----------------------------------------------------------- helpers

    def kmod(self, name: str):
        import importlib

        spec = next(k for k in KERNELS if k["name"] == name)
        return importlib.import_module("datasketch_tpu_torch.kernels." + spec["module"])

    def time_ms(self, fn, iters: int = 5, warmup: int = 1):
        """Mean ms per call from CUDA events; None (not measured) off the
        card, where the phases only rehearse."""
        from datasketch_tpu_torch.utils.profiling import cuda_time_ms

        if self.device.type != "cuda":
            return None
        return cuda_time_ms(fn, warmup=warmup, iters=iters)

    def sync(self) -> None:
        from datasketch_tpu_torch.utils.profiling import device_sync

        device_sync(self.device)

    def bound(self, name: str, nbytes: float, int_ops: float = 0.0,
              f32_ops: float = 0.0, unfused_ops: float = 0.0) -> None:
        """Record the least time the card could take for a timed call: the
        largest of ``int_ops`` over the integer ALU rate (:func:`int_rate`),
        ``f32_ops`` over the f32 peak, ``unfused_ops`` (f32 operations that
        cannot fuse) over PEAK_F32_UNFUSED_OPS and ``nbytes`` (each input
        read once, each output written once) over the memory rate."""
        t_ops = max(int_ops / self.int_rate, f32_ops / PEAK_F32_OPS,
                    unfused_ops / PEAK_F32_UNFUSED_OPS) * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        rec = self.record[name]
        rec["bound_ms"] = max(t_ops, t_bytes)
        rec["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        log("  %-13s bound %.4f ms (%.3e integer ops, %.3e f32 ops, %.3e unfused f32 ops, "
            "%.3e bytes), kernel %s ms, plain %s ms"
            % (name, rec["bound_ms"], int_ops, f32_ops, unfused_ops, nbytes, rec["ms"],
               rec["plain_ms"]))

    def compare(self, name: str, case: str, got, want) -> None:
        """Exact equality of kernel and plain outputs (tuples allowed)."""
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  "%s/%s: shape or dtype differs: %s %s vs %s %s"
                  % (name, case, tuple(g.shape), g.dtype, tuple(w.shape), w.dtype))
            if g.numel():
                if g.dtype == torch.float32:
                    err = float((g - w).abs().max())
                else:
                    err = float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                rec = self.record[name]
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
            check(torch.equal(g, w), "%s/%s: kernel and plain version differ" % (name, case))
        log("  %-13s %-34s exact" % (name, case))

    def rand_sigs(self, n: int, p: int, seed: int, values: int = 0):
        """int32[n, p] on the device from a seeded generator: full 32-bit
        patterns, or 0..values-1 (many equal slots: planted ties)."""
        torch = self.torch
        g = torch.Generator(device=self.device).manual_seed(seed)
        if values:
            return torch.randint(0, values, (n, p), generator=g, device=self.device,
                                 dtype=torch.int32)
        return torch.randint(-(1 << 31), 1 << 31, (n, p), generator=g,
                             device=self.device, dtype=torch.int32)

    def lognormal_sizes(self, n: int, seed: int):
        """int32[n] set sizes, lognormal around 120; every 17th is 0
        (a padding row)."""
        torch = self.torch
        g = torch.Generator(device=self.device).manual_seed(seed)
        x = torch.empty(n, device=self.device).log_normal_(math.log(120), 0.5, generator=g)
        x = x.to(torch.int32).clamp_min(1)
        x[::17] = 0
        return x

    def near_copies(self, rows, keep: float, seed: int):
        """Rows with a ``1 - keep`` share of slots replaced at random."""
        torch = self.torch
        g = torch.Generator(device=self.device).manual_seed(seed)
        noise = torch.randint(-(1 << 31), 1 << 31, rows.shape, generator=g,
                              device=self.device, dtype=torch.int32)
        mask = torch.rand(rows.shape, generator=g, device=self.device) < keep
        return torch.where(mask, rows, noise)

    # ------------------------------------------------------------ phases

    def phase_build(self) -> None:
        from datasketch_tpu_torch import native
        from datasketch_tpu_torch.kernels import build

        t0 = time.perf_counter()
        build.library()
        t_nvcc = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.load()
        t_gxx = time.perf_counter() - t0
        log("[build] kernels (nvcc) %.2f s, host SHA1 (g++) %.2f s" % (t_nvcc, t_gxx))
        for line in build.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    def phase_kernels(self, n_docs: int = 8192, n_ragged: int = 1001, scan=None,
                      scan_edges=None, score_edges=None, rerank_edges=None) -> None:
        """Kernel against plain version on the same tensors (kernel 1 on
        ``n_docs`` docs and ``n_ragged`` ragged ones; kernel 2's data and
        edge shapes: keyword arguments of :meth:`scan_data` and
        :meth:`phase_kernels_scan`; kernel 3's and kernel 4's edge shapes:
        of :meth:`phase_kernels_rerank` and :meth:`phase_kernels_score`)."""
        torch = self.torch
        from datasketch_tpu_torch.ops.minhash_ops import perm_tensors

        dev = self.device
        a, b = perm_tensors(1, NUM_PERM, dev)
        g = torch.Generator(device=dev).manual_seed(5)

        # kernel 1: signatures of flat ragged tokens
        k1 = self.kmod("minhash_sign")
        flat = torch.randint(-(1 << 31), 1 << 31, (n_docs * TOKENS_PER_DOC,), generator=g,
                             device=dev, dtype=torch.int32)
        lengths = torch.full((n_docs,), TOKENS_PER_DOC, dtype=torch.int32, device=dev)
        starts = torch.arange(n_docs, device=dev, dtype=torch.int64) * TOKENS_PER_DOC
        args = (flat, starts, lengths, a, b)
        self.compare("minhash_sign", "%d docs x %d tokens" % (n_docs, TOKENS_PER_DOC),
                     k1.minhash_sign(*args), k1.minhash_sign_plain(*args))
        self.record["minhash_sign"]["ms"] = self.time_ms(lambda: k1.minhash_sign(*args))
        self.record["minhash_sign"]["plain_ms"] = self.time_ms(
            lambda: k1.minhash_sign_plain(*args), iters=1)
        n_tok = n_docs * TOKENS_PER_DOC
        # per (token, permutation): the 64-bit multiply and add, the
        # Mersenne fold (and, shift, add, compare-subtract), the mask, the min
        self.bound("minhash_sign",
                   4 * n_tok + 12 * n_docs + 16 * NUM_PERM + 4 * n_docs * NUM_PERM,
                   int_ops=8.0 * n_tok * NUM_PERM)
        lens = torch.randint(0, 300, (n_ragged,), generator=g, device=dev, dtype=torch.int32)
        lens[:10] = 0
        lens[n_ragged // 2] = 2500  # longer than the kernel's token tile
        rstarts = torch.zeros(n_ragged, dtype=torch.int64, device=dev)
        rstarts[1:] = torch.cumsum(lens[:-1], 0)
        rflat = torch.randint(0, 70000, (int(lens.sum()),), generator=g, device=dev,
                              dtype=torch.int32)
        for mix in (False, True):
            args = (rflat, rstarts, lens, a, b, mix)
            self.compare("minhash_sign", "ragged %d docs, empty, mix=%s" % (n_ragged, mix),
                         k1.minhash_sign(*args), k1.minhash_sign_plain(*args))

        # kernel 2 in its plain, mask and sizes modes
        data = self.scan_data(**(scan or {}))
        self.phase_kernels_scan(data, **(scan_edges or {}))

        self.phase_kernels_rerank(data, **(rerank_edges or {}))
        self.phase_kernels_score(data, **(score_edges or {}))

    def rerank_cand(self, data: dict, c: int = 3200):
        """Kernel 3's timed candidate list over the scan table: ``c`` slots
        a query, the first third the planted source row, then random rows,
        30 % of all slots -1."""
        torch = self.torch
        g = torch.Generator(device=self.device).manual_seed(12)
        cand = torch.randint(0, data["n"], (data["nq"], c), generator=g, device=self.device,
                             dtype=torch.int32)
        cand[:, : c // 3] = data["qidx"][:, None].to(torch.int32)
        return torch.where(torch.rand(cand.shape, generator=g, device=self.device) < 0.3,
                           -1, cand)

    def phase_kernels_rerank(self, data: dict, edge_p=(66, 100, NUM_PERM, 512, 600),
                             edge_c=(1, 31, 32, 33, 333, 3200), edge_n: int = 5003,
                             edge_q: int = 37) -> None:
        """Kernel 3 against its plain version: the timed list over the scan
        table, then, at each P of ``edge_p`` and C of ``edge_c``
        (:func:`rerank_edge_case`), a query of -1 slots only, duplicated
        ids, -1 between live slots and random lists over a tie-heavy table
        (at P 100 one that starts 4 bytes past a 16-byte boundary)."""
        torch = self.torch
        k3 = self.kmod("rerank")
        db, q, n, nq = data["db"], data["q"], data["n"], data["nq"]
        cand = self.rerank_cand(data)
        c = cand.shape[1]
        self.compare("rerank", "Q=%d C=%d over N=%d" % (nq, c, n),
                     k3.rerank_scores(db, q, cand), k3.rerank_scores_plain(db, q, cand))
        self.record["rerank"]["ms"] = self.time_ms(lambda: k3.rerank_scores(db, q, cand))
        self.record["rerank"]["plain_ms"] = self.time_ms(
            lambda: k3.rerank_scores_plain(db, q, cand), iters=1)
        live = cand[cand >= 0]
        # per live (query, candidate, slot): one compare and one add; the
        # table rows read are the distinct candidates
        self.bound("rerank",
                   4 * (int(torch.unique(live).numel()) + nq) * q.shape[1] + 8 * cand.numel(),
                   int_ops=SLOT_INT_OPS * live.numel() * q.shape[1])
        for p in edge_p:
            db_e = self.rand_sigs(edge_n, p, 20 + p, values=4)
            if p == 100:  # a table 4 bytes past a 16-byte boundary
                buf = torch.empty(edge_n * p + 1, dtype=torch.int32, device=self.device)
                db_e = buf[1:].view(edge_n, p).copy_(db_e)
            q_e = self.rand_sigs(edge_q + 1, p, 21 + p, values=4)[1:]
            for ce in edge_c:
                cand_e = rerank_edge_case(torch, edge_n, edge_q, ce, self.device, seed=p + ce)
                self.compare("rerank", "P %d C %d edges" % (p, ce),
                             k3.rerank_scores(db_e, q_e, cand_e),
                             k3.rerank_scores_plain(db_e, q_e, cand_e))

    def phase_kernels_score(self, data: dict, edge_t=(1, 63, 64, 65, 8191, 8192),
                            edge_q=(1, 33, 1000), wide=(20000, 4096),
                            edge_p=(66, 100, NUM_PERM, 512, 600)) -> None:
        """Kernel 4 (``score_matrix``) against the plain version on the same
        tensors, exact: the timed shape (Q x T 8,192 of kernel 2's table,
        with its bound and ``torch.cdist(p=0)``), tie tables, each P in
        ``edge_p`` for each Q in ``edge_q`` and T in ``edge_t`` (tiles cut
        at both sides, one split and many; P 600 is the largest whose block
        fits the H100's 232,448 bytes of shared memory), the top-k k = 256
        scan at each P above 128, ``wide`` = (Q, T) where the query blocks
        alone fill the card (one split), and the k > 128 scans built on it:
        top-k k = 256 and the ensemble's k = 2,048 containment rerun against
        the running top-k over the plain version."""
        torch = self.torch
        k2 = self.kmod("topk_scan")
        k4 = self.kmod("score_matrix")
        from datasketch_tpu_torch.ops import lsh_ops

        n, nq, db, q = data["n"], data["nq"], data["db"], data["q"]
        ties, q_ties, halves, q_halves = (data[x] for x in ("ties", "q_ties", "halves",
                                                            "q_halves"))
        alive, n2 = data["alive"], data["n2"]
        tile = db[: min(n, 8192)]
        self.compare("score_matrix", "Q=%d T=%d" % (nq, tile.shape[0]),
                     k4.score_matrix(q, tile), k4.score_matrix_plain(q, tile))
        self.record["score_matrix"]["ms"] = self.time_ms(lambda: k4.score_matrix(q, tile))
        self.record["score_matrix"]["plain_ms"] = self.time_ms(
            lambda: k4.score_matrix_plain(q, tile), iters=1)
        t = tile.shape[0]
        self.bound("score_matrix", 4 * (nq + t) * NUM_PERM + 4 * nq * t,
                   int_ops=SLOT_INT_OPS * nq * t * NUM_PERM)
        # one PyTorch call with the same function: the Hamming distance
        # (cdist, p = 0) counts the differing slots, P minus the equal ones
        qd, td = q.double(), tile.double()
        dist = torch.cdist(qd, td, p=0)
        same = (NUM_PERM - dist).float() * (1.0 / NUM_PERM) == k4.score_matrix(q, tile)
        check(bool(same.all()), "cdist(p=0) does not give the score matrix")
        self.record["score_matrix"]["library_ms"] = self.time_ms(
            lambda: torch.cdist(qd, td, p=0))
        log("  score_matrix  torch.cdist(p=0) on f64 copies: %s ms"
            % self.record["score_matrix"]["library_ms"])
        del qd, td, dist, same
        self.compare("score_matrix", "Q=13 T=1000 ties",
                     k4.score_matrix(q_ties[:13], ties[:1000]),
                     k4.score_matrix_plain(q_ties[:13], ties[:1000]))
        # edge shapes on 2-valued slots (half the slots tie): P not a
        # multiple of 4 or of 64, T cut inside and at the edge of a tile
        for p in edge_p:
            d = self.rand_sigs(max(edge_t), p, 400 + p, values=2)
            qq = self.rand_sigs(max(edge_q), p, 500 + p, values=2)
            for nqe in edge_q:
                for te in edge_t:
                    self.compare("score_matrix", "P %d Q %d T %d" % (p, nqe, te),
                                 k4.score_matrix(qq[:nqe], d[:te]),
                                 k4.score_matrix_plain(qq[:nqe], d[:te]))
            if p > NUM_PERM:
                nt = d.shape[0]
                self.compare("score_matrix", "P %d scan k=%d cutoff" % (p, BIG_K),
                             lsh_ops.topk_scan(d, qq, BIG_K, nt, count_ge=0.5),
                             k2.running_topk(qq, d, BIG_K, nt, None, 0.5,
                                             k4.score_matrix_plain, 8192))
        qw = self.rand_sigs(wide[0], NUM_PERM, 600, values=3)
        self.compare("score_matrix", "Q %d T %d (query blocks fill the card)" % wide,
                     k4.score_matrix(qw, db[: wide[1]]),
                     k4.score_matrix_plain(qw, db[: wide[1]]))
        del qw
        self.compare(
            "score_matrix", "scan k=%d ties alive cutoff" % BIG_K,
            lsh_ops.topk_scan(halves, q_halves, BIG_K, n2, alive, count_ge=0.5),
            k2.running_topk(q_halves, halves, BIG_K, n2, alive, 0.5,
                            k4.score_matrix_plain, 8192),
        )
        sizes, q_sizes = data["sizes"], data["q_sizes"]
        big = 2048
        self.compare(
            "score_matrix", "containment k=%d rerun cutoff %.1f" % (big, ENS_THRESHOLD),
            lsh_ops.containment_scan(db, sizes, q[:64], q_sizes[:64], ENS_THRESHOLD, big),
            k2.running_topk(q[:64], db, big, n, None, ENS_THRESHOLD, k4.score_matrix_plain,
                            8192, sizes=sizes, q_sizes=q_sizes[:64]),
        )

    def scan_data(self, n: int = N_INDEX, nq: int = N_QUERIES, n2: int = 100003,
                  nq2: int = 77, p: int = NUM_PERM) -> dict:
        """Kernel 2's inputs on the device: the timed table (``n`` random
        rows of ``p`` slots, ``nq`` near-copy queries, lognormal sizes) and
        the tie tables (``n2`` rows of 4- and 2-valued slots, ``nq2``
        queries, an alive mask)."""
        torch = self.torch
        dev = self.device
        g = torch.Generator(device=dev).manual_seed(5)
        db = self.rand_sigs(n, p, 1)
        qidx = torch.randint(0, n, (nq,), generator=g, device=dev)
        sizes = self.lognormal_sizes(n, 8)
        keep = torch.rand(nq, generator=g, device=dev) * 0.7 + 0.3
        return {
            "n": n, "nq": nq, "n2": n2, "db": db, "qidx": qidx,
            "q": self.near_copies(db[qidx], 0.7, 2), "sizes": sizes,
            "q_sizes": (sizes[qidx].to(torch.float32) * keep).to(torch.int32).clamp_min(1),
            "ties": self.rand_sigs(n2, NUM_PERM, 3, values=4),
            "halves": self.rand_sigs(n2, NUM_PERM, 4, values=2),
            "q_ties": self.rand_sigs(nq2, NUM_PERM, 6, values=4),
            "q_halves": self.rand_sigs(nq2, NUM_PERM, 7, values=2),
            "alive": torch.rand(n2, generator=g, device=dev) > 0.1,
        }

    def phase_kernels_scan(self, data: dict, edge_n: int = 20011,
                           edge_q=(1, 33, 1000), one_split=(1000, 33)) -> None:
        """Kernel 2 (``topk_scan``) and its sizes mode (``containment_scan``)
        against the plain version on the same tensors, exact: the timed
        shapes (Q x N x P 128 at k 10; sizes at k 16 and 128, cutoff 0.8),
        tie tables with an alive mask and ``n_valid`` < N, then P 66, 100
        and 128 at N = ``edge_n`` (not a whole number of tiles) for each Q
        in ``edge_q`` and k 1 and 128, and a table of ``one_split`` = (N, Q)
        that the grid scans in one split."""
        torch = self.torch
        k2 = self.kmod("topk_scan")
        dev = self.device
        g = torch.Generator(device=dev).manual_seed(8)
        n, nq, db, q = data["n"], data["nq"], data["db"], data["q"]
        n2, alive = data["n2"], data["alive"]
        ties, halves, q_ties, q_halves = (data[x] for x in ("ties", "halves", "q_ties",
                                                            "q_halves"))
        args = (db, q, TOP_K, n)
        self.compare("topk_scan", "N=%d Q=%d k=%d" % (n, nq, TOP_K),
                     k2.topk_scan(*args), k2.topk_scan_plain(*args, None, 0.0))
        self.record["topk_scan"]["ms"] = self.time_ms(lambda: k2.topk_scan(*args))
        self.record["topk_scan"]["plain_ms"] = self.time_ms(
            lambda: k2.topk_scan_plain(*args, None, 0.0), iters=1, warmup=0)
        self.bound("topk_scan", 4 * (n + nq) * NUM_PERM + nq * (8 * TOP_K + 4),
                   int_ops=SLOT_INT_OPS * nq * n * NUM_PERM)
        cases = [
            ("ties k=1", ties, q_ties, 1, n2, None, 0.0),
            ("ties k=128", ties, q_ties, 128, n2, None, 0.0),
            ("ties k=37 alive n_valid", ties, q_ties, 37, n2 - 1000, alive, 0.0),
            ("cutoff 0.5 k=16 alive", halves, q_halves, 16, n2, alive, 0.5),
        ]
        for case, d, qq, k, nv, al, cut in cases:
            self.compare("topk_scan", case, k2.topk_scan(d, qq, k, nv, al, cut),
                         k2.topk_scan_plain(d, qq, k, nv, al, cut))

        # the sizes (containment) mode: the ensemble's scan
        sizes, q_sizes = data["sizes"], data["q_sizes"]
        for k in (16, 128):
            args = (db, sizes, q, q_sizes, k, ENS_THRESHOLD)
            self.compare("containment_scan", "N=%d Q=%d k=%d cutoff %.1f"
                         % (n, nq, k, ENS_THRESHOLD),
                         k2.containment_topk(*args), k2.containment_topk_plain(*args))
            ms = self.time_ms(lambda a=args: k2.containment_topk(*a))
            log("  containment_scan k=%d: %s ms" % (k, ms))
            if k == 16:  # the serving call's first k
                self.record["containment_scan"]["ms"] = ms
                self.record["containment_scan"]["plain_ms"] = self.time_ms(
                    lambda a=args: k2.containment_topk_plain(*a), iters=1, warmup=0)
                # the slot counts (integer), and per (query, row) the
                # containment score's five f32 operations and its compare
                self.bound("containment_scan",
                           4 * (n + nq) * (NUM_PERM + 1) + nq * (8 * k + 4),
                           int_ops=SLOT_INT_OPS * nq * n * NUM_PERM, f32_ops=6.0 * nq * n)
        s2 = self.lognormal_sizes(n2, 9)
        s2[:20000] = 120  # equal sizes over 2-valued rows: tied scores
        s2[50000:50100] = 1 << 30
        qs2 = torch.randint(1, 400, (q_halves.shape[0],), generator=g, device=dev,
                            dtype=torch.int32)
        qs2[:3] = torch.tensor([0, 1, 1 << 30], dtype=torch.int32)
        cases = [
            ("ties k=1 cutoff 0.0", halves, q_halves, 1, 0.0),
            ("ties k=37 cutoff 1.0", halves, q_halves, 37, 1.0),
            ("ties k=128 cutoff 0.5", halves, q_halves, 128, 0.5),
            ("4-valued k=37 cutoff 0.8", ties, q_ties, 37, 0.8),
        ]
        for case, d, qq, k, cut in cases:
            args = (d, s2, qq, qs2, k, cut)
            self.compare("containment_scan", case + " ragged, sizes 0..2**30",
                         k2.containment_topk(*args), k2.containment_topk_plain(*args))

        # edge shapes: P not a multiple of 4 or of 64, ragged N and Q, k at
        # both ends, 2-valued slots (ties everywhere) with a tie block of
        # equal sizes, and one shape scanned in a single split
        shapes = [(p, edge_n, nqe, k) for p in (66, 100, NUM_PERM) for nqe in edge_q
                  for k in (1, 128)]
        shapes += [(NUM_PERM, one_split[0], one_split[1], 16)]
        for i, (p, ne, nqe, k) in enumerate(shapes):
            d = self.rand_sigs(ne, p, 100 + i, values=2)
            qq = self.rand_sigs(nqe, p, 200 + i, values=2)
            al = torch.rand(ne, generator=g, device=dev) > 0.2
            nv = ne - ne // 7
            cut = 0.5 if k == 128 else 0.0
            case = "P %d N %d Q %d k %d" % (p, ne, nqe, k)
            self.compare("topk_scan", case + " alive n_valid cutoff %.1f" % cut,
                         k2.topk_scan(d, qq, k, nv, al, cut),
                         k2.topk_scan_plain(d, qq, k, nv, al, cut))
            xs = self.lognormal_sizes(ne, 300 + i)
            xs[: ne // 4] = 120
            qs = torch.randint(0, 300, (nqe,), generator=g, device=dev, dtype=torch.int32)
            args = (d, xs, qq, qs, k, 0.8)
            self.compare("containment_scan", case + " cutoff 0.8 tie block",
                         k2.containment_topk(*args), k2.containment_topk_plain(*args))

    def phase_kernels_cws(self, n_rows: int = W_ROWS, dense_rows: int = W_DENSE_ROWS,
                          edge_rows: int = 257) -> None:
        """Kernels 6 and 7 against their plain versions: kernel 7 on the
        weighted path's whole CSR batch, then kernel 6
        (:meth:`phase_kernels_cws_dense`), then both on the ragged edges
        (:meth:`phase_kernels_cws_edges`)."""
        torch = self.torch
        from datasketch_tpu_torch import WeightedMinHashGenerator

        kc = self.kmod("cws_sparse")
        dev = self.device
        gen = WeightedMinHashGenerator(W_DIM, W_SAMPLES, seed=1, device=dev)
        tables = gen.params_t()
        vals, idx, indptr = make_weighted_rows(torch, n_rows, W_DIM, dev, seed=17)
        args = (vals, idx, indptr, *tables)
        self.compare("cws_sparse", "%d CSR rows, D %d, S %d, nnz %d"
                     % (n_rows, W_DIM, W_SAMPLES, vals.numel()),
                     kc.cws_sparse(*args), kc.cws_sparse_plain(*args))
        rec = self.record["cws_sparse"]
        rec["ms"] = self.time_ms(lambda: kc.cws_sparse(*args))
        rec["plain_ms"] = self.time_ms(lambda: kc.cws_sparse_plain(*args), iters=1, warmup=0)
        # per active (row, dim, sample): division, add, floor, subtract,
        # multiply, subtract, subtract, compare, none of which can fuse; a
        # log per active (row, dim)
        active = int((vals > 0).sum())
        self.bound("cws_sparse",
                   8 * vals.numel() + 8 * (n_rows + 1) + 12 * W_DIM * W_SAMPLES
                   + 8 * n_rows * W_SAMPLES,
                   unfused_ops=8.0 * active * W_SAMPLES + active)
        del vals, idx, indptr, args
        self.phase_kernels_cws_dense(gen, dense_rows, min(edge_rows, 64))
        self.phase_kernels_cws_edges(edge_rows)

    def phase_kernels_cws_edges(self, edge_rows: int = 257) -> None:
        """Kernels 6 and 7 against their plain versions and each other on
        :func:`cws_edge_case`'s rows, then on rows whose entry order
        matters (:meth:`phase_kernels_cws_order`)."""
        torch = self.torch
        kc = self.kmod("cws_sparse")
        dev = self.device
        for d, s in ((10001, 100), (333, 6), (W_DIM, W_SAMPLES)):
            tabs, w = cws_edge_case(torch, d, s, dev, edge_rows)
            vals, idx, indptr = to_csr(torch, w)
            got = kc.cws_dense(w, *tabs)
            case = "edges D %d S %d" % (d, s)
            self.compare("cws_dense", case, got, kc.cws_dense_plain(w, *tabs))
            csr = kc.cws_sparse(vals, idx, indptr, *tabs)
            self.compare("cws_sparse", case, csr, kc.cws_sparse_plain(vals, idx, indptr, *tabs))
            check(torch.equal(got, csr), "%s: kernel 6 and kernel 7 differ" % case)
            check(bool((got[3, :, 1] < 0).all()) and bool((got[0] == 0).all())
                  and bool((got[2, :, 0] == 0).all()),
                  "%s: negative t, the empty row or the forced tie are wrong" % case)
        self.phase_kernels_cws_order(edge_rows)
        self.phase_kernels_cws_blocks()

    def phase_kernels_cws_blocks(self, shapes=CWS_BLOCK_SHAPES) -> None:
        """Kernel 7 against its plain version on :func:`cws_block_case`'s
        rows at each (rows, D, S) of ``shapes`` (batches of 1, 511, 513 and
        65,537 rows; S from 1 to 1,030; shuffled rows, a fully dense row,
        ties within and across 64-dim chunks, ties at ln_a = +0.0), on
        unaligned copies of the tables and on rows with no entry; then, on
        the card only, on parameters that give ln_a = NaN or +inf (never
        chosen: equal to the plain version on the rows without those
        entries) and on weights of +inf."""
        torch = self.torch
        kc = self.kmod("cws_sparse")
        dev = self.device
        cpu = dev.type != "cuda"
        for i, (n_rows, d, s) in enumerate(shapes):
            if cpu:  # a rehearsal: the same cases, cut
                n_rows, d = min(n_rows, 300), min(d, 1001)
            tabs, csr, ties = cws_block_case(torch, d, s, dev, n_rows)
            case = "blocks B %d D %d S %d" % (n_rows, d, s)
            want = kc.cws_sparse_plain(*csr, *tabs)
            for row, dim in ties:
                check(bool((want[row, :, 0] == dim).all()),
                      "%s: row %d's tie does not go to dim %d" % (case, row, dim))
            self.compare("cws_sparse", case, kc.cws_sparse(*csr, *tabs), want)
            if i == 0:
                moved = [unaligned_copy(torch, t) for t in tabs]
                self.compare("cws_sparse", case + " unaligned tables",
                             kc.cws_sparse(*csr, *moved), want)
        tabs, _, _ = cws_block_case(torch, 333, 6, dev, 1)
        empty = (torch.zeros(0, dtype=torch.float32, device=dev),
                 torch.zeros(0, dtype=torch.int32, device=dev),
                 torch.zeros(6, dtype=torch.int64, device=dev))
        got = kc.cws_sparse(*empty, *tabs)
        check(got.shape == (5, 6, 2) and not bool(got.any()), "nnz 0: rows are not (0, 0)")
        if cpu:  # the plain version's argmin takes a NaN: the rest is the kernel's
            return
        tabs, csr, masked = cws_odd_case(torch, dev)
        got = kc.cws_sparse(*csr, *tabs)
        want = kc.cws_sparse_plain(*masked, *tabs)
        keep = [i for i in range(got.shape[0]) if i != 41]  # +inf weights: checked below
        self.compare("cws_sparse", "ln_a NaN / +inf, as if those entries were inactive",
                     got[keep], want[keep])
        check(not bool(got[40].any()) and bool((got[41, :, 0] == 3).all())
              and bool((got[42, :, 0] == 11).all()),
              "ln_a NaN / +inf: rows 40-42 are not (0, 0), dim 3 and dim 11")
        check(bool((got[41, :, 1] == 2 ** 31 - 1).all()), "weights of +inf: t is not INT32_MAX")

    def phase_kernels_cws_dense(self, gen, dense_rows: int = W_DENSE_ROWS,
                                edge_rows: int = 64,
                                edge_ds=((W_DIM, W_SAMPLES), (10001, 100), (333, 6), (1, 1),
                                         (W_DIM, 129), (10001, 256), (W_DIM, 6),
                                         (333, 1030))) -> None:
        """Kernel 6 against its plain version and kernel 7: the first
        ``dense_rows`` rows of the weighted batch densified, in the
        generator's chunks (the first chunk timed), then at each (D, S) of
        ``edge_ds`` the rows of :func:`cws_dense_case` (an empty row, one
        active dim at the end, fully dense rows, ties across chunks and
        across warps' segments, tiny, huge and negative weights)."""
        torch = self.torch
        kc = self.kmod("cws_dense")
        dev = self.device
        tables = gen.params_t()
        vals, idx, indptr = make_weighted_rows(torch, dense_rows, W_DIM, dev, seed=17)
        sparse_kt = kc.cws_sparse(vals, idx, indptr, *tables)
        dense = densify(torch, vals, idx, indptr, W_DIM)
        del vals, idx, indptr
        chunk = min(dense_rows, gen._CHUNK_ELEMS // W_DIM)  # the generator's
        for r0 in range(0, dense_rows, chunk):
            w = dense[r0: r0 + chunk]
            got = kc.cws_dense(w, *tables)
            self.compare("cws_dense", "rows %d..%d densified" % (r0, r0 + w.shape[0] - 1),
                         got, kc.cws_dense_plain(w, *tables))
            check(torch.equal(got, sparse_kt[r0: r0 + chunk]),
                  "kernel 6 on densified rows differs from kernel 7 on the CSR rows")
        w = dense[:chunk]
        rec = self.record["cws_dense"]
        rec["ms"] = self.time_ms(lambda: kc.cws_dense(w, *tables))
        rec["plain_ms"] = self.time_ms(lambda: kc.cws_dense_plain(w, *tables), iters=1,
                                       warmup=0)
        active = int((w > 0).sum())
        self.bound("cws_dense", 4 * w.numel() + 12 * W_DIM * W_SAMPLES + 8 * chunk * W_SAMPLES,
                   unfused_ops=8.0 * active * W_SAMPLES + active)
        del dense, w, sparse_kt
        for d, s in edge_ds:
            tabs, w, ties = cws_dense_case(torch, d, s, dev, edge_rows)
            got = kc.cws_dense(w, *tabs)
            case = "dense D %d S %d" % (d, s)
            want = kc.cws_dense_plain(w, *tabs)
            for row, dim in ties:
                check(bool((want[row, :, 0] == dim).all()),
                      "%s: row %d's tie does not go to dim %d" % (case, row, dim))
            self.compare("cws_dense", case, got, want)
            vals, idx, indptr = to_csr(torch, w)
            check(torch.equal(got, kc.cws_sparse(vals, idx, indptr, *tabs)),
                  "%s: kernel 6 and kernel 7 differ" % case)

    def phase_kernels_cws_order(self, n_rows: int = 257) -> None:
        """Kernel 7 against its plain version on rows whose entry order
        matters (:func:`cws_order_case`): long rows, a tie between distant
        dims, falling dims (the first minimum in entry order wins), inactive
        entries anywhere, an empty row, at S 1, 6, 100 and 128, in the flat
        CSR and the padded ``cws_many_sparse`` form; and kernel 6 on the rows
        densified (the tied dims land in different warps' segments)."""
        torch = self.torch
        kc = self.kmod("cws_sparse")
        from datasketch_tpu_torch.ops import cws_ops

        for d, s in ((W_DIM, 1), (W_DIM, 6), (10001, 100), (W_DIM, W_SAMPLES), (333, 6)):
            tabs, (vals, idx, indptr), ties = cws_order_case(torch, d, s, self.device, n_rows)
            want = kc.cws_sparse_plain(vals, idx, indptr, *tabs)
            check(bool((want[0] == 0).all()), "D %d S %d: the empty row is not (0, 0)" % (d, s))
            for row, dim in ties:
                check(bool((want[row, :, 0] == dim).all()),
                      "D %d S %d: row %d's tie does not go to dim %d" % (d, s, row, dim))
            self.compare("cws_sparse", "entry order D %d S %d" % (d, s),
                         kc.cws_sparse(vals, idx, indptr, *tabs), want)
            w = densify(torch, vals, idx, indptr, d)  # ties across warps' segments
            self.compare("cws_dense", "entry order D %d S %d densified" % (d, s),
                         kc.cws_dense(w, *tabs), kc.cws_dense_plain(w, *tabs))
            # the padded form: each row right-padded with (idx 0, val 0)
            lengths = indptr[1:] - indptr[:-1]
            nz = int(lengths.max())
            col = torch.arange(nz, device=self.device)
            valid = col[None, :] < lengths[:, None]
            pos = torch.where(valid, indptr[:-1, None] + col[None, :], 0)
            self.compare("cws_sparse", "entry order D %d S %d padded" % (d, s),
                         cws_ops.cws_many_sparse(torch.where(valid, vals[pos], 0.0),
                                                 torch.where(valid, idx[pos], 0), *tabs),
                         want)

    def phase_signatures(self, n_docs: int = SIG_DOCS):
        """End-to-end signatures of the bench corpus."""
        torch = self.torch
        from datasketch_tpu_torch import MinHash, native
        from datasketch_tpu_torch.kernels.minhash_sign import minhash_sign_plain
        from datasketch_tpu_torch.ops.minhash_ops import init_permutations, perm_tensors

        corpus = make_corpus(n_docs, seed=42)
        kw = dict(num_perm=NUM_PERM, seed=1, out="device", device=self.device)
        MinHash.bulk_signatures(corpus[:1024], **kw)  # warm the allocator
        rates = []
        for _ in range(2):
            self.sync()
            t0 = time.perf_counter()
            sigs = MinHash.bulk_signatures(corpus, **kw)
            self.sync()
            rates.append(n_docs / (time.perf_counter() - t0))
        check(sigs.shape == (n_docs, NUM_PERM) and sigs.device.type == self.device.type,
              "signature matrix has shape %s on %s" % (tuple(sigs.shape), sigs.device))
        flat, lengths = native.hash_ragged(corpus)
        starts = np.zeros(n_docs, dtype=np.int64)
        np.cumsum(lengths[:-1], out=starts[1:])
        a, b = perm_tensors(1, NUM_PERM, self.device)
        dev_flat = torch.from_numpy(flat.view(np.int32)).to(self.device)
        plain = minhash_sign_plain(dev_flat, torch.from_numpy(starts).to(self.device),
                                   torch.from_numpy(lengths).to(self.device), a, b)
        check(torch.equal(sigs, plain), "bulk signatures differ from the plain version")
        host = sigs.cpu().numpy().view(np.uint32)
        pa, pb = init_permutations(1, NUM_PERM)
        rows = np.random.RandomState(3).choice(n_docs, 16, replace=False)
        for i in rows:
            hv = flat[starts[i]: starts[i] + lengths[i]].astype(np.uint64)[:, None]
            want = np.bitwise_and((hv * pa + pb) % np.uint64((1 << 61) - 1),
                                  np.uint64(0xFFFFFFFF)).min(axis=0)
            check(np.array_equal(host[i], want.astype(np.uint32)),
                  "signature row %d differs from the host numpy formula" % i)
        log("[signatures] %d docs x %d tokens: %s docs/s (hash + upload + kernel, "
            "synced); plain version and 16 host rows agree" % (
                n_docs, TOKENS_PER_DOC, " / ".join("%.1f" % r for r in rates)))
        self.sig_rate = max(rates)
        self.sig_corpus = corpus
        return host

    def phase_index(self, real_sigs: np.ndarray, n_rows: int = N_INDEX):
        from datasketch_tpu_torch import TorchMinHashLSH

        sigs, src, dst, near = synth_index(n_rows, real_sigs)
        index = TorchMinHashLSH(threshold=0.5, num_perm=NUM_PERM, bucket_cap=128,
                                device=self.device)
        self.sync()
        t0 = time.perf_counter()
        index.index(range(n_rows), sigs)
        status = index.status()
        build_s = time.perf_counter() - t0
        check(status["n_live"] == n_rows, "index holds %d rows" % status["n_live"])
        log("[index] %d rows built in %.3f s (upload + fingerprints + sort); status %s"
            % (n_rows, build_s, json.dumps(status)))
        self.build_s = build_s
        return index, sigs, src, dst, near

    def phase_serving(self, index, sigs, src, dst, near, n_queries: int = N_QUERIES):
        queries = sigs[dst[-n_queries:]]
        expect = src[-n_queries:]
        self.qps = {}

        def timed(label, fn, reps=3):
            fn()  # first call of the shape
            best = 0.0
            out = None
            for _ in range(reps):
                self.sync()
                t0 = time.perf_counter()
                out = fn()
                self.sync()
                best = max(best, n_queries / (time.perf_counter() - t0))
            self.qps[label] = best
            return out

        def recall(rows, scored=True):
            hits = 0
            for want, row in zip(expect, rows):
                keys = [kk for kk, _ in row] if scored else row
                hits += int(want) in keys
            return hits / len(rows)

        for method in ("scan", "bands", "auto"):
            rows = timed("top_k k=%d %s" % (TOP_K, method),
                         lambda m=method: index.top_k(queries, TOP_K, method=m))
            if method == "scan":  # bands may find fewer than k candidates
                check(all(len(r) == TOP_K for r in rows), "top_k(scan) short rows")
            rec = recall(rows)
            log("[serving] top_k k=%d %-5s %10.1f q/s recall %.4f truncated %d"
                % (TOP_K, method, self.qps["top_k k=%d %s" % (TOP_K, method)], rec,
                   index.last_truncated))
            if method == "scan":
                check(rec >= 0.99, "scan recall %.4f < 0.99" % rec)
                scan_rows = rows
        for method in ("bands", "scan"):
            rows = timed("query_batch 0.5 %s" % method,
                         lambda m=method: index.query_batch(queries, return_scores=True,
                                                            method=m))
            rec = recall(rows)
            check(all(s >= 0.5 for row in rows for _, s in row),
                  "query_batch(%s) returned a score below the threshold" % method)
            log("[serving] query_batch 0.5 %-5s %10.1f q/s recall %.4f truncated %d"
                % (method, self.qps["query_batch 0.5 %s" % method], rec,
                   index.last_truncated))
            if method == "scan":
                check(rec >= 0.99, "threshold scan recall %.4f < 0.99" % rec)
        rows = timed("top_k k=%d scan" % BIG_K,
                     lambda: index.top_k(queries, BIG_K, method="scan"))
        check(all(len(r) == BIG_K for r in rows), "top_k(k=%d) short rows" % BIG_K)
        check(all(r[:TOP_K] == s for r, s in zip(rows, scan_rows)),
              "top_k(k=%d) does not extend the k=%d answer" % (BIG_K, TOP_K))
        log("[serving] top_k k=%d scan %10.1f q/s (kernel 4)"
            % (BIG_K, self.qps["top_k k=%d scan" % BIG_K]))
        hits = index.query_batch(sigs[near[:1]], method="scan")[0]
        check(set(near.tolist()) <= set(hits),
              "escalated threshold scan missed near-copies (%d hits)" % len(hits))
        log("[serving] escalated threshold scan: %d matches (> 128) incl. all %d "
            "near-copies" % (len(hits), len(near)))
        removed = list(dict.fromkeys(int(x) for x in expect))[:N_REMOVE]
        for key in removed:
            index.remove(key)
        gone = set(removed)
        self.removed = gone
        for method in ("scan", "bands"):
            rows = timed("top_k k=%d %s after remove" % (TOP_K, method),
                         lambda m=method: index.top_k(queries, TOP_K, method=m))
            check(not any(kk in gone for row in rows for kk, _ in row),
                  "top_k(%s) returned a removed key" % method)
            rows = index.query_batch(queries, method=method)
            check(not any(kk in gone for row in rows for kk in row),
                  "query_batch(%s) returned a removed key" % method)
        log("[serving] after %d removals: scan %.1f q/s, bands %.1f q/s; no removed key "
            "returned" % (len(removed), self.qps["top_k k=%d scan after remove" % TOP_K],
                          self.qps["top_k k=%d bands after remove" % TOP_K]))

    def phase_failover(self, index, sigs, dst, counts=None, n_queries: int = N_QUERIES,
                       n_host: int = FO_HOST_QUERIES) -> None:
        """failover-1m: ``FailoverIndex`` over the served index (removals
        included). A real probe of the card, the queries through the wrapper
        on the device (kernels 2, 3 and 4 counted by ``counts`` around them
        alone), a real failed probe of a device that does not exist, host
        answers that launch nothing and agree with the device's, and the
        explicit failback."""
        torch = self.torch
        from datasketch_tpu_torch import FailoverIndex
        from datasketch_tpu_torch.utils import HealthMonitor

        queries = sigs[dst[-n_queries:]]
        fo_stats = {}
        t0 = time.perf_counter()
        fo = FailoverIndex(index, monitor=HealthMonitor(max_failures=1, device=self.device))
        snap = fo._snapshot
        fo_stats["snapshot_s"] = time.perf_counter() - t0
        fo_stats["snapshot_bytes"] = int(snap["sigs"].nbytes) + (
            0 if snap["alive"] is None else int(snap["alive"].nbytes))
        check(snap["alive"] is not None and not snap["alive"].all(),
              "the snapshot carries no tombstones")
        t0 = time.perf_counter()
        probe = fo.check()
        fo_stats["probe_wall_s"] = time.perf_counter() - t0
        check(probe["ok"], "the probe of a healthy card failed: %s" % probe)
        fo_stats["probe_latency_s"] = probe["latency_s"]
        calls = (
            ("top_k k=%d scan" % TOP_K, lambda q: fo.top_k(q, TOP_K, method="scan"),
             lambda q: index.top_k(q, TOP_K, method="scan")),
            ("top_k k=%d bands" % TOP_K, lambda q: fo.top_k(q, TOP_K, method="bands"),
             lambda q: index.top_k(q, TOP_K, method="bands")),
            ("query_batch 0.5 scan",
             lambda q: fo.query_batch(q, return_scores=True, method="scan"),
             lambda q: index.query_batch(q, return_scores=True, method="scan")),
            ("top_k k=%d scan" % BIG_K, lambda q: fo.top_k(q, BIG_K, method="scan"),
             lambda q: index.top_k(q, BIG_K, method="scan")),
        )
        for _, via, _ in calls:
            via(queries)  # first call of each shape, outside the timed window
        before = counts() if counts else None
        got, qps = {}, {}
        for label, via, _ in calls:
            self.sync()
            t0 = time.perf_counter()
            got[label] = via(queries)
            self.sync()
            qps[label] = n_queries / (time.perf_counter() - t0)
            check(fo.last_path == "device", "%s was answered from the %s" % (label, fo.last_path))
        self.sync()
        if counts:
            after = counts()
            self.fo_counts = {k: after[k] - before[k] for k in after}
            for kname in FAILOVER_PATH:
                check(self.fo_counts[kname] > 0,
                      "kernel %s was not launched on the failover-1m path" % kname)
        check(not fo.serving_from_host and not fo.status()["serving_from_host"],
              "a healthy wrapper reports host serving")
        for label, _, own in calls:
            check(got[label] == own(queries), "%s through the wrapper differs from the "
                  "index's own answer" % label)
        gone = self.removed
        fo.monitor.device = "cuda:%d" % torch.cuda.device_count()
        t0 = time.perf_counter()
        tripped = fo.check()
        fo_stats["failed_probe_wall_s"] = time.perf_counter() - t0
        fo.monitor.device = self.device
        check(not tripped["ok"] and "no CUDA device" in str(tripped["error"]),
              "the probe of a missing device did not fail: %s" % tripped)
        check(fo.serving_from_host and fo.status()["serving_from_host"],
              "one failed probe did not trip a max_failures=1 monitor")
        hq = queries[:n_host]
        before = counts() if counts else None
        t0 = time.perf_counter()
        host_top = fo.top_k(hq, TOP_K)
        check(fo.last_path == "host", "a tripped wrapper answered from the device")
        t1 = time.perf_counter()
        host_thr = fo.query_batch(hq, return_scores=True)
        t2 = time.perf_counter()
        check(fo.last_path == "host", "a tripped wrapper answered from the device")
        if counts:
            check(counts() == before, "the host path launched a kernel: %s -> %s"
                  % (json.dumps(before), json.dumps(counts())))
        qps["host top_k k=%d" % TOP_K] = n_host / (t1 - t0)
        qps["host query_batch 0.5"] = n_host / (t2 - t1)
        dev_top = got["top_k k=%d scan" % TOP_K][:n_host]
        for qi, (h, d) in enumerate(zip(host_top, dev_top)):
            check([s for _, s in h] == [s for _, s in d],
                  "query %d: host and device top-k scores differ" % qi)
            kth = d[-1][1]
            check({kk for kk, s in h if s > kth} == {kk for kk, s in d if s > kth},
                  "query %d: host and device ids above the k-th score differ" % qi)
            check(all(np.count_nonzero(snap["sigs"][kk] == hq[qi]) / NUM_PERM == s
                      for kk, s in h),
                  "query %d: a host score is not its row's equal-slot share" % qi)
            check(not any(kk in gone for kk, _ in h), "the host path returned a removed key")
        for qi, (h, d) in enumerate(zip(host_thr, got["query_batch 0.5 scan"][:n_host])):
            check(h == d, "query %d: host and device threshold answers differ" % qi)
            check(not any(kk in gone for kk, _ in h), "the host path returned a removed key")
        fo.resume_device()
        check(fo.top_k(hq, TOP_K, method="scan") == dev_top and fo.last_path == "device",
              "resume_device() did not return to the device")
        fo_stats["qps"] = qps
        self.failover = fo_stats
        log("[failover-1m] probe ok in %.3f s (op %.4f s), failed probe %.3f s; snapshot "
            "%.3f s, %d B; q/s %s" % (fo_stats["probe_wall_s"], probe["latency_s"],
                                      fo_stats["failed_probe_wall_s"], fo_stats["snapshot_s"],
                                      fo_stats["snapshot_bytes"], json.dumps(qps)))

    def host_lsh_queries(self, n_queries: int = N_QUERIES, replace: float = HOST_LSH_REPLACE):
        """Queries of host-lsh-262k: signature-corpus docs with a share of
        their tokens replaced, signed on the card (kernel 1); returns
        (the docs, uint32[n, P] signatures, source rows)."""
        from datasketch_tpu_torch import MinHash

        rng = np.random.RandomState(31)
        src = rng.choice(len(self.sig_corpus), n_queries, replace=False)
        docs = []
        for i in src:
            doc = list(self.sig_corpus[i])
            for j in np.nonzero(rng.rand(len(doc)) < replace)[0]:
                doc[j] = bytes(rng.randint(0, 256, size=10, dtype=np.uint8))
            docs.append(doc)
        q = MinHash.bulk_signatures(docs, num_perm=NUM_PERM, seed=1, out="host",
                                    device=self.device)
        return docs, q, src

    def phase_host_lsh(self, index, sigs, near, n_rows: int = HOST_LSH_ROWS,
                       n_async: int = HOST_LSH_ASYNC_ROWS, n_queries: int = N_QUERIES):
        """host-lsh-262k: the host ``MinHashLSH`` over lsh-1m's first rows
        and a ``rerank=False`` ``TorchMinHashLSH`` of the same rows, asked
        by edited docs signed on the card and by 16 of the near-copies of
        row 0 (hundreds of candidates each), ``AsyncMinHashLSH`` on
        ``aiodict`` over fewer rows, and on lsh-1m's tables ``topk_fused``
        by direct address (``build_offsets``). The launch counts are read
        around this phase; :meth:`phase_host_lsh_checks` follows it. Times
        are host seconds."""
        import asyncio

        torch = self.torch
        from datasketch_tpu_torch import AsyncMinHashLSH, MinHash, MinHashLSH, TorchMinHashLSH
        from datasketch_tpu_torch.ops import lsh_ops

        stats = {}
        docs, q, src = self.host_lsh_queries(n_queries)
        crowd = near[1:1 + HOST_LSH_NEAR]
        q, src = np.concatenate([q, sigs[crowd]]), np.concatenate([src, crowd])
        rows = sigs[:n_rows]
        t0 = time.perf_counter()
        objs = [MinHash(num_perm=NUM_PERM, hashvalues=r) for r in rows]
        q_objs = [MinHash(num_perm=NUM_PERM, hashvalues=r) for r in q]
        stats["objects_s"] = time.perf_counter() - t0
        host = MinHashLSH(threshold=0.5, num_perm=NUM_PERM)
        t0 = time.perf_counter()
        host.insert_batch(range(n_rows), objs)
        stats["host_insert_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        host_ans = host.query_batch(q_objs)
        stats["host_query_s"] = time.perf_counter() - t0
        dev = TorchMinHashLSH(threshold=0.5, num_perm=NUM_PERM, rerank=False,
                              bucket_cap=HOST_LSH_CAP, device=self.device)
        self.sync()
        t0 = time.perf_counter()
        dev.index(range(n_rows), rows)
        self.sync()
        stats["device_index_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev_ans = dev.query_batch(q)
        stats["device_query_s"] = time.perf_counter() - t0

        async def drive():
            async with AsyncMinHashLSH(threshold=0.5, num_perm=NUM_PERM) as lsh:
                t0 = time.perf_counter()
                async with lsh.insertion_session() as session:
                    for key, m in zip(range(n_async), objs[:n_async]):
                        await session.insert(key, m)
                t1 = time.perf_counter()
                out = [await lsh.query(m) for m in q_objs]
                return out, t1 - t0, time.perf_counter() - t1

        async_ans, stats["async_insert_s"], stats["async_query_s"] = asyncio.run(drive())
        # direct addressing on lsh-1m's tables
        n_buckets = 1 << max(int(index._sorted_fp.shape[1] - 1).bit_length(), 0)
        qt = torch.from_numpy(sigs[-n_queries:].view(np.int32)).to(self.device)
        self.sync()
        t0 = time.perf_counter()
        offsets = lsh_ops.build_offsets(index._sorted_fp, n_buckets)
        self.sync()
        stats["offsets_s"] = time.perf_counter() - t0
        direct = lsh_ops.topk_fused(index._sorted_fp, index._sorted_ids, index._sigs, qt,
                                    index.b, index.r, index.bucket_cap, TOP_K,
                                    offsets=offsets, n_buckets=n_buckets)
        self.sync()
        self.host_lsh = stats
        return {"docs": docs, "q": q, "src": src, "objs": objs, "q_objs": q_objs,
                "host_ans": host_ans, "dev": dev, "dev_ans": dev_ans,
                "n_crowd": len(crowd), "async_ans": async_ans, "qt": qt, "offsets": offsets,
                "n_buckets": n_buckets, "direct": direct}

    def phase_host_lsh_checks(self, index, path, n_async: int = HOST_LSH_ASYNC_ROWS) -> None:
        """host-lsh-262k's checks, after its launch counts are read: the
        query docs signed by kernel 1's plain twin equal the card's
        signatures; every host answer a subset of the device's
        (fingerprint collisions only add) with the source in both and
        nothing truncated; the async answers equal to the host class's on
        the same rows; and the direct-address ``topk_fused`` equal to the
        binary-search route for every query whose window fits on both."""
        torch = self.torch
        from datasketch_tpu_torch import MinHash, MinHashLSH
        from datasketch_tpu_torch.ops import lsh_ops

        stats = self.host_lsh
        docs, q, src = path["docs"], path["q"], path["src"]
        host_ans, dev_ans = path["host_ans"], path["dev_ans"]
        plain = MinHash.bulk_signatures(docs, num_perm=NUM_PERM, seed=1, out="host",
                                        device="cpu")
        check(np.array_equal(plain, q[:len(docs)]),
              "host-lsh-262k: kernel 1's query signatures differ from the plain signer's")
        check(path["dev"].last_truncated == 0, "the device answers were truncated (%d)"
              % path["dev"].last_truncated)
        check(min(len(a) for a in host_ans[-path["n_crowd"]:]) > 100,
              "the near-copy queries found few candidates")
        for qi, (h, d, s) in enumerate(zip(host_ans, dev_ans, src)):
            check(set(h) <= set(d), "query %d: a host answer is not in the device answer" % qi)
            check(int(s) in h and int(s) in d, "query %d: the planted source is missing" % qi)
        stats["mean_candidates"] = [float(np.mean([len(a) for a in host_ans])),
                                    float(np.mean([len(a) for a in dev_ans]))]
        small = MinHashLSH(threshold=0.5, num_perm=NUM_PERM)
        small.insert_batch(range(n_async), path["objs"][:n_async])
        want = small.query_batch(path["q_objs"])
        check([sorted(a) for a in path["async_ans"]] == [sorted(w) for w in want],
              "AsyncMinHashLSH answers differ from the host MinHashLSH's")
        check(any(want), "no async query found a candidate")
        qt, offsets, n_buckets = path["qt"], path["offsets"], path["n_buckets"]
        search = lsh_ops.topk_fused(index._sorted_fp, index._sorted_ids, index._sigs, qt,
                                    index.b, index.r, index.bucket_cap, TOP_K)
        q_t = lsh_ops.band_fingerprints(qt, index.b, index.r).T.contiguous()
        run = (torch.searchsorted(index._sorted_fp, q_t, side="right")
               - torch.searchsorted(index._sorted_fp, q_t, side="left"))
        bk = q_t >> lsh_ops._bucket_shift(n_buckets)
        window = offsets.gather(1, bk + 1) - offsets.gather(1, bk)
        fits = ((run <= index.bucket_cap) & (window <= index.bucket_cap)).all(dim=0)
        check(float(fits.float().mean()) >= 0.5, "only %d of %d queries fit their windows"
              % (int(fits.sum()), qt.shape[0]))
        for a, b in zip(path["direct"][:2], search[:2]):
            check(torch.equal(a[fits], b[fits]),
                  "topk_fused by direct address differs from the binary search")
        stats["offsets_queries_compared"] = int(fits.sum())
        log("[host-lsh-262k] %d rows (host seconds): %s; %d query signatures equal to the "
            "plain signer's" % (len(path["objs"]), json.dumps(stats), len(docs)))

    def phase_facade_parity(self, sigs: np.ndarray, n_rows: int = PARITY_ROWS,
                            n_queries: int = PARITY_QUERIES) -> None:
        """The CUDA facade against a device='cpu' one on one sub-index."""
        torch = self.torch
        from datasketch_tpu_torch import TorchMinHashLSH

        sub = sigs[:n_rows]
        rng = np.random.RandomState(17)
        rows = rng.choice(n_rows, n_queries, replace=False)
        keep = rng.rand(n_queries, NUM_PERM) < 0.7
        noise = rng.randint(0, 1 << 32, size=keep.shape, dtype=np.uint64).astype(np.uint32)
        queries = np.where(keep, sub[rows], noise)
        pair = [TorchMinHashLSH(threshold=0.5, num_perm=NUM_PERM, device=d)
                for d in (self.device, "cpu")]
        for ix in pair:
            ix.index(range(n_rows), sub)

        def same(label, fn):
            got = [fn(ix) for ix in pair]
            check(got[0] == got[1], "facade parity: %s differs" % label)
            check(pair[0].last_truncated == pair[1].last_truncated,
                  "facade parity: %s last_truncated differs" % label)

        def dispatch(ix, method):
            q = ix._queries(queries)
            out = ix._query_dispatch(q, 0.5, method)
            return [None if t is None else np.asarray(torch.as_tensor(t).cpu())
                    for t in out[:4]] + [out[4]]

        def same_dispatch(method):
            got = [dispatch(ix, method) for ix in pair]
            for x, y in zip(got[0], got[1]):
                check(np.array_equal(x, y),
                      "facade parity: threshold %s ids/scores/n_match/truncated" % method)

        # rows of a device tensor, as lists and one by one, answer as the
        # batch does
        dev_sub = torch.from_numpy(sub.view(np.int32)).to(self.device)
        q_rows = list(torch.from_numpy(queries.view(np.int32)).to(self.device))
        by_rows = TorchMinHashLSH(threshold=0.5, num_perm=NUM_PERM, device=self.device)
        tail = min(256, n_rows)
        by_rows.index(range(n_rows - tail), list(dev_sub[: n_rows - tail]))
        for i in range(n_rows - tail, n_rows):
            by_rows.insert(i, dev_sub[i])
        for method in ("scan", "bands"):
            want = pair[0].top_k(queries, TOP_K, method)
            check(by_rows.top_k(q_rows, TOP_K, method) == want,
                  "facade parity: top_k of device rows (%s) differs" % method)
            check(by_rows.query_batch(q_rows, method=method)
                  == pair[0].query_batch(queries, method=method),
                  "facade parity: query_batch of device rows (%s) differs" % method)
        check(by_rows.query(q_rows[0]) == pair[0].query(queries[0]),
              "facade parity: query of one device row differs")
        del by_rows, dev_sub
        for rnd in range(2):
            for method in ("scan", "bands", "auto"):
                same("top_k %s" % method, lambda ix, m=method: ix.top_k(queries, TOP_K, m))
                same("query_batch %s" % method,
                     lambda ix, m=method: ix.query_batch(queries, return_scores=True,
                                                         method=m))
            for method in ("scan", "bands"):
                same_dispatch(method)
            same("top_k k=200 scan", lambda ix: ix.top_k(queries, 200, "scan"))
            if rnd == 0:
                for key in rng.choice(n_rows, 500, replace=False).tolist():
                    for ix in pair:
                        ix.remove(key)
        log("[facade parity] %d rows x %d queries: CUDA and CPU facades agree on ids, "
            "scores, n_match and last_truncated (before and after 500 removals); an index "
            "of device-tensor rows (a list, then %d inserts) answers lists of device rows "
            "as the batch index does" % (n_rows, n_queries, tail))

    # ---------------------------------------------------------- ensemble

    def phase_ensemble_corpus(self, n_sets: int = ENS_SETS, n_queries: int = ENS_QUERIES,
                              seed: int = 41):
        """Token sets (host arrays, as a user passes them) and subset
        queries: each query keeps a U(0.3, 1.0) share of the distinct ids
        of one indexed set (``bench.py``'s ensemble protocol)."""
        t0 = time.perf_counter()
        docs = make_token_sets(self.torch, n_sets, self.device, seed)
        rng = np.random.RandomState(7)
        src = rng.choice(n_sets, n_queries, replace=False)
        queries = []
        for i in src:
            s = np.unique(docs[i])
            q = s[rng.rand(s.size) < rng.uniform(0.3, 1.0)]
            queries.append(q if q.size else s[:1])
        log("[ensemble] corpus: %d sets, %d ids in all, %d subset queries (%.1f s)"
            % (n_sets, sum(map(len, docs)), n_queries, time.perf_counter() - t0))
        return docs, queries, src

    def phase_ensemble(self, docs, queries, src, escalates: bool = True):
        """The containment main path through the public facade: build by
        ``index_tokens``, then the query batch by scan, bands and auto.
        ``escalates``: some query matches more than 16 sets, so the scan
        reruns past its first k (true of the full-size corpus, whose
        queries' match counts grow with the number of sets)."""
        torch = self.torch
        from datasketch_tpu_torch import MinHash, TorchMinHashLSHEnsemble

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        index = TorchMinHashLSHEnsemble(threshold=ENS_THRESHOLD, num_perm=NUM_PERM,
                                        num_part=8, bucket_cap=128, max_results=2048,
                                        device=self.device)
        self.sync()
        t0 = time.perf_counter()
        index.index_tokens(range(len(docs)), docs)
        self.sync()
        self.ens_build_s = time.perf_counter() - t0
        log("[ensemble] index_tokens of %d sets: %.3f s; rs %s, N_pad %d, partition "
            "rows %s, uppers %s" % (len(docs), self.ens_build_s, index.rs, index._n_pad,
                                    index._n_valid.tolist(), [int(u) for u in index.uppers]))
        tables = [index._sigs] + [t for pair in index._tables.values() for t in pair]
        log("[ensemble] stacked signatures and band tables: %d B on the device"
            % sum(t.numel() * t.element_size() for t in tables))
        q_sigs = MinHash.bulk_signatures(queries, num_perm=NUM_PERM, hashfunc="device",
                                         out="device", device=self.device)
        q_sizes = np.array([q.size for q in queries])
        batch = (q_sigs, q_sizes)
        self.ens_qps, out = {}, {}
        for method in ("scan", "bands", "auto"):
            index.query_batch(batch, method=method)  # first call of the shape
            best = 0.0
            for _ in range(3):
                self.sync()
                t0 = time.perf_counter()
                rows = index.query_batch(batch, method=method)
                self.sync()
                best = max(best, len(queries) / (time.perf_counter() - t0))
            self.ens_qps[method] = best
            rec = float(np.mean([int(s) in row for s, row in zip(src, rows)]))
            out[method] = (rows, index.last_truncated, rec)
            log("[ensemble] query_batch %-5s %10.1f q/s recall %.4f truncated %d "
                "longest %d" % (method, best, rec, index.last_truncated, max(map(len, rows))))
        check(out["scan"][2] >= 0.9, "ensemble scan recall %.4f < 0.9" % out["scan"][2])
        check(max(map(len, out["scan"][0])) > 16 or not escalates,
              "no scan query escalated past k = 16")
        check(out["auto"][0] == out["scan"][0], "auto did not answer as the scan")
        sub = index.query_batch((q_sigs[:ENS_PLAIN_QUERIES], q_sizes[:ENS_PLAIN_QUERIES]),
                                method="scan")
        check(sub == out["scan"][0][:ENS_PLAIN_QUERIES],
              "the scan answers a sub-batch otherwise than the whole batch")
        if cuda:
            self.ens_peak = torch.cuda.max_memory_allocated()
            log("[ensemble] peak device memory %.3f GiB" % (self.ens_peak / 2**30))
        return index, q_sigs, q_sizes, out["scan"], sub

    def phase_ensemble_checks(self, index, q_sigs, q_sizes, scan, sub) -> None:
        """The scan's answers for the first queries against the plain
        version at full size, and its truncation count against exact match
        counts of the plain version."""
        torch = self.torch
        from datasketch_tpu_torch.kernels.lsh_scan import running_topk
        from datasketch_tpu_torch.kernels.score import score_matrix_plain

        sigs, sizes, keys, _ = index._scan_table()
        n, max_out = sigs.shape[0], min(index.max_results, sigs.shape[0])
        qs = torch.from_numpy(q_sizes.astype(np.int32)).to(self.device)

        def plain(q, q_s, k):
            return running_topk(q, sigs, k, n, None, ENS_THRESHOLD, score_matrix_plain,
                                sizes=sizes, q_sizes=q_s)

        n_match = plain(q_sigs, qs, 1)[2].long()
        want = int((n_match - max_out).clamp_min(0).sum())
        check(scan[1] == want, "scan last_truncated %d, exact counts give %d" % (scan[1], want))
        m = ENS_PLAIN_QUERIES
        ids = plain(q_sigs[:m], qs[:m], max_out)[0].cpu().numpy()
        check(sub == [keys[row[row >= 0]].tolist() for row in ids],
              "the scan's answers differ from the plain version's")
        log("[ensemble] scan answers of %d queries equal the plain version's at N=%d; "
            "last_truncated %d equals the exact count; match counts max %d, median %d"
            % (len(sub), n, want, int(n_match.max()), int(n_match.median())))

    def phase_ensemble_parity(self, n_sets: int = ENS_PARITY_SETS) -> None:
        """A CUDA ensemble against a device='cpu' one on one small corpus."""
        from datasketch_tpu_torch import MinHash, TorchMinHashLSHEnsemble

        docs, queries, _ = self.phase_ensemble_corpus(n_sets, 128, seed=43)
        sizes = np.array([q.size for q in queries])
        pair = [TorchMinHashLSHEnsemble(threshold=ENS_THRESHOLD, num_part=8, device=d)
                for d in (self.device, "cpu")]
        for ix in pair:
            ix.index_tokens(range(n_sets), docs)
        batches = [(MinHash.bulk_signatures(queries, num_perm=NUM_PERM, hashfunc="device",
                                            out="device", device=ix.device), sizes)
                   for ix in pair]
        for method in ("scan", "bands", "auto"):
            got = [ix.query_batch(b, method=method) for ix, b in zip(pair, batches)]
            if method == "bands":
                got = [[set(r) for r in g] for g in got]
            check(got[0] == got[1], "ensemble parity: %s differs" % method)
            check(pair[0].last_truncated == pair[1].last_truncated,
                  "ensemble parity: %s last_truncated differs" % method)
        log("[ensemble parity] %d sets x 128 queries: CUDA and CPU ensembles agree "
            "(scan, bands, auto)" % n_sets)


    # ---------------------------------------------------------- weighted

    def phase_weighted_corpus(self, n_rows: int = W_ROWS, n_queries: int = W_QUERIES):
        """The weighted rows as the host scipy CSR matrix a user passes,
        and ``n_queries`` queries: indexed rows (sources drawn with seed
        18) with each active weight scaled by U(0.85, 1.15)."""
        import scipy.sparse as sp

        t0 = time.perf_counter()
        vals, idx, indptr = make_weighted_rows(self.torch, n_rows, W_DIM, self.device, seed=17)
        x = sp.csr_matrix((vals.cpu().numpy(), idx.cpu().numpy(), indptr.cpu().numpy()),
                          shape=(n_rows, W_DIM))
        del vals, idx, indptr
        rng = np.random.RandomState(18)
        src = rng.choice(n_rows, n_queries, replace=False)
        q = x[src]
        q.data *= rng.uniform(0.85, 1.15, q.nnz).astype(np.float32)
        log("[weighted] corpus: %d CSR rows x %d dims, nnz %d (%.1f per row), %d queries "
            "(%.1f s)" % (n_rows, W_DIM, x.nnz, x.nnz / n_rows, n_queries,
                          time.perf_counter() - t0))
        return x, q, src

    def phase_weighted(self, x, q, src, cpu_rows: int = W_CPU_ROWS,
                       dense_rows: int = W_DENSE_ROWS):
        """The weighted main path through the public facade: CSR rows ->
        ``minhash_many(out="device")`` (kernel 7) -> ``TorchMinHashLSH`` ->
        top-k by scan and bands, threshold query by bands; the dense path
        (kernel 6) on the densified head; sampled rows against a
        ``device="cpu"`` generator."""
        torch = self.torch
        from datasketch_tpu_torch import TorchMinHashLSH, WeightedMinHashGenerator

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        n = x.shape[0]
        gen = WeightedMinHashGenerator(W_DIM, W_SAMPLES, seed=1, device=self.device)
        gen.minhash_many(x[:4096], out="device")  # warm: tables, allocator
        self.sync()
        t0 = time.perf_counter()
        kt = gen.minhash_many(x, out="device")
        self.sync()
        self.w_rate = n / (time.perf_counter() - t0)
        check(kt.shape == (n, W_SAMPLES, 2) and kt.dtype == torch.int32
              and kt.device.type == self.device.type,
              "minhash_many gave %s %s on %s" % (tuple(kt.shape), kt.dtype, kt.device))
        rows = np.sort(np.random.RandomState(19).choice(n, min(cpu_rows, n), replace=False))
        cpu_gen = WeightedMinHashGenerator(W_DIM, W_SAMPLES, seed=1, device="cpu")
        want = cpu_gen.minhash_many(x[rows], out="device").numpy()
        got = kt[torch.from_numpy(rows).to(self.device)].cpu().numpy()
        bad = np.argwhere((got != want).any(-1))
        for r, smp in bad:
            row = x[int(rows[r])]
            ties = [floor_near_tie(row, int(k), smp, gen) for k in (got[r, smp, 0],
                                                                     want[r, smp, 0])]
            check(any(ties), "row %d sample %d: (k, t) %s on the device, %s on the CPU, "
                  "and no floor near-tie at either winning dim"
                  % (rows[r], smp, got[r, smp].tolist(), want[r, smp].tolist()))
        log("[weighted] minhash_many of %d CSR rows: %.1f sketches/s (upload + kernel 7, "
            "synced); %d sampled rows against the CPU generator: %d (row, sample) "
            "mismatches (any must be a floor near-tie)" % (n, self.w_rate, rows.size,
                                                           len(bad)))
        dense = x[:dense_rows].toarray()
        self.sync()
        t0 = time.perf_counter()
        kd = gen.minhash_many(dense, out="device")
        self.sync()
        self.w_dense_rate = dense.shape[0] / (time.perf_counter() - t0)
        check(torch.equal(kd, kt[:dense_rows]), "the dense path differs from the CSR path")
        log("[weighted] minhash_many of %d dense rows (%d B): %.1f sketches/s (upload + "
            "kernel 6); equal to the CSR result" % (dense.shape[0], dense.nbytes,
                                                     self.w_dense_rate))
        del dense, kd
        index = TorchMinHashLSH(threshold=0.5, num_perm=W_SAMPLES, device=self.device)
        self.sync()
        t0 = time.perf_counter()
        index.index(range(n), kt)
        self.sync()
        self.w_build_s = time.perf_counter() - t0
        log("[weighted] index of %d (k, t) rows: %.3f s; status %s"
            % (n, self.w_build_s, json.dumps(index.status())))
        q_kt = gen.minhash_many(q, out="device")
        self.w_qps = {}
        calls = {
            "top_k scan": lambda: index.top_k(q_kt, W_TOP_K, method="scan"),
            "top_k bands": lambda: index.top_k(q_kt, W_TOP_K, method="bands"),
            "query_batch 0.5 bands": lambda: index.query_batch(q_kt, return_scores=True,
                                                               method="bands"),
        }
        for label, fn in calls.items():
            fn()  # first call of the shape
            best = 0.0
            for _ in range(3):
                self.sync()
                t0 = time.perf_counter()
                out = fn()
                self.sync()
                best = max(best, len(src) / (time.perf_counter() - t0))
            self.w_qps[label] = best
            rec = float(np.mean([int(s_) in [key for key, _ in row]
                                 for s_, row in zip(src, out)]))
            log("[weighted] %-21s %10.1f q/s recall %.4f truncated %d longest %d"
                % (label, best, rec, index.last_truncated, max(map(len, out))))
            if label == "top_k scan":
                check(rec >= 0.99, "weighted scan recall %.4f < 0.99" % rec)
            if label.startswith("query_batch"):
                check(all(sc >= 0.5 for row in out for _, sc in row),
                      "weighted query_batch returned a score below the threshold")
        if cuda:
            self.w_peak = torch.cuda.max_memory_allocated()
            log("[weighted] peak device memory %d B" % self.w_peak)
        return gen, kt

    def phase_weighted_checks(self, gen, x, kt, n_sets: int = W_ENS_SETS,
                              n_pairs: int = W_SLOT_PAIRS) -> None:
        """``kt_slots`` on the device against the host mix, and an
        ensemble built from (k, t) batches against a ``device="cpu"`` one."""
        torch = self.torch
        from datasketch_tpu_torch import TorchMinHashLSHEnsemble
        from datasketch_tpu_torch.ops.cws_ops import kt_slots, kt_slots_np

        rng = np.random.RandomState(20)
        pairs = np.stack([rng.randint(0, W_DIM, n_pairs),
                          rng.randint(-(1 << 20), 1 << 20, n_pairs)], axis=-1)
        pairs = pairs.astype(np.int32).reshape(-1, W_SAMPLES, 2)
        got = kt_slots(torch.from_numpy(pairs).to(self.device)).cpu().numpy().view(np.uint32)
        check(np.array_equal(got, kt_slots_np(pairs)), "kt_slots differs from the host mix")
        log("[weighted] kt_slots of %d pairs (t in [-2**20, 2**20)) equal the host mix"
            % n_pairs)
        sizes = np.diff(x.indptr[: n_sets + 1])
        qrows = rng.choice(n_sets, 128, replace=False)
        qx = x[qrows]
        qx.data *= rng.uniform(0.85, 1.15, qx.nnz).astype(np.float32)
        q_kt = gen.minhash_many(qx, out="device")
        q_sizes = np.diff(qx.indptr)
        pair = [TorchMinHashLSHEnsemble(threshold=ENS_THRESHOLD, num_part=8, device=d)
                for d in (self.device, "cpu")]
        for ix in pair:
            ix.index_batch(range(n_sets), kt[:n_sets].to(ix.device), sizes)
        for method in ("scan", "bands", "auto"):
            got = [ix.query_batch((q_kt.to(ix.device), q_sizes), method=method)
                   for ix in pair]
            if method == "bands":
                got = [[set(r) for r in g] for g in got]
            check(got[0] == got[1], "weighted ensemble parity: %s differs" % method)
            check(pair[0].last_truncated == pair[1].last_truncated,
                  "weighted ensemble parity: %s last_truncated differs" % method)
            rec = float(np.mean([int(s_) in row for s_, row in zip(qrows, got[0])]))
            if method == "scan":
                check(rec >= 0.9, "weighted ensemble scan recall %.4f < 0.9" % rec)
        log("[weighted ensemble parity] %d (k, t) sets x 128 queries: CUDA and CPU "
            "ensembles agree (scan, bands, auto)" % n_sets)

    # ------------------------------------------------------------- b-bit

    def phase_kernels_bbit(self, n_rows: int = N_INDEX, n_queries: int = N_QUERIES,
                           ragged=(1, 33, 1000)) -> None:
        """Kernel 5 against its plain version: every slot size at num_perm
        128, 100 and 256 on low-cardinality bits and ragged Q and T, then
        the serving shape (Q x N, num_perm 128) at b = 1 and b = 4, timed,
        with its bound and ``torch.cdist(p=0)`` on the unpacked slots."""
        torch = self.torch
        from datasketch_tpu_torch.ops import bbit_ops

        kb = self.kmod("bbit_scores")
        big = max(ragged)
        shapes = [(nq, nt) for nq in ragged for nt in ragged]
        for num_perm in (128, 100, 256):
            sigs = self.rand_sigs(2 * big, num_perm, 30 + num_perm, values=4)
            for b in (1, 2, 4, 8, 16, 32):
                s = bbit_ops.slot_size(b)
                packed = bbit_ops.pack_bbit(sigs, b)
                q, db = packed[:big], packed[big:]
                self.compare("bbit_scores", "b %d P %d, Q x T in %s" % (b, num_perm, ragged),
                             tuple(kb.bbit_counts(q[:nq], db[:nt], s) for nq, nt in shapes),
                             tuple(kb.bbit_counts_plain(q[:nq], db[:nt], s)
                                   for nq, nt in shapes))
        db_sigs = self.rand_sigs(n_rows, NUM_PERM, 40)
        g = torch.Generator(device=self.device).manual_seed(41)
        qidx = torch.randint(0, n_rows, (n_queries,), generator=g, device=self.device)
        q_sigs = self.near_copies(db_sigs[qidx], 0.7, 42)
        rec = self.record["bbit_scores"]
        for b in (1, 4):
            s = bbit_ops.slot_size(b)
            db, q = bbit_ops.pack_bbit(db_sigs, b), bbit_ops.pack_bbit(q_sigs, b)
            w = db.shape[1]
            case = "b %d: Q %d x T %d x W %d" % (b, n_queries, n_rows, w)
            got = kb.bbit_counts(q, db, s)
            self.compare("bbit_scores", case, got, kb.bbit_counts_plain(q, db, s))
            ms = self.time_ms(lambda: kb.bbit_counts(q, db, s))
            plain_ms = self.time_ms(lambda: kb.bbit_counts_plain(q, db, s), iters=1, warmup=0)
            ops = bbit_word_int_ops(s) * n_queries * n_rows * w
            nbytes = 4 * (n_queries + n_rows) * w + 4 * n_queries * n_rows
            # one PyTorch call with the same function: the Hamming distance
            # of the b-bit slots (cdist, p = 0) is num_perm minus the count
            mask = (1 << b) - 1
            qd = (q_sigs.to(torch.int64) & mask).double()
            dd = (db_sigs.to(torch.int64) & mask).double()
            same = (NUM_PERM - torch.cdist(qd, dd, p=0)).to(torch.int32) == got
            check(bool(same.all()), "cdist(p=0) does not give kernel 5's counts (b %d)" % b)
            del same, got
            lib_ms = self.time_ms(lambda: torch.cdist(qd, dd, p=0), iters=2)
            del qd, dd
            if b == 1:  # the timed shape of the kernels line: bbit-1m at b = 1
                rec["ms"], rec["plain_ms"], rec["library_ms"] = ms, plain_ms, lib_ms
                self.bound("bbit_scores", nbytes, int_ops=ops)
            log("  bbit_scores   %s: kernel %s ms, plain %s ms, cdist %s ms, %.3e ops, "
                "%.3e bytes" % (case, ms, plain_ms, lib_ms, ops, nbytes))

    def phase_bbit(self, sigs: np.ndarray, src, dst, b: int, n_queries: int = N_QUERIES,
                   n_remove: int = N_REMOVE) -> None:
        """bbit-1m: the lsh-1m corpus in a ``TorchBBitIndex`` (insert_batch
        of the int32 device tensor), ``query_batch`` k = 10 of planted
        queries, recall, the plain version on 64 queries, scores against
        ``bBitMinHash.jaccard``, removals, save / load and the status."""
        torch = self.torch
        from datasketch_tpu_torch import TorchBBitIndex, bBitMinHash
        from datasketch_tpu_torch.kernels.bbit import bbit_counts_plain
        from datasketch_tpu_torch.ops import bbit_ops

        cuda = self.device.type == "cuda"
        n = sigs.shape[0]
        dev_sigs = torch.from_numpy(sigs.view(np.int32)).to(self.device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        index = TorchBBitIndex(b=b, num_perm=NUM_PERM, device=self.device)
        self.sync()
        t0 = time.perf_counter()
        index.insert_batch(range(n), dev_sigs)
        self.sync()
        build_s = time.perf_counter() - t0
        queries = dev_sigs[torch.from_numpy(dst[-n_queries:]).to(self.device)]
        expect = src[-n_queries:]
        del dev_sigs
        qps, rows = self.timed_qps(lambda: index.query_batch(queries, TOP_K), n_queries)
        rec = float(np.mean([int(e) in row for e, row in zip(expect, rows)]))
        check(all(len(r) == TOP_K for r in rows), "bbit-1m b %d: short rows" % b)
        check(rec >= 0.99, "bbit-1m b %d: recall %.4f < 0.99" % (b, rec))
        m = min(64, n_queries)
        ids, cnt = index._query_dispatch(queries[:m], TOP_K)
        p_ids, p_cnt = bbit_ops.bbit_topk_scan(
            index._packed, bbit_ops.pack_bbit(queries[:m], b), TOP_K, b, NUM_PERM,
            counts_fn=bbit_counts_plain)
        check(torch.equal(ids, p_ids) and torch.equal(cnt, p_cnt),
              "bbit-1m b %d: ids / counts differ from the plain version" % b)
        check(rows[:m] == p_ids.cpu().tolist(),
              "bbit-1m b %d: answers differ from the plain version's ids" % b)
        scored = index.query_batch(queries[:16], TOP_K, return_scores=True)
        host_q = queries[:16].cpu().numpy().view(np.uint32)
        rng = np.random.RandomState(b)
        for qi, row in enumerate(scored):
            key, score = row[rng.randint(len(row))]
            want = bBitMinHash(_Sketch(host_q[qi]), b).jaccard(
                bBitMinHash(_Sketch(sigs[key]), b))
            check(score == want, "bbit-1m b %d: score %r of (%d, %d), bBitMinHash %r"
                  % (b, score, qi, key, want))
        removed = list(dict.fromkeys(r[0] for r in rows))[:n_remove]
        index.remove_batch(removed)
        gone = set(removed)
        after = index.query_batch(queries, TOP_K)
        check(not any(key in gone for row in after for key in row),
              "bbit-1m b %d: a removed key came back" % b)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "bbit")
            index.save(path)
            loaded = TorchBBitIndex.load(path, device=self.device)
        check(loaded.query_batch(queries, TOP_K, return_scores=True)
              == index.query_batch(queries, TOP_K, return_scores=True),
              "bbit-1m b %d: the loaded index answers otherwise" % b)
        status = index.status()
        check(status["compression_x"] == 32 // bbit_ops.slot_size(b),
              "bbit-1m b %d: compression_x %r" % (b, status["compression_x"]))
        peak = torch.cuda.max_memory_allocated() if cuda else None
        self.bbit[b] = {"build_s": build_s, "qps": qps, "recall": rec, "peak": peak}
        log("[bbit-1m] b %d: %d rows inserted from the device tensor in %.3f s; query_batch "
            "k=%d %.1f q/s, recall %.4f; %d queries equal the plain version, 16 scores equal "
            "bBitMinHash; %d removed keys never return; save/load answers equal; status %s; "
            "peak device memory %s B" % (b, n, build_s, TOP_K, qps, rec, m, len(removed),
                                        json.dumps(status), peak))

    def build_bbit_16m(self, n_rows: int = BBIT_ROWS, chunk: int = BBIT_CHUNK,
                       n_queries: int = N_QUERIES, seed: int = 19):
        """The bbit-16m index: ``synth_signatures``' law drawn on the card
        chunk by chunk (uniform 32-bit values; the last 20 % copy each slot
        of an earlier row with a per-row probability U(0.6, 0.95)), each
        chunk inserted into a b = 1 index as a device tensor. Returns
        (index, the last ``n_queries`` rows as planted queries, their
        sources, synced build s, host s inside ``insert_batch``, peak
        device bytes while building)."""
        torch = self.torch
        from datasketch_tpu_torch import TorchBBitIndex

        dev, cuda = self.device, self.device.type == "cuda"
        g = torch.Generator(device=dev).manual_seed(seed)
        n_dup = int(n_rows * 0.2)
        first = n_rows - n_dup
        src = torch.randint(0, first, (n_dup,), generator=g, device=dev)
        keep_p = torch.rand(n_dup, generator=g, device=dev) * 0.35 + 0.6
        full = torch.empty((n_rows, NUM_PERM), dtype=torch.int32, device=dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        index = TorchBBitIndex(b=1, num_perm=NUM_PERM, device=dev)
        host_s = 0.0
        self.sync()
        t_all = time.perf_counter()
        for r0 in range(0, n_rows, chunk):
            r1 = min(n_rows, r0 + chunk)
            rows = full[r0:r1]
            rows.random_(-(1 << 31), 1 << 31, generator=g)
            if r1 > first:  # sources lie below ``first``: written already
                lo = max(r0, first)
                i = torch.arange(lo - first, r1 - first, device=dev)
                keep = torch.rand((r1 - lo, NUM_PERM), generator=g, device=dev) < \
                    keep_p[i][:, None]
                rows[lo - r0:] = torch.where(keep, full[src[i]], rows[lo - r0:])
            t0 = time.perf_counter()
            index.insert_batch(range(r0, r1), rows)
            host_s += time.perf_counter() - t0
        self.sync()
        build_s = time.perf_counter() - t_all
        build_peak = torch.cuda.max_memory_allocated() if cuda else None
        queries = full[n_rows - n_queries:].clone()
        expect = src[-n_queries:].cpu().numpy()
        return index, queries, expect, build_s, host_s, build_peak

    def phase_bbit_16m(self, n_rows: int = BBIT_ROWS, chunk: int = BBIT_CHUNK,
                       n_queries: int = N_QUERIES, n_plain: int = 16) -> None:
        """bbit-16m: :meth:`build_bbit_16m`, then the planted queries by
        ``query_batch`` k = 10 and ``n_plain`` of them against the plain
        version."""
        torch = self.torch
        from datasketch_tpu_torch.kernels.bbit import bbit_counts_plain
        from datasketch_tpu_torch.ops import bbit_ops

        cuda = self.device.type == "cuda"
        index, queries, expect, build_s, host_s, build_peak = self.build_bbit_16m(
            n_rows, chunk, n_queries)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        qps, rows = self.timed_qps(lambda: index.query_batch(queries, TOP_K), n_queries)
        rec = float(np.mean([int(e) in row for e, row in zip(expect, rows)]))
        check(rec >= 0.98, "bbit-16m: recall %.4f < 0.98" % rec)
        ids, cnt = index._query_dispatch(queries[:n_plain], TOP_K)
        p_ids, p_cnt = bbit_ops.bbit_topk_scan(
            index._packed, bbit_ops.pack_bbit(queries[:n_plain], 1), TOP_K, 1, NUM_PERM,
            counts_fn=bbit_counts_plain)
        check(torch.equal(ids, p_ids) and torch.equal(cnt, p_cnt),
              "bbit-16m: ids / counts differ from the plain version")
        serve_peak = torch.cuda.max_memory_allocated() if cuda else None
        self.bbit16 = {"build_s": build_s, "host_s": host_s, "qps": qps, "recall": rec,
                       "build_peak": build_peak, "serve_peak": serve_peak}
        log("[bbit-16m] %d rows (b 1, %d B packed) inserted in %d chunks: %.3f s synced, of "
            "which %.3f s host time in insert_batch (key maps, validation; the device work "
            "is queued); query_batch k=%d %.1f q/s, recall %.4f; %d queries equal the plain "
            "version; peak device memory %s B while building (the raw signatures held), "
            "%s B while serving" % (n_rows, index._packed.numel() * 4, -(-n_rows // chunk),
                                    build_s, host_s, TOP_K, qps, rec, n_plain, build_peak,
                                    serve_peak))

    # -------------------------------------------------------------- text

    def phase_text(self, n_docs: int = SIG_DOCS, n_queries: int = N_QUERIES,
                   cpu_texts: int = 1024, n_tok_docs: int = 4096) -> None:
        """text-16k: the bench corpus as raw texts (tokens joined by b" "),
        k = 9 shingles. ``MinHash.bulk_from_text`` with both engines against
        a ``device="cpu"`` run (and the SHA1 engine against ``hashlib``),
        ``TorchMinHashLSH.index_text`` / ``top_k_text`` (scan and bands) and
        ``TorchBBitIndex(b=4).insert_text`` / ``query_batch`` on queries
        whose last 100 bytes are replaced, then the token front ends
        against a ``device="cpu"`` index."""
        torch = self.torch
        from datasketch_tpu_torch import MinHash, TorchBBitIndex, TorchMinHashLSH
        from datasketch_tpu_torch.ops.minhash_ops import init_permutations

        texts = [b" ".join(doc) for doc in make_corpus(n_docs, seed=42)]
        rng = np.random.RandomState(45)
        self.text_rate = {}
        sample = np.sort(rng.choice(n_docs, min(cpu_texts, n_docs), replace=False))
        for engine, kw in (("device", {"hashfunc": "device"}), ("sha1", {})):
            MinHash.bulk_from_text(texts[:1024], k=9, num_perm=NUM_PERM, out="device",
                                   device=self.device, **kw)  # warm the allocator
            rates = []
            for _ in range(2):
                self.sync()
                t0 = time.perf_counter()
                sigs = MinHash.bulk_from_text(texts, k=9, num_perm=NUM_PERM, out="device",
                                              device=self.device, **kw)
                self.sync()
                rates.append(n_docs / (time.perf_counter() - t0))
            self.text_rate[engine] = max(rates)
            want = MinHash.bulk_from_text([texts[i] for i in sample], k=9, num_perm=NUM_PERM,
                                          device="cpu", **kw)
            got = sigs[torch.from_numpy(sample).to(self.device)].cpu().numpy().view(np.uint32)
            check(np.array_equal(got, want),
                  "bulk_from_text(%s): the card differs from the CPU run" % engine)
            log("[text-16k] bulk_from_text %-6s %d texts (%d bytes): %s texts/s; %d sampled "
                "texts equal a device='cpu' run" % (
                    engine, n_docs, sum(map(len, texts)),
                    " / ".join("%.1f" % r for r in rates), sample.size))
        a, b = init_permutations(1, NUM_PERM)
        host = sigs.cpu().numpy().view(np.uint32)  # the SHA1 engine's
        for i in rng.choice(n_docs, 32, replace=False):
            t = texts[i]
            hv = np.array([int.from_bytes(hashlib.sha1(t[j: j + 9]).digest()[:4], "little")
                           for j in range(len(t) - 8)], dtype=np.uint64)[:, None]
            want = np.bitwise_and((hv * a + b) % np.uint64((1 << 61) - 1),
                                  np.uint64(0xFFFFFFFF)).min(axis=0)
            check(np.array_equal(host[i], want.astype(np.uint32)),
                  "bulk_from_text(sha1) row %d differs from hashlib + the host formula" % i)
        log("[text-16k] 32 SHA1-engine rows equal hashlib.sha1 + the host numpy formula")
        del sigs, host
        lsh = TorchMinHashLSH(threshold=0.5, num_perm=NUM_PERM, device=self.device)
        bb = TorchBBitIndex(b=4, num_perm=NUM_PERM, device=self.device)
        self.sync()
        t0 = time.perf_counter()
        lsh.index_text(range(n_docs), texts, k=9)
        self.sync()
        t_lsh = time.perf_counter() - t0
        t0 = time.perf_counter()
        bb.insert_text(range(n_docs), texts, k=9)
        self.sync()
        t_bb = time.perf_counter() - t0
        src = rng.choice(n_docs, min(n_queries, n_docs), replace=False)
        queries = [texts[i][:-100] + bytes(rng.randint(97, 123, 100, dtype=np.uint8))
                   for i in src]
        self.text_qps = {}
        calls = {
            "top_k_text scan": lambda: lsh.top_k_text(queries, TOP_K, method="scan"),
            "top_k_text bands": lambda: lsh.top_k_text(queries, TOP_K, method="bands"),
            "b-bit query_batch": lambda: bb.query_batch(MinHash.bulk_from_text(
                queries, k=9, num_perm=NUM_PERM, hashfunc="device", out="device",
                device=self.device), TOP_K),
        }
        for label, fn in calls.items():
            qps, rows = self.timed_qps(fn, len(queries))
            keys = [[kk for kk, _ in row] if label.startswith("top_k") else row for row in rows]
            rec = float(np.mean([int(s) in row for s, row in zip(src, keys)]))
            self.text_qps[label] = (qps, rec)
            log("[text-16k] %-17s %10.1f q/s (texts in, shingles hashed on the card) recall "
                "%.4f" % (label, qps, rec))
            check(rec >= 0.99, "text-16k %s: recall %.4f < 0.99" % (label, rec))
        self.text_build = (t_lsh, t_bb)
        log("[text-16k] index_text %.3f s, insert_text (b 4) %.3f s" % self.text_build)
        docs = make_token_sets(torch, n_tok_docs, self.device, seed=44)
        pair = [TorchMinHashLSH(threshold=0.5, num_perm=NUM_PERM, device=d)
                for d in (self.device, "cpu")]
        for ix in pair:
            ix.index_tokens(range(len(docs)), docs)
        q_docs = [d[: max(1, len(d) * 3 // 4)] for d in docs[:256]]
        for method in ("scan", "bands"):
            got = [ix.top_k_tokens(q_docs, TOP_K, method=method) for ix in pair]
            check(got[0] == got[1], "top_k_tokens(%s): card and CPU differ" % method)
        log("[text-16k] index_tokens / top_k_tokens of %d token docs: the card answers as "
            "a device='cpu' index (scan, bands)" % len(docs))

    # ------------------------------------------------------------ forest

    def phase_forest(self, sigs: np.ndarray, src, dst, n_queries: int = N_QUERIES):
        """forest-1m: the index phase's rows in a ``TorchMinHashLSHForest``
        (num_perm 128, l 8, cap 64), 1,024 planted queries at k 10 by the
        walk (rank 'forest', and rank 'jaccard' with pool 512), the scan
        and 'auto' (rank 'jaccard': the scan at this size), then a k 256
        scan (kernel 4). Scan recall of the planted source >= 0.99; the
        walk's recall is written down."""
        from datasketch_tpu_torch import TorchMinHashLSHForest

        n = sigs.shape[0]
        forest = TorchMinHashLSHForest(num_perm=NUM_PERM, l=FOREST_L, cap=FOREST_CAP,
                                       device=self.device)
        self.sync()
        t0 = time.perf_counter()
        forest.index(range(n), sigs)
        self.sync()
        self.forest_build_s = time.perf_counter() - t0
        status = forest.status()
        check(status["n_indexed"] == n, "forest holds %d rows" % status["n_indexed"])
        log("[forest-1m] %d rows indexed in %.3f s (upload, fingerprints, %d stable sorts "
            "per tree); status %s" % (n, self.forest_build_s, forest.k, json.dumps(status)))
        queries = sigs[dst[-n_queries:]]
        expect = src[-n_queries:]
        routes = {
            "walk forest": dict(method="forest", rank="forest"),
            "walk jaccard pool 512": dict(method="forest", rank="jaccard"),
            "scan": dict(method="scan", rank="jaccard"),
            "auto jaccard": dict(method="auto", rank="jaccard"),
        }
        self.forest_qps, answers = {}, {}
        for label, kw in routes.items():
            forest.pool = FOREST_POOL if label.startswith("walk jaccard") else 0
            qps, rows = self.timed_qps(
                lambda kw=kw: forest.query_batch(queries, TOP_K, return_scores=True, **kw),
                n_queries)
            rec = float(np.mean([int(s) in [kk for kk, _ in row]
                                 for s, row in zip(expect, rows)]))
            self.forest_qps[label] = (qps, rec, forest.last_truncated)
            answers[label] = rows
            log("[forest-1m] %-21s %10.1f q/s recall %.4f truncated %d"
                % (label, qps, rec, forest.last_truncated))
        forest.pool = 0
        check(self.forest_qps["scan"][1] >= 0.99,
              "forest scan recall %.4f < 0.99" % self.forest_qps["scan"][1])
        check(answers["auto jaccard"] == answers["scan"], "forest auto did not answer as the scan")
        check(all(len(r) == TOP_K for r in answers["scan"]), "forest scan: short rows")
        qps, rows = self.timed_qps(
            lambda: forest.query_batch(queries, FOREST_BIG_K, return_scores=True,
                                       method="scan", rank="jaccard"), n_queries)
        self.forest_qps["scan k=%d" % FOREST_BIG_K] = (qps, None, 0)
        check(all(len(r) == FOREST_BIG_K for r in rows), "forest k=%d scan: short rows"
              % FOREST_BIG_K)
        check(all(r[:TOP_K] == s for r, s in zip(rows, answers["scan"])),
              "forest k=%d scan does not extend the k=%d answer" % (FOREST_BIG_K, TOP_K))
        log("[forest-1m] scan k=%d %10.1f q/s (kernel 4)" % (FOREST_BIG_K, qps))
        return forest, queries

    def phase_forest_checks(self, forest, queries: np.ndarray, sigs: np.ndarray,
                            n_plain: int = FOREST_PLAIN_QUERIES, parity_rows: int = PARITY_ROWS,
                            parity_queries: int = PARITY_QUERIES) -> None:
        """The forest ops on ``n_plain`` queries with the kernels' plain twins
        on the same CUDA tensors (walk at both ranks, the scan at k 16 and
        256), a CUDA forest of ``parity_rows`` rows against a
        ``device="cpu"`` one (every route: answers, scores,
        ``last_truncated``), and save / load of it onto both devices."""
        torch = self.torch
        from datasketch_tpu_torch import TorchMinHashLSHForest
        from datasketch_tpu_torch.kernels.lsh_scan import topk_scan_plain
        from datasketch_tpu_torch.kernels.rerank import rerank_scores_plain
        from datasketch_tpu_torch.ops import forest_ops, lsh_ops

        q = torch.from_numpy(queries[:n_plain].view(np.int32)).to(self.device)
        db, n = forest._sigs, forest._sigs.shape[0]
        for rank, pool in (("forest", 0), ("jaccard", FOREST_POOL)):
            args = (forest._sorted_fps, forest._sorted_ids, db, q, forest.l, forest.k,
                    forest.cap, 16)
            got = forest_ops.forest_query_fused(*args, pool=pool, rank=rank)
            want = forest_ops.forest_query_fused(*args, pool=pool, rank=rank,
                                                 rerank=rerank_scores_plain)
            self.compare("rerank", "forest walk %s, %d queries" % (rank, n_plain), got, want)
        for k, name in ((16, "topk_scan"), (FOREST_BIG_K, "score_matrix")):
            self.compare(name, "forest scan k=%d, %d queries" % (k, n_plain),
                         lsh_ops.topk_scan(db, q, k),
                         topk_scan_plain(db, q, k, n, None, 0.0)[:2])
        log("[forest-1m] %d queries: the walk (both ranks) and the scans equal the ops run "
            "with the kernels' plain twins on the same CUDA tensors" % n_plain)
        sub = sigs[:parity_rows]
        rng = np.random.RandomState(23)
        rows = rng.choice(parity_rows, parity_queries, replace=False)
        keep = rng.rand(parity_queries, NUM_PERM) < 0.7
        noise = rng.randint(0, 1 << 32, size=keep.shape, dtype=np.uint64).astype(np.uint32)
        pq = np.where(keep, sub[rows], noise)
        pair = [TorchMinHashLSHForest(num_perm=NUM_PERM, l=FOREST_L, cap=FOREST_CAP, device=d)
                for d in (self.device, "cpu")]
        for ix in pair:
            ix.index(range(parity_rows), sub)

        def same(label, call, ixs):
            got = [call(ix) for ix in ixs]
            check(got[0] == got[1], "forest parity: %s differs" % label)
            check(ixs[0].last_truncated == ixs[1].last_truncated,
                  "forest parity: %s last_truncated differs" % label)

        calls = {
            "walk forest": lambda ix: ix.query_batch(pq, TOP_K, True, method="forest"),
            "walk jaccard": lambda ix: ix.query_batch(pq, TOP_K, True, rank="jaccard",
                                                      method="forest"),
            "scan": lambda ix: ix.query_batch(pq, TOP_K, True, rank="jaccard", method="scan"),
            "auto jaccard, 100 queries": lambda ix: ix.query_batch(pq[:100], TOP_K, True,
                                                                   rank="jaccard"),
        }
        for label, call in calls.items():
            same(label, call, pair)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "forest")
            pair[0].save(path)
            loaded = [TorchMinHashLSHForest.load(path, device=d) for d in (self.device, "cpu")]
        for label in ("walk forest", "scan"):
            same("loaded %s" % label, calls[label], [pair[0], loaded[1]])
            same("loaded on the card, %s" % label, calls[label], [loaded[0], pair[1]])
        log("[forest-1m] %d rows x %d queries: the CUDA forest and a device='cpu' one agree "
            "(ids, scores, last_truncated; walk at both ranks, scan, auto); saved on the card, "
            "loaded on the card and on the CPU, they answer the same" % (parity_rows,
                                                                           parity_queries))

    def forest_corpus(self, n_docs: int = SIG_DOCS, n_queries: int = N_QUERIES):
        """forest-16k's data: sign-16k's docs sketched at num_perm 256
        (``bench.py::bench_forest``'s cascade width) and ``n_queries``
        near-variants of them (a quarter of each doc's tokens replaced)."""
        from datasketch_tpu_torch import MinHash

        docs = make_corpus(n_docs, seed=42)
        rng = np.random.RandomState(29)
        qsrc = rng.choice(n_docs, n_queries, replace=False)
        q_docs = []
        for i in qsrc:
            doc = list(docs[i])
            for j in rng.choice(len(doc), len(doc) // 4, replace=False):
                doc[j] = bytes(rng.randint(0, 256, size=10, dtype=np.uint8))
            q_docs.append(doc)
        kw = dict(num_perm=FOREST16_PERM, out="device", device=self.device)
        return (MinHash.bulk_signatures(docs, **kw), MinHash.bulk_signatures(q_docs, **kw),
                qsrc)

    def phase_forest_16k(self, sigs, q_sigs, qsrc, batch: int = FOREST16_BATCH,
                         cpu_queries: int = FOREST16_BATCH) -> None:
        """forest-16k: ``bench_forest``'s forest (num_perm 128, l 8, cascade
        256, pool 512, rank 'jaccard') over the 16,384 docs; ``batch``-query
        batches by ``query_batch`` ('auto', here the scan, and the walk) and
        ``query_stream(depth=4)``, recall of the source doc, and the first
        ``cpu_queries`` answers against a ``device="cpu"`` forest."""
        from datasketch_tpu_torch import TorchMinHashLSHForest

        kw = dict(num_perm=NUM_PERM, l=FOREST_L, rank="jaccard", cascade_perm=FOREST16_PERM,
                  pool=FOREST_POOL)
        forest = TorchMinHashLSHForest(device=self.device, **kw)
        self.sync()
        t0 = time.perf_counter()
        forest.index(range(sigs.shape[0]), sigs)
        self.sync()
        build_s = time.perf_counter() - t0
        nq = q_sigs.shape[0]
        batches = [q_sigs[i: i + batch] for i in range(0, nq, batch)]
        self.forest16 = {"build_s": build_s}
        for method in ("auto", "forest"):
            qps, rows = self.timed_qps(
                lambda m=method: forest.query_batch(batches[0], TOP_K, method=m), len(batches[0]))
            stream = list(forest.query_stream(batches, TOP_K, depth=4, method=method))
            check(stream[0] == rows, "forest-16k %s: the stream's first batch differs" % method)
            flat = [row for b in stream for row in b]
            check(len(flat) == nq, "forest-16k %s: the stream lost queries" % method)
            sqps, _ = self.timed_qps(
                lambda m=method: list(forest.query_stream(batches, TOP_K, depth=4, method=m)),
                nq, reps=2)
            rec = float(np.mean([int(s) in row for s, row in zip(qsrc, flat)]))
            self.forest16[method] = (qps, sqps, rec)
            log("[forest-16k] %-6s query_batch of %d: %10.1f q/s; query_stream depth 4: "
                "%10.1f q/s; recall %.4f" % (method, len(batches[0]), qps, sqps, rec))
            check(rec >= 0.9, "forest-16k %s recall %.4f < 0.9" % (method, rec))
        cpu = TorchMinHashLSHForest(device="cpu", **kw)
        cpu.index(range(sigs.shape[0]), sigs.cpu())
        cq = q_sigs[:cpu_queries]
        for method in ("auto", "forest"):
            got = forest.query_batch(cq, TOP_K, True, method=method)
            check(got == cpu.query_batch(cq.cpu(), TOP_K, True, method=method),
                  "forest-16k %s: the card differs from the CPU forest" % method)
            check(forest.last_truncated == cpu.last_truncated,
                  "forest-16k %s: last_truncated differs" % method)
        log("[forest-16k] %d docs indexed in %.3f s; %d queries equal a device='cpu' forest "
            "(auto, walk)" % (sigs.shape[0], build_s, cq.shape[0]))

    def phase_facade2(self, sigs, q_sigs, n_queries: int = FOREST16_BATCH,
                      n_remove: int = 500) -> None:
        """facade-2: a cascade-256 ``TorchMinHashLSH`` (num_perm 128) over
        forest-16k's rows, built in two halves and merged, beside a
        ``device="cpu"`` one built the same way: bands, scan (k 10 and
        200) and threshold answers equal; then removals, ``compact``,
        ``query_b`` at every band count, ``save`` on the card and ``load``
        on the CPU, and the streams against the batch calls."""
        from datasketch_tpu_torch import TorchMinHashLSH

        host = sigs.cpu().numpy().view(np.uint32)
        q = q_sigs[:n_queries].cpu().numpy().view(np.uint32)
        n, half = host.shape[0], host.shape[0] // 2
        pair = []
        for dev in (self.device, "cpu"):
            ix, other = (TorchMinHashLSH(threshold=0.5, num_perm=NUM_PERM,
                                         cascade_perm=FOREST16_PERM, device=dev)
                         for _ in range(2))
            ix.index(range(half), host[:half])
            other.index(range(half, n), host[half:])
            ix.merge(other, check_overlap=True)
            pair.append(ix)
        card = pair[0]

        def same(label, call, ixs=pair):
            got = [call(ix) for ix in ixs]
            check(got[0] == got[1], "facade-2: %s differs" % label)
            check(ixs[0].last_truncated == ixs[1].last_truncated,
                  "facade-2: %s last_truncated differs" % label)

        calls = {
            "top_k bands": lambda ix: ix.top_k(q, TOP_K, method="bands"),
            "top_k scan": lambda ix: ix.top_k(q, TOP_K, method="scan"),
            "top_k k=200 scan": lambda ix: ix.top_k(q, 200, method="scan"),
            "query_batch bands": lambda ix: ix.query_batch(q, return_scores=True,
                                                           method="bands"),
            "query_batch scan": lambda ix: ix.query_batch(q, return_scores=True, method="scan"),
        }
        self.facade2 = {}
        for label, call in calls.items():
            same(label, call)
            self.facade2[label] = self.timed_qps(lambda c=call: c(card), n_queries)[0]
        removed = np.random.RandomState(31).choice(n, n_remove, replace=False).tolist()
        for ix in pair:
            for key in removed:
                ix.remove(key)
        same("top_k bands after removals", calls["top_k bands"])
        for ix in pair:
            ix.compact()
        check(card.status()["n_tombstoned"] == 0 and len(card) == n - n_remove,
              "facade-2: compact left %s" % card.status())
        for label in ("top_k scan", "query_batch bands"):
            same("%s after compact" % label, calls[label])
        for b in range(1, card.b + 1):
            same("query_b b=%d" % b, lambda ix, b=b: ix.query_b(q[:100], b))
        snaps = [ix.host_snapshot() for ix in pair]
        check(snaps[0]["keys"] == snaps[1]["keys"]
              and np.array_equal(snaps[0]["sigs"], snaps[1]["sigs"]),
              "facade-2: host snapshots differ")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "lsh")
            card.save(path)
            loaded = TorchMinHashLSH.load(path, device="cpu")
        for label, call in calls.items():
            same("loaded %s" % label, call, [card, loaded])
        batches = [q[i: i + 64] for i in range(0, n_queries, 64)]
        for method in ("bands", "scan"):
            stream = list(card.query_stream(batches, return_scores=True, method=method))
            check(stream == [card.query_batch(b, return_scores=True, method=method)
                             for b in batches], "facade-2: query_stream(%s) differs" % method)
            stream = list(card.top_k_stream(batches, TOP_K, method=method))
            check(stream == [card.top_k(b, TOP_K, method=method) for b in batches],
                  "facade-2: top_k_stream(%s) differs" % method)
        card.warmup()
        log("[facade-2] cascade %d over %d rows (merged halves): card and CPU agree on "
            "bands, scans (k 10, 200) and threshold answers, after %d removals and compact, "
            "query_b b=1..%d, a card save loaded on the CPU, streams equal the batch calls; "
            "q/s %s" % (FOREST16_PERM, n, n_remove, card.b,
                        json.dumps({k: round(v, 1) for k, v in self.facade2.items()})))

    def phase_ensemble_stream(self, index, q_sigs, q_sizes, batch: int = 256) -> None:
        """The ensemble's ``query_stream`` (the scan, staged k rerun inside
        the pipeline) against ``query_batch(method="scan")`` per batch."""
        nq = q_sigs.shape[0]
        batches = [(q_sigs[i: i + batch], q_sizes[i: i + batch]) for i in range(0, nq, batch)]
        self.sync()
        t0 = time.perf_counter()
        stream = list(index.query_stream(batches, depth=4))
        self.sync()
        qps = nq / (time.perf_counter() - t0)
        want = [index.query_batch(b, method="scan") for b in batches]
        check(stream == want, "ensemble query_stream differs from the batch scans")
        self.ens_stream_qps = qps
        log("[ensemble] query_stream of %d batches of %d (depth 4): %.1f q/s; equal to the "
            "batch scans" % (len(batches), batch, qps))

    def phase_minhash_objects(self, n_docs: int = 64) -> None:
        """minhash-objects: ``MinHash.update_batch`` of sign-16k docs on the
        card (``device_mode="always"``, kernel 1) against the host path,
        ``MinHash.bulk`` on the card, ``LeanMinHash`` bytes round trips,
        and ``union`` / ``merge`` / ``count``."""
        import struct

        from datasketch_tpu_torch import LeanMinHash, MinHash

        docs = make_corpus(n_docs, seed=42)
        t0 = time.perf_counter()
        card = []
        for doc in docs:
            m = MinHash(num_perm=NUM_PERM, device_mode="always", device=self.device)
            m.update_batch(doc)
            card.append(m)
        rate = n_docs / (time.perf_counter() - t0)
        for m, doc in zip(card, docs):
            h = MinHash(num_perm=NUM_PERM, device_mode="disable")
            h.update_batch(doc)
            check(m == h, "update_batch on the card differs from the host path")
        bulk = MinHash.bulk(docs, num_perm=NUM_PERM, device_mode="always", device=self.device)
        check(bulk == card, "MinHash.bulk on the card differs from update_batch")
        for m in card[:16]:
            lean = LeanMinHash(m)
            for order in ("<", ">"):
                buf = bytearray(lean.bytesize(order))
                lean.serialize(buf, order)
                seed, count = struct.unpack_from(order + "qi", buf, 0)
                check(seed == 1 and count == NUM_PERM, "LeanMinHash header %r" % ((seed, count),))
                check(LeanMinHash.deserialize(buf, order) == lean,
                      "LeanMinHash bytes do not round-trip")
        u = MinHash.union(*card[:8])
        m = card[0].copy()
        for other in card[1:8]:
            m.merge(other)
        check(u == m, "union differs from repeated merge")
        count = u.count()
        check(math.isfinite(count) and count > TOKENS_PER_DOC,
              "count of the union of 8 docs is %r" % count)
        self.mh_rate = rate
        log("[minhash-objects] %d docs by update_batch on the card: %.1f docs/s (one launch "
            "each); equal to the host path and to MinHash.bulk; LeanMinHash bytes round-trip; "
            "union of 8 = merge; count %.1f" % (n_docs, rate, count))

    def phase_hll(self, n_bench: int = HLL_BENCH_DOCS, n_docs: int = HLL_DOCS,
                  n_stream: int = HLL_STREAM, n_sample: int = HLL_SAMPLE) -> None:
        """hll: ``bench.py::bench_hll``'s configuration on the host path,
        then a full-size ``bulk_registers`` on the card (ids hashed there)
        held against the host path, ``count_batch`` against the CPU and a
        float64 numpy evaluation, the ``merge_regs`` fold against one
        sketch of the union, and ``HyperLogLog.update_batch`` on the card
        against the host."""
        torch = self.torch
        from datasketch_tpu_torch import HyperLogLog, HyperLogLogPlusPlus, native
        from datasketch_tpu_torch.ops import hll_ops
        from datasketch_tpu_torch.ops.hashing import mix64_np

        t_phase = time.perf_counter()
        p, m = HLL_P, 1 << HLL_P
        self.hll = {}
        docs = [[b"d%d-t%d" % (d, i) for i in range(HLL_TOKENS)] for d in range(n_bench)]
        HyperLogLogPlusPlus.bulk_registers(docs[:8], p=p)  # builds the native module
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            regs = HyperLogLogPlusPlus.bulk_registers(docs, p=p)
            rates.append(n_bench * HLL_TOKENS / (time.perf_counter() - t0))
        check(regs.shape == (n_bench, m) and regs.dtype == np.int8,
              "bulk_registers gave %s %s" % (regs.shape, regs.dtype))
        one = HyperLogLogPlusPlus(p=p, device_mode="disable")
        one.update_batch(docs[0])
        check(np.array_equal(regs[0], one.reg), "bulk_registers row 0 differs from update_batch")
        uniq = [b"u-%d" % i for i in range(n_stream)]
        h = HyperLogLogPlusPlus(p=p, device_mode="disable")
        t0 = time.perf_counter()
        for i in range(0, n_stream, 1 << 15):
            h.update_batch(uniq[i: i + (1 << 15)])
        stream_rate = n_stream / (time.perf_counter() - t0)
        rel_err = abs(h.count() - n_stream) / n_stream
        check(rel_err < 0.03, "stream of %d uniques counted %.1f (rel err %.4f)"
              % (n_stream, h.count(), rel_err))
        ids = [np.arange(i, i + HLL_TOKENS, dtype=np.uint64)
               for i in range(0, n_bench * HLL_TOKENS, HLL_TOKENS)]
        t0 = time.perf_counter()
        HyperLogLogPlusPlus.bulk_registers(ids, p=p, hashfunc="device")
        ids_rate = n_bench * HLL_TOKENS / (time.perf_counter() - t0)
        self.hll["bench"] = {"tokens_per_s": max(rates), "samples": rates,
                             "stream_tokens_per_s": stream_rate, "rel_err": rel_err,
                             "ids_tokens_per_s": ids_rate}
        log("[hll] bench_hll config (p %d, %d docs x %d tokens, host): %s tokens/s; "
            "%d-unique stream %.1f tokens/s, rel err %.5f; ids (host mix64) %.1f tokens/s"
            % (p, n_bench, HLL_TOKENS, " / ".join("%.1f" % r for r in rates), n_stream,
               stream_rate, rel_err, ids_rate))

        big = np.random.RandomState(23).randint(0, 1 << 24, size=(n_docs, HLL_TOKENS)
                                                ).astype(np.uint32)
        kw = dict(p=p, hashfunc="device")
        calls = hll_ops.device_calls
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        walls = []
        for _ in range(2):
            self.sync()
            t0 = time.perf_counter()
            regs = HyperLogLogPlusPlus.bulk_registers(big, device_mode="always",
                                                      device=self.device, **kw)
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        check(regs.shape == (n_docs, m), "device registers have shape %s" % (regs.shape,))
        if self.device.type == "cuda":
            check(hll_ops.device_calls > calls, "hll_ops ran no call on the card")
        rows = np.sort(np.random.RandomState(24).choice(n_docs, min(n_sample, n_docs),
                                                        replace=False))
        host = HyperLogLogPlusPlus.bulk_registers(big[rows], device_mode="disable", **kw)
        check(np.array_equal(regs[rows], host),
              "device registers differ from the host path on %d sampled rows" % len(rows))
        dev_ids = torch.from_numpy(big.view(np.int32)).to(self.device)
        lens = torch.full((n_docs,), HLL_TOKENS, dtype=torch.int32, device=self.device)
        scatter_ms = self.time_ms(lambda: hll_ops.sketch_batch64_ids(dev_ids, lens, p),
                                  iters=3)
        del dev_ids
        dev_regs = torch.from_numpy(regs).to(self.device)
        counts = hll_ops.count_batch(dev_regs, p)[torch.from_numpy(rows).to(self.device)].cpu()
        cpu_counts = hll_ops.count_batch(torch.from_numpy(regs[rows]), p)
        f64 = count_f64(regs[rows], p)
        err = max(float(((counts - cpu_counts).abs() / cpu_counts).max()),
                  float(np.max(np.abs(counts.numpy() - f64) / f64)))
        check(err <= 1e-5, "count_batch on the card is off by rtol %.3g" % err)
        fold = dev_regs
        while fold.shape[0] > 1:
            half = fold.shape[0] // 2
            rest = fold[2 * half:]
            fold = torch.cat([hll_ops.merge_regs(fold[:half], fold[half: 2 * half]), rest])
        union = HyperLogLogPlusPlus(p=p, device_mode="disable", hashfunc="device")
        native.hll_scatter(union.reg, mix64_np(big.reshape(-1)), np.array([big.size]), p,
                           union.max_rank)  # the host scatter of every hashed id
        check(np.array_equal(fold[0].cpu().numpy(), union.reg),
              "the merge_regs fold differs from one sketch of the union")
        del dev_regs, fold
        n_tok = n_docs * HLL_TOKENS
        self.hll["device"] = {"docs_per_s": n_docs / min(walls), "tokens_per_s": n_tok / min(walls),
                              "walls_s": walls, "scatter_ms": scatter_ms,
                              "peak_device_bytes": peak, "union_count": union.count()}
        log("[hll] %d docs x %d ids (%d tokens) bulk_registers on the card (upload + mix64 + "
            "scatter + 1 GiB copy back): %.1f docs/s, %.1f tokens/s (walls %s s); "
            "sketch_batch64_ids alone %s ms; peak device memory %d B; %d sampled rows equal "
            "the host path; count_batch within rtol %.2e of the CPU and float64; merge_regs "
            "fold equals the union's sketch (count %.1f)"
            % (n_docs, HLL_TOKENS, n_tok, n_docs / min(walls), n_tok / min(walls),
               " / ".join("%.3f" % w for w in walls), scatter_ms, peak, len(rows), err,
               union.count()))

        calls = hll_ops.device_calls
        on_card = HyperLogLog(p=p, device_mode="always", device=self.device)
        on_host = HyperLogLog(p=p, device_mode="disable")
        t0 = time.perf_counter()
        on_card.update_batch(uniq)
        card_rate = n_stream / (time.perf_counter() - t0)
        on_host.update_batch(uniq)
        check(on_card == on_host, "HyperLogLog.update_batch on the card differs from the host")
        if self.device.type == "cuda":
            check(hll_ops.device_calls > calls, "HyperLogLog.update_batch ran no call on the card")
        self.hll["update_batch_tokens_per_s"] = card_rate
        self.hll["seconds"] = time.perf_counter() - t_phase
        log("[hll] HyperLogLog.update_batch of %d tokens on the card: %.1f tokens/s, equal "
            "to the host path; phase %.1f s" % (n_stream, card_rate, self.hll["seconds"]))

    def phase_schemes(self, n_sig: int = SIG_DOCS, n_cpu: int = SCH_CPU_DOCS,
                      n_docs: int = SCH_DOCS, n_queries: int = SCH_QUERIES,
                      n_parity: int = SCH_PARITY_DOCS) -> None:
        """schemes: ``scheme="oph"`` and ``"cminhash"`` through
        ``MinHash.bulk_signatures`` over sign-16k's corpus (beside the
        permutation scheme's rate), a ``TorchMinHashLSH`` built by
        ``index_tokens(scheme=)`` and served by ``top_k`` (scan, bands), and
        a small CUDA index against a ``device="cpu"`` one."""
        torch = self.torch
        from datasketch_tpu_torch import MinHash, TorchMinHashLSH

        t_phase = time.perf_counter()
        self.schemes = {}
        corpus = make_corpus(n_sig, seed=42)
        cpu_rows = np.random.RandomState(28).choice(n_sig, min(n_cpu, n_sig), replace=False)
        rng = np.random.RandomState(29)
        ids = rng.randint(0, 1 << 20, size=(n_docs, TOKENS_PER_DOC)).astype(np.uint32)
        src = rng.randint(0, n_docs, size=n_queries)
        q_ids = ids[src].copy()
        swap = rng.rand(*q_ids.shape) < SCH_REPLACE
        q_ids[swap] = rng.randint(0, 1 << 20, size=int(swap.sum()))
        kw = dict(num_perm=NUM_PERM, seed=1, out="device", device=self.device)
        for scheme in ("permutation",) + SCHEMES:
            MinHash.bulk_signatures(corpus[:1024], scheme=scheme, **kw)  # first call
            rates = []
            for _ in range(2):
                self.sync()
                t0 = time.perf_counter()
                sigs = MinHash.bulk_signatures(corpus, scheme=scheme, **kw)
                self.sync()
                rates.append(n_sig / (time.perf_counter() - t0))
            rec = {"sigs_per_s": max(rates)}
            self.schemes[scheme] = rec
            if scheme == "permutation":
                log("[schemes] permutation: %s signatures/s over %d docs x %d SHA1 tokens"
                    % (" / ".join("%.1f" % r for r in rates), n_sig, TOKENS_PER_DOC))
                continue
            cpu = MinHash.bulk_signatures([corpus[i] for i in cpu_rows], scheme=scheme,
                                          num_perm=NUM_PERM, seed=1, device="cpu")
            check(np.array_equal(sigs[torch.from_numpy(cpu_rows).to(self.device)].cpu()
                                 .numpy().view(np.uint32), cpu),
                  "%s signatures on the card differ from device='cpu' on %d docs"
                  % (scheme, len(cpu_rows)))
            index = TorchMinHashLSH(threshold=0.5, num_perm=NUM_PERM, device=self.device)
            self.sync()
            t0 = time.perf_counter()
            index.index_tokens(range(n_docs), ids, scheme=scheme)
            self.sync()
            rec["build_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            q_sigs = MinHash.bulk_signatures(q_ids, scheme=scheme, hashfunc="device", **kw)
            self.sync()
            rec["query_sigs_per_s"] = n_queries / (time.perf_counter() - t0)
            for method in ("scan", "bands"):
                qps, rows = self.timed_qps(
                    lambda m=method: index.top_k(q_sigs, TOP_K, method=m), n_queries)
                recall = float(np.mean([int(w) in [k for k, _ in row]
                                        for w, row in zip(src, rows)]))
                check(recall >= 0.99, "%s top_k(%s) recall %.4f < 0.99"
                      % (scheme, method, recall))
                rec["top_k %s" % method] = (qps, recall)
            del index, q_sigs
            pair = [TorchMinHashLSH(threshold=0.5, num_perm=NUM_PERM, device=d)
                    for d in (self.device, "cpu")]
            for ix in pair:
                ix.index_tokens(range(n_parity), ids[:n_parity], scheme=scheme)
            q_small = q_ids[src < n_parity][:256]
            sigs_pair = [MinHash.bulk_signatures(q_small, scheme=scheme, num_perm=NUM_PERM,
                                                 hashfunc="device", device=d)
                         for d in (self.device, "cpu")]
            check(np.array_equal(*sigs_pair), "%s query signatures: card and CPU differ" % scheme)
            for method in ("scan", "bands"):
                got = [ix.top_k(sigs_pair[0], TOP_K, method=method) for ix in pair]
                check(got[0] == got[1], "%s %d-doc index top_k(%s): card and CPU differ"
                      % (scheme, n_parity, method))
            log("[schemes] %-8s %s signatures/s (%d docs equal device='cpu'); index_tokens of "
                "%d docs x %d ids %.3f s; %d queries sketched at %.1f q/s; top_k k=%d scan "
                "%.1f q/s recall %.4f, bands %.1f q/s recall %.4f; a %d-doc CUDA index answers "
                "as a device='cpu' one" % (
                    scheme, " / ".join("%.1f" % r for r in rates), len(cpu_rows), n_docs,
                    TOKENS_PER_DOC, rec["build_s"], n_queries, rec["query_sigs_per_s"], TOP_K,
                    *rec["top_k scan"], *rec["top_k bands"], n_parity))
        self.schemes["seconds"] = time.perf_counter() - t_phase
        log("[schemes] phase %.1f s" % self.schemes["seconds"])

    def phase_bloom(self, sigs: np.ndarray, n: int = BLOOM_N,
                    n_parity: int = BLOOM_PARITY_ROWS, parity_n: int = BLOOM_PARITY_N,
                    expect=(9, 13, 958505838, 7)) -> None:
        """bloom: a ``TorchMinHashLSHBloom`` sized for ``n`` keys on the card,
        the index phase's rows inserted in batches and all queried back (no
        false negative), fresh signatures (false positives within b x fp),
        then a smaller filter against a ``device="cpu"`` one word for word,
        and its ``save`` / ``load`` on the card and onto the CPU (the large
        filter's compressed save takes ~50 s: ``tools/profile_torch.py
        bloom`` times it)."""
        torch = self.torch
        from datasketch_tpu_torch import TorchMinHashLSHBloom

        t_phase = time.perf_counter()
        bloom = TorchMinHashLSHBloom(threshold=BLOOM_THRESHOLD, num_perm=NUM_PERM, n=n,
                                     fp=BLOOM_FP, device=self.device)
        shape = (bloom.b, bloom.r, bloom.num_bits, bloom.num_hashes)
        check(expect is None or shape == tuple(expect), "bloom (b, r, bits, probes) %s" % (shape,))
        n_rows = sigs.shape[0]
        batches = np.array_split(np.arange(n_rows), BLOOM_BATCHES)
        self.sync()
        t0 = time.perf_counter()
        for rows in batches:
            bloom.insert_batch(sigs[rows])
        self.sync()
        insert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hit = np.concatenate([bloom.query_batch(sigs[rows]) for rows in batches])
        query_s = time.perf_counter() - t0
        check(hit.all(), "%d inserted rows were not found (false negatives)" % (~hit).sum())
        fresh = np.random.RandomState(31).randint(0, 1 << 32, size=(BLOOM_FRESH, NUM_PERM),
                                                  dtype=np.uint64).astype(np.uint32)
        fp_rate = float(bloom.query_batch(fresh).mean())
        check(fp_rate <= bloom.b * BLOOM_FP, "false-positive rate %.4f > b x fp" % fp_rate)
        words_bytes = bloom._words.numel() * 4
        del bloom
        pair = [TorchMinHashLSHBloom(threshold=BLOOM_THRESHOLD, num_perm=NUM_PERM, n=parity_n,
                                     fp=BLOOM_FP, device=d) for d in (self.device, "cpu")]
        for ix in pair:
            ix.insert_batch(sigs[:n_parity])
        check(torch.equal(pair[0]._words.cpu(), pair[1]._words),
              "the %d-row CUDA filter's words differ from device='cpu'" % n_parity)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            pair[0].save(os.path.join(tmp, "bloom"))
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = TorchMinHashLSHBloom.load(os.path.join(tmp, "bloom"), device=self.device)
            load_s = time.perf_counter() - t0
            check(torch.equal(back._words, pair[0]._words), "a card checkpoint loads other words")
            on_cpu = TorchMinHashLSHBloom.load(os.path.join(tmp, "bloom"), device="cpu")
            check(torch.equal(on_cpu._words, pair[1]._words),
                  "a card checkpoint loaded on the CPU holds other words")
            probe = np.concatenate([sigs[:512], fresh[:512]])
            check(np.array_equal(on_cpu.query_batch(probe), back.query_batch(probe)),
                  "the CPU copy of the filter answers otherwise")
        self.bloom = {"inserts_per_s": n_rows / insert_s, "queries_per_s": n_rows / query_s,
                      "fp_rate": fp_rate, "save_s": save_s, "load_s": load_s,
                      "words_bytes": words_bytes, "seconds": time.perf_counter() - t_phase}
        log("[bloom] b %d, r %d, %d bits a band, %d probes: %d B of words on the card; %d rows "
            "inserted in %d batches at %.1f rows/s, queried back at %.1f rows/s (no false "
            "negative); %d fresh signatures hit at %.4f; a %d-row filter (n %d) equals "
            "device='cpu' word for word, its card checkpoint (save %.2f s, load %.2f s) loads "
            "on the card and on the CPU and answers alike; phase %.1f s"
            % (*shape, words_bytes, n_rows, BLOOM_BATCHES, self.bloom["inserts_per_s"],
               self.bloom["queries_per_s"], BLOOM_FRESH, fp_rate, n_parity, parity_n, save_s,
               load_s, self.bloom["seconds"]))

    # ---------------------------------------------------------------- HNSW

    def hnsw_corpus(self, n_sets: int = HNSW_SETS, seed: int = 41):
        """bench_hnsw's clustered token sets, drawn on the card
        (:func:`clustered_sets`)."""
        t0 = time.perf_counter()
        docs = clustered_sets(self.torch, n_sets, self.device, seed)
        log("[hnsw] corpus: %d clustered sets, %d ids in all (%.1f s)"
            % (n_sets, sum(map(len, docs)), time.perf_counter() - t0))
        return docs

    def hnsw_recall(self, points, q_rows, rows) -> float:
        """Recall@10 of ``rows`` (answers of the corpus rows ``q_rows``)
        against kernel 2's exact scan of the same signatures: a hit is a
        result whose equal-slot count reaches the exact 10th best."""
        torch = self.torch
        from datasketch_tpu_torch.kernels import lsh_scan

        q = points[torch.as_tensor(q_rows, device=self.device)]
        _, sc, _ = lsh_scan.topk_scan(points, q, TOP_K, points.shape[0])
        c10 = torch.round(sc[:, -1].double() * points.shape[1]).long()
        ids = torch.tensor([[k for k, _ in row] + [-1] * (TOP_K - len(row)) for row in rows],
                           device=self.device)
        got = (points[ids.clamp_min(0)] == q[:, None, :]).sum(-1)
        hit = (got >= c10[:, None]) & (ids >= 0)
        return float(hit.sum()) / (len(rows) * TOP_K)

    def phase_hnsw(self, docs, n_queries: int = HNSW_QUERIES):
        """hnsw-1m: ``TorchHNSW(minhash_jaccard, m 16, ef 64).index_tokens``
        over the clustered sets (kernel 1 signs, kernel 2 finds each node's
        48 nearest rows), then ``n_queries`` corpus members by
        ``query_batch`` and by ``query_stream`` (4 batches, depth 4). The
        launch counts are read around this phase."""
        torch = self.torch
        from datasketch_tpu_torch import TorchHNSW

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        index = TorchHNSW(distance_metric="minhash_jaccard", m=HNSW_M, ef=HNSW_EF,
                          device=self.device)
        n = len(docs)
        self.sync()
        t0 = time.perf_counter()
        index.index_tokens(range(n), docs, num_perm=NUM_PERM)
        self.sync()
        self.hnsw = {"build_s": time.perf_counter() - t0}
        g = index._graph
        q_rows = np.random.RandomState(43).choice(n, n_queries, replace=False)
        q = g.points[torch.as_tensor(q_rows, device=self.device)]
        qps, rows = self.timed_qps(lambda: index.query_batch(q, TOP_K), n_queries)
        batches = [q[i: i + n_queries // 4] for i in range(0, n_queries, n_queries // 4)]
        stream = [r for b in index.query_stream(batches, TOP_K, depth=4) for r in b]
        check(stream == rows, "hnsw-1m: query_stream answers otherwise than query_batch")
        sqps, _ = self.timed_qps(
            lambda: list(index.query_stream(batches, TOP_K, depth=4)), n_queries, reps=2)
        self.hnsw.update(qps=qps, stream_qps=sqps, levels=1 + len(g.upper_nodes),
                         upper_sizes=[int(u.shape[0]) for u in g.upper_nodes])
        if cuda:
            self.hnsw["peak_bytes"] = torch.cuda.max_memory_allocated()
        log("[hnsw-1m] index_tokens of %d sets: %.3f s, levels %d %s; query_batch of %d: "
            "%.1f q/s; query_stream (4 x %d, depth 4): %.1f q/s; peak device memory %s B"
            % (n, self.hnsw["build_s"], self.hnsw["levels"], self.hnsw["upper_sizes"],
               n_queries, qps, n_queries // 4, sqps, self.hnsw.get("peak_bytes")))
        return index, q_rows, rows

    def phase_hnsw_checks(self, index, docs, q_rows, rows, n_sample: int = HNSW_SAMPLE,
                          n_cpu: int = HNSW_CPU_QUERIES, n_adds: int = HNSW_ADDS,
                          n_removes: int = HNSW_REMOVES) -> None:
        """hnsw-1m's checks: recall@10; for ``n_sample`` nodes, their
        signatures from the build (kernel 1, in the build's chunks) against
        the plain signer on the CPU, and their kNN rows by the build's
        kernel route against the plain distance tiles on the card; ``n_cpu``
        answers against the same graph on the CPU; then ``n_adds`` adds and
        a flush (the append path) and ``n_removes`` removals, and the
        queries again."""
        torch = self.torch
        from datasketch_tpu_torch import MinHash
        from datasketch_tpu_torch.ops import hnsw_ops, knn_graph

        g = index._graph
        n = g.n
        rec = self.hnsw_recall(g.points, q_rows, rows)
        self.hnsw["recall"] = rec
        log("[hnsw-1m] recall@10 against kernel 2's exact scan: %.4f" % rec)
        check(rec >= HNSW_RECALL_FLOOR, "hnsw-1m recall %.4f < %.1f" % (rec, HNSW_RECALL_FLOOR))
        sample_np = np.random.RandomState(44).choice(n, n_sample, replace=False)
        sample = torch.as_tensor(sample_np, device=self.device)
        host = MinHash.bulk_signatures([docs[i] for i in sample_np], num_perm=NUM_PERM,
                                       hashfunc="device", out="device", device="cpu")
        check(torch.equal(g.points[sample].cpu(), host),
              "hnsw-1m: kernel 1's signatures differ from the plain signer's")
        log("[hnsw-1m] signatures of %d sampled sets equal the plain signer's on the CPU"
            % n_sample)
        kc = 3 * HNSW_M
        route = knn_graph.knn_route(g.points, kc, "minhash_jaccard")
        t0 = time.perf_counter()
        want = knn_graph.knn_adjacency(g.points, kc, "minhash_jaccard", rows=sample,
                                       _route="tiles")
        self.sync()
        plain_s = time.perf_counter() - t0
        got = knn_graph.knn_adjacency(g.points, kc, "minhash_jaccard", rows=sample)
        check(torch.equal(got, want), "hnsw-1m: the %s route's kNN rows differ from the "
              "plain tiles'" % route)
        log("[hnsw-1m] kNN rows of %d nodes: the %s route equals the plain tiles (%.2f s)"
            % (n_sample, route, plain_s))
        dist = hnsw_ops.distance_fn("minhash_jaccard")
        cpu_g = hnsw_ops.DeviceGraph(
            points=g.points.cpu(), adj0=g.adj0.cpu(),
            upper_nodes=[u.cpu() for u in g.upper_nodes],
            upper_adj=[a.cpu() for a in g.upper_adj], entry=g.entry, keys=g.keys,
            deleted=g.deleted.cpu())
        qc = g.points[torch.as_tensor(q_rows[:n_cpu], device=self.device)]
        want = hnsw_ops.search(cpu_g, qc.cpu(), dist, TOP_K, HNSW_EF, HNSW_EF)
        got = hnsw_ops.search(g, qc, dist, TOP_K, HNSW_EF, HNSW_EF)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              "hnsw-1m: %d answers on the card differ from the same graph on the CPU" % n_cpu)
        del cpu_g
        log("[hnsw-1m] %d answers equal the same graph queried on the CPU" % n_cpu)

        src = torch.as_tensor(np.random.RandomState(45).choice(n, n_adds, replace=False),
                              device=self.device)
        new = self.near_copies(g.points[src], 0.8, seed=46).cpu().numpy()
        self.sync()
        t0 = time.perf_counter()
        for i in range(n_adds):
            index.add(("new", i), new[i])
        index.flush()
        self.sync()
        add_s = time.perf_counter() - t0
        check(index.status()["appended_since_build"] == n_adds,
              "hnsw-1m: the adds were not appended")
        found = index.query_batch(new, 1)
        hit = float(np.mean([bool(r) and r[0][0] == ("new", i) for i, r in enumerate(found)]))
        gone = [int(k) for k in q_rows[:n_removes]]
        t0 = time.perf_counter()
        for key in gone:
            index.remove(key)
        self.sync()
        remove_s = time.perf_counter() - t0
        after = index.query_batch(g.points[torch.as_tensor(q_rows, device=self.device)], TOP_K)
        dead = set(gone)
        check(all(k not in dead for row in after for k, _ in row),
              "hnsw-1m: a removed key came back")
        self.hnsw.update(add_s=add_s, added_self_hit=hit, remove_s=remove_s)
        log("[hnsw-1m] %d adds + flush (append path): %.3f s, %.4f find themselves first; "
            "%d removals %.3f s; no removed key in %d answers"
            % (n_adds, add_s, hit, n_removes, remove_s, len(after)))
        check(hit >= HNSW_RECALL_FLOOR, "hnsw-1m: appended points find themselves at %.4f" % hit)

    def phase_hnsw_16k(self, docs, batch: int = HNSW16_BATCH):
        """hnsw-16k: ``bench_hnsw``'s protocol (16,384 clustered sets, m 16,
        ef 64) by ``index_tokens``, then ``batch``-query batches by
        ``query_batch`` and ``query_stream``. The launch counts are read
        around this phase; :meth:`phase_hnsw_16k_checks` follows it."""
        torch = self.torch
        from datasketch_tpu_torch import TorchHNSW

        index = TorchHNSW(distance_metric="minhash_jaccard", m=HNSW_M, ef=HNSW_EF,
                          device=self.device)
        n = len(docs)
        self.sync()
        t0 = time.perf_counter()
        index.index_tokens(range(n), docs, num_perm=NUM_PERM)
        self.sync()
        build_s = time.perf_counter() - t0
        g = index._graph
        q_rows = np.random.RandomState(47).choice(n, 4 * batch, replace=False)
        q = g.points[torch.as_tensor(q_rows, device=self.device)]
        batches = [q[i: i + batch] for i in range(0, 4 * batch, batch)]
        qps, rows = self.timed_qps(lambda: index.query_batch(batches[0], TOP_K), batch)
        sqps, _ = self.timed_qps(
            lambda: list(index.query_stream(batches, TOP_K, depth=4)), 4 * batch, reps=2)
        self.hnsw16 = {"build_s": build_s, "qps": qps, "stream_qps": sqps}
        log("[hnsw-16k] %d sets: build %.3f s; query_batch of %d %.1f q/s, query_stream "
            "(4 x %d, depth 4) %.1f q/s" % (n, build_s, batch, qps, batch, sqps))
        return index, q_rows, rows, batches

    def phase_hnsw_16k_checks(self, index, docs, q_rows, rows, batches,
                              n_pts: int = HNSW_PTS) -> None:
        """hnsw-16k's checks: recall@10; a ``device="cpu"`` index by
        ``index_tokens`` over the same sets (kernel 1's plain signer): its
        signatures, adjacency, levels, entry and answers equal the card's;
        then ``HNSW.from_points`` on the card against the CPU at ``n_pts``
        points, ``from_hnsw`` and a save / load round trip."""
        torch = self.torch
        from datasketch_tpu_torch import HNSW, TorchHNSW

        g = index._graph
        n, batch = g.n, batches[0].shape[0]
        rec = self.hnsw_recall(g.points, q_rows[:batch], rows)
        cpu = TorchHNSW(distance_metric="minhash_jaccard", m=HNSW_M, ef=HNSW_EF,
                        device="cpu")
        t0 = time.perf_counter()
        cpu.index_tokens(range(n), docs, num_perm=NUM_PERM)
        cpu_s = time.perf_counter() - t0
        c = cpu._graph
        check(torch.equal(g.points.cpu(), c.points),
              "hnsw-16k: kernel 1's signatures differ from the plain signer's")
        check(torch.equal(g.adj0.cpu(), c.adj0) and g.entry == c.entry
              and len(g.upper_nodes) == len(c.upper_nodes)
              and all(torch.equal(a.cpu(), b) for a, b in zip(g.upper_nodes, c.upper_nodes))
              and all(torch.equal(a.cpu(), b) for a, b in zip(g.upper_adj, c.upper_adj)),
              "hnsw-16k: the card's graph differs from the CPU's")
        check(cpu.query_batch(batches[0].cpu(), TOP_K) == rows,
              "hnsw-16k: the card's answers differ from the CPU's")
        log("[hnsw-16k] recall@10 %.4f; index_tokens on the CPU %.1f s: equal signatures, "
            "graph and %d answers" % (rec, cpu_s, batch))
        check(rec >= HNSW_RECALL_FLOOR, "hnsw-16k recall %.4f < %.1f" % (rec, HNSW_RECALL_FLOOR))
        self.hnsw16.update(cpu_build_s=cpu_s, recall=rec)

        pts = g.points[:n_pts].cpu().numpy().view(np.uint32)
        pair = [HNSW.from_points(pts, metric="minhash_jaccard", m=HNSW_M, device=d)
                for d in (self.device, "cpu")]
        check([lay._graph for lay in pair[0]._graphs] == [lay._graph for lay in pair[1]._graphs]
              and pair[0]._entry_point == pair[1]._entry_point,
              "hnsw-16k: HNSW.from_points on the card differs from the CPU")
        snaps = [TorchHNSW.from_hnsw(h, distance_metric="minhash_jaccard", device=d)
                 for h, d in zip(pair, (self.device, "cpu"))]
        probe = pts[:batch]
        check(snaps[0].query_batch(probe, TOP_K) == snaps[1].query_batch(probe, TOP_K),
              "hnsw-16k: from_hnsw answers differ between the card and the CPU")
        with tempfile.TemporaryDirectory() as tmp:
            index.save(os.path.join(tmp, "hnsw"))
            for d in (self.device, "cpu"):
                back = TorchHNSW.load(os.path.join(tmp, "hnsw"), device=d)
                check(back.query_batch(batches[0].to(back.device), TOP_K) == rows,
                      "hnsw-16k: a checkpoint loaded on %s answers otherwise" % d)
        log("[hnsw-16k] HNSW.from_points of %d points: the card's layers, edge distances and "
            "entry equal the CPU's; from_hnsw answers alike; save / load on the card and the "
            "CPU answer alike" % n_pts)

    def phase_hnsw_l2(self, n: int = L2_POINTS, n_queries: int = HNSW_QUERIES,
                      n_cpu: int = L2_CPU_POINTS) -> None:
        """hnsw-65k-l2: ``n`` x 128 float32 points in Gaussian clusters of
        16 (seed 31) under ``l2`` (the plain distance tiles), ``n_queries``
        fresh points near the clusters, recall@10 against a float64 brute
        force; then ``n_cpu`` integer-valued points built on the card and on
        the CPU: equal graphs and answers."""
        torch = self.torch
        from datasketch_tpu_torch import TorchHNSW

        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(31)
        centers = torch.randn((n // L2_CLUSTER, L2_DIM), generator=gen, device=dev) * 4
        pts = centers.repeat_interleave(L2_CLUSTER, 0) + torch.randn(
            (n, L2_DIM), generator=gen, device=dev)
        near = torch.randint(0, centers.shape[0], (n_queries,), generator=gen, device=dev)
        q = centers[near] + torch.randn((n_queries, L2_DIM), generator=gen, device=dev)
        index = TorchHNSW(distance_metric="l2", m=HNSW_M, ef=HNSW_EF, device=dev)
        self.sync()
        t0 = time.perf_counter()
        index.index(range(n), pts)
        self.sync()
        build_s = time.perf_counter() - t0
        qps, rows = self.timed_qps(lambda: index.query_batch(q, TOP_K), n_queries)
        p64, q64 = pts.double(), q.double()
        exact = torch.cat([((p64[None] - q64[i: i + 16, None]) ** 2).sum(-1)
                           for i in range(0, n_queries, 16)])
        d10 = torch.sort(exact, dim=1).values[:, TOP_K - 1]
        ids = torch.tensor([[k for k, _ in row] + [0] * (TOP_K - len(row)) for row in rows],
                           device=dev)
        lens = torch.tensor([len(row) for row in rows], device=dev)
        ok = torch.arange(TOP_K, device=dev)[None, :] < lens[:, None]
        rec = float(((exact.gather(1, ids) <= d10[:, None]) & ok).sum()) / (n_queries * TOP_K)
        log("[hnsw-65k-l2] %d x %d points: build %.3f s (plain tiles), query_batch of %d "
            "%.1f q/s, recall@10 against float64 %.4f" % (n, L2_DIM, build_s, n_queries, qps,
                                                         rec))
        check(rec >= HNSW_RECALL_FLOOR, "hnsw-65k-l2 recall %.4f < %.1f"
              % (rec, HNSW_RECALL_FLOOR))
        del index, exact, p64
        ipts = torch.round(pts[:n_cpu]).cpu()
        pair = [TorchHNSW(distance_metric="l2", m=HNSW_M, ef=HNSW_EF, device=d)
                for d in (dev, "cpu")]
        t0 = time.perf_counter()
        pair[1].index(range(n_cpu), ipts)
        cpu_s = time.perf_counter() - t0
        pair[0].index(range(n_cpu), ipts.to(dev))
        a, b = pair[0]._graph, pair[1]._graph
        check(torch.equal(a.adj0.cpu(), b.adj0) and a.entry == b.entry
              and all(torch.equal(x.cpu(), y) for x, y in zip(a.upper_adj, b.upper_adj)),
              "hnsw-65k-l2: the card's integer-valued graph differs from the CPU's")
        iq = torch.round(q[:64]).cpu()
        check(pair[0].query_batch(iq.to(dev), TOP_K) == pair[1].query_batch(iq, TOP_K),
              "hnsw-65k-l2: the card's answers differ from the CPU's")
        self.hnsw_l2 = {"build_s": build_s, "qps": qps, "recall": rec, "cpu_build_s": cpu_s}
        log("[hnsw-65k-l2] %d integer-valued points: the card's graph and 64 answers equal "
            "the CPU's (CPU build %.1f s)" % (n_cpu, cpu_s))

    def phase_hnsw_m48(self, pts) -> None:
        """A build at m 48 on the signature rows ``pts``: 144 candidates per
        node take kernel 4's route (its launches are read around this
        phase; :meth:`phase_hnsw_m48_check` follows it)."""
        from datasketch_tpu_torch import TorchHNSW

        self.sync()
        t0 = time.perf_counter()
        index = TorchHNSW(distance_metric="minhash_jaccard", m=48, ef=HNSW_EF,
                          device=self.device)
        index.index(range(pts.shape[0]), pts)
        self.sync()
        self.hnsw_m48 = {"build_s": time.perf_counter() - t0}
        log("[hnsw-m48] %d rows at m 48: build %.3f s" % (pts.shape[0],
                                                          self.hnsw_m48["build_s"]))

    def phase_hnsw_m48_check(self, pts) -> None:
        """The m 48 build's kNN rows (kernel 4's route) equal the plain
        tiles'."""
        from datasketch_tpu_torch.ops import knn_graph

        check(knn_graph.knn_route(pts, 144, "minhash_jaccard") == "score",
              "the m 48 build did not take kernel 4's route")
        got = knn_graph.knn_adjacency(pts, 144, "minhash_jaccard")
        want = knn_graph.knn_adjacency(pts, 144, "minhash_jaccard", _route="tiles")
        check(self.torch.equal(got, want),
              "m 48: kernel 4's kNN rows differ from the plain tiles'")
        log("[hnsw-m48] kernel 4's kNN rows equal the plain tiles'")

    # ------------------------------------------------------------- sharded

    def mesh(self, n: int = SH_POSITIONS, shape=None, device=None):
        """A mesh of ``n`` positions sharing this run's device (or
        ``device``): one card standing in for several, as the JAX tests'
        virtual CPU devices do. Default shape (n, 1): n document shards."""
        from datasketch_tpu_torch.parallel import make_mesh

        return make_mesh(n, shape=shape or (n, 1), device=device or self.device)

    def same_topk(self, label: str, got, want) -> None:
        """Top-k rows held as failover-1m holds host against device: score
        columns equal and the ids above each row's k-th score equal."""
        check(len(got) == len(want), "%s: %d rows vs %d" % (label, len(got), len(want)))
        for qi, (g, w) in enumerate(zip(got, want)):
            check([s for _, s in g] == [s for _, s in w],
                  "%s: query %d's score column differs" % (label, qi))
            if w:
                kth = w[-1][1]
                check({k for k, s in g if s > kth} == {k for k, s in w if s > kth},
                      "%s: query %d's ids above the k-th score differ" % (label, qi))

    def phase_sharded_lsh(self, index, sigs: np.ndarray, dst, n_queries: int = N_QUERIES):
        """sharded-lsh-1m: the served index's rows (its device signatures,
        no host round trip) in a ``ShardedMinHashLSH(threshold 0.5)`` over 4
        positions on the card, the served index's 1,000 removals, then the
        1,024 queries by ``top_k`` k 10 (scan, bands, auto) and k 256 (scan),
        ``query_batch`` at 0.5 (bands, scan), ``top_k_stream``, ``compact``,
        ``status``, ``save`` and ``load`` onto a 2-position mesh. The launch
        counts are read around this path; its checks follow in
        :meth:`phase_sharded_lsh_checks`."""
        from datasketch_tpu_torch.parallel import ShardedMinHashLSH

        n = index._n_real
        queries = sigs[dst[-n_queries:]]
        mesh = self.mesh()
        self.sync()
        t0 = time.perf_counter()
        sh = ShardedMinHashLSH(mesh, threshold=0.5, num_perm=NUM_PERM, bucket_cap=128)
        sh.index(range(n), index._sigs)
        self.sync()
        stats = {"build_s": time.perf_counter() - t0, "qps": {}, "truncated": {}}
        for key in sorted(self.removed):
            sh.remove(key)
        calls = [("top_k k=%d %s" % (TOP_K, m), lambda m=m: sh.top_k(queries, TOP_K, method=m))
                 for m in ("scan", "bands", "auto")]
        calls.append(("top_k k=%d scan" % BIG_K,
                      lambda: sh.top_k(queries, BIG_K, method="scan")))
        calls += [("query_batch 0.5 %s" % m,
                   lambda m=m: sh.query_batch(queries, return_scores=True, method=m))
                  for m in ("bands", "scan")]
        answers = {}
        for label, fn in calls:
            stats["qps"][label], answers[label] = self.timed_qps(fn, n_queries)
            stats["truncated"][label] = sh.last_truncated
            log("[sharded-lsh-1m] %-22s %10.1f q/s truncated %d"
                % (label, stats["qps"][label], sh.last_truncated))
        batches = [queries[i: i + n_queries // 4] for i in range(0, n_queries, n_queries // 4)]
        answers["stream"] = [r for b in sh.top_k_stream(batches, TOP_K, depth=4) for r in b]
        self.sync()
        t0 = time.perf_counter()
        sh.compact()
        self.sync()
        stats["compact_s"] = time.perf_counter() - t0
        stats["status"] = sh.status()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            sh.save(os.path.join(tmp, "sharded"))
            stats["save_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = ShardedMinHashLSH.load(os.path.join(tmp, "sharded.npz"),
                                            self.mesh(2))
            stats["load_s"] = time.perf_counter() - t0
        self.sharded_lsh = stats
        return sh, loaded, queries, answers

    def phase_sharded_lsh_checks(self, index, sigs: np.ndarray, sh, loaded, queries, answers,
                                 parity_rows: int = PARITY_ROWS,
                                 parity_queries: int = PARITY_QUERIES,
                                 n_host: int = FO_HOST_QUERIES) -> None:
        """sharded-lsh-1m's checks, after its launch counts are read: the
        scans against the served (unsharded) index over the same rows, the
        bands against the same sharded class on the CPU at ``parity_rows``
        rows, the reloaded index, and ``FailoverIndex`` over the sharded
        index (device path, a real failed probe, host answers)."""
        torch = self.torch
        from datasketch_tpu_torch import FailoverIndex
        from datasketch_tpu_torch.parallel import ShardedMinHashLSH
        from datasketch_tpu_torch.utils import HealthMonitor

        st = self.sharded_lsh
        gone = self.removed
        check(st["status"]["n_live"] == index._n_real - len(gone) and
              st["status"]["n_shards"] == 4 and st["status"]["n_tombstoned"] == 0,
              "sharded-lsh-1m status %s" % json.dumps(st["status"]))
        for k in (TOP_K, BIG_K):
            label = "top_k k=%d scan" % k
            self.same_topk("sharded-lsh-1m " + label, answers[label],
                           index.top_k(queries, k, method="scan"))
        check(answers["top_k k=%d auto" % TOP_K] == answers["top_k k=%d scan" % TOP_K],
              "sharded-lsh-1m: auto did not answer as the scan")
        check(answers["stream"] == answers["top_k k=%d auto" % TOP_K],
              "sharded-lsh-1m: top_k_stream answers otherwise than top_k")
        want = index.query_batch(queries, return_scores=True, method="scan")
        if st["truncated"]["query_batch 0.5 scan"] == 0 and index.last_truncated == 0:
            check(answers["query_batch 0.5 scan"] == want,
                  "sharded-lsh-1m: threshold scan lists differ from the unsharded index's")
        check(not any(k in gone for rows in answers.values() for r in rows for k, _ in r),
              "sharded-lsh-1m: a removed key came back")
        # the bands against the same class on the CPU at a cut size
        rows = index._sigs[:parity_rows]
        pq = sigs[np.arange(0, parity_rows, parity_rows // parity_queries)]
        pair = [ShardedMinHashLSH(self.mesh(device=d), threshold=0.5, num_perm=NUM_PERM,
                                  bucket_cap=128) for d in (self.device, "cpu")]
        for ix in pair:
            ix.index(range(parity_rows), rows.to(ix.mesh.home))
            ix.remove(3)
        for label, call in (("top_k bands", lambda ix: ix.top_k(pq, TOP_K, method="bands")),
                            ("query_batch bands", lambda ix: ix.query_batch(
                                pq, return_scores=True, method="bands")),
                            ("query_batch 0.3 bands", lambda ix: ix.query_batch(
                                pq, threshold=0.3, method="bands"))):
            a, b = call(pair[0]), call(pair[1])
            check(a == b and pair[0].last_truncated == pair[1].last_truncated,
                  "sharded-lsh-1m %s: the card (truncated %d) and the CPU (truncated %d) "
                  "differ" % (label, pair[0].last_truncated, pair[1].last_truncated))
        del pair
        # the reloaded index
        check(loaded.n_shards == 2 and len(loaded) == len(sh), "the reloaded index holds %d "
              "rows on %d shards" % (len(loaded), loaded.n_shards))
        check(loaded.top_k(queries, TOP_K, method="scan") == sh.top_k(queries, TOP_K,
                                                                       method="scan"),
              "sharded-lsh-1m: the reloaded index's scan answers differ")
        check(loaded.query_batch(queries, method="scan") == sh.query_batch(queries,
                                                                           method="scan"),
              "sharded-lsh-1m: the reloaded index's threshold answers differ")
        # FailoverIndex over the sharded index
        fo = FailoverIndex(sh, monitor=HealthMonitor(max_failures=1, device=self.device))
        probe = fo.check()
        check(probe["ok"], "sharded-lsh-1m: the probe of a healthy card failed: %s" % probe)
        hq = queries[:n_host]
        dev_top = fo.top_k(hq, TOP_K, method="scan")
        dev_thr = fo.query_batch(hq, return_scores=True, method="scan")
        check(fo.last_path == "device" and dev_top == sh.top_k(hq, TOP_K, method="scan"),
              "sharded-lsh-1m: the wrapper's device path answers otherwise")
        fo.monitor.device = "cuda:%d" % torch.cuda.device_count()
        tripped = fo.check()
        fo.monitor.device = self.device
        check(not tripped["ok"] and fo.serving_from_host,
              "sharded-lsh-1m: a failed probe did not trip the wrapper: %s" % tripped)
        host_top = fo.top_k(hq, TOP_K)
        host_thr = fo.query_batch(hq, return_scores=True)
        check(fo.last_path == "host", "a tripped wrapper answered from the device")
        self.same_topk("sharded-lsh-1m host top_k", host_top, dev_top)
        check(host_thr == dev_thr, "sharded-lsh-1m: host and device threshold answers differ")
        check(not any(k in gone for r in host_top + host_thr for k, _ in r),
              "sharded-lsh-1m: the host path returned a removed key")
        fo.resume_device()
        check(fo.top_k(hq, TOP_K, method="scan") == dev_top and fo.last_path == "device",
              "sharded-lsh-1m: resume_device() did not return to the device")
        log("[sharded-lsh-1m] %d rows over 4 positions of one %s: build %.3f s, compact %.3f "
            "s, save %.2f s, load onto 2 positions %.2f s; scans equal the unsharded index's "
            "(score columns, ids above the k-th), the bands equal a device='cpu' sharded index "
            "over %d rows (answers, last_truncated), the reloaded index answers alike, "
            "FailoverIndex: device, a real failed probe, %d host answers equal the device's"
            % (index._n_real, self.device.type, st["build_s"], st["compact_s"], st["save_s"],
               st["load_s"], parity_rows, n_host))

    def phase_sharded_sketch(self, n_docs: int = SIG_DOCS, hll_rows: int = SH_HLL_ROWS):
        """sharded-sketch: ``sharded_compute_signatures`` of sign-16k's
        corpus on a (2, 2) mesh (kernel 1 per block), equal to
        ``MinHash.bulk_signatures`` and to the plain signer; then
        ``distributed_minhash_union`` and ``distributed_hll_union`` over the
        4 positions, equal to numpy's min and max."""
        torch = self.torch
        from datasketch_tpu_torch import native
        from datasketch_tpu_torch.parallel import (
            distributed_hll_union,
            distributed_minhash_union,
            sharded_compute_signatures,
        )

        corpus = self.sig_corpus[:n_docs]
        flat, lengths = native.hash_ragged(corpus)
        width = int(lengths.max())
        hashes = np.zeros((n_docs, width), dtype=np.uint32)
        hashes[np.arange(width)[None, :] < lengths[:, None]] = flat
        mesh = self.mesh(4, shape=(2, 2))
        hashes_dev = torch.from_numpy(hashes.view(np.int32)).to(self.device)
        lengths_dev = torch.from_numpy(lengths).to(self.device)
        self.sync()
        t0 = time.perf_counter()
        sh = sharded_compute_signatures(hashes_dev, lengths_dev, seed=1, num_perm=NUM_PERM,
                                        mesh=mesh)
        full = sh.full()
        self.sync()
        sign_s = time.perf_counter() - t0
        union = distributed_minhash_union(sh, mesh)
        g = torch.Generator(device=self.device).manual_seed(17)
        regs = torch.randint(0, 50, (hll_rows, 1 << 14), generator=g, device=self.device,
                             dtype=torch.int8)
        merged = distributed_hll_union(regs, mesh)
        self.sync()
        self.sharded_sketch = {"docs_per_s": n_docs / sign_s}
        return full, union, regs, merged, flat, lengths

    def phase_sharded_sketch_checks(self, full, union, regs, merged, flat, lengths) -> None:
        torch = self.torch
        from datasketch_tpu_torch import MinHash
        from datasketch_tpu_torch.kernels.minhash_sign import minhash_sign_plain
        from datasketch_tpu_torch.ops.minhash_ops import perm_tensors

        n_docs = full.shape[0]
        want = MinHash.bulk_signatures(self.sig_corpus[:n_docs], num_perm=NUM_PERM, seed=1,
                                       out="device", device=self.device)
        check(torch.equal(full, want), "sharded-sketch: the (2, 2) mesh's signatures differ "
              "from MinHash.bulk_signatures")
        starts = np.zeros(n_docs, dtype=np.int64)
        np.cumsum(lengths[:-1], out=starts[1:])
        a, b = perm_tensors(1, NUM_PERM, self.device)
        plain = minhash_sign_plain(torch.from_numpy(flat.view(np.int32)).to(self.device),
                                   torch.from_numpy(starts).to(self.device),
                                   torch.from_numpy(lengths).to(self.device), a, b)
        check(torch.equal(full, plain), "sharded-sketch: signatures differ from the plain signer")
        host = full.cpu().numpy().view(np.uint32)
        check(np.array_equal(union.cpu().numpy().view(np.uint32), host.min(axis=0)),
              "sharded-sketch: the MinHash union differs from numpy's min")
        check(np.array_equal(merged.cpu().numpy(), regs.cpu().numpy().max(axis=0)),
              "sharded-sketch: the HLL union differs from numpy's max")
        log("[sharded-sketch] %d docs on a (2, 2) mesh: %.1f docs/s (4 blocks, kernel 1 each); "
            "equal to MinHash.bulk_signatures and the plain signer; the MinHash union over the "
            "4 positions equals numpy's min, the HLL union of %d x 16384 registers numpy's max"
            % (n_docs, self.sharded_sketch["docs_per_s"], regs.shape[0]))

    def phase_sharded_bbit(self, sigs: np.ndarray, src, dst, n_queries: int = N_QUERIES,
                           parity_rows: int = PARITY_ROWS, parity_queries: int = PARITY_QUERIES):
        """ShardedBBitIndex b 1 over 4 positions on lsh-1m's rows (the int32
        device tensor), 1,024 planted queries at k 10, 1,000 removals; its
        launches are read around this path. Returns the parity check."""
        torch = self.torch
        from datasketch_tpu_torch.parallel import ShardedBBitIndex

        n = sigs.shape[0]
        dev = torch.from_numpy(sigs.view(np.int32)).to(self.device)
        ix = ShardedBBitIndex(self.mesh(), b=1, num_perm=NUM_PERM)
        self.sync()
        t0 = time.perf_counter()
        ix.insert_batch(range(n), dev)
        self.sync()
        build_s = time.perf_counter() - t0
        queries = dev[torch.from_numpy(dst[-n_queries:]).to(self.device)]
        qps, rows = self.timed_qps(lambda: ix.query_batch(queries, TOP_K), n_queries)
        rec = float(np.mean([int(e) in row for e, row in zip(src[-n_queries:], rows)]))
        removed = list(dict.fromkeys(r[0] for r in rows))[:N_REMOVE]
        ix.remove_batch(removed)
        after = ix.query_batch(queries, TOP_K)
        del dev
        check(rec >= 0.99, "sharded bbit recall %.4f < 0.99" % rec)
        check(not any(k in set(removed) for r in after for k in r),
              "sharded bbit: a removed key came back")

        def parity():
            pair = [ShardedBBitIndex(self.mesh(device=d), b=1, num_perm=NUM_PERM)
                    for d in (self.device, "cpu")]
            pq = sigs[np.arange(0, parity_rows, parity_rows // parity_queries)]
            for p in pair:
                p.insert_batch(range(parity_rows), sigs[:parity_rows])
                p.remove_batch([5, 6])
            check(pair[0].query_batch(pq, TOP_K, return_scores=True) ==
                  pair[1].query_batch(pq, TOP_K, return_scores=True),
                  "sharded bbit: the card and the CPU answer otherwise")
            return "%d rows x %d queries equal a device='cpu' index" % (parity_rows, len(pq))

        self.sharded_idx["bbit b=1"] = {"build_s": build_s, "qps": qps, "recall": rec}
        return parity

    def phase_sharded_forest(self, sigs: np.ndarray, src, dst, n_queries: int = N_QUERIES,
                             parity_rows: int = PARITY_ROWS, n_parity: int = 64):
        """ShardedMinHashLSHForest (l 8, cap 64) over 4 positions on lsh-1m's
        rows: the walk (rank 'forest') and the scan (rank 'jaccard') at k
        10, the k 256 scan (kernel 4)."""
        torch = self.torch
        from datasketch_tpu_torch.parallel import ShardedMinHashLSHForest

        n = sigs.shape[0]
        dev = torch.from_numpy(sigs.view(np.int32)).to(self.device)
        ix = ShardedMinHashLSHForest(self.mesh(), num_perm=NUM_PERM, l=FOREST_L, cap=FOREST_CAP)
        self.sync()
        t0 = time.perf_counter()
        ix.index(range(n), dev)
        self.sync()
        build_s = time.perf_counter() - t0
        del dev
        queries = sigs[dst[-n_queries:]]
        out = {"build_s": build_s}
        for label, kw in (("walk", dict(method="forest", rank="forest")),
                          ("scan", dict(method="scan", rank="jaccard"))):
            qps, rows = self.timed_qps(lambda kw=kw: ix.query_batch(queries, TOP_K, **kw),
                                       n_queries)
            out[label] = (qps, float(np.mean([int(e) in r for e, r in
                                              zip(src[-n_queries:], rows)])),
                          ix.last_truncated)
        qps, big = self.timed_qps(lambda: ix.query_batch(queries, FOREST_BIG_K, method="scan",
                                                         rank="jaccard"), n_queries)
        out["scan k=%d" % FOREST_BIG_K] = qps
        check(out["scan"][1] >= 0.99, "sharded forest scan recall %.4f < 0.99" % out["scan"][1])
        check(all(len(r) == FOREST_BIG_K for r in big), "sharded forest k=256: short rows")

        def parity():
            pair = [ShardedMinHashLSHForest(self.mesh(device=d), num_perm=NUM_PERM, l=FOREST_L,
                                            cap=FOREST_CAP) for d in (self.device, "cpu")]
            for p in pair:
                p.index(range(parity_rows), sigs[:parity_rows])
            pq = sigs[np.arange(0, parity_rows, parity_rows // n_parity)]
            for kw in (dict(method="forest", rank="forest"), dict(method="scan", rank="jaccard")):
                a = pair[0].query_batch(pq, TOP_K, return_scores=True, **kw)
                b = pair[1].query_batch(pq, TOP_K, return_scores=True, **kw)
                check(a == b and pair[0].last_truncated == pair[1].last_truncated,
                      "sharded forest %s: the card and the CPU answer otherwise" % kw["method"])
            return "%d rows x %d queries equal a device='cpu' forest (walk, scan)" % (
                parity_rows, n_parity)

        self.sharded_idx["forest"] = out
        return parity

    def phase_sharded_bloom(self, sigs: np.ndarray, n_rows: int = HOST_LSH_ROWS,
                            n: int = BLOOM_N, parity_rows: int = BLOOM_PARITY_ROWS,
                            parity_n: int = BLOOM_PARITY_N):
        """ShardedMinHashLSHBloom (threshold 0.8, n 100M, fp 0.01: 1 GiB of
        words over 4 positions) holding lsh-1m's first ``n_rows`` rows,
        queried back with 1,024 fresh signatures."""
        from datasketch_tpu_torch.parallel import ShardedMinHashLSHBloom

        ix = ShardedMinHashLSHBloom(self.mesh(), threshold=BLOOM_THRESHOLD, num_perm=NUM_PERM,
                                    n=n, fp=BLOOM_FP)
        rows = sigs[:n_rows]
        self.sync()
        t0 = time.perf_counter()
        ix.insert_batch(rows)
        self.sync()
        insert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hit = ix.query_batch(rows)
        query_s = time.perf_counter() - t0
        fresh = np.random.RandomState(32).randint(0, 1 << 32, size=(N_QUERIES, NUM_PERM),
                                                  dtype=np.uint64).astype(np.uint32)
        fp_rate = float(ix.query_batch(fresh).mean())
        check(hit.all(), "sharded bloom: %d false negatives" % (~hit).sum())
        check(fp_rate <= ix.b * BLOOM_FP, "sharded bloom false-positive rate %.4f" % fp_rate)

        def parity():
            pair = [ShardedMinHashLSHBloom(self.mesh(device=d), threshold=BLOOM_THRESHOLD,
                                           num_perm=NUM_PERM, n=parity_n, fp=BLOOM_FP)
                    for d in (self.device, "cpu")]
            for p in pair:
                p.insert_batch(sigs[:parity_rows])
            check(np.array_equal(pair[0]._host_words(), pair[1]._host_words()),
                  "sharded bloom: the card's words differ from the CPU's")
            probe = np.concatenate([sigs[:512], fresh[:512]])
            check(np.array_equal(pair[0].query_batch(probe), pair[1].query_batch(probe)),
                  "sharded bloom: the card and the CPU answer otherwise")
            return "a %d-row filter equals a device='cpu' one word for word" % parity_rows

        self.sharded_idx["bloom"] = {"inserts_per_s": n_rows / insert_s,
                                     "queries_per_s": n_rows / query_s, "fp_rate": fp_rate}
        return parity

    def phase_sharded_ensemble(self, docs, queries, src, parity_sets: int = ENS_PARITY_SETS):
        """ShardedMinHashLSHEnsemble (threshold 0.8, 8 partitions) over 4
        positions by ``index_tokens`` of ensemble-1m's sets, its subset
        queries by scan (kernel 2's sizes mode, the k = 2,048 rerun on
        kernel 4) and bands (kernel 3 is not on the bands path: its probe
        returns candidates only)."""
        from datasketch_tpu_torch import MinHash
        from datasketch_tpu_torch.parallel import ShardedMinHashLSHEnsemble

        ix = ShardedMinHashLSHEnsemble(self.mesh(), threshold=ENS_THRESHOLD, num_perm=NUM_PERM,
                                       num_part=8, bucket_cap=128, max_results=2048)
        self.sync()
        t0 = time.perf_counter()
        ix.index_tokens(range(len(docs)), docs)
        self.sync()
        out = {"build_s": time.perf_counter() - t0}
        q_sigs = MinHash.bulk_signatures(queries, num_perm=NUM_PERM, hashfunc="device",
                                         out="device", device=self.device)
        batch = (q_sigs, np.array([q.size for q in queries]))
        for method in ("scan", "bands"):
            qps, rows = self.timed_qps(lambda m=method: ix.query_batch(batch, method=m),
                                       len(queries))
            rec = float(np.mean([int(s) in row for s, row in zip(src, rows)]))
            out[method] = (qps, rec, ix.last_truncated)
        check(out["scan"][1] >= 0.9, "sharded ensemble scan recall %.4f" % out["scan"][1])

        def parity():
            from datasketch_tpu_torch.parallel import ShardedMinHashLSHEnsemble as E

            pd, pq, _ = self.phase_ensemble_corpus(parity_sets, 128, seed=43)
            pair = [E(self.mesh(device=d), threshold=ENS_THRESHOLD, num_perm=NUM_PERM,
                      num_part=8, bucket_cap=128, max_results=64) for d in (self.device, "cpu")]
            for p in pair:
                p.index_tokens(range(len(pd)), pd)
            qb = (MinHash.bulk_signatures(pq, num_perm=NUM_PERM, hashfunc="device", out="host",
                                          device="cpu"), np.array([q.size for q in pq]))
            for method in ("scan", "bands"):
                a, b = (p.query_batch(qb, method=method) for p in pair)
                if method == "bands":
                    a, b = [sorted(r) for r in a], [sorted(r) for r in b]
                check(a == b and pair[0].last_truncated == pair[1].last_truncated,
                      "sharded ensemble %s: the card and the CPU answer otherwise" % method)
            return "%d sets x %d queries equal a device='cpu' ensemble (scan, bands)" % (
                parity_sets, len(pq))

        self.sharded_idx["ensemble"] = out
        return parity

    def phase_sharded_hnsw(self, docs, n_sets: int = SH_HNSW_SETS, n_queries: int = N_QUERIES,
                           parity_sets: int = SH_HNSW_PARITY_SETS, n_parity: int = 64):
        """ShardedHNSW(minhash_jaccard, m 16, ef 64) over 4 positions by
        ``index_tokens`` of hnsw-1m's first ``n_sets`` sets (4 shards, each
        graph's kNN rows on kernel 2), 1,024 corpus members as queries."""
        from datasketch_tpu_torch.parallel import ShardedHNSW

        ix = ShardedHNSW(self.mesh(), distance_metric="minhash_jaccard", m=HNSW_M, ef=HNSW_EF)
        self.sync()
        t0 = time.perf_counter()
        ix.index_tokens(range(n_sets), docs[:n_sets], num_perm=NUM_PERM)
        self.sync()
        out = {"build_s": time.perf_counter() - t0, "local_n": ix.status()["local_n"]}
        q_rows = np.random.RandomState(47).choice(n_sets, n_queries, replace=False)
        q = ix._points_host[q_rows]
        out["qps"], rows = self.timed_qps(lambda: ix.query_batch(q, TOP_K), n_queries)
        out["self_hit"] = float(np.mean([any(d == 0.0 for _, d in row) for row in rows]))
        check(out["self_hit"] >= HNSW_RECALL_FLOOR,
              "sharded hnsw: queries find a distance-0 row at %.4f" % out["self_hit"])

        def parity():
            pair = [ShardedHNSW(self.mesh(device=d), distance_metric="minhash_jaccard",
                                m=HNSW_M, ef=HNSW_EF) for d in (self.device, "cpu")]
            for p in pair:
                p.index_tokens(range(parity_sets), docs[:parity_sets], num_perm=NUM_PERM)
            pq = pair[1]._points_host[:n_parity]
            check(pair[0].query_batch(pq, TOP_K) == pair[1].query_batch(pq, TOP_K),
                  "sharded hnsw: the card and the CPU answer otherwise")
            return "%d sets x %d queries equal a device='cpu' index" % (parity_sets, n_parity)

        self.sharded_idx["hnsw"] = out
        return parity

    def phase_sharded_2proc(self, sigs: np.ndarray, n_rows: int = HOST_LSH_ROWS,
                            n_queries: int = N_QUERIES, nccl: bool = True,
                            timeout: float = 300.0) -> None:
        """sharded-2proc: two child processes in a gloo group, each owning 2
        of a 4-position mesh on this run's device, over host-lsh-262k's rows
        (:func:`sharded_worker`); then, on a card, one child in a one-rank
        NCCL group. A child that fails, hangs or exits non-zero fails the
        phase."""
        import socket

        def free_port():
            with socket.socket() as s:
                s.bind(("localhost", 0))
                return s.getsockname()[1]

        def run(args_list, expect):
            t0 = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       "--sharded-worker"] + [str(a) for a in args],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for args in args_list]
            outs = []
            try:
                for p in procs:
                    outs.append(p.communicate(timeout=timeout)[0])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for p, out in zip(procs, outs):
                for line in out.strip().splitlines():
                    log("  child: " + line)
                check(p.returncode == 0, "sharded-2proc: a child exited %s" % p.returncode)
                for line in expect:
                    check(line in out, "sharded-2proc: a child did not report %r" % line)
            return time.perf_counter() - t0

        self.sharded_2proc = {}
        with tempfile.TemporaryDirectory() as tmp:
            np.save(os.path.join(tmp, "rows.npy"), sigs[:n_rows])
            port = free_port()
            self.sharded_2proc["gloo_s"] = run(
                [("gloo", port, rank, 2, tmp, self.device, n_queries) for rank in (0, 1)],
                ("collectives OK", "global-mesh index OK", "handoff OK"))
            if nccl:
                self.sharded_2proc["nccl_s"] = run(
                    [("nccl", free_port(), 0, 1, tmp, self.device, n_queries)], ("nccl OK",))
        log("[sharded-2proc] 2 gloo ranks x 2 positions on %s over %d rows: collectives, a "
            "ShardedMinHashLSH equal to the 4-position mesh in one process, save -> barrier -> "
            "load onto 3 positions (%.1f s); one-rank NCCL group: %s" % (
                self.device, n_rows, self.sharded_2proc["gloo_s"],
                "%.1f s" % self.sharded_2proc["nccl_s"] if nccl else "not run off the card"))

    def timed_qps(self, fn, n_queries: int, reps: int = 3):
        """(best q/s over ``reps`` synced calls after a warm one, the last
        answer)."""
        fn()
        best, out = 0.0, None
        for _ in range(reps):
            self.sync()
            t0 = time.perf_counter()
            out = fn()
            self.sync()
            best = max(best, n_queries / (time.perf_counter() - t0))
        return best, out


class _Sketch:
    """The two attributes ``bBitMinHash`` reads of a MinHash."""

    def __init__(self, hashvalues, seed: int = 1):
        self.hashvalues = np.asarray(hashvalues, dtype=np.uint64)
        self.seed = seed


def make_weighted_rows(torch, n_rows: int, dim: int, device, seed: int,
                       density: float = 0.02, chunk: int = 8192):
    """``bench.py::bench_cws``'s rows drawn on ``device``: each (row, dim)
    active with probability ``density`` (a Binomial(dim, density) count of
    dims without replacement), plus dim ``i % dim`` of row i; |N(0, 1)|
    weights, 1.0 at dim ``i % dim``. Returns CSR (vals f32, idx int32,
    indptr int64) with ascending dims per row."""
    g = torch.Generator(device=device).manual_seed(seed)
    vals, idx, counts = [], [], []
    for r0 in range(0, n_rows, chunk):
        r1 = min(n_rows, r0 + chunk)
        mask = torch.rand((r1 - r0, dim), generator=g, device=device) < density
        rows = torch.arange(r0, r1, device=device)
        mask[rows - r0, rows % dim] = True
        nz = mask.nonzero()
        v = torch.randn(nz.shape[0], generator=g, device=device).abs()
        vals.append(torch.where(nz[:, 1] == (nz[:, 0] + r0) % dim, 1.0, v))
        idx.append(nz[:, 1].to(torch.int32))
        counts.append(mask.sum(dim=1))
        del mask, nz
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.cat(counts), 0)
    return torch.cat(vals), torch.cat(idx), indptr


def densify(torch, vals, idx, indptr, dim: int):
    """Dense f32[rows, dim] of CSR rows (dims unique within a row)."""
    n = indptr.shape[0] - 1
    w = torch.zeros((n, dim), dtype=torch.float32, device=vals.device)
    rows = torch.repeat_interleave(torch.arange(n, device=vals.device),
                                   indptr[1:] - indptr[:-1])
    w[rows, idx.long()] = vals
    return w


def to_csr(torch, w):
    """CSR (vals, idx int32, indptr int64) of a dense matrix's non-zero
    entries, negative ones included."""
    nz = (w != 0).nonzero()
    indptr = torch.zeros(w.shape[0] + 1, dtype=torch.int64, device=w.device)
    indptr[1:] = torch.cumsum((w != 0).sum(dim=1), 0)
    return w[nz[:, 0], nz[:, 1]].contiguous(), nz[:, 1].to(torch.int32), indptr


def rerank_edge_case(torch, n: int, nq: int, c: int, device, seed: int):
    """int32[nq, c] candidate ids over an ``n``-row table: row 0 all -1;
    row 1 one id in every slot; row 2 live ids at even slots, -1 at odd
    ones; row 3 three ids repeated in turn; the rest random ids with a
    random fifth of the columns -1, so a chunk of 32 slots holds no, some
    or only -1 slots."""
    rng = np.random.RandomState(seed)
    cand = rng.randint(-1, n, size=(nq, c)).astype(np.int32)
    cand[0] = -1
    cand[1] = rng.randint(0, n)
    cand[2, 1::2] = -1
    cand[3] = np.resize(rng.randint(0, n, size=3), c)
    cand[4:, rng.rand(c) < 0.2] = -1
    return torch.from_numpy(cand).to(device)


def cws_edge_case(torch, d: int, s: int, device, n_rows: int = 257):
    """Tables (transposed [d, s], drawn as the generator draws them) whose
    dims 1, 2 copy dim 0 and dim d-2 copies d-3, and rows: 0 empty, 1 one
    active dim, 2 only dims 0-2 at one weight (a forced tie), 3 only tiny
    weights (negative t), 4 only huge ones, 5 negative entries only, 6 dims
    d-3 and d-2 tied among others, and the rest ~2 % dense with weights
    log-uniform over 1e-30 .. 1e30."""
    rng = np.random.RandomState(d + s)
    rs = rng.gamma(2, 1, (d, s)).astype(np.float32)
    ln_cs = np.log(rng.gamma(2, 1, (d, s))).astype(np.float32)
    betas = rng.uniform(0, 1, (d, s)).astype(np.float32)
    for t in (rs, ln_cs, betas):
        t[1:3] = t[0]
        t[d - 2] = t[d - 3]
    w = np.where(rng.rand(n_rows, d) < 0.02, 10.0 ** rng.uniform(-30, 30, (n_rows, d)), 0.0)
    w = w.astype(np.float32)
    w[:7] = 0.0
    w[1, d // 2] = 0.3
    w[2, :3] = 0.75
    w[3, :: max(1, d // 40)] = 1e-30
    w[4, :: max(1, d // 40)] = 1e30
    w[5, ::7] = -2.0
    w[6, ::11] = 1.5
    w[6, d - 3: d - 1] = 1.5
    tabs = [torch.from_numpy(t).to(device) for t in (rs, ln_cs, betas)]
    return tabs, torch.from_numpy(w).to(device)


def cws_dense_case(torch, d: int, s: int, device, n_rows: int = 64):
    """Tables (transposed [d, s], drawn as the generator draws them) and
    dense rows f32[n_rows, d] for kernel 6's layout: row 0 empty; 1 only
    the last dim active; 2 fully dense, weights log-uniform over 1e-30 ..
    1e30; 3 fully dense at 1e-30 but for dims a = 100 and b = d - 2 at
    1e30, b's parameters a copy of a's (a tie across 1,024-dim chunks and
    list flushes: a wins); 4 only dims 64 and 192, 192's parameters a copy
    of 64's, at one weight (a tie across warps' segments: 64 wins); 5 only
    tiny weights (negative t); 6 only huge ones; 7 negative entries only;
    the rest ~2 % dense, weights log-uniform over 1e-30 .. 1e30. Also
    returns the forced ties as (row, winning dim) pairs (none where d is
    too small for them)."""
    rng = np.random.RandomState(d * 3 + s)
    rs = rng.gamma(2, 1, (d, s)).astype(np.float32)
    ln_cs = np.log(rng.gamma(2, 1, (d, s))).astype(np.float32)
    betas = rng.uniform(0, 1, (d, s)).astype(np.float32)
    w = np.where(rng.rand(n_rows, d) < 0.02, 10.0 ** rng.uniform(-30, 30, (n_rows, d)), 0.0)
    w = w.astype(np.float32)
    w[:8] = 0.0
    w[1, d - 1] = 0.5
    w[2] = 10.0 ** rng.uniform(-30, 30, d)
    w[5, :: max(1, d // 40)] = 1e-30
    w[6, :: max(1, d // 40)] = 1e30
    w[7, ::3] = -1.0
    ties = []
    for row, (a, b) in ((3, (100, d - 2)), (4, (64, 192))):
        if not a < b < d:
            continue
        for t in (rs, ln_cs, betas):
            t[b] = t[a]
        ties.append((row, a))
    w[3] = 1e-30
    if d > 102:
        w[3, [100, d - 2]] = 1e30
    if d > 192:
        w[4, [64, 192]] = 0.75
    tabs = [torch.from_numpy(t).to(device) for t in (rs, ln_cs, betas)]
    return tabs, torch.from_numpy(w).to(device), ties


def cws_order_case(torch, d: int, s: int, device, n_rows: int):
    """Tables (transposed [d, s], drawn as the generator draws them) and CSR
    rows (vals f32, idx int32, indptr int64) whose entry order matters,
    with a = 64 and b = 192 (d > 192), b's parameters a copy of a's: row 0
    empty; 1 every third dim; 2 dims a, b at one weight (a tie: a, the
    first entry, wins); 3 falling dims; 4 ascending dims with zero and
    negative entries between them and a (0, 0) pad at the end; 5 dims b, a
    at one weight (falling and tied: b, the first, wins); 6 only tiny
    weights (negative t); the rest ~2 % dense with |N(0, 1)| weights. Also
    returns the forced ties as (row, winning dim) pairs."""
    rng = np.random.RandomState(d * 7 + s)
    rs = rng.gamma(2, 1, (d, s)).astype(np.float32)
    ln_cs = np.log(rng.gamma(2, 1, (d, s))).astype(np.float32)
    betas = rng.uniform(0, 1, (d, s)).astype(np.float32)
    a, b = 64, 192
    for t in (rs, ln_cs, betas):
        t[b] = t[a]
    third = list(range(0, d, 3))
    rows = [
        ([], []),
        (third, list(np.abs(rng.randn(len(third))) + 0.1)),
        ([a, b], [0.75, 0.75]),
        ([d - 1, b, a, 128, 3, 0], list(np.abs(rng.randn(6)) + 0.1)),
        ([1, 5, 128, 256, d - 2, 0], [1.0, 0.0, -1.0, 2.0, 0.5, 0.0]),
        ([b, a], [0.75, 0.75]),
        (list(range(2, d, 17)), [1e-30] * len(range(2, d, 17))),
    ]
    for _ in range(len(rows), n_rows):
        dims = np.nonzero(rng.rand(d) < 0.02)[0]
        rows.append((list(dims), list(np.abs(rng.randn(dims.size)))))
    indptr = np.concatenate([[0], np.cumsum([len(r[0]) for r in rows])]).astype(np.int64)
    idx = np.concatenate([np.asarray(r[0], dtype=np.int32) for r in rows])
    vals = np.concatenate([np.asarray(r[1], dtype=np.float32) for r in rows])
    tabs = [torch.from_numpy(t).to(device) for t in (rs, ln_cs, betas)]
    csr = tuple(torch.from_numpy(x).to(device) for x in (vals, idx, indptr))
    return tabs, csr, [(2, a), (5, b)]


def cws_block_case(torch, d: int, s: int, device, n_rows: int):
    """Tables (transposed [d, s], drawn as the generator draws them) and CSR
    rows for kernel 7's edges: ~2 % dense rows with |N(0, 1)|
    weights, their entries in a shuffled order, and in the first and the
    last rows (in the first only, for batches under 12 rows): a fully dense
    row, shuffled; dims 5, 40 at one weight, 40's parameters a copy of 5's
    (a tie within a 64-dim chunk: 5, the first entry, wins); dims 200, 70
    at one weight, 200's a copy of 70's (a tie across chunks: 200 wins);
    dims 20, 21 at weight 1.0 with r 1, beta 0.5 and ln c 0.5, so that
    ln_a = +0.0 for both (20 wins); one dim at the end; an empty row. Also
    returns the forced ties as (row, winning dim) pairs."""
    rng = np.random.RandomState(d * 11 + s + n_rows)
    rs = rng.gamma(2, 1, (d, s)).astype(np.float32)
    ln_cs = np.log(rng.gamma(2, 1, (d, s))).astype(np.float32)
    betas = rng.uniform(0, 1, (d, s)).astype(np.float32)
    dense = rng.permutation(d)
    specials, wins = [(list(dense), list(np.abs(rng.randn(d)) + 0.1))], {}
    for a, b, w in ((5, 40, 0.75), (70, 200, 1.25)):
        if b < d:
            for t in (rs, ln_cs, betas):
                t[b] = t[a]
            first = a if a == 5 else b
            wins[len(specials)] = first
            specials.append(([first, a + b - first], [w, w]))
    if d > 21:
        rs[20:22], betas[20:22], ln_cs[20:22] = 1.0, 0.5, 0.5
        wins[len(specials)] = 20
        specials.append(([20, 21], [1.0, 1.0]))
    specials += [([d - 1], [0.5]), ([], [])]
    n_sp = len(specials)
    head = list(range(min(n_sp, n_rows)))
    tail = list(range(n_sp)) if n_rows >= 2 * n_sp else []
    layout = head + [None] * (n_rows - len(head) - len(tail)) + tail
    rows = []
    for k in layout:
        if k is not None:
            rows.append(specials[k])
            continue
        dims = rng.permutation(np.nonzero(rng.rand(d) < 0.02)[0])
        rows.append((list(dims), list(np.abs(rng.randn(dims.size)))))
    ties = [(i, wins[k]) for i, k in enumerate(layout) if k in wins]
    indptr = np.concatenate([[0], np.cumsum([len(r[0]) for r in rows])]).astype(np.int64)
    idx = np.concatenate([np.asarray(r[0], dtype=np.int32) for r in rows])
    vals = np.concatenate([np.asarray(r[1], dtype=np.float32) for r in rows])
    tabs = [torch.from_numpy(t).to(device) for t in (rs, ln_cs, betas)]
    csr = tuple(torch.from_numpy(x).to(device) for x in (vals, idx, indptr))
    return tabs, csr, ties


def cws_odd_case(torch, device, d: int = 333, s: int = 8):
    """Tables with r = 0 at dim 7 (ln_a NaN) and ln c = +inf at dim 9
    (ln_a = +inf), and 40 CSR rows ~3 %
    dense that also hold dims 7 and 9, then three rows: only dims 7 and 9
    (nothing chosen: (0, 0)); dims 3 and 4 at weight +inf (ln_a = -inf for
    both: 3 wins, and its t of +inf converts to INT32_MAX); dims 7, 9, 11
    (11 wins). Returns tables, the CSR and the CSR with dims 7 and 9
    inactive (the plain version's argmin would take a NaN)."""
    rng = np.random.RandomState(5)
    rs = rng.gamma(2, 1, (d, s)).astype(np.float32)
    ln_cs = np.log(rng.gamma(2, 1, (d, s))).astype(np.float32)
    betas = rng.uniform(0, 1, (d, s)).astype(np.float32)
    rs[7] = 0.0
    ln_cs[9] = np.inf
    rows = []
    for _ in range(40):
        dims = sorted(set(np.nonzero(rng.rand(d) < 0.03)[0].tolist()) | {7, 9})
        rows.append((dims, list(np.abs(rng.randn(len(dims))) + 0.05)))
    rows += [([7, 9], [1.5, 0.5]), ([3, 4], [np.inf, np.inf]), ([7, 9, 11], [1.0, 1.0, 2.0])]
    indptr = np.concatenate([[0], np.cumsum([len(r[0]) for r in rows])]).astype(np.int64)
    idx = np.concatenate([np.asarray(r[0], dtype=np.int32) for r in rows])
    vals = np.concatenate([np.asarray(r[1], dtype=np.float32) for r in rows])
    masked = np.where(np.isin(idx, [7, 9]), 0.0, vals).astype(np.float32)
    tabs = [torch.from_numpy(t).to(device) for t in (rs, ln_cs, betas)]
    csr = tuple(torch.from_numpy(x).to(device) for x in (vals, idx, indptr))
    return tabs, csr, (torch.from_numpy(masked).to(device),) + csr[1:]


def unaligned_copy(torch, t):
    """``t``'s values in a tensor 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def floor_near_tie(row, k: int, smp: int, gen) -> bool:
    """Whether ``log(w_k) / r + beta`` of sample ``smp`` lies within 4 ulp
    of an integer (there one ulp of ``log`` may move ``t``)."""
    hit = np.nonzero(row.indices == k)[0]
    if not hit.size:
        return False
    w = np.float32(row.data[hit[0]])
    x = np.float32(np.float32(np.log(w)) / gen.rs[smp, k] + gen.betas[smp, k])
    return bool(abs(x - np.round(x)) <= 4 * np.spacing(np.float32(max(abs(x), 1.0))))


def make_token_sets(torch, n_sets: int, device, seed: int, vocab: int = 50000,
                    mean_size: int = 120):
    """Integer-token documents drawn on ``device``: lognormal lengths
    around ``mean_size`` (at least 8), Zipf(0.8) ids over ``vocab``
    (``benchmarks/utils.py::generate_sets``' shape, without its clusters);
    returned as host int32 arrays, one per document. Ids repeat within a
    document, so a set's size is its distinct count."""
    g = torch.Generator(device=device).manual_seed(seed)
    lengths = torch.empty(n_sets, device=device, dtype=torch.float64)
    lengths = lengths.log_normal_(math.log(mean_size), 0.5, generator=g).long().clamp_min(8)
    w = torch.arange(1, vocab + 1, device=device, dtype=torch.float64) ** -0.8
    cum = torch.cumsum(w / w.sum(), 0)
    u = torch.rand(int(lengths.sum()), generator=g, device=device, dtype=torch.float64)
    ids = torch.searchsorted(cum, u).clamp_max(vocab - 1).to(torch.int32).cpu().numpy()
    return np.split(ids, np.cumsum(lengths.cpu().numpy())[:-1])


def clustered_sets(torch, n_sets: int, device, seed: int, vocab: int = 50000,
                   mean_size: int = 190, cluster: int = 20):
    """``benchmarks/utils.py::generate_sets``' law, vectorized and drawn on
    ``device``: clusters of ``cluster`` sets, each a base set (lognormal
    size around ``mean_size``, at least 8 draws, its distinct Zipf(0.8) ids
    over ``vocab``) and members that keep a U(0.45, 0.98) share of the base
    and add max(1, int(base size x U(0.02, 0.35))) fresh Zipf ids, in a
    random order. Host int32 arrays, one per set; a member's ids may repeat
    (MinHash reads the set)."""
    g = torch.Generator(device=device).manual_seed(seed)
    f64 = torch.float64
    w = torch.arange(1, vocab + 1, device=device, dtype=f64) ** -0.8
    cum = torch.cumsum(w / w.sum(), 0)

    def zipf(k):
        u = torch.rand(k, generator=g, device=device, dtype=f64)
        return torch.searchsorted(cum, u).clamp_max(vocab - 1)

    def uniform(k, lo, hi):
        return lo + (hi - lo) * torch.rand(k, generator=g, device=device, dtype=f64)

    n_cl = -(-n_sets // cluster)
    draws = torch.empty(n_cl, device=device, dtype=f64).log_normal_(
        math.log(mean_size), 0.5, generator=g).long().clamp_min(8)
    seg = torch.repeat_interleave(torch.arange(n_cl, device=device), draws)
    key = torch.unique(seg * vocab + zipf(int(draws.sum())))  # distinct ids per cluster
    base = key % vocab
    bsize = torch.bincount(key // vocab, minlength=n_cl)
    bstart = torch.cumsum(bsize, 0) - bsize
    sets = torch.arange(n_sets, device=device)
    cl = sets // cluster
    is_base = sets % cluster == 0
    n_base = bsize[cl]
    owner = torch.repeat_interleave(sets, n_base)
    pos = torch.arange(owner.shape[0], device=device) - (torch.cumsum(n_base, 0) - n_base)[owner]
    tok = base[bstart[cl][owner] + pos]
    keep_rate = torch.where(is_base, 1.0, uniform(n_sets, 0.45, 0.98))
    kept = torch.rand(owner.shape[0], generator=g, device=device, dtype=f64) < keep_rate[owner]
    n_extra = torch.where(is_base, 0, (n_base * uniform(n_sets, 0.02, 0.35)).long().clamp_min(1))
    all_owner = torch.cat([owner[kept], torch.repeat_interleave(sets, n_extra)])
    all_tok = torch.cat([tok[kept], zipf(int(n_extra.sum()))])
    order = torch.argsort(all_owner, stable=True)
    ids = all_tok[order].to(torch.int32).cpu().numpy()
    docs = np.split(ids, np.cumsum(torch.bincount(all_owner, minlength=n_sets).cpu().numpy())[:-1])
    perm = torch.randperm(n_sets, generator=g, device=device).cpu().numpy()
    return [docs[i] for i in perm]


def make_corpus(n_docs: int, seed: int = 42):
    """The bench corpus: 10-byte tokens from a 30,000-word vocabulary,
    TOKENS_PER_DOC per doc (``bench.py::make_corpus``)."""
    rng = np.random.RandomState(seed)
    vocab = [bytes(rng.randint(0, 256, size=10, dtype=np.uint8)) for _ in range(30000)]
    return [
        [vocab[j] for j in rng.randint(0, len(vocab), size=TOKENS_PER_DOC)]
        for _ in range(n_docs)
    ]


def synth_index(n: int, head: np.ndarray, dup_rate: float = 0.2, seed: int = 9):
    """Index rows: random signatures whose first rows are ``head`` (real
    signatures), ``N_NEAR`` near-copies of head row 0 (90% of slots kept,
    own generator), then a ``dup_rate`` share of planted near-duplicates
    of earlier rows (``benchmarks/scale_benchmark.py::synth_signatures``).
    Returns (sigs, src, dst, near_rows)."""
    rng = np.random.RandomState(seed)
    sigs = rng.randint(0, 1 << 32, size=(n, head.shape[1]), dtype=np.uint64).astype(
        np.uint32
    )
    sigs[: head.shape[0]] = head
    near_rng = np.random.RandomState(11)
    near = np.arange(head.shape[0], head.shape[0] + N_NEAR)
    keep = near_rng.rand(N_NEAR, head.shape[1]) < 0.9
    sigs[near] = np.where(keep, head[0], sigs[near])
    n_dup = int(n * dup_rate)
    src = rng.randint(0, n - n_dup, size=n_dup)
    dst = np.arange(n - n_dup, n)
    keep = rng.rand(n_dup, head.shape[1]) < rng.uniform(0.6, 0.95, size=(n_dup, 1))
    sigs[dst] = np.where(keep, sigs[src], sigs[dst])
    return sigs, src, dst, np.concatenate([[0], near])


def count_f64(regs: np.ndarray, p: int) -> np.ndarray:
    """``hll_ops.count_batch``'s formula in float64 numpy."""
    m = 1 << p
    alpha = {4: 0.673, 5: 0.697, 6: 0.709}.get(p, 0.7213 / (1.0 + 1.079 / m))
    e = alpha * float(m) ** 2 / np.exp2(-regs.astype(np.float64)).sum(axis=1)
    num_zero = (regs == 0).sum(axis=1)
    lc = m * np.log(m / np.maximum(num_zero, 1))
    out = np.where((e <= 2.5 * m) & (num_zero > 0), lc, e)
    return np.where(out > 2.0 ** 32 / 30.0, -(2.0 ** 32) * np.log1p(-out / 2.0 ** 32), out)


def int_rate(torch, device) -> float:
    """Integer ALU operations per second of ``device``: 64 lanes per SM per
    clock, times its SMs, times the maximum SM clock that ``nvidia-smi``
    reports (off the card: the H100 SXM's)."""
    if device.type != "cuda":
        return INT_LANES_PER_SM * H100_SMS * H100_MAX_SM_MHZ * 1e6
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, "nvidia-smi failed: %s" % out.stderr.strip())
    mhz = float(out.stdout.split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return INT_LANES_PER_SM * sms * mhz * 1e6


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, "nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def sharded_worker(backend: str, port: str, rank: str, world: str, tmp: str,
                   device: str, n_queries: str = str(N_QUERIES)) -> int:
    """A child of sharded-2proc (``chip_smoke.py --sharded-worker ...``): joins
    a ``backend`` group of ``world`` ranks on localhost, reads the rows the
    parent wrote to ``tmp``, and runs, with gloo, the collectives, a
    ``ShardedMinHashLSH`` over a 4-position mesh (2 positions a rank on
    ``device``) equal to the same index on 4 positions in this process, and
    the save -> barrier -> load handoff onto a local 3-position mesh; with
    NCCL (one rank), ``distributed_minhash_union`` and one ``top_k`` equal to
    the local mesh's. Prints one line per step; any failure raises."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from datasketch_tpu_torch.parallel import (
        ShardedMinHashLSH,
        collectives,
        distributed_minhash_union,
        init_distributed,
        make_mesh,
    )
    from datasketch_tpu_torch.parallel.mesh import Mesh

    rank, world, n_queries = int(rank), int(world), int(n_queries)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0 if dev.index is None else dev.index)
    init_distributed("localhost:%s" % port, num_processes=world, process_id=rank,
                     backend=backend)
    try:
        rows = np.load(os.path.join(tmp, "rows.npy"))
        q = rows[:: max(1, rows.shape[0] // n_queries)][:n_queries]
        n_pos = 4 if backend == "gloo" else 2
        mesh = make_mesh(n_pos, axis_names=("data",), device=device)
        local = Mesh([mesh.home] * n_pos, ("data",))
        check(dist.get_backend() == backend and mesh.is_multiprocess,
              "rank %d: backend %s" % (rank, dist.get_backend()))
        head = torch.from_numpy(rows[:4096].view(np.int32)).to(mesh.home)
        check(torch.equal(distributed_minhash_union(head, mesh),
                          distributed_minhash_union(head, local)),
              "rank %d: the MinHash union differs from the local mesh's" % rank)
        ix, ref = (ShardedMinHashLSH(m, threshold=0.5, num_perm=NUM_PERM, bucket_cap=128)
                   for m in (mesh, local))
        for x in (ix, ref):
            x.index(range(rows.shape[0]), rows)
        if backend == "nccl":
            check(ix.top_k(q, TOP_K, method="scan") == ref.top_k(q, TOP_K, method="scan"),
                  "nccl: top_k differs from the local mesh's")
            print("[%d] nccl OK" % rank, flush=True)
            return 0
        mine = {s: torch.full((2,), s + 1, dtype=torch.int32, device=mesh.home)
                for s in mesh.local_shards("data")}
        check(mesh.local_shards("data") == [2 * rank, 2 * rank + 1],
              "rank %d owns shards %s" % (rank, mesh.local_shards("data")))
        check(collectives.all_gather_cat(mesh, "data", mine, dim=0).tolist()
              == [1, 1, 2, 2, 3, 3, 4, 4], "rank %d: all_gather_cat" % rank)
        check(int(collectives.psum(mesh, {s: s + 1 for s in mine})) == 10,
              "rank %d: psum" % rank)
        print("[%d] collectives OK" % rank, flush=True)
        for method in ("scan", "bands"):
            check(ix.top_k(q, TOP_K, method=method) == ref.top_k(q, TOP_K, method=method)
                  and ix.last_truncated == ref.last_truncated,
                  "rank %d: top_k %s differs from the local mesh's" % (rank, method))
            check(ix.query_batch(q, method=method) == ref.query_batch(q, method=method),
                  "rank %d: query_batch %s differs from the local mesh's" % (rank, method))
        print("[%d] global-mesh index OK" % rank, flush=True)
        ix.save(os.path.join(tmp, "handoff_%d" % rank))  # a collective: every rank saves
        dist.barrier()
        if rank == 1:
            loaded = ShardedMinHashLSH.load(os.path.join(tmp, "handoff_0.npz"),
                                            Mesh([mesh.home] * 3, ("data",)))
            check(loaded.top_k(q, TOP_K, method="scan") == ref.top_k(q, TOP_K, method="scan"),
                  "rank 1: the loaded index answers otherwise")
        dist.barrier()
        print("[%d] handoff OK" % rank, flush=True)
        return 0
    finally:
        dist.destroy_process_group()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import datasketch_tpu_torch  # noqa: F401
        from datasketch_tpu_torch.kernels import build
    except ImportError as exc:
        print("chip_smoke: run from a checkout of the repository (%s)" % exc,
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        name = torch.cuda.get_device_name(0)
        cap = torch.cuda.get_device_capability(0)
        log("[env] python %s, torch %s, CUDA %s, %s, capability %d.%d, %d device(s)"
            % (sys.version.split()[0], torch.__version__, torch.version.cuda, name,
               cap[0], cap[1], torch.cuda.device_count()))
        log(nvidia_smi_line())
        check(cap >= (9, 0), "capability %d.%d < 9.0: the kernels target sm_90a" % cap)
        smoke = Smoke(torch, "cuda")
        smoke.phase_build()
        log("[kernels] each kernel against its plain version on the card")
        smoke.phase_kernels()
        smoke.phase_kernels_cws()
        smoke.phase_kernels_bbit()
        torch.cuda.empty_cache()
        kmods = {k["name"]: smoke.kmod(k["name"]) for k in KERNELS}

        def counts():
            return {k["name"]: getattr(kmods[k["name"]], k.get("counter", "launches"))
                    for k in KERNELS}

        def zero_counts():
            for k in KERNELS:
                setattr(kmods[k["name"]], k.get("counter", "launches"), 0)

        zero_counts()
        real = smoke.phase_signatures()
        index, sigs, src, dst, near = smoke.phase_index(real)
        smoke.phase_serving(index, sigs, src, dst, near)
        torch.cuda.synchronize()
        lsh_counts = counts()
        zero_counts()
        smoke.phase_failover(index, sigs, dst, counts=counts)
        fo_counts = smoke.fo_counts
        log("[failover-1m] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.failover)))
        log("[launches] failover-1m path (the device calls alone): %s"
            % json.dumps(fo_counts))
        zero_counts()
        hl_path = smoke.phase_host_lsh(index, sigs, near)
        torch.cuda.synchronize()
        hl_counts = counts()
        smoke.phase_host_lsh_checks(index, hl_path)
        del hl_path
        log("[host-lsh-262k] %s" % nvidia_smi_line())
        log("[launches] host-lsh-262k path: %s" % json.dumps(hl_counts))
        for kname in HOST_LSH_PATH:
            check(hl_counts[kname] > 0, "kernel %s was not launched on the host-lsh-262k "
                  "path" % kname)
        t_sharded = time.perf_counter()
        zero_counts()
        shl = smoke.phase_sharded_lsh(index, sigs, dst)
        torch.cuda.synchronize()
        shl_counts = counts()
        smoke.phase_sharded_lsh_checks(index, sigs, *shl)
        del shl, index
        torch.cuda.empty_cache()
        log("[sharded-lsh-1m] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.sharded_lsh)))
        log("[launches] sharded-lsh-1m path: %s" % json.dumps(shl_counts))
        zero_counts()
        sketch = smoke.phase_sharded_sketch()
        torch.cuda.synchronize()
        shs_counts = counts()
        smoke.phase_sharded_sketch_checks(*sketch)
        del sketch
        log("[sharded-sketch] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.sharded_sketch)))
        log("[launches] sharded-sketch path: %s" % json.dumps(shs_counts))
        sh_idx = {}
        for label, phase in (("bbit", lambda: smoke.phase_sharded_bbit(sigs, src, dst)),
                             ("forest", lambda: smoke.phase_sharded_forest(sigs, src, dst)),
                             ("bloom", lambda: smoke.phase_sharded_bloom(sigs))):
            zero_counts()
            parity = phase()
            torch.cuda.synchronize()
            sh_idx[label] = counts()
            log("[sharded-%s] %s; %s" % (label, parity(), nvidia_smi_line()))
            log("[launches] sharded-%s path: %s" % (label, json.dumps(sh_idx[label])))
            torch.cuda.empty_cache()
        smoke.phase_sharded_2proc(sigs)
        for label, got, path in (("sharded-lsh-1m", shl_counts, SHARDED_LSH_PATH),
                                 ("sharded-sketch", shs_counts, SHARDED_SKETCH_PATH),
                                 ("sharded-bbit", sh_idx["bbit"], SHARDED_BBIT_PATH),
                                 ("sharded-forest", sh_idx["forest"], SHARDED_FOREST_PATH)):
            for kname in path:
                check(got[kname] > 0, "kernel %s was not launched on the %s path"
                      % (kname, label))
        t_sharded = time.perf_counter() - t_sharded
        smoke.phase_facade_parity(sigs)
        log("[launches] LSH main path (phases 4-6): %s" % json.dumps(lsh_counts))
        for kname in LSH_PATH:
            check(lsh_counts[kname] > 0, "kernel %s was not launched on the LSH path" % kname)
        zero_counts()
        for b in (1, 4):
            smoke.phase_bbit(sigs, src, dst, b)
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        bbit_counts = counts()
        log("[bbit-1m] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.bbit)))
        log("[launches] bbit-1m path: %s" % json.dumps(bbit_counts))
        for kname in BBIT_PATH:
            check(bbit_counts[kname] > 0, "kernel %s was not launched on the bbit-1m path"
                  % kname)
        zero_counts()
        forest, fq = smoke.phase_forest(sigs, src, dst)
        torch.cuda.synchronize()
        forest_counts = counts()
        smoke.phase_forest_checks(forest, fq, sigs)
        del forest
        torch.cuda.empty_cache()
        log("[forest-1m] %s: build %.3f s; q/s, recall, truncated %s"
            % (nvidia_smi_line(), smoke.forest_build_s, json.dumps(smoke.forest_qps)))
        log("[launches] forest-1m path: %s" % json.dumps(forest_counts))
        for kname in FOREST_PATH:
            check(forest_counts[kname] > 0, "kernel %s was not launched on the forest-1m path"
                  % kname)

        docs, queries, qsrc = smoke.phase_ensemble_corpus()
        zero_counts()
        ens = smoke.phase_ensemble(docs, queries, qsrc)
        smoke.phase_ensemble_stream(*ens[:3])
        torch.cuda.synchronize()
        ens_counts = counts()
        t0 = time.perf_counter()
        zero_counts()
        ens_parity = smoke.phase_sharded_ensemble(docs, queries, qsrc)
        torch.cuda.synchronize()
        sh_idx["ensemble"] = counts()
        t_sharded += time.perf_counter() - t0
        del docs, queries
        smoke.phase_ensemble_checks(*ens)
        del ens
        torch.cuda.empty_cache()
        smoke.phase_ensemble_parity()
        t0 = time.perf_counter()
        log("[sharded-ensemble] %s; %s" % (ens_parity(), nvidia_smi_line()))
        log("[launches] sharded-ensemble path: %s" % json.dumps(sh_idx["ensemble"]))
        for kname in SHARDED_ENSEMBLE_PATH:
            check(sh_idx["ensemble"][kname] > 0,
                  "kernel %s was not launched on the sharded-ensemble path" % kname)
        t_sharded += time.perf_counter() - t0
        log("[ensemble] %s: build %.3f s, q/s scan %.1f, bands %.1f, auto %.1f; peak "
            "device memory %d B" % (nvidia_smi_line(), smoke.ens_build_s,
                                    smoke.ens_qps["scan"], smoke.ens_qps["bands"],
                                    smoke.ens_qps["auto"], smoke.ens_peak))
        log("[launches] ensemble main path: %s" % json.dumps(ens_counts))
        for kname in ENSEMBLE_PATH:
            check(ens_counts[kname] > 0,
                  "kernel %s was not launched on the ensemble path" % kname)
        x, wq, wsrc = smoke.phase_weighted_corpus()
        zero_counts()
        gen, kt = smoke.phase_weighted(x, wq, wsrc)
        torch.cuda.synchronize()
        w_counts = counts()
        smoke.phase_weighted_checks(gen, x, kt)
        del x, kt
        log("[weighted] %s: CSR %.1f sketches/s, dense %.1f sketches/s, build %.3f s, "
            "q/s top_k scan %.1f, top_k bands %.1f, query_batch bands %.1f; peak device "
            "memory %d B" % (nvidia_smi_line(), smoke.w_rate, smoke.w_dense_rate,
                             smoke.w_build_s, smoke.w_qps["top_k scan"],
                             smoke.w_qps["top_k bands"], smoke.w_qps["query_batch 0.5 bands"],
                             smoke.w_peak))
        log("[launches] weighted main path: %s" % json.dumps(w_counts))
        for kname in WEIGHTED_PATH:
            check(w_counts[kname] > 0,
                  "kernel %s was not launched on the weighted path" % kname)
        del gen
        torch.cuda.empty_cache()
        zero_counts()
        smoke.phase_bbit_16m()
        torch.cuda.synchronize()
        b16_counts = counts()
        torch.cuda.empty_cache()
        log("[bbit-16m] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.bbit16)))
        log("[launches] bbit-16m path: %s" % json.dumps(b16_counts))
        zero_counts()
        smoke.phase_text()
        torch.cuda.synchronize()
        text_counts = counts()
        log("[text-16k] %s: texts/s %s, q/s and recall %s, builds %s s"
            % (nvidia_smi_line(), json.dumps(smoke.text_rate), json.dumps(smoke.text_qps),
               json.dumps(smoke.text_build)))
        log("[launches] text-16k path: %s" % json.dumps(text_counts))
        for kname in BBIT_PATH:
            check(b16_counts[kname] > 0, "kernel %s was not launched on the bbit-16m path"
                  % kname)
        for kname in TEXT_PATH + BBIT_PATH:
            check(text_counts[kname] > 0, "kernel %s was not launched on the text path"
                  % kname)
        f_sigs, f_q, f_src = smoke.forest_corpus()
        zero_counts()
        smoke.phase_forest_16k(f_sigs, f_q, f_src)
        torch.cuda.synchronize()
        f16_counts = counts()
        log("[forest-16k] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.forest16)))
        log("[launches] forest-16k path: %s" % json.dumps(f16_counts))
        zero_counts()
        smoke.phase_facade2(f_sigs, f_q)
        torch.cuda.synchronize()
        facade2_counts = counts()
        log("[facade-2] %s: q/s %s" % (nvidia_smi_line(), json.dumps(smoke.facade2)))
        log("[launches] facade-2 path: %s" % json.dumps(facade2_counts))
        del f_sigs, f_q
        zero_counts()
        smoke.phase_minhash_objects()
        torch.cuda.synchronize()
        mh_counts = counts()
        log("[minhash-objects] %s: %.1f docs/s" % (nvidia_smi_line(), smoke.mh_rate))
        log("[launches] minhash-objects path: %s" % json.dumps(mh_counts))
        for label, got, path in (("forest-16k", f16_counts, FOREST16_PATH),
                                 ("facade-2", facade2_counts, FACADE2_PATH),
                                 ("minhash-objects", mh_counts, MINHASH_PATH)):
            for kname in path:
                check(got[kname] > 0, "kernel %s was not launched on the %s path"
                      % (kname, label))
        torch.cuda.empty_cache()
        smoke.phase_hll()
        torch.cuda.empty_cache()
        log("[hll] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.hll)))
        zero_counts()
        smoke.phase_schemes()
        torch.cuda.synchronize()
        sch_counts = counts()
        torch.cuda.empty_cache()
        log("[schemes] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.schemes)))
        smoke.phase_bloom(sigs)
        del sigs
        torch.cuda.empty_cache()
        log("[bloom] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.bloom)))
        log("[launches] schemes path: %s" % json.dumps(sch_counts))
        for kname in SCHEMES_PATH:
            check(sch_counts[kname] > 0, "kernel %s was not launched on the schemes path"
                  % kname)
        t_hnsw = time.perf_counter()
        docs = smoke.hnsw_corpus()
        zero_counts()
        hnsw, hq, hrows = smoke.phase_hnsw(docs)
        torch.cuda.synchronize()
        hnsw_counts = counts()
        smoke.phase_hnsw_checks(hnsw, docs, hq, hrows)
        del hnsw
        torch.cuda.empty_cache()
        log("[hnsw-1m] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.hnsw)))
        log("[launches] hnsw-1m path: %s" % json.dumps(hnsw_counts))
        for kname in HNSW_PATH:
            check(hnsw_counts[kname] > 0, "kernel %s was not launched on the hnsw-1m path"
                  % kname)
        docs16 = smoke.hnsw_corpus(HNSW16_SETS)
        zero_counts()
        h16 = smoke.phase_hnsw_16k(docs16)
        torch.cuda.synchronize()
        h16_counts = counts()
        smoke.phase_hnsw_16k_checks(h16[0], docs16, *h16[1:])
        del h16
        log("[hnsw-16k] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.hnsw16)))
        log("[launches] hnsw-16k path: %s" % json.dumps(h16_counts))
        zero_counts()
        smoke.phase_hnsw_l2()
        torch.cuda.synchronize()
        l2_counts = counts()
        log("[hnsw-65k-l2] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.hnsw_l2)))
        log("[launches] hnsw-65k-l2 path (plain tiles, no kernel expected): %s"
            % json.dumps(l2_counts))
        from datasketch_tpu_torch import MinHash

        m48_sigs = MinHash.bulk_signatures(docs16[:HNSW_M48_ROWS], num_perm=NUM_PERM,
                                           hashfunc="device", out="device", device=smoke.device)
        zero_counts()
        smoke.phase_hnsw_m48(m48_sigs)
        torch.cuda.synchronize()
        m48_counts = counts()
        smoke.phase_hnsw_m48_check(m48_sigs)
        log("[hnsw-m48] %s: %s" % (nvidia_smi_line(), json.dumps(smoke.hnsw_m48)))
        log("[launches] hnsw m 48 path: %s" % json.dumps(m48_counts))
        for label, got, path in (("hnsw-16k", h16_counts, HNSW_PATH),
                                 ("hnsw m 48", m48_counts, HNSW_M48_PATH)):
            for kname in path:
                check(got[kname] > 0, "kernel %s was not launched on the %s path"
                      % (kname, label))
        log("[hnsw] the four HNSW phases: %.1f s" % (time.perf_counter() - t_hnsw))
        t0 = time.perf_counter()
        zero_counts()
        hnsw_parity = smoke.phase_sharded_hnsw(docs)
        torch.cuda.synchronize()
        sh_idx["hnsw"] = counts()
        log("[sharded-hnsw] %s; %s" % (hnsw_parity(), nvidia_smi_line()))
        log("[launches] sharded-hnsw path: %s" % json.dumps(sh_idx["hnsw"]))
        for kname in SHARDED_HNSW_PATH:
            check(sh_idx["hnsw"][kname] > 0,
                  "kernel %s was not launched on the sharded-hnsw path" % kname)
        del docs
        torch.cuda.empty_cache()
        t_sharded += time.perf_counter() - t0
        log("[sharded] %s: %s; the sharded phases %.1f s in all"
            % (nvidia_smi_line(), json.dumps(smoke.sharded_idx), t_sharded))
        paths = (lsh_counts, fo_counts, hl_counts, ens_counts, w_counts, bbit_counts, b16_counts, text_counts,
                 forest_counts, f16_counts, facade2_counts, mh_counts, sch_counts,
                 hnsw_counts, h16_counts, l2_counts, m48_counts, shl_counts, shs_counts,
                 *sh_idx.values())
        launches = {name: sum(c[name] for c in paths) for name in lsh_counts}
        report = []
        for k in KERNELS:
            rec = smoke.record[k["name"]]
            report.append({
                "name": k["name"], "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": launches[k["name"]],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            })
        log("[done] %.1f s in all" % (time.perf_counter() - t_start))
        print(json.dumps({"kernels": report}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0
    except Exception:  # the boundary: report and fail
        traceback.print_exc()
        print("chip_smoke: FAILED (build log follows)\n" + build.build_log[-4000:],
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        sys.exit(sharded_worker(*sys.argv[2:]))
    sys.exit(main())
