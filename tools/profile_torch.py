#!/usr/bin/env python3
"""Where the time goes on the port's paths, on one card.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 tools/profile_torch.py [CELL ...]

CELL is one of ``sign-16k``, ``lsh-1m``, ``sharded-lsh-1m``, ``failover-1m``,
``host-lsh-262k``, ``ensemble-1m``, ``weighted-1m``, ``bbit-1m``,
``bbit-16m``, ``text-16k``, ``forest-1m``, ``hll``, ``schemes``, ``bloom``,
``hnsw`` (default: all, in that order; ``lsh-1m``, ``sharded-lsh-1m``, ``failover-1m``,
``host-lsh-262k``, ``bbit-1m``, ``forest-1m`` and ``bloom`` index the
signatures of ``sign-16k``'s corpus, as ``chip_smoke.py`` does). Each cell draws
``chip_smoke.py``'s data for it and profiles each step of its path with
``torch.profiler`` (CPU and CUDA activity) over 3 calls after a warm one
(builds: 1 call after a warm one):

- sign-16k: ``MinHash.bulk_signatures`` of 16,384 docs x 200 SHA1 tokens;
- lsh-1m: the 1,048,576-row ``TorchMinHashLSH`` build, ``top_k`` k = 10 by
  scan and bands, threshold ``query_batch`` by bands and scan, ``top_k``
  k = 256 by scan, over 1,024 queries;
- sharded-lsh-1m: the same rows in a ``ShardedMinHashLSH`` over 4 mesh
  positions on the one card, beside the lsh-1m index built from the same
  device signatures: each build and each of lsh-1m's query steps, sharded
  step first;
- failover-1m: the lsh-1m index with 1,000 keys removed behind a
  ``FailoverIndex``: its snapshot, ``top_k`` k = 10 by scan through the
  wrapper on the device, then (tripped by a failed probe) the host scan's
  ``top_k`` k = 10 and threshold ``query_batch`` of 16 queries;
- host-lsh-262k: the first 262,144 lsh-1m rows in the host ``MinHashLSH``
  (``insert_batch``, ``query_batch`` of 1,024 rows) and in a
  ``rerank=False`` ``TorchMinHashLSH`` (``index``, ``query_batch``);
- ensemble-1m: ``index_tokens`` of 1,048,576 sets, ``query_batch`` of
  1,024 subset queries by scan and bands;
- weighted-1m: ``minhash_many`` of 1,048,576 CSR rows (kernel 7) and of the
  first 16,384 rows densified (kernel 6), the index build, ``top_k`` k = 5
  by scan and bands and threshold ``query_batch`` by bands;
- bbit-1m: the lsh-1m rows in a ``TorchBBitIndex`` at b = 1 and b = 4
  (``insert_batch`` of the device tensor), ``query_batch`` k = 10 of 1,024
  planted queries;
- bbit-16m: ``query_batch`` k = 10 of 1,024 planted queries over
  16,777,216 rows at b = 1 (built as ``chip_smoke.py`` builds it);
- text-16k: ``MinHash.bulk_from_text`` of the 16,384 texts with the on-card
  and the SHA1 engine, ``TorchMinHashLSH.index_text``, ``top_k_text`` k =
  10 by scan and bands, and the b = 4 index's ``query_batch`` of the
  queries' on-card sketches;
- forest-1m: the lsh-1m rows in a ``TorchMinHashLSHForest`` (num_perm 128,
  l 8, cap 64): the build, ``query_batch`` k = 10 of 1,024 planted queries
  by the walk (rank 'forest'; rank 'jaccard' with pool 512) and by the
  scan, and the k = 256 scan;
- hll: ``HyperLogLogPlusPlus.bulk_registers`` (p 14) of ``bench_hll``'s
  2,048 docs x 512 tokens on the host, then of 65,536 docs x 512 ids on the
  card; ``hll_ops.sketch_batch64_ids`` alone (the int8 scatter-max), the
  same registers scattered into int32 and cast once, and ``count_batch``;
- schemes: ``MinHash.bulk_signatures`` of sign-16k's corpus by the
  permutation, OPH and C-MinHash schemes, ``index_tokens(scheme="oph")`` of
  262,144 docs x 200 ids, ``top_k`` k = 10 by scan and bands of 1,024
  queries;
- bloom: a ``TorchMinHashLSHBloom`` sized for 100,000,000 keys:
  ``insert_batch`` and ``query_batch`` of 262,144 lsh-1m rows, and
  ``query_batch`` of 1,024, ``save`` and ``load``;
- hnsw: hnsw-1m's 1,048,576 clustered sets (``chip_smoke.clustered_sets``):
  their signatures, the kNN rows (kernel 2), the diversity pruning, the
  whole ``TorchHNSW.index`` build, ``query_batch`` k = 10 of 1,024 corpus
  members and ``query_stream`` (4 x 256, depth 4), an append of 2,048 adds;
  hnsw-16k's build and 256-query batch; hnsw-65k-l2's build (plain tiles)
  and 1,024-query batch.

Each step prints one JSON line: wall ms per call (host clock, synced),
device ms per call (the union of the CUDA kernel and copy intervals), the
device's idle share and the largest device events.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("sign-16k", "lsh-1m", "sharded-lsh-1m", "failover-1m", "host-lsh-262k", "ensemble-1m", "weighted-1m", "bbit-1m", "bbit-16m",
         "text-16k", "forest-1m", "hll", "schemes", "bloom", "hnsw")


def device_time(prof):
    """(union ms of the CUDA intervals, [(name, ms)] largest first)."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) / 1e3
    busy, cur_s, cur_e = 0.0, None, None
    for start, end in sorted(spans):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3, sorted(by_name.items(), key=lambda kv: -kv[1])


def profiled(torch, label: str, fn, reps: int = 3):
    fn()  # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    busy, by_name = device_time(prof)
    print(json.dumps({
        "step": label, "wall_ms": wall, "device_ms": busy / reps,
        "idle_share": 1.0 - busy / reps / wall,
        "top_device_ms": [[name[:60], ms / reps] for name, ms in by_name[:8]],
    }), flush=True)
    return out


def recall(src, rows, scored: bool = True) -> float:
    """Share of queries whose source key is among the returned keys."""
    import numpy as np

    return float(np.mean([int(s) in ([key for key, _ in row] if scored else row)
                          for s, row in zip(src, rows)]))


def profile_sign(torch, chip_smoke, dev):
    from datasketch_tpu_torch import MinHash

    corpus = chip_smoke.make_corpus(chip_smoke.SIG_DOCS, seed=42)
    sigs = profiled(torch, "bulk_signatures %d docs" % len(corpus),
                    lambda: MinHash.bulk_signatures(corpus, num_perm=chip_smoke.NUM_PERM,
                                                    seed=1, out="device", device=dev))
    return sigs.cpu().numpy().view("uint32")


def profile_lsh(torch, chip_smoke, dev, real):
    from datasketch_tpu_torch import TorchMinHashLSH

    n = chip_smoke.N_INDEX
    sigs, src, dst, _ = chip_smoke.synth_index(n, real)

    def build_index():
        index = TorchMinHashLSH(threshold=0.5, num_perm=chip_smoke.NUM_PERM, bucket_cap=128,
                                device=dev)
        index.index(range(n), sigs)
        return index

    index = profiled(torch, "index %d rows" % n, build_index, reps=1)
    nq = chip_smoke.N_QUERIES
    queries, expect = sigs[dst[-nq:]], src[-nq:]
    k = chip_smoke.TOP_K
    for method in ("scan", "bands"):
        rows = profiled(torch, "top_k k=%d %s" % (k, method),
                        lambda m=method: index.top_k(queries, k, method=m))
        print(json.dumps({"recall": recall(expect, rows)}), flush=True)
    for method in ("bands", "scan"):
        profiled(torch, "query_batch 0.5 %s" % method,
                 lambda m=method: index.query_batch(queries, return_scores=True, method=m))
    profiled(torch, "top_k k=%d scan" % chip_smoke.BIG_K,
             lambda: index.top_k(queries, chip_smoke.BIG_K, method="scan"))


def profile_sharded_lsh(torch, chip_smoke, dev, real):
    from datasketch_tpu_torch import TorchMinHashLSH
    from datasketch_tpu_torch.parallel import ShardedMinHashLSH, make_mesh

    n, nq, k = chip_smoke.N_INDEX, chip_smoke.N_QUERIES, chip_smoke.TOP_K
    sigs, src, dst, _ = chip_smoke.synth_index(n, real)
    rows = torch.from_numpy(sigs.view("int32")).to(dev)
    mesh = make_mesh(4, shape=(4, 1), device=dev)

    kw = dict(threshold=0.5, num_perm=chip_smoke.NUM_PERM, bucket_cap=128)

    def build(index):
        index.index(range(n), rows)
        return index

    pair = (("sharded", profiled(torch, "sharded index %d rows" % n,
                                 lambda: build(ShardedMinHashLSH(mesh, **kw)), reps=1)),
            ("lsh-1m", profiled(torch, "lsh-1m index %d rows" % n,
                                lambda: build(TorchMinHashLSH(device=dev, **kw)), reps=1)))
    queries, expect = sigs[dst[-nq:]], src[-nq:]
    steps = [("top_k k=%d %s" % (k, m), lambda ix, m=m: ix.top_k(queries, k, method=m))
             for m in ("scan", "bands")]
    steps += [("query_batch 0.5 %s" % m,
               lambda ix, m=m: ix.query_batch(queries, return_scores=True, method=m))
              for m in ("bands", "scan")]
    steps.append(("top_k k=%d scan" % chip_smoke.BIG_K,
                  lambda ix: ix.top_k(queries, chip_smoke.BIG_K, method="scan")))
    for label, fn in steps:
        for name, index in pair:
            out = profiled(torch, "%s %s" % (name, label), lambda: fn(index))
            if label.startswith("top_k k=%d" % k):
                print(json.dumps({"recall": recall(expect, out)}), flush=True)


def profile_failover(torch, chip_smoke, dev, real):
    from datasketch_tpu_torch import FailoverIndex, TorchMinHashLSH
    from datasketch_tpu_torch.utils import HealthMonitor

    n, nq = chip_smoke.N_INDEX, chip_smoke.N_QUERIES
    sigs, src, dst, _ = chip_smoke.synth_index(n, real)
    index = TorchMinHashLSH(threshold=0.5, num_perm=chip_smoke.NUM_PERM, bucket_cap=128,
                            device=dev)
    index.index(range(n), sigs)
    for key in dict.fromkeys(int(x) for x in src[-nq:][:chip_smoke.N_REMOVE]):
        index.remove(key)
    fo = FailoverIndex(index, monitor=HealthMonitor(max_failures=1), snapshot=False)
    profiled(torch, "snapshot %d rows" % n, fo.refresh_snapshot, reps=1)
    queries = sigs[dst[-nq:]]
    profiled(torch, "wrapper top_k k=%d scan" % chip_smoke.TOP_K,
             lambda: fo.top_k(queries, chip_smoke.TOP_K, method="scan"))
    fo.monitor.device = "cuda:%d" % torch.cuda.device_count()
    fo.check()
    hq = queries[:chip_smoke.FO_HOST_QUERIES]
    profiled(torch, "host top_k k=%d of %d" % (chip_smoke.TOP_K, len(hq)),
             lambda: fo.top_k(hq, chip_smoke.TOP_K), reps=1)
    profiled(torch, "host query_batch 0.5 of %d" % len(hq),
             lambda: fo.query_batch(hq, return_scores=True), reps=1)


def profile_host_lsh(torch, chip_smoke, dev, real):
    from datasketch_tpu_torch import MinHash, MinHashLSH, TorchMinHashLSH

    n, nq = chip_smoke.HOST_LSH_ROWS, chip_smoke.N_QUERIES
    rows = chip_smoke.synth_index(chip_smoke.N_INDEX, real)[0][:n]
    objs = [MinHash(num_perm=chip_smoke.NUM_PERM, hashvalues=r) for r in rows]

    def host_build():
        host = MinHashLSH(threshold=0.5, num_perm=chip_smoke.NUM_PERM)
        host.insert_batch(range(n), objs)
        return host

    def device_build():
        ix = TorchMinHashLSH(threshold=0.5, num_perm=chip_smoke.NUM_PERM, rerank=False,
                             bucket_cap=chip_smoke.HOST_LSH_CAP, device=dev)
        ix.index(range(n), rows)
        return ix

    host = profiled(torch, "host insert_batch %d rows" % n, host_build, reps=1)
    profiled(torch, "host query_batch %d" % nq, lambda: host.query_batch(objs[:nq]))
    ix = profiled(torch, "rerank=False index %d rows" % n, device_build, reps=1)
    profiled(torch, "rerank=False query_batch %d" % nq, lambda: ix.query_batch(rows[:nq]))


def profile_ensemble(torch, chip_smoke, dev, smoke):
    import numpy as np

    from datasketch_tpu_torch import MinHash, TorchMinHashLSHEnsemble

    docs, queries, src = smoke.phase_ensemble_corpus()

    def build_index():
        index = TorchMinHashLSHEnsemble(threshold=chip_smoke.ENS_THRESHOLD,
                                        num_perm=chip_smoke.NUM_PERM, num_part=8,
                                        bucket_cap=128, max_results=2048, device=dev)
        index.index_tokens(range(len(docs)), docs)
        return index

    index = profiled(torch, "index_tokens %d sets" % len(docs), build_index, reps=1)
    q_sigs = MinHash.bulk_signatures(queries, num_perm=chip_smoke.NUM_PERM,
                                     hashfunc="device", out="device", device=dev)
    batch = (q_sigs, np.array([q.size for q in queries]))
    for method in ("scan", "bands"):
        rows = profiled(torch, "ensemble query_batch %s" % method,
                        lambda m=method: index.query_batch(batch, method=m))
        print(json.dumps({"recall": recall(src, rows, scored=False)}), flush=True)


def profile_weighted(torch, chip_smoke, dev, smoke):
    from datasketch_tpu_torch import TorchMinHashLSH, WeightedMinHashGenerator

    x, q, src = smoke.phase_weighted_corpus()
    gen = WeightedMinHashGenerator(chip_smoke.W_DIM, chip_smoke.W_SAMPLES, seed=1,
                                   device=dev)
    kt = profiled(torch, "minhash_many CSR %d rows" % x.shape[0],
                  lambda: gen.minhash_many(x, out="device"))
    dense = x[: chip_smoke.W_DENSE_ROWS].toarray()
    profiled(torch, "minhash_many dense %d rows" % dense.shape[0],
             lambda: gen.minhash_many(dense, out="device"))
    del dense

    def build_index():
        index = TorchMinHashLSH(threshold=0.5, num_perm=chip_smoke.W_SAMPLES, device=dev)
        index.index(range(kt.shape[0]), kt)
        return index

    index = profiled(torch, "index %d (k, t) rows" % kt.shape[0], build_index, reps=1)
    q_kt = gen.minhash_many(q, out="device")
    k = chip_smoke.W_TOP_K
    for method in ("scan", "bands"):
        rows = profiled(torch, "top_k k=%d %s" % (k, method),
                        lambda m=method: index.top_k(q_kt, k, method=m))
        print(json.dumps({"recall": recall(src, rows)}), flush=True)
    profiled(torch, "query_batch 0.5 bands",
             lambda: index.query_batch(q_kt, return_scores=True, method="bands"))


def profile_bbit(torch, chip_smoke, dev, real):
    from datasketch_tpu_torch import TorchBBitIndex

    n = chip_smoke.N_INDEX
    sigs, src, dst, _ = chip_smoke.synth_index(n, real)
    dev_sigs = torch.from_numpy(sigs.view("int32")).to(dev)
    nq, k = chip_smoke.N_QUERIES, chip_smoke.TOP_K
    queries = dev_sigs[torch.from_numpy(dst[-nq:]).to(dev)]
    for b in (1, 4):
        def build_index(b=b):
            index = TorchBBitIndex(b=b, num_perm=chip_smoke.NUM_PERM, device=dev)
            index.insert_batch(range(n), dev_sigs)
            return index

        index = profiled(torch, "b-bit insert_batch %d rows b=%d" % (n, b), build_index, reps=1)
        rows = profiled(torch, "b-bit query_batch k=%d b=%d" % (k, b),
                        lambda: index.query_batch(queries, k))
        print(json.dumps({"recall": recall(src[-nq:], rows, scored=False)}), flush=True)
        del index
        torch.cuda.empty_cache()


def profile_bbit_16m(torch, chip_smoke, dev, smoke):
    index, queries, expect = smoke.build_bbit_16m()[:3]
    torch.cuda.empty_cache()
    rows = profiled(torch, "b-bit query_batch k=%d b=1, %d rows"
                    % (chip_smoke.TOP_K, len(index)),
                    lambda: index.query_batch(queries, chip_smoke.TOP_K))
    print(json.dumps({"recall": recall(expect, rows, scored=False)}), flush=True)


def profile_text(torch, chip_smoke, dev):
    import numpy as np

    from datasketch_tpu_torch import MinHash, TorchBBitIndex, TorchMinHashLSH

    texts = [b" ".join(doc) for doc in chip_smoke.make_corpus(chip_smoke.SIG_DOCS, seed=42)]
    p, k = chip_smoke.NUM_PERM, chip_smoke.TOP_K
    for engine, kw in (("device", {"hashfunc": "device"}), ("sha1", {})):
        profiled(torch, "bulk_from_text %s %d texts" % (engine, len(texts)),
                 lambda kw=kw: MinHash.bulk_from_text(texts, k=9, num_perm=p, out="device",
                                                      device=dev, **kw))

    def build_index():
        index = TorchMinHashLSH(threshold=0.5, num_perm=p, device=dev)
        index.index_text(range(len(texts)), texts, k=9)
        return index

    lsh = profiled(torch, "index_text %d texts" % len(texts), build_index, reps=1)
    bb = TorchBBitIndex(b=4, num_perm=p, device=dev)
    bb.insert_text(range(len(texts)), texts, k=9)
    rng = np.random.RandomState(45)
    src = rng.choice(len(texts), chip_smoke.N_QUERIES, replace=False)
    queries = [texts[i][:-100] + bytes(rng.randint(97, 123, 100, dtype=np.uint8)) for i in src]
    for method in ("scan", "bands"):
        rows = profiled(torch, "top_k_text k=%d %s" % (k, method),
                        lambda m=method: lsh.top_k_text(queries, k, method=m))
        print(json.dumps({"recall": recall(src, rows)}), flush=True)
    q_sigs = MinHash.bulk_from_text(queries, k=9, num_perm=p, hashfunc="device", out="device",
                                    device=dev)
    rows = profiled(torch, "b-bit (b=4) query_batch k=%d of text sketches" % k,
                    lambda: bb.query_batch(q_sigs, k))
    print(json.dumps({"recall": recall(src, rows, scored=False)}), flush=True)


def profile_forest(torch, chip_smoke, dev, real):
    from datasketch_tpu_torch import TorchMinHashLSHForest

    n = chip_smoke.N_INDEX
    sigs, src, dst, _ = chip_smoke.synth_index(n, real)

    def build_index():
        forest = TorchMinHashLSHForest(num_perm=chip_smoke.NUM_PERM, l=chip_smoke.FOREST_L,
                                       cap=chip_smoke.FOREST_CAP, device=dev)
        forest.index(range(n), sigs)
        return forest

    forest = profiled(torch, "forest index %d rows" % n, build_index, reps=1)
    nq = chip_smoke.N_QUERIES
    queries, expect = sigs[dst[-nq:]], src[-nq:]
    k = chip_smoke.TOP_K
    for label, pool, kw in (("walk forest", 0, dict(method="forest", rank="forest")),
                            ("walk jaccard pool %d" % chip_smoke.FOREST_POOL,
                             chip_smoke.FOREST_POOL, dict(method="forest", rank="jaccard")),
                            ("scan", 0, dict(method="scan", rank="jaccard"))):
        forest.pool = pool
        rows = profiled(torch, "forest query_batch k=%d %s" % (k, label),
                        lambda kw=kw: forest.query_batch(queries, k, **kw))
        print(json.dumps({"recall": recall(expect, rows, scored=False)}), flush=True)
    forest.pool = 0
    profiled(torch, "forest query_batch k=%d scan" % chip_smoke.FOREST_BIG_K,
             lambda: forest.query_batch(queries, chip_smoke.FOREST_BIG_K, method="scan",
                                        rank="jaccard"))


def profile_hll(torch, chip_smoke, dev):
    import numpy as np

    from datasketch_tpu_torch import HyperLogLogPlusPlus
    from datasketch_tpu_torch.device import u32_values
    from datasketch_tpu_torch.ops import hll_ops
    from datasketch_tpu_torch.ops.hashing import mix64

    p, t = chip_smoke.HLL_P, chip_smoke.HLL_TOKENS
    docs = [[b"d%d-t%d" % (d, i) for i in range(t)] for d in range(chip_smoke.HLL_BENCH_DOCS)]
    profiled(torch, "bulk_registers host %d docs x %d tokens" % (len(docs), t),
             lambda: HyperLogLogPlusPlus.bulk_registers(docs, p=p))
    n = chip_smoke.HLL_DOCS
    ids = np.random.RandomState(23).randint(0, 1 << 24, size=(n, t)).astype(np.uint32)
    profiled(torch, "bulk_registers device %d docs x %d ids" % (n, t),
             lambda: HyperLogLogPlusPlus.bulk_registers(ids, p=p, hashfunc="device",
                                                        device_mode="always", device=dev),
             reps=1)
    dev_ids = torch.from_numpy(ids.view("int32")).to(dev)
    lens = torch.full((n,), t, dtype=torch.int32, device=dev)
    regs = profiled(torch, "sketch_batch64_ids (int8 scatter-max)",
                    lambda: hll_ops.sketch_batch64_ids(dev_ids, lens, p))

    def int32_regs():
        lo = u32_values(dev_ids)
        hi, lo = mix64(torch.zeros_like(lo), lo)
        idx, rank = hll_ops.ranks_and_indices64(hi, lo, p)
        wide = torch.zeros((n, 1 << p), dtype=torch.int32, device=dev)
        return wide.scatter_reduce_(1, idx, rank.to(torch.int32), "amax").to(torch.int8)

    wide = profiled(torch, "the same into int32 registers, cast once", int32_regs)
    print(json.dumps({"int32_equal": bool(torch.equal(wide, regs))}), flush=True)
    del wide
    profiled(torch, "count_batch %d rows" % n, lambda: hll_ops.count_batch(regs, p))


def profile_schemes(torch, chip_smoke, dev):
    import numpy as np

    from datasketch_tpu_torch import MinHash, TorchMinHashLSH

    corpus = chip_smoke.make_corpus(chip_smoke.SIG_DOCS, seed=42)
    p = chip_smoke.NUM_PERM
    for scheme in ("permutation",) + chip_smoke.SCHEMES:
        profiled(torch, "bulk_signatures %s %d docs" % (scheme, len(corpus)),
                 lambda s=scheme: MinHash.bulk_signatures(corpus, scheme=s, num_perm=p,
                                                          out="device", device=dev))
    rng = np.random.RandomState(29)
    n = chip_smoke.SCH_DOCS
    ids = rng.randint(0, 1 << 20, size=(n, chip_smoke.TOKENS_PER_DOC)).astype(np.uint32)
    src = rng.randint(0, n, size=chip_smoke.SCH_QUERIES)
    q_ids = ids[src].copy()
    swap = rng.rand(*q_ids.shape) < chip_smoke.SCH_REPLACE
    q_ids[swap] = rng.randint(0, 1 << 20, size=int(swap.sum()))

    def build_index():
        index = TorchMinHashLSH(threshold=0.5, num_perm=p, device=dev)
        index.index_tokens(range(n), ids, scheme="oph")
        return index

    index = profiled(torch, "index_tokens oph %d docs" % n, build_index, reps=1)
    q_sigs = MinHash.bulk_signatures(q_ids, scheme="oph", num_perm=p, hashfunc="device",
                                     out="device", device=dev)
    for method in ("scan", "bands"):
        rows = profiled(torch, "top_k k=%d %s (oph)" % (chip_smoke.TOP_K, method),
                        lambda m=method: index.top_k(q_sigs, chip_smoke.TOP_K, method=m))
        print(json.dumps({"recall": recall(src, rows)}), flush=True)


def profile_bloom(torch, chip_smoke, dev, real):
    from datasketch_tpu_torch import TorchMinHashLSHBloom

    sigs = chip_smoke.synth_index(chip_smoke.N_INDEX, real)[0]
    batch = sigs[: chip_smoke.N_INDEX // chip_smoke.BLOOM_BATCHES]
    bloom = TorchMinHashLSHBloom(threshold=chip_smoke.BLOOM_THRESHOLD,
                                 num_perm=chip_smoke.NUM_PERM, n=chip_smoke.BLOOM_N,
                                 fp=chip_smoke.BLOOM_FP, device=dev)
    profiled(torch, "bloom insert_batch %d rows" % len(batch),
             lambda: bloom.insert_batch(batch))
    profiled(torch, "bloom query_batch %d rows" % len(batch), lambda: bloom.query_batch(batch))
    q = sigs[-chip_smoke.N_QUERIES:]
    profiled(torch, "bloom query_batch %d rows" % len(q), lambda: bloom.query_batch(q))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bloom")
        profiled(torch, "bloom save (%d B of words)" % (bloom._words.numel() * 4),
                 lambda: bloom.save(path), reps=1)
        profiled(torch, "bloom load", lambda: TorchMinHashLSHBloom.load(path, device=dev),
                 reps=1)


def profile_hnsw(torch, chip_smoke, dev):
    import numpy as np

    from datasketch_tpu_torch import MinHash, TorchHNSW
    from datasketch_tpu_torch.ops import hnsw_ops, knn_graph

    m, ef, k = chip_smoke.HNSW_M, chip_smoke.HNSW_EF, chip_smoke.TOP_K
    docs = chip_smoke.clustered_sets(torch, chip_smoke.HNSW_SETS, dev, 41)
    n = len(docs)
    sigs = profiled(torch, "hnsw-1m signatures of %d sets" % n,
                    lambda: MinHash.bulk_signatures(docs, num_perm=chip_smoke.NUM_PERM,
                                                    hashfunc="device", out="device",
                                                    device=dev), reps=1)
    del docs
    dist = hnsw_ops.distance_fn("minhash_jaccard")
    cands = profiled(torch, "hnsw-1m kNN rows k=%d (%s route)"
                     % (3 * m, knn_graph.knn_route(sigs, 3 * m, "minhash_jaccard")),
                     lambda: knn_graph.knn_adjacency(sigs, 3 * m, "minhash_jaccard"), reps=1)
    profiled(torch, "hnsw-1m diversity pruning to m=%d" % m,
             lambda: knn_graph._prune_diverse(sigs, cands, m, 256, dist), reps=1)
    del cands

    def build(metric, pts):
        index = TorchHNSW(distance_metric=metric, m=m, ef=ef, device=dev)
        index.index(range(pts.shape[0]), pts)
        return index

    index = profiled(torch, "hnsw-1m TorchHNSW.index", lambda: build("minhash_jaccard", sigs),
                     reps=1)
    q = sigs[torch.as_tensor(np.random.RandomState(43).choice(n, chip_smoke.HNSW_QUERIES,
                                                              replace=False), device=dev)]
    profiled(torch, "hnsw-1m query_batch k=%d of %d" % (k, q.shape[0]),
             lambda: index.query_batch(q, k))
    batches = [q[i: i + q.shape[0] // 4] for i in range(0, q.shape[0], q.shape[0] // 4)]
    profiled(torch, "hnsw-1m query_stream 4 x %d depth 4" % batches[0].shape[0],
             lambda: list(index.query_stream(batches, k, depth=4)))
    new = chip_smoke.Smoke(torch, dev).near_copies(
        sigs[:chip_smoke.HNSW_ADDS], 0.8, seed=46).cpu().numpy()
    calls = [0]

    def append():
        calls[0] += 1
        for i in range(new.shape[0]):
            index.add((calls[0], i), new[i])
        index.flush()

    profiled(torch, "hnsw-1m %d adds + flush (append path)" % new.shape[0], append, reps=1)
    del index, sigs
    torch.cuda.empty_cache()

    docs = chip_smoke.clustered_sets(torch, chip_smoke.HNSW16_SETS, dev, 41)
    sigs = MinHash.bulk_signatures(docs, num_perm=chip_smoke.NUM_PERM, hashfunc="device",
                                   out="device", device=dev)
    index = profiled(torch, "hnsw-16k TorchHNSW.index", lambda: build("minhash_jaccard", sigs),
                     reps=1)
    q = sigs[: chip_smoke.HNSW16_BATCH]
    profiled(torch, "hnsw-16k query_batch k=%d of %d" % (k, q.shape[0]),
             lambda: index.query_batch(q, k))

    gen = torch.Generator(device=dev).manual_seed(31)
    n, d, c = chip_smoke.L2_POINTS, chip_smoke.L2_DIM, chip_smoke.L2_CLUSTER
    centers = torch.randn((n // c, d), generator=gen, device=dev) * 4
    pts = centers.repeat_interleave(c, 0) + torch.randn((n, d), generator=gen, device=dev)
    index = profiled(torch, "hnsw-65k-l2 TorchHNSW.index (plain tiles)",
                     lambda: build("l2", pts), reps=1)
    q = pts[: chip_smoke.HNSW_QUERIES] + torch.randn((chip_smoke.HNSW_QUERIES, d),
                                                     generator=gen, device=dev)
    profiled(torch, "hnsw-65k-l2 query_batch k=%d of %d" % (k, q.shape[0]),
             lambda: index.query_batch(q, k))


def main() -> int:
    import torch

    cells = sys.argv[1:] or list(CELLS)
    unknown = sorted(set(cells) - set(CELLS))
    if unknown:
        print("profile_torch: unknown cell(s) %s; cells are %s"
              % (", ".join(unknown), ", ".join(CELLS)), file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    smoke = chip_smoke.Smoke(torch, dev)
    smoke.phase_build()
    real = None
    for cell in CELLS:
        needs_real = bool({"lsh-1m", "sharded-lsh-1m", "failover-1m", "host-lsh-262k", "bbit-1m", "forest-1m",
                           "bloom"} & set(cells))
        if cell not in cells and not (cell == "sign-16k" and needs_real):
            continue
        print(json.dumps({"cell": cell}), flush=True)
        if cell == "sign-16k":
            real = profile_sign(torch, chip_smoke, dev)
        elif cell == "lsh-1m":
            profile_lsh(torch, chip_smoke, dev, real)
        elif cell == "sharded-lsh-1m":
            profile_sharded_lsh(torch, chip_smoke, dev, real)
        elif cell == "failover-1m":
            profile_failover(torch, chip_smoke, dev, real)
        elif cell == "host-lsh-262k":
            profile_host_lsh(torch, chip_smoke, dev, real)
        elif cell == "ensemble-1m":
            profile_ensemble(torch, chip_smoke, dev, smoke)
        elif cell == "weighted-1m":
            profile_weighted(torch, chip_smoke, dev, smoke)
        elif cell == "bbit-1m":
            profile_bbit(torch, chip_smoke, dev, real)
        elif cell == "bbit-16m":
            profile_bbit_16m(torch, chip_smoke, dev, smoke)
        elif cell == "forest-1m":
            profile_forest(torch, chip_smoke, dev, real)
        elif cell == "hll":
            profile_hll(torch, chip_smoke, dev)
        elif cell == "schemes":
            profile_schemes(torch, chip_smoke, dev)
        elif cell == "bloom":
            profile_bloom(torch, chip_smoke, dev, real)
        elif cell == "hnsw":
            profile_hnsw(torch, chip_smoke, dev)
        else:
            profile_text(torch, chip_smoke, dev)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
