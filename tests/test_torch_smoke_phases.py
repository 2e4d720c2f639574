"""chip_smoke.py's main-path phases rehearsed on the CPU at a small size.

The plain PyTorch versions stand in for the kernels, so a change that
breaks the script's signatures -> index -> serving -> facade-parity checks,
its ensemble phases, its weighted (CWS) phases, its b-bit phases, its text
phase, its forest phases, the second facade phase, the MinHash-object
phase, the HyperLogLog, signature-scheme and LSHBloom phases, or the HNSW
phases fails here before it reaches a card.
"""

import numpy as np
import torch

import chip_smoke

torch.set_num_threads(2)


def test_smoke_main_path_phases_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    real = smoke.phase_signatures(n_docs=300)
    assert real.shape == (300, chip_smoke.NUM_PERM)
    index, sigs, src, dst, near = smoke.phase_index(real, n_rows=4096)
    smoke.phase_serving(index, sigs, src, dst, near, n_queries=48)
    assert set(smoke.qps) >= {"top_k k=10 scan", "query_batch 0.5 bands"}
    smoke.phase_facade_parity(sigs, n_rows=2048, n_queries=24)


def test_smoke_kernel_phase_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    smoke.phase_kernels(n_docs=300, n_ragged=40, scan=dict(n=3000, nq=40, n2=1500, nq2=20),
                        scan_edges=dict(edge_n=300, edge_q=(1, 33), one_split=(200, 33)),
                        score_edges=dict(edge_t=(1, 63, 64, 65, 130), edge_q=(1, 33),
                                         wide=(70, 128)),
                        rerank_edges=dict(edge_c=(1, 33, 333), edge_n=500, edge_q=9),
                        sha1=dict(n_rand=3000, n_long=20, n_docs=64))
    for name in ("minhash_sign", "topk_scan", "containment_scan", "containment_hits", "rerank",
                 "score_matrix", "compact_rows"):
        assert smoke.record[name]["max_abs_err"] == 0.0
        assert smoke.record[name]["bound_by"] in ("bytes", "operations")
    assert smoke.record["sha1"]["max_abs_err"] == 0.0
    assert smoke.record["sha1"]["bound_by"] == "PCIe bytes"


def test_smoke_ensemble_phases_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    docs, queries, src = smoke.phase_ensemble_corpus(n_sets=2000, n_queries=40)
    ens = smoke.phase_ensemble(docs, queries, src, escalates=False)
    assert set(smoke.ens_qps) == {"scan", "bands", "auto"}
    smoke.phase_ensemble_stream(*ens[:3], batch=16)
    smoke.phase_ensemble_checks(*ens)
    smoke.phase_ensemble_parity(n_sets=1000)


def test_smoke_weighted_phases_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    smoke.phase_kernels_cws(n_rows=600, dense_rows=40, edge_rows=12)
    assert smoke.record["cws_sparse"]["bound_by"] in ("bytes", "operations")
    x, q, src = smoke.phase_weighted_corpus(n_rows=3000, n_queries=48)
    gen, kt = smoke.phase_weighted(x, q, src, cpu_rows=64, dense_rows=40)
    assert set(smoke.w_qps) == {"top_k scan", "top_k bands", "query_batch 0.5 bands"}
    smoke.phase_weighted_checks(gen, x, kt, n_sets=1000, n_pairs=1 << 14)


def test_smoke_bbit_phases_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    smoke.phase_kernels_bbit(n_rows=3000, n_queries=40, ragged=(1, 33, 100))
    assert smoke.record["bbit_scores"]["bound_by"] in ("bytes", "operations")
    head = np.random.RandomState(1).randint(0, 1 << 32, (100, chip_smoke.NUM_PERM),
                                            dtype=np.uint64).astype(np.uint32)
    sigs, src, dst, _ = chip_smoke.synth_index(4096, head)
    for b in (1, 4):
        smoke.phase_bbit(sigs, src, dst, b, n_queries=48, n_remove=20)
    assert set(smoke.bbit) == {1, 4} and smoke.bbit[1]["recall"] >= 0.99
    smoke.phase_bbit_16m(n_rows=8192, chunk=2048, n_queries=48, n_plain=8)
    assert smoke.bbit16["recall"] >= 0.98


def test_smoke_text_phase_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    smoke.phase_text(n_docs=100, n_queries=16, cpu_texts=16, n_tok_docs=200)
    assert set(smoke.text_rate) == {"device", "sha1"}
    assert all(rec >= 0.99 for _, rec in smoke.text_qps.values())


def test_smoke_forest_1m_phases_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    head = np.random.RandomState(2).randint(0, 1 << 32, (100, chip_smoke.NUM_PERM),
                                            dtype=np.uint64).astype(np.uint32)
    sigs, src, dst, _ = chip_smoke.synth_index(4096, head)
    forest, fq = smoke.phase_forest(sigs, src, dst, n_queries=48)
    assert set(smoke.forest_qps) == {"walk forest", "walk jaccard pool 512", "scan",
                                     "auto jaccard", "scan k=256"}
    smoke.phase_forest_checks(forest, fq, sigs, n_plain=8, parity_rows=2048, parity_queries=24)


def test_smoke_forest_16k_facade2_and_minhash_phases_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    f_sigs, f_q, f_src = smoke.forest_corpus(n_docs=400, n_queries=48)
    assert f_sigs.shape == (400, chip_smoke.FOREST16_PERM)
    smoke.phase_forest_16k(f_sigs, f_q, f_src, batch=16, cpu_queries=16)
    assert smoke.forest16["auto"][2] >= 0.9
    smoke.phase_facade2(f_sigs, f_q, n_queries=48, n_remove=20)
    smoke.phase_minhash_objects(n_docs=8)


def test_smoke_hll_phase_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    smoke.phase_hll(n_bench=64, n_docs=512, n_stream=1 << 15, n_sample=64)
    assert smoke.hll["bench"]["rel_err"] < 0.03
    assert set(smoke.hll) >= {"bench", "device", "update_batch_tokens_per_s"}


def test_smoke_schemes_phase_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    smoke.phase_schemes(n_sig=200, n_cpu=50, n_docs=1500, n_queries=40, n_parity=300)
    for scheme in chip_smoke.SCHEMES:
        assert smoke.schemes[scheme]["top_k scan"][1] >= 0.99


def test_smoke_bloom_phase_on_cpu():
    smoke = chip_smoke.Smoke(torch, "cpu")
    sigs = np.random.RandomState(1).randint(0, 1 << 32, (6000, chip_smoke.NUM_PERM),
                                            dtype=np.uint64).astype(np.uint32)
    smoke.phase_bloom(sigs, n=200_000, n_parity=2048, parity_n=20_000, expect=None)
    assert smoke.bloom["fp_rate"] <= 0.09


def test_smoke_hnsw_phases_on_cpu():
    from datasketch_tpu_torch import MinHash

    smoke = chip_smoke.Smoke(torch, "cpu")
    docs = smoke.hnsw_corpus(n_sets=1500)
    assert len(docs) == 1500 and min(map(len, docs)) >= 1
    index, q_rows, rows = smoke.phase_hnsw(docs, n_queries=64)
    assert smoke.hnsw["levels"] == 2
    smoke.phase_hnsw_checks(index, docs, q_rows, rows, n_sample=64, n_cpu=16, n_adds=100,
                            n_removes=30)
    assert smoke.hnsw["recall"] >= chip_smoke.HNSW_RECALL_FLOOR
    docs16 = smoke.hnsw_corpus(n_sets=400)
    index16, q16, rows16, batches = smoke.phase_hnsw_16k(docs16, batch=32)
    smoke.phase_hnsw_16k_checks(index16, docs16, q16, rows16, batches, n_pts=300)
    smoke.phase_hnsw_l2(n=1024, n_queries=64, n_cpu=300)
    assert smoke.hnsw_l2["recall"] >= chip_smoke.HNSW_RECALL_FLOOR
    sigs = MinHash.bulk_signatures(docs16[:300], num_perm=chip_smoke.NUM_PERM,
                                   hashfunc="device", out="device", device="cpu")
    smoke.phase_hnsw_m48(sigs)
    smoke.phase_hnsw_m48_check(sigs)


def test_smoke_failover_and_host_lsh_phases_on_cpu():
    """failover-1m and host-lsh-262k at a small size: the CPU stands in for
    the card (its probe is a real subprocess probe of the CPU); the trip
    probes a CUDA device this host does not have."""
    smoke = chip_smoke.Smoke(torch, "cpu")
    real = smoke.phase_signatures(n_docs=400)
    index, sigs, src, dst, near = smoke.phase_index(real, n_rows=4096)
    smoke.phase_serving(index, sigs, src, dst, near, n_queries=48)
    smoke.phase_failover(index, sigs, dst, n_queries=48, n_host=8)
    assert smoke.failover["probe_latency_s"] is not None
    assert set(smoke.failover["qps"]) >= {"host top_k k=10", "host query_batch 0.5"}
    path = smoke.phase_host_lsh(index, sigs, near, n_rows=2048, n_async=400, n_queries=48)
    smoke.phase_host_lsh_checks(index, path, n_async=400)
    assert smoke.host_lsh["offsets_queries_compared"] >= 40


def test_smoke_sharded_phases_on_cpu():
    """The sharded phases at a small size on the CPU: sharded-lsh-1m's path
    and checks (served index, bands parity, reload, failover), the sharded
    sketches and unions, the five sharded indexes with their parity checks,
    and the two gloo children (the NCCL child needs a card)."""
    smoke = chip_smoke.Smoke(torch, "cpu")
    real = smoke.phase_signatures(n_docs=300)
    index, sigs, src, dst, near = smoke.phase_index(real, n_rows=4096)
    smoke.phase_serving(index, sigs, src, dst, near, n_queries=48)
    sh = smoke.phase_sharded_lsh(index, sigs, dst, n_queries=48)
    smoke.phase_sharded_lsh_checks(index, sigs, *sh, parity_rows=2048, parity_queries=32,
                                   n_host=8)
    assert smoke.sharded_lsh["status"]["n_shards"] == 4
    smoke.phase_sharded_sketch_checks(*smoke.phase_sharded_sketch(n_docs=300, hll_rows=64))
    for parity in (smoke.phase_sharded_bbit(sigs, src, dst, n_queries=48, parity_rows=1024,
                                            parity_queries=32),
                   smoke.phase_sharded_forest(sigs, src, dst, n_queries=48, parity_rows=1024,
                                              n_parity=16),
                   smoke.phase_sharded_bloom(sigs, n_rows=2048, n=100000, parity_rows=512,
                                             parity_n=10000)):
        parity()
    docs, queries, qsrc = smoke.phase_ensemble_corpus(n_sets=2000, n_queries=40)
    smoke.phase_sharded_ensemble(docs, queries, qsrc, parity_sets=500)()
    smoke.phase_sharded_hnsw(smoke.hnsw_corpus(2048), n_sets=1024, n_queries=32,
                             parity_sets=256, n_parity=16)()
    assert set(smoke.sharded_idx) == {"bbit b=1", "forest", "bloom", "ensemble", "hnsw"}
    smoke.phase_sharded_2proc(sigs, n_rows=2048, n_queries=64, nccl=False, timeout=240)
    assert smoke.sharded_2proc["gloo_s"] > 0
