"""FailoverIndex, the health probe and the profiling helpers on the card.

Marked ``cuda``: they skip where no card of capability >= 9.0 is present.
This file imports no JAX, so on a machine with the card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py
"""

import glob
import os

import numpy as np
import pytest
import torch

from datasketch_tpu_torch import FailoverIndex, TorchMinHashLSH
from datasketch_tpu_torch.kernels import lsh_scan, rerank, score
from datasketch_tpu_torch.ops import lsh_ops
from datasketch_tpu_torch.ops.minhash_ops import empty_signatures
from datasketch_tpu_torch.utils import HealthMonitor, device_healthcheck, time_op, trace

pytestmark = pytest.mark.cuda

P = 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a card of capability >= 9.0 (sm_90a kernels)")
    return torch.device("cuda")


def _corpus(n, seed):
    rng = np.random.RandomState(seed)
    sigs = rng.randint(0, 1 << 32, size=(n, P), dtype=np.uint64)
    half = n // 2
    sigs[half:] = sigs[:half]
    flip = rng.rand(half, P) < 0.3
    sigs[half:][flip] = rng.randint(0, 1 << 32, size=int(flip.sum()), dtype=np.uint64)
    sigs[: n // 4] |= np.uint64(1 << 31)  # slots with the top bit set
    return sigs.astype(np.uint32)


def test_failover_on_the_card_then_the_host(dev):
    sigs = _corpus(4096, 1)
    keys = list(range(len(sigs)))
    cards, cpus = [], []
    for device, out in ((dev, cards), ("cpu", cpus)):
        index = TorchMinHashLSH(threshold=0.5, num_perm=P, device=device)
        index.index(keys, sigs)
        for key in keys[::9]:
            index.remove(key)
        out.append(FailoverIndex(index, monitor=HealthMonitor(max_failures=1, device=device)))
    card, cpu = cards[0], cpus[0]
    q = np.concatenate([sigs[:40], sigs[2048:2088]])
    assert card.check()["ok"]
    before = (lsh_scan.launches, rerank.launches, score.launches)
    dev_answers = [card.top_k(q, 10, method="scan"), card.top_k(q, 10, method="bands"),
                   card.query_batch(q, return_scores=True, method="scan"),
                   card.top_k(q, 200, method="scan")]
    torch.cuda.synchronize()
    assert card.last_path == "device"
    after = (lsh_scan.launches, rerank.launches, score.launches)
    assert all(a > b for a, b in zip(after, before))
    assert dev_answers == [cpu.top_k(q, 10, method="scan"), cpu.top_k(q, 10, method="bands"),
                           cpu.query_batch(q, return_scores=True, method="scan"),
                           cpu.top_k(q, 200, method="scan")]
    for fo in (card, cpu):
        fo.monitor.device = "cuda:%d" % torch.cuda.device_count()
        assert not fo.check()["ok"] and fo.serving_from_host
    host = [card.top_k(q, 10), card.query_batch(q, return_scores=True)]
    assert card.last_path == "host"
    assert (lsh_scan.launches, rerank.launches, score.launches) == after
    assert host == [cpu.top_k(q, 10), cpu.query_batch(q, return_scores=True)]
    assert host[1] == dev_answers[2]
    for h, d in zip(host[0], dev_answers[0]):
        assert [s for _, s in h] == [s for _, s in d]
    card.resume_device()
    assert card.top_k(q, 10, method="scan") == dev_answers[0] and card.last_path == "device"


def test_probes_of_the_card(dev):
    for isolate in (True, False):
        res = device_healthcheck(device="cuda:0", isolate=isolate)
        assert res["ok"] and res["latency_s"] is not None, res
        res = device_healthcheck(device="cuda:%d" % torch.cuda.device_count(), isolate=isolate)
        assert not res["ok"] and "no CUDA device" in res["error"], res
    assert device_healthcheck()["ok"]


def test_time_op_and_trace_on_the_card(dev, tmp_path):
    sigs = torch.from_numpy(_corpus(8192, 2).view(np.int32)).to(dev)
    best, out = time_op(lsh_ops.topk_scan, sigs, sigs[:256], 10, warmup=1, iters=3)
    assert 0 < best < 10 and out[0].is_cuda and out[0].shape == (256, 10)
    with trace(str(tmp_path)):
        lsh_ops.topk_scan(sigs, sigs[:256], 10)
        torch.cuda.synchronize()
    files = glob.glob(os.path.join(str(tmp_path), "*.json"))
    assert files and os.path.getsize(files[0]) > 0
    empty = empty_signatures(4, P, device=dev)
    assert empty.is_cuda and bool((empty == -1).all())


def test_direct_address_route_on_the_card(dev):
    sigs = torch.from_numpy(_corpus(1 << 14, 3).view(np.int32)).to(dev)
    fps = lsh_ops.band_fingerprints(sigs, 25, 5)
    sf, si = lsh_ops.build_tables(fps)
    q = sigs[-512:]
    for n_buckets in (1 << 10, 1 << 14):
        off = lsh_ops.build_offsets(sf, n_buckets)
        off_cpu = lsh_ops.build_offsets(sf.cpu(), n_buckets)
        assert torch.equal(off.cpu(), off_cpu)
        got = lsh_ops.topk_fused(sf, si, sigs, q, 25, 5, 64, 10, offsets=off,
                                 n_buckets=n_buckets)
        want = lsh_ops.topk_fused(sf.cpu(), si.cpu(), sigs.cpu(), q.cpu(), 25, 5, 64, 10,
                                  offsets=off_cpu, n_buckets=n_buckets)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
