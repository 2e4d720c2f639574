"""Port parity: ``host_topk_scan`` and ``FailoverIndex`` against the JAX
package's. A ``device="cpu"`` TorchMinHashLSH loaded from a JAX
``TpuMinHashLSH.save`` file answers as the JAX FailoverIndex does on both
paths (ids, scores and tie order); the host path takes uint32 slots with
the top bit set; a device error trips the wrapper only through a failed
probe, caller and kernel errors raise, and failback is explicit."""

import numpy as np
import pytest
import torch

import datasketch_tpu as J
import datasketch_tpu_torch as T
from datasketch_tpu import serving as jax_serving
from datasketch_tpu.utils.health import HealthMonitor as JaxMonitor
from datasketch_tpu_torch import serving
from datasketch_tpu_torch.kernels import build
from datasketch_tpu_torch.kernels.build import KernelError
from datasketch_tpu_torch.utils.health import HealthMonitor

P = 128


def _scripted(base):
    class Scripted(base):
        """Monitor whose checks are scripted instead of probing a device."""

        def __init__(self, outcomes):
            super().__init__(max_failures=1)
            self._outcomes = list(outcomes)

        def check(self):
            ok = self._outcomes.pop(0) if self._outcomes else True
            res = {"ok": ok, "latency_s": 0.001 if ok else None,
                   "error": None if ok else "wedged"}
            self.last_result = res
            self.history.append((0.0, ok, res["latency_s"]))
            self.consecutive_failures = 0 if ok else self.consecutive_failures + 1
            return res

    return Scripted


def _corpus(n, seed, values=0, top_bit=False):
    """uint32[n, P]: full-range slots, or 0..values-1 (ties); near-copies
    in the second half. ``top_bit`` sets bit 31 of every slot."""
    rng = np.random.RandomState(seed)
    hi = values or (1 << 32)
    sigs = rng.randint(0, hi, size=(n, P), dtype=np.uint64)
    half = n // 2
    sigs[half:] = sigs[:half]
    flip = rng.rand(half, P) < 0.3
    sigs[half:][flip] = rng.randint(0, hi, size=int(flip.sum()), dtype=np.uint64)
    if top_bit:
        sigs |= np.uint64(1 << 31)
    return sigs.astype(np.uint32)


@pytest.mark.parametrize("values,k,dead", [(0, 5, 0), (3, 7, 0), (2, 40, 9), (4, 300, 30)])
def test_host_topk_scan_matches_jax(values, k, dead):
    sigs = _corpus(200, values + k, values=values)
    q = np.concatenate([sigs[:6], _corpus(6, 99, values=values)])
    alive = None
    if dead:
        alive = np.ones(len(sigs), dtype=bool)
        alive[np.random.RandomState(k).choice(len(sigs), dead, replace=False)] = False
    got = serving.host_topk_scan(sigs, q, k, alive=alive)
    want = jax_serving.host_topk_scan(sigs, q, k, alive=alive)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(serving.host_topk_scan(sigs[:0], q, 3), jax_serving.host_topk_scan(sigs[:0], q, 3)):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def saved_index(tmp_path_factory):
    """A JAX TpuMinHashLSH with removals, saved; and its signatures."""
    sigs = _corpus(300, 7)
    keys = [f"doc{i}" for i in range(len(sigs))]
    index = J.TpuMinHashLSH(threshold=0.5, num_perm=P, bucket_cap=64)
    index.index(keys, sigs)
    for key in keys[::7]:
        index.remove(key)
    path = str(tmp_path_factory.mktemp("serving") / "lsh.npz")
    index.save(path)
    return index, path, sigs


def _pair(saved_index, outcomes=()):
    jax_index, path, sigs = saved_index
    torch_index = T.TorchMinHashLSH.load(path, device="cpu")
    return (J.FailoverIndex(jax_index, monitor=_scripted(JaxMonitor)(list(outcomes))),
            T.FailoverIndex(torch_index, monitor=_scripted(HealthMonitor)(list(outcomes))),
            sigs)


def _answers(fo, queries):
    return [
        fo.top_k(queries, k=10),
        fo.query_batch(queries, threshold=0.5, return_scores=True),
        fo.query_batch(queries),
        fo.query(queries[0]),
    ]


def test_failover_matches_jax_on_both_paths(saved_index):
    jfo, tfo, sigs = _pair(saved_index, outcomes=[True, False])
    q = np.concatenate([sigs[:12], sigs[150:156], _corpus(4, 11)])
    jq = [J.MinHash(num_perm=P, hashvalues=r) for r in q]
    tq = [T.MinHash(num_perm=P, hashvalues=r) for r in q]
    assert jfo.check()["ok"] and tfo.check()["ok"]
    assert _answers(tfo, tq) == _answers(jfo, jq)
    assert tfo.last_path == jfo.last_path == "device"
    assert tfo.top_k(tq, k=10, method="bands") == jfo.top_k(jq, k=10, method="bands")
    assert not tfo.check()["ok"] and not jfo.check()["ok"]
    assert tfo.serving_from_host and tfo.status()["serving_from_host"]
    want = _answers(jfo, jq)
    assert jfo.last_path == "host"
    for queries in (tq, q, torch.from_numpy(q.view(np.int32)),
                    [torch.from_numpy(r.view(np.int32)) for r in q]):
        assert _answers(tfo, queries) == want
        assert tfo.last_path == "host"
        assert (tfo.top_k(queries, k=4, return_scores=False)
                == jfo.top_k(jq, k=4, return_scores=False))
    tst, jst = tfo.status(), jfo.status()
    assert tst["snapshot_rows"] == jst["snapshot_rows"] == len(sigs)
    assert tst["monitor"]["consecutive_failures"] == jst["monitor"]["consecutive_failures"] == 1
    assert len(tfo) == len(jfo) and ("doc1" in tfo) == ("doc1" in jfo)
    tfo.resume_device()
    assert tfo.top_k(tq[:3], k=5) == jfo._index.top_k(jq[:3], 5)
    assert tfo.last_path == "device"


def test_host_path_takes_slots_with_the_top_bit_set():
    sigs = _corpus(64, 3, top_bit=True)
    assert (sigs >= (1 << 31)).all()
    index = T.TorchMinHashLSH(threshold=0.5, num_perm=P, device="cpu")
    index.index(list(range(len(sigs))), sigs)
    fo = T.FailoverIndex(index, monitor=_scripted(HealthMonitor)([False]))
    # k 2 holds each query and its near-copy; k 3 adds a tie at score 0,
    # where the host's argpartition and the device's id order may pick
    # different members, so there only the score columns are compared
    device2, device3 = fo.top_k(sigs[:8], k=2), fo.top_k(sigs[:8], k=3)
    fo.check()
    for queries in ([T.MinHash(num_perm=P, hashvalues=r) for r in sigs[:8]], sigs[:8],
                    torch.from_numpy(sigs[:8].view(np.int32))):
        assert fo.top_k(queries, k=2) == device2
        assert fo.last_path == "host"
        host3 = fo.top_k(queries, k=3)
        assert [[s for _, s in row] for row in host3] == [[s for _, s in row] for row in device3]
        assert all(row[:2] == [(i, 1.0), (i + 32, row[1][1])] for i, row in enumerate(host3))
    want = jax_serving.host_topk_scan(sigs, sigs[:8], 3)
    for g, w in zip(serving.host_topk_scan(sigs, serving._host_signature_matrix(
            [T.MinHash(num_perm=P, hashvalues=r) for r in sigs[:8]]), 3), want):
        np.testing.assert_array_equal(g, w)


class _StubIndex:
    threshold = 0.5

    def __init__(self, sigs, exc):
        self.sigs, self.exc = sigs, exc

    def host_snapshot(self):
        return {"keys": list(range(len(self.sigs))), "sigs": self.sigs, "alive": None}

    def top_k(self, minhashes, k, **kwargs):
        if self.exc is not None:
            raise self.exc
        return [[("device", 1.0)]]

    def query_batch(self, minhashes, threshold=None, return_scores=False, **kwargs):
        return self.top_k(minhashes, 1)


def test_trips_on_device_errors_only_and_fails_back_explicitly():
    """A device error trips the wrapper only through a failed probe: on a
    card that probes healthy it raises, as kernel and caller errors always
    do, and the host answers only once a real probe of a missing device
    has failed."""
    sigs = _corpus(32, 5)
    index = _StubIndex(sigs, RuntimeError("CUDA error: an illegal memory access"))
    fo = T.FailoverIndex(index, monitor=HealthMonitor(max_failures=1, device="cpu",
                                                      isolate=False))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        fo.top_k(sigs[:2], k=1)
    assert not fo.serving_from_host and fo.status()["monitor"]["checks"] == 1
    assert "illegal memory access" in fo.status()["last_device_error"]
    with pytest.raises(KernelError, match="CUDA error 700"):
        build.check(700, "ds_topk_scan")
    for exc in (KernelError("nvcc failed (1)"), ValueError("bad query")):
        index.exc = exc
        with pytest.raises(type(exc)):
            fo.query_batch(sigs[:2])
        assert not fo.serving_from_host and fo.status()["monitor"]["checks"] == 1
    index.exc = RuntimeError("CUDA error: unspecified launch failure")
    fo.monitor.device = "cuda:%d" % torch.cuda.device_count()  # no such card
    rows = fo.top_k(sigs[:2], k=1)
    assert fo.last_path == "host" and fo.serving_from_host
    assert rows == [[(0, 1.0)], [(1, 1.0)]]
    assert fo.monitor.consecutive_failures == 1 and fo.status()["monitor"]["checks"] == 2
    assert "launch failure" in fo.status()["last_device_error"]
    index.exc = None
    assert fo.top_k(sigs[:2], k=1) == rows  # stays on the host until resumed
    fo.resume_device()
    assert fo.top_k(sigs[:2], k=1) == [[("device", 1.0)]] and fo.last_path == "device"
    fo2 = T.FailoverIndex(index, monitor=_scripted(HealthMonitor)([False]), snapshot=False)
    fo2.check()
    with pytest.raises(RuntimeError, match="refresh_snapshot"):
        fo2.top_k(sigs[:1], k=1)


def test_refresh_snapshot_after_removals():
    sigs = _corpus(40, 6)
    index = T.TorchMinHashLSH(threshold=0.5, num_perm=P, device="cpu")
    index.index([f"d{i}" for i in range(len(sigs))], sigs)
    fo = T.FailoverIndex(index, monitor=_scripted(HealthMonitor)([False]))
    fo.check()
    assert fo.top_k(sigs[:1], k=1)[0][0] == ("d0", 1.0)
    index.remove("d0")
    assert fo.top_k(sigs[:1], k=1)[0][0] == ("d0", 1.0)  # the old snapshot
    fo.refresh_snapshot()
    assert fo.top_k(sigs[:1], k=1)[0][0][0] == "d20"
    assert "d0" not in fo.query_batch(sigs[:1], threshold=0.0)[0]
