"""The b-bit cell (``bbit-16m.topk-scan``) end to end on the CPU at a tiny
size, with kernel 5's plain twin: its result line, its per-layer metrics,
faults planted under its timed path, its control and the roofline count
of its scan."""

import json
import sys
import time

import pytest

from conftest import CORPUS, ROOT

CELL = "bbit-16m.topk-scan"
TINY = {"corpus": CORPUS, "rows": 4096, "near_copies": 40, "insert_chunk": 1000,
        "batch": 64, "pool": 3, "check": {"calls": 2, "within": 4, "per_call": 64}}
PROGRAM_METRICS = ("tiles_per_batch.bbit", "decode_ms_per_batch.bbit")


@pytest.fixture
def run_tiny(spec):
    from portbench.harness import runner

    def run(seed=2 ** 31 + 17, seconds=0.3, trace=False, over=None):
        t0 = time.perf_counter()
        return runner.run_cell(spec, CELL, seed, seconds, trace, "cpu",
                               lambda: time.perf_counter() - t0,
                               scale=dict(TINY, **(over or {})), log=lambda msg: None)

    return run


def test_the_cell_runs_correct_on_cpu(run_tiny, spec):
    res = run_tiny()
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks" and res["failed"] == 0
    want = {m["name"] for m in spec.metrics(CELL, trace=False)} - {"peak_mem_gib"}
    assert want == {"qps.scan", "batch_p95_ms.scan", "setup_s"} == set(res["metrics"])
    assert set(res["checks"]) == {"answers_wrong"}
    json.dumps(res)


def test_a_traced_run_reports_the_program_metrics(run_tiny, spec, monkeypatch):
    from datasketch_tpu_torch.ops import bbit_ops
    from datasketch_tpu_torch.utils import profiling

    monkeypatch.setattr(bbit_ops, "_scan_tile", lambda nq: 1000)  # 5 tiles of 4,096 rows
    profiling.reset_counters()
    res = run_tiny(trace=True)
    profiling.reset_counters()
    assert res["correct"], res["checks"]
    traced = {m["name"] for m in spec.metrics(CELL, trace=True)}
    assert traced == set(PROGRAM_METRICS) | {
        "bbit_scan_roofline", "idle_share.bbit", "launches_per_batch.bbit",
        "glue_ms_per_batch.bbit"}
    for name in PROGRAM_METRICS:
        assert res["metrics"][name]["value"] > 0, name
    assert res["metrics"]["tiles_per_batch.bbit"]["value"] == 5.0
    # no device here: a roofline finds no kernel time
    assert "bbit_scan_roofline" not in res["metrics"]


def _fault(kind):
    from datasketch_tpu_torch import TorchBBitIndex

    real = TorchBBitIndex.query_batch
    prev = []

    def faulty(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if kind == "stale":  # the answers of the call before
            prev.append(out)
            out = prev[-2] if len(prev) > 1 else out
        elif kind == "half":  # the second half of the batch left out
            out = out[: len(out) // 2] + [[] for _ in out[len(out) // 2:]]
        elif kind == "swapped":  # two answers of one query in the wrong order
            j = next(j for j, ans in enumerate(out) if ans[0][1] != ans[1][1])
            out[j] = [out[j][1], out[j][0]] + out[j][2:]
        elif kind == "rounded":  # one score rounded to float32
            import numpy as np

            key, score = out[0][0]
            out[0][0] = (key, float(np.float32(score)) + 2.0 ** -30)
        return out

    return faulty


@pytest.mark.parametrize("kind", ["stale", "half", "swapped", "rounded"])
def test_a_fault_under_the_timed_path_reads_not_correct(kind, run_tiny, monkeypatch):
    from datasketch_tpu_torch import TorchBBitIndex

    monkeypatch.setattr(TorchBBitIndex, "query_batch", _fault(kind))
    res = run_tiny(seconds=0.5)
    assert res["failed"] == 0
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 4_000_000_001])
def test_control_reads_not_correct(seed, spec):
    sys.path.insert(0, ROOT + "/portbench")
    from control import control_run

    res = control_run(spec, CELL, seed, "cpu", dict(TINY), log=lambda msg: None)
    assert not res["correct"], res
    assert res["checks"]["answers_wrong"]["value"] > 0


def test_a_driver_refuses_traffic_it_cannot_check():
    from portbench.harness.spec import load_module

    driver = load_module("drivers", "minhash_bbit")
    for bad in ({"op": "top_k", "method": "bands"}, {"op": "query_batch", "method": "scan"}):
        with pytest.raises(ValueError):
            driver.Workload({"corpus": CORPUS}, dict(bad, check={"within": 2, "calls": 1}), 1,
                            "cpu")


def test_the_scan_bound_at_the_cell_size(spec):
    """The docstring's bound: at Q 1,024, N 2**24, W 4 the 2**38 operations
    over the issue lanes and the 2**37 logic ones over the INT32 pipe both
    take 8.217 ms; the bytes 0.08 ms."""
    from portbench.harness import roofline
    from portbench.harness.spec import load_module

    mod = load_module("roofline", "bbit_scan")
    config, traffic = spec.config("bbit-16m"), spec.traffic("topk-scan")
    c = mod.counts(config, traffic, 1024)
    assert (c["alu"], c["either"]) == (2 ** 37, 2 ** 37)
    sec = roofline.bound_s(c, roofline.peaks())
    assert round(sec * 1e3, 3) == 8.217
    assert round(c["bytes"] / 3.35e12 * 1e3, 2) == 0.08
    # W follows b and num_perm: b 2 at P 66 packs 16 slots a word, 5 words
    assert mod.counts(dict(config, b=2, num_perm=66), traffic, 1)["alu"] == 2 * config["rows"] * 5
    for other in (dict(traffic, method="bands"), dict(traffic, op="query_batch")):
        assert mod.counts(config, other, 1024) is None
    assert mod.counts(spec.config("lsh-1m"), traffic, 1024) is None
    assert set(mod.KERNELS) >= {"bbit_kernel"}
