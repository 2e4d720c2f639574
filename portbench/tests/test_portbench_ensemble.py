"""The containment cell (``ensemble-4m.containment-scan``) end to end on the
CPU at a tiny size, with the kernels' plain twins: its result line, its
per-layer metrics, faults planted under its timed path, its control and
the roofline count of its scan."""

import json
import sys
import time

import pytest

from conftest import ROOT

CELL = "ensemble-4m.containment-scan"
# a small vocabulary makes the sets overlap, so every batch reruns to its
# cap (16 -> 128 -> 200) and some query's matches are cut
TINY = {"rows": 2048, "max_results": 200,
        "sets": {"vocab": 100, "zipf": 0.8, "mean_size": 40, "sigma": 0.5, "min_size": 8},
        "batch": 64, "pool": 3, "warm_calls": 3,
        "check": {"calls": 2, "within": 4, "per_call": 64}}
PROGRAM_METRICS = ("passes_per_batch.containment", "rerun_ms_per_batch.containment",
                   "running_topk_ms_per_batch.containment", "decode_ms_per_batch.containment")


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
    assert set(res["checks"]) == {"answers_wrong", "truncated_wrong"}
    json.dumps(res)


def test_a_traced_run_reports_the_program_metrics(run_tiny, spec):
    from datasketch_tpu_torch.utils import profiling

    profiling.reset_counters()
    res = run_tiny(trace=True)
    profiling.reset_counters()
    assert res["correct"], res["checks"]
    traced = {m["name"] for m in spec.metrics(CELL, trace=True)}
    assert traced == set(PROGRAM_METRICS) | {
        "containment_scan_roofline", "idle_share.containment",
        "launches_per_batch.containment", "glue_ms_per_batch.containment"}
    for name in PROGRAM_METRICS:
        assert res["metrics"][name]["value"] > 0, name
    assert res["metrics"]["passes_per_batch.containment"]["value"] == 3.0
    # no device here: a roofline finds no kernel time
    assert "containment_scan_roofline" not in res["metrics"]


def _fault(kind):
    from datasketch_tpu_torch import TorchMinHashLSHEnsemble

    real = TorchMinHashLSHEnsemble.query_batch
    prev = []

    def faulty(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if kind == "stale":  # the answers of the call before
            prev.append(out)
            out = prev[-2] if len(prev) > 1 else out
        elif kind == "half":  # the second half of the batch left out
            out = out[: len(out) // 2] + [[] for _ in out[len(out) // 2:]]
        elif kind == "swapped":  # two answers of one query in the wrong order
            j = next(j for j, ans in enumerate(out) if len(ans) > 1)
            out[j] = [out[j][1], out[j][0]] + out[j][2:]
        elif kind == "untruncated":  # the cut matches not counted
            self.last_truncated = 0
        return out

    return faulty


@pytest.mark.parametrize("kind", ["stale", "half", "swapped", "untruncated"])
def test_a_fault_under_the_timed_path_reads_not_correct(kind, run_tiny, monkeypatch):
    from datasketch_tpu_torch import TorchMinHashLSHEnsemble

    monkeypatch.setattr(TorchMinHashLSHEnsemble, "query_batch", _fault(kind))
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


def test_the_estimate_one_precision_below_reads_not_correct(spec):
    """The reference with its estimate in float16 in the program's place."""
    import torch

    from portbench.harness.spec import load_module

    driver = load_module("drivers", "minhash_ensemble")
    config, traffic = dict(spec.config("ensemble-4m")), dict(spec.traffic("containment-scan"))
    for key, value in TINY.items():
        (config if key in config else traffic)[key] = value
    work = driver.Workload(config, traffic, 7, "cpu", log=lambda msg: None)
    calls = sorted(work.sampled)
    checks = work.compare(work.control(calls, 32, torch.float16), work.expected(calls))
    assert checks["answers_wrong"]["value"] > 0


def test_a_driver_refuses_an_op_it_cannot_check(spec):
    from portbench.harness.spec import load_module

    driver = load_module("drivers", "minhash_ensemble")
    for bad in ({"op": "query_batch", "method": "bands"}, {"op": "top_k", "method": "scan"}):
        with pytest.raises(ValueError):
            driver.Workload(dict(spec.config("ensemble-4m")),
                            dict(bad, batch=8, check={"within": 2, "calls": 1}), 1, "cpu")


# ------------------------------------------------------------ the roofline

def test_containment_count_is_one_pass_whatever_the_reruns(spec):
    from portbench.harness import roofline
    from portbench.harness.spec import load_module

    mod = load_module("roofline", "containment_scan")
    config, traffic = spec.config("ensemble-4m"), spec.traffic("containment-scan")
    c = mod.counts(config, traffic, 1024)
    assert c["alu"] == 1024 * (1 << 22) * 256
    # the count reads no k: a cap that never reruns gives the same work
    assert mod.counts(dict(config, max_results=16), traffic, 1024) == c
    # kernel 2s at Q 1,024 x N 1,048,576 x P 128 (17.09 ms, 37.6 ms in the
    # first ensemble profile) is bounded at 8.217 ms: the compares bind
    small = mod.counts(dict(config, rows=1 << 20, num_perm=128), traffic, 1024)
    sec = roofline.bound_s(small, roofline.peaks())
    assert round(sec * 1e3, 3) == 8.217 and sec < 17.09e-3 < 37.6e-3
    assert small["f32"] / 67e12 < sec / 50 and small["bytes"] / 3.35e12 < sec / 20
    for other in (spec.config("lsh-1m"),):
        assert mod.counts(other, traffic, 1024) is None
    assert mod.counts(config, dict(traffic, method="bands"), 1024) is None
    assert set(mod.KERNELS) == {"topk_scan_kernel", "topk_merge_kernel", "score_kernel"}


def test_the_new_readers_find_nothing_without_spans_or_counters():
    from portbench.harness.runner import Record
    from portbench.harness.spec import metric_reader
    from portbench.harness.trace import Trace

    rec = Record("queries", "cuda", {}, {})
    rec.call_s, rec.call_units = [0.5] * 3, [1024] * 3
    rec.trace = Trace(0, 1.5e6, [], [("portbench.call", 0, 1.5e6)])
    for name in ("rerun_ms_per_batch.containment", "running_topk_ms_per_batch.containment"):
        assert metric_reader(name).read(rec) is None
    rec.trace = None
    assert metric_reader("passes_per_batch.containment").read(rec) is None
    assert metric_reader("containment_scan_roofline").read(rec) is None
