"""Each cell end to end on the CPU at a tiny size (the plain twins), the
result line's format, faults planted under the timed path, and the
controls."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import CELLS, ROOT, tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(cell, run_tiny, spec):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert list(res)[:5] == RESULT_KEYS and list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    # every end-to-end metric of the cell but the device's memory (0 on the CPU)
    want = {m["name"] for m in spec.metrics(cell, trace=False)} - {"peak_mem_gib"}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


# every (op, method) the facade serves, answered by the reference: a cell of
# any of them is a traffic file and an entry
@pytest.mark.parametrize("over", [
    {"method": "bands"},
    {"method": "bands", "k": 3},
    {"op": "query_batch", "method": "scan", "return_scores": True},
    {"op": "query_batch", "method": "scan", "return_scores": False},
    {"op": "query_batch", "method": "bands", "return_scores": False},
    {"k": 128},
], ids=lambda o: "-".join("%s=%s" % kv for kv in o.items()))
def test_every_op_and_method_runs_correct_on_cpu(over, run_tiny):
    res = run_tiny("lsh-1m.topk-scan", over=over)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["checks"]["answers_wrong"]["value"] == 0


@pytest.mark.parametrize("over", [
    {"op": "query_batch", "method": "scan", "return_scores": False},
    {"op": "query_batch", "method": "scan", "return_scores": True},
    {"method": "bands"},
])
def test_a_fault_reads_not_correct_under_every_op_and_method(over, run_tiny, monkeypatch):
    from datasketch_tpu_torch import TorchMinHashLSH

    for name, fn in _lsh_fault("altered").items():
        monkeypatch.setattr(TorchMinHashLSH, name, fn)
    res = run_tiny("lsh-1m.topk-scan", seconds=0.5, over=over)
    assert not res["correct"], res["checks"]


def test_a_driver_refuses_an_op_it_cannot_check():
    from portbench.harness.spec import load_module

    driver = load_module("drivers", "minhash_lsh")
    for bad in ({"op": "top_k", "method": "auto"}, {"op": "query", "method": "scan"}):
        with pytest.raises(ValueError):
            driver.Workload({"corpus": {}}, dict(bad, check={"within": 2, "calls": 1}), 1, "cpu")


@pytest.mark.parametrize("cell", ["lsh-1m.threshold-bands", "sign-16k.sha1"])
def test_traced_run_reports_the_per_layer_metrics_it_can_read(cell, run_tiny):
    res = run_tiny(cell, trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] == 0.0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    # no device here: the idle shares read 100 %, a roofline finds nothing
    assert not any(name.endswith("_roofline") for name in res["metrics"])


# ----------------------------------------------------------- planted faults


def _lsh_fault(kind):
    from datasketch_tpu_torch import TorchMinHashLSH

    real = {"top_k": TorchMinHashLSH.top_k, "query_batch": TorchMinHashLSH.query_batch}
    prev = {}

    def wrap(name):
        def faulty(self, *args, **kwargs):
            out = real[name](self, *args, **kwargs)
            if kind == "stale":  # the state of the call before
                out, prev[name] = prev.get(name, out), out
            elif kind == "half":  # the second half of the batch left out
                out = out[: len(out) // 2] + [[] for _ in out[len(out) // 2:]]
            elif kind == "altered":  # one answer altered where it is produced
                j = next(j for j, ans in enumerate(out) if ans)
                first = out[j][0]
                first = (first[0] + 1, first[1]) if isinstance(first, tuple) else first + 1
                out[j] = [first] + out[j][1:]
            return out
        return faulty

    return {name: wrap(name) for name in real}


def _sign_fault(kind):
    from datasketch_tpu_torch import MinHash

    real = MinHash.bulk_signatures.__func__
    prev = []

    def faulty(cls, *args, **kwargs):
        out = real(cls, *args, **kwargs)
        if kind == "stale":
            prev.append(out)
            out = prev[-2] if len(prev) > 1 else out
        elif kind == "half":
            out = out.clone()
            out[out.shape[0] // 2:] = -1  # left unsigned (MAX_HASH)
        elif kind == "altered":
            out = out.clone()
            out[5, 7] ^= 1
        return out

    return classmethod(faulty)


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_reads_not_correct(cell, kind, run_tiny, monkeypatch):
    from datasketch_tpu_torch import MinHash, TorchMinHashLSH

    if cell.startswith("lsh"):
        for name, fn in _lsh_fault(kind).items():
            monkeypatch.setattr(TorchMinHashLSH, name, fn)
    else:
        monkeypatch.setattr(MinHash, "bulk_signatures", _sign_fault(kind))
    res = run_tiny(cell, seconds=0.5)
    assert res["failed"] == 0
    assert not res["correct"], res["checks"]


def test_a_call_that_raises_fails_the_run(run_tiny, monkeypatch):
    from datasketch_tpu_torch import TorchMinHashLSH

    calls = []

    def boom(self, *args, **kwargs):
        calls.append(1)
        if len(calls) > 3:  # set-up's warm calls pass
            raise RuntimeError("planted")
        return real(self, *args, **kwargs)

    real = TorchMinHashLSH.top_k
    monkeypatch.setattr(TorchMinHashLSH, "top_k", boom)
    res = run_tiny("lsh-1m.topk-scan", seconds=600)  # the raise ends the window
    assert not res["correct"] and res["failed"] == 64


# ------------------------------------------------------------- the controls


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 4_000_000_001])
@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(cell, seed, spec):
    sys.path.insert(0, ROOT + "/portbench")
    from control import control_run

    scale = dict(tiny(cell))
    if cell.startswith("lsh"):  # enough near-duplicate answers for 8-bit slots to show
        scale["batch"] = 256
        scale["check"] = {"calls": 3, "within": 4, "per_call": 256}
    res = control_run(spec, cell, seed, "cpu", scale, log=lambda msg: None)
    assert not res["correct"], res
    assert all(c["value"] > c["limit"] for c in res["checks"].values())


# ----------------------------------------------------------- the command


def test_command_refuses_without_a_card_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sign-16k.sha1", "--seed",
         "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_reference_signatures_match_the_numpy_formula():
    from portbench.reference import minhash as ref

    rng = np.random.default_rng(5)
    h = rng.integers(0, 1 << 32, size=(3, 17), dtype=np.uint64)
    a, b = ref.permutations(1, 16)
    want = ((h[..., None] * a.astype(np.uint64) + b.astype(np.uint64))
            % np.uint64((1 << 61) - 1)) & np.uint64(0xFFFFFFFF)
    table = torch.from_numpy(h.reshape(-1).astype(np.int64))
    ids = torch.arange(h.size).reshape(3, 17)
    got = ref.signatures(table, ids, 1, 16).numpy().view(np.uint32)
    assert np.array_equal(got, want.min(axis=1).astype(np.uint32))
