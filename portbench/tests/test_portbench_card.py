"""The command on a card: one short run of each configuration's cheapest
cell, traced and not (``python -m pytest portbench/tests -q -m cuda``)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell,trace", [("sign-16k.sha1", 0), ("sign-16k.sha1", 1),
                                        ("lsh-1m.topk-scan", 0)])
def test_command_on_the_card(cell, trace, cuda_card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "4100000001",
         "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    if trace:
        assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
        assert 0 < res["metrics"]["minhash_sign_roofline"]["value"] < 100
    else:
        assert res["metrics"]["setup_s"]["value"] > 0
