"""Shared pieces of the benchmark's own tests (run with
``python -m pytest portbench/tests -q`` from the repo root; on the card,
``python -m pytest portbench/tests -q -m cuda``)."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CORPUS = {"docs": 48, "tokens_per_doc": 200, "vocab": 500, "token_bytes": 10}
# each cell at a size the CPU runs in about a second, with the plain twins
TINY = {
    "sign-16k": {"corpus": CORPUS, "pool": 3, "check": {"calls": 2, "within": 4}},
    "lsh-1m": {"corpus": CORPUS, "rows": 4096, "near_copies": 40, "batch": 64, "pool": 3,
               "check": {"calls": 2, "within": 4, "per_call": 64}},
}
CELLS = ("lsh-1m.topk-scan", "sign-16k.sha1", "lsh-1m.threshold-bands")


def tiny(cell: str) -> dict:
    return TINY[cell.split(".")[0]]


@pytest.fixture
def spec():
    from portbench.harness.spec import Spec

    return Spec()


@pytest.fixture
def run_tiny(spec):
    """Run a cell on the CPU at its tiny size, with the traffic or
    configuration keys of ``over`` changed; returns the result object."""
    from portbench.harness import runner

    def run(cell, seed=2 ** 31 + 17, seconds=0.3, trace=False, over=None):
        t0 = time.perf_counter()
        return runner.run_cell(spec, cell, seed, seconds, trace, "cpu",
                               lambda: time.perf_counter() - t0,
                               scale=dict(tiny(cell), **(over or {})), log=lambda msg: None)

    return run


@pytest.fixture
def cuda_card():
    """Skip unless a CUDA card of capability >= 9.0 is here (decided when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an NVIDIA card of capability >= 9.0")
    return torch.device("cuda", 0)
