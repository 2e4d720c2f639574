"""``run.py``'s command line: checks, one run, the result line."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "datasketch_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (whole, before the first dot)
    is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def port_in_checkout(root: str) -> bool:
    spec = importlib.util.find_spec("datasketch_tpu_torch")
    if spec is None or spec.origin is None:
        return False
    pkg = os.path.join(root, "datasketch_tpu_torch") + os.sep
    return os.path.abspath(spec.origin).startswith(pkg)


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True, help="a cell name of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: trace the window and report the per-layer metrics")
    return ap.parse_args(argv)


def main(argv, setup_clock) -> int:
    args = parse(argv)
    import torch

    from portbench.harness import runner
    from portbench.harness.spec import ROOT, Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print("[portbench] %s needs %d CUDA device(s); found %s" % (
            args.workload, cell["chips"],
            torch.cuda.device_count() if torch.cuda.is_available() else "none"),
            file=sys.stderr)
        return 3
    if not port_in_checkout(ROOT):
        print("[portbench] datasketch_tpu_torch is not in this checkout (%s)" % ROOT,
              file=sys.stderr)
        return 2
    result = runner.run_cell(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0), setup_clock)
    found = forbidden_modules()
    if found:
        print("[portbench] the run loaded %s; nothing it runs may import JAX or the JAX "
              "package" % ", ".join(found), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
