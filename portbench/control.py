#!/usr/bin/env python3
"""The control of a cell: the plain reference put in the program's place,
computed with the cheaper arithmetic that breaks one of the
configuration's guarantees, and judged by the check a run makes.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

draws each seed's inputs at the cell's own size, answers the calls a run
would keep (the seeded sample and one last call) with the control, and
prints one JSON line per seed with the compared numbers and their limits.
Every line must read not correct: a control that passed would show that
the check cannot tell the cheaper arithmetic from the configuration's.
The benchmark's runs never run this. Uses the first CUDA card, or
``--device cpu``.
"""

import argparse
import json
import os
import sys


def control_run(spec, cell_name: str, seed: int, device, scale: dict = None,
                log=None) -> dict:
    from portbench.harness import spec as spec_mod

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = spec.cell(cell_name)
    config = dict(spec.config(cell["config"]))
    traffic = dict(spec.traffic(cell["traffic"]))
    for key, value in (scale or {}).items():
        (config if key in config else traffic)[key] = value
    driver = spec_mod.load_module("drivers", config["driver"])
    work = driver.Workload(config, traffic, seed, device, log)
    calls = sorted(work.sampled) + [traffic["check"]["within"] + 1]
    checks = work.compare(work.control(calls), work.expected(calls))
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"workload": cell_name, "seed": seed, "correct": correct, "checks": checks}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from portbench.harness.spec import Spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[portbench] no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    spec = Spec()
    for seed in args.seeds:
        print(json.dumps(control_run(spec, args.workload, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
