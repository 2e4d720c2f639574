#!/usr/bin/env python3
"""One kernel of one or more checkouts, timed in turns on one card: kernel 2
(the fused exact-scan top-k), kernel 3 (the band-candidate rerank), kernel 4
(the score matrix), kernel 6 (CWS over dense rows) or kernel 7 (CWS over CSR
rows).

Usage, from the root of a checkout, on a machine with one CUDA card:

    python3 tools/scan_steps.py [--kernel scan|rerank|score|cws_dense|cws_sparse]
                                [--sass] [--reps N] [--p P] [--out DIR] [ROOT ...]

Each ROOT is the root of a checkout of this repository (default: this
one); give the same one twice to time it twice (for example ``OLD . .
OLD``). For each ROOT in the order given, one process imports
``datasketch_tpu_torch`` from that ROOT, builds its kernels (``nvcc``) and
prints ptxas' registers, shared memory and spills for the kernel (kept
beside the build, so every process of a ROOT prints them). The
first time a ROOT comes up, it also holds the kernel exactly equal to its
plain version on every case of ``chip_smoke.py``'s phase for it
(``Smoke.phase_kernels_scan``, ``phase_kernels_rerank``,
``phase_kernels_score``, ``phase_kernels_cws_dense`` and
``phase_kernels_cws_edges``, ``phase_kernels_cws``; ``chip_smoke.py`` of
this checkout, whichever ROOT is under test) and fails if one differs.
Every process then times, with CUDA events (mean of N calls after a warm
one; ``--reps 0``: no timing), the timed shapes: ``scan`` Q 1,024 x N
1,048,576 x P (128 unless ``--p``) at k 10, and the sizes mode at k 16
and k 128 (cutoff 0.8); ``rerank`` the smoke's Q 1,024 x C 3,200 list
over that table and the band-candidate list of the lsh-1m serving path
(1,024 queries of ``top_k(method="bands")`` over the smoke's 1,048,576-row
index, banding 25 x 5, bucket cap 128; its live share is printed);
``score`` Q 1,024 x T 8,192 x P; ``cws_dense`` the weighted path's first
6,710 rows densified (D 10,000, S 128: the smoke's timed chunk);
``cws_sparse`` the weighted path's 1,048,576 CSR rows at D 10,000, S 128.
With ``--sass`` it also prints the opcode counts of the kernel's inner
loop (``cuobjdump -sass``): for ``scan`` and ``score`` the innermost loop
that compares staged rows in the scan, score and b-bit kernels; for
``rerank`` the innermost loop with the most global loads in each form of
the kernel, and its instructions per load (at P 128: per live candidate
row); for ``cws_dense`` and ``cws_sparse`` the innermost loop with the most
``MUFU`` (the fold's division), and its instructions per ``MUFU``: warp
instructions per 32 (entry, sample) folds. With ``--out DIR`` each
process's full output, and with ``--sass`` each build's whole SASS
listing, are written under DIR.

Prints one JSON line per process and, first, the card's name and power
limit. Exits non-zero if a build or a parity check failed.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SASS_KERNELS = ("topk_scan_kernel", "score_kernel", "bbit_kernel")
PTXAS_NAMES = {"scan": "topk_scan", "rerank": "rerank_kernel", "score": "score_kernel",
               "cws_dense": "cws_dense", "cws_sparse": "cws_sparse"}
# kernel -> (function names, the opcode that picks the loop, the per-unit key)
SASS_LOOPS = {"rerank": (("rerank_kernel",), "LDG", "per_load"),
              "cws_dense": (("cws_dense",), "MUFU", "per_mufu"),
              "cws_sparse": (("cws_sparse",), "MUFU", "per_mufu")}


def load_smoke():
    """``chip_smoke.py`` of this checkout, loaded by path so that the
    package comes from the ROOT under test."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(log: str, name: str) -> list:
    """ptxas' report lines for the entry function whose name holds ``name``."""
    out, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = name in line
            if on:
                out.append(line.split("'")[1] if "'" in line else line.strip())
        elif on and ("registers" in line or "spill" in line or "smem" in line):
            out.append(line.strip())
    return out


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def functions(sass: str) -> dict:
    """Function name -> [(address, instruction text)] of a cuobjdump -sass
    listing; a label takes the address of the instruction after it."""
    funcs, cur, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = []
            labels[cur] = {}
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(2)))
    return {name: (body, labels[name]) for name, body in funcs.items()}


def opcode(text: str) -> str:
    parts = text.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def register_compares(loop) -> int:
    return sum(1 for _, t in loop if opcode(t).startswith("ISETP")
               and len(re.findall(r"\bR\d+\b", t)) >= 2)


def loops(body, labels) -> list:
    """(start, end) addresses of every backward branch's loop."""
    out = []
    for addr, text in body:
        if opcode(text) != "BRA":
            continue
        target = text.split("BRA")[1].strip().strip("`()")
        if target in labels:
            tgt = labels[target]
        else:
            try:
                tgt = int(target.split()[-1], 16)
            except ValueError:
                continue
        if tgt < addr:
            out.append((tgt, addr))
    return out


def compare_loop(body, labels, key: str = "LDS.128") -> list:
    """Instructions of the innermost loop (no loop inside it) with the most
    instructions whose opcode starts with ``key``: for 16-byte shared
    loads, the loop that compares staged rows."""
    spans = loops(body, labels)
    best, best_n = [], 0
    for lo, hi in spans:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans):
            continue
        loop = [(a, t) for a, t in body if lo <= a <= hi]
        n_key = sum(1 for _, t in loop if opcode(t).startswith(key))
        if n_key > best_n or (n_key == best_n and len(loop) > len(best)):
            best, best_n = loop, n_key
    return best


def sass_report(lib_path: str, out_dir, tag: str, kernel: str) -> dict:
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-400:]}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "sass_%s.txt" % tag), "w") as fh:
            fh.write(proc.stdout)
    report = {}
    names, key, per = SASS_LOOPS.get(kernel, (SASS_KERNELS, "LDS.128", None))
    for name, (body, labels) in functions(proc.stdout).items():
        hit = next((k for k in names if k in name), None)
        if hit is None:
            continue
        loop = compare_loop(body, labels, key)
        hist = collections.Counter(opcode(t).split(".")[0] for _, t in loop)
        entry = {"function": name[:100], "loop_instructions": len(loop),
                 "opcodes": dict(hist.most_common())}
        if per:
            entry[per] = len(loop) / max(1, hist[key])
        else:
            entry["register_compares"] = register_compares(loop)
        report.setdefault(hit, []).append(entry)
    return report


def scan_calls(smoke_mod, smoke, parity: bool, p: int) -> dict:
    data = smoke.scan_data(p=p)
    if parity:
        smoke.phase_kernels_scan(data)
    k2 = smoke.kmod("topk_scan")
    db, q, n, sizes, q_sizes = (data[x] for x in ("db", "q", "n", "sizes", "q_sizes"))
    return {
        "topk_scan k=10": lambda: k2.topk_scan(db, q, 10, n),
        "containment_scan k=16": lambda: k2.containment_topk(db, sizes, q, q_sizes, 16, 0.8),
        "containment_scan k=128": lambda: k2.containment_topk(db, sizes, q, q_sizes, 128, 0.8),
    }


def score_calls(smoke_mod, smoke, parity: bool, p: int) -> dict:
    data = smoke.scan_data(p=p)
    if parity:
        smoke.phase_kernels_score(data)
    k4 = smoke.kmod("score_matrix")
    q, tile = data["q"], data["db"][:8192]
    return {"score_matrix Q=1024 T=8192": lambda: k4.score_matrix(q, tile)}


def rerank_calls(smoke_mod, smoke, parity: bool, p: int) -> dict:
    data = smoke.scan_data(p=p)
    if parity:
        smoke.phase_kernels_rerank(data)
    k3 = smoke.kmod("rerank")
    db, q, cand = data["db"], data["q"], smoke.rerank_cand(data)
    bands = band_candidates(smoke_mod, smoke)
    return {"rerank Q=1024 C=3200": lambda: k3.rerank_scores(db, q, cand),
            "rerank lsh-1m bands": lambda: k3.rerank_scores(*bands)}


def band_candidates(smoke_mod, smoke):
    """(table, queries, candidates) of the lsh-1m ``top_k(method="bands")``
    step: the smoke's 1,048,576-row index and its 1,024 planted queries."""
    import numpy as np
    import torch

    from datasketch_tpu_torch import MinHash, TorchMinHashLSH
    from datasketch_tpu_torch.ops import lsh_ops

    corpus = smoke_mod.make_corpus(smoke_mod.SIG_DOCS, seed=42)
    real = MinHash.bulk_signatures(corpus, num_perm=smoke_mod.NUM_PERM, seed=1,
                                   out="device", device=smoke.device)
    sigs, _, dst, _ = smoke_mod.synth_index(smoke_mod.N_INDEX,
                                            real.cpu().numpy().view(np.uint32))
    index = TorchMinHashLSH(threshold=0.5, num_perm=smoke_mod.NUM_PERM, bucket_cap=128,
                            device=smoke.device)
    index.index(range(smoke_mod.N_INDEX), sigs)
    q = index._queries(sigs[dst[-smoke_mod.N_QUERIES:]])
    cand, _ = lsh_ops._band_candidates(index._sorted_fp, index._sorted_ids, q, index.b,
                                       index.r, index.bucket_cap, None)
    live = cand[cand >= 0]
    distinct = int(torch.unique(live).numel())
    # as chip_smoke's bound for kernel 3: each distinct row and query read
    # once, the ids read and the scores written; one compare a live slot
    nbytes = 4 * (distinct + q.shape[0]) * q.shape[1] + 8 * cand.numel()
    smoke.steps_info = {"band_candidates": {
        "shape": list(cand.shape), "b": index.b, "r": index.r, "live": int(live.numel()),
        "live_share": live.numel() / cand.numel(), "distinct_rows": distinct,
        "bound_ms": 1e3 * max(nbytes / smoke_mod.PEAK_BYTES,
                              live.numel() * q.shape[1] / smoke.int_rate)}}
    return index._sigs, q, cand.contiguous()


def cws_dense_calls(smoke_mod, smoke, parity: bool, p: int) -> dict:
    import torch

    from datasketch_tpu_torch import WeightedMinHashGenerator

    gen = WeightedMinHashGenerator(smoke_mod.W_DIM, smoke_mod.W_SAMPLES, seed=1,
                                   device=smoke.device)
    if parity:
        smoke.phase_kernels_cws_dense(gen)
        smoke.phase_kernels_cws_edges()
    kc = smoke.kmod("cws_dense")
    rows = gen._CHUNK_ELEMS // smoke_mod.W_DIM
    csr = smoke_mod.make_weighted_rows(torch, smoke_mod.W_DENSE_ROWS, smoke_mod.W_DIM,
                                       smoke.device, seed=17)
    w = smoke_mod.densify(torch, *csr, smoke_mod.W_DIM)[:rows]
    tables = gen.params_t()
    return {"cws_dense %d rows" % rows: lambda: kc.cws_dense(w, *tables)}


def cws_calls(smoke_mod, smoke, parity: bool, p: int) -> dict:
    import torch

    from datasketch_tpu_torch import WeightedMinHashGenerator

    if parity:
        smoke.phase_kernels_cws()
    torch.cuda.empty_cache()
    kc = smoke.kmod("cws_sparse")
    gen = WeightedMinHashGenerator(smoke_mod.W_DIM, smoke_mod.W_SAMPLES, seed=1,
                                   device=smoke.device)
    args = smoke_mod.make_weighted_rows(torch, smoke_mod.W_ROWS, smoke_mod.W_DIM,
                                        smoke.device, seed=17) + tuple(gen.params_t())
    return {"cws_sparse 1M rows": lambda: kc.cws_sparse(*args)}


CALLS = {"scan": scan_calls, "rerank": rerank_calls, "score": score_calls,
         "cws_dense": cws_dense_calls, "cws_sparse": cws_calls}


def worker(root: str, kernel: str, parity: bool, sass: bool, reps: int, tag: str,
           p: int, out_dir) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    smoke_mod = load_smoke()
    from datasketch_tpu_torch.kernels import build

    lib_path = build._build()
    build.library()
    out = {"root": root, "kernel": kernel, "p": p,
           "ptxas": ptxas_lines(build.build_log, PTXAS_NAMES[kernel])}
    smoke = smoke_mod.Smoke(torch, "cuda")
    calls = CALLS[kernel](smoke_mod, smoke, parity, p)
    if parity:
        out["parity"] = "exact"
    out.update(getattr(smoke, "steps_info", {}))
    if reps > 0:
        out["ms"] = {label: smoke.time_ms(fn, iters=reps) for label, fn in calls.items()}
    if sass:
        out["sass"] = sass_report(lib_path, out_dir, tag, kernel)
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--kernel", choices=sorted(CALLS), default="scan")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--reps", type=int, default=5, help="timed calls (0: parity and SASS only)")
    ap.add_argument("--p", type=int, default=128, help="slots per row of the timed table")
    ap.add_argument("--out", help="directory for each process's output and SASS listings")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--parity", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.kernel, args.parity, args.sass, args.reps, args.tag,
                      args.p, args.out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    seen, rc = set(), 0
    for i, root in enumerate(args.roots):
        tag = "%s_p%d_%d_%s" % (args.kernel, args.p, i, os.path.basename(os.path.abspath(root)))
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root,
               "--kernel", args.kernel, "--reps", str(args.reps), "--p", str(args.p),
               "--tag", tag]
        if args.out:
            cmd += ["--out", args.out]
        if root not in seen:
            cmd.append("--parity")
            if args.sass:
                cmd.append("--sass")
        seen.add(root)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "steps_%s.log" % tag), "w") as fh:
                fh.write(proc.stdout + proc.stderr)
        lines = proc.stdout.strip().splitlines()
        if lines and lines[-1].startswith("{"):
            print(lines[-1], flush=True)
        if proc.returncode != 0:
            print("%s failed (rc %d):\n%s" % (root, proc.returncode, proc.stderr[-3000:]),
                  flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
