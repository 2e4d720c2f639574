"""What the benchmark's files import and read: never JAX, Flax or the JAX
package (top-level names compared whole), never the repo's JAX-era
benchmarks or tools; the plain reference never the port."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "datasketch_tpu"}
FILES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _strings(path):
    """String constants that are not docstrings."""
    tree = ast.parse(open(path).read(), path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_reads_no_jax_era_benchmark_or_tool(path):
    if os.path.basename(path) == "test_portbench_imports.py":
        return
    for s in _strings(path):
        assert not any(bad in s for bad in ("bench.py", "benchmarks/", "chip_smoke", "tools/")), s


def test_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "hashlib", "numpy", "torch", "portbench"}, (path, tops)
        portbench = [n for n in _imports(path) if n.split(".")[0] == "portbench"]
        assert all(n.startswith("portbench.reference") for n in portbench), (path, portbench)


def test_a_run_loads_no_jax(tmp_path):
    """A whole run (on the CPU, tiny) in a fresh process leaves no JAX
    module loaded: the runtime form of the check ``run.py`` makes."""
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import tiny\n"
        "from portbench.harness import runner, cli\n"
        "from portbench.harness.spec import Spec\n"
        "res = runner.run_cell(Spec(), 'lsh-1m.topk-scan', 3, 0.2, True, 'cpu', time.perf_counter,"
        " scale=tiny('lsh-1m'), log=lambda m: None)\n"
        "assert res['correct'], res\n"
        "print(cli.forbidden_modules())\n" % (ROOT, os.path.join(BENCH, "tests")))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
