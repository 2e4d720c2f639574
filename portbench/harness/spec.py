"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; a configuration names the
driver that serves its kind of system. Each is a file of its own:

- ``portbench/configs/<config>.json`` (the path is the config entry's ``file``),
- ``portbench/traffic/<traffic>.json``,
- ``portbench/drivers/<driver>.py``,
- ``portbench/metrics/<metric name>.py``: one reader per metric; a metric
  ``<base>.<part>`` (one quantity split by the cells that report it, each
  with its own bound or end-to-end metric) falls back to
  ``portbench/metrics/<base>.py``,
- ``portbench/roofline/<kernel>.py`` and ``portbench/roofline/peaks.json``.

A later cell, configuration or metric is new files plus new entries;
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots and
    dashes, so the file is loaded by path)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError("no %s named %r (%s)" % (kind, name, path))
    mod_name = "portbench_%s_%s" % (kind, re.sub(r"\W", "_", name))
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader module of metric ``name``: ``metrics/<name>.py``, else
    that of ``name`` without its last ``.<part>``."""
    while True:
        try:
            return load_module("metrics", name)
        except FileNotFoundError:
            if "." not in name:
                raise
            name = name.rsplit(".", 1)[0]


class Spec:
    """The benchmark's definition, read from ``BENCHMARK.json``."""

    def __init__(self, path: str = os.path.join(ROOT, "BENCHMARK.json")):
        self.data = read_json(path)
        self.root = os.path.dirname(os.path.abspath(path))

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError("no workload named %r in BENCHMARK.json" % name)

    def config(self, name: str) -> dict:
        for entry in self.data["configs"]:
            if entry["name"] == name:
                return read_json(os.path.join(self.root, entry["file"]))
        raise KeyError("no config named %r in BENCHMARK.json" % name)

    def traffic(self, name: str) -> dict:
        return read_json(os.path.join(BENCH_DIR, "traffic", name + ".json"))

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a run of ``cell`` reports: the end-to-end ones
        untraced, the per-layer ones traced; an entry with ``workloads``
        only in the cells it lists."""
        entries = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]
