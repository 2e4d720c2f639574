"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
configuration, traffic mix, metric and roofline found by name."""

import json
import os
import re

import pytest

from conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_KEYS = re.compile(r"(hidden|intermediate|latent|state|projection|head)|(_dim|_rank)$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert c["file"].startswith("portbench/configs/") and c["file"] not in files
        files.add(c["file"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert not any(WIDTH_KEYS.search(k) for k in c["reduced"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_cells(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert names == list(CELLS) and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(names) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    seen = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        # its reader, or that of the quantity it splits by cell
        base = m["name"].split(".")[0]
        assert any(os.path.isfile(os.path.join(ROOT, "portbench", "metrics", n + ".py"))
                   for n in (m["name"], base))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and "workloads" in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        movers = [e for e in bench["end_to_end"] if e["name"] == m["moves"]][0]
        assert set(m["workloads"]) <= set(movers.get("workloads", cells))
    for cell in cells:  # each cell: setup_s, another end-to-end metric, a per-layer one
        mine = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(mine) >= 2 and any(m["name"] == "setup_s" for m in mine)
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_layers_of_one_name(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers == {"device", "kernels", "torch glue", "upload"}


def test_everything_is_found_by_name(spec):
    from portbench.harness.spec import load_module, metric_reader

    for w in spec.data["workloads"]:
        config = spec.config(w["config"])
        assert hasattr(load_module("drivers", config["driver"]), "Workload")
        assert "check" in spec.traffic(w["traffic"])
    for m in spec.data["end_to_end"] + spec.data["per_layer"]:
        assert callable(metric_reader(m["name"]).read)
    for kernel in ("topk_scan", "minhash_sign"):
        mod = load_module("roofline", kernel)
        assert mod.KERNELS and callable(mod.counts)


def test_metrics_of_a_cell_follow_its_entries(spec):
    traced = {m["name"] for m in spec.metrics("lsh-1m.topk-scan", trace=True)}
    assert traced == {"idle_share.scan", "topk_scan_roofline", "launches_per_batch.scan",
                      "glue_ms_per_batch.scan"}
    untraced = {m["name"] for m in spec.metrics("lsh-1m.threshold-bands", trace=False)}
    assert untraced == {"qps.bands", "batch_p95_ms.bands", "peak_mem_gib", "setup_s"}
    untraced = {m["name"] for m in spec.metrics("sign-16k.sha1", trace=False)}
    assert untraced == {"docs_per_s", "peak_mem_gib", "setup_s"}
    # a cell that later entries add reports the metrics open to every cell
    assert {m["name"] for m in spec.metrics("lsh-1m.later", trace=False)} == {
        "peak_mem_gib", "setup_s"}


def test_a_split_metric_is_read_by_its_base_reader():
    from portbench.harness.spec import load_module, metric_reader

    assert metric_reader("qps.scan") is load_module("metrics", "qps")
    assert metric_reader("idle_share.sketch.more") is load_module("metrics", "idle_share")
    assert metric_reader("topk_scan_roofline") is load_module("metrics", "topk_scan_roofline")
    with pytest.raises(FileNotFoundError):
        metric_reader("no_such_metric.scan")
