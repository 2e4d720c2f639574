"""The per-layer metrics that read the port's own spans and counters
(``source`` ``program_span`` or ``program_counter``): their entries, their
readers on a tiny traced CPU run of each cell, and a program that has
neither (a reader then finds nothing and the metric is left out)."""

import json
import os

import pytest

from conftest import CELLS, ROOT

PROGRAM = ("program_span", "program_counter")
LAYERS = {"facade", "host front end", "upload", "torch glue"}


@pytest.fixture(scope="module")
def entries():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    return bench, [m for m in bench["per_layer"] if m["source"] in PROGRAM]


def test_program_metric_entries(entries):
    from portbench.harness.spec import metric_reader

    bench, mine = entries
    assert {m["name"] for m in mine} == {
        "decode_ms_per_batch.scan", "decode_ms_per_batch.bands", "upload_ms_per_batch.scan",
        "dispatch_ms_per_batch.bands", "fetch_kib_per_batch.bands", "fetch_used_share.bands",
        "sha1_ms_per_batch.sketch", "tokens_ms_per_batch.sketch"}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in mine:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["layer"] in LAYERS
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
        assert callable(metric_reader(m["name"]).read)
    # each is the last of the list: entries the benchmark had come first
    assert bench["per_layer"][-len(mine):] == mine


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_each_program_metric_in_its_cells(cell, entries, run_tiny):
    from datasketch_tpu_torch.utils import profiling

    _, mine = entries
    profiling.reset_counters()
    res = run_tiny(cell, trace=True)
    profiling.reset_counters()
    assert res["correct"], res["checks"]
    for m in mine:
        if cell not in m["workloads"]:
            assert m["name"] not in res["metrics"]
            continue
        value = res["metrics"][m["name"]]["value"]
        assert value > 0, m["name"]
        if m["unit"] == "%":
            assert value <= 100.0, m["name"]
    # on the CPU the window's idle time lies under the program's spans
    assert res["breakdown"]["idle_gaps"][0][0] != "portbench.call"


def test_fetched_kib_are_the_ids_scores_and_counts_of_a_batch(run_tiny):
    from datasketch_tpu_torch.utils import profiling

    profiling.reset_counters()
    res = run_tiny("lsh-1m.threshold-bands", trace=True)
    profiling.reset_counters()
    # 64 queries x 3,200 slots (25 bands x bucket cap 128) of int32 ids and
    # f32 scores, 64 int32 match counts and one int64 truncation count
    want = (64 * 3200 * 8 + 64 * 4 + 8) / 1024
    assert res["metrics"]["fetch_kib_per_batch.bands"]["value"] == pytest.approx(want)


def test_readers_find_nothing_in_a_program_without_spans_or_counters(entries):
    from datasketch_tpu_torch.utils import profiling
    from portbench.harness.runner import Record
    from portbench.harness.spec import metric_reader
    from portbench.harness.trace import Trace

    _, mine = entries
    rec = Record("queries", "cpu")
    rec.call_s = [0.01, 0.01]
    rec.trace = Trace(0.0, 1e6, [], [("portbench.call", 0.0, 5e5), ("aten::mm", 10.0, 20.0)])
    profiling.reset_counters()
    for m in mine:
        assert metric_reader(m["name"]).read(rec) is None, m["name"]
    rec.trace = None
    for m in mine:
        assert metric_reader(m["name"]).read(rec) is None, m["name"]


def test_span_time_counts_nested_spans_once_and_leaves_out_a_child():
    from portbench.harness.runner import Record
    from portbench.harness.spec import load_module
    from portbench.harness.trace import Trace

    prog = load_module("metrics", "_program")
    rec = Record("docs", "cpu")
    rec.call_s = [0.1, 0.1]
    host = [("dstt.front.tokens", 100.0, 1100.0), ("dstt.front.sha1", 200.0, 900.0),
            ("dstt.glue.select", 2000.0, 2500.0), ("dstt.glue.select", 2100.0, 2200.0),
            ("dstt.front.tokens", -50.0, 50.0)]  # clipped to the window's start
    rec.trace = Trace(0.0, 1e4, [], host)
    assert prog.ms_per_batch(rec, prog.named("dstt.glue.select")) == pytest.approx(0.25)
    assert prog.ms_per_batch(rec, prog.named("dstt.front.tokens"),
                             minus=prog.named("dstt.front.sha1")) == pytest.approx(0.175)
