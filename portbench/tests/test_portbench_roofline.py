"""The roofline counts against hand-worked shapes, and the trace reduction
on a made-up window."""

import pytest

from portbench.harness import roofline
from portbench.harness.runner import Record
from portbench.harness.spec import load_module, metric_reader
from portbench.harness.trace import Trace, gaps, matches, port_kernel_names, union_us

RATE = 132 * 1.98e9  # SMs x clock
LSH = {"rows": 1 << 20, "num_perm": 128}
TOPK = {"op": "top_k", "method": "scan", "k": 10}
SIGN = {"num_perm": 128, "corpus": {"tokens_per_doc": 200}}
SHA1 = {"op": "bulk_signatures", "tokens": "bytes"}


def test_kernel2_bound_is_the_compares_over_the_int32_pipe():
    mod = load_module("roofline", "topk_scan")
    c = mod.counts(LSH, TOPK, 1024)
    assert c["alu"] == 1024 * (1 << 20) * 128
    sec = roofline.bound_s(c, roofline.peaks())
    assert sec == pytest.approx(1024 * (1 << 20) * 128 / (64 * RATE))
    assert round(sec * 1e3, 3) == 8.217
    # the table read once is far from binding
    assert c["bytes"] / 3.35e12 < sec / 50


def test_kernel1_bound_is_ten_ops_over_the_issue_lanes():
    mod = load_module("roofline", "minhash_sign")
    c = mod.counts(SIGN, SHA1, 8192)
    pairs = 8192 * 200 * 128
    assert (c["alu"], c["imad"], c["either"]) == (4 * pairs, 3 * pairs, 3 * pairs)
    sec = roofline.bound_s(c, roofline.peaks())
    assert sec == pytest.approx(10 * pairs / (128 * RATE))
    assert round(sec * 1e3, 4) == 0.0627
    # the kernel measured at 0.1190 ms reads 52.7 %; one a tenth faster stays
    # under 100 % (the smoke's 8 ops at 64 lanes read 84 % and 93 %)
    assert 100 * sec / 0.1190e-3 == pytest.approx(52.7, abs=0.1)
    assert 100 * sec / (0.9 * 0.1190e-3) < 60


def test_a_count_reads_the_cell_and_is_silent_where_it_has_no_work():
    scan, sign = load_module("roofline", "topk_scan"), load_module("roofline", "minhash_sign")
    assert scan.counts(LSH, TOPK, 512)["alu"] == 512 * (1 << 20) * 128
    assert scan.counts(dict(LSH, rows=1 << 24), TOPK, 1024)["alu"] == 1024 * (1 << 24) * 128
    for traffic in (dict(TOPK, method="bands"), dict(TOPK, k=256),
                    {"op": "query_batch", "method": "scan"}):
        assert scan.counts(LSH, traffic, 1024) is None
    assert sign.counts(SIGN, dict(SHA1, tokens="ids"), 8192) is None
    assert sign.counts(SIGN, TOPK, 8192) is None


def _record(unit="queries", calls=4, config=LSH, traffic=TOPK):
    rec = Record(unit, "cuda", config, traffic)
    rec.call_s = [0.01] * calls
    rec.call_units = [1024] * calls
    rec.units = 1024 * calls
    rec.window_s = 0.04
    device = [
        ("void (anonymous namespace)::topk_scan_kernel<10>(int const*)", "kernel", 0, 8000),
        ("(anonymous namespace)::topk_merge_kernel(int const*)", "kernel", 8000, 8500),
        ("void at::native::vectorized_elementwise_kernel<4>", "kernel", 12000, 12500),
        ("Memcpy HtoD (Pageable -> Device)", "h2d", 30000, 30500),
    ]
    host = [("portbench.call", 0, 40000), ("aten::nonzero", 9600, 20000)]
    rec.trace = Trace(0, 40000, device, host)
    return rec


def test_trace_reduction_on_a_made_up_window():
    rec = _record()
    assert rec.trace.window_s == 0.04
    assert rec.trace.busy_s == pytest.approx(0.0095)
    idle = dict(rec.trace.idle_by_host_op())
    # gaps 8.5-12 ms (under aten::nonzero), 12.5-30 and 30.5-40 ms (the call's span)
    assert idle["aten::nonzero"] == pytest.approx(0.0035)
    assert idle["portbench.call"] == pytest.approx(0.0175 + 0.0095)
    assert metric_reader("idle_share.scan").read(rec) == pytest.approx(76.25)
    assert metric_reader("launches_per_batch.scan").read(rec) == 0.75
    glue = metric_reader("glue_ms_per_batch.scan").read(rec)
    assert glue == pytest.approx(0.5 / 4)
    # four calls of 1,024 queries, against the kernel's 8.5 ms
    share = metric_reader("topk_scan_roofline").read(rec)
    assert share == pytest.approx(100 * 4 * 1024 * (1 << 20) * 128 / (64 * RATE) / 0.0085)
    assert metric_reader("minhash_sign_roofline").read(rec) is None
    assert metric_reader("docs_per_s").read(rec) is None
    rec.trace = None
    assert metric_reader("idle_share.bands").read(rec) is None
    assert metric_reader("topk_scan_roofline").read(rec) is None


def test_sketch_readers():
    rec = _record(unit="docs", config=SIGN, traffic=SHA1)
    assert metric_reader("h2d_ms_per_batch.sketch").read(rec) == pytest.approx(0.125)
    assert metric_reader("qps.scan").read(rec) is None
    assert metric_reader("docs_per_s").read(rec) == pytest.approx(4096 / 0.04)
    # no minhash_sign_kernel in the window: no device time, no share
    assert metric_reader("minhash_sign_roofline").read(rec) is None


def test_interval_helpers():
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert gaps([(1, 2), (1.5, 4), (6, 7)], 0, 10) == [(0, 1), (4, 6), (7, 10)]
    names = port_kernel_names()
    assert {"topk_scan_kernel", "minhash_sign_kernel", "rerank_kernel"} <= set(names)
    assert matches("void (anonymous namespace)::rerank_kernel(int const*)", names)
    assert not matches("void at::native::index_elementwise_kernel<128, 4>", names)
