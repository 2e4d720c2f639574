"""topk_scan_roofline: kernel 2's share of its roofline over the traced
window (``portbench/roofline/topk_scan.py``)."""

from portbench.harness.roofline import share


def read(rec):
    return share(rec, "topk_scan")
