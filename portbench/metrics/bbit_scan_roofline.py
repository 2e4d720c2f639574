"""bbit_scan_roofline: the b-bit scan's share of its roofline over the
traced window: one call's work against the device time of kernel 5 (and
of the names kept for a fused b-bit scan), ``portbench/roofline/bbit_scan.py``."""

from portbench.harness.roofline import share


def read(rec):
    return share(rec, "bbit_scan")
