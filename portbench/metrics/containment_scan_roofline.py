"""containment_scan_roofline: the containment scan's share of its roofline
over the traced window: one pass's work against the device time of every
kernel that computes containments on the path, reruns included
(``portbench/roofline/containment_scan.py``)."""

from portbench.harness.roofline import share


def read(rec):
    return share(rec, "containment_scan")
