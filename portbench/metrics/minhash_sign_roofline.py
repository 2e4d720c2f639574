"""minhash_sign_roofline: kernel 1's share of its roofline over the traced
window (``portbench/roofline/minhash_sign.py``)."""

from portbench.harness.roofline import share


def read(rec):
    return share(rec, "minhash_sign")
