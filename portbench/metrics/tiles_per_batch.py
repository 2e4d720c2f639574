"""tiles_per_batch: scan steps a call (the program's ``bbit.tiles`` counter:
one tile of stored rows scored and folded into the running top-k, one
kernel 5 launch on a card) over the traced window. Reads
``tiles_per_batch.<part>``."""

from portbench.harness.spec import load_module


def read(rec):
    tiles = load_module("metrics", "_program").counter(rec, "bbit.tiles")
    if tiles is None or not rec.calls:
        return None
    return tiles / rec.calls
