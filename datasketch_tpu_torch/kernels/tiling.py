"""Grid of the equal-slot kernels that walk db tiles (kernels 2 and 4).

Both kernels (``csrc/lsh_scan.cu``, ``csrc/score.cu``) run blocks of
``QB`` queries over splits of the db axis, each split a whole number of
``RB``-row tiles. :func:`grid` sizes the splits from the card's resident
blocks, which :func:`blocks_per_sm` asks of the card once per shape.
"""

from __future__ import annotations

import ctypes

import torch

from datasketch_tpu_torch.kernels import build

__all__ = ["QB", "RB", "MAX_SPLITS", "MIN_TILES", "grid", "blocks_per_sm"]

QB, RB = 32, 64  # query rows per block, db rows per tile (csrc/common.cuh)
MAX_SPLITS = 64
MIN_TILES = 8  # least tiles per split


def grid(nq: int, n: int, sms: int, blocks_per_sm: int) -> tuple:
    """(splits, rows per split) of the db axis for ``nq`` queries over ``n``
    rows on ``sms`` SMs that each hold ``blocks_per_sm`` blocks.

    The query blocks times the splits fill the card's resident slots in
    one whole wave (a block that starts in a second wave runs while most
    of the card idles), within at most ``MAX_SPLITS`` splits of at least
    ``MIN_TILES`` tiles each. Where the query blocks alone fill a wave,
    one split. A split is a whole number of tiles, and the splits cover
    the rows exactly once, none of them empty.
    """
    q_blocks = -(-nq // QB)
    most = max(1, min(MAX_SPLITS, n // (MIN_TILES * RB)))
    want = max(1, min(sms * blocks_per_sm // q_blocks, most))
    n = max(n, 1)
    rows = -(-(-(-n // want)) // RB) * RB
    return -(-n // rows), rows


_blocks_per_sm_cache: dict = {}


def blocks_per_sm(lib, entry: str, dev, *shape: int) -> int:
    """Resident blocks per SM of the kernel behind ``entry`` (a
    ``ds_*_blocks_per_sm`` C function taking ``shape`` and an out pointer),
    asked of the card once per (device, entry, shape)."""
    key = (dev.index, entry) + shape
    if key not in _blocks_per_sm_cache:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            build.check(getattr(lib, entry)(*shape, ctypes.addressof(out)), entry)
        if out.value < 1:
            raise build.KernelError("%s: the kernel does not fit on an SM at %s" % (entry, shape))
        _blocks_per_sm_cache[key] = out.value
    return _blocks_per_sm_cache[key]
