"""b-bit MinHash on the card: packed storage and the exact top-k scan.

Port of ``datasketch_tpu/ops/bbit_ops.py``. Signatures keep the b lowest
bits of each value in s-bit slots (s on the reference's ladder, 1, 2, 4,
8, 16 or 32), packed LSB-first into uint32 words held as int32 bit
patterns: 32 slots per word at b = 1, so a corpus takes 32/s times fewer
bytes than full signatures. Slot equality of a query and a stored row is
counted by kernel 5 (:mod:`datasketch_tpu_torch.kernels.bbit`). Packing
runs on the tensor's own device in int64 (torch on the CPU has no
``uint32`` shift or sum), masked back to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from datasketch_tpu_torch.device import u32_to_i32
from datasketch_tpu_torch.kernels import bbit, lsh_scan
from datasketch_tpu_torch.utils.profiling import count, span

__all__ = [
    "slot_size",
    "words_per_sig",
    "pack_bbit",
    "pack_bbit_host",
    "match_counts",
    "bbit_topk_scan",
    "estimator_constants",
]

_SCAN_ELEMS = 1 << 26  # counts per scan step: Q * tile
_MIN_TILE = 4096

_lsb_mask = bbit.lsb_mask


def slot_size(b: int) -> int:
    """Storage bits per hash value -- the reference's exact slot ladder
    (``b_bit_minhash.py:147-160``; note b=0 lands on 4 there too)."""
    if b == 1:
        return 1
    if b == 2:
        return 2
    for limit in (4, 8, 16, 32):
        if b <= limit:
            return limit
    raise ValueError("b must be an integer in [0, 32]")


def words_per_sig(num_perm: int, b: int) -> int:
    """uint32 words holding one packed ``num_perm``-slot signature."""
    spw = 32 // slot_size(b)
    return -(-num_perm // spw)


def pack_bbit(sigs: torch.Tensor, b: int) -> torch.Tensor:
    """int32[N, P] signatures (uint32 bits) -> int32[N, W] packed b-bit
    slots, on ``sigs``' device.

    Slots are LSB-first within each word (slot j of a word occupies bits
    ``[j*s, (j+1)*s)``); padding slots past P are zero. Keeps the low b
    bits of each value, as ``bBitMinHash`` does. The slots occupy disjoint
    bits, so their shifted sum is their OR.
    """
    s = slot_size(b)
    spw = 32 // s
    n, p = sigs.shape
    w = -(-p // spw)
    v = sigs.to(torch.int64) & ((1 << b) - 1)
    if w * spw != p:
        v = torch.nn.functional.pad(v, (0, w * spw - p))
    shifts = torch.arange(spw, dtype=torch.int64, device=sigs.device) * s
    return u32_to_i32((v.reshape(n, w, spw) << shifts).sum(dim=2))


def pack_bbit_host(sigs: np.ndarray, b: int) -> np.ndarray:
    """NumPy twin of :func:`pack_bbit` (bit-identical layout), uint32."""
    s = slot_size(b)
    spw = 32 // s
    sigs = np.asarray(sigs, dtype=np.uint32)
    n, p = sigs.shape
    w = -(-p // spw)
    v = sigs & np.uint32((1 << b) - 1)
    pad = w * spw - p
    if pad:
        v = np.pad(v, ((0, 0), (0, pad)))
    v = v.reshape(n, w, spw).astype(np.uint64)
    shifts = (np.arange(spw, dtype=np.uint64) * np.uint64(s))[None, None, :]
    return (v << shifts).sum(axis=2).astype(np.uint32)


def _pad_slots(w: int, b: int, num_perm: int) -> int:
    return w * (32 // slot_size(b)) - num_perm


def match_counts(q_packed: torch.Tensor, db_packed: torch.Tensor, b: int,
                 num_perm: int) -> torch.Tensor:
    """Equal-slot counts int32[Q, N] of packed queries and rows: the
    ``intersection`` of ``bBitMinHash.jaccard``, all pairs (kernel 5 on a
    CUDA tensor), padding slots subtracted."""
    cnt = bbit.bbit_counts(q_packed, db_packed, slot_size(b))
    return cnt - _pad_slots(q_packed.shape[1], b, num_perm)


def _scan_tile(nq: int) -> int:
    """Rows scored per scan step: ``_SCAN_ELEMS`` counts per step (256 MiB
    of int32 counts, 512 MiB of keys), at least ``_MIN_TILE`` rows."""
    return max(_MIN_TILE, _SCAN_ELEMS // max(1, nq))


def bbit_topk_scan(db_packed: torch.Tensor, q_packed: torch.Tensor, k: int, b: int,
                   num_perm: int, n_valid=None, alive=None, tile=None,
                   counts_fn=bbit.bbit_counts):
    """Exact top-k over packed b-bit signatures: no banding.

    Kernel 5 scores the queries against one tile of stored rows at a time
    under a running top-k in (count desc, id asc) order, the order of the
    JAX package's ``lax.top_k`` carry. Each candidate is one hit key of
    its count and id (``lsh_scan.hit_keys``), and ``lsh_scan.fold_topk``
    carries them. Unlike the JAX scan, k is never cut to the tile size.
    Each tile counts one ``bbit.tiles`` and folds under the
    ``dstt.glue.fold_topk`` span.

    Args:
        db_packed: int32[N, W] packed rows; q_packed: int32[Q, W] queries.
        k: results per query.
        b: bits per slot; num_perm: real slots per signature (excludes
            the padding slots).
        n_valid: rows >= n_valid are ignored (None: every row).
        alive: optional bool[N] tombstone mask (False = removed).
        tile: rows scored per step (None: sized to the batch); answers do
            not depend on it.
        counts_fn: the scorer, ``bbit_counts(q, db_tile, s)`` (kernel 5)
            or its plain twin.

    Returns:
        (ids int32[Q, k], counts int32[Q, k]): exact equal-slot counts
        (the estimator's correction is affine, so their order is final);
        empty slots have id -1 and count -1.
    """
    if k <= 0:
        raise ValueError("k must be positive")
    n = db_packed.shape[0]
    nq = q_packed.shape[0]
    dev = q_packed.device
    nv = n if n_valid is None else min(n, int(n_valid))
    tile = _scan_tile(nq) if tile is None else int(tile)
    s = slot_size(b)
    best = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    for r0 in range(0, nv, tile):
        r1 = min(nv, r0 + tile)
        cnt = counts_fn(q_packed, db_packed[r0:r1], s)
        count("bbit.tiles")
        with span("dstt.glue.fold_topk"):
            key = lsh_scan.hit_keys(cnt, torch.arange(r0, r1, dtype=torch.int64, device=dev))
            if alive is not None:
                key = torch.where(alive[r0:r1], key, -1)
            best = lsh_scan.fold_topk(best, key)
    pad = _pad_slots(q_packed.shape[1], b, num_perm)
    return lsh_scan.hit_ids(best), lsh_scan.hit_counts(best, pad)


def estimator_constants(b: int, r1: float = 0.0, r2: float = 0.0):
    """(C1, C2) of the Li & Koenig unbiased estimator
    ``jaccard = (raw - C1) / (1 - C2)`` -- the host formulas of
    ``bBitMinHash._calc_a`` / ``_calc_c``."""

    def calc_a(r, bb):
        if r == 0.0:
            return 1.0 / (1 << bb)
        return r * (1 - r) ** (2**bb - 1) / (1 - (1 - r) ** (2 * bb))

    a1 = calc_a(r1, b)
    a2 = calc_a(r2, b)
    if r1 == 0.0 and r2 == 0.0:
        return a1, a2
    div = 1 / (r1 + r2)
    return (a1 * r2 + a2 * r1) * div, (a1 * r1 + a2 * r2) * div
