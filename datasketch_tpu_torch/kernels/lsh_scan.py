"""Kernel 2 wrapper: fused exact-scan top-k with hit counting (k <= 128).

CUDA source: ``datasketch_tpu_torch/csrc/lsh_scan.cu`` (replaces
``datasketch_tpu/ops/pallas_kernels.py::_topk_scan_kernel`` in its plain
and alive-mask modes, :func:`topk_scan`, and in its sizes (containment)
mode, :func:`containment_topk`; the sizes mode's emit variant, which keeps
no top-k and writes every hit, :func:`containment_hits`). CPU tensors take
the plain PyTorch version; CUDA tensors launch the kernel or raise.
``launches`` counts the plain and mask modes, ``launches_sizes`` the sizes
mode's top-k, ``launches_hits`` its emit variant.

:func:`running_topk` is the tiled running top-k that
``ops.lsh_ops.topk_scan`` runs over kernel 4 for k > 128 (the
``dstt.glue.running_topk`` span); the plain versions run its body over
:func:`~datasketch_tpu_torch.kernels.score.score_matrix_plain` inside the
kernel's own span.
"""

from __future__ import annotations

import numpy as np
import torch

from datasketch_tpu_torch.device import inv_width
from datasketch_tpu_torch.kernels import build, tiling
from datasketch_tpu_torch.kernels.score import score_matrix_plain
from datasketch_tpu_torch.utils.profiling import span

__all__ = [
    "topk_scan",
    "topk_scan_plain",
    "containment_topk",
    "containment_topk_plain",
    "containment_hits",
    "containment_hits_plain",
    "running_topk",
    "hit_keys",
    "hit_ids",
    "hit_scores",
    "hit_counts",
    "fold_topk",
    "min_hit_count",
    "MAX_K",
    "launches",
    "launches_sizes",
    "launches_hits",
]

launches = 0
launches_sizes = 0
launches_hits = 0

MAX_K = 128  # the kernel keeps at most this many entries per query
_PLAIN_TILE = 4096

# A hit of row r (< 2**31) with value v, a non-negative f32 (its bits) or a
# count, is the int64 key ``v << 31 | (2**31 - 1 - r)``; -1 is an empty slot.
# Non-negative f32 bit patterns order like the floats, so keys order like
# (v desc, r asc), and they are unique: ``torch.topk`` has no tie to break.
_ID_MASK = (1 << 31) - 1


def hit_keys(value_bits, rows):
    """Keys of ``value_bits`` (int32) and ``rows`` (int64), broadcast."""
    return (value_bits.to(torch.int64) << 31) | (_ID_MASK - rows)


def hit_ids(keys):
    """Row ids int32 of keys, -1 where empty."""
    return torch.where(keys >= 0, _ID_MASK - (keys & _ID_MASK), -1).to(torch.int32)


def hit_scores(keys):
    """f32 values of keys packed from f32 bits, -1.0 where empty."""
    return torch.where(keys >= 0, (keys >> 31).to(torch.int32).view(torch.float32), -1.0)


def hit_counts(keys, offset: int = 0):
    """int32 values less ``offset`` of keys packed from counts, -1 where empty."""
    return torch.where(keys >= 0, (keys >> 31) - offset, -1).to(torch.int32)


def fold_topk(best, keys):
    """The tile carry: the best ``best.shape[1]`` keys of a row after one
    more tile's ``keys``."""
    return torch.topk(torch.cat([best, keys], dim=1), best.shape[1], dim=1).values


def min_hit_count(cutoff: float, p: int) -> int:
    """Least count c whose f32 score ``f32(c) * f32(1/p)`` is >= f32(cutoff)
    (p + 1 if none): the exact integer form of the f32 ``score >= cutoff``."""
    scores = np.arange(p + 1, dtype=np.float32) * np.float32(inv_width(p))
    ok = np.nonzero(scores >= np.float32(cutoff))[0]
    return int(ok[0]) if ok.size else p + 1


def running_topk(q, db, k: int, n_valid: int, alive, cutoff: float,
                 score_fn, tile: int = _PLAIN_TILE):
    """Exact top-k over db tiles with a running carry, under the
    ``dstt.glue.running_topk`` span (arguments and result as
    :func:`_running_topk`'s)."""
    with span("dstt.glue.running_topk"):
        return _running_topk(q, db, k, n_valid, alive, cutoff, score_fn, tile)


def _running_topk(q, db, k: int, n_valid: int, alive, cutoff: float,
                  score_fn, tile: int = _PLAIN_TILE, sizes=None, q_sizes=None):
    """Exact top-k over db tiles with a running carry.

    ``score_fn(q, db_tile)`` gives f32[Q, t] Jaccard estimates. With
    ``sizes`` (int32[N], <= 0 marks padding rows) and ``q_sizes``
    (int32[Q]) the score is the containment estimate
    ``(j * (x + q)) / ((1 + j) * q)`` in f32, every operation between two
    tensors (a CUDA tensor divided by a Python scalar is multiplied by
    the reciprocal), and rows of size <= 0 are never hits. Per query, the
    top-k (id, score) among rows < ``n_valid`` that ``alive`` keeps and
    that score >= ``cutoff`` (f32 compare), in (score desc, id asc) order,
    empty slots (-1, -1.0), and the count of such rows. Every candidate is
    one hit key (:func:`hit_keys`).
    """
    n = db.shape[0]
    nq = q.shape[0]
    dev = q.device
    cut = float(np.float32(cutoff))
    if sizes is not None:
        qf = q_sizes.to(torch.float32).clamp_min(1.0)[:, None]
    best = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros(nq, dtype=torch.int64, device=dev)
    for r0 in range(0, min(n, n_valid), tile):
        r1 = min(n, r0 + tile)
        sc = score_fn(q, db[r0:r1])
        ids = torch.arange(r0, r1, device=dev)
        valid = ids < n_valid
        if alive is not None:
            valid &= alive[r0:r1]
        if sizes is not None:
            x = sizes[r0:r1]
            sc = (sc * (x.to(torch.float32)[None, :] + qf)) / ((1.0 + sc) * qf)
            valid &= x > 0
        hit = valid[None, :] & (sc >= cut)
        cnt += hit.sum(dim=1)
        best = fold_topk(best, torch.where(hit, hit_keys(sc.view(torch.int32), ids), -1))
    return hit_ids(best), hit_scores(best), cnt.to(torch.int32)


def topk_scan_plain(db, q, k: int, n_valid: int, alive, cutoff: float):
    """Plain PyTorch twin of the kernel (same arguments, same result)."""
    return _running_topk(q, db, k, n_valid, alive, cutoff, score_matrix_plain)


def containment_topk_plain(db, sizes, q, q_sizes, k: int, cutoff: float):
    """Plain PyTorch twin of the sizes mode (same arguments, same result)."""
    return _running_topk(q, db, k, db.shape[0], None, cutoff, score_matrix_plain,
                         sizes=sizes, q_sizes=q_sizes)


def containment_hits_plain(db, sizes, q, q_sizes, cutoff: float, cap: int,
                           tile: int = _PLAIN_TILE):
    """Plain PyTorch twin of the emit variant (same arguments, same
    result; a row past its capacity keeps its first ``cap`` hits in row
    order, one of the subsets the kernel may keep)."""
    n, nq, dev = db.shape[0], q.shape[0], q.device
    cut = float(np.float32(cutoff))
    qf = q_sizes.to(torch.float32).clamp_min(1.0)[:, None]
    keys = torch.full((nq, cap), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros(nq, dtype=torch.int64, device=dev)
    row_base = torch.arange(nq, device=dev)[:, None] * cap
    for r0 in range(0, n, tile):
        r1 = min(n, r0 + tile)
        j = score_matrix_plain(q, db[r0:r1])
        x = sizes[r0:r1]
        c = (j * (x.to(torch.float32)[None, :] + qf)) / ((1.0 + j) * qf)
        hit = (x > 0)[None, :] & (c >= cut)
        slot = cnt[:, None] + hit.cumsum(dim=1) - 1
        put = hit & (slot < cap)
        key = hit_keys(c.view(torch.int32), torch.arange(r0, r1, device=dev))
        keys.view(-1)[(row_base + slot)[put]] = key[put]
        cnt += hit.sum(dim=1)
    return keys, cnt.to(torch.int32)


def containment_hits(db, sizes, q, q_sizes, cutoff: float, cap: int):
    """Every hit of every query by estimated containment, and exact hit
    counts: the emit variant of kernel 2's sizes mode.

    The hit test and estimate are :func:`containment_topk`'s. A hit of
    stored row r at containment c is the key :func:`hit_keys` packs from
    ``bits(c)`` and r: keys order like (c desc, r asc) and are unique.

    Args:
        db: int32[N, P] stored signatures, N < 2**31; sizes: int32[N] set
            sizes, <= 0 marks a padding row (never a hit).
        q: int32[Q, P] queries; q_sizes: int32[Q] query set sizes.
        cutoff: only rows with c >= cutoff (f32 compare) are hits.
        cap: slots of each query's output row.

    Returns:
        keys int64[Q, cap], -1 = empty: a query with at most ``cap`` hits
        holds all of them, in no order; one with more holds ``cap`` of
        them. counts int32[Q]: the exact hits of each query.
    """
    with span("dstt.kernel.lsh_scan"):
        if cap < 1:
            raise ValueError("containment_hits: cap must be at least 1, got %d" % cap)
        if q.device.type == "cpu":
            return containment_hits_plain(db, sizes, q, q_sizes, cutoff, cap)
        build.require_cuda("containment_hits", db, sizes, q, q_sizes)
        _check_sigs("containment_hits", db, q)
        _check_sizes("containment_hits", db, sizes, q, q_sizes)
        n, p = db.shape
        if n > _ID_MASK:
            raise ValueError("containment_hits: rows are numbered below 2**31")
        nq, dev = q.shape[0], q.device
        keys = torch.full((nq, cap), -1, dtype=torch.int64, device=dev)
        cnt = torch.zeros(nq, dtype=torch.int32, device=dev)
        if nq == 0:
            return keys, cnt
        global launches_hits
        launches_hits += 1
        lib = build.library()
        splits, rows = tiling.grid(
            nq, n, build.num_sms(q),
            tiling.blocks_per_sm(lib, "ds_containment_hits_blocks_per_sm", dev, p))
        err = lib.ds_containment_hits(
            db.data_ptr(), q.data_ptr(), sizes.data_ptr(), q_sizes.data_ptr(), nq, n, p,
            float(np.float32(cutoff)), cap, splits, rows, keys.data_ptr(), cnt.data_ptr(),
            build.stream_ptr(q),
        )
        build.check(err, "ds_containment_hits")
        return keys, cnt


def topk_scan(db, q, k: int, n_valid: int, alive=None, cutoff: float = 0.0):
    """Top-k (ids, scores) and hit counts of every query over the table.

    Args:
        db: int32[N, P] stored signatures; q: int32[Q, P] queries.
        k: results per query, 1..128.
        n_valid: rows >= n_valid are ignored.
        alive: optional bool[N] tombstone mask (False = removed).
        cutoff: only rows scoring >= cutoff are hits (0.0 = every row).

    Returns:
        ids int32[Q, k] and scores f32[Q, k] in (score desc, id asc) order,
        empty slots (-1, -1.0); counts int32[Q] of hits.
    """
    with span("dstt.kernel.lsh_scan"):
        _check_k(k)
        if q.device.type == "cpu":
            return topk_scan_plain(db, q, k, n_valid, alive, cutoff)
        tensors = (db, q) if alive is None else (db, q, alive)
        build.require_cuda("topk_scan", *tensors)
        _check_sigs("topk_scan", db, q)
        if alive is not None and (alive.dtype != torch.bool or alive.shape[0] < db.shape[0]):
            raise ValueError("topk_scan: alive must be bool[N]")
        global launches
        launches += 1
        return _launch(db, q, k, n_valid, alive, min_hit_count(cutoff, db.shape[1]),
                       None, None, 0.0)


def containment_topk(db, sizes, q, q_sizes, k: int, cutoff: float):
    """Top-k by estimated containment, and hit counts, of every query.

    The sizes mode of kernel 2. The score of stored row x for query q is
    ``c = (j * (x + q)) / ((1 + j) * q)`` in f32, j the Jaccard estimate
    ``f32(count) * f32(1/P)``, x and q the exact set sizes (a query size
    below 1 counts as 1).

    Args:
        db: int32[N, P] stored signatures; sizes: int32[N] set sizes,
            <= 0 marks a padding row (never a hit).
        q: int32[Q, P] queries; q_sizes: int32[Q] query set sizes.
        k: results per query, 1..128.
        cutoff: only rows with c >= cutoff (f32 compare) are hits.

    Returns:
        ids int32[Q, k] and containment f32[Q, k] in (c desc, id asc)
        order, empty slots (-1, -1.0); counts int32[Q] of hits.
    """
    with span("dstt.kernel.lsh_scan"):
        _check_k(k)
        if q.device.type == "cpu":
            return containment_topk_plain(db, sizes, q, q_sizes, k, cutoff)
        build.require_cuda("containment_topk", db, sizes, q, q_sizes)
        _check_sigs("containment_topk", db, q)
        _check_sizes("containment_topk", db, sizes, q, q_sizes)
        global launches_sizes
        launches_sizes += 1
        return _launch(db, q, k, db.shape[0], None, 0, sizes, q_sizes,
                       float(np.float32(cutoff)))


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError("the scan kernel takes 1 <= k <= %d, got %d" % (MAX_K, k))


def _check_sigs(name: str, db, q) -> None:
    if (db.dim() != 2 or q.dim() != 2 or q.shape[1] != db.shape[1]
            or db.dtype != torch.int32 or q.dtype != torch.int32):
        raise ValueError("%s: want int32 db [N, P] and q [Q, P]" % name)


def _check_sizes(name: str, db, sizes, q, q_sizes) -> None:
    if sizes.dtype != torch.int32 or sizes.shape != (db.shape[0],):
        raise ValueError("%s: sizes must be int32[N]" % name)
    if q_sizes.dtype != torch.int32 or q_sizes.shape != (q.shape[0],):
        raise ValueError("%s: q_sizes must be int32[Q]" % name)


def _launch(db, q, k, n_valid, alive, min_count, sizes, q_sizes, cutoff):
    """Run the scan kernel and the split merge on CUDA tensors."""
    n, p = db.shape
    nq = q.shape[0]
    dev = q.device
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    sc = torch.full((nq, k), -1.0, dtype=torch.float32, device=dev)
    cnt = torch.zeros(nq, dtype=torch.int32, device=dev)
    if nq == 0:
        return ids, sc, cnt
    lib = build.library()
    splits, rows = tiling.grid(
        nq, n, build.num_sms(q),
        tiling.blocks_per_sm(lib, "ds_topk_scan_blocks_per_sm", dev, p, k))
    part_cnt = torch.empty((splits, nq, k), dtype=torch.int32, device=dev)
    part_id = torch.empty((splits, nq, k), dtype=torch.int32, device=dev)
    stream = build.stream_ptr(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.ds_topk_scan(
        db.data_ptr(), q.data_ptr(), ptr(alive), ptr(sizes), ptr(q_sizes),
        nq, n, p, int(n_valid), min_count, cutoff, k, splits, rows,
        part_cnt.data_ptr(), part_id.data_ptr(), cnt.data_ptr(), stream,
    )
    build.check(err, "ds_topk_scan")
    err = lib.ds_topk_merge(
        part_cnt.data_ptr(), part_id.data_ptr(), nq, splits, k, p,
        int(sizes is not None), ids.data_ptr(), sc.data_ptr(), stream,
    )
    build.check(err, "ds_topk_merge")
    return ids, sc, cnt
