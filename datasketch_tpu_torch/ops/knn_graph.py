"""Device-built ANN graph: exact kNN adjacency + diversity pruning + nested
routing levels, queried by :mod:`datasketch_tpu_torch.ops.hnsw_ops`.

Port of ``datasketch_tpu/ops/knn_graph.py``. Each node's k nearest rows
(self excluded, ties to the lowest id, as ``lax.top_k(-d, k)`` orders
them) come from one of three routes, picked by metric and dtype:

- ``"scan"``: ``minhash_jaccard`` on integer points (int32 bits of uint32
  signatures) with k + 1 <= 128 and P <= 256. Kernel 2
  (:func:`~datasketch_tpu_torch.kernels.lsh_scan.topk_scan`, cutoff 0)
  returns each row's k + 1 best in (equal-slot count desc, id asc) order;
  the distance (:func:`~datasketch_tpu_torch.ops.hnsw_ops.distance_fn`)
  falls strictly as the count c rises (P <= 2**24), so that is JAX's order. The row's own id is dropped, or the last
  column where it is absent (more than k duplicates of the row before it).
- ``"score"``: the same points with a larger k or P <= 600. Kernel 4
  (:func:`~datasketch_tpu_torch.kernels.score.score_matrix`) scores row
  chunks against every row; the counts come back exactly as
  ``round(score * P)`` and the top k are taken by (count desc, id asc).
- ``"tiles"``: every other metric and dtype (``l2``, ``cosine``, float
  points under ``minhash_jaccard``, callables): plain torch distance
  tiles and a running top-k over (distance asc, id asc). The JAX package
  computes these in XLA too.

Each route's top-k runs over unique int64 keys (value and id in one
word), so ``torch.topk`` never meets a tie. Every row is computed alone,
so results do not depend on the row chunk or on ``tile``; chunks are
sized from a per-device memory budget (``tile`` is the least chunk).
"""

from __future__ import annotations

import numpy as np
import torch

from datasketch_tpu_torch.device import resolve_device
from datasketch_tpu_torch.kernels import lsh_scan, score
from datasketch_tpu_torch.ops.hnsw_ops import BIG, DeviceGraph, as_points, distance_fn

__all__ = ["knn_adjacency", "knn_route", "build_nsw_graph", "prune_candidates"]

_SCAN_MAX_P = 256  # kernel 2's block at k = 128 fits an SM's shared memory
_SCORE_MAX_P = 600  # kernel 4's; and round(score * P) is exact up to here
_ID_BITS = 32
_ID_MASK = (1 << _ID_BITS) - 1


def _chunk(device, per_row: int, least: int = 1) -> int:
    """Rows per step so that one step's broadcast tile holds about 2**22
    elements on the CPU, 2**28 on a card."""
    budget = 1 << (22 if device.type == "cpu" else 28)
    return max(least, budget // max(1, per_row))


def _on_device(points, device) -> torch.Tensor:
    """A tensor stays on its device; an array goes to ``device`` (default
    ``"cuda"``); either in the JAX package's dtypes."""
    if not isinstance(points, torch.Tensor):
        return as_points(points, resolve_device("cuda" if device is None else device))
    return as_points(points, points.device)


def knn_route(points: torch.Tensor, k: int, metric) -> str:
    """``"scan"``, ``"score"`` or ``"tiles"`` (see the module docstring)."""
    if metric == "minhash_jaccard" and points.dtype == torch.int32:
        p = points.shape[1]
        if k + 1 <= lsh_scan.MAX_K and p <= _SCAN_MAX_P:
            return "scan"
        if p <= _SCORE_MAX_P:
            return "score"
    return "tiles"


def _ordered_bits(d: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 whose signed order is the floats' order."""
    b = d.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _knn_rows_tiles(points, rows, k: int, dist, tile: int):
    """kNN of ``points[rows]`` by distance tiles: int32[R, k]."""
    n, width = points.shape
    dev = points.device
    r_step = _chunk(dev, min(n, 4096) * width, tile)
    out = []
    for r0 in range(0, rows.shape[0], r_step):
        rid = rows[r0: r0 + r_step]
        q = points[rid]
        c_step = _chunk(dev, q.shape[0] * width, 1)
        best = None
        for c0 in range(0, n, c_step):
            c1 = min(n, c0 + c_step)
            d = dist(q, points[None, c0:c1, :])
            cols = torch.arange(c0, c1, device=dev)
            d = torch.where(cols[None, :] == rid[:, None], BIG, d)
            key = (_ordered_bits(d) << _ID_BITS) | cols[None, :]
            if best is not None:
                key = torch.cat([best, key], dim=1)
            best = torch.topk(key, min(k, key.shape[1]), dim=1, largest=False).values
        out.append((best & _ID_MASK).to(torch.int32))
    return torch.cat(out)


def _knn_rows_scan(points, rows, k: int, tile: int):
    """kNN of ``points[rows]`` through kernel 2: int32[R, k]."""
    n = points.shape[0]
    step = _chunk(points.device, 1 << 16, tile)  # the CPU twin's [rows, 4096] tiles
    out = []
    for r0 in range(0, rows.shape[0], step):
        rid = rows[r0: r0 + step]
        ids, _, _ = lsh_scan.topk_scan(points, points[rid], k + 1, n, None, 0.0)
        keep = ids != rid[:, None]
        keep[:, -1] &= ~keep.all(dim=1)  # own id absent: drop the last column
        out.append(ids[keep].view(-1, k))
    return torch.cat(out)


def _knn_rows_score(points, rows, k: int, tile: int):
    """kNN of ``points[rows]`` through kernel 4: int32[R, k]."""
    n, p = points.shape
    dev = points.device
    step = _chunk(dev, n * 4, tile)
    cols = torch.arange(n, device=dev)
    out = []
    for r0 in range(0, rows.shape[0], step):
        rid = rows[r0: r0 + step]
        counts = torch.round(score.score_matrix(points[rid], points).double() * p).long()
        counts = torch.where(cols[None, :] == rid[:, None], -1, counts)
        key = ((counts + 1) << _ID_BITS) | (_ID_MASK - cols)[None, :]
        best = torch.topk(key, k, dim=1).values
        out.append((_ID_MASK - (best & _ID_MASK)).to(torch.int32))
    return torch.cat(out)


def knn_adjacency(points, k: int = 16, metric="l2", tile: int = 256, device=None,
                  rows=None, _route=None) -> torch.Tensor:
    """Exact kNN graph adjacency int32[N, k] (directed, self excluded).

    Args:
        points: [N, D] array or tensor; a tensor stays on its device,
            an array goes to ``device`` (default ``"cuda"``).
        rows: optional row ids: only their kNN rows, int32[len(rows), k].
        _route: forces ``"scan"``, ``"score"`` or ``"tiles"`` in place of
            :func:`knn_route`'s pick, to hold the routes against each other.
    """
    points = _on_device(points, device)
    n = points.shape[0]
    rows = (torch.arange(n, device=points.device) if rows is None
            else torch.as_tensor(rows, device=points.device).long())
    route = knn_route(points, k, metric) if _route is None else _route
    if route == "scan":
        return _knn_rows_scan(points, rows, k, tile)
    if route == "score":
        return _knn_rows_score(points, rows, k, tile)
    return _knn_rows_tiles(points, rows, k, distance_fn(metric), tile)


def _pair_dists(dist, cpts, device):
    """``dist(cpts, cpts[:, None])`` -> [R, C, C] (entry [r, i, j] is the
    distance from candidate i, as the query, to candidate j), in row
    chunks of the device's budget."""
    r, c, width = cpts.shape
    step = _chunk(device, c * c * width)
    return torch.cat([dist(cpts[i: i + step], cpts[i: i + step, None, :, :])
                      for i in range(0, r, step)])


def _keep_diverse(cids, d_node, cc, m: int, finite: bool):
    """The diversity rule over distance-sorted candidates: keep c_j when
    ``d(node, c_j) <= min d(c_j, u)`` over the kept u, at most ``m``;
    kept ids to the front in candidate order, -1 padded to ``m``."""
    r, c = cids.shape
    kept = torch.zeros((r, c), dtype=torch.bool, device=cids.device)
    count = torch.zeros(r, dtype=torch.int32, device=cids.device)
    for j in range(c):
        dj = torch.where(kept, cc[:, j, :], BIG).amin(dim=-1)
        ok = (d_node[:, j] <= dj) & (count < m)
        if finite:
            ok &= d_node[:, j] < BIG
        kept[:, j] = ok
        count += ok.to(torch.int32)
    order = torch.sort((~kept).to(torch.uint8), dim=1, stable=True).indices  # kept first
    sel = cids.gather(1, order)[:, :m]
    selk = kept.gather(1, order)[:, :m]
    out = torch.where(selk, sel, -1)
    if out.shape[1] < m:  # fewer candidates than m: pad
        out = torch.cat([out, out.new_full((r, m - out.shape[1]), -1)], dim=1)
    return out


def _prune_diverse(points, cand_ids, m: int, tile: int, dist):
    """hnswlib-style heuristic pruning, vectorized over nodes.

    From each node's distance-sorted candidates keep c only if
    ``d(node, c) <= min_u d(c, u)`` over already-kept u -- the diversity
    rule that makes graphs navigable. Tie-tolerant (<=, not hnswlib's
    strict <): metrics with pervasive ties degrade to the kNN graph
    instead of pruning everything. Returns int32[N, m], -1 padded.
    """
    n, kc = cand_ids.shape
    dev = points.device
    step = _chunk(dev, kc * kc * 4, tile)
    out = []
    for r0 in range(0, n, step):
        cids = cand_ids[r0: r0 + step]
        cpts = points[cids.long()]  # [R, kc, D]
        d_node = dist(points[r0: r0 + step], cpts)  # ascending already
        cc = _pair_dists(dist, cpts, dev)
        out.append(_keep_diverse(cids, d_node, cc, m, finite=False))
    return torch.cat(out)


def prune_candidates(node_pts, cand_ids, all_pts, m: int, dist, tile: int = 128):
    """Diversity-prune candidates whose points live in a SEPARATE gather
    tensor -- the incremental-insert twin of :func:`_prune_diverse`.

    Serves both halves of ``TorchHNSW`` appends: forward edges for new
    nodes (``node_pts`` = the new points, ``cand_ids`` = frozen-graph beam
    results) and re-pruning overflowed rows (``node_pts`` = the touched
    nodes, ``cand_ids`` = old neighbors + newcomers). Candidates need not
    arrive distance-sorted (they are sorted here, stably) and ``-1`` ids
    are ignored.

    Args:
        node_pts: [R, D] the rows being (re)linked.
        cand_ids: int32[R, C] candidate ids into ``all_pts``, -1 invalid.
        all_pts: [N, D] gather source.
        m: max edges kept per row.
    Returns:
        int32[R, m] kept ids (diverse, distance-ascending), -1 padded.
    """
    r, c = cand_ids.shape
    dev = all_pts.device
    step = _chunk(dev, c * c * 4, tile)
    out = []
    for r0 in range(0, r, step):
        cids = cand_ids[r0: r0 + step]
        valid = cids >= 0
        cpts = all_pts[torch.where(valid, cids, 0).long()]  # [R, C, D]
        d_node = torch.where(valid, dist(node_pts[r0: r0 + step], cpts), BIG)
        order = torch.sort(d_node, dim=1, stable=True).indices
        cids = cids.gather(1, order)
        d_node = d_node.gather(1, order)
        cpts = cpts.gather(1, order[:, :, None].expand_as(cpts))
        cc = _pair_dists(dist, cpts, dev)
        out.append(_keep_diverse(cids, d_node, cc, m, finite=True))
    if not out:
        return torch.empty((0, m), dtype=torch.int32, device=dev)
    return torch.cat(out)


def _symmetrize(adj: np.ndarray, deg_cap: int) -> np.ndarray:
    """Base layer: forward edges plus reverse edges (src appended to dst's
    row unless dst already points back at src, in src order), capped at
    ``deg_cap`` per node."""
    n = adj.shape[0]
    full = np.full((n, deg_cap), -1, dtype=np.int32)
    full[:, : adj.shape[1]] = adj
    fill = (adj >= 0).sum(axis=1).astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int32), adj.shape[1])
    dst = adj.ravel()
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    # drop pairs where dst already points back at src
    already = (adj[dst] == src[:, None]).any(axis=1)
    add_reverse(full, fill, src[~already], dst[~already], deg_cap)
    return full


def add_reverse(full: np.ndarray, fill: np.ndarray, src: np.ndarray, dst: np.ndarray,
                deg_cap: int):
    """Write each reverse edge ``dst -> src`` into ``full`` in place, at
    slot ``fill[dst]`` plus its rank among ``dst``'s edges (in the given
    order), where that slot is under ``deg_cap``. Returns the edges
    grouped by ``dst`` (a stable sort) and the mask of those written."""
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    first = np.searchsorted(dst, dst, side="left")  # rank = arange - first occurrence
    slot = fill[dst] + np.arange(dst.shape[0]) - first
    fits = slot < deg_cap
    full[dst[fits], slot[fits]] = src[fits]
    return src, dst, fits


def build_nsw_graph(points, keys=None, m: int = 16, metric="l2", tile: int = 256,
                    level_ratio: int = 8, seed: int = 7, device=None) -> DeviceGraph:
    """Device-built hierarchical NSW index queryable by
    :func:`datasketch_tpu_torch.ops.hnsw_ops.batch_query`.

    Base layer: exact 3m-NN candidates diversity-pruned to m edges, then
    augmented with reverse edges (union, capped at 2m per node). Upper
    levels (HNSW's long-range routing): nested random subsets shrinking
    by ``level_ratio`` (one ``np.random.RandomState(seed)`` permutation),
    each with its own pruned kNN adjacency among subset members.

    Args:
        points: [N, D] array or tensor; a tensor stays on its device, an
            array goes to ``device`` (default ``"cuda"``).
    """
    points = _on_device(points, device)
    dev = points.device
    n = points.shape[0]
    if n == 0:
        raise ValueError("cannot build a graph over zero points")
    if n == 1:
        # degenerate but legal (first add() before any other): a single
        # node with no edges
        return DeviceGraph(
            points=points,
            adj0=torch.full((1, 2 * m), -1, dtype=torch.int32, device=dev),
            upper_nodes=[],
            upper_adj=[],
            entry=0,
            keys=list(keys) if keys is not None else [0],
            deleted=torch.zeros(1, dtype=torch.bool, device=dev),
        )
    dist = distance_fn(metric)
    # 3m nearest candidates, then diversity-prune to m navigable edges
    cands = knn_adjacency(points, k=min(3 * m, n - 1), metric=metric, tile=tile)
    adj = _prune_diverse(points, cands, m, tile, dist).cpu().numpy()
    full = _symmetrize(adj, 2 * m)

    # Upper levels: NESTED random subsets (one shared permutation). Nesting
    # keeps the invariant the descent relies on: every level-l node exists
    # in all lower levels, so per-query entries resolve by searchsorted.
    perm = np.random.RandomState(seed).permutation(n)
    upper = []  # built bottom-up, reversed at the end (top first)
    size = n // level_ratio
    while size > max(2 * m, 8):
        subset = torch.from_numpy(np.sort(perm[:size]).astype(np.int64)).to(dev)
        sub_pts = points[subset]
        sub_cands = knn_adjacency(sub_pts, k=min(3 * m, size - 1), metric=metric, tile=tile)
        sub_adj = _prune_diverse(sub_pts, sub_cands, min(m, size - 1), tile, dist)
        upper.append((subset, sub_adj))
        size //= level_ratio

    # the entry belongs to the top (smallest) level
    entry = int(upper[-1][0][0]) if upper else 0
    upper = list(reversed(upper))  # top (smallest) level first
    return DeviceGraph(
        points=points,
        adj0=torch.from_numpy(full).to(dev),
        upper_nodes=[u for u, _ in upper],
        upper_adj=[a for _, a in upper],
        entry=entry,
        keys=list(keys) if keys is not None else list(range(n)),
        deleted=torch.zeros(n, dtype=torch.bool, device=dev),
    )
