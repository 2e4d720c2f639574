"""Batched HNSW query over padded adjacency tensors.

Port of ``datasketch_tpu/ops/hnsw_ops.py``. The graph is exported once to
tensors -- points ``[N, D]``, base-layer adjacency ``int32[N, deg]`` (-1
padded), and compact per-upper-level ``(nodes, adj)`` pairs -- and queries
run as a batch: greedy descent through the upper levels, then a
fixed-iteration masked beam search at the base layer where every
iteration expands each query's best unexpanded beam entry and evaluates
all its neighbors in one distance call.

The JAX package runs the descent as a ``lax.while_loop`` and the beam as a
``lax.scan``; here the descent is a Python loop that asks the device once
per step whether any query moved, and the beam is ``iters`` plain steps of
torch ops. Ties break as JAX breaks them: ``torch.argmin`` takes the first
minimum and every sort is stable (``jnp.argsort``'s default).

Points are held as the JAX package holds them with 64-bit types off
(:func:`as_points`): MinHash signatures as int32 tensors of uint32 bits
(``minhash_jaccard`` compares them for equality only), floats as float32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Union

import numpy as np
import torch

from datasketch_tpu_torch.device import resolve_device, upload_bits

__all__ = ["DeviceGraph", "export_graph", "batch_query", "search", "distance_fn",
           "eager_distance_fn", "as_points", "result_rows"]

BIG = float(np.float32(3.4e38))  # the JAX package's "no distance" value, in f32


def _inv_width(p: int) -> float:
    return float(np.float32(1.0) / np.float32(p))


def _equal_slots(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """int32 count of equal slots, broadcast as the metrics are (a sum of
    bools casts them first: int32 moves half the bytes of float64)."""
    return (pts == q.unsqueeze(-2)).sum(-1, dtype=torch.int32)


@functools.lru_cache(maxsize=16)
def distance_fn(metric: Union[str, Callable]):
    """Resolve a metric name to ``(q[..., D], pts[..., N, D]) -> [..., N]``
    on torch tensors; a callable passes through (it keeps that contract).

    ``l2`` takes its root in float64 and rounds once (correctly rounded, as
    XLA's float32 root is). ``minhash_jaccard`` is ``1 - mean(equal slots)`` rounded as the JAX
    package's jitted code rounds it on the CPU: XLA turns the mean's
    division by P into a product with ``f32(1 / P)`` and fuses it with the
    subtraction into one FMA, so the distance is ``f32(1 - c * f32(1/P))``
    with one rounding. Computed here in float64, where the product and the
    difference are exact, then rounded to float32 once.
    """
    if callable(metric):
        return metric
    if metric == "l2":

        def l2(q, pts):
            s = ((pts - q.unsqueeze(-2)) ** 2).sum(-1).to(torch.float32)
            # torch's vectorized CPU sqrt is not correctly rounded; the
            # float64 root rounded once to float32 is, as XLA's is
            return torch.sqrt(s.double()).to(torch.float32)

        return l2
    if metric == "cosine":

        def cos(q, pts):
            qn = q / torch.linalg.norm(q, dim=-1, keepdim=True)
            pn = pts / torch.linalg.norm(pts, dim=-1, keepdim=True)
            return 1.0 - (pn * qn.unsqueeze(-2)).sum(-1)

        return cos
    if metric == "minhash_jaccard":

        def jaccard(q, pts):
            eq = _equal_slots(q, pts).to(torch.float64)
            return (1.0 - eq * _inv_width(q.shape[-1])).to(torch.float32)

        return jaccard
    raise ValueError("unknown metric: %r" % (metric,))


def eager_distance_fn(metric: Union[str, Callable]):
    """:func:`distance_fn` as the JAX package rounds it OUTSIDE ``jit``
    (``HNSW.from_points``' edge distances): there ``minhash_jaccard``'s
    product ``c * f32(1/P)`` rounds to float32 before the subtraction.
    Every other metric is :func:`distance_fn`'s."""
    if metric != "minhash_jaccard":
        return distance_fn(metric)

    def jaccard(q, pts):
        return 1.0 - _equal_slots(q, pts).to(torch.float32) * _inv_width(q.shape[-1])

    return jaccard


_NARROW = {np.dtype(np.uint64): np.uint32, np.dtype(np.int64): np.int32,
           np.dtype(np.float64): np.float32}
_NARROW_T = {torch.int64: torch.int32, torch.float64: torch.float32}


def as_points(x, device) -> torch.Tensor:
    """Points or queries as the JAX package holds them (64-bit types off):
    (u)int64 narrow to 32 bits, float64 to float32, uint32 rides as int32
    bit patterns. A numpy array or a tensor; contiguous on ``device``."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        x = x.to(_NARROW_T.get(x.dtype, x.dtype))
        return x.to(device).contiguous()
    arr = np.asarray(x)
    return upload_bits(arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False), device)


@dataclass
class DeviceGraph:
    """HNSW graph exported to tensors (query-only snapshot).

    ``deleted`` carries the soft-delete tombstones: tombstoned nodes still
    route but never come back as results.
    """

    points: torch.Tensor  # [N, D]
    adj0: torch.Tensor  # int32[N, deg0], -1 padded
    upper_nodes: list  # per level (top..1): int64[n_l] sorted global ids
    upper_adj: list  # per level: int32[n_l, deg], LOCAL indices, -1 padded
    entry: int
    keys: list = field(default_factory=list)
    deleted: torch.Tensor = None  # bool[N]

    @property
    def n(self) -> int:
        return self.points.shape[0]


def export_graph(index, dtype=None, device="cuda") -> DeviceGraph:
    """Snapshot a host :class:`datasketch_tpu_torch.models.hnsw.HNSW` for
    batched queries on ``device``.

    Soft-deleted nodes keep their edges (they still route) but are marked
    so queries mask them out; hard-removed nodes are absent already.
    """
    device = resolve_device(device)
    keys = list(index._nodes.keys())
    key_pos = {k: i for i, k in enumerate(keys)}
    pts = np.stack([np.asarray(index._nodes[k].point) for k in keys])
    if dtype is not None:
        pts = pts.astype(dtype)
    deleted = np.array([index._nodes[k].is_deleted for k in keys], dtype=bool)

    graphs = index._graphs  # list of layers, 0 = base
    base = graphs[0]
    deg0 = max(2, max((len(base[k]) for k in base), default=2))
    adj0 = np.full((len(keys), deg0), -1, dtype=np.int32)
    for k in base:
        row = key_pos[k]
        for j, nb in enumerate(base[k]):
            adj0[row, j] = key_pos[nb]

    upper_nodes, upper_adj = [], []
    for layer in reversed(graphs[1:]):  # top level first
        nodes = np.array(sorted(key_pos[k] for k in layer), dtype=np.int64)
        local = {int(g): i for i, g in enumerate(nodes)}
        deg = max(2, max((len(layer[k]) for k in layer), default=2))
        adj = np.full((len(nodes), deg), -1, dtype=np.int32)
        for k in layer:
            li = local[key_pos[k]]
            for j, nb in enumerate(layer[k]):
                adj[li, j] = local[key_pos[nb]]
        upper_nodes.append(torch.from_numpy(nodes).to(device))
        upper_adj.append(torch.from_numpy(adj).to(device))

    return DeviceGraph(
        points=as_points(pts, device),
        adj0=torch.from_numpy(adj0).to(device),
        upper_nodes=upper_nodes,
        upper_adj=upper_adj,
        entry=key_pos[index._entry_point],
        keys=keys,
        deleted=torch.from_numpy(deleted).to(device),
    )


def _pick(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``x[q, j[q]]`` per row q."""
    return x.gather(1, j[:, None])[:, 0]


def _greedy_level(points, nodes, adj, entry_local, queries, dist):
    """ef=1 greedy descent on one compact level, batched over queries:
    steps until no query moves (one device-to-host flag per step).
    Returns the GLOBAL id of the local minimum per query."""
    cur = entry_local
    cur_d = dist(queries, points[nodes[cur]][:, None, :])[:, 0]
    while True:
        nbrs = adj[cur]  # [Q, deg] local
        valid = nbrs >= 0
        safe = torch.where(valid, nbrs, 0).long()
        d = dist(queries, points[nodes[safe]])  # [Q, deg]
        d = torch.where(valid, d, BIG)
        j = torch.argmin(d, dim=-1)
        best_d = _pick(d, j)
        better = best_d < cur_d
        if not bool(better.any()):
            return nodes[cur]
        cur = torch.where(better, _pick(safe, j), cur)
        cur_d = torch.where(better, best_d, cur_d)


def _beam_search(points, adj0, deleted, entries, queries, dist, ef: int, iters: int):
    """Fixed-iteration masked beam search at the base layer.

    State per query: beam ids int32[ef] (-1 empty), dists f32[ef], expanded
    bool[ef]. Each iteration expands the best unexpanded entry.
    """
    q = queries.shape[0]
    deg = adj0.shape[1]
    dev = queries.device
    rows = torch.arange(q, device=dev)

    ids = torch.full((q, ef), -1, dtype=torch.int32, device=dev)
    ids[:, 0] = entries.to(torch.int32)
    dists = torch.full((q, ef), BIG, dtype=torch.float32, device=dev)
    dists[:, 0] = dist(queries, points[entries][:, None, :])[:, 0]
    expanded = torch.zeros((q, ef), dtype=torch.bool, device=dev)
    fresh = torch.zeros((q, deg), dtype=torch.bool, device=dev)

    for _ in range(iters):
        cand_d = torch.where(expanded | (ids < 0), BIG, dists)
        slot = torch.argmin(cand_d, dim=-1)
        has = _pick(cand_d, slot) < BIG
        node = _pick(ids, slot)
        expanded[rows, slot] |= has

        nbrs = adj0[torch.where(has, node, 0).long()]  # [Q, deg]
        valid = (nbrs >= 0) & has[:, None]
        safe = torch.where(valid, nbrs, 0)
        nd = dist(queries, points[safe.long()])
        nd = torch.where(valid, nd, BIG)
        # beam dedupe: drop neighbors already present
        dup = (safe[:, :, None] == ids[:, None, :]) & (ids[:, None, :] >= 0)
        nd = torch.where(dup.any(-1), BIG, nd)

        # merge (beam + neighbors), keep the best ef by distance
        all_ids = torch.cat([ids, torch.where(nd < BIG, safe, -1)], dim=1)
        all_d = torch.cat([dists, nd], dim=1)
        all_exp = torch.cat([expanded, fresh], dim=1)
        order = torch.sort(all_d, dim=1, stable=True).indices[:, :ef]
        ids = all_ids.gather(1, order)
        dists = all_d.gather(1, order)
        expanded = all_exp.gather(1, order)

    # mask tombstoned nodes out of the results (they may still route)
    tomb = deleted[torch.where(ids >= 0, ids, 0).long()] & (ids >= 0)
    dists = torch.where(tomb, BIG, dists)
    order = torch.sort(dists, dim=1, stable=True).indices
    return torch.where(tomb, -1, ids).gather(1, order), dists.gather(1, order)


def search(graph: DeviceGraph, queries: torch.Tensor, dist, k: int, ef: int, iters: int):
    """(ids int32[Q, k], dists f32[Q, k]) of a query batch on ``graph``'s
    device: the upper-level descent, then the base-layer beam. Empty and
    tombstoned slots are (-1, BIG), last."""
    deleted = graph.deleted
    if deleted is None:
        deleted = torch.zeros(graph.n, dtype=torch.bool, device=graph.points.device)
    entries = torch.full((queries.shape[0],), graph.entry, dtype=torch.int64,
                         device=queries.device)
    for nodes, adj in zip(graph.upper_nodes, graph.upper_adj):
        # upper-level nodes exist in every lower level, so per-query global
        # entries always resolve to a local index via the sorted node list
        entry_local = torch.searchsorted(nodes, entries)
        entries = _greedy_level(graph.points, nodes, adj, entry_local, queries, dist)
    ids, dists = _beam_search(graph.points, graph.adj0, deleted, entries, queries, dist,
                              ef, iters)
    return ids[:, :k], dists[:, :k]


def result_rows(keys: list, ids: np.ndarray, dists: np.ndarray) -> list:
    """Per query, the (key, distance) pairs of the live slots."""
    return [
        [(keys[int(i)], float(d)) for i, d in zip(row_ids, row_d) if i >= 0 and d < 1e37]
        for row_ids, row_d in zip(ids, dists)
    ]


def batch_query(graph: DeviceGraph, queries, k: int = 10, ef: int = 64,
                metric: Union[str, Callable] = "minhash_jaccard", iters: int = None) -> list:
    """Batched ANN query on the exported graph.

    Args:
        queries: [Q, D] array or tensor matching ``graph.points``' dtype
            semantics.
        ef: beam width; ``iters`` defaults to ``ef`` expansions.
    Returns:
        list (per query) of (key, distance) pairs, ascending distance.
    """
    iters = ef if iters is None else iters
    q = as_points(queries, graph.points.device)
    ids, dists = search(graph, q, distance_fn(metric), k, ef, iters)
    return result_rows(graph.keys, ids.cpu().numpy(), dists.cpu().numpy())
