"""HNSW -- hierarchical navigable small world graph ANN index (host).

Copy of ``datasketch_tpu/models/hnsw.py``: the reference datasketch
``HNSW``'s full MutableMapping surface (soft / hard remove with graph
repair, merge, copy, optional reverse-edge layers), the algorithm of
Malkov & Yashunin (arXiv:1603.09320) with hnswlib-style heuristic pruning,
in numpy. Every frontier expansion evaluates distances to all unvisited
neighbors in one ``batch_distance_func(query, points_matrix)`` call where
one is given.

:meth:`HNSW.from_points` builds the graph on the card instead
(:func:`datasketch_tpu_torch.ops.knn_graph.build_nsw_graph`) and converts
it into the mutable layers. The batched on-card query over an exported
graph is :mod:`datasketch_tpu_torch.ops.hnsw_ops`.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict
from collections.abc import Mapping, MutableMapping
from typing import Callable, Hashable, Optional, Union

import numpy as np
import torch

__all__ = ["HNSW"]


class _Node:
    """An indexed point: key, vector, and a soft-delete tombstone."""

    __slots__ = ("key", "point", "is_deleted")

    def __init__(self, key, point, is_deleted=False):
        self.key = key
        self.point = point
        self.is_deleted = is_deleted

    def __eq__(self, other):
        return (
            self.key == other.key
            and np.array_equal(self.point, other.point)
            and self.is_deleted == other.is_deleted
        )

    def copy(self) -> "_Node":
        return _Node(self.key, self.point, self.is_deleted)

    def __repr__(self):
        return f"_Node({self.key!r}, deleted={self.is_deleted})"


class _Layer:
    """One graph level: key -> {neighbor: distance}."""

    def __init__(self, key: Hashable) -> None:
        self._graph: dict = {key: {}}

    def __contains__(self, key) -> bool:
        return key in self._graph

    def __getitem__(self, key) -> dict:
        return self._graph[key]

    def __setitem__(self, key, value: dict) -> None:
        self._graph[key] = value

    def __delitem__(self, key) -> None:
        del self._graph[key]

    def __eq__(self, other) -> bool:
        if not isinstance(other, _Layer):
            return False
        return self._graph == other._graph

    def __len__(self) -> int:
        return len(self._graph)

    def __iter__(self):
        return iter(self._graph)

    def copy(self) -> "_Layer":
        new = object.__new__(type(self))
        new._graph = {k: dict(v) for k, v in self._graph.items()}
        if isinstance(new, _LayerWithReversedEdges):
            new._reverse = {k: set(v) for k, v in getattr(self, "_reverse", {}).items()}
        return new

    def get_reverse_edges(self, key) -> set:
        """All nodes with an out-edge to `key` (linear scan here; the
        reverse-edge layer answers in O(1))."""
        return {n for n, nbrs in self._graph.items() if key in nbrs}


class _LayerWithReversedEdges(_Layer):
    """Layer that maintains reverse edges: O(1) hard-remove at the cost of
    extra memory and bookkeeping on every edge write."""

    def __init__(self, key: Hashable) -> None:
        self._graph = {key: {}}
        self._reverse: dict = {key: set()}

    def __setitem__(self, key, value: dict) -> None:
        old = self._graph.get(key, {})
        for n in old:
            if n not in value and n in self._reverse:
                self._reverse[n].discard(key)
        for n in value:
            self._reverse.setdefault(n, set()).add(key)
        self._reverse.setdefault(key, set())
        self._graph[key] = value

    def __delitem__(self, key) -> None:
        for n in self._graph[key]:
            if n in self._reverse:
                self._reverse[n].discard(key)
        del self._graph[key]
        self._reverse.pop(key, None)

    def __eq__(self, other) -> bool:
        if not isinstance(other, _LayerWithReversedEdges):
            return False
        return self._graph == other._graph

    def get_reverse_edges(self, key) -> set:
        return set(self._reverse.get(key, set()))


class HNSW(MutableMapping):
    """Approximate nearest-neighbor index under any distance function.

    Args:
        distance_func: ``(x, y) -> float`` distance between two points.
        m: Out-degree kept per node (level 0 keeps ``m0``).
        ef_construction: Beam width during construction.
        m0: Level-0 out-degree; defaults to ``2 * m``.
        seed: Seed for the level generator.
        reversed_edges: Maintain reverse edges for fast hard-removes.
        batch_distance_func: Optional ``(query, points[N, ...]) -> float[N]``
            vectorized distance used for frontier expansion.
    """

    def __init__(
        self,
        distance_func: Callable,
        m: int = 16,
        ef_construction: int = 200,
        m0: Optional[int] = None,
        seed: Optional[int] = None,
        reversed_edges: bool = False,
        batch_distance_func: Optional[Callable] = None,
    ) -> None:
        self._nodes: OrderedDict = OrderedDict()
        self._distance_func = distance_func
        self._batch_distance_func = batch_distance_func
        self._m = m
        self._ef_construction = ef_construction
        self._m0 = 2 * m if m0 is None else m0
        self._level_mult = 1 / np.log(m)
        self._graphs: list = []
        self._entry_point = None
        self._random = np.random.RandomState(seed)
        self._layer_class = _LayerWithReversedEdges if reversed_edges else _Layer

    @classmethod
    def from_points(
        cls,
        points,
        keys=None,
        distance_func: Optional[Callable] = None,
        metric="l2",
        m: int = 16,
        ef_construction: int = 200,
        m0: Optional[int] = None,
        reversed_edges: bool = False,
        batch_distance_func: Optional[Callable] = None,
        tile: int = 256,
        device="cuda",
    ) -> "HNSW":
        """Bulk-build a fully mutable HNSW on the card.

        The graph is constructed on ``device`` (exact kNN + diversity
        pruning + nested routing levels,
        :mod:`datasketch_tpu_torch.ops.knn_graph`) and converted into the
        normal mutable layer structure: the result supports insert / remove
        / query exactly like an incrementally built index.

        Args:
            points: [N, D] array; ``metric`` names the device metric
                ('l2' / 'cosine' / 'minhash_jaccard' or a callable on torch
                tensors).
            distance_func: host-side distance for subsequent incremental
                operations; defaults to a NumPy equivalent of ``metric``.
            device: ``"cuda"`` (default) or ``"cpu"`` (plain versions of
                the kernels). No silent fallback.
        """
        if distance_func is None:
            if metric == "l2":
                distance_func = lambda x, y: float(np.linalg.norm(x - y))  # noqa: E731
                if batch_distance_func is None:
                    batch_distance_func = lambda q, pts: np.linalg.norm(  # noqa: E731
                        np.asarray(pts) - q, axis=-1
                    )
            elif metric == "cosine":
                def distance_func(x, y):
                    x = np.asarray(x, dtype=np.float64)
                    y = np.asarray(y, dtype=np.float64)
                    denom = np.linalg.norm(x) * np.linalg.norm(y)
                    return float(1.0 - np.dot(x, y) / denom) if denom else 1.0

                if batch_distance_func is None:
                    def batch_distance_func(q, pts):
                        q = np.asarray(q, dtype=np.float64)
                        pts = np.asarray(pts, dtype=np.float64)
                        denom = np.linalg.norm(pts, axis=-1) * np.linalg.norm(q)
                        dots = pts @ q
                        with np.errstate(invalid="ignore", divide="ignore"):
                            sim = np.where(denom > 0, dots / denom, 0.0)
                        return 1.0 - sim
            elif metric == "minhash_jaccard":
                distance_func = lambda x, y: 1.0 - float(np.mean(x == y))  # noqa: E731
                if batch_distance_func is None:
                    batch_distance_func = lambda q, pts: 1.0 - (  # noqa: E731
                        np.asarray(pts) == q
                    ).mean(axis=-1)
            else:
                raise ValueError(
                    "provide distance_func for metric %r" % (metric,)
                )
        return _bulk_build_hnsw(
            points,
            keys,
            distance_func,
            metric,
            m,
            ef_construction,
            m0,
            reversed_edges,
            batch_distance_func,
            tile,
            device,
        )

    # ------------------------------------------------------------- distances

    def _dists_to(self, query_point, keys: list) -> list:
        """Distances from query to many stored points, batched if possible."""
        if not keys:
            return []
        if self._batch_distance_func is not None:
            pts = np.stack([self._nodes[p].point for p in keys])
            return list(np.asarray(self._batch_distance_func(query_point, pts)))
        return [
            self._distance_func(query_point, self._nodes[p].point) for p in keys
        ]

    # ------------------------------------------------------- mapping surface

    def __len__(self) -> int:
        return sum(not node.is_deleted for node in self._nodes.values())

    def __contains__(self, key) -> bool:
        return key in self._nodes and not self._nodes[key].is_deleted

    def __getitem__(self, key):
        if key not in self:
            raise KeyError(key)
        return self._nodes[key].point

    def __setitem__(self, key, value) -> None:
        self.insert(key, value)

    def __delitem__(self, key) -> None:
        self.remove(key)

    def __iter__(self):
        return (key for key in self._nodes if not self._nodes[key].is_deleted)

    def reversed(self):
        """Reverse-order iterator over live keys."""
        return (
            key for key in reversed(self._nodes) if not self._nodes[key].is_deleted
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, HNSW):
            return False
        if (
            self._distance_func != other._distance_func
            or self._m != other._m
            or self._ef_construction != other._ef_construction
            or self._m0 != other._m0
            or self._level_mult != other._level_mult
            or self._entry_point != other._entry_point
        ):
            return False
        s1 = self._random.get_state()
        s2 = other._random.get_state()
        for a, b in zip(s1, s2):
            if isinstance(a, np.ndarray):
                if not np.array_equal(a, b):
                    return False
            elif a != b:
                return False
        return (
            set(self._nodes) == set(other._nodes)
            and all(self._nodes[k] == other._nodes[k] for k in self._nodes)
            and self._graphs == other._graphs
        )

    def get(self, key, default=None):
        if key not in self:
            return default
        return self._nodes[key].point

    def items(self):
        return (
            (key, node.point)
            for key, node in self._nodes.items()
            if not node.is_deleted
        )

    def keys(self):
        return (key for key in self._nodes if not self._nodes[key].is_deleted)

    def values(self):
        return (
            node.point for node in self._nodes.values() if not node.is_deleted
        )

    def pop(self, key, default=None, hard: bool = False):
        """Remove and return the point at key (KeyError if absent and no
        default given)."""
        if key not in self:
            if default is None:
                raise KeyError(key)
            return default
        point = self._nodes[key].point
        self.remove(key, hard=hard)
        return point

    def popitem(self, last: bool = True, hard: bool = False):
        """Remove and return a (key, point) pair, LIFO if `last`."""
        if not self._nodes:
            raise KeyError("popitem(): index is empty")
        order = reversed(self._nodes) if last else iter(self._nodes)
        key = next((k for k in order if not self._nodes[k].is_deleted), None)
        if key is None:
            raise KeyError("popitem(): index is empty")
        point = self._nodes[key].point
        self.remove(key, hard=hard)
        return key, point

    def clear(self) -> None:
        """Drop all points (random state is kept)."""
        self._nodes = OrderedDict()
        self._graphs = []
        self._entry_point = None

    def copy(self) -> "HNSW":
        """Deep copy sharing no graph structure with the original."""
        new_index = HNSW(
            self._distance_func,
            m=self._m,
            ef_construction=self._ef_construction,
            m0=self._m0,
            reversed_edges=self._layer_class is _LayerWithReversedEdges,
            batch_distance_func=self._batch_distance_func,
        )
        new_index._nodes = OrderedDict(
            (key, node.copy()) for key, node in self._nodes.items()
        )
        new_index._graphs = [layer.copy() for layer in self._graphs]
        new_index._entry_point = self._entry_point
        new_index._random.set_state(self._random.get_state())
        return new_index

    def update(self, other: Union[Mapping, "HNSW"]) -> None:
        """Insert every (key, point) from the mapping/index, overwriting."""
        for key, point in other.items():
            self.insert(key, point)

    def setdefault(self, key, default):
        if default is None:
            raise ValueError("Default value cannot be None.")
        if key not in self._nodes or self._nodes[key].is_deleted:
            self.insert(key, default)
        return self._nodes[key].point

    def merge(self, other: "HNSW") -> "HNSW":
        """New index = copy of self updated with other's points."""
        new_index = self.copy()
        new_index.update(other)
        return new_index

    # ------------------------------------------------------- graph traversal
    #
    # One beam-search primitive covers every traversal need (greedy descent
    # is just ef=1). State is a sorted parallel-array result set plus a heap
    # frontier; each frontier expansion evaluates ALL unvisited neighbors in
    # one `_dists_to` batch — this is the host mirror of the device beam in
    # :mod:`datasketch_tpu_torch.ops.hnsw_ops` (fixed-width sorted rows,
    # batched distance evaluation), kept semantically aligned with the
    # reference datasketch index (``datasketch/hnsw.py``) so recall
    # characteristics match.

    def _returnable(self, key, include_tombstones: bool, banned) -> bool:
        """May `key` appear in a result set? Tombstoned nodes are always
        traversed (they keep the graph navigable) but only returned when the
        caller opts in; a node mid-hard-remove (`banned`) never is."""
        if key == banned:
            return False
        return include_tombstones or not self._nodes[key].is_deleted

    def _search_layer(
        self,
        query_point,
        seeds,
        layer: _Layer,
        ef: int,
        include_tombstones: bool = False,
        banned=None,
    ):
        """Best-first beam search across one layer.

        Args:
            seeds: (keys list, dists list) — already-evaluated entry nodes.
                Seeds join the result set unconditionally (mirroring how the
                descent phase hands its best node down even if tombstoned).
        Returns:
            (keys, dists) of the beam, ascending by distance, len <= ef.
        """
        from bisect import bisect_right

        seed_keys, seed_dists = seeds
        order = np.argsort(np.asarray(seed_dists, dtype=float), kind="stable")
        beam_d = [float(seed_dists[i]) for i in order]
        beam_k = [seed_keys[i] for i in order]
        del beam_d[ef:], beam_k[ef:]
        frontier = sorted(zip(beam_d, range(len(beam_k))))
        # Heap entries carry an insertion serial instead of the key itself:
        # keys of mixed types are not orderable on distance ties.
        frontier = [(d, i, beam_k[i]) for d, i in frontier]
        serial = len(frontier)
        seen = set(seed_keys)

        while frontier:
            dist, _, node = heapq.heappop(frontier)
            if dist > beam_d[-1]:
                break  # nearest unexpanded node can't improve the beam
            fresh = [p for p in layer[node] if p not in seen]
            # Mark ALL examined neighbors, admitted or not — a node rejected
            # at this beam width is never worth re-reaching via another path.
            seen.update(fresh)
            for p, d in zip(fresh, self._dists_to(query_point, fresh)):
                d = float(d)
                # At ef=1 (greedy descent) ties don't improve anything and
                # admitting them floods the frontier on distance plateaus
                # (common under discrete metrics like MinHash Jaccard), so
                # require strict improvement there.
                improves = d < beam_d[-1] if ef == 1 else d <= beam_d[-1]
                if self._returnable(p, include_tombstones, banned):
                    if len(beam_d) < ef or improves:
                        at = bisect_right(beam_d, d)
                        beam_d.insert(at, d)
                        beam_k.insert(at, p)
                        del beam_d[ef:], beam_k[ef:]
                        heapq.heappush(frontier, (d, serial, p))
                        serial += 1
                elif improves:
                    # pass-through: expandable but never returned
                    heapq.heappush(frontier, (d, serial, p))
                    serial += 1
        return beam_k, beam_d

    def _descend(
        self,
        query_point,
        to_level: int,
        include_tombstones: bool = False,
        banned=None,
    ):
        """Greedy (ef=1) descent from the top layer down to `to_level`
        (exclusive). Returns the seed (keys, dists) for that level."""
        node = self._entry_point
        seeds = [node], [self._distance_func(query_point, self._nodes[node].point)]
        for layer in self._graphs[:to_level:-1]:
            seeds = self._search_layer(
                query_point, seeds, layer, 1, include_tombstones, banned
            )
        return seeds

    def _level_cap(self, level: int) -> int:
        """Out-degree budget at a level (level 0 is denser)."""
        return self._m0 if level == 0 else self._m

    def _diverse_prune(self, cand_keys, cand_dists, cap: int) -> dict:
        """Neighbor diversification: scanning candidates nearest-first, keep
        one only if no already-kept neighbor is closer to it than the anchor
        is (hnswlib's SELECT-NEIGHBORS-HEURISTIC; rejected candidates are
        dropped, not back-filled). Under-full candidate sets skip the scan
        entirely. Returns the adjacency dict {key: anchor_distance}.
        """
        if len(cand_keys) < cap:
            return dict(zip(cand_keys, (float(d) for d in cand_dists)))
        kept: dict = {}
        kept_pts: list = []
        batched = self._batch_distance_func
        for i in np.argsort(np.asarray(cand_dists, dtype=float), kind="stable"):
            k, d = cand_keys[i], float(cand_dists[i])
            pt = self._nodes[k].point
            if kept_pts:
                if batched is not None:
                    if bool(
                        np.any(np.asarray(batched(pt, np.stack(kept_pts))) < d)
                    ):
                        continue
                # scalar metric: stop at the first disqualifying neighbor
                elif any(
                    self._distance_func(pt, kp) < d for kp in kept_pts
                ):
                    continue
            kept[k] = d
            kept_pts.append(pt)
            if len(kept) == cap:
                break
        return kept

    # --------------------------------------------------------------- insert

    def insert(
        self,
        key,
        new_point,
        ef: Optional[int] = None,
        level: Optional[int] = None,
    ) -> None:
        """Insert or update a point; updates repair the neighborhood."""
        if ef is None:
            ef = self._ef_construction
        if key in self._nodes:
            self._nodes[key].is_deleted = False
            self._reindex(key, new_point, ef)
            return
        if level is None:
            level = int(-np.log(self._random.random_sample()) * self._level_mult)
        self._nodes[key] = _Node(key, new_point)
        if self._entry_point is not None:
            seeds = self._descend(new_point, level, include_tombstones=True)
            for lvl in range(min(level, len(self._graphs) - 1), -1, -1):
                layer = self._graphs[lvl]
                seeds = self._search_layer(
                    new_point, seeds, layer, ef, include_tombstones=True
                )
                self._link(layer, self._level_cap(lvl), key, *seeds)
        # every level above the current top gets a fresh layer holding only
        # the new key, which becomes the global entry point
        for _ in range(len(self._graphs), level + 1):
            self._graphs.append(self._layer_class(key))
            self._entry_point = key

    def _link(self, layer: _Layer, cap: int, key, cand_keys, cand_dists) -> None:
        """Wire `key` into a layer: pick its out-edges by diversity prune,
        then offer the reciprocal edge to each chosen neighbor (the
        neighbor re-prunes its own list with the newcomer included)."""
        layer[key] = self._diverse_prune(cand_keys, cand_dists, cap)
        for nbr, d in layer[key].items():
            adj = layer[nbr]
            if key not in adj:
                merged_keys = list(adj) + [key]
                merged_dists = list(adj.values()) + [d]
                layer[nbr] = self._diverse_prune(merged_keys, merged_dists, cap)

    def _reindex(self, key, new_point, ef: int) -> None:
        """Re-home an existing key at a new point: rebuild each old
        neighbor's adjacency from the 2nd-degree neighborhood (the region
        the moved point tears a hole in), then re-derive the key's own
        out-edges by a fresh graph search."""
        if key not in self._nodes:
            raise KeyError(key)
        self._nodes[key].point = new_point
        if self._entry_point == key and len(self._nodes) == 1:
            return
        for lvl, layer in enumerate(self._graphs):
            if key not in layer:
                break
            hood = {key}
            for p in layer[key]:
                hood.add(p)
                hood.update(layer[p])
            cap = self._level_cap(lvl)
            for p in layer[key]:
                others = [c for c in hood if c != p]
                if not others:
                    continue
                dists = np.asarray(
                    self._dists_to(self._nodes[p].point, others), dtype=float
                )
                keep = min(ef, len(others))
                near = np.argsort(dists, kind="stable")[:keep]
                layer[p] = self._diverse_prune(
                    [others[i] for i in near], dists[near], cap
                )
        self._relink(key, new_point, ef)

    def _relink(self, key, point, ef: int, banned=None) -> None:
        """Recompute `key`'s out-edges on every layer it occupies by
        searching the graph top-down (used after a point move and to patch
        the in-neighbors of a hard-removed node, which is passed as
        `banned` so it can't be chosen)."""
        node = self._entry_point
        seeds = [node], [self._distance_func(point, self._nodes[node].point)]
        for lvl in range(len(self._graphs) - 1, -1, -1):
            layer = self._graphs[lvl]
            if key not in layer:
                seeds = self._search_layer(
                    point, seeds, layer, 1, include_tombstones=True, banned=banned
                )
                continue
            # ef+1: the beam finds `key` itself too; exclude it below
            seeds = self._search_layer(
                point, seeds, layer, ef + 1, include_tombstones=True, banned=banned
            )
            cand = [(p, d) for p, d in zip(*seeds) if p != key]
            layer[key] = self._diverse_prune(
                [p for p, _ in cand], [d for _, d in cand], self._level_cap(lvl)
            )

    # ---------------------------------------------------------------- query

    def query(
        self,
        query_point,
        k: Optional[int] = None,
        ef: Optional[int] = None,
    ) -> list:
        """k nearest neighbors as (key, distance) pairs, nearest first."""
        if ef is None:
            ef = self._ef_construction
        if self._entry_point is None:
            raise ValueError("Entry point not found.")
        seeds = self._descend(query_point, 0)
        keys, dists = self._search_layer(query_point, seeds, self._graphs[0], ef)
        out = list(zip(keys, dists))
        return out[:k] if k is not None else out

    # --------------------------------------------------------------- remove

    def remove(self, key, hard: bool = False, ef: Optional[int] = None) -> None:
        """Soft remove (tombstone) or hard remove (unlink + re-wire the
        in-neighbors). Entry point is re-assigned if needed; removing the
        last point clears the index."""
        if not self._nodes or key not in self._nodes:
            raise KeyError(key)
        if ef is None:
            ef = self._ef_construction
        if self._entry_point == key and not self._rehome_entry_point(key):
            self.clear()  # no live node left anywhere
            return
        self._nodes[key].is_deleted = True
        if not hard:
            return
        # Patch everyone pointing at the doomed node, then unlink it. The
        # key occupies a contiguous run of levels from 0 up, so stop the
        # scans at the first level missing it.
        in_neighbors = set()
        for layer in self._graphs:
            if key not in layer:
                break
            in_neighbors |= layer.get_reverse_edges(key)
        for nbr in in_neighbors:
            self._relink(nbr, self._nodes[nbr].point, ef, banned=key)
        for layer in self._graphs:
            if key not in layer:
                break
            del layer[key]
        del self._nodes[key]

    def _rehome_entry_point(self, key) -> bool:
        """Move the entry point off `key`: take any live node from the
        highest possible level, dropping levels where none exists. False
        if the whole index is (or becomes) dead."""
        for lvl in range(len(self._graphs) - 1, -1, -1):
            successor = next(
                (
                    p
                    for p in self._graphs[lvl]
                    if p != key and not self._nodes[p].is_deleted
                ),
                None,
            )
            if successor is not None:
                self._entry_point = successor
                return True
            self._graphs.pop()
        return False

    def clean(self, ef: Optional[int] = None) -> None:
        """Hard-remove every tombstoned point."""
        for key in [k for k, n in self._nodes.items() if n.is_deleted]:
            self.remove(key, ef=ef, hard=True)


def _bulk_build_hnsw(
    points,
    keys,
    distance_func,
    metric,
    m,
    ef_construction,
    m0,
    reversed_edges,
    batch_distance_func,
    tile,
    device,
):
    """Implementation of :meth:`HNSW.from_points` (module-level to keep the
    class namespace clean)."""
    from datasketch_tpu_torch.device import resolve_device
    from datasketch_tpu_torch.ops import knn_graph
    from datasketch_tpu_torch.ops.hnsw_ops import as_points, eager_distance_fn

    dev = resolve_device(device)
    points = np.asarray(points)
    n = points.shape[0]
    keys = list(keys) if keys is not None else list(range(n))
    if len(keys) != n:
        raise ValueError("keys and points must have equal length")

    index = HNSW(
        distance_func=distance_func,
        m=m,
        ef_construction=ef_construction,
        m0=m0,
        reversed_edges=reversed_edges,
        batch_distance_func=batch_distance_func,
    )
    if n == 0:
        return index
    graph = knn_graph.build_nsw_graph(
        as_points(points, dev), keys=keys, m=m, metric=metric, tile=tile
    )
    # the JAX package evaluates the edge distances outside jit
    dist = eager_distance_fn(metric)
    pts_dev = graph.points

    for i, k in enumerate(keys):
        index._nodes[k] = _Node(k, points[i])

    def layer_from(adj_local, node_ids):
        """adj int32[nl, deg] LOCAL indices + global node ids -> _Layer."""
        nl = adj_local.shape[0]
        # one device pass for all edge distances of this level
        safe = np.where(adj_local >= 0, adj_local, 0)
        d = dist(
            pts_dev[torch.from_numpy(node_ids).to(dev)],
            pts_dev[torch.from_numpy(node_ids[safe]).to(dev)],
        ).cpu().numpy()
        layer = object.__new__(index._layer_class)
        layer._graph = {}
        if reversed_edges:
            layer._reverse = {keys[g]: set() for g in node_ids}
        for li in range(nl):
            nbrs = {}
            for j, lj in enumerate(adj_local[li]):
                if lj >= 0:
                    nbrs[keys[node_ids[lj]]] = float(d[li, j])
            layer._graph[keys[node_ids[li]]] = nbrs
        if reversed_edges:
            for src, nbrs in layer._graph.items():
                for dst in nbrs:
                    layer._reverse[dst].add(src)
        return layer

    # base layer: LOCAL ids == global row ids
    index._graphs.append(
        layer_from(graph.adj0.cpu().numpy(), np.arange(n, dtype=np.int64))
    )
    # upper levels come top-first from DeviceGraph; HNSW stores bottom-up
    for nodes, adj in zip(reversed(graph.upper_nodes), reversed(graph.upper_adj)):
        index._graphs.append(layer_from(adj.cpu().numpy(), nodes.cpu().numpy()))
    index._entry_point = keys[graph.entry]
    return index
