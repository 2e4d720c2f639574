"""TorchHNSW -- ANN serving index resident on the card.

Port of ``datasketch_tpu/models/tpu_hnsw.py::TpuHNSW``, the serving-side
complement to :class:`datasketch_tpu_torch.models.hnsw.HNSW`: the graph
lives on the device as adjacency tensors, bulk builds run there
(:func:`datasketch_tpu_torch.ops.knn_graph.build_nsw_graph`: exact kNN on
kernel 2 or 4 for signatures, diversity pruning, nested routing levels),
and queries are batched masked beam searches
(:mod:`datasketch_tpu_torch.ops.hnsw_ops`).

Mutation model: ``add`` buffers on the host and links at the next query
or :meth:`flush` (a rebuild for small or heavily appended indexes, else
the append path); ``remove`` tombstones; ``from_hnsw`` snapshots a
host-built index for serving.

The JAX facade pads the graph to a power-of-two capacity, query batches
to a power of two and its append scatters to power-of-two row counts, to
bound its compiled shapes. None of that changes an answer, and this one
pads nothing: ``status()``'s ``capacity``, ``bytes_points`` and
``bytes_adj`` count the rows that exist. It loads the JAX package's
padded checkpoints (the tombstoned capacity rows are dropped: no edge
reaches them) and writes files in the same ``.npz`` layout.
"""

from __future__ import annotations

from typing import Callable, Hashable, Optional, Sequence, Union

import numpy as np
import torch

from datasketch_tpu_torch.device import resolve_device
from datasketch_tpu_torch.ops import hnsw_ops, knn_graph
from datasketch_tpu_torch.persist import atomic_savez, npz_path, pack_keys, unpack_keys
from datasketch_tpu_torch.utils.pipeline import stream_batches

__all__ = ["TorchHNSW"]


class TorchHNSW:
    """Device ANN index over a hierarchical NSW graph.

    Args:
        distance_metric: ``'l2'``, ``'cosine'``, ``'minhash_jaccard'``, or a
            ``(query[..., D], points[..., N, D]) -> dists[..., N]`` callable
            on torch tensors.
        m: out-degree of the navigable graph (base layer capped at 2m).
        ef: default beam width for queries.
        level_ratio: each routing level keeps 1 / level_ratio of the one
            below.
        tile: least row chunk of the build (results do not depend on it).
        rebuild_fraction: appends since the last build beyond this share
            of the corpus trigger a full rebuild.
        device: ``"cuda"`` (default) or ``"cpu"`` (plain versions of the
            kernels). No silent fallback.
    """

    # appends below this corpus size just rebuild
    _MIN_APPEND_N = 256

    def __init__(
        self,
        distance_metric: Union[str, Callable] = "l2",
        m: int = 16,
        ef: int = 64,
        level_ratio: int = 8,
        tile: int = 256,
        rebuild_fraction: float = 0.2,
        device="cuda",
    ) -> None:
        if m < 2:
            raise ValueError("m must be at least 2")
        self.device = resolve_device(device)
        self.metric = distance_metric
        self.m = m
        self.ef = ef
        self.level_ratio = level_ratio
        self.tile = tile
        self.rebuild_fraction = rebuild_fraction

        self._graph: Optional[hnsw_ops.DeviceGraph] = None
        self._key_to_pos: dict = {}
        self._deleted_host: Optional[np.ndarray] = None
        self._pending: list = []  # (key, point) awaiting link/rebuild
        self._n_real = 0  # live + tombstoned rows
        self._appended = 0  # rows appended since the last full build
        self._adj0_host: Optional[np.ndarray] = None  # host mirror of adj0

    # ------------------------------------------------------------------ build

    def index(self, keys: Sequence[Hashable], points) -> None:
        """Bulk (re)build the graph on the device from (keys, points)."""
        keys = list(keys)
        if not isinstance(points, torch.Tensor):
            points = np.asarray(points)
        if points.shape[0] != len(keys):
            raise ValueError("keys and points must have equal length")
        # Check buffered add()s too: a clash found only when _flush_pending()
        # re-enters index() would raise from inside an unrelated query()
        # after the pending buffer was cleared, losing every buffered point.
        seen = {k for k, _ in self._pending}
        for k in keys:
            if k in self._key_to_pos or k in seen:
                raise ValueError("The given key already exists: %r" % (k,))
            seen.add(k)
        pts = hnsw_ops.as_points(points, self.device)
        if self._graph is not None:
            old_keys = [k for k in self._graph.keys if k in self._key_to_pos]
            old_alive = torch.tensor([self._key_to_pos[k] for k in old_keys],
                                     dtype=torch.int64, device=self.device)
            keys = old_keys + keys
            pts = torch.cat([self._graph.points[old_alive], pts.to(self._graph.points.dtype)])
        self._rebuild(keys, pts)

    def index_tokens(self, keys: Sequence[Hashable], token_docs, num_perm: int = 128,
                     seed: int = 1) -> None:
        """Bulk-build from PRE-TOKENIZED integer documents: the ids are
        hashed on the card into MinHash signatures (kernel 1,
        ``hashfunc="device"``), the ``minhash_jaccard`` metric's points.
        Query with signatures built the same way at equal seed."""
        self._require_minhash_metric("index_tokens")
        if len(keys) != len(token_docs):
            raise ValueError("keys and token_docs must have equal length")
        from datasketch_tpu_torch.models.minhash import MinHash

        self.index(keys, MinHash.bulk_signatures(
            token_docs, num_perm=num_perm, seed=seed, hashfunc="device", out="device",
            device=self.device))

    def index_text(self, keys: Sequence[Hashable], texts, k: int = 9, num_perm: int = 128,
                   seed: int = 1) -> None:
        """Bulk-build from RAW TEXT through on-card k-shingling
        (:meth:`datasketch_tpu_torch.MinHash.bulk_from_text`'s device
        engine). Requires ``distance_metric='minhash_jaccard'``."""
        self._require_minhash_metric("index_text")
        if len(keys) != len(texts):
            raise ValueError("keys and texts must have equal length")
        from datasketch_tpu_torch.models.minhash import MinHash

        self.index(keys, MinHash.bulk_from_text(
            texts, k=k, num_perm=num_perm, seed=seed, hashfunc="device", out="device",
            device=self.device))

    def _require_minhash_metric(self, name: str) -> None:
        if self.metric != "minhash_jaccard":
            raise ValueError(
                "%s requires distance_metric='minhash_jaccard' (points are MinHash "
                "signatures)" % name
            )

    def add(self, key: Hashable, point) -> None:
        """Buffer one (key, point); linked into the graph at the next query.

        Small buffered batches are linked against the frozen graph (beam
        search for neighbors, diversity prune, new adjacency rows, re-prune
        of overflowed reverse rows); a full rebuild runs only when appends
        since the last build exceed ``rebuild_fraction`` of the corpus
        (appended nodes skip the upper routing levels)."""
        if key in self._key_to_pos or any(k == key for k, _ in self._pending):
            raise ValueError("The given key already exists")
        if isinstance(point, torch.Tensor):
            point = point.detach().cpu().numpy()
        self._pending.append((key, np.asarray(point)))

    def flush(self) -> None:
        """Link any buffered :meth:`add` points into the graph now (queries
        flush implicitly; an explicit flush keeps the link cost out of query
        latency)."""
        self._flush_pending()

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        keys = [k for k, _ in self._pending]
        pts = np.stack([p for _, p in self._pending])
        self._pending = []
        if (
            self._graph is None
            or self._n_real < self._MIN_APPEND_N
            or self._appended + len(keys) > self.rebuild_fraction * self._n_real
        ):
            self.index(keys, pts)
        else:
            self._append_batch(keys, pts)

    def _rebuild(self, keys: list, pts: torch.Tensor) -> None:
        g = knn_graph.build_nsw_graph(pts, keys=keys, m=self.m, metric=self.metric,
                                      tile=self.tile, level_ratio=self.level_ratio)
        self._key_to_pos = {k: i for i, k in enumerate(keys)}
        self._install(g, len(keys))

    def _install(self, g: hnsw_ops.DeviceGraph, n_real: int) -> None:
        """Adopt a graph; rows past ``n_real`` (a JAX checkpoint's capacity
        padding: tombstoned, edgeless, unreachable) are dropped."""
        if g.n > n_real:
            g.points = g.points[:n_real].contiguous()
            g.adj0 = g.adj0[:n_real].contiguous()
        if g.deleted is None:
            g.deleted = torch.zeros(n_real, dtype=torch.bool, device=self.device)
        g.deleted = g.deleted[:n_real].contiguous()
        self._graph = g
        self._deleted_host = g.deleted.cpu().numpy().copy()
        self._n_real = n_real
        self._appended = 0
        self._adj0_host = None

    # ------------------------------------------------------- incremental link

    def _ensure_adj0_host(self) -> np.ndarray:
        """Host mirror of the device adjacency (one copy per build cycle,
        kept in step by the append path's updates)."""
        if self._adj0_host is None:
            self._adj0_host = self._graph.adj0.cpu().numpy().copy()
        return self._adj0_host

    def _append_batch(self, keys: list, pts: np.ndarray) -> None:
        """Link a buffered batch against the frozen graph: O(B) beam
        searches instead of the O(N) rebuild. New nodes get ``m``
        diversity-pruned forward edges; reverse edges fill spare adjacency
        slots, and rows that overflow are re-pruned over old + new
        candidates (hnswlib's shrink heuristic, vectorized)."""
        g = self._graph
        dev = self.device
        n0 = self._n_real
        b = len(keys)
        new_pts = hnsw_ops.as_points(pts, dev).to(g.points.dtype)
        deg_cap = g.adj0.shape[1]
        m = self.m
        dist = hnsw_ops.distance_fn(self.metric)

        # 1. neighbor candidates: beam-search the frozen graph
        kc = min(3 * m, n0)
        ef = max(self.ef, kc)
        cand_rows = [hnsw_ops.search(g, new_pts[i: i + 1024], dist, kc, ef, ef)[0]
                     for i in range(0, b, 1024)]
        cands = torch.cat(cand_rows)

        # 2. forward edges: diversity-prune the candidates
        fwd = knn_graph.prune_candidates(new_pts, cands, g.points, m, dist).cpu().numpy()

        # 3. the new points land before any re-prune gathers them
        new_ids = np.arange(n0, n0 + b, dtype=np.int32)
        g.points = torch.cat([g.points, new_pts])

        # 4. adjacency update on the host mirror
        adj = np.concatenate([self._ensure_adj0_host(),
                              np.full((b, deg_cap), -1, dtype=np.int32)])
        adj[new_ids, :m] = fwd
        src = np.repeat(new_ids, fwd.shape[1])
        dst = fwd.ravel()
        ok = dst >= 0
        fill = (adj[:n0] >= 0).sum(axis=1).astype(np.int64)
        src, dst, fits = knn_graph.add_reverse(adj, fill, src[ok], dst[ok], deg_cap)

        # 5. overflowed reverse rows: re-prune old neighbors + newcomers
        if (~fits).any():
            rows_over = dst[~fits]
            srcs_over = src[~fits]
            ov_v = np.unique(rows_over)
            r2 = np.arange(rows_over.shape[0]) - np.searchsorted(rows_over, rows_over,
                                                                 side="left")
            cmat = np.full((ov_v.shape[0], deg_cap + int(r2.max()) + 1), -1, dtype=np.int32)
            cmat[:, :deg_cap] = adj[ov_v]
            cmat[np.searchsorted(ov_v, rows_over), deg_cap + r2] = srcs_over
            ov_t = torch.from_numpy(ov_v.astype(np.int64)).to(dev)
            adj[ov_v] = knn_graph.prune_candidates(
                g.points[ov_t], torch.from_numpy(cmat).to(dev), g.points, deg_cap, dist,
            ).cpu().numpy()
            touched = np.unique(np.concatenate([dst[fits], ov_v]))
        else:
            touched = np.unique(dst[fits])

        # 6. ship the new rows and the touched ones
        g.adj0 = torch.cat([g.adj0, torch.from_numpy(adj[n0:]).to(dev)])
        rows_t = torch.from_numpy(touched.astype(np.int64)).to(dev)
        g.adj0[rows_t] = torch.from_numpy(adj[touched]).to(dev)
        self._adj0_host = adj

        # 7. metadata: appended rows go live
        self._deleted_host = np.concatenate([self._deleted_host, np.zeros(b, dtype=bool)])
        g.deleted = torch.cat([g.deleted, torch.zeros(b, dtype=torch.bool, device=dev)])
        g.keys.extend(keys)
        for i, k in enumerate(keys):
            self._key_to_pos[k] = n0 + i
        self._n_real += b
        self._appended += b

    @classmethod
    def from_hnsw(cls, host_index, distance_metric="l2", ef: int = 64,
                  device="cuda") -> "TorchHNSW":
        """Snapshot a host :class:`~datasketch_tpu_torch.models.hnsw.HNSW`
        (its soft-delete tombstones included) for serving on ``device``."""
        obj = cls(distance_metric=distance_metric, ef=ef, device=device)
        g = hnsw_ops.export_graph(host_index, device=obj.device)
        obj._install(g, g.n)
        # Tombstoned keys stay OUT of _key_to_pos: they read as absent, and a
        # later index() rebuild (which re-derives the corpus from
        # _key_to_pos) must not resurrect them.
        obj._key_to_pos = {k: i for i, k in enumerate(g.keys) if not obj._deleted_host[i]}
        return obj

    # ------------------------------------------------------------ mutation

    def remove(self, key: Hashable) -> None:
        """Tombstone ``key``: masked from every query (soft delete)."""
        self._flush_pending()
        if key not in self._key_to_pos:
            raise ValueError("The given key does not exist")
        pos = self._key_to_pos.pop(key)
        self._deleted_host[pos] = True
        self._graph.deleted[pos] = True

    # --------------------------------------------------------------- query

    def query(self, point, k: int = 10, ef: Optional[int] = None) -> list:
        """(key, distance) pairs for one query, nearest first."""
        if not isinstance(point, torch.Tensor):
            point = np.asarray(point)
        return self.query_batch(point[None, :], k, ef)[0]

    def query_batch(self, points, k: int = 10, ef: Optional[int] = None) -> list:
        """(key, distance) pairs per query row, nearest first."""
        out = self._query_dispatch(points, k, ef)
        if isinstance(out, list):
            return out
        return self._query_finish((out[0].cpu(), out[1].cpu()))

    def query_stream(self, batches, k: int = 10, ef: Optional[int] = None, depth: int = 4):
        """Pipelined :meth:`query_batch` over an iterable of batches
        (:func:`datasketch_tpu_torch.utils.pipeline.stream_batches`). The
        descent waits on the device once per greedy step, so batches
        overlap only in their copies back and the beam steps' launches."""
        return stream_batches(
            batches,
            lambda b: self._query_dispatch(b, k, ef),
            lambda o: o if isinstance(o, list) else self._query_finish(o),
            depth=depth,
        )

    def _query_dispatch(self, points, k: int, ef: Optional[int]):
        self._flush_pending()
        if self._graph is None:
            return [[] for _ in range(len(points))]
        ef = self.ef if ef is None else ef
        q = hnsw_ops.as_points(points, self.device)
        return hnsw_ops.search(self._graph, q, hnsw_ops.distance_fn(self.metric), k, ef, ef)

    def _query_finish(self, out) -> list:
        ids, dists = out
        return hnsw_ops.result_rows(self._graph.keys, ids.numpy(), dists.numpy())

    # ------------------------------------------------------------ plumbing

    def __contains__(self, key: Hashable) -> bool:
        return key in self._key_to_pos or any(k == key for k, _ in self._pending)

    def __len__(self) -> int:
        return len(self._key_to_pos) + len(self._pending)

    def is_empty(self) -> bool:
        return len(self) == 0

    def status(self) -> dict:
        self._flush_pending()
        if self._graph is None:
            return {"n": 0, "levels": 0, "tombstoned": 0}
        g = self._graph
        return {
            "n": self._n_real,
            "live": len(self._key_to_pos),
            "tombstoned": int(self._deleted_host[: self._n_real].sum()),
            "appended_since_build": self._appended,
            "capacity": int(g.n),
            "levels": 1 + len(g.upper_nodes),
            "degree0": int(g.adj0.shape[1]),
            "bytes_points": int(np.prod(g.points.shape)) * 4,
            "bytes_adj": int(np.prod(g.adj0.shape)) * 4,
        }

    # ------------------------------------------------------------ persistence

    def save(self, path: str) -> None:
        """Persist graph + points + tombstones as ``.npz`` (the JAX
        package's ``kind "tpu_hnsw"`` layout)."""
        self._flush_pending()
        if self._graph is None:
            raise ValueError("Cannot save an empty index")
        g = self._graph
        points = g.points.cpu().numpy()
        if self.metric == "minhash_jaccard" and points.dtype == np.int32:
            points = points.view(np.uint32)  # signatures, as the JAX package saves them
        payload = {
            "kind": np.array("tpu_hnsw"),
            "metric": np.array(self.metric if isinstance(self.metric, str) else "custom"),
            "m": np.int64(self.m),
            "ef": np.int64(self.ef),
            "entry": np.int64(g.entry),
            "points": points,
            "adj0": g.adj0.cpu().numpy(),
            "deleted": self._deleted_host,
            "keys": pack_keys(list(g.keys)),
            "n_upper": np.int64(len(g.upper_nodes)),
        }
        for i, (nodes, adj) in enumerate(zip(g.upper_nodes, g.upper_adj)):
            payload[f"upper_nodes_{i}"] = nodes.cpu().numpy().astype(np.int32)
            payload[f"upper_adj_{i}"] = adj.cpu().numpy()
        atomic_savez(path, **payload)

    @classmethod
    def load(cls, path: str, distance_metric: Optional[Union[str, Callable]] = None,
             device="cuda") -> "TorchHNSW":
        """Load a checkpoint of either package onto ``device``.

        SECURITY: the key list inside the file is a pickle payload -- only
        load index files you created or trust."""
        data = np.load(npz_path(path), allow_pickle=False)
        if str(data["kind"]) != "tpu_hnsw":
            raise ValueError("not a TpuHNSW checkpoint")
        metric = distance_metric
        if metric is None:
            metric = str(data["metric"])
            if metric == "custom":
                raise ValueError(
                    "index was saved with a custom distance callable; pass "
                    "distance_metric= to load()"
                )
        obj = cls(distance_metric=metric, m=int(data["m"]), ef=int(data["ef"]), device=device)
        dev = obj.device
        keys = unpack_keys(data["keys"])
        n_upper = int(data["n_upper"])
        g = hnsw_ops.DeviceGraph(
            points=hnsw_ops.as_points(data["points"], dev),
            adj0=torch.from_numpy(data["adj0"]).to(dev),
            upper_nodes=[torch.from_numpy(data[f"upper_nodes_{i}"].astype(np.int64)).to(dev)
                         for i in range(n_upper)],
            upper_adj=[torch.from_numpy(data[f"upper_adj_{i}"]).to(dev)
                       for i in range(n_upper)],
            entry=int(data["entry"]),
            keys=keys,
            deleted=torch.from_numpy(data["deleted"].astype(bool)).to(dev),
        )
        obj._install(g, len(keys))
        obj._key_to_pos = {k: i for i, k in enumerate(keys) if not obj._deleted_host[i]}
        return obj
