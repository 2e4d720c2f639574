"""ShardedHNSW -- document-sharded ANN graph serving over a mesh.

Port of ``datasketch_tpu/parallel/sharded_hnsw.py``: the corpus shards over
a mesh axis, each shard builds its own NSW graph over its slice
(:func:`~datasketch_tpu_torch.ops.knn_graph.build_nsw_graph`, seed ``7 +
shard``), a query batch goes to every shard, each runs the masked beam
search of :mod:`datasketch_tpu_torch.ops.hnsw_ops` over its graph, only
``k_pad`` candidates per shard ride the all_gather, and a stable merge by
distance takes the top k.

This is the one sharded index of the port that pads. The JAX package
fills the corpus up to its power-of-two row layout with points drawn
uniformly in the data's bounding box (``RandomState(n_pad & 0x7FFFFFFF)``,
float32): they sit in the shards' graphs, where they route queries but
are barred from results by the deleted mask, so they change the graphs
and the answers. The port draws the same filler in the same dtype steps.

Points are float32, as the JAX class converts them (``index_tokens``'
uint32 signatures too). Under ``minhash_jaccard`` a distance only asks
whether two float32 values are equal, which is whether their bits are
equal (-0.0 is folded into +0.0 first), so each shard's points are held
as their int32 bit patterns and the kNN rows of the build run on kernel 2.
"""

from __future__ import annotations

from typing import Callable, Hashable, Optional, Sequence, Union

import numpy as np
import torch

from datasketch_tpu_torch.device import to_numpy_u32
from datasketch_tpu_torch.ops import hnsw_ops, knn_graph
from datasketch_tpu_torch.parallel.collectives import all_gather_cat
from datasketch_tpu_torch.parallel.mesh import Mesh, rows_per_shard
from datasketch_tpu_torch.utils.pipeline import stream_batches

__all__ = ["ShardedHNSW"]


def _float_points(points) -> np.ndarray:
    """[N, D] float32 on the host, as ``np.asarray(points, np.float32)``."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    return np.asarray(points, dtype=np.float32)


class ShardedHNSW:
    """Device ANN index sharded over a mesh axis.

    Args:
        mesh: :class:`~datasketch_tpu_torch.parallel.mesh.Mesh`; documents
            shard over ``shard_axis``.
        distance_metric / m / ef / level_ratio / tile: as
            :class:`~datasketch_tpu_torch.models.torch_hnsw.TorchHNSW`.
        shard_axis: mesh axis name to shard documents over.
    """

    def __init__(self, mesh: Mesh, distance_metric: Union[str, Callable] = "l2",
                 m: int = 16, ef: int = 64, level_ratio: int = 8, tile: int = 256,
                 shard_axis: str = "data"):
        if m < 2:
            raise ValueError("m must be at least 2")
        self.mesh = mesh
        self.metric = distance_metric
        self.m = m
        self.ef = ef
        self.level_ratio = level_ratio
        self.tile = tile
        self.shard_axis = shard_axis
        self.n_shards = mesh.shape[shard_axis]
        self._keys: list = []  # corpus order, tombstoned included
        self._key_to_pos: dict = {}  # live keys only
        self._points_host: Optional[np.ndarray] = None  # float32[n_real, D]
        self._deleted_real: Optional[np.ndarray] = None  # bool[n_real]
        self._n_real = 0
        self._local_n = 0
        self._graphs: dict = {}  # s -> DeviceGraph over the shard's L rows

    # ------------------------------------------------------------- building

    def _require_minhash_metric(self, name: str) -> None:
        if self.metric != "minhash_jaccard":
            raise ValueError(
                "%s requires distance_metric='minhash_jaccard' (points are MinHash "
                "signatures)" % name
            )

    def index_tokens(self, keys: Sequence[Hashable], token_docs, num_perm: int = 128,
                     seed: int = 1) -> None:
        """Bulk-build the shards' graphs from pre-tokenized integer documents
        (ids hashed on the card by kernel 1). Requires
        ``distance_metric='minhash_jaccard'``."""
        self._require_minhash_metric("index_tokens")
        if len(keys) != len(token_docs):
            raise ValueError("keys and token_docs must have equal length")
        from datasketch_tpu_torch.models.minhash import MinHash

        sigs = MinHash.bulk_signatures(token_docs, num_perm=num_perm, seed=seed,
                                       hashfunc="device", out="device", device=self.mesh.home)
        self.index(keys, to_numpy_u32(sigs))

    def index_text(self, keys: Sequence[Hashable], texts, k: int = 9, num_perm: int = 128,
                   seed: int = 1) -> None:
        """Bulk-build the shards' graphs from raw text (k-byte shingles
        hashed on the card). Requires ``distance_metric='minhash_jaccard'``."""
        self._require_minhash_metric("index_text")
        if len(keys) != len(texts):
            raise ValueError("keys and texts must have equal length")
        from datasketch_tpu_torch.models.minhash import MinHash

        sigs = MinHash.bulk_from_text(texts, k=k, num_perm=num_perm, seed=seed,
                                      hashfunc="device", out="device", device=self.mesh.home)
        self.index(keys, to_numpy_u32(sigs))

    def index(self, keys: Sequence[Hashable], points) -> None:
        """Bulk (re)build the sharded graphs from (keys, points); calling
        again re-shards the grown corpus and drops tombstoned keys."""
        keys = list(keys)
        pts = _float_points(points)
        if pts.ndim != 2 or pts.shape[0] != len(keys):
            raise ValueError("keys and points must have equal length")
        seen = set()
        for k in keys:
            if k in self._key_to_pos or k in seen:
                raise ValueError("The given key already exists: %r" % (k,))
            seen.add(k)
        if self._n_real:
            live = [k for k in self._keys if k in self._key_to_pos]
            old_pts = self._points_host[[self._key_to_pos[k] for k in live]]
            keys = live + keys
            pts = np.concatenate([old_pts, pts], axis=0)
        self._keys = keys
        self._key_to_pos = {k: i for i, k in enumerate(keys)}
        self._points_host = pts
        self._deleted_real = np.zeros(len(keys), dtype=bool)
        self._n_real = len(keys)
        self._build()

    def _device_points(self, pts: np.ndarray, device) -> torch.Tensor:
        """float32 points on ``device``; under ``minhash_jaccard`` their
        int32 bit patterns (equal values, equal bits)."""
        if self.metric == "minhash_jaccard":
            pts = np.ascontiguousarray(pts + np.float32(0.0)).view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(pts)).to(device)

    def _build(self) -> None:
        pts = self._points_host
        n, d = pts.shape
        s_count = self.n_shards
        local_n = rows_per_shard(n, s_count)
        n_pad = local_n * s_count
        if n_pad != n:
            # the JAX package's filler: uniform points in the data's
            # bounding box, routable but masked from results, never copies
            # of real points (a distance-0 clone would take a real point's
            # in-edges in the diversity pruning)
            rng = np.random.RandomState(n_pad & 0x7FFFFFFF)
            lo, hi = pts.min(axis=0), pts.max(axis=0)
            span = np.where(hi > lo, hi - lo, 1.0)
            filler = rng.random_sample((n_pad - n, d)).astype(np.float32) * span + lo
            pts_pad = np.concatenate([pts, filler], axis=0)
        else:
            pts_pad = pts
        self._local_n = local_n
        self._graphs = {}
        for s in self.mesh.local_shards(self.shard_axis):
            dev = self.mesh.shard_device(self.shard_axis, s)
            shard_pts = self._device_points(pts_pad[s * local_n: (s + 1) * local_n], dev)
            self._graphs[s] = knn_graph.build_nsw_graph(
                shard_pts, m=self.m, metric=self.metric, tile=self.tile,
                level_ratio=self.level_ratio, seed=7 + s,
            )
        self._upload_deleted()

    def _upload_deleted(self) -> None:
        """Each shard's deleted mask: tombstones, and every filler row."""
        mask = np.ones(self.n_shards * self._local_n, dtype=bool)
        mask[: self._n_real] = self._deleted_real
        for s, g in self._graphs.items():
            g.deleted = torch.from_numpy(
                mask[s * self._local_n: (s + 1) * self._local_n].copy()).to(g.points.device)

    # ------------------------------------------------------------ mutation

    def remove(self, key: Hashable) -> None:
        """Tombstone ``key``: masked from every query (soft delete)."""
        if key not in self._key_to_pos:
            raise ValueError("The given key does not exist")
        pos = self._key_to_pos.pop(key)
        self._deleted_real[pos] = True
        self._upload_deleted()

    # --------------------------------------------------------------- query

    def query(self, point, k: int = 10, ef: Optional[int] = None) -> list:
        """(key, distance) pairs for one query, nearest first."""
        return self.query_batch(_float_points(point)[None, :], k, ef)[0]

    def query_batch(self, points, k: int = 10, ef: Optional[int] = None) -> list:
        """One pass over the shards, one k-wide all_gather, one fetch."""
        out = self._query_dispatch(points, k, ef)
        if isinstance(out, list):
            return out
        return self._query_finish(out, k)

    def query_stream(self, batches, k: int = 10, ef: Optional[int] = None, depth: int = 4):
        """Pipelined :meth:`query_batch` over an iterable of batches."""
        return stream_batches(
            batches,
            lambda b: self._query_dispatch(b, k, ef),
            lambda o: o if isinstance(o, list) else self._query_finish(o, k),
            depth=depth,
        )

    def _query_dispatch(self, points, k: int, ef: Optional[int]):
        if k <= 0:
            raise ValueError("k must be positive")
        q = _float_points(points)
        if self._points_host is None:
            return [[] for _ in range(q.shape[0])]
        if q.shape[0] == 0:
            return []
        ef = self.ef if ef is None else ef
        k_out = max(8, 1 << (k - 1).bit_length())
        ef = max(ef, k_out)
        dist = hnsw_ops.distance_fn(self.metric)
        big = hnsw_ops.BIG
        packed = {}
        for s, g in self._graphs.items():
            ids, dists = hnsw_ops.search(g, self._device_points(q, g.points.device), dist,
                                         k_out, ef, ef)
            gids = torch.where(ids >= 0, ids + s * self._local_n, -1)
            dists = torch.where(gids >= 0, dists, big)
            packed[s] = torch.stack([gids.to(torch.int32), dists.contiguous().view(torch.int32)])
        g = all_gather_cat(self.mesh, self.shard_axis, packed, dim=2)
        g_ids, g_d = g[0], g[1].view(torch.float32)
        # merge by distance, ties to the lower shard; shard-disjoint ids
        top_d, pos = torch.sort(g_d, dim=1, stable=True)
        top_d = top_d[:, :k_out]
        top_ids = torch.gather(g_ids, 1, pos[:, :k_out])
        return torch.where(top_d < 1e37, top_ids, -1), top_d

    def _query_finish(self, out, k: int) -> list:
        ids, dists = (t.cpu().numpy() for t in out)
        return hnsw_ops.result_rows(self._keys, ids[:, :k], dists[:, :k])

    def warmup(self, batch_sizes=(8, 64), k: int = 10) -> None:
        """One synthetic query per batch size; no-op while empty."""
        if self._points_host is None or not self._n_real:
            return
        rng = np.random.RandomState(0)
        dim = self._points_host.shape[1]
        for q in batch_sizes:
            self.query_batch(rng.standard_normal((int(q), dim)).astype(np.float32), k)

    # ------------------------------------------------------------- plumbing

    def __contains__(self, key: Hashable) -> bool:
        return key in self._key_to_pos

    def __len__(self) -> int:
        return len(self._key_to_pos)

    def is_empty(self) -> bool:
        return len(self) == 0

    def status(self) -> dict:
        """Shard layout, live and tombstoned points, graph levels and the
        device bytes of this rank's shards' points and base adjacency."""
        levels = 1 + (len(next(iter(self._graphs.values())).upper_nodes)
                      if self._graphs else 0)
        return {
            "n_shards": self.n_shards,
            "n_indexed": self._n_real,
            "live": len(self._key_to_pos),
            "tombstoned": int(self._deleted_real.sum()) if self._deleted_real is not None
            else 0,
            "levels": levels,
            "local_n": self._local_n,
            "device_bytes": int(sum(g.points.numel() * g.points.element_size()
                                    + g.adj0.numel() * g.adj0.element_size()
                                    for g in self._graphs.values())),
        }

    # ---------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        """Persist points, keys and tombstones as ``.npz`` in the JAX
        package's ``sharded_hnsw`` layout; graphs rebuild (re-sharded to the
        loading mesh) on load."""
        from datasketch_tpu_torch.persist import atomic_savez, pack_keys

        if self._points_host is None:
            raise ValueError("Cannot save an empty index")
        atomic_savez(
            path,
            kind=np.array("sharded_hnsw"),
            metric=np.array(self.metric if isinstance(self.metric, str) else "custom"),
            points=self._points_host,
            deleted=self._deleted_real,
            keys=pack_keys(self._keys),
            params=np.array([self.m, self.ef, self.level_ratio, self.tile], dtype=np.int64),
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh, shard_axis: str = "data",
             distance_metric: Optional[Union[str, Callable]] = None) -> "ShardedHNSW":
        """Load a ``sharded_hnsw`` checkpoint of either package onto ``mesh``.

        SECURITY: the key list inside the file is a pickle payload -- only
        load index files you created or trust.
        """
        from datasketch_tpu_torch.persist import npz_path, unpack_keys

        data = np.load(npz_path(path), allow_pickle=False)
        if str(data["kind"]) != "sharded_hnsw":
            raise ValueError("not a ShardedHNSW checkpoint")
        metric = distance_metric
        if metric is None:
            metric = str(data["metric"])
            if metric == "custom":
                raise ValueError(
                    "index was saved with a custom distance callable; pass "
                    "distance_metric= to load()"
                )
        m, ef, level_ratio, tile = (int(x) for x in data["params"])
        obj = cls(mesh, distance_metric=metric, m=m, ef=ef, level_ratio=level_ratio, tile=tile,
                  shard_axis=shard_axis)
        keys = unpack_keys(data["keys"])
        if keys:
            deleted = data["deleted"].astype(bool)
            obj._keys = keys
            obj._key_to_pos = {k: i for i, k in enumerate(keys) if not deleted[i]}
            obj._points_host = data["points"].astype(np.float32)
            obj._deleted_real = deleted
            obj._n_real = len(keys)
            obj._build()
        return obj
