"""ShardedMinHashLSHForest -- document-sharded top-k forest over a mesh.

Port of ``datasketch_tpu/parallel/sharded_forest.py``: the mesh form of
:class:`~datasketch_tpu_torch.models.torch_forest.TorchMinHashLSHForest`.
Each shard owns a run of documents (the JAX package's row layout, nothing
padded) with their per-tree sorted prefix arrays, built on its device; a
query batch goes to every shard, each runs the forest query (prefix walk,
pool rerank on kernel 3) or the exact scan (kernel 2, kernel 4 past k =
128) over its rows, only ``k_pad`` candidates per shard ride the
all_gather, and a stable cross-shard top-k re-ranks them by the same
(prefix depth, Jaccard) key. Scores are the f32 Jaccard estimates, as the
JAX sharded forest returns them.
"""

from __future__ import annotations

from typing import Hashable, Optional, Sequence

import numpy as np
import torch

from datasketch_tpu_torch.models.minhash import MinHash, pow2_at_least
from datasketch_tpu_torch.models.torch_lsh import _as_signature_matrix
from datasketch_tpu_torch.ops import forest_ops, lsh_ops
from datasketch_tpu_torch.parallel.collectives import all_gather_cat, psum
from datasketch_tpu_torch.parallel.mesh import Mesh, fetch_global, rows_per_shard, shard_span
from datasketch_tpu_torch.parallel.sharded_lsh import _empty, gather_ranked
from datasketch_tpu_torch.utils.pipeline import stream_batches

__all__ = ["ShardedMinHashLSHForest"]

_RANKS = ("forest", "jaccard")
_METHODS = ("auto", "forest", "scan")


class ShardedMinHashLSHForest:
    """Top-k Jaccard forest sharded over a mesh axis.

    Args:
        mesh: :class:`~datasketch_tpu_torch.parallel.mesh.Mesh`; documents
            shard over ``shard_axis``.
        num_perm / l / cap / rank / cascade_perm / pool / method: as
            :class:`~datasketch_tpu_torch.models.torch_forest.TorchMinHashLSHForest`
            (``method='auto'`` compares a shard's rows with the walk's
            gather volume; ``'scan'`` with rank ``'forest'`` is refused).
        shard_axis: mesh axis name to shard documents over.
    """

    def __init__(self, mesh: Mesh, num_perm: int = 128, l: int = 8, cap: int = 64,
                 shard_axis: str = "data", rank: str = "forest", cascade_perm=None,
                 pool: int = 0, method: str = "auto"):
        if l <= 0 or num_perm <= 0:
            raise ValueError("num_perm and l must be positive")
        if l > num_perm:
            raise ValueError("l cannot be greater than num_perm")
        if rank not in _RANKS:
            raise ValueError("rank must be 'forest' or 'jaccard'")
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'forest' or 'scan'")
        self.rank = rank
        self.method = method
        self.mesh = mesh
        self.l = l
        self.k = int(num_perm / l)
        self.num_perm = num_perm
        self.width = self.k * self.l
        if cascade_perm is not None and cascade_perm < self.width:
            raise ValueError("cascade_perm must be >= the prefix width k*l")
        self.cascade_perm = cascade_perm
        self.score_width = cascade_perm if cascade_perm else self.width
        if pool < 0:
            raise ValueError("pool must be >= 0")
        self.pool = pool
        self.cap = cap
        self.shard_axis = shard_axis
        self.n_shards = mesh.shape[shard_axis]
        self._keys: list = []
        self._key_set: set = set()
        self._shards = None  # s -> (sigs, sorted_fps, sorted_ids LOCAL ids) or None
        self._n_real = 0
        self._rows = 0
        self.last_truncated = 0

    # ------------------------------------------------------------- building

    def index_tokens(self, keys: Sequence[Hashable], token_docs, seed: int = 1) -> None:
        """Bulk-build from pre-tokenized integer documents, ids hashed on the
        card (kernel 1, ``hashfunc="device"``). Query with
        ``hashfunc="device"`` sketches at equal seed."""
        if len(keys) != len(token_docs):
            raise ValueError("keys and token_docs must have equal length")
        self.index(keys, MinHash.bulk_signatures(
            token_docs, num_perm=self.score_width, seed=seed, hashfunc="device",
            out="device", device=self.mesh.home))

    def index_text(self, keys: Sequence[Hashable], texts, k: int = 9, seed: int = 1) -> None:
        """Bulk-build from raw text, k-byte shingles hashed on the card.
        Query with ``MinHash.bulk_from_text(..., hashfunc="device")``
        sketches at equal ``(k, seed)``."""
        if len(keys) != len(texts):
            raise ValueError("keys and texts must have equal length")
        self.index(keys, MinHash.bulk_from_text(
            texts, k=k, num_perm=self.score_width, seed=seed, hashfunc="device",
            out="device", device=self.mesh.home))

    def index(self, keys: Sequence[Hashable], minhashes) -> None:
        """Bulk-build (or extend) the sharded forest; calling again
        re-shards the grown corpus."""
        keys = list(keys)
        sigs = _as_signature_matrix(minhashes, self.mesh.home)
        if sigs.shape[0] != len(keys):
            raise ValueError("keys and minhashes must have equal length")
        if sigs.shape[0] and sigs.shape[1] < self.score_width:
            raise ValueError("The num_perm of MinHash out of range")
        seen = set()
        for kk in keys:
            if kk in self._key_set or kk in seen:
                raise ValueError("The given key has already been added")
            seen.add(kk)
        self._key_set.update(seen)
        sigs = sigs.reshape(sigs.shape[0], -1)[:, : self.score_width]
        if self._n_real:
            sigs = torch.cat([self._all_sigs(), sigs])
        self._keys.extend(keys)
        self._build(sigs.contiguous())

    def _build(self, sigs: torch.Tensor) -> None:
        """Each of this rank's shards sorts its own trees on its device
        (ids local to the shard)."""
        n = sigs.shape[0]
        self._n_real = n
        self._rows = rows_per_shard(n, self.n_shards)
        self._shards = {}
        for s in self.mesh.local_shards(self.shard_axis):
            lo, hi = shard_span(n, self._rows, s)
            if hi == lo:
                self._shards[s] = None
                continue
            part = sigs[lo:hi].to(self.mesh.shard_device(self.shard_axis, s)).contiguous()
            fps, ids = forest_ops.build_forest(forest_ops.prefix_fingerprints(part, self.l,
                                                                              self.k))
            self._shards[s] = (part, fps, ids)

    def _shard_rows(self) -> list:
        return [hi - lo for lo, hi in (shard_span(self._n_real, self._rows, s)
                                       for s in range(self.n_shards))]

    def _host_sigs(self) -> np.ndarray:
        """uint32[N, score_width] host copy (a collective across processes)."""
        home = self.mesh.home
        local = {s: (t[0] if t is not None else
                     torch.zeros((0, self.score_width), dtype=torch.int32, device=home))
                 for s, t in self._shards.items()}
        return fetch_global(self.mesh, self.shard_axis, local, self._shard_rows()).view(np.uint32)

    def _all_sigs(self) -> torch.Tensor:
        if self.mesh.is_multiprocess:
            return torch.from_numpy(self._host_sigs().view(np.int32)).to(self.mesh.home)
        return torch.cat([t[0].to(self.mesh.home) for t in self._shards.values()
                          if t is not None])

    # -------------------------------------------------------------- queries

    def _resolve_method(self, method: str, rank: str, q_pad: int) -> str:
        """'auto' is the scan for rank 'jaccard' when a shard's rows are no
        more than the walk's gather volume ``q_pad * l * k * cap``."""
        if method == "auto":
            if rank != "jaccard":
                return "forest"
            walk_slots = q_pad * self.l * self.k * self.cap
            return "scan" if self._rows <= walk_slots else "forest"
        if method == "scan" and rank == "forest":
            # the JAX sharded forest answers this pair in Jaccard order
            # silently; the port refuses it, as its single-device forest does
            raise ValueError(
                "method='scan' orders by Jaccard only; rank='forest' (prefix depth "
                "first) needs method='forest' or 'auto'"
            )
        return method

    def query(self, minhash, k: int, rank: Optional[str] = None,
              method: Optional[str] = None) -> list:
        """Top-k keys, ordered per the index's ``rank``."""
        return self.query_batch([minhash], k, rank=rank, method=method)[0]

    def query_batch(self, minhashes, k: int, return_scores: bool = False,
                    rank: Optional[str] = None, method: Optional[str] = None) -> list:
        """Top-k for a query batch: one pass over the shards, one all_gather.
        ``rank`` and ``method`` override the index's for this call."""
        out = self._query_dispatch(minhashes, k, rank=rank, method=method)
        if isinstance(out, list):
            return out
        return self._query_finish(out, k, return_scores)

    def query_stream(self, batches, k: int, return_scores: bool = False, depth: int = 4,
                     rank: Optional[str] = None, method: Optional[str] = None):
        """Pipelined :meth:`query_batch` over an iterable of batches, with up
        to ``depth`` batches in flight."""
        if k <= 0:
            raise ValueError("k must be positive")

        def _finish(out):
            if isinstance(out, list):
                return out
            return self._query_finish(out, k, return_scores)

        return stream_batches(
            batches, lambda b: self._query_dispatch(b, k, rank=rank, method=method),
            _finish, depth=depth,
        )

    def _query_dispatch(self, minhashes, k: int, rank: Optional[str] = None,
                        method: Optional[str] = None):
        if k <= 0:
            raise ValueError("k must be positive")
        rank = self.rank if rank is None else rank
        if rank not in _RANKS:
            raise ValueError("rank must be 'forest' or 'jaccard'")
        method = self.method if method is None else method
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'forest' or 'scan'")
        if self._shards is None or not self._n_real:
            return [[] for _ in minhashes]
        q = _as_signature_matrix(minhashes, self.mesh.home)
        if q.shape[0] == 0:
            return []
        if q.shape[1] < self.score_width:
            raise ValueError("The num_perm of MinHash out of range")
        q = q[:, : self.score_width].contiguous()
        nq = q.shape[0]
        q_pad = pow2_at_least(nq, 8)
        k_out = max(8, 1 << (k - 1).bit_length())
        if self._resolve_method(method, rank, q_pad) == "scan":
            ids, scores = {}, {}
            for s, shard in self._shards.items():
                dev = self.mesh.shard_device(self.shard_axis, s)
                if shard is None:
                    ids[s], scores[s] = _empty(nq, k_out, dev)
                    continue
                loc, scores[s] = lsh_ops.topk_scan(shard[0], q.to(dev), k_out)
                ids[s] = torch.where(loc >= 0, loc + s * self._rows, -1)
            g_ids, g_sc = gather_ranked(self.mesh, self.shard_axis, ids, scores, k=k_out)
            return g_ids, g_sc, 0
        packed, trunc = {}, {}
        for s, shard in self._shards.items():
            dev = self.mesh.shard_device(self.shard_axis, s)
            if shard is None:
                ids, jac = _empty(nq, k_out, dev)
                lev = torch.zeros((nq, k_out), dtype=torch.int32, device=dev)
                trunc[s] = 0
            else:
                sigs, fps, sorted_ids = shard
                ids, jac, lev, trunc[s] = forest_ops.forest_query_fused(
                    fps, sorted_ids, sigs, q.to(dev), self.l, self.k, self.cap, k_out,
                    pool=self.pool, rank=rank, zero_rows=q_pad - nq,
                )
                ids = torch.where(ids >= 0, ids + s * self._rows, -1)
            packed[s] = torch.stack([ids.to(torch.int32), jac.view(torch.int32),
                                     lev.to(torch.int32)])
        g = all_gather_cat(self.mesh, self.shard_axis, packed, dim=2)
        g_ids, g_jac, g_lev = g[0], g[1].view(torch.float32), g[2]
        # the single-device forest's ranking key; shard-disjoint global ids
        # need no dedupe
        if rank == "forest":
            score = torch.where(g_ids >= 0, 2.0 * g_lev.to(torch.float32) + g_jac, -1.0)
        else:
            score = torch.where(g_ids >= 0, g_jac, -1.0)
        top_sc, pos = torch.sort(score, dim=1, descending=True, stable=True)
        top_sc, pos = top_sc[:, :k_out], pos[:, :k_out]
        top_ids = torch.where(top_sc >= 0, torch.gather(g_ids, 1, pos), -1)
        return top_ids, torch.gather(g_jac, 1, pos), psum(self.mesh, trunc)

    def _query_finish(self, out, k: int, return_scores: bool) -> list:
        ids, jac, trunc = out
        self.last_truncated = int(trunc)
        result = []
        for row_ids, row_jac in zip(ids[:, :k].cpu().tolist(), jac[:, :k].cpu().tolist()):
            hits = [(self._keys[i], s) for i, s in zip(row_ids, row_jac) if i >= 0]
            result.append(hits if return_scores else [kk for kk, _ in hits])
        return result

    def warmup(self, batch_sizes=(8, 64), k: int = 10) -> None:
        """One synthetic :meth:`query_batch` per batch size; no-op while empty."""
        if self._shards is None or not self._n_real:
            return
        rng = np.random.RandomState(0)
        for q in batch_sizes:
            sigs = rng.randint(0, 1 << 32, size=(int(q), self.score_width),
                               dtype=np.uint64).astype(np.uint32)
            self.query_batch(sigs, k)

    # ------------------------------------------------------------- plumbing

    def __contains__(self, key: Hashable) -> bool:
        return key in self._key_set

    def __len__(self) -> int:
        return len(self._keys)

    def is_empty(self) -> bool:
        return self._n_real == 0

    def status(self) -> dict:
        """Shard count, indexed rows and the device bytes of this rank's
        shards (nothing padded)."""
        out = {
            "n_shards": self.n_shards,
            "n_indexed": len(self._keys),
            "n_padded": 0,
            "trees": self.l,
            "prefix_len": self.k,
            "cap": self.cap,
            "last_truncated": self.last_truncated,
            "device_bytes": 0,
        }
        if self._shards is not None:
            out["device_bytes"] = int(sum(x.numel() * x.element_size()
                                          for t in self._shards.values() if t is not None
                                          for x in t))
        return out

    # ---------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        """Persist signatures and keys as ``.npz`` in the forest layout of
        both packages; trees are rebuilt (and re-sharded) on load. A
        collective across processes."""
        from datasketch_tpu_torch.persist import atomic_savez, pack_keys

        sigs = (self._host_sigs() if self._shards is not None
                else np.zeros((0, self.score_width), dtype=np.uint32))
        atomic_savez(
            path,
            sigs=sigs,
            keys=pack_keys(self._keys),
            params=np.array(
                [self.num_perm, self.l, self.cap, int(self.rank == "jaccard"),
                 self.cascade_perm or 0, self.pool, _METHODS.index(self.method)],
                dtype=np.int64,
            ),
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh, shard_axis: str = "data") -> "ShardedMinHashLSHForest":
        """Load a forest checkpoint of either package (sharded or not) onto
        ``mesh``.

        SECURITY: the key list inside the file is a pickle payload -- only
        load index files you created or trust.
        """
        from datasketch_tpu_torch.persist import npz_path, unpack_keys

        data = np.load(npz_path(path), allow_pickle=False)
        params = [int(x) for x in data["params"]]
        num_perm, l, cap = params[:3]
        rank = "jaccard" if len(params) > 3 and params[3] else "forest"
        cascade = params[4] if len(params) > 4 and params[4] else None
        pool = params[5] if len(params) > 5 else 0
        method = _METHODS[params[6]] if len(params) > 6 else "auto"
        forest = cls(mesh, num_perm=num_perm, l=l, cap=cap, shard_axis=shard_axis, rank=rank,
                     cascade_perm=cascade, pool=pool, method=method)
        keys = unpack_keys(data["keys"])
        if keys:
            forest._keys = keys
            forest._key_set = set(keys)
            sigs = np.ascontiguousarray(data["sigs"], dtype=np.uint32)
            forest._build(torch.from_numpy(sigs.view(np.int32)).to(mesh.home))
        return forest
