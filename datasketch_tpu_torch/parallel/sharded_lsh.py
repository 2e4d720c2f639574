"""ShardedMinHashLSH -- document-sharded LSH index over a mesh.

Port of ``datasketch_tpu/parallel/sharded_lsh.py``. Each shard of the
shard axis owns a run of documents' signatures and their band tables; a
query batch goes to every shard, each probes its tables and reranks on
its own (kernels 1-4 through :mod:`datasketch_tpu_torch.ops.lsh_ops`), and
the candidates come back through one all_gather.

The JAX index pads its rows with random filler to a power-of-two multiple
of the shard count; this one pads nothing. Shard s holds the real rows
``[s*L, min((s+1)*L, n))`` where ``L`` is JAX's rows per shard
(:func:`~datasketch_tpu_torch.parallel.mesh.rows_per_shard`), so the last
shards may be short or empty, and every decision JAX takes from its padded
shape (global ids, ``auto``, the scan's result cap) reads ``L``. An empty
shard answers nothing and still takes part in every collective. Answers,
their order and ``last_truncated`` equal the JAX index's on a mesh of the
same shape.
"""

from __future__ import annotations

from typing import Hashable, Optional, Sequence

import numpy as np
import torch

from datasketch_tpu_torch.models.lsh_params import optimal_param
from datasketch_tpu_torch.models.minhash import MinHash
from datasketch_tpu_torch.models.torch_lsh import _as_signature_matrix, _batch_rows, _decode_rows
from datasketch_tpu_torch.ops import lsh_ops
from datasketch_tpu_torch.parallel.collectives import all_gather_cat, pmax, psum
from datasketch_tpu_torch.parallel.mesh import (
    Mesh,
    fetch_global,
    rows_per_shard,
    shard_span,
)
from datasketch_tpu_torch.utils.pipeline import stream_batches

__all__ = ["ShardedMinHashLSH", "gather_ranked"]

_METHODS = ("auto", "bands", "scan")


def gather_ranked(mesh: Mesh, axis: str, ids: dict, scores: dict, k=None):
    """All-gather each shard's (ids int32[Q, c], scores f32[Q, c]) and order
    the pool by score with a stable sort, so ties keep shard order (JAX's
    stable ``argsort`` and ``lax.top_k``, whose lowest position wins).
    With ``k``, keep the first k and mark slots scoring below 0 empty
    (-1), as the JAX top-k merges do. Returns (ids, scores) on the home
    device."""
    packed = {s: torch.stack([ids[s].to(torch.int32), scores[s].view(torch.int32)])
              for s in ids}
    g = all_gather_cat(mesh, axis, packed, dim=2)
    g_ids, g_sc = g[0], g[1].view(torch.float32)
    g_sc, order = torch.sort(g_sc, dim=1, descending=True, stable=True)
    g_ids = torch.gather(g_ids, 1, order)
    if k is not None:
        g_ids, g_sc = g_ids[:, :k], g_sc[:, :k]
        g_ids = torch.where(g_sc >= 0, g_ids, -1)
    return g_ids, g_sc


def _valid_prefix(ids: torch.Tensor, scores: torch.Tensor):
    """A ranked threshold pool cut to its longest row of valid slots (valid
    slots score >= 0 and sort first), so the copy to the host carries S x
    fewer empty slots: one scalar read."""
    width = int((ids >= 0).sum(dim=1).max()) if ids.numel() else 0
    return ids[:, :width], scores[:, :width]


def _empty(nq: int, width: int, device):
    """An empty shard's answer: ids -1, scores -1.0."""
    return (torch.full((nq, width), -1, dtype=torch.int32, device=device),
            torch.full((nq, width), -1.0, dtype=torch.float32, device=device))


class ShardedMinHashLSH:
    """Jaccard-threshold index sharded over a mesh axis.

    Args:
        mesh: :class:`~datasketch_tpu_torch.parallel.mesh.Mesh`; documents
            shard over ``shard_axis``, on each shard's position's device.
        threshold / num_perm / weights / params: as
            :class:`~datasketch_tpu_torch.models.torch_lsh.TorchMinHashLSH`.
        bucket_cap: per-(query, band, shard) gather cap.
        shard_axis: mesh axis name to shard documents over.
    """

    def __init__(
        self,
        mesh: Mesh,
        threshold: float = 0.9,
        num_perm: int = 128,
        weights: tuple = (0.5, 0.5),
        params: Optional[tuple] = None,
        bucket_cap: int = 128,
        rerank: bool = True,
        shard_axis: str = "data",
        max_results: Optional[int] = None,
    ):
        if threshold > 1.0 or threshold < 0.0:
            raise ValueError("threshold must be in [0.0, 1.0]")
        self.mesh = mesh
        self.threshold = threshold
        self.h = num_perm
        if params is not None:
            self.b, self.r = params
            if self.b * self.r > num_perm:
                raise ValueError("b*r must be <= num_perm")
        else:
            self.b, self.r = optimal_param(threshold, num_perm, *weights)
        self.bucket_cap = bucket_cap
        self.rerank = rerank
        self.max_results = max_results
        self.shard_axis = shard_axis
        self.n_shards = mesh.shape[shard_axis]

        self._keys: list = []
        self._key_to_pos: dict = {}
        self._shards = None  # s -> (sigs int32[n_s, P], sorted_fp, sorted_ids) or None
        self._n_real = 0
        self._rows = 0  # L: global rows each shard owns
        self._alive = None  # host bool[N_real] tombstones (False = removed)
        self._alive_local = None  # cached s -> device bool[n_s] or None (all alive)
        self.last_truncated = 0

    # ------------------------------------------------------------------ build

    def index(self, keys: Sequence[Hashable], minhashes) -> None:
        """Bulk-build from parallel (keys, minhashes); re-shardable by calling again."""
        keys = list(keys)
        sigs = _as_signature_matrix(minhashes, self.mesh.home)
        if sigs.shape[0] != len(keys):
            raise ValueError("keys and minhashes must have equal length")
        if sigs.shape[0] and sigs.shape[1] != self.h:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.h, sigs.shape[1])
            )
        seen = set()
        for k in keys:
            if k in self._key_to_pos or k in seen:
                raise ValueError("The given key already exists: %r" % (k,))
            seen.add(k)
        base = len(self._keys)
        for i, k in enumerate(keys):
            self._key_to_pos[k] = base + i
        self._keys.extend(keys)
        old_alive = self._alive
        if self._shards is not None:
            # one process: concatenated on the card, the corpus never
            # round-trips the host; across processes it is collected once
            sigs = torch.cat([self._all_sigs(), sigs.reshape(-1, self.h)])
        self._build(sigs)
        self._alive = np.ones(self._n_real, dtype=bool)
        if old_alive is not None:
            self._alive[: old_alive.shape[0]] = old_alive

    def index_tokens(self, keys: Sequence[Hashable], token_docs, seed: int = 1,
                     scheme: str = "permutation") -> None:
        """Bulk-build from pre-tokenized integer documents: the ids are hashed
        on the card (kernel 1, ``hashfunc="device"``) and the signatures stay
        there. Query with sketches built the same way at equal seed."""
        self.index(keys, MinHash.bulk_signatures(
            token_docs, scheme=scheme, num_perm=self.h, seed=seed, hashfunc="device",
            out="device", device=self.mesh.home,
        ))

    def index_text(self, keys: Sequence[Hashable], texts, k: int = 9, seed: int = 1) -> None:
        """Bulk-build from raw text, k-byte shingles hashed on the card.
        Query with ``MinHash.bulk_from_text(..., hashfunc="device")``
        sketches at equal ``(k, seed)``."""
        if len(keys) != len(texts):
            raise ValueError("keys and texts must have equal length")
        self.index(keys, self._text_query_sigs(texts, k, seed))

    def _token_query_sigs(self, token_docs, seed: int) -> torch.Tensor:
        return MinHash.bulk_signatures(token_docs, num_perm=self.h, seed=seed,
                                       hashfunc="device", out="device", device=self.mesh.home)

    def _text_query_sigs(self, texts, shingle_k: int, seed: int) -> torch.Tensor:
        return MinHash.bulk_from_text(texts, k=shingle_k, num_perm=self.h, seed=seed,
                                      hashfunc="device", out="device", device=self.mesh.home)

    def query_tokens(self, token_docs, seed: int = 1, **kwargs) -> list:
        """Threshold query from pre-tokenized integer documents; kwargs pass
        to :meth:`query_batch`."""
        return self.query_batch(self._token_query_sigs(token_docs, seed), **kwargs)

    def top_k_tokens(self, token_docs, k: int, seed: int = 1, **kwargs) -> list:
        """Top-k from pre-tokenized integer documents; kwargs pass to :meth:`top_k`."""
        return self.top_k(self._token_query_sigs(token_docs, seed), k, **kwargs)

    def query_text(self, texts, shingle_k: int = 9, seed: int = 1, **kwargs) -> list:
        """Threshold query from raw texts; kwargs pass to :meth:`query_batch`."""
        return self.query_batch(self._text_query_sigs(texts, shingle_k, seed), **kwargs)

    def top_k_text(self, texts, k: int, shingle_k: int = 9, seed: int = 1, **kwargs) -> list:
        """Top-k from raw texts; kwargs pass to :meth:`top_k`."""
        return self.top_k(self._text_query_sigs(texts, shingle_k, seed), k, **kwargs)

    def _build(self, sigs: torch.Tensor) -> None:
        """Split the rows over this rank's shards and build each shard's
        band tables on its device."""
        n = sigs.shape[0]
        self._n_real = n
        self._rows = rows_per_shard(n, self.n_shards)
        self._shards = {}
        for s in self.mesh.local_shards(self.shard_axis):
            lo, hi = shard_span(n, self._rows, s)
            part = sigs[lo:hi].to(self.mesh.shard_device(self.shard_axis, s)).contiguous()
            if hi > lo:
                fps = lsh_ops.band_fingerprints(part, self.b, self.r)
                self._shards[s] = (part,) + lsh_ops.build_tables(fps)
            else:
                self._shards[s] = None
        self._alive_local = None

    def _shard_rows(self) -> list:
        return [hi - lo for lo, hi in (shard_span(self._n_real, self._rows, s)
                                       for s in range(self.n_shards))]

    def _all_sigs(self) -> torch.Tensor:
        """Every shard's rows in order, on the home device (one process),
        or through the host (a collective across processes)."""
        if not self.mesh.is_multiprocess:
            home = self.mesh.home
            parts = [self._shards[s][0].to(home) for s in range(self.n_shards)
                     if self._shards[s] is not None]
            return (torch.cat(parts) if parts
                    else torch.zeros((0, self.h), dtype=torch.int32, device=home))
        host = self._to_host()
        return torch.from_numpy(host.view(np.int32)).to(self.mesh.home)

    # ----------------------------------------------------------- mutation

    def remove(self, key: Hashable) -> None:
        """Tombstone ``key``: masked from every query, space reclaimed by
        :meth:`compact`."""
        if key not in self._key_to_pos:
            raise ValueError("The given key does not exist")
        pos = self._key_to_pos.pop(key)
        self._alive[pos] = False
        self._keys[pos] = None
        self._alive_local = None

    def merge(self, other, check_overlap: bool = False) -> None:
        """Union another sharded index (or a ``TorchMinHashLSH``) into this
        one: both corpora concatenated, one re-shard and rebuild."""
        if (self.h, self.b, self.r) != (other.h, other.b, other.r):
            raise ValueError(
                "Cannot merge indexes with different initialization parameters."
            )
        flush = getattr(other, "_flush_pending", None)
        if flush is not None:
            flush()
        other_keys = other._keys
        if check_overlap and set(self._key_to_pos) & {k for k in other_keys if k is not None}:
            raise ValueError("The keys are overlapping, duplicate key exists.")
        other_n = other._n_real
        if not other_n:
            return
        other_sigs = (other._all_sigs() if isinstance(other, ShardedMinHashLSH)
                      else other._sigs)
        base = len(self._keys)
        for i, k in enumerate(other_keys):
            if k is not None:
                self._key_to_pos[k] = base + i
        self._keys.extend(other_keys)
        old_alive, other_alive = self._alive, other._alive
        other_sigs = other_sigs[:other_n].to(self.mesh.home)
        merged = (other_sigs if self._shards is None
                  else torch.cat([self._all_sigs(), other_sigs]))
        n_self = 0 if old_alive is None else old_alive.shape[0]
        self._build(merged)
        self._alive = np.ones(self._n_real, dtype=bool)
        if old_alive is not None:
            self._alive[:n_self] = old_alive
        if other_alive is not None:
            self._alive[n_self: n_self + other_alive.shape[0]] = other_alive

    def status(self) -> dict:
        """Health counters: shard layout, live and tombstoned rows, bucket
        occupancy against ``bucket_cap`` (the longest run of any band of any
        shard), and the device bytes of this rank's shards. Nothing is
        padded (``n_padded`` 0). A collective across processes."""
        n_live = len(self._key_to_pos)
        out = {
            "n_shards": self.n_shards,
            "n_live": n_live,
            "n_tombstoned": self._n_real - n_live,
            "n_padded": 0,
            "rows_per_shard": 0,
            "bands": self.b,
            "rows_per_band": self.r,
            "bucket_cap": self.bucket_cap,
            "last_truncated": self.last_truncated,
            "device_bytes": 0,
            "max_bucket": 0,
        }
        if self._shards is not None:
            out["rows_per_shard"] = self._rows
            live = [t for t in self._shards.values() if t is not None]
            out["device_bytes"] = int(sum(x.numel() * x.element_size()
                                          for t in live for x in t))
            runs = {s: lsh_ops.bucket_stats(t[1])[0].max()
                    for s, t in self._shards.items() if t is not None}
            if runs or self.mesh.is_multiprocess:
                out["max_bucket"] = int(pmax(self.mesh, runs or {None: 0}))
        return out

    def compact(self) -> None:
        """Drop tombstoned rows and rebuild the shard tables (one process:
        the surviving rows are gathered on the card)."""
        if self._shards is None or self._alive is None or self._alive.all():
            return
        live = np.nonzero(self._alive)[0]
        sigs = self._all_sigs()[torch.from_numpy(live).to(self.mesh.home)]
        self._keys = [self._keys[i] for i in live]
        self._key_to_pos = {k: i for i, k in enumerate(self._keys)}
        self._build(sigs)
        self._alive = np.ones(self._n_real, dtype=bool)

    # -------------------------------------------------------- persistence

    def _to_host(self) -> np.ndarray:
        """uint32[N_real, P] host copy of every shard's rows; a collective
        across processes (see :func:`~datasketch_tpu_torch.parallel.mesh.
        fetch_global` for the ordering rule)."""
        local = {s: (t[0] if t is not None else
                     torch.zeros((0, self.h), dtype=torch.int32, device=self.mesh.home))
                 for s, t in self._shards.items()}
        return fetch_global(self.mesh, self.shard_axis, local,
                            self._shard_rows()).view(np.uint32)

    def host_snapshot(self) -> dict:
        """Host copy of the queryable state (``{"keys", "sigs", "alive"}``),
        one cross-shard gather; it feeds :class:`datasketch_tpu_torch.
        serving.FailoverIndex`, so a sharded deployment keeps answering
        from the host when the card is unhealthy."""
        sigs = (self._to_host() if self._shards is not None
                else np.zeros((0, self.h), np.uint32))
        alive = None
        if self._alive is not None and not bool(self._alive.all()):
            alive = self._alive.copy()
        return {"keys": list(self._keys), "sigs": sigs, "alive": alive}

    def save(self, path: str) -> None:
        """Persist signatures, keys and tombstones as ``.npz`` in the JAX
        package's sharded layout; shard tables are rebuilt (and re-sharded
        to the loading mesh) on load. A collective across processes."""
        from datasketch_tpu_torch.persist import atomic_savez, pack_keys

        sigs = (self._to_host() if self._shards is not None
                else np.zeros((0, self.h), dtype=np.uint32))
        atomic_savez(
            path,
            sigs=sigs,
            keys=pack_keys(self._keys),
            alive=self._alive if self._alive is not None else np.ones(0, dtype=bool),
            params=np.array([self.h, self.b, self.r, self.bucket_cap, int(self.rerank)],
                            dtype=np.int64),
            threshold=np.float64(self.threshold),
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh, shard_axis: str = "data") -> "ShardedMinHashLSH":
        """Rebuild a sharded checkpoint of either package on ``mesh``; the
        shard count may differ from the saving mesh's.

        SECURITY: the key list inside the file is a pickle payload -- only
        load index files you created or trust.
        """
        from datasketch_tpu_torch.persist import npz_path, unpack_keys

        data = np.load(npz_path(path), allow_pickle=False)
        h, b, r, cap, rerank = (int(x) for x in data["params"])
        index = cls(mesh, threshold=float(data["threshold"]), num_perm=h, params=(b, r),
                    bucket_cap=cap, rerank=bool(rerank), shard_axis=shard_axis)
        keys = unpack_keys(data["keys"])
        if keys:
            index._keys = keys
            index._key_to_pos = {k: i for i, k in enumerate(keys) if k is not None}
            sigs = np.ascontiguousarray(data["sigs"], dtype=np.uint32)
            index._build(torch.from_numpy(sigs.view(np.int32)).to(mesh.home))
            index._alive = data["alive"].astype(bool)
        return index

    # ------------------------------------------------------------------ query

    def __contains__(self, key: Hashable) -> bool:
        return key in self._key_to_pos

    def __len__(self) -> int:
        return len(self._key_to_pos)

    def is_empty(self) -> bool:
        return len(self._key_to_pos) == 0

    def _alive_on(self, s: int):
        """Shard s's live mask on its device, or None when nothing in it is
        tombstoned; cached until a remove / compact / index."""
        if self._alive_local is None:
            self._alive_local = {}
            for t in self._shards:
                lo, hi = shard_span(self._n_real, self._rows, t)
                mask = self._alive[lo:hi]
                self._alive_local[t] = (
                    None if mask.all() else
                    torch.from_numpy(mask.copy()).to(self.mesh.shard_device(self.shard_axis, t))
                )
        return self._alive_local[s]

    def _queries(self, minhashes) -> torch.Tensor:
        q = _as_signature_matrix(minhashes, self.mesh.home)
        if q.shape[1] != self.h:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.h, q.shape[1])
            )
        return q

    def _local_candidates(self, s: int, q: torch.Tensor):
        """Shard s's band probe and rerank: (global ids int32[Q, b*cap],
        tombstones -1; scores f32; truncation)."""
        db, sorted_fp, sorted_ids = self._shards[s]
        q_fps = lsh_ops.band_fingerprints(q, self.b, self.r)
        ids, trunc = lsh_ops.query_tables(sorted_fp, sorted_ids, q_fps, cap=self.bucket_cap)
        flat = ids.reshape(q.shape[0], -1)
        scores = lsh_ops.rerank_jaccard(db, q, flat)
        ok = flat >= 0
        alive = self._alive_on(s)
        if alive is not None:
            ok &= alive[torch.where(ok, flat, 0).long()]
        gid = torch.where(ok, flat + s * self._rows, -1)
        return gid, scores, trunc

    def warmup(self, batch_sizes=(8, 64), k: int = 10, method: str = "auto") -> None:
        """One synthetic ``top_k`` and ``query_batch`` per batch size, as
        the JAX package defines it. No-op on an empty index."""
        if self._shards is None or not self._n_real:
            return
        rng = np.random.RandomState(0)
        for q in batch_sizes:
            sigs = rng.randint(0, 1 << 32, size=(int(q), self.h),
                               dtype=np.uint64).astype(np.uint32)
            self.top_k(sigs, k, method=method)
            self.query_batch(sigs, method=method)

    def query(self, minhash, threshold: Optional[float] = None) -> list:
        return self.query_batch([minhash], threshold=threshold)[0]

    def query_batch(self, minhashes, threshold: Optional[float] = None,
                    return_scores: bool = False, rerank: Optional[bool] = None,
                    method: str = "auto") -> list:
        """Batched query across all shards; one all_gather per call.

        method: ``'bands'`` probes each shard's band tables; ``'scan'``
        scores each shard's every row and returns every key whose estimate
        clears the threshold (up to ``max_results`` / 1024 per shard;
        requires rerank); ``'auto'`` picks the scan when a shard's rows
        are within the band path's gather budget Q * b * bucket_cap.
        """
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'bands' or 'scan'")
        do_rerank = self.rerank if rerank is None else rerank
        minhashes = _batch_rows(minhashes)
        if self._shards is None or not self._n_real:
            return [[] for _ in range(len(minhashes))]
        q = self._queries(minhashes)
        if method == "auto":
            gather_slots = q.shape[0] * self.b * self.bucket_cap
            method = "scan" if do_rerank and self._rows <= gather_slots else "bands"
        cutoff = self.threshold if threshold is None else threshold
        if method == "scan":
            if not do_rerank:
                raise ValueError(
                    "method='scan' requires rerank (it scores every stored signature)"
                )
            ids, scores, trunc = self._query_scan(q, cutoff)
        else:
            ids, scores, trunc = self._query_bands(q, float(cutoff) if do_rerank else -1.0)
        self.last_truncated = int(trunc)
        return _decode_rows(ids.cpu().numpy(), scores.cpu().numpy(), self._keys,
                            return_scores)

    def _query_bands(self, q: torch.Tensor, cutoff: float):
        """Each shard dedupes, filters and compacts its candidates on its
        device, so only ``max_out`` slots per shard ride the all_gather."""
        c_local = self.b * self.bucket_cap
        max_out = c_local if self.max_results is None else min(self.max_results, c_local)
        ids, scores, over = {}, {}, {}
        for s, shard in self._shards.items():
            dev = self.mesh.shard_device(self.shard_axis, s)
            if shard is None:
                ids[s], scores[s] = _empty(q.shape[0], max_out, dev)
                over[s] = 0
                continue
            qd = q.to(dev)
            gid, sc, trunc = self._local_candidates(s, qd)
            ids[s], scores[s], n_match = lsh_ops.threshold_select(sc, gid, cutoff, max_out)
            over[s] = trunc + (n_match.long() - max_out).clamp_min(0).sum()
        g_ids, g_sc = _valid_prefix(*gather_ranked(self.mesh, self.shard_axis, ids, scores))
        return g_ids, g_sc, psum(self.mesh, over)

    def _query_scan(self, q: torch.Tensor, cutoff: float):
        """Each shard scans its rows and keeps its best ``max_out`` at or
        above the cutoff. The scan runs first at kernel 2's k (<= 128) and
        again at ``max_out`` only when some shard matched more rows than
        that (the answers are the same: every match fits)."""
        max_out = min(self.max_results or 1024, self._rows)

        def scan(k):
            ids, scores, over, most = {}, {}, {}, {}
            for s, shard in self._shards.items():
                dev = self.mesh.shard_device(self.shard_axis, s)
                if shard is None:
                    ids[s], scores[s] = _empty(q.shape[0], k, dev)
                    over[s] = most[s] = 0
                    continue
                loc, scores[s], cnt = lsh_ops.topk_scan(shard[0], q.to(dev), k,
                                                        alive=self._alive_on(s),
                                                        count_ge=cutoff)
                ids[s] = torch.where(loc >= 0, loc + s * self._rows, -1)
                over[s] = (cnt.long() - max_out).clamp_min(0).sum()
                most[s] = cnt.max()
            return ids, scores, over, most

        k = min(max_out, lsh_ops.lsh_scan.MAX_K)
        ids, scores, over, most = scan(k)
        if k < max_out and int(pmax(self.mesh, most)) > k:
            ids, scores, over, _ = scan(max_out)
        g_ids, g_sc = _valid_prefix(*gather_ranked(self.mesh, self.shard_axis, ids, scores))
        return g_ids, g_sc, psum(self.mesh, over)

    def top_k(self, minhashes, k: int, return_scores: bool = True,
              method: str = "auto") -> list:
        """Top-k (key, score) per query: per-shard candidates, one k-wide
        all_gather, a stable cross-shard top-k.

        method: ``'bands'`` probes each shard's band tables; ``'scan'``
        scores each shard's every row (kernel 2 for k <= 128, kernel 4
        above); ``'auto'`` picks the scan when a shard's rows are within
        the Q * b * cap gather budget."""
        out = self._top_k_dispatch(minhashes, k, method)
        if isinstance(out, list):
            return out
        return self._top_k_finish(out, return_scores)

    def top_k_stream(self, batches, k: int, return_scores: bool = True, depth: int = 4,
                     method: str = "auto"):
        """Pipelined :meth:`top_k` over an iterable of query batches, with up
        to ``depth`` batches in flight
        (:func:`~datasketch_tpu_torch.utils.pipeline.stream_batches`)."""

        def _finish(out):
            if isinstance(out, list):
                return out
            return self._top_k_finish(out, return_scores)

        return stream_batches(batches, lambda b: self._top_k_dispatch(b, k, method), _finish,
                              depth=depth)

    def _top_k_dispatch(self, minhashes, k: int, method: str = "auto"):
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'bands' or 'scan'")
        minhashes = _batch_rows(minhashes)
        if self._shards is None or not self._n_real:
            return [[] for _ in range(len(minhashes))]
        q = self._queries(minhashes)
        if method == "auto":
            gather_slots = q.shape[0] * self.b * self.bucket_cap
            method = "scan" if self._rows <= gather_slots else "bands"
        ids, scores, trunc = {}, {}, {}
        for s, shard in self._shards.items():
            dev = self.mesh.shard_device(self.shard_axis, s)
            trunc[s] = 0
            if shard is None:
                ids[s], scores[s] = _empty(q.shape[0], k, dev)
                continue
            qd = q.to(dev)
            if method == "scan":
                loc, scores[s] = lsh_ops.topk_scan(shard[0], qd, k, alive=self._alive_on(s))
                ids[s] = torch.where(loc >= 0, loc + s * self._rows, -1)
            else:
                gid, sc, trunc[s] = self._local_candidates(s, qd)
                ids[s], scores[s] = lsh_ops.topk_candidates(sc, gid, k, max_dup=self.b)
        g_ids, g_sc = gather_ranked(self.mesh, self.shard_axis, ids, scores, k=k)
        return g_ids, g_sc, psum(self.mesh, trunc)

    def _top_k_finish(self, out, return_scores: bool) -> list:
        ids, scores, trunc = (t.cpu() if isinstance(t, torch.Tensor) else t for t in out)
        self.last_truncated = int(trunc)
        return _decode_rows(ids.numpy(), scores.numpy(), self._keys, return_scores)
