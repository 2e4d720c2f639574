"""TorchMinHashLSHForest -- LSH Forest for top-k Jaccard queries on the card.

Port of ``datasketch_tpu/models/tpu_forest.py::TpuMinHashLSHForest``: the
reference forest's add / index lifecycle and top-k semantics over
:mod:`datasketch_tpu_torch.ops.forest_ops` (prefix walk, pool rerank on
kernel 3) or the exact scan (``lsh_ops.topk_scan``: kernel 2 for k <= 128,
kernel 4 above). Accepts MinHash / WeightedMinHash objects, rows, or
signature matrices and tensors, like :class:`TorchMinHashLSH`.

The JAX facade pads rows and query batches to powers of two; this one pads
nothing but takes its decisions from the same padded sizes: the query
batch's ``q_pad`` (the least power of two >= 8) picks ``method="auto"``'s
route and counts the padding rows' cap overflow into ``last_truncated``,
``k_pad`` (the least power of two >= max(8, k)) sets the top-k width and
the default pool, and the row count's power of two (>= 128) is the table
size ``auto`` compares. Scores come back as the JAX facade returns them:
f32 Jaccard rounded to a multiple of 2**-20 (half to even), as float.
Checkpoints use the JAX package's ``.npz`` layout.
"""

from __future__ import annotations

from typing import Hashable, Optional, Sequence

import numpy as np
import torch

from datasketch_tpu_torch.device import as_sig_tensor, resolve_device, to_numpy_u32
from datasketch_tpu_torch.models.minhash import MinHash, pow2_at_least
from datasketch_tpu_torch.models.torch_lsh import _as_signature_matrix, _host, _host_rows
from datasketch_tpu_torch.ops import forest_ops, lsh_ops
from datasketch_tpu_torch.utils.pipeline import stream_batches

__all__ = ["TorchMinHashLSHForest"]

_JAC_FX = 1 << 20  # the JAX facade returns Jaccard in this fixed point
_RANKS = ("forest", "jaccard")
_METHODS = ("auto", "forest", "scan")


class TorchMinHashLSHForest:
    """Top-k Jaccard index with prefix-tree semantics, resident on the card.

    Args:
        num_perm: signature length of indexed sketches.
        l: number of prefix trees; each reads ``k = num_perm // l`` slots.
        cap: max rows gathered per (query, tree, prefix level); overflow
            is counted in :attr:`last_truncated`.
        rank: ``'forest'`` (longest matching prefix first, estimated
            Jaccard as tiebreak: the reference's order) or ``'jaccard'``
            (the same candidate pool by estimated Jaccard alone).
        cascade_perm: stored and query rows are this wide (>= ``k * l``);
            the trees read the first ``k * l`` slots, scores all of them.
        pool: rerank pool size (0: per-rank default,
            :func:`~datasketch_tpu_torch.ops.forest_ops.forest_topk`).
        method: ``'forest'`` (prefix walk), ``'scan'`` (exact top-k over
            every row, Jaccard-ranked; refused with rank ``'forest'``,
            whose order the scan cannot give), or ``'auto'`` (the scan for
            rank ``'jaccard'`` when the padded table is no larger than the
            walk's gather volume ``q_pad * l * k * cap``, else the walk).
        device: ``"cuda"`` (default) or ``"cpu"`` (plain versions of the
            kernels). No silent fallback.
    """

    def __init__(self, num_perm: int = 128, l: int = 8, cap: int = 64, rank: str = "forest",
                 cascade_perm: Optional[int] = None, pool: int = 0, method: str = "auto",
                 device="cuda"):
        if l <= 0 or num_perm <= 0:
            raise ValueError("num_perm and l must be positive")
        if l > num_perm:
            raise ValueError("l cannot be greater than num_perm")
        if rank not in _RANKS:
            raise ValueError("rank must be 'forest' or 'jaccard'")
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'forest' or 'scan'")
        self.device = resolve_device(device)
        self.rank = rank
        self.method = method
        self.l = l
        self.k = int(num_perm / l)
        self.num_perm = num_perm
        # the reference reads only the first k*l values of a sketch
        self.width = self.k * self.l
        if cascade_perm is not None and cascade_perm < self.width:
            raise ValueError("cascade_perm must be >= the prefix width k*l")
        self.cascade_perm = cascade_perm
        self.score_width = cascade_perm if cascade_perm else self.width
        if pool < 0:
            raise ValueError("pool must be >= 0")
        self.pool = pool
        self.cap = cap
        self._keys: list = []  # row -> user key
        self._key_set: set = set()
        self._pending: list = []  # (keys, rows) staged by add() / index(keys, ...)
        self._sigs = None  # int32[N, score_width]
        self._sorted_fps = None  # int32[l, k, N], order-preserving view of uint32
        self._sorted_ids = None  # int32[l, N]
        self.last_truncated = 0

    # ------------------------------------------------------------- building

    @property
    def _n_real(self) -> int:
        return 0 if self._sigs is None else self._sigs.shape[0]

    def add(self, key: Hashable, minhash) -> None:
        """Stage (key, minhash); searchable after the next :meth:`index`."""
        row = _host_rows([minhash])[0]
        if row.shape[0] < self.score_width:
            raise ValueError("The num_perm of MinHash out of range")
        if key in self._key_set:
            raise ValueError("The given key has already been added")
        self._key_set.add(key)
        self._pending.append(([key], row[None, : self.score_width]))

    def index(self, keys: Optional[Sequence[Hashable]] = None, minhashes=None) -> None:
        """Make staged keys searchable; with ``(keys, minhashes)`` add them
        first (a uint32 matrix, an int32 tensor, a (k, t) batch, or rows /
        sketch objects). One sort per level for the whole table."""
        if (keys is None) != (minhashes is None):
            raise ValueError("provide both keys and minhashes, or neither")
        if keys is not None:
            keys = list(keys)
            sigs = _as_signature_matrix(minhashes, self.device)
            if sigs.shape[0] != len(keys):
                raise ValueError("keys and minhashes must have equal length")
            if sigs.shape[0] and sigs.shape[1] < self.score_width:
                raise ValueError("The num_perm of MinHash out of range")
            seen = set()
            for k in keys:
                if k in self._key_set or k in seen:
                    raise ValueError("The given key has already been added")
                seen.add(k)
            self._key_set.update(seen)
            if keys:
                self._pending.append((keys, sigs[:, : self.score_width]))
        if not self._pending:
            return
        parts = [self._sigs] if self._sigs is not None else []
        host: list = []  # consecutive add() rows, uploaded together
        for keys_, rows in self._pending:
            self._keys.extend(keys_)
            if isinstance(rows, np.ndarray):
                host.append(rows)
                continue
            if host:
                parts.append(as_sig_tensor(np.concatenate(host), self.device))
                host = []
            parts.append(rows)
        if host:
            parts.append(as_sig_tensor(np.concatenate(host), self.device))
        self._pending = []
        self._sigs = torch.cat(parts).contiguous() if len(parts) > 1 else parts[0].contiguous()
        self._sorted_fps, self._sorted_ids = forest_ops.build_forest(
            forest_ops.prefix_fingerprints(self._sigs, self.l, self.k)
        )

    def index_tokens(self, keys: Sequence[Hashable], token_docs, seed: int = 1,
                     scheme: str = "permutation") -> None:
        """Bulk-build from pre-tokenized integer documents, ids hashed on
        the card (kernel 1, ``hashfunc="device"``). Query with
        ``hashfunc="device"`` sketches at equal seed."""
        if len(keys) != len(token_docs):
            raise ValueError("keys and token_docs must have equal length")
        sigs = MinHash.bulk_signatures(token_docs, scheme=scheme, num_perm=self.score_width,
                                       seed=seed, hashfunc="device", out="device",
                                       device=self.device)
        self.index(list(keys), sigs)

    def index_text(self, keys: Sequence[Hashable], texts, k: int = 9, seed: int = 1) -> None:
        """Bulk-build from raw text, k-byte shingles hashed on the card.
        Query with ``MinHash.bulk_from_text(..., hashfunc="device")``
        sketches at equal ``(k, seed)``."""
        if len(keys) != len(texts):
            raise ValueError("keys and texts must have equal length")
        sigs = MinHash.bulk_from_text(texts, k=k, num_perm=self.score_width, seed=seed,
                                      hashfunc="device", out="device", device=self.device)
        self.index(list(keys), sigs)

    # -------------------------------------------------------------- queries

    def query(self, minhash, k: int, rank: Optional[str] = None,
              method: Optional[str] = None) -> list:
        """Top-k keys, ordered per the index's ``rank``."""
        return self.query_batch([minhash], k, rank=rank, method=method)[0]

    def query_batch(self, minhashes, k: int, return_scores: bool = False,
                    rank: Optional[str] = None, method: Optional[str] = None) -> list:
        """Top-k for a query batch: per query a list of keys, or of (key,
        jaccard) pairs when ``return_scores``, nearest first. ``rank`` and
        ``method`` override the index's for this call."""
        return self._query_finish(self._query_dispatch(minhashes, k, rank, method), k,
                                  return_scores)

    def query_stream(self, batches, k: int, return_scores: bool = False, depth: int = 4,
                     rank: Optional[str] = None, method: Optional[str] = None):
        """Pipelined :meth:`query_batch` over an iterable of batches, with
        up to ``depth`` batches in flight."""
        if k <= 0:
            raise ValueError("k must be positive")
        return stream_batches(
            batches,
            lambda b: self._query_dispatch(b, k, rank, method),
            lambda out: self._query_finish(out, k, return_scores),
            depth=depth,
        )

    def _resolve_method(self, method: str, rank: str, q_pad: int) -> str:
        if method == "auto":
            if rank != "jaccard":
                return "forest"
            walk_slots = q_pad * self.l * self.k * self.cap
            return "scan" if pow2_at_least(self._n_real) <= walk_slots else "forest"
        if method == "scan" and rank == "forest":
            raise ValueError(
                "method='scan' orders by Jaccard only; rank='forest' (prefix depth "
                "first) needs method='forest' or 'auto'"
            )
        return method

    def _query_dispatch(self, minhashes, k: int, rank: Optional[str],
                        method: Optional[str]):
        """Enqueue one batch on the card: (ids, jaccard, truncated, Q), or
        the answer itself for an empty index or batch."""
        if k <= 0:
            raise ValueError("k must be positive")
        rank = self.rank if rank is None else rank
        if rank not in _RANKS:
            raise ValueError("rank must be 'forest' or 'jaccard'")
        method = self.method if method is None else method
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'forest' or 'scan'")
        if self._sorted_fps is None:
            return [[] for _ in minhashes]
        q = _as_signature_matrix(minhashes, self.device)
        if q.shape[0] == 0:
            return []
        if q.shape[1] < self.score_width:
            raise ValueError("The num_perm of MinHash out of range")
        q = q[:, : self.score_width].contiguous()
        nq = q.shape[0]
        q_pad = pow2_at_least(nq, 8)
        k_pad = max(8, 1 << (k - 1).bit_length())
        if self._resolve_method(method, rank, q_pad) == "scan":
            ids, jac = lsh_ops.topk_scan(self._sigs, q, k_pad)
            return ids, jac, 0, nq
        ids, jac, _, trunc = forest_ops.forest_query_fused(
            self._sorted_fps, self._sorted_ids, self._sigs, q, self.l, self.k, self.cap,
            k_pad, pool=self.pool, rank=rank, zero_rows=q_pad - nq,
        )
        return ids, jac, trunc, nq

    def _query_finish(self, out, k: int, return_scores: bool) -> list:
        if isinstance(out, list):
            return out
        ids, jac, trunc, _ = out
        ids = _host(ids)[:, :k]
        jac = np.rint(_host(jac)[:, :k].astype(np.float64) * _JAC_FX) / _JAC_FX
        self.last_truncated = int(_host(trunc))
        result = []
        for row_ids, row_jac in zip(ids.tolist(), jac.tolist()):
            hits = [(self._keys[i], s) for i, s in zip(row_ids, row_jac) if i >= 0]
            result.append(hits if return_scores else [key for key, _ in hits])
        return result

    def warmup(self, batch_sizes=(8, 64), k: int = 10) -> None:
        """One synthetic :meth:`query_batch` per batch size, as the JAX
        package defines it. No-op before :meth:`index`."""
        if self._sorted_fps is None:
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
        return len(self._keys) + sum(len(keys) for keys, _ in self._pending)

    def is_empty(self) -> bool:
        """True until :meth:`index` has made at least one key searchable."""
        return self._n_real == 0

    def get_minhash_hashvalues(self, key: Hashable) -> np.ndarray:
        """The indexed (or staged) uint32 signature row of ``key``."""
        try:
            pos = self._keys.index(key)
        except ValueError:
            for keys, rows in self._pending:
                if key in keys:
                    row = rows[keys.index(key)]
                    return to_numpy_u32(row) if isinstance(row, torch.Tensor) else row
            raise KeyError(
                f"The provided key does not exist in the LSHForest: {key}"
            ) from None
        return to_numpy_u32(self._sigs[pos])

    def status(self) -> dict:
        """Health counters: indexed and pending rows, the deepest level's
        longest run against ``cap``, and the device bytes of the tables.
        Nothing is padded (``n_padded`` 0)."""
        out = {
            "n_indexed": len(self._keys),
            "n_pending": len(self) - len(self._keys),
            "n_padded": 0,
            "trees": self.l,
            "prefix_len": self.k,
            "cap": self.cap,
            "last_truncated": self.last_truncated,
            "device_bytes": 0,
            "max_leaf_run": 0,
        }
        if self._sorted_fps is not None:
            out["device_bytes"] = int(sum(t.numel() * t.element_size() for t in (
                self._sigs, self._sorted_fps, self._sorted_ids)))
            if self._n_real:
                max_run, _ = lsh_ops.bucket_stats(self._sorted_fps[:, self.k - 1, :])
                out["max_leaf_run"] = int(max_run.max())
        return out

    def save(self, path: str) -> None:
        """Persist signatures and keys as ``.npz`` in the JAX package's
        layout (the trees are rebuilt on load); staged keys are indexed
        first."""
        from datasketch_tpu_torch.persist import atomic_savez, pack_keys

        self.index()
        atomic_savez(
            path,
            sigs=to_numpy_u32(self._sigs) if self._sigs is not None
            else np.zeros((0, self.score_width), dtype=np.uint32),
            keys=pack_keys(self._keys),
            params=np.array(
                [self.num_perm, self.l, self.cap, int(self.rank == "jaccard"),
                 self.cascade_perm or 0, self.pool, _METHODS.index(self.method)],
                dtype=np.int64,
            ),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "TorchMinHashLSHForest":
        """Load a forest saved by either package (older, shorter ``params``
        too) onto ``device``.

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
        forest = cls(num_perm=num_perm, l=l, cap=cap, rank=rank, cascade_perm=cascade,
                     pool=pool, method=method, device=device)
        keys = unpack_keys(data["keys"])
        if len(keys):
            forest.index(keys, data["sigs"])
        return forest
