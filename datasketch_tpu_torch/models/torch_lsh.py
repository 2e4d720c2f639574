"""TorchMinHashLSH -- device-resident Jaccard-threshold index on the card.

Port of ``datasketch_tpu/models/tpu_lsh.py::TpuMinHashLSH``: signatures
and band tables stay on ``device``; queries are batched probes, kernel
reranks and kernel scans (:mod:`datasketch_tpu_torch.ops.lsh_ops`), and
the host receives one compact buffer per batch. Same banding, the same
(b, r) optimizer and the same answers, ties included.

The stored table is not padded (the JAX package pads to a power of two to
bound its compile shapes). The power-of-two row count is still computed,
because ``method="auto"`` and the scan's result cap decide on it, so both
facades take the same path for the same corpus. Likewise ``query_b`` counts
the cap overflow of the zero rows the JAX package pads a query batch with.
Checkpoints (:meth:`TorchMinHashLSH.save` / :meth:`TorchMinHashLSH.load`)
use the JAX package's ``.npz`` layout, so either package loads the other's.
"""

from __future__ import annotations

from typing import Hashable, Optional, Sequence

import numpy as np
import torch

from datasketch_tpu_torch.device import as_sig_tensor, resolve_device, to_numpy_u32
from datasketch_tpu_torch.models.lsh_params import optimal_param
from datasketch_tpu_torch.models.minhash import MinHash, pow2_at_least
from datasketch_tpu_torch.ops import lsh_ops
from datasketch_tpu_torch.ops.cws_ops import kt_slots, kt_slots_np
from datasketch_tpu_torch.utils.pipeline import stream_batches

__all__ = ["TorchMinHashLSH"]

_METHODS = ("auto", "bands", "scan")


def _host_rows(minhashes) -> np.ndarray:
    """uint32[N, P] from a sequence of rows or objects with ``hashvalues``:
    MinHash state (uint64 values < 2**32) or WeightedMinHash (k, t) pairs
    ([P, 2], mixed to slots by ``kt_slots_np``). A tensor row on any device
    is fetched."""
    rows = []
    for m in minhashes:
        hv = m.hashvalues if hasattr(m, "hashvalues") else m
        if isinstance(hv, torch.Tensor):
            hv = hv.detach().cpu()
        hv = np.asarray(hv)
        rows.append(kt_slots_np(hv) if hv.ndim == 2 else hv.astype(np.uint64).astype(np.uint32))
    return np.stack(rows) if rows else np.zeros((0, 0), dtype=np.uint32)


def _as_signature_matrix(minhashes, device: torch.device) -> torch.Tensor:
    """Signatures as an int32[N, P] tensor on ``device``: a uint32 numpy
    matrix, a tensor (int32 bits), an [N, P, 2] (k, t) batch (numpy, or a
    tensor mixed to slots on its own device), or a sequence of rows /
    MinHash or WeightedMinHash objects."""
    if isinstance(minhashes, (np.ndarray, torch.Tensor)):
        if minhashes.ndim == 2:
            return as_sig_tensor(minhashes, device)
        if minhashes.ndim == 3:
            slots = (kt_slots(minhashes) if isinstance(minhashes, torch.Tensor)
                     else kt_slots_np(minhashes))
            return as_sig_tensor(slots, device)
    rows = list(minhashes)
    if rows and all(isinstance(m, torch.Tensor) for m in rows):
        # rows of a device batch: stacked where they lie, never fetched
        return _as_signature_matrix(torch.stack(rows), device)
    return as_sig_tensor(_host_rows(rows), device)


def _host(x):
    """A tensor (any device) as a numpy array; other values unchanged."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _batch_rows(batch):
    """A stream batch as :func:`_as_signature_matrix` takes it: matrices
    and tensors as they are, other iterables as a list."""
    return batch if isinstance(batch, (np.ndarray, torch.Tensor)) else list(batch)


def _decode_rows(ids_host, sc_host, keys, return_scores: bool) -> list:
    """Host decode of compacted results: each row's valid slots, in order,
    -> keys (with scores when asked). One boolean index and one
    ``tolist`` per batch; Python touches only the valid slots."""
    hit = ids_host >= 0
    found = [keys[p] for p in ids_host[hit].tolist()]
    if return_scores:
        found = list(zip(found, sc_host[hit].tolist()))
    out = []
    pos = 0
    for count in hit.sum(axis=1).tolist():
        out.append(found[pos: pos + count])
        pos += count
    return out


class TorchMinHashLSH:
    """Device-resident MinHash LSH.

    Args:
        threshold: Jaccard threshold the banding is optimized for; also the
            default rerank cutoff of threshold queries.
        num_perm: signature length.
        weights: (fp_weight, fn_weight) for the (b, r) optimizer.
        params: explicit (b, r) override.
        bucket_cap: max bucket members gathered per (query, band);
            overflow is counted in ``last_truncated``.
        rerank: filter candidates by estimated Jaccard >= threshold.
        max_results: cap on threshold-query results per query (None =
            all candidates); overflow is counted in ``last_truncated``.
        cascade_perm: signature width when > ``num_perm``: rows and
            queries are this wide, banding reads their first ``b * r <=
            num_perm`` slots and every score (rerank, scan) all of them.
        device: ``"cuda"`` (default) or ``"cpu"`` (plain PyTorch versions
            of the kernels). No silent fallback.
    """

    def __init__(
        self,
        threshold: float = 0.9,
        num_perm: int = 128,
        weights: tuple = (0.5, 0.5),
        params: Optional[tuple] = None,
        bucket_cap: int = 128,
        rerank: bool = True,
        max_results: Optional[int] = None,
        cascade_perm: Optional[int] = None,
        device="cuda",
    ):
        if threshold > 1.0 or threshold < 0.0:
            raise ValueError("threshold must be in [0.0, 1.0]")
        if num_perm < 2:
            raise ValueError("Too few permutation functions")
        if cascade_perm is not None and cascade_perm < num_perm:
            raise ValueError("cascade_perm must be >= num_perm")
        self.device = resolve_device(device)
        self.threshold = threshold
        self.h = num_perm
        self.cascade_perm = cascade_perm
        self.in_width = cascade_perm or num_perm  # stored and query row width
        if params is not None:
            self.b, self.r = params
            if self.b * self.r > num_perm:
                raise ValueError("b*r must be <= num_perm")
        else:
            self.b, self.r = optimal_param(threshold, num_perm, *weights)
        self.bucket_cap = bucket_cap
        self.rerank = rerank
        self.max_results = max_results

        self._keys: list = []  # position -> user key (None once removed)
        self._key_to_pos: dict = {}
        self._sigs = None  # int32[N, P] on device, N = rows ever indexed
        self._sorted_fp = None  # int64[b, N]
        self._sorted_ids = None  # int32[b, N]
        self._pending_sigs: list = []  # inserted rows awaiting a rebuild
        self._alive = None  # host bool[N]; False = removed
        self._alive_dev = None  # cached (device mask or None, all_alive)
        self.last_truncated = 0

    # ------------------------------------------------------------------ build

    @property
    def _n_real(self) -> int:
        return 0 if self._sigs is None else self._sigs.shape[0]

    def _check_width(self, sigs: torch.Tensor) -> None:
        if sigs.shape[0] and sigs.shape[1] != self.in_width:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.in_width, sigs.shape[1])
            )

    def index(self, keys: Sequence[Hashable], minhashes) -> None:
        """Bulk-build from parallel (keys, signatures): a uint32[N, P] numpy
        matrix, an int32 tensor, an [N, P, 2] (k, t) batch, or rows /
        MinHash-like or WeightedMinHash objects."""
        self._flush_pending()
        keys = list(keys)
        sigs = _as_signature_matrix(minhashes, self.device)
        if sigs.shape[0] != len(keys):
            raise ValueError("keys and minhashes must have equal length")
        self._check_width(sigs)
        if not keys:
            return
        seen = set()
        for k in keys:
            if k in self._key_to_pos or k in seen:
                raise ValueError("The given key already exists: %r" % (k,))
            seen.add(k)
        base = len(self._keys)
        for i, k in enumerate(keys):
            self._key_to_pos[k] = base + i
        self._keys.extend(keys)
        self._append(sigs)

    def index_tokens(self, keys: Sequence[Hashable], token_docs, seed: int = 1,
                     scheme: str = "permutation") -> None:
        """Bulk-build from pre-tokenized integer documents: the ids are
        uploaded raw and hashed on the card (fmix32 inside kernel 1,
        ``hashfunc="device"``). Query with sketches built the same way at
        equal seed (:meth:`query_tokens`, :meth:`top_k_tokens`)."""
        sigs = MinHash.bulk_signatures(
            token_docs, scheme=scheme, num_perm=self.in_width, seed=seed, hashfunc="device",
            out="device", device=self.device,
        )
        self.index(keys, sigs)

    def index_text(self, keys: Sequence[Hashable], texts, k: int = 9, seed: int = 1) -> None:
        """Bulk-build from raw text: the bytes are uploaded and every
        overlapping k-byte shingle is hashed on the card
        (:mod:`datasketch_tpu_torch.ops.text_ops`). Query with
        :meth:`query_text` / :meth:`top_k_text` at equal ``(k, seed)``."""
        if len(keys) != len(texts):
            raise ValueError("keys and texts must have equal length")
        self.index(keys, self._text_query_sigs(texts, k, seed))

    def _token_query_sigs(self, token_docs, seed: int) -> torch.Tensor:
        return MinHash.bulk_signatures(
            token_docs, num_perm=self.in_width, seed=seed, hashfunc="device", out="device",
            device=self.device,
        )

    def _text_query_sigs(self, texts, shingle_k: int, seed: int) -> torch.Tensor:
        return MinHash.bulk_from_text(
            texts, k=shingle_k, num_perm=self.in_width, seed=seed, hashfunc="device",
            out="device", device=self.device,
        )

    def query_tokens(self, token_docs, seed: int = 1, **kwargs) -> list:
        """Threshold query from pre-tokenized integer documents (the query
        side of :meth:`index_tokens`); kwargs pass to :meth:`query_batch`."""
        return self.query_batch(self._token_query_sigs(token_docs, seed), **kwargs)

    def top_k_tokens(self, token_docs, k: int, seed: int = 1, **kwargs) -> list:
        """Top-k from pre-tokenized integer documents; kwargs pass to
        :meth:`top_k`."""
        return self.top_k(self._token_query_sigs(token_docs, seed), k, **kwargs)

    def query_text(self, texts, shingle_k: int = 9, seed: int = 1, **kwargs) -> list:
        """Threshold query from raw texts (the query side of
        :meth:`index_text`); kwargs pass to :meth:`query_batch`."""
        return self.query_batch(self._text_query_sigs(texts, shingle_k, seed), **kwargs)

    def top_k_text(self, texts, k: int, shingle_k: int = 9, seed: int = 1, **kwargs) -> list:
        """Top-k from raw texts; kwargs pass to :meth:`top_k`."""
        return self.top_k(self._text_query_sigs(texts, shingle_k, seed), k, **kwargs)

    def insert(self, key: Hashable, minhash, check_duplication: bool = True) -> None:
        """Insert one (key, signature); buffered until the next query."""
        if check_duplication and key in self._key_to_pos:
            raise ValueError("The given key already exists")
        hv = _host_rows([minhash])[0]
        if hv.shape[0] != self.in_width:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.in_width, hv.shape[0])
            )
        self._key_to_pos[key] = len(self._keys)
        self._keys.append(key)
        self._pending_sigs.append(hv)

    def _flush_pending(self) -> None:
        if not self._pending_sigs:
            return
        tail = np.stack(self._pending_sigs)
        self._pending_sigs = []
        self._append(as_sig_tensor(tail, self.device))

    def _append(self, sigs: torch.Tensor) -> None:
        """Add rows to the table and rebuild the band tables."""
        if self._sigs is not None:
            sigs = torch.cat([self._sigs, sigs], dim=0)
        self._sigs = sigs
        fps = lsh_ops.band_fingerprints(sigs, self.b, self.r)
        self._sorted_fp, self._sorted_ids = lsh_ops.build_tables(fps)
        n = sigs.shape[0]
        old = self._alive
        self._alive = np.ones(n, dtype=bool)
        if old is not None:
            self._alive[: old.shape[0]] = old
        self._alive_dev = None

    def remove(self, key: Hashable) -> None:
        """Tombstone ``key``: its row stays in the tables but is masked from
        every query (kernel 2's ``alive`` mask on the scan path)."""
        self._flush_pending()
        if key not in self._key_to_pos:
            raise ValueError("The given key does not exist")
        pos = self._key_to_pos.pop(key)
        self._alive[pos] = False
        self._keys[pos] = None
        self._alive_dev = None

    def merge(self, other: "TorchMinHashLSH", check_overlap: bool = False) -> None:
        """Union another index into this one: its rows are appended (moved
        to this index's device), its tombstones kept, and the band tables
        rebuilt once. Indexes merge only at equal (num_perm, width, b, r)."""
        if type(self) is not type(other):
            raise ValueError(
                "Cannot merge type %s and type %s." % (type(self).__name__, type(other).__name__)
            )
        if (self.h, self.in_width, self.b, self.r) != (other.h, other.in_width, other.b, other.r):
            raise ValueError(
                "Cannot merge %s with different initialization parameters."
                % type(self).__name__
            )
        self._flush_pending()
        other._flush_pending()
        if check_overlap and set(self._key_to_pos) & set(other._key_to_pos):
            raise ValueError("The keys are overlapping, duplicate key exists.")
        if other._sigs is None or not other._n_real:
            return
        base = len(self._keys)
        for i, k in enumerate(other._keys):
            if k is not None:
                self._key_to_pos[k] = base + i
        self._keys.extend(other._keys)
        n_self = self._n_real
        other_alive = other._alive.copy()
        self._append(other._sigs.to(self.device))
        self._alive[n_self:] = other_alive

    def compact(self) -> None:
        """Drop tombstoned rows and rebuild the band tables."""
        self._flush_pending()
        if self._sigs is None or self._alive.all():
            return
        live = np.nonzero(self._alive)[0]
        sigs = self._sigs[torch.from_numpy(live).to(self.device)]
        self._keys = [self._keys[i] for i in live]
        self._key_to_pos = {k: i for i, k in enumerate(self._keys)}
        self._sigs = None
        self._alive = None
        self._append(sigs)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._key_to_pos

    def __len__(self) -> int:
        return len(self._key_to_pos)

    def is_empty(self) -> bool:
        return len(self._key_to_pos) == 0

    def status(self) -> dict:
        """Health counters: live/tombstoned rows, banding, bucket occupancy
        against ``bucket_cap`` and the device bytes of table and index."""
        self._flush_pending()
        n_live = len(self._key_to_pos)
        out = {
            "n_live": n_live,
            "n_tombstoned": self._n_real - n_live,
            "n_padded": 0,
            "bands": self.b,
            "rows_per_band": self.r,
            "bucket_cap": self.bucket_cap,
            "last_truncated": self.last_truncated,
            "device_bytes": 0,
            "max_bucket": 0,
            "distinct_buckets_min": 0,
        }
        if self._sigs is not None:
            out["device_bytes"] = int(
                sum(t.numel() * t.element_size()
                    for t in (self._sigs, self._sorted_fp, self._sorted_ids))
            )
            if self._n_real:  # a compacted empty table has no bucket to count
                max_run, n_distinct = lsh_ops.bucket_stats(self._sorted_fp)
                stats = torch.stack([max_run.max(), n_distinct.min()]).cpu()
                out["max_bucket"] = int(stats[0])
                out["distinct_buckets_min"] = int(stats[1])
        return out

    # ------------------------------------------------------------------ query

    def _alive_state(self):
        """(device bool mask or None, all_alive), cached until a remove."""
        if self._alive_dev is None:
            if self._alive is None or bool(self._alive.all()):
                self._alive_dev = (None, True)
            else:
                mask = torch.from_numpy(self._alive).to(self.device)
                self._alive_dev = (mask, False)
        return self._alive_dev

    def _mask_dead(self, flat_ids):
        """Replace tombstoned candidate ids with -1."""
        alive_dev, all_alive = self._alive_state()
        if all_alive:
            return flat_ids
        safe = torch.where(flat_ids >= 0, flat_ids, 0).long()
        return torch.where((flat_ids >= 0) & alive_dev[safe], flat_ids, -1)

    def _queries(self, minhashes) -> torch.Tensor:
        q = _as_signature_matrix(minhashes, self.device)
        if q.shape[1] != self.in_width:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.in_width, q.shape[1])
            )
        return q

    def _pick(self, method: str, nq: int) -> str:
        """'auto' -> scan when the JAX index's padded row count is within
        the band path's gather budget Q * b * bucket_cap."""
        if method != "auto":
            return method
        gather_slots = nq * self.b * self.bucket_cap
        return "scan" if pow2_at_least(self._n_real) <= gather_slots else "bands"

    def query(self, minhash, threshold: Optional[float] = None) -> list:
        """Single query; returns candidate keys (reranked if enabled)."""
        return self.query_batch([minhash], threshold=threshold)[0]

    def query_batch(self, minhashes, threshold: Optional[float] = None,
                    return_scores: bool = False, method: str = "auto") -> list:
        """Batched threshold query, finished on the card.

        method: ``'bands'`` (band probe -> kernel-3 rerank -> dedupe,
        cutoff, compaction), ``'scan'`` (kernel-2 scan of every stored
        signature: all keys scoring >= threshold, up to ``max_results`` /
        1024 per query), or ``'auto'`` (scan when the corpus is within the
        band gather budget, as :meth:`top_k`).

        Returns per query a list of keys, or of (key, score) pairs when
        ``return_scores`` (scores descending).
        """
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'bands' or 'scan'")
        self._flush_pending()
        cutoff = self.threshold if threshold is None else threshold
        return self._query_finish(
            self._query_batch_dispatch(minhashes, cutoff, method, return_scores),
            return_scores,
        )

    def query_stream(self, batches, threshold: Optional[float] = None,
                     return_scores: bool = False, method: str = "auto", depth: int = 4):
        """Pipelined :meth:`query_batch`: yields one result list per batch
        of ``batches``, with up to ``depth`` batches in flight
        (:func:`~datasketch_tpu_torch.utils.pipeline.stream_batches`). A
        threshold scan whose match count overflows its first k reruns at
        the full budget when its batch is finished."""
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'bands' or 'scan'")
        self._flush_pending()
        cutoff = self.threshold if threshold is None else threshold
        return stream_batches(
            batches,
            lambda b: self._query_batch_dispatch(b, cutoff, method, return_scores),
            lambda item: self._query_finish(item, return_scores),
            depth=depth,
        )

    def _query_batch_dispatch(self, minhashes, cutoff: float, method: str,
                              return_scores: bool):
        """A batch's threshold query enqueued on the card, or the number of
        queries when there is nothing to ask (an empty index)."""
        minhashes = _batch_rows(minhashes)
        if self._sigs is None or not len(self._keys):
            return len(minhashes)
        q = self._queries(minhashes)
        if not q.shape[0]:
            return 0
        return self._query_dispatch(q, cutoff, method, self.rerank or return_scores)

    def _query_finish(self, item, return_scores: bool) -> list:
        """Fetch and decode one dispatched threshold batch; a scan whose
        match count overflowed its first k reruns at the full budget."""
        if isinstance(item, int):
            return [[] for _ in range(item)]
        sel_ids, sel_sc, n_match, trunc, max_out, escalate = item
        n_host = _host(n_match)
        if escalate is not None and (n_host > max_out).any():
            return self._query_finish(escalate(), return_scores)
        self.last_truncated = int(_host(trunc)) + int(
            np.maximum(n_host.astype(np.int64) - max_out, 0).sum()
        )
        return _decode_rows(_host(sel_ids), _host(sel_sc), self._keys, return_scores)

    def _query_dispatch(self, q: torch.Tensor, cutoff: float, method: str,
                        need_scores: bool = True):
        """One threshold batch enqueued on the card. Returns (sel_ids,
        sel_sc or None, n_match, truncated, max_out, escalate); ``n_match``
        counts matches before the ``max_out`` cap, and ``escalate`` (the
        scan's, else None) reruns the batch at the full budget. Without
        ``need_scores`` (rerank off, no scores asked) the signature table
        is never read."""
        if method == "auto" and not self.rerank:
            method = "bands"
        method = self._pick(method, q.shape[0])
        if method == "scan":
            if not self.rerank:
                raise ValueError(
                    "method='scan' requires rerank=True (it scores every "
                    "stored signature; without a cutoff the result would "
                    "be the whole corpus)"
                )
            max_out = min(self.max_results or 1024, pow2_at_least(self._n_real))
            alive = self._alive_state()[0]

            def scan(k):
                return lsh_ops.topk_scan(self._sigs, q, k, alive=alive, count_ge=cutoff)

            # kernel-sized k first; the finish reruns at the full budget
            # only when some query matched more rows than it returned
            k = min(max_out, lsh_ops.lsh_scan.MAX_K)
            escalate = None
            if k < max_out:
                escalate = lambda: scan(max_out) + (0, max_out, None)  # noqa: E731
            return scan(k) + (0, k, escalate)
        c = self.b * self.bucket_cap
        max_out = c if self.max_results is None else min(self.max_results, c)
        all_alive = self._alive_state()[1]
        if not need_scores:
            if all_alive:
                sel_ids, n_match, trunc = lsh_ops.query_candidates_fused(
                    self._sorted_fp, self._sorted_ids, q, self.b, self.r,
                    self.bucket_cap, max_out,
                )
            else:
                flat, trunc = self._probe(q)
                sel_ids, n_match = lsh_ops.unique_compact(flat, max_out)
            return sel_ids, None, n_match, trunc, max_out, None
        cut = float(cutoff) if self.rerank else -1.0
        if all_alive:
            sel_ids, sel_sc, n_match, trunc = lsh_ops.query_fused(
                self._sorted_fp, self._sorted_ids, self._sigs, q, self.b,
                self.r, self.bucket_cap, cut, max_out,
            )
            return sel_ids, sel_sc, n_match, trunc, max_out, None
        flat, trunc = self._probe(q)
        scores = lsh_ops.rerank_jaccard(self._sigs, q, flat)
        sel_ids, sel_sc, n_match = lsh_ops.threshold_select(scores, flat, cut, max_out)
        return sel_ids, sel_sc, n_match, trunc, max_out, None

    def _probe(self, q: torch.Tensor):
        """Band candidates int32[Q, b*cap] with tombstones masked, and the
        truncation count."""
        q_fps = lsh_ops.band_fingerprints(q, self.b, self.r)
        ids, trunc = lsh_ops.query_tables(
            self._sorted_fp, self._sorted_ids, q_fps, cap=self.bucket_cap
        )
        return self._mask_dead(ids.reshape(q.shape[0], -1)), trunc

    def top_k(self, minhashes, k: int, method: str = "auto") -> list:
        """Top-k most similar indexed keys per query, as (key, score) pairs.

        method: ``'bands'`` (band probe -> kernel-3 rerank -> dedupe
        top-k), ``'scan'`` (exact scan of every stored signature: kernel 2
        for k <= 128, kernel 4 above), or ``'auto'`` (scan when the JAX
        index's padded row count is <= Q * b * bucket_cap).
        """
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'bands' or 'scan'")
        self._flush_pending()
        return self._top_k_finish(self._top_k_batch_dispatch(minhashes, k, method))

    def top_k_stream(self, batches, k: int, method: str = "auto", depth: int = 4):
        """Pipelined :meth:`top_k`: yields one result list per batch of
        ``batches``, with up to ``depth`` batches in flight."""
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'bands' or 'scan'")
        self._flush_pending()
        return stream_batches(
            batches,
            lambda b: self._top_k_batch_dispatch(b, k, method),
            self._top_k_finish,
            depth=depth,
        )

    def _top_k_batch_dispatch(self, minhashes, k: int, method: str):
        """A batch's top-k enqueued on the card, or the number of queries
        when there is nothing to ask (an empty index)."""
        minhashes = _batch_rows(minhashes)
        if self._sigs is None or not len(self._keys):
            return len(minhashes)
        q = self._queries(minhashes)
        if not q.shape[0]:
            return 0
        return self._top_k_dispatch(q, k, method)

    def _top_k_finish(self, item) -> list:
        if isinstance(item, int):
            return [[] for _ in range(item)]
        top_ids, top_sc, trunc = item
        self.last_truncated = int(_host(trunc))
        return _decode_rows(_host(top_ids), _host(top_sc), self._keys, True)

    def _top_k_dispatch(self, q: torch.Tensor, k: int, method: str):
        """One top-k batch on the card: (ids, scores, truncated)."""
        method = self._pick(method, q.shape[0])
        if method == "scan":
            top_ids, top_sc = lsh_ops.topk_scan(
                self._sigs, q, k, alive=self._alive_state()[0]
            )
            return top_ids, top_sc, 0
        if self._alive_state()[1]:
            return lsh_ops.topk_fused(
                self._sorted_fp, self._sorted_ids, self._sigs, q, self.b,
                self.r, self.bucket_cap, k,
            )
        flat, trunc = self._probe(q)
        scores = lsh_ops.rerank_jaccard(self._sigs, q, flat)
        top_ids, top_sc = lsh_ops.topk_candidates(scores, flat, k, max_dup=self.b)
        return top_ids, top_sc, trunc

    def warmup(self, batch_sizes=(8, 64), k: int = 10, method: str = "auto") -> None:
        """One synthetic :meth:`top_k` and :meth:`query_batch` per batch
        size, as the JAX package defines it (there it pays the compiles;
        here the first call builds the kernel library). No-op on an empty
        index."""
        self._flush_pending()
        if self._sigs is None or not len(self._keys):
            return
        rng = np.random.RandomState(0)
        for q in batch_sizes:
            sigs = rng.randint(0, 1 << 32, size=(int(q), self.in_width),
                               dtype=np.uint64).astype(np.uint32)
            self.top_k(sigs, k, method=method)
            self.query_batch(sigs)

    # ------------------------------------------------------------ persistence

    def _host_sigs(self) -> np.ndarray:
        if self._sigs is None:
            return np.zeros((0, self.in_width), np.uint32)
        return to_numpy_u32(self._sigs)

    def host_snapshot(self) -> dict:
        """Host copy of the queryable state: ``{"keys", "sigs", "alive"}``,
        ``sigs`` uint32 and ``alive`` None when nothing is tombstoned."""
        self._flush_pending()
        alive = None
        if self._alive is not None and not bool(self._alive.all()):
            alive = self._alive.copy()
        return {"keys": list(self._keys), "sigs": self._host_sigs(), "alive": alive}

    def save(self, path: str) -> None:
        """Persist to an ``.npz`` in the JAX package's layout (signatures,
        keys, tombstones; band tables are rebuilt on load). ``.npz`` is
        appended when missing."""
        from datasketch_tpu_torch.persist import atomic_savez, npz_path, pack_keys

        self._flush_pending()
        atomic_savez(
            npz_path(path),
            sigs=self._host_sigs(),
            alive=self._alive if self._alive is not None else np.ones(0, dtype=bool),
            keys=pack_keys(self._keys),
            meta=np.array([self.h, self.b, self.r, self.bucket_cap, int(self.rerank),
                           self.in_width], dtype=np.int64),
            threshold=np.float64(self.threshold),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "TorchMinHashLSH":
        """Load an index saved by either package (the 5-field ``meta`` of
        older files too) onto ``device``.

        SECURITY: the key list inside the file is a pickle payload -- only
        load index files you created or trust.
        """
        from datasketch_tpu_torch.persist import npz_path, unpack_keys

        data = np.load(npz_path(path), allow_pickle=False)
        meta = [int(x) for x in data["meta"]]
        h, b, r, cap, rerank = meta[:5]
        in_width = meta[5] if len(meta) > 5 else h
        index = cls(threshold=float(data["threshold"]), num_perm=h, params=(b, r),
                    bucket_cap=cap, rerank=bool(rerank),
                    cascade_perm=in_width if in_width != h else None, device=device)
        keys = unpack_keys(data["keys"])
        sigs = data["sigs"]
        if sigs.shape[0]:
            index._keys = keys
            index._key_to_pos = {k: i for i, k in enumerate(keys) if k is not None}
            index._append(as_sig_tensor(sigs, index.device))
            if data["alive"].shape[0] == sigs.shape[0]:
                index._alive = data["alive"].copy()
        return index

    # ------------------------------------------------------------ band-limited

    def query_b(self, minhashes, b: int) -> list:
        """Candidate key sets probing only the first ``b`` bands (no
        rerank), as the containment ensemble probes its r-indexes."""
        out = self.query_b_dispatch(minhashes, b)
        if isinstance(out, list):
            return out
        return self.query_b_finish(out)

    def query_b_dispatch(self, minhashes, b: int):
        """Enqueue :meth:`query_b` on the card: (flat ids int32[Q, b*cap]
        with tombstones masked, truncated, Q), or the answer itself when
        the index is empty. ``truncated`` counts cap overflow over all
        bands and over the zero rows that pad the JAX package's batch to
        a power of two (at least 8)."""
        if b > self.b:
            raise ValueError("b must be less or equal to the number of bands")
        self._flush_pending()
        if self._sigs is None or not len(self._key_to_pos):
            return [set() for _ in minhashes]
        q = self._queries(minhashes)
        nq = q.shape[0]
        flat, trunc = lsh_ops.query_bands_masked(
            self._sorted_fp, self._sorted_ids, q, self.b, self.r, self.bucket_cap, b
        )
        n_zero = pow2_at_least(nq, 8) - nq
        if n_zero:
            zero = torch.zeros((1, self.in_width), dtype=torch.int32, device=self.device)
            trunc = trunc + n_zero * lsh_ops.query_bands_masked(
                self._sorted_fp, self._sorted_ids, zero, self.b, self.r, self.bucket_cap, b
            )[1]
        return self._mask_dead(flat), trunc, nq

    def query_b_finish(self, out) -> list:
        flat, trunc, nq = out
        ids_host = _host(flat)
        self.last_truncated = int(_host(trunc))
        return [{self._keys[p] for p in np.unique(row[row >= 0]).tolist()}
                for row in ids_host[:nq]]
