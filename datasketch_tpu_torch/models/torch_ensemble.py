"""TorchMinHashLSHEnsemble -- containment-threshold index on the card.

Port of ``datasketch_tpu/models/tpu_ensemble.py::TpuMinHashLSHEnsemble``:
the same DP size partitioner and per-x/q (b, r) tables
(:mod:`datasketch_tpu_torch.models.lshensemble`), and per unique r one
stacked ``[parts, b, N_pad]`` band table for all partitions, probed in one
pass with per-(query, partition) band counts. ``method="scan"`` scores the
containment estimate of every stored set instead (kernel 2's sizes mode in
its emit variant: one pass writes every query's hits and exact match
count; only queries past ``max_results`` are scanned again). Answers equal
the JAX package's: band results as
sets, scan results as ordered lists, ``last_truncated`` included, and
checkpoints load in either package.

Weighted sketches go in as the JAX package's do: WeightedMinHash objects
and [N, S, 2] (k, t) batches are mixed to slots (``ops.cws_ops.kt_slots``,
on the batch's own device for a tensor).
"""

from __future__ import annotations

import numbers
from typing import Hashable, Iterable

import numpy as np
import torch

from datasketch_tpu_torch.device import as_sig_tensor, resolve_device, to_numpy_u32
from datasketch_tpu_torch.models.lshensemble import (
    optimal_params_table,
    optimal_partitions,
    params_for,
)
from datasketch_tpu_torch.models.minhash import MinHash, pow2_at_least
from datasketch_tpu_torch.models.torch_lsh import _as_signature_matrix, _fetch
from datasketch_tpu_torch.ops import lsh_ops
from datasketch_tpu_torch.utils.pipeline import stream_batches
from datasketch_tpu_torch.utils.profiling import count, device_sync, recording, span

__all__ = ["TorchMinHashLSHEnsemble"]

_METHODS = ("auto", "bands", "scan")
def _host_sizes(sizes) -> np.ndarray:
    """Set sizes as int64[N] on the host, each as ``int(size)``."""
    if isinstance(sizes, torch.Tensor):
        sizes = sizes.cpu().numpy()
    arr = np.asarray(sizes)
    if arr.dtype.kind in "iub":
        return arr.astype(np.int64).reshape(-1)
    return np.fromiter((int(s) for s in sizes), dtype=np.int64, count=len(arr))


def _distinct_counts(token_docs, device: torch.device) -> np.ndarray:
    """``np.unique(doc).size`` of every document, computed in one pass: a
    stable sort by token, then by document, and a count of the (document,
    token) runs. Integer tokens are compared as int64 (a bijection of
    every integer dtype up to 64 bits); other dtypes take ``np.unique``."""
    arrays = [np.asarray(d).reshape(-1) for d in token_docs]
    n = len(arrays)
    lengths = np.fromiter(map(len, arrays), dtype=np.int64, count=n)
    nonempty = [a for a in arrays if a.size]
    if not nonempty:
        return np.zeros(n, dtype=np.int64)
    flat = np.concatenate(nonempty)
    if flat.dtype.kind not in "iub":
        return np.fromiter((np.unique(a).size for a in arrays), dtype=np.int64, count=n)
    vals = torch.from_numpy(flat.astype(np.int64, copy=False)).to(device)
    doc = torch.repeat_interleave(
        torch.arange(n, device=device), torch.from_numpy(lengths).to(device)
    )
    vals, order = torch.sort(vals, stable=True)
    doc, order = torch.sort(doc[order], stable=True)
    vals = vals[order]
    first = torch.ones(vals.shape[0], dtype=torch.bool, device=device)
    first[1:] = (doc[1:] != doc[:-1]) | (vals[1:] != vals[:-1])
    return torch.bincount(doc[first], minlength=n).cpu().numpy()


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _answer_lists(row_keys: np.ndarray, ids: np.ndarray, answers) -> list:
    """Per query, the keys of its ``answers[i]`` row ids, taken in turn
    from the flat ``ids``."""
    found = row_keys[ids].tolist()
    ends = np.cumsum(answers).tolist()
    return [found[a:b] for a, b in zip([0] + ends[:-1], ends)]


class TorchMinHashLSHEnsemble:
    """Containment index with stacked partitions on the card.

    Args:
        threshold: containment threshold in [0, 1].
        num_perm: signature length.
        num_part: number of size partitions.
        m: memory factor (largest r considered).
        weights: (fp_weight, fn_weight) for the (b, r) optimizer.
        bucket_cap: max bucket members gathered per (query, band);
            overflow is counted in ``last_truncated``.
        max_results: per-(query, r-probe) result cap of the band path and
            per-query cap of the scan; overflow is counted in
            ``last_truncated``.
        device: ``"cuda"`` (default) or ``"cpu"`` (plain PyTorch versions
            of the kernels). No silent fallback.
    """

    def __init__(
        self,
        threshold: float = 0.9,
        num_perm: int = 128,
        num_part: int = 16,
        m: int = 8,
        weights: tuple = (0.5, 0.5),
        bucket_cap: int = 128,
        max_results: int = 2048,
        device="cuda",
    ) -> None:
        if threshold > 1.0 or threshold < 0.0:
            raise ValueError("threshold must be in [0.0, 1.0]")
        if num_part < 1:
            raise ValueError("num_part must be at least 1")
        if m < 2 or m > num_perm:
            raise ValueError("m must be in the range of [2, num_perm]")
        if any(w < 0.0 or w > 1.0 for w in weights):
            raise ValueError("Weight must be in [0.0, 1.0]")
        if sum(weights) != 1.0:
            raise ValueError("Weights must sum to 1.0")
        self.device = resolve_device(device)
        self.threshold = threshold
        self.h = num_perm
        self.m = m
        self.num_part = num_part
        self.bucket_cap = bucket_cap
        self.max_results = max_results
        self.weights = tuple(weights)
        self.xqs, self.params = optimal_params_table(threshold, num_perm, m, weights)
        self.rs = sorted({int(r) for _, r in self.params})
        self.lowers = [None] * num_part
        self.uppers = [None] * num_part

        self._keys_per_part: list = [[] for _ in range(num_part)]
        self._key_set: set = set()
        self._n_pad = 0
        self._sigs = None  # int32[parts, N_pad, P] stacked signatures
        self._n_valid = None  # int32[parts] host row counts
        self._n_valid_dev = None
        self._tables: dict = {}  # r -> (sorted_fp, sorted_ids) [parts, b, N_pad]
        self._sizes_host = None  # int32[parts, N_pad] exact set sizes, 0 = padding
        self._keys_flat = None  # object[parts * N_pad]: global row id -> key
        self._scan_compact = None  # lazy compact scan-only table
        self.last_truncated = 0

    # ------------------------------------------------------------------ build

    def index(self, entries: Iterable) -> None:
        """One-shot bulk build from ``(key, minhash, size)`` entries."""
        entries = list(entries)
        keys = [e[0] for e in entries]
        sizes = _host_sizes([e[2] for e in entries])
        self._build(keys, _as_signature_matrix([e[1] for e in entries], self.device), sizes)

    def index_batch(self, keys, minhashes, sizes) -> None:
        """One-shot bulk build from a signature batch (uint32 numpy matrix,
        int32 tensor, [N, P, 2] (k, t) batch, or rows / MinHash-like or
        WeightedMinHash objects) and the exact set sizes."""
        keys = list(keys)
        sigs = _as_signature_matrix(minhashes, self.device)
        sizes = _host_sizes(sizes)
        if not (len(keys) == sigs.shape[0] == len(sizes)):
            raise ValueError("keys, minhashes and sizes must have equal length")
        self._build(keys, sigs, sizes)

    def index_tokens(self, keys, token_docs, seed: int = 1) -> None:
        """One-shot bulk build from pre-tokenized integer documents: token
        ids are hashed on the card (kernel 1, ``hashfunc="device"``) and
        each set size is the exact distinct-id count. Query with
        ``hashfunc="device"`` sketches at equal seed."""
        if len(keys) != len(token_docs):
            raise ValueError("keys and token_docs must have equal length")
        sigs = MinHash.bulk_signatures(
            token_docs, num_perm=self.h, seed=seed, hashfunc="device",
            out="device", device=self.device,
        )
        self._build(list(keys), sigs, _distinct_counts(token_docs, self.device))

    def _build(self, keys: list, sigs: torch.Tensor, sizes: np.ndarray) -> None:
        """DP size partitions, entries sorted by size (stably) into them,
        every partition padded to one power-of-two row count, then the
        stacked band tables of every r."""
        if not self.is_empty():
            raise ValueError("Cannot call index again on a non-empty index")
        if len(keys) == 0:
            raise ValueError("entries is empty")
        if (sizes <= 0).any():
            raise ValueError("Set size must be positive")
        if sigs.shape[1] != self.h:
            raise ValueError(
                "Expecting minhash with length %d, got %d" % (self.h, sigs.shape[1])
            )
        distinct, counts = np.unique(sizes, return_counts=True)
        for i, (lower, upper) in enumerate(
            optimal_partitions(distinct, counts, self.num_part)
        ):
            self.lowers[i], self.uppers[i] = lower, upper
        order = np.argsort(sizes, kind="stable")
        sorted_sizes = sizes[order]
        # every partition holds at least one distinct size, so walking the
        # sorted entries and stepping to the next partition past each upper
        # bound is this search
        uppers = np.array([u for u in self.uppers if u is not None])
        part_of = np.searchsorted(uppers, sorted_sizes, side="left")
        bounds = np.searchsorted(part_of, np.arange(self.num_part + 1), side="left")
        n_valid = np.diff(bounds).astype(np.int32)
        n_pad = pow2_at_least(int(n_valid.max()))
        self._n_pad = n_pad
        rng = np.random.RandomState(n_pad & 0x7FFFFFFF)
        stack = torch.empty((self.num_part, n_pad, self.h), dtype=torch.int32,
                            device=self.device)
        stack_sizes = np.zeros((self.num_part, n_pad), dtype=np.int32)
        order_dev = torch.from_numpy(order).to(self.device)
        for part in range(self.num_part):
            lo, hi = int(bounds[part]), int(bounds[part + 1])
            group = hi - lo
            self._keys_per_part[part] = [keys[i] for i in order[lo:hi].tolist()]
            self._key_set.update(self._keys_per_part[part])
            if group:
                stack[part, :group] = sigs[order_dev[lo:hi]]
                stack_sizes[part, :group] = sorted_sizes[lo:hi]
            # padding rows get pseudo-random signatures so they spread over
            # the buckets, drawn in the JAX package's order (tables equal
            # bit for bit); n_valid masks them from the band probes, size 0
            # from the scan
            if group < n_pad:
                pad = rng.randint(0, 1 << 32, size=(n_pad - group, self.h),
                                  dtype=np.uint64).astype(np.uint32)
                stack[part, group:] = as_sig_tensor(pad, self.device)
        self._n_valid = n_valid
        self._set_sizes(stack_sizes)
        self._build_tables(stack)

    def _set_sizes(self, sizes: np.ndarray) -> None:
        self._sizes_host = sizes.astype(np.int32)
        self._scan_compact = None

    def _build_tables(self, stack: torch.Tensor) -> None:
        """Keep the stacked signatures and derive every r's band tables."""
        self._sigs = stack
        self._n_valid_dev = torch.from_numpy(self._n_valid).to(self.device)
        for r in self.rs:
            self._tables[r] = lsh_ops.build_tables_stacked(stack, self.h // r, r)

    def _scan_table(self):
        """Compact scan-only layout, built on the first scan query: the
        stacked table pads every partition to the largest one, so its real
        rows are gathered into one [N_real_pad, P] table with their sizes
        and keys. Padding rows re-read row 0 and carry size 0, which the
        scan masks.

        Returns (sigs, sizes, keys, n_rows_padded).
        """
        if self._scan_compact is None:
            flat_sizes = self._sizes_host.reshape(-1)
            real = np.nonzero(flat_sizes > 0)[0]
            n_pad = pow2_at_least(real.size)
            sel = np.zeros(n_pad, dtype=np.int64)
            sel[: real.size] = real
            sizes_c = np.zeros(n_pad, dtype=np.int32)
            sizes_c[: real.size] = flat_sizes[real]
            flat = self._sigs.reshape(-1, self.h)
            self._scan_compact = (
                flat[torch.from_numpy(sel).to(self.device)],
                torch.from_numpy(sizes_c).to(self.device),
                self._flat_keys()[real],
                n_pad,
            )
        return self._scan_compact

    def _flat_keys(self) -> np.ndarray:
        """Object array: global row id (part * N_pad + local) -> key."""
        if self._keys_flat is None:
            flat = np.empty(self.num_part * self._n_pad, dtype=object)
            for part, keys in enumerate(self._keys_per_part):
                off = part * self._n_pad
                for i, key in enumerate(keys):  # one by one: tuple keys
                    flat[off + i] = key  # must not broadcast
            self._keys_flat = flat
        return self._keys_flat

    # ------------------------------------------------------------------ query

    def _as_query_batch(self, queries):
        """(sizes int64[Q], q_sigs int32[Q, P] or None) from an iterable of
        ``(minhash, size)`` pairs, one ``(signature, size)`` pair, or a
        ``(batch, sizes)`` pair: a 2-D signature batch or an [N, P, 2]
        (k, t) batch, and one size per row."""
        if isinstance(queries, tuple) and len(queries) == 2:
            first, second = queries
            if _is_array(first) and first.ndim >= 2:
                if not (_is_array(second) or isinstance(second, (list, tuple))):
                    raise ValueError(
                        "a (batch, sizes) query needs one size per row of the "
                        "batch, got %r" % (type(second).__name__,)
                    )
                q_sigs = _as_signature_matrix(first, self.device)
                sizes = _host_sizes(second)
                if q_sigs.shape[0] != len(sizes):
                    raise ValueError("batch and sizes must have equal length")
                return sizes, q_sigs
            if ((_is_array(first) and first.ndim == 1) or hasattr(first, "hashvalues")) \
                    and isinstance(second, (numbers.Integral, np.integer)):
                queries = [queries]  # one (signature, size) query
        pairs = list(queries)
        if not pairs:
            return np.zeros(0, dtype=np.int64), None
        try:
            minhashes = [mh for mh, _ in pairs]
            sizes = [size for _, size in pairs]
        except (TypeError, ValueError) as exc:
            raise ValueError(
                "queries must be (minhash, size) pairs or one (batch, sizes) pair"
            ) from exc
        return _host_sizes(sizes), _as_signature_matrix(minhashes, self.device)

    def _resolve_scan_method(self, method: str, q_pad: int) -> str:
        """'auto' picks the scan whenever the stacked table is no larger
        than the band path's worst-case gather volume (the JAX package's
        rule, kept so both facades take the same path)."""
        has_sizes = self._sizes_host is not None
        if method == "auto":
            n_total = self.num_part * self._n_pad
            gather_slots = q_pad * self.num_part * sum(
                (self.h // r) * self.bucket_cap for r in self.rs
            )
            method = "scan" if has_sizes and n_total <= gather_slots else "bands"
        if method == "scan" and not has_sizes:
            raise ValueError(
                "method='scan' needs stored set sizes -- this index was loaded "
                "from a pre-sizes checkpoint; re-save it or query with "
                "method='bands'"
            )
        return method

    def query(self, minhash, size: int, method: str = "auto"):
        """Yield candidate keys (containment >= threshold likely)."""
        for row in self.query_batch([(minhash, size)], method=method):
            yield from row

    def query_batch(self, queries, method: str = "auto") -> list:
        """Batched containment query over ``(minhash, size)`` pairs.

        method: ``'bands'`` (per unique r one probe of every partition,
        the first b bands of the (b, r) each query's x/q ratio picks per
        partition; keys in no particular order), ``'scan'`` (the
        containment estimate ``c = J*(x+q)/((1+J)*q)`` of every stored set,
        keys with c >= threshold in (c desc, row asc) order, at most
        ``max_results``), or ``'auto'`` (scan when the stacked table is no
        larger than the band path's gather volume).
        """
        if method not in _METHODS:
            raise ValueError("method must be 'auto', 'bands' or 'scan'")
        with span("dstt.facade.query_batch"):
            with span("dstt.upload.queries"):
                sizes, q_sigs = self._as_query_batch(queries)
            if not len(sizes) or not self._tables:
                return [[] for _ in range(len(sizes))]
            if q_sigs.shape[1] != self.h:
                raise ValueError(
                    "Expecting minhash with length %d, got %d" % (self.h, q_sigs.shape[1])
                )
            q_pad = pow2_at_least(q_sigs.shape[0], 8)
            if self._resolve_scan_method(method, q_pad) == "scan":
                return self._scan_finish(self._scan_dispatch(q_sigs, sizes))
            return self._query_bands(q_sigs, sizes, q_pad)

    def _b_keep(self, sizes: np.ndarray, q_pad: int) -> dict:
        """{r: int32[q_pad, parts]}: the band count each (query, partition)
        probes in the r-table its x/q ratio picks (0 elsewhere and for
        padding queries)."""
        if (sizes == 0).any():
            raise ValueError("query set sizes must be non-zero")
        b_keep = {r: np.zeros((q_pad, self.num_part), dtype=np.int32) for r in self.rs}
        used = [p for p, u in enumerate(self.uppers) if u is not None]
        ups = np.array([float(self.uppers[p]) for p in used])
        br = params_for(self.xqs, self.params, ups[None, :], sizes[:, None])
        nq = len(sizes)
        for r in self.rs:
            b_keep[r][:nq, used] = np.where(br[..., 1] == r, br[..., 0], 0)
        return b_keep

    def _query_bands(self, q_sigs: torch.Tensor, sizes: np.ndarray, q_pad: int) -> list:
        """Band probes: zero-padded queries (as in the JAX package, whose
        ``last_truncated`` counts their cap overflow too), one probe per
        unique r, dedupe and compaction on the card, one fetch per probe,
        and keys gathered into sets."""
        nq = q_sigs.shape[0]
        b_keep = self._b_keep(sizes, q_pad)
        q = torch.nn.functional.pad(q_sigs, (0, 0, 0, q_pad - nq))
        probes = []
        for r in self.rs:
            if not b_keep[r].any():
                continue
            sorted_fp, sorted_ids = self._tables[r]
            flat, trunc = lsh_ops.query_stacked_masked(
                sorted_fp, sorted_ids, q, self.h // r, r, self.bucket_cap,
                torch.from_numpy(b_keep[r]).to(self.device), self._n_valid_dev,
            )
            max_out = min(self.max_results, flat.shape[1])
            sel_ids, n_match = lsh_ops.unique_compact(flat, max_out)
            packed = torch.cat([sel_ids.long(), n_match[:, None].long(),
                                trunc.reshape(1, 1).expand(q_pad, 1)], dim=1)
            probes.append((packed, max_out))
        results = [set() for _ in range(nq)]
        total_trunc = 0
        keys_flat = self._flat_keys()
        for packed, max_out in probes:
            host = packed.cpu().numpy()
            ids_host, n_host = host[:nq, :-2], host[:, -2]
            total_trunc += int(host[0, -1]) + int(np.maximum(n_host - max_out, 0).sum())
            hit = ids_host >= 0
            found = keys_flat[ids_host[hit]].tolist()
            pos = 0
            for qi, count in enumerate(hit.sum(axis=1).tolist()):
                results[qi].update(found[pos: pos + count])
                pos += count
        self.last_truncated = total_trunc
        return [list(r) for r in results]

    def _scan_dispatch(self, q_sigs: torch.Tensor, sizes: np.ndarray):
        """Enqueue the first pass on the card: every query's hits, sorted,
        in a row of ``max_out`` slots, and its exact match count. Returns
        what :meth:`_scan_finish` takes: the counts, the cap, and the hits
        and queries behind a closure, so that :meth:`query_stream` copies
        back only the counts and the rescan and compaction stay on the
        card."""
        flat_sigs, flat_sizes, _, _ = self._scan_table()
        max_out = min(self.max_results, flat_sigs.shape[0])
        q_sizes = torch.from_numpy(sizes.astype(np.int32)).to(self.device)
        keys, n_match = lsh_ops.containment_first_pass(
            flat_sigs, flat_sizes, q_sigs, q_sizes, self.threshold, max_out)
        return n_match, max_out, lambda: (keys, q_sigs, q_sizes)

    def _scan_finish(self, item) -> list:
        """Finish one dispatched scan batch on the compact table
        (:meth:`_finish_pass`), copy back only the answers' row ids and
        decode them into keys."""
        n_match, max_out, on_card = item
        rec = recording()
        flat_sigs, flat_sizes, scan_keys, _ = self._scan_table()
        n_host, answers, flat_ids = self._finish_pass(
            flat_sigs, flat_sizes, n_match, *on_card(), max_out, rec)
        self.last_truncated = int(np.maximum(n_host - max_out, 0).sum())
        (ids_host,) = _fetch(flat_ids[: int(answers.sum())])
        with span("dstt.facade.decode"):
            out = _answer_lists(scan_keys, ids_host, answers)
        if rec:
            count("ensemble.matches", int(n_host.sum()))
            count("facade.answers", int(answers.sum()))
        return out

    def _finish_pass(self, sigs, sizes, n_match, keys, q_sigs, q_sizes, cap: int,
                     rec: bool):
        """One table's steps after its first pass: fetch the match counts;
        rescan the queries past ``cap`` (under ``dstt.facade.rerun``, which
        waits for the rescan's device work); compact the answers' row ids
        on the card. Rows of ``keys`` past ``q_sigs``' (the sharded scan's
        zero row) are only counted; counters move only when ``rec``.
        Returns (match counts int64[rows] and answers int64[Q] on the host,
        the answers' row ids int32 flat on the card)."""
        nq = q_sigs.shape[0]
        n_host = _fetch(n_match)[0].astype(np.int64)
        real = n_host[:nq]
        over = int((real > cap).sum())
        chunks = 0
        if over:
            with span("dstt.facade.rerun"):
                chunks = lsh_ops.containment_rescan(sigs, sizes, q_sigs, q_sizes,
                                                    self.threshold, keys[:nq], real)
                device_sync(keys.device)
        if rec:
            count("ensemble.passes", 1 + chunks)
            count("ensemble.rescanned", over)
        with span("dstt.glue.select_hits"):
            _, flat_ids, _ = lsh_ops.compact_rows(lsh_ops.hit_ids(keys[:nq]))
        return n_host, np.minimum(real, cap), flat_ids

    def query_stream(self, batches, depth: int = 4):
        """Pipelined containment scans (the scan path of :meth:`query_batch`)
        over an iterable of query batches, each in any form
        :meth:`query_batch` takes: yields one result list per batch, with up
        to ``depth`` batches in flight. A batch with queries past
        ``max_results`` rescans them when it is finished. Needs stored set
        sizes."""

        def dispatch(batch):
            with span("dstt.upload.queries"):
                sizes, q_sigs = self._as_query_batch(batch)
            if not len(sizes) or not self._tables:
                return len(sizes)
            if q_sigs.shape[1] != self.h:
                raise ValueError(
                    "Expecting minhash with length %d, got %d" % (self.h, q_sigs.shape[1])
                )
            self._resolve_scan_method("scan", pow2_at_least(len(sizes), 8))
            return self._scan_dispatch(q_sigs, sizes)

        def finish(item):
            if isinstance(item, int):
                return [[] for _ in range(item)]
            return self._scan_finish(item)

        return stream_batches(batches, dispatch, finish, depth=depth)

    def warmup(self, batch_sizes=(8,), sizes=(100,)) -> None:
        """One synthetic ``query_batch`` per (batch size, set size), as the
        JAX package defines it. No-op before :meth:`index`."""
        if not self._tables:
            return
        rng = np.random.RandomState(0)
        for q in batch_sizes:
            sigs = rng.randint(0, 1 << 32, size=(int(q), self.h),
                               dtype=np.uint64).astype(np.uint32)
            for size in sizes:
                self.query_batch([(row, int(size)) for row in sigs])

    # ------------------------------------------------------------ persistence

    def save(self, path: str) -> None:
        """Persist to ``.npz`` in the JAX package's ``tpu_ensemble`` format:
        stacked signatures, partition bounds, sizes and keys (band tables
        are rebuilt on load)."""
        from datasketch_tpu_torch.persist import atomic_savez, pack_keys

        if self.is_empty():
            raise ValueError("Cannot save an empty index")
        fields = dict(
            kind=np.array("tpu_ensemble"),
            threshold=np.float64(self.threshold),
            num_perm=np.int64(self.h),
            num_part=np.int64(self.num_part),
            m=np.int64(self.m),
            bucket_cap=np.int64(self.bucket_cap),
            weights=np.asarray(self.weights, dtype=np.float64),
            lowers=np.array([-1 if x is None else int(x) for x in self.lowers], np.int64),
            uppers=np.array([-1 if x is None else int(x) for x in self.uppers], np.int64),
            n_valid=self._n_valid,
            sigs=self._host_stack(),
            keys=pack_keys(self._keys_per_part),
        )
        if self._sizes_host is not None:
            fields["sizes"] = self._sizes_host
        atomic_savez(path, **fields)

    def _host_stack(self) -> np.ndarray:
        """uint32[parts, N_pad, P] host copy of the stacked signatures."""
        return to_numpy_u32(self._sigs)

    @classmethod
    def load(cls, path: str, device="cuda") -> "TorchMinHashLSHEnsemble":
        """Load a ``tpu_ensemble`` checkpoint written by either package.

        SECURITY: the key lists inside the file are a pickle payload --
        only load index files you created or trust.
        """
        from datasketch_tpu_torch.persist import npz_path, unpack_keys

        data = np.load(npz_path(path), allow_pickle=False)
        if str(data["kind"]) != "tpu_ensemble":
            raise ValueError("not a TpuMinHashLSHEnsemble checkpoint")
        if "weights" not in data:
            raise ValueError(
                "checkpoint predates the weights field -- re-save it with the "
                "writing library version"
            )
        obj = cls(
            threshold=float(data["threshold"]),
            num_perm=int(data["num_perm"]),
            num_part=int(data["num_part"]),
            m=int(data["m"]),
            bucket_cap=int(data["bucket_cap"]),
            weights=tuple(float(w) for w in data["weights"]),
            device=device,
        )
        obj.lowers = [None if x < 0 else int(x) for x in data["lowers"]]
        obj.uppers = [None if x < 0 else int(x) for x in data["uppers"]]
        obj._n_valid = data["n_valid"].astype(np.int32)
        sigs = data["sigs"]
        obj._n_pad = sigs.shape[1]
        obj._keys_per_part = unpack_keys(data["keys"])
        obj._key_set = set().union(*map(set, obj._keys_per_part))
        if "sizes" in data:
            obj._set_sizes(data["sizes"])
        # a pre-sizes checkpoint stays loadable, bands-only
        obj._build_tables(as_sig_tensor(sigs, obj.device))
        return obj

    # -------------------------------------------------------------- plumbing

    def __contains__(self, key: Hashable) -> bool:
        return key in self._key_set

    def is_empty(self) -> bool:
        return not self._key_set

    def __len__(self) -> int:
        return len(self._key_set)
