"""Degraded-mode serving: host failover for device-resident indexes.

Port of ``datasketch_tpu/serving.py``. A device-resident index adds a
failure mode the reference library never had: a wedged card HANGS
dispatches rather than raising, so a serving replica silently stops
answering. :class:`FailoverIndex` pairs a
:class:`~datasketch_tpu_torch.models.torch_lsh.TorchMinHashLSH` with a
:class:`~datasketch_tpu_torch.utils.health.HealthMonitor` and a host-side
snapshot of the signature matrix:

- while the monitor reports healthy, queries go to the device path
  (banded probe / exact scan on the card);
- once the monitor trips, queries are answered from the snapshot by an
  exact host scan: slower, but exact over the stored sketches, and it
  makes no CUDA call at all.

Only a failed probe trips the monitor. A device dispatch that raises an
error that is neither the caller's nor a kernel's (``KernelError``: a
build or launch failure) runs one probe through the monitor; if that
leaves the monitor unhealthy the query is answered from the host, and
otherwise the error is raised. A card that probes healthy never moves
the work to the host, so a fault of the program always surfaces.

Every answer records the path that gave it (``last_path``), and
``status()`` reports ``serving_from_host``. The monitor must run
OUT-OF-BAND (its subprocess probes are killable; see ``utils/health.py``):
a dispatch already sent to a wedged card cannot be cancelled from this
process, so the wrapper's job is to stop *new* queries from touching the
card once it is known bad, not to rescue in-flight ones.

Failback is explicit: after the card recovers, call
:meth:`FailoverIndex.resume_device`; automatic failback would re-wedge the
process on a flapping card.
"""

from __future__ import annotations

from typing import Hashable, Optional

import numpy as np
import torch

from datasketch_tpu_torch.kernels.build import KernelError
from datasketch_tpu_torch.models.torch_lsh import _host_rows
from datasketch_tpu_torch.ops.cws_ops import kt_slots_np
from datasketch_tpu_torch.utils.health import HealthMonitor

__all__ = ["FailoverIndex", "host_topk_scan"]


def _host_signature_matrix(minhashes) -> np.ndarray:
    """Queries as a host uint32[Q, P] matrix, like the snapshot's, with no
    CUDA call: a numpy matrix, an [Q, P, 2] (k, t) batch, a sequence of
    rows or MinHash / WeightedMinHash objects. A tensor is read with
    ``.cpu()`` (int32 signature bits are viewed as uint32), which is the
    only way a device tensor of queries can reach the host."""
    if isinstance(minhashes, torch.Tensor):
        x = minhashes.detach().cpu()
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        minhashes = x.numpy()
        if minhashes.ndim == 2 and minhashes.dtype == np.int32:
            minhashes = minhashes.view(np.uint32)
    if isinstance(minhashes, np.ndarray) and minhashes.ndim == 2:
        return np.ascontiguousarray(minhashes, dtype=np.uint32)
    if isinstance(minhashes, np.ndarray) and minhashes.ndim == 3:
        return kt_slots_np(minhashes)
    return _host_rows(list(minhashes))


def _host_scores(sigs: np.ndarray, q_row: np.ndarray,
                 alive: Optional[np.ndarray]) -> np.ndarray:
    """Estimated Jaccard of one query row vs every stored signature
    (matching-slot fraction); tombstoned rows score -1."""
    scores = (sigs == q_row[None, :]).mean(axis=1)
    if alive is not None:
        scores = np.where(alive, scores, -1.0)
    return scores


def host_topk_scan(
    sigs: np.ndarray,
    q_sigs: np.ndarray,
    k: int,
    alive: Optional[np.ndarray] = None,
):
    """Exact top-k over a host signature matrix (the JAX package's numpy
    code, tie order included).

    Jaccard is estimated as the per-row fraction of matching signature
    slots (the MinHash estimator). Returns ``(ids int64[Q, k], scores
    float64[Q, k])`` with ``-1`` ids padding short rows. Within a tie at
    the k-th score, ``argpartition`` picks the members and the stable
    ``argsort`` keeps the partition's order, which is not ascending id.

    One query row at a time keeps the working set at ``N x P`` bools.
    """
    n = sigs.shape[0]
    q = q_sigs.shape[0]
    ids_out = np.full((q, k), -1, dtype=np.int64)
    sc_out = np.zeros((q, k), dtype=np.float64)
    if n == 0:
        return ids_out, sc_out
    for qi in range(q):
        scores = _host_scores(sigs, q_sigs[qi], alive)
        kk = min(k, n)
        part = np.argpartition(-scores, kk - 1)[:kk]
        order = part[np.argsort(-scores[part], kind="stable")]
        valid = scores[order] >= 0.0
        m = int(valid.sum())
        ids_out[qi, :m] = order[valid]
        sc_out[qi, :m] = scores[order][valid]
    return ids_out, sc_out


class FailoverIndex:
    """Health-routed facade over a device index with a host snapshot.

    >>> index = TorchMinHashLSH(threshold=0.5, num_perm=128)
    >>> index.index(keys, minhashes)
    >>> fo = FailoverIndex(index)           # takes the snapshot now
    >>> fo.check()                          # out-of-band health probe
    >>> fo.top_k(queries, k=10)             # device, or host if tripped

    Args:
        index: a ``TorchMinHashLSH`` (anything with ``top_k``,
            ``query_batch``, ``host_snapshot`` and ``threshold``).
        monitor: optional pre-configured ``HealthMonitor``; by default a
            subprocess-isolated one with 3-strike eviction.
        snapshot: take the host snapshot immediately (requires a healthy
            card, since the signatures live there). Pass False and call
            :meth:`refresh_snapshot` yourself to control timing.

    The host path converts queries on the host (MinHash objects and numpy
    arrays never touch the card); a CUDA tensor of queries is read with
    ``.cpu()``.
    """

    def __init__(self, index, monitor: Optional[HealthMonitor] = None,
                 snapshot: bool = True) -> None:
        self._index = index
        self.monitor = monitor if monitor is not None else HealthMonitor()
        self._snapshot: Optional[dict] = None
        self.last_path: Optional[str] = None
        self.last_device_error: Optional[str] = None
        if snapshot:
            self.refresh_snapshot()

    # ------------------------------------------------------------- snapshot

    def refresh_snapshot(self) -> None:
        """Re-pull the host snapshot from the index (call after mutations,
        while the card is healthy)."""
        self._snapshot = self._index.host_snapshot()

    # ------------------------------------------------------------- health

    def check(self) -> dict:
        """Run one out-of-band health probe (see ``HealthMonitor``)."""
        return self.monitor.check()

    @property
    def serving_from_host(self) -> bool:
        return self.monitor.unhealthy

    def resume_device(self) -> None:
        """Explicit failback to the device path after recovery."""
        self.monitor.consecutive_failures = 0

    def _trips(self, exc: Exception) -> bool:
        """Whether a device-path error moves this query to the host: only
        when one probe through the monitor leaves it unhealthy. Caller and
        kernel errors re-raise without a probe."""
        if self._is_caller_error(exc) or isinstance(exc, KernelError):
            return False
        self.last_device_error = repr(exc)
        self.monitor.check()
        return self.monitor.unhealthy

    @staticmethod
    def _is_caller_error(exc: Exception) -> bool:
        """Input-validation errors mean a BAD QUERY, not a bad device:
        failing over on them would flip a healthy replica into degraded
        host serving (and then likely fail the host path too)."""
        return isinstance(exc, (ValueError, TypeError, KeyError))

    def _require_snapshot(self) -> dict:
        if self._snapshot is None:
            raise RuntimeError(
                "no host snapshot available — call refresh_snapshot() "
                "while the device is healthy"
            )
        return self._snapshot

    # ------------------------------------------------------------- queries

    def top_k(self, minhashes, k: int, **kwargs) -> list:
        """Per-query ``[(key, score), ...]`` rows, like the device index.

        Extra kwargs pass through to the device index; the host fallback
        honors ``return_scores`` (result SHAPE must not change
        mid-failover) and ignores device-only knobs like ``method``: the
        host scan is exact regardless.
        """
        if not self.serving_from_host:
            try:
                self.last_path = "device"
                return self._index.top_k(minhashes, k, **kwargs)
            except Exception as exc:  # noqa: BLE001 — a bad card fails over
                if not self._trips(exc):
                    raise
        self.last_path = "host"
        return_scores = kwargs.get("return_scores", True)
        snap = self._require_snapshot()
        ids, scores = host_topk_scan(
            snap["sigs"], _host_signature_matrix(minhashes), k,
            alive=snap.get("alive"),
        )
        keys = snap["keys"]
        if not return_scores:
            return [
                [keys[int(p)] for p in row_ids if p >= 0] for row_ids in ids
            ]
        return [
            [(keys[int(p)], float(s)) for p, s in zip(row_ids, row_sc) if p >= 0]
            for row_ids, row_sc in zip(ids, scores)
        ]

    def query_batch(self, minhashes, threshold: Optional[float] = None,
                    return_scores: bool = False, **kwargs) -> list:
        """Threshold query; the host path scans exactly at the cutoff."""
        if not self.serving_from_host:
            try:
                self.last_path = "device"
                return self._index.query_batch(
                    minhashes, threshold=threshold,
                    return_scores=return_scores, **kwargs
                )
            except Exception as exc:  # noqa: BLE001 — a bad card fails over
                if not self._trips(exc):
                    raise
        self.last_path = "host"
        snap = self._require_snapshot()
        cutoff = self._index.threshold if threshold is None else threshold
        q_sigs = _host_signature_matrix(minhashes)
        sigs, keys = snap["sigs"], snap["keys"]
        alive = snap.get("alive")
        out = []
        for qi in range(q_sigs.shape[0]):
            if sigs.shape[0] == 0:
                out.append([])
                continue
            scores = _host_scores(sigs, q_sigs[qi], alive)
            hits = np.nonzero(scores >= cutoff)[0]
            order = hits[np.argsort(-scores[hits], kind="stable")]
            if return_scores:
                out.append([(keys[int(p)], float(scores[p])) for p in order])
            else:
                out.append([keys[int(p)] for p in order])
        return out

    def query(self, minhash, threshold: Optional[float] = None) -> list:
        return self.query_batch([minhash], threshold=threshold)[0]

    # ------------------------------------------------------------- misc

    def __contains__(self, key: Hashable) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def status(self) -> dict:
        snap = self._snapshot
        return {
            "serving_from_host": self.serving_from_host,
            "last_path": self.last_path,
            "last_device_error": self.last_device_error,
            "snapshot_rows": None if snap is None else int(snap["sigs"].shape[0]),
            "monitor": self.monitor.status(),
        }
