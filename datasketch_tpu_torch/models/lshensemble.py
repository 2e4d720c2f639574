"""LSH Ensemble on the host: per-x/q (b, r) tables, the size partitioner and
the storage-backed ``MinHashLSHEnsemble``.

Copied from the numpy-only code of ``datasketch_tpu/models/lshensemble.py``
(containment FP/FN integrals by fixed-order Gauss-Legendre quadrature over
the whole (b, r) grid, the expected-false-positive matrix from cumulative
sums, and the partition DP with vectorized inner minimizations), so the
port chooses the same partitions and the same (b, r) for every query.
:class:`MinHashLSHEnsemble` is the JAX package's host class over the port's
host :class:`~datasketch_tpu_torch.models.lsh.MinHashLSH`.
"""

from __future__ import annotations

import functools
import struct
from collections import Counter
from typing import Hashable, Iterable, Optional

import numpy as np

from datasketch_tpu_torch.models.lsh import MinHashLSH, _random_name
from datasketch_tpu_torch.models.lsh_params import _gauss_legendre

__all__ = ["MinHashLSHEnsemble", "optimal_partitions"]


def _containment_fp_fn(threshold: float, bs, rs, xq: float, n_quad: int = 64):
    """Containment FP/FN integrals for arrays of (b, r); integrand
    ``1 - (1 - (t/(1+xq-t))^r)^b`` with the reference's integration limits."""
    x, w = _gauss_legendre(n_quad)
    bs = np.asarray(bs, dtype=np.float64)[:, None]
    rs = np.asarray(rs, dtype=np.float64)[:, None]

    def collide_prob(t):
        s = t / (1.0 + xq - t)
        return 1.0 - (1.0 - s**rs) ** bs

    fp_hi = min(threshold, xq)
    s1 = 0.5 * fp_hi * (x + 1.0)
    fp = np.sum(0.5 * fp_hi * w * collide_prob(s1[None, :]), axis=1)

    fn_hi = min(1.0, xq)
    if fn_hi <= threshold:
        fn = np.zeros(bs.shape[0])
    else:
        s2 = threshold + 0.5 * (fn_hi - threshold) * (x + 1.0)
        fn = np.sum(
            0.5 * (fn_hi - threshold) * w * (1.0 - collide_prob(s2[None, :])),
            axis=1,
        )
    return fp, fn


@functools.lru_cache(maxsize=512)
def _optimal_containment_param(
    threshold: float, num_perm: int, max_r: int, xq: float, fpw: float, fnw: float
):
    pairs = [
        (b, r)
        for b in range(1, num_perm + 1)
        for r in range(1, max_r + 1)
        if b * r <= num_perm
    ]
    fp, fn = _containment_fp_fn(
        threshold, [p[0] for p in pairs], [p[1] for p in pairs], xq
    )
    err = fp * fpw + fn * fnw
    return pairs[int(np.argmin(err))]


def optimal_params_table(threshold: float, num_perm: int, m: int, weights):
    """(xqs float64[10], params int[10, 2]): the optimal (b, r) at 10
    query-to-set size ratios log-spaced in e^[-5, 5]."""
    fpw, fnw = weights
    xqs = np.exp(np.linspace(-5, 5, 10))
    params = np.array(
        [
            _optimal_containment_param(threshold, num_perm, m, float(xq), fpw, fnw)
            for xq in xqs
        ],
        dtype=int,
    )
    return xqs, params


def params_for(xqs: np.ndarray, params: np.ndarray, x, q) -> np.ndarray:
    """(b, r) rows for set sizes ``x`` and query sizes ``q`` (broadcasting
    arrays): the first table ratio >= x/q, the last one past the end."""
    ratio = np.asarray(x, dtype=np.float64) / np.asarray(q, dtype=np.float64)
    i = np.minimum(np.searchsorted(xqs, ratio, side="left"), len(params) - 1)
    return params[i]


def _nfps_matrix(counts: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """nfps[l, u] = sum_{i=l..u} (sizes[u] - sizes[i]) / sizes[u] * counts[i]
    for every interval, via cumulative sums."""
    counts = counts.astype(np.float64)
    sizes = sizes.astype(np.float64)
    ccum = np.concatenate([[0.0], np.cumsum(counts)])
    scum = np.concatenate([[0.0], np.cumsum(sizes * counts)])
    n = len(sizes)
    l = np.arange(n)[:, None]
    u = np.arange(n)[None, :]
    cnt = ccum[u + 1] - ccum[l]
    s = scum[u + 1] - scum[l]
    with np.errstate(invalid="ignore", divide="ignore"):
        nfps = cnt - s / sizes[None, :]
    return np.where(l <= u, nfps, 0.0)


def _best_partitions(num_part: int, sizes: np.ndarray, nfps: np.ndarray):
    """DP over partition boundaries, inner minimizations vectorized."""
    if num_part < 2:
        raise ValueError("num_part cannot be less than 2")
    if num_part > len(sizes):
        raise ValueError(
            "num_part cannot be greater than the domain size of all set sizes"
        )
    n = len(sizes)
    if num_part == 2:
        vals = nfps[0, : n - 1] + nfps[np.arange(1, n), n - 1]
        u = int(np.argmin(vals))
        return [(sizes[0], sizes[u]), (sizes[u + 1], sizes[-1])], float(vals[u])

    cost = np.full((n, num_part - 1), np.inf)
    for u in range(1, n):
        cost[u, 0] = np.min(nfps[0, :u] + nfps[np.arange(1, u + 1), u])
    for p in range(3, num_part):
        pi = p - 2
        for u in range(p - 1, n):
            lo = p - 2
            vals = cost[lo:u, pi - 1] + nfps[np.arange(lo + 1, u + 1), u]
            cost[u, pi] = np.min(vals)
    p = num_part
    lo = p - 2
    vals = cost[lo : n - 1, p - 3] + nfps[np.arange(lo + 1, n), n - 1]
    u = lo + int(np.argmin(vals))
    total = float(np.min(vals))
    partitions = [(sizes[u + 1], sizes[-1])]
    p -= 1
    while p > 1:
        if p == 2:
            vals = nfps[0, :u] + nfps[np.arange(1, u + 1), u]
            u1 = int(np.argmin(vals))
        else:
            lo = p - 2
            vals = cost[lo:u, p - 3] + nfps[np.arange(lo + 1, u + 1), u]
            u1 = lo + int(np.argmin(vals))
        partitions.insert(0, (sizes[u1 + 1], sizes[u]))
        u = u1
        p -= 1
    partitions.insert(0, (sizes[0], sizes[u]))
    return partitions, total


def optimal_partitions(sizes, counts, num_part: int):
    """Optimal size-partition intervals [(lower, upper), ...], inclusive,
    for the distinct ``sizes`` (ascending) and their ``counts``."""
    sizes = np.asarray(sizes)
    counts = np.asarray(counts)
    if num_part < 2:
        return [(sizes[0], sizes[-1])]
    if num_part >= len(sizes):
        return [(x, x) for x in sizes]
    nfps = _nfps_matrix(counts, sizes)
    partitions, _ = _best_partitions(num_part, sizes, nfps)
    return partitions


class MinHashLSHEnsemble:
    """Containment-threshold index: size partitions × per-r LSH sub-indexes.

    Args:
        threshold: Containment threshold in [0, 1].
        num_perm: Signature length.
        num_part: Number of size partitions (more = better accuracy).
        m: Memory factor (max r considered; ~m× the memory of one LSH).
        weights: (fp_weight, fn_weight) for the optimizer.
        storage_config / prepickle: as in :class:`MinHashLSH`.
    """

    def __init__(
        self,
        threshold: float = 0.9,
        num_perm: int = 128,
        num_part: int = 16,
        m: int = 8,
        weights: tuple = (0.5, 0.5),
        storage_config: Optional[dict] = None,
        prepickle: Optional[bool] = None,
    ) -> None:
        if threshold > 1.0 or threshold < 0.0:
            raise ValueError("threshold must be in [0.0, 1.0]")
        if num_perm < 2:
            raise ValueError("Too few permutation functions")
        if num_part < 1:
            raise ValueError("num_part must be at least 1")
        if m < 2 or m > num_perm:
            raise ValueError("m must be in the range of [2, num_perm]")
        if any(w < 0.0 or w > 1.0 for w in weights):
            raise ValueError("Weight must be in [0.0, 1.0]")
        if sum(weights) != 1.0:
            raise ValueError("Weights must sum to 1.0")
        self.threshold = threshold
        self.h = num_perm
        self.m = m
        rs = self._init_optimal_params(weights)
        storage_config = storage_config if storage_config else {"type": "dict"}
        basename = storage_config.get("basename", _random_name(11))
        if isinstance(basename, str):
            basename = basename.encode("ascii")
        self.indexes = [
            {
                r: MinHashLSH(
                    num_perm=self.h,
                    params=(int(self.h / r), r),
                    storage_config=self._get_storage_config(
                        basename, storage_config, partition, r
                    ),
                    prepickle=prepickle,
                )
                for r in rs
            }
            for partition in range(0, num_part)
        ]
        self.lowers = [None for _ in self.indexes]
        self.uppers = [None for _ in self.indexes]

    def _init_optimal_params(self, weights):
        self.xqs, self.params = optimal_params_table(
            self.threshold, self.h, self.m, weights
        )
        return {int(r) for _, r in self.params}

    def _get_storage_config(self, basename, base_config, partition, r):
        config = dict(base_config)
        config["basename"] = b"-".join(
            [basename, struct.pack(">H", partition), struct.pack(">H", r)]
        )
        return config

    def index(self, entries: Iterable) -> None:
        """One-shot build from ``(key, minhash, size)`` tuples: DP-optimal
        size partitions, then insert each set into its partition's every
        r-index (lshensemble.py:189-228)."""
        if not self.is_empty():
            raise ValueError("Cannot call index again on a non-empty index")
        entries = list(entries)
        for _, _, size in entries:
            if size <= 0:
                raise ValueError("Set size must be positive")
        if len(entries) == 0:
            raise ValueError("entries is empty")
        sizes, counts = np.array(
            sorted(Counter(e[2] for e in entries).most_common())
        ).T
        partitions = optimal_partitions(sizes, counts, len(self.indexes))
        for i, (lower, upper) in enumerate(partitions):
            self.lowers[i], self.uppers[i] = lower, upper
        entries.sort(key=lambda e: e[2])
        curr_part = 0
        for key, minhash, size in entries:
            u = self.uppers[curr_part]
            if size > u:
                curr_part += 1
            for r in self.indexes[curr_part]:
                self.indexes[curr_part][r].insert(key, minhash)

    def query(self, minhash, size: int):
        """Yield keys of sets whose containment of the query likely exceeds
        the threshold: per partition, pick (b, r) by the x/q ratio and probe
        the first b bands of that partition's r-index."""
        for i, index in enumerate(self.indexes):
            u = self.uppers[i]
            if u is None:
                continue
            b, r = params_for(self.xqs, self.params, float(u), float(size))
            for key in index[int(r)]._query_b(minhash, int(b)):
                yield key

    def __contains__(self, key: Hashable) -> bool:
        return any(any(key in index[r] for r in index) for index in self.indexes)

    def is_empty(self) -> bool:
        return all(all(index[r].is_empty() for r in index) for index in self.indexes)
