"""(b, r) banding optimizer, copied from ``datasketch_tpu/models/lsh.py``.

NumPy only: the false-positive / false-negative integrals of every (b, r)
pair with fixed-order Gauss-Legendre quadrature, and the pair of least
weighted error (25 bands of 5 rows at threshold 0.5, num_perm 128).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["optimal_param"]


@functools.lru_cache(maxsize=256)
def _gauss_legendre(n: int):
    return np.polynomial.legendre.leggauss(n)


def _integrate_probs(threshold: float, bs, rs, n_quad: int = 64):
    """FP/FN integrals for arrays of (b, r) pairs:
    fp = int_0^t 1-(1-s^r)^b ds ; fn = int_t^1 (1-s^r)^b ds."""
    x, w = _gauss_legendre(n_quad)
    bs = np.asarray(bs, dtype=np.float64)[:, None]
    rs = np.asarray(rs, dtype=np.float64)[:, None]
    s1 = 0.5 * threshold * (x + 1.0)
    w1 = 0.5 * threshold * w
    fp = np.sum(w1 * (1.0 - (1.0 - s1[None, :] ** rs) ** bs), axis=1)
    s2 = threshold + 0.5 * (1.0 - threshold) * (x + 1.0)
    w2 = 0.5 * (1.0 - threshold) * w
    fn = np.sum(w2 * ((1.0 - s2[None, :] ** rs) ** bs), axis=1)
    return fp, fn


@functools.lru_cache(maxsize=1024)
def optimal_param(threshold: float, num_perm: int,
                  false_positive_weight: float, false_negative_weight: float):
    """The (b, r) with b * r <= num_perm of least weighted FP + FN error."""
    pairs = [
        (b, r)
        for b in range(1, num_perm + 1)
        for r in range(1, num_perm // b + 1)
    ]
    fp, fn = _integrate_probs(threshold, [p[0] for p in pairs], [p[1] for p in pairs])
    error = fp * false_positive_weight + fn * false_negative_weight
    return pairs[int(np.argmin(error))]
