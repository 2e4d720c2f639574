"""Plain answers of a b-bit MinHash index, worked out anew from its
unpacked rows.

- A slot of a stored row and of a query are equal when their low b bits
  are (datasketch's ``bBitMinHash`` keeps ``hashvalue & (2**b - 1)``).
- Count of a stored row for a query: its equal slots among the first
  ``slots`` of the signature (all of them in the reference; fewer in the
  control).
- Order of an answer: count descending, then row id ascending; top-k is
  the k first rows in that order.
- Score: ``bBitMinHash.jaccard``'s unbiased estimate ``(count / num_perm -
  C1) / (1 - C2)`` in float64, with datasketch's ``_calc_a`` /
  ``_calc_c``.

Rows and queries are int32 tensors of uint32 bit patterns. The counts are
worked out a block of queries at a time, so that the block's counts and
keys stay a few GB beside the rows at 2**24 rows. Imports nothing of the
program.
"""

from __future__ import annotations

import torch

from portbench.reference.lsh import counts as equal_counts


def calc_a(r: float, b: int) -> float:
    """A(r, b) of the Li and Koenig estimator (its limit 2**-b as r -> 0)."""
    if r == 0.0:
        return 1.0 / (1 << b)
    return r * (1 - r) ** (2 ** b - 1) / (1 - (1 - r) ** (2 * b))


def calc_c(a1: float, a2: float, r1: float, r2: float):
    """(C1, C2) of two sketches' A and r."""
    if r1 == 0.0 and r2 == 0.0:
        return a1, a2
    div = 1 / (r1 + r2)
    return (a1 * r2 + a2 * r1) * div, (a1 * r1 + a2 * r2) * div


def score(count: int, num_perm: int, b: int, r: float) -> float:
    """``bBitMinHash.jaccard`` of two sketches of equal b and r whose
    ``count`` slots of ``num_perm`` are equal."""
    a = calc_a(r, b)
    c1, c2 = calc_c(a, a, r, r)
    return (float(count) / float(num_perm) - c1) / (1 - c2)


def low_bits(x: torch.Tensor, b: int) -> torch.Tensor:
    """The low ``b`` bits of each slot, as uint8 where they fit."""
    low = x & ((1 << b) - 1) if b < 32 else x
    return low.to(torch.uint8) if b <= 8 else low


def topk(rows: torch.Tensor, q: torch.Tensor, k: int, b: int, r: float,
         slots: int = None, q_block: int = 16, n_block: int = 131072) -> list:
    """Per query, the k best [(row id, score)] by (count desc, id asc),
    counting equal low-b bits over the first ``slots`` slots (None: all)."""
    num_perm = rows.shape[1]
    slots = num_perm if slots is None else slots
    db = low_bits(rows[:, :slots], b)
    qb = low_bits(q[:, :slots], b)
    n = rows.shape[0]
    ids = torch.arange(n, device=rows.device, dtype=torch.int64)
    out = []
    for q0 in range(0, qb.shape[0], q_block):
        c = equal_counts(db, qb[q0: q0 + q_block], 32, q_block, n_block).to(torch.int64)
        best = torch.topk(c * (1 << 32) - ids[None, :], min(k, n), dim=1).values
        del c
        best_c = torch.div(best + (1 << 32) - 1, 1 << 32, rounding_mode="floor")
        best_id = best_c * (1 << 32) - best
        out += [[(i, score(ci, num_perm, b, r)) for i, ci in zip(row_id, row_c)]
                for row_id, row_c in zip(best_id.tolist(), best_c.tolist())]
    return out
