"""Plain answers of a MinHash LSH index, worked out anew from its rows.

- Score of a stored row for a query: its equal slots over the signature
  width (a count over 128 is exact in float32 and float64 alike).
- Order of an answer: score descending, then row id ascending.
- By scan: every row is a candidate.
- By bands: the signature's first b*r slots cut into b bands of r; a
  band's bucket key is the fmix32 fold of its slots from 0x9E3779B9 (the
  configuration's banding); per (query, band) the candidates are the
  ``bucket_cap`` lowest row ids whose key equals the query's.
- Top-k: the k best distinct candidates. Threshold query: every distinct
  candidate scoring at least the threshold; by scan at most ``max_out``
  of them, the first in order.

Rows and queries are int32 tensors of uint32 bit patterns; ``slot_bits``
below 32 compares only the low bits of each slot (b-bit MinHash), the
control's cheaper compare. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference.minhash import fmix32

FP_SEED = 0x9E3779B9
M32 = 0xFFFFFFFF


def _slots(x: torch.Tensor, slot_bits: int) -> torch.Tensor:
    return x if slot_bits == 32 else x & ((1 << slot_bits) - 1)


def counts(rows: torch.Tensor, q: torch.Tensor, slot_bits: int = 32,
           q_block: int = 64, n_block: int = 32768) -> torch.Tensor:
    """Equal slots int32[Q, N] of every query against every row."""
    rows, q = _slots(rows, slot_bits), _slots(q, slot_bits)
    out = torch.empty((q.shape[0], rows.shape[0]), dtype=torch.int32, device=rows.device)
    for q0 in range(0, q.shape[0], q_block):
        qb = q[q0: q0 + q_block, None, :]
        for n0 in range(0, rows.shape[0], n_block):
            eq = rows[None, n0: n0 + n_block, :] == qb
            out[q0: q0 + q_block, n0: n0 + n_block] = eq.sum(dim=2, dtype=torch.int32)
    return out


def topk_scan(rows: torch.Tensor, q: torch.Tensor, k: int, slot_bits: int = 32,
              q_block: int = 128) -> list:
    """Per query, the k best [(row id, score)] by (score desc, id asc)."""
    p, n = rows.shape[1], rows.shape[0]
    ids = torch.arange(n, device=rows.device, dtype=torch.int64)
    out = []
    for q0 in range(0, q.shape[0], q_block):
        c = counts(rows, q[q0: q0 + q_block], slot_bits).to(torch.int64)
        best = torch.topk(c * (1 << 32) - ids[None, :], min(k, n), dim=1).values
        best_c = torch.div(best + (1 << 32) - 1, 1 << 32, rounding_mode="floor")
        best_id = best_c * (1 << 32) - best
        out += [[(i, ci / p) for i, ci in zip(row_id, row_c)]
                for row_id, row_c in zip(best_id.tolist(), best_c.tolist())]
    return out


def band_keys(sigs: torch.Tensor, b: int, r: int, slot_bits: int = 32) -> torch.Tensor:
    """int64[N, b] bucket keys: the fmix32 fold of each band's r slots."""
    s = _slots(sigs, slot_bits).to(torch.int64) & M32
    key = torch.full((sigs.shape[0], b), FP_SEED, dtype=torch.int64, device=sigs.device)
    for i in range(r):
        key = fmix32(key ^ s[:, i: b * r: r])
    return key


def need_count(p: int, threshold: float) -> int:
    """The least equal-slot count whose score reaches ``threshold``."""
    return next(c for c in range(p + 2) if c == p + 1 or c / p >= threshold)


def threshold_scan(rows: torch.Tensor, q: torch.Tensor, threshold: float, max_out: int,
                   slot_bits: int = 32, q_block: int = 64) -> list:
    """Per query, [(row id, score)] of every row scoring >= ``threshold``,
    in order, cut to the first ``max_out``."""
    p = rows.shape[1]
    need = need_count(p, threshold)
    out = []
    for q0 in range(0, q.shape[0], q_block):
        c = counts(rows, q[q0: q0 + q_block], slot_bits)
        for row in c:
            ids = torch.nonzero(row >= need).flatten()
            found = sorted(zip(ids.tolist(), row[ids].tolist()), key=lambda t: (-t[1], t[0]))
            out.append([(row_id, ci / p) for row_id, ci in found[:max_out]])
    return out


def band_candidates(row_keys: torch.Tensor, q_keys: torch.Tensor, cap: int) -> list:
    """Per query, the sorted distinct row ids that its bands' buckets
    yield, each (query, band) its ``cap`` lowest ids."""
    cand = [set() for _ in range(q_keys.shape[0])]
    for band in range(q_keys.shape[1]):
        hit = torch.nonzero(row_keys[None, :, band] == q_keys[:, band, None])  # [m, 2]
        if not hit.shape[0]:
            continue
        qi, rid = hit[:, 0], hit[:, 1]  # by query, then ascending row id
        first = torch.searchsorted(qi, qi, side="left")
        rank = torch.arange(qi.shape[0], device=qi.device) - first
        keep = rank < cap
        for i, row_id in zip(qi[keep].tolist(), rid[keep].tolist()):
            cand[i].add(row_id)
    return [sorted(ids) for ids in cand]


def _scored(rows: torch.Tensor, query: torch.Tensor, ids: list, slot_bits: int) -> list:
    """[(row id, equal slots)] of ``ids`` against one query, in order."""
    if not ids:
        return []
    sel = torch.tensor(ids, device=rows.device, dtype=torch.int64)
    c = (_slots(rows[sel], slot_bits) == _slots(query, slot_bits)[None, :]).sum(dim=1)
    return sorted(zip(ids, c.tolist()), key=lambda t: (-t[1], t[0]))


def _by_bands(rows, q, b, r, cap, slot_bits, q_block, pick) -> list:
    p = rows.shape[1]
    row_keys = band_keys(rows, b, r, slot_bits)
    q_keys = band_keys(q, b, r, slot_bits)
    out = []
    for q0 in range(0, q.shape[0], q_block):
        cand = band_candidates(row_keys, q_keys[q0: q0 + q_block], cap)
        for i, ids in enumerate(cand):
            found = pick(_scored(rows, q[q0 + i], ids, slot_bits))
            out.append([(row_id, ci / p) for row_id, ci in found])
    return out


def topk_bands(rows: torch.Tensor, q: torch.Tensor, k: int, b: int, r: int, cap: int,
               slot_bits: int = 32, q_block: int = 128) -> list:
    """Per query, the k best [(row id, score)] of its band candidates."""
    return _by_bands(rows, q, b, r, cap, slot_bits, q_block, lambda found: found[:k])


def bands_threshold(rows: torch.Tensor, q: torch.Tensor, b: int, r: int, cap: int,
                    threshold: float, slot_bits: int = 32, q_block: int = 128) -> list:
    """Per query, [(row id, score)] of every band candidate scoring >=
    ``threshold``, in order."""
    need = need_count(rows.shape[1], threshold)
    return _by_bands(rows, q, b, r, cap, slot_bits, q_block,
                     lambda found: [t for t in found if t[1] >= need])
