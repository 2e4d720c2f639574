"""LSH Forest on the card (functional core).

Port of ``datasketch_tpu/ops/forest_ops.py``. Per tree, a cumulative
fingerprint per prefix length (``fp[lev]`` folds the tree's first lev + 1
signature slots with fmix32) turns prefix equality into integer equality
at every level; one lexicographic sort per tree makes the rows that share
a prefix of any length contiguous. A query narrows its run level by level
with bounded binary searches, gathers up to ``cap`` rows per (tree,
level), keeps each row's deepest match and reranks a pool of the deepest
with kernel 3 (:func:`~datasketch_tpu_torch.ops.lsh_ops.rerank_jaccard`).

Fingerprints are uint32 values held in int32 tensors with the sign bit
flipped (``u - 2**31``): that view orders like the unsigned values, so the
sorts and the searches compare them as the JAX package does, at half the
bytes of int64. The sorts, searches, dedupe and top-k are torch ops, in
the tie order of ``lax.sort`` / ``lax.top_k`` (stable sorts; among equal
keys the lowest position first).
"""

from __future__ import annotations

import numpy as np
import torch

from datasketch_tpu_torch.device import u32_bits
from datasketch_tpu_torch.ops.hashing import mix32, mix32_np
from datasketch_tpu_torch.ops.lsh_ops import _desc_stable, _pad_cols, rerank_jaccard

__all__ = [
    "prefix_fingerprints",
    "build_forest",
    "build_forest_host",
    "query_forest",
    "forest_topk",
    "forest_query_fused",
    "fingerprints_u32",
]

_FP_SEED = 0x85EBCA6B
_BIAS = 1 << 31


def fingerprints_u32(fps: torch.Tensor) -> np.ndarray:
    """Order-preserving int32 fingerprints (any device) -> host uint32."""
    return (fps.to(torch.int64) + _BIAS).cpu().numpy().astype(np.uint32)


def prefix_fingerprints(sigs: torch.Tensor, l: int, k: int) -> torch.Tensor:
    """Cumulative per-prefix fingerprints: int32[N, P] -> int32[l, k, N].

    ``out[tree, lev, i]`` hashes row i's slots ``[tree*k : tree*k+lev+1]``
    (uint32 in the order-preserving int32 view).
    """
    n = sigs.shape[0]
    trees = sigs[:, : l * k].reshape(n, l, k)
    h = torch.full((n, l), _FP_SEED, dtype=torch.int64, device=sigs.device)
    out = torch.empty((l, k, n), dtype=torch.int32, device=sigs.device)
    for lev in range(k):
        h = mix32(h ^ u32_bits(trees[:, :, lev]))
        out[:, lev, :] = (h - _BIAS).to(torch.int32).T
    return out


def build_forest(fps: torch.Tensor):
    """Lexicographic sort per tree: int32[l, k, N] -> (int32[l, k, N] sorted
    fingerprints, int32[l, N] row ids).

    One stable sort per level, from the last level to the first, over all
    trees at once: the order equals ``np.lexsort``'s (level 0 primary, ties
    by row id), so the result is :func:`build_forest_host`'s bit for bit.
    """
    l, k, n = fps.shape
    order = torch.arange(n, device=fps.device).expand(l, n)
    for lev in range(k - 1, -1, -1):
        keys = torch.gather(fps[:, lev, :], 1, order)
        _, idx = torch.sort(keys, dim=1, stable=True)
        order = torch.gather(order, 1, idx)
    sorted_fps = torch.gather(fps, 2, order[:, None, :].expand(l, k, n))
    return sorted_fps, order.to(torch.int32)


def build_forest_host(sigs, l: int, k: int):
    """Host build: fingerprints and a per-tree ``np.lexsort`` (a copy of the
    JAX package's). Returns numpy ``(sorted_fps uint32[l, k, N], sorted_ids
    int32[l, N])``."""
    sigs = np.asarray(sigs, dtype=np.uint32)
    n = sigs.shape[0]
    trees = sigs[:, : l * k].reshape(n, l, k)
    fps = np.empty((l, k, n), np.uint32)
    h = np.full((n, l), _FP_SEED, np.uint32)
    for lev in range(k):
        h = mix32_np(h ^ trees[:, :, lev])
        fps[:, lev, :] = h.T
    sorted_fps = np.empty_like(fps)
    sorted_ids = np.empty((l, n), np.int32)
    for t in range(l):
        order = np.lexsort(fps[t][::-1])  # lexsort's last key is primary
        sorted_ids[t] = order.astype(np.int32)
        sorted_fps[t] = fps[t][:, order]
    return sorted_fps, sorted_ids


def _run_bounds(row, q, lo, hi):
    """Left and right bounds of each query value inside its sorted window.

    ``row``: [l, N] (sorted within every window), ``q``: [l, Q], ``lo`` /
    ``hi``: int64[l, Q] window bounds. Both bisections advance in lockstep
    for ``bit_length(N) + 1`` steps, as in the JAX package (a per-query
    window is not a ``searchsorted``): the left one over ``v < q``, the
    right one over ``v <= q``, stacked as [l, 2Q].
    """
    n = row.shape[1]
    nq = q.shape[1]
    last = n - 1
    # v <= q  <=>  v < q + 1: one compare serves both bisections
    q2 = torch.cat([q, q], dim=1).to(torch.int64)
    q2[:, nq:] += 1
    plo, phi = torch.cat([lo, lo], dim=1), torch.cat([hi, hi], dim=1)
    for _ in range(n.bit_length() + 1):
        active = plo < phi
        mid = (plo + phi) >> 1
        v = torch.gather(row, 1, mid.clamp(0, last))
        right = v.to(torch.int64) < q2
        plo = torch.where(active & right, mid + 1, plo)
        phi = torch.where(active & ~right, mid, phi)
    return plo[:, :nq], plo[:, nq:]


def _query_forest_rows(sorted_fps, sorted_ids, q_fps, cap: int):
    """:func:`query_forest` with the truncation count per query (int64[Q])."""
    l, k, n = sorted_fps.shape
    nq = q_fps.shape[2]
    dev = sorted_fps.device
    lo = torch.zeros((l, nq), dtype=torch.int64, device=dev)
    hi = torch.full((l, nq), n, dtype=torch.int64, device=dev)
    slots = torch.arange(cap, device=dev)
    out = torch.empty((nq, k, l, cap), dtype=torch.int32, device=dev)
    trunc = torch.zeros(nq, dtype=torch.int64, device=dev)
    for lev in range(k):
        lo, hi = _run_bounds(sorted_fps[:, lev, :], q_fps[:, lev, :], lo, hi)
        pos = lo[:, :, None] + slots
        valid = pos < hi[:, :, None]
        ids = torch.gather(sorted_ids, 1, torch.where(valid, pos, 0).reshape(l, nq * cap))
        ids = torch.where(valid, ids.reshape(l, nq, cap), -1)
        out[:, lev] = ids.permute(1, 0, 2)
        trunc += (hi - lo - cap).clamp_min(0).sum(dim=0)
    return out.reshape(nq, k, l * cap), trunc


def query_forest(sorted_fps, sorted_ids, q_fps, cap: int):
    """Prefix-run candidates at every level for a query batch.

    Args:
        sorted_fps: int32[l, k, N] built forest; sorted_ids: int32[l, N].
        q_fps: int32[l, k, Q] query prefix fingerprints.
        cap: max rows gathered per (query, tree, level) run.

    Returns:
        ids: int32[Q, k, l*cap], levels by ascending prefix length, trees
            in order within a level; -1 where invalid.
        truncated: int64 scalar tensor, rows dropped by the cap, summed
            over levels (parent runs contain their children).
    """
    ids, trunc = _query_forest_rows(sorted_fps, sorted_ids, q_fps, cap)
    return ids, trunc.sum()


def forest_topk(db_sigs, q_sigs, level_ids, k_out: int, n_valid=None, pool: int = 0,
                rank: str = "forest", rerank=rerank_jaccard):
    """Level-weighted dedupe + top-k over per-level candidates.

    Phase 1 keeps each id's deepest match (a sort by (id, -depth)) and
    pools the ``pool`` deepest; phase 2 scores the pool with ``rerank``
    (kernel 3). With ``rank='forest'`` the score is ``2*depth + jaccard``
    in f32 (deeper matches first); with ``'jaccard'`` the estimate alone.

    Args:
        pool: pool size; 0 means ``max(32, 4*k_out)`` for 'forest' and
            ``max(256, 8*k_out)`` for 'jaccard'.
        rerank: the candidate scorer, ``(db, q, cand) -> f32[Q, C]``.

    Returns:
        (ids int32[Q, k_out], jaccard f32[Q, k_out], level int64[Q, k_out]
        -- the matched prefix length, 0 where the slot is empty).
    """
    if rank not in ("forest", "jaccard"):
        raise ValueError("rank must be 'forest' or 'jaccard'")
    nq, klev, c = level_ids.shape
    flat = level_ids.reshape(nq, klev * c).to(torch.int64)
    if n_valid is not None:
        flat = torch.where(flat < n_valid, flat, -1)
    length = 1 + torch.arange(klev * c, device=flat.device) // c
    length = torch.where(flat >= 0, length, 0)
    # phase 1: one key per slot, ascending (id, -depth); an id's first
    # slot holds its deepest match
    key, _ = torch.sort((flat + 1) * (klev + 1) + (klev - length), dim=1)
    ids_s = key // (klev + 1) - 1
    depth_s = klev - key % (klev + 1)
    best = ids_s >= 0
    best[:, 1:] &= ids_s[:, 1:] != ids_s[:, :-1]
    depth = torch.where(best, depth_s, -1)
    if not pool:
        pool = max(32, 4 * k_out) if rank == "forest" else max(256, 8 * k_out)
    pool = min(pool, depth.shape[1])
    pool_depth, pos = _desc_stable(depth, pool)
    pool_ids = torch.where(pool_depth >= 1, torch.gather(ids_s, 1, pos), -1)
    # phase 2: rerank the pool only
    jac = rerank(db_sigs, q_sigs, pool_ids.to(torch.int32))
    if rank == "forest":
        score = torch.where(pool_ids >= 0, 2.0 * pool_depth.to(torch.float32) + jac, -1.0)
    else:
        score = torch.where(pool_ids >= 0, jac, -1.0)
    top_sc, pos2 = _desc_stable(score, min(k_out, pool))
    hit = top_sc >= 0
    top_ids = torch.where(hit, torch.gather(pool_ids, 1, pos2), -1).to(torch.int32)
    top_jac = torch.where(hit, torch.gather(jac, 1, pos2), -1.0)
    top_len = torch.where(hit, torch.gather(pool_depth, 1, pos2), 0)
    return _pad_cols(top_ids, k_out, -1), _pad_cols(top_jac, k_out, -1.0), \
        _pad_cols(top_len, k_out, 0)


def forest_query_fused(sorted_fps, sorted_ids, db_sigs, q_sigs, l: int, k_prefix: int,
                       cap: int, k_out: int, n_valid=None, pool: int = 0,
                       rank: str = "forest", zero_rows: int = 0, rerank=rerank_jaccard):
    """Whole forest query: query fingerprints -> per-level run narrowing ->
    gather -> level-weighted top-k (``rank``, ``pool`` and ``rerank`` as in
    :func:`forest_topk`).

    ``zero_rows``: the truncation count also covers that many all-zero
    query rows (the rows the JAX facade pads a batch with), walked as one.

    Returns (ids, jaccard, level, truncated int64 scalar tensor).
    """
    nq = q_sigs.shape[0]
    q_walk = q_sigs
    if zero_rows:
        q_walk = torch.cat([q_sigs, torch.zeros_like(q_sigs[:1])])
    level_ids, trunc = _query_forest_rows(
        sorted_fps, sorted_ids, prefix_fingerprints(q_walk, l, k_prefix), cap
    )
    total = trunc[:nq].sum()
    if zero_rows:
        total = total + zero_rows * trunc[nq]
    top_ids, top_jac, top_len = forest_topk(db_sigs, q_sigs, level_ids[:nq], k_out, n_valid,
                                            pool=pool, rank=rank, rerank=rerank)
    return top_ids, top_jac, top_len, total
