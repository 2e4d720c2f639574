"""Device-resident LSH band tables and query pipelines (functional core).

Port of the functions of ``datasketch_tpu/ops/lsh_ops.py`` that the index
facade calls. Conventions:

- signatures: int32[N, P] tensors of uint32 bit patterns (equality only);
- band fingerprints: int64 holding 0..2**32-1, so sorts and
  ``searchsorted`` see the unsigned order of the JAX package's uint32, and
  ``fp >> shift`` is its unsigned shift (never shift an int32 view);
- tables: per band, fingerprints sorted with a stable sort (ties keep
  ascending doc id) and the matching int32 doc ids;
- tie order: ``lax.top_k`` puts the lowest index first among equal
  scores, which is a stable descending sort; ``torch.topk`` is used only
  on unique keys.

Kernels: the rerank is kernel 3 (the ``db_sigs[cand_ids]`` gather fused
in), the scan is kernel 2 for k <= 128 and a running top-k over kernel 4
(the score matrix) above that, as in the JAX package; the containment
scan is kernel 2's sizes mode for k <= 128 and the same running top-k
over kernel 4 above that.
"""

from __future__ import annotations

import numpy as np
import torch

from datasketch_tpu_torch.device import u32_bits
from datasketch_tpu_torch.kernels import lsh_scan, rerank, score
from datasketch_tpu_torch.ops.hashing import mix32

__all__ = [
    "band_fingerprints",
    "build_tables",
    "build_offsets",
    "bucket_stats",
    "query_tables",
    "query_tables_direct",
    "rerank_jaccard",
    "topk_candidates",
    "threshold_select",
    "unique_compact",
    "query_candidates_fused",
    "query_fused",
    "topk_fused",
    "topk_scan",
    "query_bands_masked",
    "build_tables_stacked",
    "query_stacked_masked",
    "containment_scan",
]

_FP_SEED = 0x9E3779B9


def band_fingerprints(sigs: torch.Tensor, b: int, r: int) -> torch.Tensor:
    """Fingerprint per band: int32[N, P] -> int64[N, b] (0..2**32-1).

    Sequential fmix32 fold over each band's r slots.
    """
    n = sigs.shape[0]
    bands = sigs[:, : b * r].reshape(n, b, r)
    h = torch.full((n, b), _FP_SEED, dtype=torch.int64, device=sigs.device)
    for i in range(r):
        h = mix32(h ^ u32_bits(bands[:, :, i]))
    return h


def build_tables(fps: torch.Tensor):
    """Sort (fingerprint, doc id) per band: [N, b] -> ([b, N], [b, N]).

    Returns (sorted_fp int64, sorted_ids int32); a bucket is a run of
    equal fingerprints, its ids ascending.
    """
    sorted_fp, order = torch.sort(fps.T.contiguous(), dim=1, stable=True)
    return sorted_fp, order.to(torch.int32)


def bucket_stats(sorted_fp: torch.Tensor):
    """(max_run int64[b], n_distinct int64[b]) of built band tables."""
    b, n = sorted_fp.shape
    idx = torch.arange(n, device=sorted_fp.device).expand(b, n)
    boundary = torch.ones((b, n), dtype=torch.bool, device=sorted_fp.device)
    boundary[:, 1:] = sorted_fp[:, 1:] != sorted_fp[:, :-1]
    last_start = torch.cummax(torch.where(boundary, idx, 0), dim=1).values
    run_len = idx - last_start + 1
    return run_len.max(dim=1).values, boundary.sum(dim=1)


def _bucket_windows(sorted_fp, sorted_ids, q_t, start, end, cap: int,
                    exact: bool):
    """ids int32[Q, b, cap] of the table positions [start, start + cap)
    below ``end`` (per band and query, [b, Q]), -1 elsewhere; with
    ``exact`` only positions whose fingerprint equals the query's. Also
    returns the window overflow (int64 scalar tensor)."""
    b, nq = start.shape
    pos = start[:, :, None] + torch.arange(cap, device=q_t.device)
    valid = pos < end[:, :, None]
    safe = torch.where(valid, pos, 0).reshape(b, nq * cap)
    if exact:
        fps = torch.gather(sorted_fp, 1, safe).reshape(b, nq, cap)
        valid &= fps == q_t[:, :, None]
    ids = torch.gather(sorted_ids, 1, safe)
    ids = torch.where(valid, ids.reshape(b, nq, cap), -1)
    trunc = (end - start - cap).clamp_min(0).sum()
    return ids.permute(1, 0, 2).contiguous(), trunc


def query_tables(sorted_fp, sorted_ids, q_fps, cap: int = 128):
    """Batched band-bucket lookup.

    Args:
        sorted_fp, sorted_ids: [b, N] built tables.
        q_fps: int64[Q, b] query fingerprints.
        cap: max members gathered per (query, band) bucket run.

    Returns:
        ids int32[Q, b, cap] candidate doc ids, -1 where invalid;
        truncated: int64 scalar tensor, candidates dropped by the cap.
    """
    q_t = q_fps.T.contiguous()  # [b, Q]
    start = torch.searchsorted(sorted_fp, q_t, side="left")
    end = torch.searchsorted(sorted_fp, q_t, side="right")
    return _bucket_windows(sorted_fp, sorted_ids, q_t, start, end, cap, exact=False)


def _bucket_shift(n_buckets: int) -> int:
    return 32 - int(n_buckets).bit_length() + 1


def build_offsets(sorted_fp, n_buckets: int):
    """Direct-address offsets over the sorted band tables: int32[b,
    n_buckets + 1].

    Fingerprints are uniform over 0..2**32-1, so their top
    ``log2(n_buckets)`` bits index a bucket; ``offsets[band, i]`` is the
    first table position whose fingerprint falls in bucket i. Queries then
    find their bucket with one gather instead of a binary search over N.
    """
    bucket = sorted_fp >> _bucket_shift(n_buckets)  # [b, N], nondecreasing
    bounds = torch.arange(n_buckets + 1, device=sorted_fp.device)
    bounds = bounds.expand(sorted_fp.shape[0], -1).contiguous()
    return torch.searchsorted(bucket, bounds, side="left").to(torch.int32)


def query_tables_direct(sorted_fp, sorted_ids, offsets, q_fps, cap: int,
                        n_buckets: int):
    """Band-bucket lookup by direct address (:func:`build_offsets`).

    The result contract of :func:`query_tables`, but ``cap`` bounds the
    scanned bucket *window* (a window holds every fingerprint sharing the
    top bits); entries of other fingerprints in it are dropped by an exact
    compare. ``truncated`` counts window overflow.
    """
    q_t = q_fps.T.contiguous()  # [b, Q]
    bk = q_t >> _bucket_shift(n_buckets)
    start = torch.gather(offsets, 1, bk).long()
    end = torch.gather(offsets, 1, bk + 1).long()
    return _bucket_windows(sorted_fp, sorted_ids, q_t, start, end, cap, exact=True)


def query_bands_masked(sorted_fp, sorted_ids, q_sigs, b: int, r: int,
                       cap: int, n_bands):
    """Probe all ``b`` bands, keep only the first ``n_bands``.

    ``n_bands`` is an int or an int tensor broadcasting against [Q, 1, 1].
    ``truncated`` counts cap overflow over all b bands, as the JAX package
    does (0 still means the kept results are exact).

    Returns (flat ids int32[Q, b*cap], truncated int64 scalar tensor).
    """
    ids, trunc = query_tables(sorted_fp, sorted_ids, band_fingerprints(q_sigs, b, r),
                              cap=cap)
    keep = torch.arange(b, device=ids.device)[None, :, None] < n_bands
    ids = torch.where(keep, ids, -1)
    return ids.reshape(q_sigs.shape[0], -1), trunc


def build_tables_stacked(sigs_stack: torch.Tensor, b: int, r: int):
    """Band tables of a stack of equally padded sub-indexes in one sort:
    int32[parts, N_pad, P] -> (sorted_fp int64, sorted_ids int32), each
    [parts, b, N_pad], ids local to their partition."""
    parts, n_pad, p = sigs_stack.shape
    fps = band_fingerprints(sigs_stack.reshape(parts * n_pad, p), b, r)
    fps = fps.reshape(parts, n_pad, b).transpose(1, 2).contiguous()
    sorted_fp, order = torch.sort(fps, dim=2, stable=True)
    return sorted_fp, order.to(torch.int32)


def query_stacked_masked(sorted_fp, sorted_ids, q_sigs, b: int, r: int,
                         cap: int, b_keep, n_valid):
    """Probe every partition of a stacked r-index with per-(query,
    partition) band counts.

    The partitions are flattened into one [parts * b, N_pad] table, so one
    ``searchsorted`` serves them all.

    Args:
        sorted_fp / sorted_ids: [parts, b, N_pad] stacked tables.
        q_sigs: int32[Q, P] queries.
        b_keep: int32[Q, parts] leading bands kept per (query, partition);
            0 disables the pair.
        n_valid: int32[parts] real row count per partition.

    Returns:
        (flat global ids int32[Q, parts*b*cap], global id = part * N_pad +
        local, -1 where masked; truncated int64 scalar tensor, cap
        overflow over all bands of all partitions).
    """
    parts, _, n_pad = sorted_fp.shape
    nq = q_sigs.shape[0]
    q_fps = band_fingerprints(q_sigs, b, r).repeat(1, parts)  # [Q, parts*b]
    ids, trunc = query_tables(sorted_fp.reshape(parts * b, n_pad),
                              sorted_ids.reshape(parts * b, n_pad), q_fps, cap=cap)
    ids = ids.reshape(nq, parts, b, cap)
    band = torch.arange(b, device=ids.device)[None, None, :, None]
    keep = band < b_keep[:, :, None, None]
    valid = keep & (ids >= 0) & (ids < n_valid[None, :, None, None])
    off = torch.arange(parts, device=ids.device, dtype=torch.int32) * n_pad
    ids = torch.where(valid, ids + off[None, :, None, None], -1)
    return ids.reshape(nq, -1), trunc


def rerank_jaccard(db_sigs, q_sigs, cand_ids):
    """f32[Q, C] estimated Jaccard of each query against its candidate
    rows (0 where the id is -1): kernel 3, which reads the candidate rows
    straight from the table."""
    return rerank.rerank_scores(
        db_sigs.contiguous(), q_sigs.contiguous(),
        cand_ids.to(torch.int32).contiguous(),
    )


def _desc_stable(x: torch.Tensor, k: int):
    """(values, positions) of the k largest per row, lowest position first
    among equal values -- ``lax.top_k``'s order."""
    vals, pos = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def _pad_cols(x: torch.Tensor, width: int, value) -> torch.Tensor:
    if x.shape[1] >= width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[1]), value=value)


def _dedupe_sorted(ids, scores):
    """Sort each row by id (stable) and flag the first of each distinct
    valid id. Returns (ids_s, sc_s, first)."""
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    sc_s = torch.gather(scores, 1, order)
    first = ids_s >= 0
    first[:, 1:] &= ids_s[:, 1:] != ids_s[:, :-1]
    return ids_s, sc_s, first


def topk_candidates(scores, ids, k: int, max_dup: int = 0):
    """Dedupe + top-k over gathered candidates.

    Args:
        scores: f32[Q, C]; ids: int32[Q, C] (-1 = invalid).
        max_dup: if > 0, an id appears at most this many times per row;
            the top ``k * max_dup`` scores are kept before the id sort.
    Returns:
        (top_ids int32[Q, k], top_scores f32[Q, k]), empty slots (-1, -1).
    """
    scores = torch.where(ids >= 0, scores, -1.0)
    if max_dup and scores.shape[1] > k * max_dup:
        scores, pos = _desc_stable(scores, k * max_dup)
        ids = torch.gather(ids, 1, pos)
    ids_s, sc_s, first = _dedupe_sorted(ids, scores)
    sc_m = torch.where(first, sc_s, -1.0)
    top_sc, pos = _desc_stable(sc_m, min(k, sc_m.shape[1]))
    top_ids = torch.where(top_sc >= 0, torch.gather(ids_s, 1, pos), -1)
    return _pad_cols(top_ids, k, -1), _pad_cols(top_sc, k, -1.0)


def threshold_select(scores, ids, cutoff, max_out: int):
    """Dedupe + cutoff filter + score-ordered compaction.

    Args:
        scores: f32[Q, C] candidate scores; ids: int32[Q, C], -1 invalid.
        cutoff: candidates scoring below it (f32 compare) are dropped;
            -1.0 keeps every valid candidate.
        max_out: output slots per query.
    Returns:
        (sel_ids int32[Q, max_out], sel_sc f32[Q, max_out], n_match
        int32[Q]); ``n_match`` counts distinct matches before the cap.
    """
    cut = float(np.float32(cutoff))
    sc = torch.where((ids >= 0) & (scores >= cut), scores, -1.0)
    ids_s, sc_s, first = _dedupe_sorted(ids, sc)
    first &= sc_s >= 0
    sc_m = torch.where(first, sc_s, -1.0)
    n_match = first.sum(dim=1, dtype=torch.int32)
    top_sc, pos = _desc_stable(sc_m, min(max_out, sc_m.shape[1]))
    top_ids = torch.where(top_sc >= 0, torch.gather(ids_s, 1, pos), -1)
    return _pad_cols(top_ids, max_out, -1), _pad_cols(top_sc, max_out, -1.0), n_match


def unique_compact(ids, max_out: int):
    """Distinct valid ids per row, ascending, in ``max_out`` slots; returns
    (sel_ids int32[Q, max_out], n_distinct int32[Q])."""
    zeros = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    sel_ids, _, n = threshold_select(zeros, ids, -1.0, max_out)
    return sel_ids, n


def _band_candidates(sorted_fp, sorted_ids, q_sigs, b, r, cap, n_valid,
                     offsets=None, n_buckets: int = 0):
    q_fps = band_fingerprints(q_sigs, b, r)
    if offsets is not None:
        ids, trunc = query_tables_direct(sorted_fp, sorted_ids, offsets, q_fps,
                                         cap, n_buckets)
    else:
        ids, trunc = query_tables(sorted_fp, sorted_ids, q_fps, cap=cap)
    flat = ids.reshape(q_sigs.shape[0], -1)
    if n_valid is not None:
        flat = torch.where(flat < n_valid, flat, -1)
    return flat, trunc


def query_candidates_fused(sorted_fp, sorted_ids, q_sigs, b: int, r: int,
                           cap: int, max_out: int, n_valid=None):
    """Candidates-only threshold query: band probes -> dedupe + compaction.
    Returns (sel_ids int32[Q, max_out], n_match int32[Q], truncated)."""
    flat, trunc = _band_candidates(sorted_fp, sorted_ids, q_sigs, b, r, cap, n_valid)
    sel_ids, n_match = unique_compact(flat, max_out)
    return sel_ids, n_match, trunc


def query_fused(sorted_fp, sorted_ids, db_sigs, q_sigs, b: int, r: int,
                cap: int, cutoff, max_out: int, offsets=None,
                n_buckets: int = 0, n_valid=None):
    """Threshold query: fingerprints -> band probes (by direct address when
    ``offsets`` from :func:`build_offsets` is given, else by binary search)
    -> rerank (kernel 3) -> dedupe + cutoff + compaction. Returns
    (sel_ids, sel_sc, n_match, truncated)."""
    flat, trunc = _band_candidates(sorted_fp, sorted_ids, q_sigs, b, r, cap, n_valid,
                                   offsets, n_buckets)
    scores = rerank_jaccard(db_sigs, q_sigs, flat)
    sel_ids, sel_sc, n_match = threshold_select(scores, flat, cutoff, max_out)
    return sel_ids, sel_sc, n_match, trunc


def topk_fused(sorted_fp, sorted_ids, db_sigs, q_sigs, b: int, r: int,
               cap: int, k: int, offsets=None, n_buckets: int = 0, n_valid=None):
    """Top-k query: fingerprints -> band probes (by direct address when
    ``offsets`` is given) -> rerank (kernel 3) -> dedupe top-k. Returns
    (top_ids, top_sc, truncated)."""
    flat, trunc = _band_candidates(sorted_fp, sorted_ids, q_sigs, b, r, cap, n_valid,
                                   offsets, n_buckets)
    scores = rerank_jaccard(db_sigs, q_sigs, flat)
    top_ids, top_sc = topk_candidates(scores, flat, k, max_dup=b)
    return top_ids, top_sc, trunc


def topk_scan(db_sigs, q_sigs, k: int, n_valid=None, alive=None,
              tile: int = 8192, count_ge=None):
    """Exact top-k by scoring every stored signature.

    k <= 128 runs kernel 2 (fused scan, running top-k on chip, hit
    counts); larger k runs a running top-k over ``tile``-row score
    matrices from kernel 4.

    Args:
        db_sigs: int32[N, P]; q_sigs: int32[Q, P].
        n_valid: rows >= n_valid are ignored (default N).
        alive: optional bool[N] tombstone mask (False = removed).
        count_ge: optional cutoff: also return the per-query count of
            valid rows scoring >= it, and keep only such rows.

    Returns:
        (top_ids int32[Q, k], top_scores f32[Q, k]) -- plus ``n_match
        int32[Q]`` when ``count_ge`` is given; empty slots (-1, -1).
    """
    n = db_sigs.shape[0]
    nv = n if n_valid is None else int(n_valid)
    cut = 0.0 if count_ge is None else float(count_ge)
    db_sigs, q_sigs = db_sigs.contiguous(), q_sigs.contiguous()
    if k <= lsh_scan.MAX_K:
        ids, sc, cnt = lsh_scan.topk_scan(db_sigs, q_sigs, k, nv, alive, cut)
    else:
        ids, sc, cnt = lsh_scan.running_topk(
            q_sigs, db_sigs, k, nv, alive, cut, score.score_matrix, tile
        )
    if count_ge is None:
        return ids, sc
    return ids, sc, cnt


def containment_scan(db_sigs, db_sizes, q_sigs, q_sizes, cutoff, k: int,
                     tile: int = 8192):
    """Exact containment-threshold scan: score every stored signature.

    The containment of query A (size q) in stored set B (size x) is
    estimated from the MinHash Jaccard estimate j and the exact sizes as
    ``c = j * (x + q) / ((1 + j) * q)``. k <= 128 runs kernel 2's sizes
    mode; larger k a running top-k over ``tile``-row score matrices from
    kernel 4.

    Args:
        db_sigs: int32[N, P]; db_sizes: int32[N], <= 0 marks padding rows.
        q_sigs: int32[Q, P]; q_sizes: int32[Q] query set sizes.
        cutoff: containment threshold (f32 compare).
        k: results per query (top-k by estimated containment).

    Returns:
        (ids int32[Q, k], containment f32[Q, k], n_match int32[Q]); slots
        below the cutoff are -1 / -1.0, and ``n_match`` counts every row
        >= cutoff, so truncation (n_match > k) is visible to the caller.
    """
    args = (db_sigs.contiguous(), db_sizes.to(torch.int32).contiguous(),
            q_sigs.contiguous(), q_sizes.to(torch.int32).contiguous())
    if k <= lsh_scan.MAX_K:
        return lsh_scan.containment_topk(*args, k, cutoff)
    db, sizes, q, qs = args
    return lsh_scan.running_topk(q, db, k, db.shape[0], None, cutoff,
                                 score.score_matrix, tile, sizes=sizes, q_sizes=qs)
