"""Plain answers of an LSH Ensemble containment scan, worked out anew from
the sets' token ids.

- Token hash of an integer id: murmur3's fmix32 of the id (the device hash
  of ``MinHash(hashfunc="device")``); slot j of a signature is the least
  ``((a_j * h + b_j) mod 2**64) mod (2**61 - 1)``, cut to 32 bits, over
  the set's ids, with datasketch's (a, b) (``reference/minhash.py``). The
  vocabulary is small, so each id's P values are computed once
  (:func:`hash_table`) and a signature is the least of its ids' rows.
- Size of a set: its distinct ids.
- Row order of the scan: the stable sort of the stored sets by size (the
  order in which the ensemble's partitions lay them end to end).
- Containment estimate of stored set x (size X) for query q (size Q):
  ``c = (j * (X + Q)) / ((1 + j) * Q)`` in float32, each operation rounded
  on its own, with j = ``f32(equal slots) * f32(1/P)`` and Q at least 1.
- Answer of a query: the keys of every set with ``c >= f32(threshold)``,
  in (c desc, row asc) order, cut to the first ``max_out``; its match
  count counts them all, and a batch's truncation is the sum of the match
  counts past ``max_out``.

``slot_bits`` below 32 compares only the low bits of each slot (b-bit
MinHash), the control's cheaper compare; ``dtype`` float16 takes the
estimate one precision below the configuration's. Imports nothing of the
program.
"""

from __future__ import annotations

import torch

# no product here runs on the tensor cores, but none may round to TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from portbench.reference.lsh import counts as equal_slots
from portbench.reference.minhash import fmix32, permutations, permuted

MAX_HASH = (1 << 32) - 1


def hash_table(vocab: int, seed: int, num_perm: int, device) -> torch.Tensor:
    """int64[vocab, P]: the permuted device hash of each id 0..vocab-1."""
    a, b = (torch.from_numpy(x).to(device) for x in permutations(seed, num_perm))
    h = fmix32(torch.arange(vocab, dtype=torch.int64, device=device))
    return permuted(h[:, None], a, b)


def signatures(table: torch.Tensor, ids: torch.Tensor, lengths: torch.Tensor,
               block: int = 1 << 19) -> torch.Tensor:
    """int32[N, P] (uint32 bits): per set, the least of its ids' table
    rows. Sets of one length are taken together, ``block`` ids at a time;
    an empty set keeps MAX_HASH in every slot."""
    dev, p = ids.device, table.shape[1]
    ids = ids.long()
    out = torch.full((lengths.shape[0], p), MAX_HASH, dtype=torch.int64, device=dev)
    starts = torch.cumsum(lengths, 0) - lengths
    for length in torch.unique(lengths).tolist():
        if length == 0:
            continue
        sets = torch.nonzero(lengths == length).flatten()
        step = max(1, block // length)
        for s0 in range(0, sets.shape[0], step):
            part = sets[s0: s0 + step]
            pos = starts[part][:, None] + torch.arange(length, device=dev)[None, :]
            out[part] = table[ids[pos]].amin(dim=1)
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(torch.int32)


def distinct_counts(ids: torch.Tensor, lengths: torch.Tensor, vocab: int,
                    block: int = 1 << 20) -> torch.Tensor:
    """int64[N]: the distinct ids of each set, ``block`` sets at a time."""
    dev = ids.device
    out = torch.empty(lengths.shape[0], dtype=torch.int64, device=dev)
    ends = torch.cumsum(lengths, 0).tolist()
    for s0 in range(0, lengths.shape[0], block):
        n = min(block, lengths.shape[0] - s0)
        lo = ends[s0 - 1] if s0 else 0
        seg = torch.repeat_interleave(torch.arange(n, device=dev), lengths[s0: s0 + n])
        key = torch.unique(seg * vocab + ids[lo: ends[s0 + n - 1]].long())
        out[s0: s0 + n] = torch.bincount(key // vocab, minlength=n)
    return out


def size_order(sizes: torch.Tensor) -> torch.Tensor:
    """int64[N]: the stored sets in the scan's row order (by size, stable)."""
    return torch.sort(sizes, stable=True).indices


def containment(count: torch.Tensor, x: torch.Tensor, q: torch.Tensor, p: int,
                dtype=torch.float32) -> torch.Tensor:
    """[Q, N] estimates in ``dtype`` from equal-slot counts int32[Q, N],
    stored sizes x [N] and query sizes q [Q]."""
    inv_p = torch.tensor(1.0, dtype=dtype) / torch.tensor(float(p), dtype=dtype)
    j = count.to(dtype) * inv_p.to(count.device)
    xf = x.to(dtype)[None, :]
    qf = q.to(dtype).clamp_min(1.0)[:, None]
    return (j * (xf + qf)) / ((1.0 + j) * qf)


def scan(rows: torch.Tensor, row_sizes: torch.Tensor, q: torch.Tensor,
         q_sizes: torch.Tensor, threshold: float, max_out: int, answer_rows,
         slot_bits: int = 32, dtype=torch.float32, q_block: int = 64):
    """The containment scan of queries ``q`` over ``rows`` (in row order).

    Returns ({query: [(row, c)] in order, at most ``max_out``} for the
    queries in ``answer_rows``, match counts int64[Q] of every query)."""
    cut = torch.tensor(threshold, dtype=dtype, device=rows.device)
    want = set(int(i) for i in answer_rows)
    answers, n_match = {}, []
    for q0 in range(0, q.shape[0], q_block):
        qb = q[q0: q0 + q_block]
        c = containment(equal_slots(rows, qb, slot_bits), row_sizes,
                        q_sizes[q0: q0 + q_block], rows.shape[1], dtype)
        hit = (c >= cut) & (row_sizes > 0)[None, :]
        n_match.append(hit.sum(dim=1))
        for i in range(qb.shape[0]):
            if q0 + i not in want:
                continue
            found = torch.nonzero(hit[i]).flatten()  # rows ascending
            score = c[i, found]
            order = torch.sort(score, descending=True, stable=True).indices[:max_out]
            answers[q0 + i] = list(zip(found[order].tolist(), score[order].tolist()))
    return answers, torch.cat(n_match)


def truncated(n_match: torch.Tensor, max_out: int) -> int:
    """A batch's match counts past ``max_out``, summed."""
    return int((n_match - max_out).clamp_min(0).sum())
