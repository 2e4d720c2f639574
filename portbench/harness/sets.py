"""Integer-token sets and subset queries of a containment cell, drawn from
the run's seed on the device in a few large calls.

The laws are the repo's own: ``benchmarks/utils.py::generate_sets``' shape
(lognormal draw counts around ``mean_size``, Zipf ids over ``vocab``) as
``chip_smoke.py::make_token_sets`` draws it, without its clusters; ids
repeat within a set, so a set's size is its distinct count. A query keeps
a U(lo, hi) share of the distinct ids of one stored set (``bench.py``'s
ensemble protocol), at least one. Every draw depends on the seed alone, so
the reference rebuilds the same sets and queries.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness.data import QUERIES, ROWS, torch_gen

# uniform draws a call: the sets' ids are drawn in pieces of this many, so
# the transient f64 draws stay small beside the index
_PIECE = 1 << 24


def _starts(lengths: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(lengths, 0) - lengths


def make_token_sets(seed: int, n_sets: int, vocab: int, zipf: float, mean_size: float,
                    sigma: float, min_size: int, device):
    """``n_sets`` sets of Zipf(``zipf``) ids over ``vocab``: each set
    ``max(min_size, int(LogNormal(log(mean_size), sigma)))`` draws.

    Returns (ids int32[total] on ``device``, the sets back to back;
    lengths int64[n_sets], draws a set)."""
    gen = torch_gen(seed, ROWS, device)
    lengths = torch.empty(n_sets, dtype=torch.float64, device=device)
    lengths = lengths.log_normal_(math.log(mean_size), sigma, generator=gen)
    lengths = lengths.long().clamp_min(min_size)
    w = torch.arange(1, vocab + 1, dtype=torch.float64, device=device) ** -zipf
    cum = torch.cumsum(w / w.sum(), 0)
    total = int(lengths.sum())
    ids = torch.empty(total, dtype=torch.int32, device=device)
    for s in range(0, total, _PIECE):
        u = torch.rand(min(_PIECE, total - s), generator=gen, dtype=torch.float64,
                       device=device)
        ids[s: s + u.shape[0]] = torch.searchsorted(cum, u).clamp_max(vocab - 1)
    return ids, lengths


def make_subset_queries(ids: torch.Tensor, lengths: torch.Tensor, n_queries: int,
                        share, vocab: int, seed: int):
    """``n_queries`` queries, each from its own stored set (drawn without
    replacement): every distinct id of the set is kept with probability
    U(share) (drawn once a query); a query that keeps none keeps the set's
    least id.

    Returns (query ids int32[total] ascending within each query, lengths
    int64[Q]), on ``ids``' device."""
    dev = ids.device
    gen = torch_gen(seed, QUERIES, dev)
    src = torch.randperm(lengths.shape[0], generator=gen, device=dev)[:n_queries]
    n = lengths[src]
    seg = torch.repeat_interleave(torch.arange(n_queries, device=dev), n)
    pos = _starts(lengths)[src][seg] + torch.arange(seg.shape[0], device=dev) - _starts(n)[seg]
    key = torch.unique(seg * vocab + ids[pos].long())  # sorted: by query, then id
    q_of, tok = key // vocab, key % vocab
    lo, hi = share
    keep_p = torch.rand(n_queries, generator=gen, device=dev, dtype=torch.float64) * (hi - lo) + lo
    keep = torch.rand(key.shape[0], generator=gen, device=dev, dtype=torch.float64) < keep_p[q_of]
    first = torch.ones_like(keep)
    first[1:] = q_of[1:] != q_of[:-1]
    none = torch.bincount(q_of[keep], minlength=n_queries) == 0
    keep |= first & none[q_of]
    return tok[keep].to(torch.int32), torch.bincount(q_of[keep], minlength=n_queries)


def split(ids: torch.Tensor, lengths: torch.Tensor) -> list:
    """Sets as host int32 arrays (views of one flat copy), one a set, as a
    user passes them."""
    flat = ids.cpu().numpy()
    ends = np.cumsum(lengths.cpu().numpy()).tolist()
    return [flat[a:b] for a, b in zip([0] + ends[:-1], ends)]
