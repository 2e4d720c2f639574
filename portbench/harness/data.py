"""Inputs of every cell, drawn from the run's seed.

The laws are the repo's own: the bench corpus (10-byte tokens from a
30,000-word vocabulary, 200 a document: ``bench.py::make_corpus``) and the
1M-row index of ``benchmarks/scale_benchmark.py`` (real signatures first,
near-copies of row 0, random rows, a share of planted near-duplicates),
here drawn from ``--seed`` and, for the rows and queries, on the device in
a few large calls. Every draw depends on the seed alone, never on a value
the program computed: rows that copy slots of the signed head take the
head as an argument, so the reference rebuilds the same rows from its own
head signatures.
"""

from __future__ import annotations

import numpy as np
import torch

# sub-streams of one run's seed
CORPUS, ROWS, QUERIES, SAMPLE = 1, 2, 3, 4


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one purpose of one run: any whole ``seed``
    (negative and past 2**32 too) maps to independent streams."""
    ss = np.random.SeedSequence([seed % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, stream))
    return gen


def make_corpus(seed: int, n_corpora: int, docs: int, tokens_per_doc: int,
                vocab: int, token_bytes: int):
    """The bench corpus law: ``vocab`` random tokens of ``token_bytes``
    bytes, and ``n_corpora`` corpora of ``docs`` documents, each
    ``tokens_per_doc`` tokens drawn uniformly from the vocabulary.

    Returns (words: list of bytes, ids: int64[n_corpora, docs,
    tokens_per_doc] indexes into ``words``)."""
    rng = np.random.default_rng(sub_seed(seed, CORPUS))
    raw = rng.integers(0, 256, size=(vocab, token_bytes), dtype=np.uint8)
    words = [row.tobytes() for row in raw]
    ids = rng.integers(0, vocab, size=(n_corpora, docs, tokens_per_doc), dtype=np.int64)
    return words, ids


def byte_docs(words, ids) -> list:
    """Documents as lists of bytes tokens (one corpus of ``ids``)."""
    table = np.empty(len(words), dtype=object)
    table[:] = words
    return table[ids].tolist()


def _random_slots(n: int, p: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, (n, p), dtype=torch.int32,
                         generator=gen, device=device)


def make_rows(head: torch.Tensor, n_rows: int, near_copies: int, near_keep: float,
              dup_share: float, dup_keep, seed: int) -> torch.Tensor:
    """The index rows (``benchmarks/scale_benchmark.py``'s protocol):
    uniform random int32[n_rows, P] rows on ``head``'s device, whose first
    rows are ``head``; ``near_copies`` rows after it keep each slot of head
    row 0 with probability ``near_keep``; the last ``dup_share`` of the
    rows are planted near-duplicates of uniformly drawn earlier rows, each
    keeping a U(dup_keep) share of its source's slots."""
    dev, p = head.device, head.shape[1]
    gen = torch_gen(seed, ROWS, dev)
    rows = _random_slots(n_rows, p, gen, dev)
    h = head.shape[0]
    rows[:h] = head
    keep = torch.rand((near_copies, p), generator=gen, device=dev) < near_keep
    rows[h: h + near_copies] = torch.where(keep, head[0], rows[h: h + near_copies])
    n_dup = int(n_rows * dup_share)
    src = torch.randint(0, n_rows - n_dup, (n_dup,), generator=gen, device=dev)
    lo, hi = dup_keep
    share = torch.rand((n_dup, 1), generator=gen, device=dev) * (hi - lo) + lo
    keep = torch.rand((n_dup, p), generator=gen, device=dev) < share
    rows[n_rows - n_dup:] = torch.where(keep, rows[src], rows[n_rows - n_dup:])
    return rows


def make_queries(rows: torch.Tensor, n_batches: int, batch: int, near_share: float,
                 near_keep, seed: int) -> torch.Tensor:
    """A pool of query batches int32[n_batches, batch, P] on ``rows``'
    device: in each batch a ``near_share`` of the queries, at random
    positions, are fresh near-duplicates of uniformly drawn stored rows
    (each keeps a U(near_keep) share of its source's slots, the others are
    random); the rest are unrelated random rows."""
    dev, (n, p) = rows.device, rows.shape
    gen = torch_gen(seed, QUERIES, dev)
    q = _random_slots(n_batches * batch, p, gen, dev).reshape(n_batches, batch, p)
    n_near = int(round(batch * near_share))
    lo, hi = near_keep
    for b in range(n_batches):
        pos = torch.randperm(batch, generator=gen, device=dev)[:n_near]
        src = torch.randint(0, n, (n_near,), generator=gen, device=dev)
        share = torch.rand((n_near, 1), generator=gen, device=dev) * (hi - lo) + lo
        keep = torch.rand((n_near, p), generator=gen, device=dev) < share
        q[b, pos] = torch.where(keep, rows[src], q[b, pos])
    return q


def sample_calls(seed: int, within: int, count: int) -> list:
    """Call numbers, among the first ``within`` of a window, whose answers
    the check keeps (besides the window's last call)."""
    rng = np.random.default_rng(sub_seed(seed, SAMPLE))
    return sorted(int(i) for i in rng.choice(within, size=min(count, within), replace=False))


def sample_positions(seed: int, call: int, batch: int, count: int) -> np.ndarray:
    """Positions in call ``call``'s batch whose answers are compared."""
    rng = np.random.default_rng([sub_seed(seed, SAMPLE), call])
    return np.sort(rng.choice(batch, size=min(count, batch), replace=False))
