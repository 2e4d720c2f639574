"""``TorchMinHashLSHEnsemble(device="cpu")``'s containment scan against the
benchmark's plain reference (``portbench/reference/ensemble.py``), which
works the answers out anew from the sets' token ids: signatures, sizes,
the row order, the estimates, the match counts, the keys in order and
``last_truncated``, all exact.

The corpus holds sets of uniform ids and groups of copies of a core set;
a query of a core matches its whole group, so a batch is built to stop at
the first pass (k 16), to rerun at k 128, or to rerun at ``max_results``
with some query's matches cut.
"""

import functools

import numpy as np
import pytest
import torch

from datasketch_tpu_torch import MinHash, TorchMinHashLSHEnsemble
from datasketch_tpu_torch.ops import lsh_ops
from portbench.reference import ensemble as ref

torch.set_num_threads(2)

VOCAB = 5000
MAX_RESULTS = 160
# (core size, copies): a query of the core matches every copy
GROUPS = {"k16": (12, 9), "k128": (20, 70), "truncated": (16, 230)}


def _corpus():
    """(sets as int32 arrays, {batch: (queries as int32 arrays, source of
    each)}): 700 sets of uniform ids (lognormal draw counts around 30, at
    least 8, repeats kept), then each group's copies of its core, a third
    of them with 1-3 ids of their own."""
    rng = np.random.RandomState(20)
    sets = [rng.randint(0, VOCAB, max(8, int(rng.lognormal(np.log(30), 0.5))))
            for _ in range(700)]
    cores = {}
    for name, (size, copies) in GROUPS.items():
        core = rng.choice(VOCAB, size, replace=False)
        cores[name] = core
        for c in range(copies):
            extra = rng.randint(0, VOCAB, rng.randint(1, 4)) if c % 3 == 0 else []
            sets.append(rng.permutation(np.concatenate([core, extra])))
    order = rng.permutation(len(sets))  # copies spread over the keys
    sets = [sets[i].astype(np.int32) for i in order]
    batches = {}
    for name in GROUPS:
        # subset queries of uniform sets, and the core of every group up to this one
        src = rng.choice(700, 24, replace=False)
        queries = []
        for i in np.nonzero(order[:, None] == src[None, :])[0]:
            s = np.unique(sets[i])
            q = s[rng.rand(s.size) < rng.uniform(0.3, 1.0)]
            queries.append(q if q.size else s[:1])
        for other in GROUPS:
            queries.insert(5, cores[other].astype(np.int32))
            if other == name:
                break
        batches[name] = queries
    return sets, batches


CORPUS = _corpus()


def _flat(docs):
    lengths = torch.tensor([len(d) for d in docs], dtype=torch.int64)
    return torch.from_numpy(np.concatenate(docs).astype(np.int32)), lengths


@functools.lru_cache(maxsize=None)
def _index(p, parts, threshold):
    ix = TorchMinHashLSHEnsemble(threshold=threshold, num_perm=p, num_part=parts,
                                 max_results=MAX_RESULTS, device="cpu")
    ix.index_tokens(range(len(CORPUS[0])), CORPUS[0])
    return ix


@functools.lru_cache(maxsize=None)
def _reference(p):
    """(table, rows in scan order, their sizes, key of each row)."""
    table = ref.hash_table(VOCAB, 1, p, "cpu")
    ids, lengths = _flat(CORPUS[0])
    sizes = ref.distinct_counts(ids, lengths, VOCAB)
    order = ref.size_order(sizes)
    return table, ref.signatures(table, ids, lengths)[order], sizes[order], order


def _queries(p, batch):
    docs = CORPUS[1][batch]
    table = _reference(p)[0]
    ids, lengths = _flat(docs)
    return (MinHash.bulk_signatures(docs, num_perm=p, hashfunc="device", device="cpu",
                                    out="host"),
            ref.signatures(table, ids, lengths), ref.distinct_counts(ids, lengths, VOCAB))


def _passes(n_max):
    return 1 if n_max <= 16 else 2 if n_max <= 128 else 3


@pytest.mark.parametrize("batch", list(GROUPS))
@pytest.mark.parametrize("threshold", [0.5, 0.8])
@pytest.mark.parametrize("parts", [1, 8, 32])
@pytest.mark.parametrize("p", [128, 256])
def test_scan_equals_the_plain_reference(p, parts, threshold, batch):
    ix = _index(p, parts, threshold)
    _, rows, row_sizes, order = _reference(p)
    q_prog, q_ref, q_sizes = _queries(p, batch)
    nq = q_ref.shape[0]
    answers, n_match = ref.scan(rows, row_sizes, q_ref, q_sizes, threshold, MAX_RESULTS,
                                range(nq))
    # the batch stops where it was built to, and one query's matches are cut
    assert _passes(int(n_match.max())) == list(GROUPS).index(batch) + 1
    assert (batch == "truncated") == (int(n_match.max()) > MAX_RESULTS)

    got = ix.query_batch((q_prog, q_sizes.numpy()), method="scan")
    keys = order.tolist()
    assert got == [[keys[r] for r, _ in answers[j]] for j in range(nq)]
    assert ix.last_truncated == ref.truncated(n_match, MAX_RESULTS)
    # the pass at max_results, row by row: ids, estimates and match counts
    sigs, sizes, _, _ = ix._scan_table()
    ids, c, n = lsh_ops.containment_scan(sigs, sizes, torch.from_numpy(q_prog.view(np.int32)),
                                         q_sizes, threshold, MAX_RESULTS)
    assert torch.equal(n.long(), n_match)
    for j in range(nq):
        m = min(int(n_match[j]), MAX_RESULTS)
        assert ids[j, :m].tolist() == [r for r, _ in answers[j]]
        assert c[j, :m].tolist() == [v for _, v in answers[j]]
        assert (ids[j, m:] == -1).all()


@pytest.mark.parametrize("p", [128, 256])
def test_reference_row_order_is_the_scan_tables(p):
    """The scan table's rows are the stable sort of the sets by size: the
    reference's rows, sizes and keys, row for row."""
    _, rows, row_sizes, order = _reference(p)
    for parts in (1, 8, 32):
        sigs, sizes, keys, n_pad = _index(p, parts, 0.8)._scan_table()
        n = rows.shape[0]
        assert keys.tolist() == order.tolist()
        assert torch.equal(sizes[:n].long(), row_sizes) and not sizes[n:].any()
        assert torch.equal(sigs[:n], rows) and n_pad >= n
