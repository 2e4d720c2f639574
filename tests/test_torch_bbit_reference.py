"""``TorchBBitIndex(device="cpu")``'s top-k scan against the benchmark's plain
reference (``portbench/reference/bbit.py``), which works the answers out
anew from the unpacked signatures: equal low-b bits of each slot, the
(count desc, row asc) order and ``bBitMinHash.jaccard``'s float64
estimate. Keys and scores must be equal; the benchmark's control (the
counts over the first 3/4 of the slots) must not be.

Rows are uniform random signatures with planted near-duplicates; a fifth
of the queries are near-duplicates of stored rows, the rest unrelated.
"""

import numpy as np
import pytest
import torch

from datasketch_tpu_torch import TorchBBitIndex
from datasketch_tpu_torch.ops import bbit_ops
from portbench.reference import bbit as ref

torch.set_num_threads(2)

N, Q, K = 3000, 40, 10
# b, num_perm, r, and what the case plants or changes
CASES = {
    "b1-p128": dict(b=1, p=128),
    "b2-p128": dict(b=2, p=128),
    "b1-p66": dict(b=1, p=66),  # 30 padding slots in the last word
    "b2-p66": dict(b=2, p=66),
    "b4-p128-r0.3": dict(b=4, p=128, r=0.3),
    "ties": dict(b=1, p=128, ties=True),  # 60 copies of a row tie past the k-th place
    "tiles": dict(b=1, p=128, tile=700),  # folded over 5 tiles, the last ragged
    "removed": dict(b=1, p=128, removed=True),
}


def _data(p, ties, seed=25):
    """uint32 rows [N, p] and queries [Q, p]."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 1 << 32, size=(N, p), dtype=np.uint64).astype(np.uint32)
    dup = rng.choice(N, N // 5, replace=False)
    src = rng.randint(0, N, dup.size)
    keep = rng.rand(dup.size, 1) * 0.35 + 0.6
    rows[dup] = np.where(rng.rand(dup.size, p) < keep, rows[src], rows[dup])
    if ties:
        rows[rng.choice(N, 60, replace=False)] = rows[7]
    q = rng.randint(0, 1 << 32, size=(Q, p), dtype=np.uint64).astype(np.uint32)
    near = rng.choice(Q, Q // 5, replace=False)
    src = np.full(near.size, 7) if ties else rng.randint(0, N, near.size)
    keep = rng.rand(near.size, 1) * 0.35 + 0.6
    q[near] = np.where(rng.rand(near.size, p) < keep, rows[src], q[near])
    return rows, q, src


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("case", CASES)
def test_index_answers_equal_the_reference(case, monkeypatch):
    c = CASES[case]
    b, p, r = c["b"], c["p"], c.get("r", 0.0)
    rows, q, src = _data(p, c.get("ties", False))
    if "tile" in c:
        monkeypatch.setattr(bbit_ops, "_scan_tile", lambda nq: c["tile"])
    ix = TorchBBitIndex(b=b, num_perm=p, r=r, device="cpu")
    ix.insert_batch(range(N), rows)
    live = np.arange(N)
    if c.get("removed"):
        gone = np.union1d(src[:4], np.random.RandomState(3).choice(N, 150, replace=False))
        ix.remove_batch(gone.tolist())
        live = np.setdiff1d(live, gone)
    got = ix.query_batch(q, K, return_scores=True)

    def reference(slots=None):
        ans = ref.topk(_t(rows[live]), _t(q), K, b, r, slots)
        return [[(int(live[i]), s) for i, s in a] for a in ans]

    want = reference()
    assert got == want
    assert all(len(a) == K for a in got)
    if c.get("ties"):  # the 60 copies fill the near queries' answers, lowest keys first
        copies = np.nonzero((rows == rows[7]).all(axis=1))[0]
        assert any([key for key, _ in a] == copies[:K].tolist() for a in got)
    assert got != reference(int(0.75 * p))
