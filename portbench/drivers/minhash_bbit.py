"""Driver for a ``TorchBBitIndex`` served in top-k query batches.

Set-up draws what the ``minhash_lsh`` driver draws: the head corpus signed
by ``MinHash.bulk_signatures`` (the program), the rest of the rows on the
card from the seed (``harness/data.py::make_rows``), and a pool of query
batches handed to the program as host uint32 arrays. The rows go into a
``TorchBBitIndex(b, num_perm, r)`` as device tensors in chunks of the
configuration's ``insert_chunk`` rows under keys 0..N-1, as a build from
batches of signed documents does; then the unpacked rows are dropped.
Call i asks ``query_batch(batch i % pool, k, return_scores=True)``.

The check rebuilds head, rows and queries with the reference's own head
signatures (``reference/minhash.py``) and compares the answers, keys and
float64 scores in order, of the sampled queries of each kept call with
``reference/bbit.py``'s. The control counts equal slots over only the
first 3/4 of the signature.
"""

from __future__ import annotations

import torch

from portbench.harness import data, spec
from portbench.reference import bbit as ref_bbit

OPS = ("top_k",)
METHODS = ("scan",)
# the control's slots: the first 3/4 of the signature
CONTROL_SHARE = 0.75

lsh = spec.load_module("drivers", "minhash_lsh")


class Workload(lsh.Workload):
    def __init__(self, config: dict, traffic: dict, *args, **kwargs):
        if traffic["op"] not in OPS or traffic["method"] not in METHODS:
            raise ValueError("minhash_bbit serves %s by %s, not %r by %r"
                             % (OPS, METHODS, traffic["op"], traffic["method"]))
        super().__init__(config, traffic, *args, **kwargs)

    def setup(self) -> None:
        from datasketch_tpu_torch import MinHash, TorchBBitIndex

        c = self.config
        head = MinHash.bulk_signatures(
            data.byte_docs(self.words, self.ids[0]), num_perm=c["num_perm"],
            seed=c["perm_seed"], out="device", device=self.device)
        rows = self._rows(head)
        del head
        self.index = TorchBBitIndex(b=c["b"], num_perm=c["num_perm"], r=c["r"],
                                    device=self.device)
        step = c["insert_chunk"]
        for r0 in range(0, c["rows"], step):
            r1 = min(c["rows"], r0 + step)
            self.index.insert_batch(range(r0, r1), rows[r0:r1])
        queries = self._queries(rows)
        del rows
        self.pool = [b.cpu().numpy().view("uint32") for b in queries]
        k = self.traffic["k"]
        self.serve = lambda q: self.index.query_batch(q, k, return_scores=True)

    def _answerer(self, rows: torch.Tensor, slots: int):
        """The reference's answers [(row id, score)] to a block of queries,
        counting equal low bits over the first ``slots`` slots (what the
        ``minhash_lsh`` driver's check passes as its slot width)."""
        c, k = self.config, self.traffic["k"]
        return lambda q: ref_bbit.topk(rows, q, k, c["b"], c["r"], slots)

    def expected(self, calls) -> dict:
        return self._reference(calls, self.config["num_perm"])

    def control(self, calls) -> dict:
        return self._reference(calls, int(CONTROL_SHARE * self.config["num_perm"]))
