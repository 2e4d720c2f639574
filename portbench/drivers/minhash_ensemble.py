"""Driver for a ``TorchMinHashLSHEnsemble`` served in containment query
batches.

Set-up draws the stored token sets on the card from the seed
(``harness/sets.py``), hands them to the program as host int32 arrays
(``index_tokens``: kernel 1 with ``hashfunc="device"``, exact distinct
counts, the size partitions and band tables), draws a pool of subset
queries, signs them with ``MinHash.bulk_signatures`` and hands each batch
to the program as a host ``(uint32[Q, P] signatures, int64[Q] sizes)``
pair. Call i asks batch ``i % pool`` by ``query_batch(..., method=)``.

The check rebuilds the sets and queries from the seed, computes their
signatures and sizes with the reference's own arithmetic
(``reference/ensemble.py``), and compares, for each kept call, the keys in
order of the sampled queries and the call's ``last_truncated`` (the match
counts past the cap, over every query of the batch). The control answers
with slots compared on their low 8 bits (b-bit MinHash).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import data, sets
from portbench.harness.workload import Workload as Base
from portbench.reference import ensemble as ref

OPS = ("query_batch",)
METHODS = ("scan",)


class Workload(Base):
    unit = "queries"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = torch.device(self.device)
        t = self.traffic
        if t["op"] not in OPS or t["method"] not in METHODS:
            raise ValueError("minhash_ensemble serves %s by %s, not %r by %r"
                             % (OPS, METHODS, t["op"], t["method"]))
        self.batch = t["batch"]
        # the scan's answer cap: max_results, or the scan table's
        # power-of-two row count (at least 128) where that is smaller
        c = self.config
        self.max_out = min(c["max_results"], max(128, 1 << (c["rows"] - 1).bit_length()))

    # ----------------------------------------------------------- the inputs

    def _sets(self):
        c, s = self.config, self.config["sets"]
        return sets.make_token_sets(self.seed, c["rows"], s["vocab"], s["zipf"],
                                    s["mean_size"], s["sigma"], s["min_size"], self.device)

    def _queries(self, ids, lengths):
        t = self.traffic
        return sets.make_subset_queries(ids, lengths, t["pool"] * self.batch,
                                        t["query_share"], self.config["sets"]["vocab"],
                                        self.seed)

    # ----------------------------------------------------------- the window

    def setup(self) -> None:
        from datasketch_tpu_torch import MinHash, TorchMinHashLSHEnsemble

        c, t0 = self.config, time.perf_counter()
        ids, lengths = self._sets()
        q_ids, q_len = self._queries(ids, lengths)
        docs = sets.split(ids, lengths)
        q_docs = sets.split(q_ids, q_len)
        self.log("[portbench] %d sets, %d ids drawn in %.1f s"
                 % (len(docs), ids.shape[0], time.perf_counter() - t0))
        del ids, lengths, q_ids
        t0 = time.perf_counter()
        self.index = TorchMinHashLSHEnsemble(
            threshold=c["threshold"], num_perm=c["num_perm"], num_part=c["num_part"],
            m=c["m"], weights=tuple(c["weights"]), bucket_cap=c["bucket_cap"],
            max_results=c["max_results"], device=self.device)
        self.index.index_tokens(range(c["rows"]), docs, seed=c["perm_seed"])
        del docs
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.log("[portbench] index_tokens in %.1f s" % (time.perf_counter() - t0))
        q_sigs = MinHash.bulk_signatures(q_docs, num_perm=c["num_perm"], seed=c["perm_seed"],
                                         hashfunc="device", out="host", device=self.device)
        sizes = q_len.cpu().numpy().astype(np.int64)
        b = self.batch
        self.pool = [(q_sigs[i * b: (i + 1) * b], sizes[i * b: (i + 1) * b])
                     for i in range(self.traffic["pool"])]
        method = self.traffic["method"]
        self.serve = lambda pair: self.index.query_batch(pair, method=method)

    def call(self, i: int):
        out = self.serve(self.pool[i % len(self.pool)])
        return out, self.index.last_truncated

    def units_of(self, i: int) -> int:
        return self.batch

    def free(self) -> None:
        self.index = None
        self.serve = None

    # ------------------------------------------------------------ the check

    def _positions(self, i: int):
        return data.sample_positions(self.seed, i, self.batch, self.traffic["check"]["per_call"])

    def _reference(self, calls, slot_bits: int, dtype=torch.float32) -> dict:
        """{call: {"answers": {position: [keys]}, "truncated": int}}: slots
        compared on their low ``slot_bits``, the estimate in ``dtype``."""
        c, t = self.config, self.traffic
        vocab = c["sets"]["vocab"]
        ids, lengths = self._sets()
        q_ids, q_len = self._queries(ids, lengths)
        table = ref.hash_table(vocab, c["perm_seed"], c["num_perm"], self.device)
        sizes = ref.distinct_counts(ids, lengths, vocab)
        order = ref.size_order(sizes)
        rows = ref.signatures(table, ids, lengths)[order]
        row_sizes = sizes[order]
        del ids, lengths
        q_sigs = ref.signatures(table, q_ids, q_len)
        q_sizes = ref.distinct_counts(q_ids, q_len, vocab)
        keys = order.tolist()
        out = {}
        for i in calls:
            b = i % t["pool"]
            sl = slice(b * self.batch, (b + 1) * self.batch)
            pos = self._positions(i)
            answers, n_match = ref.scan(rows, row_sizes, q_sigs[sl], q_sizes[sl],
                                        c["threshold"], self.max_out, pos, slot_bits, dtype)
            out[i] = {"answers": {j: [keys[r] for r, _ in answers[j]] for j in pos.tolist()},
                      "truncated": ref.truncated(n_match, self.max_out)}
        return out

    def expected(self, calls) -> dict:
        return self._reference(calls, 32)

    def control(self, calls, slot_bits: int = 8, dtype=torch.float32) -> dict:
        """The control in the program's place: every query's keys and the
        batch's truncation, from slots compared on their low 8 bits (or
        the cheaper arithmetic asked)."""
        out = {}
        for i, want in self._reference(calls, slot_bits, dtype).items():
            answers = [want["answers"].get(j, []) for j in range(self.batch)]
            out[i] = (answers, want["truncated"])
        return out

    def compare(self, got: dict, want: dict) -> dict:
        wrong = checked = trunc = 0
        for i, ref_call in want.items():
            try:
                answers, last_truncated = got[i]
            except (KeyError, TypeError, ValueError):
                answers, last_truncated = None, None
            trunc += last_truncated != ref_call["truncated"]
            for j, keys in ref_call["answers"].items():
                checked += 1
                try:
                    mine = list(answers[j])
                except (IndexError, TypeError):
                    mine = None
                wrong += mine != keys
        self.log("[portbench] %d answers of %d calls compared" % (checked, len(want)))
        return {"answers_wrong": {"value": wrong, "limit": 0},
                "truncated_wrong": {"value": trunc, "limit": 0}}
