"""Driver for a ``TorchMinHashLSH`` served in query batches.

Set-up signs the head corpus with ``MinHash.bulk_signatures`` (the
program), draws the rest of the rows on the card from the seed
(``harness/data.py::make_rows``), indexes them under keys 0..N-1, and
draws a pool of query batches, handed to the program as host uint32
arrays. Call i asks batch ``i % pool`` by the traffic's ``op`` and
``method`` (``scan`` or ``bands``): ``top_k`` (``k``) or ``query_batch``
(``return_scores``) at the index's threshold.

The check rebuilds head, rows and queries with the reference's own head
signatures (``reference/minhash.py``: hashlib SHA1, datasketch's
permutations) and compares the answers, in order, of the sampled queries
of each kept call with ``reference/lsh.py``'s, for every (op, method) the
facade serves: keys and scores, or keys alone where the traffic asks no
scores. The control answers with slots compared on their low 8 bits
(b-bit MinHash).
"""

from __future__ import annotations

import torch

from portbench.harness import data
from portbench.harness.workload import Workload as Base
from portbench.reference import lsh as ref_lsh
from portbench.reference import minhash as ref_minhash


OPS = ("top_k", "query_batch")
METHODS = ("scan", "bands")
# a threshold scan's answer cap: the facade's 1,024, or the index's
# power-of-two row count where that is smaller
MAX_OUT = 1024


class Workload(Base):
    unit = "queries"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        t = self.traffic
        if t["op"] not in OPS or t["method"] not in METHODS:
            raise ValueError("minhash_lsh serves %s by %s, not %r by %r"
                             % (OPS, METHODS, t["op"], t["method"]))
        self.scores = t["op"] == "top_k" or t["return_scores"]
        c = self.config["corpus"]
        self.words, self.ids = data.make_corpus(self.seed, 1, c["docs"], c["tokens_per_doc"],
                                                c["vocab"], c["token_bytes"])
        self.batch = self.traffic["batch"]

    # ----------------------------------------------------------- the window

    def _rows(self, head: torch.Tensor) -> torch.Tensor:
        c = self.config
        return data.make_rows(head, c["rows"], c["near_copies"], c["near_keep"],
                              c["dup_share"], c["dup_keep"], self.seed)

    def _queries(self, rows: torch.Tensor) -> torch.Tensor:
        t = self.traffic
        return data.make_queries(rows, t["pool"], self.batch, t["near_share"], t["near_keep"],
                                 self.seed)

    def setup(self) -> None:
        from datasketch_tpu_torch import MinHash, TorchMinHashLSH

        c = self.config
        head = MinHash.bulk_signatures(
            data.byte_docs(self.words, self.ids[0]), num_perm=c["num_perm"],
            seed=c["perm_seed"], out="device", device=self.device)
        rows = self._rows(head)
        self.index = TorchMinHashLSH(threshold=c["threshold"], num_perm=c["num_perm"],
                                     bucket_cap=c["bucket_cap"], device=self.device)
        self.index.index(range(c["rows"]), rows)
        queries = self._queries(rows)
        self.pool = [b.cpu().numpy().view("uint32") for b in queries]
        t = self.traffic
        if t["op"] == "top_k":
            self.serve = lambda q: self.index.top_k(q, t["k"], method=t["method"])
        else:
            self.serve = lambda q: self.index.query_batch(
                q, return_scores=t["return_scores"], method=t["method"])

    def call(self, i: int):
        return self.serve(self.pool[i % len(self.pool)])

    def units_of(self, i: int) -> int:
        return self.batch

    def free(self) -> None:
        self.index = None
        self.serve = None

    # ------------------------------------------------------------ the check

    def _positions(self, i: int):
        return data.sample_positions(self.seed, i, self.batch, self.traffic["check"]["per_call"])

    def _reference(self, calls, slot_bits: int) -> dict:
        c, t = self.config, self.traffic
        table = torch.from_numpy(ref_minhash.sha1_table(self.words)).to(self.device)
        head = ref_minhash.signatures(table, torch.from_numpy(self.ids[0]), c["perm_seed"],
                                      c["num_perm"])
        rows = self._rows(head)
        queries = self._queries(rows)
        answer = self._answerer(rows, slot_bits)
        out = {}
        for i in calls:
            pos = self._positions(i)
            ans = answer(queries[i % t["pool"]][torch.from_numpy(pos).to(self.device)])
            if not self.scores:
                ans = [[key for key, _ in a] for a in ans]
            out[i] = dict(zip(pos.tolist(), ans))
        return out

    def _answerer(self, rows: torch.Tensor, slot_bits: int):
        """The reference's answers [(row id, score)] to a block of queries,
        for the traffic's op and method."""
        c, t = self.config, self.traffic
        bands, per_band = c["banding"]
        if t["op"] == "top_k" and t["method"] == "scan":
            return lambda q: ref_lsh.topk_scan(rows, q, t["k"], slot_bits)
        if t["op"] == "top_k":
            return lambda q: ref_lsh.topk_bands(rows, q, t["k"], bands, per_band,
                                                c["bucket_cap"], slot_bits)
        if t["method"] == "scan":
            max_out = min(MAX_OUT, 1 << (c["rows"] - 1).bit_length())
            return lambda q: ref_lsh.threshold_scan(rows, q, c["threshold"], max_out,
                                                    slot_bits)
        return lambda q: ref_lsh.bands_threshold(rows, q, bands, per_band, c["bucket_cap"],
                                                 c["threshold"], slot_bits)

    def expected(self, calls) -> dict:
        return self._reference(calls, 32)

    def control(self, calls) -> dict:
        return self._reference(calls, 8)

    def compare(self, got: dict, want: dict) -> dict:
        wrong = checked = 0
        for i, answers in want.items():
            for j, ans in answers.items():
                checked += 1
                try:
                    mine = [tuple(a) if self.scores else a for a in got[i][j]]
                except (IndexError, KeyError, TypeError):
                    mine = None
                wrong += mine != ans
        self.log("[portbench] %d answers of %d calls compared" % (checked, len(want)))
        return {"answers_wrong": {"value": wrong, "limit": 0}}
