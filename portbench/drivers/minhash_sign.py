"""Driver for ``MinHash.bulk_signatures``: calls of one corpus each.

Set-up draws the vocabulary and a pool of corpora from the seed; call i
signs corpus ``i % pool``, each document a list of bytes tokens (SHA1 on
the host, ``tokens: "bytes"``). The check compares every signature row
of the kept calls with the reference's (``reference/minhash.py``); the
control signs with the 32-bit universal hash instead of the Mersenne
permutation.
"""

from __future__ import annotations

import torch

from portbench.harness import data
from portbench.harness.workload import Workload as Base
from portbench.reference import minhash as ref


class Workload(Base):
    unit = "docs"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        t = self.traffic
        if t["op"] != "bulk_signatures" or t["tokens"] != "bytes":
            raise ValueError("minhash_sign serves bulk_signatures of bytes tokens")
        c = self.config["corpus"]
        self.docs, self.tokens = c["docs"], c["tokens_per_doc"]
        self.words, self.ids = data.make_corpus(
            self.seed, self.traffic["pool"], self.docs, self.tokens, c["vocab"],
            c["token_bytes"])

    def setup(self) -> None:
        from datasketch_tpu_torch import MinHash

        self.sign = MinHash.bulk_signatures
        self.pool = [data.byte_docs(self.words, corpus) for corpus in self.ids]
        self.kwargs = dict(num_perm=self.config["num_perm"], seed=self.config["perm_seed"],
                           out="device", device=self.device)

    def call(self, i: int):
        return self.sign(self.pool[i % len(self.pool)], **self.kwargs)

    def units_of(self, i: int) -> int:
        return self.docs

    def free(self) -> None:
        self.pool = None

    def _reference(self, calls, mersenne: bool) -> dict:
        table = torch.from_numpy(ref.sha1_table(self.words)).to(self.device)
        by_corpus = {}
        for k in sorted({i % len(self.ids) for i in calls}):
            by_corpus[k] = ref.signatures(
                table, torch.from_numpy(self.ids[k]), self.config["perm_seed"],
                self.config["num_perm"], mersenne=mersenne)
        return {i: by_corpus[i % len(self.ids)] for i in calls}

    def expected(self, calls) -> dict:
        return self._reference(calls, mersenne=True)

    def control(self, calls) -> dict:
        return self._reference(calls, mersenne=False)

    def compare(self, got: dict, want: dict) -> dict:
        wrong = 0
        for i, out in got.items():
            out = out.to(want[i].device)
            if out.shape != want[i].shape:
                wrong += want[i].shape[0]
                continue
            wrong += int((out != want[i]).any(dim=1).sum())
        self.log("[portbench] %d signature rows of %d calls compared" % (
            sum(w.shape[0] for w in want.values()), len(want)))
        return {"rows_wrong": {"value": wrong, "limit": 0}}
