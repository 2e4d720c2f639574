"""ShardedMinHashLSHEnsemble -- containment index sharded over a mesh.

Port of ``datasketch_tpu/parallel/sharded_ensemble.py``: the mesh form of
:class:`~datasketch_tpu_torch.models.torch_ensemble.TorchMinHashLSHEnsemble`.
The stacked ``[parts, N_pad, P]`` layout shards over the PARTITION axis:
shard s owns partitions ``[s*pl, (s+1)*pl)`` with ``pl = ceil(num_part /
S)`` (JAX fills the last shards with empty filler partitions; the port
holds none, but numbers partitions and sizes its per-shard result cap by
``pl`` as JAX does). Each shard builds its partitions' band tables for
every r, probes them with the per-(query, partition) band counts and
compacts its candidates before one all_gather per unique r; the scan path
runs the single-device class's scan (kernel 2s's emit variant) on each
shard's stacked rows at the cap JAX's staged k = 16 -> 128 ->
``max_results`` ends at. The DP size partitioner, the (b, r) tables and
the ``.npz`` layout are the single-device class's, so checkpoints load in
both classes of both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from datasketch_tpu_torch.device import as_sig_tensor
from datasketch_tpu_torch.models.minhash import pow2_at_least
from datasketch_tpu_torch.models.torch_ensemble import TorchMinHashLSHEnsemble, _answer_lists
from datasketch_tpu_torch.models.torch_lsh import _fetch
from datasketch_tpu_torch.ops import lsh_ops
from datasketch_tpu_torch.parallel.collectives import all_gather_cat, pmax, psum
from datasketch_tpu_torch.parallel.mesh import Mesh, fetch_global
from datasketch_tpu_torch.utils.profiling import recording, span

__all__ = ["ShardedMinHashLSHEnsemble"]


class ShardedMinHashLSHEnsemble(TorchMinHashLSHEnsemble):
    """Containment-threshold index with partition-sharded tables.

    Args:
        mesh: :class:`~datasketch_tpu_torch.parallel.mesh.Mesh`; partitions
            shard over ``shard_axis``.
        (rest as :class:`~datasketch_tpu_torch.models.torch_ensemble.
        TorchMinHashLSHEnsemble`.)
    """

    def __init__(self, mesh: Mesh, threshold: float = 0.9, num_perm: int = 128,
                 num_part: int = 16, m: int = 8, weights: tuple = (0.5, 0.5),
                 bucket_cap: int = 128, shard_axis: str = "data", max_results: int = 2048):
        super().__init__(threshold=threshold, num_perm=num_perm, num_part=num_part, m=m,
                         weights=weights, bucket_cap=bucket_cap, max_results=max_results,
                         device=mesh.home)
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.n_shards = mesh.shape[shard_axis]
        self._parts_local = -(-num_part // self.n_shards)
        # s -> {"sigs": int32[pl_s, N_pad, P], "n_valid", "sizes", r: tables}
        self._tables = {}

    # ------------------------------------------------------------------ build

    def _parts(self, s: int):
        pl = self._parts_local
        return min(s * pl, self.num_part), min((s + 1) * pl, self.num_part)

    def _build_tables(self, stack: torch.Tensor) -> None:
        """Split the partition stack over this rank's shards and build every
        r's band tables on each shard's device (overrides the single-device
        hook, which the inherited build calls)."""
        self._sigs = None
        self._tables = {}
        for s in self.mesh.local_shards(self.shard_axis):
            lo, hi = self._parts(s)
            dev = self.mesh.shard_device(self.shard_axis, s)
            local = stack[lo:hi].to(dev).contiguous()
            shard = {"sigs": local,
                     "n_valid": torch.from_numpy(self._n_valid[lo:hi].copy()).to(dev)}
            if hi > lo:
                for r in self.rs:
                    shard[r] = lsh_ops.build_tables_stacked(local, self.h // r, r)
            if self._sizes_host is not None:
                shard["sizes"] = torch.from_numpy(
                    self._sizes_host[lo:hi].reshape(-1).copy()).to(dev)
            self._tables[s] = shard

    def _host_stack(self) -> np.ndarray:
        """uint32[num_part, N_pad, P] host copy (a collective across processes)."""
        rows = [hi - lo for lo, hi in (self._parts(s) for s in range(self.n_shards))]
        local = {s: t["sigs"] for s, t in self._tables.items()}
        return fetch_global(self.mesh, self.shard_axis, local, rows).view(np.uint32)

    # ------------------------------------------------------------------ query

    def _query_bands(self, q_sigs: torch.Tensor, sizes: np.ndarray, q_pad: int) -> list:
        """Per unique r: every shard probes its partitions (zero-padded
        queries, whose cap overflow JAX counts too), dedupes and compacts
        on its device, and the selections ride one all_gather."""
        nq = q_sigs.shape[0]
        b_keep = self._b_keep(sizes, q_pad)
        q = torch.nn.functional.pad(q_sigs, (0, 0, 0, q_pad - nq))
        probes = []
        for r in self.rs:
            if not b_keep[r].any():
                continue
            b = self.h // r
            max_out = min(self.max_results, self._parts_local * b * self.bucket_cap)
            sel, over = {}, {}
            for s, shard in self._tables.items():
                dev = self.mesh.shard_device(self.shard_axis, s)
                if r not in shard:  # a shard without partitions
                    sel[s] = torch.full((q_pad, max_out), -1, dtype=torch.int32, device=dev)
                    over[s] = 0
                    continue
                lo, hi = self._parts(s)
                sorted_fp, sorted_ids = shard[r]
                flat, trunc = lsh_ops.query_stacked_masked(
                    sorted_fp, sorted_ids, q.to(dev), b, r, self.bucket_cap,
                    torch.from_numpy(b_keep[r][:, lo:hi].copy()).to(dev), shard["n_valid"],
                )
                flat = torch.where(flat >= 0, flat + lo * self._n_pad, -1)
                sel[s], n_match = lsh_ops.unique_compact(flat, max_out)
                over[s] = trunc + (n_match.long() - max_out).clamp_min(0).sum()
            probes.append((all_gather_cat(self.mesh, self.shard_axis, sel, dim=1),
                           psum(self.mesh, over)))
        results = [set() for _ in range(nq)]
        total = 0
        keys_flat = self._flat_keys()
        for ids, trunc in probes:
            ids_host = ids.cpu().numpy()[:nq]
            total += int(trunc)
            for qi in range(nq):
                # shard-disjoint global ids: no cross-shard duplicate
                row = ids_host[qi]
                results[qi].update(keys_flat[row[row >= 0]].tolist())
        self.last_truncated = total
        return [list(r) for r in results]

    def _scan_dispatch(self, q_sigs: torch.Tensor, sizes: np.ndarray):
        """Enqueue the first pass on every shard that holds rows, at the
        per-shard cap; returns what the single-device dispatch does.

        JAX's sharded scan also scans the zero rows (size 1) that pad its
        batch to a power of two >= 8, and their overflow enters its rerun
        rule and ``last_truncated`` (its single-device scan counts real
        queries only). One zero row is scanned here, its overflow counted
        once for each padding row."""
        nq = q_sigs.shape[0]
        n_zero = pow2_at_least(nq, 8) - nq
        cap = min(self.max_results, self._parts_local * self._n_pad)
        q_all = torch.cat([q_sigs, torch.zeros_like(q_sigs[:1])]) if n_zero else q_sigs
        q_sizes = torch.from_numpy(np.append(sizes, 1)[: q_all.shape[0]].astype(np.int32))
        passes = {}
        for s, shard in self._tables.items():
            if shard["sigs"].shape[0]:
                dev = self.mesh.shard_device(self.shard_axis, s)
                q, qs = q_all.to(dev), q_sizes.to(dev)
                passes[s] = lsh_ops.containment_first_pass(
                    shard["sigs"].reshape(-1, self.h), shard["sizes"], q, qs,
                    self.threshold, cap) + (q[:nq], qs[:nq])
        return [p[1] for p in passes.values()], (cap, nq, n_zero), lambda: passes

    def _scan_finish(self, item) -> list:
        """Finish each shard's pass (the zero row is never rescanned);
        gather every shard's answer counts and row ids, padded to the
        longest, in one copy back. Results keep JAX's gathered order:
        shard by shard, each (c desc, row asc)."""
        n_match, (cap, nq, n_zero), on_card = item
        rec = recording()
        over, part = dict.fromkeys(self._tables, 0), {}
        for (s, (keys, _, q, qs)), n_s in zip(on_card().items(), n_match):
            shard = self._tables[s]
            n_host, answers, ids = self._finish_pass(
                shard["sigs"].reshape(-1, self.h), shard["sizes"], n_s, keys, q, qs, cap,
                rec)
            rows = np.maximum(n_host - cap, 0)
            over[s] = int(rows[:nq].sum() + n_zero * rows[nq:].sum())
            part[s] = torch.cat([torch.from_numpy(answers.astype(np.int32)).to(ids.device),
                                 ids[: int(answers.sum())] + self._parts(s)[0] * self._n_pad])
        for s in self._tables.keys() - part.keys():  # a shard without partitions
            part[s] = torch.zeros(nq, dtype=torch.int32,
                                  device=self.mesh.shard_device(self.shard_axis, s))
        width = int(pmax(self.mesh, {s: len(t) for s, t in part.items()}))
        part = {s: torch.nn.functional.pad(t, (0, width - len(t))) for s, t in part.items()}
        (host,) = _fetch(all_gather_cat(self.mesh, self.shard_axis, part, dim=0))
        self.last_truncated = int(psum(self.mesh, over))
        keys_flat = self._flat_keys()
        with span("dstt.facade.decode"):
            lists = [_answer_lists(keys_flat, row[nq: nq + row[:nq].sum()], row[:nq])
                     for row in host.reshape(-1, width)]
            return [sum(parts, []) for parts in zip(*lists)]

    # ------------------------------------------------------------ persistence

    @classmethod
    def load(cls, path: str, mesh: Mesh, shard_axis: str = "data") -> "ShardedMinHashLSHEnsemble":
        """Load a single-device or sharded ensemble checkpoint of either
        package onto ``mesh`` (tables re-derive; the shard count may differ).

        SECURITY: the key lists inside the file are a pickle payload -- only
        load index files you created or trust.
        """
        from datasketch_tpu_torch.persist import npz_path, unpack_keys

        data = np.load(npz_path(path), allow_pickle=False)
        if str(data["kind"]) != "tpu_ensemble":
            raise ValueError("not a TpuMinHashLSHEnsemble checkpoint")
        obj = cls(mesh, threshold=float(data["threshold"]), num_perm=int(data["num_perm"]),
                  num_part=int(data["num_part"]), m=int(data["m"]),
                  bucket_cap=int(data["bucket_cap"]),
                  weights=tuple(float(w) for w in data["weights"]), shard_axis=shard_axis)
        obj.lowers = [None if x < 0 else int(x) for x in data["lowers"]]
        obj.uppers = [None if x < 0 else int(x) for x in data["uppers"]]
        obj._n_valid = data["n_valid"].astype(np.int32)
        sigs = data["sigs"]
        obj._n_pad = sigs.shape[1]
        obj._keys_per_part = unpack_keys(data["keys"])
        obj._key_set = set().union(*map(set, obj._keys_per_part))
        if "sizes" in data:
            obj._set_sizes(data["sizes"])
        obj._build_tables(as_sig_tensor(sigs, mesh.home))
        return obj
