"""ShardedBBitIndex -- b-bit compressed top-k scan over a mesh.

Port of ``datasketch_tpu/parallel/sharded_bbit.py``: the mesh form of
:class:`~datasketch_tpu_torch.models.torch_bbit.TorchBBitIndex`. Packed
rows shard over ``shard_axis`` in the JAX package's layout (shard s owns
the real rows of ``[s*L, (s+1)*L)``, nothing padded); each shard scans its
rows with kernel 5 under a running top-k, only k candidates per shard
ride the all_gather, and a stable cross-shard top-k merges them. Equal
counts resolve to the lower global id, as in the single-device class, and
``.npz`` checkpoints load in both classes of both packages.
"""

from __future__ import annotations

from typing import Hashable, Sequence

import numpy as np
import torch

from datasketch_tpu_torch.device import as_sig_tensor, to_numpy_u32
from datasketch_tpu_torch.models.torch_bbit import TorchBBitIndex
from datasketch_tpu_torch.models.torch_lsh import _as_signature_matrix
from datasketch_tpu_torch.ops import bbit_ops
from datasketch_tpu_torch.parallel.mesh import Mesh, fetch_global, rows_per_shard, shard_span
from datasketch_tpu_torch.parallel.sharded_lsh import _empty, gather_ranked

__all__ = ["ShardedBBitIndex"]


class ShardedBBitIndex(TorchBBitIndex):
    """b-bit exact-scan top-k with the packed rows sharded over a mesh.

    Args:
        mesh: :class:`~datasketch_tpu_torch.parallel.mesh.Mesh`; packed rows
            shard over ``shard_axis``.
        (rest as :class:`~datasketch_tpu_torch.models.torch_bbit.TorchBBitIndex`.)
    """

    def __init__(self, mesh: Mesh, b: int = 4, num_perm: int = 128, r: float = 0.0,
                 tile: int = 2048, shard_axis: str = "data"):
        super().__init__(b=b, num_perm=num_perm, r=r, tile=tile, device=mesh.home)
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.n_shards = mesh.shape[shard_axis]
        self._rows = 0
        self._shards = {}  # s -> int32[n_s, W] packed rows on the shard's device
        self._alive_local = None  # cached s -> device bool[n_s] or None

    # ------------------------------------------------------------ device sync

    def _reshard(self, packed: torch.Tensor) -> None:
        """Split every packed row over this rank's shards."""
        n = packed.shape[0]
        self._rows = rows_per_shard(n, self.n_shards)
        self._shards = {}
        for s in self.mesh.local_shards(self.shard_axis):
            lo, hi = shard_span(n, self._rows, s)
            self._shards[s] = packed[lo:hi].to(
                self.mesh.shard_device(self.shard_axis, s)).contiguous()
        self._alive_local = None

    def _all_packed(self) -> torch.Tensor:
        """Every packed row in order on the home device (through the host
        across processes, a collective)."""
        if self.mesh.is_multiprocess:
            return as_sig_tensor(self._host_packed(), self.mesh.home)
        home = self.mesh.home
        parts = [self._shards[s].to(home) for s in range(self.n_shards)]
        return (torch.cat(parts) if parts
                else torch.zeros((0, self.width), dtype=torch.int32, device=home))

    def _host_packed(self) -> np.ndarray:
        rows = [hi - lo for lo, hi in (shard_span(len(self._keys), self._rows, s)
                                       for s in range(self.n_shards))]
        return fetch_global(self.mesh, self.shard_axis, self._shards, rows).view(np.uint32)

    def insert_batch(self, keys: Sequence[Hashable], minhashes) -> None:
        """Pack a batch and re-shard the grown corpus (the whole batch is
        validated first)."""
        keys = list(keys)
        sigs = _as_signature_matrix(minhashes, self.mesh.home)
        if sigs.shape[0] != len(keys):
            raise ValueError("keys and minhashes must have equal length")
        if not keys:
            return
        if sigs.shape[1] < self.num_perm:
            raise ValueError("The num_perm of MinHash out of range")
        seen = set()
        for k in keys:
            if k in self._key_to_pos or k in seen:
                raise ValueError("The given key already exists: %r" % (k,))
            seen.add(k)
        packed = bbit_ops.pack_bbit(sigs[:, : self.num_perm], self.b)
        base = len(self._keys)
        for i, k in enumerate(keys):
            self._key_to_pos[k] = base + i
        old = self._all_packed() if self._keys else None
        self._keys.extend(keys)
        self._alive = np.concatenate([self._alive, np.ones(len(keys), dtype=bool)])
        self._reshard(packed if old is None else torch.cat([old, packed]))

    def remove_batch(self, keys: Sequence[Hashable]) -> None:
        """Tombstone keys (the shards' live masks change)."""
        try:
            super().remove_batch(keys)
        finally:
            self._alive_local = None

    def compact(self) -> None:
        """Drop tombstoned rows and re-shard."""
        if not self._n_removed:
            return
        keep = self._alive
        packed = self._all_packed()[torch.from_numpy(keep).to(self.mesh.home)]
        self._keys = [k for k, a in zip(self._keys, keep) if a]
        self._key_to_pos = {k: i for i, k in enumerate(self._keys)}
        self._alive = np.ones(len(self._keys), dtype=bool)
        self._n_removed = 0
        self._reshard(packed)

    def _alive_on(self, s: int):
        if self._alive_local is None:
            self._alive_local = {}
            for t in self._shards:
                lo, hi = shard_span(len(self._keys), self._rows, t)
                mask = self._alive[lo:hi]
                self._alive_local[t] = None if mask.all() else torch.from_numpy(
                    mask.copy()).to(self.mesh.shard_device(self.shard_axis, t))
        return self._alive_local[s]

    # ---------------------------------------------------------------- queries

    def _query_dispatch(self, minhashes, k: int):
        """Each shard's top-k by kernel 5, one all_gather and a stable
        cross-shard top-k: (ids, counts) on the home device."""
        if k <= 0:
            raise ValueError("k must be positive")
        if not self._keys:
            return [[] for _ in minhashes]
        q = _as_signature_matrix(minhashes, self.mesh.home)
        if q.shape[0] == 0:
            return []
        if q.shape[1] < self.num_perm:
            raise ValueError("The num_perm of MinHash out of range")
        q_packed = bbit_ops.pack_bbit(q[:, : self.num_perm], self.b)
        ids, counts = {}, {}
        for s, packed in self._shards.items():
            dev = self.mesh.shard_device(self.shard_axis, s)
            if not packed.shape[0]:
                ids[s], counts[s] = _empty(q.shape[0], k, dev)
                continue
            loc, cnt = bbit_ops.bbit_topk_scan(packed, q_packed.to(dev), k, self.b,
                                               self.num_perm, alive=self._alive_on(s))
            ids[s] = torch.where(loc >= 0, loc + s * self._rows, -1)
            counts[s] = cnt.to(torch.float32)  # exact: counts <= num_perm
        g_ids, g_cnt = gather_ranked(self.mesh, self.shard_axis, ids, counts, k=k)
        return g_ids, g_cnt.to(torch.int32)

    def warmup(self, batch_sizes=(8, 64), k: int = 10) -> None:
        """One synthetic query per batch size; no-op while empty."""
        if not self._keys:
            return
        rng = np.random.RandomState(0)
        for q in batch_sizes:
            sigs = rng.randint(0, 1 << 32, size=(int(q), self.num_perm), dtype=np.uint64)
            self.query_batch(sigs.astype(np.uint32), k)

    # -------------------------------------------------------------- plumbing

    def status(self) -> dict:
        """The single-device class's counters with the shard count; the
        device bytes of this rank's shards (nothing padded)."""
        out = super().status()
        mask = sum(0 if m is None else m.numel() for m in (self._alive_local or {}).values())
        rows = sum(t.shape[0] for t in self._shards.values())
        out.update(device_bytes=rows * self.width * 4 + mask, n_shards=self.n_shards,
                   shard_axis=self.shard_axis)
        return out

    def save(self, path: str) -> None:
        """Persist as the single-device class does (tombstones compacted
        first); either class of either package loads the file. A
        collective across processes."""
        from datasketch_tpu_torch.persist import atomic_savez, pack_keys

        self.compact()
        packed = (self._host_packed() if self._keys
                  else np.zeros((0, self.width), dtype=np.uint32))
        atomic_savez(
            path,
            packed=packed,
            keys=pack_keys(self._keys),
            params=np.array([self.b, self.num_perm, self.tile], dtype=np.int64),
            r=np.float64(self.r),
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh, shard_axis: str = "data") -> "ShardedBBitIndex":
        """Load a single-device or sharded checkpoint of either package onto
        ``mesh``; re-sharding to another mesh shape is just loading."""
        single = TorchBBitIndex.load(path, device="cpu")
        obj = cls(mesh, b=single.b, num_perm=single.num_perm, r=single.r, tile=single.tile,
                  shard_axis=shard_axis)
        obj._keys = single._keys
        obj._key_to_pos = single._key_to_pos
        obj._alive = single._alive
        if obj._keys:
            obj._reshard(as_sig_tensor(to_numpy_u32(single._packed), mesh.home))
        return obj
