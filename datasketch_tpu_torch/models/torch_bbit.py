"""TorchBBitIndex -- exact top-k search over b-bit MinHash on the card.

Port of ``datasketch_tpu/models/tpu_bbit.py::TpuBBitIndex``. Stored
signatures keep the b lowest bits of each value, packed s bits per slot
(:mod:`datasketch_tpu_torch.ops.bbit_ops`): 32x fewer bytes than full
signatures at b = 1, 8x at b = 4. A query batch is scored against every
stored row by kernel 5 under a running top-k, and scores are the Li &
König estimate ``(count/num_perm - C1) / (1 - C2)``, computed on the host
in float64 exactly as the JAX class does, so they equal
``bBitMinHash.jaccard`` of the same pair bit for bit. Ties in count rank
by insertion order.

Device state is the packed rows (int32[N, W], no padding rows) and, once
something was removed, a bool mask of live rows. An insert packs its batch
on the batch's device and appends it; a device tensor never passes
through the host.
"""

from __future__ import annotations

from typing import Hashable, Sequence

import numpy as np
import torch

from datasketch_tpu_torch.device import as_sig_tensor, resolve_device, to_numpy_u32
from datasketch_tpu_torch.models.minhash import MinHash
from datasketch_tpu_torch.models.torch_lsh import _as_signature_matrix, _decode_rows
from datasketch_tpu_torch.ops import bbit_ops
from datasketch_tpu_torch.persist import atomic_savez, npz_path, pack_keys, unpack_keys

__all__ = ["TorchBBitIndex"]


class TorchBBitIndex:
    """Exact-scan top-k index over b-bit compressed MinHash signatures.

    Args:
        b: Bits kept per hash value, in [1, 32] (stored at the slot
            ladder's width; b = 1 stores 32 slots per uint32 word).
        num_perm: Signature length of indexed sketches.
        r: Expected density parameter of the Li & König estimator
            (reference default 0.0).
        tile: Kept for the JAX package's constructor and index files. The
            port's scan sizes its own steps to the query batch
            (``bbit_ops.bbit_topk_scan``, 2**26 counts per step); answers
            do not depend on it.
        device: ``"cuda"`` (default) or ``"cpu"`` (the kernel's plain
            version). No silent fallback.
    """

    def __init__(self, b: int = 4, num_perm: int = 128, r: float = 0.0,
                 tile: int = 2048, device="cuda"):
        b = int(b)
        if b < 1 or b > 32:
            raise ValueError("b must be an integer in [1, 32]")
        if not 0.0 <= float(r) <= 1.0:
            raise ValueError("r must be a float in [0.0, 1.0]")
        if num_perm <= 0:
            raise ValueError("num_perm must be positive")
        self.device = resolve_device(device)
        self.b = b
        self.num_perm = int(num_perm)
        self.r = float(r)
        self.tile = int(tile)
        self.width = bbit_ops.words_per_sig(self.num_perm, b)
        self._c1, self._c2 = bbit_ops.estimator_constants(b, self.r, self.r)
        self._keys: list = []  # position -> key (kept for removed rows)
        self._key_to_pos: dict = {}
        self._packed = None  # int32[N, W] on device
        self._alive = np.zeros(0, dtype=bool)  # host; False = removed
        self._alive_dev = None  # bool[N] on device while a row is removed
        self._n_removed = 0

    # ------------------------------------------------------------- building

    def insert(self, key: Hashable, minhash) -> None:
        self.insert_batch([key], [minhash])

    def insert_batch(self, keys: Sequence[Hashable], minhashes) -> None:
        """Pack a batch on its device and append it. Takes what
        ``TorchMinHashLSH.index`` takes: a uint32 matrix, an int32 tensor,
        an [N, P, 2] (k, t) batch, or rows / MinHash, bBitMinHash or
        WeightedMinHash objects. The whole batch is validated first."""
        keys = list(keys)
        sigs = _as_signature_matrix(minhashes, self.device)
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
        self._keys.extend(keys)
        self._packed = packed if self._packed is None else torch.cat([self._packed, packed])
        self._alive = np.concatenate([self._alive, np.ones(len(keys), dtype=bool)])
        if self._alive_dev is not None:
            self._alive_dev = torch.cat(
                [self._alive_dev, torch.ones(len(keys), dtype=torch.bool, device=self.device)]
            )

    def insert_tokens(self, keys: Sequence[Hashable], token_docs, seed: int = 1) -> None:
        """Bulk-insert pre-tokenized integer documents, their ids hashed on
        the card (``hashfunc="device"``). Query with ``hashfunc="device"``
        sketches at equal seed."""
        if len(keys) != len(token_docs):
            raise ValueError("keys and token_docs must have equal length")
        self.insert_batch(keys, MinHash.bulk_signatures(
            token_docs, num_perm=self.num_perm, seed=seed, hashfunc="device",
            out="device", device=self.device,
        ))

    def insert_text(self, keys: Sequence[Hashable], texts, k: int = 9, seed: int = 1) -> None:
        """Bulk-insert raw texts, their k-byte shingles hashed on the card
        (``MinHash.bulk_from_text(hashfunc="device")``)."""
        if len(keys) != len(texts):
            raise ValueError("keys and texts must have equal length")
        self.insert_batch(keys, MinHash.bulk_from_text(
            texts, k=k, num_perm=self.num_perm, seed=seed, hashfunc="device",
            out="device", device=self.device,
        ))

    def remove(self, key: Hashable) -> None:
        self.remove_batch([key])

    def remove_batch(self, keys: Sequence[Hashable]) -> None:
        """Tombstone keys (the mask changes; the rows stay until
        :meth:`compact`). Keys before a missing one are removed, as in the
        JAX package."""
        try:
            for k in keys:
                pos = self._key_to_pos.pop(k, None)
                if pos is None:
                    raise ValueError("The given key does not exist: %r" % (k,))
                self._alive[pos] = False
                self._n_removed += 1
        finally:
            self._alive_dev = None
            if self._n_removed and self._packed is not None:
                self._alive_dev = torch.from_numpy(self._alive).to(self.device)

    def compact(self) -> None:
        """Drop tombstoned rows and renumber positions."""
        if not self._n_removed:
            return
        keep = self._alive
        self._packed = self._packed[torch.from_numpy(keep).to(self.device)]
        self._keys = [k for k, a in zip(self._keys, keep) if a]
        self._key_to_pos = {k: i for i, k in enumerate(self._keys)}
        self._alive = np.ones(len(self._keys), dtype=bool)
        self._alive_dev = None
        self._n_removed = 0
        if not self._keys:
            self._packed = None

    # -------------------------------------------------------------- queries

    def query(self, minhash, k: int) -> list:
        """Top-k keys by estimated Jaccard (b-bit match fraction)."""
        return self.query_batch([minhash], k)[0]

    def query_batch(self, minhashes, k: int, return_scores: bool = False) -> list:
        """Top-k for a query batch: one scan on the card, one fetch.

        Returns a list per query of keys -- or (key, corrected_estimate)
        pairs when ``return_scores`` -- best match first.
        """
        out = self._query_dispatch(minhashes, k)
        if isinstance(out, list):
            return out
        return self._query_finish(tuple(t.cpu() for t in out), return_scores)

    def query_stream(self, batches, k: int, return_scores: bool = False, depth: int = 4):
        """Pipelined :meth:`query_batch` over an iterable of batches
        (:func:`datasketch_tpu_torch.utils.pipeline.stream_batches`)."""
        from datasketch_tpu_torch.utils.pipeline import stream_batches

        if k <= 0:
            raise ValueError("k must be positive")

        def _finish(out):
            if isinstance(out, list):
                return out
            return self._query_finish(out, return_scores)

        return stream_batches(batches, lambda bt: self._query_dispatch(bt, k), _finish,
                              depth=depth)

    def _query_dispatch(self, minhashes, k: int):
        """Enqueue one batch: (ids, counts) tensors on the device, or the
        finished answer (a list) when there is nothing to scan."""
        if k <= 0:
            raise ValueError("k must be positive")
        if self._packed is None:
            return [[] for _ in minhashes]
        q = _as_signature_matrix(minhashes, self.device)
        if q.shape[0] == 0:
            return []
        if q.shape[1] < self.num_perm:
            raise ValueError("The num_perm of MinHash out of range")
        q_packed = bbit_ops.pack_bbit(q[:, : self.num_perm], self.b)
        return bbit_ops.bbit_topk_scan(self._packed, q_packed, k, self.b, self.num_perm,
                                       alive=self._alive_dev)

    def _query_finish(self, out, return_scores: bool) -> list:
        """Host decode of fetched (ids, counts): the JAX class's float64
        estimate, elementwise, so every score equals its bit for bit."""
        ids, cnt = (t.numpy() for t in out)
        est = None
        if return_scores:
            est = (cnt.astype(np.float64) / self.num_perm - self._c1) / (1.0 - self._c2)
        return _decode_rows(ids, est, self._keys, return_scores)

    def warmup(self, batch_sizes=(8, 64), k: int = 10) -> None:
        """Build the kernels and fill the allocator before serving traffic."""
        if self._packed is None:
            return
        rng = np.random.RandomState(0)
        for q in batch_sizes:
            sigs = rng.randint(0, 1 << 32, size=(int(q), self.num_perm), dtype=np.uint64)
            self.query_batch(sigs.astype(np.uint32), k)

    # ------------------------------------------------------------- plumbing

    def __contains__(self, key: Hashable) -> bool:
        return key in self._key_to_pos

    def __len__(self) -> int:
        return len(self._key_to_pos)

    def is_empty(self) -> bool:
        return not self._key_to_pos

    def status(self) -> dict:
        """Operational counters: live and tombstoned rows, packing, and the
        device bytes of the packed rows and the live mask (the port stores
        no padding rows)."""
        n = 0 if self._packed is None else int(self._packed.shape[0])
        mask = 0 if self._alive_dev is None else int(self._alive_dev.numel())
        return {
            "n_live": len(self._key_to_pos),
            "n_removed": self._n_removed,
            "n_padded": 0,
            "b": self.b,
            "slot_bits": bbit_ops.slot_size(self.b),
            "words_per_sig": self.width,
            "compression_x": (4 * self.num_perm) / (4.0 * self.width),
            "device_bytes": n * self.width * 4 + mask,
        }

    # ------------------------------------------------------------ persistence

    def save(self, path: str) -> None:
        """Persist packed rows and keys as .npz in the JAX package's format
        (tombstones compacted first)."""
        self.compact()
        packed = (np.zeros((0, self.width), dtype=np.uint32) if self._packed is None
                  else to_numpy_u32(self._packed))
        atomic_savez(
            path,
            packed=packed,
            keys=pack_keys(self._keys),
            params=np.array([self.b, self.num_perm, self.tile], dtype=np.int64),
            r=np.float64(self.r),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "TorchBBitIndex":
        """Load an index saved by this class or by ``TpuBBitIndex``.

        SECURITY: the key list inside the file is a pickle payload -- only
        load index files you created or trust."""
        data = np.load(npz_path(path), allow_pickle=False)
        b, num_perm, tile = (int(x) for x in data["params"])
        obj = cls(b=b, num_perm=num_perm, r=float(data["r"]), tile=tile, device=device)
        obj._keys = list(unpack_keys(data["keys"]))
        obj._key_to_pos = {k: i for i, k in enumerate(obj._keys)}
        obj._alive = np.ones(len(obj._keys), dtype=bool)
        if obj._keys:
            obj._packed = as_sig_tensor(np.asarray(data["packed"], dtype=np.uint32), obj.device)
        return obj
