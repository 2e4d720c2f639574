"""ShardedMinHashLSHBloom -- bit-space-sharded membership LSH over a mesh.

Port of ``datasketch_tpu/parallel/sharded_bloom.py``: the mesh form of
:class:`~datasketch_tpu_torch.models.lsh_bloom.TorchMinHashLSHBloom`. A
bloom filter holds no per-document state; what grows is the bitmap, so the
``[b, num_words]`` band bitmaps shard over their WORD axis: shard s owns
the words ``[s*W, (s+1)*W)`` with ``W = ceil(num_words / S)`` (the last
shard holds what is left; nothing is padded). An insert is deduplicated on
the host into unique (band, word, OR-combined mask) triples, split into
(owner shard, local word) pairs, and each shard ORs its own in with one
gather and one unique-index write. A query counts the missing bits per
(doc, band) on every shard and sums the counts with one ``psum``: a band
hits when no shard reports a miss.

The probe scheme, the band keys and the ``.npz`` layout are the
single-device class's, so checkpoints load in both classes of both
packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from datasketch_tpu_torch.device import upload_bits
from datasketch_tpu_torch.models.lsh_bloom import TorchMinHashLSHBloom, _batch
from datasketch_tpu_torch.parallel.collectives import psum
from datasketch_tpu_torch.parallel.mesh import Mesh, fetch_global

__all__ = ["ShardedMinHashLSHBloom"]


class ShardedMinHashLSHBloom(TorchMinHashLSHBloom):
    """Membership-only LSH with the packed band bitmaps sharded over a mesh.

    Args:
        mesh: :class:`~datasketch_tpu_torch.parallel.mesh.Mesh`; bitmap
            words shard over ``shard_axis``.
        (rest as :class:`~datasketch_tpu_torch.models.lsh_bloom.TorchMinHashLSHBloom`.)
    """

    def __init__(self, mesh: Mesh, threshold: float = 0.9, num_perm: int = 128,
                 weights: tuple = (0.5, 0.5), params: Optional[tuple] = None,
                 n: int = 1_000_000, fp: float = 0.01, shard_axis: str = "data"):
        self._set_params(threshold, num_perm, weights, params, n, fp)
        self._init_mesh(mesh, shard_axis, None)

    def _init_mesh(self, mesh: Mesh, shard_axis: str, words_host) -> None:
        """Allocate (or upload from ``words_host``) this rank's word shards."""
        self.mesh = mesh
        self.device = mesh.home
        self.shard_axis = shard_axis
        self.n_shards = mesh.shape[shard_axis]
        self._local_words = -(-self.num_words // self.n_shards)
        self._shards = {}
        for s in mesh.local_shards(shard_axis):
            lo, hi = self._span(s)
            dev = mesh.shard_device(shard_axis, s)
            if words_host is None:
                self._shards[s] = torch.zeros((self.b, hi - lo), dtype=torch.int32,
                                              device=dev)
            else:
                self._shards[s] = upload_bits(
                    np.ascontiguousarray(words_host[:, lo:hi], dtype=np.uint32), dev)

    def _span(self, s: int):
        w = self._local_words
        return min(s * w, self.num_words), min((s + 1) * w, self.num_words)

    # --------------------------------------------------------------- ops

    def insert_batch(self, minhashes) -> None:
        """Each shard ORs in its own unique (band, word) masks: one gather
        and one unique-index write per shard."""
        minhashes = _batch(minhashes)
        if len(minhashes) == 0:
            return
        band, word, mask = self._word_updates(minhashes)
        owner = word // self._local_words
        local = word % self._local_words
        for s, words in self._shards.items():
            mine = owner == s
            if not mine.any():
                continue
            dev = words.device
            bd, lw, m = (upload_bits(np.ascontiguousarray(a[mine]), dev)
                         for a in (band, local, mask))
            words.index_put_((bd, lw), words[bd, lw] | m)

    def query_batch(self, minhashes) -> np.ndarray:
        """bool[N]: True where any band's filter hits (a likely duplicate):
        every shard counts the bits missing in its words per (doc, band),
        and one psum adds the counts."""
        minhashes = _batch(minhashes)
        if len(minhashes) == 0:
            return np.zeros(0, dtype=bool)
        pos = self._positions(minhashes)  # [N, b, k]
        word = pos >> 5
        host = (word // self._local_words, word % self._local_words,
                np.uint32(1) << (pos & 31).astype(np.uint32))
        uploaded = {}  # device -> (owner, local word, mask), sent once per device
        miss = {}
        for s, words in self._shards.items():
            dev = words.device
            if dev not in uploaded:
                uploaded[dev] = tuple(upload_bits(a, dev) for a in host)
            owner, local, mask = uploaded[dev]
            mine = owner == s
            if not words.shape[1]:
                miss[s] = torch.zeros(pos.shape[:2], dtype=torch.int64, device=dev)
                continue
            band = torch.arange(self.b, device=dev)[None, :, None]
            bit = (words[band, local.clamp(max=words.shape[1] - 1)] & mask) != 0
            miss[s] = (mine & ~bit).sum(dim=2)
        return (psum(self.mesh, miss) == 0).any(dim=1).cpu().numpy()

    # ------------------------------------------------------------ persistence

    def _host_words(self) -> np.ndarray:
        """uint32[b, num_words] host copy (a collective across processes)."""
        rows = [hi - lo for lo, hi in (self._span(s) for s in range(self.n_shards))]
        local = {s: w.T for s, w in self._shards.items()}
        return np.ascontiguousarray(
            fetch_global(self.mesh, self.shard_axis, local, rows).T).view(np.uint32)

    def save(self, path: str) -> None:
        """The single-device class's ``.npz`` layout, so checkpoints load in
        either class of either package. A collective across processes."""
        from datasketch_tpu_torch.persist import atomic_savez, npz_path

        atomic_savez(
            npz_path(path),
            bits_packed=self._host_words(),
            meta=np.array([self.h, self.b, self.r, self.num_bits, self.num_hashes],
                          dtype=np.int64),
            probe_scheme=np.int64(self._PROBE_SCHEME),
            threshold=np.float64(self.threshold),
        )

    @classmethod
    def load(cls, path: str, mesh: Mesh, shard_axis: str = "data") -> "ShardedMinHashLSHBloom":
        """Load a single-device or sharded checkpoint of either package onto
        ``mesh``."""
        single = TorchMinHashLSHBloom.load(path, device="cpu")
        obj = cls.__new__(cls)
        obj.threshold = single.threshold
        obj.h = single.h
        obj.b, obj.r = single.b, single.r
        obj.num_bits = single.num_bits
        obj.num_words = single.num_words
        obj.num_hashes = single.num_hashes
        obj.hashranges = single.hashranges
        obj._init_mesh(mesh, shard_axis, single._words.numpy().view(np.uint32))
        return obj
