"""Sharded sketch construction and collective merges.

Port of ``datasketch_tpu/parallel/sharded_sketch.py``. MinHash signatures
of a token batch are data-parallel over documents (mesh axis ``data``) and
tensor-parallel over permutations (``model``): each (data, model) block is
signed at its own position, by kernel 1 on a card. The union of MinHash
signatures is an elementwise unsigned min and the union of HyperLogLog
registers an elementwise max, so a cross-shard union is one ``pmin`` /
``pmax``.

A sharded result is a :class:`ShardedArray`: this rank's blocks keyed by
their (data, model) coordinates, and the global shape. ``np.asarray`` of
one gathers it (a collective across processes).
"""

from __future__ import annotations

import numpy as np
import torch

from datasketch_tpu_torch.device import u32_bits, u32_to_i32
from datasketch_tpu_torch.ops import minhash_ops
from datasketch_tpu_torch.parallel.collectives import all_gather_cat, pmax, pmin
from datasketch_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "ShardedArray",
    "sharded_compute_signatures",
    "distributed_minhash_union",
    "distributed_hll_union",
]


class ShardedArray:
    """A 2-D array split in blocks over two mesh axes (rows over
    ``row_axis``, columns over ``col_axis`` or unsplit when it is None).

    ``blocks`` maps (row coordinate, column coordinate) to this rank's
    block tensors; each block lives on the device of its first position.
    """

    def __init__(self, mesh: Mesh, blocks: dict, shape, row_axis: str, col_axis=None):
        self.mesh = mesh
        self.blocks = blocks
        self.shape = tuple(shape)
        self.row_axis = row_axis
        self.col_axis = col_axis

    def full(self) -> torch.Tensor:
        """The whole array on this rank's home device (every block of a
        column gathered, then the columns side by side)."""
        mesh = self.mesh
        n_cols = 1 if self.col_axis is None else mesh.shape[self.col_axis]
        cols = []
        for j in range(n_cols):
            local = {i: t for (i, jj), t in self.blocks.items() if jj == j}
            cols.append(all_gather_cat(mesh, self.row_axis, local, dim=0))
        return torch.cat(cols, dim=1)

    def __array__(self, dtype=None, copy=None):
        out = self.full().cpu().numpy()
        if out.dtype == np.int32:
            out = out.view(np.uint32)
        return out if dtype is None else out.astype(dtype)


def _block_owners(mesh: Mesh, row_axis: str, col_axis):
    """{(i, j): (rank, device)} of the first position of each block."""
    r_ax = mesh.axis_names.index(row_axis)
    c_ax = None if col_axis is None else mesh.axis_names.index(col_axis)
    owners = {}
    for p in range(mesh.size):
        idx = np.unravel_index(p, mesh.devices.shape)
        key = (int(idx[r_ax]), 0 if c_ax is None else int(idx[c_ax]))
        if key not in owners:
            owners[key] = (int(mesh.ranks.reshape(-1)[p]), mesh.devices.reshape(-1)[p])
    return owners


def shard_blocks(x: torch.Tensor, mesh: Mesh, row_axis: str, col_axis=None) -> ShardedArray:
    """Split a full [B, C] tensor into this rank's blocks: rows over
    ``row_axis`` (B divisible by its size), columns over ``col_axis``."""
    dp = mesh.shape[row_axis]
    tp = 1 if col_axis is None else mesh.shape[col_axis]
    if x.shape[0] % dp or x.shape[1] % tp:
        raise ValueError("shape %r does not split over %d x %d" % (tuple(x.shape), dp, tp))
    rb, cb = x.shape[0] // dp, x.shape[1] // tp
    blocks = {}
    for (i, j), (rank, dev) in _block_owners(mesh, row_axis, col_axis).items():
        if rank == mesh.rank:
            blocks[i, j] = x[i * rb: (i + 1) * rb, j * cb: (j + 1) * cb].to(dev)
    return ShardedArray(mesh, blocks, x.shape, row_axis, col_axis)


def sharded_compute_signatures(hashes, lengths, seed: int, num_perm: int,
                               mesh: Mesh) -> ShardedArray:
    """MinHash signatures for a token batch, dp x tp over the mesh.

    The batch axis shards over mesh axis ``data``, the permutation axis
    over ``model``: each block's position signs its documents with its
    slice of the ``num_perm`` universal hashes (kernel 1 on a card).

    Args:
        hashes: uint32[B, T] padded token hashes (B divisible by the data
            axis), a numpy array or an int32 tensor of uint32 bits.
        lengths: int32[B] valid token counts.
    Returns:
        A :class:`ShardedArray` of uint32[B, num_perm] (int32 bits), its
        blocks sharded (data, model).
    """
    dp = mesh.shape["data"]
    tp = mesh.shape.get("model", 1)
    n = hashes.shape[0]
    if n % dp:
        raise ValueError("batch %d not divisible by data axis %d" % (n, dp))
    if num_perm % tp:
        raise ValueError("num_perm %d not divisible by model axis %d" % (num_perm, tp))
    a, b = minhash_ops.init_permutations(seed, num_perm)
    if not isinstance(hashes, torch.Tensor):
        hashes = torch.from_numpy(np.ascontiguousarray(hashes, dtype=np.uint32).view(np.int32))
    lengths = torch.as_tensor(np.asarray(lengths, dtype=np.int32)) \
        if not isinstance(lengths, torch.Tensor) else lengths
    col_axis = "model" if "model" in mesh.shape else None
    rb, pb = n // dp, num_perm // tp
    blocks = {}
    for (i, j), (rank, dev) in _block_owners(mesh, "data", col_axis).items():
        if rank != mesh.rank:
            continue
        perms = (a[j * pb: (j + 1) * pb], b[j * pb: (j + 1) * pb])
        blocks[i, j] = minhash_ops.compute_signatures(
            hashes[i * rb: (i + 1) * rb].to(dev), lengths[i * rb: (i + 1) * rb].to(dev),
            seed, pb, permutations=perms,
        )
    return ShardedArray(mesh, blocks, (n, num_perm), "data", col_axis)


def distributed_minhash_union(sigs, mesh: Mesh) -> torch.Tensor:
    """Union (elementwise unsigned min) of all signatures across the batch
    and the mesh: uint32[B, P] sharded (data, model) -> int32[P] (uint32
    bits) on this rank's home device. A full tensor is split first.

    Each block's rows fold locally, then one ``pmin`` over the data axis
    per model slice -- the collective form of ``MinHash.union``.
    """
    if not isinstance(sigs, ShardedArray):
        sigs = shard_blocks(sigs, mesh, "data", "model" if "model" in mesh.shape else None)
    tp = 1 if sigs.col_axis is None else mesh.shape[sigs.col_axis]
    out = []
    for j in range(tp):
        local = {i: u32_bits(t).amin(dim=0) for (i, jj), t in sigs.blocks.items() if jj == j}
        out.append(u32_to_i32(pmin(mesh, local)))
    return torch.cat(out)


def distributed_hll_union(regs, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Union (register max) of HLL register batches across the mesh:
    [B, m] sharded over ``axis`` -> [m] on this rank's home device, in the
    registers' dtype; the collective form of ``HyperLogLog.merge``."""
    if not isinstance(regs, ShardedArray):
        regs = shard_blocks(regs, mesh, axis)
    dtype = next(iter(regs.blocks.values())).dtype
    local = {i: t.to(torch.int64).amax(dim=0) for (i, _), t in regs.blocks.items()}
    return pmax(mesh, local).to(dtype)
