"""Collectives over a mesh axis: the port's stand-in for ``shard_map``.

In the JAX package a shard body runs inside ``jax.shard_map`` and meets the
other shards through ``lax.all_gather(tiled=True)``, ``psum``, ``pmin``,
``pmax`` and ``axis_index``. Here a shard body is a Python loop over this
rank's shards (:meth:`Mesh.local_shards`), each shard's result a tensor in
a dict keyed by shard index, and these helpers combine them:

- inside one process they are torch ops across the local tensors;
- across processes they call ``torch.distributed`` on the mesh's group.
  With NCCL, CUDA tensors go straight through; with gloo, which has no
  ``all_gather`` for CUDA tensors, every collective copies its operand to
  the host and its result back, explicitly. The backend is the one the
  caller gave :func:`~datasketch_tpu_torch.parallel.mesh.init_distributed`;
  a failed collective raises.

Each shard is contributed once, by the rank that owns it, so a sum counts
it once however many replicas the mesh's other axes hold.
"""

from __future__ import annotations

import numpy as np
import torch

from datasketch_tpu_torch.parallel.mesh import Mesh

__all__ = ["all_gather_cat", "psum", "pmin", "pmax", "position_index"]


def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The operand as the group's backend takes it: on the host for gloo."""
    import torch.distributed as dist

    if dist.get_backend(mesh.group) == "gloo":
        return t.cpu()
    return t


def _owners(mesh: Mesh, axis: str):
    """(the rank of each shard of ``axis``, each rank's shards). Every rank
    must own one: the check reads only the mesh, so all ranks raise alike
    instead of one leaving the others waiting in a collective."""
    owners = mesh.shard_ranks(axis)
    per_rank = [[s for s, r in enumerate(owners) if r == rank] for rank in range(mesh.world)]
    if not all(per_rank):
        raise ValueError("every rank must own a shard of mesh axis %r: %s"
                         % (axis, per_rank))
    return owners, per_rank


def all_gather_cat(mesh: Mesh, axis: str, local: dict, dim: int) -> torch.Tensor:
    """Concatenate every shard's tensor along ``dim`` in shard order (the
    ``tiled=True`` all_gather), on this rank's home device.

    ``local`` maps each of this rank's shards to its tensor; every shard's
    tensor has the same shape and dtype.
    """
    n = mesh.shape[axis]
    home = mesh.home
    if not mesh.is_multiprocess:
        return torch.cat([local[s].to(home) for s in range(n)], dim=dim)
    import torch.distributed as dist

    owners, per_rank = _owners(mesh, axis)
    slots = max(len(p) for p in per_rank)
    t = next(iter(local.values()))
    shape, dtype = tuple(t.shape), t.dtype
    mine = per_rank[mesh.rank]
    stack = torch.zeros((slots,) + shape, dtype=dtype, device=home)
    for i, s in enumerate(mine):
        stack[i] = local[s].to(home)
    stack = _staged(mesh, stack)
    recv = [torch.empty_like(stack) for _ in range(mesh.world)]
    dist.all_gather(recv, stack, group=mesh.group)
    parts = [recv[owners[s]][per_rank[owners[s]].index(s)] for s in range(n)]
    return torch.cat(parts, dim=dim).to(home)


def _reduce(mesh: Mesh, local: dict, fold, op_name: str) -> torch.Tensor:
    """Fold this rank's shard tensors, then all_reduce the fold (int64)."""
    home = mesh.home
    vals = [torch.as_tensor(v).to(home, torch.int64) for v in local.values()]
    out = None
    for v in vals:
        out = v if out is None else fold(out, v)
    if not mesh.is_multiprocess:
        return out
    import torch.distributed as dist

    if out is None:
        raise ValueError("this rank holds no shard to reduce")
    buf = _staged(mesh, out.clone())
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, op_name), group=mesh.group)
    return buf.to(home)


def psum(mesh: Mesh, local: dict) -> torch.Tensor:
    """Sum of every shard's value (ints or integer tensors) as an int64
    tensor on the home device."""
    return _reduce(mesh, local, torch.add, "SUM")


def pmin(mesh: Mesh, local: dict) -> torch.Tensor:
    """Elementwise minimum over every shard's integer tensor, compared as
    int64 (so uint32 bit patterns held in int32 are widened first by the
    caller)."""
    return _reduce(mesh, local, torch.minimum, "MIN")


def pmax(mesh: Mesh, local: dict) -> torch.Tensor:
    """Elementwise maximum over every shard's integer tensor, as int64."""
    return _reduce(mesh, local, torch.maximum, "MAX")


def position_index(mesh: Mesh, axis: str, position: int) -> int:
    """The coordinate along ``axis`` of flat position ``position``
    (``lax.axis_index`` inside a shard body)."""
    ax = mesh.axis_names.index(axis)
    return int(np.unravel_index(position, mesh.devices.shape)[ax])
