"""The device mesh: named axes over positions, each with a device and a rank.

Port of ``datasketch_tpu/parallel/mesh.py``. A JAX ``Mesh`` is an array of
devices with named axes; here it is an array of *positions*, each with the
torch device it computes on and the rank of the process that owns it, plus
the ``torch.distributed`` process group when the mesh spans processes.
Several positions may share one device: that stands in for the JAX tests'
virtual CPU devices (``--xla_force_host_platform_device_count``) and lets
one card hold a mesh of many positions. ``DTensor`` / ``DeviceMesh`` need
one rank per device, which could express neither.

A sharded index keeps one tensor per shard of its shard axis, on the first
position of that shard (in the mesh's flat order); the positions of the
other axes hold replicas, so each shard is computed once, by its owning
rank.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "fetch_global", "init_distributed", "rows_per_shard",
           "shard_span"]


def rows_per_shard(n: int, n_shards: int) -> int:
    """The JAX package's row layout: ``n`` rows pad to the least power of
    two >= max(128, n), rounded up to a multiple of the shard count, and
    each shard owns an equal run of that. The port pads nothing, but every
    rule that JAX reads from the padded shape reads this count."""
    n_pad = 128
    while n_pad < n:
        n_pad *= 2
    return -(-n_pad // n_shards)


def shard_span(n: int, rows: int, s: int):
    """(lo, hi): the real rows of shard ``s`` when each owns ``rows`` global
    rows; the last shards may be short or empty."""
    return min(s * rows, n), min((s + 1) * rows, n)


class Mesh:
    """Positions with named axes.

    Args:
        devices: array-like of torch devices (or device strings), shaped
            as the mesh.
        axis_names: one name per axis of ``devices``.
        ranks: the owning process rank of each position (default: all 0).
        group: the ``torch.distributed`` process group the positions span,
            or None for a mesh inside one process.
    """

    def __init__(self, devices, axis_names: Sequence[str], ranks=None, group=None):
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError("mesh shape %r does not match axis names %r"
                             % (self.devices.shape, self.axis_names))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.ranks = (np.zeros(self.devices.shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(self.devices.shape))
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        if not (self.ranks == self.rank).any():
            raise ValueError("rank %d owns no position of this mesh" % self.rank)

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def is_multiprocess(self) -> bool:
        """True when the positions span a process group (its collectives
        run through ``torch.distributed``, even with one rank)."""
        return self.group is not None

    @property
    def home(self) -> torch.device:
        """This rank's first position's device: where gathered results land."""
        flat_ranks = self.ranks.reshape(-1)
        return self.devices.reshape(-1)[int(np.argmax(flat_ranks == self.rank))]

    def _first_positions(self, axis: str):
        """Flat index of the first position of each coordinate along ``axis``."""
        ax = self.axis_names.index(axis)
        coords = np.indices(self.devices.shape)[ax].reshape(-1)
        return [int(np.argmax(coords == s)) for s in range(self.devices.shape[ax])]

    def shard_ranks(self, axis: str) -> list:
        """The rank that computes each shard of ``axis``."""
        flat = self.ranks.reshape(-1)
        return [int(flat[p]) for p in self._first_positions(axis)]

    def shard_device(self, axis: str, s: int) -> torch.device:
        """The device shard ``s`` of ``axis`` lives on."""
        return self.devices.reshape(-1)[self._first_positions(axis)[s]]

    def local_shards(self, axis: str) -> list:
        """The shards of ``axis`` this rank computes, ascending."""
        return [s for s, r in enumerate(self.shard_ranks(axis)) if r == self.rank]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "model"),
    shape: Optional[Tuple[int, ...]] = None,
    device=None,
) -> Mesh:
    """Build a mesh of ``n_devices`` positions.

    Default is a 2-D ``(data, model)`` mesh, as in the JAX package:
    ``data`` shards documents, ``model`` the permutation axis of signature
    construction; the model axis is 2 when ``n_devices`` is even, else 1.

    Without ``device`` the positions are the real CUDA devices: the
    visible ones in one process, or each rank's
    ``torch.cuda.current_device()`` in rank order once
    :func:`init_distributed` has run. With ``device`` ("cpu", "cuda:0"),
    ``n_devices`` positions share that device; across processes each rank
    owns an equal run of them, in rank order, on its own ``device``.
    Asking for more devices than exist raises, and so does a CUDA mesh on
    a machine without a card.
    """
    import torch.distributed as dist

    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = 1 if group is None else dist.get_world_size(group)
    if device is not None:
        from datasketch_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        if n_devices is None:
            n_devices = world
        if n_devices % world:
            raise ValueError("%d positions do not split over %d ranks"
                             % (n_devices, world))
        devs = [dev] * n_devices
        ranks = np.repeat(np.arange(world), n_devices // world)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() without device= builds a mesh of CUDA devices, and no "
                "CUDA device is available; pass device='cpu' for a CPU mesh"
            )
        if group is None:
            devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            ranks = np.zeros(len(devs), dtype=np.int64)
        else:
            # one position per rank: each rank's current device, in rank order
            mine = torch.tensor([torch.cuda.current_device()])
            if dist.get_backend(group) == "nccl":
                mine = mine.cuda()
            every = [torch.zeros_like(mine) for _ in range(world)]
            dist.all_gather(every, mine, group=group)
            devs = [torch.device("cuda", int(t.item())) for t in every]
            ranks = np.arange(world)
        if n_devices is None:
            n_devices = len(devs)
        if n_devices > len(devs):
            raise ValueError(
                "requested %d devices but only %d available" % (n_devices, len(devs))
            )
        devs, ranks = devs[:n_devices], ranks[:n_devices]
    if shape is None:
        if len(axis_names) == 2:
            model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
            shape = (n_devices // model, model)
        else:
            shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n_devices:
        raise ValueError("mesh shape %r != n_devices %d" % (shape, n_devices))
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names, ranks=np.asarray(ranks).reshape(shape),
                group=group)


def fetch_global(mesh: Mesh, axis: str, local: dict, rows: Sequence[int]) -> np.ndarray:
    """Full host copy of a row-sharded array: shard s (``local[s]`` on its
    owning rank) holds ``rows[s]`` rows; the shards are concatenated in
    order.

    On a mesh inside one process this is a plain copy. Across processes the
    shards live in other processes, so it is a collective: EVERY process
    must reach this call in the same order (call ``save``,
    ``host_snapshot`` and ``status`` from all processes, not just one), or
    the group deadlocks like any mismatched all_reduce.
    """
    from datasketch_tpu_torch.parallel.collectives import all_gather_cat

    width = max(rows) if len(rows) else 0
    padded = {}
    for s, t in local.items():
        if t.shape[0] < width:
            pad = torch.zeros((width - t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            t = torch.cat([t, pad])
        padded[s] = t[None]
    full = all_gather_cat(mesh, axis, padded, dim=0).cpu().numpy()
    return np.concatenate([full[s, : rows[s]] for s in range(len(rows))])


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend: str = "nccl") -> None:
    """Join a ``torch.distributed`` process group before building a mesh
    that spans processes.

    The counterpart of ``jax.distributed.initialize``: call once per
    process, with the coordinator's ``host:port``, the number of processes
    and this one's id; without them the ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) are read.
    ``backend`` is the caller's choice: ``"nccl"`` moves CUDA tensors
    between cards, ``"gloo"`` moves tensors through the host (CUDA tensors
    are copied there and back explicitly). Nothing switches it later.
    """
    import torch.distributed as dist

    kwargs = {"backend": backend}
    if coordinator_address is not None:
        kwargs["init_method"] = "tcp://%s" % coordinator_address
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(**kwargs)
