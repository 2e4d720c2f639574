"""Scale-out over a mesh of positions on ``torch.distributed``.

Port of ``datasketch_tpu/parallel/``. Sketch construction is data-parallel
over the batch axis and tensor-parallel over the permutation axis; sketch
unions are ``pmin`` / ``pmax`` reductions; the indexes shard their
documents (or partitions, or bitmap words) across the mesh, a query goes
to every shard, and candidates come back through one all_gather
(:mod:`datasketch_tpu_torch.parallel.collectives`). A mesh's positions
may share one device (one card, or the CPU in the tests) or span
processes (:func:`init_distributed`).
"""

from datasketch_tpu_torch.parallel.mesh import init_distributed, make_mesh
from datasketch_tpu_torch.parallel.sharded_sketch import (
    distributed_hll_union,
    distributed_minhash_union,
    sharded_compute_signatures,
)
from datasketch_tpu_torch.parallel.sharded_lsh import ShardedMinHashLSH
from datasketch_tpu_torch.parallel.sharded_forest import ShardedMinHashLSHForest
from datasketch_tpu_torch.parallel.sharded_ensemble import ShardedMinHashLSHEnsemble
from datasketch_tpu_torch.parallel.sharded_hnsw import ShardedHNSW
from datasketch_tpu_torch.parallel.sharded_bloom import ShardedMinHashLSHBloom
from datasketch_tpu_torch.parallel.sharded_bbit import ShardedBBitIndex

__all__ = [
    "make_mesh",
    "init_distributed",
    "sharded_compute_signatures",
    "distributed_minhash_union",
    "distributed_hll_union",
    "ShardedMinHashLSH",
    "ShardedMinHashLSHForest",
    "ShardedMinHashLSHEnsemble",
    "ShardedHNSW",
    "ShardedMinHashLSHBloom",
    "ShardedBBitIndex",
]
