"""PyTorch + CUDA port of datasketch_tpu's MinHash -> LSH, LSH Ensemble,
LSH Forest, LSHBloom, weighted MinHash (CWS) and b-bit MinHash serving
paths, with the raw-text and token-id front ends, the OPH and C-MinHash
signature schemes, the per-object MinHash / LeanMinHash sketches, the
HyperLogLog / HyperLogLog++ cardinality sketches and HNSW (the device-built
graph served by ``TorchHNSW``, and the mutable host ``HNSW``); the host
reference classes (``MinHashLSH``, ``MinHashLSHEnsemble``,
``AsyncMinHashLSH`` and their storages) and ``FailoverIndex``, the
degraded mode that answers from a host snapshot while the card is unhealthy.
The reference's submodules (``datasketch_tpu_torch.lsh``, ``.storage``,
``.aio.lsh`` and the rest) import as they do in the JAX package, with
``torch_lsh`` / ``torch_ensemble`` for its ``tpu_lsh`` / ``tpu_ensemble``.

The JAX package (``datasketch_tpu``) is the reference this package is held
against; this one imports ``torch`` and numpy only, never JAX and never
``datasketch_tpu`` (whose ``__init__`` imports JAX).

Device choice is explicit: public entry points take ``device=`` (default
``"cuda"``). ``device="cuda"`` without an sm_90+ card raises; it never
falls back to the CPU. ``device="cpu"`` runs the plain PyTorch twins of the
hand-written Hopper kernels (``datasketch_tpu_torch.kernels``).

Importing this package creates no CUDA context, builds nothing and imports
no optional storage client: the kernels compile with ``nvcc`` at first use
on the card, and Redis, Cassandra and MongoDB clients are imported when
such a storage is created.
"""

from datasketch_tpu_torch.aio import AsyncMinHashLSH
from datasketch_tpu_torch.hashfunc import (
    device_hash,
    sha1_hash32,
    sha1_hash64,
    xxhash_hash32,
)
from datasketch_tpu_torch.models.b_bit_minhash import bBitMinHash
from datasketch_tpu_torch.models.hnsw import HNSW
from datasketch_tpu_torch.models.hyperloglog import HyperLogLog, HyperLogLogPlusPlus
from datasketch_tpu_torch.models.lean_minhash import LeanMinHash
from datasketch_tpu_torch.models.lsh import MinHashLSH
from datasketch_tpu_torch.models.lsh_bloom import MinHashLSHBloom, TorchMinHashLSHBloom
from datasketch_tpu_torch.models.lshensemble import MinHashLSHEnsemble
from datasketch_tpu_torch.models.lshforest import MinHashLSHForest
from datasketch_tpu_torch.models.minhash import MinHash
from datasketch_tpu_torch.models.torch_bbit import TorchBBitIndex
from datasketch_tpu_torch.models.torch_ensemble import TorchMinHashLSHEnsemble
from datasketch_tpu_torch.models.torch_forest import TorchMinHashLSHForest
from datasketch_tpu_torch.models.torch_hnsw import TorchHNSW
from datasketch_tpu_torch.models.torch_lsh import TorchMinHashLSH
from datasketch_tpu_torch.models.weighted_minhash import (
    WeightedMinHash,
    WeightedMinHashGenerator,
)
from datasketch_tpu_torch.serving import FailoverIndex
from datasketch_tpu_torch.storage import (
    DictListStorage,
    DictSetStorage,
    ordered_storage,
    unordered_storage,
)

# the reference's aliases for MinHash LSH with WeightedMinHash
WeightedMinHashLSH = MinHashLSH
WeightedMinHashLSHForest = MinHashLSHForest

__all__ = [
    "AsyncMinHashLSH",
    "bBitMinHash",
    "device_hash",
    "DictListStorage",
    "DictSetStorage",
    "FailoverIndex",
    "HNSW",
    "HyperLogLog",
    "HyperLogLogPlusPlus",
    "LeanMinHash",
    "MinHash",
    "MinHashLSH",
    "MinHashLSHBloom",
    "MinHashLSHEnsemble",
    "MinHashLSHForest",
    "ordered_storage",
    "sha1_hash32",
    "sha1_hash64",
    "TorchBBitIndex",
    "TorchHNSW",
    "TorchMinHashLSH",
    "TorchMinHashLSHBloom",
    "TorchMinHashLSHEnsemble",
    "TorchMinHashLSHForest",
    "unordered_storage",
    "WeightedMinHash",
    "WeightedMinHashGenerator",
    "WeightedMinHashLSH",
    "WeightedMinHashLSHForest",
    "xxhash_hash32",
]
