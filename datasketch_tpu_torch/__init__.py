"""PyTorch + CUDA port of datasketch_tpu's MinHash -> LSH, LSH Ensemble,
LSH Forest, LSHBloom, weighted MinHash (CWS) and b-bit MinHash serving
paths, with the raw-text and token-id front ends, the OPH and C-MinHash
signature schemes, the per-object MinHash / LeanMinHash sketches, the
HyperLogLog / HyperLogLog++ cardinality sketches and HNSW (the device-built
graph served by ``TorchHNSW``, and the mutable host ``HNSW``).

The JAX package (``datasketch_tpu``) is the reference this package is held
against; this one imports ``torch`` and numpy only, never JAX and never
``datasketch_tpu`` (whose ``__init__`` imports JAX).

Device choice is explicit: public entry points take ``device=`` (default
``"cuda"``). ``device="cuda"`` without an sm_90+ card raises; it never
falls back to the CPU. ``device="cpu"`` runs the plain PyTorch twins of the
hand-written Hopper kernels (``datasketch_tpu_torch.kernels``).

Importing this package creates no CUDA context and builds nothing: the
kernels compile with ``nvcc`` at first use on the card.
"""

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
from datasketch_tpu_torch.models.lsh_bloom import MinHashLSHBloom, TorchMinHashLSHBloom
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

WeightedMinHashLSHForest = MinHashLSHForest  # the reference's alias

__all__ = [
    "bBitMinHash",
    "device_hash",
    "HNSW",
    "HyperLogLog",
    "HyperLogLogPlusPlus",
    "LeanMinHash",
    "MinHash",
    "MinHashLSHBloom",
    "MinHashLSHForest",
    "sha1_hash32",
    "sha1_hash64",
    "TorchBBitIndex",
    "TorchHNSW",
    "TorchMinHashLSH",
    "TorchMinHashLSHBloom",
    "TorchMinHashLSHEnsemble",
    "TorchMinHashLSHForest",
    "WeightedMinHash",
    "WeightedMinHashGenerator",
    "WeightedMinHashLSHForest",
    "xxhash_hash32",
]
