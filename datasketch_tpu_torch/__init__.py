"""PyTorch + CUDA port of datasketch_tpu's MinHash -> LSH, LSH Ensemble,
weighted MinHash (CWS) and b-bit MinHash serving paths, with the raw-text
and token-id front ends.

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

from datasketch_tpu_torch.models.b_bit_minhash import bBitMinHash
from datasketch_tpu_torch.models.minhash import MinHash
from datasketch_tpu_torch.models.torch_bbit import TorchBBitIndex
from datasketch_tpu_torch.models.torch_ensemble import TorchMinHashLSHEnsemble
from datasketch_tpu_torch.models.torch_lsh import TorchMinHashLSH
from datasketch_tpu_torch.models.weighted_minhash import (
    WeightedMinHash,
    WeightedMinHashGenerator,
)

__all__ = [
    "bBitMinHash",
    "MinHash",
    "TorchBBitIndex",
    "TorchMinHashLSH",
    "TorchMinHashLSHEnsemble",
    "WeightedMinHash",
    "WeightedMinHashGenerator",
]
