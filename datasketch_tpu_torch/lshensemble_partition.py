"""Drop-in submodule alias: the reference exposes
``datasketch.lshensemble_partition.optimal_partitions`` as its own
importable module; forward to the vectorized implementation in
:mod:`datasketch_tpu_torch.models.lshensemble`."""

from datasketch_tpu_torch.models.lshensemble import (  # noqa: F401
    _best_partitions,
    _nfps_matrix,
    optimal_partitions,
)
