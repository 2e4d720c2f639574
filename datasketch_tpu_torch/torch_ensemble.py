"""Convenience submodule alias: the device-resident classes live under
:mod:`datasketch_tpu_torch.models.torch_ensemble` (the port's name for the JAX
package's ``tpu_ensemble`` alias); this keeps import paths flat beside the
drop-in parity modules."""

from datasketch_tpu_torch.models.torch_ensemble import *  # noqa: F401,F403
