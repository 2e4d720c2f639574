"""Convenience submodule alias: the device-resident classes live under
:mod:`datasketch_tpu_torch.models.torch_lsh` (the port's name for the JAX
package's ``tpu_lsh`` alias); this keeps import paths flat beside the
drop-in parity modules."""

from datasketch_tpu_torch.models.torch_lsh import *  # noqa: F401,F403
