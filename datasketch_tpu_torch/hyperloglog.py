"""Drop-in submodule alias: the reference exposes ``datasketch.hyperloglog``
(users import it directly), so ``datasketch_tpu_torch.hyperloglog`` forwards to
:mod:`datasketch_tpu_torch.models.hyperloglog`."""

from datasketch_tpu_torch.models.hyperloglog import *  # noqa: F401,F403
