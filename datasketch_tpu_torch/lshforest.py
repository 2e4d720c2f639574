"""Drop-in submodule alias: the reference exposes ``datasketch.lshforest``
(users import it directly), so ``datasketch_tpu_torch.lshforest`` forwards to
:mod:`datasketch_tpu_torch.models.lshforest`."""

from datasketch_tpu_torch.models.lshforest import *  # noqa: F401,F403
