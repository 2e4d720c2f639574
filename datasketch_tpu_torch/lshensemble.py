"""Drop-in submodule alias: the reference exposes ``datasketch.lshensemble``
(users import it directly), so ``datasketch_tpu_torch.lshensemble`` forwards to
:mod:`datasketch_tpu_torch.models.lshensemble`."""

from datasketch_tpu_torch.models.lshensemble import *  # noqa: F401,F403
