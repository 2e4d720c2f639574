"""Drop-in submodule alias: the reference exposes ``datasketch.lsh``
(users import it directly), so ``datasketch_tpu_torch.lsh`` forwards to
:mod:`datasketch_tpu_torch.models.lsh`."""

from datasketch_tpu_torch.models.lsh import *  # noqa: F401,F403
