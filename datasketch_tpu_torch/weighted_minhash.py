"""Drop-in submodule alias: the reference exposes ``datasketch.weighted_minhash``
(users import it directly), so ``datasketch_tpu_torch.weighted_minhash`` forwards to
:mod:`datasketch_tpu_torch.models.weighted_minhash`."""

from datasketch_tpu_torch.models.weighted_minhash import *  # noqa: F401,F403
