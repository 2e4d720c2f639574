"""Drop-in submodule alias: the reference exposes ``datasketch.minhash``
(users import it directly), so ``datasketch_tpu_torch.minhash`` forwards to
:mod:`datasketch_tpu_torch.models.minhash`."""

from datasketch_tpu_torch.models.minhash import *  # noqa: F401,F403
