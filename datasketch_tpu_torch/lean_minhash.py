"""Drop-in submodule alias: the reference exposes ``datasketch.lean_minhash``
(users import it directly), so ``datasketch_tpu_torch.lean_minhash`` forwards to
:mod:`datasketch_tpu_torch.models.lean_minhash`."""

from datasketch_tpu_torch.models.lean_minhash import *  # noqa: F401,F403
