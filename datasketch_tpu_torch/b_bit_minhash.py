"""Drop-in submodule alias: the reference exposes ``datasketch.b_bit_minhash``
(users import it directly), so ``datasketch_tpu_torch.b_bit_minhash`` forwards to
:mod:`datasketch_tpu_torch.models.b_bit_minhash`."""

from datasketch_tpu_torch.models.b_bit_minhash import *  # noqa: F401,F403
