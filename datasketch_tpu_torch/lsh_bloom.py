"""Drop-in submodule alias: the reference exposes ``datasketch.lsh_bloom``
(users import it directly), so ``datasketch_tpu_torch.lsh_bloom`` forwards to
:mod:`datasketch_tpu_torch.models.lsh_bloom`."""

from datasketch_tpu_torch.models.lsh_bloom import *  # noqa: F401,F403
