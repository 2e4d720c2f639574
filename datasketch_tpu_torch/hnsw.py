"""Drop-in submodule alias: the reference exposes ``datasketch.hnsw``
(users import it directly), so ``datasketch_tpu_torch.hnsw`` forwards to
:mod:`datasketch_tpu_torch.models.hnsw`."""

from datasketch_tpu_torch.models.hnsw import *  # noqa: F401,F403
