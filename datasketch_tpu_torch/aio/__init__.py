"""Asyncio front-end: AsyncMinHashLSH over async storage backends.

Parity target: ``datasketch/aio/`` (AsyncMinHashLSH at
``aio/lsh.py:20``, async storages at ``aio/storage.py:47-70``). The port,
as the JAX package, adds an in-memory ``aiodict`` backend so the async API is usable and
testable without MongoDB/Redis services.
"""

from datasketch_tpu_torch.aio.lsh import AsyncMinHashLSH
from datasketch_tpu_torch.aio.storage import (
    async_ordered_storage,
    async_unordered_storage,
)

__all__ = ["AsyncMinHashLSH", "async_ordered_storage", "async_unordered_storage"]
