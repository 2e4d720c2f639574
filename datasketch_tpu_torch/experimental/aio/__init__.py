"""Deprecated alias package; see :mod:`datasketch_tpu_torch.aio`.

Parity with ``datasketch/experimental/aio/lsh.py:31-49``.
"""

from datasketch_tpu_torch.aio import AsyncMinHashLSH  # noqa: F401

__all__ = ["AsyncMinHashLSH"]
