"""Deprecated alias module; use :mod:`datasketch_tpu_torch.aio` instead.

Parity with ``datasketch/experimental/aio/lsh.py:31-49``:
attribute access resolves lazily (PEP 562), emits a DeprecationWarning the
first time, and caches the symbol into module globals.
"""

__all__ = [
    "AsyncMinHashLSH",
    "AsyncMinHashLSHDeleteSession",
    "AsyncMinHashLSHInsertionSession",
]


def __getattr__(name):
    if name in __all__:
        import warnings

        warnings.warn(
            "datasketch_tpu_torch.experimental.aio.lsh is deprecated; import "
            "from datasketch_tpu_torch.aio instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        import datasketch_tpu_torch.aio.lsh as _aio_lsh

        value = getattr(_aio_lsh, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
