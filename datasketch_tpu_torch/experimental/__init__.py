"""Deprecated forwarding shim to :mod:`datasketch_tpu_torch.aio`.

Parity with ``datasketch/experimental/__init__.py:23-49``:
the reference's async classes originally lived under ``experimental.aio``
and are lazily forwarded (PEP 562) with a deprecation warning.
"""

import warnings


def __getattr__(name):
    if name == "aio":
        warnings.warn(
            "datasketch_tpu_torch.experimental.aio is deprecated; "
            "use datasketch_tpu_torch.aio instead",
            DeprecationWarning,
            stacklevel=2,
        )
        # importlib returns the sys.modules entry directly; a plain
        # `import pkg.sub as sub` resolves via getattr on this package and
        # would recurse back into __getattr__ when `sub` is in sys.modules
        # but not yet bound as our attribute.
        import importlib

        aio = importlib.import_module("datasketch_tpu_torch.experimental.aio")
        globals()["aio"] = aio
        return aio
    raise AttributeError(name)
