""".npz persistence helpers, copied from ``datasketch_tpu/persist.py``.

Indexes persist as in the JAX package, so a checkpoint written by either
package loads in the other: arrays go into an ``.npz`` (``np.savez``
appends the suffix on write), arbitrary key objects ride along as ONE
pickled byte payload. A ``np.asarray(keys, dtype=object)`` would flatten
tuple keys into 2-D object arrays that load back as unhashable ndarrays,
and a load that forgets the suffix fixup would raise FileNotFoundError
for every path ``save`` accepted.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = ["npz_path", "pack_keys", "unpack_keys", "atomic_savez"]


def atomic_savez(path, **arrays) -> None:
    """``np.savez_compressed`` with crash-safe semantics: write to a
    temporary sibling, fsync, then ``os.replace`` onto the final path —
    a failure mid-write can never leave a torn checkpoint where a good
    one used to be (serving restarts reload these files).
    """
    import tempfile

    final = npz_path(path)
    # unique temp per CALL (mkstemp), not per process: two threads saving
    # the same path must not interleave bytes into one temp file
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(final) + ".tmp-",
        dir=os.path.dirname(final) or ".",
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):  # pragma: no cover - only on failure
            os.unlink(tmp)


def npz_path(path) -> str:
    """The on-disk path for `path`: np.savez appended '.npz' on write."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def pack_keys(obj) -> np.ndarray:
    """Arbitrary (picklable) key structure -> uint8 payload array."""
    return np.frombuffer(pickle.dumps(obj), dtype=np.uint8)


def unpack_keys(arr: np.ndarray):
    """Inverse of :func:`pack_keys`.

    SECURITY: this is a pickle payload — only load index files you
    created or trust.
    """
    return pickle.loads(arr.tobytes())
