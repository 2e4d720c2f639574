"""Host token hashing (SHA1 low 32 / 64 bits, XXH32) and the fused HLL
register scatter: the JAX package's C++ extension, built for the port.

The source is compiled by path (``datasketch_tpu/native/src/
dshash_module.cpp`` + ``dshash_core.h``) with the flags of
``datasketch_tpu/native/corpus.py`` into the port's git-ignored build
directory and loaded with ``importlib``; ``datasketch_tpu.native`` itself
is never imported (the JAX package's ``__init__`` imports JAX). The
module is named by a hash of its sources, so a source change rebuilds it.
If the build fails this raises: there is no slow path.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading

import numpy as np

from datasketch_tpu_torch.kernels.build import BUILD_DIR

__all__ = [
    "ALGO_SHA1_32",
    "ALGO_XXH32",
    "ALGO_SHA1_64",
    "load",
    "hash_flat",
    "hash_ragged",
    "hash_shingles_padded",
    "hll_scatter",
]

# the extension's algorithm codes (``datasketch_tpu/native/corpus.py``)
ALGO_SHA1_32 = 0
ALGO_XXH32 = 1  # XXH32, seed 0
ALGO_SHA1_64 = 2  # SHA1 low 64 bits, little-endian; uint64 output

_SRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "datasketch_tpu", "native", "src",
)
_SRC = os.path.join(_SRC_DIR, "dshash_module.cpp")
_HDR = os.path.join(_SRC_DIR, "dshash_core.h")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_mod = None


def _build() -> str:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in (_SRC, _HDR):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(BUILD_DIR, "dshash_%s%s" % (digest.hexdigest()[:16], suffix))
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp.%d" % (out, os.getpid())
    include = sysconfig.get_paths()["include"]
    cmd = ["g++", *_FLAGS, "-I", include, _SRC, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "g++ failed to build the host SHA1 module (%d):\n%s"
            % (proc.returncode, proc.stdout + proc.stderr)
        )
    os.replace(tmp, out)
    return out


def load():
    """The ``_dshash`` extension module, built on first call (thread-safe)."""
    global _mod
    if _mod is not None:
        return _mod
    with _lock:
        if _mod is None:
            spec = importlib.util.spec_from_file_location("_dshash", _build())
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _mod = mod
    return _mod


def _dtype(algo: int):
    return np.uint64 if algo == ALGO_SHA1_64 else np.uint32


def hash_flat(tokens, algo: int = ALGO_SHA1_32) -> np.ndarray:
    """Hash of every bytes token of ``tokens``: uint32[n] (uint64[n] for
    ``ALGO_SHA1_64``)."""
    out = np.empty(len(tokens), dtype=_dtype(algo))
    load().hash_flat(tokens, out, algo, 0)
    return out


def hash_ragged(docs, out: np.ndarray = None, algo: int = ALGO_SHA1_32):
    """Hash of every token of ``docs`` (lists of bytes), back to back.

    Args:
        docs: sequence of token sequences.
        out: optional writable uint32 buffer of at least the total token
            count (e.g. the numpy view of a pinned tensor); allocated when
            None.
        algo: ``ALGO_SHA1_32`` or ``ALGO_XXH32``.

    Returns:
        (flat uint32[total] -- a view of ``out`` when given, lengths int32[B]).
    """
    n = len(docs)
    lengths = (
        np.fromiter(map(len, docs), np.int32, count=n) if n else np.zeros(0, np.int32)
    )
    starts = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(lengths[:-1], dtype=np.int64, out=starts[1:])
    total = int(lengths.sum())
    if out is None:
        out = np.empty(total, dtype=np.uint32)
    elif out.dtype != np.uint32 or out.shape[0] < total:
        raise ValueError("out must be uint32 with room for %d tokens" % total)
    flat = out[:total]
    load().hash_ragged(docs, flat, starts, algo, 0)
    return flat, lengths


def hash_shingles_padded(texts, k: int, out: np.ndarray, algo: int = ALGO_SHA1_32):
    """Hash of every overlapping k-byte shingle of each text, hashed in C
    straight out of the text buffers (the JAX package's
    ``corpus.hash_shingles_padded`` without its padding to a multiple).

    Args:
        texts: sequence of bytes-like texts.
        k: shingle width in bytes.
        out: writable uint32 buffer of at least ``B * T`` slots (e.g. the
            numpy view of a pinned tensor).
        algo: ``ALGO_SHA1_32`` or ``ALGO_XXH32``.

    Returns:
        (hashes uint32[B, T] -- a view of ``out``, lengths
        int32[B]): row d holds text d's ``max(0, len - k + 1)`` shingle
        hashes; T is the largest such count (at least 1), and the slots
        past a row's length are left as they were.
    """
    n = len(texts)
    lengths = np.fromiter((max(0, len(t) - k + 1) for t in texts), np.int32, count=n)
    t = max(1, int(lengths.max()) if n else 1)
    if out.dtype != np.uint32 or out.size < n * t:
        raise ValueError("out must be uint32 with room for %d slots" % (n * t))
    hashes = out.reshape(-1)[: n * t].reshape(n, t)
    load().hash_shingles(texts, hashes, t, k, algo, 0)
    return hashes, lengths


def hll_scatter(regs: np.ndarray, hv: np.ndarray, lengths: np.ndarray, p: int,
                max_rank: int) -> int:
    """Fused HLL register scatter-max over a flat hashed corpus (the JAX
    package's ``corpus.hll_scatter``): for doc d's hash h,
    ``regs[d * 2**p + (h & (2**p - 1))]`` takes the max with
    ``max_rank - bit_length(h >> p) + 1``.

    Args:
        regs: int8[n_docs * 2**p], flat, C-contiguous and writable.
        hv: uint64 hashes, all docs back to back.
        lengths: int64[n_docs] tokens per doc (they must sum to ``hv.size``).

    Returns the least rank seen; callers raise the hash-overflow
    ``ValueError`` when it is <= 0 (the registers may then be partly
    written and must be discarded).
    """
    return load().hll_scatter(regs, hv, lengths, int(p), int(max_rank))
