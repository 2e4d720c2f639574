"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

``nvcc`` compiles every source into ONE shared library with a plain C
interface, loaded with ctypes: seconds per build, where a PyTorch C++
extension (which includes torch's headers) takes minutes. The library is
built at first use into ``datasketch_tpu_torch/_build/`` (git-ignored),
named by a hash of the sources and flags, so a fresh checkout builds
everything from the repo's sources and a stale build is never loaded.

No ``--use_fast_math``: scores are ``f32(count) * f32(1/P)`` with the
reciprocal correctly rounded, bit for bit the reference's, the
containment score's division is IEEE, and the CWS kernels need the IEEE
division and the accurate ``logf``; fast math would approximate all of
them.

Every C entry point takes its pointers and the CUDA stream as
``void*``, launches on that stream (the caller passes torch's current
stream), and returns ``cudaGetLastError()``; :func:`check` raises when it
is not 0. A kernel that cannot be built or launched raises
:class:`KernelError`, which callers must not take for a bad card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

__all__ = [
    "library", "check", "require_cuda", "stream_ptr", "num_sms", "BUILD_DIR",
    "CSRC_DIR",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points in csrc/*.cu (all return cudaError_t).
_SIGNATURES = {
    "ds_minhash_sign": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "ds_score_matrix": [_P, _P, _I, _L, _I, _I, _L, _P, _P],
    "ds_score_blocks_per_sm": [_I, _P],
    "ds_rerank": [_P, _P, _P, _L, _I, _I, _I, _P, _P],
    "ds_topk_scan": [_P, _P, _P, _P, _P, _I, _L, _I, _L, _I, _F, _I, _I, _L, _P, _P, _P, _P],
    "ds_topk_scan_blocks_per_sm": [_I, _I, _P],
    "ds_topk_merge": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "ds_cws_dense": [_P, _P, _P, _P, _L, _I, _I, _I, _P, _P],
    "ds_cws_sparse": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _P, _P],
    "ds_bbit_counts": [_P, _P, _I, _L, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output (ptxas register/spill report) of the library's build


def _sources():
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


class KernelError(RuntimeError):
    """A kernel failed to build, to fit on an SM or to launch: a fault of
    the program, not of the card."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels are compiled from datasketch_tpu_torch/csrc at first use"
    )


def _build() -> str:
    global build_log
    srcs = _sources()
    digest = hashlib.sha256()
    for path in srcs:
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0" + fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, "libds_kernels_%s.so" % digest.hexdigest()[:16])
    if os.path.exists(out):
        if os.path.exists(out + ".log"):
            with open(out + ".log") as fh:
                build_log = fh.read()
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp.%d" % (out, os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp] + [s for s in srcs if s.endswith(".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelError("nvcc failed (%d):\n%s" % (proc.returncode, build_log))
    with open(out + ".log", "w") as fh:
        fh.write(build_log)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise KernelError("%s failed: CUDA error %d" % (name, err))


def stream_ptr(t: torch.Tensor) -> int:
    """Raw handle of torch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def num_sms(t: torch.Tensor) -> int:
    """Streaming multiprocessors of ``t``'s card."""
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel-side argument check: every tensor on one CUDA device and
    contiguous. Wrappers call it only after routing CPU tensors to the
    plain version, so anything else here is a caller error."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                "%s: tensors must all lie on one CUDA device (or all on the "
                "CPU for the plain version); got %s" % (name, t.device)
            )
        if not t.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % name)
