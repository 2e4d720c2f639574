"""Explicit device selection and the uint32-in-int32 tensor conventions.

Signatures live in ``torch.int32`` tensors holding uint32 bit patterns:
scoring only compares them for equality, and the host views them as
``np.uint32`` at the boundary. Values that are ordered or shifted (band
fingerprints, the permutation intermediates) are held in int64 as
0..2**32-1, because torch has no ``>>``, ``min`` or compare for
``torch.uint32`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "resolve_device",
    "u32_bits",
    "u32_values",
    "u32_to_i32",
    "to_numpy_u32",
    "as_sig_tensor",
    "upload_bits",
    "inv_width",
    "counts_to_scores",
]

LOW32 = 0xFFFFFFFF


def resolve_device(device="cuda") -> torch.device:
    """Validate ``device``: ``"cpu"``, or a CUDA card of capability >= 9.0.

    Raises RuntimeError for ``"cuda"`` on a machine without a usable card;
    there is no silent fallback to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError("device must be 'cpu' or 'cuda', got %r" % (device,))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device=%r requested but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path" % (str(device),)
        )
    cap = torch.cuda.get_device_capability(dev)
    if cap < (9, 0):
        raise RuntimeError(
            "the CUDA kernels target sm_90a (Hopper); %s has capability "
            "%d.%d" % (torch.cuda.get_device_name(dev), cap[0], cap[1])
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor of uint32 bit patterns -> int64 values 0..2**32-1."""
    return x.to(torch.int64) & LOW32


def u32_values(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor of uint32 values -> int64 0..2**32-1: uint8 and
    uint16 zero-extend, int32 / uint32 are read as bit patterns, int64 is
    masked to its low 32 bits."""
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & LOW32


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values 0..2**32-1 -> int32 tensor of the same bit patterns."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def inv_width(p: int) -> float:
    """f32(1 / p) as a Python float (exactly representable in f32)."""
    return float(np.float32(1.0) / np.float32(p))


def counts_to_scores(counts: torch.Tensor, p: int) -> torch.Tensor:
    """f32 Jaccard estimates of equal-slot counts: ``f32(count) * f32(1/p)``.

    That is the JAX package's rounding (its f32 mean and its score kernels
    multiply by the reciprocal); it equals ``count / p`` exactly when p is
    a power of two. The CUDA kernels compute the same product.
    """
    return counts.to(torch.float32) * inv_width(p)


def to_numpy_u32(x: torch.Tensor) -> np.ndarray:
    """int32 signature tensor (any device) -> host ``np.uint32`` array."""
    return x.detach().cpu().numpy().view(np.uint32)


def as_sig_tensor(x, device: torch.device) -> torch.Tensor:
    """uint32 matrix (numpy or int32-bits tensor) -> contiguous int32 tensor
    on ``device``."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        elif x.dtype != torch.int32:
            raise TypeError("signature tensors must be int32 (uint32 bits)")
        return x.to(device).contiguous()
    arr = np.asarray(x)
    if arr.dtype != np.uint32:
        arr = arr.astype(np.uint64).astype(np.uint32)
    arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr.view(np.int32)).to(device)


def upload_bits(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> contiguous tensor on ``device``; uint32 and uint64
    arrays go up as int32 / int64 bit patterns (uint8 and uint16 as they
    are)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    elif arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    return torch.from_numpy(arr).to(device)
