"""RMSNorm: the CUDA kernel and its plain version.

``rmsnorm_kernel`` launches ``csrc/rmsnorm.cu`` (hand-written for Hopper,
``sm_90a``), which replaces the TPU kernel
``repro.kernels.rmsnorm.rmsnorm_kernel``: rowwise
``f32(x) * rsqrt(mean(f32(x)^2) + eps) * f32(w)``, cast to x's dtype, over
the last axis.  It is memory-bound (x read once, out written once); see the
source for its design.  CUDA C++ rather than Triton only to share the one
``nvcc`` build path of the port's other kernels.

``rmsnorm_plain`` is the same function in plain PyTorch: it serves CPU
tensors (the tests) and is the yardstick the kernel is checked against on
the card.  :func:`repro_torch.kernels.ops.rmsnorm` picks by device.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import DTYPE_CODES, check_tensor, ptr, raise_on_error, require_cuda, stream
from .ref import rmsnorm_ref

_SOURCE = "rmsnorm"


def rmsnorm_plain(x, w, eps: float = 1e-6):
    """Plain PyTorch RMSNorm over the last axis (float32 statistics): the
    oracle's formula, kept in one place."""
    return rmsnorm_ref(x, w, eps=eps)


def _library() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.rmsnorm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def rmsnorm_kernel(x, w, eps: float = 1e-6):
    """Launch the CUDA RMSNorm on ``x``'s device.

    x: (..., D) contiguous, float32 or bfloat16; w: (D,) contiguous float32
    on the same device.  Returns a new tensor like x.  Launches on the
    current stream and does not synchronise.  ``rmsnorm_kernel.launches``
    counts launches.
    """
    device = require_cuda(x, "rmsnorm")
    if x.dim() < 1 or x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16 with a last axis, got "
                        f"{x.dtype} of shape {tuple(x.shape)}")
    D = x.shape[-1]
    check_tensor("x", x, x.dtype, x.shape, device)
    check_tensor("w", w, torch.float32, (D,), device)
    rows = x.numel() // D if D else 0
    if rows >= 2**31:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        err = _library().rmsnorm_fwd(ptr(x), ptr(w), ptr(out), rows, D,
                                     DTYPE_CODES[x.dtype], ctypes.c_float(eps),
                                     stream(device))
    raise_on_error(err, "rmsnorm")
    rmsnorm_kernel.launches += 1
    return out


rmsnorm_kernel.launches = 0
