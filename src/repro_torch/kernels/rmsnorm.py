"""RMSNorm: the CUDA kernel and its plain version.

``rmsnorm_kernel`` launches ``csrc/rmsnorm.cu`` (hand-written for Hopper,
``sm_90a``), which replaces the TPU kernel
``repro.kernels.rmsnorm.rmsnorm_kernel``: rowwise
``f32(x) * rsqrt(mean(f32(x)^2) + eps) * f32(w)``, cast to x's dtype, over
the last axis.  It is memory-bound (x read once, out written once); see the
source for its design.  CUDA C++ rather than Triton only to share the one
``nvcc`` build path of the port's other kernels.  Two bodies, picked by
:func:`rmsnorm_route` from D and the pointers' alignment: ``"vec"`` (one to
eight warps per row, the row held in registers, 16-byte loads) where D is a
multiple of 16 bytes' worth of elements and x, w are 16-byte aligned;
``"scalar"`` (a block per row, scalar loads) for an odd D or an offset view.

``rmsnorm_plain`` is the same function in plain PyTorch: it serves CPU
tensors (the tests) and is the yardstick the kernel is checked against on
the card.  :func:`repro_torch.kernels.ops.rmsnorm` picks by device.

``RMSNormFn`` is the differentiable RMSNorm of training.  Its forward is the
kernel on the card and ``rmsnorm_plain`` on the CPU; its backward is the
closed-form gradient in float32 PyTorch ops,
``dx = rstd * (g*w - x_hat * mean(g*w*x_hat))`` and ``dw = sum(g * x_hat)``.
The reference package has no RMSNorm backward kernel (XLA differentiates
``models/layers.py:rmsnorm`` there), so the port has none either.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, fake
from .common import (
    DTYPE_CODES,
    check_tensor,
    ptr,
    raise_on_error,
    refuse_grad,
    require_cuda,
    stream,
)
from .fake import shape_only
from .ref import rmsnorm_ref

_SOURCE = "rmsnorm"
ROUTES = ("vec", "scalar")
MAX_VEC_VECTORS = 8 * 32 * 4     # 16-byte vectors of a row the vec body holds in a block


def rmsnorm_route(x, w) -> str:
    """The body a launch on ``x`` (rows, D) and ``w`` (D,) runs on:
    ``"vec"`` where D is a multiple of 16 bytes' worth of x's elements (8
    bf16, 4 float32), at most :data:`MAX_VEC_VECTORS` such vectors, and x
    and w start at 16-byte aligned addresses; ``"scalar"`` otherwise."""
    per = 16 // x.element_size()
    D = x.shape[-1]
    if D % per or not 0 < D // per <= MAX_VEC_VECTORS:
        return "scalar"
    return "vec" if x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 else "scalar"


def rmsnorm_plain(x, w, eps: float = 1e-6):
    """Plain PyTorch RMSNorm over the last axis (float32 statistics): the
    oracle's formula, kept in one place."""
    return rmsnorm_ref(x, w, eps=eps)


def _library() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.rmsnorm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def rmsnorm_kernel(x, w, eps: float = 1e-6):
    """Launch the CUDA RMSNorm on ``x``'s device.

    x: (..., D) contiguous, float32 or bfloat16; w: (D,) contiguous float32
    on the same device.  Returns a new tensor like x.  Launches on the
    current stream and does not synchronise.  ``rmsnorm_kernel.launches``
    counts launches and ``rmsnorm_kernel.launches_by_route`` counts them per
    :func:`rmsnorm_route`.
    """
    refuse_grad("rmsnorm", "differentiate through ops.rmsnorm_trainable (RMSNormFn)",
                x, w)
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
    out = torch.empty_like(x)          # a fresh allocation: 16-byte aligned
    route = rmsnorm_route(x, w)
    with torch.cuda.device(device):
        err = _library().rmsnorm_fwd(ptr(x), ptr(w), ptr(out), rows, D,
                                     DTYPE_CODES[x.dtype], ctypes.c_float(eps),
                                     int(route == "vec"), stream(device))
    raise_on_error(err, f"rmsnorm ({route})")
    rmsnorm_kernel.launches += 1
    rmsnorm_kernel.launches_by_route[route] += 1
    return out


rmsnorm_kernel.launches = 0
rmsnorm_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


class RMSNormFn(torch.autograd.Function):
    """Differentiable RMSNorm over the last axis: x (..., D) in float32 or
    bfloat16, w (D,) float32; gradients in their dtypes."""

    @staticmethod
    def forward(ctx, x, w, eps):
        if shape_only(x):
            y = fake.rmsnorm(x, w, eps)
        else:
            y = rmsnorm_plain(x, w, eps) if x.device.type == "cpu" else rmsnorm_kernel(x, w, eps)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        f32 = torch.float32
        xf, gf = x.to(f32), g.to(f32)
        rstd = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + ctx.eps)
        x_hat = xf * rstd
        gw = gf * w.to(f32)
        dx = rstd * (gw - x_hat * torch.mean(gw * x_hat, dim=-1, keepdim=True))
        dw = (gf * x_hat).reshape(-1, x.shape[-1]).sum(dim=0)
        return dx.to(x.dtype), dw.to(w.dtype), None
