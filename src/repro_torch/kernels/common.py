"""Argument checks and launch plumbing shared by the CUDA kernel wrappers.

A wrapper validates everything in Python before it hands raw pointers to a
kernel: the C entry points trust their arguments.
"""
from __future__ import annotations

import ctypes

import torch

# type codes of the C entry points (see csrc/attention_tile.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device``."""
    check_strided(name, t, (dtype,), len(shape), device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_strided(name, t, dtypes, ndim, device) -> None:
    """Raise unless ``t`` is an ``ndim``-d tensor on ``device`` with one of
    ``dtypes`` and a contiguous last axis (other strides are free)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel runs on {device}")
    if t.dtype not in dtypes:
        want = " or ".join(str(d) for d in dtypes)
        raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got shape {tuple(t.shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last axis, "
                         f"got strides {t.stride()}")


def strides(t) -> tuple[int, ...]:
    """Element strides, with 0 for axes of size 1 (whose stride is moot)."""
    return tuple(0 if n == 1 else s for n, s in zip(t.shape, t.stride()))


def stride_array(*ts) -> ctypes.Array:
    """The (b, h, t) element strides of each 4-d tensor, in order, as the
    ``long long`` array the attention entry points take."""
    return (ctypes.c_longlong * (3 * len(ts)))(*(s for t in ts for s in strides(t)[:3]))


def aligned16(t) -> bool:
    """Whether 16-byte loads can address ``t``: its base address and the
    byte stride of every axis but the last (contiguous) one that is longer
    than 1 are multiples of 16."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (s * size) % 16 == 0 for n, s in zip(t.shape[:-1], t.stride()[:-1]))


def check_tma(name, t, loads: str = "TMA") -> None:
    """Raise unless 16-byte loads can address ``t`` (:func:`aligned16`): a
    TMA tensor map, or the ``cp.async`` copies of the float32 tensor-core
    route, named by ``loads``."""
    if not aligned16(t):
        raise ValueError(f"{name}: the tensor-core route loads by {loads}, which needs a "
                         f"16-byte aligned base address and 16-byte multiples for strides, "
                         f"got base {t.data_ptr():#x} and strides {t.stride()} elements "
                         f"of {t.element_size()} bytes")


def records_grad(*tensors) -> bool:
    """Whether autograd records an op on these inputs."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(what: str, route: str, *tensors) -> None:
    """Raise if autograd would record this call: a kernel's output is a
    fresh tensor filled through ``ctypes`` with no ``grad_fn``, so under
    grad an input that requires grad would silently get no gradient.
    ``route`` names the differentiable way to the same function."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"the {what} kernel is forward-only: its output carries no gradient, "
            f"but an input requires grad; {route}")


def require_cuda(t, what: str) -> torch.device:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"the CUDA {what} kernel needs CUDA tensors, got {where}")
    return t.device


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
