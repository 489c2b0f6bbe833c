"""Flash attention (forward): the CUDA kernel and its plain version.

``flash_attention_kernel`` launches ``csrc/flash_attention.cu`` (hand-written
for Hopper, ``sm_90a``), which replaces the TPU kernel
``repro.kernels.flash_attention.flash_attention_kernel``: q ``(B,Hq,T,d)``
against k, v ``(B,Hkv,S,d)``, query head h reading kv head
``h // (Hq // Hkv)``, causal mask ``kpos <= qpos`` (top-left aligned, as the
TPU kernel; it equals the bottom-right ``tril(k=S-T)`` of the oracles only
when ``T == S``), float32 online softmax, output in q's dtype.  One block per
(b, q head, query tile) with the key walk in fixed order, so row b of a
batched launch is bitwise equal to a solo launch of row b.

:func:`flash_route` picks the body from (dtype, d) alone: bfloat16 at
``d % 16 == 0``, ``d <= 256`` runs on the tensor-core body
(``csrc/attention_wgmma.cuh``: wgmma, TMA), float32 at ``d % 8 == 0``,
``d <= 960`` on the 3xTF32 tensor-core body (``csrc/attention_tf32.cuh``:
mma.sync with every float32 operand split into two TF32 halves, which
keeps the 2e-5 float32 tolerance that one-pass TF32 would break), and
every other head dim on the CUDA-core body (``csrc/attention_tile.cuh``).
There is no fallback from one to another: a tensor-core call whose base
addresses or strides its 16-byte loads cannot address raises.

``flash_attention_plain`` is the same function in plain PyTorch: it serves
CPU tensors (the tests) and is the yardstick the kernel is checked against
on the card.  :func:`repro_torch.kernels.ops.flash_attention` picks by device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .common import (
    DTYPE_CODES,
    check_strided,
    check_tma,
    ptr,
    raise_on_error,
    refuse_grad,
    require_cuda,
    stream,
    stride_array,
    strides,
)

_SOURCE = "flash_attention"
NEG_INF = -1e30


ROUTES = ("wgmma", "tf32x3", "simt")
MAX_TF32_DIM = 960       # the 3xTF32 body's o column chunks and grid cover d up to here


def flash_route(dtype, d: int) -> str:
    """The body a flash forward launch runs on: ``"wgmma"`` (the bf16
    tensor-core body) for bfloat16 at a head dim that is a multiple of 16 up
    to 256, ``"tf32x3"`` (the 3xTF32 tensor-core body) for float32 at a
    multiple of 8 up to :data:`MAX_TF32_DIM`, ``"simt"`` (the CUDA-core
    body) otherwise."""
    if dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= 256:
        return "wgmma"
    if dtype == torch.float32 and d % 8 == 0 and 8 <= d <= MAX_TF32_DIM:
        return "tf32x3"
    return "simt"


def _repeat_kv(t, group: int):
    return t if group == 1 else torch.repeat_interleave(t, group, dim=1)


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Plain PyTorch flash attention (any device, float32 math)."""
    B, Hq, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    f32 = torch.float32
    kf = _repeat_kv(k.to(f32), Hq // Hkv)
    vf = _repeat_kv(v.to(f32), Hq // Hkv)
    s = torch.matmul(q.to(f32), kf.transpose(-1, -2)) * scale
    if causal:
        kpos = torch.arange(S, device=q.device)
        qpos = torch.arange(T, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = p.masked_fill(~mask, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (torch.matmul(p, vf) / denom).to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.flash_attention_fwd_wgmma.argtypes = [p] * 4 + [i] * 6 + [p, i, ctypes.c_float, p]
        lib.flash_attention_fwd_wgmma.restype = ctypes.c_int
        lib.flash_attention_fwd_tf32.argtypes = lib.flash_attention_fwd_wgmma.argtypes
        lib.flash_attention_fwd_tf32.restype = ctypes.c_int
    return lib


def flash_attention_kernel(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Launch the CUDA flash attention on ``q``'s device.

    q: (B, Hq, T, d); k, v: (B, Hkv, S, d) with Hq a multiple of Hkv; all
    of one dtype (float32 or bfloat16), on one CUDA device, each with a
    contiguous last axis (other strides are free, so transposed views need
    no copy; on the tensor-core routes, ``"wgmma"`` and ``"tf32x3"``, the
    base addresses and strides must be 16-byte multiples, or it raises).
    Returns a contiguous (B, Hq, T, d) tensor in q's dtype.  Launches on the
    current stream and does not synchronise.
    ``flash_attention_kernel.launches`` counts launches and
    ``flash_attention_kernel.launches_by_route`` counts them per
    :func:`flash_route`.
    """
    refuse_grad("flash attention", "differentiate through "
                "ops.flash_attention_trainable (FlashAttentionFn)", q, k, v)
    device = require_cuda(q, "flash attention")
    dtypes = tuple(DTYPE_CODES)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_strided(name, t, dtypes, 4, device)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k, v must be (B, Hkv, S, d) = (B={B}, Hkv, S, d={d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if B * Hq >= 2**31:
        raise ValueError(f"B*Hq = {B * Hq} exceeds the kernel's grid")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    route = flash_route(q.dtype, d)
    out = torch.empty((B, Hq, T, d), dtype=q.dtype, device=device)
    with torch.cuda.device(device):
        if route in ("wgmma", "tf32x3"):
            loads = "TMA" if route == "wgmma" else "cp.async"
            for name, t in (("q", q), ("k", k), ("v", v)):
                check_tma(name, t, loads)
            lib = _library()
            fn = lib.flash_attention_fwd_wgmma if route == "wgmma" \
                else lib.flash_attention_fwd_tf32
            err = fn(ptr(q), ptr(k), ptr(v), ptr(out), B, Hq, Hkv, T, S, d,
                     stride_array(q, k, v), int(causal), ctypes.c_float(scale),
                     stream(device))
        else:
            qs, ks, vs = strides(q), strides(k), strides(v)
            err = _library().flash_attention_fwd(
                ptr(q), ptr(k), ptr(v), ptr(out), DTYPE_CODES[q.dtype],
                B, Hq, Hkv, T, S, d, *qs[:3], *ks[:3], *vs[:3],
                int(causal), ctypes.c_float(scale), stream(device))
    raise_on_error(err, f"flash_attention ({route})")
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_by_route[route] += 1
    return out


flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
