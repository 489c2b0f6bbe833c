"""Trainable flash attention: three CUDA kernels, their plain versions, and
the autograd function that joins them.

The port of ``repro.kernels.flash_attention_bwd``.  ``csrc/flash_attention_bwd.cu``
(hand-written for Hopper, ``sm_90a``) holds one kernel for each TPU kernel
there:

* ``flash_attention_fwd_stats_kernel`` replaces ``_fwd_stats_kernel``: the
  online-softmax forward that also writes, per query row, the running max
  ``m`` and the clamped denominator ``l = max(l, 1e-30)`` (float32,
  ``(B,Hq,T)``), o in q's dtype.  Like the flash forward it runs on the
  tensor-core body (``csrc/attention_wgmma.cuh``) or the CUDA-core one by
  :func:`~repro_torch.kernels.flash_attention.flash_route`;
* ``flash_attention_dq_kernel`` replaces ``_dq_kernel``:
  ``dQ = sum_k dS K * scale`` with ``dS = p * (dO V^T - delta)`` and
  ``p = exp(s - m) / l``, the keys walked inside the block;
* ``flash_attention_dkv_kernel`` replaces ``_dkv_kernel``:
  ``dV = sum_q p^T dO`` and ``dK = sum_q dS^T Q * scale``, one block per
  (b, kv head, key tile) walking the group's g query heads and their query
  tiles.  The TPU wrapper repeats k and v to Hq heads and sums the per-head
  partials afterwards; the kernel reads kv head ``h // g`` through strides
  and sums the group in float32, rounding once.

dQ and dK/dV run on the tensor-core bodies (``csrc/attention_wgmma_bwd.cuh``:
wgmma products, tiles by TMA; p and dS rounded to bf16 before the products
they feed) or the CUDA-core ones by :func:`flash_bwd_route`: bfloat16 at
``d % 16 == 0``, ``16 <= d <= 128`` (every training launch of the dense
family) takes the first; float32, whose 2e-4 tolerance rules out bf16
products, and other d the second.

q ``(B,Hq,T,d)`` against k, v ``(B,Hkv,S,d)``; causal mask ``kpos <= qpos``
(top-left aligned); ``scale = 1/sqrt(d)``; float32 or bfloat16 with float32
sums; any T and S (a short last tile is masked: the TPU wrapper needs
``T % bq == 0``); d up to :data:`MAX_HEAD_DIM`.  ``delta = sum(dO * O)`` per
row is one float32 PyTorch expression in :class:`FlashAttentionFn`, as it is
outside any Pallas kernel in the reference.

Beside each kernel, its plain PyTorch version: it serves CPU tensors (the
tests) and is the yardstick the kernel is checked against on the card.
:class:`FlashAttentionFn` picks the three functions by the tensors' device;
a CUDA tensor launches the kernels or raises, with no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .common import (
    DTYPE_CODES,
    check_strided,
    check_tensor,
    check_tma,
    ptr,
    raise_on_error,
    refuse_grad,
    require_cuda,
    stream,
    stride_array,
)
from .flash_attention import NEG_INF, ROUTES, flash_route

_SOURCE = "flash_attention_bwd"
MAX_HEAD_DIM = 256    # the dq and dkv tiles fit shared memory up to here
MAX_WGMMA_BWD_DIM = 128   # dK and dV accumulators fit a warpgroup's registers up to here


def flash_bwd_route(dtype, d: int) -> str:
    """The body a dQ or dK/dV launch runs on: ``"wgmma"`` (the tensor-core
    body) for bfloat16 at a head dim that is a multiple of 16 from 16 to
    :data:`MAX_WGMMA_BWD_DIM`, ``"simt"`` (the CUDA-core body) otherwise."""
    return flash_route(dtype, d) if d <= MAX_WGMMA_BWD_DIM else "simt"


def _scale(d: int, scale: float | None) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _expand(t, Hq: int):
    Hkv = t.shape[1]
    return t if Hq == Hkv else torch.repeat_interleave(t, Hq // Hkv, dim=1)


def _scores(q, k, causal: bool, scale: float):
    """float32 s (B,Hq,T,S) with kv heads expanded, and the visibility mask
    (None when not causal)."""
    T, S = q.shape[2], k.shape[2]
    s = torch.matmul(q.to(torch.float32),
                     _expand(k.to(torch.float32), q.shape[1]).transpose(-1, -2)) * scale
    if not causal:
        return s, None
    mask = (torch.arange(S, device=q.device)[None, :]
            <= torch.arange(T, device=q.device)[:, None])
    return s.masked_fill(~mask, NEG_INF), mask


def _probs(q, k, m, l, causal: bool, scale: float):
    """p = exp(s - m) / l on the visible pairs, zero elsewhere (float32)."""
    s, mask = _scores(q, k, causal, scale)
    p = torch.exp(s - m[..., None]) / l[..., None]
    return p if mask is None else p.masked_fill(~mask, 0.0)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def flash_attention_fwd_stats_plain(q, k, v, *, causal: bool = True,
                                    scale: float | None = None):
    """Plain PyTorch forward with statistics: (o in q's dtype, m, l float32
    (B,Hq,T)), l clamped at 1e-30 (any device, float32 math)."""
    scale = _scale(q.shape[-1], scale)
    s, mask = _scores(q, k, causal, scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.matmul(p, _expand(v.to(torch.float32), q.shape[1])) / l[..., None]
    return o.to(q.dtype), m, l


def flash_attention_dq_plain(q, k, v, do, m, l, delta, *, causal: bool = True,
                             scale: float | None = None):
    """Plain PyTorch dQ (B,Hq,T,d) in q's dtype (any device, float32 math)."""
    scale = _scale(q.shape[-1], scale)
    f32 = torch.float32
    p = _probs(q, k, m, l, causal, scale)
    dp = torch.matmul(do.to(f32), _expand(v.to(f32), q.shape[1]).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    return (torch.matmul(ds, _expand(k.to(f32), q.shape[1])) * scale).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, m, l, delta, *, causal: bool = True,
                              scale: float | None = None):
    """Plain PyTorch (dK, dV), each (B,Hkv,S,d) in k's dtype: the g query
    heads of a kv head summed in float32 (any device)."""
    scale = _scale(q.shape[-1], scale)
    f32 = torch.float32
    B, Hq = q.shape[:2]
    Hkv, S, d = k.shape[1:]
    p = _probs(q, k, m, l, causal, scale)
    dof = do.to(f32)
    dp = torch.matmul(dof, _expand(v.to(f32), Hq).transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)                         # (B,Hq,S,d)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(f32)) * scale
    g = Hq // Hkv
    dk = dk.reshape(B, Hkv, g, S, d).sum(dim=2)
    dv = dv.reshape(B, Hkv, g, S, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(k.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if lib.flash_attention_fwd_stats.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd_stats.argtypes = [p] * 6 + [i] * 7 + [p, i, f, p]
        lib.flash_attention_dq.argtypes = [p] * 8 + [i] * 7 + [p, i, f, p]
        lib.flash_attention_dkv.argtypes = [p] * 9 + [i] * 7 + [p, i, f, p]
        lib.flash_attention_fwd_stats_wgmma.argtypes = [p] * 6 + [i] * 6 + [p, i, f, p]
        lib.flash_attention_dq_wgmma.argtypes = [p] * 8 + [i] * 6 + [p, i, f, p]
        lib.flash_attention_dkv_wgmma.argtypes = [p] * 9 + [i] * 6 + [p, i, f, p]
        for fn in (lib.flash_attention_fwd_stats, lib.flash_attention_dq,
                   lib.flash_attention_dkv, lib.flash_attention_fwd_stats_wgmma,
                   lib.flash_attention_dq_wgmma, lib.flash_attention_dkv_wgmma):
            fn.restype = ctypes.c_int
    return lib


def _check_qkv(q, k, v, what: str):
    """Validate q, k, v; returns (device, B, Hq, Hkv, T, S, d)."""
    device = require_cuda(q, what)
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
    if S < 1:
        raise ValueError("k and v need at least one key row")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernels' {MAX_HEAD_DIM}")
    if B * max(Hq, 1) >= 2**31:
        raise ValueError(f"B*Hq = {B * Hq} exceeds the kernels' grid")
    return device, B, Hq, Hkv, T, S, d


def _check_tma(*tensors):
    for name, t in zip(("q", "k", "v", "do"), tensors):
        check_tma(name, t)


def _check_bwd(q, k, v, do, m, l, delta):
    device, B, Hq, Hkv, T, S, d = _check_qkv(q, k, v, "flash attention backward")
    check_strided("do", do, (q.dtype,), 4, device)
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do must have q's shape {tuple(q.shape)}, got {tuple(do.shape)}")
    for name, t in (("m", m), ("l", l), ("delta", delta)):
        check_tensor(name, t, torch.float32, (B, Hq, T), device)
    return device, B, Hq, Hkv, T, S, d


def flash_attention_fwd_stats_kernel(q, k, v, *, causal: bool = True,
                                     scale: float | None = None):
    """Launch the CUDA forward with statistics on ``q``'s device.

    q: (B, Hq, T, d); k, v: (B, Hkv, S, d) with Hq a multiple of Hkv; one
    dtype (float32 or bfloat16), one CUDA device, each with a contiguous
    last axis (other strides are free; on the ``"wgmma"`` route the base
    addresses and strides must be 16-byte multiples, or it raises).  Returns
    (o, m, l): o contiguous (B, Hq, T, d) in q's dtype, m and l contiguous
    (B, Hq, T) float32.  Launches on the current stream and does not
    synchronise; ``flash_attention_fwd_stats_kernel.launches`` counts
    launches, ``.launches_by_route`` counts them per ``flash_route``.
    """
    refuse_grad("flash attention forward-with-stats", "differentiate through "
                "ops.flash_attention_trainable (FlashAttentionFn)", q, k, v)
    device, B, Hq, Hkv, T, S, d = _check_qkv(q, k, v, "flash attention forward-with-stats")
    o = torch.empty((B, Hq, T, d), dtype=q.dtype, device=device)
    m = torch.empty((B, Hq, T), dtype=torch.float32, device=device)
    l = torch.empty((B, Hq, T), dtype=torch.float32, device=device)
    route = flash_route(q.dtype, d)
    with torch.cuda.device(device):
        if route == "wgmma":
            _check_tma(q, k, v)
            err = _library().flash_attention_fwd_stats_wgmma(
                ptr(q), ptr(k), ptr(v), ptr(o), ptr(m), ptr(l), B, Hq, Hkv, T, S, d,
                stride_array(q, k, v), int(causal), ctypes.c_float(_scale(d, scale)),
                stream(device))
        else:
            err = _library().flash_attention_fwd_stats(
                ptr(q), ptr(k), ptr(v), ptr(o), ptr(m), ptr(l), DTYPE_CODES[q.dtype],
                B, Hq, Hkv, T, S, d, stride_array(q, k, v), int(causal),
                ctypes.c_float(_scale(d, scale)), stream(device))
    raise_on_error(err, f"flash_attention_fwd_stats ({route})")
    flash_attention_fwd_stats_kernel.launches += 1
    flash_attention_fwd_stats_kernel.launches_by_route[route] += 1
    return o, m, l


def flash_attention_dq_kernel(q, k, v, do, m, l, delta, *, causal: bool = True,
                              scale: float | None = None):
    """Launch the CUDA dQ kernel on ``q``'s device.

    q, k, v as for the forward; do like q (same dtype, contiguous last
    axis; on the ``"wgmma"`` route q, k, v and do must have 16-byte aligned
    base addresses and strides, or it raises); m, l, delta contiguous
    (B, Hq, T) float32.  Returns dQ, contiguous (B, Hq, T, d) in q's dtype.
    Launches on the current stream; ``flash_attention_dq_kernel.launches``
    counts launches, ``.launches_by_route`` counts them per
    :func:`flash_bwd_route`.
    """
    refuse_grad("flash attention dQ", "second derivatives are not supported", q, k, v, do)
    device, B, Hq, Hkv, T, S, d = _check_bwd(q, k, v, do, m, l, delta)
    dq = torch.empty((B, Hq, T, d), dtype=q.dtype, device=device)
    route = flash_bwd_route(q.dtype, d)
    args = (ptr(q), ptr(k), ptr(v), ptr(do), ptr(m), ptr(l), ptr(delta), ptr(dq))
    tail = (B, Hq, Hkv, T, S, d, stride_array(q, k, v, do), int(causal),
            ctypes.c_float(_scale(d, scale)), stream(device))
    with torch.cuda.device(device):
        if route == "wgmma":
            _check_tma(q, k, v, do)
            err = _library().flash_attention_dq_wgmma(*args, *tail)
        else:
            err = _library().flash_attention_dq(*args, DTYPE_CODES[q.dtype], *tail)
    raise_on_error(err, f"flash_attention_dq ({route})")
    flash_attention_dq_kernel.launches += 1
    flash_attention_dq_kernel.launches_by_route[route] += 1
    return dq


def flash_attention_dkv_kernel(q, k, v, do, m, l, delta, *, causal: bool = True,
                               scale: float | None = None):
    """Launch the CUDA dK/dV kernel on ``q``'s device.

    Arguments as for :func:`flash_attention_dq_kernel`.  Returns (dK, dV),
    each contiguous (B, Hkv, S, d) in k's dtype, the g query heads of each
    kv head summed in float32.  Launches on the current stream;
    ``flash_attention_dkv_kernel.launches`` counts launches,
    ``.launches_by_route`` counts them per :func:`flash_bwd_route`.
    """
    refuse_grad("flash attention dK/dV", "second derivatives are not supported",
                q, k, v, do)
    device, B, Hq, Hkv, T, S, d = _check_bwd(q, k, v, do, m, l, delta)
    dk = torch.empty((B, Hkv, S, d), dtype=k.dtype, device=device)
    dv = torch.empty((B, Hkv, S, d), dtype=k.dtype, device=device)
    route = flash_bwd_route(q.dtype, d)
    args = (ptr(q), ptr(k), ptr(v), ptr(do), ptr(m), ptr(l), ptr(delta), ptr(dk), ptr(dv))
    tail = (B, Hq, Hkv, T, S, d, stride_array(q, k, v, do), int(causal),
            ctypes.c_float(_scale(d, scale)), stream(device))
    with torch.cuda.device(device):
        if route == "wgmma":
            _check_tma(q, k, v, do)
            err = _library().flash_attention_dkv_wgmma(*args, *tail)
        else:
            err = _library().flash_attention_dkv(*args, DTYPE_CODES[q.dtype], *tail)
    raise_on_error(err, f"flash_attention_dkv ({route})")
    flash_attention_dkv_kernel.launches += 1
    flash_attention_dkv_kernel.launches_by_route[route] += 1
    return dk, dv


flash_attention_fwd_stats_kernel.launches = 0
flash_attention_fwd_stats_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention_dq_kernel.launches = 0
flash_attention_dq_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention_dkv_kernel.launches = 0
flash_attention_dkv_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _routes(t):
    """(fwd_stats, dq, dkv) for ``t``'s device: the plain versions for a CPU
    tensor, the CUDA kernels otherwise (which launch or raise)."""
    if t.device.type == "cpu":
        return (flash_attention_fwd_stats_plain, flash_attention_dq_plain,
                flash_attention_dkv_plain)
    return (flash_attention_fwd_stats_kernel, flash_attention_dq_kernel,
            flash_attention_dkv_kernel)


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: the port of the reference's
    ``custom_vjp`` (``flash_attention_trainable``, ``_vjp_fwd``,
    ``_vjp_bwd``).  The forward saves (q, k, v, o, m, l) as the TPU
    residuals; the backward forms ``delta = sum(dO * O)`` in float32 and
    runs dQ and dK/dV.  Gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        fwd, _, _ = _routes(q)
        o, m, l = fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        _, dq_fn, dkv_fn = _routes(q)
        if do.stride(-1) != 1:
            do = do.contiguous()     # the kernels read rows with a contiguous last axis
        delta = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
        dq = dq_fn(q, k, v, do, m, l, delta, causal=ctx.causal)
        dk, dv = dkv_fn(q, k, v, do, m, l, delta, causal=ctx.causal)
        return dq, dk, dv, None
