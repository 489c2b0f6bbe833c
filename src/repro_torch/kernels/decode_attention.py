"""Decode attention: the CUDA kernels and their plain versions.

Dense flash-decode.  ``decode_attention_kernel`` launches
``csrc/decode_attention.cu`` (hand-written for Hopper, ``sm_90a``), which
replaces the TPU kernel ``repro.kernels.decode_attention.decode_attention_kernel``:
one query row per (b, q head), q ``(B,Hq,1,d)``, against a cache k, v
``(B,Hkv,S,d)`` read through its strides; query head h reads kv head
``h // (Hq // Hkv)``; cache position kpos is visible iff ``kpos <= pos`` for
a scalar ``pos``; a row with nothing visible gives exact zeros.
``decode_attention_plain`` is the same function in plain PyTorch.

Block-sparse paged decode attention.

``paged_decode_attention_kernel`` launches ``csrc/paged_decode_attention.cu``
(hand-written for Hopper, ``sm_90a``), which replaces the TPU kernel
``repro.kernels.decode_attention.paged_decode_attention_kernel``.  Each
stream b walks its block table in logical order, visits page j only while
``j*ps < lengths[b]``, and folds the optional fresh ``kn/vn`` row in last
at position ``lengths[b]``; without a fresh row an empty stream yields exact
zeros.  One thread block per stream and a fixed page order keep row b of a
batched launch bitwise equal to a solo launch of row b.  The kernel is
memory-bound (live KV bytes over 3.35 TB/s); see the source for its design.

``paged_decode_attention_plain`` is the same function in plain PyTorch — a
gather of each stream's live pages, then a two-pass softmax.  It serves CPU
tensors (the tests) and is the yardstick the kernel is checked against on
the card.  :func:`repro_torch.kernels.ops.paged_decode_attention` picks
between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .common import (
    DTYPE_CODES,
    check_strided,
    check_tensor as _check,
    ptr,
    raise_on_error,
    refuse_grad,
    require_cuda,
    stream,
    strides,
)

_SOURCE = "paged_decode_attention"
_DENSE_SOURCE = "decode_attention"
NEG_INF = -1e30


def decode_attention_plain(q, k, v, pos):
    """Plain PyTorch dense decode attention (any device, float32 math).

    q: (B, Hq, 1, d); k, v: (B, Hkv, S, d); pos: the last visible cache
    position, an int or a one-element integer tensor on q's device.
    """
    B, Hq, _, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    f32 = torch.float32
    group = Hq // Hkv
    kf, vf = k.to(f32), v.to(f32)
    if group != 1:
        kf = torch.repeat_interleave(kf, group, dim=1)
        vf = torch.repeat_interleave(vf, group, dim=1)
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(())
    valid = torch.arange(S, device=q.device) <= pos                  # (S,)
    s = torch.matmul(q.to(f32), kf.transpose(-1, -2)) / math.sqrt(d)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    empty = l <= 0.0
    out = torch.matmul(p, vf) / torch.where(empty, torch.ones_like(l), l)
    return out.masked_fill(empty, 0.0).to(q.dtype)


def _dense_library() -> ctypes.CDLL:
    lib = build.load(_DENSE_SOURCE)
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def decode_attention_kernel(q, k, v, pos):
    """Launch the CUDA dense decode attention on ``q``'s device.

    q: (B, Hq, 1, d), float32 or bfloat16; k, v: (B, Hkv, S, d) with Hq a
    multiple of Hkv, float32 or bfloat16 (one dtype for both, which may
    differ from q's); every tensor with a contiguous last axis (other
    strides are free: the model's (B, S, Hkv, d) cache is passed as a
    transposed view); pos: a one-element int32 tensor on the same CUDA
    device (read there by the kernel, no host sync).
    Returns a contiguous (B, Hq, 1, d) tensor in q's dtype.  Launches on the
    current stream and does not synchronise.
    ``decode_attention_kernel.launches`` counts launches.
    """
    refuse_grad("decode attention", "decode attention serves inference only: call "
                "it under torch.no_grad(); training attention is "
                "ops.flash_attention_trainable", q, k, v)
    device = require_cuda(q, "decode attention")
    dtypes = tuple(DTYPE_CODES)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_strided(name, t, dtypes, 4, device)
    if k.dtype != v.dtype:
        raise TypeError(f"k and v must share a dtype, got {k.dtype} and {v.dtype}")
    B, Hq, one, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if one != 1:
        raise ValueError(f"q must be (B, Hq, 1, d), got {tuple(q.shape)}")
    if k.shape[0] != B or k.shape[3] != d or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k, v must be (B, Hkv, S, d) = (B={B}, Hkv, S, d={d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if not (isinstance(pos, torch.Tensor) and pos.device == device
            and pos.dtype == torch.int32 and pos.numel() == 1):
        raise ValueError(f"pos must be a one-element int32 tensor on {device}, got {pos!r}")
    out = torch.empty((B, Hq, 1, d), dtype=q.dtype, device=device)
    qs, ks, vs = strides(q), strides(k), strides(v)
    with torch.cuda.device(device):
        err = _dense_library().decode_attention_fwd(
            ptr(q), ptr(k), ptr(v), ptr(pos), ptr(out),
            DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype], B, Hq, Hkv, S, d,
            *qs[:2], *ks[:3], *vs[:3], ctypes.c_float(1.0 / math.sqrt(d)), stream(device))
    raise_on_error(err, "decode_attention")
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0


def paged_decode_attention_plain(q, k_pages, v_pages, tables, lengths,
                                 kn=None, vn=None):
    """Plain PyTorch paged decode attention (any device, float32 math).

    q: (B, d); k_pages, v_pages: (P, ps, d); tables: (B, npages) int32;
    lengths: (B,) int32; kn, vn: optional (B, d) fresh rows attended at
    logical position ``lengths[b]``.
    """
    B, d = q.shape
    ps = k_pages.shape[1]
    f32 = torch.float32
    out = torch.zeros((B, d), dtype=f32, device=q.device)
    for b, n in enumerate(lengths.tolist()):
        used = -(-n // ps)                      # live pages of stream b
        live = tables[b, :used].to(torch.long)
        k = torch.index_select(k_pages, 0, live).reshape(used * ps, d)[:n].to(f32)
        v = torch.index_select(v_pages, 0, live).reshape(used * ps, d)[:n].to(f32)
        if kn is not None:
            k = torch.cat([k, kn[b:b + 1].to(f32)])
            v = torch.cat([v, vn[b:b + 1].to(f32)])
        if k.shape[0] == 0:
            continue    # nothing valid: exact zeros
        s = (k @ q[b].to(f32)) / math.sqrt(d)
        p = torch.exp(s - s.max())
        p = p / p.sum()
        out[b] = p @ v
    return out.to(q.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.paged_decode_attention_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def paged_decode_attention_kernel(q, k_pages, v_pages, tables, lengths,
                                  kn=None, vn=None):
    """Launch the CUDA paged decode attention kernel on ``q``'s device.

    Same arguments as :func:`paged_decode_attention_plain`; every tensor must
    be float32 (tables and lengths int32), contiguous, and on one CUDA
    device, or this raises.  Launches on the current stream and does not
    synchronise.  ``paged_decode_attention_kernel.launches`` counts launches.
    """
    refuse_grad("paged decode attention", "paged decode serves inference only: call "
                "it under torch.no_grad(); training attention is "
                "ops.flash_attention_trainable", q, k_pages, v_pages, kn, vn)
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got q on {device}")
    if q.dim() != 2:
        raise ValueError(f"q must be (B, d), got shape {tuple(q.shape)}")
    B, d = q.shape
    if k_pages.dim() != 3:
        raise ValueError(f"k_pages must be (P, ps, d), got {tuple(k_pages.shape)}")
    P, ps = k_pages.shape[:2]
    if tables.dim() != 2:
        raise ValueError(f"tables must be (B, npages), got {tuple(tables.shape)}")
    npages = tables.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check("q", q, f32, (B, d), device)
    _check("k_pages", k_pages, f32, (P, ps, d), device)
    _check("v_pages", v_pages, f32, (P, ps, d), device)
    _check("tables", tables, i32, (B, npages), device)
    _check("lengths", lengths, i32, (B,), device)
    if (kn is None) != (vn is None):
        raise ValueError("kn and vn go together: pass both or neither")
    if kn is not None:
        _check("kn", kn, f32, (B, d), device)
        _check("vn", vn, f32, (B, d), device)
    if ps < 1 or d < 1:
        raise ValueError(f"page size and width must be positive, got ps={ps}, d={d}")
    smem = 4 * (2 * d + max(ps, 8) + ps)
    if smem > 227 * 1024:
        raise ValueError(f"d={d}, ps={ps} needs {smem} bytes of shared memory "
                         f"per block, above the card's 227 KB")
    out = torch.empty((B, d), dtype=f32, device=device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)  # noqa: E731
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().paged_decode_attention_f32(
            ptr(q), ptr(kn), ptr(vn), ptr(k_pages), ptr(v_pages),
            ptr(tables), ptr(lengths), ptr(out),
            B, d, ps, npages, int(kn is not None),
            ctypes.c_float(1.0 / math.sqrt(d)), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    paged_decode_attention_kernel.launches += 1
    return out


paged_decode_attention_kernel.launches = 0
