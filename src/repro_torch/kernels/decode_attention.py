"""Decode attention: the CUDA kernels and their plain versions.

Dense flash-decode.  ``decode_attention_kernel`` launches
``csrc/decode_attention.cu`` (hand-written for Hopper, ``sm_90a``), which
replaces the TPU kernel ``repro.kernels.decode_attention.decode_attention_kernel``:
one query row per (b, q head), q ``(B,Hq,1,d)``, against a cache k, v
``(B,Hkv,S,d)`` read through its strides; query head h reads kv head
``h // (Hq // Hkv)``; cache position kpos is visible iff ``kpos <= pos`` for
a scalar ``pos``; a row with nothing visible gives exact zeros.
``decode_attention_plain`` is the same function in plain PyTorch.

Block-sparse paged decode attention.  ``paged_decode_attention_kernel``
launches ``csrc/paged_decode_attention.cu`` (hand-written for Hopper,
``sm_90a``), which replaces the TPU kernel
``repro.kernels.decode_attention.paged_decode_attention_kernel``.  Each
stream b walks its block table in logical order, visits page j only while
``j*ps < lengths[b]``, and folds the optional fresh ``kn/vn`` row in last
at position ``lengths[b]``; without a fresh row an empty stream yields exact
zeros.  ``paged_decode_attention_plain`` is the same function in plain
PyTorch: a gather of each stream's live pages, then a two-pass softmax.

Both kernels are memory-bound (the visible cache bytes over 3.35 TB/s) and
have two bodies each, picked by :func:`decode_route` and :func:`paged_route`
and counted per route in ``launches_by_route``:

* ``"split"`` (C entries ``decode_attention_fwd_split`` and
  ``paged_decode_attention_split_f32``): a thread-block cluster of
  :data:`DECODE_SPLIT` / :data:`PAGED_SPLIT` blocks takes each (b, kv head)
  or stream and splits its keys (64-key tiles, or pages) into contiguous
  runs, one a block, fed by 16-byte ``cp.async`` copies (dense) or one bulk
  copy a page (paged); each block stores its (max, denominator,
  accumulator) into rank 0's shared memory (distributed shared memory), and
  rank 0 folds them in rank order.  Rows of 16-byte multiples at 16-byte
  aligned bases and strides.
* ``"simt"`` (``decode_attention_fwd``, ``paged_decode_attention_f32``):
  the CUDA-core bodies, one block a (b, kv head) or stream walking its keys
  in one sequence, for every other shape.

Either way a row's result depends only on its own inputs, summed in a fixed
order with no atomics, so row b of a batched launch is bitwise equal to a
solo launch of row b.  The plain versions serve CPU tensors (the tests) and
are the yardsticks the kernels are checked against on the card;
:mod:`repro_torch.kernels.ops` picks between kernel and plain version by the
tensors' device.  A CUDA call that no route takes raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .common import (
    DTYPE_CODES,
    aligned16,
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

ROUTES = ("split", "simt")
SPLIT_KEYS = 64              # keys of a dense split tile: ranks take runs of whole tiles
SPLIT_MAX_ROW_BYTES = 512    # d * sizeof(cache) the dense split body's tile ring holds
SPLIT_MAX_ROWS = 8           # query rows per kv head a dense split block holds
SPLIT_Q_REGS = 16            # float4s of q a thread holds: rows * ceil(d / 16)
PAGED_SPLIT_MAX_D = 2048     # 2 float4 columns a thread of 256 in the paged split body
MAX_SMEM = 227 * 1024        # shared memory a block can take on the H100
# Blocks per cluster of the split bodies, one for every shape and never set
# by the batch.  chip_smoke.py times each of 1, 2, 4, 8 and 16 at the paths'
# step shapes: on an NVIDIA H100 80GB HBM3 at 700.00 W, 2 is within 3% of
# the best at the dense and the hybrid step, 8 the best at the paged one
# (PERF.md, PR 19).
DECODE_SPLIT = 2
PAGED_SPLIT = 8


def decode_route(kv_dtype, d: int, group: int, *cache) -> str:
    """The body a dense decode launch runs on: ``"split"`` where a cache row,
    ``d`` elements of ``kv_dtype``, is a multiple of 16 bytes and at most
    :data:`SPLIT_MAX_ROW_BYTES`, a kv head serves at most
    :data:`SPLIT_MAX_ROWS` query heads (``group``) whose q columns fit a
    thread's registers (``group`` rounded up to a power of two, times
    ``ceil(d / 16)``, at most :data:`SPLIT_Q_REGS`), and each tensor of
    ``cache`` (k, v) has 16-byte aligned base and strides; ``"simt"``
    otherwise.  q's dtype does not matter: q is read element by element."""
    row = d * torch.empty((), dtype=kv_dtype).element_size()
    if row % 16 or row > SPLIT_MAX_ROW_BYTES or not 1 <= group <= SPLIT_MAX_ROWS:
        return "simt"
    rows = 1 << (group - 1).bit_length()        # query rows a block holds: 1, 2, 4 or 8
    if rows * -(-d // 16) > SPLIT_Q_REGS:
        return "simt"
    return "split" if all(aligned16(t) for t in cache) else "simt"


def paged_split_smem(d: int, ps: int, nsplit: int) -> int:
    """Shared memory bytes of a paged split block (``split::Layout`` in the
    source): the K and V pages, q, the scores, the statistics, the warps'
    partials, two mbarriers, and every rank's (acc, m, l) for rank 0."""
    return 4 * (2 * ps * d + d + -(-ps // 4) * 4) + 64 + nsplit * (4 * d + 8)


def paged_route(d: int, ps: int, *pools) -> str:
    """The body a paged decode launch runs on: ``"split"`` at ``d % 4 ==
    0``, ``d <=`` :data:`PAGED_SPLIT_MAX_D`, a block's shared memory (two
    pages) within the card's 227 KB and 16-byte aligned pools (each page a
    16-byte aligned run, fetched by one bulk copy); ``"simt"`` otherwise."""
    if d % 4 or d > PAGED_SPLIT_MAX_D or paged_split_smem(d, ps, PAGED_SPLIT) > MAX_SMEM:
        return "simt"
    return "split" if all(t.data_ptr() % 16 == 0 for t in pools) else "simt"


def decode_attention_plain(q, k, v, pos, *, return_lse: bool = False):
    """Plain PyTorch dense decode attention (any device, float32 math).

    q: (B, Hq, 1, d); k, v: (B, Hkv, S, d); pos: the last visible cache
    position, an int or a one-element integer tensor on q's device.  With
    ``return_lse`` also each row's log-sum-exp of its scaled visible
    scores, ``m + ln(l)``, (B, Hq) float32, ``-inf`` for a row with nothing
    visible: what two calls over the halves of a cache need to be folded
    into the call over the whole.
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
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    empty = l <= 0.0
    out = torch.matmul(p, vf) / torch.where(empty, torch.ones_like(l), l)
    out = out.masked_fill(empty, 0.0).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(empty, torch.full_like(l, -math.inf), m + torch.log(l))
    return out, lse.reshape(B, Hq)


def _dense_library() -> ctypes.CDLL:
    lib = build.load(_DENSE_SOURCE)
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ctypes.c_float, p, p]
        fn.restype = ctypes.c_int
        split = lib.decode_attention_fwd_split
        split.argtypes = fn.argtypes[:-2] + [i, p, p]
        split.restype = ctypes.c_int
    return lib


def decode_attention_kernel(q, k, v, pos, *, return_lse: bool = False):
    """Launch the CUDA dense decode attention on ``q``'s device.

    q: (B, Hq, 1, d), float32 or bfloat16; k, v: (B, Hkv, S, d) with Hq a
    multiple of Hkv, float32 or bfloat16 (one dtype for both, which may
    differ from q's); every tensor with a contiguous last axis (other
    strides are free: the model's (B, S, Hkv, d) cache is passed as a
    transposed view); pos: a one-element int32 tensor on the same CUDA
    device (read there by the kernel, no host sync).
    Returns a contiguous (B, Hq, 1, d) tensor in q's dtype, and with
    ``return_lse`` also each row's log-sum-exp (B, Hq) float32 (see
    :func:`decode_attention_plain`; the C entries write it where given a
    buffer).  Launches on the current stream and
    does not synchronise.  The body is
    :func:`decode_route`'s; ``decode_attention_kernel.launches`` counts
    launches and ``decode_attention_kernel.launches_by_route`` counts them
    per route.
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
    route = decode_route(k.dtype, d, Hq // Hkv, k, v)
    out = torch.empty((B, Hq, 1, d), dtype=q.dtype, device=device)
    qs, ks, vs = strides(q), strides(k), strides(v)
    args = [ptr(q), ptr(k), ptr(v), ptr(pos), ptr(out),
            DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype], B, Hq, Hkv, S, d,
            *qs[:2], *ks[:3], *vs[:3], ctypes.c_float(1.0 / math.sqrt(d))]
    lse = torch.empty((B, Hq), dtype=torch.float32, device=device) if return_lse else None
    with torch.cuda.device(device):
        lib = _dense_library()
        if route == "split":
            err = lib.decode_attention_fwd_split(*args, DECODE_SPLIT, ptr(lse),
                                                 stream(device))
        else:
            err = lib.decode_attention_fwd(*args, ptr(lse), stream(device))
    raise_on_error(err, f"decode_attention ({route})")
    decode_attention_kernel.launches += 1
    decode_attention_kernel.launches_by_route[route] += 1
    return (out, lse) if return_lse else out


decode_attention_kernel.launches = 0
decode_attention_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


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
        split = lib.paged_decode_attention_split_f32
        split.argtypes = fn.argtypes[:-1] + [i, p]
        split.restype = ctypes.c_int
    return lib


def paged_decode_attention_kernel(q, k_pages, v_pages, tables, lengths,
                                  kn=None, vn=None):
    """Launch the CUDA paged decode attention kernel on ``q``'s device.

    Same arguments as :func:`paged_decode_attention_plain`; every tensor must
    be float32 (tables and lengths int32), contiguous, and on one CUDA
    device, or this raises.  Launches on the current stream and does not
    synchronise.  The body is :func:`paged_route`'s;
    ``paged_decode_attention_kernel.launches`` counts launches and
    ``paged_decode_attention_kernel.launches_by_route`` counts them per route.
    """
    refuse_grad("paged decode attention", "paged decode serves inference only: call "
                "it under torch.no_grad(); training attention is "
                "ops.flash_attention_trainable", q, k_pages, v_pages, kn, vn)
    device = require_cuda(q, "paged decode attention")
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
    route = paged_route(d, ps, k_pages, v_pages)
    smem = 4 * (2 * d + max(ps, 8) + ps)
    if route == "simt" and smem > MAX_SMEM:
        raise ValueError(f"d={d}, ps={ps} needs {smem} bytes of shared memory "
                         f"per block, above the card's 227 KB")
    out = torch.empty((B, d), dtype=f32, device=device)
    args = [ptr(q), ptr(kn), ptr(vn), ptr(k_pages), ptr(v_pages), ptr(tables),
            ptr(lengths), ptr(out), B, d, ps, npages, int(kn is not None),
            ctypes.c_float(1.0 / math.sqrt(d))]
    with torch.cuda.device(device):
        lib = _library()
        if route == "split":
            err = lib.paged_decode_attention_split_f32(*args, PAGED_SPLIT,
                                                       stream(device))
        else:
            err = lib.paged_decode_attention_f32(*args, stream(device))
    raise_on_error(err, f"paged_decode_attention ({route})")
    paged_decode_attention_kernel.launches += 1
    paged_decode_attention_kernel.launches_by_route[route] += 1
    return out


paged_decode_attention_kernel.launches = 0
paged_decode_attention_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
decode_attention_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
