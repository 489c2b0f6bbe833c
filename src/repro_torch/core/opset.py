"""Op vocabulary for the Program IR (PyTorch host side).

Each op kind carries three semantics:
  * ``numpy_fn`` — guest ("emulated") semantics: eager numpy, used by the
    op-at-a-time interpreter in :mod:`repro_torch.core.emulator`.  This is the
    DBT analogue: universal, host-memory, Python-dispatched.
  * ``torch_fn`` — host ("native") semantics: eager torch on the offload
    unit's device, used when the op is part of an offloaded region.  ``None``
    marks a host-only op (the analogue of ISA-specific assembly / unavailable
    dependencies): such an op can only run in the interpreter, and it is what
    blocks a function from being offloaded (until PFO splits around it).
  * ``infer_fn`` — abstract evaluation used for (a) the result avals of
    host→guest reentry during emulation, (b) the offload cost model.

Inside a unit every value is a tensor in the canonical 32-bit dtypes
(:func:`canonical_dtype`): float64 arrives as float32 and int64 as int32, so
``torch_fn`` reproduces the host semantics of the 32-bit reference engine.

Cost terms (flops / bytes moved) power :mod:`repro_torch.core.costmodel`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import library


@dataclasses.dataclass(frozen=True)
class AVal:
    """Abstract value: shape + dtype (our ShapeDtypeStruct)."""

    shape: tuple[int, ...]
    dtype: str

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * np.dtype(self.dtype).itemsize

    @staticmethod
    def of(x) -> "AVal":
        return AVal(tuple(int(d) for d in np.shape(x)), str(np.asarray(x).dtype if np.isscalar(x) else x.dtype))


@dataclasses.dataclass(frozen=True)
class Cost:
    flops: int = 0
    bytes: int = 0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.bytes + other.bytes)


@dataclasses.dataclass(frozen=True)
class OpDef:
    kind: str
    numpy_fn: Callable[..., tuple]
    torch_fn: Callable[..., tuple] | None
    infer_fn: Callable[..., tuple[AVal, ...]]
    cost_fn: Callable[..., Cost]
    nout: int = 1

    @property
    def offloadable(self) -> bool:
        return self.torch_fn is not None


REGISTRY: dict[str, OpDef] = {}


def register(kind: str, *, numpy_fn, torch_fn, infer_fn, cost_fn=None, nout=1):
    if kind in REGISTRY:
        raise ValueError(f"duplicate op kind {kind!r}")
    if cost_fn is None:
        cost_fn = lambda params, *avals: Cost(  # noqa: E731
            flops=sum(a.size for a in avals), bytes=sum(a.nbytes for a in avals)
        )
    REGISTRY[kind] = OpDef(kind, numpy_fn, torch_fn, infer_fn, cost_fn, nout)
    return REGISTRY[kind]


def get(kind: str) -> OpDef:
    try:
        return REGISTRY[kind]
    except KeyError:
        raise KeyError(f"unknown op kind {kind!r}; known: {sorted(REGISTRY)}") from None


# ---------------------------------------------------------------------------
# dtypes: the 32-bit canonical form every unit computes in
# ---------------------------------------------------------------------------

# 64-bit kinds narrow to their 32-bit twins at the guest→host boundary, the
# way the 32-bit reference engine places every array
_CANONICAL = {
    "float64": "float32", "int64": "int32", "uint64": "uint32",
    "complex128": "complex64",
}


def canonical_dtype(dtype) -> np.dtype:
    """The dtype a host unit computes ``dtype`` in (64-bit → 32-bit)."""
    name = np.dtype(dtype).name
    return np.dtype(_CANONICAL.get(name, name))


# torch <-> numpy dtypes, tabled once at import: a unit body looks them up
# while torch.export traces it, where no tensor may be made for the purpose
_NUMPY_OF_TORCH = {
    t: torch.empty((), dtype=t).numpy().dtype
    for t in (torch.bool, torch.uint8, torch.uint16, torch.uint32, torch.uint64,
              torch.int8, torch.int16, torch.int32, torch.int64, torch.float16,
              torch.float32, torch.float64, torch.complex64, torch.complex128)
}
_TORCH_OF_NUMPY = {n: t for t, n in _NUMPY_OF_TORCH.items()}


def torch_dtype(dtype) -> torch.dtype:
    """Canonical torch dtype for a numpy dtype (or dtype name)."""
    np_dtype = canonical_dtype(dtype)
    try:
        return _TORCH_OF_NUMPY[np_dtype]
    except KeyError:
        raise TypeError(f"no torch dtype for numpy {np_dtype}") from None


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """Numpy dtype of a torch dtype (the avals are spelled in numpy names)."""
    try:
        return _NUMPY_OF_TORCH[dtype]
    except KeyError:
        raise TypeError(f"no numpy dtype for torch {dtype}") from None


def _promote(*xs):
    """Cast tensors to their common dtype (torch's matmul does not promote)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def _axes(ax, ndim: int):
    """Normalize an ``axis`` param (int, sequence or None) to a tuple."""
    if ax is None:
        return tuple(range(ndim))
    return (ax,) if isinstance(ax, int) else tuple(ax)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _ew_infer(params, *avals: AVal) -> tuple[AVal, ...]:
    """Elementwise with numpy broadcasting."""
    shape = np.broadcast_shapes(*[a.shape for a in avals])
    dtype = np.result_type(*[np.dtype(a.dtype) for a in avals]).name
    return (AVal(tuple(shape), dtype),)


def _ew_cost(params, *avals: AVal) -> Cost:
    out_size = int(np.prod(np.broadcast_shapes(*[a.shape for a in avals])))
    return Cost(flops=out_size, bytes=out_size * 4 * (len(avals) + 1))


def _same_infer(params, a: AVal) -> tuple[AVal, ...]:
    return (a,)


def _unary(kind, np_f, torch_f, flops_per_elem=1):
    def cost(params, a):
        return Cost(flops=a.size * flops_per_elem, bytes=2 * a.nbytes)

    register(
        kind,
        numpy_fn=lambda params, x: (np_f(x),),
        torch_fn=lambda params, x: (torch_f(x),),
        infer_fn=_same_infer,
        cost_fn=cost,
    )


def _binary(kind, np_f, torch_f):
    register(
        kind,
        numpy_fn=lambda params, x, y: (np_f(x, y),),
        torch_fn=lambda params, x, y: (torch_f(x, y),),
        infer_fn=_ew_infer,
        cost_fn=_ew_cost,
    )


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

_np_silu = lambda x: x / (1.0 + np.exp(-x))
_np_gelu = lambda x: 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))

_unary("neg", np.negative, torch.neg)
_unary("exp", np.exp, torch.exp, 4)
_unary("log", np.log, torch.log, 4)
_unary("tanh", np.tanh, torch.tanh, 8)
_unary("sqrt", np.sqrt, torch.sqrt, 2)
_unary("rsqrt", lambda x: 1.0 / np.sqrt(x), torch.rsqrt, 2)
_unary("square", np.square, torch.square)
_unary("abs", np.abs, torch.abs)
_unary("relu", lambda x: np.maximum(x, 0), lambda x: torch.clamp_min(x, 0))
_unary("floor", np.floor, torch.floor)
_unary("silu", _np_silu, F.silu, 8)
# the tanh approximation, as in the reference's host semantics
_unary("gelu", _np_gelu, lambda x: F.gelu(x, approximate="tanh"), 12)
_unary("sigmoid", lambda x: 1.0 / (1.0 + np.exp(-x)), torch.sigmoid, 6)

_binary("add", np.add, torch.add)
_binary("sub", np.subtract, torch.sub)
_binary("mul", np.multiply, torch.mul)
_binary("div", np.divide, torch.true_divide)
_binary("maximum", np.maximum, torch.maximum)
_binary("minimum", np.minimum, torch.minimum)


def _cmp_infer(params, *avals: AVal) -> tuple[AVal, ...]:
    shape = np.broadcast_shapes(*[a.shape for a in avals])
    return (AVal(tuple(shape), "bool"),)


def _compare(kind, np_f, torch_f):
    register(
        kind,
        numpy_fn=lambda params, x, y: (np_f(x, y),),
        torch_fn=lambda params, x, y: (torch_f(x, y),),
        infer_fn=_cmp_infer,
        cost_fn=_ew_cost,
    )


_compare("eq", np.equal, torch.eq)
_compare("lt", np.less, torch.lt)


# ---------------------------------------------------------------------------
# structural
# ---------------------------------------------------------------------------

def _reshape_infer(params, a: AVal):
    shape = tuple(params["shape"])
    if -1 in shape:
        known = int(np.prod([d for d in shape if d != -1]))
        shape = tuple(a.size // known if d == -1 else d for d in shape)
    return (AVal(shape, a.dtype),)


register(
    "reshape",
    numpy_fn=lambda params, x: (np.reshape(x, params["shape"]),),
    torch_fn=lambda params, x: (torch.reshape(x, tuple(params["shape"])),),
    infer_fn=_reshape_infer,
    cost_fn=lambda params, a: Cost(0, 0),
)

register(
    "transpose",
    numpy_fn=lambda params, x: (np.transpose(x, params["perm"]),),
    torch_fn=lambda params, x: (x.permute(tuple(params["perm"])),),
    infer_fn=lambda params, a: (AVal(tuple(a.shape[i] for i in params["perm"]), a.dtype),),
    cost_fn=lambda params, a: Cost(0, 2 * a.nbytes),
)

register(
    "cast",
    numpy_fn=lambda params, x: (x.astype(params["dtype"]),),
    torch_fn=lambda params, x: (x.to(torch_dtype(params["dtype"])),),
    infer_fn=lambda params, a: (AVal(a.shape, params["dtype"]),),
    cost_fn=lambda params, a: Cost(0, 2 * a.nbytes),
)


def _concat_infer(params, *avals: AVal):
    ax = params["axis"]
    shape = list(avals[0].shape)
    shape[ax] = sum(a.shape[ax] for a in avals)
    return (AVal(tuple(shape), avals[0].dtype),)


register(
    "concat",
    numpy_fn=lambda params, *xs: (np.concatenate(xs, axis=params["axis"]),),
    torch_fn=lambda params, *xs: (torch.cat(xs, dim=params["axis"]),),
    infer_fn=_concat_infer,
    cost_fn=lambda params, *avals: Cost(0, 2 * sum(a.nbytes for a in avals)),
)


def _slice_infer(params, a: AVal):
    starts, sizes = params["starts"], params["sizes"]
    return (AVal(tuple(sizes), a.dtype),)


def _torch_slice(params, x):
    # dynamic-slice semantics: a start is clamped so the window stays in
    # bounds (the numpy guest body does not clamp; in-bounds params agree)
    idx = tuple(
        slice(s, s + z)
        for s, z in (
            (min(max(int(s), 0), d - int(z)), int(z))
            for s, z, d in zip(params["starts"], params["sizes"], x.shape)
        )
    )
    return (x[idx],)


register(
    "slice",
    numpy_fn=lambda params, x: (
        x[tuple(slice(s, s + z) for s, z in zip(params["starts"], params["sizes"]))],
    ),
    torch_fn=_torch_slice,
    infer_fn=_slice_infer,
    cost_fn=lambda params, a: Cost(0, int(np.prod(params["sizes"])) * 8),
)

def _expand_infer(params, a: AVal):
    ax, ndim = params["axis"], len(a.shape) + 1
    if not -ndim <= ax < ndim:
        raise ValueError(
            f"expand_dims axis {ax} out of range for rank-{len(a.shape)} input")
    shape = list(a.shape)
    shape.insert(ax % ndim, 1)
    return (AVal(tuple(shape), a.dtype),)


register(
    "expand_dims",
    numpy_fn=lambda params, x: (np.expand_dims(x, params["axis"]),),
    torch_fn=lambda params, x: (torch.unsqueeze(x, params["axis"]),),
    infer_fn=_expand_infer,
    cost_fn=lambda params, a: Cost(0, 0),
)


def _squeeze_infer(params, a: AVal):
    ax = params["axis"] % len(a.shape)
    if a.shape[ax] != 1:
        raise ValueError(f"squeeze axis {ax} has extent {a.shape[ax]} != 1")
    return (AVal(a.shape[:ax] + a.shape[ax + 1:], a.dtype),)


register(
    "squeeze",
    numpy_fn=lambda params, x: (np.squeeze(x, params["axis"]),),
    torch_fn=lambda params, x: (torch.squeeze(x, params["axis"]),),
    infer_fn=_squeeze_infer,
    cost_fn=lambda params, a: Cost(0, 0),
)


def _pad_to_infer(params, a: AVal):
    ax, target = params["axis"] % len(a.shape), params["target"]
    if a.shape[ax] > target:
        raise ValueError(
            f"pad_to target {target} smaller than extent {a.shape[ax]} "
            f"on axis {ax} of {a.shape}"
        )
    return (AVal(a.shape[:ax] + (target,) + a.shape[ax + 1:], a.dtype),)


def _pad_to_widths(x, axis, target):
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - x.shape[axis])
    return widths


def _torch_pad_to(params, x):
    ax = params["axis"] % x.ndim
    shape = list(x.shape)
    shape[ax] = params["target"]
    out = x.new_zeros(shape)
    out.narrow(ax, 0, x.shape[ax]).copy_(x)
    return (out,)


register(
    "pad_to",
    numpy_fn=lambda params, x: (
        np.pad(x, _pad_to_widths(x, params["axis"], params["target"])),
    ),
    torch_fn=_torch_pad_to,
    infer_fn=_pad_to_infer,
    cost_fn=lambda params, a: Cost(0, 2 * a.nbytes),
)


def _torch_roll(params, x):
    shift, ax = params["shift"], params["axis"]
    if ax is None:
        return (torch.roll(x, shift),)
    return (torch.roll(x, shift, dims=ax),)


register(
    "roll",
    numpy_fn=lambda params, x: (np.roll(x, params["shift"], axis=params["axis"]),),
    torch_fn=_torch_roll,
    infer_fn=_same_infer,
    cost_fn=lambda params, a: Cost(0, 2 * a.nbytes),
)

register(
    "where",
    numpy_fn=lambda params, c, x, y: (np.where(c, x, y),),
    torch_fn=lambda params, c, x, y: (torch.where(c.to(torch.bool), x, y),),
    infer_fn=lambda params, c, x, y: _ew_infer(params, x, y),
    cost_fn=_ew_cost,
)


# ---------------------------------------------------------------------------
# reductions / normalizations
# ---------------------------------------------------------------------------

def _red_infer(params, a: AVal):
    ax = params["axis"]
    axes = (ax,) if isinstance(ax, int) else tuple(ax)
    axes = tuple(x % len(a.shape) for x in axes)
    keep = params.get("keepdims", False)
    if keep:
        shape = tuple(1 if i in axes else d for i, d in enumerate(a.shape))
    else:
        shape = tuple(d for i, d in enumerate(a.shape) if i not in axes)
    return (AVal(shape, a.dtype),)


def _torch_mean(x, dim, keepdim):
    # integer means are taken in float and cast back by the caller, as the
    # reference's host body does
    xf = x if x.is_floating_point() or x.is_complex() else x.to(torch.float32)
    return torch.mean(xf, dim=dim, keepdim=keepdim)


for red, np_f, torch_f in [
    ("reduce_sum", np.sum, torch.sum),
    ("reduce_max", np.max, torch.amax),
    ("reduce_mean", np.mean, _torch_mean),
]:
    register(
        red,
        numpy_fn=lambda params, x, f=np_f: (
            f(x, axis=params["axis"], keepdims=params.get("keepdims", False)).astype(x.dtype),
        ),
        torch_fn=lambda params, x, f=torch_f: (
            f(x, dim=_axes(params["axis"], x.ndim),
              keepdim=params.get("keepdims", False)).to(x.dtype),
        ),
        infer_fn=_red_infer,
        cost_fn=lambda params, a: Cost(a.size, a.nbytes),
    )


def _np_softmax(params, x):
    ax = params.get("axis", -1)
    m = np.max(x, axis=ax, keepdims=True)
    e = np.exp(x - m)
    return (e / np.sum(e, axis=ax, keepdims=True),)


register(
    "softmax",
    numpy_fn=_np_softmax,
    torch_fn=lambda params, x: (torch.softmax(x, dim=params.get("axis", -1)),),
    infer_fn=_same_infer,
    cost_fn=lambda params, a: Cost(5 * a.size, 3 * a.nbytes),
)


def _np_rmsnorm(params, x, w):
    eps = params.get("eps", 1e-6)
    var = np.mean(np.square(x.astype(np.float32)), axis=-1, keepdims=True)
    return ((x * (1.0 / np.sqrt(var + eps)) * w).astype(x.dtype),)


def _torch_rmsnorm(params, x, w):
    # One registered operator (repro_torch::rmsnorm): the RMSNorm kernel on
    # CUDA, this op's plain formula on the CPU.  The kernel casts x to
    # float32 before the multiply; the formula multiplies the uncast x.
    # Inside a unit x is float32 (the canonical 32-bit dtypes), where the
    # two are the same.
    return (library.rmsnorm(x, w, float(params.get("eps", 1e-6))),)


register(
    "rmsnorm",
    numpy_fn=_np_rmsnorm,
    torch_fn=_torch_rmsnorm,
    infer_fn=lambda params, x, w: (x,),
    cost_fn=lambda params, x, w: Cost(5 * x.size, 3 * x.nbytes),
)


def _np_layernorm(params, x, w, b):
    eps = params.get("eps", 1e-5)
    xf = x.astype(np.float32)
    mu = np.mean(xf, axis=-1, keepdims=True)
    var = np.mean(np.square(xf - mu), axis=-1, keepdims=True)
    return (((xf - mu) / np.sqrt(var + eps) * w + b).astype(x.dtype),)


def _torch_layernorm(params, x, w, b):
    eps = params.get("eps", 1e-5)
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return (((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype),)


register(
    "layernorm",
    numpy_fn=_np_layernorm,
    torch_fn=_torch_layernorm,
    infer_fn=lambda params, x, w, b: (x,),
    cost_fn=lambda params, x, w, b: Cost(8 * x.size, 3 * x.nbytes),
)


# ---------------------------------------------------------------------------
# linear algebra / attention / embedding
# ---------------------------------------------------------------------------

def _matmul_infer(params, a: AVal, b: AVal):
    # batched matmul with numpy semantics: (..., m, k) @ (..., k, n)
    if len(a.shape) < 2 or len(b.shape) < 2:
        raise ValueError("matmul needs rank>=2")
    m, k = a.shape[-2], a.shape[-1]
    k2, n = b.shape[-2], b.shape[-1]
    if k != k2:
        raise ValueError(f"matmul contraction mismatch {a.shape} @ {b.shape}")
    batch = np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    dtype = np.result_type(np.dtype(a.dtype), np.dtype(b.dtype)).name
    return (AVal(tuple(batch) + (m, n), dtype),)


def _matmul_cost(params, a: AVal, b: AVal):
    out = _matmul_infer(params, a, b)[0]
    k = a.shape[-1]
    return Cost(flops=2 * out.size * k, bytes=a.nbytes + b.nbytes + out.nbytes)


register(
    "matmul",
    numpy_fn=lambda params, a, b: (np.matmul(a, b),),
    torch_fn=lambda params, a, b: (torch.matmul(*_promote(a, b)),),
    infer_fn=_matmul_infer,
    cost_fn=_matmul_cost,
)


def _np_embed(params, table, ids):
    return (table[ids],)


def _torch_embed(params, table, ids):
    rows = torch.index_select(table, 0, ids.reshape(-1))
    return (rows.reshape(tuple(ids.shape) + (table.shape[-1],)),)


register(
    "embed",
    numpy_fn=_np_embed,
    torch_fn=_torch_embed,
    infer_fn=lambda params, t, i: (AVal(i.shape + (t.shape[-1],), t.dtype),),
    cost_fn=lambda params, t, i: Cost(0, i.size * t.shape[-1] * 4),
)


def _sdpa_infer(params, q: AVal, k: AVal, v: AVal):
    # q: (B, Hq, T, D), k/v: (B, Hk, S, D)
    return (AVal(q.shape[:-1] + (v.shape[-1],), q.dtype),)


def _sdpa_cost(params, q, k, v):
    B, H, T, D = q.shape
    S = k.shape[-2]
    flops = 2 * B * H * T * S * D * 2  # qk + av
    return Cost(flops=flops, bytes=q.nbytes + k.nbytes + v.nbytes + q.nbytes)


def _np_sdpa(params, q, k, v):
    causal = params.get("causal", True)
    B, Hq, T, D = q.shape
    Hk = k.shape[1]
    if Hq != Hk:  # GQA: repeat kv heads
        k = np.repeat(k, Hq // Hk, axis=1)
        v = np.repeat(v, Hq // Hk, axis=1)
    scale = params.get("scale", 1.0 / math.sqrt(D))
    s = np.matmul(q.astype(np.float32), np.swapaxes(k, -1, -2).astype(np.float32)) * scale
    S = k.shape[2]
    if causal:
        mask = np.tril(np.ones((T, S), dtype=bool), k=S - T)
        s = np.where(mask, s, np.float32(-1e30))
    m = np.max(s, axis=-1, keepdims=True)
    e = np.exp(s - m)
    p = e / np.sum(e, axis=-1, keepdims=True)
    return (np.matmul(p, v.astype(np.float32)).astype(q.dtype),)


def _torch_sdpa(params, q, k, v):
    causal = params.get("causal", True)
    if q.device.type == "cuda":
        # The flash kernel masks kpos <= qpos (top-left); this op masks
        # tril(k=S-T) (bottom-right).  They agree only when T == S or when
        # not causal, so anything else is refused rather than run plain.
        T, S = q.shape[2], k.shape[2]
        if causal and T != S:
            raise ValueError(
                f"causal sdpa with T={T} != S={S} has no kernel on the "
                f"card: the flash kernel's causal mask is top-left aligned")
        q, k, v = (_last_axis_dense(t) for t in (q, k, v))
    scale = params.get("scale")
    # one registered operator (repro_torch::flash_attention): the flash
    # kernel on CUDA, the plain formula on the CPU
    return (library.flash_attention(q, k, v, bool(causal),
                                    None if scale is None else float(scale)),)


def _last_axis_dense(t):
    return t if t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous()


register(
    "sdpa",
    numpy_fn=_np_sdpa,
    torch_fn=_torch_sdpa,
    infer_fn=_sdpa_infer,
    cost_fn=_sdpa_cost,
)


def _paged_attention_infer(params, q, kn, vn, kp, vp, tables, lengths):
    # q/kn/vn: (B, D); kp/vp: (P, ps, D); tables: (B, NP); lengths: (B,)
    return (AVal(q.shape, q.dtype),)


def _paged_attention_cost(params, q, kn, vn, kp, vp, tables, lengths):
    # Static worst case: every table slot live.  The *realized* FLOPs scale
    # with live pages (the kernel skips dead ones) — DecodeReport's
    # pages_visited/pages_skipped counters carry the realized number.
    B, D = q.shape
    window = tables.shape[1] * kp.shape[1] + 1
    return Cost(flops=2 * B * window * D * 2,
                bytes=q.nbytes + kp.nbytes + vp.nbytes + q.nbytes)


def _np_paged_attention(params, q, kn, vn, kp, vp, tables, lengths):
    from ..kernels.ref import paged_decode_attention_ref
    out = paged_decode_attention_ref(q, kp, vp, tables, lengths, kn, vn)
    return (out.astype(q.dtype),)


def _torch_paged_attention(params, q, kn, vn, kp, vp, tables, lengths):
    return (library.paged_decode_attention(q, kp, vp, tables, lengths, kn, vn),)


register(
    "paged_attention",
    numpy_fn=_np_paged_attention,
    torch_fn=_torch_paged_attention,
    infer_fn=_paged_attention_infer,
    cost_fn=_paged_attention_cost,
)


def _np_rope(params, x):
    # x: (B, H, T, D); rotate-half RoPE with base theta
    theta = params.get("theta", 10000.0)
    pos0 = params.get("pos0", 0)
    B, H, T, D = x.shape
    inv = 1.0 / (theta ** (np.arange(0, D, 2, dtype=np.float32) / D))
    t = np.arange(pos0, pos0 + T, dtype=np.float32)
    ang = np.outer(t, inv)  # (T, D/2)
    cos, sin = np.cos(ang), np.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = np.empty_like(x)
    out[..., 0::2] = x1 * cos - x2 * sin
    out[..., 1::2] = x1 * sin + x2 * cos
    return (out.astype(x.dtype),)


def _torch_rope(params, x):
    theta = params.get("theta", 10000.0)
    pos0 = params.get("pos0", 0)
    B, H, T, D = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, **f32) / D))
    t = torch.arange(pos0, pos0 + T, **f32)
    ang = torch.outer(t, inv)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    even = x1 * cos - x2 * sin
    odd = x1 * sin + x2 * cos
    out = torch.stack([even, odd], dim=-1).reshape(x.shape)
    return (out.to(x.dtype),)


register(
    "rope",
    numpy_fn=_np_rope,
    torch_fn=_torch_rope,
    infer_fn=_same_infer,
    cost_fn=lambda params, a: Cost(6 * a.size, 2 * a.nbytes),
)

register(
    "fft",
    numpy_fn=lambda params, x: (np.fft.fftn(x, axes=params.get("axes")).astype(np.complex64),),
    torch_fn=lambda params, x: (
        torch.fft.fftn(x, dim=params.get("axes")).to(torch.complex64),),
    infer_fn=lambda params, a: (AVal(a.shape, "complex64"),),
    cost_fn=lambda params, a: Cost(int(5 * a.size * max(1, math.log2(max(a.size, 2)))), 4 * a.nbytes),
)

register(
    "ifft",
    numpy_fn=lambda params, x: (np.fft.ifftn(x, axes=params.get("axes")).astype(np.complex64),),
    torch_fn=lambda params, x: (
        torch.fft.ifftn(x, dim=params.get("axes")).to(torch.complex64),),
    infer_fn=lambda params, a: (AVal(a.shape, "complex64"),),
    cost_fn=lambda params, a: Cost(int(5 * a.size * max(1, math.log2(max(a.size, 2)))), 4 * a.nbytes),
)

register(
    "sort",
    numpy_fn=lambda params, x: (np.sort(x, axis=params.get("axis", -1)),),
    torch_fn=lambda params, x: (torch.sort(x, dim=params.get("axis", -1)).values,),
    infer_fn=_same_infer,
    cost_fn=lambda params, a: Cost(
        int(a.size * max(1, math.log2(max(a.size, 2)))), 2 * a.nbytes
    ),
)

register(
    "cumsum",
    numpy_fn=lambda params, x: (np.cumsum(x, axis=params.get("axis", -1)).astype(x.dtype),),
    torch_fn=lambda params, x: (torch.cumsum(x, dim=params.get("axis", -1)).to(x.dtype),),
    infer_fn=_same_infer,
    cost_fn=lambda params, a: Cost(a.size, 2 * a.nbytes),
)

register(
    "real",
    numpy_fn=lambda params, x: (np.real(x).astype(np.float32),),
    torch_fn=lambda params, x: (torch.real(x).to(torch.float32),),
    infer_fn=lambda params, a: (AVal(a.shape, "float32"),),
)


# ---------------------------------------------------------------------------
# host-only ops (the "ISA-specific" code: cannot be offloaded)
# ---------------------------------------------------------------------------

_HOST_LOG: list[str] = []  # captured host_print output (tests/benchmarks inspect it)
PY_FUNCS: dict[str, Callable] = {}  # registry for py_call ("unavailable dependency")


def host_log() -> list[str]:
    return _HOST_LOG


def _np_host_print(params, x):
    # The paper's motivating example: a rarely-triggered printf safety check.
    threshold = params.get("threshold", None)
    if threshold is None or bool(np.any(np.abs(x) > threshold)):
        _HOST_LOG.append(params.get("fmt", "host_print: {}").format(np.asarray(x).ravel()[:4]))
    return (x,)


register(
    "host_print",
    numpy_fn=_np_host_print,
    torch_fn=None,  # host-only: blocks offloading (until PFO)
    infer_fn=_same_infer,
    cost_fn=lambda params, a: Cost(0, a.nbytes),
)


def _np_host_assert_finite(params, x):
    if not np.all(np.isfinite(x)):
        raise FloatingPointError(f"host_assert_finite failed in {params.get('tag', '?')}")
    return (x,)


register(
    "host_assert_finite",
    numpy_fn=_np_host_assert_finite,
    torch_fn=None,
    infer_fn=_same_infer,
    cost_fn=lambda params, a: Cost(a.size, a.nbytes),
)


def _np_py_call(params, *xs):
    fn = PY_FUNCS[params["fn"]]
    out = fn(*xs)
    return out if isinstance(out, tuple) else (out,)


def _py_call_infer(params, *avals):
    out = params["out_avals"]
    return tuple(AVal(tuple(s), d) for s, d in out)


register(
    "py_call",
    numpy_fn=_np_py_call,
    torch_fn=None,  # arbitrary python — the "missing middleware library"
    infer_fn=_py_call_infer,
    cost_fn=lambda params, *avals: Cost(0, sum(a.nbytes for a in avals)),
    nout=-1,  # variable, from out_avals
)
