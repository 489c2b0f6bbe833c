"""Shared model building blocks of the port (functional, plain dicts of tensors).

The functions the model families use, with the reference package's
signatures and layouts (``models/layers.py`` there): activations (B,T,D),
projections (B,T,H,hd), caches (B,S,Hkv,hd), heads laid out by
:mod:`.attention_plan`.  Parameters are float32 masters, cast to the
activations' dtype at each use, where the reference casts them.

On the card the norms and the attention cores run the port's hand-written
kernels through :mod:`repro_torch.kernels.ops`: ``rmsnorm`` the RMSNorm
kernel, ``attention_full`` the flash-attention kernel (which tiles the query
axis itself, so the reference's query blocking, there for TPU memory, has
no counterpart) and ``attention_decode`` the flash-decode kernel.  On the
CPU the same calls take the kernels' plain versions.  ``layernorm`` and
``attention_decode`` over an int8 cache are plain PyTorch on both, as the
reference has them in ``jnp``.

Under autograd (grad enabled and an input that requires grad, as in a
train step) ``rmsnorm`` and ``attention_full`` take the differentiable
routes instead: ``RMSNormFn`` (the same forward kernel, a float32 backward)
and ``FlashAttentionFn`` (the forward-with-statistics, dQ and dK/dV
kernels).  Otherwise they take the forward-only kernels, whose outputs
carry no gradient.  Both routes are kernels on the card; the choice follows
autograd's state, not the device.

**Tensor parallelism.**  Inside a step whose mesh has a ``model`` axis of
more than one rank (:func:`~repro_torch.parallel.sharding.tensor_parallel`),
each rank holds its shards by ``param_pspec``'s layout and these blocks do
the communication the reference leaves to XLA's partitioner: attention is
column-parallel over the local heads (``wq``/``wk``/``wv``) and row-parallel
in ``wo``, the MLP column-parallel in ``wg``/``wu`` and row-parallel in
``wd``, each followed by a psum; the vocab-sharded ``table`` embeds by a
masked local lookup and a psum and unembeds to this rank's slice of the
logits.  The activations between blocks are replicated over ``model``:
each block's input enters it with ``spmd.enter`` (its cotangent psummed)
and its output leaves by ``spmd.psum_replicated``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.common import records_grad
from ..parallel import sharding as shd
from ..parallel import spmd
from .attention_plan import HeadPlan, plan_heads

DEFAULT_TP = 16
PARAM_DTYPE = torch.float32    # master params; compute casts to bf16


def _tp_in(x):
    """A block's input, replicated over ``model``, under tensor parallelism."""
    return spmd.enter(x, "model") if shd.tensor_parallel() else x


def _tp_out(y):
    """A row-parallel block's partial output summed over ``model``."""
    return spmd.psum_replicated(y, "model") if shd.tensor_parallel() else y


def _init(gen: torch.Generator, shape, device: torch.device, scale=None,
          dtype=PARAM_DTYPE):
    """Normal(0, scale^2) with scale 1/sqrt(shape[0]) by default, drawn from
    ``gen`` on the generator's device (the meta device needs none)."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0] if shape else 1)
    where = device if device.type == "meta" else gen.device
    x = torch.randn(tuple(shape), generator=gen, device=where, dtype=torch.float32)
    return (x * scale).to(dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    # float32 statistics times float32(scale), as the reference's promotion
    # of a bf16 scale does in a train step
    x, w = x.contiguous(), scale.to(torch.float32)
    if records_grad(x, w):
        return ops.rmsnorm_trainable(x, w, eps=eps)
    return ops.rmsnorm(x, w, eps=eps)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def init_norm(d, kind="rmsnorm", *, device):
    p = {"scale": torch.ones((d,), dtype=PARAM_DTYPE, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), dtype=PARAM_DTYPE, device=device)
    return p


def apply_norm(p, x, kind="rmsnorm"):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_tables(positions, head_dim, theta):
    """cos/sin tables for given integer positions (any shape)."""
    f32 = dict(dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, **f32) / head_dim))
    ang = positions.to(torch.float32)[..., None] * inv     # (..., hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., T, H, hd); cos/sin: (T, hd/2) broadcastable."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    c = cos[..., :, None, :]              # broadcast over the head axis
    s = sin[..., :, None, :]
    even = x1 * c - x2 * s
    odd = x1 * s + x2 * c
    return torch.stack([even, odd], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (head-planned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    plan: HeadPlan
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True

    @classmethod
    def make(cls, d_model, n_heads, n_kv_heads, head_dim, *, tp=DEFAULT_TP,
             qkv_bias=False, rope_theta=10000.0, causal=True):
        return cls(d_model, plan_heads(n_heads, n_kv_heads, tp), head_dim,
                   qkv_bias, rope_theta, causal)


def init_attention(gen, dims: AttnDims, *, device):
    plan = dims.plan
    hd = dims.head_dim
    # padded q slots: zero-init pad columns (and their W_o rows) so pads are inert
    pad_mask = torch.tensor([1.0 if q >= 0 else 0.0 for q in plan.q_slot_to_orig],
                            dtype=torch.float32, device=device)
    p = {
        "wq": _init(gen, (dims.d_model, plan.n_q_pad, hd), device) * pad_mask[None, :, None],
        "wk": _init(gen, (dims.d_model, plan.n_kv_phys, hd), device),
        "wv": _init(gen, (dims.d_model, plan.n_kv_phys, hd), device),
        "wo": _init(gen, (plan.n_q_pad, hd, dims.d_model), device) * pad_mask[:, None, None],
    }
    if dims.qkv_bias:
        zeros = lambda *s: torch.zeros(s, dtype=PARAM_DTYPE, device=device)  # noqa: E731
        p["bq"] = zeros(plan.n_q_pad, hd)
        p["bk"] = zeros(plan.n_kv_phys, hd)
        p["bv"] = zeros(plan.n_kv_phys, hd)
    return p


def _qkv(p, dims: AttnDims, x, positions, *, kv: bool = True):
    """x: (B,T,D) -> q (B,T,Hq,hd), k/v (B,T,Hkv,hd), rope applied (k and v
    None unless ``kv``)."""
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(x.dtype))
    k = torch.einsum("btd,dhk->bthk", x, p["wk"].to(x.dtype)) if kv else None
    v = torch.einsum("btd,dhk->bthk", x, p["wv"].to(x.dtype)) if kv else None
    if dims.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        if kv:
            k = k + p["bk"].to(x.dtype)
            v = v + p["bv"].to(x.dtype)
    if dims.rope_theta > 0:
        cos, sin = rope_tables(positions, dims.head_dim, dims.rope_theta)
        q = apply_rope(q, cos, sin)
        if kv:
            k = apply_rope(k, cos, sin)
    return q, k, v


def attention_full(p, dims: AttnDims, x, *, kv_override=None):
    """Full-sequence attention (training / prefill).  Returns (out, (k, v)).

    The core is the flash-attention kernel on (B,H,T,hd) views of the
    projections (no copy: the kernel reads strides), or under autograd the
    trainable one (forward with statistics, dQ and dK/dV kernels).  Its
    causal mask is top-left aligned, which is the reference's mask here
    because q and k cover the same T positions.  ``kv_override`` (k, v),
    each (B,S,Hkv,hd), is cross-attention: the keys and values are those
    (the encoder memory's, S free), unmasked, and x gives the queries only.
    """
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)
    x = _tp_in(x)
    q, k, v = _qkv(p, dims, x, positions, kv=kv_override is None)
    if kv_override is not None:
        k, v = kv_override
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    attend = ops.flash_attention_trainable if records_grad(qh, kh, vh) \
        else ops.flash_attention
    o = attend(qh, kh, vh, causal=dims.causal and kv_override is None)
    out = torch.einsum("bthk,hkd->btd", o.transpose(1, 2), p["wo"].to(x.dtype))
    return _tp_out(out), (k, v)


def quantize_kv(x):
    """Per-(token, head) symmetric int8 quantization: (vals_i8, scales_f32).

    x: (..., hd) -> int8 of x's shape + a float32 scale with hd reduced to
    1.  ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
    values equal the reference's bitwise.
    """
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def _seq_slice(cache, pos):
    """Under a split sequence (:func:`~repro_torch.parallel.sharding.cache_seq_axes`):
    this rank's slice of a (B,S,...) cache holds positions [lo, lo + S_loc);
    returns (axes, the local index of ``pos`` clamped into the slice, whether
    the slice holds it, ``pos`` as the slice's last visible row clamped to
    [-1, S_loc - 1]), all on the device; None without a split."""
    axes = shd.cache_seq_axes()
    if axes is None:
        return None
    S_loc = cache.shape[1]
    local = pos.reshape(1).to(torch.long) - spmd.axis_index(axes) * S_loc
    mine = (local >= 0) & (local < S_loc)
    return (axes, local.clamp(0, S_loc - 1), mine,
            local.clamp(-1, S_loc - 1).to(torch.int32))


def _write_row(cache, row, pos, where):
    """Write the new (B,1,...) ``row`` into ``cache`` at ``pos``, in place.
    Under a split sequence (``where`` from :func:`_seq_slice`) only the rank
    whose slice holds ``pos`` changes its cache: every rank writes, at the
    clamped local index, either the new row or the row already there, so no
    rank reads ``pos`` on the host."""
    if where is None:
        cache.index_copy_(1, pos.reshape(1).to(torch.long), row.to(cache.dtype))
        return
    _, at, mine, _ = where
    old = cache.index_select(1, at)
    cache.index_copy_(1, at, torch.where(mine, row.to(cache.dtype), old))


def fold_partials(o, lse, axes):
    """The attention over a cache split across the ranks of ``axes`` from
    each rank's attention over its slice: o (B,H,1,d), lse (B,H) float32
    (``-inf`` for a slice with nothing visible).  M = pmax(lse); each
    partial weighs exp(lse - M); o = psum(w o) / psum(w), one all-reduce of
    the packed sums; exact zeros where nothing is visible anywhere.  This is
    the fold the flash-decode kernel's split body does across a cluster's
    blocks."""
    M = spmd.pmax(lse, axes)
    w = torch.exp(lse - torch.where(torch.isfinite(M), M, torch.zeros_like(M)))
    packed = torch.cat([o.to(torch.float32).reshape(*lse.shape, -1) * w[..., None],
                        w[..., None]], dim=-1)
    packed = spmd.psum(packed, axes)
    num, den = packed[..., :-1], packed[..., -1:]
    out = torch.where(den > 0, num / torch.where(den > 0, den, torch.ones_like(den)),
                      torch.zeros_like(num))
    return out.reshape(o.shape).to(o.dtype)


def decode_attend(qh, kh, vh, pos, where=None):
    """The flash-decode core: q (B,Hq,1,hd) against cache views k, v
    (B,Hkv,S,hd), keys at positions <= ``pos`` visible.  Under a split
    sequence (``where`` from :func:`_seq_slice`, the cache's slices on the
    ranks of its axes) each rank runs the kernel over its slice at its local
    ``pos``, with q in float32 so that its partial o is rounded once, after
    :func:`fold_partials`."""
    if where is None:
        return ops.decode_attention(qh, kh, vh, pos)
    axes, _, _, lpos = where
    o, lse = ops.decode_attention(qh.to(torch.float32), kh, vh, lpos, return_lse=True)
    return fold_partials(o, lse, axes).to(qh.dtype)


def attention_decode(p, dims: AttnDims, x1, cache_k, cache_v, pos,
                     cache_k_scale=None, cache_v_scale=None):
    """Single-token decode against a KV cache.

    x1: (B,1,D); cache_k/v: (B,S,Hkv,hd); pos: int32 0-d tensor on the
    cache's device (current length).  The new token's k/v row is written
    into the caches **in place** at ``pos`` (the reference returns updated
    copies of a donated buffer); returns (out, cache_k, cache_v).  The core
    is the flash-decode kernel, reading the cache through a (B,Hkv,S,hd)
    view; it reads ``pos`` on the device, so a step needs no host sync.

    Under a split sequence (a decode step at a global batch of 1 on several
    data ranks, ``sharding.cache_seq_axes``) each rank's caches hold a
    contiguous slice of the positions: only the slice holding ``pos`` takes
    the new row (:func:`_write_row`), each rank attends over its slice and
    the ranks fold their partials (:func:`decode_attend`).

    With ``cache_*_scale`` (B,S,Hkv,1) the cache is int8 (per token and head
    scales, :func:`quantize_kv`): the new row is quantized and written with
    its scales, in place, and the cache is dequantized on the fly in plain
    PyTorch, as the reference does in ``jnp`` (the flash-decode kernel reads
    float32 and bf16 caches); returns (out, cache_k, cache_v, cache_k_scale,
    cache_v_scale).
    """
    q, k1, v1 = _qkv(p, dims, _tp_in(x1), pos.reshape(1))
    where = _seq_slice(cache_k, pos)
    if cache_k_scale is None:
        _write_row(cache_k, k1, pos, where)
        _write_row(cache_v, v1, pos, where)
        o = decode_attend(q.transpose(1, 2), cache_k.transpose(1, 2),
                          cache_v.transpose(1, 2), pos, where)      # (B,Hq,1,hd)
        out = torch.einsum("bthk,hkd->btd", o.transpose(1, 2), p["wo"].to(x1.dtype))
        return _tp_out(out), cache_k, cache_v
    for cache, scales, row in ((cache_k, cache_k_scale, k1), (cache_v, cache_v_scale, v1)):
        vals, s = quantize_kv(row)
        _write_row(cache, vals, pos, where)
        _write_row(scales, s, pos, where)
    B, S, n_kv = x1.shape[0], cache_k.shape[1], cache_k.shape[2]
    hd = dims.head_dim
    f32 = torch.float32
    qh = q.reshape(B, n_kv, q.shape[2] // n_kv, hd) * (1.0 / math.sqrt(hd))
    k_eff = dequantize_kv(cache_k, cache_k_scale, f32)
    v_eff = dequantize_kv(cache_v, cache_v_scale, f32)
    s = torch.einsum("bhgd,bshd->bhgs", qh.to(f32), k_eff)
    last = pos if where is None else where[3]
    valid = torch.arange(S, device=x1.device) <= last
    if where is None:
        w = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
        o = torch.einsum("bhgs,bshd->bhgd", w, v_eff).to(x1.dtype)
    else:
        s = torch.where(valid, s, -math.inf)
        lse = torch.logsumexp(s, dim=-1)                      # -inf: an empty slice
        w = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
        o = torch.einsum("bhgs,bshd->bhgd", w, v_eff)
        o = fold_partials(o.reshape(B, -1, 1, hd), lse.reshape(B, -1), where[0]).to(x1.dtype)
    o = o.reshape(B, 1, q.shape[2], hd)
    out = torch.einsum("bthk,hkd->btd", o, p["wo"].to(x1.dtype))
    return _tp_out(out), cache_k, cache_v, cache_k_scale, cache_v_scale


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model, d_ff, gated=True, *, device):
    # drawn in the reference's key order: wg, wu, then wd
    p = {}
    if gated:
        p["wg"] = _init(gen, (d_model, d_ff), device)
    p["wu"] = _init(gen, (d_model, d_ff), device)
    p["wd"] = _init(gen, (d_ff, d_model), device)
    return p


_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "relu": F.relu,
}


def apply_mlp(p, x, act="silu", gated=True):
    actf = _ACTS[act]
    x = _tp_in(x)
    if gated:
        h = actf(x @ p["wg"].to(x.dtype)) * (x @ p["wu"].to(x.dtype))
    else:
        h = actf(x @ p["wu"].to(x.dtype))
    return _tp_out(h @ p["wd"].to(x.dtype))


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def init_embed(gen, vocab_padded, d_model, *, device):
    return {"table": _init(gen, (vocab_padded, d_model), device, scale=0.02)}


def vocab_offset(table) -> int:
    """The first vocabulary row of this rank's ``table`` shard (0 without
    tensor parallelism)."""
    return spmd.axis_index("model") * table.shape[0] if shd.tensor_parallel() else 0


def embed(p, ids):
    table = p["table"]
    if not shd.tensor_parallel():
        return table[ids]
    # vocab-sharded: look up the ids this rank holds, zeros elsewhere, psum
    local = ids - vocab_offset(table)
    hit = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return _tp_out(torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype)))


def embed_in(cfg, p, ids):
    """Embedding lookup cast to the model's compute dtype (bf16 by default).
    The reference also pins a batch sharding here; each rank holds its batch
    shard already."""
    return embed(p, ids).to(getattr(torch, cfg.compute_dtype))


def unembed(p_head, x, vocab_padded):
    """Logits over the (padded) vocabulary; under tensor parallelism this
    rank's slice of them, from its ``table`` shard (see
    :func:`vocab_offset`)."""
    return _tp_in(x) @ p_head["table"].to(x.dtype).T  # tied or separate head table
