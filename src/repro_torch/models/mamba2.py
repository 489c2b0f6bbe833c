"""Mamba2 (SSD) blocks + the zamba2-style hybrid backbone (the port).

The port of the reference's ``models/mamba2.py``: a stack of Mamba2 layers
with one *shared* transformer block (attention + MLP) applied every
``shared_attn_every`` layers, after arXiv:2411.15242 (without the
per-invocation LoRA deltas on the shared block, as in the reference).
Parameter names and shapes equal the reference's: the Mamba2 layers are
stacked on a leading L axis and the shared block is the ``shared`` dict.

The SSD sequence mixer runs in its chunked form through
:func:`repro_torch.kernels.ops.ssd_scan` — on the card the hand-written SSD
kernel, which also returns the final state the prefill stores for decode,
so the model makes no second pass and no padded copies.  Under autograd (a
train step) it takes :func:`repro_torch.kernels.ops.ssd_scan_trainable`
instead: the same kernel forward and a chunked float32 backward.  A decode step
advances the state one token with :func:`ssd_decode_step`, plain PyTorch
(the reference has no kernel for it).  The shared block's attention runs the
flash and flash-decode kernels and every norm the RMSNorm kernel, as in
:mod:`.dense`.

**Tensor parallelism** (a step whose mesh has a ``model`` axis of more than
one rank, :func:`~repro_torch.parallel.sharding.tensor_parallel`): each rank
holds ``param_pspec``'s shards, ``w_z``, ``w_x``, ``w_dt``, ``conv``,
``A_log``, ``D`` and ``dt_bias`` split by heads and ``w_out`` by its rows,
and runs the block on its local heads (the SSD scan, row 8, included): the
normed input and the replicated ``w_B``/``w_C`` enter it
(``spmd.enter``: their cotangents, partial over the heads, are psummed),
and ``w_out``'s partial product is psummed.  The caches hold the local
heads' ``S`` and conv channels (``cache_pspecs``).  The shared block runs
:mod:`.layers`' attention and MLP, tensor-parallel as in :mod:`.dense`.

Differences from the reference, each for one card: the ``lax.scan`` over
layer groups is a Python loop, and its ``jax.checkpoint`` (remat) of each
Mamba2 layer is ``torch.utils.checkpoint`` (the shared block is not
rematerialised, as there); the mesh sharding constraints have no
counterpart; the flash kernel tiles the query axis itself, so there is no
``q_block``; and the cache is updated **in place** (``S``, ``conv``, the
``ak``/``av`` rows and ``pos``), where the reference returns a new cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels.common import records_grad
from ..parallel import sharding as shd
from . import layers as L
from .dense import layer_params, stack_layers, unstack_layers
from .layers import AttnDims


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A, B_, C_, chunk: int):
    """Chunked SSD: y[t] = C_t . S_t,  S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T.

    x: (B,T,H,P) head inputs; dt: (B,T,H) positive step sizes (float32);
    A: (H,) negative decay rates; B_, C_: (B,T,N) input and output
    projections (one group, shared across heads).  Returns (y (B,T,H,P) in
    x's dtype, S_final (B,H,N,P) float32).  Under autograd the scan is the
    differentiable one, which keeps no final state: S_final is None.
    """
    if records_grad(x, dt, A, B_, C_):
        return ops.ssd_scan_trainable(x, dt, A, B_, C_, chunk=chunk), None
    return ops.ssd_scan(x, dt, A, B_, C_, chunk=chunk, return_state=True)


def ssd_decode_step(S, x1, dt1, A, B1, C1):
    """Single-token SSD update.

    S: (B,H,N,P) state; x1: (B,H,P); dt1: (B,H); B1, C1: (B,N).
    Returns (y1 (B,H,P) in x1's dtype, S').
    """
    f32 = torch.float32
    dec = torch.exp(dt1 * A)                                          # (B,H)
    upd = torch.einsum("bn,bh,bhp->bhnp", B1.to(f32), dt1, x1.to(f32))
    S2 = S * dec[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", C1.to(f32), S2)
    return y.to(x1.dtype), S2


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _dims_mamba(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    P = ssm.head_dim
    H = d_inner // P
    return d_inner, H, P, ssm.state_dim


def init_mamba_layer(cfg: ModelConfig, gen, *, device):
    d_inner, H, P, N = _dims_mamba(cfg)
    f32 = dict(dtype=L.PARAM_DTYPE, device=device)
    # drawn in the reference's key order
    return {
        "ln": L.init_norm(cfg.d_model, "rmsnorm", device=device),
        "w_z": L._init(gen, (cfg.d_model, d_inner), device),
        "w_x": L._init(gen, (cfg.d_model, d_inner), device),
        "w_B": L._init(gen, (cfg.d_model, N), device),
        "w_C": L._init(gen, (cfg.d_model, N), device),
        "w_dt": L._init(gen, (cfg.d_model, H), device, scale=0.02),
        "conv": L._init(gen, (cfg.ssm.conv_kernel, d_inner), device, scale=0.5),
        "A_log": torch.zeros((H,), **f32),             # A = -exp(A_log) = -1
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "w_out": L._init(gen, (d_inner, cfg.d_model), device),
    }


def _causal_conv(x, w):
    """Depthwise causal conv: x (B,T,C), w (K,C)."""
    K, T = w.shape[0], x.shape[1]
    out = x * w[-1]
    for k in range(1, K):
        shifted = F.pad(x, (0, 0, k, 0))[:, :T, :]
        out = out + shifted * w[-1 - k]
    return out


def _local_dims(cfg: ModelConfig, lp):
    """(d_inner, H) of the heads this rank holds: all of them, or under
    tensor parallelism its shard's (``w_dt``'s columns)."""
    P = _dims_mamba(cfg)[2]
    H = lp["w_dt"].shape[-1]
    return H * P, H


def mamba_block(cfg: ModelConfig, lp, x, *, return_state: bool = False):
    """x: (B,T,D) -> (B,T,D) (optionally also the decode-ready state), on
    this rank's heads under tensor parallelism."""
    lp = shd.constrain_layer_params(lp)
    _, _, P, N = _dims_mamba(cfg)
    d_inner, H = _local_dims(cfg, lp)
    B, T, D = x.shape
    h = L._tp_in(L.apply_norm(lp["ln"], x, "rmsnorm"))
    z = h @ lp["w_z"].to(x.dtype)
    xs_raw = h @ lp["w_x"].to(x.dtype)
    B_ = h @ L._tp_in(lp["w_B"]).to(x.dtype)
    C_ = h @ L._tp_in(lp["w_C"]).to(x.dtype)
    dt = h @ lp["w_dt"].to(x.dtype)
    xs = F.silu(_causal_conv(xs_raw, lp["conv"].to(x.dtype)))
    dt = F.softplus(dt.to(torch.float32) + lp["dt_bias"])
    # in a train step A_log is the compute dtype's, as the reference's (its
    # exp rounds there); dt * A promotes to float32 either way, so the scan
    # takes A in float32
    A = -torch.exp(lp["A_log"]).to(torch.float32)
    xh = xs.reshape(B, T, H, P)
    y, S_final = ssd_chunked(xh, dt, A, B_, C_, cfg.ssm.chunk)
    y = y + xh * lp["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, T, d_inner) * F.silu(z)
    out = x + L._tp_out(y @ lp["w_out"].to(x.dtype))
    if return_state:
        K = cfg.ssm.conv_kernel
        return out, {"S": S_final, "conv": xs_raw[:, T - (K - 1):, :]}
    return out


def mamba_decode(cfg: ModelConfig, lp, state, x1):
    """state: {"S": (B,H,N,P), "conv": (B,K-1,d_inner)}; x1: (B,1,D).

    Returns (out, new state); the caller stores the state.  Types follow the
    reference's promotions: with a float32 conv state, the convolved input
    and everything after it are float32 (``jnp`` promotes bf16 with f32).
    Under tensor parallelism the state and the heads are this rank's.
    """
    lp = shd.constrain_layer_params(lp)
    _, _, P, N = _dims_mamba(cfg)
    d_inner, H = _local_dims(cfg, lp)
    B = x1.shape[0]
    dtype = x1.dtype
    h = L._tp_in(L.apply_norm(lp["ln"], x1, "rmsnorm")[:, 0])
    z = h @ lp["w_z"].to(dtype)
    xs = h @ lp["w_x"].to(dtype)
    B_ = h @ L._tp_in(lp["w_B"]).to(dtype)
    C_ = h @ L._tp_in(lp["w_C"]).to(dtype)
    dt = h @ lp["w_dt"].to(dtype)
    # conv state: (B, K-1, d_inner) of past inputs
    wide = torch.promote_types(state["conv"].dtype, xs.dtype)
    hist = torch.cat([state["conv"].to(wide), xs[:, None, :].to(wide)], dim=1)  # (B,K,dc)
    w = lp["conv"].to(dtype)
    wide = torch.promote_types(wide, w.dtype)
    xs = torch.einsum("bkc,kc->bc", hist.to(wide), w.to(wide))
    new_conv = hist[:, 1:, :]
    xs = F.silu(xs)
    dt1 = F.softplus(dt.to(torch.float32) + lp["dt_bias"])
    A = -torch.exp(lp["A_log"])
    y, S2 = ssd_decode_step(state["S"], xs.reshape(B, H, P), dt1, A, B_, C_)
    y = y + xs.reshape(B, H, P) * lp["D"][None, :, None].to(dtype)
    y = y.reshape(B, 1, d_inner) * F.silu(z)[:, None, :]
    # jnp.matmul promotes mixed operands; torch.matmul refuses them
    w = lp["w_out"].to(dtype)
    wide = torch.promote_types(y.dtype, w.dtype)
    out = x1 + L._tp_out(y.to(wide) @ w.to(wide))
    return out, {"S": S2, "conv": new_conv}


# ---------------------------------------------------------------------------
# zamba2 hybrid backbone: Mamba2 stack + one shared attention/MLP block
# ---------------------------------------------------------------------------

def _attn_dims(cfg: ModelConfig, tp: int) -> AttnDims:
    return AttnDims.make(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
        tp=tp, qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta,
    )


def init(cfg: ModelConfig, gen: torch.Generator, tp: int = L.DEFAULT_TP, *,
         device: torch.device):
    layers = [init_mamba_layer(cfg, gen, device=device) for _ in range(cfg.n_layers)]
    return {
        "embed": L.init_embed(gen, cfg.padded_vocab(), cfg.d_model, device=device),
        "layers": stack_layers(layers),
        "ln_f": L.init_norm(cfg.d_model, "rmsnorm", device=device),
        "shared": {
            "ln1": L.init_norm(cfg.d_model, cfg.norm, device=device),
            "attn": L.init_attention(gen, _attn_dims(cfg, tp), device=device),
            "ln2": L.init_norm(cfg.d_model, cfg.norm, device=device),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, gated=True, device=device),
        },
    }


def _shared_block_full(cfg, sp, h, dims):
    sp = shd.constrain_layer_params(sp, key="shared")
    a, kv = L.attention_full(sp["attn"], dims, L.apply_norm(sp["ln1"], h, cfg.norm))
    h = h + a
    m = L.apply_mlp(sp["mlp"], L.apply_norm(sp["ln2"], h, cfg.norm), "silu", gated=True)
    return h + m, kv


def n_shared_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.ssm.shared_attn_every


def backbone(cfg: ModelConfig, params, h, *, tp: int, cache=None):
    """The Mamba2 groups, each followed by the shared block, then the
    trailing Mamba2 layers and the final norm.  With a ``cache``, every
    layer's SSD state and conv tail and every shared application's k/v rows
    are written into it, in place.  Without one, under autograd,
    ``cfg.remat`` recomputes each Mamba2 layer in the backward (the
    reference's ``jax.checkpoint`` of its scan body)."""
    dims = _attn_dims(cfg, tp)
    k = cfg.ssm.shared_attn_every
    n_groups = n_shared_applications(cfg)
    T = h.shape[1]
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    lps = unstack_layers(params, cfg.n_layers)

    def mamba(i, h):
        lp = lps[i]
        if cache is None:
            if remat:
                return checkpoint(mamba_block, cfg, lp, h, use_reentrant=False)
            return mamba_block(cfg, lp, h)
        h, st = mamba_block(cfg, lp, h, return_state=True)
        cache["S"][i].copy_(st["S"])
        cache["conv"][i].copy_(st["conv"])
        return h

    for g in range(n_groups):
        for i in range(g * k, (g + 1) * k):
            h = mamba(i, h)
        h, (kk, vv) = _shared_block_full(cfg, params["shared"], h, dims)
        if cache is not None:
            cache["ak"][g, :, :T] = kk
            cache["av"][g, :, :T] = vv
    for i in range(n_groups * k, cfg.n_layers):       # trailing mamba layers
        h = mamba(i, h)
    return L.apply_norm(params["ln_f"], h, cfg.norm)


def logits_fn(cfg: ModelConfig, params, tokens, *, tp: int = L.DEFAULT_TP):
    """Teacher-forcing logits: tokens (B,T) -> (B,T,Vp)."""
    h = L.embed_in(cfg, params["embed"], tokens)
    h = backbone(cfg, params, h, tp=tp)
    return L.unembed(params["embed"], h, cfg.padded_vocab())


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, tp: int = L.DEFAULT_TP,
               dtype=torch.float32, device: torch.device):
    d_inner, H, P, N = _dims_mamba(cfg)
    dims = _attn_dims(cfg, tp)
    n_groups = n_shared_applications(cfg)
    kv = (n_groups, batch, max_len, dims.plan.n_kv_phys, cfg.head_dim_)
    return {
        "S": torch.zeros((cfg.n_layers, batch, H, N, P), dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm.conv_kernel - 1, d_inner),
                            dtype=dtype, device=device),
        "ak": torch.zeros(kv, dtype=dtype, device=device),
        "av": torch.zeros(kv, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def prefill(cfg: ModelConfig, params, tokens, cache, *, tp: int = L.DEFAULT_TP):
    """Fill the SSD states, conv tails and shared-attention k/v from a
    prompt, in place; returns (last-token logits (B,1,Vp), cache)."""
    B, T = tokens.shape
    if T > cache["ak"].shape[2]:
        raise ValueError(f"prompt of {T} tokens exceeds the cache's {cache['ak'].shape[2]}")
    if T < cfg.ssm.conv_kernel - 1:
        raise ValueError(f"prompt of {T} tokens is shorter than the conv state's "
                         f"{cfg.ssm.conv_kernel - 1} rows")
    h = L.embed_in(cfg, params["embed"], tokens)
    h = backbone(cfg, params, h, tp=tp, cache=cache)
    cache["pos"].fill_(T)
    return L.unembed(params["embed"], h[:, -1:, :], cfg.padded_vocab()), cache


def decode_step(cfg: ModelConfig, params, cache, token, *, tp: int = L.DEFAULT_TP):
    """One decode step: token (B,1) int32 -> (logits (B,1,Vp), cache).

    Advances every layer's SSD state and conv tail, writes the shared
    block's k/v rows at ``cache["pos"]`` and advances it, all in place.
    """
    dims = _attn_dims(cfg, tp)
    k = cfg.ssm.shared_attn_every
    n_groups = n_shared_applications(cfg)
    h = L.embed_in(cfg, params["embed"], token)
    pos = cache["pos"]

    def mamba(i, h):
        st = {"S": cache["S"][i], "conv": cache["conv"][i]}
        h, st = mamba_decode(cfg, layer_params(params, i), st, h)
        cache["S"][i].copy_(st["S"])
        cache["conv"][i].copy_(st["conv"])
        return h

    for g in range(n_groups):
        for i in range(g * k, (g + 1) * k):
            h = mamba(i, h)
        sp = shd.constrain_layer_params(params["shared"], key="shared")
        a, _, _ = L.attention_decode(sp["attn"], dims, L.apply_norm(sp["ln1"], h, cfg.norm),
                                     cache["ak"][g], cache["av"][g], pos)
        h = h + a
        m = L.apply_mlp(sp["mlp"], L.apply_norm(sp["ln2"], h, cfg.norm), "silu", gated=True)
        h = h + m
    for i in range(n_groups * k, cfg.n_layers):
        h = mamba(i, h)
    h = L.apply_norm(params["ln_f"], h, cfg.norm)
    pos += 1
    return L.unembed(params["embed"], h, cfg.padded_vocab()), cache
