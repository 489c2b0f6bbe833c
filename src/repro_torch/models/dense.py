"""Dense decoder-only transformer LM (qwen2 / llama3 / smollm families).

The port of the reference's ``models/dense.py``: layer parameters are
stacked on a leading L axis, as there, and each ``lax.scan`` over them
becomes a Python loop over the stacked tensors.  Attention heads follow the
head plan (see attention_plan.py) and the vocabulary is padded to a multiple
of 256, so parameter shapes and names equal the reference's.

The KV cache is updated **in place**: ``prefill`` and ``decode_step`` write
into the tensors of the cache they are given and return that same dict
(with ``pos`` advanced), where the reference returns a new cache built from
a donated one.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..parallel import sharding as shd
from . import layers as L
from .layers import AttnDims


def _dims(cfg: ModelConfig, tp: int) -> AttnDims:
    return AttnDims.make(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
        tp=tp, qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta,
    )


def init_layer(cfg: ModelConfig, gen, tp: int, *, device):
    return {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, device=device),
        "attn": L.init_attention(gen, _dims(cfg, tp), device=device),
        "ln2": L.init_norm(cfg.d_model, cfg.norm, device=device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, gated=cfg.act == "silu",
                          device=device),
    }


def stack_layers(trees):
    """Per-layer parameter dicts stacked on a leading L axis, as the
    reference's ``vmap``-ed init lays them out."""
    if isinstance(trees[0], dict):
        return {k: stack_layers([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_params(params, i: int):
    """Layer i's parameters: views into the stacked (L, ...) tensors."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(params["layers"])


def init(cfg: ModelConfig, gen: torch.Generator, tp: int = L.DEFAULT_TP, *,
         device: torch.device):
    layers = [init_layer(cfg, gen, tp, device=device) for _ in range(cfg.n_layers)]
    params = {
        "embed": L.init_embed(gen, cfg.padded_vocab(), cfg.d_model, device=device),
        "layers": stack_layers(layers),
        "ln_f": L.init_norm(cfg.d_model, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.init_embed(gen, cfg.padded_vocab(), cfg.d_model, device=device)
    return params


def _mlp(cfg: ModelConfig, lp, x):
    return L.apply_mlp(lp["mlp"], x, cfg.act, gated=cfg.act == "silu")


def _layer_fwd(cfg: ModelConfig, dims: AttnDims, h, lp, ffn=_mlp):
    """One layer: attention, then ``ffn(cfg, lp, x)`` (the MLP here, the
    routed experts in :mod:`.moe`), each behind its norm and residual.  A
    sharded step's ZeRO/FSDP shards are gathered here, inside the layer
    (``constrain_layer_params``)."""
    lp = shd.constrain_layer_params(lp, cast_to=getattr(torch, cfg.compute_dtype))
    a, kv = L.attention_full(lp["attn"], dims, L.apply_norm(lp["ln1"], h, cfg.norm))
    h = h + a
    return h + ffn(cfg, lp, L.apply_norm(lp["ln2"], h, cfg.norm)), kv


def unstack_layers(params, n_layers: int):
    """Every layer's parameters, views of the stacked (L, ...) tensors taken
    by one ``unbind`` per leaf, so the backward stacks each leaf's layer
    gradients once (the reference's scan writes them into one array)."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else torch.unbind(v)
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    parts = split(params["layers"])
    return [pick(parts, i) for i in range(n_layers)]


def backbone(cfg: ModelConfig, params, h, *, tp: int, ffn=_mlp):
    """Apply all transformer layers to embeddings h: (B,T,D).

    Under autograd, ``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
    scan body): only the layer inputs stay saved."""
    dims = _dims(cfg, tp)

    def layer(h, lp):
        return _layer_fwd(cfg, dims, h, lp, ffn)[0]

    remat = cfg.remat and torch.is_grad_enabled() and h.requires_grad
    for lp in unstack_layers(params, cfg.n_layers):
        if remat:
            h = checkpoint(layer, h, lp, use_reentrant=False)
        else:
            h = layer(h, lp)
    return L.apply_norm(params["ln_f"], h, cfg.norm)


def logits_fn(cfg: ModelConfig, params, tokens, *, tp: int = L.DEFAULT_TP):
    """Teacher-forcing logits: tokens (B,T) -> (B,T,Vp)."""
    h = L.embed_in(cfg, params["embed"], tokens)
    h = backbone(cfg, params, h, tp=tp)
    head = params.get("head", params["embed"])
    return L.unembed(head, h, cfg.padded_vocab())


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, tp: int = L.DEFAULT_TP,
               dtype=torch.float32, quantize: bool = False, device: torch.device):
    """k/v (L,B,max_len,Hkv,hd) in ``dtype``, or with ``quantize`` int8 k/v
    plus their float32 per-token, per-head scales ``ks``/``vs``
    (L,B,max_len,Hkv,1), and ``pos``."""
    dims = _dims(cfg, tp)
    shape = (cfg.n_layers, batch, max_len, dims.plan.n_kv_phys, cfg.head_dim_)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if quantize:
        for key in ("k", "v"):
            cache[key] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[key + "s"] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                           device=device)
        return cache
    for key in ("k", "v"):
        cache[key] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def prefill_embedded(cfg: ModelConfig, params, h, cache, *, tp: int, ffn=_mlp):
    """The prefill of embeddings h (B,T,D): every layer's k/v rows written
    into the cache at 0..T-1 and ``pos`` set to T, in place; returns
    (last-position logits (B,1,Vp), cache)."""
    dims = _dims(cfg, tp)
    T = h.shape[1]
    if "ks" in cache:
        raise ValueError("an int8 cache is filled by decode steps: prefill writes "
                         "unquantized rows")
    if T > cache["k"].shape[2]:
        raise ValueError(f"prompt of {T} tokens exceeds the cache's {cache['k'].shape[2]}")
    for i in range(cfg.n_layers):
        h, (k, v) = _layer_fwd(cfg, dims, h, layer_params(params, i), ffn)
        cache["k"][i, :, :T] = k
        cache["v"][i, :, :T] = v
    h = L.apply_norm(params["ln_f"], h, cfg.norm)
    cache["pos"].fill_(T)
    head = params.get("head", params["embed"])
    return L.unembed(head, h[:, -1:, :], cfg.padded_vocab()), cache


def prefill(cfg: ModelConfig, params, tokens, cache, *, tp: int = L.DEFAULT_TP):
    """Fill the cache with a full prompt, in place; returns (last-token
    logits (B,1,Vp), cache)."""
    h = L.embed_in(cfg, params["embed"], tokens)
    return prefill_embedded(cfg, params, h, cache, tp=tp)


def decode_step(cfg: ModelConfig, params, cache, token, *, tp: int = L.DEFAULT_TP,
                ffn=_mlp):
    """One decode step: token (B,1) int32 -> (logits (B,1,Vp), cache).

    Writes the token's k/v rows at ``cache["pos"]`` and advances it, in place.
    An int8 cache (the scale buffers ``"ks"``/``"vs"`` present, as in the
    reference) takes :func:`~.layers.attention_decode`'s quantized route.
    """
    dims = _dims(cfg, tp)
    h = L.embed_in(cfg, params["embed"], token)
    pos = cache["pos"]
    quant = "ks" in cache
    for i in range(cfg.n_layers):
        lp = shd.constrain_layer_params(layer_params(params, i),
                                        cast_to=getattr(torch, cfg.compute_dtype))
        extra = {} if not quant else {
            "cache_k_scale": cache["ks"][i], "cache_v_scale": cache["vs"][i]}
        a = L.attention_decode(lp["attn"], dims, L.apply_norm(lp["ln1"], h, cfg.norm),
                               cache["k"][i], cache["v"][i], pos, **extra)[0]
        h = h + a
        h = h + ffn(cfg, lp, L.apply_norm(lp["ln2"], h, cfg.norm))
    h = L.apply_norm(params["ln_f"], h, cfg.norm)
    pos += 1
    head = params.get("head", params["embed"])
    return L.unembed(head, h, cfg.padded_vocab()), cache
