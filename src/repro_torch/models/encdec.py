"""Encoder-decoder backbone (seamless-m4t-large-v2, arXiv:2308.11596): the port.

The port of the reference's ``models/encdec.py``.  The audio frontend is a
stub there and here: the caller supplies precomputed frame embeddings
``(B, S_enc, d_model)``.  A bidirectional encoder, a causal decoder with
cross-attention, LayerNorm (plain PyTorch: the reference has no kernel for
it) and a non-gated ReLU FFN.  Parameter names and shapes equal the
reference's, the layers stacked on a leading L axis.

The encoder's self-attention and the decoder's cross-attention run the
flash kernel unmasked (``causal=False``; the cross-attention at S = S_enc
keys against T queries), the decoder's self-attention the causal one.  A
decode step's cross-attention over the stored encoder keys is the
flash-decode kernel at ``pos = S_enc - 1`` (every key visible: the
reference's unmasked ``jnp`` softmax), its self-attention the flash-decode
kernel as in :mod:`.dense`.

Under autograd ``cfg.remat`` recomputes each encoder and decoder layer in
the backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
of its scan bodies).

**Tensor parallelism**: the encoder's self-attention, the decoder's self-
and cross-attention and the non-gated MLP run on this rank's heads and
columns through :mod:`.layers` (as in :mod:`.dense`); the encoder memory
enters each cross-attention's key and value projections
(``spmd.enter``: its cotangent, partial over the heads, is psummed); the
LayerNorms run replicated; the ``k``, ``v``, ``xk`` and ``xv`` caches hold
the local heads.

The self-attention cache is updated in place, as in :mod:`.dense`.  The
cross caches ``xk``/``xv`` are **replaced** by the prefill with the memory's
projections, as the reference does: their length is the frames', which
need not be ``enc_len_for(max_len)``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..parallel import sharding as shd
from . import layers as L
from .dense import layer_params, stack_layers, unstack_layers
from .layers import AttnDims


def enc_len_for(seq_len: int) -> int:
    return max(128, seq_len // 4)


def _self_dims(cfg: ModelConfig, tp: int, causal: bool) -> AttnDims:
    return AttnDims.make(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
        tp=tp, qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, causal=causal,
    )


def _cross_dims(cfg: ModelConfig, tp: int) -> AttnDims:
    return AttnDims.make(
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
        tp=tp, qkv_bias=cfg.qkv_bias, rope_theta=0.0, causal=False,
    )


def init_enc_layer(cfg: ModelConfig, gen, tp: int, *, device):
    return {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, device=device),
        "attn": L.init_attention(gen, _self_dims(cfg, tp, causal=False), device=device),
        "ln2": L.init_norm(cfg.d_model, cfg.norm, device=device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, gated=False, device=device),
    }


def init_dec_layer(cfg: ModelConfig, gen, tp: int, *, device):
    return {
        "ln1": L.init_norm(cfg.d_model, cfg.norm, device=device),
        "attn": L.init_attention(gen, _self_dims(cfg, tp, causal=True), device=device),
        "lnx": L.init_norm(cfg.d_model, cfg.norm, device=device),
        "xattn": L.init_attention(gen, _cross_dims(cfg, tp), device=device),
        "ln2": L.init_norm(cfg.d_model, cfg.norm, device=device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, gated=False, device=device),
    }


def init(cfg: ModelConfig, gen: torch.Generator, tp: int = L.DEFAULT_TP, *,
         device: torch.device):
    enc = [init_enc_layer(cfg, gen, tp, device=device) for _ in range(cfg.n_enc_layers)]
    dec = [init_dec_layer(cfg, gen, tp, device=device) for _ in range(cfg.n_layers)]
    return {
        "embed": L.init_embed(gen, cfg.padded_vocab(), cfg.d_model, device=device),
        "enc_layers": stack_layers(enc),
        "dec_layers": stack_layers(dec),
        "ln_enc": L.init_norm(cfg.d_model, cfg.norm, device=device),
        "ln_f": L.init_norm(cfg.d_model, cfg.norm, device=device),
    }


def _layers(params, key: str, i: int):
    return layer_params({"layers": params[key]}, i)


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _enc_layer(cfg, dims, lp, h):
    lp = shd.constrain_layer_params(lp, key="enc_layers")
    a, _ = L.attention_full(lp["attn"], dims, L.apply_norm(lp["ln1"], h, cfg.norm))
    h = h + a
    return h + L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], h, cfg.norm), cfg.act,
                           gated=False)


def encode(cfg: ModelConfig, params, frames, *, tp: int = L.DEFAULT_TP):
    """frames: (B, S_enc, D) stubbed frame embeddings -> encoder memory."""
    dims = _self_dims(cfg, tp, causal=False)
    h = frames.to(getattr(torch, cfg.compute_dtype))
    remat = _remat(cfg)
    for lp in unstack_layers({"layers": params["enc_layers"]}, cfg.n_enc_layers):
        if remat:
            h = checkpoint(_enc_layer, cfg, dims, lp, h, use_reentrant=False)
        else:
            h = _enc_layer(cfg, dims, lp, h)
    return L.apply_norm(params["ln_enc"], h, cfg.norm)


def _memory_kv(lp, memory, dtype):
    """The cross-attention's keys and values: the memory's projections
    (B, S_enc, Hkv, hd), no bias and no rotation, as in the reference (this
    rank's heads under tensor parallelism)."""
    memory = L._tp_in(memory)
    km = torch.einsum("bsd,dhk->bshk", memory, lp["xattn"]["wk"].to(dtype))
    vm = torch.einsum("bsd,dhk->bshk", memory, lp["xattn"]["wv"].to(dtype))
    return km, vm


def _dec_layer(cfg, dims_self, dims_x, lp, h, memory):
    """One decoder layer over the memory: (h, self (k, v), cross (k, v))."""
    lp = shd.constrain_layer_params(lp, key="dec_layers")
    a, kv_self = L.attention_full(lp["attn"], dims_self, L.apply_norm(lp["ln1"], h, cfg.norm))
    h = h + a
    hq = L.apply_norm(lp["lnx"], h, cfg.norm)
    kv_mem = _memory_kv(lp, memory, h.dtype)
    x, _ = L.attention_full(lp["xattn"], dims_x, hq, kv_override=kv_mem)
    h = h + x
    m = L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], h, cfg.norm), cfg.act, gated=False)
    return h + m, kv_self, kv_mem


def logits_fn(cfg: ModelConfig, params, tokens, frames, *, tp: int = L.DEFAULT_TP):
    """Teacher-forcing decode over encoder memory: (B,T) + (B,S,D) -> logits."""
    memory = encode(cfg, params, frames, tp=tp)
    dims_s, dims_x = _self_dims(cfg, tp, causal=True), _cross_dims(cfg, tp)
    h = L.embed_in(cfg, params["embed"], tokens)

    def layer(lp, h, memory):
        return _dec_layer(cfg, dims_s, dims_x, lp, h, memory)[0]

    remat = _remat(cfg)
    for lp in unstack_layers({"layers": params["dec_layers"]}, cfg.n_layers):
        if remat:
            h = checkpoint(layer, lp, h, memory, use_reentrant=False)
        else:
            h = layer(lp, h, memory)
    h = L.apply_norm(params["ln_f"], h, cfg.norm)
    return L.unembed(params["embed"], h, cfg.padded_vocab())


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, tp: int = L.DEFAULT_TP,
               dtype=torch.float32, device: torch.device):
    dims = _self_dims(cfg, tp, causal=True)
    enc_len = enc_len_for(max_len)
    shape = (cfg.n_layers, batch, max_len, dims.plan.n_kv_phys, cfg.head_dim_)
    xshape = (cfg.n_layers, batch, enc_len, dims.plan.n_kv_phys, cfg.head_dim_)
    zeros = lambda s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return {"k": zeros(shape), "v": zeros(shape), "xk": zeros(xshape), "xv": zeros(xshape),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg: ModelConfig, params, tokens, frames, cache, *, tp: int = L.DEFAULT_TP):
    """Encode and teacher-force the prompt: the self-attention k/v rows are
    written in place, the cross caches replaced by the memory's
    projections; returns (last-token logits (B,1,Vp), cache)."""
    T = tokens.shape[1]
    if T > cache["k"].shape[2]:
        raise ValueError(f"prompt of {T} tokens exceeds the cache's {cache['k'].shape[2]}")
    memory = encode(cfg, params, frames, tp=tp)
    dims_s, dims_x = _self_dims(cfg, tp, causal=True), _cross_dims(cfg, tp)
    h = L.embed_in(cfg, params["embed"], tokens)
    xks, xvs = [], []
    for i in range(cfg.n_layers):
        h, (k, v), (km, vm) = _dec_layer(cfg, dims_s, dims_x,
                                         _layers(params, "dec_layers", i), h, memory)
        cache["k"][i, :, :T] = k
        cache["v"][i, :, :T] = v
        xks.append(km)
        xvs.append(vm)
    h = L.apply_norm(params["ln_f"], h, cfg.norm)
    cache["xk"] = torch.stack(xks).to(cache["xk"].dtype)
    cache["xv"] = torch.stack(xvs).to(cache["xv"].dtype)
    cache["pos"].fill_(T)
    return L.unembed(params["embed"], h[:, -1:, :], cfg.padded_vocab()), cache


def decode_step(cfg: ModelConfig, params, cache, token, *, tp: int = L.DEFAULT_TP):
    """One decode step: token (B,1) -> (logits (B,1,Vp), cache), the
    self-attention row written at ``pos`` and ``pos`` advanced, in place."""
    dims_s = _self_dims(cfg, tp, causal=True)
    h = L.embed_in(cfg, params["embed"], token)
    pos = cache["pos"]
    S_enc = cache["xk"].shape[2]
    last = torch.full((), S_enc - 1, dtype=torch.int32, device=pos.device)
    for i in range(cfg.n_layers):
        lp = shd.constrain_layer_params(_layers(params, "dec_layers", i), key="dec_layers")
        a, _, _ = L.attention_decode(lp["attn"], dims_s, L.apply_norm(lp["ln1"], h, cfg.norm),
                                     cache["k"][i], cache["v"][i], pos)
        h = h + a
        # cross-attention over the (static) encoder memory's k/v: every key
        # visible, so the flash-decode kernel at pos = S_enc - 1
        hq = L._tp_in(L.apply_norm(lp["lnx"], h, cfg.norm))
        q = torch.einsum("btd,dhk->bthk", hq, lp["xattn"]["wq"].to(h.dtype))
        o = L.decode_attend(q.transpose(1, 2), cache["xk"][i].transpose(1, 2),
                            cache["xv"][i].transpose(1, 2), last,
                            L._seq_slice(cache["xk"][i], last))
        h = h + L._tp_out(torch.einsum("bthk,hkd->btd", o.transpose(1, 2),
                                       lp["xattn"]["wo"].to(h.dtype)))
        m = L.apply_mlp(lp["mlp"], L.apply_norm(lp["ln2"], h, cfg.norm), cfg.act, gated=False)
        h = h + m
    h = L.apply_norm(params["ln_f"], h, cfg.norm)
    pos += 1
    return L.unembed(params["embed"], h, cfg.padded_vocab()), cache
