"""VLM backbone (phi-3-vision-4.2b): phi3-mini decoder + CLIP patch stub (the port).

The port of the reference's ``models/vlm.py``.  The CLIP vision tower is a
stub there and here: the caller supplies precomputed patch embeddings
``(B, n_patches, D_PATCH)``; a learned projection maps them into the LM's
embedding space and they are prepended to the token embeddings.  Logits
are the text positions'.  Everything past the fusion is :mod:`.dense`'s:
the cache covers patches and text, a decode step is a dense one.

Under tensor parallelism ``patch_proj`` is split by its output columns
(``P(None, "model")``): each rank projects the patches to its slice of the
embedding, and the slices are gathered across ``model`` before they join
the token stream (``spmd.gather_replicated``, whose backward keeps the
rank's slice of the cotangent).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..parallel import sharding as shd
from ..parallel import spmd
from . import dense
from . import layers as L

D_PATCH = 1024  # CLIP ViT-L/14 output width (stubbed)


def init(cfg: ModelConfig, gen: torch.Generator, tp: int = L.DEFAULT_TP, *,
         device: torch.device):
    params = dense.init(cfg, gen, tp, device=device)
    params["patch_proj"] = L._init(gen, (D_PATCH, cfg.d_model), device)
    return params


def _fuse(cfg: ModelConfig, params, tokens, patches):
    patches = patches.to(getattr(torch, cfg.compute_dtype))
    pe = patches @ params["patch_proj"].to(patches.dtype)       # (B,P,D)
    if shd.tensor_parallel():
        pe = spmd.gather_replicated(pe, "model", 2)
    te = L.embed_in(cfg, params["embed"], tokens)               # (B,T,D)
    return torch.cat([pe.to(te.dtype), te], dim=1)


def logits_fn(cfg: ModelConfig, params, tokens, patches, *, tp: int = L.DEFAULT_TP):
    """tokens (B,T) + patches (B,P,D_PATCH) -> text-position logits (B,T,Vp)."""
    h = _fuse(cfg, params, tokens, patches)
    h = dense.backbone(cfg, params, h, tp=tp)
    head = params.get("head", params["embed"])
    return L.unembed(head, h[:, cfg.n_patches:, :], cfg.padded_vocab())


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, tp: int = L.DEFAULT_TP,
               dtype=torch.float32, device: torch.device):
    # the cache covers patches + text
    return dense.init_cache(cfg, batch, max_len + cfg.n_patches, tp=tp, dtype=dtype,
                            device=device)


def prefill(cfg: ModelConfig, params, tokens, patches, cache, *, tp: int = L.DEFAULT_TP):
    """Fill the cache with the patches and the prompt (``pos`` = P + T), in
    place; returns (last-token logits (B,1,Vp), cache)."""
    h = _fuse(cfg, params, tokens, patches)
    return dense.prefill_embedded(cfg, params, h, cache, tp=tp)


def decode_step(cfg: ModelConfig, params, cache, token, *, tp: int = L.DEFAULT_TP):
    return dense.decode_step(cfg, params, cache, token, tp=tp)
