"""Step functions of the port: train, prefill and decode.

The reference's ``launch/steps.py`` builds mesh-shardable, jit-ready steps;
the port runs eagerly on one device, so a step is a plain closure over the
config and the head plan, for every family.  The reference's ``mesh``,
``layer_pspecs``, ``batch_axes`` and ``moe_ep`` options wait for
``parallel/`` (ROADMAP Queue 1 item 10): there is one card, and MoE layers
run ``moe_block``, as the reference's do without a mesh.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models import api
from ..optim import AdamWConfig, adamw_update, clip_by_global_norm, cosine_warmup
from ..optim.tree import tree_build, tree_items, tree_map


def cross_entropy(cfg: ModelConfig, logits, labels):
    """Mean NLL in float32, gather-free, as the reference writes it: padded
    vocab entries are masked (not sliced) and the gold logit is picked by an
    ``iota == label`` reduction."""
    lgf = logits.to(torch.float32)
    vocab_ids = torch.arange(lgf.shape[-1], device=lgf.device)
    lgf = torch.where(vocab_ids < cfg.vocab, lgf, -1e30)
    m = torch.amax(lgf, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lgf - m), dim=-1)) + m[..., 0]
    gold = torch.sum(torch.where(vocab_ids == labels[..., None], lgf, 0.0), dim=-1)
    return torch.mean(lse - gold)


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               device=device) for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, params, batch: dict, *, tp: int,
                   microbatch: int = 1):
    """(mean loss, gradients laid out as ``params``) of one batch.

    The float32 masters are cast to ``cfg.compute_dtype`` inside the loss,
    as the reference does, so the gradients reach the float32 leaves through
    the casts.  ``microbatch > 1`` splits the batch into that many
    sequential microbatches and accumulates their gradients in float32
    (a plain loop where the reference scans).  ``params`` are not modified
    and need not require grad.
    """
    names, leaves = zip(*tree_items(params))
    device = leaves[0].device
    batch = _on_device(batch, device)
    dt = getattr(torch, cfg.compute_dtype)
    leaves = [t.detach().requires_grad_() for t in leaves]

    def one(mb):
        cast = tree_map(lambda x: x.to(dt), tree_build(zip(names, leaves)))
        loss = cross_entropy(cfg, api.logits(cfg, cast, mb, tp=tp), mb["labels"])
        return loss.detach(), torch.autograd.grad(loss, leaves)

    if microbatch == 1:
        loss, grads = one(batch)
    else:
        chunks = {k: v.reshape(microbatch, v.shape[0] // microbatch, *v.shape[1:])
                  for k, v in batch.items()}
        grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(microbatch):
            l, g = one({k: v[i] for k, v in chunks.items()})
            grads = [a + b.to(torch.float32) for a, b in zip(grads, g)]
            loss = loss + l
        grads = [g / microbatch for g in grads]
        loss = loss / microbatch
    return loss, tree_build(zip(names, grads))


def make_train_step(
    cfg: ModelConfig,
    *,
    tp: int,
    opt: AdamWConfig | None = None,
    warmup: int = 100,
    total_steps: int = 10_000,
    clip_norm: float = 1.0,
    microbatch: int = 1,
) -> Callable:
    """A train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` of any family: the loss's gradients, clipped to
    ``clip_norm``, then AdamW at the warmup-cosine learning rate.  An encdec
    batch carries ``frames``, a vlm batch ``patches`` (see
    :func:`repro_torch.models.api.make_batch`)."""
    opt = opt or AdamWConfig()

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, tp=tp, microbatch=microbatch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr_scale = cosine_warmup(opt_state["step"] + 1, warmup=warmup, total=total_steps)
        new_params, new_opt = adamw_update(opt, params, grads, opt_state, lr_scale)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale}
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, tp: int) -> Callable:
    def prefill_step(params, batch, cache):
        return api.prefill(cfg, params, batch, cache, tp=tp)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, tp: int) -> Callable:
    def decode_step(params, cache, batch):
        return api.decode(cfg, params, cache, batch, tp=tp)

    return decode_step
