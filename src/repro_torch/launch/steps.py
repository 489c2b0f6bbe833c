"""Step functions of the port: train, prefill and decode.

The reference's ``launch/steps.py`` builds mesh-shardable, jit-ready steps;
the port runs eagerly, so a step is a plain closure over the config and the
head plan, for every family.  Without a mesh it runs on one device.  With
``mesh`` (a :class:`~repro_torch.parallel.spmd.Mesh`, every rank of the
world calling the step) it runs one rank's part of the reference's sharded
step: the step takes the global batch and keeps the rank's slice by
``batch_pspecs``; the parameters (and the cache) are the rank's shards, cut
by :func:`param_layout` (``parallel.sharding.shard_tree``); tensor
parallelism over ``model`` runs in the dense and moe families' layers
(``models/layers.py``), expert parallelism under ``moe_ep``
(``models/moe.py:moe_block_ep``).  Under ``model > 1`` the other families
raise :class:`NotImplementedError` (ROADMAP item 10); with ``model == 1``
they train data-parallel.  The reference's ``layer_pspecs`` and
``batch_axes`` options steer XLA's propagation; per-rank eager code holds
its shards already, so the port's steps do not take them (ROADMAP,
Differences).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import api
from ..optim import AdamWConfig, adamw_update, clip_by_global_norm, cosine_warmup
from ..optim.tree import tree_build, tree_items, tree_map
from ..parallel import sharding as shd
from ..parallel import spmd

TP_FAMILIES = ("dense", "moe")


def cross_entropy(cfg: ModelConfig, logits, labels):
    """Mean NLL in float32, gather-free, as the reference writes it: padded
    vocab entries are masked (not sliced) and the gold logit is picked by an
    ``iota == label`` reduction.  Under tensor parallelism the logits are
    this rank's vocab slice: the max and the sums are reduced across
    ``model``, the form the reference's gather-free loss is written for."""
    lgf = logits.to(torch.float32)
    tp = shd.tensor_parallel()
    lo = spmd.axis_index("model") * lgf.shape[-1] if tp else 0
    vocab_ids = torch.arange(lo, lo + lgf.shape[-1], device=lgf.device)
    lgf = torch.where(vocab_ids < cfg.vocab, lgf, -1e30)
    m = torch.amax(lgf, dim=-1, keepdim=True)
    if tp:
        m = spmd.pmax(m, "model")
    sum_exp = torch.sum(torch.exp(lgf - m), dim=-1)
    gold = torch.sum(torch.where(vocab_ids == labels[..., None], lgf, 0.0), dim=-1)
    if tp:
        sum_exp = spmd.psum_replicated(sum_exp, "model")
        gold = spmd.psum_replicated(gold, "model")
    lse = torch.log(sum_exp) + m[..., 0]
    return torch.mean(lse - gold)


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               device=device) for k, v in batch.items()}


def loss_and_grads(cfg: ModelConfig, params, batch: dict, *, tp: int,
                   microbatch: int = 1, mesh=None, moe_ep: bool = False):
    """(mean loss, gradients laid out as ``params``) of one batch.

    The float32 masters are cast to ``cfg.compute_dtype`` inside the loss,
    as the reference does, so the gradients reach the float32 leaves through
    the casts.  ``microbatch > 1`` splits the batch into that many
    sequential microbatches and accumulates their gradients in float32
    (a plain loop where the reference scans).  ``params`` are not modified
    and need not require grad.

    Under ``mesh`` (every rank calling it) ``batch`` is the global batch and
    ``params`` this rank's shards (:func:`param_layout`): the loss is the
    global mean and the gradients are this rank's shards of its gradient,
    mean-reduced over the data axes once (:func:`_reduce_grads`).
    """
    if mesh is None:
        return _local_loss_and_grads(cfg, params, batch, tp=tp, microbatch=microbatch)
    _check_mesh(cfg, mesh, moe_ep)
    with _step_ctx(mesh, moe_ep):
        batch = local_batch(cfg, mesh, batch, "train")
        loss, grads = _local_loss_and_grads(cfg, params, batch, tp=tp, microbatch=microbatch)
        dp = shd.dp_axes(mesh)
        loss = spmd.psum(loss, dp) / mesh.size(dp)
        return loss, _reduce_grads(mesh, grads, param_layout(cfg, params, moe_ep=moe_ep))


def _local_loss_and_grads(cfg: ModelConfig, params, batch: dict, *, tp: int, microbatch: int):
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


# ---------------------------------------------------------------------------
# sharded steps
# ---------------------------------------------------------------------------

def param_layout(cfg: ModelConfig, params, *, moe_ep: bool = False):
    """The specs a sharded step holds ``params`` (or their optimizer
    moments) by: ``param_pspecs``'s ``tp`` layout, and under ``moe_ep`` the
    experts as ``moe_block_ep`` takes them, ``P(model, data, None)`` for
    ``wg``/``wu`` and ``P(model, None, data)`` for ``wd`` behind the layer
    axis (the reference's shard_map in-specs)."""
    specs = shd.param_pspecs(cfg, params)
    if moe_ep and cfg.family == "moe":
        experts = specs["layers"]["experts"]
        experts["wg"] = experts["wu"] = shd.P(None, "model", "data", None)
        experts["wd"] = shd.P(None, "model", None, "data")
    return specs


def _check_mesh(cfg: ModelConfig, mesh, moe_ep: bool) -> None:
    if mesh.shape.get("model", 1) > 1:
        if cfg.family not in TP_FAMILIES:
            raise NotImplementedError(
                f"tensor parallelism over 'model' is ported for the {TP_FAMILIES} families; "
                f"the {cfg.family} family ({cfg.name}) runs data-parallel on a mesh with "
                f"model == 1 (ROADMAP item 10)")
        if cfg.family == "moe" and not moe_ep:
            raise ValueError(f"{cfg.name}: under a 'model' axis of "
                             f"{mesh.shape['model']} ranks the experts run expert-parallel; "
                             f"pass moe_ep=True")


def _step_ctx(mesh, moe_ep, moe_seq_axis=None):
    if mesh is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(mesh)
    stack.enter_context(shd.activation_sharding(mesh))
    if moe_ep:
        stack.enter_context(shd.moe_ep_context(mesh, moe_seq_axis))
    return stack


def local_batch(cfg: ModelConfig, mesh, batch: dict, kind: str) -> dict:
    """This rank's slice of a global batch, by ``batch_pspecs``."""
    first = next(iter(batch.values()))
    shape = ShapeConfig(kind, kind, int(np.shape(first)[1]), int(np.shape(first)[0]))
    if shape.global_batch == 1 and mesh.size(shd.dp_axes(mesh)) > 1:
        raise NotImplementedError(
            "a global batch of 1 shards the caches' sequence over the data axes "
            "(cache_pspecs); the port does not run sequence-parallel attention")
    tensors = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
               for k, v in batch.items()}
    return shd.shard_tree(mesh, tensors, shd.batch_pspecs(cfg, shape, mesh))


def _reduce_grads(mesh, grads, specs):
    """The global mean's gradients from this rank's: each leaf summed over
    the data axes that do not shard it (one all-reduce per set of axes, the
    leaves flattened into one buffer), then divided by the number of data
    ranks.  A leaf sharded over a data axis was gathered over it inside its
    layer, whose backward summed it there already."""
    dp = shd.dp_axes(mesh)
    n_dp = mesh.size(dp)
    spec_of = dict(tree_items(specs))
    groups: dict[tuple, list] = {}
    for name, g in tree_items(grads):
        axes = tuple(a for a in dp if a not in shd.spec_axes(spec_of[name])
                     and mesh.shape[a] > 1)
        groups.setdefault(axes, []).append((name, g))
    out = {}
    for axes, items in groups.items():
        if axes:
            flat = torch.cat([g.reshape(-1) for _, g in items])
            flat = spmd.psum(flat, axes)
            parts = torch.split(flat, [g.numel() for _, g in items])
            items = [(name, part.view_as(g)) for (name, g), part in zip(items, parts)]
        for name, g in items:
            out[name] = g / n_dp if n_dp > 1 else g
    return tree_build((name, out[name]) for name, _ in tree_items(grads))


def _global_norm(mesh, grads, specs):
    """The float32 global norm of the full gradient: each leaf's squared
    sum added over the axes that shard it, so every element counts once."""
    spec_of = dict(tree_items(specs))
    by_axes: dict[tuple, torch.Tensor] = {}
    for name, g in tree_items(grads):
        axes = tuple(a for a in shd.spec_axes(spec_of[name]) if mesh.shape[a] > 1)
        sq = torch.sum(torch.square(g.to(torch.float32)))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = sum(spmd.psum(sq, axes) if axes else sq for axes, sq in sorted(by_axes.items()))
    return torch.sqrt(total)


def make_train_step(
    cfg: ModelConfig,
    *,
    tp: int,
    opt: AdamWConfig | None = None,
    warmup: int = 100,
    total_steps: int = 10_000,
    clip_norm: float = 1.0,
    microbatch: int = 1,
    mesh=None,
    moe_ep: bool = False,
) -> Callable:
    """A train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` of any family: the loss's gradients, clipped to
    ``clip_norm``, then AdamW at the warmup-cosine learning rate.  An encdec
    batch carries ``frames``, a vlm batch ``patches`` (see
    :func:`repro_torch.models.api.make_batch`).

    Under ``mesh`` the step takes the global batch and this rank's shards
    of the parameters and optimizer state (by :func:`param_layout`); its
    loss is the global mean; the gradients are mean-reduced over the data
    axes once a step (``microbatch > 1`` included), the clipping norm sums
    each leaf once over the axes that shard it, and AdamW runs on the local
    shards.
    """
    opt = opt or AdamWConfig()
    if mesh is not None:
        _check_mesh(cfg, mesh, moe_ep)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, tp=tp, microbatch=microbatch,
                                     mesh=mesh, moe_ep=moe_ep)
        norm = None
        if mesh is not None:
            with mesh:
                norm = _global_norm(mesh, grads, param_layout(cfg, params, moe_ep=moe_ep))
        grads, gnorm = clip_by_global_norm(grads, clip_norm, norm)
        lr_scale = cosine_warmup(opt_state["step"] + 1, warmup=warmup, total=total_steps)
        new_params, new_opt = adamw_update(opt, params, grads, opt_state, lr_scale)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale}
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, tp: int, mesh=None, moe_ep: bool = False,
                      moe_seq_axis=None) -> Callable:
    """``(params, batch, cache) -> (last-position logits, cache)``.  Under
    ``mesh`` it takes the global batch and this rank's shards of the
    parameters and cache (``cache_pspecs``) and returns this rank's logits
    (its batch slice; under tensor parallelism its vocab slice) and cache;
    ``moe_seq_axis`` shards the experts' tokens over that axis too."""
    if mesh is not None:
        _check_mesh(cfg, mesh, moe_ep)

    def prefill_step(params, batch, cache):
        with _step_ctx(mesh, moe_ep, moe_seq_axis):
            if mesh is not None:
                batch = local_batch(cfg, mesh, batch, "prefill")
            return api.prefill(cfg, params, batch, cache, tp=tp)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, tp: int, mesh=None, moe_ep: bool = False) -> Callable:
    """``(params, cache, batch) -> (logits, cache)``, one token; under
    ``mesh`` as :func:`make_prefill_step`."""
    if mesh is not None:
        _check_mesh(cfg, mesh, moe_ep)

    def decode_step(params, cache, batch):
        with _step_ctx(mesh, moe_ep):
            if mesh is not None:
                batch = local_batch(cfg, mesh, batch, "decode")
            return api.decode(cfg, params, cache, batch, tp=tp)

    return decode_step
