"""Step functions of the port: train, prefill and decode.

The reference's ``launch/steps.py`` builds mesh-shardable, jit-ready steps;
the port runs eagerly, so a step is a plain closure over the config and the
head plan, for every family.  Without a mesh it runs on one device.  With
``mesh`` (a :class:`~repro_torch.parallel.spmd.Mesh`, every rank of the
world calling the step) it runs one rank's part of the reference's sharded
step: the step takes the global batch and keeps the rank's slice by
``batch_pspecs``; the parameters (and the cache) are the rank's shards, cut
by :func:`param_layout` (``parallel.sharding.shard_tree``).

* ``strategy="tp"``: tensor parallelism over ``model`` in every family's
  layers (``models/layers.py`` and each family's blocks), expert
  parallelism under ``moe_ep`` (``models/moe.py:moe_block_ep``), the batch
  over the data axes; ``fsdp=True`` adds ZeRO: the leaves are also split
  over ``data`` (``param_pspecs(fsdp=True)``) and gathered over it inside
  each layer (``constrain_layer_params``).
* ``strategy="fsdp"``: no tensor parallelism; every leaf is split over as
  many axes as divide it and gathered inside its layer, the batch over as
  many axes as divide it; MoE keeps expert parallelism over ``model`` with
  its experts split over ``data`` (``moe_ep`` is required, as the
  reference's dry run forces it).

A gather's backward is a reduce-scatter, so the gradients come back as the
rank's shards, and :func:`_reduce_grads` sums each leaf once, over the
batch axes that its gather did not cover.  The reference's ``layer_pspecs``
and ``batch_axes`` options are derived here from ``strategy``, ``fsdp`` and
the parameters' global shapes.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import api
from ..optim import AdamWConfig, adamw_update, clip_by_global_norm, cosine_warmup
from ..optim.tree import tree_build, tree_items, tree_map
from ..parallel import sharding as shd
from ..parallel import spmd

TP_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")
STRATEGIES = ("tp", "fsdp")


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
                   microbatch: int = 1, mesh=None, moe_ep: bool = False,
                   strategy: str = "tp", fsdp: bool = False):
    """(mean loss, gradients laid out as ``params``) of one batch.

    The float32 masters are cast to ``cfg.compute_dtype`` inside the loss,
    as the reference does, so the gradients reach the float32 leaves through
    the casts.  ``microbatch > 1`` splits the batch into that many
    sequential microbatches and accumulates their gradients in float32
    (a plain loop where the reference scans).  ``params`` are not modified
    and need not require grad.

    Under ``mesh`` (every rank calling it) ``batch`` is the global batch and
    ``params`` this rank's shards (:func:`param_layout` with the same
    ``moe_ep``, ``strategy`` and ``fsdp``): the loss is the global mean and
    the gradients are this rank's shards of its gradient, mean-reduced over
    the batch axes once (:func:`_reduce_grads`).
    """
    if mesh is None:
        return _local_loss_and_grads(cfg, params, batch, tp=tp, microbatch=microbatch)
    _check_mesh(cfg, mesh, moe_ep, strategy)
    specs = _layout(cfg, tp, mesh, moe_ep, strategy, fsdp)
    axes = shd._axes_of(_batch_axes(cfg, mesh, batch, "train", strategy))
    with _step_ctx(cfg, mesh, moe_ep, strategy=strategy, specs=specs, tp=tp,
                   kind="train", batch=batch):
        batch = local_batch(cfg, mesh, batch, "train", strategy=strategy)
        loss, grads = _local_loss_and_grads(cfg, params, batch, tp=tp, microbatch=microbatch,
                                            specs=specs)
        loss = spmd.psum(loss, axes) / mesh.size(axes)
        return loss, _reduce_grads(mesh, grads, specs, axes, strategy, moe_ep)


def _local_loss_and_grads(cfg: ModelConfig, params, batch: dict, *, tp: int, microbatch: int,
                          specs=None):
    names, leaves = zip(*tree_items(params))
    device = leaves[0].device
    batch = _on_device(batch, device)
    dt = getattr(torch, cfg.compute_dtype)
    leaves = [t.detach().requires_grad_() for t in leaves]

    def one(mb):
        cast = tree_map(lambda x: x.to(dt), tree_build(zip(names, leaves)))
        if specs is not None:
            cast = _gather_top(cast, specs)
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

def param_layout(cfg: ModelConfig, params, *, moe_ep: bool = False, strategy: str = "tp",
                 fsdp: bool = False, mesh=None):
    """The specs a sharded step holds ``params`` (or their optimizer
    moments) by: ``param_pspecs``'s layout for ``strategy`` and ``fsdp``
    (``"fsdp"`` needs the ``mesh``), and under ``moe_ep`` the experts as
    ``moe_block_ep`` takes them, ``P(model, data, None)`` for ``wg``/``wu``
    and ``P(model, None, data)`` for ``wd`` behind the layer axis (the
    reference's shard_map in-specs)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r}: one of {STRATEGIES}")
    specs = shd.param_pspecs(cfg, params, fsdp=fsdp, strategy=strategy, mesh=mesh)
    if moe_ep and cfg.family == "moe":
        experts = specs["layers"]["experts"]
        experts["wg"] = experts["wu"] = shd.P(None, "model", "data", None)
        experts["wd"] = shd.P(None, "model", None, "data")
    return specs


@functools.lru_cache(maxsize=32)
def _global_params(cfg: ModelConfig, tp: int):
    """The parameters' global shapes (on the meta device): a sharded step
    holds shards, and the fsdp layout follows the full shapes."""
    return api.family_module(cfg).init(cfg, torch.Generator(), tp=tp,
                                       device=torch.device("meta"))


def _layout(cfg: ModelConfig, tp: int, mesh, moe_ep: bool, strategy: str, fsdp: bool):
    return param_layout(cfg, _global_params(cfg, tp), moe_ep=moe_ep, strategy=strategy,
                        fsdp=fsdp, mesh=mesh)


def _check_mesh(cfg: ModelConfig, mesh, moe_ep: bool, strategy: str = "tp") -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r}: one of {STRATEGIES}")
    if cfg.family == "moe" and not moe_ep and (
            strategy == "fsdp" or mesh.shape.get("model", 1) > 1):
        raise ValueError(f"{cfg.name}: under strategy {strategy!r} on {dict(mesh.shape)} "
                         f"the experts run expert-parallel; pass moe_ep=True")
    model = mesh.shape.get("model", 1)
    if strategy == "tp" and model > 1 and cfg.family == "ssm":
        from ..models import xlstm

        xlstm.check_tensor_parallel(cfg, model)


LAYER_KEYS = ("layers", "enc_layers", "dec_layers")


def _layer_pspecs(specs, params) -> dict:
    """One layer's specs per layer key of the params (see
    ``sharding.activation_sharding``): a stacked family's without the L
    axis, xLSTM's list as it is, and the hybrid's shared block's."""
    out = {}
    for key in LAYER_KEYS:
        if key in specs:
            out[key] = (specs[key] if isinstance(specs[key], list)
                        else shd.strip_layer_axis(specs[key], params[key]))
    if "shared" in specs:
        out["shared"] = specs["shared"]
    return out


def _gather_top(params, specs):
    """The leaves outside the layers (embedding and head tables, final
    norms, the patch projection) gathered as their step gathers them; the
    layers' leaves stay shards, each layer gathers its own."""
    top = [k for k in params if k not in LAYER_KEYS and k != "shared"]
    out = dict(params)
    out.update(shd.gather_params({k: params[k] for k in top}, {k: specs[k] for k in top}))
    return out


def _batch_axes(cfg: ModelConfig, mesh, batch: dict, kind: str, strategy: str):
    first = next(iter(batch.values()))
    shape = ShapeConfig(kind, kind, int(np.shape(first)[1]), int(np.shape(first)[0]))
    key = {"train": "tokens", "prefill": "tokens", "decode": "token"}[kind]
    return shd.batch_pspecs(cfg, shape, mesh, strategy=strategy)[key][0]


def _seq_axes(mesh, batch: dict, kind: str, strategy: str):
    """The data axes a decode step's caches split their sequence over
    (``cache_pspecs`` at a global batch of 1 under ``"tp"``), or None."""
    if kind != "decode" or strategy != "tp" or mesh.size(shd.dp_axes(mesh)) == 1:
        return None
    return shd.dp_axes(mesh) if int(np.shape(next(iter(batch.values())))[0]) == 1 else None


def _step_ctx(cfg, mesh, moe_ep, moe_seq_axis=None, *, strategy="tp", specs=None,
              tp=1, kind="train", batch=None):
    """The context a sharded step runs in: the mesh, its layout
    (``sharding.activation_sharding``, with the per-layer specs when a
    layer's leaves are split over axes that it gathers), and under
    ``moe_ep`` the expert-parallel dispatch."""
    layers = None
    if specs is not None and any(
            shd.gathered_axes(spec, strategy) for _, spec in shd._spec_items(specs)):
        layers = _layer_pspecs(specs, _global_params(cfg, tp))
    skip = ("experts/",) if moe_ep else ()
    stack = contextlib.ExitStack()
    stack.enter_context(mesh)
    stack.enter_context(shd.activation_sharding(
        mesh, strategy=strategy, layer_pspecs=layers, skip=skip,
        batch_axes=_batch_axes(cfg, mesh, batch, kind, strategy),
        seq_axes=_seq_axes(mesh, batch, kind, strategy)))
    if moe_ep:
        stack.enter_context(shd.moe_ep_context(mesh, moe_seq_axis))
    return stack


def local_batch(cfg: ModelConfig, mesh, batch: dict, kind: str, *, strategy: str = "tp") -> dict:
    """This rank's slice of a global batch, by ``batch_pspecs``.

    A decode batch of 1 on more than one data rank is replicated over them:
    the cache's sequence is split there instead (``cache_pspecs``), and the
    attention folds the ranks' slices (:func:`models.layers.decode_attend`).
    A train or prefill batch of 1 cannot split over the data ranks (nor can
    the reference's ``NamedSharding``): :class:`ValueError`."""
    first = next(iter(batch.values()))
    shape = ShapeConfig(kind, kind, int(np.shape(first)[1]), int(np.shape(first)[0]))
    if shape.global_batch == 1 and kind != "decode" and mesh.size(shd.dp_axes(mesh)) > 1:
        raise ValueError(f"a {kind} batch of 1 does not split over the data axes "
                         f"{shd.dp_axes(mesh)} of {dict(mesh.shape)}")
    tensors = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
               for k, v in batch.items()}
    return shd.shard_tree(mesh, tensors, shd.batch_pspecs(cfg, shape, mesh, strategy=strategy))


def _reduce_grads(mesh, grads, specs, batch_axes, strategy: str = "tp",
                  moe_ep: bool = False):
    """The global mean's gradients from this rank's: each leaf summed over
    the batch axes that do not split it (one all-reduce per set of axes,
    the leaves flattened into one buffer), then divided by the number of
    batch ranks.  A leaf split over an axis was gathered over it inside its
    layer (the experts under ``moe_ep`` over ``data`` only, by their
    block), whose backward summed it there already; where that axis does
    not split the batch, its ranks summed equal gradients, which the
    divisor takes out."""
    axes_b = tuple(a for a in batch_axes if mesh.shape[a] > 1)
    n_dp = mesh.size(batch_axes)
    spec_of = dict(shd._spec_items(specs))
    groups: dict[tuple, list] = {}
    for name, g in tree_items(grads):
        spec = spec_of[name]
        axes = tuple(a for a in axes_b if a not in shd.spec_axes(spec))
        gathered = (("data",) if moe_ep and name.startswith("layers/experts/")
                    else shd.gathered_axes(spec, strategy))
        over = math.prod(mesh.shape[a] for a in gathered if a not in batch_axes)
        groups.setdefault((axes, n_dp * over), []).append((name, g))
    out = {}
    for (axes, n), items in groups.items():
        if axes:
            flat = torch.cat([g.reshape(-1) for _, g in items])
            flat = spmd.psum(flat, axes)
            parts = torch.split(flat, [g.numel() for _, g in items])
            items = [(name, part.view_as(g)) for (name, g), part in zip(items, parts)]
        for name, g in items:
            out[name] = g / n if n > 1 else g
    return tree_build((name, out[name]) for name, _ in tree_items(grads))


def _global_norm(mesh, grads, specs):
    """The float32 global norm of the full gradient: each leaf's squared
    sum added over the axes that shard it, so every element counts once."""
    spec_of = dict(shd._spec_items(specs))
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
    strategy: str = "tp",
    fsdp: bool = False,
) -> Callable:
    """A train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` of any family: the loss's gradients, clipped to
    ``clip_norm``, then AdamW at the warmup-cosine learning rate.  An encdec
    batch carries ``frames``, a vlm batch ``patches`` (see
    :func:`repro_torch.models.api.make_batch`).

    Under ``mesh`` the step takes the global batch and this rank's shards
    of the parameters and optimizer state (by :func:`param_layout` with the
    same ``moe_ep``, ``strategy`` and ``fsdp``); its loss is the global
    mean; the gradients are mean-reduced over the batch axes once a step
    (``microbatch > 1`` included), the clipping norm sums each leaf once
    over the axes that shard it, and AdamW runs on the local shards.
    """
    opt = opt or AdamWConfig()
    if mesh is not None:
        _check_mesh(cfg, mesh, moe_ep, strategy)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, tp=tp, microbatch=microbatch,
                                     mesh=mesh, moe_ep=moe_ep, strategy=strategy, fsdp=fsdp)
        norm = None
        if mesh is not None:
            with mesh:
                norm = _global_norm(mesh, grads, _layout(cfg, tp, mesh, moe_ep, strategy, fsdp))
        grads, gnorm = clip_by_global_norm(grads, clip_norm, norm)
        lr_scale = cosine_warmup(opt_state["step"] + 1, warmup=warmup, total=total_steps)
        new_params, new_opt = adamw_update(opt, params, grads, opt_state, lr_scale)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale}
        return new_params, new_opt, metrics

    return train_step


def _serve_ctx(cfg, tp, mesh, moe_ep, moe_seq_axis, strategy, fsdp, kind, batch):
    specs = _layout(cfg, tp, mesh, moe_ep, strategy, fsdp)
    return _step_ctx(cfg, mesh, moe_ep, moe_seq_axis, strategy=strategy, specs=specs,
                     tp=tp, kind=kind, batch=batch), specs


def make_prefill_step(cfg: ModelConfig, *, tp: int, mesh=None, moe_ep: bool = False,
                      moe_seq_axis=None, strategy: str = "tp", fsdp: bool = False) -> Callable:
    """``(params, batch, cache) -> (last-position logits, cache)``.  Under
    ``mesh`` it takes the global batch and this rank's shards of the
    parameters (:func:`param_layout`) and of the cache
    (:func:`cache_layout`) and returns this rank's logits (its batch slice;
    under tensor parallelism its vocab slice) and cache; ``moe_seq_axis``
    shards the experts' tokens over that axis too."""
    if mesh is not None:
        _check_mesh(cfg, mesh, moe_ep, strategy)

    def prefill_step(params, batch, cache):
        if mesh is None:
            return api.prefill(cfg, params, batch, cache, tp=tp)
        ctx, specs = _serve_ctx(cfg, tp, mesh, moe_ep, moe_seq_axis, strategy, fsdp,
                                "prefill", batch)
        with ctx:
            batch = local_batch(cfg, mesh, batch, "prefill", strategy=strategy)
            return api.prefill(cfg, _gather_top(params, specs), batch, cache, tp=tp)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, tp: int, mesh=None, moe_ep: bool = False,
                     strategy: str = "tp", fsdp: bool = False) -> Callable:
    """``(params, cache, batch) -> (logits, cache)``, one token; under
    ``mesh`` as :func:`make_prefill_step`."""
    if mesh is not None:
        _check_mesh(cfg, mesh, moe_ep, strategy)

    def decode_step(params, cache, batch):
        if mesh is None:
            return api.decode(cfg, params, cache, batch, tp=tp)
        ctx, specs = _serve_ctx(cfg, tp, mesh, moe_ep, None, strategy, fsdp,
                                "decode", batch)
        with ctx:
            batch = local_batch(cfg, mesh, batch, "decode", strategy=strategy)
            return api.decode(cfg, _gather_top(params, specs), cache, batch, tp=tp)

    return decode_step


def step_for_shape(cfg: ModelConfig, shape: ShapeConfig, *, tp: int, **options
                   ) -> tuple[str, Callable]:
    """(kind, step) — the step a shape cell runs: :func:`make_train_step`,
    :func:`make_prefill_step` or :func:`make_decode_step` by ``shape.kind``,
    with ``options`` (``mesh``, ``strategy``, ...) passed on."""
    if shape.kind == "train":
        return "train", make_train_step(cfg, tp=tp, **options)
    if shape.kind == "prefill":
        return "prefill", make_prefill_step(cfg, tp=tp, **options)
    return "decode", make_decode_step(cfg, tp=tp, **options)


def cache_layout(cfg: ModelConfig, shape: ShapeConfig, mesh, cache, *,
                 strategy: str = "tp"):
    """The specs a sharded prefill or decode step holds its cache by:
    ``cache_pspecs``'s under ``"tp"``; under ``"fsdp"``, which splits no
    heads, each leaf's batch dim over the step's batch axes."""
    specs = shd.cache_pspecs(cfg, shape, mesh, cache)
    if strategy == "tp":
        return specs
    axes = shd.batch_pspecs(cfg, shape, mesh, strategy=strategy)[
        "token" if shape.kind == "decode" else "tokens"][0]

    def by_batch(spec):
        dims = [i for i, part in enumerate(spec) if set(shd._axes_of(part)) & set(
            shd.dp_axes(mesh))]
        return shd.P(*(axes if i in dims else None for i in range(len(spec))))

    return shd._map_specs(by_batch, specs)
