"""Unified model API of the port: family dispatch + step functions.

The reference's surface (``models/api.py`` there) for its six families:
``dense`` (SmolLM, Llama 3.2, Qwen2), ``moe`` (Granite MoE, DBRX),
``hybrid`` (Zamba2: Mamba2 layers and a shared attention block), ``ssm``
(xLSTM), ``encdec`` (SeamlessM4T: the batch carries stubbed ``frames``) and
``vlm`` (Phi-3-vision: the batch carries stubbed ``patches``).

* ``init(cfg, gen, tp, device=)``              — parameter dict
* ``logits(cfg, params, batch, tp)``           — teacher-forcing forward
* ``init_cache(cfg, batch, max_len, tp)``      — serving cache dict
* ``prefill(cfg, params, batch, cache, tp)``   — prompt ingestion
* ``decode(cfg, params, cache, batch, tp)``    — one-token serve step
* ``input_shapes(cfg, shape)``, ``input_specs(cfg, shape)`` — the inputs'
  shapes and dtypes, and data-less (meta) stand-ins for them
* ``make_batch(cfg, shape, seed)``             — random numpy inputs
* ``load_reference_params(cfg, tree, tp=, device=)`` — carry the reference
  package's weights across
* ``load_reference_opt_state(cfg, tree, tp=, device=)`` — and its AdamW
  state

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``); without a card they raise.  Batches may hold numpy
arrays or tensors; they are placed on the parameters' device.  Caches are
updated in place (see :mod:`.dense` and :mod:`.mamba2`), but for encdec's
cross caches, which the prefill replaces (see :mod:`.encdec`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.api import resolve_device
from ..optim.tree import tree_build as _build, tree_items as _leaves
from . import dense, encdec, mamba2, moe, vlm, xlstm
from . import layers as L

_FAMILIES = {
    "dense": dense,
    "moe": moe,
    "hybrid": mamba2,
    "ssm": xlstm,
    "encdec": encdec,
    "vlm": vlm,
}


def family_module(cfg: ModelConfig):
    return _FAMILIES[cfg.family]


def _param_device(params) -> torch.device:
    return params["embed"]["table"].device


def _placed(params, x) -> torch.Tensor:
    """A batch entry (tokens, frames or patches) as a tensor on the
    parameters' device."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=_param_device(params))


def _extra(cfg: ModelConfig, params, batch: dict) -> tuple:
    """The stubbed frontend input the family takes besides tokens: encdec's
    ``frames``, vlm's ``patches``."""
    if cfg.family == "encdec":
        return (_placed(params, batch["frames"]),)
    if cfg.family == "vlm":
        return (_placed(params, batch["patches"]),)
    return ()


def init(cfg: ModelConfig, gen: torch.Generator, tp: int = L.DEFAULT_TP, *, device=None):
    """Random parameters drawn from ``gen`` (on its own device), placed on
    ``device`` (``None``: the CUDA card)."""
    return family_module(cfg).init(cfg, gen, tp=tp, device=resolve_device(device))


def logits(cfg: ModelConfig, params, batch: dict, tp: int = L.DEFAULT_TP):
    mod = family_module(cfg)
    return mod.logits_fn(cfg, params, _placed(params, batch["tokens"]),
                         *_extra(cfg, params, batch), tp=tp)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int = L.DEFAULT_TP,
               dtype=torch.float32, *, device=None):
    return family_module(cfg).init_cache(cfg, batch, max_len, tp=tp, dtype=dtype,
                                         device=resolve_device(device))


def prefill(cfg: ModelConfig, params, batch: dict, cache, tp: int = L.DEFAULT_TP):
    mod = family_module(cfg)
    return mod.prefill(cfg, params, _placed(params, batch["tokens"]),
                       *_extra(cfg, params, batch), cache, tp=tp)


def decode(cfg: ModelConfig, params, cache, batch: dict, tp: int = L.DEFAULT_TP):
    mod = family_module(cfg)
    return mod.decode_step(cfg, params, cache, _placed(params, batch["token"]), tp=tp)


def input_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, tuple]:
    """(shape, dtype) of every model input of a shape cell, in the
    reference's order: token ids, then encdec's ``frames`` (B,
    enc_len_for(T), d_model) or vlm's ``patches`` (B, n_patches, D_PATCH),
    float32, for the shapes that are not decode steps."""
    family_module(cfg)
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out = {"tokens": ((B, T), np.int32), "labels": ((B, T), np.int32)}
    elif shape.kind == "prefill":
        out = {"tokens": ((B, T), np.int32)}
    else:
        out = {"token": ((B, 1), np.int32)}   # decode: one new token
    if cfg.family == "encdec" and shape.kind != "decode":
        out["frames"] = ((B, encdec.enc_len_for(T), cfg.d_model), np.float32)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["patches"] = ((B, cfg.n_patches, vlm.D_PATCH), np.float32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for every model input of a shape cell: meta tensors of
    :func:`input_shapes`'s shapes and dtypes, holding no data, as the
    reference's ``ShapeDtypeStruct`` specs are; nothing is allocated.  The
    launch dry run feeds them to a step."""
    return {k: torch.empty(s, dtype=getattr(torch, np.dtype(dtype).name), device="meta")
            for k, (s, dtype) in input_shapes(cfg, shape).items()}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Random batch for a shape cell; the reference's numbers for the same
    seed: token ids uniform over the vocabulary, float inputs normal * 0.1."""
    rng = np.random.default_rng(seed)
    out: dict[str, np.ndarray] = {}
    for k, (s, dtype) in input_shapes(cfg, shape).items():
        if np.issubdtype(dtype, np.integer):
            out[k] = rng.integers(0, cfg.vocab, size=s, dtype=np.int32)
        else:
            out[k] = rng.standard_normal(s).astype(np.float32) * 0.1
    return out


def load_reference_params(cfg: ModelConfig, tree, *, tp: int, device=None):
    """The reference package's params pytree, given as nested dicts of numpy
    arrays, as the port's params on ``device``.

    Every name, shape and dtype must equal those of the port's own ``init``
    for ``(cfg, tp)``; anything missing, extra or different raises
    :class:`ValueError` naming it.
    """
    device = resolve_device(device)
    want = dict(_leaves(family_module(cfg).init(cfg, torch.Generator(), tp=tp,
                                                device=torch.device("meta"))))
    got = dict(_leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter names differ: missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")
    out = []
    for name, ref in want.items():
        value = np.asarray(got[name])
        if value.shape != tuple(ref.shape):
            raise ValueError(f"{name}: shape {value.shape}, the port has {tuple(ref.shape)}")
        if value.dtype != np.dtype(str(ref.dtype).removeprefix("torch.")):
            raise ValueError(f"{name}: dtype {value.dtype}, the port has {ref.dtype}")
        out.append((name, torch.tensor(value, device=device)))
    return _build(out)


def load_reference_opt_state(cfg: ModelConfig, tree, *, tp: int, device=None):
    """The reference package's AdamW state ``{"m": tree, "v": tree, "step"}``
    (moments as nested dicts of numpy arrays) as the port's on ``device``:
    the moments checked as :func:`load_reference_params` checks parameters,
    the step an int32 0-d tensor."""
    device = resolve_device(device)
    return {
        "m": load_reference_params(cfg, tree["m"], tp=tp, device=device),
        "v": load_reference_params(cfg, tree["v"], tp=tp, device=device),
        "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                             device=device),
    }
