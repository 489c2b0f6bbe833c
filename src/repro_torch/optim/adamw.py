"""AdamW (decoupled weight decay, float32 moments), the reference's
``optim/adamw.py`` on the port's nested dicts of tensors.

Moments are float32 whatever the parameters' dtype; the update is computed
in float32 and cast back; the bias corrections are float32.  The state is
``{"m": tree, "v": tree, "step": int32 0-d tensor}``, the reference's
layout.  The update is functional: it returns new tensors and leaves its
inputs as they are.
"""
from __future__ import annotations

import dataclasses

import torch

from .tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def adamw_init(params) -> dict:
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """(new params, new state) after one AdamW step with learning rate
    ``cfg.lr * lr_scale``."""
    f32 = torch.float32
    step = state["step"] + 1
    b1t = 1.0 - torch.pow(cfg.b1, step.to(f32))
    b2t = 1.0 - torch.pow(cfg.b2, step.to(f32))
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        gf = g.to(f32)
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(gf)
        mhat = m2 / b1t
        vhat = v2 / b2t
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(f32)
        return (p.to(f32) - lr * delta).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}
