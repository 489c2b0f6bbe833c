"""Global-norm gradient clipping (the reference's ``optim/clip.py``)."""
from __future__ import annotations

import torch

from .tree import tree_leaves, tree_map


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm=None):
    """(grads scaled so their global float32 norm is at most ``max_norm``,
    the norm before scaling).  ``norm`` is that norm when the caller has
    it: a sharded step sums each leaf's squares over the ranks that shard
    it (``launch/steps.py``); by default it is taken over ``grads``."""
    gn = norm if norm is not None else torch.sqrt(
        sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn
