"""Optimizer substrate of the port: AdamW, global-norm clipping, the
warmup-cosine schedule (the reference package's ``optim``), on nested dicts
of tensors laid out as the parameters."""
from .adamw import AdamWConfig, adamw_init, adamw_update
from .clip import clip_by_global_norm
from .schedule import cosine_warmup
from .tree import tree_leaves, tree_map

__all__ = [
    "adamw_init", "adamw_update", "AdamWConfig", "cosine_warmup", "clip_by_global_norm",
    "tree_leaves", "tree_map",
]
