"""Step functions of the port: prefill and decode.

The reference's ``launch/steps.py`` builds mesh-shardable, jit-ready steps;
the port runs eagerly on one device, so a step is a plain closure over the
config and the head plan.  Training steps come with the training substrate
(ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Callable

from ..configs.base import ModelConfig
from ..models import api


def make_prefill_step(cfg: ModelConfig, *, tp: int) -> Callable:
    def prefill_step(params, batch, cache):
        return api.prefill(cfg, params, batch, cache, tp=tp)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, tp: int) -> Callable:
    def decode_step(params, cache, batch):
        return api.decode(cfg, params, cache, batch, tp=tp)

    return decode_step
