"""Offload-or-not decisions.

The paper's prototype "adopts a very simple strategy of filtering out
functions whose number of basic blocks and instructions exceeds a certain
threshold" — i.e. only sufficiently large functions are offloaded, because
every crossing costs far more than a direct call.  We reproduce that simple
size threshold as the *paper-faithful* policy, and additionally provide a
crossing-aware policy (the paper's "better cost models ... left for future
work") that estimates whether native-execution savings exceed boundary cost —
this is one of our beyond-paper extensions, and it repairs the cjson/lua-style
regressions the paper reports.
"""
from __future__ import annotations

import dataclasses

from .opset import AVal
from .program import Program, function_cost


@dataclasses.dataclass(frozen=True)
class CostModelConfig:
    # paper-faithful size threshold (ops ≈ "instructions")
    min_ops: int = 1
    min_flops: int = 0
    # beyond-paper crossing-aware policy
    crossing_aware: bool = False
    crossing_cost_s: float = 2e-4       # measured guest→host crossing cost (CPU)
    interp_op_cost_s: float = 3e-6      # per-op interpreter dispatch tax
    native_speedup: float = 8.0         # assumed native/interp throughput ratio
    host_flops_per_s: float = 5e10


@dataclasses.dataclass(frozen=True)
class Decision:
    offload: bool
    reason: str


class CostModel:
    def __init__(self, config: CostModelConfig | None = None):
        self.config = config or CostModelConfig()

    def decide(self, program: Program, fname: str, arg_avals: tuple[AVal, ...]) -> Decision:
        cfg = self.config
        cost, nops = function_cost(program, fname, arg_avals)
        if nops < cfg.min_ops:
            return Decision(False, f"too small: {nops} ops < min_ops={cfg.min_ops}")
        if cost.flops < cfg.min_flops:
            return Decision(False, f"too cheap: {cost.flops} flops < min_flops={cfg.min_flops}")
        if cfg.crossing_aware:
            interp_s = nops * cfg.interp_op_cost_s + cost.flops / (cfg.host_flops_per_s / cfg.native_speedup)
            native_s = cfg.crossing_cost_s + cost.flops / cfg.host_flops_per_s
            if native_s >= interp_s:
                return Decision(
                    False,
                    f"crossing-aware: native {native_s:.2e}s >= interp {interp_s:.2e}s",
                )
        return Decision(True, f"ok: {nops} ops, {cost.flops} flops")
