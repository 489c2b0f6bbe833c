"""Workload programs — analogues of the paper's Table 2 evaluation set.

Three customized micro-benchmarks, six LLVM-test-suite analogues, and the
eight NAS Parallel Benchmark analogues, each rebuilt as a Program over the
opset with the same *structural* character as the original (hot loops,
tiny-function call storms, host-only safety checks, library call-outs), so
the paper's per-workload phenomena (Figs. 4–6) reproduce on our engine.

``WORKLOADS[name].build(scale)`` returns ``(program, args)``; ``scale`` is
``"test"`` (seconds-fast, for pytest) or ``"bench"`` (benchmark sizes).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .micro import build_matpowsum, build_chainexp, build_stencil2d
from .llvmsuite import (
    build_cjson,
    build_lua,
    build_obsequi,
    build_oggenc,
    build_sgefa,
    build_viterbi,
)
from .npb import (
    build_npbbt,
    build_npbcg,
    build_npbep,
    build_npbft,
    build_npbis,
    build_npblu,
    build_npbmg,
    build_npbsp,
)
from .libs import build_library_app, LIBRARY_FUNCTIONS


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    source: str                       # "custom" | "llvm-suite" | "npb" | "library"
    build: Callable                   # (scale) -> (Program, list[np.ndarray])
    has_host_ops: bool                # native (all-or-nothing) infeasible?


WORKLOADS: dict[str, WorkloadSpec] = {}


def _reg(name: str, source: str, build: Callable, has_host_ops: bool) -> None:
    WORKLOADS[name] = WorkloadSpec(name, source, build, has_host_ops)


_reg("matpowsum", "custom", build_matpowsum, True)
_reg("chainexp", "custom", build_chainexp, False)
_reg("stencil2d", "custom", build_stencil2d, False)
_reg("cjson", "llvm-suite", build_cjson, True)
_reg("lua", "llvm-suite", build_lua, True)
_reg("obsequi", "llvm-suite", build_obsequi, True)
_reg("oggenc", "llvm-suite", build_oggenc, False)
_reg("sgefa", "llvm-suite", build_sgefa, True)
_reg("viterbi", "llvm-suite", build_viterbi, False)
_reg("npbbt", "npb", build_npbbt, False)
_reg("npbcg", "npb", build_npbcg, False)
_reg("npbep", "npb", build_npbep, True)
_reg("npbft", "npb", build_npbft, False)
_reg("npbis", "npb", build_npbis, False)
_reg("npblu", "npb", build_npblu, False)
_reg("npbmg", "npb", build_npbmg, False)
_reg("npbsp", "npb", build_npbsp, True)

__all__ = ["WORKLOADS", "WorkloadSpec", "build_library_app", "LIBRARY_FUNCTIONS"]
