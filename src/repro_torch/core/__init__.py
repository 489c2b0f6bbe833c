# The paper's primary contribution: partial cross-compilation + mixed
# execution, with the host side in PyTorch.  The public surface:
#
#   Program IR        — repro_torch.core.program (ProgramBuilder, Program, Function, Op)
#   Guest execution   — repro_torch.core.emulator (Emulator)
#   Staged frontend   — repro_torch.core.api (trace → plan → compile → run,
#                       signature-polymorphic CompiledHybrid, instrument())
#   Optimizations     — grt / fcp / pfo modules
#   Legacy runtime    — repro_torch.core.engine (HybridExecutor, run_scheme — shims)
#   Static analysis   — repro_torch.analysis (analyze, AnalysisReport; lazy here)
from .opset import AVal, Cost, REGISTRY as OP_REGISTRY, PY_FUNCS, host_log
from .program import Program, Function, Op, ProgramBuilder, abstract_eval, function_cost
from .emulator import Emulator
from .api import (
    CompiledHybrid,
    Instrumentation,
    NativeInfeasibleError,
    PlannedProgram,
    PlanVerificationError,
    Traced,
    instrument,
    trace,
)
from .engine import HybridExecutor, run_scheme
from .offload import SCHEMES, Scheme
from .costmodel import CostModel, CostModelConfig
from .stats import Coverage, ExecutionReport, RunStats

__all__ = [
    "AVal", "Cost", "OP_REGISTRY", "PY_FUNCS", "host_log",
    "Program", "Function", "Op", "ProgramBuilder", "abstract_eval", "function_cost",
    "Emulator",
    "trace", "Traced", "PlannedProgram", "CompiledHybrid", "instrument",
    "Instrumentation", "ExecutionReport", "NativeInfeasibleError",
    "PlanVerificationError", "HybridExecutor", "run_scheme",
    "analyze", "AnalysisReport",
    "SCHEMES", "Scheme", "CostModel", "CostModelConfig", "RunStats", "Coverage",
]


def __getattr__(name):
    # the analysis layer imports core.offload/core.fcp, so it is resolved on
    # first use rather than while this package initialises
    if name in ("analyze", "AnalysisReport"):
        from .. import analysis

        return getattr(analysis, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
