# The paper's primary contribution: partial cross-compilation + mixed
# execution, with the host side in PyTorch.  The public surface:
#
#   Program IR        — repro_torch.core.program (ProgramBuilder, Program, Function, Op)
#   Guest execution   — repro_torch.core.emulator (Emulator)
#   Staged frontend   — repro_torch.core.api (trace → plan → compile → run,
#                       signature-polymorphic CompiledHybrid, instrument())
#   Optimizations     — grt / fcp / pfo modules
from .opset import AVal, Cost, REGISTRY as OP_REGISTRY, PY_FUNCS, host_log
from .program import Program, Function, Op, ProgramBuilder, abstract_eval, function_cost
from .emulator import Emulator
from .api import (
    CompiledHybrid,
    Instrumentation,
    NativeInfeasibleError,
    PlannedProgram,
    Traced,
    instrument,
    trace,
)
from .offload import SCHEMES, Scheme
from .costmodel import CostModel, CostModelConfig
from .stats import Coverage, ExecutionReport, RunStats

__all__ = [
    "AVal", "Cost", "OP_REGISTRY", "PY_FUNCS", "host_log",
    "Program", "Function", "Op", "ProgramBuilder", "abstract_eval", "function_cost",
    "Emulator",
    "trace", "Traced", "PlannedProgram", "CompiledHybrid", "instrument",
    "Instrumentation", "ExecutionReport", "NativeInfeasibleError",
    "SCHEMES", "Scheme", "CostModel", "CostModelConfig", "RunStats", "Coverage",
]
