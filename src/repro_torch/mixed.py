"""The staged mixed-execution namespace: ``from repro_torch import mixed``.

    hybrid = mixed.trace(program).plan("tech-gf").compile()   # units on CUDA
    out = hybrid(*args)                     # plans per entry signature
    with mixed.instrument() as rec:         # per-call ExecutionReports
        hybrid(*args)
    print(rec.merged().guest_to_host)

    report = mixed.analyze(program, "tech-gf")  # static analysis & lint
    assert report.ok, report                # no error-severity diagnostics

Re-exports the staged frontend (:mod:`repro_torch.core.api`) plus the scheme
vocabulary, so application code needs exactly one import.

Every object here is safe to share across threads (see
:class:`~repro_torch.core.api.CompiledHybrid` for the concurrency model);
token-level continuous batching is built on top in :mod:`repro_torch.serve`.
"""
from .analysis import AnalysisReport, analyze
from .core.api import (
    CompiledHybrid,
    Instrumentation,
    NativeInfeasibleError,
    PlannedProgram,
    PlanVerificationError,
    Traced,
    instrument,
    trace,
)
from .core.costmodel import CostModel, CostModelConfig
from .core.offload import SCHEMES, Scheme
from .core.stats import ExecutionReport

__all__ = [
    "AnalysisReport", "analyze",
    "CompiledHybrid", "Instrumentation", "NativeInfeasibleError",
    "PlannedProgram", "PlanVerificationError", "Traced", "instrument", "trace",
    "CostModel", "CostModelConfig", "SCHEMES", "Scheme", "ExecutionReport",
]
