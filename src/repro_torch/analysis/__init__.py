"""Static analysis & plan verification over the Program IR.

Four passes with structured diagnostics (stable ``RA1xx``–``RA4xx`` codes,
op-level locations):

* :mod:`~repro_torch.analysis.dataflow`  — def-use/liveness, dead code, purity
* :mod:`~repro_torch.analysis.soundness` — independent compilable-set verifier,
  differentially cross-checked against the offload planner
* :mod:`~repro_torch.analysis.crossings` — static guest/host crossing bounds and
  the per-iteration hot-``repeat`` lint
* :mod:`~repro_torch.analysis.exactness` — bitwise cache-contract verification
  for decode roots

Entry points: :func:`analyze` (also ``mixed.analyze``) and the
``python -m repro_torch.bench.analyze`` sweep.
"""
from .api import ALL_PASSES, analyze
from .diagnostics import CODES, AnalysisReport, Diagnostic, DiagnosticSink
from .soundness import Derivation, derive_compilable, verify_plan

__all__ = [
    "ALL_PASSES",
    "analyze",
    "AnalysisReport",
    "CODES",
    "Derivation",
    "Diagnostic",
    "DiagnosticSink",
    "derive_compilable",
    "verify_plan",
]
