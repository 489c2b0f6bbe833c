"""`analyze()` — the one-call front door of the static-analysis layer.

Runs the pass pipeline (dataflow → offload soundness → crossing-cost →
exactness) over a Program under one :class:`~repro_torch.core.offload.Scheme`
and returns an :class:`AnalysisReport`.  Exposed as ``mixed.analyze``:

    report = mixed.analyze(program, "tech-gf", example_args=[tokens])
    assert report.ok, report

The soundness pass differentially cross-checks the planner
(:func:`~repro_torch.core.offload.analyze_eligibility`) against an independent
re-derivation; a disagreement is an error-severity diagnostic, and
``mixed.trace(prog).plan(scheme, verify=True)`` turns that into a raised
:class:`~repro_torch.core.api.PlanVerificationError` at plan time.
"""
from __future__ import annotations

from typing import Callable, Sequence

from ..core.fcp import HostOnlyOpError
from ..core.offload import Scheme, analyze_eligibility, resolve_scheme
from ..core.opset import AVal
from ..core.program import Program
from . import crossings, dataflow, exactness
from .diagnostics import AnalysisReport, DiagnosticSink
from .soundness import verify_plan

ALL_PASSES = ("dataflow", "soundness", "crossings", "exactness")


def analyze(
    program: Program,
    scheme: str | Scheme = "tech-gfp",
    *,
    unit_filter: Callable[[str], bool] | None = None,
    roots: Sequence[str] | None = None,
    example_args: Sequence | None = None,
    entry_avals: Sequence[AVal] | None = None,
    passes: Sequence[str] = ALL_PASSES,
) -> AnalysisReport:
    """Statically analyze ``program`` under ``scheme``.

    ``roots`` names additional decode roots beyond the auto-detected ones
    (``decode_step``/``paged_decode_step``/``prefill_suffix``); the program
    entry is always an analysis root.  ``example_args``/``entry_avals``
    supply the entry signature so the exactness pass can run in typed mode
    (rank/dtype-aware cache-contract verdicts).
    """
    program = getattr(program, "program", program)  # accept mixed.trace() results
    scheme = resolve_scheme(scheme)
    unknown = set(passes) - set(ALL_PASSES)
    if unknown:
        raise ValueError(f"unknown analysis passes {sorted(unknown)}; have {ALL_PASSES}")

    sink = DiagnosticSink()
    report = AnalysisReport(program.name, scheme.name, sink.diagnostics,
                            passes=tuple(p for p in ALL_PASSES if p in passes))
    try:
        program.validate()
    except ValueError as e:
        sink.emit("RA001", f"validation failed: {e}")
        return report

    decode_roots = [r for r in exactness.DEFAULT_ROOT_NAMES if r in program.functions]
    for r in roots or ():
        if r in program.functions and r not in decode_roots:
            decode_roots.append(r)
    analysis_roots = frozenset({program.entry, *decode_roots})

    if entry_avals is None and example_args is not None:
        entry_avals = tuple(AVal.of(a) for a in example_args)

    planner = None
    if "soundness" in passes or "crossings" in passes:
        try:
            planner = analyze_eligibility(program, scheme, unit_filter=unit_filter)
        except HostOnlyOpError:
            planner = None  # native infeasibility; soundness re-checks it

    if "dataflow" in passes:
        report.facts["dataflow"] = dataflow.run(program, sink, roots=analysis_roots)
    if "soundness" in passes:
        _, facts = verify_plan(
            program, scheme, sink, unit_filter=unit_filter, analysis=planner
        )
        report.facts["soundness"] = facts
    if "crossings" in passes:
        report.facts["crossings"] = crossings.run(
            program, scheme, sink, unit_filter=unit_filter, analysis=planner
        )
    if "exactness" in passes:
        report.facts["exactness"] = exactness.run(
            program, sink, roots=decode_roots, entry_avals=entry_avals
        )
    return report
