"""Structured diagnostics for the Program-IR static-analysis passes.

Every finding a pass emits is a :class:`Diagnostic` with a **stable code**
(``RA101`` …), a fixed severity, a human-readable message, and an op-level
location (function name + op index + op kind).  Codes are registered in
:data:`CODES` so tooling (the CLI baseline, tests, docs) can rely on the
taxonomy:

* ``RA0xx`` — program validity (the program could not be analyzed at all)
* ``RA1xx`` — dataflow: dead ops, unused outputs/globals/args, reachability
* ``RA2xx`` — offload soundness: the independent compilable-set verifier
  and its differential cross-check against the planner
* ``RA3xx`` — crossing-cost lint: static crossing bounds, per-iteration
  ``repeat`` crossings (the paper's hot-loop pathology)
* ``RA4xx`` — exactness lint: the bitwise-reproducibility contracts the
  decode serving tier relies on

Severities: ``error`` (the plan/program is unsound — CI gates on zero),
``warn`` (quality finding — CI gates on the committed baseline), ``info``
(facts surfaced for humans; never gated).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

ERROR = "error"
WARN = "warn"
INFO = "info"
_SEVERITIES = (ERROR, WARN, INFO)

# code -> (severity, title).  Stable: never renumber, only append.
CODES: dict[str, tuple[str, str]] = {
    "RA001": (ERROR, "program failed IR validation"),
    # -- dataflow ----------------------------------------------------------
    "RA101": (WARN, "dead op: results never used"),
    "RA102": (INFO, "dead results on an effectful op (op must stay)"),
    "RA103": (WARN, "function output unused at every call site"),
    "RA104": (WARN, "function unreachable from any analysis root"),
    "RA105": (WARN, "global declared but never read"),
    "RA106": (INFO, "argument never read"),
    # -- offload soundness -------------------------------------------------
    "RA201": (ERROR, "planner marked compilable; verifier refutes"),
    "RA202": (ERROR, "verifier derives compilable; planner rejected"),
    "RA203": (ERROR, "native-feasibility verdict disagreement"),
    "RA204": (INFO, "host-only op keeps function emulated"),
    "RA205": (INFO, "recursive SCC keeps function emulated"),
    "RA206": (INFO, "repeat callee not inlinable keeps function emulated"),
    "RA207": (ERROR, "PFO segment violates offload-unit invariants"),
    # -- crossing-cost lint ------------------------------------------------
    "RA301": (WARN, "repeat crosses the guest/host boundary per iteration"),
    "RA302": (INFO, "static crossing bound for one entry call"),
    "RA303": (INFO, "crossing bound unbounded (recursion)"),
    "RA304": (INFO, "host-blocked function pays per-call unit crossings"),
    # -- exactness lint ----------------------------------------------------
    "RA401": (ERROR, "cached-state output modified outside a select"),
    "RA402": (WARN, "decode root breaks fixed-shape discipline"),
    "RA403": (ERROR, "paged fresh-row output depends on the page pool"),
    "RA404": (WARN, "decode root does not match the step-fn contract"),
    "RA405": (INFO, "state pair not verifiable without avals"),
}


def severity_of(code: str) -> str:
    return CODES[code][0]


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code, severity, message, op-level location."""

    code: str
    severity: str
    message: str
    fname: str | None = None          # function the finding is anchored in
    op_index: int | None = None       # index into Function.ops (op-level location)
    op_kind: str | None = None
    hint: str | None = None           # suggested fix (e.g. the FCP/PFO remedy)

    @property
    def location(self) -> str:
        if self.fname is None:
            return "<program>"
        if self.op_index is None:
            return self.fname
        kind = f" {self.op_kind}" if self.op_kind else ""
        return f"{self.fname}[op {self.op_index}{kind}]"

    def __str__(self) -> str:
        hint = f"  (fix: {self.hint})" if self.hint else ""
        return f"{self.code} {self.severity:5s} {self.location}: {self.message}{hint}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class DiagnosticSink:
    """Collector the passes emit into; validates codes against :data:`CODES`."""

    def __init__(self):
        self.diagnostics: list[Diagnostic] = []

    def emit(
        self,
        code: str,
        message: str,
        *,
        fname: str | None = None,
        op_index: int | None = None,
        op_kind: str | None = None,
        hint: str | None = None,
    ) -> Diagnostic:
        if code not in CODES:
            raise KeyError(f"unregistered diagnostic code {code!r}")
        d = Diagnostic(code, severity_of(code), message, fname, op_index, op_kind, hint)
        self.diagnostics.append(d)
        return d

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)


@dataclasses.dataclass
class AnalysisReport:
    """Everything one :func:`repro_torch.analysis.analyze` run produced.

    ``diagnostics`` is the ordered finding list; ``facts`` is the
    machine-readable per-pass output (per-unit records, crossing bounds,
    verifier verdicts) that downstream tooling — the CLI baseline, the
    traffic-adaptive planner — consumes.
    """

    program: str
    scheme: str
    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)
    facts: dict[str, Any] = dataclasses.field(default_factory=dict)
    passes: tuple[str, ...] = ()

    # -- selection ----------------------------------------------------------

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARN]

    @property
    def infos(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == INFO]

    @property
    def ok(self) -> bool:
        """True when no error-severity diagnostics were produced."""
        return not self.errors

    def by_code(self, code: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def codes(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for d in self.diagnostics:
            out[d.code] = out.get(d.code, 0) + 1
        return dict(sorted(out.items()))

    # -- rendering ----------------------------------------------------------

    def __str__(self) -> str:
        head = (
            f"AnalysisReport({self.program!r}, scheme={self.scheme!r}, "
            f"passes={'+'.join(self.passes)}): "
            f"{len(self.errors)} errors, {len(self.warnings)} warnings, "
            f"{len(self.infos)} infos"
        )
        lines = [head]
        for d in self.diagnostics:
            lines.append(f"  {d}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            "program": self.program,
            "scheme": self.scheme,
            "passes": list(self.passes),
            "ok": self.ok,
            "codes": self.codes(),
            "diagnostics": [d.as_dict() for d in self.diagnostics],
            "facts": self.facts,
        }
