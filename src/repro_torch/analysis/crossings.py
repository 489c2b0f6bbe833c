"""Crossing-cost lint pass (RA3xx): static bounds on guest/host crossings.

Abstract-interprets the call graph of the planner's transformed program and
computes, per function, how many boundary crossings one invocation costs in
the worst case, assuming every compilable & reachable function becomes an
offload unit (the permissive-cost-model upper bound).  Two mutually
recursive summaries:

* ``emu(f)``  — crossings while ``f`` runs in the emulator.  Each call to a
  unit is one guest→host crossing plus whatever the unit's host execution
  costs; calls to non-units recurse into ``emu``.
* ``host(f)`` — crossings while ``f`` runs inside a compiled region.  An
  inlined callee costs nothing extra; a non-inlined callee is one
  host→guest *reentry* plus its emulated cost.

``repeat`` multiplies by ``times`` — and when the callee is a unit but the
repeat itself is emulated, that is the paper's hot-loop pathology: one
crossing **per iteration** (RA301), with the FCP/PFO remedy suggested in
the diagnostic.  Recursion makes the bound unbounded (RA303, ``inf``).
"""
from __future__ import annotations

import math
from typing import Callable

from ..core.offload import EligibilityAnalysis, Scheme, analyze_eligibility, resolve_scheme
from ..core.program import Program
from .diagnostics import DiagnosticSink


def _add(a: tuple, b: tuple, scale: int = 1) -> tuple:
    return (a[0] + scale * b[0], a[1] + scale * b[1])


class _CrossingModel:
    """Memoized (guest→host, host→guest) crossing bounds per function."""

    def __init__(self, analysis: EligibilityAnalysis):
        self.work = analysis.program
        self.policy = analysis.policy
        # permissive upper bound: every compilable & reachable fn is a unit
        self.units = frozenset(analysis.compilable & analysis.reachable)
        self._emu: dict[str, tuple] = {}
        self._host: dict[str, tuple] = {}
        self.hot_repeats: list[tuple[str, int, str, int]] = []  # (fn, op idx, callee, times)

    def emu(self, fname: str, stack: frozenset = frozenset()) -> tuple:
        if fname in self._emu:
            return self._emu[fname]
        if fname in stack:  # recursion: unbounded
            return (math.inf, math.inf)
        stack = stack | {fname}
        total = (0, 0)
        fn = self.work.functions[fname]
        for idx, op in enumerate(fn.ops):
            if not op.is_call:
                continue
            g = op.params["callee"]
            times = op.params.get("times", 1) if op.kind == "repeat" else 1
            if g in self.units:
                # guest→host dispatch, then whatever the host region costs
                per_iter = _add((1, 0), self.host(g, stack))
                total = _add(total, per_iter, times)
                if op.kind == "repeat":
                    self.hot_repeats.append((fname, idx, g, times))
            else:
                total = _add(total, self.emu(g, stack), times)
        if not math.isinf(total[0]):
            self._emu[fname] = total
        return total

    def host(self, fname: str, stack: frozenset = frozenset()) -> tuple:
        if fname in self._host:
            return self._host[fname]
        if fname in stack:
            return (math.inf, math.inf)
        stack = stack | {fname}
        total = (0, 0)
        fn = self.work.functions[fname]
        for op in fn.ops:
            if not op.is_call:
                continue
            g = op.params["callee"]
            times = op.params.get("times", 1) if op.kind == "repeat" else 1
            if self.policy.should_inline(g):
                total = _add(total, self.host(g, stack), times)
            else:
                # reentry: host→guest callback, then the emulated callee
                per = _add((0, 1), self.emu(g, stack))
                total = _add(total, per, times)
        if not math.isinf(total[0]):
            self._host[fname] = total
        return total

    def entry_bound(self) -> tuple:
        entry = self.work.entry
        if entry in self.units:
            return _add((1, 0), self.host(entry))
        return self.emu(entry)


def _hot_repeat_hint(scheme: Scheme) -> str:
    if not scheme.fcp:
        return (
            "enable FCP (Scheme.base().with_fcp() / 'tech-gf') so the loop "
            "iterates inside one compiled region"
        )
    if not scheme.pfo:
        return (
            "the parent is host-blocked; enable PFO "
            "(.with_pfo() / 'tech-gfp') to outline the loop into a segment"
        )
    return "restructure so the repeat sits in an offloadable function"


def run(
    program: Program,
    scheme: str | Scheme,
    sink: DiagnosticSink,
    *,
    unit_filter: Callable[[str], bool] | None = None,
    analysis: EligibilityAnalysis | None = None,
) -> dict:
    """Run the crossing lint; emit RA301–RA304 and return the facts dict."""
    scheme = resolve_scheme(scheme)
    if scheme.native:
        # complete cross-compilation: exactly one crossing per entry call
        # (feasibility itself is the soundness pass's concern)
        return {"entry_bound": {"guest_to_host": 1, "host_to_guest": 0}}
    if not scheme.offload:
        return {"entry_bound": {"guest_to_host": 0, "host_to_guest": 0}}
    if analysis is None:
        analysis = analyze_eligibility(program, scheme, unit_filter=unit_filter)

    model = _CrossingModel(analysis)
    g2h, h2g = model.entry_bound()

    # recursion paths skip memoization, so the same hot repeat can be
    # recorded more than once — dedupe by site
    hot_sites: list[tuple[str, int, str, int]] = []
    seen_sites: set[tuple[str, int]] = set()
    for fname, idx, callee, times in model.hot_repeats:
        if (fname, idx) in seen_sites:
            continue
        seen_sites.add((fname, idx))
        hot_sites.append((fname, idx, callee, times))
        sink.emit(
            "RA301",
            f"repeat {callee!r} x{times} runs in the emulator while the callee "
            f"is offloaded: {times} guest->host crossings per invocation of "
            f"{fname!r}",
            fname=fname, op_index=idx, op_kind="repeat",
            hint=_hot_repeat_hint(scheme),
        )

    # host-blocked functions whose bodies still dispatch units pay per-call
    # crossings that PFO would fold into segments
    per_fn: dict[str, dict] = {}
    for f in sorted(analysis.reachable):
        if f not in model.work.functions:
            continue
        eg, eh = (model.emu(f) if f not in model.units
                  else _add((1, 0), model.host(f)))
        per_fn[f] = {
            "unit": f in model.units,
            "guest_to_host": eg if not math.isinf(eg) else "inf",
            "host_to_guest": eh if not math.isinf(eh) else "inf",
        }
        if (
            not scheme.pfo
            and f not in model.units
            and f in analysis.blockers
            and analysis.blockers[f].startswith("host-only")
            and not math.isinf(eg)
            and eg > 0
        ):
            sink.emit(
                "RA304",
                f"host-blocked {f!r} dispatches units {eg} time(s) per call",
                fname=f,
                hint="enable PFO to outline the offloadable runs into segments",
            )

    if math.isinf(g2h):
        sink.emit(
            "RA303",
            "crossing bound is unbounded: recursion reaches an offload boundary",
            fname=program.entry,
        )
        entry_facts = {"guest_to_host": "inf", "host_to_guest": "inf"}
    else:
        sink.emit(
            "RA302",
            f"one entry call crosses guest->host at most {g2h} and "
            f"host->guest at most {h2g} time(s)",
            fname=program.entry,
        )
        entry_facts = {"guest_to_host": g2h, "host_to_guest": h2g}

    return {
        "entry_bound": entry_facts,
        "per_function": per_fn,
        "units_assumed": sorted(model.units),
        "hot_repeats": [
            {"fname": f, "op_index": i, "callee": c, "times": t}
            for f, i, c, t in hot_sites
        ],
    }
