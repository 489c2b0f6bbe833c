"""Offload-soundness verifier pass (RA2xx).

Independently re-derives the compilable set — the planner's central verdict —
and differentially cross-checks it against :func:`analyze_eligibility`.
Deliberately different algorithms so a shared bug cannot hide the
disagreement:

* reachability: BFS (planner: DFS stack walk)
* recursion:    Kosaraju two-pass SCC (planner: iterative Tarjan)
* repeat fixed point: reverse-dependency worklist (planner: iterate-until-
  stable full rescan)

The differential compares **original function names only**: under PFO the
planner's compilable set additionally contains synthesized ``f#segK``
segments the verifier cannot re-derive without re-implementing the
outliner.  Those are instead checked against the offload-unit *invariants*
(no host-only leaf op, every ``repeat`` callee inlinable, base function
passes the unit filter) — a violation is RA207.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

from ..core.fcp import HostOnlyOpError
from ..core.offload import EligibilityAnalysis, Scheme, analyze_eligibility, resolve_scheme
from ..core.program import Program
from .diagnostics import DiagnosticSink


def _bfs_reachable(program: Program, root: str) -> frozenset:
    seen = {root}
    queue = deque([root])
    while queue:
        f = queue.popleft()
        for op in program.functions[f].ops:
            if op.is_call:
                g = op.params["callee"]
                if g not in seen:
                    seen.add(g)
                    queue.append(g)
    return frozenset(seen)


def _kosaraju_recursive(program: Program) -> frozenset:
    """Functions on call-graph cycles, via Kosaraju's two-pass algorithm."""
    graph = {name: sorted(program.callees(name)) for name in program.functions}
    order: list[str] = []
    seen: set[str] = set()
    for start in sorted(graph):
        if start in seen:
            continue
        stack: list[tuple[str, int]] = [(start, 0)]
        seen.add(start)
        while stack:
            node, i = stack[-1]
            if i < len(graph[node]):
                stack[-1] = (node, i + 1)
                nxt = graph[node][i]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, 0))
            else:
                stack.pop()
                order.append(node)
    rev: dict[str, list[str]] = {name: [] for name in graph}
    for name, callees in graph.items():
        for g in callees:
            rev[g].append(name)
    comp: dict[str, int] = {}
    cid = 0
    for node in reversed(order):
        if node in comp:
            continue
        members = [node]
        comp[node] = cid
        work = [node]
        while work:
            v = work.pop()
            for w in rev[v]:
                if w not in comp:
                    comp[w] = cid
                    members.append(w)
                    work.append(w)
        cid += 1
    sizes: dict[int, int] = {}
    for c in comp.values():
        sizes[c] = sizes.get(c, 0) + 1
    out = {f for f, c in comp.items() if sizes[c] > 1}
    out |= {f for f in graph if f in graph[f]}  # self-loops
    return frozenset(out)


def _host_blocked_kinds(program: Program, fname: str) -> tuple[str, ...]:
    return tuple(
        op.kind for op in program.functions[fname].ops
        if not op.is_call and not op.opdef().offloadable
    )


@dataclasses.dataclass(frozen=True)
class Derivation:
    """The verifier's independently computed verdict."""

    compilable: frozenset
    reachable: frozenset
    recursive: frozenset
    blockers: dict  # fname -> reason string


def derive_compilable(
    program: Program,
    scheme: str | Scheme,
    *,
    unit_filter: Callable[[str], bool] | None = None,
) -> Derivation:
    """Re-derive the compilable set of the *original* program under a scheme."""
    scheme = resolve_scheme(scheme)
    reachable = _bfs_reachable(program, program.entry)
    recursive = _kosaraju_recursive(program)
    blockers: dict[str, str] = {}
    if not scheme.offload and not scheme.native:  # qemu: nothing is extracted
        return Derivation(frozenset(), reachable, recursive, blockers)

    candidates: set[str] = set()
    for f in sorted(reachable):
        if f in recursive:
            blockers[f] = "recursive"
            continue
        blocked = _host_blocked_kinds(program, f)
        if blocked:
            blockers[f] = f"host-only op {blocked[0]!r}"
            continue
        if unit_filter is not None and not scheme.native and not unit_filter(f):
            blockers[f] = "unit_filter"
            continue
        candidates.add(f)

    if scheme.native:  # all-or-nothing: feasible iff every reachable fn is clean
        feasible = not any(f in blockers for f in reachable)
        return Derivation(
            reachable if feasible else frozenset(), reachable, recursive, blockers
        )

    # repeat constraint via a reverse-dependency worklist: a parent stays
    # compilable only while (scheme.fcp and callee compilable) holds for
    # every repeat op in its body
    rdeps: dict[str, set[str]] = {}
    for f in reachable:
        for op in program.functions[f].ops:
            if op.kind == "repeat":
                rdeps.setdefault(op.params["callee"], set()).add(f)

    def repeats_ok(f: str) -> bool:
        return all(
            scheme.fcp and op.params["callee"] in candidates
            for op in program.functions[f].ops
            if op.kind == "repeat"
        )

    queue = deque(f for f in sorted(candidates) if not repeats_ok(f))
    while queue:
        f = queue.popleft()
        if f not in candidates or repeats_ok(f):
            continue
        candidates.discard(f)
        bad = next(
            op.params["callee"] for op in program.functions[f].ops
            if op.kind == "repeat"
            and not (scheme.fcp and op.params["callee"] in candidates)
        )
        blockers[f] = f"repeat {bad!r} not inlinable"
        queue.extend(sorted(rdeps.get(f, ())))

    return Derivation(frozenset(candidates), reachable, recursive, blockers)


def _check_segment(
    analysis: EligibilityAnalysis,
    seg: str,
    unit_filter: Callable[[str], bool] | None,
    sink: DiagnosticSink,
) -> None:
    """PFO segments must satisfy the offload-unit invariants (RA207)."""
    work = analysis.program
    if seg not in work.functions:
        sink.emit("RA207", f"planner compilable set names missing segment {seg!r}")
        return
    base = seg.split("#", 1)[0]
    if unit_filter is not None and not unit_filter(base):
        sink.emit(
            "RA207", f"segment of {base!r} which the unit filter excludes", fname=seg
        )
    blocked = _host_blocked_kinds(work, seg)
    if blocked:
        sink.emit(
            "RA207", f"segment contains host-only op {blocked[0]!r}", fname=seg,
            op_kind=blocked[0],
        )
    for idx, op in enumerate(work.functions[seg].ops):
        if op.kind == "repeat":
            callee = op.params["callee"]
            if not (analysis.scheme.fcp and callee in analysis.compilable):
                sink.emit(
                    "RA207",
                    f"segment repeats non-inlinable callee {callee!r}",
                    fname=seg, op_index=idx, op_kind="repeat",
                )


def verify_plan(
    program: Program,
    scheme: str | Scheme,
    sink: DiagnosticSink | None = None,
    *,
    unit_filter: Callable[[str], bool] | None = None,
    analysis: EligibilityAnalysis | None = None,
) -> tuple[DiagnosticSink, dict]:
    """Differentially cross-check the planner against the verifier.

    ``program`` must be the *original* (pre-PFO) program; ``analysis`` may
    pass in the planner's verdict to avoid recomputing it.  Emits RA201/
    RA202/RA203/RA207 errors on disagreement and RA204/RA205/RA206 infos
    explaining each emulated-side residency; returns ``(sink, facts)``.
    """
    scheme = resolve_scheme(scheme)
    sink = sink or DiagnosticSink()
    derived = derive_compilable(program, scheme, unit_filter=unit_filter)

    planner_feasible = True
    planner_error: str | None = None
    if analysis is None:
        try:
            analysis = analyze_eligibility(program, scheme, unit_filter=unit_filter)
        except HostOnlyOpError as e:
            planner_feasible = False
            planner_error = str(e)

    facts: dict = {
        "scheme": scheme.name,
        "verifier": {
            "compilable": sorted(derived.compilable),
            "reachable": sorted(derived.reachable),
            "recursive": sorted(derived.recursive),
            "blockers": dict(sorted(derived.blockers.items())),
        },
    }

    if scheme.native:
        verifier_feasible = not any(f in derived.blockers for f in derived.reachable)
        facts["native_feasible"] = {
            "planner": planner_feasible, "verifier": verifier_feasible,
        }
        if planner_feasible != verifier_feasible:
            sink.emit(
                "RA203",
                f"planner says native {'feasible' if planner_feasible else 'infeasible'}"
                f" ({planner_error or 'ok'}), verifier says "
                f"{'feasible' if verifier_feasible else 'infeasible'}",
            )
        elif planner_feasible and analysis is not None:
            if frozenset(analysis.compilable) != derived.compilable:
                sink.emit(
                    "RA203",
                    "native compilable set mismatch: planner "
                    f"{sorted(analysis.compilable)} vs verifier "
                    f"{sorted(derived.compilable)}",
                )
        if not verifier_feasible:
            for f in sorted(derived.reachable):
                if f in derived.blockers:
                    _explain_blocker(program, f, derived.blockers[f], sink)
        return sink, facts

    if analysis is None:  # non-native planner never raises; defensive
        sink.emit("RA203", f"planner raised on non-native scheme: {planner_error}")
        return sink, facts

    planner_orig = frozenset(f for f in analysis.compilable if "#" not in f)
    segments = sorted(f for f in analysis.compilable if "#" in f)
    facts["planner"] = {
        "compilable": sorted(analysis.compilable),
        "segments": segments,
        "blockers": dict(sorted(analysis.blockers.items())),
    }

    for f in sorted(planner_orig - derived.compilable):
        sink.emit(
            "RA201",
            f"planner marked {f!r} compilable; verifier blocks it "
            f"({derived.blockers.get(f, 'not derivable')})",
            fname=f,
        )
    for f in sorted(derived.compilable - planner_orig):
        sink.emit(
            "RA202",
            f"verifier derives {f!r} compilable; planner rejected it "
            f"({analysis.blockers.get(f, 'no reason recorded')})",
            fname=f,
        )
    for seg in segments:
        _check_segment(analysis, seg, unit_filter, sink)

    # explain (info) why each reachable function stays on the emulated side
    for f in sorted(derived.reachable - derived.compilable):
        reason = derived.blockers.get(f)
        if reason is not None:
            _explain_blocker(program, f, reason, sink)

    facts["agree"] = planner_orig == derived.compilable
    return sink, facts


def _explain_blocker(
    program: Program, fname: str, reason: str, sink: DiagnosticSink
) -> None:
    if reason == "recursive":
        sink.emit(
            "RA205", f"{fname!r} participates in a call-graph cycle", fname=fname
        )
    elif reason.startswith("host-only"):
        for idx, op in enumerate(program.functions[fname].ops):
            if not op.is_call and not op.opdef().offloadable:
                sink.emit(
                    "RA204",
                    f"host-only op {op.kind!r} keeps {fname!r} emulated",
                    fname=fname, op_index=idx, op_kind=op.kind,
                )
    elif reason.startswith("repeat"):
        for idx, op in enumerate(program.functions[fname].ops):
            if op.kind == "repeat":
                sink.emit(
                    "RA206",
                    f"repeat callee {op.params['callee']!r} not inlinable; "
                    f"{fname!r} stays emulated ({reason})",
                    fname=fname, op_index=idx, op_kind="repeat",
                )
                break
    # "unit_filter" blockers need no diagnostic: exclusion was requested
