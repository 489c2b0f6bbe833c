"""Dataflow core pass (RA1xx): def-use, liveness, dead code, purity.

Bodies are straight-line SSA, so liveness is a single backward sweep per
function: start from the returned vars, walk ops in reverse, and keep an
op alive iff any of its outputs is live (effectful ops are always kept).
Inputs of dead pure ops are *not* marked live, so transitively-dead chains
collapse in one sweep.

Purity is inter-procedural: a function is pure iff no op in its inline
closure is effectful.  Effects are the host-only opset entries
(``host_print``/``host_assert_finite``/``py_call``) — everything else in
the opset is a pure array op.  Computed as a monotone fixed point over the
call graph, so recursion converges.
"""
from __future__ import annotations

import dataclasses

from ..core.program import Program, Function, Op
from .diagnostics import DiagnosticSink


def _op_effectful(program: Program, op: Op, impure: set[str]) -> bool:
    if op.is_call:
        return op.params["callee"] in impure
    return not op.opdef().offloadable  # host-only leaf ops are the effects


@dataclasses.dataclass(frozen=True)
class FunctionDataflow:
    """Per-function dataflow summary (one entry per function in facts)."""

    name: str
    pure: bool
    effects: tuple[str, ...]            # host-only op kinds in the inline closure
    dead_ops: tuple[int, ...]           # removable op indices (pure + unused)
    kept_effectful: tuple[int, ...]     # unused results but op must stay
    unused_args: tuple[str, ...]
    unused_globals: tuple[str, ...]
    live_return_positions: tuple[int, ...] | None  # None for analysis roots

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _effect_closure(program: Program) -> dict[str, tuple[str, ...]]:
    """fname -> sorted host-effect op kinds transitively reachable from it."""
    direct: dict[str, set[str]] = {}
    for name, fn in program.functions.items():
        direct[name] = {
            op.kind for op in fn.ops if not op.is_call and not op.opdef().offloadable
        }
    changed = True
    while changed:
        changed = False
        for name, fn in program.functions.items():
            for op in fn.ops:
                if op.is_call:
                    callee_fx = direct.get(op.params["callee"], set())
                    if not callee_fx <= direct[name]:
                        direct[name] |= callee_fx
                        changed = True
    return {name: tuple(sorted(fx)) for name, fx in direct.items()}


def _backward_liveness(
    program: Program, fn: Function, impure: set[str]
) -> tuple[set[str], list[int], list[int], dict[int, set[int]]]:
    """One reverse sweep: (live vars, dead op idxs, kept-effectful idxs,
    live output positions per call-op index)."""
    live: set[str] = set(fn.returns)
    dead: list[int] = []
    kept: list[int] = []
    call_live_pos: dict[int, set[int]] = {}
    for idx in range(len(fn.ops) - 1, -1, -1):
        op = fn.ops[idx]
        out_live = {p for p, o in enumerate(op.outputs) if o in live}
        if op.kind == "repeat":
            # carried positions feed the next iteration whether or not the
            # final value is consumed — they are used by the loop itself
            callee = program.functions[op.params["callee"]]
            carry = op.params.get("carry", len(callee.returns))
            out_live |= set(range(min(carry, len(op.outputs))))
        effectful = _op_effectful(program, op, impure)
        if not out_live and not effectful:
            dead.append(idx)
            continue  # inputs of a dead pure op stay dead
        if not {p for p, o in enumerate(op.outputs) if o in live} and effectful:
            kept.append(idx)
        if op.is_call:
            call_live_pos[idx] = out_live
        live.update(op.inputs)
    return live, sorted(dead), sorted(kept), call_live_pos


def run(
    program: Program,
    sink: DiagnosticSink,
    *,
    roots: frozenset | set | tuple = (),
) -> dict:
    """Run the dataflow pass; emit RA101–RA106 and return the facts dict.

    ``roots`` are the external entry points (the program entry plus decode
    roots): their returns count as consumed and they are never "unreachable".
    """
    roots = set(roots) or {program.entry}
    effects = _effect_closure(program)
    impure = {f for f, fx in effects.items() if fx}

    reachable: set[str] = set()
    for r in roots:
        if r in program.functions:
            reachable |= program.reachable(r)

    # which return positions of each callee are consumed at any call site
    consumed_returns: dict[str, set[int]] = {f: set() for f in program.functions}
    per_fn: dict[str, FunctionDataflow] = {}
    liveness: dict[str, tuple] = {}
    for name in sorted(program.functions):
        fn = program.functions[name]
        live, dead, kept, call_live = _backward_liveness(program, fn, impure)
        liveness[name] = (live, dead, kept)
        for idx, positions in call_live.items():
            consumed_returns[fn.ops[idx].params["callee"]] |= positions

    for name in sorted(program.functions):
        fn = program.functions[name]
        live, dead, kept = liveness[name]
        in_graph = name in reachable

        for idx in dead:
            op = fn.ops[idx]
            if in_graph:
                sink.emit(
                    "RA101",
                    f"results {op.outputs} of {op.kind!r} are never used",
                    fname=name, op_index=idx, op_kind=op.kind,
                    hint="delete the op (pure, all outputs dead)",
                )
        for idx in kept:
            op = fn.ops[idx]
            if in_graph:
                sink.emit(
                    "RA102",
                    f"results {op.outputs} of effectful {op.kind!r} are never used "
                    f"(op kept for its effect)",
                    fname=name, op_index=idx, op_kind=op.kind,
                )

        unused_args = tuple(a for a in fn.args if a not in live)
        unused_globals = tuple(g for g in fn.globals if g not in live)
        if in_graph:
            for a in unused_args:
                sink.emit("RA106", f"argument {a!r} is never read", fname=name)
            for g in unused_globals:
                sink.emit(
                    "RA105", f"global {g!r} declared but never read", fname=name,
                    hint="drop it from Function.globals",
                )

        live_rets: tuple[int, ...] | None
        if name in roots:
            live_rets = None  # external contract; all outputs count as used
        else:
            live_rets = tuple(sorted(consumed_returns[name]))
            if in_graph:
                for p in range(len(fn.returns)):
                    if p not in consumed_returns[name]:
                        sink.emit(
                            "RA103",
                            f"output {p} ({fn.returns[p]!r}) unused at every call site",
                            fname=name,
                        )
        if not in_graph:
            sink.emit(
                "RA104",
                f"function {name!r} unreachable from roots {sorted(roots)}",
                fname=name,
            )

        per_fn[name] = FunctionDataflow(
            name=name,
            pure=name not in impure,
            effects=effects[name],
            dead_ops=tuple(dead),
            kept_effectful=tuple(kept),
            unused_args=unused_args,
            unused_globals=unused_globals,
            live_return_positions=live_rets,
        )

    # program-level: constants no reachable function declares as a global
    declared: set[str] = set()
    for name in reachable:
        declared.update(program.functions[name].globals)
    for const in sorted(program.constants):
        if const not in declared:
            sink.emit(
                "RA105", f"program constant {const!r} never declared by a "
                f"reachable function", hint="drop it from Program.constants",
            )

    return {
        "functions": {n: s.as_dict() for n, s in per_fn.items()},
        "reachable": sorted(reachable),
        "impure": sorted(impure & set(program.functions)),
    }
