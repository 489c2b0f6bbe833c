"""Program IR — the "guest program" of the mixed-execution system.

A :class:`Program` is a call graph of :class:`Function`\\ s; each function is a
straight-line sequence of :class:`Op`\\ s in SSA form (every var assigned once).
Two special op kinds provide inter-procedural structure:

* ``call``   — invoke another function (``params["callee"]``).  This is the
  unit of offloading, exactly as functions are in the paper.
* ``repeat`` — invoke a function N times, threading outputs back to inputs
  (``params["callee"], params["times"]``).  In the interpreter it is a Python
  loop (N potential guest→host crossings when the callee is offloaded — the
  hot-loop case of the paper); on the host side it becomes a loop inside
  one offload unit.

The IR deliberately has *no* intra-function control flow: like the paper we
treat the function as the unit of extraction, and PFO splits functions into
segments when parts of their bodies cannot be offloaded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

from . import opset
from .opset import AVal, Cost

CALL_KINDS = ("call", "repeat")


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def is_call(self) -> bool:
        return self.kind in CALL_KINDS

    @property
    def callee(self) -> str | None:
        return self.params.get("callee") if self.is_call else None

    def opdef(self) -> opset.OpDef:
        return opset.get(self.kind)

    @property
    def offloadable(self) -> bool:
        """Whether this op can be part of an offloaded (host) region.

        ``call``/``repeat`` ops are resolved by the offload planner (they are
        offloadable iff policy allows — see FCP); leaf ops ask the opset.
        """
        if self.is_call:
            return True
        return self.opdef().offloadable


@dataclasses.dataclass(frozen=True)
class Function:
    name: str
    args: tuple[str, ...]
    returns: tuple[str, ...]
    ops: tuple[Op, ...]
    # Names of program-level constants referenced by this function ("globals"
    # in the paper's sense — they must be propagated to the host side).
    globals: tuple[str, ...] = ()

    def var_defs(self) -> dict[str, Op]:
        defs: dict[str, Op] = {}
        for op in self.ops:
            for o in op.outputs:
                defs[o] = op
        return defs

    def validate(self, program: "Program") -> None:
        bound = set(self.args) | set(self.globals)
        for op in self.ops:
            for i in op.inputs:
                if i not in bound:
                    raise ValueError(f"{self.name}: op {op.kind} reads unbound var {i!r}")
            for o in op.outputs:
                if o in bound:
                    raise ValueError(f"{self.name}: var {o!r} assigned twice (must be SSA)")
                bound.add(o)
            if op.is_call:
                callee = program.functions[op.params["callee"]]
                if len(op.inputs) != len(callee.args):
                    raise ValueError(
                        f"{self.name}: call {callee.name} arity {len(op.inputs)} != {len(callee.args)}"
                    )
                if len(op.outputs) != len(callee.returns):
                    raise ValueError(f"{self.name}: call {callee.name} return arity mismatch")
                if op.kind == "repeat":
                    times = op.params.get("times")
                    if isinstance(times, bool) or not isinstance(times, (int, np.integer)):
                        raise ValueError(
                            f"{self.name}: repeat {callee.name} times must be an int, got {times!r}"
                        )
                    if times < 1:
                        raise ValueError(
                            f"{self.name}: repeat {callee.name} times must be positive, got {times}"
                        )
                    # threading requires matching arity on the threaded prefix:
                    # outputs[:carry] of one iteration feed args[:carry] of the next
                    carry = op.params.get("carry", len(callee.returns))
                    if isinstance(carry, bool) or not isinstance(carry, (int, np.integer)):
                        raise ValueError(
                            f"{self.name}: repeat {callee.name} carry must be an int, got {carry!r}"
                        )
                    if carry < 0:
                        raise ValueError(f"{self.name}: repeat carry negative")
                    if carry > len(callee.args) or carry > len(callee.returns):
                        raise ValueError(f"{self.name}: repeat carry too large")
        for r in self.returns:
            if r not in bound:
                raise ValueError(f"{self.name}: returns unbound var {r!r}")


@dataclasses.dataclass
class Program:
    name: str
    functions: dict[str, Function]
    entry: str
    # program-level constants ("globals"): name -> numpy array
    constants: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        if self.entry not in self.functions:
            raise ValueError(f"entry {self.entry!r} not defined")
        for fn in self.functions.values():
            for g in fn.globals:
                if g not in self.constants:
                    raise ValueError(f"{fn.name}: global {g!r} not in program constants")
            fn.validate(self)
        # no recursion (paper's functions may recurse; our offload units may not —
        # we check and treat recursive SCCs as non-offloadable instead of failing)

    def callees(self, fname: str) -> set[str]:
        return {op.params["callee"] for op in self.functions[fname].ops if op.is_call}

    def call_graph(self) -> dict[str, set[str]]:
        return {name: self.callees(name) for name in self.functions}

    def reachable(self, root: str | None = None) -> set[str]:
        root = root or self.entry
        seen: set[str] = set()
        stack = [root]
        while stack:
            f = stack.pop()
            if f in seen:
                continue
            seen.add(f)
            stack.extend(self.callees(f))
        return seen

    def recursive_functions(self) -> set[str]:
        """Functions participating in call-graph cycles (not offload units)."""
        graph = self.call_graph()
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        result: set[str] = set()
        counter = [0]

        def strongconnect(v: str) -> None:  # iterative Tarjan
            work = [(v, iter(sorted(graph[v])))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(graph[w]))))
                        advanced = True
                        break
                    elif w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        result.update(scc)
                    elif node in graph[node]:
                        result.add(node)

        for v in graph:
            if v not in index:
                strongconnect(v)
        return result


# ---------------------------------------------------------------------------
# abstract evaluation (shape/dtype inference over a function)
# ---------------------------------------------------------------------------

def abstract_eval(
    program: Program, fname: str, arg_avals: Sequence[AVal]
) -> tuple[tuple[AVal, ...], dict[str, AVal]]:
    """Infer output avals (and the full env) of ``fname`` given input avals."""
    fn = program.functions[fname]
    if len(arg_avals) != len(fn.args):
        raise ValueError(f"{fname}: expected {len(fn.args)} args, got {len(arg_avals)}")
    env: dict[str, AVal] = dict(zip(fn.args, arg_avals))
    for g in fn.globals:
        env[g] = AVal.of(program.constants[g])
    for op in fn.ops:
        ins = [env[i] for i in op.inputs]
        if op.kind == "call":
            outs, _ = abstract_eval(program, op.params["callee"], ins)
        elif op.kind == "repeat":
            outs, _ = abstract_eval(program, op.params["callee"], ins)
            # fixed-point check: threaded carry avals must be stable
            carry = op.params.get("carry", len(outs))
            for a, b in zip(ins[:carry], outs[:carry]):
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise ValueError(
                        f"{fname}: repeat {op.params['callee']} carry aval changed {a} -> {b}"
                    )
        else:
            outs = op.opdef().infer_fn(op.params, *ins)
        if len(outs) != len(op.outputs):
            raise ValueError(f"{fname}: op {op.kind} produced {len(outs)} outs, wanted {len(op.outputs)}")
        env.update(zip(op.outputs, outs))
    return tuple(env[r] for r in fn.returns), env


def function_cost(program: Program, fname: str, arg_avals: Sequence[AVal]) -> tuple[Cost, int]:
    """Total (flops, bytes) + op count of a function, calls expanded inline."""
    fn = program.functions[fname]
    env: dict[str, AVal] = dict(zip(fn.args, arg_avals))
    for g in fn.globals:
        env[g] = AVal.of(program.constants[g])
    total = Cost()
    nops = 0
    for op in fn.ops:
        ins = [env[i] for i in op.inputs]
        if op.kind == "call":
            sub, subn = function_cost(program, op.params["callee"], ins)
            outs, _ = abstract_eval(program, op.params["callee"], ins)
            total += sub
            nops += subn
        elif op.kind == "repeat":
            sub, subn = function_cost(program, op.params["callee"], ins)
            outs, _ = abstract_eval(program, op.params["callee"], ins)
            times = op.params["times"]
            total += Cost(sub.flops * times, sub.bytes * times)
            nops += subn * times
        else:
            total += op.opdef().cost_fn(op.params, *ins)
            outs = op.opdef().infer_fn(op.params, *ins)
            nops += 1
        env.update(zip(op.outputs, outs))
    return total, nops


# ---------------------------------------------------------------------------
# builder — ergonomic construction of programs
# ---------------------------------------------------------------------------

class FunctionBuilder:
    def __init__(self, pb: "ProgramBuilder", name: str, args: Sequence[str]):
        self._pb = pb
        self.name = name
        self.args = tuple(args)
        self._ops: list[Op] = []
        self._globals: list[str] = []
        self._counter = 0

    def fresh(self, hint: str = "v") -> str:
        self._counter += 1
        return f"{self.name}.{hint}{self._counter}"

    def emit(self, kind: str, *inputs: str, nout: int = 1, **params) -> Any:
        outs = tuple(self.fresh(kind) for _ in range(nout))
        self._ops.append(Op(kind, tuple(inputs), outs, dict(params)))
        return outs[0] if nout == 1 else outs

    def call(self, callee: str, *inputs: str, nout: int | None = None) -> Any:
        if nout is None:
            nout = len(self._pb._fns[callee].returns) if callee in self._pb._fns else 1
        outs = tuple(self.fresh("c") for _ in range(nout))
        self._ops.append(Op("call", tuple(inputs), outs, {"callee": callee}))
        return outs[0] if nout == 1 else outs

    def repeat(self, callee: str, times: int, *inputs: str, nout: int | None = None, carry: int | None = None) -> Any:
        if nout is None:
            nout = len(self._pb._fns[callee].returns) if callee in self._pb._fns else 1
        outs = tuple(self.fresh("r") for _ in range(nout))
        params: dict[str, Any] = {"callee": callee, "times": times}
        if carry is not None:
            params["carry"] = carry
        self._ops.append(Op("repeat", tuple(inputs), outs, params))
        return outs[0] if nout == 1 else outs

    def use_global(self, name: str) -> str:
        if name not in self._globals:
            self._globals.append(name)
        return name

    def build(self, returns: Sequence[str]) -> Function:
        fn = Function(self.name, self.args, tuple(returns), tuple(self._ops), tuple(self._globals))
        self._pb._fns[self.name] = fn
        return fn


class ProgramBuilder:
    def __init__(self, name: str):
        self.name = name
        self._fns: dict[str, Function] = {}
        self._consts: dict[str, np.ndarray] = {}

    def constant(self, name: str, value: np.ndarray) -> str:
        self._consts[name] = np.asarray(value)
        return name

    def function(self, name: str, args: Sequence[str]) -> FunctionBuilder:
        return FunctionBuilder(self, name, args)

    def build(self, entry: str) -> Program:
        p = Program(self.name, dict(self._fns), entry, dict(self._consts))
        p.validate()
        return p
