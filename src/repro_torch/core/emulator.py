"""The DBT analogue: an op-at-a-time interpreter over host (numpy) memory.

This is the "guest emulation" side of the system.  It is deliberately
universal — it can execute *every* op in the opset, including host-only ops
(``host_print``, ``py_call``, …) that no host unit can run — and deliberately
slow: each op pays Python dispatch, parameter decoding, and materializes its
result as a fresh host array, the same per-instruction tax that makes DBT
"dozens of times slower than native".

Reentrancy: the emulator is a plain re-entrant object — offloaded host code
may call back into :meth:`Emulator.run` from inside a unit's guest callback
while an outer :meth:`run` is still on the Python stack (nested guest frames
on the host stack, mirroring the paper's stack-consistency mechanism).
"""
from __future__ import annotations

import time
from typing import Protocol, Sequence

import numpy as np

from ..obs import EMULATOR
from .program import Program, Op
from .stats import RunStats


class CallRouter(Protocol):
    """Hook the HybridExecutor uses to intercept function calls.

    ``route(fname, args, depth)`` returns the call's outputs if the callee is
    offloaded to the host side (a guest→host crossing happens inside), or
    ``None`` to tell the emulator to interpret the callee itself.
    """

    def route(self, fname: str, args: Sequence[np.ndarray], depth: int) -> tuple | None: ...


class Emulator:
    def __init__(self, program: Program, router: CallRouter | None = None,
                 stats: RunStats | None = None, tracer=None):
        self.program = program
        self.router = router
        self.stats = stats if stats is not None else RunStats()
        # an obs.Tracer, or None: the tracing-off hot path is one `is None`
        # test per interpreted function (see repro_torch.obs)
        self.tracer = tracer
        self._depth = 0

    # -- public ------------------------------------------------------------

    def run(self, fname: str, args: Sequence[np.ndarray]) -> tuple[np.ndarray, ...]:
        """Execute ``fname`` (interpreting), returning host arrays."""
        self._depth += 1
        self.stats.max_reentry_depth = max(self.stats.max_reentry_depth, self._depth)
        try:
            return self._run_function(fname, [np.asarray(a) for a in args])
        finally:
            self._depth -= 1

    def call(self, fname: str, args: Sequence[np.ndarray]) -> tuple[np.ndarray, ...]:
        """Execute a call to ``fname``, letting the router offload it."""
        routed = self._route(fname, args)
        if routed is not None:
            return routed
        return self.run(fname, args)

    # -- internals ----------------------------------------------------------

    def _route(self, fname: str, args) -> tuple | None:
        if self.router is None:
            return None
        return self.router.route(fname, args, self._depth)

    def _run_function(self, fname: str, args: list[np.ndarray]) -> tuple[np.ndarray, ...]:
        tracer = self.tracer
        if tracer is None:
            return self._run_function_inner(fname, args)
        t0 = time.perf_counter_ns()
        try:
            return self._run_function_inner(fname, args)
        finally:
            # inclusive span: nested interpreted calls are inside this one
            tracer.add(fname, EMULATOR, t0, time.perf_counter_ns() - t0)

    def _run_function_inner(self, fname: str, args: list[np.ndarray]) -> tuple[np.ndarray, ...]:
        fn = self.program.functions[fname]
        self.stats.guest_calls += 1
        if len(args) != len(fn.args):
            raise TypeError(f"{fname}: expected {len(fn.args)} args, got {len(args)}")
        env: dict[str, np.ndarray] = dict(zip(fn.args, args))
        for g in fn.globals:
            env[g] = self.program.constants[g]
        for op in fn.ops:
            ins = [env[v] for v in op.inputs]
            outs = self._execute_op(op, ins)
            env.update(zip(op.outputs, outs))
        return tuple(env[r] for r in fn.returns)

    def _execute_op(self, op: Op, ins: list[np.ndarray]) -> tuple:
        if op.kind == "call":
            routed = self._route(op.params["callee"], ins)
            if routed is not None:
                return routed
            return self._run_function(op.params["callee"], ins)
        if op.kind == "repeat":
            callee, times = op.params["callee"], op.params["times"]
            carry = op.params.get("carry", None)
            cur = list(ins)
            outs: tuple = ()
            for _ in range(times):
                routed = self._route(callee, cur)
                outs = routed if routed is not None else self._run_function(callee, cur)
                ncarry = carry if carry is not None else len(outs)
                cur[:ncarry] = outs[:ncarry]
            return outs
        # leaf op: guest-side numpy execution ("translated block").
        self.stats.guest_ops += 1
        opdef = op.opdef()
        result = opdef.numpy_fn(op.params, *ins)
        # guest memory model: every result is materialized as a host array
        return tuple(np.asarray(r) for r in result)
