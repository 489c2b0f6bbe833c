"""Host-side lowering of offloaded functions + the Fast Calling Path (FCP).

``trace_function`` runs a Program function as eager torch operations on the
unit's device.  Calls to other functions take one of two lowerings:

* **FCP on** (``tech-gf`` / ``tech-gfp``) and the callee is natively
  executable → the callee runs *inline* in the same host region: offloaded
  functions call each other directly on the host side, with no guest↔host
  boundary crossing (paper §3.4: FCP "lets offloaded functions call each
  other directly without switching to the guest emulation").

* otherwise → the call lowers to a host→guest callback
  (:func:`repro_torch.core.reentrancy.emit_guest_callback`): execution
  bounces through the emulator, which may itself re-offload the callee —
  this is the paper's baseline behaviour in which *every* inter-function
  edge crosses the boundary (QEMU's switching machinery on every call).

``repeat`` ops (hot loops) become a Python loop inside the unit when the
callee can be inlined; otherwise the loop is not host-executable at all
(looping over a guest callback would be pathological) and the containing
function stays on the guest side — which is precisely why, without FCP, hot
loops produce millions of crossings (paper Fig. 5, npbbt: 6,713,003 → 206).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .opset import AVal, numpy_dtype, torch_dtype
from .program import Program, abstract_eval
from .reentrancy import emit_guest_callback


class HostOnlyOpError(Exception):
    """Raised when lowering hits an op with no host (torch) semantics."""

    def __init__(self, kind: str, fname: str):
        super().__init__(f"op {kind!r} in function {fname!r} is host-only (cannot be offloaded)")
        self.kind = kind
        self.fname = fname


@dataclasses.dataclass(frozen=True)
class InlinePolicy:
    """Who may be traced inline into a host region."""

    inline_all: bool = False              # 'native' scheme: complete cross-compilation
    fcp: bool = False
    compilable: frozenset = frozenset()   # natively-executable function set

    def should_inline(self, callee: str) -> bool:
        if self.inline_all:
            return True
        return self.fcp and callee in self.compilable


def trace_function(
    program: Program,
    fname: str,
    policy: InlinePolicy,
    reentry: Callable[[int, str, tuple], tuple],
    globals_env: dict,
    args: Sequence,
    token=None,
    device: torch.device | None = None,
    run_op: Callable | None = None,
) -> tuple:
    """Run ``fname`` as torch ops on ``device`` (default: the CPU).

    ``token`` is the reentry-channel id every guest callback carries (see
    :mod:`repro_torch.core.reentrancy`); ``None`` (direct lowering outside an
    offload unit) uses the zero token, an int32 like every channel id.
    ``run_op(kind, torch_fn, params, ins)``, when given, runs each leaf op
    (a sharded unit's counter, :func:`repro_torch.parallel.units.run_op`)."""
    if token is None:
        token = np.int32(0)
    device = torch.device("cpu") if device is None else device
    fn = program.functions[fname]
    env: dict[str, object] = dict(zip(fn.args, args))
    for g in fn.globals:
        env[g] = globals_env[g]
    for op in fn.ops:
        ins = [env[v] for v in op.inputs]
        if op.kind == "call":
            callee = op.params["callee"]
            if policy.should_inline(callee):
                outs = trace_function(
                    program, callee, policy, reentry, globals_env, ins, token, device,
                    run_op,
                )
            else:
                outs = emit_guest_callback(reentry, program, callee, ins, token, device)
        elif op.kind == "repeat":
            outs = _trace_repeat(program, op, policy, reentry, globals_env, ins,
                                 token, device, run_op)
        else:
            opdef = op.opdef()
            if opdef.torch_fn is None:
                raise HostOnlyOpError(op.kind, fname)
            if run_op is None:
                outs = opdef.torch_fn(op.params, *ins)
            else:
                outs = run_op(op.kind, opdef.torch_fn, op.params, ins)
        env.update(zip(op.outputs, outs))
    return tuple(env[r] for r in fn.returns)


def _trace_repeat(program, op, policy, reentry, globals_env, ins, token, device,
                  run_op=None) -> tuple:
    callee, times = op.params["callee"], op.params["times"]
    if not policy.should_inline(callee):
        # The planner guarantees repeat ops only reach host lowering when the
        # callee is inlinable; hitting this means the function should have
        # stayed on the guest side.
        raise HostOnlyOpError(f"repeat({callee})", "<host region>")
    nret = len(program.functions[callee].returns)
    ncarry = op.params.get("carry", nret)
    carried = tuple(ins[:ncarry])
    invariant = tuple(ins[ncarry:])

    in_avals = tuple(AVal(tuple(map(int, a.shape)), numpy_dtype(a.dtype).name)
                     for a in ins)
    out_avals, _ = abstract_eval(program, callee, in_avals)
    # the loop threads the carry at its entry dtype (a fixed-type loop
    # state, as in the reference's scan), and the non-carried outputs of
    # the last iteration come out
    carry_dtypes = tuple(a.dtype for a in carried)
    extras = tuple(torch.zeros(a.shape, dtype=torch_dtype(a.dtype), device=device)
                   for a in out_avals[ncarry:])
    for _ in range(times):
        outs = trace_function(
            program, callee, policy, reentry, globals_env,
            list(carried) + list(invariant), token, device, run_op
        )
        carried = tuple(o.to(dt) for o, dt in zip(outs[:ncarry], carry_dtypes))
        extras = tuple(outs[ncarry:])
    return carried + extras


def inline_closure(program: Program, fname: str, policy: InlinePolicy) -> tuple[set[str], tuple[str, ...]]:
    """Functions traced into ``fname``'s region + the globals they reference.

    The globals of every inlined callee must be staged to the host side along
    with the root function's own (the paper's global-reference propagation).
    """
    seen: set[str] = set()
    gnames: list[str] = []

    def visit(f: str) -> None:
        if f in seen:
            return
        seen.add(f)
        fn = program.functions[f]
        for g in fn.globals:
            if g not in gnames:
                gnames.append(g)
        for op in fn.ops:
            if op.is_call and policy.should_inline(op.params["callee"]):
                visit(op.params["callee"])

    visit(fname)
    return seen, tuple(gnames)
