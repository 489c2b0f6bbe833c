"""Partial Function Outlining (PFO).

Paper §3.4: *"PFO expands offloadable functions, making originally
un-offloadable functions offloadable ... For context-sensitive code, its
complement is split instead."*

A function whose body mixes offloadable tensor ops with host-only ops (the
canonical case: a rarely-triggered ``printf``-style safety check — here
``host_print`` / ``host_assert_finite`` / ``py_call``) cannot be offloaded as
a whole.  PFO partitions its body into **maximal runs of host-executable
ops**, outlines each run into a fresh function (``f#segK``), and rewrites the
original body to call the outlined segments, leaving only the problematic
ops (plus the segment call glue) on the guest side.  The outlined segments
are then offloaded like any other function.

Live-range analysis over the straight-line SSA body determines each
segment's arguments (live-ins) and returns (live-outs).
"""
from __future__ import annotations

import dataclasses

from .program import Program, Function, Op
from .fcp import InlinePolicy


@dataclasses.dataclass
class OutlineResult:
    residual: Function
    segments: list[Function]


def _op_hostable(program: Program, op: Op, policy: InlinePolicy) -> bool:
    if op.kind == "call":
        return True  # reentrancy covers calls to guest functions
    if op.kind == "repeat":
        return policy.should_inline(op.params["callee"])
    return op.opdef().offloadable


def outline_function(
    program: Program,
    fname: str,
    policy: InlinePolicy,
    *,
    min_segment_ops: int = 1,
) -> OutlineResult | None:
    """Split ``fname`` into offloadable segments; None if nothing to gain."""
    fn = program.functions[fname]
    flags = [_op_hostable(program, op, policy) for op in fn.ops]
    if all(flags):
        return None  # already fully offloadable — PFO not needed
    if not any(flags):
        return None  # nothing offloadable at all

    # group consecutive hostable ops into runs
    runs: list[tuple[int, int]] = []  # [start, end) index ranges of hostable runs
    i = 0
    while i < len(fn.ops):
        if flags[i]:
            j = i
            while j < len(fn.ops) and flags[j]:
                j += 1
            runs.append((i, j))
            i = j
        else:
            i += 1

    runs = [(s, e) for (s, e) in runs if e - s >= min_segment_ops]
    if not runs:
        return None

    # later-use map for live-out analysis
    used_later: dict[str, int] = {}  # var -> last op index that reads it
    for idx, op in enumerate(fn.ops):
        for v in op.inputs:
            used_later[v] = idx
    for v in fn.returns:
        used_later[v] = len(fn.ops)

    global_set = set(fn.globals)
    segments: list[Function] = []
    new_ops: list[Op] = []
    run_iter = iter(runs)
    next_run = next(run_iter, None)
    idx = 0
    seg_id = 0
    while idx < len(fn.ops):
        if next_run is not None and idx == next_run[0]:
            s, e = next_run
            seg_ops = fn.ops[s:e]
            defined = {o for op in seg_ops for o in op.outputs}
            live_in: list[str] = []
            seg_globals: list[str] = []
            for op in seg_ops:
                for v in op.inputs:
                    if v in defined:
                        continue
                    if v in global_set:
                        if v not in seg_globals:
                            seg_globals.append(v)
                    elif v not in live_in:
                        live_in.append(v)
            live_out = [
                o
                for op in seg_ops
                for o in op.outputs
                if used_later.get(o, -1) >= e
            ]
            seg_name = f"{fname}#seg{seg_id}"
            seg_id += 1
            seg = Function(
                name=seg_name,
                args=tuple(live_in),
                returns=tuple(live_out),
                ops=tuple(seg_ops),
                globals=tuple(seg_globals),
            )
            segments.append(seg)
            new_ops.append(Op("call", tuple(live_in), tuple(live_out), {"callee": seg_name}))
            idx = e
            next_run = next(run_iter, None)
        else:
            new_ops.append(fn.ops[idx])
            idx += 1

    residual = Function(fn.name, fn.args, fn.returns, tuple(new_ops), fn.globals)
    return OutlineResult(residual=residual, segments=segments)
