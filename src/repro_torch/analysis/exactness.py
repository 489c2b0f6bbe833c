"""Exactness lint pass (RA4xx): bitwise-reproducibility contracts of decode
roots.

The serving tier's whole bit-identity story (paged KV storage, prefix
sharing, cross-batch decode) rests on one invariant: a decode root may
write cached state **only via selects** — every already-written row passes
through ``where``/``pad_to``-style ops bitwise unchanged, never through
arithmetic (``old * keep + new * (1-keep)`` would round).  This pass proves
it statically with a forward taint analysis computing, per SSA var:

* ``EXACT(v)`` — the root args whose elements can reach ``v`` **bitwise
  unchanged** (through selects, permutations, padding, identity host ops);
* ``DEP(v)``   — the root args ``v`` depends on at all.

Both are interprocedural (memoized per-function summaries over formal
positions; recursion and ``repeat`` degrade conservatively).  For each
state pair ``(arg_k, return_{k+1})`` of a dense decode root the contract
is: output EXACT-contains its arg (cache passes through), or does not
depend on it at all (state recomputed fresh).  A dependence that is not
exact on a **cache-shaped** aval (rank >= 3 float — per-stream state with
a context axis) is RA401; recurrent rank-2 state (recomputed every step,
e.g. an RNN hidden state) is legitimately inexact and exempt.  Paged roots
return *fresh rows* instead of merged caches, so there the contract is
inverted: fresh-row outputs must NOT depend on the page pools (RA403).

Fixed-shape discipline: roots must run at one padded signature, so any
wildcard (``-1``) reshape or state aval drift in a root's closure is RA402.
"""
from __future__ import annotations

import math
from typing import Sequence

from ..core.opset import AVal
from ..core.program import Program, abstract_eval
from .diagnostics import DiagnosticSink

# op kind -> input positions whose elements pass through bitwise ("all" =
# every input).  Everything not listed breaks exactness (arithmetic).
_EXACT_INPUTS: dict[str, object] = {
    "reshape": (0,), "transpose": (0,), "expand_dims": (0,), "squeeze": (0,),
    "roll": (0,), "slice": (0,), "pad_to": (0,), "sort": (0,),
    "host_print": (0,), "host_assert_finite": (0,),
    "where": (1, 2),          # selects an element of x or y; cond is dep-only
    "maximum": (0, 1), "minimum": (0, 1),
    "concat": "all",
    "embed": (0,),            # output rows are table rows, copied bitwise
}

DEFAULT_ROOT_NAMES = ("decode_step", "paged_decode_step", "prefill_suffix")
PAGED_ROOT_NAMES = ("paged_decode_step",)


def _exact_positions(kind: str, n_inputs: int) -> tuple[int, ...]:
    spec = _EXACT_INPUTS.get(kind)
    if spec is None:
        return ()
    if spec == "all":
        return tuple(range(n_inputs))
    return tuple(p for p in spec if p < n_inputs)


class _FlowAnalysis:
    """Per-function (EXACT, DEP) summaries over formal argument positions."""

    def __init__(self, program: Program):
        self.program = program
        self._memo: dict[str, tuple[tuple[frozenset, frozenset], ...]] = {}

    def summary(self, fname: str, stack: frozenset = frozenset()):
        """Per return position: (exact formal idxs, dep formal idxs)."""
        if fname in self._memo:
            return self._memo[fname]
        fn = self.program.functions[fname]
        all_formals = frozenset(range(len(fn.args)))
        if fname in stack:  # recursion: nothing exact, everything dependent
            return tuple((frozenset(), all_formals) for _ in fn.returns)
        stack = stack | {fname}

        exact: dict[str, frozenset] = {}
        dep: dict[str, frozenset] = {}
        for i, a in enumerate(fn.args):
            exact[a] = dep[a] = frozenset({i})
        for g in fn.globals:  # constants carry no root-arg taint
            exact[g] = dep[g] = frozenset()

        for op in fn.ops:
            in_exact = [exact[v] for v in op.inputs]
            in_dep = [dep[v] for v in op.inputs]
            if op.is_call:
                callee_sum = self.summary(op.params["callee"], stack)
                outs_e, outs_d = [], []
                for ret_e, ret_d in callee_sum:
                    e = frozenset().union(*(in_exact[i] for i in ret_e)) if ret_e else frozenset()
                    d = frozenset().union(*(in_dep[i] for i in ret_d)) if ret_d else frozenset()
                    outs_e.append(e)
                    outs_d.append(d)
                if op.kind == "repeat":
                    # iterated composition: be conservative — nothing exact,
                    # every output may depend on every input
                    all_dep = frozenset().union(*in_dep) if in_dep else frozenset()
                    outs_e = [frozenset() for _ in outs_e]
                    outs_d = [all_dep for _ in outs_d]
            else:
                pos = _exact_positions(op.kind, len(op.inputs))
                e = (frozenset().union(*(in_exact[p] for p in pos))
                     if pos else frozenset())
                d = frozenset().union(*in_dep) if in_dep else frozenset()
                outs_e = [e] * len(op.outputs)
                outs_d = [d] * len(op.outputs)
            for o, oe, od in zip(op.outputs, outs_e, outs_d):
                exact[o] = oe
                dep[o] = od

        result = tuple((exact[r], dep[r]) for r in fn.returns)
        self._memo[fname] = result
        return result


def _closure_wildcard_reshapes(program: Program, root: str) -> list[tuple[str, int]]:
    sites: list[tuple[str, int]] = []
    for f in sorted(program.reachable(root)):
        for idx, op in enumerate(program.functions[f].ops):
            if op.kind == "reshape" and -1 in tuple(op.params.get("shape", ())):
                sites.append((f, idx))
    return sites


def _cache_shaped(aval: AVal) -> bool:
    """Per-stream cached state: a context axis beyond (batch, feature) and a
    rounding-prone dtype.  Rank-2 recurrent state is recomputed per step and
    legitimately inexact; integer state (lengths, tables) is exact anyway."""
    return len(aval.shape) >= 3 and aval.dtype.startswith("float")


def check_root(
    program: Program,
    root: str,
    sink: DiagnosticSink,
    *,
    flow: _FlowAnalysis | None = None,
    avals: Sequence[AVal] | None = None,
    paged: bool | None = None,
) -> dict:
    """Check one decode root's exactness contract; returns its facts dict."""
    flow = flow or _FlowAnalysis(program)
    fn = program.functions[root]
    facts: dict = {"root": root, "mode": "typed" if avals is not None else "structural"}
    if paged is None:
        paged = root in PAGED_ROOT_NAMES

    if len(fn.returns) < 2 or len(fn.args) < 2:
        sink.emit(
            "RA404",
            f"{root!r} has {len(fn.args)} args / {len(fn.returns)} returns; a "
            f"step root needs state plus logits on both sides",
            fname=root,
        )
        return facts

    summary = flow.summary(root)
    arg_avals = dict(zip(fn.args, avals)) if avals is not None else {}

    out_avals: tuple[AVal, ...] | None = None
    if avals is not None:
        try:
            out_avals, _ = abstract_eval(program, root, tuple(avals))
        except Exception as e:  # inconsistent synthetic avals: degrade
            sink.emit(
                "RA404", f"{root!r} failed abstract evaluation: {e}", fname=root
            )
            facts["mode"] = "structural"
            arg_avals = {}

    pairs = []
    if paged:
        n_fresh = len(fn.returns) - 1
        pool_positions = frozenset(range(min(n_fresh, len(fn.args))))
        facts["pools"] = [fn.args[p] for p in sorted(pool_positions)]
        for j in range(1, len(fn.returns)):
            _, d = summary[j]
            hit = sorted(d & pool_positions)
            if hit:
                sink.emit(
                    "RA403",
                    f"fresh-row output {fn.returns[j]!r} depends on page "
                    f"pool(s) {[fn.args[p] for p in hit]} — rows must be "
                    f"computed from the token alone so host-side appends "
                    f"stay bit-identical",
                    fname=root,
                )
            pairs.append({
                "output": fn.returns[j],
                "depends_on_pools": [fn.args[p] for p in hit],
            })
    else:
        state_args = fn.args[:-1]          # last arg is the token
        state_rets = fn.returns[1:]        # first return is the logits
        if len(state_args) != len(state_rets):
            sink.emit(
                "RA404",
                f"{root!r} state arity mismatch: {len(state_args)} state args "
                f"vs {len(state_rets)} state returns",
                fname=root,
            )
            return facts
        for k, (arg, ret) in enumerate(zip(state_args, state_rets)):
            e, d = summary[k + 1]
            if k in e:
                verdict = "cache-pass-through"
            elif k not in d:
                verdict = "recomputed-fresh"
            else:
                aval = arg_avals.get(arg)
                if aval is not None and _cache_shaped(aval):
                    verdict = "inexact-write"
                    sink.emit(
                        "RA401",
                        f"state output {ret!r} depends on cached input "
                        f"{arg!r} ({aval}) but not bitwise-exactly — cached "
                        f"rows must pass through a select (where/pad_to), "
                        f"not arithmetic",
                        fname=root,
                        hint="merge with where(mask, new, old) instead of "
                             "masked arithmetic",
                    )
                elif aval is not None:
                    verdict = "recomputed-inexact-ok"
                else:
                    verdict = "unverified"
                    sink.emit(
                        "RA405",
                        f"state pair ({arg!r} -> {ret!r}) is inexact but no "
                        f"avals were provided to classify it (pass "
                        f"entry avals / example args for a typed verdict)",
                        fname=root,
                    )
            entry = {"arg": arg, "output": ret, "verdict": verdict}
            if avals is not None and out_avals is not None:
                ain, aout = arg_avals[arg], out_avals[k + 1]
                entry["aval"] = str(ain)
                if ain.shape != aout.shape or ain.dtype != aout.dtype:
                    sink.emit(
                        "RA402",
                        f"state pair ({arg!r} -> {ret!r}) drifts "
                        f"{ain} -> {aout}; a step root must preserve its "
                        f"padded state signature",
                        fname=root,
                    )
            pairs.append(entry)

    facts["pairs"] = pairs

    for f, idx in _closure_wildcard_reshapes(program, root):
        op = program.functions[f].ops[idx]
        sink.emit(
            "RA402",
            f"wildcard reshape {tuple(op.params['shape'])} reachable from "
            f"decode root {root!r} — roots must run at fixed padded shapes",
            fname=f, op_index=idx, op_kind="reshape",
        )
    return facts


def derive_decode_root_avals(
    program: Program,
    entry_avals: Sequence[AVal],
    roots: Sequence[str],
) -> dict[str, tuple[AVal, ...]]:
    """Best-effort root avals from the prefill entry's signature.

    Convention (see models/programs.py): the entry is a prefill
    ``tokens -> (logits, *state)``; ``decode_step`` takes ``(*state, token)``,
    ``prefill_suffix`` takes ``(*state, tokens)``, and a paged root takes
    ``(*pools, tables, len, token)`` with one pool per rank-3 state array.
    Roots whose arity does not match the convention are skipped (the caller
    falls back to the structural-only check).
    """
    out: dict[str, tuple[AVal, ...]] = {}
    try:
        entry_out, _ = abstract_eval(program, program.entry, tuple(entry_avals))
    except Exception:
        return out
    if not entry_out or not entry_out[0].shape:
        return out
    state = entry_out[1:]
    batch = int(entry_out[0].shape[0])
    i32 = "int32"
    token = AVal((batch,), i32)

    for root in roots:
        fn = program.functions.get(root)
        if fn is None:
            continue
        if root == "prefill_suffix":
            cand = tuple(state) + (tuple(entry_avals)[0],)
            if len(cand) == len(fn.args):
                out[root] = cand
        elif root in PAGED_ROOT_NAMES:
            grown = [a for a in state if len(a.shape) == 3]
            n_fresh = len(fn.returns) - 1
            if len(grown) != n_fresh or not grown:
                continue
            ctx = int(grown[0].shape[1])
            page = max(1, min(4, ctx))
            npages = max(1, math.ceil(ctx / page))
            pools = tuple(
                AVal((batch * npages, page) + tuple(a.shape[2:]), a.dtype)
                for a in grown
            )
            cand = pools + (AVal((batch, npages), i32), AVal((batch,), i32), token)
            if len(cand) == len(fn.args):
                out[root] = cand
        else:
            cand = tuple(state) + (token,)
            if len(cand) == len(fn.args):
                out[root] = cand
    return out


def run(
    program: Program,
    sink: DiagnosticSink,
    *,
    roots: Sequence[str] | None = None,
    entry_avals: Sequence[AVal] | None = None,
) -> dict:
    """Run the exactness lint over every decode root present in the program."""
    if roots is None:
        roots = [r for r in DEFAULT_ROOT_NAMES if r in program.functions]
    else:
        roots = [r for r in roots if r in program.functions]
    root_avals: dict[str, tuple[AVal, ...]] = {}
    if entry_avals is not None:
        root_avals = derive_decode_root_avals(program, entry_avals, roots)
    flow = _FlowAnalysis(program)
    facts = {"roots": []}
    for root in roots:
        facts["roots"].append(
            check_root(program, root, sink, flow=flow, avals=root_avals.get(root))
        )
    return facts
