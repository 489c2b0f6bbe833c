"""Compile-time offload planning: eligibility analysis + unit construction.

Mirrors the paper's compile-time phase: identify target-agnostic functions,
extract them, and prepare host-side versions.  Planning is split in two so
the staged frontend (:mod:`repro_torch.core.api`) can reuse the expensive part
across entry signatures:

1. :func:`analyze_eligibility` — **aval-independent**: the compilable-set
   fixed point, the PFO outlining transform, and the static coverage
   counters.  Runs once per ``PlannedProgram``.
2. :func:`finalize_plan` — **per entry signature**: abstract-interprets the
   call graph under concrete avals, applies the cost-model gate, and builds
   the offload units.  Runs once per distinct entry signature.

Our analysis:

1. **Compilable set** (can execute natively at all): no host-only leaf ops,
   not in a recursive SCC (our offload units are host regions — no recursion),
   and every ``repeat`` callee inlinable under the scheme's policy (without
   FCP a hot loop keeps its parent on the guest side, so each iteration
   crosses — the paper's baseline behaviour).
2. **PFO pass** (scheme.pfo): un-compilable functions are split into
   offloadable segments (see :mod:`repro_torch.core.pfo`), producing a transformed
   program whose residual functions stay interpreted.
3. **Offload units** (get a stub + crossing): compilable functions accepted
   by the cost model (the paper's size threshold).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Sequence

import torch

from .costmodel import CostModel
from .fcp import HostOnlyOpError, InlinePolicy, inline_closure, trace_function
from .opset import AVal
from .pfo import outline_function
from .program import Program, Function, abstract_eval
from .stats import Coverage


@dataclasses.dataclass(frozen=True)
class Scheme:
    """A feature bundle of the paper's ablation axes.

    Obtainable two ways: the string registry (``SCHEMES["tech-gf"]``) or the
    composable constructors — ``Scheme.base().with_grt().with_fcp()`` builds
    a value equal to ``SCHEMES["tech-gf"]`` (names are derived canonically
    from the enabled features, so composed schemes compare equal to their
    registry twins).

    The feature axes (all off on :meth:`base`):

    * ``grt`` — Global Reference Table: cache conversion plans per
      (function, signature) across crossings instead of rebuilding them.
    * ``fcp`` — Function-Closure Propagation: inline compilable callees
      (including hot ``repeat`` loops) into their parent's offload unit so
      the loop iterates *inside* the unit instead of crossing per iteration.
    * ``pfo`` — Partial-Function Offloading: split functions blocked by a
      host-only op into offloadable segments around it.
    * ``native`` — complete cross-compilation, the all-or-nothing baseline:
      fails outright if anything reachable is host-blocked or recursive.

    Instances are frozen (hashable, thread-safe); ``with_*`` return new
    values and never mutate.
    """

    name: str
    offload: bool = True
    grt: bool = False
    fcp: bool = False
    pfo: bool = False
    native: bool = False  # complete cross-compilation (all-or-nothing)

    # -- composable constructors -------------------------------------------

    @classmethod
    def base(cls) -> "Scheme":
        """The baseline offloading scheme (``tech``): stubs + crossings only."""
        return cls("tech")

    @classmethod
    def emulation(cls) -> "Scheme":
        """Pure op-at-a-time interpretation (``qemu``)."""
        return cls("qemu", offload=False)

    @classmethod
    def complete(cls) -> "Scheme":
        """Complete cross-compilation (``native``) — the all-or-nothing mode."""
        return cls("native", native=True)

    @staticmethod
    def _derived_name(offload: bool, grt: bool, fcp: bool, pfo: bool, native: bool) -> str:
        if native:
            return "native"
        if not offload:
            return "qemu"
        suffix = "".join(c for c, on in (("g", grt), ("f", fcp), ("p", pfo)) if on)
        return f"tech-{suffix}" if suffix else "tech"

    def _with(self, **kw) -> "Scheme":
        if self.native or not self.offload:
            # GRT/FCP/PFO only exist on the offloading path; allowing them
            # here would mint schemes named "qemu"/"native" that compare
            # unequal to their registry twins
            raise ValueError(
                f"scheme {self.name!r} takes no feature toggles; "
                f"start from Scheme.base()"
            )
        flags = dict(offload=self.offload, grt=self.grt, fcp=self.fcp,
                     pfo=self.pfo, native=self.native)
        flags.update(kw)
        return Scheme(Scheme._derived_name(**flags), **flags)

    def with_grt(self, enabled: bool = True) -> "Scheme":
        """Toggle the Global Reference Table (conversion-plan caching)."""
        return self._with(grt=enabled)

    def with_fcp(self, enabled: bool = True) -> "Scheme":
        """Toggle Function-Closure Propagation (inline compilable callees)."""
        return self._with(fcp=enabled)

    def with_pfo(self, enabled: bool = True) -> "Scheme":
        """Toggle Partial-Function Offloading (split around host-only ops)."""
        return self._with(pfo=enabled)


SCHEMES: dict[str, Scheme] = {
    "native": Scheme("native", native=True),
    "qemu": Scheme("qemu", offload=False),
    "tech": Scheme("tech"),
    "tech-g": Scheme("tech-g", grt=True),
    "tech-gf": Scheme("tech-gf", grt=True, fcp=True),
    "tech-gfp": Scheme("tech-gfp", grt=True, fcp=True, pfo=True),
}


def resolve_scheme(scheme: str | Scheme) -> Scheme:
    if isinstance(scheme, str):
        try:
            return SCHEMES[scheme]
        except KeyError:
            raise KeyError(
                f"unknown scheme {scheme!r}; available: {sorted(SCHEMES)} "
                f"(or compose one: Scheme.base().with_grt()...)"
            ) from None
    return scheme


@dataclasses.dataclass
class OffloadUnit:
    fname: str
    global_names: tuple[str, ...]       # closure globals (incl. inlined callees')
    call: Callable                      # (globals_tuple, args_tuple, token) -> outputs
    inlined: frozenset                  # functions traced into this region
    # Concrete signatures this unit has run at: each entry is
    # ``(globals_sig, args_sig)`` with ``(shape, dtype-string)`` per array.
    # A signature's first call is the eager unit's "compile" (the reference
    # engine traces once per signature), so the compile counters of the two
    # engines stay comparable.
    seen_signatures: set = dataclasses.field(default_factory=set)
    # The unit's body without the compile accounting: what AOT persistence
    # (repro_torch.serve.aot) hands to torch.export at each seen signature.
    body: Callable | None = None


@dataclasses.dataclass
class OffloadPlan:
    program: Program                    # transformed program (PFO segments added)
    units: dict[str, OffloadUnit]
    policy: InlinePolicy
    coverage: Coverage
    decisions: dict[str, str]           # fname -> human-readable reason
    call_avals: dict[str, tuple[AVal, ...]] = dataclasses.field(default_factory=dict)

    def units_only_read(self, params: Sequence[int]) -> bool:
        """Whether the root's parameters at positions ``params`` reach
        nothing but offload units: the root is a unit itself, or every use
        of each in its body is an operand of a ``call`` to a unit and none
        is returned.  Such arguments may cross as
        :class:`~repro_torch.core.convert.Resident` values, which no guest
        op reads."""
        root = self.program.functions[self.program.entry]
        if root.name in self.units:
            return True
        names = {root.args[i] for i in params}
        if names.intersection(root.returns):
            return False
        return all(op.kind == "call" and op.callee in self.units
                   for op in root.ops if names.intersection(op.inputs))


def unit_cache_key(
    fname: str,
    arg_avals: tuple[AVal, ...],
    backend: str | None = None,
    sharded: bool = False,
) -> tuple:
    """Cache key for an offload unit: function + per-arg rank/dtype.

    An eager unit is shape-polymorphic, so two entry signatures whose
    abstract interpretation reaches ``fname`` with the same argument *ranks
    and dtypes* share one unit (reentry is routed through the token
    registry, see :mod:`repro_torch.core.api`).  ``backend`` partitions the
    cache when the same plan is compiled for several devices
    (``compile(backend=...)``); ``sharded`` keeps a mesh plan's units, which
    run on DTensors, apart from an unsharded plan's.
    """
    key = (fname, tuple((len(a.shape), str(a.dtype)) for a in arg_avals), backend)
    return key + ("sharded",) if sharded else key


class UnitCache:
    """Thread-safe (key → OffloadUnit) cache shared across entry signatures.

    One instance lives on each :class:`~repro_torch.core.api.PlannedProgram`, so
    every signature state — and every ``CompiledHybrid`` compiled from that
    plan — reuses the same unit callables.  A new batch bucket that only
    changes concrete sizes therefore pays one first-signature call, not a
    fresh unit construction.
    """

    def __init__(self):
        self._units: dict[tuple, OffloadUnit] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.builds = 0

    def get_or_build(self, key: tuple, factory: Callable[[], OffloadUnit]) -> OffloadUnit:
        with self._lock:
            unit = self._units.get(key)
            if unit is not None:
                self.hits += 1
                return unit
            self.builds += 1
            unit = factory()
            self._units[key] = unit
            return unit

    def __len__(self) -> int:
        with self._lock:
            return len(self._units)

    def items(self) -> list[tuple[tuple, OffloadUnit]]:
        """Snapshot of ``(key, unit)`` pairs (for AOT export/introspection)."""
        with self._lock:
            return list(self._units.items())


@dataclasses.dataclass
class EligibilityAnalysis:
    """The aval-independent half of planning (shared across signatures)."""

    scheme: Scheme
    program: Program                    # PFO-transformed working program
    compilable: frozenset               # unit_filter already applied here
    policy: InlinePolicy
    reachable: frozenset                # reachable in the transformed program
    recursive: frozenset
    coverage_template: Coverage         # static counters; per-signature copy made
    # fname -> why it was excluded from the compilable set ("recursive",
    # "host-only op 'X'", "unit_filter", "repeat 'g' not inlinable").  The
    # machine-readable half of the verdict: the analysis layer cross-checks it
    # and traffic-adaptive planning consumes it as per-unit facts.
    blockers: dict = dataclasses.field(default_factory=dict)


def _body_host_blocked(fn: Function) -> bool:
    return any((not op.is_call) and (not op.opdef().offloadable) for op in fn.ops)


def collect_call_avals(program: Program, entry_avals: tuple[AVal, ...]) -> dict[str, tuple[AVal, ...]]:
    """Abstract-interpret from the entry, recording each function's arg avals."""
    call_avals: dict[str, tuple[AVal, ...]] = {}

    def visit(fname: str, avals: tuple[AVal, ...]) -> tuple[AVal, ...]:
        first_visit = fname not in call_avals
        call_avals.setdefault(fname, tuple(avals))
        fn = program.functions[fname]
        env: dict[str, AVal] = dict(zip(fn.args, avals))
        for g in fn.globals:
            env[g] = AVal.of(program.constants[g])
        for op in fn.ops:
            ins = tuple(env[v] for v in op.inputs)
            if op.is_call:
                callee = op.params["callee"]
                if first_visit or callee not in call_avals:
                    outs = visit(callee, ins)
                else:
                    outs, _ = abstract_eval(program, callee, ins)
                if op.kind == "repeat":
                    # threaded carry shapes must be stable or iteration 2 would
                    # see different shapes than the traced/compiled iteration 1;
                    # dtype promotion (f32 -> f64) reaches a fixed point after
                    # one iteration and the loop bodies tolerate it, so only
                    # the exactness lint (RA402) comments on dtype drift
                    carry = op.params.get("carry", len(outs))
                    for a, b in zip(ins[:carry], outs[:carry]):
                        if a.shape != b.shape:
                            raise ValueError(
                                f"{fname}: repeat {callee} carry aval changed {a} -> {b}"
                            )
            else:
                outs = op.opdef().infer_fn(op.params, *ins)
            env.update(zip(op.outputs, outs))
        return tuple(env[r] for r in fn.returns)

    visit(program.entry, entry_avals)
    return call_avals


def analyze_eligibility(
    program: Program,
    scheme: Scheme,
    *,
    unit_filter: Callable[[str], bool] | None = None,
    reachable: frozenset | None = None,
    recursive: frozenset | None = None,
) -> EligibilityAnalysis:
    """Aval-independent planning: compilable set, PFO transform, coverage.

    ``reachable``/``recursive`` accept pre-computed call-graph facts (e.g.
    from ``mixed.trace``) so planning several schemes for one traced program
    doesn't re-walk the graph each time.

    Raises :class:`~repro_torch.core.fcp.HostOnlyOpError` when ``scheme.native``
    and complete cross-compilation is infeasible (the all-or-nothing wall).
    """
    coverage = Coverage()
    reachable = set(reachable) if reachable is not None else program.reachable()
    recursive = set(recursive) if recursive is not None else program.recursive_functions()

    if not scheme.offload and not scheme.native:
        coverage.total_functions = len(reachable)
        return EligibilityAnalysis(
            scheme, program, frozenset(), InlinePolicy(),
            frozenset(reachable), frozenset(recursive), coverage,
        )

    work = Program(
        program.name, dict(program.functions), program.entry, dict(program.constants)
    )

    if scheme.native:
        # eager all-or-nothing check: any host-only op or recursion anywhere
        # reachable makes complete cross-compilation infeasible.
        for f in sorted(reachable):
            if f in recursive:
                raise HostOnlyOpError(f"<recursive {f}>", f)
            if _body_host_blocked(work.functions[f]):
                bad = next(
                    op.kind
                    for op in work.functions[f].ops
                    if not op.is_call and not op.opdef().offloadable
                )
                raise HostOnlyOpError(bad, f)
        coverage.total_functions = len(reachable)
        return EligibilityAnalysis(
            scheme, work, frozenset(reachable), InlinePolicy(inline_all=True),
            frozenset(reachable), frozenset(recursive), coverage,
        )

    # ---- fixed-point compilable analysis --------------------------------
    blockers: dict[str, str] = {}
    compilable = set()
    for f in sorted(reachable):
        if f in recursive:
            blockers[f] = "recursive"
        elif _body_host_blocked(work.functions[f]):
            bad = next(
                op.kind for op in work.functions[f].ops
                if not op.is_call and not op.opdef().offloadable
            )
            blockers[f] = f"host-only op {bad!r}"
        elif unit_filter is not None and not unit_filter(f):
            # Library-scope offloading (paper §4.4.2): only the named
            # library's functions have "source" available — the downstream
            # app is a pre-built binary and can neither be cross-compiled
            # nor inlined.
            blockers[f] = "unit_filter"
        else:
            compilable.add(f)
    changed = True
    while changed:
        changed = False
        for f in sorted(compilable):
            for op in work.functions[f].ops:
                if op.kind == "repeat":
                    if not (scheme.fcp and op.params["callee"] in compilable):
                        compilable.discard(f)
                        blockers[f] = f"repeat {op.params['callee']!r} not inlinable"
                        changed = True
                        break

    # ---- PFO: split the un-compilable remainder --------------------------
    policy = InlinePolicy(fcp=scheme.fcp, compilable=frozenset(compilable))
    if scheme.pfo:
        for f in sorted(reachable - compilable):
            if unit_filter is not None and not unit_filter(f):
                continue
            res = outline_function(work, f, policy)
            if res is None:
                continue
            work.functions[f] = res.residual
            for seg in res.segments:
                work.functions[seg.name] = seg
                compilable.add(seg.name)
            coverage.outlined_segments += len(res.segments)
        policy = InlinePolicy(fcp=scheme.fcp, compilable=frozenset(compilable))

    reachable_after = work.reachable()
    coverage.total_functions = len(reachable_after)
    for f in sorted(reachable_after):
        if f in recursive:
            coverage.blocked_by_recursion += 1
        elif _body_host_blocked(work.functions[f]):
            coverage.blocked_by_host_ops += 1

    return EligibilityAnalysis(
        scheme, work, frozenset(compilable), policy,
        frozenset(reachable_after), frozenset(recursive), coverage,
        blockers,
    )


def finalize_plan(
    analysis: EligibilityAnalysis,
    costmodel: CostModel,
    reentry: Callable[[int, str, tuple], tuple],
    entry_avals: tuple[AVal, ...],
    *,
    compile_hook: Callable[[], None] | None = None,
    unit_cache: UnitCache | None = None,
    backend: str | None = None,
    mesh=None,
) -> OffloadPlan:
    """Per-signature planning: cost gate + unit construction.

    When ``unit_cache`` is given, units are shared across signatures via
    :func:`unit_cache_key` — callers must then pass signature-independent
    ``reentry``/``compile_hook`` dispatchers (the staged API's call-context
    routing), since one unit may serve many executor states.  Under ``mesh``
    the units run sharded (:mod:`repro_torch.parallel.units`).
    """
    scheme = analysis.scheme
    work = analysis.program
    device = torch.device(backend or "cpu")
    coverage = dataclasses.replace(analysis.coverage_template)
    decisions: dict[str, str] = {}

    def make_unit(fname: str, avals: tuple[AVal, ...]) -> OffloadUnit:
        factory = lambda: _make_unit(work, fname, analysis.policy, reentry,
                                     compile_hook, device, sharded=mesh is not None)
        if unit_cache is None:
            return factory()
        key = unit_cache_key(fname, avals, backend, sharded=mesh is not None)
        return unit_cache.get_or_build(key, factory)

    if not scheme.offload and not scheme.native:
        return OffloadPlan(work, {}, analysis.policy, coverage, decisions)

    if scheme.native:
        unit = make_unit(work.entry, tuple(entry_avals))
        coverage.offloaded_functions = coverage.total_functions
        call_avals = collect_call_avals(work, entry_avals)
        return OffloadPlan(
            work, {work.entry: unit}, analysis.policy, coverage, decisions, call_avals
        )

    # ---- cost-model gate: which compilable functions become units --------
    call_avals = collect_call_avals(work, tuple(entry_avals))
    units: dict[str, OffloadUnit] = {}
    for f in sorted(analysis.compilable & analysis.reachable):
        avals = call_avals.get(f)
        if avals is None:  # unreachable under these avals (dead function)
            continue
        decision = costmodel.decide(work, f, avals)
        decisions[f] = decision.reason
        if not decision.offload:
            coverage.rejected_by_costmodel += 1
            continue
        units[f] = make_unit(f, avals)

    coverage.offloaded_functions = len(units)
    return OffloadPlan(work, units, analysis.policy, coverage, decisions, call_avals)


def plan_offloading(
    program: Program,
    scheme: Scheme,
    costmodel: CostModel,
    reentry: Callable[[int, str, tuple], tuple],
    entry_avals: tuple[AVal, ...],
    *,
    compile_hook: Callable[[], None] | None = None,
    backend: str | None = None,
    unit_filter: Callable[[str], bool] | None = None,
) -> OffloadPlan:
    """One-shot planning (analysis + finalize) — the pre-staged-API entry.

    ``reentry`` follows the token protocol: ``reentry(token, callee, args)``,
    where ``token`` is the reentry-channel scalar each guest callback carries
    (see :mod:`repro_torch.core.reentrancy`).  Units built here are invoked
    as ``unit.call(staged_globals, dev_args, token)`` and run on ``backend``
    (``None``: the CUDA card, raising where there is none, as every entry
    point of the port; ``"cpu"`` on the CPU), where the reference's take a
    ``jit_wrapper``.
    """
    from .api import resolve_device    # api builds on this module

    device = str(resolve_device(backend))
    analysis = analyze_eligibility(program, scheme, unit_filter=unit_filter)
    return finalize_plan(
        analysis, costmodel, reentry, tuple(entry_avals),
        compile_hook=compile_hook, backend=device,
    )


def _tensor_sig(xs) -> tuple:
    return tuple((tuple(int(d) for d in x.shape), str(x.dtype)) for x in xs)


def _make_unit(
    program: Program,
    fname: str,
    policy: InlinePolicy,
    reentry: Callable,
    compile_hook: Callable[[], None] | None,
    device: torch.device,
    *,
    sharded: bool = False,
) -> OffloadUnit:
    """A unit running ``fname`` (its inlined closure) as torch ops on
    ``device``; ``sharded``: on DTensors over a mesh, each op's
    redistributions counted (:mod:`repro_torch.parallel.units`)."""
    inlined, gnames = inline_closure(program, fname, policy)
    seen: set = set()
    seen_lock = threading.Lock()

    def body(globals_tuple, args_tuple, reentry_token):
        genv = dict(zip(gnames, globals_tuple))
        if not sharded:
            return trace_function(
                program, fname, policy, reentry, genv, list(args_tuple),
                reentry_token, device,
            )
        from ..parallel import units

        with units.unit_scope():
            return trace_function(
                program, fname, policy, reentry, genv, list(args_tuple),
                reentry_token, device, units.run_op,
            )

    def call(globals_tuple, args_tuple, reentry_token):
        # An eager unit runs its body on every call, so "compiles" is
        # counted where the reference engine traces: the first call at
        # each concrete (globals, args) signature.
        sig = (_tensor_sig(globals_tuple), _tensor_sig(args_tuple))
        with seen_lock:
            first = sig not in seen
            seen.add(sig)
        if first and compile_hook is not None:
            compile_hook()
        return body(globals_tuple, args_tuple, reentry_token)

    return OffloadUnit(
        fname=fname,
        global_names=gnames,
        call=call,
        inlined=frozenset(inlined),
        seen_signatures=seen,
        body=body,
    )
