"""Staged frontend: ``trace → plan → compile → run``.

The paper separates a compile-time phase (eligibility analysis, unit
extraction) from a run-time phase (crossing channels, GRT caching).  This
module exposes that separation as explicit, composable stages:

    traced   = mixed.trace(program)            # validated IR + call-graph facts
    planned  = traced.plan("tech-gf")          # offload plan, no JIT yet
    hybrid   = planned.compile()               # callable; units on the card
    out      = hybrid(*args)                   # plans per entry signature

``CompiledHybrid`` infers entry avals from the actual arguments on first
call and caches an ``(aval-signature → executor state)`` entry, so one
compiled object transparently serves multiple shapes/dtypes.  Every call
returns through a per-call :class:`~repro_torch.core.stats.ExecutionReport`
(``hybrid.last_report``); ``with instrument() as rec:`` collects the reports
of every call made inside the block, across all compiled objects.

Concurrency model (the substrate of :mod:`repro_torch.serve`): a ``CompiledHybrid``
may be called from many threads at once.

* The signature cache is a lock-guarded, double-checked map — exactly one
  executor state (one plan, one GRT) exists per signature no matter how many
  threads race the first call.
* Every call owns a private :class:`~repro_torch.core.stats.RunStats` and
  :class:`~repro_torch.core.emulator.Emulator` (a ``_CallContext``); nothing on
  the hot path writes shared counters.  After the call, the private stats
  are folded into the state's lifetime record under a lock.
* Offload units are shared across signatures through the planned
  program's :class:`~repro_torch.core.offload.UnitCache` (an eager unit is
  shape-polymorphic).  Host→guest reentry therefore cannot close over any
  one executor.  Instead the caller's identity travels with the unit call
  as a scalar token, resolved in a lock-guarded registry (see
  :mod:`repro_torch.core.reentrancy`); compile accounting, which happens
  on the calling thread, uses a thread-local stack.

Devices: ``compile(backend=None)`` means ``"cuda"`` and raises where no
CUDA device is present; ``backend="cpu"`` runs the units on the CPU (the
tests do).  Each executor keeps an explicit :class:`torch.device`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Callable, Collection, Sequence

import numpy as np
import torch

from .. import obs
from .convert import (ConversionPlan, Resident, StagedConstants, aval_of, build_plan,
                      signature_of)
from .costmodel import CostModel, CostModelConfig
from .emulator import Emulator
from .fcp import HostOnlyOpError
from .grt import GlobalReferenceTable
from .offload import (
    EligibilityAnalysis,
    OffloadPlan,
    OffloadUnit,
    Scheme,
    UnitCache,
    analyze_eligibility,
    finalize_plan,
    resolve_scheme,
)
from .opset import AVal
from .program import Program, abstract_eval
from .stats import ExecutionReport, RunStats

# The reference engine computes float32 matmuls in full float32.  On the
# card, PyTorch would route float32 convolutions (and, if enabled, matmuls)
# through TF32, which keeps about three decimal digits; both are turned off
# here, at engine import, so a unit on the card matches the reference's
# numerics.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class NativeInfeasibleError(RuntimeError):
    """Complete cross-compilation failed (the paper's all-or-nothing wall)."""


class PlanVerificationError(RuntimeError):
    """The independent offload-soundness verifier refuted the planner.

    Raised by ``Traced.plan(scheme, verify=True)`` when
    :func:`repro_torch.analysis.soundness.verify_plan` emits any
    error-severity diagnostic (compilable-set disagreement or a PFO segment
    violating the offload-unit invariants).  Carries the diagnostics on
    ``.diagnostics``.
    """

    def __init__(self, message: str, diagnostics=()):
        super().__init__(message)
        self.diagnostics = tuple(diagnostics)


# ---------------------------------------------------------------------------
# instrumentation sessions
# ---------------------------------------------------------------------------


class Instrumentation:
    """Collects the ExecutionReport of every call made while active.

    Thread-safe: calls made on any thread while the session is open are
    recorded; ``merged()`` snapshots under the lock so it can run while
    other threads are still appending.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reports: list[ExecutionReport] = []

    def record(self, report: ExecutionReport) -> None:
        with self._lock:
            self.reports.append(report)

    def merged(self) -> ExecutionReport:
        with self._lock:
            reports = list(self.reports)
        return ExecutionReport.aggregate(reports)

    def __len__(self) -> int:
        return len(self.reports)


_RECORDERS: list[Instrumentation] = []
_RECORDERS_LOCK = threading.Lock()


@contextlib.contextmanager
def instrument():
    """``with instrument() as rec:`` — record every hybrid call in scope.

    Sessions are global (a recorder sees calls from every thread), and the
    registry is lock-guarded so concurrent sessions on different threads can
    open and close without corrupting each other's registration.
    """
    rec = Instrumentation()
    with _RECORDERS_LOCK:
        _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        with _RECORDERS_LOCK:
            _RECORDERS.remove(rec)


def _record_report(report: ExecutionReport) -> None:
    with _RECORDERS_LOCK:
        recorders = tuple(_RECORDERS)
    for rec in recorders:
        rec.record(report)


# ---------------------------------------------------------------------------
# call-context routing
#
# Offload units are shared across signature states (and across CompiledHybrid
# objects built from one PlannedProgram), so the reentry callback of a unit
# cannot close over any one executor.  Two mechanisms identify the in-flight
# caller instead:
#
# * Reentry (runtime): the caller's identity travels with the unit call as a
#   scalar token (see repro_torch.core.reentrancy); the dispatcher resolves it
#   in the lock-guarded registry below.
# * Compile accounting: a unit's first call at a signature runs on the calling
#   thread, so a thread-local stack of active contexts suffices.
# ---------------------------------------------------------------------------


_REENTRY_CHANNELS: dict[int, "_CallContext"] = {}
_REENTRY_LOCK = threading.Lock()
_next_token = itertools.count(1)


def _open_reentry_channel(ctx: "_CallContext") -> int:
    with _REENTRY_LOCK:
        token = next(_next_token) % 0x7FFFFFFF or 1   # keep int32-safe
        while token in _REENTRY_CHANNELS:             # wrapped onto a live call
            token = next(_next_token) % 0x7FFFFFFF or 1
        _REENTRY_CHANNELS[token] = ctx
    return token


def _close_reentry_channel(token: int) -> None:
    with _REENTRY_LOCK:
        _REENTRY_CHANNELS.pop(token, None)


def _dispatch_reentry(token: int, callee: str, args: tuple) -> tuple:
    with _REENTRY_LOCK:
        ctx = _REENTRY_CHANNELS.get(token)
    if ctx is None:
        raise RuntimeError(
            f"host→guest reentry on closed channel {token}; offload units "
            "must only execute via CompiledHybrid.__call__"
        )
    return ctx.reenter(callee, args)


_TRACING_CONTEXTS = threading.local()


def _tracing_stack() -> list:
    stack = getattr(_TRACING_CONTEXTS, "stack", None)
    if stack is None:
        stack = _TRACING_CONTEXTS.stack = []
    return stack


def _dispatch_compile_hook() -> None:
    stack = _tracing_stack()
    if stack:
        ctx = stack[-1]
        ctx.stats.compiles += 1
        tracer = getattr(ctx, "tracer", None)
        if tracer is not None:
            tracer.event("unit_compile", obs.COMPILE)


# ---------------------------------------------------------------------------
# stage 1: trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Traced:
    """A validated program plus its call-graph facts (scheme-independent).

    Produced by :func:`trace`.  Immutable and thread-safe; one ``Traced``
    can be planned many times (for different schemes) without re-walking
    the call graph, or re-rooted at another function via :meth:`with_entry`
    (which re-derives the facts for the new root — build re-rooted plans
    once and reuse them, don't re-derive per call).
    """

    program: Program
    reachable: frozenset
    recursive: frozenset
    host_blocked: frozenset     # reachable functions containing host-only ops

    def plan(
        self,
        scheme: str | Scheme = "tech-gfp",
        *,
        costmodel: CostModel | None = None,
        mesh=None,
        arg_specs=None,
        compute_dtype: str | None = "float32",
        unit_filter: Callable[[str], bool] | None = None,
        unit_cache: "UnitCache | None" = None,
        verify: bool = False,
    ) -> "PlannedProgram":
        """Run the aval-independent compile-time phase for ``scheme``.

        Raises :class:`NativeInfeasibleError` immediately for the ``native``
        scheme when any reachable function is host-blocked or recursive —
        infeasibility is a *plan-time* fact, no arguments needed.

        ``unit_cache`` lets a new plan share offload units with a sibling
        plan of the same program (pass ``other.unit_cache``); the default
        gives the plan a fresh cache.  :meth:`PlannedProgram.for_entry` uses
        this to keep one set of units across the prefill and per-token-step
        plans of a decode loop.

        ``verify=True`` differentially cross-checks the planner's
        compilable set against the independent re-derivation in
        :mod:`repro_torch.analysis` and raises :class:`PlanVerificationError`
        if they disagree — the plan is rejected, not silently trusted.

        ``mesh`` (a :class:`~repro_torch.parallel.spmd.Mesh`, every rank of
        the world running the same calls) makes the units sharded: the
        entry unit's arguments are placed by ``arg_specs`` (a
        :class:`~repro_torch.parallel.sharding.P` or ``None`` per entry
        argument; ``None`` or omitted: replicated), every other unit's
        arguments and every program constant are replicated, and each unit
        computes the global result, which every rank gets back in full
        (:mod:`repro_torch.parallel.units`).
        """
        scheme = resolve_scheme(scheme)
        try:
            analysis = analyze_eligibility(
                self.program,
                scheme,
                unit_filter=unit_filter,
                reachable=self.reachable,
                recursive=self.recursive,
            )
        except HostOnlyOpError as e:
            if scheme.native:
                if verify:
                    self._verify(scheme, unit_filter, None)
                raise NativeInfeasibleError(str(e)) from e
            raise
        if verify:
            self._verify(scheme, unit_filter, analysis)
        return PlannedProgram(
            traced=self,
            scheme=scheme,
            analysis=analysis,
            costmodel=costmodel or CostModel(CostModelConfig()),
            mesh=mesh,
            arg_specs=None if arg_specs is None else tuple(arg_specs),
            compute_dtype=compute_dtype,
            unit_filter=unit_filter,
            unit_cache=unit_cache if unit_cache is not None else UnitCache(),
        )

    def _verify(self, scheme: Scheme, unit_filter, analysis) -> None:
        from ..analysis.soundness import verify_plan  # lazy: keep core standalone

        sink, _ = verify_plan(
            self.program, scheme, unit_filter=unit_filter, analysis=analysis
        )
        errors = [d for d in sink.diagnostics if d.severity == "error"]
        if errors:
            raise PlanVerificationError(
                f"offload-soundness verifier rejected the {scheme.name!r} plan: "
                + "; ".join(str(d) for d in errors),
                errors,
            )

    def with_entry(self, entry: str) -> "Traced":
        """Re-root the traced program at another of its functions.

        The decode-loop surface: one exported program holds both the
        prefill entry and a per-token ``step`` function; ``with_entry``
        produces a ``Traced`` whose entry — and therefore whose reachable
        set and plans — start from ``entry`` instead.  Constants and
        function bodies are shared, not copied; the call-graph facts are
        re-derived for the new root (one full :func:`trace`), so treat this
        as a plan-time operation, not a per-call one.
        """
        if entry == self.program.entry:
            return self
        if entry not in self.program.functions:
            raise KeyError(
                f"unknown function {entry!r}; program defines "
                f"{sorted(self.program.functions)}"
            )
        return trace(
            Program(
                self.program.name,
                dict(self.program.functions),
                entry,
                dict(self.program.constants),
            )
        )


def trace(program: Program) -> Traced:
    """Stage 1: validate the program and derive call-graph facts."""
    from .offload import _body_host_blocked

    program.validate()
    reachable = frozenset(program.reachable())
    return Traced(
        program=program,
        reachable=reachable,
        recursive=frozenset(program.recursive_functions()),
        host_blocked=frozenset(
            f for f in reachable if _body_host_blocked(program.functions[f])
        ),
    )


# ---------------------------------------------------------------------------
# stage 2: plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlannedProgram:
    """Offload plan (eligibility + PFO transform), no units built yet.

    Per-signature work — abstract interpretation under concrete avals, the
    cost-model gate, unit construction — is deferred to the compiled
    object's first call for each signature.  The ``unit_cache`` is shared by
    every signature state and every ``CompiledHybrid`` built from this plan,
    so concurrent serving sessions reuse one set of units.
    """

    traced: Traced
    scheme: Scheme
    analysis: EligibilityAnalysis      # unit_filter already applied inside
    costmodel: CostModel
    mesh: object                       # spmd.Mesh of sharded units, or None
    arg_specs: tuple | None            # the entry unit's argument specs
    compute_dtype: str | None
    unit_filter: Callable[[str], bool] | None = None
    unit_cache: UnitCache = dataclasses.field(default_factory=UnitCache, compare=False)

    @property
    def compilable(self) -> frozenset:
        return self.analysis.compilable

    def for_entry(self, entry: str) -> "PlannedProgram":
        """Plan the same program, same scheme, rooted at ``entry``.

        This is the **step-fn plan surface** behind
        :class:`~repro_torch.serve.DecodeScheduler`: a decode-loop program
        exports a prefill entry plus a per-token ``step`` function, and
        ``planned.for_entry("step")`` yields a sibling plan for the step
        without duplicating compiled state — the two plans share one
        :class:`~repro_torch.core.offload.UnitCache`, so a function reachable
        from both (e.g. the LM head) is built exactly once and re-entered
        with whatever batch each caller brings (the unit is built once per
        rank/dtype/backend).

        Scheme, cost model, mesh, compute dtype, and unit filter carry
        over; ``arg_specs`` do not (they describe the original entry's
        arguments).
        """
        traced = self.traced.with_entry(entry)
        if traced is self.traced:
            return self
        return traced.plan(
            self.scheme,
            costmodel=self.costmodel,
            mesh=self.mesh,
            arg_specs=None,
            compute_dtype=self.compute_dtype,
            unit_filter=self.unit_filter,
            unit_cache=self.unit_cache,
        )

    def save_aot(self, path) -> dict:
        """Persist this plan's artifacts to a versioned on-disk AOT cache.

        Serializes the program IR (+ constants), the scheme/cost-model
        configuration, and — for every offload unit in the shared
        ``unit_cache`` — a :func:`torch.export.export` program per concrete
        signature the unit has run at, so a fresh process can
        :meth:`load_aot` and serve with compile count 0.  Units containing
        host callbacks (guest reentry) cannot be exported and are skipped
        with a warning — they recompile on load, which is always safe.
        Returns a summary dict (see
        :func:`repro_torch.serve.aot.save_planned`).

        Raises :class:`repro_torch.serve.aot.AotError` when the plan carries
        non-serializable state (``unit_filter``, ``mesh``, ``arg_specs``).
        """
        from ..serve.aot import save_planned  # serve builds on core; lazy

        return save_planned(self, path)

    @staticmethod
    def load_aot(path) -> "PlannedProgram":
        """Reconstruct a plan saved with :meth:`save_aot`.

        The returned plan's unit cache runs the loaded programs at the
        saved signatures, which count as seen — ``compile()`` + calls at
        the saved shapes make no first-signature call, so
        ``ExecutionReport.compiles`` stays 0.  Unseen shapes compile as
        always.  A corrupt or version-mismatched artifact is never loaded
        blind: manifest/digest damage raises
        :class:`repro_torch.serve.aot.AotError` (callers fall back to
        planning from source), per-blob damage skips just that signature
        with a warning.
        """
        from ..serve.aot import load_planned

        return load_planned(path)

    def compile(self, *, backend: str | None = None) -> "CompiledHybrid":
        """Stage 3: produce the callable, signature-polymorphic runtime.

        ``backend`` is the :class:`torch.device` the offload units run on:
        ``None`` means ``"cuda"`` (raising where no CUDA device is present),
        ``"cpu"`` runs them on the CPU.  The same plan can be compiled
        several times for different devices — the shared unit cache keys
        units by device so targets never collide.  A sharded plan's units
        run on its mesh's device (the rank's card, or the CPU), which
        ``backend`` must name.
        """
        return CompiledHybrid(self, backend=backend)


def resolve_device(backend: str | torch.device | None) -> torch.device:
    """The unit device for ``compile(backend=...)``: ``None`` means CUDA.

    Raises :class:`ValueError` when the device is not present here — the
    port never falls back to the CPU behind the caller's back.
    """
    try:
        device = torch.device("cuda" if backend is None else backend)
    except RuntimeError as e:
        raise ValueError(f"backend {backend!r}: {e}") from None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(
                f"backend {str(device)!r} is not available on this host: no "
                f"CUDA device (pass backend='cpu' to run the units on the CPU)")
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise ValueError(f"backend {str(device)!r}: no such CUDA device")
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise ValueError(f"backend {str(device)!r}: the port runs on 'cuda' or 'cpu'")
    return device


# ---------------------------------------------------------------------------
# stage 3/4: compile + run
# ---------------------------------------------------------------------------


def _aval_label(avals) -> str:
    """Stable signature label for histogram keys: ``f32[4x8],i32[]``-style."""
    return ",".join(
        f"{np.dtype(a.dtype).str.lstrip('|<>=')}"
        f"[{'x'.join(map(str, a.shape))}]"
        for a in avals
    )


def _traced_unit_call(tracer, fname: str, plan: ConversionPlan, unit,
                      dev_args, token: int):
    """``unit.call`` under a tracer: a ``unit`` span over the host enqueue
    and, on CUDA, a ``drain`` span over the wait for the unit's end event
    (the copy back would wait for it anyway), with the unit's device-clock
    span in the ``unit`` span's args."""
    on_card = plan.device.type == "cuda"
    t_unit = time.perf_counter_ns()
    interval = obs.DeviceInterval(tracer, plan.device) if on_card else None
    outs = unit.call(plan.staged_globals, dev_args, np.int32(token))
    t_enqueued = time.perf_counter_ns()
    args = None
    if interval is not None:
        interval.stop()
        interval.wait()
        tracer.add(fname, obs.DRAIN, t_enqueued,
                   time.perf_counter_ns() - t_enqueued)
        args = interval.args()
    tracer.add(fname, obs.UNIT, t_unit, t_enqueued - t_unit, args=args)
    return outs


class _CallContext:
    """Everything one in-flight call mutates: stats, emulator, interleave.

    Instances are created per ``CompiledHybrid.__call__`` (never shared), so
    concurrent calls on one signature state are fully isolated; the shared
    pieces they touch (plan, units, GRT) are immutable or internally locked.
    """

    __slots__ = ("state", "stats", "emulator", "host_active", "tracer", "kept")

    def __init__(self, state: "_SignatureExecutor", kept: dict[str, frozenset[int]]):
        self.state = state
        # unit name -> the output positions that stay on the device
        self.kept = kept
        self.stats = RunStats()
        # resolved ONCE per call: with tracing off every hot-path producer
        # below sees `tracer is None` and records nothing
        self.tracer = obs.active()
        self.emulator = Emulator(state.plan.program, router=self,
                                 stats=self.stats, tracer=self.tracer)
        self.host_active = 0  # live host regions (for interleave accounting)

    # -- execution ----------------------------------------------------------

    def run(self, args: Sequence[np.ndarray]) -> tuple[np.ndarray, ...]:
        entry = self.state.plan.program.entry
        routed = self.route(entry, args, depth=0)
        if routed is not None:
            return routed
        if self.state.scheme.native:
            raise NativeInfeasibleError("entry not compilable")  # pragma: no cover
        return self.emulator.run(entry, args)

    # -- CallRouter protocol (used by the emulator) — the guest-side stub ---

    def route(self, fname: str, args: Sequence[np.ndarray], depth: int) -> tuple | None:
        state = self.state
        unit = state.plan.units.get(fname)
        if unit is None:
            return None
        # ---- guest→host crossing -------------------------------------
        self.stats.guest_to_host += 1
        self.stats.per_function_crossings[fname] += 1
        if self.host_active > 0:
            self.stats.nested_crossings += 1
        tracer = self.tracer
        t_cross = time.perf_counter_ns()
        sig_label = ""
        try:
            arg_avals = tuple(aval_of(a) for a in args)
            sig_label = _aval_label(arg_avals)
            if state._grt is not None:
                plan = state._grt.lookup_or_build(
                    fname,
                    arg_avals,
                    lambda: state._build_plan(unit, arg_avals),
                    stats=self.stats,
                )
            else:
                # baseline: reconstruct conversion data on every crossing
                self.stats.conversion_builds += 1
                plan = state._build_plan(unit, arg_avals)
            t_place = time.perf_counter_ns()
            dev_args = plan.convert_in(args)
            t_placed = time.perf_counter_ns()
            self.stats.place_ns += t_placed - t_place
            placed = resident = 0
            for a, t in zip(args, dev_args):
                if isinstance(a, Resident):
                    resident += a.nbytes
                else:
                    placed += t.nbytes
            self.stats.placed_bytes += placed
            self.stats.resident_bytes += resident
            if tracer is not None:
                span_args = {"bytes": placed}
                if resident:
                    span_args["resident_bytes"] = resident
                tracer.add(fname, obs.PLACE, t_place, t_placed - t_place,
                           args=span_args)
            self.host_active += 1
            self.stats.max_interleave_depth = max(
                self.stats.max_interleave_depth, self.host_active + self.emulator._depth
            )
            token = _open_reentry_channel(self)
            stack = _tracing_stack()
            stack.append(self)  # compile hooks of first-signature unit calls
            try:
                if tracer is None:
                    outs = unit.call(plan.staged_globals, dev_args, np.int32(token))
                else:
                    outs = _traced_unit_call(tracer, fname, plan, unit,
                                             dev_args, token)
                # gather results before closing the channel: convert_out
                # waits for the device, so the crossing's wall time includes
                # the unit's kernels (outputs the plan keeps stay there)
                t_fetch = time.perf_counter_ns() if tracer is not None else 0
                host = plan.convert_out(outs, self.kept.get(fname, ()), dev_args)
                fetched = kept = 0
                for a in host:
                    if isinstance(a, Resident):
                        kept += a.nbytes
                    else:
                        fetched += a.nbytes
                self.stats.fetched_bytes += fetched
                self.stats.kept_bytes += kept
                if tracer is not None:
                    span_args = {"bytes": fetched}
                    if kept:
                        span_args["kept_bytes"] = kept
                    tracer.add(fname, obs.FETCH, t_fetch,
                               time.perf_counter_ns() - t_fetch, args=span_args)
                return host
            finally:
                stack.pop()
                _close_reentry_channel(token)
                self.host_active -= 1
        finally:
            dur = time.perf_counter_ns() - t_cross
            # the per-(unit, signature) latency distribution is part of the
            # report contract, so it records regardless of tracing state
            self.stats.unit_latency.record((fname, sig_label), dur)
            if tracer is not None:
                tracer.add(fname, obs.CROSSING, t_cross, dur,
                           args={"signature": sig_label})

    # -- host→guest reentry (via the thread-local dispatcher) ---------------

    def reenter(self, callee: str, args: tuple) -> tuple:
        self.stats.host_to_guest += 1
        # re-enter the (re-entrant) emulator; it may re-offload via route()
        tracer = self.tracer
        if tracer is None:
            return self.emulator.call(callee, args)
        t0 = time.perf_counter_ns()
        try:
            return self.emulator.call(callee, args)
        finally:
            tracer.add(callee, obs.REENTRY, t0, time.perf_counter_ns() - t0)


class _SignatureExecutor:
    """Shared runtime state for one entry signature: plan, units, GRT.

    One instance exists per distinct entry-aval signature seen by a
    CompiledHybrid.  It owns only thread-safe or immutable pieces; per-call
    mutation lives in :class:`_CallContext`.  ``stats`` is the lifetime
    cumulative record, updated under a lock after each call.
    """

    def __init__(
        self,
        planned: PlannedProgram,
        entry_avals: tuple[AVal, ...],
        device: torch.device,
        staged: StagedConstants | None = None,
    ):
        self.planned = planned
        self.scheme = planned.scheme
        self.entry_avals = tuple(entry_avals)
        self.stats = RunStats()
        self._stats_lock = threading.Lock()
        self._grt = GlobalReferenceTable() if self.scheme.grt else None
        # the GRT's plans place globals through the compiled program's shared
        # copies; the baseline (no GRT) places them afresh on every crossing
        self._staged = staged if self._grt is not None else None
        # every crossing places its arguments and globals on this device
        self.device = device

        self.plan: OffloadPlan = finalize_plan(
            planned.analysis,
            planned.costmodel,
            _dispatch_reentry,
            self.entry_avals,
            compile_hook=_dispatch_compile_hook,
            unit_cache=planned.unit_cache,
            backend=str(self.device),
            mesh=planned.mesh,
        )
        self._kept: dict[frozenset[int], dict[str, frozenset[int]]] = {}

    def kept_for(self, returns: frozenset[int]) -> dict[str, frozenset[int]]:
        """The plan's kept outputs (:meth:`OffloadPlan.kept_outputs`) when
        the caller asks for the entry outputs ``returns`` on the device,
        decided once per request; a sharded plan keeps nothing."""
        kept = self._kept.get(returns)
        if kept is None:
            kept = {} if self.planned.mesh is not None else self.plan.kept_outputs(returns)
            self._kept[returns] = kept
        return kept

    def call(self, args: Sequence[np.ndarray],
             returns: frozenset[int] = frozenset()) -> tuple[tuple, RunStats, float]:
        """Run one entry call in a fresh context; fold stats into lifetime."""
        ctx = _CallContext(self, self.kept_for(returns))
        t0 = time.perf_counter()
        try:
            out = ctx.run(args)
        finally:
            wall = time.perf_counter() - t0
            with self._stats_lock:
                self.stats.merge(ctx.stats)
        return out, ctx.stats, wall

    def _build_plan(self, unit: OffloadUnit, arg_avals: tuple[AVal, ...]) -> ConversionPlan:
        planned = self.planned
        eff_avals = arg_avals
        if planned.compute_dtype is not None:
            eff_avals = tuple(
                AVal(a.shape, planned.compute_dtype)
                if np.issubdtype(np.dtype(a.dtype), np.floating)
                else a
                for a in arg_avals
            )
        out_avals, _ = abstract_eval(self.plan.program, unit.fname, eff_avals)
        # only the entry unit's arguments are the caller's, placed by arg_specs
        specs = planned.arg_specs if unit.fname == self.plan.program.entry else None
        return build_plan(
            self.plan.program,
            unit.fname,
            arg_avals,
            out_avals,
            unit.global_names,
            device=self.device,
            compute_dtype=planned.compute_dtype,
            mesh=planned.mesh,
            arg_specs=specs,
            staged=self._staged,
        )


class CompiledHybrid:
    """Callable hybrid runtime, signature-polymorphic.

    Calls infer the entry signature from the actual arguments; each new
    signature triggers one per-signature plan (cost gate + units), cached
    for every later call with the same shapes/dtypes.  Inspect behaviour via
    ``last_report`` (per-call :class:`ExecutionReport`), ``replans`` (plans
    built so far), ``signatures`` (cached keys), and ``plan_for(*args)``
    (the :class:`OffloadPlan` serving those arguments).

    Safe to call from many threads at once: the signature cache is
    double-checked under a lock (exactly one plan per signature), execution
    state is per-call, and units/GRT entries are shared through
    internally-locked caches.  ``last_report``/``last_plan`` are "most
    recent call on any thread" conveniences — under concurrency, prefer
    ``instrument()`` sessions for attribution.
    """

    def __init__(self, planned: PlannedProgram, *, backend: str | None = None):
        self.planned = planned
        # resolved now, so a missing device fails at compile(), not at the
        # first call
        self.device = resolve_device(backend)
        mesh = planned.mesh
        if mesh is not None and self.device != torch.device(mesh.device):
            raise ValueError(f"a plan sharded over {mesh} runs its units on the rank's "
                             f"device {mesh.device}, not {self.device}")
        self._states: dict[tuple[AVal, ...], _SignatureExecutor] = {}
        # one device copy of each constant for every signature's GRT plans
        # (under a mesh each plan replicates its own, as before)
        self.staged = StagedConstants(self.device) if mesh is None else None
        self._plan_lock = threading.Lock()
        self._last_state: _SignatureExecutor | None = None
        self.replans = 0                        # signature plans built
        self.last_report: ExecutionReport | None = None

    # -- introspection ------------------------------------------------------

    @property
    def scheme(self) -> Scheme:
        return self.planned.scheme

    @property
    def signatures(self) -> tuple[tuple[AVal, ...], ...]:
        return tuple(self._states)

    @property
    def last_plan(self) -> OffloadPlan | None:
        """OffloadPlan of the most recent call's signature (None before any)."""
        return self._last_state.plan if self._last_state is not None else None

    def plan_for(self, *args) -> OffloadPlan:
        """The offload plan serving ``args`` (built now if unseen)."""
        return self._state_for(signature_of(args))[0].plan

    def state_for(self, entry_avals: Sequence[AVal]) -> _SignatureExecutor:
        """Materialize (or fetch) the executor state for explicit avals."""
        return self._state_for(tuple(entry_avals))[0]

    # -- execution ----------------------------------------------------------

    def _state_for(self, sig: tuple[AVal, ...]) -> tuple[_SignatureExecutor, bool]:
        # double-checked: the dict read is safe under the GIL, and the lock
        # guarantees racing first-callers build exactly one state per sig
        state = self._states.get(sig)
        if state is not None:
            return state, True
        with self._plan_lock:
            state = self._states.get(sig)
            hit = state is not None
            if state is None:
                state = _SignatureExecutor(self.planned, sig, self.device, self.staged)
                self._states[sig] = state
                self.replans += 1
        return state, hit

    def call_reported(
        self, *args, device_returns: Collection[int] = (),
    ) -> tuple[tuple[np.ndarray | Resident, ...], ExecutionReport]:
        """Run one entry call and return ``(outputs, report)``.

        Unlike ``last_report`` — a "most recent call on any thread"
        convenience — the returned report is attributed to exactly this
        call, so concurrent callers (e.g. :mod:`repro_torch.serve` workers) get
        race-free accounting.

        ``device_returns`` names entry-output positions the caller would
        take on the units' device: each comes back as a
        :class:`~repro_torch.core.convert.Resident` where the plan lets it
        stay there (it is a unit's output that no guest op reads,
        :meth:`~repro_torch.core.offload.OffloadPlan.kept_outputs`), and as
        a numpy array otherwise.
        """
        program = self.planned.analysis.program
        entry = program.functions[program.entry]
        entry_params = entry.args
        if len(args) != len(entry_params):
            raise TypeError(
                f"{program.entry}: expected {len(entry_params)} args "
                f"({', '.join(entry_params)}), got {len(args)}"
            )
        returns = frozenset(int(i) for i in device_returns)
        if not returns <= set(range(len(entry.returns))):
            raise ValueError(f"{program.entry}: device_returns {sorted(returns)} outside "
                             f"its {len(entry.returns)} outputs")
        args = [a if isinstance(a, Resident) else np.asarray(a) for a in args]
        sig = signature_of(args)
        state, hit = self._state_for(sig)
        self._last_state = state
        tracer = obs.active()
        t0 = time.perf_counter_ns() if tracer is not None else 0
        out, call_stats, wall = state.call(args, returns)
        if tracer is not None:
            tracer.add(program.entry, obs.CALL, t0,
                       time.perf_counter_ns() - t0,
                       args={"scheme": self.scheme.name})
        # the call owned its RunStats outright, so the report is a delta
        # against zero — per-call isolation needs no high-water-mark games
        report = ExecutionReport.from_stats_delta(
            RunStats(),
            call_stats,
            scheme=self.scheme.name,
            signature=sig,
            cache_hits=int(hit),
            replans=self.replans,
            owner=id(self),
            wall_seconds=wall,
        )
        self.last_report = report
        _record_report(report)
        return out, report

    def __call__(self, *args) -> tuple[np.ndarray, ...]:
        return self.call_reported(*args)[0]
