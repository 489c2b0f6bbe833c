"""Deprecated executor facade over the staged ``trace → plan → compile → run``
frontend (:mod:`repro_torch.core.api`).

``HybridExecutor`` historically fused the compile-time phase (eligibility
analysis, unit extraction) and the run-time phase (crossings, GRT) into one
constructor pinned to a single entry signature.  The staged API replaces it:

========================================  =====================================
old                                       new
========================================  =====================================
``HybridExecutor(prog, s, entry_avals)``  ``mixed.trace(prog).plan(s).compile()``
``ex(*args)``                             ``hybrid(*args)`` (any signature)
``ex.stats`` (mutable, cumulative)        ``hybrid.last_report`` (per call)
``ex.plan`` / ``ex.coverage``             ``hybrid.plan_for(*args)[.coverage]``
``run_scheme(prog, s, args)``             ``mixed.trace(prog).plan(s).compile()``
========================================  =====================================

Both shims below route through the staged path, so their results are
bit-identical to the new API.  They emit :class:`DeprecationWarning`.
Like every entry point of the port, the units run on the CUDA card unless
the caller passes ``backend="cpu"``.

Scheme reference (unchanged semantics):

======== ============================================================
native   whole program as one offload unit (complete
         cross-compilation; raises :class:`NativeInfeasibleError` when
         host-only ops exist — the "all-or-nothing" failure mode)
qemu     pure op-at-a-time interpretation (DBT baseline)
tech     baseline offloading: per-crossing plan rebuild, every
         inter-function edge bounces through the emulator
tech-g   + GRT (cached conversion plans + staged globals)
tech-gf  + FCP (offloaded→offloaded calls run inline, loops inside a unit)
tech-gfp + PFO (host-op-blocked functions split into segments)
======== ============================================================
"""
from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np

from .. import obs
from .api import CompiledHybrid, NativeInfeasibleError, trace
from .convert import aval_of
from .costmodel import CostModel
from .offload import Scheme
from .opset import AVal
from .program import Program

__all__ = ["HybridExecutor", "NativeInfeasibleError", "run_scheme"]


class HybridExecutor:
    """Deprecated: use ``mixed.trace(program).plan(scheme, ...).compile()``.

    Thin facade that plans eagerly for ``entry_avals`` (preserving the old
    construct-time ``NativeInfeasibleError``) and exposes the legacy mutable
    ``stats`` / ``plan`` / ``coverage`` surface bound to that signature.
    Calls still dispatch through the signature-polymorphic cache, so other
    signatures work instead of misconverting — they just account to their
    own per-signature state rather than ``self.stats``.

    ``mesh`` and ``arg_specs`` plan sharded offload units (see
    :meth:`repro_torch.core.api.Traced.plan`); ``backend`` is the device of
    the units (``None``: the CUDA card; under a mesh, the rank's device).
    """

    def __init__(
        self,
        program: Program,
        scheme: str | Scheme = "tech-gfp",
        *,
        entry_avals: Sequence[AVal] | None = None,
        costmodel: CostModel | None = None,
        mesh=None,
        arg_specs=None,
        compute_dtype: str | None = "float32",
        unit_filter=None,
        backend: str | None = None,
    ):
        obs.warn(
            "HybridExecutor is deprecated; use "
            "repro_torch.mixed.trace(program).plan(scheme, ...).compile()",
            DeprecationWarning,
            origin="core.engine",
        )
        if entry_avals is None:
            raise ValueError("entry_avals required (shape/dtype of entry args)")
        self.entry_avals = tuple(entry_avals)
        # .plan() raises NativeInfeasibleError here, like the old constructor
        self.compiled: CompiledHybrid = (
            trace(program)
            .plan(
                scheme,
                costmodel=costmodel,
                mesh=mesh,
                arg_specs=arg_specs,
                compute_dtype=compute_dtype,
                unit_filter=unit_filter,
            )
            .compile(backend=backend)
        )
        self._state = self.compiled.state_for(self.entry_avals)
        self._emulator = None

    # -- legacy surface ----------------------------------------------------

    @property
    def program(self) -> Program:
        return self.compiled.planned.traced.program

    @property
    def scheme(self) -> Scheme:
        return self.compiled.scheme

    @property
    def costmodel(self) -> CostModel:
        return self.compiled.planned.costmodel

    @property
    def stats(self):
        return self._state.stats

    @property
    def plan(self):
        return self._state.plan

    @property
    def coverage(self):
        return self._state.plan.coverage

    @property
    def emulator(self):
        """Legacy introspection surface: an interpreter over the signature's
        transformed program.  Execution now creates a private emulator per
        call (see repro_torch.core.api), so this one is router-less — it
        interprets everything and never offloads."""
        if self._emulator is None:
            from .emulator import Emulator

            self._emulator = Emulator(self._state.plan.program,
                                      stats=self._state.stats)
        return self._emulator

    def __call__(self, *args) -> tuple[np.ndarray, ...]:
        return self.compiled(*args)


def run_scheme(
    program: Program,
    scheme: str,
    args: Sequence[np.ndarray],
    **kw,
) -> tuple[tuple[np.ndarray, ...], HybridExecutor]:
    """Deprecated convenience: build an executor for ``scheme``, run it once."""
    entry_avals = tuple(aval_of(a) for a in args)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ex = HybridExecutor(program, scheme, entry_avals=entry_avals, **kw)
    warnings.warn(
        "run_scheme is deprecated; use "
        "repro_torch.mixed.trace(program).plan(scheme).compile()(*args)",
        DeprecationWarning,
        stacklevel=2,
    )
    out = ex(*args)
    return out, ex
