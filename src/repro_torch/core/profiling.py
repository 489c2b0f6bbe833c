"""Profile-guided offload selection — the paper's stated future work.

Paper §4.2/§5: *"More sophisticated strategies are possible, such as better
cost models and profiling"*, *"we plan to explore ... more adaptive
offloading strategies guided by workload characteristics"*, and §4.3.2:
*"This inspires us to explore the combination of profiling methods to
selectively offload hot functions in the future."*

We implement it on top of :mod:`repro_torch.obs`: one profiling pass under pure
emulation runs with a private :class:`~repro_torch.obs.Tracer`, whose
``emulator`` spans already carry per-function inclusive wall time — the
profiler *is* the tracer's histogram stream, not a separate timing path,
so profiling and tracing share one clock and one event taxonomy.
:class:`ProfiledCostModel` then offloads a function iff its *measured*
per-call interpretation time exceeds the crossing cost by a margin — hot
long functions offload, tiny hot-path functions (the cjson/lua killers)
stay interpreted.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .. import obs
from .costmodel import CostModel, CostModelConfig, Decision
from .emulator import Emulator
from .opset import AVal
from .program import Program
from .stats import RunStats


@dataclasses.dataclass
class FunctionProfile:
    calls: int = 0
    total_s: float = 0.0

    @property
    def per_call_s(self) -> float:
        return self.total_s / max(1, self.calls)


def profiles_from_histograms(hist: obs.HistogramSet, *,
                             kind: str | None = obs.EMULATOR
                             ) -> dict[str, FunctionProfile]:
    """Fold a ``(name, kind)``-keyed :class:`~repro_torch.obs.HistogramSet` into
    per-function profiles.

    With ``kind=obs.EMULATOR`` this reads a profiling pass (interpreted
    inclusive time).  With ``kind=None`` it sums across *all* kinds per
    name — e.g. feeding ``ExecutionReport.latency`` (keyed by
    ``(unit, signature)``) from a live serving run back into planning.
    """
    out: dict[str, FunctionProfile] = {}
    for (name, k), h in hist.items():
        if kind is not None and k != kind:
            continue
        p = out.setdefault(name, FunctionProfile())
        p.calls += h.count
        p.total_s += h.sum_ns * 1e-9
    return out


class ProfilingEmulator(Emulator):
    """Emulator recording per-function inclusive wall time.

    A thin configuration of the base emulator: it installs a private
    tracer whose ``emulator`` spans are the measurement (the old
    ``_run_function`` stopwatch override is gone — same clock, same event
    path as every other consumer of :mod:`repro_torch.obs`).
    """

    def __init__(self, program: Program, tracer: obs.Tracer | None = None):
        # a small ring suffices: the histograms (the actual profile) never
        # drop, only the replayable span timeline is bounded
        if tracer is None:  # explicit: an empty Tracer is falsy (len == 0)
            tracer = obs.Tracer(capacity=1024, label="profile")
        super().__init__(program, router=None, stats=RunStats(),
                         tracer=tracer)

    @property
    def profile(self) -> dict[str, FunctionProfile]:
        return profiles_from_histograms(self.tracer.hist)


def profile_program(program: Program, args: Sequence[np.ndarray]) -> dict[str, FunctionProfile]:
    """One interpretation pass; returns per-function profiles."""
    em = ProfilingEmulator(program)
    em.run(program.entry, args)
    return dict(em.profile)


class ProfiledCostModel(CostModel):
    """Offload decisions from measured interpretation time vs crossing cost.

    A function is offloaded iff
        per_call_interp_s > crossing_cost_s × margin
    i.e. a crossing must pay for itself even with zero native speedup —
    any native gain is then pure profit.  Functions the profile never saw
    (cold / segments created later by PFO) fall back to the static model.
    """

    def __init__(self, profile: dict[str, FunctionProfile],
                 config: CostModelConfig | None = None, *, margin: float = 1.0):
        super().__init__(config or CostModelConfig())
        self.profile = profile
        self.margin = margin

    @classmethod
    def from_histograms(cls, hist: obs.HistogramSet,
                        config: CostModelConfig | None = None, *,
                        kind: str | None = obs.EMULATOR,
                        margin: float = 1.0) -> "ProfiledCostModel":
        """Build directly from tracer/report histograms (one event path)."""
        return cls(profiles_from_histograms(hist, kind=kind),
                   config, margin=margin)

    def decide(self, program: Program, fname: str, arg_avals: tuple[AVal, ...]) -> Decision:
        prof = self.profile.get(fname)
        if prof is None or prof.calls == 0:
            base = fname.split("#")[0]          # PFO segment → parent profile
            prof = self.profile.get(base)
        if prof is None or prof.calls == 0:
            return super().decide(program, fname, arg_avals)
        threshold = self.config.crossing_cost_s * self.margin
        if prof.per_call_s <= threshold:
            return Decision(
                False,
                f"profiled: {prof.per_call_s*1e6:.0f}us/call <= crossing "
                f"{threshold*1e6:.0f}us ({prof.calls} calls)",
            )
        return Decision(
            True,
            f"profiled hot: {prof.per_call_s*1e6:.0f}us/call over {prof.calls} calls",
        )
