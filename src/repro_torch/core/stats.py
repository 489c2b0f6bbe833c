"""Instrumentation: crossing counters + coverage (paper Figs. 5 & 6 analogues).

Two layers:

* :class:`RunStats` — the mutable, cumulative counters owned by one
  per-signature executor state (internal accounting).
* :class:`ExecutionReport` — an immutable-by-convention per-call snapshot
  derived from a ``RunStats`` delta; this is what the staged API
  (:mod:`repro_torch.core.api`) hands back to callers and what
  ``mixed.instrument()`` aggregates via :meth:`ExecutionReport.merge`.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Iterable

from ..obs.histogram import HistogramSet


@dataclasses.dataclass
class RunStats:
    guest_ops: int = 0                      # ops executed by the interpreter
    guest_calls: int = 0                    # function invocations interpreted
    guest_to_host: int = 0                  # offload crossings (Fig. 5 metric)
    host_to_guest: int = 0                  # reentrancy callbacks
    conversion_builds: int = 0              # calling-conversion plans constructed
    grt_hits: int = 0                       # plans served from the GRT
    compiles: int = 0                       # first-signature unit calls
    per_function_crossings: Counter = dataclasses.field(default_factory=Counter)
    max_reentry_depth: int = 0
    nested_crossings: int = 0               # guest→host crossings issued while a
                                            # host region was already live (the
                                            # interleaved call chains of Fig. 3)
    max_interleave_depth: int = 0           # deepest guest/host alternation
    place_ns: int = 0                       # host ns placing crossing arguments
    placed_bytes: int = 0                   # argument bytes convert_in copied
    resident_bytes: int = 0                 # argument bytes passed by reference
    unit_latency: HistogramSet = dataclasses.field(
        default_factory=HistogramSet)      # crossing wall time per (unit, sig)

    def reset(self) -> None:
        self.guest_ops = 0
        self.guest_calls = 0
        self.guest_to_host = 0
        self.host_to_guest = 0
        self.conversion_builds = 0
        self.grt_hits = 0
        self.compiles = 0
        self.per_function_crossings.clear()
        self.max_reentry_depth = 0
        self.nested_crossings = 0
        self.max_interleave_depth = 0
        self.place_ns = 0
        self.placed_bytes = 0
        self.resident_bytes = 0
        self.unit_latency = HistogramSet()

    def copy(self) -> "RunStats":
        return dataclasses.replace(
            self,
            per_function_crossings=Counter(self.per_function_crossings),
            unit_latency=self.unit_latency.copy(),
        )

    def merge(self, other: "RunStats") -> None:
        """Fold ``other`` into this cumulative record (sums counters, maxes
        high-water marks).  The staged API gives every call its own private
        ``RunStats`` and merges it into the per-signature lifetime record
        afterwards, so concurrent calls never write to shared counters."""
        for f in _SUM_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for f in _MAX_FIELDS:
            setattr(self, f, max(getattr(self, f), getattr(other, f)))
        self.per_function_crossings.update(other.per_function_crossings)
        self.unit_latency.update(other.unit_latency)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["per_function_crossings"] = dict(self.per_function_crossings)
        d["unit_latency"] = self.unit_latency.as_dict()
        return d


# counter fields summed by both the RunStats delta and ExecutionReport.merge
_SUM_FIELDS = (
    "guest_ops", "guest_calls", "guest_to_host", "host_to_guest",
    "conversion_builds", "grt_hits", "compiles", "nested_crossings",
    "place_ns", "placed_bytes", "resident_bytes",
)
_MAX_FIELDS = ("max_reentry_depth", "max_interleave_depth")


@dataclasses.dataclass
class ExecutionReport:
    """What one entry call did: counters, cache behaviour, wall time.

    Produced by :class:`repro_torch.core.api.CompiledHybrid` for every call.
    ``replans`` is the owning compiled object's cumulative count of entry
    signatures planned so far (so a growing value across reports means the
    object is seeing new shapes); ``cache_hits`` is 1 when this call reused
    an already-planned signature, 0 when it triggered a fresh plan.
    """

    scheme: str = ""
    signature: tuple | None = None          # entry avals of this call
    calls: int = 1
    cache_hits: int = 0
    replans: int = 0                        # cumulative plans built (owner-wide)
    owner: int | None = None                # id of the producing CompiledHybrid
    wall_seconds: float = 0.0
    guest_ops: int = 0
    guest_calls: int = 0
    guest_to_host: int = 0
    host_to_guest: int = 0
    conversion_builds: int = 0
    grt_hits: int = 0
    compiles: int = 0
    nested_crossings: int = 0
    max_reentry_depth: int = 0
    max_interleave_depth: int = 0
    place_ns: int = 0                       # host ns placing crossing arguments
    placed_bytes: int = 0                   # argument bytes convert_in copied
    resident_bytes: int = 0                 # argument bytes passed by reference
    per_function_crossings: Counter = dataclasses.field(default_factory=Counter)
    latency: HistogramSet = dataclasses.field(
        default_factory=HistogramSet)      # crossing wall time per (unit, sig)

    @property
    def cache_hit(self) -> bool:
        return self.cache_hits > 0

    @classmethod
    def from_stats_delta(
        cls, before: RunStats, after: RunStats, **kw
    ) -> "ExecutionReport":
        """Report for the work done between two RunStats snapshots."""
        fields = {f: getattr(after, f) - getattr(before, f) for f in _SUM_FIELDS}
        for f in _MAX_FIELDS:
            # high-water marks can't be differenced; default to the observed
            # value in `after` — callers isolating a single call override via
            # kw (see CompiledHybrid.__call__, which zeroes the marks first)
            fields[f] = getattr(after, f)
        delta = Counter(after.per_function_crossings)
        delta.subtract(before.per_function_crossings)
        fields["per_function_crossings"] = +delta  # drop zero entries
        fields["latency"] = after.unit_latency.delta_since(before.unit_latency)
        fields.update(kw)
        return cls(**fields)

    def merge(self, *others: "ExecutionReport") -> "ExecutionReport":
        """Aggregate this report with ``others`` (sums counters, maxes depths).

        ``replans`` is cumulative per producing object, so same-owner reports
        take the max while reports from different (or unknown) owners sum —
        use :meth:`aggregate` for arbitrary report lists; it groups by owner
        first so order doesn't matter.
        """
        out = dataclasses.replace(
            self,
            per_function_crossings=Counter(self.per_function_crossings),
            latency=self.latency.copy(),
        )
        for o in others:
            out.calls += o.calls
            out.cache_hits += o.cache_hits
            if out.owner is not None and out.owner == o.owner:
                out.replans = max(out.replans, o.replans)
            else:
                out.replans += o.replans
                out.owner = None
            out.wall_seconds += o.wall_seconds
            for f in _SUM_FIELDS:
                setattr(out, f, getattr(out, f) + getattr(o, f))
            for f in _MAX_FIELDS:
                setattr(out, f, max(getattr(out, f), getattr(o, f)))
            out.per_function_crossings.update(o.per_function_crossings)
            out.latency.update(o.latency)
            if out.signature != o.signature:
                out.signature = None
            if out.scheme != o.scheme:
                out.scheme = "<mixed>"
        return out

    @classmethod
    def aggregate(cls, reports: Iterable["ExecutionReport"]) -> "ExecutionReport":
        reports = list(reports)
        if not reports:
            return cls(calls=0)
        # group by owner so each object's cumulative replans counts once
        groups: dict = {}
        for r in reports:
            groups.setdefault(r.owner if r.owner is not None else id(r), []).append(r)
        merged = [g[0].merge(*g[1:]) for g in groups.values()]
        return merged[0].merge(*merged[1:])

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["per_function_crossings"] = dict(self.per_function_crossings)
        d["latency"] = self.latency.as_dict()
        d["cache_hit"] = self.cache_hit
        return d


@dataclasses.dataclass
class Coverage:
    """Fig. 6 analogue: how many functions were offloaded, out of how many."""

    total_functions: int = 0
    offloaded_functions: int = 0
    outlined_segments: int = 0              # PFO-created offload units
    rejected_by_costmodel: int = 0
    blocked_by_host_ops: int = 0
    blocked_by_recursion: int = 0

    @property
    def fraction(self) -> float:
        return self.offloaded_functions / max(1, self.total_functions)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fraction"] = self.fraction
        return d


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
