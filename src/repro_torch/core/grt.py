"""Global Reference Table (GRT).

Paper §3.4: *"Basic design incurs unnecessary construction of same data for
each cross-side function call.  GRT pre-stores them in global constants to
eliminate those costs."*

Our GRT caches, per (offload unit, argument avals):
  * the :class:`~repro_torch.core.convert.ConversionPlan` (marshaling recipe), and
  * the staged device-resident globals inside it (weights/constants),
so repeated crossings skip plan reconstruction and global re-staging.
Without GRT the engine rebuilds the plan — including ``device_put`` of every
global — on *every* guest→host crossing, exactly like the paper's baseline.

The table is **thread-safe**: concurrent sessions of the serving runtime
(:mod:`repro_torch.serve`) share one table per signature state, and a re-entrant
lock guarantees each (unit, avals) plan is built exactly once even when many
threads cross simultaneously (the build itself runs under the lock, so a
racing thread waits for the winner's plan instead of duplicating the
``device_put`` of every global).

The table keeps its own ``hits``/``builds`` counters; a :class:`RunStats`
may additionally be attached (constructor) or supplied per lookup (the
staged API passes each call's private stats so per-call
``ExecutionReport`` deltas attribute GRT traffic to the right caller).
"""
from __future__ import annotations

import threading
from typing import Callable

from .convert import ConversionPlan
from .opset import AVal
from .stats import RunStats


class GlobalReferenceTable:
    def __init__(self, stats: RunStats | None = None):
        self._table: dict[tuple, ConversionPlan] = {}
        self._stats = stats
        # re-entrant: a builder that crosses again (nested offload while
        # staging) must not deadlock against its own table
        self._lock = threading.RLock()
        self.hits = 0
        self.builds = 0

    def lookup_or_build(
        self,
        fname: str,
        arg_avals: tuple[AVal, ...],
        builder: Callable[[], ConversionPlan],
        stats: RunStats | None = None,
    ) -> ConversionPlan:
        stats = stats if stats is not None else self._stats
        key = (fname, arg_avals)
        with self._lock:
            plan = self._table.get(key)
            if plan is not None:
                self.hits += 1
                if stats is not None:
                    stats.grt_hits += 1
                return plan
            self.builds += 1
            if stats is not None:
                stats.conversion_builds += 1
            plan = builder()
            self._table[key] = plan
            return plan

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)
