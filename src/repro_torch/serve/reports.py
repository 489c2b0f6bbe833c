"""Serving-side instrumentation: what the batching runtime did, aggregated.

Where :class:`~repro_torch.core.stats.ExecutionReport` describes one entry call,
:class:`ServerReport` describes the *server's* behaviour across calls: how
well batching amortized the paper's fixed per-crossing cost (crossings per
request, batch occupancy), how long requests queued, and how often a cold
bucket fell back to the emulator path while its plan compiled in the
background.  :class:`DecodeReport` is the analogue for the token-level
continuous-batching scheduler: tokens per crossing, per-step occupancy,
admission waits.

Ratio metrics can be undefined before any qualifying work ran (e.g.
``crossings_per_request`` before the first compiled-path request,
``tokens_per_crossing`` before the first crossing).  The numeric properties
return ``nan`` — never a misleading 0.0 — and every human-oriented renderer
(``__str__``, :meth:`ServerReport.table`) prints such values as ``"n/a"``.
"""
from __future__ import annotations

import dataclasses
import math
import threading

from ..core.stats import ExecutionReport
from ..obs.histogram import HistogramSet


def _fmt(x: float, spec: str = ".2f") -> str:
    """Render a ratio metric for logs: ``nan`` (undefined yet) → ``"n/a"``."""
    return "n/a" if isinstance(x, float) and math.isnan(x) else format(x, spec)


def _render_rows(rows: list[tuple[str, str]]) -> str:
    """Width-aligned key/value table shared by the ``table()`` renderers."""
    width = max(len(k) for k, _ in rows)
    return "\n".join(f"{k:<{width}}  {v}" for k, v in rows)


class _OwnerFoldingStats:
    """Shared accumulator core: a lock, plain counters, and per-owner
    incremental folding of :class:`ExecutionReport`\\ s (O(producers) state,
    preserving ``replans``' per-owner cumulative-max semantics — see
    ``ExecutionReport.merge``)."""

    def __init__(self, **counters):
        self._lock = threading.Lock()
        self._merged_by_owner: dict[int | None, ExecutionReport] = {}
        self._r: dict = counters

    def _fold(self, report: ExecutionReport) -> None:
        cur = self._merged_by_owner.get(report.owner)
        self._merged_by_owner[report.owner] = (
            report if cur is None else cur.merge(report)
        )

    def _merged_execution(self) -> ExecutionReport:
        # caller holds self._lock
        per_owner = list(self._merged_by_owner.values())
        return (per_owner[0].merge(*per_owner[1:])
                if per_owner else ExecutionReport(calls=0))


@dataclasses.dataclass(frozen=True)
class ServerReport:
    """Immutable snapshot of a :class:`~repro_torch.serve.MixedServer`'s counters.

    ``execution`` merges the per-call :class:`ExecutionReport` of every
    server-side entry call (batched compiled calls, warmups, and emulator
    fallbacks), so crossing counters reconcile with the core engine's
    accounting.
    """

    requests: int = 0                   # requests completed
    batches: int = 0                    # batched entry calls on the compiled path
    fallback_requests: int = 0          # requests served on the emulator path
    fallback_calls: int = 0             # emulator-path entry calls
    oversize_splits: int = 0            # chunk cuts on batches above the top
                                        # bucket (a batch split into n chunks
                                        # counts n - 1)
    warm_compiles: int = 0              # buckets compiled off the request path
                                        # (background warms and user warm())
    warm_failures: int = 0              # failed warm attempts (bucket retried)
    request_rows: int = 0               # real rows executed
    padded_rows: int = 0                # rows after bucket padding
    queue_wait_total: float = 0.0       # seconds spent queued, summed
    queue_wait_max: float = 0.0
    pool_wait_total: float = 0.0        # of those, seconds from the batch's
                                        # cut to a worker's start, summed
    crossings: int = 0                  # guest→host crossings serving requests
                                        # (warmup crossings appear only in
                                        # `execution`, not in crossings_per_request)
    execution: ExecutionReport = dataclasses.field(
        # ExecutionReport's dataclass default is calls=1 (one entry call);
        # an empty server report must not claim a phantom call
        default_factory=lambda: ExecutionReport(calls=0)
    )

    @property
    def batch_occupancy(self) -> float:
        """Fraction of executed rows that were real requests (1.0 = no
        padding).  NaN until any rows executed."""
        if self.padded_rows == 0:
            return math.nan
        return self.request_rows / self.padded_rows

    @property
    def compiled_requests(self) -> int:
        """Requests served on the compiled (batched, crossing-paying) path."""
        return self.requests - self.fallback_requests

    @property
    def crossings_per_request(self) -> float:
        """The serving-economics headline: amortized guest→host crossings.

        Measured over compiled-path requests only — emulator fallbacks make
        zero crossings but are the *slow* path, so counting them in the
        denominator would make the metric look better the more traffic
        misses the compiled path.  NaN until any compiled request ran.
        """
        if self.compiled_requests == 0:
            return math.nan
        return self.crossings / self.compiled_requests

    @property
    def mean_queue_wait(self) -> float:
        return self.queue_wait_total / max(1, self.requests)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["execution"] = self.execution.as_dict()
        d["batch_occupancy"] = self.batch_occupancy
        d["crossings_per_request"] = self.crossings_per_request
        d["mean_queue_wait"] = self.mean_queue_wait
        return d

    def __str__(self) -> str:  # human-oriented one-liner for demos/logs
        # crossings/request is nan until a compiled-path request ran (see the
        # property docstring); render "n/a" rather than a confusing "nan"
        return (
            f"ServerReport(requests={self.requests}, batches={self.batches}, "
            f"fallback={self.fallback_requests}, "
            f"occupancy={_fmt(self.batch_occupancy)}, "
            f"crossings/request={_fmt(self.crossings_per_request)}, "
            f"mean_wait={self.mean_queue_wait * 1e3:.2f}ms)"
        )

    def table(self) -> str:
        """Multi-line, aligned rendering for demos/benchmark output."""
        return _render_rows([
            ("requests", str(self.requests)),
            ("batched calls", str(self.batches)),
            ("fallback requests", str(self.fallback_requests)),
            ("oversize splits", str(self.oversize_splits)),
            ("warm compiles", str(self.warm_compiles)),
            ("batch occupancy", _fmt(self.batch_occupancy)),
            ("crossings/request", _fmt(self.crossings_per_request)),
            ("mean queue wait", f"{self.mean_queue_wait * 1e3:.2f} ms"),
            ("max queue wait", f"{self.queue_wait_max * 1e3:.2f} ms"),
        ])


class ServerStats(_OwnerFoldingStats):
    """Lock-guarded accumulator behind ``MixedServer.report()``.

    Worker threads record completed batches concurrently; ``snapshot()``
    freezes the counters into a :class:`ServerReport`.
    """

    def __init__(self):
        super().__init__(
            requests=0, batches=0, fallback_requests=0, fallback_calls=0,
            oversize_splits=0, warm_compiles=0, warm_failures=0,
            request_rows=0, padded_rows=0,
            queue_wait_total=0.0, queue_wait_max=0.0, pool_wait_total=0.0,
            crossings=0,
        )

    def record_batch(
        self,
        *,
        n_requests: int,
        rows: int,
        padded_rows: int,
        waits: list[float],
        reports: list[ExecutionReport],
        fallback_calls: int,
        calls: int = 1,
        splits: int = 0,
        pool_wait: float = 0.0,
    ) -> None:
        """One logical batch, served by ``calls`` entry calls (> 1 when an
        oversized batch was split into top-bucket chunks).  Its requests
        count as fallbacks if *any* chunk ran on the emulator path — the
        slow path dominated their latency.  When that happens the compiled
        chunks' crossings are kept out of ``crossings`` too (they still
        appear in ``execution``): ``crossings_per_request`` divides by
        compiled-path requests only, so crossings whose requests left the
        denominator must leave the numerator with them.  ``pool_wait`` is
        the part of ``waits``' sum spent between the cut and the worker."""
        with self._lock:
            r = self._r
            r["requests"] += n_requests
            r["pool_wait_total"] += pool_wait
            r["fallback_calls"] += fallback_calls
            r["batches"] += calls - fallback_calls
            if fallback_calls:
                r["fallback_requests"] += n_requests
            r["oversize_splits"] += splits
            r["request_rows"] += rows
            r["padded_rows"] += padded_rows
            r["queue_wait_total"] += sum(waits)
            r["queue_wait_max"] = max(r["queue_wait_max"], *waits, 0.0)
            for report in reports:
                if not fallback_calls:
                    r["crossings"] += report.guest_to_host
                self._fold(report)

    def record_warm(self, report: ExecutionReport | None) -> None:
        with self._lock:
            self._r["warm_compiles"] += 1
            if report is not None:
                self._fold(report)

    def record_warm_failure(self) -> None:
        with self._lock:
            self._r["warm_failures"] += 1

    def snapshot(self) -> ServerReport:
        with self._lock:
            return ServerReport(execution=self._merged_execution(), **self._r)


# ---------------------------------------------------------------------------
# token-level continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodeReport:
    """Immutable snapshot of a :class:`~repro_torch.serve.DecodeScheduler`'s counters.

    The serving-economics headline here is :attr:`tokens_per_crossing`: a
    solo decode loop pays one crossing-set per token; the continuous batcher
    pays one per *step*, shared by every live stream, so tokens/crossing
    scales with occupancy.  ``execution`` merges the per-call
    :class:`~repro_torch.core.stats.ExecutionReport` of every scheduler-issued
    entry call (prefills, steps, and warmups), reconciling with the core
    engine's accounting.
    """

    streams: int = 0                    # decode streams completed
    tokens: int = 0                     # tokens emitted across all streams
    step_tokens: int = 0                # tokens emitted by step calls only
    steps: int = 0                      # batched decode-step entry calls
    prefills: int = 0                   # batched prefill entry calls
    warm_calls: int = 0                 # warmup calls (excluded from crossings)
    live_rows: int = 0                  # real stream-rows summed over steps
    slot_rows: int = 0                  # capacity rows summed over steps
    admitted: int = 0                   # streams admitted (prefilled) so far
    crossings: int = 0                  # guest→host crossings serving streams
                                        # (prefills + steps; warmups appear
                                        # only in `execution`)
    state_bytes: int = 0                # decode-state bytes handed across
                                        # serving calls (prefill outputs +
                                        # step inputs, at padded shapes;
                                        # resident pools by their size)
    step_place_s: float = 0.0           # host seconds the step calls' crossings
                                        # spent placing their arguments
    step_placed_bytes: int = 0          # argument bytes the step calls'
                                        # crossings copied to the device
    step_resident_bytes: int = 0        # argument bytes they passed by
                                        # reference (resident page pools)
    admit_wait_total: float = 0.0       # seconds from submit() to prefill
    admit_wait_max: float = 0.0
    failures: int = 0                   # streams resolved with an exception
    # paged KV-cache counters (all 0 for fixed-row state contracts)
    page_size: int = 0                  # positions per page
    page_capacity: int = 0              # pool size in pages
    pages_in_use: int = 0               # at snapshot; 0 after close = no leaks
    pages_peak: int = 0                 # high-water concurrent pages
    page_allocs: int = 0
    page_frees: int = 0                 # allocs - frees == pages_in_use
    cache_rows_valid: int = 0           # filled KV positions summed over steps
    cache_rows_allocated: int = 0       # page-held positions summed over steps
    # prefix-sharing counters (all 0 unless StateSpec.share_prefixes)
    prefix_hits: int = 0                # admissions that mapped a shared prefix
    prefix_tokens_reused: int = 0       # prompt positions served from shared
                                        # pages instead of being re-stored
    pages_shared: int = 0               # cumulative shared-page mappings
    pages_cow_copied: int = 0           # copy-on-write page copies (0 in the
                                        # common page-aligned case)
    state_bytes_saved: int = 0          # page-store bytes sharing avoided
    prefix_evictions: int = 0           # LRU prefix entries dropped (pool
                                        # pressure, the index bound, and the
                                        # release at close)
    # paged-kernel counters (all 0 unless the scheduler runs a paged_step
    # root — the block-sparse Pallas attention path)
    kernel_steps: int = 0               # steps served by the paged kernel
    pages_visited: int = 0              # live pages the kernel attended,
                                        # summed over kernel steps
    pages_skipped: int = 0              # dead table slots skipped; visited +
                                        # skipped == slots × table width
    execution: ExecutionReport = dataclasses.field(
        default_factory=lambda: ExecutionReport(calls=0)
    )
    # wall-time distribution of the scheduler's own phases, keyed
    # ("prefill"|"prefill_suffix"|"step", "") — per-(unit, signature)
    # crossing latency lives on execution.latency (see repro_torch.obs)
    latency: HistogramSet = dataclasses.field(default_factory=HistogramSet)

    @property
    def tokens_per_crossing(self) -> float:
        """Tokens emitted per guest→host crossing (NaN until any crossing).

        The reciprocal of the paper's fixed-cost-per-token: higher is
        better, and it grows with the number of concurrently live streams
        because every step's crossing-set is shared by the whole batch.
        """
        if self.crossings == 0:
            return math.nan
        return self.tokens / self.crossings

    @property
    def tokens_per_step(self) -> float:
        """Mean tokens produced by one batched step call (NaN before any;
        prefill-emitted tokens are excluded — they count in ``tokens``)."""
        if self.steps == 0:
            return math.nan
        return self.step_tokens / self.steps

    @property
    def step_occupancy(self) -> float:
        """Fraction of stepped slot-rows holding live streams (1.0 = full).
        NaN until any step ran."""
        if self.slot_rows == 0:
            return math.nan
        return self.live_rows / self.slot_rows

    @property
    def state_bytes_per_crossing(self) -> float:
        """Decode-state bytes marshalled per guest→host crossing (NaN until
        any crossing) — the per-crossing channel load the paper's fixed-cost
        analysis prices.  Paged state keeps this *flat in stream count*:
        every step re-materializes the same fixed padded shape however the
        cache is occupied."""
        if self.crossings == 0:
            return math.nan
        return self.state_bytes / self.crossings

    @property
    def cache_occupancy(self) -> float:
        """Fraction of page-held KV positions actually filled (1.0 = no
        intra-page waste).  NaN until any paged step ran; page-size 1 pins
        it at 1.0, larger pages trade waste for fewer allocations.  With
        prefix sharing the numerator counts *logical* filled positions while
        the denominator counts *physical* page rows, so values above 1.0
        quantify deduplication: several streams' prefixes resident in one
        set of pages."""
        if self.cache_rows_allocated == 0:
            return math.nan
        return self.cache_rows_valid / self.cache_rows_allocated

    @property
    def page_occupancy(self) -> float:
        """Fraction of the pool's pages in use at snapshot (NaN when the
        scheduler has no paged state)."""
        if self.page_capacity == 0:
            return math.nan
        return self.pages_in_use / self.page_capacity

    @property
    def unique_state_bytes_per_crossing(self) -> float:
        """Sharing-adjusted channel+storage load per crossing: marshalled
        state bytes minus the page-store bytes prefix sharing avoided
        (``state_bytes_saved``).  Equals :attr:`state_bytes_per_crossing`
        when sharing is off; strictly below it when prefixes were reused.
        NaN until any crossing."""
        if self.crossings == 0:
            return math.nan
        return (self.state_bytes - self.state_bytes_saved) / self.crossings

    @property
    def page_visit_fraction(self) -> float:
        """Fraction of stepped block-table slots the paged kernel actually
        attended (NaN until any kernel step ran).  The dense step's
        equivalent is always 1.0 — it reads every padded position — so
        ``1 - page_visit_fraction`` is the fraction of attention work the
        block-sparse walk eliminated on this traffic."""
        total = self.pages_visited + self.pages_skipped
        if total == 0:
            return math.nan
        return self.pages_visited / total

    @property
    def mean_admit_wait(self) -> float:
        return self.admit_wait_total / max(1, self.admitted)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["execution"] = self.execution.as_dict()
        d["latency"] = self.latency.as_dict()
        d["page_visit_fraction"] = self.page_visit_fraction
        d["tokens_per_crossing"] = self.tokens_per_crossing
        d["tokens_per_step"] = self.tokens_per_step
        d["step_occupancy"] = self.step_occupancy
        d["state_bytes_per_crossing"] = self.state_bytes_per_crossing
        d["unique_state_bytes_per_crossing"] = self.unique_state_bytes_per_crossing
        d["cache_occupancy"] = self.cache_occupancy
        d["page_occupancy"] = self.page_occupancy
        d["mean_admit_wait"] = self.mean_admit_wait
        return d

    def __str__(self) -> str:
        return (
            f"DecodeReport(streams={self.streams}, tokens={self.tokens}, "
            f"steps={self.steps}, prefills={self.prefills}, "
            f"tokens/crossing={_fmt(self.tokens_per_crossing)}, "
            f"occupancy={_fmt(self.step_occupancy)}, "
            f"mean_admit_wait={self.mean_admit_wait * 1e3:.2f}ms)"
        )

    def table(self) -> str:
        """Multi-line, aligned rendering for demos/benchmark output."""
        rows = [
            ("streams", str(self.streams)),
            ("tokens", str(self.tokens)),
            ("step calls", str(self.steps)),
            ("prefill calls", str(self.prefills)),
            ("crossings", str(self.crossings)),
            ("tokens/crossing", _fmt(self.tokens_per_crossing)),
            ("tokens/step", _fmt(self.tokens_per_step)),
            ("step occupancy", _fmt(self.step_occupancy)),
            ("state bytes/crossing", _fmt(self.state_bytes_per_crossing, ".0f")),
            ("mean admit wait", f"{self.mean_admit_wait * 1e3:.2f} ms"),
        ]
        if self.page_capacity:
            rows += [
                ("pages in use", f"{self.pages_in_use}/{self.page_capacity} "
                                 f"(peak {self.pages_peak}, "
                                 f"size {self.page_size})"),
                ("cache occupancy", _fmt(self.cache_occupancy)),
            ]
        if self.prefix_hits or self.pages_shared:
            rows += [
                ("prefix hits", str(self.prefix_hits)),
                ("prefix tokens reused", str(self.prefix_tokens_reused)),
                ("pages shared / cow", f"{self.pages_shared} / "
                                       f"{self.pages_cow_copied}"),
                ("state bytes saved", str(self.state_bytes_saved)),
            ]
        if self.kernel_steps:
            rows += [
                ("kernel steps", str(self.kernel_steps)),
                ("pages visited / skipped", f"{self.pages_visited} / "
                                            f"{self.pages_skipped}"),
                ("page visit fraction", _fmt(self.page_visit_fraction)),
            ]
        return _render_rows(rows)


@dataclasses.dataclass(frozen=True)
class ClusterReport:
    """Aggregate view over a :class:`~repro_torch.serve.ClusterRouter`'s workers.

    Folds one :class:`DecodeReport` per worker (dead workers contribute
    their last report, drained workers their final one) plus the router's
    own routing counters.  The cluster-economics headline is the same as a
    single scheduler's — :attr:`tokens_per_crossing` — computed over the
    *aggregate* token and crossing totals, so it answers "did scaling out
    preserve the per-crossing amortization?".  ``compiles`` sums the
    workers' merged ``execution.compiles``: a fleet booted from a warm AOT
    cache (:meth:`repro_torch.core.api.PlannedProgram.load_aot`) reports 0 here.
    """

    workers: int = 0                    # workers ever started
    live_workers: int = 0               # accepting traffic at snapshot
    routed_affinity: int = 0            # submissions placed by prefix hash
    routed_spill: int = 0               # submissions placed round-robin
    worker_reports: tuple[DecodeReport, ...] = ()
    # observability fold (see repro_torch.obs):
    worker_warnings: tuple[str, ...] = ()   # structured warnings shipped back
                                            # from worker processes (Python
                                            # warnings there are otherwise
                                            # invisible to the parent)
    worker_spans: int = 0               # spans folded from worker tracers
    spans_dropped: int = 0              # ring overflow, workers + router

    def _sum(self, field: str) -> int:
        return sum(getattr(r, field) for r in self.worker_reports)

    @property
    def streams(self) -> int:
        return self._sum("streams")

    @property
    def tokens(self) -> int:
        return self._sum("tokens")

    @property
    def crossings(self) -> int:
        return self._sum("crossings")

    @property
    def failures(self) -> int:
        return self._sum("failures")

    @property
    def prefix_hits(self) -> int:
        """Cross-worker total of admissions that mapped a shared prefix —
        the payoff of prefix-affinity routing: prompts that can share pages
        land on the worker whose LRU prefix index holds them."""
        return self._sum("prefix_hits")

    @property
    def prefix_tokens_reused(self) -> int:
        return self._sum("prefix_tokens_reused")

    @property
    def compiles(self) -> int:
        """First-signature unit calls across the fleet (0 on a warm AOT boot)."""
        return sum(r.execution.compiles for r in self.worker_reports)

    @property
    def tokens_per_crossing(self) -> float:
        """Aggregate tokens per guest→host crossing (NaN until any)."""
        if self.crossings == 0:
            return math.nan
        return self.tokens / self.crossings

    @property
    def latency(self) -> HistogramSet:
        """Cluster-wide scheduler-phase latency: the associative merge of
        every worker's :attr:`DecodeReport.latency` (order-independent)."""
        out = HistogramSet()
        for r in self.worker_reports:
            out.update(r.latency)
        return out

    def as_dict(self) -> dict:
        return {
            "workers": self.workers,
            "live_workers": self.live_workers,
            "routed_affinity": self.routed_affinity,
            "routed_spill": self.routed_spill,
            "streams": self.streams,
            "tokens": self.tokens,
            "crossings": self.crossings,
            "tokens_per_crossing": self.tokens_per_crossing,
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "compiles": self.compiles,
            "failures": self.failures,
            "worker_warnings": list(self.worker_warnings),
            "worker_spans": self.worker_spans,
            "spans_dropped": self.spans_dropped,
            "latency": self.latency.as_dict(),
            "worker_reports": [r.as_dict() for r in self.worker_reports],
        }

    def __str__(self) -> str:
        return (
            f"ClusterReport(workers={self.live_workers}/{self.workers}, "
            f"streams={self.streams}, tokens={self.tokens}, "
            f"tokens/crossing={_fmt(self.tokens_per_crossing)}, "
            f"prefix_hits={self.prefix_hits}, compiles={self.compiles})"
        )

    def table(self) -> str:
        """Multi-line, aligned rendering for demos/benchmark output."""
        rows = [
            ("workers (live/started)", f"{self.live_workers}/{self.workers}"),
            ("routed by affinity", str(self.routed_affinity)),
            ("routed round-robin", str(self.routed_spill)),
            ("streams", str(self.streams)),
            ("tokens", str(self.tokens)),
            ("crossings", str(self.crossings)),
            ("tokens/crossing", _fmt(self.tokens_per_crossing)),
            ("prefix hits (cross-worker)", str(self.prefix_hits)),
            ("prefix tokens reused", str(self.prefix_tokens_reused)),
            ("compiles", str(self.compiles)),
            ("failures", str(self.failures)),
        ]
        if self.worker_spans or self.worker_warnings:
            rows += [
                ("worker spans folded", str(self.worker_spans)),
                ("spans dropped", str(self.spans_dropped)),
                ("worker warnings", str(len(self.worker_warnings))),
            ]
        return _render_rows(rows)


@dataclasses.dataclass(frozen=True)
class MultiModelReport:
    """Per-model + aggregate view over a
    :class:`~repro_torch.serve.MultiModelDecodeScheduler`.

    ``models`` holds one :class:`DecodeReport` per registered model — the
    per-model sections, each with its own tokens/crossing, occupancy, and
    page counters (a fixed-size-state model's ``page_allocs`` is 0 by
    contract).  The ``pool_*`` fields are the *shared* :class:`PagePool`'s
    global counters, mixing every paged tenant's traffic; per-model page
    accounting lives in each model's section, and the two reconcile:
    ``pool_allocs == sum of per-model page_allocs`` (likewise frees), so
    the cross-tenant leak identity ``pool_allocs - pool_frees ==
    pool_in_use == 0`` holds at close.  Aggregate properties sum over the
    sections; the co-serving headline is the per-model contrast in
    :attr:`DecodeReport.state_bytes_per_crossing` — fixed-size state pays
    a tiny constant per crossing while growing KV state pays the padded
    cache — which :meth:`table` puts side by side.
    """

    models: dict[str, DecodeReport] = dataclasses.field(default_factory=dict)
    # shared-pool globals (0 when no registered model pages)
    pool_pages: int = 0
    pool_page_size: int = 0
    pool_in_use: int = 0                # at snapshot; 0 after close = no leaks
    pool_peak: int = 0                  # high-water across all tenants
    pool_allocs: int = 0
    pool_frees: int = 0
    pool_refs_outstanding: int = 0      # refcount leaks across tenants

    def _sum(self, field: str) -> int:
        return sum(getattr(r, field) for r in self.models.values())

    @property
    def streams(self) -> int:
        return self._sum("streams")

    @property
    def tokens(self) -> int:
        return self._sum("tokens")

    @property
    def steps(self) -> int:
        return self._sum("steps")

    @property
    def prefills(self) -> int:
        return self._sum("prefills")

    @property
    def crossings(self) -> int:
        return self._sum("crossings")

    @property
    def state_bytes(self) -> int:
        return self._sum("state_bytes")

    @property
    def failures(self) -> int:
        return self._sum("failures")

    @property
    def tokens_per_crossing(self) -> float:
        """Aggregate tokens per guest→host crossing (NaN until any)."""
        if self.crossings == 0:
            return math.nan
        return self.tokens / self.crossings

    @property
    def state_bytes_per_crossing(self) -> float:
        """Aggregate marshalled state bytes per crossing (NaN until any)."""
        if self.crossings == 0:
            return math.nan
        return self.state_bytes / self.crossings

    def as_dict(self) -> dict:
        return {
            "models": {name: r.as_dict() for name, r in self.models.items()},
            "streams": self.streams,
            "tokens": self.tokens,
            "steps": self.steps,
            "prefills": self.prefills,
            "crossings": self.crossings,
            "tokens_per_crossing": self.tokens_per_crossing,
            "state_bytes": self.state_bytes,
            "state_bytes_per_crossing": self.state_bytes_per_crossing,
            "failures": self.failures,
            "pool_pages": self.pool_pages,
            "pool_page_size": self.pool_page_size,
            "pool_in_use": self.pool_in_use,
            "pool_peak": self.pool_peak,
            "pool_allocs": self.pool_allocs,
            "pool_frees": self.pool_frees,
            "pool_refs_outstanding": self.pool_refs_outstanding,
        }

    def __str__(self) -> str:
        return (
            f"MultiModelReport(models={len(self.models)}, "
            f"streams={self.streams}, tokens={self.tokens}, "
            f"tokens/crossing={_fmt(self.tokens_per_crossing)}, "
            f"pool_in_use={self.pool_in_use}/{self.pool_pages})"
        )

    def table(self) -> str:
        """Per-model sections plus the aggregate, for demos/benchmarks."""
        parts = []
        for name in sorted(self.models):
            parts.append(f"[{name}]\n{self.models[name].table()}")
        rows = [
            ("models", str(len(self.models))),
            ("streams", str(self.streams)),
            ("tokens", str(self.tokens)),
            ("crossings", str(self.crossings)),
            ("tokens/crossing", _fmt(self.tokens_per_crossing)),
            ("state bytes/crossing", _fmt(self.state_bytes_per_crossing, ".0f")),
            ("failures", str(self.failures)),
        ]
        if self.pool_pages:
            rows.append(
                ("shared pool in use",
                 f"{self.pool_in_use}/{self.pool_pages} "
                 f"(peak {self.pool_peak}, size {self.pool_page_size})"))
        parts.append("[aggregate]\n" + _render_rows(rows))
        return "\n\n".join(parts)


class DecodeStats(_OwnerFoldingStats):
    """Lock-guarded accumulator behind ``DecodeScheduler.report()``.

    The decode loop records from its scheduler thread while ``snapshot()``
    may run on any caller thread.  ``tokens`` counts *emitted* tokens — the
    scheduler reports how many samples actually succeeded per call, so a
    stream killed by a poisoned sampler never inflates the token counters.
    """

    def __init__(self):
        super().__init__(
            streams=0, tokens=0, step_tokens=0, steps=0, prefills=0,
            warm_calls=0, live_rows=0, slot_rows=0, admitted=0, crossings=0,
            state_bytes=0, step_place_s=0.0, step_placed_bytes=0,
            step_resident_bytes=0,
            admit_wait_total=0.0, admit_wait_max=0.0,
            failures=0, page_size=0, page_capacity=0, pages_in_use=0,
            pages_peak=0, page_allocs=0, page_frees=0, cache_rows_valid=0,
            cache_rows_allocated=0, prefix_hits=0, prefix_tokens_reused=0,
            pages_shared=0, pages_cow_copied=0, state_bytes_saved=0,
            prefix_evictions=0, kernel_steps=0, pages_visited=0, pages_skipped=0,
        )
        # scheduler-phase wall-time distribution (DecodeReport.latency)
        self._hist = HistogramSet()

    def record_prefill(self, *, n_streams: int, tokens: int,
                       waits: list[float],
                       report: ExecutionReport,
                       state_bytes: int = 0,
                       phase: str = "prefill") -> None:
        with self._lock:
            r = self._r
            r["prefills"] += 1
            r["admitted"] += n_streams
            r["tokens"] += tokens
            r["crossings"] += report.guest_to_host
            r["state_bytes"] += state_bytes
            r["admit_wait_total"] += sum(waits)
            r["admit_wait_max"] = max(r["admit_wait_max"], *waits, 0.0)
            self._hist.record((phase, ""), int(report.wall_seconds * 1e9))
            self._fold(report)

    def record_step(self, *, live: int, slots: int, tokens: int,
                    report: ExecutionReport,
                    state_bytes: int = 0,
                    cache_valid: int = 0, cache_alloc: int = 0,
                    pages_visited: int = 0, pages_skipped: int = 0,
                    kernel_step: bool = False) -> None:
        with self._lock:
            r = self._r
            r["steps"] += 1
            r["tokens"] += tokens
            r["step_tokens"] += tokens
            r["live_rows"] += live
            r["slot_rows"] += slots
            r["crossings"] += report.guest_to_host
            r["state_bytes"] += state_bytes
            r["step_place_s"] += report.place_ns / 1e9
            r["step_placed_bytes"] += report.placed_bytes
            r["step_resident_bytes"] += report.resident_bytes
            r["cache_rows_valid"] += cache_valid
            r["cache_rows_allocated"] += cache_alloc
            if kernel_step:
                r["kernel_steps"] += 1
                r["pages_visited"] += pages_visited
                r["pages_skipped"] += pages_skipped
            self._hist.record(("step", ""), int(report.wall_seconds * 1e9))
            self._fold(report)

    def record_pool(self, *, page_size: int, page_capacity: int,
                    in_use: int, peak: int, allocs: int, frees: int,
                    prefix_hits: int = 0, prefix_tokens_reused: int = 0,
                    pages_shared: int = 0, pages_cow_copied: int = 0,
                    state_bytes_saved: int = 0,
                    prefix_evictions: int = 0) -> None:
        """Absolute pool counters (the loop owns the pool; these mirror it)."""
        with self._lock:
            r = self._r
            r["page_size"] = page_size
            r["page_capacity"] = page_capacity
            r["pages_in_use"] = in_use
            r["pages_peak"] = peak
            r["page_allocs"] = allocs
            r["page_frees"] = frees
            r["prefix_hits"] = prefix_hits
            r["prefix_tokens_reused"] = prefix_tokens_reused
            r["pages_shared"] = pages_shared
            r["pages_cow_copied"] = pages_cow_copied
            r["state_bytes_saved"] = state_bytes_saved
            r["prefix_evictions"] = prefix_evictions

    def record_retire(self, *, failed: bool = False) -> None:
        with self._lock:
            self._r["streams"] += 1
            if failed:
                self._r["failures"] += 1

    def record_warm(self, report: ExecutionReport | None) -> None:
        with self._lock:
            self._r["warm_calls"] += 1
            if report is not None:
                self._fold(report)

    def snapshot(self) -> DecodeReport:
        with self._lock:
            return DecodeReport(execution=self._merged_execution(),
                                latency=self._hist.copy(), **self._r)
