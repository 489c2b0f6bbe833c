"""``repro_torch.obs`` — crossing-level tracing, histograms, and structured logs.

    from repro_torch import obs

    with obs.session() as tracer:
        hybrid(x)                       # crossing/unit/emulator spans
    tracer.export_chrome_trace("trace.json")   # open in Perfetto

Three cooperating pieces (see ``docs/observability.md``):

* :class:`Tracer` — a per-process flight recorder: bounded span ring with
  counted drops, structured log buffer, per-(name, kind) latency
  histograms, Chrome trace-event export.
* :class:`Histogram` / :class:`HistogramSet` — fixed log-bucket latency
  distributions with associative ``merge``, carried on
  ``ExecutionReport.latency`` / ``DecodeReport.latency`` and consumed by
  ``ProfiledCostModel``.
* the module-level gate — :func:`install` / :func:`active` /
  :func:`session`.  ``active()`` returns ``None`` whenever span recording
  is off, so instrumented hot paths cost one ``is None`` test and program
  outputs are bit-identical traced or not.
"""
from .histogram import (
    BUCKET_UPPER_NS,
    N_BUCKETS,
    Histogram,
    HistogramSet,
    bucket_index,
)
from .trace import (
    ADMIT_WAIT,
    AOT,
    CALL,
    COMPILE,
    CROSSING,
    EMULATOR,
    FRAME,
    BATCH,
    DRAIN,
    EMIT,
    FETCH,
    PLACE,
    PREFILL,
    REENTRY,
    RESULT,
    SPAN_KINDS,
    SSD,
    STEP,
    SUBMIT,
    UNIT,
    DeviceInterval,
    LogEvent,
    Span,
    Tracer,
    active,
    context_trace_id,
    current,
    install,
    log_event,
    maybe_span,
    next_submission_id,
    session,
    trace_context,
    traced,
    warn,
)

__all__ = [
    "Histogram", "HistogramSet", "bucket_index",
    "N_BUCKETS", "BUCKET_UPPER_NS",
    "Span", "LogEvent", "Tracer", "DeviceInterval",
    "install", "current", "active", "session", "maybe_span", "traced",
    "warn", "log_event", "next_submission_id", "trace_context",
    "context_trace_id",
    "SPAN_KINDS",
    "CROSSING", "UNIT", "EMULATOR", "REENTRY", "CALL", "COMPILE",
    "PREFILL", "STEP", "ADMIT_WAIT",
    "PLACE", "DRAIN", "FETCH", "EMIT", "BATCH", "SSD",
    "AOT", "FRAME", "SUBMIT", "RESULT",
]
