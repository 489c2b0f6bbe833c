"""The flight recorder: typed spans, a bounded ring, and Chrome export.

One :class:`Tracer` per process, installed with :func:`install` (or the
:func:`session` context manager).  Producers throughout the stack ask
:func:`active` for the tracer **once per call boundary** and skip every
record when it returns ``None`` — the tracing-off hot path is a single
``is None`` test, costs nothing, and cannot change program outputs
(gated bit-identical in ``benchmarks/smoke_trace.py``).

Design points:

* **Monotonic, cross-process-comparable clock.**  Timestamps are
  ``time.perf_counter_ns()``; on Linux that is ``CLOCK_MONOTONIC``, which
  is system-wide, so spans recorded in spawned worker processes land on
  the same timeline as the parent's without translation.
* **Bounded ring, counted drops.**  The span buffer holds ``capacity``
  records; overflow drops the *oldest* and increments ``spans_dropped``
  so a truncated trace is detectable, never silent.
* **Histograms never drop.**  Every completed span also folds its
  duration into a per-``(name, kind)`` :class:`~repro_torch.obs.histogram.Histogram`
  — O(1) state however long the run — which is what profiling and the
  cost model consume (``repro_torch.core.profiling`` reads the same stream).
* **Logs ride the tracer.**  :func:`warn` records a structured
  :class:`LogEvent` *and* forwards to :mod:`warnings`, so in-process
  callers keep their ``pytest.warns`` contract while cluster workers ship
  the structured copy across the channel instead of losing it.
* **Trace ids.**  A tracer carries a root ``trace_id``; the cluster
  router hands its root id to every worker tracer and stamps a per-
  submission child id (``root/seq``) on submit frames, so a multi-process
  run folds into one coherent timeline keyed by a single root.  Within a
  process a thread may set a trace context (:func:`trace_context`) that
  its spans default to: a ``MixedServer`` worker runs each batch under the
  batch's id.
* **Device clock beside the host's.**  Traced on CUDA, CUDA events
  around a unit's launches (:class:`DeviceInterval`) put its device-clock
  span in its ``unit`` span's args, placed on ``perf_counter_ns`` through
  one anchor a device; the Chrome export draws it on a ``device`` track,
  so a Perfetto file shows where each unit ran without a profiler.

The reference's kinds are documented in ``docs/observability.md``.  The
port's own, inside the crossing and the request:

=============  ====================  ========================================
kind           where                 one span means
=============  ====================  ========================================
``place``      ``core/api.py``       in a crossing: the cast and copy of every
                                     argument to the unit's device; ``bytes``
                                     (copied), and ``resident_bytes`` where
                                     arguments passed by reference
``unit``       ``core/api.py``       in a crossing: the host's enqueue of the
                                     unit; traced on CUDA, ``device_ms`` and
                                     ``device_start_ns`` (below)
``drain``      ``core/api.py``       in a traced crossing on CUDA: the host's
                                     wait for the unit's end event
``fetch``      ``core/api.py``       in a crossing: the results' copy to host
                                     memory; ``bytes`` (copied), and
                                     ``kept_bytes`` where outputs stayed on
                                     the device
``emit``       ``serve/runtime.py``  a decode scheduler's host work after a
                                     prefill group's or a step's call (page
                                     appends, sampling, counters); ``live``
``batch``      ``serve/runtime.py``  one batch on a ``MixedServer`` worker,
                                     under an id of its own; ``requests``
                                     (their ids), ``rows``, ``padded_rows``,
                                     ``bucket``, ``batch_wait_ms`` (each
                                     request's submit to the cut) and
                                     ``pool_wait_ms`` (the cut to the start)
``ssd``        ``core/opset.py``     inside a unit: the host's launch of one
                                     SSD scan (the ``ssd_scan`` op); ``b``,
                                     ``t``, ``h``, ``n``, ``p``, ``chunk``
                                     and ``route`` (the kernel's body, or
                                     ``plain`` off the card)
=============  ====================  ========================================

``device_ms`` is the device clock from the stream reaching the unit's
start event to its end event: the unit's kernels, and on a stream that
other threads also launch on (the legacy default stream, which a
``MixedServer``'s workers share) their kernels in between and the
device's idle too; where the host is the bound it tracks the enqueue.
``device_start_ns`` is that start on ``perf_counter_ns``.  A request's
waits ride its batch's span rather than spans of their own, so that a
timeline labelling the device's idle by the shortest open span does not
pick a waiting request over the work that ran.  The reference's
``page_alloc``/``page_cow``/``page_evict`` events are counted instead
(``DecodeReport.page_allocs``, ``pages_cow_copied``, ``prefix_evictions``).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
import uuid
import warnings as _warnings
from collections import Counter, deque
from dataclasses import dataclass, field

from .histogram import HistogramSet

# --------------------------------------------------------------------------
# Span taxonomy (docs/observability.md and the table above document each kind)

CROSSING = "crossing"        # one guest→host crossing (convert/dispatch/out)
UNIT = "unit"                # the offload-unit dispatch inside a crossing
EMULATOR = "emulator"        # one interpreted guest function body
REENTRY = "reentry"          # host→guest re-entry (emulated callee)
CALL = "call"                # one entry call through CompiledHybrid
COMPILE = "compile"          # a first-signature unit call (the compile hook)
PREFILL = "prefill"          # one batched prefill group (decode admission)
STEP = "step"                # one batched decode step crossing
ADMIT_WAIT = "admit_wait"    # a stream's submit→admission wait
PLACE = "place"              # a crossing's argument cast + copy to the device
DRAIN = "drain"              # the wait for a unit's end event (traced, CUDA)
FETCH = "fetch"              # a crossing's results copied to host memory
EMIT = "emit"                # a scheduler phase's host work after its call
BATCH = "batch"              # one batch on a MixedServer worker
SSD = "ssd"                  # one SSD scan launch inside a unit (ssd_scan op)
AOT = "aot"                  # AOT plan-cache save/load
FRAME = "frame"              # a cluster channel frame (send side)
SUBMIT = "submit"            # a routed submission (parent + worker sides)
RESULT = "result"            # a finished stream's result frame (worker side)

SPAN_KINDS = (
    CROSSING, UNIT, EMULATOR, REENTRY, CALL, COMPILE, PREFILL, STEP,
    ADMIT_WAIT, AOT, FRAME, SUBMIT, RESULT, PLACE, DRAIN, FETCH, EMIT, BATCH, SSD,
)

#: the Chrome export's thread id of the device track (one per process)
DEVICE_TID = 0


@dataclass
class Span:
    """One timeline record.  ``dur_ns is None`` marks an instant event."""

    name: str
    kind: str
    start_ns: int
    dur_ns: int | None
    pid: int
    tid: int
    trace_id: str | None = None
    args: dict | None = None


@dataclass
class LogEvent:
    """A structured log record (the tracer-carried side of :func:`warn`)."""

    level: str
    message: str
    t_ns: int
    pid: int
    origin: str | None = None
    fields: dict | None = None


def _new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class Tracer:
    """Bounded flight recorder for one process.

    ``spans_enabled=False`` turns the tracer into a pure log/histogram
    collector: :func:`active` then returns ``None`` so span producers take
    the zero-cost path, while :func:`warn` still records structured logs
    (cluster workers run in this mode unless the parent traces).
    """

    DEFAULT_CAPACITY = 65536
    LOG_CAPACITY = 4096

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 trace_id: str | None = None, label: str | None = None,
                 spans_enabled: bool = True):
        self.capacity = int(capacity)
        self.trace_id = trace_id or _new_trace_id()
        self.label = label or "main"
        self.spans_enabled = bool(spans_enabled)
        self.spans_dropped = 0
        self.logs_dropped = 0
        #: latency distribution per (span name, span kind); never drops.
        self.hist = HistogramSet()
        #: pid -> human label, for multi-process Chrome export.
        self.process_labels: dict[int, str] = {os.getpid(): self.label}
        self._spans: deque[Span] = deque()
        self._logs: deque[LogEvent] = deque()
        self._lock = threading.Lock()
        #: device index -> (perf_counter_ns, CUDA event recorded then)
        self._anchors: dict[int, tuple] = {}
        self._anchor_lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    @staticmethod
    def now() -> int:
        return time.perf_counter_ns()

    def add(self, name: str, kind: str, start_ns: int, dur_ns: int, *,
            trace_id: str | None = None, args: dict | None = None) -> None:
        """Record a completed span (and fold it into the histograms)."""
        if not self.spans_enabled:
            return
        span = Span(name=name, kind=kind, start_ns=int(start_ns),
                    dur_ns=int(dur_ns), pid=os.getpid(),
                    tid=threading.get_ident(),
                    trace_id=trace_id or context_trace_id() or self.trace_id,
                    args=args)
        with self._lock:
            self.hist.record((name, kind), span.dur_ns)
            if len(self._spans) >= self.capacity:
                self._spans.popleft()
                self.spans_dropped += 1
            self._spans.append(span)

    def event(self, name: str, kind: str, *, trace_id: str | None = None,
              args: dict | None = None) -> None:
        """Record an instant event (no duration, no histogram entry)."""
        if not self.spans_enabled:
            return
        span = Span(name=name, kind=kind, start_ns=self.now(), dur_ns=None,
                    pid=os.getpid(), tid=threading.get_ident(),
                    trace_id=trace_id or context_trace_id() or self.trace_id,
                    args=args)
        with self._lock:
            if len(self._spans) >= self.capacity:
                self._spans.popleft()
                self.spans_dropped += 1
            self._spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str, kind: str, *, trace_id: str | None = None,
             args: dict | None = None):
        t0 = self.now()
        try:
            yield
        finally:
            self.add(name, kind, t0, self.now() - t0,
                     trace_id=trace_id, args=args)

    def device_anchor(self, device) -> tuple:
        """``(perf_counter_ns, event)`` for CUDA ``device``: a CUDA event
        recorded on its current stream at that host moment, which places
        any later event of the device on the host clock.  Taken once, when
        the tracer first sees the device: synchronise, read the clock,
        record the event."""
        import torch

        index = device.index if device.index is not None else torch.cuda.current_device()
        with self._anchor_lock:
            anchor = self._anchors.get(index)
            if anchor is None:
                torch.cuda.synchronize(index)
                event = torch.cuda.Event(enable_timing=True)
                anchor = (self.now(), event)
                event.record(torch.cuda.current_stream(index))
                self._anchors[index] = anchor
        return anchor

    def log(self, level: str, message: str, *, origin: str | None = None,
            fields: dict | None = None) -> None:
        """Record a structured log event (works even with spans disabled)."""
        ev = LogEvent(level=level, message=message, t_ns=self.now(),
                      pid=os.getpid(), origin=origin, fields=fields)
        with self._lock:
            if len(self._logs) >= self.LOG_CAPACITY:
                self._logs.popleft()
                self.logs_dropped += 1
            self._logs.append(ev)

    # -- harvest / fold ----------------------------------------------------

    def drain(self) -> tuple[list[Span], list[LogEvent]]:
        """Take (and clear) buffered spans and logs; drop counters persist."""
        with self._lock:
            spans, logs = list(self._spans), list(self._logs)
            self._spans.clear()
            self._logs.clear()
        return spans, logs

    def extend(self, spans: list[Span], logs: list[LogEvent] = (), *,
               labels: dict[int, str] | None = None) -> None:
        """Fold foreign records (e.g. a worker's drain) into this ring."""
        with self._lock:
            for span in spans:
                if len(self._spans) >= self.capacity:
                    self._spans.popleft()
                    self.spans_dropped += 1
                self._spans.append(span)
            for ev in logs:
                if len(self._logs) >= self.LOG_CAPACITY:
                    self._logs.popleft()
                    self.logs_dropped += 1
                self._logs.append(ev)
            if labels:
                self.process_labels.update(labels)

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def logs(self) -> list[LogEvent]:
        with self._lock:
            return list(self._logs)

    def counts_by_kind(self) -> dict[str, int]:
        with self._lock:
            return dict(Counter(s.kind for s in self._spans))

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # -- export ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The trace as a Chrome trace-event / Perfetto-compatible dict."""
        spans = self.snapshot()
        events = []
        for pid in sorted({s.pid for s in spans} | set(self.process_labels)):
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": self.process_labels.get(pid, f"pid{pid}")},
            })
        device_pids = set()
        for s in spans:
            args = dict(s.args or {})
            if s.trace_id:
                args["trace_id"] = s.trace_id
            ev = {
                "name": s.name, "cat": s.kind, "pid": s.pid, "tid": s.tid,
                "ts": s.start_ns / 1000.0, "args": args,
            }
            if s.dur_ns is None:
                ev.update(ph="i", s="t")
            else:
                ev.update(ph="X", dur=s.dur_ns / 1000.0)
            events.append(ev)
            if "device_start_ns" in args:
                # the unit's kernels, on the device's own track
                device_pids.add(s.pid)
                events.append({
                    "name": s.name, "cat": s.kind, "ph": "X", "pid": s.pid,
                    "tid": DEVICE_TID, "ts": args["device_start_ns"] / 1000.0,
                    "dur": args["device_ms"] * 1000.0, "args": args,
                })
        for pid in sorted(device_pids):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": DEVICE_TID, "args": {"name": "device"}})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "trace_id": self.trace_id,
                "spans_dropped": self.spans_dropped,
            },
        }

    def export_chrome_trace(self, path) -> dict:
        """Write the Chrome trace JSON to ``path``; returns the payload."""
        payload = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(payload, f)
        return payload


class DeviceInterval:
    """One unit's device-clock span, placed on the host clock (tracing on
    CUDA only).

    CUDA events are recorded on ``device``'s current stream before the
    unit's first launch (construction) and after its last (:meth:`stop`);
    :meth:`wait` blocks until the end event has run, and :meth:`args` then
    reads the span between them and places its start on
    ``perf_counter_ns`` through the tracer's anchor for the device, which
    was recorded before the start event.  The span holds whatever else
    ran on the stream between the events (see ``device_ms`` above)."""

    __slots__ = ("anchor_ns", "anchor", "stream", "start", "end")

    def __init__(self, tracer: Tracer, device):
        import torch

        self.anchor_ns, self.anchor = tracer.device_anchor(device)
        self.stream = torch.cuda.current_stream(device)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)

    def stop(self) -> None:
        self.end.record(self.stream)

    def wait(self) -> None:
        self.end.synchronize()

    def args(self) -> dict:
        return {
            "device_ms": self.start.elapsed_time(self.end),
            "device_start_ns": self.anchor_ns + round(
                self.anchor.elapsed_time(self.start) * 1e6),
        }


# --------------------------------------------------------------------------
# Process-global installation

_STATE = threading.local()
_GLOBAL: Tracer | None = None
_GLOBAL_LOCK = threading.Lock()
_SUBMIT_SEQ = itertools.count()


def context_trace_id() -> str | None:
    """The calling thread's trace context (see :func:`trace_context`)."""
    return getattr(_STATE, "trace_id", None)


@contextlib.contextmanager
def trace_context(trace_id: str | None):
    """Default ``trace_id`` of every span this thread records in the body
    (a span given its own id keeps it); the previous context comes back
    after.  A ``MixedServer`` worker runs each batch under the batch's id."""
    prev = context_trace_id()
    _STATE.trace_id = trace_id
    try:
        yield
    finally:
        _STATE.trace_id = prev


def install(tracer: Tracer | None) -> Tracer | None:
    """Install ``tracer`` as the process tracer; returns the previous one."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, tracer
    return prev


def current() -> Tracer | None:
    """The installed tracer, if any — even one with spans disabled."""
    return _GLOBAL


def active() -> Tracer | None:
    """The installed tracer iff span recording is on, else ``None``.

    This is THE hot-path gate: producers call it once per boundary and a
    ``None`` result short-circuits every record.
    """
    t = _GLOBAL
    return t if t is not None and t.spans_enabled else None


@contextlib.contextmanager
def session(tracer: Tracer | None = None, **kw):
    """Install a tracer for the ``with`` body; restores the previous one.

        with obs.session() as tracer:
            hybrid(x)
        tracer.export_chrome_trace("trace.json")
    """
    if tracer is None:      # explicit None test: an *empty* tracer is falsy
        tracer = Tracer(**kw)
    prev = install(tracer)
    try:
        yield tracer
    finally:
        install(prev)


@contextlib.contextmanager
def maybe_span(name: str, kind: str, **args):
    """A span on the active tracer, or a no-op when tracing is off."""
    t = active()
    if t is None:
        yield
        return
    t0 = t.now()
    try:
        yield
    finally:
        t.add(name, kind, t0, t.now() - t0, args=args or None)


def traced(name: str, kind: str):
    """Decorator form of :func:`maybe_span` (zero-cost when tracing is off)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t = active()
            if t is None:
                return fn(*a, **kw)
            t0 = t.now()
            try:
                return fn(*a, **kw)
            finally:
                t.add(name, kind, t0, t.now() - t0)
        return wrapper
    return deco


def next_submission_id(root: str) -> str:
    """A fresh per-submission child trace id under ``root``."""
    return f"{root}/{next(_SUBMIT_SEQ)}"


def warn(message: str, category: type[Warning] = UserWarning, *,
         stacklevel: int = 2, origin: str | None = None,
         fields: dict | None = None) -> None:
    """Structured warning: a tracer-carried LogEvent + ``warnings.warn``.

    The tracer copy is what crosses the cluster channel (spawned workers'
    Python warnings are otherwise lost); the :mod:`warnings` copy keeps
    the in-process contract (filters, ``pytest.warns``) intact.
    """
    t = current()
    if t is not None:
        t.log("warning", message, origin=origin, fields=fields)
    _warnings.warn(message, category, stacklevel=stacklevel + 1)


def log_event(level: str, message: str, *, origin: str | None = None,
              fields: dict | None = None) -> None:
    """Record a structured log on the installed tracer (no-op without one)."""
    t = current()
    if t is not None:
        t.log(level, message, origin=origin, fields=fields)
