"""Serving over one PlannedProgram (the port): request-level batching and
token-level continuous batching.

:class:`MixedServer` is the request-level front door: many callers submit
small requests; the server buckets them by padded shape
(:class:`~repro_torch.serve.BucketLadder`), coalesces each bucket into
**one** batched entry call — one signature plan, one set of crossings for
the whole batch — and splits the results back per caller, bit-identically
to running each request alone.  A cold bucket is served on the emulator
path (the planned scheme without units) while a background thread makes
its first compiled-path call.

    server = MixedServer(mixed.trace(prog).plan("tech-gfp"),
                         ladder=BucketLadder(batch_sizes=(1, 2, 4, 8)))
    with server:
        logits, aux = server.request(tokens)
        print(server.report())               # crossings/request, occupancy, ...

A decode loop pays the paper's fixed guest→host crossing cost once per
**token**: every step is a tiny entry call.  :class:`DecodeScheduler` treats
the decode loop itself as the persistent iteration and re-forms the batch
every step, so all live streams share one crossing-set per token position;
with a paged :class:`~repro_torch.serve.StateSpec` and ``paged_step=...``
each step goes through the block-sparse paged-attention CUDA kernel.

    planned = mixed.trace(export_attn_decode_lm()).plan("tech-gfp")
    with DecodeScheduler(planned, step="decode_step",
                         paged_step="paged_decode_step", capacity=8,
                         state=StateSpec(growing={0: 1, 1: 1},
                                         max_context=32, page_size=4)) as s:
        tokens = s.decode(prompt, max_new_tokens=16)

:class:`MultiModelDecodeScheduler` co-serves several decode models (for
example the mamba2 SSM and the attention LM) from one loop over one shared
page pool, one batched crossing per model per iteration.

The offload units run on CUDA unless ``backend="cpu"`` is passed (the
tests do).  The page pools stay numpy on the host and cross at every step,
as in the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from .. import obs
from ..core.api import CompiledHybrid, PlannedProgram
from ..core.convert import Resident, aval_of, signature_of
from ..core.opset import AVal, canonical_dtype, torch_dtype
from ..core.offload import Scheme
from .batcher import (
    Batch,
    BucketLadder,
    PagedKVState,
    PagePool,
    Request,
    SlotMap,
    StateSpec,
    coalesce,
    group_key,
    pad_request,
    pad_rows,
)
from .reports import (
    DecodeReport,
    DecodeStats,
    MultiModelReport,
    ServerReport,
    ServerStats,
)


@dataclasses.dataclass
class _Pending:
    request: Request
    future: Future
    submitted: float
    id: str | int            # a submission trace id when traced, else a count


_CLOSE = object()
_FLUSH = object()
_WAKE = object()


def _resolve(fut: Future, *, result=None, exception=None) -> None:
    """Deliver a batch outcome, tolerating callers who cancelled meanwhile.

    A cancelled batch-mate must never prevent the other requests in the
    batch from resolving (``set_result`` on a cancelled Future raises), and
    error paths may legitimately re-visit futures that already resolved.
    """
    if fut.done():
        return
    try:
        if not fut.set_running_or_notify_cancel():
            return                           # caller cancelled while queued
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
    except (InvalidStateError, RuntimeError):
        # resolved concurrently; set_running_or_notify_cancel raises a plain
        # RuntimeError (not InvalidStateError) on a non-pending future
        pass


class MixedServer:
    """Serve many concurrent callers from one planned hybrid program.

    Parameters
    ----------
    planned:
        A :class:`PlannedProgram` (compiled here, honouring ``backend``) or
        an already-compiled :class:`CompiledHybrid` to serve.
    ladder:
        Shape-bucketing policy (:class:`BucketLadder`).  The default pads
        request batches to {1, 2, 4, 8} rows and leaves sequences alone.
    max_batch_delay:
        Seconds a request may wait for batch-mates before its bucket is
        flushed anyway (the classic batching latency/throughput knob).
    workers:
        Batch-execution threads.  More workers let a slow emulator-path
        batch overlap with warm compiled batches.  On CUDA they share the
        device's current stream, as every unit of the port does.
    backend:
        Forwarded to ``planned.compile(backend=...)``: ``None`` runs the
        units on CUDA, ``"cpu"`` on the CPU (ignored when an
        already-compiled hybrid is passed).
    max_pending:
        Backpressure bound on outstanding requests (queued or executing).
        ``submit()`` blocks once the server is this far behind; capacity is
        released as each request's future resolves.
    """

    def __init__(
        self,
        planned: PlannedProgram | CompiledHybrid,
        *,
        ladder: BucketLadder | None = None,
        max_batch_delay: float = 0.005,
        workers: int = 2,
        backend: str | None = None,
        max_pending: int = 4096,
    ):
        if isinstance(planned, CompiledHybrid):
            self.hybrid = planned
            self.planned = planned.planned
        else:
            self.planned = planned
            self.hybrid = planned.compile(backend=backend)
        self.ladder = ladder or BucketLadder()
        self.max_batch_delay = float(max_batch_delay)
        # The fallback runtime: same traced program, offloading scheme with
        # GRT but *no units* (unit_filter rejects everything), i.e. pure
        # interpretation on the guest — universal, needs no per-signature
        # preparation.  It is compiled for the hybrid's device, where it
        # places nothing.
        self._fallback = self.planned.traced.plan(
            Scheme.base().with_grt(),
            costmodel=self.planned.costmodel,
            mesh=self.planned.mesh,
            arg_specs=self.planned.arg_specs,
            compute_dtype=self.planned.compute_dtype,
            unit_filter=lambda f: False,
        ).compile(backend=str(self.hybrid.device))
        self._entry_arity = len(
            self.planned.analysis.program.functions[
                self.planned.analysis.program.entry
            ].args
        )

        self._stats = ServerStats()
        self._ids = itertools.count()
        # the semaphore, not the queue, bounds outstanding work — the
        # dispatcher drains the queue into _pending immediately, so a queue
        # maxsize would never engage as backpressure
        self._capacity = threading.BoundedSemaphore(max_pending)
        self._queue: queue.Queue = queue.Queue()
        self._pending: dict[tuple, list[_Pending]] = {}
        self._warm_lock = threading.Lock()
        self._warm: set[tuple] = set()
        self._warming: set[tuple] = set()
        self._closed = False
        self._submit_lock = threading.Lock()   # makes submit() atomic vs close()
        self._pool = ThreadPoolExecutor(workers, thread_name_prefix="mixed-serve")
        self._warm_pool = ThreadPoolExecutor(1, thread_name_prefix="mixed-warm")
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="mixed-serve-dispatch", daemon=True
        )
        self._dispatcher.start()

    # -- client surface -----------------------------------------------------

    def submit(self, *args) -> Future:
        """Enqueue one request; resolves to the entry call's output tuple.

        Each argument must carry the request's rows on axis 0 (typically a
        single row).  Requests with compatible padded signatures coalesce
        into one batched entry call.
        """
        if len(args) != self._entry_arity:
            entry = self.planned.analysis.program.entry
            raise TypeError(
                f"{entry}: expected {self._entry_arity} args, got {len(args)}"
            )
        req = Request.of(args, self.ladder.seq_axis)
        fut: Future = Future()
        tr = obs.active()
        rid = next(self._ids) if tr is None else obs.next_submission_id(tr.trace_id)
        # blocking backpressure, taken OUTSIDE the submit lock so stalled
        # submitters never hold it against flush()/close()
        self._capacity.acquire()
        with self._submit_lock:
            if self._closed:
                self._capacity.release()
                raise RuntimeError("MixedServer is closed")
            fut.add_done_callback(lambda _: self._capacity.release())
            self._queue.put(_Pending(req, fut, time.perf_counter(), rid))
        return fut

    def request(self, *args, timeout: float | None = None):
        """Blocking convenience: ``submit(*args).result(timeout)``."""
        return self.submit(*args).result(timeout)

    def flush(self) -> None:
        """Force all queued requests to dispatch without waiting the delay."""
        with self._submit_lock:
            if not self._closed:
                self._queue.put(_FLUSH)

    def warm(self, *args) -> int:
        """Pre-compile every ladder bucket that could serve ``args``.

        Runs one dummy batched call per bucket on the compiled path, so
        later traffic of this shape never touches the emulator fallback.
        Returns the number of buckets warmed; buckets already warm — or
        currently warming in the background — are skipped, so one bucket
        is only ever compiled (and counted) once.
        """
        req = Request.of(args, self.ladder.seq_axis)
        padded = pad_request(req, self.ladder)
        warmed = 0
        for b in self.ladder.batch_sizes:
            if b < req.rows:
                continue
            args_b = tuple(pad_rows(p, b) for p in padded)
            sig = signature_of(args_b)
            with self._warm_lock:
                if sig in self._warm or sig in self._warming:
                    continue
                self._warming.add(sig)
            if self._attempt_warm(sig, args_b, reraise=True):
                warmed += 1
        return warmed

    def _attempt_warm(self, sig: tuple, args: tuple, *, reraise: bool) -> bool:
        """Run one compiled-path call for ``sig`` (caller holds the _warming
        claim) and keep the warm/warming bookkeeping in exactly one place.
        Failure leaves the bucket cold so a later batch re-triggers a warm."""
        try:
            _, report = self.hybrid.call_reported(*args)
        except Exception:  # noqa: BLE001 — background warms must not raise
            with self._warm_lock:
                self._warming.discard(sig)
            self._stats.record_warm_failure()
            if reraise:
                raise
            return False
        with self._warm_lock:
            self._warm.add(sig)
            self._warming.discard(sig)
        self._stats.record_warm(report)
        return True

    def report(self) -> ServerReport:
        """Snapshot of the serving counters (see :class:`ServerReport`)."""
        return self._stats.snapshot()

    def close(self) -> None:
        """Stop accepting, flush and finish all queued work, join workers.

        Every caller joins the dispatcher and worker pools — concurrent
        closers all block until the server is drained, so "close()
        returned" always implies "drained" (an early return on ``_closed``
        would let a second closer race ahead of the first one's join)."""
        with self._submit_lock:
            if not self._closed:
                self._closed = True
                # under the same lock as submit(): once the sentinel is
                # queued, no request can land behind it and be stranded
                self._queue.put(_CLOSE)
        self._dispatcher.join()
        self._pool.shutdown(wait=True)
        self._warm_pool.shutdown(wait=True)

    def __enter__(self) -> "MixedServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatcher ---------------------------------------------------------

    def _dispatch_loop(self) -> None:
        closing = False
        while True:
            try:
                timeout = self._next_deadline() if self._pending else None
                try:
                    item = self._queue.get(timeout=timeout)
                except queue.Empty:
                    item = None
                if item is _CLOSE:
                    closing = True
                    # drain whatever raced in before the sentinel
                    while True:
                        try:
                            extra = self._queue.get_nowait()
                        except queue.Empty:
                            break
                        if isinstance(extra, _Pending):
                            self._enqueue(extra)
                elif item is _FLUSH or item is None:
                    pass
                else:
                    self._enqueue(item)
                self._flush_due(force=closing or item is _FLUSH)
            except Exception as e:  # noqa: BLE001 — the dispatcher must outlive
                # any one poisoned request: fail whatever was pending and
                # keep serving (stranded futures would hang clients forever)
                for items in self._pending.values():
                    for i in items:
                        _resolve(i.future, exception=e)
                self._pending.clear()
            if closing:
                return

    def _enqueue(self, item: _Pending) -> None:
        key = group_key(item.request, self.ladder)
        self._pending.setdefault(key, []).append(item)

    def _next_deadline(self) -> float:
        oldest = min(
            item.submitted for items in self._pending.values() for item in items
        )
        return max(0.0, oldest + self.max_batch_delay - time.perf_counter())

    def _flush_due(self, force: bool) -> None:
        now = time.perf_counter()
        max_rows = self.ladder.max_batch
        for key in list(self._pending):
            items = self._pending[key]
            while items:
                rows = sum(i.request.rows for i in items)
                if rows >= max_rows:
                    # cut a full bucket off the front; leftovers keep waiting
                    take, acc = [], 0
                    for i in items:
                        if take and acc + i.request.rows > max_rows:
                            break
                        take.append(i)
                        acc += i.request.rows
                    items = items[len(take):]
                    self._pending[key] = items
                    self._submit_batch(take)
                    continue
                if force or (now - items[0].submitted >= self.max_batch_delay):
                    self._pending[key] = []
                    self._submit_batch(items)
                    items = []
                break
            if not self._pending.get(key):
                self._pending.pop(key, None)

    def _submit_batch(self, items: list[_Pending]) -> None:
        batch = coalesce([i.request for i in items], self.ladder)
        self._pool.submit(self._run_batch, batch, items, time.perf_counter())

    # -- batch execution (worker threads) -----------------------------------

    def _run_batch(self, batch: Batch, items: list[_Pending], cut: float) -> None:
        """Run one batch the dispatcher cut at ``cut`` (perf_counter s).
        Traced, the batch gets a ``batch`` span under an id of its own,
        which every span the batch's call records on this thread carries;
        its args hold its requests' ids and waits (``batch_wait_ms``:
        each one's submit to the cut; ``pool_wait_ms``: the cut to this
        worker's start).  The span is recorded before the futures
        resolve: a woken caller may read it."""
        started = time.perf_counter()
        tr = obs.active()
        if tr is None:
            _, outcome = self._serve_batch(batch, items, cut, started)
        else:
            batch_id = obs.next_submission_id(tr.trace_id)
            with obs.trace_context(batch_id):
                padded, outcome = self._serve_batch(batch, items, cut, started)
            chunked = batch.padded_rows > self.ladder.max_batch
            tr.add("batch", obs.BATCH, int(started * 1e9),
                   tr.now() - int(started * 1e9), trace_id=batch_id,
                   args={"requests": [str(i.id) for i in items],
                         "rows": batch.rows, "padded_rows": padded,
                         "bucket": self.ladder.max_batch if chunked
                         else batch.padded_rows,
                         "batch_wait_ms": [1e3 * (cut - i.submitted) for i in items],
                         "pool_wait_ms": 1e3 * (started - cut)})
        if isinstance(outcome, Exception):
            # every caller gets the failure; a stranded future would hang
            # its client forever
            for i in items:
                _resolve(i.future, exception=outcome)
        else:
            for i, result in zip(items, outcome):
                _resolve(i.future, result=result)

    def _serve_batch(self, batch: Batch, items: list[_Pending], cut: float,
                     started: float) -> tuple[int, list | Exception]:
        """Run and count one batch: ``(rows run, padded; the requests'
        results, or the exception that failed them)``."""
        padded = batch.padded_rows
        try:
            waits = [started - i.submitted for i in items]
            if batch.padded_rows > self.ladder.max_batch:
                outs, reports, fallbacks, calls, padded = self._run_chunked(batch)
            else:
                outs, report, fallback = self._run_sized(batch.args)
                reports, fallbacks = [report], int(fallback)
                calls = 1
            self._stats.record_batch(
                n_requests=len(items),
                rows=batch.rows,
                padded_rows=padded,
                waits=waits,
                reports=reports,
                fallback_calls=fallbacks,
                calls=calls,
                splits=calls - 1,
                pool_wait=(started - cut) * len(items),
            )
            return padded, list(batch.split(outs))
        except Exception as e:  # noqa: BLE001 — delivered to every caller
            return padded, e

    def _run_sized(self, args: tuple) -> tuple[tuple, Any, bool]:
        """One entry call at a ladder-shaped signature: route to the compiled
        path when the bucket is warm, else serve on the emulator fallback and
        kick off a background warm.  Returns ``(outs, report, fallback)``."""
        sig = signature_of(args)
        with self._warm_lock:
            warm = sig in self._warm
            if not warm and sig not in self._warming:
                self._warming.add(sig)
                self._warm_pool.submit(self._warm_signature, sig)
        runner = self.hybrid if warm else self._fallback
        outs, report = runner.call_reported(*args)
        return outs, report, not warm

    def _run_chunked(self, batch: Batch):
        """Serve a batch above the top bucket as top-bucket chunks.

        Without this, an adversarial batch size would run at its natural
        row count — a brand-new entry signature (and unit "compile") per size,
        unbounded by the ladder.  Chunking is bit-exact under the same
        contract as pad/coalesce/split: every op treats axis-0 rows
        independently, so a row's result doesn't depend on which chunk
        carried it.  Chunks are padded to ladder buckets, so they reuse the
        ladder's warm signatures.
        """
        mb = self.ladder.max_batch
        pieces, reports = [], []
        fallbacks = calls = padded = 0
        for start in range(0, batch.rows, mb):
            rows = min(mb, batch.rows - start)
            bucket = self.ladder.batch_bucket(rows)
            args = tuple(pad_rows(a[start:start + rows], bucket)
                         for a in batch.args)
            outs, report, fallback = self._run_sized(args)
            # trim chunk padding now; non-row (0-d) outputs pass through
            # (identical per chunk for batch-parallel programs)
            pieces.append(tuple(np.asarray(o)[:rows] if np.ndim(o) else o
                                for o in outs))
            reports.append(report)
            fallbacks += int(fallback)
            calls += 1
            padded += bucket
        outs = tuple(
            np.concatenate([p[j] for p in pieces], axis=0)
            if np.ndim(pieces[0][j]) else pieces[0][j]
            for j in range(len(pieces[0]))
        )
        return outs, reports, fallbacks, calls, padded

    def _warm_signature(self, sig: tuple) -> None:
        """Background bucket compilation: one dummy call on the compiled path.

        Runs on the dedicated warm thread so in-flight requests keep flowing
        through the emulator fallback instead of blocking on the first-
        signature unit calls.  A failed
        warm leaves the bucket on the fallback path (the next batch of this
        shape re-triggers a warm attempt) rather than routing traffic onto a
        compiled path known to be broken.
        """
        dummy = tuple(np.zeros(a.shape, a.dtype) for a in sig)
        self._attempt_warm(sig, dummy, reraise=False)


# ---------------------------------------------------------------------------
# token-level continuous batching
# ---------------------------------------------------------------------------


def greedy_sample(logits_row: np.ndarray) -> int:
    """Default token sampler: deterministic argmax over the logits row."""
    return int(np.argmax(np.asarray(logits_row)))


class DecodeStream:
    """Handle for one submitted decode request (returned by
    :meth:`DecodeScheduler.submit`).

    ``future`` resolves to the generated tokens as a 1-D int32 array of
    length ≤ ``max_new_tokens`` (shorter only if ``eos`` was sampled); use
    :meth:`result` / :meth:`done` as conveniences.  After admission the
    scheduler fills the scheduling facts — ``slot`` (the physical batch row
    the stream occupied), ``admitted_step`` (the first step index it joined)
    and, at retirement, ``retired_step`` (the step that produced its last
    token; ``admitted_step - 1`` for streams that finished at their prefill
    and never stepped).  They are written by the decode loop before the
    future resolves, so reading them after ``result()`` returns is race-free.
    """

    def __init__(self, prompt: np.ndarray, max_new_tokens: int, eos: int | None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos = eos
        self.future: Future = Future()
        self.submitted = time.perf_counter()
        self.slot: int | None = None
        self.admitted_step: int | None = None
        self.retired_step: int | None = None
        self._generated: list[int] = []

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block for the stream's generated tokens (1-D int32)."""
        return self.future.result(timeout)

    def done(self) -> bool:
        return self.future.done()


@dataclasses.dataclass
class _PendingStream:
    stream: DecodeStream

    @property
    def sig(self) -> tuple:
        p = self.stream.prompt
        return (p.shape, str(p.dtype))


class DecodeScheduler:
    """Continuous (in-flight) batching for autoregressive decode loops.

    Where :class:`MixedServer` amortizes the paper's fixed guest→host
    crossing cost across *requests*, a decode loop pays that cost once per
    **token**: every step is a tiny entry call, and serving N streams
    request-style costs N crossing-sets per token position.  This scheduler
    treats the decode loop itself as the persistent iteration and re-forms
    the batch **every step**:

    * new streams join mid-flight at their prefill boundary — admissions
      are grouped into one batched prefill entry call per prompt shape;
    * each step issues exactly ONE batched entry crossing for all live
      streams (the per-token unit is planned once and re-entered);
    * finished streams retire immediately — their slot is handed to the
      next admission, never padded along until the slowest stream ends.

    **Program contract.**  ``planned`` is a decode-loop program planned at
    its prefill entry: ``prefill(prompts) -> (logits, *state)`` with
    ``prompts`` carrying one prompt per row.  ``step`` names a function of
    the same program with ``step(*state, tokens) -> (logits, *state)``,
    where every array carries streams on axis 0 and every op is
    row-independent (batch-parallel).  The step plan is derived via
    :meth:`~repro_torch.core.api.PlannedProgram.for_entry`, so prefill and step
    share one offload-unit cache (functions reachable from both — e.g. the
    LM head — compile once).

    **State contract.**  By default every state array is a fixed-size row
    per stream (the recurrent-LM shape).  A :class:`~repro_torch.serve.StateSpec`
    with ``growing`` entries generalizes this to **paged KV-cache state**:
    the marked arrays carry one row per *context position* (padded in the
    program to the spec's fixed ``max_context``, so the step signature
    never changes), and the scheduler keeps each stream's filled prefix in
    fixed-size pages (:class:`~repro_torch.serve.PagePool` +
    :class:`~repro_torch.serve.BlockTable`) — admitted at the prefill boundary,
    grown by one position per step, recycled the instant the stream
    retires.  Admission is conservatively gated on worst-case page demand
    (``ceil((prompt_len + max_new_tokens - 1) / page_size)``), so a stream
    that was admitted can always grow to its end.  Bit-exactness is
    unchanged: gathers rebuild the padded state over a zero template,
    reproducing exactly the array a solo loop would have threaded (see
    :class:`~repro_torch.serve.batcher.PagedKVState`).

    **Prefix sharing** (``StateSpec(share_prefixes=True)`` +
    ``prefill_suffix=...``): a newly admitted stream whose prompt shares a
    page-aligned prefix with a live or recently-retired stream *of the same
    prompt length* maps those full pages read-only (copy-on-write protects
    them from any later write) instead of re-storing them, and its
    admission rides the suffix-capable prefill root — same arg structure as
    ``step`` but with a ``(B, T)`` token batch: growing state inputs carry
    the cached prefix rows, the non-growing length vector carries each
    row's cached length.  Because the suffix root recomputes through the
    *same offload units* as the plain prefill and merges with a pure
    ``where`` select, a prefix-shared stream's tokens stay bit-identical to
    :func:`decode_reference`.  What sharing buys is pages:
    ``pages_in_use``/``pages_peak`` drop under many-streams-same-system-
    prompt traffic (``prefix_hits``, ``prefix_tokens_reused``,
    ``pages_shared``, ``state_bytes_saved`` in the report).  Admission
    gating stays conservative (full worst case per stream), so sharing
    never turns an admissible load into an overflow.

    **Paged-kernel stepping** (``paged_step=...``, requires a paged
    ``StateSpec``): the named root replaces the dense step with the
    block-sparse paged-attention path — ``paged_step(*pool buffers,
    tables, lengths, tokens) -> (logits, *fresh rows)``.  Each step's
    crossing receives the page-pool backing buffers and a dense block-table
    array *directly* (the gather/append re-materialization of dense K/V
    disappears entirely), the kernel inside visits only live pages
    (``pages_visited``/``pages_skipped``/``kernel_steps`` in the report),
    and the returned per-stream k/v rows are appended into pages.  The
    pools live on the step's device when its plan lets them cross by
    reference (every use of them in the root is an operand of an offload
    unit's call, :meth:`~repro_torch.core.offload.OffloadPlan.units_only_read`):
    the crossing then passes them to the unit as
    :class:`~repro_torch.core.convert.Resident` values and places only the
    table, the lengths and the tokens.  Otherwise (an emulated root, a
    mesh) they stay numpy and are placed every step.  Tokens stay bit-identical to
    :func:`paged_decode_reference` — same kernel, same fixed shapes, and
    the page walk is physical-page-id invariant — and match
    :func:`decode_reference` on the workloads the smoke gates pin down.

    **Bit-exactness.**  Every prefill and step call is padded to the fixed
    ``capacity`` rows (see :class:`~repro_torch.serve.batcher.SlotMap`): at one
    fixed shape, each row of a batch-parallel program is a pure function of
    that row's inputs, so a stream's tokens are bit-identical to decoding
    it alone (:func:`decode_reference`) no matter when it was admitted or
    who its batch-mates were.  This is deliberately stronger than reusing
    the request-level bucket ladder, whose varying shapes are only
    bitwise-stable for kernels that happen to reduce identically per shape.

    **Threading.**  ``submit``/``report``/``warm``/``close`` may be called
    from any thread; one daemon decode-loop thread owns the slot map and
    state buffers.  The compiled hybrids underneath are the thread-safe
    substrate from :mod:`repro_torch.core.api`.

        planned = mixed.trace(export_attn_decode_lm()).plan("tech-gfp")
        spec = StateSpec(growing={0: 1, 1: 1}, max_context=32, page_size=4)
        with DecodeScheduler(planned, step="decode_step", capacity=8,
                             paged_step="paged_decode_step", state=spec) as sched:
            streams = [sched.submit(prompt, max_new_tokens=16)
                       for prompt in prompts]
            tokens = [s.result() for s in streams]
            print(sched.report())            # tokens/crossing, occupancy, ...
    """

    def __init__(
        self,
        planned: PlannedProgram,
        *,
        step: str,
        capacity: int = 8,
        sample: Callable[[np.ndarray], int] | None = None,
        eos: int | None = None,
        admit_delay: float = 0.0,
        max_pending: int = 4096,
        backend: str | None = None,
        start: bool = True,
        state: StateSpec | None = None,
        prefill_suffix: str | None = None,
        paged_step: str | None = None,
        page_pool: PagePool | None = None,
        page_quota: int | None = None,
        tracer: "obs.Tracer | None" = None,
    ):
        # explicit tracer wins; otherwise each phase consults the process
        # tracer (obs.active()) at call time, so installing one later works
        self._tracer = tracer
        self.planned = planned
        self.step_planned = planned.for_entry(step)
        self.prefill = planned.compile(backend=backend)
        self.step = self.step_planned.compile(backend=backend)
        program = planned.analysis.program
        entry_args = program.functions[program.entry].args
        if len(entry_args) != 1:
            raise ValueError(
                f"prefill entry {program.entry!r} must take exactly one "
                f"argument (the prompt batch), got {len(entry_args)}"
            )
        n_returns = len(program.functions[program.entry].returns)
        if n_returns < 2:
            raise ValueError(
                f"prefill entry {program.entry!r} must return (logits, "
                f"*state), got {n_returns} return(s)"
            )
        self._n_state = n_returns - 1
        step_fn = self.step_planned.analysis.program.functions[step]
        if len(step_fn.args) != self._n_state + 1:
            raise ValueError(
                f"step {step!r} must take ({self._n_state} state arrays + "
                f"tokens), got {len(step_fn.args)} args"
            )
        if len(step_fn.returns) != n_returns:
            raise ValueError(
                f"step {step!r} must return (logits, *state) like the "
                f"prefill entry, got {len(step_fn.returns)} return(s)"
            )
        self.capacity = int(capacity)
        self.state_spec = state or StateSpec()
        for idx in self.state_spec.growing:
            if idx >= self._n_state:
                raise ValueError(
                    f"StateSpec marks state {idx} as growing but the program "
                    f"returns only {self._n_state} state array(s)"
                )
        # paged growing-state storage; None for fixed-row state contracts.
        # ``page_pool`` lets several schedulers share one physical pool
        # (multi-model co-serving); ``page_quota`` is then this scheduler's
        # admission budget within it — worst-case gating against the quota
        # keeps every co-tenant's admitted streams able to grow to their
        # end even when the pool itself is shared.
        if (page_pool is not None or page_quota is not None) \
                and not self.state_spec.paged:
            raise ValueError(
                "page_pool/page_quota need a paged StateSpec (growing "
                "arrays) — a fixed-row state allocates no pages")
        self._paged = (PagedKVState(self.capacity, self.state_spec,
                                    pool=page_pool)
                       if self.state_spec.paged else None)
        if self._paged is not None:
            quota = (int(page_quota) if page_quota is not None
                     else self.state_spec.pool_pages(self.capacity))
            if not 1 <= quota <= self._paged.pool.pages:
                raise ValueError(
                    f"page_quota={quota} must be in [1, "
                    f"{self._paged.pool.pages}] (the pool's page count)")
            self._page_quota = quota
        else:
            self._page_quota = 0
        self._pages_committed = 0      # worst-case pages of live streams
        self._paged_dirty = True       # membership changed since last gather
        # the prefix-sharing prefill: a root with the step's arg structure
        # but a (B, T) token batch — `prefill_suffix(*state, tokens) ->
        # (logits, *state)` — whose growing-state inputs carry the cached
        # prefix rows and whose non-growing state input carries the per-row
        # cached length.  Shares the offload-unit cache with prefill/step.
        self._suffix: CompiledHybrid | None = None
        if prefill_suffix is not None:
            if self._paged is None:
                raise ValueError(
                    "prefill_suffix needs a paged StateSpec (growing arrays) "
                    "— prefix sharing maps KV pages")
            if prefill_suffix not in program.functions:
                raise KeyError(
                    f"unknown prefill_suffix function {prefill_suffix!r}; "
                    f"program defines {sorted(program.functions)}")
            sfx = program.functions[prefill_suffix]
            if len(sfx.args) != self._n_state + 1:
                raise ValueError(
                    f"prefill_suffix {prefill_suffix!r} must take "
                    f"({self._n_state} state arrays + tokens), got "
                    f"{len(sfx.args)} args")
            if len(sfx.returns) != n_returns:
                raise ValueError(
                    f"prefill_suffix {prefill_suffix!r} must return (logits, "
                    f"*state) like the prefill entry, got "
                    f"{len(sfx.returns)} return(s)")
            self.suffix_planned = planned.for_entry(prefill_suffix)
            self._suffix = self.suffix_planned.compile(backend=backend)
        # the block-sparse paged-kernel step: `paged_step(*pool buffers,
        # tables, lengths, tokens) -> (logits, *fresh rows)` — consumes the
        # page-pool backing buffers and block tables directly (no dense
        # gather at the crossing) and returns each stream's newly computed
        # context rows for the scheduler to append host-side.
        self._paged_step: CompiledHybrid | None = None
        if paged_step is not None:
            if self._paged is None:
                raise ValueError(
                    "paged_step needs a paged StateSpec (growing arrays) — "
                    "the kernel walks KV pages")
            if paged_step not in program.functions:
                raise KeyError(
                    f"unknown paged_step function {paged_step!r}; "
                    f"program defines {sorted(program.functions)}")
            n_growing = len(self.state_spec.growing)
            pfn = program.functions[paged_step]
            if len(pfn.args) != n_growing + 3:
                raise ValueError(
                    f"paged_step {paged_step!r} must take ({n_growing} pool "
                    f"buffers + tables + lengths + tokens), got "
                    f"{len(pfn.args)} args")
            if len(pfn.returns) != n_growing + 1:
                raise ValueError(
                    f"paged_step {paged_step!r} must return (logits, "
                    f"{n_growing} fresh state rows), got "
                    f"{len(pfn.returns)} return(s)")
            self.paged_step_planned = planned.for_entry(paged_step)
            self._paged_step = self.paged_step_planned.compile(backend=backend)
        if self.state_spec.share_prefixes and self._suffix is None:
            raise ValueError(
                "StateSpec(share_prefixes=True) needs a suffix-capable "
                "prefill entry: pass DecodeScheduler(prefill_suffix=...)")
        if self._suffix is not None and not self.state_spec.share_prefixes:
            raise ValueError(
                "prefill_suffix without StateSpec(share_prefixes=True) "
                "would compile but never run — enable sharing on the state "
                "spec or drop the argument")
        self.sample = sample or greedy_sample
        self.eos = eos
        # Grace period after an idle wake-up before the first admission, so
        # a burst of submissions coalesces into one batched prefill (the
        # decode-side analogue of MixedServer's max_batch_delay).  Never
        # applied while steps are running — mid-flight admission stays eager.
        self.admit_delay = float(admit_delay)

        self._stats = DecodeStats()
        # same backpressure contract as MixedServer: submit() blocks once
        # this many streams are outstanding (queued, pending, or live);
        # capacity releases as each stream's future resolves
        self._capacity_sem = threading.BoundedSemaphore(max_pending)
        self._slots = SlotMap(self.capacity)
        self._state: list[np.ndarray] | None = None   # (capacity, ...) each
        self._state_writable = False   # may _prefill_group scatter in place?
        self._tokens: np.ndarray | None = None        # (capacity,) int32
        self._step_idx = 0
        self._pending: list[_PendingStream] = []
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        self._started = False
        self._submit_lock = threading.Lock()
        self._loop_thread = threading.Thread(
            target=self._loop, name="mixed-decode-loop", daemon=True
        )
        if start:
            self.start()

    # -- client surface -----------------------------------------------------

    def start(self) -> None:
        """Start the decode loop (idempotent).

        Constructed with ``start=False``, the scheduler queues submissions
        without admitting them until ``start()`` — the deterministic way to
        make a whole burst join in one batched prefill (``admit_delay`` is
        the best-effort, timing-based alternative for live traffic).
        """
        with self._submit_lock:
            if self._started:
                return
            self._started = True
            # start under the lock: a concurrent close() that sees
            # _started must also see a started thread, or its join()
            # would raise "cannot join thread before it is started"
            self._loop_thread.start()

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        eos: int | None = None,
    ) -> DecodeStream:
        """Enqueue one decode stream; returns its :class:`DecodeStream`.

        ``prompt`` is a 1-D integer token array; the stream emits
        ``max_new_tokens`` tokens (the first sampled from the prefill
        logits) unless ``eos`` (default: the scheduler's) is sampled first,
        which is emitted and ends the stream.  Admission happens at the
        next step boundary with a free slot, FIFO per prompt shape.
        """
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D tokens, got shape {prompt.shape}")
        # validate here, not deep in the engine: a zero-length or float
        # prompt would otherwise surface as an opaque shape/dtype error
        # mid-loop and fail its whole admission group
        if prompt.shape[0] == 0:
            raise ValueError("prompt must not be empty (zero-length tokens)")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(
                f"prompt must be integer tokens, got dtype {prompt.dtype}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1: {max_new_tokens}")
        spec = self.state_spec
        if spec.paged:
            # the last KV row a stream can write is prompt_len + max_new - 2
            # (each step caches the *input* token; the final sampled token
            # never enters the cache), so the context high-water mark is
            # prompt_len + max_new_tokens - 1
            worst_ctx = prompt.shape[0] + max_new_tokens - 1
            if worst_ctx > spec.max_context:
                raise ValueError(
                    f"prompt_len + max_new_tokens - 1 = {worst_ctx} exceeds "
                    f"the state contract's max_context={spec.max_context}"
                )
            if spec.pages_needed(worst_ctx) > self._page_quota:
                raise ValueError(
                    f"stream needs {spec.pages_needed(worst_ctx)} pages at "
                    f"worst case but this scheduler's page quota is only "
                    f"{self._page_quota}"
                )
        stream = DecodeStream(prompt, int(max_new_tokens),
                              self.eos if eos is None else eos)
        # blocking backpressure, taken OUTSIDE the submit lock so stalled
        # submitters never hold it against start()/close()
        self._capacity_sem.acquire()
        with self._submit_lock:
            if self._closed:
                self._capacity_sem.release()
                raise RuntimeError("DecodeScheduler is closed")
            stream.future.add_done_callback(
                lambda _: self._capacity_sem.release())
            self._queue.put(_PendingStream(stream))
        return stream

    def decode(self, prompt, max_new_tokens: int, *,
               eos: int | None = None,
               timeout: float | None = None) -> np.ndarray:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens, eos=eos).result(timeout)

    def warm(self, prompt_len: int, *, dtype=np.int32) -> None:
        """Pre-compile the prefill (for ``prompt_len``) and step signatures.

        One dummy padded call each, so the first real stream never blocks
        on a first-signature unit build.  Warm calls are counted in ``report().warm_calls`` and in
        ``execution``, but never in ``crossings`` — tokens/crossing reflects
        serving traffic only.
        """
        prompts = np.zeros((self.capacity, int(prompt_len)), dtype)
        outs, rep = self.prefill.call_reported(prompts)
        self._stats.record_warm(rep)
        state = [np.asarray(o) for o in outs[1:]]
        tokens = np.zeros((self.capacity,), np.int32)
        _, rep = self.step.call_reported(*state, tokens)
        self._stats.record_warm(rep)
        if self._suffix is not None:
            _, rep = self._suffix.call_reported(*state, prompts)
            self._stats.record_warm(rep)
        if self._paged_step is not None:
            spec = self.state_spec
            device = _pools_device(self._paged_step, self._paged, state)
            pools = []
            for k in sorted(spec.growing):
                axis = spec.growing[k]
                s = state[k]
                inner = tuple(d for i, d in enumerate(s.shape)
                              if i not in (0, axis))
                shape = (spec.pool_pages(self.capacity), spec.page_size) + inner
                pools.append(np.zeros(shape, s.dtype) if device is None else Resident(
                    torch.zeros(shape, dtype=torch_dtype(canonical_dtype(s.dtype)),
                                device=device)))
            tables = np.zeros((self.capacity, spec.pages_per_stream), np.int32)
            lengths = np.zeros((self.capacity,), np.int32)
            _, rep = self._paged_step.call_reported(
                *pools, tables, lengths, tokens)
            self._stats.record_warm(rep)

    def report(self) -> DecodeReport:
        """Snapshot of the decode counters (see :class:`DecodeReport`)."""
        return self._stats.snapshot()

    def close(self) -> None:
        """Stop accepting, decode every admitted/queued stream to completion,
        then join the loop thread.

        Safe (and meaningful) to call from several threads at once: *every*
        caller joins the loop thread, so "close() returned" always implies
        "drained".  The early-return-on-``_closed`` shortcut would let a
        second closer return while the first is still waiting on the join —
        the exact race this guards against.
        """
        self.start()    # a never-started scheduler still drains its queue
        with self._submit_lock:
            if not self._closed:
                self._closed = True
                self._queue.put(_CLOSE)
        self._loop_thread.join()

    def __enter__(self) -> "DecodeScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the decode loop (scheduler thread) ---------------------------------

    def _loop(self) -> None:
        closing = False
        while True:
            try:
                closing = self._drain(block=not closing
                                      and self._slots.live == 0
                                      and not self._pending) or closing
                self._admit()
                if self._slots.live:
                    self._step_all()
                elif closing and not self._pending:
                    if self._paged is not None:
                        # drop retained prefix entries: "close() returned"
                        # implies the zero-leak identity (in_use == 0,
                        # refs_outstanding == 0), retention notwithstanding
                        self._paged.clear_prefix_index()
                        self._record_pool()
                    return
                elif not self._pending:
                    continue    # nothing live; block for work at the top
            except Exception as e:  # noqa: BLE001 — the loop must outlive any
                # one poisoned stream: fail everything in flight and keep
                # serving (stranded futures would hang clients forever)
                self._fail_all(e)

    def _fail_all(self, e: BaseException) -> None:
        """Fail every live and pending stream with ``e`` and keep serving.

        Records everything before resolving any future: a client waking
        from ``result()`` must see current counters.  Shared by this
        scheduler's own loop and by :class:`MultiModelDecodeScheduler`,
        whose loop drives several schedulers and must contain one model's
        poisoned iteration to that model's streams.
        """
        failed: list[DecodeStream] = []
        for slot, stream in self._slots.occupied():
            self._release_slot(stream)
            self._stats.record_retire(failed=True)
            failed.append(stream)
        for p in self._pending:
            self._stats.record_retire(failed=True)
            failed.append(p.stream)
        self._pending = []
        self._record_pool()
        for stream in failed:
            _resolve(stream.future, exception=e)

    def _drain(self, block: bool) -> bool:
        """Move queued submissions into the pending list; True once closed."""
        closing = False
        if block:
            item = self._queue.get()
            if item is _CLOSE:
                closing = True
            else:
                self._pending.append(item)
                if self.admit_delay > 0:
                    time.sleep(self.admit_delay)   # let the burst coalesce
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return closing
            if item is _CLOSE:
                closing = True
            else:
                self._pending.append(item)

    # -- admission (the prefill boundary) -----------------------------------

    def _admit(self) -> None:
        while self._pending and self._slots.free:
            lead = self._pending[0]
            budget = self._page_budget()
            blocked = False         # keep FIFO: no queue-jumping past a
            group: list[_PendingStream] = []    # page-starved stream
            rest: list[_PendingStream] = []
            for p in self._pending:
                need = self._pages_worst(p.stream)
                if (not blocked and len(group) < self._slots.free
                        and p.sig == lead.sig):
                    if need <= budget:
                        group.append(p)
                        budget -= need
                        continue
                    blocked = True
                rest.append(p)
            if not group:
                return              # head-of-line stream waits for pages
            self._pending = rest
            self._prefill_group([p.stream for p in group])

    # -- paged-state accounting (no-ops for fixed-row state) -----------------

    def _pages_worst(self, stream: DecodeStream) -> int:
        """Conservative page demand: the stream decoded to max_new_tokens."""
        if self._paged is None:
            return 0
        return self.state_spec.pages_needed(
            stream.prompt.shape[0] + stream.max_new_tokens - 1)

    def _page_budget(self) -> int:
        """Quota pages not spoken for by any live stream's worst case."""
        if self._paged is None:
            return 0
        return self._page_quota - self._pages_committed

    def _release_slot(self, stream: DecodeStream) -> None:
        """Free the stream's slot and recycle its pages + reservation."""
        self._slots.retire(stream.slot)
        if self._paged is not None:
            self._paged.retire(stream.slot)
            self._pages_committed -= self._pages_worst(stream)
            self._paged_dirty = True

    def _record_pool(self) -> None:
        if self._paged is not None:
            # per-instance counters, not the pool's: with a shared pool
            # (multi-model co-serving) the pool's global totals mix every
            # tenant's traffic, while these are exactly this scheduler's.
            # For a private pool the two are identical.
            paged, pool = self._paged, self._paged.pool
            self._stats.record_pool(
                page_size=pool.page_size, page_capacity=self._page_quota,
                in_use=paged.pages_in_use, peak=paged.page_peak_in_use,
                allocs=paged.page_allocs, frees=paged.page_frees,
                prefix_hits=paged.prefix_hits,
                prefix_tokens_reused=paged.prefix_tokens_reused,
                pages_shared=paged.pages_shared,
                pages_cow_copied=paged.cow_copies,
                state_bytes_saved=paged.bytes_saved,
                prefix_evictions=paged.prefix_evictions)

    @staticmethod
    def _state_nbytes(arrays) -> int:
        """Logical bytes of state handed to a call, resident pools included."""
        return int(sum(a.nbytes for a in arrays))

    def _suffix_args(
        self,
        prompts: np.ndarray,
        n_rows: int,
        pins: dict[int, tuple[int, tuple[int, ...]]],
    ) -> list[np.ndarray | Resident]:
        """State inputs for the suffix-capable prefill call.

        Growing arrays carry each pending row's cached prefix, gathered from
        its pinned pages over the zero template (rows without a match stay
        all-zero); every non-growing state array carries the per-row cached
        length — the suffix entry's contract is therefore ``(growing K/V
        arrays..., length vector, tokens)``, which the scheduler validates
        against the stored state shapes here.  The growing arrays are built
        on the pools' device and cross by reference where the suffix root's
        plan takes them so (every use reaches an offload unit), as the
        paged step takes the pools; otherwise they are gathered on the host.
        """
        growing = self.state_spec.growing
        paged = self._paged
        row_pages = [(pins[i][1], pins[i][0]) if i in pins else ((), 0)
                     for i in range(n_rows)]
        lengths: dict[int, np.ndarray] = {}
        for k in range(self._n_state):
            if k in growing:
                continue
            ref = self._state[k]
            if ref is None or ref.ndim != 1:
                raise ValueError(
                    f"prefix sharing requires every non-growing state array "
                    f"to be the per-stream (capacity,) length vector; state "
                    f"{k} has shape "
                    f"{None if ref is None else ref.shape}")
            vec = np.zeros((self.capacity,), ref.dtype)
            for i, (shared_len, _) in pins.items():
                vec[i] = shared_len
            lengths[k] = vec
        resident = False
        if paged.device is not None and paged.device == self._suffix.device:
            sig = [paged.dense_aval(k) if k in growing else aval_of(lengths[k])
                   for k in range(self._n_state)] + [aval_of(prompts)]
            resident = self._suffix.state_for(sig).plan.units_only_read(sorted(growing))
        return [paged.gather_pages(k, row_pages, resident=resident) if k in growing
                else lengths[k] for k in range(self._n_state)]

    def _device_returns(self) -> frozenset[int]:
        """The prefill outputs to take on the device: the growing state
        (K/V), once their pools live on the prefill's device, so admission
        copies them into the pools there.  Host pools take them as today."""
        paged = self._paged
        if paged is None or paged.device is None or paged.device != self.prefill.device:
            return frozenset()
        return frozenset(1 + k for k in self.state_spec.growing)

    def _obs(self) -> "obs.Tracer | None":
        return self._tracer if self._tracer is not None else obs.active()

    def _prefill_group(self, streams: list[DecodeStream]) -> None:
        waits = [time.perf_counter() - s.submitted for s in streams]
        tr = self._obs()
        if tr is not None:
            for s, w in zip(streams, waits):
                # submitted is perf_counter seconds — the same monotonic
                # clock as span timestamps, so the wait renders in place
                tr.add("admit", obs.ADMIT_WAIT,
                       int(s.submitted * 1e9), int(w * 1e9))
        admitted: list[DecodeStream] = []
        # resolutions are deferred until all counters are recorded: a client
        # waking from result() may immediately call report() and must see
        # the step/pool state that produced its tokens
        resolutions: list[tuple] = []
        sharing = self._suffix is not None and self.state_spec.share_prefixes
        # pre-call prefix matches, keyed by pending-row index.  Pinned pages
        # hold a pool reference each, so allocation pressure between match
        # and admit (eviction of retained entries) can never recycle them;
        # admit(pinned=True) adopts the references, the except path returns
        # whatever was never consumed.
        pins: dict[int, tuple[int, tuple[int, ...]]] = {}
        phase, t_emit = "prefill", None
        try:
            prompts = pad_rows(np.stack([s.prompt for s in streams]),
                               self.capacity)
            suffix_state: list[np.ndarray] | None = None
            keys_by_row: dict[int, list] = {}
            if sharing and self._state is not None:
                for i, s in enumerate(streams):
                    # hash each prompt's prefixes once; the admit-time
                    # re-match below reuses the keys instead of re-hashing
                    keys_by_row[i] = self._paged.prefix_keys(s.prompt)
                    shared_len, pages = self._paged.match_and_pin(
                        s.prompt, keys=keys_by_row[i])
                    if shared_len:
                        pins[i] = (shared_len, pages)
            phase = "prefill_suffix" if pins else "prefill"
            t0 = tr.now() if tr is not None else 0
            if pins:
                # one batched suffix-capable prefill serves the whole group:
                # matched rows consume their cached prefix (len > 0), the
                # rest recompute from len 0 — bit-identical to the plain
                # prefill row-for-row, because both roots route through the
                # same encode/head offload units
                suffix_state = self._suffix_args(prompts, len(streams), pins)
                outs, report = self._suffix.call_reported(
                    *suffix_state, prompts, device_returns=self._device_returns())
            else:
                outs, report = self.prefill.call_reported(
                    prompts, device_returns=self._device_returns())
            if tr is not None:
                t_emit = tr.now()
                tr.add(phase, obs.PREFILL, t0, t_emit - t0,
                       args={"streams": len(streams)})
            logits = np.asarray(outs[0])
            # growing arrays the call kept on the device stay Resident
            state = [o if isinstance(o, Resident) else np.asarray(o) for o in outs[1:]]
            growing = self.state_spec.growing
            if self._state is None:
                # first admission fixes the persistent (capacity, ...)
                # buffers; free rows hold stale-but-finite values and are
                # never read back.  Growing arrays live in pages instead —
                # no dense buffer.
                self._state = [None if k in growing else np.array(s)
                               for k, s in enumerate(state)]
                self._state_writable = True
                self._tokens = np.zeros((self.capacity,), np.int32)
            elif not self._state_writable:
                # the steady decode path adopts step outputs without
                # copying (see _step_all); unit outputs may alias their inputs,
                # so the admission boundary — the only writer — copies the
                # fixed-row arrays once before scattering into them
                self._state = [v if k in growing else np.array(v)
                               for k, v in enumerate(self._state)]
                self._state_writable = True
            if self._paged is not None:
                device = _pools_device(self._paged_step, self._paged, state)
                for k in growing:
                    self._paged.ensure_buffers(k, state[k], device)
                self._paged_dirty = True
            prompt_len = streams[0].prompt.shape[0]
            emitted = 0
            for i, stream in enumerate(streams):
                slot = self._slots.admit(stream)
                stream.slot = slot
                stream.admitted_step = self._step_idx
                admitted.append(stream)
                if self._paged is not None:
                    # commit BEFORE admit: if admit dies mid-allocation the
                    # handler's _release_slot decrement stays balanced
                    self._pages_committed += self._pages_worst(stream)
                    shared_len, pages = pins.pop(i, (0, ()))
                    if sharing and not shared_len:
                        # intra-group sharing: an earlier stream of this very
                        # group may have just registered the common prefix —
                        # its stored rows are bitwise this row's own rows
                        # (same batched call), so mapping them is exact
                        shared_len, pages = self._paged.match_and_pin(
                            stream.prompt, keys=keys_by_row.get(i))
                    self._paged.admit(slot, {k: _row(state[k], i) for k in growing},
                                      prompt_len, shared_len=shared_len,
                                      shared_pages=pages, pinned=True)
                    if sharing:
                        self._paged.register_prefix(slot, stream.prompt)
                for k, s in enumerate(state):
                    if k not in growing:
                        self._state[k][slot] = s[i]
                if not self._emit(stream, logits[i], at_prefill=True,
                                  resolutions=resolutions):
                    self._tokens[stream.slot] = stream._generated[-1]
                emitted += len(stream._generated)  # 0 if the sampler failed
            state_bytes = self._state_nbytes(outs[1:])
            if suffix_state is not None:
                # the suffix path also marshals the cached state *into* the
                # call — count it: state_bytes prices the crossing channel
                state_bytes += self._state_nbytes(suffix_state)
            self._stats.record_prefill(n_streams=len(streams), tokens=emitted,
                                       waits=waits, report=report,
                                       state_bytes=state_bytes, phase=phase)
            self._record_pool()
        except Exception as e:  # noqa: BLE001 — fail this whole group (the
            # streams left _pending already, so nobody else can resolve
            # them) but keep serving; release anything partially admitted
            for _i, (_len, pages) in pins.items():
                # consumed pins were popped at admit; these streams never
                # admitted, so hand their references back to the pool
                self._paged.unpin(pages)
            pins.clear()
            for stream in streams:
                if any(stream is s for s, _, _ in resolutions):
                    continue           # retired at its own prefill emit
                if stream in admitted:
                    self._release_slot(stream)
                self._stats.record_retire(failed=True)
                resolutions.append((stream, None, e))
            self._record_pool()
        finally:
            # before the resolutions: a client they wake may read the tracer
            if t_emit is not None:
                tr.add(phase, obs.EMIT, t_emit, tr.now() - t_emit,
                       args={"live": len(streams)})
            # even if the handler itself dies, queued outcomes must reach
            # their clients — a dropped resolution is a hung result()
            for stream, result, exc in resolutions:
                _resolve(stream.future, result=result, exception=exc)

    # -- stepping ------------------------------------------------------------

    def _step_all(self) -> None:
        if self._paged_step is not None:
            return self._step_all_paged()
        live = self._slots.occupied()
        growing = self.state_spec.growing
        if self._paged is not None:
            if self._paged_dirty:
                # membership changed since the last step: re-materialize
                # growing arrays from pages at the one fixed padded shape
                # (zero template beyond each filled prefix — bit-identical
                # to the array a solo loop would have threaded)
                state_args = [
                    self._paged.gather(k) if k in growing else self._state[k]
                    for k in range(self._n_state)
                ]
                self._paged_dirty = False
            else:
                # unchanged membership: the previous step's own outputs are
                # already bit-identical to a gather for every live row
                # (select-writes + zero padding), so skip the page copies
                state_args = list(self._state)
            cache_valid = self._paged.valid_positions()
            cache_alloc = self._paged.pool.in_use * self.state_spec.page_size
        else:
            state_args = self._state
            cache_valid = cache_alloc = 0
        tr = self._obs()
        t0 = tr.now() if tr is not None else 0
        try:
            outs, report = self.step.call_reported(*state_args, self._tokens)
            if tr is not None:
                t_emit = tr.now()
                tr.add("step", obs.STEP, t0, t_emit - t0,
                       args={"live": len(live)})
        except Exception as e:  # noqa: BLE001 — a poisoned step fails its
            # streams (stranded futures would hang clients) but not the
            # loop; record everything before resolving (see _prefill_group)
            self._step_idx += 1
            for slot, stream in live:
                self._release_slot(stream)
                stream.retired_step = self._step_idx - 1
                self._stats.record_retire(failed=True)
            self._record_pool()
            for slot, stream in live:
                _resolve(stream.future, exception=e)
            return
        self._step_idx += 1
        logits = np.asarray(outs[0])
        state = [np.asarray(o) for o in outs[1:]]
        # Adopt the step outputs as-is — the steady decode path copies
        # nothing.  Unit outputs may alias other arrays, but the decode loop
        # only ever writes state at the admission boundary, which copies the
        # fixed-row arrays first (_state_writable); a fixed-size-state model
        # (StateSpec(growing={})) therefore streams step-to-step with zero
        # per-step state duplication and zero page traffic.
        self._state = state
        self._state_writable = False
        emitted = 0
        resolutions: list[tuple] = []
        try:
            for slot, stream in live:
                if self._paged is not None:
                    # the step wrote exactly one new context row per stream
                    # (a select: rows below the write position pass through
                    # bitwise unchanged) — page only the appended position
                    self._paged.append(slot,
                                       {k: state[k][slot] for k in growing})
                before = len(stream._generated)
                if not self._emit(stream, logits[slot], at_prefill=False,
                                  resolutions=resolutions):
                    self._tokens[slot] = stream._generated[-1]
                emitted += len(stream._generated) - before  # 0 on sampler fail
            self._stats.record_step(
                live=len(live), slots=self.capacity, tokens=emitted,
                report=report,
                state_bytes=(self._state_nbytes(state_args)
                             + int(self._tokens.nbytes)),
                cache_valid=cache_valid, cache_alloc=cache_alloc)
            self._record_pool()
        finally:
            if tr is not None:      # before the resolutions (see _prefill_group)
                tr.add("step", obs.EMIT, t_emit, tr.now() - t_emit,
                       args={"live": len(live)})
            # a later slot's append/record may raise (handled by _loop);
            # outcomes already queued must still reach their clients — a
            # dropped resolution is a hung result()
            for stream, result, exc in resolutions:
                _resolve(stream.future, result=result, exception=exc)

    def _step_all_paged(self) -> None:
        """One batched step through the block-sparse paged-kernel root.

        The crossing consumes the page-pool backing buffers, the dense
        block-table array, and the length vector *directly* — no dense
        ``(capacity, max_context, ...)`` gather is ever materialized, and
        the step returns only each stream's fresh context rows, which are
        appended into pages host-side.  Inside the kernel, dead table slots
        are skipped outright, so attention FLOPs scale with the live pages
        counted here (``pages_visited``).
        """
        live = self._slots.occupied()
        growing = sorted(self.state_spec.growing)
        paged = self._paged
        pools = [paged.backing(k) for k in growing]
        tables = paged.table_array()
        lengths = paged.lengths_array()
        ps = self.state_spec.page_size
        visited = int(sum(-(-int(n) // ps) for n in lengths))
        skipped = int(tables.size) - visited
        cache_valid = paged.valid_positions()
        cache_alloc = paged.pool.in_use * ps
        tr = self._obs()
        t0 = tr.now() if tr is not None else 0
        try:
            outs, report = self._paged_step.call_reported(
                *pools, tables, lengths, self._tokens)
            if tr is not None:
                t_emit = tr.now()
                tr.add("step", obs.STEP, t0, t_emit - t0,
                       args={"live": len(live), "pages_visited": visited})
        except Exception as e:  # noqa: BLE001 — same contract as _step_all:
            # a poisoned step fails its streams but never the loop
            self._step_idx += 1
            for slot, stream in live:
                self._release_slot(stream)
                stream.retired_step = self._step_idx - 1
                self._stats.record_retire(failed=True)
            self._record_pool()
            for slot, stream in live:
                _resolve(stream.future, exception=e)
            return
        self._step_idx += 1
        logits = np.asarray(outs[0])
        rows = [np.asarray(o) for o in outs[1:]]
        emitted = 0
        resolutions: list[tuple] = []
        try:
            for slot, stream in live:
                # land the fresh k/v rows in pages; copy-on-write detaches a
                # shared tail page exactly as the dense append path would
                paged.append_row(slot, {k: rows[j][slot]
                                        for j, k in enumerate(growing)})
                before = len(stream._generated)
                if not self._emit(stream, logits[slot], at_prefill=False,
                                  resolutions=resolutions):
                    self._tokens[slot] = stream._generated[-1]
                emitted += len(stream._generated) - before
            paged.flush()           # device pools: the step's rows in one copy
            self._stats.record_step(
                live=len(live), slots=self.capacity, tokens=emitted,
                report=report,
                state_bytes=(self._state_nbytes(pools) + int(tables.nbytes)
                             + int(lengths.nbytes)
                             + int(self._tokens.nbytes)),
                cache_valid=cache_valid, cache_alloc=cache_alloc,
                pages_visited=visited, pages_skipped=skipped,
                kernel_step=True)
            self._record_pool()
        finally:
            if tr is not None:      # before the resolutions (see _prefill_group)
                tr.add("step", obs.EMIT, t_emit, tr.now() - t_emit,
                       args={"live": len(live)})
            for stream, result, exc in resolutions:
                _resolve(stream.future, result=result, exception=exc)

    def _emit(self, stream: DecodeStream, logits_row: np.ndarray,
              *, at_prefill: bool, resolutions: list[tuple]) -> bool:
        """Sample one token for ``stream``; retire it if finished or failed.

        Returns True when the stream retired (its slot is already free).
        The future is not resolved here — the outcome is queued on
        ``resolutions`` and delivered by the caller after the call's
        counters are recorded, so a client waking from ``result()`` never
        reads a report that predates its own tokens."""
        try:
            token = int(self.sample(logits_row))
        except Exception as e:  # noqa: BLE001 — a failing sampler kills only
            # its own stream; batch-mates decode on
            self._retire(stream, at_prefill)
            self._stats.record_retire(failed=True)
            resolutions.append((stream, None, e))
            return True
        stream._generated.append(token)
        done = (len(stream._generated) >= stream.max_new_tokens
                or (stream.eos is not None and token == stream.eos))
        if done:
            self._retire(stream, at_prefill)
            self._stats.record_retire()
            resolutions.append((stream,
                                np.array(stream._generated, np.int32), None))
        return done

    def _retire(self, stream: DecodeStream, at_prefill: bool) -> None:
        """Free the stream's slot (and pages) immediately — reusable by the
        very next admission pass, so a retired stream never pads a later
        step and never holds cache it can no longer use."""
        self._release_slot(stream)
        stream.retired_step = (stream.admitted_step - 1 if at_prefill
                               else self._step_idx - 1)


class MultiModelDecodeScheduler:
    """Heterogeneous co-serving: several decode models, one scheduler.

    Each :meth:`register`\\ ed model — a ``(PlannedProgram, StateSpec)``
    pair with its own step root, capacity, and sampling config — becomes a
    **lane**: a full :class:`DecodeScheduler` whose slot partition,
    signature group, and counters are private to that model, but whose
    loop thread is never started.  This scheduler runs ONE loop thread
    that drives every lane in turn, so each iteration issues **one
    batched prefill/step crossing per model** — the multi-model analogue
    of continuous batching's one-crossing-per-step contract — and a
    poisoned iteration in one model's lane fails only that model's
    streams (see :meth:`DecodeScheduler._fail_all`).

    **Shared page pool.**  All paged lanes draw from one
    :class:`~repro_torch.serve.PagePool` sized at build time to the sum of the
    lanes' quotas (each quota defaults to the lane's can't-fail pool size;
    cap it via ``StateSpec(pages=...)``).  Every lane admission-gates
    against its own quota, so co-tenants can never starve each other of
    pages mid-flight, and per-lane page accounting
    (:class:`~repro_torch.serve.batcher.PagedKVState`) keeps each model's
    ``page_allocs``/``page_frees`` exact while the pool's globals sum
    them.  A fixed-size-state model (``StateSpec(growing={})`` — e.g. the
    mamba2 SSM export) never touches the pool at all: its lane asserts
    the degenerate fast path's ``page_allocs == 0`` contract simply by
    construction.

    **Bit-exactness** is inherited lane by lane: every lane pads to its
    own fixed capacity, so each stream's tokens are bit-identical to its
    model's solo :func:`decode_reference` regardless of what the *other*
    models were doing — the whole point of per-model signature groups.

    **Lifecycle.**  ``register(...)`` (before any traffic) →
    ``submit(model=...)`` / ``warm(model, ...)`` → ``report()`` →
    ``close()``.  The lanes are built lazily on first use; registering
    after that raises.

        multi = MultiModelDecodeScheduler()
        multi.register("attn", planned_attn, step="decode_step",
                       capacity=4, state=StateSpec(growing={0: 1, 1: 1},
                                                   max_context=32,
                                                   page_size=8))
        multi.register("mamba2", planned_m2, step="decode_step", capacity=4)
        with multi:
            a = multi.submit(prompt, 8, model="attn")
            b = multi.submit(prompt, 8, model="mamba2")
            print(multi.report().table())    # per-model sections + aggregate
    """

    def __init__(self, *, start: bool = True,
                 tracer: "obs.Tracer | None" = None):
        # start=True (default) launches the loop on first submit; start=False
        # queues submissions until start() — the deterministic way to admit a
        # whole multi-model burst together (same idiom as DecodeScheduler)
        self._autostart = bool(start)
        self._tracer = tracer
        self._configs: dict[str, tuple[PlannedProgram, dict]] = {}
        self._lanes: dict[str, DecodeScheduler] | None = None
        self.pool: PagePool | None = None
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        self._started = False
        self._lock = threading.Lock()
        self._loop_thread = threading.Thread(
            target=self._loop, name="mixed-multimodel-loop", daemon=True
        )

    # -- registration ---------------------------------------------------------

    def register(
        self,
        name: str,
        planned: PlannedProgram,
        *,
        step: str,
        capacity: int = 8,
        state: StateSpec | None = None,
        **kwargs,
    ) -> "MultiModelDecodeScheduler":
        """Add a model lane (chainable).  Must precede the first submit/warm.

        ``kwargs`` forward to the lane's :class:`DecodeScheduler`
        (``sample``, ``eos``, ``prefill_suffix``, ``paged_step``,
        ``backend``, ...); the scheduler itself owns the lane's lifecycle
        and pool plumbing, so ``start``/``page_pool``/``page_quota``/
        ``tracer`` are rejected here.
        """
        for owned in ("start", "page_pool", "page_quota", "tracer"):
            if owned in kwargs:
                raise TypeError(
                    f"register() manages {owned!r} itself; it cannot be "
                    f"passed per model")
        with self._lock:
            if self._lanes is not None:
                raise RuntimeError(
                    "cannot register a model after the scheduler started "
                    "serving (lanes and the shared pool are already built)")
            if name in self._configs:
                raise ValueError(f"model {name!r} is already registered")
            self._configs[name] = (
                planned, dict(step=step, capacity=capacity, state=state,
                              **kwargs))
        return self

    @property
    def registered(self) -> tuple[str, ...]:
        """Registered model names, in registration order."""
        return tuple(self._configs)

    def _ensure_built(self) -> None:
        """Build the lanes and the shared pool (idempotent, first use)."""
        with self._lock:
            if self._lanes is not None:
                return
            if not self._configs:
                raise RuntimeError(
                    "no models registered; call register() before serving")
            # one shared physical pool sized to the sum of per-lane quotas;
            # quota-gated admission inside each lane keeps tenants isolated
            quotas: dict[str, int] = {}
            page_size: int | None = None
            for name, (_planned, kw) in self._configs.items():
                spec = kw["state"]
                if spec is None or not spec.paged:
                    continue
                if page_size is None:
                    page_size = spec.page_size
                elif page_size != spec.page_size:
                    raise ValueError(
                        f"model {name!r} declares page_size="
                        f"{spec.page_size} but the shared pool was sized "
                        f"at page_size={page_size}; co-served paged specs "
                        f"must agree on page_size")
                quotas[name] = spec.pool_pages(int(kw["capacity"]))
            pool = (PagePool(sum(quotas.values()), page_size)
                    if quotas else None)
            lanes: dict[str, DecodeScheduler] = {}
            for name, (planned, kw) in self._configs.items():
                paged = name in quotas
                lanes[name] = DecodeScheduler(
                    planned,
                    start=False,            # this scheduler's loop drives it
                    page_pool=pool if paged else None,
                    page_quota=quotas.get(name),
                    tracer=self._tracer,
                    **kw,
                )
            self.pool = pool
            self._lanes = lanes

    # -- client surface -------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        model: str,
        eos: int | None = None,
    ) -> DecodeStream:
        """Enqueue one decode stream on ``model``'s lane.

        Same contract as :meth:`DecodeScheduler.submit`, plus routing:
        ``model`` must name a registered model.  Admission, stepping, and
        retirement happen on the model's own slot partition, so streams
        of different models never share a batch row.
        """
        if self._autostart:
            self.start()    # lanes built + loop running on first traffic
        else:
            self._ensure_built()
        lane = self._lanes.get(model)
        if lane is None:
            raise KeyError(
                f"unknown model {model!r}; registered models: "
                f"{sorted(self._lanes)}")
        with self._lock:
            if self._closed:
                raise RuntimeError("MultiModelDecodeScheduler is closed")
            # enqueue lane item and wake token under one lock: nothing can
            # land in a lane queue after close() queued the _CLOSE sentinel
            stream = lane.submit(prompt, max_new_tokens, eos=eos)
            self._queue.put(_WAKE)
        return stream

    def decode(self, prompt, max_new_tokens: int, *, model: str,
               eos: int | None = None,
               timeout: float | None = None) -> np.ndarray:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens, model=model,
                           eos=eos).result(timeout)

    def warm(self, model: str, prompt_len: int, **kwargs) -> None:
        """Pre-compile ``model``'s prefill/step signatures (see
        :meth:`DecodeScheduler.warm`)."""
        self._ensure_built()
        if model not in self._lanes:
            raise KeyError(
                f"unknown model {model!r}; registered models: "
                f"{sorted(self._lanes)}")
        self._lanes[model].warm(prompt_len, **kwargs)

    def report(self) -> MultiModelReport:
        """Per-model :class:`DecodeReport` sections + shared-pool globals."""
        lanes = self._lanes or {}
        pool = self.pool
        return MultiModelReport(
            models={name: lane.report() for name, lane in lanes.items()},
            pool_pages=pool.pages if pool else 0,
            pool_page_size=pool.page_size if pool else 0,
            pool_in_use=pool.in_use if pool else 0,
            pool_peak=pool.peak_in_use if pool else 0,
            pool_allocs=pool.allocs if pool else 0,
            pool_frees=pool.frees if pool else 0,
            pool_refs_outstanding=pool.refs_outstanding if pool else 0,
        )

    def start(self) -> None:
        """Build the lanes and start the co-serving loop (idempotent)."""
        self._ensure_built()
        with self._lock:
            if self._started:
                return
            self._started = True
            self._loop_thread.start()

    def close(self) -> None:
        """Stop accepting, decode every queued stream on every lane to
        completion, then join the loop thread (same every-caller-joins
        contract as :meth:`DecodeScheduler.close`)."""
        with self._lock:
            if self._lanes is None and not self._configs:
                self._closed = True     # nothing registered: nothing to drain
                return
        self.start()
        with self._lock:
            if not self._closed:
                self._closed = True
                self._queue.put(_CLOSE)
        self._loop_thread.join()

    def __enter__(self) -> "MultiModelDecodeScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the co-serving loop (scheduler thread) -------------------------------

    def _drain(self, block: bool) -> bool:
        """Consume wake tokens from this scheduler's own queue; True once
        the close sentinel has been seen.  The tokens carry no payload —
        submissions live in the lanes' queues — they only bound how long
        an idle loop blocks."""
        closing = False
        if block:
            closing = self._queue.get() is _CLOSE
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return closing
            if item is _CLOSE:
                closing = True

    def _loop(self) -> None:
        lanes = list(self._lanes.values())
        closing = False
        while True:
            idle = (not closing
                    and all(lane._slots.live == 0 and not lane._pending
                            and lane._queue.empty() for lane in lanes))
            closing = self._drain(block=idle) or closing
            for lane in lanes:
                # one admission pass + ONE batched step crossing per model
                # per iteration; a poisoned model fails only its own lane
                try:
                    lane._drain(block=False)
                    lane._admit()
                    if lane._slots.live:
                        lane._step_all()
                except Exception as e:  # noqa: BLE001 — contain the blast
                    # radius to this lane's streams and keep co-serving
                    lane._fail_all(e)
            if closing and all(lane._slots.live == 0 and not lane._pending
                               and lane._queue.empty() for lane in lanes):
                for lane in lanes:
                    if lane._paged is not None:
                        # same zero-leak drain contract as a solo close()
                        lane._paged.clear_prefix_index()
                        lane._record_pool()
                return


def decode_reference(
    prefill: CompiledHybrid,
    step: CompiledHybrid,
    prompt,
    max_new_tokens: int,
    *,
    capacity: int,
    sample: Callable[[np.ndarray], int] | None = None,
    eos: int | None = None,
) -> np.ndarray:
    """Solo-decode ``prompt`` with the scheduler's exact padded recipe.

    This is the bit-exactness oracle for :class:`DecodeScheduler`: it pads
    the single stream to the same fixed ``capacity`` rows, so every kernel
    runs at the same shape the scheduler uses and the produced tokens are
    bit-identical to the same stream decoded inside any batch.  Use the
    ``capacity`` the scheduler was built with.
    """
    sample = sample or greedy_sample
    prompt = np.asarray(prompt)
    outs = prefill(pad_rows(prompt[None, :], capacity))
    logits, state = np.asarray(outs[0]), [np.asarray(o) for o in outs[1:]]
    generated = [int(sample(logits[0]))]
    tokens = np.zeros((capacity,), np.int32)
    while (len(generated) < max_new_tokens
           and not (eos is not None and generated[-1] == eos)):
        tokens = np.array(tokens)
        tokens[0] = generated[-1]
        outs = step(*state, tokens)
        logits, state = np.asarray(outs[0]), [np.asarray(o) for o in outs[1:]]
        generated.append(int(sample(logits[0])))
    return np.array(generated, np.int32)


def _row(state: np.ndarray | Resident, i: int) -> np.ndarray | torch.Tensor:
    """Row ``i`` of a batched state output: numpy, or a kept one's device row."""
    return state.tensor[i] if isinstance(state, Resident) else state[i]


def _pools_device(paged_step: CompiledHybrid | None, paged: PagedKVState,
                  state) -> torch.device | None:
    """The device a paged state's pools live on, or None for numpy pools.

    The pools live on the paged step's device when its plan, at the
    signature the steps will call it with, lets every pool cross by
    reference: each use of a pool in the root is an operand of an offload
    unit's call (under ``tech-gfp`` the root's first segment).  An emulated
    root, a sharded plan, or a dense step (no paged step) keeps them on the
    host, placed every step.  ``state`` is the prefill's state outputs, which
    fix the pools' inner shape and dtype; the answer is the plan's, so every
    call for one scheduler gives the same."""
    if paged_step is None or paged_step.planned.mesh is not None:
        return None
    spec = paged.spec
    growing = sorted(spec.growing)
    avals = []
    for k in growing:
        s = state[k]
        inner = tuple(d for i, d in enumerate(s.shape) if i not in (0, spec.growing[k]))
        avals.append(AVal((paged.pool.pages, spec.page_size) + inner,
                          str(canonical_dtype(s.dtype))))
    capacity = paged.capacity
    avals += [AVal((capacity, spec.pages_per_stream), "int32"),
              AVal((capacity,), "int32"), AVal((capacity,), "int32")]
    plan = paged_step.state_for(avals).plan
    return paged_step.device if plan.units_only_read(range(len(growing))) else None


def paged_decode_reference(
    prefill: CompiledHybrid,
    paged_step: CompiledHybrid,
    prompt,
    max_new_tokens: int,
    *,
    capacity: int,
    state: StateSpec,
    sample: Callable[[np.ndarray], int] | None = None,
    eos: int | None = None,
) -> np.ndarray:
    """Solo-decode ``prompt`` through the block-sparse paged-kernel step.

    The paged-kernel analogue of :func:`decode_reference`: one stream,
    padded to the scheduler's ``capacity`` rows, driven through its own
    :class:`~repro_torch.serve.batcher.PagedKVState` at the scheduler's exact
    fixed shapes — pool ``(pool_pages, page_size, ...)`` buffers, a dense
    ``(capacity, pages_per_stream)`` block table, a ``(capacity,)`` length
    vector.  Because each kernel grid row depends only on its own query,
    table row, and the pages they name — and the logical page walk order is
    fixed — the tokens are bit-identical to the same stream decoded inside
    any scheduler batch, whatever *physical* page ids either run allocated.
    Use the ``capacity`` and ``state`` spec the scheduler was built with.
    The pools live where the scheduler's do (on the step's device when its
    plan takes them by reference), so the oracle crosses as the steps do.
    """
    sample = sample or greedy_sample
    prompt = np.asarray(prompt)
    growing = sorted(state.growing)
    paged = PagedKVState(capacity, state)
    outs = prefill(pad_rows(prompt[None, :], capacity))
    logits, st = np.asarray(outs[0]), [np.asarray(o) for o in outs[1:]]
    device = _pools_device(paged_step, paged, st)
    for k in growing:
        paged.ensure_buffers(k, st[k], device)
    paged.admit(0, {k: st[k][0] for k in growing}, int(prompt.shape[0]))
    generated = [int(sample(logits[0]))]
    tokens = np.zeros((capacity,), np.int32)
    while (len(generated) < max_new_tokens
           and not (eos is not None and generated[-1] == eos)):
        tokens = np.array(tokens)
        tokens[0] = generated[-1]
        outs = paged_step(*[paged.backing(k) for k in growing],
                          paged.table_array(), paged.lengths_array(), tokens)
        logits = np.asarray(outs[0])
        rows = [np.asarray(o) for o in outs[1:]]
        paged.append_row(0, {k: rows[j][0] for j, k in enumerate(growing)})
        generated.append(int(sample(logits[0])))
    return np.array(generated, np.int32)
