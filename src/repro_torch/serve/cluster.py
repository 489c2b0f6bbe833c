"""Cross-process serving tier: multiprocess decode workers + a prefix-affinity
front-door router.

One Python process is the ceiling on a single :class:`DecodeScheduler`; this
module is the scale-out layer the ROADMAP calls for.  It is the paper's
cross-environment calling channel applied one level up: where an offload
unit crosses guest↔host *inside* a process, a :class:`ClusterWorker`
crosses client↔worker *between* processes over a length-prefixed socket
channel carrying submit / result / report / drain messages — same shape,
same economics (a fixed per-message cost that batching must amortize).

Layers:

* :class:`WorkerSpec` — a picklable recipe for one worker: the guest
  program (by factory name, so the child process rebuilds it), scheme,
  scheduler geometry, and optionally an AOT cache directory
  (:mod:`repro_torch.serve.aot`) so the worker boots warm with compile
  count 0, and the device its units run on (``backend``).
* :class:`ClusterWorker` — parent-side handle on one spawned worker
  process.  Submissions return local futures resolved by a receiver
  thread; a worker crash or unclean channel close fails every in-flight
  future with :class:`ClusterWorkerError` — no stranded clients.
* :class:`ClusterRouter` — the front door.  Prompts whose first
  ``page_size`` tokens hash equal are routed to the same worker
  (**prefix affinity**), so the per-worker LRU prefix index
  (``StateSpec.share_prefixes``) actually hits; prompts shorter than one
  page spill round-robin.  Workers can be drained (graceful: finish
  in-flight streams, return a final report, leave the routing set) and
  rejoined (a fresh process from the same spec — warm if the spec names an
  AOT cache).  :meth:`ClusterRouter.report` folds per-worker
  :class:`~repro_torch.serve.DecodeReport`\\ s into one
  :class:`~repro_torch.serve.ClusterReport`.

Processes are **spawned**, never forked — a CUDA context does not survive
a fork.  Before spawning, the router builds the kernels the op set reaches
(:data:`repro_torch.kernels.library.SOURCES`), so the workers load them
instead of each running ``nvcc`` on the same sources.  The channel speaks pickle between two processes of
the same codebase over a private ``AF_UNIX`` socketpair created in a
mode-0700 temporary directory; it is a process boundary, not a trust
boundary.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib
import itertools
import multiprocessing
import pickle
import shutil
import socket
import struct
import sys
import tempfile
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np

import torch

from .. import obs
from ..core.api import PlannedProgram, trace
from ..kernels import build, library, ops
from .batcher import StateSpec
from .reports import ClusterReport, DecodeReport
from .runtime import DecodeScheduler, _resolve


class ClusterWorkerError(RuntimeError):
    """The worker's channel died (crash, kill, unclean close).  Every
    in-flight future of that worker resolves with this error; the router
    stops routing to it."""


def prefix_affinity(prompt, page_size: int) -> int | None:
    """Stable placement hash of a prompt's first full KV page.

    ``sha256(dtype ‖ prompt[:page_size])`` — the same first page always
    hashes the same, so every prompt sharing it lands on one worker and
    that worker's prefix index can convert the collisions into CoW page
    hits.  Returns ``None`` when the prompt has no full page to hash
    (the router spills those round-robin).
    """
    prompt = np.asarray(prompt)
    if page_size <= 0 or prompt.shape[0] < page_size:
        return None
    h = hashlib.sha256(str(prompt.dtype).encode())
    h.update(np.ascontiguousarray(prompt[:page_size]).tobytes())
    return int.from_bytes(h.digest()[:8], "big")


# ---------------------------------------------------------------------------
# the channel: length-prefixed pickle frames over AF_UNIX
# ---------------------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise EOFError("channel closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv(sock: socket.socket):
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    return pickle.loads(_recv_exact(sock, n))


def _send(sock: socket.socket, lock: threading.Lock, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    tr = obs.active()
    if tr is not None:
        # send-side only, so frame counts stay deterministic per workload
        # (each frame is seen once, by the process that produced it)
        kind = obj[0] if isinstance(obj, tuple) and obj \
            and isinstance(obj[0], str) else "frame"
        tr.event(kind, obs.FRAME, args={"bytes": len(payload)})
    with lock:  # result callbacks and replies send from different threads
        sock.sendall(struct.pack(">I", len(payload)) + payload)


# ---------------------------------------------------------------------------
# worker spec + child-process entry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """Everything a spawned worker needs to build its scheduler.

    ``program`` names a zero-side-effect factory as ``"module:function"``
    (e.g. ``"repro_torch.models.programs:export_decode_lm"``); the child imports
    and calls it with ``program_kwargs`` — programs hold numpy constants,
    so shipping the recipe is cheaper and safer than pickling the arrays.
    ``aot_path`` points at a cache written by
    :meth:`~repro_torch.core.api.PlannedProgram.save_aot`; when it loads (and its
    program digest matches the factory's program) the worker boots warm.
    ``hold_admission=True`` starts the scheduler paused so a benchmark can
    queue a whole workload and release it deterministically with
    :meth:`ClusterRouter.start`.  ``backend`` is the device the worker's
    scheduler compiles its units for, as :class:`DecodeScheduler` takes it:
    ``None`` is the CUDA device (the worker refuses to boot without one),
    ``"cpu"`` the CPU.
    """

    program: str
    program_kwargs: dict = dataclasses.field(default_factory=dict)
    scheme: str = "tech-gfp"
    step: str = "decode_step"
    capacity: int = 8
    state: StateSpec | None = None
    prefill_suffix: str | None = None
    eos: int | None = None
    admit_delay: float = 0.0
    aot_path: str | None = None
    hold_admission: bool = False
    # span recording in the worker process.  The worker always installs a
    # Tracer (structured logs/warnings must cross the channel regardless);
    # this flag gates the span ring.  ClusterRouter flips it on
    # automatically when the parent itself traces.
    trace: bool = False
    backend: str | None = None


def build_planned(spec: WorkerSpec) -> PlannedProgram:
    """Build the worker's plan: AOT cache when trustworthy, source otherwise.

    The AOT path is advisory, never blind: an unusable artifact
    (:class:`~repro_torch.serve.aot.AotError`) or a program-digest mismatch with
    the factory's program degrades to a warning + planning from source.
    """
    from .aot import AotError, program_digest  # serve.aot imports core only

    mod, _, fn = spec.program.partition(":")
    factory = getattr(importlib.import_module(mod), fn)
    program = factory(**spec.program_kwargs)
    if spec.aot_path:
        try:
            planned = PlannedProgram.load_aot(spec.aot_path)
            if program_digest(planned.traced.program) == program_digest(program):
                return planned
            obs.warn(
                f"AOT cache at {spec.aot_path} holds a different program "
                f"than {spec.program}; planning from source")
        except AotError as e:
            obs.warn(f"AOT cache unusable ({e}); planning from source")
    return trace(program).plan(spec.scheme)


def _errstr(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


def _deliver(sock: socket.socket, lock: threading.Lock, rid: int, tctx,
             fut) -> None:
    """Future→frame bridge, run on the scheduler's loop thread."""
    try:
        tokens, err = fut.result(), None
    except Exception as e:  # noqa: BLE001 — ship the failure to the client
        tokens, err = None, _errstr(e)
    tr = obs.active()
    if tr is not None:
        tr.event("result", obs.RESULT, trace_id=tctx,
                 args={"rid": rid, "ok": err is None})
    try:
        _send(sock, lock, ("result", rid, tokens, err))
    except OSError:
        pass                # parent went away; nothing left to notify


def _obs_payload(tracer: obs.Tracer) -> dict:
    """The worker's observability shipment, attached to report/drain replies:
    buffered spans and structured logs (drained — each record ships once),
    the cumulative drop counter, pid→label mapping for export, and the
    worker's kernel launches per route since it booted (cumulative)."""
    spans, logs = tracer.drain()
    return {
        "spans": spans,
        "logs": logs,
        "spans_dropped": tracer.spans_dropped,
        "labels": dict(tracer.process_labels),
        "launches": ops.launches_by_route(),
    }


def _worker_main(spec: WorkerSpec, sock_path: str,
                 trace_id: str | None = None) -> None:
    """Child-process entry (must be a top-level function for spawn)."""
    # install before build_planned: boot-time warnings (e.g. an unusable
    # AOT cache) must land on the tracer to reach the parent — in a spawned
    # process a plain warnings.warn is invisible to everyone
    tracer = obs.Tracer(label=multiprocessing.current_process().name,
                        trace_id=trace_id, spans_enabled=spec.trace)
    obs.install(tracer)
    conn = socket.socket(socket.AF_UNIX)
    conn.connect(sock_path)
    lock = threading.Lock()
    try:
        if spec.backend != "cpu" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device in the worker process; pass "
                "WorkerSpec(backend='cpu') to run its units on the CPU")
        planned = build_planned(spec)
        sched = DecodeScheduler(
            planned,
            step=spec.step,
            capacity=spec.capacity,
            eos=spec.eos,
            admit_delay=spec.admit_delay,
            state=spec.state,
            prefill_suffix=spec.prefill_suffix,
            start=not spec.hold_admission,
            backend=spec.backend,
        )
        ops.reset_launches()    # count the serving run's launches, not the boot's
    except Exception as e:  # noqa: BLE001 — boot failures must reach the parent
        _send(conn, lock, ("fatal", _errstr(e)))
        conn.close()
        raise
    _send(conn, lock, ("ready",))
    try:
        while True:
            try:
                msg = _recv(conn)
            except (EOFError, OSError):
                break       # parent vanished: drain and exit below
            kind = msg[0]
            if kind == "submit":
                _, rid, prompt, max_new, eos, tctx = msg
                if spec.trace:
                    tracer.event("submit", obs.SUBMIT, trace_id=tctx,
                                 args={"rid": rid, "prompt_len": len(prompt)})
                try:
                    stream = sched.submit(prompt, max_new, eos=eos)
                except Exception as e:  # noqa: BLE001 — a bad request fails
                    # itself, not the worker
                    _send(conn, lock, ("result", rid, None, _errstr(e)))
                    continue
                stream.future.add_done_callback(
                    functools.partial(_deliver, conn, lock, rid, tctx))
            elif kind == "start":
                sched.start()
            elif kind == "report":
                _send(conn, lock, ("reply", msg[1], True,
                                   (sched.report(), _obs_payload(tracer))))
            elif kind == "save_aot":
                _, tag, path = msg
                try:
                    _send(conn, lock, ("reply", tag, True, planned.save_aot(path)))
                except Exception as e:  # noqa: BLE001
                    _send(conn, lock, ("reply", tag, False, _errstr(e)))
            elif kind == "drain":
                sched.close()   # finish every queued/in-flight stream first
                _send(conn, lock, ("reply", msg[1], True,
                                   (sched.report(), _obs_payload(tracer))))
                break
    finally:
        sched.close()
        conn.close()


# ---------------------------------------------------------------------------
# parent-side worker handle
# ---------------------------------------------------------------------------


class ClusterWorker:
    """Parent-side handle on one spawned decode worker.

    Created by :class:`ClusterRouter` (or directly for a single remote
    scheduler).  ``submit`` returns a local :class:`Future` resolved by the
    receiver thread when the worker ships the stream's tokens; ``report`` /
    ``save_aot`` / ``drain`` are synchronous round-trips.  Any channel
    failure — the process crashed, was killed, or closed the socket
    uncleanly — fails every outstanding future with
    :class:`ClusterWorkerError` and flips :attr:`alive`.
    """

    def __init__(self, spec: WorkerSpec, *, name: str, sock_dir: str,
                 ctx=None, start_timeout: float = 300.0,
                 trace_id: str | None = None):
        self.spec = spec
        self.name = name
        self.draining = False
        self.final_report: DecodeReport | None = None
        self.last_report: DecodeReport | None = None
        #: observability harvested from report/drain replies
        self.warnings: list[str] = []
        self.logs: list[obs.LogEvent] = []
        self.spans_dropped = 0
        #: the worker's kernel launches per route since boot, as of its
        #: latest report/drain reply (``{kernel: {route: n}}``)
        self.launches_by_route: dict[str, dict[str, int]] = {}
        self._spans: list[obs.Span] = []
        self._labels: dict[int, str] = {}
        self._alive = True
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._inflight: dict[int, Future] = {}
        self._sync: dict[int, Future] = {}
        self._ids = itertools.count()
        ctx = ctx or multiprocessing.get_context("spawn")

        sock_path = str(Path(sock_dir) / f"{name}.sock")
        listener = socket.socket(socket.AF_UNIX)
        listener.bind(sock_path)
        listener.listen(1)
        listener.settimeout(start_timeout)
        self.process = ctx.Process(
            target=_worker_main, args=(spec, sock_path, trace_id),
            name=f"repro-torch-cluster-{name}", daemon=True)
        self.process.start()
        try:
            self._conn, _ = listener.accept()
        finally:
            listener.close()
        first = _recv(self._conn)   # ("ready",) or ("fatal", msg)
        if first[0] != "ready":
            self.process.join(timeout=10.0)
            self._alive = False
            raise ClusterWorkerError(f"worker {name} failed to boot: {first[1]}")
        self._receiver = threading.Thread(
            target=self._recv_loop, name=f"cluster-recv-{name}", daemon=True)
        self._receiver.start()

    # -- liveness ------------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._alive

    @property
    def accepting(self) -> bool:
        return self._alive and not self.draining

    # -- client surface ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               eos: int | None = None, tctx: str | None = None) -> Future:
        """Ship one decode stream to the worker; resolves to 1-D int32 tokens.

        ``tctx`` is the per-submission trace id stamped by the router; it
        rides the frame so worker-side spans join the parent's timeline."""
        prompt = np.asarray(prompt)
        fut: Future = Future()
        with self._state_lock:
            if not self._alive:
                raise ClusterWorkerError(f"worker {self.name} is dead")
            rid = next(self._ids)
            self._inflight[rid] = fut
        try:
            _send(self._conn, self._send_lock,
                  ("submit", rid, prompt, int(max_new_tokens), eos, tctx))
        except OSError as e:
            self._on_death(e)
            raise ClusterWorkerError(
                f"worker {self.name} channel closed during submit") from e
        return fut

    def start(self) -> None:
        """Release a ``hold_admission`` scheduler (no-op otherwise)."""
        _send(self._conn, self._send_lock, ("start",))

    def report(self, timeout: float | None = 120.0) -> DecodeReport:
        rep, payload = self._roundtrip(("report",), timeout)
        self._ingest_obs(payload)
        self.last_report = rep
        return rep

    def save_aot(self, path, timeout: float | None = 600.0) -> dict:
        """Have the worker persist its (warm) plan to ``path``."""
        return self._roundtrip(("save_aot", str(path)), timeout)

    def drain(self, timeout: float | None = 600.0) -> DecodeReport:
        """Graceful shutdown: finish every in-flight stream, return the
        final report, and leave the routing set.  Idempotent-ish: a second
        drain on a drained worker returns the stored final report."""
        if self.final_report is not None:
            return self.final_report
        self.draining = True
        rep, payload = self._roundtrip(("drain",), timeout)
        self._ingest_obs(payload)
        self.final_report = self.last_report = rep
        self.process.join(timeout=30.0)
        with self._state_lock:
            self._alive = False
        return rep

    # -- observability harvest ----------------------------------------------

    def _ingest_obs(self, payload: dict | None) -> None:
        """Fold one report/drain reply's observability shipment into the
        parent-side buffers (see :func:`_obs_payload`)."""
        if not payload:
            return
        self._spans.extend(payload.get("spans", ()))
        for ev in payload.get("logs", ()):
            self.logs.append(ev)
            if ev.level == "warning":
                self.warnings.append(ev.message)
        self.spans_dropped = payload.get("spans_dropped", self.spans_dropped)
        self.launches_by_route = payload.get("launches", self.launches_by_route)
        self._labels.update(payload.get("labels", {}))

    def take_obs(self) -> tuple[list[obs.Span], dict[int, str]]:
        """Pop the harvested spans (+ pid labels) for folding into the
        parent tracer; warnings/logs stay — they feed ClusterReport."""
        spans, self._spans = self._spans, []
        return spans, dict(self._labels)

    def kill(self) -> None:
        """Hard-kill the worker process (crash simulation / last resort).
        The receiver thread observes the channel EOF and fails every
        in-flight future with :class:`ClusterWorkerError`."""
        self.process.kill()
        self.process.join(timeout=30.0)

    # -- internals -----------------------------------------------------------

    def _roundtrip(self, msg: tuple, timeout: float | None):
        fut: Future = Future()
        with self._state_lock:
            if not self._alive:
                raise ClusterWorkerError(f"worker {self.name} is dead")
            tag = next(self._ids)
            self._sync[tag] = fut
        try:
            _send(self._conn, self._send_lock, (msg[0], tag, *msg[1:]))
        except OSError as e:
            self._on_death(e)
            raise ClusterWorkerError(
                f"worker {self.name} channel closed during {msg[0]}") from e
        ok, payload = fut.result(timeout)
        if not ok:
            raise ClusterWorkerError(f"worker {self.name} {msg[0]} failed: {payload}")
        return payload

    def _recv_loop(self) -> None:
        try:
            while True:
                msg = _recv(self._conn)
                if msg[0] == "result":
                    _, rid, tokens, err = msg
                    with self._state_lock:
                        fut = self._inflight.pop(rid, None)
                    if fut is None:
                        continue
                    if err is None:
                        _resolve(fut, result=tokens)
                    else:
                        _resolve(fut, exception=RuntimeError(
                            f"worker {self.name} stream failed: {err}"))
                elif msg[0] == "reply":
                    _, tag, ok, payload = msg
                    with self._state_lock:
                        fut = self._sync.pop(tag, None)
                    if fut is not None:
                        _resolve(fut, result=(ok, payload))
        except (EOFError, OSError) as e:
            self._on_death(e)

    def _on_death(self, cause: BaseException) -> None:
        """Channel gone: fail everything outstanding, exactly once."""
        with self._state_lock:
            if not self._alive:
                return
            self._alive = False
            inflight = list(self._inflight.values()) + list(self._sync.values())
            self._inflight.clear()
            self._sync.clear()
        if self.draining and not inflight:
            return              # clean post-drain EOF, nothing stranded
        err = ClusterWorkerError(
            f"worker {self.name} died ({type(cause).__name__}: {cause}); "
            f"its in-flight streams are lost")
        for fut in inflight:
            _resolve(fut, exception=err)
        try:
            self._conn.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the front-door router
# ---------------------------------------------------------------------------


class ClusterRouter:
    """Route decode traffic over N spawned workers with prefix affinity.

    Placement: prompts with at least one full page of tokens hash their
    *first page* — ``sha256(dtype ‖ prompt[:page_size])`` — onto the live
    worker set, so all traffic sharing a first-page prefix lands on one
    worker and its LRU prefix index (:class:`~repro_torch.serve.StateSpec`
    ``share_prefixes``) converts the collisions into CoW page hits.
    Prompts shorter than a page carry nothing shareable and spill
    round-robin.  Placement hashes over the *live* worker set, so a death
    or drain reshuffles affinity (documented trade-off: stability against
    the common case, simplicity against membership churn).

        spec = WorkerSpec(program="repro_torch.models.programs:export_decode_lm",
                          program_kwargs={"vocab": 32, "d_model": 16},
                          capacity=4)
        with ClusterRouter(spec, workers=2) as router:
            out = router.decode(prompt, max_new_tokens=8)
            print(router.report().table())

    ``close()`` drains every live worker (graceful); a worker that dies
    mid-flight fails only its own futures (:class:`ClusterWorkerError`)
    and leaves the routing set — later traffic lands on the survivors.
    """

    def __init__(self, spec: WorkerSpec, workers: int = 2, *,
                 start_timeout: float = 300.0,
                 tracer: "obs.Tracer | None" = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1: {workers}")
        # spawn passes sys.path to the child: make sure our src dir survives
        # the trip as an absolute path (the parent may have used a relative
        # PYTHONPATH entry and a different cwd)
        src = str(Path(__file__).resolve().parents[2])
        if src not in sys.path:
            sys.path.insert(0, src)
        # tracing: when the parent traces (explicit tracer or one installed
        # via obs.session), worker span rings turn on and every worker
        # tracer is rooted at the parent's trace id — a whole run folds
        # into one timeline.
        self.tracer = tracer if tracer is not None else obs.active()
        if self.tracer is not None and not spec.trace:
            spec = dataclasses.replace(spec, trace=True)
        self._trace_id = self.tracer.trace_id if self.tracer is not None else None
        self.worker_spans = 0
        self._archived_warnings: list[str] = []
        self._archived_dropped = 0
        self._archived_launches: list[dict] = []
        self.spec = spec
        if spec.backend != "cpu":
            # one nvcc per source here, not one per worker for the same source
            build.build(library.SOURCES)
        self._ctx = multiprocessing.get_context("spawn")
        self._sock_dir = tempfile.mkdtemp(prefix="repro-torch-cluster-")
        self._lock = threading.Lock()
        self._rr = 0
        self._gen = itertools.count()
        self.routed_affinity = 0
        self.routed_spill = 0
        self._started = 0
        self._page_size = (spec.state.page_size
                           if spec.state is not None and spec.state.paged else 0)
        # the workers boot side by side: each is a fresh interpreter that
        # imports torch and builds (or loads) its plan, seconds apiece
        names = [f"w{i}-g{next(self._gen)}" for i in range(workers)]
        with ThreadPoolExecutor(workers, thread_name_prefix="cluster-boot") as pool:
            booting = [pool.submit(self._boot, name, start_timeout) for name in names]
        booted, failed = [], []
        for fut in booting:
            try:
                booted.append(fut.result())
            except Exception as e:  # noqa: BLE001 — reraised below, after cleanup
                failed.append(e)
        if failed:
            for w in booted:
                w.kill()
            shutil.rmtree(self._sock_dir, ignore_errors=True)
            raise failed[0]
        self._started = workers
        self.workers: list[ClusterWorker] = booted

    def _boot(self, name: str, start_timeout: float) -> ClusterWorker:
        return ClusterWorker(self.spec, name=name, sock_dir=self._sock_dir,
                             ctx=self._ctx, start_timeout=start_timeout,
                             trace_id=self._trace_id)

    def _spawn(self, start_timeout: float = 300.0) -> ClusterWorker:
        worker = self._boot(f"w{self._started}-g{next(self._gen)}", start_timeout)
        self._started += 1
        return worker

    def _harvest(self) -> None:
        """Fold every worker's harvested spans into the parent tracer."""
        for w in self.workers:
            spans, labels = w.take_obs()
            self.worker_spans += len(spans)
            if self.tracer is not None and spans:
                self.tracer.extend(spans, labels=labels)

    # -- placement -----------------------------------------------------------

    def _affinity(self, prompt: np.ndarray) -> int | None:
        return prefix_affinity(prompt, self._page_size)

    def _live(self) -> list[ClusterWorker]:
        return [w for w in self.workers if w.accepting]

    def _pick(self, prompt: np.ndarray) -> ClusterWorker:
        live = self._live()
        if not live:
            raise ClusterWorkerError("no live workers to route to")
        key = self._affinity(prompt)
        with self._lock:
            if key is None:
                worker = live[self._rr % len(live)]
                self._rr += 1
                self.routed_spill += 1
            else:
                worker = live[key % len(live)]
                self.routed_affinity += 1
        return worker

    # -- client surface ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               eos: int | None = None) -> Future:
        """Route one decode stream; resolves to its 1-D int32 tokens.

        A worker discovered dead at submit time is retired from routing and
        the stream is re-placed on the survivors (the failed attempt never
        reached the dead worker's scheduler, so re-placement cannot
        double-serve it)."""
        prompt = np.asarray(prompt)
        tctx = (obs.next_submission_id(self._trace_id)
                if self._trace_id is not None else None)
        while True:
            worker = self._pick(prompt)
            if self.tracer is not None:
                self.tracer.event("route", obs.SUBMIT, trace_id=tctx,
                                  args={"worker": worker.name,
                                        "prompt_len": int(prompt.shape[0])})
            try:
                return worker.submit(prompt, max_new_tokens, eos=eos, tctx=tctx)
            except ClusterWorkerError:
                if not self._live():
                    raise

    def decode(self, prompt, max_new_tokens: int, *,
               eos: int | None = None,
               timeout: float | None = None) -> np.ndarray:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, max_new_tokens, eos=eos).result(timeout)

    def start(self) -> None:
        """Release every ``hold_admission`` scheduler in one broadcast."""
        for w in self._live():
            w.start()

    def report(self) -> ClusterReport:
        """Aggregate :class:`ClusterReport` over every worker ever started.

        Live workers are queried now; drained workers contribute their
        final report; a crashed worker contributes its last successful
        report (its unreported tail died with it)."""
        reports = []
        for w in self.workers:
            if w.accepting:
                try:
                    reports.append(w.report())
                    continue
                except ClusterWorkerError:
                    pass
            if w.final_report is not None:
                reports.append(w.final_report)
            elif w.last_report is not None:
                reports.append(w.last_report)
        self._harvest()
        warnings = list(self._archived_warnings)
        dropped = self._archived_dropped
        for w in self.workers:
            warnings.extend(w.warnings)
            dropped += w.spans_dropped
        with self._lock:
            routed_affinity, routed_spill = self.routed_affinity, self.routed_spill
        return ClusterReport(
            workers=self._started,
            live_workers=len(self._live()),
            routed_affinity=routed_affinity,
            routed_spill=routed_spill,
            worker_reports=tuple(reports),
            worker_warnings=tuple(warnings),
            worker_spans=self.worker_spans,
            spans_dropped=dropped,
        )

    def launches_by_route(self) -> dict[str, dict[str, int]]:
        """Kernel launches per route summed over every worker ever started,
        each as of its latest report/drain reply (call after
        :meth:`report`): the workers' own counts, reset when each booted."""
        total: dict[str, dict[str, int]] = {}
        for counts in self._archived_launches + [w.launches_by_route
                                                 for w in self.workers]:
            for kernel, routes in counts.items():
                acc = total.setdefault(kernel, dict.fromkeys(routes, 0))
                for route, n in routes.items():
                    acc[route] = acc.get(route, 0) + n
        return total

    def save_aot(self, path) -> dict:
        """Persist one live worker's warm plan (they are interchangeable —
        same spec, same traffic shapes reach the same units)."""
        live = self._live()
        if not live:
            raise ClusterWorkerError("no live worker to save an AOT cache from")
        return live[0].save_aot(path)

    # -- membership ----------------------------------------------------------

    def drain_worker(self, index: int) -> DecodeReport:
        """Gracefully drain ``workers[index]``: it finishes its in-flight
        streams, reports, and leaves the routing set."""
        return self.workers[index].drain()

    def rejoin_worker(self, index: int, *,
                      start_timeout: float = 300.0) -> ClusterWorker:
        """Replace a drained/dead ``workers[index]`` with a fresh process
        from the same spec (warm-booted when the spec names an AOT cache)."""
        old = self.workers[index]
        if old.accepting:
            raise ValueError(f"worker {old.name} is still serving; drain it first")
        # keep the departing worker's observability on the record: its
        # replacement must not silently erase boot warnings or drop counts
        spans, labels = old.take_obs()
        self.worker_spans += len(spans)
        if self.tracer is not None and spans:
            self.tracer.extend(spans, labels=labels)
        self._archived_warnings.extend(old.warnings)
        self._archived_dropped += old.spans_dropped
        self._archived_launches.append(old.launches_by_route)
        worker = self._spawn(start_timeout)
        self.workers[index] = worker
        return worker

    def close(self) -> None:
        """Drain every live worker, then remove the channel directory."""
        try:
            for w in self.workers:
                if w.alive:
                    try:
                        w.drain()
                    except ClusterWorkerError:
                        pass    # died while draining; futures already failed
        finally:
            self._harvest()     # drain replies carried the final spans
            for w in self.workers:
                if w.process.is_alive():
                    w.kill()
            shutil.rmtree(self._sock_dir, ignore_errors=True)

    def __enter__(self) -> "ClusterRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
