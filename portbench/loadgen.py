"""The one traffic generator, and the closed loop that offers its requests.

A cell's traffic is a dict of parameters read from its workload file:

``clients``
    Closed-loop callers: each sends its next request when its last one
    returns.
``prompt_tokens``
    Tokens in each request row.
``shared_prefix_tokens``
    Leading tokens that every prompt of a run shares (one seeded prefix);
    the rest of each prompt is its own.  Default 0.
``rows_cycle``
    Rows a request carries, as a multiset that every client walks through
    in a seeded order, cycle after cycle.  Default ``[1]``.
``new_tokens``
    ``{"min": a, "max": b, "step": s}``: tokens a decode stream asks for,
    a, a + s, ... up to b once a cycle (s defaults to 1), in a seeded
    order.  Absent for requests that decode nothing.

Every seed gets the same sizes in another order, so the work of a window
does not move with the seed; only token ids and orders do.  Request ``i``
of client ``c`` is a pure function of (seed, c, i).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

_ROWS, _NEW, _PROMPT, _PREFIX = 1, 2, 3, 4       # independent random streams


def seed_words(seed: int) -> list[int]:
    """A whole-number seed of any size or sign as SeedSequence words."""
    s = int(seed) % 2**128
    return [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, (s >> 64) & 0xFFFFFFFF, s >> 96]


@dataclasses.dataclass(frozen=True)
class Request:
    client: int
    index: int
    tokens: np.ndarray              # (rows, prompt_tokens) int32
    new_tokens: int | None

    @property
    def rows(self) -> int:
        return int(self.tokens.shape[0])


class Traffic:
    """The requests of one run, drawn from ``seed`` and the cell's
    parameters, with token ids in ``[0, vocab)``."""

    def __init__(self, params: dict, seed: int, vocab: int):
        self.clients = int(params["clients"])
        self.prompt_tokens = int(params["prompt_tokens"])
        self.shared = int(params.get("shared_prefix_tokens", 0))
        self.rows_cycle = [int(r) for r in params.get("rows_cycle", [1])]
        nt = params.get("new_tokens")
        self.new_cycle = None if nt is None else list(
            range(int(nt["min"]), int(nt["max"]) + 1, int(nt.get("step", 1))))
        if not 0 <= self.shared < self.prompt_tokens:
            raise ValueError(f"shared_prefix_tokens {self.shared} must be below "
                             f"prompt_tokens {self.prompt_tokens}")
        self.seed = seed_words(seed)
        self.vocab = int(vocab)
        self.prefix = self._rng(_PREFIX).integers(0, vocab, self.shared, dtype=np.int32)

    def _rng(self, *words) -> np.random.Generator:
        return np.random.default_rng([*self.seed, *words])

    def _cycled(self, cycle: list, tag: int, c: int, i: int):
        k, pos = divmod(i, len(cycle))
        return cycle[int(self._rng(tag, c, k).permutation(len(cycle))[pos])]

    def request(self, c: int, i: int) -> Request:
        rows = self._cycled(self.rows_cycle, _ROWS, c, i)
        new = None if self.new_cycle is None else self._cycled(self.new_cycle, _NEW, c, i)
        own = self._rng(_PROMPT, c, i).integers(
            0, self.vocab, (rows, self.prompt_tokens - self.shared), dtype=np.int32)
        tokens = np.concatenate([np.broadcast_to(self.prefix, (rows, self.shared)), own],
                                axis=1)
        return Request(c, i, np.ascontiguousarray(tokens), new)


@dataclasses.dataclass
class Completion:
    request: Request
    submit: float                   # perf_counter seconds
    done: float
    ok: bool
    answer: object = None           # what the driver kept for the check
    error: str | None = None


class ClosedLoop:
    """``clients`` threads, each sending its requests one after another
    through ``submit`` (blocking) until :meth:`stop`.  Times are taken on
    the client's side: from just before the call to just after it
    returns.  ``tracer`` (an ``obs.Tracer`` or None) gets a ``harness``
    span around every call."""

    def __init__(self, traffic: Traffic, submit, tracer=None):
        self.traffic = traffic
        self.submit = submit
        self.tracer = tracer
        self.completions: list[Completion] = []
        self.submitted = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._client, args=(c,), daemon=True,
                                          name=f"bench-client-{c}")
                         for c in range(traffic.clients)]

    def start(self) -> float:
        t0 = time.perf_counter()
        for t in self._threads:
            t.start()
        return t0

    def stop(self) -> float:
        """No client sends again; returns the closing time."""
        self._stop.set()
        return time.perf_counter()

    def join(self, deadline: float) -> bool:
        """Wait until every request in flight has returned, or until the
        perf_counter ``deadline``; True when all returned."""
        for t in self._threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return not any(t.is_alive() for t in self._threads)

    def _client(self, c: int) -> None:
        i = 0
        while not self._stop.is_set():
            req = self.traffic.request(c, i)
            with self._lock:
                self.submitted += 1
            t = time.perf_counter()
            try:
                answer, ok, err = self.submit(req), True, None
            except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
                answer, ok, err = None, False, f"{type(e).__name__}: {e}"
            done = time.perf_counter()
            if self.tracer is not None:
                self.tracer.add("request", "harness", int(t * 1e9), int((done - t) * 1e9))
            with self._lock:
                self.completions.append(Completion(req, t, done, ok, answer, err))
            i += 1
