"""The device's side of a traced run: ``torch.profiler`` over the window,
reduced to busy time, kernel time by name, and idle time by what the host
was doing.

Only device activity is recorded (kernels, copies, fills): the host's side
comes from the program's ``obs`` spans and the harness's own spans, which
cost far less than the profiler's host events on a path of thousands of
launches a second.  The two clocks are tied by a marker: after a
synchronise, with the device idle, the host notes ``perf_counter_ns`` and
launches one short kernel; that kernel's start is taken as the same moment.
"""
from __future__ import annotations

import bisect
import heapq
import re
import time

MARKER_CYCLES = 100_000


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and argument list (a copy's
    or a fill's name whole)."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:limit]
    name = re.sub(r"^void ", "", name)
    cut = name.find("(")
    name = name if cut <= 0 else name[:cut]
    return name[:limit]


class DeviceTrace:
    """Start before the window opens; :meth:`stop` after it drained."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.mark_ns = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.mark_ns = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.stop()

    def intervals(self) -> list[tuple[float, float, str]]:
        """Every device activity as (start us, end us, name) on the trace's
        clock, in order.  Read from the profiler's raw records: building its
        per-event Python objects would take minutes on a window of millions
        of launches."""
        cuda = self.torch.autograd.DeviceType.CUDA
        evs = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                a = e.start_ns() / 1e3
                evs.append((a, a + e.duration_ns() / 1e3, e.name()))
        evs.sort()
        return evs


def union(intervals):
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class SpanTimeline:
    """For any moment, the innermost host span open then: the shortest of
    the spans that cover it, preferring the program's spans to the
    harness's own."""

    def __init__(self, spans):
        bounds = []
        for s in spans:
            if s.dur_ns:
                bounds.append((s.start_ns, 0, s))
                bounds.append((s.start_ns + s.dur_ns, 1, s))
        bounds.sort(key=lambda x: (x[0], x[1]))
        self.starts: list[int] = []
        self.labels: list[str | None] = []
        heap: list = []
        closed: set[int] = set()
        for t, kind, s in bounds:
            if kind == 0:
                rank = (s.kind == "harness", s.dur_ns, id(s))
                heapq.heappush(heap, (rank, s))
            else:
                closed.add(id(s))
            while heap and id(heap[0][1]) in closed:
                heapq.heappop(heap)
            label = f"{heap[0][1].kind}:{heap[0][1].name}" if heap else None
            if self.starts and self.starts[-1] == t:
                self.labels[-1] = label
            else:
                self.starts.append(t)
                self.labels.append(label)

    def at(self, t_ns: int) -> str:
        i = bisect.bisect_right(self.starts, t_ns) - 1
        label = self.labels[i] if i >= 0 else None
        return label or "no host span"


def reduce(trace: DeviceTrace, t0_ns: int, t1_ns: int, spans) -> dict:
    """Busy time, kernel time by name and idle time by host span over the
    traced window [t0_ns, t1_ns] (perf_counter_ns)."""
    evs = trace.intervals()
    if not evs:
        return {"window_s": (t1_ns - t0_ns) / 1e9, "busy_s": 0.0, "kernels": {},
                "idle_by_host": {}, "events": 0}
    sleeps = [e for e in evs if "sleep" in e[2].lower() or "spin" in e[2].lower()]
    marker = sleeps[0] if sleeps else evs[0]
    base_us = marker[0] - trace.mark_ns / 1e3        # trace us = base + perf ns / 1e3
    w0, w1 = base_us + t0_ns / 1e3, base_us + t1_ns / 1e3
    kernels: dict[str, dict] = {}
    clipped = []
    for a, b, name in evs:
        if (a, b, name) == marker:
            continue
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        k = kernels.setdefault(name, {"seconds": 0.0, "count": 0})
        k["seconds"] += (b - a) / 1e6
        k["count"] += 1
    busy = union(clipped)
    busy_s = sum(b - a for a, b in busy) / 1e6
    timeline = SpanTimeline(spans)
    idle: dict[str, float] = {}
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            mid_ns = int(((edge + a) / 2 - base_us) * 1e3)
            label = timeline.at(mid_ns)
            idle[label] = idle.get(label, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_s, "kernels": kernels,
            "idle_by_host": idle, "events": len(clipped)}


def breakdown(dev: dict, top: int = 10) -> dict:
    ops: dict[str, float] = {}
    for name, k in dev["kernels"].items():
        short = short_name(name)
        ops[short] = ops.get(short, 0.0) + k["seconds"]
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[n, s] for n, s in rank(ops)],
            "idle_gaps": [[n, s] for n, s in rank(dev["idle_by_host"])]}
