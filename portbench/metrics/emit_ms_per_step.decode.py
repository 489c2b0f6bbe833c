"""Decode scheduler: host ms spent after each call (page appends, sampling,
counter records) per decode step: each thread's union of the program's
``emit`` spans, summed, over the steps of the traced half.  A program
without the spans reads nothing."""
from portbench.devtrace import union


def read(record):
    steps = record["traced_counters"].get("steps")
    by_tid: dict = {}
    for s in record["spans"]:
        if s.kind == "emit" and s.dur_ns:
            by_tid.setdefault(s.tid, []).append((s.start_ns, s.start_ns + s.dur_ns))
    if not steps or not by_tid:
        return None
    return sum(b - a for spans in by_tid.values() for a, b in union(spans)) / 1e6 / steps
