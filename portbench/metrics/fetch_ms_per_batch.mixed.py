"""Crossing and placement: host ms the crossings spend copying results to
host memory (the logits above all) per batched entry call: the program's
``fetch`` spans summed over every thread, over the traced half's
``batches``.  A program without the spans reads nothing."""


def read(record):
    batches = record["traced_counters"].get("batches")
    fetch = [s.dur_ns for s in record["spans"] if s.kind == "fetch" and s.dur_ns]
    if not batches or not fetch:
        return None
    return sum(fetch) / 1e6 / batches
