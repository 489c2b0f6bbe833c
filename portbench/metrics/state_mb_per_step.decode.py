"""Crossing and placement: decode-state MB (1e6 bytes) marshalled across
the crossings per decode step (``DecodeReport.state_bytes`` over
``steps``): both page pools, the block table and the lengths on every paged
step, and the prefills' K/V outputs."""


def read(record):
    c = record["counters"]
    return c["state_bytes"] / c["steps"] / 1e6 if c["steps"] else None
