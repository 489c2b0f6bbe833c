"""Crossing and placement: guest-to-host crossings per token emitted
(``DecodeReport``)."""


def read(record):
    c = record["counters"]
    return c["crossings"] / c["tokens"] if c["tokens"] else None
