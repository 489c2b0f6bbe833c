"""Decode scheduler: live stream rows over the capacity rows stepped
(``DecodeReport``), in %."""


def read(record):
    c = record["counters"]
    return 100.0 * c["live_rows"] / c["slot_rows"] if c["slot_rows"] else None
