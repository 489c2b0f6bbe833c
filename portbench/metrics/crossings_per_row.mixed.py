"""Crossing and placement: guest-to-host crossings per request row served
(``ServerReport``)."""


def read(record):
    c = record["counters"]
    return c["crossings"] / c["request_rows"] if c["request_rows"] else None
