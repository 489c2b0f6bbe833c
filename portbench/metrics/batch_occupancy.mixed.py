"""Request batching: real request rows over the rows the buckets padded
them to (``ServerReport``), in %."""


def read(record):
    c = record["counters"]
    return 100.0 * c["request_rows"] / c["padded_rows"] if c["padded_rows"] else None
