"""Request batching: mean wait of a request in the server's queue before
its batch ran (``ServerReport``), in ms."""


def read(record):
    c = record["counters"]
    return 1e3 * c["queue_wait_total"] / c["requests"] if c["requests"] else None
