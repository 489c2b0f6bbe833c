"""Request batching: mean wait of a request between the dispatcher's cut
of its batch and a worker's start on it (``ServerReport.pool_wait_total``
over ``requests``, in the untraced half), in ms: the part of
``queue_wait_ms.mixed`` that no batching window explains.  A program
without the counter reads nothing."""


def read(record):
    c = record["counters"]
    if "pool_wait_total" not in c or not c.get("requests"):
        return None
    return 1e3 * c["pool_wait_total"] / c["requests"]
