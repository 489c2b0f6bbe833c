"""Model step: device-clock ms of the offload units per batched entry call:
each unit's span from the stream reaching its start event to its end event
(CUDA events, the ``device_ms`` arg of the program's ``unit`` spans; their
own interval is the host's enqueue), summed over every thread, over the
traced half's ``batches``.  The server's workers share one stream, so a
span also holds the other worker's kernels and the device's idle between
the events: not the unit's busy time.  A program or a device without the
arg reads nothing."""


def read(record):
    batches = record["traced_counters"].get("batches")
    device_ms = [s.args["device_ms"] for s in record["spans"]
                 if s.kind == "unit" and s.args and "device_ms" in s.args]
    if not batches or not device_ms:
        return None
    return sum(device_ms) / batches
