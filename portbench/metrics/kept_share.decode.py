"""Crossing and placement: the share of the unit output bytes of a decode
scheduler's serving calls (prefills and steps) that stay on the device
instead of being copied back: ``DecodeReport.kept_bytes`` over it plus
``fetched_bytes``, in the untraced half, %.  A program without the counters
reads nothing."""


def read(record):
    c = record["counters"]
    if "kept_bytes" not in c or "fetched_bytes" not in c:
        return None
    total = c["kept_bytes"] + c["fetched_bytes"]
    return 100.0 * c["kept_bytes"] / total if total else None
