"""Crossing and placement: the share of the argument bytes a decode step's
crossings hand to their units that pass by reference, already on the device,
instead of being copied there: ``DecodeReport.step_resident_bytes`` over it
plus ``step_placed_bytes``, in the untraced half, %.  A program without the
counters reads nothing."""


def read(record):
    c = record["counters"]
    if "step_resident_bytes" not in c or "step_placed_bytes" not in c:
        return None
    total = c["step_resident_bytes"] + c["step_placed_bytes"]
    return 100.0 * c["step_resident_bytes"] / total if total else None
