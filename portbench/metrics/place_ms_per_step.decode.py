"""Crossing and placement: host ms a decode step's crossings spend placing
their arguments on the device (both page pools, the block table, the
lengths and the tokens, then the head's hidden rows): the program's
``DecodeReport.step_place_s`` over ``steps``, in the untraced half.  A
program without the counter reads nothing."""


def read(record):
    c = record["counters"]
    if "step_place_s" not in c or not c.get("steps"):
        return None
    return 1e3 * c["step_place_s"] / c["steps"]
