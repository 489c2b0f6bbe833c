"""Kernels: the SSD kernels' device time (either body, in the profiler's
trace) over the traced half's busy time, in %."""
import re

KERNEL = re.compile(r"ssd_scan_kernel|ssd_mma::scan_kernel")


def read(record):
    dev = record["device"]
    if not dev or not dev["busy_s"]:
        return None
    seconds = sum(k["seconds"] for n, k in dev["kernels"].items() if KERNEL.search(n))
    if not seconds:
        return None
    return 100.0 * seconds / dev["busy_s"]
