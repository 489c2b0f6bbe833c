"""Kernels: the SSD scan as a share of its roofline: the least time
``work_hybrid.py`` gives the recurrence's work of every launch in the traced
half (the program's ``ssd`` spans: b, t, h, n, p), over the device time of
the SSD kernels in the profiler's trace, either body, in %.  A program
without the spans reads nothing."""
import re

from portbench import work_hybrid

KERNEL = re.compile(r"ssd_scan_kernel|ssd_mma::scan_kernel")


def read(record):
    dev = record["device"]
    spans = [s for s in record["spans"] if s.kind == "ssd" and s.args]
    if not dev or not spans:
        return None
    seconds = sum(k["seconds"] for n, k in dev["kernels"].items() if KERNEL.search(n))
    if not seconds:
        return None
    bound = sum(work_hybrid.ssd_bound_s(*(s.args[k] for k in "bthnp")) for s in spans)
    return 100.0 * bound / seconds
