"""Kernels: the paged decode attention kernel as a share of its roofline:
the bytes of the live K/V rows each step read once, with each slot's q,
fresh k/v row and output, at 3.35 TB/s, over the device time of its calls
in the profiler's trace, in %."""
import re

from portbench import work

KERNEL = re.compile(r"split::split_kernel|paged_decode_attention_kernel")


def read(record):
    dev = record["device"]
    if not dev:
        return None
    seconds = sum(k["seconds"] for n, k in dev["kernels"].items() if KERNEL.search(n))
    c = record["traced_counters"]
    if not seconds or not c["kernel_steps"]:
        return None
    d = record["config"]["model"]["d_model"]
    nbytes = work.paged_step_bytes(c["slot_rows"], c["cache_rows_valid"], d)
    flops = work.paged_step_flops(c["slot_rows"], c["cache_rows_valid"], d)
    return 100.0 * work.bound_s(flops, nbytes) / seconds
