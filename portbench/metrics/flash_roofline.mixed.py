"""Kernels: the flash attention forward (float32, the ``tf32x3`` body) on
the served shape, as a share of its roofline: the least time ``work.py``
gives for every call of the traced window (32 a batch, each over the
batch's padded rows), over the device time of those calls in the
profiler's trace, in %."""
import re

from portbench import work

KERNEL = re.compile(r"attn_tf32::fwd_kernel")


def read(record):
    dev = record["device"]
    if not dev:
        return None
    seconds = sum(k["seconds"] for n, k in dev["kernels"].items() if KERNEL.search(n))
    rows = record["traced_counters"]["padded_rows"]
    if not seconds or not rows:
        return None
    m = record["config"]["model"]
    hq, hkv = m["num_attention_heads"], m["num_key_value_heads"]
    t = record["cell"]["traffic"]["prompt_tokens"]
    bound = rows * m["num_hidden_layers"] * work.flash_bound_s(
        1, hq, hkv, t, m["hidden_size"] // hq)
    return 100.0 * bound / seconds
