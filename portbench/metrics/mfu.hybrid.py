"""Model step: the model FLOPs of the request rows answered in the
untraced half of the window (``work_hybrid.hybrid_forward_flops`` at the
served length), over that half times the float32 tensor-core peak (495/3
TFLOP/s), in %."""
from portbench import work, work_hybrid


def read(record):
    rows = record["counters"].get("request_rows")
    if not rows:
        return None
    t = record["cell"]["traffic"]["prompt_tokens"]
    flops = rows * work_hybrid.hybrid_forward_flops(record["config"], t)
    return 100.0 * flops / (record["window_s"] * work.FP32_TC_FLOPS)
