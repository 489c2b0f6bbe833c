"""Model step: the model FLOPs of the prompts prefilled and of the tokens
the steps emitted in the untraced half of the window, the attention over
each stream's live positions included, over that half times the float32
tensor-core peak (495/3 TFLOP/s), in %."""
from portbench import work


def read(record):
    c = record["counters"]
    if not c["admitted"] and not c["live_rows"]:
        return None
    m = record["config"]["model"]
    t = record["cell"]["traffic"]["prompt_tokens"]
    flops = (c["admitted"] * work.attn_lm_prefill_flops(m, t)
             + c["live_rows"] * work.attn_lm_token_flops(m)
             + work.paged_step_flops(c["live_rows"], c["cache_rows_valid"], m["d_model"]))
    return 100.0 * flops / (record["window_s"] * work.FP32_TC_FLOPS)
