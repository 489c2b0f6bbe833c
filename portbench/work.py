"""Peaks of the card and the work of each measured shape: the yardstick that
roofline shares and ``mfu`` divide by.

Frozen here, beside the benchmark, so that no change to the program can move
them.  Peaks are NVIDIA's H100 SXM data sheet (dense rates, no sparsity, at
the full 700 W power limit): HBM 3.35 TB/s, bf16 989 TFLOP/s, TF32 495
TFLOP/s, float32 outside the tensor cores 67 TFLOP/s.

Both configurations compute in float32.  A float32 product is counted at the
float32-accurate tensor-core rate, three TF32 terms a product, 495/3
TFLOP/s: the rate a 3xTF32 GEMM or attention body could reach.  Counting
float32 products at the slower CUDA-core rate would let such a kernel read
above 100%.

FLOPs count a multiply-add as two operations.  Bytes count each input read
once and each output written once, whatever a kernel reads again.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_SIMT_FLOPS = 67e12
FP32_TC_FLOPS = TF32_FLOPS / 3       # float32-accurate products on the tensor cores
F32 = 4                              # bytes of a float32


def bound_s(flops: float, nbytes: float, peak_flops: float = FP32_TC_FLOPS) -> float:
    """The least time the card could take: the larger of the compute and
    the memory term."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


# -- attention kernels --------------------------------------------------------

def causal_pairs(t: int) -> int:
    """(query, key) pairs a causal mask keeps over t positions."""
    return t * (t + 1) // 2


def flash_flops(b: int, hq: int, t: int, d: int, causal: bool = True) -> int:
    """Q.K^T and P.V of one forward over (b, hq, t, d) queries against t keys."""
    pairs = causal_pairs(t) if causal else t * t
    return 4 * b * hq * pairs * d


def flash_bytes(b: int, hq: int, hkv: int, t: int, d: int, itemsize: int = F32) -> int:
    """q, k, v read once, o written once."""
    return (2 * b * hq * t * d + 2 * b * hkv * t * d) * itemsize


def flash_bound_s(b, hq, hkv, t, d, causal=True) -> float:
    return bound_s(flash_flops(b, hq, t, d, causal), flash_bytes(b, hq, hkv, t, d))


def paged_step_bytes(rows: int, valid_positions: int, d: int, itemsize: int = F32) -> int:
    """One paged decode step: the live K and V rows read once, and per stream
    q, the fresh k and v rows read and the output written."""
    return 2 * valid_positions * d * itemsize + 4 * rows * d * itemsize


def paged_step_flops(rows: int, valid_positions: int, d: int) -> int:
    """Scores and weighted values over every live position and the fresh row."""
    return 4 * (valid_positions + rows) * d


# -- whole models ---------------------------------------------------------------

def dense_forward_flops(cfg: dict, t: int) -> int:
    """One sequence of t tokens through the dense forward the mixed path
    serves: q/k/v/o projections, causal attention, the gated MLP, and the
    tied head at every position.  ``cfg`` is a configuration file's
    ``model`` group."""
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim", d // hq)
    ff, vocab = cfg["intermediate_size"], cfg["vocab_size"]
    proj = 2 * t * d * (2 * hq * hd + 2 * hkv * hd)
    mlp = 2 * t * 3 * d * ff
    attn = flash_flops(1, hq, t, hd)
    head = 2 * t * d * vocab
    return layers * (proj + mlp + attn) + head


def attn_lm_prefill_flops(cfg: dict, t: int) -> int:
    """One prompt of t tokens through the attention decode LM's prefill:
    q/k/v and output projections, causal single-head attention of width d,
    and the head at the last position."""
    d, vocab = cfg["d_model"], cfg["vocab"]
    return 4 * 2 * t * d * d + flash_flops(1, 1, t, d) + 2 * d * vocab


def attn_lm_token_flops(cfg: dict) -> int:
    """One decode step of one stream, without the attention over its cache:
    q/k/v and output projections and the head."""
    d, vocab = cfg["d_model"], cfg["vocab"]
    return 4 * 2 * d * d + 2 * d * vocab
