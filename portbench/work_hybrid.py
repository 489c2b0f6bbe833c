"""The work of the hybrid Mamba-2/attention forward (Granite 4.0-H) and of
its SSD scan: the yardstick ``mfu.hybrid`` and ``ssd_roofline.hybrid``
divide by, at the peaks of :mod:`portbench.work`.

The SSD's work is the recurrence's, whatever chunk or kernel body computes
it: a token and head updates its (N, P) state (a multiply-add per entry)
and reads it against C (another), 4 N P operations, counted at the float32
tensor-core rate; x, dt, B and C are read once and y written once.  So a
later chunk or body is read against the same yardstick.
"""
from __future__ import annotations

from portbench import work


def ssd_flops(b: int, t: int, h: int, n: int, p: int) -> int:
    """The SSD recurrence over b sequences of t tokens and h heads."""
    return 4 * b * t * h * n * p


def ssd_bytes(b: int, t: int, h: int, n: int, p: int, itemsize: int = work.F32) -> int:
    """x and y (b, t, h, p), dt (b, t, h), B and C (b, t, n), each once."""
    return (2 * b * t * h * p + b * t * h + 2 * b * t * n) * itemsize


def ssd_bound_s(b, t, h, n, p) -> float:
    return work.bound_s(ssd_flops(b, t, h, n, p), ssd_bytes(b, t, h, n, p))


def hybrid_forward_flops(cfg: dict, t: int) -> int:
    """One sequence of t tokens through the hybrid forward the mixed path
    serves: per Mamba-2 layer the input projection (z, x, B, C, dt), the SSD
    at the recurrence's count and the output projection; per attention layer
    the q/k/v/o projections and causal attention; an MLP in every layer; the
    tied head at every position.  The conv, the norms and the elementwise
    work are left out.  ``cfg`` is a configuration file, which holds the published
    configuration's keys at its top level."""
    d, vocab = cfg["hidden_size"], cfg["vocab_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // hq
    h, p, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    inner = h * p
    ff = cfg["shared_intermediate_size"]
    types = cfg["layer_types"]
    mamba = (2 * t * d * (2 * inner + 2 * n + h) + ssd_flops(1, t, h, n, p)
             + 2 * t * inner * d)
    attn = 2 * t * d * (2 * hq * hd + 2 * hkv * hd) + work.flash_flops(1, hq, t, hd)
    mlp = 2 * t * 3 * d * ff
    head = 2 * t * d * vocab
    return (types.count("mamba") * mamba + types.count("attention") * attn
            + len(types) * mlp + head)
