"""``work.py``'s operation and byte counts against counts made by hand, and
against the FLOPs of the plain references' own products."""
from __future__ import annotations

import pytest

from portbench import work


def test_flash_counts_by_hand():
    # b 2, 3 heads, t 4, d 8, causal: 10 of 16 pairs; 2 x d each for Q.K^T and P.V
    assert work.causal_pairs(4) == 10
    assert work.flash_flops(2, 3, 4, 8) == 2 * 3 * 10 * 8 * 4
    assert work.flash_flops(2, 3, 4, 8, causal=False) == 2 * 3 * 16 * 8 * 4
    # q and o: 2 x 3 x 4 x 8 floats each; k and v on 1 kv head: 2 x 1 x 4 x 8 each
    assert work.flash_bytes(2, 3, 1, 4, 8) == (2 * 192 + 2 * 64) * 4


def test_paged_step_counts_by_hand():
    # 2 streams with 5 and 7 live positions of width 4: 12 K rows and 12 V rows
    assert work.paged_step_bytes(2, 12, 4) == (2 * 12 * 4 + 4 * 2 * 4) * 4
    assert work.paged_step_flops(2, 12, 4) == 4 * 14 * 4


def test_bound_is_the_larger_term():
    assert work.bound_s(work.FP32_TC_FLOPS, 1.0) == pytest.approx(1.0)
    assert work.bound_s(1.0, work.HBM_BYTES_PER_S * 2) == pytest.approx(2.0)
    assert work.FP32_TC_FLOPS == pytest.approx(165e12)


def test_dense_forward_by_hand():
    cfg = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
           "num_key_value_heads": 1, "intermediate_size": 16, "vocab_size": 10}
    t, hd = 3, 4
    proj = 2 * t * 8 * (2 * 8 + 2 * hd)          # q and o 8 wide, k and v 4
    mlp = 2 * t * 3 * 8 * 16
    attn = 4 * 2 * 6 * hd                        # 2 heads, 6 causal pairs
    head = 2 * t * 8 * 10
    assert work.dense_forward_flops(cfg, t) == 2 * (proj + mlp + attn) + head


def test_attn_lm_by_hand():
    cfg = {"d_model": 4, "vocab": 10}
    assert work.attn_lm_prefill_flops(cfg, 3) == 4 * 2 * 3 * 16 + 4 * 6 * 4 + 2 * 4 * 10
    assert work.attn_lm_token_flops(cfg) == 4 * 2 * 16 + 2 * 4 * 10
