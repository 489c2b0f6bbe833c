"""TP head-planning on the port: structural validation for every assigned
arch at TP=16, ported from ``tests/test_attention_plan.py``."""
import pytest

pytest.importorskip("hypothesis")  # optional dev dependency
from hypothesis import given, settings, strategies as st

from repro_torch.configs import ARCHS, get_config
from repro_torch.models.attention_plan import plan_heads, validate_plan

EXPECTED = {
    # arch: (n_q_pad, n_kv_phys)
    "qwen2-7b": (32, 16),
    "smollm-360m": (16, 16),
    "llama3.2-1b": (32, 16),
    "qwen2-1.5b": (16, 16),
    "dbrx-132b": (48, 16),
    "granite-moe-1b-a400m": (16, 16),
    "zamba2-2.7b": (32, 32),
    "xlstm-350m": (16, 16),     # planned but unused: ssm shards dv instead
    "seamless-m4t-large-v2": (16, 16),
    "phi-3-vision-4.2b": (32, 32),
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_assigned_archs_plan_at_tp16(arch):
    c = get_config(arch)
    plan = plan_heads(c.n_heads, c.n_kv_heads, 16)
    validate_plan(plan)
    assert (plan.n_q_pad, plan.n_kv_phys) == EXPECTED[arch], arch
    assert plan.n_q_pad % 16 == 0
    assert plan.n_kv_phys % 16 == 0
    # uniform GQA group after planning
    assert plan.n_q_pad % plan.n_kv_phys == 0


@settings(max_examples=200, deadline=None)
@given(
    n_kv=st.integers(1, 32),
    group=st.integers(1, 8),
    tp=st.sampled_from([2, 4, 8, 16]),
)
def test_plan_heads_property(n_kv, group, tp):
    """For any (n_q = n_kv·group, n_kv, tp) with n_kv <= tp or divisible:
    the plan is structurally valid and covers every original head."""
    n_q = n_kv * group
    if n_kv > tp and n_kv % tp != 0:
        return  # unsupported by contract
    plan = plan_heads(n_q, n_kv, tp)
    validate_plan(plan)
    assert plan.n_q_pad % tp == 0
    assert plan.n_kv_phys % tp == 0 or plan.n_kv_phys == n_kv
