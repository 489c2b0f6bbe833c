"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base; unverified]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    rope_theta=500000.0,
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
    source="[hf:databricks/dbrx-base; unverified]",
)
