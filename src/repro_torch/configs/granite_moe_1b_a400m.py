"""granite-moe-1b-a400m [moe] — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,          # padded to 49408 for TP=16 (multiple of 256)
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512),
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
)
