"""zamba2-2.7b [hybrid] — Mamba2 + shared attention blocks [arXiv:2411.15242; hf]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,          # 2560 / 32
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=64, conv_kernel=4, expand=2, chunk=256, shared_attn_every=6),
    source="[arXiv:2411.15242; hf]",
)
