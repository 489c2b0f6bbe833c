"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,               # no FFN; mLSTM blocks carry their own up/down proj
    vocab=50304,
    rope_theta=0.0,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0),
    source="[arXiv:2405.04517; unverified]",
)
