"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

Backbone only: the audio frontend is a stub (input_specs() provides
precomputed frame embeddings), per the assignment.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,          # decoder layers
    n_enc_layers=24,      # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,         # padded to 256256 for TP=16 (multiple of 256)
    rope_theta=10000.0,
    norm="layernorm",
    act="relu",
    frontend_stub=True,
    source="[arXiv:2308.11596; hf]",
)
