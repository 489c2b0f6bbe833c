"""phi-3-vision-4.2b [vlm] — phi3-mini + CLIP [hf:microsoft/Phi-3-vision-128k-instruct; hf].

Backbone only: the CLIP tower is a stub (input_specs() provides precomputed
patch embeddings), per the assignment.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    n_patches=576,        # 336px CLIP ViT-L/14 grid
    frontend_stub=True,
    source="[hf:microsoft/Phi-3-vision-128k-instruct; hf]",
)
