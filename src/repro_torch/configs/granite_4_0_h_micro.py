"""granite-4.0-h-micro [hybrid] — 36 Mamba-2 and 4 attention layers, each with
a dense SwiGLU MLP, muP multipliers
[hf:ibm-granite/granite-4.0-h-micro config.json, ``granitemoehybrid``].

Served by the mixed engine through
:func:`repro_torch.models.programs.export_hybrid_forward`, not by the zoo's
``models/api`` (whose ``hybrid`` family is Zamba2's shared-block design), so
it is not in :data:`repro_torch.configs.ARCHS`.

No positional encoding (``position_embedding_type`` "nope").  One
departure: ``ssm.chunk`` is 128 where the published ``mamba_chunk_size``
is 256.  At float32 and N = 128 the SSD scan runs on the CUDA-core body,
whose block holds at most 254 rows of a chunk in shared memory; the chunk
changes only the order of the float32 sums, not the function.
"""
from .base import HybridLayout, ModelConfig, SSMConfig

LAYER_TYPES = tuple("attention" if i in (5, 15, 25, 35) else "mamba" for i in range(40))

CONFIG = ModelConfig(
    name="granite-4.0-h-micro",
    family="hybrid",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,                # shared_intermediate_size; no experts
    vocab=100352,
    head_dim=64,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    # mamba_d_state, mamba_d_conv, mamba_expand, mamba_d_head (64 heads of 64)
    ssm=SSMConfig(state_dim=128, conv_kernel=4, expand=2, chunk=128, head_dim=64),
    layout=HybridLayout(
        layer_types=LAYER_TYPES,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        attention_multiplier=0.015625,
        logits_scaling=8.0,
        norm_eps=1e-5,
    ),
    compute_dtype="float32",
    source="[hf:ibm-granite/granite-4.0-h-micro; hf]",
)
