"""Model/shape configuration schema shared by all architectures."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # Mamba2 N (per-head state size)
    conv_kernel: int = 4
    expand: int = 2
    chunk: int = 256             # SSD chunked-scan block length
    # hybrid (zamba2): a shared attention block is applied every k SSM layers
    shared_attn_every: int = 6
    head_dim: int = 64           # Mamba2 P: d_inner = expand * d_model splits into heads of P


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    """A hybrid whose every layer holds one sequence mixer, Mamba-2 or
    attention (no positional encoding), then a dense MLP, with muP scalings
    (Granite 4.0-H, ``granitemoehybrid``); exported by
    ``models/programs.py:export_hybrid_forward``."""
    layer_types: tuple[str, ...]         # "mamba" | "attention", one per layer
    embedding_multiplier: float          # x = embedding_multiplier * E[tokens]
    residual_multiplier: float           # each mixer's and MLP's output, before its residual add
    attention_multiplier: float          # the softmax scale
    logits_scaling: float                # logits divided by this
    norm_eps: float                      # every RMSNorm's epsilon


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8         # sLSTM block frequency (rest are mLSTM)
    proj_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"            # mlp activation (silu => SwiGLU gate)
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None
    layout: HybridLayout | None = None   # per-layer mixers (export_hybrid_forward)
    # enc-dec (seamless): number of encoder layers (decoder gets n_layers)
    n_enc_layers: int = 0
    # vlm (phi-3-vision): number of stubbed image-patch embeddings per sample
    n_patches: int = 0
    # modality frontends are stubs: input_specs() provides frame/patch embeds
    frontend_stub: bool = False
    remat: bool = True           # activation checkpointing for train_step
    compute_dtype: str = "bfloat16"  # activations/compute; params stay fp32 masters
    source: str = ""             # provenance note [paper/hf; tier]

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def padded_vocab(self, multiple: int = 256) -> int:
        v = self.vocab
        return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# long_500k needs sub-quadratic sequence mixing: only SSM/hybrid archs run it
# (pure full-attention archs skip it — recorded in EXPERIMENTS.md §Dry-run).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def shape_grid(cfg: ModelConfig) -> list[tuple[str, bool, str]]:
    """(shape_name, runnable, skip_reason) for the assigned 4-shape grid."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
            out.append((s.name, False, "full-attention arch: 500k decode needs sub-quadratic mixing"))
        else:
            out.append((s.name, True, ""))
    return out
