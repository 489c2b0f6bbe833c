"""Architecture registry + reduced (smoke-test) config derivation."""
from __future__ import annotations

import dataclasses

from .base import ModelConfig, MoEConfig, SSMConfig, XLSTMConfig

from .qwen2_7b import CONFIG as _qwen2_7b
from .smollm_360m import CONFIG as _smollm
from .llama3_2_1b import CONFIG as _llama
from .qwen2_1_5b import CONFIG as _qwen2_15
from .dbrx_132b import CONFIG as _dbrx
from .granite_moe_1b_a400m import CONFIG as _granite
from .zamba2_2_7b import CONFIG as _zamba
from .xlstm_350m import CONFIG as _xlstm
from .seamless_m4t_large_v2 import CONFIG as _seamless
from .phi_3_vision_4_2b import CONFIG as _phi3v

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _qwen2_7b, _smollm, _llama, _qwen2_15, _dbrx,
        _granite, _zamba, _xlstm, _seamless, _phi3v,
    ]
}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}") from None


def reduced_config(arch: str, *, tp: int = 2) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one step, no allocation
    pain): few layers, narrow widths, tiny vocab, few experts/patches."""
    c = get_config(arch)
    kw: dict = dict(
        n_layers=2,
        d_model=64,
        n_heads=max(2, min(4, c.n_heads)),
        n_kv_heads=2 if c.n_kv_heads >= 2 else 1,
        d_ff=128 if c.d_ff else 0,
        vocab=512,
        head_dim=16,
        remat=False,
    )
    if c.family == "moe":
        # high capacity factor => no token drops => decode/teacher-forcing
        # equivalence is exact at smoke-test sizes
        kw["moe"] = MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                              capacity_factor=4.0)
    if c.family == "hybrid":
        kw["n_layers"] = 4
        kw["ssm"] = SSMConfig(state_dim=16, conv_kernel=4, expand=2, chunk=16,
                              shared_attn_every=2)
        kw["head_dim"] = 16
    if c.family == "ssm":
        kw["n_layers"] = 4
        kw["xlstm"] = XLSTMConfig(slstm_every=2, proj_factor=2.0)
        kw["n_heads"] = 2
        kw["n_kv_heads"] = 2
    if c.family == "encdec":
        kw["n_enc_layers"] = 2
    if c.family == "vlm":
        kw["n_patches"] = 8
    return dataclasses.replace(c, name=c.name + "-reduced", **kw)
