"""Analytic roofline terms of a cell on NVIDIA H100 cards.

The port of the reference's ``launch/rooflines.py``: the compute and memory
terms keep its formulas (parameter counts from a meta-device ``init``, which
is exact, plus the attention and cache terms); the hardware constants are
the H100's, each stated once below with its source; the collective term
reads the operand bytes the dry run counts per mesh axis
(``parallel/spmd.py:collective_stats``), each axis at the rate of the links
its ranks share.

Hardware (per card), from the NVIDIA H100 Tensor Core GPU datasheet, SXM5:

* :data:`PEAK_FLOPS_BF16` — bf16 tensor-core peak, dense (the datasheet's
  1,979 TFLOP/s is with 2:4 sparsity);
* :data:`HBM_BW` — HBM3 bandwidth;
* :data:`NVLINK_BW` — NVLink 4, 900 GB/s a card in both directions: the
  rate of one direction, for an axis whose ranks lie in one node of
  :data:`NODE_CARDS` cards;
* :data:`NIC_BW` — one 400 Gb/s network port a card (ConnectX-7 NDR, the
  datasheet's HGX H100 networking), for an axis that spans nodes.  No axis
  of the reference's 16x16 or 2x16x16 meshes fits one node.

These are the constants PERF.md's kernel bounds use.  No TPU figure is
carried over.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import api, encdec
from ..models.attention_plan import plan_heads
from ..optim.tree import tree_items

PEAK_FLOPS_BF16 = 989e12       # FLOP/s, bf16 dense
HBM_BW = 3.35e12               # B/s
NVLINK_BW = 900e9 / 2          # B/s a direction
NIC_BW = 400e9 / 8             # B/s: one 400 Gb/s port
NODE_CARDS = 8                 # cards joined by NVLink in one node


@functools.lru_cache(maxsize=64)
def param_count(cfg: ModelConfig, tp: int = 16) -> int:
    """The parameters of ``api.init`` at ``tp``'s head plan, counted on the
    meta device (nothing allocated)."""
    params = api.family_module(cfg).init(cfg, torch.Generator(), tp=tp,
                                         device=torch.device("meta"))
    return sum(int(math.prod(t.shape)) for _, t in tree_items(params))


def active_param_count(cfg: ModelConfig, tp: int = 16) -> int:
    """Params touched per token (MoE: top_k of num_experts experts)."""
    n = param_count(cfg, tp)
    if cfg.moe is None:
        return n
    m = cfg.moe
    expert_params = cfg.n_layers * 3 * m.num_experts * cfg.d_model * m.d_ff_expert
    active = cfg.n_layers * 3 * m.top_k * cfg.d_model * m.d_ff_expert
    return n - expert_params + active


def _attention_flops(cfg: ModelConfig, shape: ShapeConfig, tp: int) -> int:
    """Softmax-attention score+value FLOPs (forward), padded heads included."""
    plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, tp)
    hd = cfg.head_dim_
    B, T = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        return 0  # mLSTM flops counted via param matmuls + chunk math below
    n_attn_layers = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn_layers = cfg.n_layers // cfg.ssm.shared_attn_every
    if shape.kind == "decode":
        # one token vs cache of length T
        return n_attn_layers * B * plan.n_q_pad * hd * T * 2 * 2
    # causal full attention: ~T^2/2 per head pair, x2 matmuls x2 FLOP/MAC
    flops = n_attn_layers * B * plan.n_q_pad * hd * T * T * 2
    if cfg.family == "encdec":
        S = encdec.enc_len_for(T)
        flops += cfg.n_enc_layers * B * plan.n_q_pad * hd * S * S * 2 * 2  # bidir enc
        flops += cfg.n_layers * B * plan.n_q_pad * hd * T * S * 2 * 2     # cross
    return flops


def model_flops(cfg: ModelConfig, shape: ShapeConfig, tp: int = 16) -> dict:
    """MODEL_FLOPS for the cell: 6*N*D train, 2*N*D forward (+attention)."""
    n_active = active_param_count(cfg, tp)
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * T
        base = 6 * n_active * tokens
        attn = 3 * _attention_flops(cfg, shape, tp)   # fwd + bwd ~ 3x fwd
    elif shape.kind == "prefill":
        tokens = B * T
        base = 2 * n_active * tokens
        attn = _attention_flops(cfg, shape, tp)
    else:  # decode: one token per sequence
        tokens = B * 1
        base = 2 * n_active * tokens
        attn = _attention_flops(cfg, shape, tp)
    return {"base": int(base), "attention": int(attn), "total": int(base + attn)}


def memory_bytes(cfg: ModelConfig, shape: ShapeConfig, tp: int = 16,
                 kv_quant: bool = False) -> int:
    """Minimum HBM traffic per step (weights-read dominated heuristic).

    train: params read (bf16) + grads written + opt state read/write (fp32
    m,v) + activations ~ 2 bytes x tokens x d_model x layers x k.
    decode: active params read once + KV cache / SSM state read.
    """
    n = param_count(cfg, tp)
    n_act = active_param_count(cfg, tp)
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        weight_traffic = n * 2 + n * 2 + n * 4 * 4       # read w, write g, rw m/v
        acts = 2 * B * T * cfg.d_model * max(cfg.n_layers, 1) * 4
        return int(weight_traffic + acts)
    if shape.kind == "prefill":
        acts = 2 * B * T * cfg.d_model * max(cfg.n_layers, 1) * 2
        return int(n_act * 2 + acts)
    # decode
    plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, tp)
    kv_bytes_per_elem = (1 + 4 / cfg.head_dim_) if kv_quant else 2
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        cache = 2 * cfg.n_layers * B * T * plan.n_kv_phys * cfg.head_dim_ * kv_bytes_per_elem
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.ssm.shared_attn_every
        d_inner = cfg.ssm.expand * cfg.d_model
        cache = (2 * n_attn * B * T * plan.n_kv_phys * cfg.head_dim_ * 2
                 + cfg.n_layers * B * (d_inner // 64) * cfg.ssm.state_dim * 64 * 4)
    else:  # ssm
        H = cfg.n_heads
        dk = cfg.d_model // H
        dv = int(cfg.xlstm.proj_factor * cfg.d_model) // H
        cache = cfg.n_layers * B * H * dk * dv * 4
    return int(n_act * 2 + cache)


def link_bw(axis: str, mesh_shape: dict | None = None, axis_names=None) -> float:
    """The rate (B/s) a collective over ``axis`` moves a rank's bytes at:
    NVLink where the axis's ranks lie in one node of :data:`NODE_CARDS`
    cards (ranks laid out row-major over ``axis_names``, as the port's
    meshes are), the NIC otherwise or where the mesh is not given."""
    if mesh_shape is None or axis not in mesh_shape:
        return NIC_BW
    names = list(axis_names or mesh_shape)
    stride = math.prod(mesh_shape[a] for a in names[names.index(axis) + 1:])
    span = (mesh_shape[axis] - 1) * stride + 1
    return NVLINK_BW if span <= NODE_CARDS else NIC_BW


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self):
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def collective_seconds(bytes_by_axis: dict, mesh_shape: dict | None = None,
                       axis_names=None) -> float:
    """One rank's collective time: each axis's operand bytes at its
    :func:`link_bw`."""
    return sum(b / link_bw(a, mesh_shape, axis_names) for a, b in bytes_by_axis.items())


def roofline(cfg: ModelConfig, shape: ShapeConfig, chips: int, collective_bytes_by_axis: dict,
             tp: int = 16, kv_quant: bool = False, mesh_shape: dict | None = None,
             axis_names=None) -> dict:
    """The cell's three terms on ``chips`` H100s: model FLOPs at the bf16
    peak and the heuristic HBM bytes at :data:`HBM_BW`, both spread over
    the chips, and one rank's collective bytes by mesh axis (already per
    device) at each axis's link rate."""
    mf = model_flops(cfg, shape, tp)
    mb = memory_bytes(cfg, shape, tp, kv_quant=kv_quant)
    terms = RooflineTerms(
        compute_s=mf["total"] / (chips * PEAK_FLOPS_BF16),
        memory_s=mb / (chips * HBM_BW),
        collective_s=collective_seconds(collective_bytes_by_axis, mesh_shape, axis_names),
    )
    return {
        "model_flops": mf,
        "memory_bytes": mb,
        "params": param_count(cfg, tp),
        "active_params": active_param_count(cfg, tp),
        "terms": terms.as_dict(),
        "bound_s": terms.bound_s,
    }
