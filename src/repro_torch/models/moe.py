"""Mixture-of-Experts transformer (dbrx-132b, granite-moe families): the port.

The port of the reference's ``models/moe.py``: capacity-based top-k routing.
Each (token, k) pair takes a queue position (slot) in its expert's buffer
from an exclusive running count in the flat (token, k) order, exactly the
reference's; pairs at ``slot >= C`` are dropped (standard capacity
semantics; with ``capacity_factor`` at E/k or above nothing is dropped and
the layer is exact).  The reference counts with a one-hot cumsum in
token blocks under ``lax.scan`` (to bound memory at 1M tokens a step; the
blocks do not change the counts); the port takes each pair's rank in a
stable sort by expert, which gives the same counts without the (N*k, E)
one-hot, whose scan along the token axis is slow on the card.

Dispatch is plain index assignment into the (E, C, D) buffer: each kept
(expert, slot) receives one token, so it is deterministic.  The expert
products are ``torch.bmm``s, where the reference has ``einsum``s outside any
Pallas kernel.  The combine sums each token's k weighted contributions over
k in a fixed order (no ``index_add_``, which is an atomic float sum on
CUDA); in bf16 this rounds once where the reference's scatter-add rounds
after each of the k adds.

Under autograd the gradients follow the reference's: the router's through
the kept gates (the sort's values), each kept pair's token through its
buffer row (the index assignment's backward gathers it), and a dropped
pair's none (it lands in the sliced-away row E).

Attention, norms, the cache and the layer loop are :mod:`.dense`'s, with the
routed experts in place of the MLP, so they run the flash, flash-decode and
RMSNorm kernels, and a train step rematerialises each layer under
``cfg.remat`` as the reference's ``jax.checkpoint`` of its scan body does.

Under a mesh, :func:`moe_block_ep` is the reference's expert-parallel
formulation, one rank per mesh position: route locally, exchange expert
slabs with one all-to-all over the ``model`` axis, compute the local
experts, all-to-all back.  :func:`dispatch_moe_block` calls it whenever a
step installs :class:`~repro_torch.parallel.sharding.moe_ep_context`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..parallel import sharding as shd
from ..parallel import spmd
from . import dense
from . import layers as L
from .dense import _dims, stack_layers


def init_moe_layer(cfg: ModelConfig, gen, tp: int, *, device):
    m = cfg.moe
    E, D, Fe = m.num_experts, cfg.d_model, m.d_ff_expert
    return {
        "ln1": L.init_norm(D, cfg.norm, device=device),
        "attn": L.init_attention(gen, _dims(cfg, tp), device=device),
        "ln2": L.init_norm(D, cfg.norm, device=device),
        "router": L._init(gen, (D, E), device, scale=0.02),
        "experts": {
            "wg": L._init(gen, (E, D, Fe), device),
            "wu": L._init(gen, (E, D, Fe), device),
            "wd": L._init(gen, (E, Fe, D), device),
        },
    }


def init(cfg: ModelConfig, gen: torch.Generator, tp: int = L.DEFAULT_TP, *,
         device: torch.device):
    layers = [init_moe_layer(cfg, gen, tp, device=device) for _ in range(cfg.n_layers)]
    return {
        "embed": L.init_embed(gen, cfg.padded_vocab(), cfg.d_model, device=device),
        "layers": stack_layers(layers),
        "ln_f": L.init_norm(cfg.d_model, cfg.norm, device=device),
    }


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / m.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(cfg: ModelConfig, lp, xf):
    """Top-k routing of tokens xf (N, D): (weights (N,k) float32, experts
    (N,k), slots (N,k), keep (N,k)), the reference's for the same gates.

    Top-k is a stable descending sort, so equal gates (frequent with bf16
    router logits) keep the lower expert first, as ``lax.top_k`` does.
    """
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    logits = xf @ lp["router"].to(xf.dtype)                        # (N, E)
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    top_v, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_v, top_i = top_v[:, :k], top_i[:, :k]
    top_v = top_v / torch.clamp(torch.sum(top_v, dim=-1, keepdim=True), min=1e-9)
    # exclusive running count of each expert in the flat (token, k) order:
    # a pair's rank in a stable sort by expert, less its expert's first rank
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=xf.device)
    # bincount's size depends on the data; a scatter into E zeros does not
    # (a step on tensors without data, the launch dry run, runs this too)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    first = torch.cumsum(counts, dim=0) - counts
    slot = (rank - first[flat_e]).reshape(top_i.shape)
    return top_v, top_i, slot, slot < _capacity(cfg, xf.shape[0])


def dispatch(xf, e_flat, s_flat, n_experts: int, capacity: int):
    """Tokens xf (N, D) into the (E, C, D) expert buffer: flat pair p
    (token p // k) at (e_flat[p], s_flat[p]); the dropped pairs go to the
    out-of-range row E, sliced away."""
    k = e_flat.numel() // xf.shape[0]
    tok = torch.arange(xf.shape[0], device=xf.device).repeat_interleave(k)
    buf = torch.zeros((n_experts + 1, capacity, xf.shape[1]), dtype=xf.dtype,
                      device=xf.device)
    buf[e_flat, s_flat] = xf[tok]
    return buf[:n_experts]


def experts(w, xe):
    """The experts' gated MLPs on their buffers xe (E, C, D): batched
    matmuls, as the reference's ``einsum``s."""
    hg = F.silu(torch.bmm(xe, w["wg"].to(xe.dtype)))
    hu = torch.bmm(xe, w["wu"].to(xe.dtype))
    return torch.bmm(hg * hu, w["wd"].to(xe.dtype))


def combine(he, e_flat, s_flat, keep, top_v):
    """Each token's k expert outputs, weighted and summed over k in a fixed
    order: (N, D)."""
    N, k = top_v.shape
    gathered = he[e_flat % he.shape[0], s_flat]
    gathered = torch.where(keep.reshape(-1)[:, None], gathered, 0.0)
    weighted = gathered * top_v.reshape(-1)[:, None].to(he.dtype)
    return weighted.reshape(N, k, -1).sum(dim=1)


def moe_block(cfg: ModelConfig, lp, x):
    """x: (B,T,D) -> (B,T,D) via capacity-based top-k expert routing."""
    E = cfg.moe.num_experts
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    top_v, top_i, slot, keep = route(cfg, lp, xf)
    e_flat = torch.where(keep, top_i, E).reshape(-1)
    s_flat = torch.where(keep, slot, 0).reshape(-1)
    xe = dispatch(xf, e_flat, s_flat, E, _capacity(cfg, B * T))
    he = experts(lp["experts"], xe)
    return combine(he, e_flat, s_flat, keep, top_v).reshape(B, T, D)


def moe_block_ep(cfg: ModelConfig, lp, x, mesh, *, seq_axis=None):
    """Expert-parallel MoE: explicit all-to-all dispatch over ``model``.

    The reference's ``shard_map`` block, run by each rank on its own shards:
    x (B_local, T, D) is this rank's batch slice, replicated over
    ``model``; the experts' weights are held as the reference's in-specs
    lay them out, ``wg``/``wu`` (E/M, d/nd, f) and ``wd`` (E/M, f, d/nd)
    for M ranks over ``model`` and nd over ``data``, and all-gathered over
    ``data`` inside the layer (the reference's ``batch_axes``,
    ``model_axis`` and ``weight_gather_axis``, fixed to the names every
    step gives them).  Each rank routes its tokens locally with a
    per-sender capacity ``_capacity(cfg, N_local)`` (standard EP
    semantics), sends each expert's slab to the rank that holds it,
    computes its local experts on the slabs of every sender, and sends the
    results back to be combined.  With
    ``seq_axis`` (prefill) the token dim is also sharded over that axis, so
    the model ranks do not route the same tokens, and the output is
    gathered back over it.

    Differentiable: the collectives' backwards are their transposes and the
    values replicated over an axis cross :func:`~repro_torch.parallel.spmd.enter`
    and :func:`~repro_torch.parallel.spmd.leave`, as at ``shard_map``'s
    boundary, so the backward is the mirrored exchange with the weights'
    gradients reduce-scattered over ``data``.
    """
    E = cfg.moe.num_experts
    M = mesh.shape["model"]
    if E % M:
        raise ValueError(f"{E} experts do not split over {M} ranks of 'model'")
    E_loc = E // M
    # under the fsdp strategy the batch may be split over "model" too: then
    # the model ranks route different tokens, which neither enter nor leave
    # as values replicated over it
    split = shd.tokens_split_over("model")
    if split and seq_axis is not None:
        raise ValueError("moe_block_ep: the tokens are split over 'model' already; "
                         "seq_axis must be None")
    with mesh:
        if seq_axis is not None:
            xl = spmd.take(spmd.enter(x, seq_axis), seq_axis, 1)
        else:
            xl = x if split else spmd.enter(x, "model")
        router = lp["router"] if split else spmd.enter(lp["router"], "model")
        bl, tl, D = xl.shape
        N = bl * tl
        xf = xl.reshape(N, D)
        top_v, top_i, slot, keep = route(cfg, {"router": router}, xf)
        C = _capacity(cfg, N)
        e_flat = torch.where(keep, top_i, E).reshape(-1)
        s_flat = torch.where(keep, slot, 0).reshape(-1)
        xe = dispatch(xf, e_flat, s_flat, E, C)                        # (E, C, D)

        # dispatch all-to-all over the expert axis: tokens per local expert
        xr = spmd.all_to_all(xe.reshape(M, E_loc, C, D), "model", 0, 0)
        xg = xr.movedim(0, 1).reshape(E_loc, M * C, D)

        # expert compute, the weights gathered over the data axis
        w = lp["experts"]
        w = {"wg": spmd.all_gather(w["wg"], "data", 1),
             "wu": spmd.all_gather(w["wu"], "data", 1),
             "wd": spmd.all_gather(w["wd"], "data", 2)}
        he = experts(w, xg)                                            # (E_loc, M*C, D)

        # combine all-to-all back to the senders
        hr = he.reshape(E_loc, M, C, D).movedim(1, 0)
        hb = spmd.all_to_all(hr, "model", 0, 0).reshape(E, C, D)
        y = combine(hb, e_flat, s_flat, keep, top_v).reshape(bl, tl, D)
        if seq_axis is not None:
            return spmd.leave(spmd.all_gather(y, seq_axis, 1), seq_axis)
        return y if split else spmd.leave(y, "model")


def dispatch_moe_block(cfg: ModelConfig, lp, x):
    """The routed experts of one layer: :func:`moe_block_ep` when the step
    installed an expert-parallel context, else :func:`moe_block`."""
    ep = shd.current_moe_ep()
    if ep is not None:
        mesh, seq_axis = ep
        return moe_block_ep(cfg, lp, x, mesh, seq_axis=seq_axis)
    return moe_block(cfg, lp, x)


def backbone(cfg: ModelConfig, params, h, *, tp: int):
    return dense.backbone(cfg, params, h, tp=tp, ffn=dispatch_moe_block)


def logits_fn(cfg: ModelConfig, params, tokens, *, tp: int = L.DEFAULT_TP):
    h = L.embed_in(cfg, params["embed"], tokens)
    h = backbone(cfg, params, h, tp=tp)
    return L.unembed(params["embed"], h, cfg.padded_vocab())


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, tp: int = L.DEFAULT_TP,
               dtype=torch.float32, device: torch.device):
    return dense.init_cache(cfg, batch, max_len, tp=tp, dtype=dtype, device=device)


def prefill(cfg: ModelConfig, params, tokens, cache, *, tp: int = L.DEFAULT_TP):
    """Fill the cache with a full prompt, in place (see :func:`.dense.prefill`)."""
    h = L.embed_in(cfg, params["embed"], tokens)
    return dense.prefill_embedded(cfg, params, h, cache, tp=tp, ffn=dispatch_moe_block)


def decode_step(cfg: ModelConfig, params, cache, token, *, tp: int = L.DEFAULT_TP):
    """One decode step, in place (see :func:`.dense.decode_step`)."""
    return dense.decode_step(cfg, params, cache, token, tp=tp, ffn=dispatch_moe_block)
