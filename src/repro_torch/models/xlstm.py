"""xLSTM backbone (mLSTM + sLSTM blocks, arXiv:2405.04517): the port.

The port of the reference's ``models/xlstm.py``, where every op is ``jnp``
(no Pallas kernel): so is every op here but the norms, which run the RMSNorm
kernel.

* mLSTM: matrix-memory cells with stabilised exponential gating, in the
  reference's time-chunked parallel form (intra-chunk products, an
  inter-chunk state recurrence in log space): ``lax.cummax`` is
  ``torch.cummax``, the inter-chunk ``lax.scan`` a loop over chunks.  As
  there, ``T`` must be a multiple of the chunk ``min(128, T)``: prompts of
  128-multiples or shorter than 128.
* sLSTM: scalar-memory cells with block-diagonal (per-head) recurrent
  weights, a sequential loop over T.  Every ``slstm_every``-th layer is an
  sLSTM block, the rest mLSTM.

**Tensor parallelism** (a step whose mesh has a ``model`` axis of more than
one rank): each rank holds ``param_pspec``'s shards with the mLSTM
override.  The mLSTM splits the value width ``dv`` (``wv``, ``wo_gate``,
the rows of ``wo``; its C state on ``dv``): ``wq``, ``wk``, ``wi``, ``wf``
and ``fb`` stay replicated, because the normaliser needs all of ``dk``, and
enter the block with the normed input (``spmd.enter``: their cotangents,
partial over ``dv``, are psummed); ``wo``'s partial product is psummed.
The sLSTM splits ``wx``'s output D and its (B, D) states.  Where the
``model`` axis divides the heads, a rank's D shard holds whole heads and its
recurrent term stays local: the rank takes its heads' blocks of the
replicated ``rh`` and its slice of ``fb`` (``spmd.take``).  Where the heads
divide the axis instead (xLSTM-350M's 4 heads over the production mesh's 16
ranks), a rank's shard is a slice of one head: every step gathers h over
``model`` (``spmd.all_gather``, whose backward is a reduce-scatter) and the
rank multiplies its head's h by its columns of that head's block.
:func:`check_tensor_parallel` refuses any other axis.

Parameter names and shapes equal the reference's; ``params["layers"]`` is a
list of per-layer dicts, as there (the two kinds have different leaves).
The decode state is updated in place: ``prefill`` and ``decode_step`` write
each layer's state into the cache's tensors and advance ``pos``; those are
the only in-place writes, so autograd goes through the chunked mLSTM and
the sLSTM loop of a train step as through any other ops (no remat, as in
the reference).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..parallel import sharding as shd
from ..parallel import spmd
from . import layers as L

F32 = torch.float32
NEG_INIT = -1e30            # the stabiliser's start: no source seen yet


def _dims(cfg: ModelConfig):
    H = cfg.n_heads
    dk = cfg.d_model // H
    dv = int(cfg.xlstm.proj_factor * cfg.d_model) // H
    return H, dk, dv


def is_slstm_layer(cfg: ModelConfig, i: int) -> bool:
    return (i + 1) % cfg.xlstm.slstm_every == 0


def check_tensor_parallel(cfg: ModelConfig, model: int) -> None:
    """Raise :class:`ValueError` unless ``model`` ranks can split xLSTM:
    the mLSTM's ``dv``, and the sLSTM's heads (each rank's D shard holds
    whole heads) or its heads' widths (the heads divide ``model`` and each
    rank's shard lies in one head, whose h it gathers every step)."""
    H, _, dv = _dims(cfg)
    heads = H % model == 0 or (model % H == 0 and cfg.d_model % model == 0)
    if not heads or dv % model:
        raise ValueError(f"{cfg.name}: a 'model' axis of {model} ranks must divide the "
                         f"mLSTM's dv {dv}, and give each rank whole sLSTM heads or a "
                         f"slice of one head of D = {cfg.d_model} (whose h is then "
                         f"gathered every step)")


def _local(x, dim: int):
    """A replicated leaf's slice of this rank's heads under tensor
    parallelism (its cotangent psummed, then zero outside the slice)."""
    if not shd.tensor_parallel():
        return x
    return spmd.take(spmd.enter(x, "model"), "model", dim)


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, chunked-parallel)
# ---------------------------------------------------------------------------

def init_mlstm_layer(cfg: ModelConfig, gen, *, device):
    H, dk, dv = _dims(cfg)
    D = cfg.d_model
    return {
        "ln": L.init_norm(D, "rmsnorm", device=device),
        "wq": L._init(gen, (D, H, dk), device),
        "wk": L._init(gen, (D, H, dk), device),
        "wv": L._init(gen, (D, H, dv), device),
        "wi": L._init(gen, (D, H), device, scale=0.02),
        "wf": L._init(gen, (D, H), device, scale=0.02),
        "fb": torch.full((H,), 3.0, dtype=F32, device=device),   # forget bias: remember
        "wo_gate": L._init(gen, (D, H, dv), device, scale=0.02),
        "wo": L._init(gen, (H, dv, D), device),
    }


def mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int):
    """Stabilised mLSTM in chunked-parallel form.

    q,k: (B,T,H,dk); v: (B,T,H,dv); i_pre/f_pre: (B,T,H) pre-activations.
    C_t = f_t C_{t-1} + i_t k_t v_t^T ;  n_t = f_t n_{t-1} + i_t k_t
    y_t = (q^T C)_t / max(|q^T n|_t, 1)   with log-space stabiliser m_t.
    Returns (y (B,T,H,dv) in q's dtype, final state {"C", "n", "m"}).
    """
    B, T, H, dk = q.shape
    Q = min(chunk, T)
    nc = T // Q
    if T % Q:
        raise ValueError(f"mLSTM: T={T} is not a multiple of the chunk {Q}")

    logf = F.logsigmoid(f_pre.to(F32))                             # (B,T,H)
    logi = i_pre.to(F32)

    def r(a):
        return a.reshape(B, nc, Q, *a.shape[2:])

    qc, kc, vc = r(q).to(F32), r(k).to(F32), r(v).to(F32)
    lf, li = r(logf), r(logi)
    csf = torch.cumsum(lf, dim=2)                                  # sum of log f in a chunk
    a_j = li - csf                                                 # (B,nc,Q,H)
    m_intra = torch.cummax(a_j, dim=2).values                      # running max over j <= t
    scale = 1.0 / math.sqrt(dk)

    # intra-chunk scores (q_t . k_j) * scale: (B,nc,t,H,j)
    s_qk = torch.einsum("bcthd,bcjhd->bcthj", qc, kc) * scale
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))

    # chunk-local summaries at the chunk's end: weight exp(li_j + csf_end - csf_j)
    b_end = a_j + csf[:, :, -1:, :]
    m_loc = torch.amax(b_end, dim=2)                               # (B,nc,H)
    w_loc = torch.exp(b_end - m_loc[:, :, None, :])
    C_loc = torch.einsum("bcjh,bcjhd,bcjhe->bchde", w_loc, kc, vc)
    n_loc = torch.einsum("bcjh,bcjhd->bchd", w_loc, kc)
    f_tot = csf[:, :, -1, :]                                       # (B,nc,H)

    # inter-chunk recurrence (the reference's lax.scan): the state before
    # each chunk, and the final one
    C = torch.zeros((B, H, dk, vc.shape[-1]), dtype=F32, device=q.device)
    n = torch.zeros((B, H, dk), dtype=F32, device=q.device)
    m = torch.full((B, H), NEG_INIT, dtype=F32, device=q.device)
    C_prev, n_prev, m_prev = [], [], []
    for c in range(nc):
        C_prev.append(C)
        n_prev.append(n)
        m_prev.append(m)
        m_new = torch.maximum(f_tot[:, c] + m, m_loc[:, c])
        w_old = torch.exp(f_tot[:, c] + m - m_new)
        w_new = torch.exp(m_loc[:, c] - m_new)
        C = C * w_old[..., None, None] + C_loc[:, c] * w_new[..., None, None]
        n = n * w_old[..., None] + n_loc[:, c] * w_new[..., None]
        m = m_new
    C_prev, n_prev, m_prev = (torch.stack(a, dim=1) for a in (C_prev, n_prev, m_prev))

    # per-step stabiliser: m_t = max(m_intra_t, m_prev + csf_t)
    m_carry = m_prev[:, :, None, :] + csf                          # (B,nc,Q,H)
    m_t = torch.maximum(m_intra, m_carry)

    # weight of source j at target t: (B,nc,t,j,H), zero above the diagonal
    w_intra = torch.exp(a_j[:, :, None, :, :] + csf[:, :, :, None, :]
                        - m_t[:, :, :, None, :])
    w_intra = torch.where(mask[None, None, :, :, None], w_intra, 0.0)
    sw = s_qk * w_intra.permute(0, 1, 2, 4, 3)                     # (B,nc,t,H,j)
    num_intra = torch.einsum("bcthj,bcjhe->bcthe", sw, vc)
    den_intra = sw.sum(dim=-1)
    qs = qc * scale

    # inter-chunk: q_t . C_prev with weight exp(m_prev + csf_t - m_t)
    w_c = torch.exp(m_carry - m_t)                                 # (B,nc,Q,H)
    num_inter = torch.einsum("bcthd,bchde->bcthe", qs, C_prev) * w_c[..., None]
    den_inter = torch.einsum("bcthd,bchd->bcth", qs, n_prev) * w_c

    num = num_intra + num_inter
    den = den_intra + den_inter
    denom = torch.maximum(torch.abs(den), torch.exp(-m_t))         # max(|q.n|, 1), stabilised
    y = num / denom[..., None]
    return y.reshape(B, T, H, -1).to(q.dtype), {"C": C, "n": n, "m": m}


def _replicated(lp, *names):
    """The mLSTM's replicated leaves as they enter per-rank code."""
    return [L._tp_in(lp[n]) for n in names]


def mlstm_block(cfg: ModelConfig, lp, x, *, return_state: bool = False):
    dt = x.dtype
    h = L._tp_in(L.apply_norm(lp["ln"], x, "rmsnorm"))
    wq, wk, wi, wf, fb = _replicated(lp, "wq", "wk", "wi", "wf", "fb")
    q = torch.einsum("btd,dhk->bthk", h, wq.to(dt))
    k = torch.einsum("btd,dhk->bthk", h, wk.to(dt))
    v = torch.einsum("btd,dhk->bthk", h, lp["wv"].to(dt))
    i_pre = torch.einsum("btd,dh->bth", h, wi.to(dt))
    f_pre = torch.einsum("btd,dh->bth", h, wf.to(dt)) + fb.to(dt)
    y, state = mlstm_chunked(q, k, v, i_pre, f_pre, chunk=128)
    og = torch.sigmoid(torch.einsum("btd,dhe->bthe", h, lp["wo_gate"].to(dt)))
    out = x + L._tp_out(torch.einsum("bthe,hed->btd", y * og, lp["wo"].to(dt)))
    return (out, state) if return_state else out


def mlstm_decode(cfg: ModelConfig, lp, state, x1):
    """state: {"C": (B,H,dk,dv), "n": (B,H,dk), "m": (B,H)}; x1: (B,1,D).
    Returns (out, new state)."""
    H, dk, dv = _dims(cfg)
    dt = x1.dtype
    h = L._tp_in(L.apply_norm(lp["ln"], x1, "rmsnorm")[:, 0])
    wq, wk, wi, wf, fb = _replicated(lp, "wq", "wk", "wi", "wf", "fb")
    q = torch.einsum("bd,dhk->bhk", h, wq.to(dt)) / math.sqrt(dk)
    k = torch.einsum("bd,dhk->bhk", h, wk.to(dt)).to(F32)
    v = torch.einsum("bd,dhk->bhk", h, lp["wv"].to(dt)).to(F32)
    i_pre = torch.einsum("bd,dh->bh", h, wi.to(dt)).to(F32)
    # jnp promotes the bf16 projection with the float32 bias to float32
    f_pre = (torch.einsum("bd,dh->bh", h, wf.to(dt)) + fb).to(F32)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    w_old = torch.exp(logf + state["m"] - m_new)
    w_new = torch.exp(i_pre - m_new)
    C2 = state["C"] * w_old[..., None, None] + w_new[..., None, None] * torch.einsum(
        "bhk,bhe->bhke", k, v)
    n2 = state["n"] * w_old[..., None] + w_new[..., None] * k
    qf = q.to(F32)
    num = torch.einsum("bhk,bhke->bhe", qf, C2)
    den = torch.einsum("bhk,bhk->bh", qf, n2)
    denom = torch.maximum(torch.abs(den), torch.exp(-m_new))
    y = (num / denom[..., None]).to(dt)
    og = torch.sigmoid(torch.einsum("bd,dhe->bhe", h, lp["wo_gate"].to(dt)))
    out = x1 + L._tp_out(torch.einsum("bhe,hed->bd", y * og, lp["wo"].to(dt)))[:, None, :]
    return out, {"C": C2, "n": n2, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, sequential; block-diagonal recurrence)
# ---------------------------------------------------------------------------

def init_slstm_layer(cfg: ModelConfig, gen, *, device):
    H, D = cfg.n_heads, cfg.d_model
    dh = D // H
    return {
        "ln": L.init_norm(D, "rmsnorm", device=device),
        "wx": L._init(gen, (D, 4, D), device),                 # i, f, z, o from the input
        "rh": L._init(gen, (4, H, dh, dh), device),            # block-diagonal recurrence
        "fb": torch.full((D,), 3.0, dtype=F32, device=device),
        "wo": L._init(gen, (D, D), device),
    }


def _slstm_recurrence(cfg: ModelConfig, rh):
    """The recurrent term of this rank's gates, ``h -> (B, 4, D_loc)``,
    from the replicated blocks ``rh`` (4, H, dh, dh) and the rank's h
    (B, D_loc) in the gates' dtype: its heads' blocks where its D shard
    holds whole heads (or without tensor parallelism), else h gathered over
    ``model`` and its columns of its head's block."""
    H, dh = rh.shape[1], rh.shape[2]
    model = spmd.axis_size("model") if shd.tensor_parallel() else 1
    if H % model == 0:
        rh_l = _local(rh, 1)

        def rec(h, dt):
            hh = h.reshape(h.shape[0], rh_l.shape[1], dh).to(dt)
            return torch.einsum("bhk,ghke->bghe", hh, rh_l.to(dt)).reshape(h.shape[0], 4, -1)
        return rec
    D_loc = H * dh // model
    start = spmd.axis_index("model") * D_loc
    head, e0 = start // dh, start % dh
    rh_l = spmd.enter(rh, "model")[:, head, :, e0:e0 + D_loc]          # (4, dh, D_loc)

    def rec(h, dt):
        hh = spmd.all_gather(h, "model", dim=1).reshape(h.shape[0], H, dh)[:, head]
        return torch.einsum("bk,gke->bge", hh.to(dt), rh_l.to(dt))
    return rec


def _slstm_cell(rec, fb, gx, h, c, n, m):
    """One sLSTM step: gx (B,4,D) input gates, h (B,D) in the compute dtype,
    c, n, m (B,D) float32, with ``rec`` the recurrent term
    (:func:`_slstm_recurrence`) and the forget bias ``fb`` (D,) of the
    columns held (this rank's, under tensor parallelism) -> (h2, c2, n2,
    m2)."""
    g = (gx + rec(h, gx.dtype)).to(F32)
    i_pre, f_pre, z_pre, o_pre = g[:, 0], g[:, 1] + fb, g[:, 2], g[:, 3]
    logf = F.logsigmoid(f_pre)
    m2 = torch.maximum(logf + m, i_pre)
    iw = torch.exp(i_pre - m2)
    fw = torch.exp(logf + m - m2)
    c2 = fw * c + iw * torch.tanh(z_pre)
    n2 = fw * n + iw
    h2 = (torch.sigmoid(o_pre) * (c2 / torch.clamp(n2, min=1.0))).to(gx.dtype)
    return h2, c2, n2, m2


def slstm_block(cfg: ModelConfig, lp, x, *, return_state: bool = False):
    B, T, _ = x.shape
    hx = L._tp_in(L.apply_norm(lp["ln"], x, "rmsnorm"))
    gates_x = torch.einsum("btd,dge->btge", hx, lp["wx"].to(x.dtype))  # (B,T,4,D)
    D = gates_x.shape[-1]
    rec, fb = _slstm_recurrence(cfg, lp["rh"]), _local(lp["fb"], 0)
    h = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    c = torch.zeros((B, D), dtype=F32, device=x.device)
    n = torch.zeros((B, D), dtype=F32, device=x.device)
    m = torch.full((B, D), NEG_INIT, dtype=F32, device=x.device)
    ys = []
    for t in range(T):
        h, c, n, m = _slstm_cell(rec, fb, gates_x[:, t], h, c, n, m)
        ys.append(h)
    out = x + L._tp_out(torch.stack(ys, dim=1) @ lp["wo"].to(x.dtype))
    return (out, {"h": h, "c": c, "n": n, "m": m}) if return_state else out


def slstm_decode(cfg: ModelConfig, lp, state, x1):
    hx = L._tp_in(L.apply_norm(lp["ln"], x1, "rmsnorm")[:, 0])
    gx = torch.einsum("bd,dge->bge", hx, lp["wx"].to(x1.dtype))
    h2, c2, n2, m2 = _slstm_cell(_slstm_recurrence(cfg, lp["rh"]), _local(lp["fb"], 0), gx,
                                 state["h"], state["c"], state["n"], state["m"])
    out = x1 + L._tp_out(h2 @ lp["wo"].to(x1.dtype))[:, None, :]
    return out, {"h": h2, "c": c2, "n": n2, "m": m2}


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, gen: torch.Generator, tp: int = L.DEFAULT_TP, *,
         device: torch.device):
    layers = [init_slstm_layer(cfg, gen, device=device) if is_slstm_layer(cfg, i)
              else init_mlstm_layer(cfg, gen, device=device) for i in range(cfg.n_layers)]
    return {
        "embed": L.init_embed(gen, cfg.padded_vocab(), cfg.d_model, device=device),
        "layers": layers,
        "ln_f": L.init_norm(cfg.d_model, "rmsnorm", device=device),
    }


def backbone(cfg: ModelConfig, params, h, *, cache=None):
    """All blocks, then the final norm.  With a ``cache``, each block's
    final state is copied into it, in place."""
    for i in range(cfg.n_layers):
        blk = slstm_block if is_slstm_layer(cfg, i) else mlstm_block
        lp = shd.constrain_layer_params(params["layers"][i], index=i)
        if cache is None:
            h = blk(cfg, lp, h)
        else:
            h, st = blk(cfg, lp, h, return_state=True)
            _store(cache["layers"][i], st)
    return L.apply_norm(params["ln_f"], h, "rmsnorm")


def _store(slots: dict, state: dict) -> None:
    for key, t in state.items():
        slots[key].copy_(t)


def logits_fn(cfg: ModelConfig, params, tokens, *, tp: int = L.DEFAULT_TP):
    h = L.embed_in(cfg, params["embed"], tokens)
    return L.unembed(params["embed"], backbone(cfg, params, h), cfg.padded_vocab())


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, tp: int = L.DEFAULT_TP,
               dtype=torch.float32, device: torch.device):
    """Every layer's recurrent state (``max_len`` does not size it)."""
    H, dk, dv = _dims(cfg)
    D = cfg.d_model

    def full(shape, value=0.0, dt=F32):
        return torch.full(shape, value, dtype=dt, device=device)

    layers = []
    for i in range(cfg.n_layers):
        if is_slstm_layer(cfg, i):
            layers.append({"h": full((batch, D), dt=dtype), "c": full((batch, D)),
                           "n": full((batch, D)), "m": full((batch, D), NEG_INIT)})
        else:
            layers.append({"C": full((batch, H, dk, dv)), "n": full((batch, H, dk)),
                           "m": full((batch, H), NEG_INIT)})
    return {"pos": torch.zeros((), dtype=torch.int32, device=device), "layers": layers}


def prefill(cfg: ModelConfig, params, tokens, cache, *, tp: int = L.DEFAULT_TP):
    """Run the prompt, storing every layer's final state in the cache and
    ``pos`` = T, in place; returns (last-token logits (B,1,Vp), cache)."""
    h = L.embed_in(cfg, params["embed"], tokens)
    h = backbone(cfg, params, h, cache=cache)
    cache["pos"].fill_(tokens.shape[1])
    return L.unembed(params["embed"], h[:, -1:, :], cfg.padded_vocab()), cache


def decode_step(cfg: ModelConfig, params, cache, token, *, tp: int = L.DEFAULT_TP):
    """One decode step: token (B,1) -> (logits (B,1,Vp), cache), every
    layer's state advanced in place."""
    h = L.embed_in(cfg, params["embed"], token)
    for i in range(cfg.n_layers):
        dec = slstm_decode if is_slstm_layer(cfg, i) else mlstm_decode
        lp = shd.constrain_layer_params(params["layers"][i], index=i)
        h, st = dec(cfg, lp, cache["layers"][i], h)
        _store(cache["layers"][i], st)
    h = L.apply_norm(params["ln_f"], h, "rmsnorm")
    cache["pos"] += 1
    return L.unembed(params["embed"], h, cfg.padded_vocab()), cache
