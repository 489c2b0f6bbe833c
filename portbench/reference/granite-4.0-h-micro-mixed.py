"""Plain float32 reference of Granite 4.0-H Micro's forward (HF
``granitemoehybrid``): the token embedding times ``embedding_multiplier``;
per layer, RMSNorm, the layer's sequence mixer (a Mamba-2 mixer, or causal
grouped-query attention with no positional encoding at the softmax scale
``attention_multiplier``) and a residual add of its output times
``residual_multiplier``, then RMSNorm, the SwiGLU MLP (``input_linear`` to
gate and up, ``output_linear``) and a residual add scaled alike; a final
RMSNorm and the head tied to the embedding, divided by ``logits_scaling``.
Logits at every position.  Every RMSNorm at ``rms_norm_eps``.

The Mamba-2 mixer (HF ``Mamba2Mixer``, one group): ``in_proj`` to z, xBC and
dt; a causal depthwise conv of width ``mamba_d_conv`` with bias over xBC,
then SiLU, split into x (heads of ``mamba_d_head``), B and C
(``mamba_d_state``); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
the SSD ``y = SSD(x, dt, A, B, C) + D x``; ``rmsnorm(y * silu(z))`` over the
inner width with its own weight; ``out_proj``.  The SSD is computed whole,
without chunks, in its quadratic (dual) form per head:
``y = (L o C B^T) (dt x)`` with ``L[t, s] = exp(sum_{s < r <= t} dt_r A)``
for s <= t and 0 above, built from a segment sum: no chunked recurrence, so
it shares no algorithm with the program's scan.

The weights are made here, on the device, from the seed, and handed to the
program and to this reference alike.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.checks import round_tf32


def dims(model: dict) -> dict:
    d, hq = model["hidden_size"], model["num_attention_heads"]
    H, P, N = model["mamba_n_heads"], model["mamba_d_head"], model["mamba_d_state"]
    G = model["mamba_n_groups"]
    if G != 1:
        raise ValueError(f"one group of B and C, got mamba_n_groups {G}")
    types = model["layer_types"]
    return {"L": model["num_hidden_layers"], "D": d, "Hq": hq,
            "Hkv": model["num_key_value_heads"], "hd": d // hq,
            "F": model["shared_intermediate_size"], "V": model["vocab_size"],
            "H": H, "P": P, "N": N, "K": model["mamba_d_conv"], "I": H * P,
            "types": types, "Lm": types.count("mamba"), "La": types.count("attention")}


def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Weights drawn on ``device`` from ``seed``, one call per kind with the
    layers of a kind stacked on axis 0 (mamba and attention layers each in
    their own order): the embedding normal at 0.02; each linear normal at
    1/sqrt(fan-in); the conv's weight and bias uniform in (-1/2, 1/2),
    PyTorch's ``Conv1d`` default at fan-in ``mamba_d_conv`` = 4; ``A_log`` =
    log(1..H) and ``D`` = 1, the published Mamba-2 initialisation;
    ``dt_bias`` the inverse softplus of dt drawn log-uniform in [1e-3, 0.1],
    Mamba-2's; every norm weight 1."""
    n = dims(model)
    D, F_, I, N, H, K = n["D"], n["F"], n["I"], n["N"], n["H"], n["K"]
    Lm, La, L = n["Lm"], n["La"], n["L"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    f32 = dict(device=device, dtype=torch.float32)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, **f32) * std

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, **f32)

    conv_dim = I + 2 * N
    w = {"embed": normal((n["V"], D), 0.02)}
    for key, shape in (("in_proj", (Lm, D, 2 * I + 2 * N + H)), ("out_proj", (Lm, I, D)),
                       ("wq", (La, D, n["Hq"] * n["hd"])), ("wk", (La, D, n["Hkv"] * n["hd"])),
                       ("wv", (La, D, n["Hkv"] * n["hd"])), ("wo", (La, n["Hq"] * n["hd"], D)),
                       ("w_in", (L, D, 2 * F_)), ("w_out", (L, F_, D))):
        w[key] = normal(shape, 1.0 / math.sqrt(shape[1]))
    w["conv_w"] = uniform((Lm, conv_dim, K), -0.5, 0.5)
    w["conv_b"] = uniform((Lm, conv_dim), -0.5, 0.5)
    dt = torch.exp(uniform((Lm, H), math.log(1e-3), math.log(0.1)))
    w["dt_bias"] = dt + torch.log(-torch.expm1(-dt))          # softplus(dt_bias) = dt
    w["A_log"] = torch.log(torch.arange(1, H + 1, **f32)).expand(Lm, H).contiguous()
    w["D"] = torch.ones((Lm, H), **f32)
    w["mnorm"] = torch.ones((Lm, I), **f32)
    for key in ("ln1", "ln2"):
        w[key] = torch.ones((L, D), **f32)
    w["ln_f"] = torch.ones((D,), **f32)
    return w


def _mm(a, b, tf32):
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): ``sum_{s < r <= t} a_r`` at [t, s] for s <= t,
    -inf above the diagonal; each entry summed from its own terms."""
    T = a.shape[-1]
    rep = a[..., None].expand(*a.shape, T)                       # [r, s] = a_r
    strict = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    out = torch.cumsum(rep.masked_fill(~strict, 0.0), dim=-2)   # [t, s] = sum_{s<r<=t}
    lower = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~lower, float("-inf"))


def ssd(x, dt, A, B, C, *, tf32: bool = False):
    """The SSD in its quadratic form: x (b, T, H, P), dt (b, T, H), A (H,),
    B and C (b, T, N) -> y (b, T, H, P), with no chunks."""
    L = torch.exp(segsum((dt * A).transpose(1, 2)))              # (b, H, T, T)
    G = _mm(C, B.transpose(1, 2), tf32)                          # (b, T, T)
    M = L * G[:, None]
    xdt = (x * dt[..., None]).transpose(1, 2)                    # (b, H, T, P)
    return _mm(M, xdt, tf32).transpose(1, 2)


def _mamba(u, w, j, n, eps, tf32):
    I, N, H, P, K = n["I"], n["N"], n["H"], n["P"], n["K"]
    b, T, _ = u.shape
    zxbcdt = _mm(u, w["in_proj"][j], tf32)
    z, xbc, dt = zxbcdt.split([I, I + 2 * N, H], dim=-1)
    cw = w["conv_w"][j]
    if tf32:
        xbc, cw = round_tf32(xbc), round_tf32(cw)
    xbc = F.conv1d(xbc.transpose(1, 2), cw[:, None, :], w["conv_b"][j], padding=K - 1,
                   groups=xbc.shape[-1])[..., :T].transpose(1, 2)
    x, B, C = F.silu(xbc).split([I, N, N], dim=-1)
    dt = F.softplus(dt + w["dt_bias"][j])
    A = -torch.exp(w["A_log"][j])
    xh = x.reshape(b, T, H, P)
    y = ssd(xh, dt, A, B, C, tf32=tf32) + xh * w["D"][j][:, None]
    y = _rmsnorm(y.reshape(b, T, I) * F.silu(z), w["mnorm"][j], eps)
    return _mm(y, w["out_proj"][j], tf32)


def _attention(h, w, j, n, scale, tf32):
    b, T, _ = h.shape
    Hq, Hkv, hd = n["Hq"], n["Hkv"], n["hd"]
    q = _mm(h, w["wq"][j], tf32).view(b, T, Hq, hd).transpose(1, 2)
    k = _mm(h, w["wk"][j], tf32).view(b, T, Hkv, hd).transpose(1, 2)
    v = _mm(h, w["wv"][j], tf32).view(b, T, Hkv, hd).transpose(1, 2)
    k = k.repeat_interleave(Hq // Hkv, dim=1)
    v = v.repeat_interleave(Hq // Hkv, dim=1)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    s = _mm(q, k.transpose(-1, -2), tf32) * scale
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = _mm(p, v, tf32).transpose(1, 2).reshape(b, T, Hq * hd)
    return _mm(o, w["wo"][j], tf32)


def logits(w: dict, model: dict, tokens: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """(B, T, vocab) float32 logits of (B, T) token ids."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = dims(model)
    eps, r = model["rms_norm_eps"], model["residual_multiplier"]
    x = w["embed"][tokens] * model["embedding_multiplier"]
    jm = ja = 0
    for i, kind in enumerate(n["types"]):
        h = _rmsnorm(x, w["ln1"][i], eps)
        if kind == "mamba":
            out = _mamba(h, w, jm, n, eps, tf32)
            jm += 1
        else:
            out = _attention(h, w, ja, n, model["attention_multiplier"], tf32)
            ja += 1
        x = x + out * r
        h = _rmsnorm(x, w["ln2"][i], eps)
        gate, up = _mm(h, w["w_in"][i], tf32).chunk(2, dim=-1)
        x = x + _mm(F.silu(gate) * up, w["w_out"][i], tf32) * r
    x = _rmsnorm(x, w["ln_f"], eps)
    return _mm(x, w["embed"].T, tf32) / model["logits_scaling"]
