"""Plain float32 reference of SmolLM-360M's forward (a Llama-style dense
decoder): token embedding; per layer RMSNorm, q/k/v projections, RoPE,
causal grouped-query attention, the output projection and a residual, then
RMSNorm, the SwiGLU MLP and a residual; a final RMSNorm and the head tied to
the embedding.  Logits at every position.

Departures from the published model, both the program's and kept here so
that the two compute the same function: RMSNorm's epsilon is the
configuration's ``rms_norm_eps`` as run (1e-6; published 1e-5), and RoPE
rotates interleaved pairs (dims 2i, 2i+1) where the published code rotates
halves (dims i, i + hd/2); with random weights that is the same model under
a fixed permutation of each head's q and k columns.

The weights are made here, on the device, from the seed, and handed to the
program and to this reference alike.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from portbench.checks import round_tf32

def dims(model: dict) -> dict:
    d, hq = model["hidden_size"], model["num_attention_heads"]
    return {"L": model["num_hidden_layers"], "D": d, "Hq": hq,
            "Hkv": model["num_key_value_heads"], "hd": d // hq,
            "F": model["intermediate_size"], "V": model["vocab_size"]}


def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Normal weights drawn on ``device`` from ``seed`` in one call per kind
    (layers stacked on axis 0): the embedding at the published
    ``initializer_range``, each projection at 1/sqrt(fan-in), norm scales 1."""
    n = dims(model)
    L, D, F = n["L"], n["D"], n["F"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std

    w = {"embed": normal((n["V"], D), model["initializer_range"])}
    for key, shape in (("wq", (L, D, n["Hq"] * n["hd"])), ("wk", (L, D, n["Hkv"] * n["hd"])),
                       ("wv", (L, D, n["Hkv"] * n["hd"])), ("wo", (L, n["Hq"] * n["hd"], D)),
                       ("wg", (L, D, F)), ("wu", (L, D, F)), ("wd", (L, F, D))):
        w[key] = normal(shape, 1.0 / math.sqrt(shape[1]))
    for key in ("ln1", "ln2"):
        w[key] = torch.ones((L, D), device=device)
    w["ln_f"] = torch.ones((D,), device=device)
    return w


def _mm(a, b, tf32):
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    t, hd = x.shape[-2], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.outer(torch.arange(t, dtype=torch.float32, device=x.device), inv)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def logits(w: dict, model: dict, tokens: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """(B, T, vocab) float32 logits of (B, T) token ids."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = dims(model)
    eps, theta = model["rms_norm_eps"], model["rope_theta"]
    B, T = tokens.shape
    Hq, Hkv, hd = n["Hq"], n["Hkv"], n["hd"]
    causal = torch.ones(T, T, dtype=torch.bool, device=tokens.device).tril()
    x = w["embed"][tokens]
    for i in range(n["L"]):
        h = _rmsnorm(x, w["ln1"][i], eps)
        q = _mm(h, w["wq"][i], tf32).view(B, T, Hq, hd).transpose(1, 2)
        k = _mm(h, w["wk"][i], tf32).view(B, T, Hkv, hd).transpose(1, 2)
        v = _mm(h, w["wv"][i], tf32).view(B, T, Hkv, hd).transpose(1, 2)
        q, k = _rope(q, theta), _rope(k, theta)
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
        s = _mm(q, k.transpose(-1, -2), tf32) * (1.0 / math.sqrt(hd))
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = _mm(p, v, tf32).transpose(1, 2).reshape(B, T, Hq * hd)
        x = x + _mm(o, w["wo"][i], tf32)
        h = _rmsnorm(x, w["ln2"][i], eps)
        g = torch.nn.functional.silu(_mm(h, w["wg"][i], tf32))
        x = x + _mm(g * _mm(h, w["wu"][i], tf32), w["wd"][i], tf32)
    x = _rmsnorm(x, w["ln_f"], eps)
    return _mm(x, w["embed"].T, tf32)
