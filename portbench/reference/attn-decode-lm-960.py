"""Plain float32 reference of the attention decode LM: one causal
self-attention layer with one head of width ``d_model``, a residual through
``tanh``, and a head to the vocabulary.

    e = E[tokens];  q, k, v = e Wq, e Wk, e Wv
    a = softmax(q k^T / sqrt(d), causal) v
    h = tanh(a Wp + e);  logits = h Wo

Decoding through a KV cache, one token a step, gives at each position what
this full causal forward gives over the prompt and the tokens fed so far,
so one forward over ``prompt + served[:-1]`` checks every served token.

The weights are drawn here, from the seed, as the program's exporter draws
them (numpy's ``default_rng(seed)``; ``standard_normal(shape) /
sqrt(shape[0])`` in float32, in the order E, Wq, Wk, Wv, Wp, Wo): a frozen
copy of the draw, so nothing the program made is read.  Imports nothing of
the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.checks import round_tf32

ORDER = ("E", "Wq", "Wk", "Wv", "Wp", "Wo")


def draw_weights(vocab: int, d: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    shapes = {"E": (vocab, d), "Wq": (d, d), "Wk": (d, d), "Wv": (d, d), "Wp": (d, d),
              "Wo": (d, vocab)}
    return {k: (rng.standard_normal(shapes[k]) / np.sqrt(shapes[k][0])).astype(np.float32)
            for k in ORDER}


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def logits(w: dict[str, torch.Tensor], tokens: torch.Tensor, *, tf32: bool = False,
           positions: slice = slice(None)) -> torch.Tensor:
    """(T, vocab) float32 logits of a 1-D token row at ``positions``, each
    from the tokens up to and including it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    e = w["E"][tokens]
    q, k, v = (matmul(e, w[n], tf32) for n in ("Wq", "Wk", "Wv"))
    t, d = e.shape
    s = matmul(q, k.T, tf32) * (1.0 / math.sqrt(d))
    causal = torch.ones(t, t, dtype=torch.bool, device=e.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    a = matmul(p, v, tf32)
    h = torch.tanh(matmul(a, w["Wp"], tf32) + e)[positions]
    return matmul(h, w["Wo"], tf32)
