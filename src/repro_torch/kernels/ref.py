"""Oracles for the port's kernels: naive formulas, the allclose targets.

``attention_ref``, ``decode_attention_ref`` and ``rmsnorm_ref`` are torch
transcriptions of the reference package's oracles (``kernels/ref.py``
there): two-pass softmax attention with GQA by repeating kv heads, the
causal mask bottom-right aligned (``tril(k=S-T)``), and float32 statistics.
``paged_decode_attention_ref`` is numpy: the emulator body of the
``paged_attention`` op and the allclose target of the paged kernel.  All are
copies, so the port imports nothing of the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _gqa(q, k, v):
    """float32 scores q.k/sqrt(d) with k, v heads repeated up to q's."""
    Hq, Hkv, d = q.shape[1], k.shape[1], q.shape[-1]
    if Hq != Hkv:
        k = torch.repeat_interleave(k, Hq // Hkv, dim=1)
        v = torch.repeat_interleave(v, Hq // Hkv, dim=1)
    f32 = torch.float32
    s = torch.einsum("bhtd,bhsd->bhts", q.to(f32), k.to(f32)) / math.sqrt(d)
    return s, v.to(f32)


def attention_ref(q, k, v, *, causal: bool = True):
    """q: (B,Hq,T,d); k, v: (B,Hkv,S,d): naive softmax attention with GQA."""
    T, S = q.shape[2], k.shape[2]
    s, vf = _gqa(q, k, v)
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool, device=q.device).tril(S - T)
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vf).to(q.dtype)


def decode_attention_ref(q, k, v, pos):
    """q: (B,Hq,1,d); k, v: (B,Hkv,S,d); positions > pos masked."""
    S = k.shape[2]
    s, vf = _gqa(q, k, v)
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vf).to(q.dtype)


def rmsnorm_ref(x, w, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, tables, lengths,
                               kn=None, vn=None):
    """Page-gathering oracle for the paged decode attention kernel.

    q: (B,d); k_pages, v_pages: (P,ps,d); tables: (B,npages) int32;
    lengths: (B,) int32; kn, vn: optional (B,d) fresh rows appended at
    logical position ``lengths[b]``.  Gathers each stream's live pages
    into a dense causal window and runs a plain two-pass softmax; a
    stream with nothing valid (length 0 and no fresh row) yields zeros.
    """
    q = np.asarray(q, np.float32)
    k_pages = np.asarray(k_pages, np.float32)
    v_pages = np.asarray(v_pages, np.float32)
    tables = np.asarray(tables)
    lengths = np.asarray(lengths)
    B, d = q.shape
    ps = k_pages.shape[1]
    out = np.zeros((B, d), np.float32)
    for b in range(B):
        n = int(lengths[b])
        used = range(-(-n // ps))
        k = np.concatenate([k_pages[tables[b, j]] for j in used], axis=0)[:n] \
            if n else np.zeros((0, d), np.float32)
        v = np.concatenate([v_pages[tables[b, j]] for j in used], axis=0)[:n] \
            if n else np.zeros((0, d), np.float32)
        if kn is not None:
            k = np.concatenate([k, np.asarray(kn, np.float32)[b:b + 1]], axis=0)
            v = np.concatenate([v, np.asarray(vn, np.float32)[b:b + 1]], axis=0)
        if k.shape[0] == 0:
            continue
        s = (k @ q[b]) / math.sqrt(d)
        p = np.exp(s - s.max())
        p = p / p.sum()
        out[b] = p @ v
    return out
