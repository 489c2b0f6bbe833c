"""Oracles of the port's kernels that are not their plain versions.

Each formula has one copy in the port.  ``rmsnorm_ref`` (float32
statistics) is also the RMSNorm kernel's plain version.  ``ssd_scan_ref`` is
the SSD recurrence taken one step at a time, the definition that the SSD
kernel and its plain version (both in the chunked form) are held to.
``paged_decode_attention_ref`` is numpy: the emulator body of the
``paged_attention`` op and the allclose target of the paged kernel.  The
dense attention kernels' oracles are their plain versions
(``flash_attention_plain``, ``decode_attention_plain``), held against the
reference package's ``attention_ref`` and ``decode_attention_ref`` in the
tests.  All are transcriptions of the reference package's
``kernels/ref.py``, so the port imports nothing of the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rmsnorm_ref(x, w, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def ssd_scan_ref(x, dt, A, B, C):
    """Sequential-scan SSD (the definitionally correct recurrence).

    x: (B,T,H,P); dt: (B,T,H); A: (H,); B, C: (B,T,N) -> y (B,T,H,P) in
    x's dtype; the state is float32.
    """
    f32 = torch.float32
    Bs, T, H, P = x.shape
    N = B.shape[-1]
    dt = dt.to(f32)
    S = torch.zeros((Bs, H, N, P), dtype=f32, device=x.device)
    ys = []
    for t in range(T):
        dec = torch.exp(dt[:, t] * A)                                # (B,H)
        S = S * dec[..., None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", B[:, t].to(f32), dt[:, t], x[:, t].to(f32))
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t].to(f32), S))
    return torch.stack(ys, dim=1).to(x.dtype)


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
