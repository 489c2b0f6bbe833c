"""Numpy oracles for the port's kernels (the guest side's semantics).

``paged_decode_attention_ref`` is the emulator body of the
``paged_attention`` op and the allclose target of the paged kernel; it is a
copy of the reference package's oracle, kept here so the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import math

import numpy as np


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
