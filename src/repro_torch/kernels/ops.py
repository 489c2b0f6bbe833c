"""Public kernel entry points of the port, dispatched by tensor device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version.  There is no
fallback from one to the other and no switch to force either.
"""
from __future__ import annotations

from .decode_attention import (
    paged_decode_attention_kernel,
    paged_decode_attention_plain,
)


def paged_decode_attention(q, k_pages, v_pages, tables, lengths,
                           kn=None, vn=None):
    """Block-sparse paged decode attention (see :mod:`.decode_attention`)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, tables,
                                            lengths, kn, vn)
    return paged_decode_attention_kernel(q, k_pages, v_pages, tables, lengths,
                                         kn, vn)
