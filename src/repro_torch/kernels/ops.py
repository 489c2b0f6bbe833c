"""Public kernel entry points of the port, dispatched by tensor device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version.  There is no
fallback from one to the other and no switch to force either.
"""
from __future__ import annotations

from .decode_attention import (
    decode_attention_kernel,
    decode_attention_plain,
    paged_decode_attention_kernel,
    paged_decode_attention_plain,
)
from .flash_attention import flash_attention_kernel, flash_attention_plain
from .flash_attention_bwd import FlashAttentionFn
from .rmsnorm import RMSNormFn, rmsnorm_kernel, rmsnorm_plain
from .ssm_scan import ssd_scan_kernel, ssd_scan_plain


def paged_decode_attention(q, k_pages, v_pages, tables, lengths,
                           kn=None, vn=None):
    """Block-sparse paged decode attention (see :mod:`.decode_attention`)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, tables,
                                            lengths, kn, vn)
    return paged_decode_attention_kernel(q, k_pages, v_pages, tables, lengths,
                                         kn, vn)


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Tiled online-softmax attention, q (B,Hq,T,d) against k, v (B,Hkv,S,d),
    causal mask ``kpos <= qpos`` (see :mod:`.flash_attention`)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    return flash_attention_kernel(q, k, v, causal=causal, scale=scale)


def flash_attention_trainable(q, k, v, *, causal: bool = True):
    """Differentiable flash attention, q (B,Hq,T,d) against k, v (B,Hkv,S,d):
    forward with statistics, then dQ and dK/dV, each the CUDA kernel on the
    card and its plain version on the CPU (see :mod:`.flash_attention_bwd`)."""
    return FlashAttentionFn.apply(q, k, v, causal)


def decode_attention(q, k, v, pos):
    """One query row per (b, q head) against a cache, positions ``<= pos``
    visible (see :mod:`.decode_attention`)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos)
    return decode_attention_kernel(q, k, v, pos)


def rmsnorm(x, w, *, eps: float = 1e-6):
    """Rowwise RMSNorm over the last axis (see :mod:`.rmsnorm`)."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    return rmsnorm_kernel(x, w, eps)


def rmsnorm_trainable(x, w, *, eps: float = 1e-6):
    """Differentiable RMSNorm: the kernel (card) or the plain version (CPU)
    forward, the closed-form float32 backward (see :mod:`.rmsnorm`)."""
    return RMSNormFn.apply(x, w, eps)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, return_state: bool = False):
    """Mamba2 SSD chunked scan, x (B,T,H,P), dt (B,T,H), A (H,), B, C (B,T,N)
    -> y (B,T,H,P) [and the final state (B,H,N,P)] (see :mod:`.ssm_scan`)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk, return_state=return_state)
    return ssd_scan_kernel(x, dt, A, B, C, chunk=chunk, return_state=return_state)


# the inference kernels' wrappers, each counting its launches per route
_COUNTED = {"rmsnorm": rmsnorm_kernel, "flash_attention": flash_attention_kernel,
            "decode_attention": decode_attention_kernel,
            "paged_decode_attention": paged_decode_attention_kernel,
            "ssd_scan": ssd_scan_kernel}


def launches_by_route() -> dict:
    """This process's launches of each inference kernel per route since the
    last :func:`reset_launches`, ``{kernel: {route: n}}``."""
    return {name: dict(fn.launches_by_route) for name, fn in _COUNTED.items()}


def reset_launches() -> None:
    """Set every inference kernel's launch counts to 0."""
    for fn in _COUNTED.values():
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
