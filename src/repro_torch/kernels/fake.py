"""Shape-only stand-ins of the kernels, for tensors that carry no data.

A meta tensor, or a fake one (``torch._subclasses.fake_tensor``), has a
shape, a dtype and a device but no values, so neither a kernel nor its plain
version can run on it; and running the plain version for its shapes alone
would count transients the card never holds (plain attention's (B, H, T, S)
float32 scores).  :mod:`repro_torch.kernels.ops` and the kernels' autograd
functions send such tensors here, chosen by the tensor's kind
(:func:`shape_only`), never by catching an error.  Each function returns
empty outputs of the shapes and dtypes its kernel returns on the card,
counts the call as route ``"fake"`` in the kernel's ``launches_by_route``
(the key appears with the first such call; ``launches`` counts card launches
only, so it does not move) and adds the floating-point operations the
kernel would do on these shapes to :data:`flops`.  The launch dry run
(:mod:`repro_torch.launch.dryrun`) runs every step this way.

FLOPs count a multiply-add as two.  Attention counts the visible
(query, key) pairs: the causal mask ``kpos <= qpos`` from the top left, and
every cache position of a decode (its ``pos`` has no value here).
"""
from __future__ import annotations

import importlib
import sys
from collections import Counter

import torch

flops: Counter = Counter()

# kernel name -> (module, wrapper) whose launches_by_route counts the calls
_WRAPPERS = {
    "rmsnorm": ("rmsnorm", "rmsnorm_kernel"),
    "flash_attention": ("flash_attention", "flash_attention_kernel"),
    "decode_attention": ("decode_attention", "decode_attention_kernel"),
    "paged_decode_attention": ("decode_attention", "paged_decode_attention_kernel"),
    "ssd_scan": ("ssm_scan", "ssd_scan_kernel"),
    "flash_attention_fwd_stats": ("flash_attention_bwd", "flash_attention_fwd_stats_kernel"),
    "flash_attention_dq": ("flash_attention_bwd", "flash_attention_dq_kernel"),
    "flash_attention_dkv": ("flash_attention_bwd", "flash_attention_dkv_kernel"),
}


def shape_only(t) -> bool:
    """Whether ``t`` is a tensor without data: on the meta device, or a
    fake tensor."""
    if not isinstance(t, torch.Tensor):
        return False
    if t.device.type == "meta":
        return True
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    return fake is not None and isinstance(t, fake.FakeTensor)


def _count(name: str, n_flops: int) -> None:
    module, attr = _WRAPPERS[name]
    wrapper = getattr(importlib.import_module(f"{__package__}.{module}"), attr)
    wrapper.launches_by_route["fake"] = wrapper.launches_by_route.get("fake", 0) + 1
    flops[name] += int(n_flops)


def reset() -> None:
    """Zero :data:`flops` and every kernel's ``"fake"`` count."""
    flops.clear()
    for module, attr in _WRAPPERS.values():
        wrapper = getattr(importlib.import_module(f"{__package__}.{module}"), attr)
        wrapper.launches_by_route.pop("fake", None)


def visible_pairs(T: int, S: int, causal: bool) -> int:
    """(query, key) pairs an attention of T queries over S keys computes:
    all of them, or under ``kpos <= qpos`` sum over i < T of min(i + 1, S)."""
    if not causal:
        return T * S
    n = min(T, S)
    return n * (n + 1) // 2 + (T - n) * S


def rmsnorm(x, w, eps: float = 1e-6):
    _count("rmsnorm", 4 * x.numel())
    return x.new_empty(x.shape)


def _attn_pairs(q, k, causal: bool) -> int:
    B, Hq, T, _ = q.shape
    return B * Hq * visible_pairs(T, k.shape[2], causal)


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    _count("flash_attention", 4 * q.shape[-1] * _attn_pairs(q, k, causal))
    return q.new_empty(tuple(q.shape[:-1]) + (v.shape[-1],))


def flash_attention_fwd_stats(q, k, v, *, causal: bool = True, scale=None):
    _count("flash_attention_fwd_stats", 4 * q.shape[-1] * _attn_pairs(q, k, causal))
    stats = tuple(q.shape[:-1])
    return (q.new_empty(tuple(q.shape[:-1]) + (v.shape[-1],)),
            q.new_empty(stats, dtype=torch.float32), q.new_empty(stats, dtype=torch.float32))


def flash_attention_dq(q, k, v, do, m, l, delta, *, causal: bool = True, scale=None):
    # the scores, dO.V^T and dS.K: three products a visible pair
    _count("flash_attention_dq", 6 * q.shape[-1] * _attn_pairs(q, k, causal))
    return q.new_empty(q.shape)


def flash_attention_dkv(q, k, v, do, m, l, delta, *, causal: bool = True, scale=None):
    # the scores, P^T.dO, dO.V^T and dS^T.Q: four products a visible pair
    _count("flash_attention_dkv", 8 * q.shape[-1] * _attn_pairs(q, k, causal))
    return k.new_empty(k.shape), v.new_empty(v.shape)


def decode_attention(q, k, v, pos, *, return_lse: bool = False):
    B, Hq, _, d = q.shape
    _count("decode_attention", 4 * B * Hq * k.shape[2] * d)
    out = q.new_empty((B, Hq, 1, d))
    return (out, q.new_empty((B, Hq), dtype=torch.float32)) if return_lse else out


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, kn=None, vn=None):
    B, d = q.shape
    keys = tables.shape[1] * k_pages.shape[1] + (kn is not None)
    _count("paged_decode_attention", 4 * B * keys * d)
    return q.new_empty((B, d), dtype=torch.float32)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, return_state: bool = False):
    Bsz, T, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, T)
    nc = -(-T // Q)
    # per chunk: C.B^T, the masked intra-chunk product, the chunk's state
    # and the carried state's output term
    _count("ssd_scan", Bsz * nc * (2 * Q * Q * N + 2 * Q * Q * H * P + 4 * Q * N * H * P))
    y = x.new_empty((Bsz, T, H, P))
    if return_state:
        return y, x.new_empty((Bsz, H, N, P), dtype=torch.float32)
    return y
