"""The op set's kernels as registered torch operators (``repro_torch::``).

The kernels are C entry points called through ``ctypes``, which
``torch.export`` cannot trace.  Registered here as operators with a fake
(shape and dtype only) implementation, each one is a single node of an
exported graph — ``torch.ops.repro_torch.rmsnorm.default`` and so on — so
an offload unit that reaches a kernel can be saved with
``torch.export.save`` and loaded in another process
(:mod:`repro_torch.serve.aot`).

* ``repro_torch::rmsnorm(x, w, eps)`` — row 7, RMSNorm;
* ``repro_torch::flash_attention(q, k, v, causal, scale)`` — row 3, the
  flash-attention forward;
* ``repro_torch::paged_decode_attention(q, k_pages, v_pages, tables,
  lengths, kn, vn)`` — row 1, block-sparse paged decode attention;
* ``repro_torch::ssd_scan(x, dt, A, B, C, chunk)`` — row 8, the SSD
  (Mamba-2) chunked scan, y only.

The CUDA implementation is the :mod:`.ops` call, which launches the kernel
or raises; the CPU implementation is the op set's plain formula (for
``rmsnorm`` and ``flash_attention`` the op set's own CPU body, which masks
a causal T != S bottom-right as the reference's op does; for ``ssd_scan``
the kernel's plain chunked version).  The operators
are defined with ``torch.library.Library("repro_torch", "DEF")`` and plain
``define``/``impl``, the registration with the least dispatch cost per
call.  Importing this module registers them; it builds no kernel.
"""
from __future__ import annotations

import math

import torch

from . import ops

_LIB = torch.library.Library("repro_torch", "DEF")

_LIB.define("rmsnorm(Tensor x, Tensor w, float eps) -> Tensor")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "float? scale) -> Tensor")
_LIB.define("paged_decode_attention(Tensor q, Tensor k_pages, Tensor v_pages, "
            "Tensor tables, Tensor lengths, Tensor? kn, Tensor? vn) -> Tensor")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, int chunk) -> Tensor")


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


def _rmsnorm_cpu(x, w, eps):
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w).to(x.dtype)


def _rmsnorm_cuda(x, w, eps):
    return ops.rmsnorm(x.contiguous(), w, eps=eps)


def _rmsnorm_fake(x, w, eps):
    return torch.empty_like(x)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _flash_attention_cpu(q, k, v, causal, scale):
    B, Hq, T, D = q.shape
    Hk = k.shape[1]
    if Hq != Hk:
        k = torch.repeat_interleave(k, Hq // Hk, dim=1)
        v = torch.repeat_interleave(v, Hq // Hk, dim=1)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    S = k.shape[2]
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool, device=q.device).tril(S - T)
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=torch.float32, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def _flash_attention_cuda(q, k, v, causal, scale):
    return ops.flash_attention(q, k, v, causal=causal, scale=scale)


def _flash_attention_fake(q, k, v, causal, scale):
    return q.new_empty(tuple(q.shape[:-1]) + (v.shape[-1],))


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def _paged_decode_attention(q, k_pages, v_pages, tables, lengths, kn, vn):
    # ops dispatches by device: the plain version on the CPU, the kernel on CUDA
    return ops.paged_decode_attention(q, k_pages, v_pages, tables, lengths, kn, vn)


def _paged_decode_attention_fake(q, k_pages, v_pages, tables, lengths, kn, vn):
    return torch.empty_like(q)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------


def _ssd_scan(x, dt, A, B, C, chunk):
    # ops dispatches by device: the plain version on the CPU, the kernel on CUDA
    return ops.ssd_scan(x, dt, A, B, C, chunk=chunk)


def _ssd_scan_fake(x, dt, A, B, C, chunk):
    return x.new_empty(tuple(x.shape))


for _name, _cpu, _cuda, _fake in (
    ("rmsnorm", _rmsnorm_cpu, _rmsnorm_cuda, _rmsnorm_fake),
    ("flash_attention", _flash_attention_cpu, _flash_attention_cuda,
     _flash_attention_fake),
    ("paged_decode_attention", _paged_decode_attention, _paged_decode_attention,
     _paged_decode_attention_fake),
    ("ssd_scan", _ssd_scan, _ssd_scan, _ssd_scan_fake),
):
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=_LIB)

rmsnorm = torch.ops.repro_torch.rmsnorm.default
flash_attention = torch.ops.repro_torch.flash_attention.default
paged_decode_attention = torch.ops.repro_torch.paged_decode_attention.default
ssd_scan = torch.ops.repro_torch.ssd_scan.default

# the kernel sources these operators launch on CUDA (``build.build`` names)
SOURCES = ("flash_attention", "rmsnorm", "paged_decode_attention", "ssm_scan")


# ---------------------------------------------------------------------------
# sharding rules (DTensor) for sharded offload units
# ---------------------------------------------------------------------------

_RULES_REGISTERED = False


def register_sharding_rules() -> None:
    """Teach DTensor the three operators, for the sharded offload units of
    :mod:`repro_torch.parallel.units` (idempotent; imports DTensor only
    here).  Each rule lists the placements under which the operator runs on
    a rank's local tensors, per mesh axis; any other placement of the inputs
    is redistributed to replicated before the call, so the kernel always
    runs, on whole rows, heads or sequences:

    * ``rmsnorm``: local over any dim but the normalised last one (w
      replicated);
    * ``flash_attention``: local over the batch, or over the heads where
      the kv heads split as evenly as the q heads (each rank keeps whole
      GQA groups);
    * ``paged_decode_attention``: local over the batch (q, the fresh rows,
      the block tables and lengths split; the page pools replicated).
    """
    global _RULES_REGISTERED
    if _RULES_REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R = Replicate()

    @register_sharding(rmsnorm)
    def _rmsnorm_rule(x, w, eps):
        rules = [([R], [R, R, None])]
        rules += [([Shard(d)], [Shard(d), R, None]) for d in range(len(x.shape) - 1)]
        return rules

    @register_sharding(flash_attention)
    def _flash_rule(q, k, v, causal, scale):
        rules = [([R], [R, R, R, None, None]), ([Shard(0)], [Shard(0)] * 3 + [None, None])]
        n = q.mesh.size()
        if q.shape[1] % n == 0 and k.shape[1] % n == 0:
            rules.append(([Shard(1)], [Shard(1)] * 3 + [None, None]))
        return rules

    @register_sharding(paged_decode_attention)
    def _paged_rule(q, k_pages, v_pages, tables, lengths, kn, vn):
        fresh = [None if t is None else R for t in (kn, vn)]
        rules = [([R], [R, R, R, R, R] + fresh)]
        fresh = [None if t is None else Shard(0) for t in (kn, vn)]
        rules.append(([Shard(0)], [Shard(0), R, R, Shard(0), Shard(0)] + fresh))
        return rules

    _RULES_REGISTERED = True
