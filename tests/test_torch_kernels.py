"""The port's dense attention and RMSNorm kernels against the reference.

On CPU tensors the port's entry points (``repro_torch.kernels.ops``) run the
kernels' plain PyTorch versions.  They are held against the reference's
Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs them) and
the reference's oracles over the same cases, in float32 and bfloat16, at the
reference's tolerances: 2e-5 for attention and 1e-5 for RMSNorm in float32,
2e-2 in bfloat16.  The causal cases have T == S, where the flash kernel's
top-left mask and the oracle's bottom-right mask agree.  The port's oracles
(its plain versions and ``ref.rmsnorm_ref``) are checked against the
reference's too.

The CUDA kernels themselves are compared with their plain versions on the
card (marked ``gpu``, skipped without CUDA); the reference package is
imported inside the tests that use it, so those also run without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import ROUTES as DECODE_ROUTES
from repro_torch.kernels.decode_attention import (
    DECODE_SPLIT,
    SPLIT_KEYS,
    decode_attention_kernel,
    decode_attention_plain,
    decode_route,
)
from repro_torch.kernels.common import check_tma
from repro_torch.kernels.flash_attention import (
    flash_attention_kernel,
    flash_attention_plain,
    flash_route,
)
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_fwd_stats_kernel,
    flash_attention_fwd_stats_plain,
)
from repro_torch.kernels.rmsnorm import ROUTES as RMS_ROUTES
from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain, rmsnorm_route

ATTN_CASES = [
    # (B, Hq, Hkv, T, S, d, causal, bq, bk) -- tests/test_kernels.py; the
    # port's kernel tiles itself, bq/bk only drive the reference kernel
    (1, 2, 2, 128, 128, 32, True, 64, 64),
    (2, 4, 2, 128, 128, 64, True, 32, 64),      # GQA
    (1, 8, 2, 64, 64, 16, True, 64, 16),        # group=4
    (2, 2, 1, 96, 96, 32, False, 32, 32),       # non-causal, MQA
    (1, 2, 2, 256, 256, 128, True, 128, 128),   # MXU-aligned d
]
DECODE_CASES = [
    # (B, Hq, Hkv, S, d, pos, bk)
    (1, 2, 2, 256, 32, 255, 64),
    (2, 4, 1, 512, 64, 300, 128),    # partially-filled cache
    (1, 8, 2, 128, 16, 64, 32),
]
RMS_SHAPES = [(8, 64), (3, 5, 128), (256, 32)]
# (B, Hq, Hkv, T, S, d, causal, -, -): the tensor-core route's head dims (16,
# 64, SmolLM's; 80, Zamba2's; 128) with T and S off its 128-row tiles, causal
# with T < S and T > S, GQA 3:1 and 1:1, non-causal
ROUTE_CASES = [
    (2, 6, 2, 300, 300, 16, True, 0, 0), (1, 3, 3, 513, 513, 64, True, 0, 0),
    (2, 6, 2, 300, 513, 80, True, 0, 0), (2, 3, 3, 513, 300, 128, True, 0, 0),
    (1, 6, 2, 300, 513, 64, False, 0, 0), (1, 3, 3, 513, 300, 80, False, 0, 0),
]
DTYPES = ["float32", "bfloat16"]


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(shape, dtype, seed):
    """The same numbers as a jax array and a torch tensor of ``dtype``."""
    import jax.numpy as jnp

    x = _np(shape, seed)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, dtype, f32_tol):
    tol = 2e-2 if dtype == "bfloat16" else f32_tol
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _attn_inputs(case, dtype):
    B, Hq, Hkv, T, S, d = case[:6]
    return (_both((B, Hq, T, d), dtype, 0), _both((B, Hkv, S, d), dtype, 1),
            _both((B, Hkv, S, d), dtype, 2))


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_matches_reference(case, dtype):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    causal, bq, bk = case[6:]
    (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(case, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal, bq=bq, bk=bk), dtype, 2e-5)
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal), dtype, 2e-5)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_matches_reference(case, dtype):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    B, Hq, Hkv, S, d, pos, bk = case
    jq, tq = _both((B, Hq, 1, d), dtype, 3)
    jk, tk = _both((B, Hkv, S, d), dtype, 4)
    jv, tv = _both((B, Hkv, S, d), dtype, 5)
    got = ops.decode_attention(tq, tk, tv, torch.tensor(pos, dtype=torch.int32))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(pos, jnp.int32), bk=bk),
           dtype, 2e-5)
    _close(got, jref.decode_attention_ref(jq, jk, jv, pos), dtype, 2e-5)


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matches_reference(shape, dtype):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    jx, tx = _both(shape, dtype, 6)
    jw, tw = _both(shape[-1:], "float32", 7)
    got = ops.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, jops.rmsnorm(jx, jw), dtype, 1e-5)
    _close(got, jref.rmsnorm_ref(jx, jw), dtype, 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_torch_oracles_match_reference_oracles(dtype):
    """The port keeps one copy of each formula: the plain versions are the
    attention kernels' oracles, ``ref.rmsnorm_ref`` RMSNorm's."""
    from repro.kernels import ref as jref

    for case in ATTN_CASES:
        (jq, tq), (jk, tk), (jv, tv) = _attn_inputs(case, dtype)
        _close(flash_attention_plain(tq, tk, tv, causal=case[6]),
               jref.attention_ref(jq, jk, jv, causal=case[6]), dtype, 2e-5)
    for B, Hq, Hkv, S, d, pos, _ in DECODE_CASES:
        (jq, tq), (jk, tk), (jv, tv) = (_both((B, Hq, 1, d), dtype, 3),
                                        _both((B, Hkv, S, d), dtype, 4),
                                        _both((B, Hkv, S, d), dtype, 5))
        _close(decode_attention_plain(tq, tk, tv, torch.tensor(pos, dtype=torch.int32)),
               jref.decode_attention_ref(jq, jk, jv, pos), dtype, 2e-5)
    for shape in RMS_SHAPES:
        (jx, tx), (jw, tw) = _both(shape, dtype, 6), _both(shape[-1:], "float32", 7)
        _close(tref.rmsnorm_ref(tx, tw), jref.rmsnorm_ref(jx, jw), dtype, 1e-5)


@pytest.mark.parametrize("pos", [-1, -5])
def test_decode_nothing_visible_gives_exact_zeros(pos):
    """pos < 0: every cache position is masked; the row is exactly zero, as
    the reference kernel's explicit all-masked branch gives it."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    (jq, tq), (jk, tk), (jv, tv) = (_both((2, 4, 1, 16), "float32", 8),
                                    _both((2, 2, 32, 16), "float32", 9),
                                    _both((2, 2, 32, 16), "float32", 10))
    got = ops.decode_attention(tq, tk, tv, torch.tensor(pos, dtype=torch.int32))
    assert torch.all(got == 0.0)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(pos, jnp.int32), bk=8)
    assert np.all(np.asarray(want) == 0.0)


def test_decode_reads_the_model_cache_layout():
    """The cache in the model's (B, S, Hkv, d) layout, passed as a
    transposed view, gives what a contiguous (B, Hkv, S, d) copy gives."""
    q = torch.from_numpy(_np((2, 6, 1, 16), 11))
    cache_k = torch.from_numpy(_np((2, 40, 3, 16), 12))
    cache_v = torch.from_numpy(_np((2, 40, 3, 16), 13))
    pos = torch.tensor(25, dtype=torch.int32)
    view = ops.decode_attention(q, cache_k.transpose(1, 2), cache_v.transpose(1, 2), pos)
    copy = ops.decode_attention(q, cache_k.transpose(1, 2).contiguous(),
                                cache_v.transpose(1, 2).contiguous(), pos)
    torch.testing.assert_close(view, copy, rtol=0, atol=0)


def test_flash_causal_mask_is_top_left():
    """T != S: the kernel masks kpos <= qpos (top-left), as the reference's
    flash kernel does, not the oracle's bottom-right tril(k=S-T)."""
    q = torch.from_numpy(_np((1, 1, 4, 8), 14))
    k = torch.from_numpy(_np((1, 1, 6, 8), 15))
    v = torch.from_numpy(_np((1, 1, 6, 8), 16))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention(q, k[:, :, :4], v[:, :, :4], causal=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,d,want", [
    *((torch.bfloat16, d, "wgmma") for d in (16, 64, 80, 128, 256)),
    *((torch.float32, d, "tf32x3") for d in (16, 64, 80, 128, 256)),
    (torch.float32, 960, "tf32x3"), (torch.float32, 12, "simt"),
    (torch.bfloat16, 8, "simt"), (torch.bfloat16, 24, "simt"),
    (torch.bfloat16, 272, "simt"), (torch.bfloat16, 960, "simt"),
])
def test_flash_route_is_picked_by_dtype_and_head_dim(dtype, d, want):
    """bfloat16 at d % 16 == 0, d <= 256 takes the bf16 tensor-core body,
    float32 at d % 8 == 0, d <= 960 the 3xTF32 one, every other head dim
    the CUDA-core one."""
    assert flash_route(dtype, d) == want


def test_flash_wrappers_count_launches_by_route():
    for fn in (flash_attention_kernel, flash_attention_fwd_stats_kernel):
        assert set(fn.launches_by_route) == {"wgmma", "tf32x3", "simt"}
        assert all(isinstance(n, int) for n in fn.launches_by_route.values())
    before = dict(flash_attention_kernel.launches_by_route)
    q = torch.zeros(1, 1, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, q, q)
    assert flash_attention_kernel.launches_by_route == before
    before = dict(flash_attention_fwd_stats_kernel.launches_by_route)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_stats_kernel(q.float(), q.float(), q.float())
    assert flash_attention_fwd_stats_kernel.launches_by_route == before


def _offset_view():
    buf = torch.zeros(1 + 64, dtype=torch.bfloat16)
    return buf[1:].view(1, 1, 4, 16)             # base 2 bytes past an aligned one


@pytest.mark.parametrize("make,ok", [
    (lambda: torch.zeros(2, 3, 40, 64, dtype=torch.bfloat16), True),
    # the model's (B, T, H, d) projections, seen as (B, H, T, d)
    (lambda: torch.zeros(2, 40, 3, 80, dtype=torch.bfloat16).transpose(1, 2), True),
    (lambda: torch.zeros(1, 2, 8, 20, dtype=torch.bfloat16)[..., :16], False),  # 40-byte rows
    (_offset_view, False),
], ids=["contiguous", "model-view", "row-stride", "base-address"])
def test_tensor_core_route_refuses_what_tma_cannot_address(make, ok):
    t = make()
    if ok:
        check_tma("q", t)
    else:
        with pytest.raises(ValueError, match="TMA"):
            check_tma("q", t)


def test_kernels_refuse_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_kernel(x, torch.ones(8))
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_kernel(q[:, :, :1], q, q, torch.tensor([2], dtype=torch.int32))


@pytest.mark.parametrize("make,ok", [
    (lambda: torch.zeros(2, 3, 40, 64), True),
    (lambda: torch.zeros(2, 40, 3, 80).transpose(1, 2), True),     # the model's view
    (lambda: torch.zeros(1, 2, 8, 10)[..., :8], False),             # 40-byte rows
    (lambda: torch.zeros(1 + 64)[1:].view(1, 1, 4, 16), False),      # base 4 bytes off
], ids=["contiguous", "model-view", "row-stride", "base-address"])
def test_tf32_route_refuses_what_cp_async_cannot_address(make, ok):
    """The float32 tensor-core route copies 16-byte pieces with cp.async:
    the wrapper refuses unaligned bases and strides instead of falling back."""
    t = make()
    if ok:
        check_tma("q", t, "cp.async")
    else:
        with pytest.raises(ValueError, match="cp.async"):
            check_tma("q", t, "cp.async")


def _cache_view(B, S, Hkv, d, dtype=torch.float32):
    """The model's (B, S, Hkv, d) cache seen as (B, Hkv, S, d)."""
    return torch.zeros(B, S, Hkv, d, dtype=dtype).transpose(1, 2)


def _offset_cache(B, S, Hkv, d):
    buf = torch.zeros(1 + B * S * Hkv * d)
    return buf[1:].view(B, S, Hkv, d).transpose(1, 2)     # base 4 bytes off


@pytest.mark.parametrize("kv_dtype,d,group,make,want", [
    (torch.float32, 64, 3, lambda: _cache_view(8, 545, 5, 64), "split"),    # dense step
    (torch.float32, 80, 1, lambda: _cache_view(8, 1057, 32, 80), "split"),  # hybrid step
    (torch.bfloat16, 64, 3, lambda: _cache_view(8, 545, 5, 64, torch.bfloat16), "split"),
    (torch.float32, 16, 4, lambda: _cache_view(1, 128, 2, 16), "split"),
    (torch.float32, 128, 2, lambda: _cache_view(2, 64, 1, 128), "split"),
    (torch.bfloat16, 256, 1, lambda: _cache_view(1, 64, 1, 256, torch.bfloat16), "split"),
    (torch.float32, 18, 2, lambda: _cache_view(2, 100, 2, 18), "simt"),     # 72-byte rows
    (torch.bfloat16, 20, 1, lambda: _cache_view(2, 100, 2, 20, torch.bfloat16), "simt"),
    (torch.float32, 192, 1, lambda: _cache_view(1, 64, 1, 192), "simt"),    # 768-byte rows
    (torch.float32, 64, 16, lambda: _cache_view(1, 64, 1, 64), "simt"),     # group above 8
    (torch.float32, 128, 4, lambda: _cache_view(1, 64, 1, 128), "simt"),    # q registers
    (torch.float32, 64, 3, lambda: _offset_cache(2, 64, 5, 64), "simt"),    # base address
    (torch.float32, 64, 3,
     lambda: torch.zeros(2, 64, 5, 65)[..., :64].transpose(1, 2), "simt"),  # 260-byte rows
], ids=["dense-step", "hybrid-step", "bf16-cache", "d16-group4", "d128-group2",
        "bf16-d256", "odd-d", "odd-d-bf16", "too-wide", "group16", "q-registers",
        "base-address", "row-stride"])
def test_decode_route_is_picked_by_shape_and_alignment(kv_dtype, d, group, make, want):
    """Both step shapes of the paths take the split body; rows that are no
    16-byte multiple, too wide for its tile ring or its q registers, more
    than 8 query heads a kv head, and caches its 16-byte copies cannot
    address take the CUDA-core body."""
    k = make()
    assert decode_route(kv_dtype, d, group, k, k) == want
    assert want in DECODE_ROUTES


def test_decode_wrappers_count_launches_by_route():
    from repro_torch.kernels.decode_attention import paged_decode_attention_kernel

    for fn in (decode_attention_kernel, paged_decode_attention_kernel):
        assert set(fn.launches_by_route) == set(DECODE_ROUTES)
        assert all(isinstance(n, int) for n in fn.launches_by_route.values())
    before = (decode_attention_kernel.launches, dict(decode_attention_kernel.launches_by_route))
    q = torch.zeros(1, 2, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_kernel(q, q, q, torch.tensor([0], dtype=torch.int32))
    assert (decode_attention_kernel.launches,
            decode_attention_kernel.launches_by_route) == before


# ---------------------------------------------------------------------------
# the 3xTF32 split, modelled in plain PyTorch
# ---------------------------------------------------------------------------

def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 does: add half of the 13 dropped bits to the
    sign-magnitude pattern, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_matmul(a, b, terms: int):
    """a @ b on the modelled tensor cores: one pass (hi.hi, hi rounded to
    TF32) or the 3xTF32 split (lo = x - hi, read truncated; lo.hi + hi.lo +
    hi.hi, small terms first), float32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _tf32_attention(q, k, v, terms: int):
    """(o, m, l) of causal attention with both products on the modelled
    tensor cores (``terms`` 3: the tf32x3 route; 1: one-pass TF32)."""
    Hq, T, d = q.shape[1:]
    g = Hq // k.shape[1]
    kf, vf = (torch.repeat_interleave(t, g, dim=1) for t in (k, v))
    s = _split_matmul(q, kf.transpose(-1, -2), terms) / d ** 0.5
    mask = torch.ones(T, k.shape[2], dtype=torch.bool).tril()
    s = s.masked_fill(~mask, -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]).masked_fill(~mask, 0.0)
    l = p.sum(-1).clamp_min(1e-30)
    return _split_matmul(p, vf, terms) / l[..., None], m, l


@pytest.mark.parametrize("shape", [(2, 1, 1, 64, 960), (1, 3, 3, 64, 64), (2, 6, 2, 40, 64)],
                         ids=["attn-lm-d960", "1x3x64x64", "gqa"])
def test_tf32x3_split_keeps_the_float32_gate(shape):
    """The design's numerics where no card is present: with every product
    split into three TF32 products, o stays within the 2e-5 float32 gate of
    the plain version (m, l within 2e-4); one-pass TF32 does not."""
    B, Hq, Hkv, T, d = shape
    q = torch.from_numpy(_np((B, Hq, T, d), 30))
    k, v = (torch.from_numpy(_np((B, Hkv, T, d), s)) for s in (31, 32))
    want_o, want_m, want_l = flash_attention_fwd_stats_plain(q, k, v, causal=True)
    o, m, l = _tf32_attention(q, k, v, terms=3)
    torch.testing.assert_close(o, want_o, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(m, want_m, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(l, want_l, rtol=2e-4, atol=2e-4)
    one, _, _ = _tf32_attention(q, k, v, terms=1)
    assert (one - want_o).abs().max().item() > 2e-5


def test_tf32_rounding_model():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12])
    assert _tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0]
    hi = _tf32(x)
    assert torch.equal(hi + _tf32(x - hi), x)


# ---------------------------------------------------------------------------
# RMSNorm's two bodies
# ---------------------------------------------------------------------------

def _offset(shape, dtype):
    """A contiguous tensor whose base is one element past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(1 + n, dtype=dtype)[1:].view(*shape)


@pytest.mark.parametrize("make,want", [
    (lambda: (torch.zeros(4096, 960, dtype=torch.bfloat16), torch.zeros(960)), "vec"),
    (lambda: (torch.zeros(8, 1024, 960, dtype=torch.bfloat16), torch.zeros(960)), "vec"),
    (lambda: (torch.zeros(8192, 2560, dtype=torch.bfloat16), torch.zeros(2560)), "vec"),
    (lambda: (torch.zeros(8, 2560), torch.zeros(2560)), "vec"),
    (lambda: (torch.zeros(8, 960, dtype=torch.bfloat16), torch.zeros(960)), "vec"),
    (lambda: (torch.zeros(8, 64), torch.zeros(64)), "vec"),
    (lambda: (torch.zeros(8, 12, dtype=torch.bfloat16), torch.zeros(12)), "scalar"),
    (lambda: (torch.zeros(7, 963), torch.zeros(963)), "scalar"),
    (lambda: (torch.zeros(2, 4 * 8 * 32 * 4 + 4), torch.zeros(4 * 8 * 32 * 4 + 4)), "scalar"),
    (lambda: (_offset((4, 960), torch.float32), torch.zeros(960)), "scalar"),
    (lambda: (_offset((4, 960), torch.bfloat16), torch.zeros(960)), "scalar"),
    (lambda: (torch.zeros(4, 960), _offset((960,), torch.float32)), "scalar"),
], ids=["dense-prefill", "train", "hybrid-prefill", "hybrid-decode-f32", "decode",
        "narrow", "odd-bf16", "odd-f32", "too-wide", "offset-x-f32", "offset-x-bf16",
        "offset-w"])
def test_rmsnorm_route_is_picked_by_d_and_alignment(make, want):
    x, w = make()
    assert rmsnorm_route(x, w) == want
    assert want in RMS_ROUTES


def test_rmsnorm_counts_launches_by_route():
    assert set(rmsnorm_kernel.launches_by_route) == set(RMS_ROUTES)
    assert all(isinstance(n, int) for n in rmsnorm_kernel.launches_by_route.values())
    before = (rmsnorm_kernel.launches, dict(rmsnorm_kernel.launches_by_route))
    for x in (torch.zeros(2, 960), _offset((2, 960), torch.float32)):
        with pytest.raises(ValueError, match="CUDA"):
            rmsnorm_kernel(x, torch.ones(960))     # a refused call counts nothing
    assert (rmsnorm_kernel.launches, rmsnorm_kernel.launches_by_route) == before


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dev(shape, dtype, seed, device):
    return torch.from_numpy(_np(shape, seed)).to(device, getattr(torch, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain_on_card(dtype):
    dev = _cuda()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    stats_tol = 2e-2 if dtype == "bfloat16" else 2e-4
    for B, Hq, Hkv, T, S, d, causal, _, _ in ATTN_CASES + [
            (2, 15, 5, 512, 512, 64, True, 0, 0),
            (2, 1, 1, 128, 128, 960, True, 0, 0)] + ROUTE_CASES:
        q, k, v = (_dev((B, Hq, T, d), dtype, 0, dev), _dev((B, Hkv, S, d), dtype, 1, dev),
                   _dev((B, Hkv, S, d), dtype, 2, dev))
        route = flash_route(q.dtype, d)
        before = dict(flash_attention_kernel.launches_by_route)
        got = flash_attention_kernel(q, k, v, causal=causal)
        assert flash_attention_kernel.launches_by_route == {**before, route: before[route] + 1}
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        solo = flash_attention_kernel(q[-1:], k[-1:], v[-1:], causal=causal)
        assert torch.equal(solo[0], got[-1])
        # the model's (B, T, H, d) projections, passed as transposed views
        tv = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
        assert torch.equal(flash_attention_kernel(*tv, causal=causal), got)
        if d <= 256:
            before = dict(flash_attention_fwd_stats_kernel.launches_by_route)
            stats = flash_attention_fwd_stats_kernel(q, k, v, causal=causal)
            after = flash_attention_fwd_stats_kernel.launches_by_route
            assert after == {**before, route: before[route] + 1}
            for g, w in zip(stats, flash_attention_fwd_stats_plain(q, k, v, causal=causal)):
                torch.testing.assert_close(g.float(), w.float(), rtol=stats_tol,
                                           atol=stats_tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32")])
def test_decode_kernel_matches_plain_on_card(dtypes):
    """Every case on decode_route's body (the split one at these shapes),
    within tolerance of the plain version, exact zeros at pos < 0, a repeat
    launch and row b's solo launch bitwise equal to the batched one."""
    dev = _cuda()
    qd, kd = dtypes
    tol = 2e-2 if "bfloat16" in dtypes else 2e-5
    for B, Hq, Hkv, S, d, pos, _ in DECODE_CASES + [(8, 15, 5, 545, 64, 544, 0)]:
        q = _dev((B, Hq, 1, d), qd, 3, dev)
        ck, cv = _dev((B, S, Hkv, d), kd, 4, dev), _dev((B, S, Hkv, d), kd, 5, dev)
        kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
        route = decode_route(kt.dtype, d, Hq // Hkv, kt, vt)
        assert route == "split"
        for p in (pos, -1):
            p = torch.tensor([p], dtype=torch.int32, device=dev)
            before = dict(decode_attention_kernel.launches_by_route)
            got = decode_attention_kernel(q, kt, vt, p)
            assert decode_attention_kernel.launches_by_route == {**before,
                                                                 route: before[route] + 1}
            want = decode_attention_plain(q, kt, vt, p)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
            assert torch.equal(decode_attention_kernel(q, kt, vt, p), got)
            for b in range(B):
                solo = decode_attention_kernel(q[b:b + 1], kt[b:b + 1], vt[b:b + 1], p)
                assert torch.equal(solo[0], got[b])
        assert torch.all(got == 0.0)


def _split_positions(S):
    """pos 0 (one key: fewer tiles than ranks), the first tile's edges, the
    edges of the ranks' runs of tiles, and pos >= S - 1."""
    C = DECODE_SPLIT
    tiles = -(-S // SPLIT_KEYS)
    ranks = {SPLIT_KEYS * (r * tiles // C) for r in range(1, C)}
    return sorted({0, SPLIT_KEYS - 1, SPLIT_KEYS, *(n + dn for n in ranks for dn in (-1, 0)),
                   S - 2, S - 1, S + 3})


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 15, 5, 545, 64, "bfloat16"), (2, 32, 32, 1057, 80, "float32"),
                                  (3, 4, 1, 300, 16, "float32")],
                         ids=["dense", "hybrid", "d16"])
def test_decode_split_edges_on_card(case):
    """The split body at the edges of its key split, against the plain
    version, batched == solo and repeat launches bitwise; a head dim with
    rows of no 16-byte multiple on the CUDA-core body."""
    dev = _cuda()
    B, Hq, Hkv, S, d, qd = case
    q = _dev((B, Hq, 1, d), qd, 6, dev)
    kt = _dev((B, S, Hkv, d), "float32", 7, dev).transpose(1, 2)
    vt = _dev((B, S, Hkv, d), "float32", 8, dev).transpose(1, 2)
    tol = 2e-2 if qd == "bfloat16" else 2e-5
    for pos in _split_positions(S):
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        before = dict(decode_attention_kernel.launches_by_route)
        got = decode_attention_kernel(q, kt, vt, p)
        assert decode_attention_kernel.launches_by_route == {**before,
                                                             "split": before["split"] + 1}
        torch.testing.assert_close(got.float(), decode_attention_plain(q, kt, vt, p).float(),
                                   rtol=tol, atol=tol)
        assert torch.equal(decode_attention_kernel(q, kt, vt, p), got)
        for b in range(B):
            solo = decode_attention_kernel(q[b:b + 1], kt[b:b + 1], vt[b:b + 1], p)
            assert torch.equal(solo[0], got[b])
    q = _dev((2, 4, 1, 18), "float32", 9, dev)
    kt = _dev((2, 100, 2, 18), "float32", 10, dev).transpose(1, 2)
    p = torch.tensor([60], dtype=torch.int32, device=dev)
    before = dict(decode_attention_kernel.launches_by_route)
    got = decode_attention_kernel(q, kt, kt, p)
    assert decode_attention_kernel.launches_by_route == {**before, "simt": before["simt"] + 1}
    torch.testing.assert_close(got, decode_attention_plain(q, kt, kt, p), rtol=2e-5, atol=2e-5)


def _assert_lse_close(got, want, tol):
    """Log-sum-exps equal within ``tol`` of max(1, |want|), and ``-inf``
    (nothing visible) on the same rows."""
    empty = torch.isneginf(want)
    assert torch.equal(torch.isneginf(got), empty)
    err = (got[~empty] - want[~empty]).abs() / want[~empty].abs().clamp_min(1.0)
    assert err.numel() == 0 or err.max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 15, 5, 545, 64, "bfloat16", "float32", "split"),
                                  (1, 32, 32, 4096, 80, "float32", "bfloat16", "split"),
                                  (2, 4, 2, 100, 18, "float32", "float32", "simt")],
                         ids=["dense", "sequence-parallel", "d18"])
def test_decode_lse_matches_plain_on_card(case):
    """Row 2's optional log-sum-exp (``return_lse``) on both bodies against
    the plain version: o unchanged by asking for it, the lse within the
    float32 tolerance relative to its magnitude, ``-inf`` where nothing is
    visible; at the split body's key-run edges and past the cache."""
    dev = _cuda()
    B, Hq, Hkv, S, d, qd, kd, route = case
    q = _dev((B, Hq, 1, d), qd, 11, dev)
    kt = _dev((B, S, Hkv, d), kd, 12, dev).transpose(1, 2)
    vt = _dev((B, S, Hkv, d), kd, 13, dev).transpose(1, 2)
    assert decode_route(kt.dtype, d, Hq // Hkv, kt, vt) == route
    tol = 2e-2 if "bfloat16" == qd else 2e-5
    for pos in sorted({-1, *_split_positions(S)}):
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        before = dict(decode_attention_kernel.launches_by_route)
        got, lse = decode_attention_kernel(q, kt, vt, p, return_lse=True)
        assert decode_attention_kernel.launches_by_route == {**before,
                                                             route: before[route] + 1}
        want, want_lse = decode_attention_plain(q, kt, vt, p, return_lse=True)
        torch.cuda.synchronize()
        assert lse.shape == (B, Hq) and lse.dtype == torch.float32
        assert torch.equal(decode_attention_kernel(q, kt, vt, p), got)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        _assert_lse_close(lse, want_lse, 2e-5)
        assert pos >= 0 or bool(torch.isneginf(lse).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain_on_card(dtype):
    dev = _cuda()
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for shape in RMS_SHAPES + [(4096, 960), (8, 960)]:
        x, w = _dev(shape, dtype, 6, dev), _dev(shape[-1:], "float32", 7, dev)
        got, want = rmsnorm_kernel(x, w), rmsnorm_plain(x, w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# (B, Hq, Hkv, T, S, d, causal): the float32 launches the 3xTF32 body takes
# on the paths (the attn LM's d = 960 prefill, the mixed forward's
# (2,15,256,64)), a short d = 960 tile, the smallest head dim, and short last
# tiles with causal T < S and T > S
TF32_CASES = [(8, 1, 1, 128, 128, 960, True), (2, 1, 1, 70, 70, 960, True),
              (2, 15, 5, 256, 256, 64, True), (1, 2, 1, 33, 40, 8, True),
              (2, 6, 2, 300, 513, 80, True), (2, 3, 3, 513, 300, 128, True),
              (1, 2, 2, 65, 65, 200, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ATTN_CASES + TF32_CASES, ids=str)
def test_tf32x3_route_matches_plain_on_card(case):
    """The float32 tensor-core body: o within 2e-5 of the plain version, m
    and l within 2e-4, every launch on ``"tf32x3"``; the forward with
    statistics gives the flash forward's o bitwise (one body); batched ==
    solo and strided views == contiguous inputs, bitwise."""
    dev = _cuda()
    B, Hq, Hkv, T, S, d, causal = case[:7]
    q, k, v = (_dev((B, Hq, T, d), "float32", 20, dev),
               _dev((B, Hkv, S, d), "float32", 21, dev),
               _dev((B, Hkv, S, d), "float32", 22, dev))
    assert flash_route(torch.float32, d) == "tf32x3"
    before = flash_attention_kernel.launches_by_route["tf32x3"]
    got = flash_attention_kernel(q, k, v, causal=causal)
    assert flash_attention_kernel.launches_by_route["tf32x3"] == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for b in range(B):
        solo = flash_attention_kernel(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal)
        assert torch.equal(solo[0], got[b])
    tv = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert torch.equal(flash_attention_kernel(*tv, causal=causal), got)
    if d <= 256:
        before = flash_attention_fwd_stats_kernel.launches_by_route["tf32x3"]
        o, m, l = flash_attention_fwd_stats_kernel(q, k, v, causal=causal)
        assert flash_attention_fwd_stats_kernel.launches_by_route["tf32x3"] == before + 1
        assert torch.equal(o, got)
        _, pm, pl = flash_attention_fwd_stats_plain(q, k, v, causal=causal)
        torch.testing.assert_close(m, pm, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(l, pl, rtol=2e-4, atol=2e-4)
        for g, w in zip(flash_attention_fwd_stats_kernel(*tv, causal=causal), (o, m, l)):
            assert torch.equal(g, w)


# every RMSNorm shape of the paths (dense prefill and decode, the train
# step, the hybrid prefill and its float32 decode), a narrow D, an odd D and
# offset views: (shape, dtype, offset, route)
RMS_CARD_CASES = [((4096, 960), "bfloat16", False, "vec"), ((8, 960), "bfloat16", False, "vec"),
                  ((8, 1024, 960), "bfloat16", False, "vec"),
                  ((8192, 2560), "bfloat16", False, "vec"), ((8, 2560), "float32", False, "vec"),
                  ((2, 256, 960), "float32", False, "vec"), ((8, 64), "float32", False, "vec"),
                  ((7, 963), "float32", False, "scalar"), ((5, 12), "bfloat16", False, "scalar"),
                  ((4, 960), "float32", True, "scalar"), ((4, 960), "bfloat16", True, "scalar")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RMS_CARD_CASES, ids=str)
def test_rmsnorm_routes_match_plain_on_card(case):
    dev = _cuda()
    shape, dtype, offset, route = case
    x = _dev(shape, dtype, 23, dev)
    if offset:        # the same values one element past a 16-byte boundary
        x = torch.zeros(1 + x.numel(), dtype=x.dtype, device=dev)[1:].view(*shape).copy_(x)
    w = _dev(shape[-1:], "float32", 24, dev)
    assert rmsnorm_route(x, w) == route
    before = rmsnorm_kernel.launches_by_route[route]
    got = rmsnorm_kernel(x, w)
    assert rmsnorm_kernel.launches_by_route[route] == before + 1
    want = rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    rows = x.reshape(-1, shape[-1])
    solo = rmsnorm_kernel(rows[-1:].contiguous(), w)
    assert torch.equal(solo[0], got.reshape(-1, shape[-1])[-1])
