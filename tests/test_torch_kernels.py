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
from repro_torch.kernels.decode_attention import (
    decode_attention_kernel,
    decode_attention_plain,
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
from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain

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
    *((torch.float32, d, "simt") for d in (16, 64, 80, 128, 256)),
    (torch.bfloat16, 8, "simt"), (torch.bfloat16, 24, "simt"),
    (torch.bfloat16, 272, "simt"), (torch.bfloat16, 960, "simt"),
])
def test_flash_route_is_picked_by_dtype_and_head_dim(dtype, d, want):
    """bfloat16 at d % 16 == 0, d <= 256 takes the tensor-core body; float32
    (its 2e-5 tolerance) and every other head dim the CUDA-core one."""
    assert flash_route(dtype, d) == want


def test_flash_wrappers_count_launches_by_route():
    for fn in (flash_attention_kernel, flash_attention_fwd_stats_kernel):
        assert set(fn.launches_by_route) == {"wgmma", "simt"}
        assert all(isinstance(n, int) for n in fn.launches_by_route.values())
    before = dict(flash_attention_kernel.launches_by_route)
    q = torch.zeros(1, 1, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, q, q)
    assert flash_attention_kernel.launches_by_route == before


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
    dev = _cuda()
    qd, kd = dtypes
    tol = 2e-2 if "bfloat16" in dtypes else 2e-5
    for B, Hq, Hkv, S, d, pos, _ in DECODE_CASES + [(8, 15, 5, 545, 64, 544, 0)]:
        q = _dev((B, Hq, 1, d), qd, 3, dev)
        ck, cv = _dev((B, S, Hkv, d), kd, 4, dev), _dev((B, S, Hkv, d), kd, 5, dev)
        for p in (pos, -1):
            p = torch.tensor([p], dtype=torch.int32, device=dev)
            got = decode_attention_kernel(q, ck.transpose(1, 2), cv.transpose(1, 2), p)
            want = decode_attention_plain(q, ck.transpose(1, 2), cv.transpose(1, 2), p)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        assert torch.all(got == 0.0)


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
