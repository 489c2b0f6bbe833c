"""The port's trainable flash attention and RMSNorm against the reference.

On the CPU, ``FlashAttentionFn`` runs the three kernels' plain versions.
Against the reference's Pallas kernels in interpret mode:
``flash_attention_fwd_stats_plain`` against ``_fwd_impl`` (o, m, l), and
the gradients through ``FlashAttentionFn`` against ``jax.vjp`` of
``flash_attention_trainable``, 2e-4 in float32 (the reference's own
tolerance, ``tests/test_profiling_and_flash_bwd.py``) and 2e-2 in bfloat16;
the gradients also against ``jax.grad`` of ``attention_ref``.  The cases
are the reference's ``BWD_CASES``, a bfloat16 case and a T that is not a
multiple of the reference's tile (the port takes any T; the reference's
wrapper needs ``T % bq == 0``, so there the reference runs whole tiles).
``RMSNormFn``'s backward against ``jax.grad`` of ``layers.rmsnorm``.  A
forward-only kernel wrapper refuses a call that autograd would record.

The tensor-core backward's rounding (p and dS rounded to bf16 before the
products they feed, float32 sums) modelled in float32 PyTorch against the
reference VJP on the bf16 cases, and :func:`flash_bwd_route`.

On the card (``gpu``): each kernel against its plain version, the route of
every launch, bitwise batched == solo, strided inputs, and the training
shape.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    decode_attention_kernel,
    paged_decode_attention_kernel,
)
from repro_torch.kernels.flash_attention import ROUTES, flash_attention_kernel, flash_route
from repro_torch.kernels.flash_attention_bwd import (
    FlashAttentionFn,
    flash_attention_dkv_kernel,
    flash_attention_dkv_plain,
    flash_attention_dq_kernel,
    flash_attention_dq_plain,
    flash_attention_fwd_stats_kernel,
    flash_attention_fwd_stats_plain,
    flash_bwd_route,
)
from repro_torch.kernels.rmsnorm import RMSNormFn, rmsnorm_kernel
from repro_torch.kernels.ssm_scan import ssd_scan_kernel

# (B, Hq, Hkv, T, d, causal, bq, bk, dtype): the reference's BWD_CASES, then
# a bfloat16 case and a short last tile (T = 80 against the port's 64-row
# tiles; the reference runs it with bq = bk = 16, which divide 80)
CASES = [
    (1, 2, 2, 64, 16, True, 32, 32, "float32"),
    (2, 4, 2, 64, 32, True, 16, 32, "float32"),     # GQA grad reduction over head groups
    (1, 2, 1, 96, 16, False, 32, 32, "float32"),    # MQA, non-causal
    (2, 6, 2, 64, 32, True, 32, 32, "bfloat16"),
    (2, 3, 1, 80, 16, True, 16, 16, "float32"),
    (1, 4, 2, 48, 80, True, 16, 16, "bfloat16"),    # Zamba2's head dim (d % 64 != 0)
]
IDS = [f"B{c[0]}-H{c[1]}/{c[2]}-T{c[3]}-d{c[4]}-{'causal' if c[5] else 'full'}-{c[8]}"
       for c in CASES]


def _tol(dtype):
    return dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)


def _inputs(case, seed=0):
    """q, k, v and a random dO as numpy float32 (rounded to bf16 for a bf16
    case, so both packages see the same numbers)."""
    B, Hq, Hkv, T, d, *_, dtype = case
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Hq, T, d), (B, Hkv, T, d), (B, Hkv, T, d), (B, Hq, T, d))]
    if dtype == "bfloat16":
        arrays = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrays]
    return arrays


def _torch(a, dtype, grad=False):
    return torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(grad)


def _jax(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a, getattr(jnp, dtype))


def _np(x):
    return np.asarray(x.float().detach() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fwd_stats_matches_reference_kernel(case):
    from repro.kernels import flash_attention_bwd as ref

    B, Hq, Hkv, T, d, causal, bq, bk, dtype = case
    q, k, v, _ = _inputs(case)
    o, (m, l) = ref._fwd_impl(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                              causal=causal, bq=bq, bk=bk, interpret=True)
    to, tm, tl = flash_attention_fwd_stats_plain(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), causal=causal)
    assert to.dtype == getattr(torch, dtype) and tm.dtype == tl.dtype == torch.float32
    assert tuple(tm.shape) == tuple(tl.shape) == (B, Hq, T)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(to), _np(o), **tol)
    np.testing.assert_allclose(_np(tm), np.asarray(m).reshape(B, Hq, T), **tol)
    np.testing.assert_allclose(_np(tl), np.asarray(l).reshape(B, Hq, T), **tol)


def _port_grads(case, q, k, v, do):
    dtype = case[-1]
    tq, tk, tv = (_torch(a, dtype, grad=True) for a in (q, k, v))
    out = ops.flash_attention_trainable(tq, tk, tv, causal=case[5])
    out.backward(_torch(do, dtype))
    return out, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gradients_match_reference_vjp(case):
    import jax
    from repro.kernels.flash_attention_bwd import flash_attention_trainable as ref_fa

    B, Hq, Hkv, T, d, causal, bq, bk, dtype = case
    q, k, v, do = _inputs(case)
    want_o, vjp = jax.vjp(lambda q, k, v: ref_fa(q, k, v, causal, bq, bk, True),
                          _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    want = vjp(_jax(do, dtype))
    out, got = _port_grads(case, q, k, v, do)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(out), _np(want_o), **tol)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), err_msg=f"d{name}", **tol)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gradients_match_autodiff_of_attention_ref(case):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref

    causal, dtype = case[5], case[8]
    q, k, v, do = _inputs(case)
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))   # the oracle in float32
    want = jax.grad(lambda q, k, v: jnp.sum(ref.attention_ref(q, k, v, causal=causal) * do),
                    argnums=(0, 1, 2))(qj, kj, vj)
    _, got = _port_grads(case, q, k, v, do)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=f"d{name}", **_tol(dtype))


def _wgmma_bwd_model(q, k, v, do, m, l, delta, causal):
    """(dQ, dK, dV) as the tensor-core bodies round them: float32 p from the
    statistics and float32 dS = p * (dP - delta), each rounded to bf16 before
    the product it feeds (dV = P^T dO, dQ = dS K, dK = dS^T Q), float32
    sums, one rounding of each output."""
    f32 = torch.float32

    def bf(t):
        return t.to(torch.bfloat16).to(f32)

    B, Hq, T, d = q.shape
    Hkv, S = k.shape[1:3]
    g, scale = Hq // Hkv, 1.0 / np.sqrt(d)
    kf, vf = (t.to(f32).repeat_interleave(g, dim=1) for t in (k, v))
    qf, dof = q.to(f32), do.to(f32)
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - m[..., None]) / l[..., None]
    if causal:
        p = p.masked_fill(torch.arange(S)[None, :] > torch.arange(T)[:, None], 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    dq = bf(ds) @ kf * scale
    dk = (bf(ds).transpose(-1, -2) @ qf * scale).reshape(B, Hkv, g, S, d).sum(2)
    dv = (bf(p).transpose(-1, -2) @ dof).reshape(B, Hkv, g, S, d).sum(2)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


BF16_CASES = [c for c in CASES if c[8] == "bfloat16"]


@pytest.mark.parametrize("case", BF16_CASES, ids=[IDS[CASES.index(c)] for c in BF16_CASES])
def test_tensor_core_rounding_matches_reference_vjp(case):
    """The bf16 cases take the tensor-core backward; its rounding, modelled
    here, stays within the 2e-2 gate of the reference VJP (interpret
    mode), as the kernel must on the card."""
    import jax
    from repro.kernels.flash_attention_bwd import flash_attention_trainable as ref_fa

    B, Hq, Hkv, T, d, causal, bq, bk, dtype = case
    assert flash_bwd_route(torch.bfloat16, d) == "wgmma"
    q, k, v, do = _inputs(case)
    _, vjp = jax.vjp(lambda q, k, v: ref_fa(q, k, v, causal, bq, bk, True),
                     _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    want = vjp(_jax(do, dtype))
    tq, tk, tv, tdo = (_torch(a, dtype) for a in (q, k, v, do))
    o, m, l = flash_attention_fwd_stats_plain(tq, tk, tv, causal=causal)
    delta = (tdo.float() * o.float()).sum(-1)
    got = _wgmma_bwd_model(tq, tk, tv, tdo, m, l, delta, causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=f"d{name}", **_tol(dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [16, 64, 80, 128, 130, 960])
def test_flash_bwd_route_is_picked_by_dtype_and_head_dim(dtype, d):
    want = "wgmma" if dtype == "bfloat16" and d <= 128 and d % 16 == 0 else "simt"
    assert flash_bwd_route(getattr(torch, dtype), d) == want
    assert want in ROUTES


@pytest.mark.parametrize("d", [8, 12, 16, 32, 64, 80, 128, 256, 960])
def test_flash_bwd_route_keeps_float32_on_the_cuda_cores(d):
    """The float32 forward takes the 3xTF32 body at d % 8 == 0, but dQ and
    dK/dV have no such body: their float32 launches stay on the CUDA cores
    at every head dim, whatever ``flash_route`` gives the forward."""
    assert flash_bwd_route(torch.float32, d) == "simt"


def test_bwd_wrappers_count_launches_by_route():
    for fn in (flash_attention_dq_kernel, flash_attention_dkv_kernel):
        assert set(fn.launches_by_route) == set(ROUTES)
        assert all(isinstance(n, int) for n in fn.launches_by_route.values())
    q = torch.zeros(1, 2, 4, 16, dtype=torch.bfloat16)
    before = [dict(fn.launches_by_route) for fn in (flash_attention_dq_kernel,
                                                     flash_attention_dkv_kernel)]
    s = q[..., 0].float()
    for fn in (flash_attention_dq_kernel, flash_attention_dkv_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, s, s, s)     # a refused call counts nothing
    assert [flash_attention_dq_kernel.launches_by_route,
            flash_attention_dkv_kernel.launches_by_route] == before


def test_plain_backward_matches_its_own_autograd():
    """dq/dkv plain versions equal autograd through the plain forward, the
    statistics fed back as the kernels get them."""
    case = (2, 4, 2, 33, 8, True, 0, 0, "float32")
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=3))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, m, l = flash_attention_fwd_stats_plain(q, k, v)
    o.backward(do)
    with torch.no_grad():
        delta = (do * o).sum(-1)
        dq = flash_attention_dq_plain(q, k, v, do, m, l, delta)
        dk, dv = flash_attention_dkv_plain(q, k, v, do, m, l, delta)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_matches_reference(dtype):
    import jax
    import jax.numpy as jnp
    from repro.models import layers as jlayers

    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    g = rng.standard_normal((3, 5, 48)).astype(np.float32)
    if dtype == "bfloat16":
        x, g = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, g))
    jdt = getattr(jnp, dtype)
    y, vjp = jax.vjp(lambda x, w: jlayers.rmsnorm(x, w), jnp.asarray(x, jdt), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g, jdt))
    tx = _torch(x, dtype, grad=True)
    tw = torch.from_numpy(w).requires_grad_()
    out = RMSNormFn.apply(tx, tw, 1e-6)
    out.backward(_torch(g, dtype))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(out), _np(y), **tol)
    assert tx.grad.dtype == getattr(torch, dtype) and tw.grad.dtype == torch.float32
    np.testing.assert_allclose(_np(tx.grad), _np(want_dx), **tol)
    np.testing.assert_allclose(_np(tw.grad), _np(want_dw), **tol)


def test_layers_take_the_trainable_routes_under_grad():
    """``rmsnorm`` and ``attention_full`` carry gradients to every input and
    parameter; under ``no_grad`` they take the forward-only routes."""
    from repro_torch.models import layers as L

    torch.manual_seed(0)
    dims = L.AttnDims.make(32, 4, 2, 8, tp=1)
    p = L.init_attention(torch.Generator().manual_seed(0), dims, device=torch.device("cpu"))
    p = {k: t.requires_grad_() for k, t in p.items()}
    scale = torch.ones(32, requires_grad=True)
    x = torch.randn(2, 9, 32, requires_grad=True)
    out, _ = L.attention_full(p, dims, L.rmsnorm(x, scale))
    out.square().sum().backward()
    for t in (x, scale, *p.values()):
        assert t.grad is not None and torch.count_nonzero(t.grad) > 0
    with torch.no_grad():
        again, _ = L.attention_full(p, dims, L.rmsnorm(x, scale))
    torch.testing.assert_close(again, out.detach(), rtol=0, atol=0)


def _forward_only_calls():
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    k = torch.randn(1, 2, 4, 8)
    x = torch.randn(3, 8, requires_grad=True)
    pool = torch.zeros(2, 4, 8)
    tables = torch.zeros(1, 1, dtype=torch.int32)
    ssd = (torch.randn(1, 8, 2, 4, requires_grad=True), torch.rand(1, 8, 2),
           -torch.rand(2), torch.randn(1, 8, 4), torch.randn(1, 8, 4))
    return {
        "flash_attention": (lambda: flash_attention_kernel(q, k, k), "flash_attention_trainable"),
        "rmsnorm": (lambda: rmsnorm_kernel(x, torch.ones(8)), "rmsnorm_trainable"),
        "decode_attention": (lambda: decode_attention_kernel(
            q[:, :, :1], k, k, torch.zeros(1, dtype=torch.int32)), "no_grad"),
        "paged_decode_attention": (lambda: paged_decode_attention_kernel(
            x[:1], pool, pool, tables, torch.ones(1, dtype=torch.int32)), "no_grad"),
        "ssd_scan": (lambda: ssd_scan_kernel(*ssd), "ssd_scan_trainable"),
        "fwd_stats": (lambda: flash_attention_fwd_stats_kernel(q, k, k),
                      "flash_attention_trainable"),
    }


@pytest.mark.parametrize("name", sorted(_forward_only_calls()))
def test_forward_only_kernels_refuse_grad(name):
    """A forward-only kernel's output has no ``grad_fn``: called where
    autograd would record it, the wrapper raises (before it looks for a
    card), naming the differentiable route.  Under ``no_grad`` the same call
    gets past the check, to the CUDA requirement."""
    call, route = _forward_only_calls()[name]
    with pytest.raises(RuntimeError, match=f"forward-only.*{route}"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call()


def test_trainable_ops_dispatch_by_device():
    q = torch.randn(1, 2, 5, 8, requires_grad=True)
    out = ops.flash_attention_trainable(q, q.detach(), q.detach())
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    y = ops.rmsnorm_trainable(q, torch.ones(8))
    assert type(y.grad_fn).__name__ == "RMSNormFnBackward"


def test_kernels_refuse_what_they_do_not_take():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_dq_kernel(q, q, q, q, q[..., 0], q[..., 0], q[..., 0])
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_dkv_kernel(q, q, q, q, q[..., 0], q[..., 0], q[..., 0])


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

CARD_CASES = [c[:6] + (c[8],) for c in CASES] + [
    (2, 6, 2, 100, 128, True, "float32"),       # Qwen2's head dim, a short last tile
    (2, 6, 2, 100, 128, True, "bfloat16"),
    (1, 4, 4, 37, 64, False, "float32"),
    (8, 15, 5, 1024, 64, True, "bfloat16"),     # the SmolLM-360M train step
    (1, 2, 1, 50, 256, True, "float32"),        # the largest head dim the kernels take
    # the tensor-core forward: T off its 128-row tiles, GQA 3:1 and 1:1
    (2, 6, 2, 300, 80, True, "bfloat16"), (1, 3, 3, 513, 16, True, "bfloat16"),
    (2, 4, 4, 100, 128, False, "bfloat16"), (1, 2, 1, 50, 256, True, "bfloat16"),
    # the tensor-core backward: d = 80, 96, 128 (one warpgroup for dK/dV), T
    # off its 64- and 128-row tiles, non-causal, GQA 1:1, 3:1 and 6:1
    (1, 6, 1, 513, 96, True, "bfloat16"), (2, 3, 1, 300, 128, False, "bfloat16"),
    (1, 4, 4, 513, 80, False, "bfloat16"), (2, 6, 1, 300, 64, True, "bfloat16"),
    (1, 2, 2, 300, 128, True, "bfloat16"), (2, 6, 2, 513, 96, False, "bfloat16"),
]


def _card_inputs(case, seed=0):
    B, Hq, Hkv, T, d, causal, dtype = case
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dt)
            for s in ((B, Hq, T, d), (B, Hkv, T, d), (B, Hkv, T, d), (B, Hq, T, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_kernels_match_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    causal, dtype = case[5], case[6]
    q, k, v, do = _card_inputs(case)
    route = flash_route(q.dtype, q.shape[-1])
    before = dict(flash_attention_fwd_stats_kernel.launches_by_route)
    o, m, l = flash_attention_fwd_stats_kernel(q, k, v, causal=causal)
    after = flash_attention_fwd_stats_kernel.launches_by_route
    assert after == {**before, route: before[route] + 1}
    po, pm, pl = flash_attention_fwd_stats_plain(q, k, v, causal=causal)
    delta = (do.float() * po.float()).sum(-1)
    bwd_route = flash_bwd_route(q.dtype, q.shape[-1])
    bwd = (flash_attention_dq_kernel, flash_attention_dkv_kernel)
    before = [dict(fn.launches_by_route) for fn in bwd]
    dq = flash_attention_dq_kernel(q, k, v, do, pm, pl, delta, causal=causal)
    dk, dv = flash_attention_dkv_kernel(q, k, v, do, pm, pl, delta, causal=causal)
    for fn, b in zip(bwd, before):
        assert fn.launches_by_route == {**b, bwd_route: b[bwd_route] + 1}
    pdq = flash_attention_dq_plain(q, k, v, do, pm, pl, delta, causal=causal)
    pdk, pdv = flash_attention_dkv_plain(q, k, v, do, pm, pl, delta, causal=causal)
    torch.cuda.synchronize()
    tol = _tol(dtype)
    for got, want in ((o, po), (m, pm), (l, pl), (dq, pdq), (dk, pdk), (dv, pdv)):
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), **tol)
    # row 0 of the batched launches equals a solo launch of row 0, bitwise
    one = [t[:1] for t in (q, k, v, do, pm, pl, delta)]
    assert torch.equal(flash_attention_fwd_stats_kernel(*one[:3], causal=causal)[0][0], o[0])
    assert torch.equal(flash_attention_dq_kernel(*one, causal=causal)[0], dq[0])
    assert torch.equal(flash_attention_dkv_kernel(*one, causal=causal)[0][0], dk[0])
    # the model's (B, T, H, d) projections passed as transposed views
    tv = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v, do)]
    for g, w in zip(flash_attention_fwd_stats_kernel(*tv[:3], causal=causal), (o, m, l)):
        assert torch.equal(g, w)
    assert torch.equal(flash_attention_dq_kernel(*tv, pm, pl, delta, causal=causal), dq)
    assert torch.equal(flash_attention_dkv_kernel(*tv, pm, pl, delta, causal=causal)[1], dv)


@pytest.mark.gpu
@pytest.mark.parametrize("T,S", [(300, 513), (513, 300)])
def test_bwd_kernels_take_any_t_and_s_on_card(T, S):
    """Causal with T != S (top-left aligned) on the tensor-core backward, at
    the train step's head dim and GQA 3:1: keys past every query get zero
    gradients, queries past S see all keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(7)
    q, do = (torch.from_numpy(rng.standard_normal((2, 6, T, 64)).astype(np.float32))
             .to("cuda", torch.bfloat16) for _ in "qd")
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, S, 64)).astype(np.float32))
            .to("cuda", torch.bfloat16) for _ in "kv")
    o, m, l = flash_attention_fwd_stats_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, m, l, delta)
    got = (flash_attention_dq_kernel(*args), *flash_attention_dkv_kernel(*args))
    want = (flash_attention_dq_plain(*args), *flash_attention_dkv_plain(*args))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **_tol("bfloat16"))


@pytest.mark.gpu
def test_flash_attention_fn_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = (2, 4, 2, 70, 32, True, 0, 0, "float32")
    q, k, v, do = _inputs(case, seed=5)
    _, cpu = _port_grads(case, q, k, v, do)
    counts = [f.launches for f in (flash_attention_fwd_stats_kernel,
                                   flash_attention_dq_kernel, flash_attention_dkv_kernel)]
    tq, tk, tv = (torch.from_numpy(a).cuda().requires_grad_() for a in (q, k, v))
    FlashAttentionFn.apply(tq, tk, tv, True).backward(torch.from_numpy(do).cuda())
    after = [f.launches for f in (flash_attention_fwd_stats_kernel,
                                  flash_attention_dq_kernel, flash_attention_dkv_kernel)]
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1]
    for got, want in zip((tq.grad, tk.grad, tv.grad), cpu):
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
