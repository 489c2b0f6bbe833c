"""The port's SSD (Mamba2) chunked scan against the reference.

On CPU tensors ``repro_torch.kernels.ops.ssd_scan`` runs the kernel's plain
version (the chunked form).  It is held against the reference's Pallas
kernel (interpret mode, as ``tests/test_kernels.py`` runs it), the
reference's sequential oracle ``ssd_scan_ref`` and its model's
``ssd_chunked`` (which also gives the final state) on the reference's
``SSD_CASES``, at the reference's tolerance: 2e-4 in float32, 2e-2 in
bfloat16.  A T that is not a multiple of the chunk, which the TPU kernel
refuses, is held against ``ssd_chunked``'s dt = 0 padding, final state
included.

The kernel has two bodies, picked by ``ssd_route`` from (dtype, N, P,
chunk): every shape of the reference's cases and of the Zamba2 path goes
to the tensor-core body ("mma"), odd N or P to the CUDA-core one ("simt").
Where no card is present, a torch model of the tensor-core body's
numerics (TF32 products with each float32 operand split into hi + lo,
bfloat16 operands exact) is held against the plain version at Zamba2's
widths.

The CUDA kernel itself is compared with its plain version on the card
(marked ``gpu``, skipped without CUDA): y and the final state, float32 and
bfloat16 (the state, float32 in both, at the float32 gate on the
tensor-core route), on both routes, an unpadded short last chunk, the
model's strided (B,T,H,P) view, row b of a batched launch bitwise equal to
a solo launch, pairs above the diagonal whose decay overflows, a
misaligned base that the tensor-core route refuses, and the route's chunk
table against the built body's.  The reference package is imported inside
the tests that use it, so those also run without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssm_scan import (
    MMA_MAX_CHUNK,
    mma_max_chunk,
    ssd_route,
    ssd_scan_kernel,
    ssd_scan_plain,
)

SSD_CASES = [
    # (B, T, H, P, N, chunk) -- tests/test_kernels.py
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 96, 1, 64, 64, 32),
]
TAIL_CASES = [
    # T not a multiple of the chunk; T below one chunk
    (2, 100, 3, 16, 8, 32),
    (1, 300, 2, 64, 16, 256),
    (2, 11, 2, 16, 8, 16),
]
ZAMBA2 = (8, 1024, 80, 64, 64, 256)     # the hybrid path's prefill scan
GATE = [(2, 300, 80, 64, 64, 256), (2, 304, 80, 64, 64, 256)]   # its float32 gate
SIMT_CASES = [
    # N or P not a multiple of 8: the CUDA-core body
    (2, 64, 2, 12, 8, 16),
    (1, 100, 3, 16, 12, 32),
]


def _inputs(case, seed, dtype="float32", a_scale=1.0):
    """numpy inputs as in tests/test_kernels.py, and as torch tensors;
    ``a_scale`` scales A (300: steps of dt*A from -6 to -216, so
    exp(cs_i - cs_j) overflows float32 within 15 rows above the diagonal)."""
    B, T, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, T, H, P)).astype(np.float32),
              (rng.random((B, T, H)) * 0.5 + 0.1).astype(np.float32),
              ((-rng.random(H) - 0.2) * a_scale).astype(np.float32),
              (rng.standard_normal((B, T, N)) * 0.3).astype(np.float32),
              (rng.standard_normal((B, T, N)) * 0.3).astype(np.float32))
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    low = getattr(torch, dtype)
    return arrays, (x.to(low), dt, A, Bm.to(low), Cm.to(low))


def _jax(arrays, dtype="float32"):
    import jax.numpy as jnp

    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in arrays)
    low = getattr(jnp, dtype)
    return x.astype(low), dt, A, Bm.astype(low), Cm.astype(low)


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_matches_reference_kernel_and_oracle(case):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    arrays, args = _inputs(case, 8)
    got = ops.ssd_scan(*args, chunk=case[5])
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    jargs = _jax(arrays)
    _close(got, jops.ssd_scan(*jargs, chunk=case[5]), 2e-4)
    _close(got, jref.ssd_scan_ref(*jargs), 2e-4)


@pytest.mark.parametrize("case", SSD_CASES + TAIL_CASES)
def test_y_and_final_state_match_ssd_chunked(case):
    from repro.models.mamba2 import ssd_chunked

    arrays, args = _inputs(case, 9)
    y, S = ops.ssd_scan(*args, chunk=case[5], return_state=True)
    wy, wS = ssd_chunked(*_jax(arrays), chunk=case[5])
    B, T, H, P, N, _ = case
    assert S.shape == (B, H, N, P) and S.dtype == torch.float32
    _close(y, wy, 2e-4)
    _close(S, wS, 2e-4)


@pytest.mark.parametrize("case", SSD_CASES + TAIL_CASES)
def test_torch_sequential_oracle_matches_reference_oracle(case):
    from repro.kernels import ref as jref

    arrays, args = _inputs(case, 10)
    _close(tref.ssd_scan_ref(*args), jref.ssd_scan_ref(*_jax(arrays)), 2e-4)
    # the chunked form equals the recurrence, a short last chunk included
    _close(ssd_scan_plain(*args, chunk=case[5]), tref.ssd_scan_ref(*args), 2e-4)


@pytest.mark.parametrize("case", SSD_CASES + TAIL_CASES[:1])
def test_bfloat16_matches_reference(case):
    from repro.models.mamba2 import ssd_chunked

    arrays, args = _inputs(case, 11, "bfloat16")
    y, S = ops.ssd_scan(*args, chunk=case[5], return_state=True)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    wy, wS = ssd_chunked(*_jax(arrays, "bfloat16"), chunk=case[5])
    _close(y, wy, 2e-2)
    _close(S, wS, 2e-2)


def test_state_continues_the_scan():
    """The final state of the first half is the state the second half
    starts from: the scan of the whole equals the recurrence carried on."""
    case = (2, 64, 2, 16, 8, 16)
    _, (x, dt, A, Bm, Cm) = _inputs(case, 12)
    _, S = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=16, return_state=True)
    _, S_half = ssd_scan_plain(x[:, :40], dt[:, :40], A, Bm[:, :40], Cm[:, :40],
                               chunk=16, return_state=True)
    for t in range(40, 64):
        S_half = (S_half * torch.exp(dt[:, t] * A)[..., None, None]
                  + torch.einsum("bn,bh,bhp->bhnp", Bm[:, t], dt[:, t], x[:, t]))
    _close(S, S_half.numpy(), 2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES + TAIL_CASES + [ZAMBA2] + GATE)
def test_route_takes_every_path_shape_to_the_tensor_cores(case, dtype):
    _, _, _, P, N, chunk = case
    assert ssd_route(dtype, N, P, chunk) == "mma"


@pytest.mark.parametrize("dtype,N,P,Q", [
    (torch.float32, 12, 16, 32), (torch.bfloat16, 8, 12, 16),   # N or P off 8
    (torch.float32, 64, 128, 256),                              # P past 64
    (torch.bfloat16, 72, 64, 256),                              # N past 64
    (torch.float32, 64, 64, 512),                               # chunk past shared memory
    (torch.bfloat16, 64, 64, 1024),
    (torch.float16, 64, 64, 256),                               # no such body
])
def test_route_sends_other_shapes_to_the_cuda_cores(dtype, N, P, Q):
    assert ssd_route(dtype, N, P, Q) == "simt"


@pytest.mark.parametrize("dtype,N,longest", [
    (torch.float32, 64, 256), (torch.float32, 48, 256), (torch.float32, 32, 384),
    (torch.float32, 8, 512),
    (torch.bfloat16, 64, 640), (torch.bfloat16, 40, 768), (torch.bfloat16, 32, 896),
    (torch.bfloat16, 16, 1088),
])
def test_route_limit_follows_shared_memory(dtype, N, longest):
    """The longest chunk a block's shared memory holds (``ssd_mma::layout``,
    whose compile-time check keeps ``MMA_MAX_CHUNK`` the most whole score
    tiles that fit 227 KB): at N = P = 64 a float32 block holds 256 rows, a
    bfloat16 block (x and B as loaded, C in registers) 640; a smaller N
    leaves room for more.  One row more goes to the CUDA-core body."""
    assert mma_max_chunk(dtype, N) == longest
    assert ssd_route(dtype, N, 64, longest) == "mma"
    assert ssd_route(dtype, N, 64, longest + 1) == "simt"
    assert ssd_route(dtype, N, 8, 1) == "mma"


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the kernel's split rounds hi."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, a_exact: bool, b_exact: bool, one_pass: bool = False):
    """a @ b on the modelled tensor cores: each operand split into hi =
    tf32(x) and lo = x - hi (read truncated), lo.hi + hi.lo + hi.hi with the
    terms of an exact (bfloat16) operand's lo left out, float32 sums;
    ``one_pass``: hi.hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if one_pass:
        return out
    terms = []
    if not a_exact:
        terms.append(_tf32_truncated(a - ah) @ bh)
    if not b_exact:
        terms.append(ah @ _tf32_truncated(b - bh))
    return sum(terms[1:], terms[0]) + out if terms else out


def _mma_model(x, dt, A, Bm, Cm, chunk, *, exact: bool, one_pass: bool = False):
    """The tensor-core body's arithmetic in torch, chunk by chunk with the
    short last chunk as it is.  ``exact`` (bfloat16 inputs): C.B^T exact,
    dt carried by p and by the end-of-chunk weight w so that x stays exact,
    p.x, C.S_prev and (B w dt)^T.x in two terms; otherwise every product in
    three, on dt*x.  (y, S) in float32."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    xh = x.permute(0, 2, 1, 3)                      # (B,H,T,P)
    dth = dt.permute(0, 2, 1)                       # (B,H,T)
    S = torch.zeros((Bsz, H, N, P))
    ys = []
    for t0 in range(0, T, chunk):
        sl = slice(t0, min(T, t0 + chunk))
        L = sl.stop - t0
        cs = torch.cumsum(dth[..., sl] * A[None, :, None], dim=-1)       # (B,H,L)
        d = dth[..., sl]
        C, B = Cm[:, None, sl], Bm[:, None, sl]                         # (B,1,L,N)
        G = _mm(C, B.transpose(-1, -2), exact, exact, one_pass)
        keep = torch.ones((L, L), dtype=torch.bool).tril()
        p = torch.where(keep, G * torch.exp(cs[..., :, None] - cs[..., None, :]),
                        torch.zeros(()))
        w = torch.exp(cs[..., -1:] - cs)
        y = _mm(C, S, exact, False, one_pass) * torch.exp(cs)[..., None]
        decay = torch.exp(cs[..., -1])[..., None, None]
        if exact:
            y = y + _mm(p * d[..., None, :], xh[:, :, sl], False, True, one_pass)
            S = S * decay + _mm((B * (w * d)[..., None]).transpose(-1, -2), xh[:, :, sl],
                                False, True, one_pass)
        else:
            xdt = xh[:, :, sl] * d[..., None]
            y = y + _mm(p, xdt, False, False, one_pass)
            S = S * decay + _mm(B.transpose(-1, -2), w[..., None] * xdt, False, False,
                                one_pass)
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), S


@pytest.mark.parametrize("T", [512, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_numerics_keep_the_float32_gate(dtype, T):
    """The design's numerics where no card is present, at Zamba2's widths
    (N = P = 64, chunk 256; two heads): with the split the body uses, y
    and S stay within 2e-4 of the plain version in float32; in one-pass
    TF32 they do not.  bfloat16 inputs are carried in float32, so the
    plain version's y is compared before its rounding to bfloat16."""
    case = (2, T, 2, 64, 64, 256)
    _, args = _inputs(case, 15, dtype)
    x, dt, A, Bm, Cm = (t.float() for t in args)
    if dtype == "bfloat16":
        for t in (x, Bm, Cm):       # bf16 values are exact in TF32: lo is 0
            assert torch.equal(_tf32(t), t)
    want_y, want_S = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=256, return_state=True)
    y, S = _mma_model(x, dt, A, Bm, Cm, 256, exact=dtype == "bfloat16")
    torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(S, want_S, rtol=2e-4, atol=2e-4)
    one, _ = _mma_model(x, dt, A, Bm, Cm, 256, exact=dtype == "bfloat16", one_pass=True)
    assert (one - want_y).abs().max().item() > 2e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_is_finite_where_the_decay_overflows(dtype):
    """Large dt*|A|: exp(cs_i - cs_j) above the diagonal is inf in float32,
    and the plain version (pairs selected, never multiplied by a mask)
    stays finite and equal to the sequential recurrence."""
    case = (1, 300, 2, 64, 64, 256)
    _, args = _inputs(case, 16, dtype, a_scale=300.0)
    x, dt, A, Bm, Cm = args
    cs = torch.cumsum(dt[0, :256, 0] * A[0], 0)
    assert torch.isinf(torch.exp(cs[:, None] - cs[None, :])).any()
    y, S = ssd_scan_plain(*args, chunk=256, return_state=True)
    assert torch.isfinite(y.float()).all() and torch.isfinite(S).all()
    want = tref.ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float())
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)
    y32, _ = _mma_model(*(t.float() for t in args), 256, exact=dtype == "bfloat16")
    assert torch.isfinite(y32).all()


def test_kernel_refuses_cpu_tensors():
    _, args = _inputs(SSD_CASES[0], 13)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_kernel(*args, chunk=16)


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------

def _on_card(case, seed, dtype, **kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, args = _inputs(case, seed, dtype, **kw)
    return tuple(t.cuda() for t in args)


def _state_tol(dtype, route):
    """The final state is float32 in both dtypes.  The tensor-core body
    computes it from bfloat16 inputs, which are exact in TF32, with float32
    accuracy, so it is held to the float32 gate; the CUDA-core body keeps
    the reference's bfloat16 tolerance."""
    return 2e-4 if dtype == "float32" or route == "mma" else 2e-2


def _launch_counted(args, chunk, route):
    """ops.ssd_scan on the card, checking that it launched once on ``route``."""
    before = ssd_scan_kernel.launches
    by_route = dict(ssd_scan_kernel.launches_by_route)
    out = ops.ssd_scan(*args, chunk=chunk, return_state=True)
    assert ssd_scan_kernel.launches == before + 1
    by_route[route] += 1
    assert ssd_scan_kernel.launches_by_route == by_route
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES + TAIL_CASES + SIMT_CASES)
def test_kernel_matches_plain_on_card(case, dtype):
    x, dt, A, Bm, Cm = _on_card(case, 14, dtype)
    B, T, H, P, N, chunk = case
    route = ssd_route(x.dtype, N, P, chunk)
    assert route == ("simt" if case in SIMT_CASES else "mma")
    y, S = _launch_counted((x, dt, A, Bm, Cm), chunk, route)
    wy, wS = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, return_state=True)
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)
    tol_S = _state_tol(dtype, route)
    torch.testing.assert_close(S, wS, rtol=tol_S, atol=tol_S)
    # the model's layout: x a (B,T,H,P) view of wider rows
    wide = torch.zeros((B, T, H * P + 8), dtype=x.dtype, device=x.device)
    wide[..., :H * P] = x.reshape(B, T, H * P)
    view = wide[..., :H * P].unflatten(-1, (H, P))
    assert torch.equal(ops.ssd_scan(view, dt, A, Bm, Cm, chunk=chunk), y)
    for b in range(B):
        solo, S_solo = ops.ssd_scan(x[b:b + 1], dt[b:b + 1], A, Bm[b:b + 1], Cm[b:b + 1],
                                    chunk=chunk, return_state=True)
        assert torch.equal(solo[0], y[b]) and torch.equal(S_solo[0], S[b])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_core_body_at_full_width_on_card(dtype):
    """Zamba2's widths (H 4 of its 80 heads, P 64, N 64, chunk 256) over
    four chunks."""
    case = (1, 1024, 4, 64, 64, 256)
    args = _on_card(case, 17, dtype)
    y, S = _launch_counted(args, 256, "mma")
    wy, wS = ssd_scan_plain(*args, chunk=256, return_state=True)
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(S, wS, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(1, 300, 2, 64, 64, 256), SIMT_CASES[0]],
                         ids=["mma", "simt"])
def test_kernel_is_finite_where_the_decay_overflows_on_card(case, dtype):
    """exp(cs_i - cs_j) above the diagonal is inf: y stays finite and equal
    to the plain version on both bodies."""
    args = _on_card(case, 18, dtype, a_scale=300.0)
    route = ssd_route(args[0].dtype, case[4], case[3], case[5])
    y, S = _launch_counted(args, case[5], route)
    wy, wS = ssd_scan_plain(*args, chunk=case[5], return_state=True)
    assert torch.isfinite(y.float()).all() and torch.isfinite(S).all()
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)
    tol_S = _state_tol(dtype, route)
    torch.testing.assert_close(S, wS, rtol=tol_S, atol=tol_S)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["x", "B", "C"])
def test_tensor_core_route_refuses_a_misaligned_base_on_card(name):
    """16-byte copies cannot address a base one element past a boundary:
    the wrapper raises, it never runs the CUDA-core body instead."""
    args = list(_on_card(SSD_CASES[1], 19, "bfloat16"))
    i = {"x": 0, "B": 3, "C": 4}[name]
    t = args[i]
    shifted = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    shifted.copy_(t)
    args[i] = shifted
    before = dict(ssd_scan_kernel.launches_by_route)
    with pytest.raises(ValueError, match="16-byte"):
        ssd_scan_kernel(*args, chunk=SSD_CASES[1][5])
    assert ssd_scan_kernel.launches_by_route == before


@pytest.mark.gpu
def test_route_table_matches_the_body_on_card():
    """``ssd_route`` routes by :data:`MMA_MAX_CHUNK`; the built library's
    ``ssd_scan_mma_max_chunk`` gives the table the tensor-core body takes,
    which its compile-time check holds to its shared-memory layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.common import DTYPE_CODES

    lib = ssm_scan._library()
    for dtype in (*MMA_MAX_CHUNK, torch.float16):
        for N in range(0, 80):
            want = mma_max_chunk(dtype, N)
            code = DTYPE_CODES.get(dtype, -1)
            assert lib.ssd_scan_mma_max_chunk(code, N) == want, (dtype, N)
