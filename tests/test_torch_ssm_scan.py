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

The CUDA kernel itself is compared with its plain version on the card
(marked ``gpu``, skipped without CUDA): y and the final state, float32 and
bfloat16, an unpadded short last chunk, the model's strided (B,T,H,P) view,
and row b of a batched launch bitwise equal to a solo launch.  The
reference package is imported inside the tests that use it, so those also
run without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssm_scan import ssd_scan_kernel, ssd_scan_plain

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


def _inputs(case, seed, dtype="float32"):
    """numpy inputs as in tests/test_kernels.py, and as torch tensors."""
    B, T, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, T, H, P)).astype(np.float32),
              (rng.random((B, T, H)) * 0.5 + 0.1).astype(np.float32),
              (-rng.random(H) - 0.2).astype(np.float32),
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


def test_kernel_refuses_cpu_tensors():
    _, args = _inputs(SSD_CASES[0], 13)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_kernel(*args, chunk=16)


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES + TAIL_CASES)
def test_kernel_matches_plain_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, args = _inputs(case, 14, dtype)
    x, dt, A, Bm, Cm = (t.cuda() for t in args)
    before = ssd_scan_kernel.launches
    y, S = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=case[5], return_state=True)
    assert ssd_scan_kernel.launches == before + 1
    wy, wS = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=case[5], return_state=True)
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(S, wS, rtol=tol, atol=tol)
    # the model's layout: x a (B,T,H,P) view of wider rows
    B, T, H, P, N, chunk = case
    wide = torch.zeros((B, T, H * P + 8), dtype=x.dtype, device=x.device)
    wide[..., :H * P] = x.reshape(B, T, H * P)
    view = wide[..., :H * P].unflatten(-1, (H, P))
    assert torch.equal(ops.ssd_scan(view, dt, A, Bm, Cm, chunk=chunk), y)
    for b in range(B):
        solo, S_solo = ops.ssd_scan(x[b:b + 1], dt[b:b + 1], A, Bm[b:b + 1], Cm[b:b + 1],
                                    chunk=chunk, return_state=True)
        assert torch.equal(solo[0], y[b]) and torch.equal(S_solo[0], S[b])
