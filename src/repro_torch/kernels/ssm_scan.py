"""SSD (Mamba2) chunked scan: the CUDA kernel and its plain version.

``ssd_scan_kernel`` launches ``csrc/ssm_scan.cu`` (hand-written for Hopper,
``sm_90a``), which replaces the TPU kernel
``repro.kernels.ssm_scan.ssd_scan_kernel``:

    S_t = exp(dt_t * A) S_{t-1} + dt_t B_t (x) x_t,    y_t = C_t . S_t

for x ``(B,T,H,P)``, dt ``(B,T,H)`` float32, A ``(H,)`` float32, B and C
``(B,T,N)`` shared across heads, in the chunked form (chunks of ``chunk``
rows), all math in float32, y in x's dtype.  Unlike the TPU kernel it also
returns the final state ``(B,H,N,P)`` float32 (``return_state=True``), which
the model's prefill stores for decode, and takes a T that is not a multiple
of the chunk without padded copies.  One block per (b, h) with sums in a
fixed order, so row b of a batched launch is bitwise equal to a solo launch
of row b.  CUDA C++ rather than Triton: the work is three matmul-shaped
products with an (N,P) state carried across chunks, not an elementwise pass,
and it keeps the port's single ``nvcc`` build path.

:func:`ssd_route` picks the body from (dtype, N, P, chunk) alone:
``"mma"``, the tensor-core body (``csrc/ssd_mma.cuh``: mma.sync with
float32 accuracy, each float32 operand split into TF32 hi + lo, bfloat16
operands exact and C.B^T on bfloat16 tiles), for float32 and bfloat16 at
N and P multiples of 8 up to 64 and a chunk up to :func:`mma_max_chunk`
(the most rows that fit one block's shared memory); ``"simt"``, the
CUDA-core body, otherwise.  There is no fallback from one to the other:
an ``"mma"`` call whose x, B or C its 16-byte copies cannot address
raises.

``ssd_scan_plain`` is the same function in plain PyTorch, the chunked form
of the reference's ``models/mamba2.py:ssd_chunked``: it serves CPU tensors
(the tests) and is the yardstick the kernel is checked against on the card.
:func:`repro_torch.kernels.ops.ssd_scan` picks by device.

Training differentiates the scan through :class:`SSDScanFn`: the kernel
forward on the card (its plain version on the CPU), and :func:`ssd_scan_vjp`
backward, the gradient XLA derives for the reference's ``ssd_chunked``
written by hand in chunked torch ops (the reference has no SSD backward
kernel), the same code on both devices.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build, fake
from .common import (
    DTYPE_CODES,
    check_strided,
    check_tensor,
    check_tma,
    ptr,
    raise_on_error,
    refuse_grad,
    require_cuda,
    stream,
)
from .fake import shape_only

_SOURCE = "ssm_scan"

ROUTES = ("mma", "simt")
MMA_MAX_P = 64                 # the tensor-core body holds 64 columns of x, y and S
MMA_MAX_N = 64                 # ... and 64 rows of S (the C fragments of a strip)
# The longest chunk the tensor-core body takes, by dtype and N rounded up to
# 16 (16, 32, 48, 64): ``ssd_mma::kMaxChunk``, the most rows whose tiles fit
# one block's shared memory, which ``csrc/ssd_mma.cuh`` holds to its layout
# at compile time; ``ssd_scan_mma_max_chunk`` returns it from the library.
MMA_MAX_CHUNK = {torch.bfloat16: (1088, 896, 768, 640),
                 torch.float32: (512, 384, 256, 256)}


def mma_max_chunk(dtype, N: int) -> int:
    """The longest chunk the tensor-core body takes at (dtype, N), 0 where
    it takes none (N not a multiple of 8 up to :data:`MMA_MAX_N`, or
    another dtype)."""
    if dtype not in MMA_MAX_CHUNK or not (8 <= N <= MMA_MAX_N and N % 8 == 0):
        return 0
    return MMA_MAX_CHUNK[dtype][(N + 15) // 16 - 1]


def ssd_route(dtype, N: int, P: int, Q: int) -> str:
    """The body an SSD launch with state dim N, head dim P and chunk Q runs
    on: ``"mma"`` (the tensor-core body) for float32 and bfloat16 at N and
    P multiples of 8 up to :data:`MMA_MAX_N` and :data:`MMA_MAX_P` and Q up
    to :func:`mma_max_chunk` (at N = 64: 256 in float32, 640 in bfloat16),
    ``"simt"`` (the CUDA-core body) otherwise."""
    if 8 <= P <= MMA_MAX_P and P % 8 == 0 and 1 <= Q <= mma_max_chunk(dtype, N):
        return "mma"
    return "simt"


def _wide(*ts) -> torch.dtype:
    """The math's dtype: float32, or float64 where an input is float64."""
    out = torch.float32
    for t in ts:
        out = torch.promote_types(out, t.dtype)
    return out


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 256, return_state: bool = False):
    """Plain PyTorch chunked SSD (any device, float32 math, float64 for
    float64 inputs): y (B,T,H,P) in x's dtype, and the final state (B,H,N,P)
    float32 if ``return_state``.

    A T that is not a multiple of the chunk is padded with dt = 0, which is
    inert (decay 1, update 0), as the reference's ``ssd_chunked`` does."""
    f32 = _wide(x, dt, A, B, C)
    Bsz, T, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        def z(a):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        x, dt, B, C = z(x), z(dt), z(B), z(C)
    nc = x.shape[1] // Q

    dA = dt * A                                          # (B,T,H)
    xdt = x * dt[..., None]                              # float32

    def r(a):
        return a.reshape(Bsz, nc, Q, *a.shape[2:])
    dA_c, xdt_c, B_c, C_c = r(dA), r(xdt).to(f32), r(B).to(f32), r(C).to(f32)

    cs = torch.cumsum(dA_c, dim=2)                       # (B,nc,Q,H)
    # intra-chunk: L_ij = exp(cs_i - cs_j) for i >= j, selected (never a
    # multiplied mask: exp above the diagonal can overflow)
    li = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (B,nc,Q,Q,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Lm = torch.where(mask[None, None, :, :, None], torch.exp(li),
                     torch.zeros((), dtype=f32, device=x.device))
    scores = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)
    y = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", scores, Lm, xdt_c)

    # chunk-final local states, then the inter-chunk scan
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)      # (B,nc,Q,H)
    S_local = torch.einsum("bckn,bckh,bckhp->bchnp", B_c, decay_to_end, xdt_c)
    chunk_decay = torch.exp(cs[:, :, -1, :])             # (B,nc,H)
    S = torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_local[:, c]
    S_prevs = torch.stack(prevs, dim=1)                  # (B,nc,H,N,P)

    # inter-chunk contribution: y_i += (C_i . S_prev) exp(cs_i)
    y = y + torch.einsum("bcqn,bchnp->bcqhp", C_c, S_prevs) * torch.exp(cs)[..., None]
    y = y.reshape(Bsz, nc * Q, H, P)[:, :T].to(x.dtype)
    return (y, S) if return_state else y


def _library() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, ll, p, ll, ll, ll, p, p, ll, ll, p, ll, ll,
                       p, ll, ll, ll, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_fwd_mma.argtypes = fn.argtypes
        lib.ssd_scan_fwd_mma.restype = ctypes.c_int
        lib.ssd_scan_mma_max_chunk.argtypes = [i, i]
        lib.ssd_scan_mma_max_chunk.restype = ctypes.c_int
    return lib


def ssd_scan_kernel(x, dt, A, B, C, *, chunk: int = 256, return_state: bool = False):
    """Launch the CUDA SSD scan on ``x``'s device.

    x: (B, T, H, P), float32 or bfloat16; dt: (B, T, H) float32; A: (H,)
    contiguous float32; B, C: (B, T, N) in x's dtype; all on one CUDA
    device, each with a contiguous last axis (other strides are free, so the
    model's (B,T,H,P) view of its (B,T,H*P) activations needs no copy; on
    the ``"mma"`` route the base addresses and strides of x, B and C must be
    16-byte multiples, or it raises).  Returns y, a contiguous (B, T, H, P)
    tensor in x's dtype, and with ``return_state`` also the final state, a
    contiguous (B, H, N, P) float32 tensor.  Launches on the current stream
    and does not synchronise; a shape whose chunk does not fit one block's
    shared memory is refused by the launch (``RuntimeError``).
    ``ssd_scan_kernel.launches`` counts launches and
    ``ssd_scan_kernel.launches_by_route`` counts them per :func:`ssd_route`.
    """
    refuse_grad("ssd scan", "differentiate through ops.ssd_scan_trainable (SSDScanFn)",
                x, dt, A, B, C)
    device = require_cuda(x, "ssd scan")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    check_strided("x", x, (x.dtype,), 4, device)
    Bsz, T, H, P = x.shape
    check_strided("dt", dt, (torch.float32,), 3, device)
    check_tensor("A", A, torch.float32, (H,), device)
    for name, t in (("B", B), ("C", C)):
        check_strided(name, t, (x.dtype,), 3, device)
    N = B.shape[-1]
    if tuple(dt.shape) != (Bsz, T, H):
        raise ValueError(f"dt must have shape {(Bsz, T, H)}, got {tuple(dt.shape)}")
    if tuple(B.shape) != (Bsz, T, N) or tuple(C.shape) != (Bsz, T, N):
        raise ValueError(f"B and C must be (B, T, N) = ({Bsz}, {T}, N), got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if Bsz * H >= 2**31:
        raise ValueError(f"B*H = {Bsz * H} exceeds the kernel's grid")
    route = ssd_route(x.dtype, N, P, chunk)
    if route == "mma":
        for name, t in (("x", x), ("B", B), ("C", C)):
            check_tma(name, t, "cp.async")
    y = torch.empty((Bsz, T, H, P), dtype=x.dtype, device=device)
    S = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=device) \
        if return_state else None
    xs, ds, bs, cs, ys = x.stride(), dt.stride(), B.stride(), C.stride(), y.stride()
    with torch.cuda.device(device):
        lib = _library()
        fn = lib.ssd_scan_fwd_mma if route == "mma" else lib.ssd_scan_fwd
        err = fn(ptr(x), xs[0], xs[1], xs[2], ptr(dt), ds[0], ds[1], ds[2], ptr(A),
                 ptr(B), bs[0], bs[1], ptr(C), cs[0], cs[1], ptr(y), ys[0], ys[1], ys[2],
                 ptr(S), DTYPE_CODES[x.dtype], Bsz, T, H, P, N, min(chunk, T),
                 stream(device))
    raise_on_error(err, f"ssd_scan ({route})")
    ssd_scan_kernel.launches += 1
    ssd_scan_kernel.launches_by_route[route] += 1
    return (y, S) if return_state else y


ssd_scan_kernel.launches = 0
ssd_scan_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


def ssd_scan_vjp(x, dt, A, B, C, dy, *, chunk: int = 256):
    """The gradients (dx, ddt, dA, dB, dC) of y = ssd_scan(x, dt, A, B, C)
    (no final state) against the cotangent ``dy`` (B,T,H,P), each in its
    input's dtype.

    Plain torch ops in float32 (float64 for float64 inputs), chunked as the
    forward is, on any device: the chunk-final states and the decays are
    recomputed from the inputs, the state's gradient is carried backward
    over the chunks (dS_{c-1} = exp(cs_last) dS_c + the inter-chunk output's
    term), the intra-chunk terms come from C.B^T, the masked decay matrix
    and x dt in batched products, and the cumulative decays' gradient turns
    into dt A's by a reversed cumsum within each chunk.  Decays above the
    diagonal are masked before the exp (they can overflow).  A short last
    chunk is padded with zero rows, inert as dt = 0 is in the forward, so
    the gradients are those of the unpadded scan the kernel walks.
    ``ssd_scan_vjp.calls`` counts calls."""
    ssd_scan_vjp.calls += 1
    f = _wide(x, dt, A, B, C)
    Bsz, T, H, P = x.shape
    Q = min(chunk, T)
    pad = (-T) % Q

    def chunked(a):                      # (B,T,...) -> (B,nc,Q,...) in f
        a = a.to(f)
        if pad:
            a = F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape(Bsz, -1, Q, *a.shape[2:])

    Bc, Cc = chunked(B), chunked(C)                          # (B,nc,Q,N)
    xh = chunked(x).permute(0, 1, 3, 2, 4)                   # (B,nc,H,Q,P)
    dyh = chunked(dy).permute(0, 1, 3, 2, 4)
    dth = chunked(dt).permute(0, 1, 3, 2)                    # (B,nc,H,Q)
    nc = xh.shape[1]
    xdt = xh * dth[..., None]
    cs = torch.cumsum(dth * A.to(f)[:, None], dim=-1)        # (B,nc,H,Q)

    # intra-chunk: y_i = sum_{j <= i} G_ij L_ij xdt_j, G = C.B^T,
    # L_ij = exp(cs_i - cs_j)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    G = Cc @ Bc.transpose(-1, -2)                            # (B,nc,Q,Q)
    L = (cs[..., :, None] - cs[..., None, :]).masked_fill_(~mask, float("-inf")).exp_()
    dxdt = (L * G[:, :, None]).transpose(-1, -2) @ dyh       # (B,nc,H,Q,P)
    dML = (dyh @ xdt.transpose(-1, -2)).mul_(L)              # dM * L, zero above the diagonal
    del L
    dG = dML.sum(dim=2)                                      # (B,nc,Q,Q)
    dLL = dML.mul_(G[:, :, None])                            # dL * L = d(cs_i - cs_j)
    dcs = dLL.sum(dim=-1) - dLL.sum(dim=-2)
    del dML, dLL
    dC = dG @ Bc
    dB = dG.transpose(-1, -2) @ Cc

    # the chunk-final local states and the states before each chunk
    decay_end = torch.exp(cs[..., -1:] - cs)                 # (B,nc,H,Q)
    wx = xdt * decay_end[..., None]
    S_local = Bc.transpose(-1, -2)[:, :, None] @ wx          # (B,nc,H,N,P)
    dec = torch.exp(cs[..., -1])                             # (B,nc,H)
    S = torch.zeros_like(S_local[:, 0])
    prevs = []
    for c in range(nc):
        prevs.append(S)
        S = S * dec[:, c, :, None, None] + S_local[:, c]
    S_prev = torch.stack(prevs, dim=1)

    # inter-chunk: y_i += exp(cs_i) C_i.S_prev
    ecs = torch.exp(cs)
    dYS = dyh @ S_prev.transpose(-1, -2)                     # (B,nc,H,Q,N)
    dcs = dcs + ecs * (Cc[:, :, None] * dYS).sum(dim=-1)
    dC = dC + (dYS * ecs[..., None]).sum(dim=2)
    dS_direct = Cc.transpose(-1, -2)[:, :, None] @ (dyh * ecs[..., None])  # (B,nc,H,N,P)

    # the state's gradient, carried backward over the chunks
    g = torch.zeros_like(S)
    dSL = [None] * nc
    for c in reversed(range(nc)):
        dSL[c] = g
        g = g * dec[:, c, :, None, None] + dS_direct[:, c]
    dSL = torch.stack(dSL, dim=1)                            # dS_local (B,nc,H,N,P)
    dcs_last = (dSL * S_prev).sum(dim=(-1, -2)) * dec
    dB = dB + (wx @ dSL.transpose(-1, -2)).sum(dim=2)
    dwx = Bc[:, :, None] @ dSL                               # (B,nc,H,Q,P)
    dxdt = dxdt + dwx * decay_end[..., None]
    dww = (dwx * wx).sum(dim=-1)                             # d(decay_end) * decay_end
    dcs = dcs - dww
    dcs[..., -1] += dcs_last + dww.sum(dim=-1)

    # cs = cumsum(dt A) within a chunk: a reversed cumsum, then the product rule
    ddA = dcs.flip(-1).cumsum(-1).flip(-1)                   # (B,nc,H,Q)
    ddt = ddA * A.to(f)[:, None] + (dxdt * xh).sum(dim=-1)
    dA = (ddA * dth).sum(dim=(0, 1, 3))
    dx = dxdt * dth[..., None]

    dx = dx.transpose(2, 3).reshape(Bsz, nc * Q, H, P)[:, :T]
    ddt = ddt.transpose(2, 3).reshape(Bsz, nc * Q, H)[:, :T]
    dB = dB.reshape(Bsz, nc * Q, -1)[:, :T]
    dC = dC.reshape(Bsz, nc * Q, -1)[:, :T]
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype))


ssd_scan_vjp.calls = 0


class SSDScanFn(torch.autograd.Function):
    """The differentiable SSD scan, x (B,T,H,P), dt (B,T,H), A (H,), B, C
    (B,T,N) -> y (B,T,H,P): forward :func:`ssd_scan_kernel` on the card (run
    with grad off, as a Function's forward is) or :func:`ssd_scan_plain` on
    the CPU, backward :func:`ssd_scan_vjp`; gradients in each input's
    dtype."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        if shape_only(x):
            scan = fake.ssd_scan
        else:
            scan = ssd_scan_plain if x.device.type == "cpu" else ssd_scan_kernel
        y = scan(x, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*ssd_scan_vjp(*ctx.saved_tensors, dy, chunk=ctx.chunk), None)
