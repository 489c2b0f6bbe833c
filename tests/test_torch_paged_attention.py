"""Paged decode attention in the port against the reference.

The port's wrapper serves CPU tensors with its plain PyTorch version; it is
held against the reference's Pallas kernel (run in interpret mode, as the
reference's own tests run it) and the numpy page-gathering oracle on the
masking-edge-case matrix of ``tests/test_paged_attention_kernel.py``: page
sizes {1, 2, 8} x empty / single-token / partial / full / max_context-full
streams x contiguous, gapped and permuted tables, with and without a fresh
row — to 2e-5, the reference's float32 kernel tolerance.  The CUDA kernel
itself is compared with the plain version on the card (marked ``gpu``);
the reference package is imported inside the tests that use it, so the
``gpu`` case also runs on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    paged_decode_attention_kernel,
    paged_decode_attention_plain,
)

TOL = 2e-5

PAGED_CASES = [
    # (ps, npages, lengths)
    (1, 8, (0, 1, 3, 8)),          # ps=1: every page is a full tail
    (2, 6, (0, 1, 5, 12)),         # partial tail (1, 5) + full (12 = 6*2)
    (8, 4, (0, 1, 11, 32)),        # big pages: 11 = page + partial, 32 full
    (2, 4, (7, 8, 2, 1)),          # mixed partial/full, no empties
    (8, 2, (16, 16, 16, 16)),      # every stream max_context-full
]
LAYOUTS = ["contig", "gaps", "permuted"]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pool_case(ps, lengths, *, layout, npages, seed=0, d=16):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    need = sum(-(-n // ps) for n in lengths)
    P = max(need * 3, 4)
    q = _rand((B, d), seed + 1)
    kp = _rand((P, ps, d), seed + 2)
    vp = _rand((P, ps, d), seed + 3)
    if layout == "contig":
        ids = list(range(P))
    elif layout == "gaps":
        ids = list(range(0, P, 3)) + [i for i in range(P) if i % 3]
    else:
        ids = list(rng.permutation(P))
    tables = np.zeros((B, npages), np.int32)
    k = 0
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            tables[b, j] = ids[k]
            k += 1
    kn, vn = _rand((B, d), seed + 4), _rand((B, d), seed + 5)
    return q, kp, vp, tables, np.asarray(lengths, np.int32), kn, vn


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("fresh", [False, True], ids=["pages", "fresh"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", PAGED_CASES)
def test_plain_matches_reference_kernel_and_oracle(case, layout, fresh):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    ps, npages, lengths = case
    q, kp, vp, tables, lens, kn, vn = _pool_case(
        ps, lengths, layout=layout, npages=npages, seed=10)
    extra = (kn, vn) if fresh else ()
    got = ops.paged_decode_attention(*_t(q, kp, vp, tables, lens, *extra)).numpy()
    pallas = np.asarray(jops.paged_decode_attention(q, kp, vp, tables, lens, *extra))
    oracle = jref.paged_decode_attention_ref(q, kp, vp, tables, lens, *extra)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)
    # the port's own numpy oracle (the emulator body) is the reference's copy
    assert np.array_equal(ref.paged_decode_attention_ref(q, kp, vp, tables, lens, *extra),
                          oracle)
    for b, n in enumerate(lengths):
        if n == 0 and not fresh:
            assert np.all(got[b] == 0.0)   # exact zeros, not an epsilon quotient
        if n == 0 and fresh:
            assert np.array_equal(got[b], vn[b])   # one valid entry: out IS vn


@pytest.mark.parametrize("fresh", [False, True], ids=["pages", "fresh"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_plain_batched_rows_equal_solo(case, fresh):
    """Row b of a batched call is bitwise a solo call of row b — whatever
    the batch-mates and the physical page ids."""
    ps, npages, lengths = case
    q, kp, vp, tables, lens, kn, vn = _t(*_pool_case(
        ps, lengths, layout="permuted", npages=npages, seed=20))
    extra = (kn, vn) if fresh else ()
    batched = ops.paged_decode_attention(q, kp, vp, tables, lens, *extra)
    for b in range(len(lengths)):
        solo = ops.paged_decode_attention(
            q[b:b + 1], kp, vp, tables[b:b + 1], lens[b:b + 1],
            *(t[b:b + 1] for t in extra))
        assert torch.equal(solo[0], batched[b])


def test_plain_physical_layout_invariance():
    ps, npages, lengths = 2, 6, (0, 1, 5, 12)
    q, kp, vp, tables, lens, _, _ = _pool_case(ps, lengths, layout="contig",
                                               npages=npages, seed=30)
    perm = np.random.default_rng(31).permutation(kp.shape[0])
    inv = np.argsort(perm)
    tables2 = perm[tables].astype(np.int32)
    a = ops.paged_decode_attention(*_t(q, kp, vp, tables, lens))
    b = ops.paged_decode_attention(*_t(q, kp[inv], vp[inv], tables2, lens))
    assert torch.equal(a, b)


def test_cpu_tensors_use_the_plain_version():
    """The wrapper's only dispatch rule: CPU tensors take the plain version
    (and never touch the launch counter); the kernel refuses them."""
    q, kp, vp, tables, lens, _, _ = _t(*_pool_case(2, (3, 5), layout="contig",
                                                   npages=3, seed=40))
    before = paged_decode_attention_kernel.launches
    got = ops.paged_decode_attention(q, kp, vp, tables, lens)
    assert torch.equal(got, paged_decode_attention_plain(q, kp, vp, tables, lens))
    assert paged_decode_attention_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_kernel(q, kp, vp, tables, lens)


def test_paged_attention_op_emulator_matches_host_body():
    """The op's numpy body (guest) and torch body (host) agree."""
    from repro_torch.core import opset

    q, kp, vp, tables, lens, kn, vn = _pool_case(2, (0, 1, 5, 12), layout="permuted",
                                                 npages=6, seed=60)
    op = opset.get("paged_attention")
    (em,) = op.numpy_fn({}, q, kn, vn, kp, vp, tables, lens)
    (host,) = op.torch_fn({}, *_t(q, kn, vn, kp, vp, tables, lens))
    np.testing.assert_allclose(em, host.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 960])
def test_cuda_kernel_matches_plain_on_the_card(d):
    """The CUDA kernel against its plain version on the card, to 2e-5, with
    exact zeros for empty streams and batched rows bitwise equal to solo."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    for ps, npages, lengths in PAGED_CASES:
        for layout in LAYOUTS:
            q, kp, vp, tables, lens, kn, vn = (
                t.to(dev) for t in _t(*_pool_case(ps, lengths, layout=layout,
                                                  npages=npages, seed=70, d=d)))
            for extra in ((), (kn, vn)):
                got = paged_decode_attention_kernel(q, kp, vp, tables, lens, *extra)
                want = paged_decode_attention_plain(q, kp, vp, tables, lens, *extra)
                torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
                for b, n in enumerate(lengths):
                    if n == 0 and not extra:
                        assert torch.all(got[b] == 0.0)
                    solo = paged_decode_attention_kernel(
                        q[b:b + 1], kp, vp, tables[b:b + 1], lens[b:b + 1],
                        *(t[b:b + 1] for t in extra))
                    assert torch.equal(solo[0], got[b])
