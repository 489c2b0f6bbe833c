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
    PAGED_SPLIT,
    paged_route,
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


def _pool(P, ps, d):
    return torch.zeros(P, ps, d)


@pytest.mark.parametrize("d,ps,make,want", [
    (960, 16, lambda: _pool(1024, 16, 960), "split"),     # the serving step's pools
    (16, 1, lambda: _pool(8, 1, 16), "split"),
    (16, 8, lambda: _pool(8, 8, 16), "split"),
    (960, 1, lambda: _pool(8, 1, 960), "split"),
    (18, 2, lambda: _pool(8, 2, 18), "simt"),             # rows of no 16-byte multiple
    (960, 32, lambda: _pool(4, 32, 960), "simt"),         # two pages above 227 KB
    (4096, 1, lambda: _pool(4, 1, 4096), "simt"),         # wider than the body's columns
    (960, 16, lambda: torch.zeros(1 + 2 * 16 * 960)[1:].view(2, 16, 960), "simt"),
], ids=["serving", "d16-ps1", "d16-ps8", "d960-ps1", "odd-d", "big-page", "too-wide",
        "base-address"])
def test_paged_route_is_picked_by_shape_and_alignment(d, ps, make, want):
    """The serving shape and the reference's cases take the split body;
    rows of no 16-byte multiple, pages too large for two in shared memory,
    too wide a row and a pool its bulk copies cannot address take the
    CUDA-core one."""
    pool = make()
    assert paged_route(d, ps, pool, pool) == want


def _check_on_card(dev, ps, npages, lengths, d, layout, seed, route):
    """The kernel on one pool case, with and without a fresh row: its route,
    the plain version's values, exact zeros for an empty stream (exactly vn
    with a fresh row), a repeat launch and row b's solo launch bitwise."""
    q, kp, vp, tables, lens, kn, vn = (
        t.to(dev) for t in _t(*_pool_case(ps, lengths, layout=layout, npages=npages,
                                          seed=seed, d=d)))
    assert paged_route(d, ps, kp, vp) == route
    for extra in ((), (kn, vn)):
        before = dict(paged_decode_attention_kernel.launches_by_route)
        got = paged_decode_attention_kernel(q, kp, vp, tables, lens, *extra)
        assert paged_decode_attention_kernel.launches_by_route == {
            **before, route: before[route] + 1}
        want = paged_decode_attention_plain(q, kp, vp, tables, lens, *extra)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        assert torch.equal(paged_decode_attention_kernel(q, kp, vp, tables, lens, *extra), got)
        for b, n in enumerate(lengths):
            if n == 0:
                assert torch.equal(got[b], vn[b]) if extra else torch.all(got[b] == 0.0)
            solo = paged_decode_attention_kernel(
                q[b:b + 1], kp, vp, tables[b:b + 1], lens[b:b + 1],
                *(t[b:b + 1] for t in extra))
            assert torch.equal(solo[0], got[b])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 960])
def test_cuda_kernel_split_edges_on_the_card(d):
    """The split body at the edges of its page split at ps 16 and a
    128-slot table: lengths on page boundaries, on the boundaries of the
    ranks' page runs (C - 1, C, C + 1 and 2C pages), a full table, length
    0 with and without a fresh row; and a width of no 16-byte rows on the
    CUDA-core body."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    ps, npages = 16, 128
    C = PAGED_SPLIT
    lengths = (0, 1, ps - 1, ps, ps + 1, (C - 1) * ps, C * ps, C * ps + 1, (C + 1) * ps,
               2 * C * ps - 1, 2 * C * ps, npages * ps - 1, npages * ps)
    _check_on_card(dev, ps, npages, lengths, d, "permuted", 80, "split")
    _check_on_card(dev, 2, 6, (0, 1, 5, 12), 18, "permuted", 81, "simt")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 960])
def test_cuda_kernel_matches_plain_on_the_card(d):
    """The CUDA kernel against its plain version on the card, to 2e-5, on
    the split body, with exact zeros for empty streams, repeat launches and
    batched rows bitwise equal to solo ones."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    for ps, npages, lengths in PAGED_CASES:
        for layout in LAYOUTS:
            _check_on_card(dev, ps, npages, lengths, d, layout, 70, "split")
