"""Op-by-op parity of the port's ``torch_fn`` with the reference ``jax_fn``.

Every op kind of the reference registry exists in the port with the same
``offloadable`` flag (an op left without host semantics would silently turn
host-only and change plans and crossing counts); the port adds only the
hybrid forward's ``ssd_scan``, ``conv1d`` and ``softplus``, which no program
of the reference uses (``tests/test_torch_hybrid_forward.py`` checks them).  Each host body runs on the
same seeded numpy inputs in both frameworks: selection ops must agree
bitwise, the rest to float32 tolerance, and the result dtypes must match
(the 32-bit canonical forms on both sides).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import opset as jref
from repro_torch.core import opset as tport

BITWISE = {"where", "pad_to", "slice", "reshape", "transpose", "concat",
           "roll", "expand_dims", "squeeze"}
HOST_ONLY = {"host_print", "host_assert_finite", "py_call"}
PORT_ONLY = {"ssd_scan", "conv1d", "softplus"}


def _f(rng, *shape, lo=None):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.abs(x) + lo if lo is not None else x


def _case(kind, rng):
    """(params, inputs) for one op kind, drawn from ``rng``."""
    f = lambda *s, **kw: _f(rng, *s, **kw)  # noqa: E731
    i32 = lambda hi, *s: rng.integers(0, hi, s, dtype=np.int32)  # noqa: E731
    unary_pos = {"log", "sqrt", "rsqrt"}
    if kind in {"neg", "exp", "tanh", "square", "abs", "relu", "floor", "silu",
                "gelu", "sigmoid"} | unary_pos:
        return {}, [f(3, 5, lo=0.1) if kind in unary_pos else 3 * f(3, 5)]
    if kind in {"add", "sub", "mul", "maximum", "minimum"}:
        return {}, [f(3, 5), f(5)]
    if kind == "div":
        return {}, [f(3, 5), f(5, lo=0.5)]
    if kind in {"eq", "lt"}:
        return {}, [i32(3, 4, 6), i32(3, 6)]
    table = {
        "reshape": ({"shape": (4, -1)}, [f(2, 3, 4)]),
        "transpose": ({"perm": (2, 0, 1)}, [f(2, 3, 4)]),
        "cast": ({"dtype": "int32"}, [10 * f(3, 4)]),
        "concat": ({"axis": 1}, [f(3, 2), f(3, 4)]),
        "slice": ({"starts": (1, 2), "sizes": (2, 3)}, [f(4, 6)]),
        "expand_dims": ({"axis": 1}, [f(3, 4)]),
        "squeeze": ({"axis": 1}, [f(3, 1, 4)]),
        "pad_to": ({"axis": 1, "target": 7}, [f(3, 4)]),
        "roll": ({"shift": 2, "axis": 1}, [f(3, 5)]),
        "where": ({}, [rng.random((3, 5)) < 0.5, f(3, 5), f(3, 5)]),
        "reduce_sum": ({"axis": (1, 2)}, [f(3, 4, 5)]),
        "reduce_max": ({"axis": (1,), "keepdims": True}, [f(3, 4, 5)]),
        "reduce_mean": ({"axis": (0, 2)}, [f(3, 4, 5)]),
        "softmax": ({"axis": -1}, [3 * f(3, 7)]),
        "rmsnorm": ({"eps": 1e-6}, [f(3, 8), f(8)]),
        "layernorm": ({"eps": 1e-5}, [f(3, 8), f(8), f(8)]),
        "matmul": ({}, [f(2, 3, 4), f(4, 5)]),
        "embed": ({}, [f(10, 6), i32(10, 2, 3)]),
        "sdpa": ({"causal": True}, [f(2, 4, 5, 8), f(2, 2, 5, 8), f(2, 2, 5, 8)]),
        "rope": ({"theta": 10000.0}, [f(1, 2, 4, 8)]),
        "fft": ({}, [f(4, 8)]),
        "ifft": ({}, [(f(4, 8) + 1j * f(4, 8)).astype(np.complex64)]),
        "sort": ({"axis": -1}, [f(3, 9)]),
        "cumsum": ({"axis": -1}, [f(3, 9)]),
        "real": ({}, [(f(3, 4) + 1j * f(3, 4)).astype(np.complex64)]),
    }
    if kind == "paged_attention":
        B, d, ps, P, npages = 3, 16, 2, 8, 4
        lengths = np.array([0, 3, 8], np.int32)
        tables = np.zeros((B, npages), np.int32)
        tables[1, :2] = [5, 2]
        tables[2, :4] = [7, 1, 4, 0]
        return {}, [f(B, d), f(B, d), f(B, d), f(P, ps, d), f(P, ps, d),
                    tables, lengths]
    return table[kind]


def test_registry_kinds_and_offloadable_flags_match():
    assert set(tport.REGISTRY) == set(jref.REGISTRY) | PORT_ONLY
    assert not PORT_ONLY & set(jref.REGISTRY)
    for kind, ref_def in jref.REGISTRY.items():
        assert tport.REGISTRY[kind].offloadable == ref_def.offloadable, kind
        assert tport.REGISTRY[kind].nout == ref_def.nout, kind
    host_only = {k for k, d in tport.REGISTRY.items() if d.torch_fn is None}
    assert host_only == HOST_ONLY
    assert len(tport.REGISTRY) - len(host_only) == 47 + len(PORT_ONLY)


OFFLOADABLE = sorted(k for k in jref.REGISTRY if k not in HOST_ONLY)


@pytest.mark.parametrize("kind", OFFLOADABLE)
def test_torch_fn_matches_jax_fn(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    params, inputs = _case(kind, rng)
    want = jref.get(kind).jax_fn(params, *[jnp.asarray(x) for x in inputs])
    got = tport.get(kind).torch_fn(params, *[torch.from_numpy(np.array(x)) for x in inputs])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (kind, g.dtype, w.dtype)
        assert g.shape == w.shape, (kind, g.shape, w.shape)
        if kind in BITWISE:
            assert np.array_equal(g, w), kind
        else:
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=kind)


@pytest.mark.parametrize("kind", OFFLOADABLE)
def test_infer_and_cost_match_reference(kind):
    """The shared semantics (abstract eval, cost) are the reference's own."""
    rng = np.random.default_rng(1 + sum(map(ord, kind)))
    params, inputs = _case(kind, rng)
    avals = [tport.AVal.of(x) for x in inputs]
    ref_avals = [jref.AVal.of(x) for x in inputs]
    got = tport.get(kind).infer_fn(params, *avals)
    want = jref.get(kind).infer_fn(params, *ref_avals)
    assert [(a.shape, a.dtype) for a in got] == [(a.shape, a.dtype) for a in want]
    gc = tport.get(kind).cost_fn(params, *avals)
    wc = jref.get(kind).cost_fn(params, *ref_avals)
    assert (gc.flops, gc.bytes) == (wc.flops, wc.bytes)


@pytest.mark.parametrize("dtype,want", [
    ("float64", torch.float32), ("int64", torch.int32), ("uint64", torch.uint32),
    ("complex128", torch.complex64), ("float32", torch.float32),
    ("int32", torch.int32), ("bool", torch.bool), ("float16", torch.float16),
])
def test_canonical_dtypes_are_32_bit(dtype, want):
    """Units compute in the 32-bit forms the reference engine places."""
    assert tport.torch_dtype(dtype) == want
