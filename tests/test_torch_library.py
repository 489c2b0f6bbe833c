"""The op set's kernels as registered operators (``repro_torch::``).

``rmsnorm``, ``sdpa`` and ``paged_attention`` each reach their kernel
through one registered operator (:mod:`repro_torch.kernels.library`).  On
the CPU the operator is the op set's plain formula; an offload unit holding
it exports with ``torch.export`` as one ``repro_torch::`` node, saves,
loads and gives the same bits.  On the card (``gpu``) each operator equals
the direct :mod:`repro_torch.kernels.ops` call bit for bit, and an exported
unit holding the flash operator loads and runs there.  The reference
package is imported inside the tests that use it.
"""
import io
import math

import numpy as np
import pytest
import torch

from repro_torch.core.opset import REGISTRY
from repro_torch.kernels import library, ops

OPS = {
    # op kind -> (registered operator, input shapes/dtypes, params)
    "rmsnorm": ("rmsnorm", [((3, 5, 32), "float32"), ((32,), "float32")],
                {"eps": 1e-6}),
    "sdpa": ("flash_attention", [((2, 3, 8, 16), "float32"),
                                 ((2, 1, 8, 16), "float32"),
                                 ((2, 1, 8, 16), "float32")], {"causal": True}),
    "paged_attention": ("paged_decode_attention",
                        [((2, 16), "float32"), ((2, 16), "float32"),
                         ((2, 16), "float32"), ((6, 4, 16), "float32"),
                         ((6, 4, 16), "float32"), ((2, 3), "int32"),
                         ((2,), "int32")], {}),
}


def _inputs(kind, device="cpu"):
    rng = np.random.default_rng(3)
    out = []
    for shape, dtype in OPS[kind][1]:
        if dtype == "int32":
            hi = 6 if len(shape) == 2 else 9
            a = rng.integers(0, hi, shape).astype(np.int32)
            if len(shape) == 2:                  # block table: distinct pages
                a = np.arange(np.prod(shape), dtype=np.int32).reshape(shape) % 6
        else:
            a = rng.standard_normal(shape).astype(np.float32)
        out.append(torch.from_numpy(a).to(device))
    return out


def _op_call(kind):
    fn = REGISTRY[kind].torch_fn
    params = OPS[kind][2]
    return lambda *xs: fn(params, *xs)


class _Unit(torch.nn.Module):
    def __init__(self, kind):
        super().__init__()
        self._call = _op_call(kind)

    def forward(self, *xs):
        return tuple(self._call(*xs))


def _export_roundtrip(kind, inputs):
    ep = torch.export.export(_Unit(kind), tuple(inputs), strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue()))
    return ep, loaded


@pytest.mark.parametrize("kind", sorted(OPS))
def test_exported_unit_roundtrips_with_one_registered_node(kind):
    """Export, save, load: the loaded graph holds the ``repro_torch::``
    operator as one node and gives the eager call's bits."""
    inputs = _inputs(kind)
    eager = _op_call(kind)(*inputs)
    ep, loaded = _export_roundtrip(kind, inputs)
    name = f"repro_torch.{OPS[kind][0]}.default"
    for graph in (ep.graph, loaded.graph):
        targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
        assert targets.count(name) == 1, targets
        assert not any(t.startswith("aten.") for t in targets), targets
    got = loaded.module()(*inputs)
    for g, e in zip(got, eager):
        assert torch.equal(g, e)


@pytest.mark.parametrize("kind", sorted(OPS))
def test_registered_op_on_cpu_matches_reference_op(kind):
    """The CPU formula behind each operator is the reference op's, within
    the engine's tolerance (2e-3/2e-4), and its fake gives the same
    shape and dtype."""
    from repro.core.opset import REGISTRY as JREGISTRY

    inputs = _inputs(kind)
    got = _op_call(kind)(*inputs)[0]
    want = JREGISTRY[kind].numpy_fn(OPS[kind][2], *(x.numpy() for x in inputs))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = _op_call(kind)(*(mode.from_tensor(x) for x in inputs))[0]
    assert tuple(fake.shape) == tuple(got.shape) and fake.dtype == got.dtype


def test_sdpa_scale_and_noncausal_reach_the_operator():
    q, k, v = _inputs("sdpa")
    fn = REGISTRY["sdpa"].torch_fn
    a = fn({"causal": False, "scale": 0.5}, q, k, v)[0]
    b = library.flash_attention(q, k, v, False, 0.5)
    assert torch.equal(a, b)
    c = fn({"causal": True}, q, k, v)[0]
    assert torch.equal(c, library.flash_attention(q, k, v, True, 1.0 / math.sqrt(16)))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_registered_ops_equal_direct_kernel_calls_on_card():
    """Each operator on CUDA tensors launches its kernel and equals the
    direct kernels/ops call bit for bit, at the op set's path shapes."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel

    dev = _cuda()
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    x, w = f32(8, 256, 960), f32(960)
    before = rmsnorm_kernel.launches
    assert torch.equal(library.rmsnorm(x, w, 1e-5), ops.rmsnorm(x, w, eps=1e-5))
    assert rmsnorm_kernel.launches == before + 2
    for (B, Hq, Hk, T, d) in ((8, 15, 5, 256, 64), (8, 1, 1, 128, 960)):
        q, k, v = f32(B, Hq, T, d), f32(B, Hk, T, d), f32(B, Hk, T, d)
        before = flash_attention_kernel.launches
        assert torch.equal(library.flash_attention(q, k, v, True, None),
                           ops.flash_attention(q, k, v, causal=True))
        assert flash_attention_kernel.launches == before + 2
    q, kn, vn = _inputs("paged_attention", dev)[:3]
    kp, vp, tables, lengths = _inputs("paged_attention", dev)[3:]
    assert torch.equal(
        library.paged_decode_attention(q, kp, vp, tables, lengths, kn, vn),
        ops.paged_decode_attention(q, kp, vp, tables, lengths, kn, vn))


@pytest.mark.gpu
def test_exported_flash_unit_loads_and_runs_on_card():
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    dev = _cuda()
    inputs = [t.to(dev) for t in _inputs("sdpa")]
    eager = _op_call("sdpa")(*inputs)
    _, loaded = _export_roundtrip("sdpa", inputs)
    before = flash_attention_kernel.launches
    got = loaded.module()(*inputs)
    assert flash_attention_kernel.launches == before + 1
    assert torch.equal(got[0], eager[0])
