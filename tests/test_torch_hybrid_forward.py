"""``export_hybrid_forward`` (Granite 4.0-H's layout: per-layer Mamba-2 or
attention mixers, a dense MLP in each layer, muP scalings) on the mixed
engine, against the benchmark's plain reference
(``portbench/reference/granite-4.0-h-micro-mixed.py``, plain torch, which
computes the SSD in its quadratic form without chunks), and the op set's
``ssd_scan``, ``conv1d`` and ``softplus``.

The CPU tests use a tiny configuration that keeps every kind of layer:
types [mamba, attention, mamba, mamba], d_model 64, 4 query and 2 KV heads
of 16, 4 Mamba heads of 16 (expand 1), N 16, a conv of width 4, vocabulary
256, 40 positions against a chunk of 16 (so the last chunk is short).  The
``gpu`` tests run the ``ssd_scan`` op at the published widths on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import registry
from repro_torch import mixed
from repro_torch.core import NativeInfeasibleError
from repro_torch.core.opset import REGISTRY
from repro_torch.kernels.ssm_scan import ssd_route, ssd_scan_kernel, ssd_scan_plain
from repro_torch.models.programs import export_hybrid_forward
from repro_torch.serve import BucketLadder, MixedServer

CONFIG = "granite-4.0-h-micro-mixed"
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=4,
            mamba_d_head=16, mamba_d_state=16, mamba_expand=1, shared_intermediate_size=128,
            intermediate_size=128, vocab_size=256, num_hidden_layers=4,
            layer_types=["mamba", "attention", "mamba", "mamba"])
SEQ, CHUNK = 40, 16
# float32 on both sides, in other orders of summation (chunked scan against
# the quadratic form, conv taps against F.conv1d, row-block GEMMs): the
# tiny forward reads ~5e-7 of the largest logit; 1e-5 leaves 20x room and is
# 20x below the benchmark's own limit
REL_TOL = 1e-5


def _reference():
    return registry.reference(registry.config(CONFIG)["reference"])


def _tiny(seed=7):
    """(configuration, weights, port config, program, tokens) at the tiny size."""
    cfgj = registry.config(CONFIG)
    m = {**cfgj, **TINY}
    ref = _reference()
    drv = registry.driver(cfgj["driver"])
    w = ref.make_weights(m, seed, "cpu")
    cfg = drv.port_config({**cfgj["system"], "ssd_chunk": CHUNK}, m)
    prog, (tokens,) = export_hybrid_forward(cfg, drv.port_params(w, ref.dims(m)), 3, SEQ)
    return m, w, cfg, prog, tokens


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_hybrid_forward_matches_the_reference():
    """trace -> plan tech-gfp -> compile on the CPU: logits and row maxima
    against the reference's logits on the same seeded weights."""
    m, w, cfg, prog, tokens = _tiny()
    hybrid = mixed.trace(prog).plan("tech-gfp").compile(backend="cpu")
    logits, row_max = hybrid(tokens)
    want = _reference().logits(w, m, torch.from_numpy(tokens.astype(np.int64))).numpy()
    assert logits.shape == (3, SEQ, 256) and row_max.shape == (3, SEQ)
    assert _rel_err(logits, want) < REL_TOL
    assert _rel_err(row_max, want.max(-1)) < REL_TOL
    units = hybrid.plan_for(tokens).units
    assert {"layer0.mamba", "layer1.attn", "layer3.mlp", "lm_head"} <= set(units)


def test_guest_alone_computes_the_same_function():
    """The numpy bodies (``qemu``: every op interpreted) agree too."""
    m, w, cfg, prog, tokens = _tiny(seed=8)
    logits, _ = mixed.trace(prog).plan("qemu").compile(backend="cpu")(tokens)
    want = _reference().logits(w, m, torch.from_numpy(tokens.astype(np.int64))).numpy()
    assert _rel_err(logits, want) < REL_TOL


def test_native_is_infeasible_with_the_host_check():
    *_, prog, _ = _tiny()
    with pytest.raises(NativeInfeasibleError):
        mixed.trace(prog).plan("native")


def test_batched_requests_equal_solo_requests():
    """Two concurrent requests of 1 and 2 rows, coalesced into one bucket,
    answer bitwise as each does alone."""
    *_, prog, tokens = _tiny(seed=9)
    planned = mixed.trace(prog).plan("tech-gfp")
    rng = np.random.default_rng(3)
    one = rng.integers(0, 256, (1, SEQ), dtype=np.int32)
    two = rng.integers(0, 256, (2, SEQ), dtype=np.int32)
    with MixedServer(planned, backend="cpu", ladder=BucketLadder(batch_sizes=(1, 2, 4)),
                     max_batch_delay=0.5, workers=2) as server:
        server.warm(one)
        solo = [server.request(one, timeout=120), server.request(two, timeout=120)]
        futures = [server.submit(one), server.submit(two)]
        together = [f.result(timeout=120) for f in futures]
        rep = server.report()
    # the solo requests ran as batches of 1 and 2 rows, the pair as one of 4
    assert rep.fallback_requests == 0 and rep.requests == 4 and rep.batches == 3
    assert rep.request_rows == 6 and rep.padded_rows == 7
    for alone, batched in zip(solo, together):
        for a, b in zip(alone, batched):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_export_refuses_other_families_and_bad_layouts():
    from repro_torch.configs import reduced_config

    with pytest.raises(ValueError, match="hybrid"):
        export_hybrid_forward(reduced_config("smollm-360m"), {}, 1, 4)
    _, _, cfg, _, _ = _tiny()
    short = dataclasses.replace(cfg, layout=dataclasses.replace(
        cfg.layout, layer_types=("mamba", "attention")))
    with pytest.raises(ValueError, match="layer_types"):
        export_hybrid_forward(short, {}, 1, 4)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


def _ssd_inputs(b, t, h, p, n, seed, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, h, p), generator=g, dtype=dtype)
    dt = F.softplus(torch.randn((b, t, h), generator=g, dtype=dtype) - 2.0)
    A = -torch.exp(torch.randn((h,), generator=g, dtype=dtype))
    B = torch.randn((b, t, n), generator=g, dtype=dtype)
    C = torch.randn((b, t, n), generator=g, dtype=dtype)
    return tuple(a.to(device) for a in (x, dt, A, B, C))


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_scan_op_bodies_agree_with_the_quadratic_form(chunk):
    """The numpy body, the torch body on the CPU and the reference's
    quadratic (dual) form, at a T that is no multiple of the chunk.  float32
    in other orders of summation: 2e-5 of the largest output."""
    args = _ssd_inputs(2, 37, 4, 16, 16, seed=chunk)
    op = REGISTRY["ssd_scan"]
    guest = op.numpy_fn({"chunk": chunk}, *(a.numpy() for a in args))[0]
    host = op.torch_fn({"chunk": chunk}, *args)[0]
    quad = _reference().ssd(*args)
    scale = float(quad.abs().max())
    assert guest.dtype == np.float32 and host.dtype == torch.float32
    assert float((host - quad).abs().max()) / scale < 2e-5
    assert np.abs(guest - quad.numpy()).max() / scale < 2e-5
    assert torch.equal(host, ssd_scan_plain(*args, chunk=chunk))


def test_ssd_scan_op_records_a_span_per_launch():
    from repro_torch import obs

    args = _ssd_inputs(2, 20, 4, 8, 16, seed=3)
    with obs.session() as tracer:
        REGISTRY["ssd_scan"].torch_fn({"chunk": 8}, *args)
    spans = [s for s in tracer.snapshot() if s.kind == obs.SSD]
    assert len(spans) == 1
    assert spans[0].args == {"b": 2, "t": 20, "h": 4, "n": 16, "p": 8, "chunk": 8,
                             "route": "plain"}


def test_conv1d_op_matches_a_grouped_conv():
    """Both bodies against ``F.conv1d(groups=C)`` with the causal padding
    (float64, so the reference's own rounding does not enter)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 11, 6), generator=g)
    w = torch.randn((6, 4), generator=g)
    b = torch.randn((6,), generator=g)
    want = F.conv1d(x.double().transpose(1, 2), w.double()[:, None, :], b.double(),
                    padding=3, groups=6)[..., :11].transpose(1, 2)
    op = REGISTRY["conv1d"]
    host = op.torch_fn({}, x, w, b)[0]
    guest = op.numpy_fn({}, x.numpy(), w.numpy(), b.numpy())[0]
    assert host.dtype == torch.float32 and guest.dtype == np.float32
    torch.testing.assert_close(host.double(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(guest, want.numpy(), rtol=1e-6, atol=1e-6)
    # causal: the first output row sees only the first input row
    assert torch.equal(op.torch_fn({}, x[:, :1], w, b)[0][:, 0], host[:, 0])


def test_softplus_op_follows_torch_threshold():
    x = torch.tensor([-40.0, -3.0, -1e-3, 0.0, 2.5, 19.99, 20.0, 20.01, 60.0])
    op = REGISTRY["softplus"]
    assert torch.equal(op.torch_fn({}, x)[0], F.softplus(x))
    guest = op.numpy_fn({}, x.numpy())[0]
    np.testing.assert_allclose(guest, F.softplus(x).numpy(), rtol=1e-6, atol=1e-7)
    assert guest[-1] == 60.0 and guest[-2] == np.float32(20.01)   # x itself above 20


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ssd_scan_op_at_the_published_widths_on_card():
    """H 64, P 64, N 128, T 512, float32, batch 8: the op launches the
    kernel once, on the CUDA-core body at the configuration's chunk 128,
    and agrees with the plain chunked version."""
    dev = _cuda()
    chunk = registry.config(CONFIG)["system"]["ssd_chunk"]
    args = _ssd_inputs(8, 512, 64, 64, 128, seed=11, device=dev)
    route = ssd_route(torch.float32, 128, 64, chunk)
    assert (route, chunk) == ("simt", 128)
    before = dict(ssd_scan_kernel.launches_by_route)
    y = REGISTRY["ssd_scan"].torch_fn({"chunk": chunk}, *args)[0]
    torch.cuda.synchronize()
    before[route] += 1
    assert ssd_scan_kernel.launches_by_route == before
    want = ssd_scan_plain(*args, chunk=chunk)
    torch.testing.assert_close(y, want, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_reference_ssd_matches_the_plain_scan_in_float64_on_card():
    """The reference's quadratic form against the kernel's plain chunked
    version, both in float64, at one layer's shape of one sequence."""
    dev = _cuda()
    args = _ssd_inputs(1, 512, 64, 64, 128, seed=12, device=dev, dtype=torch.float64)
    want = ssd_scan_plain(*args, chunk=128)
    got = _reference().ssd(*args)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_ssd_scan_unit_exports_with_one_registered_node():
    """A unit holding the op exports with ``torch.export`` as one
    ``repro_torch::ssd_scan`` node, saves, loads and gives the eager bits."""
    import io

    op = REGISTRY["ssd_scan"]

    class Unit(torch.nn.Module):
        def forward(self, *xs):
            return tuple(op.torch_fn({"chunk": 8}, *xs))

    args = _ssd_inputs(2, 20, 4, 8, 16, seed=4)
    ep = torch.export.export(Unit(), args, strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue()))
    targets = [str(n.target) for n in loaded.graph.nodes if n.op == "call_function"]
    assert targets.count("repro_torch.ssd_scan.default") == 1, targets
    assert torch.equal(loaded.module()(*args)[0], Unit()(*args)[0])
