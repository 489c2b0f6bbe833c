"""The port's launch helpers and H100 rooflines against the reference.

``models.api.input_specs`` and ``launch.steps.step_for_shape`` against the
reference's (shapes, dtypes and step kinds for every arch x shape);
``launch.rooflines``' parameter counts, model FLOPs and memory bytes against
the reference's integers, and each roofline term against the reference's
times the ratio of the two packages' hardware constants; the link rate of a
mesh axis; the collectives' operand bytes by kind on a 2-rank gloo world
(``parallel/spmd.py:collective_stats``), DTensor redistributions included;
and the kernels' shape-only stand-ins (``kernels/fake.py``) against the
shapes the kernels return.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.kernels import fake, ops
from repro_torch.kernels.decode_attention import decode_attention_kernel
from repro_torch.launch import rooflines
from repro_torch.launch.steps import step_for_shape
from repro_torch.models import api
from repro_torch.parallel import spmd

TP = 16


@pytest.fixture(scope="module")
def jroof():
    """The reference's rooflines module, its parameter count memoised (the
    reference traces ``init`` on every call)."""
    from repro.launch import rooflines as ref

    original = ref.param_count
    ref.param_count = functools.lru_cache(maxsize=None)(original)
    yield ref
    ref.param_count = original


@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_and_step_kinds_equal_the_reference(arch):
    from repro.configs import get_config as jget
    from repro.models import api as japi
    from repro.launch.steps import step_for_shape as jstep_for_shape

    for shape in SHAPES.values():
        want = japi.input_specs(jget(arch), shape)
        got = api.input_specs(get_config(arch), shape)
        assert list(got) == list(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(spec.shape)
            assert str(got[k].dtype).removeprefix("torch.") == str(np.dtype(spec.dtype))
        assert step_for_shape(get_config(arch), shape, tp=TP)[0] == \
            jstep_for_shape(jget(arch), shape, tp=TP)[0]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_counts_flops_and_bytes_equal_the_reference(jroof, arch):
    from repro.configs import get_config as jget

    cfg, jcfg = get_config(arch), jget(arch)
    assert rooflines.param_count(cfg, TP) == jroof.param_count(jcfg, TP)
    assert rooflines.active_param_count(cfg, TP) == jroof.active_param_count(jcfg, TP)
    for shape in SHAPES.values():
        assert rooflines.model_flops(cfg, shape, TP) == jroof.model_flops(jcfg, shape, TP)
        for kv_quant in (False, True):
            assert rooflines.memory_bytes(cfg, shape, TP, kv_quant) == \
                jroof.memory_bytes(jcfg, shape, TP, kv_quant)


@pytest.mark.parametrize("arch", ["qwen2-7b", "dbrx-132b", "zamba2-2.7b", "xlstm-350m",
                                  "seamless-m4t-large-v2"])
def test_roofline_terms_scale_by_the_constants(jroof, arch):
    """The same model FLOPs, bytes and collective bytes over the H100's
    constants: compute by 197/989 (the reference's TPU peak over the bf16
    dense peak), memory by 819e9/3.35e12, the collective term at one
    400 Gb/s port against the reference's 50e9 B/s link (the same rate)."""
    from repro.configs import get_config as jget

    for shape in SHAPES.values():
        for chips, coll in ((256, 3_000_000), (512, 12_345_678)):
            want = jroof.roofline(jget(arch), shape, chips, coll, tp=TP)
            got = rooflines.roofline(get_config(arch), shape, chips, {"data": coll}, tp=TP)
            for key in ("model_flops", "memory_bytes", "params", "active_params"):
                assert got[key] == want[key]
            t, w = got["terms"], want["terms"]
            np.testing.assert_allclose(t["compute_s"], w["compute_s"] * 197e12 / 989e12,
                                       rtol=1e-12)
            np.testing.assert_allclose(t["memory_s"], w["memory_s"] * 819e9 / 3.35e12,
                                       rtol=1e-12)
            np.testing.assert_allclose(t["collective_s"], w["collective_s"] * 50e9 /
                                       rooflines.NIC_BW, rtol=1e-12)
            assert got["bound_s"] == max(t["compute_s"], t["memory_s"], t["collective_s"])


def test_link_rate_of_an_axis():
    single, multi = {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}
    for shape in (single, multi):
        for axis in shape:
            assert rooflines.link_bw(axis, shape) == rooflines.NIC_BW == 50e9
    assert rooflines.link_bw("data", {"data": 2, "model": 1}) == rooflines.NVLINK_BW == 450e9
    assert rooflines.link_bw("data", {"data": 2, "model": 4}) == rooflines.NVLINK_BW
    assert rooflines.link_bw("data", {"data": 4, "model": 4}) == rooflines.NIC_BW
    assert rooflines.link_bw("model", {"data": 4, "model": 8}) == rooflines.NVLINK_BW
    assert rooflines.collective_seconds({"data": 50e9, "model": 450e9},
                                        {"data": 16, "model": 2}) == pytest.approx(2.0)


def _collectives_rank():
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel import units

    mesh = spmd.Mesh((2,), ("data",))
    spmd.reset_collectives()
    with mesh:
        spmd.psum(torch.ones(3, 5), "data")                                     # 60 B
        spmd.all_gather(torch.ones(2, 4, dtype=torch.bfloat16), "data")          # 16 B
        spmd.all_to_all(torch.ones(4, 6), "data", 0, 1)                          # 96 B
        spmd.ppermute(torch.ones(3, dtype=torch.float64), "data", [(0, 1)])      # 24 B, rank 0
    with units.unit_scope():
        x = units.to_mesh(mesh, torch.ones(4, 8), ("data", None))
        x.redistribute(mesh.device_mesh, [Replicate()])                          # 2x8x4 B
    stats = spmd.collective_stats["gloo"]
    return stats.as_dict(), dict(spmd.collectives_by_route["gloo"])


def test_collective_bytes_by_kind_on_two_ranks():
    ranks = spmd.run_spmd(_collectives_rank, 2, device="cpu", timeout=120)
    for rank, (stats, calls) in enumerate(ranks):
        want = {"all_reduce": 60, "all_gather": 16 + 64, "all_to_all": 96,
                "ppermute": 24 if rank == 0 else 0}
        assert stats["bytes_by_kind"] == want
        assert stats["count_by_kind"] == {"all_reduce": 1, "all_gather": 2, "all_to_all": 1,
                                          "ppermute": 1}
        assert stats["bytes_by_axis"] == {"data": sum(want.values())}
        assert stats["total_bytes"] == sum(want.values())
        # the backend's own operations: ppermute is an all_to_all_single
        assert calls == {"all_reduce": 1, "all_gather": 2, "all_to_all": 2}


def test_shape_only_kernels_give_the_kernels_shapes():
    """On meta tensors each entry returns its kernel's output shapes and
    dtypes, counted as route "fake" (not as a launch), with its FLOPs."""
    meta = torch.device("meta")
    q = torch.empty(2, 6, 1, 16, dtype=torch.bfloat16, device=meta)
    k = torch.empty(2, 3, 40, 16, dtype=torch.float32, device=meta)
    fake.reset()
    launches = decode_attention_kernel.launches
    o, lse = ops.decode_attention(q, k, k, torch.empty((), device=meta), return_lse=True)
    assert (o.shape, o.dtype, lse.shape, lse.dtype) == ((2, 6, 1, 16), torch.bfloat16,
                                                        (2, 6), torch.float32)
    assert decode_attention_kernel.launches_by_route["fake"] == 1
    assert decode_attention_kernel.launches == launches
    assert fake.flops["decode_attention"] == 4 * 2 * 6 * 40 * 16
    qf = torch.empty(2, 4, 10, 8, device=meta)
    kf = torch.empty(2, 2, 10, 8, device=meta)
    assert ops.flash_attention(qf, kf, kf).shape == (2, 4, 10, 8)
    assert fake.flops["flash_attention"] == 4 * 8 * 2 * 4 * 55
    y, S = ops.ssd_scan(torch.empty(1, 9, 2, 4, device=meta), torch.empty(1, 9, 2, device=meta),
                        torch.empty(2, device=meta), torch.empty(1, 9, 3, device=meta),
                        torch.empty(1, 9, 3, device=meta), chunk=4, return_state=True)
    assert (y.shape, S.shape, S.dtype) == ((1, 9, 2, 4), (1, 2, 3, 4), torch.float32)
    x = torch.empty(3, 8, dtype=torch.bfloat16, device=meta, requires_grad=True)
    y = ops.rmsnorm_trainable(x, torch.empty(8, device=meta))
    y.sum().backward()
    assert x.grad.shape == x.shape
    assert fake.visible_pairs(10, 10, True) == 55 and fake.visible_pairs(4, 10, True) == 10
    assert fake.visible_pairs(10, 4, True) == 10 + 6 * 4
    fake.reset()
    assert "fake" not in decode_attention_kernel.launches_by_route and not fake.flops
