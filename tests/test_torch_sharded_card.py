"""The rest of sharded execution on the card: two ranks of a world there
(route ``"shared"`` on one card, gloo; ``"nccl"`` with a card a rank).

* The other four families (Zamba2, xLSTM, SeamlessM4T, Phi-3-vision),
  reduced, float32, tensor-parallel on mesh (data 1, model 2): the loss and
  the gradients against the one-rank step on the CPU (global relative error
  1e-4, the hybrid 2e-4 as ``tests/test_torch_train_families.py``).
* The fsdp layouts on mesh (data 2, model 1): the fully sharded strategy and
  ZeRO (``fsdp=True``), the reduced SmolLM's loss and gradients likewise.
* Sharded offload units on mesh (data 2): the reduced SmolLM's forward
  under both specs against the unsharded compile on the card (2e-3/2e-4),
  the counters equal.

Every test skips without a CUDA device; none imports JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.parallel import spmd

FAMILIES = ["zamba2-2.7b", "xlstm-350m", "seamless-m4t-large-v2", "phi-3-vision-4.2b"]
TP, B = 2, 2


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), compute_dtype="float32", remat=True)


def _batch(cfg):
    from repro_torch.models import api

    seq = 16 if cfg.family == "ssm" else 32
    return api.make_batch(cfg, ShapeConfig("t", "train", seq, B), seed=0)


def _flat(tree):
    from repro_torch.models import api

    return {n: t.detach().float().cpu().numpy() for n, t in api._leaves(tree)}


def _rank_grads(arch, shape, strategy, fsdp):
    """One rank on the card: the reduced arch's loss and gathered gradients
    held by the layout of ``strategy``/``fsdp`` on a mesh of ``shape``."""
    from repro_torch.launch.steps import loss_and_grads, param_layout
    from repro_torch.models import api
    from repro_torch.optim.tree import tree_map
    from repro_torch.parallel import sharding as shd

    cfg = _cfg(arch)
    mesh = spmd.Mesh(shape, ("data", "model"))
    full = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    specs = param_layout(cfg, full, strategy=strategy, fsdp=fsdp, mesh=mesh)
    local = tree_map(lambda t: t.to(mesh.device), shd.shard_tree(mesh, full, specs))
    loss, grads = loss_and_grads(cfg, local, _batch(cfg), tp=TP, mesh=mesh, strategy=strategy,
                                 fsdp=fsdp)
    torch.cuda.synchronize()
    return float(loss), _flat(shd.gather_tree(mesh, grads, specs)), mesh.backend


def _against_cpu(arch, ranks, tol):
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import api

    cfg = _cfg(arch)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    loss, grads = loss_and_grads(cfg, params, _batch(cfg), tp=TP)
    want = _flat(grads)
    for got_loss, got, backend in ranks:
        assert backend == ("gloo" if torch.cuda.device_count() < 2 else "nccl")
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-4)
        num = sum(float(np.sum((got[k] - w) ** 2)) for k, w in want.items())
        den = sum(float(np.sum(w ** 2)) for w in want.values())
        assert np.sqrt(num / den) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_tensor_parallel_families_on_the_card_equal_the_cpu(arch):
    _needs_card()
    ranks = spmd.run_spmd(_rank_grads, 2, device="cuda", args=(arch, (1, 2), "tp", False),
                          timeout=300)
    _against_cpu(arch, ranks, 2e-4 if arch.startswith("zamba2") else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy,fsdp", [("fsdp", False), ("tp", True)],
                         ids=["fsdp", "zero"])
def test_fsdp_layouts_on_the_card_equal_the_cpu(strategy, fsdp):
    _needs_card()
    ranks = spmd.run_spmd(_rank_grads, 2, device="cuda",
                          args=("smollm-360m", (2, 1), strategy, fsdp), timeout=300)
    _against_cpu("smollm-360m", ranks, 1e-4)


def _rank_units(spec):
    from repro_torch import mixed
    from repro_torch.models import api
    from repro_torch.models.programs import export_dense_forward
    from repro_torch.parallel.sharding import P

    cfg = dataclasses.replace(reduced_config("smollm-360m"), compute_dtype="float32")
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    prog, (tokens,) = export_dense_forward(cfg, params, 2, 16, with_host_check=False, tp=TP)
    mesh = spmd.Mesh((2,), ("data",))
    plain = mixed.trace(prog).plan("tech-gf").compile()
    sharded = mixed.trace(prog).plan("tech-gf", mesh=mesh, arg_specs=(P(*spec),)).compile()
    want, wrep = plain.call_reported(tokens)
    got, grep = sharded.call_reported(tokens)
    keys = ("guest_to_host", "host_to_guest", "conversion_builds", "compiles")
    return got, want, [getattr(grep, k) for k in keys], [getattr(wrep, k) for k in keys]


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [("data", None), (None, "data")], ids=["batch", "seq"])
def test_sharded_units_on_the_card_equal_the_unsharded_compile(spec):
    _needs_card()
    for got, want, counters, want_counters in spmd.run_spmd(
            _rank_units, 2, device="cuda", args=(spec,), timeout=300):
        assert len(got) == len(want) == 2            # the logits and their max
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)
        assert counters == want_counters
