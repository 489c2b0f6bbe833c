"""The port's layout rules (``repro_torch.parallel.sharding``) against the
JAX package's, spec by spec as tuples.

Every arch in ``configs/``, its reduced config (real parameter trees) and its
full one (trees by shape only: ``jax.eval_shape`` there, the meta device
here), under the ``tp`` strategy, ``tp`` with ZeRO (``fsdp=True``) and the
``fsdp`` strategy, on (2, 2), (2, 2, 2) and the production (16, 16) and
(2, 16, 16) meshes; ``batch_pspecs`` and ``cache_pspecs`` for each reduced
arch.  The reference's rules read only a mesh's axis names and device-array
shape, so a stand-in mesh object serves both packages.  Plus the port's
own: ``shard_tree``/``gather_tree`` round trips in a 4-rank gloo world,
``to_named``'s placements, ``layer_slice_pspecs``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import api
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.spmd import Mesh, run_spmd

ARCHS = ["qwen2-7b", "smollm-360m", "llama3.2-1b", "qwen2-1.5b", "dbrx-132b",
         "granite-moe-1b-a400m", "zamba2-2.7b", "xlstm-350m", "seamless-m4t-large-v2",
         "phi-3-vision-4.2b"]
MESHES = {(2, 2): ("data", "model"), (2, 2, 2): ("pod", "data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


def _meshes(shape):
    axes = MESHES[shape]
    port = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    ref = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    return port, ref


def _ref_items(tree):
    import jax
    from jax.sharding import PartitionSpec
    from repro.parallel.sharding import _path_str

    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {_path_str(path): tuple(spec) for path, spec in flat}


def _port_items(tree):
    return {name: tuple(spec) for name, spec in shd._spec_items(tree)}


def _trees(arch, reduced):
    import jax
    from repro.configs import get_config as jget, reduced_config as jreduced
    from repro.models import api as japi

    tp = 2 if reduced else 16
    cfg = reduced_config(arch) if reduced else get_config(arch)
    jcfg = jreduced(arch) if reduced else jget(arch)
    port = api.family_module(cfg).init(cfg, torch.Generator(), tp=tp,
                                       device=torch.device("meta"))
    ref = jax.eval_shape(lambda: japi.init(jcfg, jax.random.PRNGKey(0), tp=tp))
    return cfg, jcfg, port, ref


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, reduced):
    from repro.parallel import sharding as jshd

    cfg, jcfg, port, ref = _trees(arch, reduced)
    for fsdp in (False, True):
        got = _port_items(shd.param_pspecs(cfg, port, fsdp=fsdp))
        want = _ref_items(jshd.param_pspecs(jcfg, ref, fsdp=fsdp))
        assert got == want, (arch, fsdp)
        opt = _port_items(shd.opt_state_pspecs(cfg, port, fsdp=fsdp))
        assert opt == _ref_items(jshd.opt_state_pspecs(jcfg, ref, fsdp=fsdp))
    for shape in MESHES:
        pm, jm = _meshes(shape)
        got = _port_items(shd.param_pspecs(cfg, port, strategy="fsdp", mesh=pm))
        want = _ref_items(jshd.param_pspecs(jcfg, ref, strategy="fsdp", mesh=jm))
        assert got == want, (arch, shape)
        if "layers" in port and isinstance(port["layers"], dict):
            got = _port_items(shd.layer_slice_pspecs(cfg, port, strategy="fsdp", mesh=pm))
            want = _ref_items(jshd.layer_slice_pspecs(jcfg, ref, strategy="fsdp", mesh=jm))
            assert got == want, (arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    import jax
    from repro.configs import reduced_config as jreduced
    from repro.configs.base import ShapeConfig as JShape
    from repro.models import api as japi
    from repro.parallel import sharding as jshd

    cfg, jcfg = reduced_config(arch), jreduced(arch)
    for shape in ((2, 2), (2, 2, 2)):
        pm, jm = _meshes(shape)
        for kind in ("train", "prefill", "decode"):
            for batch in (1, 8):
                s, js = ShapeConfig("s", kind, 64, batch), JShape("s", kind, 64, batch)
                for strategy in ("tp", "fsdp"):
                    got = {k: tuple(v) for k, v in
                           shd.batch_pspecs(cfg, s, pm, strategy=strategy).items()}
                    want = {k: tuple(v) for k, v in
                            jshd.batch_pspecs(jcfg, js, jm, strategy=strategy).items()}
                    assert got == want, (arch, shape, kind, batch, strategy)
                if kind != "decode":
                    continue
                cache = api.family_module(cfg).init_cache(cfg, batch, 64, tp=2,
                                                          device=torch.device("meta"))
                jcache = jax.eval_shape(lambda: japi.init_cache(jcfg, batch, 64, tp=2))
                got = _port_items(shd.cache_pspecs(cfg, s, pm, cache))
                want = _ref_items(jshd.cache_pspecs(jcfg, js, jm, jcache))
                assert got == want, (arch, shape, batch)


def test_specs_print_like_partition_specs():
    from jax.sharding import PartitionSpec

    for spec in [(), ("model", None), (None, ("pod", "data"), None)]:
        assert repr(shd.P(*spec)) == repr(PartitionSpec(*spec))
    assert shd.spec_axes(shd.P(None, ("pod", "data"), "model")) == ("pod", "data", "model")
    assert shd.dp_axes(_meshes((2, 2, 2))[0]) == ("pod", "data")


def test_constraints_are_identity_in_eager_code():
    x = torch.randn(2, 3)
    assert shd.constrain_batch(x, None) is x
    lp = {"w": torch.randn(2, 2), "i": torch.arange(3)}
    assert shd.constrain_layer_params(lp) is lp
    # outside a sharded step that holds shards, as the reference's outside
    # its activation context: the params as they are, cast_to or not (the
    # layers cast each leaf at its use)
    assert shd.constrain_layer_params(lp, cast_to=torch.bfloat16) is lp


def _round_trip(arch):
    """On each rank: shard the full reduced tree by the tp and fsdp layouts,
    check each shard's shape, gather it back."""
    cfg = reduced_config(arch)
    mesh = Mesh((2, 2), ("data", "model"))
    full = api.init(cfg, torch.Generator().manual_seed(0), tp=2, device="cpu")
    out = {}
    for strategy in ("tp", "fsdp"):
        specs = shd.param_pspecs(cfg, full, strategy=strategy, mesh=mesh)
        local = shd.shard_tree(mesh, full, specs)
        back = shd.gather_tree(mesh, local, specs)
        shards = {}
        for name, spec in shd._spec_items(specs):
            want = list(dict(api._leaves(full))[name].shape)
            for dim, part in enumerate(spec):
                want[dim] //= mesh.size(part) if part is not None else 1
            assert list(dict(api._leaves(local))[name].shape) == want, (name, spec)
            shards[name] = dict(api._leaves(local))[name].numpy()
        out[strategy] = (all(torch.equal(a, b) for (_, a), (_, b)
                             in zip(api._leaves(back), api._leaves(full))), shards)
    placements = shd.to_named(mesh, shd.P(None, ("data", "model")))
    out["placements"] = [repr(p) for p in placements]
    return out


def test_shard_and_gather_round_trip_in_a_gloo_world():
    res = run_spmd(_round_trip, 4, device="cpu", args=("granite-moe-1b-a400m",), timeout=180)
    for r in res:
        assert r["tp"][0] and r["fsdp"][0]
        assert r["placements"] == ["Shard(dim=1)", "Shard(dim=1)"]
    # the experts' shards differ across model ranks, the norms' are replicated
    wg = "layers/experts/wg"
    assert not np.array_equal(res[0]["tp"][1][wg], res[1]["tp"][1][wg])
    np.testing.assert_array_equal(res[0]["tp"][1][wg], res[2]["tp"][1][wg])
    np.testing.assert_array_equal(res[0]["tp"][1]["ln_f/scale"], res[3]["tp"][1]["ln_f/scale"])
