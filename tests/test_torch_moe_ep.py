"""The port's expert-parallel MoE (``models/moe.py:moe_block_ep``) against
the JAX package's, on a 4-rank (data 2, model 2) gloo world.

The reference runs ``moe_block_ep`` under ``jax.jit`` on 4 forced host
devices (a subprocess, as ``tests/test_moe_ep.py`` does); the port runs one
spawned rank per mesh position, each holding its batch slice and its shards
of the experts (``P(model, data, None)`` for ``wg``/``wu``, ``P(model, None,
data)`` for ``wd``).  The same numpy inputs go to both.  Capacity factors
8.0 (nothing dropped) and 1.25 (per-sender drops), token dims replicated
(``seq_axis=None``) and sharded (``"model"``, the prefill layout), float32
at the reference's own 2e-4.  At 8.0 the layer's gradients (x, the router,
every expert shard) equal the port's one-rank ``moe_block``'s, within
2e-4, and the drops counted at 1.25 are per sender.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import spmd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
CAPS = (8.0, 1.25)
LAYOUTS = (None, "model")
E, K, F = 4, 2, 32
B, T = 4, 32

ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config
    from repro.configs.base import MoEConfig
    from repro.models.moe import moe_block_ep

    path = sys.argv[1]
    data = dict(np.load(path))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    lp = {"router": jnp.asarray(data["router"]),
          "experts": {k: jnp.asarray(data[k]) for k in ("wg", "wu", "wd")}}
    x = jnp.asarray(data["x"])
    out = {}
    for cap in (8.0, 1.25):
        cfg = dataclasses.replace(
            reduced_config("dbrx-132b"), compute_dtype="float32",
            moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32, capacity_factor=cap))
        for seq in (None, "model"):
            with mesh:
                y = jax.jit(lambda x: moe_block_ep(cfg, lp, x, mesh, batch_axes="data",
                                                   seq_axis=seq))(x)
            out[f"{cap}/{seq}"] = np.asarray(y)
    np.savez(path.replace("in.npz", "out.npz"), **out)
    print("ORACLE_OK")
""")


def _cfg(cap):
    return dataclasses.replace(
        reduced_config("dbrx-132b"), compute_dtype="float32",
        moe=MoEConfig(num_experts=E, top_k=K, d_ff_expert=F, capacity_factor=cap))


def _inputs():
    D = reduced_config("dbrx-132b").d_model
    rng = np.random.default_rng(0)
    f32 = np.float32
    # a shared direction u in every token that the router maps to expert 0,
    # so expert 0 overflows at capacity 1.25
    u = rng.standard_normal(D)
    u /= np.linalg.norm(u)
    router = rng.standard_normal((D, E)) * 0.02
    router[:, 0] += 2.0 * u
    return {"router": router.astype(f32),
            "wg": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(f32),
            "wu": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(f32),
            "wd": (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(f32),
            "x": (rng.standard_normal((B, T, D)) + 2.0 * u).astype(f32),
            "ct": rng.standard_normal((B, T, D)).astype(f32)}


SPECS = {"router": shd.P(None, None), "wg": shd.P("model", "data", None),
         "wu": shd.P("model", "data", None), "wd": shd.P("model", None, "data")}


def _ep_rank(data):
    """One rank of the (2, 2) world: every (capacity, layout) forward, the
    drops counted per sender at 1.25, and the gradients at 8.0."""
    mesh = spmd.Mesh((2, 2), ("data", "model"))
    full = {k: torch.tensor(v) for k, v in data.items()}
    local = shd.shard_tree(mesh, {k: full[k] for k in SPECS}, SPECS)
    x = shd.shard_tree(mesh, {"x": full["x"], "ct": full["ct"]},
                       {"x": shd.P("data", None, None), "ct": shd.P("data", None, None)})
    out = {}
    for cap in CAPS:
        for seq in LAYOUTS:
            lp = {"router": local["router"], "experts": {k: local[k] for k in ("wg", "wu", "wd")}}
            kept = []
            real_route = moe.route

            def spy(cfg, lp_, xf):
                res = real_route(cfg, lp_, xf)
                kept.append(int(res[3].sum()))
                return res

            moe.route = spy
            try:
                y = moe.moe_block_ep(_cfg(cap), lp, x["x"], mesh, seq_axis=seq)
            finally:
                moe.route = real_route
            full_y = shd.gather_tree(mesh, {"y": y.detach()}, {"y": shd.P("data", None, None)})
            out[f"{cap}/{seq}"] = full_y["y"].numpy()
            out[f"kept {cap}/{seq}"] = kept[0]
    # gradients at capacity 8.0, tokens replicated over model
    leaves = {k: v.clone().requires_grad_() for k, v in local.items()}
    xl = x["x"].clone().requires_grad_()
    lp = {"router": leaves["router"], "experts": {k: leaves[k] for k in ("wg", "wu", "wd")}}
    y = moe.moe_block_ep(_cfg(8.0), lp, xl, mesh)
    (y * x["ct"]).sum().backward()
    with mesh:
        router = spmd.psum(leaves["router"].grad, "data")   # replicated over data
    grads = shd.gather_tree(mesh, {k: leaves[k].grad for k in ("wg", "wu", "wd")},
                            {k: SPECS[k] for k in ("wg", "wu", "wd")})
    grads["router"] = router
    grads["x"] = shd.gather_tree(mesh, {"x": xl.grad}, {"x": shd.P("data", None, None)})["x"]
    out["grads"] = {k: v.numpy() for k, v in grads.items()}
    out["counts"] = {k: dict(v) for k, v in spmd.collectives_by_route.items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _inputs()
    path = str(tmp_path_factory.mktemp("moe_ep") / "in.npz")
    np.savez(path, **{k: v for k, v in data.items() if k != "ct"})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    oracle = subprocess.Popen([sys.executable, "-c", ORACLE, path], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    ranks = spmd.run_spmd(_ep_rank, 4, device="cpu", args=(data,), timeout=300)
    stdout, stderr = oracle.communicate(timeout=300)
    assert oracle.returncode == 0 and "ORACLE_OK" in stdout, stdout + stderr
    return data, ranks, dict(np.load(path.replace("in.npz", "out.npz")))


@pytest.mark.parametrize("seq", LAYOUTS, ids=["tokens-replicated", "seq-sharded"])
@pytest.mark.parametrize("cap", CAPS)
def test_ep_equals_the_reference(runs, cap, seq):
    _, ranks, ref = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"{cap}/{seq}"], ref[f"{cap}/{seq}"], rtol=TOL, atol=TOL)


def test_ep_at_high_capacity_equals_one_rank_moe_block(runs):
    data, ranks, _ = runs
    cfg = _cfg(8.0)
    leaves = {k: torch.tensor(data[k]).requires_grad_() for k in SPECS}
    x = torch.tensor(data["x"]).requires_grad_()
    lp = {"router": leaves["router"], "experts": {k: leaves[k] for k in ("wg", "wu", "wd")}}
    y = moe.moe_block(cfg, lp, x)
    np.testing.assert_allclose(ranks[0]["8.0/None"], y.detach().numpy(), rtol=TOL, atol=TOL)
    (y * torch.tensor(data["ct"])).sum().backward()
    want = {k: v.grad.numpy() for k, v in leaves.items()} | {"x": x.grad.numpy()}
    for r in ranks:
        for k, w in want.items():
            np.testing.assert_allclose(r["grads"][k], w, rtol=TOL, atol=TOL, err_msg=k)


def test_low_capacity_drops_are_per_sender(runs):
    """Each rank routes its own tokens with ``_capacity(cfg, N_local)``:
    at 1.25 some pairs drop, at 8.0 none do."""
    _, ranks, _ = runs
    n_local = {None: B // 2 * T, "model": B // 2 * T // 2}
    for seq, n in n_local.items():
        kept = [r[f"kept 1.25/{seq}"] for r in ranks]
        assert all(k < n * K for k in kept), kept
        assert all(r[f"kept 8.0/{seq}"] == n * K for r in ranks)
    assert set(ranks[0]["counts"]) == {"gloo"}
    assert ranks[0]["counts"]["gloo"]["all_to_all"] > 0
