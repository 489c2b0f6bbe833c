"""The port's pipeline schedule (``parallel/pipeline.py``) against the JAX
package, at the reference test's shapes (L 8, S 4, M 6, mb 2, D 16) on a
4-rank gloo world.

The forward equals the reference's ``pipeline_apply`` on 4 forced host
devices (a subprocess, 2e-5).  The reference's own gradient through
``pipeline_apply`` fails on this tree (``tests/test_pipeline.py``), so the
port's gradients (each stage's weights and the input) are held to
``jax.grad`` of the sequential ``ref_apply`` (5e-4), the reference test's
own contract.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.parallel import sharding as shd
from repro_torch.parallel import spmd
from repro_torch.parallel.pipeline import pipeline_apply, stage_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, S, M, MB, D = 8, 4, 6, 2, 16

ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.parallel.pipeline import pipeline_apply, stage_split

    path = sys.argv[1]
    data = dict(np.load(path))
    mesh = jax.make_mesh((4,), ("pod",))

    def stage_fn(params_stage, h):
        def body(carry, w):
            return jnp.tanh(carry @ w), None
        h, _ = jax.lax.scan(body, h, params_stage)
        return h

    out = pipeline_apply(stage_fn, stage_split(jnp.asarray(data["Ws"]), 4),
                         jnp.asarray(data["xs"]), mesh=mesh, axis="pod")
    np.save(path.replace("in.npz", "out.npy"), np.asarray(out))
    print("ORACLE_OK")
""")


def _inputs():
    rng = np.random.default_rng(0)
    return {"Ws": (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32),
            "xs": rng.standard_normal((M, MB, D)).astype(np.float32)}


def _stage_fn(params_stage, h):
    for w in params_stage:
        h = torch.tanh(h @ w)
    return h


def _pipeline_rank(data):
    mesh = spmd.Mesh((S,), ("pod",))
    stages = stage_split(torch.tensor(data["Ws"]), S)
    local = shd.shard_tree(mesh, {"w": stages}, {"w": shd.P("pod")})["w"].requires_grad_()
    xs = torch.tensor(data["xs"]).requires_grad_()
    out = pipeline_apply(_stage_fn, local, xs, mesh=mesh, axis="pod")
    torch.sum(torch.square(out)).backward()
    grads = shd.gather_tree(mesh, {"w": local.grad}, {"w": shd.P("pod")})["w"]
    return {"out": out.detach().numpy(), "grad_w": grads.reshape(L, D, D).numpy(),
            "grad_x": xs.grad.numpy(), "stage": mesh.axis_index("pod"),
            "counts": {k: dict(v) for k, v in spmd.collectives_by_route.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _inputs()
    path = str(tmp_path_factory.mktemp("pipeline") / "in.npz")
    np.savez(path, **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    oracle = subprocess.Popen([sys.executable, "-c", ORACLE, path], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    ranks = spmd.run_spmd(_pipeline_rank, S, device="cpu", args=(data,), timeout=300)
    stdout, stderr = oracle.communicate(timeout=300)
    assert oracle.returncode == 0 and "ORACLE_OK" in stdout, stdout + stderr
    return data, ranks, np.load(path.replace("in.npz", "out.npy"))


def _sequential(data):
    import jax
    import jax.numpy as jnp

    def ref_apply(Ws, xs):
        def all_layers(h):
            def body(carry, w):
                return jnp.tanh(carry @ w), None
            h, _ = jax.lax.scan(body, h, Ws)
            return h
        return jax.vmap(all_layers)(xs)

    loss = lambda Ws, xs: jnp.sum(jnp.square(ref_apply(Ws, xs)))  # noqa: E731
    gw, gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(data["Ws"]), jnp.asarray(data["xs"]))
    return np.asarray(ref_apply(data["Ws"], data["xs"])), np.asarray(gw), np.asarray(gx)


def test_forward_equals_the_reference_pipeline(runs):
    _, ranks, ref = runs
    assert [r["stage"] for r in ranks] == list(range(S))
    for r in ranks:         # replicated over the stages
        np.testing.assert_allclose(r["out"], ref, rtol=2e-5, atol=2e-5)


def test_gradients_equal_the_sequential_reference(runs):
    data, ranks, _ = runs
    out, gw, gx = _sequential(data)
    for r in ranks:
        np.testing.assert_allclose(r["out"], out, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["grad_w"], gw, rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(r["grad_x"], gx, rtol=5e-4, atol=5e-4)


def test_schedule_exchanges_one_slot_a_tick(runs):
    """M + S - 2 rotations forward and as many backward, one all-to-all each;
    one all-reduce for the outputs and one for the input's cotangent."""
    _, ranks, _ = runs
    for r in ranks:
        counts = r["counts"]["gloo"]
        assert counts["all_to_all"] == 2 * (M + S - 2)
        assert counts["all_reduce"] >= 2
