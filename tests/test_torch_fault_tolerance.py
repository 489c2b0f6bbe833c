"""The port's fault tolerance (``runtime/fault_tolerance.py``): the
counterparts of ``tests/test_fault_tolerance.py``'s six tests, with
``compressed_psum`` on a 4-rank gloo world held against the JAX package's
``shard_map`` result on 4 forced host devices (a subprocess), and the
production mesh plan (``launch/mesh.py``)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_production_mesh, production_plan
from repro_torch.parallel import spmd
from repro_torch.runtime.fault_tolerance import (
    HeartbeatRegistry,
    MeshPlan,
    StragglerPolicy,
    build_mesh,
    compressed_psum,
    dequantize_int8,
    plan_elastic_mesh,
    quantize_int8,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEV = 4

ORACLE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.runtime.fault_tolerance import compressed_psum

    path = sys.argv[1]
    g = np.load(path)

    def shard_fn(g):
        out, err = compressed_psum({"g": g}, "dp", None)
        return out["g"], err["g"]

    out, err = jax.jit(shard_map(shard_fn, mesh=jax.make_mesh((4,), ("dp",)),
                                 in_specs=P("dp"), out_specs=(P("dp"), P("dp"))))(
        jnp.asarray(g))
    np.savez(path.replace("in.npy", "out.npz"), out=np.asarray(out), err=np.asarray(err))
    print("ORACLE_OK")
""")


def test_heartbeat_failure_detection():
    hb = HeartbeatRegistry(deadline_s=10.0)
    for h in range(4):
        hb.beat(h, now=0.0)
    hb.beat(0, now=8.0)
    hb.beat(1, now=9.0)
    assert hb.dead_hosts(now=12.0) == [2, 3]
    assert hb.alive_hosts(now=12.0) == [0, 1]


def test_straggler_policy_flags_persistent_slowness():
    sp = StragglerPolicy(threshold=1.5, window=4)
    for step in range(6):
        for h in range(8):
            sp.record_step(h, 1.0 if h != 5 else 2.5)
    assert sp.stragglers() == [5]
    sp2 = StragglerPolicy(threshold=1.5, window=4)
    for step in range(6):
        for h in range(8):
            slow = h == 5 and step == 2
            sp2.record_step(h, 2.5 if slow else 1.0)
    assert sp2.stragglers() == []


def test_elastic_mesh_plans():
    p = plan_elastic_mesh(512, model_parallel=16, pods=2)
    assert p.shape == (2, 16, 16)
    p = plan_elastic_mesh(448, model_parallel=16)
    assert p.shape == (28, 16) and p.n_devices == 448
    p = plan_elastic_mesh(450, model_parallel=16)
    assert p.shape == (28, 16)
    with pytest.raises(ValueError):
        plan_elastic_mesh(8, model_parallel=16)
    assert production_plan() == MeshPlan((16, 16), ("data", "model"))
    assert production_plan(multi_pod=True) == MeshPlan((2, 16, 16), ("pod", "data", "model"))


def test_int8_quantization_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal(1000), dtype=torch.float32)
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8
    err = (dequantize_int8(q, s) - x).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-6


def _world_rank(g_host):
    """One rank of a 4-rank world: the elastic meshes it can and cannot
    build, then compressed_psum of its row, once and over 16 steps of error
    feedback."""
    out = {}
    mesh = build_mesh(plan_elastic_mesh(N_DEV, model_parallel=1))
    out["mesh"] = dict(mesh.shape)
    out["tp_mesh"] = dict(build_mesh(plan_elastic_mesh(N_DEV, model_parallel=2)).shape)
    for bad in (MeshPlan((2, 4), ("data", "model")), MeshPlan((1, 2), ("data", "model"))):
        try:
            build_mesh(bad)
            out[f"refused {bad.shape}"] = False
        except ValueError:
            out[f"refused {bad.shape}"] = True
    try:
        make_production_mesh()
        out["production refused"] = False
    except ValueError:
        out["production refused"] = True
    dp = spmd.Mesh((N_DEV,), ("dp",))
    g = torch.tensor(g_host[torch.distributed.get_rank()])
    with dp:
        got, err = compressed_psum({"g": g}, "dp", None)
        out["once"], out["err"] = got["g"].numpy(), err["g"].numpy()
        total, error = torch.zeros_like(g), None
        for _ in range(16):
            step, error = compressed_psum({"g": g}, "dp", error)
            total += step["g"]
        out["mean_of_16"] = (total / 16).numpy()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    g_host = np.random.default_rng(1).standard_normal((N_DEV, 64)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("ft") / "in.npy")
    np.save(path, g_host)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    oracle = subprocess.Popen([sys.executable, "-c", ORACLE, path], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    ranks = spmd.run_spmd(_world_rank, N_DEV, device="cpu", args=(g_host,), timeout=300)
    stdout, stderr = oracle.communicate(timeout=300)
    assert oracle.returncode == 0 and "ORACLE_OK" in stdout, stdout + stderr
    return g_host, ranks, dict(np.load(path.replace("in.npy", "out.npz")))


def test_elastic_remesh_on_the_world(world):
    _, ranks, _ = world
    for r in ranks:
        assert r["mesh"] == {"data": 4, "model": 1}
        assert r["tp_mesh"] == {"data": 2, "model": 2}
        assert r["refused (2, 4)"] and r["refused (1, 2)"] and r["production refused"]


def test_compressed_psum_error_feedback_converges(world):
    """Mean of compressed psum over ranks ≈ true mean, equal to the JAX
    package's shard_map result; error feedback keeps the bias bounded over
    repeated steps."""
    g_host, ranks, ref = world
    true_mean = g_host.mean(axis=0)
    scale = np.abs(g_host).max() / 127.0
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank["once"], true_mean, atol=scale * 2 + 1e-5)
        np.testing.assert_allclose(rank["once"], ref["out"].reshape(N_DEV, 64)[r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rank["err"], ref["err"].reshape(N_DEV, 64)[r],
                                   rtol=1e-6, atol=1e-6)
        # the residual fed back: 16 steps average out to within 1/16 of a
        # quantization step per rank
        np.testing.assert_allclose(rank["mean_of_16"], true_mean, atol=scale * 2 / 16 + 1e-5)
