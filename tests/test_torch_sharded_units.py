"""Sharded offload units (``plan(mesh=, arg_specs=)``) against the JAX
package's sharded compile, on a 2-rank gloo world.

The reference compiles the same programs with ``mesh=jax.make_mesh((2,),
("data",))`` on 2 forced host devices (a subprocess, as
``tests/test_torch_moe_ep.py`` runs its oracle); the port runs one spawned
rank per device, every rank calling the same hybrid.  Two programs, the
SmolLM-shaped ``export_dense_forward`` (reduced, float32, from one set of
weights) and the attention decode LM, each under ``tech-gf`` and ``native``
without the host check (the entry is a unit: its argument is placed by
``arg_specs``) and ``tech-gfp`` with it (the entry stays on the guest, the
units' arguments are replicated), each with the batch split
(``P("data", None)``) and the sequence split (``P(None, "data")``).  Both
calls of each case match the reference's outputs at the engine's
2e-3/2e-4 on every rank, and their counters (crossings, reentries,
conversion builds, compiles, GRT hits, per-function crossings, coverage,
units) equal the reference's and the port's unsharded plan's exactly.  Also:
``HybridExecutor(mesh=, arg_specs=)``, ``for_entry`` (the mesh carries,
``arg_specs`` do not), ``save_aot``'s refusal, ``MixedServer`` and a
``DecodeScheduler`` on a sharded plan, and where the partitioner gathered.
"""
import json
import os
import subprocess
import sys
import textwrap
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch import mixed as tmixed
from repro_torch.configs import reduced_config
from repro_torch.core import HybridExecutor
from repro_torch.core.convert import aval_of
from repro_torch.models import api
from repro_torch.models.programs import export_attn_decode_lm, export_dense_forward
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import P
from repro_torch.serve import DecodeScheduler, MixedServer
from repro_torch.serve.aot import AotError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("guest_to_host", "host_to_guest", "conversion_builds", "compiles", "grt_hits",
            "guest_calls", "guest_ops", "nested_crossings", "max_reentry_depth",
            "max_interleave_depth")
SPECS = {"batch": (P("data", None),), "seq": (P(None, "data"),)}
# (program, scheme, with the host check)
PLANS = [("dense", "tech-gf", False), ("dense", "native", False), ("dense", "tech-gfp", True),
         ("attn", "tech-gf", False), ("attn", "native", False), ("attn", "tech-gfp", True)]
CASES = [(prog, scheme, check, spec) for prog, scheme, check in PLANS for spec in SPECS]
DENSE_B, DENSE_T = 2, 16
VOCAB, DM, CTX, ATTN_B, ATTN_T = 32, 16, 24, 4, 6
TP = 2


def _case_id(case):
    prog, scheme, check, spec = case
    return f"{prog}-{scheme}{'-check' if check else ''}-{spec}"


def _dense_weights():
    """The reduced SmolLM's float32 weights as nested numpy dicts (the
    port's init, seed 0), which both packages export."""
    cfg = reduced_config("smollm-360m")
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device="cpu")
    return {name: t.numpy() for name, t in api._leaves(params)}


def _nested(flat):
    out = {}
    for name, value in flat.items():
        *path, last = name.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = value
    return out


def _tokens(prog):
    rng = np.random.default_rng(1)
    if prog == "dense":
        return rng.integers(0, reduced_config("smollm-360m").vocab, (DENSE_B, DENSE_T),
                            dtype=np.int32)
    return rng.integers(0, VOCAB, (ATTN_B, ATTN_T), dtype=np.int32)


def _program(prog, check, weights):
    if prog == "dense":
        cfg = reduced_config("smollm-360m")
        params = _nested({k: torch.from_numpy(v) for k, v in weights.items()})
        return export_dense_forward(cfg, params, DENSE_B, DENSE_T,
                                    with_host_check=check, tp=TP)[0]
    return export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=CTX,
                                 with_host_check=check)


ORACLE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import numpy as np
    import jax
    from jax.sharding import PartitionSpec as P
    from repro import mixed
    from repro.configs import reduced_config
    from repro.models.programs import export_attn_decode_lm, export_dense_forward

    path = sys.argv[1]
    weights = dict(np.load(path))
    cases = json.loads(open(path.replace("in.npz", "cases.json")).read())
    nested = {}
    for name, value in weights.items():
        if name.startswith("tokens/"):
            continue
        *parts, last = name.split("/")
        node = nested
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = value
    # Auto axes: GSPMD propagates the entry's sharding, as the reference
    # engine was written for (an Explicit mesh refuses its embedding gather)
    mesh = jax.make_mesh((2,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    specs = {"batch": (P("data", None),), "seq": (P(None, "data"),)}
    counters = %r
    outs, reports = {}, {}
    for prog, scheme, check, spec in cases:
        if prog == "dense":
            program = export_dense_forward(reduced_config("smollm-360m"), nested, %d, %d,
                                           with_host_check=check, tp=%d)[0]
        else:
            program = export_attn_decode_lm(vocab=%d, d_model=%d, max_context=%d,
                                            with_host_check=check)
        h = mixed.trace(program).plan(scheme, mesh=mesh, arg_specs=specs[spec]).compile()
        key = f"{prog}/{scheme}/{check}/{spec}"
        reports[key] = []
        for i in range(2):
            o, r = h.call_reported(weights["tokens/" + prog])
            for j, a in enumerate(o):
                outs[f"{key}/{i}/{j}"] = np.asarray(a)
            plan = h.plan_for(weights["tokens/" + prog])
            reports[key].append({
                **{c: getattr(r, c) for c in counters},
                "per_function": dict(r.per_function_crossings),
                "coverage": plan.coverage.as_dict(), "units": sorted(plan.units)})
    np.savez(path.replace("in.npz", "out.npz"), **outs)
    open(path.replace("in.npz", "reports.json"), "w").write(json.dumps(reports))
    print("ORACLE_OK")
""") % (COUNTERS, DENSE_B, DENSE_T, TP, VOCAB, DM, CTX)


def _report(rep, plan):
    return {**{c: getattr(rep, c) for c in COUNTERS},
            "per_function": dict(rep.per_function_crossings),
            "coverage": plan.coverage.as_dict(), "units": sorted(plan.units)}


def _unsharded(weights):
    """The port's unsharded plans: both calls' outputs and reports."""
    out = {}
    for prog, scheme, check in PLANS:
        h = tmixed.trace(_program(prog, check, weights)).plan(scheme).compile(backend="cpu")
        tokens = _tokens(prog)
        calls = [h.call_reported(tokens) for _ in range(2)]
        out[(prog, scheme, check)] = [(o, _report(r, h.plan_for(tokens))) for o, r in calls]
    return out


def _serving_rank(mesh, weights):
    """``MixedServer`` and ``DecodeScheduler`` on sharded plans."""
    out = {}
    dense = _program("dense", True, weights)
    planned = tmixed.trace(dense).plan("tech-gfp", mesh=mesh, arg_specs=SPECS["seq"])
    direct = planned.compile(backend="cpu")
    row = _tokens("dense")[:1]
    server = MixedServer(planned, backend="cpu", workers=1)
    try:
        out["warmed"] = server.warm(row)
        out["fallback"] = (server._fallback.planned.mesh is mesh,
                           server._fallback.planned.arg_specs)
        got = [server.request(_tokens("dense")[i:i + 1], timeout=120)[0] for i in range(2)]
    finally:
        server.close()
    out["served"] = [(g, direct(_tokens("dense")[i:i + 1])[0]) for i, g in enumerate(got)]

    attn = tmixed.trace(_program("attn", True, weights)).plan(
        "tech-gfp", mesh=mesh, arg_specs=SPECS["batch"])
    out["tokens"], out["decode_report"] = _decode(attn)
    return out


def _decode(planned):
    sched = DecodeScheduler(planned, step="decode_step", capacity=ATTN_B, backend="cpu",
                            start=False)
    try:
        prompts = _tokens("attn")
        streams = [sched.submit(p, max_new_tokens=5) for p in prompts]
        sched.start()
        tokens = [np.asarray(s.result(timeout=120)) for s in streams]
        report = sched.report()
    finally:
        sched.close()
    keys = ("streams", "tokens", "steps", "prefills", "crossings", "live_rows", "slot_rows")
    return tokens, {k: getattr(report, k) for k in keys}


def _rank(weights):
    from repro_torch.parallel import units

    mesh = spmd.Mesh((2,), ("data",))
    out = {"cases": {}, "redistributions": {}}
    for prog, scheme, check, spec in CASES:
        h = tmixed.trace(_program(prog, check, weights)).plan(
            scheme, mesh=mesh, arg_specs=SPECS[spec]).compile(backend="cpu")
        tokens = _tokens(prog)
        units.redistributions_by_op.clear()
        calls = []
        for _ in range(2):
            o, r = h.call_reported(tokens)
            calls.append((o, _report(r, h.plan_for(tokens))))
        out["cases"][(prog, scheme, check, spec)] = calls
        out["redistributions"][(prog, scheme, check, spec)] = dict(units.redistributions_by_op)
    prog = _program("dense", False, weights)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ex = HybridExecutor(prog, "tech-gf", entry_avals=[aval_of(_tokens("dense"))],
                            mesh=mesh, arg_specs=SPECS["batch"], backend="cpu")
    out["executor"] = (ex(_tokens("dense"))[0], ex.compiled.planned.mesh is mesh,
                       ex.compiled.planned.arg_specs)
    out.update(_serving_rank(mesh, weights))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    weights = _dense_weights()
    path = str(tmp_path_factory.mktemp("sharded_units") / "in.npz")
    np.savez(path, **weights, **{f"tokens/{p}": _tokens(p) for p in ("dense", "attn")})
    with open(path.replace("in.npz", "cases.json"), "w") as f:
        json.dump(CASES, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    oracle = subprocess.Popen([sys.executable, "-c", ORACLE, path], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    ranks = spmd.run_spmd(_rank, 2, device="cpu", args=(weights,), timeout=300)
    unsharded = _unsharded(weights)
    stdout, stderr = oracle.communicate(timeout=300)
    assert oracle.returncode == 0 and "ORACLE_OK" in stdout, stdout + stderr
    ref = dict(np.load(path.replace("in.npz", "out.npz")))
    with open(path.replace("in.npz", "reports.json")) as f:
        reports = json.load(f)
    return weights, ranks, unsharded, ref, reports


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_units_match_the_reference(runs, case):
    _, ranks, _, ref, reports = runs
    prog, scheme, check, spec = case
    key = f"{prog}/{scheme}/{check}/{spec}"
    for r in ranks:
        for i, (outs, report) in enumerate(r["cases"][case]):
            for j, o in enumerate(outs):
                want = ref[f"{key}/{i}/{j}"]
                assert o.dtype == want.dtype and o.shape == want.shape
                np.testing.assert_allclose(o, want, rtol=2e-3, atol=2e-4)
            want = reports[key][i]
            for c in COUNTERS:
                assert report[c] == want[c], (c, report[c], want[c])
            assert report["per_function"] == want["per_function"]
            assert report["coverage"] == want["coverage"]
            assert report["units"] == want["units"]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_counters_equal_the_unsharded_plan(runs, case):
    _, ranks, unsharded, _, _ = runs
    prog, scheme, check, _ = case
    for r in ranks:
        for (outs, report), (want_outs, want) in zip(r["cases"][case],
                                                    unsharded[(prog, scheme, check)]):
            assert report == want
            for o, w in zip(outs, want_outs):
                np.testing.assert_allclose(o, w, rtol=2e-3, atol=2e-4)


# the collectives each op's redistributions issued over the case's two
# calls, where the entry unit's argument is placed by its spec
GATHERS = {("dense", "batch"): {}, ("dense", "seq"): {"sdpa": 12},
           ("attn", "batch"): {}, ("attn", "seq"): {"sdpa": 6, "eq": 2, "pad_to": 6}}


def test_where_the_partitioner_gathers(runs):
    """The batch split runs every op of both programs on the rank's rows
    (the flash-attention rule is local over the batch, and the attention
    LM's ``pad_to`` joins its zero tail to the rank's rows).  The sequence
    split keeps the token ids split through ``embed`` (a lookup in the
    replicated table) and the ops after it on the rank's positions, up to
    the attention, which needs every key: ``sdpa`` gathers q, k and v; in
    the attention LM also ``pad_to``, which pads the split axis, and ``eq``
    the lengths it summed over the split sequence.  A plan whose entry stays
    on the guest (``tech-gfp`` with the host check) places nothing by its
    specs, so no op gathers."""
    _, ranks, _, _, _ = runs
    for r in ranks:
        for (prog, scheme, check, spec), counts in r["redistributions"].items():
            ops = {k: v for k, v in counts.items() if k != "<outputs>"}
            assert ops == ({} if check else GATHERS[(prog, spec)]), (prog, scheme, spec, ops)


def test_hybrid_executor_plans_sharded_units(runs):
    _, ranks, unsharded, _, _ = runs
    want = unsharded[("dense", "tech-gf", False)][0][0][0]
    for r in ranks:
        out, same_mesh, specs = r["executor"]
        assert same_mesh and specs == SPECS["batch"]
        np.testing.assert_allclose(out, want, rtol=2e-3, atol=2e-4)


def test_mixed_server_serves_a_sharded_plan(runs):
    """The fallback plan carries the mesh and the specs, as the reference's
    does; every warm response equals the sharded plan called directly."""
    _, ranks, _, _, _ = runs
    for r in ranks:
        assert r["warmed"] >= 1
        assert r["fallback"] == (True, SPECS["seq"])
        for got, direct in r["served"]:
            np.testing.assert_array_equal(got, direct)


def test_decode_scheduler_on_a_sharded_plan_equals_unsharded(runs):
    weights, ranks, _, _, _ = runs
    planned = tmixed.trace(_program("attn", True, weights)).plan("tech-gfp")
    tokens, report = _decode(planned)
    for r in ranks:
        assert r["decode_report"] == report
        for got, want in zip(r["tokens"], tokens):
            np.testing.assert_array_equal(got, want)


def test_for_entry_keeps_the_mesh_and_drops_arg_specs():
    mesh = types.SimpleNamespace(shape={"data": 2}, axis_names=("data",))
    planned = tmixed.trace(export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=CTX)).plan(
        "tech-gfp", mesh=mesh, arg_specs=SPECS["batch"])
    assert planned.mesh is mesh and planned.arg_specs == SPECS["batch"]
    step = planned.for_entry("decode_step")
    assert step.mesh is mesh and step.arg_specs is None
    assert step.unit_cache is planned.unit_cache


@pytest.mark.parametrize("kw", [{"mesh": "mesh"}, {"arg_specs": (None,)}],
                         ids=["mesh", "arg_specs"])
def test_save_aot_refuses_a_sharded_plan(tmp_path, kw):
    if "mesh" in kw:
        kw = {"mesh": types.SimpleNamespace(shape={"data": 2}, axis_names=("data",))}
    planned = tmixed.trace(export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=CTX)).plan(
        "tech-gfp", **kw)
    with pytest.raises(AotError, match="mesh/arg_specs"):
        planned.save_aot(tmp_path / "cache")
