"""The paper's 17 workloads and the library apps: the port against the JAX
package, scheme by scheme.

Every workload runs at test scale through ``trace → plan → compile`` in both
packages under all six schemes, two calls each (a cold call, then a warm
one).  Where the reference refuses ``native`` (host-only ops), the port
refuses with the same error; otherwise outputs agree to the engine
tolerance (2e-3/2e-4, as ``tests/test_core_engine.py``) with equal dtypes —
``sgefa`` under ``tech-gfp`` returns float32 where the numpy guest returns
float64, in both — and the framework-free counters (crossings both ways,
conversion builds, compiles, GRT hits) and the coverage are equal.

``src/repro_torch/workloads/reference_counters.json`` holds the same
records for the JAX package at bench scale (the card's machine has no JAX;
``chip_smoke.py`` holds the card's run against it).  One test recomputes
it; regenerate it with ``PYTHONPATH=src python tests/test_torch_workloads.py``.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from repro import mixed as jmixed
from repro.core import NativeInfeasibleError as JNativeInfeasible
from repro.workloads import WORKLOADS as JWORKLOADS
from repro.workloads.libs import build_library_app as jbuild_app
from repro.workloads.libs import library_unit_filter as jfilter
from repro_torch.bench.common import SCHEMES, SchemeRun, run_compiled, sweep_schemes
from repro_torch.bench.table3_library import APPS, LIB_SETS
from repro_torch.workloads import WORKLOADS as TWORKLOADS
from repro_torch.workloads.libs import build_library_app as tbuild_app
from repro_torch.workloads.libs import library_unit_filter as tfilter

RTOL, ATOL = 2e-3, 2e-4
REFERENCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "workloads"
             / "reference_counters.json")
# the workloads with host-only ops: complete cross-compilation refuses them
NATIVE_INFEASIBLE = ["cjson", "lua", "matpowsum", "npbep", "npbsp", "obsequi", "sgefa"]


def jax_sweep(prog, args, schemes=SCHEMES, **plan_kw) -> dict[str, SchemeRun]:
    """The JAX package's runs in the port's record format: a cold call and
    one warm call per scheme."""
    out = {}
    for scheme in schemes:
        try:
            hybrid = jmixed.trace(prog).plan(scheme, **plan_kw).compile()
        except JNativeInfeasible as e:
            out[scheme] = SchemeRun(infeasible=e)
            continue
        out[scheme] = run_compiled(hybrid, args, repeats=1)
    return out


def assert_runs_match(jruns: dict, truns: dict, what: str) -> None:
    assert list(jruns) == list(truns)
    for scheme, j in jruns.items():
        t = truns[scheme]
        assert t.record() == j.record(), (what, scheme)
        if j.infeasible is not None:
            continue
        for a, b in zip(j.outputs, t.outputs):
            np.testing.assert_allclose(b, np.asarray(a), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} under {scheme}")


@pytest.mark.parametrize("name", sorted(TWORKLOADS))
def test_workload_matches_reference(name):
    jprog, jargs = JWORKLOADS[name].build("test")
    tprog, targs = TWORKLOADS[name].build("test")
    for a, b in zip(jargs, targs):
        assert np.array_equal(a, b)
    assert TWORKLOADS[name].has_host_ops == JWORKLOADS[name].has_host_ops
    jruns = jax_sweep(jprog, jargs)
    truns = sweep_schemes(tprog, targs, repeats=1, device="cpu")
    assert_runs_match(jruns, truns, name)
    # every scheme agrees with pure interpretation, in the port alone too
    for scheme, run in truns.items():
        if run.infeasible is None:
            for a, b in zip(truns["qemu"].outputs, run.outputs):
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_native_infeasible_set():
    port = sorted(n for n, s in TWORKLOADS.items() if s.has_host_ops)
    ref = sorted(n for n, s in JWORKLOADS.items() if s.has_host_ops)
    assert port == ref == NATIVE_INFEASIBLE


def test_sgefa_keeps_the_reference_dtype():
    prog, args = TWORKLOADS["sgefa"].build("test")
    runs = sweep_schemes(prog, args, schemes=["qemu", "tech-gfp"], repeats=0,
                         device="cpu")
    assert runs["qemu"].outputs[0].dtype == np.float64      # the numpy guest
    assert runs["tech-gfp"].outputs[0].dtype == np.float32  # x64-off units


@pytest.mark.parametrize("app", APPS)
def test_library_app_matches_reference(app):
    jprog, jargs = jbuild_app(app, "test")
    tprog, targs = tbuild_app(app, "test")
    for lib, prefixes in LIB_SETS.items():
        jruns = jax_sweep(jprog, jargs, ["tech-gfp"], unit_filter=jfilter(prefixes))
        truns = sweep_schemes(tprog, targs, schemes=["tech-gfp"], repeats=1,
                              device="cpu", unit_filter=tfilter(prefixes))
        assert_runs_match(jruns, truns, f"{app}/{lib}")
        assert all(u.startswith(prefixes) for u in truns["tech-gfp"].hybrid.last_plan.units)


def reference_records(scale: str = "bench") -> dict:
    """The JAX package's records at ``scale``: what the JSON file holds."""
    workloads = {}
    for name in sorted(JWORKLOADS):
        prog, args = JWORKLOADS[name].build(scale)
        workloads[name] = {s: r.record() for s, r in jax_sweep(prog, args).items()}
    table3 = {}
    for app in APPS:
        prog, args = jbuild_app(app, scale)
        table3[app] = {
            lib: jax_sweep(prog, args, ["tech-gfp"],
                           unit_filter=jfilter(prefixes))["tech-gfp"].record()
            for lib, prefixes in LIB_SETS.items()}
    return {
        "_comment": "The JAX package's counters at bench scale: per workload and "
                    "scheme a cold call ('first') and a warm call ('steady'), the "
                    "coverage, the number of offloaded units and each output's "
                    "dtype and shape; table 3's apps under tech-gfp with each "
                    "library set offloaded. Written by tests/test_torch_workloads.py.",
        "scale": scale,
        "native_infeasible": sorted(n for n, runs in workloads.items()
                                    if runs["native"].get("infeasible")),
        "workloads": workloads,
        "table3": table3,
    }


def test_reference_counters_file_is_current():
    assert json.loads(REFERENCE.read_text()) == reference_records("bench")


if __name__ == "__main__":
    REFERENCE.write_text(json.dumps(reference_records("bench"), indent=1) + "\n")
    print(f"wrote {REFERENCE}")
