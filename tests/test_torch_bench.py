"""The port's paper-figure harness (``repro_torch.bench``) on the CPU at test
scale: every section runs and gives the rows the reference's harness gives;
fig. 7's programs match the JAX package's (same weights) scheme by scheme;
the profile-guided cost model keeps its structure; the harness refuses to
run without a card unless asked for the CPU.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro_torch.bench import (
    beyond_profile,
    crossing_cost,
    fig4_speedup,
    fig5_invocations,
    fig6_coverage,
    fig7_reverse,
    run,
    table3_library,
)
from repro_torch.bench.common import (
    SCHEMES,
    SchemeRun,
    csv_row,
    geomean,
    run_compiled,
    sweep_schemes,
    sweep_workloads,
)
from repro_torch.models.programs import load_reference_constants
from repro_torch.workloads import WORKLOADS

RTOL, ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module")
def sweep():
    return sweep_workloads("test", device="cpu", repeats=1)


def _derived(row: str) -> dict:
    return dict(kv.split("=", 1) for kv in row.split(",", 2)[2].split(";") if "=" in kv)


def test_fig4_rows(sweep):
    rows = fig4_speedup.rows(sweep)
    assert len(rows) == 17 * 6 + 4 + 1
    for name, runs in sweep.items():
        row = next(r for r in rows if r.startswith(f"fig4/{name}/native,"))
        if WORKLOADS[name].has_host_ops:
            assert "native_infeasible" in row and runs["native"].infeasible is not None
        else:
            assert float(_derived(row)["speedup_vs_qemu"]) > 0
        qemu = next(r for r in rows if r.startswith(f"fig4/{name}/qemu,"))
        assert _derived(qemu)["speedup_vs_qemu"] == "1.000"
    for scheme in SCHEMES[2:]:
        row = next(r for r in rows if r.startswith(f"fig4/geomean/{scheme},"))
        want = geomean([sweep[n]["qemu"].seconds / sweep[n][scheme].seconds for n in sweep])
        assert float(_derived(row)["geomean_speedup"]) == pytest.approx(want, abs=1e-3)


def test_fig5_rows_carry_the_steady_counters(sweep):
    rows = fig5_invocations.rows(sweep)
    assert len(rows) == 17 * len(fig5_invocations.COUNT_SCHEMES)
    for row in rows:
        _, name, scheme = row.split(",")[0].split("/")
        rep = sweep[name][scheme].steady
        d = _derived(row)
        assert (int(d["g2h"]), int(d["h2g"]), int(d["nested"])) == (
            rep.guest_to_host, rep.host_to_guest, rep.nested_crossings)
    # GRT leaves the counts alone; FCP never adds crossings
    for name, runs in sweep.items():
        g2h = {s: runs[s].steady.guest_to_host for s in fig5_invocations.COUNT_SCHEMES}
        assert g2h["tech"] == g2h["tech-g"] >= g2h["tech-gf"], (name, g2h)


def test_fig6_rows(sweep):
    rows = fig6_coverage.rows(sweep)
    assert len(rows) == 17 * len(fig6_coverage.COV_SCHEMES)
    obsequi = {r.split(",")[0].split("/")[2]: _derived(r) for r in rows
               if r.startswith("fig6/obsequi/")}
    # paper claim C5: PFO outlines around the host-only ops
    assert int(obsequi["tech-gfp"]["segments"]) > 0
    assert int(obsequi["tech-gf"]["segments"]) == 0


def test_fig_runs_standalone():
    names = ["sgefa", "npbbt"]
    assert len(fig4_speedup.run("test", device="cpu", workloads=names, repeats=1)) == \
        2 * 6 + 4 + 1
    assert len(fig5_invocations.run("test", device="cpu", workloads=names)) == 2 * 4
    assert len(fig6_coverage.run("test", device="cpu", workloads=names)) == 2 * 3


def _reference_fig7(arch: str, seq: int):
    import jax
    from repro.configs import reduced_config
    from repro.models import api as japi
    from repro.models import programs as jprograms

    cfg = dataclasses.replace(reduced_config(arch), compute_dtype="float32",
                              d_model=128, d_ff=256, n_layers=4)
    params = japi.init(cfg, jax.random.PRNGKey(0), tp=2)
    return jprograms.export_dense_forward(cfg, params, batch=2, seq=seq, tp=2)


@pytest.mark.parametrize("arch", fig7_reverse.MODEL_ARCHS)
def test_fig7_matches_reference(arch):
    """The reduced dense programs of fig. 7 under every scheme, with the JAX
    package's weights: same counters, coverage and units, logits within the
    engine tolerance; ``native`` refused for the host check."""
    from repro import mixed as jmixed
    from repro.core import NativeInfeasibleError as JNativeInfeasible

    seq = fig7_reverse.seq_len("test")
    jprog, jargs = _reference_fig7(arch, seq)
    tprog, targs = fig7_reverse.model_program(arch, seq=seq)
    load_reference_constants(tprog, jprog.constants)
    assert np.array_equal(jargs[0], targs[0])
    truns = sweep_schemes(tprog, targs, repeats=1, device="cpu")
    for scheme in SCHEMES:
        try:
            jh = jmixed.trace(jprog).plan(scheme).compile()
        except JNativeInfeasible:
            assert truns[scheme].infeasible is not None
            continue
        jrun = run_compiled(jh, jargs, repeats=1)
        assert truns[scheme].record() == jrun.record(), scheme
        for a, b in zip(jrun.outputs, truns[scheme].outputs):
            np.testing.assert_allclose(b, np.asarray(a), rtol=RTOL, atol=ATOL)
    rows = fig7_reverse.rows({arch: truns})
    assert len(rows) == 6 + 4
    g2h = {s: int(_derived(r)["g2h"]) for r in rows
           for s in ("tech", "tech-gf", "tech-gfp") if r.startswith(f"fig7/{arch}/{s},")}
    assert g2h["tech"] >= g2h["tech-gf"] >= g2h["tech-gfp"] >= 1


def test_fig7_weights_come_from_the_seed():
    a, _ = fig7_reverse.model_program("smollm-360m", seq=8, seed=0)
    b, _ = fig7_reverse.model_program("smollm-360m", seq=8, seed=0)
    c, _ = fig7_reverse.model_program("smollm-360m", seq=8, seed=1)
    assert all(np.array_equal(a.constants[k], b.constants[k]) for k in a.constants)
    assert not all(np.array_equal(a.constants[k], c.constants[k]) for k in a.constants)


def test_table3_rows():
    sweeps = table3_library.sweep("test", device="cpu", repeats=1)
    rows = table3_library.rows(sweeps)
    assert len(rows) == len(table3_library.APPS) * (1 + len(table3_library.LIB_SETS))
    for app, res in sweeps.items():
        for lib, prefixes in table3_library.LIB_SETS.items():
            units = res[lib].hybrid.last_plan.units
            assert all(u.startswith(prefixes) for u in units), (app, lib, units)
            for a, b in zip(res["qemu"].outputs, res[lib].outputs):
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    zl = sweeps["zlibflate"]
    assert len(zl["zlib"].hybrid.last_plan.units) > 0
    assert len(zl["libpng"].hybrid.last_plan.units) == 0   # zlibflate uses no libpng


def test_beyond_profile_structure():
    """Profile guidance refuses the tiny hot-path functions of cjson and lua
    (they stay interpreted, far fewer crossings than static tech-gfp) and
    still offloads npbbt's solver."""
    sweeps = beyond_profile.sweep("test", device="cpu", repeats=1)
    rows = beyond_profile.rows(sweeps)
    assert len(rows) == 3 * len(beyond_profile.CASES)
    tiny = {"cjson": ("tok_skip", "node_alloc", "parse_value"),
            "lua": ("op_arith", "op_cmp")}
    for name, fns in tiny.items():
        guided, static = sweeps[name]["profile-guided"], sweeps[name]["static"]
        decisions = guided.hybrid.last_plan.decisions
        for fn in fns:
            assert fn not in guided.hybrid.last_plan.units
            assert decisions[fn].startswith("profiled:"), (name, fn, decisions[fn])
        assert guided.steady.guest_to_host < static.steady.guest_to_host
    assert len(sweeps["npbbt"]["profile-guided"].hybrid.last_plan.units) > 0
    for name, res in sweeps.items():
        for kind in ("static", "profile-guided"):
            for a, b in zip(res["qemu"].outputs, res[kind].outputs):
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_crossing_cost_parts():
    parts = crossing_cost.measure(device="cpu", sizes=(64,), n=3)
    assert set(parts) == {64}
    assert set(parts[64]) == {
        "plan_build(GRT-cached)", "convert_in(place)", "unit_dispatch+exec",
        "convert_out(to_host)", "callback_roundtrip", "whole_crossing(tech-g)",
        "whole_crossing(tech)"}
    assert all(0 < s < 1 and math.isfinite(s) for s in parts[64].values())
    rows = crossing_cost.rows(parts)
    assert rows[0].startswith("crossing/n64/plan_build") and len(rows) == 7


def test_csv_row_format():
    assert csv_row("a/b", 12.345, "x=1") == "a/b,12.3,x=1"
    assert csv_row("a/b", float("nan"), "x=1") == "a/b,nan,x=1"
    assert SchemeRun(infeasible=ValueError("x")).record() == {"infeasible": True}


def test_run_on_the_cpu(capsys):
    assert run.main(["--device", "cpu", "--scale", "test", "--repeats", "1"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    for prefix in ("fig4/", "fig5/", "fig6/", "fig7/", "table3/", "profile/", "crossing/"):
        assert any(line.startswith(prefix) for line in lines), prefix
    assert "FAILED" not in captured.err and "units on: cpu" in captured.err


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="CUDA"):
        run.main(["--scale", "test", "--repeats", "1"])
    assert capsys.readouterr().out == ""          # no rows, not even the header


def test_fig7_sweep_runs_both_archs():
    sweeps = fig7_reverse.sweep("test", device="cpu", repeats=1)
    assert list(sweeps) == fig7_reverse.MODEL_ARCHS
    for runs in sweeps.values():
        assert runs["native"].infeasible is not None
        for scheme in SCHEMES[2:]:
            for a, b in zip(runs["qemu"].outputs, runs[scheme].outputs):
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
