"""The port's engine surface, ported from the reference's tests: the
end-to-end scheme behaviour of ``tests/test_core_engine.py`` on the 17
workloads, the staged frontend, report and deprecated-shim tests of
``tests/test_api.py``, and the profile-guided cost model of
``tests/test_profiling_and_flash_bwd.py``.  Units run on the CPU
(``backend="cpu"``); tolerances are the reference's (2e-3/2e-4).
"""
import dataclasses
import warnings
from collections import Counter

import numpy as np
import pytest

from repro_torch import mixed
from repro_torch.core import (
    SCHEMES as SCHEME_REGISTRY,
    CostModel,
    CostModelConfig,
    ExecutionReport,
    HybridExecutor,
    NativeInfeasibleError,
    ProgramBuilder,
    RunStats,
    Scheme,
    run_scheme,
)
from repro_torch.core.convert import aval_of, signature_of
from repro_torch.core.profiling import ProfiledCostModel, profile_program
from repro_torch.workloads import WORKLOADS
from repro_torch.workloads.libs import build_library_app, library_unit_filter

SCHEMES = ["qemu", "tech", "tech-g", "tech-gf", "tech-gfp"]


def run_staged(prog, scheme, args, **plan_kw):
    """One call through the staged API (units on the CPU); returns
    (outputs, CompiledHybrid)."""
    hybrid = mixed.trace(prog).plan(scheme, **plan_kw).compile(backend="cpu")
    out = hybrid(*args)
    return out, hybrid


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_scheme_equivalence(name):
    spec = WORKLOADS[name]
    prog, args = spec.build("test")
    ref, _ = run_staged(prog, "qemu", args)
    for scheme in SCHEMES[1:]:
        out, _ = run_staged(prog, scheme, args)
        for a, b in zip(ref, out):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-4,
                err_msg=f"{name} under {scheme} diverged from qemu",
            )


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_native_feasibility(name):
    spec = WORKLOADS[name]
    prog, args = spec.build("test")
    if spec.has_host_ops:
        # infeasibility is a compile-time fact: .plan() raises, no avals needed
        with pytest.raises(NativeInfeasibleError):
            mixed.trace(prog).plan("native")
    else:
        out, hybrid = run_staged(prog, "native", args)
        ref, _ = run_staged(prog, "qemu", args)
        for a, b in zip(ref, out):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-4)
        assert hybrid.last_report.guest_to_host == 1  # single region, single crossing


def test_fcp_collapses_crossings():
    """Paper Fig. 5: FCP reduces guest→host calls by orders of magnitude."""
    prog, args = WORKLOADS["npbbt"].build("test")
    _, hy_tech = run_staged(prog, "tech", args)
    _, hy_gf = run_staged(prog, "tech-gf", args)
    assert hy_tech.last_report.guest_to_host > 5 * max(1, hy_gf.last_report.guest_to_host)
    # with FCP the entire solver collapses into one region = one crossing
    assert hy_gf.last_report.guest_to_host <= 2


def test_grt_eliminates_plan_rebuilds():
    """Paper §3.4 GRT: conversion data built once, not per crossing."""
    prog, args = WORKLOADS["matpowsum"].build("test")
    _, hy_tech = run_staged(prog, "tech", args)
    _, hy_g = run_staged(prog, "tech-g", args)
    rep_tech, rep_g = hy_tech.last_report, hy_g.last_report
    assert rep_tech.conversion_builds == rep_tech.guest_to_host
    assert rep_g.conversion_builds <= len(hy_g.plan_for(*args).units)
    assert rep_g.grt_hits > 0
    # GRT does not change crossing counts (paper: "GRT poses no effect to
    # the invocation count")
    assert rep_g.guest_to_host == rep_tech.guest_to_host


def test_pfo_increases_coverage_and_rescues_blocked_functions():
    """Paper Fig. 6: PFO expands offloading to host-op-blocked functions."""
    prog, args = WORKLOADS["obsequi"].build("test")
    _, hy_gf = run_staged(prog, "tech-gf", args)
    _, hy_gfp = run_staged(prog, "tech-gfp", args)
    cov_gf = hy_gf.plan_for(*args).coverage
    cov_gfp = hy_gfp.plan_for(*args).coverage
    assert cov_gfp.offloaded_functions > cov_gf.offloaded_functions
    assert cov_gfp.outlined_segments > 0
    # the paper's obsequi: crossings collapse to ~1 once PFO+FCP combine
    assert hy_gfp.last_report.guest_to_host < hy_gf.last_report.guest_to_host


def test_reentrancy_nested_callbacks():
    """cjson-style: offloaded region calls back to guest, which re-offloads."""
    prog, args = WORKLOADS["cjson"].build("test")
    out, hybrid = run_staged(prog, "tech-gfp", args)
    rep = hybrid.last_report
    assert rep.host_to_guest > 0          # callbacks happened
    assert rep.nested_crossings > 0       # guest re-offloaded while a host
                                          # region was live: host→guest→host
    assert rep.max_interleave_depth >= 2  # interleaved call chain depth
    ref, _ = run_staged(prog, "qemu", args)
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-3, atol=2e-4)


def test_crossing_count_correlates_with_schemes():
    """tech >= tech-gf >= tech-gfp in crossings, for loop-heavy workloads."""
    for name in ["matpowsum", "stencil2d", "npblu"]:
        prog, args = WORKLOADS[name].build("test")
        counts = {}
        for scheme in ["tech", "tech-gf", "tech-gfp"]:
            _, hybrid = run_staged(prog, scheme, args)
            counts[scheme] = hybrid.last_report.guest_to_host
        assert counts["tech"] >= counts["tech-gf"] >= counts["tech-gfp"], (name, counts)


def test_costmodel_threshold_rejects_small_functions():
    cfg = CostModelConfig(min_ops=10_000)  # absurd threshold: nothing offloads
    prog, args = WORKLOADS["stencil2d"].build("test")
    out, hybrid = run_staged(prog, "tech-gfp", args, costmodel=CostModel(cfg))
    assert hybrid.last_report.guest_to_host == 0  # degraded to pure emulation
    ref, _ = run_staged(prog, "qemu", args)
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-3)
    assert hybrid.plan_for(*args).coverage.rejected_by_costmodel > 0


def test_crossing_aware_costmodel_fixes_cjson():
    """Beyond-paper: the crossing-aware cost model refuses bad offloads."""
    prog, args = WORKLOADS["cjson"].build("test")
    cfg = CostModelConfig(crossing_aware=True)
    out, hybrid = run_staged(prog, "tech-gfp", args, costmodel=CostModel(cfg))
    ref, _ = run_staged(prog, "qemu", args)
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-3, atol=2e-4)
    # tiny parser functions must be rejected
    assert hybrid.plan_for(*args).coverage.rejected_by_costmodel > 0


def test_library_offloading_unmodified_app():
    """Paper Table 3: offloading only the shared library still accelerates
    (and never changes results of) an unmodified downstream app."""
    for app in ["zlibflate", "imagemagick", "optipng", "apng2gif"]:
        prog, args = build_library_app(app, "test")
        ref, _ = run_staged(prog, "qemu", args)
        out, hybrid = run_staged(
            prog, "tech-gfp", args,
            unit_filter=library_unit_filter(("zlib.", "libpng.")),
        )
        np.testing.assert_allclose(out[0], ref[0], rtol=2e-3, atol=2e-4)
        # app functions must never be offloaded
        assert all(u.startswith(("zlib.", "libpng."))
                   for u in hybrid.plan_for(*args).units)
        if app == "zlibflate":
            assert hybrid.last_report.guest_to_host > 0


def test_degradation_guarantee():
    """Worst case degenerates to pure emulation, never to failure."""
    prog, args = WORKLOADS["lua"].build("test")
    cfg = CostModelConfig(min_ops=10**9)
    out, hybrid = run_staged(prog, "tech-gfp", args, costmodel=CostModel(cfg))
    ref, _ = run_staged(prog, "qemu", args)
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-3, atol=2e-4)
    assert hybrid.last_report.guest_to_host == 0


def build_program(host_check: bool = True):
    """Quickstart-shaped program: offloadable dense block + hot loop, plus an
    optional host-only safety check (the paper's printf case)."""
    pb = ProgramBuilder("api-test")
    W = (np.random.default_rng(0).standard_normal((48, 48)) / 10).astype(np.float32)
    pb.constant("W", W)

    dense = pb.function("dense", ["x"])
    dense.use_global("W")
    h = dense.emit("matmul", "x", "W")
    h = dense.emit("tanh", h)
    dense.build([h])

    step = pb.function("step", ["x"])
    y = step.call("dense", "x")
    z = step.emit("mul", y, y)
    step.build([z])

    main = pb.function("main", ["x0"])
    out = main.repeat("step", 12, "x0")
    if host_check:
        out = main.emit("host_print", out, threshold=1e6, fmt="overflow {}")
    s = main.emit("reduce_sum", out, axis=(0, 1))
    main.build([s])
    return pb.build("main")


def arg(batch: int, dtype=np.float32, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((batch, 48)).astype(dtype)


# ---------------------------------------------------------------------------
# staged pipeline + signature-polymorphic cache
# ---------------------------------------------------------------------------


def test_trace_exposes_callgraph_facts():
    traced = mixed.trace(build_program())
    assert {"main", "step", "dense"} <= set(traced.reachable)
    assert traced.host_blocked == frozenset({"main"})
    assert traced.recursive == frozenset()


def test_signature_polymorphic_plan_cache():
    """One CompiledHybrid serves two shapes: two plans, then per-shape hits."""
    hybrid = mixed.trace(build_program()).plan("tech-gfp").compile(backend="cpu")
    x8, x4 = arg(8), arg(4)

    out8 = hybrid(x8)
    assert hybrid.replans == 1
    assert hybrid.last_report.replans == 1 and not hybrid.last_report.cache_hit
    assert hybrid.last_report.signature == signature_of([x8])

    out4 = hybrid(x4)
    assert hybrid.replans == 2                      # second shape → second plan
    assert not hybrid.last_report.cache_hit
    assert hybrid.last_report.replans == 2

    # second call per shape hits the cache — no new plan
    r8 = hybrid(x8)
    assert hybrid.replans == 2 and hybrid.last_report.cache_hit
    r4 = hybrid(x4)
    assert hybrid.replans == 2 and hybrid.last_report.cache_hit
    assert len(hybrid.signatures) == 2

    # cached path is deterministic
    assert np.array_equal(out8[0], r8[0])
    assert np.array_equal(out4[0], r4[0])

    # each shape agrees with pure emulation
    qemu = mixed.trace(build_program()).plan("qemu").compile(backend="cpu")
    np.testing.assert_allclose(out8[0], qemu(x8)[0], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(out4[0], qemu(x4)[0], rtol=2e-3, atol=2e-4)


def test_dtype_is_part_of_the_signature():
    hybrid = mixed.trace(build_program()).plan("tech-g").compile(backend="cpu")
    hybrid(arg(8, np.float32))
    hybrid(arg(8, np.float64))
    assert hybrid.replans == 2
    assert len({sig[0].dtype for sig in hybrid.signatures}) == 2


def test_grt_cache_warm_across_calls_of_same_signature():
    hybrid = mixed.trace(build_program()).plan("tech-g").compile(backend="cpu")
    x = arg(8)
    hybrid(x)
    first = hybrid.last_report
    hybrid(x)
    second = hybrid.last_report
    assert first.conversion_builds > 0
    assert second.conversion_builds == 0           # everything served by GRT
    assert second.grt_hits == second.guest_to_host
    assert second.compiles == 0                    # no retrace either


def test_native_infeasibility_raised_at_plan_time():
    with pytest.raises(NativeInfeasibleError):
        mixed.trace(build_program(host_check=True)).plan("native")
    # feasible program: plan + compile + run, entirely offloaded
    hybrid = mixed.trace(build_program(host_check=False)).plan("native").compile(backend="cpu")
    out = hybrid(arg(8))
    assert hybrid.last_report.guest_to_host == 1
    assert out[0].shape == ()


def test_plan_for_and_coverage():
    hybrid = mixed.trace(build_program()).plan("tech-gfp").compile(backend="cpu")
    plan = hybrid.plan_for(arg(8))                 # builds eagerly, no call
    assert hybrid.replans == 1
    assert plan.coverage.offloaded_functions > 0
    assert "dense" in plan.units


# ---------------------------------------------------------------------------
# composable Scheme
# ---------------------------------------------------------------------------


def test_feature_toggles_rejected_on_non_offloading_schemes():
    # allowing .with_grt() on qemu/native would mint schemes named "qemu"
    # that compare unequal to SCHEME_REGISTRY["qemu"]
    with pytest.raises(ValueError):
        Scheme.emulation().with_grt()
    with pytest.raises(ValueError):
        Scheme.complete().with_pfo()


def test_grt_table_counters():
    from repro_torch.core.grt import GlobalReferenceTable
    from repro_torch.core import RunStats

    sentinel = object()
    # standalone (no RunStats attached): table-local counters still work
    grt = GlobalReferenceTable()
    key = (aval_of(arg(8)),)
    assert grt.lookup_or_build("f", key, lambda: sentinel) is sentinel
    assert grt.lookup_or_build("f", key, lambda: None) is sentinel
    assert (grt.builds, grt.hits, len(grt)) == (1, 1, 1)
    # attached: table counters and RunStats stay in lockstep
    stats = RunStats()
    grt2 = GlobalReferenceTable(stats)
    grt2.lookup_or_build("f", key, lambda: sentinel)
    grt2.lookup_or_build("f", key, lambda: None)
    assert (grt2.builds, grt2.hits) == (stats.conversion_builds, stats.grt_hits)


def test_report_depths_are_per_call_not_lifetime():
    """High-water marks in a report reflect that call, not earlier calls."""
    hybrid = mixed.trace(build_program()).plan("tech-gfp").compile(backend="cpu")
    x = arg(8)
    hybrid(x)
    first = hybrid.last_report
    assert first.max_interleave_depth >= 1
    # simulate an earlier deeply-nested call on the cumulative stats
    state = hybrid.state_for(signature_of([x]))
    state.stats.max_interleave_depth = 99
    state.stats.max_reentry_depth = 99
    hybrid(x)
    second = hybrid.last_report
    assert second.max_interleave_depth == first.max_interleave_depth  # not 99
    assert second.max_reentry_depth == first.max_reentry_depth
    # the cumulative stats keep the lifetime high-water mark
    assert state.stats.max_interleave_depth == 99


def test_composable_scheme_equals_registry():
    assert Scheme.base() == SCHEME_REGISTRY["tech"]
    assert Scheme.base().with_grt() == SCHEME_REGISTRY["tech-g"]
    assert Scheme.base().with_grt().with_fcp() == SCHEME_REGISTRY["tech-gf"]
    assert Scheme.base().with_grt().with_fcp().with_pfo() == SCHEME_REGISTRY["tech-gfp"]
    assert Scheme.emulation() == SCHEME_REGISTRY["qemu"]
    assert Scheme.complete() == SCHEME_REGISTRY["native"]
    # toggles compose in any order and can disable again
    assert Scheme.base().with_fcp().with_grt() == SCHEME_REGISTRY["tech-gf"]
    assert Scheme.base().with_grt().with_grt(False) == SCHEME_REGISTRY["tech"]


def test_composed_scheme_runs_like_registry_scheme():
    prog = build_program()
    x = arg(8)
    via_string = mixed.trace(prog).plan("tech-gf").compile(backend="cpu")
    via_compose = mixed.trace(prog).plan(Scheme.base().with_grt().with_fcp()).compile(backend="cpu")
    out_s, out_c = via_string(x), via_compose(x)
    assert np.array_equal(out_s[0], out_c[0])
    assert via_string.last_report.guest_to_host == via_compose.last_report.guest_to_host


# ---------------------------------------------------------------------------
# ExecutionReport + instrument()
# ---------------------------------------------------------------------------


def test_instrument_collects_per_call_reports():
    hybrid = mixed.trace(build_program()).plan("tech-gfp").compile(backend="cpu")
    x8, x4 = arg(8), arg(4)
    hybrid(x8)  # outside the session: not recorded
    with mixed.instrument() as rec:
        hybrid(x8)
        hybrid(x4)
        hybrid(x4)
    assert len(rec.reports) == 3
    merged = rec.merged()
    assert merged.calls == 3
    assert merged.cache_hits == 2                  # x8 warm, first x4 cold
    assert merged.guest_to_host == sum(r.guest_to_host for r in rec.reports)
    assert merged.signature is None                # mixed signatures


def test_execution_report_merge():
    r1 = ExecutionReport(scheme="tech", guest_to_host=3, wall_seconds=0.5,
                         max_interleave_depth=1, replans=1, owner=1,
                         per_function_crossings=Counter({"f": 3}))
    r2 = ExecutionReport(scheme="tech", guest_to_host=2, cache_hits=1,
                         wall_seconds=0.25, max_interleave_depth=4, replans=2,
                         owner=1, per_function_crossings=Counter({"f": 1, "g": 1}))
    m = r1.merge(r2)
    assert m.calls == 2 and m.cache_hits == 1
    assert m.guest_to_host == 5
    assert m.wall_seconds == pytest.approx(0.75)
    assert m.max_interleave_depth == 4             # max, not sum
    assert m.replans == 2                          # same owner: cumulative max
    assert m.per_function_crossings == Counter({"f": 4, "g": 1})
    # originals untouched
    assert r1.guest_to_host == 3 and r1.per_function_crossings == Counter({"f": 3})
    assert ExecutionReport.aggregate([]).calls == 0
    assert ExecutionReport.aggregate([r1, r2]).guest_to_host == 5


def test_replans_sum_across_distinct_compiled_objects():
    # per-owner replans are cumulative, so aggregating across two objects
    # must sum the per-owner maxima, in any report order
    a1 = ExecutionReport(replans=1, owner=10)
    a2 = ExecutionReport(replans=3, owner=10)
    b1 = ExecutionReport(replans=2, owner=20)
    assert ExecutionReport.aggregate([a1, b1, a2]).replans == 5
    assert ExecutionReport.aggregate([a1, a2, b1]).replans == 5
    # end to end: two hybrids inside one instrument session
    prog = build_program()
    h1 = mixed.trace(prog).plan("tech-g").compile(backend="cpu")
    h2 = mixed.trace(prog).plan("tech-gfp").compile(backend="cpu")
    with mixed.instrument() as rec:
        h1(arg(8)); h1(arg(4)); h2(arg(8))
    assert rec.merged().replans == 3               # 2 plans in h1 + 1 in h2


def test_runstats_reset_is_explicit_and_complete():
    s = RunStats()
    for f in dataclasses.fields(RunStats):
        if f.name == "per_function_crossings":
            s.per_function_crossings["x"] = 7
        else:
            setattr(s, f.name, 9)
    s.reset()
    assert s == RunStats(), "reset() must restore every field to its default"


# ---------------------------------------------------------------------------
# deprecated shims
# ---------------------------------------------------------------------------


def test_hybrid_executor_shim_matches_staged_path():
    prog = build_program()
    x = arg(8)
    with pytest.deprecated_call():
        ex = HybridExecutor(prog, "tech-gfp", entry_avals=[aval_of(x)],
                            backend="cpu")
    old = ex(*[x])
    new_hybrid = mixed.trace(prog).plan("tech-gfp").compile(backend="cpu")
    new = new_hybrid(x)
    assert np.array_equal(old[0], new[0]), "shim must be bit-identical"
    assert ex.stats.guest_to_host == new_hybrid.last_report.guest_to_host
    assert ex.coverage.offloaded_functions == \
        new_hybrid.plan_for(x).coverage.offloaded_functions
    assert sorted(ex.plan.units) == sorted(new_hybrid.plan_for(x).units)


def test_run_scheme_shim_matches_staged_path():
    prog = build_program()
    x = arg(8)
    with pytest.deprecated_call():
        old, ex = run_scheme(prog, "tech-gf", [x], backend="cpu")
    new = mixed.trace(prog).plan("tech-gf").compile(backend="cpu")(x)
    assert np.array_equal(old[0], new[0])


def test_shim_requires_entry_avals():
    with pytest.raises(ValueError), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        HybridExecutor(build_program(), "tech")


def test_shim_native_raises_in_constructor():
    prog = build_program(host_check=True)
    with pytest.raises(NativeInfeasibleError), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        HybridExecutor(prog, "native", entry_avals=[aval_of(arg(8))],
                       backend="cpu")


def test_profile_records_hot_functions():
    prog, args = WORKLOADS["obsequi"].build("test")
    profile = profile_program(prog, args)
    assert profile["main"].calls == 1
    assert profile["eval_board"].calls > 1
    # inclusive time: main >= everything else
    assert profile["main"].total_s >= profile["eval_board"].total_s


def test_profiled_costmodel_rejects_cjson_hotpath_but_keeps_heavy_fns():
    """The cjson regression (paper C6) disappears under profile guidance:
    the tiny parser functions are refused, results stay identical."""
    prog, args = WORKLOADS["cjson"].build("test")
    profile = profile_program(prog, args)
    cm = ProfiledCostModel(profile)
    out, hybrid = run_staged(prog, "tech-gfp", args, costmodel=cm)
    ref, _ = run_staged(prog, "qemu", args)
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-3, atol=2e-4)
    # tiny functions rejected with profiled reasons
    decisions = hybrid.plan_for(*args).decisions
    rejected = [f for f, r in decisions.items() if r.startswith("profiled:")]
    assert len(rejected) > 0
    # crossings far fewer than the unprofiled engine's
    _, hy_raw = run_staged(prog, "tech-gfp", args)
    assert hybrid.last_report.guest_to_host < hy_raw.last_report.guest_to_host


def test_profiled_costmodel_still_offloads_hot_heavy_functions():
    prog, args = WORKLOADS["obsequi"].build("test")
    profile = profile_program(prog, args)
    cm = ProfiledCostModel(profile, margin=0.01)  # aggressive: offload hot fns
    out, hybrid = run_staged(prog, "tech-gfp", args, costmodel=cm)
    ref, _ = run_staged(prog, "qemu", args)
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-3, atol=2e-4)
    assert len(hybrid.plan_for(*args).units) > 0


# ---------------------------------------------------------------------------
# the port's shim contract: devices
# ---------------------------------------------------------------------------


def test_shim_default_backend_is_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="CUDA"), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        HybridExecutor(build_program(), "tech", entry_avals=[aval_of(arg(8))])
