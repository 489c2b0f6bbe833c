"""The port's static-analysis layer (repro_torch.analysis), ported from
``tests/test_analysis.py``: golden diagnostic codes per pass, the
planner↔verifier differential on every exported program × every Scheme axis
combination, the crossing bound checked against *measured* crossings (units
on the CPU), exactness-contract corruption fixtures, the
`plan(verify=True)` rejection path, and the tightened repeat validation.
Where the reference uses ``export_decode_lm`` (not ported), the port's
recurrent-state export, ``export_mamba2_decode_lm``, takes its place.

Then the parity with the JAX package: on every target of
``python -m repro_torch.bench.analyze`` under every scheme, the port's
diagnostics and facts equal the reference's on the same program.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch import mixed
from repro_torch.analysis import CODES, analyze, derive_compilable, verify_plan
from repro_torch.analysis.diagnostics import DiagnosticSink
from repro_torch.core import ProgramBuilder
from repro_torch.core.offload import SCHEMES, analyze_eligibility
from repro_torch.core.program import Function, Op, Program
from repro_torch.models import programs
from repro_torch.workloads import WORKLOADS

ALL_SCHEME_NAMES = sorted(SCHEMES)


def hot_loop_program(times: int = 8, host_check: bool = True):
    """The paper's hot-loop pathology: a repeat over an offloadable step,
    with (optionally) a host-only op pinning the parent to the guest side."""
    pb = ProgramBuilder("hotloop")
    pb.constant("W", (np.eye(8) * 0.5).astype(np.float32))
    step = pb.function("step", ["x"])
    step.use_global("W")
    y = step.emit("matmul", "x", "W")
    y = step.emit("tanh", y)
    step.build([y])
    m = pb.function("main", ["x0"])
    v = m.repeat("step", times, "x0")
    if host_check:
        v = m.emit("host_assert_finite", v, tag="hotloop")
    s = m.emit("reduce_sum", v, axis=(0,))
    m.build([s])
    return pb.build("main"), [np.linspace(0, 1, 16, dtype=np.float32).reshape(2, 8)]


# ---------------------------------------------------------------------------
# diagnostics engine
# ---------------------------------------------------------------------------


def test_code_registry_taxonomy():
    for code, (sev, _title) in CODES.items():
        assert code.startswith("RA") and len(code) == 5
        assert sev in ("error", "warn", "info")
    sink = DiagnosticSink()
    with pytest.raises(KeyError):
        sink.emit("RA999", "nope")


def test_report_shape_and_rendering():
    prog, args = hot_loop_program()
    rep = analyze(prog, "tech", example_args=args)
    assert rep.program == "hotloop" and rep.scheme == "tech"
    assert rep.passes == ("dataflow", "soundness", "crossings", "exactness")
    assert rep.ok  # warnings don't flip ok
    d = rep.by_code("RA301")[0]
    assert d.fname == "main" and d.op_kind == "repeat" and d.op_index == 0
    assert "RA301" in str(rep) and "main[op 0 repeat]" in str(d)
    payload = rep.as_dict()
    assert payload["codes"]["RA301"] == 1
    assert payload["diagnostics"][0]["severity"] in ("error", "warn", "info")


def test_invalid_program_yields_ra001():
    fn = Function("main", ("x",), ("y",), (Op("tanh", ("ghost",), ("y",)),))
    prog = Program("bad", {"main": fn}, "main")
    rep = analyze(prog, "tech")
    assert not rep.ok and rep.by_code("RA001")
    assert rep.facts == {}  # no pass ran on an invalid program


# ---------------------------------------------------------------------------
# dataflow pass (RA1xx)
# ---------------------------------------------------------------------------


def dead_code_program():
    pb = ProgramBuilder("deadcode")
    pb.constant("c", np.float32(2.0))
    pb.constant("orphan", np.float32(3.0))
    helper = pb.function("helper", ["a", "unused_arg"])
    h1 = helper.emit("tanh", "a")
    h2 = helper.emit("square", "a")  # second output: never consumed anywhere
    helper.build([h1, h2])
    ghost = pb.function("ghost", ["a"])  # never called
    g = ghost.emit("neg", "a")
    ghost.build([g])
    m = pb.function("main", ["x"])
    m.use_global("c")
    dead_chain = m.emit("mul", "x", "c")
    m.emit("neg", dead_chain)  # feeds nothing -> whole chain dead
    m.emit("host_print", "x", threshold=1e9)  # dead results, kept effect
    keep, _drop = m.call("helper", "x", "x", nout=2)
    out = m.emit("add", keep, "x")
    m.build([out])
    return pb.build("main")


def test_dataflow_golden_codes():
    rep = analyze(dead_code_program(), "tech")
    codes = rep.codes()
    assert codes["RA101"] == 2          # dead mul + dead neg (cascade)
    assert codes["RA102"] == 1          # host_print kept for its effect
    assert codes["RA103"] == 1          # helper output 1 unused everywhere
    assert codes["RA104"] == 1          # ghost unreachable
    # two RA105: the undeclared 'orphan' constant, plus 'c' whose only
    # reader is the dead chain (liveness cascades into globals)
    assert codes["RA105"] == 2
    assert {d.fname for d in rep.by_code("RA105")} == {None, "main"}
    assert codes["RA106"] == 1          # helper's unused_arg
    dead = {(d.fname, d.op_index) for d in rep.by_code("RA101")}
    assert dead == {("main", 0), ("main", 1)}
    flow = rep.facts["dataflow"]["functions"]
    assert flow["main"]["pure"] is False and "host_print" in flow["main"]["effects"]
    assert flow["helper"]["pure"] is True
    assert flow["ghost"]["live_return_positions"] == ()


def test_dataflow_repeat_carry_counts_as_use():
    # a repeat's carried output is consumed by the loop even if the caller
    # ignores the final value of some positions
    pb = ProgramBuilder("carryuse")
    st = pb.function("st", ["a", "b"])
    a2 = st.emit("tanh", "a")
    b2 = st.emit("neg", "b")
    st.build([a2, b2])
    m = pb.function("main", ["x", "y"])
    ra, _rb = m.repeat("st", 3, "x", "y", nout=2)
    m.build([ra])
    rep = analyze(pb.build("main"), "tech")
    assert not rep.by_code("RA103")  # both outputs feed the next iteration
    assert not rep.by_code("RA101")


def test_shipped_exports_have_no_dataflow_warnings():
    # the dead-code satellite: model exports must be clean under the lint
    for prog in (programs.export_mamba2_decode_lm(), programs.export_attn_decode_lm()):
        rep = analyze(prog, "tech-gfp", passes=("dataflow",))
        assert rep.warnings == [], f"{prog.name}: {rep.warnings}"


# ---------------------------------------------------------------------------
# offload-soundness verifier (RA2xx)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ALL_SCHEME_NAMES)
def test_differential_agrees_on_exports(scheme):
    progs = [
        programs.export_mamba2_decode_lm(),
        programs.export_attn_decode_lm(),
        hot_loop_program()[0],
    ]
    for name in ("matpowsum", "cjson", "viterbi", "npbep"):
        progs.append(WORKLOADS[name].build("test")[0])
    for prog in progs:
        sink, facts = verify_plan(prog, scheme)
        errors = [d for d in sink.diagnostics if d.severity == "error"]
        assert errors == [], f"{prog.name}/{scheme}: {errors}"


def test_verifier_blockers_match_planner_reasons():
    prog, _ = hot_loop_program(host_check=False)  # blocked by the repeat alone
    scheme = SCHEMES["tech"]
    analysis = analyze_eligibility(prog, scheme)
    derived = derive_compilable(prog, scheme)
    assert derived.compilable == frozenset(analysis.compilable)
    # both sides explain main's exclusion the same way
    assert "repeat" in analysis.blockers["main"]
    assert "repeat" in derived.blockers["main"]


def test_differential_catches_forged_compilable_set():
    # forge a planner verdict that marks a host-blocked function compilable:
    # the verifier must refute it (RA201) and plan(verify=True) must raise
    prog, _ = hot_loop_program()
    analysis = analyze_eligibility(prog, SCHEMES["tech"])
    forged = dataclasses.replace(
        analysis, compilable=analysis.compilable | {"main"}
    )
    sink, _ = verify_plan(prog, "tech", analysis=forged)
    assert [d.code for d in sink.diagnostics if d.severity == "error"] == ["RA201"]

    missing = dataclasses.replace(analysis, compilable=frozenset())
    sink, _ = verify_plan(prog, "tech", analysis=missing)
    assert {d.code for d in sink.diagnostics if d.severity == "error"} == {"RA202"}


def test_plan_verify_true_accepts_and_rejects(monkeypatch):
    prog, args = hot_loop_program()
    traced = mixed.trace(prog)
    out_ok = traced.plan("tech-gf", verify=True).compile(backend="cpu")(*args)

    # sabotage the planner: force an extra name into its compilable set
    import repro_torch.core.api as core_api

    real = core_api.analyze_eligibility

    def forged(program, scheme, **kw):
        analysis = real(program, scheme, **kw)
        return dataclasses.replace(
            analysis, compilable=analysis.compilable | {"main"}
        )

    monkeypatch.setattr(core_api, "analyze_eligibility", forged)
    with pytest.raises(mixed.PlanVerificationError) as ei:
        mixed.trace(prog).plan("tech-gf", verify=True)
    assert any(d.code == "RA201" for d in ei.value.diagnostics)
    # without verify the forged plan goes through unchecked (the old world)
    mixed.trace(prog).plan("tech")
    del out_ok


def test_native_feasibility_differential():
    clean, _ = hot_loop_program(host_check=False)
    sink, facts = verify_plan(clean, "native")
    assert facts["native_feasible"] == {"planner": True, "verifier": True}
    blocked, _ = hot_loop_program(host_check=True)
    sink, facts = verify_plan(blocked, "native")
    assert facts["native_feasible"] == {"planner": False, "verifier": False}
    assert not [d for d in sink.diagnostics if d.severity == "error"]


def test_pfo_segments_checked_not_rederived():
    prog, _ = hot_loop_program()
    sink, facts = verify_plan(prog, "tech-gfp")
    assert facts["planner"]["segments"]  # PFO produced segments
    assert not [d for d in sink.diagnostics if d.severity == "error"]


# ---------------------------------------------------------------------------
# crossing-cost lint (RA3xx)
# ---------------------------------------------------------------------------


def test_hot_repeat_flagged_with_scheme_conditional_hint():
    prog, args = hot_loop_program(times=8)
    rep = analyze(prog, "tech", example_args=args)
    (d,) = rep.by_code("RA301")
    assert "x8" in d.message and "FCP" in d.hint
    rep_gf = analyze(prog, "tech-gf", example_args=args)
    (d_gf,) = rep_gf.by_code("RA301")
    assert "PFO" in d_gf.hint  # FCP already on; parent is host-blocked
    rep_gfp = analyze(prog, "tech-gfp", example_args=args)
    assert not rep_gfp.by_code("RA301")  # outlined: loop lives in a segment


def test_static_bound_matches_measured_crossings():
    # the bound assumes every compilable fn becomes a unit; run with the
    # default (permissive) cost model and compare against the real counters
    prog, args = hot_loop_program(times=6)
    for scheme in ("tech", "tech-gf", "tech-gfp"):
        rep = analyze(prog, scheme, example_args=args)
        bound = rep.facts["crossings"]["entry_bound"]["guest_to_host"]
        hybrid = mixed.trace(prog).plan(scheme).compile(backend="cpu")
        with mixed.instrument() as rec:
            hybrid(*args)
        measured = rec.merged().guest_to_host
        assert measured == bound, (scheme, measured, bound)


def test_recursion_gives_unbounded_crossings():
    f = Function("f", ("x",), ("y",), (
        Op("tanh", ("x",), ("t",)),
        Op("call", ("t",), ("y",), {"callee": "g"}),
    ))
    g = Function("g", ("x",), ("y",), (Op("call", ("x",), ("y",), {"callee": "f"}),))
    leaf = Function("leaf", ("x",), ("y",), (Op("neg", ("x",), ("y",)),))
    m = Function("main", ("x",), ("y", "z"), (
        Op("call", ("x",), ("y",), {"callee": "f"}),
        Op("call", ("x",), ("z",), {"callee": "leaf"}),
    ))
    prog = Program("rec", {"f": f, "g": g, "leaf": leaf, "main": m}, "main")
    prog.validate()
    rep = analyze(prog, "tech")
    assert rep.by_code("RA303")
    assert rep.facts["crossings"]["entry_bound"]["guest_to_host"] == "inf"
    # the differential must also agree that f/g are non-offloadable
    assert not [d for d in rep.diagnostics if d.severity == "error"]
    assert "f" in rep.facts["soundness"]["verifier"]["recursive"]


def test_qemu_and_native_bounds():
    prog, args = hot_loop_program(host_check=False)
    rep_q = analyze(prog, "qemu", example_args=args)
    assert rep_q.facts["crossings"]["entry_bound"]["guest_to_host"] == 0
    rep_n = analyze(prog, "native", example_args=args)
    assert rep_n.facts["crossings"]["entry_bound"]["guest_to_host"] == 1


# ---------------------------------------------------------------------------
# exactness lint (RA4xx)
# ---------------------------------------------------------------------------


def _attn_tokens():
    return [np.zeros((2, 3), np.int32)]


def test_shipped_decode_roots_are_exact():
    rep = analyze(programs.export_attn_decode_lm(), "tech-gfp",
                  example_args=_attn_tokens())
    facts = {r["root"]: r for r in rep.facts["exactness"]["roots"]}
    assert set(facts) == {"decode_step", "paged_decode_step", "prefill_suffix"}
    for r in facts.values():
        assert r["mode"] == "typed"
    verdicts = {p["arg"]: p["verdict"] for p in facts["decode_step"]["pairs"]}
    assert verdicts["K"] == verdicts["V"] == "cache-pass-through"
    assert not rep.by_code("RA401") and not rep.by_code("RA403")
    # recurrent rank-2 state is exempt from the cache contract
    rep2 = analyze(programs.export_mamba2_decode_lm(), "tech-gfp",
                   example_args=_attn_tokens())
    assert not rep2.by_code("RA401") and rep2.ok


def corrupt_where_to_arithmetic(prog: Program) -> Program:
    """Rewrite attend's K-merge select into masked arithmetic — the classic
    exactness bug (old rows go through a multiply and may round)."""
    at = prog.functions["attend"]
    ops = []
    for op in at.ops:
        if op.kind == "where" and "K" in op.inputs:
            cond, new, old = op.inputs
            condf = Op("cast", (cond,), ("attend.condf",), {"dtype": "float32"})
            scaled = Op("mul", (old, "scale"), ("attend.scaled",), {})
            keep = Op("where", (cond, new, "attend.scaled"), op.outputs, {})
            ops += [condf, scaled, keep]
        else:
            ops.append(op)
    fns = dict(prog.functions)
    fns["attend"] = Function(at.name, at.args, at.returns, tuple(ops), at.globals)
    return Program(prog.name, fns, prog.entry, dict(prog.constants))


def test_inexact_cache_write_is_ra401():
    prog = corrupt_where_to_arithmetic(programs.export_attn_decode_lm())
    prog.validate()
    rep = analyze(prog, "tech-gfp", example_args=_attn_tokens())
    errs = rep.by_code("RA401")
    assert errs and not rep.ok
    assert any("K" in d.message for d in errs)


def test_structural_mode_downgrades_to_info():
    prog = corrupt_where_to_arithmetic(programs.export_attn_decode_lm())
    rep = analyze(prog, "tech-gfp")  # no example args -> no avals
    assert not rep.by_code("RA401")
    assert rep.by_code("RA405") and rep.ok


def test_paged_root_pool_dependence_is_ra403():
    prog = programs.export_attn_decode_lm()
    pa = prog.functions["paged_attend"]
    # leak the pool into a fresh row: kn2 = kn + reduce over Kp
    ops = list(pa.ops)
    kn = pa.returns[1]
    ops.append(Op("reduce_mean", ("Kp",), ("paged_attend.poolmean",), {"axis": (0, 1)}))
    ops.append(Op("add", (kn, "paged_attend.poolmean"), ("paged_attend.kn2",), {}))
    rets = (pa.returns[0], "paged_attend.kn2", pa.returns[2])
    fns = dict(prog.functions)
    fns["paged_attend"] = Function(pa.name, pa.args, rets, tuple(ops), pa.globals)
    bad = Program(prog.name, fns, prog.entry, dict(prog.constants))
    bad.validate()
    rep = analyze(bad, "tech-gfp", example_args=_attn_tokens())
    errs = rep.by_code("RA403")
    assert errs and not rep.ok and "Kp" in errs[0].message


def test_wildcard_reshape_in_root_closure_is_ra402():
    pb = ProgramBuilder("wild")
    pb.constant("W", np.eye(4, dtype=np.float32))
    st = pb.function("decode_step", ["h", "token"])
    st.use_global("W")
    r = st.emit("reshape", "h", shape=(-1, 4))
    y = st.emit("matmul", r, "W")
    st.build([y, y])
    m = pb.function("main", ["h"])
    t = m.emit("tanh", "h")
    m.build([t])
    rep = analyze(pb.build("main"), "tech")
    (d,) = rep.by_code("RA402")
    assert d.fname == "decode_step" and d.op_kind == "reshape"


# ---------------------------------------------------------------------------
# tightened repeat validation (satellite)
# ---------------------------------------------------------------------------


def _repeat_program(times, carry=None):
    pb = ProgramBuilder("rv")
    st = pb.function("st", ["a"])
    y = st.emit("tanh", "a")
    st.build([y])
    m = pb.function("main", ["x"])
    v = m.repeat("st", times, "x", carry=carry)
    m.build([v])
    return pb.build("main")


def test_repeat_times_must_be_positive_int():
    assert _repeat_program(3) is not None
    with pytest.raises(ValueError, match="positive"):
        _repeat_program(0)
    with pytest.raises(ValueError, match="positive"):
        _repeat_program(-2)
    with pytest.raises(ValueError, match="must be an int"):
        _repeat_program(2.5)
    with pytest.raises(ValueError, match="must be an int"):
        _repeat_program(True)
    with pytest.raises(ValueError, match="must be an int"):
        _repeat_program(None)
    assert _repeat_program(np.int64(4)) is not None  # numpy ints are fine


def test_repeat_carry_bounds():
    with pytest.raises(ValueError, match="negative"):
        _repeat_program(2, carry=-1)
    with pytest.raises(ValueError, match="too large"):
        _repeat_program(2, carry=2)
    with pytest.raises(ValueError, match="must be an int"):
        _repeat_program(2, carry="1")
    assert _repeat_program(2, carry=0) is not None
    assert _repeat_program(2, carry=1) is not None


def test_collect_call_avals_rejects_unstable_carry():
    # carry aval drift is caught on the planner's abstract-interpretation
    # path, not just in abstract_eval
    from repro_torch.core.offload import collect_call_avals
    from repro_torch.core.opset import AVal

    grow = Function("grow", ("x",), ("y",), (
        Op("concat", ("x", "x"), ("y",), {"axis": 0}),
    ))
    m = Function("main", ("x",), ("y",), (
        Op("repeat", ("x",), ("y",), {"callee": "grow", "times": 2}),
    ))
    prog = Program("drift", {"grow": grow, "main": m}, "main")
    with pytest.raises(ValueError, match="carry aval changed"):
        collect_call_avals(prog, (AVal((4,), "float32"),))


# ---------------------------------------------------------------------------
# planner blockers (machine-readable reasons)
# ---------------------------------------------------------------------------


def test_eligibility_blockers_populated():
    prog, _ = hot_loop_program(host_check=False)
    a = analyze_eligibility(prog, SCHEMES["tech"])
    assert a.blockers == {"main": "repeat 'step' not inlinable"}
    blocked, _ = hot_loop_program(host_check=True)
    a2 = analyze_eligibility(blocked, SCHEMES["tech-gf"])
    assert a2.blockers["main"].startswith("host-only op")
    a3 = analyze_eligibility(prog, SCHEMES["tech-gf"])
    assert a3.blockers == {}


# ---------------------------------------------------------------------------
# parity with the JAX package on every target the port has
# ---------------------------------------------------------------------------


def _reference_program(name: str):
    """The reference's program for an analyze target (weights may differ:
    no diagnostic reads a constant's values)."""
    from repro.models import programs as jprograms
    from repro.workloads import WORKLOADS as JWORKLOADS
    from repro.workloads import LIBRARY_FUNCTIONS as JLIBS
    from repro.workloads.libs import build_library_app, library_unit_filter

    if name == "attn-decode-lm":
        return jprograms.export_attn_decode_lm(), None
    if name == "mamba2-decode-lm":
        return jprograms.export_mamba2_decode_lm(), None
    if name == "lib-zlibflate":
        return build_library_app("zlibflate", "test")[0], library_unit_filter(JLIBS)
    if name == "zoo-smollm-360m":
        import jax
        from repro.configs import reduced_config
        from repro.models import api as japi

        cfg = dataclasses.replace(reduced_config("smollm-360m"), compute_dtype="float32",
                                  d_model=64, d_ff=128, n_layers=2)
        params = japi.init(cfg, jax.random.PRNGKey(0), tp=2)
        return jprograms.export_dense_forward(cfg, params, batch=2, seq=8, tp=2)[0], None
    return JWORKLOADS[name.removeprefix("wl-")].build("test")[0], None


def _normalise(x):
    """Facts as plain data: sets sorted, tuples as lists."""
    if isinstance(x, dict):
        return {k: _normalise(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return sorted(_normalise(v) for v in x)
    if isinstance(x, (list, tuple)):
        return [_normalise(v) for v in x]
    return x


def _targets():
    from repro_torch.bench.analyze import build_targets

    return build_targets()


@pytest.mark.parametrize("name", sorted(_targets()))
def test_diagnostics_equal_reference(name):
    from repro.analysis import analyze as janalyze
    from repro_torch.bench.analyze import ALL_SCHEMES

    target = _targets()[name]
    prog, example_args = target.build()
    jprog, jfilter = _reference_program(name)
    assert sorted(jprog.functions) == sorted(prog.functions)
    for scheme in ALL_SCHEMES:
        rep = analyze(prog, scheme, unit_filter=target.unit_filter,
                      example_args=example_args)
        jrep = janalyze(jprog, scheme, unit_filter=jfilter, example_args=example_args)
        assert rep.as_dict()["diagnostics"] == jrep.as_dict()["diagnostics"], scheme
        assert rep.codes() == jrep.codes() and rep.ok == jrep.ok
        assert _normalise(rep.facts) == _normalise(jrep.facts), scheme


def test_analyze_gate_passes_against_the_baseline(capsys):
    from repro_torch.bench.analyze import main

    assert main(["--all", "--strict"]) == 0
    out = capsys.readouterr().out
    assert "all targets clean" in out
    assert "decode-lm" in out and "moe-decode-lm" in out    # named, not ported


def test_mixed_exports_analysis_entry_points():
    from repro_torch import core

    assert mixed.analyze is core.analyze
    assert mixed.AnalysisReport is core.AnalysisReport
    assert issubclass(mixed.PlanVerificationError, RuntimeError)
