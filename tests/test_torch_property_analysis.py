"""Property-based tests (hypothesis) for the port's differential plan
verifier, ported from ``tests/test_property_analysis.py``.

Random valid programs are mutated — insert a host-only op, introduce
recursion, break SSA — and the invariant is that the *planner*
(`analyze_eligibility`) and the *independent verifier*
(`repro_torch.analysis.soundness`) flip their verdicts together: whatever the
mutation did to the compilable set, both sides must still agree on it
(and a broken program must fail validation before either runs).
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")  # optional dev dependency
from hypothesis import given, settings, strategies as st

from repro_torch.analysis import analyze, derive_compilable, verify_plan
from repro_torch.core import ProgramBuilder
from repro_torch.core.offload import SCHEMES, analyze_eligibility
from repro_torch.core.program import Function, Op, Program

UNARY = ["neg", "tanh", "relu", "sigmoid", "abs", "square"]
BINARY = ["add", "sub", "mul", "maximum", "minimum"]
SCHEME_NAMES = sorted(SCHEMES)


@st.composite
def random_program(draw):
    """A random multi-function program over (n,) float32 vectors."""
    n_helpers = draw(st.integers(1, 3))
    pb = ProgramBuilder("prop-analysis")
    pb.constant("c0", np.float32(0.5))

    names = [f"h{i}" for i in range(n_helpers)]
    for i, name in enumerate(names):
        fb = pb.function(name, ["x"])
        fb.use_global("c0")
        v = "x"
        for _ in range(draw(st.integers(1, 4))):
            kind = draw(st.sampled_from(UNARY + BINARY))
            v = fb.emit(kind, v) if kind in UNARY else fb.emit(kind, v, "c0")
        if i > 0 and draw(st.booleans()):
            v = fb.call(names[i - 1], v)  # helpers may chain downward
        fb.build([v])

    main = pb.function("main", ["x0"])
    main.use_global("c0")
    v = "x0"
    for _ in range(draw(st.integers(1, 4))):
        kind = draw(st.sampled_from(UNARY + BINARY))
        v = main.emit(kind, v) if kind in UNARY else main.emit(kind, v, "c0")
        if draw(st.booleans()):
            callee = draw(st.sampled_from(names))
            if draw(st.booleans()):
                v = main.call(callee, v)
            else:
                v = main.repeat(callee, draw(st.integers(1, 4)), v)
    main.build([v])
    return pb.build("main")


def assert_differential_agrees(prog, schemes=SCHEME_NAMES):
    for scheme in schemes:
        sink, facts = verify_plan(prog, scheme)
        errors = [d for d in sink.diagnostics if d.severity == "error"]
        assert errors == [], f"{scheme}: {errors}"


@settings(max_examples=25, deadline=None)
@given(random_program())
def test_random_valid_programs_agree_on_all_schemes(prog):
    assert_differential_agrees(prog)


@settings(max_examples=20, deadline=None)
@given(random_program(), st.data())
def test_host_op_insertion_flips_both_sides(prog, data):
    """Poisoning a function with a host-only op must drop it (and any parent
    that needed it inlined) from BOTH the planner's and the verifier's
    compilable sets, keeping the differential green."""
    victim = data.draw(st.sampled_from(sorted(prog.functions)))
    fn = prog.functions[victim]
    poisoned = Function(
        fn.name, fn.args, fn.returns,
        fn.ops + (Op("host_print", (fn.returns[0],), (f"{victim}.hp",),
                     {"threshold": 1e9}),),
        fn.globals,
    )
    mutated = Program(prog.name, {**prog.functions, victim: poisoned},
                      prog.entry, dict(prog.constants))
    mutated.validate()
    for scheme in ("tech", "tech-gf", "tech-gfp"):
        before = derive_compilable(prog, SCHEMES[scheme]).compilable
        after = derive_compilable(mutated, SCHEMES[scheme]).compilable
        assert victim not in after
        assert after <= before  # poisoning never *adds* compilability
        planner_after = {
            f for f in analyze_eligibility(mutated, SCHEMES[scheme]).compilable
            if "#" not in f
        }
        assert planner_after == after
    assert_differential_agrees(mutated, ("tech", "tech-gf", "tech-gfp"))


@settings(max_examples=20, deadline=None)
@given(random_program(), st.data())
def test_recursion_insertion_flips_both_sides(prog, data):
    """Adding a self-call makes the victim recursive for planner AND
    verifier (Tarjan vs Kosaraju), with the differential still green."""
    victim = data.draw(
        st.sampled_from([f for f in sorted(prog.functions) if f != prog.entry])
    )
    fn = prog.functions[victim]
    recursive = Function(
        fn.name, fn.args, fn.returns,
        fn.ops + (Op("call", (fn.returns[0],), (f"{victim}.rec",),
                     {"callee": victim}),),
        fn.globals,
    )
    mutated = Program(prog.name, {**prog.functions, victim: recursive},
                      prog.entry, dict(prog.constants))
    mutated.validate()  # recursion is legal IR; it is just never offloadable
    derived = derive_compilable(mutated, SCHEMES["tech-gf"])
    analysis = analyze_eligibility(mutated, SCHEMES["tech-gf"])
    assert victim in derived.recursive and victim in analysis.recursive
    assert victim not in derived.compilable
    assert victim not in analysis.compilable
    assert_differential_agrees(mutated, ("tech", "tech-gf", "tech-gfp"))


@settings(max_examples=20, deadline=None)
@given(random_program(), st.data())
def test_ssa_break_fails_validation_and_analysis(prog, data):
    """Double-assigning a var must be rejected by Program.validate, and
    analyze() must surface it as RA001 instead of running any pass."""
    victim = data.draw(st.sampled_from(sorted(prog.functions)))
    fn = prog.functions[victim]
    clobber = data.draw(st.sampled_from([o for op in fn.ops for o in op.outputs]))
    broken = Function(
        fn.name, fn.args, fn.returns,
        fn.ops + (Op("neg", (fn.returns[0],), (clobber,)),),
        fn.globals,
    )
    mutated = Program(prog.name, {**prog.functions, victim: broken},
                      prog.entry, dict(prog.constants))
    with pytest.raises(ValueError):
        mutated.validate()
    rep = analyze(mutated, "tech-gf")
    assert not rep.ok and rep.by_code("RA001") and rep.facts == {}
