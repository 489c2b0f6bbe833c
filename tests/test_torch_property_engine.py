"""Property-based tests (hypothesis) for the port's mixed-execution
invariants, ported from ``tests/test_property_engine.py`` (units on the CPU).

Random programs over the opset must satisfy:
  * scheme equivalence: qemu == tech-gfp (== native when feasible)
  * abstract_eval agrees with concrete interpreter shapes/dtypes
  * PFO partitions bodies exactly (no op lost or duplicated), and the
    transformed program is still valid SSA
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")  # optional dev dependency
from hypothesis import given, settings, strategies as st

from repro_torch.core import (
    HybridExecutor, NativeInfeasibleError, ProgramBuilder, abstract_eval, run_scheme,
)
from repro_torch.core.convert import aval_of
from repro_torch.core.fcp import InlinePolicy
from repro_torch.core.pfo import outline_function

UNARY = ["neg", "tanh", "relu", "sigmoid", "abs", "square"]
BINARY = ["add", "sub", "mul", "maximum", "minimum"]


@st.composite
def random_program(draw):
    """A random 2-function program over (n,) float32 vectors."""
    n = draw(st.sampled_from([8, 17, 32]))
    n_ops_sub = draw(st.integers(2, 6))
    n_ops_main = draw(st.integers(2, 8))
    host_at = draw(st.one_of(st.none(), st.integers(0, n_ops_main - 1)))
    loop_times = draw(st.integers(1, 5))

    pb = ProgramBuilder("prop")
    pb.constant("c0", np.float32(0.5))

    sub = pb.function("sub_fn", ["x"])
    sub.use_global("c0")
    v = "x"
    for i in range(n_ops_sub):
        kind = draw(st.sampled_from(UNARY + BINARY))
        if kind in UNARY:
            v = sub.emit(kind, v)
        else:
            v = sub.emit(kind, v, "c0")
    sub.build([v])

    main = pb.function("main", ["x0"])
    main.use_global("c0")
    v = "x0"
    use_loop = draw(st.booleans())
    if use_loop:
        v = main.repeat("sub_fn", loop_times, v)
    for i in range(n_ops_main):
        if host_at == i:
            v = main.emit("host_print", v, threshold=1e9)
        kind = draw(st.sampled_from(UNARY + BINARY))
        if kind in UNARY:
            v = main.emit(kind, v)
        else:
            v = main.emit(kind, v, "c0")
    v2 = main.call("sub_fn", v)
    main.build([v2])

    prog = pb.build("main")
    x0 = np.linspace(-1, 1, n, dtype=np.float32)
    return prog, [x0], host_at is not None


@settings(max_examples=25, deadline=None)
@given(random_program())
def test_scheme_equivalence_property(case):
    prog, args, has_host = case
    ref, _ = run_scheme(prog, "qemu", args, backend="cpu")
    out, ex = run_scheme(prog, "tech-gfp", args, backend="cpu")
    for a, b in zip(ref, out):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)
    if has_host:
        with pytest.raises(NativeInfeasibleError):
            HybridExecutor(prog, "native", entry_avals=[aval_of(args[0])],
                           backend="cpu")
    else:
        nat, _ = run_scheme(prog, "native", args, backend="cpu")
        np.testing.assert_allclose(ref[0], nat[0], rtol=2e-3, atol=2e-4)


@settings(max_examples=25, deadline=None)
@given(random_program())
def test_abstract_eval_matches_concrete(case):
    prog, args, _ = case
    avals = tuple(aval_of(a) for a in args)
    out_avals, _ = abstract_eval(prog, "main", avals)
    ref, _ = run_scheme(prog, "qemu", args, backend="cpu")
    assert len(out_avals) == len(ref)
    for av, concrete in zip(out_avals, ref):
        assert av.shape == tuple(np.shape(concrete))
        assert str(np.asarray(concrete).dtype) == av.dtype


@settings(max_examples=25, deadline=None)
@given(random_program())
def test_pfo_partition_exact(case):
    prog, args, has_host = case
    fn = prog.functions["main"]
    policy = InlinePolicy(fcp=True, compilable=frozenset(["sub_fn"]))
    res = outline_function(prog, "main", policy)
    if res is None:
        return
    # every original op appears exactly once across residual non-call ops +
    # segment bodies
    seg_ops = [op for seg in res.segments for op in seg.ops]
    res_ops = [op for op in res.residual.ops if op.params.get("callee", "").find("#seg") < 0]
    combined = seg_ops + res_ops
    assert len(combined) == len(fn.ops)
    assert sorted(o.outputs for o in combined) == sorted(o.outputs for o in fn.ops)
    # the transformed program still validates (SSA + arity)
    work = dict(prog.functions)
    work["main"] = res.residual
    for seg in res.segments:
        work[seg.name] = seg
    from repro_torch.core.program import Program
    p2 = Program("t", work, "main", prog.constants)
    p2.validate()
    # and still computes the same thing under the hybrid engine
    out, _ = run_scheme(prog, "tech-gfp", args, backend="cpu")
    ref, _ = run_scheme(prog, "qemu", args, backend="cpu")
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-3, atol=2e-4)
