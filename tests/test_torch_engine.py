"""The port's staged engine against the reference, scheme by scheme.

The attention decode LM's roots (``prefill``, ``decode_step``,
``paged_decode_step``) run through ``trace → plan → compile`` in both
packages under all six schemes.  Where the reference refuses (``native``
meets the host-only ``host_assert_finite``), the port refuses with the same
error; otherwise outputs agree to the engine tolerance (2e-3/2e-4, as
``tests/test_core_engine.py``) with equal dtypes, and the counters that do
not depend on the framework — crossings, reentries, conversion builds,
compiles, GRT hits, coverage — are equal, call after call.
"""
import numpy as np
import pytest

from repro import mixed as jmixed
from repro.core import NativeInfeasibleError as JNativeInfeasible
from repro.core.program import ProgramBuilder as JBuilder
from repro.models.programs import export_attn_decode_lm as jexport
from repro_torch import mixed as tmixed
from repro_torch.core import NativeInfeasibleError as TNativeInfeasible
from repro_torch.core.program import ProgramBuilder as TBuilder
from repro_torch.models.programs import export_attn_decode_lm as texport

SCHEMES = ["native", "qemu", "tech", "tech-g", "tech-gf", "tech-gfp"]
COUNTERS = ("guest_to_host", "host_to_guest", "conversion_builds", "compiles",
            "grt_hits", "guest_calls", "guest_ops", "nested_crossings",
            "max_reentry_depth", "max_interleave_depth")
VOCAB, DM, CTX, PS, B = 32, 16, 24, 4, 3


def _attn_args(root, seed=0):
    rng = np.random.default_rng(seed)
    if root == "prefill":
        return [rng.integers(0, VOCAB, (B, 6), dtype=np.int32)]
    lens = np.array([0, 5, 13], np.int32)
    tokens = rng.integers(0, VOCAB, (B,), dtype=np.int32)
    if root == "decode_step":
        K = rng.standard_normal((B, CTX, DM)).astype(np.float32)
        V = rng.standard_normal((B, CTX, DM)).astype(np.float32)
        return [K, V, lens, tokens]
    npages, P = CTX // PS, B * (CTX // PS)
    Kp = rng.standard_normal((P, PS, DM)).astype(np.float32)
    Vp = rng.standard_normal((P, PS, DM)).astype(np.float32)
    tables = rng.permutation(P)[:B * npages].reshape(B, npages).astype(np.int32)
    return [Kp, Vp, tables, lens, tokens]


def _compare(jprog, tprog, scheme, calls):
    """Run ``calls`` (lists of args) through both engines; compare."""
    try:
        jplanned = jmixed.trace(jprog).plan(scheme)
    except JNativeInfeasible:
        with pytest.raises(TNativeInfeasible):
            tmixed.trace(tprog).plan(scheme)
        return None
    jh = jplanned.compile()
    th = tmixed.trace(tprog).plan(scheme).compile(backend="cpu")
    for args in calls:
        jo, jr = jh.call_reported(*args)
        to, tr = th.call_reported(*args)
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
            np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4)
        for f in COUNTERS:
            assert getattr(tr, f) == getattr(jr, f), (scheme, f)
        assert dict(tr.per_function_crossings) == dict(jr.per_function_crossings)
        jplan, tplan = jh.plan_for(*args), th.plan_for(*args)
        assert tplan.coverage.as_dict() == jplan.coverage.as_dict()
        assert sorted(tplan.units) == sorted(jplan.units)
        assert tplan.decisions == jplan.decisions
    return th


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("root", ["prefill", "decode_step", "paged_decode_step"])
def test_attn_lm_roots_match_reference(root, scheme):
    jprog = jexport(vocab=VOCAB, d_model=DM, max_context=CTX)
    tprog = texport(vocab=VOCAB, d_model=DM, max_context=CTX)
    if root != "prefill":
        jprog = jmixed.trace(jprog).with_entry(root).program
        tprog = tmixed.trace(tprog).with_entry(root).program
    # the second call at the same signature compiles nothing and hits the GRT
    _compare(jprog, tprog, scheme, [_attn_args(root, 0), _attn_args(root, 1)])


def _mixed_program(builder):
    """A program that exercises every lowering path of a unit: a float64
    constant (placed as float32), a hot ``repeat`` loop with a carry, a call
    into a host-blocked callee (host→guest reentry without FCP), and a
    host-only op in the entry (PFO splits around it)."""
    pb = builder("lowering-paths")
    pb.constant("c64", np.linspace(0.5, 1.5, 6))              # float64
    pb.constant("w", np.linspace(-1, 1, 36, dtype=np.float32).reshape(6, 6))

    body = pb.function("body", ["x", "n"])
    body.use_global("w")
    y = body.emit("tanh", body.emit("matmul", "x", "w"))
    body.build([y, body.emit("add", "n", "n")])

    chk = pb.function("check", ["x"])
    chk.build([chk.emit("host_print", "x", threshold=1e9)])

    work = pb.function("work", ["x", "n"])
    work.use_global("c64")
    x2 = work.emit("mul", "x", "c64")
    y, m = work.repeat("body", 3, x2, "n")
    work.build([y, m])

    post = pb.function("post", ["y"])
    z = post.call("check", post.emit("neg", "y"))
    post.build([post.emit("reduce_sum", z, axis=(1,))])

    main = pb.function("main", ["x", "n"])
    y, m = main.call("work", "x", "n")
    s = main.call("post", y)
    s = main.emit("host_print", s, threshold=1e9)
    main.build([main.emit("exp", s), m])
    return pb.build("main")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_lowering_paths_match_reference(scheme):
    rng = np.random.default_rng(3)
    args = [rng.standard_normal((4, 6)), np.arange(4, dtype=np.int64)]
    th = _compare(_mixed_program(JBuilder), _mixed_program(TBuilder), scheme,
                  [args, args])
    if th is not None and scheme in ("tech", "tech-g"):
        # without FCP the unit's call into the host-blocked callee re-enters
        # the guest on every call
        assert th.last_report.host_to_guest > 0


def test_default_backend_is_cuda_and_raises_without_it():
    planned = tmixed.trace(texport(vocab=VOCAB, d_model=DM, max_context=CTX)).plan()
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="CUDA"):
        planned.compile()
    with pytest.raises(ValueError, match="CUDA"):
        planned.compile(backend="cuda")


def test_plan_verify_accepts_sound_and_rejects_forged(monkeypatch):
    """``plan(verify=True)`` runs the analysis layer's soundness verifier: a
    sound plan goes through, a forged compilable set raises
    :class:`PlanVerificationError` with the verifier's RA201."""
    import dataclasses

    import repro_torch.core.api as core_api

    traced = tmixed.trace(texport(vocab=VOCAB, d_model=DM, max_context=CTX))
    for scheme in SCHEMES[1:]:
        traced.plan(scheme, verify=True)
    with pytest.raises(TNativeInfeasible):
        traced.plan("native", verify=True)
    real = core_api.analyze_eligibility

    def forged(program, scheme, **kw):
        analysis = real(program, scheme, **kw)
        return dataclasses.replace(analysis,
                                   compilable=analysis.compilable | {"prefill"})

    monkeypatch.setattr(core_api, "analyze_eligibility", forged)
    with pytest.raises(tmixed.PlanVerificationError) as ei:
        traced.plan("tech-gf", verify=True)
    assert any(d.code == "RA201" for d in ei.value.diagnostics)


def test_deferred_stages_raise_not_implemented():
    """Sharded offload units (``mesh`` / ``arg_specs``) are the one stage of
    the engine not yet ported: asking for them raises, naming the slice."""
    import warnings

    from repro_torch.core import HybridExecutor
    from repro_torch.core.convert import aval_of

    prog = texport(vocab=VOCAB, d_model=DM, max_context=CTX)
    avals = [aval_of(a) for a in _attn_args("prefill")]
    for kw in ({"mesh": object()}, {"arg_specs": (None,)}):
        with pytest.raises(NotImplementedError, match="parallel"), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            HybridExecutor(prog, "tech-gfp", entry_avals=avals, backend="cpu", **kw)


def test_aot_save_load_roundtrip_zero_compiles(tmp_path):
    """``save_aot`` then ``load_aot`` round-trips the attention LM's warm
    plan, and the loaded plan replays the saved calls with zero compiles
    and the same bits, as the reference's does."""
    traced = tmixed.trace(texport(vocab=VOCAB, d_model=DM, max_context=CTX))
    planned = traced.plan("tech-gfp")
    args = _attn_args("prefill")
    warm = planned.compile(backend="cpu")
    outs, report = warm.call_reported(*args)
    assert report.compiles > 0
    summary = planned.save_aot(tmp_path / "cache")
    assert summary["exported_units"] >= 1 and summary["skipped_units"] == 0
    loaded = type(planned).load_aot(tmp_path / "cache").compile(backend="cpu")
    got, report = loaded.call_reported(*args)
    assert report.compiles == 0
    assert loaded.planned.unit_cache.aot_dispatches > 0
    for g, o in zip(got, outs):
        np.testing.assert_array_equal(g, o)
