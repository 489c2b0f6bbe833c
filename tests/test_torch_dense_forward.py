"""The port's ``export_dense_forward`` against the reference's, scheme by scheme.

The reduced dense configs export with the same weights (the reference's,
carried by ``load_reference_params``): the port's Program has the same
constant names, order and values as the reference's export.  Under all six
schemes the mixed run agrees with the reference's to the engine tolerance
(2e-3/2e-4, ``tests/test_core_engine.py``), and the counters that do not
depend on the framework — crossings, reentries, conversion builds,
compiles, GRT hits, coverage — are equal.  ``native`` is refused with the
host check (the paper's printf case) and runs without it.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch import mixed as tmixed
from repro_torch.configs import reduced_config
from repro_torch.core import NativeInfeasibleError as TNativeInfeasible
from repro_torch.models import api
from repro_torch.models.programs import export_dense_forward, load_reference_constants

TP = 2
SCHEMES = ["native", "qemu", "tech", "tech-g", "tech-gf", "tech-gfp"]
COUNTERS = ("guest_to_host", "host_to_guest", "conversion_builds", "compiles",
            "grt_hits", "guest_calls", "guest_ops", "nested_crossings",
            "max_reentry_depth", "max_interleave_depth")


def _exports(arch, *, with_host_check=True, batch=2, seq=8):
    import jax
    from repro.configs import reduced_config as jreduced
    from repro.models import api as japi
    from repro.models.programs import export_dense_forward as jexport

    jcfg = dataclasses.replace(jreduced(arch), compute_dtype="float32")
    jparams = japi.init(jcfg, jax.random.PRNGKey(0), tp=TP)
    jprog, jargs = jexport(jcfg, jparams, batch, seq, with_host_check=with_host_check, tp=TP)
    cfg = dataclasses.replace(reduced_config(arch), compute_dtype="float32")
    params = api.load_reference_params(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), tp=TP, device="cpu")
    tprog, targs = export_dense_forward(cfg, params, batch, seq,
                                       with_host_check=with_host_check, tp=TP)
    return jprog, jargs, tprog, targs


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-1.5b"])
def test_constants_equal_reference_export(arch):
    jprog, jargs, tprog, targs = _exports(arch)
    assert list(tprog.constants) == list(jprog.constants)
    for name, value in jprog.constants.items():
        mine = tprog.constants[name]
        assert mine.dtype == value.dtype and mine.shape == value.shape, name
        np.testing.assert_array_equal(mine, value, err_msg=name)
    assert sorted(tprog.functions) == sorted(jprog.functions)
    for fname, fn in jprog.functions.items():
        assert [op.kind for op in tprog.functions[fname].ops] == [op.kind for op in fn.ops]
    np.testing.assert_array_equal(targs[0], jargs[0])
    # the carried constants install on the port's own export unchanged
    load_reference_constants(tprog, jprog.constants)


def _run_both(jprog, tprog, scheme, args):
    from repro import mixed as jmixed
    from repro.core import NativeInfeasibleError as JNativeInfeasible

    try:
        jh = jmixed.trace(jprog).plan(scheme).compile()
    except JNativeInfeasible:
        with pytest.raises(TNativeInfeasible):
            tmixed.trace(tprog).plan(scheme)
        return False
    th = tmixed.trace(tprog).plan(scheme).compile(backend="cpu")
    for call in range(2):          # the second call hits the caches
        jo, jr = jh.call_reported(*args)
        to, tr = th.call_reported(*args)
        assert len(jo) == len(to) == 2
        for a, b in zip(jo, to):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4)
        for f in COUNTERS:
            assert getattr(tr, f) == getattr(jr, f), (scheme, call, f)
        assert dict(tr.per_function_crossings) == dict(jr.per_function_crossings)
        jplan, tplan = jh.plan_for(*args), th.plan_for(*args)
        assert tplan.coverage.as_dict() == jplan.coverage.as_dict()
        assert sorted(tplan.units) == sorted(jplan.units)
        assert tplan.decisions == jplan.decisions
    return True


@pytest.mark.parametrize("scheme", SCHEMES)
def test_mixed_run_matches_reference(scheme):
    jprog, jargs, tprog, _ = _exports("smollm-360m")
    ran = _run_both(jprog, tprog, scheme, jargs)
    assert ran == (scheme != "native")      # the host check blocks native


def test_native_runs_without_the_host_check():
    jprog, jargs, tprog, _ = _exports("llama3.2-1b", with_host_check=False)
    assert _run_both(jprog, tprog, "native", jargs)
    th = tmixed.trace(tprog).plan("native").compile(backend="cpu")
    _, rep = th.call_reported(*jargs)
    assert rep.guest_to_host == 1            # one region, one crossing


def test_mixed_logits_equal_the_model():
    """The exported program computes the model's teacher-forcing logits."""
    import jax
    from repro.configs import reduced_config as jreduced
    from repro.models import api as japi

    cfg = dataclasses.replace(reduced_config("smollm-360m"), compute_dtype="float32")
    jparams = japi.init(dataclasses.replace(jreduced("smollm-360m"),
                                            compute_dtype="float32"),
                        jax.random.PRNGKey(0), tp=TP)
    params = api.load_reference_params(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), tp=TP, device="cpu")
    prog, (tokens,) = export_dense_forward(cfg, params, 3, 12, tp=TP)
    logits, mx = tmixed.trace(prog).plan("tech-gfp").compile(backend="cpu")(tokens)
    want = api.logits(cfg, params, {"tokens": tokens}, tp=TP).numpy()
    np.testing.assert_allclose(logits, want, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(mx, want.max(axis=2), rtol=2e-3, atol=2e-4)


def test_export_refuses_other_families():
    cfg = reduced_config("dbrx-132b")
    with pytest.raises(ValueError, match="dense"):
        export_dense_forward(cfg, {}, 1, 4, tp=TP)
