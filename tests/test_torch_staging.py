"""One device copy of each program constant for a compiled program
(``core/convert.py:StagedConstants``): the GRT's plans of every unit and
every entry signature share it, a constant replaced in the program is
placed anew, and the baseline scheme (no GRT) still places the globals on
every crossing, as the paper's baseline does."""
import numpy as np
import pytest
import torch

from repro_torch import mixed
from repro_torch.core.program import ProgramBuilder
from repro_torch.models.programs import load_reference_constants

WIDTH = 16


def build_program(scale: float = 1.0):
    """Two units reading the weight W (one before and one after the host
    check, so PFO splits ``main`` around it) and one reading V."""
    rng = np.random.default_rng(0)
    pb = ProgramBuilder("staging-test")
    pb.constant("W", (scale * rng.standard_normal((WIDTH, WIDTH)) / 4).astype(np.float32))
    pb.constant("V", (scale * rng.standard_normal((WIDTH,))).astype(np.float32))
    f = pb.function("f", ["x"])
    f.use_global("W")
    f.build([f.emit("tanh", f.emit("matmul", "x", "W"))])
    g = pb.function("g", ["x"])
    g.use_global("W")
    g.use_global("V")
    g.build([g.emit("add", g.emit("matmul", "x", "W"), "V")])
    m = pb.function("main", ["x"])
    y = m.emit("host_assert_finite", m.call("f", "x"), tag="staging")
    m.build([m.call("g", y)])
    return pb.build("main")


def rows(n: int) -> np.ndarray:
    return np.random.default_rng(n).standard_normal((n, WIDTH)).astype(np.float32)


def plans(hybrid):
    """Every GRT plan of every signature: {(signature rows, unit): plan}."""
    out = {}
    for sig, state in hybrid._states.items():
        for (fname, _), plan in state._grt._table.items():
            out[(sig[0].shape[0], fname)] = plan
    return out


def staged(plan, name):
    return plan.staged_globals[plan.global_names.index(name)]


def _compiled(device, scheme="tech-gfp", prog=None):
    return mixed.trace(prog or build_program()).plan(scheme).compile(backend=device)


def _two_signatures_share_the_globals(device):
    hybrid = _compiled(device)
    for n in (1, 2):
        hybrid(rows(n))
    by_key = plans(hybrid)
    units = {f for _, f in by_key}
    assert {1, 2} == {n for n, _ in by_key} and len(units) >= 2
    w = [staged(p, "W") for p in by_key.values() if "W" in p.global_names]
    assert len(w) >= 4                      # W in two units' plans, at two signatures
    assert all(t is w[0] for t in w)
    assert len({t.data_ptr() for t in w}) == 1
    assert hybrid.staged.placements == 2    # W and V, once each
    return hybrid


def test_two_bucket_signatures_share_their_globals():
    _two_signatures_share_the_globals("cpu")


def test_replaced_constants_are_placed_anew():
    """``load_reference_constants`` after staging, into the program that
    every signature's plans read: a signature planned afterwards places the
    new arrays and answers as a program exported with them does; the plans
    built before keep theirs."""
    hybrid = _compiled("cpu")
    hybrid(rows(1))
    old_w = staged(plans(hybrid)[(1, "main#seg1")], "W")
    new = build_program(scale=2.0)
    load_reference_constants(hybrid.planned.analysis.program, new.constants)
    got = hybrid(rows(2))
    assert hybrid.staged.placements == 4
    fresh = staged(plans(hybrid)[(2, "main#seg1")], "W")
    assert fresh is not old_w
    np.testing.assert_array_equal(fresh.numpy(), new.constants["W"])
    want = _compiled("cpu", prog=new)(rows(2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_the_baseline_places_globals_on_every_crossing():
    hybrid = _compiled("cpu", scheme="tech")
    assert not hybrid.scheme.grt
    _, rep = hybrid.call_reported(rows(1))
    _, rep2 = hybrid.call_reported(rows(1))
    assert rep2.conversion_builds == rep.conversion_builds > 0
    assert hybrid.staged.placements == 0


@pytest.mark.gpu
def test_two_bucket_signatures_share_their_globals_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    hybrid = _two_signatures_share_the_globals("cuda")
    w = [staged(p, "W") for p in plans(hybrid).values() if "W" in p.global_names]
    assert w[0].is_cuda
