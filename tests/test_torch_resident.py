"""Resident guest values: a tensor already on the unit's device crosses by
reference.

A :class:`~repro_torch.core.convert.Resident` argument reaches the unit as
the same storage, counts in ``resident_bytes`` and not in ``placed_bytes``,
keys the same signature (so the same plan and GRT entry) as a numpy array of
its shape, and the result equals the numpy call's bit for bit.  The guest
never reads one: a leaf op given one raises, and so does a crossing to a
unit on another device, in another float dtype or under a mesh.
"""
import numpy as np
import pytest
import torch

from repro_torch import mixed
from repro_torch.core import ProgramBuilder
from repro_torch.core.convert import ConversionPlan, Resident, aval_of, signature_of

CPU = torch.device("cpu")


def program(host_check: bool = True):
    """``main(x, b) = dense(x, b)`` (then a host print when ``host_check``),
    ``dense(x, b) = tanh(x @ W + b)``."""
    pb = ProgramBuilder("resident")
    pb.constant("W", (np.random.default_rng(0).standard_normal((16, 16)) / 4
                      ).astype(np.float32))
    dense = pb.function("dense", ["x", "b"])
    dense.use_global("W")
    dense.build([dense.emit("tanh", dense.emit("add", dense.emit("matmul", "x", "W"), "b"))])
    main = pb.function("main", ["x0", "b0"])
    h = main.call("dense", "x0", "b0")
    if host_check:
        h = main.emit("host_print", h, threshold=1e6, fmt="overflow {}")
    main.build([h])
    return pb.build("main")


def args():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((4, 16)).astype(np.float32),
            rng.standard_normal((4, 16)).astype(np.float32))


def test_a_resident_argument_reaches_the_unit_as_the_same_storage():
    hybrid = mixed.trace(program()).plan("tech-gfp").compile(backend="cpu")
    x, b = args()
    (want,), first = hybrid.call_reported(x, b)
    r = Resident(torch.from_numpy(x.copy()))
    seen = []
    for unit in hybrid.plan_for(x, b).units.values():
        call = unit.call
        unit.call = lambda g, a, t, call=call: seen.append(a[0].data_ptr()) or call(g, a, t)
    (got,), rep = hybrid.call_reported(r, b)
    assert seen == [r.tensor.data_ptr()]
    assert np.array_equal(got, want)
    assert (rep.resident_bytes, rep.placed_bytes) == (x.nbytes, b.nbytes)
    assert (first.resident_bytes, first.placed_bytes) == (0, x.nbytes + b.nbytes)
    # the numpy call's plan and GRT entry serve it
    assert rep.cache_hits == 1 and hybrid.replans == 1
    assert rep.conversion_builds == 0 and rep.grt_hits == rep.guest_to_host == 1


def test_a_resident_keys_the_numpy_signature():
    x = np.zeros((3, 5), np.float32)
    r = Resident(torch.zeros(3, 5))
    assert aval_of(r) == aval_of(x)
    assert signature_of([r, np.int32(2)]) == signature_of([x, np.int32(2)])
    assert (r.shape, r.dtype, r.nbytes) == (x.shape, x.dtype, x.nbytes)


@pytest.mark.parametrize("scheme", ["qemu", "tech-g", "tech-gfp"])
def test_a_guest_leaf_op_given_a_resident_raises(scheme):
    """Where ``dense`` is interpreted (``qemu``), its first leaf op names
    itself; where it is a unit, the crossing takes the handle."""
    hybrid = mixed.trace(program()).plan(scheme).compile(backend="cpu")
    x, b = args()
    r = Resident(torch.from_numpy(x.copy()))
    if scheme == "qemu":
        with pytest.raises(TypeError, match="guest op 'matmul'"):
            hybrid(r, b)
    else:
        np.testing.assert_array_equal(hybrid(r, b)[0], hybrid(x, b)[0])


def test_a_resident_is_never_read_as_a_numpy_array():
    with pytest.raises(TypeError, match="never copied back"):
        np.asarray(Resident(torch.zeros(2)))
    with pytest.raises(TypeError, match="canonical dtype"):
        Resident(torch.zeros(2, dtype=torch.float64))


def _plan(**kw):
    base = dict(fname="f", arg_avals=(), out_avals=(), global_names=(), staged_globals=(),
                device=CPU, compute_dtype="float32")
    return ConversionPlan(**{**base, **kw})


@pytest.mark.parametrize("case", ["device", "mesh", "dtype"])
def test_a_resident_that_cannot_cross_by_reference_raises(case):
    """On another device, under a mesh, or in another float dtype than the
    unit computes in: never a copy."""
    t = torch.zeros(2, 3, device="meta" if case == "device" else "cpu")
    plan = _plan(mesh=object() if case == "mesh" else None,
                 compute_dtype="float16" if case == "dtype" else "float32")
    match = {"device": "by reference only", "mesh": "sharded", "dtype": "compute dtype"}
    with pytest.raises(ValueError, match=match[case]):
        plan.convert_in([Resident(t)])


def test_convert_in_passes_a_resident_and_places_the_rest():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    a = np.ones((2, 3), np.float64)
    got = _plan().convert_in([Resident(t), a])
    assert got[0] is t
    assert got[1].dtype == torch.float32 and got[1].data_ptr() != a.ctypes.data


@pytest.mark.parametrize("scheme,host_check,want", [
    ("tech-gfp", True, True),     # the root's first segment is a unit
    ("tech-gf", True, True),      # dense is a unit the root calls
    ("native", False, True),      # the root is a unit itself
    ("qemu", True, False),        # nothing is a unit
])
def test_units_only_read(scheme, host_check, want):
    hybrid = mixed.trace(program(host_check)).plan(scheme).compile(backend="cpu")
    plan = hybrid.plan_for(*args())
    assert plan.units_only_read([0]) is want
    assert plan.units_only_read([0, 1]) is want


def test_units_only_read_refuses_a_guest_use_and_a_return():
    pb = ProgramBuilder("mixed_use")
    f = pb.function("f", ["x"])
    f.build([f.emit("tanh", "x")])
    main = pb.function("main", ["x", "y"])
    main.build([main.emit("host_print", main.call("f", "x"), threshold=1e6, fmt="{}"),
                main.emit("add", "x", "x"), "y"])
    hybrid = mixed.trace(pb.build("main")).plan("tech-gf").compile(backend="cpu")
    x = np.ones((2, 2), np.float32)
    plan = hybrid.plan_for(x, x)
    assert "f" in plan.units
    assert not plan.units_only_read([0])      # the guest's add reads x
    assert not plan.units_only_read([1])      # y is returned
