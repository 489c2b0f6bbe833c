"""Kept outputs: a unit output that no guest op reads stays on the device.

:meth:`~repro_torch.core.offload.OffloadPlan.kept_outputs` marks an output
of a unit the root calls as kept when every use of it in the root is an
operand of a ``call`` to a unit, or a return at an entry-output position
the caller asked for (``call_reported(..., device_returns=...)``).  The
crossing hands it back as a :class:`~repro_torch.core.convert.Resident`
(cloned where it shares an argument's storage); everything else is copied
back as before, and ``kept_bytes`` + ``fetched_bytes`` count every output
byte once.  A sharded plan keeps nothing, nor do the mixed programs, whose
only unit-to-unit value passes the guest's host check.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import mixed
from repro_torch.configs import reduced_config
from repro_torch.core import ProgramBuilder
from repro_torch.core.convert import Resident, aval_of
from repro_torch.models import api
from repro_torch.models.programs import export_attn_decode_lm, export_dense_forward

VOCAB, DM, CTX, B, T = 32, 16, 24, 3, 5


def _attn(scheme="tech-gfp", **kw):
    return mixed.trace(export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=CTX)).plan(
        scheme, **kw)


def _args(root):
    rng = np.random.default_rng(3)
    kv = [rng.standard_normal((B, CTX, DM)).astype(np.float32) for _ in range(2)]
    return {
        "prefill": [rng.integers(0, VOCAB, (B, T), dtype=np.int32)],
        "decode_step": kv + [np.full(B, T, np.int32), np.ones(B, np.int32)],
        "prefill_suffix": kv + [np.array([4, 0, 2], np.int32),
                                rng.integers(0, VOCAB, (B, T), dtype=np.int32)],
        "paged_decode_step": [rng.standard_normal((8, 4, DM)).astype(np.float32)
                              for _ in range(2)]
        + [np.zeros((B, CTX // 4), np.int32), np.full(B, 3, np.int32), np.ones(B, np.int32)],
    }[root]


def _recording(hybrid, args):
    """Wrap every unit of the plan serving ``args`` to record its outputs'
    bytes; returns the list the calls append to."""
    seen = []
    for unit in hybrid.plan_for(*args).units.values():
        call = unit.call

        def wrapped(g, a, t, call=call):
            outs = call(g, a, t)
            seen.append(sum(o.nbytes for o in outs))
            return outs
        unit.call = wrapped
    return seen


@pytest.mark.parametrize("root,returns,kept", [
    ("prefill", (), {}),
    ("prefill", (1, 2), {"prefill#seg0": {1, 2}}),
    ("prefill", (0, 1, 2, 3), {"prefill#seg0": {1, 2, 3}, "prefill#seg1": {0}}),
    ("decode_step", (), {}),
    ("decode_step", (1, 2), {"decode_step#seg0": {1, 2}}),
    # the recomputed K/V reach only the second segment: kept unasked
    ("prefill_suffix", (), {"prefill_suffix#seg0": {1, 2}}),
    ("prefill_suffix", (1, 2), {"prefill_suffix#seg0": {1, 2},
                                "prefill_suffix#seg1": {1, 2}}),
    ("paged_decode_step", (), {}),
    ("paged_decode_step", (1, 2), {"paged_decode_step#seg0": {1, 2}}),
])
def test_which_outputs_each_root_keeps(root, returns, kept):
    hybrid = _attn().for_entry(root).compile(backend="cpu")
    plan = hybrid.plan_for(*_args(root))
    assert plan.kept_outputs(returns) == {f: frozenset(js) for f, js in kept.items()}


@pytest.mark.parametrize("root", ["prefill", "decode_step", "prefill_suffix",
                                  "paged_decode_step"])
def test_kept_and_fetched_bytes_count_every_output_once(root):
    """The guest-read hidden rows (``h``, before the host check) are fetched
    even when every return is asked for; the asked returns come back
    resident, bitwise equal to the numpy call's; kept + fetched bytes equal
    the bytes the units returned."""
    hybrid = _attn().for_entry(root).compile(backend="cpu")
    args = _args(root)
    want, plain = hybrid.call_reported(*args)
    seen = _recording(hybrid, args)
    n = len(want)
    got, rep = hybrid.call_reported(*args, device_returns=range(n))
    assert rep.kept_bytes + rep.fetched_bytes == sum(seen) > 0
    assert plain.kept_bytes + plain.fetched_bytes == sum(seen)
    assert rep.fetched_bytes == B * DM * 4          # h alone
    assert all(isinstance(g, Resident) for g in got)
    for g, w in zip(got, want):
        assert isinstance(w, np.ndarray)
        assert np.array_equal(g.tensor.numpy(), w)
    # the crossings and the bytes they place are the same either way
    assert (rep.guest_to_host, rep.placed_bytes) == (plain.guest_to_host, plain.placed_bytes)


def test_a_guest_read_output_is_fetched():
    """``prefill``'s first segment returns (h, K, V, len): h feeds the host
    check, so it crosses back as numpy whatever the caller asks."""
    hybrid = _attn().compile(backend="cpu")
    args = _args("prefill")
    state = hybrid.state_for([aval_of(a) for a in args])
    assert state.plan.program.functions["prefill"].ops[1].kind == "host_assert_finite"
    assert state.kept_for(frozenset(range(4)))["prefill#seg0"] == frozenset({1, 2, 3})
    outs, rep = hybrid.call_reported(*args, device_returns={1, 2})
    # h (B, D), the logits (B, V) and the length vector (B,) come back as bytes
    assert rep.fetched_bytes == B * DM * 4 + B * VOCAB * 4 + B * 4
    assert isinstance(outs[0], np.ndarray) and isinstance(outs[3], np.ndarray)
    assert isinstance(outs[1], Resident) and isinstance(outs[2], Resident)


def test_a_sharded_plan_keeps_nothing():
    """Under a mesh a resident cannot cross in, so nothing is kept, asked
    for or not (the plan is only built here: no world is needed)."""
    mesh = types.SimpleNamespace(shape={"data": 2}, axis_names=("data",),
                                 device=torch.device("cpu"))
    hybrid = _attn(mesh=mesh).for_entry("prefill_suffix").compile(backend="cpu")
    state = hybrid.state_for([aval_of(a) for a in _args("prefill_suffix")])
    assert state.plan.kept_outputs((1, 2))            # the unsharded analysis would keep
    assert state.kept_for(frozenset()) == {} == state.kept_for(frozenset({1, 2}))


def test_the_dense_forward_keeps_nothing():
    """``export_dense_forward``: the backbone's only output goes through
    the guest's host check before the head, so every byte is fetched, as
    ``MixedServer`` (which asks for no return on the device) always had."""
    cfg = dataclasses.replace(reduced_config("smollm-360m"), compute_dtype="float32",
                              d_model=64, d_ff=128, n_layers=2)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=2, device="cpu")
    prog, (tokens,) = export_dense_forward(cfg, params, 2, 8, tp=2)
    hybrid = mixed.trace(prog).plan("tech-gfp").compile(backend="cpu")
    assert hybrid.plan_for(tokens).kept_outputs() == {}
    seen = _recording(hybrid, [tokens])
    outs, rep = hybrid.call_reported(tokens)
    assert rep.kept_bytes == 0 and rep.fetched_bytes == sum(seen) > 0
    assert all(isinstance(o, np.ndarray) for o in outs)


def test_the_hybrid_forward_keeps_nothing():
    """``export_hybrid_forward`` (the tiny Granite 4.0-H layout of its own
    tests): the same contract, so nothing is kept."""
    from test_torch_hybrid_forward import _tiny

    *_, prog, tokens = _tiny()
    hybrid = mixed.trace(prog).plan("tech-gfp").compile(backend="cpu")
    plan = hybrid.plan_for(tokens)
    assert plan.kept_outputs() == {}
    outs, rep = hybrid.call_reported(tokens)
    assert rep.kept_bytes == 0 and rep.fetched_bytes > 0


def _passthrough():
    """``main(x, b) = (x2, check(y))`` with ``f(x, b) = (x, tanh(x @ W + b))``:
    the unit hands its first argument straight back."""
    pb = ProgramBuilder("passthrough")
    pb.constant("W", np.eye(4, dtype=np.float32))
    f = pb.function("f", ["x", "b"])
    f.use_global("W")
    f.build(["x", f.emit("tanh", f.emit("add", f.emit("matmul", "x", "W"), "b"))])
    main = pb.function("main", ["x0", "b0"])
    x2, y = main.call("f", "x0", "b0")
    main.build([x2, main.emit("host_print", y, threshold=1e6, fmt="overflow {}")])
    return pb.build("main")


def test_a_kept_output_that_aliases_an_argument_is_a_clone():
    hybrid = mixed.trace(_passthrough()).plan("tech-gfp").compile(backend="cpu")
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    b = np.zeros((2, 4), np.float32)
    (x2, _), rep = hybrid.call_reported(Resident(x), b, device_returns={0})
    assert isinstance(x2, Resident)
    assert x2.tensor.data_ptr() != x.data_ptr()
    assert torch.equal(x2.tensor, x)
    # a numpy argument placed on the CPU shares the caller's memory: cloned too
    xn = x.numpy().copy()
    (x3, _), _ = hybrid.call_reported(xn, b, device_returns={0})
    x3.tensor.add_(1)
    assert np.array_equal(xn, x.numpy())
    assert rep.kept_bytes == x.nbytes


def test_a_guest_op_given_a_kept_output_raises():
    """A kept output is a Resident: no numpy view of it, and a guest leaf
    op given one names itself."""
    hybrid = _attn().compile(backend="cpu")
    outs, _ = hybrid.call_reported(*_args("prefill"), device_returns={1})
    with pytest.raises(TypeError, match="never copied back"):
        np.asarray(outs[1])
    step = _attn("qemu").for_entry("decode_step").compile(backend="cpu")
    args = _args("decode_step")
    with pytest.raises(TypeError, match="guest op"):
        step(outs[1], *args[1:])


def test_device_returns_outside_the_outputs_raise():
    hybrid = _attn().compile(backend="cpu")
    with pytest.raises(ValueError, match="outside its 4 outputs"):
        hybrid.call_reported(*_args("prefill"), device_returns={4})
