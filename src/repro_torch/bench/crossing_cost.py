"""Crossing-cost decomposition (the paper's §4.2 first observation).

The paper attributes crossing cost to "the internal works of QEMU,
including system call handling, context switching" rather than argument
conversion.  This microbenchmark decomposes the port's crossing into its
parts — plan construction (what GRT caches), guest→host placement of the
arguments, the offload unit's dispatch and execution, the host→guest copy
of the results, and the host→guest→host callback round trip — beside one
whole crossing of a compiled program, so the GRT/FCP effect sizes of
figs. 4-5 are explained by measured constants.  Every part is timed with
the device synchronised, so device work is inside the time.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import ProgramBuilder
from ..core.api import resolve_device
from ..core.convert import aval_of, build_plan, place
from ..core.program import abstract_eval
from ..core.reentrancy import emit_guest_callback
from .common import compile_scheme, csv_row

SIZES = (64, 512)


def _timer(device: torch.device):
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def timed(f, n=50) -> float:
        """Mean seconds of ``f`` over ``n`` calls, each ending in a device sync."""
        f()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
            sync()
        return (time.perf_counter() - t0) / n

    return timed


def sample_program(n: int):
    """``main`` calls ``f(x) = tanh(x @ W)`` once: one crossing a call."""
    pb = ProgramBuilder("xc")
    W = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    pb.constant("W", W)
    f = pb.function("f", ["x"])
    f.use_global("W")
    y = f.emit("matmul", "x", "W")
    y = f.emit("tanh", y)
    f.build([y])
    m = pb.function("main", ["x0"])
    o = m.call("f", "x0")
    m.build([o])
    return pb.build("main"), np.random.default_rng(1).standard_normal((8, n)).astype(np.float32)


def measure(*, device=None, sizes=SIZES, n: int = 50) -> dict[int, dict[str, float]]:
    """{size: {part: seconds}} for the sample program at each ``size``."""
    dev = resolve_device(device)
    timed = _timer(dev)
    out = {}
    for size in sizes:
        prog, x = sample_program(size)
        avals = (aval_of(x),)
        out_avals, _ = abstract_eval(prog, "f", avals)
        hybrid = compile_scheme(prog, "tech-g", device=dev)
        hybrid(x)                                   # builds the unit
        unit = hybrid.plan_for(x).units["f"]
        plan = build_plan(prog, "f", avals, out_avals, ("W",), device=dev,
                          compute_dtype="float32")
        dev_x = plan.convert_in([x])
        token = np.int32(0)                         # f never re-enters the guest
        y = unit.call(plan.staged_globals, dev_x, token)

        def echo(_token, _callee, args):            # the guest side of a callback
            return (np.asarray(args[0]) * np.float32(1.0),)

        parts = {
            "plan_build(GRT-cached)": timed(lambda: build_plan(
                prog, "f", avals, out_avals, ("W",), device=dev,
                compute_dtype="float32"), n),
            "convert_in(place)": timed(lambda: place(x, dev), n),
            "unit_dispatch+exec": timed(
                lambda: unit.call(plan.staged_globals, dev_x, token), n),
            "convert_out(to_host)": timed(lambda: plan.convert_out(y), n),
            "callback_roundtrip": timed(lambda: emit_guest_callback(
                echo, prog, "f", y, token, dev), n),
            "whole_crossing(tech-g)": timed(lambda: hybrid(x), n),
        }
        tech = compile_scheme(prog, "tech", device=dev)
        parts["whole_crossing(tech)"] = timed(lambda: tech(x), n)
        out[size] = parts
    return out


def rows(parts: dict[int, dict[str, float]]) -> list[str]:
    out = []
    for size, ps in parts.items():
        for part, secs in ps.items():
            derived = f"globals={size}x{size}f32" if part.startswith("plan_build") else ""
            out.append(csv_row(f"crossing/n{size}/{part}", secs * 1e6, derived))
    return out


def run(scale: str = "bench", *, device=None):
    return rows(measure(device=device))


if __name__ == "__main__":
    for r in run():
        print(r)
