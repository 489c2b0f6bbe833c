"""CI smoke gate: every scheme through the staged API in a few seconds.

Runs the quickstart-shaped program (offloadable dense block, hot loop,
host-only safety check) under every execution scheme via
``mixed.trace(...).plan(...).compile()`` and asserts the paper's invariants:

* ``native`` is infeasible (all-or-nothing wall), detected at plan time;
* all runnable schemes agree with pure emulation;
* guest→host crossing counts are monotone non-increasing along the
  ablation ``tech → tech-g → tech-gf → tech-gfp``;
* one CompiledHybrid serves two entry signatures (two plans, then cache hits).

The units run on the CUDA card unless ``--device cpu`` is given; without a
card and without it the gate raises.  Failures print the measured numbers
before exiting non-zero.  Exit status is the verdict:

    PYTHONPATH=src python -m repro_torch.bench.smoke [--device cpu]
"""
from __future__ import annotations

import numpy as np

from .. import mixed
from ..core import ProgramBuilder
from ..core.api import resolve_device
from .common import GateFailure, check, finish_gate, gate_main

SWEEP = ["qemu", "tech", "tech-g", "tech-gf", "tech-gfp"]
ABLATION = ["tech", "tech-g", "tech-gf", "tech-gfp"]
# the program holds no kernel op (matmul, tanh, mul): no kernel is on this path
KERNELS: tuple[str, ...] = ()


def build_program():
    pb = ProgramBuilder("smoke")
    W = (np.random.default_rng(0).standard_normal((96, 96)) / 10).astype(np.float32)
    pb.constant("W", W)

    dense = pb.function("dense", ["x"])      # offloadable library function
    dense.use_global("W")
    h = dense.emit("matmul", "x", "W")
    h = dense.emit("tanh", h)
    dense.build([h])

    step = pb.function("step", ["x"])        # hot-loop body
    y = step.call("dense", "x")
    z = step.emit("mul", y, y)
    step.build([z])

    main = pb.function("main", ["x0"])
    out = main.repeat("step", 25, "x0")      # hot loop
    chk = main.emit("host_print", out, threshold=1e6,
                    fmt="overflow {}")       # host-only safety check (printf)
    s = main.emit("reduce_sum", chk, axis=(0, 1))
    main.build([s])
    x0 = np.random.default_rng(1).standard_normal((8, 96)).astype(np.float32)
    return pb.build("main"), x0


def run(device=None, *, rows: list | None = None) -> list[str]:
    resolve_device(device)
    rows = [] if rows is None else rows
    prog, x0 = build_program()
    traced = mixed.trace(prog)

    # all-or-nothing wall: plan-time failure, no arguments involved
    try:
        traced.plan("native")
    except mixed.NativeInfeasibleError:
        rows.append("smoke/native,nan,infeasible(all-or-nothing)=ok")
    else:
        raise GateFailure("native plan unexpectedly succeeded")

    crossings: dict[str, int] = {}
    ref = None
    for scheme in SWEEP:
        hybrid = traced.plan(scheme).compile(backend=device)
        out = hybrid(x0)
        if ref is None:
            ref = out[0]
        check(np.allclose(out[0], ref, rtol=1e-4),
              f"{scheme} diverged from qemu",
              f"max |delta| = {np.max(np.abs(out[0] - ref))}")
        rep = hybrid.last_report
        crossings[scheme] = rep.guest_to_host
        rows.append(f"smoke/{scheme},{rep.wall_seconds*1e6:.1f},"
                    f"g2h={rep.guest_to_host};replans={rep.replans}")

    # the gate: crossings monotone non-increasing along the ablation
    for a, b in zip(ABLATION, ABLATION[1:]):
        check(crossings[a] >= crossings[b],
              f"crossing regression: {a}={crossings[a]} < {b}={crossings[b]}",
              f"full sweep: {crossings}")

    # signature polymorphism: a second batch size reuses the compiled object
    hybrid = traced.plan("tech-gfp").compile(backend=device)
    hybrid(x0)
    hybrid(x0[:4])
    check(hybrid.replans == 2 and not hybrid.last_report.cache_hit,
          f"expected 2 plans and a cache miss, got replans={hybrid.replans} "
          f"cache_hit={hybrid.last_report.cache_hit}")
    hybrid(x0[:4])
    check(hybrid.replans == 2 and hybrid.last_report.cache_hit,
          f"expected a signature-cache hit, got replans={hybrid.replans} "
          f"cache_hit={hybrid.last_report.cache_hit}")
    rows.append(f"smoke/polymorphic,nan,replans={hybrid.replans};cache_hit=ok")
    finish_gate(rows, "smoke", device, KERNELS)
    return rows


def main(argv=None) -> int:
    return gate_main("SMOKE", "smoke", run, 30, argv)


if __name__ == "__main__":
    raise SystemExit(main())
