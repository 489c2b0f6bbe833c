"""Quickstart: the paper's mechanism through the staged frontend.

The API mirrors the paper's phase split as four explicit stages:

    traced  = mixed.trace(program)        # compile-time: validate + call graph
    planned = traced.plan("tech-gfp")     # compile-time: eligibility, PFO
    hybrid  = planned.compile()           # a callable; units on the CUDA card
    out     = hybrid(*args)               # run-time: plans cached per signature

``hybrid`` infers entry signatures from the actual arguments, so one
compiled object serves many shapes — each new signature plans once, later
calls hit the cache.  Every call yields a per-call ``ExecutionReport``
(``hybrid.last_report``); ``with mixed.instrument() as rec:`` aggregates
reports across calls.

This demo builds a tiny "guest program" with a host-only safety check (the
paper's printf case), runs it under every execution scheme, and prints the
paper's three headline effects: all-or-nothing failure of complete
cross-compilation (a *plan-time* error), crossing collapse from FCP+PFO,
and identical results everywhere — plus the staged API's fourth effect:
signature-polymorphic plan caching.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import mixed
from ..core import ProgramBuilder
from ..core.api import resolve_device

SCHEMES = ["qemu", "tech", "tech-g", "tech-gf", "tech-gfp"]
BATCHES = (8, 8, 4, 4, 8)


def build_program():
    pb = ProgramBuilder("quickstart")
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
    out = main.repeat("step", 50, "x0")      # hot loop: 50 iterations
    chk = main.emit("host_print", out, threshold=1e6,
                    fmt="overflow {}")       # host-only safety check (printf)
    s = main.emit("reduce_sum", chk, axis=(0, 1))
    main.build([s])
    x0 = np.random.default_rng(1).standard_normal((8, 96)).astype(np.float32)
    return pb.build("main"), [x0]


def run(device=None) -> dict:
    """Print the demo; returns ``{"schemes": {scheme: counters and
    coverage}, "plans": n, "cache_hits": n, "calls": n}``."""
    resolve_device(device)
    prog, args = build_program()
    traced = mixed.trace(prog)

    print("== complete cross-compilation (the all-or-nothing paradigm) ==")
    try:
        traced.plan("native")                # fails at PLAN time — no args needed
    except mixed.NativeInfeasibleError as e:
        print(f"  native plan FAILED (as in the paper): {e}\n")

    print("== mixed execution (TECH-NAME) ==")
    ref = None
    schemes = {}
    for scheme in SCHEMES:
        hybrid = traced.plan(scheme).compile(backend=device)
        out = hybrid(*args)
        if ref is None:
            ref = out[0]
        assert np.allclose(out[0], ref, rtol=1e-4), scheme
        r = hybrid.last_report
        cov = hybrid.last_plan.coverage
        schemes[scheme] = {"guest_to_host": r.guest_to_host,
                           "host_to_guest": r.host_to_guest,
                           "conversion_builds": r.conversion_builds,
                           "grt_hits": r.grt_hits,
                           "coverage": (cov.offloaded_functions, cov.total_functions)}
        print(f"  {scheme:9s} guest->host={r.guest_to_host:4d}  "
              f"host->guest={r.host_to_guest:3d}  "
              f"conv_builds={r.conversion_builds:4d}  grt_hits={r.grt_hits:4d}  "
              f"coverage={cov.offloaded_functions}/{cov.total_functions}")

    print("\n== one compiled object, many entry signatures ==")
    hybrid = traced.plan("tech-gfp").compile(backend=device)
    with mixed.instrument() as rec:
        for batch in BATCHES:
            hybrid(args[0][:batch])
    agg = rec.merged()
    print(f"  {agg.calls} calls over batches (8,8,4,4,8): "
          f"{hybrid.replans} plans built, {agg.cache_hits} cache hits")

    print("\nall schemes agree; FCP+PFO collapse the crossings exactly as in "
          "the paper's Fig. 5.")
    return {"schemes": schemes, "plans": hybrid.replans,
            "cache_hits": agg.cache_hits, "calls": agg.calls}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="unit device: omit for the CUDA card, 'cpu' for the CPU")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
