"""The paper-figure harness of the port: one module per table or figure.

    python -m repro_torch.bench.run                      # on the CUDA card
    python -m repro_torch.bench.run --device cpu --scale test

Prints ``name,us_per_call,derived`` CSV on standard output, and on standard
error each section's wall time and what the units ran on.  Without a card
(and without ``--device cpu``) it raises before any section runs.  Figs. 4-6 read
one sweep of the 17 workloads under the six schemes.  A section that fails
prints ``# <section> FAILED: ...`` to standard error; the others still run,
and the exit status is then 1.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from . import (
    beyond_profile,
    crossing_cost,
    fig4_speedup,
    fig5_invocations,
    fig6_coverage,
    fig7_reverse,
    table3_library,
)
from .common import device_label, sweep_workloads


def sections(scale: str, device, repeats: int):
    sweep = {}

    def workloads():
        sweep.update(sweep_workloads(scale, device=device, repeats=repeats))
        return []

    return [
        ("sweep (17 workloads x 6 schemes)", workloads),
        ("fig4 (speedup ablation)", lambda: fig4_speedup.rows(sweep)),
        ("fig5 (crossing counts)", lambda: fig5_invocations.rows(sweep)),
        ("fig6 (offload coverage)", lambda: fig6_coverage.rows(sweep)),
        ("fig7 (model-program class)",
         lambda: fig7_reverse.rows(fig7_reverse.sweep(scale, device=device,
                                                      repeats=repeats))),
        ("table3 (library offloading)",
         lambda: table3_library.rows(table3_library.sweep(scale, device=device,
                                                          repeats=repeats))),
        ("beyond-paper (profile-guided offloading)",
         lambda: beyond_profile.rows(beyond_profile.sweep(scale, device=device,
                                                          repeats=repeats))),
        ("crossing-cost decomposition",
         lambda: crossing_cost.rows(crossing_cost.measure(device=device))),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of the offload units (default: the CUDA card; 'cpu')")
    ap.add_argument("--scale", choices=("test", "bench"), default="bench")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed calls after each cold call (the best is kept)")
    args = ap.parse_args(argv)

    print(f"# units on: {device_label(args.device)}; scale {args.scale}", file=sys.stderr)
    print("name,us_per_call,derived")
    failed = []
    for title, fn in sections(args.scale, args.device, args.repeats):
        t0 = time.time()
        try:
            rows = fn()
        except Exception as e:  # report the section, run the rest, exit 1
            traceback.print_exc()
            print(f"# {title} FAILED: {type(e).__name__}: {e}", file=sys.stderr)
            failed.append(title)
            continue
        for r in rows:
            print(r, flush=True)
        print(f"# {title}: {time.time() - t0:.1f}s", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
