"""Fig. 4 analogue: per-workload speedup of each scheme over qemu.

Paper claims the figure tests:
  C1  emulation is far slower than native (paper: 13.23× geomean)
  C2  TECH-gfp achieves a multi-× geomean speedup over qemu (paper: 3.03×)
  C3  GRT alone barely moves wall time
  C6  cjson/lua regress (offloading is not a guaranteed win)

On the card every crossing pays a host→device placement and a
device→host gather, so a speedup below 1 here is a measurement of that
cost, not a fault.
"""
from __future__ import annotations

import numpy as np

from .common import SCHEMES, SchemeRun, csv_row, geomean, sweep_workloads


def rows(sweep: dict[str, dict[str, SchemeRun]]) -> list[str]:
    out = []
    per_scheme_speedups = {s: [] for s in SCHEMES[2:]}
    native_slowdowns = []
    for name, res in sweep.items():
        t_qemu = res["qemu"].seconds
        t_native = res["native"].seconds
        if np.isfinite(t_native) and t_native > 0:
            native_slowdowns.append(t_qemu / t_native)
        for scheme in SCHEMES:
            secs = res[scheme].seconds
            speedup = t_qemu / secs if np.isfinite(secs) and secs > 0 else float("nan")
            if scheme in per_scheme_speedups and np.isfinite(speedup):
                per_scheme_speedups[scheme].append(speedup)
            derived = f"speedup_vs_qemu={speedup:.3f}" if np.isfinite(speedup) else \
                "native_infeasible(all-or-nothing)"
            out.append(csv_row(f"fig4/{name}/{scheme}", secs * 1e6, derived))
    for scheme, sp in per_scheme_speedups.items():
        out.append(csv_row(f"fig4/geomean/{scheme}", float("nan"),
                           f"geomean_speedup={geomean(sp):.3f}"))
    if native_slowdowns:
        out.append(csv_row("fig4/geomean/qemu_slowdown_vs_native", float("nan"),
                           f"qemu_slowdown={geomean(native_slowdowns):.2f}x"))
    return out


def run(scale: str = "bench", *, device=None, workloads=None, repeats: int = 3):
    return rows(sweep_workloads(scale, device=device, repeats=repeats,
                                workloads=workloads))


if __name__ == "__main__":
    for r in run():
        print(r)
