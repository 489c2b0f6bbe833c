"""Fig. 5 analogue: guest→host crossing counts per scheme per workload.

Paper claims: GRT leaves counts unchanged; FCP collapses them by orders of
magnitude (npbbt 6,713,003 → 206); FCP+PFO leave many workloads at a single
crossing; crossing count correlates with hybrid overhead (C4, C7).  The
counts do not depend on the framework: they equal the JAX package's.
"""
from __future__ import annotations

from .common import SchemeRun, csv_row, sweep_workloads

COUNT_SCHEMES = ["tech", "tech-g", "tech-gf", "tech-gfp"]


def rows(sweep: dict[str, dict[str, SchemeRun]]) -> list[str]:
    out = []
    for name, res in sweep.items():
        for scheme in COUNT_SCHEMES:
            r = res[scheme].steady
            out.append(csv_row(
                f"fig5/{name}/{scheme}", float("nan"),
                f"g2h={r.guest_to_host};h2g={r.host_to_guest};"
                f"nested={r.nested_crossings}"))
    return out


def run(scale: str = "bench", *, device=None, workloads=None):
    return rows(sweep_workloads(scale, device=device, repeats=1, workloads=workloads,
                                schemes=COUNT_SCHEMES))


if __name__ == "__main__":
    for r in run():
        print(r)
