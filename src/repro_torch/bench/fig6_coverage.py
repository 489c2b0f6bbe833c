"""Fig. 6 analogue: function offloading coverage per scheme.

Paper claim C5: PFO increases coverage (obsequi 21 → 46 functions) by
outlining around host-only ops; coverage gains do not always change
performance (the extra functions may be cold).
"""
from __future__ import annotations

from .common import SchemeRun, csv_row, sweep_workloads

COV_SCHEMES = ["tech", "tech-gf", "tech-gfp"]


def rows(sweep: dict[str, dict[str, SchemeRun]]) -> list[str]:
    out = []
    for name, res in sweep.items():
        for scheme in COV_SCHEMES:
            c = res[scheme].hybrid.last_plan.coverage
            out.append(csv_row(
                f"fig6/{name}/{scheme}", float("nan"),
                f"offloaded={c.offloaded_functions}/{c.total_functions};"
                f"segments={c.outlined_segments};host_blocked={c.blocked_by_host_ops}"))
    return out


def run(scale: str = "test", *, device=None, workloads=None):
    return rows(sweep_workloads(scale, device=device, repeats=0, workloads=workloads,
                                schemes=COV_SCHEMES))


if __name__ == "__main__":
    for r in run():
        print(r)
