"""Beyond-paper: profile-guided offload selection on the regression cases.

The paper's cjson/lua negative results (§4.2) motivate its future work on
profiling-guided selection — implemented in
:mod:`repro_torch.core.profiling`.  This benchmark compares the regression
workloads under (a) qemu, (b) static tech-gfp (the paper's prototype
behaviour, regresses), (c) profile-guided tech-gfp (profiling passes feed a
measured cost model).  The profiled decisions come from measured wall
time, so their counts are not framework-free: the structure is what holds
(cjson and lua stay interpreted, npbbt offloads).  The profile keeps each
function's smallest per-call time over ``PROFILE_PASSES`` passes: a call
that host load preempted lengthens one pass's mean, not the smallest, so a
busy host cannot lift a 10 us function over the 200 us crossing cost.
"""
from __future__ import annotations

from ..core.profiling import FunctionProfile, ProfiledCostModel, profile_program
from ..workloads import WORKLOADS
from .common import SchemeRun, compile_scheme, csv_row, run_compiled

CASES = ["cjson", "lua", "obsequi", "npbbt"]
PROFILE_PASSES = 5


def steady_profile(program, args) -> dict[str, FunctionProfile]:
    """Each function's profile from the pass, of ``PROFILE_PASSES``, that
    measured its smallest per-call time."""
    best: dict[str, FunctionProfile] = {}
    for _ in range(PROFILE_PASSES):
        for name, prof in profile_program(program, args).items():
            if prof.calls and (name not in best or prof.per_call_s < best[name].per_call_s):
                best[name] = prof
    return best


def sweep(scale: str = "bench", *, device=None, repeats: int = 3
          ) -> dict[str, dict[str, SchemeRun]]:
    """{case: {"qemu" | "static" | "profile-guided": SchemeRun}}."""
    out = {}
    for name in CASES:
        prog, args = WORKLOADS[name].build(scale)
        profile = steady_profile(prog, args)
        out[name] = {
            "qemu": run_compiled(compile_scheme(prog, "qemu", device=device), args,
                                 repeats=repeats),
            "static": run_compiled(compile_scheme(prog, "tech-gfp", device=device),
                                   args, repeats=repeats),
            "profile-guided": run_compiled(
                compile_scheme(prog, "tech-gfp", device=device,
                               costmodel=ProfiledCostModel(profile)),
                args, repeats=repeats),
        }
    return out


def rows(sweeps: dict[str, dict[str, SchemeRun]]) -> list[str]:
    out = []
    for name, res in sweeps.items():
        t_qemu = res["qemu"].seconds
        out.append(csv_row(f"profile/{name}/qemu", t_qemu * 1e6, "speedup=1.000"))
        static = res["static"]
        out.append(csv_row(
            f"profile/{name}/static", static.seconds * 1e6,
            f"speedup={t_qemu / static.seconds:.3f};g2h={static.steady.guest_to_host}"))
        guided = res["profile-guided"]
        out.append(csv_row(
            f"profile/{name}/profile-guided", guided.seconds * 1e6,
            f"speedup={t_qemu / guided.seconds:.3f};g2h={guided.steady.guest_to_host};"
            f"units={len(guided.hybrid.last_plan.units)}"))
    return out


def run(scale: str = "bench", *, device=None):
    return rows(sweep(scale, device=device))


if __name__ == "__main__":
    for r in run():
        print(r)
