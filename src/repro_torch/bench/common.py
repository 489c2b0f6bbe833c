"""Shared benchmark machinery: timing, CSV rows, scheme sweeps.

Everything routes through the staged ``mixed.trace(...).plan(...).compile()``
frontend.  ``device`` is the device of the offload units: ``None`` is the
CUDA card (the port's default, raising where there is none), ``"cpu"`` runs
them on the CPU.  Every call of a compiled program ends in numpy outputs
gathered from the device, so a host-clock time of a call includes the
device's work — for ``native`` (one unit) as for every other scheme.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import mixed
from ..core import CompiledHybrid, NativeInfeasibleError
from ..core.api import resolve_device
from ..kernels import ops
from ..workloads import WORKLOADS

SCHEMES = ["native", "qemu", "tech", "tech-g", "tech-gf", "tech-gfp"]
# the framework-free counters of one call's ExecutionReport
COUNTERS = ("guest_to_host", "host_to_guest", "conversion_builds", "compiles",
            "grt_hits")
# the engine's tolerance against pure interpretation (tests/test_core_engine.py)
RTOL, ATOL = 2e-3, 2e-4
# the JAX package's records at bench scale (see tests/test_torch_workloads.py)
REFERENCE_COUNTERS = Path(__file__).resolve().parents[1] / "workloads" / "reference_counters.json"


class GateFailure(Exception):
    """A smoke-gate check failed; carries the diagnostics to print."""


def check(cond, msg: str, *details) -> None:
    """Explicit smoke-gate assertion: on failure, attach every detail
    (typically a report table) so the failure log shows the numbers, not a
    one-line AssertionError."""
    if cond:
        return
    raise GateFailure("\n".join([msg, *[str(d) for d in details]]))


def counters(report) -> dict:
    """The framework-free counters of an ExecutionReport, by name."""
    return {f: getattr(report, f) for f in COUNTERS}


def compile_scheme(prog, scheme, *, device=None, **plan_kw) -> CompiledHybrid:
    """Staged pipeline in one line (the common benchmark entry)."""
    return mixed.trace(prog).plan(scheme, **plan_kw).compile(backend=device)


@dataclasses.dataclass
class SchemeRun:
    """One scheme on one program: a cold call, then ``repeats`` timed calls.

    ``first``/``outputs`` are the cold call's report and results (it plans,
    builds the units and stages the globals); ``steady`` is the report of
    the last timed call; ``seconds`` the best timed call's wall time.  For an
    infeasible ``native`` plan only ``infeasible`` is set.
    """

    seconds: float = float("nan")
    hybrid: CompiledHybrid | None = None
    first: object = None
    steady: object = None
    outputs: tuple | None = None
    infeasible: NativeInfeasibleError | None = None

    def record(self) -> dict:
        """Counters, coverage, units and output dtypes/shapes (JSON-ready)."""
        if self.infeasible is not None:
            return {"infeasible": True}
        plan = self.hybrid.last_plan
        return {
            "first": counters(self.first),
            "steady": counters(self.steady),
            "coverage": plan.coverage.as_dict(),
            "units": len(plan.units),
            "dtypes": [str(np.asarray(o).dtype) for o in self.outputs],
            "shapes": [list(np.shape(o)) for o in self.outputs],
        }


def run_compiled(hybrid: CompiledHybrid, args, *, repeats: int = 3) -> SchemeRun:
    """A cold call (plan + unit build, like filling QEMU's TB cache), then
    the best of ``repeats`` steady-state calls."""
    outputs, first = hybrid.call_reported(*args)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        hybrid(*args)
        best = min(best, time.perf_counter() - t0)
    return SchemeRun(best, hybrid, first, hybrid.last_report, outputs)


def sweep_schemes(prog, args, *, schemes=None, repeats=3, device=None,
                  **plan_kw) -> dict[str, SchemeRun]:
    """{scheme: SchemeRun}; an infeasible ``native`` carries its error."""
    out = {}
    for scheme in schemes or SCHEMES:
        try:
            hybrid = compile_scheme(prog, scheme, device=device, **plan_kw)
        except NativeInfeasibleError as e:
            out[scheme] = SchemeRun(infeasible=e)
            continue
        out[scheme] = run_compiled(hybrid, args, repeats=repeats)
    return out


def sweep_workloads(scale: str, *, device=None, repeats: int = 3, workloads=None,
                    schemes=None) -> dict[str, dict[str, SchemeRun]]:
    """Every workload (default: all 17) under every scheme — the one sweep
    that figs. 4-6 read."""
    out = {}
    for name in workloads or sorted(WORKLOADS):
        prog, args = WORKLOADS[name].build(scale)
        out[name] = sweep_schemes(prog, args, schemes=schemes, repeats=repeats,
                                  device=device)
    return out


def load_reference() -> dict:
    return json.loads(REFERENCE_COUNTERS.read_text())


def reference_mismatches(sweeps: dict[str, dict[str, SchemeRun]],
                         recorded: dict[str, dict[str, dict]], *,
                         baseline: str = "qemu") -> list[str]:
    """Where a sweep leaves the reference's records, as readable lines.

    Each recorded run's :meth:`SchemeRun.record` (counters of the cold and
    the warm call, coverage, units, output dtypes and shapes) must equal
    the reference's, and its outputs must lie within the engine tolerance
    of the ``baseline`` run's (pure interpretation) on the same inputs.
    """
    bad = []
    for name, want_runs in recorded.items():
        runs = sweeps[name]
        if set(runs) != set(want_runs) | ({baseline} & set(runs)):
            bad.append(f"{name}: ran {sorted(runs)}, recorded {sorted(want_runs)}")
            continue
        base = runs[baseline].outputs if baseline in runs else None
        for scheme, want in want_runs.items():
            got = runs[scheme].record()
            if got != want:
                diff = {k: (got.get(k), want.get(k)) for k in want | got
                        if got.get(k) != want.get(k)}
                bad.append(f"{name}/{scheme}: (port, reference) {diff}")
            if base is None or runs[scheme].infeasible is not None:
                continue
            for a, b in zip(base, runs[scheme].outputs):
                if not np.allclose(b, a, rtol=RTOL, atol=ATOL):
                    bad.append(f"{name}/{scheme}: output {b} vs {baseline} {a} "
                               f"beyond {RTOL}/{ATOL}")
    return bad


def geomean(xs) -> float:
    xs = [x for x in xs if np.isfinite(x) and x > 0]
    if not xs:
        return float("nan")
    return float(np.exp(np.mean(np.log(xs))))


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    if np.isfinite(us_per_call):
        return f"{name},{us_per_call:.1f},{derived}"
    return f"{name},nan,{derived}"


def device_label(device) -> str:
    """What the units run on: the card's name, or ``cpu``.  Raises where
    the device is not present (``None`` is the CUDA card)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


# ---------------------------------------------------------------------------
# the smoke gates' shared runner
# ---------------------------------------------------------------------------


def sum_launches(*counts: dict) -> dict:
    """Kernel launches per route, ``{kernel: {route: n}}``, summed."""
    out: dict[str, dict[str, int]] = {}
    for c in counts:
        for name, routes in c.items():
            mine = out.setdefault(name, {})
            for route, n in routes.items():
                mine[route] = mine.get(route, 0) + n
    return out


def launch_row(gate: str, launches: dict) -> str:
    """``<gate>/launches``: every kernel launched, by route (``none`` if no
    kernel ran, as on the CPU, where the wrappers run their plain versions
    and count nothing)."""
    parts = [f"{name}:{route}={n}" for name, routes in sorted(launches.items())
             for route, n in sorted(routes.items()) if n]
    return csv_row(f"{gate}/launches", float("nan"), ";".join(parts) or "none")


def launches_from_rows(rows, gate: str) -> dict:
    """``{kernel: {route: n}}`` back from a gate's :func:`launch_row`."""
    row = next(r for r in rows if r.startswith(f"{gate}/launches,"))
    derived = row.split(",", 2)[2]
    out: dict[str, dict[str, int]] = {}
    for part in ([] if derived == "none" else derived.split(";")):
        key, n = part.split("=")
        name, route = key.split(":")
        out.setdefault(name, {})[route] = int(n)
    return out


def require_launches(launches: dict, kernels, device, gate: str) -> None:
    """On the card, fail unless every kernel of ``kernels`` (this gate's
    path) was launched at least once."""
    if resolve_device(device).type != "cuda":
        return
    missing = [k for k in kernels if not sum(launches.get(k, {}).values())]
    check(not missing, f"{gate}: kernels of this path never launched on the card: "
          f"{missing}", launches)


def finish_gate(rows: list, gate: str, device, kernels, *worker_launches) -> None:
    """Append the gate's launch row (this process's counts since
    :func:`gate_main` reset them, plus any spawned workers') and hold the
    path's kernels to having run on the card."""
    launches = sum_launches(ops.launches_by_route(), *worker_launches)
    rows.append(launch_row(gate, launches))
    require_launches(launches, kernels, device, gate)


def gate_main(title: str, gate: str, run, budget_s: float, argv=None) -> int:
    """Run one smoke gate as a program: ``--device`` (omit for the CUDA
    card, ``cpu`` for the CPU; without a card and without ``--device cpu``
    it raises), the CSV rows on standard output, the verdict as the exit
    status.  ``run(device, rows=rows)`` appends the rows named ``<gate>/...``.
    A failed check prints the rows so far, this process's launches and the
    check's numbers before the run exits 1."""
    ap = argparse.ArgumentParser(description=title)
    ap.add_argument("--device", default=None,
                    help="unit device: omit for the CUDA card, 'cpu' for the CPU")
    args = ap.parse_args(argv)
    label = device_label(args.device)
    ops.reset_launches()
    rows: list[str] = []
    t0 = time.time()
    try:
        run(args.device, rows=rows)
    except (GateFailure, AssertionError) as e:
        for r in rows:
            print(r)
        print(launch_row(gate, ops.launches_by_route()))
        print(f"{title} FAILED: {e}", file=sys.stderr)
        return 1
    for r in rows:
        print(r)
    dt = time.time() - t0
    print(f"# {title.lower()}: {dt:.1f}s on {label}", file=sys.stderr)
    if dt > budget_s:
        print(f"{title} FAILED: exceeded {budget_s:.0f}s budget", file=sys.stderr)
        return 1
    print(f"{title} PASSED", file=sys.stderr)
    return 0
