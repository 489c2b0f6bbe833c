"""Static-analysis sweep over the port's exported programs — the analyze gate.

Runs :func:`repro_torch.analysis.analyze` on the decode-LM exports the port
has, a reduced model-zoo dense forward, a library app and every workload in
:mod:`repro_torch.workloads`, across every Scheme axis combination, and
gates:

* **zero error-severity diagnostics** anywhere (including planner/verifier
  differential disagreement — RA2xx), and
* **no new warnings** versus the committed ``ANALYSIS_baseline.json`` (the
  reference package's per-program, per-code warn counts; read only here).

Targets the port does not have yet are listed and skipped: ``decode-lm``
waits for ``export_decode_lm`` and ``moe-decode-lm`` for the MoE family.

Usage:
    python -m repro_torch.bench.analyze --all --strict
    python -m repro_torch.bench.analyze -p attn-decode-lm -v
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Callable, Sequence

REPO = Path(__file__).resolve().parents[3]
BASELINE_PATH = REPO / "ANALYSIS_baseline.json"
# every Scheme axis combination the differential check must agree on
ALL_SCHEMES = ("qemu", "tech", "tech-g", "tech-gf", "tech-gfp", "native")
# baseline targets whose exporters belong to later slices of the port
NOT_PORTED = {
    "decode-lm": "models.programs.export_decode_lm",
    "moe-decode-lm": "models.programs.export_moe_decode_lm (the MoE family)",
}


@dataclasses.dataclass
class Target:
    name: str
    build: Callable          # () -> (Program, example_args | None)
    unit_filter: Callable | None = None
    # scheme whose diagnostics are gated against the baseline; every scheme
    # of ALL_SCHEMES still runs through the soundness differential
    gate_scheme: str = "tech-gfp"


def _decode_export(name: str):
    def build():
        import numpy as np

        from ..models import programs

        return getattr(programs, name)(), [np.zeros((2, 3), np.int32)]

    return build


def _zoo_dense(arch: str):
    def build():
        import dataclasses as dc

        import torch

        from ..configs import reduced_config
        from ..models import api, programs

        cfg = dc.replace(
            reduced_config(arch), compute_dtype="float32",
            d_model=64, d_ff=128, n_layers=2,
        )
        params = api.init(cfg, torch.Generator().manual_seed(0), tp=2, device="cpu")
        return programs.export_dense_forward(cfg, params, batch=2, seq=8, tp=2)

    return build


def build_targets() -> dict[str, Target]:
    from ..workloads import LIBRARY_FUNCTIONS, WORKLOADS, build_library_app
    from ..workloads.libs import library_unit_filter

    targets: dict[str, Target] = {
        "attn-decode-lm": Target("attn-decode-lm", _decode_export("export_attn_decode_lm")),
        "mamba2-decode-lm": Target("mamba2-decode-lm",
                                   _decode_export("export_mamba2_decode_lm")),
        "zoo-smollm-360m": Target("zoo-smollm-360m", _zoo_dense("smollm-360m")),
        # library-scope offloading: exercises the unit_filter differential
        "lib-zlibflate": Target(
            "lib-zlibflate",
            lambda: build_library_app("zlibflate", "test"),
            unit_filter=library_unit_filter(LIBRARY_FUNCTIONS),
        ),
    }
    for name, spec in sorted(WORKLOADS.items()):
        targets[f"wl-{name}"] = Target(f"wl-{name}", (lambda s=spec: s.build("test")))
    return targets


def analyze_target(target: Target, verbose: bool = False) -> tuple[dict, list[str]]:
    """Run the full scheme sweep on one target.

    Returns (gate-scheme warn counts by code, list of failure strings).
    """
    from ..analysis import analyze

    program, example_args = target.build()
    failures: list[str] = []
    gate_counts: dict[str, int] = {}
    for scheme in ALL_SCHEMES:
        report = analyze(
            program, scheme,
            unit_filter=target.unit_filter,
            example_args=example_args,
        )
        agree = report.facts.get("soundness", {}).get("agree")
        if agree is False:  # None for native/qemu (feasibility check instead)
            failures.append(f"{target.name}/{scheme}: planner and verifier disagree")
        for d in report.errors:
            failures.append(f"{target.name}/{scheme}: {d}")
        if scheme == target.gate_scheme:
            for d in report.warnings:
                gate_counts[d.code] = gate_counts.get(d.code, 0) + 1
            if verbose:
                print(report)
        elif verbose:
            status = "ok" if report.ok else "ERRORS"
            print(f"  [{scheme:8s}] {status} {report.codes()}")
    return gate_counts, failures


def load_baseline() -> dict:
    return json.loads(BASELINE_PATH.read_text())


def check_baseline(results: dict[str, dict[str, int]], baseline: dict) -> list[str]:
    """New warnings fail only when they exceed the committed baseline."""
    failures = []
    known = baseline.get("targets", {})
    for name, counts in sorted(results.items()):
        allowed = known.get(name, {})
        for code, n in sorted(counts.items()):
            cap = allowed.get(code, 0)
            if n > cap:
                failures.append(f"{name}: {n} x {code} warnings exceed baseline ({cap})")
    return failures


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true", help="sweep every target")
    ap.add_argument("-p", "--programs", nargs="*", default=None,
                    help="target names to analyze (default: --all)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on any error or baseline regression")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--list", action="store_true", help="list targets and exit")
    args = ap.parse_args(argv)

    targets = build_targets()
    if args.list:
        for name in targets:
            print(name)
        for name, why in NOT_PORTED.items():
            print(f"{name} (not ported: {why})")
        return 0
    names = list(targets) if (args.all or not args.programs) else args.programs
    unknown = [n for n in names if n not in targets]
    if unknown:
        ap.error(f"unknown targets {unknown}; have {sorted(targets)}")

    results: dict[str, dict[str, int]] = {}
    failures: list[str] = []
    for name in names:
        counts, fails = analyze_target(targets[name], verbose=args.verbose)
        results[name] = counts
        failures.extend(fails)
        status = "FAIL" if fails else "ok"
        print(f"{name:20s} {status:4s} warnings={sum(counts.values())} {counts or ''}")
    for name, why in NOT_PORTED.items():
        print(f"{name:20s} skip (not ported: {why})")

    failures.extend(check_baseline(results, load_baseline()))
    if failures:
        print(f"\n{len(failures)} failure(s):")
        for f in failures:
            print(f"  {f}")
        return 1 if args.strict else 0
    print("\nanalyze: all targets clean (no errors, no baseline regressions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
