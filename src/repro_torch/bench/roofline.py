"""Roofline rows from the port's dry-run records (``launch/dryrun.py``).

The port's copy of the harness's ``benchmarks/roofline.py``: one CSV row per
(arch, shape, mesh, tag) with the three H100 roofline terms, the dominant
one, and rank 0's bytes.  Where the reference divides the model's FLOPs by
XLA's HLO FLOPs, the port divides them (per chip) by the FLOPs its step
performed on rank 0: the counted matmuls and the kernels' FLOPs on their
shape-only route (``counted_flops`` in each record).

    PYTHONPATH=src python -m repro_torch.bench.roofline [DRYRUN_DIR]
"""
from __future__ import annotations

import glob
import json
import os
import sys

from ..launch.dryrun import OUT_DIR
from .common import csv_row


def load_cells(dryrun_dir=None) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(str(dryrun_dir or OUT_DIR), "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def flops_ratio(cell: dict) -> float:
    """Model FLOPs per chip over the FLOPs rank 0's step counted (nan where
    it counted none)."""
    counted = cell["counted_flops"]["total"]
    model = cell["roofline"]["model_flops"]["total"] / cell["chips"]
    return model / counted if counted else float("nan")


def run(dryrun_dir=None) -> list[str]:
    rows = []
    for c in load_cells(dryrun_dir):
        tag = c.get("tag") or "baseline"
        name = f"roofline/{c['arch']}/{c['shape']}/{c['mesh']}/{tag}"
        if c["status"] == "skipped":
            rows.append(csv_row(name, float("nan"), f"skipped:{c['reason'][:60]}"))
            continue
        if c["status"] != "ok":
            rows.append(csv_row(name, float("nan"), f"error:{c.get('error', '?')[:80]}"))
            continue
        r, mem = c["roofline"], c["memory"]
        t = r["terms"]
        derived = (
            f"compute_s={t['compute_s']:.3e};memory_s={t['memory_s']:.3e};"
            f"collective_s={t['collective_s']:.3e};dominant={t['dominant']};"
            f"model/counted_flops={flops_ratio(c):.2f};"
            f"rank0_gib={mem['total'] / 2**30:.2f};fits={mem['fits']}"
        )
        rows.append(csv_row(name, r["bound_s"] * 1e6, derived))
    return rows


if __name__ == "__main__":
    for row in run(sys.argv[1] if len(sys.argv) > 1 else None):
        print(row)
