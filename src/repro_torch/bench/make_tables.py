"""Markdown roofline tables from the port's dry-run records.

The port's copy of the harness's ``benchmarks/make_tables.py``: per mesh, one
row per (arch, shape) cell without a tag, with the H100 roofline terms
(seconds), the dominant term, the compute term's share of the bound, the
ratio of the model's FLOPs per chip to the FLOPs rank 0's step counted (the
reference's MODEL/HLO column; see :mod:`.roofline`), rank 0's bytes and
whether they fit the card; then the count of cells by status and the cells
that do not fit.

    PYTHONPATH=src python -m repro_torch.bench.make_tables [single|multi|MESH] [DRYRUN_DIR]
"""
from __future__ import annotations

import sys
from collections import Counter

from .roofline import flops_ratio, load_cells


def fmt_cell(d: dict) -> dict:
    t = d["roofline"]["terms"]
    bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
    return dict(compute_s=t["compute_s"], memory_s=t["memory_s"],
                collective_s=t["collective_s"], dominant=t["dominant"],
                frac=t["compute_s"] / bound if bound else 0.0, util=flops_ratio(d),
                rank0_gib=d["memory"]["total"] / 2**30, fits=d["memory"]["fits"])


def table(mesh: str = "single", dryrun_dir=None) -> list[str]:
    lines = [f"### {mesh} mesh",
             "| arch | shape | compute_s | memory_s | collective_s | dominant | "
             "roofline-frac | MODEL/counted flops | rank 0 GiB | fits |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    status, misfits = Counter(), []
    for d in load_cells(dryrun_dir):
        if d.get("tag") or d["mesh"] != mesh:
            continue
        status[d["status"]] += 1
        if d["status"] == "skipped":
            lines.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | — | — | — | "
                         f"skipped: {d['reason']} |")
            continue
        if d["status"] != "ok":
            lines.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | — | — | — | "
                         f"ERROR {d.get('error', '')[:40]} |")
            continue
        c = fmt_cell(d)
        if not c["fits"]:
            misfits.append(f"{d['arch']} {d['shape']}")
        lines.append(
            f"| {d['arch']} | {d['shape']} | {c['compute_s']:.3e} | {c['memory_s']:.3e} | "
            f"{c['collective_s']:.3e} | {c['dominant']} | {c['frac']:.2f} | {c['util']:.2f} | "
            f"{c['rank0_gib']:.2f} | {c['fits']} |")
    lines.append("")
    lines.append(f"cells: {dict(status)}; rank 0 over the card: {misfits or 'none'}")
    return lines


def main(mesh: str = "single", dryrun_dir=None) -> None:
    for line in table(mesh, dryrun_dir):
        print(line)


if __name__ == "__main__":
    main(*(sys.argv[1:3]))
