"""Find the benchmark's pieces by name.

Everything that belongs to one cell, one configuration, one entry kind or
one metric sits in a file of its own, so that a later change adds files and
edits none:

* ``workloads/<cell>.json``: the cell (configuration, traffic, system
  options, why);
* ``configs/<config>.json``: the configuration (source, widths, what was
  reduced and assumed, the driver, the reference and the check's limits);
* ``drivers/<driver>.py``: one entry kind, a ``Driver`` class;
* ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: one metric each,
  a ``read(record)`` function;
* ``reference/<config>.py``: the plain float32 reference of a configuration.

Which metrics a cell reports is read from ``BENCHMARK.json`` at the root of
the checkout.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent          # the benchmark's folder
REPO = ROOT.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: Path = REPO) -> dict:
    return _json(Path(repo) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    return {"name": name, **_json(Path(root) / "workloads" / f"{name}.json")}


def config(name: str, root: Path = ROOT) -> dict:
    return {"name": name, **_json(Path(root) / "configs" / f"{name}.json")}


def load_module(path: Path):
    """Import a file by its path (names may hold dots and dashes)."""
    path = Path(path)
    key = f"portbench_{path.parent.name}_{path.stem}".replace(".", "_").replace("-", "_")
    if key in sys.modules and getattr(sys.modules[key], "__file__", None) == str(path):
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT):
    return load_module(Path(root) / "drivers" / f"{name}.py")


def reference(name: str, root: Path = ROOT):
    return load_module(Path(root) / "reference" / f"{name}.py")


def metric_reader(name: str, per_layer: bool, root: Path = ROOT):
    return load_module(Path(root) / ("metrics" if per_layer else "end_to_end") / f"{name}.py")


def cell_metrics(bench: dict, cell_name: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and the per-layer metrics ``cell_name`` reports: an
    end-to-end entry counts in every cell unless its ``workloads`` list
    leaves the cell out; a per-layer entry counts in the cells its
    ``workloads`` list names, which every per-layer entry has."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    layer = [m for m in bench["per_layer"] if cell_name in m["workloads"]]
    return e2e, layer


def bench_cell(bench: dict, cell_name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell_name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {cell_name!r}")
