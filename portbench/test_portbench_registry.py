"""The benchmark's files against BENCHMARK.json and the contract's limits,
and that a cell, a configuration, a driver and a metric are added as new
files, found by name, without an edit to any file already there."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import harness, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = registry.cell(w["name"])
        assert cell["config"] == w["config"]
        config = registry.config(cell["config"])
        assert hasattr(registry.driver(config["driver"]).Driver, "check")
        ref = registry.reference(config["reference"])
        assert hasattr(ref, "logits")
        assert w["chips"] == 1
        e2e, layer = registry.cell_metrics(bench, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
        for m in e2e:
            assert callable(registry.metric_reader(m["name"], False).read)
        for m in layer:
            assert callable(registry.metric_reader(m["name"], True).read)
            assert m["moves"] in {x["name"] for x in e2e}


def test_names_units_and_keys_keep_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["reduced"] == registry.config(c["name"])["reduced"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_each_check_has_every_limit_set():
    for c in registry.benchmark()["configs"]:
        limits = registry.config(c["name"])["check"]["limits"]
        assert limits and all(v is not None for v in limits.values()), c["name"]


THROWAWAY_DRIVER = '''
import numpy as np


class Driver:
    def __init__(self, config, cell, *, seed, device, reference):
        self.vocab = config["model"]["vocab"]
        self.n = 0

    def submit(self, req):
        self.n += 1
        return req.tokens.sum(axis=1)

    def counters(self):
        return {"answers": self.n}

    def close(self):
        pass

    def check(self, completions):
        bad = sum(not np.array_equal(c.answer, c.request.tokens.sum(axis=1))
                  for c in completions)
        return [{"name": "wrong", "value": float(bad)}]
'''


def test_a_new_cell_is_new_files_only(tmp_path):
    """A throwaway configuration, cell, driver, end-to-end and per-layer
    metric, written beside the benchmark's own files, run through the
    harness on the CPU."""
    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "drivers" / "echo.py").write_text(THROWAWAY_DRIVER)
    (root / "reference" / "echo-cfg.py").write_text("def logits(*a):\n    return None\n")
    (root / "configs" / "echo-cfg.json").write_text(json.dumps({
        "source": "https://example.org", "model": {"vocab": 50}, "reduced": [],
        "driver": "echo", "reference": "echo-cfg", "system": {},
        "check": {"limits": {"wrong": 0}}}))
    (root / "workloads" / "echo.small.json").write_text(json.dumps({
        "config": "echo-cfg", "why": "throwaway",
        "traffic": {"clients": 2, "prompt_tokens": 4, "rows_cycle": [1, 2]}}))
    (root / "end_to_end" / "answers_per_s.py").write_text(
        "def read(record):\n    return record['counters']['answers'] / record['window_s']\n")
    (root / "metrics" / "answers.echo.py").write_text(
        "def read(record):\n    return record['counters']['answers']\n")
    bench = registry.benchmark()
    bench["workloads"].append({"name": "echo.small", "config": "echo-cfg", "traffic": "small",
                               "chips": 1, "why": "throwaway"})
    bench["end_to_end"].append({"name": "answers_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["echo.small"]})
    bench["per_layer"].append({"name": "answers.echo", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "echo",
                               "moves": "answers_per_s", "workloads": ["echo.small"]})
    assert all(p.read_bytes() == b for p, b in before.items())

    cell, config = registry.cell("echo.small", root), registry.config("echo-cfg", root)
    for trace in (False, True):
        result = harness.run(cell, config, bench, seed=3, seconds=0.2, trace=trace,
                             device="cpu", root=root)
        assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
        want = {"answers.echo"} if trace else {"answers_per_s", "setup_s"}
        assert set(result["metrics"]) == want
