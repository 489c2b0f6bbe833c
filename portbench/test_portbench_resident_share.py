"""``resident_share.decode`` on synthetic records: the untraced half's share
of step argument bytes passed by reference, nothing where no step crossed or
the program has no such counters (as a program from before them), and a
value from a CPU run of the decode cell."""
from __future__ import annotations

import pytest

from portbench import harness, registry, tiny


def read(counters, traced=None):
    record = {"counters": counters, "traced_counters": traced or {}, "spans": []}
    return registry.metric_reader("resident_share.decode", True).read(record)


def test_reads_the_untraced_counters():
    assert read({"step_resident_bytes": 990, "step_placed_bytes": 10},
                {"step_resident_bytes": 0, "step_placed_bytes": 5}) == pytest.approx(99.0)
    assert read({"step_resident_bytes": 0, "step_placed_bytes": 0}) is None
    assert read({"state_bytes": 10, "steps": 1}) is None


def test_a_traced_cpu_run_reports_it():
    cell, config = tiny.decode()
    result = harness.run(cell, config, registry.benchmark(), seed=2**31 + 9, seconds=0.5,
                         trace=True, device="cpu")
    share = result["metrics"]["resident_share.decode"]["value"]
    assert 50.0 < share < 100.0          # the tiny pools are small beside the table
