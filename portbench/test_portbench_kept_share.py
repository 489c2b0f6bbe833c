"""``kept_share.decode`` on synthetic records: the untraced half's share of
unit output bytes left on the device, nothing where no call returned or the
program has no such counters (as a program from before them), and a value
from a CPU run of the decode cell."""
from __future__ import annotations

import pytest

from portbench import harness, registry, tiny


def read(counters, traced=None):
    record = {"counters": counters, "traced_counters": traced or {}, "spans": []}
    return registry.metric_reader("kept_share.decode", True).read(record)


def test_reads_the_untraced_counters():
    assert read({"kept_bytes": 900, "fetched_bytes": 100},
                {"kept_bytes": 0, "fetched_bytes": 5}) == pytest.approx(90.0)
    assert read({"kept_bytes": 0, "fetched_bytes": 0}) is None
    assert read({"step_resident_bytes": 10, "step_placed_bytes": 1}) is None


def test_a_traced_cpu_run_reports_it():
    cell, config = tiny.decode()
    result = harness.run(cell, config, registry.benchmark(), seed=2**31 + 11, seconds=0.5,
                         trace=True, device="cpu")
    share = result["metrics"]["kept_share.decode"]["value"]
    assert 0.0 < share < 100.0           # the K/V stay, the logits come back
