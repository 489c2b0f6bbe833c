"""The per-layer readers of the crossing's phases, the scheduler's host
work and the request lifecycle, on synthetic records: a value, nothing
where the denominator is 0 or the program has no such counter or span (as
a program from before them), and spans from two threads."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import registry


def span(kind, start, dur, tid=1, args=None, name="x"):
    return SimpleNamespace(name=name, kind=kind, start_ns=start, dur_ns=dur, tid=tid,
                           args=args)


def record(counters=None, traced=None, spans=()):
    return {"counters": counters or {}, "traced_counters": traced or {}, "spans": list(spans)}


def read(name, rec):
    return registry.metric_reader(name, True).read(rec)


def test_place_ms_per_step_reads_the_untraced_counter():
    assert read("place_ms_per_step.decode", record({"step_place_s": 0.9, "steps": 50},
                                                   {"step_place_s": 5.0, "steps": 1})) \
        == pytest.approx(18.0)
    assert read("place_ms_per_step.decode", record({"step_place_s": 0.0, "steps": 0})) is None
    assert read("place_ms_per_step.decode", record({"steps": 50})) is None


def test_pool_wait_ms_reads_the_untraced_counter():
    assert read("pool_wait_ms.mixed", record({"pool_wait_total": 3.0, "requests": 4})) \
        == pytest.approx(750.0)
    assert read("pool_wait_ms.mixed", record({"pool_wait_total": 0.0, "requests": 0})) is None
    assert read("pool_wait_ms.mixed", record({"queue_wait_total": 3.0, "requests": 4})) is None


def test_emit_ms_per_step_unions_each_thread_then_sums():
    spans = [span("emit", 0, 2_000_000, tid=1), span("emit", 1_000_000, 2_000_000, tid=1),
             span("emit", 0, 1_000_000, tid=2), span("step", 0, 9_000_000, tid=1)]
    # thread 1: [0, 3) ms, thread 2: [0, 1) ms, over 2 steps
    assert read("emit_ms_per_step.decode", record(traced={"steps": 2}, spans=spans)) \
        == pytest.approx(2.0)
    assert read("emit_ms_per_step.decode", record(traced={"steps": 0}, spans=spans)) is None
    assert read("emit_ms_per_step.decode",
                record(traced={"steps": 2}, spans=spans[3:])) is None


def test_fetch_ms_per_batch_sums_every_thread():
    spans = [span("fetch", 0, 3_000_000, tid=1, args={"bytes": 8}),
             span("fetch", 0, 5_000_000, tid=2, args={"bytes": 8}),
             span("place", 0, 7_000_000, tid=1)]
    assert read("fetch_ms_per_batch.mixed", record(traced={"batches": 2}, spans=spans)) \
        == pytest.approx(4.0)
    assert read("fetch_ms_per_batch.mixed", record(traced={"batches": 0}, spans=spans)) is None
    assert read("fetch_ms_per_batch.mixed",
                record(traced={"batches": 2}, spans=spans[2:])) is None


def test_unit_device_ms_per_batch_reads_the_device_arg():
    spans = [span("unit", 0, 9_000_000, tid=1, args={"device_ms": 1.5, "device_start_ns": 5}),
             span("unit", 0, 9_000_000, tid=2, args={"device_ms": 2.5, "device_start_ns": 7}),
             span("unit", 0, 9_000_000, tid=2)]          # a unit on the CPU: no device time
    assert read("unit_device_ms_per_batch.mixed", record(traced={"batches": 2}, spans=spans)) \
        == pytest.approx(2.0)
    assert read("unit_device_ms_per_batch.mixed",
                record(traced={"batches": 0}, spans=spans)) is None
    assert read("unit_device_ms_per_batch.mixed",
                record(traced={"batches": 2}, spans=spans[2:])) is None
