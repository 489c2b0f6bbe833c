"""The port's observability tier (repro_torch.obs): tracer, histograms,
propagation, ported from ``tests/test_obs.py`` (units on the CPU).

Covers the contracts the flight recorder promises:

* **passivity** — tracing on vs off is bit-identical on a decode workload
  (the tier-1 invariant ``smoke-trace`` gates at cluster scale),
* the bounded span ring drops the **oldest** records and counts every
  drop; histograms never drop,
* histogram ``merge`` is associative and conserves bucket counts
  (property-tested under hypothesis when available),
* ``obs.warn`` records a structured LogEvent *and* still satisfies
  ``pytest.warns``,
* cross-process harvest — a spawned cluster worker's boot warning and
  spans cross the channel into :class:`~repro_torch.serve.ClusterReport`, under
  the parent's root trace id,
* profiling rides the same span stream (``ProfilingEmulator`` has no
  private stopwatch) and :class:`ProfiledCostModel` still resolves PFO
  segment names to their parent profile.
"""
import json
import os

import numpy as np
import pytest

from repro_torch import mixed, obs
from repro_torch.core.costmodel import CostModelConfig
from repro_torch.core.profiling import (
    FunctionProfile,
    ProfiledCostModel,
    profile_program,
)
from repro_torch.models.programs import export_decode_lm
from repro_torch.serve import ClusterRouter, DecodeScheduler, WorkerSpec
from repro_torch.workloads import WORKLOADS

VOCAB, DM = 32, 16


def decode_outputs(planned, n_streams: int = 3, max_new: int = 4):
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, VOCAB, (6,), dtype=np.int32) for _ in range(n_streams)]
    with DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=2) as sched:
        futs = [sched.submit(p, max_new) for p in ps]
        outs = [f.result(120) for f in futs]
        rep = sched.report()
    return outs, rep


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


def test_bucket_index_log2_layout():
    assert obs.bucket_index(0) == 0
    assert obs.bucket_index(1023) == 0          # sub-µs bucket
    assert obs.bucket_index(1024) == 1
    assert obs.bucket_index(2047) == 1
    assert obs.bucket_index(2048) == 2
    assert obs.bucket_index(10**18) == obs.N_BUCKETS - 1   # clamps, no IndexError


def test_histogram_record_and_stats():
    h = obs.Histogram()
    for ns in (500, 1500, 3000, 3000):
        h.record(ns)
    assert h.count == 4 and h.sum_ns == 8000
    assert h.min_ns == 500 and h.max_ns == 3000
    assert sum(h.counts) == h.count
    assert h.quantile_ns(1.0) >= h.quantile_ns(0.5)


def test_histogram_merge_is_associative_small():
    a, b, c = obs.Histogram(), obs.Histogram(), obs.Histogram()
    for h, vals in ((a, [100, 2000]), (b, [10**6]), (c, [5, 5, 10**9])):
        for v in vals:
            h.record(v)
    left = a.merge(b).merge(c)
    right = a.merge(b.merge(c))
    assert left == right
    assert left.count == a.count + b.count + c.count
    assert sum(left.counts) == left.count


def test_histogram_merge_property():
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    durations = st.lists(st.integers(min_value=0, max_value=10**12),
                         max_size=50)

    @hypothesis.given(durations, durations, durations)
    def run(xs, ys, zs):
        a, b, c = obs.Histogram(), obs.Histogram(), obs.Histogram()
        for h, vals in ((a, xs), (b, ys), (c, zs)):
            for v in vals:
                h.record(v)
        left, right = a.merge(b).merge(c), a.merge(b.merge(c))
        assert left == right                      # associative
        assert left.count == len(xs) + len(ys) + len(zs)
        assert sum(left.counts) == left.count     # buckets conserve samples
        assert left.sum_ns == sum(xs) + sum(ys) + sum(zs)

    run()


def test_histogram_set_overflow_key_bounds_cardinality():
    hs = obs.HistogramSet()
    for i in range(600):
        hs.record((f"name{i}", "kind"), 100)
    assert len(hs) <= 513                         # MAX_KEYS + overflow bucket
    assert hs.total_count == 600                  # no sample lost
    assert hs.get(("<overflow>", "")) is not None


def test_histogram_set_delta_and_pickle_roundtrip():
    import pickle

    hs = obs.HistogramSet()
    hs.record(("f", "unit"), 1000)
    before = hs.copy()
    hs.record(("f", "unit"), 2000)
    hs.record(("g", "unit"), 10)
    delta = hs.delta_since(before)
    assert delta.total_count == 2
    back = pickle.loads(pickle.dumps(hs))
    assert back == hs


# ---------------------------------------------------------------------------
# the tracer ring
# ---------------------------------------------------------------------------


def test_ring_overflow_drops_oldest_and_counts():
    tr = obs.Tracer(capacity=4, label="tiny")
    for i in range(10):
        tr.add(f"s{i}", obs.UNIT, i, 1)
    spans = tr.snapshot()
    assert [s.name for s in spans] == ["s6", "s7", "s8", "s9"]
    assert tr.spans_dropped == 6
    assert tr.hist.total_count == 10              # histograms never drop


def test_session_restores_previous_and_empty_tracer_is_not_replaced():
    # regression: Tracer defines __len__, so an *empty* tracer is falsy —
    # session/ProfilingEmulator must test `is None`, not truthiness
    mine = obs.Tracer(label="mine")
    assert len(mine) == 0 and not mine
    with obs.session(mine) as got:
        assert got is mine and obs.active() is mine
    assert obs.active() is not mine


def test_disabled_tracer_collects_logs_but_no_spans():
    tr = obs.Tracer(spans_enabled=False)
    with obs.session(tr):
        assert obs.active() is None and obs.current() is tr
        with pytest.warns(UserWarning, match="something skewed"):
            obs.warn("something skewed")
    assert len(tr) == 0
    assert [ev.message for ev in tr.logs()] == ["something skewed"]


def test_warn_keeps_warnings_contract():
    with obs.session(label="w") as tr:
        with pytest.warns(UserWarning, match="both paths"):
            obs.warn("both paths", origin="test")
    ev = tr.logs()[0]
    assert ev.level == "warning" and ev.origin == "test"


def test_chrome_export_is_valid_and_labelled(tmp_path):
    with obs.session(label="exporter") as tr:
        with tr.span("work", obs.UNIT, args={"signature": "f32[4]"}):
            pass
        tr.event("tick", obs.COMPILE)
    path = tmp_path / "trace.json"
    tr.export_chrome_trace(path)
    payload = json.loads(path.read_text())
    events = payload["traceEvents"]
    metas = [e for e in events if e["ph"] == "M"]
    assert any(e["args"]["name"] == "exporter" for e in metas)
    xs = [e for e in events if e["ph"] == "X"]
    assert xs[0]["name"] == "work" and xs[0]["cat"] == obs.UNIT
    assert xs[0]["args"]["trace_id"] == tr.trace_id
    assert any(e["ph"] == "i" for e in events)
    assert payload["otherData"]["spans_dropped"] == 0


# ---------------------------------------------------------------------------
# passivity: tracing must never change outputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def planned():
    return mixed.trace(export_decode_lm(vocab=VOCAB, d_model=DM)).plan("tech-gfp")


def test_decode_outputs_bit_identical_traced_or_not(planned):
    base, _ = decode_outputs(planned)
    with obs.session(label="traced") as tr:
        traced, rep = decode_outputs(planned)
    for a, b in zip(base, traced):
        np.testing.assert_array_equal(a, b)
    # and the run actually recorded: scheduler phases + unit crossings
    kinds = tr.counts_by_kind()
    assert kinds.get(obs.STEP, 0) > 0 and kinds.get(obs.CROSSING, 0) > 0
    assert rep.latency.get(("step", "")).count == kinds[obs.STEP]


def test_execution_report_carries_latency_histograms():
    prog, args = WORKLOADS["obsequi"].build("test")
    hybrid = mixed.trace(prog).plan("tech-gfp").compile(backend="cpu")
    hybrid(*args)
    rep = hybrid.last_report
    assert rep.latency.total_count >= 1           # always on, tracer or not
    for (unit, sig), h in rep.latency.items():
        assert sum(h.counts) == h.count
        assert isinstance(unit, str) and isinstance(sig, str)
    assert "latency" in rep.as_dict()


# ---------------------------------------------------------------------------
# cross-process propagation (one spawn: warning + spans + trace ids)
# ---------------------------------------------------------------------------


def test_cluster_ships_worker_warnings_and_spans(tmp_path):
    spec = WorkerSpec(
        backend="cpu",
        program="repro_torch.models.programs:export_decode_lm",
        program_kwargs={"vocab": VOCAB, "d_model": DM},
        capacity=2,
        aot_path=str(tmp_path / "nonexistent-cache"),   # boot warning source
    )
    prompt = np.arange(6, dtype=np.int32)
    with obs.session(label="router") as tr:
        with ClusterRouter(spec, workers=1) as router:
            out = router.decode(prompt, 3, timeout=180)
            rep = router.report()
    assert out.shape == (3,)
    assert any("AOT cache unusable" in w for w in rep.worker_warnings)
    assert rep.spans_dropped == 0
    assert rep.worker_spans > 0
    worker_spans = [s for s in tr.snapshot() if s.pid != os.getpid()]
    assert worker_spans, "no spans crossed the channel"
    assert all(s.trace_id.startswith(tr.trace_id) for s in tr.snapshot())
    assert any(lbl != "main" for pid, lbl in tr.process_labels.items()
               if pid != os.getpid())
    txt = rep.table()
    assert "worker warnings" in txt


# ---------------------------------------------------------------------------
# profiling rides the span stream
# ---------------------------------------------------------------------------


def test_profile_program_reads_emulator_spans():
    prog, args = WORKLOADS["obsequi"].build("test")
    prof = profile_program(prog, args)
    assert prof, "profiling pass saw no functions"
    hot = max(prof.values(), key=lambda p: p.total_s)
    assert hot.calls >= 1 and hot.total_s > 0
    # the pass is self-contained: nothing leaked into the global tracer
    assert obs.current() is None or obs.current().label != "profile"


def test_profiled_costmodel_pfo_segment_falls_back_to_parent():
    model = ProfiledCostModel(
        {"f": FunctionProfile(calls=10, total_s=1.0)},   # 100ms/call: hot
        CostModelConfig(crossing_cost_s=1e-3),
    )
    direct = model.decide(None, "f", ())
    seg = model.decide(None, "f#1", ())                  # PFO segment name
    assert direct.offload and seg.offload
    assert seg.reason.startswith("profiled hot:")
    cold = model.decide(None, "f#1#2", ())
    assert cold.reason.startswith("profiled hot:")       # nested segments too


def test_profiled_costmodel_from_histograms_matches_dict():
    hs = obs.HistogramSet()
    for _ in range(10):
        hs.record(("f", obs.EMULATOR), 100_000_000)      # 100ms interpreted
    model = ProfiledCostModel.from_histograms(
        hs, CostModelConfig(crossing_cost_s=1e-3))
    assert model.decide(None, "f", ()).offload
    assert model.profile["f"].calls == 10
