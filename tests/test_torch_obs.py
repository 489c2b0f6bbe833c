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

    # no per-example deadline: under several loaded test workers one example
    # can take longer than hypothesis' default 200 ms without anything wrong
    @hypothesis.settings(deadline=None)
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


# ---------------------------------------------------------------------------
# inside the crossing: place / unit / fetch (a drain too on CUDA)
# ---------------------------------------------------------------------------


def phases_of(spans):
    """``{crossing span: {kind: span}}`` for the place/unit/drain/fetch
    spans on the crossing's thread, under its name, inside its interval."""
    out = {}
    for c in (s for s in spans if s.kind == obs.CROSSING):
        inside = [s for s in spans if s.kind in (obs.PLACE, obs.UNIT, obs.DRAIN, obs.FETCH)
                  and s.name == c.name and s.tid == c.tid and c.start_ns <= s.start_ns
                  and s.start_ns + s.dur_ns <= c.start_ns + c.dur_ns]
        kinds = {}
        for s in inside:
            assert s.kind not in kinds, (c.name, s.kind)
            kinds[s.kind] = s
        out[id(c)] = (c, kinds)
    return out


def test_crossing_phases_nest_in_order_with_their_bytes():
    from repro_torch.core import ProgramBuilder

    pb = ProgramBuilder("phases")
    pb.constant("W", (np.random.default_rng(0).standard_normal((32, 32)) / 8).astype(np.float32))
    dense = pb.function("dense", ["x"])
    dense.use_global("W")
    dense.build([dense.emit("tanh", dense.emit("matmul", "x", "W"))])
    main = pb.function("main", ["x0"])
    main.build([main.emit("host_print", main.call("dense", "x0"), threshold=1e6,
                          fmt="overflow {}")])
    hybrid = mixed.trace(pb.build("main")).plan("tech-gfp").compile(backend="cpu")
    x = np.ones((4, 32), np.float32)
    hybrid(x)                                     # compile outside the trace
    with obs.session(label="phases") as tr:
        (out,), rep = hybrid.call_reported(x)
    crossings = list(phases_of(tr.snapshot()).values())
    assert len(crossings) == rep.guest_to_host == 1
    (c, kinds), = crossings
    assert set(kinds) == {obs.PLACE, obs.UNIT, obs.FETCH}     # no drain on the CPU
    place, unit, fetch = kinds[obs.PLACE], kinds[obs.UNIT], kinds[obs.FETCH]
    assert place.start_ns + place.dur_ns <= unit.start_ns
    assert unit.start_ns + unit.dur_ns <= fetch.start_ns
    assert place.args == {"bytes": x.nbytes} and fetch.args == {"bytes": out.nbytes}
    assert unit.args is None                      # no device_ms off the card
    assert all(s.trace_id == tr.trace_id for s in (c, place, unit, fetch))
    assert 0 < rep.place_ns <= place.dur_ns + c.dur_ns


def paged_workload(n_streams: int = 3, max_new: int = 5, capacity: int = 4):
    """Paged decode through the paged-kernel root (CPU units); returns
    ``(outputs, report, scheduler)``, the scheduler closed."""
    from repro_torch.models.programs import export_attn_decode_lm
    from repro_torch.serve import StateSpec

    planned = mixed.trace(export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=32)
                          ).plan("tech-gfp")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, (8,), dtype=np.int32) for _ in range(n_streams)]
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=32, page_size=4)
    with DecodeScheduler(planned, backend="cpu", step="decode_step",
                         paged_step="paged_decode_step", capacity=capacity,
                         state=spec) as sched:
        outs = [f.result(120) for f in [sched.submit(p, max_new) for p in prompts]]
    return outs, sched.report(), sched


def test_paged_step_places_the_pools_table_lengths_and_tokens():
    """A paged step's crossings, in their ``place`` spans: the first passes
    both page pools by reference (``resident_bytes``) and copies the block
    table, the lengths and the tokens (``bytes``); the second (the head)
    copies the (capacity, d_model) float32 hidden rows.  The report's
    ``step_placed_bytes`` and ``step_resident_bytes`` hold the same sums,
    and ``step_place_s`` the steps' placement time; prefills and warm calls
    stay out of all three."""
    from repro_torch.core.convert import Resident

    with obs.session(label="place") as tr:
        outs, rep, sched = paged_workload()
    paged, capacity = sched._paged, sched.capacity
    assert all(isinstance(paged.backing(k), Resident) for k in (0, 1))
    pools = sum(paged.backing(k).nbytes for k in (0, 1))
    entry = (paged.table_array().nbytes + paged.lengths_array().nbytes
             + capacity * np.dtype(np.int32).itemsize)
    head = capacity * DM * np.dtype(np.float32).itemsize
    step_places = [k[obs.PLACE].args for c, k in phases_of(tr.snapshot()).values()
                   if c.name.startswith("paged_decode_step")]
    assert rep.steps > 0 and rep.kernel_steps == rep.steps
    assert len(step_places) == 2 * rep.steps
    assert sum(a["bytes"] for a in step_places) == rep.steps * (entry + head) \
        == rep.step_placed_bytes
    assert sum(a.get("resident_bytes", 0) for a in step_places) == rep.steps * pools \
        == rep.step_resident_bytes
    assert 0 < rep.step_place_s < rep.execution.place_ns / 1e9


def test_scheduler_emit_spans_follow_each_call():
    """One ``emit`` span after each prefill group and each step, on the
    scheduler's thread, after the phase's own span, with its live rows;
    the tokens equal the untraced run's."""
    plain_outs, _, _ = paged_workload()
    with obs.session(label="emit") as tr:
        outs, rep, sched = paged_workload()
    spans = tr.snapshot()
    emits = [s for s in spans if s.kind == obs.EMIT]
    phases = [s for s in spans if s.kind in (obs.STEP, obs.PREFILL)]
    assert len(emits) == len(phases) == rep.steps + rep.prefills
    for e in emits:
        phase = max((p for p in phases if p.start_ns + p.dur_ns <= e.start_ns),
                    key=lambda p: p.start_ns)
        assert e.name == phase.name and e.tid == phase.tid
        assert e.args["live"] == phase.args.get("live", phase.args.get("streams"))
    for a, b in zip(plain_outs, outs):
        np.testing.assert_array_equal(a, b)


def test_untraced_crossings_record_nothing_and_still_count():
    tr = obs.Tracer(spans_enabled=False)
    with obs.session(tr):
        _, rep, _ = paged_workload(n_streams=2, max_new=3)
    assert len(tr) == 0 and tr.hist.total_count == 0
    assert rep.step_place_s > 0 and rep.execution.place_ns > 0


def test_add_takes_the_thread_trace_context_until_it_is_cleared():
    import threading

    tr = obs.Tracer(label="ctx")
    seen = {}

    def worker():
        with obs.trace_context("root/7"):
            tr.add("in", obs.UNIT, 0, 1)
            tr.add("own", obs.UNIT, 0, 1, trace_id="root/8")   # explicit id wins
            with obs.trace_context("root/9"):
                tr.event("nested", obs.COMPILE)
            seen["restored"] = obs.context_trace_id()
        seen["after"] = obs.context_trace_id()
        tr.add("out", obs.UNIT, 0, 1)

    with obs.trace_context("main/1"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        tr.add("main", obs.UNIT, 0, 1)            # other threads keep their own
    ids = {s.name: s.trace_id for s in tr.snapshot()}
    assert ids == {"in": "root/7", "own": "root/8", "nested": "root/9",
                   "out": tr.trace_id, "main": "main/1"}
    assert seen == {"restored": "root/7", "after": None}
    assert obs.context_trace_id() is None


def test_chrome_export_draws_unit_device_time_on_a_device_track():
    tr = obs.Tracer(label="dev")
    tr.add("main_seg0", obs.UNIT, 1_000_000, 50_000,
           args={"device_ms": 0.25, "device_start_ns": 1_020_000})
    tr.add("main_seg0", obs.PLACE, 900_000, 100_000, args={"bytes": 64})
    events = tr.chrome_trace()["traceEvents"]
    dev = [e for e in events if e["ph"] == "X" and e["tid"] == obs.trace.DEVICE_TID]
    host = [e for e in events if e["ph"] == "X" and e["tid"] != obs.trace.DEVICE_TID]
    assert len(dev) == 1 and len(host) == 2
    assert (dev[0]["ts"], dev[0]["dur"], dev[0]["name"]) == (1020.0, 250.0, "main_seg0")
    assert any(e["ph"] == "M" and e["name"] == "thread_name" and e["args"]["name"] == "device"
               and e["tid"] == obs.trace.DEVICE_TID for e in events)


def test_prefix_evictions_mirror_the_index_bound():
    """An LRU drop of a retained prefix entry counts in
    ``DecodeReport.prefix_evictions``, and so does the release of the
    entries still retained at close."""
    from repro_torch.models.programs import export_attn_decode_lm
    from repro_torch.serve import StateSpec

    planned = mixed.trace(export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=32)
                          ).plan("tech-gfp")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, (8,), dtype=np.int32) for _ in range(3)]
    counts = {}
    for bound in (1, 64):
        spec = StateSpec(growing={0: 1, 1: 1}, max_context=32, page_size=4,
                         share_prefixes=True, prefix_cache_entries=bound)
        with DecodeScheduler(planned, backend="cpu", step="decode_step",
                             prefill_suffix="prefill_suffix", capacity=2,
                             state=spec) as sched:
            for p in prompts:                     # one at a time: distinct prefixes
                sched.submit(p, 2).result(120)
            serving = sched.report().prefix_evictions
        counts[bound] = (serving, sched.report().prefix_evictions)
    # each prompt registers 8 // 4 = 2 entries: 6 in all, `bound` kept till close
    assert counts == {1: (5, 6), 64: (0, 6)}
