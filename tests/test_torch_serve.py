"""The serving runtime (repro_torch.serve) and the concurrency substrate under it.

Covers: thread-safe signature cache on CompiledHybrid (exactly one plan per
signature under contention), cross-signature offload-unit sharing, thread-safe
GRT and instrument() sessions, the batcher's bucket selection and padding
exactness, and MixedServer end-to-end — concurrent mixed-shape clients,
bit-identical batched results, emulator fallback for cold buckets, and
ServerReport bookkeeping.
"""
import math
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from repro_torch import mixed
from repro_torch.core import ProgramBuilder
from repro_torch.core.convert import signature_of
from repro_torch.serve import (
    BucketLadder,
    MixedServer,
    Request,
    coalesce,
    group_key,
)


def build_program(repeats: int = 8, width: int = 32, builder=ProgramBuilder):
    """Quickstart-shaped serving program: offloadable dense block + hot loop
    + host-only check, with a batch-preserving output (axis-0 = requests)."""
    pb = builder("serve-test")
    W = (np.random.default_rng(0).standard_normal((width, width)) / 10).astype(
        np.float32
    )
    pb.constant("W", W)

    dense = pb.function("dense", ["x"])
    dense.use_global("W")
    h = dense.emit("matmul", "x", "W")
    h = dense.emit("tanh", h)
    dense.build([h])

    step = pb.function("step", ["x"])
    y = step.call("dense", "x")
    z = step.emit("mul", y, y)
    step.build([z])

    main = pb.function("main", ["x0"])
    out = main.repeat("step", repeats, "x0")
    out = main.emit("host_print", out, threshold=1e6, fmt="overflow {}")
    main.build([out])
    return pb.build("main")


def rows(n: int, width: int = 32, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, width)).astype(np.float32)


# ---------------------------------------------------------------------------
# concurrency substrate: CompiledHybrid under contention
# ---------------------------------------------------------------------------


def test_concurrent_calls_one_plan_per_signature():
    """8 threads × 2 signatures: exactly 2 plans, every output identical."""
    planned = mixed.trace(build_program()).plan("tech-gfp")
    hybrid = planned.compile(backend="cpu")
    x8, x4 = rows(8), rows(4, seed=2)
    ref8, ref4 = hybrid(x8)[0].copy(), hybrid(x4)[0].copy()
    errors = []

    def worker(i):
        try:
            for _ in range(10):
                x, ref = (x8, ref8) if i % 2 == 0 else (x4, ref4)
                out = hybrid(x)
                assert np.array_equal(out[0], ref)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    with mixed.instrument() as rec:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        [t.start() for t in ts]
        [t.join() for t in ts]

    assert errors == []
    assert hybrid.replans == 2                    # no duplicate replans
    assert len(hybrid.signatures) == 2
    assert len(rec.reports) == 80
    merged = rec.merged()
    assert merged.calls == 80
    assert merged.guest_to_host == sum(r.guest_to_host for r in rec.reports)
    assert merged.replans == 2                    # cumulative per owner, maxed


def test_concurrent_first_calls_build_one_grt_entry_per_key():
    """Racing cold calls never duplicate conversion-plan builds (locked GRT)."""
    hybrid = mixed.trace(build_program()).plan("tech-g").compile(backend="cpu")
    x = rows(8)
    ts = [threading.Thread(target=lambda: hybrid(x)) for _ in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    state = hybrid.state_for(signature_of([x]))
    grt = state._grt
    assert grt.builds == len(grt)                 # one build per cached key
    # lifetime stats reconcile across all 8 calls
    assert state.stats.grt_hits + state.stats.conversion_builds \
        == state.stats.guest_to_host


def test_units_shared_across_signatures_and_hybrids():
    """Same rank/dtype ⇒ the second signature reuses every offload unit, and a
    second CompiledHybrid from the same plan builds no new units at all."""
    planned = mixed.trace(build_program()).plan("tech-gfp")
    h1 = planned.compile(backend="cpu")
    h1(rows(8))
    builds_after_first = planned.unit_cache.builds
    assert builds_after_first > 0
    h1(rows(4, seed=2))                            # new signature, same ranks
    assert planned.unit_cache.builds == builds_after_first
    assert planned.unit_cache.hits >= builds_after_first
    h2 = planned.compile(backend="cpu")                         # sibling compiled object
    h2(rows(2, seed=3))
    assert planned.unit_cache.builds == builds_after_first


def test_backend_compile_partitions_unit_cache():
    # two device names ("cpu" and "cpu:0": the reference's default and
    # explicit backends, on the one device this host has) key apart
    planned = mixed.trace(build_program()).plan("tech-g")
    h_default = planned.compile(backend="cpu:0")
    h_cpu = planned.compile(backend="cpu")
    x = rows(4)
    np.testing.assert_array_equal(h_default(x)[0], h_cpu(x)[0])
    # distinct backends may not share offload units
    assert planned.unit_cache.builds == 2 * len(
        {k[0] for k in planned.unit_cache._units}
    )
    with pytest.raises(ValueError):
        planned.compile(backend="no-such-backend")


def test_concurrent_instrument_sessions_do_not_corrupt():
    hybrid = mixed.trace(build_program()).plan("tech-g").compile(backend="cpu")
    x = rows(4)
    hybrid(x)
    errors = []

    def session(n):
        try:
            with mixed.instrument() as rec:
                for _ in range(n):
                    hybrid(x)
                assert len(rec.reports) >= n      # sees at least its own calls
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=session, args=(5,)) for _ in range(6)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert errors == []
    from repro_torch.core.api import _RECORDERS

    assert _RECORDERS == []                       # every session unregistered


# ---------------------------------------------------------------------------
# batcher
# ---------------------------------------------------------------------------


def test_bucket_ladder_selection_and_validation():
    ladder = BucketLadder(batch_sizes=(1, 2, 4, 8), seq_multiple=16)
    assert [ladder.batch_bucket(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    assert ladder.batch_bucket(13) == 13          # above the ladder: natural size
    assert ladder.padded_seq(1) == 16 and ladder.padded_seq(16) == 16
    assert ladder.padded_seq(17) == 32
    with pytest.raises(ValueError):
        BucketLadder(batch_sizes=())
    with pytest.raises(ValueError):
        BucketLadder(batch_sizes=(0, 2))
    with pytest.raises(ValueError):
        BucketLadder(seq_multiple=0)


def test_request_validation():
    with pytest.raises(ValueError):
        Request.of([], seq_axis=1)
    with pytest.raises(ValueError):               # mismatched leading dims
        Request.of([np.zeros((2, 3)), np.zeros((3, 3))], seq_axis=1)
    r = Request.of([np.zeros((2, 5))], seq_axis=1)
    assert (r.rows, r.seq) == (2, 5)


def test_coalesce_pads_batch_and_splits_exactly():
    ladder = BucketLadder(batch_sizes=(1, 2, 4, 8))
    reqs = [
        Request.of([rows(1, seed=s)], seq_axis=1) for s in (1, 2, 3)
    ]
    batch = coalesce(reqs, ladder)
    assert batch.args[0].shape == (4, 32)         # 3 rows → 4-bucket
    assert (batch.rows, batch.padded_rows) == (3, 4)
    # filler replicates the last real row
    np.testing.assert_array_equal(batch.args[0][3], batch.args[0][2])
    outs = (batch.args[0] * 2.0,)                 # row-parallel fake result
    split = batch.split(outs)
    for req, out in zip(reqs, split):
        np.testing.assert_array_equal(out[0], req.args[0] * 2.0)


def test_coalesce_rejects_mixed_signatures():
    ladder = BucketLadder()
    a = Request.of([rows(1)], seq_axis=1)
    b = Request.of([rows(1, width=16)], seq_axis=1)
    assert group_key(a, ladder) != group_key(b, ladder)
    with pytest.raises(ValueError):
        coalesce([a, b], ladder)


def test_seq_padding_is_exact_for_causal_programs():
    """Pad seq 5→8 on a causal-free row-parallel program: identical prefix."""
    ladder = BucketLadder(batch_sizes=(1, 2), seq_axis=1, seq_multiple=8)
    x = np.random.default_rng(0).standard_normal((1, 5, 3)).astype(np.float32)
    req = Request.of([x], seq_axis=1)
    batch = coalesce([req, req], ladder)
    assert batch.args[0].shape == (2, 8, 3)       # seq rounded up
    # an elementwise "model": padded positions don't pollute real ones
    outs = (np.tanh(batch.args[0]),)
    (out_a, ), (out_b, ) = batch.split(outs)
    assert out_a.shape == (1, 5, 3)
    np.testing.assert_array_equal(out_a, np.tanh(x))
    np.testing.assert_array_equal(out_b, np.tanh(x))


# ---------------------------------------------------------------------------
# MixedServer end-to-end
# ---------------------------------------------------------------------------


def test_server_concurrent_clients_bit_identical():
    """8 client threads, mixed request shapes, warm server: outputs are
    bit-identical to direct per-request hybrid calls and batching strictly
    reduces crossings per request."""
    planned = mixed.trace(build_program()).plan("tech-gfp")
    direct = planned.compile(backend="cpu")
    reqs = [rows(1, seed=10 + i) for i in range(12)] + [rows(2, seed=30 + i) for i in range(4)]
    refs = [direct(r) for r in reqs]
    unbatched_crossings = direct.last_report.guest_to_host
    assert unbatched_crossings >= 1

    with MixedServer(
        planned, backend="cpu", ladder=BucketLadder(batch_sizes=(1, 2, 4, 8)),
        max_batch_delay=0.02,
    ) as server:
        server.warm(reqs[0])
        results = [None] * len(reqs)

        def client(i):
            results[i] = server.request(reqs[i])

        ts = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        [t.start() for t in ts]
        [t.join() for t in ts]
        rep = server.report()

    for ref, out in zip(refs, results):
        assert len(ref) == len(out)
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(r, o)
    assert rep.requests == len(reqs)
    assert rep.fallback_requests == 0             # warm server never fell back
    assert rep.batches < len(reqs)                # batching actually happened
    assert rep.crossings_per_request < unbatched_crossings
    assert 0 < rep.batch_occupancy <= 1.0
    assert rep.queue_wait_max >= rep.mean_queue_wait >= 0


def test_server_cold_bucket_falls_back_then_warms():
    planned = mixed.trace(build_program(repeats=4, width=16)).plan("tech-gfp")
    server = MixedServer(
        planned, backend="cpu", ladder=BucketLadder(batch_sizes=(1, 2)), max_batch_delay=0.002
    )
    try:
        x = rows(1, width=16)
        out_cold = server.request(x)
        rep = server.report()
        assert rep.fallback_requests == 1         # served by the emulator path
        assert rep.batches == 0
        # headline metric is undefined until a compiled-path request ran —
        # fallback-only traffic must not read as "zero crossings"
        assert math.isnan(rep.crossings_per_request)
        # the background warm eventually lands
        deadline = time.time() + 30
        while server.report().warm_compiles < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert server.report().warm_compiles >= 1
        out_warm = server.request(x)
        rep = server.report()
        assert rep.batches >= 1                   # compiled path now serving
        direct = planned.compile(backend="cpu")
        ref = direct(x)
        np.testing.assert_array_equal(out_warm[0], ref[0])
        np.testing.assert_allclose(out_cold[0], ref[0], rtol=1e-5, atol=1e-6)
    finally:
        server.close()


def test_server_timeout_flush_and_explicit_flush():
    planned = mixed.trace(build_program(repeats=2, width=16)).plan("tech-g")
    with MixedServer(
        planned, backend="cpu", ladder=BucketLadder(batch_sizes=(1, 2, 4, 8)),
        max_batch_delay=0.05,
    ) as server:
        x = rows(1, width=16)
        server.warm(x)
        # a lone request dispatches after ~max_batch_delay without help
        t0 = time.perf_counter()
        server.request(x)
        waited = time.perf_counter() - t0
        assert waited >= 0.04                     # sat out the batching window
        # flush() short-circuits the wait
        fut = server.submit(x)
        server.flush()
        fut.result(timeout=10)
        rep = server.report()
        assert rep.requests == 2
        # occupancy accounting saw the 1-row bucket twice, unpadded
        assert rep.request_rows == 2 and rep.padded_rows == 2


def test_server_submit_validation_and_close_semantics():
    planned = mixed.trace(build_program(repeats=2, width=16)).plan("tech-g")
    server = MixedServer(planned, backend="cpu")
    with pytest.raises(TypeError):
        server.submit(rows(1, width=16), rows(1, width=16))   # arity
    with pytest.raises(ValueError):
        server.submit(np.float32(3.0))                        # scalar arg
    fut = server.submit(rows(1, width=16))
    assert isinstance(fut, Future)
    fut.result(timeout=30)
    server.close()
    server.close()                                            # idempotent
    with pytest.raises(RuntimeError):
        server.submit(rows(1, width=16))


def test_cancelled_future_does_not_strand_batch_mates():
    planned = mixed.trace(build_program(repeats=2, width=16)).plan("tech-g")
    with MixedServer(
        planned, backend="cpu", ladder=BucketLadder(batch_sizes=(1, 2, 4)), max_batch_delay=5.0
    ) as server:
        server.warm(rows(1, width=16))
        fut_a = server.submit(rows(1, width=16, seed=7))
        fut_b = server.submit(rows(1, width=16, seed=8))
        assert fut_a.cancel()                     # caller gave up while queued
        server.flush()
        out_b = fut_b.result(timeout=30)          # batch-mate still resolves
        assert out_b[0].shape == (1, 16)
        assert fut_a.cancelled()


def test_failed_warm_keeps_bucket_on_fallback_and_retries():
    planned = mixed.trace(build_program(repeats=2, width=16)).plan("tech-gfp")
    server = MixedServer(
        planned, backend="cpu", ladder=BucketLadder(batch_sizes=(1,)), max_batch_delay=0.001
    )
    try:
        real = server.hybrid.call_reported
        state = {"fails": 1}

        def flaky(*args):                         # first warm attempt dies
            if (
                threading.current_thread().name.startswith("mixed-warm")
                and state["fails"] > 0
            ):
                state["fails"] -= 1
                raise RuntimeError("simulated unit failure")
            return real(*args)

        server.hybrid.call_reported = flaky
        x = rows(1, width=16)
        server.request(x)                         # cold: fallback + failed warm
        deadline = time.time() + 30
        while server.report().warm_failures < 1 and time.time() < deadline:
            time.sleep(0.01)
        rep = server.report()
        assert rep.warm_failures == 1 and rep.warm_compiles == 0
        server.request(x)                         # still fallback; retriggers warm
        deadline = time.time() + 30
        while server.report().warm_compiles < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert server.report().warm_compiles == 1
        server.request(x)                         # finally on the compiled path
        assert server.report().batches >= 1
    finally:
        server.close()


def test_oversized_batch_splits_into_top_bucket_chunks():
    """A request batch above the top bucket is served as top-bucket chunks —
    bit-identical to solo per-row requests, signature set bounded by the
    ladder (no natural-size retrace), splits counted in the report."""
    planned = mixed.trace(build_program()).plan("tech-gfp")
    direct = planned.compile(backend="cpu")
    big = rows(11, seed=42)
    refs = [direct(big[i:i + 1]) for i in range(11)]
    with MixedServer(
        planned, backend="cpu", ladder=BucketLadder(batch_sizes=(1, 2, 4)),
        max_batch_delay=0.001,
    ) as server:
        server.warm(big[:1])                      # warms buckets 1/2/4
        out = server.request(big, timeout=120)
        rep = server.report()
    for j, o in enumerate(out):
        o = np.asarray(o)
        assert o.shape[0] == 11                   # all rows came back, in order
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(np.asarray(ref[j])[0], o[i])
    assert rep.requests == 1
    assert rep.oversize_splits == 2               # 11 rows → 4 + 4 + 3(→4)
    assert rep.batches == 3 and rep.fallback_requests == 0
    assert rep.padded_rows == 12 and rep.request_rows == 11
    # adversarial sizes must not mint entry signatures above the ladder
    assert all(sig[0].shape[0] <= 4 for sig in server.hybrid.signatures)


def test_record_batch_mixed_chunks_keeps_crossings_consistent():
    """A partially-fallback chunked batch excludes its requests from the
    compiled denominator, so its compiled chunks' crossings must leave the
    numerator with them — otherwise the next clean compiled request would
    report stray crossings it never made."""
    from repro_torch.core.stats import ExecutionReport
    from repro_torch.serve import ServerStats

    stats = ServerStats()
    compiled = ExecutionReport(calls=1, guest_to_host=3)
    cold = ExecutionReport(calls=1, guest_to_host=0)
    stats.record_batch(n_requests=1, rows=11, padded_rows=12, waits=[0.0],
                       reports=[cold, compiled, compiled],
                       fallback_calls=1, calls=3, splits=2)
    rep = stats.snapshot()
    assert rep.fallback_requests == 1 and rep.compiled_requests == 0
    assert rep.crossings == 0 and math.isnan(rep.crossings_per_request)
    assert rep.execution.guest_to_host == 6    # full accounting still there
    stats.record_batch(n_requests=1, rows=1, padded_rows=1, waits=[0.0],
                       reports=[compiled], fallback_calls=0)
    assert stats.snapshot().crossings_per_request == 3.0


def test_concurrent_close_implies_drained():
    """Two threads racing close(): both must block until every queued
    request resolved — the early-return-on-closed race let the second
    closer return while the first was still joining the dispatcher."""
    planned = mixed.trace(build_program(repeats=2, width=16)).plan("tech-g")
    server = MixedServer(
        planned, backend="cpu", ladder=BucketLadder(batch_sizes=(1, 2, 4)),
        max_batch_delay=0.2,                      # queued work outlives close()
    )
    futs = [server.submit(rows(1, width=16, seed=i)) for i in range(6)]
    drained = []

    def closer():
        server.close()
        drained.append(all(f.done() for f in futs))

    first = threading.Thread(target=closer)
    first.start()
    time.sleep(0.02)                              # second closer races in late
    second = threading.Thread(target=closer)
    second.start()
    first.join(120)
    second.join(120)
    assert drained == [True, True]


def test_server_shares_planned_state_with_direct_callers():
    """The server's hybrid is just another client of the shared plan: warm
    buckets reuse units already built by direct calls."""
    planned = mixed.trace(build_program(repeats=2, width=16)).plan("tech-gfp")
    direct = planned.compile(backend="cpu")
    direct(rows(2, width=16))                     # builds the units
    builds = planned.unit_cache.builds
    with MixedServer(
        planned, backend="cpu", ladder=BucketLadder(batch_sizes=(2,)), max_batch_delay=0.001
    ) as server:
        server.warm(rows(2, width=16, seed=5))
        server.request(rows(2, width=16, seed=6))
    assert planned.unit_cache.builds == builds    # zero new unit constructions


def test_server_outputs_match_reference_direct_calls():
    """Parity with the JAX package: the port's batched server answers each
    request as the reference's direct call does, within the engine's
    tolerance (2e-3/2e-4), with the reference's crossings per call."""
    from repro import mixed as jmixed
    from repro.core import ProgramBuilder as JBuilder

    reqs = [rows(1, seed=50 + i) for i in range(5)] + [rows(2, seed=70)]
    jprog = build_program(builder=JBuilder)
    jdirect = jmixed.trace(jprog).plan("tech-gfp").compile()
    tdirect = mixed.trace(build_program()).plan("tech-gfp").compile(backend="cpu")
    planned = mixed.trace(build_program()).plan("tech-gfp")
    with MixedServer(planned, backend="cpu",
                     ladder=BucketLadder(batch_sizes=(1, 2, 4, 8))) as server:
        server.warm(reqs[0])
        futs = [server.submit(r) for r in reqs]
        outs = [f.result(timeout=120) for f in futs]
    for r, out in zip(reqs, outs):
        jo, jr = jdirect.call_reported(r)
        to, tr = tdirect.call_reported(r)
        np.testing.assert_allclose(out[0], np.asarray(jo[0]), rtol=2e-3, atol=2e-4)
        assert tr.guest_to_host == jr.guest_to_host


def test_serve_exports_every_reference_name():
    import repro.serve as jserve

    import repro_torch.serve as tserve

    assert set(jserve.__all__) <= set(tserve.__all__)
    for name in jserve.__all__:
        assert getattr(tserve, name).__module__.startswith("repro_torch.")


# ---------------------------------------------------------------------------
# request lifecycles: batch spans (with their requests' waits) and pool_wait_total
# ---------------------------------------------------------------------------


LIFECYCLE_REQS = [rows(1, seed=90 + i) for i in range(10)] + [rows(2, seed=110 + i)
                                                             for i in range(3)]


def serve_clients(planned, reqs=LIFECYCLE_REQS, workers: int = 2):
    """Concurrent clients on a warm server; ``(outputs, report)``."""
    with MixedServer(planned, backend="cpu", workers=workers, max_batch_delay=0.01,
                     ladder=BucketLadder(batch_sizes=(1, 2, 4))) as server:
        server.warm(reqs[0])
        before = server.report()
        results = [None] * len(reqs)

        def client(i):
            results[i] = server.request(reqs[i])

        ts = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        [t.start() for t in ts]
        [t.join() for t in ts]
    after = server.report()
    delta = {k: getattr(after, k) - getattr(before, k)
             for k in ("requests", "queue_wait_total", "pool_wait_total", "batches")}
    return results, after, delta


@pytest.fixture(scope="module")
def lifecycle_runs():
    from repro_torch import obs

    planned = mixed.trace(build_program()).plan("tech-gfp")
    plain = serve_clients(planned)
    with obs.session(label="serve") as tracer:
        traced = serve_clients(planned)
    return plain, traced, tracer.snapshot()


def test_server_outputs_bit_identical_traced_or_not(lifecycle_runs):
    (plain, _, _), (traced, _, _), spans = lifecycle_runs
    for a, b in zip(plain, traced):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert spans


def test_every_request_has_one_batch_wait_and_one_pool_wait(lifecycle_runs):
    """Each request's two waits ride the one ``batch`` span that lists its
    id (``batch_wait_ms``: submit to the cut; ``pool_wait_ms``: the cut to
    the worker's start, shared by the batch) and add up to
    ``queue_wait_total`` (submit to worker start), the second part to
    ``pool_wait_total``.  No span of their own covers the waits."""
    from repro_torch import obs

    _, (_, rep, delta), spans = lifecycle_runs
    batches = [s for s in spans if s.kind == obs.BATCH]
    ids = [rid for b in batches for rid in b.args["requests"]]
    assert len(ids) == len(set(ids)) == delta["requests"] == len(LIFECYCLE_REQS)
    total_ms = pool_ms = 0.0
    for b in batches:
        waits = b.args["batch_wait_ms"]
        assert len(waits) == len(b.args["requests"])
        assert min(waits) >= 0 and b.args["pool_wait_ms"] >= 0
        total_ms += sum(waits) + len(waits) * b.args["pool_wait_ms"]
        pool_ms += len(waits) * b.args["pool_wait_ms"]
    assert abs(total_ms / 1e3 - delta["queue_wait_total"]) < 1e-3
    assert abs(pool_ms / 1e3 - delta["pool_wait_total"]) < 1e-3
    assert 0 <= delta["pool_wait_total"] <= delta["queue_wait_total"]
    assert {s.kind for s in spans} <= set(obs.SPAN_KINDS)


def test_batch_spans_list_the_requests_they_resolved(lifecycle_runs):
    """A ``batch`` span lists the distinct requests it served under their
    submission ids, with their rows padded to its bucket, and every span
    of its call carries its own id."""
    from repro_torch import obs

    _, (_, _, delta), spans = lifecycle_runs
    batches = [s for s in spans if s.kind == obs.BATCH]
    assert len(batches) == delta["batches"]                   # warm: no fallback
    by_id = {b.trace_id: b for b in batches}
    assert len(by_id) == len(batches)
    for b in batches:
        n = len(b.args["requests"])
        assert n <= b.args["rows"] <= 2 * n                   # 1- and 2-row requests
        assert b.args["rows"] <= b.args["padded_rows"] == b.args["bucket"]
        assert b.args["bucket"] in (1, 2, 4)
        assert all(rid.startswith(b.trace_id.split("/")[0] + "/") and rid != b.trace_id
                   for rid in b.args["requests"])
    workers = {b.tid for b in batches}            # warm() calls run elsewhere
    inner = [s for s in spans if s.tid in workers and s.kind in (
        obs.CALL, obs.CROSSING, obs.PLACE, obs.UNIT, obs.FETCH)]
    assert inner
    for s in inner:
        b = by_id[s.trace_id]                                 # a batch's id
        assert b.tid == s.tid
        assert b.start_ns <= s.start_ns and s.start_ns + s.dur_ns <= b.start_ns + b.dur_ns


def test_untraced_server_records_no_spans_and_counts_its_waits():
    """Tracing off (a tracer with spans disabled installed): nothing is
    recorded, and ``pool_wait_total`` and the crossings' ``place_ns`` still
    advance."""
    from repro_torch import obs

    planned = mixed.trace(build_program()).plan("tech-gfp")
    with obs.session(spans_enabled=False) as tracer:
        _, rep, delta = serve_clients(planned, LIFECYCLE_REQS[:6], workers=1)
    assert len(tracer) == 0 and tracer.spans_dropped == 0
    assert delta["requests"] == 6
    assert 0 < delta["pool_wait_total"] <= delta["queue_wait_total"]
    assert rep.execution.place_ns > 0


def test_worker_trace_context_is_cleared_after_each_batch():
    from repro_torch import obs

    planned = mixed.trace(build_program()).plan("tech-gfp")
    with obs.session(label="ctx"), MixedServer(planned, backend="cpu", workers=1) as server:
        server.warm(LIFECYCLE_REQS[0])
        server.request(LIFECYCLE_REQS[0])
        # the pool's one worker thread, after its batch
        assert server._pool.submit(obs.context_trace_id).result(60) is None
