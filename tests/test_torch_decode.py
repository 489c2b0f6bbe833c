"""Token-level continuous batching (repro_torch.serve.DecodeScheduler) over
the port's ``export_decode_lm``, ported from ``tests/test_decode.py``.

Then the parity with the JAX package: ``export_decode_lm`` and
``export_moe_decode_lm`` give the reference's constants, ops and program
digest from the same seed, their roots give the reference's counters under
all six schemes (outputs within the engine's 2e-3/2e-4), and greedy decoding
gives the reference's tokens.

Covers the decode-scheduling invariants the serving layer promises:

* mid-flight admission is **bit-identical** to solo decoding (the fixed
  padded shape makes every row a pure function of its own inputs),
* retirement frees slots for the very next admission pass (no padding to
  the slowest stream),
* crossings per token on ≥4 concurrent decodes are strictly below
  per-request (solo-loop) serving,
* the ``for_entry`` step-plan surface shares offload units with the
  prefill plan,
* report rendering ("n/a" for not-yet-defined ratio metrics) and failure
  isolation (a poisoned sampler kills only its own stream).
"""
import math
import threading
import time

import numpy as np
import pytest

from repro_torch import mixed
from repro_torch.models.programs import export_decode_lm
from repro_torch.serve import (
    DecodeReport,
    DecodeScheduler,
    ServerReport,
    SlotMap,
    decode_reference,
)

VOCAB, DM, PROMPT_LEN = 32, 16, 6


@pytest.fixture(scope="module")
def planned():
    """One plan for the whole module: every scheduler shares its offload
    units (PlannedProgram.unit_cache)."""
    return mixed.trace(export_decode_lm(vocab=VOCAB, d_model=DM)).plan("tech-gfp")


def prompts(n: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (PROMPT_LEN,), dtype=np.int32)
            for _ in range(n)]


def wait_for(pred, timeout: float = 60.0, what: str = "condition"):
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# the step-fn plan surface
# ---------------------------------------------------------------------------


def test_for_entry_shares_unit_cache(planned):
    """Prefill and step plans share one UnitCache; the head function —
    reachable from both roots — is built once, not per plan."""
    step_planned = planned.for_entry("decode_step")
    assert step_planned.unit_cache is planned.unit_cache
    assert step_planned.analysis.program.entry == "decode_step"
    assert step_planned.scheme == planned.scheme
    # same entry -> same plan object (no-op fast path)
    assert planned.for_entry(planned.analysis.program.entry) is planned


def test_with_entry_unknown_function(planned):
    with pytest.raises(KeyError, match="unknown function"):
        planned.traced.with_entry("nonesuch")


# ---------------------------------------------------------------------------
# SlotMap
# ---------------------------------------------------------------------------


def test_slotmap_admit_retire_lowest_free():
    sm = SlotMap(3)
    assert (sm.capacity, sm.free, sm.live) == (3, 3, 0)
    a, b, c = sm.admit("a"), sm.admit("b"), sm.admit("c")
    assert (a, b, c) == (0, 1, 2)
    with pytest.raises(RuntimeError):
        sm.admit("d")
    assert sm.retire(1) == "b"
    assert sm.admit("d") == 1          # lowest free slot is reused
    assert [i for i, _ in sm.occupied()] == [0, 1, 2]
    sm.retire(1)
    with pytest.raises(KeyError):
        sm.retire(1)                   # double free of the same slot


def test_slotmap_rejects_bad_capacity():
    with pytest.raises(ValueError):
        SlotMap(0)


# ---------------------------------------------------------------------------
# scheduling invariants
# ---------------------------------------------------------------------------


def test_midflight_admission_bit_identical(planned):
    """Streams admitted while others are mid-decode produce exactly the
    tokens they produce when decoded alone."""
    ps = prompts(4)
    lens = [10, 12, 5, 6]
    with DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=4) as sched:
        sched.warm(PROMPT_LEN)
        first = [sched.submit(ps[i], lens[i]) for i in (0, 1)]
        # make sure the first two are genuinely mid-flight before admitting
        wait_for(lambda: sched.report().steps >= 2, what="two decode steps")
        late = [sched.submit(ps[i], lens[i]) for i in (2, 3)]
        outs = [s.result(timeout=120) for s in first + late]
        assert all(s.admitted_step > 0 for s in late), (
            "late streams must have joined mid-flight")
    for p, n, out in zip(ps, lens, outs):
        ref = decode_reference(sched.prefill, sched.step, p, n, capacity=4)
        assert np.array_equal(ref, out), "not bit-identical to solo decoding"
        assert out.dtype == np.int32 and len(out) == n


def test_retirement_frees_slot_for_next_admission(planned):
    """With capacity 2 and three streams, the third is admitted into the
    retiring stream's slot at the very next step — retirement never pads a
    later step and admission never waits for the slowest stream."""
    ps = prompts(3, seed=1)
    with DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=2,
                         start=False) as sched:
        sched.warm(PROMPT_LEN)
        a = sched.submit(ps[0], 2)     # retires after step 0
        b = sched.submit(ps[1], 12)    # still live throughout
        c = sched.submit(ps[2], 4)     # must inherit a's slot
        sched.start()
        outs = [s.result(timeout=120) for s in (a, b, c)]
        rep = sched.report()
    assert c.slot == a.slot
    assert c.admitted_step == a.retired_step + 1
    assert b.retired_step > c.retired_step
    # no step ran half-empty while c was waiting: slots freed same-step
    assert rep.steps == 11             # longest stream: 12 tokens = 11 steps
    for p, n, out in zip(ps, (2, 12, 4), outs):
        ref = decode_reference(sched.prefill, sched.step, p, n, capacity=2)
        assert np.array_equal(ref, out)


def test_crossings_per_token_below_per_request(planned):
    """≥4 concurrent decodes: the shared per-step crossing-set beats one
    crossing-set per token per request, strictly."""
    ps = prompts(4, seed=2)
    n = 8
    with DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=4,
                         start=False) as sched:
        sched.warm(PROMPT_LEN)
        streams = [sched.submit(p, n) for p in ps]
        sched.start()
        outs = [s.result(timeout=120) for s in streams]
        rep = sched.report()
    assert rep.prefills == 1, "pre-start burst must admit in one prefill"
    assert rep.tokens == 4 * n
    batched_cpt = rep.crossings / rep.tokens

    # per-request serving: each stream is its own prefill + per-token calls
    solo_crossings = 0
    with mixed.instrument() as rec:
        for p, out in zip(ps, outs):
            ref = decode_reference(sched.prefill, sched.step, p, n, capacity=4)
            assert np.array_equal(ref, out)
    solo = rec.merged()
    solo_crossings = solo.guest_to_host
    solo_cpt = solo_crossings / (4 * n)
    assert batched_cpt < solo_cpt, (
        f"continuous batching did not amortize crossings: "
        f"{batched_cpt:.3f} >= {solo_cpt:.3f}")
    # with 4 streams fully overlapped the amortization is ~4x; allow slack
    # for the prefill call and ragged tail
    assert batched_cpt <= solo_cpt / 2


def test_eos_retires_early_and_is_emitted(planned):
    ps = prompts(1, seed=3)
    ref = decode_reference(planned.compile(backend="cpu"),
                           planned.for_entry("decode_step").compile(backend="cpu"),
                           ps[0], 12, capacity=2)
    # pick an eos that first appears mid-sequence, so the stream must stop
    # exactly there (a value already seen earlier would stop sooner)
    k = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    eos = int(ref[k])
    with DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=2,
                         eos=eos) as sched:
        out = sched.decode(ps[0], 12, timeout=120)
    assert np.array_equal(out, ref[:k + 1])
    assert out[-1] == eos


def test_sampler_failure_kills_only_its_stream(planned):
    """A sampler exception retires that stream with the error; batch-mates
    decode on, bit-identically."""
    ps = prompts(3, seed=4)
    calls = []

    def sampler(row):
        calls.append(None)
        if len(calls) == 1:            # first sample = first admitted stream
            raise RuntimeError("poisoned sampler")
        return int(np.argmax(row))

    with DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=4,
                         sample=sampler, start=False) as sched:
        sched.warm(PROMPT_LEN)
        streams = [sched.submit(p, 6) for p in ps]
        sched.start()
        with pytest.raises(RuntimeError, match="poisoned sampler"):
            streams[0].result(timeout=120)
        outs = [s.result(timeout=120) for s in streams[1:]]
        rep = sched.report()
    assert rep.failures == 1 and rep.streams == 3
    assert rep.tokens == 2 * 6, "failed stream must not inflate token counts"
    for p, out in zip(ps[1:], outs):
        ref = decode_reference(sched.prefill, sched.step, p, 6, capacity=4)
        assert np.array_equal(ref, out)


def test_submit_validation_and_close(planned):
    sched = DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=2)
    with pytest.raises(ValueError, match="1-D"):
        sched.submit(np.zeros((1, 4), np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(np.zeros((4,), np.int32), 0)
    sched.close()
    sched.close()                      # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(np.zeros((4,), np.int32), 4)


def test_submit_rejects_empty_and_float_prompts(planned):
    """Zero-length and float prompts fail at submit() with a clear error —
    not deep in the engine mid-loop, where the opaque shape/dtype failure
    would take the whole admission group down with it."""
    sched = DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=1,
                            max_pending=1, start=False)
    with pytest.raises(ValueError, match="empty"):
        sched.submit(np.zeros((0,), np.int32), 4)
    with pytest.raises(ValueError, match="integer"):
        sched.submit(np.arange(4, dtype=np.float32), 4)
    with pytest.raises(ValueError, match="integer"):
        sched.submit([0.5, 1.5], 4)               # list of floats
    # rejected submissions ran before the backpressure semaphore: with
    # max_pending=1, a good submit must still go through without blocking
    s = sched.submit(prompts(1, seed=9)[0], 2)
    sched.close()
    assert len(s.result(timeout=1)) == 2
    assert sched.report().streams == 1 and sched.report().failures == 0


def test_concurrent_close_implies_drained(planned):
    """Two threads racing close(): BOTH must block until the loop drains.
    The old early-return on `_closed` let the second closer return before
    the first one's join — "closed" no longer meant "drained"."""
    sched = DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=1,
                            start=False)
    sched.warm(PROMPT_LEN)
    streams = [sched.submit(p, 16) for p in prompts(2, seed=8)]
    drained = []

    def closer():
        sched.close()
        drained.append(all(s.done() for s in streams))

    first = threading.Thread(target=closer)
    first.start()                      # starts the loop, begins draining
    time.sleep(0.05)                   # second closer races in mid-drain
    second = threading.Thread(target=closer)
    second.start()
    first.join(120)
    second.join(120)
    assert drained == [True, True]


def test_submit_backpressure(planned):
    """max_pending bounds outstanding streams: submit() blocks until a
    stream's future resolves, exactly like MixedServer's backpressure."""
    sched = DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=1,
                            max_pending=1, start=False)
    p = prompts(1, seed=7)[0]
    sched.submit(p, 2)
    unblocked = threading.Event()

    def second():
        sched.submit(p, 2)
        unblocked.set()

    t = threading.Thread(target=second, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not unblocked.is_set(), "second submit should block at max_pending"
    sched.start()                      # first stream finishes -> capacity frees
    t.join(60)
    assert unblocked.is_set()
    sched.close()
    assert sched.report().streams == 2


def test_close_finishes_queued_streams(planned):
    """close() decodes everything already submitted, including streams
    still waiting for a slot."""
    ps = prompts(3, seed=5)
    sched = DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=1)
    streams = [sched.submit(p, 3) for p in ps]
    sched.close()
    for p, s in zip(ps, streams):
        ref = decode_reference(sched.prefill, sched.step, p, 3, capacity=1)
        assert np.array_equal(ref, s.result(timeout=1))


def test_scheduler_contract_validation(planned):
    with pytest.raises(ValueError, match="must take"):
        DecodeScheduler(planned, backend="cpu", step="head")      # wrong step arity
    bad = export_decode_lm(vocab=VOCAB, d_model=DM)
    single = mixed.trace(bad).with_entry("head").plan("tech-gfp")
    with pytest.raises(ValueError, match="logits"):
        DecodeScheduler(single, backend="cpu", step="decode_step")  # 1-return prefill


# ---------------------------------------------------------------------------
# report rendering (the "n/a" fix)
# ---------------------------------------------------------------------------


def test_report_na_rendering():
    """Undefined ratio metrics render as "n/a", never "nan"."""
    srv = ServerReport()
    assert math.isnan(srv.crossings_per_request)
    assert "crossings/request=n/a" in str(srv)
    assert "nan" not in str(srv) and "nan" not in srv.table()

    dec = DecodeReport()
    assert math.isnan(dec.tokens_per_crossing)
    assert math.isnan(dec.tokens_per_step)
    assert "tokens/crossing=n/a" in str(dec)
    assert "nan" not in str(dec) and "nan" not in dec.table()
    # the numeric surface stays NaN (documented; as_dict is for machines)
    assert math.isnan(dec.as_dict()["tokens_per_crossing"])


def test_decode_report_counters(planned):
    with DecodeScheduler(planned, backend="cpu", step="decode_step", capacity=2) as sched:
        sched.warm(PROMPT_LEN)
        sched.decode(prompts(1, seed=6)[0], 4, timeout=120)
        rep = sched.report()
    assert rep.streams == 1 and rep.tokens == 4
    assert rep.steps == 3 and rep.prefills == 1
    assert rep.step_tokens == 3                  # first token came from prefill
    assert rep.tokens_per_step == 1.0
    assert rep.warm_calls == 2                   # prefill + step warm
    assert rep.crossings > 0
    assert rep.tokens_per_crossing == rep.tokens / rep.crossings
    assert 0 < rep.step_occupancy <= 1.0
    # warm calls appear in execution, never in serving crossings
    assert rep.execution.guest_to_host > rep.crossings


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

SCHEMES = ["native", "qemu", "tech", "tech-g", "tech-gf", "tech-gfp"]
COUNTERS = ("guest_to_host", "host_to_guest", "conversion_builds", "compiles",
            "grt_hits", "guest_calls", "guest_ops", "nested_crossings")
EXPORTS = {
    "decode-lm": ("export_decode_lm", {"vocab": VOCAB, "d_model": DM}),
    "moe-decode-lm": ("export_moe_decode_lm",
                      {"vocab": VOCAB, "d_model": DM, "max_context": 16,
                       "n_experts": 3, "d_ff": 8}),
}


def _exports(name, **extra):
    from repro.models import programs as jprograms
    from repro_torch.models import programs as tprograms

    fn, kw = EXPORTS[name]
    kw = {**kw, **extra}
    return getattr(jprograms, fn)(**kw), getattr(tprograms, fn)(**kw)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_export_equals_reference(name, seed):
    """Same constants (names, dtypes, values), functions, ops and digest."""
    from repro.serve.aot import program_digest as jdigest
    from repro_torch.serve import program_digest

    jprog, prog = _exports(name, seed=seed)
    assert list(prog.constants) == list(jprog.constants)
    for cname, value in jprog.constants.items():
        assert prog.constants[cname].dtype == value.dtype
        np.testing.assert_array_equal(prog.constants[cname], value, err_msg=cname)
    assert sorted(prog.functions) == sorted(jprog.functions)
    for fname, fn in jprog.functions.items():
        assert [op.kind for op in prog.functions[fname].ops] == [op.kind for op in fn.ops]
        assert [op.params for op in prog.functions[fname].ops] == [op.params for op in fn.ops]
    assert prog.entry == jprog.entry
    assert program_digest(prog) == jdigest(jprog)


def _root_args(name, root, seed=0):
    rng = np.random.default_rng(seed)
    B, S = 3, EXPORTS[name][1].get("max_context")
    tokens = rng.integers(0, VOCAB, (B,), dtype=np.int32)
    if root == "prefill":
        return [rng.integers(0, VOCAB, (B, 6), dtype=np.int32)]
    if name == "decode-lm":
        return [rng.standard_normal((B, DM)).astype(np.float32), tokens]
    K = rng.standard_normal((B, S, DM)).astype(np.float32)
    V = rng.standard_normal((B, S, DM)).astype(np.float32)
    lens = np.array([0, 5, 9], np.int32)
    if root == "decode_step":
        return [K, V, lens, tokens]
    return [K, V, lens, rng.integers(0, VOCAB, (B, 10), dtype=np.int32)]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name,root", [("decode-lm", "prefill"),
                                       ("decode-lm", "decode_step"),
                                       ("moe-decode-lm", "prefill"),
                                       ("moe-decode-lm", "decode_step"),
                                       ("moe-decode-lm", "prefill_suffix")])
def test_roots_match_reference_under_every_scheme(name, root, scheme):
    from repro import mixed as jmixed
    from repro.core import NativeInfeasibleError as JNativeInfeasible
    from repro_torch.core import NativeInfeasibleError

    jprog, prog = _exports(name)
    jtraced = jmixed.trace(jprog).with_entry(root)
    ttraced = mixed.trace(prog).with_entry(root)
    try:
        jh = jtraced.plan(scheme).compile()
    except JNativeInfeasible:
        with pytest.raises(NativeInfeasibleError):
            ttraced.plan(scheme)
        return
    th = ttraced.plan(scheme).compile(backend="cpu")
    for seed in (0, 1):
        args = _root_args(name, root, seed)
        jo, jr = jh.call_reported(*args)
        to, tr = th.call_reported(*args)
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4)
        for f in COUNTERS:
            assert getattr(tr, f) == getattr(jr, f), (scheme, f)
        assert dict(tr.per_function_crossings) == dict(jr.per_function_crossings)
        assert th.plan_for(*args).coverage.as_dict() == jh.plan_for(*args).coverage.as_dict()


def test_greedy_tokens_equal_reference(planned):
    from repro import mixed as jmixed
    from repro.models.programs import export_decode_lm as jexport
    from repro.serve import decode_reference as jdecode_reference

    jplanned = jmixed.trace(jexport(vocab=VOCAB, d_model=DM)).plan("tech-gfp")
    jpre, jstep = jplanned.compile(), jplanned.for_entry("decode_step").compile()
    pre = planned.compile(backend="cpu")
    step = planned.for_entry("decode_step").compile(backend="cpu")
    for p in prompts(4, seed=13):
        np.testing.assert_array_equal(
            decode_reference(pre, step, p, 10, capacity=4),
            jdecode_reference(jpre, jstep, p, 10, capacity=4))
