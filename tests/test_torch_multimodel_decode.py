"""Multi-model co-serving on the port (``MultiModelDecodeScheduler``).

Ports of the eight tests of ``tests/test_multimodel_decode.py``: the mamba2
SSM (fixed-size per-stream state, ``StateSpec(growing={})``) and the
attention LM (growing paged KV) decode concurrently in one scheduler over
one shared ``PagePool``; every stream's tokens are bit-identical to its own
model's solo ``decode_reference``; the SSM lane never touches the pool; the
shared pool's cross-tenant leak identity holds at close; misuse fails
loudly.  The units run with ``backend="cpu"``.

Beside them: the port's ``export_mamba2_decode_lm`` has the reference's
constants and ``program_digest`` and, under all six schemes, its crossing,
compile and coverage counters; and the ``decode_multimodel`` workload
(``benchmarks/smoke_decode.py:multimodel_workload``) reproduces
``BENCH_serve.json``'s section exactly, with the reference's tokens.  The
reference package is imported inside the tests that use it.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch import mixed
from repro_torch.models.programs import (
    export_attn_decode_lm,
    export_mamba2_decode_lm,
    load_reference_constants,
)
from repro_torch.serve import (
    DecodeScheduler,
    MultiModelDecodeScheduler,
    PagePool,
    StateSpec,
    decode_reference,
)

ROOT = Path(__file__).resolve().parents[1]
VOCAB, DM, MAX_CTX = 32, 16, 24
CAPACITY = 3
CPU = dict(backend="cpu")
SCHEMES = ["native", "qemu", "tech", "tech-g", "tech-gf", "tech-gfp"]
COUNTERS = ("guest_to_host", "host_to_guest", "conversion_builds", "compiles",
            "grt_hits", "guest_calls", "guest_ops", "nested_crossings",
            "max_reentry_depth", "max_interleave_depth")


@pytest.fixture(scope="module")
def planned_attn():
    """One attention plan for the module: lanes share offload units."""
    return mixed.trace(
        export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=MAX_CTX)
    ).plan("tech-gfp")


@pytest.fixture(scope="module")
def planned_mamba2():
    return mixed.trace(export_mamba2_decode_lm(vocab=VOCAB, d_model=DM)).plan("tech-gfp")


@pytest.fixture(scope="module")
def oracles(planned_attn, planned_mamba2):
    """Solo (prefill, step) pairs per model, compiled once."""
    return {
        name: (p.compile(**CPU), p.for_entry("decode_step").compile(**CPU))
        for name, p in (("attn", planned_attn), ("mamba2", planned_mamba2))
    }


def attn_spec(page_size: int = 4) -> StateSpec:
    return StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX, page_size=page_size)


def build_multi(planned_attn, planned_mamba2, **kwargs):
    multi = MultiModelDecodeScheduler(**kwargs)
    multi.register("attn", planned_attn, step="decode_step",
                   capacity=CAPACITY, state=attn_spec(), **CPU)
    multi.register("mamba2", planned_mamba2, step="decode_step",
                   capacity=CAPACITY, **CPU)
    return multi


def prompts(n: int, length: int = 5, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (length,), dtype=np.int32) for _ in range(n)]


# ---------------------------------------------------------------------------
# ports of tests/test_multimodel_decode.py
# ---------------------------------------------------------------------------

def test_multimodel_bit_identity_interleaved(planned_attn, planned_mamba2, oracles):
    """Interleaved admissions across models, staggered max_new_tokens (so
    streams retire mid-flight while the other model keeps stepping): every
    stream must match its model's solo oracle bitwise."""
    multi = build_multi(planned_attn, planned_mamba2, start=False)
    jobs = []
    with multi:
        for i, p in enumerate(prompts(2 * CAPACITY, seed=1)):
            model = "attn" if i % 2 == 0 else "mamba2"
            jobs.append((model, p, 3 + i % 4, multi.submit(p, 3 + i % 4, model=model)))
        multi.start()       # admit the whole burst deterministically
        results = [(m, p, n, s.result(timeout=300)) for m, p, n, s in jobs]
    for model, prompt, max_new, toks in results:
        ref = decode_reference(*oracles[model], prompt, max_new, capacity=CAPACITY)
        assert np.array_equal(toks, ref), (
            f"{model} stream diverged from its solo oracle: "
            f"{toks.tolist()} != {ref.tolist()}")
    rep = multi.report()
    assert rep.streams == len(jobs) and rep.failures == 0
    assert rep.models["attn"].steps > 0 and rep.models["mamba2"].steps > 0
    # one batched prefill/step per model per iteration, never a fused call
    assert rep.crossings == (rep.models["attn"].crossings
                             + rep.models["mamba2"].crossings)


def test_degenerate_spec_zero_page_accounting(planned_attn, planned_mamba2):
    """The fixed-size-state lane never touches the shared pool, while its
    paged co-tenant pages normally."""
    multi = build_multi(planned_attn, planned_mamba2)
    with multi:
        for p in prompts(CAPACITY, seed=2):
            multi.submit(p, 4, model="mamba2")
            multi.submit(p, 4, model="attn")
        rep_mid = multi.report()        # while traffic may be in flight
    rep = multi.report()
    ssm = rep.models["mamba2"]
    assert ssm.page_allocs == 0 and ssm.page_frees == 0
    assert ssm.page_capacity == 0 and ssm.pages_peak == 0
    assert rep.models["attn"].page_allocs > 0
    assert rep_mid.models["mamba2"].page_allocs == 0
    assert ssm.state_bytes_per_crossing < rep.models["attn"].state_bytes_per_crossing


def test_fixed_row_scheduler_rejects_pool_plumbing(planned_mamba2):
    """page_pool/page_quota without growing state is a contract error."""
    with pytest.raises(ValueError, match="fixed-row state"):
        DecodeScheduler(planned_mamba2, step="decode_step", capacity=2,
                        start=False, page_pool=PagePool(4, 4), **CPU)
    with pytest.raises(ValueError, match="fixed-row state"):
        DecodeScheduler(planned_mamba2, step="decode_step", capacity=2,
                        start=False, page_quota=4, **CPU)


def test_shared_pool_leak_identity_at_close(planned_attn, planned_mamba2):
    multi = build_multi(planned_attn, planned_mamba2)
    with multi:
        for i, p in enumerate(prompts(4, seed=3)):
            multi.submit(p, 3 + i, model="attn")
            multi.submit(p, 3 + i, model="mamba2")
    rep = multi.report()
    assert rep.pool_allocs - rep.pool_frees == rep.pool_in_use == 0
    assert rep.pool_refs_outstanding == 0
    assert rep.pool_allocs == sum(r.page_allocs for r in rep.models.values())
    assert rep.pool_frees == sum(r.page_frees for r in rep.models.values())
    assert rep.pool_allocs > 0
    assert rep.pool_pages == sum(r.page_capacity for r in rep.models.values())


def test_quota_partitioning_gates_each_lane(planned_attn):
    """Two paged lanes over one pool: each admission-gates against its own
    quota, even though the shared pool still has free pages."""
    multi = MultiModelDecodeScheduler(start=False)
    small = StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX, page_size=4, pages=2)
    multi.register("small", planned_attn, step="decode_step", capacity=CAPACITY,
                   state=small, **CPU)
    multi.register("big", planned_attn, step="decode_step", capacity=CAPACITY,
                   state=attn_spec(), **CPU)
    with multi:
        with pytest.raises(ValueError, match="page quota"):
            multi.submit(np.arange(5, dtype=np.int32), 8, model="small")
        s = multi.submit(np.arange(5, dtype=np.int32), 8, model="big")
        multi.start()
        assert s.result(timeout=300).shape == (8,)
    assert multi.report().pool_in_use == 0


def test_submit_routing_validation(planned_attn, planned_mamba2):
    multi = build_multi(planned_attn, planned_mamba2, start=False)
    with pytest.raises(KeyError, match="unknown model 'xlstm'"):
        multi.submit(np.arange(4, dtype=np.int32), 2, model="xlstm")
    with pytest.raises(RuntimeError, match="after the scheduler started"):
        multi.register("late", planned_mamba2, step="decode_step")
    multi.close()
    with pytest.raises(RuntimeError, match="closed"):
        multi.submit(np.arange(4, dtype=np.int32), 2, model="mamba2")


def test_registration_validation(planned_attn, planned_mamba2):
    multi = MultiModelDecodeScheduler()
    with pytest.raises(RuntimeError, match="no models registered"):
        multi.submit(np.arange(4, dtype=np.int32), 2, model="attn")
    multi.register("attn", planned_attn, step="decode_step", capacity=2,
                   state=attn_spec(page_size=4), **CPU)
    with pytest.raises(ValueError, match="already registered"):
        multi.register("attn", planned_mamba2, step="decode_step")
    with pytest.raises(TypeError, match="manages 'page_pool'"):
        multi.register("x", planned_attn, step="decode_step", page_pool=None)
    multi.register("attn8", planned_attn, step="decode_step", capacity=2,
                   state=attn_spec(page_size=8), **CPU)
    with pytest.raises(ValueError, match="page_size"):
        multi.submit(np.arange(4, dtype=np.int32), 2, model="attn")
    multi2 = MultiModelDecodeScheduler()
    multi2.close()          # closing an empty scheduler is a no-op
    assert multi2.registered == ()


def test_lane_failure_contained_to_its_model(planned_attn, planned_mamba2, oracles):
    """A poisoned sampler on one model's lane fails that lane's streams;
    the co-tenant keeps decoding bit-identically."""
    def bomb(_logits):
        raise RuntimeError("poisoned sampler")

    multi = MultiModelDecodeScheduler(start=False)
    multi.register("attn", planned_attn, step="decode_step", capacity=CAPACITY,
                   state=attn_spec(), sample=bomb, **CPU)
    multi.register("mamba2", planned_mamba2, step="decode_step", capacity=CAPACITY, **CPU)
    p = np.arange(5, dtype=np.int32) % VOCAB
    with multi:
        bad = multi.submit(p, 4, model="attn")
        good = multi.submit(p, 4, model="mamba2")
        multi.start()
        with pytest.raises(RuntimeError, match="poisoned sampler"):
            bad.result(timeout=300)
        toks = good.result(timeout=300)
    ref = decode_reference(*oracles["mamba2"], p, 4, capacity=CAPACITY)
    assert np.array_equal(toks, ref)
    rep = multi.report()
    assert rep.models["attn"].failures == 1
    assert rep.models["mamba2"].failures == 0
    assert rep.pool_in_use == 0 and rep.pool_refs_outstanding == 0


# ---------------------------------------------------------------------------
# export_mamba2_decode_lm against the reference's
# ---------------------------------------------------------------------------

EXPORTS = [dict(), dict(vocab=64, d_model=32, state_dim=8, head_dim=4, seed=3),
           dict(with_host_check=False)]


@pytest.mark.parametrize("kw", EXPORTS, ids=["default", "wider", "no-check"])
def test_export_equals_reference(kw):
    """Same constants (names, values), functions, ops and digest."""
    from repro.models.programs import export_mamba2_decode_lm as jexport
    from repro.serve.aot import program_digest

    jprog, prog = jexport(**kw), export_mamba2_decode_lm(**kw)
    assert list(prog.constants) == list(jprog.constants)
    for name, value in jprog.constants.items():
        assert prog.constants[name].dtype == value.dtype
        np.testing.assert_array_equal(prog.constants[name], value, err_msg=name)
    assert sorted(prog.functions) == sorted(jprog.functions)
    for fname, fn in jprog.functions.items():
        assert [op.kind for op in prog.functions[fname].ops] == [op.kind for op in fn.ops]
    assert program_digest(prog) == program_digest(jprog)
    # the carried constants install on an export from another seed
    other = export_mamba2_decode_lm(**{**kw, "seed": 11})
    load_reference_constants(other, jprog.constants)
    assert program_digest(other) == program_digest(jprog)


def _root_args(root, seed=0):
    rng = np.random.default_rng(seed)
    if root == "prefill":
        return [rng.integers(0, VOCAB, (CAPACITY, 6), dtype=np.int32)]
    return [rng.standard_normal((CAPACITY, 4 * 4)).astype(np.float32),
            rng.integers(0, VOCAB, (CAPACITY,), dtype=np.int32)]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("root", ["prefill", "decode_step"])
def test_roots_match_reference_under_every_scheme(root, scheme):
    """Outputs to the engine tolerance (2e-3/2e-4), and equal crossing,
    compile and coverage counters, call after call; ``native`` is refused
    by both (the host check)."""
    from repro import mixed as jmixed
    from repro.core import NativeInfeasibleError as JNativeInfeasible
    from repro.models.programs import export_mamba2_decode_lm as jexport
    from repro_torch.core import NativeInfeasibleError

    prog = export_mamba2_decode_lm(vocab=VOCAB, d_model=DM)
    try:
        jplanned = jmixed.trace(jexport(vocab=VOCAB, d_model=DM)).plan(scheme)
    except JNativeInfeasible:
        with pytest.raises(NativeInfeasibleError):
            mixed.trace(prog).plan(scheme)
        return
    planned = mixed.trace(prog).plan(scheme)
    if root != "prefill":
        jplanned, planned = jplanned.for_entry(root), planned.for_entry(root)
    jh, th = jplanned.compile(), planned.compile(**CPU)
    for call in range(2):
        args = _root_args(root, seed=call)
        jo, jr = jh.call_reported(*args)
        to, tr = th.call_reported(*args)
        assert len(jo) == len(to) == 2
        for a, b in zip(jo, to):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4)
        for f in COUNTERS:
            assert getattr(tr, f) == getattr(jr, f), (scheme, call, f)
        assert dict(tr.per_function_crossings) == dict(jr.per_function_crossings)
        jplan, tplan = jh.plan_for(*args), th.plan_for(*args)
        assert tplan.coverage.as_dict() == jplan.coverage.as_dict()
        assert sorted(tplan.units) == sorted(jplan.units)
        assert tplan.decisions == jplan.decisions


# ---------------------------------------------------------------------------
# decode_multimodel: BENCH_serve.json, exactly
# ---------------------------------------------------------------------------

def multimodel_workload(serve, mixed_mod, exports, **kw):
    """benchmarks/smoke_decode.py:multimodel_workload on either package."""
    vocab, dm, max_ctx, prompt_len = 32, 16, 24, 6
    capacity, lens = 3, (5, 6, 7, 8, 9, 10)
    attn_export, mamba2_export = exports
    planneds = {
        "attn": mixed_mod.trace(attn_export(vocab=vocab, d_model=dm,
                                            max_context=max_ctx)).plan("tech-gfp"),
        "mamba2": mixed_mod.trace(mamba2_export(vocab=vocab, d_model=dm)).plan("tech-gfp"),
    }
    spec = serve.StateSpec(growing={0: 1, 1: 1}, max_context=max_ctx, page_size=4)
    rng = np.random.default_rng(23)
    ps = [rng.integers(0, vocab, (prompt_len,), dtype=np.int32) for _ in range(len(lens))]
    multi = serve.MultiModelDecodeScheduler(start=False)
    multi.register("attn", planneds["attn"], step="decode_step", capacity=capacity,
                   state=spec, **kw)
    multi.register("mamba2", planneds["mamba2"], step="decode_step",
                   capacity=capacity, **kw)
    jobs = []
    with multi:
        for i, (p, n) in enumerate(zip(ps, lens)):
            model = "attn" if i % 2 == 0 else "mamba2"
            jobs.append((model, p, multi.submit(p, n, model=model)))
        multi.start()
        outs = [(m, p, s.result(timeout=120)) for m, p, s in jobs]
    return outs, multi.report(), planneds, capacity


def decode_multimodel_counters(outs, rep, planneds, capacity, **kw):
    """The decode_multimodel section of BENCH_serve.json, as the smoke gate
    computes it."""
    oracle = {name: (p.compile(**kw), p.for_entry("decode_step").compile(**kw))
              for name, p in planneds.items()}
    violations = sum(
        not np.array_equal(decode_reference(*oracle[m], p, len(t), capacity=capacity), t)
        for m, p, t in outs)
    ssm, attn = rep.models["mamba2"], rep.models["attn"]
    return {
        "attn_page_allocs": attn.page_allocs,
        "attn_state_bytes_per_crossing": attn.state_bytes_per_crossing,
        "attn_tokens_per_crossing": attn.tokens_per_crossing,
        "bit_identity_violations": violations,
        "models": len(rep.models),
        "pool_in_use_at_close": rep.pool_in_use,
        "pool_pages": rep.pool_pages,
        "pool_peak": rep.pool_peak,
        "pool_refs_outstanding_at_close": rep.pool_refs_outstanding,
        "ssm_page_allocs": ssm.page_allocs,
        "ssm_state_bytes_per_crossing": ssm.state_bytes_per_crossing,
        "ssm_tokens_per_crossing": ssm.tokens_per_crossing,
        "state_bytes_per_crossing": rep.state_bytes_per_crossing,
        "streams": rep.streams,
        "tokens": rep.tokens,
        "tokens_per_crossing": rep.tokens_per_crossing,
    }


def test_decode_multimodel_reproduces_bench_serve():
    from repro_torch import serve

    want = json.loads((ROOT / "BENCH_serve.json").read_text())["decode_multimodel"]
    outs, rep, planneds, capacity = multimodel_workload(
        serve, mixed, (export_attn_decode_lm, export_mamba2_decode_lm), **CPU)
    assert decode_multimodel_counters(outs, rep, planneds, capacity, **CPU) == want
    assert rep.failures == 0 and rep.pool_allocs - rep.pool_frees == 0


def test_decode_multimodel_tokens_equal_reference():
    from repro import mixed as jmixed
    from repro import serve as jserve
    from repro.models import programs as jprograms
    from repro_torch import serve

    outs, rep, _, _ = multimodel_workload(
        serve, mixed, (export_attn_decode_lm, export_mamba2_decode_lm), **CPU)
    jouts, jrep, _, _ = multimodel_workload(
        jserve, jmixed, (jprograms.export_attn_decode_lm, jprograms.export_mamba2_decode_lm))
    for (m, p, t), (jm, jp, jt) in zip(outs, jouts):
        assert m == jm and np.array_equal(p, jp) and np.array_equal(t, jt)
    skip = {"admit_wait_total", "admit_wait_max", "mean_admit_wait", "execution",
            "latency"}
    for name, r in rep.models.items():
        mine, theirs = r.as_dict(), jrep.models[name].as_dict()
        for k in set(theirs) - skip:
            same_nan = isinstance(theirs[k], float) and np.isnan(theirs[k]) \
                and np.isnan(mine[k])      # a ratio still undefined in both
            assert mine[k] == theirs[k] or same_nan, (name, k)
