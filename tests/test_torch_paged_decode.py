"""Decode serving on the port: ``DecodeScheduler`` over paged KV state.

The ``decode_paged_kernel`` workload (the 4-stream burst of
``benchmarks/smoke_decode.py:paged_kernel_workload``) runs on the port with
``backend="cpu"`` (the kernel's plain version) and on the reference: the
greedy tokens are equal, and the counters of ``BENCH_serve.json``'s
``decode_paged_kernel`` section are reproduced exactly.  The port's own
bitwise contracts — batched streams equal their solo oracles — hold in the
dense-paged and the paged-kernel modes.  The reference package is imported
inside the tests that use it, so the ``gpu`` case also runs on a machine
without JAX.
"""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import mixed
from repro_torch.models.programs import (
    export_attn_decode_lm,
    load_reference_constants,
)
from repro_torch.serve import (
    DecodeScheduler,
    StateSpec,
    decode_reference,
    paged_decode_reference,
)

ROOT = Path(__file__).resolve().parents[1]
VOCAB, DM, MAX_CTX, PAGE, PROMPT_LEN = 32, 16, 24, 4, 6
LENS = (6, 8, 10, 12)


def _reference():
    """(mixed, serve, export_attn_decode_lm) of the JAX package."""
    from repro import mixed as jmixed
    from repro import serve as jserve
    from repro.models.programs import export_attn_decode_lm as jexport
    return jmixed, jserve, jexport


def _prompts(n, seed, length=PROMPT_LEN):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (length,), dtype=np.int32) for _ in range(n)]


def _spec(page_size=PAGE):
    return StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX, page_size=page_size)


def _decode_paged_kernel(serve, planned, spec, **kw):
    """The decode_paged_kernel burst on either package's scheduler."""
    prompts = _prompts(len(LENS), seed=11)
    with serve.DecodeScheduler(planned, step="decode_step",
                               paged_step="paged_decode_step",
                               capacity=len(LENS), state=spec, start=False,
                               **kw) as sched:
        sched.warm(PROMPT_LEN)
        streams = [sched.submit(p, n) for p, n in zip(prompts, LENS)]
        sched.start()
        outs = [s.result(timeout=240) for s in streams]
    return prompts, outs, sched.report(), sched


@pytest.fixture(scope="module")
def planned():
    return mixed.trace(export_attn_decode_lm(
        vocab=VOCAB, d_model=DM, max_context=MAX_CTX)).plan("tech-gfp")


@pytest.fixture(scope="module")
def reference_run():
    jmixed, jserve, jexport = _reference()
    jplanned = jmixed.trace(jexport(vocab=VOCAB, d_model=DM,
                                    max_context=MAX_CTX)).plan("tech-gfp")
    spec = jserve.StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX,
                            page_size=PAGE)
    return _decode_paged_kernel(jserve, jplanned, spec)


@pytest.fixture(scope="module")
def port_run(planned):
    from repro_torch import serve
    return _decode_paged_kernel(serve, planned, _spec(), backend="cpu")


def test_tokens_equal_reference(port_run, reference_run):
    _, outs, _, _ = port_run
    _, ref_outs, _, _ = reference_run
    for a, b in zip(outs, ref_outs):
        assert np.array_equal(a, b)


def test_bench_serve_counters_reproduced(port_run):
    """``BENCH_serve.json`` decode_paged_kernel, exactly."""
    want = json.loads((ROOT / "BENCH_serve.json").read_text())["decode_paged_kernel"]
    prompts, outs, rep, sched = port_run
    violations = 0
    pstep = sched.paged_step_planned.compile(backend="cpu")
    for p, n, out in zip(prompts, LENS, outs):
        dense = decode_reference(sched.prefill, sched.step, p, n, capacity=len(LENS))
        paged = paged_decode_reference(sched.prefill, pstep, p, n,
                                       capacity=len(LENS), state=_spec())
        violations += not np.array_equal(dense, out) or not np.array_equal(paged, out)
    walk = rep.kernel_steps * len(LENS) * _spec().pages_per_stream
    got = {
        "bit_identity_violations": violations,
        "dense_equivalent_pages": walk,
        "kernel_steps": rep.kernel_steps,
        "page_visit_fraction": rep.page_visit_fraction,
        "pages_skipped": rep.pages_skipped,
        "pages_visited": rep.pages_visited,
        "state_bytes_per_crossing": rep.state_bytes_per_crossing,
        "streams": rep.streams,
        "tokens": rep.tokens,
        "tokens_per_crossing": rep.tokens_per_crossing,
    }
    assert got == want
    assert rep.kernel_steps == rep.steps
    assert rep.pages_in_use == 0 and rep.page_allocs == rep.page_frees > 0
    assert sched._paged.pool.refs_outstanding == 0


def test_report_counters_equal_reference(port_run, reference_run):
    """Every counter of the two DecodeReports (timings aside) is equal."""
    _, _, rep, _ = port_run
    _, _, jrep, _ = reference_run
    skip = {"admit_wait_total", "admit_wait_max", "mean_admit_wait",
            "execution", "latency"}
    mine, theirs = rep.as_dict(), jrep.as_dict()
    for k in set(theirs) - skip:
        assert mine[k] == theirs[k], k
    for f in ("guest_to_host", "host_to_guest", "conversion_builds",
              "compiles", "grt_hits", "calls"):
        assert getattr(rep.execution, f) == getattr(jrep.execution, f), f


def test_reference_constants_carried_across(reference_run):
    """A port program exported from another seed decodes the reference's
    tokens once the reference program's constants are loaded into it."""
    _, _, jexport = _reference()
    jprog = jexport(vocab=VOCAB, d_model=DM, max_context=MAX_CTX)
    prog = export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=MAX_CTX, seed=5)
    assert not np.array_equal(prog.constants["Wq"], jprog.constants["Wq"])
    load_reference_constants(prog, jprog.constants)
    from repro_torch import serve
    _, outs, _, _ = _decode_paged_kernel(
        serve, mixed.trace(prog).plan("tech-gfp"), _spec(), backend="cpu")
    for a, b in zip(outs, reference_run[1]):
        assert np.array_equal(a, b)


def test_same_seed_gives_bitwise_equal_constants():
    _, _, jexport = _reference()
    jprog = jexport(vocab=VOCAB, d_model=DM, max_context=MAX_CTX, seed=3)
    prog = export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=MAX_CTX, seed=3)
    assert set(prog.constants) == set(jprog.constants)
    for k, v in jprog.constants.items():
        assert prog.constants[k].dtype == v.dtype
        assert np.array_equal(prog.constants[k], v), k


def test_load_reference_constants_refuses_mismatches():
    _, _, jexport = _reference()
    prog = export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=MAX_CTX)
    wider = jexport(vocab=VOCAB, d_model=2 * DM, max_context=MAX_CTX).constants
    with pytest.raises(ValueError, match="program has float32"):
        load_reference_constants(prog, wider)
    fewer = dict(jexport(vocab=VOCAB, d_model=DM, max_context=MAX_CTX).constants)
    fewer.pop("Wo")
    with pytest.raises(ValueError, match="missing"):
        load_reference_constants(prog, fewer)
    cast = dict(jexport(vocab=VOCAB, d_model=DM, max_context=MAX_CTX).constants)
    cast["E"] = cast["E"].astype(np.float64)
    with pytest.raises(ValueError, match="'E'"):
        load_reference_constants(prog, cast)


def test_dense_paged_mode_matches_reference_tokens(planned):
    """The dense-paged step mode (paged storage, dense gather at the
    crossing): bit-identical to solo decoding and to the reference."""
    jmixed, jserve, jexport = _reference()
    prompts = _prompts(4, seed=13)
    lens = [8, 10, 4, 5]
    with DecodeScheduler(planned, step="decode_step", capacity=4,
                         state=_spec(), start=False, backend="cpu") as sched:
        sched.warm(PROMPT_LEN)
        streams = [sched.submit(p, n) for p, n in zip(prompts, lens)]
        sched.start()
        outs = [s.result(timeout=240) for s in streams]
        rep = sched.report()
    jplanned = jmixed.trace(jexport(vocab=VOCAB, d_model=DM,
                                    max_context=MAX_CTX)).plan("tech-gfp")
    jprefill = jplanned.compile()
    jstep = jplanned.for_entry("decode_step").compile()
    for p, n, out in zip(prompts, lens, outs):
        ref = decode_reference(sched.prefill, sched.step, p, n, capacity=4)
        assert np.array_equal(ref, out)
        assert np.array_equal(jserve.decode_reference(jprefill, jstep, p, n,
                                                      capacity=4), out)
    assert rep.kernel_steps == 0 and rep.steps > 0
    assert rep.pages_in_use == 0 and rep.page_allocs == rep.page_frees > 0


def test_paged_kernel_midflight_admission_bit_identical(planned):
    prompts = _prompts(4, seed=17)
    lens = [8, 10, 4, 5]
    with DecodeScheduler(planned, step="decode_step",
                         paged_step="paged_decode_step", capacity=4,
                         state=_spec(), backend="cpu") as sched:
        sched.warm(PROMPT_LEN)
        first = [sched.submit(prompts[i], lens[i]) for i in (0, 1)]
        deadline = time.time() + 60
        while sched.report().steps < 2 and time.time() < deadline:
            time.sleep(0.005)
        late = [sched.submit(prompts[i], lens[i]) for i in (2, 3)]
        outs = [s.result(timeout=240) for s in first + late]
        rep = sched.report()
    assert all(s.admitted_step > 0 for s in late)
    pstep = sched.paged_step_planned.compile(backend="cpu")
    for p, n, out in zip(prompts, lens, outs):
        ref = paged_decode_reference(sched.prefill, pstep, p, n, capacity=4,
                                     state=_spec())
        assert np.array_equal(ref, out)
    assert rep.kernel_steps == rep.steps
    assert rep.pages_in_use == 0 and rep.page_allocs == rep.page_frees > 0


@pytest.mark.parametrize("capacity", [1, 2, 5])
def test_randomized_paged_kernel_stress(planned, capacity):
    """Random prompt lengths, page sizes and retirement times: every stream
    equals its solo paged oracle; the pool drains leak-free."""
    rng = np.random.default_rng(200 + capacity)
    page_size = int(rng.choice([2, 4, 5]))
    spec = _spec(page_size)
    jobs = [(_prompts(1, seed=2000 + i, length=int(rng.choice([3, 5, 8])))[0],
             int(rng.integers(1, 9))) for i in range(6)]
    with DecodeScheduler(planned, step="decode_step",
                         paged_step="paged_decode_step", capacity=capacity,
                         state=spec, start=False, backend="cpu") as sched:
        streams = [sched.submit(p, n) for p, n in jobs]
        sched.start()
        outs = [s.result(timeout=240) for s in streams]
        rep = sched.report()
    pstep = sched.paged_step_planned.compile(backend="cpu")
    for (p, n), out in zip(jobs, outs):
        assert len(out) == n
        ref = paged_decode_reference(sched.prefill, pstep, p, n,
                                     capacity=capacity, state=spec)
        assert np.array_equal(ref, out)
    assert rep.failures == 0
    assert rep.pages_in_use == 0 and rep.page_allocs == rep.page_frees
    assert sched._paged.pool.refs_outstanding == 0


@pytest.mark.parametrize("paged_step", [None, "paged_decode_step"])
def test_prefix_shared_burst_matches_reference(planned, paged_step):
    """Four prompts sharing an 8-token prefix (two pages): the prefix pages
    are mapped once and reused, and tokens and sharing counters equal the
    reference's, in the dense-paged and the paged-kernel step modes."""
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, VOCAB, (8,), dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, VOCAB, (4,), np.int32)])
               for _ in range(4)]
    lens = [5, 6, 7, 8]

    def run(serve, planned, **kw):
        spec = serve.StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX,
                               page_size=PAGE, share_prefixes=True)
        with serve.DecodeScheduler(planned, step="decode_step", capacity=4,
                                   state=spec, prefill_suffix="prefill_suffix",
                                   paged_step=paged_step, start=False,
                                   **kw) as sched:
            sched.warm(12)
            streams = [sched.submit(p, n) for p, n in zip(prompts, lens)]
            sched.start()
            outs = [s.result(timeout=240) for s in streams]
        return outs, sched.report(), sched

    from repro_torch import serve
    jmixed, jserve, jexport = _reference()
    jplanned = jmixed.trace(jexport(vocab=VOCAB, d_model=DM,
                                    max_context=MAX_CTX)).plan("tech-gfp")
    outs, rep, sched = run(serve, planned, backend="cpu")
    ref_outs, ref_rep, _ = run(jserve, jplanned)
    for p, n, out, ref in zip(prompts, lens, outs, ref_outs):
        assert np.array_equal(out, ref)
        solo = decode_reference(sched.prefill, sched.step, p, n, capacity=4)
        assert np.array_equal(out, solo)
    assert (rep.prefix_hits, rep.prefix_tokens_reused, rep.pages_shared,
            rep.pages_cow_copied) == (3, 3 * 8, 3 * 2, 0)
    for k in ("prefix_hits", "prefix_tokens_reused", "pages_shared",
              "pages_cow_copied", "state_bytes_saved", "pages_peak",
              "kernel_steps", "pages_visited", "crossings", "tokens"):
        assert getattr(rep, k) == getattr(ref_rep, k), k
    assert rep.pages_in_use == 0 and rep.page_allocs == rep.page_frees > 0
    assert sched._paged.pool.refs_outstanding == 0


def test_default_backend_raises_without_cuda(planned):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="CUDA"):
        planned.compile()
    with pytest.raises(ValueError, match="CUDA"):
        DecodeScheduler(planned, step="decode_step",
                        paged_step="paged_decode_step", capacity=2,
                        state=_spec(), start=False)


def test_paged_step_validation(planned):
    with pytest.raises(ValueError, match="needs a paged StateSpec"):
        DecodeScheduler(planned, step="decode_step",
                        paged_step="paged_decode_step", capacity=2,
                        start=False, backend="cpu")
    with pytest.raises(KeyError, match="unknown paged_step"):
        DecodeScheduler(planned, step="decode_step", paged_step="nope",
                        capacity=2, state=_spec(), start=False, backend="cpu")
    with pytest.raises(ValueError, match="pool buffers"):
        DecodeScheduler(planned, step="decode_step", paged_step="decode_step",
                        capacity=2, state=_spec(), start=False, backend="cpu")


@pytest.mark.gpu
def test_paged_kernel_workload_on_the_card_matches_cpu(planned):
    """On the card, the burst decodes the CPU run's tokens and counters."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    from repro_torch import serve
    from repro_torch.kernels.decode_attention import paged_decode_attention_kernel
    _, cpu, cpu_rep, _ = _decode_paged_kernel(serve, planned, _spec(), backend="cpu")
    before = paged_decode_attention_kernel.launches
    _, gpu, rep, _ = _decode_paged_kernel(serve, planned, _spec())
    assert paged_decode_attention_kernel.launches - before >= rep.kernel_steps > 0
    for a, b in zip(gpu, cpu):
        assert np.array_equal(a, b)
    assert (rep.pages_visited, rep.pages_skipped) == (cpu_rep.pages_visited,
                                                      cpu_rep.pages_skipped)
