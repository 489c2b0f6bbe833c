"""CI smoke gate for token-level continuous batching: bounded, assertion-driven.

Decodes 6 concurrent streams (staggered lengths) of the decode-loop LM two
ways and gates the tentpole invariants, then repeats the duel on the
**paged attention workload** (``export_attn_decode_lm`` + ``StateSpec``):
4 concurrent attention-decode streams, bit-identical to the solo oracle,
tokens/crossing strictly above request-level serving of the same workload,
and zero leaked pages at close.  A third section gates the **block-sparse
paged kernel** (``paged_step="paged_decode_step"``): the same burst stepped
through the paged-attention kernel must match both solo oracles
bit-for-bit while visiting strictly fewer pages than the dense-equivalent
walk.  A fourth gates **prefix sharing**: 4 streams with a common
page-aligned prompt prefix must stay bit-identical to the solo oracle while
peaking strictly below the unshared run.  A fifth gates **heterogeneous
multi-model co-serving** (``MultiModelDecodeScheduler``): an interleaved
mamba2 (fixed-size SSM state) + attention-LM (paged KV) burst in one
scheduler over one shared page pool — zero bit-identity violations against
each model's own solo oracle, zero SSM page traffic, SSM state bytes per
crossing strictly below the attention LM's, and a leak-free shared pool at
close.  The last section is the **card section**: the paged-kernel solo
oracle with its units on the card must give the tokens of the same oracle
on the CPU, with the paged kernel launched once per kernel step, all on
its ``split`` body.  Under ``--device cpu`` it prints one row saying that
it was not requested.

* **continuous batching** (:class:`repro_torch.serve.DecodeScheduler`): one
  batched prefill admits the burst, every step issues ONE batched entry
  crossing for all live streams, finished streams retire immediately;
* **request-level serving** of the same workload: each client thread runs
  its own prefill and then submits one single-row step request per token
  to a :class:`repro_torch.serve.MixedServer` over the same step plan.

Gated:

* every continuous-batching stream is **bit-identical** to solo decoding
  (``decode_reference`` at the same fixed capacity);
* tokens per guest→host crossing under continuous batching is **strictly
  greater** than under request-level serving;
* retirement/admission bookkeeping: steps equal the longest stream's step
  count (no padding to the slowest), and prefill admitted the whole burst
  in one call;
* prefix sharing: ≥4 streams sharing a page-aligned prefix are
  bit-identical to the oracle, ``pages_peak`` is strictly below the
  sharing-disabled run, ``prefix_tokens_reused > 0``, and the pool drains
  with zero page leaks and zero refcount leaks.

The units run on the CUDA card unless ``--device cpu`` is given.  Failures
print the offending report table before exiting non-zero.  Exit status is
the verdict:

    PYTHONPATH=src python -m repro_torch.bench.smoke_decode [--device cpu]
"""
from __future__ import annotations

import threading

import numpy as np

from .. import mixed
from ..core.api import resolve_device
from ..kernels import ops
from ..models.programs import (
    export_attn_decode_lm,
    export_decode_lm,
    export_mamba2_decode_lm,
)
from ..serve import (
    BucketLadder,
    DecodeScheduler,
    MixedServer,
    MultiModelDecodeScheduler,
    StateSpec,
    decode_reference,
    greedy_sample,
    paged_decode_reference,
)
from .common import check, finish_gate, gate_main
from .serve_sections import prefix_workload

VOCAB, DM, PROMPT_LEN = 48, 24, 8
N_STREAMS = 6
LENS = (8, 10, 12, 14, 16, 18)          # staggered: exercises early retirement
# the kernels this gate's path launches on the card: the paged step's
# ``paged_attention`` op and the attention LM's prefill ``sdpa``
KERNELS = ("paged_decode_attention", "flash_attention")


def run(device=None, *, rows: list | None = None) -> list[str]:
    """Continuous batching against request-level serving (the decode LM)."""
    resolve_device(device)
    rows = [] if rows is None else rows
    planned = mixed.trace(export_decode_lm(vocab=VOCAB, d_model=DM)).plan("tech-gfp")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, (PROMPT_LEN,), dtype=np.int32)
               for _ in range(N_STREAMS)]
    total_tokens = sum(LENS)

    # ---- continuous batching -------------------------------------------
    # start=False: the whole burst is queued before the loop first admits,
    # so "one batched prefill" below is deterministic, not timing-dependent
    with DecodeScheduler(planned, step="decode_step", capacity=N_STREAMS,
                         start=False, backend=device) as sched:
        sched.warm(PROMPT_LEN)
        streams = [sched.submit(p, n) for p, n in zip(prompts, LENS)]
        sched.start()
        outs = [s.result(timeout=120) for s in streams]
        rep = sched.report()

    for p, n, out in zip(prompts, LENS, outs):
        ref = decode_reference(sched.prefill, sched.step, p, n,
                               capacity=N_STREAMS)
        check(np.array_equal(ref, out), "stream not bit-identical to solo",
              f"got      {out}\nexpected {ref}", rep.table())
    rows.append(f"smoke_decode/bitident,nan,streams={N_STREAMS};ok")

    check(rep.tokens == total_tokens,
          f"tokens {rep.tokens} != submitted {total_tokens}", rep.table())
    check(rep.prefills == 1, "burst should admit in one batched prefill",
          rep.table())
    check(rep.steps == max(LENS) - 1,
          "retired streams must not stretch the decode loop", rep.table())
    sched_tpc = rep.tokens_per_crossing
    check(sched_tpc > 0, "no tokens per crossing measured", rep.table())

    # ---- request-level serving of the same workload ---------------------
    step_planned = planned.for_entry("decode_step")
    prefill = planned.compile(backend=device)
    ladder = BucketLadder(batch_sizes=(1, 2, 4, 8))
    base_crossings = 0
    lock = threading.Lock()
    errors: list = []
    with MixedServer(step_planned, ladder=ladder, max_batch_delay=0.005,
                     backend=device) as server:
        # warm every bucket + the prefill signature: measure serving, not builds
        h0 = np.zeros((1, DM), np.float32)
        server.warm(h0, np.zeros((1,), np.int32))
        prefill.call_reported(prompts[0][None, :])

        before = server.report()

        def client(i: int):
            nonlocal base_crossings
            try:
                outs, prep = prefill.call_reported(prompts[i][None, :])
                with lock:
                    base_crossings += prep.guest_to_host
                logits, state = np.asarray(outs[0]), [np.asarray(o) for o in outs[1:]]
                tok = greedy_sample(logits[0])
                for _ in range(LENS[i] - 1):
                    outs = server.request(
                        *state, np.array([tok], np.int32), timeout=120)
                    logits, state = np.asarray(outs[0]), list(outs[1:])
                    tok = greedy_sample(logits[0])
            except Exception as e:  # noqa: BLE001 - reported by the check below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(N_STREAMS)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        after = server.report()
    check(not errors, f"client errors: {errors[:3]}", after.table())
    check(after.fallback_requests == before.fallback_requests,
          "warm buckets must not fall back", after.table())

    step_requests = after.requests - before.requests
    check(step_requests == total_tokens - N_STREAMS,
          f"expected {total_tokens - N_STREAMS} step requests, "
          f"got {step_requests}", after.table())
    base_crossings += after.crossings - before.crossings
    base_tpc = total_tokens / base_crossings

    rows.append(
        f"smoke_decode/tokens_per_crossing,nan,"
        f"continuous={sched_tpc:.3f};request_level={base_tpc:.3f};"
        f"steps={rep.steps};occupancy={rep.step_occupancy:.2f}")
    check(sched_tpc > base_tpc,
          f"continuous batching did not beat request-level serving: "
          f"{sched_tpc:.3f} <= {base_tpc:.3f}", rep.table(), after.table())

    # the two regimes share one plan substrate: no duplicate unit builds
    cache = planned.unit_cache
    check(cache.hits > 0 and len(cache) == cache.builds,
          f"duplicate unit builds: len={len(cache)} builds={cache.builds} "
          f"hits={cache.hits}")
    rows.append(f"smoke_decode/shared_units,nan,builds={cache.builds};"
                f"hits={cache.hits}")
    return rows


def run_attn(device=None) -> list[str]:
    """The paged-KV duel: continuous batching with paged growing state vs
    request-level serving of the same attention decode workload."""
    rows = []
    vocab, dm, max_ctx, prompt_len = 32, 16, 24, 6
    n_streams, lens = 4, (6, 8, 10, 12)
    planned = mixed.trace(
        export_attn_decode_lm(vocab=vocab, d_model=dm, max_context=max_ctx)
    ).plan("tech-gfp")
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=max_ctx, page_size=4)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, (prompt_len,), dtype=np.int32)
               for _ in range(n_streams)]
    total_tokens = sum(lens)

    # ---- continuous batching over paged KV state ------------------------
    with DecodeScheduler(planned, step="decode_step", capacity=n_streams,
                         state=spec, start=False, backend=device) as sched:
        sched.warm(prompt_len)
        streams = [sched.submit(p, n) for p, n in zip(prompts, lens)]
        sched.start()
        outs = [s.result(timeout=120) for s in streams]
        rep = sched.report()

    for p, n, out in zip(prompts, lens, outs):
        ref = decode_reference(sched.prefill, sched.step, p, n,
                               capacity=n_streams)
        check(np.array_equal(ref, out),
              "attention stream not bit-identical to solo",
              f"got      {out}\nexpected {ref}", rep.table())
    rows.append(f"smoke_decode/attn_bitident,nan,streams={n_streams};ok")

    check(rep.tokens == total_tokens,
          f"tokens {rep.tokens} != submitted {total_tokens}", rep.table())
    check(rep.prefills == 1 and rep.steps == max(lens) - 1,
          "admission/retirement bookkeeping broke", rep.table())
    check(rep.pages_in_use == 0, "leaked pages at close", rep.table())
    check(rep.page_allocs == rep.page_frees > 0,
          "page alloc/free identity broke", rep.table())
    check(0 < rep.cache_occupancy <= 1.0, "cache occupancy out of range",
          rep.table())
    sched_tpc = rep.tokens_per_crossing
    check(sched_tpc > 0, "no tokens per crossing measured", rep.table())

    # ---- request-level serving of the same workload ---------------------
    step_planned = planned.for_entry("decode_step")
    prefill = planned.compile(backend=device)
    base_crossings = 0
    lock = threading.Lock()
    errors: list = []
    with MixedServer(step_planned, ladder=BucketLadder(batch_sizes=(1, 2, 4)),
                     max_batch_delay=0.005, backend=device) as server:
        k0 = np.zeros((1, max_ctx, dm), np.float32)
        server.warm(k0, k0, np.zeros((1,), np.int32), np.zeros((1,), np.int32))
        prefill.call_reported(prompts[0][None, :])

        before = server.report()

        def client(i: int):
            nonlocal base_crossings
            try:
                outs, prep = prefill.call_reported(prompts[i][None, :])
                with lock:
                    base_crossings += prep.guest_to_host
                logits, state = np.asarray(outs[0]), list(outs[1:])
                tok = greedy_sample(logits[0])
                for _ in range(lens[i] - 1):
                    outs = server.request(
                        *state, np.array([tok], np.int32), timeout=120)
                    logits, state = np.asarray(outs[0]), list(outs[1:])
                    tok = greedy_sample(logits[0])
            except Exception as e:  # noqa: BLE001 - reported by the check below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_streams)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        after = server.report()
    check(not errors, f"client errors: {errors[:3]}", after.table())
    check(after.fallback_requests == before.fallback_requests,
          "warm buckets must not fall back", after.table())
    base_crossings += after.crossings - before.crossings
    base_tpc = total_tokens / base_crossings

    rows.append(
        f"smoke_decode/attn_tokens_per_crossing,nan,"
        f"continuous={sched_tpc:.3f};request_level={base_tpc:.3f};"
        f"pages_peak={rep.pages_peak};cache_occ={rep.cache_occupancy:.2f};"
        f"state_bytes_per_crossing={rep.state_bytes_per_crossing:.0f}")
    check(sched_tpc > base_tpc,
          f"paged continuous batching did not beat request-level serving: "
          f"{sched_tpc:.3f} <= {base_tpc:.3f}", rep.table(), after.table())
    return rows


def paged_kernel_workload(device=None):
    """The paged-kernel workload (``BENCH_serve.json``'s
    ``decode_paged_kernel``).

    Returns ``(decode_all, prompts, lens, n_streams, spec)``;
    ``decode_all()`` decodes the 4-stream burst through the block-sparse
    paged-attention kernel (``paged_step="paged_decode_step"``) and
    returns ``(outs, report, sched)`` — the report taken AFTER close, so
    the zero-leak identities are final.
    """
    vocab, dm, max_ctx = 32, 16, 24
    page_size, prompt_len = 4, 6
    n_streams, lens = 4, (6, 8, 10, 12)
    planned = mixed.trace(
        export_attn_decode_lm(vocab=vocab, d_model=dm, max_context=max_ctx)
    ).plan("tech-gfp")
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=max_ctx,
                     page_size=page_size)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, (prompt_len,), dtype=np.int32)
               for _ in range(n_streams)]

    def decode_all():
        with DecodeScheduler(planned, step="decode_step",
                             paged_step="paged_decode_step",
                             capacity=n_streams, state=spec,
                             start=False, backend=device) as sched:
            sched.warm(prompt_len)
            streams = [sched.submit(p, n) for p, n in zip(prompts, lens)]
            sched.start()
            outs = [s.result(timeout=120) for s in streams]
        return outs, sched.report(), sched

    return decode_all, prompts, lens, n_streams, spec


def run_paged_kernel(device=None) -> list[str]:
    """The block-sparse paged-kernel gate: 4 concurrent streams stepped
    through ``paged_decode_step`` (pool buffers + block tables cross
    directly; the kernel walks only live pages) must be bit-identical to
    BOTH solo oracles, visit strictly fewer pages than the dense-equivalent
    walk, and drain the pool leak-free."""
    rows = []
    decode_all, prompts, lens, n_streams, spec = paged_kernel_workload(device)

    outs, rep, sched = decode_all()
    pstep = sched.paged_step_planned.compile(backend=device)
    violations = 0
    for p, n, out in zip(prompts, lens, outs):
        dense = decode_reference(sched.prefill, sched.step, p, n,
                                 capacity=n_streams)
        paged = paged_decode_reference(sched.prefill, pstep, p, n,
                                       capacity=n_streams, state=spec)
        violations += (not np.array_equal(dense, out)
                       or not np.array_equal(paged, out))
    check(violations == 0,
          f"{violations} stream(s) diverged from the solo oracles",
          rep.table())

    check(rep.kernel_steps == rep.steps > 0,
          "every step must go through the paged kernel", rep.table())
    walk = rep.kernel_steps * n_streams * spec.pages_per_stream
    check(rep.pages_visited + rep.pages_skipped == walk,
          "page-visit accounting does not cover the table walk", rep.table())
    check(0 < rep.pages_visited < walk,
          f"kernel visited {rep.pages_visited} of {walk} dense-equivalent "
          f"pages — block-sparsity must skip dead/short pages", rep.table())
    check(rep.pages_in_use == 0, "leaked pages at close", rep.table())
    check(rep.page_allocs == rep.page_frees > 0,
          "page alloc/free identity broke", rep.table())
    check(sched._paged.pool.refs_outstanding == 0,
          "leaked page refcounts at close", rep.table())
    rows.append(
        f"smoke_decode/paged_kernel,nan,"
        f"bit_identity_violations={violations};"
        f"pages_visited={rep.pages_visited};dense_equivalent_pages={walk};"
        f"visit_fraction={rep.page_visit_fraction:.3f};"
        f"kernel_steps={rep.kernel_steps};"
        f"tokens_per_crossing={rep.tokens_per_crossing:.3f}")
    return rows


def run_card(device=None) -> list[str]:
    """The card section: the paged-kernel solo oracle with its units on the
    card against the same oracle on the CPU.  Greedy argmax over
    well-separated logits is token-exact even where the card's reductions
    reassociate, so the tokens must be equal; where one differs the check
    reports the CPU logits' top-two gap at the first differing token and
    the largest logit difference there.  The paged kernel must run once per
    kernel step, every launch on its ``split`` body.  Under ``--device
    cpu`` the section was not requested and says so."""
    if resolve_device(device).type != "cuda":
        return ["smoke_decode/card_paged_kernel,nan,not_requested=device_cpu"]
    vocab, dm, max_ctx, new = 32, 16, 24, 8
    planned = mixed.trace(
        export_attn_decode_lm(vocab=vocab, d_model=dm, max_context=max_ctx)
    ).plan("tech-gfp")
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=max_ctx, page_size=4)
    prompt = np.random.default_rng(19).integers(0, vocab, (6,), np.int32)

    def oracle(backend):
        logits = []

        def sample(row):
            logits.append(np.array(row))
            return greedy_sample(row)

        toks = paged_decode_reference(
            planned.compile(backend=backend),
            planned.for_entry("paged_decode_step").compile(backend=backend),
            prompt, new, capacity=4, state=spec, sample=sample)
        return toks, logits

    cpu, cpu_logits = oracle("cpu")
    before = ops.launches_by_route()["paged_decode_attention"]
    card, card_logits = oracle(device)
    after = ops.launches_by_route()["paged_decode_attention"]
    launched = {r: n - before.get(r, 0) for r, n in after.items() if n - before.get(r, 0)}
    if not np.array_equal(cpu, card):
        i = int(np.flatnonzero(cpu != card)[0]) if cpu.shape == card.shape else 0
        top = np.sort(cpu_logits[i])[-2:]
        check(False, f"card paged decode diverged from the CPU at token {i}: "
              f"{card} vs {cpu}",
              f"CPU logits' top-two gap there {top[1] - top[0]:.3e}, largest "
              f"|card - CPU| logit {np.abs(card_logits[i] - cpu_logits[i]).max():.3e}")
    steps = len(card) - 1
    check(launched == {"split": steps},
          f"the paged kernel must run once per kernel step ({steps}), all on "
          f"'split': launched {launched}")
    return [f"smoke_decode/card_paged_kernel,nan,tokens={len(card)};"
            f"kernel_steps={steps};split_launches={launched['split']};ok"]


def run_prefix(device=None) -> list[str]:
    """The prefix-sharing gate: ≥4 concurrent streams with a common
    page-aligned prompt prefix — bit-identical to the solo oracle, strictly
    fewer pages at peak than with sharing disabled, prefix tokens actually
    reused, and a leak-free pool (pages *and* refcounts) at close."""
    rows = []
    decode_all, prompts, lens, n_streams = prefix_workload(device)

    outs, rep, sched = decode_all(share=True)
    for p, n, out in zip(prompts, lens, outs):
        ref = decode_reference(sched.prefill, sched.step, p, n,
                               capacity=n_streams)
        check(np.array_equal(ref, out),
              "prefix-shared stream not bit-identical to solo",
              f"got      {out}\nexpected {ref}", rep.table())
    check(rep.prefix_hits >= n_streams - 1,
          f"expected >= {n_streams - 1} prefix hits", rep.table())
    check(rep.prefix_tokens_reused > 0, "no prefix tokens reused", rep.table())
    check(rep.pages_in_use == 0, "leaked pages at close", rep.table())
    check(rep.page_allocs == rep.page_frees > 0,
          "page alloc/free identity broke", rep.table())
    check(sched._paged.pool.refs_outstanding == 0,
          "leaked page refcounts at close", rep.table())

    outs_off, rep_off, _ = decode_all(share=False)
    for a, b in zip(outs, outs_off):
        check(np.array_equal(a, b),
              "sharing changed the decoded tokens", rep.table())
    check(rep.pages_peak < rep_off.pages_peak,
          f"sharing must strictly lower the page peak: "
          f"{rep.pages_peak} >= {rep_off.pages_peak}",
          rep.table(), rep_off.table())
    rows.append(
        f"smoke_decode/prefix_sharing,nan,"
        f"hits={rep.prefix_hits};tokens_reused={rep.prefix_tokens_reused};"
        f"pages_peak={rep.pages_peak};unshared_peak={rep_off.pages_peak};"
        f"pages_shared={rep.pages_shared};cow={rep.pages_cow_copied};"
        f"bytes_saved={rep.state_bytes_saved}")
    return rows


def multimodel_workload(device=None):
    """The heterogeneous co-serving workload (``BENCH_serve.json``'s
    ``decode_multimodel``).

    Returns ``(decode_all, planneds, prompts, lens, capacity)``;
    ``decode_all()`` co-serves an interleaved mamba2 (fixed-size SSM
    state) + attention-LM (paged growing KV) burst in one
    :class:`~repro_torch.serve.MultiModelDecodeScheduler` over one shared
    ``PagePool`` and returns ``(outs, report)`` with ``outs`` a list of
    ``(model, prompt, tokens)`` — the report taken AFTER close, so the
    shared-pool zero-leak identities are final.
    """
    vocab, dm, max_ctx, prompt_len = 32, 16, 24, 6
    capacity, lens = 3, (5, 6, 7, 8, 9, 10)
    planneds = {
        "attn": mixed.trace(export_attn_decode_lm(
            vocab=vocab, d_model=dm, max_context=max_ctx)).plan("tech-gfp"),
        "mamba2": mixed.trace(export_mamba2_decode_lm(
            vocab=vocab, d_model=dm)).plan("tech-gfp"),
    }
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=max_ctx, page_size=4)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, vocab, (prompt_len,), dtype=np.int32)
               for _ in range(len(lens))]

    def decode_all():
        multi = MultiModelDecodeScheduler(start=False)
        multi.register("attn", planneds["attn"], step="decode_step",
                       capacity=capacity, state=spec, backend=device)
        multi.register("mamba2", planneds["mamba2"], step="decode_step",
                       capacity=capacity, backend=device)
        jobs = []
        with multi:
            for i, (p, n) in enumerate(zip(prompts, lens)):
                model = "attn" if i % 2 == 0 else "mamba2"
                jobs.append((model, p, multi.submit(p, n, model=model)))
            multi.start()       # the whole mixed burst admits together
            outs = [(m, p, s.result(timeout=120)) for m, p, s in jobs]
        return outs, multi.report()

    return decode_all, planneds, prompts, lens, capacity


def run_multimodel(device=None) -> list[str]:
    """The heterogeneous co-serving gate: a mixed mamba2+attn burst in ONE
    scheduler over ONE shared page pool — every stream bit-identical to
    its own model's solo oracle, the SSM lane at zero page traffic with a
    ``state_bytes_per_crossing`` strictly below the attention LM's, and
    the shared pool leak-free across tenants at close."""
    rows = []
    decode_all, planneds, _prompts, lens, capacity = multimodel_workload(device)

    outs, rep = decode_all()
    oracle = {name: (p.compile(backend=device),
                     p.for_entry("decode_step").compile(backend=device))
              for name, p in planneds.items()}
    violations = 0
    for model, prompt, toks in outs:
        ref = decode_reference(*oracle[model], prompt, len(toks),
                               capacity=capacity)
        violations += not np.array_equal(ref, toks)
    check(violations == 0,
          f"{violations} stream(s) diverged from their model's solo oracle",
          rep.table())

    check(rep.streams == len(lens) and rep.failures == 0,
          "stream accounting broke", rep.table())
    ssm, attn = rep.models["mamba2"], rep.models["attn"]
    check(ssm.page_allocs == 0 and ssm.page_frees == 0,
          "fixed-size-state lane must never touch the page pool",
          rep.table())
    check(attn.page_allocs > 0, "paged lane allocated no pages", rep.table())
    check(ssm.state_bytes_per_crossing < attn.state_bytes_per_crossing,
          f"SSM state bytes/crossing must be strictly below the attention "
          f"LM's: {ssm.state_bytes_per_crossing:.0f} >= "
          f"{attn.state_bytes_per_crossing:.0f}", rep.table())
    check(rep.pool_allocs - rep.pool_frees == rep.pool_in_use == 0,
          "shared-pool leak identity broke at close", rep.table())
    check(rep.pool_refs_outstanding == 0,
          "leaked shared-pool refcounts at close", rep.table())
    check(rep.pool_allocs == sum(r.page_allocs for r in rep.models.values()),
          "per-model page counters do not reconcile with the shared pool",
          rep.table())
    rows.append(
        f"smoke_decode/multimodel,nan,"
        f"bit_identity_violations={violations};streams={rep.streams};"
        f"ssm_state_bytes_per_crossing={ssm.state_bytes_per_crossing:.0f};"
        f"attn_state_bytes_per_crossing={attn.state_bytes_per_crossing:.0f};"
        f"ssm_page_allocs={ssm.page_allocs};"
        f"pool_peak={rep.pool_peak};"
        f"tokens_per_crossing={rep.tokens_per_crossing:.3f}")
    return rows


SECTIONS = (run_attn, run_paged_kernel, run_prefix, run_multimodel, run_card)


def run_all(device=None, *, rows: list | None = None) -> list[str]:
    """Every section in the reference's order, each appending its rows."""
    rows = run(device, rows=rows)
    for section in SECTIONS:
        rows += section(device)
    finish_gate(rows, "smoke_decode", device, KERNELS)
    return rows


def main(argv=None) -> int:
    return gate_main("SMOKE-DECODE", "smoke_decode", run_all, 180, argv)


if __name__ == "__main__":
    raise SystemExit(main())
