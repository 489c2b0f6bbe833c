"""Property-based tests (hypothesis) for the paged-kernel decode path.

Random admit / decode / retire interleavings drive a
:class:`~repro_torch.serve.DecodeScheduler` in paged-kernel mode
(``paged_step="paged_decode_step"``: the block-sparse paged attention
Pallas kernel reads the pool buffers through each stream's block table
instead of a re-materialized dense cache) and must preserve the serving
contract:

  * **bit-exactness** — every stream's tokens equal ``decode_reference``
    solo decoding through the DENSE step, bit for bit: the paged kernel
    changes how the KV cache is *read*, never which tokens come out;
  * **zero leaks** — the pool ends every run with ``in_use == 0``, zero
    outstanding references, and ``allocs == frees``, whatever the
    admission order or retirement times;
  * **visit accounting** — ``pages_visited + pages_skipped`` covers the
    full table walk exactly, and the kernel visits strictly fewer pages
    than the dense-equivalent walk whenever streams are short of
    ``max_context`` (which these workloads always are).

Ported from ``tests/test_property_paged_kernel.py`` (units on the CPU).
"""
import functools

import numpy as np
import pytest

pytest.importorskip("hypothesis")  # optional dev dependency
from hypothesis import given, settings, strategies as st

from repro_torch import mixed
from repro_torch.models.programs import export_attn_decode_lm
from repro_torch.serve import (
    DecodeScheduler,
    StateSpec,
    decode_reference,
    paged_decode_reference,
)

VOCAB, DM, MAX_CTX, PAGE, CAP = 32, 16, 24, 4, 3
PROMPT_LENS = (3, 6)      # few distinct prefill shapes -> few unit signatures


@functools.lru_cache(maxsize=1)
def _planned():
    """One shared plan: every hypothesis example reuses the offload units
    (PlannedProgram.unit_cache), so only the first example compiles."""
    return mixed.trace(
        export_attn_decode_lm(vocab=VOCAB, d_model=DM, max_context=MAX_CTX)
    ).plan("tech-gfp")


def _spec() -> StateSpec:
    return StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX,
                     page_size=PAGE)


def _prompt(length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, VOCAB, (length,), dtype=np.int32)


# one decode job: (prompt length, max_new_tokens, prompt seed)
job = st.tuples(
    st.sampled_from(PROMPT_LENS),
    st.integers(1, 6),
    st.integers(0, 2 ** 16),
)


@settings(max_examples=8, deadline=None)
@given(st.lists(job, min_size=1, max_size=6), st.integers(0, 2 ** 16))
def test_random_interleavings_paged_kernel_bit_identical(jobs, seed):
    """Jobs outnumber capacity, half queue before the loop starts and half
    race in live, so slots retire and recycle mid-run — every interleaving
    must stay bit-identical to solo dense decoding and drain clean."""
    rng = np.random.default_rng(seed)
    prompts = [_prompt(ln, s) for ln, _, s in jobs]
    with DecodeScheduler(_planned(), backend="cpu", step="decode_step",
                         paged_step="paged_decode_step",
                         capacity=CAP, state=_spec(), start=False) as sched:
        for ln in PROMPT_LENS:
            sched.warm(ln)
        order = rng.permutation(len(jobs))
        split = len(jobs) // 2
        streams = {}
        for idx in order[:split]:
            streams[idx] = sched.submit(prompts[idx], jobs[idx][1])
        sched.start()
        for idx in order[split:]:
            streams[idx] = sched.submit(prompts[idx], jobs[idx][1])
        outs = {idx: s.result(timeout=240) for idx, s in streams.items()}
        rep = sched.report()

    for idx, (_, max_new, _) in enumerate(jobs):
        ref = decode_reference(sched.prefill, sched.step, prompts[idx],
                               max_new, capacity=CAP)
        assert np.array_equal(ref, outs[idx]), (
            f"stream {idx} (len {len(prompts[idx])}, max_new {max_new}) "
            f"diverged from the dense solo oracle")

    assert rep.streams == len(jobs) and rep.failures == 0
    # zero-leak identities, refcounts included, after close
    assert rep.pages_in_use == 0, "pages leaked at drain"
    assert rep.page_allocs == rep.page_frees > 0
    assert sched._paged.pool.refs_outstanding == 0, "refs leaked at drain"
    # every step went through the kernel, and its walk covered the whole
    # table exactly once per step
    assert rep.kernel_steps == rep.steps
    walk = rep.kernel_steps * CAP * _spec().pages_per_stream
    assert rep.pages_visited + rep.pages_skipped == walk
    if rep.kernel_steps:
        assert rep.pages_visited < walk, (
            "block-sparsity must skip dead/short pages on these workloads")


@settings(max_examples=10, deadline=None)
@given(st.sampled_from(PROMPT_LENS), st.integers(1, 8),
       st.integers(0, 2 ** 16))
def test_paged_solo_reference_matches_dense(prompt_len, max_new, seed):
    """The two solo oracles agree token-for-token on any prompt: the
    paged-kernel step is a drop-in reader for the dense step."""
    planned = _planned()
    prompt = _prompt(prompt_len, seed)
    dense = decode_reference(
        planned.compile(backend="cpu"),
        planned.for_entry("decode_step").compile(backend="cpu"),
        prompt, max_new, capacity=2)
    paged = paged_decode_reference(
        planned.compile(backend="cpu"),
        planned.for_entry("paged_decode_step").compile(backend="cpu"),
        prompt, max_new, capacity=2, state=_spec())
    assert np.array_equal(dense, paged)
