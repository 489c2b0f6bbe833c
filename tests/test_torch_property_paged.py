"""Property-based tests (hypothesis) for paged-state refcounting + CoW.

Random admit / share / write / retire interleavings against a
:class:`repro_torch.serve.PagedKVState` must preserve the paged-state contract:

  * never leak: ``allocs - frees == in_use`` after every operation, and a
    fully-retired, index-cleared state ends at ``in_use == 0`` with zero
    outstanding references;
  * never double-free: every release goes through the refcount, so the pool
    raises instead of corrupting the free list;
  * isolation: a write into a shared page never changes the bytes observed
    through any *other* stream's block table (copy-on-write detaches the
    writer first).

The oracle is a dense per-slot model array updated alongside every
operation; after each step, ``gather`` must reproduce it bit-for-bit.

Ported from ``tests/test_property_paged.py`` (units on the CPU).
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")  # optional dev dependency
from hypothesis import given, settings, strategies as st

from repro_torch.serve import PagedKVState, StateSpec

CAPACITY, MAX_CTX, PAGE = 4, 12, 3


def fresh_state(entries: int = 4) -> PagedKVState:
    spec = StateSpec(growing={0: 1}, max_context=MAX_CTX, page_size=PAGE,
                     share_prefixes=True, prefix_cache_entries=entries)
    paged = PagedKVState(capacity=CAPACITY, spec=spec)
    paged.ensure_buffers(0, np.zeros((CAPACITY, MAX_CTX, 2), np.float32))
    return paged


def dense_row(rng: np.random.Generator) -> np.ndarray:
    # integer-valued float32 so equality is exact by construction
    return rng.integers(1, 1000, (MAX_CTX, 2)).astype(np.float32)


op = st.tuples(
    st.sampled_from(["admit", "share", "append", "retire", "register"]),
    st.integers(0, CAPACITY - 1),      # slot
    st.integers(1, MAX_CTX),           # a length-ish parameter
    st.integers(0, 2 ** 16),           # value seed
)


def check_invariants(paged: PagedKVState, model: dict[int, np.ndarray],
                     lengths: dict[int, int]) -> None:
    pool = paged.pool
    assert pool.allocs - pool.frees == pool.in_use, "leak identity broken"
    assert pool.refs_outstanding >= pool.in_use
    dense = paged.gather(0)
    for slot, expect in model.items():
        ref = np.zeros((MAX_CTX, 2), np.float32)
        ref[:lengths[slot]] = expect[:lengths[slot]]
        np.testing.assert_array_equal(
            dense[slot], ref,
            err_msg=f"slot {slot} observed bytes changed (isolation broken)")


@settings(max_examples=60, deadline=None)
@given(st.lists(op, min_size=1, max_size=40))
def test_random_interleavings_never_leak_never_corrupt(ops):
    paged = fresh_state()
    model: dict[int, np.ndarray] = {}     # slot -> full expected row
    lengths: dict[int, int] = {}
    prompts: dict[int, np.ndarray] = {}   # slot -> token ids (for register)

    for kind, slot, n, seed in ops:
        rng = np.random.default_rng(seed)
        if kind == "admit" and slot not in model:
            row = dense_row(rng)
            length = min(n, MAX_CTX)
            paged.admit(slot, {0: row}, length)
            model[slot], lengths[slot] = row, length
            prompts[slot] = rng.integers(0, 97, (length,), dtype=np.int32)
        elif kind == "share" and slot not in model and model:
            donor = sorted(model)[seed % len(model)]
            shared_len = 1 + seed % lengths[donor]
            pages = tuple(
                paged.table.pages(donor)[:-(-shared_len // PAGE)])
            for p in pages:                      # the match_and_pin pin
                paged.pool.retain(p)
            length = min(shared_len + n, MAX_CTX)
            row = dense_row(rng)
            row[:shared_len] = model[donor][:shared_len]
            paged.admit(slot, {0: row}, length, shared_len=shared_len,
                        shared_pages=pages, pinned=True)
            model[slot], lengths[slot] = row, length
            prompts[slot] = np.concatenate(
                [prompts[donor][:shared_len],
                 rng.integers(0, 97, (length - shared_len,), np.int32)])
        elif kind == "append" and slot in model and lengths[slot] < MAX_CTX:
            grown = np.array(model[slot])
            grown[lengths[slot]] = rng.integers(1, 1000, (2,))
            paged.append(slot, {0: grown})
            model[slot] = grown
            lengths[slot] += 1
        elif kind == "retire" and slot in model:
            paged.retire(slot)
            del model[slot], lengths[slot], prompts[slot]
        elif kind == "register" and slot in model:
            paged.register_prefix(slot, prompts[slot][:lengths[slot]])
        check_invariants(paged, model, lengths)

    for slot in list(model):
        paged.retire(slot)
    paged.clear_prefix_index()
    pool = paged.pool
    assert pool.in_use == 0, "pages leaked at drain"
    assert pool.refs_outstanding == 0, "references leaked at drain"
    assert pool.allocs == pool.frees


@settings(max_examples=60, deadline=None)
@given(st.integers(1, MAX_CTX - 1), st.integers(0, 2 ** 16))
def test_shared_page_write_isolation(shared_len, seed):
    """Focused CoW property: whatever the (possibly mid-page) shared prefix
    length, the donor's continued appends and the sharer's suffix writes
    never show through each other's block tables."""
    rng = np.random.default_rng(seed)
    paged = fresh_state()
    donor_row = dense_row(rng)
    donor_len = max(shared_len, 1 + seed % MAX_CTX)
    paged.admit(0, {0: donor_row}, donor_len)
    pages = tuple(paged.table.pages(0)[:-(-shared_len // PAGE)])
    for p in pages:
        paged.pool.retain(p)
    sharer_row = dense_row(rng)
    sharer_row[:shared_len] = donor_row[:shared_len]
    sharer_len = min(MAX_CTX, shared_len + 2)
    paged.admit(1, {0: sharer_row}, sharer_len, shared_len=shared_len,
                shared_pages=pages, pinned=True)

    # both keep appending into (potentially shared) tail pages; after every
    # write, BOTH observed views must still equal their own model exactly
    models = {0: (donor_row, donor_len), 1: (sharer_row, sharer_len)}
    for slot in (0, 1):
        row, length = models[slot]
        if length < MAX_CTX:
            grown = np.array(row)
            grown[length] = rng.integers(1, 1000, (2,))
            paged.append(slot, {0: grown})
            models[slot] = (grown, length + 1)
        dense = paged.gather(0)
        for s, (r, ln) in models.items():
            ref = np.zeros((MAX_CTX, 2), np.float32)
            ref[:ln] = r[:ln]
            np.testing.assert_array_equal(
                dense[s], ref, err_msg=f"slot {s} bytes changed")

    paged.retire(0)
    paged.retire(1)
    assert paged.pool.in_use == 0
    assert paged.pool.refs_outstanding == 0
