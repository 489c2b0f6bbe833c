"""Page pools on the step's device (``backend="cpu"``: CPU tensors).

The paged-kernel scheduler keeps its K/V pools as tensors on the paged
step's device when its plan takes them by reference, and as numpy pools in
the dense step mode and under an emulating scheme.  Device pools hold the
same bytes as host pools after the same admissions, appends, copy-on-write
copies and retirements; the steps copy only the table, the lengths, the
tokens and the head's hidden rows, and pass both pools by reference.
"""
import numpy as np
import pytest
import torch

from repro_torch import mixed
from repro_torch.core.convert import Resident
from repro_torch.models.programs import export_attn_decode_lm
from repro_torch.serve import (
    DecodeScheduler,
    PagedKVState,
    StateSpec,
    paged_decode_reference,
)

VOCAB, DM, MAX_CTX, PAGE = 32, 16, 24, 4
CPU = torch.device("cpu")


def _spec(**kw):
    return StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX, page_size=PAGE, **kw)


def _planned(scheme="tech-gfp"):
    return mixed.trace(export_attn_decode_lm(vocab=VOCAB, d_model=DM,
                                             max_context=MAX_CTX)).plan(scheme)


def _prompts(n, seed, length=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (length,), dtype=np.int32) for _ in range(n)]


def _serve(planned, prompts, lens, *, capacity=4, **kw):
    with DecodeScheduler(planned, step="decode_step", capacity=capacity, state=_spec(),
                         backend="cpu", start=False, **kw) as sched:
        sched.warm(prompts[0].shape[0])
        streams = [sched.submit(p, n) for p, n in zip(prompts, lens)]
        sched.start()
        outs = [s.result(timeout=240) for s in streams]
    return outs, sched.report(), sched


@pytest.mark.parametrize("scheme,paged_step,resident", [
    ("tech-gfp", "paged_decode_step", True),
    ("tech-gf", "paged_decode_step", True),
    ("qemu", "paged_decode_step", False),      # emulated: the guest reads the pools
    ("tech-gfp", None, False),                 # the dense step gathers on the host
])
def test_where_the_pools_live(scheme, paged_step, resident):
    prompts = _prompts(2, seed=5)
    outs, rep, sched = _serve(_planned(scheme), prompts, [4, 6], paged_step=paged_step)
    paged = sched._paged
    assert paged.device == (CPU if resident else None)
    for k in (0, 1):
        buf = paged.backing(k)
        assert isinstance(buf, Resident if resident else np.ndarray)
        assert isinstance(paged._backing[k], torch.Tensor if resident else np.ndarray)
    assert rep.step_resident_bytes == (rep.steps * sum(paged.backing(k).nbytes for k in (0, 1))
                                       if resident else 0)
    if paged_step is not None:
        pstep = sched.paged_step_planned.compile(backend="cpu")
        for p, n, out in zip(prompts, [4, 6], outs):
            ref = paged_decode_reference(sched.prefill, pstep, p, n, capacity=4,
                                         state=_spec())
            assert np.array_equal(ref, out)


def test_step_bytes_split_into_placed_and_resident():
    """Per step: placed = table + lengths + tokens (first segment) + the
    head's (capacity, d_model) float32 rows; resident = both pools."""
    capacity = 4
    outs, rep, sched = _serve(_planned(), _prompts(3, seed=9), [5, 7, 3],
                              paged_step="paged_decode_step", capacity=capacity)
    paged = sched._paged
    per_step = (paged.table_array().nbytes + paged.lengths_array().nbytes
                + capacity * 4 + capacity * DM * 4)
    pools = sum(paged.backing(k).nbytes for k in (0, 1))
    assert rep.steps > 0
    assert rep.step_placed_bytes == rep.steps * per_step
    assert rep.step_resident_bytes == rep.steps * pools
    # state_bytes keeps pricing the logical state handed to each step
    assert rep.state_bytes >= rep.steps * pools


def test_midflight_admission_and_retirement_stay_bitwise():
    """Streams admitted while others step, retiring at different steps,
    each equal their solo oracle, which crosses as the steps do."""
    planned = _planned()
    prompts, lens = _prompts(6, seed=31), [2, 9, 4, 7, 1, 5]
    with DecodeScheduler(planned, step="decode_step", paged_step="paged_decode_step",
                         capacity=3, state=_spec(), backend="cpu") as sched:
        first = [sched.submit(p, n) for p, n in zip(prompts[:3], lens[:3])]
        first[0].result(timeout=240)
        late = [sched.submit(p, n) for p, n in zip(prompts[3:], lens[3:])]
        outs = [s.result(timeout=240) for s in first + late]
        rep = sched.report()
    assert any(s.admitted_step > 0 for s in late)
    assert isinstance(sched._paged.backing(0), Resident)
    pstep = sched.paged_step_planned.compile(backend="cpu")
    for p, n, out in zip(prompts, lens, outs):
        assert np.array_equal(paged_decode_reference(sched.prefill, pstep, p, n,
                                                     capacity=3, state=_spec()), out)
    assert rep.pages_in_use == 0 and rep.page_allocs == rep.page_frees > 0


def _twins(capacity=4, inner=3):
    """A host and a device PagedKVState over one spec (float32 rows)."""
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX, page_size=PAGE,
                     share_prefixes=True)
    host, dev = PagedKVState(capacity, spec), PagedKVState(capacity, spec)
    dense = np.zeros((capacity, MAX_CTX, inner), np.float32)
    for k in (0, 1):
        host.ensure_buffers(k, dense)
        dev.ensure_buffers(k, dense, CPU)
    return host, dev


def _same(host, dev, rows=()):
    dev.flush()
    for k in (0, 1):
        assert np.array_equal(host._backing[k], dev._backing[k].numpy()), k
        assert np.array_equal(host.gather_pages(k, rows), dev.gather_pages(k, rows)), k
    assert host.table._tables == dev.table._tables and host.lengths == dev.lengths


@pytest.mark.parametrize("seed", range(6))
def test_device_pools_hold_the_host_pools_bytes(seed):
    """Random admissions (some sharing a donor's pages up to a mid-page
    length, so the boundary page is copied on write), appends held until a
    flush and retirements in between: both storages hold the same bytes,
    page for page, and gather the same rows."""
    rng = np.random.default_rng(seed)
    host, dev = _twins()
    live: dict[int, int] = {}
    for _ in range(40):
        op = rng.choice(["admit", "append", "retire", "flush"])
        free = [s for s in range(4) if s not in live]
        if op == "admit" and free:
            slot = int(rng.choice(free))
            length = int(rng.integers(1, 12))
            row = {k: rng.standard_normal((MAX_CTX, 3)).astype(np.float32) for k in (0, 1)}
            kw = {}
            if live and rng.random() < 0.5:
                donor = int(rng.choice(sorted(live)))
                shared = int(rng.integers(1, live[donor] + 1))
                pages = tuple(host.table.pages(donor)[:-(-shared // PAGE)])
                length = max(length, shared)
                for t in (host, dev):
                    for p in pages:
                        t.pool.retain(p)
                kw = dict(shared_len=shared, shared_pages=pages, pinned=True)
            for t in (host, dev):
                t.admit(slot, row, length, **kw)
            live[slot] = length
        elif op == "append" and live:
            # one step: every live slot appends, some retire right after
            for slot in sorted(live):
                if live[slot] >= MAX_CTX:
                    continue
                row = {k: rng.standard_normal(3).astype(np.float32) for k in (0, 1)}
                for t in (host, dev):
                    t.append_row(slot, row)
                live[slot] += 1
                if rng.random() < 0.3:
                    for t in (host, dev):
                        t.retire(slot)
                    del live[slot]
        elif op == "retire" and live:
            slot = int(rng.choice(sorted(live)))
            for t in (host, dev):
                t.retire(slot)
            del live[slot]
        elif op == "flush":
            rows = [(host.table.pages(s), n) for s, n in sorted(live.items())]
            _same(host, dev, rows)
    _same(host, dev, [(host.table.pages(s), n) for s, n in sorted(live.items())])
    assert host.cow_copies == dev.cow_copies


def test_a_reused_page_takes_the_later_row():
    """Slot 0 appends into a fresh page and retires; slot 1 takes that page
    in the same step and appends at the same offset: after the flush the
    page holds slot 1's row, as on the host."""
    host, dev = _twins(capacity=2)
    zero = {k: np.zeros((MAX_CTX, 3), np.float32) for k in (0, 1)}
    for t in (host, dev):
        t.admit(0, zero, PAGE)
        t.admit(1, zero, 2 * PAGE)
    a = {k: np.full(3, 1.0, np.float32) for k in (0, 1)}
    b = {k: np.full(3, 2.0, np.float32) for k in (0, 1)}
    for t in (host, dev):
        t.append_row(0, a)          # a fresh page at offset 0
        t.retire(0)                 # ... freed again
        t.append_row(1, b)          # slot 1's fresh page is that page
    assert dev.table.pages(1)[-1] not in dev.table.pages(0)
    assert len(dev._pending) == 2
    _same(host, dev, [(host.table.pages(1), host.lengths[1])])
    page = dev.table.pages(1)[-1]
    assert np.array_equal(dev._backing[0][page, 0].numpy(), b[0])


def test_device_pools_refuse_a_dense_gather_and_a_second_home():
    host, dev = _twins()
    with pytest.raises(RuntimeError, match="host pools"):
        dev.gather(0)
    spec = _spec()
    mixed_home = PagedKVState(2, spec)
    mixed_home.ensure_buffers(0, np.zeros((2, MAX_CTX, 3), np.float32), CPU)
    with pytest.raises(ValueError, match="live on cpu"):
        mixed_home.ensure_buffers(1, np.zeros((2, MAX_CTX, 3), np.float32))
