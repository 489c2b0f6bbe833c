"""The port's cross-process cluster tier (repro_torch.serve.cluster), ported
from ``tests/test_cluster.py``; the spawned workers run their units on the
CPU (``WorkerSpec(backend="cpu")``).

Covers the router/worker contract end to end, with real spawned worker
processes over the socket channel:

* a 2-worker cluster serves a paged, prefix-shared decode workload
  **bit-identical** to ``decode_reference`` solo decoding,
* prefix affinity — prompts sharing a first page land on one worker (its
  prefix index converts them to CoW hits); sub-page prompts spill
  round-robin,
* the crash contract — a killed worker fails every in-flight future with
  :class:`ClusterWorkerError` and leaves the routing set; later traffic
  lands on the survivors (no stranded futures),
* graceful drain (finish in-flight, final report, leave routing) and
  rejoin (fresh process from the same spec),
* boot failures surface as :class:`ClusterWorkerError`, and the AOT
  fallback plans from source when the cache holds a different program.
"""
import time

import numpy as np
import pytest

from repro_torch import mixed
from repro_torch.models.programs import export_attn_decode_lm
from repro_torch.serve import (
    ClusterRouter,
    ClusterWorkerError,
    StateSpec,
    WorkerSpec,
    build_planned,
    decode_reference,
)

VOCAB, DM, MAX_CTX, PAGE, PLEN, MAXNEW, CAP = 32, 16, 24, 4, 8, 6, 4

STATE = StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX, page_size=PAGE,
                  share_prefixes=True)


def spec(**overrides) -> WorkerSpec:
    base = dict(
        backend="cpu",
        program="repro_torch.models.programs:export_attn_decode_lm",
        program_kwargs={"vocab": VOCAB, "d_model": DM, "max_context": MAX_CTX},
        capacity=CAP, state=STATE, prefill_suffix="prefill_suffix",
    )
    base.update(overrides)
    return WorkerSpec(**base)


def prompts(n: int, length: int = PLEN, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (length,), dtype=np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def oracle():
    """In-process solo-decode oracle at the cluster's exact capacity."""
    planned = mixed.trace(export_attn_decode_lm(
        vocab=VOCAB, d_model=DM, max_context=MAX_CTX)).plan("tech-gfp")
    prefill = planned.compile(backend="cpu")
    step = planned.for_entry("decode_step").compile(backend="cpu")

    def decode(prompt, max_new=MAXNEW):
        return decode_reference(prefill, step, prompt, max_new, capacity=CAP)

    return decode


def test_two_workers_bit_identical_to_reference(oracle):
    ps = prompts(6)
    with ClusterRouter(spec(), workers=2) as router:
        futs = [router.submit(p, MAXNEW) for p in ps]
        outs = [f.result(180) for f in futs]
        rep = router.report()
    for p, out in zip(ps, outs):
        np.testing.assert_array_equal(out, oracle(p))   # bit-identical
    assert rep.workers == 2 and rep.live_workers == 2
    assert rep.streams == len(ps) and rep.failures == 0
    assert rep.routed_affinity == len(ps)       # all carried a full page
    assert rep.tokens == len(ps) * MAXNEW
    assert rep.crossings > 0 and rep.tokens_per_crossing > 0


def test_prefix_affinity_converts_to_prefix_hits(oracle):
    # four streams with one shared page-aligned prefix: affinity must land
    # them on ONE worker, whose prefix index then shares the donor's pages
    shared = prompts(1, seed=3)[0]
    group = [shared] + [
        np.concatenate([shared[:PAGE], p[PAGE:]]) for p in prompts(3, seed=4)
    ]
    with ClusterRouter(spec(hold_admission=True), workers=2) as router:
        futs = [router.submit(p, MAXNEW) for p in group]
        router.start()
        outs = [f.result(180) for f in futs]
        rep = router.report()
    for p, out in zip(group, outs):
        np.testing.assert_array_equal(out, oracle(p))   # sharing stays exact
    per_worker = [r.streams for r in rep.worker_reports]
    assert sorted(per_worker) == [0, 4]         # one worker took the group
    assert rep.prefix_hits >= 1                 # ...and actually shared
    assert rep.prefix_tokens_reused >= PAGE


def test_sub_page_prompts_spill_round_robin(oracle):
    ps = prompts(4, length=PAGE - 1, seed=9)    # no full page to hash
    with ClusterRouter(spec(), workers=2) as router:
        outs = [router.submit(p, MAXNEW) for p in ps]
        outs = [f.result(180) for f in outs]
        rep = router.report()
    for p, out in zip(ps, outs):
        np.testing.assert_array_equal(out, oracle(p))
    assert rep.routed_spill == 4 and rep.routed_affinity == 0
    assert [r.streams for r in rep.worker_reports] == [2, 2]    # alternated


def test_killed_worker_fails_inflight_and_leaves_routing():
    # the crash regression: hold admission so submissions are parked
    # in-flight, kill the worker under them, and require (a) every future
    # of the victim fails with ClusterWorkerError, (b) the other worker's
    # streams are untouched, (c) the router stops routing to the corpse
    with ClusterRouter(spec(hold_admission=True), workers=2) as router:
        pa = prompts(1, seed=11)[0]
        ia = router._affinity(pa) % 2
        pb = next(p for s in range(100, 200) for p in prompts(1, seed=s)
                  if router._affinity(p) % 2 != ia)
        victim = router.workers[ia]
        doomed = [router.submit(pa, MAXNEW) for _ in range(3)]
        safe = router.submit(pb, MAXNEW)
        victim.kill()
        deadline = time.time() + 30
        while victim.alive and time.time() < deadline:
            time.sleep(0.05)
        assert not victim.alive
        router.start()                  # release the survivor's admission
        for f in doomed:
            with pytest.raises(ClusterWorkerError):
                f.result(180)
        assert all(f.done() for f in doomed)    # no stranded futures
        assert safe.result(180) is not None     # survivor unaffected
        # the router no longer routes to the dead worker: pa's affinity
        # re-resolves over the surviving set
        assert victim not in router._live()
        out = router.decode(pa, MAXNEW, timeout=180)
        assert out.shape == (MAXNEW,)
        assert router.report().live_workers == 1


def test_dead_submit_raises_when_no_workers_left():
    with ClusterRouter(spec(), workers=1) as router:
        router.workers[0].kill()
        deadline = time.time() + 30
        while router.workers[0].alive and time.time() < deadline:
            time.sleep(0.05)
        with pytest.raises(ClusterWorkerError, match="no live workers"):
            router.submit(prompts(1)[0], MAXNEW)


def test_drain_and_rejoin(oracle):
    p = prompts(1, seed=21)[0]
    with ClusterRouter(spec(), workers=2) as router:
        np.testing.assert_array_equal(router.decode(p, MAXNEW, timeout=180),
                                      oracle(p))
        final = router.drain_worker(0)
        assert not router.workers[0].accepting
        assert final.failures == 0
        # drained worker's report still folds into the aggregate
        assert router.report().streams >= final.streams
        # traffic keeps flowing on the survivor
        np.testing.assert_array_equal(router.decode(p, MAXNEW, timeout=180),
                                      oracle(p))
        # rejoin: a fresh process, serving again
        router.rejoin_worker(0)
        assert router.report().live_workers == 2
        np.testing.assert_array_equal(router.decode(p, MAXNEW, timeout=180),
                                      oracle(p))


def test_boot_failure_surfaces():
    bad = spec(program="repro_torch.models.programs:no_such_factory")
    with pytest.raises(ClusterWorkerError, match="failed to boot"):
        ClusterRouter(bad, workers=1)


def test_aot_mismatch_falls_back_to_source(tmp_path):
    # an AOT cache holding a DIFFERENT program must not be loaded blind:
    # build_planned compares digests, warns, and plans from source
    other = mixed.trace(export_attn_decode_lm(
        vocab=VOCAB, d_model=DM, max_context=MAX_CTX, seed=5)).plan("tech-gfp")
    cache = tmp_path / "cache"
    other.save_aot(cache)
    with pytest.warns(UserWarning, match="different program"):
        planned = build_planned(spec(aot_path=str(cache)))
    # the plan really is the factory's program, not the cache's
    from repro_torch.serve import program_digest
    want = program_digest(export_attn_decode_lm(
        vocab=VOCAB, d_model=DM, max_context=MAX_CTX))
    assert program_digest(planned.traced.program) == want
