"""CI smoke gate for the serving runtime: bounded-time, assertion-driven.

Drives a :class:`repro_torch.serve.MixedServer` with 8 concurrent client
threads and mixed request shapes over the quickstart-shaped program
(offloadable dense block, hot loop, host-only safety check;
:func:`repro_torch.bench.serve_sections.build_program`) and asserts the
serving invariants:

* every batched result is **bit-identical** to a per-request
  ``hybrid(*args)`` call on the same PlannedProgram;
* at least one batched crossing happened, and measured guest→host
  crossings per request are **strictly lower** than unbatched serving;
* a cold bucket is served on the emulator fallback (no blocking on the
  units' first call) and the background warm eventually flips it to the
  compiled path;
* the server's signature states all live on one shared plan: no duplicate
  unit constructions across buckets (on the card: 8 client threads and the
  background warm share one CUDA context and one unit cache).

The units run on the CUDA card unless ``--device cpu`` is given.  Failures
print the offending report table before exiting non-zero.  Exit status is
the verdict:

    PYTHONPATH=src python -m repro_torch.bench.smoke_serve [--device cpu]
"""
from __future__ import annotations

import threading
import time

import numpy as np

from .. import mixed
from ..core.api import resolve_device
from ..serve import BucketLadder, MixedServer
from .common import check, finish_gate, gate_main
from .serve_sections import build_program

N_CLIENTS = 8
REQUESTS_PER_CLIENT = 4
# the program holds no kernel op (matmul, tanh, mul): no kernel is on this path
KERNELS: tuple[str, ...] = ()


def run(device=None, *, rows: list | None = None) -> list[str]:
    resolve_device(device)
    rows = [] if rows is None else rows
    planned = mixed.trace(build_program()).plan("tech-gfp")
    direct = planned.compile(backend=device)

    rng = np.random.default_rng(1)
    requests = []                            # mixed shapes: 1-row and 2-row
    for i in range(N_CLIENTS * REQUESTS_PER_CLIENT):
        n = 1 if i % 3 else 2
        requests.append(rng.standard_normal((n, 64)).astype(np.float32))

    # unbatched baseline: one entry call per request
    with mixed.instrument() as rec:
        refs = [direct(r) for r in requests]
    unbatched = rec.merged()
    unbatched_cpr = unbatched.guest_to_host / unbatched.calls
    check(unbatched_cpr >= 1, "expected at least one crossing per direct call",
          f"unbatched crossings/request = {unbatched_cpr}")

    ladder = BucketLadder(batch_sizes=(1, 2, 4, 8))
    with MixedServer(planned, ladder=ladder, max_batch_delay=0.02,
                     backend=device) as server:
        # cold-bucket semantics first: the very first request of a shape is
        # served on the emulator path, never blocking on the units
        cold = server.request(requests[0])
        rep = server.report()
        check(rep.fallback_requests == 1 and rep.batches == 0,
              "cold bucket must fall back to the emulator path", rep.table())
        np.testing.assert_allclose(cold[0], refs[0][0], rtol=1e-5, atol=1e-6)
        deadline = time.time() + 60
        while server.report().warm_compiles < 1 and time.time() < deadline:
            time.sleep(0.01)
        check(server.report().warm_compiles >= 1,
              "background warm never landed", server.report().table())
        rows.append("smoke_serve/fallback,nan,cold=emulator;warm=background")

        # pre-compile remaining buckets, then hammer with concurrent clients
        server.warm(requests[0])                 # 2-row shape (i % 3 == 0)
        server.warm(requests[2])                 # 1-row shape
        results: list = [None] * len(requests)
        errors: list = []

        def client(c: int):
            try:
                for j in range(REQUESTS_PER_CLIENT):
                    i = c * REQUESTS_PER_CLIENT + j
                    results[i] = server.request(requests[i])
            except Exception as e:  # noqa: BLE001 - reported by the check below
                errors.append(e)

        before = server.report()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(N_CLIENTS)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        after = server.report()
        check(not errors, f"client errors: {errors[:3]}", after.table())

    for i, (ref, out) in enumerate(zip(refs, results)):
        check(len(ref) == len(out),
              f"request {i}: output arity {len(out)} != {len(ref)}")
        for r, o in zip(ref, out):
            check(np.array_equal(r, o), f"request {i} not bit-identical",
                  after.table())
    rows.append(f"smoke_serve/bitident,nan,requests={len(requests)};ok")

    n_req = after.requests - before.requests
    n_batches = after.batches - before.batches
    crossings = after.crossings - before.crossings
    check(n_req == len(requests),
          f"served {n_req} of {len(requests)} requests", after.table())
    check(n_batches >= 1, "no batched crossings happened", after.table())
    check(n_batches < n_req, "batching never coalesced concurrent requests",
          after.table())
    cpr = crossings / n_req
    check(cpr < unbatched_cpr,
          f"crossings/request did not improve: batched={cpr} "
          f"unbatched={unbatched_cpr}", after.table())
    check(after.fallback_requests == before.fallback_requests,
          "warm buckets must not fall back", after.table())
    rows.append(
        f"smoke_serve/batched,nan,requests={n_req};batches={n_batches};"
        f"cpr={cpr:.3f};unbatched_cpr={unbatched_cpr:.3f};"
        f"occupancy={after.batch_occupancy:.2f}")

    # all buckets are signatures of ONE shared plan: no duplicate unit builds
    cache = planned.unit_cache
    check(cache.hits > 0 and len(cache) == cache.builds,
          f"duplicate unit builds: len={len(cache)} builds={cache.builds} "
          f"hits={cache.hits}")
    rows.append(f"smoke_serve/shared_units,nan,builds={cache.builds};"
                f"hits={cache.hits}")
    finish_gate(rows, "smoke_serve", device, KERNELS)
    return rows


def main(argv=None) -> int:
    return gate_main("SMOKE-SERVE", "smoke_serve", run, 120, argv)


if __name__ == "__main__":
    raise SystemExit(main())
