"""Mixed-execution serving: a MixedServer under concurrent, mixed-size traffic.

The serving program embeds a per-request host-side safety check (the
paper's printf case) in the hot path, so the whole step cannot be one
unit — the all-or-nothing wall.  The staged frontend offloads the
compilable segments and interprets only the check;
:class:`repro_torch.serve.MixedServer` then amortizes the remaining
guest→host crossings across callers by coalescing concurrent requests into
one padded batch per bucket.

``export_dense_forward`` exports batch-agnostic programs (wildcard leading
dims), so every batch bucket is just another entry signature on one
compiled object — all buckets share the plan cache, the GRT and the units.
On the card the forward's ``rmsnorm`` and ``sdpa`` ops run the RMSNorm and
flash-attention kernels (float32: the 3xTF32 tensor-core route).

    PYTHONPATH=src python -m repro_torch.examples.serve_mixed [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import numpy as np
import torch

from .. import mixed
from ..configs import reduced_config
from ..core.api import resolve_device
from ..models import api, programs
from ..serve import BucketLadder, MixedServer

N_CLIENTS = 8
REQUESTS_PER_CLIENT = 4
SEQ = 128                      # the export's pinned sequence length
SEQ_CHOICES = (96, 128)        # mixed request lengths; ladder pads to 128
N_LAYERS = 6
TP = 1                         # the head plan of one card


def run(device=None, *, n_layers: int = N_LAYERS, n_clients: int = N_CLIENTS,
        requests_per_client: int = REQUESTS_PER_CLIENT) -> dict:
    """Print the demo; returns the unbatched and batched crossings per
    request, the server's report and ``bitident`` (every batched result
    equal to its per-request call, checked before returning)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(
        reduced_config("llama3.2-1b"), compute_dtype="float32",
        d_model=192, d_ff=512, n_layers=n_layers)
    params = api.init(cfg, torch.Generator().manual_seed(0), tp=TP, device=dev)
    prog, _ = programs.export_dense_forward(
        cfg, params, batch=1, seq=SEQ, with_host_check=True, tp=TP)
    traced = mixed.trace(prog)

    print("== serving program with a host-side check in the hot path ==")
    try:
        traced.plan("native")
    except mixed.NativeInfeasibleError:
        print("  whole-step jit: INFEASIBLE (host-only op) — the paper's "
              "all-or-nothing wall\n")

    planned = traced.plan("tech-gfp")
    direct = planned.compile(backend=device)

    rng = np.random.default_rng(0)
    requests = [
        rng.integers(0, cfg.vocab, (1, rng.choice(SEQ_CHOICES)), dtype=np.int32)
        for _ in range(n_clients * requests_per_client)
    ]

    # -- baseline: every request is its own entry call --------------------
    # the export pins seq=128 (batch is agnostic), so shorter requests are
    # zero-padded to 128 and sliced back — exactly the batcher's contract,
    # which is exact for causal programs
    def run_direct(tokens):
        s = tokens.shape[1]
        padded = np.pad(tokens, ((0, 0), (0, SEQ - s)))
        outs = direct(padded)
        return tuple(o[:, :s] if o.ndim >= 2 and o.shape[1] == SEQ else o
                     for o in outs)

    run_direct(requests[0])    # warm up plan + unit build outside the timing
    with mixed.instrument() as rec:
        refs = [run_direct(r) for r in requests]
    unbatched = rec.merged()
    unbatched_cpr = unbatched.guest_to_host / unbatched.calls
    print(f"unbatched: {unbatched.calls} calls, "
          f"{unbatched_cpr:.1f} crossings/request, "
          f"{unbatched.wall_seconds / unbatched.calls * 1e3:.1f} ms/request")

    # -- batched serving over the same PlannedProgram ---------------------
    ladder = BucketLadder(batch_sizes=(1, 2, 4, 8), seq_multiple=SEQ)
    with MixedServer(planned, ladder=ladder, max_batch_delay=0.02,
                     backend=device) as server:
        for seq in SEQ_CHOICES:   # pre-compile every bucket: no cold fallbacks
            server.warm(rng.integers(0, cfg.vocab, (1, seq), dtype=np.int32))

        results = [None] * len(requests)
        t0 = time.perf_counter()

        def client(c):
            for j in range(requests_per_client):
                i = c * requests_per_client + j
                results[i] = server.request(requests[i])

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        wall = time.perf_counter() - t0
        rep = server.report()

    for ref, out in zip(refs, results):
        for r, o in zip(ref, out):
            np.testing.assert_array_equal(r, o)
    print(f"batched:   {rep.batches} batched calls for {rep.requests} requests, "
          f"{rep.crossings_per_request:.1f} crossings/request, "
          f"{wall / rep.requests * 1e3:.1f} ms/request")
    print(f"           occupancy={rep.batch_occupancy:.2f}, "
          f"mean queue wait={rep.mean_queue_wait * 1e3:.1f} ms, "
          f"fallbacks={rep.fallback_requests}")
    print("\nall", len(requests), "batched results are bit-identical to "
          "per-request calls; batching cut crossings/request "
          f"{unbatched_cpr:.1f} → {rep.crossings_per_request:.1f}")
    return {"requests": len(requests), "bitident": True,
            "unbatched_crossings_per_request": unbatched_cpr,
            "crossings_per_request": rep.crossings_per_request,
            "wall_s": wall, "report": rep}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="unit device: omit for the CUDA card, 'cpu' for the CPU")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
