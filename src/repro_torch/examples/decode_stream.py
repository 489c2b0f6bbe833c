"""Continuous batching for decode loops: the per-token crossing, amortized.

A solo autoregressive decode loop is the paper's hot-loop pathology at
serving time: every token is one tiny entry call — one full set of
guest→host crossings buys one token for one stream.  The
:class:`repro_torch.serve.DecodeScheduler` lifts the loop into the
scheduler: streams join mid-flight at their prefill boundary, retire the
moment they finish, and every step issues ONE batched entry crossing shared
by all live streams — so tokens/crossing scales with occupancy while each
stream's tokens stay bit-identical to decoding it alone.

    PYTHONPATH=src python -m repro_torch.examples.decode_stream [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import mixed
from ..core.api import resolve_device
from ..models.programs import export_decode_lm
from ..serve import DecodeScheduler, decode_reference

VOCAB, DM, PROMPT_LEN = 64, 32, 8
LENS = (10, 12, 14, 16, 18, 20, 6, 8)          # staggered stream lengths


def run(device=None) -> dict:
    """Print the demo; returns the solo and continuous tokens per crossing,
    the scheduler's report and each stream's (slot, admitted, retired,
    tokens)."""
    resolve_device(device)
    prog = export_decode_lm(vocab=VOCAB, d_model=DM)
    planned = mixed.trace(prog).plan("tech-gfp")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (PROMPT_LEN,), dtype=np.int32)
               for _ in LENS]

    # -- baseline: one stream at a time, one crossing-set per token --------
    prefill = planned.compile(backend=device)
    step = planned.for_entry("decode_step").compile(backend=device)
    refs = []
    with mixed.instrument() as rec:
        for p, n in zip(prompts, LENS):
            refs.append(decode_reference(prefill, step, p, n,
                                         capacity=len(LENS)))
    solo = rec.merged()
    solo_tpc = sum(LENS) / solo.guest_to_host
    print(f"solo decoding:  {sum(LENS)} tokens, {solo.guest_to_host} "
          f"crossings -> {solo_tpc:.2f} tokens/crossing")

    # -- continuous batching: same streams, shared step crossings ----------
    with DecodeScheduler(planned, step="decode_step", capacity=len(LENS),
                         start=False, backend=device) as sched:
        sched.warm(PROMPT_LEN)
        streams = [sched.submit(p, n) for p, n in zip(prompts, LENS)]
        t0 = time.perf_counter()
        sched.start()               # whole burst admits in one batched prefill
        outs = [s.result(timeout=120) for s in streams]
        wall = time.perf_counter() - t0
        rep = sched.report()

    for ref, out in zip(refs, outs):
        np.testing.assert_array_equal(ref, out)

    print(f"continuous:     {rep.tokens} tokens, {rep.crossings} crossings "
          f"-> {rep.tokens_per_crossing:.2f} tokens/crossing "
          f"({wall * 1e3:.0f} ms)")
    print()
    print(rep.table())
    print()
    for s in streams:
        print(f"  stream slot={s.slot} admitted@step {s.admitted_step:>2} "
              f"retired@step {s.retired_step:>2} tokens={len(s.result())}")
    print(f"\nall {len(LENS)} streams bit-identical to solo decoding; "
          f"continuous batching lifted tokens/crossing "
          f"{solo_tpc:.2f} -> {rep.tokens_per_crossing:.2f}")
    return {"solo_tokens_per_crossing": solo_tpc,
            "tokens_per_crossing": rep.tokens_per_crossing, "report": rep,
            "streams": [(s.slot, s.admitted_step, s.retired_step, len(s.result()))
                        for s in streams],
            "wall_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="unit device: omit for the CUDA card, 'cpu' for the CPU")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
