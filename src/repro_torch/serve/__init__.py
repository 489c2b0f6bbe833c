"""repro_torch.serve — token-level continuous batching on the port.

:class:`DecodeScheduler` treats a decode-loop program (prefill + per-token
step) as a persistent iteration, re-forming the batch every step — streams
join mid-flight at their prefill boundary, retire the moment they finish,
and all live streams share ONE batched step crossing per token position.  A
:class:`StateSpec` with growing entries keeps paged KV-cache state
(:class:`PagePool`/:class:`BlockTable`), and ``paged_step=...`` steps
through the block-sparse paged-attention CUDA kernel.

    planned = mixed.trace(decode_program).plan("tech-gfp")
    with DecodeScheduler(planned, step="decode_step", capacity=8) as sched:
        tokens = sched.decode(prompt, max_new_tokens=16)
        print(sched.report())            # tokens/crossing, occupancy, ...

:class:`MultiModelDecodeScheduler` co-serves several decode models —
say the mamba2 SSM (fixed-size state, no pages) and the attention LM (paged
KV) — from one loop over one shared :class:`PagePool`, reporting per model
and for the pool (:class:`MultiModelReport`).

Request-level serving, AOT and the cluster tier come with later slices of
the port.
"""
from .batcher import (
    BlockTable,
    PagedKVState,
    PagePool,
    SlotMap,
    StateSpec,
)
from .reports import DecodeReport, DecodeStats, MultiModelReport
from .runtime import (
    DecodeScheduler,
    DecodeStream,
    MultiModelDecodeScheduler,
    decode_reference,
    greedy_sample,
    paged_decode_reference,
)

__all__ = [
    "BlockTable", "PagePool", "PagedKVState", "SlotMap", "StateSpec",
    "DecodeScheduler", "DecodeStream", "DecodeReport", "DecodeStats",
    "MultiModelDecodeScheduler", "MultiModelReport",
    "decode_reference", "greedy_sample", "paged_decode_reference",
]
