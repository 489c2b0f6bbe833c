"""repro_torch.serve — concurrent, batching mixed-execution serving on the port.

Builds the serving layer the ROADMAP calls for on top of the staged
frontend, in two regimes over the same thread-safe substrate (shared
:class:`~repro_torch.core.api.PlannedProgram`: signature cache, GRT, and
cross-signature offload units):

* **Request-level batching** — :class:`MixedServer`: a shape-bucketing
  batcher (:class:`BucketLadder`) coalesces concurrent single requests
  into one guest→host crossing-set per batch, and cold buckets are
  compiled in the background while requests fall back to the emulator
  path.

      from repro_torch import mixed
      from repro_torch.serve import BucketLadder, MixedServer

      planned = mixed.trace(program).plan("tech-gfp")
      with MixedServer(planned, ladder=BucketLadder(batch_sizes=(1, 2, 4, 8),
                                                    seq_multiple=16)) as server:
          out = server.request(tokens)     # or .submit() -> Future
          print(server.report())

* **Token-level continuous batching** — :class:`DecodeScheduler`: treats
  a decode-loop program (prefill + per-token step) as a persistent
  iteration, re-forming the batch every step — streams join mid-flight at
  their prefill boundary, retire the moment they finish, and all live
  streams share ONE batched step crossing per token position.  A
  declarative :class:`StateSpec` extends the state contract from
  fixed-size rows to **paged, growing KV-cache state**
  (:class:`PagePool`/:class:`BlockTable`): fixed-size pages per stream,
  recycled at retirement, re-materialized at one fixed padded shape per
  step so bit-exactness is untouched.  ``share_prefixes=True`` adds
  **copy-on-write prefix sharing**: streams whose prompts share a
  page-aligned prefix (same prompt length) map the donor's pages
  read-only instead of re-storing them — refcounted, CoW-protected, and
  still bit-identical to solo decoding.

      planned = mixed.trace(decode_program).plan("tech-gfp")
      with DecodeScheduler(planned, step="decode_step", capacity=8) as sched:
          tokens = sched.decode(prompt, max_new_tokens=16)
          print(sched.report())            # tokens/crossing, occupancy, ...

* **Multi-model co-serving** — :class:`MultiModelDecodeScheduler`: one
  loop thread drives a lane (a full :class:`DecodeScheduler` with its own
  slot partition and signature group) per registered model, so each step
  issues one batched crossing *per model* and every paged lane draws from
  ONE shared quota-partitioned :class:`PagePool`.  Heterogeneous state
  contracts co-exist: a fixed-size-state SSM (``StateSpec(growing={})``,
  zero page traffic) beside a growing-KV attention LM, each stream still
  bit-identical to its model's solo :func:`decode_reference`.

      multi = MultiModelDecodeScheduler()
      multi.register("attn", planned_attn, step="decode_step",
                     capacity=4, state=spec)
      multi.register("mamba2", planned_m2, step="decode_step", capacity=4)
      with multi:
          toks = multi.decode(prompt, 8, model="mamba2")
          print(multi.report().table())  # per-model sections + aggregate

* **Cross-process cluster tier** — :class:`ClusterRouter` spreads decode
  traffic over N spawned worker processes (one :class:`DecodeScheduler`
  each, behind a length-prefixed socket channel), routing prompts by a
  hash of their first KV page so per-worker prefix sharing keeps hitting
  (**prefix affinity**), with round-robin spill for sub-page prompts,
  graceful drain/rejoin, and an aggregate :class:`ClusterReport`.
  Workers named an AOT cache (:mod:`repro_torch.serve.aot`,
  ``PlannedProgram.save_aot/load_aot``) boot warm with compile count 0.

      spec = WorkerSpec(program="repro_torch.models.programs:export_decode_lm",
                        capacity=4, aot_path="cache/decode_lm")
      with ClusterRouter(spec, workers=2) as router:
          tokens = router.decode(prompt, max_new_tokens=16)
          print(router.report().table())   # per-worker + aggregate

The offload units run on CUDA unless ``backend="cpu"`` is passed
(``MixedServer``, ``DecodeScheduler``, ``WorkerSpec``); the tests pass it.
See ``docs/serving.md`` for when each regime wins and the full report
field reference.
"""
from .aot import AotError, load_planned, program_digest, save_planned
from .batcher import (
    Batch,
    BlockTable,
    BucketLadder,
    PagedKVState,
    PagePool,
    Request,
    SlotMap,
    StateSpec,
    coalesce,
    group_key,
    pad_request,
)
from .cluster import (
    ClusterRouter,
    ClusterWorker,
    ClusterWorkerError,
    WorkerSpec,
    build_planned,
    prefix_affinity,
)
from .reports import (
    ClusterReport,
    DecodeReport,
    DecodeStats,
    MultiModelReport,
    ServerReport,
    ServerStats,
)
from .runtime import (
    DecodeScheduler,
    DecodeStream,
    MixedServer,
    MultiModelDecodeScheduler,
    decode_reference,
    greedy_sample,
    paged_decode_reference,
)

__all__ = [
    "Batch", "BlockTable", "BucketLadder", "PagePool", "PagedKVState",
    "Request", "SlotMap", "StateSpec", "coalesce", "group_key",
    "pad_request",
    "MixedServer", "ServerReport", "ServerStats",
    "DecodeScheduler", "DecodeStream", "DecodeReport", "DecodeStats",
    "MultiModelDecodeScheduler", "MultiModelReport",
    "decode_reference", "greedy_sample", "paged_decode_reference",
    "AotError", "load_planned", "program_digest", "save_planned",
    "ClusterReport", "ClusterRouter", "ClusterWorker", "ClusterWorkerError",
    "WorkerSpec", "build_planned", "prefix_affinity",
]
