#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs end to end on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits non-zero; the result lines print only at the end):

1. Device and build: torch version, the card's name and power limit
   (``nvidia-smi``), and an ``nvcc`` build of every kernel source of the
   path (one compiler per source, all started together), with the build time
   and each kernel's registers and spills from the compiler's report (the
   tensor-core attention body once per head dim it is built for, the SSD
   tensor-core body once per type).
2. Kernel against its plain PyTorch version on the card: page sizes
   {1, 2, 8, 16} x five tail states x contiguous/gapped/permuted tables x
   with and without a fresh row, at d=16 and d=960, to 2e-5 (the
   reference's float32 kernel tolerance); then the split's edges at the
   serving shape (lengths on page boundaries and on the boundaries of the
   cluster's page runs, a full 128-page table) and an odd d; every launch
   on ``paged_route``'s body (``"split"``; d = 18 on ``"simt"``); empty
   streams give exact zeros, a length-0 stream with a fresh row gives
   exactly its v row, a repeat launch and row b's solo launch are bitwise
   equal to the batched one.
3. The main path at real width: ``export_attn_decode_lm`` at SmolLM-360M's
   widths (d_model 960, vocab 49152; one layer, one head), planned
   ``tech-gfp``, served by ``DecodeScheduler`` in ``paged_step`` mode on
   the card (capacity 8, page size 16, max_context 2048, a 1024-page pool):
   8 streams of 128-token prompts decoding 16..64 tokens.  Gates: the
   shortest and longest stream equal ``paged_decode_reference`` bitwise,
   every step went through the kernel, all on its split body (``"split"``),
   and every batched prefill through the flash kernel (the launch counts
   cover them; d = 960 in float32 takes the 3xTF32 tensor-core body,
   ``"tf32x3"``), the page-visit accounting
   covers the table walk, the pool drains leak-free.  The batched prefill is
   timed with the flash kernel and with its plain version in its place.
   The longest stream's solo reference run and one batched prefill are
   profiled (device time by operation per step, and the device's idle
   share).  Then the kernel's time at the step shape against its bound,
   the old CUDA-core body's through its C entry (``simt_ms``), the split
   body's at each cluster size of ``CLUSTER_SIZES`` (``ms_by_cluster``),
   the plain version's time, and where the page pools live (on the card,
   passed to each step by reference).
4. A small input checked by the repo's own means: the 4-stream
   ``decode_paged_kernel`` workload on the card gives the tokens of the same
   run on the CPU and the counters recorded in ``BENCH_serve.json``; then
   ``BENCH_serve.json``'s ``request_level`` (``MixedServer``),
   ``decode_continuous`` (the prefix-sharing burst), ``decode_cluster``
   (one worker, ``save_aot``, two spawned workers on the card booted from
   the cache) and ``observability`` (the traced cluster run) sections,
   each field exactly, with the units on the card
   (``repro_torch.bench.serve_sections``).
5. The dense kernels (RMSNorm, flash attention, flash-decode) against their
   plain versions on the card: the reference's kernel cases
   (``tests/test_kernels.py``) plus every shape the dense, mixed and paged
   paths and their float32 gates give the kernels, short last tiles and
   causal T < S and T > S, RMSNorm at the train
   step's (8, 1024, 960) rows, and phase 18's shapes (Granite's GQA group 2
   and DBRX's group 6 at d = 128, SeamlessM4T's unmasked encoder and
   cross-attention at T = 512 against S = 128, Phi-3-vision's d = 96 forward
   and flash-decode, DBRX's d_model 6144 norms; DBRX's flash-decode on
   ``"simt"``, its group of 6 at d = 128 exceeding the split body's q
   registers), float32 at
   2e-5 (RMSNorm 1e-5) and bfloat16 at 2e-2; the forward with statistics
   (o, m, l) on the same attention cases (float32 2e-4); every flash launch
   on the route ``flash_route`` gives (bf16 at d % 16 == 0: ``"wgmma"``;
   float32 at d % 8 == 0: ``"tf32x3"``), every RMSNorm launch at a path
   shape on ``"vec"`` and at an odd D and an offset view on ``"scalar"``;
   decode with pos < 0 gives exact zeros; row b of a batched flash launch,
   and the last row of an RMSNorm launch, are bitwise equal to a solo
   launch; every flash-decode launch at a path shape on ``decode_route``'s
   ``"split"``, at d = 18 on ``"simt"``; flash-decode's split edges at the
   dense and hybrid step shapes (one key, the first tile's and the ranks'
   run edges, pos >= S - 1) with a repeat launch and row b's solo launch
   bitwise equal to the batched one; a causal ``sdpa`` op with T != S is
   refused on the card.
6. The dense standard path at full size: ``launch.serve.greedy_generate`` on
   SmolLM-360M (all 32 layers and widths, bf16 compute, tp=1, random weights
   from a seeded generator): 8 prompts of 512 tokens, 32 new tokens each.
   Gates: 32 flash + 65 RMSNorm launches per prefill (all 32 flash on the
   tensor-core body, every RMSNorm on ``"vec"``) and 32 decode (all on
   ``"split"``) + 65 RMSNorm launches per step; timed tokens equal greedy_generate's; on a
   float32 copy of the config, prefill + one decode step equals the
   teacher-forcing logits at 5e-3.  A profiler window splits the prefill's
   and a decode step's device time by operation.
7. The dense mixed path at full size: ``export_dense_forward`` (float32,
   batch 2, seq 256, host check, tp=1): ``native`` is refused, ``tech-gfp``
   on the card gives the model's logits (2e-3/2e-4), on the card and on a
   CPU copy of the weights (the plain versions), and the RMSNorm and flash
   kernels ran (flash on ``"tf32x3"``: float32 at d = 64; RMSNorm on
   ``"vec"``).  A profiler window of one call (device time by operation and
   the idle share).
8. The dense kernels' times at the path's shapes against their bounds,
   their plain versions and the one PyTorch call that computes the same
   function (timed for comparison only; the port never calls it): the flash
   forward and the forward with statistics at the prefill's bf16 shape and
   at the mixed forward's float32 (2,15,256,64), the flash forward at the
   attn LM's float32 d = 960 prefill, each also on the CUDA-core body
   through its C entry (``cuda_core_ms``; float32 bounds at the 3xTF32
   rate, the TF32 peak over three); RMSNorm at the prefill's (4096, 960)
   and the decode step's (8, 960) rows against ``F.rms_norm``; flash-decode
   at the dense step's shape, also on the old CUDA-core body through its C
   entry (``simt_ms``) and the split body at each cluster size
   (``ms_by_cluster``), against ``sdpa`` with a ``kpos <= pos`` mask.
   Then the registered operators' cost per call (``kernels/library.py``):
   RMSNorm and the float32 flash forward at configuration 3's shapes
   issued through ``repro_torch::`` and through the direct
   ``kernels/ops.py`` call, on the host clock.
9. The SSD scan kernel against its plain version on the card, on both
   bodies: the reference's ``SSD_CASES``, short last chunks and the hybrid
   path's shapes ((8,1024,80,64), and its float32 gate's T=300 and 304, not
   multiples of the 256 chunk) on the tensor-core body (``"mma"``), N or P
   off 8 on the CUDA-core body (``"simt"``), and on each a case whose
   exp(cs_i - cs_j) is inf above the diagonal (y finite); float32 at 2e-4
   and bfloat16 at 2e-2, y and the final state (float32 in both dtypes: on
   ``"mma"`` held at 2e-4 in bfloat16 too); each launch on the route
   ``ssd_route`` gives, whose chunk table equals the built body's
   (``ssd_scan_mma_max_chunk``); row 0 of a batched launch bitwise equal to
   a solo launch; the model's strided x.
10. ``decode_multimodel`` on the card: the mamba2 SSM and the attention LM
   co-served over one shared page pool give ``BENCH_serve.json``'s counters
   exactly and every model's solo ``decode_reference`` tokens.
11. The hybrid standard path at full width: ``greedy_generate`` on
   Zamba2-2.7B (all 54 Mamba2 layers, the shared block 9 times, bf16
   compute, tp=1, random weights from a seeded generator): 8 prompts of
   1024 tokens, 32 new tokens each.  Gates: 54 SSD + 9 flash + 73 RMSNorm
   launches per prefill (all 54 SSD and 9 flash on the tensor-core bodies,
   every RMSNorm on ``"vec"``), 9 decode (all on ``"split"``) + 73
   RMSNorm per step; timed
   tokens equal greedy_generate's; on a float32 copy of the config, 2
   prompts of 300 tokens, prefill + 4 decode steps equal the
   teacher-forcing logits at 5e-3, its 108 SSD launches (T = 304 and 300)
   all on ``"mma"``.  Profiler windows of one prefill and of 8 decode steps.
12. The SSD kernel's time at the path's bf16 shape and at its float32
   gate's (2,304,80,64) against its bound (the float32-operand products at
   the rate of the TF32 terms they need: two in bf16, 494/2 TFLOP/s, three
   in float32; C.B^T once per (b, chunk)), its plain version (no single
   PyTorch call computes it) and the CUDA-core body through its C entry
   (``cuda_core_ms``), and the flash
   forward, the forward with statistics (both also on the CUDA-core body),
   flash-decode (also on the old CUDA-core body and at each cluster size)
   and RMSNorm kernels' times at the hybrid shapes (RMSNorm at
   the prefill's (8192, 2560) bf16 and the decode step's (8, 2560) float32
   rows against ``F.rms_norm``).
13. The training kernels (forward with statistics, dQ, dK/dV) against their
   plain versions on the card: the reference's ``BWD_CASES``, a short last
   tile at d = 128 and the train step's shape, float32 at 2e-4 and bfloat16
   at 2e-2, each launch on the route ``flash_route`` / ``flash_bwd_route``
   gives (bf16 at d % 16 == 0: the tensor-core bodies; the float32 forward
   with statistics on ``"tf32x3"``, float32 dQ and dK/dV on ``"simt"``);
   batched == solo bitwise and strided views at the train shape.
14. The training path at full width: ``launch.train.train`` on SmolLM-360M
   uncut (float32 masters, bf16 compute, remat, tp=1, AdamW lr 3e-4, clip
   1.0), 6 steps of 8 x 1024 ``TokenPipeline`` tokens.  Gates: finite
   losses and grad norms; 64 forward-with-statistics (32 + 32 recomputed),
   32 dQ and 32 dK/dV launches per step, all on the tensor-core bodies,
   every RMSNorm on ``"vec"``, and no plain-version call; one
   step's gradients through the kernels against the plain versions in
   their places (one run each, back to back) at a global relative error
   <= 2e-2, every leaf finite and nonzero where the plain one is; on the
   reduced config in float32 the card's step equals the CPU's (1e-4; its
   forward with statistics on ``"tf32x3"``, dQ and dK/dV on ``"simt"``) and a
   3 + 3 resumed run equals 6 uninterrupted steps (rtol 1e-5, atol 1e-6).
   Step p50, tokens/s,
   peak memory, and a profiler window of one step.  Then the three kernels'
   times at the train shape against their bounds, their plain versions and
   ``scaled_dot_product_attention``'s forward and backward (all three also
   on the CUDA-core bodies through their C entries, and dQ + dK/dV together
   against the backward), and RMSNorm's at the train step's (8, 1024, 960)
   rows against ``F.rms_norm``.
15. The paper's evaluation on the card (``repro_torch.bench``): the 17
   workloads under the six schemes at bench scale with the units on the card
   (figs. 4-6: each scheme's time and speedup over ``qemu``, the geomeans,
   crossings and coverage), table 3's four apps with each library set
   offloaded, fig. 7's two reduced dense programs (SmolLM-360M and
   Llama-3.2-1B, float32, d_model 128, 4 layers, 4/2 heads of 16), the
   profile-guided cost model and the crossing-cost decomposition.  Gates:
   every scheme's counters of its cold and warm call, coverage, units and
   output dtypes equal the JAX package's (``reference_counters.json``, the
   card's machine having no JAX), the native-infeasible set too, and outputs
   lie within 2e-3/2e-4 of pure interpretation; fig. 7's launches are 4 flash
   (all ``"tf32x3"``) and 9 RMSNorm (all ``"vec"``) per unit call of the
   forward; profile guidance still offloads npbbt.  Profiles of one
   ``tech-gfp`` call of cjson (the most crossings) and of npbft (the most
   device work).  Then fig. 7's two kernels at its shapes: the float32
   flash forward at q (2,4,128,16) against (2,2,128,16) (``"tf32x3"``)
   beside the CUDA-core body, its plain version and ``sdpa``, and RMSNorm
   at (256, 128) float32 rows (``"vec"``) beside its plain version and
   ``F.rms_norm``.
16. Request-level serving at full width (configuration 8): ``MixedServer``
   over phase 7's program (SmolLM-360M uncut, float32, seq 256, host
   check, batch-agnostic, ``tech-gfp``), buckets {1, 2, 4, 8}, a 20 ms
   window, two batch threads.  A cold request on the emulator fallback
   (its wall logged), then every bucket warm, then 8 client threads send
   ``tests/test_serve.py``'s mix (12 requests of 1 row, 4 of 2, 256 tokens
   each).  Gates: no fallback when warm; every batch's outputs bitwise
   equal to the compiled hybrid called directly on the same padded batch;
   every response within 2e-3/2e-4 of its per-request call (how many are
   bitwise equal is logged); crossings per row below the per-request
   calls'; 32 flash (all ``"tf32x3"``) and 65 RMSNorm (all ``"vec"``)
   launches per batch.  Requests, batches, crossings per row, occupancy,
   latency p50/p99, rows/s, peak memory, and a profiler window of one
   bucket-8 batch.
17. AOT and the cluster at full width (configuration 9):
   ``export_attn_decode_lm`` at d_model 960, vocab 49152, max_context 256
   on spawned workers (capacity 8, page 16, prefix sharing, burst
   admission): one worker serves burst A (8 prompts of 128 tokens sharing
   64, decoding 16..32) and saves its plan with ``save_aot``; two workers
   boot from the cache and serve bursts A + B.  Gates: the counters equal
   the same workload's CPU run (``cluster_full_counters.json``),
   second_boot_compiles 0, streams [8, 8]; every stream bitwise equal to
   the in-process ``decode_reference`` on the card, the cluster's burst A
   to the baseline's; the blobs hold no weights; the prefill's flash
   launches on ``"tf32x3"`` in the eager and in the loaded units.  Boot
   walls cold and warm, blobs and bytes, tokens/s, tokens per crossing,
   step p50 per worker.
18. The rest of the zoo at full width (configuration 10), bf16 compute,
   tp=1, random weights from a seeded CUDA generator, 8 prompts of 512
   tokens: (a) Granite MoE uncut, 32 new tokens, through
   ``greedy_generate``; (b) DBRX at its widths with 2 of its 40 layers
   (its bf16 weights alone are about 264 GB), 8 new; (c) SeamlessM4T uncut
   with 128 stubbed frames and (d) Phi-3-vision uncut with 576 stubbed
   patches, 32 new each, through ``api.prefill``/``api.decode`` (the
   reference's ``greedy_generate`` feeds tokens only); (e) xLSTM uncut, 32
   new.  Gates: every launch counted per prefill and per step (flash on
   ``"wgmma"``, RMSNorm on ``"vec"``, flash-decode on ``"split"``, DBRX's
   on ``"simt"``; SeamlessM4T's flash calls split into causal and
   unmasked), timed tokens equal the counted run's, and float32
   teacher-forcing gates (5e-3): MoE at capacity E/k, SeamlessM4T with
   frames whose length is not ``enc_len_for`` of the cache's (the cross
   caches replaced), Phi-3-vision over its patches, xLSTM at 16 tokens (its
   sLSTM recurrence at the reference's init is chaotic) plus its first
   mLSTM block's chunked form against its own recurrence over 512 tokens.
   Prefill ms, step p50, peak memory, MoE's dropped (token, k) pairs at
   capacity 1.25, and profiler windows of a prefill and a step (MoE's
   routing, dispatch, expert products, combine and attention as ranges).
   Then the flash forward at Phi-3's prefill (d = 96), SeamlessM4T's
   cross-attention and DBRX's prefill, flash-decode at Phi-3's step and at
   DBRX's (q (8,48,1,128) bf16 against the (8,521,8,128) float32 cache, a
   group of 6 at d = 128 on ``"simt"``, against ``sdpa`` with
   ``enable_gqa``) and RMSNorm at Phi-3's and DBRX's prefill rows, each
   against its bound, its plain version and one PyTorch call.
19. The other families train at full width (run right after phase 1, while
   the card's memory is empty; ``make_train_step``, 3 steps of
   8 sequences at seed 0, bf16 compute, float32 masters, remat, tp=1, AdamW
   lr 3e-4, clip 1.0; ``TokenPipeline`` batches, ``make_batch``'s with the
   stubbed frames or patches for encdec and vlm): Zamba2-2.7B (x 1024,
   row 8 under autograd through ``SSDScanFn`` and its VJP), Granite MoE
   (x 1024), SeamlessM4T (x 512, 128 frames), Phi-3-vision (x 512, 576
   patches; depth cut 32 -> 16, see ``FAM_RUNS``) and xLSTM-350M (x 512).
   Launch counts per step and the routes of rows 4-8 derived from the
   layer loops, no serving kernel (rows 1-3) and no plain version in a
   step, the step p50, tokens/s, peak memory, losses, a profiled step's
   idle share, and each family's reduced float32 step on the card against
   the CPU's (1e-4).  After phase 18, rows 4-6 at the new training shapes against
   their plain versions and ``sdpa``'s forward and backward, the SSD VJP
   beside row 8's forward at the Zamba2 shape, and the VJP on the card
   against the CPU's at the float32 SSD gate shapes.
20. Sharded training (configuration 12; run right after phase 19): the
   parent empties its cache and prints what it holds, then spawns two ranks
   that share the card through gloo (``run_spmd``, route ``"shared"``),
   each on a (data 1, model 2) mesh: (d) ``compressed_psum`` of a 2^20
   gradient within the reference test's bound; (a) one Granite MoE layer's
   experts (d 1024, 32 experts, top 8, ``d_ff_expert`` 512) on 8 x 1024
   bf16 tokens through ``moe_block_ep`` against ``moe_block`` on the rank
   at capacity 8.0, forward and every gradient within 2e-2 (global
   relative), and at 1.25, with a router that favours 4 experts, the
   per-sender drops, equal to the count from the routing of the rank's
   slice and more than none; (b) SmolLM-360M's 32 layers
   at full width as 2 pipeline stages of 16 (``pipeline_apply``, 8
   microbatches of 1 x 512, bf16) against the 32 layers in sequence, output
   and every stage weight's gradient within 2e-2, rows 4-7's launches
   counted; (c) Granite MoE at 8 of its 24 layers through ``make_train_step`` with
   ``moe_ep`` and tensor parallelism, 3 steps of 8 x 1024 ``TokenPipeline``
   tokens: launches and routes of rows 4-7 per step, no plain version,
   step p50, tokens/s, each rank's peak, a profiled step's idle share and,
   from the same trace, the host time inside the process group's
   collective ranges (an upper bound on their share: each also waits for
   the device work queued before it) and the device time of their copies,
   and the reduced float32 step on the same mesh on the card against the
   one-rank CPU step (1e-4).  Then (e) a one-rank NCCL world runs (a)'s
   layer and one all-reduce.  ``ranks_by_route`` and each rank's
   ``collectives_by_route`` are printed.  On a machine with a card a rank
   the two ranks run on NCCL instead, and (e) is not run.
21. The rest of sharded execution (configuration 13; run right after phase
   20): two more ranks share the card through gloo.  (a) Tensor
   parallelism on mesh (data 1, model 2), bf16, remat, full widths:
   Zamba2-2.7B at 48 of its 54 layers (4 x 1024; the SSD scan on each
   rank's 40 heads), xLSTM-350M uncut (4 x 128), SeamlessM4T uncut (4 x
   512 + 128 frames), Phi-3-vision at 16 of its 32 layers (4 x 512 + 576
   patches; the patch projection's columns gathered): 3 steps each with
   every launch counted and routed, no plain version, step p50, tokens/s,
   each rank's peak, a profiled step's idle and collective shares, then a
   prefill of 128 tokens and a decode step on the rank's heads with their
   launches counted, and the reduced float32 step against the one-rank CPU
   step (1e-4; the hybrid 2e-4).  (b) SmolLM-360M uncut under
   ``strategy="fsdp"`` on (data 2, model 1), 3 steps of 4 x 1024: each
   layer's shards gathered inside it (twice a step with remat, counted),
   launches, p50, peak, shares, and the reduced float32 gate under the same
   layout.  (c) Sharded offload units on (data 2): configuration 3's
   forward without its host check under ``tech-gf`` with its tokens split
   by batch and by sequence, against the one-rank unsharded compile on the
   card (2e-3/2e-4), crossings, conversion builds, compiles, GRT hits and
   coverage equal, ms per call sharded and unsharded, the redistributions
   per op; configuration 1's decode LM through a ``DecodeScheduler`` on a
   sharded plan, its tokens and report equal to the unsharded scheduler's.
22. Sequence-parallel decode at a global batch of 1 (configuration 14; run
   right after phase 21).  (a) Row 2's log-sum-exp output
   (``return_lse``) on both bodies against the plain version at the dense
   and hybrid step shapes and at the sequence-parallel shape, q (1,32,1,80)
   float32 against one rank's (1,32,262144,80) bf16 slice at positions
   from none visible to past the slice (o unchanged by asking for it, the
   lse within 2e-5 of its magnitude, -inf where nothing is visible); its
   time with and without lse in two runs each, the plain version, ``sdpa``
   and the 0.801 ms bound.  (b) Zamba2-2.7B uncut (54 layers, 9
   shared-attention applications) at ``long_500k``, computing in float32:
   two ranks share the card through gloo on (data 2, model 1), each holding
   half of a bf16 k/v cache of 524,288 positions (each block of 4096 from a
   seed of its own), 8 decode steps from position 524,280 and 8 across the
   ranks' boundary from 262,140, each step from the seeded SSD state and
   conv window (the model at random init is chaotic: see ``SP_TOL``);
   after the ranks exit, the one-rank decode on the same seeded state and
   tokens, and again from the state scaled by one float32 ulp (the
   yardstick, reported).  Gates: every step's logits within 5e-3 of the
   one rank's largest, greedy tokens equal, every ``decode_attention``
   launch ``"split"`` (9 a step).  Step p50 and range, peak a rank, the
   collectives' host share and the card's idle share of two profiled
   steps.  (c) The dry run in a subprocess on this machine's torch:
   SmolLM-360M ``decode_32k`` multi, Qwen2-1.5B ``long_500k`` (skipped
   with the reference's reason), Zamba2-2.7B ``long_500k`` single, Granite
   MoE ``train_4k`` under ``strategy="fsdp"``, and (b)'s own cell on a
   (data 2, model 1) world, whose predicted rank bytes are printed beside
   (b)'s measured peak.
23. The repo's own entry points on the card (configuration 15; run last):
   the five smoke gates of ``repro_torch.bench`` through ``main([])`` at
   their own sizes (``smoke``, ``smoke_serve``, ``smoke_decode`` with its
   card section, ``smoke_cluster`` and ``smoke_trace``, whose workers are
   spawned on the card), each exiting 0 with its rows, wall and launches by
   route (its spawned workers' included) printed; then the five examples of
   ``repro_torch.examples`` at their defaults: ``quickstart``,
   ``serve_mixed`` (rows 3 and 7), ``decode_stream``, ``offload_library``
   (bench scale) and ``train_lm`` at SmolLM-360M uncut, 8 x 256,
   :data:`TRAIN_LM_STEPS` of its 200 steps with asynchronous checkpoints
   (rows 4-7, the loss falling).  Gates: the gates' exit statuses (each
   fails on its own if a kernel of its path was not launched),
   ``smoke_decode``'s card section giving the CPU's tokens with row 1 once
   per kernel step, all on ``"split"``, the examples' counts equal to the
   reference's printed ones, and each example's kernels on their routes.

The last lines are a ``kernels`` JSON line (every row with its
``launches_by_route``; rows 1 and 2 with the old body's ``simt_ms``, their
cluster size and ``ms_by_cluster``, row 2 with its hybrid-step readings
under ``hybrid``; rows 3-6 and 8 with ``cuda_core_ms``, rows 3 and 4
with their float32 route's readings under ``tf32x3``, row 8 with its
float32 gate's routes and its float32 timing under ``float32``; rows 3
and 7 with fig. 7's readings and routes under ``fig7``, phase 16's
routes under ``served`` and the operators' cost per call under
``dispatch``; row 3 with phase 17's eager and loaded routes under
``aot_cluster``; rows 2, 3 and 7 with phase 18's launches by route per
run and their times at its shapes under ``zoo``; rows 4-8 with phase
19's launches by route per run under ``families``, rows 4-6 with their
times at its shapes, row 8 with the SSD VJP's calls and time; rows 4-7
with phase 20's launches by route per rank under ``sharded``; every row
with phase 21's launches by route per rank and part under ``sharded``,
``configuration 13``; row 2 with phase 22's ``lse`` readings and its
sequence-parallel launches by route under ``sequence_parallel``; every
row with phase 23's launches by route per entry point that launched it
under ``entry_points``), the card's name and power limit, and ``{"ok": true, "device": {...}}``.  The script needs the repo's
``src/`` beside it and a CUDA device; without either it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = 2e-5          # float32 kernel tolerance of the reference tests

# the main path's shape: SmolLM-360M widths (src/repro/configs/smollm_360m.py)
D_MODEL, VOCAB, MAX_CTX, PAGE = 960, 49152, 2048, 16
CAPACITY, PROMPT = 8, 128
MAX_NEW = tuple(int(n) for n in np.linspace(16, 64, CAPACITY))

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12         # bf16 tensor cores, dense
H100_TF32X3_FLOPS = 494e12 / 3   # float32 as 3xTF32: the dense TF32 peak over three products
H100_TF32X2_FLOPS = 494e12 / 2   # float32 times a bf16 operand (exact in TF32): two products

KERNEL_SOURCES = ("paged_decode_attention", "rmsnorm", "flash_attention",
                  "decode_attention", "ssm_scan", "flash_attention_bwd")

# the dense path: SmolLM-360M at full size (src/repro_torch/configs/smollm_360m.py)
DENSE_ARCH, DENSE_B, DENSE_PROMPT, DENSE_NEW = "smollm-360m", 8, 512, 32
MIXED_B, MIXED_SEQ = 2, 256
# the hybrid path: Zamba2-2.7B at full width (src/repro_torch/configs/zamba2_2_7b.py):
# 32 heads of 80 in the shared block, SSD with H=80 heads of P=64, N=64, chunk 256
HYBRID_ARCH, HYBRID_B, HYBRID_PROMPT, HYBRID_NEW = "zamba2-2.7b", 8, 1024, 32
HYB_HEADS, HYB_HD, HYB_D = 32, 80, 2560
SSD_H, SSD_P, SSD_N, SSD_Q = 80, 64, 64, 256
GATE_B, GATE_PROMPT, GATE_STEPS = 2, 300, 4     # the hybrid float32 gate
HYB_CACHE = HYBRID_PROMPT + HYBRID_NEW + 1      # 1057 positions
# the training path: SmolLM-360M uncut, 6 steps of 8 x 1024 tokens
TRAIN_ARCH, TRAIN_B, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = "smollm-360m", 8, 1024, 6, 3e-4
# the rest of the zoo at full width (phase 18): 8 prompts of 512 tokens each,
# run: (arch, layers or None for uncut, new tokens)
ZOO_RUNS = {"a": ("granite-moe-1b-a400m", None, 32),
            "b": ("dbrx-132b", 2, 8),            # depth cut 40 -> 2 (264 GB of bf16 weights)
            "c": ("seamless-m4t-large-v2", None, 32),
            "d": ("phi-3-vision-4.2b", None, 32),
            "e": ("xlstm-350m", None, 32)}
ZOO_B, ZOO_PROMPT, ZOO_FRAMES, ZOO_PATCHES = 8, 512, 128, 576
ZOO_GATE_B = 2                                 # the float32 teacher-forcing gates
ZOO_GATE_FRAMES = 128        # != enc_len_for(the gate's cache), 136: the cross caches replaced
# xLSTM at the reference's random init is chaotic: the sLSTM recurrence (rh
# at std 1/sqrt(4) over 256 inputs a head) grows a float32 rounding
# difference about tenfold every 16 tokens, to O(1) by token ~48.  So its
# gate runs at the reference test's length (tests/test_models.py: 16 tokens
# and a step), and the mLSTM's multi-chunk form is held against its own
# step-by-step recurrence over ZOO_PROMPT tokens.
XLSTM_GATE_PROMPT, XLSTM_GATE_STEPS = 16, 1
# the other families trained at full width (phase 19): run: (arch, seq, layers
# or None for uncut); 8 sequences a step, 3 steps, seed 0, bf16 compute, remat
FAM_RUNS = {"a": ("zamba2-2.7b", 1024, None),
            "b": ("granite-moe-1b-a400m", 1024, None),
            "c": ("seamless-m4t-large-v2", 512, None),
            # depth cut 32 -> 16: the functional AdamW holds old and new params
            # and moments at once, 28 B a parameter, 104 GB for 32 layers
            "d": ("phi-3-vision-4.2b", 512, 16),
            # 128 tokens: at the reference's random init the sLSTM's backward
            # overflows beyond ~200 (the reference's own gradient norm at 8 of
            # its layers reads 1.2e7 at 64 tokens, 2.6e13 at 128, inf at 256;
            # the port's at 24: 1.9e8, 1.8e14, 7.9e28, NaN at 512)
            "e": ("xlstm-350m", 128, None)}
FAM_B, FAM_STEPS, FAM_LR = 8, 3, 3e-4
# the training attention shapes phase 19 adds: (B, Hq, Hkv, T, S, d, causal)
FAM_ATTN = {"zamba2": (FAM_B, 32, 32, 1024, 1024, 80, True),          # the shared block
            "phi3": (FAM_B, 32, 32, ZOO_PATCHES + 512, ZOO_PATCHES + 512, 96, True),
            "seamless-enc": (FAM_B, 16, 16, ZOO_FRAMES, ZOO_FRAMES, 64, False),
            "seamless-cross": (FAM_B, 16, 16, 512, ZOO_FRAMES, 64, False),
            "granite": (FAM_B, 16, 8, 1024, 1024, 64, True)}
# the reference's BWD_CASES (tests/test_profiling_and_flash_bwd.py), a short
# last tile at Qwen2's head dim, the train step's attention, and phase 19's:
# (B, Hq, Hkv, T, S, d, causal)
BWD_CASES = [(1, 2, 2, 64, 64, 16, True), (2, 4, 2, 64, 64, 32, True),
             (1, 2, 1, 96, 96, 16, False), (2, 6, 2, 100, 100, 128, True),
             (TRAIN_B, 15, 5, TRAIN_SEQ, TRAIN_SEQ, 64, True), *FAM_ATTN.values()]
# the reference's kernel cases (tests/test_kernels.py) and this path's shapes
ATTN_CASES = [  # (B, Hq, Hkv, T, S, d, causal)
    (1, 2, 2, 128, 128, 32, True), (2, 4, 2, 128, 128, 64, True),
    (1, 8, 2, 64, 64, 16, True), (2, 2, 1, 96, 96, 32, False),
    (1, 2, 2, 256, 256, 128, True),
    (DENSE_B, 15, 5, DENSE_PROMPT, DENSE_PROMPT, 64, True),   # SmolLM-360M prefill
    (DENSE_B, 15, 5, DENSE_PROMPT + 1, DENSE_PROMPT + 1, 64, True),  # its teacher forcing
    (MIXED_B, 15, 5, MIXED_SEQ, MIXED_SEQ, 64, True),         # the mixed path
    (CAPACITY, 1, 1, PROMPT, PROMPT, D_MODEL, True),   # the attn LM's prefill
    (HYBRID_B, HYB_HEADS, HYB_HEADS, HYBRID_PROMPT, HYBRID_PROMPT, HYB_HD, True),  # Zamba2
    (GATE_B, HYB_HEADS, HYB_HEADS, GATE_PROMPT, GATE_PROMPT, HYB_HD, True),  # its gate
    (GATE_B, HYB_HEADS, HYB_HEADS, GATE_PROMPT + GATE_STEPS, GATE_PROMPT + GATE_STEPS,
     HYB_HD, True),                                   # the gate's teacher forcing
    # short last tiles of both bodies, causal with T < S and T > S
    (2, 6, 2, 300, 513, HYB_HD, True), (2, 3, 3, 513, 300, 128, True),
    (1, 4, 4, 300, 300, 16, False),
    # the zoo's prefills (phase 18) and their float32 gates' teacher forcing
    (ZOO_B, 16, 8, ZOO_PROMPT, ZOO_PROMPT, 64, True),               # Granite, group 2
    (ZOO_GATE_B, 16, 8, ZOO_PROMPT + 1, ZOO_PROMPT + 1, 64, True),
    (ZOO_B, 48, 8, ZOO_PROMPT, ZOO_PROMPT, 128, True),              # DBRX, group 6
    (ZOO_B, 16, 16, ZOO_FRAMES, ZOO_FRAMES, 64, False),             # seamless encoder
    (ZOO_B, 16, 16, ZOO_PROMPT, ZOO_PROMPT, 64, True),              # its decoder
    (ZOO_B, 16, 16, ZOO_PROMPT, ZOO_FRAMES, 64, False),             # its cross-attention
    (ZOO_GATE_B, 16, 16, ZOO_PROMPT + 1, ZOO_GATE_FRAMES, 64, False),
    (ZOO_B, 32, 32, ZOO_PATCHES + ZOO_PROMPT, ZOO_PATCHES + ZOO_PROMPT, 96, True),  # phi-3
    (ZOO_GATE_B, 32, 32, ZOO_PATCHES + ZOO_PROMPT + 1, ZOO_PATCHES + ZOO_PROMPT + 1,
     96, True),
]
DECODE_CASES = [  # (B, Hq, Hkv, S, d, pos)
    (1, 2, 2, 256, 32, 255), (2, 4, 1, 512, 64, 300), (1, 8, 2, 128, 16, 64),
    (DENSE_B, 15, 5, DENSE_PROMPT + DENSE_NEW + 1, 64, DENSE_PROMPT + DENSE_NEW // 2),
    (DENSE_B, 15, 5, DENSE_PROMPT + 4, 64, DENSE_PROMPT),     # the float32 copy's step
    (HYBRID_B, HYB_HEADS, HYB_HEADS, HYB_CACHE, HYB_HD, HYBRID_PROMPT + HYBRID_NEW // 2),
    (GATE_B, HYB_HEADS, HYB_HEADS, GATE_PROMPT + GATE_STEPS + 1, HYB_HD,
     GATE_PROMPT + GATE_STEPS - 1),                   # the hybrid gate's last step
]
# the zoo's step shapes with the route each takes: DBRX's group of 6 at
# d = 128 needs more q registers than the split body holds (decode_route)
ZOO_DECODE_CASES = [  # (B, Hq, Hkv, S, d, pos), route
    ((ZOO_B, 16, 8, ZOO_PROMPT + 33, 64, ZOO_PROMPT + 16), "split"),    # Granite
    ((ZOO_B, 48, 8, ZOO_PROMPT + 9, 128, ZOO_PROMPT + 4), "simt"),      # DBRX
    ((ZOO_B, 16, 16, ZOO_PROMPT + 33, 64, ZOO_PROMPT + 16), "split"),   # seamless self
    ((ZOO_B, 16, 16, ZOO_FRAMES, 64, ZOO_FRAMES - 1), "split"),         # its cross
    ((ZOO_B, 32, 32, ZOO_PATCHES + ZOO_PROMPT + 33, 96, ZOO_PATCHES + ZOO_PROMPT + 16),
     "split"),                                                          # phi-3, 384 B rows
    ((ZOO_GATE_B, 16, 8, ZOO_PROMPT + 4, 64, ZOO_PROMPT), "split"),     # the gates' steps
    ((ZOO_GATE_B, 32, 32, ZOO_PATCHES + ZOO_PROMPT + 4, 96, ZOO_PATCHES + ZOO_PROMPT),
     "split"),
]
RMS_SHAPES = [(8, 64), (3, 5, 128), (256, 32),
              (DENSE_B * DENSE_PROMPT, 960), (DENSE_B, 960),
              (DENSE_B, DENSE_PROMPT + 1, 960), (MIXED_B, MIXED_SEQ, 960),
              (HYBRID_B, HYBRID_PROMPT, HYB_D), (HYBRID_B, 1, HYB_D),
              (GATE_B, GATE_PROMPT + GATE_STEPS, HYB_D),
              (TRAIN_B, TRAIN_SEQ, 960),                      # the train step's norms
              (ZOO_B, ZOO_PROMPT, 1024), (ZOO_B, 1, 1024),     # Granite, xLSTM
              (ZOO_GATE_B, ZOO_PROMPT + 1, 1024),
              (ZOO_B, ZOO_PATCHES + ZOO_PROMPT, 3072), (ZOO_B, 1, 3072),   # phi-3
              (ZOO_GATE_B, ZOO_PATCHES + ZOO_PROMPT + 1, 3072)]
# DBRX's d_model 6144: 768 bf16 vectors on vec; 1536 float32 ones exceed the
# body's 1024 (rmsnorm_route), which DBRX never runs (no float32 gate)
ZOO_WIDE_RMS = [(ZOO_B, ZOO_PROMPT, 6144), (ZOO_B, 1, 6144)]
# the reference's SSD cases (tests/test_kernels.py) and the hybrid path's shapes:
# (B, T, H, P, N, chunk)
SSD_CASES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 96, 1, 64, 64, 32),
             (HYBRID_B, HYBRID_PROMPT, SSD_H, SSD_P, SSD_N, SSD_Q),    # Zamba2 prefill
             (GATE_B, GATE_PROMPT, SSD_H, SSD_P, SSD_N, SSD_Q),        # T % 256 != 0
             (GATE_B, GATE_PROMPT + GATE_STEPS, SSD_H, SSD_P, SSD_N, SSD_Q),
             # short last chunks and T below one chunk (tests/test_torch_ssm_scan.py)
             (2, 100, 3, 16, 8, 32), (1, 300, 2, 64, 16, 256), (2, 11, 2, 16, 8, 16)]
# N or P not a multiple of 8: the CUDA-core body ("simt")
SSD_SIMT_CASES = [(2, 64, 2, 12, 8, 16), (1, 100, 3, 16, 12, 32)]
# steps of dt*A from -6 to -216: exp(cs_i - cs_j) overflows float32 within 15
# rows above the diagonal
SSD_OVERFLOW_CASES = [(GATE_B, GATE_PROMPT, SSD_H, SSD_P, SSD_N, SSD_Q),
                      (2, 64, 2, 12, 8, 16)]
SSD_OVERFLOW_A = 300.0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """Fail the run (a check that ``python -O`` cannot strip)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def phase_build(torch) -> None:
    from repro_torch.kernels import build

    log(f"# torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"# card: {card_line()}")
    t0 = time.perf_counter()
    seconds = build.build(KERNEL_SOURCES)
    log(f"# build: {time.perf_counter() - t0:.2f} s wall for "
        f"{len(KERNEL_SOURCES)} source(s): {seconds}")
    for name in KERNEL_SOURCES:
        for fn, regs, stores, loads in ptxas_report(build.build_log(name)):
            log(f"#   {name}: {fn}: {regs} registers, spill stores {stores} B, "
                f"loads {loads} B")
        for line in build.build_log(name).splitlines():
            if "Performance Loss" in line:        # ptxas serialising wgmma
                log(f"#   {name}: {line.split(': ', 1)[-1].strip()}")


def _short_name(mangled: str) -> str:
    """``ns::kernel<args>`` from a mangled kernel name (the forms this
    repo's kernels take: nested names, int, float and bf16 template args)."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled
    parts = []
    while s[:1].isdigit():
        n = re.match(r"\d+", s).group()
        parts.append(s[len(n):len(n) + int(n)])
        s = s[len(n) + int(n):]
    name = "::".join(p for p in parts if not p.startswith("_GLOBAL__N")) or mangled
    m = re.match(r"I((?:Li\d+E|f|13__nv_bfloat16)+)E", s)
    if m:
        args = re.findall(r"Li(\d+)E|(f)|13(__nv_bfloat16)", m.group(1))
        name += "<" + ", ".join(i or ("float" if f else "bf16") for i, f, _ in args) + ">"
    return name


def ptxas_report(text: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) for each entry
    function of an ``nvcc -Xptxas -v`` log."""
    rows, fn, spills = [], None, (0, 0)
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn, spills = _short_name(line.split("'")[1]), (0, 0)
        elif fn and "spill stores" in line:
            spills = tuple(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif fn and re.search(r"Used \d+ registers", line):
            rows.append((fn, int(re.search(r"Used (\d+) registers", line).group(1)), *spills))
            fn = None
    return rows


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def pool_case(ps, lengths, d, layout, npages, seed):
    """(q, kn, vn, k_pages, v_pages, tables, lengths) numpy arrays, with the
    logical pages of all streams mapped onto physical ids by ``layout``."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    need = sum(-(-n // ps) for n in lengths)
    P = max(need * 3, 4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kn, vn = f(B, d), f(B, d), f(B, d)
    kp, vp = f(P, ps, d), f(P, ps, d)
    if layout == "contig":
        ids = list(range(P))
    elif layout == "gaps":
        ids = list(range(0, P, 3)) + [i for i in range(P) if i % 3]
    else:
        ids = list(rng.permutation(P))
    tables = np.zeros((B, npages), np.int32)
    k = 0
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            tables[b, j] = ids[k]
            k += 1
    return q, kn, vn, kp, vp, tables, np.asarray(lengths, np.int32)


def phase_kernel(torch) -> float:
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_kernel as kernel,
        paged_decode_attention_plain as plain,
        PAGED_SPLIT,
        paged_route,
    )

    dev = torch.device("cuda")
    worst = 0.0
    cases = 0

    def run(ps, lengths, d, layout, npages, want_route):
        """One pool case, with and without a fresh row: the route, the plain
        version's values, exact zeros for an empty stream (exactly vn with
        a fresh row), a repeat launch and row b's solo launch bitwise."""
        nonlocal worst, cases
        arrays = pool_case(ps, lengths, d, layout, npages, seed=cases)
        q, kn, vn, kp, vp, tables, lens = (torch.from_numpy(a).to(dev) for a in arrays)
        route = paged_route(d, ps, kp, vp)
        check(route == want_route, f"paged route {route} != {want_route} (d={d} ps={ps})")
        for fresh in (False, True):
            extra = (kn, vn) if fresh else ()
            before = _routes()["paged_decode_attention"]
            got = kernel(q, kp, vp, tables, lens, *extra)
            after = _routes()["paged_decode_attention"]
            check(after == {**before, route: before[route] + 1},
                  f"paged routes {before} -> {after}, want one {route} launch")
            want = plain(q, kp, vp, tables, lens, *extra)
            torch.cuda.synchronize()
            worst = max(worst, (got - want).abs().max().item())
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
            check(torch.equal(kernel(q, kp, vp, tables, lens, *extra), got),
                  f"paged: a repeat launch differs (d={d} ps={ps} {layout})")
            for b, n in enumerate(lengths):
                if n == 0 and fresh:
                    # length 0: the softmax has one entry, out == vn
                    check(torch.equal(got[b], vn[b]), "fresh-only row != vn")
                elif n == 0:
                    check(torch.all(got[b] == 0.0), "empty stream not exact zeros")
                solo = kernel(q[b:b + 1], kp, vp, tables[b:b + 1], lens[b:b + 1],
                              *(t[b:b + 1] for t in extra))
                check(torch.equal(solo[0], got[b]), (
                    f"batched row {b} != solo (d={d} ps={ps} {layout} fresh={fresh})"))
            cases += 1

    npages = 6
    for d in (16, 960):
        for ps in (1, 2, 8, 16):
            # empty, single token, partial tail, full tail, max_context-full
            lengths = (0, 1, 2 * ps + max(ps // 2, 1) if ps > 1 else 3,
                       3 * ps, npages * ps)
            for layout in ("contig", "gaps", "permuted"):
                run(ps, lengths, d, layout, npages, "split")
    # the split's edges at the serving shape (d 960, ps 16, 128-slot tables):
    # lengths on page boundaries, on the boundaries of the cluster's page
    # runs (C, C + 1 and 2C pages: every rank one page, one rank two, every
    # rank two), a full 128-page table, and length 0
    C = PAGED_SPLIT
    edges = (0, 1, PAGE - 1, PAGE, PAGE + 1, (C - 1) * PAGE, C * PAGE, C * PAGE + 1,
             (C + 1) * PAGE, 2 * C * PAGE - 1, 2 * C * PAGE, MAX_CTX - 1, MAX_CTX)
    run(PAGE, edges, D_MODEL, "permuted", MAX_CTX // PAGE, "split")
    # a width that is not a multiple of 4: the CUDA-core body
    run(2, (0, 1, 5, 12), 18, "permuted", npages, "simt")
    torch.cuda.synchronize()
    log(f"# paged kernel vs plain: {cases} cases, max |err| {worst:.3e} (tol {TOL}); "
        f"every launch on paged_route's body (split, C = {C}; d = 18 on simt), "
        f"split edges {edges}, exact zeros, repeat launches and batched==solo "
        f"bitwise: ok")
    return worst


# ---------------------------------------------------------------------------
# phase 3: the main path at real width
# ---------------------------------------------------------------------------

def phase_main(torch) -> dict:
    from repro_torch import mixed, obs
    from repro_torch.models.programs import export_attn_decode_lm
    from repro_torch.serve import (
        DecodeScheduler,
        StateSpec,
        paged_decode_reference,
    )

    t0 = time.perf_counter()
    program = export_attn_decode_lm(vocab=VOCAB, d_model=D_MODEL,
                                    max_context=MAX_CTX, seed=SEED)
    planned = mixed.trace(program).plan("tech-gfp")
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX, page_size=PAGE)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, VOCAB, (PROMPT,), dtype=np.int32)
               for _ in range(CAPACITY)]
    tracer = obs.Tracer()
    log(f"# main path: export+plan {time.perf_counter() - t0:.2f} s; pool "
        f"{spec.pool_pages(CAPACITY)} pages of {PAGE} x {D_MODEL} f32, "
        f"{2 * spec.pool_pages(CAPACITY) * PAGE * D_MODEL * 4 / 1e6:.1f} MB "
        f"for K+V")

    sched = DecodeScheduler(planned, step="decode_step",
                            paged_step="paged_decode_step",
                            capacity=CAPACITY, state=spec, start=False,
                            tracer=tracer)
    with sched:
        t0 = time.perf_counter()
        sched.warm(PROMPT)
        torch.cuda.synchronize()
        log(f"# warm: {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        streams = [sched.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
        _reset_counts()                            # counts of this run only
        t0 = time.perf_counter()
        sched.start()
        outs = [s.result(timeout=900) for s in streams]
        wall = time.perf_counter() - t0
        launches, routes = _counts(), _routes()
    rep = sched.report()
    peak = torch.cuda.max_memory_allocated()

    for out, n in zip(outs, MAX_NEW):
        check(out.shape == (n,) and out.dtype == np.int32, (out.shape, out.dtype))
        check(np.all((0 <= out) & (out < VOCAB)), "token out of range")
    pstep = sched.paged_step_planned.compile()
    shortest, longest = int(np.argmin(MAX_NEW)), int(np.argmax(MAX_NEW))
    ref = paged_decode_reference(sched.prefill, pstep, prompts[shortest],
                                 MAX_NEW[shortest], capacity=CAPACITY, state=spec)
    check(np.array_equal(ref, outs[shortest]),
          f"shortest stream differs from its solo paged reference:\n"
          f"{outs[shortest]}\n{ref}")
    # the longest stream's solo run doubles as the profiled window: the same
    # padded step shape as serving, one stream live
    ref = profile_steps(torch, lambda: paged_decode_reference(
        sched.prefill, pstep, prompts[longest], MAX_NEW[longest],
        capacity=CAPACITY, state=spec), MAX_NEW[longest] - 1)
    check(np.array_equal(ref, outs[longest]),
          f"longest stream differs from its solo paged reference:\n"
          f"{outs[longest]}\n{ref}")
    check(rep.kernel_steps == rep.steps > 0, (rep.kernel_steps, rep.steps))
    check(launches["paged_decode_attention"] >= rep.kernel_steps,
          (launches, rep.kernel_steps))
    # the prefill's sdpa op runs the flash kernel, once per batched prefill
    check(launches["flash_attention"] == rep.prefills > 0, (launches, rep.prefills))
    # d = 960 in float32: the CUDA-core body
    check_routes(routes, "flash_attention", "attn-LM prefill (f32, d = 960)",
                 tf32x3=rep.prefills)
    check(launches["rmsnorm"] == launches["decode_attention"] == launches["ssd_scan"] == 0,
          launches)
    check_routes(routes, "paged_decode_attention", "paged steps (f32, d = 960, ps 16)",
                 split=launches["paged_decode_attention"])
    walk = rep.kernel_steps * CAPACITY * spec.pages_per_stream
    check(rep.pages_visited + rep.pages_skipped == walk, rep.table())
    check(0 < rep.pages_visited, rep.table())
    check(rep.pages_in_use == 0 and rep.page_allocs == rep.page_frees > 0, rep.table())
    check(sched._paged.pool.refs_outstanding == 0, "leaked page refcounts")

    steps = [s.dur_ns for s in tracer.snapshot() if s.kind == obs.STEP]
    step_p50 = float(np.median(steps)) / 1e6
    log(f"# main path: {rep.tokens} tokens in {wall:.3f} s = "
        f"{rep.tokens / wall:.1f} tokens/s; {rep.steps} steps, step p50 "
        f"{step_p50:.3f} ms; crossings {rep.crossings}, tokens/crossing "
        f"{rep.tokens_per_crossing:.4f}; kernel launches {launches} "
        f"(kernel_steps {rep.kernel_steps}, prefills {rep.prefills}); pages "
        f"visited {rep.pages_visited} of {walk}; max_memory_allocated "
        f"{peak / 2**20:.1f} MiB")
    prefill_routes(torch, sched.prefill, np.stack(prompts))
    saved = _snapshot()
    profile_steps(torch, lambda: sched.prefill(np.stack(prompts)), 1,
                  "attn-LM batched prefill (8 x 128 tokens, sdpa q (8,1,128,960) f32)")
    _restore(saved)                       # the profiled prefill is not the path's run
    pools = [sched._paged.backing(k) for k in sorted(spec.growing)]
    return {"launches": launches["paged_decode_attention"], "pools": pools,
            "lengths": [PROMPT + n // 2 for n in MAX_NEW],
            "flash_routes": routes["flash_attention"],
            "routes": routes["paged_decode_attention"]}


PREFILL_REPS = 10


def prefill_routes(torch, prefill, prompts) -> None:
    """The attn LM's batched prefill (8 x 128 tokens) on the host clock,
    with its ``sdpa`` op on the flash kernel (as shipped) and with the
    kernel's plain version in its place (plain PyTorch, the route the op
    took before the kernel existed), interleaved; medians of
    ``PREFILL_REPS`` calls each.  Launches made here are not the path's."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain

    def plain(q, k, v, *, causal=True, scale=None):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)

    saved, shipped = _snapshot(), ops.flash_attention
    times = {"kernel": [], "plain": []}
    logits = {}
    try:
        for i in range(2 + PREFILL_REPS):          # two warm-up rounds
            for route, fn in (("kernel", shipped), ("plain", plain)):
                ops.flash_attention = fn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = prefill(prompts)
                logits[route] = np.asarray(out[0])
                torch.cuda.synchronize()
                if i >= 2:
                    times[route].append((time.perf_counter() - t0) * 1e3)
    finally:
        ops.flash_attention = shipped
        _restore(saved)
    np.testing.assert_allclose(logits["kernel"], logits["plain"], rtol=2e-4, atol=2e-5)
    med = {r: float(np.median(t)) for r, t in times.items()}
    log(f"# attn-LM prefill ({prompts.shape[0]} x {prompts.shape[1]} tokens, "
        f"sdpa q (8,1,128,960) f32): {med['kernel']:.3f} ms with the flash "
        f"kernel, {med['plain']:.3f} ms with its plain version (medians of "
        f"{PREFILL_REPS}, host clock; min {min(times['kernel']):.3f} / "
        f"{min(times['plain']):.3f}); logits agree (2e-4/2e-5)")


COLLECTIVE_RANGES = ("gloo:", "nccl:")   # a process group's ranges around its collectives


def profile_steps(torch, fn, steps: int,
                  label: str = "solo steps + prefill at the serving shape",
                  ranges: tuple = (), into: dict | None = None):
    """Run ``fn`` under the torch profiler and print where the device time
    of its ``steps`` steps goes: device busy time by operation, per step,
    and the device's idle share of the window's wall time.  ``ranges`` names
    ``record_function`` ranges opened inside ``fn``: each one's device time
    (its kernels' and its children's) is printed as a row of its own.  The
    ranges a process group opens around its collectives (``gloo:*``,
    ``nccl:*``) are not busy time either.  ``into`` receives the window's
    ``wall_ms``, ``busy_ms`` and ``idle``, and from the same trace
    ``coll_host_ms``, the host time inside the process group's own
    collective ranges (None where the trace holds none), and
    ``coll_device_ms``, the device time of their copies through pinned host
    buffers (gloo on CUDA tensors) and of NCCL's kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, coll_host_us = [], None
    for ev in prof.key_averages():
        collective = ev.key.startswith(COLLECTIVE_RANGES)
        if collective and ev.device_type == torch.autograd.DeviceType.CPU:
            coll_host_us = (coll_host_us or 0.0) + ev.cpu_time_total
        # device-side events only: a host op's device total repeats the
        # time of the kernels and copies it launched
        if (ev.device_type != torch.autograd.DeviceType.CUDA or ev.key in ranges
                or collective):
            continue          # a range's device-side span is not busy time
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log("# profile: the profiler recorded no device time (not measured)")
        return out
    if into is not None:
        into.update(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms,
                    coll_host_ms=None if coll_host_us is None else coll_host_us / 1e3,
                    coll_device_ms=sum(ms for ms, _, key in rows
                                       if "Pinned" in key or key.startswith("nccl")))
    log(f"# profile of {steps} {label}: "
        f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}; per step, by device time:")
    for ms, count, name in rows[:8]:
        log(f"#   {ms / steps:9.4f} ms/step  {count:5d} calls  {name[:70]}")
    for name in ranges:
        evs = [ev for ev in prof.events() if ev.name == name
               and ev.device_type == torch.autograd.DeviceType.CPU]
        ms = sum(ev.device_time_total for ev in evs) / 1e3
        log(f"#   range {name}: {ms / steps:9.4f} ms/step of device time, "
            f"{len(evs)} calls" if ms > 0 else f"#   range {name}: not measured")
    return out


def l2_flush_buffer(torch):
    """1 GiB to zero before each timed call: it evicts the 50 MB L2."""
    return torch.empty(2**30 // 4, dtype=torch.float32, device="cuda")


TIME_CHUNK = 20                  # reps enqueued behind one spin kernel


def time_ms(torch, fn, reps: int, flush, *, syncs: bool = False,
            chunk: int = TIME_CHUNK) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, L2 flushed before
    each one (the serving step finds the cache cold: the pools were just
    copied in), measured with CUDA events around each call.

    The events must time the device's work, not the host's enqueue of it:
    a call whose Python wrapper takes longer than the device's work would
    otherwise be timed at the wrapper's speed.  So each chunk of reps is
    enqueued behind a spin kernel (``torch.cuda._sleep``) that holds the
    stream until the host has enqueued the whole chunk; if the spin ended
    first, the chunk is discarded and run again behind a spin four times as
    long.  Chunks stay short so the enqueue never blocks on a full launch
    queue (``chunk`` calls; fewer for a function of many launches).  A function that waits for the device itself (``syncs``, such as
    the paged plain version's host loop over the lengths) cannot be queued
    behind a spin: its events then include the host's time between its
    launches, which is what such a function costs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles, total, done = 2 * 10**7, 0.0, 0
    while done < reps:
        n = min(chunk, reps - done)
        if not syncs:
            torch.cuda._sleep(cycles)
        held = torch.cuda.Event()
        held.record()
        pairs = []
        for _ in range(n):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        waited = not syncs and held.query()     # the spin ended before the enqueue
        torch.cuda.synchronize()
        if waited:
            cycles *= 4
            check(cycles < 2**35, "the host never got ahead of a spin kernel "
                  "(does the timed function synchronise?)")
            continue
        total += sum(start.elapsed_time(end) for start, end in pairs)
        done += n
    return total / reps


def phase_timing(torch, main: dict) -> dict:
    """The kernel at the serving step's shape: pools (1024, 16, 960), tables
    (8, 128), each stream at the midpoint of its decode."""
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_kernel as kernel,
        paged_decode_attention_plain as plain,
        PAGED_SPLIT,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    P = CAPACITY * (MAX_CTX // PAGE)
    npages = MAX_CTX // PAGE
    lengths = np.asarray(main["lengths"], np.int32)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)  # noqa: E731
    q, kn, vn = f(CAPACITY, D_MODEL), f(CAPACITY, D_MODEL), f(CAPACITY, D_MODEL)
    kp, vp = f(P, PAGE, D_MODEL), f(P, PAGE, D_MODEL)
    tables = np.zeros((CAPACITY, npages), np.int32)
    perm = rng.permutation(P)
    for b in range(CAPACITY):
        tables[b] = perm[b * npages:(b + 1) * npages]
    tables = torch.from_numpy(tables).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    args = (q, kp, vp, tables, lens, kn, vn)

    got, want = kernel(*args), plain(*args)
    simt, simt_out = _paged_entry(torch, *args)
    simt()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    simt_err = (simt_out - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)

    flush = l2_flush_buffer(torch)
    saved = _snapshot()
    kernel_ms = time_ms(torch, lambda: kernel(*args), 200, flush)
    simt_ms = time_ms(torch, simt, 100, flush)
    by_cluster = {c: time_ms(torch, _paged_entry(torch, *args, nsplit=c)[0], 100, flush)
                  for c in CLUSTER_SIZES}
    plain_ms = time_ms(torch, lambda: plain(*args), 20, flush, syncs=True)
    _restore(saved)                     # timing launches are not the path's

    live_rows = int(lengths.sum())
    live_pages = int(sum(-(-int(n) // PAGE) for n in lengths))
    nbytes = (2 * live_rows * D_MODEL * 4            # live K and V rows
              + 4 * CAPACITY * D_MODEL * 4           # q, kn, vn, out
              + CAPACITY * 4 + live_pages * 4)       # lengths, live table slots
    flops = 4 * (live_rows + CAPACITY) * D_MODEL     # q.k and p.v, fresh row too
    bound_bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_ops_ms = flops / H100_FP32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"

    # the page pools live on the card: the step takes them by reference
    pools = main["pools"]
    pool_mb = sum(p.nbytes for p in pools) / 1e6
    pool_at = sorted({str(getattr(p, "device", "host")) for p in pools})

    cluster = PAGED_SPLIT
    log(f"# paged kernel at the step shape (B={CAPACITY}, d={D_MODEL}, ps={PAGE}, "
        f"npages={npages}, lengths={lengths.tolist()}): {kernel_ms:.4f} ms [split, "
        f"cluster of {cluster}], old CUDA-core body {simt_ms:.4f} ms (|err| "
        f"{simt_err:.3e}), split body by cluster size "
        + ", ".join(f"{c}: {ms:.4f}" for c, ms in by_cluster.items())
        + f"; bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.3f} MB, "
        f"{flops / 1e6:.2f} MFLOP), plain version {plain_ms:.4f} ms, "
        f"|err| {err:.3e}; no single PyTorch call computes paged decode "
        f"attention over a block table, so library_ms is null")
    log(f"# page pools ({pool_mb:.1f} MB) on {', '.join(pool_at)}, passed to the "
        f"step by reference")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "simt_ms": simt_ms,
            "ms_by_cluster": by_cluster, "cluster": cluster}


# ---------------------------------------------------------------------------
# phase 4: small input against the CPU run and BENCH_serve.json
# ---------------------------------------------------------------------------

def phase_small(torch) -> None:
    from repro_torch import mixed
    from repro_torch.models.programs import export_attn_decode_lm
    from repro_torch.serve import DecodeScheduler, StateSpec

    vocab, dm, max_ctx, ps, prompt_len = 32, 16, 24, 4, 6
    lens = (6, 8, 10, 12)
    planned = mixed.trace(export_attn_decode_lm(
        vocab=vocab, d_model=dm, max_context=max_ctx)).plan("tech-gfp")
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=max_ctx, page_size=ps)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, (prompt_len,), dtype=np.int32)
               for _ in range(len(lens))]

    def run(backend):
        with DecodeScheduler(planned, step="decode_step",
                             paged_step="paged_decode_step",
                             capacity=len(lens), state=spec, start=False,
                             backend=backend) as sched:
            sched.warm(prompt_len)
            streams = [sched.submit(p, n) for p, n in zip(prompts, lens)]
            sched.start()
            outs = [s.result(timeout=120) for s in streams]
        return outs, sched.report()

    gpu, rep = run(None)
    cpu, _ = run("cpu")
    for a, b in zip(gpu, cpu):
        check(np.array_equal(a, b), f"card tokens {a} != CPU tokens {b}")
    want = json.loads((ROOT / "BENCH_serve.json").read_text())["decode_paged_kernel"]
    got = {"pages_visited": rep.pages_visited, "pages_skipped": rep.pages_skipped,
           "kernel_steps": rep.kernel_steps, "tokens": rep.tokens,
           "tokens_per_crossing": rep.tokens_per_crossing}
    for k, v in got.items():
        check(v == want[k], f"{k}: {v} on the card, {want[k]} recorded")
    check(rep.pages_in_use == 0 and rep.page_allocs == rep.page_frees,
          "pages leaked by the small run")
    log(f"# small input: card tokens == CPU tokens; counters == "
        f"BENCH_serve.json decode_paged_kernel {got}")

    # the serving sections on the card: MixedServer, the prefix-sharing
    # burst, the two-worker cluster booted from an AOT cache (two spawned
    # worker processes on the card) and the traced cluster run
    from repro_torch.bench import serve_sections

    walls = {}
    got = {}
    for name in serve_sections.SECTIONS:
        t0 = time.perf_counter()
        got.update(serve_sections.sections(None, [name]))
        walls[name] = round(time.perf_counter() - t0, 2)
    bad = serve_sections.mismatches(got)
    check(not bad, "serving sections against BENCH_serve.json:\n" + "\n".join(bad))
    for name in serve_sections.SECTIONS:
        log(f"# small input: {name} on the card == BENCH_serve.json "
            f"({len(got[name])} fields, {walls[name]} s): {json.dumps(got[name], sort_keys=True)}")


# ---------------------------------------------------------------------------
# phase 5: the dense kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(torch, shape, dtype, seed, dev):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


def phase_dense_kernels(torch) -> dict:
    from repro_torch.core.opset import REGISTRY
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.decode_attention import (
        DECODE_SPLIT, SPLIT_KEYS, decode_attention_kernel, decode_attention_plain, decode_route)
    from repro_torch.kernels.flash_attention import (
        flash_attention_kernel, flash_attention_plain, flash_route)
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain, rmsnorm_route

    dev = torch.device("cuda")
    worst = {"flash_attention": 0.0, "flash_attention_fwd_stats": 0.0,
             "decode_attention": 0.0, "rmsnorm": 0.0}
    cases = 0

    def routed(name, route, fn):
        """``fn()``, failing unless it made exactly one launch of ``name``,
        on ``route``."""
        before = _routes()[name]
        out = fn()
        after = _routes()[name]
        check(after == {**before, route: before[route] + 1},
              f"{name}: routes {before} -> {after}, want one {route} launch")
        return out

    def compare(name, got, want, dtype, f32_tol):
        nonlocal cases
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else f32_tol
        err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
        if dtype == torch.float32:
            worst[name] = max(worst[name], err)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        cases += 1

    for dtype in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, T, S, d, causal in ATTN_CASES:
            q = _randn(torch, (B, Hq, T, d), dtype, 0, dev)
            k = _randn(torch, (B, Hkv, S, d), dtype, 1, dev)
            v = _randn(torch, (B, Hkv, S, d), dtype, 2, dev)
            route = flash_route(dtype, d)
            got = routed("flash_attention", route,
                         lambda: flash_attention_kernel(q, k, v, causal=causal))
            compare("flash_attention", got, flash_attention_plain(q, k, v, causal=causal),
                    dtype, TOL)
            if d <= fab.MAX_HEAD_DIM:
                # the forward with statistics on the same inputs: o, m and l
                stats = routed("flash_attention_fwd_stats", route,
                               lambda: fab.flash_attention_fwd_stats_kernel(
                                   q, k, v, causal=causal))
                want = fab.flash_attention_fwd_stats_plain(q, k, v, causal=causal)
                for g, w in zip(stats, want):
                    compare("flash_attention_fwd_stats", g, w, dtype, 2e-4)
                if route in ("wgmma", "tf32x3"):     # one body: the same o
                    check(torch.equal(stats[0], got), "fwd_stats o != flash o")
            for b in range(B):
                solo = flash_attention_kernel(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                              causal=causal)
                check(torch.equal(solo[0], got[b]),
                      f"flash: batched row {b} != solo {(B, Hq, Hkv, T, S, d, dtype)}")
            # the model's (B, T, H, d) projections, passed as transposed views
            tv = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
            check(torch.equal(flash_attention_kernel(*tv, causal=causal), got),
                  "flash: strided views differ from contiguous inputs")
            check(torch.equal(flash_attention_kernel(q, k, tv[2], causal=causal), got),
                  "flash: v with other strides than k differs")
        for qd, kd in ((dtype, dtype), (torch.bfloat16, torch.float32)):
            for (B, Hq, Hkv, S, d, pos), want in ([(c, "split") for c in DECODE_CASES]
                                                  + ZOO_DECODE_CASES):
                q = _randn(torch, (B, Hq, 1, d), qd, 3, dev)
                ck = _randn(torch, (B, S, Hkv, d), kd, 4, dev)   # the model's layout
                cv = _randn(torch, (B, S, Hkv, d), kd, 5, dev)
                kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
                route = decode_route(kd, d, Hq // Hkv, kt, vt)
                check(route == want, f"decode route {route} != {want} at "
                      f"{(B, Hq, Hkv, S, d, kd)}")
                for p in (pos, -1):
                    pt = torch.tensor([p], dtype=torch.int32, device=dev)
                    args = (q, kt, vt, pt)
                    got = routed("decode_attention", route,
                                 lambda: decode_attention_kernel(*args))
                    compare("decode_attention", got, decode_attention_plain(*args),
                            torch.bfloat16 if torch.bfloat16 in (qd, kd) else qd, TOL)
                    if p < 0:
                        check(torch.all(got == 0.0), "decode: pos < 0 not exact zeros")
        # every shape of the paths on the vec body; an odd D and an offset
        # view (one element past a 16-byte boundary) on the scalar one
        wide = "vec" if dtype == torch.bfloat16 else "scalar"
        for shape, offset, route in ([(shape, False, "vec") for shape in RMS_SHAPES]
                                     + [(shape, False, wide) for shape in ZOO_WIDE_RMS]
                                     + [((7, 963), False, "scalar"),
                                        ((4, 960), True, "scalar")]):
            x = _randn(torch, shape, dtype, 6, dev)
            if offset:
                x = torch.zeros(1 + x.numel(), dtype=dtype, device=dev)[1:].view(
                    *shape).copy_(x)
            w = _randn(torch, shape[-1:], torch.float32, 7, dev)
            check(rmsnorm_route(x, w) == route, (shape, offset, rmsnorm_route(x, w)))
            got = routed("rmsnorm", route, lambda: rmsnorm_kernel(x, w))
            compare("rmsnorm", got, rmsnorm_plain(x, w), dtype, 1e-5)
            rows = x.reshape(-1, shape[-1])
            check(torch.equal(rmsnorm_kernel(rows[-1:].contiguous(), w)[0],
                              got.reshape(-1, shape[-1])[-1]),
                  f"rmsnorm: batched last row != solo {shape}")

    # flash-decode's split edges at the dense and hybrid step shapes: one key
    # (fewer tiles than ranks), the first tile's edges, the edges of the
    # ranks' tile runs, pos >= S - 1; a repeat launch and row b's solo
    # launch bitwise; a head dim whose rows are no 16-byte multiple on simt
    edge_cases = 0
    for (B, Hq, Hkv, S, d), qd in (((DENSE_B, 15, 5, DENSE_PROMPT + DENSE_NEW + 1, 64),
                                    torch.bfloat16),
                                   ((HYBRID_B, HYB_HEADS, HYB_HEADS, HYB_CACHE, HYB_HD),
                                    torch.float32)):
        C = DECODE_SPLIT
        tiles = -(-S // SPLIT_KEYS)
        ranks = {SPLIT_KEYS * (r * tiles // C) for r in range(1, C)}
        positions = sorted({0, SPLIT_KEYS - 2, SPLIT_KEYS - 1, SPLIT_KEYS,
                            *(n + dn for n in ranks for dn in (-2, -1, 0)),
                            S - 2, S - 1, S + 3})
        q = _randn(torch, (B, Hq, 1, d), qd, 24, dev)
        kt = _randn(torch, (B, S, Hkv, d), torch.float32, 25, dev).transpose(1, 2)
        vt = _randn(torch, (B, S, Hkv, d), torch.float32, 26, dev).transpose(1, 2)
        for p in positions:
            pt = torch.tensor([p], dtype=torch.int32, device=dev)
            got = routed("decode_attention", "split",
                         lambda: decode_attention_kernel(q, kt, vt, pt))
            compare("decode_attention", got, decode_attention_plain(q, kt, vt, pt), qd, TOL)
            check(torch.equal(decode_attention_kernel(q, kt, vt, pt), got),
                  f"decode: a repeat launch differs (pos {p})")
            for b in range(B):
                solo = decode_attention_kernel(q[b:b + 1], kt[b:b + 1], vt[b:b + 1], pt)
                check(torch.equal(solo[0], got[b]),
                      f"decode: batched row {b} != solo {(B, Hq, Hkv, S, d)} pos {p}")
            edge_cases += 1
    q = _randn(torch, (2, 4, 1, 18), torch.float32, 27, dev)
    kt = _randn(torch, (2, 100, 2, 18), torch.float32, 28, dev).transpose(1, 2)
    vt = _randn(torch, (2, 100, 2, 18), torch.float32, 29, dev).transpose(1, 2)
    pt = torch.tensor([60], dtype=torch.int32, device=dev)
    check(decode_route(torch.float32, 18, 2, kt, vt) == "simt", "decode: d = 18 not on simt")
    got = routed("decode_attention", "simt", lambda: decode_attention_kernel(q, kt, vt, pt))
    compare("decode_attention", got, decode_attention_plain(q, kt, vt, pt), torch.float32, TOL)

    sdpa = REGISTRY["sdpa"].torch_fn
    q = _randn(torch, (1, 2, 4, 16), torch.float32, 8, dev)
    k = _randn(torch, (1, 2, 6, 16), torch.float32, 9, dev)
    try:
        sdpa({"causal": True}, q, k, k)
    except ValueError as exc:
        check("T=4 != S=6" in str(exc), f"unexpected refusal: {exc}")
    else:
        check(False, "a causal sdpa with T != S ran on the card")
    sdpa({"causal": False}, q, k, k)               # non-causal T != S is fine
    torch.cuda.synchronize()
    log(f"# dense kernels vs plain: {cases} cases, max |err| in float32 "
        f"{worst}; flash and forward-with-statistics launches on the route "
        f"flash_route gives (bf16 at d % 16 == 0: wgmma; f32 at d % 8 == 0: tf32x3), "
        f"RMSNorm on vec at every path shape and on scalar at odd D and an offset "
        f"view, pos<0 exact zeros, flash and RMSNorm batched==solo bitwise, strided "
        f"views, causal sdpa T!=S refused; flash-decode on split at every path shape "
        f"and on simt at d = 18, {edge_cases} split-edge positions with repeat and "
        f"batched==solo bitwise: ok")
    return worst


# ---------------------------------------------------------------------------
# phase 6: the dense standard path at full size
# ---------------------------------------------------------------------------

def _launch_counts():
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.decode_attention import (
        decode_attention_kernel, paged_decode_attention_kernel)
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel
    from repro_torch.kernels.ssm_scan import ssd_scan_kernel
    return {"rmsnorm": rmsnorm_kernel, "flash_attention": flash_attention_kernel,
            "decode_attention": decode_attention_kernel,
            "paged_decode_attention": paged_decode_attention_kernel,
            "ssd_scan": ssd_scan_kernel,
            "flash_attention_fwd_stats": fab.flash_attention_fwd_stats_kernel,
            "flash_attention_dq": fab.flash_attention_dq_kernel,
            "flash_attention_dkv": fab.flash_attention_dkv_kernel}


# the serving paths launch none of the training kernels
NO_TRAIN_LAUNCHES = {"flash_attention_fwd_stats": 0, "flash_attention_dq": 0,
                     "flash_attention_dkv": 0}


# every wrapper also counts its launches per body (``launches_by_route``):
# the flash attention ones "wgmma" (the bf16 tensor-core body), "tf32x3"
# (the float32 one), "simt" (the CUDA-core one); RMSNorm "vec", "scalar";
# the SSD scan "mma" (the tensor-core body), "simt"; the two decode kernels
# "split" (the cache split over a thread-block cluster), "simt"
ROUTED = ("flash_attention", "flash_attention_fwd_stats", "flash_attention_dq",
          "flash_attention_dkv", "rmsnorm", "ssd_scan", "decode_attention",
          "paged_decode_attention")


def _reset_counts():
    for fn in _launch_counts().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def _counts() -> dict:
    return {name: fn.launches for name, fn in _launch_counts().items()}


def _routes() -> dict:
    fns = _launch_counts()
    return {name: dict(fns[name].launches_by_route) for name in ROUTED}


def _snapshot():
    """The launch counts and route counts, to be put back by :func:`_restore`
    after launches that are not a path's (timing, comparisons)."""
    return _counts(), _routes()


def _restore(saved) -> None:
    counts, routes = saved
    fns = _launch_counts()
    for name, n in counts.items():
        fns[name].launches = n
    for name, r in routes.items():
        fns[name].launches_by_route = dict(r)


def check_routes(routes: dict, name: str, what: str, **want) -> None:
    """Fail unless ``name``'s launches went to each route as many times as
    ``want`` says (routes it does not name: none)."""
    want = {r: want.get(r, 0) for r in routes[name]}
    check(routes[name] == want, f"{what}: {name} routes {routes[name]} != {want}")


def phase_dense_standard(torch) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import api

    dev = torch.device("cuda")
    cfg = get_config(DENSE_ARCH)
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(SEED), tp=1, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _tensors(params))
    log(f"# dense path: {cfg.name} ({L} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}q/{cfg.n_kv_heads}kv heads, vocab {cfg.vocab}, "
        f"{cfg.compute_dtype} compute), {nparams / 1e6:.1f} M params "
        f"({nparams * 4 / 1e9:.2f} GB f32), init {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 3)
    prompt = rng.integers(0, cfg.vocab, (DENSE_B, DENSE_PROMPT), dtype=np.int32)
    greedy_generate(cfg, params, prompt[:, :16], steps=2, tp=1)     # warm-up
    torch.cuda.synchronize()

    # the main path, counted: greedy_generate as a user calls it
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    tokens = greedy_generate(cfg, params, prompt, steps=DENSE_NEW, tp=1)
    wall = time.perf_counter() - t0
    launches, routes = _counts(), _routes()
    peak = torch.cuda.max_memory_allocated()
    check(tokens.shape == (DENSE_B, DENSE_NEW + 1) and tokens.dtype == np.int32,
          (tokens.shape, tokens.dtype))
    check(np.all((0 <= tokens) & (tokens < cfg.vocab)), "token out of range")
    want = {"rmsnorm": (2 * L + 1) * (DENSE_NEW + 1), "flash_attention": L,
            "decode_attention": L * DENSE_NEW, "paged_decode_attention": 0, "ssd_scan": 0,
            **NO_TRAIN_LAUNCHES}
    check(launches == want, f"launches {launches} != {want}")
    check_routes(routes, "flash_attention", "dense prefill (bf16, d = 64)", wgmma=L)
    check_routes(routes, "rmsnorm", "dense serving (bf16, D = 960)", vec=want["rmsnorm"])
    check_routes(routes, "decode_attention", "dense decode (bf16 q, f32 cache, d = 64)",
                 split=want["decode_attention"])

    # the same steps timed one by one, with their launch counts
    cache = api.init_cache(cfg, DENSE_B, DENSE_PROMPT + DENSE_NEW + 1, tp=1, device=dev)
    prefill, decode = make_prefill_step(cfg, tp=1), make_decode_step(cfg, tp=1)
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": torch.as_tensor(prompt, device=dev)}, cache)
    tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    delta = {k: v - before[k] for k, v in _counts().items()}
    check(delta == {"rmsnorm": 2 * L + 1, "flash_attention": L, "decode_attention": 0,
                    "paged_decode_attention": 0, "ssd_scan": 0, **NO_TRAIN_LAUNCHES},
          f"prefill launches {delta}")
    step_ms, out = [], [tok]
    for _ in range(DENSE_NEW):
        before = _counts()
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, {"token": tok})
        tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        delta = {k: v - before[k] for k, v in _counts().items()}
        check(delta == {"rmsnorm": 2 * L + 1, "flash_attention": 0, "decode_attention": L,
                        "paged_decode_attention": 0, "ssd_scan": 0, **NO_TRAIN_LAUNCHES},
              f"decode-step launches {delta}")
        out.append(tok)
    timed = torch.cat(out, dim=1).cpu().numpy()
    check(np.array_equal(timed, tokens), "timed steps' tokens != greedy_generate's")
    p50 = float(np.median(step_ms))
    log(f"# dense standard path: {DENSE_B} x {DENSE_PROMPT}-token prompts, "
        f"{DENSE_NEW} new tokens each: greedy_generate {wall * 1e3:.1f} ms = "
        f"{DENSE_B * (DENSE_NEW + 1) / wall:.1f} tokens/s; prefill {prefill_ms:.2f} ms, "
        f"decode step p50 {p50:.3f} ms (min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}) = {DENSE_B / p50 * 1e3:.1f} tokens/s in decode; "
        f"launches {launches}, flash by route {routes['flash_attention']}; "
        f"max_memory_allocated {peak / 2**20:.1f} MiB; "
        f"KV cache {cache['k'].numel() * 8 / 1e6:.1f} MB f32")

    # where the time goes: one prefill, then 8 decode steps
    cache = api.init_cache(cfg, DENSE_B, DENSE_PROMPT + DENSE_NEW + 1, tp=1, device=dev)
    toks = torch.as_tensor(prompt, device=dev)
    profile_steps(torch, lambda: prefill(params, {"tokens": toks}, cache), 1,
                  "dense prefill (8 x 512 tokens, 32 layers)")
    n = min(8, DENSE_NEW)
    profile_steps(torch, lambda: [decode(params, cache, {"token": tok}) for _ in range(n)],
                  n, f"dense decode steps (batch {DENSE_B}, cache {DENSE_PROMPT}.."
                  f"{DENSE_PROMPT + n})")

    # the reference's serving contract at full size: prefill + one decode
    # step equal the teacher-forcing logits (tests/test_models.py, 5e-3)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    full = api.logits(cfg32, params, {"tokens": timed_prompt(prompt, timed)}, tp=1)[:, -1]
    cache = api.init_cache(cfg32, DENSE_B, DENSE_PROMPT + 4, tp=1, device=dev)
    _, cache = api.prefill(cfg32, params, {"tokens": prompt}, cache, tp=1)
    got, _ = api.decode(cfg32, params, cache, {"token": timed[:, :1]}, tp=1)
    err = (got[:, 0] - full).abs().max().item()
    torch.testing.assert_close(got[:, 0], full, rtol=5e-3, atol=5e-3)
    log(f"# dense float32 copy: prefill + decode == teacher forcing, max |err| "
        f"{err:.3e} (tol 5e-3)")
    return {"launches": launches, "routes": routes, "params": params, "cfg": cfg}


def timed_prompt(prompt, tokens):
    """The prompt followed by the first generated token: (B, T + 1)."""
    return np.concatenate([prompt, tokens[:, :1]], axis=1)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _tensors(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, list)):
            yield from _tensors(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# phase 7: the dense mixed path at full size
# ---------------------------------------------------------------------------

def phase_dense_mixed(torch, dense: dict) -> dict:
    import dataclasses

    from repro_torch import mixed
    from repro_torch.core import NativeInfeasibleError
    from repro_torch.models import api
    from repro_torch.models.programs import export_dense_forward

    cfg32 = dataclasses.replace(dense["cfg"], compute_dtype="float32")
    params = dense["params"]
    t0 = time.perf_counter()
    prog, (tokens,) = export_dense_forward(cfg32, params, batch=MIXED_B, seq=MIXED_SEQ,
                                           with_host_check=True, tp=1)
    traced = mixed.trace(prog)
    try:
        traced.plan("native")
    except NativeInfeasibleError:
        pass
    else:
        check(False, "native planned despite the host check")
    hybrid = traced.plan("tech-gfp").compile()
    log(f"# dense mixed path: export + trace + plan {time.perf_counter() - t0:.2f} s "
        f"({len(prog.functions)} functions, {len(prog.constants)} constants)")
    _reset_counts()
    t0 = time.perf_counter()
    (logits, mx), rep = hybrid.call_reported(tokens)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches, routes = _counts(), _routes()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        hybrid(tokens)
        walls.append((time.perf_counter() - t0) * 1e3)
    want = api.logits(cfg32, params, {"tokens": tokens}, tp=1).cpu().numpy()
    err = float(np.abs(logits - want).max())
    np.testing.assert_allclose(logits, want, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(mx, want.max(axis=2), rtol=2e-3, atol=2e-4)
    # the same model on a CPU copy of the weights runs the kernels' plain
    # versions: a check of the card's result that no kernel takes part in
    t0 = time.perf_counter()
    on_cpu = api.logits(cfg32, _tree_map(lambda t: t.cpu(), params),
                        {"tokens": tokens}, tp=1).numpy()
    cpu_s = time.perf_counter() - t0
    err_cpu = float(np.abs(logits - on_cpu).max())
    np.testing.assert_allclose(logits, on_cpu, rtol=2e-3, atol=2e-4)
    L = cfg32.n_layers
    check(launches == {"rmsnorm": 2 * L + 1, "flash_attention": L, "decode_attention": 0,
                       "paged_decode_attention": 0, "ssd_scan": 0, **NO_TRAIN_LAUNCHES},
          f"mixed path launches {launches}")
    check_routes(routes, "flash_attention", "float32 mixed forward (d = 64)", tf32x3=L)
    check_routes(routes, "rmsnorm", "float32 mixed forward (D = 960)", vec=2 * L + 1)
    cov = hybrid.plan_for(tokens).coverage
    log(f"# dense mixed path (tech-gfp, batch {MIXED_B} x {MIXED_SEQ}): logits == "
        f"api.logits, max |err| {err:.3e} (2e-3/2e-4); crossings guest->host "
        f"{rep.guest_to_host}, host->guest {rep.host_to_guest}, conversion builds "
        f"{rep.conversion_builds}, compiles {rep.compiles}; coverage "
        f"{cov.as_dict()}; launches {launches}; first call {first_ms:.1f} ms, "
        f"then {', '.join(f'{w:.1f}' for w in walls)} ms per call")
    log(f"# dense mixed path: steady calls {min(walls):.1f}-{max(walls):.1f} ms "
        f"per call (host clock, {len(walls)} calls)")
    log(f"# dense mixed path == api.logits on a CPU copy of the weights (plain "
        f"versions, {cpu_s:.1f} s): max |err| {err_cpu:.3e} (2e-3/2e-4)")
    saved = _snapshot()
    profile_steps(torch, lambda: hybrid(tokens), 1,
                  f"float32 mixed forward call (tech-gfp, {MIXED_B} x {MIXED_SEQ}, "
                  f"{L} layers)")
    _restore(saved)
    return {"routes": routes}


# ---------------------------------------------------------------------------
# phase 8: the dense kernels' times
# ---------------------------------------------------------------------------

def _bound(nbytes, flops, peak):
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _cuda_core_call(q, k, v, stats: bool, causal: bool = True):
    """A call of the CUDA-core body (``attention_tile.cuh``, which ran every
    bfloat16 launch before the tensor-core body) through its C entry, on
    inputs the wrappers route to the tensor-core body: timed beside it in
    the same run, never on a path.
    Returns (call, outputs)."""
    import ctypes
    import math

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.common import DTYPE_CODES, ptr, stream, stride_array, strides

    B, Hq, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    scale = ctypes.c_float(1.0 / math.sqrt(d))
    o = torch.empty((B, Hq, T, d), dtype=q.dtype, device=q.device)
    m, l = (torch.empty((B, Hq, T), dtype=torch.float32, device=q.device) for _ in "ml")
    code, st = DTYPE_CODES[q.dtype], stream(q.device)
    if stats:
        lib, sa = fab._library(), stride_array(q, k, v)

        def call():
            check(lib.flash_attention_fwd_stats(
                ptr(q), ptr(k), ptr(v), ptr(o), ptr(m), ptr(l), code, B, Hq, Hkv, T, S, d,
                sa, int(causal), scale, st) == 0, "CUDA-core forward with statistics failed")
        return call, (o, m, l)
    lib, ss = fa._library(), [x for t in (q, k, v) for x in strides(t)[:3]]

    def call():
        check(lib.flash_attention_fwd(ptr(q), ptr(k), ptr(v), ptr(o), code, B, Hq, Hkv, T,
                                      S, d, *ss, int(causal), scale, st) == 0,
              "CUDA-core flash forward failed")
    return call, (o,)


CLUSTER_SIZES = (1, 2, 4, 8, 16)     # the split bodies' cluster sizes timed beside the shipped one


def _decode_entry(torch, q, k, v, pos, nsplit=None, lse: bool = False):
    """A call of the dense flash-decode through a C entry, on inputs the
    wrapper takes: the CUDA-core body (``decode_attention_fwd``, the body of
    every launch before the split one) when ``nsplit`` is None, else the
    split body at that cluster size; with ``lse`` it also writes each row's
    log-sum-exp.  Timed beside the wrapper in the same run, never on a
    path.  Returns (call, output), the output (o, lse) with ``lse``."""
    import ctypes
    import math

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.common import DTYPE_CODES, ptr, stream, strides

    B, Hq, _, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, 1, d), dtype=q.dtype, device=q.device)
    rows = torch.empty((B, Hq), dtype=torch.float32, device=q.device) if lse else None
    qs, ks, vs = strides(q), strides(k), strides(v)
    args = [ptr(q), ptr(k), ptr(v), ptr(pos), ptr(out), DTYPE_CODES[q.dtype],
            DTYPE_CODES[k.dtype], B, Hq, Hkv, S, d, *qs[:2], *ks[:3], *vs[:3],
            ctypes.c_float(1.0 / math.sqrt(d))]
    lib, st = da._dense_library(), stream(q.device)
    if nsplit is None:
        def call():
            check(lib.decode_attention_fwd(*args, ptr(rows), st) == 0,
                  "CUDA-core decode failed")
    else:
        def call():
            check(lib.decode_attention_fwd_split(*args, nsplit, ptr(rows), st) == 0,
                  f"split decode at C = {nsplit} failed")
    return call, ((out, rows) if lse else out)


def _paged_entry(torch, q, kp, vp, tables, lens, kn, vn, nsplit=None):
    """A call of the paged decode kernel through a C entry: the CUDA-core
    body (``paged_decode_attention_f32``) when ``nsplit`` is None, else the
    split body at that cluster size (see :func:`_decode_entry`)."""
    import ctypes
    import math

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.common import ptr, stream

    B, d = q.shape
    out = torch.empty_like(q)
    args = [ptr(q), ptr(kn), ptr(vn), ptr(kp), ptr(vp), ptr(tables), ptr(lens), ptr(out), B,
            d, kp.shape[1], tables.shape[1], int(kn is not None),
            ctypes.c_float(1.0 / math.sqrt(d))]
    lib, st = da._library(), stream(q.device)
    if nsplit is None:
        def call():
            check(lib.paged_decode_attention_f32(*args, st) == 0, "CUDA-core paged failed")
    else:
        def call():
            check(lib.paged_decode_attention_split_f32(*args, nsplit, st) == 0,
                  f"split paged at C = {nsplit} failed")
    return call, out


def decode_timing(torch, q, k, v, pos, flush, reps: int, bound, by, work, shape,
                  library) -> dict:
    """Row 2 at one step shape: the wrapper's route, the CUDA-core body
    through its C entry (``simt_ms``), the split body at each of
    :data:`CLUSTER_SIZES` (``ms_by_cluster``), the plain version and one
    ``scaled_dot_product_attention`` call with a ``kpos <= pos`` mask."""
    from repro_torch.kernels.decode_attention import (
        DECODE_SPLIT, decode_attention_kernel, decode_attention_plain, decode_route)

    got = decode_attention_kernel(q, k, v, pos)
    want = decode_attention_plain(q, k, v, pos)
    simt, simt_out = _decode_entry(torch, q, k, v, pos)
    simt()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    simt_err = (simt_out.float() - want.float()).abs().max().item()
    by_cluster = {c: time_ms(torch, _decode_entry(torch, q, k, v, pos, c)[0], reps // 2, flush)
                  for c in CLUSTER_SIZES}
    return dict(
        ms=time_ms(torch, lambda: decode_attention_kernel(q, k, v, pos), reps, flush),
        simt_ms=time_ms(torch, simt, reps // 2, flush),
        plain_ms=time_ms(torch, lambda: decode_attention_plain(q, k, v, pos), reps // 4, flush),
        library_ms=time_ms(torch, library, reps, flush),
        ms_by_cluster=by_cluster, cluster=DECODE_SPLIT,
        route=decode_route(k.dtype, q.shape[-1], q.shape[1] // k.shape[1], k, v),
        bound_ms=bound, bound_by=by, max_abs_err=err, simt_err=simt_err,
        library="sdpa with a kpos <= pos mask", shape=shape, work=work)


def flash_timing(torch, q, k, v, flush, reps: int, *, stats: bool,
                 causal: bool = True) -> dict:
    """Row 3 (``stats`` False: ``flash_attention_kernel``) or row 4
    (``flash_attention_fwd_stats_kernel``) at one shape, causal (T == S) or
    not: the kernel as routed, the CUDA-core body on the same inputs
    (``cuda_core_ms``), the plain version, and
    ``scaled_dot_product_attention``'s forward, beside the bound: q, k, v
    read once, o (and m, l) written once, 4*d flops per visible (query, key)
    pair on the tensor cores (bf16: 989 TFLOP/s; float32 on the
    ``"tf32x3"`` route: the TF32 peak over three)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import (
        flash_attention_kernel, flash_attention_plain, flash_route)

    B, Hq, T, d = q.shape
    S = k.shape[2]
    if stats:
        def kern():
            return fab.flash_attention_fwd_stats_kernel(q, k, v, causal=causal)

        def plain():
            return fab.flash_attention_fwd_stats_plain(q, k, v, causal=causal)
    else:
        def kern():
            return (flash_attention_kernel(q, k, v, causal=causal),)

        def plain():
            return (flash_attention_plain(q, k, v, causal=causal),)
    got, want = kern(), plain()
    core, core_out = _cuda_core_call(q, k, v, stats, causal)
    core()
    torch.cuda.synchronize()
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    core_err = max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(core_out, want))
    nbytes = (q.element_size() * (2 * q.numel() + k.numel() + v.numel())
              + (8 * B * Hq * T if stats else 0))
    flops = 4 * B * Hq * d * (T * (T + 1) // 2 if causal else T * S)
    route = flash_route(q.dtype, d)
    bound, by = _bound(nbytes, flops,
                       H100_TF32X3_FLOPS if route == "tf32x3" else H100_BF16_FLOPS)
    return dict(
        ms=time_ms(torch, kern, reps, flush),
        cuda_core_ms=time_ms(torch, core, max(reps // 5, 3), flush),
        plain_ms=time_ms(torch, plain, max(reps // 5, 3), flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), reps, flush),
        library="sdpa forward", bound_ms=bound, bound_by=by, max_abs_err=err,
        cuda_core_err=core_err, route=route,
        shape=f"q {tuple(q.shape)}, k,v {tuple(k.shape)} {str(q.dtype)[6:]} "
              f"{'causal' if causal else 'unmasked'}",
        work=f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP")


def log_timing(out: dict) -> None:
    for name, r in out.items():
        lib = r.get("library", "library")
        lib_ms = "null (no single PyTorch call computes it)" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        core = (f", CUDA-core body {r['cuda_core_ms']:.4f} ms (|err| "
                f"{r['cuda_core_err']:.3e})") if "cuda_core_ms" in r else ""
        if "simt_ms" in r:
            core = (f" (cluster of {r['cluster']}), old CUDA-core body {r['simt_ms']:.4f} ms "
                    f"(|err| {r['simt_err']:.3e}), split body by cluster size "
                    + ", ".join(f"{c}: {ms:.4f}" for c, ms in r["ms_by_cluster"].items()))
        route = f" [{r['route']}]" if "route" in r else ""
        log(f"# {name}{route} at {r['shape']}: {r['ms']:.4f} ms{core}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['work']}), plain "
            f"{r['plain_ms']:.4f} ms, {lib} {lib_ms}, |err| {r['max_abs_err']:.3e}")


def phase_dense_timing(torch, dense: dict) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain, rmsnorm_route

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    flush = l2_flush_buffer(torch)
    saved = _snapshot()
    out = {}

    # rows 3 and 4: the prefill's attention, (8,15,512,64) against
    # (8,5,512,64), bf16, on the tensor-core body
    B, Hq, Hkv, T, d = DENSE_B, 15, 5, DENSE_PROMPT, 64
    q = _randn(torch, (B, Hq, T, d), bf16, 10, dev)
    k = _randn(torch, (B, Hkv, T, d), bf16, 11, dev)
    v = _randn(torch, (B, Hkv, T, d), bf16, 12, dev)
    out["flash_attention"] = flash_timing(torch, q, k, v, flush, 50, stats=False)
    out["flash_attention_fwd_stats@dense"] = flash_timing(torch, q, k, v, flush, 50,
                                                          stats=True)

    # rows 3 and 4 on the float32 route: the attn LM's prefill
    # (configuration 1), one head of d = 960, q, k, v (8,1,128,960); the mixed
    # forward (configuration 3), (2,15,256,64) against (2,5,256,64)
    qa, ka, va = (_randn(torch, (CAPACITY, 1, PROMPT, D_MODEL), f32, s, dev)
                  for s in (18, 19, 20))
    out["flash_attention@attn-lm"] = flash_timing(torch, qa, ka, va, flush, 50, stats=False)
    qm = _randn(torch, (MIXED_B, Hq, MIXED_SEQ, d), f32, 21, dev)
    km, vm = (_randn(torch, (MIXED_B, Hkv, MIXED_SEQ, d), f32, s, dev) for s in (22, 23))
    out["flash_attention@mixed"] = flash_timing(torch, qm, km, vm, flush, 50, stats=False)
    out["flash_attention_fwd_stats@mixed"] = flash_timing(torch, qm, km, vm, flush, 50,
                                                          stats=True)

    # decode: one step's attention, q (8,15,1,64) bf16 against the model's
    # (8,545,5,64) float32 cache, at the middle step of the 32 (pos 528)
    S, pos = DENSE_PROMPT + DENSE_NEW + 1, DENSE_PROMPT + DENSE_NEW // 2
    q1 = _randn(torch, (B, Hq, 1, d), bf16, 13, dev)
    ck = _randn(torch, (B, S, Hkv, d), f32, 14, dev)
    cv = _randn(torch, (B, S, Hkv, d), f32, 15, dev)
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    pt = torch.tensor([pos], dtype=torch.int32, device=dev)
    visible = pos + 1
    nbytes = 2 * 2 * q1.numel() + 2 * B * Hkv * visible * d * 4 + 4
    flops = 4 * B * Hq * visible * d
    bound, by = _bound(nbytes, flops, H100_FP32_FLOPS)
    mask = (torch.arange(S, device=dev) <= pos)[None, None, None, :]
    q1f = q1.to(f32)
    out["decode_attention"] = decode_timing(
        torch, q1, kt, vt, pt, flush, 200, bound, by,
        f"{nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} MFLOP",
        f"q {tuple(q1.shape)} bf16, cache {tuple(ck.shape)} f32, pos {pos}",
        lambda: F.scaled_dot_product_attention(q1f, kt, vt, attn_mask=mask, enable_gqa=True))

    # rmsnorm: the prefill's rows (4096, 960) bf16; the decode step's (8, 960)
    for rows, key in ((B * DENSE_PROMPT, "rmsnorm"), (B, "rmsnorm@decode")):
        x = _randn(torch, (rows, 960), bf16, 16, dev)
        w = _randn(torch, (960,), f32, 17, dev)
        wb = w.to(bf16)
        err = (rmsnorm_kernel(x, w).float() - rmsnorm_plain(x, w).float()).abs().max().item()
        nbytes = 2 * 2 * x.numel() + 4 * w.numel()
        bound, by = _bound(nbytes, 4 * x.numel(), H100_FP32_FLOPS)
        out[key] = dict(
            ms=time_ms(torch, lambda: rmsnorm_kernel(x, w), 200, flush),
            plain_ms=time_ms(torch, lambda: rmsnorm_plain(x, w), 50, flush),
            library_ms=time_ms(torch, lambda: F.rms_norm(x, (960,), wb, 1e-6), 200, flush),
            bound_ms=bound, bound_by=by, max_abs_err=err, route=rmsnorm_route(x, w),
            library="F.rms_norm", shape=f"x ({rows}, 960) bf16, w f32",
            work=f"{nbytes / 1e6:.3f} MB")

    _restore(saved)                         # timing launches are not the path's
    log_timing(out)
    out["dispatch"] = dispatch_cost(torch)
    return out


DISPATCH_CALLS, DISPATCH_ROUNDS = 200, 6


def dispatch_cost(torch) -> dict:
    """The registered operators' cost per call on the host clock, at
    configuration 3's shapes (RMSNorm over (2, 256, 960) float32 rows, the
    float32 flash forward at (2,15,256,64) against (2,5,256,64)): the time
    to issue ``DISPATCH_CALLS`` calls through ``repro_torch::`` and through
    the direct ``kernels/ops.py`` call, alternating, the median of
    ``DISPATCH_ROUNDS`` rounds each.  The results are bitwise equal."""
    from repro_torch.kernels import library, ops

    dev, f32 = torch.device("cuda"), torch.float32
    saved = _snapshot()
    x = _randn(torch, (MIXED_B, MIXED_SEQ, 960), f32, 70, dev)
    w = _randn(torch, (960,), f32, 71, dev)
    q = _randn(torch, (MIXED_B, 15, MIXED_SEQ, 64), f32, 72, dev)
    k, v = (_randn(torch, (MIXED_B, 5, MIXED_SEQ, 64), f32, s, dev) for s in (73, 74))
    cases = {
        "rmsnorm": (lambda: library.rmsnorm(x, w, 1e-6),
                    lambda: ops.rmsnorm(x, w, eps=1e-6)),
        "flash_attention": (lambda: library.flash_attention(q, k, v, True, None),
                            lambda: ops.flash_attention(q, k, v, causal=True)),
    }
    out = {}
    for name, (via_op, direct) in cases.items():
        check(torch.equal(via_op(), direct()), f"{name}: operator != direct call")
        us = {"op": [], "direct": []}
        for r in range(DISPATCH_ROUNDS):
            order = (("op", via_op), ("direct", direct))
            for label, fn in (order if r % 2 == 0 else order[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter_ns()
                for _ in range(DISPATCH_CALLS):
                    fn()
                t1 = time.perf_counter_ns()
                torch.cuda.synchronize()
                us[label].append((t1 - t0) / DISPATCH_CALLS / 1e3)
        op_us, direct_us = (float(np.median(us[k])) for k in ("op", "direct"))
        out[name] = {"op_us": op_us, "direct_us": direct_us,
                     "dispatch_us": op_us - direct_us,
                     "op_us_range": [min(us["op"]), max(us["op"])],
                     "direct_us_range": [min(us["direct"]), max(us["direct"])]}
        log(f"# dispatch {name} at configuration 3's shape: through repro_torch:: "
            f"{op_us:.2f} us/call (rounds {min(us['op']):.2f}-{max(us['op']):.2f}), "
            f"direct kernels/ops {direct_us:.2f} us/call (rounds "
            f"{min(us['direct']):.2f}-{max(us['direct']):.2f}): the operator costs "
            f"{op_us - direct_us:+.2f} us per call (host clock, {DISPATCH_CALLS} calls "
            f"a round, median of {DISPATCH_ROUNDS}); results bitwise equal")
    _restore(saved)
    return out


# ---------------------------------------------------------------------------
# phase 9: the SSD kernel against its plain version
# ---------------------------------------------------------------------------

def _ssd_inputs(torch, case, dtype, seed, dev, a_scale=1.0):
    """x, dt, A, B, C as in tests/test_kernels.py, on the card; ``a_scale``
    scales A (the overflow cases)."""
    B, T, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = f(rng.standard_normal((B, T, H, P))).to(dtype)
    dt = f(rng.random((B, T, H)) * 0.5 + 0.1)
    A = f((-rng.random(H) - 0.2) * a_scale)
    Bm = f(rng.standard_normal((B, T, N)) * 0.3).to(dtype)
    Cm = f(rng.standard_normal((B, T, N)) * 0.3).to(dtype)
    return x, dt, A, Bm, Cm


def phase_ssd_kernel(torch) -> float:
    """The SSD kernel against its plain version, on both bodies: the
    reference's cases and short last chunks on the tensor-core body
    ("mma"), N or P off 8 on the CUDA-core body ("simt"), the hybrid path's
    shapes, and pairs whose decay overflows above the diagonal (y finite);
    float32 at 2e-4 and bfloat16 at 2e-2, y and the final state (on "mma"
    the bf16 state at 2e-4 too: float32 from inputs exact in TF32); each
    launch on the route ``ssd_route`` gives, whose chunk table equals the
    built body's; row 0 of a batched launch bitwise equal to a solo launch;
    the model's strided (B,T,H,P) view equal to contiguous input.  Returns
    the largest error held to 2e-4."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.common import DTYPE_CODES
    from repro_torch.kernels.ssm_scan import (
        mma_max_chunk, ssd_route, ssd_scan_kernel, ssd_scan_plain)

    dev = torch.device("cuda")
    saved = _snapshot()
    worst, cases = 0.0, 0
    runs = ([(c, 1.0, "mma") for c in SSD_CASES] + [(c, 1.0, "simt") for c in SSD_SIMT_CASES]
            + [(c, SSD_OVERFLOW_A, None) for c in SSD_OVERFLOW_CASES])
    lib = ssm_scan._library()
    for dtype in (torch.float32, torch.bfloat16):
        for N in range(0, 80):               # the route's chunk table is the body's
            check(lib.ssd_scan_mma_max_chunk(DTYPE_CODES[dtype], N)
                  == mma_max_chunk(dtype, N), f"ssd: chunk table differs at {dtype}, N {N}")
    for dtype in (torch.float32, torch.bfloat16):
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        for case, a_scale, want_route in runs:
            chunk = case[5]
            route = ssd_route(dtype, case[4], case[3], chunk)
            check(want_route is None or route == want_route,
                  f"ssd: {case} {dtype} routed {route}, not {want_route}")
            args = _ssd_inputs(torch, case, dtype, 20 + cases, dev, a_scale)
            before = dict(ssd_scan_kernel.launches_by_route)
            y, S = ssd_scan_kernel(*args, chunk=chunk, return_state=True)
            check(ssd_scan_kernel.launches_by_route[route] == before[route] + 1,
                  f"ssd: {case} {dtype} not counted on {route}")
            wy, wS = ssd_scan_plain(*args, chunk=chunk, return_state=True)
            torch.cuda.synchronize()
            # the state is float32 in both dtypes; the tensor-core body
            # computes it from bf16 inputs (exact in TF32) to float32 accuracy
            tol_S = 2e-4 if route == "mma" else tol
            for got, want, t in ((y, wy, tol), (S, wS, tol_S)):
                err = (got.float() - want.float()).abs().max().item()
                if t == 2e-4:
                    worst = max(worst, err)
                torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)
            check(torch.isfinite(y.float()).all().item() and torch.isfinite(S).all().item(),
                  f"ssd: non-finite y or S {case} A x {a_scale}")
            solo, S_solo = ssd_scan_kernel(*(a[:1] if a.dim() > 1 else a for a in args),
                                           chunk=chunk, return_state=True)
            check(torch.equal(solo[0], y[0]) and torch.equal(S_solo[0], S[0]),
                  f"ssd: batched row 0 != solo {case} {dtype}")
            x = args[0]
            Bsz, T, H, P = x.shape
            wide = torch.zeros((Bsz, T, H * P + 8), dtype=dtype, device=dev)
            wide[..., :H * P] = x.reshape(Bsz, T, H * P)
            view = wide[..., :H * P].unflatten(-1, (H, P))
            check(torch.equal(ssd_scan_kernel(view, *args[1:], chunk=chunk), y),
                  f"ssd: strided x differs from contiguous {case}")
            cases += 1
    torch.cuda.synchronize()
    by_route = dict(ssd_scan_kernel.launches_by_route)
    _restore(saved)                         # comparison launches are not a path's
    log(f"# ssd kernel vs plain: {cases} cases (y and final state; "
        f"{2 * len(SSD_OVERFLOW_CASES)} with exp(cs_i - cs_j) = inf above the diagonal), "
        f"max |err| at 2e-4 {worst:.3e} (float32 y and S, bf16 S on mma; bf16 y at "
        f"2e-2); launches by route {by_route}; chunk table == ssd_scan_mma_max_chunk, "
        f"batched row 0 == solo bitwise, strided x, T % chunk != 0, finite y: ok")
    return worst


# ---------------------------------------------------------------------------
# phase 10: decode_multimodel on the card
# ---------------------------------------------------------------------------

def phase_multimodel(torch) -> None:
    """``benchmarks/smoke_decode.py``'s decode_multimodel workload (mamba2 SSM
    + attention LM over one shared page pool) with the units on the card:
    ``BENCH_serve.json``'s counters exactly, every stream's tokens equal to
    its model's solo ``decode_reference`` on the card."""
    from repro_torch import mixed
    from repro_torch.models.programs import export_attn_decode_lm, export_mamba2_decode_lm
    from repro_torch.serve import MultiModelDecodeScheduler, StateSpec, decode_reference

    vocab, dm, max_ctx, prompt_len = 32, 16, 24, 6
    capacity, lens = 3, (5, 6, 7, 8, 9, 10)
    planneds = {
        "attn": mixed.trace(export_attn_decode_lm(
            vocab=vocab, d_model=dm, max_context=max_ctx)).plan("tech-gfp"),
        "mamba2": mixed.trace(export_mamba2_decode_lm(vocab=vocab, d_model=dm)).plan(
            "tech-gfp"),
    }
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=max_ctx, page_size=4)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, vocab, (prompt_len,), dtype=np.int32) for _ in lens]
    t0 = time.perf_counter()
    multi = MultiModelDecodeScheduler(start=False)
    multi.register("attn", planneds["attn"], step="decode_step", capacity=capacity,
                   state=spec)
    multi.register("mamba2", planneds["mamba2"], step="decode_step", capacity=capacity)
    jobs = []
    with multi:
        for i, (p, n) in enumerate(zip(prompts, lens)):
            model = "attn" if i % 2 == 0 else "mamba2"
            jobs.append((model, p, multi.submit(p, n, model=model)))
        multi.start()
        outs = [(m, p, s.result(timeout=300)) for m, p, s in jobs]
    wall = time.perf_counter() - t0
    rep = multi.report()
    oracle = {name: (p.compile(), p.for_entry("decode_step").compile())
              for name, p in planneds.items()}
    violations = sum(
        not np.array_equal(decode_reference(*oracle[m], p, len(t), capacity=capacity), t)
        for m, p, t in outs)
    ssm, attn = rep.models["mamba2"], rep.models["attn"]
    got = {
        "attn_page_allocs": attn.page_allocs,
        "attn_state_bytes_per_crossing": attn.state_bytes_per_crossing,
        "attn_tokens_per_crossing": attn.tokens_per_crossing,
        "bit_identity_violations": violations,
        "models": len(rep.models),
        "pool_in_use_at_close": rep.pool_in_use,
        "pool_pages": rep.pool_pages,
        "pool_peak": rep.pool_peak,
        "pool_refs_outstanding_at_close": rep.pool_refs_outstanding,
        "ssm_page_allocs": ssm.page_allocs,
        "ssm_state_bytes_per_crossing": ssm.state_bytes_per_crossing,
        "ssm_tokens_per_crossing": ssm.tokens_per_crossing,
        "state_bytes_per_crossing": rep.state_bytes_per_crossing,
        "streams": rep.streams,
        "tokens": rep.tokens,
        "tokens_per_crossing": rep.tokens_per_crossing,
    }
    want = json.loads((ROOT / "BENCH_serve.json").read_text())["decode_multimodel"]
    for k, v in want.items():
        check(got[k] == v, f"decode_multimodel {k}: {got[k]} on the card, {v} recorded")
    check(rep.failures == 0, rep.table())
    log(f"# decode_multimodel on the card ({wall:.2f} s): {violations} bit-identity "
        f"violations; ssm_page_allocs {ssm.page_allocs}, attn_page_allocs "
        f"{attn.page_allocs}, pool_peak {rep.pool_peak}, tokens/crossing "
        f"{rep.tokens_per_crossing:.4f}, ssm state bytes/crossing "
        f"{ssm.state_bytes_per_crossing:.1f} == BENCH_serve.json")


# ---------------------------------------------------------------------------
# phase 11: the hybrid standard path at full width
# ---------------------------------------------------------------------------

def _hybrid_launches(L: int, G: int, *, prefills: int, steps: int) -> dict:
    norms = L + 2 * G + 1           # a norm per Mamba2 layer, two per shared block, ln_f
    return {"rmsnorm": norms * (prefills + steps), "flash_attention": G * prefills,
            "decode_attention": G * steps, "paged_decode_attention": 0,
            "ssd_scan": L * prefills, **NO_TRAIN_LAUNCHES}


def phase_hybrid_standard(torch) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import api, mamba2

    dev = torch.device("cuda")
    cfg = get_config(HYBRID_ARCH)
    L, G = cfg.n_layers, mamba2.n_shared_applications(cfg)
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(SEED), tp=1, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _tensors(params))
    log(f"# hybrid path: {cfg.name} ({L} Mamba2 layers, d_model {cfg.d_model}, SSD "
        f"{SSD_H} heads x {SSD_P}, N {cfg.ssm.state_dim}, chunk {cfg.ssm.chunk}; shared "
        f"block x{G}: {cfg.n_heads} heads of {cfg.head_dim_}, d_ff {cfg.d_ff}; vocab "
        f"{cfg.vocab}, {cfg.compute_dtype} compute), {nparams / 1e6:.1f} M params "
        f"({nparams * 4 / 1e9:.2f} GB f32), init {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 4)
    prompt = rng.integers(0, cfg.vocab, (HYBRID_B, HYBRID_PROMPT), dtype=np.int32)
    greedy_generate(cfg, params, prompt[:, :300], steps=2, tp=1)      # warm-up
    torch.cuda.synchronize()

    # the main path, counted: greedy_generate as a user calls it
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    tokens = greedy_generate(cfg, params, prompt, steps=HYBRID_NEW, tp=1)
    wall = time.perf_counter() - t0
    launches, routes = _counts(), _routes()
    peak = torch.cuda.max_memory_allocated()
    check(tokens.shape == (HYBRID_B, HYBRID_NEW + 1) and tokens.dtype == np.int32,
          (tokens.shape, tokens.dtype))
    check(np.all((0 <= tokens) & (tokens < cfg.vocab)), "token out of range")
    want = _hybrid_launches(L, G, prefills=1, steps=HYBRID_NEW)
    check(launches == want, f"hybrid launches {launches} != {want}")
    check_routes(routes, "flash_attention", "hybrid prefill (bf16, d = 80)", wgmma=G)
    check_routes(routes, "rmsnorm", "hybrid serving (D = 2560)", vec=launches["rmsnorm"])
    check_routes(routes, "ssd_scan", "hybrid prefill (bf16, N = P = 64, chunk 256)", mma=L)
    check_routes(routes, "decode_attention", "hybrid decode (f32, d = 80)",
                 split=launches["decode_attention"])

    # the same steps timed one by one, with their launch counts
    cache = api.init_cache(cfg, HYBRID_B, HYB_CACHE, tp=1, device=dev)
    cache_mb = sum(cache[k].numel() * cache[k].element_size() for k in
                   ("S", "conv", "ak", "av")) / 1e6
    prefill, decode = make_prefill_step(cfg, tp=1), make_decode_step(cfg, tp=1)
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": torch.as_tensor(prompt, device=dev)}, cache)
    tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    delta = {k: v - before[k] for k, v in _counts().items()}
    check(delta == _hybrid_launches(L, G, prefills=1, steps=0), f"prefill launches {delta}")
    step_ms, out = [], [tok]
    for _ in range(HYBRID_NEW):
        before = _counts()
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, {"token": tok})
        tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        delta = {k: v - before[k] for k, v in _counts().items()}
        check(delta == _hybrid_launches(L, G, prefills=0, steps=1),
              f"decode-step launches {delta}")
        out.append(tok)
    timed = torch.cat(out, dim=1).cpu().numpy()
    check(np.array_equal(timed, tokens), "timed steps' tokens != greedy_generate's")
    p50 = float(np.median(step_ms))
    log(f"# hybrid standard path: {HYBRID_B} x {HYBRID_PROMPT}-token prompts, "
        f"{HYBRID_NEW} new tokens each: greedy_generate {wall * 1e3:.1f} ms = "
        f"{HYBRID_B * (HYBRID_NEW + 1) / wall:.1f} tokens/s; prefill {prefill_ms:.2f} ms, "
        f"decode step p50 {p50:.3f} ms (min {min(step_ms):.3f}, max {max(step_ms):.3f}) "
        f"= {HYBRID_B / p50 * 1e3:.1f} tokens/s in decode; launches {launches}, flash "
        f"by route {routes['flash_attention']}; "
        f"max_memory_allocated {peak / 2**20:.1f} MiB; cache {cache_mb:.1f} MB f32 "
        f"(S {cache['S'].numel() * 4 / 1e6:.1f}, conv {cache['conv'].numel() * 4 / 1e6:.1f}, "
        f"ak+av {2 * cache['ak'].numel() * 4 / 1e6:.1f})")

    # where the time goes: one prefill, then 8 decode steps
    cache = api.init_cache(cfg, HYBRID_B, HYB_CACHE, tp=1, device=dev)
    toks = torch.as_tensor(prompt, device=dev)
    profile_steps(torch, lambda: prefill(params, {"tokens": toks}, cache), 1,
                  f"hybrid prefill ({HYBRID_B} x {HYBRID_PROMPT} tokens, {L} layers)")
    n = min(8, HYBRID_NEW)
    profile_steps(torch, lambda: [decode(params, cache, {"token": tok}) for _ in range(n)],
                  n, f"hybrid decode steps (batch {HYBRID_B}, cache {HYBRID_PROMPT}.."
                  f"{HYBRID_PROMPT + n})")

    # the reference's serving contract at full width, in float32: prefill +
    # decode steps equal the teacher-forcing logits (tests/test_models.py, 5e-3)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gate = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab, (GATE_B, GATE_PROMPT + GATE_STEPS), dtype=np.int32)
    gate_routes = _routes()["ssd_scan"]
    full = api.logits(cfg32, params, {"tokens": gate}, tp=1)
    cache = api.init_cache(cfg32, GATE_B, GATE_PROMPT + GATE_STEPS + 1, tp=1, device=dev)
    got, cache = api.prefill(cfg32, params, {"tokens": gate[:, :GATE_PROMPT]}, cache, tp=1)
    errs = [(got[:, 0] - full[:, GATE_PROMPT - 1]).abs().max().item()]
    torch.testing.assert_close(got[:, 0], full[:, GATE_PROMPT - 1], rtol=5e-3, atol=5e-3)
    for t in range(GATE_PROMPT, GATE_PROMPT + GATE_STEPS):
        got, cache = api.decode(cfg32, params, cache, {"token": gate[:, t:t + 1]}, tp=1)
        errs.append((got[:, 0] - full[:, t]).abs().max().item())
        torch.testing.assert_close(got[:, 0], full[:, t], rtol=5e-3, atol=5e-3)
    check(torch.isfinite(full).all().item(), "hybrid float32 logits not finite")
    # the gate's SSD launches (T = 304 teacher forcing, T = 300 prefill), all
    # on the tensor-core body in float32
    gate_routes = {r: n - gate_routes[r] for r, n in _routes()["ssd_scan"].items()}
    check(gate_routes == {"mma": 2 * L, "simt": 0},
          f"hybrid float32 gate: ssd_scan routes {gate_routes} != mma {2 * L}")
    log(f"# hybrid float32 copy ({GATE_B} x {GATE_PROMPT} tokens, {GATE_STEPS} steps): "
        f"prefill + decode == teacher forcing, max |err| {max(errs):.3e} (tol 5e-3); "
        f"ssd_scan routes {gate_routes}")
    return {"launches": launches, "routes": routes, "cfg": cfg, "gate_routes": gate_routes}


# ---------------------------------------------------------------------------
# phase 12: the kernels' times at the hybrid path's shapes
# ---------------------------------------------------------------------------

def ssd_work(B, T, H, P, N, Q, x_bytes):
    """(bytes, flops, C.B^T flops) of one SSD scan: x, dt, B, C read once, y
    and the final state written once; over the pairs this input's chunks
    hold, the flops of the three products with a float32 operand per head
    (p.(dt x), the state update, and C.S_prev in every chunk but the first,
    where S_prev = 0), and those of C.B^T, which depends on (b, chunk)
    alone."""
    nbytes = (2 * B * T * H * P * x_bytes + B * T * H * 4 + 2 * B * T * N * x_bytes
              + H * 4 + B * H * N * P * 4)
    flops = cb = 0
    for t0 in range(0, T, Q):
        n = min(Q, T - t0)
        flops += n * (n + 1) * P + 2 * n * N * P * (2 if t0 else 1)
        cb += n * (n + 1) * N
    return nbytes, flops * B * H, cb * B


def ssd_timing(torch, case, dtype, seed: int, flush, reps: int) -> dict:
    """Row 8 at one shape: the kernel as routed, the CUDA-core body on the
    same inputs (``cuda_core_ms``) and the plain version, against the
    bound.  Each float32-operand product runs at the rate of the TF32 terms
    it needs (bf16 operands are exact in TF32: two terms, 494/2 TFLOP/s;
    float32: three, 494/3); C.B^T once per (b, chunk) (bf16: exact on the
    bf16 tensor cores; float32: three terms)."""
    from repro_torch.kernels.ssm_scan import ssd_route, ssd_scan_kernel, ssd_scan_plain

    chunk = case[5]
    args = _ssd_inputs(torch, case, dtype, seed, torch.device("cuda"))
    x, Bm = args[0], args[3]
    y, S = ssd_scan_kernel(*args, chunk=chunk, return_state=True)
    wy, wS = ssd_scan_plain(*args, chunk=chunk, return_state=True)
    core, (cy, cS) = _ssd_core_call(args, chunk)
    core()
    torch.cuda.synchronize()
    err = max((y.float() - wy.float()).abs().max().item(), (S - wS).abs().max().item())
    core_err = max((cy.float() - wy.float()).abs().max().item(), (cS - wS).abs().max().item())
    bf16 = dtype == torch.bfloat16
    nbytes, flops, cb = ssd_work(*case, x_bytes=x.element_size())
    rate, cb_rate = ((H100_TF32X2_FLOPS, H100_BF16_FLOPS) if bf16
                     else (H100_TF32X3_FLOPS, H100_TF32X3_FLOPS))
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = (flops / rate + cb / cb_rate) * 1e3
    name = str(dtype).removeprefix("torch.")
    return dict(
        ms=time_ms(torch, lambda: ssd_scan_kernel(*args, chunk=chunk, return_state=True),
                   reps, flush),
        cuda_core_ms=time_ms(torch, core, max(reps // 10, 3), flush), cuda_core_err=core_err,
        plain_ms=time_ms(torch, lambda: ssd_scan_plain(*args, chunk=chunk, return_state=True),
                         max(reps // 5, 3), flush),
        library_ms=None, bound_ms=max(by_bytes, by_ops),
        bound_by="bytes" if by_bytes >= by_ops else "operations", max_abs_err=err,
        route=ssd_route(dtype, case[4], case[3], chunk),
        shape=f"x {tuple(x.shape)} {name}, B, C {tuple(Bm.shape)} {name}, chunk {chunk}",
        work=f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP at "
             f"{'two' if bf16 else 'three'} TF32 terms + {cb / 1e9:.4f} GFLOP C.B^T "
             f"{'on bf16' if bf16 else 'at three terms'}")


def _ssd_core_call(args, chunk: int):
    """A call of the CUDA-core SSD body (``ssm_scan.cu``'s ``ssd_scan_fwd``,
    which ran every launch before the tensor-core body) through its C
    entry, on inputs the wrapper routes to the tensor-core body: timed
    beside it in the same run, never on a path.  Returns (call, outputs)."""
    import torch

    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.common import DTYPE_CODES, ptr, stream

    x, dt, A, Bm, Cm = args
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    S = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    xs, ds, bs, cs, ys = x.stride(), dt.stride(), Bm.stride(), Cm.stride(), y.stride()
    fn, st = ssm_scan._library().ssd_scan_fwd, stream(x.device)

    def call():
        check(fn(ptr(x), xs[0], xs[1], xs[2], ptr(dt), ds[0], ds[1], ds[2], ptr(A),
                 ptr(Bm), bs[0], bs[1], ptr(Cm), cs[0], cs[1], ptr(y), ys[0], ys[1], ys[2],
                 ptr(S), DTYPE_CODES[x.dtype], Bsz, T, H, P, N, min(chunk, T), st) == 0,
              "CUDA-core SSD scan failed")
    return call, (y, S)


def phase_hybrid_timing(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain, rmsnorm_route

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    flush = l2_flush_buffer(torch)
    saved = _snapshot()
    out = {}

    # the SSD scan of one Mamba2 layer's prefill, x (8,1024,80,64) bf16, and
    # of the float32 gate's teacher forcing, x (2,304,80,64) float32: the
    # tensor-core body, the CUDA-core body through its C entry, the plain
    # version
    out["ssd_scan"] = ssd_timing(
        torch, (HYBRID_B, HYBRID_PROMPT, SSD_H, SSD_P, SSD_N, SSD_Q), bf16, 30, flush, 50)
    out["ssd_scan@gate-f32"] = ssd_timing(
        torch, (GATE_B, GATE_PROMPT + GATE_STEPS, SSD_H, SSD_P, SSD_N, SSD_Q), f32, 39,
        flush, 50)

    # rows 3 and 4 at the shared block's prefill attention, (8,32,1024,80)
    # bf16, MHA, on the tensor-core body
    q, k, v = (_randn(torch, (HYBRID_B, HYB_HEADS, HYBRID_PROMPT, HYB_HD), bf16, s, dev)
               for s in (31, 32, 33))
    out["flash_attention@hybrid"] = flash_timing(torch, q, k, v, flush, 20, stats=False)
    out["flash_attention_fwd_stats@hybrid"] = flash_timing(torch, q, k, v, flush, 20,
                                                           stats=True)

    # decode: the shared block's step attention; after the first Mamba2
    # layer the decode step runs in float32 (the reference's promotion), so q
    # (8,32,1,80) f32 against the (8,1057,32,80) f32 cache at pos 1040
    pos = HYBRID_PROMPT + HYBRID_NEW // 2
    q1 = _randn(torch, (HYBRID_B, HYB_HEADS, 1, HYB_HD), f32, 34, dev)
    ck = _randn(torch, (HYBRID_B, HYB_CACHE, HYB_HEADS, HYB_HD), f32, 35, dev)
    cv = _randn(torch, (HYBRID_B, HYB_CACHE, HYB_HEADS, HYB_HD), f32, 36, dev)
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    pt = torch.tensor([pos], dtype=torch.int32, device=dev)
    visible = pos + 1
    nbytes = 2 * 4 * q1.numel() + 2 * HYBRID_B * HYB_HEADS * visible * HYB_HD * 4 + 4
    flops = 4 * HYBRID_B * HYB_HEADS * visible * HYB_HD
    bound, by = _bound(nbytes, flops, H100_FP32_FLOPS)
    mask = (torch.arange(HYB_CACHE, device=dev) <= pos)[None, None, None, :]
    out["decode_attention@hybrid"] = decode_timing(
        torch, q1, kt, vt, pt, flush, 100, bound, by,
        f"{nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} MFLOP",
        f"q {tuple(q1.shape)} f32, cache {tuple(ck.shape)} f32, pos {pos}",
        lambda: F.scaled_dot_product_attention(q1, kt, vt, attn_mask=mask))

    # rmsnorm: the prefill's rows (8192, 2560) bf16; the decode step's (8, 2560) f32
    for rows, dtype, key in ((HYBRID_B * HYBRID_PROMPT, bf16, "rmsnorm@hybrid"),
                             (HYBRID_B, f32, "rmsnorm@hybrid-decode")):
        xr = _randn(torch, (rows, HYB_D), dtype, 37, dev)
        w = _randn(torch, (HYB_D,), f32, 38, dev)
        wl = w.to(dtype)
        err = (rmsnorm_kernel(xr, w).float() - rmsnorm_plain(xr, w).float()).abs().max().item()
        nbytes = 2 * xr.element_size() * xr.numel() + 4 * w.numel()
        bound, by = _bound(nbytes, 4 * xr.numel(), H100_FP32_FLOPS)
        out[key] = dict(
            ms=time_ms(torch, lambda: rmsnorm_kernel(xr, w), 100, flush),
            plain_ms=time_ms(torch, lambda: rmsnorm_plain(xr, w), 50, flush),
            library_ms=time_ms(torch, lambda: F.rms_norm(xr, (HYB_D,), wl, 1e-6), 100, flush),
            bound_ms=bound, bound_by=by, max_abs_err=err, route=rmsnorm_route(xr, w),
            library="F.rms_norm",
            shape=f"x ({rows}, {HYB_D}) {str(dtype).removeprefix('torch.')}, w f32",
            work=f"{nbytes / 1e6:.3f} MB")

    _restore(saved)                         # timing launches are not the path's
    log_timing(out)
    return out


# ---------------------------------------------------------------------------
# phase 13: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def _bwd_chain(fwd, dq_fn, dkv_fn, q, k, v, do, causal):
    """(o, m, l, dq, dk, dv) of one forward-with-statistics and backward
    chain, delta formed as ``FlashAttentionFn`` forms it."""
    o, m, l = fwd(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = dq_fn(q, k, v, do, m, l, delta, causal=causal)
    dk, dv = dkv_fn(q, k, v, do, m, l, delta, causal=causal)
    return o, m, l, dq, dk, dv


def phase_bwd_kernels(torch) -> dict:
    """The forward-with-statistics, dQ and dK/dV kernels against their plain
    versions: the reference's ``BWD_CASES``, a short last tile at Qwen2's
    head dim, the training shape and phase 19's shapes (d = 80 and 96,
    unmasked with S != T, GQA group 2), float32 at 2e-4 (the reference's own
    tolerance) and bfloat16 at 2e-2, each launch on its route (bf16 at
    these d: the tensor-core bodies); row 0 of a batched launch bitwise
    equal to a solo launch, and the model's transposed views equal to
    contiguous inputs, at the training shape."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import flash_route

    dev = torch.device("cuda")
    names = ("flash_attention_fwd_stats", "flash_attention_dq", "flash_attention_dkv")
    worst = dict.fromkeys(names, 0.0)
    worst_bf16 = dict.fromkeys(names, 0.0)
    kernels = (fab.flash_attention_fwd_stats_kernel, fab.flash_attention_dq_kernel,
               fab.flash_attention_dkv_kernel)
    plains = (fab.flash_attention_fwd_stats_plain, fab.flash_attention_dq_plain,
              fab.flash_attention_dkv_plain)
    saved = _snapshot()
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        for B, Hq, Hkv, T, S, d, causal in BWD_CASES:
            q, do = (_randn(torch, (B, Hq, T, d), dtype, s, dev) for s in (40, 41))
            k, v = (_randn(torch, (B, Hkv, S, d), dtype, s, dev) for s in (42, 43))
            _reset_counts()
            got = _bwd_chain(*kernels, q, k, v, do, causal)
            routes = _routes()
            want = _bwd_chain(*plains, q, k, v, do, causal)
            torch.cuda.synchronize()
            for name, route in zip(names, (flash_route(dtype, d),
                                           *[fab.flash_bwd_route(dtype, d)] * 2)):
                check_routes(routes, name, f"{dtype}, d = {d}", **{route: 1})
            for name, g, w in zip(names[:1] * 3 + names[1:2] + names[2:] * 2, got, want):
                check(g.dtype == w.dtype and g.shape == w.shape, (name, g.shape, w.shape))
                err = (g.float() - w.float()).abs().max().item()
                into = worst if dtype == torch.float32 else worst_bf16
                into[name] = max(into[name], err)
                torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
                check(torch.isfinite(g.float()).all().item(), f"{name}: non-finite")
            cases += 1
            if (B, Hq, T) != (TRAIN_B, 15, TRAIN_SEQ) or dtype != torch.bfloat16:
                continue
            o, m, l, dq, dk, dv = got
            one = [t[:1] for t in (q, k, v, do)]
            solo = _bwd_chain(*kernels, *one, causal)
            for g, w in zip(solo, got):
                check(torch.equal(g[0], w[0]), "training kernels: batched row 0 != solo")
            tv = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v, do)]
            check(all(torch.equal(a, b) for a, b in
                      zip(_bwd_chain(*kernels, *tv, causal), got)),
                  "training kernels: strided views differ from contiguous inputs")
    _restore(saved)                         # comparison launches are not a path's
    log(f"# training kernels vs plain: {cases} cases (o, m, l, dq, dk, dv), each launch on "
        f"its route (bf16: tensor-core bodies), max |err| in float32 {worst} (tol 2e-4), "
        f"in bf16 {worst_bf16} (tol 2e-2); batched row 0 == solo bitwise and strided views "
        f"at the training shape: ok")
    return {name: max(worst[name], worst_bf16[name]) for name in names}


# ---------------------------------------------------------------------------
# phase 14: the training path at full width
# ---------------------------------------------------------------------------

def _grad_rel_err(torch, got, want):
    num = sum(((g.float() - w.float()) ** 2).sum() for g, w in zip(got, want))
    return (torch.sqrt(num) / torch.sqrt(sum((w.float() ** 2).sum() for w in want))).item()


def phase_train(torch) -> dict:
    """``launch.train.train`` on SmolLM-360M uncut (float32 masters, bf16
    compute, remat, tp=1, AdamW lr 3e-4, clip 1.0): 6 steps of 8 x 1024
    tokens from ``TokenPipeline``.  Gates: (a) every loss and grad norm
    finite; (b) per step 2L forward-with-statistics (L and L recomputed),
    L dQ and L dK/dV launches, all on the tensor-core bodies, and no
    plain-version call; (c) one step's
    gradients through the kernels against the same step with the plain
    versions in their places, back to back: global relative error <= 2e-2,
    every leaf finite and nonzero where the plain one is; (d) on the reduced
    config in float32 the card's step equals the CPU's (1e-4), and a 3 + 3
    resumed run equals 6 uninterrupted steps (rtol 1e-5, atol 1e-6)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    L = cfg.n_layers
    check(cfg.remat and cfg.compute_dtype == "bfloat16", (cfg.remat, cfg.compute_dtype))

    # the main path, counted, with the plain versions counted too: a call of
    # one on the card would be a fallback
    plain_calls = {}
    saved_plain = {n: getattr(fab, n) for n in (
        "flash_attention_fwd_stats_plain", "flash_attention_dq_plain",
        "flash_attention_dkv_plain")}

    def counted(name, fn):
        def call(*args, **kw):
            plain_calls[name] = plain_calls.get(name, 0) + 1
            return fn(*args, **kw)
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for n, fn in saved_plain.items():
            setattr(fab, n, counted(n, fn))
        _reset_counts()
        t0 = time.perf_counter()
        out = train(TRAIN_ARCH, reduced=False, steps=TRAIN_STEPS, batch=TRAIN_B,
                    seq=TRAIN_SEQ, lr=TRAIN_LR, seed=SEED, log_every=1, device="cuda")
        wall = time.perf_counter() - t0
        launches, routes = _counts(), _routes()
    finally:
        for n, fn in saved_plain.items():
            setattr(fab, n, fn)
    peak = torch.cuda.max_memory_allocated()
    metrics = out["metrics"]
    check(len(metrics) == TRAIN_STEPS, metrics)
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics),
          f"non-finite loss or grad norm: {metrics}")
    per_step = {"flash_attention_fwd_stats": 2 * L, "flash_attention_dq": L,
                "flash_attention_dkv": L}
    for name, n in per_step.items():
        check(launches[name] == TRAIN_STEPS * n,
              f"{name}: {launches[name]} launches in {TRAIN_STEPS} steps, want {n} per step")
    check(launches["flash_attention"] == launches["decode_attention"] == 0, launches)
    for name, n in per_step.items():
        check_routes(routes, name, "train steps (bf16, d = 64)", wgmma=TRAIN_STEPS * n)
    check(launches["rmsnorm"] > 0, launches)
    check_routes(routes, "rmsnorm", "train steps (bf16, D = 960)", vec=launches["rmsnorm"])
    check(not plain_calls, f"plain versions called on the card: {plain_calls}")
    nparams = sum(t.numel() for t in _tensors(out["params"]))
    step_ms = [m["ms"] for m in metrics]
    p50 = float(np.median(step_ms))
    tokens = TRAIN_B * TRAIN_SEQ
    log(f"# training path: {cfg.name} uncut ({L} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}q/{cfg.n_kv_heads}kv heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}), {nparams / 1e6:.1f} M params, float32 masters, "
        f"{cfg.compute_dtype} compute, remat, tp=1, AdamW lr {TRAIN_LR}, clip 1.0: "
        f"{TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_SEQ} tokens in {wall:.2f} s (init "
        f"included); step p50 {p50:.1f} ms (min {min(step_ms):.1f}, max "
        f"{max(step_ms):.1f}) = {tokens / p50 * 1e3:.0f} tokens/s; losses "
        f"{[round(m['loss'], 4) for m in metrics]}, grad norms "
        f"{[round(m['grad_norm'], 4) for m in metrics]}; launches {launches}, by route "
        f"{ {n: routes[n] for n in per_step} }; "
        f"max_memory_allocated {peak / 2**20:.1f} MiB")

    # where the time goes: one more step under the profiler
    params, opt_state = out["params"], out["opt_state"]
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_B, seed=SEED))
    batch = data.batch_at(TRAIN_STEPS)
    step_fn = make_train_step(cfg, tp=1, opt=AdamWConfig(lr=TRAIN_LR),
                              total_steps=max(TRAIN_STEPS, 10))
    saved = _snapshot()
    profile_steps(torch, lambda: step_fn(params, opt_state, batch), 1,
                  f"train step ({TRAIN_B} x {TRAIN_SEQ} tokens, {L} layers, remat)")

    # (c) the kernels against their plain versions in the same step
    grads, times = {}, {}
    # the plain versions in the kernels' places, where ``_routes`` finds them
    plain = {f"flash_attention_{n}_kernel": getattr(fab, f"flash_attention_{n}_plain")
             for n in ("fwd_stats", "dq", "dkv")}
    shipped = {n: getattr(fab, n) for n in plain}
    try:
        for route in ("kernel", "plain"):
            for n in plain:
                setattr(fab, n, plain[n] if route == "plain" else shipped[n])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, g = loss_and_grads(cfg, params, batch, tp=1)
            torch.cuda.synchronize()
            times[route] = (time.perf_counter() - t0) * 1e3
            grads[route] = (float(loss), [t for _, t in api._leaves(g)])
    finally:
        for n, fn in shipped.items():
            setattr(fab, n, fn)
        _restore(saved)
    names = [n for n, _ in api._leaves(params)]
    rel = _grad_rel_err(torch, grads["kernel"][1], grads["plain"][1])
    check(rel <= 2e-2, f"kernel vs plain gradients: global relative error {rel:.3e}")
    for name, g, w in zip(names, grads["kernel"][1], grads["plain"][1]):
        check(torch.isfinite(g).all().item(), f"{name}: non-finite gradient")
        check(torch.count_nonzero(w).item() == 0 or torch.count_nonzero(g).item() > 0,
              f"{name}: zero gradient through the kernels, nonzero through the plain versions")
    leaf_rel = {n: _grad_rel_err(torch, [g], [w]) for n, g, w in
                zip(names, grads["kernel"][1], grads["plain"][1])}
    log(f"# train-step gradients, kernels vs plain versions (one step, {TRAIN_B} x "
        f"{TRAIN_SEQ}): loss {grads['kernel'][0]:.6f} / {grads['plain'][0]:.6f}, global "
        f"relative error {rel:.3e} (tol 2e-2; 8.494e-3 with the CUDA-core dQ and dK/dV); "
        f"per leaf "
        f"{ {n: float(f'{e:.2e}') for n, e in leaf_rel.items()} }; loss+gradient host time "
        f"{times['kernel']:.1f} ms with the kernels, then {times['plain']:.1f} ms with "
        f"the plain versions")

    # (d) the reduced config in float32: card == CPU, and resume == uninterrupted
    cfg_r = dataclasses.replace(reduced_config(TRAIN_ARCH), compute_dtype="float32")
    cpu = api.init(cfg_r, torch.Generator().manual_seed(SEED), tp=1, device="cpu")
    card = _tree_map(lambda t: t.to(dev), cpu)
    batch_r = TokenPipeline(DataConfig(vocab=cfg_r.vocab, seq_len=64, global_batch=4,
                                       seed=SEED)).batch_at(0)
    lc, gc = loss_and_grads(cfg_r, cpu, batch_r, tp=1)
    before = _routes()
    lg, gg = loss_and_grads(cfg_r, card, batch_r, tp=1)
    after = _routes()
    # float32 at the reduced head dim: the forward with statistics on the
    # 3xTF32 body, dQ and dK/dV on the CUDA cores
    for name, route in (("flash_attention_fwd_stats", "tf32x3"), ("flash_attention_dq", "simt"),
                        ("flash_attention_dkv", "simt")):
        delta = {r: after[name][r] - before[name][r] for r in after[name]}
        check(delta[route] > 0 and sum(delta.values()) == delta[route],
              f"reduced float32 step: {name} routes {delta}, want {route} only")
    errs = []
    for (name, a), (_, b) in zip(api._leaves(gc), api._leaves(gg)):
        err = (b.cpu() - a).abs().max().item()
        errs.append(err / max(a.abs().max().item(), 1e-12))
        check(err <= 1e-4 * max(a.abs().max().item(), 1e-12), f"card vs CPU grad {name}: {err}")
    check(abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc)), (float(lg), float(lc)))
    step_r = make_train_step(cfg_r, tp=1, opt=AdamWConfig(lr=TRAIN_LR), total_steps=10)
    _, _, mc = step_r(cpu, adamw_init(cpu), batch_r)
    _, _, mg = step_r(card, adamw_init(card), batch_r)
    for key in ("loss", "grad_norm"):
        check(abs(float(mg[key]) - float(mc[key])) <= 1e-4 * abs(float(mc[key])),
              (key, float(mg[key]), float(mc[key])))
    kw = dict(reduced=True, batch=2, seq=32, ckpt_every=100, log_every=100, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        full = train(TRAIN_ARCH, steps=6, ckpt_dir=f"{tmp}/a", **kw)
        train(TRAIN_ARCH, steps=3, ckpt_dir=f"{tmp}/b", **kw)
        resumed = train(TRAIN_ARCH, steps=6, ckpt_dir=f"{tmp}/b", resume=True, **kw)
    resume_err = 0.0
    for (name, a), (_, b) in zip(api._leaves(full["params"]), api._leaves(resumed["params"])):
        resume_err = max(resume_err, (a - b).abs().max().item())
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    log(f"# reduced {TRAIN_ARCH} float32: card step == CPU step (loss {float(mg['loss']):.6f} "
        f"/ {float(mc['loss']):.6f}, largest leaf gradient error {max(errs):.2e} of the "
        f"leaf's max, tol 1e-4); 3 + 3 resumed steps == 6 uninterrupted (max |err| "
        f"{resume_err:.2e}, rtol 1e-5, atol 1e-6)")
    return {"launches": launches, "routes": routes, "p50_ms": p50}


def _cuda_core_bwd_call(bwd, dq: bool):
    """A call of the CUDA-core dQ or dK/dV body (``flash_attention_bwd.cu``'s
    ``dq_kernel`` / ``dkv_kernel``, which ran every bfloat16 launch before
    the tensor-core bodies) through its C entry, on inputs the wrappers route
    to the tensor-core bodies: timed beside them in the same run, never on a
    path.  Returns (call, outputs)."""
    import ctypes
    import math

    import torch

    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.common import DTYPE_CODES, ptr, stream, stride_array

    q, k, v, do, m, l, delta = bwd
    B, Hq, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    lib = fab._library()
    ins = [ptr(t) for t in bwd]
    tail = (DTYPE_CODES[q.dtype], B, Hq, Hkv, T, S, d, stride_array(q, k, v, do), 1,
            ctypes.c_float(1.0 / math.sqrt(d)), stream(q.device))
    if dq:
        out = (torch.empty((B, Hq, T, d), dtype=q.dtype, device=q.device),)
        fn, what = lib.flash_attention_dq, "CUDA-core dQ"
    else:
        out = tuple(torch.empty((B, Hkv, S, d), dtype=k.dtype, device=k.device)
                    for _ in "kv")
        fn, what = lib.flash_attention_dkv, "CUDA-core dK/dV"
    outs = [ptr(t) for t in out]

    def call():
        check(fn(*ins, *outs, *tail) == 0, f"{what} failed")
    return call, out


def phase_train_timing(torch) -> dict:
    """The three training kernels at the train step's attention shape: q
    (8,15,1024,64), k, v (8,5,1024,64) bf16, causal, against their bounds,
    their plain versions, their CUDA-core bodies through their C entries
    (``cuda_core_ms``) and ``scaled_dot_product_attention``'s forward (row
    4) and backward (rows 5 and 6 together; timed for comparison only); and
    the RMSNorm kernel at the train step's rows against ``F.rms_norm``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain, rmsnorm_route

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    flush = l2_flush_buffer(torch)
    saved = _snapshot()
    B, Hq, Hkv, T, d = TRAIN_B, 15, 5, TRAIN_SEQ, 64
    q, do = (_randn(torch, (B, Hq, T, d), bf16, s, dev) for s in (50, 51))
    k, v = (_randn(torch, (B, Hkv, T, d), bf16, s, dev) for s in (52, 53))
    o, m, l = fab.flash_attention_fwd_stats_kernel(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, m, l, delta)
    got = (o, m, l, fab.flash_attention_dq_kernel(*bwd), *fab.flash_attention_dkv_kernel(*bwd))
    want = (*fab.flash_attention_fwd_stats_plain(q, k, v), fab.flash_attention_dq_plain(*bwd),
            *fab.flash_attention_dkv_plain(*bwd))
    errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]

    pairs = B * Hq * (T * (T + 1) // 2)            # visible (query, key) pairs
    qb, kb, sb = q.numel() * 2, k.numel() * 2, B * Hq * T * 4
    work = {  # bytes (inputs read once, outputs written once), flops
        "flash_attention_dq": (qb + 2 * kb + qb + 3 * sb + qb, 3 * 2 * d * pairs),
        "flash_attention_dkv": (qb + 2 * kb + qb + 3 * sb + 2 * kb, 4 * 2 * d * pairs),
    }
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                         retain_graph=True), 20, flush)
    runs = {
        "flash_attention_dq": (lambda: fab.flash_attention_dq_kernel(*bwd),
                               lambda: fab.flash_attention_dq_plain(*bwd), errs[3], want[3:4]),
        "flash_attention_dkv": (lambda: fab.flash_attention_dkv_kernel(*bwd),
                                lambda: fab.flash_attention_dkv_plain(*bwd), max(errs[4:]),
                                want[4:]),
    }
    # rows 4 and 3 on the tensor-core body, against sdpa's forward
    out = {"flash_attention_fwd_stats": flash_timing(torch, q, k, v, flush, 20, stats=True),
           "flash_attention@train": flash_timing(torch, q, k, v, flush, 20, stats=False)}
    out["flash_attention_fwd_stats"]["max_abs_err"] = max(
        out["flash_attention_fwd_stats"]["max_abs_err"], *errs[:3])
    shape = f"q {tuple(q.shape)}, k,v {tuple(k.shape)} bf16 causal"
    for name, (kern, plain, err, plain_out) in runs.items():
        nbytes, flops = work[name]
        bound, by = _bound(nbytes, flops, H100_BF16_FLOPS)
        core, core_out = _cuda_core_bwd_call(bwd, name == "flash_attention_dq")
        core()
        torch.cuda.synchronize()
        out[name] = dict(ms=time_ms(torch, kern, 20, flush),
                         cuda_core_ms=time_ms(torch, core, 5, flush),
                         cuda_core_err=max((g.float() - w.float()).abs().max().item()
                                           for g, w in zip(core_out, plain_out)),
                         plain_ms=time_ms(torch, plain, 10, flush), library_ms=lib_bwd,
                         bound_ms=bound, bound_by=by, max_abs_err=err, shape=shape,
                         route=fab.flash_bwd_route(q.dtype, d),
                         library="sdpa backward (dq, dk, dv)",
                         work=f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP")
    dq_t, dkv_t = out["flash_attention_dq"], out["flash_attention_dkv"]
    both, both_core = dq_t["ms"] + dkv_t["ms"], dq_t["cuda_core_ms"] + dkv_t["cuda_core_ms"]
    log(f"# dQ + dK/dV at {shape}: {both:.4f} ms ({both / lib_bwd:.2f}x sdpa backward "
        f"{lib_bwd:.4f} ms; bound {dq_t['bound_ms'] + dkv_t['bound_ms']:.5f} ms); on the "
        f"CUDA-core bodies {both_core:.4f} ms ({both_core / lib_bwd:.1f}x)")

    # the RMSNorm forward kernel at the train step's rows (8 x 1024, 960) bf16,
    # 129 launches a step under ``RMSNormFn``
    x = _randn(torch, (B, T, 960), bf16, 54, dev)
    w = _randn(torch, (960,), torch.float32, 55, dev)
    wb = w.to(bf16)
    nbytes = 2 * 2 * x.numel() + 4 * w.numel()
    bound, by = _bound(nbytes, 4 * x.numel(), H100_FP32_FLOPS)
    out["rmsnorm@train"] = dict(
        ms=time_ms(torch, lambda: rmsnorm_kernel(x, w), 200, flush),
        plain_ms=time_ms(torch, lambda: rmsnorm_plain(x, w), 50, flush),
        library_ms=time_ms(torch, lambda: F.rms_norm(x, (960,), wb, 1e-6), 200, flush),
        bound_ms=bound, bound_by=by, shape=f"x {tuple(x.shape)} bf16, w f32",
        max_abs_err=(rmsnorm_kernel(x, w).float() - rmsnorm_plain(x, w).float()).abs().max().item(),
        library="F.rms_norm", route=rmsnorm_route(x, w), work=f"{nbytes / 1e6:.3f} MB")
    _restore(saved)                         # timing launches are not the path's
    log_timing(out)
    return out


# ---------------------------------------------------------------------------
# phase 15: the paper's evaluation on the card
# ---------------------------------------------------------------------------

PAPER_SCALE = "bench"
PAPER_REPEATS = 2        # timed calls after each cold call; the best is kept
# fig. 7's programs: float32, batch 2, seq 128, 4 layers, 4 query heads and 2
# kv heads of 16 (plan_heads(4, 2, 2)), d_model 128: per call 4 flash
# launches at q (2,4,128,16) against (2,2,128,16), 9 RMSNorm at (2,128,128)
FIG7_LAYERS, FIG7_B, FIG7_T, FIG7_HQ, FIG7_HKV, FIG7_HD, FIG7_D = 4, 2, 128, 4, 2, 16, 128
OFFLOADING = ("tech", "tech-g", "tech-gf", "tech-gfp")


def _log_rows(rows) -> None:
    for row in rows:
        log(f"# paper {row}")


def phase_paper(torch) -> dict:
    """The 17 workloads x 6 schemes at bench scale with the units on the card
    (figs. 4-6), table 3, fig. 7, the profile-guided cost model and the
    crossing-cost decomposition, through ``repro_torch.bench``.  Gates:
    every scheme's counters (cold and warm call), coverage, units and output
    dtypes equal the JAX package's recorded ones
    (``reference_counters.json``), the native-infeasible set too, outputs
    within 2e-3/2e-4 of pure interpretation; fig. 7's flash and RMSNorm
    launches all on ``"tf32x3"`` / ``"vec"``, as many as its units run.
    Then profiles of one ``tech-gfp`` call of cjson and of npbft."""
    from repro_torch.bench import (beyond_profile, crossing_cost, fig4_speedup,
                                   fig5_invocations, fig6_coverage, fig7_reverse,
                                   table3_library)
    from repro_torch.bench import common
    from repro_torch.workloads import WORKLOADS

    ref = common.load_reference()
    check(ref["scale"] == PAPER_SCALE, f"reference counters at {ref['scale']}")
    log(f"# paper's evaluation on {torch.cuda.get_device_name(0)} ({card_line()}), "
        f"{PAPER_SCALE} scale, best of {PAPER_REPEATS} timed calls after a cold one")
    walls = {}
    t0 = time.perf_counter()
    sweep = common.sweep_workloads(PAPER_SCALE, repeats=PAPER_REPEATS)
    walls["workloads"] = time.perf_counter() - t0
    bad = common.reference_mismatches(sweep, ref["workloads"])
    check(not bad, "workloads against the JAX package's counters:\n" + "\n".join(bad))
    infeasible = sorted(n for n, runs in sweep.items() if runs["native"].infeasible)
    check(infeasible == ref["native_infeasible"], f"native-infeasible set {infeasible}")
    _log_rows(fig4_speedup.rows(sweep))
    _log_rows(fig5_invocations.rows(sweep))
    _log_rows(fig6_coverage.rows(sweep))
    log(f"# paper: 17 workloads x 6 schemes == reference_counters.json (counters of "
        f"the cold and the warm call, coverage, units, dtypes), native infeasible "
        f"for {infeasible}, outputs within {common.RTOL}/{common.ATOL} of qemu")

    t0 = time.perf_counter()
    t3 = table3_library.sweep(PAPER_SCALE, repeats=PAPER_REPEATS)
    walls["table3"] = time.perf_counter() - t0
    bad = common.reference_mismatches(t3, ref["table3"])
    check(not bad, "table 3 against the JAX package's counters:\n" + "\n".join(bad))
    _log_rows(table3_library.rows(t3))

    # fig. 7: the launches of the sweep are the path's; counted from zero
    t0 = time.perf_counter()
    _reset_counts()
    f7 = fig7_reverse.sweep(PAPER_SCALE, repeats=PAPER_REPEATS)
    launches, routes = _counts(), _routes()
    walls["fig7"] = time.perf_counter() - t0
    calls = len(f7) * len(OFFLOADING) * (1 + PAPER_REPEATS)
    for arch, runs in f7.items():
        check(runs["native"].infeasible is not None, f"fig7 {arch}: native planned")
        for scheme in OFFLOADING:
            for a, b in zip(runs["qemu"].outputs, runs[scheme].outputs):
                np.testing.assert_allclose(b, a, rtol=common.RTOL, atol=common.ATOL,
                                           err_msg=f"fig7 {arch} {scheme}")
    check(launches == {**dict.fromkeys(launches, 0), "flash_attention": 4 * calls,
                       "rmsnorm": (2 * FIG7_LAYERS + 1) * calls},
          f"fig7 launches {launches} ({calls} unit calls of the forward)")
    check_routes(routes, "flash_attention", "fig7 float32 forward (d = 16)",
                 tf32x3=FIG7_LAYERS * calls)
    check_routes(routes, "rmsnorm", "fig7 float32 forward (D = 128)",
                 vec=(2 * FIG7_LAYERS + 1) * calls)
    _log_rows(fig7_reverse.rows(f7))
    log(f"# paper fig7: launches {launches['flash_attention']} flash (all tf32x3), "
        f"{launches['rmsnorm']} RMSNorm (all vec) over {calls} forward calls")

    t0 = time.perf_counter()
    bp = beyond_profile.sweep(PAPER_SCALE, repeats=PAPER_REPEATS)
    walls["beyond_profile"] = time.perf_counter() - t0
    for name, res in bp.items():
        for kind in ("static", "profile-guided"):
            for a, b in zip(res["qemu"].outputs, res[kind].outputs):
                check(np.allclose(b, a, rtol=common.RTOL, atol=common.ATOL),
                      f"profile-guided {name} {kind}: {b} vs {a}")
    check(len(bp["npbbt"]["profile-guided"].hybrid.last_plan.units) > 0,
          "profile guidance offloads npbbt")
    _log_rows(beyond_profile.rows(bp))

    t0 = time.perf_counter()
    parts = crossing_cost.measure()
    walls["crossing_cost"] = time.perf_counter() - t0
    _log_rows(crossing_cost.rows(parts))

    # profiles of one steady tech-gfp call: the most crossings (cjson) and
    # the most device work (npbft)
    saved = _snapshot()
    for name in ("cjson", "npbft"):
        run = sweep[name]["tech-gfp"]
        prog, args = WORKLOADS[name].build(PAPER_SCALE)
        profile_steps(torch, lambda: run.hybrid(*args), 1,
                      f"{name} tech-gfp call ({run.steady.guest_to_host} crossings)")
    _restore(saved)
    log(f"# paper: section wall times (s): "
        f"{ {k: round(v, 2) for k, v in walls.items()} }")
    return {"fig7_launches": launches, "fig7_routes": routes}


def phase_paper_timing(torch) -> dict:
    """The two kernels fig. 7's programs run, at its shapes: the float32
    flash forward at q (2,4,128,16) against (2,2,128,16) causal (row 3 on
    ``"tf32x3"``; beside the CUDA-core body, the plain version and ``sdpa``)
    and RMSNorm at (256, 128) float32 rows (row 7 on ``"vec"``; beside its
    plain version and ``F.rms_norm``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain, rmsnorm_route

    dev = torch.device("cuda")
    f32 = torch.float32
    flush = l2_flush_buffer(torch)
    saved = _snapshot()
    q = _randn(torch, (FIG7_B, FIG7_HQ, FIG7_T, FIG7_HD), f32, 60, dev)
    k, v = (_randn(torch, (FIG7_B, FIG7_HKV, FIG7_T, FIG7_HD), f32, s, dev) for s in (61, 62))
    out = {"flash_attention@fig7": flash_timing(torch, q, k, v, flush, 100, stats=False)}
    check(out["flash_attention@fig7"]["route"] == "tf32x3", "fig7 flash route")
    check(out["flash_attention@fig7"]["max_abs_err"] <= TOL, "fig7 flash vs plain")
    x = _randn(torch, (FIG7_B * FIG7_T, FIG7_D), f32, 63, dev)
    w = _randn(torch, (FIG7_D,), f32, 64, dev)
    err = (rmsnorm_kernel(x, w) - rmsnorm_plain(x, w)).abs().max().item()
    check(err <= 1e-5 and rmsnorm_route(x, w) == "vec", f"fig7 rmsnorm |err| {err}")
    nbytes = 4 * 2 * x.numel() + 4 * w.numel()
    bound, by = _bound(nbytes, 4 * x.numel(), H100_FP32_FLOPS)
    out["rmsnorm@fig7"] = dict(
        ms=time_ms(torch, lambda: rmsnorm_kernel(x, w), 200, flush),
        plain_ms=time_ms(torch, lambda: rmsnorm_plain(x, w), 50, flush),
        library_ms=time_ms(torch, lambda: F.rms_norm(x, (FIG7_D,), w, 1e-6), 200, flush),
        bound_ms=bound, bound_by=by, max_abs_err=err, route=rmsnorm_route(x, w),
        library="F.rms_norm", shape=f"x {tuple(x.shape)} f32, w f32",
        work=f"{nbytes / 1e6:.3f} MB")
    _restore(saved)                         # timing launches are not the path's
    log_timing(out)
    return out


# ---------------------------------------------------------------------------
# phase 16: request-level serving at full width (configuration 8)
# ---------------------------------------------------------------------------

SERVE_BUCKETS, SERVE_DELAY, SERVE_WORKERS, SERVE_CLIENTS = (1, 2, 4, 8), 0.02, 2, 8
SERVE_ROWS = (1,) * 12 + (2,) * 4     # tests/test_serve.py's mix: 12 x 1 row, 4 x 2 rows


def phase_serve(torch, dense: dict) -> dict:
    """``MixedServer`` over configuration 3's program (SmolLM-360M uncut,
    float32, seq 256, host check, batch-agnostic, ``tech-gfp``) with buckets
    {1, 2, 4, 8}, a 20 ms batching window and two batch threads.  A cold
    request is served on the emulator fallback; then every bucket is warm
    and 8 client threads send the reference test's mix.  Gates: no
    fallback after warming; each batch's outputs bitwise equal the compiled
    hybrid called directly on the same padded batch, each response within
    2e-3/2e-4 of its direct per-request call; crossings per row below the
    unbatched calls'; 32 flash (all ``"tf32x3"``) and 65 RMSNorm (all
    ``"vec"``) launches per batch."""
    import dataclasses
    import threading

    from repro_torch import mixed
    from repro_torch.models.programs import export_dense_forward
    from repro_torch.serve import BucketLadder, MixedServer

    cfg32 = dataclasses.replace(dense["cfg"], compute_dtype="float32")
    L = cfg32.n_layers
    prog, _ = export_dense_forward(cfg32, dense["params"], batch=1, seq=MIXED_SEQ,
                                   with_host_check=True, tp=1)
    planned = mixed.trace(prog).plan("tech-gfp")
    rng = np.random.default_rng(SEED + 16)
    reqs = [rng.integers(0, cfg32.vocab, (n, MIXED_SEQ), dtype=np.int32)
            for n in SERVE_ROWS]
    server = MixedServer(planned, ladder=BucketLadder(batch_sizes=SERVE_BUCKETS),
                         max_batch_delay=SERVE_DELAY, workers=SERVE_WORKERS)
    captured = []
    try:
        t0 = time.perf_counter()
        cold = server.request(reqs[0], timeout=600)
        cold_s = time.perf_counter() - t0
        check(server.report().fallback_requests == 1, "the cold request was not "
              "served on the emulator fallback")
        t0 = time.perf_counter()
        server.warm(reqs[0])
        deadline = time.time() + 600
        while server.report().warm_compiles < len(SERVE_BUCKETS) and time.time() < deadline:
            time.sleep(0.01)
        warm_s = time.perf_counter() - t0
        check(server.report().warm_compiles == len(SERVE_BUCKETS),
              f"buckets warmed: {server.report().warm_compiles}")
        real = server.hybrid.call_reported

        def capture(*args):
            outs, rep = real(*args)
            captured.append((tuple(np.array(a) for a in args), outs))
            return outs, rep

        server.hybrid.call_reported = capture
        results, lat = [None] * len(reqs), [0.0] * len(reqs)

        def client(c):
            for i in range(c, len(reqs), SERVE_CLIENTS):
                t = time.perf_counter()
                results[i] = server.request(reqs[i], timeout=600)
                lat[i] = time.perf_counter() - t

        before = server.report()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        [t.start() for t in threads]
        [t.join() for t in threads]
        wall = time.perf_counter() - t0
        launches, routes = _counts(), _routes()
        peak = torch.cuda.max_memory_allocated()
        after = server.report()
    finally:
        server.close()
    check(all(r is not None for r in results), "a client got no response")
    rows = sum(SERVE_ROWS)
    batches = after.batches - before.batches
    check(after.fallback_requests == before.fallback_requests,
          "a warm server fell back to the emulator")
    check(batches == len(captured), f"{batches} batches, {len(captured)} captured calls")
    check(launches == {**dict.fromkeys(launches, 0), "flash_attention": L * batches,
                       "rmsnorm": (2 * L + 1) * batches},
          f"served launches {launches} over {batches} batches")
    check_routes(routes, "flash_attention", "served float32 forward (d = 64)",
                 tf32x3=L * batches)
    check_routes(routes, "rmsnorm", "served float32 forward (D = 960)",
                 vec=(2 * L + 1) * batches)

    saved = _snapshot()                     # the comparisons' launches are not the path's
    direct = planned.compile()
    for args, outs in captured:             # each batch: the direct call on its padded batch
        for a, b in zip(outs, direct(*args)):
            check(np.array_equal(a, b), f"batch of {args[0].shape[0]} rows != the "
                  f"direct call on the same padded batch")
    solo_crossings, bitwise, err = 0, 0, 0.0
    for req, res in zip(reqs, results):
        ref, rep = direct.call_reported(req)
        solo_crossings += rep.guest_to_host
        for a, b in zip(res, ref):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)
            err = max(err, float(np.abs(a - b).max()))
        bitwise += all(np.array_equal(a, b) for a, b in zip(res, ref))
    np.testing.assert_allclose(cold[0], results[0][0], rtol=2e-3, atol=2e-4)
    cpr = (after.crossings - before.crossings) / rows
    solo_cpr = solo_crossings / rows
    check(cpr < solo_cpr, f"crossings per row {cpr} not below unbatched {solo_cpr}")
    big = next(args for args, _ in captured if args[0].shape[0] == max(SERVE_BUCKETS)) \
        if any(a[0].shape[0] == max(SERVE_BUCKETS) for a, _ in captured) else None
    if big is not None:
        profile_steps(torch, lambda: direct(*big), 1,
                      f"bucket-{max(SERVE_BUCKETS)} batch ({max(SERVE_BUCKETS)} x "
                      f"{MIXED_SEQ} tokens, {L} layers)")
    _restore(saved)
    lat_ms = np.array(lat) * 1e3
    sizes = sorted(a[0].shape[0] for a, _ in captured)
    log(f"# served (configuration 8, {card_line()}): "
        f"cold request on the emulator fallback {cold_s:.2f} s; warming {len(SERVE_BUCKETS)} "
        f"buckets {warm_s:.2f} s")
    log(f"# served: {len(reqs)} requests ({rows} rows) from {SERVE_CLIENTS} threads in "
        f"{batches} batches of {sizes} padded rows; crossings/row {cpr:.4f} (unbatched "
        f"{solo_cpr:.4f}); batch occupancy {after.batch_occupancy:.4f} (cumulative "
        f"{after.request_rows}/{after.padded_rows}); latency p50 "
        f"{np.percentile(lat_ms, 50):.1f} ms, p99 {np.percentile(lat_ms, 99):.1f} ms (host "
        f"clock); {rows / wall:.2f} rows/s over {wall:.2f} s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"# served: every batch == the direct call on its padded batch (bitwise); every "
        f"response within 2e-3/2e-4 of its per-request call (max |err| {err:.3e}), "
        f"{bitwise}/{len(reqs)} bitwise; launches {launches['flash_attention']} flash "
        f"(all tf32x3) + {launches['rmsnorm']} RMSNorm (all vec) = "
        f"{L} + {2 * L + 1} per batch")
    return {"launches": launches, "routes": routes, "batches": batches}


# ---------------------------------------------------------------------------
# phase 17: AOT and the cluster at full width (configuration 9)
# ---------------------------------------------------------------------------

def phase_cluster(torch) -> dict:
    """``export_attn_decode_lm`` at SmolLM-360M's widths (d_model 960, vocab
    49152, max_context 256) on two spawned workers booted from an AOT cache
    (``serve_sections.FULL``): one worker serves burst A and saves its warm
    plan, two workers load it and serve bursts A + B.  Gates: the counters
    equal the same workload's CPU run (``cluster_full_counters.json``),
    second_boot_compiles 0, streams [8, 8]; every stream bitwise equal to
    the in-process ``decode_reference`` on the card, the cluster's burst A
    to the baseline's; in each worker, counted there since its boot and
    shipped with its report, one flash launch on ``"tf32x3"`` per prefill
    group and no other launch, eager units (the baseline) and loaded ones
    (the cluster) alike."""
    from repro_torch import mixed, obs
    from repro_torch.bench import serve_sections as ss
    from repro_torch.models.programs import export_attn_decode_lm
    from repro_torch.serve import decode_reference, load_planned

    geo = ss.FULL
    # traced, so the workers' aot_save / aot_load spans come back over the
    # channel with their durations (tracing is passive: the counters and
    # tokens are the untraced run's)
    tracer = obs.Tracer(label="chip-smoke")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-aot-") as tmp:
        aot_dir = f"{tmp}/cache"
        t0 = time.perf_counter()
        with obs.session(tracer):
            metrics, problems, base, clus, extra = ss.cluster_workload(
                None, geo, oracle=False, aot_dir=aot_dir)
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_planned(aot_dir)
        load_s = time.perf_counter() - t0
    aot_spans = sorted((sp.name, round(sp.dur_ns / 1e9, 2)) for sp in tracer.snapshot()
                       if sp.kind == obs.AOT and sp.dur_ns is not None)
    check(not problems, "cluster streams:\n" + "\n".join(problems[:4]))
    want = json.loads(ss.FULL_COUNTERS.read_text())
    want.pop("device", None)
    diff = {k: (metrics[k], want[k]) for k in want if metrics[k] != want[k]}
    check(not diff and set(metrics) == set(want),
          f"cluster counters against the CPU run: {diff}")
    check(metrics["second_boot_compiles"] == 0 and metrics["first_boot_compiles"] > 0,
          f"compiles {metrics['first_boot_compiles']} -> {metrics['second_boot_compiles']}")
    check(metrics["streams_per_worker"] == [geo.n_streams] * geo.workers,
          f"streams per worker {metrics['streams_per_worker']}")

    # the launches of the workers' own runs: each prefill group (a batched
    # prefill or prefill_suffix call) runs ``encode`` once, one flash
    # launch; the decode step attends with plain matmuls and a softmax
    groups = {}
    for run, rep in (("baseline", base), ("cluster", clus)):
        per_worker = extra["worker_launches"][run]
        check(len(per_worker) == len(rep.worker_reports),
              f"{run}: {len(per_worker)} workers' launches for "
              f"{len(rep.worker_reports)} reports")
        for i, (counts, wr) in enumerate(zip(per_worker, rep.worker_reports)):
            what = f"{run} worker {i} ({wr.prefills} prefill groups)"
            check(wr.prefills > 0, f"{what}: no prefill")
            check_routes(counts, "flash_attention", what, tf32x3=wr.prefills)
            for name in counts:
                if name != "flash_attention":
                    check_routes(counts, name, what)
        groups[run] = sum(wr.prefills for wr in rep.worker_reports)
        check_routes(extra["launches"][run], "flash_attention", f"{run} (summed)",
                     tf32x3=groups[run])

    # the loaded plan in this process computes what the eager one does
    planned = mixed.trace(export_attn_decode_lm(
        vocab=geo.vocab, d_model=geo.d_model, max_context=geo.max_context)).plan("tech-gfp")
    check(extra["aot"]["bytes"] < planned.traced.program.constants["E"].nbytes / 10,
          f"AOT blobs hold {extra['aot']['bytes']} bytes: weights were embedded")
    prefill, step = planned.compile(), planned.for_entry("decode_step").compile()
    for i, ((p, n), out) in enumerate(zip(extra["both"], extra["outs"])):
        ref = decode_reference(prefill, step, p, n, capacity=geo.n_streams)
        check(np.array_equal(ref, out), f"cluster stream {i} != decode_reference")
    lprefill = loaded.compile()
    p0, _ = extra["both"][0]
    padded = np.repeat(p0[None], geo.n_streams, axis=0)
    outs, rep = lprefill.call_reported(padded)
    ref_outs, _ = prefill.call_reported(padded)
    for a, b in zip(outs, ref_outs):
        check(np.array_equal(a, b), "loaded prefill != eager prefill")
    check(loaded.unit_cache.aot_dispatches > 0 and rep.compiles == 0,
          f"loaded prefill: dispatches {loaded.unit_cache.aot_dispatches}, "
          f"compiles {rep.compiles}")

    walls = extra["walls"]
    steps = [r.latency.get(("step", "")) for r in clus.worker_reports]
    p50 = [h.quantile_ns(0.5) / 1e6 for h in steps if h is not None]
    mean = [h.mean_ns / 1e6 for h in steps if h is not None]
    flash = {run: extra["launches"][run]["flash_attention"] for run in groups}
    log(f"# cluster (configuration 9, {card_line()}): "
        f"counters == the CPU run ({ss.FULL_COUNTERS.name}): "
        f"{json.dumps(metrics, sort_keys=True)}")
    log(f"# cluster: boot walls, cold (1 worker from source) {walls['baseline_boot_s']:.2f} s, "
        f"warm (2 workers from the AOT cache, booting side by side) "
        f"{walls['cluster_boot_s']:.2f} s; save_aot {walls['save_aot_s']:.2f} s, "
        f"{extra['aot']['signatures']} blobs of {extra['aot']['bytes']} bytes in all; "
        f"the workers' AOT spans (s) {aot_spans}; load_planned in this process "
        f"{load_s:.2f} s")
    log(f"# cluster: {clus.tokens} tokens in {walls['cluster_decode_s']:.2f} s "
        f"({clus.tokens / walls['cluster_decode_s']:.1f} tokens/s; baseline "
        f"{base.tokens / walls['baseline_decode_s']:.1f} tokens/s on one worker), "
        f"{clus.tokens_per_crossing:.4f} tokens per crossing; step p50 "
        f"{min(p50):.2f}-{max(p50):.2f} ms (log2-bucket upper edge, per worker), mean "
        f"{min(mean):.2f}-{max(mean):.2f} ms; whole phase {run_s:.1f} s")
    log(f"# cluster: every stream == decode_reference on the card (bitwise), burst A == "
        f"the baseline's, the loaded prefill == the eager one; flash launches counted "
        f"in the workers: baseline (eager units) {flash['baseline']} for "
        f"{groups['baseline']} prefill groups, cluster (loaded units) "
        f"{flash['cluster']} for {groups['cluster']}")
    return {"flash": flash, "prefill_groups": groups}


# ---------------------------------------------------------------------------
# phase 18: the rest of the zoo at full width (configuration 10)
# ---------------------------------------------------------------------------

def _zoo_launches(cfg, *, prefills: int, steps: int) -> dict:
    L = cfg.n_layers
    if cfg.family == "encdec":      # LayerNorm; cross-attention in prefill and step
        norms, flash, dec = 0, cfg.n_enc_layers + 2 * L, 2 * L
    elif cfg.family == "ssm":       # a norm per block and ln_f; no attention
        norms, flash, dec = L + 1, 0, 0
    else:                           # moe, vlm: the dense decoder's layout
        norms, flash, dec = 2 * L + 1, L, L
    return {"rmsnorm": norms * (prefills + steps), "flash_attention": flash * prefills,
            "decode_attention": dec * steps, "paged_decode_attention": 0, "ssd_scan": 0,
            **NO_TRAIN_LAUNCHES}


def _zoo_extra(cfg, B: int, rng, frames: int = ZOO_FRAMES) -> dict:
    """The stubbed frontend's input, drawn as ``make_batch`` draws floats
    (normal x 0.1): encdec's frames (B, frames, d_model), vlm's patches
    (B, n_patches, D_PATCH); nothing for the token-only families."""
    from repro_torch.models import vlm

    if cfg.family == "encdec":
        shape = (B, frames, cfg.d_model)
    elif cfg.family == "vlm":
        shape = (B, cfg.n_patches, vlm.D_PATCH)
    else:
        return {}
    key = "frames" if cfg.family == "encdec" else "patches"
    return {key: rng.standard_normal(shape).astype(np.float32) * 0.1}


def zoo_generate(torch, cfg, params, prompt, extra: dict, steps: int):
    """Greedy tokens (B, steps + 1) as a caller gets them: ``greedy_generate``
    for the token-only families; for encdec and vlm, which it does not
    serve (it feeds tokens only, as the reference's), ``api.prefill`` with
    the frames or patches and then ``api.decode`` steps."""
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import api

    if not extra:
        return greedy_generate(cfg, params, prompt, steps=steps, tp=1)
    B, T = prompt.shape
    cache = api.init_cache(cfg, B, T + steps + 1, tp=1,
                           device=params["embed"]["table"].device)
    logits, cache = api.prefill(cfg, params, {"tokens": prompt, **extra}, cache, tp=1)
    tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(steps):
        logits, cache = api.decode(cfg, params, cache, {"token": tok}, tp=1)
        tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1).cpu().numpy()


class _Spies:
    """Watchers on a counted run, each restored on exit: the flash calls'
    ``causal`` flags (``ops.flash_attention`` wrapped) and, for MoE, each
    ``moe.route`` call's dropped and total (token, k) pairs, split into
    prefill (more tokens than the batch) and decode calls."""

    def __init__(self, batch: int):
        from repro_torch.kernels import ops
        from repro_torch.models import moe

        self.ops, self.moe, self.batch = ops, moe, batch
        self.causal = {True: 0, False: 0}
        self.pairs = {"prefill": [], "decode": []}
        self.shipped = (ops.flash_attention, moe.route)

    def __enter__(self):
        flash, route = self.shipped

        def spy_flash(q, k, v, *, causal=True, scale=None):
            self.causal[bool(causal)] += 1
            return flash(q, k, v, causal=causal, scale=scale)

        def spy_route(cfg, lp, xf):
            out = route(cfg, lp, xf)
            keep = out[3]
            kind = "prefill" if xf.shape[0] > self.batch else "decode"
            self.pairs[kind].append((keep.numel() - keep.sum(), keep.numel()))
            return out

        self.ops.flash_attention, self.moe.route = spy_flash, spy_route
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention, self.moe.route = self.shipped

    def dropped(self) -> dict:
        """{kind: (dropped pairs, pairs)} over the run."""
        return {kind: (int(sum(int(d) for d, _ in v)), int(sum(n for _, n in v)))
                for kind, v in self.pairs.items() if v}


class _Ranges:
    """``record_function`` ranges around the attention sublayers (prefill
    and step) and, for MoE, the routing, dispatch, expert products and
    combine, for a profiler window; restored on exit."""

    MOE = ("route", "dispatch", "experts", "combine")

    def __init__(self, cfg):
        from repro_torch.models import layers, moe

        self.targets = [(layers, "attention_full", "attention"),
                        (layers, "attention_decode", "attention")]
        if cfg.family == "moe":
            self.targets += [(moe, f, f"moe.{f}") for f in self.MOE]
        self.names = tuple(dict.fromkeys(label for _, _, label in self.targets))
        self.saved = [(mod, f, getattr(mod, f)) for mod, f, _ in self.targets]

    def __enter__(self):
        from torch.profiler import record_function

        for (mod, f, label), (_, _, fn) in zip(self.targets, self.saved):
            def wrapped(*a, _fn=fn, _label=label, **kw):
                with record_function(_label):
                    return _fn(*a, **kw)
            setattr(mod, f, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, f, fn in self.saved:
            setattr(mod, f, fn)


def _zoo_run(torch, run: str, arch: str, layers, new: int) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import api

    dev = torch.device("cuda")
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(SEED), tp=1, device=dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _tensors(params))
    what = {"moe": f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, d_ff_expert "
                   f"{cfg.moe.d_ff_expert}" if cfg.moe else "",
            "encdec": f"{cfg.n_enc_layers} encoder layers, d_ff {cfg.d_ff}",
            "vlm": f"{cfg.n_patches} patches, d_ff {cfg.d_ff}",
            "ssm": f"an sLSTM block every {cfg.xlstm.slstm_every} layers" if cfg.xlstm else ""}[cfg.family]
    log(f"# zoo run {run}: {cfg.name} ({L} layers{' (cut)' if layers else ''}, d_model "
        f"{cfg.d_model}, {cfg.n_heads}q/{cfg.n_kv_heads}kv heads of {cfg.head_dim_}, "
        f"{what}, vocab {cfg.vocab}, {cfg.compute_dtype} compute), "
        f"{nparams / 1e6:.1f} M params ({nparams * 4 / 1e9:.2f} GB f32), init "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 20 + ord(run) - ord("a"))
    prompt = rng.integers(0, cfg.vocab, (ZOO_B, ZOO_PROMPT), dtype=np.int32)
    extra = _zoo_extra(cfg, ZOO_B, rng)
    zoo_generate(torch, cfg, params, prompt[:, :16], extra, 2)          # warm-up
    torch.cuda.synchronize()

    # the main path, counted: as a caller drives it
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    with _Spies(ZOO_B) as spies:
        tokens = zoo_generate(torch, cfg, params, prompt, extra, new)
    wall = time.perf_counter() - t0
    launches, routes = _counts(), _routes()
    peak = torch.cuda.max_memory_allocated()
    check(tokens.shape == (ZOO_B, new + 1) and tokens.dtype == np.int32,
          (tokens.shape, tokens.dtype))
    check(np.all((0 <= tokens) & (tokens < cfg.vocab)), "token out of range")
    want = _zoo_launches(cfg, prefills=1, steps=new)
    check(launches == want, f"zoo run {run}: launches {launches} != {want}")
    check_routes(routes, "flash_attention", f"zoo run {run} prefill (bf16)",
                 wgmma=want["flash_attention"])
    check_routes(routes, "rmsnorm", f"zoo run {run} (bf16)", vec=want["rmsnorm"])
    # DBRX's group of 6 at d = 128 exceeds the split body's q registers
    dec_route = "simt" if cfg.name == "dbrx-132b" else "split"
    check_routes(routes, "decode_attention", f"zoo run {run} decode",
                 **{dec_route: want["decode_attention"]})
    if cfg.family == "encdec":
        split = {True: L, False: cfg.n_enc_layers + L}
        check(spies.causal == split, f"seamless flash calls by causal {spies.causal} != {split}")
    drops = spies.dropped()

    # the same steps timed one by one, with their launch counts
    put = {k: torch.as_tensor(v, device=dev) for k, v in extra.items()}
    batch = {"tokens": torch.as_tensor(prompt, device=dev), **put}
    prefill, decode = make_prefill_step(cfg, tp=1), make_decode_step(cfg, tp=1)
    cache = api.init_cache(cfg, ZOO_B, ZOO_PROMPT + new + 1, tp=1, device=dev)
    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    delta = {k: v - before[k] for k, v in _counts().items()}
    check(delta == _zoo_launches(cfg, prefills=1, steps=0), f"prefill launches {delta}")
    step_ms, out = [], [tok]
    for _ in range(new):
        before = _counts()
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, {"token": tok})
        tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        delta = {k: v - before[k] for k, v in _counts().items()}
        check(delta == _zoo_launches(cfg, prefills=0, steps=1), f"step launches {delta}")
        out.append(tok)
    timed = torch.cat(out, dim=1).cpu().numpy()
    check(np.array_equal(timed, tokens), f"zoo run {run}: timed tokens != the counted run's")
    # the VLM's cache and positions cover the patches before the text
    first = ZOO_PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)
    check(int(cache["pos"]) == first + new, f"zoo run {run}: pos {int(cache['pos'])}")
    if cfg.family == "vlm":
        check(cache["k"].shape[2] == first + new + 1, f"vlm cache {tuple(cache['k'].shape)}")
    p50 = float(np.median(step_ms))
    drop_txt = "".join(f"; pairs dropped at capacity {cfg.moe.capacity_factor} in {kind} "
                       f"{d}/{n} = {d / n:.4f}" for kind, (d, n) in drops.items())
    log(f"# zoo run {run} ({cfg.name}): {ZOO_B} x {ZOO_PROMPT}-token prompts"
        f"{' + ' + ', '.join(f'{k} {tuple(v.shape[1:])}' for k, v in extra.items()) if extra else ''}"
        f", {new} new tokens each: generation {wall * 1e3:.1f} ms = "
        f"{ZOO_B * (new + 1) / wall:.1f} tokens/s; prefill {prefill_ms:.2f} ms, decode "
        f"step p50 {p50:.3f} ms (min {min(step_ms):.3f}, max {max(step_ms):.3f}); "
        f"launches {launches}; routes flash {routes['flash_attention']}, decode "
        f"{routes['decode_attention']}, rmsnorm {routes['rmsnorm']}"
        + (f"; flash calls causal/unmasked {spies.causal[True]}/{spies.causal[False]}"
           if cfg.family == "encdec" else "")
        + f"{drop_txt}; max_memory_allocated {peak / 2**20:.1f} MiB")

    # where the time goes: one prefill, then one decode step
    cache = api.init_cache(cfg, ZOO_B, ZOO_PROMPT + new + 1, tp=1, device=dev)
    with _Ranges(cfg) as ranges:
        profile_steps(torch, lambda: prefill(params, batch, cache), 1,
                      f"zoo run {run} prefill ({cfg.name})", ranges.names)
        profile_steps(torch, lambda: decode(params, cache, {"token": tok}), 1,
                      f"zoo run {run} decode step ({cfg.name})", ranges.names)

    result = {"launches": launches, "routes": routes, "prefill_ms": prefill_ms,
              "step_p50_ms": p50, "peak_mib": peak / 2**20, "drops": drops,
              "tokens_per_s": ZOO_B * (new + 1) / wall}
    if run != "b":
        result["gate_err"] = _zoo_gate(torch, cfg, params, rng)
    del params, cache
    torch.cuda.empty_cache()
    return result


def _zoo_gate(torch, cfg, params, rng) -> float:
    """The reference's serving contract in float32 (tests/test_models.py,
    5e-3): prefill + decode steps equal the teacher-forcing logits.  MoE at
    capacity E/k, which drops nothing (a float32 copy at 1.25 would drop
    other pairs at T than at T + 1); encdec with frames whose length is not
    ``enc_len_for`` of the cache's; xLSTM at the reference test's 16 tokens
    (see ``XLSTM_GATE_PROMPT``), then its mLSTM's chunked form against its
    recurrence."""
    import dataclasses

    from repro_torch.models import api

    dev = torch.device("cuda")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    if cfg.moe:
        cfg32 = dataclasses.replace(cfg32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    P, steps = ((XLSTM_GATE_PROMPT, XLSTM_GATE_STEPS) if cfg.family == "ssm"
                else (ZOO_PROMPT, 1))
    toks = rng.integers(0, cfg.vocab, (ZOO_GATE_B, P + steps), dtype=np.int32)
    extra = _zoo_extra(cfg, ZOO_GATE_B, rng, frames=ZOO_GATE_FRAMES)
    full = api.logits(cfg32, params, {"tokens": toks, **extra}, tp=1)
    check(torch.isfinite(full).all().item(), f"{cfg.name} float32 logits not finite")
    cache = api.init_cache(cfg32, ZOO_GATE_B, P + steps + 3, tp=1, device=dev)
    got, cache = api.prefill(cfg32, params, {"tokens": toks[:, :P], **extra}, cache, tp=1)
    errs = [(got[:, 0] - full[:, P - 1]).abs().max().item()]
    torch.testing.assert_close(got[:, 0], full[:, P - 1], rtol=5e-3, atol=5e-3)
    for t in range(P, P + steps):
        got, cache = api.decode(cfg32, params, cache, {"token": toks[:, t:t + 1]}, tp=1)
        errs.append((got[:, 0] - full[:, t]).abs().max().item())
        torch.testing.assert_close(got[:, 0], full[:, t], rtol=5e-3, atol=5e-3)
    if cfg.family == "encdec":
        check(cache["xk"].shape[2] == ZOO_GATE_FRAMES, "cross caches not replaced")
    if cfg.family == "ssm":
        _mlstm_recurrence_gate(torch, cfg32, params, rng)
    log(f"# zoo {cfg.name} float32 copy ({ZOO_GATE_B} x {P} tokens"
        f"{', capacity ' + str(cfg32.moe.capacity_factor) if cfg.moe else ''}"
        f"{', ' + ', '.join(f'{k} {v.shape[1:]}' for k, v in extra.items()) if extra else ''}"
        f", {steps} step(s)): prefill + decode == teacher forcing, max |err| "
        f"{max(errs):.3e} (tol 5e-3)")
    return max(errs)


def _mlstm_recurrence_gate(torch, cfg, params, rng) -> None:
    """The first mLSTM block at full width in float32 over ZOO_PROMPT
    tokens (four 128-chunks): its chunked form, output and final state,
    against ``mlstm_decode`` stepped token by token from the empty state."""
    from repro_torch.models import xlstm

    dev = torch.device("cuda")
    lp = params["layers"][0]
    x = torch.from_numpy(rng.standard_normal((ZOO_GATE_B, ZOO_PROMPT, cfg.d_model))
                         .astype(np.float32)).to(dev)
    full, state = xlstm.mlstm_block(cfg, lp, x, return_state=True)
    st = xlstm.init_cache(cfg, ZOO_GATE_B, 1, device=dev)["layers"][0]
    outs = []
    for t in range(ZOO_PROMPT):
        o, st = xlstm.mlstm_decode(cfg, lp, st, x[:, t:t + 1])
        outs.append(o)
    steps = torch.cat(outs, dim=1)
    err = (steps - full).abs().max().item()
    torch.testing.assert_close(steps, full, rtol=5e-3, atol=5e-3)
    for key in ("C", "n", "m"):
        torch.testing.assert_close(st[key], state[key], rtol=5e-3, atol=5e-3)
    log(f"# zoo xlstm float32: the first mLSTM block's chunked form over "
        f"{ZOO_GATE_B} x {ZOO_PROMPT} tokens == its recurrence stepped token by token, "
        f"max |err| {err:.3e} (tol 5e-3), final C, n, m too")


def phase_zoo(torch) -> dict:
    return {run: _zoo_run(torch, run, *spec) for run, spec in ZOO_RUNS.items()}


def dbrx_decode_timing(torch, flush) -> dict:
    """Row 2 at DBRX's decode step (configuration 10): q (8,48,1,128) bf16
    against the (8,521,8,128) float32 cache at pos 516, a GQA group of 6 at
    d = 128, which ``decode_route`` sends to the CUDA-core body
    (``"simt"``: the split body's q registers hold no group of 6 at d =
    128).  The wrapper's time (the simt body), its plain version, and
    ``scaled_dot_product_attention`` with ``enable_gqa`` and a ``kpos <=
    pos`` mask (q cast to float32, the cache's type), beside the bound:
    q read and o written once in bf16, the visible k and v rows read once
    in float32, over 3.35 TB/s; 4 d flops a visible (query, key) pair at
    the float32 rate."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention_kernel, decode_attention_plain, decode_route)

    dev = torch.device("cuda")
    (B, Hq, Hkv, S, d, pos), want = ZOO_DECODE_CASES[1]
    q = _randn(torch, (B, Hq, 1, d), torch.bfloat16, 48, dev)
    ck = _randn(torch, (B, S, Hkv, d), torch.float32, 49, dev)
    cv = _randn(torch, (B, S, Hkv, d), torch.float32, 50, dev)
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    pt = torch.tensor([pos], dtype=torch.int32, device=dev)
    route = decode_route(kt.dtype, d, Hq // Hkv, kt, vt)
    check(route == want == "simt", f"DBRX's decode shape routes to {route!r}")
    err = (decode_attention_kernel(q, kt, vt, pt).float()
           - decode_attention_plain(q, kt, vt, pt).float()).abs().max().item()
    visible = pos + 1
    nbytes = 2 * 2 * q.numel() + 2 * B * Hkv * visible * d * 4 + 4
    flops = 4 * B * Hq * visible * d
    bound, by = _bound(nbytes, flops, H100_FP32_FLOPS)
    mask = (torch.arange(S, device=dev) <= pos)[None, None, None, :]
    qf = q.float()
    return dict(
        ms=time_ms(torch, lambda: decode_attention_kernel(q, kt, vt, pt), 100, flush),
        plain_ms=time_ms(torch, lambda: decode_attention_plain(q, kt, vt, pt), 25, flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qf, kt, vt, attn_mask=mask, enable_gqa=True), 100, flush),
        library="sdpa (enable_gqa) with a kpos <= pos mask", route=route,
        bound_ms=bound, bound_by=by, max_abs_err=err,
        shape=f"q {tuple(q.shape)} bf16, cache {tuple(ck.shape)} f32, pos {pos}",
        work=f"{nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} MFLOP")


def phase_zoo_timing(torch) -> dict:
    """Rows 3 and 2 at the zoo's new shapes: the flash forward at phi-3's
    prefill (d = 96), seamless's cross-attention (T 512 against S 128,
    unmasked) and DBRX's prefill (d = 128, group 6), bf16; flash-decode at
    phi-3's step (q (8,32,1,96) bf16 against the (8,1121,32,96) float32
    cache) and at DBRX's (:func:`dbrx_decode_timing`); row 7 at phi-3's and
    DBRX's prefill rows."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain, rmsnorm_route

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    flush = l2_flush_buffer(torch)
    saved = _snapshot()
    out = {}
    T3 = ZOO_PATCHES + ZOO_PROMPT
    for key, (B, Hq, Hkv, T, S, d, causal) in {
            "flash_attention@phi3": (ZOO_B, 32, 32, T3, T3, 96, True),
            "flash_attention@seamless-cross": (ZOO_B, 16, 16, ZOO_PROMPT, ZOO_FRAMES, 64,
                                               False),
            "flash_attention@dbrx": (ZOO_B, 48, 8, ZOO_PROMPT, ZOO_PROMPT, 128, True)}.items():
        q = _randn(torch, (B, Hq, T, d), bf16, 40, dev)
        k = _randn(torch, (B, Hkv, S, d), bf16, 41, dev)
        v = _randn(torch, (B, Hkv, S, d), bf16, 42, dev)
        out[key] = flash_timing(torch, q, k, v, flush, 50, stats=False, causal=causal)

    B, Hq, d = ZOO_B, 32, 96
    S, pos = T3 + 33, T3 + 16
    q1 = _randn(torch, (B, Hq, 1, d), bf16, 43, dev)
    ck = _randn(torch, (B, S, Hq, d), f32, 44, dev)
    cv = _randn(torch, (B, S, Hq, d), f32, 45, dev)
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    pt = torch.tensor([pos], dtype=torch.int32, device=dev)
    visible = pos + 1
    nbytes = 2 * 2 * q1.numel() + 2 * B * Hq * visible * d * 4 + 4
    flops = 4 * B * Hq * visible * d
    bound, by = _bound(nbytes, flops, H100_FP32_FLOPS)
    mask = (torch.arange(S, device=dev) <= pos)[None, None, None, :]
    q1f = q1.to(f32)
    out["decode_attention@phi3"] = decode_timing(
        torch, q1, kt, vt, pt, flush, 100, bound, by,
        f"{nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} MFLOP",
        f"q {tuple(q1.shape)} bf16, cache {tuple(ck.shape)} f32, pos {pos}",
        lambda: F.scaled_dot_product_attention(q1f, kt, vt, attn_mask=mask))
    out["decode_attention@dbrx"] = dbrx_decode_timing(torch, flush)
    # RMSNorm at the widest new rows: phi-3's prefill (8 x 1088, 3072) and
    # DBRX's (8 x 512, 6144), bf16
    for key, (rows, D) in {"rmsnorm@phi3": (ZOO_B * T3, 3072),
                           "rmsnorm@dbrx": (ZOO_B * ZOO_PROMPT, 6144)}.items():
        x = _randn(torch, (rows, D), bf16, 46, dev)
        w = _randn(torch, (D,), f32, 47, dev)
        wb = w.to(bf16)
        err = (rmsnorm_kernel(x, w).float() - rmsnorm_plain(x, w).float()).abs().max().item()
        nbytes = 2 * 2 * x.numel() + 4 * w.numel()
        bound, by = _bound(nbytes, 4 * x.numel(), H100_FP32_FLOPS)
        out[key] = dict(
            ms=time_ms(torch, lambda: rmsnorm_kernel(x, w), 100, flush),
            plain_ms=time_ms(torch, lambda: rmsnorm_plain(x, w), 20, flush),
            library_ms=time_ms(torch, lambda: F.rms_norm(x, (D,), wb, 1e-6), 100, flush),
            bound_ms=bound, bound_by=by, max_abs_err=err, route=rmsnorm_route(x, w),
            library="F.rms_norm", shape=f"x ({rows}, {D}) bf16, w f32",
            work=f"{nbytes / 1e6:.3f} MB")
    _restore(saved)                         # timing launches are not the path's
    log_timing(out)
    return out


# ---------------------------------------------------------------------------
# phase 19: the other families train at full width (configuration 11)
# ---------------------------------------------------------------------------

def _family_launches(cfg) -> dict:
    """Each counted kernel's launches in one train step with remat: a
    rematerialised layer runs its forward twice (its norms, forwards with
    statistics and SSD scans), and no serving kernel (rows 1-3) runs."""
    L = cfg.n_layers
    out = dict.fromkeys(_counts(), 0)
    if cfg.family == "hybrid":       # each Mamba2 layer remat, the shared block not
        G = cfg.n_layers // cfg.ssm.shared_attn_every
        out.update(ssd_scan=2 * L, rmsnorm=2 * L + 2 * G + 1, flash_attention_fwd_stats=G,
                   flash_attention_dq=G, flash_attention_dkv=G)
    elif cfg.family == "encdec":     # LayerNorm; encoder, decoder self and cross
        n = cfg.n_enc_layers + 2 * L
        out.update(flash_attention_fwd_stats=2 * n, flash_attention_dq=n,
                   flash_attention_dkv=n)
    elif cfg.family == "ssm":        # a norm a block and ln_f; no attention, no remat
        out.update(rmsnorm=L + 1)
    else:                            # moe, vlm: the dense layer loop
        out.update(rmsnorm=4 * L + 1, flash_attention_fwd_stats=2 * L,
                   flash_attention_dq=L, flash_attention_dkv=L)
    return out


def _family_batches(cfg, seq: int, n: int, B: int = FAM_B) -> list:
    """n train batches: ``make_batch``'s (with the stubbed frames or
    patches) for encdec and vlm, ``TokenPipeline``'s for the others."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import api

    if cfg.family in ("encdec", "vlm"):
        shape = ShapeConfig("train", "train", seq, B)
        return [api.make_batch(cfg, shape, seed=SEED + i) for i in range(n)]
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=B, seed=SEED))
    return [data.batch_at(i) for i in range(n)]


class _TrainSpies:
    """Watchers on a counted train run, each restored on exit: calls of the
    plain versions (on the card each would be a fallback) and the trainable
    flash calls by (causal, S != T)."""

    def __init__(self):
        from repro_torch.kernels import flash_attention_bwd as fab
        from repro_torch.kernels import ops, rmsnorm, ssm_scan

        self.plain = [(fab, "flash_attention_fwd_stats_plain"),
                      (fab, "flash_attention_dq_plain"), (fab, "flash_attention_dkv_plain"),
                      (ssm_scan, "ssd_scan_plain"), (rmsnorm, "rmsnorm_plain")]
        self.saved = [(mod, n, getattr(mod, n)) for mod, n in self.plain]
        self.ops, self.shipped = ops, ops.flash_attention_trainable
        self.plain_calls, self.flash = {}, {}

    def __enter__(self):
        for mod, n, fn in self.saved:
            def call(*a, _n=n, _fn=fn, **kw):
                self.plain_calls[_n] = self.plain_calls.get(_n, 0) + 1
                return _fn(*a, **kw)
            setattr(mod, n, call)

        def flash(q, k, v, *, causal=True):
            key = ("causal" if causal else "unmasked") + (" S != T" if k.shape[2] != q.shape[2]
                                                          else "")
            self.flash[key] = self.flash.get(key, 0) + 1
            return self.shipped(q, k, v, causal=causal)

        self.ops.flash_attention_trainable = flash
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)
        self.ops.flash_attention_trainable = self.shipped


def _family_run(torch, run: str, arch: str, seq: int, layers) -> dict:
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ssd_scan_vjp
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    check(cfg.remat and cfg.compute_dtype == "bfloat16", (cfg.name, cfg.remat))
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(SEED), tp=1, device=dev)
    opt_state = adamw_init(params)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _tensors(params))
    log(f"# train run {run}: {cfg.name} ({cfg.n_layers} layers"
        f"{' (cut from ' + str(get_config(arch).n_layers) + ')' if layers else ''}, d_model "
        f"{cfg.d_model}, {cfg.n_heads}q/{cfg.n_kv_heads}kv heads of {cfg.head_dim_}, vocab "
        f"{cfg.vocab}), {nparams / 1e6:.1f} M params, float32 masters and AdamW moments "
        f"({16 * nparams / 1e9:.1f} GB with the gradients), init {time.perf_counter() - t0:.2f}"
        f" s; {held / 2**20:.0f} MiB held by earlier phases")
    step = make_train_step(cfg, tp=1, opt=AdamWConfig(lr=FAM_LR), total_steps=10,
                           clip_norm=1.0)
    batches = _family_batches(cfg, seq, FAM_STEPS + 1)

    # the main path, counted: FAM_STEPS steps as a trainer takes them
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, step_ms = [], []
    with _TrainSpies() as spies:
        _reset_counts()
        ssd_scan_vjp.calls = 0
        for i in range(FAM_STEPS):
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batches[i])
            metrics.append((float(m["loss"]), float(m["grad_norm"])))     # synchronises
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches, routes, vjp_calls = _counts(), _routes(), ssd_scan_vjp.calls
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(v) for mt in metrics for v in mt),
          f"train run {run}: non-finite loss or grad norm {metrics}")
    want = {k: FAM_STEPS * n for k, n in _family_launches(cfg).items()}
    check(launches == want, f"train run {run}: launches {launches} != {want}")
    want_vjp = FAM_STEPS * cfg.n_layers if cfg.family == "hybrid" else 0
    check(vjp_calls == want_vjp, f"train run {run}: {vjp_calls} SSD VJP calls, want {want_vjp}")
    for name in ("flash_attention_fwd_stats", "flash_attention_dq", "flash_attention_dkv"):
        check_routes(routes, name, f"train run {run} (bf16, d = {cfg.head_dim_})",
                     wgmma=want[name])
    check_routes(routes, "rmsnorm", f"train run {run} (bf16)", vec=want["rmsnorm"])
    check_routes(routes, "ssd_scan", f"train run {run} (bf16)", mma=want["ssd_scan"])
    check(not spies.plain_calls, f"train run {run}: plain versions on the card "
          f"{spies.plain_calls}")
    if cfg.family == "encdec":
        E, L = cfg.n_enc_layers, cfg.n_layers
        split = {"unmasked": 2 * FAM_STEPS * E, "causal": 2 * FAM_STEPS * L,
                 "unmasked S != T": 2 * FAM_STEPS * L}
        check(spies.flash == split, f"seamless flash calls {spies.flash} != {split}")
    p50 = float(np.median(step_ms))
    tokens = FAM_B * seq
    log(f"# train run {run} ({cfg.name}): {FAM_STEPS} steps of {FAM_B} x {seq} tokens"
        f"{' + ' + str(cfg.n_patches) + ' patches' if cfg.family == 'vlm' else ''}"
        f"{' + ' + str(ZOO_FRAMES) + ' frames' if cfg.family == 'encdec' else ''}: step "
        f"ms {[round(t, 1) for t in step_ms]}, p50 {p50:.1f} = {tokens / p50 * 1e3:.0f} "
        f"tokens/s; losses {[round(a, 4) for a, _ in metrics]}, grad norms "
        f"{[round(b, 4) for _, b in metrics]}; launches {launches}, SSD VJP calls "
        f"{vjp_calls}, flash calls {spies.flash}; routes "
        f"{ {n: routes[n] for n in ROUTED if sum(routes[n].values())} }; "
        f"max_memory_allocated {peak / 2**20:.0f} MiB")

    # where the time goes: one more step under the profiler
    saved = _snapshot()
    profile_steps(torch, lambda: step(params, opt_state, batches[FAM_STEPS]), 1,
                  f"train run {run} step ({cfg.name}, {FAM_B} x {seq}"
                  f"{'' if cfg.family == 'ssm' else ', remat'})")
    _restore(saved)
    del params, opt_state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "routes": routes, "vjp_calls": vjp_calls, "p50_ms": p50,
            "step_ms": step_ms, "tokens_per_s": tokens / p50 * 1e3, "peak_mib": peak / 2**20,
            "losses": [a for a, _ in metrics], "params_m": nparams / 1e6,
            "gate_err": _family_gate(torch, arch)}


def _family_gate(torch, arch: str) -> float:
    """The family's reduced config in float32 with remat, tp=1, on the card
    against the CPU: the loss at 1e-4, and one train step's grad norm and
    the gradients' global relative error at 1e-4, as configuration 6's
    gate, but for the hybrid at 2e-4, the tolerance of its float32 logits
    on the card (tests/test_torch_hybrid.py): at this init its gradient is
    ill-conditioned (grad norm 505, 498 of it the embedding's), so the
    card's plain float32 ops alone part from the CPU's by 3.9e-5 in the
    grad norm, and the SSD body's split-TF32 float32 products bring that
    to 1.04e-4.  Returns the global relative error; the largest
    per-leaf one is printed."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device("cuda")
    cfg = dataclasses.replace(reduced_config(arch), compute_dtype="float32", remat=True)
    cpu = api.init(cfg, torch.Generator().manual_seed(SEED), tp=1, device="cpu")
    card = api._build((k, v.to(dev)) for k, v in api._leaves(cpu))
    seq = 16 if cfg.family == "ssm" else 32         # xLSTM's chaos (XLSTM_GATE_PROMPT)
    batch = _family_batches(cfg, seq, 1, B=2)[0]
    saved = _snapshot()
    lc, gc_ = loss_and_grads(cfg, cpu, batch, tp=1)
    lg, gg = loss_and_grads(cfg, card, batch, tp=1)
    want = [a for _, a in api._leaves(gc_)]
    got = [b.cpu() for _, b in api._leaves(gg)]
    rel = _grad_rel_err(torch, got, want)
    leaf = max((g - w).abs().max().item() / max(w.abs().max().item(), 1e-12)
               for g, w in zip(got, want))
    check(all(torch.isfinite(g).all().item() for g in got), f"{arch}: non-finite gradient")
    tol = 2e-4 if cfg.family == "hybrid" else 1e-4
    check(rel <= tol, f"{arch} reduced float32: card vs CPU gradients {rel:.3e}")
    check(abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc)), (float(lg), float(lc)))
    step = make_train_step(cfg, tp=1, opt=AdamWConfig(lr=FAM_LR), total_steps=10)
    _, _, mc = step(cpu, adamw_init(cpu), batch)
    _, _, mg = step(card, adamw_init(card), batch)
    for key, t in (("loss", 1e-4), ("grad_norm", tol)):
        check(abs(float(mg[key]) - float(mc[key])) <= t * abs(float(mc[key])),
              (arch, key, float(mg[key]), float(mc[key])))
    _restore(saved)
    log(f"# {cfg.name} float32 (remat, 2 x {seq}): card == CPU (loss {float(lg):.6f} / "
        f"{float(lc):.6f}, gradients' global relative error {rel:.2e}, tol {tol:.0e}; largest "
        f"per leaf {leaf:.2e} of the leaf's max; step loss within 1e-4, grad norm "
        f"{float(mg['grad_norm']):.4f} / {float(mc['grad_norm']):.4f} within {tol:.0e})")
    return rel


def phase_families(torch) -> dict:
    return {run: _family_run(torch, run, *spec) for run, spec in FAM_RUNS.items()}


def ssd_vjp_work(B, T, H, P, N, Q, x_bytes):
    """(bytes, flops) of one SSD VJP: x, dt, A, B, C and dy read once, dx,
    ddt, dA, dB and dC written once; per (b, head, chunk of n rows) the
    products 4 n^2 P (the intra-chunk dx.dt and dM) and 10 n N P (the local
    state, its gradient's two products, and the inter-chunk C.S_prev
    terms), per (b, chunk) 6 n^2 N (C.B^T, dG.B, dG^T.C)."""
    nbytes = (3 * B * T * H * P * x_bytes + 2 * B * T * H * 4 + 2 * H * 4
              + 4 * B * T * N * x_bytes)
    flops = 0
    for t0 in range(0, T, Q):
        n = min(Q, T - t0)
        flops += B * H * (4 * n * n * P + 10 * n * N * P) + B * 6 * n * n * N
    return nbytes, flops


def phase_families_timing(torch) -> dict:
    """Rows 4-6 at phase 19's new training shapes (``FAM_ATTN``, bf16)
    against their bounds, their plain versions and
    ``scaled_dot_product_attention``'s forward (row 4) and backward (rows 5
    and 6 together); the SSD VJP at the Zamba2 shape (8,1024,80,64) bf16,
    Q 256, beside row 8's forward there, against its bound and autograd
    through the plain version; and the VJP on the card against the VJP on
    the CPU at the float32 SSD gate shapes, the steep decays included."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.ssm_scan import ssd_scan_kernel, ssd_scan_plain, ssd_scan_vjp

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    flush = l2_flush_buffer(torch)
    saved = _snapshot()
    calls = ssd_scan_vjp.calls
    out = {}
    for key, (B, Hq, Hkv, T, S, d, causal) in FAM_ATTN.items():
        q, do = (_randn(torch, (B, Hq, T, d), bf16, s, dev) for s in (60, 61))
        k, v = (_randn(torch, (B, Hkv, S, d), bf16, s, dev) for s in (62, 63))
        out[f"flash_attention_fwd_stats@{key}"] = flash_timing(
            torch, q, k, v, flush, 20, stats=True, causal=causal)
        o, m, l = fab.flash_attention_fwd_stats_kernel(q, k, v, causal=causal)
        delta = (do.float() * o.float()).sum(-1)
        bwd = (q, k, v, do, m, l, delta)
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                 enable_gqa=True)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), do, retain_graph=True), 20, flush)
        pairs = B * Hq * (T * (T + 1) // 2 if causal else T * S)
        qb, kb, sb = q.numel() * 2, k.numel() * 2, B * Hq * T * 4
        shape = (f"q {tuple(q.shape)}, k,v {tuple(k.shape)} bf16 "
                 f"{'causal' if causal else 'unmasked'}")
        for name, nbytes, flops, kern, plain in (
                ("flash_attention_dq", 3 * qb + 2 * kb + 3 * sb, 6 * d * pairs,
                 lambda: (fab.flash_attention_dq_kernel(*bwd, causal=causal),),
                 lambda: (fab.flash_attention_dq_plain(*bwd, causal=causal),)),
                ("flash_attention_dkv", 2 * qb + 4 * kb + 3 * sb, 8 * d * pairs,
                 lambda: fab.flash_attention_dkv_kernel(*bwd, causal=causal),
                 lambda: fab.flash_attention_dkv_plain(*bwd, causal=causal))):
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(kern(), plain()))
            check(err <= 2e-2 * max(w.float().abs().max().item() for w in plain()) + 2e-2,
                  f"{name} at {shape}: |err| {err}")
            bound, by = _bound(nbytes, flops, H100_BF16_FLOPS)
            out[f"{name}@{key}"] = dict(
                ms=time_ms(torch, kern, 20, flush), plain_ms=time_ms(torch, plain, 3, flush),
                library_ms=lib_bwd, library="sdpa backward (dq, dk, dv)", bound_ms=bound,
                bound_by=by, max_abs_err=err, route=fab.flash_bwd_route(bf16, d), shape=shape,
                work=f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP")
        del qg, kg, vg, lib_out

    # the SSD VJP beside row 8's forward at the Zamba2 shape; the blocks the
    # attention timing cached go back first, so no allocation of the timed
    # calls waits on the device to release one
    torch.cuda.empty_cache()
    case = (HYBRID_B, HYBRID_PROMPT, SSD_H, SSD_P, SSD_N, SSD_Q)
    args = _ssd_inputs(torch, case, bf16, 64, dev)
    dy = _randn(torch, args[0].shape, bf16, 65, dev)
    got = ssd_scan_vjp(*args, dy, chunk=SSD_Q)
    leaves = [a.detach().clone().requires_grad_() for a in args]
    y = ssd_scan_plain(*leaves, chunk=SSD_Q)
    want = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    rel = max((g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
              for g, w in zip(got, want))
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    check(rel <= 2e-2, f"SSD VJP vs autograd through the plain version: {rel:.3e}")
    nbytes, flops = ssd_vjp_work(*case, x_bytes=2)
    bound, by = _bound(nbytes, flops, H100_TF32X3_FLOPS)
    # the VJP and autograd's backward launch ~100 kernels a call: two calls
    # a chunk keep the enqueue inside the launch queue
    out["ssd_scan_vjp@zamba2"] = dict(
        ms=time_ms(torch, lambda: ssd_scan_vjp(*args, dy, chunk=SSD_Q), 10, flush, chunk=2),
        forward_ms=time_ms(torch, lambda: ssd_scan_kernel(*args, chunk=SSD_Q), 20, flush),
        plain_ms=time_ms(torch, lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True),
                         4, flush, chunk=2),
        library_ms=None, bound_ms=bound, bound_by=by, max_abs_err=err, max_rel_err=rel,
        route="torch ops (float32)", plain="autograd through the plain version",
        shape=f"x {tuple(args[0].shape)} bf16, B, C {tuple(args[3].shape)} bf16, "
              f"chunk {SSD_Q}",
        work=f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP at three TF32 terms")
    del leaves, y, want, got

    # the VJP on the card against the VJP on the CPU, float32
    worst = {}
    for case, a_scale in ([(c, 1.0) for c in SSD_CASES[4:6]]
                          + [(c, SSD_OVERFLOW_A) for c in SSD_OVERFLOW_CASES]):
        args = _ssd_inputs(torch, case, torch.float32, 66, dev, a_scale)
        dy = _randn(torch, args[0].shape, torch.float32, 67, dev)
        card = ssd_scan_vjp(*args, dy, chunk=case[5])
        cpu = ssd_scan_vjp(*(a.cpu() for a in args), dy.cpu(), chunk=case[5])
        exact = ssd_scan_vjp(*(a.cpu().double() for a in args), dy.cpu().double(),
                             chunk=case[5])
        for name, g, w, e in zip(("dx", "ddt", "dA", "dB", "dC"), card, cpu, exact):
            g = g.cpu()
            check(torch.isfinite(g).all().item(), f"SSD VJP {case}: non-finite {name}")
            top = max(w.abs().max().item(), 1e-30)
            err = (g - w).abs().max().item() / top
            if name == "dA" and a_scale != 1.0:
                # dA at the steep decays is the reversed cumsum of terms that
                # dwarf their sum: float32 keeps about two digits of it on
                # either device, so each is held to the float64 VJP, the
                # card at most twice as far as the CPU
                far = (g.double() - e).abs().max().item()
                check(far <= 2 * (w.double() - e).abs().max().item() + 1e-6 * top,
                      f"SSD VJP card vs CPU {case} A x {a_scale}: dA {far:.3e} from float64")
            else:
                check(err <= 1e-4, f"SSD VJP card vs CPU {case} A x {a_scale}: {name} "
                      f"{err:.3e}")
            worst[name] = max(worst.get(name, 0.0), err)
    ssd_scan_vjp.calls = calls
    _restore(saved)                         # timing launches are not the path's
    log_timing(out)
    log(f"# SSD VJP at {out['ssd_scan_vjp@zamba2']['shape']}: "
        f"{out['ssd_scan_vjp@zamba2']['ms']:.4f} ms beside row 8's forward "
        f"{out['ssd_scan_vjp@zamba2']['forward_ms']:.4f} ms; card vs CPU at the float32 gate "
        f"shapes (steep decays included), largest error of each gradient's max {worst}")
    out["ssd_scan_vjp@zamba2"]["card_vs_cpu"] = worst
    return out


# ---------------------------------------------------------------------------
# phase 20: sharded training over torch.distributed (configuration 12)
# ---------------------------------------------------------------------------

SPMD_WORLD = 2                   # ranks sharing the one card (route "shared")
SPMD_TIMEOUT = 600
EP_ARCH, EP_B, EP_T, EP_CAPS = "granite-moe-1b-a400m", 8, 1024, (8.0, 1.25)
PP_ARCH, PP_M, PP_T = "smollm-360m", 8, 512      # 2 stages of 16 layers, microbatch 1
# depth cut 24 -> 8: each uncut step's 144 all-to-alls through gloo took
# 17-28 s, and phase 21 needs the script's time
SH_ARCH, SH_STEPS, SH_LAYERS = "granite-moe-1b-a400m", 3, 8
EP_HOT, EP_HOT_SCALE = 4, 10.0   # (a)'s router: 4 experts' columns 10x, so 1.25 drops pairs
BF16_TOL = 2e-2


def _rel(torch, got, want) -> float:
    """The global relative (L2) error of ``got`` against ``want``."""
    return _grad_rel_err(torch, [got], [want])


def _ep_inputs(torch, dev, cfg):
    m = cfg.moe
    D, E, F = cfg.d_model, m.num_experts, m.d_ff_expert
    gen = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    router = randn(D, E) * 0.02
    router[:, :EP_HOT] *= EP_HOT_SCALE
    w = {"router": router, "wg": randn(E, D, F) / D ** 0.5,
         "wu": randn(E, D, F) / D ** 0.5, "wd": randn(E, F, D) / F ** 0.5}
    x = randn(EP_B, EP_T, D).to(torch.bfloat16)
    ct = randn(EP_B, EP_T, D).to(torch.bfloat16)
    return w, x, ct


def _spmd_ep_layer(torch, mesh, tag: str) -> dict:
    """(a): one Granite MoE layer's experts, expert-parallel over the mesh's
    ``model`` axis, against ``moe_block`` on this rank at capacity 8.0
    (forward and backward), then the per-sender drops at 1.25.  The router
    favours EP_HOT experts, so 1.25 drops pairs: the drops ``moe_block_ep``
    made are held against a count from the routing of the rank's slice,
    each expert's pairs beyond ``_capacity(cfg, N_local)``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as shd

    dev = mesh.device
    base = get_config(EP_ARCH)
    w, x, ct = _ep_inputs(torch, dev, base)
    specs = {"router": shd.P(None, None), "wg": shd.P("model", "data", None),
             "wu": shd.P("model", "data", None), "wd": shd.P("model", None, "data")}
    local = shd.shard_tree(mesh, w, specs)
    out = {}
    for cap in EP_CAPS:
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=cap))
        seen, real_route = [], moe.route

        def spy(cfg_, lp_, xf):
            res = real_route(cfg_, lp_, xf)
            seen.append((xf.shape[0], res[1], int(res[3].sum())))
            return res

        leaves = {k: v.clone().requires_grad_() for k, v in local.items()}
        xl = x.clone().requires_grad_()
        lp = {"router": leaves["router"], "experts": {k: leaves[k] for k in ("wg", "wu", "wd")}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moe.route = spy
        try:
            y = moe.moe_block_ep(cfg, lp, xl, mesh)
        finally:
            moe.route = real_route
        n_local = EP_B // mesh.shape["data"] * EP_T
        n_pairs = n_local * cfg.moe.top_k
        n_seen, top_i, n_kept = seen[0]
        check(n_seen == n_local, f"{tag} EP routed {n_seen} tokens, not its slice's {n_local}")
        if cap != 8.0:
            torch.cuda.synchronize()
            out[f"ep_fwd_ms@{cap}"] = (time.perf_counter() - t0) * 1e3
            per_expert = torch.bincount(top_i.reshape(-1), minlength=cfg.moe.num_experts)
            want = int((per_expert - moe._capacity(cfg, n_local)).clamp(min=0).sum())
            out[f"drops@{cap}"] = n_pairs - n_kept
            check(n_pairs - n_kept == want > 0,
                  f"{tag} EP at capacity {cap}: {n_pairs - n_kept} drops, the slice's "
                  f"routing counts {want} (and must drop some)")
            continue
        (y.float() * ct.float()).sum().backward()
        torch.cuda.synchronize()
        out["ep_fwd_bwd_ms"] = (time.perf_counter() - t0) * 1e3
        check(n_kept == n_pairs, f"{tag} EP at capacity 8.0 dropped {n_pairs - n_kept} pairs")
        full = {k: v.clone().requires_grad_() for k, v in w.items()}
        xr = x.clone().requires_grad_()
        yr = moe.moe_block(cfg, {"router": full["router"],
                                 "experts": {k: full[k] for k in ("wg", "wu", "wd")}}, xr)
        (yr.float() * ct.float()).sum().backward()
        grads = shd.gather_tree(mesh, {k: leaves[k].grad for k in specs}, specs)
        errs = {"y": _rel(torch, y, yr), "x": _rel(torch, xl.grad, xr.grad)}
        errs.update({k: _rel(torch, grads[k], full[k].grad) for k in specs})
        check(max(errs.values()) <= BF16_TOL,
              f"{tag} EP layer vs moe_block (bf16, capacity 8.0): {errs}")
        out["errs"] = errs
        del y, yr, grads, full, xr
    return out


def _pipeline_check(torch, pmesh) -> dict:
    """(b): SmolLM-360M's 32 layers at full width as 2 stages of 16, 8
    microbatches of 1 x 512 in bf16, forward and every stage weight's
    gradient against the 32 layers applied in sequence on this rank."""
    from repro_torch.configs import get_config
    from repro_torch.models import dense
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.pipeline import pipeline_apply, stage_split

    dev = pmesh.device
    cfg = get_config(PP_ARCH)
    dims = dense._dims(cfg, 1)
    S = pmesh.shape["pod"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layers = dense.init(cfg, gen, tp=1, device=dev)["layers"]
    x = (torch.randn(PP_M, 1, PP_T, cfg.d_model, generator=gen, device=dev)
         .to(torch.bfloat16))
    ct = torch.randn(PP_M, 1, PP_T, cfg.d_model, generator=gen, device=dev)

    def run_layers(stack, h):
        cast = tree_map(lambda t: t.to(torch.bfloat16), stack)
        for lp in dense.unstack_layers({"layers": cast}, tree_leaves(cast)[0].shape[0]):
            h = dense._layer_fwd(cfg, dims, h, lp)[0]
        return h

    spec = tree_map(lambda _: shd.P("pod"), layers)
    local = tree_map(lambda t: t.requires_grad_(),
                     shd.shard_tree(pmesh, stage_split(layers, S), spec))
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline_apply(run_layers, local, x, mesh=pmesh, axis="pod")
    (out.float() * ct).sum().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches, routes = _counts(), _routes()
    # the sequential reference: all 32 layers on this rank, the microbatches
    # as one batch
    full = tree_map(lambda t: t.detach().clone().requires_grad_(), layers)
    ref = run_layers(full, x.reshape(PP_M, PP_T, cfg.d_model)).reshape(out.shape)
    (ref.float() * ct).sum().backward()
    me, per = pmesh.axis_index("pod"), cfg.n_layers // S
    got = [t.grad[0] for t in tree_leaves(local)]
    want = [t.grad[me * per:(me + 1) * per] for t in tree_leaves(full)]
    errs = {"out": _rel(torch, out, ref), "grads": _grad_rel_err(torch, got, want)}
    check(max(errs.values()) <= BF16_TOL, f"pipeline vs sequential (bf16): {errs}")
    L = per
    want_launch = dict.fromkeys(launches, 0)
    want_launch.update(rmsnorm=2 * L * (PP_M + S - 1), flash_attention_fwd_stats=L * (PP_M + S - 1),
                       flash_attention_dq=L * (PP_M + S - 1),
                       flash_attention_dkv=L * (PP_M + S - 1))
    check(launches == want_launch, f"pipeline stage launches {launches} != {want_launch}")
    return {"errs": errs, "ms": ms, "launches": launches, "routes": routes}


def _sharded_step(torch, mesh) -> dict:
    """(c): Granite MoE on the (1, 2) mesh, tensor-parallel attention and
    expert-parallel experts: SH_STEPS counted steps of 8 x 1024 tokens, a
    profiled step (its collectives read from the trace), and the reduced
    float32 gate."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step, param_layout
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding as shd

    dev, tp = mesh.device, mesh.shape["model"]
    cfg = dataclasses.replace(get_config(SH_ARCH), n_layers=SH_LAYERS)
    t0 = time.perf_counter()
    full = api.init(cfg, torch.Generator(device=dev).manual_seed(SEED), tp=tp, device=dev)
    specs = param_layout(cfg, full, moe_ep=True)
    params = shd.shard_tree(mesh, full, specs)
    n_full = sum(t.numel() for t in _tensors(full))
    n_local = sum(t.numel() for t in _tensors(params))
    del full
    gc.collect()
    torch.cuda.empty_cache()
    opt_state = adamw_init(params)
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, tp=tp, opt=AdamWConfig(lr=FAM_LR), total_steps=10,
                           mesh=mesh, moe_ep=True)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=EP_T, global_batch=EP_B,
                                    seed=SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics, step_ms = [], []
    with _TrainSpies() as spies:
        for i in range(SH_STEPS):
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, data.batch_at(i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches, routes = _counts(), _routes()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(v) for mt in metrics for v in mt), f"sharded step: {metrics}")
    check(not spies.plain_calls, f"sharded step: plain versions on the card "
          f"{spies.plain_calls}")
    want = {k: SH_STEPS * n for k, n in _family_launches(cfg).items()}
    check(launches == want, f"sharded step: launches {launches} != {want}")
    for name in ("flash_attention_fwd_stats", "flash_attention_dq", "flash_attention_dkv"):
        check_routes(routes, name, "sharded step (bf16, d = 64)", wgmma=want[name])
    check_routes(routes, "rmsnorm", "sharded step (bf16)", vec=want["rmsnorm"])

    # one more step under the profiler
    saved = _snapshot()
    prof: dict = {}
    profile_steps(torch, lambda: step(params, opt_state, data.batch_at(SH_STEPS)), 1,
                  f"sharded train step ({cfg.name}, rank {torch.distributed.get_rank()})",
                  into=prof)
    _restore(saved)
    del params, opt_state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "p50_ms": float(np.median(step_ms)),
            "losses": [a for a, _ in metrics], "grad_norms": [b for _, b in metrics],
            "peak_mib": peak / 2**20, "launches": launches, "routes": routes,
            "params_full_m": n_full / 1e6, "params_local_m": n_local / 1e6,
            "init_s": init_s, "n_layers": cfg.n_layers, "profile": prof,
            "gate": _sharded_gate(torch, mesh)}


def _sharded_gate(torch, mesh) -> dict:
    """The reduced Granite MoE in float32 with remat on the same mesh on the
    card against the one-rank step on the CPU: the loss and the gradients'
    global relative error at 1e-4, and one train step's loss and grad norm
    at 1e-4 (configuration 11's gate)."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import loss_and_grads, make_train_step, param_layout
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.tree import tree_map
    from repro_torch.parallel import sharding as shd

    dev, tp = mesh.device, mesh.shape["model"]
    cfg = dataclasses.replace(reduced_config(SH_ARCH), compute_dtype="float32", remat=True)
    cpu = api.init(cfg, torch.Generator().manual_seed(SEED), tp=tp, device="cpu")
    batch = _family_batches(cfg, 32, 1, B=2)[0]
    specs = param_layout(cfg, cpu, moe_ep=True)
    card = tree_map(lambda t: t.to(dev), shd.shard_tree(mesh, cpu, specs))
    saved = _snapshot()
    lc, gc_ = loss_and_grads(cfg, cpu, batch, tp=tp)
    lg, gg = loss_and_grads(cfg, card, batch, tp=tp, mesh=mesh, moe_ep=True)
    gg = shd.gather_tree(mesh, gg, specs)
    want = [a for _, a in api._leaves(gc_)]
    got = [b.cpu() for _, b in api._leaves(gg)]
    rel = _grad_rel_err(torch, got, want)
    check(rel <= 1e-4, f"sharded reduced float32: card vs CPU gradients {rel:.3e}")
    check(abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc)), (float(lg), float(lc)))
    kw = dict(tp=tp, opt=AdamWConfig(lr=FAM_LR), total_steps=10)
    _, _, mc = make_train_step(cfg, **kw)(cpu, adamw_init(cpu), batch)
    _, _, mg = make_train_step(cfg, mesh=mesh, moe_ep=True, **kw)(card, adamw_init(card), batch)
    for key in ("loss", "grad_norm"):
        check(abs(float(mg[key]) - float(mc[key])) <= 1e-4 * abs(float(mc[key])),
              ("sharded gate", key, float(mg[key]), float(mc[key])))
    _restore(saved)
    return {"grad_rel": rel, "loss": (float(lg), float(lc)),
            "grad_norm": (float(mg["grad_norm"]), float(mc["grad_norm"]))}


def _compressed_check(torch, mesh) -> dict:
    """(d): compressed_psum of each rank's 2^20 float32 gradient over the
    ranks: the mean within the reference test's bound (two quantization
    steps of the largest magnitude)."""
    from repro_torch.runtime.fault_tolerance import compressed_psum

    dev, n = mesh.device, mesh.size("data") * mesh.size("model")
    g_all = [torch.randn(1 << 20, generator=torch.Generator(device=dev).manual_seed(SEED + r),
                         device=dev) for r in range(n)]
    me = torch.distributed.get_rank()
    with mesh:
        got, err = compressed_psum({"g": g_all[me]}, "model")
    true = torch.stack(g_all).mean(0)
    scale = float(torch.stack(g_all).abs().max()) / 127.0
    dev_max = float((got["g"] - true).abs().max())
    check(dev_max <= scale * 2 + 1e-5, f"compressed_psum: {dev_max} > {scale * 2 + 1e-5}")
    return {"max_abs_err": dev_max, "bound": scale * 2 + 1e-5}


def _spmd_rank() -> dict:
    """One rank of phase 20's shared world: (d), (a), (b), (c)."""
    import torch

    from repro_torch.parallel import spmd

    mesh = spmd.Mesh((1, SPMD_WORLD), ("data", "model"))
    rank = torch.distributed.get_rank()
    out = {"device": str(mesh.device), "backend": mesh.backend}
    out["compressed_psum"] = _compressed_check(torch, mesh)
    out["ep"] = _spmd_ep_layer(torch, mesh, f"rank {rank}")
    out["pipeline"] = _pipeline_check(torch, spmd.Mesh((SPMD_WORLD,), ("pod",)))
    torch.cuda.empty_cache()
    out["train"] = _sharded_step(torch, mesh)
    out["collectives_by_route"] = {k: dict(v) for k, v in spmd.collectives_by_route.items()}
    return out


def _nccl_rank() -> dict:
    """(e): (a)'s layer in a one-rank NCCL world, and one all-reduce (run
    where the ranks of the phase share a card, so that the ``nccl`` route is
    launched once)."""
    import torch

    from repro_torch.parallel import spmd

    mesh = spmd.Mesh((1, 1), ("data", "model"))
    out = {"device": str(mesh.device), "backend": mesh.backend,
           "ep": _spmd_ep_layer(torch, mesh, "nccl rank 0")}
    x = torch.ones(4, device=mesh.device)
    torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    check(torch.equal(x, torch.ones_like(x)), "one-rank NCCL all-reduce")
    return out


def phase_sharded(torch) -> dict:
    """Phase 20: configuration 12, sharded training on SPMD_WORLD ranks: on
    one card they share it through gloo (route ``"shared"``) and a one-rank
    NCCL world follows; with a card a rank they run on NCCL."""
    import gc

    from repro_torch.parallel import spmd

    gc.collect()
    torch.cuda.empty_cache()
    log(f"# phase 20: the parent holds {torch.cuda.memory_allocated() / 2**20:.0f} MiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**20:.0f} MiB reserved after "
        f"empty_cache")
    cards = torch.cuda.device_count()
    route = "nccl" if SPMD_WORLD <= cards else "shared"
    check(spmd.spmd_route(SPMD_WORLD, "cuda") == route,
          f"{SPMD_WORLD} ranks on {cards} card(s) are not {route!r}")
    t0 = time.perf_counter()
    ranks = spmd.run_spmd(_spmd_rank, SPMD_WORLD, device="cuda", timeout=SPMD_TIMEOUT)
    shared_s = time.perf_counter() - t0
    nccl, nccl_s = None, 0.0
    if route == "shared":
        t0 = time.perf_counter()
        nccl = spmd.run_spmd(_nccl_rank, 1, device="cuda", timeout=SPMD_TIMEOUT)[0]
        nccl_s = time.perf_counter() - t0
        check(nccl["backend"] == "nccl", nccl["backend"])
    want_routes = ({"shared": SPMD_WORLD, "nccl": 1} if route == "shared"
                   else {"nccl": SPMD_WORLD})
    check(dict(spmd.ranks_by_route) == want_routes,
          f"ranks_by_route {dict(spmd.ranks_by_route)} != {want_routes}")
    want_rank = [("gloo", "cuda:0") if route == "shared" else ("nccl", f"cuda:{r}")
                 for r in range(SPMD_WORLD)]
    check([(r["backend"], r["device"]) for r in ranks] == want_rank,
          [(r["backend"], r["device"]) for r in ranks])
    nan = float("nan")
    for r, res in enumerate(ranks):
        t = res["train"]
        prof = t["profile"]
        wall, coll = prof.get("wall_ms"), prof.get("coll_host_ms")
        log(f"# rank {r}: EP layer (a) errors {res['ep']['errs']}, fwd+bwd "
            f"{res['ep']['ep_fwd_bwd_ms']:.1f} ms, per-sender drops at 1.25: "
            f"{res['ep']['drops@1.25']} of {EP_B * EP_T * 8} pairs; pipeline (b) errors "
            f"{res['pipeline']['errs']}, {res['pipeline']['ms']:.1f} ms fwd+bwd; "
            f"compressed_psum (d) {res['compressed_psum']}")
        log(f"# rank {r}: sharded step (c) {t['n_layers']} layers, {t['params_local_m']:.1f} "
            f"of {t['params_full_m']:.1f} M params on this rank, init {t['init_s']:.1f} s; "
            f"step ms {[round(x, 1) for x in t['step_ms']]}, p50 {t['p50_ms']:.1f} = "
            f"{EP_B * EP_T / t['p50_ms'] * 1e3:.0f} tokens/s (both ranks together); losses "
            f"{[round(x, 4) for x in t['losses']]}; peak {t['peak_mib']:.0f} MiB; profiled "
            f"step wall {wall or nan:.1f} ms, device busy "
            f"{prof.get('busy_ms', nan):.1f} ms, idle {prof.get('idle', nan):.3f}; "
            f"collectives in the trace: host time inside the process group's ranges "
            + (f"{coll:.1f} ms = share {coll / wall:.3f} of the step (an upper bound: each "
               f"range also waits for the device work queued before it)"
               if coll is not None and wall else "not measured")
            + f", device time of their copies {prof.get('coll_device_ms', nan):.1f} ms; "
            f"gate {t['gate']}; collectives_by_route {res['collectives_by_route']}")
    busy = sum(res["train"]["profile"].get("busy_ms", 0.0) for res in ranks)
    wall = max(res["train"]["profile"].get("wall_ms", 0.0) for res in ranks)
    idle = 1 - busy / wall if wall and route == "shared" else None
    log(f"# phase 20: ranks_by_route {dict(spmd.ranks_by_route)}; {route} world "
        f"{shared_s:.1f} s"
        + (f", nccl world {nccl_s:.1f} s ((e) EP layer {nccl['ep']['errs']}, drops at 1.25 "
           f"{nccl['ep']['drops@1.25']}); the card's idle share in the profiled step, both "
           f"ranks' busy time over the longer wall: {idle if idle is not None else nan:.3f}"
           if nccl is not None else ""))
    return {"ranks": ranks, "nccl": nccl, "ranks_by_route": dict(spmd.ranks_by_route),
            "card_idle": idle}


# ---------------------------------------------------------------------------
# phase 21: the rest of sharded execution (configuration 13)
# ---------------------------------------------------------------------------

# (a) tensor parallelism over model = 2 on the other families at their full
# widths: run: (arch, layers or None for uncut, batch, seq); bf16, remat,
# TPF_STEPS steps, then a prefill of TPF_PROMPT tokens and a decode step.
# Depth cuts: the two ranks share the card, each holding its half of the
# parameters at the functional AdamW's ~29 B a parameter (phase 19), so the
# card holds as much as one unsharded run plus the activations of two
TPF_RUNS = {"a": ("zamba2-2.7b", 48, 4, 1024),          # 54 -> 48 (8 shared applications)
            "b": ("xlstm-350m", None, 4, 128),           # 128: the sLSTM backward (FAM_RUNS)
            "c": ("seamless-m4t-large-v2", None, 4, 512),
            "d": ("phi-3-vision-4.2b", 16, 4, 512)}      # 32 -> 16, as phase 19
TPF_STEPS, TPF_PROMPT = 3, 64
# (b) the fsdp strategy: SmolLM-360M uncut on mesh (data 2, model 1)
FSDP_ARCH, FSDP_B, FSDP_SEQ, FSDP_STEPS = "smollm-360m", 4, 1024, 3
# (c) sharded units on mesh (data 2): configuration 3's program without its
# host check (so the entry is a unit and its tokens are placed by the spec)
# under tech-gf, and configuration 1's decode LM through a DecodeScheduler
UNIT_SPECS = (("batch", ("data", None)), ("seq", (None, "data")))
UNIT_REPS = 5
SPMD21_TIMEOUT = 900


def _tp_family_run(torch, mesh, run: str, arch: str, layers, B: int, seq: int) -> dict:
    """(a): one family tensor-parallel over the mesh's ``model`` axis:
    TPF_STEPS counted train steps, a profiled one, a prefill and a decode
    step, each launch counted, and the reduced float32 gate."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.ssm_scan import ssd_scan_vjp
    from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                          make_train_step, param_layout)
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding as shd

    dev, tp = mesh.device, mesh.shape["model"]
    rank = torch.distributed.get_rank()
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    full = api.init(cfg, torch.Generator(device=dev).manual_seed(SEED), tp=tp, device=dev)
    specs = param_layout(cfg, full)
    params = shd.shard_tree(mesh, full, specs)
    n_full = sum(t.numel() for t in _tensors(full))
    n_local = sum(t.numel() for t in _tensors(params))
    del full
    gc.collect()
    torch.cuda.empty_cache()
    opt_state = adamw_init(params)
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, tp=tp, opt=AdamWConfig(lr=FAM_LR), total_steps=10, mesh=mesh)
    batches = _family_batches(cfg, seq, TPF_STEPS + 1, B=B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, step_ms = [], []
    with _TrainSpies() as spies:
        _reset_counts()
        ssd_scan_vjp.calls = 0
        for i in range(TPF_STEPS):
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batches[i])
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches, routes, vjp = _counts(), _routes(), ssd_scan_vjp.calls
    peak = torch.cuda.max_memory_allocated()
    what = f"tp run {run} ({cfg.name}, rank {rank})"
    check(all(np.isfinite(v) for mt in metrics for v in mt), f"{what}: {metrics}")
    check(not spies.plain_calls, f"{what}: plain versions on the card {spies.plain_calls}")
    want = {k: TPF_STEPS * n for k, n in _family_launches(cfg).items()}
    check(launches == want, f"{what}: launches {launches} != {want}")
    check(vjp == (TPF_STEPS * cfg.n_layers if cfg.family == "hybrid" else 0), (what, vjp))
    for name in ("flash_attention_fwd_stats", "flash_attention_dq", "flash_attention_dkv"):
        check_routes(routes, name, f"{what} (bf16, d = {cfg.head_dim_})", wgmma=want[name])
    check_routes(routes, "rmsnorm", f"{what} (bf16)", vec=want["rmsnorm"])
    check_routes(routes, "ssd_scan", f"{what} (bf16, local heads)", mma=want["ssd_scan"])

    saved = _snapshot()
    prof: dict = {}
    profile_steps(torch, lambda: step(params, opt_state, batches[TPF_STEPS]), 1,
                  f"{what} train step", into=prof)
    _restore(saved)
    del opt_state, step, m
    gc.collect()
    torch.cuda.empty_cache()

    # serving: a prefill of TPF_PROMPT tokens and one decode step, the cache
    # held as cache_pspecs lays it out
    cache = api.init_cache(cfg, B, TPF_PROMPT + 1, tp=tp, dtype=torch.bfloat16, device=dev)
    cspecs = shd.cache_pspecs(cfg, ShapeConfig("d", "decode", TPF_PROMPT + 1, B), mesh, cache)
    cache = shd.shard_tree(mesh, cache, cspecs)
    tokens = np.asarray(batches[0]["tokens"])
    prompt = {"tokens": tokens[:, :TPF_PROMPT]} | _zoo_extra(cfg, B, np.random.default_rng(SEED))
    prefill = make_prefill_step(cfg, tp=tp, mesh=mesh)
    decode = make_decode_step(cfg, tp=tp, mesh=mesh)
    _reset_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = prefill(params, prompt, cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        logits2, cache = decode(params, cache, {"token": tokens[:, TPF_PROMPT:TPF_PROMPT + 1]})
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
    serve_launches, serve_routes = _counts(), _routes()
    if cfg.family == "hybrid":
        G = cfg.n_layers // cfg.ssm.shared_attn_every
        want = _hybrid_launches(cfg.n_layers, G, prefills=1, steps=1)
    else:
        want = _zoo_launches(cfg, prefills=1, steps=1)
    check(serve_launches == want, f"{what} prefill + step: launches {serve_launches} != {want}")
    check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(logits2).all()),
          f"{what}: non-finite serving logits")
    del params, cache, logits, logits2
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "full_layers": get_config(arch).n_layers,
            "B": B, "seq": seq, "step_ms": step_ms, "p50_ms": float(np.median(step_ms)),
            "losses": [a for a, _ in metrics], "peak_mib": peak / 2**20,
            "params_full_m": n_full / 1e6, "params_local_m": n_local / 1e6, "init_s": init_s,
            "launches": launches, "routes": routes, "vjp_calls": vjp, "profile": prof,
            "serve_launches": serve_launches, "serve_routes": serve_routes,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "gate": _tp_family_gate(torch, mesh, arch)}


def _tp_family_gate(torch, mesh, arch: str, strategy: str = "tp") -> float:
    """The family's reduced config in float32 with remat, held by the
    ``strategy``'s layout on ``mesh`` on the card, against the one-rank step
    on the CPU: the loss at 1e-4 and the gradients' global relative error at
    1e-4 (the hybrid at 2e-4, as phase 19's gate)."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.steps import loss_and_grads, param_layout
    from repro_torch.models import api
    from repro_torch.optim.tree import tree_map
    from repro_torch.parallel import sharding as shd

    tp = mesh.shape["model"]
    cfg = dataclasses.replace(reduced_config(arch), compute_dtype="float32", remat=True)
    cpu = api.init(cfg, torch.Generator().manual_seed(SEED), tp=max(tp, 1), device="cpu")
    seq = 16 if cfg.family == "ssm" else 32
    batch = _family_batches(cfg, seq, 1, B=2)[0]
    specs = param_layout(cfg, cpu, strategy=strategy, mesh=mesh)
    card = tree_map(lambda t: t.to(mesh.device), shd.shard_tree(mesh, cpu, specs))
    saved = _snapshot()
    lc, gc_ = loss_and_grads(cfg, cpu, batch, tp=max(tp, 1))
    lg, gg = loss_and_grads(cfg, card, batch, tp=max(tp, 1), mesh=mesh, strategy=strategy)
    gg = shd.gather_tree(mesh, gg, specs)
    _restore(saved)
    want = [a for _, a in api._leaves(gc_)]
    got = [b.cpu() for _, b in api._leaves(gg)]
    rel = _grad_rel_err(torch, got, want)
    tol = 2e-4 if cfg.family == "hybrid" else 1e-4
    check(rel <= tol, f"{cfg.name} reduced float32 ({strategy}): card vs CPU gradients "
          f"{rel:.3e} > {tol:.0e}")
    check(abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc)), (arch, float(lg), float(lc)))
    return rel


def _fsdp_run(torch, mesh) -> dict:
    """(b): SmolLM-360M uncut held by the fsdp strategy on (data 2, model
    1): each layer's shards gathered inside the layer (and again in its
    remat), FSDP_STEPS counted steps, a profiled one, and the reduced
    float32 gate under the same layout."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.steps import make_train_step, param_layout
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding as shd

    dev = mesh.device
    rank = torch.distributed.get_rank()
    cfg = get_config(FSDP_ARCH)
    full = api.init(cfg, torch.Generator(device=dev).manual_seed(SEED), tp=1, device=dev)
    specs = param_layout(cfg, full, strategy="fsdp", mesh=mesh)
    params = shd.shard_tree(mesh, full, specs)
    n_full = sum(t.numel() for t in _tensors(full))
    n_local = sum(t.numel() for t in _tensors(params))
    del full
    gc.collect()
    torch.cuda.empty_cache()
    opt_state = adamw_init(params)
    step = make_train_step(cfg, tp=1, opt=AdamWConfig(lr=FAM_LR), total_steps=10, mesh=mesh,
                           strategy="fsdp")
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=FSDP_SEQ, global_batch=FSDP_B,
                                    seed=SEED))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, step_ms = [], []
    shd.layer_gathers.update(calls=0, leaves=0)
    with _TrainSpies() as spies:
        _reset_counts()
        for i in range(FSDP_STEPS):
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, data.batch_at(i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches, routes = _counts(), _routes()
    gathers = dict(shd.layer_gathers)
    peak = torch.cuda.max_memory_allocated()
    what = f"fsdp ({cfg.name}, rank {rank})"
    check(all(np.isfinite(v) for mt in metrics for v in mt), f"{what}: {metrics}")
    check(not spies.plain_calls, f"{what}: plain versions on the card {spies.plain_calls}")
    want = {k: FSDP_STEPS * n for k, n in _family_launches(cfg).items()}
    check(launches == want, f"{what}: launches {launches} != {want}")
    for name in ("flash_attention_fwd_stats", "flash_attention_dq", "flash_attention_dkv"):
        check_routes(routes, name, f"{what} (bf16, d = 64)", wgmma=want[name])
    check_routes(routes, "rmsnorm", f"{what} (bf16)", vec=want["rmsnorm"])
    # each layer gathers its shards once in the forward and once in its remat
    check(gathers["calls"] == FSDP_STEPS * 2 * cfg.n_layers, (what, gathers))
    saved = _snapshot()
    prof: dict = {}
    profile_steps(torch, lambda: step(params, opt_state, data.batch_at(FSDP_STEPS)), 1,
                  f"{what} train step", into=prof)
    _restore(saved)
    del params, opt_state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "p50_ms": float(np.median(step_ms)),
            "losses": [a for a, _ in metrics], "peak_mib": peak / 2**20,
            "params_full_m": n_full / 1e6, "params_local_m": n_local / 1e6,
            "launches": launches, "routes": routes, "gathers": gathers, "profile": prof,
            "gate": _tp_family_gate(torch, mesh, FSDP_ARCH, strategy="fsdp")}


def _call_ms(torch, fn, reps: int) -> list:
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


REPORTED = ("guest_to_host", "host_to_guest", "conversion_builds", "compiles", "grt_hits")


def _units_run(torch, mesh) -> dict:
    """(c): sharded offload units on (data 2): configuration 3's forward
    under each of UNIT_SPECS against the one-rank unsharded compile on the
    card (2e-3/2e-4, counters exact), ms per call and the partitioner's
    redistributions per op; then configuration 1's decode LM through a
    DecodeScheduler on a sharded plan, its tokens and report against the
    unsharded scheduler's."""
    import dataclasses
    import gc

    from repro_torch import mixed
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.programs import export_attn_decode_lm, export_dense_forward
    from repro_torch.parallel import units
    from repro_torch.parallel.sharding import P
    from repro_torch.serve import DecodeScheduler, StateSpec

    dev = mesh.device
    rank = torch.distributed.get_rank()
    cfg32 = dataclasses.replace(get_config("smollm-360m"), compute_dtype="float32")
    params = api.init(cfg32, torch.Generator(device=dev).manual_seed(SEED), tp=1, device=dev)
    prog, (tokens,) = export_dense_forward(cfg32, params, batch=MIXED_B, seq=MIXED_SEQ,
                                           with_host_check=False, tp=1)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    L = cfg32.n_layers
    plain = mixed.trace(prog).plan("tech-gf").compile()
    _reset_counts()
    want_out, want_rep = plain.call_reported(tokens)
    want_plan = plain.plan_for(tokens)
    check(_counts()["flash_attention"] == L, _counts())
    plain_ms = _call_ms(torch, lambda: plain(tokens), UNIT_REPS)
    out = {"unsharded_ms": plain_ms, "forward": {}}
    for name, spec in UNIT_SPECS:
        what = f"sharded units ({name} split, rank {rank})"
        hybrid = mixed.trace(prog).plan("tech-gf", mesh=mesh, arg_specs=(P(*spec),)).compile()
        units.redistributions_by_op.clear()
        _reset_counts()
        got, rep = hybrid.call_reported(tokens)
        launches, routes = _counts(), _routes()
        redis = dict(units.redistributions_by_op)
        for a, b in zip(got, want_out):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)
        err = max(float(np.abs(a - b).max()) for a, b in zip(got, want_out))
        for key in REPORTED:
            check(getattr(rep, key) == getattr(want_rep, key),
                  (what, key, getattr(rep, key), getattr(want_rep, key)))
        check(dict(rep.per_function_crossings) == dict(want_rep.per_function_crossings), what)
        plan = hybrid.plan_for(tokens)
        check(plan.coverage.as_dict() == want_plan.coverage.as_dict(), what)
        check(sorted(plan.units) == sorted(want_plan.units), what)
        check(launches == {"rmsnorm": 2 * L + 1, "flash_attention": L, "decode_attention": 0,
                           "paged_decode_attention": 0, "ssd_scan": 0, **NO_TRAIN_LAUNCHES},
              f"{what}: launches {launches}")
        check_routes(routes, "flash_attention", f"{what} (f32, d = 64)", tf32x3=L)
        check_routes(routes, "rmsnorm", f"{what} (f32, D = 960)", vec=2 * L + 1)
        saved = _snapshot()
        ms = _call_ms(torch, lambda: hybrid(tokens), UNIT_REPS)
        _restore(saved)
        out["forward"][name] = {"ms": ms, "max_abs_err": err, "redistributions": redis,
                                "launches": launches, "routes": routes,
                                "crossings": rep.guest_to_host, "compiles": rep.compiles}
    del plain
    gc.collect()

    # configuration 1's decode LM: the prefill entry stays on the guest (its
    # host check), so every unit's arguments are replicated over the mesh
    program = export_attn_decode_lm(vocab=VOCAB, d_model=D_MODEL, max_context=MAX_CTX, seed=SEED)
    spec = StateSpec(growing={0: 1, 1: 1}, max_context=MAX_CTX, page_size=PAGE)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, VOCAB, (PROMPT,), dtype=np.int32) for _ in range(CAPACITY)]

    def serve(planned):
        sched = DecodeScheduler(planned, step="decode_step", paged_step="paged_decode_step",
                                capacity=CAPACITY, state=spec, start=False)
        with sched:
            sched.warm(PROMPT)
            streams = [sched.submit(p, n) for p, n in zip(prompts, MAX_NEW)]
            _reset_counts()
            t0 = time.perf_counter()
            sched.start()
            toks = [s.result(timeout=600) for s in streams]
            wall = time.perf_counter() - t0
            launches, routes = _counts(), _routes()
        rep = sched.report()
        return toks, rep, wall, launches, routes

    units.redistributions_by_op.clear()
    sharded_plan = mixed.trace(program).plan("tech-gfp", mesh=mesh,
                                             arg_specs=(P("data", None),))
    toks, rep, wall, launches, routes = serve(sharded_plan)
    redis = dict(units.redistributions_by_op)
    saved = _snapshot()
    want_toks, want, want_wall, _, _ = serve(mixed.trace(program).plan("tech-gfp"))
    _restore(saved)
    what = f"sharded decode LM (rank {rank})"
    for a, b in zip(toks, want_toks):
        check(np.array_equal(a, b), f"{what}: tokens differ from the unsharded scheduler's")
    for key in ("tokens", "steps", "prefills", "crossings", "kernel_steps", "pages_visited"):
        check(getattr(rep, key) == getattr(want, key),
              (what, key, getattr(rep, key), getattr(want, key)))
    check(launches["paged_decode_attention"] >= rep.kernel_steps > 0, (what, launches))
    check(launches["flash_attention"] == rep.prefills > 0, (what, launches))
    check_routes(routes, "flash_attention", f"{what} prefill (f32, d = 960)",
                 tf32x3=rep.prefills)
    check_routes(routes, "paged_decode_attention", f"{what} paged steps",
                 split=launches["paged_decode_attention"])
    out["decode"] = {"tokens": rep.tokens, "wall_s": wall, "unsharded_wall_s": want_wall,
                     "steps": rep.steps, "crossings": rep.crossings,
                     "redistributions": redis, "launches": launches, "routes": routes}
    return out


def _spmd21_rank() -> dict:
    """One rank of phase 21's shared world: (a), (b), (c)."""
    import torch

    from repro_torch.parallel import spmd

    rank = torch.distributed.get_rank()
    tp_mesh = spmd.Mesh((1, SPMD_WORLD), ("data", "model"))
    out = {"device": str(tp_mesh.device), "backend": tp_mesh.backend, "tp": {}}
    for run, spec in TPF_RUNS.items():
        t0 = time.perf_counter()
        out["tp"][run] = _tp_family_run(torch, tp_mesh, run, *spec)
        out["tp"][run]["wall_s"] = time.perf_counter() - t0
        log(f"# phase 21 rank {rank}: tp run {run} done in {out['tp'][run]['wall_s']:.1f} s")
    t0 = time.perf_counter()
    out["fsdp"] = _fsdp_run(torch, spmd.Mesh((SPMD_WORLD, 1), ("data", "model")))
    out["fsdp"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["units"] = _units_run(torch, spmd.Mesh((SPMD_WORLD,), ("data",)))
    out["units"]["wall_s"] = time.perf_counter() - t0
    out["collectives_by_route"] = {k: dict(v) for k, v in spmd.collectives_by_route.items()}
    return out


def _share(prof: dict, key: str):
    wall = prof.get("wall_ms")
    return prof[key] / wall if wall and prof.get(key) is not None else None


def phase_sharded_rest(torch) -> dict:
    """Phase 21: configuration 13 on SPMD_WORLD ranks sharing the card
    through gloo (route ``"shared"``; on NCCL with a card a rank): (a) the
    other families tensor-parallel, (b) the fsdp strategy, (c) sharded
    offload units."""
    import gc

    from repro_torch.parallel import spmd

    gc.collect()
    torch.cuda.empty_cache()
    before = dict(spmd.ranks_by_route)
    route = "nccl" if SPMD_WORLD <= torch.cuda.device_count() else "shared"
    t0 = time.perf_counter()
    ranks = spmd.run_spmd(_spmd21_rank, SPMD_WORLD, device="cuda", timeout=SPMD21_TIMEOUT)
    wall = time.perf_counter() - t0
    check(spmd.ranks_by_route[route] == before.get(route, 0) + SPMD_WORLD,
          dict(spmd.ranks_by_route))
    want_rank = [("gloo", "cuda:0") if route == "shared" else ("nccl", f"cuda:{r}")
                 for r in range(SPMD_WORLD)]
    check([(r["backend"], r["device"]) for r in ranks] == want_rank,
          [(r["backend"], r["device"]) for r in ranks])
    nan = float("nan")
    card_idle = {}
    for run in TPF_RUNS:
        for r, res in enumerate(ranks):
            t = res["tp"][run]
            prof = t["profile"]
            share = _share(prof, "coll_host_ms")
            log(f"# phase 21 (a) rank {r} run {run}: {t['arch']} at {t['layers']} of "
                f"{t['full_layers']} layers, {t['B']} x {t['seq']}, {t['params_local_m']:.1f} "
                f"of {t['params_full_m']:.1f} M params on this rank, init {t['init_s']:.1f} s; "
                f"step ms {[round(x, 1) for x in t['step_ms']]}, p50 {t['p50_ms']:.1f} = "
                f"{t['B'] * t['seq'] / t['p50_ms'] * 1e3:.0f} tokens/s (both ranks together); "
                f"losses {[round(x, 4) for x in t['losses']]}; peak {t['peak_mib']:.0f} MiB; "
                f"profiled step wall {prof.get('wall_ms', nan):.1f} ms, busy "
                f"{prof.get('busy_ms', nan):.1f} ms, idle {prof.get('idle', nan):.3f}, "
                f"collectives' host share "
                + (f"{share:.3f} (an upper bound)" if share is not None else "not measured")
                + f", their copies {prof.get('coll_device_ms', nan):.1f} ms; prefill "
                f"{t['prefill_ms']:.1f} ms, decode step {t['decode_ms']:.1f} ms; launches a "
                f"train run {t['launches']}, prefill + step {t['serve_launches']}; gate "
                f"{t['gate']:.2e}; {t['wall_s']:.1f} s")
        busy = sum(res["tp"][run]["profile"].get("busy_ms", 0.0) for res in ranks)
        longest = max(res["tp"][run]["profile"].get("wall_ms", 0.0) for res in ranks)
        card_idle[run] = 1 - busy / longest if longest and route == "shared" else None
    for r, res in enumerate(ranks):
        f = res["fsdp"]
        prof = f["profile"]
        share = _share(prof, "coll_host_ms")
        log(f"# phase 21 (b) rank {r}: {FSDP_ARCH} fsdp on (data 2, model 1), {FSDP_B} x "
            f"{FSDP_SEQ} a step, {f['params_local_m']:.1f} of {f['params_full_m']:.1f} M params "
            f"held; step ms {[round(x, 1) for x in f['step_ms']]}, p50 {f['p50_ms']:.1f} = "
            f"{FSDP_B * FSDP_SEQ / f['p50_ms'] * 1e3:.0f} tokens/s (both ranks); losses "
            f"{[round(x, 4) for x in f['losses']]}; peak {f['peak_mib']:.0f} MiB; layer gathers "
            f"{f['gathers']}; profiled step idle {prof.get('idle', nan):.3f}, collectives' host "
            f"share " + (f"{share:.3f}" if share is not None else "not measured")
            + f"; gate {f['gate']:.2e}; {f['wall_s']:.1f} s")
        u = res["units"]
        for name, fw in u["forward"].items():
            log(f"# phase 21 (c) rank {r}: forward, {name} split: ms per call "
                f"{[round(x, 1) for x in fw['ms']]} (median {np.median(fw['ms']):.1f}) against "
                f"unsharded {[round(x, 1) for x in u['unsharded_ms']]} (median "
                f"{np.median(u['unsharded_ms']):.1f}); max |err| {fw['max_abs_err']:.2e}; "
                f"crossings {fw['crossings']}, compiles {fw['compiles']}; redistributions "
                f"by op {fw['redistributions']}")
        d = u["decode"]
        log(f"# phase 21 (c) rank {r}: decode LM on a sharded plan: {d['tokens']} tokens in "
            f"{d['wall_s']:.2f} s ({d['steps']} steps, {d['crossings']} crossings; unsharded "
            f"{d['unsharded_wall_s']:.2f} s), tokens equal; redistributions by op "
            f"{d['redistributions']}; launches {d['launches']}; {u['wall_s']:.1f} s; "
            f"collectives_by_route {res['collectives_by_route']}")
    busy = sum(res["fsdp"]["profile"].get("busy_ms", 0.0) for res in ranks)
    longest = max(res["fsdp"]["profile"].get("wall_ms", 0.0) for res in ranks)
    card_idle["fsdp"] = 1 - busy / longest if longest and route == "shared" else None
    log(f"# phase 21: {route} world {wall:.1f} s; the card's idle share in each profiled "
        f"step, both ranks' busy time over the longer wall: "
        + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} not measured"
                    for k, v in card_idle.items()))
    return {"ranks": ranks, "card_idle": card_idle}


# ---------------------------------------------------------------------------
# phase 22: sequence-parallel decode at a global batch of 1 (configuration 14)
# ---------------------------------------------------------------------------

# long_500k (src/repro_torch/configs/base.py): decode against 524,288
# positions at batch 1, Zamba2-2.7B at full width and depth (54 layers, the
# shared block 9 times), its bf16 k/v cache split over two data ranks.  Per
# rank: 10.8 GB of float32 parameters, 24.2 GB of k/v (half the sequence)
# and 71 MB of SSD state, about 35 GB, 70 GB for both on the one card
SP_ARCH, SP_SEQ, SP_BLOCK = "zamba2-2.7b", 524_288, 4096
SP_STARTS, SP_STEPS = (524_280, 262_140), 8      # the cache's end; across the ranks' boundary
SP_TIMEOUT = 600
# Zamba2 at random init is chaotic: a rounding difference (the fold's order
# of sums) grows through its 54 layers and from step to step, in bf16
# compute past any kernel tolerance.  So (b) computes in float32 (the hybrid
# decode runs in float32 after its first layer anyway; the cache stays
# bf16), and every step starts from the seeded SSD state and conv window
# (the k/v rows written by earlier steps stay): a step's logits then differ
# only by that step's own rounding, held at phase 11's float32 end-to-end
# gate; the yardstick (SP_ULP) shows how far one ulp of the state moves them
SP_TOL = 5e-3
SP_ULP = 2.0 ** -23             # the yardstick: the seeded state scaled by 1 + one float32 ulp
# (a): row 2 at the sequence-parallel shape, one rank's slice: q (1,32,1,80)
# float32 (the hybrid decode's promotion) against (1,32,262144,80) bf16 k/v,
# read as the model's (B,S,H,d) cache; local positions: none visible, the
# first tile, its edge, the cluster's two runs' edge, the whole slice, past it
SP_SLICE = SP_SEQ // 2
SP_LSE_POS = (-1, 0, 63, 64, 131_071, 131_072, SP_SLICE - 1, SP_SLICE + 5)
# (c): the dry run's cells on this machine's torch, and (b)'s own cell
DRYRUN_CELLS = (("smollm-360m", "decode_32k", "multi", {}),
                ("qwen2-1.5b", "long_500k", "single", {}),
                ("zamba2-2.7b", "long_500k", "single", {}),
                ("granite-moe-1b-a400m", "train_4k", "single", {"strategy": "fsdp"}),
                ("zamba2-2.7b", "long_500k", "data=2,model=1", {}))
DRYRUN_TIMEOUT = 600


def _lse_err(torch, got, want) -> float:
    """Max |difference| of two log-sum-exps relative to max(1, |want|), with
    each -inf (nothing visible) required on both sides."""
    empty = torch.isneginf(want)
    check(torch.equal(torch.isneginf(got), empty), "lse: -inf rows differ")
    if bool(empty.all()):
        return 0.0
    g, w = got[~empty], want[~empty]
    return ((g - w).abs() / w.abs().clamp_min(1.0)).max().item()


def _lse_case(torch, q, k, v, pos, tol: float) -> dict:
    """Row 2 with ``return_lse`` on the routed body and on the simt body
    (C entry) against the plain version: (o err, lse err, route)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_kernel, decode_attention_plain, decode_route)

    p = torch.tensor([pos], dtype=torch.int32, device=q.device)
    o, lse = decode_attention_kernel(q, k, v, p, return_lse=True)
    plain_o, plain_lse = decode_attention_plain(q, k, v, p, return_lse=True)
    simt, (so, slse) = _decode_entry(torch, q, k, v, p, lse=True)
    simt()
    o_only = decode_attention_kernel(q, k, v, p)
    torch.cuda.synchronize()
    check(torch.equal(o, o_only), "the lse output changed o")
    out = {"o_err": (o.float() - plain_o.float()).abs().max().item(),
           "lse_err": _lse_err(torch, lse, plain_lse),
           "simt_o_err": (so.float() - plain_o.float()).abs().max().item(),
           "simt_lse_err": _lse_err(torch, slse, plain_lse),
           "route": decode_route(k.dtype, q.shape[-1], q.shape[1] // k.shape[1], k, v)}
    for key in ("o_err", "lse_err", "simt_o_err", "simt_lse_err"):
        check(out[key] <= tol, f"row 2 with lse at pos {pos}: {key} {out[key]:.3e} > {tol}")
    if pos < 0:
        check(bool((o == 0).all()), "row 2 with lse: nothing visible must give exact zeros")
    return out


def _lse_phase(torch) -> dict:
    """(a): row 2's lse output against the plain version at the dense and
    hybrid step shapes and at the sequence-parallel shape, its time with
    and without lse in two runs each, the plain version, sdpa, the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention_kernel

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    saved = _snapshot()
    cases = {}
    # the dense step: q (8,15,1,64) bf16 against a float32 cache (8,545,5,64) at pos 528
    q = _randn(torch, (8, 15, 1, 64), bf16, 220, dev)
    kc, vc = (_randn(torch, (8, 545, 5, 64), f32, s, dev).transpose(1, 2) for s in (221, 222))
    cases["dense step"] = _lse_case(torch, q, kc, vc, 528, 2e-2)
    # the hybrid step: q (8,32,1,80) float32 against its float32 cache (8,1057,32,80)
    q = _randn(torch, (8, 32, 1, 80), f32, 223, dev)
    kc, vc = (_randn(torch, (8, 1057, 32, 80), f32, s, dev).transpose(1, 2) for s in (224, 225))
    cases["hybrid step"] = _lse_case(torch, q, kc, vc, 1040, TOL)
    del kc, vc
    # the sequence-parallel shape
    q = _randn(torch, (1, 32, 1, 80), f32, 226, dev)
    g = torch.Generator(device=dev).manual_seed(227)
    k, v = (torch.randn((1, SP_SLICE, 32, 80), generator=g, device=dev).to(bf16).transpose(1, 2)
            for _ in "kv")
    for pos in SP_LSE_POS:
        cases[f"sp pos {pos}"] = _lse_case(torch, q, k, v, pos, TOL)
    check(all(c["route"] == "split" for c in cases.values()),
          {k: c["route"] for k, c in cases.items()})
    flush = l2_flush_buffer(torch)
    p = torch.tensor([SP_SLICE - 1], dtype=torch.int32, device=dev)
    runs = {"with lse": [], "without lse": []}
    for _ in range(2):
        runs["without lse"].append(time_ms(torch, lambda: decode_attention_kernel(q, k, v, p),
                                           40, flush))
        runs["with lse"].append(time_ms(
            torch, lambda: decode_attention_kernel(q, k, v, p, return_lse=True), 40, flush))
    from repro_torch.kernels.decode_attention import decode_attention_plain

    plain_ms = time_ms(torch, lambda: decode_attention_plain(q, k, v, p), 3, flush)
    qb = q.to(bf16)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qb, k, v), 20, flush)
    # each k/v element read once, q read and o and lse written once; 4 d
    # flops per (key, query row) on the CUDA cores
    nbytes = 2 * SP_SLICE * 32 * 80 * 2 + q.numel() * 4 * 2 + 32 * 4
    bound, by = _bound(nbytes, 4 * 80 * SP_SLICE * 32, H100_FP32_FLOPS)
    del k, v, flush
    torch.cuda.empty_cache()
    _restore(saved)
    ms = float(np.median(runs["with lse"]))
    out = {"cases": cases, "runs_ms": runs, "ms": ms,
           "ms_no_lse": float(np.median(runs["without lse"])),
           "plain_ms": plain_ms, "library_ms": library_ms, "library": "sdpa (q cast to bf16)",
           "bound_ms": bound, "bound_by": by,
           "max_abs_err": max(max(c["o_err"], c["simt_o_err"]) for c in cases.values()),
           "max_lse_rel_err": max(max(c["lse_err"], c["simt_lse_err"])
                                  for c in cases.values()),
           "shape": f"q (1,32,1,80) f32, k/v (1,32,{SP_SLICE},80) bf16"}
    out["lse_cost_ms"] = out["ms"] - out["ms_no_lse"]
    log(f"# phase 22 (a): row 2 with lse at {out['shape']}: ms with lse {runs['with lse']}, "
        f"without {runs['without lse']} (two runs each), plain {plain_ms:.3f}, "
        f"{out['library']} {library_ms:.3f}, bound {bound:.4f} ms by {by}; max |o err| "
        f"{out['max_abs_err']:.2e}, max lse rel err {out['max_lse_rel_err']:.2e}; cases "
        + ", ".join(f"{name}: {c['route']} o {c['o_err']:.1e} lse {c['lse_err']:.1e} simt "
                    f"{c['simt_o_err']:.1e}/{c['simt_lse_err']:.1e}"
                    for name, c in cases.items()))
    return out


def _sp_cache(torch, cfg, lo: int, n: int, dev):
    """The bf16 hybrid cache of positions [lo, lo + n): each SP_BLOCK of k
    and v rows drawn from a seed of its own (its global block index), so a
    rank's half and the one-rank cache hold the same values; the SSD states
    and conv windows from one seed (replicated over the data ranks)."""
    from repro_torch.models import api

    f32, bf16 = torch.float32, torch.bfloat16
    cache = api.init_cache(cfg, 1, n, tp=1, dtype=bf16, device=dev)
    for j in range(n // SP_BLOCK):
        blk = lo // SP_BLOCK + j
        for i, name in enumerate(("ak", "av")):
            g = torch.Generator(device=dev).manual_seed(SEED * 1_000_003 + 2 * blk + i)
            rows = cache[name][:, :, j * SP_BLOCK:(j + 1) * SP_BLOCK]
            rows.copy_(torch.randn(rows.shape, generator=g, device=dev, dtype=f32))
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    for name in ("S", "conv"):
        cache[name].copy_(0.1 * torch.randn(cache[name].shape, generator=g, device=dev,
                                            dtype=f32))
    return cache


def _sp_config():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(SP_ARCH), compute_dtype="float32")


def _sp_decode(torch, step, params, cache, vocab: int, tokens=None) -> dict:
    """SP_STEPS decode steps from each of SP_STARTS, each from the cache's
    SSD state and conv window as they were on entry (see SP_TOL): greedy
    from a seeded first token, or teacher-forced with ``tokens``; each
    step's logits over the vocabulary, its token and its wall time."""
    dev = cache["pos"].device
    seeded = {name: cache[name].clone() for name in ("S", "conv")}
    tok = int(np.random.default_rng(SEED + 22).integers(0, vocab))
    logits, fed, step_ms = [], [], []
    for start in SP_STARTS:
        cache["pos"].fill_(start)
        for _ in range(SP_STEPS):
            if tokens is not None:
                tok = tokens[len(fed)]
            fed.append(tok)
            token = torch.full((1, 1), tok, dtype=torch.int32, device=dev)
            for name, x in seeded.items():
                cache[name].copy_(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                lg, cache = step(params, cache, {"token": token})
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            lg = lg.float()[0, -1, :vocab]
            logits.append(lg.cpu().numpy())
            tok = int(lg.argmax())
    return {"logits": np.stack(logits), "tokens": fed, "argmax": [int(x.argmax())
                                                                   for x in logits],
            "step_ms": step_ms}


def _sp_rank() -> dict:
    """One data rank of (b): its half of the seeded cache, the same seeded
    parameters (the model axis has one rank, so the full parameters are its
    shards), SP_STEPS steps from each start, counted; then two profiled
    steps."""
    import torch

    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import api
    from repro_torch.parallel import spmd

    mesh = spmd.Mesh((SPMD_WORLD, 1), ("data", "model"))
    rank, dev = torch.distributed.get_rank(), mesh.device
    cfg = _sp_config()
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(SEED), tp=1, device=dev)
    half = SP_SEQ // SPMD_WORLD
    cache = _sp_cache(torch, cfg, rank * half, half, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    step = make_decode_step(cfg, tp=1, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    spmd.reset_collectives()
    _reset_counts()
    out = _sp_decode(torch, step, params, cache, cfg.vocab)
    launches, routes = _counts(), _routes()
    coll = {k: v.as_dict() for k, v in spmd.collective_stats.items()}
    peak = torch.cuda.max_memory_allocated()
    prof = {}
    token = torch.full((1, 1), out["tokens"][-1], dtype=torch.int32, device=dev)

    def two():
        with torch.no_grad():
            for _ in range(2):
                step(params, cache, {"token": token})
    cache["pos"].fill_(SP_STARTS[1])
    profile_steps(torch, two, 2, label=f"rank {rank} sequence-parallel decode steps",
                  into=prof)
    out.update(rank=rank, device=str(dev), backend=mesh.backend, setup_s=setup_s,
               launches=launches, routes=routes, collectives=coll, peak_mib=peak / 2**20,
               profile=prof, local_ak=tuple(cache["ak"].shape))
    return out


def _dryrun_subprocess() -> list:
    """(c): the dry run's cells in a subprocess on this machine's torch (no
    card, no other rank: a fake world)."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "from repro_torch.launch import dryrun\n"
            f"cells = {[list(c) for c in DRYRUN_CELLS]!r}\n"
            "out = [dryrun.run_cell(a, s, m, save=False, **kw) for a, s, m, kw in cells]\n"
            "print('DRYRUN ' + json.dumps(out, default=str))\n")
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=DRYRUN_TIMEOUT, cwd=tmp)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("DRYRUN ")]
    check(proc.returncode == 0 and lines, f"the dry run failed: {proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("DRYRUN "):])


def phase_seq_parallel(torch) -> dict:
    """Phase 22 (configuration 14): (a) row 2's lse output, (b) Zamba2-2.7B
    decoding at long_500k on two data ranks sharing the card, against the
    one-rank decode on the same seeded state, (c) the dry run."""
    import gc

    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import api
    from repro_torch.parallel import spmd

    lse = _lse_phase(torch)

    gc.collect()
    torch.cuda.empty_cache()
    log(f"# phase 22 (b): the parent holds {torch.cuda.memory_allocated() / 2**20:.0f} MiB "
        f"before the ranks")
    route = "nccl" if SPMD_WORLD <= torch.cuda.device_count() else "shared"
    t0 = time.perf_counter()
    ranks = spmd.run_spmd(_sp_rank, SPMD_WORLD, device="cuda", timeout=SP_TIMEOUT)
    world_s = time.perf_counter() - t0
    check([r["backend"] for r in ranks] == ["gloo" if route == "shared" else "nccl"] * 2,
          [r["backend"] for r in ranks])
    cfg = _sp_config()
    per_step = cfg.n_layers // cfg.ssm.shared_attn_every
    n_steps = len(SP_STARTS) * SP_STEPS
    for r in ranks:
        check(r["local_ak"][2] == SP_SEQ // SPMD_WORLD, r["local_ak"])
        check_routes(r["routes"], "decode_attention", f"phase 22 rank {r['rank']}",
                     split=per_step * n_steps)
        check(r["tokens"] == ranks[0]["tokens"], "the ranks' greedy tokens differ")

    # the one-rank decode on the same seeded state, the ranks' tokens fed
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(SEED), tp=1, device=dev)
    cache = _sp_cache(torch, cfg, 0, SP_SEQ, dev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    one = _sp_decode(torch, make_decode_step(cfg, tp=1), params, cache, cfg.vocab,
                     tokens=ranks[0]["tokens"])
    one_routes = _routes()
    one_peak = torch.cuda.max_memory_allocated() / 2**20
    one_s = time.perf_counter() - t0
    check_routes(one_routes, "decode_attention", "phase 22 one rank", split=per_step * n_steps)
    # the yardstick: the same one-rank steps from the seeded state scaled by
    # one float32 ulp (reported, not gated)
    saved = _snapshot()
    del cache
    gc.collect()
    cache = _sp_cache(torch, cfg, 0, SP_SEQ, dev)
    cache["S"].mul_(1 + SP_ULP)
    ulp = _sp_decode(torch, make_decode_step(cfg, tp=1), params, cache, cfg.vocab,
                     tokens=ranks[0]["tokens"])
    _restore(saved)
    ulp_err = (np.abs(ulp["logits"] - one["logits"]).max(axis=1)
               / np.abs(one["logits"]).max(axis=1))
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    errs = []
    for r in ranks:
        scale = np.abs(one["logits"]).max(axis=1)
        err = np.abs(r["logits"] - one["logits"]).max(axis=1) / scale
        errs.append(err)
        log(f"# phase 22 (b) rank {r['rank']}: each step's logits err against the one rank "
            f"{[float(f'{e:.2e}') for e in err]}; argmax {r['argmax']}, one rank "
            f"{one['argmax']}")
    log(f"# phase 22 (b): the one rank from its state scaled by one float32 ulp, each step's "
        f"logits err {[float(f'{e:.2e}') for e in ulp_err]}")
    for r, err in zip(ranks, errs):
        check(bool((err <= SP_TOL).all()), f"rank {r['rank']}: logits err {err.max():.3e}")
        check(r["argmax"] == one["argmax"], f"rank {r['rank']}: greedy tokens differ: "
              f"{r['argmax']} against {one['argmax']}")
    busy = sum(r["profile"].get("busy_ms", 0.0) for r in ranks)
    longest = max(r["profile"].get("wall_ms", 0.0) for r in ranks)
    card_idle = 1 - busy / longest if longest and route == "shared" else None
    for r in ranks:
        share = _share(r["profile"], "coll_host_ms")
        ms = r["step_ms"]
        log(f"# phase 22 (b) rank {r['rank']}: {SP_ARCH} at {SP_SEQ} positions, batch 1, "
            f"its k/v rows {r['local_ak']}; setup {r['setup_s']:.1f} s; step ms "
            f"{[round(x, 1) for x in ms]}, p50 {np.median(ms):.1f} (range {min(ms):.1f}-"
            f"{max(ms):.1f}); peak {r['peak_mib']:.0f} MiB; collectives' host share "
            + (f"{share:.3f}" if share is not None else "not measured")
            + f"; launches {r['launches']}; collectives {r['collectives']}; max logits err "
            f"{errs[r['rank']].max():.2e} of the one rank's largest")
    log(f"# phase 22 (b): {route} world {world_s:.1f} s; one rank {one_s:.1f} s, step p50 "
        f"{np.median(one['step_ms']):.1f} ms (range {min(one['step_ms']):.1f}-"
        f"{max(one['step_ms']):.1f}), peak {one_peak:.0f} MiB; greedy tokens equal "
        f"{one['argmax']}; the card's idle share in the profiled steps "
        + (f"{card_idle:.3f}" if card_idle is not None else "not measured"))

    t0 = time.perf_counter()
    cells = _dryrun_subprocess()
    dry_s = time.perf_counter() - t0
    for (arch, shape, mesh, _), c in zip(DRYRUN_CELLS, cells):
        check(c["status"] != "error", f"dry run {arch} {shape} {mesh}: {c.get('error')}")
        if c["status"] == "skipped":
            log(f"# phase 22 (c): {arch} {shape} {mesh}: skipped: {c['reason']}")
            continue
        m = c["memory"]
        log(f"# phase 22 (c): {arch} {shape} {mesh}: chips {c['chips']}, rank 0 "
            f"{m['total'] / 2**20:.0f} MiB (params {m['params'] / 2**20:.0f}, cache "
            f"{m.get('cache', 0) / 2**20:.0f}, activations {m['activation_peak'] / 2**20:.0f})"
            f", fits {m['fits']}; collectives {c['collectives']['total_bytes'] / 1e6:.1f} MB; "
            f"dominant {c['roofline']['terms']['dominant']}; wall {c['wall_s']:.1f} s")
    status = {f"{a} {s} {m}": c["status"] for (a, s, m, _), c in zip(DRYRUN_CELLS, cells)}
    check(list(status.values()) == ["ok", "skipped", "ok", "ok", "ok"], status)
    check(cells[1]["reason"].startswith("full-attention arch"), cells[1]["reason"])
    check(cells[0]["chips"] == 512 and cells[0]["memory"]["activation_peak"] > 0, cells[0])
    predicted = cells[-1]["memory"]["total"] / 2**20
    measured = max(r["peak_mib"] for r in ranks)
    log(f"# phase 22 (c): the dry run's rank bytes for (b)'s cell {predicted:.0f} MiB against "
        f"(b)'s measured peak {measured:.0f} MiB ({predicted / measured - 1:+.1%}); "
        f"{dry_s:.1f} s")
    return {"lse": lse, "ranks": ranks, "one": {"step_ms": one["step_ms"], "peak_mib": one_peak,
                                                "routes": one_routes, "ulp_err": ulp_err},
            "card_idle": card_idle, "dryrun": status, "predicted_mib": predicted,
            "measured_mib": measured}


# ---------------------------------------------------------------------------
# phase 23: the repo's own entry points on the card (configuration 15)
# ---------------------------------------------------------------------------

ENTRY_GATES = ("smoke", "smoke_serve", "smoke_decode", "smoke_cluster", "smoke_trace")
# the kernels each entry point must launch on the card (PERF.md section 6's
# rows): the gates fail on their own when one of theirs is missing; the
# examples are held here
ENTRY_KERNELS = {"serve_mixed": {"rmsnorm": "vec", "flash_attention": "tf32x3"},
                 "train_lm": {"flash_attention_fwd_stats": "wgmma", "flash_attention_dq": "wgmma",
                              "flash_attention_dkv": "wgmma", "rmsnorm": "vec"}}
# train_lm at its default, SmolLM-360M uncut, 8 x 256: 24 of the example's
# 200 steps (phase 23's budget), a checkpoint every 12 (the example's every
# 50; each holds 1.45 GB of float32 masters and twice that of moments)
TRAIN_LM_STEPS, TRAIN_LM_CKPT_EVERY = 24, 12
# train_lm's launches a step (phase 14's, which are seq-free): 32 forwards
# with statistics plus 32 under remat, 32 dQ, 32 dK/dV, 129 RMSNorm
TRAIN_LM_PER_STEP = {"flash_attention_fwd_stats": 64, "flash_attention_dq": 32,
                     "flash_attention_dkv": 32, "rmsnorm": 129}
# what the reference's examples print (examples/quickstart.py, decode_stream.py)
QUICKSTART_G2H = {"qemu": 0, "tech": 100, "tech-g": 100, "tech-gf": 50, "tech-gfp": 2}
DECODE_STREAM_TPC = (0.5, 2.6)               # solo, continuous tokens per crossing
OFFLOAD_UNITS = {
    "zlibflate": {"zlib only": ["zlib.deflate_block", "zlib.window_step"],
                  "libpng only": [],
                  "zlib+libpng": ["zlib.deflate_block", "zlib.window_step"]},
    "imagemagick": {"zlib only": ["zlib.deflate_block", "zlib.window_step"],
                    "libpng only": ["libpng.filter_rows", "libpng.quantize",
                                    "libpng.scanline_step"],
                    "zlib+libpng": ["libpng.filter_rows", "libpng.quantize",
                                    "libpng.scanline_step", "zlib.deflate_block",
                                    "zlib.window_step"]}}


def _entry_gate(torch, name: str) -> dict:
    """One smoke gate as its program runs, on the card: exit status 0, its
    rows, its wall and its launches by route."""
    import contextlib
    import importlib
    import io

    from repro_torch.bench.common import launches_from_rows

    module = importlib.import_module(f"repro_torch.bench.{name}")
    _reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main([])
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"# phase 23 {name}: {line}")
    check(rc == 0, f"{name} exited {rc} on the card")
    launches = launches_from_rows(lines, name)
    log(f"# phase 23 {name}: exit 0 in {wall:.2f} s; launches by route (this process "
        f"and its workers) {launches}")
    return {"wall_s": wall, "rows": lines, "launches_by_route": launches}


def _entry_example(torch, name: str, fn) -> dict:
    """One example's ``run`` on the card: its wall and its launches by
    route in this process (its printed lines go to standard output)."""
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    routes = {k: v for k, v in _routes().items() if sum(v.values())}
    for kernel, route in ENTRY_KERNELS.get(name, {}).items():
        n = routes.get(kernel, {})
        check(n.get(route, 0) > 0 and sum(n.values()) == n[route],
              f"{name}: {kernel} launched {n}, expected all on {route!r}")
    log(f"# phase 23 {name}: {wall:.2f} s; launches by route {routes}")
    return {"wall_s": wall, "launches_by_route": routes, "out": out}


def phase_entry_points(torch) -> dict:
    """The five smoke gates and the five examples of ``repro_torch`` on the
    card (configuration 15): each gate through ``main([])`` at its own
    sizes (exit status 0; ``smoke_decode``'s card section gives the CPU's
    tokens with the paged kernel launched once per kernel step, all on
    ``split``), each example's ``run`` at its defaults (``train_lm`` at
    SmolLM-360M uncut, 8 x 256, :data:`TRAIN_LM_STEPS` steps), with its
    wall and launches by route, and each held to what the reference's
    example prints."""
    import tempfile as tf

    from repro_torch.examples import (
        decode_stream, offload_library, quickstart, serve_mixed, train_lm)

    out = {name: _entry_gate(torch, name) for name in ENTRY_GATES}
    card = [r for r in out["smoke_decode"]["rows"]
            if r.startswith("smoke_decode/card_paged_kernel,")]
    check(len(card) == 1 and card[0].endswith(";ok") and "tokens=8" in card[0],
          f"smoke_decode's card section: {card}")

    q = _entry_example(torch, "quickstart", lambda: quickstart.run(None))
    got = {s: r["guest_to_host"] for s, r in q["out"]["schemes"].items()}
    check(got == QUICKSTART_G2H and (q["out"]["plans"], q["out"]["cache_hits"]) == (2, 3),
          f"quickstart: crossings {got}, plans {q['out']['plans']}, "
          f"cache hits {q['out']['cache_hits']}")
    out["quickstart"] = q

    sm = _entry_example(torch, "serve_mixed", lambda: serve_mixed.run(None))
    check(sm["out"]["bitident"] and sm["out"]["crossings_per_request"]
          < sm["out"]["unbatched_crossings_per_request"],
          f"serve_mixed: {sm['out']['crossings_per_request']} crossings a request "
          f"batched, {sm['out']['unbatched_crossings_per_request']} unbatched")
    out["serve_mixed"] = sm

    ds = _entry_example(torch, "decode_stream", lambda: decode_stream.run(None))
    tpc = (round(ds["out"]["solo_tokens_per_crossing"], 2),
           round(ds["out"]["tokens_per_crossing"], 2))
    check(tpc == DECODE_STREAM_TPC, f"decode_stream tokens per crossing {tpc}")
    out["decode_stream"] = ds

    ol = _entry_example(torch, "offload_library", lambda: offload_library.run(None))
    units = {app: {label: u for label, (_, u) in res.items() if label != "pure emulation"}
             for app, res in ol["out"].items()}
    check(units == OFFLOAD_UNITS, f"offload_library units {units}")
    out["offload_library"] = ol

    with tf.TemporaryDirectory(prefix="chip-smoke-train-lm-") as ckpt:
        tl = _entry_example(torch, "train_lm", lambda: train_lm.run(
            steps=TRAIN_LM_STEPS, device=None, ckpt_dir=ckpt,
            ckpt_every=TRAIN_LM_CKPT_EVERY))
    losses = tl["out"]["losses"]
    check(losses[-1] < losses[0], f"train_lm: the loss did not fall: {losses}")
    for kernel, per_step in TRAIN_LM_PER_STEP.items():
        n = sum(tl["launches_by_route"][kernel].values())
        check(n == per_step * TRAIN_LM_STEPS,
              f"train_lm: {kernel} launched {n} times in {TRAIN_LM_STEPS} steps, "
              f"expected {per_step} a step")
    ms = [m["ms"] for m in tl["out"]["metrics"]]
    tl["step_ms"] = ms
    log(f"# phase 23 train_lm ({card_line()}): {TRAIN_LM_STEPS} of the example's 200 steps "
        f"of 8 x 256 tokens, SmolLM-360M uncut; step p50 {np.median(ms):.1f} ms (first "
        f"{ms[0]:.1f}, range {min(ms[1:]):.1f}-{max(ms[1:]):.1f}), "
        f"{8 * 256 / (np.median(ms) / 1e3):.0f} tokens/s; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; checkpoints at steps {TRAIN_LM_CKPT_EVERY}, {TRAIN_LM_STEPS}")
    tl["out"] = {"losses": losses}
    out["train_lm"] = tl
    for v in out.values():
        v.pop("out", None)
    log("# phase 23 walls (s): " + ", ".join(f"{k} {v['wall_s']:.2f}" for k, v in out.items()))
    return out


def _entry_row(entry: dict, name: str) -> dict:
    """Row ``name``'s launches by route in each entry point of phase 23
    that launched it."""
    return {ep: r["launches_by_route"][name] for ep, r in entry.items()
            if sum(r["launches_by_route"].get(name, {}).values())}


def _sharded21_row(s21: dict, name: str) -> dict:
    """Row ``name``'s launches by route in phase 21, per rank and part."""
    out = {}
    for r, res in enumerate(s21["ranks"]):
        for run, t in res["tp"].items():
            out[f"rank {r} tp {run} {t['arch']} train"] = t["routes"][name]
            out[f"rank {r} tp {run} {t['arch']} prefill+step"] = t["serve_routes"][name]
        out[f"rank {r} fsdp train"] = res["fsdp"]["routes"][name]
        for split, fw in res["units"]["forward"].items():
            out[f"rank {r} units forward {split}"] = fw["routes"][name]
        out[f"rank {r} units decode"] = res["units"]["decode"]["routes"][name]
    return {k: v for k, v in out.items() if sum(v.values())}


def _runs_row(results: dict, runs: dict, timing: dict, name: str) -> dict:
    """Row ``name``'s readings of phase 18 (``runs`` ZOO_RUNS) or 19
    (FAM_RUNS) for the JSON line: its launches by route in each run, and its
    times at the phase's shapes."""
    keys = ("ms", "cuda_core_ms", "simt_ms", "plain_ms", "library_ms", "library",
            "bound_ms", "bound_by", "max_abs_err", "shape", "route")
    return {"launches_by_route": {f"{run} {runs[run][0]}": r["routes"][name]
                                  for run, r in results.items()},
            "shapes": {key.split("@")[1]: {k: r[k] for k in keys if k in r}
                       for key, r in timing.items() if key.split("@")[0] == name}}


def _sharded_row(sharded: dict, name: str) -> dict:
    """Row ``name``'s launches by route in phase 20, per rank: the pipeline
    stage (b) and the 3 counted train steps (c)."""
    return {"launches_by_route": {
        f"rank {r} {part}": res[part]["routes"][name]
        for r, res in enumerate(sharded["ranks"]) for part in ("pipeline", "train")},
        "ranks_by_route": sharded["ranks_by_route"]}


def _fig7_row(timing: dict, key: str, routes: dict, name: str) -> dict:
    """Fig. 7's readings of a kernel for the JSON line."""
    r = timing[key]
    keys = ("ms", "cuda_core_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "shape")
    return {k: r[k] for k in keys if k in r} | {"launches_by_route": routes[name]}


def _tf32x3_rows(timing: dict, name: str, launches: dict) -> dict:
    """The float32 route's readings of row ``name`` for the JSON line: each
    timed shape's kernel, old-body, library and bound times, and the paths'
    route counts."""
    rows = {key.split("@")[1]: {k: r[k] for k in ("ms", "cuda_core_ms", "plain_ms",
                                                   "library_ms", "bound_ms", "bound_by",
                                                   "max_abs_err")}
            for key, r in timing.items()
            if key.split("@")[0] == name and r.get("route") == "tf32x3"}
    return {"shapes": rows, "launches_by_route": launches}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    t_all = time.perf_counter()
    walls = {}

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(torch, *args)
        walls[phase.__name__] = round(time.perf_counter() - t0, 2)
        return out

    run(phase_build)
    # phase 19's training runs first, while the card's memory is empty:
    # Zamba2-2.7B's step peaks at about 70 GiB of the 80
    families = run(phase_families)
    sharded = run(phase_sharded)
    sharded21 = run(phase_sharded_rest)
    seqpar = run(phase_seq_parallel)
    err = run(phase_kernel)
    dense_err = run(phase_dense_kernels)
    ssd_err = run(phase_ssd_kernel)
    main_run = run(phase_main)
    timing = run(phase_timing, main_run)
    run(phase_small)
    run(phase_multimodel)
    dense = run(phase_dense_standard)
    mixed = run(phase_dense_mixed, dense)
    dense_timing = run(phase_dense_timing, dense)
    hybrid = run(phase_hybrid_standard)
    hybrid_timing = run(phase_hybrid_timing)
    bwd_err = run(phase_bwd_kernels)
    training = run(phase_train)
    train_timing = run(phase_train_timing)
    paper = run(phase_paper)
    paper_timing = run(phase_paper_timing)
    served = run(phase_serve, dense)
    cluster = run(phase_cluster)
    zoo = run(phase_zoo)
    zoo_timing = run(phase_zoo_timing)
    families_timing = run(phase_families_timing)
    entry = run(phase_entry_points)
    log(f"# phase wall times (s): {walls}")
    log(f"# all phases passed in {time.perf_counter() - t_all:.1f} s")

    kernels = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:114",
        "launches": main_run["launches"],
        "max_abs_err": max(err, timing["max_abs_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "ok": True,
        "launches_by_route": main_run["routes"],
        "simt_ms": timing["simt_ms"],
        "cluster": timing["cluster"],
        "ms_by_cluster": timing["ms_by_cluster"],
        "sharded": {"configuration 13": _sharded21_row(sharded21, "paged_decode_attention")},
        "entry_points": _entry_row(entry, "paged_decode_attention"),
    }]
    for name, replaces in (("decode_attention", "src/repro/kernels/decode_attention.py:34"),
                           ("flash_attention", "src/repro/kernels/flash_attention.py:25"),
                           ("rmsnorm", "src/repro/kernels/rmsnorm.py:11")):
        t = dense_timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/attention_wgmma.cuh" if name == "flash_attention"
            else f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": dense["launches"][name],
            "max_abs_err": max(dense_err[name], t["max_abs_err"],
                               train_timing["rmsnorm@train"]["max_abs_err"]
                               if name == "rmsnorm" else 0.0,
                               paper_timing.get(f"{name}@fig7", {}).get("max_abs_err", 0.0),
                               *(r["max_abs_err"] for key, r in zoo_timing.items()
                                 if key.split("@")[0] == name)),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "ok": True,
        })
        if name in dense["routes"]:
            kernels[-1]["launches_by_route"] = dense["routes"][name]
        kernels[-1]["zoo"] = _runs_row(zoo, ZOO_RUNS, zoo_timing, name)
        kernels[-1]["sharded"] = {"configuration 13": _sharded21_row(sharded21, name)}
        kernels[-1]["entry_points"] = _entry_row(entry, name)
        if name in ("flash_attention", "rmsnorm"):
            kernels[-1]["fig7"] = _fig7_row(paper_timing, f"{name}@fig7",
                                            paper["fig7_routes"], name)
            kernels[-1]["served"] = {"batches": served["batches"],
                                     "launches_by_route": served["routes"][name]}
            kernels[-1]["dispatch"] = dense_timing["dispatch"][name]
        if name == "flash_attention":
            kernels[-1]["aot_cluster"] = {
                "baseline_launches_by_route": cluster["flash"]["baseline"],
                "cluster_launches_by_route": cluster["flash"]["cluster"],
                "prefill_groups": cluster["prefill_groups"]}
            kernels[-1]["cuda_core_ms"] = t["cuda_core_ms"]
            kernels[-1]["tf32x3"] = _tf32x3_rows(
                dense_timing, "flash_attention",
                {"attn-lm prefill": main_run["flash_routes"],
                 "mixed forward": mixed["routes"]["flash_attention"]})
        if name == "decode_attention":
            hyb = hybrid_timing["decode_attention@hybrid"]
            lse = seqpar["lse"]
            kernels[-1]["lse"] = {k: lse[k] for k in (
                "ms", "ms_no_lse", "lse_cost_ms", "runs_ms", "plain_ms", "library_ms",
                "library", "bound_ms", "bound_by", "max_abs_err", "max_lse_rel_err", "shape")}
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], lse["max_abs_err"])
            kernels[-1]["sequence_parallel"] = {
                "configuration 14": {f"rank {r['rank']}": r["routes"][name]
                                     for r in seqpar["ranks"]}
                | {"one rank": seqpar["one"]["routes"][name]}}
            kernels[-1].update(
                simt_ms=t["simt_ms"], cluster=t["cluster"], ms_by_cluster=t["ms_by_cluster"],
                hybrid={k: hyb[k] for k in ("ms", "simt_ms", "ms_by_cluster", "plain_ms",
                                            "library_ms", "bound_ms", "bound_by",
                                            "max_abs_err")}
                | {"launches_by_route": hybrid["routes"]["decode_attention"]})
        if name == "rmsnorm":
            kernels[-1]["families"] = _runs_row(families, FAM_RUNS, {}, name)
            kernels[-1]["sharded"] |= _sharded_row(sharded, name)
            kernels[-1]["routes_by_shape"] = {
                k: r["route"] for k, r in {**dense_timing, **hybrid_timing,
                                           **train_timing}.items() if k.startswith("rmsnorm")}
    t = hybrid_timing["ssd_scan"]
    kernels.append({
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_mma.cuh",
        "replaces": "src/repro/kernels/ssm_scan.py:28",
        "launches": hybrid["launches"]["ssd_scan"],
        "max_abs_err": max(ssd_err, t["max_abs_err"]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "ok": True,
        "launches_by_route": hybrid["routes"]["ssd_scan"],
        "float32_gate_launches_by_route": hybrid["gate_routes"],
        "cuda_core_ms": t["cuda_core_ms"],
        "float32": {k: hybrid_timing["ssd_scan@gate-f32"][k] for k in (
            "ms", "cuda_core_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
        "families": _runs_row(families, FAM_RUNS, {}, "ssd_scan") | {
            "vjp_calls": {f"{run} {FAM_RUNS[run][0]}": r["vjp_calls"]
                          for run, r in families.items()},
            "vjp": families_timing["ssd_scan_vjp@zamba2"]},
        "sharded": {"configuration 13": _sharded21_row(sharded21, "ssd_scan")},
        "entry_points": _entry_row(entry, "ssd_scan"),
    })
    for name, line in (("flash_attention_fwd_stats", 27), ("flash_attention_dq", 65),
                       ("flash_attention_dkv", 96)):
        t = train_timing[name]
        stats = name == "flash_attention_fwd_stats"
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/attention_wgmma.cuh" if stats
            else "src/repro_torch/csrc/attention_wgmma_bwd.cuh",
            "replaces": f"src/repro/kernels/flash_attention_bwd.py:{line}",
            "launches": training["launches"][name],
            "max_abs_err": max(bwd_err[name], t["max_abs_err"],
                               dense_err[name] if stats else 0.0),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "ok": True,
        })
        kernels[-1]["launches_by_route"] = training["routes"][name]
        kernels[-1]["cuda_core_ms"] = t["cuda_core_ms"]
        kernels[-1]["families"] = _runs_row(families, FAM_RUNS, families_timing, name)
        kernels[-1]["sharded"] = _sharded_row(sharded, name) | {
            "configuration 13": _sharded21_row(sharded21, name)}
        kernels[-1]["entry_points"] = _entry_row(entry, name)
        if stats:
            kernels[-1]["tf32x3"] = _tf32x3_rows(dense_timing, name, {})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
