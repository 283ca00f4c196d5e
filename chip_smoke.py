"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100 target).

    python3 chip_smoke.py            # from the repository root

Phases, each printing its own line(s); any failure exits non-zero before
the final line:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of ``src/repro_torch/csrc`` with nvcc for
     sm_90a, one process per source, with seconds and, per kernel entry,
     ptxas's registers, static shared memory and spills (and the wgmma
     flash body's dynamic shared memory);
  3. kernels: each kernel against its plain PyTorch version at the serving
     path's shapes, under ``torch.no_grad`` as the serving paths call them
     (tolerances: float32 2e-5; bfloat16 5e-2 for the paged kernel; the
     bfloat16 prefix and full-sequence flash rows (the wgmma body, which
     rounds P to bf16) element by element within 2^-7 |plain| + 2^-7 a +
     2e-5, a = the softmax-weighted mean of |v| (derived in
     ``check_bf16_attention``), with an error from the float32 truth at
     most twice SDPA's plus 2e-5, and within 5e-2; the bfloat16 RMSNorm
     within one bfloat16 rounding step of the plain output element by
     element; INT8 codes within 1, dequantize bit for bit in float32 and
     bfloat16, round-trip relative error < 0.02, SSD chunk rtol = atol =
     1e-4 x sqrt(Q N / 1024), also at the model's decay range, where cum
     reaches about -180 over a chunk), with its time, the plain
     version's time, the least time the card could take (bytes over
     3.35 TB/s or operations over the dtype's peak rate, whichever is
     larger) and, where one PyTorch call computes the same function, that
     call's time as a yardstick (the port never calls it; SDPA pinned to
     one backend, named).  Times are device times with the inputs out of
     L2: the median of 3 CUDA-graph replays of a run of calls, each after
     a read of four times the L2, less the reads alone (``time_ms``); the
     flash-prefix and RMSNorm rows also print a host loop's per-call time
     (``eager_ms``, inputs in L2).  The flash library's body counters
     name the body each flash row took (the bf16 rows must take the
     ``wgmma`` body, the f32 rows the ``tf32x3`` body), the paged
     library's counters that each paged call ran the split-KV body and
     its merge, the SSD library's that each SSD call took the body its
     plan names (the tensor-core body at the mamba shapes), the kv_quant
     library's that quantize (both entries) and dequantize took their
     16-byte bodies.  The quantize kernel's store entry (the swap's
     device half: K and V read where they lie, bf16, through a request's
     page list, positions past its length masked) is held at granite's
     and granite-moe's swaps and the tier page, timed beside the path it
     replaced (gather, mask, float32 copy, the (T, d) entry), the codes
     that differ from the plain version counted; a whole offload is
     timed the old way and the new (one launch, one pinned copy), with
     the device memory each adds.  The bound of f32
     work (the flash rows, the SSD chunk) is the smaller of the f32 FMA
     bound and the 3xTF32 one (three times the flops at TF32's rate),
     named (``f32_bound``).  The kernels redesigned for Hopper must not be
     slower than their library call, or their plain version where there is
     none (every reading above every reading of the other fails): the bf16
     prefix kernel at C 256, start 1000 against SDPA, the bf16 (1024,
     5120) RMSNorm against ``F.rms_norm`` (printed beside its bound and a
     copy of its bytes), the f32 causal flash kernel at the training
     shape against SDPA, the bf16 paged attention, the SSD chunk (each
     case) and the f32 INT8 dequantize (beside a copy of its bytes)
     against their plain versions; row 7's split-row entries
     (``rmsnorm_sumsq``, ``rmsnorm_apply``: a row's columns over two
     ranks) at phase 27's per-rank shapes of the gated norm, against their
     plain twins and, the halves side by side, the whole-row kernel, and
     (f32) at (j)'s three unequal widths of 1664, 1728 and 1728; the SSD
     chunk also at (j)'s 26 and 27 heads (``uneven_shapes``);
  4. reference: the full-width model's kernel path (paged-attention
     kernel + prefix flash kernel + RMSNorm kernel) against its plain path
     (page gather + masked attention + plain RMSNorm) on one short
     request's logits;
  5. serve: granite-3-8b at full width and depth (random weights from a
     seed) through ``serve(..., warmup=True)`` on the paged backend (asked
     for: the engine's default is dense, as the reference's) with chunked
     paged prefill and the fused paged decode, both as CUDA graphs
     captured at warmup; swaps unquantized (phase 6 forces INT8 ones), so
     that greedy tokens do not depend on the wall clock's schedule; every
     request must finish and the paged-attention and prefix-flash kernels
     must have launched, the paged one through its split-KV body and
     merge.  After phase 6, the backend's graphed decode step against the
     same step run eagerly on the same staged inputs
     (``graphed_vs_eager_step``: 8 lanes at contexts 64..1600, K/V drawn
     from the seed, 3 steps): tokens, reasons and the pool bit for bit;
  6. swap: the same model with 2 lanes and a KV budget of a little over
     two sequences, staged arrivals on a virtual clock: requests must be
     preempted, swapped out and in as INT8 through the kv_quant kernels,
     and all finish; each offload's wall and the device memory it added
     are printed (as in the other swap phases: 17, 24 (d), 25 (b), 26 (b),
     28 (2));
  7. profile: where a full-batch decode step's and a 256-token prefill
     chunk's time goes on the kernel path under ``torch.profiler`` (the
     decode step prints the paged kernels' share of device busy; the
     chunk must run the bf16 wgmma body), then both steps as the engine
     calls them (through the paged backend: inputs staged, tokens back on
     the host), as CUDA-graph replays: wall, device span (CUDA events)
     and device busy each;
  8. mamba reference: mamba2-2.7b at full width and depth (64 layers,
     d_model 2560, 80 heads of 64, state 128; random bf16 weights from a
     seed), its kernel path (fused RMSNorm + SSD chunk kernels) against its
     plain path on one prompt's prefill and 4 decode steps, in f32 (must
     agree to 1e-3) and in bf16 (printed beside bf16's own distance from
     f32);
  9. mamba serve: 8 requests through ``serve(..., warmup=True)`` on the
     dense state backend (monolithic prefill, eager; fused recurrent
     decode as a CUDA graph), then (after phase 10) its graphed decode
     step against the same step eager, as phase 5's: tokens, reasons and
     the conv and SSM state bit for bit;
 10. mamba swap: 2 lanes and staged arrivals force preemptions that swap a
     request's conv and SSM state to the host and back; each preempted
     request's greedy tokens must equal, bit for bit, those of a run of the
     same engine that serves it alone (no preemption);
 11. mamba profile: one full-batch decode step and one 1024-token prefill
     under ``torch.profiler``, kernel and plain paths (the kernel
     prefill's line names the SSD chunk kernels' time and share), then the
     decode step as the engine calls it, replayed and eager;
 12. train reference: granite-3-8b at full width and 8 of its 40 layers in
     float32 (random weights from a seed, one 4 x 1024 batch of the
     synthetic stream), the loss and every gradient leaf through the
     kernels (flash forward and RMSNorm kernel, plain recomputed
     backwards) against ``use_kernels=False``: loss within 1e-4 relative,
     every leaf present, nonzero and within a relative L2 of 1e-3;
 13. train: ``launch/train.train`` on the card, the same configuration, five
     AdamW steps; every loss finite; ms per step, tokens/s, peak memory;
 14. train profile: one step under ``torch.profiler``, wall against device
     busy, and the shares of the flash kernel, the plain attention
     backward, the RMSNorm kernel and the weight products.

 15. dense reference: granite on the dense KV backend (the phase-4 model,
     after phases 5-7's paged engines are freed): one prompt prefilled
     into a lane's stripe as one chunk (the engine's route: prefix flash
     and RMSNorm kernels) and, apart, by the monolithic ``Model.prefill``
     (the full-sequence flash kernel), each followed by 4 dense decode
     steps (plain decode attention), against phase 4's paged kernel path,
     relative L2 <= 0.05 in bf16;
 16. dense serve: phase 5's 8 requests through ``serve(...,
     warmup=True)`` on the dense backend with the reference engine's
     defaults (no chunk size: each prompt one eager chunk over its stripe;
     fused decode as a CUDA graph, ``max_seq_len`` 2048, 8 lanes), swaps
     unquantized; every request must finish and the prefix flash and
     RMSNorm kernels must have launched; after phase 17 its graphed decode
     step against the same step eager, as phase 5's (the dense stripes
     bit for bit);
 17. dense swap: phase 6's setup on the dense backend with chunks of 256:
     requests must be preempted and their K/V stripes swapped as INT8
     through the kv_quant kernels, and all finish;
 18. kernel bench rows: the reference's ``benchmarks/bench_kernels.py``
     rows on the card: the INT8 paged attention at the bench's shape (its
     main path) and one full-batch dense decode step fused and sampled
     against ``decode_step`` plus a host argmax per lane, then the fused
     step as the engine calls it, replayed and eager.
 19. packs and the prefix cache, at the model and backend level: a pack of
     4 rows at bucket 256 (starts 0, 256, 512, 1000; chunk lengths 256,
     200, 17 and 0, a padding row) through ``paged_prefill_pack`` and
     through ``prefill_pack``, each against its three members run one by
     one on a copy of the pool or cache (logits and written K/V within
     5e-2 relative L2; the prefix flash kernel launched once per layer at
     B = 4, through the wgmma body); each backend's pack step graph
     replayed against the eager pack step on the same input, bit for bit;
     a 1024-token prompt published and hit by a request sharing it (hit
     exactly 1024, only the 200-token tail prefilled, logits against the
     same request cold), the same with a 1000-token span (a copy-on-write
     page; the publisher's page unchanged bit for bit) and through the
     dense backend's private store; then no page or refcount left; and
     the wall of a graphed pack of 4 chunks at buckets 64 and 128 against
     the same 4 chunks as graphed single chunks (printed, not gated);
 20. serving with the online predictor, packs of 4 and the prefix cache,
     on granite cut to 12 of its 40 layers (20 since phase 26 came, 12
     since phase 27's (d)-(g): the script's time), paged (with the auto token budget at a target TPOT of 30 ms) and
     dense, each through ``serve(..., warmup=True)``: 16 requests at t=0
     (cut for the script's time), 12 of them in 3 families that share a
     1024-token system prompt; all
     must finish with prefix hits, the dense serve (no budget) with packs
     in its own traffic (the paged serve's own packs are printed: its auto
     budget of a few dozen tokens seldom leaves room for two chunks of
     one bucket; the warm batch's are not counted), no capture or library
     load after warmup, a replay per decode step and per pack, and no page,
     refcount or prefix entry left after the drain; it prints tokens/s,
     TTFT p50 of hit and cold requests, decode and pack p50, the budget
     and its fit (the warm batch's t0, alpha and beta, its rings' sample
     counts and mean context), the predictor's gauges and predict latency; after the
     paged serve, the same requests with the cache, packing and the
     learned predictor off, and how many requests' greedy tokens agree
     (printed, not gated: the wall clock sets the schedule and a pack's
     shape gives other bits).
 21. speculative verify-k decoding and the observability bus (spec_k 3),
     on both backends: (a) one verify step of 8 lanes x 4 positions at
     contexts 64..1600 (a paged lane at length % 16 == 14, so that its
     span crosses into its scratch page; K/V random bf16 from a seed)
     against 4 sequential eager decode steps from the same state fed the
     tokens they sample, both against the float32 truth (the same steps
     of the weights and state upcast): the verify's logits and written
     K/V no farther from the truth than 1.25 times the bf16 steps' (plus
     1e-3; the verify against the bf16 steps printed), the prefix flash
     kernel once per layer through the wgmma body and its merge; then the
     verify step as the engine calls it, graphed and eager, under the
     profiler (the wgmma kernel must run); (b) phase 5's
     8 requests on a warmed speculative engine of phase 5's (paged) and
     phase 16's (dense) configuration with a wall-clock ``EventBus``
     attached: all finish, drafts proposed, no capture or library load
     after warmup, one verify replay per decode iteration, 40 prefix
     flash launches per verify step on top of 40 per prefill chunk, the
     bus's decode iterations carrying the drafted and accepted counts,
     and greedy tokens equal, bit for bit, to the same serve without the
     bus; then the verify step graphed against its eager step, as phase
     5's decode step; printed beside the spec-off serve's tokens/s, with
     accepted / drafted, tokens per lane iteration and how many requests
     agree with the spec-off serve (not gated); (c) the trace and its
     ``.prom`` written to a temporary directory, the JSON loaded back
     and its events counted by name.
 22. two replicas on the one card sharing a host KV tier
     (``serving/kv_tier.HostKVTier``), replica B's weights placed by
     ``distributed/placement.place_params`` (the same tensors: device
     memory must grow by less than B's pool plus 1 GiB): (a) paged replica
     A (pages of 16, chunks of 256) serves a 1024-token system prompt plus
     a tail and publishes it into an fp tier; paged replica B imports the
     prompt (``_tier_import``, ``tier_fill``): B's imported pages equal
     A's bit for bit, and B's last logits for a request sharing the
     prompt equal A's for the same request from its local prefix hit, bit
     for bit; the same for a dense B through its private store; then A
     publishes into an INT8 tier and a paged importer serves the request:
     payload bytes beside the raw bytes, the ``kv_quantize_store`` and
     ``kv_dequantize`` kernels launched, the imported pages within the
     INT8 round trip's bound (relative 0.02), the importer lossy and
     publishing nothing, no library load and no pinned page left; the
     publishes' host copies and the fills timed; (b) two warmed paged
     engines of phase 5's configuration with the prefix cache and an fp
     tier: A serves the 3 families' heads, B 12 requests (9 in 3 families
     sharing a 1024-token system prompt, 3 distinct; outputs 16-32): all
     finish, a tier import in every family, no capture or library load
     while serving, a replay per decode step, no page, refcount, prefix
     entry or tier pin left after the drain, and B's greedy tokens equal,
     bit for bit, those of B serving the same requests again with the tier
     off and its cache cleared; it prints tokens/s, TTFT p50 of imported,
     local-hit and cold requests, each fill's and each publish's time, the
     effective rates and the tier's gauges.
 23. two granite-3-8b replicas (phase 20's model: 12 of 40 layers) behind
     the online gateway
     (``launch/serve.serve_gateway``, ``serving/gateway``): (a) two warmed
     paged replicas of phase 5's configuration (B shares A's weights, both
     on cuda:0) serve 16 sharegpt arrivals at 6/s (cut for the script's
     time; prompts clamped to
     1536, outputs to 64, a quarter interactive) in wall clock under the
     concurrent pump (one step thread per replica), EWT routing, with the
     bus and gauge snapshots every 0.5 s: 16 of 16 streams end in
     ``finish``, each stream's tokens are its request's (none lost or
     repeated), both replicas serve, no capture or library load in either
     pump thread, no pump raised, gauges recorded, and the paged
     attention, prefix flash and RMSNorm launches (counted from 0 after
     the warmups) equal exactly what the replicas' graph replays launched
     (``StepGraphs.replayed``); it prints tokens/s, TTFT p50/p90 per
     class, normalized latency, dispatches and each replica's step walls;
     (b) fresh copies of the requests served at t=0 by replica A alone
     (``ServingEngine.serve``): (a)'s streams equal them bit for bit; (c)
     the lockstep pump over A and B on fresh copies: tokens equal (b), its
     tokens/s and TTFT beside (a)'s (printed, not gated).
 24. granite-moe-3b-a800m at full width and 8 of its 32 layers (cut for
     the script's time: 16 since phase 26 came, 8 since phase 27's
     (d)-(g); 40 experts
     of 1536 x 512 top 8, capacity factor 1.25; random bf16 weights from
     a seed, the router f32), after the granite model is freed: (a) one
     MoE layer in f32 on the card against the CPU over 64 tokens (the
     router's top-9 margin above four times the logits' card-vs-CPU
     difference, then equal expert choices and kept masks, outputs within
     1e-5 of their scale); (b) the kernel path against the plain path on
     phase 4's kind of request in f32 (relative L2 < 1e-3, equal greedy
     tokens) and in bf16 (printed), each with the count of routing
     decisions that differ, and beside bf16 two witnesses: bf16 plain
     against f32 plain (printed) and the bf16 kernel path on the plain
     path's routing (relative L2 < 0.05); (c) phase 5's 8 requests on a
     warmed paged
     engine of phase 5's configuration with graphs; (d) phase 6's 2-lane
     INT8 swap trace; (e) 8 requests through ``serve(...)`` on the dense
     backend, warmed; then (c) again with eager steps, whose tokens must
     equal (c)'s bit for bit, and (f) a profile of the graphed engine
     decode step (B 8) with the MoE block's device time at the decode
     shape split into routing/dispatch and expert products.  (c) and (d)
     run on a virtual clock (0.1 s a step; the eager engine gets the
     graphed one's measured chunk costs): an MoE token depends on which
     requests share its step, so the two serves compare on one schedule.
     Each serve gates that all finish, no capture or library load after
     warmup, every decode step a replay, and its kernels launched (the
     paged attention, prefix flash and RMSNorm kernels; the INT8 quant
     kernels in (d)); it prints tokens/s, TTFT p50 (wall), decode p50 and
     the share of decode steps' (token, k) assignments dropped (counted
     through ``Model.moe_tap`` in the eager serve).
 25. the encoder-decoder family and the embeds input, after phase 24's
     model is freed: seamless-m4t-large-v2 at full width and depth (24 +
     24 layers, d_model 1024, 16 heads of 64, d_ff 8192, vocab 256206,
     LayerNorm, gelu; random bf16 weights from a seed).  (a) one request
     of 4096 speech frames through ``Model.prefill`` and 4 dense decode
     steps, the kernel path (the flash kernel, bidirectional in the
     encoder, causal in the decoder's prefill) against the plain path:
     at full width and 2 + 2 layers in f32 (relative L2 < 1e-3, equal
     greedy tokens), and the full bf16 model (<= 0.05); (b) the serving
     path the reference's dense KV backend runs (its engine cannot
     prefill an encoder-decoder, and the port's refuses one): 8 requests
     of 4096 frames (``cross_kv_len``) with a 1-token decoder start and
     outputs of 16-64 tokens through 8 lanes of ``max_seq_len`` 128, each
     ``Model.prefill``ed alone and placed by ``write_prefill``, then fused
     decode steps as a CUDA graph until every request ends, one lane
     offloaded and uploaded at step 8 (k/v INT8 through the kv_quant
     kernels, the 4096-frame xk/xv raw): all finish, 48 flash launches a
     request, the swap's blob kinds, every step a replay, and the graphed
     decode step equal to its eager step bit for bit (8 lanes at context
     64, as phase 5's); tokens/s, decode p50,
     prefill ms per request, the swap's bytes and times; then one
     prefill profiled, and the graphed decode step at full batch
     profiled (busy time) beside the
     cross-attention's device time alone and the step's bytes bound
     (decoder and head weights plus the lanes' cross caches); (c)
     internvl2-2b at full width and depth fed 4 rows of 1024 patch
     embeddings, right-padded, with ``last_index``: kernel path against
     plain path (<= 0.05), and ``embeds = embed[tokens]`` equal to the
     token path bit for bit; (d) ``launch/train.train`` on seamless at
     full width and depth in f32, batch 2 x 1024, 3 AdamW steps: losses
     finite, the flash kernel and its (plain, recomputed) backward once
     per layer and step; ms/step and peak memory.
 26. the hybrid family and the ssm family's training, after phase 25's
     models are freed (device memory allocated printed first):
     jamba-1.5-large-398b at full width (d_model 8192, 64/8 heads of 128,
     d_ff 24576, Mamba heads of 128 with state 128, vocab 65536) and one
     8-layer group of its 72 (7 Mamba layers, attention at layer 3, MoE
     on odd layers), each MoE layer holding a share of its 16 experts
     (``Model(expert_shard=)``: the device-local half of the reference's
     expert parallelism, routing, capacity and aux loss over all 16; the
     other chips' shares and the exchange are left out).  (a) f32, 2 of
     16 experts (11.3 B parameters): one 1000-token prompt's prefill
     logits and 4 decode steps, the kernel path (the SSD chunk's
     tensor-core body through the 128-column head split, every call; the
     flash kernel; RMSNorm at 8192 and 16384) against the plain path,
     relative L2 < 1e-3 and equal greedy tokens.  (b) bf16, 8 of 16
     experts (25.81 B parameters, 51.6 GB): kernel vs plain (<= 0.05),
     then the main path, counted from 0: 12 requests (prompts 64-1536,
     outputs 16-64) through ``serve(..., kv_backend="dense",
     warmup=True)`` with 8 lanes (lanes turn over), the decode step a
     CUDA graph, each prompt prefilled whole, and one 1000-token lane's
     INT8 swap on its backend (K/V through rows 3-4, conv and SSM state
     raw: restored bit for bit, K/V within 0.02); then the graphed decode
     step equal to its eager step bit for bit, as phase 5's; tokens/s,
     TTFT p50, decode p50,
     prefill ms a request, the swap's bytes.  (c) the graphed decode step
     at 8 lanes profiled against its bytes bound, with the device times
     of its MoE blocks, Mamba steps and plain attention, and a 1024-token
     prefill whose SSD kernels' share the profile names.  (d)
     mamba2-2.7b at full width and 32 of its 64 layers in f32 (cut for
     the script's time): the loss and every
     gradient leaf through ``SsdChunk`` and ``FusedRMSNorm`` against the
     plain path (loss 1e-4 relative, each leaf nonzero within rel_l2
     1e-3), then ``launch/train.train``, 3 AdamW steps at batch 1 x 1024
     (main path, counted from 0): losses finite, 32 SSD launches a step;
     ms/step, tokens/s, peak memory.
 27. sharded execution over a device mesh, after phase 11 (mamba freed;
     phases 12-14 follow): two ranks share the card over a gloo group
     (NCCL refuses two ranks on one device; every collective is staged
     through a host copy), processes this script starts
     (``--shard-rank``) and waits for;
     a rank that fails fails the phase.  Each rank draws the whole model
     from the seed and keeps its block (``Model.shard``); rank 0 first
     computes the one-rank result on the whole weights.  (a) granite-3-8b
     at full width and 8 of its 40 layers (``SHARD27``, cut for the
     script's time), mesh data 1 x model 2 (16/4 heads of 128 a rank; the odd vocab's tied embed
     split over d_model, the reference's re-homed spec): ``Model.prefill``
     of 2 prompts of 1024 and 8 teacher-forced ``decode_step`` calls, bf16
     logits within 0.05 relative L2 of one rank at every step, greedy
     agreement printed;
     the per-rank weight bytes must equal the dry run's
     (``launch/dryrun.param_bytes``).  (b) granite-moe-3b-a800m at 8 of
     its 32 layers, experts and heads over model 2 (20 experts, 12/4
     heads a rank): the same run on the one-rank run's routing (gated at
     0.05; greedy agreement printed), with the share of routing decisions
     that the sharded router, given the same inputs, makes differently
     (printed).  (c) one FSDP step of granite-3-8b at full width and 1
     layer (2 before PR 27) in f32, mesh data 2 x model 1, batch 2 x
     1024, AdamW: loss
     within 1e-5 relative, the clipped global norm within 1e-6 relative,
     and every gradient leaf and both AdamW moments within rel_l2 1e-4 of
     one rank's step (each rank holds its block of one rank's gradients
     and moments; the squared sums cross ranks).  (d) mamba2-2.7b at 4 of
     64 layers (cut for the script's time; 40 of 80 SSM heads a
     rank: its heads' z, x and dt columns
     of ``in_proj``, B and C whole; the gated norm over d_inner through row
     7's split-row entries, the sum of squares all-reduced between them):
     prefill 2 x 1024 and 8 decode steps as (a).  (e) seamless-m4t-large-v2
     at 8 of 24 encoder and 8 of 24 decoder layers (8/8 heads of 64 a
     rank): prefill from 4096 frames and a 1-token decoder start, then 8
     decode steps.  (f) jamba-1.5-large-398b's one 8-layer group (32/4
     attention heads and 64 of 128 Mamba heads a rank), holding 4 of its
     16 experts split over the ranks (2 each; routing over all 16, an
     absent expert adds 0), each rank drawing its blocks layer by layer
     (``Model.init(..., "serving")``); prefill 1 x 1024 and 8 decode steps;
     rank 0 then draws the one-rank model of the same 4 experts and runs
     it on the sharded run's routing.  (d)-(f) are gated as (a) (bf16
     0.05), weights against the dry run.  (g) one step of mamba2-2.7b at
     2 layers in f32, mesh data 1 x model 2, batch 1 x 1024, gated as
     (c): the split norm's backward crosses the ranks.  Each part prints
     its ranks' peak device memory.  The sharded runs (every rank's) are
     counted from 0 and added to the kernels line (``SHARD27_ROWS``: the
     rows each part must launch; row 7's split-row entries
     ``rmsnorm_sumsq`` and ``rmsnorm_apply`` in (d), (f) and (g), their
     rows in the kernels line).  (h) granite-3-8b at full width and 8 of
     its 40 layers on three ranks of their own, mesh data 1 x model 3: its
     32/8 heads laid out as 9 KV / 36 query slots (3 / 12 a rank, rank 0's
     third KV slot a zero padding head; ``sharding.head_layout``), d_ff
     12800 as 4266, 4267 and 4267 columns: the serving run of (a), every
     rank's weight bytes against the dry run's for its coordinate; then
     one tensor-parallel step at 1 layer in f32, batch 2 x 1024, gated as
     (c), no padding slot in any rank's gradients, moments or weights, and
     the gradients of the padded leaves gathered whole
     (``ctx.gather_full``) within 1e-4 of one rank's.  (i)
     jamba-1.5-large-398b's ``long_500k`` cell, its global batch of 1 with
     the cache's positions split over ``data`` (mesh data 2 x model 1,
     the one group at full width holding 2 of 16 experts, the weights
     whole on both ranks): rank 0 prefills one 12288-token prompt on its
     own, each rank keeps its half of a 16384-position cache (every new
     token lands on rank 1), and 8 teacher-forced ``decode_step(...,
     seq_split=True)`` calls follow; every step's merged attention
     (``layers.decode_attention`` over ``seq``: one max and one sum
     all-reduce)
     within 1e-5 relative L2 of one rank's unsplit float32 attention on
     the same query and cache, the new K/V rows equal to one rank's bit
     for bit; the logits' rel_l2 and greedy agreement printed.  (j) on
     (h)'s three ranks after (h): mamba2-2.7b at full width and 4 of 64
     layers in f32, its 80 SSM heads as 26, 27 and 27
     (``sharding.even_blocks``; each rank's heads' columns, conv
     channels, constants, ``out_proj`` rows, gated-norm columns and SSM
     state, B and C whole): a 1 x 1024 prefill and 8 decode steps within
     (d)'s f32 gate of one rank's, every rank's weights the dry run's,
     each rank's walls and peak printed; then one tensor-parallel AdamW
     step at 1 x 1024 gated as (c), the padded leaves as (h)'s.  The
     ranks of (a)-(g) and (i) and the three of (h) and (j) start before
     phase 8 and wait for their go, so that their start overlaps phases
     8-11; (h)'s go follows the first group's exit, and its ranks' exits
     overlap phases 12-14.

 28. the three registered configs no earlier phase runs, after phase 26's
     models are freed, one at a time at full width, random bf16 weights
     from the seed through ``Model.init`` on the card, each freed before
     the next: qwen1.5-32b at 16 of its 64 layers (d_model 5120, 40 = 40
     heads of 128: G 1, QKV biases, d_ff 27392, vocab 152064),
     command-r-35b at 20 of 40 (d_model 8192, 64/8 heads: G 8, LayerNorm,
     a tied 256000-row head; both cut for the script's time) and
     dbrx-132b at 8 of 40 holding all
     16 experts, top 4 (d_model 6144, 48/8 heads: G 6, LayerNorm, d_ff
     10752; 54.61 GB), depth the only cut.  Each: (1) the kernel path
     against the plain path on the same weights: two prompts (1024 and
     600 tokens) prefilled in chunks of 256 on a 2-lane paged backend,
     then 8 decode steps of both lanes, the plain path fed the kernel
     path's tokens (dbrx on its routing, as phase 24 (b)): relative L2 of
     the 18 logit rows <= 0.05; (2) the main path, counted from 0: 8
     requests (prompts 64-1536, outputs 16-64) through ``serve(...,
     warmup=True)`` on the paged backend with chunks of 256, graphed,
     INT8 swaps (the compile gate as phase 5's; all finish), then one
     forced INT8 swap of a 1000-token lane on its backend (K/V within
     phase 3's round-trip bound); (3) the graphed decode step against its
     eager step, as phase 5's; (4) the graphed engine decode step at 8
     lanes profiled, against its bytes bound (the weights a step reads and
     the lanes' K/V); the paged attention, prefix flash, INT8 quant and,
     for qwen, RMSNorm kernels must have launched.
 29. granite-moe-3b-a800m trained on the card in f32: at 8 of its 32
     layers, batch 4 x 1024, the loss (the aux term in it) and every
     gradient leaf through the kernels against ``use_kernels=False`` as
     phase 12 holds granite's, on one routing (the kernel path's choices
     replayed in the plain path, gate weights from its own router, so the
     router's gradient is compared too); then ``launch/train.train`` at all
     32 layers (3.30 B parameters), batch 1 x 1024, 3 AdamW steps, counted
     from 0: losses finite, the flash and RMSNorm kernels launched;
     ms/step, tokens/s, peak memory.

The serve phases 5, 6, 9, 10, 16, 17, 20, 21, 22 (b), 23, 24, 26 (b) and
28 (2) run warmed engines
(every step graph captured and every kernel library loaded before the
first request): each prints its warmup's seconds, captures and
graph-pool size, and fails on any capture or library build or load while
serving (``utils/compile_counter.CompileCounter``) and on any decode (or,
with speculative decoding, verify) step that did not run as a replay.  A
replay adds its captured launches to every wrapper's ``launches`` and to
the libraries' body counters, so the main-path counts below count
replays.

Phases 15-23 run after phase 7, with the granite model still loaded
(phases 20 and 23 on its first 12 layers); phases 28 and 29 after phase
26, before phase 27's ranks start.
Phase 3 also holds the paged attention (f32 and bf16) and the prefix
flash kernel (bf16) at granite-moe's decode shape (B 8, H 24, KVH 8, d
64: G 3, pages of 16, lengths 1..2048) and its 256-token chunk at 1000,
the INT8 quantize and dequantize at granite-moe's swap rows (86,016 of
64) and the RMSNorm at its width 1536 (the kernels line's ``moe_shape``;
gated as granite's rows), the prefix flash kernel at stablelm-3b's head
dim 80 (H = KVH = 32, bf16, C 256 at 1000) and the full-sequence one at
its training shape (f32 causal, B 4, S 1024; both ``stablelm_shape``,
gated as granite's rows, each beside the d-128 body at the same heads
and shape, ``d128_ms``), the full-sequence kernel at seamless's encoder
(bf16 bidirectional, B 1, H 16, S 4096, d 64; ``seamless_shape``, gated
as granite's rows), and holds the prefix
flash kernel at the verify step's shape (B 8, C 4, starts 60..2040,
Smax 2048 and 2064, the last key tile of 2064
partial: the bf16 bound, the wgmma body and its merge, its time, bound,
plain and SDPA times, in the kernels line's ``verify_shape``), at the
packs' shapes (B 4, starts 0/256/512/1000, ragged chunk lengths with a
padding row, at bucket 256 and at the split buckets 32 and 16: each
member's rows by the bf16 bound above, the planned body and merge), the
INT8 quantize and dequantize at the KV tier's page shape (5120 rows of 128,
float32 in, bfloat16 out; the kernels line's ``tier_page_shape``), the
INT8 paged attention (the bench's shape and
granite's decode shape, codes from the ``kv_quantize`` kernel; against its
plain version and, within 0.05, float attention on the unquantized
pages), the full-sequence flash kernel at the training shape
(B 4, H 32, KVH 8, S 1024, d 128: f32 causal and bidirectional, bf16
causal, a ragged S of 1000, d 64 bidirectional, and bf16 causal at B 1,
S 2048; SDPA timed as the yardstick), the RMSNorm kernel (rows of 2560 and 5120 for mamba,
4096 for granite, 1536 for granite-moe, 8192 and 16384 for jamba (a
1024-token prefill; the kernels line's ``jamba_shape``), bf16 and f32, with
``torch.nn.functional.rms_norm`` timed
as the library yardstick) and the SSD chunk kernel (B 1, S 1024 = 4 chunks
of 256, with small and with model-range decay, and one ragged chunk of 200
rows; 80 heads of 64, state 128, f32; and jamba's prefill layer, 128 heads
of 128 through the head split, at both decays: ``jamba_shape``) against
their plain versions; the full-sequence flash kernel also at jamba's
attention layer (bf16 causal, B 1, H 64, KVH 8, S 1024, d 128;
``jamba_shape``, gated as granite's rows), at phase 27 (i)'s prompt
length (bf16 causal, B 1, S 12288, 8/1 heads of 128; ``long_shape``,
gated as granite's rows) and at phase 27's per-rank
heads (bf16 causal, B 2, S 1024: granite's 16/4 of d 128,
granite-moe's 12/4 of d 64 and (h)'s padded 12/3 of d 128;
``sharded_shape``, gated as granite's rows), the RMSNorm at
phase 27's 2 x 1024 prefill rows of 4096 and 1536 (``sharded_shape``),
and the paged kernel (bf16) at phase 28's decode shapes (B 8, d 128,
pages of 16, lengths 1..2048: qwen1.5-32b's 40 = 40 heads, G 1, and
dbrx-132b's 48/8, G 6) and the prefix flash kernel (bf16, C 256 at 1000)
at their heads and command-r-35b's 64/8, G 8 (``big_shapes``, gated as
granite's rows).
There are five main paths, each driven with every kernel's launch count set to 0 just before it and
read just after: granite's phases 5 and 6 (the paged-attention, prefix
flash and INT8 quant kernels must have launched), granite's dense phases
16 and 17 (the prefix flash, RMSNorm and INT8 quant kernels), the kernel bench of
phase 18 (the INT8 paged attention), mamba's phases 9 and 10 (the RMSNorm
and SSD chunk kernels must have launched, every SSD call through the
tensor-core body) and training's phase 13 (the
flash and RMSNorm kernels must have launched); then phase 19's two packs
and phase 20's and phase 21's two serves each, phase 22, phase 23 (a),
phase 24's serves (c)-(e), phase 25's serve (b) and training (d), and
phase 26's serve and swap (b) and training (d), phase 27's sharded
runs on both ranks, phase 28's serves, swaps, graphed steps and profiles
and phase 29's training, each counted from 0 and added to the kernels
line's launches.  Each phase
prints its seconds.  Then a ``kernels`` JSON line (each row also names
the ``csrc`` headers its source includes), the card's name and
power limit, and the final ``{"ok": true, "device": {...}}`` line.  Needs
one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

T0 = time.perf_counter()               # this script's start (phase 27)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12               # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,       # dense tensor-core rate
              "float32": 67e12,         # float32 outside the tensor cores
              "tf32": 495e12}           # dense TF32 tensor-core rate
L2_BYTES = 50 * 2 ** 20                 # H100 SXM data sheet
_SCRUB = []                             # the L2 scrub's buffer, made once
SEED = 0
# the lanes of the profiled and checked decode steps: 8 at contexts spread
# over the serves' range
PROFILE_CTX = np.linspace(64, 1600, 8).astype(int)


class Clock:
    """Prints each phase's seconds as it ends."""

    def __init__(self, t0: float):
        self.t = t0

    def lap(self, what: str) -> None:
        now = time.perf_counter()
        print(f"[time] {what}: {now - self.t:.1f}s", flush=True)
        self.t = now


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def free_memory(torch) -> None:
    """Collect the reference cycles that can still hold a deleted model's
    tensors (engines, graphs and closures that refer back to each other),
    then return the cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def _scrub_l2():
    """Reads a float32 buffer of four times the card's L2 (one reduction),
    which leaves none of the data of earlier calls there."""
    import torch
    if not _SCRUB:
        _SCRUB.append(torch.ones(L2_BYTES, dtype=torch.float32,
                                 device="cuda"))
    return _SCRUB[0].sum()


def _replay_ms(graph) -> float:
    import torch
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def time_ms(fn, iters: int = 20, reps: int = 3, readings=None) -> float:
    """Device time of one call of ``fn`` whose inputs are not in L2, as a
    serving step finds fresh activations and another layer's K/V: the
    median of ``reps`` readings.  A reading replays, between CUDA events, a
    CUDA graph of ``iters`` (L2 scrub, call) pairs and one of the ``iters``
    scrubs alone, and takes the difference per call; the host's time to
    issue the calls is in neither (after one warm-up call and one warm-up
    replay of each).  ``readings``, when given, gets every reading."""
    import torch
    fn()
    _scrub_l2()
    torch.cuda.synchronize()
    graphs = []
    for calls in ((_scrub_l2, fn), (_scrub_l2,)):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                for call in calls:
                    call()
        graph.replay()
        graphs.append(graph)
    torch.cuda.synchronize()
    got = [(_replay_ms(graphs[0]) - _replay_ms(graphs[1])) / iters
           for _ in range(reps)]
    del graphs
    if readings is not None:
        readings.extend(got)
    return statistics.median(got)


def verdict(label: str, ms: float, mine: list, lib_ms: float, lib: list,
            what: str, b_ms: float, copy_ms: float = None) -> None:
    """Prints a redesigned kernel's verdict against its library call (or,
    where there is none, its plain version), with
    its time over its bound (and, for a bytes-bound row, the time of a
    copy of the same bytes, what the card reaches in practice), and fails
    when it is slower: every reading of the kernel above every reading of
    the library call, so that the readings' own spread decides nothing."""
    slower = min(mine) > max(lib)
    copy = ("" if copy_ms is None else f"; a copy of the same bytes "
            f"{copy_ms:.4f} ms, {copy_ms / b_ms:.2f}x")
    print(f"[verdict] {label}: kernel {ms:.4f} ms vs {what} {lib_ms:.4f} ms "
          f"({'SLOWER' if slower else 'no slower'}; readings "
          f"{', '.join(f'{x:.4f}' for x in mine)} vs "
          f"{', '.join(f'{x:.4f}' for x in lib)}), {ms / b_ms:.2f}x its "
          f"{b_ms:.4f} ms bound{copy}", flush=True)
    if slower:
        fail(f"{label}: slower than {what}")


def eager_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Time of one call of ``fn`` issued back to back from the host: the
    median of ``reps`` readings of CUDA events around ``iters`` calls,
    after one warm-up call.  A call's host time is in it when that is
    longer than its device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    readings = []
    for _ in range(reps):
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        readings.append(t0.elapsed_time(t1) / iters)
    return statistics.median(readings)


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_bound(nbytes: float, flops: float):
    """The least time for float32 work at f32 accuracy (attention, the SSD
    chunk): the smaller of the CUDA cores' bound (the flops over float32's
    67 TFLOP/s) and the tensor cores' by the 3xTF32 split (three times the
    flops over TF32's 495 TFLOP/s), each no less than the bytes' time.
    Returns (ms, bytes or operations, the basis's name)."""
    fma = bound(nbytes, flops, "float32")
    tc = bound(nbytes, 3.0 * flops, "tf32")
    return (*tc, "3xTF32") if tc[0] <= fma[0] else (*fma, "f32 FMA")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------- phase 3

def check_table(label: str, tables, num_pages: int, shape) -> None:
    """A page table drawn on the card, checked on the host before any
    gather reads it: its shape, and every entry in ``[0, num_pages)``.  A
    failure names the table's min, max, shape and dtype, so that a bad
    draw fails here and not as a device-side assert in the gather."""
    host = tables.cpu()
    lo, hi = int(host.min()), int(host.max())
    if tuple(host.shape) != tuple(shape) or lo < 0 or hi >= num_pages:
        fail(f"{label}: drawn page table out of range: min {lo}, max {hi}, "
             f"shape {tuple(host.shape)} (want {tuple(shape)}, entries in "
             f"[0, {num_pages})), dtype {host.dtype}")


def check_paged_attention(torch, dev, H=32, d=128, KVH=8,
                          dtypes=("float32", "bfloat16")):
    """Decode attention over bf16 and f32 pages at granite's decode shape
    (B 8, H 32, KVH 8, d 128, pages of 16, lengths 1..2048 drawn from 2048
    + 1 pool pages), or with granite-moe's heads (``H`` 24, ``d`` 64: G 3),
    or in bf16 alone (``dtypes``) with phase 28's: qwen1.5-32b's (``H`` =
    ``KVH`` = 40: G 1) and dbrx-132b's (48/8: G 6).
    Each call must run the split-KV body and its merge once (the library's
    counters); the bf16 row (the serve path's) must be no slower than its
    plain version in every reading, and prints its time over its bytes
    bound.  Returns the bf16 row."""
    from repro_torch.kernels.paged_attention import (ops, paged_attention,
                                                     paged_attention_ref)
    B, page = 8, 16
    max_pages = 2048 // page
    num_pages = B * max_pages + 1
    g = torch.Generator(device=dev).manual_seed(SEED)
    lengths = torch.tensor(np.linspace(1, 2048, B).astype(np.int32),
                           device=dev)
    tables = torch.randperm(num_pages - 1, generator=g, device=dev)[
        :B * max_pages].reshape(B, max_pages).to(torch.int32)
    check_table("paged_attention", tables, num_pages, (B, max_pages))
    rows = {}
    for name in dtypes:
        dt = getattr(torch, name)
        q = torch.randn((B, H, d), generator=g, device=dev).to(dt)
        kc = torch.randn((num_pages, page, KVH, d), generator=g,
                         device=dev).to(dt)
        vc = torch.randn((num_pages, page, KVH, d), generator=g,
                         device=dev).to(dt)
        before = ops.body_launches()
        out = paged_attention(q, kc, vc, tables, lengths)
        torch.cuda.synchronize()
        took = {k: n - before[k] for k, n in ops.body_launches().items()}
        if took != {"body": 1, "merge": 1}:
            fail(f"paged_attention {name}: launched {took}, want the "
                 "split-KV body and its merge once each")
        ref = paged_attention_ref(q, kc, vc, tables, lengths)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2e-5 if name == "float32" else 5e-2
        if not err <= tol:
            fail(f"paged_attention {name}: max_abs_err {err} > {tol}")
        mine, theirs = [], []
        ms = time_ms(lambda: paged_attention(q, kc, vc, tables, lengths),
                     readings=mine)
        plain = time_ms(lambda: paged_attention_ref(q, kc, vc, tables,
                                                    lengths), 5,
                        readings=theirs)
        toks = int(lengths.sum())
        moved = (nbytes(q, tables, lengths) * 2 - nbytes(tables, lengths)
                 + 2 * toks * KVH * d * kc.element_size())
        b_ms, b_by = bound(moved, 4.0 * toks * H * d, name)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"[kernel] paged_attention {name} B={B} H={H} KVH={KVH} "
              f"d={d} page={page} lengths 1..2048: body+merge max_err="
              f"{err:.3g} kernel_ms={ms:.4f} ({b_ms / ms:.1%} of bound) "
              f"plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              "library_ms=none", flush=True)
        if name == "bfloat16":
            verdict(f"paged_attention {name} B={B} H={H} KVH={KVH} d={d} "
                    "lengths 1..2048", ms, mine, plain, theirs,
                    "its plain version", b_ms)
    return rows["bfloat16"]


def sdpa_call(torch, q, k, v, mask=None, causal=False):
    """The SDPA yardstick pinned to one backend: flash for the unmasked
    calls, else the first of the memory-efficient, cuDNN and math backends
    that takes the position mask; GQA through ``enable_gqa``, or with the
    kv heads expanded beforehand where the backend refuses it.  Returns
    (a function of no arguments, the backend's name)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[1] // k.shape[1]
    order = ([] if mask is not None else [SDPBackend.FLASH_ATTENTION]) + [
        SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
        SDPBackend.MATH]
    for backend in order:
        for gqa in (True, False):
            kk = k if gqa else k.repeat_interleave(G, dim=1)
            vv = v if gqa else v.repeat_interleave(G, dim=1)
            extra = {"enable_gqa": True} if gqa else {}

            def call(kk=kk, vv=vv, extra=extra, backend=backend):
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(
                        q, kk, vv, attn_mask=mask, is_causal=causal, **extra)
            try:
                call()
            except (RuntimeError, TypeError):
                continue
            return call, backend.name + (" gqa" if gqa else " expanded")
    fail("no SDPA backend takes the yardstick's call")


def check_bf16_attention(torch, label, out, plain, truth, absv, lib_out):
    """A bf16 flash row against its plain version and the float32 truth.

    ``plain`` is the plain version's bf16 output; ``truth`` its float32
    output on the same bf16 inputs; ``absv`` the plain version applied to
    |v| in float32, a = sum_j w_j |v_j| with w the softmax weights;
    ``lib_out`` SDPA's bf16 output.  The kernel rounds P to bf16 (unit
    roundoff 2^-8) before P V and sums l over the unrounded P, so before
    its output is rounded it is within 2^-8 a of the truth, and the two
    outputs' roundings add at most 2^-8 (|out| + |truth|) <= 2^-7 |plain| +
    2^-14 a.  So element by element |out - plain| <= 2^-7 |plain| + 2^-7 a
    + 2e-5 (the float32 sums' slack; the FMA body's bound was 2^-7 |plain|
    + 2e-5).  The kernel's largest error from the truth must also be at
    most twice SDPA's, plus 2e-5; and the max error 5e-2.  Returns (max
    error from plain, from truth, SDPA's from truth)."""
    diff = (out.float() - plain.float()).abs()
    bound_ = 2.0 ** -7 * plain.float().abs() + 2.0 ** -7 * absv + 2e-5
    err = diff.max().item()
    if not (bool((diff <= bound_).all()) and err <= 5e-2):
        fail(f"{label}: beyond the derived bound by "
             f"{(diff - bound_).max().item():.3g} (max_abs_err {err})")
    t_err = (out.float() - truth).abs().max().item()
    l_err = (lib_out.float() - truth).abs().max().item()
    if not t_err <= 2 * l_err + 2e-5:
        fail(f"{label}: {t_err:.3g} from the float32 truth, SDPA {l_err:.3g}")
    return err, t_err, l_err


def check_body(torch, label, fn, want):
    """Fails unless one call of ``fn`` launches the flash body ``want``
    ("wgmma" or "tf32x3") once and no other body, by the library's body
    counters (``ops.body_launches``; a split's merge aside).  Returns the
    bodies it took, e.g. "wgmma+merge" for a split."""
    from repro_torch.kernels.flash_prefill.ops import BODIES, body_launches
    before = body_launches()
    fn()
    torch.cuda.synchronize()
    took = {k: n - before[k] for k, n in body_launches().items()}
    if took[want] != 1 or any(took[k] for k in BODIES
                              if k not in (want, "merge")):
        fail(f"{label}: launched {took}, want the {want} body once")
    return "+".join(k for k in BODIES if took[k])


FLASH_PREFIX_CASES = (("float32", 256, 1000), ("bfloat16", 16, 0),
                      ("bfloat16", 16, 1000), ("bfloat16", 256, 0),
                      ("bfloat16", 256, 1000))


def check_flash_prefix(torch, dev, H=32, d=128, cases=FLASH_PREFIX_CASES,
                       KVH=8):
    """The prefix kernel at granite's chunk shapes (B 1, H 32, KVH 8, d
    128, Smax 2048, strided k/v as the serve path passes them): f32 (the
    FMA body, 2e-5) and bf16 (the wgmma body: the derived element-wise
    bound, the float32-truth check against SDPA, 5e-2) at chunks of 16 and
    256 at positions 0 and 1000; or at ``cases`` with granite-moe's heads
    (``H`` 24, ``d`` 64: G 3, 21 rows of each head in the body's 64) or
    stablelm-3b's (``H`` = ``KVH`` = 32, ``d`` 80: two 64-column panels,
    the second zero past column 80).  The
    body counters name the bodies each takes (C 16 at 1000 splits its
    keys: body and merge).  SDPA with the position mask, pinned to one
    backend (printed), is the yardstick; the bf16 C 256 row at 1000 must be
    no slower in every reading.  Times are device times (:func:`time_ms`)
    and, for bf16, also a host loop's per-call time (:func:`eager_ms`).
    Returns the bf16 C 256 row at position 1000."""
    from repro_torch.kernels.flash_prefill import (flash_prefill_prefix,
                                                   flash_prefill_prefix_ref)
    B, Smax = 1, 2048
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    main = None
    for name, C, st in cases:
        dt = getattr(torch, name)
        label = (f"flash_prefill_prefix {name} H={H} KVH={KVH} d={d} C={C} "
                 f"start={st}")
        q = torch.randn((B, H, C, d), generator=g, device=dev).to(dt)
        # k/v as the serve path passes them: transposed views of the
        # page-gathered (B, Smax, KVH, d) stripe
        k = torch.randn((B, Smax, KVH, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
        v = torch.randn((B, Smax, KVH, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
        start = torch.full((B,), st, dtype=torch.int32, device=dev)
        out = flash_prefill_prefix(q, k, v, start)
        ref = flash_prefill_prefix_ref(q, k, v, start)
        torch.cuda.synchronize()
        qpos = st + torch.arange(C, device=dev)
        mask = torch.arange(Smax, device=dev)[None, :] <= qpos[:, None]
        lib, backend = sdpa_call(torch, q, k, v, mask=mask)
        if name == "float32":
            err = (out - ref).abs().max().item()
            if not err <= 2e-5:
                fail(f"{label}: max_abs_err {err} > 2e-05")
            extra = ""
            body = check_body(torch, label,
                              lambda: flash_prefill_prefix(q, k, v, start),
                              "tf32x3")
        else:
            qf, kf, vf = q.float(), k.float(), v.float()
            err, t_err, l_err = check_bf16_attention(
                torch, label, out, ref,
                flash_prefill_prefix_ref(qf, kf, vf, start),
                flash_prefill_prefix_ref(qf, kf, vf.abs(), start), lib())
            body = check_body(torch, label,
                              lambda: flash_prefill_prefix(q, k, v, start),
                              "wgmma")
            e_ms = eager_ms(lambda: flash_prefill_prefix(q, k, v, start))
            extra = (f" truth_err={t_err:.3g} (SDPA {l_err:.3g}) eager_ms="
                     f"{e_ms:.4f} library_eager_ms={eager_ms(lib):.4f}")
        mine, theirs = [], []
        ms = time_ms(lambda: flash_prefill_prefix(q, k, v, start),
                     readings=mine)
        plain = time_ms(lambda: flash_prefill_prefix_ref(q, k, v, start), 5)
        lib_ms = time_ms(lib, readings=theirs)
        visible = C * st + C * (C + 1) // 2       # keys each row attends
        n_kv = st + C
        moved = nbytes(q) * 2 + 2 * n_kv * KVH * d * k.element_size() + 4
        if name == "float32":
            b_ms, b_by, basis = f32_bound(moved,
                                                    4.0 * visible * H * d)
            b_by_txt = f"{b_by}, {basis}"
        else:
            b_ms, b_by = bound(moved, 4.0 * visible * H * d, name)
            b_by_txt = b_by
        print(f"[kernel] {label} Smax={Smax}: body {body} max_err={err:.3g}"
              f" kernel_ms={ms:.4f} ({b_ms / ms:.1%} of bound) plain_ms="
              f"{plain:.4f} bound_ms={b_ms:.4f} ({b_by_txt}) library_ms="
              f"{lib_ms:.4f} (SDPA {backend}){extra}", flush=True)
        if name == "bfloat16" and C == 256 and st == 1000:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms)
            verdict(f"flash_prefill_prefix bf16 H={H} KVH={KVH} d={d} C=256 "
                    "start=1000", ms, mine, lib_ms, theirs, f"SDPA {backend}",
                    b_ms)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return main


# the pack's kernel shapes: per bucket, each row's chunk length at starts
# PACK_KERNEL_STARTS (the last row is pack padding, chunk length 0)
PACK_KERNEL_STARTS = (0, 256, 512, 1000)
PACK_KERNEL_CASES = ((256, (256, 200, 17, 0)), (32, (32, 25, 17, 0)),
                     (16, (16, 9, 1, 0)))


def check_flash_prefix_pack(torch, dev):
    """The prefix kernel at a pack's shapes on granite (B 4 = the pack
    width, H 32, KVH 8, d 128, Smax 2048, bf16; starts 0/256/512/1000,
    ragged chunk lengths and a padding row of length 0; q, k and v as
    transposed views, as the packs pass them) at bucket 256 (no split)
    and at buckets 32 and 16, which the plan splits (body and merge).
    Each member's rows are held against the plain version on the same
    tensors with :func:`check_bf16_attention`, every output row must be
    finite, and the body counters must show the body and merge the plan
    names."""
    from repro_torch.kernels.flash_prefill import (flash_prefill_prefix,
                                                   flash_prefill_prefix_ref)
    from repro_torch.kernels.flash_prefill.plan import num_splits
    B, H, KVH, d, Smax = len(PACK_KERNEL_STARTS), 32, 8, 128, 2048
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    start = torch.tensor(PACK_KERNEL_STARTS, dtype=torch.int32, device=dev)
    for C, lens in PACK_KERNEL_CASES:
        label = (f"flash_prefill_prefix pack B={B} C={C} starts "
                 f"{list(PACK_KERNEL_STARTS)} lengths {list(lens)}")
        q = torch.randn((B, C, H, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
        k = torch.randn((B, Smax, KVH, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
        v = torch.randn((B, Smax, KVH, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
        out = flash_prefill_prefix(q, k, v, start)
        qf, kf, vf = q.float(), k.float(), v.float()
        ref = flash_prefill_prefix_ref(q, k, v, start)
        truth = flash_prefill_prefix_ref(qf, kf, vf, start)
        absv = flash_prefill_prefix_ref(qf, kf, vf.abs(), start)
        qpos = start[:, None] + torch.arange(C, device=dev)[None]
        mask = (torch.arange(Smax, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]              # (B, 1, C, Smax)
        lib, backend = sdpa_call(torch, q, k, v, mask=mask)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out.float()).all()):
            fail(f"{label}: non-finite output rows")

        def members(t):
            return torch.cat([t[b, :, :n] for b, n in enumerate(lens) if n],
                             dim=1)
        err, t_err, l_err = check_bf16_attention(
            torch, label, members(out), members(ref), members(truth),
            members(absv), members(lib()))
        nsplit = num_splits(B, KVH, H // KVH, C, Smax)
        want = "wgmma+merge" if nsplit > 1 else "wgmma"
        body = check_body(torch, label,
                          lambda: flash_prefill_prefix(q, k, v, start),
                          "wgmma")
        if body != want:
            fail(f"{label}: took {body}, the plan ({nsplit} splits) names "
                 f"{want}")
        ms = time_ms(lambda: flash_prefill_prefix(q, k, v, start))
        plain = time_ms(lambda: flash_prefill_prefix_ref(q, k, v, start), 5)
        print(f"[kernel] {label}: body {body} ({nsplit} splits) members' "
              f"rows max_err={err:.3g} truth_err={t_err:.3g} (SDPA "
              f"{backend} {l_err:.3g}) kernel_ms={ms:.4f} plain_ms="
              f"{plain:.4f}", flush=True)
        del q, k, v, out, ref, truth, absv
    torch.cuda.empty_cache()

# the verify step's kernel shape: B 8 lanes of C = spec_k + 1 = 4 queries,
# ragged starts from 60 to 2040 (the last two within a few tokens of the
# dense stripe's end), Smax 2048 (dense) and 2064 (paged: 128 pages of 16
# plus the lane's scratch page, so the last key tile is partial)
VERIFY_STARTS = (60, 300, 700, 1100, 1500, 1900, 2030, 2040)
VERIFY_C = 4


def check_flash_prefix_verify(torch, dev):
    """The prefix kernel at the verify step's shapes on granite (B 8, C 4,
    H 32, KVH 8, d 128, bf16, starts VERIFY_STARTS; q, k and v as the
    transposed views the verify passes) at Smax 2048 and 2064: the derived
    bf16 bound and the float32-truth check (``check_bf16_attention``), the
    body counters (the wgmma body, and its merge when the plan splits),
    the kernel's time, its bound from this run's starts, the plain
    version's time and SDPA's, pinned to one backend and named.  Returns
    ``{Smax: row}``."""
    from repro_torch.kernels.flash_prefill import (flash_prefill_prefix,
                                                   flash_prefill_prefix_ref)
    from repro_torch.kernels.flash_prefill.plan import num_splits
    B, H, KVH, d, C = len(VERIFY_STARTS), 32, 8, 128, VERIFY_C
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    start = torch.tensor(VERIFY_STARTS, dtype=torch.int32, device=dev)
    rows = {}
    for Smax in (2048, 2064):
        label = f"flash_prefill_prefix verify B={B} C={C} Smax={Smax}"
        q = torch.randn((B, C, H, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
        k = torch.randn((B, Smax, KVH, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
        v = torch.randn((B, Smax, KVH, d), generator=g,
                        device=dev).to(dt).transpose(1, 2)
        out = flash_prefill_prefix(q, k, v, start)
        qf, kf, vf = q.float(), k.float(), v.float()
        ref = flash_prefill_prefix_ref(q, k, v, start)
        qpos = start[:, None] + torch.arange(C, device=dev)[None]
        mask = (torch.arange(Smax, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]              # (B, 1, C, Smax)
        lib, backend = sdpa_call(torch, q, k, v, mask=mask)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out.float()).all()):
            fail(f"{label}: non-finite output rows")
        err, t_err, l_err = check_bf16_attention(
            torch, label, out, ref, flash_prefill_prefix_ref(qf, kf, vf,
                                                             start),
            flash_prefill_prefix_ref(qf, kf, vf.abs(), start), lib())
        nsplit = num_splits(B, KVH, H // KVH, C, Smax)
        want = "wgmma+merge" if nsplit > 1 else "wgmma"
        body = check_body(torch, label,
                          lambda: flash_prefill_prefix(q, k, v, start),
                          "wgmma")
        if body != want:
            fail(f"{label}: took {body}, the plan ({nsplit} splits) names "
                 f"{want}")
        ms = time_ms(lambda: flash_prefill_prefix(q, k, v, start))
        plain = time_ms(lambda: flash_prefill_prefix_ref(q, k, v, start), 5)
        lib_ms = time_ms(lib)
        e_ms = eager_ms(lambda: flash_prefill_prefix(q, k, v, start))
        # this run's work: lane b's C queries see start_b + i + 1 keys
        visible = sum(C * s + C * (C + 1) // 2 for s in VERIFY_STARTS)
        n_kv = sum(min(s + C, Smax) for s in VERIFY_STARTS)
        moved = nbytes(q) * 2 + 2 * n_kv * KVH * d * 2 + 4 * B
        b_ms, b_by = bound(moved, 4.0 * visible * H * d, "bfloat16")
        print(f"[kernel] {label} starts {list(VERIFY_STARTS)}: body {body} "
              f"({nsplit} splits) max_err={err:.3g} truth_err={t_err:.3g} "
              f"(SDPA {l_err:.3g}) kernel_ms={ms:.4f} ({b_ms / ms:.1%} of "
              f"bound) plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"library_ms={lib_ms:.4f} (SDPA {backend}) eager_ms="
              f"{e_ms:.4f}", flush=True)
        rows[Smax] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return rows


# granite's training shape first (the row the kernels line reports), then
# bidirectional, bf16, a ragged S, d 64 and one serving prompt of 2048
FLASH_FULL_CASES = (("float32", 4, 1024, 128, True),
                    ("float32", 4, 1024, 128, False),
                    ("bfloat16", 4, 1024, 128, True),
                    ("float32", 4, 1000, 128, True),
                    ("float32", 4, 1024, 64, False),
                    ("bfloat16", 1, 2048, 128, True))


def check_flash_prefill(torch, dev, H=32, KVH=8, cases=FLASH_FULL_CASES):
    """The full-sequence flash kernel at the training path's shape (B 4,
    H 32, KVH 8, S 1024, d 128, the (B, S, H, d) projections viewed as
    (B, H, S, d) without a copy): f32 causal and bidirectional (2e-5, the
    3xTF32 body), bf16 causal (the wgmma body, held as
    :func:`check_bf16_attention` holds it), a ragged S of 1000 and d 64
    bidirectional (f32, 2e-5), and bf16 causal at B 1, S 2048 (one prompt
    of ``Model.prefill``'s largest serving bucket); or ``cases`` at other
    heads (stablelm-3b's training shape, H = KVH = 32, d 80; seamless's
    encoder, bf16 bidirectional, H = KVH = 16, S 4096, d 64).  SDPA pinned
    to one backend is the yardstick; the first case must be no slower
    (:func:`verdict`).  The bound counts the visible (query, key) pairs: 4
    d flops each.  Returns the first case's row (granite's: the shape
    training runs)."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_ref)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    main = None
    for name, B, S, d, causal in cases:
        dt = getattr(torch, name)

        def mk(heads):
            return torch.randn((B, S, heads, d), generator=g,
                               device=dev).to(dt).transpose(1, 2)
        q, k, v = mk(H), mk(KVH), mk(KVH)
        out = flash_prefill(q, k, v, causal=causal)
        ref = flash_prefill_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        kind = "causal" if causal else "bidirectional"
        label = f"flash_prefill {name} {kind} B={B} S={S} d={d}"
        lib, backend = sdpa_call(torch, q, k, v, causal=causal)
        if name == "float32":
            err = (out - ref).abs().max().item()
            if not err <= 2e-5:
                fail(f"{label}: max_abs_err {err} > 2e-05")
            body = check_body(torch, label,
                              lambda: flash_prefill(q, k, v, causal=causal),
                              "tf32x3")
            extra = f" body {body}"
        else:
            qf, kf, vf = q.float(), k.float(), v.float()
            err, t_err, l_err = check_bf16_attention(
                torch, label, out, ref,
                flash_prefill_ref(qf, kf, vf, causal=causal),
                flash_prefill_ref(qf, kf, vf.abs(), causal=causal), lib())
            body = check_body(torch, label,
                              lambda: flash_prefill(q, k, v, causal=causal),
                              "wgmma")
            extra = f" body {body} truth_err={t_err:.3g} (SDPA {l_err:.3g})"
            del qf, kf, vf
        mine, theirs = [], []
        ms = time_ms(lambda: flash_prefill(q, k, v, causal=causal), 10,
                     readings=mine)
        plain = time_ms(lambda: flash_prefill_ref(q, k, v, causal=causal), 5)
        lib_ms = time_ms(lib, 10, readings=theirs)
        visible = S * (S + 1) // 2 if causal else S * S
        flops = 4.0 * B * H * d * visible
        if name == "float32":
            b_ms, b_by, basis = f32_bound(nbytes(q, k, v, out),
                                                    flops)
        else:
            (b_ms, b_by), basis = bound(nbytes(q, k, v, out), flops,
                                        name), name
        print(f"[kernel] {label} H={H} KVH={KVH}: max_err={err:.3g} "
              f"kernel_ms={ms:.4f} ({b_ms / ms:.1%} of bound) plain_ms="
              f"{plain:.4f} bound_ms={b_ms:.4f} ({b_by}, {basis}) library_ms="
              f"{lib_ms:.4f} (SDPA {backend}){extra}", flush=True)
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms)
            verdict(label, ms, mine, lib_ms, theirs, f"SDPA {backend}",
                    b_ms)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return main


KV_QUANT_GRANITE = (40 * 64 * 16 * 8, 128)   # 1024 tokens of granite K
KV_QUANT_MOE = (32 * 21 * 16 * 8, 64)        # granite-moe's 336-token lane


def check_kv_quant(torch, dev, shape=KV_QUANT_GRANITE):
    """INT8 quantize and dequantize at one granite swap's rows (327,680 x
    128), or at ``shape``: granite-moe's swap of one lane's 336-token
    budget (phase 24 (d): 32 layers x 21 pages of 16 x 8 KV heads = 86,016
    rows of 64, where the 16-byte dequantize body lays 4 threads on a row
    and 64 rows on a block, against 8 and 32 at 128).  Codes within 1 of
    the plain version, scales within 1e-6
    relative, zeros within 1; dequantize equal to its plain version bit for
    bit in float32 (same operations in the same order) and in bfloat16 (its
    round to nearest even), through the 16-byte body (``ops.body_launches``);
    the round trip within 2% of the input.  Dequantize's time is printed
    beside its bound and a copy of the same bytes, and gated against its
    plain version (:func:`verdict`)."""
    from repro_torch.kernels.kv_quant import (kv_dequantize,
                                              kv_dequantize_ref, kv_quantize,
                                              kv_quantize_ref)
    from repro_torch.kernels.kv_quant import ops as kv_ops
    T, d = shape
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn((T, d), generator=g, device=dev) * 4.0
    before = kv_ops.body_launches("quantize")
    q, lam, z = kv_quantize(x)
    torch.cuda.synchronize()
    body = {n: c - before[n]
            for n, c in kv_ops.body_launches("quantize").items()}
    if body != {"vec16": 1, "scalar": 0}:
        fail(f"kv_quantize: took bodies {body}, want the 16-byte body")
    code_err, n_diff = _quant_parity(torch, "kv_quantize", [(q, lam, z)],
                                     [kv_quantize_ref(x)])
    for dt, view in ((torch.bfloat16, torch.int16),
                     (torch.float32, torch.int32)):
        before = kv_ops.body_launches()
        xh = kv_dequantize(q, lam, z, dtype=dt)
        torch.cuda.synchronize()
        body = {k: n - before[k] for k, n in kv_ops.body_launches().items()}
        xr = kv_dequantize_ref(q, lam, z, dtype=dt)
        if not torch.equal(xh.view(view), xr.view(view)):
            fail(f"kv_dequantize {dt}: not bit for bit the plain version "
                 f"(max_abs_err {(xh.float() - xr.float()).abs().max()})")
        if body != {"vec16": 1, "scalar": 0}:
            fail(f"kv_dequantize {dt}: took bodies {body}, want the 16-byte "
                 "body")
    deq_err = (xh - xr).abs().max().item()
    rel = ((xh - x).abs().max() / x.abs().max()).item()
    if not rel < 0.02:
        fail(f"kv quant round trip: relative error {rel} >= 0.02")
    qm = time_ms(lambda: kv_quantize(x))
    qp = time_ms(lambda: kv_quantize_ref(x), 5)
    mine, theirs = [], []
    dm = time_ms(lambda: kv_dequantize(q, lam, z), readings=mine)
    dp = time_ms(lambda: kv_dequantize_ref(q, lam, z), 5, readings=theirs)
    qb, qby = bound(nbytes(x, q, lam, z), 6.0 * T * d, "float32")
    moved = nbytes(q, lam, z, xh)
    db, dby = bound(moved, 3.0 * T * d, "float32")
    src = torch.empty(moved // 8, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    print(f"[kernel] kv_quantize T={T} d={d} f32->int8: code_err={code_err} "
          f"codes_differing={n_diff} of {T * d}, body vec16 "
          f"kernel_ms={qm:.4f} ({qb / qm:.1%} of bound) plain_ms={qp:.4f} "
          f"bound_ms={qb:.4f} ({qby}) library_ms=none", flush=True)
    print(f"[kernel] kv_dequantize T={T} d={d} int8->f32: bitwise equal "
          f"(f32 and bf16), body vec16, roundtrip_rel={rel:.4f} kernel_ms="
          f"{dm:.4f} ({db / dm:.1%} of bound) plain_ms={dp:.4f} bound_ms="
          f"{db:.4f} ({dby}) copy_ms={copy_ms:.4f} (a copy of the same "
          f"{moved / 1e6:.1f} MB) library_ms=none", flush=True)
    verdict(f"kv_dequantize int8->f32 ({T}, {d})", dm, mine, dp, theirs,
            "its plain version", db, copy_ms=copy_ms)
    del src, dst
    return (dict(max_abs_err=float(code_err), codes_differing=n_diff,
                 ms=qm, plain_ms=qp, bound_ms=qb, bound_by=qby,
                 library_ms=None),
            dict(max_abs_err=deq_err, ms=dm, plain_ms=dp, bound_ms=db,
                 bound_by=dby, library_ms=None))


def check_kv_quant_page(torch, dev):
    """INT8 quantize and dequantize at the KV tier's page shape (phase
    22): one granite page of K, 40 layers x 16 tokens x 8 KV heads =
    5120 rows of 128, float32 in (the (T, d) entry; the tier's own page
    goes through the store entry, :func:`check_kv_quant_store`) and
    bfloat16 out (the pool's dtype), against their plain versions with
    :func:`check_kv_quant`'s tolerances (codes within 1, scales within
    1e-6 relative, zeros within 1, dequantize bit for bit), each with its
    time, plain time and bound.  Returns the two rows' numbers."""
    from repro_torch.kernels.kv_quant import (kv_dequantize,
                                              kv_dequantize_ref, kv_quantize,
                                              kv_quantize_ref)
    T, d = 40 * 16 * 8, 128
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    x = torch.randn((T, d), generator=g, device=dev) * 4.0
    q, lam, z = kv_quantize(x)
    xh = kv_dequantize(q, lam, z, dtype=torch.bfloat16)
    xr = kv_dequantize_ref(q, lam, z, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    code_err, n_diff = _quant_parity(torch, "kv_quantize at the tier page "
                                     "shape", [(q, lam, z)],
                                     [kv_quantize_ref(x)])
    if not torch.equal(xh.view(torch.int16), xr.view(torch.int16)):
        fail("kv_dequantize at the tier page shape: not bit for bit the "
             "plain version")
    rel = ((xh.float() - x).abs().max() / x.abs().max()).item()
    if not rel < 0.02:
        fail(f"kv quant round trip at the tier page shape: {rel} >= 0.02")
    rows = {}
    held = {"kv_quantize": f"code_err={code_err} codes_differing={n_diff}",
            "kv_dequantize": "bitwise equal"}
    for name, fn, plain, moved, flops in (
            ("kv_quantize", lambda: kv_quantize(x),
             lambda: kv_quantize_ref(x), nbytes(x, q, lam, z), 6.0 * T * d),
            ("kv_dequantize", lambda: kv_dequantize(q, lam, z,
                                                    dtype=torch.bfloat16),
             lambda: kv_dequantize_ref(q, lam, z, dtype=torch.bfloat16),
             nbytes(q, lam, z, xh), 3.0 * T * d)):
        ms = time_ms(fn)
        pms = time_ms(plain, 5)
        b_ms, b_by = bound(moved, flops, "float32")
        rows[name] = dict(rows=T, d=d, ms=ms, plain_ms=pms, bound_ms=b_ms,
                          bound_by=b_by,
                          max_abs_err=(float(code_err) if name ==
                                       "kv_quantize" else 0.0))
        print(f"[kernel] {name} tier page T={T} d={d} "
              f"{'f32->int8' if name == 'kv_quantize' else 'int8->bf16'}: "
              f"{held[name]}"
              f" roundtrip_rel={rel:.4f} kernel_ms={ms:.4f} ({b_ms / ms:.1%} "
              f"of bound) plain_ms={pms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              "library_ms=none", flush=True)
    return rows


# the store entry's shapes, a request's pages of a bf16 pool (pool pages,
# pages taken, tokens): one granite swap of 1000 tokens in 64 pages,
# granite-moe's lane of phase 24 (d) (21 pages, 330 tokens); the tier
# page (phase 22) is one page view of K, no length
KV_STORE_GRANITE = dict(L=40, KVH=8, d=128, pool=129, pages=64, length=1000)
KV_STORE_MOE = dict(L=32, KVH=8, d=64, pool=43, pages=21, length=330)
KV_STORE_PAGE = dict(L=40, KVH=8, d=128, pool=8, pages=None, length=None)


def _quant_parity(torch, label, got, want):
    """Codes within 1 of the plain version (the count that differ
    returned), scales within 1e-6 relative, zeros within 1; else fail."""
    code_err = max((g[0].int() - w[0].int()).abs().max().item()
                   for g, w in zip(got, want))
    n_diff = sum(int((g[0] != w[0]).sum()) for g, w in zip(got, want))
    if code_err > 1 or not all(
            torch.allclose(g[1], w[1], rtol=1e-6, atol=0)
            and (g[2] - w[2]).abs().max().item() <= 1
            for g, w in zip(got, want)):
        fail(f"{label}: codes differ by {code_err}, or the scales/zeros "
             "differ from the plain version")
    return code_err, n_diff


def check_kv_quant_store(torch, dev, label, L, KVH, d, pool, pages, length):
    """The store entry of the quantize kernel (``kv_quantize_store``), the
    swap's device half, at a main path's shape: K and V of a bf16 paged
    pool (L, ``pool``, 16, KVH, d) read where they lie through ``pages``
    page indices drawn at random, positions past ``length`` masked, one
    launch (``pages`` None: one page view ``pool[:, 3]`` of K alone, as
    the KV tier quantizes a page).  Held against its plain version
    (gather, mask, float32, ``kv_quantize_ref``): codes within 1 (how
    many differ printed), scales within 1e-6 relative, zeros within 1,
    the masked rows exactly a zero row's (lam 1e-8, z -0.0, codes -128),
    the 16-byte body taken.  Timed (``time_ms``) beside its bound (the
    rows it must read once, its codes, scales and zeros written once), its
    plain version and the path it replaced (for each of K and V: gather,
    mask, float32 copy, the (T, d) entry).  With a length, also a whole
    offload the old way (those steps, then three blocking copies into
    pageable memory, for K and V) against ``quantize_kv_store`` (one
    launch, one copy into pinned memory, one sync): walls and the device
    memory each adds at its peak, the first call apart."""
    from repro_torch.kernels.kv_quant import (kv_quantize, kv_quantize_store,
                                              kv_quantize_store_ref)
    from repro_torch.kernels.kv_quant import ops as kv_ops
    from repro_torch.kernels.kv_quant.ref import store_view
    from repro_torch.serving.kv_cache import quantize_kv_store
    pg = 16
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    k = (torch.randn((L, pool, pg, KVH, d), generator=g, device=dev)
         * 4.0).to(torch.bfloat16)
    v = (torch.randn((L, pool, pg, KVH, d), generator=g, device=dev)
         * 4.0).to(torch.bfloat16)
    if pages is None:
        xs, idx, P = (k[:, 3],), None, 1
    else:
        xs = (k, v)
        idx = torch.randperm(pool, generator=g, device=dev)[:pages]
        P = pages
    before = kv_ops.body_launches("quantize")
    got, _ = kv_quantize_store(xs, pages=idx, length=length)
    torch.cuda.synchronize()
    body = {n: c - before[n]
            for n, c in kv_ops.body_launches("quantize").items()}
    want = kv_quantize_store_ref(xs, idx, length)
    code_err, n_diff = _quant_parity(torch, f"kv_quantize_store {label}",
                                     got, want)
    if body != {"vec16": 1, "scalar": 0}:
        fail(f"kv_quantize_store {label}: took bodies {body}, want the "
             "16-byte body")
    rows = L * P * pg * KVH
    valid = rows if length is None else L * min(length, P * pg) * KVH
    if length is not None:
        for q, lam, z in got:
            cut = (slice(None), slice(length, None))
            ql = q.view(L, P * pg, KVH, d)[cut]
            ll = lam.view(L, P * pg, KVH)[cut]
            zl = z.view(L, P * pg, KVH)[cut]
            if not (bool((ql == -128).all()) and bool((ll == 1e-8).all())
                    and bool((zl == 0).all())
                    and bool(torch.signbit(zl).all())):
                fail(f"kv_quantize_store {label}: a masked row is not a "
                     "zero row's codes (lam 1e-8, z -0.0, codes -128)")
    pos = (None if length is None else torch.arange(
        P * pg, device=dev).reshape(1, P, pg, 1, 1))

    def old_path():
        out = []
        for x in xs:
            arr = store_view(x)
            if idx is not None:
                arr = arr[:, idx]
            if pos is not None:
                arr = torch.where(pos < length, arr, torch.zeros_like(arr))
            out.append(kv_quantize(arr.reshape(-1, d).float().contiguous()))
        return out
    ms = time_ms(lambda: kv_quantize_store(xs, pages=idx, length=length))
    plain = time_ms(lambda: kv_quantize_store_ref(xs, idx, length), 5)
    old = time_ms(old_path, 5)
    n = len(xs)
    b_ms, b_by = bound(n * (valid * d * 2 + rows * d + 8 * rows),
                       6.0 * n * rows * d, "float32")
    print(f"[kernel] kv_quantize_store {label} (L {L}, {P} pages of {pg}, "
          f"length {length}, KVH {KVH}, d {d}, bf16, {'K and V' if n == 2 else 'K'}"
          f"): code_err={code_err} codes_differing={n_diff} of "
          f"{n * rows * d}{'' if length is None else ', masked rows exact'}"
          f", body vec16 kernel_ms={ms:.4f} "
          f"({b_ms / ms:.1%} of bound) plain_ms={plain:.4f} old_path_ms="
          f"{old:.4f} ({old / ms:.2f}x) bound_ms={b_ms:.4f} ({b_by}) "
          "library_ms=none", flush=True)
    row = dict(max_abs_err=float(code_err), codes_differing=n_diff, ms=ms,
               plain_ms=plain, old_path_ms=old, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, shape=dict(L=L, pages=P, page=pg, KVH=KVH,
                                           d=d, length=length))
    if length is not None:
        shape = (L, P, pg, KVH, d)

        def old_offload():
            return [tuple(t.cpu() for t in trip) for trip in old_path()]

        def new_offload():
            return quantize_kv_store(xs, shape, pages=idx, length=length)

        # old, new, new, old, 3 calls each: the first call of each apart
        walls = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            fn = old_offload if name == "old" else new_offload
            walls[name] += [measured_offload(torch, fn)[1:]
                            for _ in range(3)]
        kv_bytes = nbytes(*xs) * P // pool
        for name in ("old", "new"):
            w = walls[name]
            later = [x[0] for x in w[1:]]
            row[f"offload_{name}"] = dict(
                first_ms=w[0][0], later_ms=statistics.median(later),
                peak_bytes=max(x[1] for x in w))
            print(f"[swap] {label} offload, {name} path: first "
                  f"{w[0][0]:.2f} ms, later {statistics.median(later):.2f} "
                  f"ms (median of {len(later)}), device memory added "
                  f"{max(x[1] for x in w) / 1e6:.1f} MB "
                  f"({max(x[1] for x in w) / kv_bytes:.2f}x the request's "
                  f"K + V {kv_bytes / 1e6:.1f} MB)", flush=True)
    del k, v, xs, got, want
    torch.cuda.empty_cache()
    return row


def _q8_pool(torch, kv_quantize, k):
    """INT8 codes and float32 per-row scales and zeros of a (num_pages,
    page, KVH, d) pool through the ``kv_quantize`` kernel."""
    shape = tuple(k.shape)
    q, lam, z = kv_quantize(k.float().reshape(-1, shape[-1]).contiguous())
    return (q.reshape(shape), lam.reshape(*shape[:-1], 1),
            z.reshape(*shape[:-1], 1))


def check_paged_attention_q8(torch, dev):
    """Decode attention over INT8 pages at two shapes: the reference's
    kernel bench row (``benchmarks/bench_kernels.py:67``: B 8, H = KVH = 8,
    d 128, pages of 64, 64 pages a sequence so context 4096, a pool of 512
    pages drawn at random into the tables, float32 q) and granite's decode
    (B 8, H 32, KVH 8, d 128, pages of 16, lengths 1..2048, bf16 q).  The
    codes come from the ``kv_quantize`` kernel.  Each row is held against
    ``paged_attention_q8_ref`` (float32 within 2e-5; bfloat16 element by
    element within one bf16 rounding step of the plain output plus 2e-5,
    both sides accumulating in f32 and rounding once) and its distance
    from float attention on the unquantized pages must stay below 0.05
    (``tests/test_kernels.py:122``'s bound).  The bound counts the codes,
    scales and zeros of the distinct pool rows the live table entries name
    (the bench's tables are drawn with replacement, so lanes share pages),
    q, the tables, the lengths and the output.  Returns the bench row."""
    from repro_torch.kernels.kv_quant import (kv_quantize, paged_attention_q8,
                                              paged_attention_q8_ref)
    from repro_torch.kernels.paged_attention import paged_attention_ref
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    main = None
    for label, name, B, H, KVH, page, npg, maxp in (
            ("bench", "float32", 8, 8, 8, 64, 512, 64),
            ("granite", "bfloat16", 8, 32, 8, 16, 8 * 128 + 1, 128)):
        d = 128
        dt = getattr(torch, name)
        q = torch.randn((B, H, d), generator=g, device=dev).to(dt)
        k = torch.randn((npg, page, KVH, d), generator=g, device=dev).to(dt)
        v = torch.randn((npg, page, KVH, d), generator=g, device=dev).to(dt)
        if label == "bench":
            tables = torch.randint(0, npg, (B, maxp), generator=g,
                                   device=dev, dtype=torch.int32)
            lengths = torch.full((B,), maxp * page, dtype=torch.int32,
                                 device=dev)
        else:
            tables = torch.randperm(npg - 1, generator=g, device=dev)[
                :B * maxp].reshape(B, maxp).to(torch.int32)
            lengths = torch.tensor(np.linspace(1, maxp * page, B)
                                   .astype(np.int32), device=dev)
        check_table(f"paged_attention_q8 {label}", tables, npg, (B, maxp))
        kq, klam, kz = _q8_pool(torch, kv_quantize, k)
        vq, vlam, vz = _q8_pool(torch, kv_quantize, v)
        args = (q, kq, klam, kz, vq, vlam, vz, tables, lengths)
        out = paged_attention_q8(*args)
        ref = paged_attention_q8_ref(*args)
        fp = paged_attention_ref(q, k, v, tables, lengths)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        dist = (out.float() - fp.float()).abs().max().item()
        if name == "float32":
            ok = err <= 2e-5
        else:
            ok = bool((diff <= 2.0 ** -7 * ref.float().abs() + 2e-5).all())
        if not ok:
            fail(f"paged_attention_q8 {label} {name}: max_abs_err {err} "
                 "beyond its tolerance")
        if not dist < 0.05:
            fail(f"paged_attention_q8 {label}: {dist} from float attention")
        ms = time_ms(lambda: paged_attention_q8(*args))
        plain = time_ms(lambda: paged_attention_q8_ref(*args), 5)
        toks = int(lengths.sum())
        # pool rows (page, slot) the live positions name, each read once
        pos = torch.arange(maxp * page, device=dev)
        rows = (tables.long()[:, pos // page] * page + pos % page)[
            pos[None] < lengths.long()[:, None]]
        n_rows = int(torch.unique(rows).numel())
        moved = (2 * n_rows * KVH * (d + 8) + nbytes(q, tables, lengths)
                 + nbytes(out))
        b_ms, b_by = bound(moved, toks * (4.0 * H * d + 6.0 * KVH * d),
                           "float32")
        print(f"[kernel] paged_attention_q8 {label} {name} B={B} H={H} "
              f"KVH={KVH} d={d} page={page} context {maxp * page} max, "
              f"{toks} tokens over {n_rows} distinct pool rows: "
              f"max_err={err:.3g} from_float_attention="
              f"{dist:.3g} kernel_ms={ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) library_ms=none", flush=True)
        if label == "bench":
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
        del q, k, v, kq, vq, klam, kz, vlam, vz, out, ref, fp, args, diff
    torch.cuda.empty_cache()
    return main


def check_fused_rmsnorm(torch, dev):
    """The RMSNorm kernel at each main path's widths, bf16 and f32: mamba's
    d_model 2560 and gate-norm d_inner 5120 for a decode batch (8 rows) and
    a 1024-token prefill, granite's d_model 4096 and granite-moe's 1536
    for a decode batch and a 256-token prefill chunk, jamba's d_model 8192
    and gate-norm d_inner 16384 for a 1024-token prefill;
    ``torch.nn.functional.rms_norm`` is the
    library yardstick.  float32 must agree to 2e-5 (relative beyond 1);
    bfloat16 must be within one bfloat16 rounding step of the plain output,
    element by element (both sum in float32, so only the final rounding can
    differ).  Times are device times (:func:`time_ms`) and a host loop's
    per-call times (:func:`eager_ms`) of the kernel and the library call.
    Returns the bf16 (1024, 5120) row, the bf16 (256, 1536) one
    (granite-moe's chunk), jamba's bf16 rows by width and phase 27's (a
    2 x 1024 prefill of granite and of granite-moe) by width."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_rmsnorm import fused_rmsnorm, rmsnorm_ref
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows = {}
    shapes = ((8, 2560), (1024, 2560), (8, 5120), (1024, 5120), (8, 4096),
              (256, 4096), (8, 1536), (256, 1536), (1024, 8192),
              (1024, 16384), (2048, 4096), (2048, 1536))
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        for T, d in shapes:
            x = (torch.randn((T, d), generator=g, device=dev) * 3).to(dt)
            scale = (1 + 0.1 * torch.randn((d,), generator=g,
                                           device=dev)).to(dt)
            out = fused_rmsnorm(x, scale)
            ref = rmsnorm_ref(x, scale)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if name == "float32":
                ok = err <= 2e-5 * max(1.0, ref.float().abs().max().item())
            else:
                ok = bool((diff <= 2.0 ** -7 * ref.float().abs()).all())
            if not ok:
                fail(f"fused_rmsnorm {name} ({T}, {d}): max_abs_err {err}")

            def kern():
                return fused_rmsnorm(x, scale)

            def lib():
                return F.rms_norm(x, (d,), scale, 1e-5)
            mine, theirs = [], []
            ms = time_ms(kern, 50, readings=mine)
            plain = time_ms(lambda: rmsnorm_ref(x, scale), 20)
            lib_ms = time_ms(lib, 50, readings=theirs)
            b_ms, b_by = bound(nbytes(x, scale, out), 4.0 * T * d, name)
            print(f"[kernel] fused_rmsnorm {name} T={T} d={d}: max_err="
                  f"{err:.3g} kernel_ms={ms:.4f} ({b_ms / ms:.1%} of bound) "
                  f"plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"library_ms={lib_ms:.4f} eager_ms={eager_ms(kern, 50):.4f}"
                  f" library_eager_ms={eager_ms(lib, 50):.4f}", flush=True)
            if name == "bfloat16":
                rows[(T, d)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib_ms)
            if name == "bfloat16" and T == 1024 and d == 5120:
                y = torch.empty_like(x)
                verdict("fused_rmsnorm bf16 (1024, 5120)", ms, mine, lib_ms,
                        theirs, "F.rms_norm", b_ms,
                        copy_ms=time_ms(lambda: y.copy_(x), 50))
    return rows[(1024, 5120)], rows[(256, 1536)], {
        str(d): rows[(1024, d)] for d in (8192, 16384)}, {
        str(d): rows[(2048, d)] for d in (4096, 1536)}


SPLIT_NORM_SHAPES = {"mamba2": (2048, 2560), "jamba": (1024, 8192)}


def check_split_rmsnorm(torch, dev):
    """Row 7's split-row entries at phase 27's per-rank shapes of the gated
    norm (a row's d_inner over two ranks): mamba2's 2 x 1024-token prefill
    (2048, 2560) and jamba's 1024-token one (1024, 8192), bf16 and f32.
    Each rank's half of a (T, 2 d) row: ``rmsnorm_sumsq`` of each half
    against its plain twin (float32, 1e-5 relative to the sum), then
    ``rmsnorm_apply`` of each half from the two sums added, against its
    plain twin and, the halves side by side, against the whole-row
    kernel on the whole row (float32 2e-5; bf16 within one bfloat16
    rounding step of the plain output, element by element).  Times as the
    other rows (device times, inputs out of L2); no one PyTorch call
    computes either function.  Returns, by entry, the bf16 rows by
    shape."""
    from repro_torch.kernels.fused_rmsnorm import (fused_rmsnorm,
                                                   rmsnorm_apply,
                                                   rmsnorm_apply_ref,
                                                   rmsnorm_sumsq,
                                                   rmsnorm_sumsq_ref)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows = {"rmsnorm_sumsq": {}, "rmsnorm_apply": {}}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        for label, (T, d) in SPLIT_NORM_SHAPES.items():
            x = (torch.randn((T, 2 * d), generator=g, device=dev) * 3).to(dt)
            scale = (1 + 0.1 * torch.randn((2 * d,), generator=g,
                                           device=dev)).to(dt)
            halves = [x[:, :d].contiguous(), x[:, d:].contiguous()]
            scales = [scale[:d].contiguous(), scale[d:].contiguous()]
            sums = [rmsnorm_sumsq(h) for h in halves]
            plain_sums = [rmsnorm_sumsq_ref(h) for h in halves]
            err_s = max(((a - b).abs() / b.abs().clamp(min=1e-30)).max()
                        .item() for a, b in zip(sums, plain_sums))
            if not err_s <= 1e-5:
                fail(f"rmsnorm_sumsq {name} ({T}, {d}): relative error "
                     f"{err_s}")
            total = sums[0] + sums[1]
            outs = [rmsnorm_apply(h, total, sc, 2 * d)
                    for h, sc in zip(halves, scales)]
            plains = [rmsnorm_apply_ref(h, total, sc, 2 * d)
                      for h, sc in zip(halves, scales)]
            whole = fused_rmsnorm(x, scale)
            torch.cuda.synchronize()
            err_a = 0.0
            for got, want in ((torch.cat(outs, -1), torch.cat(plains, -1)),
                              (torch.cat(outs, -1), whole)):
                diff = (got.float() - want.float()).abs()
                err_a = max(err_a, diff.max().item())
                if name == "float32":
                    ok = diff.max().item() <= 2e-5 * max(
                        1.0, want.float().abs().max().item())
                else:
                    ok = bool((diff <= 2.0 ** -7 * want.float().abs()).all())
                if not ok:
                    fail(f"rmsnorm_apply {name} ({T}, {d}): max_abs_err "
                         f"{diff.max().item()}")
            h, sc, out = halves[0], scales[0], outs[0]
            cases = {
                "rmsnorm_sumsq": (lambda: rmsnorm_sumsq(h),
                                  lambda: rmsnorm_sumsq_ref(h),
                                  nbytes(h, sums[0]), 2.0 * T * d, err_s),
                "rmsnorm_apply": (lambda: rmsnorm_apply(h, total, sc, 2 * d),
                                  lambda: rmsnorm_apply_ref(h, total, sc,
                                                            2 * d),
                                  nbytes(h, total, sc, out), 3.0 * T * d,
                                  err_a)}
            for entry, (kern, plain_fn, nb, flops, err) in cases.items():
                ms = time_ms(kern, 50)
                plain = time_ms(plain_fn, 20)
                b_ms, b_by = bound(nb, flops, name)
                print(f"[kernel] {entry} {name} {label} T={T} d={d} of "
                      f"{2 * d}: max_err={err:.3g} kernel_ms={ms:.4f} "
                      f"({b_ms / ms:.1%} of bound) plain_ms={plain:.4f} "
                      f"bound_ms={b_ms:.4f} ({b_by}) library_ms=null",
                      flush=True)
                if name == "bfloat16":
                    rows[entry][label] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return rows


# phase 27 (j)'s gated norm: mamba2's 80 heads of 64 as 26, 27 and 27 on
# three ranks, a 1024-token prefill's rows (T, widths), in f32
UNEVEN_NORM = (1024, (1664, 1728, 1728))


def check_uneven_split_rmsnorm(torch, dev):
    """Row 7's split-row entries at phase 27 (j)'s per-rank widths, f32:
    each rank's columns of a (1024, 5120) row, 1664, 1728 and 1728 wide.
    ``rmsnorm_sumsq`` of each part against its plain twin (1e-5 relative
    to the sum), then ``rmsnorm_apply`` of each part from the three sums
    added, against its plain twin and, the parts side by side, against the
    whole-row kernel on the whole row (2e-5).  Times as the other rows.
    Returns, by entry, the rows by width."""
    from repro_torch.kernels.fused_rmsnorm import (fused_rmsnorm,
                                                   rmsnorm_apply,
                                                   rmsnorm_apply_ref,
                                                   rmsnorm_sumsq,
                                                   rmsnorm_sumsq_ref)
    T, widths = UNEVEN_NORM
    d_full = sum(widths)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.randn((T, d_full), generator=g, device=dev) * 3
    scale = 1 + 0.1 * torch.randn((d_full,), generator=g, device=dev)
    cuts = np.cumsum((0,) + widths).tolist()
    parts = [x[:, a:b].contiguous() for a, b in zip(cuts, cuts[1:])]
    scales = [scale[a:b].contiguous() for a, b in zip(cuts, cuts[1:])]
    sums = [rmsnorm_sumsq(h) for h in parts]
    plain_sums = [rmsnorm_sumsq_ref(h) for h in parts]
    err_s = max(((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()
                for a, b in zip(sums, plain_sums))
    if not err_s <= 1e-5:
        fail(f"rmsnorm_sumsq float32 widths {widths}: relative error "
             f"{err_s}")
    total = sums[0] + sums[1] + sums[2]
    outs = [rmsnorm_apply(h, total, sc, d_full)
            for h, sc in zip(parts, scales)]
    plains = [rmsnorm_apply_ref(h, total, sc, d_full)
              for h, sc in zip(parts, scales)]
    whole = fused_rmsnorm(x, scale)
    torch.cuda.synchronize()
    err_a = 0.0
    for got, want in ((torch.cat(outs, -1), torch.cat(plains, -1)),
                      (torch.cat(outs, -1), whole)):
        diff = (got - want).abs().max().item()
        err_a = max(err_a, diff)
        if not diff <= 2e-5 * max(1.0, want.abs().max().item()):
            fail(f"rmsnorm_apply float32 widths {widths}: max_abs_err "
                 f"{diff}")
    rows = {"rmsnorm_sumsq": {}, "rmsnorm_apply": {}}
    for w in sorted(set(widths)):
        i = widths.index(w)
        h, sc, out = parts[i], scales[i], outs[i]
        cases = {
            "rmsnorm_sumsq": (lambda: rmsnorm_sumsq(h),
                              lambda: rmsnorm_sumsq_ref(h),
                              nbytes(h, sums[i]), 2.0 * T * w, err_s),
            "rmsnorm_apply": (lambda: rmsnorm_apply(h, total, sc, d_full),
                              lambda: rmsnorm_apply_ref(h, total, sc,
                                                        d_full),
                              nbytes(h, total, sc, out), 3.0 * T * w,
                              err_a)}
        for entry, (kern, plain_fn, nb, flops, err) in cases.items():
            ms = time_ms(kern, 50)
            plain = time_ms(plain_fn, 20)
            b_ms, b_by = bound(nb, flops, "float32")
            print(f"[kernel] {entry} float32 mamba2 (j) T={T} d={w} of "
                  f"{d_full}: max_err={err:.3g} kernel_ms={ms:.4f} "
                  f"({b_ms / ms:.1%} of bound) plain_ms={plain:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) library_ms=null",
                  flush=True)
            rows[entry][str(w)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
    return rows


def ssd_flops(B, C, Q, H, P, N) -> float:
    """Operations the SSD chunk step needs: the lower-triangular C . B^T
    once per chunk (it is shared by the heads), and per head the decayed
    scores, their product with xbar and the chunk state."""
    tri = Q * (Q + 1) / 2
    return B * C * (2.0 * tri * N + H * (tri + 2.0 * tri * P
                                         + 2.0 * Q * P * N + 2.0 * Q))


def ssd_bodies(torch, fn):
    """(fn's result, the launches of each SSD body it made:
    ``ops.body_launches``' ``fma``, ``tf32x3_states``, ``tf32x3_y``)."""
    from repro_torch.kernels.ssd_scan import ops
    before = ops.body_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in ops.body_launches().items()}


SSD_CASES = ((4, 256, "0.1|randn|"), (4, 256, "softplus"),
             (1, 200, "0.1|randn|"))


def check_ssd_chunk(torch, dev, H=80, P=64, cases=SSD_CASES):
    """The SSD chunk kernel at one full-width mamba2-2.7b prefill layer of
    1024 tokens (B 1, C 4 chunks of Q 256, H 80, P 64, N 128, f32), with
    dA = -0.1 |randn| and at the model's decay range (dA = -softplus(randn),
    as A = -1 and dt = softplus(.) make it: cum reaches about -180 over a
    chunk, where exp(cum[q]) . exp(-cum[s]) would overflow), and at a
    prompt shorter than a chunk, whose single chunk of Q 200 is not a
    multiple of the kernel's tiles; or ``cases`` at other heads (jamba's
    prefill layer: H 128 heads of P 128, which the wrapper runs as 256
    heads of 64).  Every output finite and within
    1e-4 x sqrt(Q N / 1024) of the plain version; each call must take the
    body ``plan.body`` names (the tensor-core body for all of them, by the
    body counters).  The kernel's worst error from the float64 truth must
    be no larger than the plain version's.  The bound is
    :func:`f32_bound`'s (3xTF32).  The kernel is gated against its plain
    version (:func:`verdict`).  Returns the first case's row."""
    from repro_torch.kernels.ssd_scan import plan, ssd_chunk, ssd_chunk_ref
    B, N = 1, 128
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    main = None
    for C, Q, decay in cases:
        xbar = torch.randn((B, C, Q, H, P), generator=g, device=dev)
        dA = torch.randn((B, C, Q, H), generator=g, device=dev)
        dA = (-torch.nn.functional.softplus(dA) if decay == "softplus"
              else -dA.abs() * 0.1)
        Bc = torch.randn((B, C, Q, N), generator=g, device=dev)
        Cc = torch.randn((B, C, Q, N), generator=g, device=dev)
        outs, body = ssd_bodies(torch, lambda: ssd_chunk(xbar, dA, Bc, Cc))
        refs = ssd_chunk_ref(xbar, dA, Bc, Cc)
        torch.cuda.synchronize()
        label = f"ssd_chunk H={H} P={P} Q={Q} dA=-{decay}"
        want = plan.body(Q, P, N, [t.data_ptr() for t in (xbar, Bc, Cc,
                                                          *outs[:2])])
        took = {"fma": 1, "tf32x3_states": 0, "tf32x3_y": 0} if want == "fma" \
            else {"fma": 0, "tf32x3_states": 1, "tf32x3_y": 1}
        if want != "tf32x3" or body != took:
            fail(f"{label}: the plan names the {want} body, the counters "
                 f"read {body}")
        err = 0.0
        # 1e-4 at the Pallas tests' shapes (Q * N <= 1024), scaled by the
        # square root of the sums' lengths beyond them (float32 sums)
        tol = 1e-4 * (Q * N / 1024) ** 0.5
        # each path's error from the float64 truth (the plain version on
        # float64 inputs), relative to 1 + |truth|, its worst output
        truth = ssd_chunk_ref(*(t.double() for t in (xbar, dA, Bc, Cc)))

        def off(got):
            return max((((g.double() - t).abs() / (1 + t.abs())).max().item()
                        for g, t in zip(got, truth)))
        k_off, p_off = off(outs), off(refs)
        t_err = f"truth_err={k_off:.3g} (plain {p_off:.3g})"
        del truth
        if k_off > p_off:
            fail(f"{label}: {t_err}: the kernel is further from the float64 "
                 "truth than the plain version")
        for name, o, r in zip(("y_diag", "states", "chunk_decay"), outs,
                              refs):
            if not torch.isfinite(o).all():
                fail(f"{label}: non-finite {name}")
            if not torch.allclose(o, r, rtol=tol, atol=tol):
                fail(f"{label}: {name} differs from the plain version by "
                     f"{(o - r).abs().max().item()}")
            err = max(err, (o - r).abs().max().item())
        mine, theirs = [], []
        ms = time_ms(lambda: ssd_chunk(xbar, dA, Bc, Cc), readings=mine)
        plain = time_ms(lambda: ssd_chunk_ref(xbar, dA, Bc, Cc), 5,
                        readings=theirs)
        b_ms, b_by, basis = f32_bound(nbytes(xbar, dA, Bc, Cc, *outs),
                                      ssd_flops(B, C, Q, H, P, N))
        cum = torch.cumsum(dA, dim=2).min().item()
        print(f"[kernel] {label} f32 B={B} C={C} N={N}: "
              f"max_err={err:.3g} (tol {tol:.2g}) cum_min={cum:.1f} body "
              f"{want} (heads split {plan.head_split(P)}) kernel_ms={ms:.4f} ({b_ms / ms:.1%} of bound) "
              f"plain_ms={plain:.4f} bound_ms={b_ms:.4f} ({b_by}, {basis}) "
              f"library_ms=none {t_err}", flush=True)
        verdict(label, ms, mine, plain, theirs, "its plain version", b_ms)
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del xbar, dA, Bc, Cc, outs, refs
    return main


# ------------------------------------------------------- phases 4 to 6

def _request_logits(torch, model, params, prompt, impl, toks=None):
    """One request through the model's kernel path (``impl`` "kernel":
    paged-attention kernel, prefix flash kernel, RMSNorm kernel) or its
    plain path ("gather": page gather, masked chunk attention, plain
    RMSNorm) on its own pool: the prompt in two chunks (its first 64
    tokens, then the rest), then 4 decode steps fed ``toks[1:]`` (greedy
    from this path's logits when None).  Returns (the 6 logit rows
    float32, the tokens fed: the prompt's greedy next token, then each
    step's)."""
    from repro_torch.serving.kv_cache import KVBackendConfig, PagedKVBackend
    impl0 = model.chunk_attn_impl
    model.chunk_attn_impl = "flash" if impl == "kernel" else "masked"
    model.use_kernels = impl == "kernel"
    kv = PagedKVBackend(model, KVBackendConfig(
        max_slots=1, max_seq_len=2048, page_size=16, attn_impl=impl),
        num_pages=16)
    rows = [kv.prefill_chunk(params, 7, prompt[:64], 0),
            kv.prefill_chunk(params, 7, prompt[64:], 64)]
    fed = [int(rows[-1].argmax()) if toks is None else toks[0]]
    for i in range(4):
        kv.pool.extend(7, 1)
        pos = kv.pool.lengths[7] - 1
        pt = kv.pool.page_table[7]
        tables = torch.full((1, kv.max_pages_per_seq), kv.scratch_page,
                            dtype=torch.int32, device=model.device)
        tables[0, :len(pt)] = torch.tensor(pt, dtype=torch.int32)
        t = torch.tensor([[fed[-1]]], device=model.device)
        logits = model.paged_decode_step(
            params, {"k": kv.pool.k, "v": kv.pool.v}, t, tables,
            torch.tensor([pos], dtype=torch.int32, device=model.device),
            torch.tensor([pt[pos // 16]], device=model.device),
            torch.tensor([pos % 16], device=model.device),
            attn_impl=impl)
        rows.append(logits)
        fed.append(int(logits.argmax()) if toks is None else toks[i + 1])
    model.chunk_attn_impl = impl0
    model.use_kernels = True
    return torch.cat(rows).float(), fed


def reference_check(torch, model, params):
    """Kernel path vs plain path of the full-width model on one short
    request: prefill 100 tokens in two chunks, then 4 decode steps, each
    path on its own pool; the plain path takes no kernel (page gather,
    masked chunk attention, plain RMSNorm).  Every logit row finite,
    relative L2 error of the kernel path's logits < 0.05 (bf16 rounding
    through 40 layers), and the same greedy tokens fed to both."""
    rng = np.random.default_rng(SEED + 3)
    prompt = rng.integers(2, model.cfg.vocab_size, 100).tolist()
    outs = {}
    outs["kernel"], tok = _request_logits(torch, model, params, prompt,
                                          "kernel")
    outs["gather"], _ = _request_logits(torch, model, params, prompt,
                                        "gather", tok)
    outs["tok"] = tok
    a, b = outs["kernel"], outs["gather"]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("reference: non-finite logits")
    if tuple(a.shape) != (6, model.cfg.vocab_size):
        fail(f"reference: logits shape {tuple(a.shape)}")
    rel = ((a - b).norm() / b.norm()).item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"[reference] full-width kernel vs plain path, 6 logit rows: "
          f"rel_l2={rel:.4g} argmax_agree={agree:.2f}", flush=True)
    if not rel < 0.05:
        fail(f"reference: kernel-path logits differ (rel_l2 {rel})")
    return dict(prompt=prompt, tok=outs["tok"], kernel=a, rel=rel,
                agree=agree)


def reset_counts(kernels):
    for k in kernels.values():
        k.launches = 0


def read_counts(kernels):
    return {n: k.launches for n, k in kernels.items()}


def graph_gate(label: str, eng, counter, saw_warmup: bool) -> None:
    """One line on a warmed engine's step graphs, and the compile gate:
    the keys, captures, compile events and graph-pool size of its warmup,
    then the captures and library builds or loads ``counter`` saw after
    the warmup (``saw_warmup``: the counter was attached before the engine
    was built), which must be none, and, for a serve with graphs, its
    decode and pack replays, which must equal its decode steps and its
    packs since the warmup (the auto budget's warm batch's among them:
    the replay counters are not read between the two serves; with
    speculative decoding, its verify replays)."""
    w = eng.warm_stats
    if w is None:
        fail(f"{label}: the engine was not warmed")
    seen = counter.events[w["compiles"]:] if saw_warmup else counter.events
    g = eng.kv.graphs
    # a speculative engine's decode step is the verify step
    kind = "verify" if eng._spec_ok else "decode"
    replays = g.replays[kind] - w["replays"][kind]
    steps = len(eng.iter_times)
    pack_replays = g.replays["pack"] - w["replays"]["pack"]
    packs = sum(1 for *_, rows in eng.prefill_times if rows > 1)
    print(f"[graphs] {label}: warmup {w['seconds']:.2f}s, {w['keys']} step "
          f"keys, {w['captures']} CUDA graphs captured, {w['compiles']} "
          f"compile events, graph pool {w['pool_bytes'] / 2**20:.1f} MiB; "
          f"serving: {len(seen)} new "
          f"captures or library loads, {replays} {kind} replays for {steps} "
          f"decode steps, {g.replays['chunk'] - w['replays']['chunk']} "
          f"chunk replays, {pack_replays} pack replays for "
          f"{packs} packs", flush=True)
    if seen:
        fail(f"{label}: captured or loaded at serve time: {seen}")
    if g.capture and replays != steps:
        fail(f"{label}: {steps - replays} decode steps ran without a replay")
    if g.capture and pack_replays != packs:
        fail(f"{label}: {packs - pack_replays} packs ran "
             "without a replay")


def same_tokens(label: str, graphed, eager) -> None:
    """The graphed serve's greedy tokens against the eager serve's of the
    same requests, bit for bit."""
    a = [list(r.output_tokens) for r in graphed]
    b = [list(r.output_tokens) for r in eager]
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    same = not differ and len(a) == len(b)
    print(f"[graphs] {label}: graphed vs eager serve, {len(a)} requests, "
          f"{sum(map(len, a))} tokens: "
          + ("equal bit for bit" if same else f"requests {differ} differ"),
          flush=True)
    if not same:
        fail(f"{label}: graphed and eager greedy tokens differ")


# the serve phases' launcher arguments (phases 5, 16 and 9).  Swaps travel
# unquantized here, so the greedy tokens do not depend on when the wall
# clock's schedule preempts (phases 6 and 17 force the INT8 swaps; phase
# 21 compares its speculative serves' tokens with phases 5's and 16's).
# Phases 5, 16, 21 and 24 (c) serve these 8 requests, few enough for the
# script's time
PAGED_SERVE = dict(arch_size="full", strategy="alise", n_requests=8,
                   max_slots=8, seed=SEED, predictor_kind="oracle",
                   prefill_chunk=256, kv_backend="paged",
                   paged_attn_impl="kernel", chunk_attn="flash",
                   page_size=16, quantize=False, warmup=True)
DENSE_SERVE = dict(arch_size="full", strategy="alise", n_requests=8,
                   max_slots=8, seed=SEED, predictor_kind="oracle",
                   kv_backend="dense", quantize=False, warmup=True,
                   verbose=False)
MAMBA_SERVE = dict(arch="mamba2-2.7b", arch_size="full", strategy="alise",
                   n_requests=8, max_slots=8, seed=SEED,
                   predictor_kind="oracle", kv_backend="dense", warmup=True,
                   verbose=False)


SWAP_TRACE = ((200, 264, 120, 136, 150, 170), (48, 48, 6, 6, 6, 6))


def swap_requests(cfg):
    """Phase 6's trace (prompt and output lengths ``SWAP_TRACE``, tokens
    from seed ``SEED + 4``): two long requests, then four short ones."""
    from repro_torch.core.request import Request, reset_request_counter
    reset_request_counter()
    rng = np.random.default_rng(SEED + 4)
    return [Request(prompt_len=p, arrival_time=0.0, true_out_len=o,
                    prompt_tokens=rng.integers(2, cfg.vocab_size, p).tolist())
            for p, o in zip(*SWAP_TRACE)]


def virtual_serve(torch, eng, reqs, stage=0):
    """Serve ``reqs`` on a virtual clock (``t`` advances 0.1 s a step, so
    the schedule depends on nothing measured): all at t=0, or with
    ``stage`` the first ``stage`` five steps before the rest; then until
    the engine drains (at most 2000 more steps).  Returns the serve's
    wall seconds and each request's wall seconds to its first token."""
    t, first = 0.0, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def step():
        nonlocal t
        eng.step(t)
        t += 0.1
        now = time.perf_counter() - t0
        for r in reqs:
            if r.generated and r.req_id not in first:
                first[r.req_id] = now
    for r in reqs[:stage] if stage else reqs:
        eng.submit(r, t)
    if stage:
        for _ in range(5):
            step()
        for r in reqs[stage:]:
            eng.submit(r, t)
    for _ in range(2000):
        if not eng.sched.live:
            break
        step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, first


def serve_summary(eng, reqs, wall):
    """tokens/s, TTFT p50, decode steps p50 and prefills p50 of a serve
    (mamba's TTFT as phase 9 takes it: each prompt's prefill end, from the
    end of the warmup)."""
    gen = sum(r.generated for r in reqs)
    ttft = [r.first_token_time - r.arrival_time for r in reqs
            if r.finish_time is not None]
    if eng.model.cfg.family == "ssm":
        ttft = [t1 + dt - eng.warm_stats["end"]
                for t1, _, dt, _ in eng.prefill_times]
    step_ms = [dt * 1e3 for *_, dt in eng.iter_times]
    pre_ms = [dt * 1e3 for _, _, dt, _ in eng.prefill_times]
    return (f"{gen} tokens, {gen / wall:.1f} tok/s, wall {wall:.2f}s, TTFT "
            f"p50 {np.median(ttft):.3f}s, {len(step_ms)} decode steps p50 "
            f"{np.median(step_ms):.2f} ms, {len(pre_ms)} prefills p50 "
            f"{np.median(pre_ms):.2f} ms, preemptions "
            f"{sum(r.preempt_count for r in reqs)}")


def phase_serve(torch, model, params, kernels):
    from repro_torch.launch.serve import serve
    from repro_torch.utils.compile_counter import CompileCounter
    counter = CompileCounter()
    reqs, eng = serve(**PAGED_SERVE, device=model.device,
                      model_and_params=(model, params))
    torch.cuda.synchronize()
    wall = time.perf_counter() - eng.warm_stats["end"]
    counts = read_counts(kernels)
    graph_gate("granite paged serve (phase 5)", eng, counter, True)
    counter.detach()
    done = [r for r in reqs if r.finish_time is not None]
    gen = sum(r.generated for r in reqs)
    ttft = [r.first_token_time - r.arrival_time for r in done]
    step_ms = [dt * 1e3 for *_, dt in eng.iter_times]
    batch = [b for _, _, b, _ in eng.iter_times]
    chunk_ms = [dt * 1e3 for _, _, dt, _ in eng.prefill_times]
    print(f"[serve] granite-3-8b full (40L d4096 32/8H ff12800 V49155 bf16) "
          f"kernel/flash chunk=256 slots=8: {len(done)}/{len(reqs)} finished, "
          f"{gen} tokens generated, {gen / wall:.1f} tok/s, wall {wall:.2f}s, "
          f"TTFT p50 {np.median(ttft):.3f}s, preemptions "
          f"{sum(r.preempt_count for r in reqs)}, {len(step_ms)} decode steps "
          f"p50 {np.median(step_ms):.2f} ms (mean batch {np.mean(batch):.2f}), "
          f"{len(chunk_ms)} prefill chunks p50 {np.median(chunk_ms):.2f} ms, "
          f"launches {counts}", flush=True)
    if len(done) != len(reqs):
        fail("serve: not every request finished")
    for r in reqs:
        if len(r.output_tokens) != r.generated or r.generated < 1:
            fail(f"serve: request {r.req_id} produced no tokens")
        if not all(0 <= t < model.cfg.vocab_size for t in r.output_tokens):
            fail(f"serve: request {r.req_id} emitted an out-of-vocab token")
    for n in ("paged_attention", "flash_prefill_prefix"):
        if counts[n] <= 0:
            fail(f"serve: kernel {n} never launched on the serve path")
    return reqs


def phase_swap(torch, model, params, kernels):
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    from repro_torch.core.quantization import kv_bytes_per_token
    from repro_torch.utils.compile_counter import CompileCounter
    cfg = model.cfg
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    reqs = swap_requests(cfg)
    eng = ServingEngine(model, params, EngineConfig(
        max_slots=2, max_seq_len=2048, max_new_tokens=64, strategy="alise",
        quantize_offload=True, hbm_bytes=2 * 336 * bpt, kv_backend="paged",
        page_size=16, paged_attn_impl="kernel", prefill_chunk=256,
        warmup_compile=True), predictor=OraclePredictor())
    counter = CompileCounter()
    before = read_counts(kernels)
    walls = watch_offloads(torch, eng.kv)
    virtual_serve(torch, eng, reqs, stage=2)
    counts = {n: c - before[n] for n, c in read_counts(kernels).items()}
    graph_gate("granite paged swap (phase 6)", eng, counter, False)
    counter.detach()
    pre = sum(r.preempt_count for r in reqs)
    print(f"[swap] 2 lanes, KV budget {2 * 336} tokens, INT8 offload: "
          f"{sum(r.finish_time is not None for r in reqs)}/{len(reqs)} "
          f"finished, preemptions {pre}, {offload_summary(walls)}, "
          f"launches {counts}", flush=True)
    if eng.sched.live or any(r.finish_time is None for r in reqs):
        fail("swap: engine did not drain")
    if pre <= 0:
        fail("swap: no preemption was forced")
    for n in ("kv_quantize_store", "kv_dequantize"):
        if counts[n] <= 0:
            fail(f"swap: kernel {n} never launched")
    return counts


def _start_profiler(torch) -> None:
    """One profiled kernel: a process's first ``torch.profiler`` session
    starts CUPTI, which costs seconds once; later sessions do not."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        (x + 1).sum().item()


def _kernel_name(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][:40]


def _is_kernel(torch, e) -> bool:
    """A device event that is a kernel or copy (not a user annotation's
    span on the device timeline)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def profile_step(torch, label: str, step, n: int = 3, watch=()) -> None:
    """One line on where ``step``'s time goes: host wall ms per call
    without the profiler (``n`` calls, synchronized) and the device span
    of a call (CUDA events recorded before and after it on the stream,
    median; the device's idle gaps inside the call are in it), then the
    device's busy time per call (sum of kernel times) and its top kernels
    from ``torch.profiler`` over ``n`` more calls, and every kernel whose
    name holds one of ``watch`` (fails when such a kernel never ran).
    The profiler records the device's activity alone: every figure here
    is a device event's, and an eager step's host ops made the event list
    cost 5-8 s a profile.  The kernels are read from the profiler's raw
    events, not ``prof.events()``, whose tree of FunctionEvents cost 1.3-1.9
    s more a profile.  The line ends with the profile's cost (timed calls,
    profiler session, event list).  Returns the busy ms per call
    (None when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    t_begin = time.perf_counter()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    t0 = time.perf_counter()
    for begin, end in marks:
        begin.record()
        step()
        end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    span = statistics.median(b.elapsed_time(e) for b, e in marks)
    t_timed = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    t_profiled = time.perf_counter()
    by_kernel = {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == cuda and not e.is_user_annotation()
                and not getattr(e, "is_hidden_event", lambda: False)()):
            name = _kernel_name(e.name())
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.duration_ns() / 1e6 / n)
    busy = sum(by_kernel.values())
    cost = (f"; cost: timed {t_timed - t_begin:.1f}s, profiled "
            f"{t_profiled - t_timed:.1f}s, events "
            f"{time.perf_counter() - t_profiled:.1f}s")
    if busy <= 0:
        print(f"[profile] {label}: wall {wall:.2f} ms, device span "
              f"{span:.2f} ms; the profiler saw no device time (device busy "
              "not measured)", flush=True)
        return None
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
    seen = [(k, v) for k, v in sorted(by_kernel.items())
            if any(w in k for w in watch)]
    if watch and not seen:
        fail(f"{label}: no kernel named like {watch} ran")
    watched = sum(v for _, v in seen)
    print(f"[profile] {label}: wall {wall:.2f} ms, device span {span:.2f} ms, "
          f"device busy {busy:.2f} ms (idle {max(0.0, 1 - busy / wall):.1%})"
          f", {len(by_kernel)} kernel "
          "names; top: " + "; ".join(f"{k} {v:.2f} ms ({v / busy:.1%})"
                                     for k, v in top)
          + "".join(f"; watched: {k} {v:.2f} ms ({v / busy:.1%})"
                    for k, v in seen)
          + (f"; watched together {watched:.2f} ms ({watched / busy:.1%})"
             if len(seen) > 1 else "") + cost, flush=True)
    return busy


def phase_profile(torch, model, params):
    """Where the time goes in the two model steps of the serve path, on the
    kernels: a full-batch decode step (8 lanes at contexts spread over
    64..1600 tokens, the serve phase's range) and one 256-token prefill
    chunk starting at position 1024, whose flash route must run the bf16
    wgmma body (its time and share printed); then both as the engine's
    graph replays."""
    from repro_torch.serving.kv_cache import KVBackendConfig, PagedKVBackend
    B, pg = 8, 16
    kv = PagedKVBackend(model, KVBackendConfig(
        max_slots=B, max_seq_len=2048, page_size=pg), num_pages=B * 128)
    pool = {"k": kv.pool.k, "v": kv.pool.v}
    dev = model.device
    ctx = np.linspace(64, 1600, B).astype(int)
    tables = torch.full((B, kv.max_pages_per_seq), kv.scratch_page,
                        dtype=torch.int32)
    wp, wo = torch.zeros(B, dtype=torch.long), torch.zeros(B, dtype=torch.long)
    for i, c in enumerate(ctx):
        pages = kv.pool.allocate(i, int(c) + 1)
        tables[i, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
        wp[i], wo[i] = pages[c // pg], c % pg
    dec = [x.to(dev) for x in (torch.full((B, 1), 7), tables,
                               torch.tensor(ctx, dtype=torch.int32), wp, wo)]
    profile_step(torch, f"decode step (kernel, B={B}, ctx 64..1600)",
                 lambda: model.paged_decode_step(params, pool, *dec,
                                                 attn_impl="kernel"),
                 watch=("paged_attention",))
    start, C = 1024, 256
    pos = start + torch.arange(C)
    pages = torch.tensor(kv.pool.page_table[B - 1], dtype=torch.long)
    pre = [torch.full((1, C), 7, device=dev), tables[B - 1:].to(dev),
           pages[pos // pg].to(dev), (pos % pg).to(dev)]
    profile_step(torch, f"prefill chunk (flash, C={C}, start={start})",
                 lambda: model.paged_prefill_chunk(params, pool, *pre, start,
                                                   C),
                 watch=("flash_attn_wgmma",))
    del kv, pool, dec, pre
    torch.cuda.empty_cache()
    profile_step(torch, f"engine decode step (graphed, B={B}, ctx 64..1600)",
                 engine_decode(model, params, "paged", True, ctx), n=3)
    # a chunk of 256 at position 1024 of a request whose pages exist
    kv = PagedKVBackend(model, KVBackendConfig(
        max_slots=1, max_seq_len=2048, page_size=pg, graph_buckets=(C,)),
        num_pages=130)
    kv.pool.allocate(0, start)
    profile_step(torch, f"engine prefill chunk (graphed, C={C}, "
                 f"start={start})",
                 lambda: kv.prefill_chunk(params, 0, [7] * C, start), n=3)
    del kv
    torch.cuda.empty_cache()


def engine_decode(model, params, backend, cuda_graphs, ctx,
                  max_seq_len=2048):
    """A step for profiling a KV backend's fused decode step as the
    engine calls it (host inputs staged, tokens and reasons back on the
    host), with or without CUDA graphs: every lane active, lane i at
    context ``ctx[i]`` (paged: pages allocated; a step grows each lane by
    one token; dense granite: each call starts from ``ctx`` again),
    greedy.  The first call captures the graph.  The step's ``kv``
    attribute is its backend."""
    import torch
    from repro_torch.serving.kv_cache import (DenseKVBackend,
                                              KVBackendConfig, PagedKVBackend)
    B = len(ctx)
    bcfg = KVBackendConfig(max_slots=B, max_seq_len=max_seq_len,
                           page_size=16, attn_impl="kernel",
                           cuda_graphs=cuda_graphs)
    if backend == "paged":
        kv = PagedKVBackend(model, bcfg, num_pages=B * 128)
        for i, c in enumerate(ctx):
            kv.pool.allocate(i, int(c))
            kv.slot_req[i] = i
    else:
        kv = DenseKVBackend(model, bcfg)
    ctx = np.asarray(ctx, np.int32)
    args = (np.full((B, 1), 7, np.int32), np.ones((B,), bool),
            np.ones((B,), np.int32), ctx + 1,
            np.full((B,), np.iinfo(np.int32).max, np.int32),
            np.arange(B, dtype=np.int32))

    lens = torch.from_numpy(ctx).to(model.device)
    reset = backend == "dense" and model.cfg.family != "ssm"

    def step():
        if reset:
            kv.cache["lengths"].copy_(lens)
        return kv.decode(params, *args)
    step.kv = kv
    return step


# ---------------------------------------------------- phases 15 to 18

def dense_reference_check(torch, model, params, ref):
    """Granite on the dense backend against phase 4's paged kernel path on
    the same request, by two prefill routes into a 2048-position stripe:
    the engine's (the prompt as one chunk of ``Model.prefill_chunk``,
    padded to its pow2 bucket: the prefix flash and RMSNorm kernels) and
    the reference API's monolithic ``Model.prefill`` (padded to 128 with
    ``last_index``: the full-sequence flash kernel).  Each is followed by 4
    dense decode steps (plain decode attention) fed phase 4's greedy
    tokens and held against phase 4's kernel-path logits: relative L2 <=
    0.05 in bf16, printed beside phase 4's kernel-vs-plain figure."""
    dev = model.device
    prompt, toks = ref["prompt"], ref["tok"]
    S = len(prompt)
    # phase 4's rows: 2 chunk rows (the prompt's last is row 1), 4 decodes
    b = torch.cat([ref["kernel"][1:2], ref["kernel"][2:6]])
    for route in ("prefill_chunk", "prefill"):
        cache = model.init_cache(1, 2048)
        if route == "prefill_chunk":
            Cb = max(8, 1 << (S - 1).bit_length())
            logits = model.prefill_chunk(
                params, cache["k"][:, 0], cache["v"][:, 0],
                torch.tensor([prompt + [0] * (Cb - S)], device=dev), 0, S)
        else:
            logits, pcache = model.prefill(params, {
                "tokens": torch.tensor([prompt + [0] * (128 - S)],
                                       device=dev),
                "last_index": torch.tensor([S - 1], dtype=torch.int32,
                                           device=dev)})
            for key in ("k", "v"):
                cache[key][:, :, :S] = pcache[key][:, :, :S]
            del pcache
        cache["lengths"][:] = S
        rows = [logits]
        for i in range(4):
            t = torch.tensor([[toks[i]]], device=dev)
            rows.append(model.decode_step(params, cache, t))
        del cache
        a = torch.cat(rows).float()
        if not torch.isfinite(a).all() or tuple(a.shape) != (
                5, model.cfg.vocab_size):
            fail(f"dense reference ({route}): logits {tuple(a.shape)}, "
                 f"finite {bool(torch.isfinite(a).all())}")
        rel = ((a - b).norm() / b.norm()).item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        print(f"[dense-reference] {route} + 4 dense decode steps vs the "
              f"paged kernel path, 5 logit rows: rel_l2={rel:.4g} "
              f"argmax_agree={agree:.2f} (paged kernel vs plain, phase 4: "
              f"rel_l2={ref['rel']:.4g} argmax_agree={ref['agree']:.2f})",
              flush=True)
        if not rel <= 0.05:
            fail(f"dense reference ({route}): dense-path logits differ "
                 f"(rel_l2 {rel})")


def phase_dense_serve(torch, model, params, kernels):
    """Phase 5's 8 requests through ``ServingEngine.serve`` on the dense
    backend with the reference engine's defaults: no chunk size (each
    prompt one chunk over its lane's stripe, through the prefix flash
    kernel), fused decode, ``max_seq_len`` 2048, 8 lanes."""
    from repro_torch.launch.serve import serve
    from repro_torch.utils.compile_counter import CompileCounter
    before = read_counts(kernels)
    counter = CompileCounter()
    reqs, eng = serve(**DENSE_SERVE, device=model.device,
                      model_and_params=(model, params))
    torch.cuda.synchronize()
    wall = time.perf_counter() - eng.warm_stats["end"]
    counts = {n: c - before[n] for n, c in read_counts(kernels).items()}
    graph_gate("granite dense serve (phase 16)", eng, counter, True)
    counter.detach()
    done = [r for r in reqs if r.finish_time is not None]
    gen = sum(r.generated for r in reqs)
    ttft = [r.first_token_time - r.arrival_time for r in done]
    step_ms = [dt * 1e3 for *_, dt in eng.iter_times]
    batch = [b for _, _, b, _ in eng.iter_times]
    pre_ms = [dt * 1e3 for _, _, dt, _ in eng.prefill_times]
    print(f"[dense-serve] granite-3-8b full, dense KV (Smax 2048), "
          f"whole-prompt chunks, fused decode, slots=8: {len(done)}/"
          f"{len(reqs)} finished, {gen} tokens generated, {gen / wall:.1f} "
          f"tok/s, wall {wall:.2f}s, TTFT p50 {np.median(ttft):.3f}s, "
          f"preemptions {sum(r.preempt_count for r in reqs)}, "
          f"{len(step_ms)} decode steps p50 {np.median(step_ms):.2f} ms "
          f"(p10 {np.percentile(step_ms, 10):.2f}, p90 "
          f"{np.percentile(step_ms, 90):.2f}; mean batch {np.mean(batch):.2f})"
          f", {len(pre_ms)} prefills p50 {np.median(pre_ms):.2f} ms, "
          f"launches {counts}", flush=True)
    if len(done) != len(reqs):
        fail("dense serve: not every request finished")
    for r in reqs:
        if len(r.output_tokens) != r.generated or r.generated < 1:
            fail(f"dense serve: request {r.req_id} produced no tokens")
        if not all(0 <= t < model.cfg.vocab_size for t in r.output_tokens):
            fail(f"dense serve: request {r.req_id} emitted an out-of-vocab "
                 "token")
    for n in ("flash_prefill_prefix", "fused_rmsnorm"):
        if counts[n] <= 0:
            fail(f"dense serve: kernel {n} never launched")
    return reqs


def phase_dense_swap(torch, model, params, kernels):
    """Phase 6's setup on the dense backend (2 lanes, a KV budget of 672
    tokens, staged arrivals on a virtual clock) with chunks of 256: there
    must be preemptions whose K/V stripes cross to the host as INT8
    through the kv_quant kernels, and every request must finish.  Then one
    lane's offload and upload are timed alone."""
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    from repro_torch.core.quantization import kv_bytes_per_token
    from repro_torch.utils.compile_counter import CompileCounter
    cfg = model.cfg
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    reqs = swap_requests(cfg)
    eng = ServingEngine(model, params, EngineConfig(
        max_slots=2, max_seq_len=2048, max_new_tokens=64, strategy="alise",
        quantize_offload=True, hbm_bytes=2 * 336 * bpt, kv_backend="dense",
        prefill_chunk=256, warmup_compile=True), predictor=OraclePredictor())
    counter = CompileCounter()
    before = read_counts(kernels)
    walls = watch_offloads(torch, eng.kv)
    virtual_serve(torch, eng, reqs, stage=2)
    counts = {n: c - before[n] for n, c in read_counts(kernels).items()}
    graph_gate("granite dense swap (phase 17)", eng, counter, False)
    counter.detach()
    pre = sum(r.preempt_count for r in reqs)
    if eng.sched.live or any(r.finish_time is None for r in reqs):
        fail("dense swap: engine did not drain")
    # one lane of 264 tokens (a 512-position span) round trip, timed alone
    eng.kv.prefill_chunk(params, -1, reqs[1].prompt_tokens, 0)
    walls = walls[:]        # the serve's; the lane below is timed alone
    blob, out_ms, added = measured_offload(torch, lambda: eng.kv.offload(-1))
    t2 = time.perf_counter()
    eng.kv.upload(-1, blob)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    eng.kv.clear(-1)
    swap_bytes = sum(sum(nbytes(x) for x in blob[k][1][:3])
                     for k in ("k", "v"))
    print(f"[dense-swap] 2 lanes, KV budget {2 * 336} tokens, chunks of 256, "
          f"INT8 stripe offload: {sum(r.finish_time is not None for r in reqs)}"
          f"/{len(reqs)} finished, preemptions {pre}; a 264-token lane "
          f"(span {blob['k'][1][3][1]}) crosses as {swap_bytes / 1e6:.2f} MB "
          f"(codes + scales + zeros), offload {out_ms:.1f} ms (device "
          f"memory added {added / 1e6:.1f} MB) / upload "
          f"{1e3 * (t3 - t2):.1f} ms; the serve's "
          f"{offload_summary(walls)}; launches {counts}", flush=True)
    if pre <= 0:
        fail("dense swap: no preemption was forced")
    for n in ("kv_quantize_store", "kv_dequantize"):
        if counts[n] <= 0:
            fail(f"dense swap: kernel {n} never launched")


def phase_bench_rows(torch, model, params, kernels):
    """The reference kernel bench's rows (``benchmarks/bench_kernels.py:
    67-121``) on the card: INT8 paged attention at the bench's shape (row
    5's path: its launches are counted here, from 0), then one full-batch
    dense decode step of the full-width, full-depth model (B 8, Smax 2048,
    every lane at position 1024) fused and sampled on the device, against
    ``decode_step`` plus a host argmax per lane (8 host syncs).  Returns
    the launch counts."""
    from repro_torch.kernels.kv_quant import kv_quantize, paged_attention_q8
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    B, H, KVH, d, page, npg, maxp = 8, 8, 8, 128, 64, 512, 64
    q = torch.randn((B, H, d), generator=g, device=dev)
    pools = [_q8_pool(torch, kv_quantize,
                      torch.randn((npg, page, KVH, d), generator=g,
                                  device=dev)) for _ in range(2)]
    tables = torch.randint(0, npg, (B, maxp), generator=g, device=dev,
                           dtype=torch.int32)
    check_table("paged_attention_q8 bench (phase 18)", tables, npg,
                (B, maxp))
    lengths = torch.full((B,), maxp * page, dtype=torch.int32, device=dev)
    args = (q, *pools[0], *pools[1], tables, lengths)
    reset_counts(kernels)
    q8_ms = time_ms(lambda: paged_attention_q8(*args))
    counts = read_counts(kernels)
    del pools, args
    Smax = 2048
    cache = model.init_cache(B, Smax)
    toks = torch.ones((B, 1), dtype=torch.long, device=dev)
    ones = torch.ones((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    rids = torch.arange(B, dtype=torch.int32, device=dev)

    def fused():
        cache["lengths"].fill_(Smax // 2)
        tok, reason = model.decode_step_sampled(
            params, cache, toks, active, ones, ones, ones * Smax, rids,
            max_seq_len=Smax)
        return torch.stack([tok, reason]).cpu()

    def per_slot():
        cache["lengths"].fill_(Smax // 2)
        logits = model.decode_step(params, cache, toks)
        return [int(logits[i].argmax()) for i in range(B)]

    res = {}
    for name, fn in (("per_slot", per_slot), ("fused", fused),
                     ("per_slot", per_slot), ("fused", fused)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        res.setdefault(name, []).append((time.perf_counter() - t0) * 200)
    slot_ms, fused_ms = min(res["per_slot"]), min(res["fused"])
    print(f"[bench] paged_attention_q8 B={B} ctx {maxp * page} (bench "
          f"shape): {q8_ms:.4f} ms, launches {counts['paged_attention_q8']}; "
          f"dense decode step B={B} Smax={Smax} at position {Smax // 2}: "
          f"per-slot host argmax {slot_ms:.2f} ms ({B} host syncs), fused "
          f"and sampled {fused_ms:.2f} ms (1 sync), {slot_ms / fused_ms:.2f}x "
          f"(runs of 5, best of 2, in turns)", flush=True)
    profile_step(torch, f"dense decode step (fused, B={B}, Smax={Smax})",
                 fused, n=3)
    del cache
    torch.cuda.empty_cache()
    for graphs in (True, False):
        how = "graphed" if graphs else "eager"
        profile_step(torch, f"dense engine decode step ({how}, B={B}, "
                     f"Smax={Smax}, at position {Smax // 2})",
                     engine_decode(model, params, "dense", graphs,
                                   [Smax // 2] * B), n=3)
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------- phases 19 and 20

# phase 19's pack rows: (start, chunk length) at bucket 256; the last row
# is pack padding (chunk length 0)
PACK_ROWS = ((0, 256), (256, 200), (512, 17), (1000, 0))
PACK_BUCKET = 256
BF16_TOL = 5e-2                         # ROADMAP rule 2's bf16 tolerance


def _held(torch, label: str, got, want) -> str:
    """``got`` against ``want`` within the bf16 tolerance: relative L2 at
    most 5e-2 and every value finite.  Returns the worst absolute error
    and the relative L2 as text."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite values")
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    err = (got - want).abs().max().item()
    if not rel <= BF16_TOL:
        fail(f"{label}: rel_l2 {rel:.4g} > {BF16_TOL} (max_abs_err "
             f"{err:.4g})")
    return f"max_abs_err={err:.4g} rel_l2={rel:.4g}"


def _pack_prompts(model, rng, rids):
    """One prompt per pack member, long enough for its row."""
    V = model.cfg.vocab_size
    return {rid: rng.integers(2, V, s + n).tolist()
            for rid, (s, n) in zip(rids, PACK_ROWS[:3])}


def _pack_items(params, kv, prompts):
    """Prefill each member's earlier chunks (chunks of 256 up to its row's
    start) through ``kv.prefill_chunk``; returns the pack's items
    ``(rid, chunk tokens, start)``."""
    items = []
    for rid, (start, n) in zip(prompts, PACK_ROWS[:3]):
        p = prompts[rid]
        for s in range(0, start, PACK_BUCKET):
            kv.prefill_chunk(params, rid, p[s:s + PACK_BUCKET], s)
        items.append((rid, p[start:start + n], start))
    return items


def _graphed_pack(torch, label, kv, params, items, tensors, state):
    """The pack's step graph (captured here, on the backend's neutral
    input) replayed on ``items`` against the eager pack step on the same
    staged input and the same starting state (``tensors()``: the pool's
    or the cache's K and V): equal bit for bit, the members' logits and
    ``state()`` (the paged pool without its scratch page, or the dense
    cache)."""
    staged = kv._pack_inputs(items, PACK_BUCKET)
    snap = [t.clone() for t in tensors()]
    step = (lambda buf: kv._pack_step(params, buf, PACK_BUCKET))
    graphed = kv._run_chunk(("pack", PACK_BUCKET), staged, step,
                            lambda: kv._pack_inputs([], PACK_BUCKET))
    after = [t.clone() for t in state()]
    for t, s in zip(tensors(), snap):
        t.copy_(s)
    eager = step(torch.from_numpy(staged).to(kv.device))
    torch.cuda.synchronize()
    # the padding rows' logits are garbage (on the paged backend they read
    # the scratch page, whose duplicate writes keep no order): members only
    m = len(items)
    same = torch.equal(graphed[:m], eager[:m]) and all(
        torch.equal(a, b) for a, b in zip(after, state()))
    print(f"[pack] {label}: graphed pack (replay of ('pack', "
          f"{PACK_BUCKET}), {kv.graphs.replays['pack']} replay) vs eager "
          f"pack on the same input: "
          + ("equal bit for bit" if same else "DIFFER"), flush=True)
    if not same:
        fail(f"{label}: the graphed pack differs from the eager pack")
    for rid, _, _ in items:
        kv.clear(rid)


def _flash_bodies():
    from repro_torch.kernels.flash_prefill import ops
    return ops.body_launches()


def _pack_parity(torch, label, model, kernels, tensors, run_pack,
                 run_single, written):
    """One pack of PACK_ROWS through ``run_pack`` (its launches counted
    from 0: the prefix flash kernel must launch once per layer, at B = 4,
    through the wgmma body) against its three members run one by one
    through ``run_single`` on the state ``tensors()`` held before the
    pack: logits and the written K/V (``written()``) held within the bf16
    tolerance.  Returns the pack's launch counts."""
    snap = [t.clone() for t in tensors()]
    reset_counts(kernels)
    bodies = _flash_bodies()
    logits = run_pack()
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    bodies = {k: n - bodies[k] for k, n in _flash_bodies().items()}
    packed = written()
    for t, s in zip(tensors(), snap):
        t.copy_(s)
    single = torch.cat([run_single(i) for i in range(3)])
    torch.cuda.synchronize()
    L = model.cfg.num_layers
    held_logits = _held(torch, label + " logits", logits[:3], single)
    held_kv = _held(torch, label + " K/V", packed, written())
    print(f"[pack] {label}: pack of 4 rows at bucket {PACK_BUCKET} (starts "
          f"{[s for s, _ in PACK_ROWS]}, chunk lengths "
          f"{[n for _, n in PACK_ROWS]}) vs its 3 members one by one: "
          f"logits {held_logits}; written K/V {held_kv}; "
          f"flash_prefill_prefix launches {counts['flash_prefill_prefix']} "
          f"at B=4 (bodies {bodies})", flush=True)
    if counts["flash_prefill_prefix"] != L:
        fail(f"{label}: flash_prefill_prefix launched "
             f"{counts['flash_prefill_prefix']} times, want {L} at B = 4")
    if bodies["wgmma"] != L or bodies["fma"]:
        fail(f"{label}: the pack's flash calls did not all take the wgmma "
             "body")
    return counts


def _pack_wall(torch, model, params, kv) -> None:
    """The wall of a graphed pack of 4 fresh chunks at buckets 64 and 128
    against the same 4 chunks as 4 graphed single-chunk calls (each key
    captured first; medians of 3, in turns single, pack, pack, single,
    single, pack), printed."""
    rng = np.random.default_rng(SEED + 192)
    V = model.cfg.vocab_size
    for b in (64, 128):
        toks = {rid: rng.integers(2, V, b).tolist() for rid in range(20, 24)}
        items = [(rid, t, 0) for rid, t in toks.items()]

        def single():
            for rid, t in toks.items():
                kv.prefill_chunk(params, rid, t, 0)

        def packed():
            kv.prefill_pack(params, items, b)

        got = {}
        order = (single, packed,                 # first uses: captures
                 single, packed, packed, single, single, packed)
        for i, fn in enumerate(order):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= 2:
                got.setdefault(fn.__name__, []).append(
                    (time.perf_counter() - t0) * 1e3)
            for rid in toks:
                kv.clear(rid)
        one, four = (statistics.median(got[k]) for k in ("single",
                                                         "packed"))
        print(f"[pack] paged wall at bucket {b}: 4 single chunks "
              f"{one:.2f} ms, one pack of the 4 {four:.2f} ms "
              f"({four / one:.2f}x; graphed, median of 3)", flush=True)


def _paged_pack_phase(torch, model, params, kernels):
    from repro_torch.serving.kv_cache import KVBackendConfig, PagedKVBackend
    kv = PagedKVBackend(model, KVBackendConfig(
        max_slots=8, max_seq_len=2048, page_size=16, attn_impl="kernel",
        graph_buckets=(64, 128, PACK_BUCKET)), num_pages=200)
    rng = np.random.default_rng(SEED + 19)
    scratch = kv.scratch_page
    live = [p for p in range(kv.pool.k.shape[1]) if p != scratch]

    def tensors():
        return [kv.pool.k, kv.pool.v]

    def state():
        return [kv.pool.k[:, live], kv.pool.v[:, live]]

    _graphed_pack(torch, "paged", kv, params,
                  _pack_items(params, kv, _pack_prompts(model, rng,
                                                        (10, 11, 12))),
                  tensors, state)
    items = _pack_items(params, kv, _pack_prompts(model, rng, (1, 2, 3)))
    kv._pack_inputs(items, PACK_BUCKET)       # claim lanes, grow pages
    rows = [kv._chunk_fields(kv.pool.page_table[rid], t, s, PACK_BUCKET)
            for rid, t, s in items]
    rows.append(kv._chunk_fields([], [], PACK_ROWS[3][0], PACK_BUCKET))
    dev = model.device
    tables, toks, wp, wo, start, n = (
        torch.as_tensor(np.stack([np.asarray(r[f], np.int32) for r in rows]),
                        device=dev) for f in range(6))
    pages = sorted({int(p) for i, (_, c) in enumerate(PACK_ROWS[:3])
                    for p in wp[i, :c].tolist()})
    idx = torch.tensor(pages, device=dev)

    def written():
        return torch.cat([t[:, idx].flatten() for t in tensors()])

    counts = _pack_parity(
        torch, "paged", model, kernels, tensors,
        lambda: model.paged_prefill_pack(params, kv._kv(), toks, tables, wp,
                                         wo, start, n),
        lambda i: model.paged_prefill_chunk(
            params, kv._kv(), toks[i:i + 1], tables[i:i + 1], wp[i], wo[i],
            start[i:i + 1], n[i:i + 1]),
        written)
    for rid, _, _ in items:
        kv.clear(rid)
    _pack_wall(torch, model, params, kv)
    return counts


def _dense_pack_phase(torch, model, params, kernels):
    from repro_torch.serving.kv_cache import DenseKVBackend, KVBackendConfig
    kv = DenseKVBackend(model, KVBackendConfig(
        max_slots=4, max_seq_len=2048, graph_buckets=(PACK_BUCKET,)))
    rng = np.random.default_rng(SEED + 19)

    def tensors():
        return [kv.cache["k"], kv.cache["v"]]

    _graphed_pack(torch, "dense", kv, params,
                  _pack_items(params, kv, _pack_prompts(model, rng,
                                                        (10, 11, 12))),
                  tensors, tensors)
    items = _pack_items(params, kv, _pack_prompts(model, rng, (1, 2, 3)))
    kv._pack_inputs(items, PACK_BUCKET)       # claim lanes
    dev = model.device
    lanes = [kv.slot_of(rid) for rid, _, _ in items]
    toks = torch.zeros((4, PACK_BUCKET), dtype=torch.int32, device=dev)
    for i, (_, t, _) in enumerate(items):
        toks[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
    as_t = (lambda a: torch.tensor(a, dtype=torch.int32, device=dev))
    lane_t = as_t(lanes + [lanes[0]])       # padding reads row 0's lane
    start = as_t([s for s, _ in PACK_ROWS])
    n = as_t([c for _, c in PACK_ROWS])

    def written():
        return torch.cat([t[:, lane, s:s + PACK_BUCKET].flatten()
                          for lane, (s, _) in zip(lanes, PACK_ROWS)
                          for t in tensors()])

    counts = _pack_parity(
        torch, "dense", model, kernels, tensors,
        lambda: model.prefill_pack(params, kv.cache["k"], kv.cache["v"],
                                   lane_t, toks, start, n),
        lambda i: model.prefill_chunk(
            params, kv.cache["k"][:, lanes[i]], kv.cache["v"][:, lanes[i]],
            toks[i:i + 1], start[i:i + 1], n[i:i + 1]),
        written)
    del kv
    return counts


def _prefix_hit(torch, label, kv, params, model, shared: int, tail: int,
                rng, rid0: int):
    """Request A prefills its prompt (1024 tokens: the ``shared`` span
    and its own rest) in chunks of 256 and publishes it; request B shares
    the span and has ``tail`` tokens of its own.  B must acquire a hit of
    exactly ``shared`` and prefill only its tail, in one chunk; its last
    logits are held against B prefilled cold on a fresh lane.  Returns
    (A's rid, B's rid, the cold rid, the hit, A's pages)."""
    V = model.cfg.vocab_size
    span = rng.integers(2, V, shared).tolist()
    a = span + rng.integers(2, V, 1024 - shared).tolist()
    b = span + rng.integers(2, V, tail).tolist()
    ra, rb, rc = rid0, rid0 + 1, rid0 + 2
    for s in range(0, len(a), 256):
        kv.prefill_chunk(params, ra, a[s:s + 256], s)
    published = kv.prefix_publish(ra, a, len(a))
    hit = kv.prefix_acquire(rb, b)
    got = kv.prefill_chunk(params, rb, b[hit:], hit)
    for s in range(0, len(b), 256):
        cold = kv.prefill_chunk(params, rc, b[s:s + 256], s)
    torch.cuda.synchronize()
    print(f"[prefix] {label}: A published {published} pages; B acquired a "
          f"hit of {hit} tokens (shared {shared}) and prefilled its "
          f"{len(b) - hit} uncached tokens in one chunk; last logits vs B "
          f"cold: {_held(torch, label, got, cold)}", flush=True)
    if hit != shared:
        fail(f"{label}: B's hit is {hit} tokens, want {shared}")
    return ra, rb, rc


def phase_pack_prefix(torch, model, params, kernels):
    """Phase 19: pack and prefix-cache parity at the model and backend
    level (deterministic; see the module docstring).  Returns the packs'
    launch counts (paged and dense summed)."""
    from repro_torch.serving.kv_cache import (DenseKVBackend,
                                              KVBackendConfig, PagedKVBackend)
    counts = _paged_pack_phase(torch, model, params, kernels)
    torch.cuda.empty_cache()
    dense = _dense_pack_phase(torch, model, params, kernels)
    counts = {k: counts[k] + dense[k] for k in counts}
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 191)
    kv = PagedKVBackend(model, KVBackendConfig(
        max_slots=4, max_seq_len=2048, page_size=16, attn_impl="kernel",
        prefix_cache=True), num_pages=300)
    rids = _prefix_hit(torch, "paged prefix hit (a 1024-token span, 64 "
                       "pages)", kv, params, model, 1024, 200, rng, 1)
    for rid in rids:
        kv.clear(rid)
    ra, rb, rc = 4, 5, 6
    # a 1000-token span: the hit ends inside A's page 62, which B gets as
    # a copy; B's tail writes that copy and must leave A's page unchanged
    V = model.cfg.vocab_size
    span = rng.integers(2, V, 1000).tolist()
    a = span + rng.integers(2, V, 24).tolist()
    b = span + rng.integers(2, V, 200).tolist()
    for s in range(0, len(a), 256):
        kv.prefill_chunk(params, ra, a[s:s + 256], s)
    kv.prefix_publish(ra, a, len(a))
    a_page = kv.pool.page_table[ra][1000 // 16]
    before = (kv.pool.k[:, a_page].clone(), kv.pool.v[:, a_page].clone())
    cows = kv.prefix_stats().cow_pages
    hit = kv.prefix_acquire(rb, b)
    got = kv.prefill_chunk(params, rb, b[hit:], hit)
    for s in range(0, len(b), 256):
        cold = kv.prefill_chunk(params, rc, b[s:s + 256], s)
    torch.cuda.synchronize()
    kept = (torch.equal(before[0], kv.pool.k[:, a_page])
            and torch.equal(before[1], kv.pool.v[:, a_page]))
    print(f"[prefix] paged shared tail page (a 1000-token span): hit "
          f"{hit}, {kv.prefix_stats().cow_pages - cows} copy-on-write page, "
          f"A's page {a_page} after B's tail "
          + ("unchanged bit for bit" if kept else "CHANGED")
          + f"; last logits vs B cold: "
          f"{_held(torch, 'paged shared tail page', got, cold)}",
          flush=True)
    if hit != 1000 or kv.prefix_stats().cow_pages != cows + 1 or not kept:
        fail("paged shared tail page: the hit, its copy-on-write page or "
             "A's page is wrong")
    for rid in (ra, rb, rc):
        kv.clear(rid)
    freed = kv.prefix_reclaim(10 ** 6)
    pool = kv.pool
    clean = (not pool.page_table and list(pool.refs) == [kv.scratch_page]
             and sorted(pool.free_pages + [kv.scratch_page])
             == list(range(pool.cfg.num_pages)))
    print(f"[prefix] paged leaks: after releasing A and B and reclaiming "
          f"{freed} cached pages, refcounts "
          + ("all 0 and the free list whole" if clean
             else f"{pool.refs}, {len(pool.free_pages)} free"), flush=True)
    if not clean:
        fail("paged prefix cache: pages or refcounts leaked")
    del kv, pool
    torch.cuda.empty_cache()
    kv = DenseKVBackend(model, KVBackendConfig(
        max_slots=4, max_seq_len=2048, page_size=16, prefix_cache=True))
    _prefix_hit(torch, "dense prefix hit through DensePrefixCache.fetch",
                kv, params, model, 1024, 200, rng, 1)
    del kv
    torch.cuda.empty_cache()
    return counts


def phase20_requests(cfg):
    """Phase 20's traffic, all at t = 0: 3 families of 4 requests that
    share a 1024-token system prompt, each with its own tail of 16-256
    tokens, and 4 distinct prompts of 32-200 tokens; outputs of 16-64
    tokens; in a seeded shuffled order."""
    from repro_torch.core.request import Request, reset_request_counter
    rng = np.random.default_rng(SEED + 20)
    V = cfg.vocab_size
    systems = [rng.integers(2, V, 1024).tolist() for _ in range(3)]
    prompts = [systems[f] + rng.integers(2, V, int(rng.integers(16, 257)))
               .tolist() for f in range(3) for _ in range(4)]
    prompts += [rng.integers(2, V, int(rng.integers(32, 201))).tolist()
                for _ in range(4)]
    outs = rng.integers(16, 65, len(prompts))
    order = rng.permutation(len(prompts))
    reset_request_counter()
    return [Request(prompt_len=len(prompts[i]), arrival_time=0.0,
                    true_out_len=int(outs[i]), prompt_tokens=prompts[i])
            for i in order]


SERVE20 = dict(arch_size="full", strategy="alise", max_slots=8, seed=SEED,
               prefill_chunk=256, page_size=16, paged_attn_impl="kernel",
               chunk_attn="flash", warmup=True)


def _no_leaks(eng) -> str:
    """After the drain: no lane, host blob, lossy mark or memory
    reservation left; the paged pool's pages are free or held by the
    prefix index alone (then, with the index dropped, the free list
    whole); the dense store's pages indexed or free."""
    kv = eng.kv
    bad = []
    if any(r is not None for r in kv.slot_req) or eng.host_pool \
            or eng._lossy_kv or eng.sched.live or eng.mem.reserved:
        bad.append("engine state left")
    held = kv.prefix.index.n_pages
    if eng.kv_backend == "paged":
        pool = kv.pool
        nodes = {n.page for n in kv.prefix.index.nodes}
        if pool.page_table or any(
                n != 1 or (p != kv.scratch_page and p not in nodes)
                for p, n in pool.refs.items()):
            bad.append("page refcounts")
        kv.prefix.drop_all()
        if sorted(pool.free_pages + [kv.scratch_page]) \
                != list(range(pool.cfg.num_pages)):
            bad.append("free list")
    elif held + len(kv.prefix.free_pages) != kv.prefix.capacity:
        bad.append("store pages")
    if bad:
        fail(f"leaks after the drain: {bad}")
    return f"no leak ({held} pages held by the index, then dropped)"


def _budget_fit(eng, target_tpot: float) -> str:
    """The auto token budget's fit, as ``autotune_token_budget`` made it
    from the warm batch's timing rings (their entries stamped before this
    serve's start): the fitted t0, alpha and beta, the samples in each
    ring, the mean per-lane context, and the budget they give beside the
    one the engine chose (printed, not gated)."""
    from repro_torch.core.latency_model import LatencyModel
    t0 = eng.serve_started
    iters = [e for e in eng.iter_times if e[0] < t0]
    pre = [e for e in eng.prefill_times if e[0] < t0]
    lm = LatencyModel.fit([(n, dt) for _, n, dt, _ in pre],
                          [(c / max(b, 1), dt) for _, c, b, dt in iters])
    ctx = (float(np.mean([c / max(b, 1) for _, c, b, _ in iters]))
           if iters else eng.cfg.max_seq_len / 2)
    again = lm.budget_for_tpot(target_tpot, eng.cfg.max_slots, ctx)
    packs = sum(1 for *_, rows in pre if rows > 1)
    return (f"auto budget fit from the warm batch: t0={lm.t0:.4e} s/token "
            f"alpha={lm.alpha:.4e} s/ctx-token beta={lm.beta:.4e} s; "
            f"{len(iters)} decode-step samples, {len(pre)} prefill samples "
            f"({packs} packs, {sum(n for _, n, _, _ in pre)} tokens), mean "
            f"per-lane context {ctx:.1f}; budget {again} (the engine chose "
            f"{eng.sched.cfg.iter_token_budget})")


# phases 20, 22 and 23: 12 of 40 layers, for the script's 290 s ceiling
# (at 20 layers a slow host and phase 20's auto budget took it past; phase
# 22 ran all 40 until phase 30 came)
GRANITE_CUT = 12


def build(torch, dev, cfg, **kw):
    """(model, params) of ``cfg`` on the card as ``serve``'s
    ``build_model`` builds a model (flash chunk attention, the KV cache in
    the weights' dtype, random weights from the seed); ``kw`` goes to
    ``Model``."""
    from repro_torch.models.model import Model
    model = Model(cfg, chunk_attn_impl="flash", kv_dtype=cfg.param_dtype,
                  device=dev, **kw)
    return model, model.init(torch.Generator(device=dev).manual_seed(SEED))


def granite_cut(model, params):
    """granite-3-8b at full width and its first ``GRANITE_CUT`` of 40
    layers: ``model``'s options over ``params``' first layers, with no
    second draw."""
    from repro_torch.models.model import Model
    cut = Model(model.cfg.scaled(num_layers=GRANITE_CUT),
                chunk_attn_impl=model.chunk_attn_impl,
                kv_dtype=model.kv_dtype, device=model.device)
    print(f"[model] granite-3-8b full width, {GRANITE_CUT} of 40 layers "
          "(phases 20, 22 and 23)", flush=True)
    return cut, {**params, "layers": params["layers"][:GRANITE_CUT]}


def phase_serve20(torch, model, params, kernels, backend):
    """Phase 20, one backend: phase20_requests through
    ``serve(..., warmup=True)`` with the online predictor, packs of 4 and
    the prefix cache (the paged serve with the auto token budget at a
    target TPOT of 30 ms), gated as the module docstring says; then,
    after the paged serve only, the same requests with the prefix cache,
    packing and the learned predictor off, and the count of requests
    whose greedy tokens agree (not gated).  Packs are counted in this
    serve's own traffic (stamped at or after ``eng.serve_started``), not
    in the auto budget's warm batch.  The serve without a budget must
    dispatch one; under the auto budget the count is printed, not gated:
    the scheduler (the reference's) spends the budget chunk by chunk,
    each charged at its bucket, so a budget of a few dozen tokens seldom
    leaves room for a second chunk of the same bucket.  The serve's launches are counted from 0 (the
    comparison serve's are not); returns them."""
    from repro_torch.launch.serve import serve
    from repro_torch.utils.compile_counter import CompileCounter
    auto = backend == "paged"
    extra = dict(iter_token_budget="auto", target_tpot=0.030) if auto else {}
    reqs = phase20_requests(model.cfg)
    reset_counts(kernels)
    counter = CompileCounter()
    reqs, eng = serve(**SERVE20, **extra, kv_backend=backend,
                      prefill_pack=True, prefill_pack_width=4,
                      prefix_cache=True, predictor_kind="online",
                      requests=reqs, device=model.device,
                      model_and_params=(model, params))
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    label = f"granite {backend} serve (phase 20)"
    graph_gate(label, eng, counter, True)
    counter.detach()
    done = [r for r in reqs if r.finish_time is not None]
    if len(done) != len(reqs):
        fail(f"{label}: {len(done)}/{len(reqs)} requests finished")
    st = eng.kv.prefix_stats()
    t0 = eng.serve_started
    warm = sum(1 for t, *_, rows in eng.prefill_times if rows > 1 and t < t0)
    packs = [(rows, dt) for t, _, dt, rows in eng.prefill_times
             if rows > 1 and t >= t0]
    budget = eng.sched.cfg.iter_token_budget
    gen = sum(r.generated for r in reqs)
    wall = max(r.finish_time for r in reqs)
    def ttft(keep):
        got = [r.first_token_time - r.arrival_time for r in reqs if keep(r)]
        return (f"{np.median(got) if got else float('nan'):.3f}s "
                f"({len(got)} requests)")

    # cold requests of the hit requests' length class are the families'
    # first requests (prompts over 1024 tokens that found no hit)
    hit = ttft(lambda r: r.cached_prefix_hint > 0)
    cold_long = ttft(lambda r: not r.cached_prefix_hint
                     and r.prompt_len > 1024)
    cold_short = ttft(lambda r: not r.cached_prefix_hint
                      and r.prompt_len <= 1024)
    steps = [dt * 1e3 for t, _, _, dt in eng.iter_times if t >= t0]
    pack_ms = [dt * 1e3 for _, dt in packs]
    g = eng.predictor.gauges()
    print(f"[serve20] {label}: {len(done)}/{len(reqs)} finished, {gen} "
          f"tokens, {gen / wall:.1f} tok/s, wall {wall:.2f}s; TTFT p50 hit "
          f"{hit}, cold over 1024 tokens {cold_long}, cold short "
          f"{cold_short}; {len(steps)} decode steps p50 "
          f"{np.median(steps):.2f} ms; "
          f"{len(packs)} packs p50 "
          f"{np.median(pack_ms) if pack_ms else float('nan'):.2f} ms "
          f"(this serve's traffic; {warm} more in the auto budget's warm "
          f"batch); "
          f"preemptions {sum(r.preempt_count for r in reqs)}", flush=True)
    print(f"[serve20] {label}: prefix cache {st.hits} hits ({st.partial_hits}"
          f" partial), {st.hit_tokens} hit tokens, {st.misses} misses, "
          f"{st.inserted_pages} pages published, {st.cow_pages} "
          f"copy-on-write, {st.deduped_pages} deduped; packs dispatched "
          f"{len(packs)}, mean occupancy "
          f"{np.mean([m for m, _ in packs]) if packs else 0:.2f} of 4;"
          f" token budget {budget}; launches {counts}", flush=True)
    print(f"[serve20] {label}: predictor gauges: coverage p90 "
          f"{g.get('predictor_cov90_batch', float('nan')):.3f}, MAE "
          f"{g.get('predictor_mae_batch', float('nan')):.1f} tokens, "
          f"{g['predictor_updates']:.0f} updates, feedback queue "
          f"{g['predictor_feedback_depth']:.0f} (drained), mean predict "
          f"latency {eng.predictor.mean_latency_s() * 1e3:.3f} ms per "
          f"request", flush=True)
    if st.hits <= 0 or st.hit_tokens <= 0:
        fail(f"{label}: no prefix hit")
    if not packs and budget is None:
        fail(f"{label}: the serve's traffic dispatched no pack")
    if not packs:
        print(f"[serve20] {label}: no pack in the serve's traffic under "
              f"the auto budget of {budget} tokens an iteration (not "
              f"gated)", flush=True)
    if auto and not isinstance(budget, int):
        fail(f"{label}: the auto budget is {budget!r}, not an integer")
    if auto:
        print(f"[serve20] {label}: {_budget_fit(eng, 0.030)}", flush=True)
    if g["predictor_feedback_depth"]:
        fail(f"{label}: the predictor's feedback was not drained")
    print(f"[serve20] {label}: {_no_leaks(eng)}", flush=True)
    del eng
    torch.cuda.empty_cache()
    if not auto:
        return counts
    ref, _ = serve(**SERVE20, kv_backend=backend, predictor_kind="oracle",
                   iter_token_budget=budget, requests=phase20_requests(
                       model.cfg), device=model.device,
                   model_and_params=(model, params), verbose=False)
    agree = sum(list(a.output_tokens) == list(b.output_tokens)
                for a, b in zip(reqs, ref))
    print(f"[serve20] {label}: the same requests with the prefix cache, "
          f"packing and the learned predictor off: {agree}/{len(reqs)} "
          f"requests' greedy tokens agree (not gated: the schedule "
          f"follows the wall clock, and a pack's shape gives other bits)",
          flush=True)
    return counts


# ------------------------------------------------------------- phase 21

VERIFY_VS_DECODE = 1.25   # the verify's error from the f32 truth, at most
                          # this times the bf16 decode steps' error
SPEC_K = 3
VERIFY_CTX = np.linspace(64, 1600, 8).astype(int)
VERIFY_CTX[1] = 286     # 286 % 16 == 14: this paged lane's span of 4
                        # crosses into its scratch page


def _verify_backend(torch, model, backend, graphs=False):
    """A KV backend with ``spec_k`` 3 holding 8 lanes at VERIFY_CTX, its
    K/V random bf16 from a seed (paged: each lane's pages allocated)."""
    from repro_torch.serving.kv_cache import (DenseKVBackend,
                                              KVBackendConfig, PagedKVBackend)
    B = len(VERIFY_CTX)
    bcfg = KVBackendConfig(max_slots=B, max_seq_len=2048, page_size=16,
                           attn_impl="kernel", cuda_graphs=graphs,
                           spec_k=SPEC_K)
    g = torch.Generator(device=model.device).manual_seed(SEED + 21)
    if backend == "paged":
        kv = PagedKVBackend(model, bcfg, num_pages=B * 130)
        for i, c in enumerate(VERIFY_CTX):
            kv.pool.allocate(i, int(c))
            kv.slot_req[i] = i
        tensors = [kv.pool.k, kv.pool.v]
    else:
        kv = DenseKVBackend(model, bcfg)
        kv.cache["lengths"].copy_(torch.from_numpy(VERIFY_CTX.astype(
            np.int32)))
        tensors = [kv.cache["k"], kv.cache["v"]]
    for t in tensors:
        t.normal_(generator=g)
    return kv, tensors


def _verify_vs_decode(torch, model, params, params32, backend):
    """Phase 21 (a), one backend: one verify step of B 8 lanes x K1 4
    positions at VERIFY_CTX against 4 sequential eager decode steps from
    the same state (dense: ``decode_step``, plain decode attention; paged:
    ``paged_decode_step`` with the paged-attention kernel, at the verify's
    own write destinations), fed the tokens those steps sample greedily,
    and both against the float32 truth: the same 4 decode steps of the
    model in float32 (``params32``: the bf16 weights upcast) from the
    state upcast.  Gates: the verify's logits and written K/V are no
    farther from the truth than VERIFY_VS_DECODE times the bf16 decode
    steps' (plus 1e-3), and its flash calls run once per layer through
    the wgmma body (and its merge when the plan splits).  The verify
    against the bf16 decode steps directly is printed: both are about 5%
    from the truth after 40 bf16 layers, so they differ by as much."""
    from repro_torch.kernels.flash_prefill import flash_prefill_prefix
    from repro_torch.kernels.flash_prefill.ops import body_launches
    from repro_torch.kernels.flash_prefill.plan import num_splits
    from repro_torch.models.model import Model
    from repro_torch.serving.step_graphs import unpack
    cfg, dev = model.cfg, model.device
    B, K1 = len(VERIFY_CTX), SPEC_K + 1
    kv, tensors = _verify_backend(torch, model, backend)
    snap = [t.clone() for t in tensors]
    ctx = torch.from_numpy(VERIFY_CTX.astype(np.int32)).to(dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    z = np.zeros((B,), np.int32)
    if backend == "paged":
        maxp = kv.max_pages_per_seq + 1
        staged = torch.from_numpy(kv._verify_inputs(
            np.zeros((B, K1), np.int32), z, np.ones((B,), bool), z, z, z,
            z)).to(dev)
        tables, lens, wp, wo = unpack(staged[:B * (maxp + 1 + 2 * K1)],
                                      (B, maxp), (B,), (B, K1), (B, K1))
        state = {"k": kv.pool.k, "v": kv.pool.v}
        scratch_col = int((tables[1] == kv.lane_scratch[1]).nonzero()[0])
        if int(wp[1, 2]) != kv.lane_scratch[1] or scratch_col != 18:
            fail("phase 21: lane 1's span does not cross into its scratch "
                 "page")

        def written(st):
            return torch.stack([st[k][:, wp.long(), wo.long()]
                                for k in ("k", "v")])
    else:
        state = kv.cache
        pos = ctx.long()[:, None] + torch.arange(K1, device=dev)[None]
        lanes = torch.arange(B, device=dev)[:, None]

        def written(st):
            return torch.stack([st[k][:, lanes, pos] for k in ("k", "v")])

    def decode_steps(m, prm, st, feed):
        """4 sequential decode steps fed ``feed`` (the greedy tokens of
        the first run are appended to it)."""
        out = []
        for i in range(K1):
            if backend == "paged":
                lg = m.paged_decode_step(prm, st, feed[i], tables, lens + i,
                                         wp[:, i], wo[:, i],
                                         attn_impl="kernel")
            else:
                lg = m.decode_step(prm, st, feed[i], active)
            out.append(lg)
            if len(feed) == i + 1:
                feed.append(lg.argmax(-1, keepdim=True))
        return torch.stack(out, dim=1)

    def restore():
        for t, s in zip(tensors, snap):
            t.copy_(s)
        if backend == "dense":
            kv.cache["lengths"].copy_(ctx)

    rng = np.random.default_rng(SEED + 21)
    toks = [torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, 1))).to(
        dev)]
    seq = decode_steps(model, params, state, toks)
    seq_rows = written(state)
    restore()
    st32 = {k: v.float() for k, v in state.items() if k != "lengths"}
    if backend == "dense":
        st32["lengths"] = ctx.clone()
    m32 = Model(cfg.scaled(param_dtype="float32"), kv_dtype="float32",
                device=dev)
    truth = decode_steps(m32, params32, st32, list(toks))
    truth_rows = written(st32)
    del st32
    drafts = torch.cat(toks[:K1], dim=1).to(torch.int32)
    bodies, n0 = body_launches(), flash_prefill_prefix.launches
    if backend == "paged":
        ver = model.paged_decode_verify(params, state, drafts, tables, lens,
                                        wp, wo)
    else:
        ver = model.decode_verify(params, kv.cache, drafts, active)
    torch.cuda.synchronize()
    bodies = {k: n - bodies[k] for k, n in body_launches().items()}
    launched = flash_prefill_prefix.launches - n0
    label = f"{backend} verify (phase 21)"
    errs = {}
    for what, v, sq, tr in (("logits", ver, seq, truth),
                            ("K/V", written(state), seq_rows, truth_rows)):
        if not bool(torch.isfinite(v.float()).all()):
            fail(f"{label} {what}: non-finite values")
        errs[what] = (_rel(v, tr), _rel(sq, tr), _rel(v, sq))
    agree = (ver.argmax(-1) == seq.argmax(-1)).float().mean().item()
    L = cfg.num_layers
    Smax = tables.shape[1] * 16 if backend == "paged" else 2048
    split = num_splits(B, cfg.num_kv_heads,
                       cfg.num_heads // cfg.num_kv_heads, K1, Smax) > 1
    print(f"[verify] {label}: B={B} K1={K1} ctx {VERIFY_CTX.tolist()} "
          f"Smax={Smax}, one verify step vs {K1} sequential bf16 decode "
          f"steps fed their greedy tokens, each against the f32 truth: "
          + "; ".join(f"{w} rel_l2 verify {a:.4g}, decode {b:.4g} (verify "
                      f"vs decode {c:.4g})" for w, (a, b, c) in errs.items())
          + f"; argmax agree {agree:.3f}; flash_prefill_prefix launches "
          f"{launched}, bodies {bodies}", flush=True)
    for what, (a, b, _) in errs.items():
        if not a <= VERIFY_VS_DECODE * b + 1e-3:
            fail(f"{label} {what}: {a:.4g} from the f32 truth, more than "
                 f"{VERIFY_VS_DECODE} x the decode steps' {b:.4g}")
    if launched != L or bodies["wgmma"] != L or bodies["fma"] \
            or bodies["tf32x3"] or bodies["merge"] != (L if split else 0):
        fail(f"{label}: the verify's flash calls did not all take the "
             f"wgmma body{' and its merge' if split else ''}")
    del kv, tensors, snap, m32
    torch.cuda.empty_cache()


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def engine_verify(model, params, backend, cuda_graphs):
    """A step for profiling a KV backend's verify step as the engine calls
    it (host inputs staged, samples, emit counts and reasons back on the
    host), with or without CUDA graphs: 8 lanes at VERIFY_CTX, each with 3
    seeded drafts; each call starts from the same lengths (dense: the
    lengths reset on the device; paged: the pool's lengths and page
    tables, a promoted scratch page dropped).  The first call captures
    the graph."""
    import torch
    kv, _ = _verify_backend(torch, model, backend, cuda_graphs)
    B, K1 = len(VERIFY_CTX), SPEC_K + 1
    rng = np.random.default_rng(SEED + 22)
    ctx = VERIFY_CTX.astype(np.int32)
    args = (rng.integers(2, model.cfg.vocab_size, (B, K1)).astype(np.int32),
            np.full((B,), SPEC_K, np.int32), np.ones((B,), bool),
            np.ones((B,), np.int32), ctx + 1,
            np.full((B,), np.iinfo(np.int32).max, np.int32),
            np.arange(B, dtype=np.int32))
    lens = torch.from_numpy(ctx).to(model.device)
    n_pages = ({i: len(kv.pool.page_table[i]) for i in range(B)}
               if backend == "paged" else {})

    def step():
        if backend == "dense":
            kv.cache["lengths"].copy_(lens)
        for i, n in n_pages.items():
            del kv.pool.page_table[i][n:]
            kv.pool.lengths[i] = int(ctx[i])
        return kv.decode_verify(params, *args)
    return step


def phase_verify_model(torch, model, params):
    """Phase 21 (a): the verify step against sequential decode steps and
    the float32 truth on both backends (:func:`_verify_vs_decode`; the
    weights upcast once, 33 GB), then the verify step as
    the engine calls it, graphed and eager, under the profiler (the wgmma
    flash body must run)."""
    from repro_torch.utils import tree_map
    params32 = tree_map(lambda t: t.float(), params)
    for backend in ("dense", "paged"):
        _verify_vs_decode(torch, model, params, params32, backend)
    del params32
    torch.cuda.empty_cache()
    for backend in ("dense", "paged"):
        for graphs in (True, False):
            how = "graphed" if graphs else "eager"
            profile_step(torch, f"engine verify step ({how}, {backend}, B=8,"
                         f" K1={SPEC_K + 1}, ctx 64..1600)",
                         engine_verify(model, params, backend, graphs), n=3,
                         watch=("flash_attn_wgmma",))
            torch.cuda.empty_cache()


def _spec_engine(model, params, backend, graphs):
    """Phase 5's (paged) or phase 16's (dense) engine, warmed, with
    speculative decoding at spec_k 3: the configuration ``serve()`` builds
    from PAGED_SERVE or DENSE_SERVE plus ``spec_decode``."""
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    return ServingEngine(model, params, EngineConfig(
        max_slots=8, max_seq_len=2048, max_new_tokens=64, strategy="alise",
        quantize_offload=False, kv_backend=backend, page_size=16,
        paged_attn_impl="kernel",
        prefill_chunk=256 if backend == "paged" else None,
        spec_decode=True, spec_k=SPEC_K, warmup_compile=True,
        cuda_graphs=graphs, seed=SEED), predictor=OraclePredictor())


def _spec_serve(model, params, kernels, backend, graphs, bus=None):
    """Phase 5's 8 requests through :func:`_spec_engine`; returns the
    requests, the engine, its launches during the warmup and the serve's
    wall (from the end of the warmup)."""
    import torch
    from repro_torch.launch.serve import build_requests
    counts0 = read_counts(kernels)
    eng = _spec_engine(model, params, backend, graphs)
    warm = {n: c - counts0[n] for n, c in read_counts(kernels).items()}
    if bus is not None:
        eng.attach_bus(bus, "engine0")
    reqs = build_requests(model.cfg, PAGED_SERVE["n_requests"], SEED, "full")
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    return reqs, eng, warm, time.perf_counter() - t0


def _tok_s(reqs) -> float:
    """Generated tokens per second of a serve, over the latest finish
    (the engine's clock: seconds since ``serve()`` began)."""
    return sum(r.generated for r in reqs) / max(r.finish_time for r in reqs)


def phase_spec_serve(torch, model, params, kernels, backend, spec_off):
    """Phase 21 (b) and (c), one backend: phase 5's 8 requests on a
    warmed speculative engine (spec_k 3) with a wall-clock EventBus
    attached, counted from 0 (the main path); gates: every request
    finishes, drafts were proposed, no capture or library load after the
    warmup and one verify replay per decode iteration (``graph_gate``),
    the prefix flash kernel launched 40 times per verify step on top of
    40 per prefill chunk, the bus's decode iterations carry the drafted
    and accepted counts, and the greedy tokens equal those of the same
    serve without the bus, bit for bit; then the
    verify step graphed against eager (:func:`graphed_vs_eager_step`, 8
    lanes at ``VERIFY_CTX``, 3 drafts); printed: accepted /
    drafted, tokens per lane iteration, tokens/s beside the spec-off
    serve's (``spec_off``: phase 5's or 16's requests), decode-iteration
    p50, and how many requests' tokens agree with the spec-off serve (not
    gated: a (B x 4)-row verify rounds otherwise than a B-row decode).
    (c): the trace and its ``.prom`` written to a temporary directory, the
    JSON loaded back, its events counted by name.  Returns the launches."""
    import tempfile
    from collections import Counter
    from repro_torch.launch.serve import _export_trace
    from repro_torch.serving.observability import EventBus, analyze_quality
    from repro_torch.utils.compile_counter import CompileCounter
    label = f"granite {backend} spec serve (phase 21)"
    reset_counts(kernels)
    counter = CompileCounter()
    bus = EventBus(clock="wall")
    reqs, eng, warm, wall = _spec_serve(model, params, kernels, backend,
                                        True, bus)
    counts = read_counts(kernels)
    graph_gate(label, eng, counter, True)
    counter.detach()
    L = model.cfg.num_layers
    done = [r for r in reqs if r.finish_time is not None]
    drafted = sum(r.spec_drafted for r in reqs)
    accepted = sum(r.spec_accepted for r in reqs)
    iters = sum(r.spec_iters for r in reqs)
    steps, chunks = len(eng.iter_times), len(eng.prefill_times)
    flash = counts["flash_prefill_prefix"] - warm["flash_prefill_prefix"]
    events = bus.snapshot()
    dec = [e for e in events if e.kind == "decode_iter"]
    step_ms = [dt * 1e3 for *_, dt in eng.iter_times]
    print(f"[spec] {label}: {len(done)}/{len(reqs)} finished, "
          f"{sum(r.generated for r in reqs)} tokens, {_tok_s(reqs):.1f} "
          f"tok/s (spec off, phase {5 if backend == 'paged' else 16}: "
          f"{_tok_s(spec_off):.1f}, by the same measure), wall "
          f"{wall:.2f}s; {accepted}/{drafted} drafts accepted "
          f"({accepted / max(drafted, 1):.3f}), "
          f"{(iters + accepted) / max(iters, 1):.3f} tokens per lane "
          f"iteration; {steps} verify steps p50 {np.median(step_ms):.2f} "
          f"ms; {chunks} prefill chunks; flash_prefill_prefix launches "
          f"after warmup {flash} ({L} x ({steps} + {chunks}) = "
          f"{L * (steps + chunks)}); launches {counts}", flush=True)
    if len(done) != len(reqs):
        fail(f"{label}: {len(done)}/{len(reqs)} requests finished")
    if drafted <= 0:
        fail(f"{label}: no draft was proposed")
    if flash != L * (steps + chunks):
        fail(f"{label}: flash_prefill_prefix launched {flash} times after "
             f"the warmup, want {L * (steps + chunks)}")
    if (len(dec) != steps or sum(e.data["drafted"] for e in dec) != drafted
            or sum(e.data["accepted"] for e in dec) != accepted):
        fail(f"{label}: the bus's decode_iter events do not carry the "
             "serve's drafted and accepted counts")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        _export_trace(bus, analyze_quality(bus), path)
        with open(path) as f:
            trace = json.load(f)
        prom = os.path.getsize(path + ".prom")
    names = Counter("request spans" if e["name"].startswith("req ")
                    else e["name"] for e in trace["traceEvents"]
                    if e.get("ph") != "M")
    print(f"[trace] {label}: {len(events)} bus events, "
          f"{len(trace['traceEvents'])} trace events loaded back, "
          f"{prom} bytes of Prometheus text; by name: "
          + ", ".join(f"{k} {v}" for k, v in sorted(names.items())),
          flush=True)
    if not dec or prom <= 0 or names["finish"] != len(reqs):
        fail(f"{label}: the exported trace lacks its events")
    del eng, bus, events, trace
    torch.cuda.empty_cache()
    untraced, eng, _, wall = _spec_serve(model, params, kernels, backend,
                                         True)
    print(f"[spec] {label}, no bus: {_tok_s(untraced):.1f} tok/s, wall "
          f"{wall:.2f}s", flush=True)
    same_tokens(label + " (traced vs untraced)", reqs, untraced)
    del eng
    torch.cuda.empty_cache()
    graphed_vs_eager_step(torch, label, model, params, backend, VERIFY_CTX,
                          spec_k=SPEC_K)
    agree = sum(list(a.output_tokens) == list(b.output_tokens)
                for a, b in zip(reqs, spec_off))
    print(f"[spec] {label}: {agree}/{len(reqs)} requests' greedy tokens "
          f"agree with the spec-off serve (not gated: in bf16 a (B x "
          f"{SPEC_K + 1})-row verify and a B-row decode round "
          f"differently)", flush=True)
    return counts


# ------------------------------------------------------ phases 8 to 11

# ------------------------------------------------------------- phase 22

TIER_ENGINE = dict(max_slots=4, max_seq_len=2048, max_new_tokens=64,
                   strategy="alise", quantize_offload=False,
                   kv_backend="paged", page_size=16,
                   paged_attn_impl="kernel", prefill_chunk=256,
                   prefix_cache=True, cuda_graphs=False, seed=SEED)
TIER_SYSTEM = 1024                      # the shared system prompt's tokens
TIER_Q8_BOUND = 0.02                    # phase 3's INT8 round-trip bound


def _tier_engine(model, params, tier=None, **kw):
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    eng = ServingEngine(model, params, EngineConfig(**{**TIER_ENGINE, **kw}),
                        predictor=OraclePredictor())
    if tier is not None:
        eng.attach_tier(tier)
    return eng


def _index_pages(kv, toks, n):
    """The pages (pool or store) a prefix cache's index holds for the
    first ``n`` tokens of ``toks``."""
    return [node.page for node in kv.prefix.index.match(toks, n,
                                                        touch=False)[0]]


def _same_pages(torch, src_pool, src_pages, dst, dst_pages) -> bool:
    """Whether ``dst`` (a pool or a dense store: ``k``/``v`` (L, pages,
    page, KVH, hd)) holds at ``dst_pages`` the bits ``src_pool`` holds at
    ``src_pages``."""
    a = torch.as_tensor(src_pages, device=src_pool.k.device)
    b = torch.as_tensor(dst_pages, device=dst.k.device)
    return (len(src_pages) == len(dst_pages)
            and torch.equal(src_pool.k[:, a], dst.k[:, b])
            and torch.equal(src_pool.v[:, a], dst.v[:, b]))


def _timed_publishes(tier, log):
    """Wrap ``tier.publish`` so that each call's seconds (the host copies
    or quantizations of the pages it stores, each synchronized) and pages
    land in ``log``."""
    real = tier.publish

    def publish(tokens, upto, fetch_page):
        t0 = time.perf_counter()
        n = real(tokens, upto, fetch_page)
        log.append((time.perf_counter() - t0, n))
        return n
    tier.publish = publish


def _timed_fills(torch, eng, log):
    """Wrap ``eng.kv.tier_fill`` so that each fill's seconds (until the
    device has the pages), payload bytes and tokens land in ``log``."""
    real = eng.kv.tier_fill

    def tier_fill(tokens, handle):
        t0 = time.perf_counter()
        got = real(tokens, handle)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, handle.nbytes, got))
        return got
    eng.kv.tier_fill = tier_fill


def _rate(log) -> str:
    secs = sum(x[0] for x in log)
    nbytes = sum(x[1] for x in log)
    return (f"{len(log)} calls, {nbytes / 1e6:.1f} MB in {secs * 1e3:.1f} ms"
            f" ({nbytes / max(secs, 1e-12) / 1e9:.2f} GB/s)")


def _tier_model_level(torch, model, params, kernels):
    """Phase 22 (a): the import of a 1024-token system prompt, model-level,
    gated bit for bit (fp tier, paged and dense importers) and within the
    INT8 round trip (quantized tier).  See the module docstring."""
    from repro_torch.core.request import Request, reset_request_counter
    from repro_torch.distributed.placement import place_params
    from repro_torch.serving.kv_tier import HostKVTier
    from repro_torch.utils import tree_leaves
    from repro_torch.utils.compile_counter import CompileCounter
    V, pg = model.cfg.vocab_size, TIER_ENGINE["page_size"]
    rng = np.random.default_rng(SEED + 221)
    system = rng.integers(2, V, TIER_SYSTEM).tolist()
    prompt_a = system + rng.integers(2, V, 200).tolist()
    x = system + rng.integers(2, V, 100).tolist()
    tier = HostKVTier(8e9, pg)
    pubs, fills = [], []
    _timed_publishes(tier, pubs)
    a = _tier_engine(model, params, tier)
    page_bytes = 2 * a.kv.pool.k[:, 0].numel() * a.kv.pool.k.element_size()
    reset_request_counter()
    a.serve([Request(prompt_len=len(prompt_a), arrival_time=0.0,
                     true_out_len=2, prompt_tokens=list(prompt_a))])
    torch.cuda.synchronize()
    # A's own request with the shared prefix: a local hit of 1024
    hit_a = a.kv.prefix_acquire(1000, x)
    logits_a = a.kv.prefill_chunk(params, 1000, x[hit_a:], hit_a)
    pages_a = _index_pages(a.kv, x, TIER_SYSTEM)
    # replica B on the same card: the same weights (no copy), its own pool
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params_b = place_params(params, model.device)
    shared = all(p is q for (_, p), (_, q) in zip(tree_leaves(params),
                                                  tree_leaves(params_b)))
    b = _tier_engine(model, params_b, tier)
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - before
    pool_b = 2 * b.kv.pool.k.numel() * b.kv.pool.k.element_size()
    print(f"[tier] phase 22 (a): replica B placed on {model.device}: "
          f"{'the same' if shared else 'COPIED'} weight tensors, device "
          f"memory grew {grew / 2**30:.2f} GiB for a {pool_b / 2**30:.2f} "
          f"GiB pool", flush=True)
    if not shared or grew >= pool_b + 2**30:
        fail("phase 22 (a): replica B does not share replica A's weights")
    _timed_fills(torch, b, fills)
    got = b._tier_import(2000, x, 0.0)
    hit_b = b.kv.prefix_acquire(2000, x)
    logits_b = b.kv.prefill_chunk(params_b, 2000, x[hit_b:], hit_b)
    torch.cuda.synchronize()
    pages_b = _index_pages(b.kv, x, TIER_SYSTEM)
    same_pages = _same_pages(torch, a.kv.pool, pages_a, b.kv.pool, pages_b)
    same_logits = torch.equal(logits_a, logits_b)
    print(f"[tier] phase 22 (a) paged B: imported {got} tokens "
          f"({len(pages_b)} pages), hit {hit_b} (A's local hit {hit_a}); "
          f"pages {'equal' if same_pages else 'DIFFER from'} A's bit for "
          f"bit; last logits "
          + ("equal A's bit for bit" if same_logits else
             f"DIFFER (max_abs "
             f"{(logits_a - logits_b).abs().max().item():.4g})")
          + f"; publishes (host copies) {_rate([(t, n * page_bytes) for t, n in pubs])}"
          f"; tier_fill {_rate(fills)}", flush=True)
    if not (got == hit_b == hit_a == TIER_SYSTEM and same_pages
            and same_logits):
        fail("phase 22 (a): the paged import is not bit for bit A's prefix")
    if tier.pinned_pages():
        fail("phase 22 (a): the import left tier pages pinned")
    del b, params_b
    torch.cuda.empty_cache()
    # a dense importer: the tier payload lands in its private store
    d = _tier_engine(model, params, tier, kv_backend="dense")
    got = d._tier_import(3000, x, 0.0)
    store = _index_pages(d.kv, x, TIER_SYSTEM)
    same_pages = _same_pages(torch, a.kv.pool, pages_a, d.kv.prefix, store)
    hit_d = d.kv.prefix_acquire(3000, x)
    logits_d = d.kv.prefill_chunk(params, 3000, x[hit_d:], hit_d)
    torch.cuda.synchronize()
    same_logits = torch.equal(logits_a, logits_d)
    print(f"[tier] phase 22 (a) dense B: imported {got} tokens into its "
          f"store ({len(store)} pages), hit {hit_d}; pages "
          f"{'equal' if same_pages else 'DIFFER from'} A's bit for bit; "
          f"last logits "
          + ("equal A's bit for bit" if same_logits else
             f"DIFFER (max_abs "
             f"{(logits_a - logits_d).abs().max().item():.4g})"), flush=True)
    if not (got == hit_d == TIER_SYSTEM and same_pages and same_logits):
        fail("phase 22 (a): the dense import is not bit for bit A's prefix")
    raw_bytes = sum(tier.entries[n.page].nbytes for n in
                    tier.index.match(x, TIER_SYSTEM, touch=False)[0])
    del d
    a.kv.clear(1000)
    torch.cuda.empty_cache()
    # the quantized tier: A publishes its prompt again (its cache dropped)
    # into an INT8 tier, and a paged importer serves the shared request
    q8 = HostKVTier(8e9, pg, quantize=True)
    counter = CompileCounter()
    start = read_counts(kernels)
    a.attach_tier(q8)
    qpubs, qfills = [], []
    _timed_publishes(q8, qpubs)
    a.kv.prefix.drop_all()
    a.serve([Request(prompt_len=len(prompt_a), arrival_time=0.0,
                     true_out_len=2, prompt_tokens=list(prompt_a))])
    pages_a = _index_pages(a.kv, x, TIER_SYSTEM)
    bq = _tier_engine(model, params, q8)
    _timed_fills(torch, bq, qfills)
    seen, publishes = [], q8.stats.publishes
    real_import = bq._tier_import

    def tier_import(rid, toks, t):
        got = real_import(rid, toks, t)
        seen.append((got, rid in bq._lossy_kv))
        return got
    bq._tier_import = tier_import
    bq._publish = lambda req, toks, t: fail(
        "phase 22 (a): a lossy importer published")
    reset_request_counter()
    req = Request(prompt_len=len(x), arrival_time=0.0, true_out_len=4,
                  prompt_tokens=list(x))
    bq.serve([req])
    torch.cuda.synchronize()
    launches = {k: n - start[k] for k, n in read_counts(kernels).items()}
    pages_q = _index_pages(bq.kv, x, TIER_SYSTEM)
    ia = torch.as_tensor(pages_a, device=model.device)
    ib = torch.as_tensor(pages_q, device=model.device)
    err = max(((bq.kv.pool.k[:, ib].float() - a.kv.pool.k[:, ia].float())
               .abs().max() / a.kv.pool.k[:, ia].float().abs().max()).item(),
              ((bq.kv.pool.v[:, ib].float() - a.kv.pool.v[:, ia].float())
               .abs().max() / a.kv.pool.v[:, ia].float().abs().max()).item())
    q8_bytes = sum(q8.entries[n.page].nbytes for n in
                   q8.index.match(x, TIER_SYSTEM, touch=False)[0])
    q8_page = q8_bytes // len(pages_q)
    loads = [e for e in counter.events if not e.startswith("first-use")]
    counter.detach()
    print(f"[tier] phase 22 (a) q8 tier: {TIER_SYSTEM}-token prefix "
          f"payload {q8_bytes / 1e6:.2f} MB vs raw {raw_bytes / 1e6:.2f} MB "
          f"({q8_bytes / raw_bytes:.3f}x); kv_quantize_store launches "
          f"{launches['kv_quantize_store']}, kv_dequantize launches "
          f"{launches['kv_dequantize']}; publishes (quantize + host "
          f"copies) {_rate([(t, n * q8_page) for t, n in qpubs])}; tier_fill "
          f"{_rate(qfills)}; imports {seen} (tokens, lossy); "
          f"imported pages' relative error {err:.4g} (bound "
          f"{TIER_Q8_BOUND}); tier publishes {publishes} -> "
          f"{q8.stats.publishes}; {req.generated} tokens served; pinned "
          f"pages {q8.pinned_pages()}; library loads or captures "
          f"{loads}", flush=True)
    if not (launches["kv_quantize_store"] > 0
            and launches["kv_dequantize"] > 0):
        fail("phase 22 (a): the q8 tier did not launch the kv_quant kernels")
    if not (seen and seen[0] == (TIER_SYSTEM, True)):
        fail("phase 22 (a): the q8 import was not a lossy 1024-token import")
    if not (err < TIER_Q8_BOUND and q8.stats.publishes == publishes
            and q8.pinned_pages() == 0 and req.generated >= 1 and not loads):
        fail("phase 22 (a): the q8 import broke a gate")
    del a, bq
    torch.cuda.empty_cache()


def phase22_prompts(cfg):
    """Phase 22 (b)'s traffic: 3 families sharing a 1024-token system
    prompt, each a head (a tail of 16 tokens, so that an import of the
    head's prompt stops at 1024, a chunk boundary) and 2 members (tails of
    16-256 tokens), and 3 distinct prompts of 64-512 tokens; outputs of
    16-32 tokens.  Returns (prompts, outputs): the heads first."""
    rng = np.random.default_rng(SEED + 222)
    V = cfg.vocab_size
    systems = [rng.integers(2, V, TIER_SYSTEM).tolist() for _ in range(3)]
    prompts = [s + rng.integers(2, V, 16).tolist() for s in systems]
    prompts += [s + rng.integers(2, V, int(rng.integers(16, 257))).tolist()
                for s in systems for _ in range(2)]
    prompts += [rng.integers(2, V, int(rng.integers(64, 513))).tolist()
                for _ in range(3)]
    return prompts, rng.integers(16, 33, len(prompts)).tolist()


def _requests22(prompts, outs):
    from repro_torch.core.request import Request, reset_request_counter
    reset_request_counter()
    return [Request(prompt_len=len(p), arrival_time=0.0, true_out_len=o,
                    prompt_tokens=list(p)) for p, o in zip(prompts, outs)]


def _tier_serve(torch, model, params):
    """Phase 22 (b): two warmed paged engines of phase 5's configuration
    sharing an fp tier; A serves the families' heads, B all 12 requests;
    then B again with the tier off and its cache cleared (see the module
    docstring)."""
    from repro_torch.distributed.placement import place_params
    from repro_torch.serving.kv_tier import HostKVTier
    from repro_torch.serving.observability import EventBus
    from repro_torch.utils.compile_counter import CompileCounter
    prompts, outs = phase22_prompts(model.cfg)
    fam = {i: (i if i < 3 else (i - 3) // 2 if i < 9 else None)
           for i in range(len(prompts))}
    serve_cfg = dict(max_slots=8, max_new_tokens=64, cuda_graphs=True,
                     warmup_compile=True)
    tier = HostKVTier(8e9, TIER_ENGINE["page_size"])
    pubs, fills = [], []
    _timed_publishes(tier, pubs)
    a = _tier_engine(model, params, tier, **serve_cfg)
    b = _tier_engine(model, place_params(params, model.device), tier,
                     **serve_cfg)
    bus = EventBus(clock="wall")
    b.attach_bus(bus, "B")
    _timed_fills(torch, b, fills)
    # both engines are warm: every event from here on is a serve-time one
    counter = CompileCounter()
    a.serve(_requests22(prompts[:3], outs[:3]))
    reqs = _requests22(prompts, outs)
    b.serve(reqs)
    torch.cuda.synchronize()
    graph_gate("phase 22 (b) replicas A and B", a, counter, False)
    graph_gate("phase 22 (b) replica B", b, counter, False)
    counter.detach()
    done = [r for r in reqs if r.finish_time is not None]
    imported = {ev.req_id for ev in bus.snapshot()
                if ev.kind == "tier_import"}
    idx = {r.req_id: i for i, r in enumerate(reqs)}
    families = {fam[idx[rid]] for rid in imported} - {None}

    def p50(keep):
        got = [r.first_token_time - r.arrival_time for r in reqs if keep(r)]
        return (f"{np.median(got) if got else float('nan'):.3f}s "
                f"({len(got)})")
    g = tier.gauges()
    page_bytes = 2 * b.kv.pool.k[:, 0].numel() * b.kv.pool.k.element_size()
    print(f"[tier] phase 22 (b): B served {len(done)}/{len(reqs)}, "
          f"{_tok_s(reqs):.1f} tok/s; TTFT p50 imported "
          f"{p50(lambda r: r.req_id in imported)}, local hit "
          f"{p50(lambda r: r.req_id not in imported and r.cached_prefix_hint)}"
          f", cold {p50(lambda r: not r.cached_prefix_hint)}; tier imports "
          f"{len(imported)} over families {sorted(families)}; tier_fill "
          f"{_rate(fills)}: {[round(t * 1e3, 2) for t, *_ in fills]} ms; "
          f"publishes (host copies) "
          f"{_rate([(t, n * page_bytes) for t, n in pubs])}: "
          f"{[round(t * 1e3, 2) for t, _ in pubs]} ms; tier gauges "
          f"{ {k: round(v, 4) for k, v in g.items()} }", flush=True)
    if len(done) != len(reqs) or families != {0, 1, 2}:
        fail("phase 22 (b): unfinished requests or a family without a "
             "tier import")
    if tier.pinned_pages():
        fail("phase 22 (b): tier pages left pinned")
    print(f"[tier] phase 22 (b) replica A: {_no_leaks(a)}; replica B: "
          f"{_no_leaks(b)}; tier pins 0", flush=True)
    # B again, the tier off and its local cache cleared (by _no_leaks)
    b.tier = b.kv.prefix.tier = None
    ref = _requests22(prompts, outs)
    b.serve(ref)
    torch.cuda.synchronize()
    differ = [i for i, (r, q) in enumerate(zip(reqs, ref))
              if list(r.output_tokens) != list(q.output_tokens)]
    print(f"[tier] phase 22 (b) replica B with the tier off and its cache "
          f"cleared: {_tok_s(ref):.1f} tok/s, {sum(r.generated for r in ref)}"
          f" tokens; greedy tokens "
          + ("equal the tier serve's bit for bit" if not differ
             else f"DIFFER in requests {differ}"), flush=True)
    if differ:
        fail("phase 22 (b): B's greedy tokens depend on the tier")
    del a, b
    torch.cuda.empty_cache()


def phase_tier(torch, model, params, kernels):
    """Phase 22: two granite-3-8b replicas on one card sharing a host KV
    tier, (a) at the model level and (b) serving.  Returns the launches of
    both parts, counted from 0."""
    reset_counts(kernels)
    _tier_model_level(torch, model, params, kernels)
    _tier_serve(torch, model, params)
    return read_counts(kernels)


# ------------------------------------------------------------- phase 23

# the launcher's gateway mode on phase 5's engine configuration (raw
# swaps, the oracle predictor, warmed replicas), in wall clock with the
# concurrent pump and tracing on; sharegpt arrivals at 6/s
GATEWAY23 = dict(arch_size="full", dataset="sharegpt", rate=6.0,
                 n_requests=16, n_engines=2, max_slots=8, router="ewt",
                 interactive_frac=0.25, seed=SEED, predictor_kind="oracle",
                 kv_backend="paged", prefill_chunk=256, warmup=True,
                 virtual_dt=None,
                 pump="concurrent", trace=True, metrics_interval=0.5)
GATEWAY23_ROWS = ("paged_attention", "flash_prefill_prefix", "fused_rmsnorm")


def _copies(reqs, arrival=None):
    """Fresh requests with the same prompts, output lengths, classes and
    (unless ``arrival`` is given) arrival times."""
    from repro_torch.core.request import Request
    return [Request(prompt_len=r.prompt_len,
                    arrival_time=(r.arrival_time if arrival is None
                                  else arrival),
                    true_out_len=r.true_out_len,
                    prompt_tokens=list(r.prompt_tokens),
                    slo_class=r.slo_class) for r in reqs]


def _replayed(engines):
    """The launch counters the engines' graph replays advanced so far,
    summed over engines and keys."""
    out = {}
    for e in engines:
        for n, per in e.kv.graphs.replayed().values():
            for c, k in per.items():
                out[c] = out.get(c, 0) + n * k
    return out


def _steps_since(eng, since):
    """Decode-step and prefill wall times (ms) of ``eng`` that began at or
    after the perf_counter stamp ``since``."""
    steps = [dt * 1e3 for t0, _, _, dt in eng.iter_times if t0 >= since]
    pre = [dt * 1e3 for t0, _, dt, _ in eng.prefill_times if t0 >= since]
    return steps, pre


def _gateway_summary(gw, streams, wall, since):
    """tokens/s over both replicas, TTFT p50/p90 per class, normalized
    latency, dispatches and each replica's step walls, as one string;
    also returns (tokens/s, TTFT p50 of all requests)."""
    m = gw.metrics.summary()
    reqs = [s.request for s in streams]
    tokens = sum(len(s.token_values) for s in streams)
    norm = [r.normalized_latency for r in reqs if r.normalized_latency]
    ttft = [r.first_token_time - r.arrival_time for r in reqs]
    per = {}
    for d in gw.router.drivers:
        steps, pre = _steps_since(d.engine, since)
        per[d.name] = (f"decode p50 {np.median(steps):.2f} ms ({len(steps)}"
                       f" steps), prefill p50 {np.median(pre):.2f} ms "
                       f"({len(pre)})")
    text = (f"{tokens} tokens in {wall:.2f}s, {tokens / wall:.1f} tok/s; "
            + "; ".join(f"{c} TTFT p50/p90 {m[c]['ttft_p50']:.3f}/"
                        f"{m[c]['ttft_p90']:.3f}s (n={m[c]['completed']})"
                        for c in ("interactive", "batch"))
            + f"; TTFT p50 all {np.median(ttft):.3f}s; normalized latency "
            f"{np.mean(norm) * 1e3:.1f} ms/token; "
            + "; ".join(f"{k}: {v}" for k, v in per.items()))
    return text, tokens / wall, float(np.median(ttft))


def phase_gateway(torch, model, params, kernels):
    """Phase 23: two warmed replicas behind the online gateway, built and
    served by ``launch/serve.serve_gateway`` in wall clock under the
    concurrent pump; (b) the batch serve on replica A and (c) the
    lockstep pump against it.  Returns (a)'s launches, counted from 0
    once the replicas are warm."""
    import asyncio
    import dataclasses

    from repro_torch.launch.serve import serve_gateway
    from repro_torch.serving.gateway import Gateway, GatewayConfig
    from repro_torch.utils.compile_counter import CompileCounter
    state = {}

    def ready(gw):
        engines = [d.engine for d in gw.router.drivers]
        for e in engines:
            # one card: every pump thread starts on the process's device
            if e.model.device.type != "cuda" or torch.device(
                    e.device) != torch.device("cuda:0"):
                fail(f"phase 23: a replica is on {e.device}, not cuda:0")
        if engines[1].params["embed"] is not params["embed"]:
            fail("phase 23: replica B does not share A's weights")
        torch.cuda.synchronize()
        state["counter"] = CompileCounter()
        state["replayed"] = _replayed(engines)
        reset_counts(kernels)
        state["t0"] = time.perf_counter()

    try:
        streams, gw = serve_gateway(**GATEWAY23, device=model.device,
                                    model_and_params=(model, params),
                                    on_ready=ready)
    except Exception as exc:     # stop_pumps re-raises a pump's failure
        fail(f"phase 23 (a): the concurrent serve raised {exc!r}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - state["t0"]
    launches = read_counts(kernels)
    counter = state["counter"]
    counter.detach()
    engines = [d.engine for d in gw.router.drivers]
    for d in gw.router.drivers:
        graph_gate(f"gateway {d.name} (phase 23)", d.engine, counter, False)
    replayed = _replayed(engines)
    want = {k: replayed.get(k, 0) - state["replayed"].get(k, 0)
            for k in kernels}
    events = gw.bus.snapshot()
    dispatch = {}
    for e in events:
        if e.kind == "dispatch":
            dispatch[e.replica] = dispatch.get(e.replica, 0) + 1
    gauges = sum(1 for e in events if e.kind == "gauge")
    ends = {}
    for s in streams:
        ends[s.events_log[-1].kind] = ends.get(s.events_log[-1].kind, 0) + 1
    text, tok_s, ttft = _gateway_summary(gw, streams, wall, state["t0"])
    print(f"[gateway] (a) concurrent pump, 2 replicas: {text}; dispatches "
          f"{dispatch}; {gauges} gauge snapshots; stream ends {ends}; "
          f"launches {launches}, replays {want}", flush=True)
    if len(streams) != GATEWAY23["n_requests"] or ends != {
            "finish": len(streams)}:
        fail(f"phase 23 (a): streams ended {ends}")
    for s in streams:
        idx = [ev.index for ev in s.events_log if ev.kind == "token"]
        if (s.token_values != list(s.request.output_tokens)
                or idx != list(range(len(idx)))):
            fail(f"phase 23 (a): stream {s.request.req_id} lost or "
                 "repeated a token")
    if len(dispatch) != 2 or not all(e.sched.finished for e in engines):
        fail(f"phase 23 (a): both replicas must serve (dispatches "
             f"{dispatch})")
    if not gauges:
        fail("phase 23 (a): the bus holds no gauge snapshot")
    if launches != want or not all(launches[k] > 0 for k in GATEWAY23_ROWS):
        fail(f"phase 23 (a): launches {launches} are not the replays' "
             f"{want}, or a row of {GATEWAY23_ROWS} did not launch")

    # (b) the same requests at t=0 on replica A alone, batch mode
    a = engines[0]
    batch = _copies([s.request for s in streams], arrival=0.0)
    t0 = time.perf_counter()
    a.serve(batch)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    want_tokens = [list(r.output_tokens) for r in batch]
    got = [s.token_values for s in streams]
    differ = [i for i, (x, y) in enumerate(zip(got, want_tokens)) if x != y]
    steps, pre = _steps_since(a, t0)
    b_tokens = sum(r.generated for r in batch)
    print(f"[gateway] (b) batch serve on replica A: {b_tokens} tokens in "
          f"{b_wall:.2f}s, {b_tokens / b_wall:.1f} tok/s, decode p50 "
          f"{np.median(steps):.2f} ms ({len(steps)} steps), prefill p50 "
          f"{np.median(pre):.2f} ms, preemptions "
          f"{sum(r.preempt_count for r in batch)}; streams of (a) "
          + ("equal bit for bit" if not differ else f"{differ} differ"),
          flush=True)
    if differ:
        fail(f"phase 23 (b): streams {differ} differ from the batch serve")

    # (c) the lockstep pump over the same replicas and requests
    lock_gw = Gateway(engines, GatewayConfig(
        router_policy=GATEWAY23["router"], concurrent_pump=False),
        admission=dataclasses.replace(gw.admission.cfg))
    copies = _copies([s.request for s in streams])
    t0 = time.perf_counter()
    lock_streams = asyncio.run(lock_gw.replay(copies))
    torch.cuda.synchronize()
    c_wall = time.perf_counter() - t0
    c_text, c_tok_s, c_ttft = _gateway_summary(lock_gw, lock_streams, c_wall,
                                               t0)
    same = [s.token_values for s in lock_streams] == want_tokens
    print(f"[gateway] (c) lockstep pump, 2 replicas: {c_text}; tokens "
          + ("equal (b)" if same else "differ from (b)"), flush=True)
    print(f"[gateway] concurrent vs lockstep: {tok_s:.1f} vs {c_tok_s:.1f} "
          f"tok/s, TTFT p50 {ttft:.3f} vs {c_ttft:.3f}s (printed, not "
          "gated)", flush=True)
    if not same:
        fail("phase 23 (c): the lockstep pump's tokens differ from (b)")
    del a, engines, gw, lock_gw
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- phase 24

MOE_ARCH = "granite-moe-3b-a800m"
MOE_LAYERS = 8                          # of 32: the script's time ceiling
MOE_LAYER_TOKENS = 64                   # (a): one MoE layer's tokens
MOE_F32_REL = 1e-3                      # (b): f32 kernel vs plain logits
MOE_SERVE_ROWS = ("paged_attention", "flash_prefill_prefix",
                  "fused_rmsnorm")
MOE_DENSE_REQUESTS = 8                  # (e): a cut of phase 16's 12


def _top_margin(logits, k: int) -> float:
    """The smallest gap between consecutive values among each row's k + 1
    largest router logits: the order of the top k and the k-th / (k+1)-th
    boundary, which decide the expert choices and their flat order."""
    top = logits.float().topk(k + 1, dim=-1).values
    return (top[..., :-1] - top[..., 1:]).min().item()


def moe_layer_check(torch, dev, cfg):
    """Phase 24 (a): one full-width MoE layer in float32 (a float32 router
    over 40 experts of 1536 x 512, top 8, capacity factor 1.25, one
    group), drawn from a seed on the CPU, over 64 tokens on the card and on
    the CPU.  The router logits' top-9 margin must exceed four times their
    largest card-vs-CPU difference; then the expert choices and the
    kept/dropped masks must be equal exactly and the outputs within 1e-5
    of the CPU's largest |y|.  Returns the drop count."""
    from repro_torch.models import layers as L
    c32 = cfg.scaled(param_dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 24)
    p_cpu = L.init_moe(c32, gen, torch.float32)
    x_cpu = torch.randn((1, MOE_LAYER_TOKENS, cfg.d_model), generator=gen)
    p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
    taps = []

    def tap(shape, idx, keep):
        taps.append((idx.cpu(), keep.cpu()))
    y_cpu, aux_cpu = L.apply_moe(c32, p_cpu, x_cpu, tap=tap)
    y_dev, aux_dev = L.apply_moe(c32, p_dev, x_cpu.to(dev), tap=tap)
    torch.cuda.synchronize()
    lg_cpu = x_cpu @ p_cpu["router"]
    lg_dev = (x_cpu.to(dev) @ p_dev["router"]).cpu()
    delta = (lg_cpu - lg_dev).abs().max().item()
    margin = _top_margin(lg_cpu, cfg.top_k)
    (i_cpu, k_cpu), (i_dev, k_dev) = taps
    cap = L.moe_capacity(c32, MOE_LAYER_TOKENS)
    dropped = int((~k_cpu).sum())
    err = (y_dev.cpu() - y_cpu).abs().max().item()
    scale = max(1.0, y_cpu.abs().max().item())
    print(f"[moe] (a) one full-width MoE layer f32, {MOE_LAYER_TOKENS} "
          f"tokens, E {cfg.num_experts} top {cfg.top_k} capacity {cap}: "
          f"router top-{cfg.top_k + 1} margin {margin:.3g} vs card-CPU "
          f"logit diff {delta:.3g}; {dropped}/{k_cpu.numel()} assignments "
          f"dropped; choices "
          f"{'equal' if torch.equal(i_cpu, i_dev) else 'DIFFER'}, kept "
          f"masks {'equal' if torch.equal(k_cpu, k_dev) else 'DIFFER'}; "
          f"max |dy| {err:.3g} (|y| up to {scale:.3g}); aux "
          f"{aux_dev.item():.6f} vs {aux_cpu.item():.6f}", flush=True)
    if not margin > 4 * delta:
        fail(f"phase 24 (a): router margin {margin} not above 4 x the "
             f"card-vs-CPU logit difference {delta}: a tie decides")
    if not (torch.equal(i_cpu, i_dev) and torch.equal(k_cpu, k_dev)):
        fail("phase 24 (a): expert choices or kept masks differ card vs CPU")
    if not err <= 1e-5 * scale:
        fail(f"phase 24 (a): outputs differ by {err} (> 1e-5 x {scale})")
    return dropped


def moe_reference_check(torch, model, params):
    """Phase 24 (b): the model's kernel path against its plain
    path (``use_kernels=False``, page gather, masked chunk attention) on
    phase 4's kind of short request (128 prompt tokens in two full chunks
    of 64, so that no padded row routes, then 4 decode steps, every run fed
    the f32 kernel path's tokens), in float32 (the bf16 weights cast),
    gated at a relative L2 of 1e-3 with equal
    greedy tokens, and
    in bf16 beside it (printed).  Each run's routing decisions (every
    call's set of K experts per token) are recorded through
    ``Model.moe_tap`` and the count of (token, k) choices that differ
    between two runs, as sets, is printed.  Two witnesses stand beside the
    bf16 line: the bf16 plain path against the f32 plain path (no kernel
    in either: what bf16 rounding alone does to the routing and the
    logits), and the bf16 kernel path with every router call's output
    replaced by the bf16 plain path's (routing fixed), gated within
    granite's 0.05 of the bf16 plain path."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.utils import tree_map
    rng = np.random.default_rng(SEED + 3)
    prompt = rng.integers(2, model.cfg.vocab_size, 128).tolist()
    m32 = Model(model.cfg.scaled(param_dtype="float32"),
                chunk_attn_impl="flash", kv_dtype="float32",
                device=model.device)
    p32 = tree_map(lambda t: t.float(), params)
    real_route = L._route
    routes = []

    def run(m, p, impl, toks, route=None):
        """(logits, tokens fed, routing decisions) of one run; ``route``
        stands in for ``layers._route`` during it."""
        seen = []
        m.moe_tap = lambda shape, idx, keep: seen.append(idx.sort(-1).values)
        L._route = route or real_route
        try:
            out, fed = _request_logits(torch, m, p, prompt, impl, toks)
        finally:
            m.moe_tap, L._route = None, real_route
        if not torch.isfinite(out).all():
            fail(f"phase 24 (b): non-finite {impl} logits")
        return out, fed, seen

    def record(cfg, p, xf):
        routes.append(real_route(cfg, p, xf))
        return routes[-1]

    def compare(what, a, b):
        (x, _, cx), (y, _, cy) = a, b
        flips = sum(int((u != w).sum()) for u, w in zip(cx, cy))
        n = sum(u.numel() for u in cx)
        rel = ((x - y).norm() / y.norm()).item()
        agree = (x.argmax(-1) == y.argmax(-1)).float().mean().item()
        print(f"[moe] (b) {MOE_ARCH} full width, {MOE_LAYERS} layers, {what},"
              f" 6 logit rows: "
              f"rel_l2={rel:.4g} argmax_agree={agree:.2f}; routing decisions "
              f"differing {flips}/{n}", flush=True)
        return rel, agree, flips
    k32 = run(m32, p32, "kernel", None)
    toks = k32[1]
    g32 = run(m32, p32, "gather", toks)
    res = {"f32": compare("f32, kernel vs plain path", k32, g32)}
    del m32, p32
    free_memory(torch)
    k16 = run(model, params, "kernel", toks)
    g16 = run(model, params, "gather", toks, route=record)
    res["bf16"] = compare("bf16, kernel vs plain path", k16, g16)
    res["bf16_plain_vs_f32"] = compare(
        "witness 1: bf16 plain vs f32 plain path", g16, g32)
    replay = iter(routes)
    fixed = run(model, params, "kernel", toks,
                route=lambda cfg, p, xf: next(replay))
    res["bf16_fixed_routing"] = compare(
        "witness 2: bf16 kernel path on the plain path's routing vs plain",
        fixed, g16)
    rel, agree, flips = res["f32"]
    if not (rel < MOE_F32_REL and agree == 1.0):
        fail(f"phase 24 (b): f32 kernel-path logits differ (rel_l2 {rel}, "
             f"argmax agree {agree}, {flips} routing decisions differ)")
    rel = res["bf16_fixed_routing"][0]
    if not rel < 0.05:
        fail(f"phase 24 (b): with the routing fixed the bf16 kernel path is "
             f"{rel} from the plain path (>= 0.05)")
    return res


def _moe_engine(model, params, *, graphs=True, **kw):
    """Phase 5's engine configuration (paged, chunks of 256, 8 lanes,
    kernels, unquantized swaps, warmed), with ``kw`` over it (phase 26:
    ``serve``'s dense engine, whole prompts, INT8 swaps)."""
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    opts = dict(max_slots=8, max_seq_len=2048, max_new_tokens=64,
                strategy="alise", quantize_offload=False, kv_backend="paged",
                page_size=16, paged_attn_impl="kernel", prefill_chunk=256,
                warmup_compile=True, cuda_graphs=graphs, seed=SEED)
    opts.update(kw)
    return ServingEngine(model, params, EngineConfig(**opts),
                         predictor=OraclePredictor())


def _moe_summary(eng, reqs, wall, first) -> str:
    gen = sum(r.generated for r in reqs)
    step_ms = [dt * 1e3 for *_, dt in eng.iter_times]
    chunk_ms = [dt * 1e3 for _, _, dt, _ in eng.prefill_times]
    return (f"{sum(r.finish_time is not None for r in reqs)}/{len(reqs)} "
            f"finished, {gen} tokens, {gen / wall:.1f} tok/s, wall "
            f"{wall:.2f}s, TTFT p50 {np.median(list(first.values())):.3f}s "
            f"(wall), {len(step_ms)} decode steps p50 "
            f"{np.median(step_ms):.2f} ms, {len(chunk_ms)} prefill chunks "
            f"p50 {np.median(chunk_ms):.2f} ms, preemptions "
            f"{sum(r.preempt_count for r in reqs)}")


def _served(label, model, reqs) -> None:
    if any(r.finish_time is None for r in reqs):
        fail(f"{label}: not every request finished")
    for r in reqs:
        if len(r.output_tokens) != r.generated or r.generated < 1:
            fail(f"{label}: request {r.req_id} produced no tokens")
        if not all(0 <= t < model.cfg.vocab_size for t in r.output_tokens):
            fail(f"{label}: request {r.req_id} emitted an out-of-vocab "
                 "token")


def moe_block_times(torch, model, params, step_ms) -> None:
    """Phase 24 (f), the MoE block alone at the decode step's shape (8
    tokens, capacity 2, one layer's weights): device times (:func:`time_ms`)
    of the whole block, of its routing and dispatch (router, top-k, the
    capacity plan, the scatter into the expert rows) and of its expert
    products (three batched products over 40 x 2 rows), against the step's
    device span ``step_ms`` for its layers; the bytes bound of the block is
    its weights' read (every expert runs)."""
    from repro_torch.models import layers as L
    cfg = model.cfg
    p = params["layers"][0]["ffn"]
    g = torch.Generator(device=model.device).manual_seed(SEED + 25)
    x = torch.randn((8, 1, cfg.d_model), generator=g,
                    device=model.device).to(model.dtype)
    E, K = cfg.num_experts, cfg.top_k
    cap = L.moe_capacity(cfg, 8)

    def route():
        w, idx, aux, e_alloc = L._route(cfg, p, x.reshape(1, 8, -1))
        dest, keep = L._dispatch_plan(idx.reshape(1, -1), e_alloc, cap)
        buf = torch.zeros((1, E * cap + 1, cfg.d_model), dtype=x.dtype,
                          device=x.device)
        xk = x.reshape(1, 8, 1, -1).expand(1, 8, K, -1).reshape(1, 8 * K, -1)
        return buf.scatter_(1, dest[..., None].expand_as(xk), xk)
    buf = torch.randn((1, E, cap, cfg.d_model), generator=g,
                      device=model.device).to(model.dtype)

    def experts():
        h = torch.nn.functional.silu(buf @ p["wg"]) * (buf @ p["wi"])
        return h @ p["wo"]
    whole = time_ms(lambda: L.apply_moe(cfg, p, x))
    r_ms, e_ms = time_ms(route), time_ms(experts)
    w_bytes = nbytes(p["wi"], p["wg"], p["wo"], p["router"])
    b_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    L_ = cfg.num_layers
    print(f"[moe] (f) MoE block at decode (8 tokens, capacity {cap}), one "
          f"layer: {whole:.4f} ms device (bytes bound {b_ms:.4f} ms: "
          f"{w_bytes / 2**20:.0f} MiB of weights, {b_ms / whole:.1%}); "
          f"routing + dispatch {r_ms:.4f} ms, expert products {e_ms:.4f} ms"
          f"; x {L_} layers = {whole * L_:.2f} ms of the graphed step's "
          f"{step_ms:.2f} ms device span ({whole * L_ / step_ms:.1%}; "
          f"routing + dispatch {r_ms * L_ / step_ms:.1%}, expert products "
          f"{e_ms * L_ / step_ms:.1%})", flush=True)


def phase_moe(torch, dev, kernels):
    """Phase 24: granite-moe-3b-a800m at full width and ``MOE_LAYERS`` of
    its 32 layers (random
    weights from a seed, bf16).  (a) one MoE layer card vs CPU; (b) the
    kernel path vs the plain path; then the main path, counted from 0:
    (c) phase 5's 8 requests on a warmed paged engine with graphs, (d) a
    2-lane INT8 swap serve on the paged backend (phase 6's trace), (e) the
    dense backend through ``serve(...)`` (warmed, 8 requests); then (c)'s
    requests again eagerly (bit for bit), and (f) a profile of the graphed
    decode step with the MoE block's share.  (c) and (d) run on a virtual
    clock: the MoE's tokens depend on which requests share a step, so a
    graphed and an eager serve compare only on one schedule.  Returns the
    launch counts of (c)-(e)."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import kv_bytes_per_token
    from repro_torch.launch.serve import build_requests, serve
    from repro_torch.utils import tree_leaves
    from repro_torch.utils.compile_counter import CompileCounter
    clock = Clock(time.perf_counter())
    cfg = get_config(MOE_ARCH).scaled(num_layers=MOE_LAYERS)
    model, params = build(torch, dev, cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    print(f"[model] {MOE_ARCH} full width, {cfg.num_layers} of 32 layers ("
          f"d{cfg.d_model} {cfg.num_heads}/{cfg.num_kv_heads}H hd{cfg.hd} "
          f"{cfg.num_experts} experts top {cfg.top_k} ff{cfg.d_ff} "
          f"V{cfg.vocab_size}), {n_params:,} params bf16 (router f32)",
          flush=True)
    moe_layer_check(torch, dev, cfg)
    moe_reference_check(torch, model, params)
    clock.lap("MoE layer + reference (phase 24 a-b)")

    reset_counts(kernels)
    counter = CompileCounter()
    eng = _moe_engine(model, params)
    reqs = build_requests(cfg, PAGED_SERVE["n_requests"], SEED, "full")
    wall, first = virtual_serve(torch, eng, reqs)
    counts = read_counts(kernels)
    graph_gate("granite-moe paged serve (phase 24 c)", eng, counter, True)
    counter.detach()
    print(f"[moe] (c) paged, chunks of 256, 8 lanes, graphed: "
          f"{_moe_summary(eng, reqs, wall, first)}; launches {counts}",
          flush=True)
    _served("phase 24 (c)", model, reqs)
    for n in MOE_SERVE_ROWS:
        if counts[n] <= 0:
            fail(f"phase 24 (c): kernel {n} never launched")
    costs = dict(eng.latency.bucket_costs or {})
    del eng
    clock.lap("MoE paged serve (phase 24 c)")

    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    swap_reqs = swap_requests(cfg)
    before = read_counts(kernels)
    counter = CompileCounter()
    eng = _moe_engine(model, params, max_slots=2, quantize_offload=True,
                      hbm_bytes=2 * 336 * bpt)
    walls = watch_offloads(torch, eng.kv)
    virtual_serve(torch, eng, swap_reqs, stage=2)
    moved = {n: c - before[n] for n, c in read_counts(kernels).items()}
    graph_gate("granite-moe paged INT8 swap (phase 24 d)", eng, counter,
               True)
    counter.detach()
    pre = sum(r.preempt_count for r in swap_reqs)
    print(f"[moe] (d) 2 lanes, KV budget {2 * 336} tokens, INT8 offload: "
          f"{sum(r.finish_time is not None for r in swap_reqs)}/"
          f"{len(swap_reqs)} finished, preemptions {pre}, "
          f"{offload_summary(walls)}, launches {moved}", flush=True)
    _served("phase 24 (d)", model, swap_reqs)
    if pre <= 0:
        fail("phase 24 (d): no preemption was forced")
    for n in ("kv_quantize_store", "kv_dequantize"):
        if moved[n] <= 0:
            fail(f"phase 24 (d): kernel {n} never launched")
    del eng
    clock.lap("MoE INT8 swap (phase 24 d)")

    before = read_counts(kernels)
    counter = CompileCounter()
    dreqs, deng = serve(**{**DENSE_SERVE, "n_requests": MOE_DENSE_REQUESTS},
                        arch=MOE_ARCH, device=dev,
                        model_and_params=(model, params))
    torch.cuda.synchronize()
    dwall = time.perf_counter() - deng.warm_stats["end"]
    moved = {n: c - before[n] for n, c in read_counts(kernels).items()}
    graph_gate("granite-moe dense serve (phase 24 e)", deng, counter, True)
    counter.detach()
    print(f"[moe] (e) dense KV, whole-prompt chunks, 8 lanes, graphed, "
          f"serve(): {serve_summary(deng, dreqs, dwall)}; launches {moved}",
          flush=True)
    _served("phase 24 (e)", model, dreqs)
    for n in ("flash_prefill_prefix", "fused_rmsnorm"):
        if moved[n] <= 0:
            fail(f"phase 24 (e): kernel {n} never launched")
    del deng
    launches = read_counts(kernels)
    clock.lap("MoE dense serve (phase 24 e)")

    # (c)'s requests again with eager steps: the same schedule (the
    # graphed engine's measured chunk costs, which price the plans' EWT)
    # must give the same tokens; the tap counts the decode steps' drops
    drops = {"n": 0, "dropped": torch.zeros((), dtype=torch.long,
                                             device=dev)}

    def tap(shape, idx, keep):
        if shape[0] == 8 and shape[1] == 1:        # a decode step
            drops["n"] += keep.numel()
            drops["dropped"] += (~keep).sum()
    eng = _moe_engine(model, params, graphs=False)
    eng.latency.bucket_costs = costs
    ereqs = build_requests(cfg, PAGED_SERVE["n_requests"], SEED, "full")
    model.moe_tap = tap
    try:
        ewall, efirst = virtual_serve(torch, eng, ereqs)
    finally:
        model.moe_tap = None
    print(f"[serve-eager] granite-moe paged (phase 24 c), cuda_graphs=False: "
          f"{_moe_summary(eng, ereqs, ewall, efirst)}", flush=True)
    share = int(drops["dropped"]) / max(drops["n"], 1)
    print(f"[moe] decode steps dropped {int(drops['dropped'])} of "
          f"{drops['n']} (token, k) assignments ({share:.1%}; every lane "
          "routes, idle ones too)", flush=True)
    same_tokens("granite-moe paged (phase 24 c)", reqs, ereqs)
    del eng
    clock.lap("MoE eager serve (phase 24 c)")

    ctx = np.linspace(64, 1600, 8).astype(int)
    step = engine_decode(model, params, "paged", True, ctx)
    span = []
    profile_step(torch, "granite-moe engine decode step (graphed, B=8, ctx "
                 "64..1600)", step, n=3, watch=("paged_attention",))
    for _ in range(5):
        b, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        b.record()
        step()
        e.record()
        torch.cuda.synchronize()
        span.append(b.elapsed_time(e))
    moe_block_times(torch, model, params, statistics.median(span))
    del step, model, params
    free_memory(torch)
    clock.lap("MoE profile (phase 24 f)")
    return launches


ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH = "internvl2-2b"
ENCDEC_F32_REL = 1e-3                   # (a): f32 kernel vs plain logits
ENCDEC_SERVE = dict(requests=8, lanes=8, max_seq_len=128, swap_step=8)
VLM_LENGTHS = (1024, 896, 640, 256)     # (c): each row's true patch count
ENCDEC_TRAIN = dict(batch=2, seq=1024, steps=3)


def _encdec_logits(torch, model, params, frames, start, toks=None):
    """(logits (5, V) float32, tokens fed) of one request: ``Model.prefill``
    of ``frames`` (1, T, D) and the 1-token decoder start ``start``, then 4
    dense decode steps over a 1-lane cache of 16 positions fed ``toks``
    (greedy from this run's logits when None)."""
    dev = model.device
    logits, pc = model.prefill(params, {
        "enc_embeds": frames, "tokens": torch.tensor([[start]], device=dev)})
    cache = model.init_cache(1, 16)
    for key in ("k", "v"):
        cache[key][:, :, :1] = pc[key]
    for key in ("xk", "xv"):
        cache[key].copy_(pc[key])
    cache["lengths"].fill_(1)
    rows, fed = [logits[0]], []
    for i in range(4):
        fed.append(int(rows[-1].argmax()) if toks is None else toks[i])
        rows.append(model.decode_step(
            params, cache, torch.tensor([[fed[-1]]], device=dev))[0])
    return torch.stack(rows).float(), fed


def _kernel_vs_plain(torch, label, model, params, frames, start):
    """The kernel path (flash attention in the encoder and the decoder's
    prefill) against the plain path (``use_kernels=False``) of one
    request, both fed the kernel path's greedy tokens.  Returns (rel_l2,
    argmax agreement)."""
    model.use_kernels = True
    a, fed = _encdec_logits(torch, model, params, frames, start)
    model.use_kernels = False
    b, _ = _encdec_logits(torch, model, params, frames, start, fed)
    model.use_kernels = True
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail(f"phase 25 (a) {label}: non-finite logits")
    rel = ((a - b).norm() / b.norm()).item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"[encdec] (a) {ENCDEC_ARCH} {label}, 4096 frames, 5 logit rows: "
          f"kernel vs plain path rel_l2={rel:.4g} argmax_agree={agree:.2f}",
          flush=True)
    return rel, agree


def encdec_reference_check(torch, dev, model, params):
    """Phase 25 (a): the kernel path against the plain path on one request
    of 4096 speech frames drawn from the seed: at full width and 2 + 2
    layers in float32 (relative L2 < 1e-3, equal greedy tokens), then the
    full 24 + 24-layer bf16 ``model`` (relative L2 <= 0.05)."""
    from repro_torch.models.model import Model
    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(SEED + 25)
    frames = torch.randn((1, cfg.cross_kv_len, cfg.d_model), generator=g,
                         device=dev)
    c32 = cfg.scaled(num_layers=2, num_encoder_layers=2,
                     param_dtype="float32")
    m32 = Model(c32, kv_dtype="float32", device=dev)
    p32 = m32.init(torch.Generator(device=dev).manual_seed(SEED))
    rel, agree = _kernel_vs_plain(torch, "f32, 2 + 2 layers", m32, p32,
                                  frames, 5)
    if not (rel < ENCDEC_F32_REL and agree == 1.0):
        fail(f"phase 25 (a): f32 kernel path differs (rel_l2 {rel}, argmax "
             f"agree {agree})")
    del m32, p32
    free_memory(torch)
    rel, _ = _kernel_vs_plain(torch, "bf16, 24 + 24 layers", model, params,
                              frames.to(model.dtype), 5)
    if not rel <= BF16_TOL:
        fail(f"phase 25 (a): bf16 kernel path differs (rel_l2 {rel})")


def _encdec_requests(torch, cfg, dev):
    """(rid, frames (1, 4096, D) bf16, decoder start token, output length
    16..64) of phase 25 (b)'s requests, drawn from the seed."""
    rng = np.random.default_rng(SEED + 25)
    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    return [(rid, torch.randn((1, cfg.cross_kv_len, cfg.d_model),
                              generator=g, device=dev).to(torch.bfloat16),
             int(rng.integers(2, cfg.vocab_size)),
             int(rng.integers(16, 65)))
            for rid in range(ENCDEC_SERVE["requests"])]


def _blob_bytes(blob) -> int:
    """Bytes of an offload blob: INT8 codes with their scales and zeros,
    or a raw tensor."""
    n = 0
    for key, item in blob.items():
        if key == "lengths":
            continue
        kind, payload = item
        parts = payload[:3] if kind == "q8" else (payload,)
        n += sum(t.numel() * t.element_size() for t in parts)
    return n


def measured_offload(torch, offload):
    """``offload()`` (a backend's offload of one request) timed alone: the
    device synchronized before it, its wall in ms (an INT8 offload
    synchronizes its stream before it returns; a raw one copies to the
    host) and the device memory it added at its peak over what was
    allocated before it.  Returns (blob, ms, bytes)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    blob = offload()
    ms = (time.perf_counter() - t0) * 1e3
    return blob, ms, torch.cuda.max_memory_allocated() - base


def watch_offloads(torch, kv) -> list:
    """Make every ``kv.offload`` of an engine's backend a
    :func:`measured_offload`; returns the list each call appends its
    (ms, added bytes, blob bytes) to."""
    log, real = [], kv.offload

    def offload(rid):
        blob, ms, added = measured_offload(torch, lambda: real(rid))
        log.append((ms, added, _blob_bytes(blob)))
        return blob
    kv.offload = offload
    return log


def offload_summary(log) -> str:
    """One phrase on a run's offloads: the first call's wall apart from
    the later ones', and the most device memory one added."""
    if not log:
        return "no offload"
    later = [ms for ms, _, _ in log[1:]]
    return (f"{len(log)} offloads: first {log[0][0]:.2f} ms "
            f"({log[0][2] / 1e6:.2f} MB), later "
            + (f"median {statistics.median(later):.2f} ms (min "
               f"{min(later):.2f}, max {max(later):.2f})" if later else
               "none")
            + f", device memory added at most "
            f"{max(a for _, a, _ in log) / 1e6:.1f} MB")


def encdec_serve(torch, model, params, reqs, graphs: bool):
    """Phase 25 (b)'s serve through a ``DenseKVBackend`` as the reference's
    backend path runs an encoder-decoder (the engine cannot prefill one):
    each request ``Model.prefill``ed alone when a lane is free (its first
    token the prefill's greedy one) and placed by ``write_prefill``, then
    fused decode steps over all lanes (the step graph ``("decode",)``
    when ``graphs``) until every request ends (EOS or its output length);
    at decode step ``swap_step`` the lowest-numbered live request is
    offloaded (k/v as INT8 through ``kv_quantize_store``, xk/xv raw) and
    uploaded (``kv_dequantize``).  Returns ({rid: tokens}, stats)."""
    from repro_torch.serving.kv_cache import DenseKVBackend, KVBackendConfig
    cfg = ENCDEC_SERVE
    kv = DenseKVBackend(model, KVBackendConfig(
        max_slots=cfg["lanes"], max_seq_len=cfg["max_seq_len"],
        max_new_tokens=64, quantize_offload=True, cuda_graphs=graphs,
        seed=SEED))
    B, dev = cfg["lanes"], model.device
    pending = list(reqs)
    out, true_len, ends = {}, {}, {}
    st = dict(prefill_ms=[], decode_ms=[], swap=None)
    step = 0
    t_start = time.perf_counter()
    while pending or any(r is not None for r in kv.slot_req):
        while pending and kv.free_slot() is not None:
            rid, frames, start, n = pending.pop(0)
            t0 = time.perf_counter()
            logits, pc = model.prefill(params, {
                "enc_embeds": frames,
                "tokens": torch.tensor([[start]], device=dev)})
            kv.write_prefill(rid, pc, 1)
            out[rid] = [int(logits[0].argmax())]
            torch.cuda.synchronize()
            st["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
            true_len[rid] = n
            del pc
        if step == cfg["swap_step"]:
            rid = min(r for r in kv.slot_req if r is not None)
            blob, out_ms, added = measured_offload(torch, lambda: kv.offload(rid))
            t1 = time.perf_counter()
            kv.upload(rid, blob)
            torch.cuda.synchronize()
            st["swap"] = dict(
                rid=rid, kinds={k: blob[k][0] for k in ("k", "v", "xk",
                                                        "xv")},
                bytes=_blob_bytes(blob), out_ms=out_ms, out_added=added,
                in_ms=(time.perf_counter() - t1) * 1e3)
            del blob
        toks = np.zeros((B, 1), np.int32)
        active = np.zeros((B,), bool)
        gen, ctx, tl, rids = (np.zeros((B,), np.int32) for _ in range(4))
        for slot, rid in enumerate(kv.slot_req):
            if rid is not None:
                toks[slot, 0], active[slot], rids[slot] = (out[rid][-1], True,
                                                          rid)
                gen[slot] = ctx[slot] = len(out[rid]) + 1
                tl[slot] = true_len[rid]
        t0 = time.perf_counter()
        got, reason = kv.decode(params, toks, active, gen, ctx, tl, rids)
        st["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        for slot, rid in enumerate(list(kv.slot_req)):
            if rid is not None:
                out[rid].append(int(got[slot]))
                if int(reason[slot]):
                    ends[rid] = int(reason[slot])
                    kv.clear(rid)
        step += 1
    st["wall"] = time.perf_counter() - t_start
    st["ends"] = ends
    st["replays"] = kv.graphs.replays["decode"]
    del kv
    torch.cuda.empty_cache()
    return out, st


def encdec_profile(torch, model, params):
    """Phase 25 (b)'s prefill of one request (eager, as the serve runs it)
    and its decode step at full batch (8 lanes at context 64 of
    ``max_seq_len`` 128, every lane's 4096-frame cross cache) as the
    engine calls it, graphed: wall, device span and busy
    (:func:`profile_step`), and the cross-attention alone (the 24 decoder
    layers' ``_apply_cross`` at the step's shape, device time by
    :func:`time_ms`) against that busy time; the step's bytes bound is its
    decoder and head weights plus the lanes' cross caches."""
    from repro_torch.utils import tree_leaves
    cfg = model.cfg
    B, Smax = ENCDEC_SERVE["lanes"], ENCDEC_SERVE["max_seq_len"]
    g = torch.Generator(device=model.device).manual_seed(SEED + 27)
    frames = torch.randn((1, cfg.cross_kv_len, cfg.d_model), generator=g,
                         device=model.device).to(model.dtype)
    start = torch.tensor([[5]], device=model.device)
    profile_step(torch, f"{ENCDEC_ARCH} prefill ({cfg.cross_kv_len} frames "
                 "+ a 1-token decoder start, eager)",
                 lambda: model.prefill(params, {"enc_embeds": frames,
                                                "tokens": start}), n=3,
                 watch=("flash_attn_wgmma",))
    del frames
    step = engine_decode(model, params, "dense", True, np.full(B, 64),
                         max_seq_len=Smax)
    kv = step.kv
    for key in ("xk", "xv"):            # frames' K/V, not zeros
        kv.cache[key].normal_(generator=g)
    busy = profile_step(torch, f"{ENCDEC_ARCH} engine decode step (graphed, "
                        f"B={B}, ctx 64 of {Smax}, cross "
                        f"{cfg.cross_kv_len} frames)", step, n=3)
    marks = []
    for _ in range(5):
        b, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        b.record()
        step()
        e.record()
        marks.append((b, e))
    torch.cuda.synchronize()
    span = statistics.median(b.elapsed_time(e) for b, e in marks)
    x = torch.randn((B, 1, cfg.d_model), generator=g,
                    device=model.device).to(model.dtype)

    def cross():
        for li in range(cfg.num_layers):
            model._apply_cross(params["cross"][li], x, kv.cache["xk"][li],
                               kv.cache["xv"][li])
    with torch.no_grad():
        c_ms = time_ms(cross, iters=3)
    weights = sum(t.numel() * t.element_size() for path, t in
                  tree_leaves({"layers": params["layers"],
                               "cross": params["cross"]})
                  if path[-1] not in ("wk", "wv") or path[0] != "cross")
    weights += nbytes(params["lm_head"], params["final_norm"]["scale"])
    xbytes = nbytes(kv.cache["xk"], kv.cache["xv"])
    b_ms = (weights + xbytes) / HBM_BYTES_PER_S * 1e3
    share = ("busy not measured" if busy is None else
             f"{c_ms / busy:.1%} of the busy {busy:.2f} ms, the rest "
             f"{busy - c_ms:.2f} ms")
    print(f"[encdec] (b) decode step graphed: device span {span:.2f} ms "
          f"against a {b_ms:.3f} ms bytes bound ({weights / 1e9:.2f} GB of "
          f"decoder and head weights + {xbytes / 1e9:.2f} GB of cross cache, "
          f"{b_ms / span:.1%}); cross-attention of {cfg.num_layers} layers "
          f"alone {c_ms:.2f} ms ({share})", flush=True)
    del step, kv
    torch.cuda.empty_cache()


def phase_encdec_serve(torch, model, params, kernels):
    """Phase 25 (b): 8 requests of 4096 frames through 8 lanes of the
    dense backend, graphed, counted from 0 (the flash kernel once per
    encoder layer, bidirectional, and once per decoder layer, causal, for
    each prefill; kv_quantize_store once (K and V) and kv_dequantize
    twice for the swap), then
    the graphed decode step against its eager step at 8 lanes of context
    64 (:func:`graphed_vs_eager_step`); then the profile.
    Returns the graphed serve's launch counts."""
    cfg = model.cfg
    reqs = _encdec_requests(torch, cfg, model.device)
    reset_counts(kernels)
    out, st = encdec_serve(torch, model, params, reqs, graphs=True)
    counts = read_counts(kernels)
    n_req = len(reqs)
    gen = sum(len(t) for t in out.values())
    sw = st["swap"]
    print(f"[encdec] (b) {ENCDEC_ARCH} full width/depth, dense backend, "
          f"{ENCDEC_SERVE['lanes']} lanes, max_seq_len "
          f"{ENCDEC_SERVE['max_seq_len']}, {n_req} requests of "
          f"{cfg.cross_kv_len} frames, graphed: {len(st['ends'])}/{n_req} "
          f"finished, {gen} tokens, {gen / st['wall']:.1f} tok/s, wall "
          f"{st['wall']:.2f}s, prefill ms per request p50 "
          f"{np.median(st['prefill_ms']):.2f} (each: "
          f"{', '.join(f'{t:.1f}' for t in st['prefill_ms'])}), "
          f"{len(st['decode_ms'])} decode steps p50 "
          f"{np.median(st['decode_ms']):.2f} ms ({st['replays']} replays); "
          f"swap of request {sw['rid']} at step {ENCDEC_SERVE['swap_step']}:"
          f" {sw['kinds']}, {sw['bytes'] / 1e6:.1f} MB to the host, out "
          f"{sw['out_ms']:.1f} ms (device memory added "
          f"{sw['out_added'] / 1e6:.1f} MB), in {sw['in_ms']:.1f} ms; launches "
          f"{counts}", flush=True)
    if len(st["ends"]) != n_req:
        fail("phase 25 (b): not every request finished")
    for rid, toks in out.items():
        if not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"phase 25 (b): request {rid} emitted an out-of-vocab token")
    if sw["kinds"] != {"k": "q8", "v": "q8", "xk": "raw", "xv": "raw"}:
        fail(f"phase 25 (b): swap blob kinds {sw['kinds']}")
    want = n_req * (cfg.num_encoder_layers + cfg.num_layers)
    if counts["flash_prefill"] != want:
        fail(f"phase 25 (b): {counts['flash_prefill']} flash launches, want "
             f"{want} (each prefill's encoder and decoder layers)")
    for n in ("kv_quantize_store", "kv_dequantize"):
        if counts[n] <= 0:
            fail(f"phase 25 (b): kernel {n} never launched")
    if st["replays"] != len(st["decode_ms"]):
        fail(f"phase 25 (b): {len(st['decode_ms'])} decode steps, "
             f"{st['replays']} replays")
    graphed_vs_eager_step(torch, f"{ENCDEC_ARCH} dense (phase 25 b)", model,
                          params, "dense", np.full(ENCDEC_SERVE["lanes"], 64),
                          max_seq_len=ENCDEC_SERVE["max_seq_len"])
    encdec_profile(torch, model, params)
    return counts


def phase_vlm(torch, dev):
    """Phase 25 (c): internvl2-2b at full width and depth fed patch
    embeddings: 4 rows of 1024, drawn from the seed at the embedding
    table's scale and right-padded to ``VLM_LENGTHS`` with ``last_index``;
    ``Model.prefill``'s kernel path (flash, RMSNorm) against its plain
    path, relative L2 <= 0.05; and ``embeds = embed[tokens]`` through the
    kernel path must give the token path's logits and K/V bit for bit."""
    from repro_torch.launch.serve import build_model
    from repro_torch.utils import tree_leaves
    model, params = build_model(VLM_ARCH, "full", dev, None, SEED)
    cfg = model.cfg
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    g = torch.Generator(device=dev).manual_seed(SEED + 28)
    B, S = len(VLM_LENGTHS), max(VLM_LENGTHS)
    embeds = (0.02 * torch.randn((B, S, cfg.d_model), generator=g,
                                 device=dev)).to(model.dtype)
    lens = torch.tensor(VLM_LENGTHS, device=dev)
    embeds[torch.arange(S, device=dev)[None, :] >= lens[:, None]] = 0
    batch = {"embeds": embeds, "last_index": (lens - 1).to(torch.int32)}
    outs = {}
    for use in (True, False):
        model.use_kernels = use
        outs[use], _ = model.prefill(params, batch)
    model.use_kernels = True
    a, b = outs[True], outs[False]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("phase 25 (c): non-finite logits")
    rel = ((a - b).norm() / b.norm()).item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    rng = np.random.default_rng(SEED + 28)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, S))).to(dev)
    lt, ct = model.prefill(params, {"tokens": toks})
    le, ce = model.prefill(params, {"embeds": params["embed"][toks]})
    same = (torch.equal(lt, le) and torch.equal(ct["k"], ce["k"])
            and torch.equal(ct["v"], ce["v"]))
    print(f"[encdec] (c) {VLM_ARCH} full width/depth ({cfg.num_layers}L "
          f"d{cfg.d_model} {cfg.num_heads}/{cfg.num_kv_heads}H hd{cfg.hd} "
          f"V{cfg.vocab_size}), {n_params:,} params bf16, {B} rows of patch "
          f"embeddings (true lengths {VLM_LENGTHS}): kernel vs plain path "
          f"rel_l2={rel:.4g} argmax_agree={agree:.2f}; embeds = "
          f"embed[tokens] vs the token path: "
          + ("logits and K/V equal bit for bit" if same else "DIFFER"),
          flush=True)
    if not rel <= BF16_TOL:
        fail(f"phase 25 (c): kernel path differs (rel_l2 {rel})")
    if not same:
        fail("phase 25 (c): embeds of the embedding rows differ from the "
             "token path")


def phase_encdec_train(torch, dev, kernels):
    """Phase 25 (d): ``launch/train.train`` on seamless at full width and
    depth in float32 (1.63 B parameters: 26.1 GB with gradients and AdamW
    moments), batch 2 x 1024 (the encoder reads the one-hot frames of the
    tokens, as the reference's launcher builds them), 3 steps: every loss
    finite, the flash kernel launched once per layer and step and
    ``FlashPrefill``'s backward (the plain recompute) run as often.
    Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import FlashPrefill
    from repro_torch.launch.train import train
    from repro_torch.utils import tree_leaves
    cfg = ENCDEC_TRAIN
    backward = FlashPrefill.backward
    calls = [0]

    def counted(ctx, grad_out):
        calls[0] += 1
        return backward(ctx, grad_out)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    FlashPrefill.backward = staticmethod(counted)
    t0 = time.perf_counter()
    try:
        state, losses, step_s = train(
            ENCDEC_ARCH, smoke=False, batch_size=cfg["batch"],
            seq_len=cfg["seq"], steps=cfg["steps"], log_every=cfg["steps"],
            device=dev)
    finally:
        FlashPrefill.backward = staticmethod(backward)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for _, p in tree_leaves(state["params"]))
    p50 = float(np.median(step_s))
    toks = cfg["batch"] * cfg["seq"]
    print(f"[train] {ENCDEC_ARCH} full width and depth (24 + 24 layers), "
          f"f32, {n_params:,} params, AdamW, batch {cfg['batch']}x"
          f"{cfg['seq']}: {len(losses)} steps, ms/step p50 {p50 * 1e3:.1f} "
          f"(each: {', '.join(f'{t * 1e3:.1f}' for t in step_s)}), "
          f"{toks / p50:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB "
          f"({peak:,} B), loss first {losses[0]:.4f} last {losses[-1]:.4f}, "
          f"wall {wall:.1f}s with init; flash backward (plain recompute) "
          f"{calls[0]} calls; launches {counts}", flush=True)
    if len(losses) != cfg["steps"] or not all(np.isfinite(losses)):
        fail(f"phase 25 (d): losses {losses}")
    arch = get_config(ENCDEC_ARCH)
    layers = arch.num_encoder_layers + arch.num_layers
    if counts["flash_prefill"] != cfg["steps"] * layers or \
            calls[0] != cfg["steps"] * layers:
        fail(f"phase 25 (d): {counts['flash_prefill']} flash launches and "
             f"{calls[0]} backward calls, want {cfg['steps'] * layers} each")
    del state
    torch.cuda.empty_cache()
    return counts


def phase_encdec(torch, dev, kernels):
    """Phase 25: the encoder-decoder family and the embeds input.
    seamless-m4t-large-v2 at full width and depth (24 + 24 layers, d_model
    1024, 16 heads of 64, d_ff 8192, vocab 256206, LayerNorm, gelu; random
    bf16 weights from the seed): (a) the kernel path against the plain
    path, (b) the dense-backend serve (main path, counted from 0), graphed
    against eager, with its profile; (c) internvl2-2b fed patch embeddings;
    (d) seamless training (main path, counted from 0).  Returns (b)'s and
    (d)'s launch counts, summed."""
    from repro_torch.launch.serve import build_model
    from repro_torch.utils import tree_leaves
    clock = Clock(time.perf_counter())
    model, params = build_model(ENCDEC_ARCH, "full", dev, None, SEED)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    print(f"[model] {ENCDEC_ARCH} full width/depth ({cfg.num_encoder_layers}"
          f" + {cfg.num_layers}L d{cfg.d_model} {cfg.num_heads}/"
          f"{cfg.num_kv_heads}H hd{cfg.hd} ff{cfg.d_ff} V{cfg.vocab_size}, "
          f"cross {cfg.cross_kv_len} frames), {n_params:,} params bf16",
          flush=True)
    with torch.no_grad():
        encdec_reference_check(torch, dev, model, params)
    clock.lap("seamless kernel vs plain (phase 25 a)")
    with torch.no_grad():
        counts = phase_encdec_serve(torch, model, params, kernels)
    clock.lap("seamless dense-backend serve + profile (phase 25 b)")
    del model, params
    free_memory(torch)
    with torch.no_grad():
        phase_vlm(torch, dev)
    torch.cuda.empty_cache()
    clock.lap("internvl2 patch embeddings (phase 25 c)")
    t_counts = phase_encdec_train(torch, dev, kernels)
    clock.lap("seamless training (phase 25 d)")
    return {k: counts[k] + t_counts[k] for k in counts}


HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_LAYERS = 8                       # one 8-layer group of 72
HYBRID_F32_SHARD = (0, 8)               # (a): 2 of 16 experts (45 GB f32)
HYBRID_SHARD = (0, 2)                   # (b)-(c): one of 2 chips' share
HYBRID_PROMPT = 1000                    # (a)-(b): the reference prompt
HYBRID_F32_REL = 1e-3                   # (a): f32 kernel vs plain logits
HYBRID_SERVE = dict(arch=HYBRID_ARCH, arch_size="full", strategy="alise",
                    n_requests=12, max_slots=8, seed=SEED,
                    predictor_kind="oracle", kv_backend="dense",
                    quantize=True, warmup=True, verbose=False)
HYBRID_ROWS = ("flash_prefill", "fused_rmsnorm", "ssd_chunk",
               "kv_quantize_store", "kv_dequantize")
MAMBA_TRAIN = dict(batch=1, seq=1024, steps=3, layers=32)    # of 64


def _hybrid_model(torch, dev, dtype, shard):
    """jamba-1.5-large-398b at full width, one 8-layer group, holding the
    ``shard`` share of every MoE layer's 16 experts, random weights from
    the seed in ``dtype`` (the routers f32), by :func:`build`."""
    from repro_torch.configs import get_config
    from repro_torch.utils import tree_leaves
    cfg = get_config(HYBRID_ARCH).scaled(num_layers=HYBRID_LAYERS,
                                         param_dtype=dtype)
    t0 = time.perf_counter()
    model, params = build(torch, dev, cfg, expert_shard=shard)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_leaves(params))
    nb = sum(t.numel() * t.element_size() for _, t in tree_leaves(params))
    lo, hi = model.experts
    print(f"[model] {HYBRID_ARCH} full width ({HYBRID_LAYERS} of 72 layers: "
          f"7 Mamba + 1 attention, 4 MoE; d{cfg.d_model} {cfg.num_heads}/"
          f"{cfg.num_kv_heads}H hd{cfg.hd} ff{cfg.d_ff} Mamba {cfg.ssm_heads}"
          f"x{cfg.ssm_headdim} N{cfg.ssm_state} V{cfg.vocab_size}), experts "
          f"[{lo}, {hi}) of {cfg.num_experts} held (share {shard[0]} of "
          f"{shard[1]}), {n:,} params {dtype} ({nb / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return model, params


def _hybrid_logits(torch, model, params, prompt, toks=None):
    """(logits (5, V) float32, tokens fed) of one request: ``Model.prefill``
    of ``prompt`` (1, S), its cache placed in a 1-lane cache of S + 8
    positions, then 4 dense decode steps fed ``toks`` (greedy from this
    run's logits when None)."""
    logits, pc = model.prefill(params, {"tokens": prompt})
    S = prompt.shape[1]
    cache = model.init_cache(1, S + 8)
    for key in ("k", "v"):
        cache[key][:, :, :S] = pc[key]
    for key in ("conv", "ssm", "lengths"):
        cache[key].copy_(pc[key])
    rows, fed = [logits[0]], []
    for i in range(4):
        fed.append(int(rows[-1].argmax()) if toks is None else toks[i])
        rows.append(model.decode_step(
            params, cache, torch.tensor([[fed[-1]]], device=model.device))[0])
    return torch.stack(rows).float(), fed


def hybrid_kernel_vs_plain(torch, label, model, params, tol):
    """Phase 26's kernel path (the SSD chunk's tensor-core body through the
    P-128 split, the full-sequence flash kernel, RMSNorm) against the plain
    path (``use_kernels=False``) on one ``HYBRID_PROMPT``-token prompt from
    the seed: prefill logits and 4 decode steps, both fed the kernel
    path's greedy tokens; fails above ``tol`` (relative L2) or, in f32, on
    an argmax that differs.  Every SSD call of the kernel path must take
    the tensor-core body."""
    rng = np.random.default_rng(SEED + 26)
    prompt = torch.tensor(rng.integers(2, model.cfg.vocab_size,
                                       (1, HYBRID_PROMPT)),
                          device=model.device)
    (a, fed), body = ssd_bodies(
        torch, lambda: _hybrid_logits(torch, model, params, prompt))
    model.use_kernels = False
    b, _ = _hybrid_logits(torch, model, params, prompt, fed)
    model.use_kernels = True
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail(f"phase 26 {label}: non-finite logits")
    rel = ((a - b).norm() / b.norm()).item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    n_ssm = sum(model.cfg.layer_kind(i) == "ssm"
                for i in range(model.cfg.num_layers))
    print(f"[hybrid] {label}: {HYBRID_PROMPT}-token prefill + 4 decode "
          f"steps, 5 logit rows: kernel vs plain path rel_l2={rel:.4g} "
          f"argmax_agree={agree:.2f}; SSD bodies {body}", flush=True)
    if body != {"fma": 0, "tf32x3_states": n_ssm, "tf32x3_y": n_ssm}:
        fail(f"phase 26 {label}: the SSD calls did not all take the "
             f"tensor-core body ({body})")
    f32 = model.dtype == torch.float32
    if not (rel <= tol and (agree == 1.0 or not f32)):
        fail(f"phase 26 {label}: kernel path differs (rel_l2 {rel}, argmax "
             f"agree {agree})")


def hybrid_swap(torch, model, params, kv):
    """One lane's INT8 swap on the serve's dense backend: a
    ``HYBRID_PROMPT``-token prefill placed by ``write_prefill``, offloaded
    (K/V as INT8 through ``kv_quantize_store``, conv and SSM state raw) and
    uploaded (``kv_dequantize``) into another lane: conv and SSM state
    bit for bit, K/V within phase 3's INT8 round-trip bound, the length
    kept.  Prints the bytes and times."""
    rng = np.random.default_rng(SEED + 27)
    prompt = torch.tensor(rng.integers(2, model.cfg.vocab_size,
                                       (1, HYBRID_PROMPT)),
                          device=model.device)
    _, pc = model.prefill(params, {"tokens": prompt})
    kv.slot_req[0] = -2                   # the swap lands in another lane
    kv.write_prefill(-1, pc, HYBRID_PROMPT)
    src = kv.slot_of(-1)
    before = {k: kv._lane(k, src).clone() for k in kv.cache if k != "lengths"}
    blob, out_ms, added = measured_offload(torch, lambda: kv.offload(-1))
    t1 = time.perf_counter()
    kv.slot_req[src] = -3
    kv.upload(-1, blob)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dst = kv.slot_of(-1)
    kinds = {k: blob[k][0] for k in ("k", "v", "conv", "ssm")}
    exact = all(torch.equal(kv._lane(k, dst), before[k])
                for k in ("conv", "ssm"))
    err = max(((kv._lane(k, dst)[:, :HYBRID_PROMPT].float()
                - before[k][:, :HYBRID_PROMPT].float()).norm()
               / before[k][:, :HYBRID_PROMPT].float().norm()).item()
              for k in ("k", "v"))
    kept = int(kv.cache["lengths"][dst]) == HYBRID_PROMPT
    print(f"[hybrid] (b) INT8 swap of a {HYBRID_PROMPT}-token lane (lane "
          f"{src} -> {dst}): {kinds}, {_blob_bytes(blob) / 1e6:.1f} MB to the "
          f"host (K/V span {blob['k'][1][3][1]}), out {out_ms:.1f} ms "
          f"(device memory added {added / 1e6:.1f} MB), in "
          f"{(t2 - t1) * 1e3:.1f} ms; conv and SSM state "
          + ("equal bit for bit" if exact else "DIFFER")
          + f", K/V rel_l2 {err:.4g}, length "
          + ("kept" if kept else "LOST"), flush=True)
    if kinds != {"k": "q8", "v": "q8", "conv": "raw", "ssm": "raw"}:
        fail(f"phase 26 (b): swap blob kinds {kinds}")
    if not (exact and kept and err < TIER_Q8_BOUND):
        fail("phase 26 (b): the swap did not restore the lane")
    for rid in (-1, -2, -3):
        kv.clear(rid)
    del pc, before, blob


def phase_hybrid_serve(torch, model, params, kernels):
    """Phase 26 (b): the main path, counted from 0: ``HYBRID_SERVE``'s 12
    requests (prompts 64-1536, outputs 16-64, 8 lanes, so lanes turn over)
    through ``serve(...)`` on the dense backend, warmed, the decode step a
    CUDA graph, each prompt prefilled whole; then one lane's INT8 swap on
    its backend.  Then the graphed decode step against its eager step
    (:func:`graphed_vs_eager_step`).  Returns the main path's launch
    counts."""
    from repro_torch.launch.serve import serve
    from repro_torch.utils.compile_counter import CompileCounter
    reset_counts(kernels)
    counter = CompileCounter()
    reqs, eng = serve(**HYBRID_SERVE, device=model.device,
                      model_and_params=(model, params))
    torch.cuda.synchronize()
    wall = time.perf_counter() - eng.warm_stats["end"]
    graph_gate("jamba dense serve (phase 26 b)", eng, counter, True)
    counter.detach()
    _served("phase 26 (b)", model, reqs)
    pre = [dt * 1e3 for _, _, dt, _ in eng.prefill_times]
    print(f"[hybrid] (b) {HYBRID_ARCH} dense KV and state, 8 lanes, "
          f"graphed, serve(): {serve_summary(eng, reqs, wall)}; prefill ms a "
          f"request {np.mean(pre):.1f} mean over {len(pre)}", flush=True)
    if len(pre) != len(reqs):
        fail(f"phase 26 (b): {len(pre)} prefills for {len(reqs)} requests")
    hybrid_swap(torch, model, params, eng.kv)
    counts = read_counts(kernels)
    print(f"[main-path] {HYBRID_ARCH} serve + swap (phase 26 b) launches "
          f"{counts}", flush=True)
    for n in HYBRID_ROWS:
        if counts[n] <= 0:
            fail(f"phase 26 (b): kernel {n} never launched")
    del eng
    free_memory(torch)
    graphed_vs_eager_step(torch, "jamba dense (phase 26 b)", model, params,
                          "dense", PROFILE_CTX)
    return counts


def hybrid_profile(torch, model, params):
    """Phase 26 (c): the graphed engine decode step at full batch (8 lanes
    at contexts 64..1600) as the engine calls it: wall, device span, busy
    (:func:`profile_step`) against its bytes bound (the weights a step
    reads, every held expert's included, with the lanes' SSM state read
    and written); the device times (:func:`time_ms`) of the 4 MoE blocks,
    the 7 Mamba decode steps and the attention layer's plain decode
    attention at the step's shape, and their shares of the step's span;
    then one 1024-token prefill, whose SSD chunk kernels' share of busy
    the profile names."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.utils import tree_leaves
    cfg = model.cfg
    B = 8
    ctx = np.linspace(64, 1600, B).astype(int)
    step = engine_decode(model, params, "dense", True, ctx)
    busy = profile_step(torch, f"{HYBRID_ARCH} engine decode step (graphed, "
                        f"B={B}, ctx 64..1600)", step, n=3)
    marks = []
    for _ in range(5):
        b, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        b.record()
        step()
        e.record()
        marks.append((b, e))
    torch.cuda.synchronize()
    span = statistics.median(b.elapsed_time(e) for b, e in marks)
    cache = step.kv.cache
    weights = sum(t.numel() * t.element_size()
                  for path, t in tree_leaves(params) if path != ("embed",))
    state = nbytes(cache["ssm"], cache["conv"])
    kvb = int(sum(ctx)) * 2 * cfg.num_kv_heads * cfg.hd * 2
    b_ms = (weights + 2 * state + kvb) / HBM_BYTES_PER_S * 1e3
    g = torch.Generator(device=model.device).manual_seed(SEED + 28)
    x = torch.randn((B, 1, cfg.d_model), generator=g,
                    device=model.device).to(model.dtype)
    layers = params["layers"]
    moe = [i for i in range(cfg.num_layers) if cfg.ffn_kind(i) == "moe"]
    ssm = [i for i in range(cfg.num_layers) if cfg.layer_kind(i) == "ssm"]
    attn = [i for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn"]
    st = {"conv": cache["conv"][0, 0], "ssm": cache["ssm"][0, 0]}
    q = torch.randn((B, cfg.num_heads, cfg.hd), generator=g,
                    device=model.device).to(model.dtype)
    lens = torch.tensor(ctx, dtype=torch.int32, device=model.device)
    with torch.no_grad():
        moe_ms = time_ms(lambda: [L.apply_moe(cfg, layers[i]["ffn"], x,
                                              experts=model.experts)
                                  for i in moe], iters=5)
        ssm_ms = time_ms(lambda: [M.mamba_decode_step(cfg, layers[i]["ssm"],
                                                      x[:, 0], st)
                                  for i in ssm], iters=5)
        att_ms = time_ms(lambda: [L.decode_attention(
            cfg, q, cache["k"][0], cache["v"][0], lens) for _ in attn],
            iters=5)
    del step, cache, st
    torch.cuda.empty_cache()

    def share(ms):
        return f"{ms:.2f} ms ({ms / span:.1%})"
    print(f"[hybrid] (c) decode step graphed: device span {span:.2f} ms, "
          f"busy {'not measured' if busy is None else f'{busy:.2f} ms'}, "
          f"against a {b_ms:.3f} ms bytes bound ({weights / 1e9:.2f} GB of "
          f"weights, every held expert's, + {2 * state / 1e9:.2f} GB of "
          f"Mamba state read and written + {kvb / 1e9:.3f} GB of K/V, "
          f"{b_ms / span:.1%}); {len(moe)} MoE blocks {share(moe_ms)}, "
          f"{len(ssm)} Mamba decode steps {share(ssm_ms)}, the plain decode "
          f"attention {share(att_ms)}", flush=True)
    prompt = torch.full((1, 1024), 7, device=model.device)
    profile_step(torch, f"{HYBRID_ARCH} prefill (kernel, S=1024, eager)",
                 lambda: model.prefill(params, {"tokens": prompt}), n=3,
                 watch=("ssd_",))


def mamba_train_reference(torch, dev, cfg, batch):
    """Phase 26 (d) first: mamba2-2.7b's loss and gradients through the
    kernels (the SSD chunk through ``SsdChunk``, RMSNorm through
    ``FusedRMSNorm``, each with a plain recomputed backward) against
    ``use_kernels=False`` on the same random params and batch, held as
    phase 12 holds granite's (:func:`kernel_vs_plain_grads`); ``SsdChunk``'s
    backward must run once a layer."""
    from repro_torch.kernels.ssd_scan import SsdChunk
    from repro_torch.models.model import Model
    model = Model(cfg, ssd_chunk=min(64, MAMBA_TRAIN["seq"]), remat=False,
                  device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    backward = SsdChunk.backward
    calls = [0]

    def counted(ctx, *grads):
        calls[0] += 1
        return backward(ctx, *grads)
    torch.cuda.reset_peak_memory_stats()
    SsdChunk.backward = staticmethod(counted)
    try:
        r = kernel_vs_plain_grads(torch, "phase 26 (d)", model, params, batch)
    finally:
        SsdChunk.backward = staticmethod(backward)
    peak = torch.cuda.max_memory_allocated()
    print(f"[train-reference] mamba2-2.7b full width, {cfg.num_layers} of "
          f"64 layers, f32, "
          f"{r['params']:,} params, batch {MAMBA_TRAIN['batch']}x"
          f"{MAMBA_TRAIN['seq']}: loss kernel {r['loss'][0]:.6f} plain "
          f"{r['loss'][1]:.6f} (rel {r['rel_loss']:.3g}); {r['leaves']} "
          f"gradient leaves, worst rel_l2 {r['worst']:.3g} at "
          f"{r['worst_at']}; SsdChunk backward {calls[0]} calls; loss+grad "
          f"{r['seconds'][0]:.2f}s kernel path, {r['seconds'][1]:.2f}s plain "
          f"path; peak memory {peak / 2**30:.2f} GiB", flush=True)
    if calls[0] != cfg.num_layers:
        fail(f"phase 26 (d): {calls[0]} SsdChunk backwards, want "
             f"{cfg.num_layers}")
    del params, model
    torch.cuda.empty_cache()


def phase_mamba_train(torch, dev, kernels):
    """Phase 26 (d): mamba2-2.7b trained at full width and 32 of its 64
    layers (f32; all 64: 43.2 GB of weights, gradients and AdamW moments),
    batch
    ``MAMBA_TRAIN``: kernel vs plain loss and gradients
    (:func:`mamba_train_reference`), then ``launch/train.train``'s 3 AdamW
    steps counted from 0: losses finite, the SSD chunk (forward kernel,
    plain recomputed backward) and RMSNorm kernels launched; ms/step,
    tokens/s and peak memory.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.training.data import DataConfig, SyntheticLM
    cfg = get_config("mamba2-2.7b").scaled(param_dtype="float32",
                                           num_layers=MAMBA_TRAIN["layers"])
    batch = next(SyntheticLM(cfg, DataConfig(
        batch_size=MAMBA_TRAIN["batch"], seq_len=MAMBA_TRAIN["seq"]))
        .iterate(device=dev))
    mamba_train_reference(torch, dev, cfg, batch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    state, losses, step_s = train(
        "mamba2-2.7b", smoke=False, batch_size=MAMBA_TRAIN["batch"],
        seq_len=MAMBA_TRAIN["seq"], steps=MAMBA_TRAIN["steps"],
        log_every=MAMBA_TRAIN["steps"], num_layers=MAMBA_TRAIN["layers"],
        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_s))
    toks = MAMBA_TRAIN["batch"] * MAMBA_TRAIN["seq"]
    print(f"[train] mamba2-2.7b full width, {cfg.num_layers} of 64 "
          f"layers, f32, "
          f"AdamW, batch {MAMBA_TRAIN['batch']}x{MAMBA_TRAIN['seq']}: "
          f"{len(losses)} steps, ms/step p50 {p50 * 1e3:.1f} (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in step_s)}), {toks / p50:.0f} "
          f"tokens/s, peak memory {peak / 2**30:.2f} GiB ({peak:,} B), loss "
          f"first {losses[0]:.4f} last {losses[-1]:.4f}, wall {wall:.1f}s "
          f"with init, launches {counts}", flush=True)
    if len(losses) != MAMBA_TRAIN["steps"] or not all(np.isfinite(losses)):
        fail(f"phase 26 (d): losses {losses}")
    chunks = MAMBA_TRAIN["steps"] * cfg.num_layers
    if counts["ssd_chunk"] != chunks or counts["fused_rmsnorm"] <= 0:
        fail(f"phase 26 (d): {counts['ssd_chunk']} SSD launches (want "
             f"{chunks}), {counts['fused_rmsnorm']} RMSNorm launches")
    del state
    torch.cuda.empty_cache()
    return counts


def phase_hybrid(torch, dev, kernels):
    """Phase 26: the hybrid family and the ssm family's training.
    jamba-1.5-large-398b at full width, one 8-layer group, holding a share
    of its experts (the device-local half of the reference's expert
    parallelism; the other chips' shares and their exchange are left
    out): (a) f32, 2 of 16 experts, kernel vs plain path; (b) bf16, 8 of
    16 (25.81 B parameters), kernel vs plain, then the main path (serve +
    an INT8 swap, counted from 0) and graphed == eager on one schedule;
    (c) the decode step's profile; (d) mamba2-2.7b trained at 32 of 64
    layers
    (main path, counted from 0).  Returns (b)'s and (d)'s launch counts,
    summed."""
    clock = Clock(time.perf_counter())
    free_memory(torch)
    print(f"[hybrid] device memory allocated before phase 26: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    with torch.no_grad():
        model, params = _hybrid_model(torch, dev, "float32", HYBRID_F32_SHARD)
        hybrid_kernel_vs_plain(torch, "(a) f32, 2 of 16 experts", model,
                               params, HYBRID_F32_REL)
        del model, params
        free_memory(torch)
        print(f"[hybrid] device memory allocated before (b): "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
        clock.lap("jamba f32 kernel vs plain (phase 26 a)")
        model, params = _hybrid_model(torch, dev, "bfloat16", HYBRID_SHARD)
        hybrid_kernel_vs_plain(torch, "(b) bf16, 8 of 16 experts", model,
                               params, BF16_TOL)
        clock.lap("jamba bf16 init + kernel vs plain (phase 26 b)")
        counts = phase_hybrid_serve(torch, model, params, kernels)
        clock.lap("jamba serve + swap + graphed vs eager (phase 26 b)")
        hybrid_profile(torch, model, params)
        del model, params
        free_memory(torch)
        clock.lap("jamba profile (phase 26 c)")
    t_counts = phase_mamba_train(torch, dev, kernels)
    clock.lap("mamba2-2.7b training (phase 26 d)")
    return {k: counts[k] + t_counts[k] for k in counts}


# ------------------------------------------------------ phases 28 and 29

# phase 28: the three registered configs no earlier phase runs, at full
# width, one at a time; depth cut where the card (80 GB) or the script's
# time asks for it: (config, layers held or None for all)
BIG_ARCHS = (("qwen1.5-32b", 16),         # of 64 (32: 36.8 GB of bf16)
             ("command-r-35b", 20),       # of 40 (all 40: 60.6 GB)
             ("dbrx-132b", 8))            # of 40, all 16 experts: 54.6 GB
BIG_PROMPTS = (1024, 600)                 # (1): two prompts, chunks of 256
BIG_CHUNK = 256
BIG_DECODE = 8                            # (1): decode steps of both lanes
BIG_STEPS = 3                             # (3): graphed vs eager steps
BIG_SERVE = dict(arch_size="full", strategy="alise", n_requests=8,
                 max_slots=8, seed=SEED, predictor_kind="oracle",
                 prefill_chunk=BIG_CHUNK, kv_backend="paged",
                 paged_attn_impl="kernel", chunk_attn="flash", page_size=16,
                 quantize=True, warmup=True, verbose=False)
BIG_ROWS = ("paged_attention", "flash_prefill_prefix", "kv_quantize_store",
            "kv_dequantize")             # and RMSNorm's kernel where RMSNorm
BIG_SWAP_TOKENS = 1000                    # (2): the forced INT8 swap's lane


def _big_logits(torch, model, params, prompts, impl, toks=None):
    """Phase 28 (1)'s run on one path (``impl`` "kernel": the prefix flash
    and paged-attention kernels and, where the config has RMSNorm, its
    kernel; "gather": page gather, masked chunk attention, plain norms) on
    its own 2-lane paged backend: each of ``prompts`` prefilled in chunks of
    ``BIG_CHUNK``, then ``BIG_DECODE`` decode steps of both lanes at once,
    fed ``toks`` (greedy from this path's logits when None).  Returns (the
    2 + 2 * BIG_DECODE logit rows float32, the tokens fed)."""
    from repro_torch.serving.kv_cache import KVBackendConfig, PagedKVBackend
    kernel = impl == "kernel"
    impl0 = model.chunk_attn_impl
    model.chunk_attn_impl = "flash" if kernel else "masked"
    model.use_kernels = kernel
    dev, pg = model.device, 16
    try:
        kv = PagedKVBackend(model, KVBackendConfig(
            max_slots=2, max_seq_len=2048, page_size=pg, attn_impl=impl),
            num_pages=2 * 2048 // pg)
        rows = []
        for rid, p in enumerate(prompts):
            for s in range(0, len(p), BIG_CHUNK):
                last = kv.prefill_chunk(params, rid, p[s:s + BIG_CHUNK], s)
            rows.append(last)
        fed = [[int(r.argmax()) for r in rows] if toks is None else toks[0]]
        for i in range(BIG_DECODE):
            tables = torch.full((2, kv.max_pages_per_seq), kv.scratch_page,
                                dtype=torch.int32)
            pos, wp, wo = [], [], []
            for rid in range(2):
                kv.pool.extend(rid, 1)
                n = kv.pool.lengths[rid] - 1
                pt = kv.pool.page_table[rid]
                tables[rid, :len(pt)] = torch.tensor(pt, dtype=torch.int32)
                pos.append(n)
                wp.append(pt[n // pg])
                wo.append(n % pg)
            logits = model.paged_decode_step(
                params, {"k": kv.pool.k, "v": kv.pool.v},
                torch.tensor(fed[-1], device=dev)[:, None], tables.to(dev),
                torch.tensor(pos, dtype=torch.int32, device=dev),
                torch.tensor(wp, device=dev), torch.tensor(wo, device=dev),
                attn_impl=impl)
            rows.append(logits)
            fed.append(logits.argmax(-1).tolist() if toks is None
                       else toks[i + 1])
    finally:
        model.chunk_attn_impl = impl0
        model.use_kernels = True
    return torch.cat(rows).float(), fed


def big_kernel_vs_plain(torch, model, params) -> float:
    """Phase 28 (1): the kernel path against the plain path on the same
    weights, both fed the kernel path's tokens: relative L2 of all 18
    logit rows within ``BF16_TOL``, the greedy agreement printed.  An MoE
    (dbrx) runs the plain path on the kernel path's routing (every router
    call's output recorded, then replayed), as phase 24 (b) fixes its
    routing, and prints the share of choices the plain router makes
    otherwise."""
    from repro_torch.models import layers as L
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 28)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist()
               for n in BIG_PROMPTS]
    store, flips = [], []
    real = L._route
    try:
        if cfg.has_moe:
            L._route = _record_routes(L, store)
        a, fed = _big_logits(torch, model, params, prompts, "kernel")
        if cfg.has_moe:         # the plain path on the kernel path's routes
            L._route = real
            L._route = _record_routes(L, None, iter(store), flips)
        b, _ = _big_logits(torch, model, params, prompts, "gather", fed)
    finally:
        L._route = real
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail(f"phase 28 {cfg.name}: non-finite logits")
    rel = _rel_l2(torch, a, b)
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    routed = (f"; on the kernel path's routing ({len(store)} router calls; "
              f"the plain router's own choices differ on "
              f"{float(torch.stack(flips).mean()):.2%})" if flips else "")
    print(f"[big] (1) {cfg.name} prompts {BIG_PROMPTS} in chunks of "
          f"{BIG_CHUNK} + {BIG_DECODE} decode steps of both lanes, "
          f"{a.shape[0]} logit rows: kernel vs plain path rel_l2={rel:.4g} "
          f"argmax_agree={agree:.2f}{routed}", flush=True)
    if not rel <= BF16_TOL:
        fail(f"phase 28 {cfg.name}: kernel path is {rel} from the plain path "
             f"(> {BF16_TOL})")
    return rel


def big_swap(torch, model, params, kv) -> None:
    """Phase 28 (2)'s forced INT8 swap on the serve's paged backend: a
    ``BIG_SWAP_TOKENS``-token prompt prefilled in chunks of ``BIG_CHUNK``,
    offloaded (its pages as INT8 through ``kv_quantize_store``) and uploaded
    into fresh pages (``kv_dequantize``): K/V within phase 3's INT8 round
    trip bound, the length kept.  Prints the bytes and times."""
    rng = np.random.default_rng(SEED + 29)
    prompt = rng.integers(2, model.cfg.vocab_size, BIG_SWAP_TOKENS).tolist()
    for s in range(0, len(prompt), BIG_CHUNK):
        kv.prefill_chunk(params, -1, prompt[s:s + BIG_CHUNK], s)
    n = BIG_SWAP_TOKENS

    def rows(pages):
        idx = torch.tensor(pages, dtype=torch.long, device=model.device)
        return {k: getattr(kv.pool, k)[:, idx].flatten(1, 2)[:, :n].float()
                for k in ("k", "v")}
    before = rows(kv.pool.page_table[-1])
    blob, out_ms, added = measured_offload(torch, lambda: kv.offload(-1))
    t1 = time.perf_counter()
    kv.upload(-1, blob)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    after = rows(kv.pool.page_table[-1])
    err = max(_rel_l2(torch, after[k], before[k]) for k in ("k", "v"))
    kinds = {k: blob[k][0] for k in ("k", "v")}
    kept = kv.pool.lengths[-1] == n
    print(f"[big] (2) forced INT8 swap of a {n}-token lane: {kinds}, "
          f"{_blob_bytes(blob) / 1e6:.1f} MB to the host, out "
          f"{out_ms:.1f} ms (device memory added {added / 1e6:.1f} MB), in "
          f"{(t2 - t1) * 1e3:.1f} ms; K/V "
          f"rel_l2 {err:.4g}, length {'kept' if kept else 'LOST'}",
          flush=True)
    if kinds != {"k": "q8", "v": "q8"} or not (kept and err < TIER_Q8_BOUND):
        fail(f"phase 28 {model.cfg.name}: the INT8 swap did not restore "
             f"the lane ({kinds}, rel_l2 {err})")
    kv.clear(-1)
    del before, after, blob


def graphed_vs_eager_step(torch, label, model, params, backend, ctx,
                          steps=BIG_STEPS, spec_k=0,
                          max_seq_len=2048) -> None:
    """A KV backend's fused decode step (with ``spec_k``, its verify-k
    step) as the engine runs it, a CUDA graph replay, against the same
    step function run eagerly on the same staged inputs, bit for bit:
    every lane active, lane i at context ``ctx[i]``, the K/V (and any
    conv, SSM or cross state) drawn from the seed, ``steps`` steps each
    fed the graphed step's tokens (a verify step also ``spec_k`` drafts
    from the seed, its accepted span committed as the engine commits it);
    after each step the step's output (tokens, reasons; a verify's
    samples and accepted counts), and after the last the whole cache (the
    paged pool but its shared scratch page, the target of the capture's
    neutral runs), must be equal.  This is what an eager serve of the same
    requests checked, at a few steps' cost."""
    from repro_torch.serving.kv_cache import (DenseKVBackend,
                                              KVBackendConfig, PagedKVBackend)
    B, pg, dev, K1 = len(ctx), 16, model.device, spec_k + 1
    ctx = np.asarray(ctx, np.int32)
    bcfg = KVBackendConfig(max_slots=B, max_seq_len=max_seq_len,
                           page_size=pg, attn_impl="kernel", eos_token=-1,
                           spec_k=spec_k)
    if backend == "paged":
        kv = PagedKVBackend(model, bcfg, num_pages=B + sum(
            -(-(int(c) + steps * K1) // pg) for c in ctx))
        for i, c in enumerate(ctx):
            kv.pool.allocate(i, int(c))
            kv.slot_req[i] = i
        state = {"k": kv.pool.k, "v": kv.pool.v}
    else:
        kv = DenseKVBackend(model, bcfg)
        state = kv.cache
        if "lengths" in state:
            state["lengths"].copy_(torch.from_numpy(ctx))
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    for t in state.values():
        if t.is_floating_point():
            for row in t:                  # a layer at a time: no big temp
                row.copy_(torch.randn(row.shape, generator=g, device=dev))
    snap = {k: t.clone() for k, t in state.items()}
    rng = np.random.default_rng(SEED + 30)
    kind = "verify" if spec_k else "decode"
    step = getattr(kv, f"_{kind}_step")
    neutral = getattr(kv, f"_neutral_{kind}")
    toks, active = np.full((B, K1), 7, np.int32), np.ones((B,), bool)
    gen, cur = np.zeros((B,), np.int32), ctx.copy()
    lanes = (np.full((B,), 2 ** 31 - 1, np.int32),
             np.arange(B, dtype=np.int32))
    staged, graphed = [], []
    for i in range(steps):
        if spec_k:
            toks[:, 1:] = rng.integers(2, model.cfg.vocab_size, (B, spec_k))
            staged.append(kv._verify_inputs(
                toks, np.full((B,), spec_k, np.int32), active, gen, cur,
                *lanes))
        else:
            staged.append(kv._decode_inputs(toks, active, gen + 1, cur + 1,
                                            *lanes))
        out = kv.graphs.run((kind,), staged[-1],
                            lambda buf: step(params, buf), neutral).cpu()
        graphed.append(out)
        if spec_k:
            n = out[:, K1].numpy().astype(np.int32)
            kv._commit_verify(n, active)
            toks[:, 0] = out.numpy()[np.arange(B), n - 1]
        else:
            n = np.ones((B,), np.int32)
            toks[:, 0] = out[0].numpy()
        gen, cur = gen + n, cur + n
    after = {k: t.clone() for k, t in state.items()}
    for k, t in state.items():
        t.copy_(snap[k])
    del snap
    same = all(torch.equal(step(params, torch.from_numpy(s).to(dev)).cpu(),
                           want) for s, want in zip(staged, graphed))
    if backend == "paged":
        live = torch.tensor([p for p in range(kv.pool.k.shape[1])
                             if p != kv.scratch_page], device=dev)
        differ = [k for k, t in state.items()
                  if not torch.equal(t[:, live], after[k][:, live])]
    else:
        differ = [k for k, t in state.items() if not torch.equal(t, after[k])]
    replays = kv.graphs.replays[kind]
    print(f"[graphs] {label}: graphed {kind} step vs the same step eager, "
          f"{B} lanes at ctx {int(ctx.min())}..{int(ctx.max())}"
          + (f", {spec_k} drafts" if spec_k else "")
          + f", {steps} steps ({replays} replays): outputs "
          f"{'equal' if same else 'DIFFER'}, cache "
          + (f"DIFFERS in {differ}" if differ else "equal bit for bit"),
          flush=True)
    if not same or differ or replays != steps:
        fail(f"{label}: the graphed {kind} step differs from its eager step")
    del kv, state, after


def big_profile(torch, model, params) -> None:
    """Phase 28 (4): one graphed engine decode step at 8 lanes and
    contexts 64..1600 profiled (:func:`profile_step`: wall, span, busy,
    idle, top kernels), against its bytes bound: the weights a step reads
    (the head, never the embedding table's unread rows; a tied head reads
    the table, every expert of an MoE layer) and the lanes' K/V."""
    from repro_torch.utils import tree_leaves
    cfg = model.cfg
    ctx = PROFILE_CTX
    step = engine_decode(model, params, "paged", True, ctx)
    busy = profile_step(torch, f"{cfg.name} engine decode step (graphed, "
                        "B=8, ctx 64..1600)", step, n=3,
                        watch=("paged_attention",))
    weights = sum(t.numel() * t.element_size()
                  for path, t in tree_leaves(params)
                  if path != ("embed",) or cfg.tie_embeddings)
    kvb = int(sum(ctx)) * 2 * cfg.num_layers * cfg.num_kv_heads * cfg.hd * 2
    b_ms = (weights + kvb) / HBM_BYTES_PER_S * 1e3
    print(f"[big] (4) {cfg.name} decode step bound {b_ms:.3f} ms (bytes: "
          f"{weights / 1e9:.2f} GB of weights + {kvb / 1e9:.3f} GB of K/V)"
          + ("" if busy is None else
             f"; busy {busy:.2f} ms = {b_ms / busy:.1%} of the bound"),
          flush=True)
    del step
    free_memory(torch)


def phase_big(torch, dev, kernels):
    """Phase 28: qwen1.5-32b, command-r-35b and dbrx-132b at full width
    (``BIG_ARCHS``' depth), one at a time, random bf16 weights from the
    seed through ``Model.init`` on the card: (1) kernel vs plain path; (2)
    the main path, counted from 0: a graphed ``serve(...)`` of 8 requests
    on the paged backend (chunks of 256, warmed), then one forced INT8
    swap on its backend; (3) the graphed decode step against its eager
    step, bit for bit; (4) one profiled graphed decode step against its
    bound.  Returns the launch counts of (2)-(4), summed over the
    configs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.utils import tree_leaves
    from repro_torch.utils.compile_counter import CompileCounter
    clock = Clock(time.perf_counter())
    free_memory(torch)
    totals = None
    with torch.no_grad():
        for name, layers in BIG_ARCHS:
            full = get_config(name)
            cfg = full if layers is None else full.scaled(num_layers=layers)
            t0 = time.perf_counter()
            model, params = build(torch, dev, cfg)
            torch.cuda.synchronize()
            n = sum(t.numel() for _, t in tree_leaves(params))
            nb = sum(t.numel() * t.element_size()
                     for _, t in tree_leaves(params))
            moe = (f", {cfg.num_experts} experts top {cfg.top_k} (all held)"
                   if cfg.has_moe else "")
            print(f"[model] {name} full width, {cfg.num_layers} of "
                  f"{full.num_layers} layers (d{cfg.d_model} {cfg.num_heads}/"
                  f"{cfg.num_kv_heads}H hd{cfg.hd} ff{cfg.d_ff} V"
                  f"{cfg.vocab_size}, {cfg.norm_type}"
                  f"{', QKV bias' if cfg.qkv_bias else ''}"
                  f"{', tied head' if cfg.tie_embeddings else ''}{moe}), "
                  f"{n:,} params bf16 ({nb / 1e9:.2f} GB), init "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
            big_kernel_vs_plain(torch, model, params)
            clock.lap(f"{name} init + kernel vs plain (phase 28 1)")

            reset_counts(kernels)
            counter = CompileCounter()
            reqs, eng = serve(**BIG_SERVE, arch=name, device=dev,
                              model_and_params=(model, params))
            torch.cuda.synchronize()
            wall = time.perf_counter() - eng.warm_stats["end"]
            graph_gate(f"{name} paged serve (phase 28 2)", eng, counter,
                       True)
            counter.detach()
            _served(f"phase 28 {name}", model, reqs)
            print(f"[big] (2) {name} paged, chunks of {BIG_CHUNK}, 8 lanes, "
                  f"graphed, serve(): {serve_summary(eng, reqs, wall)}",
                  flush=True)
            big_swap(torch, model, params, eng.kv)
            del eng
            free_memory(torch)
            clock.lap(f"{name} serve + INT8 swap (phase 28 2)")
            graphed_vs_eager_step(torch, f"{name} (phase 28 3)", model,
                                  params, "paged", PROFILE_CTX)
            big_profile(torch, model, params)
            counts = read_counts(kernels)
            print(f"[main-path] {name} serve, swap, graphed step and profile "
                  f"(phase 28) launches {counts}", flush=True)
            rows = BIG_ROWS + (("fused_rmsnorm",)
                               if cfg.norm_type == "rmsnorm" else ())
            for k in rows:
                if counts[k] <= 0:
                    fail(f"phase 28 {name}: kernel {k} never launched")
            totals = counts if totals is None else {
                k: totals[k] + counts[k] for k in totals}
            del model, params, reqs
            free_memory(torch)
            clock.lap(f"{name} graphed step + profile (phase 28 3-4)")
    return totals


MOE_TRAIN = dict(ref_layers=8, ref_batch=4, seq=1024, batch=1, steps=3)


def _route_on(torch, real, recorded, flips):
    """A router (``layers._route``'s signature) taking each call's experts
    from ``recorded`` (the top-k choices of another run, in call order) and
    its gate weights and aux term from this call's own router
    probabilities, as ``_route`` computes them, so that gradients reach
    the router; ``flips`` gets the count of (token, k) choices that
    ``real``'s own top-k makes otherwise."""
    it = iter(recorded)

    def route(cfg, p, xf):
        _, own, _, E_alloc = real(cfg, p, xf)
        idx = next(it)
        flips.append((own.sort(-1).values != idx.sort(-1).values).sum())
        probs = torch.softmax(xf.float() @ p["router"], dim=-1)
        w = probs.gather(-1, idx)
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
        lead = tuple(range(idx.dim() - 1))
        first = torch.nn.functional.one_hot(idx[..., 0], E_alloc).float()
        aux = cfg.num_experts * (first.mean(dim=lead)
                                 * probs.mean(dim=lead)).sum()
        return w, idx, aux, E_alloc
    return route


def phase_moe_train(torch, dev, kernels):
    """Phase 29: granite-moe-3b-a800m trained on the card in float32.
    First at ``MOE_TRAIN``'s 8 of 32 layers, batch 4 x 1024: the loss (the
    aux term in it) and every gradient leaf through the kernels (flash
    forward, RMSNorm kernel, plain recomputed backwards) against
    ``use_kernels=False`` (:func:`kernel_vs_plain_grads`: loss 1e-4
    relative, every leaf present, finite, nonzero, rel_l2 1e-3) on one
    routing: the kernel path's router choices, replayed in the plain path
    with its own gate weights (:func:`_route_on`).  Then
    ``launch/train.train`` at all 32 layers (3.30 B parameters: 52.8 GB
    with gradients and AdamW moments), batch 1 x 1024, 3 AdamW steps, the
    main path counted from 0: losses finite, the flash and RMSNorm kernels
    launched; ms/step, tokens/s, peak memory.  Returns the launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.training.data import DataConfig, SyntheticLM
    free_memory(torch)
    T = MOE_TRAIN
    cfg = get_config(MOE_ARCH).scaled(param_dtype="float32",
                                      num_layers=T["ref_layers"])
    # no remat: a recompute would call the recording router again
    model = Model(cfg, attn_chunk=T["seq"] // 2, remat=False, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    batch = next(SyntheticLM(cfg, DataConfig(
        batch_size=T["ref_batch"], seq_len=T["seq"])).iterate(device=dev))
    real, store, flips = L._route, [], []

    def record(cfg_, p, xf):
        out = real(cfg_, p, xf)
        store.append(out[1].detach())
        return out

    def before(use):
        L._route = record if use else _route_on(torch, real, store, flips)
    torch.cuda.reset_peak_memory_stats()
    try:
        r = kernel_vs_plain_grads(torch, "phase 29", model, params, batch,
                                  before=before)
    finally:
        L._route = real
    n = sum(int(t.numel()) for t in store)
    print(f"[train-reference] {MOE_ARCH} full width, {T['ref_layers']} of "
          f"32 layers, f32, {r['params']:,} params, batch {T['ref_batch']}x"
          f"{T['seq']}: loss kernel {r['loss'][0]:.6f} plain "
          f"{r['loss'][1]:.6f} (rel {r['rel_loss']:.3g}, ce "
          f"{r['ce'][0]:.6f}/{r['ce'][1]:.6f}); {r['leaves']} gradient "
          f"leaves, worst rel_l2 {r['worst']:.3g} at {r['worst_at']}; one "
          f"routing ({len(store)} router calls, the plain router's own "
          f"choices differ on {int(sum(flips))}/{n}); loss+grad "
          f"{r['seconds'][0]:.2f}s kernel path, {r['seconds'][1]:.2f}s plain "
          f"path; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model, params, batch, store
    free_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    state, losses, step_s = train(
        MOE_ARCH, smoke=False, batch_size=T["batch"], seq_len=T["seq"],
        steps=T["steps"], log_every=T["steps"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_s))
    toks = T["batch"] * T["seq"]
    print(f"[train] {MOE_ARCH} full width and depth (32 layers, 40 experts "
          f"top 8), f32, AdamW, batch {T['batch']}x{T['seq']}: "
          f"{len(losses)} steps, ms/step p50 {p50 * 1e3:.1f} (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in step_s)}), {toks / p50:.0f} "
          f"tokens/s, peak memory {peak / 2**30:.2f} GiB ({peak:,} B), loss "
          f"first {losses[0]:.4f} last {losses[-1]:.4f}, wall {wall:.1f}s "
          f"with init, launches {counts}", flush=True)
    if len(losses) != T["steps"] or not all(np.isfinite(losses)):
        fail(f"phase 29: losses {losses}")
    for k in ("flash_prefill", "fused_rmsnorm"):
        if counts[k] <= 0:
            fail(f"phase 29: kernel {k} never launched on the training path")
    del state
    free_memory(torch)
    return counts


def mamba_reference_check(torch, model, params):
    """Kernel path vs plain path of the full-width mamba2-2.7b on one
    300-token prompt (one chunk of 256 and a ragged one padded to 256) and
    4 decode steps, all fed the bf16 kernel path's greedy tokens, with the
    weights in bf16 and upcast to f32.  In f32 the two paths must agree to
    a relative L2 below 1e-3 with equal argmax: there the only difference
    is the kernels' summation order.  In bf16 the relative L2 is printed
    beside each bf16 path's distance from the f32 plain path, which is what
    bf16 rounding alone does to this random-weight model over 64 layers."""
    rng = np.random.default_rng(SEED + 7)
    prompt = torch.tensor(rng.integers(2, model.cfg.vocab_size, (1, 300)),
                          device=model.device)
    from repro_torch.utils import tree_map
    p32 = tree_map(lambda t: t.float(), params)
    toks = []

    def run(ps, use):
        model.use_kernels = use
        logits, cache = model.prefill(ps, {"tokens": prompt})
        rows = [logits]
        for i in range(4):
            if len(toks) == i:
                toks.append(int(rows[-1].argmax()))
            t = torch.tensor([[toks[i]]], device=model.device)
            rows.append(model.decode_step(ps, cache, t))
        return torch.cat(rows).float()

    outs = {(dt, use): run(ps, use)
            for dt, ps in (("bf16", params), ("f32", p32))
            for use in (True, False)}
    model.use_kernels = True
    del p32
    if not all(torch.isfinite(o).all() for o in outs.values()):
        fail("mamba reference: non-finite logits")
    if any(tuple(o.shape) != (5, model.cfg.vocab_size) for o in outs.values()):
        fail("mamba reference: logits of the wrong shape")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    def agree(a, b):
        return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    ref = outs[("f32", False)]
    r32, r16 = rel(outs[("f32", True)], ref), rel(outs[("bf16", True)],
                                                   outs[("bf16", False)])
    print(f"[mamba-reference] full-width kernel vs plain path, 300-token "
          f"prefill + 4 decode steps, 5 logit rows: f32 rel_l2={r32:.4g} "
          f"argmax_agree={agree(outs[('f32', True)], ref):.2f}; bf16 "
          f"rel_l2={r16:.4g} argmax_agree="
          f"{agree(outs[('bf16', True)], outs[('bf16', False)]):.2f}; "
          f"bf16 kernel vs f32 plain rel_l2="
          f"{rel(outs[('bf16', True)], ref):.4g}, bf16 plain vs f32 plain "
          f"rel_l2={rel(outs[('bf16', False)], ref):.4g}", flush=True)
    if not (r32 < 1e-3 and agree(outs[("f32", True)], ref) == 1.0):
        fail(f"mamba reference: f32 kernel-path logits differ (rel_l2 {r32})")


def phase_mamba_serve(torch, model, params):
    from repro_torch.launch.serve import serve
    from repro_torch.utils.compile_counter import CompileCounter
    counter = CompileCounter()
    reqs, eng = serve(**MAMBA_SERVE, device=model.device,
                      model_and_params=(model, params))
    torch.cuda.synchronize()
    t0 = eng.warm_stats["end"]          # the serve starts when warmup ends
    wall = time.perf_counter() - t0
    graph_gate("mamba serve (phase 9)", eng, counter, True)
    counter.detach()
    done = [r for r in reqs if r.finish_time is not None]
    gen = sum(r.generated for r in reqs)
    # the engine stamps a token with its iteration's start; all 8 prompts
    # are prefilled in the first iteration, one after another, so each
    # request's first token is measured at the end of its own (single)
    # prefill instead, from the end of the engine's warmup
    ttft = [t1 + dt - t0 for t1, _, dt, _ in eng.prefill_times]
    step_ms = [dt * 1e3 for *_, dt in eng.iter_times]
    batch = [b for _, _, b, _ in eng.iter_times]
    pre_ms = [dt * 1e3 for _, _, dt, _ in eng.prefill_times]
    pre_tok = [n for _, n, _, _ in eng.prefill_times]
    print(f"[mamba-serve] mamba2-2.7b full (64L d2560 80x64 heads N128 "
          f"V50280 bf16) dense state, slots=8: {len(done)}/{len(reqs)} "
          f"finished, {gen} tokens generated, {gen / wall:.1f} tok/s, wall "
          f"{wall:.2f}s, TTFT p50 {np.median(ttft):.3f}s, preemptions "
          f"{sum(r.preempt_count for r in reqs)}, {len(step_ms)} decode steps "
          f"p50 {np.median(step_ms):.2f} ms (mean batch {np.mean(batch):.2f}), "
          f"{len(pre_ms)} prefills p50 {np.median(pre_ms):.2f} ms "
          f"({sum(pre_tok)} tokens, {sum(pre_tok) / sum(pre_ms) * 1e3:.0f} "
          f"tok/s)", flush=True)
    if len(done) != len(reqs):
        fail("mamba serve: not every request finished")
    if len(pre_ms) != len(reqs):
        fail(f"mamba serve: {len(pre_ms)} prefills for {len(reqs)} requests")
    for r in reqs:
        if len(r.output_tokens) != r.generated or r.generated < 1:
            fail(f"mamba serve: request {r.req_id} produced no tokens")
        if not all(0 <= t < model.cfg.vocab_size for t in r.output_tokens):
            fail(f"mamba serve: request {r.req_id} emitted an out-of-vocab "
                 "token")
    return reqs


def _mamba_swap_run(model, params, prompts, outs, staged: bool):
    """Serve on a virtual clock with 2 dense lanes, no early EOS; with
    ``staged`` the first two requests run 5 steps before the rest
    arrive."""
    from repro_torch.core.engine import EngineConfig, ServingEngine
    from repro_torch.core.predictor import OraclePredictor
    from repro_torch.core.request import Request, reset_request_counter
    from repro_torch.utils.compile_counter import CompileCounter
    reset_request_counter()
    reqs = [Request(prompt_len=len(p), arrival_time=0.0, true_out_len=o,
                    prompt_tokens=list(p)) for p, o in zip(prompts, outs)]
    eng = ServingEngine(model, params, EngineConfig(
        max_slots=2, max_seq_len=2048, max_new_tokens=64, strategy="alise",
        quantize_offload=False, kv_backend="dense", eos_token=-1,
        warmup_compile=True), predictor=OraclePredictor())
    counter = CompileCounter()
    t = 0.0
    first = reqs[:2] if staged else reqs
    for r in first:
        eng.submit(r, t)
    for _ in range(5 if staged else 0):
        eng.step(t)
        t += 0.1
    for r in reqs[len(first):]:
        eng.submit(r, t)
    for _ in range(2000):
        if not eng.sched.live:
            break
        eng.step(t)
        t += 0.1
    if eng.sched.live or any(r.finish_time is None for r in reqs):
        fail("mamba swap: engine did not drain")
    if staged:
        graph_gate("mamba swap (phase 10)", eng, counter, False)
    counter.detach()
    return reqs, eng


def phase_mamba_swap(torch, model, params, kernels):
    """Forced state swaps with 2 lanes; returns the launch counts and the
    SSD chunk library's body counters (``ops.body_launches``), both read
    right after the swap run.  Then every preempted request is served alone
    by the same engine configuration (2 lanes, so the decode batch shape is
    the same) and its greedy tokens must be equal bit for bit."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    rng = np.random.default_rng(SEED + 8)
    lens, outs = (300, 520, 90, 140, 200, 64), (40, 40, 6, 6, 6, 6)
    prompts = [rng.integers(2, model.cfg.vocab_size, n).tolist()
               for n in lens]
    before = read_counts(kernels)
    t0 = time.perf_counter()
    reqs, eng = _mamba_swap_run(model, params, prompts, outs, staged=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = read_counts(kernels)
    bodies = ssd_ops.body_launches()
    counts = {n: c - before[n] for n, c in total.items()}
    lane_bytes = sum(t[:, 0].numel() * t.element_size()
                     for k, t in eng.kv.cache.items() if k != "lengths")
    pre = sum(r.preempt_count for r in reqs)
    # one lane's round trip over the host link, timed alone
    rid = -1
    eng.kv.slot_req[0] = rid
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    blob = eng.kv.offload(rid)
    t2 = time.perf_counter()
    eng.kv.upload(rid, blob)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    eng.kv.clear(rid)
    print(f"[mamba-swap] 2 lanes, staged arrivals, raw state offload: "
          f"{sum(r.finish_time is not None for r in reqs)}/{len(reqs)} "
          f"finished in {wall:.2f}s, preemptions {pre}, "
          f"{lane_bytes / 1e6:.1f} MB swapped per preemption (conv + f32 SSM "
          f"state of 64 layers), offload {1e3 * (t2 - t1):.1f} ms / upload "
          f"{1e3 * (t3 - t2):.1f} ms, launches {counts}", flush=True)
    if pre <= 0:
        fail("mamba swap: no preemption was forced")
    victims = [(i, r) for i, r in enumerate(reqs) if r.preempt_count > 0]
    for i, r in victims:
        alone, _ = _mamba_swap_run(model, params, [prompts[i]], [outs[i]],
                                   staged=False)
        if alone[0].preempt_count or alone[0].output_tokens != r.output_tokens:
            fail(f"mamba swap: request {i} ({r.preempt_count} preemptions) "
                 "emitted other greedy tokens than its unpreempted run")
    print(f"[mamba-swap] {len(victims)} preempted requests: greedy tokens "
          "equal to their unpreempted runs, bit for bit", flush=True)
    return total, bodies


def phase_mamba_profile(torch, model, params):
    """Where the time goes in the mamba path's two model steps, kernel and
    plain: a full-batch decode step (8 lanes, every lane active) and one
    1024-token prefill, whose kernel path prints the SSD chunk kernels'
    time and share of device busy (its tensor-core body: the states and
    scores kernel and the y kernel)."""
    B = 8
    cache = model.init_cache(B, 2048)
    dev = model.device
    toks = torch.full((B, 1), 7, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    prompt = torch.full((1, 1024), 7, device=dev)
    for use in (True, False):
        model.use_kernels = use
        path = "kernel" if use else "plain"
        profile_step(torch, f"mamba decode step ({path}, B={B})",
                     lambda: model.decode_step(params, cache, toks, active))
        profile_step(torch, f"mamba prefill ({path}, S=1024)",
                     lambda: model.prefill(params, {"tokens": prompt}), n=3,
                     watch=("ssd_",) if use else ())
    model.use_kernels = True
    del cache
    for graphs in (True, False):
        how = "graphed" if graphs else "eager"
        profile_step(torch, f"mamba engine decode step ({how}, B={B})",
                     engine_decode(model, params, "dense", graphs, [0] * B),
                     n=3)
        torch.cuda.empty_cache()


# ---------------------------------------------------- phases 12 to 14

TRAIN = dict(layers=8, batch=4, seq=1024, steps=3)


def _train_setup(torch, dev):
    """granite-3-8b at full width and 8 of its 40 layers in float32, as
    ``launch/train.py`` builds it for ``seq_len`` 1024 (attention chunks of
    512 for the plain version, no remat), and the first batch of the
    synthetic stream."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.training.data import DataConfig, SyntheticLM
    cfg = get_config("granite-3-8b").scaled(param_dtype="float32",
                                            num_layers=TRAIN["layers"])
    model = Model(cfg, attn_chunk=TRAIN["seq"] // 2, remat=False,
                  device=dev)
    data = SyntheticLM(cfg, DataConfig(batch_size=TRAIN["batch"],
                                       seq_len=TRAIN["seq"]))
    return model, next(data.iterate(device=dev))


def kernel_vs_plain_grads(torch, label, model, params, batch,
                          before=None) -> dict:
    """The loss and gradients of ``model`` on ``batch`` through its kernels
    (forward kernels, plain recomputed backwards) against
    ``use_kernels=False`` (plain versions, autograd throughout) on the same
    ``params``: the loss within 1e-4 relative, every gradient leaf
    present, finite, nonzero and within a relative L2 of 1e-3 (``label``
    names a failure).  A kernel that cut the graph would leave its inputs'
    leaves without gradient or with a wrong one.  ``before(use_kernels)``,
    when given, runs before each path (phase 29 fixes the routing there).
    Returns the losses, ce terms, leaf count, worst leaf and each path's
    seconds."""
    from repro_torch.utils import tree_leaves
    named = [(path, p.requires_grad_(True)) for path, p in
             tree_leaves(params)]
    leaves = [p for _, p in named]
    out = {}
    for use in (True, False):
        model.use_kernels = use
        if before is not None:
            before(use)
        t0 = time.perf_counter()
        loss, parts = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        out[use] = (loss.item(), parts["ce"].item(), grads,
                    time.perf_counter() - t0)
        del loss, parts
    model.use_kernels = True
    (lk, cek, gk, tk), (lp, cep, gp, tp) = out[True], out[False]
    worst, worst_at = -1.0, None
    for (path, _), a, b in zip(named, gk, gp):
        if a is None or b is None:
            fail(f"{label}: no gradient for {path}")
        if not (torch.isfinite(a).all() and a.abs().max().item() > 0):
            fail(f"{label}: gradient of {path} is zero or non-finite")
        rel = ((a - b).norm() / b.norm()).item()
        if rel > worst:
            worst, worst_at = rel, path
    rel_loss = abs(lk - lp) / abs(lp)
    res = dict(loss=(lk, lp), ce=(cek, cep), rel_loss=rel_loss,
               leaves=len(leaves), params=sum(p.numel() for p in leaves),
               worst=worst, worst_at=".".join(map(str, worst_at)),
               seconds=(tk, tp))
    if not rel_loss <= 1e-4:
        fail(f"{label}: loss differs by {rel_loss} relative")
    if not worst <= 1e-3:
        fail(f"{label}: gradient of {worst_at} differs by rel_l2 {worst}")
    return res


def train_reference(torch, dev):
    """The training path's loss and gradients through the kernels (flash
    forward + plain recomputed backward, RMSNorm kernel + plain backward)
    against ``use_kernels=False`` (the plain online-softmax attention and
    plain RMSNorm, autograd throughout) on the same random params and
    batch, held by :func:`kernel_vs_plain_grads`."""
    model, batch = _train_setup(torch, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    r = kernel_vs_plain_grads(torch, "train reference", model, params, batch)
    print(f"[train-reference] granite-3-8b full width, {TRAIN['layers']} "
          f"layers, f32, {r['params']:,} params, batch {TRAIN['batch']}x"
          f"{TRAIN['seq']}: loss kernel {r['loss'][0]:.6f} plain "
          f"{r['loss'][1]:.6f} (rel {r['rel_loss']:.3g}, ce "
          f"{r['ce'][0]:.6f}/{r['ce'][1]:.6f}); {r['leaves']} gradient "
          f"leaves, worst rel_l2 {r['worst']:.3g} at {r['worst_at']}; "
          f"loss+grad {r['seconds'][0]:.2f}s kernel path, "
          f"{r['seconds'][1]:.2f}s plain path (first calls)", flush=True)
    del params
    torch.cuda.empty_cache()


def phase_train(torch, dev, kernels):
    """``launch/train.train`` on the card: full width, depth 8, float32,
    batch 4 x 1024, three AdamW steps (five until phase 30 came).  Every loss finite; the flash and
    RMSNorm kernels must launch.  Returns (state, launch counts)."""
    from repro_torch.launch.train import train
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    state, losses, step_s = train(
        "granite-3-8b", smoke=False, num_layers=TRAIN["layers"],
        batch_size=TRAIN["batch"], seq_len=TRAIN["seq"],
        steps=TRAIN["steps"], log_every=TRAIN["steps"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_s))
    toks = TRAIN["batch"] * TRAIN["seq"]
    print(f"[train] granite-3-8b full width (d4096 32/8H ff12800 V49155), "
          f"{TRAIN['layers']} of 40 layers, f32, AdamW, batch "
          f"{TRAIN['batch']}x{TRAIN['seq']}: {len(losses)} steps, ms/step "
          f"p50 {p50 * 1e3:.1f} (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in step_s)}), "
          f"{toks / p50:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB "
          f"({peak:,} B), loss first {losses[0]:.4f} last {losses[-1]:.4f}, "
          f"wall {wall:.1f}s with init, launches {counts}", flush=True)
    if len(losses) != TRAIN["steps"] or not all(np.isfinite(losses)):
        fail(f"train: losses {losses}")
    for n in ("flash_prefill", "fused_rmsnorm"):
        if counts[n] <= 0:
            fail(f"train: kernel {n} never launched on the training path")
    return state, counts


def _kernels_under(e):
    """(name, microseconds) of the device kernels launched inside a CPU
    event and its children."""
    for k in e.kernels:
        yield k.name, k.duration
    for c in e.cpu_children:
        yield from _kernels_under(c)


def phase_train_profile(torch, dev, state):
    """One training step under ``torch.profiler``: host wall time against
    the device's busy time, and the shares of the flash kernel, the plain
    attention backward (the device time inside the Function's
    ``flash_prefill.backward_plain`` range), the RMSNorm kernel and the
    weight products (gemm kernels outside that range)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step
    model, batch = _train_setup(torch, dev)
    step = make_train_step(model, AdamWConfig())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    events = prof.events()
    busy = flash = norm = gemm = 0.0
    for e in events:
        if _is_kernel(torch, e):
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            name = e.name.lower()
            flash += ms if "flash_attn" in name else 0.0
            norm += ms if "rmsnorm_kernel" in name else 0.0
            gemm += ms if "gemm" in name else 0.0
    back = back_gemm = 0.0
    for e in events:
        if (e.name == "flash_prefill.backward_plain"
                and e.device_type == torch.autograd.DeviceType.CPU):
            for name, us in _kernels_under(e):
                back += us / 1e3
                back_gemm += us / 1e3 if "gemm" in name.lower() else 0.0
    if busy <= 0:
        print(f"[train-profile] one step: wall {wall:.1f} ms; the profiler "
              "saw no device time (device busy not measured)", flush=True)
        return

    def share(ms):
        return f"{ms:.1f} ms ({ms / busy:.1%})"
    weights = gemm - back_gemm
    back_txt = (share(back) if back > 0 else
                "not measured (no kernels under the backward's range)")
    print(f"[train-profile] one step (batch {TRAIN['batch']}x{TRAIN['seq']}, "
          f"{TRAIN['layers']} layers): wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms (idle {max(0.0, 1 - busy / wall):.1%}); flash "
          f"kernel {share(flash)}, plain attention backward {back_txt}, "
          f"RMSNorm kernel {share(norm)}, weight products "
          f"{share(weights)}, other {share(busy - flash - norm - back - weights)}",
          flush=True)


# (a) granite at TRAIN's depth and batch, mamba2 at TRAIN's seq; (b)
# granite at TRAIN's batch and seq
REMAT = dict(mamba_layers=4, mamba_batch=1, deep_layers=20, steps=3)
REMAT_GRAD_REL = 1e-6                   # (a): each leaf, remat vs no remat
CARD_GIB = 79.1                         # the H100's memory as torch sees it


def _remat_pair(torch, dev, kernels, label, model, batch) -> dict:
    """Phase 30 (a) on one model: ``Model.loss`` and ``torch.autograd.grad``
    with remat off, then on, on the same params and batch, after an
    untimed warm run.  The loss must
    be equal bit for bit and every gradient leaf within ``REMAT_GRAD_REL``
    rel_l2; each run's seconds, its peak above the memory it started from
    (the other run's gradients are held there) and its launches, counted
    from 0.  The remat run launches each layer kernel once more a layer
    (its recompute): the flash and SSD kernels twice as often, the RMSNorm
    kernel twice less the final norm."""
    from repro_torch.utils import tree_leaves
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    named = [(path, p.requires_grad_(True))
             for path, p in tree_leaves(params)]
    leaves = [p for _, p in named]
    # a first, untimed run: the card's first products and allocations
    model.remat = False
    loss, _ = model.loss(params, batch)
    torch.autograd.grad(loss, leaves)
    del loss
    runs = {}
    for remat in (False, True):
        model.remat = remat
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        t0 = time.perf_counter()
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[remat] = dict(loss=loss.detach(), grads=grads,
                           s=time.perf_counter() - t0,
                           peak=torch.cuda.max_memory_allocated() - start,
                           launches=read_counts(kernels))
        del loss
    off, on = runs[False], runs[True]
    same, worst, worst_at, differ = 0, 0.0, None, []
    for (path, _), a, b in zip(named, off["grads"], on["grads"]):
        if torch.equal(a, b):
            same += 1
            continue
        differ.append(".".join(map(str, path)))
        rel = ((b - a).norm() / a.norm()).item()
        if not rel <= worst:
            worst, worst_at = rel, ".".join(map(str, path))
    res = dict(loss=off["loss"].item(),
               loss_equal=torch.equal(off["loss"], on["loss"]),
               leaves=len(leaves), same=same, differ=differ, worst=worst,
               worst_at=worst_at, s=(off["s"], on["s"]),
               peak=(off["peak"], on["peak"]),
               launches=(off["launches"], on["launches"]))
    print(f"[remat] {label}: loss {res['loss']:.6f} equal bit for bit "
          f"{res['loss_equal']}; {same} of {len(leaves)} gradient leaves "
          f"equal bit for bit"
          + (f" (not: {', '.join(differ)}; worst rel_l2 {worst:.3g} at "
             f"{worst_at}, gate {REMAT_GRAD_REL})" if differ else "")
          + f"; loss+grad {off['s']:.3f}s without remat, {on['s']:.3f}s "
          f"with ({on['s'] / off['s']:.2f}x); peak above the start "
          f"{off['peak'] / 2**30:.2f} GiB without, {on['peak'] / 2**30:.2f}"
          f" GiB with (saves {(off['peak'] - on['peak']) / 2**30:.2f} GiB); "
          f"launches without {off['launches']}, with {on['launches']}",
          flush=True)
    if not res["loss_equal"]:
        fail(f"phase 30 (a) {label}: the loss differs with remat")
    if not worst <= REMAT_GRAD_REL:
        fail(f"phase 30 (a) {label}: gradient of {worst_at} differs by "
             f"rel_l2 {worst}")
    for k in ("flash_prefill", "ssd_chunk", "fused_rmsnorm"):
        n_off, n_on = off["launches"][k], on["launches"][k]
        want = 2 * n_off - (k == "fused_rmsnorm")
        if n_off and n_on != want:
            fail(f"phase 30 (a) {label}: {k} launched {n_on} times with "
                 f"remat, want {want} (once more a layer than {n_off})")
    del params, named, leaves, runs, off, on
    free_memory(torch)
    return res


def phase_remat(torch, dev, kernels):
    """Phase 30: the reference's layer rematerialisation on the card.
    (a) granite-3-8b at full width and 8 of 40 layers, f32, batch 4 x 1024,
    and mamba2-2.7b at 4 of 64 layers, batch 1 x 1024 (``SsdChunk`` under a
    recompute): :func:`_remat_pair`.  (b) granite-3-8b at 20 of 40 layers,
    f32, 4 x 1024, remat on, ``make_train_step`` with AdamW, 3 steps: every
    loss finite; ms a step, the peak, and the dry run's saved-bytes tally at
    the same depth with remat on and off (the no-remat total must exceed
    the card).  Returns the launch counts of (a)'s remat runs and (b)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import saved_activation_bytes
    from repro_torch.models.model import Model
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    from repro_torch.utils import tree_leaves
    R, T = REMAT, TRAIN
    free_memory(torch)
    totals = {k: 0 for k in kernels}
    model, batch = _train_setup(torch, dev)
    a = _remat_pair(torch, dev, kernels, f"granite-3-8b full width, "
                    f"{T['layers']} of 40 layers, f32, batch {T['batch']}x"
                    f"{T['seq']}", model, batch)
    del model, batch
    cfg = get_config("mamba2-2.7b").scaled(param_dtype="float32",
                                           num_layers=R["mamba_layers"])
    model = Model(cfg, ssd_chunk=min(64, T["seq"]), device=dev)
    batch = next(SyntheticLM(cfg, DataConfig(
        batch_size=R["mamba_batch"], seq_len=T["seq"])).iterate(device=dev))
    am = _remat_pair(torch, dev, kernels, f"mamba2-2.7b full width, "
                     f"{R['mamba_layers']} of 64 layers, f32, batch "
                     f"{R['mamba_batch']}x{T['seq']}", model, batch)
    del model, batch
    for r in (a, am):
        totals = {k: totals[k] + r["launches"][1][k] for k in totals}
    free_memory(torch)

    # (b): the depth that does not fit without remat
    L = R["deep_layers"]
    cfg = get_config("granite-3-8b").scaled(param_dtype="float32",
                                            num_layers=L)
    tally = {remat: saved_activation_bytes(cfg, T["batch"], T["seq"],
                                           remat=remat)
             for remat in (True, False)}
    model = Model(cfg, attn_chunk=T["seq"] // 2, device=dev)
    state = init_train_state(model,
                             torch.Generator(device=dev).manual_seed(SEED))
    held = sum(t.numel() * t.element_size()
               for k in ("params", "m", "v")
               for _, t in tree_leaves(state[k]))
    state_b = held + held // 3          # and the gradients, one more copy
    no_remat = state_b + tally[False]
    step = make_train_step(model, AdamWConfig())
    it = SyntheticLM(cfg, DataConfig(batch_size=T["batch"],
                                     seq_len=T["seq"])).iterate(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    losses, step_s = [], []
    for _ in range(R["steps"]):
        t0 = time.perf_counter()
        state, metrics = step(state, next(it))
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(step_s))
    print(f"[remat] granite-3-8b full width, {L} of 40 layers, f32, AdamW, "
          f"batch {T['batch']}x{T['seq']}, remat on: {len(losses)} steps, "
          f"ms/step p50 {p50 * 1e3:.1f} (each: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in step_s)}), "
          f"{T['batch'] * T['seq'] / p50:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB ({peak:,} B), losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; parameters, gradients "
          f"and moments {state_b / 2**30:.2f} GiB; the dry run's saved-bytes "
          f"tally at the loss {tally[True] / 2**30:.2f} GiB with remat, "
          f"{tally[False] / 2**30:.2f} GiB without (so without remat at "
          f"least {no_remat / 2**30:.2f} GiB, the card {CARD_GIB} GiB); "
          f"launches {counts}", flush=True)
    if len(losses) != R["steps"] or not all(np.isfinite(losses)):
        fail(f"phase 30 (b): losses {losses}")
    if not no_remat > CARD_GIB * 2**30:
        fail(f"phase 30 (b): {L} layers would fit without remat "
             f"({no_remat / 2**30:.2f} GiB)")
    if counts["flash_prefill"] != 2 * L * R["steps"]:
        fail(f"phase 30 (b): {counts['flash_prefill']} flash launches, want "
             f"{2 * L * R['steps']} (forward and recompute)")
    del state, metrics, model, step
    free_memory(torch)
    return {k: totals[k] + counts[k] for k in totals}


def ptxas_report(logs) -> list:
    """One line per kernel entry from ``nvcc -Xptxas -v``'s output: source,
    kernel (demangled by ``c++filt`` where the machine has it), registers,
    static shared memory and spills."""
    rows = []
    for src, log in sorted(logs.items()):
        entry, spill = "?", ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                rows.append([src, entry, line.split(":", 1)[-1].strip(),
                             spill])
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(r[1] for r in rows),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(rows):
        for r, n in zip(rows, names):
            r[1] = n.replace("(anonymous namespace)::", "").split("(")[0]
    return [f"{src}: {entry}: {used}; {spill}"
            for src, entry, used, spill in rows]


# (a) and (b) at 8 layers: at 20 and 16 layers the script took 288.9 s on
# the H100 machine against its 290 s ceiling (the ranks' collectives cross
# the host).  (d) mamba2-2.7b at 4 of 64 layers (8 until (j) came), (e)
# seamless at 8 of 24 encoder and 8 of 24 decoder layers, (f) jamba's one
# 8-layer group holding 4 of 16 experts (2 a rank), each for the same
# ceiling; (f)'s share is what two ranks of jamba's group fit on one card
SHARD27 = dict(granite_layers=8, prompts=2, prompt_len=1024, decode=8,
               moe_layers=8, train_layers=1, train_batch=2, train_seq=1024,
               mamba_layers=4, seamless_layers=8, seamless_frames=4096,
               hybrid_share=(0, 4), mamba_train_layers=2, timeout=900,
               long_share=(0, 8), long_prompt=12288, long_cache=16384,
               uneven_layers=4)
# the parts' meshes (data, model): two ranks on model 2 unless named; (h)
# and (j) three ranks of their own, (c) and (i) two on data 2
SHARD27_MESH = {"c": (2, 1), "g": (1, 2), "h": (1, 3), "i": (2, 1),
                "j": (1, 3)}
SHARD27_ATTN_REL = 1e-5       # (i): the merged attention against one rank
SHARD27_LOSS_REL = 1e-5                  # (c), (g): loss against one rank
SHARD27_GRAD_REL = 1e-4                  # (c), (g): each gradient, moment
SHARD27_NORM_REL = 1e-6                  # (c), (g): the clipped global norm
# (d), (f): a Mamba stack's bf16 logits move as far as 0.06 rel_l2 under
# any change of rounding (one rank's own kernel path against its plain
# path, (d)'s witness, as far as the sharded run), so there the sharded
# run is held to one rank in f32 (SHARD27_F32_REL) and its bf16 error
# from the f32 truth to at most twice one rank's (the bound PR 15 set the
# bf16 flash kernel against SDPA's error)
SHARD27_F32_REL = 1e-3
SHARD27_TRUTH_RATIO = 2.0
SHARD27_MAMBA = ("d", "f")
# the rows whose launches each part must show (row 7's split-row entries
# wherever a Mamba layer's gated norm runs over two ranks)
SHARD27_ROWS = {
    "a": ("flash_prefill", "fused_rmsnorm"),
    "b": ("flash_prefill", "fused_rmsnorm"),
    "c": ("flash_prefill", "fused_rmsnorm"),
    "d": ("fused_rmsnorm", "rmsnorm_sumsq", "rmsnorm_apply", "ssd_chunk"),
    "e": ("flash_prefill",),
    "f": ("flash_prefill", "fused_rmsnorm", "rmsnorm_sumsq",
          "rmsnorm_apply", "ssd_chunk"),
    "g": ("fused_rmsnorm", "rmsnorm_sumsq", "rmsnorm_apply", "ssd_chunk"),
    "h": ("flash_prefill", "fused_rmsnorm"),
    "i": ("ssd_chunk", "fused_rmsnorm"),
    "j": ("fused_rmsnorm", "rmsnorm_sumsq", "rmsnorm_apply", "ssd_chunk")}
# rows a part launches on rank 0 only: (i)'s prefill is rank 0's alone
SHARD27_RANK0_ROWS = {"i": ("ssd_chunk",)}
SHARD27_SERVES = {"a": "granite-3-8b", "b": "granite-moe-3b-a800m",
                  "d": "mamba2-2.7b", "e": "seamless-m4t-large-v2",
                  "f": "jamba-1.5-large-398b"}
# the three ranks' parts: (h) granite padded, (j) mamba2's 80 SSM heads
# as 26, 27 and 27 (in f32, as (d) is gated), each served and trained
SHARD27_THREE = {"h": ("granite-3-8b", "bfloat16"),
                 "j": ("mamba2-2.7b", "float32")}
SHARD27_UNEVEN_HEADS = [26, 27, 27]


def _rel_l2(torch, got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp(min=1e-30))


def _shard27_logits(torch, model, params, batch, forced):
    """f32 logits of ``Model.prefill`` of ``batch`` (``tokens`` (B, S),
    with ``enc_embeds`` for an encoder-decoder) and of one ``decode_step``
    per column of ``forced`` (T, B, 1), teacher-forced, the prefill's
    cache placed in a decode cache of S + T positions (its K/V at the
    first S, the recurrent state and the cross K/V whole); and the wall
    seconds of the prefill and of a decode step."""
    S = batch["tokens"].shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    full = model.decode_cache(cache, S + forced.shape[0])
    del cache
    outs = [logits.float().cpu()]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for t in range(forced.shape[0]):
        outs.append(model.decode_step(params, full, forced[t]).float().cpu())
    torch.cuda.synchronize()
    return outs, t1 - t0, (time.perf_counter() - t2) / forced.shape[0]


def _rel_all(torch, got, want) -> float:
    """rel_l2 of every step's logits taken together."""
    return _rel_l2(torch, torch.cat(got), torch.cat(want))


def _shard27_cfg(part: str, dtype: str = "bfloat16"):
    """Part ``part``'s config: its arch at full width in ``dtype``, depth
    cut as :data:`SHARD27` says."""
    from repro_torch.configs import get_config
    arch = (SHARD27_THREE[part][0] if part in SHARD27_THREE
            else SHARD27_SERVES[part])
    cfg = get_config(arch).scaled(param_dtype=dtype)
    cut = {"a": dict(num_layers=SHARD27["granite_layers"]),
           "h": dict(num_layers=SHARD27["granite_layers"]),
           "j": dict(num_layers=SHARD27["uneven_layers"]),
           "b": dict(num_layers=SHARD27["moe_layers"]),
           "d": dict(num_layers=SHARD27["mamba_layers"]),
           "e": dict(num_layers=SHARD27["seamless_layers"],
                     num_encoder_layers=SHARD27["seamless_layers"]),
           "f": dict(num_layers=HYBRID_LAYERS)}[part]
    return cfg.scaled(**cut)


def _shard27_inputs(torch, dev, cfg, part: str):
    """Part ``part``'s prefill batch and teacher-forced decode tokens (T,
    B, 1), from the seed: 2 prompts of 1024 tokens, jamba's and (j)'s
    one; seamless one request of 4096 frames and a 1-token decoder
    start."""
    rng = np.random.default_rng(SEED + 27)
    T = SHARD27["decode"]
    if cfg.is_encoder_decoder:
        B = 1
        batch = {"enc_embeds": torch.from_numpy(rng.standard_normal(
            (B, SHARD27["seamless_frames"], cfg.d_model)).astype(
                np.float32)).to(dev, getattr(torch, cfg.param_dtype)),
            "tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, 1)).astype(np.int32)).to(dev)}
    else:
        B = 1 if part in "fj" else SHARD27["prompts"]
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, SHARD27["prompt_len"])).astype(
                np.int32)).to(dev)}
    forced = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (T, B, 1)).astype(np.int32)).to(dev)
    return batch, forced


def _heads(cfg, m: int = 2) -> str:
    """What a rank of ``m`` holds of ``cfg``'s heads, for the log: its
    query and KV head slots, as ``sharding.head_layout`` lays them out."""
    from repro_torch.distributed.sharding import head_layout
    out = []
    if cfg.family != "ssm":
        lay = head_layout(cfg, m)
        out.append(f"heads {lay.q_slots}/{lay.kv_slots}"
                   + (f" (each KV head on {lay.rep} ranks)" if lay.rep > 1
                      else ""))
    if cfg.has_ssm:
        from repro_torch.distributed.sharding import even_blocks
        out.append("SSM heads " + "/".join(sorted(
            {str(len(b)) for b in even_blocks(cfg.ssm_heads, m)}))
            + f" of {cfg.ssm_heads}")
    return ", ".join(out) + " a rank"


def _record_routes(L, store, replay=None, flips=None):
    """``layers._route`` recording each call's output in ``store`` or,
    with ``replay`` (an iterator of recorded outputs), returning those
    while the share of its own choices that differ goes to ``flips``."""
    real = L._route

    def route(*args):
        own = real(*args)
        if replay is None:
            store.append(own)
            return own
        routed = next(replay)
        flips.append((own[1] != routed[1]).float().mean())
        return routed
    return route


def _shard27_serve(torch, dev, rank, part, kernels, log,
                   dtype="bfloat16"):
    """Part (a), (b), (d), (e), (h) or (j) on this rank: its arch
    (``SHARD27_SERVES``, ``SHARD27_THREE``) at full width in ``dtype``
    (depth cut by :func:`_shard27_cfg`), mesh data 1 x model 2 unless
    ``SHARD27_MESH`` names another.  Returns the results (the part's wall
    and this rank's SSM heads among them) and the sharded and (rank 0's;
    None on the others) one-rank logits.
    Rank 0 first computes the one-rank logits on the whole weights; each
    rank then keeps its block (``Model.shard``) and runs the sharded
    prefill and decode steps, counted from 0.  An MoE's bf16 rounding
    flips routing decisions between the two (its router's near-ties), and
    a flipped route changes a token's output wholly, so an MoE runs
    sharded on the one-rank run's routing (every ``layers._route`` output
    recorded on rank 0 and sent to rank 1), as phase 24 (b) fixes its
    routing; each replayed call also runs the sharded router on its own
    inputs, and the share of its choices that differ from the recorded
    ones is printed."""
    import torch.distributed as dist
    from repro_torch.distributed.ctx import Mesh
    from repro_torch.launch.dryrun import param_bytes
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.utils import tree_size_bytes
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    real_route = L._route
    cfg = _shard27_cfg(part, dtype)
    shape = SHARD27_MESH.get(part, (1, 2))
    mesh = make_test_mesh(*shape)
    batch, forced = _shard27_inputs(torch, dev, cfg, part)
    one, whole = build(torch, dev, cfg)
    ref = None
    torch.cuda.synchronize()
    marks = {"draw": time.perf_counter() - t_start}
    out = {}
    recorded = [None]
    if rank == 0:
        recorded = []
        L._route = _record_routes(L, recorded)
        try:
            ref, pre_s, dec_s = _shard27_logits(torch, one, whole, batch,
                                                forced)
        finally:
            L._route = real_route
        out["one_prefill_s"], out["one_decode_s"] = pre_s, dec_s
        recorded = [[(w.cpu(), i.cpu(), a.cpu(), e) for w, i, a, e in
                     recorded]]
    if cfg.has_moe:
        dist.broadcast_object_list(recorded, src=0)
    marks["one_rank"] = time.perf_counter() - t_start
    sharded = Model(cfg, chunk_attn_impl="flash", kv_dtype=cfg.param_dtype,
                    mesh=mesh, device=dev)
    params = sharded.shard(whole)
    torch.cuda.synchronize()
    marks["shard"] = time.perf_counter() - t_start
    meta = Model(cfg, device="meta").init(torch.Generator())
    out["weight_bytes"] = tree_size_bytes(params)
    out["dry_weight_bytes"] = param_bytes(
        cfg, meta, "serving", Mesh(("data", "model"), shape,
                                   coords=mesh.coords))[0]
    marks["dry"] = time.perf_counter() - t_start
    del whole, one
    free_memory(torch)
    marks["free"] = time.perf_counter() - t_start
    flips = []
    if cfg.has_moe:                      # on the one-rank routing
        L._route = _record_routes(
            L, None, iter([(w.to(dev), i.to(dev), a.to(dev), e)
                           for w, i, a, e in recorded[0]]), flips)
    reset_counts(kernels)
    try:
        got, pre_s, dec_s = _shard27_logits(torch, sharded, params, batch,
                                            forced)
    finally:
        L._route = real_route
    out["launches"] = read_counts(kernels)
    out["prefill_s"], out["decode_s"] = pre_s, dec_s
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["ssm_heads"] = sharded.ssm_heads
    marks["sharded"] = time.perf_counter() - t_start
    out["wall_s"] = marks["sharded"]
    if rank == 0:
        out["rel_l2"] = [_rel_l2(torch, g, w) for g, w in zip(got, ref)]
        out["greedy_agree"] = float(np.mean(
            [bool(a) for g, w in zip(got, ref)
             for a in (g.argmax(-1) == w.argmax(-1)).tolist()]))
        if flips:
            out["routes_differing"] = float(torch.stack(flips).mean())
    held = (f", experts [{sharded.experts[0]}, {sharded.experts[1]})"
            if cfg.has_moe else "")
    log(f"({part}) {cfg.name} {cfg.num_layers} layers {dtype}"
        + (f" + {cfg.num_encoder_layers} encoder layers"
           if cfg.is_encoder_decoder else "")
        + f", {_heads(cfg, shape[1])}{held}: {out['weight_bytes']:,} "
        f"weight bytes "
        f"(dry run {out['dry_weight_bytes']:,}), prefill {pre_s * 1e3:.1f} "
        f"ms, decode {dec_s * 1e3:.2f} ms a step, peak "
        f"{out['peak_bytes'] / 2 ** 30:.2f} GiB, launches "
        f"{out['launches']}; part {time.perf_counter() - t_start:.1f}s (at "
        f"{', '.join(f'{k} {v:.1f}' for k, v in marks.items())})")
    del sharded, params
    free_memory(torch)
    return out, got, ref


def _shard27_mamba(torch, dev, rank, kernels, log):
    """Part (d): mamba2-2.7b as :func:`_shard27_serve` runs it, in bf16 and
    then in f32 (both runs' launches counted); rank 0 holds the f32
    sharded logits to one rank's (``f32_rel_l2``), measures each bf16
    run's error from one rank's f32 logits, the truth (``truth_err``:
    sharded, one rank), and how far one rank's own bf16 kernel path is
    from its plain path (``witness_rel_l2``: the bf16 spread of the
    stack, whatever the sharding)."""
    from repro_torch.models.model import Model
    out, got16, ref16 = _shard27_serve(torch, dev, rank, "d", kernels, log)
    if rank == 0:    # the witness: one rank's plain path, the same weights
        cfg = _shard27_cfg("d")
        batch, forced = _shard27_inputs(torch, dev, cfg, "d")
        _, whole = build(torch, dev, cfg)
        plain = Model(cfg, kv_dtype=cfg.param_dtype, use_kernels=False,
                      device=dev)
        want, _, _ = _shard27_logits(torch, plain, whole, batch, forced)
        out["witness_rel_l2"] = [_rel_l2(torch, g, w)
                                 for g, w in zip(ref16, want)]
        del whole, plain
        free_memory(torch)
    f32, got32, truth = _shard27_serve(torch, dev, rank, "d", kernels, log,
                                       dtype="float32")
    out["launches"] = {k: n + f32["launches"][k]
                       for k, n in out["launches"].items()}
    out["f32"] = {k: f32[k] for k in ("prefill_s", "decode_s", "peak_bytes",
                                      "weight_bytes", "dry_weight_bytes")
                  if k in f32}
    if rank == 0:
        out["f32"].update(one_prefill_s=f32["one_prefill_s"],
                          one_decode_s=f32["one_decode_s"])
        out["f32_rel_l2"] = f32["rel_l2"]
        out["truth_err"] = [_rel_all(torch, got16, truth),
                            _rel_all(torch, ref16, truth)]
    return out


def _shard27_hybrid(torch, dev, rank, kernels, log):
    """Part (f) on this rank: jamba-1.5-large-398b's one 8-layer group at
    full width, mesh data 1 x model 2 (32/4 attention heads and 64 of 128
    Mamba heads a rank), holding the ``hybrid_share`` of every MoE layer's
    16 experts split over the two ranks (2 each), routing over all 16 (an
    absent expert adds 0): the card does not hold two ranks of the whole
    group.  Each rank draws the group from the seed layer by layer and
    keeps its blocks (``Model.init(..., "serving")``: no rank holds the
    whole group), runs the sharded prefill of one 1024-token prompt and 8
    decode steps, counted from 0, recording every ``layers._route``
    output, and frees its blocks; then rank 0 alone draws the one-rank
    model of the same share and runs the same calls on the sharded run's
    routing (each replayed call's own choices compared), while rank 1
    waits.  A route flipped by bf16 rounding at a near-tie changes a
    token's output wholly, so the comparison holds the two on one
    routing, as (b) does."""
    import torch.distributed as dist
    from repro_torch.distributed.ctx import Mesh
    from repro_torch.launch.dryrun import param_bytes
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.utils import tree_size_bytes
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    real_route = L._route
    cfg = _shard27_cfg("f")
    share = SHARD27["hybrid_share"]
    mesh = make_test_mesh(1, 2)
    batch, forced = _shard27_inputs(torch, dev, cfg, "f")
    sharded = Model(cfg, chunk_attn_impl="flash", kv_dtype=cfg.param_dtype,
                    mesh=mesh, expert_shard=share, device=dev)
    params = sharded.init(torch.Generator(device=dev).manual_seed(SEED),
                          "serving")
    torch.cuda.synchronize()
    marks = {"draw": time.perf_counter() - t_start}
    out = {"weight_bytes": tree_size_bytes(params)}
    meta = Model(cfg, expert_shard=share, device="meta").init(
        torch.Generator())
    out["dry_weight_bytes"] = param_bytes(
        cfg, meta, "serving", Mesh(("data", "model"), (1, 2)))[0]
    recorded = []
    L._route = _record_routes(L, recorded)
    reset_counts(kernels)
    try:
        got, pre_s, dec_s = _shard27_logits(torch, sharded, params, batch,
                                            forced)
    finally:
        L._route = real_route
    out["launches"] = read_counts(kernels)
    out["prefill_s"], out["decode_s"] = pre_s, dec_s
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    held = sharded.experts
    marks["sharded"] = time.perf_counter() - t_start
    del sharded, params
    free_memory(torch)
    if rank == 0:
        torch.cuda.reset_peak_memory_stats(dev)
        one, whole = build(torch, dev, cfg, expert_shard=share)
        flips = []
        L._route = _record_routes(L, None, iter(recorded), flips)
        try:
            ref, one_pre, one_dec = _shard27_logits(torch, one, whole, batch,
                                                    forced)
        finally:
            L._route = real_route
        out["one_prefill_s"], out["one_decode_s"] = one_pre, one_dec
        out["rel_l2"] = [_rel_l2(torch, g, w) for g, w in zip(got, ref)]
        out["greedy_agree"] = float(np.mean(
            [bool(a) for g, w in zip(got, ref)
             for a in (g.argmax(-1) == w.argmax(-1)).tolist()]))
        out["routes_differing"] = float(torch.stack(flips).mean())
        del one, whole
        free_memory(torch)
        marks["one_rank"] = time.perf_counter() - t_start
        # the truth: one rank of the same share in f32, on the same routing
        one, whole = build(torch, dev, cfg.scaled(param_dtype="float32"),
                           expert_shard=share)
        L._route = _record_routes(L, None, iter(recorded), [])
        try:
            truth, _, _ = _shard27_logits(torch, one, whole, batch, forced)
        finally:
            L._route = real_route
        out["one_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["truth_err"] = [_rel_all(torch, got, truth),
                            _rel_all(torch, ref, truth)]
        del one, whole
        free_memory(torch)
        marks["f32_truth"] = time.perf_counter() - t_start
    del recorded
    dist.barrier()                  # the reference's memory is free again
    E = cfg.num_experts
    log(f"(f) {cfg.name} {cfg.num_layers} layers, {_heads(cfg)}, experts "
        f"[{held[0]}, {held[1]}) of the share [{share[0] * E // share[1]}, "
        f"{(share[0] + 1) * E // share[1]}): {out['weight_bytes']:,} weight "
        f"bytes (dry run {out['dry_weight_bytes']:,}), prefill "
        f"{pre_s * 1e3:.1f} ms, decode {dec_s * 1e3:.2f} ms a step, peak "
        f"{out['peak_bytes'] / 2 ** 30:.2f} GiB"
        + (f" (one rank's references, bf16 and the f32 truth, "
           f"{out['one_peak_bytes'] / 2 ** 30:.2f} GiB)" if rank == 0
           else "")
        + f", launches {out['launches']}; part "
        f"{time.perf_counter() - t_start:.1f}s (at "
        f"{', '.join(f'{k} {v:.1f}' for k, v in marks.items())})")
    return out


def _attention_tap(torch, L, mesh, worst):
    """``layers.decode_attention`` that also holds the attention merged
    over ``seq``, in float32 on this rank's query and cache block, to one
    rank's unsplit attention over the ranks' blocks laid side by side
    (gathered over ``data``; the valid counts summed), appending the
    rel_l2 to ``worst`` on rank 0."""
    import torch.distributed as dist
    real = L.decode_attention
    group = mesh.group("data")

    def gathered(t):
        parts = [torch.empty_like(t.cpu()) for _ in range(2)]
        dist.all_gather(parts, t.cpu().contiguous(), group=group)
        return torch.cat(parts, dim=1).to(t.device)

    def tapped(cfg, q, k, v, valid, over=None):
        out = real(cfg, q, k, v, valid, over)
        merged = real(cfg, q.float(), k, v, valid, over)
        n = valid.cpu().clone()
        dist.all_reduce(n, group=group)
        kw, vw = gathered(k), gathered(v)
        if mesh.coord("data") == 0:
            want = real(cfg, q.float(), kw, vw, n.to(q.device))
            worst.append(_rel_l2(torch, merged, want))
        return out
    return tapped


def _shard27_long(torch, dev, rank, kernels, log):
    """Part (i) on this rank: jamba-1.5-large-398b's ``long_500k`` cell,
    its global batch of 1 with the decode cache's positions split over
    ``data`` (mesh data 2 x model 1): the one 8-layer group at full width
    holding ``long_share`` of every MoE layer's 16 experts (routing over
    all 16), the weights whole on each rank.  Rank 0 prefills one
    ``long_prompt``-token prompt on its own (its weights are the one-rank
    model's) and sends the cache to rank 1; each rank keeps its block of
    a ``long_cache``-position decode cache (rank 1's holds every new
    token), and both run 8 teacher-forced decode steps with
    ``seq_split``, the prefill and the steps counted from 0.  Every step's
    merged attention is held to one rank's unsplit attention in float32
    (:func:`_attention_tap`); then rank 0 runs one rank's decode steps on
    the whole cache, rank 1's new K/V rows are held to its bit for bit,
    and the logits' rel_l2 and greedy agreement are printed."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import cache_layouts, shard_leaf
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.utils import tree_size_bytes
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    from repro_torch.configs import get_config
    cfg = get_config(HYBRID_ARCH).scaled(num_layers=HYBRID_LAYERS)
    share, S, Smax = (SHARD27["long_share"], SHARD27["long_prompt"],
                      SHARD27["long_cache"])
    mesh = make_test_mesh(*SHARD27_MESH["i"])
    sharded = Model(cfg, chunk_attn_impl="flash", kv_dtype=cfg.param_dtype,
                    mesh=mesh, expert_shard=share, device=dev)
    params = sharded.init(torch.Generator(device=dev).manual_seed(SEED),
                          "serving")
    one = Model(cfg, chunk_attn_impl="flash", kv_dtype=cfg.param_dtype,
                expert_shard=share, device=dev)
    rng = np.random.default_rng(SEED + 29)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S)).astype(
        np.int32)).to(dev)
    forced = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SHARD27["decode"], 1, 1)).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    marks = {"draw": time.perf_counter() - t_start}
    out = {"weight_bytes": tree_size_bytes(params)}
    reset_counts(kernels)
    box = [None]
    if rank == 0:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = one.prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        box = [{k: t.cpu() for k, t in cache.items()}]
        del cache
    dist.broadcast_object_list(box, src=0, group=mesh.group("data"))
    ref = one.decode_cache({k: t.to(dev) for k, t in box[0].items()}, Smax)
    del box
    specs = cache_layouts(cfg, {k: tuple(t.shape) for k, t in ref.items()},
                          ShapeSpec("long", Smax, 1, "decode"), mesh)
    full = {k: shard_leaf(t, specs[k], mesh) for k, t in ref.items()}
    marks["prefill"] = time.perf_counter() - t_start
    worst, got = [], []
    real_attention = L.decode_attention
    L.decode_attention = _attention_tap(torch, L, mesh, worst)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(forced.shape[0]):
            got.append(sharded.decode_step(params, full, forced[t],
                                           seq_split=True).float().cpu())
        torch.cuda.synchronize()
        out["decode_s"] = (time.perf_counter() - t0) / forced.shape[0]
    finally:
        L.decode_attention = real_attention
    out["launches"] = read_counts(kernels)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    marks["sharded"] = time.perf_counter() - t_start
    # rank 1's block: the new tokens' K/V rows (its positions from Smax/2)
    lo = S - Smax // 2
    rows = [full[k][:, :, lo:lo + forced.shape[0]].cpu() for k in ("k", "v")]
    box = [rows if rank == 1 else None]
    dist.broadcast_object_list(box, src=1, group=mesh.group("data"))
    if rank == 0:
        out["attn_rel"] = worst
        want = [one.decode_step(params, ref, forced[t]).float().cpu()
                for t in range(forced.shape[0])]
        out["rows_equal"] = all(
            torch.equal(r, ref[k][:, :, S:S + forced.shape[0]].cpu())
            for r, k in zip(box[0], ("k", "v")))
        out["rel_l2"] = [_rel_l2(torch, g, w) for g, w in zip(got, want)]
        out["greedy_agree"] = float(np.mean(
            [bool((g.argmax(-1) == w.argmax(-1)).all())
             for g, w in zip(got, want)]))
    del box, full, ref, sharded, one, params
    free_memory(torch)
    dist.barrier()
    log(f"(i) {cfg.name} {cfg.num_layers} layers bf16, data 2 x model 1, "
        f"experts {share[0] * 16 // share[1]}-"
        f"{(share[0] + 1) * 16 // share[1]} of 16, a {S}-token prompt in a "
        f"{Smax}-position cache split at {Smax // 2}: "
        f"{out['weight_bytes']:,} weight bytes, decode "
        f"{out['decode_s'] * 1e3:.2f} ms a step, peak "
        f"{out['peak_bytes'] / 2 ** 30:.2f} GiB, launches {out['launches']}; "
        f"part {time.perf_counter() - t_start:.1f}s (at "
        f"{', '.join(f'{k} {v:.1f}' for k, v in marks.items())})")
    return out


def _shard27_train(torch, dev, rank, part, kernels, log):
    """Part (c), (g), (h) or (j) on this rank, in f32 with AdamW: (c)
    granite-3-8b at full width and ``train_layers`` layers, mesh data 2 x
    model 1 (FSDP), batch 2 x 1024, a row a rank; (g) mamba2-2.7b at full
    width and ``mamba_train_layers`` layers, mesh data 1 x model 2
    (tensor parallelism: 40 of 80 SSM heads a rank, the gated norm's
    statistic summed over the ranks in the forward and its gradient in
    the backward), batch 1 x 1024; (h) granite's padded heads on model 3;
    (j) mamba2 at ``uneven_layers`` layers on model 3, its 80 SSM heads
    as 26, 27 and 27 (padding slots in the layout, none held).  Each rank
    first takes one rank's step on the whole batch and keeps its block
    (by the layouts) of that step's
    gradients and AdamW moments and the step's clipped global norm; then
    each takes the sharded step on its rows, counted from 0, and compares
    its gradient and moment blocks with those (each leaf's squared
    differences and squares summed over the ranks: one rel_l2 per leaf,
    with nothing gathered) and its norm with that norm."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.ctx import HeadSplit
    from repro_torch.distributed.sharding import shard_leaf, spec_at
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import make_train_step
    from repro_torch.utils import tree_leaves, tree_map
    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    arch, layers, shape = {
        "c": ("granite-3-8b", SHARD27["train_layers"],
              (SHARD27["train_batch"], SHARD27["train_seq"])),
        "g": ("mamba2-2.7b", SHARD27["mamba_train_layers"],
              (1, SHARD27["train_seq"])),
        "h": ("granite-3-8b", SHARD27["train_layers"],
              (SHARD27["train_batch"], SHARD27["train_seq"])),
        "j": ("mamba2-2.7b", SHARD27["uneven_layers"],
              (1, SHARD27["train_seq"]))}[part]
    mesh_shape = SHARD27_MESH[part]
    cfg = get_config(arch).scaled(num_layers=layers, param_dtype="float32")
    mesh = make_test_mesh(*mesh_shape)
    rng = np.random.default_rng(SEED + 28)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                                 .astype(np.int32)).to(dev)
             for k in ("tokens", "targets")}
    one = Model(cfg, device=dev)
    whole = one.init(torch.Generator(device=dev).manual_seed(SEED))
    sharded = Model(cfg, mesh=mesh, device=dev)
    specs = sharded.layouts("train")
    torch.cuda.synchronize()
    marks = {"draw": time.perf_counter() - t_start}
    out = {}

    def state_of(params):
        for _, p in tree_leaves(params):
            p.requires_grad_(True)
        return {"params": params, **init_opt_state(params)}
    state = state_of(tree_map(lambda t: t.clone(), whole))
    step = make_train_step(one, AdamWConfig(), keep_grads=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    out["one_step_s"] = time.perf_counter() - t0
    ref_loss, ref_norm = float(m["loss"]), float(m["grad_norm"])
    trees = {"grads": m["grads"], "m": state["m"], "v": state["v"]}
    ref = {(name,) + path: shard_leaf(g, spec_at(specs, path),
                                      mesh).detach().clone()
           for name, tree in trees.items() for path, g in tree_leaves(tree)}
    # the leaves a rank holds by padded units, whole: the sharded step's
    # gathered gradients must be these, with no padding slot
    split = {path: g.detach().clone() for path, g in tree_leaves(m["grads"])
             if part in SHARD27_THREE
             and isinstance(spec_at(specs, path), HeadSplit)}
    del state, m, trees
    marks["one_rank"] = time.perf_counter() - t_start
    state = state_of(sharded.shard(whole, "train"))
    del whole
    free_memory(torch)
    step = make_train_step(sharded, AdamWConfig(), keep_grads=True)
    d, nd = mesh.coord("data"), mesh.sizes["data"]
    rows = {k: v[d * shape[0] // nd:(d + 1) * shape[0] // nd]
            for k, v in batch.items()}
    reset_counts(kernels)
    torch.cuda.synchronize()
    before = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, m = step(state, rows)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    marks["sharded"] = time.perf_counter() - t_start
    out["wall_s"] = marks["sharded"]
    out["launches"] = read_counts(kernels)
    out["loss"], out["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    # the part's peak (the one-rank step's included), and the sharded
    # step's own (remat on since phase 30)
    out["step_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["peak_bytes"] = max(before, out["step_peak_bytes"])
    trees = {"grads": m["grads"], "m": state["m"], "v": state["v"]}
    names, sums = [], []
    for name, tree in trees.items():
        for path, g in tree_leaves(tree):
            want = ref[(name,) + path].double()
            names.append(name)
            sums.append(torch.stack([(g.double() - want).square().sum(),
                                     want.square().sum()]))
    sums = torch.stack(sums).cpu()
    dist.all_reduce(sums)
    if not bool((sums[:, 1] > 0).all()):
        fail(f"phase 27 ({part}): a one-rank gradient or moment leaf is 0")
    rel = (sums[:, 0] / sums[:, 1]).sqrt()
    out["ref_loss"], out["ref_grad_norm"] = ref_loss, ref_norm
    for name in trees:
        out[f"worst_{name}_rel"] = float(max(
            r for n, r in zip(names, rel.tolist()) if n == name))
    out["leaves"] = names.count("grads")
    if split:
        out.update(_padded_slots(torch, mesh, specs, trees, split,
                                 state["params"]))
    log(f"({part}) {arch} {layers} layers f32, data {mesh_shape[0]} x model "
        f"{mesh_shape[1]}: step {out['step_s'] * 1e3:.1f} ms (one rank "
        f"{out['one_step_s'] * 1e3:.1f} ms), loss {out['loss']:.6f}, peak "
        f"{out['peak_bytes'] / 2 ** 30:.2f} GiB, launches "
        f"{out['launches']}; part {time.perf_counter() - t_start:.1f}s (at "
        f"{', '.join(f'{k} {v:.1f}' for k, v in marks.items())})")
    del state, m, trees, sharded, ref
    free_memory(torch)
    return out


def _padded_slots(torch, mesh, specs, trees, whole_grads, params) -> dict:
    """The leaves a rank holds by padded units (attention head slots, an
    uneven ``d_ff``): each rank's stored gradient, moments and weights
    hold its real units only (``HeadSplit.stored``), the ranks' units
    cover each whole unit, and the gradients gathered whole
    (``ctx.gather_full``) have the whole leaf's shape and follow one
    rank's (``whole_grads``): the worst rel_l2 of those."""
    from repro_torch.distributed.ctx import gather_full
    from repro_torch.distributed.sharding import spec_at
    stored_ok, worst = True, 0.0
    for path, want in whole_grads.items():
        spec = spec_at(specs, path)
        n = len(spec.stored(mesh))
        for t in (trees["grads"], trees["m"], trees["v"], params):
            t = spec_at(t, path)
            stored_ok &= t.shape[spec.dim] == n
        units = set()
        for c in range(mesh.sizes["model"]):
            units.update(spec.stored(mesh, (0, c)))
        stored_ok &= units == set(range(spec.width))
        got = gather_full(spec_at(trees["grads"], path), spec,
                          tuple(want.shape), mesh)
        stored_ok &= tuple(got.shape) == tuple(want.shape)
        worst = max(worst, _rel_l2(torch, got, want))
    return {"pad_free": bool(stored_ok), "gathered_grads_rel": worst,
            "padded_leaves": len(whole_grads)}


def shard27_rank(rank: int, world: int, port: int, jobdir: str) -> None:
    """One rank of phase 27 (a child process :func:`start_shard_ranks`
    starts): the gloo group over the ranks on the one card, then, once
    the parent writes ``jobdir/go`` (:func:`phase_sharded`), parts (a) to
    (g) and (i) on two ranks, parts (h) and (j) on three; the results as
    JSON for the parent.  A rank whose parent is gone exits."""
    import torch
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import init_distributed
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = init_distributed(rank, world, port, dev, backend="gloo")
    kernels = dict(counters.WRAPPERS)

    def log(msg):
        print(f"[shard] rank {rank}: {msg}", flush=True)
    log(f"joined a {backend} group of {world} on "
        f"{torch.cuda.get_device_name(0)}, {time.perf_counter() - T0:.1f}s "
        f"after the script started")
    # the first meta-tensor op loads PyTorch's meta kernels (seconds): do it
    # while waiting (Model.shard reads the whole model's shapes on meta)
    torch.empty((1,), device="meta") * 1.0
    go, parent = os.path.join(jobdir, "go"), os.getppid()
    while not os.path.exists(go):
        if os.getppid() != parent:
            sys.exit(1)
        time.sleep(0.1)
    t_go = time.perf_counter()
    res = {}
    for part in ("hj" if world == 3 else "abcdefgi"):
        if part in SHARD27_THREE:
            res[part] = _shard27_serve(torch, dev, rank, part, kernels,
                                       log, SHARD27_THREE[part][1])[0]
            res[part + "_train"] = _shard27_train(torch, dev, rank, part,
                                                  kernels, log)
        elif part == "i":
            res[part] = _shard27_long(torch, dev, rank, kernels, log)
        elif part in "cg":
            res[part] = _shard27_train(torch, dev, rank, part, kernels, log)
        elif part == "d":
            res[part] = _shard27_mamba(torch, dev, rank, kernels, log)
        elif part == "f":
            res[part] = _shard27_hybrid(torch, dev, rank, kernels, log)
        else:
            res[part] = _shard27_serve(torch, dev, rank, part, kernels,
                                       log)[0]
    log(f"results written {time.perf_counter() - t_go:.1f}s after the go")
    path = os.path.join(jobdir, f"rank{rank}.json")
    with open(path + ".tmp", "w") as fh:
        json.dump(res, fh)
    os.replace(path + ".tmp", path)       # the parent reads it whole
    os._exit(0)       # no teardown of the group: the parent has the results


def start_shard_ranks(world: int):
    """Start ``world`` rank processes of phase 27 (this script with
    ``--shard-rank``) ahead of the phase, so that their start (Python,
    torch, the card's context, the gloo group) overlaps the phases before
    it; they wait for :func:`phase_sharded`'s go.  Returns ``(jobdir,
    [(process, log file)])``; the processes are stopped when this script
    exits, however it exits."""
    import atexit
    import socket
    import tempfile
    jobdir = tempfile.mkdtemp(prefix="chip_smoke27_")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.abspath(__file__)
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(here), "src")}
    procs = []
    for r in range(world):
        logf = open(os.path.join(jobdir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, here, "--shard-rank", str(r), str(world),
             str(port), jobdir], env=env, stdout=logf,
            stderr=subprocess.STDOUT), logf))

    def stop():
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    atexit.register(stop)
    return jobdir, procs


def phase_sharded(torch, dev, kernels, ranks, gates):
    """Phase 27: sharded execution over a device mesh, ranks sharing the
    one card over a gloo group (NCCL refuses two ranks on one device; each
    collective is staged through a host copy).  Frees this process's
    cached memory, tells the waiting ranks of :func:`start_shard_ranks` to
    go, waits for every rank's results (a rank that fails, or results
    that do not come within ``SHARD27["timeout"]``, fail the phase, and
    the ranks are stopped), prints their lines and runs ``gates`` on
    them; :func:`end_shard_ranks` waits for their exits.  Returns the
    ranks' launch counts of the sharded runs, summed."""
    jobdir, procs = ranks
    world = len(procs)
    free_memory(torch)
    open(os.path.join(jobdir, "go"), "w").close()
    t_go = time.perf_counter()
    deadline = t_go + SHARD27["timeout"]
    results = [os.path.join(jobdir, f"rank{r}.json") for r in range(world)]
    done = False
    # until both results are in, a rank fails (the other would wait on
    # it) or the time runs out
    while time.perf_counter() < deadline:
        done = all(os.path.exists(f) for f in results)
        if done or any(p.poll() for p, _ in procs):
            break
        time.sleep(0.2)
    print(f"[shard] the {world} ranks' results "
          f"{'in' if done else 'missing'} {time.perf_counter() - t_go:.1f}s "
          f"after the go", flush=True)
    if not done:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # a rank that failed first, then one stopped because of it
    for r in sorted(range(world),
                    key=lambda r: (procs[r][0].poll() or 0) < 0):
        with open(os.path.join(jobdir, f"rank{r}.log")) as fh:
            text = fh.read()
        for line in text.splitlines():
            if line.startswith("[shard]"):
                print(line, flush=True)
        if not done and procs[r][0].returncode:
            print(text[-6000:], flush=True)
            fail(f"phase 27: rank {r} exited {procs[r][0].returncode}")
    if not done:
        fail(f"phase 27: no results within {SHARD27['timeout']} s")
    res = []
    for f in results:
        with open(f) as fh:
            res.append(json.load(fh))
    return gates(res, kernels)


def end_shard_ranks(ranks) -> None:
    """Wait for phase 27's rank processes to exit (each ends right after
    writing its results; the card's context is released as it exits) and
    fail on an exit other than 0."""
    _, procs = ranks
    for r, (p, logf) in enumerate(procs):
        try:
            code = p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            fail(f"phase 27: rank {r} did not exit")
        logf.close()
        if code != 0:
            fail(f"phase 27: rank {r} exited {code}")


def _gate_serve(part: str, arch: str, res) -> None:
    """A serving part's gates on its ranks' results (rank 0 measured
    against one rank; every rank's weights against the dry run's)."""
    got = res[0][part]
    m = SHARD27_MESH.get(part, (1, 2))[1]
    worst = max(got["rel_l2"])
    routes = got.get("routes_differing")
    peaks = ", ".join(f"{r[part]['peak_bytes'] / 2 ** 30:.2f}"
                      for r in res)
    gate = ("not gated: see the f32 truth" if part in SHARD27_MAMBA
            else f"gate {BF16_TOL}")
    print(f"[shard] ({part}) {arch}, data 1 x model {m}: bf16 logits vs "
          f"one rank{'' if routes is None else ' on one routing'} "
          f"rel_l2 prefill {got['rel_l2'][0]:.4f}, decode "
          f"{', '.join(f'{x:.4f}' for x in got['rel_l2'][1:])} (worst "
          f"{worst:.4f}, {gate})"
          + f"; greedy agreement {got['greedy_agree']:.3f} (not gated)"
          + ("" if routes is None else f"; the other run's router's own "
             f"choices differing {routes:.4f} (not gated)")
          + "; per-rank weights GB "
          + ", ".join(f"{r[part]['weight_bytes'] / 1e9:.3f}" for r in res)
          + ", dry run "
          + ", ".join(f"{r[part]['dry_weight_bytes'] / 1e9:.3f}"
                      for r in res)
          + f"; sharded prefill {got['prefill_s'] * 1e3:.1f} ms (one rank "
          f"{got['one_prefill_s'] * 1e3:.1f}), decode "
          f"{got['decode_s'] * 1e3:.2f} ms a step (one rank "
          f"{got['one_decode_s'] * 1e3:.2f}); peak GiB by rank {peaks}"
          + (f", one rank's references "
             f"{got['one_peak_bytes'] / 2 ** 30:.2f}"
             if "one_peak_bytes" in got else ""), flush=True)
    if part in SHARD27_MAMBA:
        err, one_err = got["truth_err"]
        f32 = got.get("f32_rel_l2")
        wit = got.get("witness_rel_l2")
        print(f"[shard] ({part}) against one rank's f32 logits (the "
              f"truth): sharded bf16 rel_l2 {err:.4f}, one rank's bf16 "
              f"{one_err:.4f} (ratio {err / one_err:.3f}, gate "
              f"{SHARD27_TRUTH_RATIO})"
              + ("" if wit is None else
                 f"; one rank's bf16 kernel path vs its plain path "
                 f"(the witness, not gated) worst {max(wit):.4f}")
              + ("" if f32 is None else
                 f"; f32 sharded vs one rank rel_l2 worst "
                 f"{max(f32):.2e} (gate {SHARD27_F32_REL}), prefill "
                 f"{got['f32']['prefill_s'] * 1e3:.1f} ms (one rank "
                 f"{got['f32']['one_prefill_s'] * 1e3:.1f}), decode "
                 f"{got['f32']['decode_s'] * 1e3:.2f} ms a step, "
                 f"{got['f32']['weight_bytes']:,} weight bytes a rank "
                 f"(dry run {got['f32']['dry_weight_bytes']:,})"),
              flush=True)
        if not err <= SHARD27_TRUTH_RATIO * one_err:
            fail(f"phase 27 ({part}): bf16 error from the f32 truth "
                 f"{err} > {SHARD27_TRUTH_RATIO} x one rank's {one_err}")
        if f32 is not None and not max(f32) <= SHARD27_F32_REL:
            fail(f"phase 27 ({part}): f32 rel_l2 {max(f32)} > "
                 f"{SHARD27_F32_REL}")
        if f32 is not None and got["f32"]["weight_bytes"] != \
                got["f32"]["dry_weight_bytes"]:
            fail(f"phase 27 ({part}): f32 per-rank weights differ from "
                 "the dry run's")
    elif not worst <= BF16_TOL:
        fail(f"phase 27 ({part}): rel_l2 {worst} > {BF16_TOL}")
    for r in res:
        if r[part]["weight_bytes"] != r[part]["dry_weight_bytes"]:
            fail(f"phase 27 ({part}): per-rank weights differ from the "
                 "dry run's")


def _gate_train(part: str, what: str, c: dict, res) -> None:
    """A training part's gates on rank 0's results ``c`` (loss, clipped
    norm, every gradient leaf and moment against one rank's; with padded
    units, none held and the gathered gradients whole)."""
    loss_rel = abs(c["loss"] - c["ref_loss"]) / abs(c["ref_loss"])
    norm_rel = (abs(c["grad_norm"] - c["ref_grad_norm"])
                / c["ref_grad_norm"])
    print(f"[shard] ({part}) {what}: loss {c['loss']:.6f} vs one rank "
          f"{c['ref_loss']:.6f} (rel {loss_rel:.2e}, gate "
          f"{SHARD27_LOSS_REL}); global norm {c['grad_norm']:.6f} vs "
          f"{c['ref_grad_norm']:.6f} (rel {norm_rel:.2e}, gate "
          f"{SHARD27_NORM_REL}); worst of {c['leaves']} leaves rel_l2: "
          f"gradients {c['worst_grads_rel']:.2e}, m "
          f"{c['worst_m_rel']:.2e}, v {c['worst_v_rel']:.2e} (gate "
          f"{SHARD27_GRAD_REL}); step {c['step_s'] * 1e3:.1f} ms (one "
          f"rank {c['one_step_s'] * 1e3:.1f}); peak GiB by rank "
          + ", ".join(f"{r[part]['peak_bytes'] / 2 ** 30:.2f}"
                      for r in res)
          + ", the sharded step's own "
          + ", ".join(f"{r[part]['step_peak_bytes'] / 2 ** 30:.2f}"
                      for r in res)
          + ("" if "pad_free" not in c else
             f"; {c['padded_leaves']} leaves by padded units: no padding "
             f"slot held {all(r[part]['pad_free'] for r in res)}, "
             f"gathered gradients vs one rank rel_l2 "
             f"{c['gathered_grads_rel']:.2e}"), flush=True)
    if not loss_rel <= SHARD27_LOSS_REL:
        fail(f"phase 27 ({part}): loss rel {loss_rel} > "
             f"{SHARD27_LOSS_REL}")
    if not norm_rel <= SHARD27_NORM_REL:
        fail(f"phase 27 ({part}): global norm rel {norm_rel} > "
             f"{SHARD27_NORM_REL}")
    for name in ("grads", "m", "v"):
        worst = c[f"worst_{name}_rel"]
        if not worst <= SHARD27_GRAD_REL:
            fail(f"phase 27 ({part}): {name} rel_l2 {worst} > "
                 f"{SHARD27_GRAD_REL}")
    if "pad_free" in c:
        if not all(r[part]["pad_free"] for r in res):
            fail(f"phase 27 ({part}): a padding slot in the state")
        if not c["gathered_grads_rel"] <= SHARD27_GRAD_REL:
            fail(f"phase 27 ({part}): gathered gradients rel_l2 "
                 f"{c['gathered_grads_rel']} > {SHARD27_GRAD_REL}")


def _gate_long(res) -> None:
    """Part (i)'s gates: every step's merged attention against one rank's
    unsplit attention, and the new K/V rows bit for bit."""
    c = res[0]["i"]
    worst = max(c["attn_rel"])
    print(f"[shard] (i) {HYBRID_ARCH} long_500k context split, data 2 x "
          f"model 1: merged attention vs one rank's unsplit f32 rel_l2 "
          f"worst {worst:.2e} over {len(c['attn_rel'])} steps (gate "
          f"{SHARD27_ATTN_REL}); new K/V rows equal one rank's "
          f"{c['rows_equal']}; bf16 logits vs one rank rel_l2 "
          f"{', '.join(f'{x:.4f}' for x in c['rel_l2'])}, greedy "
          f"agreement {c['greedy_agree']:.3f} (neither gated: a random "
          f"Mamba stack's bf16 spread); rank 0's one-rank prefill of "
          f"{SHARD27['long_prompt']} tokens {c['prefill_s'] * 1e3:.1f} ms, "
          f"decode {c['decode_s'] * 1e3:.2f} ms a step; weights "
          + ", ".join(f"{r['i']['weight_bytes'] / 1e9:.3f}" for r in res)
          + " GB, peak GiB by rank "
          + ", ".join(f"{r['i']['peak_bytes'] / 2 ** 30:.2f}" for r in res),
          flush=True)
    if not worst <= SHARD27_ATTN_REL:
        fail(f"phase 27 (i): merged attention rel_l2 {worst} > "
             f"{SHARD27_ATTN_REL}")
    if not c["rows_equal"]:
        fail("phase 27 (i): a new K/V row differs from one rank's")


def _launch_counts(res, kernels):
    """The ranks' launch counts of their parts, summed; every part's rows
    (``SHARD27_ROWS``) must have launched on every rank."""
    counts = {k: 0 for k in kernels}
    for r in res:
        for part, names in SHARD27_ROWS.items():
            runs = [r[k]["launches"] for k in (part, part + "_train")
                    if k in r]
            if not runs:
                continue
            for run in runs:
                for k, n in run.items():
                    counts[k] += n
            for n in names:
                if r is not res[0] and n in SHARD27_RANK0_ROWS.get(part, ()):
                    continue
                if sum(run[n] for run in runs) <= 0:
                    fail(f"phase 27 ({part}): {n} never launched")
    return counts


def shard27_gates(res, kernels):
    """Phase 27's gates on the two ranks' results (parts (a)-(g) and (i));
    returns the launch counts of both ranks' sharded runs."""
    for part, arch in SHARD27_SERVES.items():
        _gate_serve(part, arch, res)
    for part, what in (("c", "granite-3-8b FSDP, data 2 x model 1"),
                       ("g", "mamba2-2.7b tensor parallel, data 1 x "
                             "model 2")):
        _gate_train(part, what, res[0][part], res)
    _gate_long(res)
    return _launch_counts(res, kernels)


def _gate_uneven(res) -> None:
    """Part (j)'s serving gates: mamba2's 80 SSM heads as 26, 27 and 27
    on the three ranks, its f32 logits against one rank's within (d)'s
    f32 gate, every rank's weights those of the dry run; each rank's wall
    and peak printed beside one rank's."""
    c = res[0]["j"]
    worst = max(c["rel_l2"])
    heads = [r["j"]["ssm_heads"] for r in res]
    print(f"[shard] (j) mamba2-2.7b {SHARD27['uneven_layers']} layers f32, "
          f"{sum(heads)} SSM heads as {', '.join(map(str, heads))} on "
          f"data 1 x "
          f"model 3: logits vs one rank rel_l2 prefill {c['rel_l2'][0]:.2e}"
          f", decode {', '.join(f'{x:.2e}' for x in c['rel_l2'][1:])} "
          f"(worst {worst:.2e}, gate {SHARD27_F32_REL}); greedy agreement "
          f"{c['greedy_agree']:.3f} (not gated); per-rank weights GB "
          + ", ".join(f"{r['j']['weight_bytes'] / 1e9:.4f}" for r in res)
          + ", dry run "
          + ", ".join(f"{r['j']['dry_weight_bytes'] / 1e9:.4f}"
                      for r in res)
          + "; by rank: prefill ms "
          + ", ".join(f"{r['j']['prefill_s'] * 1e3:.1f}" for r in res)
          + f" (one rank {c['one_prefill_s'] * 1e3:.1f}), decode ms a step "
          + ", ".join(f"{r['j']['decode_s'] * 1e3:.2f}" for r in res)
          + f" (one rank {c['one_decode_s'] * 1e3:.2f}), part wall s "
          + ", ".join(f"{r['j']['wall_s']:.1f}" for r in res)
          + ", peak GiB "
          + ", ".join(f"{r['j']['peak_bytes'] / 2 ** 30:.2f}" for r in res)
          + "; train part wall s "
          + ", ".join(f"{r['j_train']['wall_s']:.1f}" for r in res),
          flush=True)
    if heads != SHARD27_UNEVEN_HEADS:
        fail(f"phase 27 (j): SSM heads by rank {heads}, want "
             f"{SHARD27_UNEVEN_HEADS}")
    if not worst <= SHARD27_F32_REL:
        fail(f"phase 27 (j): f32 rel_l2 {worst} > {SHARD27_F32_REL}")
    for r in res:
        if r["j"]["weight_bytes"] != r["j"]["dry_weight_bytes"]:
            fail("phase 27 (j): per-rank weights differ from the dry run's")


def shard27_padded_gates(res, kernels):
    """Parts (h) and (j)'s gates on their three ranks' results:
    granite-3-8b with its heads padded to 9 KV / 36 query slots and
    ``d_ff`` to 12801, and mamba2-2.7b with its 80 SSM heads as 26, 27
    and 27, each served and trained; returns their launch counts."""
    _gate_serve("h", "granite-3-8b, heads and d_ff padded", res)
    _gate_train("h_train", "granite-3-8b tensor parallel, padded, data 1 "
                "x model 3", res[0]["h_train"], res)
    _gate_uneven(res)
    _gate_train("j_train", "mamba2-2.7b tensor parallel, 80 SSM heads as "
                "26, 27, 27, data 1 x model 3", res[0]["j_train"], res)
    return _launch_counts(res, kernels)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "src", "repro_torch")):
        fail("src/repro_torch not found next to this script: run it from a "
             "checkout of the repository")
    from repro_torch.kernels import _build, counters
    from repro_torch.launch.serve import build_model
    from repro_torch.utils import tree_leaves

    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"[device] {name} | {smi_line} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t_start = t0 = time.perf_counter()
    # the profiler's first session starts CUPTI (11-14 s on an H100's
    # host): paid here, beside nvcc, not by the first profiled phase
    warm = threading.Thread(target=_start_profiler, args=(torch,))
    warm.start()
    logs = _build.build_all(verbose=True)
    warm.join()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(_build.sources())} sources with nvcc for sm_90a in "
          f"{build_s:.1f}s", flush=True)
    for line in ptxas_report(logs):
        print(f"[build] {line}")
    smem = _build.load("flash_prefill_prefix").flash_prefill_wgmma_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    print(f"[build] flash_attn_wgmma_kernel dynamic shared memory: d 64 "
          f"{smem(64)} B, d 80 {smem(80)} B, d 128 {smem(128)} B",
          flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = Clock(time.perf_counter())
    # the raw wrappers are timed under no_grad, the mode the serving paths
    # call them in (training reaches them through their Functions)
    with torch.no_grad():
        pa = check_paged_attention(torch, dev)
        fp = check_flash_prefix(torch, dev)
        # rows 1 and 2 at granite-moe's decode and chunk shapes (G 3, d 64)
        pa_moe = check_paged_attention(torch, dev, H=24, d=64)
        fp_moe = check_flash_prefix(torch, dev, H=24, d=64,
                                    cases=(("bfloat16", 256, 1000),))
        # row 2 at stablelm-3b's chunk (H = KVH = 32, d 80), and the d-128
        # body at the same heads, chunk and start: what d 80's panel
        # padding costs
        fp_stablelm = check_flash_prefix(torch, dev, H=32, KVH=32, d=80,
                                         cases=(("bfloat16", 256, 1000),))
        fp_stablelm["d128_ms"] = check_flash_prefix(
            torch, dev, H=32, KVH=32, d=128,
            cases=(("bfloat16", 256, 1000),))["ms"]
        check_flash_prefix_pack(torch, dev)
        fpv = check_flash_prefix_verify(torch, dev)
        fa = check_flash_prefill(torch, dev)
        # row 6 at stablelm-3b's training shape and at seamless's encoder
        # (4096 frames, bidirectional), each gated as granite's
        fa_stablelm = check_flash_prefill(
            torch, dev, H=32, KVH=32, cases=(("float32", 4, 1024, 80, True),))
        fa_stablelm["d128_ms"] = check_flash_prefill(
            torch, dev, H=32, KVH=32,
            cases=(("float32", 4, 1024, 128, True),))["ms"]
        fa_seamless = check_flash_prefill(
            torch, dev, H=16, KVH=16,
            cases=(("bfloat16", 1, 4096, 64, False),))
        # and at jamba's attention layer in a bf16 prefill (64/8 heads)
        fa_jamba = check_flash_prefill(
            torch, dev, H=64, KVH=8,
            cases=(("bfloat16", 1, 1024, 128, True),))
        # and at phase 27 (i)'s prompt length (12288 positions in one
        # launch, jamba's group of 8), at 8/1 heads: the plain version's
        # (S, S) float32 scores of 64 heads would take 38.6 GB
        fa_long = check_flash_prefill(
            torch, dev, H=8, KVH=1,
            cases=(("bfloat16", 1, 12288, 128, True),))
        # and at phase 27's per-rank heads (a 2 x 1024 prefill on a model
        # axis of 2: granite's 16/4 of d 128, granite-moe's 12/4 of d 64;
        # on 3, granite's padded 12/3 of d 128), held to plain and to SDPA
        # as granite's rows
        fa_shard = {
            "granite_H16_KVH4_d128": check_flash_prefill(
                torch, dev, H=16, KVH=4,
                cases=(("bfloat16", 2, 1024, 128, True),)),
            "granite_moe_H12_KVH4_d64": check_flash_prefill(
                torch, dev, H=12, KVH=4,
                cases=(("bfloat16", 2, 1024, 64, True),)),
            # and phase 27 (h)'s: granite's heads padded on a model axis
            # of 3, 12 query slots over 3 KV slots a rank
            "granite_padded_H12_KVH3_d128": check_flash_prefill(
                torch, dev, H=12, KVH=3,
                cases=(("bfloat16", 2, 1024, 128, True),))}
        # rows 1 and 2 at phase 28's heads (d 128): the paged kernel at
        # qwen1.5-32b's decode shape (40 = 40 heads: G 1) and dbrx-132b's
        # (48/8: G 6), the prefix kernel at their chunks and command-r-35b's
        # (64/8: G 8), bf16, gated as granite's rows
        pa_big = {f"{n}_H{H}_KVH{K}": check_paged_attention(
            torch, dev, H=H, KVH=K, dtypes=("bfloat16",))
            for n, H, K in (("qwen", 40, 40), ("dbrx", 48, 8))}
        fp_big = {f"{n}_H{H}_KVH{K}": check_flash_prefix(
            torch, dev, H=H, KVH=K, cases=(("bfloat16", 256, 1000),))
            for n, H, K in (("qwen", 40, 40), ("dbrx", 48, 8),
                            ("command_r", 64, 8))}
        kq, kd = check_kv_quant(torch, dev)
        kq_moe, kd_moe = check_kv_quant(torch, dev, KV_QUANT_MOE)
        kpage = check_kv_quant_page(torch, dev)
        kst = check_kv_quant_store(torch, dev, "granite swap",
                                   **KV_STORE_GRANITE)
        kst_moe = check_kv_quant_store(torch, dev, "granite-moe swap",
                                       **KV_STORE_MOE)
        kst_page = check_kv_quant_store(torch, dev, "tier page",
                                        **KV_STORE_PAGE)
        pq8 = check_paged_attention_q8(torch, dev)
        rn, rn_moe, rn_jamba, rn_shard = check_fused_rmsnorm(torch, dev)
        rn_split = check_split_rmsnorm(torch, dev)
        sc = check_ssd_chunk(torch, dev)
        # row 8 at jamba's prefill layer (1000 tokens: 4 chunks of 256; 128
        # heads of 128 through the split), at the model's decay
        sc_jamba = check_ssd_chunk(torch, dev, H=128, P=128,
                                   cases=((4, 256, "softplus"),
                                          (4, 256, "0.1|randn|")))
        # rows 7 and 8 at phase 27 (j)'s ranks: mamba2's 80 heads as 26,
        # 27 and 27 of 64 (a 1024-token prefill, f32)
        rn_uneven = check_uneven_split_rmsnorm(torch, dev)
        sc_uneven = {f"H{H}": check_ssd_chunk(torch, dev, H=H,
                                              cases=((4, 256, "softplus"),))
                     for H in (26, 27)}
    clock.lap("kernels (phase 3)")

    kernels = dict(counters.WRAPPERS)       # every wrapper, by name
    t0 = time.perf_counter()
    model, params = build_model("granite-3-8b", "full", dev, "flash", SEED)
    torch.cuda.synchronize()
    n_params = params["embed"].numel() + sum(
        t.numel() for layer in params["layers"] for sub in layer.values()
        for t in sub.values())
    print(f"[model] granite-3-8b full width/depth, {n_params:,} params bf16, "
          f"init {time.perf_counter() - t0:.1f}s", flush=True)
    ref = reference_check(torch, model, params)
    clock.lap("granite init + reference (phase 4)")
    # granite's main path is phases 5 and 6 together: counts start at 0
    # here and are read after both (launches made by the parity checks
    # above are not counted)
    from repro_torch.kernels.paged_attention.ops import body_launches
    reset_counts(kernels)
    passes = body_launches()
    paged_reqs = phase_serve(torch, model, params, kernels)
    phase_swap(torch, model, params, kernels)
    launches = read_counts(kernels)
    passes = {k: n - passes[k] for k, n in body_launches().items()}
    print(f"[main-path] granite-3-8b (phases 5-6) launches {launches}; "
          f"paged attention split-KV body {passes['body']}, merge "
          f"{passes['merge']}", flush=True)
    if passes["body"] != launches["paged_attention"] or passes["merge"] <= 0:
        fail("the paged path did not run the split-KV body and its merge")
    clock.lap("granite serve + swap (phases 5-6)")
    # phase 5's graphed decode step against its eager step (after the main
    # path's counts)
    graphed_vs_eager_step(torch, "granite paged (phase 5)", model, params,
                          "paged", PROFILE_CTX)
    clock.lap("granite paged graphed vs eager step (phase 5)")
    phase_profile(torch, model, params)
    clock.lap("granite profile (phase 7)")
    # granite on the dense backend, with the same model (the paged engines
    # of phases 5-7 are gone)
    torch.cuda.empty_cache()
    dense_reference_check(torch, model, params, ref)
    clock.lap("granite dense reference (phase 15)")
    reset_counts(kernels)
    dense_reqs = phase_dense_serve(torch, model, params, kernels)
    phase_dense_swap(torch, model, params, kernels)
    d_launches = read_counts(kernels)
    print(f"[main-path] granite-3-8b dense (phases 16-17) launches "
          f"{d_launches}", flush=True)
    clock.lap("granite dense serve + swap (phases 16-17)")
    graphed_vs_eager_step(torch, "granite dense (phase 16)", model, params,
                          "dense", PROFILE_CTX)
    clock.lap("granite dense graphed vs eager step (phase 16)")
    # row 5's path is the kernel bench (phase 18): counts start at 0 there
    q_launches = phase_bench_rows(torch, model, params, kernels)
    print(f"[main-path] kernel bench (phase 18) launches {q_launches}",
          flush=True)
    clock.lap("kernel bench rows (phase 18)")
    # phases 19-20 on the same model: the packs of phase 19 and the serves
    # of phase 20 are main paths, each counted from 0; their counts are
    # added to the kernels line's totals
    totals = phase_pack_prefix(torch, model, params, kernels)
    print(f"[main-path] granite packs (phase 19) launches {totals}",
          flush=True)
    clock.lap("pack + prefix parity (phase 19)")
    # phases 20, 22 and 23 serve granite cut to GRANITE_CUT of its 40
    # layers (each compares its serves with each other only), for the
    # script's time since phase 26 came
    cut, cut_params = granite_cut(model, params)
    for backend in ("paged", "dense"):
        counts = phase_serve20(torch, cut, cut_params, kernels, backend)
        print(f"[main-path] granite {backend} serve with packs, prefix "
              f"cache and online predictor (phase 20) launches {counts}",
              flush=True)
        totals = {k: totals[k] + counts[k] for k in totals}
        clock.lap(f"granite {backend} serve (phase 20)")
    # phase 21: speculative verify-k decoding and the observability bus
    phase_verify_model(torch, model, params)
    clock.lap("verify vs sequential decode + verify profile (phase 21a)")
    for backend, spec_off in (("paged", paged_reqs), ("dense", dense_reqs)):
        counts = phase_spec_serve(torch, model, params, kernels, backend,
                                  spec_off)
        print(f"[main-path] granite {backend} spec serve with the bus "
              f"(phase 21) launches {counts}", flush=True)
        totals = {k: totals[k] + counts[k] for k in totals}
        clock.lap(f"granite {backend} spec serve + export (phase 21)")
    # phase 22: two replicas of the cut granite sharing a host KV tier,
    # counted from 0
    counts = phase_tier(torch, cut, cut_params, kernels)
    print(f"[main-path] granite two replicas sharing a KV tier (phase 22) "
          f"launches {counts}", flush=True)
    totals = {k: totals[k] + counts[k] for k in totals}
    clock.lap("two replicas sharing a KV tier (phase 22)")
    # phase 23: two replicas behind the gateway, counted from 0 once warm
    counts = phase_gateway(torch, cut, cut_params, kernels)
    print(f"[main-path] granite two replicas behind the gateway, "
          f"concurrent pump (phase 23) launches {counts}", flush=True)
    totals = {k: totals[k] + counts[k] for k in totals}
    clock.lap("two replicas behind the gateway (phase 23)")
    del model, params, ref, cut, cut_params
    free_memory(torch)

    # phase 24: granite-moe-3b-a800m, its serves counted from 0
    counts = phase_moe(torch, dev, kernels)
    print(f"[main-path] {MOE_ARCH} paged, INT8 swap and dense serves "
          f"(phase 24) launches {counts}", flush=True)
    totals = {k: totals[k] + counts[k] for k in totals}
    clock.lap("granite-moe-3b-a800m (phase 24)")

    # phase 25: seamless (encoder-decoder) served through the dense backend
    # and trained, internvl2 fed patch embeddings; (b) and (d) counted
    counts = phase_encdec(torch, dev, kernels)
    print(f"[main-path] {ENCDEC_ARCH} dense-backend serve and training "
          f"(phase 25) launches {counts}", flush=True)
    totals = {k: totals[k] + counts[k] for k in totals}
    clock.lap("seamless-m4t-large-v2 + internvl2-2b (phase 25)")

    # phase 26: jamba's 8-layer group holding 8 of 16 experts, served with
    # an INT8 swap, and mamba2-2.7b trained; (b) and (d) counted from 0
    counts = phase_hybrid(torch, dev, kernels)
    print(f"[main-path] {HYBRID_ARCH} dense serve with a swap and "
          f"mamba2-2.7b training (phase 26) launches {counts}", flush=True)
    totals = {k: totals[k] + counts[k] for k in totals}
    clock.lap("jamba-1.5-large-398b + mamba2-2.7b training (phase 26)")

    # phase 28: qwen1.5-32b, command-r-35b and dbrx-132b at full width, each
    # served with an INT8 swap, its graphed step held to its eager step and
    # profiled; counted from 0
    counts = phase_big(torch, dev, kernels)
    print(f"[main-path] qwen1.5-32b, command-r-35b and dbrx-132b serves, "
          f"swaps, graphed steps and profiles (phase 28) launches {counts}",
          flush=True)
    totals = {k: totals[k] + counts[k] for k in totals}
    clock.lap("qwen1.5-32b, command-r-35b, dbrx-132b (phase 28)")
    # phase 29: granite-moe trained on the card, counted from 0
    counts = phase_moe_train(torch, dev, kernels)
    print(f"[main-path] {MOE_ARCH} training (phase 29) launches {counts}",
          flush=True)
    totals = {k: totals[k] + counts[k] for k in totals}
    clock.lap(f"{MOE_ARCH} training (phase 29)")

    # phase 27's ranks start now, their start overlapping phases 8-11
    ranks, ranks3 = start_shard_ranks(2), start_shard_ranks(3)
    t0 = time.perf_counter()
    model, params = build_model("mamba2-2.7b", "full", dev, None, SEED)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    print(f"[model] mamba2-2.7b full width/depth, {n_params:,} params bf16 "
          f"(SSM constants f32), init {time.perf_counter() - t0:.1f}s",
          flush=True)
    mamba_reference_check(torch, model, params)
    clock.lap("mamba init + reference (phase 8)")
    # mamba's main path is phases 9 and 10 together (the unpreempted
    # comparison runs of phase 10 are not counted)
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    reset_counts(kernels)
    ssd_before = ssd_ops.body_launches()
    phase_mamba_serve(torch, model, params)
    m_launches, ssd_after = phase_mamba_swap(torch, model, params, kernels)
    ssd_body = {k: n - ssd_before[k] for k, n in ssd_after.items()}
    print(f"[main-path] mamba2-2.7b (phases 9-10) launches {m_launches}; "
          f"SSD chunk bodies {ssd_body}", flush=True)
    if (ssd_body["fma"] or ssd_body["tf32x3_states"] != m_launches["ssd_chunk"]
            or ssd_body["tf32x3_y"] != m_launches["ssd_chunk"]):
        fail("the mamba path's SSD chunk calls did not all take the "
             "tensor-core body")
    clock.lap("mamba serve + swap (phases 9-10)")
    graphed_vs_eager_step(torch, "mamba (phase 9)", model, params, "dense",
                          PROFILE_CTX)
    clock.lap("mamba graphed vs eager step (phase 9)")
    phase_mamba_profile(torch, model, params)
    clock.lap("mamba profile (phase 11)")
    del model, params
    free_memory(torch)

    # phase 27: sharded execution, two ranks sharing the card; each rank's
    # sharded runs counted from 0 there, summed; the ranks' exits overlap
    # phases 12-14
    counts = phase_sharded(torch, dev, kernels, ranks, shard27_gates)
    print(f"[main-path] sharded prefill, decode and FSDP training, two "
          f"ranks (phase 27 (a)-(g), (i)) launches {counts}", flush=True)
    totals = {k: totals[k] + counts[k] for k in totals}
    clock.lap("sharded execution over a mesh of two ranks (phase 27)")
    end_shard_ranks(ranks)
    counts = phase_sharded(torch, dev, kernels, ranks3,
                           shard27_padded_gates)
    print(f"[main-path] padded heads and d_ff, uneven SSM heads, three "
          f"ranks (phase 27 (h), (j)) launches {counts}", flush=True)
    totals = {k: totals[k] + counts[k] for k in totals}
    clock.lap("padded and uneven heads over three ranks (phase 27 (h), "
              "(j))")

    train_reference(torch, dev)
    clock.lap("train reference (phase 12)")
    # the training main path is phase 13: counts start at 0 there and are
    # read right after it
    state, t_launches = phase_train(torch, dev, kernels)
    print(f"[main-path] granite-3-8b training (phase 13) launches "
          f"{t_launches}", flush=True)
    clock.lap("train (phase 13)")
    phase_train_profile(torch, dev, state)
    del state
    torch.cuda.empty_cache()
    clock.lap("train profile (phase 14)")

    end_shard_ranks(ranks3)
    # phase 30: layer rematerialisation, after every rank has gone (its
    # deep run holds 62.4 GiB of training state); counted from 0
    counts = phase_remat(torch, dev, kernels)
    print(f"[main-path] granite-3-8b and mamba2-2.7b with remat (phase 30) "
          f"launches {counts}", flush=True)
    totals = {k: totals[k] + counts[k] for k in totals}
    clock.lap("layer rematerialisation (phase 30)")
    src = "src/repro_torch/csrc/"
    rows = [
        dict(name="paged_attention", route="cuda",
             source=src + "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/paged_attention.py:66",
             launches=launches["paged_attention"], **pa,
             moe_shape=pa_moe, big_shapes=pa_big),
        dict(name="flash_prefill_prefix", route="cuda",
             source=src + "flash_prefill_prefix.cu",
             replaces="src/repro/kernels/flash_prefill/flash_prefill.py:119",
             launches=launches["flash_prefill_prefix"], **fp,
             verify_shape={str(k): v for k, v in fpv.items()},
             moe_shape=fp_moe, stablelm_shape=fp_stablelm,
             big_shapes=fp_big),
        dict(name="flash_prefill", route="cuda",
             source=src + "flash_prefill_prefix.cu",
             replaces="src/repro/kernels/flash_prefill/flash_prefill.py:165",
             launches=t_launches["flash_prefill"], **fa,
             stablelm_shape=fa_stablelm, seamless_shape=fa_seamless,
             jamba_shape=fa_jamba, long_shape=fa_long,
             sharded_shape=fa_shard),
        # the (T, d) entry's row counts every launch of the quantize
        # kernel, through either entry (the store entry's added below)
        dict(name="kv_quantize", route="cuda", source=src + "kv_quant.cu",
             replaces="src/repro/kernels/kv_quant/kv_quant.py:37",
             launches=launches["kv_quantize"], **kq,
             tier_page_shape=kpage["kv_quantize"], moe_shape=kq_moe),
        dict(name="kv_quantize_store", route="cuda",
             source=src + "kv_quant.cu",
             replaces="src/repro/kernels/kv_quant/kv_quant.py:37",
             launches=launches["kv_quantize_store"], **kst,
             moe_shape=kst_moe, tier_page_shape=kst_page),
        dict(name="kv_dequantize", route="cuda", source=src + "kv_quant.cu",
             replaces="src/repro/kernels/kv_quant/kv_quant.py:62",
             launches=launches["kv_dequantize"], **kd,
             tier_page_shape=kpage["kv_dequantize"], moe_shape=kd_moe),
        dict(name="paged_attention_q8", route="cuda",
             source=src + "paged_attention.cu",
             replaces="src/repro/kernels/kv_quant/kv_quant.py:123",
             launches=q_launches["paged_attention_q8"], **pq8),
        dict(name="fused_rmsnorm", route="cuda",
             source=src + "fused_rmsnorm.cu",
             replaces="src/repro/kernels/fused_rmsnorm/fused_rmsnorm.py:23",
             launches=m_launches["fused_rmsnorm"], **rn, moe_shape=rn_moe,
             jamba_shape=rn_jamba, sharded_shape=rn_shard),
        dict(name="ssd_chunk", route="cuda", source=src + "ssd_chunk.cu",
             replaces="src/repro/kernels/ssd_scan/ssd_scan.py:51",
             launches=m_launches["ssd_chunk"], **sc, jamba_shape=sc_jamba,
             uneven_shapes=sc_uneven),
    ]
    # row 7's split-row entries, launched on phase 27's path only (mamba2's
    # per-rank prefill shape, jamba's beside it, (j)'s uneven widths)
    for entry, by_shape in rn_split.items():
        rows.append(dict(
            name=entry, route="cuda", source=src + "fused_rmsnorm.cu",
            replaces="src/repro/kernels/fused_rmsnorm/fused_rmsnorm.py:23",
            launches=0, **by_shape["mamba2"], jamba_shape=by_shape["jamba"],
            uneven_shapes=rn_uneven[entry]))
    root = os.path.dirname(os.path.abspath(__file__))
    for r in rows:
        r["launches"] += totals[r["name"]]      # phases 19-27
    kq_row = next(r for r in rows if r["name"] == "kv_quantize")
    kq_row["entries"] = {n: r["launches"] for r in rows
                         for n in ("kv_quantize", "kv_quantize_store")
                         if r["name"] == n}
    kq_row["launches"] = sum(kq_row["entries"].values())
    for r in rows:
        # the csrc headers the source includes (flash and SSD bodies, the
        # 3xTF32 primitives), as the build key follows them
        r["headers"] = [os.path.relpath(str(h), root) for h in
                        _build.includes(os.path.basename(r["source"])[:-3])]
        if r["launches"] <= 0:
            fail(f"kernel {r['name']} never launched on its main path")
    print("[kernels] " + ", ".join(
        f"{r['name']}: launches={r['launches']} parity=ok" for r in rows),
        flush=True)
    print(f"[time] total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:          # phase 27's ranks
        shard27_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                     sys.argv[5])
    else:
        main()
