"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # build + kernel phases only

Phases, each fatal on failure (non-zero exit, no result line):

1. the card: name and power limit as nvidia-smi reports them;
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, one nvcc per source in parallel; ptxas's registers and
   spills per kernel (the bf16 paged fused kernel, every fp32 attention
   kernel and every SSD kernel must not spill);
3. kernels, at the main-path shapes of Qwen3-1.7B (H=16, K=8, G=2, D=128,
   page size 16, dense cache rows of the replay's max_len = 1000, which is
   not a multiple of 128): each kernel against its plain PyTorch version
   on the card, fp32 (atol 1e-4) and bf16 (atol 2e-2; bf16 flash, paged
   and dense decode also within 4 bf16 ulps of each output row's scale,
   beside what a result one key short reads), paged decode in bf16 also
   at page sizes 8 and 32, dense decode with
   linear positions and with a scrambled ring with holes; both fused
   bullet kernels bit-equal to flash + their decode kernel at every
   decode_share of the tile table, fp32 and bf16 (flash's bf16 body runs
   on the tensor cores, both decode kernels' bf16 body is split across
   CTAs); both fused kernels' SM partition read from the launch's record
   at the serving shape, fp32 and bf16, decode_share in {0, 0.25, 0.5,
   0.75, 1}: every item ran once, the SMs that took decode items from
   their own queue are at most n_dec_sm, all of rank below it, and none
   of them took prefill items from its own queue;
   median times over CUDA events of the card's work alone (the stream
   held busy while the host enqueues; L2 flushed before each launch), in bf16
   and, for the kernels whose fp32 body differs, in fp32 (rows named
   ``*_fp32``), beside each kernel's bound and the library yardstick (for
   decode the faster of masked SDPA on K/V expanded to every query head
   and SDPA with enable_gqa on the cache as it is), flash's achieved
   TFLOP/s, bf16 paged and dense decode timed at forced piece counts
   beside split_count's pick, and the paged fused kernel timed at the
   serving shape at each decode_share
   of SWEEP_SHARES beside flash + paged decode launched apart; then the SSD scan (phase 8's shapes; the
   bf16 body also against its plain mirror ``ref.ssd_scan_tc_ref`` within
   2^-7 (y) and 1e-5 (state), timed in both dtypes and in bf16 at each P
   slice of its output kernel), the
   RG-LRU scan at RecurrentGemma-2B's width W=2560 (B in {1, 4}, S in
   {3000, 200}, from zeros and from h0, fp32 and bf16: y and the fp32
   h_T), and flash
   prefill and dense decode at the RecurrentGemma phase's shapes (H=10 on
   K=1, D=256: 4 rows of S=3000 with the 2048 window, decode over 4 slots
   of a 2048-row ring that has wrapped; bf16 also within 4 bf16 ulps of
   each output row's scale); then kernels 1-4 at the shapes the
   mixture-of-experts slice and Qwen1.5 bring (``phase_attention_moe``,
   fp32 and bf16, each timed beside its bound and SDPA): flash over one
   Mixtral-8x22B prompt of 4200 tokens (H=48, K=8, G=6, its 4096-token
   window) and dense decode over 4 slots of its wrapped 4096-row ring,
   Llama-4 Maverick's paged decode (H=40, K=8, G=5) and its paged fused
   kernel (bit-equal to flash + paged decode at every tile-table share),
   Qwen1.5-4B's flash and paged decode (H=K=20, G=1); then the D = 64
   instances of kernels 1-5 (``phase_attention_d64``, fp32 and bf16,
   each timed beside its bound and SDPA): Granite-3.0-2B's causal flash
   over one prompt of 1000 tokens (H=32, K=8, G=4) and paged decode over
   the 8 slots, SeamlessM4T's encoder flash (4 rows of 1024 frames,
   H=K=16, non-causal), its cross-attention flash (64 prompt rows over
   the 1024 encoder rows) and cross decode (kernel 4 over 4 slots of 1024
   rows, all attended), both fused kernels bit-equal to flash + their
   decode kernel at every tile-table share (the dense one's launches are
   that sweep's), the paged one's SM partition read from its record;
   then the chunked prefill's kernels (``phase_chunked_kernels``, fp32
   and bf16): kernel 1 at a query offset, Qwen3-1.7B's chunks of 512 rows
   at offset 7680 over 8192 keys, 1000 at 1000 over 2000, and 512 at 1024
   over 2348 keys (the rows past the chunk at a large finite value no
   query may attend), Granite's D = 64, RecurrentGemma's D = 256 with its
   2048 window and Mixtral's 4096 window, each offset past the window;
   kernel 6 from a random state at the SSD shapes (bf16 also against its
   mirror), and in fp32 a scan split at row 300 (the second part from the
   first part's final state) against the whole; timed: the 8192-key chunk
   beside SDPA with the offset-causal mask and the prefix copy
   (``copy_ms``), kernel 6 from a state at B=1 S=1000 (rows
   ``flash_attention_chunk*``, ``ssd_scan_state*``); then kernel 1's
   backward (``phase_train_kernels``, fp32, the register-tiled body) at
   BWD_SHAPES, as a train step runs it (from the log-sum-exp of the fp32
   training forward ``flash_attention_fwd_lse``, held bit-equal to the
   serving forward and within LSE_TOL of the plain log-sum-exp, timed
   beside it: row ``flash_attention_lse_fp32``; the split count's sweep
   logged): Qwen3-1.7B's training shape (B 8, S 128), S 2048 at its
   heads, Mixtral's G = 6 with a 256-key window, Granite's D = 64 G = 4,
   SeamlessM4T's cross shape (128 rows over 1024, non-causal),
   RecurrentGemma's local attention (D = 256, G = 10, window 2048, S
   3000): dq, dk, dv against the plain backward within TOL of its scale,
   two runs bit-equal, timed beside its bound, the plain backward and
   SDPA's forward + backward less its forward (``is_causal`` where there
   is no window, a mask where there is one; the backend its backward ran
   logged) (rows ``flash_attention_bwd*``); the
   backwards of kernel 6 at Mamba-2-2.7B's shapes (B 1, S 1000 in 4
   chunks of 256, from zeros and from a random state with the final
   state's gradient) and of kernel 7 at RecurrentGemma's (B 4, S 3000, W
   2560, from h0): every gradient within TOL of the plain backward's
   scale (kernel 7's bit-equal too), timed beside its bound and the plain
   backward (rows ``ssd_scan_bwd*``, ``rglru_scan_bwd``); then the bf16
   backwards (``phase_bwd_bf16``) at the same shapes on bf16 inputs:
   kernel 1's on the tensor cores (``flash_attention_bwd_tc``, from the
   log-sum-exp of the training forward ``flash_attention_fwd_lse``, whose
   output is held bit-equal to the serving forward's and within TOL of
   the plain one, its log-sum-exp within LSE_TOL of the plain one), kernel 6's
   (``ssd_scan_bwd_tc``) from zeros and from a state, kernel 7's bf16
   instance, each output within BWD_BF16_TOL (kernel 7 RG_TOL's bf16 ulp)
   of its max abs against the plain backward on the same inputs in fp32,
   two runs bit-equal, timed beside its bound at the bf16 peak, the plain
   backward and (kernel 1) SDPA's bf16 forward + backward less its forward
   (``is_causal`` where there is no window, a mask where there is one;
   the backend its backward ran logged) (rows ``*_bf16``; kernel 7's bf16 instance is logged, not a row: no
   model runs kernel 7 in bf16, the RG-LRU gates hand it fp32);
4. colocated: the dense fused kernel swept over decode_share in {0, 0.25,
   0.5, 0.75, 1} (the counterpart of examples/colocated_attention.py),
   fp32 and bf16: bit-equal to flash + dense decode, and its time per
   share, each at most COLOCATED_LIMIT times flash + dense decode launched
   apart;
5. reference: a 2-layer cut of Qwen3-1.7B at full width, fp32, prefill +
   decode on the card (kernels) against the same on the CPU (plain
   versions); moe reference (``phase_moe_reference``): Llama-4 Maverick
   (paged) and Mixtral-8x22B (its ring) at reduced widths with head dim
   128 and their own heads, experts and top-k, fp32, prompts of 150 and
   80 tokens (past the reduced 64-token window) and 8 decode steps, card
   against CPU: logits within 1e-3 of scale, tokens and every MoE call's
   dropped fraction equal; Llama-4 fused and Qwen1.5-4B (H=K=20) serial
   through BulletServer, card against CPU, streams, cycles and MoE sums
   equal; Qwen1.5-4B in bf16 (the G=1 rows' launches); archs reference
   (``phase_archs_reference``): Granite, Seamless (its encoder over 16
   stub frames, cross-attention, the cross cache) and InternVL2 (8 stub
   patches prepended) at reduced widths with head dim 64 and their own
   heads, fp32, prefill + 8 decode steps through ``GraphedDecode``, card
   against CPU within the MoE reference's gate, then reduced Granite
   fused through BulletServer, card against CPU (the fp32 D = 64 rows'
   launches);
6. serve: Qwen3-1.7B at full width and depth, bf16, seeded random
   weights, 12 requests through BulletServer fused (the default) with the
   launch counters read around that run, the decode_share of each fused
   cycle counted and the prompt tokens against the padded length buckets
   they ran at, then serial: identical streams;
   then the same requests under the scheduler's defaults (its fused
   share); then 4 of them on the dense slot cache in bf16 (the bf16 dense
   decode kernel's launches); then a decode-heavy serve under the
   scheduler's defaults (8 requests of 128 + 128 tokens) with a
   torch.profiler window over 30 serial decode cycles, and one over 30
   fused cycles (device time by kernel kind, device busy share, wall per
   cycle, tok/s); the host time per cycle by part (``HostSplit``) of the
   fused, serial, default-scheduler and decode-heavy serves, cycles that
   captured a graph apart; every server's CUDA graphs (serial decode per
   table bucket or for the dense cache, the fused cycle's segments, the
   paged prefill groups and first tokens) counted by kind with their
   capture seconds, and the graph pool's peak;
   chip (``phase_chip``): chip granularity over the group CHIP_GROUP,
   the one card named twice (each side its own stream and page pool):
   (a) ``partition="chip"`` on the same 12 requests, 8 slots: streams
   identical to the fused serve's, chip cycles, one handoff a request, no
   fused cycle, the pool free and audited, the staging pool apart from
   the decode pool, no graph dropped or captured twice; tok/s beside the
   fused serve's (one card that stands for two), the chip cycles' host
   split, each handoff's pages, MiB and card ms (CUDA events around the
   copy, the prefill side's stream held while the host queues it; the
   copy's first launches timed apart before) beside ``kv_handoff_time``'s
   prediction at the spec's ``ici_bw``; (b)
   ``partition="auto"`` under tests/test_submesh.py's cheap-handoff
   (chip cycles) and dear-handoff (none, fused cycles) regimes, streams
   identical; (c) seeded handoff faults on 6 of the requests: two
   transient failures retried through, then a window that exhausts the
   retry budget and degrades chip -> tile, streams identical, the pool
   free; (d) a 2-layer full-width fp32 cut of the chip engine on the card
   against the same over ("cpu", "cpu"): streams, chip cycles and
   handoffs equal; (e) the ``c_group`` and ``c_final`` graphs over a
   staging pool and the decode graph, each replayed on a side stream,
   bit-equal to their eager steps;
   graphs: the engine's graphs against the eager step (the module-level
   step function called directly) on two copies of one cache, bf16, full
   width and depth: Qwen3-1.7B's engine iteration on the paged cache at
   every table bucket the serve reached (tables changed between
   replays), its fused step in segments against ``fused_group_decode``
   (rep 0, 13 and 27, two table buckets, two decode shares: prompt
   activations, tokens, logits and page pool), its prefill groups and
   first tokens (Bp 1 and 4, padded lengths 128 and 1024, two batches
   each: activations, page pool but the trash page, first tokens), and
   its iteration on the dense cache, Mamba-2-2.7B's, RecurrentGemma-2B's
   ``decode_step`` (``GraphedDecode``) after a prefill; tokens equal,
   logits and caches bit-equal after every step, and the launch counters
   moved by every graphed step as by the eager one;
7. replay: Qwen3-1.7B at full width and depth through the OnlineFrontend
   on a ShareGPT-shaped trace, with observability (the decode_share of
   each fused cycle counted): (a) a fault-free virtual-clock replay; (b)
   the same under a fault plan that walks the SLO guard
   fused→serial→dense and back, invariants audited every cycle,
   streams equal to (a)'s; (c) the dense slot cache serving the same
   requests, streams equal to (a)'s; (d) a wall-clock replay in bf16;
8. Mamba-2 (the SSD chunk scan kernel, checked in phase 3 at Mamba-2-2.7B's
   shapes: H=80, P=64, N=128, chunk 256, B in {1, 4}, S in {1000, 200}):
   (a) reference: a 2-layer cut at full width, fp32, dense prefill + decode
   on the card against the CPU, greedy tokens equal; (b) replay of the
   ShareGPT-shaped trace at full width and depth (64 layers, d_model 2560,
   vocab 50280, seeded random weights, 8 slots, max_prefill_batch 4, so
   prefill batches mix prompt lengths), on the virtual clock in fp32 with
   the ssd_scan launches counted, then on the wall clock in bf16 (counted
   again: the bf16 row's launches); (c) the
   length-correct state: 4 trace prompts prefilled as one padded batch and
   each alone, fp32, every layer's conv and ssm state of every request
   equal within 1e-3 of its scale (cuBLAS may pick another GEMM for
   another batch shape, so states, not argmax streams, are compared; the
   CPU tests hold the streams exactly); torch.profiler windows over 10
   prefill and 10 decode cycles of the wall-clock run's warm-up;
9. RecurrentGemma-2B through the models-level ``prefill`` /
   ``decode_step`` (its only route: ``BulletServer`` refuses its
   ``pattern_tail``): (a) reference: a 5-layer cut at full width, one
   (R, R, L) period and the (R, R) tail, fp32, prompts of 2100 (past the
   window) and 600 tokens as one padded batch + 8 greedy decode steps on
   the card against the CPU, logits within 1e-4 of their scale, tokens
   equal, launches counted; (b) at full width and depth (26 layers,
   vocab 256000, seeded random weights): each request's RG-LRU conv and
   hidden state and SWA ring after a padded batch prefill of prompts of
   3000, 2300, 1200 and 300 tokens against its solo prefill, fp32, every
   layer within 1e-3 of scale; then in bf16 the same batch and 64 greedy
   decode steps through ``GraphedDecode`` (the first captures, the rest
   replay: ms per step over the replays), with 18 rglru_scan and 8 flash
   launches per prefill and 8 decode_attention per step; torch.profiler
   windows over one prefill call and 10 decode steps (replays). The
   reference phase (a) decodes through ``GraphedDecode`` too;
10. sharing: closed-loop multi-turn sessions (``generate_interactions``:
   8 sessions of 2-4 turns, 96-288 fresh tokens and 24-72 output tokens a
   turn) through ``OnlineFrontend.submit_interactions`` at full
   Qwen3-1.7B width and depth, paged, page size 16, 8 slots, max_len
   2048, on the virtual clock: fp32 with sharing off, fp32 with
   ``share_prefix`` (streams identical, tokens reused, fewer prefilled,
   invariants every cycle, the pool clean, each hit request's
   first-token logits within 1e-3 of scale of its unshared run's with
   the same argmax), bf16 with sharing on (tok/s, COW copies, the host ms
   of shared and miss prefill-group cycles, flash, paged decode and the
   paged fused kernel launched); ``prefix_suffix_attention`` (plain
   PyTorch) timed at the bf16 run's largest suffix batch beside its
   bound and masked SDPA;
11. tenants: ``generate_tenant_interactions`` over 4 apps (app 0
   flooding), bf16, sharing on: no tenant controller, a permissive one
   (streams and admission order identical), the full stack (credit, 2
   new interactions per second per app: ``check_oit``, every request
   finished or shed); Jain's index over per-tenant goodput;
12. sim: the serving simulator (``core/simulate.py``, ``sim/``), priced
   by the H100 ``HardwareSpec`` with this card's SM count (the spec line
   printed; the rows are the estimator's prices, not card time): (i) the
   paper's comparison, SIM_SYSTEMS on llama3.1-8b over one ShareGPT
   trace (368 requests), the estimator fitted as ``--mode sim`` fits it:
   every request finished, its timestamps consistent; each system's
   metrics row and host seconds; (ii) the fleet, FLEET replicas behind
   the prefix-affinity router with replica 1 down for [1, 4) s, twice:
   every request finished or cancelled for want of a replica, the same
   per-request signature both times, the ``tail_point`` line; (iii)
   ``sim/replay_vs_sim.py``'s ``cross_validate`` with the port's engine
   and its kernels on the card (flash and paged decode launched): (A)
   the JAX gate's recipe (reduced Qwen3-1.7B, fp32, 16 requests of 64
   tokens, 4 slots) at the kernels' head dim 128: the same partition
   table and split candidates, goodput 1.0 on both sides, at least 5
   table entries, and the engine's cycles, mean cycle and metrics equal
   to the same run's on the CPU; (B) full Qwen3-1.7B in bf16 on the
   replay phase's trace, 8 slots: the same table and split candidates.
   Both gaps are printed, not gated (the engine prices each decode on
   the page-bucketed contexts it streamed, the simulator on the mean
   context);
13. moe (``phase_moe``): (b) Llama-4 Maverick at its published widths,
   one pattern repeat (a dense and a MoE layer: 128 experts top-1 and the
   shared expert; 18.6 G params, drawn an expert at a time), bf16, the
   serve phase's 12 requests fused (pause off, launches counted, decode
   shares, host split, each prefill group's drops) and serial, token
   streams identical (the bf16 split decode cuts each slot's own rows, so
   the table buckets the two schedules set apart change nothing; a
   profile window of 10 decode cycles in the serial run); the
   scheduler's defaults with their host split; the MoE layer's card ms at (8, 1) and (1, 1024) tokens beside
   the bytes of all experts and of the experts routed to; (c) its graphs
   against the eager steps with the MoE layer inside, on two repeats that
   share the one repeat's weights: serial decode at the serve's table
   buckets, the fused cycle in segments (``d_rep`` included) and the
   prefill groups and first tokens, MoE sums bit-equal; (d)
   Mixtral-8x22B at its published widths over 8 of its 56 layers (8
   experts top-2, 20.5 G params), bf16, the dense ring cache, serial:
   prompts of 4200, 1500, 600 and 64 tokens, 32 decode steps each,
   windowed flash and ring decode launches counted, drops, the MoE
   layer's card ms at 4 slots, and its dense decode iteration's graph
   against the eager step;
14. head dim 64 and the encoder-decoder: (a) granite: Granite-3.0-2B at
   its published depth and widths (40 layers, 2.53 G params, D = 64, G =
   4), bf16, the serve phase's 12 requests through BulletServer on the
   paged path fused (pause off, launches counted: the bf16 D = 64 rows of
   kernels 1-3) and serial, streams identical, a profile window of 10
   serial decode cycles (device busy share), the scheduler's defaults,
   then its graphs against the eager steps (serial decode at the serve's
   buckets, the fused cycle in segments at repeats 0, 20 and 39, the
   prefill groups and first tokens); (b) seamless: SeamlessM4T-Large-v2
   at full depth (24 encoder and 24 decoder layers, 2.0 G params), bf16,
   4 rows of 1024 stub frames encoded, decoder prompts of 8, 16, 32 and
   64 tokens prefilled (3 flash launches a layer: encoder, decoder,
   cross), 64 greedy steps through ``GraphedDecode`` bit-equal to the
   eager ``decode_step`` (2 dense decode launches a layer a step: self
   and cross): encoder, prefill and per-step ms; (c) internvl:
   InternVL2-76B at its published widths over 8 of its 80 layers (9.0 G
   params, the depth cut printed), bf16, dense slot cache, 2 rows of 256
   stub patches prepended to prompts of 64 and 500 tokens, 32 greedy steps
   through ``GraphedDecode`` bit-equal to eager;
15. chunked (``phase_chunked``): the chunked prefill (``prefill_chunk``)
   and the long-context prefill at published widths, seeded random
   weights. fp32, chunked against unchunked (the recipe of
   tests/test_chunked_real.py): Qwen3-1.7B (28 layers, 2 × 2048, chunks
   [512]*4 and [768, 768, 512]), Mamba-2-2.7B (64 layers, 2 × 2000,
   [500]*4), RecurrentGemma-2B (26 layers, 2 × 2000, [512, 512, 512,
   464]), Mixtral-8x22B (2 of 56 layers, 2 × 2048, [512]*4, capacity
   factor 8): the last chunk's logits against ``forward``'s at S-1 and 8
   greedy steps from the chunked cache against 8 from the unchunked
   ``prefill``'s, within 2e-3 of scale, tokens equal; Qwen3-1.7B's
   long-context batch (window 8192, prompts of 16384 and 12000): each
   row's logits and every layer's ring against its solo prefill within
   1e-3 of scale. bf16 Qwen3-1.7B: one 8192-token prompt whole and in
   chunks of 512, 1024 and 2048 (ms in total and per chunk, the last
   logits within 5e-2 of scale of the whole prefill's), a profile of the
   512-token chunks, 32 greedy steps through ``GraphedDecode``; the
   long-context batch in bf16 (prefill ms) and 32 graphed
   ``decode_step(long_context=True)`` steps over the ring (ms a step,
   launches); bf16 Mamba-2-2.7B, one 2000-token prompt in chunks of 512
   (on the SSD chunks' boundaries: within 5e-2 of scale of the whole
   prefill) and of 500 (within twice the whole bf16 prefill's distance
   from the fp32 one), the ``ssd_scan_state`` row's launches;
16. train (``phase_train``): (a) the train step (``compute_grads``,
   remat on, fp32) on the card against the CPU at reduced widths and
   depth with each model's own heads (TRAIN_REF: Qwen3-1.7B, Mixtral's
   window, Llama-4 Maverick's router and aux loss, SeamlessM4T's encoder
   and cross-attention at D = 64, InternVL2's frontend), B 2, S 128: the
   loss, the aux loss, the grad norm and every gradient leaf within its
   gate; (b) Qwen3-1.7B at full width and depth through
   ``repro_torch.launch.train`` (fp32, AdamW, batch 8 x 128, remat, 2
   steps): ms a step, tok/s, peak memory, a checkpoint round trip under
   build/ bit-equal, the first step with 2 microbatches equal to the
   run's first step, one step profiled; (c) Granite-3.0-2B at full width
   and depth, 2 steps (the D = 64 backward on a path); (d) Mamba-2-2.7B
   (batch 4 x 1024: 4 chunks of 256 a row) and RecurrentGemma-2B (8 x
   128) at full width and depth, 2 steps each and one profiled: finite
   losses and grad norms, each backward launched, ms a step, tok/s, peak
   memory; (e) bf16: (a) again on a bf16 param tree (TRAIN_BF16_TOL; a
   MoE model's CPU side on the card's expert choices, the flipped ones
   counted), then (b)'s Qwen3-1.7B (10 steps, the loss falling by
   TRAIN_LOSS_DROP, one step profiled), (c)'s Granite and (d)'s
   Mamba-2-2.7B (one step profiled) and RecurrentGemma, 3 steps each,
   each at full width and depth through ``run(..., param_dtype=
   torch.bfloat16)`` (fp32 moments), ms a step, tok/s and peak memory
   beside the fp32 runs'. TRAIN_REF in (a) also holds Mamba-2 (kernel 6
   both ways) and RecurrentGemma (kernel 7, and kernel 1 at D = 256, both
   ways). The rows ``flash_attention_bwd*`` take their launches from (b)
   (Qwen3's shape and S 2048, the same kernel instance), (c) (D = 64), (a)
   (Mixtral's window, SeamlessM4T's cross-attention) and (d)
   (RecurrentGemma's D = 256); ``ssd_scan_bwd*`` and ``rglru_scan_bwd``
   from (d) (the state row the same kernel's); the ``*_bf16`` rows from
   the same runs in (e) (a bf16 RecurrentGemma step runs kernel 7 in
   fp32: its gates are fp32, as the JAX package's);
17. sharded (``phase_sharded``, ROADMAP §1 item 8d): ranks spawned on
   cuda:0 over gloo (every collective staged through the host: no measure
   of TP speed), while the dry-run matrix (18 (a)) traces on the host's
   cores: Qwen3-1.7B at full width and depth on 1 x 2, fp32 (gate TP_TOL
   of the real vocab's logit scale against the unsharded port on the
   card) and bf16 (printed); RecurrentGemma-2B's (R, R, L) and
   Mamba-2-2.7B at depth 2 on 1 x 2; Mixtral-8x22B (one layer, capacity
   factor 8) on 2 x 2, token-parallel and 2D; a depth-2 Qwen3-1.7B fp32
   train step with FSDP on 2 x 2 against the unsharded step; each rank's
   parameter bytes equal to ``sharded_resident_gb``, its launches (1 and
   4 in Qwen3, 1 and 7 in RecurrentGemma, 6 in Mamba-2) and collective
   bytes printed;
18. dryrun (``phase_dryrun``): (a) every registered config x input shape
   (44) on the 16x16 production mesh traced at full width and depth on
   the meta device, the whole step and rank 0's local step
   (``repro_torch.launch.dryrun``, DRYRUN_JOBS processes, rows under
   build/), no failure, Granite-3.0-2B's ``decode_32k`` under 16 GB a
   device; (b) Qwen3-1.7B at full width in bf16 on the card:
   ``prefill`` of one 1000-token prompt (kernel 1) and ``decode_step``
   over 8 slots of a dense 1000-row cache at contexts 1-1000 (kernel 4),
   each: the median card ms of CUDA-event timings outside the counter,
   the roofline counter's FLOPs and bytes on the card (the kernels
   charged by ``kernels/cost.py``, 28 launches each, the wrappers'
   counters moved as much), the roofline time and its share of the
   measured ms (gated in (0, SHARE_LIMIT]), the same counts from the meta
   trace outside the kernel (the decode kernel charging every cache row
   there), and the meta trace's peak against ``max_memory_allocated``
   beyond the arguments (within PEAK_TOL or PEAK_SLACK).

Every bound column is ``kernels/cost.py``'s: the bytes and operations of
each kernel and ``bound_ms`` over the H100 peaks.

The second-last line is the kernel table as JSON (each row's launches
read from a run of the row's dtype, so they count the body it times), the
last line the device summary as JSON.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the kernels' bytes and operations, and the H100 bound over them (one
# place for the kernel table, the roofline counter and the dry-run)
from repro_torch.kernels.cost import (HBM_BW, bound_ms,  # noqa: E402
                                      bwd_cost, decode_cost, dense_cost,
                                      esize, flash_cost, rglru_bwd_cost,
                                      rglru_cost, ssd_bwd_cost, ssd_cost)
from repro_torch.kernels.geometry import (PIECE_ROWS,  # noqa: E402
                                          fp32_pieces)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
H, K, G, D, PS = 16, 8, 2, 128, 16
#: the attention kernels' source (kernels 1-5)
ATTN_SRC = "src/repro_torch/kernels/csrc/attention.cu"
#: the replay phase's context window, and so the dense cache's rows: not a
#: multiple of 128 (nor of the kernel's 16-row tile), so the tail path runs
MAX_LEN = 1000
#: Mamba-2-2.7B's SSD sizes: heads, head dim, state, chunk
SSD_H, SSD_P, SSD_N, SSD_Q = 80, 64, 128, 256
#: SSD kernel vs plain: error over the output's scale max(1, max|plain|);
#: bf16 y is rounded to bf16 (one ulp is 2^-8 of the scale), the fp32
#: state is not
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_STATE_TOL = 1e-4
#: the bf16 SSD kernel against its plain mirror ref.ssd_scan_tc_ref (the
#: same roundings in another summation order), tighter: y one bf16 ulp of
#: the scale's binade (the two round y apart at most once), the state 1e-5
SSD_TC_TOL, SSD_TC_STATE_TOL = 2.0 ** -7, 1e-5
#: the SSD scan's kernels: the fp32 body, and the bf16 body's three
#: launches (C Bᵀ with the chunk states, the pass over the chunks, the
#: outputs)
SSD_KERNELS = ("ssd_scan_kernel", "ssd_state_kernel", "ssd_pass_kernel",
               "ssd_out_kernel")
#: RecurrentGemma-2B's sizes: RG-LRU width, attention heads (10 query heads
#: on one kv head), head dim, sliding window
RG_W, RG_H, RG_K, RG_D, RG_WINDOW = 2560, 10, 1, 256, 2048
#: RG-LRU kernel vs plain, over the output's scale max(1, max|plain|): fp32
#: y and h_T 1e-5; bf16 y one bf16 ulp of the scale (2^-8), h_T (fp32) 1e-5
RG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}
RG_STATE_TOL = 1e-5
#: flash and dense decode in bf16 vs plain, at D=256 and at D=128: besides
#: TOL's absolute limit, max|kernel - plain| over each output row within
#: this many bf16 ulps of the row's own scale max|plain_row|. The kernel
#: rounds its output once; the plain version rounds each 1024-key block's
#: PV product and then its output, so the two differ by up to about 2 ulps
#: where the window spans 3 blocks; each phase prints what a result one key
#: short reads in the same units, well above this
RG_ATTN_ULPS = 4
#: the value of the key and value rows past a chunk at a query offset: a
#: kernel that attends them misses by far more than the tolerance
PAST_CHUNK = 1e3
#: decode_share values of the paged fused kernel's sweep at the serving
#: shape
SWEEP_SHARES = (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)
#: the colocated gate: the dense fused launch at any share within this
#: many times flash + dense decode launched apart (both the timer's
#: medians of card time; the margin covers the swing of rows under 0.1 ms between runs,
#: up to 61%)
COLOCATED_LIMIT = 3.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

#: cycles (about 0.5 ms) the timer keeps the stream busy before each timed
#: call, longer than any wrapper here takes to enqueue its launches
HOLD_CYCLES = 1_000_000


class Timer:
    """Median milliseconds of one call over CUDA events; a 256 MiB buffer
    is rewritten before every timed call so each starts with a cold L2,
    as a layer's attention does in the model. The stream is held busy
    (``torch.cuda._sleep``) while the host enqueues the events and the
    call, so they bracket the card's work alone and not the time the
    wrapper's Python takes (which rows under ~0.1 ms would read)."""

    def __init__(self, reps: int = 15):
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(HOLD_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def with_tflops(row: dict, n_ops: float) -> dict:
    """A flash row with the TFLOP/s its kernel achieved in this run."""
    row["tflops"] = n_ops / row["ms"] / 1e9
    return row


def log_row(r: dict) -> None:
    extra = ""
    if "library_gqa_ms" in r:
        extra += (f"; SDPA expanded {r['library_expanded_ms']:.4f}, "
                  f"enable_gqa {r['library_gqa_ms']:.4f}")
    if "tflops" in r:
        extra += f"; {r['tflops']:.1f} TFLOP/s achieved"
    log(f"{r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
        f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms by "
        f"{r['bound_by']}{extra}) at {r['shape']}")


def split_sweep(timer, fn, chosen: int, what: str) -> None:
    """A bf16 split decode launch ``fn`` (dense or paged) timed at forced
    piece counts (the wrappers' split_count replaced for the sweep), beside
    the count split_count picks (``chosen``): the evidence for its
    choice."""
    from repro_torch.kernels import decode_attention as DA
    pick = DA.split_count
    times = []
    try:
        for n in (1, 2, 4, 8, 16, 32, 64):
            DA.split_count = lambda *a, n=n: n
            times.append(f"{n}: {timer(fn):.4f}")
    finally:
        DA.split_count = pick
    log(f"{what}, ms by pieces per (slot, kv head) (split_count picks "
        f"{chosen}): {', '.join(times)}")


def sdpa_yardsticks(timer, q, k, v, mask, g):
    """Masked SDPA over a decode batch two ways: on K/V expanded to every
    query head with repeat_interleave (G times the kernel's bytes) and on
    the unexpanded cache with enable_gqa. q (B, H, 1, D), k/v (B, K, S, D)
    contiguous. Returns (expanded ms, gqa ms): the faster is library_ms."""
    F = torch.nn.functional
    kx = k.repeat_interleave(g, 1).contiguous()
    vx = v.repeat_interleave(g, 1).contiguous()
    exp_ms = timer(lambda: F.scaled_dot_product_attention(q, kx, vx,
                                                          attn_mask=mask))
    gqa_ms = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    return exp_ms, gqa_ms


def schedule_gate(sched, what: str) -> str:
    """Fails unless one fused launch's record (a bullet_attention.Schedule)
    shows the SM partition: every item ran exactly once, each SM id had one
    rank, the SMs that took decode items from their own queue are at most
    n_dec_sm and all of rank below it, and the SMs that took prefill items
    from their own queue are all of rank n_dec_sm or more. Returns what the
    record shows."""
    rec = sched.record.cpu()
    n_dec = sched.n_dec
    check(bool((rec[:, 0] == 1).all()), f"{what}: an item ran other than "
          "once")
    rank_of = {}
    for smid, rank in rec[:, 2:4].tolist():
        check(rank_of.setdefault(smid, rank) == rank,
              f"{what}: SM {smid} has two ranks")
    own = rec[:, 4] == 1
    dec_own = {int(x) for x in rec[:n_dec, 2][own[:n_dec]]}
    pre_own = {int(x) for x in rec[n_dec:, 2][own[n_dec:]]}
    check(len(dec_own) <= sched.n_dec_sm
          and all(rank_of[x] < sched.n_dec_sm for x in dec_own),
          f"{what}: decode items from the decode queue on {len(dec_own)} "
          f"SMs, n_dec_sm {sched.n_dec_sm}")
    check(all(rank_of[x] >= sched.n_dec_sm for x in pre_own),
          f"{what}: a decode SM took prefill items from its own queue")
    return (f"{len(dec_own)} SMs took decode items from their own queue "
            f"(n_dec_sm {sched.n_dec_sm} of {sched.n_sm}), {len(pre_own)} "
            f"prefill; {int((~own[:n_dec]).sum())} of {n_dec} decode and "
            f"{int((~own[n_dec:]).sum())} of {len(rec) - n_dec} prefill "
            f"items taken from the other queue; {len(rank_of)} SMs ran items")


def share_histogram(shares) -> str:
    """decode_share: number of fused cycles, over the shares of a run's
    fused cycles."""
    counts = collections.Counter(round(x, 4) for x in shares)
    return ", ".join(f"{k:.4f}: {n}" for k, n in sorted(counts.items())) \
        or "none"


class FusedShares:
    """A serve audit: the decode_share of each fused cycle."""

    def __init__(self):
        self.shares, self.seen = [], 0

    def __call__(self, srv) -> None:
        if srv.stats.fused_cycles > self.seen:
            self.seen = srv.stats.fused_cycles
            self.shares.append(srv.rm.executable().decode_share)


class PaddedShare:
    """A serve audit: each prefill batch's real prompt tokens against the
    tokens it was padded to (B x padded length), read from the in-flight
    task after every cycle."""

    def __init__(self):
        self.real = self.padded = 0
        self.task = None

    def __call__(self, srv) -> None:
        task = srv.ptask
        if task is not None and task is not self.task:
            self.task = task
            self.real += task.n_tokens
            self.padded += task.x.shape[0] * task.x.shape[1]

    def line(self) -> str:
        share = 1 - self.real / max(self.padded, 1)
        return (f"{self.real} prompt tokens padded to {self.padded} "
                f"({100 * share:.1f}% padding)")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def flash_inputs(gen, bp, s, dtype, h: int = H, kh: int = K, d: int = D,
                 sk: int = 0):
    """q of ``s`` rows, k and v of ``sk`` rows (0: ``s``)."""
    sk = sk or s
    q = torch.randn(bp * h, s, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(bp * kh, sk, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(bp * kh, sk, d, generator=gen, device="cuda").to(dtype)
    return q, k, v


#: decode slots: live contexts (pos + 1) incl. page edges; 0 = inactive
CONTEXTS = (1, 15, 16, 17, 257, 500, 1000, 0)


def decode_inputs(gen, dtype, ps: int = PS, kh: int = K, g: int = G,
                  d: int = D):
    """8 slots over a pool of ``ps``-row pages: mixed contexts, page-edge
    cases, one inactive slot (pos = -1), the table bucketed to a power of
    two with the trash page past each slot's live pages; the trash page
    holds large garbage so any read of it would show. ``kh`` kv heads of
    ``g`` query heads each, head dim ``d``."""
    b = len(CONTEXTS)
    need = [-(-c // ps) for c in CONTEXTS]
    n_b = 1 << (max(need) - 1).bit_length()
    n_pages = sum(need) + 8
    trash = n_pages
    kp = torch.randn(n_pages + 1, ps, kh, d, generator=gen, device="cuda")
    vp = torch.randn(n_pages + 1, ps, kh, d, generator=gen, device="cuda")
    kp[trash] = 1e4
    vp[trash] = -1e4
    perm = torch.randperm(n_pages, generator=gen, device="cuda").cpu()
    bt = np.full((b, n_b), trash, np.int32)
    used = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[used:used + n].numpy()
        used += n
    pos = torch.tensor([c - 1 for c in CONTEXTS], dtype=torch.int32,
                       device="cuda")
    q = torch.randn(b, kh, g, d, generator=gen, device="cuda").to(dtype)
    return (q, kp.to(dtype), vp.to(dtype),
            torch.from_numpy(bt).cuda(), pos)


def dense_inputs(gen, dtype, ring: bool, kh: int = K, g: int = G,
                 d: int = D):
    """8 slots over dense rows of MAX_LEN: the contexts of the paged case
    (clipped to the row), one inactive slot, and either linear positions
    or tests/test_kernels.py's scrambled ring with holes (-1), in which
    the first slot (pos 0) attends no row; ``kh`` kv heads of ``g`` query
    heads, head dim ``d``."""
    b, s = len(CONTEXTS), MAX_LEN
    base = torch.arange(s, dtype=torch.int32, device="cuda")[None].expand(b, s)
    if ring:
        kvpos = torch.where(base % 5 == 0, -1, (base * 13) % (s + 200))
    else:
        kvpos = base
    pos = torch.tensor([min(c, s) - 1 for c in CONTEXTS], dtype=torch.int32,
                       device="cuda")
    q = torch.randn(b, kh, g, d, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dtype)
    return q, kc, vc, kvpos.to(torch.int32).contiguous(), pos


def attended(kvpos, pos):
    """(B,) bool: the dense slots with at least one attended row. A slot
    without one returns zeros from the kernel (as the TPU kernel does) and
    the mean of V from the plain version (as the XLA reference does), so
    kernel and plain are compared on the others."""
    return ((kvpos >= 0) & (kvpos <= pos[:, None])).any(dim=1)


def ssd_inputs(gen, b, s, dtype):
    """The SSD kernel's inputs as the model's prefill makes them (through
    ``ops.ssd_chunk_inputs``): x, B, C ~ N(0, 1) in ``dtype``, dt the
    softplus of N(0, 1), A = -exp(A_log) with A_log the "lru" init, S
    padded to the chunk with dt = 0."""
    from repro_torch.kernels import ops

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x = rn(b, s, SSD_H, SSD_P).to(dtype)
    dt = torch.nn.functional.softplus(rn(b, s, SSD_H))
    u = torch.rand(SSD_H, generator=gen, device="cuda") * 0.8 + 0.1
    A = -torch.exp(torch.log(u / (1 - u)))
    return ops.ssd_chunk_inputs(x, dt, A, rn(b, s, SSD_N).to(dtype),
                                rn(b, s, SSD_N).to(dtype), chunk=SSD_Q)


def ssd_check(gen, b, s, dtype, state: bool = False) -> float:
    """The SSD scan kernel against its plain version on ``ssd_inputs``
    (with ``state`` from a random state0): y and the final state within
    SSD_TOL / SSD_STATE_TOL of scale, the bf16 body also against its
    plain mirror within SSD_TC_TOL / SSD_TC_STATE_TOL; with ``state`` the
    log adds what the scan from zeros reads. Returns max|kernel - plain|
    of y."""
    from repro_torch.kernels import ref as KR
    from repro_torch.kernels import ssd_scan as SK
    xw, cum, bm, cm = ssd_inputs(gen, b, s, dtype)
    st0 = (torch.randn(b, SSD_H, SSD_P, SSD_N, generator=gen, device="cuda")
           if state else None)
    y, st = SK.ssd_scan(xw, cum, bm, cm, st0)
    ry, rst = SK.ssd_scan_plain(xw, cum, bm, cm, st0)
    torch.cuda.synchronize()
    what = (f"ssd_scan{' from a state' if state else ''} {_dt_name(dtype)} "
            f"B={b} S={s}")
    check(y.dtype == dtype and st.dtype == torch.float32,
          f"{what}: output dtypes {y.dtype}/{st.dtype}")
    ey, es = rel_err(y, ry), rel_err(st, rst)
    check(math.isfinite(ey) and ey <= SSD_TOL[dtype]
          and math.isfinite(es) and es <= SSD_STATE_TOL,
          f"{what}: y err {ey}, state err {es}")
    ea = (y.float() - ry.float()).abs().max().item()
    extra = ""
    if dtype == torch.bfloat16:
        my, mst = KR.ssd_scan_tc_ref(xw, cum, bm, cm, st0)
        my_e, ms_e = rel_err(y, my), rel_err(st, mst)
        check(my_e <= SSD_TC_TOL and ms_e <= SSD_TC_STATE_TOL,
              f"{what} against its mirror: y err {my_e}, state err {ms_e}")
        extra = f"; against the mirror y {my_e:.3e}, state {ms_e:.3e}"
    if state:
        zy = rel_err(SK.ssd_scan_plain(xw, cum, bm, cm)[0], ry)
        extra += f"; the scan from zeros reads y {zy:.3e}"
    log(f"{what} (NC={xw.shape[1]} Q={xw.shape[2]}): max|kernel-plain|/"
        f"scale y {ey:.3e}, state {es:.3e}; max|kernel-plain| y {ea:.3e} "
        f"(scale {ry.float().abs().max().item():.1f}){extra}")
    return ea


def rel_err(out, ref) -> float:
    """max|out - ref| over the reference's scale max(1, max|ref|)."""
    ref = ref.float()
    return ((out.float() - ref).abs().max()
            / ref.abs().max().clamp(min=1.0)).item()


# ---------------------------------------------------------------------------
# kernel checks and rows: one of each per kernel, at every shape
# ---------------------------------------------------------------------------

def _dt_name(dtype) -> str:
    return str(dtype)[6:]


def _dt_suffix(dtype) -> tuple:
    """(row-name suffix, shape tag): the bf16 rows carry no suffix."""
    return ("", "bf16") if dtype == torch.bfloat16 else ("_fp32", "fp32")


def flash_check(gen, bp, s, dtype, *, h: int = H, kh: int = K, d: int = D,
                window: int = 0, what: str = "", causal: bool = True,
                sk: int = 0, q_offset: int = 0):
    """Flash over ``bp`` rows of ``s`` query tokens and ``sk`` keys (0:
    ``s``; ``h`` query heads on ``kh`` kv heads, head dim ``d``, causal or
    not, within ``window`` keys; query i at position ``q_offset + i``, the
    key and value rows past the chunk at PAST_CHUNK, which no query may
    attend) against its plain version within TOL; in bf16 also per output
    row within RG_ATTN_ULPS, beside what the plain version reads with the
    window one key short (for window 0, the last row's oldest key left
    out; with an offset, the offset one short). Returns (error, (q, k,
    v))."""
    from repro_torch.kernels import flash_attention as FA
    g = h // kh
    q, k, v = flash_inputs(gen, bp, s, dtype, h, kh, d, sk)
    if q_offset:
        k[:, q_offset + s:] = PAST_CHUNK
        v[:, q_offset + s:] = PAST_CHUNK
    out = FA.flash_attention(q, k, v, causal=causal, window=window, group=g,
                             q_offset=q_offset)
    ref = FA.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   group=g, q_offset=q_offset)
    torch.cuda.synchronize()
    e = (out.float() - ref.float()).abs().max().item()
    name = (f"flash {what}{_dt_name(dtype)} Bp={bp} S={s}"
            f"{f' at offset {q_offset}' if q_offset else ''}"
            f"{f' Sk={sk}' if sk else ''} H={h} K={kh} D={d} "
            f"window={window}{'' if causal else ' non-causal'}")
    check(math.isfinite(e) and e <= TOL[dtype], f"{name}: err {e}")
    how = ""
    if dtype == torch.bfloat16:
        u = row_ulps(out, ref)
        check(math.isfinite(u) and u <= RG_ATTN_ULPS,
              f"{name}: {u} ulps of the row scale")
        if q_offset:
            short, probe = "offset one", dict(window=window,
                                              q_offset=q_offset - 1)
        else:
            short, probe = "window one key", dict(window=(window or s) - 1)
        wu = row_ulps(FA.flash_attention_plain(q, k, v, causal=causal,
                                               group=g, **probe), ref)
        how = (f", {u:.2f} bf16 ulps of the row scale (tolerance "
               f"{RG_ATTN_ULPS}); a wrong result reads {wu:.2f} ({short} "
               "short)")
    log(f"{name}: max|kernel-plain| = {e:.3e}{how}")
    return e, (q, k, v)


def paged_check(gen, dtype, *, ps: int = PS, kh: int = K, g: int = G,
                d: int = D, what: str = ""):
    """Paged decode over the 8 slots of CONTEXTS (``decode_inputs``)
    against its plain version within TOL on the active slots, the inactive
    slot zeros; in bf16 (the split body) also per output row within
    RG_ATTN_ULPS, beside what the plain version reads with each slot's
    newest key left out. Returns (error, inputs)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_decode_attention as PD
    q, kp, vp, bt, pos = inputs = decode_inputs(gen, dtype, ps, kh, g, d)
    out = PD.paged_decode_attention(q, kp, vp, bt, pos)
    ref = PD.paged_decode_attention_plain(q, kp, vp, bt, pos)
    torch.cuda.synchronize()
    act = pos >= 0
    e = (out[act].float() - ref[act].float()).abs().max().item()
    name = (f"paged decode {what}{_dt_name(dtype)} K={kh} G={g} D={d} "
            f"ps={ps}")
    check(math.isfinite(e) and e <= TOL[dtype], f"{name}: err {e}")
    check(bool((out[~act] == 0).all()), f"{name}: inactive slot not zero")
    how = ""
    if dtype == torch.bfloat16:
        u = row_ulps(out[act], ref[act])
        check(math.isfinite(u) and u <= RG_ATTN_ULPS,
              f"{name}: {u} ulps of the row scale")
        # the slots with a key left after the newest is dropped
        two = pos >= 1
        wu = row_ulps(PD.paged_decode_attention_plain(
            q, kp, vp, bt, pos - 1)[two], ref[two])
        n = DA.n_split(q, bt.shape[1] * ps, paged=True)
        how = (f", {u:.2f} bf16 ulps of the row scale (tolerance "
               f"{RG_ATTN_ULPS}); a wrong result reads {wu:.2f} (newest key "
               f"left out); {n} pieces per (slot, kv head) in the launch")
    log(f"{name} contexts {CONTEXTS} n_b {bt.shape[1]}: max|kernel-plain| "
        f"(active) = {e:.3e}{how}, inactive slot zeros")
    return e, inputs


def dense_check(inputs, dtype, what: str) -> float:
    """Dense decode over ``inputs`` (q, k_cache, v_cache, kv_positions,
    pos) against its plain version within TOL on the slots with an
    attended row, the others zeros; in bf16 also per output row within
    RG_ATTN_ULPS, beside what the plain version reads with each slot's
    newest key left out. Returns the error."""
    from repro_torch.kernels import decode_attention as DA
    q, kc, vc, kvpos, pos = inputs
    b, kh, g, d = q.shape
    out = DA.decode_attention(q, kc, vc, kvpos, pos)
    ref = DA.decode_attention_plain(q, kc, vc, kvpos, pos)
    torch.cuda.synchronize()
    act = attended(kvpos, pos)
    e = (out[act].float() - ref[act].float()).abs().max().item()
    name = (f"dense decode {what} {_dt_name(dtype)} {b} slots x S="
            f"{kc.shape[1]} K={kh} G={g} D={d}")
    check(math.isfinite(e) and e <= TOL[dtype], f"{name}: err {e}")
    check(bool((out[~act] == 0).all()),
          f"{name}: a slot with no attended row not zero")
    how = ""
    if dtype == torch.bfloat16:
        u = row_ulps(out[act], ref[act])
        check(math.isfinite(u) and u <= RG_ATTN_ULPS,
              f"{name}: {u} ulps of the row scale")
        newest = torch.where(kvpos == pos[:, None], -1, kvpos)
        wu = row_ulps(DA.decode_attention_plain(
            q, kc, vc, newest, pos)[act], ref[act])
        how = (f", {u:.2f} bf16 ulps of the row scale (tolerance "
               f"{RG_ATTN_ULPS}); a wrong result reads {wu:.2f} (newest key "
               "left out)")
    log(f"{name}: max|kernel-plain| ({int(act.sum())} slots with an "
        f"attended row) = {e:.3e}{how}; {int((~act).sum())} slots without "
        "one return zeros")
    return e


def flash_row(timer, name, dtype, inputs, err, bp, s, *, h: int = H,
              kh: int = K, d: int = D, window: int = 0, what: str = "",
              causal: bool = True, sk: int = 0, q_offset: int = 0):
    """Flash's kernel-table row: card ms, plain ms and SDPA (on expanded
    K/V, the window or the query offset as a causal mask) on ``inputs``
    (``sk`` keys, 0: ``s``), beside the bound."""
    from repro_torch.kernels import flash_attention as FA
    F = torch.nn.functional
    g = h // kh
    sk = sk or s
    sfx, tag = _dt_suffix(dtype)
    q, k, v = inputs
    nb, no = flash_cost(bp, s, dtype, h=h, kh=kh, d=d, window=window,
                        causal=causal, sk=sk, q_offset=q_offset)
    bms, bby = bound_ms(nb, no, dtype)
    qs = q.reshape(bp, h, s, d)
    ks = k.reshape(bp, kh, sk, d).repeat_interleave(g, 1)
    vs = v.reshape(bp, kh, sk, d).repeat_interleave(g, 1)
    if window or q_offset:
        i = torch.arange(s, device="cuda")[:, None] + q_offset
        j = torch.arange(sk, device="cuda")[None, :]
        mask = (j <= i) & (j > i - window) if window else j <= i
        lib = timer(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask))
    else:
        lib = timer(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal))
    kw = dict(causal=causal, window=window, group=g, q_offset=q_offset)
    return with_tflops(dict(
        name=name + sfx, route="cuda", source=ATTN_SRC,
        replaces="src/repro/kernels/flash_attention.py:77",
        ms=timer(lambda: FA.flash_attention(q, k, v, **kw)),
        plain_ms=timer(lambda: FA.flash_attention_plain(q, k, v, **kw)),
        bound_ms=bms, bound_by=bby, library_ms=lib, max_abs_err=err,
        shape=f"{what}Bp={bp} S={s}"
              f"{f' at offset {q_offset} over Sk={sk}' if q_offset else ''}"
              f" H={h} K={kh} D={d} window {window} "
              f"{'causal' if causal else 'non-causal'} {tag}"), no)


def paged_row(timer, name, dtype, inputs, err, *, what: str = "",
              sweep: bool = False) -> dict:
    """Paged decode's kernel-table row: card ms, plain ms and SDPA (on the
    gathered K/V, expanded and with ``enable_gqa``) on ``inputs``
    (``decode_inputs``), beside the bound; ``sweep`` also times bf16 over
    forced piece counts."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import paged_decode_attention as PD
    sfx, tag = _dt_suffix(dtype)
    qd, kpg, vpg, bt, pos = inputs
    b, kh, g, d = qd.shape
    nb, no = decode_cost(qd, pos, dtype, PS)
    bms, bby = bound_ms(nb, no, dtype)
    kd = kpg[bt.long()].reshape(b, -1, kh, d).transpose(1, 2).contiguous()
    vd = vpg[bt.long()].reshape(b, -1, kh, d).transpose(1, 2).contiguous()
    kvpos = torch.arange(kd.shape[2], device="cuda")
    mask = (kvpos[None, :] <= pos[:, None])[:, None, None, :]
    exp_ms, gqa_ms = sdpa_yardsticks(timer, qd.reshape(b, kh * g, 1, d), kd,
                                     vd, mask, g)
    if dtype == torch.bfloat16:
        n = DA.n_split(qd, bt.shape[1] * PS, paged=True)
        if sweep:
            split_sweep(timer, lambda: PD.paged_decode_attention(
                qd, kpg, vpg, bt, pos), n, f"paged decode D={d} {b} slots")
        body = f"{n} pieces per (slot, kv head) in the launch"
    else:
        body = (f"{fp32_pieces(bt.shape[1] * PS)} pieces of {PIECE_ROWS} "
                "rows per (slot, kv head) in the launch, each slot its own")
    return dict(
        name=name + sfx, route="cuda", source=ATTN_SRC,
        replaces="src/repro/kernels/paged_decode_attention.py:73",
        ms=timer(lambda: PD.paged_decode_attention(qd, kpg, vpg, bt, pos)),
        plain_ms=timer(lambda: PD.paged_decode_attention_plain(
            qd, kpg, vpg, bt, pos)),
        bound_ms=bms, bound_by=bby, library_ms=min(exp_ms, gqa_ms),
        library_expanded_ms=exp_ms, library_gqa_ms=gqa_ms, max_abs_err=err,
        shape=f"{what}{b} slots contexts {CONTEXTS} K={kh} G={g} "
              f"n_b={bt.shape[1]} ps={PS} {tag}, {body}")


def dense_row(timer, name, dtype, inputs, err, *, what: str = "",
              sweep: bool = False) -> dict:
    """Dense decode's kernel-table row: card ms, plain ms and SDPA (masked
    by the attended positions, expanded and with ``enable_gqa``) on
    ``inputs``, beside the bound; ``sweep`` also times bf16 over forced
    piece counts."""
    from repro_torch.kernels import decode_attention as DA
    sfx, tag = _dt_suffix(dtype)
    qd, kc, vc, kvpos, pos = inputs
    b, kh, g, d = qd.shape
    nb, no = dense_cost(qd, kvpos, pos, dtype)
    bms, bby = bound_ms(nb, no, dtype)
    att = (kvpos >= 0) & (kvpos <= pos[:, None])
    exp_ms, gqa_ms = sdpa_yardsticks(
        timer, qd.reshape(b, kh * g, 1, d), kc.transpose(1, 2).contiguous(),
        vc.transpose(1, 2).contiguous(), att[:, None, None, :], g)
    if dtype == torch.bfloat16:
        n = DA.n_split(qd, kc.shape[1])
        if sweep:
            split_sweep(timer, lambda: DA.decode_attention(
                qd, kc, vc, kvpos, pos), n, f"dense decode D={d} {b} slots")
        body = f"{n} pieces per (slot, kv head)"
    else:
        body = (f"{fp32_pieces(kc.shape[1])} pieces of {PIECE_ROWS} rows "
                "per (slot, kv head)")
    return dict(
        name=name + sfx, route="cuda", source=ATTN_SRC,
        replaces="src/repro/kernels/decode_attention.py:62",
        ms=timer(lambda: DA.decode_attention(qd, kc, vc, kvpos, pos)),
        plain_ms=timer(lambda: DA.decode_attention_plain(
            qd, kc, vc, kvpos, pos)),
        bound_ms=bms, bound_by=bby, library_ms=min(exp_ms, gqa_ms),
        library_expanded_ms=exp_ms, library_gqa_ms=gqa_ms, max_abs_err=err,
        shape=f"{what}{b} slots x S={kc.shape[1]} rows, pos "
              f"{pos.tolist()} ({int(att.sum())} attended rows), K={kh} "
              f"G={g} D={d} {tag}, {body}")


def _sweep_fused(fused, args, outs, shares, what: str):
    """``fused(*args, decode_share=share)`` at every share, each result
    bit-equal to ``outs`` (flash + the decode kernel launched apart).
    Returns the last result."""
    for share in shares:
        got = fused(*args, decode_share=share)
        torch.cuda.synchronize()
        check(torch.equal(got[0], outs[0]) and torch.equal(got[1], outs[1]),
              f"{what} share {share}: not bit-equal to flash + decode")
    return got


def _fused_err(got, ref, act, dtype, what: str) -> float:
    """max|kernel - plain| of a fused launch (the decode side on its
    slots ``act``), within TOL."""
    e = max((got[0].float() - ref[0].float()).abs().max().item(),
            (got[1][act].float() - ref[1][act].float()).abs().max().item())
    check(math.isfinite(e) and e <= TOL[dtype], f"{what}: {e}")
    return e


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    card = res.stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"SMs {torch.cuda.get_device_properties(0).multi_processor_count}")
    return card


def ptxas_report(text: str):
    """(kernel, registers, spill stores, spill loads, shared bytes) per
    kernel entry, from ``nvcc -Xptxas -v``'s report."""
    rows, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"kernel": m.group(1), "spill_st": 0, "spill_ld": 0,
                   "smem": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_st"], cur["spill_ld"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(m.group(1)) if m else 0
    return rows


def demangled(names):
    """The kernels' C++ names through c++filt where the toolkit's host has
    it (a report nicety: the mangled names name the same kernels)."""
    tool = shutil.which("c++filt")
    if tool is None:
        return list(names)
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) \
        else list(names)


def phase_build():
    from repro_torch.kernels import build
    b = build.build()
    log(f"build: {b.seconds:.1f} s (one nvcc per source, in parallel) -> "
        f"{os.path.relpath(b.path, ROOT)}")
    report = ptxas_report(b.log)
    for r, name in zip(report, demangled([r["kernel"] for r in report])):
        log(f"  ptxas {name}: {r.get('regs')} registers, "
            f"{r['spill_st']} B spill stores, {r['spill_ld']} B spill loads, "
            f"{r['smem']} B static smem")
    # the bf16 paged fused kernel runs the split body at two CTAs an SM:
    # it must fit its 128 registers without spilling, at every head dim
    fused = [r for r in report if "bullet_tc_kernel" in r["kernel"]
             and "10DecodeArgs" in r["kernel"]]
    check(len(fused) == len(build.PAGED_HEAD_DIMS)
          and all(r["spill_st"] == 0 and r["spill_ld"] == 0 for r in fused),
          f"bullet_tc_kernel<D, DecodeArgs> spills: {fused}")
    # no fp32 attention kernel may spill: the register-tiled flash body
    # (standalone and in both fused kernels) and the fp32 split decode body
    fp32 = [r for r in report if any(k in r["kernel"] for k in (
        "flash_rt_kernel", "decode_kernelIf", "bullet_kernelIf"))]
    want = 2 * len(build.HEAD_DIMS) + 3 * len(build.PAGED_HEAD_DIMS)
    check(len(fp32) == want
          and all(r["spill_st"] == 0 and r["spill_ld"] == 0 for r in fp32),
          f"fp32 attention kernels ({len(fp32)} of {want}) spill: {fp32}")
    # nor may kernel 1's fp32 backward (its 8 x 8 blocks of a score and an
    # accumulator product a thread) or the fp32 training forward
    bwd = [r for r in report if any(k in r["kernel"] for k in (
        "flash_bwd_rt_kernel", "flash_rt_lse_kernel"))]
    check(len(bwd) == 2 * len(build.BWD_HEAD_DIMS)
          and all(r["spill_st"] == 0 and r["spill_ld"] == 0 for r in bwd),
          f"fp32 backward kernels ({len(bwd)} of "
          f"{2 * len(build.BWD_HEAD_DIMS)}) spill: {bwd}")
    # no SSD kernel may spill: the bf16 body keeps its accumulators in
    # registers across each product
    ssd = [r for r in report if any(k in r["kernel"] for k in SSD_KERNELS)]
    check(all(any(k in r["kernel"] for r in ssd) for k in SSD_KERNELS),
          f"SSD kernels missing from ptxas's report: {ssd}")
    spilled = [r for r in ssd if r["spill_st"] or r["spill_ld"]]
    check(not spilled, f"SSD kernels spill: {spilled}")
    build.library()
    return b


def phase_kernels(timer: Timer):
    from repro_torch.core.estimator import HardwareSpec
    from repro_torch.core.resource import ResourceManager
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = {}

    def worst(key, e):
        err[key] = max(err.get(key, 0.0), e)

    # -- flash: S in {128, 200, 1000}, Bp in {1, 4}, plus a window case
    for dtype in (torch.float32, torch.bfloat16):
        for bp in (1, 4):
            for s, window in ((128, 0), (200, 0), (1000, 0), (200, 17)):
                e, _ = flash_check(gen, bp, s, dtype, window=window)
                worst(("flash", dtype), e)

    # -- paged decode: 8 slots, mixed contexts, inactive slot, trash page;
    # in bf16 (the split body) at page sizes 8 and 32 besides the served 16
    for dtype, ps in ((torch.float32, PS), (torch.bfloat16, PS),
                      (torch.bfloat16, 8), (torch.bfloat16, 32)):
        e, _ = paged_check(gen, dtype, ps=ps)
        worst(("decode", dtype), e)

    # -- dense decode: 8 slots over MAX_LEN rows, linear and ring positions
    for dtype in (torch.float32, torch.bfloat16):
        for ring in (False, True):
            e = dense_check(dense_inputs(gen, dtype, ring), dtype,
                            "ring with holes" if ring else "linear")
            worst(("dense", dtype), e)

    # -- bullet: every decode_share of the tile table, bit-equal
    rm = ResourceManager(HardwareSpec(), SchedulerConfig().unit_quantum)
    shares = sorted({round(p.decode_share, 6) for p in rm.tile_entries})
    for dtype in (torch.float32, torch.bfloat16):
        qp, kpp, vpp = flash_inputs(gen, 2, 200, dtype)
        dec = decode_inputs(gen, dtype)
        fo = FA.flash_attention(qp, kpp, vpp, causal=True, group=G)
        do = PD.paged_decode_attention(*dec)
        got = _sweep_fused(
            functools.partial(BA.bullet_attention_paged, group=G),
            (qp, kpp, vpp, *dec), (fo, do), shares, f"bullet {dtype}")
        err[("bullet", dtype)] = e = _fused_err(
            got, BA.bullet_attention_paged_plain(qp, kpp, vpp, *dec, group=G),
            dec[4] >= 0, dtype, f"bullet {dtype}")
        log(f"bullet {str(dtype)[6:]}: bit-equal to flash + paged decode at "
            f"all {len(shares)} tile-table shares; max|kernel-plain| = "
            f"{e:.3e}")
    for dtype in (torch.float32, torch.bfloat16):
        qp, kpp, vpp = flash_inputs(gen, 2, 200, dtype)
        fo = FA.flash_attention(qp, kpp, vpp, causal=True, group=G)
        for ring in (False, True):
            dec = dense_inputs(gen, dtype, ring)
            got = _sweep_fused(
                functools.partial(BA.bullet_attention, group=G),
                (qp, kpp, vpp, *dec), (fo, DA.decode_attention(*dec)),
                shares, f"dense bullet {dtype} ring={ring}")
        err[("bullet_dense", dtype)] = e = _fused_err(
            got, BA.bullet_attention_plain(qp, kpp, vpp, *dec, group=G),
            attended(dec[3], dec[4]), dtype, f"dense bullet {dtype}")
        log(f"dense bullet {str(dtype)[6:]}: bit-equal to flash + dense decode "
            f"at all {len(shares)} tile-table shares, linear and ring; "
            f"max|kernel-plain| = {e:.3e}")

    # -- the SM partition of both fused kernels, from the launch's record,
    # at the serving shape: the longest prompt and the 8-slot decode batch
    for dtype in (torch.float32, torch.bfloat16):
        qp, kpp, vpp = flash_inputs(gen, 1, MAX_LEN, dtype)
        fo = FA.flash_attention(qp, kpp, vpp, group=G)
        dec = {"paged": decode_inputs(gen, dtype),
               "dense": dense_inputs(gen, dtype, False)}
        for kind, args in dec.items():
            fused = (BA.bullet_attention_paged if kind == "paged"
                     else BA.bullet_attention)
            do = (PD.paged_decode_attention(*args) if kind == "paged"
                  else DA.decode_attention(*args))
            for share in (0.0, 0.25, 0.5, 0.75, 1.0):
                op, od, sched = fused(qp, kpp, vpp, *args,
                                      decode_share=share, group=G,
                                      record=True)
                torch.cuda.synchronize()
                what = f"{kind} bullet {str(dtype)[6:]} share {share}"
                check(torch.equal(op, fo) and torch.equal(od, do),
                      f"{what}: not bit-equal to flash + decode")
                log(f"{what} at the serving shape: "
                    f"{schedule_gate(sched, what)}")

    # -- timings at the serving shapes: bf16 (the bodies the served model
    # runs) and fp32 (the CUDA-core bodies, which the fp32 replays
    # and references run)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        rows += _timed_d128(timer, gen, dt, err, rm)
    for r in rows:
        log_row(r)
    return rows


def _timed_d128(timer, gen, dt, err, rm) -> list:
    """Kernels 1-5 timed at D=128 in ``dt``: the longest prompt of the serve
    phase, its 8-slot decode batch, and the two fused. The fp32 rows are
    named with a ``_fp32`` suffix."""
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD

    bf16 = dt == torch.bfloat16
    sfx, tag = _dt_suffix(dt)
    rows = []

    q, k, v = flash_inputs(gen, 1, 1000, dt)
    rows.append(flash_row(timer, "flash_attention", dt, (q, k, v),
                          err[("flash", dt)], 1, 1000))
    nb, no = flash_cost(1, 1000, dt, h=H, kh=K, d=D)
    qd, kpg, vpg, bt, pos = paged_in = decode_inputs(gen, dt)
    rows.append(paged_row(timer, "paged_decode_attention", dt, paged_in,
                          err[("decode", dt)], sweep=True))
    nb_d, no_d = decode_cost(qd, pos, dt, PS)
    qdd, kc, vc, kvpos, posd = dense_in = dense_inputs(gen, dt, False)
    rows.append(dense_row(timer, "decode_attention", dt, dense_in,
                          err[("dense", dt)], what="linear positions, ",
                          sweep=True))
    nb_dd, no_dd = dense_cost(qdd, kvpos, posd, dt)

    share = round(rm.current.decode_share, 6)
    code = 1 if bf16 else 0
    # one function over both phases' inputs: max(sum of bytes / rate,
    # sum of operations / peak)
    bms, bby = bound_ms(nb + nb_d, no + no_d, dt)
    n_sm = DA.sm_count(torch.cuda.current_device())
    n_dec_sm = BA.decode_sms(share, n_sm, True, True)
    n_ctas = BA.grid_ctas(torch.cuda.current_device(), code, D, G, PS)
    apart = timer(lambda: (FA.flash_attention(q, k, v, group=G),
                           PD.paged_decode_attention(qd, kpg, vpg, bt, pos)))

    def fused_at(x):
        return timer(lambda: BA.bullet_attention_paged(
            q, k, v, qd, kpg, vpg, bt, pos, decode_share=x, group=G))
    sweep = ", ".join(f"{x}: {fused_at(x):.4f}" for x in SWEEP_SHARES)
    log(f"bullet_attention_paged{sfx} at the serving shape, card ms by "
        f"decode_share: {sweep}; flash + paged decode launched apart "
        f"{apart:.4f}")
    rows.append(dict(
        name="bullet_attention_paged" + sfx, route="cuda", source=ATTN_SRC,
        replaces="src/repro/kernels/bullet_attention.py:260",
        ms=timer(lambda: BA.bullet_attention_paged(
            q, k, v, qd, kpg, vpg, bt, pos, decode_share=share, group=G)),
        plain_ms=timer(lambda: BA.bullet_attention_paged_plain(
            q, k, v, qd, kpg, vpg, bt, pos, group=G)),
        bound_ms=bms, bound_by=bby, library_ms=None,
        max_abs_err=err[("bullet", dt)],
        shape=f"flash Bp=1 S=1000 + decode as above, decode_share={share}: "
              f"{n_dec_sm} of {n_sm} SMs decode first, {n_ctas} CTAs, {tag}"))
    bms, bby = bound_ms(nb + nb_dd, no + no_dd, dt)
    n_ctas = BA.grid_ctas(torch.cuda.current_device(), code, D, G, PS,
                          dense=True)
    rows.append(dict(
        name="bullet_attention" + sfx, route="cuda", source=ATTN_SRC,
        replaces="src/repro/kernels/bullet_attention.py:361",
        ms=timer(lambda: BA.bullet_attention(
            q, k, v, qdd, kc, vc, kvpos, posd, decode_share=share, group=G)),
        plain_ms=timer(lambda: BA.bullet_attention_plain(
            q, k, v, qdd, kc, vc, kvpos, posd, group=G)),
        bound_ms=bms, bound_by=bby, library_ms=None,
        max_abs_err=err[("bullet_dense", dt)],
        shape=f"flash Bp=1 S=1000 + dense decode as above, decode_share="
              f"{share}: {n_dec_sm} of {n_sm} SMs decode first, {n_ctas} "
              f"CTAs, {tag}"))
    return rows


def phase_ssd(timer: Timer) -> list:
    """The SSD chunk scan kernel against its plain version at Mamba-2-2.7B's
    shapes, fp32 and bf16, one prompt (B=1) and a full prefill batch
    (B=4), S=1000 (four chunks, the last padded) and S=200 (one chunk of
    Q=S rows): y and the final state; the bf16 body also against its plain
    mirror. Timed at B=1, S=1000 in both dtypes (rows ``ssd_scan`` and
    ``ssd_scan_fp32``), and in bf16 at each P slice of the output kernel."""
    from repro_torch.kernels import geometry
    from repro_torch.kernels import ssd_scan as SK

    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 4):
            for s in (1000, 200):
                worst[dtype] = max(worst.get(dtype, 0.0),
                                   ssd_check(gen, b, s, dtype))
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        xw, cum, bm, cm = ssd_inputs(gen, 1, 1000, dtype)
        nb, no = ssd_cost(xw, dtype, SSD_N)
        bms, bby = bound_ms(nb, no, dtype)
        ms = timer(lambda: SK.ssd_scan(xw, cum, bm, cm))
        plain = timer(lambda: SK.ssd_scan_plain(xw, cum, bm, cm))
        tag = str(dtype)[6:]
        log(f"ssd_scan {tag} B=1 S=1000: {ms:.4f} ms (plain {plain:.4f}, "
            f"library none, bound {bms:.4f} ms by {bby}: {nb / 1e6:.1f} MB, "
            f"{no / 1e9:.2f} GFLOP)")
        if dtype == torch.bfloat16:
            sweep = ", ".join(
                f"{w}: " + format(timer(lambda w=w: SK.ssd_scan(
                    xw, cum, bm, cm, p_slice=w)), ".4f")
                for w in geometry.SSD_P_SLICES)
            log(f"ssd_scan bf16 B=1 S=1000, ms by P slice of the output "
                f"kernel (the build's SSD_P_SLICE is "
                f"{geometry.SSD_P_SLICE}): {sweep}")
        rows.append(dict(
            name="ssd_scan" if dtype == torch.bfloat16 else "ssd_scan_fp32",
            route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:66",
            ms=ms, plain_ms=plain, bound_ms=bms, bound_by=bby,
            library_ms=None, max_abs_err=worst[dtype],
            shape=f"B=1 S=1000 (NC=4 Q=256) H={SSD_H} P={SSD_P} N={SSD_N} "
                  f"{tag}"))
    return rows


def phase_rglru(timer: Timer) -> dict:
    """The RG-LRU scan kernel against its plain version at RecurrentGemma's
    width W = 2560: one prompt (B=1) and a prefill batch (B=4), S=3000 and
    S=200, from zeros and from a given h0, fp32 and bf16 inputs: y and h_T.
    Timed at B=4, S=3000 in fp32, the dtype the model's gates hand it."""
    from repro_torch.kernels import rglru_scan as RK

    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 4):
            for s in (3000, 200):
                for with_h0 in (False, True):
                    a = torch.sigmoid(torch.randn(
                        b, s, RG_W, generator=gen, device="cuda")).to(dtype)
                    bb = torch.randn(b, s, RG_W, generator=gen,
                                     device="cuda").to(dtype)
                    h0 = (torch.randn(b, RG_W, generator=gen, device="cuda")
                          if with_h0 else None)
                    y, h = RK.rglru_scan(a, bb, h0)
                    ry, rh = RK.rglru_scan_plain(a, bb, h0)
                    torch.cuda.synchronize()
                    check(y.dtype == dtype and h.dtype == torch.float32,
                          f"rglru_scan {dtype}: output dtypes {y.dtype}/"
                          f"{h.dtype}")
                    ey, eh = rel_err(y, ry), rel_err(h, rh)
                    check(math.isfinite(ey) and ey <= RG_TOL[dtype]
                          and math.isfinite(eh) and eh <= RG_STATE_TOL,
                          f"rglru_scan {dtype} B={b} S={s} h0={with_h0}: y "
                          f"err {ey}, h_T err {eh}")
                    ea = (y.float() - ry.float()).abs().max().item()
                    worst[dtype] = max(worst.get(dtype, 0.0), ea)
                    log(f"rglru_scan {str(dtype)[6:]} B={b} S={s} W={RG_W} "
                        f"h0={'given' if with_h0 else 'zeros'}: "
                        f"max|kernel-plain|/scale y {ey:.3e}, h_T {eh:.3e}; "
                        f"bit-equal {torch.equal(y, ry) and torch.equal(h, rh)}")
    dtype = torch.float32
    a = torch.sigmoid(torch.randn(4, 3000, RG_W, generator=gen,
                                  device="cuda"))
    bb = torch.randn(4, 3000, RG_W, generator=gen, device="cuda")
    nb, no = rglru_cost(a, dtype)
    bms, bby = bound_ms(nb, no, dtype)
    ms = timer(lambda: RK.rglru_scan(a, bb))
    plain = timer(lambda: RK.rglru_scan_plain(a, bb))
    log(f"rglru_scan fp32 B=4 S=3000 W={RG_W}: {ms:.4f} ms (plain "
        f"{plain:.4f}, library none, bound {bms:.4f} ms by {bby}: "
        f"{nb / 1e6:.1f} MB)")
    return dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:37",
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=bby, library_ms=None,
        max_abs_err=max(worst.values()),
        shape=f"B=4 S=3000 W={RG_W} fp32 (the model's gates are fp32)")


def row_ulps(out, ref) -> float:
    """max|out - ref| over each row (the last dim), in bf16 ulps of the
    row's own scale max|ref_row| (an ulp of x is 2^(floor(log2 x) - 7));
    the largest over the rows."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    scale = ref.abs().amax(-1).clamp(min=2.0 ** -100)
    return (err / torch.exp2(torch.floor(torch.log2(scale)) - 7)).max().item()


def phase_attention_d256(timer: Timer) -> list:
    """Kernels 1 and 4 at the RecurrentGemma phase's shapes (H=10 on K=1,
    so G=10, D=256): flash prefill over a padded batch of 4 rows of
    S=3000 (q (40, 3000, 256), k/v (4, 3000, 256), so every row reaches
    its own kv head) with the 2048-token window, causal, and dense decode
    over 4 slots of the 2048-row ring, which has wrapped for the slots past
    position 2047 and still holds holes (-1) for the others. Against the
    plain versions within TOL, and in bf16 also within RG_ATTN_ULPS bf16
    ulps of each output row's scale; each bf16 check also prints what a wrong
    result reads in those units (flash with the window one key short,
    decode without the newest key). Timed in bf16 at the same shapes,
    beside SDPA."""
    from repro_torch.models.transformer import _kv_positions

    gen = torch.Generator(device="cuda").manual_seed(8)
    bp, s, g = 4, 3000, RG_H // RG_K
    #: decode positions after prefills of 3000, 2300, 1200, 300 tokens and
    #: 40 decode steps: two rings wrapped, two with holes
    dpos = torch.tensor([3039, 2339, 1239, 339], dtype=torch.int32,
                        device="cuda")
    kvpos = _kv_positions(dpos, RG_WINDOW, True)     # the model's ring map
    err, inputs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        err[("flash", dtype)], inputs[("flash", dtype)] = flash_check(
            gen, bp, s, dtype, h=RG_H, kh=RG_K, d=RG_D, window=RG_WINDOW,
            what="D=256 ")
        inputs[("decode", dtype)] = (
            rn(bp, RG_K, g, RG_D), rn(bp, RG_WINDOW, RG_K, RG_D),
            rn(bp, RG_WINDOW, RG_K, RG_D), kvpos, dpos)
        err[("decode", dtype)] = dense_check(
            inputs[("decode", dtype)], dtype, f"{RG_WINDOW}-row ring")

    # timed in bf16 (the served model's bodies) and fp32 (the first
    # CUDA-core bodies, which the fp32 reference runs)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        rows.append(flash_row(timer, "flash_attention_d256", dt,
                              inputs[("flash", dt)], err[("flash", dt)], bp,
                              s, h=RG_H, kh=RG_K, d=RG_D, window=RG_WINDOW))
        rows.append(dense_row(timer, "decode_attention_d256", dt,
                              inputs[("decode", dt)], err[("decode", dt)],
                              what=f"{RG_WINDOW}-row ring, ", sweep=True))
    for r in rows:
        log_row(r)
    return rows


#: the attention shapes the mixture-of-experts slice and the Qwen1.5
#: configs bring, all at D = 128: Mixtral-8x22B's 48 query heads on 8 kv
#: heads (G = 6) with its 4096-token window (a prompt of MX_S tokens, and
#: a dense ring of MX_WINDOW rows, wrapped, at the decode positions
#: MX_DPOS: 4 slots after prefills of about 4200, 1500, 600 and 64 tokens
#: and 40 decode steps), Llama-4 Maverick's 40 on 8 (G = 5), Qwen1.5-4B's
#: 20 on 20 (G = 1)
MX_H, MX_K, MX_WINDOW, MX_S = 48, 8, 4096, 4200
MX_DPOS = (4239, 1539, 639, 103)
L4_H, L4_K = 40, 8
Q15_H = 20
#: InternVL2-76B's 64 query heads on 8 kv heads (G = 8) and the patches
#: its stub frontend prepends to each prompt
IV_H, IV_K, IV_PATCHES = 64, 8, 256


def phase_attention_moe(timer: Timer) -> list:
    """Kernels 1-4 at the shapes the MoE slice and the Qwen1.5 configs
    serve, each against its plain version (fp32 and bf16; bf16 also per
    output row within RG_ATTN_ULPS) and timed in both dtypes beside its
    bound and SDPA: flash over one Mixtral prompt of MX_S tokens (G = 6,
    the 4096-token window, first run at D = 128) and dense decode over 4
    slots of its wrapped 4096-row ring; Llama-4's paged decode (G = 5) and
    its paged fused kernel, bit-equal to flash + paged decode at every
    decode_share of the tile table; Qwen1.5-4B's flash and paged decode
    (G = 1, the first multi-head model the kernels serve); InternVL2-76B's
    (G = 8) flash over the internvl phase's padded prefill batch and dense
    decode over its slot cache at the last decode step (checked, not
    timed)."""
    from repro_torch.core.estimator import HardwareSpec
    from repro_torch.core.resource import ResourceManager
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.models.transformer import _kv_positions

    gen = torch.Generator(device="cuda").manual_seed(23)
    g6, g5 = MX_H // MX_K, L4_H // L4_K
    dpos = torch.tensor(MX_DPOS, dtype=torch.int32, device="cuda")
    kvpos = _kv_positions(dpos, MX_WINDOW, True)      # the model's ring map
    rm = ResourceManager(HardwareSpec(), SchedulerConfig().unit_quantum)
    shares = sorted({round(p.decode_share, 6) for p in rm.tile_entries})
    err, inp = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        # -- Mixtral: windowed flash, and dense decode over the wrapped ring
        err["mx_flash", dtype], inp["mx_flash", dtype] = flash_check(
            gen, 1, MX_S, dtype, h=MX_H, kh=MX_K, window=MX_WINDOW,
            what="mixtral-8x22b ")
        b = len(MX_DPOS)
        inp["mx_dense", dtype] = (rn(b, MX_K, g6, D), rn(b, MX_WINDOW, MX_K, D),
                                  rn(b, MX_WINDOW, MX_K, D), kvpos, dpos)
        err["mx_dense", dtype] = dense_check(
            inp["mx_dense", dtype], dtype, f"mixtral-8x22b {MX_WINDOW}-row ring")

        # -- Llama-4: paged decode at G = 5, and the paged fused kernel
        # bit-equal to flash + paged decode at every tile-table share
        err["l4_decode", dtype], inp["l4_decode", dtype] = paged_check(
            gen, dtype, kh=L4_K, g=g5, what="llama4-maverick ")
        qp, kpp, vpp = inp["l4_flash", dtype] = flash_inputs(
            gen, 1, MAX_LEN, dtype, L4_H, L4_K)
        dec = inp["l4_decode", dtype]
        fo = FA.flash_attention(qp, kpp, vpp, causal=True, group=g5)
        got = _sweep_fused(
            functools.partial(BA.bullet_attention_paged, group=g5),
            (qp, kpp, vpp, *dec), (fo, PD.paged_decode_attention(*dec)),
            shares, f"bullet llama4-maverick {dtype}")
        err["l4_bullet", dtype] = e = _fused_err(
            got, BA.bullet_attention_paged_plain(qp, kpp, vpp, *dec,
                                                 group=g5),
            dec[4] >= 0, dtype, f"bullet llama4-maverick {dtype}")
        log(f"bullet llama4-maverick {_dt_name(dtype)} (H={L4_H} K={L4_K}): "
            f"bit-equal to flash + paged decode at all {len(shares)} "
            f"tile-table shares; max|kernel-plain| = {e:.3e}")

        # -- Qwen1.5-4B: multi-head flash and paged decode, G = 1
        err["q15_flash", dtype], inp["q15_flash", dtype] = flash_check(
            gen, 1, MAX_LEN, dtype, h=Q15_H, kh=Q15_H, what="qwen1.5-4b ")
        err["q15_decode", dtype], inp["q15_decode", dtype] = paged_check(
            gen, dtype, kh=Q15_H, g=1, what="qwen1.5-4b ")

    # -- InternVL2-76B: IV_PATCHES patches before each of IV_PROMPTS, one
    # padded batch, and the slot cache of the internvl phase at its last
    # step (a generator of its own: the rows above keep their inputs)
    ivgen = torch.Generator(device="cuda").manual_seed(76)
    b, s_iv = len(IV_PROMPTS), IV_PATCHES + max(IV_PROMPTS)
    n_rows = s_iv + IV_DECODE
    ivpos = torch.tensor([IV_PATCHES + n + IV_DECODE - 1 for n in IV_PROMPTS],
                         dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        def rn(*shape):
            return torch.randn(*shape, generator=ivgen,
                               device="cuda").to(dtype)
        flash_check(ivgen, b, s_iv, dtype, h=IV_H, kh=IV_K,
                    what="internvl2-76b ")
        dense_check((rn(b, IV_K, IV_H // IV_K, D), rn(b, n_rows, IV_K, D),
                     rn(b, n_rows, IV_K, D),
                     _kv_positions(ivpos, n_rows, False), ivpos), dtype,
                    f"internvl2-76b {n_rows}-row slot cache")

    share = round(rm.current.decode_share, 6)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        sfx, tag = _dt_suffix(dt)
        rows.append(flash_row(timer, "flash_attention_mixtral", dt,
                              inp["mx_flash", dt], err["mx_flash", dt], 1,
                              MX_S, h=MX_H, kh=MX_K, window=MX_WINDOW,
                              what="mixtral-8x22b: "))
        rows.append(dense_row(timer, "decode_attention_mixtral", dt,
                              inp["mx_dense", dt], err["mx_dense", dt],
                              what=f"mixtral-8x22b {MX_WINDOW}-row ring: "))
        rows.append(paged_row(timer, "paged_decode_attention_llama4", dt,
                              inp["l4_decode", dt], err["l4_decode", dt],
                              what="llama4-maverick: "))
        qp, kpp, vpp = inp["l4_flash", dt]
        qd, kpg, vpg, bt, pos = inp["l4_decode", dt]
        nb_p, no_p = flash_cost(1, MAX_LEN, dt, h=L4_H, kh=L4_K, d=D)
        nb_d, no_d = decode_cost(qd, pos, dt, PS)
        bms, bby = bound_ms(nb_p + nb_d, no_p + no_d, dt)
        n_sm = DA.sm_count(torch.cuda.current_device())
        n_ctas = BA.grid_ctas(torch.cuda.current_device(),
                              int(dt == torch.bfloat16), D, g5, PS)
        rows.append(dict(
            name="bullet_attention_paged_llama4" + sfx, route="cuda",
            source=ATTN_SRC,
            replaces="src/repro/kernels/bullet_attention.py:260",
            ms=timer(lambda: BA.bullet_attention_paged(
                qp, kpp, vpp, qd, kpg, vpg, bt, pos, decode_share=share,
                group=g5)),
            plain_ms=timer(lambda: BA.bullet_attention_paged_plain(
                qp, kpp, vpp, qd, kpg, vpg, bt, pos, group=g5)),
            bound_ms=bms, bound_by=bby, library_ms=None,
            max_abs_err=err["l4_bullet", dt],
            shape=f"llama4-maverick: flash Bp=1 S={MAX_LEN} H={L4_H} "
                  f"K={L4_K} + paged decode as its row, decode_share={share}"
                  f": {BA.decode_sms(share, n_sm, True, True)} of {n_sm} SMs "
                  f"decode first, {n_ctas} CTAs, {tag}"))
        rows.append(flash_row(timer, "flash_attention_qwen15", dt,
                              inp["q15_flash", dt], err["q15_flash", dt], 1,
                              MAX_LEN, h=Q15_H, kh=Q15_H,
                              what="qwen1.5-4b: "))
        rows.append(paged_row(timer, "paged_decode_attention_qwen15", dt,
                              inp["q15_decode", dt], err["q15_decode", dt],
                              what="qwen1.5-4b: "))
    for r in rows:
        log_row(r)
    return rows


#: head dim 64: Granite-3.0-2B's attention (32 query heads on 8 kv heads,
#: G = 4) and SeamlessM4T-Large-v2's (16 on 16, G = 1) over its SM_SE stub
#: frames (the encoder's length and the cross cache's rows)
D64, GR_H, GR_K = 64, 32, 8
SM_H, SM_SE = 16, 1024
#: the Seamless phase's rows: decoder prompts and greedy decode steps
SM_PROMPTS, SM_DECODE = (8, 16, 32, 64), 64


def phase_attention_d64(timer: Timer):
    """The D = 64 instances of kernels 1-5, fp32 and bf16, each against
    its plain version (bf16 also per output row within RG_ATTN_ULPS) at
    the shapes the head-dim-64 models serve, timed beside its bound and
    SDPA: Granite's causal flash over one prompt of MAX_LEN tokens (G = 4)
    and its paged decode over the 8 slots of CONTEXTS; Seamless's encoder
    flash, non-causal, over 4 rows of SM_SE frames (G = 1), its
    cross-attention flash (Sq = 64 prompt rows over the SM_SE encoder
    rows, non-causal: checked, not timed) and its cross decode, kernel 4
    over 4 slots of SM_SE rows all attended; both fused kernels bit-equal
    to flash + their decode kernel at every decode_share of the tile table
    (Granite's prompt with its paged decode, and with dense decode over 8
    slots of MAX_LEN rows), the paged one's SM partition read from its
    record at shares 0.25 and 0.75. Returns (rows, the dense fused
    kernel's launches in each dtype's share sweep: no serving path runs
    it, as at D = 128)."""
    from repro_torch.core.estimator import HardwareSpec
    from repro_torch.core.resource import ResourceManager
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD

    gen = torch.Generator(device="cuda").manual_seed(64)
    g4 = GR_H // GR_K
    rm = ResourceManager(HardwareSpec(), SchedulerConfig().unit_quantum)
    shares = sorted({round(p.decode_share, 6) for p in rm.tile_entries})
    dev = torch.cuda.current_device()
    err, inp, dense_launches = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        # -- Granite: causal flash (G = 4) and paged decode
        err["gr_flash", dtype], inp["gr_flash", dtype] = flash_check(
            gen, 1, MAX_LEN, dtype, h=GR_H, kh=GR_K, d=D64,
            what="granite-3-2b ")
        err["gr_decode", dtype], inp["gr_decode", dtype] = paged_check(
            gen, dtype, kh=GR_K, g=g4, d=D64, what="granite-3-2b ")
        # -- Seamless: the encoder's non-causal flash (G = 1), the
        # cross-attention's (a 64-token prompt over SM_SE rows) and the
        # cross decode over SM_SE rows, every one attended
        err["sm_flash", dtype], inp["sm_flash", dtype] = flash_check(
            gen, 4, SM_SE, dtype, h=SM_H, kh=SM_H, d=D64, causal=False,
            what="seamless encoder ")
        flash_check(gen, 4, 64, dtype, h=SM_H, kh=SM_H, d=D64,
                    causal=False, sk=SM_SE, what="seamless cross-attention ")
        b = 4
        kvpos = torch.arange(SM_SE, dtype=torch.int32, device="cuda")[
            None].expand(b, SM_SE).contiguous()
        inp["sm_cross", dtype] = (
            rn(b, SM_H, 1, D64), rn(b, SM_SE, SM_H, D64),
            rn(b, SM_SE, SM_H, D64), kvpos,
            torch.full((b,), SM_SE - 1, dtype=torch.int32, device="cuda"))
        err["sm_cross", dtype] = dense_check(
            inp["sm_cross", dtype], dtype,
            f"seamless cross-attention, {SM_SE} rows all attended,")

        # -- the paged fused kernel: Granite's prompt and paged decode,
        # bit-equal at every share, the SM partition from its record
        qp, kpp, vpp = inp["gr_flash", dtype]
        dec = inp["gr_decode", dtype]
        fo = FA.flash_attention(qp, kpp, vpp, causal=True, group=g4)
        do = PD.paged_decode_attention(*dec)
        got = _sweep_fused(
            functools.partial(BA.bullet_attention_paged, group=g4),
            (qp, kpp, vpp, *dec), (fo, do), shares,
            f"bullet granite-3-2b {dtype}")
        err["gr_bullet", dtype] = _fused_err(
            got, BA.bullet_attention_paged_plain(qp, kpp, vpp, *dec,
                                                 group=g4),
            dec[4] >= 0, dtype, f"bullet granite-3-2b {dtype}")
        for share in (0.25, 0.75):
            op, od, sched = BA.bullet_attention_paged(
                qp, kpp, vpp, *dec, decode_share=share, group=g4,
                record=True)
            torch.cuda.synchronize()
            what = f"paged bullet D=64 {_dt_name(dtype)} share {share}"
            check(torch.equal(op, fo) and torch.equal(od, do),
                  f"{what}: not bit-equal to flash + decode")
            log(f"{what} at granite's shape: {schedule_gate(sched, what)}")
        code = int(dtype == torch.bfloat16)
        log(f"bullet granite-3-2b {_dt_name(dtype)} (H={GR_H} K={GR_K} "
            f"D={D64}): bit-equal to flash + paged decode at all "
            f"{len(shares)} tile-table shares; max|kernel-plain| = "
            f"{err['gr_bullet', dtype]:.3e}; "
            f"{BA.grid_ctas(dev, code, D64, g4, PS)} CTAs a wave (D=128: "
            f"{BA.grid_ctas(dev, code, D, g4, PS)})")

        # -- the dense fused kernel: Granite's prompt with dense decode over
        # 8 slots of MAX_LEN rows, bit-equal at every share; its launches
        # are this sweep's
        dd = inp["gr_dense", dtype] = dense_inputs(gen, dtype, False, GR_K,
                                                   g4, D64)
        ddo = DA.decode_attention(*dd)
        BA.dense_launches = 0
        got = _sweep_fused(functools.partial(BA.bullet_attention, group=g4),
                           (qp, kpp, vpp, *dd), (fo, ddo), shares,
                           f"dense bullet granite-3-2b {dtype}")
        dense_launches[dtype] = BA.dense_launches
        check(dense_launches[dtype] == len(shares),
              f"dense bullet D=64 {dtype}: {dense_launches[dtype]} launches")
        err["gr_dbullet", dtype] = _fused_err(
            got, BA.bullet_attention_plain(qp, kpp, vpp, *dd, group=g4),
            attended(dd[3], dd[4]), dtype, f"dense bullet D=64 {dtype}")
        log(f"dense bullet granite-3-2b {_dt_name(dtype)}: bit-equal to "
            f"flash + dense decode at all {len(shares)} tile-table shares; "
            f"max|kernel-plain| = {err['gr_dbullet', dtype]:.3e}")
    log(f"split decode CTAs an SM, bf16: dense D=64 "
        f"{DA.split_ctas_per_sm(dev, D64)}, D=128 "
        f"{DA.split_ctas_per_sm(dev, D)}; paged D=64 "
        f"{DA.split_ctas_per_sm(dev, D64, True)}, D=128 "
        f"{DA.split_ctas_per_sm(dev, D, True)}")

    share = round(rm.current.decode_share, 6)
    n_sm = DA.sm_count(dev)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        sfx, tag = _dt_suffix(dt)
        rows.append(flash_row(timer, "flash_attention_d64", dt,
                              inp["gr_flash", dt], err["gr_flash", dt], 1,
                              MAX_LEN, h=GR_H, kh=GR_K, d=D64,
                              what="granite-3-2b: "))
        rows.append(flash_row(timer, "flash_attention_d64_encoder", dt,
                              inp["sm_flash", dt], err["sm_flash", dt], 4,
                              SM_SE, h=SM_H, kh=SM_H, d=D64, causal=False,
                              what="seamless encoder: "))
        rows.append(paged_row(timer, "paged_decode_attention_d64", dt,
                              inp["gr_decode", dt], err["gr_decode", dt],
                              what="granite-3-2b: ", sweep=True))
        rows.append(dense_row(timer, "decode_attention_d64", dt,
                              inp["sm_cross", dt], err["sm_cross", dt],
                              what="seamless cross-attention: ", sweep=True))
        qp, kpp, vpp = inp["gr_flash", dt]
        nb_p, no_p = flash_cost(1, MAX_LEN, dt, h=GR_H, kh=GR_K,
                                d=D64)
        for kind, dec in (("paged", inp["gr_decode", dt]),
                          ("dense", inp["gr_dense", dt])):
            if kind == "paged":
                nb_d, no_d = decode_cost(dec[0], dec[4], dt, PS)
                fused, plain = BA.bullet_attention_paged, \
                    BA.bullet_attention_paged_plain
                name, key = "bullet_attention_paged_d64", "gr_bullet"
                replaces = "src/repro/kernels/bullet_attention.py:260"
            else:
                nb_d, no_d = dense_cost(dec[0], dec[3], dec[4], dt)
                fused, plain = BA.bullet_attention, BA.bullet_attention_plain
                name, key = "bullet_attention_d64", "gr_dbullet"
                replaces = "src/repro/kernels/bullet_attention.py:361"
            bms, bby = bound_ms(nb_p + nb_d, no_p + no_d, dt)
            n_ctas = BA.grid_ctas(dev, int(dt == torch.bfloat16), D64, g4,
                                  PS, dense=kind == "dense")
            rows.append(dict(
                name=name + sfx, route="cuda", source=ATTN_SRC,
                replaces=replaces,
                ms=timer(lambda: fused(qp, kpp, vpp, *dec,
                                       decode_share=share, group=g4)),
                plain_ms=timer(lambda: plain(qp, kpp, vpp, *dec, group=g4)),
                bound_ms=bms, bound_by=bby, library_ms=None,
                max_abs_err=err[key, dt],
                shape=f"granite-3-2b: flash Bp=1 S={MAX_LEN} H={GR_H} "
                      f"K={GR_K} D={D64} + {kind} decode over 8 slots, "
                      f"decode_share={share}: "
                      f"{BA.decode_sms(share, n_sm, True, True)} of {n_sm} "
                      f"SMs decode first, {n_ctas} CTAs, {tag}"))
    for r in rows:
        log_row(r)
    return rows, dense_launches


# ---------------------------------------------------------------------------
# the chunked prefill's kernels: kernel 1 at a query offset, kernel 6 from a
# starting state
# ---------------------------------------------------------------------------

#: Qwen3-1.7B's chunks (Sq query rows at the offset, over Sk keys): the
#: timed row (the last 512 tokens of an 8192-token prompt), a chunk and an
#: offset off the tiles, and keys past the chunk
CHUNK_CASES = ((512, 7680, 8192), (1000, 1000, 2000), (512, 1024, 2348))
#: (model, H, K, D, window, Sq, offset, Sk) of the other shapes, each
#: offset past its window (Granite has none)
CHUNK_SHAPES = (
    ("granite-3-2b ", GR_H, GR_K, D64, 0, 512, 3584, 4096),
    ("recurrentgemma-2b ", RG_H, RG_K, RG_D, RG_WINDOW, 512, 2560, 3072),
    ("mixtral-8x22b ", MX_H, MX_K, D, MX_WINDOW, 512, 4608, 5120))
#: the SSD scan from a state split at this row (not a multiple of SSD_Q)
SSD_SPLIT = 300


def _ssd_model_inputs(gen, b, s, dtype):
    """x, dt, A, B, C, D in the model layout at Mamba-2-2.7B's sizes (as
    ``ssd_inputs`` draws them), for ``ops.ssd_scan_op``."""
    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    u = torch.rand(SSD_H, generator=gen, device="cuda") * 0.8 + 0.1
    return (rn(b, s, SSD_H, SSD_P).to(dtype),
            torch.nn.functional.softplus(rn(b, s, SSD_H)),
            -torch.exp(torch.log(u / (1 - u))), rn(b, s, SSD_N).to(dtype),
            rn(b, s, SSD_N).to(dtype), rn(SSD_H))


def phase_chunked_kernels(timer: Timer) -> list:
    """The chunked prefill's two kernel contracts, each against its plain
    version on the card, fp32 and bf16. Kernel 1 at a query offset:
    Qwen3-1.7B's chunks of CHUNK_CASES and the shapes of CHUNK_SHAPES
    (Granite's D = 64 and G = 4, RecurrentGemma's D = 256 with G = 10 and
    its 2048 window, Mixtral's G = 6 and 4096 window), the key rows past
    each chunk at PAST_CHUNK, within TOL and in bf16 RG_ATTN_ULPS per
    output row. Kernel 6 from a random state0 at Mamba-2-2.7B's shapes
    (B 1 and 4, S 1000 and 200) within SSD_TOL / SSD_STATE_TOL, the bf16
    body also against its mirror ``ssd_scan_tc_ref(state0)`` within
    SSD_TC_TOL / SSD_TC_STATE_TOL; in fp32 the scan of S = 1000 rows
    equals the scan of its first SSD_SPLIT rows followed by the rest from
    their final state (``ops.ssd_scan_op``, each part padded to its own
    chunks), within SSD_STATE_TOL of scale. Timed: kernel 1 at
    CHUNK_CASES[0] beside SDPA with the offset-causal mask and the prefix
    copy, kernel 6 from a state at B=1 S=1000 (rows
    ``flash_attention_chunk*``, ``ssd_scan_state*``). The long-context
    prefill's own shapes too, on a generator of their own: kernel 1 over
    the padded batch of LC_PROMPTS within Qwen3-1.7B's long-context
    window, and kernel 4 over that batch's ring at its first decode step
    (the ring's positions as ``decode_step`` maps them)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SK
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(25)
    gen_lc = torch.Generator(device="cuda").manual_seed(33)
    lc_window = get_config("qwen3-1.7b").long_context_window
    lc_pos = torch.tensor(LC_PROMPTS, dtype=torch.int32, device="cuda")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        timed = None
        for sq, off, sk in CHUNK_CASES:
            e, inp = flash_check(gen, 1, sq, dtype, sk=sk, q_offset=off,
                                 what="qwen3-1.7b chunk ")
            timed = timed or (e, inp)
        for what, h, kh, d, window, sq, off, sk in CHUNK_SHAPES:
            flash_check(gen, 1, sq, dtype, h=h, kh=kh, d=d, window=window,
                        sk=sk, q_offset=off, what=what + "chunk ")
        flash_check(gen_lc, len(LC_PROMPTS), max(LC_PROMPTS), dtype,
                    window=lc_window, what="qwen3-1.7b long context ")

        def rn(*shape):
            return torch.randn(*shape, generator=gen_lc,
                               device="cuda").to(dtype)
        b = len(LC_PROMPTS)
        dense_check((rn(b, K, G, D), rn(b, lc_window, K, D),
                     rn(b, lc_window, K, D),
                     T._kv_positions(lc_pos, lc_window, True), lc_pos),
                    dtype, "qwen3-1.7b long-context ring")
        sq, off, sk = CHUNK_CASES[0]
        row = flash_row(timer, "flash_attention_chunk", dtype, timed[1],
                        timed[0], 1, sq, sk=sk, q_offset=off,
                        what="qwen3-1.7b chunk: ")
        # what ops.flash_attention_op spends making the cached K and V
        # (B, Sk, K, D) heads-major for the kernel: each chunk copies its
        # whole prefix, once a layer
        km, vm = (t.reshape(1, K, sk, D).transpose(1, 2).contiguous()
                  for t in timed[1][1:])
        row["copy_ms"] = timer(lambda: (ops._heads_major(km),
                                        ops._heads_major(vm)))
        log_row(row)
        log(f"  the K/V prefix made heads-major for it "
            f"(ops.flash_attention_op, once a layer a chunk): "
            f"{row['copy_ms']:.4f} ms")
        rows.append(row)

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 4):
            for s in (1000, 200):
                worst[dtype] = max(worst.get(dtype, 0.0),
                                   ssd_check(gen, b, s, dtype, state=True))
    x, dt, A, B_, C, Dk = _ssd_model_inputs(gen, 2, 1000, torch.float32)
    y, st = ops.ssd_scan_op(x, dt, A, B_, C, Dk, chunk=SSD_Q)
    p = SSD_SPLIT
    y1, st1 = ops.ssd_scan_op(x[:, :p], dt[:, :p], A, B_[:, :p], C[:, :p],
                              Dk, chunk=SSD_Q)
    y2, st2 = ops.ssd_scan_op(x[:, p:], dt[:, p:], A, B_[:, p:], C[:, p:],
                              Dk, chunk=SSD_Q, state0=st1)
    ey, es = rel_err(torch.cat([y1, y2], 1), y), rel_err(st2, st)
    check(ey <= SSD_STATE_TOL and es <= SSD_STATE_TOL,
          f"ssd_scan fp32 split at row {p}: y err {ey}, state err {es}")
    log(f"ssd_scan fp32 B=2 S=1000 as rows [0, {p}) then [{p}, 1000) from "
        f"the first part's state: against the whole scan, /scale y "
        f"{ey:.3e}, state {es:.3e}")

    for dtype in (torch.bfloat16, torch.float32):
        xw, cum, bm, cm = ssd_inputs(gen, 1, 1000, dtype)
        st0 = torch.randn(1, SSD_H, SSD_P, SSD_N, generator=gen,
                          device="cuda")
        nb, no = ssd_cost(xw, dtype, SSD_N, state=True)
        bms, bby = bound_ms(nb, no, dtype)
        sfx, tag = _dt_suffix(dtype)
        row = dict(
            name="ssd_scan_state" + sfx, route="cuda",
            source="src/repro_torch/kernels/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:66",
            ms=timer(lambda: SK.ssd_scan(xw, cum, bm, cm, st0)),
            plain_ms=timer(lambda: SK.ssd_scan_plain(xw, cum, bm, cm, st0)),
            bound_ms=bms, bound_by=bby, library_ms=None,
            max_abs_err=worst[dtype],
            shape=f"B=1 S=1000 (NC=4 Q=256) H={SSD_H} P={SSD_P} N={SSD_N} "
                  f"from a state {tag}")
        log_row(row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# training: kernel 1's backward, the train step on the card against the CPU,
# Qwen3-1.7B and Granite-3.0-2B through the training launcher
# ---------------------------------------------------------------------------

#: the backward's source and the forward it is the gradient of
BWD_SRC = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
#: (row name, B, Sq, Sk, H, K, D, causal, window): Qwen3-1.7B's training
#: shape (batch 8 x seq 128), S 2048 at its heads, Mixtral-8x22B's G = 6
#: with a 256-key window, Granite-3.0-2B's D = 64 G = 4, SeamlessM4T's
#: cross-attention (128 decoder rows over 1024 encoder rows, non-causal),
#: RecurrentGemma-2B's local attention (D = 256, G = 10, its 2048 window)
BWD_SHAPES = (
    ("flash_attention_bwd", 8, 128, 128, 16, 8, 128, True, 0),
    ("flash_attention_bwd_s2048", 1, 2048, 2048, 16, 8, 128, True, 0),
    ("flash_attention_bwd_mixtral", 1, 1024, 1024, 48, 8, 128, True, 256),
    ("flash_attention_bwd_d64", 1, 1024, 1024, 32, 8, 64, True, 0),
    ("flash_attention_bwd_cross", 4, 128, 1024, 16, 16, 64, False, 0),
    ("flash_attention_bwd_d256", 1, 3000, 3000, RG_H, RG_K, RG_D, True,
     RG_WINDOW),
)
#: the backwards of kernels 6 and 7
SSD_BWD_SRC = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
RG_BWD_SRC = "src/repro_torch/kernels/csrc/rglru_scan.cu"
#: the bf16 backwards of kernels 1 and 6 (tensor cores)
BWD_TC_SRC = "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu"
SSD_BWD_TC_SRC = "src/repro_torch/kernels/csrc/ssd_scan_bwd_tc.cu"
#: a bf16 backward against its plain backward on the same bf16 inputs
#: (computed in fp32): max|kernel - plain| over max|plain|, per output. The
#: kernels round P and dS (kernel 1) or M, C Bᵀ L, S and G (kernel 6) to
#: bf16 as product operands and write bf16 gradients, the plain backward
#: rounds nothing: the smoke's bf16 attention tolerance
BWD_BF16_TOL = 2e-2
#: the training forward's log2-sum-exp2 (``flash_attention_fwd_lse``, fp32
#: and bf16) against the plain one of the same inputs in fp32, absolute, in
#: log2 units: both sum fp32 products of the same values (the kernels' exp
#: and log are the hardware's approximate ones, a few fp32 ulps); a row
#: that misses one key or counts one too many moves by far more
LSE_TOL = 1e-3


def phase_scan_bwd(timer: Timer, gen) -> list:
    """The backwards of kernels 6 and 7 (fp32) against their plain
    backwards on the same inputs: kernel 6 at Mamba-2-2.7B's shapes on
    ``ssd_inputs`` (B 1, S 1000: 4 chunks of 256, the last padded), dy ~
    N(0, 1), from zeros and from a random state0 with a random final-state
    gradient; kernel 7 at RecurrentGemma's width (B 4, S 3000, W 2560) from
    h0, a and b as ``phase_rglru`` makes them, y the forward kernel's. Each
    gradient within TOL of the plain's scale (kernel 7's also bit-equal, the
    plain order); timed beside its bound and the plain backward (no single
    PyTorch call computes either). Returns the rows."""
    from repro_torch.kernels import rglru_scan as RK
    from repro_torch.kernels import ssd_scan as SK
    f32, rows = torch.float32, []
    xw, cum, bm, cm = ssd_inputs(gen, 1, 1000, f32)
    dy = torch.randn(xw.shape, generator=gen, device="cuda")
    shape_st = (1, SSD_H, SSD_P, SSD_N)
    for name, state in (("ssd_scan_bwd", False), ("ssd_scan_bwd_state",
                                                  True)):
        st0 = (torch.randn(shape_st, generator=gen, device="cuda")
               if state else None)
        dst = (torch.randn(shape_st, generator=gen, device="cuda")
               if state else None)
        args = (xw, cum, bm, cm, st0, dy, dst)
        got = SK.ssd_scan_bwd(*args)
        want = SK.ssd_scan_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want) if w is not None]
        what = (f"{name} B=1 S=1000 (NC=4 Q=256) H={SSD_H} P={SSD_P} "
                f"N={SSD_N}{' from a random state' if state else ''} fp32")
        check(all(math.isfinite(e) and e <= TOL[f32] for e in errs)
              and (got[4] is None) == (st0 is None),
              f"{what}: dxw, dcum, dB, dC(, dstate0) err {errs}")
        again = SK.ssd_scan_bwd(*args)
        same = all(torch.equal(g, a) for g, a in zip(got, again)
                   if g is not None)
        check(same, f"{what}: two runs differ")
        nb, no = ssd_bwd_cost(xw, SSD_N, state)
        bms, bby = bound_ms(nb, no, f32)
        row = dict(
            name=name, route="cuda", source=SSD_BWD_SRC,
            replaces="src/repro/kernels/ssd_scan.py:66 (its gradient; the "
                     "JAX package takes it through XLA)",
            ms=timer(lambda: SK.ssd_scan_bwd(*args)),
            plain_ms=timer(lambda: SK.ssd_scan_bwd_plain(*args)),
            bound_ms=bms, bound_by=bby, library_ms=None,
            max_abs_err=max((g - w).abs().max().item()
                            for g, w in zip(got, want) if w is not None),
            shape=what)
        log(f"{name}: dxw {errs[0]:.3e}, dcum {errs[1]:.3e}, dB "
            f"{errs[2]:.3e}, dC {errs[3]:.3e}"
            f"{f', dstate0 {errs[4]:.3e}' if state else ''} of the plain "
            f"backward's scale (TOL {TOL[f32]}); two runs bit-equal; "
            f"{nb / 1e6:.1f} MB, {no / 1e9:.2f} GFLOP")
        log_row(row)
        rows.append(row)
    del xw, cum, bm, cm, dy, args, got, want, again
    b, s = 4, 3000
    a = torch.sigmoid(torch.randn(b, s, RG_W, generator=gen, device="cuda"))
    bb = torch.randn(b, s, RG_W, generator=gen, device="cuda")
    h0 = torch.randn(b, RG_W, generator=gen, device="cuda")
    y, _ = RK.rglru_scan(a, bb, h0)
    dy = torch.randn(b, s, RG_W, generator=gen, device="cuda")
    dh = torch.randn(b, RG_W, generator=gen, device="cuda")
    args = (a, y, h0, dy, dh)
    got = RK.rglru_scan_bwd(*args)
    want = RK.rglru_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    what = f"rglru_scan_bwd B={b} S={s} W={RG_W} from h0 fp32"
    check(all(math.isfinite(e) and e <= TOL[f32] for e in errs),
          f"{what}: da, db, dh0 err {errs}")
    nb, no = rglru_bwd_cost(a, h0=True)
    bms, bby = bound_ms(nb, no, f32)
    row = dict(
        name="rglru_scan_bwd", route="cuda", source=RG_BWD_SRC,
        replaces="src/repro/kernels/rglru_scan.py:37 (its gradient; the JAX "
                 "package takes it through XLA)",
        ms=timer(lambda: RK.rglru_scan_bwd(*args)),
        plain_ms=timer(lambda: RK.rglru_scan_bwd_plain(*args)),
        bound_ms=bms, bound_by=bby, library_ms=None,
        max_abs_err=max((g - w).abs().max().item()
                        for g, w in zip(got, want)),
        shape=what)
    log(f"rglru_scan_bwd: da {errs[0]:.3e}, db {errs[1]:.3e}, dh0 "
        f"{errs[2]:.3e} of the plain backward's scale (TOL {TOL[f32]}); "
        f"bit-equal {equal}; {nb / 1e6:.1f} MB")
    log_row(row)
    rows.append(row)
    return rows


def phase_train_kernels(timer: Timer) -> list:
    """Kernel 1's backward (fp32, the register-tiled body) at BWD_SHAPES as
    a train step runs it: o and each row's log-sum-exp from the fp32
    training forward ``flash_attention_fwd_lse`` (``_lse_forward_check``:
    bit-equal to the serving forward, within LSE_TOL of the plain
    log-sum-exp), dO ~ N(0, 1), the backward given that log-sum-exp: dq, dk
    and dv each within TOL of the plain backward's scale max(1,
    max|plain|), two runs bit-equal; timed beside its bound (max(bytes /
    HBM_BW, cost.BWD_OPS x the forward's operations / the fp32 peak)), the
    plain backward and SDPA's forward + backward less its forward
    (``_sdpa_bwd``); the training forward timed beside the serving one at
    each shape, and at the first (Qwen3-1.7B's training shape) a row of
    its own, ``flash_attention_lse_fp32``. Then the backwards of kernels 6
    and 7 (``phase_scan_bwd``) and every bf16 backward
    (``phase_bwd_bf16``). Returns the rows (launches filled by main)."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cuda").manual_seed(26)
    rows, lse_row = [], None
    for name, b, sq, sk, h, kh, d, causal, window in BWD_SHAPES:
        g = h // kh
        q, k, v = flash_inputs(gen, b, sq, torch.float32, h, kh, d, sk)
        do = torch.randn(q.shape, generator=gen, device="cuda")
        kw = dict(causal=causal, window=window, group=g)
        o, lse = FA._forward_lse(q, k, v, **kw)
        _lse_forward_check(name, q, k, v, o, lse, kw)
        fn = lambda: FA.flash_attention_bwd(q, k, v, o, do,  # noqa: E731
                                            lse=lse, **kw)
        got, again = fn(), fn()
        want = FA.flash_attention_bwd_plain(q, k, v, o, do, **kw)
        torch.cuda.synchronize()
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        shape = (f"B={b} Sq={sq} Sk={sk} H={h} K={kh} D={d} window {window} "
                 f"{'causal' if causal else 'non-causal'} fp32")
        check(all(math.isfinite(e) and e <= TOL[torch.float32]
                  for e in errs), f"{name} at {shape}: dq, dk, dv err {errs}")
        check(all(torch.equal(a, a2) for a, a2 in zip(got, again)),
              f"{name} at {shape}: two runs differ")
        lib, lib_fwd, how = _sdpa_bwd(timer, q, k, v, do, b, h, kh, causal,
                                      window)
        fwd_ms = timer(lambda: FA._forward_lse(q, k, v, **kw))
        serve_ms = timer(lambda: FA._forward(q, k, v, **kw))
        nb, no = bwd_cost(b, sq, sk, h, kh, d, causal, window)
        bms, bby = bound_ms(nb, no, torch.float32)
        row = with_tflops(dict(
            name=name, route="cuda", source=BWD_SRC,
            replaces="src/repro/kernels/flash_attention.py:77 (its gradient;"
                     " the JAX package takes it through XLA)",
            ms=timer(fn),
            plain_ms=timer(lambda: FA.flash_attention_bwd_plain(
                q, k, v, o, do, **kw)),
            bound_ms=bms, bound_by=bby, library_ms=lib,
            max_abs_err=max(errs), shape=shape), no)
        row["library"] = f"SDPA fp32 backward, {how}"
        split = _fp32_split(FA, q, k, kw)
        bwd_split_sweep(timer, FA, fn, split, name)
        log(f"{name}: dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} "
            f"of the plain backward's scale (TOL {TOL[torch.float32]}); two "
            f"runs bit-equal; split {split}; library "
            f"{how}; SDPA forward {lib_fwd:.4f} ms; training forward "
            f"{fwd_ms:.4f} ms, serving forward {serve_ms:.4f} ms")
        log_row(row)
        rows.append(row)
        if lse_row is None:
            # the training forward at Qwen3-1.7B's training shape
            fb, fo = flash_cost(b, sq, torch.float32, h=h, kh=kh, d=d,
                                window=window, causal=causal, sk=sk)
            fb += 4 * b * h * sq  # the log-sum-exp
            fms, fby = bound_ms(fb, fo, torch.float32)
            lse_row = with_tflops(dict(
                name="flash_attention_lse_fp32", route="cuda",
                source=ATTN_SRC,
                replaces="src/repro/kernels/flash_attention.py:77 (the "
                         "forward of its gradient: the fp32 body with each "
                         "row's log-sum-exp stored)",
                ms=fwd_ms, plain_ms=timer(lambda: (
                    FA.flash_attention_plain(q, k, v, **kw),
                    FA.flash_lse_plain(q, k, **kw))),
                bound_ms=fms, bound_by=fby, library_ms=lib_fwd,
                max_abs_err=rel_err(o, FA.flash_attention_plain(
                    q, k, v, **kw)), shape=shape), fo)
            log_row(lse_row)
        del q, k, v, do, o, lse, got, again, want
        torch.cuda.empty_cache()
    return ([*rows, lse_row] + phase_scan_bwd(timer, gen)
            + phase_bwd_bf16(timer, gen))


def bwd_split_sweep(timer, FA, fn, chosen: int, what: str) -> None:
    """A backward ``fn`` timed with its dK/dV items forced over 1, 2, 3, 4
    and 6 CTAs a key tile (the wrapper's bwd_split replaced for the
    sweep), beside the count bwd_split picks (``chosen``): the evidence
    for its rule."""
    pick, times = FA.bwd_split, []
    try:
        for n in (1, 2, 3, 4, 6):
            FA.bwd_split = lambda *a, n=n: n
            times.append(f"{n}: {timer(fn):.4f}")
    finally:
        FA.bwd_split = pick
    log(f"{what}, ms by dK/dV CTAs a key tile (bwd_split picks {chosen}): "
        f"{', '.join(times)}")


def _fp32_split(FA, q, k, kw) -> int:
    """The split the fp32 backward's wrapper picks for these inputs."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import geometry
    bh, sq, d = q.shape
    return FA.bwd_split(sq, k.shape[1], kw["group"], bh // kw["group"],
                        kw["causal"], kw["window"],
                        DA.sm_count(q.device.index), geometry.rt_bwd_tile(d))


def _sdpa_bwd(timer, q, k, v, do, b, h, kh, causal, window):
    """SDPA's forward + backward less its forward on the kernel's inputs
    in (B, H, S, D) with ``enable_gqa``: its own causal form where there is
    no window (Sq = Sk at every causal shape, so its top-left diagonal is
    the kernel's), an explicit mask only for a window. Returns (ms,
    forward ms, the form and the backend its backward ran)."""
    F = torch.nn.functional
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    qs = q.reshape(b, h, sq, d).detach().requires_grad_()
    ks = k.reshape(b, kh, sk, d).detach().requires_grad_()
    vs = v.reshape(b, kh, sk, d).detach().requires_grad_()
    dos = do.reshape(b, h, sq, d)
    mask = None
    if window:
        i = torch.arange(sq, device="cuda")[:, None]
        j = torch.arange(sk, device="cuda")[None, :]
        mask = j > i - window
        if causal:
            mask &= j <= i

    def sdpa():
        return F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=causal and not window,
            enable_gqa=True)

    def fwd_bwd():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), dos)

    lib_fwd = timer(lambda: sdpa().detach())
    lib = timer(fwd_bwd) - lib_fwd
    form = ("the window's mask" if window else
            "is_causal" if causal else "no mask")
    return lib, lib_fwd, f"{form}, {sdpa_backend(fwd_bwd)}"


def scale_err(out, ref) -> float:
    """max|out - ref| over max|ref|: an output's error scaled to its own
    max abs."""
    ref = ref.float()
    return ((out.float() - ref).abs().max()
            / ref.abs().max().clamp(min=1e-30)).item()


def _bf16_row(timer, name, src, replaces, fn, plain, got, want, n_bytes,
              n_ops, shape, library_ms=None, tol=BWD_BF16_TOL) -> dict:
    """One bf16 backward row: every output of ``fn()`` (the kernel, already
    run as ``got``) within ``tol`` of the plain backward's (``want``, the
    same bf16 inputs in fp32) scaled to its own max abs, a second run
    bit-equal, timed beside its bound at the bf16 peak."""
    errs = [scale_err(g, w) for g, w in zip(got, want) if w is not None]
    check(all(math.isfinite(e) and e <= tol for e in errs)
          and all(g.dtype in (torch.bfloat16, torch.float32)
                  for g in got if g is not None),
          f"{name} at {shape}: errors {errs} (gate {tol})")
    again = fn()
    check(all(torch.equal(g, a) for g, a in zip(got, again)
              if g is not None), f"{name} at {shape}: two runs differ")
    bms, bby = bound_ms(n_bytes, n_ops, torch.bfloat16)
    row = dict(name=name, route="cuda", source=src, replaces=replaces,
               ms=timer(fn), plain_ms=timer(plain), bound_ms=bms,
               bound_by=bby, library_ms=library_ms, max_abs_err=max(errs),
               shape=shape)
    log(f"{name}: errors {['%.3e' % e for e in errs]} of each output's max "
        f"abs (gate {tol}); two runs bit-equal; {n_bytes / 1e6:.1f} MB, "
        f"{n_ops / 1e9:.2f} GFLOP")
    return row


def _lse_forward_check(name, q, k, v, o, lse, kw) -> None:
    """The training forward ``flash_attention_fwd_lse`` (the serving body
    of q's dtype with the log-sum-exp written too) against the serving
    forward on the same inputs, bit for bit, and against the plain forward
    within TOL of the dtype; its log2-sum-exp2 within LSE_TOL of the plain
    one."""
    from repro_torch.kernels import flash_attention as FA
    serving = FA._forward(q, k, v, **kw)
    plain = FA.flash_attention_plain(q, k, v, **kw)
    want = FA.flash_lse_plain(q, k, **kw)
    torch.cuda.synchronize()
    e = (o.float() - plain.float()).abs().max().item()
    le = (lse - want).abs().max().item()
    check(torch.equal(o, serving), f"{name}: the training forward's output "
          "differs from the serving forward's")
    check(math.isfinite(e) and e <= TOL[q.dtype],
          f"{name}: training forward max|kernel-plain| {e}")
    check(math.isfinite(le) and le <= LSE_TOL,
          f"{name}: log2-sum-exp2 max|kernel-plain| {le}")
    log(f"{name}: {_dt_name(q.dtype)} training forward "
        f"(flash_attention_fwd_lse) bit-equal to the serving forward, "
        f"max|kernel-plain| {e:.3e} (gate {TOL[q.dtype]}), log2-sum-exp2 "
        f"max|kernel-plain| {le:.3e} (gate {LSE_TOL})")


def sdpa_backend(fn) -> str:
    """Which SDPA backend one call of ``fn`` ran its backward on: the aten
    backward op it dispatched to, read from torch.profiler's host-side
    events (cuDNN, flash or memory-efficient; none of them is the math
    path). The host events need no device tracing, which can miss the
    first profiled window of a process."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    # the outermost op first: _scaled_dot_product_flash_attention_backward
    # calls _flash_attention_backward
    ops = sorted((not e.key.startswith("aten::_scaled_dot_product"), e.key)
                 for e in prof.key_averages()
                 if e.key.startswith("aten::") and "attention" in e.key
                 and e.key.endswith("_backward"))
    if not ops:
        return "math (no fused attention backward op)"
    op = ops[0][1]
    kind = ("cuDNN" if "cudnn" in op else "flash" if "flash" in op else
            "memory-efficient")
    return f"{kind} ({op})"


def phase_bwd_bf16(timer: Timer, gen) -> list:
    """The bf16 backwards: kernel 1's (``flash_attention_bwd_tc``, tensor
    cores) at every BWD_SHAPES shape as a train step runs it (from the
    log-sum-exp its forward ``flash_attention_fwd_lse`` kept; that forward
    itself held against the serving one and the plain one,
    ``_lse_forward_check``), kernel 6's
    (``ssd_scan_bwd_tc``) at Mamba-2-2.7B's shapes from zeros and from a
    random state0 with a random final-state gradient, kernel 7's
    (``rglru_scan_bwd`` on bf16) at RecurrentGemma's width from h0. Inputs
    as the fp32 rows' in bf16, dy ~ N(0, 1) in bf16; each held against its
    plain backward on the same inputs cast to fp32 (BWD_BF16_TOL; kernel 7,
    which rounds only its outputs, within RG_TOL's bf16 ulp), two runs
    bit-equal, timed beside its bound at the bf16 peak and the plain
    backward; kernel 1 also beside SDPA's bf16 forward + backward less its
    forward (``_sdpa_bwd``), with the backend its backward ran. Returns
    the rows ``*_bf16`` of kernels 1 and 6 (kernel 7's is logged only: no
    model path runs it in bf16)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rglru_scan as RK
    from repro_torch.kernels import ssd_scan as SK
    bf, rows = torch.bfloat16, []
    for name, b, sq, sk, h, kh, d, causal, window in BWD_SHAPES:
        g = h // kh
        q, k, v = flash_inputs(gen, b, sq, bf, h, kh, d, sk)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(bf)
        kw = dict(causal=causal, window=window, group=g)
        # as a train step runs it: FlashAttention's forward on the card
        # keeps each row's log-sum-exp, the backward reads it
        o, lse = FA._forward_lse(q, k, v, **kw)
        _lse_forward_check(name, q, k, v, o, lse, kw)
        f32 = [t.float() for t in (q, k, v, o, do)]
        fn = lambda: FA.flash_attention_bwd(q, k, v, o, do,  # noqa: E731
                                            lse=lse, **kw)
        plain = lambda: FA.flash_attention_bwd_plain(*f32, **kw)  # noqa
        got, want = fn(), plain()
        torch.cuda.synchronize()
        lib, lib_fwd, how = _sdpa_bwd(timer, q, k, v, do, b, h, kh, causal,
                                      window)
        nb, no = bwd_cost(b, sq, sk, h, kh, d, causal, window, bf)
        shape = (f"B={b} Sq={sq} Sk={sk} H={h} K={kh} D={d} window {window} "
                 f"{'causal' if causal else 'non-causal'} bf16")
        row = with_tflops(_bf16_row(
            timer, name + "_bf16", BWD_TC_SRC,
            "src/repro/kernels/flash_attention.py:77 (its gradient; the JAX "
            "package takes it through XLA)", fn, plain, got, want, nb, no,
            shape, library_ms=lib), no)
        row["library"] = f"SDPA bf16 backward, {how}"
        log_row(row)
        log(f"{name}_bf16: library SDPA, {how}; SDPA forward "
            f"{lib_fwd:.4f} ms")
        rows.append(row)
        del q, k, v, do, o, lse, f32, got, want
        torch.cuda.empty_cache()

    xw, cum, bm, cm = ssd_inputs(gen, 1, 1000, bf)
    dy = torch.randn(xw.shape, generator=gen, device="cuda").to(bf)
    shape_st = (1, SSD_H, SSD_P, SSD_N)
    for name, state in (("ssd_scan_bwd_bf16", False),
                        ("ssd_scan_bwd_state_bf16", True)):
        st0 = (torch.randn(shape_st, generator=gen, device="cuda")
               if state else None)
        dst = (torch.randn(shape_st, generator=gen, device="cuda")
               if state else None)
        args = (xw, cum, bm, cm, st0, dy, dst)
        f32 = tuple(t if t is None or t.dtype == torch.float32 else t.float()
                    for t in args)
        fn = lambda: SK.ssd_scan_bwd(*args)  # noqa: E731
        plain = lambda: SK.ssd_scan_bwd_plain(*f32)  # noqa: E731
        got, want = fn(), plain()
        torch.cuda.synchronize()
        check((got[4] is None) == (st0 is None), f"{name}: dstate0")
        nb, no = ssd_bwd_cost(xw, SSD_N, state, bf)
        row = _bf16_row(
            timer, name, SSD_BWD_TC_SRC,
            "src/repro/kernels/ssd_scan.py:66 (its gradient; the JAX package "
            "takes it through XLA)", fn, plain, got, want, nb, no,
            f"B=1 S=1000 (NC=4 Q=256) H={SSD_H} P={SSD_P} N={SSD_N}"
            f"{' from a random state' if state else ''} bf16")
        log_row(row)
        rows.append(row)
    del xw, cum, bm, cm, dy, args, f32, got, want

    b, s = 4, 3000
    a = torch.sigmoid(torch.randn(b, s, RG_W, generator=gen,
                                  device="cuda")).to(bf)
    bb = torch.randn(b, s, RG_W, generator=gen, device="cuda").to(bf)
    h0 = torch.randn(b, RG_W, generator=gen, device="cuda")
    y, _ = RK.rglru_scan(a, bb, h0)
    dy = torch.randn(b, s, RG_W, generator=gen, device="cuda").to(bf)
    dh = torch.randn(b, RG_W, generator=gen, device="cuda")
    args = (a, y, h0, dy, dh)
    f32 = (a.float(), y.float(), h0, dy.float(), dh)
    fn = lambda: RK.rglru_scan_bwd(*args)  # noqa: E731
    plain = lambda: RK.rglru_scan_bwd_plain(*f32)  # noqa: E731
    got, want = fn(), plain()
    torch.cuda.synchronize()
    check(got[0].dtype == bf and got[2].dtype == torch.float32,
          f"rglru_scan_bwd_bf16: dtypes {[t.dtype for t in got]}")
    nb, no = rglru_bwd_cost(a, True, bf)
    # checked and timed, but not a row of the kernel table: no model path
    # runs kernel 7 in bf16 (the RG-LRU gates hand it fp32 a and b, as the
    # JAX package's _gates do), so nothing launches this body on a path
    log_row(_bf16_row(
        timer, "rglru_scan_bwd_bf16", RG_BWD_SRC,
        "src/repro/kernels/rglru_scan.py:37 (its gradient; the JAX package "
        "takes it through XLA)", fn, plain, got, want, nb, no,
        f"B={b} S={s} W={RG_W} from h0 bf16", tol=RG_TOL[bf]))
    return rows


def phase_colocated(timer: Timer) -> dict:
    """The counterpart of examples/colocated_attention.py on the card: one
    dense fused launch computes a prefill batch's attention and a decode
    batch's over dense caches, swept over decode_share, in fp32 and in
    bf16 (each dtype runs its own bodies); every share must equal flash +
    dense decode run apart bit for bit. Returns the fused kernel's launches
    in each dtype's sweep."""
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import ops

    # prefill: 2 requests x 256 tokens; decode: 8 requests over 512-row
    # caches (the example's shapes at the served model's heads, D=128)
    bp, sp, bd, sk = 2, 256, 8, 512
    gen = torch.Generator(device="cuda").manual_seed(3)
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
        qp, kp, vp = rn(bp, sp, H, D), rn(bp, sp, K, D), rn(bp, sp, K, D)
        qd, kd, vd = rn(bd, 1, H, D), rn(bd, sk, K, D), rn(bd, sk, K, D)
        kvpos = torch.arange(sk, dtype=torch.int32,
                             device="cuda")[None].expand(bd, sk).contiguous()
        pos = torch.from_numpy(np.random.default_rng(0).integers(
            64, sk, bd).astype(np.int32)).cuda()
        ref_p = ops.flash_attention_op(qp, kp, vp)
        ref_d = ops.decode_attention_op(qd, kd, vd, kvpos, pos)
        n_ctas = BA.grid_ctas(torch.cuda.current_device(),
                              int(dtype == torch.bfloat16), D, G, PS,
                              dense=True)
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        BA.dense_launches = 0
        outs = {}
        for share in (0.0, 0.25, 0.5, 0.75, 1.0):
            outs[share] = ops.bullet_attention_op(
                qp, kp, vp, qd, kd, vd, kvpos, pos, decode_share=share)
        n = launches[dtype] = BA.dense_launches
        check(n == 5, f"colocated {dtype}: {n} fused launches, want 5")
        # card time (the timer holds the stream), so the gate compares
        # kernels and not the wrappers' Python
        apart = timer(lambda: (ops.flash_attention_op(qp, kp, vp),
                               ops.decode_attention_op(qd, kd, vd, kvpos,
                                                       pos)))
        log(f"colocated {str(dtype)[6:]}: flash + dense decode launched "
            f"apart {apart:.4f} ms of card time; {n_ctas} CTAs on {n_sm} "
            f"SMs fused")
        for share, (op, od) in outs.items():
            check(torch.equal(op, ref_p) and torch.equal(od, ref_d),
                  f"colocated {dtype} share {share}: not bit-equal to flash "
                  "+ dense decode")
            ms = timer(lambda: ops.bullet_attention_op(
                qp, kp, vp, qd, kd, vd, kvpos, pos, decode_share=share))
            n_dec_sm = BA.decode_sms(share, n_sm, True, True)
            log(f"colocated {str(dtype)[6:]} decode_share={share:4.2f}: "
                f"{n_dec_sm:3d} of {n_sm} SMs decode first, {ms:.4f} ms "
                f"({ms / apart:.2f}x apart), bit-equal to flash + dense "
                f"decode")
            check(ms <= COLOCATED_LIMIT * apart,
                  f"colocated {dtype} share {share}: {ms:.4f} ms, more than "
                  f"{COLOCATED_LIMIT:g}x the {apart:.4f} ms launched apart")
    return launches


def phase_reference():
    """Full-width Qwen3-1.7B cut to 2 layers, fp32: prefill + 4 decode
    steps on the card (kernels) against the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2)
    params = T.init_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    cpu = {k: (tuple({n: t.cpu() for n, t in b.items()} for b in v)
               if k == "blocks" else v.cpu()) for k, v in params.items()}
    s, n_dec = 200, 4
    toks = torch.randint(0, cfg.vocab_size, (1, s),
                         generator=torch.Generator().manual_seed(1))
    n_pages = -(-(s + n_dec) // PS)
    page_map = torch.arange(-(-s // PS), dtype=torch.int32)[None]
    bt = torch.arange(n_pages, dtype=torch.int32)[None]
    outs = {}
    for dev, p in (("cuda", params), ("cpu", cpu)):
        cache = T.init_paged_cache(cfg, n_pages, PS, torch.float32, dev)
        logits, _ = T.prefill(p, toks.to(dev), torch.tensor([s]).to(dev),
                              cache, page_map.to(dev), cfg)
        seq = [logits.float().cpu()]
        tok = logits.argmax(-1)
        for i in range(n_dec):
            logits, _ = T.decode_step(
                p, cache, tok[:, None].to(torch.int32),
                torch.tensor([s + i], dtype=torch.int32, device=dev), cfg,
                block_tables=bt.to(dev))
            seq.append(logits.float().cpu())
            tok = logits.argmax(-1)
        outs[dev] = seq
    worst = _card_vs_cpu(outs, cfg)
    log(f"reference: 2-layer full-width Qwen3-1.7B fp32, prefill S={s} + "
        f"{n_dec} decode steps, card vs CPU max rel logit err {worst:.2e}")


def _card_vs_cpu(outs, cfg, tol: float = 1e-3) -> float:
    """Each step's logits on the card against the CPU's, over the real
    vocab: finite, within ``tol`` of their scale, the same greedy token.
    Returns the worst error over the scale."""
    worst = 0.0
    for a, b in zip(outs["cuda"], outs["cpu"]):
        a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
        check(bool(torch.isfinite(a).all()), "non-finite logits on the card")
        e = (a - b).abs().max().item()
        scale = max(1.0, b.abs().max().item())
        check(e <= tol * scale, f"{cfg.name}: card vs CPU logits differ "
              f"by {e}")
        check(bool((a.argmax(-1) == b.argmax(-1)).all()),
              f"{cfg.name}: argmax differs")
        worst = max(worst, e / scale)
    return worst


def _serve(cfg, params, prompts, outs, arrivals, fused: bool,
           audit=None, default_sched: bool = False, paged: bool = True,
           max_len: int = 1152, max_slots: int = 8, partition: str = "tile",
           devices=None, est=None, faults=None, guard=None):
    """Serve the requests, each released when the virtual clock reaches its
    arrival. The clock advances by the H100 estimator's price of each cycle
    (as the JAX package's virtual replay does), so the scheduler's
    decisions do not depend on this run's wall time; throughput is timed
    on the wall clock. One prompt per prefill batch keeps each request's
    prefill shapes, and so its bf16 numerics, independent of which requests
    happen to be admitted together, so fused and serial runs can be
    compared token for token. As in tests/test_fused.py the §3.3.3 decode
    pause is off (max_decode_pause_cycles=0): with a 150 ms TPOT SLO and
    millisecond decode steps the scheduler would otherwise borrow the card
    for prefill 48 cycles out of 49, and the run would barely reach the
    fused path it exists to drive. ``default_sched=True`` serves with the
    scheduler's defaults instead (pause on, up to 4 prompts per prefill
    batch), to show how often the default configuration fuses.

    ``audit(server)`` runs after every cycle (e.g. a
    :class:`ProfileCycles`). ``paged=False`` serves on the dense slot
    cache (serial). ``max_len`` and ``max_slots`` size the cache.
    ``partition`` and ``devices`` select chip granularity over a device
    group; ``est``, ``faults`` and ``guard`` are the server's seams."""
    from repro_torch.core.config import (CacheConfig, ControlConfig,
                                         ExecConfig, ServerConfig)
    from repro_torch.core.engine import BulletServer
    from repro_torch.core.estimator import predict_cycle
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.serving.request import SLO, Request

    if default_sched:
        config = ServerConfig(slo=SLO(3.0, 150.0), max_slots=max_slots,
                              max_len=max_len, dtype=torch.bfloat16,
                              execution=ExecConfig(fused=fused))
    else:
        config = ServerConfig(
            slo=SLO(3.0, 150.0), est=est, max_slots=max_slots,
            max_len=max_len, max_prefill_batch=1, dtype=torch.bfloat16,
            cache=CacheConfig(paged=paged),
            execution=ExecConfig(fused=fused, partition=partition,
                                 devices=devices),
            control=ControlConfig(
                sched=SchedulerConfig(max_decode_pause_cycles=0)),
            faults=faults, guard=guard)
    server = BulletServer(cfg, params, config=config, device="cuda")
    queue = sorted(zip(arrivals, range(len(prompts))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    now, cycles = 0.0, 0
    while queue or not server.idle:
        check(cycles < 20_000, "serve did not drain")
        while queue and queue[0][0] <= now:
            arrival, rid = queue.pop(0)
            server.submit(Request(rid=rid, arrival=arrival,
                                  prompt_len=len(prompts[rid]),
                                  output_len=outs[rid]), prompts[rid])
        if server.idle:
            now = queue[0][0]
            continue
        server.step(now)
        server.check_invariants()
        obs = server.last_cycle_observation()
        now += predict_cycle(server.est, server.cfg, obs) if obs else 1e-4
        cycles += 1
        if audit is not None:
            audit(server)
    torch.cuda.synchronize()
    return server, time.perf_counter() - t0, cycles


def _kernel_kind(name: str) -> str:
    # "decode_kernel" matches the fp32 decode kernels (decode_kernel<float,
    # 128, DecodeArgs> over the page pool, <..., DenseDecodeArgs> over the
    # dense cache) and the bf16 split kernels over either
    # (split_decode_kernel<128, DecodeArgs>, ...); flash is "flash_kernel"
    # (bf16) and "flash_rt_kernel" (fp32), the training forwards
    # "flash_lse_kernel" and "flash_rt_lse_kernel", the backwards
    # "flash_bwd_*"; the fused kernels are "bullet_kernel" (fp32) and
    # "bullet_tc_kernel" (bf16)
    if any(k in name for k in ("flash_kernel", "flash_rt_kernel",
                               "flash_lse_kernel", "flash_rt_lse_kernel",
                               "flash_bwd", "decode_kernel",
                               "bullet_kernel", "bullet_tc_kernel")):
        return "attention (this port's kernels)"
    if any(k in name for k in SSD_KERNELS) or "ssd_bwd_" in name:
        return "SSD scan (this port's kernel)"
    if "rglru_scan" in name:
        return "RG-LRU scan (this port's kernel)"
    if any(k in name.lower() for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "GEMM (cuBLAS)"
    return "other (elementwise, norms, copies, index ops)"


class ProfileCycles:
    """A per-cycle audit hook (serve or replay) that runs torch.profiler
    over the ``n`` cycles after cycle ``first`` (or, with ``when``, after
    the first cycle from ``first`` on after which ``when(server)`` holds),
    times that window on the host clock and counts the window's cycles
    that ran a prefill group and the tokens its decode iterations
    emitted, and the graphs captured in it."""

    def __init__(self, first: int, n: int, when=None):
        self.first, self.n, self.when, self.cycle = first, n, when, 0
        self.start = None
        self.prof = self.wall = None
        self.t0, self.prefills, self.tokens, self.captured = 0.0, 0, 0, 0

    @staticmethod
    def _captures(srv) -> int:
        return len(getattr(getattr(srv, "graphs", None), "captures", ()))

    def __call__(self, srv) -> None:
        self.cycle += 1
        if self.start is None:
            if self.cycle >= self.first and (self.when is None
                                             or self.when(srv)):
                self.start = self.cycle
                self.captured = -self._captures(srv)
                torch.cuda.synchronize()
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            return
        if self.cycle <= self.start + self.n:
            self.prefills += bool(srv.last_prefill_tokens)
            if srv.last_decode is not None:
                self.tokens += srv.last_decode.batch
        if self.cycle == self.start + self.n:
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            self.captured += self._captures(srv)

    def report(self, what: str, card: str) -> dict:
        """``_profile_report`` of the window, with its tok/s and wall per
        cycle."""
        check(self.wall is not None, f"{what}: the run ended before its "
              "profile window")
        out = _profile_report(self.prof, self.wall, what, card,
                              cycles=self.n, tokens=self.tokens)
        out["captures"] = self.captured
        log(f"  graphs captured in the window: {self.captured}")
        return out


def _profile_report(prof, wall: float, what: str, card: str,
                    cycles: int = 0, tokens: int = 0) -> dict:
    """Device time by kernel kind over a profiled window, and the device's
    busy share of that window's wall time; with ``cycles`` (engine cycles
    or decode steps) also the wall per cycle, with ``tokens`` the output
    tok/s. Returns those numbers."""
    kinds, names = {}, []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the operators that
        # launched them report the same time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.device_time_total                                  # us
        if t <= 0:
            continue
        kinds[_kernel_kind(e.key)] = kinds.get(_kernel_kind(e.key), 0.0) + t
        names.append((t, e.count, e.key))
    busy = sum(kinds.values()) / 1e3
    check(busy > 0, "the profiler saw no device time")
    out = {"wall_ms": wall * 1e3, "busy_ms": busy,
           "busy_share": busy / (wall * 1e3),
           "kind_ms": {k: t / 1e3 for k, t in kinds.items()}}
    extra = ""
    if cycles:
        out["ms_per_cycle"] = wall * 1e3 / cycles
        extra += f", {out['ms_per_cycle']:.2f} ms wall per cycle"
    if tokens:
        out["tok_s"] = tokens / wall
        extra += f", {tokens} tokens = {out['tok_s']:.1f} tok/s"
    log(f"profile: {what}, wall {wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%)"
        f"{extra}  [{card}]")
    for kind, t in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  {kind}: {t / 1e3:.2f} ms ({100 * t / 1e3 / busy:.1f}% of "
            f"device time)")
    for t, count, name in sorted(names, reverse=True)[:8]:
        log(f"  {t / 1e3:8.2f} ms {count:6d}x {name[:90]}")
    return out


class HostSplit:
    """A serve audit that, from its first call on, times on the host clock
    what each engine cycle spends where: the scheduler, staging the decode
    inputs, the call into the serial decode graph (the replay's enqueue;
    the device's work is then waited for apart, where the engine's
    read-back would wait for it anyway), the fused cycle's decode graph
    replays and its eager fused repeat (host time only: their device work
    runs on while the host goes on), the prefill graphs' replays, graph
    captures (the miss's eager run and the capture), the read-back and
    bookkeeping of the sampled tokens (in a fused cycle the wait for its
    device work too), the rest of a fused or chip cycle, a prefill group's
    launch, a chip cycle's page handoff; each part exclusive of the parts
    it calls. The rest of the cycle's wall is the engine's and the serve
    loop's other work. Cycles are split by kind: a decode iteration alone,
    fused, chip, or other, and apart from each a cycle of that kind that
    captured a graph ("fused (capturing)"). A part whose method a checkout
    lacks is left out."""

    #: (part, owner, method) of the timed calls; owner "" is the server
    PARTS = (("schedule", "scheduler", "schedule"),
             ("stage inputs", "", "_decode_inputs"),
             ("read back, bookkeeping", "", "_finish_decode_iteration"),
             ("eager fused repeat", "", "_fused_repeat"),
             ("rest of the fused cycle", "", "_fused_cycle"),
             ("prefill group launch", "", "_launch_prefill_group"),
             ("rest of the chip cycle", "", "_chip_cycle"),
             ("handoff", "", "_handoff"))

    def __init__(self):
        self.last = None
        self.cur = collections.defaultdict(float)
        self.cycles = collections.defaultdict(list)
        #: per timed call in progress, the time its timed callees took
        self.stack = []
        #: whether the cycle in progress captured a graph
        self.capturing = False

    def _add(self, part: str, elapsed: float, callees: float = 0.0) -> None:
        self.cur[part] += elapsed - callees
        if self.stack:
            self.stack[-1] += elapsed

    def _timed(self, fn, part):
        def timed(*a, **k):
            self.stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                elapsed = time.perf_counter() - t0
                self._add(part, elapsed, self.stack.pop())
        return timed

    def _graphs(self, graphs):
        split = self

        class Timed:
            def __call__(self, key, *a):
                n = len(graphs.captures)
                t0 = time.perf_counter()
                out = graphs(key, *a)
                t1 = time.perf_counter()
                if len(graphs.captures) != n:
                    split._add("captures", t1 - t0)
                    split.capturing = True
                elif key[0] in ("paged", "dense"):
                    torch.cuda.synchronize()
                    split._add("graph call (host)", t1 - t0)
                    split._add("device wait", time.perf_counter() - t1)
                elif key[0].startswith("d_"):
                    split._add("decode replays (host)", t1 - t0)
                else:
                    split._add("prefill replays (host)", t1 - t0)
                return out

            def __getattr__(self, name):
                return getattr(graphs, name)
        return Timed()

    def __call__(self, srv) -> None:
        now = time.perf_counter()
        if self.last is None:
            for part, owner, name in self.PARTS:
                obj = getattr(srv, owner) if owner else srv
                if hasattr(obj, name):
                    setattr(obj, name, self._timed(getattr(obj, name), part))
            if hasattr(srv, "graphs"):          # a checkout without graphs
                srv.graphs = self._graphs(srv.graphs)
            if hasattr(srv, "graphs_p"):        # the chip prefill side's
                srv.graphs_p = self._graphs(srv.graphs_p)
        else:
            kind = ("chip" if getattr(srv, "last_chip", False)
                    else "fused" if srv.last_fused else "decode"
                    if srv.last_decode is not None
                    and not srv.last_prefill_tokens else "other")
            if self.capturing:
                kind += " (capturing)"
            self.cycles[kind].append((now - self.last, dict(self.cur)))
        self.cur.clear()
        self.capturing = False
        self.last = now

    def report(self, kind: str) -> dict:
        """Mean ms per cycle of ``kind``: its wall, each part, the rest."""
        got = self.cycles[kind]
        check(bool(got), f"host split: no {kind} cycle")
        out = {"cycles": len(got),
               "wall": 1e3 * statistics.mean(w for w, _ in got)}
        parts = sorted({p for _, d in got for p in d})
        for p in parts:
            out[p] = 1e3 * sum(d.get(p, 0.0) for _, d in got) / len(got)
        out["other"] = out["wall"] - sum(out[p] for p in parts)
        return out


def host_split_line(split: HostSplit, kind: str) -> str:
    r = split.report(kind)
    return (f"{r['cycles']} {kind} cycles, {r['wall']:.2f} ms wall each: "
            + ", ".join(f"{k} {v:.3f}" for k, v in r.items()
                        if k not in ("cycles", "wall")) + " ms")


def phase_profile(cfg, params, prompts, outs, arrivals, card: str) -> dict:
    """Where the time goes in steady fused serving: device time by kernel
    kind over 30 cycles of the serve workload, and the device's busy share
    of that window's wall time."""
    prof = ProfileCycles(150, 30)
    _serve(cfg, params, prompts, outs, arrivals, fused=True, audit=prof)
    return prof.report("30 fused-serving cycles", card)


#: the decode-heavy serve: requests, prompt and output tokens each (so
#: every decode iteration's table fits 16 pages of 16 rows: one graph),
#: and the cycles of its profile window
DECODE_SERVE = dict(n=8, prompt=128, output=128, cycles=30)


def decode_serve(cfg, params, card: str) -> dict:
    """The scheduler's defaults serving 8 requests of 128 prompt and 128
    output tokens, all arriving at once: after the two prefill batches
    every cycle is a serial decode iteration of 8 slots. A torch.profiler
    window over the 30 cycles after the last prefill group (fatal if one
    of them ran a prefill group), then the same serve unprofiled with its
    host time split by part (``HostSplit``). Returns the window's numbers
    and the serve's tok/s."""
    d = DECODE_SERVE
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, d["prompt"]).astype(np.int32)
               for _ in range(d["n"])]
    outs = [d["output"]] * d["n"]
    # the window opens once every prompt's prefill groups have run
    prof = ProfileCycles(1, d["cycles"], when=lambda srv: (
        srv.ptask is None and not srv.pending))
    server, secs, cycles = _serve(cfg, params, prompts, outs, [0.0] * d["n"],
                                  fused=True, default_sched=True, audit=prof)
    check(prof.prefills == 0, f"decode serve: {prof.prefills} cycles of the "
          "window ran a prefill group")
    out = prof.report(f"{d['cycles']} serial decode cycles of the "
                      "default-scheduler serve (8 slots)", card)
    out["serve_tok_s"] = d["n"] * d["output"] / secs
    log(f"decode serve (default scheduler, {d['n']} x {d['prompt']} prompt "
        f"+ {d['output']} output tokens): {out['serve_tok_s']:.1f} tok/s, "
        f"{cycles} cycles, {server.stats.fused_cycles} fused; "
        f"{captures(server)}  [{card}]")
    # the same serve again, unprofiled, with its host time split by part
    split = HostSplit()
    _serve(cfg, params, prompts, outs, [0.0] * d["n"], fused=True,
           default_sched=True, audit=split)
    log(f"decode serve host split: {host_split_line(split, 'decode')}  "
        f"[{card}]")
    return out


def captures(server) -> str:
    """The graphs a server (or a ``GraphedDecode``, or a ``StepGraphs``)
    captured, by kind (the key's first element): how many, their capture
    seconds in all and at most, and the peak of the graphs' shared pool (a
    server of a checkout without graphs: none)."""
    graphs = getattr(server, "graphs", server)
    if not hasattr(graphs, "captures"):
        return "no graphs"
    kinds = collections.defaultdict(list)
    for k, t in graphs.captures:
        kinds[k[0]].append(t)
    pool = graphs.pool_bytes() if hasattr(graphs, "pool_bytes") else None
    return (f"{len(graphs.captures)} graphs captured: " + ", ".join(
        f"{k} {len(ts)} in {sum(ts):.3f} s (at most {max(ts):.3f})"
        for k, ts in sorted(kinds.items()))
        + "; graph pool peak " + ("not measured" if pool is None
                                  else f"{pool / 2**20:.1f} MiB"))


# ---------------------------------------------------------------------------
# the decode graphs against the eager step
# ---------------------------------------------------------------------------

#: decode steps of each graphs-against-eager check on one key (the first is
#: the capture's miss)
GRAPH_STEPS = 4


def _map_tree(fn, tree):
    """``fn`` of every tensor of a nested dict / tuple tree, the nesting
    kept."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


#: a copy of every tensor of a tree, its nesting kept
_clone_tree = functools.partial(_map_tree, torch.clone)


def _counter_names():
    from repro_torch.core.graphs import COUNTERS
    return [f"{m.__name__.rsplit('.', 1)[-1]}.{a}" for m, a in COUNTERS]


def graph_vs_eager(what, steps, eager, graphed, cache_e, cache_g, tok,
                   card: str) -> None:
    """Decode steps through the graphs against the module-level step called
    directly, on two copies of one cache: ``steps`` is (key, feed) per
    step, ``eager(tok, feed)`` and ``graphed(key, tok, feed)`` return (next
    tokens (B, 1), logits (B, V)). Fatal unless after every step the
    tokens are equal and the logits and every cache leaf bit-equal, and
    unless after n steps of a key the launch counters moved by exactly n
    times what one eager step moves them."""
    from repro_torch.core.graphs import launch_counts
    tok_e, tok_g = tok.clone(), tok.clone()
    per = {}
    leaves_e, leaves_g = _leaves(cache_e), _leaves(cache_g)
    for key, feed in steps:
        c0 = launch_counts()
        nt_e, lg_e = eager(tok_e, feed)
        c1 = launch_counts()
        nt_g, lg_g = graphed(key, tok_g, feed)
        c2 = launch_counts()
        check(torch.equal(nt_g, nt_e), f"graphs {what} {key}: tokens differ")
        check(torch.equal(lg_g, lg_e), f"graphs {what} {key}: logits differ")
        for i, (a, b) in enumerate(zip(leaves_g, leaves_e)):
            check(torch.equal(a, b), f"graphs {what} {key}: cache leaf {i} "
                  "differs")
        d_e = tuple(y - x for x, y in zip(c0, c1))
        d_g = tuple(y - x for x, y in zip(c1, c2))
        rec = per.setdefault(key, {"n": 0, "eager": d_e,
                                   "graphed": (0,) * len(d_e)})
        check(d_e == rec["eager"], f"graphs {what} {key}: eager steps moved "
              f"the counters by {rec['eager']} and {d_e}")
        rec["n"] += 1
        rec["graphed"] = tuple(a + b for a, b in zip(rec["graphed"], d_g))
        tok_e, tok_g = nt_e.clone(), nt_g.clone()
    names = _counter_names()
    for key, rec in per.items():
        check(rec["graphed"] == tuple(rec["n"] * d for d in rec["eager"]),
              f"graphs {what} {key}: {rec['n']} graphed steps moved the "
              f"counters by {rec['graphed']}, one eager step by "
              f"{rec['eager']}")
    one = {k: {n: d for n, d in zip(names, r["eager"]) if d}
           for k, r in per.items()}
    log(f"graphs {what}: {len(steps)} steps over {len(per)} keys, tokens "
        f"equal, logits and caches bit-equal to the eager step; launches "
        f"of one step by key {one}, n graphed steps of a key n times those "
        f" [{card}]")


@contextlib.contextmanager
def _side(stream):
    """Run the body on ``stream`` (None: the current stream), ordered
    after the current stream's work and before its later work, as the chip
    engine runs each side."""
    if stream is None:
        yield
        return
    cur = torch.cuda.current_stream()
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield
    cur.wait_stream(stream)


def engine_graphs_check(what, cfg, params, cache, steps, card: str,
                        stream=None) -> None:
    """``graph_vs_eager`` for the engine's decode iteration
    (``engine._decode_iteration``) over ``cache`` and its copy, each step's
    feed its pos, active and (paged) block tables, through a StepGraphs
    keyed as the engine keys it, replayed on ``stream`` (a chip decode
    side's; None: the current stream)."""
    from repro_torch.core import engine as E
    from repro_torch.core.graphs import StepGraphs
    twin = _clone_tree(cache)
    graphs = StepGraphs()

    def args(feed):
        return [feed["pos"], feed["active"]] + (
            [feed["bt"]] if "bt" in feed else [])

    def eager(tok, feed):
        return E._decode_iteration(params, twin, tok, *args(feed), cfg=cfg)

    def graphed(key, tok, feed):
        with _side(stream):
            return graphs(key, lambda *a: E._decode_iteration(
                params, cache, *a, cfg=cfg), tok, *args(feed))
    b = steps[0][1]["pos"].shape[0]
    tok = torch.randint(0, cfg.vocab_size, (b, 1), dtype=torch.int32,
                        generator=torch.Generator(device="cuda").manual_seed(
                            4), device="cuda")
    graph_vs_eager(what, steps, eager, graphed, twin, cache, tok, card)
    log(f"graphs {what}: " + ", ".join(f"{k}: captured in {t:.3f} s"
                                       for k, t in graphs.captures))
    graphs.drop()


def _fill_random(cache, seed: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for t in _leaves(cache):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))


def _decode_feed(rng, n_b: int, slots: int, max_blocks: int):
    """(pos, active, block tables) of one paged decode step, as device
    tensors, and the pages no table names (numpy): the tables drawn from a
    fresh permutation of the ``slots·max_blocks`` pages (the ownership
    changing between steps), the longest slot's live pages past half the
    bucket (the width the engine would pick), the last slot inactive on
    the trash page ``slots·max_blocks``."""
    n_pages = slots * max_blocks
    perm = rng.permutation(n_pages)
    bt = np.full((slots, n_b), n_pages, np.int32)
    need = rng.integers(1, n_b + 1, slots)
    need[0] = max(need[0], n_b // 2 + 1)
    pos = (need - 1) * PS + rng.integers(0, PS, slots)
    pos[-1] = rng.integers(0, n_b * PS)
    for i in range(slots - 1):
        bt[i, :need[i]] = perm[i * max_blocks:i * max_blocks + need[i]]
    active = np.arange(slots) < slots - 1
    return (torch.from_numpy(pos.astype(np.int32)).cuda(),
            torch.from_numpy(active).cuda(), torch.from_numpy(bt).cuda(),
            perm[(slots - 1) * max_blocks:])


def paged_graph_steps(buckets, slots: int, max_blocks: int, seed: int):
    """(key, feed) per step: 3 steps per table bucket (``_decode_feed``)."""
    rng = np.random.default_rng(seed)
    steps = []
    for n_b in buckets:
        for _ in range(3):
            pos, active, bt, _ = _decode_feed(rng, n_b, slots, max_blocks)
            steps.append((("paged", n_b), {"pos": pos, "active": active,
                                           "bt": bt}))
    return steps


def dense_graph_steps(slots: int, max_pos: int, seed: int):
    """(("dense",), feed) for GRAPH_STEPS steps from random positions below
    ``max_pos``, every slot but the last active."""
    pos = np.random.default_rng(seed).integers(0, max_pos - GRAPH_STEPS,
                                               slots).astype(np.int32)
    active = torch.from_numpy(np.arange(slots) < slots - 1).cuda()
    return [(("dense",), {"pos": torch.from_numpy(pos + i).cuda(),
                          "active": active}) for i in range(GRAPH_STEPS)]


#: the fused graphs check: the fused repeats it runs, each at two decode
#: shares (8 and 62 of the card's 132 SMs, the serve's smallest and largest
#: common ones) and at two table buckets, with a prompt of FUSED_SP tokens
FUSED_REPS, FUSED_SHARES, FUSED_SP = (0, 13, 27), (8 / 132, 62 / 132), 256
#: the prefill graphs check: batch sizes and padded lengths (buckets)
PREFILL_BPS, PREFILL_LENS = (1, 4), (128, 1024)


def _moved(c0, c1) -> tuple:
    return tuple(b - a for a, b in zip(c0, c1))


def fused_graphs_check(cfg, params, cache, buckets, card: str,
                       name: str = "qwen3-1.7b", reps=FUSED_REPS,
                       moe: bool = False) -> None:
    """The fused cycle in segments through a StepGraphs
    (``engine._fused_step``: the embedding, each decode repeat but the
    fused one and the head replayed, the fused repeat eager) against
    ``T.fused_group_decode`` called directly on a copy of the page pool,
    bf16, full width and depth: at the smallest and largest table bucket
    the serve reached, the fused repeat ``rep`` in ``reps``, each at both
    FUSED_SHARES, decode tables and the prompt drawn anew every step. Fatal
    unless after every step the prompt activations, the tokens, the logits
    and the page pool are bit-equal and the launch counters moved alike.
    ``moe``: the prompt is shorter than its padded length, and the
    prefill side's MoE metrics summed on each side are bit-equal too."""
    from repro_torch.core import engine as E
    from repro_torch.core.graphs import StepGraphs, launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import MoEStats
    slots, max_blocks = 8, -(-1152 // PS)
    stats_e = stats_g = lengths = None
    if moe:
        stats_e, stats_g = MoEStats("cuda"), MoEStats("cuda")
        lengths = torch.tensor([FUSED_SP - 37], dtype=torch.int32,
                               device="cuda")
    twin = _clone_tree(cache)
    graphs = StepGraphs()
    x_d = torch.zeros((slots, 1, cfg.d_model), dtype=torch.bfloat16,
                      device="cuda")
    graphs.keep(x_d)
    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda").manual_seed(13)
    positions = torch.arange(FUSED_SP, device="cuda")[None, :]
    tok = torch.randint(0, cfg.vocab_size, (slots, 1), dtype=torch.int32,
                        generator=gen, device="cuda")
    tok_e, n, per_step = tok.clone(), 0, set()
    widths = sorted({buckets[0], buckets[-1]})
    for n_b in widths:
        for rep in reps:
            for share in FUSED_SHARES:
                pos, active, bt, spare = _decode_feed(rng, n_b, slots,
                                                      max_blocks)
                page_map = torch.from_numpy(
                    spare[:FUSED_SP // PS][None].astype(np.int32)).cuda()
                x_p = torch.randn((1, FUSED_SP, cfg.d_model), generator=gen,
                                  device="cuda").to(torch.bfloat16)
                c0 = launch_counts()
                x_e, lg_e = T.fused_group_decode(
                    params, twin, x_p.clone(), positions, page_map, tok_e,
                    pos, cfg, rep=rep, decode_share=share, block_tables=bt,
                    lengths=lengths, stats=stats_e)
                nt_e = torch.where(active, lg_e.argmax(-1).to(torch.int32),
                                   0)[:, None]
                c1 = launch_counts()
                nt_g, lg_g = E._fused_step(
                    graphs, params, cache, x_p, positions, page_map, x_d, tok,
                    pos, active, bt, cfg=cfg, rep=rep, decode_share=share,
                    lengths=lengths, stats=stats_g)
                c2 = launch_counts()
                what = (f"graphs {name} fused, rep {rep}, n_b {n_b}, "
                        f"share {share:.4f}")
                check(torch.equal(x_p, x_e), f"{what}: x_p differs")
                check(torch.equal(nt_g, nt_e), f"{what}: tokens differ")
                check(torch.equal(lg_g, lg_e), f"{what}: logits differ")
                for i, (a, b) in enumerate(zip(_leaves(cache),
                                               _leaves(twin))):
                    check(torch.equal(a, b), f"{what}: pool leaf {i} differs")
                d_e, d_g = _moved(c0, c1), _moved(c1, c2)
                check(d_e == d_g, f"{what}: the eager step moved the "
                      f"counters by {d_e}, the graphed one by {d_g}")
                per_step.add(d_e)
                tok, tok_e, n = nt_g.clone(), nt_e.clone(), n + 1
    check(len(per_step) == 1, f"fused steps moved the counters unalike: "
          f"{per_step}")
    if moe:
        check(torch.equal(stats_e.sums, stats_g.sums),
              f"graphs {name} fused: MoE sums {stats_e.sums.tolist()} eager, "
              f"{stats_g.sums.tolist()} segmented")
    one = {k: d for k, d in zip(_counter_names(), per_step.pop()) if d}
    log(f"graphs {name} fused: {n} fused steps (rep {tuple(reps)}, "
        f"table buckets {widths}, shares "
        f"{[round(x, 4) for x in FUSED_SHARES]}), prompt activations, "
        f"tokens, logits and page pool bit-equal to T.fused_group_decode; "
        f"launches of each step {one}, graphed as eager; {captures(graphs)}"
        f"  [{card}]")
    graphs.drop()


def prefill_graphs_check(cfg, params, cache, card: str,
                         name: str = "qwen3-1.7b", moe: bool = False,
                         kinds=("p_group", "p_final"), stream=None,
                         bps=None) -> None:
    """The paged prefill groups (``engine._prefill_group_paged``) and the
    prompts' first tokens (``engine._final_tokens``) through a StepGraphs
    keyed ``(kinds[0], rep, Bp, S)`` and ``(kinds[1], Bp, S)`` (the chip
    prefill side's ``c_group`` and ``c_final`` replayed on its ``stream``,
    over its staging pool; Bp in ``bps``, default PREFILL_BPS) against
    the same functions called directly on a copy of the page pool, bf16,
    full width and depth: for each Bp in PREFILL_BPS and padded length S
    in PREFILL_LENS two prompt batches, one after the other, in one set of
    persistent buffers (the first captures, the second replays; pages and
    lengths drawn anew). Fatal unless after every group the activations,
    after every batch the page pool (but the trash page, which the padded
    rows reach in no set order) and the first tokens are bit-equal and the
    launch counters moved alike. The groups read each batch's lengths, as
    the engine's do; ``moe``: the MoE metrics summed on each side are
    bit-equal too."""
    from repro_torch.core import engine as E
    from repro_torch.core.graphs import StepGraphs, launch_counts
    from repro_torch.models.moe import MoEStats
    n_pages = 8 * -(-1152 // PS)
    stats_e = MoEStats("cuda") if moe else None
    stats_g = MoEStats("cuda") if moe else None
    twin = _clone_tree(cache)
    graphs = StepGraphs()
    rng = np.random.default_rng(14)
    gen = torch.Generator(device="cuda").manual_seed(15)
    groups = 0
    bps = bps or PREFILL_BPS
    for bp in bps:
        for s in PREFILL_LENS:
            bufs = (torch.empty((bp, s, cfg.d_model), dtype=torch.bfloat16,
                                device="cuda"),
                    torch.arange(s, device="cuda")[None, :],
                    torch.empty((bp,), dtype=torch.int32, device="cuda"),
                    torch.empty((bp, s // PS), dtype=torch.int32,
                                device="cuda"))
            graphs.keep(*bufs)
            for _ in range(2):
                lens = rng.integers(s // 2 + 1, s + 1, bp).astype(np.int32)
                perm = rng.permutation(n_pages)
                pm = np.full((bp, s // PS), n_pages, np.int32)
                for i, n in enumerate(lens):
                    need = -(-int(n) // PS)
                    pm[i, :need] = perm[i * (s // PS):i * (s // PS) + need]
                x_e = torch.randn((bp, s, cfg.d_model), generator=gen,
                                  device="cuda").to(torch.bfloat16)
                bufs[0].copy_(x_e)
                bufs[2].copy_(torch.from_numpy(lens))
                bufs[3].copy_(torch.from_numpy(pm))
                what = f"graphs {name} {kinds[0]}, Bp {bp}, S {s}"
                for rep in range(cfg.n_pattern_repeats):
                    c0 = launch_counts()
                    x_e = E._prefill_group_paged(params, twin, x_e.clone(),
                                                 bufs[1], bufs[3], bufs[2],
                                                 cfg=cfg, rep=rep,
                                                 stats=stats_e)
                    c1 = launch_counts()
                    with _side(stream):
                        graphs((kinds[0], rep, bp, s), functools.partial(
                            E._prefill_group_paged, params, cache, cfg=cfg,
                            rep=rep, stats=stats_g), bufs[0], bufs[1],
                            bufs[3], bufs[2])
                    c2 = launch_counts()
                    check(torch.equal(bufs[0], x_e),
                          f"{what}: activations after rep {rep} differ")
                    check(_moved(c0, c1) == _moved(c1, c2),
                          f"{what}, rep {rep}: launches {_moved(c0, c1)} "
                          f"eager, {_moved(c1, c2)} graphed")
                    groups += 1
                # every page but the trash page, which takes the padded
                # rows of every prompt in no set order
                for i, (a, b) in enumerate(zip(_leaves(cache),
                                               _leaves(twin))):
                    check(torch.equal(a[:, :n_pages], b[:, :n_pages]),
                          f"{what}: pool leaf {i} differs")
                ft_e = E._final_tokens(params, x_e, bufs[2], cfg=cfg)
                with _side(stream):
                    ft_g = graphs((kinds[1], bp, s), functools.partial(
                        E._final_tokens, params, cfg=cfg), bufs[0], bufs[2])
                check(torch.equal(ft_g, ft_e), f"{what}: first tokens differ")
    if moe:
        check(torch.equal(stats_e.sums, stats_g.sums),
              f"graphs {name} prefill: MoE sums {stats_e.sums.tolist()} "
              f"eager, {stats_g.sums.tolist()} graphed")
    log(f"graphs {name} prefill ({kinds[0]}, {kinds[1]}"
        f"{', on a side stream' if stream is not None else ''}): {groups} "
        f"groups over Bp {bps} x S {PREFILL_LENS}, two batches each "
        f"(capture, replay): "
        f"activations, page pool and first tokens bit-equal to the eager "
        f"functions, launches graphed as eager; {captures(graphs)}  [{card}]")
    graphs.drop()


def phase_graphs(card: str, buckets) -> None:
    """The engine's graphs against the eager step (the module-level step
    function called directly) on two copies of one cache, at full width
    and depth, bf16: Qwen3-1.7B's engine iteration on the paged cache at
    every table bucket the serve reached (8 slots of 1152 rows, the tables
    changed between replays), its fused cycle in segments
    (``fused_graphs_check``) and its prefill groups and first tokens
    (``prefill_graphs_check``) on the same pool, and on the dense cache,
    Mamba-2-2.7B's on its dense cache (conv windows and SSD states), both
    drawn at random, and
    RecurrentGemma-2B's ``decode_step`` through ``GraphedDecode`` after the
    padded prefill of its phase's prompts. Tokens equal, logits and caches
    bit-equal after every step, launches as ``graph_vs_eager`` holds them;
    each check prints its keys' capture seconds."""
    from repro_torch.configs import get_config
    from repro_torch.core.graphs import GraphedDecode
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-1.7b")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    _paged_graphs("qwen3-1.7b", cfg, params, buckets, card, FUSED_REPS, 6)
    cache = T.init_cache(cfg, 8, 1152, torch.bfloat16, "cuda")
    _fill_random(cache, 8)
    engine_graphs_check("qwen3-1.7b dense", cfg, params, cache,
                        dense_graph_steps(8, 1152, 9), card)
    del cache, params

    cfg = get_config("mamba2-2.7b")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    cache = T.init_cache(cfg, 8, MAX_LEN, torch.bfloat16, "cuda")
    _fill_random(cache, 10)
    engine_graphs_check("mamba2-2.7b dense", cfg, params, cache,
                        dense_graph_steps(8, MAX_LEN, 11), card)
    del cache, params
    torch.cuda.empty_cache()

    cfg = get_config("recurrentgemma-2b")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    b = len(RG_PROMPTS)
    toks, lens = _prompt_batch(cfg, RG_PROMPTS, seed=3)
    toks, lens = toks.cuda(), lens.cuda()
    cache = T.init_cache(cfg, b, max(RG_PROMPTS) + RG_DECODE,
                         torch.bfloat16, "cuda")
    logits, _ = T.prefill(params, toks, lens, cache, None, cfg)
    twin = _clone_tree(cache)
    dec = GraphedDecode(params, cache, cfg)

    def eager(tok, feed):
        lg, _ = T.decode_step(params, twin, tok, feed["pos"], cfg)
        return lg.argmax(-1).to(torch.int32)[:, None], lg

    def graphed(key, tok, feed):
        lg = dec(tok, feed["pos"])
        return lg.argmax(-1).to(torch.int32)[:, None], lg
    graph_vs_eager("recurrentgemma-2b", [(("rg", b), {"pos": lens + i})
                                         for i in range(GRAPH_STEPS)],
                   eager, graphed, twin, cache,
                   logits.argmax(-1).to(torch.int32)[:, None], card)
    log(f"graphs recurrentgemma-2b: {captures(dec)}")
    del twin, dec, cache, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# mixture of experts: Llama-4 Maverick (paged, fused) and Mixtral-8x22B
# (sliding window, dense ring cache), and the multi-head Qwen1.5-4B
# ---------------------------------------------------------------------------

#: the reference's prompts (both past the reduced 64-token window) and
#: decode steps; the engine reference's requests
MOE_REF_PROMPTS, MOE_REF_DECODE = (150, 80), 8
MOE_ENGINE = dict(n=6, lo=30, hi=120, out=8)
#: Mixtral's serve: prompts of about 4200, 1500, 600 and 64 tokens, each
#: decoding MX_DECODE tokens, at the published widths over MX_LAYERS of
#: its 56 layers
MX_PROMPTS, MX_DECODE, MX_LAYERS = (4200, 1500, 600, 64), 32, 8


def _reduced_heads(name: str, head_dim: int = 128):
    """``name`` at the reduced widths with a head dim the kernels are
    built for, its own query and kv heads (so its own G), experts and
    top-k."""
    from repro_torch.configs import get_config
    full = get_config(name)
    return full.reduced(head_dim=head_dim, n_heads=full.n_heads,
                        n_kv_heads=full.n_kv_heads,
                        n_experts=full.n_experts,
                        n_experts_per_token=full.n_experts_per_token)


#: a param or cache tree's tensors on the CPU, its nesting kept
_to_cpu = functools.partial(_map_tree, torch.Tensor.cpu)


def _kernel_counts():
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.kernels import ssd_scan as SK
    return {"flash": FA.launches, "paged_decode": PD.launches,
            "decode": DA.launches, "bullet_paged": BA.launches,
            "ssd": SK.launches}


def _reset_counts() -> None:
    from repro_torch.core.graphs import COUNTERS
    for m, a in COUNTERS:
        setattr(m, a, 0)


class _Calls(list):
    """A model ``stats`` argument that keeps each MoE call's metrics in
    order (eager calls only)."""
    add = list.append


def _engine_streams(cfg, params, device, dtype, prompts, fused: bool):
    """The port's BulletServer over ``prompts`` (MOE_ENGINE's outputs, one
    prompt per prefill batch, pause off) on ``device``, the virtual clock
    advancing 1 ms a cycle: (outputs, cycles, stats, moe sums)."""
    from repro_torch.core.config import (ControlConfig, ExecConfig,
                                         ServerConfig)
    from repro_torch.core.engine import BulletServer
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.serving.request import SLO, Request

    server = BulletServer(cfg, params, config=ServerConfig(
        slo=SLO(3.0, 150.0), max_slots=4, max_len=256, max_prefill_batch=1,
        dtype=dtype, execution=ExecConfig(fused=fused),
        control=ControlConfig(sched=SchedulerConfig(
            max_decode_pause_cycles=0))), device=device)
    for rid, p in enumerate(prompts):
        server.submit(Request(rid=rid, arrival=0.0, prompt_len=len(p),
                              output_len=MOE_ENGINE["out"]), p)
    now, cycles = 0.0, 0
    while not server.idle:
        check(cycles < 5000, f"{cfg.name} engine on {device} did not drain")
        server.step(now)
        server.check_invariants()
        now += 1e-3
        cycles += 1
    moe = server.moe_stats.read() if server.moe_stats is not None else None
    return server.outputs, cycles, server.stats, moe


def _engine_card_vs_cpu(name: str, cfg, prompts, seed: int, fused: bool,
                        card: str) -> dict:
    """``cfg`` (reduced) through BulletServer in fp32 with params drawn
    from ``seed``, on the card (kernels) and on the CPU (plain versions),
    over ``prompts`` (``_engine_streams``): streams, cycles and MoE sums
    equal; ``fused``: a fused cycle ran on the card. Returns the card's
    launch counts."""
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, seed=seed, dtype=torch.float32,
                           device="cuda")
    got = {}
    for side, p in (("cuda", params), ("cpu", _to_cpu(params))):
        _reset_counts()
        got[side] = _engine_streams(cfg, p, p["embed"].device, torch.float32,
                                    prompts, fused)
        if side == "cuda":
            counts = _kernel_counts()
    check(got["cuda"][0] == got["cpu"][0],
          f"{name} engine: card and CPU streams differ")
    check(got["cuda"][1] == got["cpu"][1],
          f"{name} engine: {got['cuda'][1]} cycles on the card, "
          f"{got['cpu'][1]} on the CPU")
    moe_c, moe_h = got["cuda"][3], got["cpu"][3]
    if moe_c is not None:
        # the drops follow from the routing alone; the load-balance loss
        # sums softmax outputs, rounded apart on the two devices
        check({k: v for k, v in moe_c.items() if k != "load_balance_loss"}
              == {k: v for k, v in moe_h.items()
                  if k != "load_balance_loss"}
              and math.isclose(moe_c["load_balance_loss"],
                               moe_h["load_balance_loss"], rel_tol=1e-4),
              f"{name} engine: MoE sums {moe_c} on the card, {moe_h} on "
              "the CPU")
    st = got["cuda"][2]
    if fused:
        check(st.fused_cycles > 0 and counts["bullet_paged"] > 0,
              f"{name} engine: no fused cycle")
    sums = "" if moe_c is None else f" and MoE sums {moe_c}"
    log(f"engine reference {name}: reduced widths, H={cfg.n_heads} "
        f"K={cfg.n_kv_heads} D={cfg.head_dim}, fp32, "
        f"{'fused' if fused else 'serial'}, {len(prompts)} requests: card "
        f"and CPU streams, cycles ({got['cuda'][1]}){sums} equal; "
        f"{st.fused_cycles} fused cycles; card launches {counts}  [{card}]")
    return counts


def phase_moe_reference(card: str) -> dict:
    """(a) The MoE models at reduced widths with head dim 128 and their own
    heads, experts and top-k, fp32, card (kernels) against CPU (plain
    versions): Llama-4 Maverick's prefill into the page pool + paged
    decode, Mixtral's into its 64-row ring + ring decode (prompts of
    MOE_REF_PROMPTS tokens as one padded batch, MOE_REF_DECODE greedy
    steps): logits within 1e-3 of scale, tokens equal, every MoE call's
    dropped fraction equal; then Llama-4 through BulletServer fused and
    Qwen1.5-4B (H = K = 20) serial, card against CPU, streams equal, and
    Qwen1.5-4B in bf16 on the card. Returns the launches of each fp32 row
    (and the G = 1 rows' in both dtypes)."""
    from repro_torch.models import transformer as T

    launches = {}
    for name in ("llama4-maverick-400b-a17b", "mixtral-8x22b"):
        cfg = _reduced_heads(name)
        paged = T.supports_paged_cache(cfg)
        params = T.init_params(cfg, seed=3, dtype=torch.float32,
                               device="cuda")
        cpu = _to_cpu(params)
        toks, lens = _prompt_batch(cfg, MOE_REF_PROMPTS, seed=4)
        b, s = toks.shape
        max_len = s + MOE_REF_DECODE
        n_b = -(-max_len // PS)
        page_map = torch.arange(b * n_b, dtype=torch.int32).reshape(b, n_b)
        outs, drops = {}, {}
        for side, p in (("cuda", params), ("cpu", cpu)):
            dev = p["embed"].device
            stats = _Calls()
            _reset_counts()
            if paged:
                cache = T.init_paged_cache(cfg, b * n_b, PS, torch.float32,
                                           dev)
                pm = page_map[:, :-(-s // PS)].to(dev)
            else:
                cache = T.init_cache(cfg, b, max_len, torch.float32, dev)
                pm = None
            logits, _ = T.prefill(p, toks.to(dev), lens.to(dev), cache, pm,
                                  cfg, stats=stats)
            seq = [logits.float().cpu()]
            tok = logits.argmax(-1)
            for i in range(MOE_REF_DECODE):
                logits, _ = T.decode_step(
                    p, cache, tok[:, None].to(torch.int32),
                    (lens + i).to(torch.int32).to(dev), cfg,
                    block_tables=page_map.to(dev) if paged else None)
                seq.append(logits.float().cpu())
                tok = logits.argmax(-1)
            outs[side] = seq
            drops[side] = [float(m.dropped_fraction) for m in stats]
            if side == "cuda":
                counts = _kernel_counts()
        worst = _card_vs_cpu(outs, cfg)
        check(drops["cuda"] == drops["cpu"],
              f"{name}: per-call dropped fractions differ, card "
              f"{drops['cuda']}, CPU {drops['cpu']}")
        decode_kind = "paged_decode" if paged else "decode"
        check(counts["flash"] > 0 and counts[decode_kind] > 0,
              f"{name} reference: launches {counts}")
        if paged:
            launches["paged_decode_attention_llama4_fp32"] = \
                counts["paged_decode"]
        else:
            launches["flash_attention_mixtral_fp32"] = counts["flash"]
            launches["decode_attention_mixtral_fp32"] = counts["decode"]
        log(f"moe reference {name}: reduced widths, H={cfg.n_heads} "
            f"K={cfg.n_kv_heads} D={cfg.head_dim}, {cfg.n_experts} experts "
            f"top-{cfg.n_experts_per_token}, fp32, "
            f"{'paged' if paged else 'dense ring'} cache, prompts "
            f"{list(MOE_REF_PROMPTS)} + {MOE_REF_DECODE} decode steps: card "
            f"vs CPU max rel logit err {worst:.2e}, tokens equal, per-call "
            f"dropped fractions equal {[round(x, 4) for x in drops['cuda']]}"
            f"; launches {counts}  [{card}]")

    rng = np.random.default_rng(6)
    m = MOE_ENGINE
    for name, fused in (("llama4-maverick-400b-a17b", True),
                        ("qwen1.5-4b", False)):
        cfg = _reduced_heads(name)
        prompts = [rng.integers(0, cfg.vocab_size,
                                int(rng.integers(m["lo"], m["hi"])))
                   .astype(np.int32) for _ in range(m["n"])]
        counts = _engine_card_vs_cpu(name, cfg, prompts, 5, fused, card)
        if fused:
            launches["bullet_attention_paged_llama4_fp32"] = \
                counts["bullet_paged"]
        else:
            launches["flash_attention_qwen15_fp32"] = counts["flash"]
            launches["paged_decode_attention_qwen15_fp32"] = \
                counts["paged_decode"]
        if name == "qwen1.5-4b":
            p16 = T.init_params(cfg, seed=5, dtype=torch.bfloat16,
                                device="cuda")
            _reset_counts()
            outs, cycles, st16, _ = _engine_streams(cfg, p16, "cuda",
                                                    torch.bfloat16, prompts,
                                                    True)
            counts = _kernel_counts()
            check(all(len(v) == m["out"] for v in outs.values()),
                  "qwen1.5-4b bf16: a request unfinished")
            check(counts["flash"] > 0 and counts["paged_decode"] > 0,
                  f"qwen1.5-4b bf16: launches {counts}")
            launches["flash_attention_qwen15"] = counts["flash"]
            launches["paged_decode_attention_qwen15"] = counts["paged_decode"]
            log(f"moe reference qwen1.5-4b bf16 on the card, fused: "
                f"{cycles} cycles, {st16.fused_cycles} fused, launches "
                f"{counts}  [{card}]")
    return launches


def _first_diff(a, b) -> int:
    """The first index where two token streams differ."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _moe_ms(timer, cfg, params, card: str, what: str, b: int, s: int):
    """One MoE layer (``T._ff`` of the first MoE block: norm, router,
    every expert's two products, the shared expert) on (b, s) random
    activations in the served dtype, card ms, beside two bounds: the bytes
    of every expert's weights (what the einsum reads whatever the routing)
    and of the experts this call routed to (what a grouped kernel would
    read, ROADMAP R14)."""
    from repro_torch.configs.base import MOE
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    j = next(i for i, blk in enumerate(cfg.pattern) if blk.ff == MOE)
    p = T.params_at(params["blocks"][j], 0)
    blk = cfg.pattern[j]
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((b, s, cfg.d_model), generator=gen,
                    device="cuda").to(p["w_in"].dtype)
    # a prefill call routes each row's length, a decode call the slot array
    lengths = (torch.full((b,), s, dtype=torch.int32, device="cuda")
               if s > 1 else None)
    ms = timer(lambda: T._ff(x, p, blk, cfg, lengths))
    hn = L.rms_norm(x, p["ln2"], cfg.rmsnorm_eps).reshape(-1, cfg.d_model)
    _, experts, _ = M.route_topk(hn @ p["router"], cfg.n_experts_per_token)
    touched = int(torch.unique(experts).numel())
    e_bytes = (p["w_in"][0].numel() + p["w_out"][0].numel()) \
        * esize(p["w_in"].dtype)
    other = sum(p[n].numel() for n in ("ln2", "router", "shared_wi",
                                       "shared_wo") if n in p) \
        * esize(p["w_in"].dtype)
    all_ms = (cfg.n_experts * e_bytes + other) / HBM_BW * 1e3
    routed_ms = (touched * e_bytes + other) / HBM_BW * 1e3
    log(f"moe layer {what}: {ms:.3f} ms card time on ({b}, {s}) tokens; "
        f"bound by the bytes of all {cfg.n_experts} experts {all_ms:.3f} ms "
        f"({100 * all_ms / ms:.1f}% of it), of the {touched} routed to "
        f"{routed_ms:.3f} ms  [{card}]")
    return ms


def phase_moe(card: str, timer: Timer) -> dict:
    """(b) Llama-4 Maverick at its published widths, one pattern repeat (a
    dense and a MoE layer of its 48; 128 experts top-1 and the shared
    expert), bf16: the serve phase's 12 requests fused (pause off) and
    serial, streams identical (the bf16 split decode cuts each slot's own
    rows, so a slot's result does not depend on the table bucket the
    other slots set), then under the scheduler's defaults;
    kernel 1-3 launches, the fused shares, the host split, tok/s, the
    prefill groups' drops, a profile window of serial decode cycles and
    the MoE layer's card ms at the decode and a prefill shape. (c) its
    graphs against the eager steps, with the MoE layer inside, on two
    repeats sharing the one repeat's weights: the serial decode iteration
    at the serve's table buckets, the fused cycle in segments (``d_rep``
    included) and the prefill groups and first tokens; then Mixtral's
    dense decode iteration. (d) Mixtral-8x22B at its published widths over
    MX_LAYERS layers, bf16, dense ring cache, serial: prompts of
    MX_PROMPTS tokens, MX_DECODE steps each; windowed flash and ring decode
    launches. Returns the bf16 rows' launches."""
    launches = _moe_llama4(card, timer)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(_moe_mixtral(card, timer))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _serve_full(name: str, cfg, params, card: str, moe: bool = False):
    """``cfg`` at full width on the paged path through BulletServer, bf16:
    the serve phase's 12 requests fused (the pause off; launches counted,
    the fused cycles' decode shares, the prefill padding, the host split),
    serial (streams identical to the fused run's, the host split, a
    profile window over 10 serial decode cycles once every prompt is in,
    with its device busy share), then under the scheduler's defaults.
    ``moe``: every prefill group made one MoE call; its drops are printed.
    Returns (the fused serve's launch counts, the serial serve's decode
    table buckets)."""
    from repro_torch.core.engine import prefill_bucket

    prompts, out_lens, arrivals = serve_workload(cfg)
    n_tok = int(sum(out_lens))
    _serve(cfg, params, prompts[:2], [2, 2], [0.0, 0.0], fused=True)

    _reset_counts()
    fused_shares, split = FusedShares(), HostSplit()
    server, secs, cycles = _serve(
        cfg, params, prompts, out_lens, arrivals, fused=True,
        audit=lambda srv: (fused_shares(srv), split(srv)))
    counts = _kernel_counts()
    for rid, o in enumerate(out_lens):
        got = server.outputs.get(rid, [])
        check(len(got) == o and all(0 <= t < cfg.vocab_size for t in got),
              f"{name} serve: request {rid}: {len(got)} tokens, want {o}")
    check(server.pool.available_blocks == server.pool.n_blocks,
          f"{name} serve: KV pool not clean")
    check(server.stats.fused_cycles > 0, f"{name} serve: no fused cycle")
    for kind in ("flash", "paged_decode", "bullet_paged"):
        check(counts[kind] > 0, f"{name} serve: no {kind} launch")
    drops = ""
    if moe:
        m = server.moe_stats.read()
        check(m["calls"] == server.stats.prefill_cycles,
              f"{name} serve: {m['calls']} MoE prefill calls, "
              f"{server.stats.prefill_cycles} prefill groups")
        drops = (f"; drops per prefill group: {m['dropping_calls']} of "
                 f"{m['calls']} groups dropped, mean dropped fraction "
                 f"{m['mean_dropped_fraction']:.4f}")
    log(f"{name} serve fused: {n_tok} tokens in {secs:.3f} s = "
        f"{n_tok / secs:.1f} tok/s, {cycles} cycles, "
        f"{server.stats.fused_cycles} fused, {server.stats.prefill_cycles} "
        f"prefill groups, launches {counts}{drops}; {captures(server)}  "
        f"[{card}]")
    # one prompt per prefill batch, each padded to its length bucket
    real = sum(len(p) for p in prompts)
    pad = sum(prefill_bucket(len(p), 1152, PS) for p in prompts)
    log(f"{name} serve fused: decode_share of the fused cycles: "
        f"{share_histogram(fused_shares.shares)}; prefill batches: {real} "
        f"prompt tokens padded to {pad} "
        f"({100 * (1 - real / pad):.1f}% padding)")
    for kind in sorted(split.cycles):
        log(f"{name} fused host split: {host_split_line(split, kind)}")

    prof = ProfileCycles(1, 10, when=lambda srv: (srv.ptask is None
                                                  and not srv.pending))
    s_split = HostSplit()
    serial, s_secs, s_cycles = _serve(
        cfg, params, prompts, out_lens, arrivals, fused=False,
        audit=lambda srv: (prof(srv), s_split(srv)))
    check(serial.stats.fused_cycles == 0, f"{name} serial run fused")
    for rid in range(len(prompts)):
        check(serial.outputs[rid] == server.outputs[rid],
              f"{name} request {rid}: fused and serial streams differ from "
              f"token {_first_diff(serial.outputs[rid], server.outputs[rid])}")
    buckets = sorted({k[1] for k, _ in serial.graphs.captures
                      if k[0] == "paged"})
    log(f"{name} serve serial: {n_tok / s_secs:.1f} tok/s, {s_cycles} "
        f"cycles; token streams identical to the fused run's "
        f"({server.stats.fused_cycles} fused cycles), decode table buckets "
        f"{buckets} pages; {captures(serial)}  [{card}]")
    for kind in sorted(s_split.cycles):
        log(f"{name} serial host split: {host_split_line(s_split, kind)}")
    window = prof.report(f"10 serial decode cycles of {name}'s serial serve "
                         "(8 slots)", card)
    log(f"{name} decode window: device busy share "
        f"{100 * window['busy_share']:.1f}%")
    d_split = HostSplit()
    _reset_counts()
    dflt, d_secs, d_cycles = _serve(cfg, params, prompts, out_lens,
                                    arrivals, fused=True, default_sched=True,
                                    audit=d_split)
    for rid, o in enumerate(out_lens):
        check(len(dflt.outputs.get(rid, [])) == o,
              f"{name} default scheduler: request {rid} unfinished")
    log(f"{name} serve default scheduler: {n_tok / d_secs:.1f} tok/s, "
        f"{dflt.stats.fused_cycles} of {d_cycles} cycles fused, "
        f"{dflt.stats.paused_cycles} paused, launches {_kernel_counts()}; "
        f"{captures(dflt)}  [{card}]")
    for kind in sorted(d_split.cycles):
        log(f"{name} default scheduler host split: "
            f"{host_split_line(d_split, kind)}")
    del server, serial, dflt, split, s_split, d_split
    gc.collect()
    torch.cuda.empty_cache()
    return counts, buckets


def _paged_graphs(name: str, cfg, params, buckets, card: str, reps,
                  seed: int, moe: bool = False) -> None:
    """``cfg``'s graphs against the eager steps on a page pool of 8 slots
    of 1152 rows drawn from ``seed``, bf16: the serial decode iteration at
    the table ``buckets``, the fused cycle in segments at the repeats
    ``reps``, the prefill groups and first tokens."""
    from repro_torch.models import transformer as T
    max_blocks = -(-1152 // PS)
    cache = T.init_paged_cache(cfg, 8 * max_blocks, PS, torch.bfloat16,
                               "cuda")
    _fill_random(cache, seed)
    engine_graphs_check(f"{name} paged", cfg, params, cache,
                        paged_graph_steps(buckets, 8, max_blocks, seed + 1),
                        card)
    fused_graphs_check(cfg, params, cache, buckets, card, name=name,
                       reps=reps, moe=moe)
    prefill_graphs_check(cfg, params, cache, card, name=name, moe=moe)


def _moe_llama4(card: str, timer: Timer) -> dict:
    """``phase_moe``'s (b) and (c); returns the bf16 Llama-4 rows'
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    launches = {}
    full = get_config("llama4-maverick-400b-a17b")
    check(full.d_model == 5120 and full.n_heads == 40 and full.n_kv_heads == 8
          and full.n_experts == 128 and full.n_experts_per_token == 1
          and full.d_ff == 8192 and full.n_shared_experts == 1,
          "not the published Llama-4 Maverick widths")
    cfg = dataclasses.replace(full, n_layers=2)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"moe llama4-maverick: {T.param_count(params) / 1e9:.2f} G params "
        f"in bf16 ({torch.cuda.memory_allocated() / 2**30:.1f} GiB) drawn in "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")
    counts, buckets = _serve_full("llama4-maverick", cfg, params, card,
                                  moe=True)
    launches["paged_decode_attention_llama4"] = counts["paged_decode"]
    launches["bullet_attention_paged_llama4"] = counts["bullet_paged"]
    _moe_ms(timer, cfg, params, card, "llama4-maverick decode", 8, 1)
    _moe_ms(timer, cfg, params, card, "llama4-maverick prefill", 1, 1024)

    # (c) the graphs, with the MoE layer inside: two pattern repeats that
    # share the one repeat's weights (views, no copy)
    cfg2 = dataclasses.replace(full, n_layers=4)
    params2 = dict(params, blocks=tuple(
        {n: t.expand(2, *t.shape[1:]) for n, t in b.items()}
        for b in params["blocks"]))
    _paged_graphs("llama4-maverick", cfg2, params2, buckets, card, (0, 1),
                  16, moe=True)
    return launches


def _moe_mixtral(card: str, timer: Timer) -> dict:
    """``phase_moe``'s (d) and Mixtral's graph; returns the bf16 Mixtral
    rows' launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    launches = {}
    full = get_config("mixtral-8x22b")
    check(full.d_model == 6144 and full.n_heads == 48 and full.n_kv_heads == 8
          and full.n_experts == 8 and full.n_experts_per_token == 2
          and full.sliding_window == 4096 and full.d_ff == 16384,
          "not the published Mixtral-8x22B widths")
    cfg = dataclasses.replace(full, n_layers=MX_LAYERS)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"moe mixtral-8x22b: {T.param_count(params) / 1e9:.2f} G params in "
        f"bf16 ({torch.cuda.memory_allocated() / 2**30:.1f} GiB) drawn in "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in MX_PROMPTS]
    outs = [MX_DECODE] * len(prompts)
    max_len = -(-(max(MX_PROMPTS) + MX_DECODE) // PS) * PS
    _reset_counts()
    mx, m_secs, m_cycles = _serve(cfg, params, prompts, outs,
                                  [0.0] * len(prompts), fused=False,
                                  paged=False, max_len=max_len,
                                  max_slots=len(prompts))
    counts = _kernel_counts()
    for rid, o in enumerate(outs):
        got = mx.outputs.get(rid, [])
        check(len(got) == o and all(0 <= t < cfg.vocab_size for t in got),
              f"mixtral serve: request {rid}: {len(got)} tokens, want {o}")
    check(counts["flash"] == MX_LAYERS * len(prompts),
          f"mixtral serve: {counts['flash']} flash launches")
    check(counts["decode"] >= MX_LAYERS * (MX_DECODE - 1),
          f"mixtral serve: {counts['decode']} decode_attention launches")
    launches["flash_attention_mixtral"] = counts["flash"]
    launches["decode_attention_mixtral"] = counts["decode"]
    moe = mx.moe_stats.read()
    n_tok = len(prompts) * MX_DECODE
    log(f"moe mixtral-8x22b serve: {MX_LAYERS} layers, dense ring cache of "
        f"{min(cfg.sliding_window, max_len)} rows, serial, prompts "
        f"{list(MX_PROMPTS)}, {n_tok} tokens in {m_secs:.3f} s = "
        f"{n_tok / m_secs:.1f} tok/s, {m_cycles} cycles, launches {counts} "
        f"(windowed flash, ring decode); drops per prefill group: "
        f"{moe['dropping_calls']} of {moe['calls']} MoE calls dropped, mean "
        f"dropped fraction {moe['mean_dropped_fraction']:.4f}; "
        f"{captures(mx)}  [{card}]")
    _moe_ms(timer, cfg, params, card, "mixtral-8x22b decode",
            len(prompts), 1)
    del mx
    cache = T.init_cache(cfg, len(prompts), max_len, torch.bfloat16, "cuda")
    _fill_random(cache, 19)
    engine_graphs_check("mixtral-8x22b dense", cfg, params, cache,
                        dense_graph_steps(len(prompts), max_len, 20), card)
    return launches


def serve_workload(cfg):
    """The serve phase's 12 requests: prompts of 64-1024 and outputs of
    16-64 seeded tokens, Poisson arrivals 20 ms apart on average on the
    virtual clock (a choice of this smoke test that keeps prefill and
    decode co-resident, not a rate measured from any trace)."""
    rng = np.random.default_rng(0)
    n = 12
    prompt_lens = rng.integers(64, 1025, n)
    out_lens = rng.integers(16, 65, n)
    prompts = [rng.integers(0, cfg.vocab_size, int(L)).astype(np.int32)
               for L in prompt_lens]
    arrivals = np.cumsum(rng.exponential(0.02, n)).tolist()
    return prompts, out_lens.tolist(), arrivals


def phase_serve(card: str):
    from repro_torch.configs import get_config
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.models import transformer as T

    cfg = get_config("qwen3-1.7b")
    check(cfg.n_layers == 28 and cfg.d_model == 2048 and cfg.n_heads == 16
          and cfg.n_kv_heads == 8 and cfg.vocab_size == 151936,
          "not the full Qwen3-1.7B config")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    prompts, out_lens, arrivals = serve_workload(cfg)
    n = len(prompts)
    log(f"serve: qwen3-1.7b full width/depth bf16, {n} requests, prompts "
        f"{[len(p) for p in prompts]}, outputs {out_lens}, arrivals "
        f"every {arrivals[-1] / n * 1e3:.1f} ms on average (virtual clock)")
    # warm-up: cuBLAS handles and kernel modules load outside the timing
    _serve(cfg, params, prompts[:2], [2, 2], [0.0, 0.0], fused=True)

    FA.launches = PD.launches = BA.launches = 0
    fused_shares = FusedShares()
    split = HostSplit()
    padded = PaddedShare()
    server, secs, cycles = _serve(
        cfg, params, prompts, out_lens, arrivals, fused=True,
        audit=lambda srv: (fused_shares(srv), split(srv), padded(srv)))
    launches = {"flash_attention": FA.launches,
                "paged_decode_attention": PD.launches,
                "bullet_attention_paged": BA.launches}
    st = server.stats
    for rid, o in enumerate(out_lens):
        got = server.outputs.get(rid, [])
        check(len(got) == o, f"request {rid}: {len(got)} tokens, want {o}")
        check(all(0 <= t < cfg.vocab_size for t in got),
              f"request {rid}: token out of vocab")
    check(server.pool.available_blocks == server.pool.n_blocks,
          "KV pool not clean")
    check(st.fused_cycles > 0, "no fused cycle ran")
    for name, c in launches.items():
        check(c > 0, f"{name} never launched on the main path")
    n_tok = int(sum(out_lens))
    log(f"serve fused: {n_tok} tokens in {secs:.3f} s = "
        f"{n_tok / secs:.1f} tok/s, {cycles} cycles, stats {vars(st)}, "
        f"launches {launches}, KV pool clean: True; {captures(server)}  "
        f"[{card}]")
    log(f"serve fused: decode_share of the fused cycles: "
        f"{share_histogram(fused_shares.shares)}")
    log(f"serve fused: prefill batches: {padded.line()}")
    for kind in sorted(split.cycles):
        log(f"serve fused host split: {host_split_line(split, kind)}")

    s_split = HostSplit()
    serial, s_secs, s_cycles = _serve(cfg, params, prompts, out_lens,
                                      arrivals, fused=False, audit=s_split)
    check(serial.stats.fused_cycles == 0, "serial run fused")
    for rid in range(n):
        check(serial.outputs[rid] == server.outputs[rid],
              f"request {rid}: fused and serial token streams differ")
    log(f"serve serial: {n_tok / s_secs:.1f} tok/s, {s_cycles} cycles; "
        f"token streams identical to fused; {captures(serial)}  [{card}]")
    for kind in sorted(s_split.cycles):
        log(f"serve serial host split: {host_split_line(s_split, kind)}")

    # the dense slot cache in bf16, on 4 of the requests: the path of the
    # bf16 dense decode kernel (the split body) at D=128
    DA.launches = 0
    nd = 4
    dense, _, _ = _serve(cfg, params, prompts[:nd], out_lens[:nd],
                         arrivals[:nd], fused=False, paged=False)
    launches["decode_attention"] = DA.launches
    for rid, o in enumerate(out_lens[:nd]):
        got = dense.outputs.get(rid, [])
        check(len(got) == o and all(0 <= t < cfg.vocab_size for t in got),
              f"serve dense: request {rid}: {len(got)} tokens, want {o}")
    check(DA.launches >= cfg.n_layers * (max(out_lens[:nd]) - 1),
          f"serve dense: {DA.launches} decode_attention launches")
    log(f"serve dense cache, serial, bf16: {nd} requests finished, "
        f"{DA.launches} decode_attention launches; {captures(dense)}  "
        f"[{card}]")

    # the scheduler's defaults on the same requests: how often they fuse
    BA.launches = 0
    d_split = HostSplit()
    dflt, d_secs, d_cycles = _serve(cfg, params, prompts, out_lens,
                                    arrivals, fused=True, default_sched=True,
                                    audit=d_split)
    for rid, o in enumerate(out_lens):
        check(len(dflt.outputs.get(rid, [])) == o,
              f"default scheduler: request {rid} unfinished")
    log(f"serve default scheduler (pause on, max_prefill_batch 4): "
        f"{n_tok / d_secs:.1f} tok/s, {dflt.stats.fused_cycles} of "
        f"{d_cycles} cycles fused, bullet launches {BA.launches}; "
        f"{captures(dflt)}  [{card}]")
    for kind in sorted(d_split.cycles):
        log(f"serve default scheduler host split: "
            f"{host_split_line(d_split, kind)}")
    decode_serve(cfg, params, card)
    phase_profile(cfg, params, prompts, out_lens, arrivals, card)
    # the table buckets the serial serve's decode graphs were captured for
    buckets = sorted({k[1] for k, _ in serial.graphs.captures
                      if k[0] == "paged"})
    streams = {rid: list(o) for rid, o in server.outputs.items()}
    del server, serial, dense, dflt, params
    torch.cuda.empty_cache()
    return launches, n_tok / secs, buckets, streams


# ---------------------------------------------------------------------------
# chip granularity: disjoint prefill and decode sides with a page handoff
# ---------------------------------------------------------------------------

#: the device group of the chip phase: the one card named twice, so each
#: side has its own stream and page pool on it
CHIP_GROUP = ("cuda:0", "cuda:0")
#: the estimator regimes of tests/test_submesh.py for partition="auto"
#: (hardware fields, params): cheap handoff (chip must win), dear (tile)
CHIP_REGIMES = (("cheap", dict(ici_bw=1e13), dict(p_c=0.5, p_b=0.5)),
                ("dear", dict(ici_bw=1e6), dict(p_c=1.0, p_b=1.0)))
#: requests of the fault runs and of the card-vs-CPU reference
CHIP_FAULT_REQUESTS, CHIP_REF_REQUESTS = 6, 4
#: cycles (about 2 ms) the prefill side's stream is held before a timed
#: handoff: longer than the host takes to queue one
HANDOFF_HOLD = 4 * HOLD_CYCLES


class Handoffs:
    """Times every page handoff of a server's run: while entered, the
    engine's ``transfer_pages`` is wrapped so CUDA events bracket each copy
    (recorded on the prefill side's stream before the selection and on the
    decode side's after the writes, the prefill side's stream held busy
    with ``torch.cuda._sleep`` while the host queues the copy, so the
    events bracket the card's work alone, as ``Timer``'s do; the hold adds
    HANDOFF_HOLD cycles to each handoff of the timed run, and the garbage
    collector held off while the host queues it); as an audit
    after each cycle it pairs the handoff with the tokens the cycle moved.
    ``rows()``: (pages, bytes, tokens, card ms) per handoff."""

    def __init__(self):
        self.calls = []
        self.tokens = []

    def __enter__(self):
        from repro_torch.core import engine as E
        self._real = real = E.transfer_pages

        def timed(src, dst, blocks, placement=None, fault=None, *,
                  streams=None):
            p_stream, d_stream = streams
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            # no collection while the host queues the copy: a pause longer
            # than the hold would be read as card time
            gc_was_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(p_stream):
                    torch.cuda._sleep(HANDOFF_HOLD)
                t0.record(p_stream)
                out = real(src, dst, blocks, placement, fault,
                           streams=streams)
                t1.record(d_stream)
            finally:
                if gc_was_on:
                    gc.enable()
            page = sum(t[:, 0].numel() * t.element_size()
                       for t in _leaves(src))
            self.calls.append((len(blocks), len(blocks) * page, t0, t1))
            return out
        E.transfer_pages = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine as E
        E.transfer_pages = self._real

    def __call__(self, server) -> None:
        if server.last_handoff_tokens:
            self.tokens.append(server.last_handoff_tokens)

    def rows(self):
        torch.cuda.synchronize()
        check(len(self.calls) == len(self.tokens),
              f"{len(self.calls)} handoffs timed, {len(self.tokens)} seen")
        return [(n, b, tok, t0.elapsed_time(t1))
                for (n, b, t0, t1), tok in zip(self.calls, self.tokens)]


def _handoff_first_use(cfg, card: str) -> None:
    """A handoff's first launches, apart: ``transfer_pages`` between two
    64-page pools of ``cfg``'s shape on two streams, 5 pages (PyTorch's
    small-index ``index_select``, at most 16 indices) and 60 (its
    large-index one), each twice, card ms as ``Handoffs`` reads them. The
    first call of each loads kernels the run has not used yet, so the chip
    serve's handoffs after this read the copy's own time."""
    from repro_torch.kvcache.paged import transfer_pages
    from repro_torch.models import transformer as T
    src = T.init_paged_cache(cfg, 64, PS, torch.bfloat16, "cuda")
    dst = T.init_paged_cache(cfg, 64, PS, torch.bfloat16, "cuda")
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    got = []
    for n in (5, 60):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(streams[0]):
                torch.cuda._sleep(HANDOFF_HOLD)
            t0.record(streams[0])
            transfer_pages(src, dst, list(range(n)), streams=streams)
            t1.record(streams[1])
            torch.cuda.synchronize()
            got.append(t0.elapsed_time(t1))
    log(f"chip handoff first use: 5 pages {got[0]:.4f} ms then "
        f"{got[1]:.4f}, 60 pages {got[2]:.4f} ms then {got[3]:.4f}  "
        f"[{card}]")


def _distinct_pools(a, b) -> bool:
    """No leaf of page pool ``a`` shares storage with one of ``b``."""
    return {t.data_ptr() for t in _leaves(a)}.isdisjoint(
        t.data_ptr() for t in _leaves(b))


def _no_recapture(server, what: str) -> str:
    """Fatal if a server dropped a graph or captured a key twice (after
    the first chip cycle every key replays); returns the captures by kind
    of both of its StepGraphs."""
    for g in (server.graphs, server.graphs_p):
        keys = [k for k, _ in g.captures]
        check(g.dropped == 0, f"{what}: {g.dropped} graphs dropped")
        check(len(keys) == len(set(keys)), f"{what}: a key captured twice")
    return (f"decode side {captures(server.graphs)}, dropped "
            f"{server.graphs.dropped}; prefill side "
            f"{captures(server.graphs_p)}, dropped {server.graphs_p.dropped}")


def _chip_streams_equal(server, want: dict, what: str) -> None:
    for rid, toks in want.items():
        check(server.outputs.get(rid) == toks,
              f"{what}: request {rid}'s stream differs")


def _chip_reference(card: str, prompts, out_lens) -> None:
    """(d): a 2-layer cut of Qwen3-1.7B at full width, fp32, the chip
    engine over CHIP_GROUP on the card and over ("cpu", "cpu") on the CPU
    (plain versions), the same estimator, the virtual clock 1 ms a cycle:
    streams, chip cycles and handoffs equal."""
    from repro_torch.configs import get_config
    from repro_torch.core.config import (ControlConfig, ExecConfig,
                                         ServerConfig)
    from repro_torch.core.engine import BulletServer
    from repro_torch.core.estimator import HardwareSpec, PerfEstimator
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import transformer as T
    from repro_torch.serving.request import SLO, Request

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2)
    params = T.init_params(cfg, seed=2, dtype=torch.float32, device="cuda")
    got = {}
    for dev, group, p in (("cuda", CHIP_GROUP, params),
                          ("cpu", ("cpu", "cpu"), _to_cpu(params))):
        server = BulletServer(cfg, p, config=ServerConfig(
            slo=SLO(3.0, 150.0), est=PerfEstimator(HardwareSpec(n_chips=2)),
            max_slots=8, max_len=1152, max_prefill_batch=1,
            dtype=torch.float32,
            execution=ExecConfig(partition="chip", devices=group),
            control=ControlConfig(sched=SchedulerConfig(
                max_decode_pause_cycles=0))), device=dev)
        for rid, (pr, o) in enumerate(zip(prompts, out_lens)):
            server.submit(Request(rid=rid, arrival=0.0, prompt_len=len(pr),
                                  output_len=o), pr)
        now = 0.0
        while not server.idle:
            server.step(now)
            server.check_invariants()
            now += 1e-3
        st = server.stats
        got[dev] = (dict(server.outputs), st.chip_cycles, st.handoffs)
    check(got["cuda"][0] == got["cpu"][0],
          "chip reference: card and CPU streams differ")
    check(got["cuda"][1:] == got["cpu"][1:],
          f"chip reference: (chip cycles, handoffs) {got['cuda'][1:]} on "
          f"the card, {got['cpu'][1:]} on the CPU")
    check(got["cuda"][1] > 0 and got["cuda"][2] == len(prompts),
          f"chip reference: {got['cuda'][1:]}")
    log(f"chip (d) reference: 2-layer full-width Qwen3-1.7B fp32, "
        f"{len(prompts)} requests (prompts {[len(p) for p in prompts]}), "
        f"the chip engine over {CHIP_GROUP} and over ('cpu', 'cpu'): "
        f"streams, chip cycles ({got['cuda'][1]}) and handoffs "
        f"({got['cuda'][2]}) equal  [{card}]")


def phase_chip(card: str, fused=None, fused_tps=None) -> None:
    """Chip granularity on the card: Qwen3-1.7B at full width and depth,
    bf16, the serve phase's 12 requests and 8 slots, over the group
    CHIP_GROUP (one card named twice: each side its own stream and page
    pool). ``fused``, ``fused_tps``: the serve phase's fused streams and
    tok/s (None: served here first). Fatal checks: (a) partition="chip":
    streams identical to the fused serve's, chip cycles, one handoff per
    request, no fused cycle, the pool free and audited, the staging pool
    apart from the decode pool, no graph dropped or captured twice; (b)
    partition="auto" under the cheap- and dear-handoff regimes of
    tests/test_submesh.py: chip cycles in the first, none and fused cycles
    in the second, streams identical; (c) seeded handoff faults: two
    transient failures retried through, then a failure window past the
    retry budget that degrades chip -> tile, streams identical to the
    clean run's, the pool free; (d) the card against the CPU on a 2-layer
    fp32 cut (``_chip_reference``); (e) the new graph keys (``c_group``,
    ``c_final``) and the decode graph replayed on a side stream bit-equal
    to their eager steps. Prints the chip serve's tok/s beside the fused
    serve's, each handoff's pages, bytes and card ms beside
    ``kv_handoff_time``'s prediction, the chip cycles and the captures by
    kind; a handoff's first launches are timed apart first
    (``_handoff_first_use``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.estimator import (EstimatorParams, HardwareSpec,
                                            PerfEstimator)
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.models import transformer as T
    from repro_torch.resilience import (FaultInjector, FaultPlan, FaultSpec,
                                        GuardConfig, SLOGuard)

    cfg = get_config("qwen3-1.7b")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    prompts, out_lens, arrivals = serve_workload(cfg)
    n = len(prompts)
    n_tok = int(sum(out_lens))
    if fused is None:
        _serve(cfg, params, prompts[:2], [2, 2], [0.0, 0.0], fused=True)
        ref, secs, _ = _serve(cfg, params, prompts, out_lens, arrivals,
                              fused=True)
        fused = {rid: list(o) for rid, o in ref.outputs.items()}
        fused_tps = n_tok / secs
        del ref
    chip = dict(partition="chip", devices=CHIP_GROUP)
    _handoff_first_use(cfg, card)

    # (a) partition="chip"
    _reset_counts()
    split = HostSplit()
    with Handoffs() as handoffs:
        server, secs, cycles = _serve(
            cfg, params, prompts, out_lens, arrivals, fused=True,
            audit=lambda srv: (handoffs(srv), split(srv)), **chip)
    launches = {"flash_attention": FA.launches,
                "paged_decode_attention": PD.launches}
    st = server.stats
    _chip_streams_equal(server, fused, "chip (a)")
    check(st.chip_cycles > 0 and st.handoffs == n and st.fused_cycles == 0,
          f"chip (a): chip cycles {st.chip_cycles}, handoffs {st.handoffs}, "
          f"fused cycles {st.fused_cycles}")
    check(server.pool.free_blocks == server.pool.n_blocks,
          "chip (a): KV pool not free")
    server.pool.check_invariants()
    check(_distinct_pools(server.cache_p, server.cache),
          "chip (a): the staging pool shares storage with the decode pool")
    check(all(c > 0 for c in launches.values()),
          f"chip (a): launches {launches}")
    log(f"chip (a) partition='chip' over {CHIP_GROUP}: {n} requests, "
        f"{n_tok / secs:.1f} tok/s on one card that stands for two (fused "
        f"serve {fused_tps:.1f} tok/s), {cycles} cycles, {st.chip_cycles} "
        f"chip, {st.handoffs} handoffs, streams identical to the fused "
        f"serve's, launches {launches}, KV pool clean: True; "
        f"{_no_recapture(server, 'chip (a)')}  [{card}]")
    for kind in sorted(split.cycles):
        log(f"chip (a) host split: {host_split_line(split, kind)}")
    rows = handoffs.rows()
    for pages, nbytes, tok, ms in rows:
        pred = server.est.kv_handoff_time(cfg, tok) * 1e3
        log(f"chip (a) handoff: {tok} tokens, {pages} pages, "
            f"{nbytes / 2**20:.2f} MiB, {ms:.4f} ms on the card "
            f"({nbytes / ms / 1e6:.1f} GB/s); kv_handoff_time at ici_bw "
            f"{server.est.hw.ici_bw:.3g} B/s: {pred:.4f} ms  [{card}]")
    ms_all = [r[3] for r in rows]
    log(f"chip (a) handoffs: {len(rows)}, card ms median "
        f"{statistics.median(ms_all):.4f}, max {max(ms_all):.4f}, "
        f"{sum(r[1] for r in rows) / 2**20:.1f} MiB in all  [{card}]")
    del server

    # (b) partition="auto" under the two regimes
    for name, hw, par in CHIP_REGIMES:
        est = PerfEstimator(HardwareSpec(n_chips=len(CHIP_GROUP), **hw),
                            EstimatorParams(**par))
        _reset_counts()
        auto, a_secs, _ = _serve(cfg, params, prompts, out_lens, arrivals,
                                 fused=True, est=est, partition="auto",
                                 devices=CHIP_GROUP)
        st = auto.stats
        _chip_streams_equal(auto, fused, f"chip (b) auto {name}")
        if name == "cheap":
            check(st.chip_cycles > 0, "chip (b) cheap: no chip cycle")
        else:
            check(st.chip_cycles == 0 and st.fused_cycles > 0,
                  f"chip (b) dear: {st.chip_cycles} chip cycles, "
                  f"{st.fused_cycles} fused")
        check(auto.pool.free_blocks == auto.pool.n_blocks,
              f"chip (b) auto {name}: KV pool not free")
        log(f"chip (b) partition='auto', {name} handoff (ici_bw "
            f"{hw['ici_bw']:.0e}, p_c=p_b={par['p_c']}): {st.chip_cycles} "
            f"chip and {st.fused_cycles} fused cycles, {st.handoffs} "
            f"handoffs, {n_tok / a_secs:.1f} tok/s, streams identical to "
            f"the fused serve's; launches {_kernel_counts()}  [{card}]")
        del auto

    # (c) seeded handoff faults on the first CHIP_FAULT_REQUESTS requests
    k = CHIP_FAULT_REQUESTS
    want = {rid: fused[rid] for rid in range(k)}
    # the first handoff comes at the end of the first prompt's layer
    # groups: a window a little past it fails that one past the budget
    window = cfg.n_pattern_repeats + 12
    for name, spec, cooldown in (
            ("transient", FaultSpec("handoff", count=2), 8),
            ("exhausted", FaultSpec("handoff", start=0, end=window), 6)):
        guard = SLOGuard(GuardConfig(cooldown_cycles=cooldown))
        srv, _, _ = _serve(cfg, params, prompts[:k], out_lens[:k],
                           arrivals[:k], fused=True,
                           faults=FaultInjector(FaultPlan([spec], seed=1)),
                           guard=guard, **chip)
        st = srv.stats
        kinds = [t["transition"] for t in guard.transitions]
        _chip_streams_equal(srv, want, f"chip (c) {name}")
        check(srv.pool.free_blocks == srv.pool.n_blocks,
              f"chip (c) {name}: KV pool not free")
        if name == "transient":
            check(st.handoff_retries == 2 and st.prefill_aborts == 0
                  and not kinds,
                  f"chip (c) transient: retries {st.handoff_retries}, "
                  f"aborts {st.prefill_aborts}, transitions {kinds}")
        else:
            check("degrade:chip" in kinds and st.prefill_aborts >= 1,
                  f"chip (c) exhausted: transitions {kinds}, aborts "
                  f"{st.prefill_aborts}")
        log(f"chip (c) handoff faults, {name}: {k} requests, retries "
            f"{st.handoff_retries}, prefill aborts {st.prefill_aborts}, "
            f"transitions {kinds}, {st.chip_cycles} chip and "
            f"{st.fused_cycles} fused cycles, streams identical to the "
            f"clean run's, KV pool clean: True  [{card}]")
        del srv

    # (d) the card against the CPU
    ref_prompts = [p[:160] for p in prompts[:CHIP_REF_REQUESTS]]
    _chip_reference(card, ref_prompts, [8] * CHIP_REF_REQUESTS)

    # (e) the chip graph keys against their eager steps
    max_blocks = -(-1152 // PS)
    pool = T.init_paged_cache(cfg, 8 * max_blocks, PS, torch.bfloat16,
                              "cuda")
    _fill_random(pool, 21)
    prefill_graphs_check(cfg, params, pool, card, kinds=("c_group",
                                                         "c_final"),
                         stream=torch.cuda.Stream(), bps=(1,))
    engine_graphs_check("qwen3-1.7b chip decode side", cfg, params, pool,
                        paged_graph_steps((4, 64), 8, max_blocks, 22), card,
                        stream=torch.cuda.Stream())
    del pool, params
    torch.cuda.empty_cache()


#: the replay trace: ShareGPT-shaped lengths fitted to MAX_LEN, Poisson
#: arrivals at REPLAY_RATE requests per trace second. The rate is a choice
#: of this smoke test (it keeps prefills overlapping live decodes on the
#: virtual clock), not a rate measured from any deployment.
REPLAY_REQUESTS, REPLAY_RATE = 16, 16.0


def _replay_trace(n: int = REPLAY_REQUESTS):
    from repro_torch.serving.workload import (fit_trace_to_context,
                                              generate_trace)
    return fit_trace_to_context(
        generate_trace("sharegpt", REPLAY_RATE, 60.0, seed=0,
                       max_requests=n), MAX_LEN)


def _replay(cfg, params, dtype, *, paged=True, plan=None, wall=False,
            n_requests=REPLAY_REQUESTS, audit=None, max_prefill_batch=1):
    """One OnlineFrontend replay of the trace through BulletServer with
    observability on: the virtual clock priced by the H100 estimator, or
    the wall clock. The scheduler runs as in the serve phase's main path
    (one prompt per prefill batch unless ``max_prefill_batch`` says
    otherwise, no §3.3.3 decode pause), so every request's prefill shapes,
    and so its numerics, do not depend on which requests happen to be
    admitted together. ``paged=None`` lets the engine choose. ``plan`` attaches a fault
    injector and the SLO guard. ``audit(server)`` runs after every cycle.
    Returns (server, guard, metrics, wall seconds, per-cycle records)."""
    from repro_torch.core.config import (CacheConfig, ControlConfig,
                                         ServerConfig)
    from repro_torch.core.engine import BulletServer
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.obs import Observability
    from repro_torch.resilience import FaultInjector, SLOGuard
    from repro_torch.serving.frontend import (OnlineFrontend, VirtualClock,
                                              WallClock, estimator_cycle_cost)
    from repro_torch.serving.request import WORKLOAD_SLOS

    guard = SLOGuard() if plan is not None else None
    server = BulletServer(cfg, params, config=ServerConfig(
        slo=WORKLOAD_SLOS["sharegpt"], max_slots=8, max_len=MAX_LEN,
        max_prefill_batch=max_prefill_batch, dtype=dtype,
        cache=CacheConfig(paged=paged),
        control=ControlConfig(sched=SchedulerConfig(
            max_decode_pause_cycles=0)),
        obs=Observability(), guard=guard,
        faults=FaultInjector(plan) if plan is not None else None),
        device="cuda")
    records = []
    last = [time.perf_counter()]

    def on_cycle(srv, now):
        t = time.perf_counter()
        check(len(records) < 50_000, "replay did not drain")
        records.append(dict(fused=srv.last_fused,
                            share=(srv.rm.executable().decode_share
                                   if srv.last_fused else None),
                            prefill=srv.last_prefill_tokens,
                            decode=srv.last_decode is not None,
                            wall=t - last[0]))
        last[0] = t
        if audit is not None:
            audit(srv)

    fe = OnlineFrontend(server, WallClock() if wall else VirtualClock(),
                        cycle_cost=None if wall else estimator_cycle_cost,
                        on_cycle=on_cycle)
    trace = _replay_trace(n_requests)
    fe.submit_trace(trace, cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last[0] = t0
    m = fe.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(not fe.truncated, "replay truncated")
    for r in trace:
        got = server.outputs.get(r.rid, [])
        check(len(got) == r.output_len,
              f"replay request {r.rid}: {len(got)} tokens, want "
              f"{r.output_len}")
        check(all(0 <= x < cfg.vocab_size for x in got),
              f"replay request {r.rid}: token out of vocab")
    check(server.pool.available_blocks == server.pool.n_blocks,
          "replay: KV pool not clean")
    return server, guard, m, secs, records


def _decode_only_ms(records) -> float:
    """Mean host wall time of the cycles that ran a decode iteration and no
    prefill group (the engine reads its sampled tokens back every cycle,
    so this includes the device time)."""
    ts = [r["wall"] for r in records if r["decode"] and not r["prefill"]]
    return 1e3 * statistics.mean(ts) if ts else float("nan")


def phase_replay(card: str) -> dict:
    """Trace replay at full Qwen3-1.7B width and depth. (a), (b) and (c)
    run in fp32: (b)'s guard re-prefills every preempted request over its
    generated prefix, which in bf16 rounds differently from the decode
    steps that first produced it, and would let greedy streams drift for a
    reason that is not a fault of the port. Virtual-clock metrics depend
    on the estimator's prices, not on the dtype. (d) serves in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.models import transformer as T
    from repro_torch.resilience import FaultPlan, FaultSpec
    from repro_torch.serving.request import WORKLOAD_SLOS

    def counters():
        return {"flash_attention": FA.launches,
                "paged_decode_attention": PD.launches,
                "bullet_attention_paged": BA.launches,
                "decode_attention": DA.launches,
                "bullet_attention": BA.dense_launches}

    def reset():
        FA.launches = PD.launches = BA.launches = DA.launches = 0
        BA.dense_launches = 0

    cfg = get_config("qwen3-1.7b")
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    trace = _replay_trace()
    log(f"replay: qwen3-1.7b full width/depth, {len(trace)} ShareGPT-shaped "
        f"requests fitted to max_len {MAX_LEN} (prompts "
        f"{[r.prompt_len for r in trace]}, outputs "
        f"{[r.output_len for r in trace]}), Poisson arrivals at "
        f"{REPLAY_RATE:g} req/s (the smoke's choice, not a measured rate), "
        f"SLO {WORKLOAD_SLOS['sharegpt']}")

    # (a) fault-free virtual-clock replay
    reset()
    a, _, ma, secs_a, rec_a = _replay(cfg, params, torch.float32)
    la = counters()
    for name in ("flash_attention", "paged_decode_attention",
                 "bullet_attention_paged"):
        check(la[name] > 0, f"replay (a): {name} never launched")
    first_fused = next((i for i, r in enumerate(rec_a) if r["fused"]), None)
    check(first_fused is not None, "replay (a): no fused cycle")
    log(f"replay (a) virtual clock, fp32: {ma.row()}")
    log(f"  {len(rec_a)} cycles in {secs_a:.1f} s wall, stats "
        f"{vars(a.stats)}, launches {la}, first fused cycle {first_fused}, "
        f"decode-only cycle {_decode_only_ms(rec_a):.1f} ms wall (paged); "
        f"{captures(a)}  [{card}]")
    log(f"  decode_share of the fused cycles: "
        f"{share_histogram(r['share'] for r in rec_a if r['fused'])}")

    # (b) the same trace under a fault plan: two failed fused dispatches
    # (fused→serial), then two failed prefill dispatches of the serial path
    # (paged→dense); the guard's cooldown probes back to paged, then fused
    n_a = len(rec_a)
    start = first_fused + 8
    check(start + 2 < n_a // 2, f"replay (a) too short ({n_a} cycles)")
    plan = FaultPlan(seed=0, specs=[
        FaultSpec("dispatch", start=first_fused, end=first_fused + 2,
                  target="fused", count=2),
        FaultSpec("dispatch", start=start, end=n_a // 2, target="prefill",
                  count=2)])
    dense = {"iters": 0, "short": 0, "last": 0}

    def audit(srv):
        srv.check_invariants()
        n = DA.launches - dense["last"]
        dense["last"] = DA.launches
        if not srv.paged and srv.last_decode is not None:
            dense["iters"] += 1
            dense["short"] += n < cfg.n_layers
    reset()
    b, guard, mb, secs_b, rec_b = _replay(cfg, params, torch.float32,
                                          plan=plan, audit=audit)
    lb = counters()
    kinds = [t["transition"] for t in guard.transitions]
    check(guard.recovered, f"replay (b): guard not recovered: {kinds}")
    check("degrade:paged" in kinds and "restore:paged" in kinds
          and "degrade:fused" in kinds and "restore:fused" in kinds,
          f"replay (b): transitions {kinds}")
    check(b.paged and b.fused, "replay (b) did not end on the fast path")
    check(dense["iters"] > 0 and dense["short"] == 0,
          f"replay (b): {dense['iters']} dense decode iterations, "
          f"{dense['short']} with fewer decode_attention launches than "
          "layers")
    for name in ("flash_attention", "paged_decode_attention",
                 "bullet_attention_paged", "decode_attention"):
        check(lb[name] > 0, f"replay (b): {name} never launched")
    for r in trace:
        check(b.outputs[r.rid] == a.outputs[r.rid],
              f"replay (b): request {r.rid}'s stream differs from (a)'s")
    log(f"replay (b) chaos, fp32: {mb.row()}")
    log(f"  transitions {' '.join(kinds)}; {len(rec_b)} cycles in "
        f"{secs_b:.1f} s wall, faults {b.faults.injected}, stats "
        f"{vars(b.stats)}, launches {lb}, {dense['iters']} dense decode "
        f"iterations with {cfg.n_layers} decode_attention launches each or "
        f"more; streams identical to (a); invariants held every cycle; KV "
        f"pool clean; {captures(b)}  [{card}]")

    # (c) the dense slot cache serving the same requests (serial)
    reset()
    c, _, mc, secs_c, rec_c = _replay(cfg, params, torch.float32,
                                      paged=False)
    lc = counters()
    check(lc["decode_attention"] > 0 and lc["paged_decode_attention"] == 0,
          f"replay (c): launches {lc}")
    for r in trace:
        check(c.outputs[r.rid] == a.outputs[r.rid],
              f"replay (c): request {r.rid}'s stream differs from (a)'s")
    log(f"replay (c) dense cache, serial, fp32: {mc.row()}")
    log(f"  {len(rec_c)} cycles in {secs_c:.1f} s wall, launches {lc}, "
        f"decode-only cycle {_decode_only_ms(rec_c):.1f} ms wall (dense); "
        f"streams identical to (a); {captures(c)}  [{card}]")
    del a, b, c

    # (d) wall-clock replay in bf16 after a warm-up pass
    params = {k: (tuple({n: t.to(torch.bfloat16) for n, t in blk.items()}
                        for blk in v) if k == "blocks"
                  else v.to(torch.bfloat16)) for k, v in params.items()}
    torch.cuda.empty_cache()
    _replay(cfg, params, torch.bfloat16, wall=True, n_requests=2)
    d, _, md, secs_d, rec_d = _replay(cfg, params, torch.bfloat16,
                                      wall=True)
    log(f"replay (d) wall clock, bf16: {md.row()}  [{card}]")
    log(f"  {len(rec_d)} cycles in {secs_d:.1f} s, stats {vars(d.stats)}, "
        f"decode-only cycle {_decode_only_ms(rec_d):.1f} ms wall; "
        f"{captures(d)}  [{card}]")
    log(f"  decode_share of the fused cycles: "
        f"{share_histogram(r['share'] for r in rec_d if r['fused'])}")
    return lb


def phase_mamba_reference():
    """Full-width Mamba-2-2.7B cut to 2 layers, fp32: dense prefill of a
    300-token prompt (two chunks, the second padded) + 4 decode steps on
    the card (the SSD kernel) against the CPU (its plain version)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as SK
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2)
    params = T.init_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    cpu = {k: (tuple({n: t.cpu() for n, t in b.items()} for b in v)
               if k == "blocks" else v.cpu()) for k, v in params.items()}
    s, n_dec = 300, 4
    toks = torch.randint(0, cfg.vocab_size, (1, s),
                         generator=torch.Generator().manual_seed(1))
    outs = {}
    before = SK.launches
    for dev, p in (("cuda", params), ("cpu", cpu)):
        cache = T.init_cache(cfg, 1, s + n_dec, torch.float32, dev)
        logits, _ = T.prefill(p, toks.to(dev), torch.tensor([s]).to(dev),
                              cache, None, cfg)
        seq = [logits.float().cpu()]
        tok = logits.argmax(-1)
        for i in range(n_dec):
            logits, _ = T.decode_step(
                p, cache, tok[:, None].to(torch.int32),
                torch.tensor([s + i], dtype=torch.int32, device=dev), cfg)
            seq.append(logits.float().cpu())
            tok = logits.argmax(-1)
        outs[dev] = seq
    check(SK.launches - before == cfg.n_layers,
          f"mamba reference: {SK.launches - before} ssd_scan launches on "
          f"the card, want {cfg.n_layers}")
    worst = _card_vs_cpu(outs, cfg)
    log(f"mamba reference: 2-layer full-width Mamba-2-2.7B fp32, prefill "
        f"S={s} + {n_dec} decode steps, card vs CPU max rel logit err "
        f"{worst:.2e}, greedy tokens equal")


#: the Mamba-2 replay's requests (the trace's first ones): fewer than the
#: Qwen3 replay's, as each of its 64-layer decode cycles costs the host
#: about twice as many launches
MAMBA_REQUESTS = 8


def _percentiles(server):
    """TTFT (ms) and TPOT (ms) p50 and p90 over the finished requests."""
    from repro_torch.serving.request import percentile
    done = server.finished
    ttft = [1e3 * r.ttft for r in done]
    tpot = [r.tpot_ms for r in done]
    return (percentile(ttft, 50), percentile(ttft, 90),
            percentile(tpot, 50), percentile(tpot, 90))


def phase_mamba(card: str) -> dict:
    """Mamba-2-2.7B at full width and depth through the OnlineFrontend on
    the dense slot cache (serial): the trace replay on the virtual clock
    in fp32 (ssd_scan launches counted: one per prefill group), the
    length-correct state check in fp32, then the wall-clock replay in
    bf16. Returns the ssd_scan launches of each: {"fp32": the virtual
    replay's, "bf16": the wall-clock replay's}, one per prefill group."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as SK
    from repro_torch.models import transformer as T

    cfg = get_config("mamba2-2.7b")
    check(cfg.n_layers == 64 and cfg.d_model == 2560
          and cfg.vocab_size == 50280 and cfg.ssm_n_heads == SSD_H
          and cfg.ssm_head_dim == SSD_P and cfg.ssm_state == SSD_N,
          "not the full Mamba-2-2.7B config")
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    trace = _replay_trace(MAMBA_REQUESTS)
    log(f"mamba replay: mamba2-2.7b full width/depth, {len(trace)} "
        f"ShareGPT-shaped requests (prompts {[r.prompt_len for r in trace]}"
        f", outputs {[r.output_len for r in trace]}), 8 slots, "
        f"max_prefill_batch 4, dense slot cache, serial")

    # (b) virtual clock, fp32
    SK.launches = 0
    srv, _, m, secs, rec = _replay(cfg, params, torch.float32, paged=None,
                                   max_prefill_batch=4,
                                   n_requests=MAMBA_REQUESTS)
    launches = SK.launches
    check(not srv.paged and not srv.fused, "mamba: not dense and serial")
    check(launches > 0 and launches == srv.stats.prefill_cycles,
          f"mamba replay: {launches} ssd_scan launches for "
          f"{srv.stats.prefill_cycles} prefill groups")
    p = _percentiles(srv)
    log(f"mamba replay virtual clock, fp32: {m.row()}")
    log(f"  TTFT p50/p90 {p[0]:.1f}/{p[1]:.1f} ms, TPOT p50/p90 "
        f"{p[2]:.1f}/{p[3]:.1f} ms, {m.throughput_tok_s:.0f} tok/s, goodput "
        f"{100 * m.goodput:.1f}%; {len(rec)} cycles in {secs:.1f} s wall "
        f"({1e3 * secs / len(rec):.1f} ms per cycle), decode-only cycle "
        f"{_decode_only_ms(rec):.1f} ms, stats {vars(srv.stats)}, ssd_scan "
        f"launches {launches}; {captures(srv)}  [{card}]")
    del srv

    # (c) the length-correct state: a mixed-length batch against each
    # prompt alone
    rng = np.random.default_rng(0)
    lens = [r.prompt_len for r in trace[:4]]
    check(len(set(lens)) > 1, f"state check: prompts of one length {lens}")
    toks = np.zeros((4, max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    batch = T.init_cache(cfg, 4, MAX_LEN, torch.float32, "cuda")
    T.prefill(params, torch.from_numpy(toks).cuda(),
              torch.tensor(lens).cuda(), batch, None, cfg)
    worst = 0.0
    for i, n in enumerate(lens):
        solo = T.init_cache(cfg, 1, MAX_LEN, torch.float32, "cuda")
        T.prefill(params, torch.from_numpy(toks[i:i + 1, :n]).cuda(),
                  torch.tensor([n]).cuda(), solo, None, cfg)
        for key in ("conv", "ssm"):
            a, b = batch["blocks"][0][key][:, i], solo["blocks"][0][key][:, 0]
            for layer in range(cfg.n_layers):
                e = rel_err(a[layer], b[layer])
                check(math.isfinite(e) and e <= 1e-3,
                      f"state check: request {i} (length {n}) layer {layer}"
                      f" {key} differs from its solo prefill by {e}")
                worst = max(worst, e)
    torch.cuda.synchronize()
    log(f"mamba state: batch of prompts {lens} (padded to {max(lens)}) vs "
        f"each alone, fp32, all {cfg.n_layers} layers' conv and ssm states:"
        f" max|batch-solo|/scale {worst:.2e} (tolerance 1e-3)  [{card}]")
    del batch, solo, params
    torch.cuda.empty_cache()

    # (d) wall clock, bf16, after a warm-up pass of 2 requests (one prefill
    # batch, then decode) in which two 10-cycle windows are profiled: one
    # inside the prefill, one of decode iterations alone
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    windows = (ProfileCycles(10, 10), ProfileCycles(100, 10))
    _replay(cfg, params, torch.bfloat16, paged=None, max_prefill_batch=4,
            wall=True, n_requests=2,
            audit=lambda srv: [w(srv) for w in windows])
    for w in windows:
        w.report(f"cycles {w.start + 1}-{w.start + w.n} of Mamba-2 serving "
                 f"({w.prefills} with a prefill group), bf16, wall clock",
                 card)
    SK.launches = 0
    srv, _, m, secs, rec = _replay(cfg, params, torch.bfloat16, paged=None,
                                   max_prefill_batch=4, wall=True,
                                   n_requests=MAMBA_REQUESTS)
    launches_bf16 = SK.launches
    check(launches_bf16 > 0
          and launches_bf16 == srv.stats.prefill_cycles,
          f"mamba wall-clock replay: {launches_bf16} ssd_scan launches for "
          f"{srv.stats.prefill_cycles} prefill groups")
    p = _percentiles(srv)
    log(f"mamba replay wall clock, bf16: {m.row()}  [{card}]")
    log(f"  TTFT p50/p90 {p[0]:.1f}/{p[1]:.1f} ms, TPOT p50/p90 "
        f"{p[2]:.1f}/{p[3]:.1f} ms, {m.throughput_tok_s:.0f} tok/s, goodput "
        f"{100 * m.goodput:.1f}%; {len(rec)} cycles in {secs:.1f} s "
        f"({1e3 * secs / len(rec):.1f} ms per cycle), decode-only cycle "
        f"{_decode_only_ms(rec):.1f} ms, stats {vars(srv.stats)}, ssd_scan "
        f"launches {launches_bf16}; {captures(srv)}  [{card}]")
    del srv, params
    torch.cuda.empty_cache()
    return {"fp32": launches, "bf16": launches_bf16}


def _leaves(tree):
    """The tensors of a nested dict / tuple tree."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def _rg_launches():
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rglru_scan as RK
    return {"rglru_scan": RK.launches, "flash_attention": FA.launches,
            "decode_attention": DA.launches}


def _rg_reset() -> None:
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rglru_scan as RK
    RK.launches = FA.launches = DA.launches = 0


def _prompt_batch(cfg, lens, seed: int):
    """(B, max(lens)) int32 prompts of seeded random tokens, right-padded
    with zeros, and their lengths."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    return torch.from_numpy(toks), torch.tensor(lens, dtype=torch.int32)


def _greedy(params, cfg, toks, lens, cache, n_dec: int, frontend=None):
    """The models-level path: ``prefill`` of the padded batch (with its
    ``frontend``, encoded or prepended), then ``n_dec`` greedy
    ``decode_step``s through ``GraphedDecode`` (replayed as a CUDA graph on
    the card, eager on the CPU). Returns the logits of every step (on the
    CPU) and the greedy tokens."""
    from repro_torch.core.graphs import GraphedDecode
    from repro_torch.models import prefill
    dev = params["embed"].device
    logits, _ = prefill(params, toks.to(dev), lens.to(dev), cache, None, cfg,
                        frontend=None if frontend is None
                        else frontend.to(dev))
    step = GraphedDecode(params, cache, cfg)
    seq, tokens = [logits.float().cpu()], []
    tok = logits.argmax(-1).to(torch.int32)
    pos = lens.to(dev)
    for _ in range(n_dec):
        tokens.append(tok.cpu())
        logits = step(tok[:, None], pos)
        seq.append(logits.float().cpu())
        tok, pos = logits.argmax(-1).to(torch.int32), pos + 1
    return seq, tokens


def phase_rg_reference():
    """RecurrentGemma-2B at full width cut to 5 layers, one (R, R, L)
    period and the (R, R) tail, fp32: two prompts (2100 tokens, past the
    2048 window, and 600) as one padded batch, prefill + 8 greedy decode
    steps on the card (kernels) against the CPU (plain versions): logits
    within 1e-4 of their scale, the same greedy tokens, and the card's
    launches: 4 rglru_scan (one per RG-LRU layer), 1 flash_attention, 8
    decode_attention. Returns those launches (of the fp32 bodies)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params

    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), n_layers=5)
    check(cfg.n_pattern_repeats == 1 and len(cfg.pattern_tail) == 2,
          "not one (R, R, L) period and the (R, R) tail")
    params = init_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    cpu = {k: (tuple({n: t.cpu() for n, t in b.items()} for b in v)
               if isinstance(v, tuple) else v.cpu())
           for k, v in params.items()}
    toks, lens = _prompt_batch(cfg, [2100, 600], seed=1)
    n_dec = 8
    outs = {}
    for dev, p in (("cuda", params), ("cpu", cpu)):
        _rg_reset()
        t = time.perf_counter()
        cache = init_cache(cfg, 2, 2100 + n_dec, torch.float32, dev)
        outs[dev] = _greedy(p, cfg, toks, lens, cache, n_dec)[0]
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = _rg_launches()
        log(f"rg reference on {dev}: {time.perf_counter() - t:.1f} s")
    want = {"rglru_scan": 4, "flash_attention": 1, "decode_attention": 8}
    check(launches == want, f"rg reference: launches {launches}, want {want}")
    worst = _card_vs_cpu(outs, cfg, tol=1e-4)
    log(f"rg reference: 5-layer full-width RecurrentGemma-2B fp32, prompts "
        f"{lens.tolist()} as one padded batch + {n_dec} decode steps, card vs "
        f"CPU max rel logit err {worst:.2e} (tolerance 1e-4), greedy tokens "
        f"equal, launches {launches}")
    return launches


#: the RecurrentGemma phase's prompts (one padded batch) and decode steps
RG_PROMPTS, RG_DECODE = (3000, 2300, 1200, 300), 64


def _rg_state_check(cfg, card: str) -> None:
    """Each request's recurrent and ring state after the padded batch
    prefill against the same prompt prefilled alone, fp32, every layer:
    RG-LRU ``conv`` and ``hidden``, the SWA ring's ``k`` and ``v``, within
    1e-3 of the solo state's scale. States, not streams: cuBLAS may pick
    another GEMM for another batch shape."""
    from repro_torch.models import init_cache, init_params, prefill

    params = init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    max_len = max(RG_PROMPTS) + RG_DECODE
    toks, lens = _prompt_batch(cfg, RG_PROMPTS, seed=2)
    batch = init_cache(cfg, len(RG_PROMPTS), max_len, torch.float32, "cuda")
    prefill(params, toks.cuda(), lens.cuda(), batch, None, cfg)
    worst = 0.0
    for i, n in enumerate(RG_PROMPTS):
        solo = init_cache(cfg, 1, max_len, torch.float32, "cuda")
        prefill(params, toks[i:i + 1, :n].cuda(), lens[i:i + 1].cuda(), solo,
                None, cfg)
        for part in ("blocks", "tail"):
            stacked = part == "blocks"
            for j, (bl, sl) in enumerate(zip(batch[part], solo[part])):
                for key in bl:
                    a = bl[key][:, i] if stacked else bl[key][i:i + 1]
                    b = sl[key][:, 0] if stacked else sl[key]
                    for r in range(a.shape[0] if stacked else 1):
                        ar, br = (a[r], b[r]) if stacked else (a, b)
                        e = rel_err(ar, br)
                        check(math.isfinite(e) and e <= 1e-3,
                              f"rg state: request {i} (length {n}) {part}"
                              f"[{j}] repeat {r} {key} differs from its "
                              f"solo prefill by {e}")
                        worst = max(worst, e)
    torch.cuda.synchronize()
    log(f"rg state: batch of prompts {list(RG_PROMPTS)} (padded to "
        f"{max(RG_PROMPTS)}) vs each alone, fp32, all {cfg.n_layers} layers' "
        f"RG-LRU conv/hidden and SWA rings: max|batch-solo|/scale "
        f"{worst:.2e} (tolerance 1e-3)  [{card}]")


def phase_recurrentgemma(card: str) -> dict:
    """RecurrentGemma-2B at full width and depth (26 layers, d_model 2560,
    vocab 256000, seeded random weights) through the models-level
    ``prefill`` / ``decode_step`` on the dense slot cache: the state check
    in fp32, then in bf16 four prompts as one padded batch and 64 greedy
    decode steps through ``GraphedDecode``, timed, with the launches
    counted around that run, and a torch.profiler window over one prefill
    call and one over 10 decode steps. Returns the launches of the bf16
    run."""
    from repro_torch.configs import get_config
    from repro_torch.core.graphs import GraphedDecode
    from repro_torch.models import init_cache, init_params, prefill

    cfg = get_config("recurrentgemma-2b")
    check(cfg.n_layers == 26 and cfg.d_model == RG_W and cfg.n_heads == RG_H
          and cfg.n_kv_heads == RG_K and cfg.head_dim == RG_D
          and cfg.sliding_window == RG_WINDOW and cfg.vocab_size == 256000
          and cfg.lru_width == RG_W, "not the full RecurrentGemma-2B config")
    n_rg = sum(b.mixer == "rglru" for b in cfg.all_blocks)
    n_swa = sum(b.mixer == "swa" for b in cfg.all_blocks)
    _rg_state_check(cfg, card)
    torch.cuda.empty_cache()

    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    max_len = max(RG_PROMPTS) + RG_DECODE
    b = len(RG_PROMPTS)
    toks, lens = _prompt_batch(cfg, RG_PROMPTS, seed=3)
    toks, lens = toks.cuda(), lens.cuda()
    log(f"recurrentgemma: full width/depth bf16, {n_params / 1e9:.2f} B "
        f"params ({n_rg} RG-LRU, {n_swa} SWA layers), prompts "
        f"{list(RG_PROMPTS)} as one padded batch, dense cache of {max_len} "
        f"rows (SWA rings of {min(RG_WINDOW, max_len)}), {RG_DECODE} greedy "
        f"decode steps")
    # warm-up: cuBLAS handles and kernel modules load outside the timing
    w = min(RG_PROMPTS)
    _greedy(params, cfg, toks[:, :w].cpu(), torch.full((b,), w,
            dtype=torch.int32), init_cache(cfg, b, w + 2, torch.bfloat16,
                                           "cuda"), 2)

    _rg_reset()
    cache = init_cache(cfg, b, max_len, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, _ = prefill(params, toks, lens, cache, None, cfg)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre = _rg_launches()
    check(pre == {"rglru_scan": n_rg, "flash_attention": n_swa,
                  "decode_attention": 0},
          f"recurrentgemma prefill: launches {pre}, want {n_rg} rglru_scan "
          f"and {n_swa} flash_attention")
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "recurrentgemma: non-finite prefill logits")
    # the timed decode: the first step captures (an eager step, then the
    # capture), the other RG_DECODE - 1 replay
    _rg_reset()
    dec = GraphedDecode(params, cache, cfg)
    tok = logits.argmax(-1).to(torch.int32)
    pos = lens.clone()
    out = []
    t0 = time.perf_counter()
    for i in range(RG_DECODE):
        lg = dec(tok[:, None], pos)
        tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
        out.append(tok)
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t_first, t_dec = t1 - t0, time.perf_counter() - t1
    n_rep = RG_DECODE - 1
    launches = _rg_launches()
    launches["rglru_scan"] += pre["rglru_scan"]
    launches["flash_attention"] += pre["flash_attention"]
    check(launches["decode_attention"] == n_swa * RG_DECODE
          and launches["rglru_scan"] == n_rg
          and launches["flash_attention"] == n_swa,
          f"recurrentgemma: launches {launches} after {RG_DECODE} decode "
          f"steps, want {n_swa} decode_attention per step")
    toks_out = torch.stack(out, 1).cpu()
    check(bool(((toks_out >= 0) & (toks_out < cfg.vocab_size)).all()),
          "recurrentgemma: token out of vocab")
    check(bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()),
          "recurrentgemma: non-finite decode logits")
    log(f"recurrentgemma bf16: prefill of {int(lens.sum())} prompt tokens "
        f"(padded {b}x{max(RG_PROMPTS)}) {1e3 * t_pre:.1f} ms, decode "
        f"{1e3 * t_dec / n_rep:.2f} ms per step over {n_rep} graph replays "
        f"({b} slots, {b * n_rep / t_dec:.1f} output tok/s), the first step "
        f"(eager, then the capture) {1e3 * t_first:.1f} ms; launches "
        f"{launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  [{card}]")

    # profiles: one prefill call, and 10 decode steps (graph replays)
    cache = init_cache(cfg, b, max_len, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, _ = prefill(params, toks, lens, cache, None, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _profile_report(prof, wall, "RecurrentGemma-2B bf16, one prefill call "
                    f"(4 prompts, padded to {max(RG_PROMPTS)})", card)
    dec = GraphedDecode(params, cache, cfg)
    tok = logits.argmax(-1).to(torch.int32)
    lg = dec(tok[:, None], lens)
    tok, pos = lg.argmax(-1).to(torch.int32), lens + 1
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            lg = dec(tok[:, None], pos)
            tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _profile_report(prof, wall, "RecurrentGemma-2B bf16, 10 decode steps "
                    "(4 slots, graph replays)", card, cycles=10,
                    tokens=10 * b)
    del params, cache, dec
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# multi-turn sessions: shared-prefix reuse and the tenant layer
# ---------------------------------------------------------------------------

#: the sharing phase's sessions (generate_interactions): 8 sessions of 2-4
#: turns, each turn 96-288 fresh tokens and 24-72 output tokens, arriving
#: at 16 sessions per trace second: a choice of this smoke test that keeps
#: turns of several sessions in flight, not a rate measured from a trace
SHARING = dict(n_sessions=8, rate_s=16.0, turns=4, new_tokens=192,
               output_tokens=48, seed=0)
#: the tenants phase's sessions (generate_tenant_interactions over
#: make_apps(4)): app 0 floods with 20x its Zipf share
TENANTS = dict(n_sessions=12, rate_s=32.0, turns=3, new_tokens=128,
               output_tokens=32, seed=0, rate_skew={0: 20.0})
SESSION_LEN = 2048


def _sessions(cfg, params, dtype, sessions, *, share: bool, tenancy=None,
              first_logits=None):
    """Replay closed-loop multi-turn ``sessions`` through the
    OnlineFrontend's ``submit_interactions`` on the virtual clock priced by
    the estimator (so every decision, and each turn's prompt, follows the
    engine's outputs and not the host's speed): Qwen3 paged, page size 16,
    8 slots, max_len SESSION_LEN, up to 4 prompts per prefill batch, the
    §3.3.3 pause off (so miss batches fuse with decode), ``share`` the
    shared-prefix reuse, ``tenancy`` a TenancyController or None. The
    engine's invariants are audited after every cycle. ``first_logits``
    (a dict) collects each request's first-token logits (fp32, on the
    host), keyed (session, turn), with whether its batch hit the prefix
    index. Returns (server, frontend, metrics, wall s, cycle records)."""
    from repro_torch.core.config import (CacheConfig, ControlConfig,
                                         ServerConfig)
    from repro_torch.core.engine import BulletServer
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.models import transformer as T
    from repro_torch.serving.frontend import (OnlineFrontend, VirtualClock,
                                              estimator_cycle_cost)
    from repro_torch.serving.request import WORKLOAD_SLOS

    server = BulletServer(cfg, params, config=ServerConfig(
        slo=WORKLOAD_SLOS["sharegpt"], max_slots=8, max_len=SESSION_LEN,
        dtype=dtype, cache=CacheConfig(page_size=PS, share_prefix=share),
        control=ControlConfig(sched=SchedulerConfig(
            max_decode_pause_cycles=0)),
        tenancy=tenancy), device="cuda")
    if first_logits is not None:
        finish = server._finish_prefill

        def hooked(task, now):
            logits = T.last_token_logits(server.params, task.x, task.lengths,
                                         cfg).float().cpu()
            for i, r in enumerate(task.batch):
                first_logits.setdefault(
                    (r.session_id, r.turn_index),
                    (logits[i], task.prefix_map is not None))
            return finish(task, now)
        server._finish_prefill = hooked
    records = []
    last = [0.0]

    def on_cycle(srv, now):
        t = time.perf_counter()
        check(len(records) < 50_000, "session replay did not drain")
        srv.check_invariants()
        task = srv.ptask
        shape = None
        if task is not None and task.prefix_map is not None \
                and task.rep == 1:
            # a suffix batch's first group ran: its shape, once per task
            check(task.x.is_cuda and task.prefix_map.is_cuda,
                  "a shared task's tensors are not on the card")
            shape = (tuple(task.x.shape[:2]), tuple(task.prefix_map.shape),
                     task.prefix_lens.tolist(), task.lengths.tolist())
        records.append(dict(wall=t - last[0], fused=srv.last_fused,
                            prefill=srv.last_prefill_tokens,
                            reused=srv.last_reused_tokens, shape=shape))
        last[0] = t

    fe = OnlineFrontend(server, VirtualClock(),
                        cycle_cost=estimator_cycle_cost, on_cycle=on_cycle)
    fe.submit_interactions(sessions, cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last[0] = t0
    m = fe.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(not fe.truncated, "session replay truncated")
    check(server.pool.available_blocks == server.pool.n_blocks,
          "session replay: KV pool not clean")
    return server, fe, m, secs, records


def _streams(fe, server) -> dict:
    """Each finished request's tokens, keyed (session, turn): rids follow
    the order turns finish in, which a cheaper prefill may change."""
    return {(r.session_id, r.turn_index): list(server.outputs[r.rid])
            for r in fe.requests if r.phase.name == "FINISHED"}


def _group_ms(records, shared: bool) -> str:
    """Mean and max host wall ms of the serial cycles that ran a prefill
    group of a shared (eager) or a miss (graphed) task."""
    ts = [1e3 * r["wall"] for r in records
          if r["prefill"] and not r["fused"]
          and (r["reused"] > 0) == shared]
    if not ts:
        return "none"
    return f"{statistics.mean(ts):.2f} ms mean, {max(ts):.2f} max, n={len(ts)}"


def prefix_suffix_cost(b, sq, lp, h, k, d, s_lens, plens, dtype):
    """(bytes, operations) of prefix_suffix_attention on one suffix batch:
    q, the suffix K/V, the gathered prefix K/V and the output moved once;
    QKᵀ and PV over the keys each real query attends (its prefix and the
    suffix up to itself)."""
    e = esize(dtype)
    n_bytes = e * d * (2 * b * sq * h + 2 * b * (sq + lp) * k)
    attended = sum(pl * s + s * (s + 1) // 2 for pl, s in zip(plens, s_lens))
    return n_bytes, 4 * h * d * attended


def time_prefix_suffix(timer, cfg, shape, dtype=torch.bfloat16) -> dict:
    """prefix_suffix_attention (plain PyTorch on the card) at one suffix
    batch's shape from the run, random inputs, beside its bound and masked
    SDPA on the same concatenated K/V and explicit mask (enable_gqa)."""
    import torch.nn.functional as F

    from repro_torch.models.attention import prefix_suffix_attention
    (b, sq), (_, lp_pages), plens, s_lens = shape
    lp = lp_pages * PS
    h, k, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, ks, vs = rnd(b, sq, h, d), rnd(b, sq, k, d), rnd(b, sq, k, d)
    kp, vp = rnd(b, lp, k, d), rnd(b, lp, k, d)
    plen = torch.tensor(plens, dtype=torch.int32, device="cuda")
    pos = (plen.long()[:, None]
           + torch.arange(sq, device="cuda")[None]).to(torch.int32)
    args = (q, ks, vs, kp, vp, plen, pos)
    ms = timer(lambda: prefix_suffix_attention(*args))
    kv_pos = torch.cat([torch.where(
        torch.arange(lp, device="cuda")[None] < plen.long()[:, None],
        torch.arange(lp, device="cuda")[None], 1 << 30), pos.long()], 1)
    mask = (kv_pos[:, None, :] <= pos.long()[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    kc = torch.cat([kp, ks], 1).transpose(1, 2)
    vc = torch.cat([vp, vs], 1).transpose(1, 2)
    lib = timer(lambda: F.scaled_dot_product_attention(
        qt, kc, vc, attn_mask=mask, enable_gqa=True))
    n_bytes, n_ops = prefix_suffix_cost(b, sq, lp, h, k, d, s_lens, plens,
                                        dtype)
    bms, by = bound_ms(n_bytes, n_ops, dtype)
    return dict(ms=ms, library_ms=lib, bound_ms=bms, bound_by=by,
                shape=f"B={b} Sq={sq} Lp={lp} H={h} K={k} D={d}")


def _logits_gate(on: dict, off: dict, cfg, tol: float = 1e-3):
    """Each hit request's first-token logits from the shared path against
    the same request's without sharing (its whole prompt prefilled): within
    ``tol`` of their scale, the same greedy token. Returns (hits, worst
    error over the scale)."""
    worst, hits = 0.0, 0
    for key, (a, hit) in on.items():
        if not hit:
            continue
        check(key in off, f"sharing: no unshared run of {key}")
        b = off[key][0]
        a, b = a[:cfg.vocab_size], b[:cfg.vocab_size]
        check(bool(torch.isfinite(a).all()), f"sharing: {key} non-finite")
        e = (a - b).abs().max().item()
        scale = max(1.0, b.abs().max().item())
        check(e <= tol * scale, f"sharing: {key}'s first-token logits differ"
              f" from the full recompute by {e} (scale {scale})")
        check(int(a.argmax()) == int(b.argmax()),
              f"sharing: {key}'s first token differs from the recompute")
        worst, hits = max(worst, e / scale), hits + 1
    return hits, worst


def phase_sharing(card: str, timer) -> None:
    """Closed-loop multi-turn sessions (SHARING) at full Qwen3-1.7B width
    and depth: fp32 with sharing off, fp32 with sharing on (streams
    identical, fewer tokens prefilled, each hit's first-token logits
    against the unshared run's), then bf16 with sharing on (tok/s, the
    kernels launched); prefix_suffix_attention timed at the largest suffix
    batch of the bf16 run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.models import transformer as T
    from repro_torch.serving.workload import generate_interactions

    cfg = get_config("qwen3-1.7b")
    sessions = generate_interactions(**SHARING)
    log(f"sharing: qwen3-1.7b full width/depth, {len(sessions)} sessions, "
        f"{sum(len(s.turns) for s in sessions)} turns "
        f"({', '.join(str(len(s.turns)) for s in sessions)}), fresh tokens "
        f"{[t.new_tokens for s in sessions for t in s.turns]}, outputs "
        f"{[t.output_tokens for s in sessions for t in s.turns]}")
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    runs = {}
    for share in (False, True):
        logits = {}
        srv, fe, m, secs, rec = _sessions(cfg, params, torch.float32,
                                          sessions, share=share,
                                          first_logits=logits)
        runs[share] = (srv, fe, _streams(fe, srv), logits)
        st = srv.stats
        check(len(runs[share][2]) == len(fe.requests),
              f"sharing {share}: unfinished requests")
        log(f"sharing fp32, share_prefix={share}: {m.row()}; {len(rec)} "
            f"cycles in {secs:.1f} s wall, prefill tokens "
            f"{st.prefill_tokens}, reused {st.reused_prefill_tokens}, "
            f"prefix hits {st.prefix_hits}, fused cycles {st.fused_cycles}, "
            f"COW copies {srv.pool.ops.cow_copies}; {captures(srv)}  "
            f"[{card}]")
    (s_off, fe_off, st_off, lg_off), (s_on, fe_on, st_on, lg_on) = (
        runs[False], runs[True])
    check(st_on == st_off, "sharing: fp32 streams differ with sharing on")
    check(s_on.stats.reused_prefill_tokens > 0, "sharing: nothing reused")
    check(s_on.stats.prefill_tokens < s_off.stats.prefill_tokens,
          "sharing: no fewer prefilled tokens")
    hits, worst = _logits_gate(lg_on, lg_off, cfg)
    check(hits > 0, "sharing: no hit request")
    log(f"sharing fp32: {len(st_on)} streams identical on and off; "
        f"prefilled tokens {s_off.stats.prefill_tokens} -> "
        f"{s_on.stats.prefill_tokens} "
        f"({s_off.stats.prefill_tokens / s_on.stats.prefill_tokens:.2f}x "
        f"fewer); {hits} hit requests' first-token logits within "
        f"{worst:.2e} of scale of the full recompute, same tokens")
    del runs, s_off, s_on, fe_off, fe_on, lg_on, lg_off
    params = {k: (tuple({n: t.to(torch.bfloat16) for n, t in blk.items()}
                        for blk in v) if k == "blocks"
                  else v.to(torch.bfloat16)) for k, v in params.items()}
    gc.collect()
    torch.cuda.empty_cache()
    FA.launches = PD.launches = BA.launches = 0
    srv, fe, m, secs, rec = _sessions(cfg, params, torch.bfloat16, sessions,
                                      share=True)
    launches = {"flash_attention": FA.launches,
                "paged_decode_attention": PD.launches,
                "bullet_attention_paged": BA.launches}
    for name, c in launches.items():
        check(c > 0, f"sharing bf16: {name} never launched")
    n_tok = sum(len(srv.outputs[r.rid]) for r in fe.requests)
    check(srv.stats.prefix_hits > 0, "sharing bf16: no prefix hit")
    log(f"sharing bf16, share_prefix=True: {m.row()}; {n_tok} tokens in "
        f"{secs:.2f} s wall = {n_tok / secs:.1f} tok/s, {len(rec)} cycles, "
        f"prefill tokens {srv.stats.prefill_tokens}, reused "
        f"{srv.stats.reused_prefill_tokens}, hits {srv.stats.prefix_hits}, "
        f"COW copies {srv.pool.ops.cow_copies}, fused cycles "
        f"{srv.stats.fused_cycles}, launches {launches}; {captures(srv)}  "
        f"[{card}]")
    log(f"sharing bf16 host ms of a serial prefill-group cycle: shared "
        f"(eager) {_group_ms(rec, True)}; miss (graphed) "
        f"{_group_ms(rec, False)}  [{card}]")
    shapes = [r["shape"] for r in rec if r["shape"] is not None]
    big = max(shapes, key=lambda sh: sh[0][0] * sh[0][1]
              * (sh[1][1] * PS + sh[0][1]))
    row = time_prefix_suffix(timer, cfg, big)
    log(f"prefix_suffix_attention (plain PyTorch), bf16: {row['ms']:.4f} ms "
        f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, masked SDPA "
        f"enable_gqa {row['library_ms']:.4f} ms) at {row['shape']}, the "
        f"run's largest suffix batch  [{card}]")


def phase_tenants(card: str) -> None:
    """The tenant layer over multi-turn sessions (TENANTS, app 0 flooding),
    bf16 with sharing on, at full Qwen3-1.7B width and depth: no
    controller, a permissive one (byte-identical streams and admission
    order), the full stack (credit and a rate limit of 2 new interactions
    per second per app: check_oit, every request finished, shed or
    throttled); Jain's index over per-tenant goodput."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.models import transformer as T
    from repro_torch.serving.request import WORKLOAD_SLOS
    from repro_torch.serving.tenancy import (TenancyConfig,
                                             TenancyController,
                                             generate_tenant_interactions,
                                             jain_index, make_apps,
                                             per_tenant_outcomes)

    cfg = get_config("qwen3-1.7b")
    kw = dict(TENANTS)
    sessions = generate_tenant_interactions(
        make_apps(4, rate_limit=2), kw.pop("n_sessions"), kw.pop("rate_s"),
        **kw)
    log(f"tenants: qwen3-1.7b bf16, {len(sessions)} sessions by app "
        f"{collections.Counter(s.app_id for s in sessions)}, "
        f"{sum(len(s.turns) for s in sessions)} turns")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    ctl = {"none": None,
           "permissive": TenancyController(make_apps(4), TenancyConfig(
               credit=False, rate_limit=0, kv_pressure=1.01)),
           "full": TenancyController(make_apps(4, rate_limit=2),
                                     TenancyConfig(credit=True))}
    out = {}
    slo = WORKLOAD_SLOS["sharegpt"]
    for name, ten in ctl.items():
        FA.launches = PD.launches = 0
        srv, fe, m, secs, rec = _sessions(cfg, params, torch.bfloat16,
                                          sessions, share=True, tenancy=ten)
        check(FA.launches > 0 and PD.launches > 0,
              f"tenants {name}: flash {FA.launches}, paged decode "
              f"{PD.launches} launches")
        for r in fe.requests:
            check(r.phase.name == "FINISHED" or r.rid in fe.shed,
                  f"tenants {name}: request {r.rid} neither finished nor "
                  "shed")
        per = per_tenant_outcomes(fe.requests, slo)
        jain = jain_index([per[a].goodput if a in per else 0
                           for a in range(4)])
        out[name] = (_streams(fe, srv), fe.admitted_order, jain)
        log(f"tenants {name}: {m.row()}; {len(fe.requests)} requests, "
            f"throttled {len(fe.throttled)}, shed {len(fe.shed)}, goodput "
            f"by app {[per[a].goodput if a in per else 0 for a in range(4)]}"
            f", Jain {jain:.3f}, reused {srv.stats.reused_prefill_tokens}, "
            f"{len(rec)} cycles in {secs:.2f} s wall  [{card}]")
        if ten is not None and ten.credit_enabled:
            ten.check_oit()
            log("tenants full: " + ", ".join(
                f"app{a} credit {ten.credit(a):.2f} admitted {st.admitted} "
                f"throttled {st.throttled}"
                for a, st in sorted(ten.stats.items())))
    check(out["permissive"][:2] == out["none"][:2],
          "tenants: a permissive controller changed the streams or order")
    check(len(ctl["full"].throttle_log) > 0, "tenants: the flood was not cut")
    log(f"tenants: permissive controller byte-identical to none; OIT held; "
        f"Jain over per-tenant goodput {out['none'][2]:.3f} (none) -> "
        f"{out['full'][2]:.3f} (full stack)")


#: the sim phase's comparison: the systems of the paper's Figs. 11-14 on
#: one llama3.1-8b instance of this card, over one ShareGPT trace
#: (generate_trace's rate in req/s and duration in s, seed 0: 368
#: requests), the estimator fitted as ``--mode sim`` fits it
SIM_SYSTEMS = ("bullet", "chunked-1024", "chunked-2048", "nanoflow-1024",
               "naive", "bullet-fix66", "bullet-nosched", "bullet-nopart")
SIM_TRACE = ("sharegpt", 100.0, 4.0)
#: the fleet: replicas of one card behind the prefix-affinity router,
#: generate_fleet_interactions(turns, req/s, seed 0), with replica 1 down
#: for trace seconds [1, 4). 800 turns at 160 req/s leave four H100s at
#: 0.999 attainment; this load takes them to about 0.98, the p99 TPOT past
#: the SLO's p99 hold
FLEET = dict(replicas=4, turns=4000, rate=2000.0)
FLEET_OUTAGE = dict(kind="dispatch", target="any", blocks=1, start=1, end=4)


def _sim_fleet(cfg, hw, est, card: str) -> None:
    """The fleet level, twice on one seed: every request finished or
    cancelled for want of a replica, the same per-request signature."""
    from repro_torch.launch.serve import fleet_sim_config, tail_line
    from repro_torch.resilience.faults import FaultPlan, FaultSpec
    from repro_torch.serving.request import WORKLOAD_SLOS, Phase
    from repro_torch.serving.tenancy import generate_fleet_interactions
    from repro_torch.sim import ClusterConfig, ClusterSimulator, tail_point

    slo = WORKLOAD_SLOS["sharegpt"]
    work = generate_fleet_interactions(FLEET["turns"], FLEET["rate"], seed=0)
    runs = []
    for _ in range(2):
        t = time.perf_counter()
        res = ClusterSimulator(ClusterConfig(
            sim=fleet_sim_config(cfg, hw, slo), n_replicas=FLEET["replicas"],
            router="prefix-affinity", seed=0,
            faults=FaultPlan(specs=[FaultSpec(**FLEET_OUTAGE)], seed=0)),
            est).run(work)
        secs = time.perf_counter() - t
        phases = collections.Counter(r.phase for r in res.requests)
        check(set(phases) <= {Phase.FINISHED, Phase.CANCELLED},
              f"sim fleet: requests left in {phases}")
        check(phases[Phase.CANCELLED] == res.cancelled_no_replica,
              "sim fleet: a request cancelled other than for want of a "
              "replica")
        runs.append((res, sorted(
            (r.rid, r.arrival, r.prefill_start, r.first_token_time,
             r.finish_time, r.generated) for r in res.requests)))
        log(f"sim fleet {FLEET['replicas']}x{cfg.name} router="
            f"prefix-affinity, {len(res.requests)} requests ({len(work)} "
            f"sessions) @ {FLEET['rate']:g} req/s, replica 1 down [1, 4) s: "
            f"{res.metrics.row()}; "
            f"{tail_line(tail_point(res.requests, slo), res)}; cycles "
            f"{[c for c, _, _ in res.replica_stats]}; {secs:.2f} s host  "
            f"[{card}]")
    (a, sig_a), (b, sig_b) = runs
    check(sig_a == sig_b and a.total_cycles == b.total_cycles
          and a.replica_stats == b.replica_stats,
          "sim fleet: the same seed replayed differently")
    log("sim fleet: the same seed replays identically")


def _sim_cross(cfg, est, trace, params, *, max_len, max_slots):
    """cross_validate on the card, its table drift a failure of the
    phase; returns the result, its wall seconds and the kernel launches
    of the engine's replay."""
    from repro_torch.kernels import bullet_attention as BA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.sim.replay_vs_sim import cross_validate

    FA.launches = PD.launches = BA.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        r = cross_validate(cfg, est, trace, params=params, device="cuda",
                           max_len=max_len, max_slots=max_slots)
    except RuntimeError as e:
        fail(f"sim cross-validation {cfg.name}: {e}")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = dict(flash=FA.launches, paged_decode=PD.launches,
                    fused_paged=BA.launches)
    check(launches["flash"] > 0 and launches["paged_decode"] > 0,
          f"sim cross-validation {cfg.name}: the engine launched {launches}")
    return r, secs, launches


def _over_tol(gap: float) -> str:
    from repro_torch.sim.replay_vs_sim import CYCLE_TOL
    return ("" if gap <= CYCLE_TOL else
            f"; over CYCLE_TOL {CYCLE_TOL:.0%}, not gated: the engine prices "
            "each decode on the page-bucketed contexts it streamed, the "
            "simulator on the mean context")


def _cross_line(what, r, secs, launches, card) -> str:
    return (f"sim cross-validation {what}: gap {r['cycle_gap']:.4%} (mean "
            f"cycle sim {r['mean_cycle_sim_s'] * 1e3:.6f} ms, engine "
            f"{r['mean_cycle_eng_s'] * 1e3:.6f} ms), cycles sim / engine "
            f"{r['n_cycles_sim']} / {r['n_cycles_eng']}, goodput "
            f"{r['m_sim'].goodput:.3f} / {r['m_replay'].goodput:.3f}, "
            f"{len(r['table'])} table entries, engine launches {launches}, "
            f"{secs:.2f} s wall  [{card}]")


def phase_sim(card: str) -> None:
    """The serving simulator priced for this card, and held against the
    port's engine with its kernels on the card: (i) the paper's
    comparison (SIM_SYSTEMS over SIM_TRACE: every request finished, its
    timestamps consistent); (ii) the fleet (FLEET, deterministic under
    the outage); (iii) cross_validate, (A) the JAX gate's recipe at the
    head dim the kernels are built for (tables equal, goodput 1.0 on both
    sides, at least 5 table entries, the card's engine cycles, mean cycle
    and metrics equal to the same run's on the CPU, so the gap is the
    CPU's: 23.7% at this head dim, where the JAX package gives the same;
    tests/port/test_torch_simulate.py holds CYCLE_TOL at the JAX recipe's
    head dim 32), (B) at full width and depth in bf16 on the replay
    phase's trace (tables equal). Gaps are printed, not gated."""
    from repro_torch.configs import get_config
    from repro_torch.core.estimator import (HardwareSpec, PerfEstimator,
                                            fit_params)
    from repro_torch.core.profiler import SurrogateMachine, run_profiling
    from repro_torch.core.simulate import ServingSimulator, SimConfig
    from repro_torch.launch.serve import fitted_estimator, spec_line
    from repro_torch.models import transformer as T
    from repro_torch.serving.request import WORKLOAD_SLOS, Phase
    from repro_torch.serving.workload import (fit_trace_to_context,
                                              generate_trace)
    from repro_torch.sim.replay_vs_sim import cross_validate

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = get_config("llama3.1-8b")
    t = time.perf_counter()
    hw, est = fitted_estimator(cfg, 1)
    check(hw.units_per_chip == sms, f"sim: spec has {hw.units_per_chip} "
          f"units, the card {sms} SMs")
    log(f"sim {spec_line(hw)}; fitted in {time.perf_counter() - t:.2f} s "
        f"host  [{card}]")
    slo = WORKLOAD_SLOS["sharegpt"]
    for system in SIM_SYSTEMS:
        trace = generate_trace(*SIM_TRACE, seed=0)
        t = time.perf_counter()
        m = ServingSimulator(SimConfig(model=cfg, hw=hw, slo=slo), est,
                             SurrogateMachine(hw, seed=7), system).run(trace)
        secs = time.perf_counter() - t
        for r in trace:
            check(r.phase == Phase.FINISHED
                  and r.prefill_start >= r.arrival - 1e-9
                  and r.first_token_time >= r.prefill_start
                  and r.finish_time >= r.first_token_time
                  and r.generated == r.output_len,
                  f"sim {system}: request {r.rid} unfinished or "
                  "inconsistent")
        log(f"sim {system:16s} {m.row()}  ({len(trace)} requests, "
            f"{secs:.2f} s host, {1e3 * secs / len(trace):.1f} ms a "
            f"request)")
    _sim_fleet(cfg, hw, est, card)

    # (A) the JAX gate's recipe, at the head dim the kernels are built for
    cfg = get_config("qwen3-1.7b").reduced(head_dim=D)
    sweep = dict(max_sl=2048, max_bs=16, max_cl=2048)
    hw = HardwareSpec()
    est = PerfEstimator(hw, fit_params(run_profiling(cfg, hw, **sweep), cfg,
                                       hw, iters=20))
    trace = fit_trace_to_context(generate_trace(
        "sharegpt", 8.0, 5.0, seed=1, max_requests=16), 64)
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    r, secs, launches = _sim_cross(cfg, est, trace, params, max_len=64,
                                   max_slots=4)
    log(_cross_line(f"(A) {cfg.name} fp32, {len(trace)} requests", r, secs,
                    launches, card) + _over_tol(r["cycle_gap"]))
    check(r["m_sim"].goodput == r["m_replay"].goodput == 1.0,
          "sim (A): goodput below 1.0")
    check(len(r["table"]) >= 5, "sim (A): table under 5 entries")
    cpu = {k: (tuple({n: x.cpu() for n, x in b.items()} for b in v)
               if k == "blocks" else v.cpu()) for k, v in params.items()}
    c = cross_validate(cfg, est, trace, params=cpu, device="cpu",
                       max_len=64, max_slots=4)
    keys = ("n_cycles_sim", "n_cycles_eng", "mean_cycle_sim_s",
            "mean_cycle_eng_s", "table")
    check(all(r[k] == c[k] for k in keys)
          and r["m_replay"].row() == c["m_replay"].row(),
          "sim (A): the engine on the card decided otherwise than on the "
          "CPU")
    log("sim (A): the card's engine cycles, mean cycle and metrics equal "
        "the same run's on the CPU")

    # (B) full width and depth, bf16, the replay phase's trace
    cfg = get_config("qwen3-1.7b")
    est = PerfEstimator(hw, fit_params(run_profiling(cfg, hw, **sweep), cfg,
                                       hw, iters=20))
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    trace = _replay_trace()
    r, secs, launches = _sim_cross(cfg, est, trace, params, max_len=MAX_LEN,
                                   max_slots=8)
    log(_cross_line(f"(B) {cfg.name} bf16, {len(trace)} requests, max_len "
                    f"{MAX_LEN}, 8 slots", r, secs, launches, card)
        + _over_tol(r["cycle_gap"]))


# ---------------------------------------------------------------------------
# head dim 64 and the encoder-decoder: Granite-3.0-2B on the paged fused
# path, SeamlessM4T-Large-v2's encoder and cross-attention, InternVL2-76B's
# frontend
# ---------------------------------------------------------------------------

GRANITE, SEAMLESS, INTERNVL = ("granite-3-2b", "seamless-m4t-large-v2",
                               "internvl2-76b")
#: the archs reference: prompts (tokens; InternVL2's behind its patches)
#: as one padded batch, and greedy decode steps
ARCH_REF_PROMPTS, ARCH_REF_DECODE = (40, 23), 8
#: InternVL2-76B's cut: layers of its 80, rows of 256 stub patches
#: prepended to prompts of IV_PROMPTS tokens, greedy decode steps
IV_LAYERS, IV_PROMPTS, IV_DECODE = 8, (64, 500), 32


def _frontend_rows(cfg, b: int, seed: int):
    """Seeded stub frontend rows on the CPU (B, n, De): an encoder-decoder
    model's ``encoder_seq_len`` frames, a VLM's ``frontend_embed_len``
    patches; None without a frontend."""
    n = cfg.encoder_seq_len if cfg.n_encoder_layers else cfg.frontend_embed_len
    if not n:
        return None
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (b, n, cfg.frontend_embed_dim)).astype(np.float32))


def _prepended(cfg) -> int:
    """Rows a decoder-only VLM's frontend adds in front of each prompt."""
    return 0 if cfg.n_encoder_layers else cfg.frontend_embed_len


def phase_archs_reference(card: str) -> dict:
    """Granite, Seamless and InternVL2 at reduced widths with head dim 64
    (so the D = 64 kernels run) and their own heads, fp32, card (kernels)
    against CPU (plain versions): the models-level ``prefill`` of
    ARCH_REF_PROMPTS as one padded batch (Seamless encoding its 16 stub
    frames, InternVL2 prepending its 8 patches) and ARCH_REF_DECODE greedy
    ``decode_step``s through ``GraphedDecode`` on the dense slot cache,
    logits within 1e-3 of scale and tokens equal (the MoE reference's
    gate); then reduced Granite through BulletServer fused, card against
    CPU, streams and cycles equal. Returns the fp32 D = 64 rows' launches:
    Granite's engine run (flash, paged decode, the paged fused kernel) and
    Seamless's reference (its encoder's flash, its decode)."""
    from repro_torch.models import transformer as T

    launches = {}
    for name in (GRANITE, SEAMLESS, INTERNVL):
        cfg = _reduced_heads(name, D64)
        params = T.init_params(cfg, seed=7, dtype=torch.float32,
                               device="cuda")
        toks, lens = _prompt_batch(cfg, ARCH_REF_PROMPTS, seed=8)
        fe = _frontend_rows(cfg, len(ARCH_REF_PROMPTS), seed=9)
        lens = lens + _prepended(cfg)
        max_len = int(lens.max()) + ARCH_REF_DECODE
        outs = {}
        for side, p in (("cuda", params), ("cpu", _to_cpu(params))):
            dev = p["embed"].device
            _reset_counts()
            cache = T.init_cache(cfg, len(lens), max_len, torch.float32, dev)
            outs[side], _ = _greedy(p, cfg, toks, lens, cache,
                                    ARCH_REF_DECODE, frontend=fe)
            if side == "cuda":
                counts = _kernel_counts()
        worst = _card_vs_cpu(outs, cfg)
        check(counts["flash"] > 0 and counts["decode"] > 0,
              f"{name} reference: launches {counts}")
        if name == SEAMLESS:
            launches["flash_attention_d64_encoder_fp32"] = counts["flash"]
            launches["decode_attention_d64_fp32"] = counts["decode"]
        front = (f"encoder of {cfg.encoder_seq_len} frames, "
                 if cfg.n_encoder_layers else
                 f"{_prepended(cfg)} patches prepended, " if fe is not None
                 else "")
        log(f"archs reference {name}: reduced widths, H={cfg.n_heads} "
            f"K={cfg.n_kv_heads} D={cfg.head_dim}, fp32, {front}"
            f"prompts {list(ARCH_REF_PROMPTS)} + {ARCH_REF_DECODE} decode "
            f"steps: card vs CPU max rel logit err {worst:.2e}, tokens "
            f"equal; launches {counts}  [{card}]")

    cfg = _reduced_heads(GRANITE, D64)
    rng = np.random.default_rng(10)
    m = MOE_ENGINE
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(
        m["lo"], m["hi"]))).astype(np.int32) for _ in range(m["n"])]
    counts = _engine_card_vs_cpu(GRANITE, cfg, prompts, 11, True, card)
    launches.update(flash_attention_d64_fp32=counts["flash"],
                    paged_decode_attention_d64_fp32=counts["paged_decode"],
                    bullet_attention_paged_d64_fp32=counts["bullet_paged"])
    return launches


def phase_granite(card: str) -> dict:
    """Granite-3.0-2B at its published depth and widths (40 layers,
    d_model 2048, 32 query heads on 8 kv heads, D = 64, seeded random
    weights, bf16) through BulletServer on the paged path
    (``_serve_full``: the serve phase's 12 requests fused and serial with
    identical streams, then under the scheduler's defaults); then its
    graphs against the eager steps (``_paged_graphs``: serial decode at
    the serve's table buckets, the fused cycle in segments at repeats 0,
    20 and 39, the prefill groups and first tokens). Returns the bf16
    D = 64 rows' launches of the fused serve."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(GRANITE)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab_size)
          == (40, 2048, GR_H, GR_K, D64, 8192, 49155),
          "not the published Granite-3.0-2B widths")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"granite: {T.param_count(params) / 1e9:.2f} G params in bf16 "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB) drawn in "
        f"{time.perf_counter() - t0:.1f} s; {cfg.n_layers} layers, paged KV "
        f"{2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2} B a token "
        f" [{card}]")
    counts, buckets = _serve_full("granite-3-2b", cfg, params, card)
    _paged_graphs("granite-3-2b", cfg, params, buckets, card, (0, 20, 39),
                  24)
    return {"flash_attention_d64": counts["flash"],
            "paged_decode_attention_d64": counts["paged_decode"],
            "bullet_attention_paged_d64": counts["bullet_paged"]}


def _decode_graphed(params, cfg, cache, logits, lens, n_dec: int,
                    what: str, card: str, long_context: bool = False):
    """``n_dec`` greedy ``decode_step``s through ``GraphedDecode`` from a
    prefill's ``logits`` (the first step captures, the rest replay,
    timed), then the same steps eagerly on a copy of the cache taken
    before them, fed the same tokens: fatal unless every step's logits
    and, after the last, every cache leaf are bit-equal. ``long_context``:
    the cache's (its full-attention entries are rings). Returns (ms per
    replayed step, the first step's ms, the launch counts of the graphed
    steps)."""
    from repro_torch.core.graphs import GraphedDecode
    from repro_torch.models import transformer as T
    twin = _clone_tree(cache)
    _reset_counts()
    dec = GraphedDecode(params, cache, cfg, long_context=long_context)
    tok = logits.argmax(-1).to(torch.int32)
    pos = lens.clone()
    fed, seen = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_dec):
        fed.append(tok)
        lg = dec(tok[:, None], pos)
        seen.append(lg.clone())
        tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t_first, t_dec = t1 - t0, time.perf_counter() - t1
    counts = _kernel_counts()
    pos = lens.clone()
    for i, tok in enumerate(fed):
        lg, _ = T.decode_step(params, twin, tok[:, None], pos, cfg,
                              long_context=long_context)
        check(torch.equal(lg, seen[i]), f"{what}: decode step {i}: the "
              "graph's logits differ from the eager step's")
        pos = pos + 1
    for i, (a, b) in enumerate(zip(_leaves(cache), _leaves(twin))):
        check(torch.equal(a, b), f"{what}: cache leaf {i} differs after "
              f"{n_dec} graphed and eager steps")
    check(bool(torch.isfinite(seen[-1][:, :cfg.vocab_size]).all()),
          f"{what}: non-finite decode logits")
    log(f"{what}: {n_dec} greedy decode steps through GraphedDecode, "
        f"logits and cache bit-equal to the eager decode_step; "
        f"{captures(dec)}  [{card}]")
    return 1e3 * t_dec / (n_dec - 1), 1e3 * t_first, counts


def _profile_models_level(params, cfg, toks, lens, max_len, frontend,
                          what: str, card: str) -> None:
    """torch.profiler windows over one ``prefill`` call (with its
    ``frontend``) and over 10 decode steps replayed through
    ``GraphedDecode`` (after the step that captures)."""
    from repro_torch.core.graphs import GraphedDecode
    from repro_torch.models import transformer as T
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    b = toks.shape[0]
    cache = T.init_cache(cfg, b, max_len, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, _ = T.prefill(params, toks, lens, cache, None, cfg,
                              frontend=frontend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _profile_report(prof, wall, f"{what}, one prefill call", card)
    dec = GraphedDecode(params, cache, cfg)
    lg = dec(logits.argmax(-1).to(torch.int32)[:, None], lens)
    tok, pos = lg.argmax(-1).to(torch.int32), lens + 1
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            lg = dec(tok[:, None], pos)
            tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _profile_report(prof, wall, f"{what}, 10 decode steps (graph replays)",
                    card, cycles=10, tokens=10 * b)


def phase_seamless(card: str) -> dict:
    """SeamlessM4T-Large-v2 at its published depth and widths (24 encoder
    and 24 decoder layers, d_model 1024, 16 heads of D = 64, vocab 256206,
    seeded random weights, bf16) through the models-level path: 4 rows of
    SM_SE stub frames encoded, decoder prompts of SM_PROMPTS tokens
    prefilled (every block cross-attending the encoder's K/V, the cross
    cache filled), then SM_DECODE greedy steps through ``GraphedDecode``,
    bit-equal to the eager ``decode_step``: the encoder's, the prefill's
    and a decode step's ms, and the launches (the encoder's, the
    decoder's and the cross-attention's flash per prefill; self and cross
    dense decode per step); profiles of one prefill call and 10 decode
    steps. Returns the bf16 D = 64 rows' launches of this run: flash
    (encoder row) and dense decode (cross decode row)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(SEAMLESS)
    check((cfg.n_encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim, cfg.encoder_seq_len,
           cfg.vocab_size) == (24, 24, 1024, SM_H, SM_H, D64, SM_SE, 256206)
          and cfg.cross_attention, "not the published SeamlessM4T widths")
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    b = len(SM_PROMPTS)
    gen = torch.Generator(device="cuda").manual_seed(24)
    frames = torch.randn(b, SM_SE, cfg.frontend_embed_dim, generator=gen,
                         device="cuda").to(torch.bfloat16)
    toks, lens = _prompt_batch(cfg, SM_PROMPTS, seed=25)
    toks, lens = toks.cuda(), lens.cuda()
    max_len = max(SM_PROMPTS) + SM_DECODE
    log(f"seamless: {T.param_count(params) / 1e9:.2f} G params in bf16 "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB): "
        f"{cfg.n_encoder_layers} encoder and {cfg.n_layers} decoder layers; "
        f"{b} rows of {SM_SE} stub frames, decoder prompts "
        f"{list(SM_PROMPTS)}, dense cache of {max_len} rows, cross cache "
        f"of {SM_SE}  [{card}]")
    # warm-up: cuBLAS handles and kernel modules load outside the timing
    T.prefill(params, toks, lens, T.init_cache(cfg, b, max_len,
                                               torch.bfloat16, "cuda"),
              None, cfg, frontend=frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = T.encode(params, frames, cfg)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    check(bool(torch.isfinite(enc).all()), "seamless: non-finite encoder")
    del enc
    _reset_counts()
    cache = T.init_cache(cfg, b, max_len, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = T.prefill(params, toks, lens, cache, None, cfg,
                          frontend=frames)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre = _kernel_counts()
    want = 3 * cfg.n_layers     # encoder, decoder self, cross: one each
    check(pre["flash"] == want and pre["decode"] == 0,
          f"seamless prefill: launches {pre}, want {want} flash")
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "seamless: non-finite prefill logits")
    ms, first, dec = _decode_graphed(params, cfg, cache, logits, lens,
                                     SM_DECODE, "seamless", card)
    check(dec["decode"] == 2 * cfg.n_layers * SM_DECODE and dec["flash"] == 0,
          f"seamless decode: launches {dec}, want {2 * cfg.n_layers} dense "
          "decode (self and cross) a step")
    log(f"seamless bf16: encoder {1e3 * t_enc:.2f} ms ({b} x {SM_SE} "
        f"frames), prefill {1e3 * t_pre:.2f} ms (encoder included), decode "
        f"{ms:.3f} ms per step over {SM_DECODE - 1} graph replays ({b} "
        f"slots, {b * 1e3 / ms:.1f} output tok/s), the first step (eager, "
        f"then the capture) {first:.1f} ms; launches prefill {pre}, decode "
        f"{dec}  [{card}]")
    _profile_models_level(params, cfg, toks, lens, max_len, frames,
                          f"SeamlessM4T-Large-v2 bf16 ({b} rows of {SM_SE} "
                          "frames)", card)
    del params, cache
    torch.cuda.empty_cache()
    return {"flash_attention_d64_encoder": pre["flash"],
            "decode_attention_d64": dec["decode"]}


def phase_internvl(card: str) -> None:
    """InternVL2-76B at its published widths (d_model 8192, 64 query
    heads on 8 kv heads, D = 128, d_ff 28672, vocab 128256; its stub
    frontend of 256 patches of dim 3200 and their projector) over
    IV_LAYERS of its 80 layers (the depth cut: all 80 in bf16 would take
    ~150 GB), seeded random weights, bf16, on the dense slot cache
    through the models-level path: 2 rows of 256 patches prepended to
    prompts of IV_PROMPTS tokens, prefilled, then IV_DECODE greedy steps
    through ``GraphedDecode``, bit-equal to the eager ``decode_step``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    full = get_config(INTERNVL)
    check((full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
           full.head_dim, full.d_ff, full.vocab_size,
           full.frontend_embed_len, full.frontend_embed_dim)
          == (80, 8192, IV_H, IV_K, D, 28672, 128256, IV_PATCHES, 3200),
          "not the published InternVL2-76B widths")
    cfg = dataclasses.replace(full, n_layers=IV_LAYERS)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    b, nf = len(IV_PROMPTS), cfg.frontend_embed_len
    gen = torch.Generator(device="cuda").manual_seed(26)
    patches = torch.randn(b, nf, cfg.frontend_embed_dim, generator=gen,
                          device="cuda").to(torch.bfloat16)
    toks, lens = _prompt_batch(cfg, IV_PROMPTS, seed=27)
    toks, lens = toks.cuda(), lens.cuda() + nf
    max_len = nf + max(IV_PROMPTS) + IV_DECODE
    log(f"internvl: {T.param_count(params) / 1e9:.2f} G params in bf16 "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB) drawn in "
        f"{time.perf_counter() - t0:.1f} s: {IV_LAYERS} of its "
        f"{full.n_layers} layers (depth cut), published widths; {b} rows of "
        f"{nf} patches prepended to prompts {list(IV_PROMPTS)}, dense cache "
        f"of {max_len} rows  [{card}]")
    T.prefill(params, toks, lens, T.init_cache(cfg, b, max_len,
                                               torch.bfloat16, "cuda"),
              None, cfg, frontend=patches)
    _reset_counts()
    cache = T.init_cache(cfg, b, max_len, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = T.prefill(params, toks, lens, cache, None, cfg,
                          frontend=patches)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre = _kernel_counts()
    check(pre["flash"] == IV_LAYERS, f"internvl prefill: launches {pre}")
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "internvl: non-finite prefill logits")
    ms, first, dec = _decode_graphed(params, cfg, cache, logits, lens,
                                     IV_DECODE, "internvl", card)
    check(dec["decode"] == IV_LAYERS * IV_DECODE,
          f"internvl decode: launches {dec}")
    log(f"internvl bf16 ({IV_LAYERS} of {full.n_layers} layers): prefill "
        f"{1e3 * t_pre:.2f} ms ({int(lens.sum())} rows, patches included), "
        f"decode {ms:.3f} ms per step over {IV_DECODE - 1} graph replays, "
        f"the first step {first:.1f} ms; launches prefill {pre}, decode "
        f"{dec}  [{card}]")
    del params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the chunked prefill and the long-context prefill at published widths
# ---------------------------------------------------------------------------

#: fp32, chunked against unchunked: (arch, layers (0: all), rows, prompt
#: tokens, chunk sequences); Mixtral at 2 of its 56 layers (one layer in
#: fp32 is 10 GB)
CHUNKED_RUNS = (
    ("qwen3-1.7b", 0, 2, 2048, ((512,) * 4, (768, 768, 512))),
    ("mamba2-2.7b", 0, 2, 2000, ((500,) * 4,)),
    ("recurrentgemma-2b", 0, 2, 2000, ((512, 512, 512, 464),)),
    ("mixtral-8x22b", 2, 2, 2048, ((512,) * 4,)))
#: greedy decode steps after each prefill, chunked against unchunked
CHUNKED_DECODE = 8
#: the JAX recipe's gate (tests/test_chunked_real.py): within this much of
#: the logits' scale max(1, max|forward|)
CHUNKED_TOL = 2e-3
#: bf16: one prompt of CHUNKED_PROMPT tokens, chunks of CHUNK_SIZES, then
#: CHUNKED_GRAPHED greedy steps through GraphedDecode; the last logits
#: bit-equal to the unchunked prefill's (every chunk starts on kernel 1's
#: query tiles, so each row meets the same key tiles in the same order,
#: and the GEMMs and norms are row by row)
CHUNKED_PROMPT, CHUNK_SIZES, CHUNKED_GRAPHED = 8192, (512, 1024, 2048), 32
#: the long-context prefill: Qwen3-1.7B's 8192-token window, one padded
#: batch of these prompts, LC_DECODE graphed steps over the ring (bf16);
#: fp32 rows against their solo prefills within LC_TOL of scale
LC_PROMPTS, LC_DECODE, LC_TOL = (16384, 12000), 32, 1e-3


def _chunked_cfg(arch: str, layers: int):
    """The published config (depth cut to ``layers`` when given), a MoE
    config at capacity factor 8 as the JAX recipe sets it (no token
    drops, so chunking changes no routing)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    return cfg


def _run_chunks(params, cfg, toks, chunks, max_len, dtype):
    """``prefill_chunk`` over ``toks`` (B, S) in ``chunks`` through a fresh
    dense cache of ``max_len`` rows. Returns (the last chunk's logits,
    the cache, ms of each chunk on the host clock, synchronized)."""
    from repro_torch.models import prefill_chunk
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, toks.shape[0], max_len, dtype, "cuda")
    ms, start = [], 0
    for n in chunks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = prefill_chunk(params, toks[:, start:start + n], start,
                                  cache, cfg)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        start += n
    check(start == toks.shape[1], f"chunks {chunks} do not cover the prompt")
    return logits, cache, ms


def _eager_greedy(params, cfg, cache, logits, pos, n_dec: int):
    """``n_dec`` greedy eager ``decode_step``s from a prefill's logits:
    (the logits of each step, the tokens fed)."""
    from repro_torch.models import transformer as T
    seq, fed = [], []
    tok = logits.argmax(-1).to(torch.int32)
    for _ in range(n_dec):
        fed.append(tok)
        lg, _ = T.decode_step(params, cache, tok[:, None], pos, cfg)
        seq.append(lg)
        tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
    return seq, fed


def _chunked_fp32(params, cfg, b, s, seqs, depth: str, card: str) -> dict:
    """One run of CHUNKED_RUNS in fp32: ``forward``'s logits at S - 1 and
    CHUNKED_DECODE greedy steps from the unchunked ``prefill``'s cache,
    then per chunk sequence the last chunk's logits against the former and
    CHUNKED_DECODE steps from the chunked cache against the latter, within
    CHUNKED_TOL of scale, tokens equal. Returns the flash and SSD launches
    of the chunked prefills."""
    from repro_torch.models import transformer as T
    toks = torch.from_numpy(np.random.default_rng(29).integers(
        0, cfg.vocab_size, (b, s), dtype=np.int32)).cuda()
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    max_len = s + CHUNKED_DECODE
    v = cfg.vocab_size              # the padded vocabulary reads -1e30
    full, _ = T.forward(params, toks, cfg)
    last = full[:, -1, :v].clone()
    scale = max(full[..., :v].abs().max().item(), 1.0)
    del full
    cache = T.init_cache(cfg, b, max_len, torch.float32, "cuda")
    logits, _ = T.prefill(params, toks, lens, cache, None, cfg)
    ref_seq, ref_fed = _eager_greedy(params, cfg, cache, logits, lens,
                                     CHUNKED_DECODE)
    del cache
    out = {"flash": 0, "ssd": 0}
    for chunks in seqs:
        _reset_counts()
        lg, cache, ms = _run_chunks(params, cfg, toks, chunks, max_len,
                                    torch.float32)
        counts = _kernel_counts()
        out["flash"] += counts["flash"]
        out["ssd"] += counts["ssd"]
        e_last = (lg[:, :v] - last).abs().max().item() / scale
        what = f"chunked {cfg.name} fp32 ({depth}) {b}x{s} in {list(chunks)}"
        check(e_last <= CHUNKED_TOL, f"{what}: last logits {e_last} of "
              "scale from forward's")
        seq, fed = _eager_greedy(params, cfg, cache, lg, lens,
                                 CHUNKED_DECODE)
        e_dec = 0.0
        for i, (a, r) in enumerate(zip(seq, ref_seq)):
            check(torch.equal(fed[i], ref_fed[i]), f"{what}: decode step "
                  f"{i} fed other tokens than the unchunked run's")
            e_dec = max(e_dec, (a[:, :v] - r[:, :v]).abs().max().item()
                        / scale)
        check(e_dec <= CHUNKED_TOL, f"{what}: decode logits {e_dec} of "
              "scale from the unchunked cache's")
        log(f"{what}: last logits {e_last:.3e} of scale from forward's at "
            f"S-1, {CHUNKED_DECODE} greedy steps {e_dec:.3e} of scale from "
            f"the unchunked prefill's, tokens equal (tolerance "
            f"{CHUNKED_TOL}); chunk ms {[round(t, 2) for t in ms]}; "
            f"launches flash {counts['flash']}, ssd_scan {counts['ssd']}  "
            f"[{card}]")
        del cache
    return out


def _long_context(params, cfg, dtype, card: str) -> dict:
    """Qwen3-1.7B's long-context prefill of LC_PROMPTS as one padded
    batch. fp32: each row's last logits and every layer's ring against its
    solo long-context prefill, within LC_TOL of scale. bf16: the prefill's
    ms (a warm-up call first), then LC_DECODE greedy
    ``decode_step(long_context=True)`` steps through ``GraphedDecode``,
    bit-equal to eager (ms a step), kernel 1's (windowed) and kernel 4's
    (over the ring) launches. Returns those launches (bf16)."""
    from repro_torch.models import transformer as T
    b, s = len(LC_PROMPTS), max(LC_PROMPTS)
    window = cfg.long_context_window
    toks, lens = _prompt_batch(cfg, LC_PROMPTS, seed=31)
    toks, lens = toks.cuda(), lens.cuda()
    max_len = s + LC_DECODE
    tag = _dt_name(dtype)
    what = (f"long context qwen3-1.7b {tag} (window {window}), prompts "
            f"{list(LC_PROMPTS)} in one batch")

    def run(t, n):
        cache = T.init_cache(cfg, t.shape[0], max_len, dtype, "cuda",
                             long_context=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = T.prefill(params, t, n, cache, None, cfg, long_context=True)
        torch.cuda.synchronize()
        return lg, cache, 1e3 * (time.perf_counter() - t0)

    if dtype == torch.float32:
        logits, cache, _ = run(toks, lens)
        rings = _leaves(cache)
        check(all(leaf.shape[2] == window for leaf in rings),
              f"{what}: the rings are not {window} rows")
        worst = [0.0, 0.0]
        v = cfg.vocab_size
        for i, n in enumerate(LC_PROMPTS):
            lg, solo, _ = run(toks[i:i + 1, :n], lens[i:i + 1])
            e = rel_err(logits[i:i + 1, :v], lg[:, :v])
            worst[0] = max(worst[0], e)
            for a, r in zip(rings, _leaves(solo)):
                worst[1] = max(worst[1], rel_err(a[:, i:i + 1], r))
            del solo
        check(worst[0] <= LC_TOL and worst[1] <= LC_TOL,
              f"{what}: against the solo prefills logits {worst[0]}, rings "
              f"{worst[1]} of scale")
        log(f"{what}: against each row's solo prefill, logits "
            f"{worst[0]:.3e} and every layer's ring {worst[1]:.3e} of scale "
            f"(tolerance {LC_TOL})  [{card}]")
        return {}
    run(toks, lens)                                  # warm-up
    _reset_counts()
    logits, cache, t_pre = run(toks, lens)
    pre = _kernel_counts()
    check(pre["flash"] == cfg.n_layers, f"{what}: prefill launches {pre}")
    ms, first, dec = _decode_graphed(params, cfg, cache, logits, lens,
                                     LC_DECODE, what, card,
                                     long_context=True)
    check(dec["decode"] == cfg.n_layers * LC_DECODE and dec["flash"] == 0,
          f"{what}: decode launches {dec}")
    log(f"{what}: prefill {t_pre:.2f} ms ({int(lens.sum())} tokens), decode "
        f"{ms:.3f} ms per step over {LC_DECODE - 1} graph replays over the "
        f"{window}-row ring, the first step {first:.1f} ms; launches "
        f"prefill {pre['flash']} flash (window {window}), decode "
        f"{dec['decode']} dense decode over the ring  [{card}]")
    del cache
    return {"flash": pre["flash"], "decode": dec["decode"]}


def _chunked_bf16(card: str) -> dict:
    """Qwen3-1.7B at full depth in bf16: one prompt of CHUNKED_PROMPT
    tokens prefilled whole and in chunks of each of CHUNK_SIZES (ms in
    total and per chunk on the host clock, first to last; the last logits
    bit-equal to the whole prefill's), one more pass of the
    whole prefill and of each chunk size under torch.profiler (device busy
    ms, kernel 1's apart from the rest), then CHUNKED_GRAPHED greedy steps
    from the cache of the chunks of CHUNK_SIZES[0] through
    ``GraphedDecode``; then the long-context batch (``_long_context``).
    Returns kernel 1's launches in the chunked prefills."""
    from repro_torch.models import transformer as T
    cfg = _chunked_cfg("qwen3-1.7b", 0)
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(30).integers(
        0, cfg.vocab_size, (1, CHUNKED_PROMPT), dtype=np.int32)).cuda()
    lens = torch.full((1,), CHUNKED_PROMPT, dtype=torch.int32, device="cuda")
    max_len = CHUNKED_PROMPT + CHUNKED_GRAPHED
    what = f"chunked qwen3-1.7b bf16 (all {cfg.n_layers} layers)"
    # warm-up: cuBLAS handles and kernel modules load outside the timing
    T.prefill(params, toks, lens, T.init_cache(cfg, 1, max_len,
                                               torch.bfloat16, "cuda"),
              None, cfg)
    _run_chunks(params, cfg, toks, (CHUNK_SIZES[0],) * (
        CHUNKED_PROMPT // CHUNK_SIZES[0]), max_len, torch.bfloat16)
    cache = T.init_cache(cfg, 1, max_len, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole, _ = T.prefill(params, toks, lens, cache, None, cfg)
    torch.cuda.synchronize()
    t_whole = 1e3 * (time.perf_counter() - t0)
    del cache
    v = cfg.vocab_size
    whole = whole[:, :v].float()
    scale = max(whole.abs().max().item(), 1.0)
    log(f"{what}: one prompt of {CHUNKED_PROMPT} tokens, unchunked prefill "
        f"{t_whole:.2f} ms  [{card}]")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def profiled(fn, label, n):
        """Device busy ms and kernel 1's of one more pass of ``fn``."""
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rep = _profile_report(prof, wall, f"{what}, {label}", card, cycles=n)
        return rep["busy_ms"], rep["kind_ms"].get(
            "attention (this port's kernels)", 0.0)

    flash, kept = 0, None
    for size in CHUNK_SIZES:
        chunks = (size,) * (CHUNKED_PROMPT // size)
        _reset_counts()
        lg, cache, ms = _run_chunks(params, cfg, toks, chunks, max_len,
                                    torch.bfloat16)
        n = _kernel_counts()["flash"]
        check(n == cfg.n_layers * len(chunks), f"{what}: chunks of {size}: "
              f"{n} flash launches")
        flash += n
        e = (lg[:, :v].float() - whole).abs().max().item() / scale
        check(torch.equal(lg[:, :v].float(), whole), f"{what}: chunks of "
              f"{size}: last logits {e} of scale from the unchunked "
              "prefill's, not bit-equal")
        log(f"{what}: chunks of {size}: {sum(ms):.2f} ms in all "
            f"({sum(ms) / t_whole:.2f}x the unchunked prefill), per chunk "
            f"first to last {[round(t, 2) for t in ms]}; last logits "
            f"bit-equal to the unchunked prefill's  [{card}]")
        if size == CHUNK_SIZES[0]:
            kept = (lg, cache)
        else:
            del cache
    # the profiled passes after every timed one, so that no profiler
    # session runs before a pass whose wall time is read
    runs = [("the unchunked prefill", 1, lambda: T.prefill(
        params, toks, lens, T.init_cache(cfg, 1, max_len, torch.bfloat16,
                                         "cuda"), None, cfg))]
    for size in CHUNK_SIZES:
        chunks = (size,) * (CHUNKED_PROMPT // size)
        runs.append((f"{len(chunks)} chunks of {size}", len(chunks),
                     functools.partial(_run_chunks, params, cfg, toks,
                                       chunks, max_len, torch.bfloat16)))
    for label, n, fn in runs:
        busy, attn = profiled(fn, label, n)
        log(f"{what}: {label}: device busy {busy:.2f} ms, kernel 1 "
            f"{attn:.2f} ms  [{card}]")
    ms, first, _ = _decode_graphed(params, cfg, kept[1], kept[0], lens,
                                   CHUNKED_GRAPHED, what, card)
    log(f"{what}: {CHUNKED_GRAPHED} greedy steps from the chunked cache "
        f"(chunks of {CHUNK_SIZES[0]}) through GraphedDecode, {ms:.3f} ms "
        f"per step over {CHUNKED_GRAPHED - 1} replays, the first {first:.1f} "
        f"ms  [{card}]")
    del kept
    lc = _long_context(params, cfg, torch.bfloat16, card)
    del params
    torch.cuda.empty_cache()
    return flash, lc


#: bf16 Mamba-2-2.7B: one prompt of SSD_CHUNKED_PROMPT tokens in these
#: chunks, each on the SSD chunks' boundaries but the last
SSD_CHUNKED_PROMPT, SSD_CHUNKS = 2000, (512, 512, 512, 464)


def _ssd_chunked_bf16(card: str) -> int:
    """Mamba-2-2.7B at full depth in bf16: one prompt of SSD_CHUNKED_PROMPT
    tokens prefilled whole and in SSD_CHUNKS (each chunk's scan from the
    state the chunk before left, zeros for the first). On the SSD chunks'
    own boundaries (multiples of SSD_Q) the scan runs the whole prefill's
    chunks and hands each call's fp32 final state on as the next one's
    state0, which the kernel rounds to bf16 for its inter term as the
    whole scan does the state entering a chunk: the last logits bit-equal
    to the whole prefill's. Returns the SSD launches of the chunked
    prefill."""
    from repro_torch.models import transformer as T
    cfg = _chunked_cfg("mamba2-2.7b", 0)
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    s, v = SSD_CHUNKED_PROMPT, cfg.vocab_size
    what = f"chunked mamba2-2.7b bf16 (all {cfg.n_layers} layers)"
    toks = torch.from_numpy(np.random.default_rng(32).integers(
        0, cfg.vocab_size, (1, s), dtype=np.int32)).cuda()
    lens = torch.full((1,), s, dtype=torch.int32, device="cuda")

    def whole():
        cache = T.init_cache(cfg, 1, s, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = T.prefill(params, toks, lens, cache, None, cfg)
        torch.cuda.synchronize()
        return lg[:, :v], 1e3 * (time.perf_counter() - t0)

    whole()                                         # warm-up
    ref, t_whole = whole()
    _reset_counts()
    lg, _, ms = _run_chunks(params, cfg, toks, SSD_CHUNKS, s, torch.bfloat16)
    got = _kernel_counts()["ssd"]
    e = rel_err(lg[:, :v], ref)
    check(torch.equal(lg[:, :v], ref), f"{what}: chunks {list(SSD_CHUNKS)}: "
          f"last logits {e} of scale from the unchunked prefill's, not "
          "bit-equal")
    check(got == len(SSD_CHUNKS) * cfg.n_layers,
          f"{what}: {got} ssd_scan launches")
    log(f"{what}, one prompt of {s}: unchunked {t_whole:.2f} ms; chunks "
        f"{list(SSD_CHUNKS)}: {sum(ms):.2f} ms ({[round(t, 2) for t in ms]})"
        f", last logits bit-equal to the unchunked prefill's; {got} "
        f"ssd_scan launches from a state  [{card}]")
    del params
    torch.cuda.empty_cache()
    return got


def phase_chunked(card: str) -> dict:
    """The chunked prefill (``prefill_chunk``) and the long-context prefill
    at published widths, seeded random weights: (1) fp32, chunked against
    unchunked, CHUNKED_RUNS (``_chunked_fp32``), and Qwen3-1.7B's
    long-context batch in fp32 against its solo prefills; (2) bf16,
    Qwen3-1.7B's CHUNKED_PROMPT-token prompt whole and in chunks, then the
    long-context batch and its graphed decode (``_chunked_bf16``); (3)
    bf16 Mamba-2-2.7B in SSD_CHUNKS (``_ssd_chunked_bf16``).
    Returns the launches of the rows ``flash_attention_chunk*`` and
    ``ssd_scan_state*``: each kernel's in the chunked prefills of its
    dtype (kernel 1 Qwen3-1.7B's, kernel 6 Mamba-2-2.7B's)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    launches = {}
    for arch, layers, b, s, seqs in CHUNKED_RUNS:
        t0 = time.perf_counter()
        cfg = _chunked_cfg(arch, layers)
        depth = (f"{layers} of {get_config(arch).n_layers} layers" if layers
                 else f"all {cfg.n_layers} layers")
        params = T.init_params(cfg, seed=0, dtype=torch.float32,
                               device="cuda")
        got = _chunked_fp32(params, cfg, b, s, seqs, depth, card)
        if arch == "qwen3-1.7b":
            launches["flash_attention_chunk_fp32"] = got["flash"]
            _long_context(params, cfg, torch.float32, card)
        if arch == "mamba2-2.7b":
            launches["ssd_scan_state_fp32"] = got["ssd"]
        del params
        torch.cuda.empty_cache()
        log(f"  chunked {arch} fp32 ({depth}): "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["flash_attention_chunk"], lc = _chunked_bf16(card)
    log(f"  chunked and long context qwen3-1.7b bf16: "
        f"{time.perf_counter() - t0:.1f} s; long-context launches {lc}")
    t0 = time.perf_counter()
    launches["ssd_scan_state"] = _ssd_chunked_bf16(card)
    log(f"  chunked mamba2-2.7b bf16: {time.perf_counter() - t0:.1f} s")
    return launches


#: the card-against-CPU train step: arch, the head dim its reduced widths
#: take (one the backward is built for), the kernels its blocks run both
#: ways; batch and sequence (past the reduced 64-key window, so Mixtral's
#: and RecurrentGemma's windowed masks cut; 8 chunks of Mamba-2's reduced
#: 16 rows)
TRAIN_REF = (("qwen3-1.7b", 128, ("flash",)),
             ("mixtral-8x22b", 128, ("flash",)),
             ("llama4-maverick-400b-a17b", 128, ("flash",)),
             ("seamless-m4t-large-v2", 64, ("flash",)),
             ("internvl2-76b", 128, ("flash",)),
             ("mamba2-2.7b", 128, ("ssd",)),
             ("recurrentgemma-2b", RG_D, ("flash", "rglru")))
TRAIN_REF_B, TRAIN_REF_S = 2, 128
#: card-against-CPU gates of the train step: the loss (relative), the grad
#: norm (relative) and every gradient leaf within this share of its own
#: scale max|g| on the CPU (the other card-against-CPU gates' 1e-3)
TRAIN_LOSS_TOL, TRAIN_NORM_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4, 1e-3
#: the same gates for a bf16 step, card against CPU, with the aux loss
#: apart and each gradient leaf's L2 distance over its norm ("l2"): both
#: run the bf16 model, but the card's GEMMs (cuBLAS) and kernels round at
#: other places than the CPU's plain versions (kernel 1 rounds P and dS to
#: bf16, the plain backward does not), and a bf16 gradient carries 2^-9 of
#: each element; a norm's weight (a sum over every token) moves most, so a
#: leaf's max error is gated loosely and its L2 distance tightly. In a MoE
#: model a token's top-k experts can flip where bf16 rounds two router
#: logits apart, which would move whole rows of the experts' gradients:
#: the CPU runs the card's expert choices (``_SharedRoutes``), and the
#: tokens that its own choices would have routed otherwise are counted
TRAIN_BF16_TOL = {"loss": 2e-3, "aux": 1e-2, "norm": 2e-2, "grad": 0.25,
                  "l2": 5e-2}
#: the full-width runs through the training launcher: its arguments,
#: but for the steps
TRAIN_QWEN = ["--arch", "qwen3-1.7b", "--full", "--batch", "8", "--seq",
              "128"]
TRAIN_GRANITE = ["--arch", "granite-3-2b", "--full", "--batch", "8",
                 "--seq", "128"]
#: Mamba-2-2.7B at 4 x 1024 (4 full chunks of 256 a row), RecurrentGemma-2B
#: at the launcher's defaults (8 x 128)
TRAIN_MAMBA = ["--arch", "mamba2-2.7b", "--full", "--batch", "4", "--seq",
               "1024"]
TRAIN_RG = ["--arch", "recurrentgemma-2b", "--full", "--batch", "8",
            "--seq", "128"]
#: steps: the fp32 runs 2 each (a step's time is the second's), the bf16
#: runs, the JAX package's production dtype, 3 each and Qwen3-1.7B's 10
#: (its loss gated by TRAIN_LOSS_DROP)
TRAIN_FP32_STEPS, TRAIN_BF16_STEPS, TRAIN_QWEN_STEPS = 2, 3, 10
#: the loss over Qwen3-1.7B's 10 bf16 steps must fall by at least this much
#: (nats; the first step's loss is about ln(vocab) = 11.9, and the first
#: run on an H100 fell 6.40, to 5.91: the 256-symbol source's order-0
#: entropy is ln 256 = 5.5)
TRAIN_LOSS_DROP = 3.0
#: the first step with 2 microbatches against 1 (tests/test_training.py's
#: tolerances): loss and grad norm, relative
ACCUM_LOSS_TOL, ACCUM_NORM_TOL = 1e-4, 1e-3


def _train_batch(cfg, seed: int, device):
    """A seeded batch of TRAIN_REF_B x TRAIN_REF_S random tokens and
    labels, with the config's stub frontend rows, on ``device``."""
    rng = np.random.default_rng(seed)
    shape = (TRAIN_REF_B, TRAIN_REF_S)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, shape).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, shape).astype(np.int32))}
    fe = _frontend_rows(cfg, TRAIN_REF_B, seed + 1)
    if fe is not None:
        batch["frontend"] = fe
    return {k: v.to(device) for k, v in batch.items()}


def _grad_norm(grads) -> float:
    from repro_torch.training.tree import leaves
    return math.sqrt(sum(float(torch.sum(torch.square(g.float())))
                         for g in leaves(grads)))


def _train_counts() -> dict:
    """Forward and backward launches of the kernels a train step runs."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rglru_scan as RK
    from repro_torch.kernels import ssd_scan as SK
    return {"flash": (FA.launches, FA.bwd_launches),
            "ssd": (SK.launches, SK.bwd_launches),
            "rglru": (RK.launches, RK.bwd_launches)}


class _SharedRoutes:
    """The MoE layers' top-k expert choices made on the card, replayed on
    the CPU: under ``record()`` every ``moe.route_topk`` call (the
    forward's and the remat recompute's, in call order) keeps its
    experts; under ``replay()`` each call takes the next kept choice in
    place of its own, its weights from its own probabilities (renormed as
    ``route_topk`` does), and counts the tokens whose own choice differs.
    Both put ``route_topk`` back on exit."""

    def __init__(self):
        self.kept, self.flipped, self.tokens = [], 0, 0

    @contextlib.contextmanager
    def _patched(self, fn):
        from repro_torch.models import moe as M
        own = M.route_topk
        M.route_topk = lambda logits, k: fn(own, logits, k)
        try:
            yield
        finally:
            M.route_topk = own

    def record(self):
        def keep(own, logits, k):
            w, idx, probs = own(logits, k)
            self.kept.append(idx.cpu())
            return w, idx, probs
        return self._patched(keep)

    def replay(self):
        def take(own, logits, k):
            _, idx, probs = own(logits, k)
            check(bool(self.kept), "shared routes: more router calls on the "
                  "CPU than on the card")
            card = self.kept.pop(0).to(idx.device)
            check(card.shape == idx.shape, f"shared routes: {card.shape} "
                  f"on the card, {idx.shape} on the CPU")
            self.flipped += int((card != idx).any(-1).sum())
            self.tokens += idx.shape[0]
            w = probs.gather(1, card)
            return w / w.sum(-1, keepdim=True).clamp(min=1e-9), card, probs
        return self._patched(take)

    def note(self) -> str:
        if not self.tokens:
            return ""
        return (f"the CPU on the card's expert choices (its own would have "
                f"routed {self.flipped} of {self.tokens} token-calls "
                f"otherwise); ")


def _train_reference(card: str, dtype=torch.float32) -> dict:
    """TRAIN_REF at reduced widths and depth with their own heads, in
    ``dtype``, remat on: ``compute_grads`` on the card (kernels 1, 6 and 7
    forward and backward) against the CPU (plain versions), params from
    the port's seeded init on the card, copied to the CPU; fp32 within
    TRAIN_*_TOL, bf16 within TRAIN_BF16_TOL, there a MoE model's CPU
    side on the card's expert choices (``_SharedRoutes``). Returns the
    launches (forward, backward) by arch and kernel."""
    from repro_torch.models import transformer as T
    from repro_torch.training.trainer import compute_grads
    from repro_torch.training.tree import leaves_with_paths, checkpoint_key
    launches = {}
    for name, d, kernels in TRAIN_REF:
        cfg = _reduced_heads(name, d)
        if dtype == torch.float32:
            tol = {"loss": TRAIN_LOSS_TOL, "aux": TRAIN_LOSS_TOL,
                   "norm": TRAIN_NORM_TOL, "grad": TRAIN_GRAD_TOL}
        else:
            tol = TRAIN_BF16_TOL
        params = T.init_params(cfg, seed=26, dtype=dtype, device="cuda")
        out, routes = {}, _SharedRoutes()
        for side, p in (("cuda", params), ("cpu", _to_cpu(params))):
            _reset_counts()
            # bf16 only: in fp32 the CPU keeps its own routes
            shared = (contextlib.nullcontext()
                      if not cfg.n_experts or dtype == torch.float32 else
                      routes.record() if side == "cuda" else routes.replay())
            with shared:
                grads, m = compute_grads(p, _train_batch(cfg, 27, side), cfg,
                                         remat=True)
            out[side] = (float(m["loss"]), float(m["aux"]),
                         _grad_norm(grads), grads)
            if side == "cuda":
                torch.cuda.synchronize()
                launches[name] = _train_counts()
        check(not routes.kept, f"train reference {name}: "
              f"{len(routes.kept)} router calls on the card left unused")
        (lc, ac, nc, gc_), (lh, ah, nh, gh) = out["cuda"], out["cpu"]
        check(math.isfinite(lc) and abs(lc - lh) <= tol["loss"] * abs(lh),
              f"train reference {name}: loss {lc} on the card, {lh} on the "
              "CPU")
        check(abs(ac - ah) <= tol["aux"] * max(abs(ah), 1e-3),
              f"train reference {name}: aux {ac} / {ah}")
        check(abs(nc - nh) <= tol["norm"] * nh,
              f"train reference {name}: grad norm {nc} / {nh}")
        worst, worst_l2, n = 0.0, 0.0, 0
        for (path, a), (_, b) in zip(leaves_with_paths(gc_),
                                     leaves_with_paths(gh)):
            check(a.dtype == b.dtype, f"train reference {name}: gradient "
                  f"{checkpoint_key(path)} {a.dtype} / {b.dtype}")
            a, b = a.cpu().float(), b.float()
            scale = b.abs().max().item()
            e = (a - b).abs().max().item()
            l2 = ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
            check(math.isfinite(e) and e <= tol["grad"] * scale + 1e-30
                  and l2 <= tol.get("l2", math.inf),
                  f"train reference {name}: gradient {checkpoint_key(path)}"
                  f" differs by {e} at scale {scale}, {l2} of its norm")
            worst, n = max(worst, e / max(scale, 1e-30)), n + 1
            worst_l2 = max(worst_l2, l2)
        ran = {k: launches[name][k] for k in kernels}
        check(all(f > 0 and b > 0 for f, b in ran.values()),
              f"train reference {name}: launches (forward, backward) {ran}")
        heads = (f"H={cfg.n_heads} K={cfg.n_kv_heads} D={cfg.head_dim}"
                 if cfg.n_heads else f"SSD H={cfg.ssm_n_heads} "
                 f"P={cfg.ssm_head_dim} N={cfg.ssm_state} Q={cfg.ssm_chunk}")
        log(f"train reference {name}: reduced widths, {cfg.n_layers} "
            f"layers, {heads}"
            f"{f' window {cfg.sliding_window}' if cfg.has_mixer('swa') else ''}"
            f", {_dt_name(dtype)}, B={TRAIN_REF_B} S={TRAIN_REF_S}: loss "
            f"{lc:.6f} (CPU {lh:.6f}), aux {ac:.6f}, grad norm {nc:.6f} "
            f"(CPU {nh:.6f}), {n} gradient leaves, worst {worst:.2e} of the "
            f"leaf's scale, {worst_l2:.2e} of its norm (gates {tol}); "
            f"{routes.note()}launches (forward, backward) {ran}"
            f"  [{card}]")
        del params, grads, gc_, gh, out
        torch.cuda.empty_cache()
    return launches


def _checkpoint_roundtrip(params) -> float:
    """Save ``params`` under build/ and load them into their own tree on the
    card: every leaf bit-equal. Returns the seconds it took."""
    from repro_torch.training.checkpoint import load_checkpoint
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.tree import leaves
    path = os.path.join(ROOT, "build", "train_smoke", "qwen3.npz")
    t0 = time.perf_counter()
    save_checkpoint(path, params, step=10)
    restored, step = load_checkpoint(path, params)
    check(step == 10, f"checkpoint step {step}")
    for a, b in zip(leaves(params), leaves(restored)):
        check(a.dtype == b.dtype and bool(torch.equal(a, b)),
              "checkpoint round trip is not bit-equal")
    secs = time.perf_counter() - t0
    size = os.path.getsize(path)
    os.remove(path)
    log(f"  checkpoint: {size / 2**30:.2f} GiB saved and loaded back "
        f"bit-equal in {secs:.1f} s")
    return secs


def _accum_check(card: str, argv) -> tuple:
    """Qwen3-1.7B's first step from the launcher's init (seed 0) on its
    first batch with 2 microbatches, for the launcher's run of ``argv`` to
    be held
    against; then one step with 1 microbatch under torch.profiler (device
    time by kernel kind). Returns the first step's (loss, grad norm)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as launcher
    from repro_torch.models import transformer as T
    from repro_torch.training.trainer import make_train_step
    args = launcher.parse_args(argv)
    cfg = get_config(args.arch)
    raw = next(SyntheticLM(DataConfig(cfg.vocab_size, seq_len=args.seq,
                                      batch_size=args.batch,
                                      n_symbols=256)).batches())
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    params = T.init_params(cfg, seed=args.seed, dtype=torch.float32,
                           device="cuda")
    kw = dict(remat=True, lr=args.lr, warmup=min(20, args.steps // 4 + 1))
    init_fn, step_fn = make_train_step(cfg, accum_steps=2, **kw)
    state = init_fn(params)
    del params
    state, m = step_fn(state, batch)
    first = float(m["loss"]), float(m["grad_norm"])
    _, step1 = make_train_step(cfg, **kw)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step1(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _profile_report(prof, wall, "qwen3-1.7b, one train step (fp32, batch 8 "
                    "x 128, remat)", card)
    return first


def phase_train(card: str) -> dict:
    """Training on the card: (1) the train step against the CPU at reduced
    widths (``_train_reference``); (2) Qwen3-1.7B at full width and depth
    through ``repro_torch.launch.train`` (fp32, AdamW, batch 8 x 128,
    remat, TRAIN_FP32_STEPS): the first step with 2 microbatches equals
    the run's first step, a checkpoint round trip under build/ is
    bit-equal; ms a step, tok/s and peak memory; (3) Granite-3.0-2B
    (kernel 1's D = 64 backward on a path), Mamba-2-2.7B and
    RecurrentGemma-2B at full width and depth, TRAIN_FP32_STEPS each
    (``_train_full``, the last two with one more step profiled); (4)
    bf16: (1) in bf16 (TRAIN_BF16_TOL), then Qwen3-1.7B TRAIN_QWEN_STEPS
    (the loss falls by TRAIN_LOSS_DROP), Granite-3.0-2B, Mamba-2-2.7B and
    RecurrentGemma-2B TRAIN_BF16_STEPS each, every one at full width and
    depth on a bf16 param tree (``_train_full``, Qwen3's and Mamba-2's
    with one more step profiled). Returns the backward rows' launches,
    fp32 and bf16."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as launcher
    ref = _train_reference(card)

    fp32 = ["--steps", str(TRAIN_FP32_STEPS)]
    _reset_counts()
    t0 = time.perf_counter()
    run = launcher.run(launcher.parse_args(TRAIN_QWEN + fp32))
    secs = time.perf_counter() - t0
    qwen = (FA.launches, FA.bwd_launches)
    check(all(math.isfinite(x) for x in run.losses + run.grad_norms),
          f"qwen3-1.7b training: losses {run.losses}")
    check(qwen[1] > 0, "qwen3-1.7b training: no backward launch")
    log(f"train qwen3-1.7b (full width and depth, fp32, AdamW, remat, batch "
        f"8 x 128): losses {[round(x, 4) for x in run.losses]}; grad norms "
        f"{[round(x, 3) for x in run.grad_norms]}; "
        f"{statistics.median(run.step_ms[1:]):.1f} ms a step (the first "
        f"{run.step_ms[0]:.1f}), {run.tok_s:,.0f} tok/s, peak allocated "
        f"{run.peak_bytes / 2**30:.2f} GiB; kernel 1 {qwen[0]} forward and "
        f"{qwen[1]} backward launches; {secs:.1f} s  [{card}]")
    _checkpoint_roundtrip(run.state.params)
    first = (run.losses[0], run.grad_norms[0])
    del run
    gc.collect()
    torch.cuda.empty_cache()
    acc = _accum_check(card, TRAIN_QWEN + fp32)
    check(abs(acc[0] - first[0]) <= ACCUM_LOSS_TOL * abs(first[0])
          and abs(acc[1] - first[1]) <= ACCUM_NORM_TOL * abs(first[1]),
          f"accumulation: 2 microbatches {acc}, 1 {first}")
    log(f"  accumulation: first step with 2 microbatches loss {acc[0]:.6f} "
        f"grad norm {acc[1]:.6f}, with 1 {first[0]:.6f} / {first[1]:.6f} "
        f"(rel {abs(acc[0] - first[0]) / first[0]:.2e} / "
        f"{abs(acc[1] - first[1]) / first[1]:.2e})")
    gc.collect()
    torch.cuda.empty_cache()

    granite = _train_full(TRAIN_GRANITE + fp32, ("flash",), card,
                          profile=False)
    mamba = _train_full(TRAIN_MAMBA + fp32, ("ssd",), card)
    rg = _train_full(TRAIN_RG + fp32, ("rglru", "flash"), card)

    # (4) bf16: the card against the CPU at reduced widths, then every
    # full-width run again on a bf16 param tree
    ref16 = _train_reference(card, torch.bfloat16)
    bf16 = ["--steps", str(TRAIN_BF16_STEPS)]
    qwen16 = _train_full(TRAIN_QWEN + ["--steps", str(TRAIN_QWEN_STEPS)],
                         ("flash",), card, torch.bfloat16,
                         drop=TRAIN_LOSS_DROP)
    granite16 = _train_full(TRAIN_GRANITE + bf16, ("flash",), card,
                            torch.bfloat16, profile=False)
    mamba16 = _train_full(TRAIN_MAMBA + bf16, ("ssd",), card, torch.bfloat16)
    rg16 = _train_full(TRAIN_RG + bf16, ("rglru", "flash"), card,
                       torch.bfloat16, profile=False)
    return {"flash_attention_lse_fp32": qwen[0],
            "flash_attention_bwd": qwen[1],
            "flash_attention_bwd_s2048": qwen[1],
            "flash_attention_bwd_mixtral": ref["mixtral-8x22b"]["flash"][1],
            "flash_attention_bwd_d64": granite["flash"][1],
            "flash_attention_bwd_cross":
                ref["seamless-m4t-large-v2"]["flash"][1],
            "flash_attention_bwd_d256": rg["flash"][1],
            "ssd_scan_bwd": mamba["ssd"][1],
            "ssd_scan_bwd_state": mamba["ssd"][1],
            "rglru_scan_bwd": rg["rglru"][1],
            "flash_attention_bwd_bf16": qwen16["flash"][1],
            "flash_attention_bwd_s2048_bf16": qwen16["flash"][1],
            "flash_attention_bwd_mixtral_bf16":
                ref16["mixtral-8x22b"]["flash"][1],
            "flash_attention_bwd_d64_bf16": granite16["flash"][1],
            "flash_attention_bwd_cross_bf16":
                ref16["seamless-m4t-large-v2"]["flash"][1],
            "flash_attention_bwd_d256_bf16": rg16["flash"][1],
            "ssd_scan_bwd_bf16": mamba16["ssd"][1],
            "ssd_scan_bwd_state_bf16": mamba16["ssd"][1]}


def _train_full(argv, kernels, card: str, dtype=torch.float32,
                profile: bool = True, drop: float = 0.0) -> dict:
    """One launcher run at full width and depth (``argv``) on a ``dtype``
    param tree (``run``'s ``param_dtype``; the command line trains in
    fp32, as the JAX launcher does): every loss and grad norm finite,
    each of ``kernels`` launched forward and backward, the loss falling
    by more than ``drop`` where given; logs ms a step, tok/s and peak
    memory; with ``profile`` one more step from the run's state under
    torch.profiler (device time by kernel kind). Returns the launches
    (forward, backward) by kernel of the run."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as launcher
    from repro_torch.training.trainer import make_train_step
    _reset_counts()
    t0 = time.perf_counter()
    args = launcher.parse_args(argv)
    run = launcher.run(args, param_dtype=dtype)
    secs = time.perf_counter() - t0
    counts = _train_counts()
    ran = {k: counts[k] for k in kernels}
    check(all(math.isfinite(x) for x in run.losses + run.grad_norms)
          and all(f > 0 and b > 0 for f, b in ran.values()),
          f"{args.arch} {_dt_name(dtype)} training: losses {run.losses}, "
          f"grad norms {run.grad_norms}, launches (forward, backward) {ran}")
    fell = run.losses[0] - run.losses[-1]
    check(not drop or fell > drop, f"{args.arch} {_dt_name(dtype)} "
          f"training: the loss fell {fell} over {len(run.losses)} steps "
          f"(gate {drop})")
    what = ("bf16 params, fp32 moments" if dtype == torch.bfloat16
            else "fp32")
    log(f"train {args.arch} (full width and depth, {what}, AdamW, remat, "
        f"batch {args.batch} x {args.seq}): losses "
        f"{[round(x, 4) for x in run.losses]}"
        f"{f', fell {fell:.4f} (gate {drop})' if drop else ''}; grad norms "
        f"{[round(x, 3) for x in run.grad_norms]}; "
        f"{statistics.median(run.step_ms[1:]):.1f} ms a step (the first "
        f"{run.step_ms[0]:.1f}), {run.tok_s:,.0f} tok/s, peak allocated "
        f"{run.peak_bytes / 2**30:.2f} GiB; launches (forward, backward) "
        f"{ran}; {secs:.1f} s  [{card}]")
    if profile:
        cfg = get_config(args.arch)
        raw = next(SyntheticLM(DataConfig(cfg.vocab_size, seq_len=args.seq,
                                          batch_size=args.batch,
                                          n_symbols=256)).batches())
        batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
        _, step = make_train_step(cfg, remat=True, lr=args.lr,
                                  warmup=min(20, args.steps // 4 + 1))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            step(run.state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        _profile_report(prof, wall, f"{args.arch}, one train step "
                        f"({_dt_name(dtype)}, batch {args.batch} x "
                        f"{args.seq}, remat)", card)
        del prof, batch
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# dryrun: the dry-run matrix on the meta device, and the roofline counter
# against measured steps on the card
# ---------------------------------------------------------------------------

#: the roofline share's gate: the counted work's least time at the card's
#: peaks over the measured step may not pass the step's own time by more
#: than the timing's spread
SHARE_LIMIT = 1.05
#: the decode step's 8 slots: their context lengths, 1 to MAX_LEN
DRYRUN_CONTEXTS = (1, 143, 286, 429, 572, 715, 858, 1000)
#: the dry-run's predicted peak (the meta trace's, beyond its arguments)
#: against the card's (max_memory_allocated beyond what was allocated
#: before the step): relative, and at least this many bytes (the first
#: card run read 192 B apart of 82.04 MiB for the prefill and 764 B of
#: 10.68 MiB for the decode step: the allocator's 512-byte rounding)
PEAK_TOL, PEAK_SLACK = 0.01, 1 << 20
DRYRUN_REPS = 10


#: the dry-run matrix's processes: the host's cores but two, left to the
#: sharded phase's ranks, which run on the card meanwhile
DRYRUN_JOBS = max(1, min(8, (os.cpu_count() or 1) - 2))


def _dryrun_matrix_start():
    """Start (a), every registered config x input shape on the 16x16 mesh
    traced on the meta device (launch/dryrun.py, DRYRUN_JOBS processes),
    in the background on the host's CPU: (a, its start, its log)."""
    path = os.path.join(ROOT, "build", "torch_dryrun.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    log_path = path + ".log"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--force",
             "--jobs", str(DRYRUN_JOBS), "--results", path], env=env,
            stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter(), log_path


def _dryrun_matrix(card: str, started) -> int:
    """(a)'s end: its rows checked, its output printed."""
    proc, t, log_path = started
    rc = proc.wait()
    with open(log_path) as f:
        text = f.read()
    print(text, end="", flush=True)
    check(rc == 0, f"dry-run matrix: exit {rc}: {text[-3000:]}")
    with open(os.path.join(ROOT, "build", "torch_dryrun.json")) as f:
        rows = json.load(f)
    check(len(rows) == 44 and all(r["mesh"] == "16x16" for r in rows),
          f"dry-run matrix: {len(rows)} rows")
    granite = next(r for r in rows if (r["arch"], r["shape"])
                   == ("granite-3-2b", "decode_32k"))
    check(granite["memory"]["resident_gb"] < 16.0,
          f"granite decode_32k resident {granite['memory']['resident_gb']}")
    log(f"dryrun (a): {len(rows)} combinations on 16x16 traced on the meta "
        f"device (each the whole step and rank 0's local step) in "
        f"{time.perf_counter() - t:.1f} s with {DRYRUN_JOBS} processes, "
        f"no failure (host CPU, beside the sharded phase on the card)")
    return len(rows)


def _count(fn, args):
    from repro_torch.launch.roofline import Counter
    with torch.no_grad(), Counter() as c:
        fn(*args)
    return c


def _outside(rep) -> tuple:
    """(FLOPs, bytes, dots) of a report outside its kernels."""
    return (rep.flops - rep.kernel_flops, rep.hbm_bytes - rep.kernel_bytes,
            rep.dots)


def _measured_step(name, fn, args, meta_args, kernel, card: str) -> dict:
    """(b) one step on the card: its median card ms over CUDA events, its
    counted work on the card and on the meta device, the roofline share,
    and the dry-run's predicted peak against the card's."""
    from repro_torch.launch.perf import step_ms
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    with torch.no_grad():
        ms = statistics.median(step_ms(lambda: fn(*args), DRYRUN_REPS))
    n0 = FA.launches + DA.launches
    on_card = _count(fn, args)
    torch.cuda.synchronize()
    rep = on_card.report
    launched = FA.launches + DA.launches - n0
    k = rep.kernels[kernel]
    check(launched == k["launches"] == 28 and list(rep.kernels) == [kernel],
          f"dryrun {name}: {launched} launches, counted {rep.kernels}")
    meta = _count(fn, meta_args)
    mrep = meta.report
    check(_outside(rep) == _outside(mrep),
          f"dryrun {name}: outside the kernels card {_outside(rep)} != meta "
          f"{_outside(mrep)}")
    mk = mrep.kernels[kernel]
    same = (mk["operations"], mk["bytes"]) == (k["operations"], k["bytes"])
    check(mk["launches"] == k["launches"]
          and (same if kernel == "flash_attention"
               else mk["operations"] >= k["operations"]),
          f"dryrun {name}: kernel charge card {k} meta {mk}")
    terms = rep.terms()
    roof = rep.roofline_s() * 1e3
    share = roof / ms
    check(0 < share <= SHARE_LIMIT,
          f"dryrun {name}: roofline share {share} (roofline {roof} ms, "
          f"measured {ms} ms)")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    pred = meta.peak_bytes
    check(abs(pred - peak) <= max(PEAK_TOL * peak, PEAK_SLACK),
          f"dryrun {name}: predicted peak {pred} B, card {peak} B")
    log(f"dryrun (b) {name}: {ms:.3f} ms measured (median of {DRYRUN_REPS} "
        f"CUDA-event timings, outside the counter); counted "
        f"{rep.flops / 1e9:.2f} GFLOP ({k['operations'] / 1e9:.3f} in "
        f"{k['launches']} {kernel} launches), {rep.hbm_bytes / 1e9:.3f} GB "
        f"({k['bytes'] / 1e9:.4f} in the kernel), {rep.dots} products "
        f"outside it; roofline {roof:.4f} ms (compute "
        f"{terms['compute_s'] * 1e3:.4f}, memory {terms['memory_s'] * 1e3:.4f}"
        f", {rep.dominant()}), share {share:.4f}; peak beyond the arguments "
        f"predicted {pred / 2**20:.2f} MiB, card {peak / 2**20:.2f} MiB; on "
        f"{card}")
    log(f"dryrun (b) {name}: the meta trace's counts equal the card's "
        f"outside the kernel; its {kernel} charge "
        f"{mk['operations'] / 1e9:.4f} GFLOP, {mk['bytes'] / 1e9:.4f} GB "
        f"({'equal' if same else 'every cache row'}); on {card}")
    return dict(ms=ms, roofline_ms=roof, share=share, flops=rep.flops,
                bytes=rep.hbm_bytes, peak_pred=pred, peak_card=peak)


def phase_dryrun(card: str, matrix) -> dict:
    """The dry-run matrix (a) (started by ``_dryrun_matrix_start``), then
    Qwen3-1.7B at full width in bf16 on the card (b): prefill of one
    1000-token prompt (kernel 1) and a decode step over 8 slots of a dense
    cache of 1000 rows at contexts 1-1000 (kernel 4), each against the
    roofline counter on the card and on the meta device."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    out = {"matrix": _dryrun_matrix(card, matrix)}
    cfg = get_config("qwen3-1.7b")
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(28)
    params = T.init_params(cfg, seed=28, dtype=dt, device="cuda")
    mparams = T.init_params(cfg, dtype=dt, device="meta")

    def meta_like(*ts):
        return tuple(torch.empty_like(t, device="meta") for t in ts)

    def prefill(p, c, t, n):
        return T.prefill(p, t, n, c, None, cfg)

    def decode(p, c, t, q):
        return T.decode_step(p, c, t, q, cfg)

    toks = torch.randint(0, cfg.vocab_size, (1, MAX_LEN), generator=gen,
                         device="cuda", dtype=torch.int32)
    lens = torch.full((1,), MAX_LEN, dtype=torch.int32, device="cuda")
    cache = T.init_cache(cfg, 1, MAX_LEN, dt, "cuda")
    mcache = T.init_cache(cfg, 1, MAX_LEN, dt, "meta")
    out["prefill"] = _measured_step(
        "prefill B=1 S=1000", prefill, (params, cache, toks, lens),
        (mparams, mcache, *meta_like(toks, lens)), "flash_attention", card)
    del cache, mcache
    b = len(DRYRUN_CONTEXTS)
    cache = T.init_cache(cfg, b, MAX_LEN, dt, "cuda")
    for leaf in cache["blocks"]:
        for t in leaf.values():
            t.normal_(generator=gen)
    mcache = T.init_cache(cfg, b, MAX_LEN, dt, "meta")
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    pos = torch.tensor([c - 1 for c in DRYRUN_CONTEXTS], dtype=torch.int32,
                       device="cuda")
    out["decode"] = _measured_step(
        f"decode_step {b} slots contexts {DRYRUN_CONTEXTS}", decode,
        (params, cache, tok, pos), (mparams, mcache, *meta_like(tok, pos)),
        "decode_attention", card)
    return out


# ---------------------------------------------------------------------------
# sharded: the tensor-parallel runtime over gloo ranks that share the card
# ---------------------------------------------------------------------------

#: the sharded phase's gate against the unsharded port on the card, of
#: the logits' scale: the JAX sharded script's bound
TP_TOL = 5e-3
#: the sharded train step against the unsharded one: loss and grad norm
#: relative, params of each leaf's scale
TP_TRAIN_TOL, TP_PARAM_TOL = 1e-4, 1e-5
#: (a)'s batch and prompt, then TP_DECODE teacher-forced decode steps
TP_B, TP_S, TP_S0, TP_DECODE = 2, 128, 120, 4


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def _tp_cfg(name: str, small: bool, **fields):
    """The config at full width (``fields`` cut its depth), or at the
    reduced widths with its own structure (``small``: the CPU rehearsal of
    this phase)."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if small:
        heads = min(cfg.n_heads, 4)
        cfg = cfg.reduced(n_heads=heads, n_kv_heads=min(cfg.n_kv_heads, 2)
                          if cfg.n_kv_heads > 1 else cfg.n_kv_heads)
    return dataclasses.replace(cfg, **fields)


def _tp_launches():
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rglru_scan as RK
    from repro_torch.kernels import ssd_scan as SK
    return {"flash": FA.launches, "decode": DA.launches, "ssd": SK.launches,
            "rglru": RK.launches}


def _tp_drive(params, cfg, toks, lens, max_len, dtype, device, rows: int,
              s0: int, policy=None, forward=True):
    """forward (optional), prefill of the first ``lens`` tokens of each row
    (padded to ``s0``, the longest of every rank's rows) and TP_DECODE
    teacher-forced decode steps, with ``policy`` (``toks`` and ``lens``
    this rank's rows of ``rows``) or without: the logits of each, on the
    card."""
    from repro_torch.models import transformer as T
    out = {}
    with torch.no_grad():
        if forward:
            out["forward"], _ = T.forward(params, toks, cfg, policy=policy)
        cache = T.init_cache(cfg, rows, max_len, dtype, device,
                             policy=policy)
        out["prefill"], cache = T.prefill(params, toks[:, :s0], lens, cache,
                                          None, cfg, policy=policy)
        pos = lens.clone()
        for i in range(TP_DECODE):
            tok = toks.gather(1, (pos[:, None] % toks.shape[1]).long())
            out[f"decode{i}"], cache = T.decode_step(
                params, cache, tok, pos, cfg, policy=policy)
            pos = pos + 1
    return out


def _tp_gathered(out, policy, mesh):
    """Each output's logits, gathered over the mesh."""
    from repro_torch.models import sharding as SH
    bax = policy.data_axes if policy.shard_batch else None
    voc = policy.model_axis if policy.shard_vocab else None
    return {k: SH.gather_leaf(v, SH.Spec(bax, None, voc) if v.dim() == 3
                              else SH.Spec(bax, voc), mesh)
            for k, v in out.items()}


def _tp_err(got, want, vocab: int) -> dict:
    """Per output: (max abs error, the unsharded logits' scale over the
    ``vocab`` real entries: the padded tail holds -1e30 on both sides)."""
    return {k: (float((got[k].float() - want[k].float()).abs().max()),
                max(float(want[k][..., :vocab].float().abs().max()), 1.0))
            for k in want}


def _tp_bytes(cfg, policy, mesh, params, dtype) -> tuple:
    """(this rank's parameter bytes, ``sharded_resident_gb``'s count)."""
    from repro_torch.launch.specs import sharded_resident_gb
    from repro_torch.models import transformer as T
    from repro_torch.training.tree import leaves
    full = T.init_params(cfg, dtype=dtype, device="meta")
    mine = sum(t.numel() * t.element_size() for t in leaves(params))
    return mine, sharded_resident_gb(full, T.param_specs(cfg, policy),
                                     mesh) * 2**30


def _tp_model(mesh, name, cfg, dtype, toks, lens, max_len, seed,
              forward=True, **policy_kw):
    """One model on this rank's shards: init leaf by leaf, the main path
    (forward, prefill, decode) with the counters reset just before it and
    read just after. Returns (this rank's row, the gathered logits)."""
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    rows = toks.shape[0]
    policy = SH.make_policy(cfg, mesh, global_batch=rows, **policy_kw)
    dev = mesh.device
    params = T.init_params(cfg, seed=seed, dtype=dtype, device=dev,
                           policy=policy)
    mine, resident = _tp_bytes(cfg, policy, mesh, params, dtype)
    bax = policy.data_axes if policy.shard_batch else None
    ltoks = SH.shard_leaf(toks.to(dev), SH.Spec(bax), mesh).contiguous()
    llens = SH.shard_leaf(lens.to(dev), SH.Spec(bax), mesh).contiguous()
    _reset_counts()
    SH.COLLECTIVES.reset()
    _sync(dev)
    t0 = time.perf_counter()
    out = _tp_drive(params, cfg, ltoks, llens, max_len, dtype, dev, rows,
                    int(lens.max()), policy, forward)
    _sync(dev)
    secs = time.perf_counter() - t0
    row = {"rank": mesh.rank, "what": name, "launches": _tp_launches(),
           "gated": dtype == torch.float32,
           "collectives": SH.COLLECTIVES.read(), "seconds": secs,
           "param_bytes": mine, "resident_bytes": resident,
           "policy": {k: getattr(policy, k) for k in (
               "shard_heads", "shard_kv_heads", "seq_parallel_decode",
               "shard_experts", "shard_vocab", "shard_batch")}}
    got = _tp_gathered(out, policy, mesh)
    del params, out
    _sync(dev)
    return row, got


def _tp_reference(cfg, dtype, toks, lens, max_len, seed, dev,
                  forward=True):
    """The unsharded port on ``dev``, rank 0's card."""
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, seed=seed, dtype=dtype, device=dev)
    out = _tp_drive(params, cfg, toks.to(dev), lens.to(dev), max_len, dtype,
                    dev, toks.shape[0], int(lens.max()), None, forward)
    del params
    _sync(dev)
    return out


def _tp_case(mesh, name, cfg, dtype, toks, lens, max_len, seed, *, refs,
             forward=True, **policy_kw):
    """:func:`_tp_model`, and on rank 0 its error against ``refs[key]``
    (computed once per (config, dtype) and kept)."""
    row, got = _tp_model(mesh, name, cfg, dtype, toks, lens, max_len, seed,
                         forward, **policy_kw)
    if mesh.rank == 0:
        key = (cfg.name, cfg.n_layers, dtype)
        if key not in refs:
            refs[key] = _tp_reference(cfg, dtype, toks, lens, max_len, seed,
                                      mesh.device, forward)
        row["errors"] = _tp_err(got, refs[key], cfg.vocab_size)
    del got
    _sync(mesh.device)
    return row


def _tp_first(mesh, small: bool = False) -> list:
    """(a) Qwen3-1.7B full width and depth on 1 x 2, fp32 then bf16; (b)
    RecurrentGemma-2B one (R, R, L) repeat and Mamba-2-2.7B at depth 2 on
    1 x 2, fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, refs = [], {}
    qwen = _tp_cfg("qwen3-1.7b", small)
    gen = torch.Generator().manual_seed(31)
    toks = torch.randint(0, qwen.vocab_size, (TP_B, TP_S), generator=gen,
                         dtype=torch.int32)
    lens = torch.full((TP_B,), TP_S0, dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        rows.append(_tp_case(mesh, f"(a) qwen3-1.7b {_dt_name(dt)}", qwen,
                             dt, toks, lens, TP_S, 31, refs=refs))
        refs.clear()
    rg = _tp_cfg("recurrentgemma-2b", small, n_layers=3, pattern_tail=())
    lens = [100, 50] if small else [2100, 1100]
    toks, lens = _prompt_batch(rg, lens, seed=32)
    rows.append(_tp_case(mesh, "(b) recurrentgemma-2b (R, R, L) fp32", rg,
                         torch.float32, toks, lens,
                         toks.shape[1] + TP_DECODE, 32, refs=refs,
                         forward=False))
    refs.clear()
    mamba = _tp_cfg("mamba2-2.7b", small, n_layers=2)
    toks, lens = _prompt_batch(mamba, [256, 200], seed=33)
    rows.append(_tp_case(mesh, "(b) mamba2-2.7b depth 2 fp32", mamba,
                         torch.float32, toks, lens, 256 + TP_DECODE, 33,
                         refs=refs))
    return rows


def _tp_train(mesh, cfg, seed: int) -> dict:
    """(d) one fp32 train step of ``cfg`` with FSDP on this rank's shards
    (AdamW, eps 1e-3 as the CPU test's), the gathered params, loss and grad
    norm; rank 0 then the unsharded step and the errors."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.training.trainer import make_train_step
    from repro_torch.training.tree import leaves
    b, s = 4, 128
    gen = torch.Generator().manual_seed(seed)
    batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                              dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
    kw = dict(optimizer="adamw", eps=1e-3, lr=1e-3, warmup=1, remat=True)
    policy = SH.make_policy(cfg, mesh, global_batch=b, fsdp=True)
    specs = T.param_specs(cfg, policy)
    dev = mesh.device
    params = T.init_params(cfg, seed=seed, dtype=torch.float32, device=dev,
                           policy=policy)
    mine, resident = _tp_bytes(cfg, policy, mesh, params, torch.float32)
    local = {k: SH.shard_leaf(v.to(dev), SH.Spec(policy.data_axes),
                              mesh).contiguous() for k, v in batch.items()}
    init_fn, step_fn = make_train_step(cfg, policy, **kw)
    state = init_fn(params)
    del params
    _reset_counts()
    SH.COLLECTIVES.reset()
    _sync(dev)
    t0 = time.perf_counter()
    state, m = step_fn(state, local)
    _sync(dev)
    row = {"rank": mesh.rank, "what": f"(d) qwen3-1.7b depth "
           f"{cfg.n_layers} train step fp32, FSDP",
           "launches": _tp_launches(),
           "bwd_flash": FA.bwd_launches,
           "collectives": SH.COLLECTIVES.read(),
           "seconds": time.perf_counter() - t0, "param_bytes": mine,
           "resident_bytes": resident}
    got = SH.gather_tree(state.params, specs, mesh, cfg)
    metrics = {k: float(m[k]) for k in ("loss", "grad_norm")}
    del state
    _sync(dev)
    if mesh.rank == 0:
        init_fn, step_fn = make_train_step(cfg, **kw)
        ref = init_fn(T.init_params(cfg, seed=seed, dtype=torch.float32,
                                    device=dev))
        ref, rm = step_fn(ref, {k: v.to(dev) for k, v in batch.items()})
        worst = max(float((a - b_).abs().max())
                    / max(float(b_.abs().max()), 1e-30)
                    for a, b_ in zip(leaves(got), leaves(ref.params)))
        row["errors"] = {k: (abs(metrics[k] - float(rm[k])),
                             abs(float(rm[k]))) for k in metrics}
        row["param_err"] = worst
        del ref
    del got
    _sync(dev)
    return row


def _tp_second(mesh, small: bool = False) -> list:
    """(c) Mixtral-8x22B at full width, one pattern repeat, on 2 x 2, fp32
    with capacity factor 8: token-parallel, then 2D expert weights; (d)
    the train step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mix = _tp_cfg("mixtral-8x22b", small, n_layers=1,
                  moe_capacity_factor=8.0)
    gen = torch.Generator().manual_seed(34)
    toks = torch.randint(0, mix.vocab_size, (4, 64), generator=gen,
                         dtype=torch.int32)
    lens = torch.tensor([60, 60, 48, 30], dtype=torch.int32)
    refs, rows = {}, []
    rows.append(_tp_case(mesh, "(c) mixtral-8x22b token-parallel fp32", mix,
                         torch.float32, toks, lens, 64 + TP_DECODE, 34,
                         refs=refs))
    rows.append(_tp_case(mesh, "(c) mixtral-8x22b 2D weights fp32", mix,
                         torch.float32, toks, lens, 64 + TP_DECODE, 34,
                         refs=refs, moe_2d_weights=True))
    refs.clear()
    rows.append(_tp_train(mesh, _tp_cfg("qwen3-1.7b", small, n_layers=2),
                          35))
    return rows


#: what each part must launch on every rank
TP_NEEDS = {"(a)": ("flash", "decode"), "(b) recurrentgemma": ("flash",
                                                                "rglru"),
            "(b) mamba2": ("ssd",), "(c)": ("flash", "decode"),
            "(d)": ("flash",)}


def phase_sharded(card: str, device: str = "cuda:0",
                  small: bool = False) -> None:
    """Tensor parallelism on the card (ROADMAP §1 item 8d): ranks spawned on
    cuda:0 over gloo (``launch/mesh.run_on_mesh``; the library was built
    by this process before), (a) and (b) on 1 x 2, (c) and (d) on 2 x 2,
    each against the unsharded port on the card (rank 0): logits within
    TP_TOL of their scale (fp32; bf16 printed), the train step within
    TP_TRAIN_TOL / TP_PARAM_TOL; each rank's parameter bytes equal to
    ``sharded_resident_gb``, its kernel launches (1 and 4 in (a), 1 and 7
    in RecurrentGemma, 6 in Mamba-2, 1 forward and backward in (d)) and
    its collective bytes printed. gloo stages every collective through the
    host: these times are no measure of tensor-parallel speed. ``device``
    and ``small`` (reduced widths): the phase's rehearsal on the CPU."""
    from repro_torch.launch.mesh import mesh_shape, run_on_mesh
    t0 = time.perf_counter()
    rows = []
    for fn, shape in ((_tp_first, (1, 2)), (_tp_second, (2, 2))):
        n = shape[0] * shape[1]
        for ranks in zip(*run_on_mesh(fn, mesh_shape(shape), small,
                                      devices=[device] * n, timeout=600)):
            rows.extend(ranks)
    for r in rows:
        need = next(v for k, v in TP_NEEDS.items() if r["what"].startswith(k))
        ran = r["launches"]
        # a wrapper counts the launches of its kernel, which runs on a card
        check(torch.device(device).type != "cuda"
              or all(ran[k] > 0 for k in need),
              f"sharded {r['what']} rank {r['rank']}: launches {ran}")
        check(r["param_bytes"] == r["resident_bytes"],
              f"sharded {r['what']} rank {r['rank']}: {r['param_bytes']} B "
              f"of params, sharded_resident_gb {r['resident_bytes']} B")
        coll = r["collectives"]
        bwd = (f", flash backward {r['bwd_flash']}" if "bwd_flash" in r
               else "")
        log(f"sharded {r['what']} rank {r['rank']}: params "
            f"{r['param_bytes'] / 2**30:.3f} GiB (sharded_resident_gb "
            f"{r['resident_bytes'] / 2**30:.3f}); launches {ran}"
            f"{bwd}; "
            f"collectives {coll['count']} "
            f"{ {k: f'{v / 2**20:.1f} MiB' for k, v in coll['bytes'].items()} }"
            f", staged through the host {coll['staged_copies']} copies "
            f"{coll['staged_bytes'] / 2**20:.1f} MiB; main path "
            f"{r['seconds']:.2f} s (gloo, host-staged: not TP speed)  "
            f"[{card}]")
        if "errors" not in r:
            continue
        if r["what"].startswith("(d)"):
            for k, (e, sc) in r["errors"].items():
                check(e <= TP_TRAIN_TOL * sc,
                      f"sharded {r['what']}: {k} off by {e} of {sc}")
            check(r["param_err"] <= TP_PARAM_TOL,
                  f"sharded {r['what']}: params off by {r['param_err']}")
            log(f"sharded {r['what']}: loss and grad norm against the "
                f"unsharded step {r['errors']}, params within "
                f"{r['param_err']:.2e} of each leaf's scale (gates "
                f"{TP_TRAIN_TOL}, {TP_PARAM_TOL})")
            continue
        worst = max(e / sc for e, sc in r["errors"].values())
        if r["gated"]:
            check(worst <= TP_TOL, f"sharded {r['what']}: logits off by "
                  f"{r['errors']}")
        check(math.isfinite(worst), f"sharded {r['what']}: {r['errors']}")
        gate = f"(gate {TP_TOL})" if r["gated"] else "(printed)"
        log(f"sharded {r['what']}: against the unsharded port on the card, "
            f"worst {worst:.2e} of the logits' scale {gate}"
            f": { {k: f'{e:.3g} of {sc:.3g}' for k, (e, sc) in r['errors'].items()} }")
    log(f"sharded: {time.perf_counter() - t0:.1f} s, {len(rows)} rank rows")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the model phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        # servers sit in reference cycles: collect them, so that each
        # phase starts with only what the script still holds on the card
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase {name}: {time.perf_counter() - t:.1f} s "
            f"(total {time.perf_counter() - t0:.1f} s), "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB left "
            "allocated")
        return out

    card = phase_card()
    timed("build", phase_build)
    timer = Timer()
    rows = timed("kernels", phase_kernels, timer)
    rows += timed("ssd kernel", phase_ssd, timer)
    rows.append(timed("rglru kernel", phase_rglru, timer))
    rows += timed("attention D=256", phase_attention_d256, timer)
    rows += timed("attention MoE shapes", phase_attention_moe, timer)
    d64_rows, d64_dense = timed("attention D=64", phase_attention_d64, timer)
    rows += d64_rows
    rows += timed("chunked kernels", phase_chunked_kernels, timer)
    rows += timed("train kernels", phase_train_kernels, timer)
    colocated = timed("colocated", phase_colocated, timer)
    if args.kernels_only:
        return 0
    timed("reference", phase_reference)
    timed("mamba reference", phase_mamba_reference)
    rg_ref = timed("recurrentgemma reference", phase_rg_reference)
    moe_ref = timed("moe reference", phase_moe_reference, card)
    arch_ref = timed("archs reference", phase_archs_reference, card)
    launches, serve_tps, buckets, serve_streams = timed(
        "serve", phase_serve, card)
    timed("chip", phase_chip, card, serve_streams, serve_tps)
    timed("graphs", phase_graphs, card, buckets)
    replay = timed("replay", phase_replay, card)
    ssd = timed("mamba", phase_mamba, card)
    rg = timed("recurrentgemma", phase_recurrentgemma, card)
    timed("sharing", phase_sharing, card, timer)
    timed("tenants", phase_tenants, card)
    timed("sim", phase_sim, card)
    moe = timed("moe", phase_moe, card, timer)
    granite = timed("granite", phase_granite, card)
    seamless = timed("seamless", phase_seamless, card)
    timed("internvl", phase_internvl, card)
    chunked = timed("chunked", phase_chunked, card)
    train = timed("train", phase_train, card)
    # the dry-run matrix traces on the host's cores while the sharded
    # phase runs on the card; the dry-run's card steps (b) come after
    matrix = _dryrun_matrix_start()
    timed("sharded", phase_sharded, card)
    timed("dryrun", phase_dryrun, card, matrix)
    # each kernel's launches on a path that runs its body: in bf16 the serve
    # phase's fused run (flash, paged decode, the paged fused kernel) and
    # its dense-cache run (dense decode), the bf16 colocated sweep (the
    # dense fused kernel, which no serving path runs) and the RecurrentGemma
    # run (the RG-LRU scan, and kernels 1 and 4 at D = 256); in fp32 the
    # chaos replay (flash, dense decode, the paged fused kernel), the fp32
    # colocated sweep and the RecurrentGemma reference (kernels 1 and 4 at
    # D = 256); the SSD scan from the Mamba-2 replays, the wall-clock one
    # in bf16 and the virtual-clock one in fp32; the rows of the MoE and
    # Qwen1.5 shapes from the moe phase's serves in bf16 (Llama-4 Maverick
    # fused, Mixtral on its ring, Qwen1.5-4B) and its fp32 reference; the
    # chunked rows from the chunked phase's chunked prefills (kernel 1
    # Qwen3-1.7B's, kernel 6 Mamba-2-2.7B's, each dtype its own run)
    launches = {**launches, "bullet_attention": colocated[torch.bfloat16],
                "ssd_scan": ssd["bf16"], "ssd_scan_fp32": ssd["fp32"],
                "rglru_scan": rg["rglru_scan"],
                "flash_attention_d256": rg["flash_attention"],
                "decode_attention_d256": rg["decode_attention"],
                "flash_attention_fp32": replay["flash_attention"],
                "decode_attention_fp32": replay["decode_attention"],
                "paged_decode_attention_fp32":
                    replay["paged_decode_attention"],
                "bullet_attention_paged_fp32":
                    replay["bullet_attention_paged"],
                "bullet_attention_fp32": colocated[torch.float32],
                "flash_attention_d256_fp32": rg_ref["flash_attention"],
                "decode_attention_d256_fp32": rg_ref["decode_attention"],
                **moe_ref, **moe, **arch_ref, **granite, **seamless,
                **chunked, **train,
                "bullet_attention_d64": d64_dense[torch.bfloat16],
                "bullet_attention_d64_fp32": d64_dense[torch.float32]}
    for r in rows:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"{r['name']} never launched on its path")
    log(f"{card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
