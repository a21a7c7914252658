#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

In order:
1. prints the card's name and power limit, the torch version and the TF32
   flags (set off: the reference mixes at full float32 precision), asks the
   allocator for expandable segments (unless ``PYTORCH_CUDA_ALLOC_CONF`` is
   set), and takes
   the card's peak memory rate, float32 rate and dense bf16 and TF32 tensor
   rates from its name;
2. builds every kernel of the port's main paths from this checkout's sources,
   one nvcc per source, all started together (nine: ``consensus_mix``,
   ``dequant_mix``, ``segment_mix``, ``wkv6`` and its backward ``wkv6_bwd``,
   ``flash_attention`` and its backward ``flash_attention_bwd``, ``ssd`` and
   its backward ``ssd_bwd``), and prints ptxas's report;
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and times kernel, plain version and, where one exists,
   one PyTorch library call in turns with CUDA events (atol 5e-5 / rtol 1e-4
   for the consensus kernels, float32 attention and ``ssd``, with a relative
   norm error under 1e-5 for ``ssd``, 1e-3 for ``wkv6``, atol = rtol = 1e-2
   and a relative norm error under 1e-2 for bf16 attention):
   ``consensus_mix`` at nine
   shapes, asserting the design each takes (the column tile from K = 16 to
   128, the gather below and above): the main paths' K = 2 and 100, a
   padded ring, K = 15 and 16 on either side of the small-K rule, K = 100
   with a ragged N and zero beta rows, K = 100 with W = I (d must survive),
   and K = 128 and 129 on either side of the cap; ``dequant_mix`` at nine,
   asserting the design each takes (the
   column tile up to K = 128, the gather above): the vector path at K=100
   (its N a ragged number of tiles), a padded star round, the scalar path
   with odd leaf boundaries inside a tile, a zero beta row, a zero-scale
   leaf and a no-payload call at K = 8 and K = 100, K = 2, and K = 128 and
   129 on either side of the cap), ``segment_mix`` at fifteen, printing
   and asserting the route each takes (the library's ``segment_mix_route``
   against ``segment.kernel_route``, and the route the case is built for:
   the column tile from K = 16 to 128 at D >= K / 3 slots, the persistent
   gather elsewhere): K=100 complete (tile), K=4096 ring (gather), a
   padded star with a zero beta row and ragged N on the scalar path,
   round 17 of a stacked R=16 link-dropout schedule, D=2047 slots, K = 24
   complete with a zero beta row and ragged N (the tile's scalar path),
   K = 32 complete at a degree bound of 34 (the tile's padding slots past
   K), and where the routes meet at the 2NN's row: complete graphs of 8
   and 12 peers (gather), 16 and 32 (tile), a ring of 64 (gather) and
   Erdos-Renyi graphs of 64 at D = 25 (tile) and of 128 at D = 36 (gather)
   and 52 (tile); the mass mode (push-sum) of the three
   consensus kernels, mixed, d and the new mass each held to its plain
   version, the new mass to sum K within 1e-5 K, and timed against
   ``torch.matmul([A diag(y); Beta], X)``: ``consensus_mix`` at K = 8 on
   the directed ring (gather), K = 100 complete (tile), K = 129 (gather) and
   K = 16 with an isolated peer, ``dequant_mix`` (qint8) at K = 8, 100, 129
   and K = 8 with an isolated peer, ``segment_mix`` on the K = 4096
   directed ring at the 2NN's row, on a K = 64 one with an isolated peer
   (whose mass and parameters stay, and whose d is 0), at ``iid_k100
   --protocol push_sum``'s K = 100 on the complete graph (the tile), on a
   complete graph of 24 with an isolated peer (the tile's guard) and at
   the gossip cases' eight shapes where the routes meet; the
   snapshot mode
   (bounded staleness) of ``consensus_mix``, gossip and mass, on
   age-decayed operands with every own snapshot stale, asserting its design
   and that d reads the live row, timed against
   ``torch.matmul([W_off; Beta], P)``: ``straggler_k8``'s K = 8 ring
   (gather), K = 100 complete (tile), K = 129 (gather) and K = 16 with an
   isolated peer (tile); the dense operands of adaptive rounds (a
   loss-proximity matching computed on the card, every j != k a slot, one
   weighted), asserting each design and timed against
   ``torch.matmul([W_off; Beta], X)``: ``consensus_mix`` at K = 8 (gather,
   D = 7, also timed on the same matching's D = 1 sparse operands), K = 9
   (one unmatched peer, whose row stays x_k and whose d stays 0) and K = 100
   (tile, D = 99), its mass mode at K = 8 and 100 (the new mass summing to
   K), ``dequant_mix`` (qint8) at K = 8 (tile); then each partner rule's
   matching on the card against the CPU's, partner, W and Beta equal, the
   all-zero-loss round's tie-break pairing among them; ``wkv6`` at seventeen (the prefill's
   B 4, T 1024, 64 heads of 64, chunk 16, from a zero and from a random
   state, and with bf16 r, k and v as served, timed; T 1000, ragged;
   log-decay -50; T 5, under one chunk; B 1, T 4096, timed; T 1001 ragged
   at chunk 48 with a state in bf16; the reference's three sweep shapes at
   head widths 16, 32 and 64; head widths 16 and 32 at chunks 1 and 64;
   and chunk 64 at head width 64 in float32 at B 1 and 4; bf16 outputs
   held within the float32 tolerance plus their one rounding),
   ``flash_attention`` at 40, asserting the route each takes (``wgmma``
   for bf16 at D = 64, 80 and 128, ``mma_sync`` at D = 32, ``float32``)
   (minitron's prefill B 4, S 1024, H 32, Kh 8,
   D 128, causal, bf16, timed against SDPA; phi4's group of 3; the
   long-context B 1, S 8192, window 4096, timed against SDPA with a boolean
   mask; S 1000 ragged; S 5; non-causal float32; smollm's 9 over 3 heads;
   zamba2's shared block at its prefill's B 4, S 1024, H = Kh = 32, D 80,
   timed against SDPA; the reduced configs' D 32 float32; the wgmma
   design's edges: S 129 and 1000 against 128-row tiles, S 5 at D 80,
   window 4000 at S 8192, group 3 at D 80, non-causal D 128, B 4 S 1024 at
   both served widths, and the (B, H, S, D) entry read in place at both;
   qwen3-moe's prefill at its group of 16, B 4, S 1024, H 64, Kh 4, D 128,
   timed against SDPA; internvl2's prefill, B 4, S 1024, H 16, Kh 8, D 128,
   causal; seamless-m4t's encoder, B 4, S 256, H = Kh = 16, D 64,
   non-causal (SDPA with ``is_causal=False``), and its decoder prefill, S
   768, causal, each timed against SDPA;
   and the reference sweep's 9 (S, D, mask) shapes in both types), ``ssd``
   at 32, output and
   final state, each asserting its route (``tf32x2`` for bf16 inputs,
   ``tf32x3`` for float32) and its split of P (zamba2's prefill B 4, T 1024,
   80 heads of P = N = 64, one B/C group, chunk 64, from a zero and from a
   random state, and with bf16 x, B and C as the served path gives them,
   both timed beside both bounds, on the float32 pipes and on the tensor
   cores; T 1000, ragged; T 5 and T 1, under one chunk; B 1, T 8192, 128
   chunks of carried state; dt a = -50; G = 2 groups over H = 4; the
   reference sweep's three shapes in both types; then the tensor-core
   design's edges: B * H on either side of each change of the split, in
   bf16 and float32; B 1, H 80 in bf16 (split 4); P 64, N 32 split 4;
   T 65, T 17, chunk 48 and chunk 1, and P 16, N 8 over 3 groups, in both
   types); ``flash_attention_bwd`` at nineteen, each asserting its route
   (``wgmma`` for bf16 at D = 64 and 128, ``mma_sync`` at D = 32 and 80,
   ``float32``), dq, dk and dv against the plain
   backward on the forward kernel's own output and row log-sum-exp (the
   lse against the plain forward's; bf16 atol = rtol = 5e-2 and a relative
   norm error under 1e-2, float32 a relative norm error under 1e-5; two
   calls equal bit for bit), six timed against SDPA's backward
   (``torch.autograd.grad`` through ``scaled_dot_product_attention(...,
   enable_gqa=True)``): the LM round's B 16 (K = 4 peers x batch 4), S 1024,
   H 9, Kh 3, D 64, causal, bf16; minitron's B 4, S 1024, H 32, Kh 8, D
   128; a window of 256; non-causal at D 80; float32 at D 32 and 64; and
   ragged S 1000, 130 (window 48), 200 (float32 D 128) and 77 (float32 D
   80, non-causal); the wgmma design's edges: S 129 at D 64 and 128, S 5, a
   window of 100 and non-causal at D 64, groups 1 and 16 at D 128, every
   operand read through (B, H, S, D) views at D 64 and 128;
   ``consensus_mix``'s bf16 mode (gossip) at six against
   its plain version (atol = rtol = 5e-2), each asserting its design and
   its vector path (rows of a multiple of 8), timed against the dense bf16
   product: the LM round's K = 4 complete at smollm-135m's row (N =
   134,515,008, the gather), K = 2, K = 100 at the 2NN's bf16 row (the
   tile), a K = 8 ring with a zero beta row, K = 24 with zero beta rows at
   N = 4099 and K = 4 at N = 5003 (the scalar path of each design);
   ``wkv6_bwd`` at nine (two of them across many chunk boundaries) and
   ``ssd_bwd`` at nine against their plain
   backwards (``BWD_REL_NORM``: each gradient's relative norm error under
   1e-4 in float32 and 1e-2 in bf16; under extreme decay every gradient
   within 1e-4 of the largest, ddt 1e-3; two calls equal bit for bit), the
   trained shapes timed against the plain backwards beside their bounds:
   rwkv6-7b's round (K = 2 x batch 2 = B 4, T 1024, 64 heads of 64, bf16,
   each peer's u a row) and zamba2-2.7b's (B 2, T 1024, 80 heads of P = N =
   64, bf16 views of the convolution's output, each peer's a a row), the
   served batch of 4, float32 with both states, ragged, G < H, the reduced
   and the narrowest widths, one token, extreme decay (``wkv6_bwd`` also at
   4096 tokens and at extreme decay over 1024);
3b. trains smollm-135m at full width (30 layers, d 576, vocab 49,152, tied,
   bf16, nothing cut) P2P through ``core.task.from_model``, ``init_state``
   and ``make_round_fn`` (``drive_p2p_lm``): K = 4 on the complete graph,
   batch 4, seq 1024, T = 4, S = 1, p2pl_affinity, seed 0; the first local
   step's stacked losses (equal) and gradients against the same step with
   the plain attention backward (atol = rtol = 5e-2, relative norm error
   under 5e-2); 2 rounds, each launching ``flash_attention`` and
   ``flash_attention_bwd`` 120 times and ``consensus_mix`` once (bf16 mode,
   the gather), no plain version; losses, drift and state finite; then one
   more round through its two phases, timed apart; s/round and peak memory;
   one more round under torch.profiler: device ms and launches by category
   (matmuls, elementwise and casts, attention forward and backward, wkv6
   and ssd forward and backward, consensus, other), the busy share and the
   top kernels; then the same for rwkv6-7b (published widths, 6 of 32
   layers, K = 2, batch 2: ``wkv6`` and ``wkv6_bwd`` 24 a round) and
   zamba2-2.7b (published widths, 42 of 54 layers, K = 2, batch 1: ``ssd``
   and ``ssd_bwd`` 168, ``flash_attention`` and its backward 28 a round),
   the first step's gradients against the plain backwards of all three
   kernels (``plain_backwards``); then the reference's entry point as it
   is, ``run_p2p_lm(arch, rounds=4)`` for smollm-135m, rwkv6-7b and
   zamba2-2.7b (reduced, float32: the kernels' float32 routes, 4 launches
   of ``consensus_mix``); then the reference's public API
   (``drive_step_api``): the consensus kernels' tree-level wrappers on the
   2NN's stacked float32 parameters at K = 8, each called the reference's
   way, moving its kernel's counter and held to its plain version (5e-5 /
   1e-4): ``consensus_mix_schedule`` on ``timevarying_k8``'s schedule,
   ``consensus_mix_push_sum_schedule`` on ``directed_k8``'s,
   ``dequant_consensus_mix_schedule`` on a qint8 wire and
   ``consensus_mix_flat``, and one ``consensus_mix_schedule`` call with its
   round index on the card captured as a CUDA graph, each replay equal to
   the eager call bit for bit; then smollm-135m at full width and depth on
   a K = 4 ring trained 2 rounds of T = 2 through ``make_train_step`` (AdamW
   on a cosine schedule, gradients clipped, eta_d 0.25; batch 4 x seq 1024
   a peer from ``lm_batches``) and ``make_consensus_step``: the first
   step's gradients against the plain backwards, ``flash_attention`` and its
   backward 480 launches each and ``consensus_mix`` 2 (bf16), each step's
   and each consensus's seconds, the peak memory, one more consensus step
   against its plain version (bf16 5e-2), ``make_consensus_step_psum``
   against ``make_consensus_step`` on the complete graph, and a checkpoint
   of the parameters and one peer's AdamW state restored bit for bit;
   ``consensus_mix``'s row range (run with 3a: a launch that computes the
   rows of some peers only, reading every peer's: how a rank of the sharded runtime
   mixes its own row) in every mode (gossip, mass, snapshot, both, dense
   operands and their mass mode; float32 and bf16; the gather at K = 8 and
   the column tile at K = 100), four ranges each held to the full launch's
   rows bit for bit and to the plain version, timed at ``sharded_k8``'s
   K = 8 row, K = 100 and smollm-135m's bf16 row at K = 2;
3a. runs the sharded runtime, one process per peer (last, after step 9,
   each earlier phase having freed what it held): ``sharded_k8`` as 8
   ranks on the one card through
   the ``cuda_ipc`` group (one spawn): gossip and push-sum on the
   reference's eight schedule entries, qint8 and staleness 2 each, two
   rounds a case, every rank's rows after both phases and its losses equal
   to the vmap runtime's run here first, bit for bit (qint8: allclose),
   the pod scan driver's chunk too, and two cases at local width 1 with
   their distance from the vmap rows; each case's time a round against the
   vmap round's, the exchange time a call, the communication share and
   each rank's peak memory; then ``run_paper_experiment(sharded_k8(),
   peer_axis="pod")`` 10 rounds, its accuracies, losses and drift equal to
   the vmap run's; then smollm-135m at full width, bf16, as K = 2 ranks,
   one round against the vmap round run first and freed (its rows within
   the bf16 tolerance, and the sharded consensus from its post-local rows
   bit for bit);
3c. holds the slot form of ``segment_mix`` (a rank's block and its
   ring-gathered slots: the hierarchical runtime's segment mix) against its
   plain version at five cases, gossip and mass, its rows equal to the
   one-device call's where that takes the gather route: the K = 4096 ring's
   block of 512 at the 2NN's row (timed, with ``torch.matmul`` of the
   block's dense [W; Beta] rows), a ragged star at a scalar row, the
   complete K = 2048 graph's staged chunks; and runs the hierarchical
   runtime over several slices (after step 9, whose fleet it reuses):
   bridge at K = 64 over 8 ranks of 8 (``iid_k100``'s ring, gossip and
   push-sum, 2 rounds; each rank's consensus from the vmap run's post-local
   rows, and its whole rounds at the vmap width, equal to the vmap run's
   bit for bit, the default width's distance reported), segment at K =
   4096 over 8 ranks of 512 (each rank's consensus from step 9's last
   post-local params equal to that round's one-device ``segment_mix``
   result, gossip and push-sum, then a whole round each; every rank's peak
   memory and what its consensus phase adds, under one (K, N) buffer), and
   ``run_paper_experiment(iid_k100(), peer_axis="pod",
   peers_per_device=25)`` 5 rounds against the vmap run;
3d. holds the dry run (``launch.dryrun_lib.run_case``: the step on fake
   CUDA tensors, every hand kernel through its fake route, the roofline
   against this card's peaks) against the same step on real tensors at
   full width and depth: smollm-135m's training (B 1, T 1024) and
   zamba2-2.7b's training and prefill (B 1, T 4096): the state's bytes
   equal, the reckoned peak within ``DRYRUN_PEAK_BAND`` of
   ``torch.cuda.max_memory_allocated`` (less what the card held beside the
   state), each hand kernel's calls equal to its wrapper's launches and to
   its device launches in ``torch.profiler``, the roofline's terms beside
   the step's time;
4. serves RWKV6-7B at full width and depth (bf16, random init on the card)
   through ``serve_batch``: batch 4, prompt 1024, first prefill only, then
   prefill and 15 decode steps, asserting ``wkv6`` launched once per layer
   in the prefill and never in the decode; in one more prefill, reruns the
   WKV calls of layers 0 and 31 on the operands the served path gives them,
   through the plain version, and compares (``recheck_calls``); times a
   warm prefill and decode step and profiles each; then serves the K = 2
   fleet through ``serve_fleet`` (two stacked models, one request group
   each), asserting 2 x 32 launches, and the same fleet with
   ``peer_axis="pod"`` (a process a peer), its tokens equal to the stacked
   fleet's and 32 launches a rank;
5. serves minitron-8b (9.88 B parameters) at full width and depth the same
   way, asserting ``flash_attention`` launched once per layer in each
   prefill and never in the decode; reruns the attention calls of layers 0
   and 31 of one more prefill through the plain version the same way;
   times and profiles a warm prefill and decode step (device time by kernel
   category); then
   runs its long-context variant (``for_shape(..., long_500k)``, a 4096-slot
   ring) on a prompt of 8192 tokens and 3 decode steps, both ways (the
   python loop and the scanned decode from the same prefill's cache, tokens
   and rings equal), asserting 32 launches, finite logits and the ring's
   positions;
6. serves zamba2-2.7b (2.35 B parameters: 54 Mamba2 layers and one shared
   attention block applied 9 times) at full width and depth the same way,
   asserting 54 ``ssd`` and 9 ``flash_attention`` launches in each prefill
   and none in the decode, and printing the peak memory beside the
   parameters; reruns the SSD calls of layers 0 and 53 and the attention
   calls of the shared block's first and last application of one more
   prefill through the plain version the same way; times and profiles a
   warm prefill and decode step (device time by kernel category); then
   serves internvl2-2b (1.89 B parameters: 24 layers, a 256-patch image
   prefix projected before 768 text tokens) and seamless-m4t-medium (0.72 B:
   256 frames through 12 encoder layers, 768 tokens through 12 decoder
   layers with cross-attention) at full size the same way, asserting 24
   ``flash_attention`` launches in each prefill (seamless: 12 non-causal in
   the encoder, 12 causal in the decoder) and none in the decode, every KV
   cache's positions (internvl2's 0 .. 1038 across the prefix; seamless's
   cache of ``split_encdec_seq(1040)`` = 780 decoder slots, as the
   reference sizes it, so decode positions 780-782 wrap onto slots 0-2) and
   seamless's cross k and v of the prompt's 256 frames; reruns the
   attention calls of internvl2's layers 0 and 23 and seamless's encoder
   layers 0 and 11 and decoder layers 0 and 11 of one more prefill through
   the plain version the same way, and prints each path's seconds; then
   serves the two MoE decoders at their published widths with the depth cut
   to fit the card (bf16, random init from seed 0 on the card, batch 4,
   prompt 1024, 16 tokens, through ``serve_model``, the helper
   ``serve_batch`` runs): deepseek-v2-236b at 6 of 60 layers (21.25 B
   parameters: MLA, the dense layer 0, 5 MoE layers of 160 experts top-6
   and 2 shared; no kernel, so none launched) and qwen3-moe-235b-a22b at 8
   of 94 (21.15 B: GQA at a group of 16 through ``flash_attention``, 8
   launches in each prefill and none in the decode, layers 0 and 7
   rechecked; 128 experts top-8), each timed, profiled and decoded both
   ways as the others, printing the peak memory beside the parameters; and
   on each (``moe_checks``): the share of assignments dropped at capacity
   factor 1.25 in every MoE layer of one prefill, the first MoE layer's
   dispatch on 512 tokens of its real input at a capacity that drops
   nothing against ``apply_dense_reference`` (relative norm error under
   1e-2), and for deepseek one decode step under ``mla_absorb`` against the
   expanded step (each layer's MLA output on the expanded step's own input
   within 1e-2, the logits' error reported), both timed;
   in phases 4-6, ``serve_batch`` and ``serve_fleet`` decode through their
   default, the scanned decode (one decode step captured as a CUDA graph
   over the cache, written in place, and replayed per token); and on the
   parameters each phase loads for its recheck, one prefill is decoded 15
   steps both ways, the python loop and the scanned decode
   (``compare_decode``): tokens and every final cache leaf equal, the
   prefill's launches as above and none in either decode, decode s/token
   both ways, the capture seconds, a warm replay's seconds, the CUDA
   kernels of one step both ways (torch.profiler) and the peak memory both
   ways; the K = 2 fleet's groups are drawn again and decoded both ways,
   each equal to ``serve_fleet``'s tokens (``fleet_both_ways``);
7. drives the trainer through ``run_paper_experiment``: uncompressed
   ``noniid_affinity`` (5 rounds) and ``iid_k100`` (2), then compressed
   ``timevarying_k8`` round robin with qint8 (5) and with top-k (3),
   ``iid_k100`` with qint8 (2), and ``iid_k100`` on the one-slice
   hierarchical runtime (segment mode, 2); then push-sum: ``directed_k8``
   static (3), with one-way matchings (3) and with directed link dropout and
   qint8 (3), ``iid_k100 --protocol push_sum`` (2) and the same on the
   one-slice segment runtime (2), each push-sum run checking after every
   round that the mass sums to K within 1e-5 K and stays positive; then
   asynchronous rounds: ``iid_k100 --steps-profile linear`` (2: step budgets
   alone, the synchronous consensus), ``straggler_k8`` gossip static and
   push-sum round robin (5 each, through the snapshot mode); then adaptive
   partner selection (each round's matching chosen on the card inside the
   round, mixed through the dense operands): ``timevarying_k8 --schedule
   adaptive`` with loss proximity and with eps-greedy (eps 0.5),
   ``directed_k8 --schedule adaptive`` (push-sum, the mass mode) and
   ``timevarying_k8 --schedule adaptive --compressor qint8`` (5 each); then
   RWKV6 on sequential MNIST (``seqmnist_phase``: ``seqmnist_k8``, K = 8,
   T = 4, 31 leaves, N = 100,236): the classifier's K-batched loss and
   per-leaf gradients on the card against the CPU (atol 5e-5 / rtol 1e-4),
   ``rwkv6_features`` chunked (``wkv6``, 2 launches) against the token loop
   at B = 256, ``wkv6`` at B 256, T 196, H 4, dk 16, chunk 49 against its
   plain version (timed) and from a random state, ``consensus_mix`` (gossip
   and mass mode) and ``dequant_mix`` held and timed at the task's row,
   gossip static, push-sum static and gossip round robin over qint8 (2
   rounds each), both drivers on gossip and push-sum (4 rounds, eval every
   2), and one round's kernels eager and on replay (torch.profiler),
   printing the phase's seconds; with
   every kernel's launch count reset just before and read just after each
   run, and every plain version's calls counted (none allowed); after each
   of the first, the compressed, the hierarchical and three push-sum runs it
   recomputes one consensus phase with the plain version (the async ones
   on the round's delivery and age-decayed operands); these runs take
   ``run_paper_experiment``'s default driver, the scan driver (each round a
   replay of one captured CUDA graph of the round, launches counted on
   replay), evaluating every round, so ``on_round`` still sees every
   round; then runs both drivers from the same seed and rounds
   (``compare_drivers``): ``noniid_affinity`` (K = 2, the gather design; 10
   rounds, eval every 5), ``iid_k100`` (tile; 10, 5), ``iid_k100`` qint8
   (``dequant_mix``; 10, 5), ``timevarying_k8`` round robin with qint8 (R =
   2 operands refreshed per round; 9, 3), ``directed_k8`` (push-sum, mass
   mode; 10, 5), ``iid_k100`` on the one-slice segment runtime
   (``segment_mix``; 10, 5), ``straggler_k8`` gossip static and push-sum
   round robin (the snapshot mode's gather; 10, 5) and ``iid_k100
   --steps-profile straggler --staleness-bound 3`` (its tile; 10, 5), and
   the adaptive ``timevarying_k8`` loss-proximity and eps-greedy runs and
   ``directed_k8`` (10, 5 each): final params, momentum, d, b, mass, the
   selection key and last losses, estimate, published snapshots and ages,
   the logged losses and accuracies equal bit for bit, ages within the
   bound and the mass summing to K, the same
   launches, no plain version; s/round both ways after the first period,
   the capture seconds, peak memory both ways, and at K = 100 the cost of
   copying every state leaf once (the body's carry copy at most);
8. breaks one round of ``noniid_affinity``, ``iid_k100``, ``iid_k100``
   with qint8 and ``directed_k8`` down by phase (synchronized host timers:
   the python driver's per-round view, through the phase functions) and
   profiles one more for the device's busy share; and profiles one adaptive
   round's selection alone at K = 8 for each rule (kernels, device time,
   a CUDA graph of it replayed);
9. trains the 2NN at K=4096 peers on a ring at full width on the one-slice
   segment runtime, 2 rounds through the python driver's round function
   without evaluation (its rounds are device-bound, about 2 s, and its
   state 13.1 GB, so a graph of the round would save little and its carry
   copy more memory), and prints its seconds per round and peak memory
   beside the state's size;
10. prints the ``kernels`` JSON line (``flash_attention_bwd``, ``wkv6_bwd``
   and ``ssd_bwd`` among them, each with its LM step's gradient check;
   ``consensus_mix`` with its bf16 mode;
   each consensus kernel with its mass mode beside its gossip mode,
   ``segment_mix`` at K = 100 beside K = 4096 in both modes and with its
   routes' edges, ``consensus_mix`` also with its snapshot mode,
   ``consensus_mix`` and ``dequant_mix`` with their dense-operand
   cases and the adaptive paths' launches, ``consensus_mix`` with its row
   range and the sharded paths' launches, ``segment_mix`` with its slot
   form and the hierarchical paths' launches) and, last, the contract line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed check raises, so the script exits non-zero and prints no result;
so does a run without a CUDA device or outside a checkout of the repository.

    python3 chip_smoke.py
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card (the part nvidia-smi's name picks, its published peaks, and a piece
# of work's least time on it) and each hand kernel's bytes and operations a
# call, shared with the dry run
from repro_torch.launch.mesh import Card, card_line  # noqa: E402
from repro_torch.launch.roofline import kernel_work  # noqa: E402
TOL = dict(atol=5e-5, rtol=1e-4)  # float32, as tests/test_kernels.py
NONIID_ROUNDS = 5
IID_ROUNDS = 2
TV_QINT8_ROUNDS = 5
TV_TOPK_ROUNDS = 3
IID_QINT8_ROUNDS = 2
IID_POD_ROUNDS = 2
DIRECTED_ROUNDS = 3
STRAGGLER_ROUNDS = 5
ADAPTIVE_ROUNDS = 5
LARGE_K = 4096
LARGE_K_ROUNDS = 2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """The relative norm error |got - want| / |want|, in float32."""
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()))


def cuda_ms(fn, target_s: float = 0.05) -> float:
    """Mean milliseconds per call of ``fn``, from CUDA events around a run of
    calls sized to take about ``target_s``, after a warm-up call; a call
    that alone takes longer (a plain version's token loop) is timed once."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once_ms = max(start.elapsed_time(end), 1e-3)
    if once_ms >= target_s * 1e3:
        return once_ms
    iters = int(min(max(target_s * 1e3 / once_ms, 3), 500))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kern, library) -> dict:
    """Mean ms of each, timed in turns: plain, kernel, library, library, kernel,
    plain; ``library`` None (no PyTorch call computes the function) gives
    ``library_ms`` None."""
    t = {"plain_ms": [], "ms": [], "library_ms": []}
    for fn, key in ((plain, "plain_ms"), (kern, "ms"), (library, "library_ms"),
                    (library, "library_ms"), (kern, "ms"), (plain, "plain_ms")):
        if fn is not None:
            t[key].append(cuda_ms(fn))
    return {key: sum(v) / len(v) if v else None for key, v in t.items()}


def consensus_case(card, name, graph, sizes, n, *, dmax=None, zero_beta_rows=(), self_only_w=False,
                   want_path="tile", seed=0):
    """Kernel vs plain version (and the dense library product) at one shape.
    ``self_only_w`` mixes with W = I while Beta stays the graph's (the mix
    is x, d must survive); ``want_path`` is the design the wrapper must
    pick: ``"tile"`` or ``"gather"``."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    local_steps = 10
    w = graph_lib.mixing_matrix(graph, "data_weighted", data_sizes=sizes)
    if self_only_w:
        w = np.eye(len(sizes))
    beta = graph_lib.affinity_matrix(graph, data_sizes=sizes)
    beta[list(zero_beta_rows)] = 0.0  # isolated for d: d must stay 0
    sparse = ops.sparse_from_matrices(w, beta, dmax=dmax, device=dev)
    k, d = sparse.nbr_idx.shape
    path = "tile" if ops.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)

    got = ops.consensus_mix_stacked(x, sparse, local_steps)
    want = ref.consensus_mix_stacked_ref(x, *sparse, local_steps)
    torch.cuda.synchronize()
    err = 0.0
    for g, r, what in zip(got, want, ("mixed", "d")):
        torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g - r).abs().max()))
    for row in zero_beta_rows:
        check(bool((got[1][row] == 0).all()), f"{name}: zero beta row {row} gives d = 0")
    if self_only_w:
        check(bool(torch.equal(got[0], x)), f"{name}: W = I mixes nothing")
        check(float(got[1].abs().max()) > 0.0, f"{name}: d survives a W with no off-diagonal")

    mixed, d_out = torch.empty_like(x), torch.empty_like(x)
    dense = torch.as_tensor(np.concatenate([w, beta]), dtype=torch.float32, device=dev)
    lib_out = torch.empty((2 * k, n), device=dev)
    kern = lambda: ops.launch(x, sparse, local_steps, mixed, d_out)  # noqa: E731
    plain = lambda: ref.consensus_mix_stacked_ref(x, *sparse, local_steps)  # noqa: E731
    library = lambda: torch.matmul(dense, x, out=lib_out)  # noqa: E731
    times = in_turns(plain, kern, library)

    # work this run's data needs: real (non-padding) slots only
    real = (sparse.nbr_idx != torch.arange(k, device=dev)[:, None]).sum().item()
    return {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": n % 4 == 0,
            "max_abs_err": err, **times,
            **card.work_bound(kernel_work("consensus_mix", k=k, n=n, d=d, real=real))}


def consensus_cases(card: Card, row: int) -> list[dict]:
    """``consensus_mix`` at the main paths' shapes (K = 2 and 100 at the
    2NN's row) and at the edges of its two designs: the column tile from
    ``TILE_MIN_PEERS`` to ``TILE_MAX_PEERS`` peers, the gather elsewhere."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops

    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    lo, cap = ops.TILE_MIN_PEERS, ops.TILE_MAX_PEERS
    design = lambda k: "tile" if lo <= k <= cap else "gather"  # noqa: E731
    return [
        consensus_case(card, "noniid_k2", complete(2), np.full(2, 100), row,
                       want_path=design(2)),
        consensus_case(card, "iid_k100", complete(100), np.full(100, 600), row),
        consensus_case(card, "ring_k8_padded", graph_lib.build_graph("ring", 8),
                       np.arange(1, 9) * 10, 1001, dmax=3, zero_beta_rows=(3,),
                       want_path=design(8)),
        consensus_case(card, f"edge_k{lo - 1}", complete(lo - 1), np.arange(1, lo) * 10, 5003,
                       want_path="gather", seed=1),
        consensus_case(card, f"edge_k{lo}", complete(lo), np.arange(1, lo + 1) * 10, 5003,
                       zero_beta_rows=(0,), seed=2),
        consensus_case(card, "k100_ragged_n", complete(100), np.arange(1, 101) * 6, 4099,
                       zero_beta_rows=(0, 57), seed=3),
        consensus_case(card, "k100_w_self_only", complete(100), np.full(100, 600), 20000,
                       self_only_w=True, seed=4),
        consensus_case(card, f"cap_k{cap}", complete(cap), np.arange(1, cap + 1) * 5, 50000,
                       zero_beta_rows=(5,), seed=5),
        consensus_case(card, f"gather_k{cap + 1}", complete(cap + 1), np.arange(1, cap + 2) * 5,
                       50000, zero_beta_rows=(5,), want_path="gather", seed=6),
    ]


CONSENSUS_BF16_TOL = dict(atol=5e-2, rtol=5e-2)  # bf16, as tests/test_kernels.py


def consensus_bf16_case(card, name, graph, sizes, n, *, zero_beta_rows=(), want_path="gather",
                        seed=0):
    """The bf16 storage mode of ``consensus_mix`` (gossip) vs its plain
    version on the card: x bf16, float32 sums, mixed and d rounded to bf16
    (atol = rtol = 5e-2), timed in turns against the dense bf16 library
    product ``[W_off; Beta] X`` (float32 accumulation)."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    local_steps = 4
    w = graph_lib.mixing_matrix(graph, "data_weighted", data_sizes=sizes)
    beta = graph_lib.affinity_matrix(graph, data_sizes=sizes)
    beta[list(zero_beta_rows)] = 0.0
    sparse = ops.sparse_from_matrices(w, beta, device=dev)
    k, d = sparse.nbr_idx.shape
    path = "tile" if ops.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16)
    vector = ops.vector_width(x) > 1
    check(vector == (n % 8 == 0), f"{name}: the vector path iff N = {n} is a multiple of 8")
    got = ops.consensus_mix_stacked(x, sparse, local_steps)
    want = ref.consensus_mix_stacked_ref(x, *sparse, local_steps)
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    for g, r, what in zip(got, want, ("mixed", "d")):
        check(g.dtype == torch.bfloat16, f"{name} {what} is bf16")
        torch.testing.assert_close(g.float(), r.float(), **CONSENSUS_BF16_TOL,
                                   msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g.float() - r.float()).abs().max()))
        rel = max(rel, rel_norm(g, r))
    for row in zero_beta_rows:
        check(bool((got[1][row] == 0).all()), f"{name}: zero beta row {row} gives d = 0")
    del got, want
    mixed, d_out = torch.empty_like(x), torch.empty_like(x)
    dense = torch.as_tensor(np.concatenate([w, beta]),
                            dtype=torch.bfloat16, device=dev)
    lib_out = torch.empty((2 * k, n), dtype=torch.bfloat16, device=dev)
    kern = lambda: ops.launch(x, sparse, local_steps, mixed, d_out)  # noqa: E731
    plain = lambda: ref.consensus_mix_stacked_ref(x, *sparse, local_steps)  # noqa: E731
    library = lambda: torch.matmul(dense, x, out=lib_out)  # noqa: E731
    times = in_turns(plain, kern, library)
    real = (sparse.nbr_idx != torch.arange(k, device=dev)[:, None]).sum().item()
    # the same work's least time on bf16 operands: the dense bf16 tensor rate
    # (the library product's), so the (2K, K) operator times x is bound by bytes
    case = {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": vector,
            "dtype": "bfloat16", "max_abs_err": err, "rel_norm_err": rel, **times,
            **card.work_bound(kernel_work("consensus_mix", k=k, n=n, d=d, real=real,
                                          elem_bytes=2))}
    del x, mixed, d_out, lib_out
    torch.cuda.empty_cache()
    return case


def consensus_bf16_cases(card: Card, lm_row: int, mlp_row: int) -> list[dict]:
    """The bf16 mode at the LM round's shape (K = 4 complete at smollm-135m's
    row, the gather), K = 2, K = 100 at the 2NN's bf16 row (the tile), a
    zero beta row on each design, and rows of no multiple of 8 elements
    (the scalar path) on each design."""
    from repro_torch.core import graph as graph_lib

    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    return [
        consensus_bf16_case(card, "lm_smollm_k4", complete(4), np.ones(4), lm_row),
        consensus_bf16_case(card, "k2", complete(2), np.ones(2), 1 << 20, seed=1),
        consensus_bf16_case(card, "k100_mlp_row", complete(100), np.full(100, 600), mlp_row,
                            want_path="tile", seed=2),
        consensus_bf16_case(card, "k8_ring_zero_beta", graph_lib.build_graph("ring", 8),
                            np.arange(1, 9) * 10, 1 << 16, zero_beta_rows=(3,), seed=3),
        consensus_bf16_case(card, "k24_zero_beta_ragged", complete(24), np.arange(1, 25) * 6,
                            4099, zero_beta_rows=(0, 11), want_path="tile", seed=4),
        consensus_bf16_case(card, "k4_ragged_n", complete(4), np.arange(1, 5), 5003, seed=5),
    ]


def bf16_mode_case(card, kernel: str, mode: str, name: str, graph, n: int, *, want: str,
                   sizes=None, leaves: int = 6, scalar: bool = False, seed: int = 0,
                   timed: bool = True) -> dict:
    """One of the bf16 storage modes that extend the consensus kernels against
    its plain version on the card (``CONSENSUS_BF16_TOL``; a dequant_mix
    estimate's advance, ``ref.advance_estimates``, bit for bit; the new mass
    at TOL), asserting the design or route the case is built for (``want``),
    and timed in turns against the plain version and ``torch.matmul`` of the
    dense bf16 ``[W_off; Beta]`` (the push-sum modes: ``[A_off diag(y);
    Beta]``).  ``kernel``/``mode``: consensus_mix in "mass", "snapshot",
    "mass_snapshot" or "dense" (an adaptive matching's operands, K peers),
    dequant_mix and segment_mix in "gossip" or "mass".  The snapshots P (and
    a compressed wire's estimates) are x perturbed; the int8 payload is the
    qint8 compressor's of ``leaves`` equal leaves (``ef_flat``), with
    ``scalar`` leaves that start off whole vectors (dequant_mix's scalar
    path, asserted).  ``timed=False`` skips the timing (the check stays)."""
    from repro_torch import compression
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import p2p, protocols
    from repro_torch.kernels.consensus_mix import dequant, ops, ref, segment

    dev = torch.device("cuda")
    t = 4
    mass = "mass" in mode
    rng = np.random.default_rng(seed)
    if mode == "dense":
        w, beta, one = matching_operands(graph, mass=False, seed=seed)
        k, d = one.nbr_idx.shape
        dense = torch.cat([w - torch.diag(torch.diagonal(w)), beta]).to(torch.bfloat16)
    else:
        sparse = graph_lib.SparseSchedule.from_schedule(
            graph_lib.static_schedule(graph), "data_weighted",
            data_sizes=np.ones(graph.num_peers) if sizes is None else sizes,
            stochasticity="column" if mass else "row")
        ops_s = ops.upload_schedule(sparse, dev)
        one = ops.select_round(ops_s, 0)
        k, d = sparse.num_peers, sparse.degree_bound
    y = push_sum_mass(k, seed, dev) if mass else None
    if "snapshot" in mode:
        stale = protocols.StaleRoundOps(
            *one, torch.as_tensor(protocols.column_sums(sparse)[0], device=dev),
            torch.zeros(k, dtype=torch.bool, device=dev))
        decay = torch.as_tensor((0.5 ** rng.integers(0, STALE_BOUND + 1, k)).astype(np.float32),
                                device=dev)
        one = protocols.age_decayed_operands(stale, decay, "column" if mass else "row")
    if mode != "dense":
        dense_w = torch.zeros(2 * k, k, device=dev)
        rows = torch.arange(k, device=dev).repeat_interleave(d)
        cols = one.nbr_idx.long().reshape(-1)
        wy = one.nbr_w * (y[one.nbr_idx.long()] if mass else 1.0)
        dense_w.index_put_((rows, cols), wy.reshape(-1), accumulate=True)
        dense_w.index_put_((rows + k, cols), one.beta.reshape(-1), accumulate=True)
        dense = dense_w.to(torch.bfloat16)
        del dense_w
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16)
    other = (x.float() + 0.05 * torch.randn(k, n, generator=gen, device=dev)).to(torch.bfloat16)
    offs, q, scale = None, None, None
    if kernel == "dequant_mix":
        base = n // leaves // 8 * 8  # leaf starts on whole vectors
        cuts = [301, 1, 475, 222][:leaves - 1] if scalar else [base] * (leaves - 1)
        shapes = {f"leaf{i}": (c,) for i, c in enumerate([*cuts, n - sum(cuts)])}
        layout = p2p.ParamLayout.block(shapes, torch.bfloat16)
        check(layout.row == n, f"{name}: the row {n} is whole bf16 rows")
        offs = layout.leaf_offsets
        payload = compression.get_compressor("qint8").ef_flat(x, other, layout)
        q, scale = payload.q, payload.scale
        vector = dequant.takes_vector_path(offs, x, other, q)
        check(vector != scalar, f"dequant_mix bf16 {mode} {name}: vector path {vector}")
    else:
        vector = n % 8 == 0
    if kernel == "segment_mix":
        design = segment_route(name, k, d, want)
    else:
        tile = (ops if kernel == "consensus_mix" else dequant).takes_tile_path(k)
        design = "tile" if tile else "gather"
        check(design == want, f"{kernel} bf16 {mode} {name}: {design} design, want {want}")
    pub = other if "snapshot" in mode else None
    n_out = (3 if kernel == "dequant_mix" else 2) + (1 if mass else 0)
    outs = [torch.empty_like(y) if mass and i == n_out - 1 else torch.empty_like(x)
            for i in range(n_out)]
    new_mass = outs[-1] if mass else None

    def call():  # the wrapper, as the runtime calls it
        if kernel == "consensus_mix":
            if mass:
                return (ops.consensus_mix_push_sum_stacked(x, y, one, t) if pub is None else
                        ops.consensus_mix_push_sum_snapshot_stacked(x, pub, y, one, t))
            return (ops.consensus_mix_stacked(x, one, t) if pub is None else
                    ops.consensus_mix_snapshot_stacked(x, pub, one, t))
        if kernel == "dequant_mix":
            if mass:
                return dequant.dequant_mix_push_sum_stacked(x, other, q, scale, y, one, offs, t)
            return dequant.dequant_mix_stacked(x, other, q, scale, one, offs, t)
        if mass:
            return segment.segment_mix_push_sum_schedule(x, y, 0, ops_s, t)
        return segment.segment_mix_schedule(x, 0, ops_s, t)

    def plain():  # its plain version on the same inputs
        if kernel == "consensus_mix":
            if mass:
                return ref.consensus_mix_push_sum_stacked_ref(x, y, *one, t, published=pub)
            return ref.consensus_mix_stacked_ref(x, *one, t, published=pub)
        if kernel == "dequant_mix":
            if mass:
                return ref.dequant_mix_push_sum_stacked_ref(x, other, q, scale, offs, y, *one, t)
            return ref.dequant_mix_stacked_ref(x, other, q, scale, offs, *one, t)
        if mass:
            return ref.segment_mix_push_sum_stacked_ref(x, y, *one, t)
        return ref.segment_mix_stacked_ref(x, *one, t)

    def kern():  # the launch alone, into buffers made once
        if kernel == "consensus_mix":
            ops.launch(x, one, t, outs[0], outs[1], y, new_mass, published=pub)
        elif kernel == "dequant_mix":
            dequant.launch(x, other, q, scale, one, offs, t, *outs[:3], y, new_mass)
        else:
            segment.launch(x, 0, ops_s, t, outs[0], outs[1], y, new_mass)

    got, want_out = call(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for i, (g, r) in enumerate(zip(got, want_out)):
        what = f"{kernel} bf16 {mode} {name} output {i}"
        if g.dtype == torch.float32:  # the new mass
            torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{what}: {m}")
            continue
        check(g.dtype == torch.bfloat16, f"{what} is bf16")
        if kernel == "dequant_mix" and i == 2:  # the advanced estimates, rounded alike
            check(torch.equal(g, r), f"{what}: est' bit for bit")
        torch.testing.assert_close(g.float(), r.float(), **CONSENSUS_BF16_TOL,
                                   msg=lambda m: f"{what}: {m}")
        err = max(err, float((g.float() - r.float()).abs().max()))
    del got, want_out
    lib_out = torch.empty((2 * k, n), dtype=torch.bfloat16, device=dev)
    times = in_turns(plain, kern, lambda: torch.matmul(dense, x, out=lib_out)) if timed else {}
    real = int((one.nbr_idx != torch.arange(k, device=dev)[:, None]).sum())
    work = dict(k=k, n=n, d=d, real=real, elem_bytes=2, mass=mass)
    if kernel == "dequant_mix":
        work["leaves"] = len(offs) - 1 if q is not None else 0
    elif kernel == "consensus_mix":
        work["snapshot"] = "snapshot" in mode
    case = {"case": name, "mode": mode, "K": k, "D": d, "N": n,
            ("route" if kernel == "segment_mix" else "path"): design,
            "vector_path": vector, "dtype": "bfloat16", "max_abs_err": err, **times,
            "library": "torch.matmul of the dense bf16 (2K, K) operator",
            **(card.work_bound(kernel_work(kernel, **work)) if timed else {})}
    del x, other, outs, lib_out, dense
    torch.cuda.empty_cache()
    return case


def bf16_mode_cases(card: Card, lm_row: int, mlp_row: int) -> dict[str, list[dict]]:
    """The bf16 storage modes this slice adds, at the main paths' shapes
    (each kernel's first case at smollm-135m's row timed, the later ones at
    that row checked untimed: their plain versions take seconds):
    ``consensus_mix`` mass (K = 8 directed ring at smollm-135m's row, the
    gather; K = 100 at the 2NN's, the tile), snapshot and the two together
    (the same two each), dense (an adaptive K = 8 matching at smollm's row);
    ``dequant_mix`` gossip and mass at K = 8 (smollm's row) and K = 100 (the
    2NN's), on the column tile, and at K = 129 on the gather (the 2NN's row;
    gossip's also on the scalar path, leaves off whole vectors);
    ``segment_mix`` gossip and mass at K = 100 (the tile) and on a K = 4096
    ring (the gather), at the 2NN's row."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import dequant

    ring = lambda k: graph_lib.build_graph("ring", k)  # noqa: E731
    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    directed = graph_lib.build_graph("directed_ring", 8)
    sizes100 = np.full(100, 600)
    gather_k = dequant.TILE_MAX_PEERS + 1  # the fewest peers on dequant_mix's gather
    sizes_gather = np.arange(1, gather_k + 1) * 5
    lm8 = lm_row  # smollm-135m's bf16 row
    return {
        "consensus_mix": [
            bf16_mode_case(card, "consensus_mix", "mass", "k8_directed_ring_lm_row", directed,
                           lm8, want="gather"),
            bf16_mode_case(card, "consensus_mix", "mass", "k100_mlp_row", complete(100),
                           mlp_row, sizes=sizes100, want="tile", seed=1),
            bf16_mode_case(card, "consensus_mix", "snapshot", "k8_ring_lm_row", ring(8), lm8,
                           want="gather", seed=2, timed=False),
            bf16_mode_case(card, "consensus_mix", "snapshot", "k100_mlp_row", complete(100),
                           mlp_row, sizes=sizes100, want="tile", seed=3),
            bf16_mode_case(card, "consensus_mix", "mass_snapshot", "k8_directed_ring_lm_row",
                           directed, lm8, want="gather", seed=4, timed=False),
            bf16_mode_case(card, "consensus_mix", "mass_snapshot", "k100_mlp_row",
                           complete(100), mlp_row, sizes=sizes100, want="tile", seed=17),
            bf16_mode_case(card, "consensus_mix", "dense", "k8_matching_lm_row", 8, lm8,
                           want="gather", seed=5, timed=False),
        ],
        "dequant_mix": [
            bf16_mode_case(card, "dequant_mix", "gossip", "k8_ring_lm_row", ring(8), lm8,
                           want="tile", seed=6),
            bf16_mode_case(card, "dequant_mix", "mass", "k8_directed_ring_lm_row", directed,
                           lm8, want="tile", seed=7, timed=False),
            bf16_mode_case(card, "dequant_mix", "gossip", "k100_mlp_row", complete(100),
                           mlp_row, sizes=sizes100, want="tile", seed=8),
            bf16_mode_case(card, "dequant_mix", "mass", "k100_mlp_row", complete(100),
                           mlp_row, sizes=sizes100, want="tile", seed=9),
            bf16_mode_case(card, "dequant_mix", "gossip", f"gather_k{gather_k}_mlp_row",
                           complete(gather_k), mlp_row, sizes=sizes_gather, want="gather",
                           seed=14),
            bf16_mode_case(card, "dequant_mix", "mass", f"gather_k{gather_k}_mlp_row",
                           complete(gather_k), mlp_row, sizes=sizes_gather, want="gather",
                           seed=15),
            bf16_mode_case(card, "dequant_mix", "gossip", f"gather_k{gather_k}_odd_leaves",
                           complete(gather_k), 50000, sizes=sizes_gather, leaves=5,
                           scalar=True, want="gather", seed=16),
        ],
        "segment_mix": [
            bf16_mode_case(card, "segment_mix", "gossip", "k100_mlp_row", complete(100),
                           mlp_row, sizes=sizes100, want="tile", seed=10),
            bf16_mode_case(card, "segment_mix", "mass", "k100_mlp_row", complete(100),
                           mlp_row, sizes=sizes100, want="tile", seed=11),
            bf16_mode_case(card, "segment_mix", "gossip", f"k{LARGE_K}_ring_mlp_row",
                           ring(LARGE_K), mlp_row, want="gather", seed=12),
            bf16_mode_case(card, "segment_mix", "mass", f"k{LARGE_K}_directed_ring_mlp_row",
                           graph_lib.build_graph("directed_ring", LARGE_K), mlp_row,
                           want="gather", seed=13),
        ],
    }


def dequant_case(card, name, graph, sizes, leaf_offsets, n, *, dmax=None, zero_beta_rows=(),
                 zero_scale_leaves=(), payload=True, want_vector=None, want_path="tile",
                 seed=0, operands=None):
    """dequant_mix kernel vs its plain version (and the dense library product
    of the advanced estimates) at one shape.  ``leaf_offsets`` are the L + 1
    leaf boundaries; columns from the last one to ``n`` are row padding, zero
    in every input.  ``payload=False`` is top-k's call: no q, no scales.
    ``want_path`` is the design the wrapper must pick: ``"tile"`` or
    ``"gather"``.  ``operands`` (an adaptive round's dense operands on the
    card) replace the graph's."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import dequant, ops, ref

    dev = torch.device("cuda")
    local_steps = 10
    if operands is None:
        w = graph_lib.mixing_matrix(graph, "data_weighted", data_sizes=sizes)
        beta = graph_lib.affinity_matrix(graph, data_sizes=sizes)
        beta[list(zero_beta_rows)] = 0.0  # isolated for d: d must stay exactly 0
        sparse = ops.sparse_from_matrices(w, beta, dmax=dmax, device=dev)
    else:
        sparse = operands
    k, d = sparse.nbr_idx.shape
    size, num_leaves = leaf_offsets[-1], len(leaf_offsets) - 1
    rng = np.random.default_rng(seed)
    x = torch.zeros(k, n, device=dev)
    est = torch.zeros(k, n, device=dev)
    x[:, :size] = torch.as_tensor(rng.normal(size=(k, size)).astype(np.float32), device=dev)
    est[:, :size] = x[:, :size] + torch.as_tensor(
        0.01 * rng.normal(size=(k, size)).astype(np.float32), device=dev)
    q = scale = None
    if payload:
        q = torch.zeros(k, n, dtype=torch.int8, device=dev)
        q[:, :size] = torch.as_tensor(rng.integers(-127, 128, (k, size)).astype(np.int8),
                                      device=dev)
        scale = torch.as_tensor(rng.uniform(0, 1e-4, (k, num_leaves)).astype(np.float32),
                                device=dev)
        scale[:, list(zero_scale_leaves)] = 0.0
    vector = dequant.takes_vector_path(leaf_offsets if payload else (0, 0), x, est, q)
    check(want_vector is None or vector == want_vector,
          f"{name}: vector path {vector}, want {want_vector}")
    path = "tile" if dequant.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")

    got = dequant.dequant_mix_stacked(x, est, q, scale, sparse, leaf_offsets, local_steps)
    want = ref.dequant_mix_stacked_ref(x, est, q, scale, leaf_offsets, *sparse, local_steps)
    torch.cuda.synchronize()
    err = 0.0
    for g, r, what in zip(got, want, ("mixed", "d", "est'")):
        torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g - r).abs().max()))
        check(bool((g[:, size:] == 0).all()), f"{name} {what}: row padding stays exactly 0")
    for row in zero_beta_rows:
        check(bool((got[1][row] == 0).all()), f"{name}: zero beta row {row} gives d = 0")
    check(payload or got[2] is est, f"{name}: a call with no payload leaves est as it is")

    mixed, d_out = torch.empty_like(x), torch.empty_like(x)
    est_out = torch.empty_like(x) if payload else None
    adv = want[2]  # the advanced estimates, prepared outside the timed region
    dense = ref.dense_mix_operator(sparse.nbr_idx, sparse.nbr_w, sparse.beta)
    lib_out = torch.empty((2 * k, n), device=dev)
    kern = lambda: dequant.launch(x, est, q, scale, sparse, leaf_offsets,  # noqa: E731
                                  local_steps, mixed, d_out, est_out)
    plain = lambda: ref.dequant_mix_stacked_ref(  # noqa: E731
        x, est, q, scale, leaf_offsets, *sparse, local_steps)
    library = lambda: torch.matmul(dense, adv, out=lib_out)  # noqa: E731
    times = in_turns(plain, kern, library)

    # work this run's data needs: slots of nonzero weight only (padding and a
    # dense round's unselected edges weigh 0); the own estimate's advance (2
    # operations) only with a payload
    real = ((sparse.nbr_w != 0) | (sparse.beta != 0)).sum().item()
    work = kernel_work("dequant_mix", k=k, n=n, d=d, real=real,
                       leaves=num_leaves if payload else 0)
    tile_cols = dequant.load_kernel().lib.dequant_mix_tile_columns(k) if path == "tile" else None
    return {"case": name, "K": k, "D": d, "N": n, "leaves": num_leaves, "payload": payload,
            "vector_path": vector, "path": path, "tile_columns": tile_cols, "max_abs_err": err,
            **times, **card.work_bound(work)}


def dequant_cases(card: Card, layout) -> list[dict]:
    """``dequant_mix`` at the main paths' shapes and at the edges of its two
    designs: the column tile (K <= 128) and the gather (K > 128)."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import dequant

    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    cap = dequant.TILE_MAX_PEERS
    # leaves of a 50,000-column row, every start a multiple of 4 (vector path)
    mid_leaves, mid_n = (0, 12000, 12200, 40000, 40012, 49996), 50000
    odd_leaves, odd_n = (0, 301, 302, 777, 999), 1001  # scalar path, leaves inside a tile
    cases = [
        dequant_case(card, "iid_k100_qint8", complete(100), np.full(100, 600),
                     layout.leaf_offsets, layout.row, want_vector=True),
        dequant_case(card, "tv_k8_star", graph_lib.build_graph("star", 8), np.full(8, 100),
                     layout.leaf_offsets, layout.row, want_vector=True),
        dequant_case(card, "ring_odd_leaves", graph_lib.build_graph("ring", 8),
                     np.arange(1, 9) * 10, odd_leaves, odd_n, dmax=3, zero_beta_rows=(3,),
                     zero_scale_leaves=(1,), want_vector=False),
        dequant_case(card, "ring_no_payload", graph_lib.build_graph("ring", 8),
                     np.arange(1, 9) * 10, odd_leaves, odd_n, dmax=3, zero_beta_rows=(3,),
                     payload=False, seed=1),
        dequant_case(card, "noniid_k2", complete(2), np.full(2, 100), layout.leaf_offsets,
                     layout.row, want_vector=True, seed=2),
        dequant_case(card, "k100_odd_leaves_zero_beta", complete(100), np.arange(1, 101) * 6,
                     odd_leaves, odd_n, zero_beta_rows=(0, 57), zero_scale_leaves=(1,),
                     want_vector=False, seed=3),
        dequant_case(card, "k100_no_payload", complete(100), np.full(100, 600), mid_leaves,
                     mid_n, payload=False, want_vector=True, seed=4),
        dequant_case(card, f"cap_k{cap}", complete(cap), np.arange(1, cap + 1) * 5, mid_leaves,
                     mid_n, zero_beta_rows=(5,), zero_scale_leaves=(2,), want_vector=True,
                     seed=5),
        dequant_case(card, f"gather_k{cap + 1}", complete(cap + 1),
                     np.arange(1, cap + 2) * 5, mid_leaves, mid_n, zero_beta_rows=(5,),
                     zero_scale_leaves=(2,), want_vector=True, want_path="gather", seed=6),
    ]
    main = cases[0]
    check(main["N"] % main["tile_columns"] != 0,
          f"iid_k100_qint8: N={main['N']} should leave a ragged last tile of "
          f"{main['tile_columns']} columns")
    return cases


def library_operator(sparse, r: int, dev, *, as_csr: bool) -> torch.Tensor:
    """[W; Beta] of round ``r`` as a (2K, K) float32 operator: dense, or (the
    callers' choice above K = 1000) the CSR of its nonzeros; at K = 4096 on
    a ring a dense product would be 13 TFLOP, nearly all of it zeros."""
    k, d = sparse.num_peers, sparse.degree_bound
    rows = np.repeat(np.arange(k), d)
    cols = sparse.nbr_idx[r].ravel().astype(np.int64)
    real = cols != rows
    idx = np.stack([np.concatenate([np.arange(k), rows[real], rows[real] + k]),
                    np.concatenate([np.arange(k), cols[real], cols[real]])])
    vals = np.concatenate([sparse.self_w[r], sparse.nbr_w[r].ravel()[real],
                           sparse.beta[r].ravel()[real]]).astype(np.float32)
    op = torch.sparse_coo_tensor(torch.as_tensor(idx), torch.as_tensor(vals), (2 * k, k),
                                 device=dev).coalesce()
    return op.to_sparse_csr() if as_csr else op.to_dense()


def segment_route(name: str, k: int, d: int, want: str) -> str:
    """``segment.kernel_route(k, d)``, checked against the kernel library's
    own ``segment_mix_route`` and against ``want``, the route the case is
    built for."""
    from repro_torch.kernels.consensus_mix import segment

    route = segment.kernel_route(k, d)
    lib_route = segment.ROUTES[segment.load_kernel().lib.segment_mix_route(k, d)]
    check(route == lib_route, f"segment_mix {name}: the wrapper's route {route} is the "
          f"kernel's ({lib_route})")
    check(route == want, f"segment_mix {name}: route {route}, want {want}")
    return route


def segment_case(card, name, sparse, n, *, round_idx=0, zero_beta_rows=(), size=None,
                 want_vector=None, want_route, seed=0):
    """segment_mix kernel vs its plain version (and the library product of
    [W; Beta]) over round ``round_idx % R`` of a stacked sparse schedule.
    Columns from ``size`` to ``n`` are row padding, zero in the input, and
    must stay exactly zero.  The route (``segment.kernel_route``) must be
    the kernel library's own and ``want_route``."""
    from repro_torch.kernels.consensus_mix import ops, ref, segment

    dev = torch.device("cuda")
    local_steps = 10
    if zero_beta_rows:  # isolated for d in every round: d must stay exactly 0
        beta = sparse.beta.copy()
        beta[:, list(zero_beta_rows)] = 0.0
        sparse = dataclasses.replace(sparse, beta=beta)
    ops_s = ops.upload_schedule(sparse, dev)
    k, d = sparse.num_peers, sparse.degree_bound
    route = segment_route(name, k, d, want_route)
    r = round_idx % sparse.period
    size = n if size is None else size
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.zeros(k, n, device=dev)
    x[:, :size] = torch.randn(k, size, generator=gen, device=dev)
    vector = n % 4 == 0 and x.data_ptr() % 16 == 0
    check(want_vector is None or vector == want_vector,
          f"{name}: vector path {vector}, want {want_vector}")

    got = segment.segment_mix_schedule(x, round_idx, ops_s, local_steps)
    want = ref.segment_mix_stacked_ref(x, *ops.select_round(ops_s, round_idx), local_steps)
    torch.cuda.synchronize()
    err = 0.0
    for g, w, what in zip(got, want, ("mixed", "d")):
        torch.testing.assert_close(g, w, **TOL, msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g - w).abs().max()))
        check(bool((g[:, size:] == 0).all()), f"{name} {what}: row padding stays exactly 0")
    for row in zero_beta_rows:
        check(bool((got[1][row] == 0).all()), f"{name}: zero beta row {row} gives d = 0")
    del got, want

    mixed, d_out = torch.empty_like(x), torch.empty_like(x)
    as_csr = k > 1000
    lib_op = library_operator(sparse, r, dev, as_csr=as_csr)
    kern = lambda: segment.launch(x, round_idx, ops_s, local_steps, mixed, d_out)  # noqa: E731
    plain = lambda: ref.segment_mix_stacked_ref(  # noqa: E731
        x, *ops.select_round(ops_s, round_idx), local_steps)
    library = ((lambda: torch.sparse.mm(lib_op, x)) if as_csr  # noqa: E731
               else (lambda: torch.matmul(lib_op, x)))
    times = in_turns(plain, kern, library)
    if as_csr:  # the card's streaming rate beside the byte bound: one copy of x
        times["copy_ms"] = cuda_ms(lambda: mixed.copy_(x))

    # work this run's data needs: the round's real (non-padding) slots only;
    # x read once, mixed and d written once, the round's operands read once
    real = int((sparse.nbr_idx[r] != np.arange(k)[:, None]).sum())
    return {"case": name, "K": k, "D": d, "N": n, "round": r, "route": route,
            "vector_path": vector,
            "library": "torch.sparse.mm (CSR [W; Beta])" if as_csr else "torch.matmul",
            "max_abs_err": err, **times,
            **card.work_bound(kernel_work("segment_mix", k=k, n=n, d=d, real=real))}


def build_kernels() -> None:
    """Build every kernel library at once (one nvcc each, in parallel)."""
    from repro_torch.kernels.consensus_mix import dequant, ops, segment
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops

    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(zip(("consensus_mix", "dequant_mix", "segment_mix", "wkv6", "wkv6_bwd",
                         "flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd"),
                        pool.map(lambda load: load(),
                                 (ops.load_kernel, dequant.load_kernel, segment.load_kernel,
                                  wkv6_ops.load_kernel, wkv6_ops.load_bwd_kernel,
                                  flash_ops.load_kernel, flash_ops.load_bwd_kernel,
                                  ssd_ops.load_kernel, ssd_ops.load_bwd_kernel))))
    print(f"build: all nine kernels in {time.perf_counter() - start:.2f} s", flush=True)
    for name, kl in libs.items():
        print(f"  {name}: nvcc {kl.build_seconds:.2f} s -> {kl.path.relative_to(ROOT)}")
        for line in kl.log.splitlines():
            if any(w in line for w in ("Function properties", "registers", "spill", "smem",
                                       "arning", "serialized")):
                print(f"  ptxas: {line.strip()}")
    smem = {f"{name} D={d}": libs["flash_attention"].lib.flash_attention_smem_bytes(code, d)
            for name, code in (("float32", 0), ("bfloat16", 1)) for d in (32, 64, 80, 128)}
    print(f"  flash_attention dynamic shared memory per block, bytes: {smem}", flush=True)


def _print_case(kernel: str, c: dict) -> None:
    path = (f"path={c['path']} vector={c['vector_path']} " if "path" in c else
            f"route={c['route']} vector={c['vector_path']} " if "route" in c else "")
    if "mode" in c:
        path = f"mode={c['mode']} {c.get('dtype', '')} " + path
    copy = f"copy of x={c['copy_ms']:.4f} ms " if "copy_ms" in c else ""
    timed = (f" kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms library="
             f"{c['library_ms']:.4f} ms {copy}bound={c['bound_ms']:.4f} ms ({c['bound_by']}; "
             f"{c['bound_card']})" if "ms" in c else " (untimed)")
    print(f"{kernel} {c['case']}: K={c['K']} D={c['D']} N={c['N']} {path}"
          f"max_abs_err={c['max_abs_err']:.3g}{timed}", flush=True)


def _print_slot_case(c: dict) -> None:
    timed = (f"kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms library="
             f"{c['library_ms']:.4f} ms bound={c['bound_ms']:.4f} ms ({c['bound_by']}; "
             f"{c['bound_card']})" if "ms" in c else "")
    print(f"segment_mix slot form {c['case']}: mode={c['mode']} K={c['K']} p={c['p']} "
          f"rank={c['rank']} D={c['D']} N={c['N']} vector={c['vector_path']} "
          f"max_abs_err={c['max_abs_err']:.3g} rows equal the one-device call's "
          f"({c['one_device_route']} route): {c['one_device_rows_equal']} {timed}", flush=True)


# where segment_mix's two routes meet, at the 2NN's row: complete graphs
# across the lower edge in K, and sparse rows below the cap across the edge
# in D (D >= K / 3 takes the tile): a ring of 64 (D = 2), Erdos-Renyi graphs
# of 64 at p = 0.25 (D = 25) and of 128 at p = 0.2 (D = 36) and 0.3 (D =
# 52); each (topology, K, p, the route it takes)
SEGMENT_EDGE_SHAPES = (("complete", 8, None, "gather"), ("complete", 12, None, "gather"),
                       ("complete", 16, None, "tile"), ("complete", 32, None, "tile"),
                       ("ring", 64, None, "gather"), ("erdos_renyi", 64, 0.25, "tile"),
                       ("erdos_renyi", 128, 0.2, "gather"), ("erdos_renyi", 128, 0.3, "tile"))


def segment_edge_graph(topology: str, k: int, p: float | None):
    """The graph of a ``SEGMENT_EDGE_SHAPES`` entry and its case's name."""
    from repro_torch.core import graph as graph_lib

    if p is None:
        return graph_lib.build_graph(topology, k), f"{topology}_k{k}"
    return graph_lib.build_graph(topology, k, p=p), f"{topology}_k{k}_p{p}"


def segment_cases(card: Card) -> list[dict]:
    """``segment_mix`` at the one-slice runtime's shapes and at its edges."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of

    layout = layout_of("mnist_mlp")

    def sparse_of(sched, sizes):
        return graph_lib.SparseSchedule.from_schedule(sched, "data_weighted", data_sizes=sizes)

    def static(topology, k):
        return graph_lib.static_schedule(graph_lib.build_graph(topology, k))

    dropout = graph_lib.link_dropout_schedule(graph_lib.build_graph("ring", 64), 0.7, 16, seed=3)
    dropout_sparse = sparse_of(dropout, np.arange(64) % 5 + 10)
    # round 17 of R = 16 is round 1, whose operands differ from round 0's
    check(not np.array_equal(dropout_sparse.nbr_w[1], dropout_sparse.nbr_w[0]),
          "link-dropout rounds 0 and 1 differ")
    large_k_sizes = np.where(np.arange(LARGE_K) < 60000 % LARGE_K, 15, 14)  # iid_partition's
    cases = [
        segment_case(card, "iid_k100", sparse_of(static("complete", 100), np.full(100, 600)),
                     layout.row, size=layout.size, want_vector=True, want_route="tile"),
        segment_case(card, "ring_k4096", sparse_of(static("ring", LARGE_K), large_k_sizes),
                     layout.row, size=layout.size, want_vector=True, want_route="gather",
                     seed=1),
        segment_case(card, "star_k8_ragged", sparse_of(static("star", 8), np.arange(1, 9) * 10),
                     1001, zero_beta_rows=(3,), want_vector=False, want_route="gather", seed=2),
        segment_case(card, "link_dropout_r16_at17", dropout_sparse, layout.row,
                     round_idx=17, size=layout.size, want_vector=True, want_route="gather",
                     seed=3),
        segment_case(card, "complete_k2048_chunked",
                     sparse_of(static("complete", 2048), np.arange(2048) % 7 + 5), 256,
                     want_vector=True, want_route="gather", seed=4),
        # the tile route's scalar path and its guard on the raw beta row
        segment_case(card, "complete_k24_ragged",
                     sparse_of(static("complete", 24), np.arange(1, 25) * 10), 1001,
                     zero_beta_rows=(3,), want_vector=False, want_route="tile", seed=5),
        # a degree bound past K: the tile's two padding slots a row scatter +0.0
        segment_case(card, "complete_k32_bound34", graph_lib.SparseSchedule.from_schedule(
                         static("complete", 32), "data_weighted",
                         data_sizes=np.arange(1, 33) * 10, degree_bound=34),
                     layout.row, size=layout.size, want_vector=True, want_route="tile", seed=6),
    ]
    for i, (topology, k, p, route) in enumerate(SEGMENT_EDGE_SHAPES):
        graph, name = segment_edge_graph(topology, k, p)
        cases.append(segment_case(
            card, name, sparse_of(graph_lib.static_schedule(graph), np.arange(1, k + 1) * 10),
            layout.row, size=layout.size, want_vector=True, want_route=route, seed=7 + i))
    torch.cuda.empty_cache()
    return cases


HIER_RANKS = 8  # the hierarchical runtime's slices: ranks on the one card


def slot_case(card, name, sparse, n, *, p, rank, mass=False, size=None, zero_beta_rows=(),
              timed=False, seed=0):
    """``segment_mix``'s slot form (a rank of the hierarchical runtime over
    K / p ranks: its (p, N) block and its (p, D, N) ring-gathered slots)
    against its plain version on the block of rank ``rank``; with ``mass``
    its mass mode (the (p, D) sender masses).  Where the one-device call of
    the same round takes the gather route its rows must equal the slot
    form's bit for bit (both sum the slots in slot order).  ``timed``: the
    kernel, its plain version and the library's product of the block's
    dense [W; Beta] rows (``library_operator``'s, the self term included;
    [A diag(y); Beta] in the mass mode) with the (K, N) buffer, in turns."""
    from repro_torch.kernels.consensus_mix import ops, ref, segment

    dev = torch.device("cuda")
    t = 10
    if zero_beta_rows:
        beta = sparse.beta.copy()
        beta[:, list(zero_beta_rows)] = 0.0
        sparse = dataclasses.replace(sparse, beta=beta)
    ops_s = ops.upload_schedule(sparse, dev)
    k, d = sparse.num_peers, sparse.degree_bound
    rows = slice(rank * p, (rank + 1) * p)
    size = n if size is None else size
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.zeros(k, n, device=dev)
    x[:, :size] = torch.randn(k, size, generator=gen, device=dev)
    full_ops = ops.select_round(ops_s, 0)
    blk_ops = ops.SparseOperands(*(o[rows].contiguous() for o in full_ops))
    idx = blk_ops.nbr_idx.long()
    block, slots = x[rows].contiguous(), x[idx]
    y = push_sum_mass(k, seed, dev) if mass else None
    if mass:
        args = (block, slots, y[rows].contiguous(), y[idx].contiguous(), blk_ops, t)
        got = segment.segment_mix_push_sum_slots(*args)
        want = ref.segment_mix_push_sum_slots_ref(block, slots, y[rows], y[idx], blk_ops.self_w,
                                                  blk_ops.nbr_w, blk_ops.beta, t)
    else:
        got = segment.segment_mix_slots(block, slots, blk_ops, t)
        want = ref.segment_mix_slots_ref(block, slots, blk_ops.self_w, blk_ops.nbr_w,
                                         blk_ops.beta, t)
    torch.cuda.synchronize()
    err = 0.0
    for g, w, what in zip(got, want, ("mixed", "d", "y'")):
        torch.testing.assert_close(g, w, **TOL, msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g - w).abs().max()))
    for g, what in zip(got[:2], ("mixed", "d")):
        check(bool((g[:, size:] == 0).all()), f"{name} {what}: row padding stays exactly 0")
    for row in zero_beta_rows:
        if rows.start <= row < rows.stop:
            check(bool((got[1][row - rows.start] == 0).all()), f"{name}: zero beta row gives d = 0")
    one_route = segment.kernel_route(k, d)
    one = (segment.segment_mix_push_sum_schedule(x, y, 0, ops_s, t) if mass
           else segment.segment_mix_schedule(x, 0, ops_s, t))
    one_equal = all(bool(torch.equal(g, o[rows])) for g, o in zip(got, one))
    if one_route == "gather":
        check(one_equal, f"{name}: the slot form's rows equal the one-device gather's bit for bit")
    del one, want
    out = {"case": name, "mode": "mass" if mass else "gossip", "K": k, "p": p, "rank": rank,
           "D": d, "N": n, "vector_path": n % 4 == 0, "one_device_route": one_route,
           "one_device_rows_equal": one_equal, "max_abs_err": err}
    if timed:
        mixed, d_out = torch.empty_like(block), torch.empty_like(block)
        new_mass = torch.empty(p, device=dev) if mass else None
        op = (mass_library(sparse, y, dev, as_csr=False) if mass
              else library_operator(sparse, 0, dev, as_csr=False))
        lib_rows = torch.cat([op[rows], op[k + rows.start:k + rows.stop]]).contiguous()
        del op
        if mass:
            kern = lambda: segment.launch_slots(block, slots, blk_ops, t, mixed, d_out,  # noqa
                                                args[2], args[3], new_mass)
            plain = lambda: ref.segment_mix_push_sum_slots_ref(  # noqa: E731
                block, slots, args[2], args[3], blk_ops.self_w, blk_ops.nbr_w, blk_ops.beta, t)
        else:
            kern = lambda: segment.launch_slots(block, slots, blk_ops, t, mixed, d_out)  # noqa
            plain = lambda: ref.segment_mix_slots_ref(  # noqa: E731
                block, slots, blk_ops.self_w, blk_ops.nbr_w, blk_ops.beta, t)
        times = in_turns(plain, kern, lambda: torch.matmul(lib_rows, x))
        # work this run's data needs: the block's real (non-padding) slots;
        # block and slots read once, mixed and d written once, the block's
        # operands (and masses) read once
        real = int((sparse.nbr_idx[0][rows] != np.arange(k)[rows, None]).sum())
        out |= {"library": "torch.matmul (the block's dense [W; Beta] rows x the (K, N) buffer)",
                **times, **card.work_bound(kernel_work("segment_mix", form="slots", p=p, n=n,
                                                       d=d, real=real, mass=mass))}
        del lib_rows, mixed, d_out
    del x, slots, got
    torch.cuda.empty_cache()
    return out


def slot_cases(card: Card) -> list[dict]:
    """The slot form of ``segment_mix``: the K = 4096 ring over 8 ranks
    (p = 512, a middle rank, the 2NN's row; the main path, gossip and mass,
    timed), a ragged star at a scalar row with a zero beta row (the rank of
    the hub), and the complete K = 2048 graph's staged chunks, gossip and
    mass."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of

    layout = layout_of("mnist_mlp")

    def sparse_of(topology, k, sizes, stochasticity="row"):
        return graph_lib.SparseSchedule.from_schedule(
            graph_lib.static_schedule(graph_lib.build_graph(topology, k)), "data_weighted",
            data_sizes=sizes, stochasticity=stochasticity)

    large_k_sizes = np.where(np.arange(LARGE_K) < 60000 % LARGE_K, 15, 14)  # iid_partition's
    p = LARGE_K // HIER_RANKS
    cases = [
        slot_case(card, "ring_k4096_rank3", sparse_of("ring", LARGE_K, large_k_sizes),
                  layout.row, p=p, rank=3, size=layout.size, timed=True, seed=41),
        slot_case(card, "ring_k4096_rank3_push_sum",
                  sparse_of("ring", LARGE_K, large_k_sizes, "column"), layout.row, p=p, rank=3,
                  mass=True, size=layout.size, timed=True, seed=42),
        slot_case(card, "star_k64_rank0_ragged", sparse_of("star", 64, np.arange(1, 65) * 10),
                  1001, p=8, rank=0, zero_beta_rows=(3,), seed=43),
        slot_case(card, "star_k64_rank0_push_sum", sparse_of("star", 64, np.arange(1, 65) * 10,
                                                             "column"),
                  1001, p=8, rank=0, mass=True, seed=44),
        slot_case(card, "complete_k2048_rank1_chunked",
                  sparse_of("complete", 2048, np.arange(2048) % 7 + 5), 256, p=256, rank=1,
                  seed=45),
    ]
    return cases


def push_sum_operands(sched, sizes, dev):
    """Push-sum's column-stochastic sparse schedule of ``sched`` and its upload."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops

    sparse = graph_lib.SparseSchedule.from_schedule(sched, "data_weighted", data_sizes=sizes,
                                                    stochasticity="column")
    return sparse, ops.upload_schedule(sparse, dev)


def push_sum_mass(k: int, seed: int, dev) -> torch.Tensor:
    """A positive (K,) float32 mass summing to K, as push-sum keeps it."""
    y = np.random.default_rng(seed).uniform(0.2, 2.0, k)
    return torch.as_tensor((k * y / y.sum()).astype(np.float32), device=dev)


def isolated(graph, peer: int):
    """``graph`` with every edge into and out of ``peer`` removed."""
    from repro_torch.core import graph as graph_lib

    a = graph.adjacency.copy()
    a[peer, :] = a[:, peer] = False
    return graph_lib.CommGraph(a, directed=graph.directed)


def mass_library(sparse, mass: torch.Tensor, dev, *, as_csr: bool) -> torch.Tensor:
    """[A diag(y); Beta] of round 0 as a (2K, K) float32 operator (dense, or
    CSR above K = 1000): its product with X is the push-sum numerator and
    the neighbor sum, without the division."""
    y = mass.double().cpu().numpy()
    scaled = dataclasses.replace(sparse, self_w=sparse.self_w * y[None, :],
                                 nbr_w=sparse.nbr_w * y[sparse.nbr_idx])
    return library_operator(scaled, 0, dev, as_csr=as_csr)


def check_mass_outputs(name: str, got, want, x, mass, iso) -> float:
    """Kernel against plain version: mixed, d (and est') and the new mass at
    TOL; the new mass sums to K; an isolated peer keeps its parameters (to
    the rounding of y x / y) and its mass, and its d is 0.  Returns the
    largest absolute difference."""
    err = 0.0
    names = ("mixed", "d", "est'", "new_mass") if len(got) == 4 else ("mixed", "d", "new_mass")
    for g, r, what in zip(got, want, names):
        torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} {what}: {m}")
        err = max(err, float((g - r).abs().max()))
    y_new = got[-1]
    k = y_new.shape[0]
    check(abs(float(y_new.double().sum()) - k) <= 1e-5 * k, f"{name}: sum y' = K")
    check(bool((y_new > 0).all()), f"{name}: y' > 0")
    if iso is not None:
        check(float(y_new[iso]) == float(mass[iso]), f"{name}: isolated peer keeps its mass")
        torch.testing.assert_close(got[0][iso], x[iso], rtol=1e-6, atol=0,
                                   msg=lambda m: f"{name}: isolated peer's parameters: {m}")
        check(bool((got[1][iso] == 0).all()), f"{name}: isolated peer's d is 0")
    return err


def consensus_mass_case(card, name, graph, sizes, n, *, iso=None, want_path="tile", seed=0):
    """``consensus_mix``'s mass mode (push-sum) against its plain version and
    the library product of [A diag(y); Beta]; ``iso`` isolates a peer."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    t = 10
    if iso is not None:
        graph = isolated(graph, iso)
    sparse, ops_s = push_sum_operands(graph_lib.static_schedule(graph), sizes, dev)
    one = ops.select_round(ops_s, 0)
    k, d = sparse.num_peers, sparse.degree_bound
    path = "tile" if ops.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32),
                        device=dev)
    mass = push_sum_mass(k, seed, dev)
    got = ops.consensus_mix_push_sum_stacked(x, mass, one, t)
    want = ref.consensus_mix_push_sum_stacked_ref(x, mass, *one, t)
    torch.cuda.synchronize()
    err = check_mass_outputs(name, got, want, x, mass, iso)
    del got, want

    mixed, d_out, new_mass = torch.empty_like(x), torch.empty_like(x), torch.empty_like(mass)
    lib_op = mass_library(sparse, mass, dev, as_csr=False)
    lib_out = torch.empty((2 * k, n), device=dev)
    times = in_turns(lambda: ref.consensus_mix_push_sum_stacked_ref(x, mass, *one, t),
                     lambda: ops.launch(x, one, t, mixed, d_out, mass, new_mass),
                     lambda: torch.matmul(lib_op, x, out=lib_out))
    real = int((sparse.nbr_idx[0] != np.arange(k)[:, None]).sum())
    return {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": n % 4 == 0,
            "max_abs_err": err, **times,
            **card.work_bound(kernel_work("consensus_mix", k=k, n=n, d=d, real=real,
                                          mass=True))}


def dequant_mass_case(card, name, graph, sizes, layout, *, iso=None, want_path="tile", seed=0):
    """``dequant_mix``'s mass mode (compressed push-sum, qint8 at the 2NN's
    row) against its plain version and the library product of
    [A diag(y); Beta] with the advanced estimates."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import dequant, ops, ref

    dev = torch.device("cuda")
    t = 10
    if iso is not None:
        graph = isolated(graph, iso)
    sparse, ops_s = push_sum_operands(graph_lib.static_schedule(graph), sizes, dev)
    one = ops.select_round(ops_s, 0)
    k, d = sparse.num_peers, sparse.degree_bound
    path = "tile" if dequant.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
    n, size, leaves = layout.row, layout.size, layout.leaf_offsets
    rng = np.random.default_rng(seed)
    x = torch.zeros(k, n, device=dev)
    x[:, :size] = torch.as_tensor(rng.normal(size=(k, size)).astype(np.float32), device=dev)
    est = x + torch.as_tensor(0.01 * rng.normal(size=(k, n)).astype(np.float32), device=dev)
    est[:, size:] = 0.0
    q = torch.zeros(k, n, dtype=torch.int8, device=dev)
    q[:, :size] = torch.as_tensor(rng.integers(-127, 128, (k, size)).astype(np.int8), device=dev)
    scale = torch.as_tensor(rng.uniform(0, 1e-4, (k, len(leaves) - 1)).astype(np.float32),
                            device=dev)
    mass = push_sum_mass(k, seed, dev)
    got = dequant.dequant_mix_push_sum_stacked(x, est, q, scale, mass, one, leaves, t)
    want = ref.dequant_mix_push_sum_stacked_ref(x, est, q, scale, leaves, mass, *one, t)
    torch.cuda.synchronize()
    err = check_mass_outputs(name, got, want, x, mass, iso)
    adv = want[2]
    del got, want

    outs = [torch.empty_like(x) for _ in range(3)]
    new_mass = torch.empty_like(mass)
    lib_op = mass_library(sparse, mass, dev, as_csr=False)
    lib_out = torch.empty((2 * k, n), device=dev)
    times = in_turns(
        lambda: ref.dequant_mix_push_sum_stacked_ref(x, est, q, scale, leaves, mass, *one, t),
        lambda: dequant.launch(x, est, q, scale, one, leaves, t, *outs, mass, new_mass),
        lambda: torch.matmul(lib_op, adv, out=lib_out))
    real = int((sparse.nbr_idx[0] != np.arange(k)[:, None]).sum())
    return {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": True,
            "max_abs_err": err, **times,
            **card.work_bound(kernel_work("dequant_mix", k=k, n=n, d=d, real=real,
                                          leaves=len(leaves) - 1, mass=True))}


def segment_mass_case(card, name, graph, sizes, n, *, size=None, iso=None, want_route,
                      seed=0):
    """``segment_mix``'s mass mode (push-sum on the one-slice segment
    runtime) against its plain version and the library product of
    [A diag(y); Beta] (CSR above K = 1000)."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ref, segment

    dev = torch.device("cuda")
    t = 10
    if iso is not None:
        graph = isolated(graph, iso)
    sparse, ops_s = push_sum_operands(graph_lib.static_schedule(graph), sizes, dev)
    k, d = sparse.num_peers, sparse.degree_bound
    route = segment_route(name, k, d, want_route)
    size = n if size is None else size
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.zeros(k, n, device=dev)
    x[:, :size] = torch.randn(k, size, generator=gen, device=dev)
    mass = push_sum_mass(k, seed, dev)
    got = segment.segment_mix_push_sum_schedule(x, mass, 0, ops_s, t)
    want = ref.segment_mix_push_sum_stacked_ref(x, mass, *(a[0] for a in ops_s), t)
    torch.cuda.synchronize()
    err = check_mass_outputs(name, got, want, x, mass, iso)
    del got, want

    mixed, d_out, new_mass = torch.empty_like(x), torch.empty_like(x), torch.empty_like(mass)
    as_csr = k > 1000
    lib_op = mass_library(sparse, mass, dev, as_csr=as_csr)
    library = ((lambda: torch.sparse.mm(lib_op, x)) if as_csr  # noqa: E731
               else (lambda: torch.matmul(lib_op, x)))
    times = in_turns(
        lambda: ref.segment_mix_push_sum_stacked_ref(x, mass, *(a[0] for a in ops_s), t),
        lambda: segment.launch(x, 0, ops_s, t, mixed, d_out, mass, new_mass), library)
    real = int((sparse.nbr_idx[0] != np.arange(k)[:, None]).sum())
    out = {"case": name, "K": k, "D": d, "N": n, "route": route, "vector_path": n % 4 == 0,
           "library": "torch.sparse.mm (CSR [A diag(y); Beta])" if as_csr else "torch.matmul",
           "max_abs_err": err, **times,
           **card.work_bound(kernel_work("segment_mix", k=k, n=n, d=d, real=real,
                                         mass=True))}
    del x, mixed, d_out, lib_op
    torch.cuda.empty_cache()
    return out


def mass_cases(card: Card) -> dict[str, list[dict]]:
    """The mass mode (push-sum) of the three consensus kernels at the
    push-sum paths' shapes: ``directed_k8`` (K = 8, directed ring, gather /
    tile for qint8), ``iid_k100 --protocol push_sum`` (K = 100, tile), one
    K past the tile cap (gather), and one case each with an isolated peer;
    ``segment_mix``'s are ``segment_mass_cases``."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of
    from repro_torch.kernels.consensus_mix import ops

    layout = layout_of("mnist_mlp")
    row = layout.row
    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    ring8 = graph_lib.build_graph("directed_ring", 8)
    k8_sizes = np.array([150, 150, 150, 150, 100, 100, 100, 100])  # directed_k8's shards
    cap = ops.TILE_MAX_PEERS
    return {
        "consensus_mix": [
            consensus_mass_case(card, "directed_k8", ring8, k8_sizes, row, want_path="gather"),
            consensus_mass_case(card, "iid_k100", complete(100), np.full(100, 600), row, seed=1),
            consensus_mass_case(card, f"gather_k{cap + 1}", complete(cap + 1),
                                np.arange(1, cap + 2) * 5, 50000, want_path="gather", seed=2),
            consensus_mass_case(card, "k16_isolated_peer", complete(16), np.arange(1, 17) * 10,
                                5003, iso=3, seed=3),
        ],
        "dequant_mix": [
            dequant_mass_case(card, "directed_k8_qint8", ring8, k8_sizes, layout),
            dequant_mass_case(card, "iid_k100_qint8", complete(100), np.full(100, 600), layout,
                              seed=1),
            dequant_mass_case(card, f"gather_k{cap + 1}_qint8", complete(cap + 1),
                              np.arange(1, cap + 2) * 5, layout, want_path="gather", seed=2),
            dequant_mass_case(card, "directed_k8_isolated_peer", ring8, k8_sizes, layout,
                              iso=5, seed=3),
        ],
        "segment_mix": segment_mass_cases(card),
    }


def segment_mass_cases(card: Card) -> list[dict]:
    """``segment_mix``'s mass mode: the K = 4096 directed ring (gather),
    ``iid_k100 --protocol push_sum`` on the one-slice segment runtime
    (tile), an isolated peer on each route, and ``SEGMENT_EDGE_SHAPES``."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of

    layout = layout_of("mnist_mlp")
    row = layout.row
    large_k_sizes = np.where(np.arange(LARGE_K) < 60000 % LARGE_K, 15, 14)
    cases = [
        segment_mass_case(card, f"directed_ring_k{LARGE_K}",
                          graph_lib.build_graph("directed_ring", LARGE_K), large_k_sizes, row,
                          size=layout.size, want_route="gather"),
        segment_mass_case(card, "directed_ring_k64_isolated_peer",
                          graph_lib.build_graph("directed_ring", 64), np.arange(64) % 5 + 10,
                          1001, iso=7, want_route="gather", seed=1),
        segment_mass_case(card, "iid_k100", graph_lib.build_graph("complete", 100),
                          np.full(100, 600), row, size=layout.size, want_route="tile", seed=2),
        segment_mass_case(card, "complete_k24_isolated_peer",
                          graph_lib.build_graph("complete", 24), np.arange(1, 25) * 10, 1001,
                          iso=5, want_route="tile", seed=3),
    ]
    for i, (topology, k, p, route) in enumerate(SEGMENT_EDGE_SHAPES):
        graph, name = segment_edge_graph(topology, k, p)
        cases.append(segment_mass_case(card, name, graph, np.arange(1, k + 1) * 10, row,
                                       size=layout.size, want_route=route, seed=4 + i))
    return cases


STALE_BOUND = 3  # straggler_k8's staleness bound: the ages the snapshot cases draw


def snapshot_case(card, name, graph, sizes, n, *, mass=False, iso=None, want_path="tile",
                  seed=0):
    """``consensus_mix``'s snapshot mode (bounded-staleness consensus), gossip
    or with ``mass`` its mass mode, against its plain version and the
    library product ``[W_off; Beta] P`` (mass: ``[A_off diag(y); Beta] P``),
    on the round's operands age-decayed (``protocols.age_decayed_operands``)
    by random ages up to ``STALE_BOUND``.  The published buffer P is x
    perturbed, so every own row is stale and d must read the live x_k.
    ``iso`` isolates a peer: it keeps its parameters (and its mass) and its
    d is 0."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import protocols
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    t = 10
    if iso is not None:
        graph = isolated(graph, iso)
    stochasticity = "column" if mass else "row"
    sparse = graph_lib.SparseSchedule.from_schedule(
        graph_lib.static_schedule(graph), "data_weighted", data_sizes=sizes,
        stochasticity=stochasticity)
    k, d = sparse.num_peers, sparse.degree_bound
    path = "tile" if ops.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
    rng = np.random.default_rng(seed)
    stale = protocols.StaleRoundOps(
        *ops.select_round(ops.upload_schedule(sparse, dev), 0),
        torch.as_tensor(protocols.column_sums(sparse)[0], device=dev),
        torch.zeros(k, dtype=torch.bool, device=dev))
    age = rng.integers(0, STALE_BOUND + 1, k)
    decay = torch.as_tensor((0.5 ** age).astype(np.float32), device=dev)
    a_ops = protocols.age_decayed_operands(stale, decay, stochasticity)
    x = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
    pub = x + torch.as_tensor(0.05 * rng.normal(size=(k, n)).astype(np.float32), device=dev)
    y = push_sum_mass(k, seed, dev) if mass else None
    if mass:
        got = ops.consensus_mix_push_sum_snapshot_stacked(x, pub, y, a_ops, t)
        want = ref.consensus_mix_push_sum_stacked_ref(x, y, *a_ops, t, published=pub)
    else:
        got = ops.consensus_mix_snapshot_stacked(x, pub, a_ops, t)
        want = ref.consensus_mix_stacked_ref(x, *a_ops, t, published=pub)
    torch.cuda.synchronize()
    if mass:
        err = check_mass_outputs(name, got, want, x, y, iso)
    else:
        err = 0.0
        for g, r, what in zip(got, want, ("mixed", "d")):
            torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} {what}: {m}")
            err = max(err, float((g - r).abs().max()))
        if iso is not None:
            check(bool(torch.equal(got[0][iso], x[iso])), f"{name}: isolated peer keeps x")
            check(bool((got[1][iso] == 0).all()), f"{name}: isolated peer's d is 0")
    # d's own term is the live row: with the stale own row it would differ
    live = int(np.argmax(np.asarray(a_ops.beta.sum(dim=1).cpu()) > 0))
    wrong = (want[1][live] * t + x[live] - pub[live]) / t
    check(not torch.allclose(got[1][live], wrong, **TOL), f"{name}: d reads the live x_k")
    del got, want

    outs = [torch.empty_like(x), torch.empty_like(x)]
    mass_args = (y, torch.empty_like(y)) if mass else ()
    w_off = torch.zeros(k, k, dtype=torch.float32, device=dev)
    rows = torch.arange(k, device=dev).repeat_interleave(d)
    cols = a_ops.nbr_idx.long().reshape(-1)
    w_vals = a_ops.nbr_w * (y[a_ops.nbr_idx.long()] if mass else 1.0)
    beta_d = torch.zeros(k, k, dtype=torch.float32, device=dev)
    w_off.index_put_((rows, cols), w_vals.reshape(-1), accumulate=True)
    beta_d.index_put_((rows, cols), a_ops.beta.reshape(-1), accumulate=True)
    lib_op = torch.cat([w_off, beta_d])
    lib_out = torch.empty((2 * k, n), device=dev)
    if mass:
        plain = lambda: ref.consensus_mix_push_sum_stacked_ref(  # noqa: E731
            x, y, *a_ops, t, published=pub)
    else:
        plain = lambda: ref.consensus_mix_stacked_ref(x, *a_ops, t, published=pub)  # noqa: E731
    times = in_turns(plain,
                     lambda: ops.launch(x, a_ops, t, *outs, *mass_args, published=pub),
                     lambda: torch.matmul(lib_op, pub, out=lib_out))
    real = int((sparse.nbr_idx[0] != np.arange(k)[:, None]).sum())
    return {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": n % 4 == 0,
            "weights": "mass" if mass else "gossip", "max_abs_err": err, **times,
            **card.work_bound(kernel_work("consensus_mix", k=k, n=n, d=d, real=real, mass=mass,
                                          snapshot=True))}


def snapshot_cases(card: Card) -> list[dict]:
    """The snapshot mode of ``consensus_mix`` in both designs and both weight
    modes: ``straggler_k8``'s K = 8 ring (gather), K = 100 complete at the
    2NN's row (tile: ``iid_k100`` with a staleness bound), K = 129 past the
    tile's cap (gather), and K = 16 with an isolated peer whose own row is
    stale (tile)."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of
    from repro_torch.kernels.consensus_mix import ops

    row = layout_of("mnist_mlp").row
    complete = lambda k: graph_lib.build_graph("complete", k)  # noqa: E731
    ring8 = graph_lib.build_graph("ring", 8)
    cap = ops.TILE_MAX_PEERS
    cases = []
    for mass in (False, True):
        tag = "_mass" if mass else ""
        cases += [
            snapshot_case(card, f"straggler_k8{tag}", ring8, np.full(8, 100), row, mass=mass,
                          want_path="gather"),
            snapshot_case(card, f"iid_k100{tag}", complete(100), np.full(100, 600), row,
                          mass=mass, seed=1),
            snapshot_case(card, f"gather_k{cap + 1}{tag}", complete(cap + 1),
                          np.arange(1, cap + 2) * 5, 50000, mass=mass, want_path="gather",
                          seed=2),
            snapshot_case(card, f"k16_isolated_stale{tag}", complete(16),
                          np.arange(1, 17) * 10, 5003, mass=mass, iso=3, seed=3),
        ]
    return cases


def matching_operands(k: int, *, mass: bool, seed: int):
    """An adaptive round's dense (K, K) W and Beta computed on the card
    (``graph.adaptive_round_matrices``, loss proximity over random losses,
    ``timevarying_k8``-like data sizes; column-stochastic with ``mass``),
    and the kernel's operands gathered from them (``ops.dense_operands``)."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import prng
    from repro_torch.kernels.consensus_mix import ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    losses = torch.as_tensor(rng.uniform(1.0, 2.5, k).astype(np.float32), device=dev)
    sizes = torch.as_tensor((100 + 50 * (np.arange(k) % 3)).astype(np.float32), device=dev)
    w, beta = graph_lib.adaptive_round_matrices(
        losses, prng.prng_key(seed, dev), data_sizes=sizes,
        stochasticity="column" if mass else "row")
    return w, beta, ops.dense_operands(w, beta, ops.complete_candidates(k, dev))


def dense_case(card, name, k, n, *, mass=False, want_path="tile", with_d1=False, seed=0):
    """``consensus_mix`` on an adaptive round's dense operands (every j != k
    a slot, one of them weighted), gossip or with ``mass`` its mass mode,
    against its plain version on the same operands and the library product
    ``[W_off; Beta] X`` (mass: ``[A_off diag(y); Beta] X``).  An odd K
    leaves one peer unmatched: its parameters (and mass) stay, its d is 0.
    ``with_d1`` also times the kernel on the same matching's D = 1 sparse
    operands (``ops.sparse_from_matrices``), the rows the dense operands
    read but weight 0 left out."""
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    t = 10
    w, beta, dense = matching_operands(k, mass=mass, seed=seed)
    d = dense.nbr_idx.shape[1]
    check(d == k - 1, f"{name}: D = {d}, want K - 1")
    path = "tile" if ops.takes_tile_path(k) else "gather"
    check(path == want_path, f"{name}: {path} design, want {want_path}")
    lone = torch.nonzero(beta.sum(dim=1) == 0).flatten().tolist()
    check(len(lone) == k % 2, f"{name}: {len(lone)} unmatched peers, want {k % 2}")
    iso = lone[0] if lone else None
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
    y = push_sum_mass(k, seed, dev) if mass else None
    if mass:
        got = ops.consensus_mix_push_sum_dense(x, y, w, beta, t)
        want = ref.consensus_mix_push_sum_stacked_ref(x, y, *dense, t)
        torch.cuda.synchronize()
        err = check_mass_outputs(name, got, want, x, y, iso)
    else:
        got = ops.consensus_mix_dense(x, w, beta, t)
        want = ref.consensus_mix_stacked_ref(x, *dense, t)
        torch.cuda.synchronize()
        err = 0.0
        for g, r, what in zip(got, want, ("mixed", "d")):
            torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} {what}: {m}")
            err = max(err, float((g - r).abs().max()))
        if iso is not None:
            check(bool(torch.equal(got[0][iso], x[iso])), f"{name}: unmatched peer keeps x")
            check(bool((got[1][iso] == 0).all()), f"{name}: unmatched peer's d is 0")
    del want

    outs = [torch.empty_like(x), torch.empty_like(x)]
    mass_args = (y, torch.empty_like(y)) if mass else ()
    nbr_w = dense.nbr_w * y[dense.nbr_idx.long()] if mass else dense.nbr_w
    lib_op = ref.dense_mix_operator(dense.nbr_idx, nbr_w, dense.beta)
    lib_out = torch.empty((2 * k, n), device=dev)
    plain_fn = ref.consensus_mix_push_sum_stacked_ref if mass else ref.consensus_mix_stacked_ref
    times = in_turns(lambda: plain_fn(x, *((y,) if mass else ()), *dense, t),
                     lambda: ops.launch(x, dense, t, *outs, *mass_args),
                     lambda: torch.matmul(lib_op, x, out=lib_out))
    extra = {}
    if with_d1:
        sparse = ops.sparse_from_matrices(w.double().cpu().numpy(), beta.double().cpu().numpy(),
                                          device=dev)
        check(sparse.nbr_idx.shape[1] == 1, f"{name}: the matching's sparse operands have D = 1")
        d1_out = [torch.empty_like(x), torch.empty_like(x)]
        ops.launch(x, sparse, t, *d1_out)
        for g, r, what in zip(d1_out, got, ("mixed", "d")):
            torch.testing.assert_close(g, r, **TOL, msg=lambda m: f"{name} D = 1 {what}: {m}")
        extra = {"sparse_d1_ms": cuda_ms(lambda: ops.launch(x, sparse, t, *d1_out)),
                 "dense_ms_same_call": cuda_ms(lambda: ops.launch(x, dense, t, *outs))}
    # work this run's data needs: the matched slots (nonzero weight) only
    real = int(((dense.nbr_w != 0) | (dense.beta != 0)).sum())
    return {"case": name, "K": k, "D": d, "N": n, "path": path, "vector_path": n % 4 == 0,
            "weights": "mass" if mass else "gossip", "matched_slots": real,
            "max_abs_err": err, **times, **extra,
            **card.work_bound(kernel_work("consensus_mix", k=k, n=n, d=d, real=real,
                                          mass=mass))}


def dense_cases(card: Card) -> dict[str, list[dict]]:
    """Adaptive rounds' dense operands at the 2NN's row: ``consensus_mix`` at
    K = 8 (gather, D = 7; also timed on the D = 1 sparse operands of the
    same matching), K = 9 (one unmatched peer) and K = 100 (tile, D = 99),
    its mass mode at K = 8 and 100, and ``dequant_mix`` (qint8) at K = 8
    (tile)."""
    from repro_torch.core.p2p import layout_of

    layout = layout_of("mnist_mlp")
    row = layout.row
    _, _, k8 = matching_operands(8, mass=False, seed=4)
    return {
        "consensus_mix": [
            dense_case(card, "adaptive_k8", 8, row, want_path="gather", with_d1=True),
            dense_case(card, "adaptive_k9_unmatched", 9, row, want_path="gather", seed=1),
            dense_case(card, "adaptive_k100", 100, row, seed=2),
            dense_case(card, "adaptive_k8_mass", 8, row, mass=True, want_path="gather",
                       seed=3),
            dense_case(card, "adaptive_k100_mass", 100, row, mass=True, seed=5),
        ],
        "dequant_mix": [
            dequant_case(card, "adaptive_k8_qint8", None, None, layout.leaf_offsets, row,
                         want_vector=True, seed=4, operands=k8),
        ],
    }


def check_matching_on_card() -> dict:
    """Each rule's ``adaptive_round_matrices`` on the card against the CPU's
    for the same losses and key: partner (via the matching), W and Beta
    equal, both stochasticities, at K = 8 and 9, the all-zero-loss round
    (every pair ties: ``torch.argmin``'s first flat index on the card, the
    pairing (0, 1), (2, 3), ...) among them."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import prng

    dev = torch.device("cuda")
    checked = 0
    for k in (8, 9):
        for seed in range(4):
            losses = np.random.default_rng(seed).uniform(0.5, 2.5, k).astype(np.float32)
            if seed == 0:
                losses[:] = 0.0
            for rule in graph_lib.ADAPTIVE_RULES:
                out = {}
                for where in ("cpu", dev):
                    l_t, key = torch.as_tensor(losses, device=where), prng.prng_key(seed, where)
                    partner = graph_lib.greedy_matching(
                        graph_lib.partner_scores(l_t, key, rule, 0.5))
                    mats = [graph_lib.adaptive_round_matrices(
                        l_t, key, rule=rule, eps=0.5, data_sizes=torch.arange(
                            1.0, k + 1, device=where), stochasticity=st)
                        for st in ("row", "column")]
                    out[str(where)] = [partner, *(m for pair in mats for m in pair)]
                for a, b in zip(out["cpu"], out[str(dev)]):
                    check(torch.equal(a, b.cpu()), f"matching K={k} seed {seed} {rule}: the "
                                                   "card's differs from the CPU's")
                if seed == 0 and rule == "loss_proximity":
                    pairs = out[str(dev)][0].cpu().tolist()
                    want = [i + 1 if i % 2 == 0 else i - 1 for i in range(k - k % 2)]
                    check(pairs[:k - k % 2] == want, f"K={k}: round 0 pairs {pairs}")
                checked += 1
    print(f"matching on the card equals the CPU's: {checked} (K, losses, key, rule) cases, "
          "partner, W and Beta, row and column", flush=True)
    return {"cases": checked}


def selection_profile(card: Card, exp, data) -> dict:
    """The device time of one adaptive round's selection (the key split, the
    scores, the greedy matching, W and Beta, the dense operands:
    ``p2p.adaptive_operands``) at ``exp``'s K, for each rule: the host's
    seconds of an eager call, its kernel count and device time
    (torch.profiler), and a replay of it alone captured as a CUDA graph
    (CUDA events)."""
    from repro_torch import capture as capture_lib
    from repro_torch.core import graph as graph_lib
    from repro_torch.core import p2p, task as task_lib

    dev = torch.device("cuda")
    out = {"card": card.line}
    for rule in graph_lib.ADAPTIVE_RULES:
        cfg = dataclasses.replace(exp.p2p, partner_rule=rule)
        state = p2p.init_state(task_lib.get_task(cfg.model), cfg, device=dev)
        ad = state.adaptive._replace(last_losses=torch.linspace(1.0, 2.0, cfg.num_peers,
                                                                device=dev))
        ops = p2p.round_operands(cfg, device=dev)[0]
        select = lambda: p2p.adaptive_operands(ad, cfg, ops)  # noqa: E731
        select()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(20):
            select()
        torch.cuda.synchronize()
        eager_s = (time.perf_counter() - start) / 20
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            select()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        captured = capture_lib.capture(select, dev)
        out[rule] = {"eager_host_s": eager_s,
                     "kernels": sum(e.count for e in kernels),
                     "device_busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
                     "graph_replay_ms": cuda_ms(captured.replay)}
        del captured
    print(f"selection ({card.line}): {json.dumps(out)}", flush=True)
    return out


WKV6_TOL = dict(atol=1e-3, rtol=1e-3)  # float32, the wkv6 tolerance of tests/test_kernels.py
# bf16 r, k, v and output: both sides compute in float32 from the same bf16
# values, and the kernel rounds its float32 output once to bf16 (at most 2^-9
# of it), so each entry is held within WKV6_TOL plus that rounding
WKV6_BF16_TOL = dict(atol=1e-3, rtol=1e-3 + 2**-8)


def wkv6_case(card, name, b, t, h, dk, chunk, *, state=False, ld=None, timed=False,
              dtype=torch.float32, seed=0):
    """wkv6 kernel vs its plain version on the card at one shape; ``ld`` is
    a constant log-decay, or (low, high) for a uniform draw of -ld; r, k
    and v in ``dtype`` (bf16: the served type; the log-decays stay float32)."""
    from repro_torch.kernels.rwkv6 import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(b, t, h, dk, generator=gen, device=dev).to(dtype) for _ in range(3))
    if isinstance(ld, float):
        logd = torch.full((b, t, h, dk), ld, device=dev)
    else:
        low, high = ld or (0.01, 4.0)  # tests/test_kernels.py's draw
        logd = -(low + (high - low) * torch.rand(b, t, h, dk, generator=gen, device=dev))
    u = 0.5 * torch.randn(h, dk, generator=gen, device=dev)
    s0 = torch.randn(b, h, dk, dk, generator=gen, device=dev) if state else None

    got, got_s = ops.wkv6(r, k, v, logd, u, state=s0, chunk=chunk)
    want, want_s = ref.wkv6_chunked_ref(r, k, v, logd, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    check(got.dtype == dtype, f"wkv6 {name}: output in r's type {dtype}, got {got.dtype}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(got_s).all()), f"wkv6 {name} finite")
    err = 0.0
    for g, w, what, tol in ((got, want, "out", WKV6_BF16_TOL if dtype == torch.bfloat16
                             else WKV6_TOL), (got_s, want_s, "final state", WKV6_TOL)):
        torch.testing.assert_close(g.float(), w, **tol, msg=lambda m: f"wkv6 {name} {what}: {m}")
        err = max(err, float((g.float() - w).abs().max()))
    case = {"case": name, "B": b, "T": t, "H": h, "dk": dk, "chunk": min(chunk, t),
            "state": state, "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
            "max_abs_out": float(want.abs().max())}
    if state:  # the state in must matter here: a zero state gives another result
        zero_s = ops.wkv6(r, k, v, logd, u, chunk=chunk)[1]
        case["state_effect"] = float((zero_s - got_s).abs().max())
        check(case["state_effect"] > 1e-2, f"wkv6 {name}: the initial state reaches the end")
    if timed:
        q = min(chunk, t)
        out = torch.empty_like(r)
        final = torch.empty(b, h, dk, dk, device=dev)
        kern = lambda: ops.launch(r, k, v, logd, u, s0, q, out, final)  # noqa: E731
        plain = lambda: ref.wkv6_chunked_ref(r, k, v, logd, u, s0, chunk=q)  # noqa: E731
        case.update(in_turns(plain, kern, None))
        es = r.element_size()
        case.update(card.work_bound(kernel_work("wkv6", b=b, t=t, h=h, dk=dk, q=q, state=state,
                                                in_bytes=es, out_bytes=es)))
    return case


def wkv6_cases(card: Card) -> list[dict]:
    """``wkv6`` at the serving prefill's shape (B 4, T 1024, 64 heads of 64,
    chunk 16) and at its edges."""
    small = (1e-4, 2e-3)  # decays summing to ~1 over 1024 tokens: the state survives
    cases = [
        wkv6_case(card, "main_b4_t1024", 4, 1024, 64, 64, 16, timed=True),
        wkv6_case(card, "main_b4_t1024_state", 4, 1024, 64, 64, 16, state=True, ld=small,
                  seed=1),
        wkv6_case(card, "ragged_t1000", 4, 1000, 64, 64, 16, state=True, ld=small, seed=2),
        wkv6_case(card, "extreme_decay", 4, 1024, 64, 64, 16, ld=-50.0, seed=3),
        wkv6_case(card, "short_t5", 4, 5, 64, 64, 16, state=True, ld=small, seed=4),
        wkv6_case(card, "b1_t4096", 1, 4096, 64, 64, 16, timed=True, seed=5),
        # the served type: bf16 r, k, v and output, float32 log-decays
        wkv6_case(card, "main_b4_t1024_bf16", 4, 1024, 64, 64, 16, timed=True,
                  dtype=torch.bfloat16, seed=7),
        wkv6_case(card, "ragged_t1001_q48_state_bf16", 2, 1001, 8, 64, 48, state=True, ld=small,
                  dtype=torch.bfloat16, seed=8),
    ]
    for t, h, dk, chunk in ((64, 2, 32, 16), (32, 4, 16, 8), (48, 1, 64, 48)):
        cases.append(wkv6_case(card, f"sweep_t{t}_h{h}_dk{dk}_q{chunk}", 2, t, h, dk, chunk,
                               state=True, ld=small, seed=6))
    # the narrower heads' instantiations at the chunk's extremes
    for dk, chunk in ((16, 1), (16, 64), (32, 1), (32, 64)):
        cases.append(wkv6_case(card, f"dk{dk}_q{chunk}", 2, 200, 3, dk, chunk, state=True,
                               ld=small, seed=9))
    # the general form at the longest chunk in float32 (218 KB of shared
    # memory), where the heads leave SMs free (B 1) and where they do not (B 4)
    for b in (1, 4):
        cases.append(wkv6_case(card, f"dk64_q64_b{b}", b, 300, 64, 64, 64, state=True,
                               ld=small, seed=10))
    torch.cuda.empty_cache()
    return cases


def _print_wkv6_case(c: dict) -> None:
    times = ""
    if "ms" in c:
        times = (f" kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms library=none "
                 f"bound={c['bound_ms']:.4f} ms ({c['bound_by']}; {c['bound_card']})")
    print(f"wkv6 {c['case']}: B={c['B']} T={c['T']} H={c['H']} dk={c['dk']} chunk={c['chunk']} "
          f"state={c['state']} {c['dtype']} max_abs_err={c['max_abs_err']:.3g} "
          f"(max |out| {c['max_abs_out']:.4g}){times}", flush=True)


# bf16 kernel vs plain version.  An output row averages up to S value rows, so
# at S = 1024..8192 its entries are about 0.02..0.06: the reference's test
# tolerance (5e-2) would pass a kernel that drops a KV tile.  Here each entry
# is held within 1e-2 + 1e-2 |want| (one bf16 step at |out| ~ 3 is 0.0156), and
# the whole output within 1e-2 of the plain version's norm.
FLASH_BF16_TOL = dict(atol=1e-2, rtol=1e-2)
FLASH_REL_NORM = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
LIBRARY_BF16_TOL = dict(atol=5e-2, rtol=5e-2)  # SDPA, the yardstick, as tests/test_kernels.py


def check_flash(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """Hold a flash output to the plain version's: every entry (float32
    ``TOL``, bf16 ``FLASH_BF16_TOL``) and the relative norm of the
    difference (``FLASH_REL_NORM``).  Returns the errors."""
    g, w = got.float(), want.float()
    check(got.dtype == want.dtype and bool(torch.isfinite(g).all()), f"{what} finite")
    tol = TOL if got.dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(g, w, **tol, msg=lambda m: f"{what}: {m}")
    rel = rel_norm(g, w)
    check(rel < FLASH_REL_NORM[got.dtype],
          f"{what}: relative norm error {rel} >= {FLASH_REL_NORM[got.dtype]}")
    return {"max_abs_err": float((g - w).abs().max()), "rel_norm_err": rel,
            "max_abs": float(w.abs().max())}


def visible_mask(s: int, *, causal: bool, window: int | None, device) -> torch.Tensor:
    """(S, S) bool, True where the key is visible: SDPA's ``attn_mask``."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    mask = (ki <= qi) if causal else torch.ones(s, s, dtype=torch.bool, device=device)
    return mask & ((qi - ki) < window) if window else mask


def flash_case(card, name, b, s, h, kh, d, *, causal=True, window=None, dtype=torch.bfloat16,
               timed=False, transposed=False, want_route=None, seed=0):
    """flash_attention kernel vs its plain version on the card at one shape
    (q (B, S, H, D), k and v (B, S, Kh, D), normal draws); ``timed`` also
    times kernel, plain version and SDPA (``is_causal`` without a window, a
    boolean mask with one) in turns, SDPA's output checked first, and the
    host's cost of one launch (the tensor maps included).  ``transposed``
    enters through ``flash_attention``'s (B, H, S, D) layout.  The route
    (``ops.kernel_route``) must be the kernel library's own, and
    ``want_route`` where given."""
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, s, kh, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    route = ops.kernel_route(dtype, d)
    check(route == ops.ROUTES[ops.load_kernel().lib.flash_attention_route(
        ops.DTYPE_CODES[dtype], d)], f"flash {name}: the wrapper's route {route} is the kernel's")
    check(want_route is None or route == want_route, f"flash {name}: route {route}, "
          f"want {want_route}")
    if transposed:  # the reference kernel's (B, H, S, D) entry, read in place
        bhsd = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
        got = ops.flash_attention(*bhsd, causal=causal, window=window).transpose(1, 2)
        views = [x.transpose(1, 2) for x in bhsd]
        check(all(ops._kernel_operand(x) is x for x in views),
              f"flash {name}: the transposed views are read in place, not copied")
        del bhsd, views
    else:
        got = ops.gqa_flash_attention(q, k, v, causal=causal, window=window)
    want = ref.gqa_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    case = {"case": name, "B": b, "S": s, "H": h, "Kh": kh, "D": d, "causal": causal,
            "window": window, "dtype": str(dtype).removeprefix("torch."), "route": route,
            **check_flash(got, want, f"flash {name}")}
    if timed:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window is None:
            library = lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)  # noqa: E731
        else:
            mask = visible_mask(s, causal=causal, window=window, device=dev)
            library = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
        lib_out = library().transpose(1, 2).float()
        torch.testing.assert_close(lib_out, want.float(),
                                   **(TOL if dtype == torch.float32 else LIBRARY_BF16_TOL),
                                   msg=lambda m: f"flash {name} SDPA: {m}")
        case["library_max_abs_err"] = float((lib_out - want.float()).abs().max())
        del lib_out
        out = torch.empty_like(q)
        scale = d**-0.5
        kern = lambda: ops.launch(q, k, v, out, causal=causal, window=window,  # noqa: E731
                                  scale=scale)
        plain = lambda: ref.gqa_attention_ref(q, k, v, causal=causal, window=window)  # noqa: E731
        case.update(in_turns(plain, kern, library))
        torch.cuda.synchronize()
        start, reps = time.perf_counter(), 20
        for _ in range(reps):
            kern()
        case["host_us_per_launch"] = (time.perf_counter() - start) / reps * 1e6
        torch.cuda.synchronize()
        case.update(card.work_bound(kernel_work(
            "flash_attention", b=b, s=s, h=h, kh=kh, d=d, causal=causal, window=window,
            elem_bytes=q.element_size())))
    del q, k, v, got, want
    return case


def flash_cases(card: Card) -> list[dict]:
    """``flash_attention`` at the decoder prefill's shapes and at its edges."""
    f32 = torch.float32
    wg = "wgmma"
    cases = [
        flash_case(card, "main_minitron", 4, 1024, 32, 8, 128, timed=True, want_route=wg),
        flash_case(card, "phi4_group3", 1, 2048, 24, 8, 128, want_route=wg, seed=1),
        flash_case(card, "long_window4096", 1, 8192, 32, 8, 128, window=4096, timed=True,
                   want_route=wg, seed=2),
        flash_case(card, "ragged_s1000", 2, 1000, 32, 8, 128, want_route=wg, seed=3),
        flash_case(card, "tiny_s5", 1, 5, 32, 8, 128, want_route=wg, seed=4),
        flash_case(card, "noncausal_f32", 2, 512, 4, 4, 64, causal=False, dtype=f32, seed=5),
        flash_case(card, "smollm", 2, 512, 9, 3, 64, want_route=wg, seed=6),
        # the LM round's forward: K = 4 peers x batch 4 folded into B 16
        flash_case(card, "lm_smollm_k4", 16, 1024, 9, 3, 64, timed=True, want_route=wg,
                   seed=23),
        flash_case(card, "zamba2_d80", 4, 1024, 32, 32, 80, timed=True, want_route=wg, seed=7),
        flash_case(card, "qwen3moe_group16", 4, 1024, 64, 4, 128, timed=True, want_route=wg,
                   seed=19),
        # the last two families' prefills: internvl2's 256 patches and 768 text
        # tokens at group 2; seamless-m4t's encoder over 256 frames (non-causal)
        # and its decoder over 768 tokens, both at D 64
        flash_case(card, "internvl2_group2", 4, 1024, 16, 8, 128, timed=True, want_route=wg,
                   seed=20),
        flash_case(card, "seamless_encoder_noncausal", 4, 256, 16, 16, 64, causal=False,
                   timed=True, want_route=wg, seed=21),
        flash_case(card, "seamless_decoder", 4, 768, 16, 16, 64, timed=True,
                   want_route=wg, seed=22),
        flash_case(card, "reduced_d32_f32", 2, 128, 4, 2, 32, dtype=f32, seed=8),
        # the wgmma design's edges: rows ragged against 128-row tiles, a
        # window that is a multiple of no tile, both served widths at the
        # prefill's shape, the (B, H, S, D) entry
        flash_case(card, "ragged_s129", 2, 129, 32, 8, 128, want_route=wg, seed=10),
        flash_case(card, "ragged_s1000_d80", 2, 1000, 32, 32, 80, want_route=wg, seed=11),
        flash_case(card, "tiny_s5_d80", 1, 5, 32, 32, 80, want_route=wg, seed=12),
        flash_case(card, "window4000_s8192", 1, 8192, 32, 8, 128, window=4000, want_route=wg,
                   seed=13),
        flash_case(card, "group3_d80", 1, 1024, 24, 8, 80, want_route=wg, seed=14),
        flash_case(card, "noncausal_d128", 2, 1000, 8, 2, 128, causal=False, want_route=wg,
                   seed=15),
        flash_case(card, "d128_b4_s1024_mha", 4, 1024, 32, 32, 128, want_route=wg, seed=16),
        flash_case(card, "transposed_bhsd_d128", 2, 1024, 32, 8, 128, transposed=True,
                   want_route=wg, seed=17),
        flash_case(card, "transposed_bhsd_d80", 2, 1000, 32, 32, 80, transposed=True,
                   want_route=wg, seed=18),
    ]
    for s, d in ((128, 32), (256, 64), (64, 128)):  # test_flash_attention_sweep's grid
        for causal, window in ((True, None), (True, 64), (False, None)):
            for dtype in (f32, torch.bfloat16):
                mode = "noncausal" if not causal else f"window{window}" if window else "causal"
                cases.append(flash_case(card, f"sweep_s{s}_d{d}_{mode}_{str(dtype)[6:]}", 1, s,
                                        2, 2, d, causal=causal, window=window, dtype=dtype,
                                        seed=9))
    torch.cuda.empty_cache()
    return cases


def _print_flash_case(c: dict) -> None:
    times = ""
    if "ms" in c:
        times = (f" kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms "
                 f"library(SDPA)={c['library_ms']:.4f} ms bound={c['bound_ms']:.4f} ms "
                 f"({c['bound_by']}; {c['bound_card']})")
    if "host_us_per_launch" in c:
        times += f" host={c['host_us_per_launch']:.1f} us/launch"
    print(f"flash_attention {c['case']}: B={c['B']} S={c['S']} H={c['H']} Kh={c['Kh']} "
          f"D={c['D']} causal={c['causal']} window={c['window']} {c['dtype']} "
          f"route={c['route']} "
          f"max_abs_err={c['max_abs_err']:.3g} rel_norm_err={c['rel_norm_err']:.3g} "
          f"(max |out| {c['max_abs']:.4g}){times}", flush=True)


FLASH_BWD_BF16_TOL = dict(atol=5e-2, rtol=5e-2)  # bf16 gradients, as tests/test_kernels.py
FLASH_BWD_REL_NORM = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FLASH_LSE_TOL = {torch.float32: TOL, torch.bfloat16: dict(atol=2e-3, rtol=1e-4)}


def flash_bwd_case(card, name, b, s, h, kh, d, *, causal=True, window=None,
                   dtype=torch.bfloat16, timed=False, transposed=False, want_route=None,
                   seed=0):
    """The backward kernel vs the plain backward on the card at one shape:
    the forward kernel's output and row log-sum-exp (the lse against the
    plain forward's), then dq, dk, dv from both backwards on the same
    inputs; ``timed`` also times kernel, plain backward and SDPA's backward
    (``torch.autograd.grad`` through ``scaled_dot_product_attention(...,
    enable_gqa=True)``) in turns.  ``transposed`` hands the backward q, k,
    v, o and do as (B, S, H, D) views of (B, H, S, D) tensors, read in place.
    The route (``ops.bwd_kernel_route``) must be the kernel library's own,
    and ``want_route`` where given."""
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, s, kh, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    dout = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    route = ops.bwd_kernel_route(dtype, d)
    check(route == ops.ROUTES[ops.load_bwd_kernel().lib.flash_attention_bwd_route(
        ops.DTYPE_CODES[dtype], d)], f"flash_bwd {name}: the wrapper's route {route} is the "
          "kernel's")
    check(want_route is None or route == want_route, f"flash_bwd {name}: route {route}, "
          f"want {want_route}")
    scale = d**-0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    ops.launch(q, k, v, out, causal=causal, window=window, scale=scale, lse=lse)
    want_out, want_lse = ref.gqa_attention_ref(q, k, v, causal=causal, window=window,
                                               return_lse=True)
    torch.cuda.synchronize()
    check_flash(out, want_out, f"flash_bwd {name} forward")
    torch.testing.assert_close(lse, want_lse, **FLASH_LSE_TOL[dtype],
                               msg=lambda m: f"flash_bwd {name} lse: {m}")
    lse_err = float((lse - want_lse).abs().max())
    del want_out, want_lse
    if transposed:  # every operand a (B, S, H, D) view of a (B, H, S, D) tensor
        q, k, v, out, dout = (x.transpose(1, 2).contiguous().transpose(1, 2)
                              for x in (q, k, v, out, dout))
        check(all(ops._kernel_operand(x) is x and not x.is_contiguous()
                  for x in (q, k, v, out, dout)),
              f"flash_bwd {name}: the transposed views are read in place, not copied")
    got = ops.attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window, scale=scale)
    want = ref.gqa_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal, window=window,
                                     scale=scale)
    torch.cuda.synchronize()
    errs, rels = [], []
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        check(g.dtype == dtype and g.shape == w.shape and bool(torch.isfinite(g.float()).all()),
              f"flash_bwd {name} {what} finite, {dtype}, {tuple(w.shape)}")
        if dtype == torch.bfloat16:
            torch.testing.assert_close(g.float(), w.float(), **FLASH_BWD_BF16_TOL,
                                       msg=lambda m: f"flash_bwd {name} {what}: {m}")
        rel = rel_norm(g, w)
        check(rel < FLASH_BWD_REL_NORM[dtype],
              f"flash_bwd {name} {what}: relative norm error {rel} >= "
              f"{FLASH_BWD_REL_NORM[dtype]}")
        errs.append(float((g.float() - w.float()).abs().max()))
        rels.append(rel)
    again = ops.attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window,
                              scale=scale)
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"flash_bwd {name}: two calls give the same bits (no atomics)")
    case = {"case": name, "B": b, "S": s, "H": h, "Kh": kh, "D": d, "causal": causal,
            "window": window, "dtype": str(dtype).removeprefix("torch."), "route": route,
            "max_abs_err": max(errs), "rel_norm_err": max(rels), "lse_max_abs_err": lse_err,
            "max_abs": max(float(w.float().abs().max()) for w in want)}
    del got, want, again
    if timed:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        kw = (dict(is_causal=causal) if window is None else
              dict(attn_mask=visible_mask(s, causal=causal, window=window, device=dev)))
        lib_out = sdpa(qt, kt, vt, enable_gqa=True, **kw)
        dout_t = dout.transpose(1, 2)
        library = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout_t,  # noqa: E731
                                              retain_graph=True)
        lib_dq = library()[0].transpose(1, 2)
        case["library_dq_rel_norm_err"] = rel_norm(lib_dq, ops.attention_bwd(
            q, k, v, out, dout, lse, causal=causal, window=window, scale=scale)[0])
        del lib_dq
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = ops.bwd_scratch(b, h, s, dev)
        kern = lambda: ops.launch_bwd(q, k, v, out, dout, lse, dq, dk, dv, delta,  # noqa: E731
                                      causal=causal, window=window, scale=scale)
        plain = lambda: ref.gqa_attention_bwd_ref(q, k, v, out, dout, lse,  # noqa: E731
                                                  causal=causal, window=window, scale=scale)
        case.update(in_turns(plain, kern, library))
        case.update(card.work_bound(kernel_work(
            "flash_attention_bwd", b=b, s=s, h=h, kh=kh, d=d, causal=causal, window=window,
            elem_bytes=q.element_size())))
        del lib_out, qt, kt, vt
    del q, k, v, dout, out, lse
    torch.cuda.empty_cache()
    return case


def flash_bwd_cases(card: Card) -> list[dict]:
    """The backward kernel at the LM round's shape (smollm-135m: the K = 4
    peers' batch of 4 folded into B 16, S 1024, H 9, Kh 3, D 64, causal,
    bf16), at zamba2-2.7b's LM round's (B 2, H = Kh = 32, D 80), at
    minitron's prefill shape, with a window, non-causal, in
    float32 (the reduced configs' D 32), and at S that are no multiple of
    a tile, at every head width; then the wgmma design's edges: S ragged
    against its 128-key and 128-row tiles (129) and below one tile (5), a
    window that is a multiple of no tile, non-causal at D 64, groups of 1
    and 16 at D 128, and every operand read through (B, H, S, D) views.
    Each asserts its route."""
    f32, wg, ms = torch.float32, "wgmma", "mma_sync"
    return [
        flash_bwd_case(card, "lm_smollm_k4", 16, 1024, 9, 3, 64, timed=True, want_route=wg),
        # zamba2-2.7b's shared block in its LM round: K = 2 peers x batch 1
        flash_bwd_case(card, "zamba2_trained_d80", 2, 1024, 32, 32, 80, timed=True,
                       want_route=ms, seed=19),
        flash_bwd_case(card, "minitron", 4, 1024, 32, 8, 128, timed=True, want_route=wg, seed=1),
        flash_bwd_case(card, "window256", 2, 1024, 8, 2, 64, window=256, timed=True,
                       want_route=wg, seed=2),
        flash_bwd_case(card, "noncausal_d80", 2, 512, 4, 4, 80, causal=False, timed=True,
                       want_route=ms, seed=3),
        flash_bwd_case(card, "reduced_f32_d32", 8, 32, 4, 2, 32, dtype=f32, timed=True,
                       want_route="float32", seed=4),
        flash_bwd_case(card, "f32_s512_d64", 2, 512, 4, 2, 64, dtype=f32, timed=True,
                       want_route="float32", seed=5),
        flash_bwd_case(card, "ragged_s1000", 2, 1000, 9, 3, 64, want_route=wg, seed=6),
        flash_bwd_case(card, "ragged_s130_d32", 1, 130, 4, 2, 32, window=48, want_route=ms,
                       seed=7),
        flash_bwd_case(card, "ragged_s200_d128_f32", 1, 200, 2, 1, 128, dtype=f32,
                       want_route="float32", seed=8),
        flash_bwd_case(card, "ragged_s77_d80_f32", 1, 77, 4, 2, 80, dtype=f32, causal=False,
                       want_route="float32", seed=9),
        flash_bwd_case(card, "ragged_s129", 2, 129, 9, 3, 64, want_route=wg, seed=10),
        flash_bwd_case(card, "ragged_s129_d128", 2, 129, 8, 2, 128, want_route=wg, seed=11),
        flash_bwd_case(card, "tiny_s5", 1, 5, 9, 3, 64, want_route=wg, seed=12),
        flash_bwd_case(card, "window100_d64", 2, 1000, 8, 2, 64, window=100, want_route=wg,
                       seed=13),
        flash_bwd_case(card, "noncausal_d64", 2, 1000, 8, 2, 64, causal=False, want_route=wg,
                       seed=14),
        # seamless-m4t-medium's training: the encoder's non-causal
        # self-attention, K = 2 peers x batch 4, 256 frames
        flash_bwd_case(card, "seamless_trained_encoder_noncausal", 8, 256, 16, 16, 64,
                       causal=False, timed=True, want_route=wg, seed=20),
        flash_bwd_case(card, "group1_d128", 2, 1024, 8, 8, 128, want_route=wg, seed=15),
        flash_bwd_case(card, "group16_d128", 1, 1024, 64, 4, 128, want_route=wg, seed=16),
        flash_bwd_case(card, "transposed_bhsd_d64", 2, 1000, 9, 3, 64, transposed=True,
                       want_route=wg, seed=17),
        flash_bwd_case(card, "transposed_bhsd_d128", 2, 1024, 8, 2, 128, transposed=True,
                       want_route=wg, seed=18),
    ]


def _print_flash_bwd_case(c: dict) -> None:
    times = ""
    if "ms" in c:
        times = (f" kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms "
                 f"library(SDPA backward)={c['library_ms']:.4f} ms "
                 f"(its dq's relative norm error {c['library_dq_rel_norm_err']:.3g}) "
                 f"bound={c['bound_ms']:.4f} ms ({c['bound_by']}; {c['bound_card']})")
    print(f"flash_attention_bwd {c['case']}: B={c['B']} S={c['S']} H={c['H']} Kh={c['Kh']} "
          f"D={c['D']} causal={c['causal']} window={c['window']} {c['dtype']} "
          f"route={c['route']} max_abs_err={c['max_abs_err']:.3g} "
          f"rel_norm_err={c['rel_norm_err']:.3g} (max |grad| {c['max_abs']:.4g}; lse "
          f"max_abs_err {c['lse_max_abs_err']:.3g}){times}", flush=True)


# The kernel and its plain version compute in float32 from the same values
# (bf16 x, B and C widened as they are read), so every ssd output is float32
# and held at the float32 tolerance, and the difference's norm within 1e-5 of
# the plain version's.
SSD_REL_NORM = 1e-5


def ssd_case(card, name, b, t, h, p, n, chunk, *, g=1, state=False, dt_range=(0.01, 1.0),
             dt_a=None, dtype=torch.float32, timed=False, want_split=None, seed=0):
    """ssd kernel vs its plain version on the card at one shape: x, B and C
    normal, dt uniform in ``dt_range``, a = -U(0.5, 2) (tests/test_kernels.py's
    draws; ``dt_a`` fixes dt = 1 and a = dt_a instead), B/C in ``g`` groups;
    output and final state compared.  The route (``ops.kernel_route``) and
    the split of P (``ops.kernel_split``) must be the kernel library's own,
    and the split ``want_split`` where given."""
    from repro_torch.kernels.mamba2 import ops, ref

    dev = torch.device("cuda")
    lib = ops.load_kernel().lib
    code, sms = ops.DTYPE_CODES[dtype], torch.cuda.get_device_properties(dev).multi_processor_count
    route, split = ops.kernel_route(dtype), ops.kernel_split(b * h, p, dtype, sms)
    check(route == ops.ROUTES[lib.ssd_route(code)], f"ssd {name}: route {route} is the kernel's")
    check(route == ("tf32x2" if dtype == torch.bfloat16 else "tf32x3"),
          f"ssd {name}: {dtype} takes the tensor-core route, not {route}")
    check(split == lib.ssd_split(b * h, p, code, sms), f"ssd {name}: split {split} is the kernel's")
    check(want_split is None or split == want_split, f"ssd {name}: split {split}, want {want_split}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=gen, device=dev).to(dtype)
    bm, cm = (torch.randn(b, t, g, n, generator=gen, device=dev).to(dtype) for _ in range(2))
    low, high = dt_range
    dt = low + (high - low) * torch.rand(b, t, h, generator=gen, device=dev)
    a = -(0.5 + 1.5 * torch.rand(h, generator=gen, device=dev))
    if dt_a is not None:
        dt, a = torch.ones(b, t, h, device=dev), torch.full((h,), dt_a, device=dev)
    s0 = torch.randn(b, h, p, n, generator=gen, device=dev) if state else None

    got, got_s = ops.ssd(x, bm, cm, dt, a, state=s0, chunk=chunk)
    want, want_s = ref.ssd_chunked_ref(x, bm, cm, dt, a, state=s0, chunk=chunk)
    torch.cuda.synchronize()
    case = {"case": name, "B": b, "T": t, "H": h, "G": g, "P": p, "N": n, "chunk": min(chunk, t),
            "state": state, "dtype": str(dtype).removeprefix("torch."), "route": route,
            "split": split, "max_abs_out": float(want.abs().max())}
    errs, rels = [], []
    for gv, wv, what in ((got, want, "y"), (got_s, want_s, "final state")):
        check(gv.dtype == torch.float32 and bool(torch.isfinite(gv).all()),
              f"ssd {name} {what} float32 and finite")
        torch.testing.assert_close(gv, wv, **TOL, msg=lambda m: f"ssd {name} {what}: {m}")
        errs.append(float((gv - wv).abs().max()))
        rels.append(float(torch.linalg.vector_norm(gv - wv) / torch.linalg.vector_norm(wv)))
        check(rels[-1] < SSD_REL_NORM, f"ssd {name} {what}: relative norm error {rels[-1]}")
    case.update(max_abs_err=max(errs), rel_norm_err=max(rels))
    if state:  # the state in must matter here: a zero state gives another result
        zero_s = ops.ssd(x, bm, cm, dt, a, chunk=chunk)[1]
        case["state_effect"] = float((zero_s - got_s).abs().max())
        check(case["state_effect"] > 1e-2, f"ssd {name}: the initial state reaches the end")
    if timed:
        q = min(chunk, t)
        y = torch.empty(b, t, h, p, device=dev)
        final = torch.empty(b, h, p, n, device=dev)
        kern = lambda: ops.launch(x, bm, cm, dt, a, s0, q, y, final)  # noqa: E731
        plain = lambda: ref.ssd_chunked_ref(x, bm, cm, dt, a, state=s0, chunk=q)  # noqa: E731
        case.update(in_turns(plain, kern, None))
        case.update(card.work_bound(kernel_work("ssd", b=b, t=t, h=h, g=g, p=p, n=n, q=q,
                                                state=state, in_bytes=x.element_size())))
    del x, bm, cm, dt, got, got_s, want, want_s
    return case


def ssd_cases(card: Card) -> list[dict]:
    """``ssd`` at the hybrid prefill's shape (B 4, T 1024, 80 heads of
    P = N = 64, one B/C group, chunk 64) and at its edges: the reference's,
    then the tensor-core design's (each split of P and the B * H where the
    rule changes, a row into a second chunk, chunks under 64 rows, one row,
    the narrowest (P, N)), each asserting its route and split."""
    small = (1e-4, 2e-3)  # decays summing to about -1 over 1024 steps: the state survives
    main = (4, 1024, 80, 64, 64, 64)
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [
        ssd_case(card, "main_b4_t1024", *main, timed=True, want_split=2),
        ssd_case(card, "main_b4_t1024_state", *main, state=True, dt_range=small, seed=1),
        ssd_case(card, "main_b4_t1024_bf16", *main, dtype=bf16, timed=True, want_split=1,
                 seed=2),
        ssd_case(card, "ragged_t1000", 4, 1000, 80, 64, 64, 64, state=True, dt_range=small,
                 seed=3),
        ssd_case(card, "short_t5", 4, 5, 80, 64, 64, 64, state=True, seed=4),
        ssd_case(card, "short_t1", 4, 1, 80, 64, 64, 64, state=True, seed=5),
        ssd_case(card, "b1_t8192", 1, 8192, 80, 64, 64, 64, state=True, dt_range=(1e-5, 2e-4),
                 want_split=2, seed=6),
        ssd_case(card, "strong_decay", 4, 1024, 80, 64, 64, 64, dt_a=-50.0, seed=7),
        ssd_case(card, "groups_g2_h4", 2, 256, 4, 64, 64, 64, g=2, state=True, dt_range=small,
                 seed=8),
    ]
    for t, h, p, n, chunk in ((64, 2, 32, 16, 16), (32, 3, 16, 8, 8), (48, 1, 64, 32, 48)):
        for dtype in (torch.float32, torch.bfloat16):  # tests/test_kernels.py's sweep
            cases.append(ssd_case(card, f"sweep_t{t}_h{h}_p{p}_n{n}_q{chunk}_{str(dtype)[6:]}",
                                  2, t, h, p, n, chunk, g=h, seed=9, dtype=dtype))
    # bf16 splits P in 1, 2 or 4 at B * H >= 2 SMs, >= 1 SM, below; float32 in 2
    for bh, split in ((2 * sms - 1, 2), (2 * sms, 1), (sms - 1, 4), (sms, 2)):
        cases.append(ssd_case(card, f"split{split}_bh{bh}_bf16", 1, 130, bh, 64, 64, 64,
                              state=True, dt_range=small, dtype=bf16, want_split=split,
                              seed=10))
    cases += [
        ssd_case(card, f"split2_bh{2 * sms}_f32", 1, 130, 2 * sms, 64, 64, 64, state=True,
                 dt_range=small, want_split=2, seed=11),
        ssd_case(card, "b1_h80_bf16", 1, 1024, 80, 64, 64, 64, state=True, dt_range=small,
                 dtype=bf16, want_split=4, seed=12),
        ssd_case(card, "p64_n32_split4_bf16", 1, 130, 4, 64, 32, 64, state=True,
                 dt_range=small, dtype=bf16, want_split=4, seed=13),
    ]
    for dtype in (torch.float32, bf16):
        tag = str(dtype)[6:]
        cases += [
            ssd_case(card, f"t65_{tag}", 2, 65, 8, 64, 64, 64, state=True, dt_range=small,
                     dtype=dtype, seed=14),
            ssd_case(card, f"t17_{tag}", 2, 17, 8, 64, 64, 64, state=True, dt_range=small,
                     dtype=dtype, seed=15),
            ssd_case(card, f"chunk48_t200_{tag}", 2, 200, 8, 64, 64, 48, state=True,
                     dt_range=small, dtype=dtype, seed=16),
            ssd_case(card, f"chunk1_t40_{tag}", 2, 40, 8, 64, 64, 1, state=True,
                     dt_range=small, dtype=dtype, seed=17),
            ssd_case(card, f"p16_n8_g3_{tag}", 2, 100, 6, 16, 8, 64, g=3, state=True,
                     dt_range=small, dtype=dtype, want_split=1, seed=18),
        ]
    torch.cuda.empty_cache()
    return cases


def _both_bounds(c: dict) -> str:
    """The two bounds of a scan kernel's case (``Card.work_bound``), printed."""
    return (f"float32 pipes {c['bound_ms_fma']:.4f} ms by {c['bound_by_fma']}, "
            f"{c['bound_tensor_type']} tensor cores {c['bound_ms_tensor']:.4f} ms by "
            f"{c['bound_by_tensor']}")


def _print_ssd_case(c: dict) -> None:
    times = ""
    if "ms" in c:
        times = (f" kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms library=none "
                 f"bound={c['bound_ms']:.4f} ms ({c['bound_by']}; {c['bound_card']}; "
                 f"{_both_bounds(c)})")
    print(f"ssd {c['case']}: B={c['B']} T={c['T']} H={c['H']} G={c['G']} P={c['P']} N={c['N']} "
          f"chunk={c['chunk']} state={c['state']} {c['dtype']} route={c['route']} "
          f"split={c['split']} max_abs_err={c['max_abs_err']:.3g} "
          f"rel_norm_err={c['rel_norm_err']:.3g} (max |y| {c['max_abs_out']:.4g}){times}",
          flush=True)


# The backward kernels of wkv6 and ssd against their plain backwards on the
# card: each gradient's relative norm error under 1e-4 where it is float32
# and under 1e-2 where it is bf16 (dr, dk, dv, dx, dB, dC in the operands'
# type: one rounding of each); two calls equal bit for bit (no atomics).
# Under extreme decay (a log-decay of -50 a step) the log-decays' gradient is
# the cancellation of sums of terms the size of the other gradients and
# vanishes in exact arithmetic, so there every gradient is held within 1e-4
# of the largest entry of any (and ddt, which carries it times |a| = 50,
# within 1e-3).
BWD_REL_NORM = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def check_bwd(kernel: str, name: str, names, got, again, want, *, extreme: bool) -> dict:
    """Holds one backward call's gradients to the plain backward's; returns
    the largest errors."""
    errs, rels = {}, {}
    scale = max(float(w.float().abs().max()) for w in want)
    for what, g, w, g2 in zip(names, got, want, again):
        check(g.shape == w.shape and bool(torch.isfinite(g.float()).all()),
              f"{kernel} {name} d{what}: shape {tuple(g.shape)} and finite")
        check(torch.equal(g, g2), f"{kernel} {name} d{what}: two calls give the same bits")
        errs[what] = float((g.float() - w.float()).abs().max())
        rels[what] = rel_norm(g, w)
        if extreme:
            lim = (1e-3 if what == "dt" else 1e-4) * scale
            check(errs[what] <= lim, f"{kernel} {name} d{what}: max abs error {errs[what]} > "
                                     f"{lim} (extreme decay)")
        else:
            lim = BWD_REL_NORM[g.dtype]
            check(rels[what] < lim, f"{kernel} {name} d{what}: relative norm error "
                                    f"{rels[what]} >= {lim}")
    return {"max_abs_err": max(errs.values()), "rel_norm_err": max(rels.values()),
            "max_abs": scale, "max_abs_err_by_grad": errs, "rel_norm_err_by_grad": rels}


def wkv6_bwd_case(card, name, b, t, h, dk, *, u_rows=1, state=False, dstate=False, ld=None,
                  dtype=torch.float32, timed=False, seed=0):
    """The wkv6 backward kernel vs the plain backward on the card at one
    shape: r, k, v and the output's gradient in ``dtype``, log-decays as
    ``wkv6_case`` draws them, u of ``u_rows`` rows (a vmapped call's peers
    folded into the batch), a random initial state and final-state gradient
    where asked."""
    from repro_torch.kernels.rwkv6 import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v, dout = (torch.randn(b, t, h, dk, generator=gen, device=dev).to(dtype)
                     for _ in range(4))
    if isinstance(ld, float):
        logd = torch.full((b, t, h, dk), ld, device=dev)
    else:
        low, high = ld or (0.01, 4.0)
        logd = -(low + (high - low) * torch.rand(b, t, h, dk, generator=gen, device=dev))
    u = 0.5 * torch.randn(*((u_rows,) if u_rows > 1 else ()), h, dk, generator=gen, device=dev)
    s0 = torch.randn(b, h, dk, dk, generator=gen, device=dev) if state else None
    ds = torch.randn(b, h, dk, dk, generator=gen, device=dev) if dstate else None
    args = (r, k, v, logd, u, s0, dout, ds)
    got = ops.wkv6_bwd(*args)
    again = ops.wkv6_bwd(*args)
    want = ref.wkv6_bwd_ref(*args)
    torch.cuda.synchronize()
    for g, x in zip(got, (r, k, v, logd, u)):
        check(g.dtype == x.dtype, f"wkv6_bwd {name}: a gradient in its operand's type")
    names = ("r", "k", "v", "logdecay", "u", "state")
    case = {"case": name, "B": b, "T": t, "H": h, "dk": dk, "u_rows": u_rows, "state": state,
            "dstate": dstate, "dtype": str(dtype).removeprefix("torch."),
            **check_bwd("wkv6_bwd", name, names, got, again, want,
                        extreme=isinstance(ld, float))}
    del got, again, want
    if timed:
        rkv = ops._rkv_dtype(r, k, v)
        outs = [torch.empty(b, t, h, dk, dtype=rkv, device=dev) for _ in range(3)]
        dld = torch.empty(b, t, h, dk, device=dev)
        du, scratch = torch.empty_like(u), ops.bwd_scratch(b, t, h, dk, dev)
        ds_in = torch.empty(b, h, dk, dk, device=dev)
        kern = lambda: ops.launch_bwd(r, k, v, logd, u, s0, dout, ds, *outs, dld, du,  # noqa: E731
                                      scratch, ds_in)
        plain = lambda: ref.wkv6_bwd_ref(*args)  # noqa: E731
        case.update(in_turns(plain, kern, None))
        # the token-by-token count on the tensor cores too, at the operands' rate
        case.update(card.work_bound(kernel_work(
            "wkv6_bwd", b=b, t=t, h=h, dk=dk, in_bytes=r.element_size(), u_rows=u_rows,
            state=state, dstate=dstate)))
    del r, k, v, dout, logd, u, s0, ds
    torch.cuda.empty_cache()
    return case


def wkv6_bwd_cases(card: Card) -> list[dict]:
    """The wkv6 backward at the trained rwkv6-7b round's shape (K = 2 peers x
    batch 2 folded into B 4, T 1024, 64 heads of 64, bf16, each peer's u a
    row, a state in (the loss hands the kernel zeros), no final-state
    gradient), which is also the served prefill's batch of 4; then with a
    final-state gradient in float32, ragged, at the narrower heads (the
    reduced configs' 32, seqmnist's 16), one token, extreme decay, and
    across many chunk and sub-chunk boundaries: 4096 tokens in bf16 and
    extreme decay over 1024."""
    small = (1e-4, 2e-3)  # decays summing to about -1 over 1024 tokens: the state survives
    bf16 = torch.bfloat16
    return [
        wkv6_bwd_case(card, "trained_k2_b2_t1024_bf16", 4, 1024, 64, 64, u_rows=2, state=True,
                      dtype=bf16, timed=True, seed=31),
        wkv6_bwd_case(card, "b4_t1024_state_dstate_f32", 4, 1024, 64, 64, state=True,
                      dstate=True, ld=small, timed=True, seed=32),
        wkv6_bwd_case(card, "ragged_t1000_bf16", 2, 1000, 8, 64, u_rows=2, state=True,
                      dstate=True, ld=small, dtype=bf16, seed=33),
        wkv6_bwd_case(card, "reduced_dk32_f32", 4, 32, 4, 32, u_rows=2, state=True,
                      dstate=True, seed=34),
        wkv6_bwd_case(card, "seqmnist_dk16_f32", 64, 196, 4, 16, state=True, dstate=True,
                      seed=35),
        wkv6_bwd_case(card, "t1_dk64", 2, 1, 4, 64, state=True, dstate=True, seed=36),
        wkv6_bwd_case(card, "extreme_decay", 2, 256, 8, 64, state=True, dstate=True, ld=-50.0,
                      seed=37),
        wkv6_bwd_case(card, "b1_t4096_bf16", 1, 4096, 64, 64, state=True, dstate=True,
                      ld=small, dtype=bf16, seed=38),
        wkv6_bwd_case(card, "extreme_decay_t1024", 2, 1024, 8, 64, state=True, dstate=True,
                      ld=-50.0, seed=39),
    ]


def _print_wkv6_bwd_case(c: dict) -> None:
    times = ""
    if "ms" in c:
        times = (f" kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms library=none "
                 f"bound={c['bound_ms']:.4f} ms ({c['bound_by']}; {c['bound_card']}; "
                 f"{_both_bounds(c)})")
    print(f"wkv6_bwd {c['case']}: B={c['B']} T={c['T']} H={c['H']} dk={c['dk']} "
          f"u_rows={c['u_rows']} state={c['state']} dstate={c['dstate']} {c['dtype']} "
          f"max_abs_err={c['max_abs_err']:.3g} rel_norm_err={c['rel_norm_err']:.3g} (max |grad| "
          f"{c['max_abs']:.4g}; by gradient {json.dumps(c['rel_norm_err_by_grad'])}){times}",
          flush=True)


def ssd_bwd_case(card, name, b, t, h, p, n, *, g=1, a_rows=1, state=False, dstate=False,
                 dt_range=(0.01, 1.0), dt_a=None, dtype=torch.float32, strided=False,
                 timed=False, seed=0):
    """The ssd backward kernel vs the plain backward on the card at one
    shape: x, B and C in ``dtype`` (``strided``: views of one (B, T, H P +
    2 G N) buffer, as the model's convolution output gives them), dt and a
    as ``ssd_case`` draws them (a of ``a_rows`` rows: a vmapped call's peers
    folded into the batch), the float32 output gradient normal, a random
    initial state and final-state gradient where asked."""
    from repro_torch.kernels.mamba2 import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    if strided:
        conv = torch.randn(b, t, h * p + 2 * g * n, generator=gen, device=dev).to(dtype)
        x = conv[..., :h * p].unflatten(-1, (h, p))
        bm = conv[..., h * p:h * p + g * n].unflatten(-1, (g, n))
        cm = conv[..., h * p + g * n:].unflatten(-1, (g, n))
        check(all(ops._kernel_operand(m) is m for m in (x, bm, cm)),
              f"ssd_bwd {name}: the strided views are read in place")
    else:
        x = torch.randn(b, t, h, p, generator=gen, device=dev).to(dtype)
        bm, cm = (torch.randn(b, t, g, n, generator=gen, device=dev).to(dtype) for _ in range(2))
    low, high = dt_range
    dt = low + (high - low) * torch.rand(b, t, h, generator=gen, device=dev)
    a_shape = ((a_rows,) if a_rows > 1 else ()) + (h,)
    a = -(0.5 + 1.5 * torch.rand(*a_shape, generator=gen, device=dev))
    if dt_a is not None:
        dt, a = torch.ones(b, t, h, device=dev), torch.full(a_shape, dt_a, device=dev)
    dy = torch.randn(b, t, h, p, generator=gen, device=dev)
    s0 = torch.randn(b, h, p, n, generator=gen, device=dev) if state else None
    ds = torch.randn(b, h, p, n, generator=gen, device=dev) if dstate else None
    args = (x, bm, cm, dt, a, s0, dy, ds)
    got = ops.ssd_bwd(*args)
    again = ops.ssd_bwd(*args)
    want = ref.ssd_bwd_ref(*args)
    torch.cuda.synchronize()
    for gr, m in zip(got, (x, bm, cm, dt, a)):
        check(gr.dtype == m.dtype, f"ssd_bwd {name}: a gradient in its operand's type")
    names = ("x", "b", "c", "dt", "a", "state")
    case = {"case": name, "B": b, "T": t, "H": h, "G": g, "P": p, "N": n, "a_rows": a_rows,
            "state": state, "dstate": dstate, "strided": strided,
            "dtype": str(dtype).removeprefix("torch."),
            **check_bwd("ssd_bwd", name, names, got, again, want, extreme=dt_a is not None)}
    del got, again, want
    if timed:
        dx = torch.empty(b, t, h, p, dtype=dtype, device=dev)
        db, dc = (torch.empty(b, t, g, n, dtype=dtype, device=dev) for _ in range(2))
        ddt, da = torch.empty_like(dt), torch.empty_like(a)
        scratch = ops.bwd_scratch(b, t, h, p, n, dev)
        ds_in = torch.empty(b, h, p, n, device=dev)
        kern = lambda: ops.launch_bwd(x, bm, cm, dt, a, s0, dy, ds, dx, db, dc,  # noqa: E731
                                      ddt, da, scratch, ds_in)
        plain = lambda: ref.ssd_bwd_ref(*args)  # noqa: E731
        case.update(in_turns(plain, kern, None))
        # the token-by-token count on the tensor cores too, at the operands' rate
        case.update(card.work_bound(kernel_work(
            "ssd_bwd", b=b, t=t, h=h, g=g, p=p, n=n, in_bytes=x.element_size(), a_rows=a_rows,
            state=state, dstate=dstate)))
    del x, bm, cm, dt, a, dy, s0, ds
    torch.cuda.empty_cache()
    return case


def ssd_bwd_cases(card: Card) -> list[dict]:
    """The ssd backward at the trained zamba2-2.7b round's shape (K = 2
    peers x batch 1 folded into B 2, T 1024, 80 heads of P = N = 64, one
    B/C group, bf16 views of the convolution's output, each peer's a a row,
    a state in (the loss hands the kernel zeros), no final-state gradient)
    and the served prefill's batch of 4; then with a final-state gradient in
    float32, ragged with G = 2 over H = 4, the reduced configs' (P, N) =
    (32, 16), the narrowest (16, 8), one token, and strong decay."""
    small = (1e-4, 2e-3)
    bf16 = torch.bfloat16
    zamba = (1024, 80, 64, 64)
    return [
        ssd_bwd_case(card, "trained_k2_b1_t1024_bf16", 2, *zamba, a_rows=2, state=True,
                     dtype=bf16, strided=True, timed=True, seed=41),
        ssd_bwd_case(card, "served_b4_t1024_bf16", 4, *zamba, state=True, dtype=bf16,
                     strided=True, timed=True, seed=42),
        ssd_bwd_case(card, "b2_t1024_state_dstate_f32", 2, *zamba, state=True, dstate=True,
                     dt_range=small, timed=True, seed=43),
        ssd_bwd_case(card, "ragged_t1000_g2_h4_bf16", 2, 1000, 4, 64, 64, g=2, a_rows=2,
                     state=True, dstate=True, dt_range=small, dtype=bf16, seed=44),
        ssd_bwd_case(card, "reduced_p32_n16_f32", 4, 32, 8, 32, 16, a_rows=2, state=True,
                     dstate=True, strided=True, seed=45),
        ssd_bwd_case(card, "p64_n32_f32", 2, 200, 4, 64, 32, g=2, state=True, dstate=True,
                     seed=46),
        ssd_bwd_case(card, "p16_n8_g3_f32", 2, 100, 6, 16, 8, g=3, state=True, dstate=True,
                     seed=47),
        ssd_bwd_case(card, "t1", 2, 1, 8, 64, 64, state=True, dstate=True, seed=48),
        ssd_bwd_case(card, "strong_decay", 2, 256, 8, 64, 64, state=True, dstate=True,
                     dt_a=-50.0, seed=49),
    ]


def _print_ssd_bwd_case(c: dict) -> None:
    times = ""
    if "ms" in c:
        times = (f" kernel={c['ms']:.4f} ms plain={c['plain_ms']:.4f} ms library=none "
                 f"bound={c['bound_ms']:.4f} ms ({c['bound_by']}; {c['bound_card']}; "
                 f"{_both_bounds(c)})")
    print(f"ssd_bwd {c['case']}: B={c['B']} T={c['T']} H={c['H']} G={c['G']} P={c['P']} "
          f"N={c['N']} a_rows={c['a_rows']} state={c['state']} dstate={c['dstate']} "
          f"strided={c['strided']} {c['dtype']} max_abs_err={c['max_abs_err']:.3g} "
          f"rel_norm_err={c['rel_norm_err']:.3g} (max |grad| {c['max_abs']:.4g}; by gradient "
          f"{json.dumps(c['rel_norm_err_by_grad'])}){times}", flush=True)


def check_kernels(card: Card) -> dict[str, list[dict]]:
    """Build the nine kernels and hold each against its plain version at its
    shapes; the three consensus kernels' mass mode under "<kernel> mass",
    ``consensus_mix``'s snapshot mode under "consensus_mix snapshot" and its
    bf16 mode under "consensus_mix bf16", and adaptive rounds' dense
    operands under "<kernel> dense"."""
    from repro_torch.configs import get_config
    from repro_torch.core.p2p import layout_of, row_align
    from repro_torch.models import transformer as tf

    build_kernels()
    layout = layout_of("mnist_mlp")
    row = layout.row  # 199,210 parameters -> 199,212
    align = row_align(torch.bfloat16)
    bf16_row = lambda n: -(-n // align) * align  # noqa: E731
    lm_size = sum(math.prod(s) for s in tf.decoder_param_shapes(get_config(LM_ARCH)).values())
    cases = {"consensus_mix": consensus_cases(card, row),
             "dequant_mix": dequant_cases(card, layout), "segment_mix": segment_cases(card),
             "wkv6": wkv6_cases(card), "wkv6_bwd": wkv6_bwd_cases(card),
             "flash_attention": flash_cases(card),
             "flash_attention_bwd": flash_bwd_cases(card), "ssd": ssd_cases(card),
             "ssd_bwd": ssd_bwd_cases(card),
             "consensus_mix bf16": consensus_bf16_cases(card, bf16_row(lm_size),
                                                        bf16_row(layout.size))}
    for kernel, kcases in mass_cases(card).items():
        cases[f"{kernel} mass"] = kcases
    cases["consensus_mix snapshot"] = snapshot_cases(card)
    for kernel, kcases in dense_cases(card).items():
        cases[f"{kernel} dense"] = kcases
    for kernel, kcases in bf16_mode_cases(card, bf16_row(lm_size), bf16_row(layout.size)).items():
        cases[f"{kernel} bf16 modes"] = kcases
    cases["segment_mix slots"] = slot_cases(card)
    for kernel, kcases in cases.items():
        for c in kcases:
            if kernel == "wkv6":
                _print_wkv6_case(c)
            elif kernel == "wkv6_bwd":
                _print_wkv6_bwd_case(c)
            elif kernel == "ssd_bwd":
                _print_ssd_bwd_case(c)
            elif kernel == "flash_attention":
                _print_flash_case(c)
            elif kernel == "flash_attention_bwd":
                _print_flash_bwd_case(c)
            elif kernel == "ssd":
                _print_ssd_case(c)
            elif kernel == "segment_mix slots":
                _print_slot_case(c)
            else:
                _print_case(kernel, c)
            if "sparse_d1_ms" in c:
                print(f"{kernel} {c['case']}: the same matching on D = 1 sparse operands "
                      f"{c['sparse_d1_ms']:.4f} ms against the dense D = {c['D']} "
                      f"{c['dense_ms_same_call']:.4f} ms (same call)", flush=True)
    return cases


def recheck_consensus(name: str, exp, state, data, *, mix_mode=None) -> None:
    """One more round's consensus phase through the kernel, held against the
    plain version on the same post-local state (S = 1); ``mix_mode``
    "segment" rechecks the one-slice hierarchical runtime's phase.  A
    push-sum run is held to the plain versions of the mass mode, its new
    mass included; a bounded-staleness run to the snapshot mode's, on the
    round's delivery and age-decayed operands, its published buffer and ages
    included; an adaptive run on the round's dense operands, selected from
    the state as the round step selects them."""
    from repro_torch import compression
    from repro_torch.core import p2p, protocols, task as task_lib
    from repro_torch.kernels.consensus_mix import ops as cm_ops
    from repro_torch.kernels.consensus_mix import ref
    from repro_torch.launch import train

    cfg = exp.p2p
    check(cfg.consensus_steps == 1 and not cfg.use_affinity_b, f"{name}: one plain step")
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = np.asarray([len(p[0]) for p in parts])
    batches = task.make_peer_batches(parts, exp.batch_size, seed=1).round_batches_on(
        cfg.local_steps, torch.device("cuda"))
    after_local, _ = p2p.local_phase(state, task, batches, cfg, steps_k=p2p.steps_budget(cfg))
    if cfg.schedule == "adaptive":
        sparse, _ = p2p.adaptive_operands(
            state.adaptive, cfg, p2p.round_operands(cfg, sizes, device="cuda")[0])
        check(sparse.nbr_idx.shape[1] == cfg.num_peers - 1, f"{name}: dense operands")
    else:
        ops_s = p2p.schedule_operands(cfg, sizes, device="cuda")
        sparse = cm_ops.select_round(ops_s, after_local.round_idx)
    comp = compression.from_config(cfg)
    push_sum = cfg.protocol == "push_sum"
    # push-sum: the plain versions of the mass mode take the mass after x
    mass = (after_local.protocol.mass,) if push_sum else ()
    if mix_mode == "segment":
        after_cons = p2p.consensus_phase_hier(after_local, cfg, ops_s, mix_mode=mix_mode)
        plain = ref.segment_mix_push_sum_stacked_ref if push_sum else ref.segment_mix_stacked_ref
        out = plain(after_local.params, *mass, *sparse, cfg.local_steps)
    elif cfg.staleness_bound > 0:
        pick, _ = p2p.round_picker(cfg, sizes, device="cuda")
        stale = pick(after_local.round_idx)
        after_cons = p2p.consensus_phase(after_local, cfg, stale)
        st = after_local.staleness
        delivered, age, decay = p2p.staleness_delivery(cfg, stale.scheduled, st.age)
        published = torch.where(delivered[:, None], after_local.params, st.published)
        a_ops = protocols.age_decayed_operands(
            stale, decay, protocols.get_protocol(cfg.protocol).stochasticity)
        plain = (ref.consensus_mix_push_sum_stacked_ref if push_sum
                 else ref.consensus_mix_stacked_ref)
        out = plain(after_local.params, *mass, *a_ops, cfg.local_steps, published=published)
        check(torch.equal(after_cons.staleness.published, published)
              and torch.equal(after_cons.staleness.age, age), f"{name}: published buffer")
        check(int(age.max()) <= cfg.staleness_bound, f"{name}: ages within the bound")
    elif comp.identity:
        after_cons = p2p.consensus_phase(after_local, cfg, sparse)
        plain = (ref.consensus_mix_push_sum_stacked_ref if push_sum
                 else ref.consensus_mix_stacked_ref)
        out = plain(after_local.params, *mass, *sparse, cfg.local_steps)
    else:
        after_cons = p2p.consensus_phase(after_local, cfg, sparse)
        layout = p2p.layout_of(cfg.model)
        payload = comp.ef_flat(after_local.params, after_local.compression, layout)
        plain = (ref.dequant_mix_push_sum_stacked_ref if push_sum
                 else ref.dequant_mix_stacked_ref)
        out = plain(after_local.params, payload.est, payload.q, payload.scale,
                    layout.leaf_offsets, *mass, *sparse, cfg.local_steps)
        torch.testing.assert_close(after_cons.compression, out[2], **TOL)
    mixed, d_bias = out[0], out[1]
    if push_sum:
        torch.testing.assert_close(after_cons.protocol.mass, out[-1], **TOL)
    torch.testing.assert_close(after_cons.params, mixed, **TOL)
    if cfg.use_affinity_d:
        torch.testing.assert_close(after_cons.d_bias, d_bias, **TOL)
    print(f"{name}: consensus of one more round matches the plain version")


def launch_counters() -> dict:
    from repro_torch.kernels.consensus_mix import dequant, ops, segment
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops

    return {"consensus_mix": ops.launches, "dequant_mix": dequant.launches,
            "segment_mix": segment.launches, "wkv6": wkv6_ops.launches,
            "wkv6_bwd": wkv6_ops.bwd_launches, "flash_attention": flash_ops.launches,
            "flash_attention_bwd": flash_ops.bwd_launches, "ssd": ssd_ops.launches,
            "ssd_bwd": ssd_ops.bwd_launches}


@contextlib.contextmanager
def count_plain_calls():
    """Counts the calls of the consensus kernels' plain versions (every
    ``*_ref`` function of ``kernels.consensus_mix.ref``) while active:
    yields a dict name -> calls."""
    from repro_torch.kernels.consensus_mix import ref

    calls: dict[str, int] = {}
    names = [n for n in dir(ref) if n.endswith("_ref") and callable(getattr(ref, n))]
    real = {n: getattr(ref, n) for n in names}

    def counted(n):
        def call(*args, **kwargs):
            calls[n] = calls.get(n, 0) + 1
            return real[n](*args, **kwargs)
        return call

    for n in names:
        setattr(ref, n, counted(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(ref, n, real[n])


def drive(name: str, exp, rounds: int, data, *, recheck: bool, mix_mode: str | None = None,
          **run_kw) -> dict:
    """Train ``exp`` for ``rounds`` rounds through ``run_paper_experiment`` on
    the card (its default scan driver, evaluating every round), every launch
    count set to 0 just before and read just after;
    checks that the path's kernel launched rounds x S times, the others and
    every plain version none, and that the run's numbers are sane.
    ``mix_mode`` "segment" with ``peer_axis="pod"`` runs the one-slice
    hierarchical runtime.  A push-sum run also checks after every round that
    the mass sums to K within 1e-5 K and stays positive."""
    from repro_torch.launch import train

    push_sum = exp.p2p.protocol == "push_sum"
    sums = []

    def watch_mass(r, state):
        mass = state.protocol.mass
        k = mass.shape[0]
        total = float(mass.double().sum())
        sums.append(total)
        check(abs(total - k) <= 1e-5 * k, f"{name} round {r}: sum y = {total}, want {k}")
        check(bool((mass > 0).all()), f"{name} round {r}: y > 0")

    counters = launch_counters()
    if mix_mode == "segment":
        kernel = "segment_mix"
        run_kw["mix_mode"] = mix_mode
    else:
        kernel = "consensus_mix" if exp.p2p.compressor == "none" else "dequant_mix"
    want = {key: 0 for key in counters}
    want[kernel] = rounds * exp.p2p.consensus_steps
    print(f"main path: {name}, {rounds} rounds", flush=True)
    torch.cuda.reset_peak_memory_stats()
    for counter in counters.values():
        counter.reset()
    with count_plain_calls() as plain_calls:
        log, state = train.run_paper_experiment(
            exp, rounds=rounds, data=data, device="cuda", verbose=True, return_state=True,
            on_round=watch_mass if push_sum else None, **run_kw)
    launches = {key: counter.count for key, counter in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == want, f"{name} launched {launches}, want {want}")
    check(not plain_calls, f"{name} called plain versions {plain_calls}")
    check(len(sums) == (rounds if push_sum else 0), f"{name}: mass watched every round")
    check(all(math.isfinite(v) for v in log.train_loss), f"{name} losses finite")
    acc = log.series("all").mean(axis=1)
    check(bool(np.all((acc >= 0) & (acc <= 1))), f"{name} accuracies in [0, 1]")
    check(bool(torch.isfinite(state.params).all()), f"{name} parameters finite")
    if recheck:
        recheck_consensus(name, exp, state, data, mix_mode=mix_mode)
    print(f"{name}: launches {launches}, plain-version calls {plain_calls}, seconds per round "
          f"{log.seconds}, peak memory {peak_gb:.3f} GB"
          + (f", sum of the mass after each round {sums}" if push_sum else ""))
    return {"launches": {kernel: launches[kernel]}, "peak_gb": peak_gb, "seconds": log.seconds,
            "mode": "mass" if push_sum else "gossip", "mass_sums": sums}


def compare_drivers(card: Card, name: str, exp, rounds: int, eval_every: int, data, *,
                    kernel: str, **run_kw) -> dict:
    """``run_paper_experiment`` of ``exp`` under both drivers, the python one
    first, from the same seed and rounds, every launch count set to 0 just
    before and read just after each run and every plain version's calls
    counted (none allowed): the final state (params, momentum, d, b,
    push-sum's mass, the compressed wire's estimate) equal bit for bit, the
    logged losses and accuracies equal, and the same launches (the scan
    driver's counted on replay: ``repro_torch.capture``), ``kernel``'s
    rounds x S.  Prints seconds per round both ways over the eval periods
    after the first (the scan driver's first holds its warm-up round and
    capture), the capture seconds and the peak memory both ways."""
    from repro_torch.core import p2p
    from repro_torch.launch import train

    counters = launch_counters()
    want = {key: 0 for key in counters} | {kernel: rounds * exp.p2p.consensus_steps}
    runs = {}
    for driver in ("python", "scan"):
        print(f"main path: {name}, {rounds} rounds, eval every {eval_every}, driver {driver}",
              flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for counter in counters.values():
            counter.reset()
        with count_plain_calls() as plain_calls:
            log, state = train.run_paper_experiment(
                exp, rounds=rounds, data=data, eval_every=eval_every, device="cuda",
                driver=driver, return_state=True, **run_kw)
        launches = {key: counter.count for key, counter in counters.items()}
        check(launches == want, f"{name} ({driver}) launched {launches}, want {want}")
        check(not plain_calls, f"{name} ({driver}) called plain versions {plain_calls}")
        check(all(math.isfinite(v) for v in log.train_loss), f"{name} ({driver}) losses finite")
        runs[driver] = {"log": log, "state": state, "launches": launches,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    python, scan = runs["python"], runs["scan"]
    final = scan["state"]
    if exp.p2p.protocol == "push_sum":
        total = float(final.protocol.mass.double().sum())
        check(abs(total - exp.p2p.num_peers) <= 1e-5 * exp.p2p.num_peers,
              f"{name}: sum y = {total}")
    if exp.p2p.staleness_bound > 0:
        check(int(final.staleness.age.max()) <= exp.p2p.staleness_bound,
              f"{name}: ages within the bound")
    leaves = list(zip(p2p.state_leaves(python["state"]), p2p.state_leaves(scan["state"])))
    check(len(p2p.state_leaves(python["state"])) == len(p2p.state_leaves(scan["state"])),
          f"{name}: state structure")
    for i, (a, b) in enumerate(leaves):
        check(torch.equal(a, b), f"{name}: state leaf {i} differs between the drivers, max "
                                 f"|diff| {float((a - b).abs().max())}")
    check(python["state"].round_idx == scan["state"].round_idx == rounds, f"{name}: rounds")
    check(python["log"].train_loss == scan["log"].train_loss, f"{name}: logged losses differ")
    for group in python["log"].after_local:
        for phase in ("local", "consensus"):
            check(np.array_equal(python["log"].series(group, phase),
                                 scan["log"].series(group, phase)),
                  f"{name}: logged {phase} accuracies of {group} differ")
    out = {"card": card.line, "rounds": rounds, "eval_every": eval_every,
           "state_leaves_equal": len(leaves), "launches_per_round": {
               d: runs[d]["launches"][kernel] / rounds for d in runs},
           "s_per_round_after_first_period": {
               d: float(np.mean(runs[d]["log"].seconds[1:])) for d in runs},
           "first_period_s_per_round": {d: runs[d]["log"].seconds[0] for d in runs},
           "capture_s": scan["log"].capture_seconds,
           "peak_gb": {d: runs[d]["peak_gb"] for d in runs}}
    if exp.p2p.num_peers == 100 and not run_kw and exp.p2p.compressor == "none" \
            and not exp.p2p.use_async:
        # what the body's copy of the round's state into the carried buffers
        # costs at most: every (K, row) leaf copied once
        src = p2p.state_leaves(scan["state"])
        dst = [t.clone() for t in src]
        out["carry_copy_all_leaves_ms"] = cuda_ms(
            lambda: [d.copy_(t) for d, t in zip(dst, src)])
        del dst
    print(f"drivers {name} ({card.line}): {json.dumps(out)}", flush=True)
    return {"launches": {kernel: scan["launches"][kernel]}, **out}


def phase_breakdown(exp, data, rounds: int = 3) -> dict:
    """Where one round's time goes: mean seconds of each phase over ``rounds``
    rounds after a warm-up round, each phase ended by a device synchronize;
    then one more round under torch.profiler for the device's busy share."""
    from repro_torch.core import p2p, task as task_lib
    from repro_torch.launch import train

    dev = torch.device("cuda")
    cfg = exp.p2p
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = np.asarray([len(p[0]) for p in parts])
    batcher = task.make_peer_batches(parts, exp.batch_size, seed=0)
    state = p2p.init_state(task, cfg, data_sizes=sizes, device=dev)
    sparse = p2p.round_operands(cfg, sizes, device=dev)[0]
    x_eval = torch.as_tensor(data[2], device=dev)
    y_eval = torch.as_tensor(data[3], dtype=torch.int64, device=dev)
    groups = {"all": np.arange(10)}

    def one_round(st, times=None):
        marks = [time.perf_counter()]
        batches = batcher.round_batches_on(cfg.local_steps, dev)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        after_local, _ = p2p.local_phase(st, task, batches, cfg)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        after_cons = p2p.consensus_phase(after_local, cfg, sparse)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for s in (after_local, after_cons):
            p2p.stratified_accuracy(task.apply_fn, p2p.param_views(s, task), x_eval, y_eval,
                                    groups)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if times is not None:
            for name, a, b in zip(("batches", "local", "consensus", "eval"), marks, marks[1:]):
                times.setdefault(name, []).append(b - a)
        return after_cons

    state = one_round(state)  # warm-up: cuBLAS handles, allocator, autograd
    times: dict[str, list] = {}
    for _ in range(rounds):
        state = one_round(state, times)
    out = {name: sum(v) / len(v) for name, v in times.items()}

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        batches = batcher.round_batches_on(cfg.local_steps, dev)
        after_local, _ = p2p.local_phase(state, task, batches, cfg)
        p2p.consensus_phase(after_local, cfg, sparse)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
    # device-side entries only: the aten ops' rows repeat their kernels' time
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    out["profiled_round_s"] = wall_s
    out["device_busy_s"] = device_s
    out["device_busy_share"] = device_s / wall_s if device_s > 0 else None
    out["top_kernels_ms"] = [(e.key[:70], e.count, e.self_device_time_total / 1e3)
                             for e in top[:6]]
    return out


def drive_large_k(exp, rounds: int, data) -> dict:
    """``exp`` at K = LARGE_K peers, full width, on the one-slice segment
    runtime: ``rounds`` rounds through the python driver's round function,
    no evaluation (as the reference's K = 4096 test drives its round step;
    the rounds are device-bound at about 2 s), launch counts
    reset just before and read just after, peak memory beside the size of
    the four state buffers (params, momentum, d, b).  The initial params,
    the last round's post-local params and its consensus's params and d are
    kept under "_kept" (shareable copies, ``peer_group.shared_copy``), with
    the peers' shards and data sizes, for the hierarchical runtime's ranks
    to start from and to mix again."""
    from repro_torch.core import p2p, peer_group, task as task_lib
    from repro_torch.data import partition
    from repro_torch.launch import train

    dev = torch.device("cuda")
    cfg = exp.p2p
    k = cfg.num_peers
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = partition.data_sizes(parts)
    batcher = task.make_peer_batches(parts, exp.batch_size, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    state = p2p.init_state(task, cfg, data_sizes=sizes, device=dev)
    round_fn = p2p.make_hier_round_fn(task, cfg, sizes, peers_per_device=k, mix_mode="segment",
                                      device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    init = peer_group.shared_copy(state.params)  # the hierarchical rounds' start, kept
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()
    print(f"main path: 2NN at K={k} on a {cfg.topology}, one-slice segment runtime, "
          f"{rounds} rounds", flush=True)
    seconds, losses = [], []
    for _ in range(rounds):
        start = time.perf_counter()
        batches = batcher.round_batches_on(cfg.local_steps, dev)
        after_local, state, loss = round_fn(state, batches)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        losses.append(float(loss.mean()))
    launches = {key: counter.count for key, counter in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_gb = 4 * state.params.numel() * 4 / 1e9
    want = {key: 0 for key in counters} | {"segment_mix": rounds * cfg.consensus_steps}
    check(launches == want, f"K={k} launched {launches}, want {want}")
    check(all(math.isfinite(v) for v in losses), f"K={k} losses finite")
    for field in ("params", "momentum", "d_bias", "b_bias"):
        check(bool(torch.isfinite(getattr(state, field)).all()), f"K={k} {field} finite")
    check(state.round_idx == rounds, f"K={k} ran {state.round_idx} rounds")
    print(f"K={k}: launches {launches}, set-up {setup_s:.3f} s, seconds per round {seconds}, "
          f"losses {losses}, peak memory {peak_gb:.3f} GB against {state_gb:.3f} GB for the "
          f"four (K, {state.params.shape[1]}) state buffers", flush=True)
    del batches
    kept = {"init": init, "post_local": peer_group.shared_copy(after_local.params),
            "parts": parts, "sizes": sizes, "round": rounds - 1}
    del after_local
    kept |= {"params": peer_group.shared_copy(state.params),
             "d": peer_group.shared_copy(state.d_bias)}
    del state, round_fn
    torch.cuda.empty_cache()
    return {"launches": {"segment_mix": launches["segment_mix"]}, "peak_gb": peak_gb,
            "state_gb": state_gb, "seconds": seconds, "setup_s": setup_s, "_kept": kept}


LM_ARCH = "smollm-135m"
LM_REDUCED_ROUNDS = 4
# the first step's bf16 gradients, kernels against plain backwards, through
# every layer's bf16 activations: tests/test_kernels.py's bf16 tolerance,
# 5e-2, on every entry and on the relative norm of the difference (each
# backward call alone is held to 1e-2, FLASH_BWD_REL_NORM and BWD_REL_NORM)
LM_GRAD_TOL = dict(atol=5e-2, rtol=5e-2)
LM_GRAD_REL_NORM = 5e-2


@dataclasses.dataclass(frozen=True)
class LMRun:
    """One P2P LM training configuration on the card: ``run_p2p_lm``'s step
    sizes and token draws, p2pl_affinity on the complete graph, S = 1, seed 0,
    bf16; ``layers`` None is the published depth."""

    label: str
    arch: str
    layers: int | None
    peers: int
    batch: int
    seq: int
    steps: int = 4
    rounds: int = 2


LM_RUNS = (
    # smollm-135m at full width and depth, K = 4
    LMRun("p2p_lm_smollm_full", LM_ARCH, None, 4, 4, 1024),
    # rwkv6-7b at its published widths, 6 of 32 layers: the most whose
    # reckoned peak stays under 70 GB at K = 2, batch 2 (PERF.md)
    LMRun("p2p_lm_rwkv6_7b", "rwkv6-7b", 6, 2, 2, 1024),
    # zamba2-2.7b at its published widths, 42 of 54 layers (7 of the shared
    # block's 9 periods): 54 reckon over 70 GB at K = 2, batch 1 (PERF.md)
    LMRun("p2p_lm_zamba2_2_7b", "zamba2-2.7b", 42, 2, 1, 1024),
)


def lm_step_launches(cfg) -> dict:
    """The kernel launches one local step of ``cfg``'s loss makes, each way."""
    if cfg.family == "rwkv6":
        return {"wkv6": cfg.num_layers, "wkv6_bwd": cfg.num_layers}
    if cfg.family == "hybrid":
        apps = cfg.num_layers // cfg.shared_block_period
        return {"ssd": cfg.num_layers, "ssd_bwd": cfg.num_layers, "flash_attention": apps,
                "flash_attention_bwd": apps}
    if cfg.family == "encdec":  # the encoder's self-attention, then the decoder's
        layers = cfg.encoder_layers + cfg.num_layers
        return {"flash_attention": layers, "flash_attention_bwd": layers}
    return {"flash_attention": cfg.num_layers, "flash_attention_bwd": cfg.num_layers}


@contextlib.contextmanager
def plain_backwards():
    """While active, the Functions of ``flash_attention``, ``wkv6`` and
    ``ssd`` run their plain backwards on CUDA tensors too (the yardstick of
    the gradient checks): each module's backward dispatch (``attention_bwd``,
    ``wkv6_bwd``, ``ssd_bwd``) is swapped for its plain version."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops
    from repro_torch.kernels.rwkv6 import ref as wkv6_ref

    def attention(q, k, v, out, dout, lse, *, causal, window, scale):
        return ref.gqa_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal, window=window,
                                         scale=scale)

    def plain_of(ref_fn, operands: int):
        def run(*args, need_dstate=True):
            grads = ref_fn(*args)
            return (*(g.to(x.dtype) for g, x in zip(grads[:5], args[:operands])),
                    grads[5] if need_dstate else None)
        return run

    swaps = [(ops, "attention_bwd", attention),
             (wkv6_ops, "wkv6_bwd", plain_of(wkv6_ref.wkv6_bwd_ref, 5)),
             (ssd_ops, "ssd_bwd", plain_of(ssd_ref.ssd_bwd_ref, 5))]
    real = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for module, name, fn in real:
            setattr(module, name, fn)


def lm_step_grads(task, layout, blocks, batch) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The local step's stacked losses and flat gradients, one buffer a
    block of the layout, as ``local_phase`` takes them (one backward of the
    summed per-peer losses)."""
    views = layout.views(*(b.detach().requires_grad_(True) for b in blocks))
    losses = task.loss_fn(views, batch)
    grads = torch.autograd.grad(losses.sum(), list(views.values()), materialize_grads=True)
    return losses.detach(), layout.flatten_blocks(dict(zip(views, grads)))


def compare_grads(name: str, layout, got: list, want: list) -> dict:
    """Holds a step's flat gradients (one buffer a block) to the plain
    backwards' leaf by leaf (``compare_grad_dicts`` on the layout's views;
    the views die with this function)."""
    return compare_grad_dicts(name, layout.views(*got), layout.views(*want))


def compare_grad_dicts(name: str, got: dict, want: dict) -> dict:
    """Holds gradients to the plain backwards' (LM_GRAD_TOL) leaf by leaf,
    2^26 entries at a time in float32 (the whole (K, row) buffer widened
    would take 15 GB at rwkv6-7b's 6 layers, zamba2's stacked in_proj alone
    9 GB); returns the relative norm errors, whole and by leaf, and the
    largest errors."""
    leaf_rel, diff2, want2, max_err, max_abs = {}, 0.0, 0.0, 0.0, 0.0
    for leaf, ga in got.items():
        gb = want[leaf]
        d2 = w2 = 0.0
        for a, b in zip(ga.reshape(-1).split(2**26), gb.reshape(-1).split(2**26)):
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"{name}: gradient of {leaf} finite")
            torch.testing.assert_close(a, b, **LM_GRAD_TOL, msg=lambda m: f"{name} d{leaf}: {m}")
            d2 += float(torch.linalg.vector_norm(a - b)) ** 2
            w2 += float(torch.linalg.vector_norm(b)) ** 2
            max_err = max(max_err, float((a - b).abs().max()))
            max_abs = max(max_abs, float(b.abs().max()))
        leaf_rel[leaf] = math.sqrt(d2 / w2) if w2 else math.sqrt(d2)
        diff2, want2 = diff2 + d2, want2 + w2
    return {"rel_norm_err": math.sqrt(diff2 / want2), "max_abs_err": max_err,
            "max_abs": max_abs, "leaf_rel_norm_err_max": max(leaf_rel.values()),
            "leaf_rel_norm_err": leaf_rel}


def lm_kernel_category(name: str) -> str:
    """The group a device kernel of the LM round is reported under."""
    if any(tag in name for tag in ("flash_wgmma", "flash_bf16", "flash_f32")):
        return "attention forward"
    if any(tag in name for tag in ("delta_f32", "delta_bf16", "dkdv_", "dq_wgmma", "dq_bf16",
                                   "dq_f32")):
        return "attention backward"
    if "wkv6_bwd" in name:
        return "wkv6 backward"
    if "wkv6" in name:
        return "wkv6 forward"
    if any(tag in name for tag in ("chunk_cums", "chunk_states", "chunk_grad", "group_reduce",
                                   "da_reduce")):
        return "ssd backward"
    if "ssd_kernel" in name:
        return "ssd forward"
    if any(tag in name for tag in ("consensus_mix", "mix_tile", "dequant_mix", "segment_")):
        return "consensus"
    if kernel_category(name) == "matmul":
        return "matmuls"
    if any(tag in name for tag in ("elementwise", "copy", "Copy", "cast")):
        return "elementwise and casts"
    return "other"


def recording_init(task):
    """``task`` with an init that records the leaves' types as it draws
    them, and that record: what ``check_leaf_types`` holds the flat buffers
    to, independent of the layout's own account of the types."""
    types = {}

    def init(gen):
        leaves = task.init_params(gen)
        types.update((leaf, v.dtype) for leaf, v in leaves.items())
        return leaves

    return dataclasses.replace(task, init_params=init), types


def check_leaf_types(name: str, init_types: dict, layout, blocks) -> None:
    """Every leaf of the flat buffers in the type the model's init drew it
    in (``recording_init``; the reference's: float32 for rwkv6's decay base
    and bonus, Mamba2's dt bias, A_log and D and a MoE router, the model's
    type for the rest)."""
    got = {leaf: v.dtype for leaf, v in layout.views(*blocks).items()}
    check(bool(init_types) and got == init_types, f"{name}: leaf types {got}, "
          f"drawn {init_types}")


def drive_p2p_lm(card: Card, run: LMRun) -> dict:
    """One slice path at published widths: P2P training of ``run.arch`` (its
    depth cut to ``run.layers`` where given; bf16) through
    ``core.task.from_model``, ``init_state`` and ``make_round_fn``: K =
    ``run.peers`` on the complete graph, ``run.batch`` x ``run.seq`` tokens,
    T = ``run.steps``, S = 1, p2pl_affinity, seed 0 (``run_p2p_lm``'s step
    sizes and token draws).  First the first local step's stacked losses
    and gradients against the same step with the plain backwards on the
    card; then ``run.rounds`` rounds, every launch count reset just before
    and read just after each (``lm_step_launches`` T times a round,
    ``consensus_mix`` S); then one more round through the two phases with
    synchronized timers, and one under torch.profiler (device ms and
    launches by ``lm_kernel_category``, the busy share, the top kernels).
    Prints s/round, the phases' seconds, the launches, the peak memory and
    the profile.  rwkv6's and Mamba2's float32 leaves sit in a float32 block
    beside the bf16 one (``ParamLayout.wide``), so their rounds mix twice a
    consensus step."""
    from repro_torch.configs import get_config
    from repro_torch.core import consensus as consensus_lib
    from repro_torch.core import p2p, task as task_lib
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model

    dev = torch.device("cuda")
    name = run.arch
    cfg = get_config(run.arch)
    if run.layers is not None:
        cfg = cfg.replace(num_layers=run.layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    task, init_types = recording_init(task_lib.from_model(build_model(cfg)))
    pcfg = train.lm_config(num_peers=run.peers, local_steps=run.steps,
                           algorithm="p2pl_affinity", lr=1e-2, momentum=0.5, eta_d=0.25)
    state = p2p.init_state(task, pcfg, seed=0, device=dev)
    round_fn = p2p.make_round_fn(task, pcfg, device=dev)
    layout = p2p.ParamLayout.of(task)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    check(state.params.dtype == torch.bfloat16 and state.params.shape == (run.peers, layout.row)
          and layout.row % 8 == 0, f"{name}: a (K, row) bf16 buffer, row a multiple of 8")
    blocks = p2p.param_blocks(state)
    check_leaf_types(name, init_types, layout, blocks)
    check((layout.wide is not None) == (cfg.family in ("rwkv6", "hybrid")),
          f"{name}: a float32 block exactly where the model has float32 leaves")
    rng = np.random.default_rng(0)

    def round_batches():
        tokens, labels = train.lm_token_batches(rng, cfg.vocab_size, num_peers=run.peers,
                                                local_steps=run.steps, batch=run.batch,
                                                seq=run.seq)
        return tuple(torch.as_tensor(a, dtype=torch.int64, device=dev) for a in (tokens, labels))

    counters = launch_counters()
    batches = round_batches()
    step0 = (batches[0][0], batches[1][0])
    for counter in counters.values():
        counter.reset()
    losses_k, grads_k = lm_step_grads(task, layout, blocks, step0)
    torch.cuda.synchronize()
    step_launches = {key: c.count for key, c in counters.items() if c.count}
    want_step = lm_step_launches(cfg)
    check(step_launches == want_step, f"{name} step launched {step_launches}, want {want_step}")
    start = time.perf_counter()
    with plain_backwards():
        losses_p, grads_p = lm_step_grads(task, layout, blocks, step0)
    torch.cuda.synchronize()
    plain_step_s = time.perf_counter() - start
    check(torch.equal(losses_k, losses_p), f"{name}: the step's losses equal")
    grad_check = {"losses": losses_k.tolist(), **compare_grads(name, layout, grads_k, grads_p),
                  "plain_step_s": plain_step_s}
    grad_rel, leaf_rel = grad_check["rel_norm_err"], grad_check["leaf_rel_norm_err"]
    print(f"{name} first local step ({card.line}): losses {losses_k.tolist()}; gradients "
          f"against the plain backwards: relative norm error {grad_rel:.3g}, max abs "
          f"error {grad_check['max_abs_err']:.3g} of max |grad| {grad_check['max_abs']:.3g}, "
          f"worst leaf {max(leaf_rel, key=leaf_rel.get)} {max(leaf_rel.values()):.3g} (the "
          f"plain step {plain_step_s:.2f} s); every leaf {json.dumps(leaf_rel)}", flush=True)
    check(grad_rel < LM_GRAD_REL_NORM, f"{name} gradients: relative norm error {grad_rel}")
    del grads_k, grads_p, blocks

    depth = "" if run.layers is None else f" {run.layers} layers,"
    print(f"main path: p2p_lm {name} full width,{depth} K={run.peers} batch {run.batch} seq "
          f"{run.seq} T={run.steps}, {run.rounds} rounds", flush=True)
    want = {key: 0 for key in counters} | {key: n * run.steps for key, n in want_step.items()}
    # one launch a consensus step for each block of the layout
    want["consensus_mix"] = pcfg.consensus_steps * (2 if layout.wide is not None else 1)
    seconds, losses, per_round = [], [], []
    total = dict.fromkeys(counters, 0)
    with count_plain_calls() as plain_calls:
        for r in range(run.rounds):
            if r:
                batches = round_batches()
            torch.cuda.synchronize()
            for counter in counters.values():
                counter.reset()
            start = time.perf_counter()
            # the round's post-local state (its first output) is not kept:
            # at these widths it is two (K, row) buffers
            state, step_losses = round_fn(state, batches)[1:]
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
            launches = {key: c.count for key, c in counters.items()}
            check(launches == want, f"{name} round {r} launched {launches}, want {want}")
            per_round.append({key: n for key, n in launches.items() if n})
            for key, n in launches.items():
                total[key] += n
            losses.append(float(step_losses.float().mean()))
    check(not plain_calls, f"{name} called plain versions {plain_calls}")
    check(all(math.isfinite(v) for v in losses), f"{name} losses finite: {losses}")
    drift = float(consensus_lib.pairwise_drift(*p2p.param_blocks(state)))
    check(math.isfinite(drift), f"{name} drift finite: {drift}")
    for field in ("params", "momentum", "d_bias"):
        for block in (state, *([state.wide] if state.wide else [])):
            check(bool(torch.isfinite(getattr(block, field)).all()), f"{name} {field} finite")
    check_leaf_types(name, init_types, layout, p2p.param_blocks(state))
    # one more round through its two phases, timed apart
    ops = p2p.round_operands(pcfg, device=dev)
    batches = round_batches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    after_local, _ = p2p.local_phase(state, task, batches, pcfg)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - start
    start = time.perf_counter()
    state = p2p.consensus_phase(after_local, pcfg, ops[state.round_idx % len(ops)])
    torch.cuda.synchronize()
    consensus_s = time.perf_counter() - start
    del after_local
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batches = round_batches()
    profile = profile_once(lambda: round_fn(state, batches), category=lm_kernel_category,
                           n_top=12)
    print(f"p2p_lm {name} one round under torch.profiler ({card.line}): wall "
          f"{profile['wall_s']:.4f} s, device busy {profile['device_busy_s']:.4f} s (share "
          f"{profile['device_busy_share']:.4f}), {profile['kernels']} kernels; by category "
          f"[launches, device ms]: {json.dumps(profile['by_category_launches_ms'])}; top "
          f"kernels [name, launches, ms]: {json.dumps(profile['top_kernels_ms'])}", flush=True)
    replica_gb = sum(b.numel() * b.element_size() for b in p2p.param_blocks(state)) / 1e9
    state_gb = 4 * replica_gb
    wide = "" if layout.wide is None else f" and (K, {layout.wide.row}) float32"
    print(f"p2p_lm {name} ({card.line}): {layout.size} parameters a peer, set-up {setup_s:.2f} "
          f"s, seconds per round {seconds}, losses {losses}, final drift {drift:.6g}; one more "
          f"round: local phase {local_s:.4f} s, consensus {consensus_s:.4f} s; launches per "
          f"round {per_round}; peak memory {peak_gb:.3f} GB against {state_gb:.3f} GB for the "
          f"four (K, {layout.row}) bf16{wide} state buffers", flush=True)
    del state
    torch.cuda.empty_cache()
    return {"launches": {key: n for key, n in total.items() if n}, "seconds": seconds,
            "losses": losses, "final_drift": drift, "local_s": local_s,
            "consensus_s": consensus_s, "setup_s": setup_s, "peak_gb": peak_gb,
            "state_gb": state_gb, "launches_per_round": per_round, "grad_check": grad_check,
            "row": layout.row, "params_per_peer": layout.size, "layers": cfg.num_layers,
            "wide_row": None if layout.wide is None else layout.wide.row,
            "round_profile": profile}


def drive_run_p2p_lm_reduced(card: Card, arch: str) -> dict:
    """The reference's entry point as it is: ``run_p2p_lm(arch,
    rounds=LM_REDUCED_ROUNDS)`` on the card (reduced, float32: the kernels'
    float32 routes at the reduced widths, ``consensus_mix`` at K = 2),
    launch counts reset just before and read just after."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train

    cfg = reduced(get_config(arch))
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()
    print(f"main path: run_p2p_lm({arch!r}, rounds={LM_REDUCED_ROUNDS}) (reduced)", flush=True)
    start = time.perf_counter()
    out = train.run_p2p_lm(arch, rounds=LM_REDUCED_ROUNDS, verbose=True, device="cuda")
    seconds = time.perf_counter() - start
    launches = {key: c.count for key, c in counters.items()}
    steps = LM_REDUCED_ROUNDS * 4  # the reference's default T = 4
    want = {key: 0 for key in counters} | {key: n * steps for key, n in
                                           lm_step_launches(cfg).items()}
    want["consensus_mix"] = LM_REDUCED_ROUNDS
    check(launches == want, f"run_p2p_lm({arch}) launched {launches}, want {want}")
    check(len(out["losses"]) == LM_REDUCED_ROUNDS
          and all(math.isfinite(v) for v in out["losses"]), f"run_p2p_lm({arch}) losses {out}")
    check(math.isfinite(out["final_drift"]), f"run_p2p_lm({arch}) drift {out}")
    print(f"run_p2p_lm {arch} reduced ({card.line}): {json.dumps(out)} in {seconds:.2f} s, "
          f"launches {launches}", flush=True)
    return {"launches": {key: n for key, n in launches.items() if n}, "seconds": seconds, **out}


# the scan driver on the LM round's batch trees: C rounds a call, CHUNKS calls
LM_SCAN_CHUNK = 2
LM_SCAN_CHUNKS = 2
# the mixed rwkv6-7b task at its published widths and a depth cut to fit a
# captured round beside the python driver's final state (PERF.md)
LM_MIXED_ARCH, LM_MIXED_LAYERS = "rwkv6-7b", 2
# the modes a bf16 LM now runs in: (label, P2PConfig fields); push-sum on a
# directed ring, the qint8 wire, staleness bound 2 with straggling peers
LM_MODES = (("push_sum", dict(protocol="push_sum", topology="directed_ring")),
            ("qint8", dict(compressor="qint8")),
            ("staleness2", dict(staleness_bound=2, steps_profile="straggler")))
LM_MODE_ROUNDS = 2


def lm_setup(arch: str, layers: int | None, peers: int, steps: int, **mode):
    """A bf16 LM task at published widths (depth cut to ``layers`` where
    given) and ``run_p2p_lm``'s P2P configuration with ``mode``'s fields:
    (cfg, task, pcfg, init types)."""
    from repro_torch.configs import get_config
    from repro_torch.core import task as task_lib
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model

    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    task, init_types = recording_init(task_lib.from_model(build_model(cfg)))
    pcfg = dataclasses.replace(train.lm_config(
        num_peers=peers, local_steps=steps, algorithm="p2pl_affinity", lr=1e-2, momentum=0.5,
        eta_d=0.25), **mode)
    return cfg, task, pcfg, init_types


def lm_chunk(rng, cfg, rounds: int, peers: int, steps: int, batch: int, seq: int) -> dict:
    """``rounds`` rounds of ``run_p2p_lm``'s token draws as the reference's
    batch tree on the card: {"tokens", "labels"}, (C, T, K, B, S) int64."""
    from repro_torch.launch import train

    draws = [train.lm_token_batches(rng, cfg.vocab_size, num_peers=peers, local_steps=steps,
                                    batch=batch, seq=seq) for _ in range(rounds)]
    return {name: torch.as_tensor(np.stack([d[i] for d in draws]), dtype=torch.int64,
                                  device="cuda") for i, name in enumerate(("tokens", "labels"))}


def lm_round_launches(cfg, pcfg, layout) -> dict:
    """The launches a round of ``pcfg`` makes on ``cfg``: its loss's kernels
    T times each way, and its consensus kernel once a block a step (a
    compressed wire's ``dequant_mix``, else ``consensus_mix``)."""
    counters = launch_counters()
    want = {key: 0 for key in counters} | {key: n * pcfg.local_steps for key, n in
                                           lm_step_launches(cfg).items()}
    mix = "dequant_mix" if pcfg.compressor != "none" else "consensus_mix"
    want[mix] = pcfg.consensus_steps * len(layout.blocks)
    return want


def drive_p2p_lm_scan(card: Card, label: str, arch: str, layers: int | None, peers: int,
                      batch: int, seq: int, steps: int) -> dict:
    """The scan driver on the reference's batch trees at published widths:
    one initial state and the same (C, T, K, B, S) token chunks through
    ``make_round_fn`` (C python-driver calls a chunk) and through
    ``make_scan_driver`` (one call a chunk: the first round of the first
    call eager, then the capture, every later round a replay of the LM round
    as one CUDA graph); the final states (every carried leaf, both blocks of
    a mixed task) and the losses must be equal bit for bit.  Launches are
    counted a chunk and held to ``lm_round_launches`` C times; s/round is
    timed in turns (python chunks, scan chunks, one more python round after
    the driver and its graph are freed), with the capture's seconds, each
    driver's peak memory and one replayed chunk under torch.profiler."""
    from repro_torch import pytree
    from repro_torch.core import p2p

    dev = torch.device("cuda")
    cfg, task, pcfg, init_types = lm_setup(arch, layers, peers, steps)
    layout = p2p.ParamLayout.of(task)
    torch.cuda.empty_cache()
    state0 = p2p.init_state(task, pcfg, seed=0, device=dev)
    check_leaf_types(label, init_types, layout, p2p.param_blocks(state0))
    rng = np.random.default_rng(0)
    chunks = [lm_chunk(rng, cfg, LM_SCAN_CHUNK, peers, steps, batch, seq)
              for _ in range(LM_SCAN_CHUNKS)]
    want = lm_round_launches(cfg, pcfg, layout)
    counters = launch_counters()
    depth = "" if layers is None else f" {layers} layers,"
    print(f"main path: {label}: {arch} full width,{depth} K={peers} batch {batch} seq {seq} "
          f"T={steps}, {LM_SCAN_CHUNKS} chunks of C={LM_SCAN_CHUNK} rounds through both "
          f"drivers", flush=True)

    def python_rounds(state, chunk):
        losses, seconds = [], []
        for c in range(LM_SCAN_CHUNK):
            for counter in counters.values():
                counter.reset()
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, step_losses = round_fn(state, pytree.tree_map(lambda x: x[c], chunk))[1:]
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
            launches = {key: n.count for key, n in counters.items()}
            check(launches == want, f"{label} python round launched {launches}, want {want}")
            losses.append(step_losses)
        return state, torch.stack(losses), seconds

    round_fn = p2p.make_round_fn(task, pcfg, device=dev)
    torch.cuda.reset_peak_memory_stats()
    py = p2p.with_leaves(state0, [t.clone() for t in p2p.state_leaves(state0)], 0)
    py_losses, py_seconds = [], []
    for chunk in chunks:
        py, losses, seconds = python_rounds(py, chunk)
        py_losses.append(losses)
        py_seconds += seconds
    torch.cuda.synchronize()
    py_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    drive = p2p.make_scan_driver(task, pcfg, device=dev, donate=True)
    scan, scan_losses, scan_seconds = state0, [], []
    del state0
    for chunk in chunks:
        for counter in counters.values():
            counter.reset()
        torch.cuda.synchronize()
        start = time.perf_counter()
        scan, losses = drive(scan, chunk)[1:]
        torch.cuda.synchronize()
        scan_seconds.append(time.perf_counter() - start)
        launches = {key: n.count for key, n in counters.items()}
        want_chunk = {key: n * LM_SCAN_CHUNK for key, n in want.items()}
        check(launches == want_chunk, f"{label} scan chunk launched {launches}, want "
              f"{want_chunk}")
        scan_losses.append(losses)
    scan_peak = torch.cuda.max_memory_allocated() / 1e9
    capture_s = drive.capture_seconds
    py_leaves, scan_leaves = p2p.state_leaves(py), p2p.state_leaves(scan)
    check(len(py_leaves) == len(scan_leaves) and scan.round_idx == py.round_idx,
          f"{label}: the drivers' states have the same leaves and round")
    for i, (a, b) in enumerate(zip(py_leaves, scan_leaves)):
        check(a.dtype == b.dtype and torch.equal(a, b), f"{label}: leaf {i} bit for bit")
    check(all(torch.equal(a, b) for a, b in zip(py_losses, scan_losses)),
          f"{label}: losses bit for bit")
    check(all(bool(torch.isfinite(x).all()) for x in py_losses), f"{label}: losses finite")
    replay_profile = profile_once(lambda: drive(scan, chunks[-1]), category=lm_kernel_category,
                                  n_top=8)
    del py, py_leaves, drive
    torch.cuda.empty_cache()
    for counter in counters.values():
        counter.reset()
    torch.cuda.synchronize()
    start = time.perf_counter()
    scan = round_fn(scan, pytree.tree_map(lambda x: x[0], chunks[0]))[1]
    torch.cuda.synchronize()
    py_again_s = time.perf_counter() - start
    replay_s = scan_seconds[-1] / LM_SCAN_CHUNK  # the last chunk: replays only
    first_rest_s = (scan_seconds[0] - capture_s) / max(LM_SCAN_CHUNK - 1, 1)
    state_gb = sum(t.numel() * t.element_size() for t in scan_leaves) / 1e9
    del scan, scan_leaves
    torch.cuda.empty_cache()
    # the launches counted and checked: both drivers' rounds (the profiled
    # chunk and the last python round are not counted)
    out = {"launches": {key: 2 * n * LM_SCAN_CHUNK * LM_SCAN_CHUNKS for key, n in want.items()
                        if n},
           "python_s_per_round": py_seconds, "python_again_s": py_again_s,
           "scan_s_per_chunk": scan_seconds, "scan_replay_s_per_round": replay_s,
           "scan_first_chunk_rest_s_per_round": first_rest_s, "capture_s": capture_s,
           "python_peak_gb": py_peak, "scan_peak_gb": scan_peak, "state_gb": state_gb,
           "losses": [float(x.float().mean()) for x in torch.cat(py_losses)],
           "replay_profile": replay_profile, "layers": cfg.num_layers}
    print(f"{label} ({card.line}): python driver s/round {py_seconds} (and {py_again_s:.4f} "
          f"after the scan driver), peak {py_peak:.3f} GB; scan driver s/chunk of C="
          f"{LM_SCAN_CHUNK} {scan_seconds} (warm-up and capture {capture_s:.3f} s; replays "
          f"{replay_s:.4f} s/round), peak {scan_peak:.3f} GB; state {state_gb:.3f} GB; bits "
          f"equal; replayed chunk under torch.profiler: wall {replay_profile['wall_s']:.4f} s, "
          f"device busy {replay_profile['device_busy_s']:.4f} s (share "
          f"{replay_profile['device_busy_share']:.4f}), {replay_profile['kernels']} kernels, "
          f"by category {json.dumps(replay_profile['by_category_launches_ms'])}", flush=True)
    return out


def drive_lm_mode(card: Card, label: str, arch: str, layers: int | None, peers: int,
                  batch: int, seq: int, steps: int, rounds: int, **mode) -> dict:
    """``rounds`` rounds of a bf16 LM at published widths in a consensus mode
    (``mode``: push-sum, a compressed wire, bounded staleness, adaptive
    selection) through ``make_round_fn``: launches counted a round and held
    to ``lm_round_launches`` (the mode's kernel once a block a step: a mixed
    task's float32 block through the float32 kernel, its bf16 block through
    the bf16 storage mode), no plain version called, every leaf in its type,
    the losses, parameters and the mode's buffers finite, push-sum's mass
    summing to K."""
    from repro_torch.core import p2p

    dev = torch.device("cuda")
    cfg, task, pcfg, init_types = lm_setup(arch, layers, peers, steps, **mode)
    layout = p2p.ParamLayout.of(task)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    state = p2p.init_state(task, pcfg, seed=0, device=dev)
    round_fn = p2p.make_round_fn(task, pcfg, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    want = lm_round_launches(cfg, pcfg, layout)
    counters = launch_counters()
    rng = np.random.default_rng(0)
    chunk = lm_chunk(rng, cfg, rounds, peers, steps, batch, seq)
    depth = "" if layers is None else f" {layers} layers,"
    print(f"main path: {label}: {arch} full width,{depth} K={peers} batch {batch} seq {seq} "
          f"T={steps}, {rounds} rounds, {mode}", flush=True)
    seconds, losses, total = [], [], dict.fromkeys(counters, 0)
    with count_plain_calls() as plain_calls:
        for r in range(rounds):
            for counter in counters.values():
                counter.reset()
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, step_losses = round_fn(state, {k: v[r] for k, v in chunk.items()})[1:]
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
            launches = {key: c.count for key, c in counters.items()}
            check(launches == want, f"{label} round {r} launched {launches}, want {want}")
            for key, n in launches.items():
                total[key] += n
            losses.append(float(step_losses.float().mean()))
    check(not plain_calls, f"{label} called plain versions {plain_calls}")
    check(all(math.isfinite(v) for v in losses), f"{label} losses {losses}")
    check_leaf_types(label, init_types, layout, p2p.param_blocks(state))
    for i, leaf in enumerate(p2p.state_leaves(state)):
        if leaf.is_floating_point():
            check(bool(torch.isfinite(leaf).all()), f"{label}: state leaf {i} finite")
    if pcfg.protocol == "push_sum":
        mass = state.protocol.mass
        check(abs(float(mass.double().sum()) - peers) <= 1e-5 * peers, f"{label}: sum y = K")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state, round_fn
    torch.cuda.empty_cache()
    print(f"{label} ({card.line}): set-up {setup_s:.2f} s, s/round {seconds}, losses {losses}, "
          f"launches a round {({k: n for k, n in want.items() if n})}, peak {peak_gb:.3f} GB",
          flush=True)
    return {"launches": {key: n for key, n in total.items() if n}, "seconds": seconds,
            "losses": losses, "peak_gb": peak_gb, "mode": next(iter(mode)) if mode else "gossip",
            "bf16_mode": True, "layers": cfg.num_layers}


# the encoder-decoder at full size: K = 2, batch 4, a 1024-token sequence split
# as the reference's split_encdec_seq (256 frames, 768 tokens), T = 4
ENCDEC_ARCH, ENCDEC_PEERS, ENCDEC_BATCH, ENCDEC_SEQ, ENCDEC_ROUNDS = (
    "seamless-m4t-medium", 2, 4, 1024, 2)
# the vlm, one round with its image patches: published widths, 12 of its 24
# layers (PERF.md), K = 2, batch 2, 256 patches and 768 tokens, T = 2
VLM_ARCH, VLM_LAYERS = "internvl2-2b", 12


@contextlib.contextmanager
def flash_calls_by_mask():
    """While active, counts ``flash_attention``'s forward and backward
    launches by their mask: yields a dict ("forward" or "backward",
    "causal" or "non-causal") -> launches."""
    from repro_torch.kernels.flash_attention import ops

    calls: dict[str, int] = {}
    real = {"launch": ops.launch, "launch_bwd": ops.launch_bwd}

    def counted(name, way):
        def call(*args, **kwargs):
            key = f"{way} {'causal' if kwargs['causal'] else 'non-causal'}"
            calls[key] = calls.get(key, 0) + 1
            return real[name](*args, **kwargs)
        return call

    ops.launch, ops.launch_bwd = counted("launch", "forward"), counted("launch_bwd", "backward")
    try:
        yield calls
    finally:
        ops.launch, ops.launch_bwd = real["launch"], real["launch_bwd"]


def drive_p2p_batch_tree(card: Card, label: str, arch: str, layers: int | None, peers: int,
                         batch: int, seq: int, steps: int, rounds: int) -> dict:
    """P2P training of a model whose batch carries more than tokens (the
    encoder-decoder's ``frames``, the vlm's ``patches``; bf16, published
    widths, ``run_p2p_lm``'s step sizes) through ``from_model`` on the
    registry's batch tree (``Model.make_batch``'s keys, stacked (T, K, B,
    ...)): the first local step's losses and gradients against the same step
    with the plain backwards (LM_GRAD_TOL), its ``flash_attention`` launches
    by mask, then ``rounds`` rounds, launches held to ``lm_round_launches``,
    s/round, the peak."""
    from repro_torch.core import p2p
    from repro_torch.models.registry import build_model

    dev = torch.device("cuda")
    cfg, task, pcfg, init_types = lm_setup(arch, layers, peers, steps)
    model = build_model(cfg)
    layout = p2p.ParamLayout.of(task)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    state = p2p.init_state(task, pcfg, seed=0, device=dev)
    round_fn = p2p.make_round_fn(task, pcfg, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    check_leaf_types(label, init_types, layout, p2p.param_blocks(state))
    gen = torch.Generator(device=dev).manual_seed(0)

    def round_batches():  # the registry's batch tree, (T, K, B, ...) a leaf
        draws = [[model.make_batch(gen, batch, seq) for _ in range(peers)] for _ in range(steps)]
        return {key: torch.stack([torch.stack([d[key] for d in step]) for step in draws])
                for key in draws[0][0]}

    batches = round_batches()
    shapes = {key: tuple(leaf.shape[3:]) for key, leaf in batches.items()}
    print(f"main path: {label}: {arch} full width{'' if layers is None else f', {layers} layers'}"
          f", K={peers} batch {batch} seq {seq} ({shapes}), T={steps}, {rounds} rounds",
          flush=True)
    counters = launch_counters()
    step0 = {key: leaf[0] for key, leaf in batches.items()}
    for counter in counters.values():
        counter.reset()
    with flash_calls_by_mask() as by_mask:
        losses_k, grads_k = lm_step_grads(task, layout, p2p.param_blocks(state), step0)
    torch.cuda.synchronize()
    step_launches = {key: c.count for key, c in counters.items() if c.count}
    with plain_backwards():
        losses_p, grads_p = lm_step_grads(task, layout, p2p.param_blocks(state), step0)
    check(torch.equal(losses_k, losses_p), f"{label}: the step's losses equal")
    grad_check = {"losses": losses_k.tolist(), **compare_grads(label, layout, grads_k, grads_p)}
    del grads_k, grads_p
    check(grad_check["rel_norm_err"] < LM_GRAD_REL_NORM,
          f"{label} gradients: relative norm error {grad_check['rel_norm_err']}")
    want = lm_round_launches(cfg, pcfg, layout)
    check(step_launches == {k: n // steps for k, n in want.items() if n and "attention" in k},
          f"{label}: the step launched {step_launches}")
    seconds, losses, total = [], [], dict.fromkeys(counters, 0)
    with count_plain_calls() as plain_calls:
        for r in range(rounds):
            if r:
                batches = round_batches()
            for counter in counters.values():
                counter.reset()
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, step_losses = round_fn(state, batches)[1:]
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
            launches = {key: c.count for key, c in counters.items()}
            check(launches == want, f"{label} round {r} launched {launches}, want {want}")
            for key, n in launches.items():
                total[key] += n
            losses.append(float(step_losses.float().mean()))
    check(not plain_calls, f"{label} called plain versions {plain_calls}")
    check(all(math.isfinite(v) for v in losses), f"{label} losses {losses}")
    for leaf in p2p.param_blocks(state):
        check(bool(torch.isfinite(leaf).all()), f"{label}: parameters finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_gb = 4 * sum(b.numel() * b.element_size() for b in p2p.param_blocks(state)) / 1e9
    del state, round_fn, batches, step0
    torch.cuda.empty_cache()
    print(f"{label} ({card.line}): {layout.size} parameters a peer, set-up {setup_s:.2f} s; first "
          f"step: losses {grad_check['losses']}, gradients against the plain backwards: relative "
          f"norm error {grad_check['rel_norm_err']:.3g}, worst leaf "
          f"{grad_check['leaf_rel_norm_err_max']:.3g}; flash_attention launches a step by mask "
          f"{by_mask}; s/round {seconds}, losses {losses}, peak {peak_gb:.3f} GB against "
          f"{state_gb:.3f} GB of state", flush=True)
    grad_check.pop("leaf_rel_norm_err")
    return {"launches": {key: n for key, n in total.items() if n}, "seconds": seconds,
            "losses": losses, "peak_gb": peak_gb, "state_gb": state_gb, "setup_s": setup_s,
            "grad_check": grad_check, "flash_launches_by_mask_a_step": by_mask,
            "layers": cfg.num_layers, "params_per_peer": layout.size}


def drive_lm_trees_and_modes(card: Card) -> dict:
    """The LM paths of batch trees and consensus modes on the card: the scan driver on smollm-135m's token
    batches (full width and depth, K = 4, batch 4, seq 1024, T = 4) and on
    the mixed rwkv6-7b task (LM_MIXED_LAYERS layers, K = 2, batch 1, T = 2);
    smollm-135m (K = 4) and the mixed rwkv6-7b (K = 2) in each of LM_MODES,
    rwkv6-7b also under adaptive selection; the encoder-decoder's and the vlm's P2P
    training on their batch trees.  Returns the paths by label."""
    paths = {}
    start = time.perf_counter()
    paths["p2p_lm_scan_smollm_full"] = drive_p2p_lm_scan(
        card, "p2p_lm_scan_smollm_full", LM_ARCH, None, 4, 4, 1024, 4)
    paths["p2p_lm_scan_rwkv6_7b_mixed"] = drive_p2p_lm_scan(
        card, "p2p_lm_scan_rwkv6_7b_mixed", LM_MIXED_ARCH, LM_MIXED_LAYERS, 2, 1, 1024, 2)
    for name, mode in LM_MODES:
        paths[f"p2p_lm_{name}_smollm_full"] = drive_lm_mode(
            card, f"p2p_lm_{name}_smollm_full", LM_ARCH, None, 4, 4, 1024, 4, LM_MODE_ROUNDS,
            **mode)
    for name, mode in (*LM_MODES, ("adaptive", dict(schedule="adaptive"))):
        paths[f"p2p_lm_{name}_rwkv6_7b_mixed"] = drive_lm_mode(
            card, f"p2p_lm_{name}_rwkv6_7b_mixed", LM_MIXED_ARCH, LM_MIXED_LAYERS, 2, 1, 1024, 2,
            LM_MODE_ROUNDS, **mode)
    paths["p2p_encdec_seamless_full"] = drive_p2p_batch_tree(
        card, "p2p_encdec_seamless_full", ENCDEC_ARCH, None, ENCDEC_PEERS, ENCDEC_BATCH,
        ENCDEC_SEQ, 4, ENCDEC_ROUNDS)
    paths["p2p_vlm_internvl2"] = drive_p2p_batch_tree(
        card, "p2p_vlm_internvl2", VLM_ARCH, VLM_LAYERS, 2, 2, 1024, 2, 1)
    print(f"LM tree and mode paths: {time.perf_counter() - start:.1f} s ({card.line})",
          flush=True)
    return paths


# a bf16 MoE decoder, reduced: its float32 router beside its bf16 leaves (the
# full model does not fit: PERF.md)
LM_MOE_ARCH = "qwen3-moe-235b-a22b"


def drive_p2p_lm_reduced_bf16(card: Card, arch: str) -> dict:
    """One round of ``run_p2p_lm``'s loop on ``reduced(get_config(arch))`` in
    bf16 (its defaults: K = 2, T = 4, batch 4, seq 32, seed 0; the reference's
    p2pl_affinity step sizes) through ``from_model``, ``init_state`` and
    ``make_round_fn``, as ``run_p2p_lm`` composes them: every leaf in its
    init's type through the round (a MoE's router float32 in a block of its
    own, so ``consensus_mix`` launches twice), launch counts reset just
    before and read just after, the losses, parameters and drift finite."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import consensus as consensus_lib
    from repro_torch.core import p2p, task as task_lib
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model

    dev = torch.device("cuda")
    name = f"{arch} reduced bf16"
    cfg = reduced(get_config(arch)).replace(dtype="bfloat16")
    task, init_types = recording_init(task_lib.from_model(build_model(cfg)))
    pcfg = train.lm_config(num_peers=2, local_steps=4, algorithm="p2pl_affinity", lr=1e-2,
                           momentum=0.5, eta_d=0.25)
    state = p2p.init_state(task, pcfg, seed=0, device=dev)
    layout = p2p.ParamLayout.of(task)
    check(layout.wide is not None, f"{name}: a float32 block for the router")
    check_leaf_types(name, init_types, layout, p2p.param_blocks(state))
    round_fn = p2p.make_round_fn(task, pcfg, device=dev)
    tokens, labels = train.lm_token_batches(np.random.default_rng(0), cfg.vocab_size,
                                            num_peers=2, local_steps=4, batch=4, seq=32)
    batches = tuple(torch.as_tensor(v, dtype=torch.int64, device=dev) for v in (tokens, labels))
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()
    print(f"main path: p2p_lm {name}, K=2 batch 4 seq 32 T=4, one round", flush=True)
    torch.cuda.synchronize()
    start = time.perf_counter()
    with count_plain_calls() as plain_calls:
        _, state, step_losses = round_fn(state, batches)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {key: c.count for key, c in counters.items()}
    want = {key: 0 for key in counters} | {key: n * 4 for key, n in
                                           lm_step_launches(cfg).items()}
    want["consensus_mix"] = 2
    check(launches == want, f"{name} launched {launches}, want {want}")
    check(not plain_calls, f"{name} called plain versions {plain_calls}")
    losses = step_losses.float().tolist()
    check(all(math.isfinite(v) for v in losses), f"{name} losses finite: {losses}")
    blocks = p2p.param_blocks(state)
    check(all(bool(torch.isfinite(b.float()).all()) for b in blocks), f"{name} parameters finite")
    check_leaf_types(name, init_types, layout, blocks)
    drift = float(consensus_lib.pairwise_drift(*blocks))
    print(f"p2p_lm {name} ({card.line}): {layout.size} bf16 and {layout.wide.size} float32 "
          f"parameters a peer (rows {layout.row} and {layout.wide.row}), losses {losses}, drift "
          f"{drift:.6g}, {seconds:.3f} s, launches {launches}", flush=True)
    return {"launches": {key: n for key, n in launches.items() if n}, "seconds": seconds,
            "losses": losses, "final_drift": drift}


# the reference's step API at full width: smollm-135m, nothing cut, on a ring
STEP_API_PEERS = 4
STEP_API_BATCH, STEP_API_SEQ = 4, 1024
STEP_API_STEPS, STEP_API_ROUNDS = 2, 2


def compare_tree(name: str, got, want, tol: dict) -> float:
    """Holds every leaf of tree ``got`` to the same leaf of ``want`` (each
    flattened in the reference's order, ``ops.flatten_pytree``); returns the
    largest absolute error."""
    from repro_torch.kernels.consensus_mix import ops

    a = ops.flatten_pytree(got)[0] if isinstance(got, dict) else got
    b = ops.flatten_pytree(want)[0] if isinstance(want, dict) else want
    torch.testing.assert_close(a.float(), b.float(), **tol, msg=lambda m: f"{name}: {m}")
    return float((a.float() - b.float()).abs().max())


def step_api_wrappers(card: Card) -> dict:
    """The consensus kernels' tree-level wrappers, called the reference's
    way on the 2NN's stacked float32 parameters at K = 8:
    ``consensus_mix_schedule`` on ``timevarying_k8``'s schedule (random
    matchings, R = 16), ``consensus_mix_push_sum_schedule`` on
    ``directed_k8``'s, ``dequant_consensus_mix_schedule`` on a qint8 wire
    (``quantize_int8`` of x minus estimates) and ``consensus_mix_flat``, each
    call moving its kernel's counter by one and held to its plain version on
    the same inputs (5e-5 / 1e-4); then one ``consensus_mix_schedule`` call
    with a 0-d round index on the card captured as a CUDA graph and replayed
    for rounds 3 and 11, each replay equal bit for bit to the eager call
    with an int index.  Launch counts reset just before and read just
    after; no plain version runs inside a wrapper."""
    from repro_torch import capture as capture_lib
    from repro_torch.configs.p2pl_mnist import directed_k8, timevarying_k8
    from repro_torch.core import p2p, task as task_lib
    from repro_torch.kernels.consensus_mix import dequant, ops, ref

    dev = torch.device("cuda")
    tv, directed = timevarying_k8(), directed_k8()
    k = tv.p2p.num_peers
    task = task_lib.get_task("mnist_mlp")
    state = p2p.init_state(task, tv.p2p, seed=0, device=dev)
    stacked = p2p.ParamLayout.of(task).views(state.params)  # (K, ...) views, float32
    flat = ops.flatten_pytree(stacked)[0]
    n = flat.shape[1]
    sizes = np.arange(1, k + 1) * 100
    w, beta, sched = p2p.mixing_constants(tv.p2p, sizes)
    tv_ops = ops.sparse_from_schedule(w, beta, device=dev)
    consts, dsched = p2p.protocol_constants(directed.p2p, sizes)
    push_ops = ops.sparse_from_schedule(consts.w, consts.beta, device=dev)
    mass = push_sum_mass(k, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    est = flat + 0.01 * torch.randn(flat.shape, generator=gen, device=dev)
    q, scale = dequant.quantize_int8(flat - est)
    x, nbrs = flat[0], flat[1:4]
    w_nbr = torch.tensor([0.2, 0.15, 0.25], device=dev)
    b_nbr = torch.tensor([0.5, 0.3, 0.2], device=dev)
    t_steps = tv.p2p.local_steps
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()
    errs: dict[str, float] = {}
    print(f"main path: the reference's wrappers on the 2NN's row, K={k} N={n} float32 "
          f"({sched.name} R={w.shape[0]}, {dsched.name} R={consts.w.shape[0]})", flush=True)

    def one_call(kernel, name, call, plain):
        before = counters[kernel].count
        with count_plain_calls() as plain_calls:
            got = call()
            torch.cuda.synchronize()
        check(not plain_calls, f"{name}: called plain versions {plain_calls}")
        check(counters[kernel].count == before + 1, f"{name}: one {kernel} launch")
        want = plain()
        errs[name] = max(compare_tree(f"{name} [{i}]", g, v, TOL)
                         for i, (g, v) in enumerate(zip(got, want)))

    for r in (0, 5, 17):
        one_call("consensus_mix", f"consensus_mix_schedule r={r}",
                 lambda: ops.consensus_mix_schedule(stacked, r, *tv_ops, t_steps),
                 lambda: ref.consensus_mix_stacked_ref(flat, *ops.select_round(tv_ops, r),
                                                       t_steps))
        one_call("consensus_mix", f"consensus_mix_push_sum_schedule r={r}",
                 lambda: ops.consensus_mix_push_sum_schedule(stacked, mass, r, *push_ops,
                                                             t_steps),
                 lambda: ref.consensus_mix_push_sum_stacked_ref(
                     flat, mass, *ops.select_round(push_ops, r), t_steps))
        one_call("dequant_mix", f"dequant_consensus_mix_schedule r={r}",
                 lambda: dequant.dequant_consensus_mix_schedule(stacked, est, q, scale, *tv_ops,
                                                                r, t_steps),
                 lambda: ref.dequant_mix_stacked_ref(flat, est, q, scale[:, None], (0, n),
                                                     *ops.select_round(tv_ops, r),
                                                     t_steps)[:2])
    one_call("consensus_mix", "consensus_mix_flat",
             lambda: ops.consensus_mix_flat(x, nbrs, 0.4, w_nbr, b_nbr, t_steps),
             lambda: ref.consensus_mix_ref(x, nbrs, 0.4, w_nbr, b_nbr, t_steps))
    # one call with the round index on the card, captured and replayed
    round_idx = torch.zeros((), dtype=torch.int64, device=dev)
    captured = capture_lib.capture(
        lambda: ops.consensus_mix_schedule(stacked, round_idx, *tv_ops, t_steps), dev)
    replays = {}
    for r in (3, 11):
        round_idx.fill_(r)
        got = captured.replay()
        eager = ops.consensus_mix_schedule(stacked, r, *tv_ops, t_steps)
        torch.cuda.synchronize()
        equal = all(torch.equal(g[leaf], e[leaf]) for g, e in zip(got, eager) for leaf in g)
        check(equal, f"captured consensus_mix_schedule round {r}: replay equals eager")
        replays[r] = equal
    launches = {key: c.count for key, c in counters.items()}
    want = {key: 0 for key in counters} | {"consensus_mix": 3 * 2 + 1 + 1 + 2 * 2,
                                           "dequant_mix": 3}
    check(launches == want, f"step_api wrappers launched {launches}, want {want}")
    print(f"step_api wrappers ({card.line}): max abs error against the plain versions "
          f"{json.dumps(errs)}; captured consensus_mix_schedule (capture {captured.seconds:.3f} "
          f"s) replays equal eager bit for bit at rounds {list(replays)}; launches "
          f"{ {key: v for key, v in launches.items() if v} }", flush=True)
    return {"launches": {key: v for key, v in launches.items() if v}, "max_abs_err": errs,
            "capture_replays_equal": replays, "capture_s": captured.seconds}


def step_api_smollm(card: Card) -> dict:
    """smollm-135m at full width and depth (bf16, random init from seed 0)
    trained through the reference's step API on a K = 4 ring (W and Beta
    from ``core.graph``, data-weighted with equal sizes): ``STEP_API_ROUNDS``
    rounds of ``STEP_API_STEPS`` calls of ``make_train_step`` (eta_d 0.25)
    on each peer in turn, AdamW on a cosine schedule with the gradients
    clipped to norm 1, batch 4 x seq 1024 tokens a peer from
    ``data.synthetic.lm_batches`` (seed 0), then ``make_consensus_step``
    with the affinity d.  First the first step's gradients (an optimizer
    that records them) against the same step with the plain backwards
    (``plain_backwards``); then the rounds, launch counts reset just before
    and read just after (``flash_attention`` and its backward 30 a step,
    ``consensus_mix`` one a round: every leaf is bf16), every step and
    consensus synchronized and timed; then, outside the count, one more
    consensus step against its plain version (bf16 5e-2),
    ``make_consensus_step_psum`` against ``make_consensus_step`` on the
    complete graph with uniform weights, ``make_multipod_train_step`` on
    peers 0 and 1 against each one's ``make_train_step`` (bf16 5e-2), and a
    checkpoint of the stacked parameters and peer 0's AdamW state saved to a
    temporary directory and restored onto the card bit for bit."""
    import tempfile

    from repro_torch import checkpoint, optim, pytree
    from repro_torch.configs import get_config
    from repro_torch.core import graph as graph_lib
    from repro_torch.data import synthetic
    from repro_torch.kernels.consensus_mix import ops, ref
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model

    dev = torch.device("cuda")
    k, t_steps, rounds = STEP_API_PEERS, STEP_API_STEPS, STEP_API_ROUNDS
    name = f"step_api {LM_ARCH}"
    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    peers = [model.init(gen) for _ in range(k)]
    stacked = {leaf: torch.stack([p[leaf] for p in peers]) for leaf in peers[0]}
    del peers
    check({v.dtype for v in stacked.values()} == {torch.bfloat16}, f"{name}: bf16 leaves")
    graph = graph_lib.build_graph("ring", k)
    w_mat, beta_mat = graph_lib.mixing_matrix(graph), graph_lib.affinity_matrix(graph)
    tokens, labels = (torch.as_tensor(a, dtype=torch.int64, device=dev) for a in
                      synthetic.lm_batches(rounds * t_steps * k, STEP_API_BATCH, STEP_API_SEQ,
                                           cfg.vocab_size, seed=0))
    base = optim.adamw(optim.cosine_schedule(1e-3, 1, rounds * t_steps), weight_decay=0.01)
    opt = optim.Optimizer(base.init, lambda g, s, p, step: base.update(
        optim.clip_by_global_norm(g, 1.0), s, p, step))
    train_step = steps.make_train_step(model, opt, eta_d=0.25)
    consensus_step = steps.make_consensus_step(w_mat, beta_mat, local_steps=t_steps,
                                               use_affinity=True)
    opt_states = [opt.init({leaf: v[i] for leaf, v in stacked.items()}) for i in range(k)]
    d_bias = {leaf: torch.zeros(v.shape, dtype=torch.float32, device=dev)
              for leaf, v in stacked.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start

    def batch(i):
        return {"tokens": tokens[i], "labels": labels[i]}

    # the first step's gradients, the kernels' backwards against the plain ones
    recorded: dict = {}

    def record(grads, state, params, step):
        recorded.clear()
        recorded.update(grads)
        return params, state

    probe = steps.make_train_step(model, optim.Optimizer(lambda p: (), record))
    peer0 = {leaf: v[0] for leaf, v in stacked.items()}
    loss_k = probe(peer0, (), None, batch(0), 0)[2]
    got = dict(recorded)
    with plain_backwards():
        loss_p = probe(peer0, (), None, batch(0), 0)[2]
    want = dict(recorded)
    check(torch.equal(loss_k, loss_p), f"{name}: the first step's losses equal")
    grad_check = {"loss": float(loss_k), **compare_grad_dicts(name, got, want)}
    del got, want, recorded, peer0
    check(grad_check["rel_norm_err"] < LM_GRAD_REL_NORM,
          f"{name} gradients: relative norm error {grad_check['rel_norm_err']}")
    print(f"{name} first step ({card.line}): loss {float(loss_k):.6f}; gradients against the "
          f"plain backwards: relative norm error {grad_check['rel_norm_err']:.3g}, max abs "
          f"error {grad_check['max_abs_err']:.3g} of max |grad| {grad_check['max_abs']:.3g}",
          flush=True)

    print(f"main path: {name} full width, K={k} ring, batch {STEP_API_BATCH} seq "
          f"{STEP_API_SEQ}, T={t_steps}, {rounds} rounds through make_train_step and "
          f"make_consensus_step", flush=True)
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()
    train_s, consensus_s, losses = [], [], []
    with count_plain_calls() as plain_calls:
        for r in range(rounds):
            trained = []
            for i in range(k):
                params = {leaf: v[i] for leaf, v in stacked.items()}
                d_i = {leaf: v[i] for leaf, v in d_bias.items()}
                for t in range(t_steps):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    params, opt_states[i], loss = train_step(
                        params, opt_states[i], d_i, batch((r * t_steps + t) * k + i),
                        r * t_steps + t)
                    torch.cuda.synchronize()
                    train_s.append(time.perf_counter() - start)
                    losses.append(float(loss))
                trained.append(params)
            stacked = {leaf: torch.stack([p[leaf] for p in trained]) for leaf in stacked}
            del trained, params
            torch.cuda.synchronize()
            start = time.perf_counter()
            stacked, d_bias = consensus_step(stacked, d_bias)
            torch.cuda.synchronize()
            consensus_s.append(time.perf_counter() - start)
    launches = {key: c.count for key, c in counters.items()}
    steps_run = rounds * k * t_steps
    want_launches = {key: 0 for key in counters} | {
        key: n * steps_run for key, n in lm_step_launches(cfg).items()} | {
        "consensus_mix": rounds}
    check(launches == want_launches, f"{name} launched {launches}, want {want_launches}")
    check(not plain_calls, f"{name} called plain versions {plain_calls}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(v) for v in losses), f"{name} losses finite: {losses}")
    for what, tree in (("params", stacked), ("d", d_bias)):
        check(all(bool(torch.isfinite(v.float()).all()) for v in tree.values()),
              f"{name}: {what} finite")
    check(all(v.dtype == torch.bfloat16 for v in stacked.values())
          and all(v.dtype == torch.float32 for v in d_bias.values()),
          f"{name}: mixed leaves bf16, d float32")

    # outside the count: the consensus step against its plain version
    mixed, d_new = consensus_step(stacked, d_bias)
    flat = ops.flatten_pytree(stacked)[0]
    sparse = graph_lib.SparseSchedule.from_dense(w_mat[None], beta_mat[None])
    plain_mixed, plain_d = ref.consensus_mix_stacked_ref(
        flat, *ops.select_round(ops.upload_schedule(sparse, dev), 0), t_steps)
    tol = CONSENSUS_BF16_TOL
    consensus_err = {"mixed": compare_tree(f"{name} consensus mixed", mixed, plain_mixed, tol),
                     "d": compare_tree(f"{name} consensus d", d_new, plain_d, tol)}
    del mixed, d_new, flat, plain_mixed, plain_d
    # make_consensus_step_psum against make_consensus_step, complete graph, uniform
    w_c = np.full((k, k), 1.0 / k)
    beta_c = (np.ones((k, k)) - np.eye(k)) / (k - 1)
    psum = steps.make_consensus_step_psum(k, self_weight=1 / k, peer_weight=1 / k,
                                          local_steps=t_steps, use_affinity=True)(stacked, None)
    kern = steps.make_consensus_step(w_c, beta_c, local_steps=t_steps,
                                     use_affinity=True)(stacked, None)
    psum_err = {"mixed": compare_tree(f"{name} psum mixed", psum[0], kern[0], tol),
                "d": compare_tree(f"{name} psum d", psum[1], kern[1], tol)}
    del psum, kern
    # make_multipod_train_step on peers 0 and 1 (the kernels' Functions under
    # torch.func.vmap: their vmap rules fold the peers into the batch)
    # against each peer's make_train_step, one step at the schedule's peak
    def stack(trees):
        return pytree.tree_map(lambda *xs: torch.stack(xs), *trees)

    two = [{leaf: v[i] for leaf, v in tree.items()} for tree in (stacked, d_bias) for i in (0, 1)]
    torch.cuda.synchronize()
    start = time.perf_counter()
    got = steps.make_multipod_train_step(model, opt, eta_d=0.25)(
        stack(two[:2]), stack(opt_states[:2]), stack(two[2:]), stack([batch(0), batch(1)]), 1)
    torch.cuda.synchronize()
    multipod_s = time.perf_counter() - start
    multipod_err = {}

    def flat(tree):
        return torch.cat([tree[leaf].reshape(-1) for leaf in sorted(tree)])

    for i in (0, 1):
        want = train_step(two[i], opt_states[i], two[2 + i], batch(i), 1)
        multipod_err[f"peer {i} loss"] = compare_tree(f"{name} multipod peer {i} loss",
                                                      got[2][i], want[2], tol)
        multipod_err[f"peer {i} params"] = compare_tree(
            f"{name} multipod peer {i} params",
            flat({leaf: v[i] for leaf, v in got[0].items()}), flat(want[0]), tol)
        del want
    del got, two
    # a checkpoint of the stacked parameters and peer 0's AdamW state
    tree = {"params": stacked, "opt0": opt_states[0]}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        path = os.path.join(tmp, "step_api")
        start = time.perf_counter()
        checkpoint.save(path, tree, step=rounds * t_steps, extra={"arch": LM_ARCH})
        save_s = time.perf_counter() - start
        start = time.perf_counter()
        restored = checkpoint.restore(path, tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - start
        meta = checkpoint.load_metadata(path)
        ckpt_gb = os.path.getsize(path + ".npz") / 1e9
    leaves = pytree.leaves_with_path(tree)
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for (p, want_leaf), got_leaf in zip(leaves, pytree.leaves(restored)):
        check(got_leaf.device == want_leaf.device and got_leaf.dtype == want_leaf.dtype
              and torch.equal(got_leaf.view(bits[got_leaf.dtype]),
                              want_leaf.view(bits[want_leaf.dtype])),
              f"{name}: checkpoint leaf {'/'.join(p)} restored bit for bit")
    check(meta["step"] == rounds * t_steps and len(meta["keys"]) == len(leaves),
          f"{name}: checkpoint metadata {meta['step']}, {len(meta['keys'])} keys")
    del restored, tree
    print(f"{name} ({card.line}): set-up {setup_s:.2f} s; seconds per train step {train_s} "
          f"(mean {sum(train_s) / len(train_s):.4f}); seconds per consensus step "
          f"{consensus_s}; peak memory {peak_gb:.3f} GB; losses {losses}; launches "
          f"{ {key: v for key, v in launches.items() if v} }; consensus against its plain "
          f"version, max abs error {json.dumps(consensus_err)}; psum against the kernel step "
          f"on the complete graph {json.dumps(psum_err)}; make_multipod_train_step on 2 peers "
          f"{multipod_s:.3f} s, against make_train_step {json.dumps(multipod_err)}; "
          f"checkpoint {ckpt_gb:.3f} GB "
          f"({len(leaves)} leaves) saved in {save_s:.2f} s, restored bit for bit in "
          f"{restore_s:.2f} s", flush=True)
    del stacked, d_bias, opt_states
    torch.cuda.empty_cache()
    return {"launches": {key: v for key, v in launches.items() if v}, "train_step_s": train_s,
            "consensus_step_s": consensus_s, "peak_gb": peak_gb, "losses": losses,
            "setup_s": setup_s, "grad_check": {key: v for key, v in grad_check.items()
                                               if key != "leaf_rel_norm_err"},
            "consensus_max_abs_err": consensus_err, "psum_max_abs_err": psum_err,
            "multipod_s": multipod_s, "multipod_max_abs_err": multipod_err,
            "checkpoint": {"gb": ckpt_gb, "save_s": save_s, "restore_s": restore_s}}


def drive_step_api(card: Card) -> dict:
    """The reference's public API on the card (``step_api_wrappers``, then
    ``step_api_smollm``): the launches of both, under one path."""
    start = time.perf_counter()
    wrappers = step_api_wrappers(card)
    smollm = step_api_smollm(card)
    launches = dict(wrappers["launches"])
    for key, n in smollm["launches"].items():
        launches[key] = launches.get(key, 0) + n
    seconds = time.perf_counter() - start
    print(f"drive_step_api ({card.line}): {seconds:.1f} s, launches {launches}", flush=True)
    return {"launches": launches, "seconds": seconds, "wrappers": wrappers, "smollm": smollm}


SEQMNIST = "rwkv6_seqmnist"
SEQMNIST_ROUNDS = 2


def seqmnist_params(k: int, seed: int = 0) -> dict[str, torch.Tensor]:
    """``k`` draws of the classifier's parameters, stacked, on the CPU."""
    from repro_torch.core import task as task_lib

    task = task_lib.get_task(SEQMNIST)
    gen = torch.Generator().manual_seed(seed)
    peers = [task.init_params(gen) for _ in range(k)]
    return {name: torch.stack([p[name] for p in peers]) for name in task.param_shapes}


def check_classifier_on_card() -> dict:
    """The task's K-batched loss (``torch.func.vmap`` of the classifier, the
    RNN form) and its per-leaf gradients on the card against the same
    function on the CPU, from the same parameters and one (K, B, 196) token
    batch, TF32 off; at atol 5e-5 / rtol 1e-4 (``TOL``).  The RNN form
    reaches no kernel: no launch may be counted."""
    from repro_torch.core import task as task_lib

    task = task_lib.get_task(SEQMNIST)
    k, b = 8, 10  # seqmnist_k8's peers and batch: one local step's
    params = seqmnist_params(k)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, 16, (k, b, 196)))
    labels = torch.as_tensor(rng.integers(0, 10, (k, b)))
    counters = launch_counters()
    for counter in counters.values():
        counter.reset()

    def loss_and_grads(dev):
        leaves = {n: t.to(dev).requires_grad_(True) for n, t in params.items()}
        losses = task.loss_fn(leaves, (tokens.to(dev), labels.to(dev)))
        grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
        return losses.detach().cpu(), [g.cpu() for g in grads]

    (cpu_l, cpu_g), (card_l, card_g) = loss_and_grads("cpu"), loss_and_grads("cuda")
    launched = {key: c.count for key, c in counters.items() if c.count}
    check(not launched, f"the classifier's RNN form launched {launched}")
    torch.testing.assert_close(card_l, cpu_l, **TOL, msg=lambda m: f"classifier losses: {m}")
    for name, got, want in zip(params, card_g, cpu_g):
        torch.testing.assert_close(got, want, **TOL,
                                   msg=lambda m, n=name: f"classifier grad {n}: {m}")
    out = {"K": k, "B": b, "T": 196,
           "loss_max_abs_diff": float((card_l - cpu_l).abs().max()),
           "grad_max_abs_diff": max(float((g - w).abs().max()) for g, w in zip(card_g, cpu_g)),
           "tolerance": TOL}
    print(f"classifier on the card against the CPU: {json.dumps(out)}", flush=True)
    return out


def check_seqmnist_wkv6(card: Card) -> dict:
    """``rwkv6_features(chunked=True)`` on the card (each layer's WKV through
    ``wkv6``: 2 launches) against ``chunked=False`` (the token loop) at the
    task's shape, B = 256 as the chunked eval's chunks (``WKV6_TOL``); then
    one ``wkv6`` call at B 256, T 196, H 4, dk 16, chunk 49, from a zero and
    from a random state, against its plain version, the first timed in
    turns."""
    from repro_torch.core import task as task_lib
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops
    from repro_torch.models import transformer as tf

    cfg = task_lib.seqmnist_model_config()
    params = {n: t[0].cuda() for n, t in seqmnist_params(1, seed=1).items()}
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 16, (256, 196)),
                             device="cuda")
    wkv6_ops.launches.reset()
    with torch.no_grad():
        chunked = tf.rwkv6_features(params, cfg, tokens, chunked=True)
        launched = wkv6_ops.launches.count
        loop = tf.rwkv6_features(params, cfg, tokens, chunked=False)
    check(launched == cfg.num_layers, f"rwkv6_features(chunked=True) launched wkv6 {launched} "
                                      f"times, want {cfg.num_layers}")
    check(wkv6_ops.launches.count == launched, "the token loop launched wkv6")
    torch.testing.assert_close(chunked, loop, **WKV6_TOL,
                               msg=lambda m: f"features, wkv6 against the token loop: {m}")
    features_err = float((chunked - loop).abs().max())
    del chunked, loop
    cases = [wkv6_case(card, "seqmnist_b256_t196_q49", 256, 196, 4, 16, 49, timed=True, seed=11),
             wkv6_case(card, "seqmnist_b256_t196_q49_state", 256, 196, 4, 16, 49, state=True,
                       ld=(1e-4, 2e-2), seed=12)]
    for c in cases:
        _print_wkv6_case(c)
    print(f"features at B=256 T=196: wkv6 against the token loop, max |diff| "
          f"{features_err:.3g} (atol = rtol = 1e-3)", flush=True)
    return {"features_max_abs_diff": features_err, "cases": cases}


def captured_kernel_names(fn) -> list[str]:
    """The kernels that a CUDA graph of one call of ``fn`` holds, by their
    (mangled) names, read from the graph's nodes with the CUDA driver
    (``cuGraphGetNodes``, ``cuFuncGetName``): a count that no profiler
    buffer can drop.  ``fn`` is warmed up once on a side stream and captured
    into a graph of its own, which is kept for reading and never replayed;
    the launch counters keep the counts they had."""
    import ctypes
    import gc

    from repro_torch.kernels.build import LaunchCounter

    drv = ctypes.CDLL("libcuda.so.1")

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p),
                    *((f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x",
                                                    "block_y", "block_z", "shared_bytes")),
                    ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    def call(name, *args):
        rc = getattr(drv, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} failed: CUresult {rc}")

    def names_of(graph) -> list[str]:
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", ctypes.c_void_p(graph), None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        call("cuGraphGetNodes", ctypes.c_void_p(graph), nodes, ctypes.byref(n))
        out = []
        for node in nodes:
            kind = ctypes.c_int(-1)
            call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
            if kind.value == 4:  # CU_GRAPH_NODE_TYPE_GRAPH: a child graph
                child = ctypes.c_void_p()
                call("cuGraphChildGraphNodeGetGraph", ctypes.c_void_p(node), ctypes.byref(child))
                out += names_of(child.value)
            elif kind.value == 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                params, name = KernelNodeParams(), ctypes.c_char_p()
                call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(params))
                if params.func:
                    call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
                else:
                    call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
                out.append(name.value.decode())
        return out

    counts = [c.count for c in LaunchCounter.instances]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    gc.disable()  # as capture.Captured: no collection of another graph mid-capture
    try:
        with torch.cuda.graph(graph, stream=stream):
            fn()
    finally:
        gc.enable()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    for counter, count in zip(LaunchCounter.instances, counts):
        counter.count = count
    names = names_of(graph.raw_cuda_graph())
    del graph
    return names


EAGER_PROFILE_TRIES = 3


def profile_seqmnist_round(card: Card, exp, data) -> dict:
    """One ``exp`` round both ways under torch.profiler: an eager round of
    the python driver's round function, and a replay of the scan driver's
    captured round (``ScanDriver.captured``, after one chunk of 2 rounds):
    kernels, device time, wall seconds, and the graph's capture seconds
    (warm-up round included).  A replay launches only what the capture
    recorded, which must be the eager round's matmuls, one for one: the
    graph's are counted from its nodes (``captured_kernel_names``), the
    eager round's from its profile.  The profiler can drop kernel records
    when tens of thousands arrive at once, and never adds one: an eager
    profile that counts fewer matmuls than the graph's nodes is taken again,
    up to ``EAGER_PROFILE_TRIES`` times, and each count is reported; one
    count above the graph's fails at once.  The total counts
    differ by a few tens either way (the graph's static-buffer copies, the
    eager round's batch upload and the one-time work of its first calls,
    whose count falls from call to call), so they are reported, not
    compared."""
    from repro_torch.core import p2p, task as task_lib
    from repro_torch.launch import train

    dev = torch.device("cuda")
    cfg = exp.p2p
    task = task_lib.get_task(cfg.model)
    parts = train.mnist_parts(exp, data[0], data[1])
    sizes = np.asarray([len(p[0]) for p in parts])
    batcher = task.make_peer_batches(parts, exp.batch_size, seed=0)
    state = p2p.init_state(task, cfg, data_sizes=sizes, device=dev)
    round_fn = p2p.make_round_fn(task, cfg, sizes, device=dev)
    batches = batcher.round_batches_on(cfg.local_steps, dev)
    round_fn(state, batches)  # warm-up: cuBLAS handles, allocator, autograd
    torch.cuda.synchronize()
    eager = profile_once(lambda: round_fn(state, batches))
    drive_fn = p2p.make_scan_driver(task, cfg, sizes, device=dev, donate=False)
    drive_fn(state, batcher.chunk_batches_on(cfg.local_steps, 2, dev))
    replay = profile_once(drive_fn.captured.replay, cpu=False)
    replay_ms = cuda_ms(drive_fn.captured.replay, target_s=0.5)
    # the graph's kernels from its nodes, not from a profile: profiles of one
    # replay counted 58022-58061 kernels and 4994-4996 matmuls (the
    # profiler's buffers can drop records when some 58k kernels arrive at once)
    graph_kernels = captured_kernel_names(drive_fn.captured.fn)
    graph_matmuls = sum(kernel_category(name) == "matmul" for name in graph_kernels)
    eager_counts = [eager["by_category_launches_ms"].get("matmul", [0])[0]]
    while eager_counts[-1] < graph_matmuls and len(eager_counts) < EAGER_PROFILE_TRIES:
        eager = profile_once(lambda: round_fn(state, batches))
        eager_counts.append(eager["by_category_launches_ms"].get("matmul", [0])[0])
    matmuls = {"eager": eager_counts[-1], "graph": graph_matmuls,
               "eager_profiles": eager_counts}
    out = {"card": card.line, "capture_s": drive_fn.capture_seconds,
           "eager_round": {key: eager[key] for key in ("wall_s", "device_busy_s", "kernels")},
           "replay": {key: replay[key] for key in ("wall_s", "device_busy_s", "kernels")},
           "graph_kernel_nodes": len(graph_kernels), "matmuls": matmuls,
           "replay_ms_cuda_events": replay_ms,
           "replay_by_category": replay["by_category_launches_ms"],
           "replay_top_kernels_ms": replay["top_kernels_ms"]}
    print(f"seqmnist round profile ({card.line}): {json.dumps(out)}", flush=True)
    if matmuls["graph"] != matmuls["eager"]:  # which matmul kernels differ, by name
        graph_names = collections.Counter(n for n in graph_kernels
                                          if kernel_category(n) == "matmul")
        names = {"eager": {k: n for k, n, _ in eager["matmul_kernels"]},
                 "graph": dict(graph_names)}
        print(f"seqmnist round profile: matmul kernels by name {json.dumps(names)}", flush=True)
    check(matmuls["graph"] == matmuls["eager"] > 0,
          f"the captured round holds {matmuls['graph']} matmuls, the eager round ran "
          f"{matmuls['eager']}")
    return out


def seqmnist_phase(card: Card, data, cases: dict, paths: dict) -> dict:
    """RWKV6 on sequential MNIST (``seqmnist_k8``, K = 8, T = 4, 31 leaves,
    N = 100,236): the classifier on the card against the CPU, ``wkv6`` at
    the task's shape, ``consensus_mix`` (and its mass
    mode) and ``dequant_mix`` held and timed at the task's row, three
    training runs through ``run_paper_experiment`` (gossip static, push-sum
    static, gossip round robin over qint8; launches counted, no plain
    version, the mass watched, one consensus phase rechecked), both drivers
    on gossip and push-sum, and one round's kernels both ways.  Adds its
    cases and paths to ``cases`` and ``paths``; returns its own results and
    seconds."""
    from repro_torch.configs.p2pl_mnist import seqmnist_k8
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of

    start = time.perf_counter()
    out = {"classifier": check_classifier_on_card()}
    wkv6 = check_seqmnist_wkv6(card)
    cases["wkv6"].extend(wkv6["cases"])
    out["features_max_abs_diff"] = wkv6["features_max_abs_diff"]
    layout = layout_of(SEQMNIST)
    check((len(layout.shapes), layout.size, layout.row) == (31, 100_234, 100_236),
          f"seqmnist layout {len(layout.shapes)} leaves, {layout.size} -> {layout.row}")
    ring, sizes = graph_lib.build_graph("ring", 8), np.full(8, 100)
    new = {"consensus_mix": consensus_case(card, "seqmnist_k8_ring", ring, sizes, layout.row,
                                           want_path="gather", seed=13),
           "consensus_mix mass": consensus_mass_case(card, "seqmnist_k8_ring_push_sum", ring,
                                                     sizes, layout.row, want_path="gather",
                                                     seed=14),
           "dequant_mix": dequant_case(card, "seqmnist_k8_ring_qint8", ring, sizes,
                                       layout.leaf_offsets, layout.row, seed=15)}
    for kernel, c in new.items():
        cases[kernel].append(c)
        _print_case(kernel, c)
    gossip, push = seqmnist_k8(), seqmnist_k8(protocol="push_sum")
    rr = seqmnist_k8(schedule="round_robin")
    rr_qint8 = dataclasses.replace(rr, p2p=dataclasses.replace(rr.p2p, compressor="qint8"))
    paths |= {
        "seqmnist_k8": drive("seqmnist_k8", gossip, SEQMNIST_ROUNDS, data, recheck=True),
        "seqmnist_k8_push_sum": drive("seqmnist_k8_push_sum", push, SEQMNIST_ROUNDS, data,
                                      recheck=True),
        "seqmnist_k8_round_robin_qint8": drive("seqmnist_k8_round_robin_qint8", rr_qint8,
                                               SEQMNIST_ROUNDS, data, recheck=True),
    }
    for label, exp in (("seqmnist_k8", gossip), ("seqmnist_k8_push_sum", push)):
        result = compare_drivers(card, label, exp, 4, 2, data, kernel="consensus_mix")
        result["mode"] = "mass" if exp.p2p.protocol == "push_sum" else "gossip"
        paths[f"{label}_both_drivers"] = result
    out["round_profile"] = profile_seqmnist_round(card, gossip, data)
    out["seconds"] = time.perf_counter() - start
    print(f"seqmnist phase ({card.line}): {out['seconds']:.1f} s", flush=True)
    return out


SERVE_ARCH = "rwkv6-7b"
DECODER_ARCH = "minitron-8b"
HYBRID_ARCH = "zamba2-2.7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 16
FLEET_PEERS = 2
LONG_PROMPT, LONG_GEN = 8192, 4
# the last two families at full size (nothing cut): internvl2-2b, a 256-patch
# image prefix before 768 text tokens, 24 layers; seamless-m4t-medium, 256
# frames through 12 encoder layers (non-causal) and 768 tokens through 12
# decoder layers; (arch, launches a prefill, rechecked calls: the first and
# last layer's, and seamless's first and last encoder and decoder calls)
VLM_ENCDEC_SERVED = (("internvl2-2b", {"flash_attention": 24}, {"flash_attention": (0, 23)}),
                     ("seamless-m4t-medium", {"flash_attention": 24},
                      {"flash_attention": (0, 11, 12, 23)}))
# the MoE decoders at published widths, depth cut to fit one 80 GB card (bf16
# parameters 42.5 and 42.3 GB): deepseek's dense layer 0 and 5 MoE layers,
# qwen3-moe's first 8 layers; (arch, layers, launches a prefill, rechecked calls)
MOE_SERVED = (("deepseek-v2-236b", 6, {}, {}),
              ("qwen3-moe-235b-a22b", 8, {"flash_attention": 8}, {"flash_attention": (0, 7)}))
MOE_REL_NORM = 1e-2  # bf16: the dispatch against the dense oracle, absorbed MLA against expanded
MOE_DENSE_TOKENS = 128  # of each prompt row: 512 tokens through every expert in the oracle


def _serving_launches(counters: dict, want: dict, name: str) -> dict:
    launches = {key: counter.count for key, counter in counters.items()}
    want = {key: 0 for key in counters} | want
    check(launches == want, f"{name} launched {launches}, want {want}")
    return launches


def prompt_seq_len(prompt: dict) -> int:
    """The length ``make_batch`` was given: the text tokens, and the vlm
    patches or the encoder-decoder's frames."""
    return sum(prompt[k].shape[1] for k in ("tokens", "patches", "frames") if k in prompt)


def ring_positions(n_slots: int, written: int, device) -> torch.Tensor:
    """(n_slots,) int32: the positions a KV cache of ``n_slots`` slots holds
    after positions 0 .. written - 1 were written in order, each at its slot
    ``pos % n_slots`` (-1 where none was)."""
    want = torch.full((n_slots,), -1, dtype=torch.int32, device=device)
    last = torch.arange(max(written - n_slots, 0), written, dtype=torch.int32, device=device)
    want[last.long() % n_slots] = last
    return want


def served_config(arch: str, layers: int | None = None):
    """``arch``'s published config, its depth cut to ``layers`` if given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def drive_serve_batch(card: Card, arch: str, per_prefill: dict[str, int], *,
                      layers: int | None = None) -> dict:
    """``serve_batch`` of ``arch`` at full width and depth (bf16, random init
    from seed 0 on the card), or, with ``layers``, ``serve_model`` (the
    helper ``serve_batch`` runs) on the published config cut to that depth;
    launch counts set to 0 just before and read just after each call: first
    with ``gen_tokens=1`` (prefill only, the explicit empty decode), where
    each kernel of ``per_prefill`` launches the number given and every other
    kernel none; then prefill plus 15 decode steps, where they launch the
    same numbers in all, so the decode launched none.  Every KV cache's
    positions are checked: the prompt's decoder side (the vlm's patches and
    text; the encoder-decoder's text), then the decoded tokens, each at its
    slot ``pos % cache_len``; the encoder-decoder's cache has
    ``split_encdec_seq(prompt + gen)`` decoder slots, as the reference's,
    so its last decode positions wrap onto the first slots."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.registry import split_encdec_seq

    cfg = served_config(arch, layers)
    depth = "full" if layers is None else f"full width, {layers} of " \
        f"{served_config(arch).num_layers} layers"
    counters = launch_counters()
    runs = {}
    for label, gen in (("prefill_only", 1), ("prefill_decode", SERVE_GEN)):
        print(f"main path: serve_batch {arch} {depth}, batch {SERVE_BATCH}, prompt "
              f"{SERVE_PROMPT}, gen {gen}", flush=True)
        torch.cuda.empty_cache()
        for counter in counters.values():
            counter.reset()
        kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen_tokens=gen, seed=0,
                  verbose=True, device="cuda")
        if layers is None:
            out = serve.serve_batch(arch, use_reduced=False, **kw)
        else:
            out = serve.serve_model(build_model(cfg), **kw)
        launches = _serving_launches(counters, per_prefill, f"serve_batch {arch} gen={gen}")
        tokens = out["tokens"]
        check(tuple(tokens.shape) == (SERVE_BATCH, gen), f"serve_batch tokens {tokens.shape}")
        check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
              "serve_batch tokens in the vocab")
        for name, leaf in out["cache"].items():
            check(bool(torch.isfinite(leaf.float()).all()), f"serve_batch cache {name} finite")
        runs[label] = {key: out[key] for key in ("prefill_s", "decode_steps",
                                                 "decode_s_per_token", "tokens_per_s",
                                                 "peak_memory_gb", "params_gb")}
        runs[label]["launches"] = {k: launches[k] for k in per_prefill}
        runs[label]["tokens"] = tokens[0].tolist()
        dec_len = split_encdec_seq(SERVE_PROMPT)[1] if cfg.family == "encdec" else SERVE_PROMPT
        for name in ("main.pos_ids", "first.pos_ids", "attn.pos_ids", "self.pos_ids"):
            if name in out["cache"]:  # KV caches' positions: 0 .. dec_len + gen - 2
                held = out["cache"][name]
                want_pos = ring_positions(held.shape[-1], dec_len + gen - 1, "cuda")
                check(bool((held == want_pos).all()), f"serve_batch cache positions {name}: "
                      f"slots 0-2 {held[0, 0, :3].tolist()}, want {want_pos[:3].tolist()}")
                runs[label]["pos_ids_slots_0_3"] = held[0, 0, :4].tolist()
        if cfg.family == "encdec":  # the prefill's cross k and v, not the cache's 260 frames
            enc_len = split_encdec_seq(SERVE_PROMPT)[0]
            for name in ("cross_k", "cross_v"):
                check(tuple(out["cache"][name].shape) == (
                    cfg.num_layers, SERVE_BATCH, enc_len, cfg.attention.num_kv_heads,
                    cfg.attention.head_dim), f"serve_batch {name} {out['cache'][name].shape}")
        del out
    check(runs["prefill_only"]["tokens"][0] == runs["prefill_decode"]["tokens"][0],
          "the prefill token does not depend on the decode length")
    print(f"serve_batch {arch} ({card.line}): {json.dumps(runs)}", flush=True)
    print(f"serve_batch {arch}: peak memory {runs['prefill_decode']['peak_memory_gb']:.3f} GB "
          f"beside {runs['prefill_decode']['params_gb']:.3f} GB of parameters", flush=True)
    return {"launches": {k: sum(r["launches"][k] for r in runs.values()) for k in per_prefill},
            "runs": runs,
            "launches_by_phase": {k: {"prefill": runs["prefill_only"]["launches"][k],
                                      "decode": runs["prefill_decode"]["launches"][k]
                                      - runs["prefill_only"]["launches"][k]}
                                  for k in per_prefill}}


def decode_step_bytes(params: dict, cache: dict) -> int:
    """The bytes one decode step must read: every parameter but an untied
    embedding table, of which it gathers B rows (a tied one the unembedding
    reads whole), and every leaf of the prefill's cache."""
    nbytes = sum(t.numel() * t.element_size() for t in (*params.values(), *cache.values()))
    if "lm_head" in params:
        nbytes -= params["embed"].numel() * params["embed"].element_size()
    return nbytes


def time_and_profile_serving(model, params, prompt, cache0) -> dict:
    """One warm prefill and one warm decode step (after a warm-up step),
    timed by host clocks around device synchronizes, then each profiled;
    and the bytes a decode step must read (``decode_step_bytes``)."""
    from repro_torch.launch import steps

    prefill = steps.make_prefill_step(model)
    decode = steps.make_serve_step(model)
    out = {}
    torch.cuda.synchronize()
    start = time.perf_counter()
    tok, cache = prefill(params, prompt, cache0)
    torch.cuda.synchronize()
    out["warm_prefill_s"] = time.perf_counter() - start
    out["decode_step_bytes"] = decode_step_bytes(params, cache)
    pos = torch.full((SERVE_BATCH,), steps.prompt_dec_len(prompt), dtype=torch.int64,
                     device="cuda")
    decode(params, cache, tok, pos)  # warm-up step
    torch.cuda.synchronize()
    start = time.perf_counter()
    decode(params, cache, tok, pos)
    torch.cuda.synchronize()
    out["warm_decode_step_s"] = time.perf_counter() - start
    for phase, fn in (("prefill", lambda: prefill(params, prompt, cache0)),
                      ("decode_step", lambda: decode(params, cache, tok, pos))):
        out[phase] = profile_once(fn)
    return out


def _compare_wkv6(args, kwargs, got, want, what) -> dict:
    rec = {"logdecay_range": [float(args[3].min()), float(args[3].max())],
           "o_max_abs": float(want[0].abs().max())}
    rec["o_dtype"] = str(got[0].dtype).removeprefix("torch.")
    for g, w, part in ((got[0], want[0], "o"), (got[1], want[1], "state")):
        tol = WKV6_BF16_TOL if g.dtype == torch.bfloat16 else WKV6_TOL
        torch.testing.assert_close(g.float(), w, **tol, msg=lambda m: f"{what} {part}: {m}")
        rec[f"{part}_max_abs_err"] = float((g.float() - w).abs().max())
    return rec


def _compare_flash(args, kwargs, got, want, what) -> dict:
    return {**check_flash(got, want, what), "q_max_abs": float(args[0].float().abs().max()),
            "S": args[0].shape[1], "causal": kwargs.get("causal", True)}


def _compare_ssd(args, kwargs, got, want, what) -> dict:
    x, dt = args[0], args[3]
    rec = {"x_dtype": str(x.dtype), "x_strides": list(x.stride()),
           "y_max_abs": float(want[0].abs().max()),
           "dt_range": [float(dt.min()), float(dt.max())]}
    for g, w, part in ((got[0], want[0], "y"), (got[1], want[1], "state")):
        torch.testing.assert_close(g, w, **TOL, msg=lambda m: f"{what} {part}: {m}")
        rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
        check(rel < SSD_REL_NORM, f"{what} {part}: relative norm error {rel}")
        rec[f"{part}_max_abs_err"] = float((g - w).abs().max())
        rec[f"{part}_rel_norm_err"] = rel
    return rec


def _recheck_wrappers() -> dict:
    """kernel -> (wrapper's module, wrapper's name, plain version with the
    wrapper's signature, comparison)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.rwkv6 import ops as wkv6_ops
    from repro_torch.kernels.rwkv6 import ref as wkv6_ref

    def wkv6_plain(r, k, v, ld, u, *, state=None, chunk=16):
        return wkv6_ref.wkv6_chunked_ref(r, k, v, ld, u, state, chunk=chunk)

    return {"wkv6": (wkv6_ops, "wkv6", wkv6_plain, _compare_wkv6),
            "flash_attention": (flash_ops, "gqa_flash_attention", flash_ref.gqa_attention_ref,
                                _compare_flash),
            "ssd": (ssd_ops, "ssd", ssd_ref.ssd_chunked_ref, _compare_ssd)}


@contextlib.contextmanager
def recheck_calls(picks: dict[str, tuple[int, ...]], log: dict):
    """Wrap the kernel wrappers named in ``picks`` while the block runs: the
    calls numbered there (in the order the block makes them) also go through
    the plain version on the very same operands, views and strides as given,
    and are compared; the readings go to ``log[kernel][f"call{i}"]``."""
    wrappers = _recheck_wrappers()
    saved = []
    for kernel, numbers in picks.items():
        module, name, plain, compare = wrappers[kernel]
        real = getattr(module, name)
        calls = itertools.count()
        log[kernel] = {}

        def wrapped(*args, _real=real, _plain=plain, _compare=compare, _kernel=kernel,
                    _numbers=numbers, _calls=calls, **kwargs):
            i = next(_calls)
            got = _real(*args, **kwargs)
            if i in _numbers:
                want = _plain(*args, **kwargs)
                torch.cuda.synchronize()
                rec = _compare(args, kwargs, got, want, f"{_kernel} call {i}")
                log[_kernel][f"call{i}"] = rec
                print(f"{_kernel} call {i} of the prefill at full width: kernel vs plain "
                      f"version {json.dumps(rec)}", flush=True)
            return got

        saved.append((module, name, real))
        setattr(module, name, wrapped)
    try:
        yield log
    finally:
        for module, name, real in saved:
            setattr(module, name, real)
    for kernel, numbers in picks.items():
        check(sorted(log[kernel]) == sorted(f"call{i}" for i in numbers),
              f"{kernel}: rechecked {sorted(log[kernel])}, want calls {numbers}")


def compare_decode(card: Card, name: str, model, params, prompt, per_prefill: dict[str, int],
                   *, gen: int = SERVE_GEN) -> dict:
    """One prefill of ``prompt``, then its ``gen - 1`` decode steps both ways
    from the prefill's cache: the python loop (``make_decode_loop``, which
    leaves the cache as it was), then the scanned decode
    (``make_decode_scan``: one captured CUDA graph of the step, replayed per
    token, consuming the cache).  Launch counts set to 0 just before and
    read just after each: the prefill's kernels as ``per_prefill``, none in
    either decode.  Tokens and every leaf of the final cache must be equal.
    Prints decode s/token both ways, the capture seconds, a warm replay's
    seconds (the replays' wall time over their count), the CUDA kernels of
    one step both ways (torch.profiler: an eager step, one replay) and the
    peak memory both ways."""
    from repro_torch.launch import steps

    dev = prompt["tokens"].device
    batch = prompt["tokens"].shape[0]
    counters = launch_counters()
    torch.cuda.empty_cache()
    for counter in counters.values():
        counter.reset()
    tok, cache = steps.make_prefill_step(model)(
        params, prompt, model.init_cache(batch, prompt_seq_len(prompt) + gen, dev))
    torch.cuda.synchronize()
    _serving_launches(counters, per_prefill, f"{name} prefill")
    pos = torch.full((batch,), steps.prompt_dec_len(prompt), dtype=torch.int64, device=dev)
    out, toks, caches = {"card": card.line}, {}, {}
    for impl in ("python", "scan"):
        make = steps.make_decode_loop if impl == "python" else steps.make_decode_scan
        decode = make(model, gen - 1)
        for counter in counters.values():
            counter.reset()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        toks[impl], caches[impl] = decode(params, cache, tok, pos)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        _serving_launches(counters, {}, f"{name} decode ({impl})")
        out.setdefault("decode_s_per_token", {})[impl] = seconds / (gen - 1)
        out.setdefault("peak_gb", {})[impl] = torch.cuda.max_memory_allocated() / 1e9
        if impl == "scan":
            out["capture_s"] = decode.capture_seconds
            out["replay_s_per_step"] = (seconds - decode.capture_seconds) / (gen - 2)
    check(torch.equal(toks["python"], toks["scan"]),
          f"{name}: decode tokens differ: {toks['python'].tolist()} vs {toks['scan'].tolist()}")
    for leaf in caches["python"]:
        a, b = caches["python"][leaf], caches["scan"][leaf]
        check(torch.equal(a, b), f"{name}: final cache {leaf} differs, max |diff| "
                                 f"{float((a.float() - b.float()).abs().max())}")
    out["tokens"] = [int(tok[0])] + toks["scan"][0].tolist()
    # one more step each way from the final cache, profiled
    last = toks["scan"][:, -1].clone()
    at = pos + gen - 1
    eager = steps.make_serve_step(model)
    captured = steps.make_decode_scan(model, 2).capture_step(params, caches["scan"],
                                                            last.clone(), at.clone())
    profiles = {"python": profile_once(lambda: eager(params, caches["python"], last, at)),
                "scan": profile_once(captured.replay)}
    del captured
    out["kernels_per_step"] = {impl: p["kernels"] for impl, p in profiles.items()}
    out["profiled_step"] = {impl: {k: p[k] for k in ("wall_s", "device_busy_s",
                                                     "device_busy_share")}
                            for impl, p in profiles.items()}
    print(f"decode both ways {name} ({card.line}): {json.dumps(out)}", flush=True)
    del cache, caches
    torch.cuda.empty_cache()
    return out


def recheck_and_break_down(card: Card, arch: str, picks: dict[str, tuple[int, ...]],
                           per_prefill: dict[str, int], *, layers: int | None = None,
                           extra=None) -> dict:
    """The served ``arch`` again (seed 0: the same parameters and prompt as
    ``serve_batch``; with ``layers``, its depth cut so): one prefill through
    ``model.prefill`` in which the
    kernel calls of ``picks`` (call i is layer i's, or the shared block's
    i-th application) are rerun through the plain version on the operands
    the served path gives them (``recheck_calls``); then one warm prefill
    and one warm decode step timed, and each profiled for its kernels; then,
    on the same parameters, the decode both ways (``compare_decode``, the
    prefill launching ``per_prefill``); then ``extra(card, model, params,
    prompt)`` where given, its result under ``"checks"``."""
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    model = build_model(served_config(arch, layers))
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    prompt = model.make_batch(gen, SERVE_BATCH, SERVE_PROMPT)
    out = {"recheck": {}}
    with torch.no_grad():
        cache0 = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, dev)
        with recheck_calls(picks, out["recheck"]):
            model.prefill(params, prompt, cache0)
        torch.cuda.empty_cache()
        out.update(time_and_profile_serving(model, params, prompt, cache0))
    out["decode_step_bound_ms"] = out["decode_step_bytes"] / card.bytes_per_s * 1e3
    print(f"serving breakdown {arch} ({card.line}): {json.dumps(out)}", flush=True)
    del cache0
    out["decode_both_ways"] = compare_decode(card, arch, model, params, prompt, per_prefill)
    if extra is not None:
        out["checks"] = extra(card, model, params, prompt)
    del params
    torch.cuda.empty_cache()
    return out


def mla_absorbed_vs_expanded(model, params, tok, cache) -> dict:
    """One decode step from ``cache`` (the prefill's) under ``mla_absorb``
    against the expanded step.  Layer by layer, the absorbed MLA on the very
    input and cache the expanded step gives that layer, each within
    ``MOE_REL_NORM``: there the two forms differ only by the expanded
    form's bf16 K and V (the reference's), the absorbed form being float32
    throughout.  The whole step's logits are compared and reported (their
    error grows through the layers and the MoE blocks of random weights).
    Both steps timed in turns."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import build_model

    cfg = model.cfg
    absorbed_attn = dataclasses.replace(cfg.attention, mla_absorb=True)
    absorbed = build_model(cfg.replace(attention=absorbed_attn))
    pos = torch.full((SERVE_BATCH,), SERVE_PROMPT, dtype=torch.int64, device=tok.device)
    step = {"expanded": lambda: model.decode_step(params, tok, pos, cache),
            "absorbed": lambda: absorbed.decode_step(params, tok, pos, cache)}
    layer_errs = []
    real_mla = attn_lib.mla_apply

    def mla(p, acfg, x, positions, **kw):
        o, c = real_mla(p, acfg, x, positions, **kw)
        layer_errs.append(rel_norm(real_mla(p, absorbed_attn, x, positions, **kw)[0], o))
        return o, c

    with torch.no_grad():
        attn_lib.mla_apply = mla
        try:
            expanded_logits = step["expanded"]()[0]
        finally:
            attn_lib.mla_apply = real_mla
        absorbed_logits = step["absorbed"]()[0]
        torch.cuda.synchronize()
        check(len(layer_errs) == cfg.num_layers, f"{len(layer_errs)} MLA layers compared")
        for i, err in enumerate(layer_errs):
            check(err < MOE_REL_NORM, f"{cfg.name}: absorbed MLA at layer {i}, relative norm "
                                      f"error {err}")
        out = {"layer_rel_norm_err": layer_errs,
               "logits_rel_norm_err": rel_norm(absorbed_logits, expanded_logits),
               "logits_max_abs_err": float((absorbed_logits - expanded_logits).abs().max()),
               "same_argmax": bool(torch.equal(absorbed_logits.argmax(-1),
                                               expanded_logits.argmax(-1)))}
        times = {"expanded": [], "absorbed": []}
        for name in ("expanded", "absorbed", "absorbed", "expanded"):
            times[name].append(cuda_ms(step[name]))
    return {**out, **{f"{name}_step_ms": sum(v) / len(v) for name, v in times.items()}}


def moe_checks(card: Card, model, params, prompt) -> dict:
    """On a MoE decoder at published widths: one prefill in which every MoE
    layer's input is routed once more to count the share of assignments
    dropped at the config's capacity factor (1.25); the first MoE layer's
    dispatch, on the first ``MOE_DENSE_TOKENS`` tokens of each prompt row of
    its real input, at a capacity factor that drops nothing (E / top_k)
    against ``apply_dense_reference`` (every expert on every token), within
    a relative norm error of ``MOE_REL_NORM``, and at 1.25 beside it; with
    MLA, one decode step from the prefill's cache under ``mla_absorb`` against
    the expanded step (logits within ``MOE_REL_NORM``), both timed in turns."""
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib

    cfg, dev = model.cfg, prompt["tokens"].device
    seen: dict = {"drops": []}
    real = moe_lib.apply

    def wrapped(p, mcfg, x, *, act="silu"):
        seen["drops"].append(float(moe_lib.dropped_share(p, mcfg, x)))
        if "x" not in seen:
            seen["p"], seen["x"] = p, x[:, :MOE_DENSE_TOKENS].clone()
        return real(p, mcfg, x, act=act)

    moe_lib.apply = wrapped
    try:
        tok, cache = steps.make_prefill_step(model)(
            params, prompt, model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, dev))
    finally:
        moe_lib.apply = real
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    check(len(seen["drops"]) == n_moe, f"{cfg.name}: {len(seen['drops'])} MoE calls, want {n_moe}")
    check(all(0.0 <= d < 1.0 for d in seen["drops"]), f"{cfg.name}: drop shares {seen['drops']}")
    out = {"card": card.line, "capacity_factor": cfg.moe.capacity_factor,
           "tokens": SERVE_BATCH * SERVE_PROMPT,
           "capacity": moe_lib.capacity(cfg.moe, SERVE_BATCH * SERVE_PROMPT),
           "dropped_share_by_layer": seen["drops"],
           "dropped_share_mean": sum(seen["drops"]) / n_moe}
    p, x = seen["p"], seen["x"]
    no_drop = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)
    with torch.no_grad():
        check(float(moe_lib.dropped_share(p, no_drop, x)) == 0.0, f"{cfg.name}: no drops")
        want, want_aux = moe_lib.apply_dense_reference(p, cfg.moe, x)
        got, got_aux = moe_lib.apply(p, no_drop, x)
        at_cf, _ = moe_lib.apply(p, cfg.moe, x)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), f"{cfg.name}: dispatch finite")
    rel = rel_norm(got, want)
    check(rel < MOE_REL_NORM, f"{cfg.name}: dispatch vs dense oracle, relative norm error {rel}")
    out["dispatch_vs_dense"] = {
        "tokens": x.shape[0] * x.shape[1], "capacity": moe_lib.capacity(no_drop, x.shape[0] *
                                                                        x.shape[1]),
        "rel_norm_err": rel, "max_abs_err": float((got.float() - want.float()).abs().max()),
        "aux": float(got_aux), "aux_dense": float(want_aux),
        "dropped_share_at_cf": float(moe_lib.dropped_share(p, cfg.moe, x)),
        "rel_norm_err_at_cf": rel_norm(at_cf, want)}
    del seen, p, x, want, got, at_cf
    if cfg.attention.kind == "mla":
        out["mla_absorbed_vs_expanded"] = mla_absorbed_vs_expanded(model, params, tok, cache)
    del cache
    torch.cuda.empty_cache()
    print(f"moe checks {cfg.name} ({card.line}): {json.dumps(out)}", flush=True)
    return out


def drive_long_context(card: Card) -> dict:
    """minitron-8b's long-context variant (``for_shape(..., long_500k)``: a
    4096-slot ring) at full width and depth through ``build_model`` and
    ``launch/steps.py``: batch 1, a prompt of 8192 tokens, 4 tokens, the 3
    decode steps both ways (the python loop, then the scanned decode from
    the same prefill's cache; tokens and the final rings equal); launch
    counts set to 0 just before and read just after: one flash launch per
    layer in the prefill, none in either decode."""
    from repro_torch.configs import INPUT_SHAPES, for_shape, get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = for_shape(get_config(DECODER_ARCH), INPUT_SHAPES["long_500k"])
    window = cfg.attention.sliding_window
    check(window == 4096, f"long_500k window {window}")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    prompt = model.make_batch(gen, 1, LONG_PROMPT)
    cache = model.init_cache(1, LONG_PROMPT + LONG_GEN, dev)
    check(cache["main.k"].shape[2] == window, f"a ring of {window} slots")
    decode = steps.make_decode_loop(model, LONG_GEN - 1)
    counters = launch_counters()
    print(f"main path: {DECODER_ARCH} long_500k variant (window {window}), batch 1, prompt "
          f"{LONG_PROMPT}, gen {LONG_GEN}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in counters.values():
        counter.reset()
    start = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(params, prompt, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - start
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size), f"long-context logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "long-context logits finite")
    tok = torch.argmax(logits[:, -1], dim=-1)
    pos = torch.full((1,), LONG_PROMPT, dtype=torch.int64, device=dev)
    start = time.perf_counter()
    toks, python_cache = decode(params, cache, tok, pos)  # leaves the prefill's cache
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - start
    scan = steps.make_decode_scan(model, LONG_GEN - 1)
    start = time.perf_counter()
    scan_toks, cache = scan(params, cache, tok, pos)  # consumes it, written in place
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - start
    launches = _serving_launches(counters, {"flash_attention": cfg.num_layers}, "long context")
    check(torch.equal(toks, scan_toks), f"long-context decode tokens differ: {toks.tolist()} "
                                        f"vs {scan_toks.tolist()}")
    for leaf in cache:
        check(torch.equal(python_cache[leaf], cache[leaf]),
              f"long-context final cache {leaf} differs between the decodes")
    del python_cache
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "long-context tokens in the vocab")
    last = LONG_PROMPT + LONG_GEN - 2  # the last position written
    held = torch.sort(cache["main.pos_ids"][:, 0].long(), dim=-1).values
    check(bool((held == torch.arange(last - window + 1, last + 1, device=dev)).all()),
          "every layer's ring holds the last 4096 positions")
    run = {"prefill_s": prefill_s, "decode_s_per_token": decode_s / (LONG_GEN - 1),
           "scan_decode_s_per_token": scan_s / (LONG_GEN - 1), "capture_s": scan.capture_seconds,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params_gb": sum(t.numel() * t.element_size() for t in params.values()) / 1e9,
           "launches": launches["flash_attention"], "tokens": [int(tok[0])] + toks[0].tolist()}
    print(f"long context {DECODER_ARCH} ({card.line}): {json.dumps(run)}", flush=True)
    del params, cache, logits
    torch.cuda.empty_cache()
    return {**run, "launches": {"flash_attention": run["launches"]}}


def kernel_category(name: str) -> str:
    """The group a device kernel's time is reported under."""
    if "flash_" in name:
        return "flash_attention"
    if "wkv6" in name:
        return "wkv6"
    if "ssd_kernel" in name:
        return "ssd"
    if any(tag in name for tag in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    if "copy" in name:
        return "copies and casts"
    return "other elementwise and reductions"


def profile_once(fn, category=kernel_category, n_top: int = 8, *, cpu: bool = True) -> dict:
    """One call of ``fn`` under torch.profiler: wall seconds, device busy
    seconds and share, launches and device milliseconds by kernel category
    (``category`` of the kernel's name), and the ``n_top`` kernels that took
    the most device time.  ``cpu=False`` records the device's kernels alone,
    which is faster to read but, for a burst of tens of thousands of eager
    launches, drops some records (a graph's replay is one launch)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    by_category: dict[str, list] = {}
    for e in kernels:
        entry = by_category.setdefault(category(e.key), [0, 0.0])
        entry[0] += e.count
        entry[1] += e.self_device_time_total / 1e3
    return {"wall_s": wall_s, "device_busy_s": device_s,
            "device_busy_share": device_s / wall_s if device_s > 0 else None,
            "kernels": sum(e.count for e in kernels),
            "by_category_launches_ms": by_category,
            "matmul_kernels": [(e.key[:120], e.count, e.self_device_time_total / 1e3)
                               for e in kernels if category(e.key) == "matmul"],
            "top_kernels_ms": [(e.key[:70], e.count, e.self_device_time_total / 1e3)
                               for e in top[:n_top]]}


def drive_serve_fleet(card: Card) -> dict:
    """``serve_fleet`` of rwkv6-7b at full width and depth, K = 2 peers of
    different seeds stacked (bf16), one request group per peer, launch counts
    set to 0 just before and read just after: wkv6 launches once per layer
    and group."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    layers = get_config(SERVE_ARCH).num_layers
    counters = launch_counters()
    print(f"main path: serve_fleet {SERVE_ARCH} full, {FLEET_PEERS} peers, batch {SERVE_BATCH}, "
          f"prompt {SERVE_PROMPT}, gen {SERVE_GEN}", flush=True)
    torch.cuda.empty_cache()
    for counter in counters.values():
        counter.reset()
    out = serve.serve_fleet(SERVE_ARCH, num_peers=FLEET_PEERS, batch=SERVE_BATCH,
                            prompt_len=SERVE_PROMPT, gen_tokens=SERVE_GEN, use_reduced=False,
                            seed=0, verbose=True, device="cuda")
    launches = _serving_launches(counters, {"wkv6": FLEET_PEERS * layers}, "serve_fleet")
    tokens = out["tokens"]
    check(tuple(tokens.shape) == (FLEET_PEERS, SERVE_BATCH, SERVE_GEN), "fleet tokens shape")
    check(bool(((tokens >= 0) & (tokens < 65536)).all()), "fleet tokens in the vocab")
    check(not torch.equal(tokens[0], tokens[1]), "two peers' models answer differently")
    run = {key: out[key] for key in ("serve_s", "capture_s", "tokens_per_s", "peak_memory_gb",
                                     "params_gb")}
    del out
    run["groups_both_ways"] = fleet_both_ways(tokens)
    print(f"serve_fleet ({card.line}): {json.dumps(run)}", flush=True)
    torch.cuda.empty_cache()
    return {"launches": {"wkv6": launches["wkv6"]}, **run, "_tokens": tokens.cpu()}


def fleet_both_ways(fleet_tokens: torch.Tensor, seed: int = 0) -> dict:
    """The K = 2 fleet's parameters and prompts drawn again as ``serve_fleet``
    draws them (peer p from seed + 1 + p, the prompts from ``seed``); each
    group prefilled once, then decoded with the python loop and with the
    scanned decode (its own capture: the group's parameter views sit
    elsewhere).  Both must give ``serve_fleet``'s tokens; decode s/token and
    capture seconds per group, both ways."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model, common
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    model = build_model(get_config(SERVE_ARCH))
    torch.cuda.empty_cache()
    stacked = tf.stacked_init(
        FLEET_PEERS, lambda p: model.init(torch.Generator(device=dev).manual_seed(seed + 1 + p)))
    prompt_gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = tf.stacked_init(FLEET_PEERS,
                              lambda _p: model.make_batch(prompt_gen, SERVE_BATCH, SERVE_PROMPT))
    caches = serve.stack_request_caches(
        model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, dev), FLEET_PEERS)
    prefill = steps.make_prefill_step(model)
    pos = torch.full((SERVE_BATCH,), SERVE_PROMPT, dtype=torch.int64, device=dev)
    out = {}
    for g in range(FLEET_PEERS):
        params = common.row(stacked, g)
        tok, cache = prefill(params, common.row(prompts, g), common.row(caches, g))
        run = {}
        for impl in ("python", "scan"):
            make = steps.make_decode_loop if impl == "python" else steps.make_decode_scan
            decode = make(model, SERVE_GEN - 1)
            torch.cuda.synchronize()
            start = time.perf_counter()
            toks, _ = decode(params, cache, tok, pos)
            torch.cuda.synchronize()
            run[f"decode_s_per_token_{impl}"] = (time.perf_counter() - start) / (SERVE_GEN - 1)
            check(torch.equal(torch.cat([tok[:, None], toks], dim=1), fleet_tokens[g]),
                  f"fleet group {g}: the {impl} decode's tokens differ from serve_fleet's")
            if impl == "scan":
                run["capture_s"] = decode.capture_seconds
        out[f"group{g}"] = run
    del stacked, caches, cache
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The sharded runtime: one process per peer, K ranks on the one card
# ---------------------------------------------------------------------------

SHARDED_K = 8
SHARDED_STEPS = 10  # sharded_k8's T
SHARDED_ROUNDS = 2  # a grid case's rounds (its schedule's period is 2)
SHARDED_EXPERIMENT_ROUNDS = 10
# a pod run's rows are within TOL of the vmap run's (local phase at width 1:
# another GEMM), so a test image whose top two logits lie that close may flip
SHARDED_ACC_ATOL = 0.01
# smollm-135m at full width, bf16: K = 2 ranks, batch 4 x 1024 tokens, T = 4
SHARDED_LM = dict(arch=LM_ARCH, layers=None, peers=2, batch=4, seq=1024, steps=4)
ROW_RANGE_MODES = ("gossip", "mass", "snapshot", "mass snapshot", "dense", "dense mass")


def row_range_case(card, name, k, n, *, mode="gossip", dtype=torch.float32, graph=None,
                   want_path="gather", timed=False, seed=0) -> dict:
    """``consensus_mix``'s row range in one mode (``ROW_RANGE_MODES``): the
    launches of the middle peer alone, of the first, of the last and of all
    but the first, each against the full launch's rows bit for bit and
    against the plain version's rows (float32 ``TOL``, bf16
    ``CONSENSUS_BF16_TOL``).  ``timed``: the middle peer's launch (a rank's
    launch in the sharded runtime) beside the full launch, its plain version
    and the library's one-row product ``[W_off; Beta][k] X``."""
    from repro_torch.core import graph as graph_lib
    from repro_torch.kernels.consensus_mix import ops, ref

    dev = torch.device("cuda")
    local_steps = 10
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mode.startswith("dense"):
        w, beta, sparse = matching_operands(k, mass="mass" in mode, seed=seed)
        w, beta = w.float(), beta.float()
    else:
        graph = graph or graph_lib.build_graph("ring", k)
        w = graph_lib.mixing_matrix(graph, "data_weighted", data_sizes=np.arange(1, k + 1))
        beta = graph_lib.affinity_matrix(graph, data_sizes=np.arange(1, k + 1))
        sparse = ops.sparse_from_matrices(w, beta, device=dev)
        w, beta = (torch.as_tensor(m, dtype=torch.float32, device=dev) for m in (w, beta))
    d = sparse.nbr_idx.shape[1]
    path = "tile" if ops.takes_tile_path(k) else "gather"
    check(path == want_path, f"row range {name}: {path} design, want {want_path}")
    x = torch.randn(k, n, generator=gen, device=dev).to(dtype)
    pub = (x.float() + 0.05 * torch.randn(k, n, generator=gen, device=dev)).to(dtype)
    mass = 0.5 + torch.rand(k, generator=gen, device=dev)
    snap, push = "snapshot" in mode, "mass" in mode

    def kernel(rows):
        if push and snap:
            return ops.consensus_mix_push_sum_snapshot_stacked(x, pub, mass, sparse, local_steps,
                                                               rows=rows)
        if push:
            return ops.consensus_mix_push_sum_stacked(x, mass, sparse, local_steps, rows=rows)
        if snap:
            return ops.consensus_mix_snapshot_stacked(x, pub, sparse, local_steps, rows=rows)
        return ops.consensus_mix_stacked(x, sparse, local_steps, rows=rows)

    def plain(rows):
        extra = dict(published=pub) if snap else {}
        if push:
            return ref.consensus_mix_push_sum_stacked_ref(x, mass, *sparse, local_steps,
                                                          rows=rows, **extra)
        return ref.consensus_mix_stacked_ref(x, *sparse, local_steps, rows=rows, **extra)

    full = kernel(None)
    tol = TOL if dtype == torch.float32 else CONSENSUS_BF16_TOL
    err, mid = 0.0, k // 2
    for row0, count in ((mid, 1), (0, 1), (k - 1, 1), (1, k - 1)):
        got, want = kernel((row0, count)), plain((row0, count))
        for g, f, r, what in zip(got, full, want, ("mixed", "d", "new mass")):
            check(bool(torch.equal(g, f[row0:row0 + count])),
                  f"row range {name} ({row0}, {count}) {what}: the full launch's rows")
            torch.testing.assert_close(g.float(), r.float(), **tol,
                                       msg=lambda m: f"row range {name} {what}: {m}")
            err = max(err, float((g.float() - r.float()).abs().max()))
    out = {"case": name, "mode": mode, "dtype": str(dtype).removeprefix("torch."), "K": k,
           "D": d, "N": n, "path": path, "rows_equal_full_launch": True, "max_abs_err": err}
    if not timed:
        return out
    row_out = [t[mid:mid + 1].clone() for t in full[:2]]
    row_mass = mass[:1].clone()
    kern = lambda: ops.launch(x, sparse, local_steps, *row_out,  # noqa: E731
                              *((mass, row_mass) if push else ()),
                              published=pub if snap else None, rows=(mid, 1))
    full_out = [torch.empty_like(x), torch.empty_like(x)]
    full_ms = cuda_ms(lambda: ops.launch(x, sparse, local_steps, *full_out,
                                         *((mass, mass.clone()) if push else ()),
                                         published=pub if snap else None))
    w_off = w - torch.diag(torch.diagonal(w))
    dense_row = torch.stack([w_off[mid], beta[mid]]).to(dtype)
    lib_out = torch.empty((2, n), dtype=dtype, device=dev)
    times = in_turns(lambda: plain((mid, 1)), kern,
                     lambda: torch.matmul(dense_row, pub if snap else x, out=lib_out))
    # one row's work: its real slots' rows and its own row read, two rows written
    real = int((sparse.nbr_idx[mid] != mid).sum())
    work = kernel_work("consensus_mix", k=k, n=n, d=d, real=real,
                       elem_bytes=x.element_size(), rows=1)
    return out | {**times, "full_launch_ms": full_ms, "row": mid, **card.work_bound(work)}


def row_range_cases(card: Card) -> list[dict]:
    """The row range in every mode it gained (gossip, mass, snapshot and
    both, dense operands and their mass mode; float32 and bf16; the gather
    design at K = 8 and the column tile at K = 100), timed at the sharded
    runtime's shapes: ``sharded_k8``'s K = 8 ring at the 2NN's row (its main
    path), K = 100 complete (the tile) and smollm-135m's bf16 row at K = 2
    (the LM's sharded round)."""
    from repro_torch.configs import get_config
    from repro_torch.core import graph as graph_lib
    from repro_torch.core.p2p import layout_of, row_align
    from repro_torch.models import transformer as tf

    row = layout_of("mnist_mlp").row
    lm_size = sum(math.prod(s) for s in tf.decoder_param_shapes(get_config(LM_ARCH)).values())
    align = row_align(torch.bfloat16)
    out = [
        row_range_case(card, "sharded_k8", SHARDED_K, row, timed=True),
        row_range_case(card, "k100_complete_tile", 100, row,
                       graph=graph_lib.build_graph("complete", 100), want_path="tile",
                       timed=True, seed=1),
        row_range_case(card, "smollm_k2_bf16", 2, -(-lm_size // align) * align,
                       dtype=torch.bfloat16, graph=graph_lib.build_graph("complete", 2),
                       timed=True, seed=2),
    ]
    seed = 3
    for mode in ROW_RANGE_MODES:
        for dtype in (torch.float32, torch.bfloat16):
            for k, path in ((SHARDED_K, "gather"), (100, "tile")):
                graph = None if k == SHARDED_K else graph_lib.build_graph("erdos_renyi", k,
                                                                           p=0.3, seed=seed)
                out.append(row_range_case(
                    card, f"{mode.replace(' ', '_')}_k{k}_{str(dtype)[6:]}", k, 50000,
                    mode=mode, dtype=dtype, graph=graph, want_path=path, seed=seed))
                seed += 1
    out.append(row_range_case(card, "gossip_k100_scalar_path", 100, 5003, graph=graph_lib
                              .build_graph("complete", 100), want_path="tile", seed=seed))
    return out


def _print_row_range_case(c: dict) -> None:
    timed = (f" row={c['ms']:.4f} ms full launch={c['full_launch_ms']:.4f} ms "
             f"plain={c['plain_ms']:.4f} ms library={c['library_ms']:.4f} ms "
             f"bound={c['bound_ms']:.4f} ms ({c['bound_by']}; {c['bound_card']})"
             if "ms" in c else "")
    print(f"consensus_mix row range {c['case']}: mode={c['mode']} {c['dtype']} K={c['K']} "
          f"D={c['D']} N={c['N']} path={c['path']} rows equal the full launch's: "
          f"{c['rows_equal_full_launch']} max_abs_err={c['max_abs_err']:.3g}{timed}", flush=True)


def sharded_cases(sizes: tuple):
    """``sharded_k8``'s configurations on the reference's grid
    (tests/test_mesh_runtime.py:56): gossip and push-sum on the eight
    schedule entries, a qint8 wire each, bounded staleness (bound 2) each,
    ``SHARDED_ROUNDS`` rounds a case; the scan driver's case; and the cases
    also run at local width 1."""
    from repro_torch.configs.p2pl_mnist import sharded_k8
    from repro_torch.launch import pod

    grid = [("static", {}), ("link_dropout", {}), ("round_robin", {}),
            ("one_way_matching", {}), ("random_matching", {}), ("peer_churn", {}),
            ("adaptive", {"partner_rule": "loss_proximity"}),
            ("adaptive", {"partner_rule": "eps_greedy"})]

    def case(name, protocol, schedule, **fields):
        extra = {k: fields.pop(k) for k in ("partner_rule",) if k in fields}
        cfg = sharded_k8(schedule=schedule, protocol=protocol, local_steps=SHARDED_STEPS,
                         schedule_rounds=2, **extra).p2p
        return pod.RoundCase(name, dataclasses.replace(cfg, **fields), SHARDED_ROUNDS, sizes)

    cases = [case(f"{proto}_{sched}{'_' + ex['partner_rule'] if ex else ''}", proto, sched, **ex)
             for proto in ("gossip", "push_sum") for sched, ex in grid]
    cases += [case("gossip_qint8", "gossip", "static", compressor="qint8"),
              case("push_sum_qint8", "push_sum", "one_way_matching", compressor="qint8"),
              case("gossip_staleness_b2", "gossip", "round_robin", staleness_bound=2,
                   steps_profile="straggler"),
              case("push_sum_staleness_b2", "push_sum", "round_robin", staleness_bound=2,
                   steps_profile="straggler")]
    scan = [case("scan_gossip_static", "gossip", "static")]
    width = [case("width1_gossip_link_dropout", "gossip", "link_dropout"),
             case("width1_push_sum_static", "push_sum", "static")]
    return cases, scan, width


def drive_sharded_k8(card: Card, data) -> dict:
    """``sharded_k8`` on the sharded runtime: 8 ranks on the one card, one
    spawn through the ``cuda_ipc`` group (``launch.pod.grid_rank``), the
    grid of ``sharded_cases`` at local width K (each rank's local phase on K
    copies of its row: cuBLAS then picks the vmap round's GEMMs) held to the
    vmap runtime's rounds run here first: every uncompressed case's rows
    after both phases and its losses equal bit for bit (state digests), the
    qint8 cases allclose with every rank's estimate stack the same, the scan
    driver's chunk the python loop's bits; the width cases again at local
    width 1, the runtime's default, within ``TOL`` of the vmap rows.
    Prints each case's time a round against the vmap round's, the exchange
    time a consensus step, each rank's peak memory and launches."""
    from repro_torch.configs.p2pl_mnist import sharded_k8
    from repro_torch.core import p2p, peer_group, task as task_lib
    from repro_torch.data import partition
    from repro_torch.launch import pod, train

    start = time.perf_counter()
    exp = sharded_k8()
    sizes = tuple(int(v) for v in partition.data_sizes(train.mnist_parts(exp, *data[:2])))
    cases, scan, width = sharded_cases(sizes)
    task = task_lib.get_task("mnist_mlp")
    want, vmap_s = {}, {}
    for case in [*cases, *scan, *width]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounds = pod.vmap_rounds(case, "cuda")
        torch.cuda.synchronize()
        vmap_s[case.name] = (time.perf_counter() - t0) / case.rounds
        want[case.name] = {
            "digests": [[(pod.state_digest(p2p.shard_state(local, r)),
                          pod.state_digest(p2p.shard_state(cons, r)), losses.cpu())
                         for r in range(SHARDED_K)] for local, cons, losses in rounds],
            "params": rounds[-1][1].params.cpu(),
            "losses": torch.stack([losses for _, _, losses in rounds]).cpu()}
        del rounds
    torch.cuda.empty_cache()
    spawn_start = time.perf_counter()
    ranks = peer_group.spawn_peers(pod.grid_rank, SHARDED_K, "cuda",
                                   args=(cases, scan, width, SHARDED_K),
                                   inbox_bytes=p2p.inbox_bytes(task, cases[0].cfg), deadline=300)
    spawn_s = time.perf_counter() - spawn_start
    report, launches = {}, {"consensus_mix": 0, "dequant_mix": 0}
    for case in [*cases, *width]:
        stats = [r["stats"][case.name] for r in ranks]
        for key in launches:
            launches[key] += sum(s["launches"][key] for s in stats)
        kernel = "dequant_mix" if case.cfg.compressor != "none" else "consensus_mix"
        blocks = case.rounds * case.cfg.consensus_steps
        check(all(s["launches"][kernel] == blocks for s in stats),
              f"sharded {case.name}: {kernel} launched {[s['launches'] for s in stats]}, want "
              f"{blocks} a rank")
        if case.cfg.compressor == "none":
            for r, per_rank in enumerate(want[case.name]["digests"]):
                for k, (local, cons, losses) in enumerate(per_rank):
                    got = ranks[k][case.name][r]
                    check(got.local == local and got.consensus == cons,
                          f"sharded {case.name} round {r} rank {k}: rows equal the vmap "
                          "runtime's bit for bit")
                    check(bool(torch.equal(got.losses, losses)),
                          f"sharded {case.name} round {r} rank {k}: losses equal")
            equal = True
        else:
            got = torch.cat([ranks[k][case.name][-1].params for k in range(SHARDED_K)])
            torch.testing.assert_close(got, want[case.name]["params"], **TOL,
                                       msg=lambda m: f"sharded {case.name}: {m}")
            equal = bool(torch.equal(got, want[case.name]["params"]))
        exchange = sum(s["exchange_seconds"] for s in stats) / max(
            sum(s["exchanges"] for s in stats), 1)
        # the rank's host seconds in exchanges and all-gathers, of its round's
        comm = sum(s["exchange_seconds"] + s["gather_seconds"] for s in stats) / sum(
            s["seconds_per_round"] * case.rounds for s in stats)
        report[case.name] = {
            "equal_bits": equal, "pod_s_per_round": stats[0]["seconds_per_round"],
            "vmap_s_per_round": vmap_s[case.name], "exchange_ms_per_call": exchange * 1e3,
            "exchanges_per_round_a_rank": stats[0]["exchanges"] / case.rounds,
            "gathers_per_round_a_rank": stats[0]["gathers"] / case.rounds,
            "communication_share": comm, "launches_a_rank": stats[0]["launches"]}
        print(f"sharded_k8 {case.name} ({card.line}): rows {'equal' if equal else 'allclose'} "
              f"to the vmap runtime's; {stats[0]['seconds_per_round'] * 1e3:.2f} ms a round "
              f"on 8 ranks against {vmap_s[case.name] * 1e3:.2f} ms vmap; exchange "
              f"{exchange * 1e3:.3f} ms a call; exchanges and gathers {comm:.1%} of the "
              "round", flush=True)
    for case in scan:
        for k in range(SHARDED_K):
            got = ranks[k]["scan"][case.name]
            local, cons, _ = want[case.name]["digests"][-1][k]
            check(got.local == local and got.consensus == cons
                  and bool(torch.equal(got.losses, want[case.name]["losses"])),
                  f"sharded {case.name} rank {k}: the pod scan driver's bits")
    widths = {}
    for case in width:
        got = torch.cat([ranks[k]["width"][case.name][-1].params for k in range(SHARDED_K)])
        ref_params = want[case.name]["params"]
        torch.testing.assert_close(got, ref_params, **TOL,
                                   msg=lambda m, name=case.name: f"sharded {name} width 1: {m}")
        widths[case.name] = {"equal_bits": bool(torch.equal(got, ref_params)),
                             "max_abs_diff": float((got - ref_params).abs().max()),
                             "s_per_round": ranks[0]["stats"][f"width {case.name}"]
                             ["seconds_per_round"]}
        print(f"sharded_k8 {case.name} at local width 1 ({card.line}): rows equal the vmap "
              f"runtime's: {widths[case.name]['equal_bits']}, max |diff| "
              f"{widths[case.name]['max_abs_diff']:.3e} after {case.rounds} rounds; "
              f"{widths[case.name]['s_per_round'] * 1e3:.2f} ms a round", flush=True)
    peaks = [r["stats"]["peak_bytes"] / 1e9 for r in ranks]
    seconds = time.perf_counter() - start
    print(f"sharded_k8 ({card.line}): {len(cases)} cases, 8 ranks, spawn and grid "
          f"{spawn_s:.1f} s, phase {seconds:.1f} s; peak memory a rank (GB) "
          f"{[round(p, 3) for p in peaks]}; launches {launches}", flush=True)
    return {"launches": launches, "mode": "row_range", "cases": report, "local_width_1": widths,
            "peak_gb_by_rank": peaks, "spawn_s": spawn_s, "seconds": seconds}


def drive_sharded_experiment(card: Card, data) -> dict:
    """``run_paper_experiment(sharded_k8(), peer_axis="pod")``, 10 rounds on
    8 ranks, each rank's local phase on its own row (the runtime's default
    width), against the vmap run of the same seed: the final state's params
    within ``TOL``, the losses and the drift within its rtol, every accuracy
    within ``SHARDED_ACC_ATOL``; how many accuracies came out equal is
    reported.  (The consensus phase's bits are ``drive_sharded_k8``'s
    check.)"""
    from repro_torch.configs.p2pl_mnist import sharded_k8
    from repro_torch.launch import train

    exp = sharded_k8()
    start = time.perf_counter()
    log_v, state_v = train.run_paper_experiment(exp, rounds=SHARDED_EXPERIMENT_ROUNDS, data=data,
                                                device="cuda", return_state=True)
    vmap_s = time.perf_counter() - start
    start = time.perf_counter()
    log_p, state_p = train.run_paper_experiment(exp, rounds=SHARDED_EXPERIMENT_ROUNDS, data=data,
                                                device="cuda", peer_axis="pod", verbose=True,
                                                return_state=True)
    pod_s = time.perf_counter() - start
    params_diff = float((state_p.params.to(state_v.params.device) - state_v.params).abs().max())
    torch.testing.assert_close(state_p.params.to(state_v.params.device), state_v.params, **TOL,
                               msg=lambda m: f"sharded_k8 run_paper_experiment params: {m}")
    accs, acc_diff = [], 0.0
    for attr in ("after_local", "after_consensus"):
        want, got = getattr(log_v, attr), getattr(log_p, attr)
        check(want.keys() == got.keys(), f"sharded_k8 run_paper_experiment: {attr} groups")
        for g in want:
            w, p = np.stack(want[g]), np.stack(got[g])
            accs.append(np.array_equal(w, p))
            acc_diff = max(acc_diff, float(np.abs(w - p).max()))
    check(acc_diff <= SHARDED_ACC_ATOL,
          f"sharded_k8 run_paper_experiment: accuracies within {SHARDED_ACC_ATOL} of the vmap "
          f"run's (max |diff| {acc_diff})")
    for what in ("train_loss", "drift"):
        check(np.allclose(getattr(log_p, what), getattr(log_v, what), rtol=TOL["rtol"], atol=0),
              f"sharded_k8 run_paper_experiment: {what} within rtol {TOL['rtol']} of the vmap "
              "run's")
    launches = {key: sum(r["launches"][key] for r in log_p.ranks)
                for key in ("consensus_mix", "dequant_mix")}
    want_launches = SHARDED_EXPERIMENT_ROUNDS * exp.p2p.consensus_steps * exp.p2p.num_peers
    check(launches == {"consensus_mix": want_launches, "dequant_mix": 0},
          f"sharded_k8 run_paper_experiment launched {launches}")
    exchange = [r["exchange"] for r in log_p.ranks]
    per_call = sum(e["exchange_seconds"] for e in exchange) / sum(e["exchanges"] for e in exchange)
    peaks = [r["peak_bytes"] / GB for r in log_p.ranks]  # a width-1 rank's whole run
    print(f"sharded_k8 run_paper_experiment ({card.line}): {SHARDED_EXPERIMENT_ROUNDS} rounds, "
          f"{sum(accs)} of {len(accs)} accuracy groups equal the vmap run's (max |diff| "
          f"{acc_diff:.3g}), params max |diff| {params_diff:.3g}; "
          f"{np.mean(log_p.seconds) * 1e3:.2f} ms a round on 8 ranks against "
          f"{np.mean(log_v.seconds) * 1e3:.2f} ms vmap; exchange {per_call * 1e3:.3f} ms a "
          f"call; peak memory a rank at local width 1 (GB) {[round(v, 3) for v in peaks]}; "
          f"whole runs {pod_s:.1f} s pod, {vmap_s:.1f} s vmap", flush=True)
    return {"launches": launches, "mode": "row_range", "peak_gb_by_rank": peaks,
            "pod_s_per_round": log_p.seconds,
            "vmap_s_per_round": log_v.seconds, "exchange_ms_per_call": per_call * 1e3,
            "accuracy_groups_equal": [sum(accs), len(accs)], "accuracy_max_abs_diff": acc_diff,
            "params_max_abs_diff": params_diff, "seconds": pod_s}


def drive_sharded_lm(card: Card) -> dict:
    """smollm-135m at full width, bf16, on the sharded runtime: K = 2 ranks
    on the one card, one round of ``run_p2p_lm``'s configuration (batch 4 x
    1024 tokens, T = 4).  The vmap round runs first, here, and is freed
    before the spawn but for its rows after each phase (a shareable copy,
    ``peer_group.shared_copy``); each rank's round (its local phase on its
    own row, ``local_width=1``) is held to them within the bf16 tolerance,
    and the sharded consensus from the vmap round's post-local rows must
    give its rows bit for bit."""
    from repro_torch.core import p2p, peer_group
    from repro_torch.launch import pod, train

    run = SHARDED_LM
    start = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, task, pcfg, _ = lm_setup(run["arch"], run["layers"], run["peers"], run["steps"])
    state = p2p.init_state(task, pcfg, seed=0, device="cuda")
    tokens, labels = train.lm_token_batches(np.random.default_rng(0), cfg.vocab_size,
                                            num_peers=run["peers"], local_steps=run["steps"],
                                            batch=run["batch"], seq=run["seq"])
    batches = tuple(torch.as_tensor(a, dtype=torch.int64, device="cuda") for a in (tokens, labels))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    after_local, after_cons, _ = p2p.make_round_fn(task, pcfg, device="cuda")(state, batches)
    torch.cuda.synchronize()
    vmap_s = time.perf_counter() - t0
    rows = peer_group.shared_copy(torch.stack([after_local.params, after_cons.params,
                                               after_cons.d_bias]))
    del state, after_local, after_cons, batches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = peer_group.spawn_peers(
        pod.lm_round_rank, run["peers"], "cuda",
        args=(run["arch"], run["layers"], run["batch"], run["seq"], run["steps"], rows),
        inbox_bytes=p2p.inbox_bytes(task, pcfg), deadline=300)
    spawn_s = time.perf_counter() - t0
    del rows
    torch.cuda.empty_cache()
    for k, r in enumerate(ranks):
        check(r["consensus_from_vmap_equal"],
              f"sharded {run['arch']} rank {k}: the consensus from the vmap round's post-local "
              "rows equals its rows bit for bit")
        for what in ("local", "consensus", "d"):
            check(r[f"{what}_allclose"],
                  f"sharded {run['arch']} rank {k}: {what} rows within the bf16 tolerance "
                  f"(max |diff| {r[f'{what}_max_abs_diff']})")
        check(r["launches"] == pcfg.consensus_steps * len(p2p.ParamLayout.of(task).blocks),
              f"sharded {run['arch']} rank {k}: consensus_mix launched {r['launches']}")
    seconds = time.perf_counter() - start
    summary = {key: [r[key] for r in ranks] for key in (
        "local_equal", "consensus_equal", "consensus_from_vmap_equal", "local_max_abs_diff",
        "consensus_max_abs_diff", "d_max_abs_diff", "seconds")}
    summary["exchange_ms_per_call"] = [1e3 * r["stats"]["exchange_seconds"]
                                       / max(r["stats"]["exchanges"], 1) for r in ranks]
    peaks = [r["peak_bytes"] / 1e9 for r in ranks]
    print(f"sharded {run['arch']} ({card.line}): K = {run['peers']} ranks, one round: "
          f"{json.dumps(summary)}; vmap round {vmap_s:.2f} s; peak memory a rank (GB) "
          f"{[round(p, 3) for p in peaks]}; spawn and round {spawn_s:.1f} s, phase "
          f"{seconds:.1f} s", flush=True)
    return {"launches": {"consensus_mix": sum(r["launches"] for r in ranks)},
            "mode": "row_range", **summary, "vmap_round_s": vmap_s, "peak_gb_by_rank": peaks,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# The hierarchical runtime over several slices: a block of p peers a rank
# ---------------------------------------------------------------------------

HIER_BRIDGE_K = 64  # the bridge mode's largest K ("auto" picks it up to here)
HIER_BRIDGE_ROUNDS = 2
HIER_POD_PPD = 25  # iid_k100 over 4 ranks: K = 100 > 64, so "auto" is segment
HIER_POD_ROUNDS = 5
GB = 1e9


def free_shared() -> None:
    """Free what this process shared with ranks that have exited: CUDA IPC
    keeps a shared block until the producer collects it."""
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def hier_bridge_cases() -> list:
    """The bridge mode's cases: the 2NN at full width on ``iid_k100``'s ring
    at K = 64 over ``HIER_RANKS`` ranks (p = 8), gossip and push-sum."""
    from repro_torch.configs.p2pl_mnist import iid_k100
    from repro_torch.launch import pod

    cfg = dataclasses.replace(iid_k100(topology="ring").p2p, num_peers=HIER_BRIDGE_K)
    sizes = tuple(int(v) for v in np.arange(HIER_BRIDGE_K) % 7 + 10)
    p = HIER_BRIDGE_K // HIER_RANKS
    return [pod.RoundCase(f"bridge_k{HIER_BRIDGE_K}_{proto}",
                          dataclasses.replace(cfg, protocol=proto), HIER_BRIDGE_ROUNDS, sizes,
                          peers_per_device=p, mix_mode="bridge")
            for proto in ("gossip", "push_sum")]


def drive_hier_bridge_and_consensus(card: Card, kept: dict) -> dict:
    """One spawn of ``HIER_RANKS`` ranks (``launch.pod.hier_rank``) for two
    checks of the hierarchical runtime over several slices.

    Bridge (``hier_bridge_cases``): each rank's consensus from its block of
    the vmap run's post-local state equals the vmap run's consensus bit for
    bit; at the vmap runtime's local width (K rows) every rank's rows after
    both phases and its losses equal the vmap run's (digests); at the
    default width (its own p rows) its last params' distance from the vmap
    run's is reported (relative norm under 1e-2).

    Segment at K = ``LARGE_K`` (p = 512): each rank's consensus phase alone
    from ``drive_large_k``'s last post-local params (``kept``) equals that
    round's one-device ``segment_mix`` result on its rows, for gossip and
    (from the same params, its initial mass) push-sum; each rank's peak
    memory and what its consensus phase added."""
    from repro_torch.configs.p2pl_mnist import iid_k100
    from repro_torch.core import p2p, peer_group, protocols as protocols_lib
    from repro_torch.core import task as task_lib
    from repro_torch.kernels.consensus_mix import segment
    from repro_torch.launch import pod

    start = time.perf_counter()
    task = task_lib.get_task("mnist_mlp")
    cases = hier_bridge_cases()
    want = {}
    for case in cases:
        rounds = pod.vmap_rounds(case, "cuda")
        p = case.peers_per_device
        want[case.name] = {
            "digests": [[(pod.state_digest(p2p.shard_state(local, r, p)),
                          pod.state_digest(p2p.shard_state(cons, r, p)), losses.cpu())
                         for r in range(HIER_RANKS)] for local, cons, losses in rounds],
            "params": rounds[-1][1].params.cpu()}
        del rounds
    # the one-device runtime's K = 4096 round: gossip is drive_large_k's, push-sum
    # mixes the same post-local params from its initial mass
    ring = iid_k100(topology="ring")
    large = dataclasses.replace(ring.p2p, num_peers=LARGE_K)
    push = dataclasses.replace(large, protocol="push_sum")
    sizes = kept["sizes"]
    ops_push = p2p.schedule_operands(push, sizes, device="cuda")
    mass = protocols_lib.get_protocol("push_sum").init_state(kept["post_local"], sizes).mass
    want_push = segment.segment_mix_push_sum_schedule(kept["post_local"], mass, kept["round"],
                                                      ops_push, push.local_steps)
    checks = [
        {"cfg": large, "data_sizes": sizes, "params": kept["post_local"],
         "round": kept["round"], "want_params": kept["params"], "want_d": kept["d"]},
        # without the affinity bias the state's d is not the kernel's: it keeps its own (0)
        {"cfg": push, "data_sizes": sizes, "params": kept["post_local"], "round": kept["round"],
         "mass": peer_group.shared_copy(mass), "want_params": peer_group.shared_copy(want_push[0]),
         "want_d": peer_group.shared_copy(want_push[1]) if push.use_affinity_d else kept["d"],
         "want_mass": peer_group.shared_copy(want_push[2])}]
    del want_push, ops_push
    torch.cuda.empty_cache()
    p_large = LARGE_K // HIER_RANKS
    inbox = max(p2p.inbox_bytes(task, cases[0].cfg, peers_per_device=cases[0].peers_per_device,
                                mix_mode="bridge"),
                p2p.inbox_bytes(task, large, peers_per_device=p_large, mix_mode="segment"))
    ring_bytes = p2p.ring_bytes(task, large, peers_per_device=p_large, mix_mode="segment")
    spawn_start = time.perf_counter()
    ranks = peer_group.spawn_peers(pod.hier_rank, HIER_RANKS, "cuda",
                                   args=(cases, True, cases, (), checks, None, ()),
                                   inbox_bytes=inbox, ring_bytes=ring_bytes, deadline=400)
    spawn_s = time.perf_counter() - spawn_start
    del checks, mass
    for key in ("post_local", "params", "d"):
        del kept[key]
    free_shared()
    bridge, launches = {}, 0
    for case in cases:
        p = case.peers_per_device
        for k in range(HIER_RANKS):
            check(all(ranks[k]["from_vmap"][case.name]),
                  f"hier {case.name} rank {k}: the consensus from the vmap run's post-local "
                  "rows equals the vmap run's consensus bit for bit")
            for r, per_rank in enumerate(want[case.name]["digests"]):
                local, cons, losses = per_rank[k]
                got = ranks[k]["vmap_width"][case.name][r]
                check(got.local == local and got.consensus == cons
                      and bool(torch.equal(got.losses, losses)),
                      f"hier {case.name} round {r} rank {k}: at local width K the rows and "
                      "losses equal the vmap run's bit for bit")
        stats = [r["cases"]["stats"][case.name] for r in ranks]
        blocks = case.rounds * case.cfg.consensus_steps
        for s_ in (stats, [r["vmap_width"]["stats"][case.name] for r in ranks]):
            check(all(x["launches"]["consensus_mix"] == blocks and x["shifts"] == 0 for x in s_),
                  f"hier {case.name}: one consensus_mix row-range launch a step and rank, no "
                  f"ring shift ({[x['launches'] for x in s_]})")
            launches += sum(x["launches"]["consensus_mix"] for x in s_)
        # at the default width (the rank's own p rows) the local phase's GEMMs
        # are others than the vmap round's K-row ones: their last-bit
        # differences grow over the 2 x 60 SGD steps (the bits are held above,
        # at width K and from the vmap run's post-local rows), so this width is
        # reported, and held only to a relative norm of 1e-2 against a gross fault
        got = torch.cat([ranks[k]["cases"][case.name][-1].params for k in range(HIER_RANKS)])
        rel = rel_norm(got, want[case.name]["params"])
        check(bool(torch.isfinite(got).all()) and rel < 1e-2,
              f"hier {case.name} default width: params' relative norm error {rel}")
        bridge[case.name] = {
            "default_width_equal_bits": bool(torch.equal(got, want[case.name]["params"])),
            "default_width_rel_norm_err": rel,
            "default_width_max_abs_diff": float((got - want[case.name]["params"]).abs().max()),
            "s_per_round": stats[0]["seconds_per_round"],
            "gather_ms_per_call": 1e3 * sum(x["gather_seconds"] for x in stats)
            / max(sum(x["gathers"] for x in stats), 1)}
        print(f"hier {case.name} ({card.line}): 8 ranks of {p} peers, bridge; the consensus "
              f"from the vmap post-local rows and the rounds at local width K equal the vmap "
              f"run's bit for bit; at the default width max |diff| "
              f"{bridge[case.name]['default_width_max_abs_diff']:.3e}, relative norm "
              f"{rel:.3e}; "
              f"{bridge[case.name]['s_per_round'] * 1e3:.2f} ms a round, all-gather "
              f"{bridge[case.name]['gather_ms_per_call']:.3f} ms a call", flush=True)
    consensus = []
    seg_launches = 0
    for i, proto in enumerate(("gossip", "push_sum")):
        res = [r["checks"][i] for r in ranks]
        for k, r in enumerate(res):
            diffs = {key: r[key] for key in r if key.endswith("max_abs_diff")}
            equal = r["params_equal"] and r["d_equal"] and r.get("mass_equal", True)
            if not equal:  # held to 1e-5, the reference's segment tolerance
                check(all(v <= 1e-5 for v in diffs.values()),
                      f"hier K={LARGE_K} {proto} rank {k}: {diffs}")
            check(r["launches"] == 1, f"hier K={LARGE_K} {proto} rank {k}: segment_mix slot "
                  f"form launched {r['launches']} times, want 1")
            check(r["consensus_added_peak_bytes"] < LARGE_K * 199212 * 4,
                  f"hier K={LARGE_K} {proto} rank {k}: the consensus phase added "
                  f"{r['consensus_added_peak_bytes'] / GB:.3f} GB, one (K, N) buffer or more")
            seg_launches += r["launches"]
        summary = {"equal_bits": [r["params_equal"] and r["d_equal"] and r.get("mass_equal", True)
                                  for r in res],
                   "params_max_abs_diff": max(r["params_max_abs_diff"] for r in res),
                   "d_max_abs_diff": max(r["d_max_abs_diff"] for r in res),
                   "peak_gb_by_rank": [r["peak_bytes"] / GB for r in res],
                   "consensus_added_gb_by_rank": [r["consensus_added_peak_bytes"] / GB
                                                  for r in res]}
        consensus.append({"protocol": proto, **summary})
        print(f"hier K={LARGE_K} {proto} consensus from the one-device post-local state "
              f"({card.line}): 8 ranks of {p_large} peers, segment (slot form): {json.dumps(summary)}",
              flush=True)
    seconds = time.perf_counter() - start
    print(f"hier bridge and K={LARGE_K} consensus ({card.line}): spawn and work {spawn_s:.1f} s, "
          f"phase {seconds:.1f} s", flush=True)
    return {"bridge": {"launches": {"consensus_mix": launches}, "mode": "row_range",
                       "cases": bridge},
            "consensus": {"launches": {"segment_mix": seg_launches}, "mode": "slots",
                          "checks": consensus, "spawn_s": spawn_s, "seconds": seconds}}


def drive_hier_large_k(card: Card, kept: dict) -> dict:
    """One round of the 2NN at full width at K = ``LARGE_K`` on a ring over
    ``HIER_RANKS`` ranks (p = 512, segment mode: the reference's K = 4096
    round on 8 slices), gossip then push-sum, each from ``drive_large_k``'s
    initial params (``kept``, shared by the launcher: no rank draws the
    fleet) and the first round of batches of a batcher of seed 0 on its
    shards: losses and state finite, one slot-form launch a rank and step,
    each rank's peak memory and what its consensus phase added."""
    from repro_torch.configs.p2pl_mnist import iid_k100
    from repro_torch.core import p2p, peer_group, task as task_lib
    from repro_torch.launch import pod

    start = time.perf_counter()
    ring = iid_k100(topology="ring")
    exp = dataclasses.replace(ring, p2p=dataclasses.replace(ring.p2p, num_peers=LARGE_K))
    cfgs = [exp.p2p, dataclasses.replace(exp.p2p, protocol="push_sum")]
    task = task_lib.get_task("mnist_mlp")
    sizes, init = kept["sizes"], kept.pop("init")
    x_all, y_all, idx = task.make_peer_batches(kept["parts"], exp.batch_size,
                                               seed=0).chunk_batches_on(
        exp.p2p.local_steps, 1, torch.device("cpu"))
    p = LARGE_K // HIER_RANKS
    spawn_start = time.perf_counter()
    ranks = peer_group.spawn_peers(
        pod.hier_rank, HIER_RANKS, "cuda",
        args=((), False, (), (), (), (cfgs, init, (x_all, y_all, idx), sizes), ()),
        inbox_bytes=p2p.inbox_bytes(task, exp.p2p, peers_per_device=p, mix_mode="segment"),
        ring_bytes=p2p.ring_bytes(task, exp.p2p, peers_per_device=p, mix_mode="segment"),
        deadline=400)
    spawn_s = time.perf_counter() - spawn_start
    del init
    free_shared()
    out, launches = {}, 0
    for i, cfg in enumerate(cfgs):
        res = [r["large"][i] for r in ranks]
        for k, r in enumerate(res):
            check(r["finite"] and r["round_idx"] == 1,
                  f"hier K={LARGE_K} {cfg.protocol} rank {k}: finite after one round")
            check(r["launches"]["segment_mix"] == cfg.consensus_steps
                  and r["launches"]["consensus_mix"] == 0,
                  f"hier K={LARGE_K} {cfg.protocol} rank {k}: launched {r['launches']}")
            check(r["consensus_added_peak_bytes"] < LARGE_K * 199212 * 4,
                  f"hier K={LARGE_K} {cfg.protocol} rank {k}: the consensus phase added "
                  f"{r['consensus_added_peak_bytes'] / GB:.3f} GB")
            launches += r["launches"]["segment_mix"]
        check(all(torch.equal(res[0]["losses"], r["losses"]) for r in res),
              f"hier K={LARGE_K} {cfg.protocol}: every rank has the (T,) losses")
        summary = {"loss": float(res[0]["losses"].mean()),
                   "seconds_by_rank": [r["seconds"] for r in res],
                   "peak_gb_by_rank": [r["peak_bytes"] / GB for r in res],
                   "consensus_added_gb_by_rank": [r["consensus_added_peak_bytes"] / GB
                                                  for r in res],
                   "ring_shift_ms_per_call": 1e3 * res[0]["stats"]["shift_seconds"]
                   / max(res[0]["stats"]["shifts"], 1)}
        out[cfg.protocol] = summary
        print(f"hier K={LARGE_K} {cfg.protocol} round ({card.line}): 8 ranks of {p} peers, "
              f"segment: {json.dumps(summary)}", flush=True)
    seconds = time.perf_counter() - start
    print(f"hier K={LARGE_K} rounds ({card.line}): spawn and rounds {spawn_s:.1f} s, phase "
          f"{seconds:.1f} s", flush=True)
    return {"launches": {"segment_mix": launches}, "mode": "slots", "rounds": out,
            "spawn_s": spawn_s, "seconds": seconds}


def drive_hier_experiment(card: Card, data) -> dict:
    """``run_paper_experiment(iid_k100(), peer_axis="pod",
    peers_per_device=25)``, ``HIER_POD_ROUNDS`` rounds on 4 ranks ("auto":
    segment, K = 100 > 64), against the vmap run of the same seed: every
    accuracy within ``SHARDED_ACC_ATOL``, how many are equal, the params
    within the segment tolerance's reach; one slot-form launch a rank and
    round."""
    from repro_torch.configs.p2pl_mnist import iid_k100
    from repro_torch.launch import train

    exp = iid_k100()
    start = time.perf_counter()
    log_v, state_v = train.run_paper_experiment(exp, rounds=HIER_POD_ROUNDS, data=data,
                                                device="cuda", return_state=True)
    vmap_s = time.perf_counter() - start
    start = time.perf_counter()
    log_p, state_p = train.run_paper_experiment(exp, rounds=HIER_POD_ROUNDS, data=data,
                                                device="cuda", peer_axis="pod", verbose=True,
                                                peers_per_device=HIER_POD_PPD, return_state=True)
    pod_s = time.perf_counter() - start
    params_diff = float((state_p.params.to(state_v.params.device) - state_v.params).abs().max())
    accs, acc_diff = [], 0.0
    for attr in ("after_local", "after_consensus"):
        want, got = getattr(log_v, attr), getattr(log_p, attr)
        check(want.keys() == got.keys(), f"hier run_paper_experiment: {attr} groups")
        for g in want:
            w, p = np.stack(want[g]), np.stack(got[g])
            accs.append(np.array_equal(w, p))
            acc_diff = max(acc_diff, float(np.abs(w - p).max()))
    check(acc_diff <= SHARDED_ACC_ATOL,
          f"hier run_paper_experiment: accuracies within {SHARDED_ACC_ATOL} of the vmap run's "
          f"(max |diff| {acc_diff})")
    ranks = exp.p2p.num_peers // HIER_POD_PPD
    launches = {key: sum(r["launches"][key] for r in log_p.ranks)
                for key in ("consensus_mix", "dequant_mix", "segment_mix")}
    want_launches = HIER_POD_ROUNDS * exp.p2p.consensus_steps * ranks
    check(launches == {"consensus_mix": 0, "dequant_mix": 0, "segment_mix": want_launches},
          f"hier run_paper_experiment launched {launches}")
    peaks = [r["peak_bytes"] / GB for r in log_p.ranks]
    print(f"hier run_paper_experiment iid_k100 ({card.line}): {ranks} ranks of {HIER_POD_PPD} "
          f"peers, segment, {HIER_POD_ROUNDS} rounds, {sum(accs)} of {len(accs)} accuracy "
          f"groups equal the vmap run's (max |diff| {acc_diff:.3g}), params max |diff| "
          f"{params_diff:.3g}; {np.mean(log_p.seconds) * 1e3:.2f} ms a round against "
          f"{np.mean(log_v.seconds) * 1e3:.2f} ms vmap; peak memory a rank (GB) "
          f"{[round(v, 3) for v in peaks]}; whole runs {pod_s:.1f} s pod, {vmap_s:.1f} s vmap",
          flush=True)
    return {"launches": {"segment_mix": launches["segment_mix"]}, "mode": "slots",
            "accuracy_groups_equal": [sum(accs), len(accs)], "accuracy_max_abs_diff": acc_diff,
            "params_max_abs_diff": params_diff, "pod_s_per_round": log_p.seconds,
            "vmap_s_per_round": log_v.seconds, "peak_gb_by_rank": peaks, "seconds": pod_s}


def drive_serve_fleet_pod(card: Card, stacked_tokens: torch.Tensor) -> dict:
    """``serve_fleet`` of rwkv6-7b at full size with ``peer_axis="pod"``:
    ``FLEET_PEERS`` ranks on the one card, each drawing its own peer's
    parameters and serving its own request group; the tokens must equal the
    stacked fleet's (``drive_serve_fleet``'s, ``stacked_tokens``), and each
    rank launches ``wkv6`` once a layer in its prefill."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    layers = get_config(SERVE_ARCH).num_layers
    print(f"main path: serve_fleet {SERVE_ARCH} full, {FLEET_PEERS} peers, peer_axis=pod, batch "
          f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, gen {SERVE_GEN}", flush=True)
    torch.cuda.empty_cache()
    start = time.perf_counter()
    out = serve.serve_fleet(SERVE_ARCH, num_peers=FLEET_PEERS, batch=SERVE_BATCH,
                            prompt_len=SERVE_PROMPT, gen_tokens=SERVE_GEN, use_reduced=False,
                            seed=0, verbose=True, device="cuda", peer_axis="pod")
    seconds = time.perf_counter() - start
    check(torch.equal(out["tokens"].cpu(), stacked_tokens.cpu()),
          "the pod fleet's tokens equal the stacked fleet's")
    per_rank = [r["launches"] for r in out["ranks"]]
    check(all(r == {"wkv6": layers, "flash_attention": 0, "ssd": 0} for r in per_rank),
          f"pod fleet launches a rank {per_rank}, want {layers} wkv6")
    run = {"serve_s": out["serve_s"], "tokens_per_s": out["tokens_per_s"],
           "peak_gb_by_rank": [r["peak_memory_gb"] for r in out["ranks"]],
           "params_gb_a_rank": out["params_gb"], "wkv6_launches_by_rank":
           [r["wkv6"] for r in per_rank], "seconds": seconds}
    print(f"serve_fleet pod ({card.line}): tokens equal the stacked fleet's; {json.dumps(run)}",
          flush=True)
    return {"launches": {"wkv6": sum(r["wkv6"] for r in per_rank)}, **run}


# the dry run held against a real step of the same code at shapes that fit
# one card (not INPUT_SHAPES entries): smollm-135m's training (flash_attention
# and its backward), zamba2-2.7b's training (ssd and flash_attention, each
# with its backward) and prefill
DRYRUN_CASES = ((LM_ARCH, ("train_b1_t1024", 1024, 1, "train")),
                (HYBRID_ARCH, ("train_b1_t1024", 1024, 1, "train")),
                (HYBRID_ARCH, ("prefill_b1_t4096", 4096, 1, "prefill")))
# the dry run's peak of live bytes over torch.cuda.max_memory_allocated()
# less what the card held beside the step's state when the step began (the
# cuBLAS workspaces of the warm-up step: no count of the step can know them).
# The dry run counts the state and every storage an op returns, each rounded
# to the allocator's 512-byte blocks; what it cannot see is the scratch a
# CUDA op allocates inside itself, small beside a step's activations
DRYRUN_PEAK_BAND = (0.98, 1.02)
# the one device kernel each wrapper call launches exactly once, by name in
# torch.profiler (a backward launches several kernels, each once a call)
LAUNCH_MARKERS = {"flash_attention": ("flash_wgmma_kernel", "flash_bf16_kernel",
                                      "flash_f32_kernel"),
                  "flash_attention_bwd": ("delta_bf16_kernel", "delta_f32_kernel"),
                  "ssd": ("ssd_kernel",), "ssd_bwd": ("chunk_cums",),
                  "wkv6": ("wkv6_kernel",), "wkv6_bwd": ("wkv6_bwd_du",)}


def marker_launches(prof) -> dict[str, int]:
    """Device launches of each hand kernel in a profile, by ``LAUNCH_MARKERS``."""
    out = dict.fromkeys(LAUNCH_MARKERS, 0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for kernel, marks in LAUNCH_MARKERS.items():
            if any(m in e.key for m in marks):
                out[kernel] += e.count
    return out


def drive_dryrun_check(card: Card) -> dict:
    """``launch.dryrun_lib.run_case`` on fake CUDA tensors, then the same
    step (``make_state`` and ``make_step`` of the same module) on real
    tensors drawn on the card, for each of ``DRYRUN_CASES``: the state's
    bytes equal part by part, the dry run's peak within ``DRYRUN_PEAK_BAND``
    of ``torch.cuda.max_memory_allocated`` after a reset (less what the card
    held beside the state; the raw ratio printed too), each hand kernel's
    calls in the dry run equal to its wrapper's launches and to its device
    launches in ``torch.profiler``, and the roofline's terms beside one real
    step's time (CUDA events)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun_lib
    from repro_torch.models import build_model

    start = time.perf_counter()
    counters = launch_counters()
    total = dict.fromkeys(counters, 0)
    out = {}
    for arch, shape in ((a, ShapeConfig(*s)) for a, s in DRYRUN_CASES):
        label = f"{arch} {shape.name}"
        t0 = time.perf_counter()
        res = dryrun_lib.run_case(arch, shape, card=card)
        check(res.ok, f"dry run {label}:\n{res.error}")
        dry_s = time.perf_counter() - t0
        rep = res.report
        check(rep.extra["fake_device"] == "cuda", f"dry run {label} on fake CUDA tensors")
        check(bool(res.kernel_calls), f"dry run {label}: the fake route of a hand kernel")

        cfg, shape_cfg = dryrun_lib.prepare_case(arch, shape)
        model = build_model(cfg)
        opt = dryrun_lib.make_optimizer("sgdm")
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = model.make_batch(gen, dryrun_lib.per_peer_batch(shape_cfg, 1),
                                 shape_cfg.seq_len)
        state = dryrun_lib.make_state(model, shape_cfg, opt, peers=1, generator=gen,
                                      batch=batch)
        real_bytes = dryrun_lib.state_bytes(state)
        check(real_bytes == res.state_bytes,
              f"{label}: state bytes {real_bytes} real, {res.state_bytes} reckoned")
        step = dryrun_lib.make_step(model, shape_cfg.kind, opt, peers=1, eta_d=1.0)
        warm = step(state)  # lazy initializations (cuBLAS handles, workspaces)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in
                  (warm[-1] if shape_cfg.kind == "train" else warm[0],)),
              f"{label}: the step's loss / tokens are finite")
        del warm
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        for counter in counters.values():
            counter.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            res_out = step(state)
            torch.cuda.synchronize()
        launches = {k: c.count for k, c in counters.items() if c.count}
        stats = torch.cuda.memory_stats()
        peak, requested = stats["allocated_bytes.all.peak"], stats["requested_bytes.all.peak"]
        del res_out
        on_device = {k: n for k, n in marker_launches(prof).items() if n}
        for key, n in launches.items():
            total[key] += n
        resident = before - rep.extra["state_bytes_held"]  # beside the state
        raw_ratio = rep.extra["peak_bytes"] / peak
        ratio = rep.extra["peak_bytes"] / (peak - resident)
        start_ev, end_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start_ev.record()
        step(state)
        end_ev.record()
        torch.cuda.synchronize()
        step_ms = start_ev.elapsed_time(end_ev)
        roof_ms = max(rep.compute_s, rep.memory_s, rep.collective_s) * 1e3
        out[label] = {
            "state_bytes": real_bytes, "peak_bytes_reckoned": rep.extra["peak_bytes"],
            "max_memory_allocated": peak, "peak_requested_bytes": requested,
            "allocated_before": before, "resident_beside_state": resident,
            "peak_ratio_raw": raw_ratio, "peak_ratio": ratio,
            "kernel_calls": res.kernel_calls, "wrapper_launches": launches,
            "profiler_launches": on_device, "compute_ms": rep.compute_s * 1e3,
            "memory_ms": rep.memory_s * 1e3, "dominant": rep.dominant,
            "flops": rep.flops_per_chip, "bytes": rep.hbm_bytes_per_chip,
            "step_ms": step_ms, "step_over_roofline": step_ms / roof_ms,
            "dry_run_s": dry_s}
        print(f"dryrun check {label} ({card.line}): state {sum(real_bytes.values())} B "
              f"equal; peak reckoned {rep.extra['peak_bytes'] / 2**30:.3f} GiB, "
              f"max_memory_allocated {peak / 2**30:.3f} GiB (requested "
              f"{requested / 2**30:.3f}; before the step {before / 2**30:.3f}, of which "
              f"{resident / 2**20:.1f} MiB beside the state), ratio {raw_ratio:.4f}, "
              f"{ratio:.4f} less that; calls {res.kernel_calls}, wrapper launches {launches}, "
              f"profiler launches {on_device}; roofline compute "
              f"{rep.compute_s * 1e3:.3f} ms, memory {rep.memory_s * 1e3:.3f} ms "
              f"({rep.dominant}), real step {step_ms:.3f} ms ({step_ms / roof_ms:.2f}x); "
              f"dry run {dry_s:.1f} s", flush=True)
        check(launches == res.kernel_calls,
              f"{label}: wrapper launches {launches}, dry-run calls {res.kernel_calls}")
        check(on_device == res.kernel_calls,
              f"{label}: profiler launches {on_device}, dry-run calls {res.kernel_calls}")
        check(DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1],
              f"{label}: dry-run peak {rep.extra['peak_bytes']} over the real {peak} less "
              f"{resident} beside the state = {ratio:.4f}, outside {DRYRUN_PEAK_BAND}")
        del state, step, model
        gc.collect()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - start
    print(f"dryrun check: {seconds:.1f} s ({card.line})", flush=True)
    return {"launches": {k: n for k, n in total.items() if n}, "seconds": seconds,
            "cases": out}


def main() -> int:
    # the full-width LM rounds hold about nine parameter-sized buffers; with
    # fixed segments the allocator left 9.5 GiB of them unusable (rwkv6-7b)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 1
    from repro_torch.configs.p2pl_mnist import (directed_k8, iid_k100, noniid_k2, straggler_k8,
                                                timevarying_k8)
    from repro_torch.data import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    card = Card(card_line())
    print(f"card: {card.line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}",
          flush=True)

    def elapsed(what: str) -> None:
        print(f"chip_smoke: {time.perf_counter() - started:.1f} s before {what}", flush=True)

    cases = check_kernels(card)
    data = synthetic.mnist_like()
    paths = {}
    # the dry run (fake tensors, reckoned) against the same steps on the card
    elapsed("the dry-run check")
    paths["dryrun_check"] = drive_dryrun_check(card)
    # the slices' paths, on a card with nothing else held: P2P training
    # of smollm-135m at full width (flash_attention forward and backward,
    # consensus_mix in bf16), of rwkv6-7b (wkv6 and its backward) and of
    # zamba2-2.7b (ssd and its backward, the shared block's flash_attention)
    # at their published widths, then the reference's run_p2p_lm of each
    # (reduced, float32)
    elapsed("the LM rounds")
    paths |= {run.label: drive_p2p_lm(card, run) for run in LM_RUNS}
    for arch in (LM_ARCH, *(run.arch for run in LM_RUNS[1:])):
        label = "run_p2p_lm_reduced" if arch == LM_ARCH else f"run_p2p_lm_reduced_{arch}"
        paths[label] = drive_run_p2p_lm_reduced(card, arch)
    paths[f"p2p_lm_reduced_bf16_{LM_MOE_ARCH}"] = drive_p2p_lm_reduced_bf16(card, LM_MOE_ARCH)
    # this slice: the LM round as one CUDA graph (the scan driver on token
    # batch trees), bf16 and mixed-type LMs in every consensus mode, the
    # encoder-decoder's and the vlm's training on their batch trees
    elapsed("the LM trees and modes")
    paths |= drive_lm_trees_and_modes(card)
    # the reference's public API: the consensus wrappers on the 2NN, then
    # smollm-135m at full width through make_train_step / make_consensus_step
    elapsed("the step API")
    paths["drive_step_api"] = drive_step_api(card)
    elapsed("serving")
    matching = check_matching_on_card()
    paths["serve_batch"] = drive_serve_batch(card, SERVE_ARCH, {"wkv6": 32})
    serving = {SERVE_ARCH: recheck_and_break_down(card, SERVE_ARCH, {"wkv6": (0, 31)},
                                                  {"wkv6": 32})}
    paths["serve_fleet_k2"] = drive_serve_fleet(card)
    # the pod layout of the same fleet: a process a peer, the stacked fleet's tokens
    paths["serve_fleet_pod_k2"] = drive_serve_fleet_pod(card, paths["serve_fleet_k2"].pop("_tokens"))
    paths["serve_batch_minitron"] = drive_serve_batch(card, DECODER_ARCH,
                                                      {"flash_attention": 32})
    serving[DECODER_ARCH] = recheck_and_break_down(card, DECODER_ARCH,
                                                   {"flash_attention": (0, 31)},
                                                   {"flash_attention": 32})
    paths["long_context_minitron"] = drive_long_context(card)
    # zamba2: 54 Mamba2 layers through ssd, 9 shared-block applications through
    # flash_attention in every prefill
    paths["serve_batch_zamba2"] = drive_serve_batch(card, HYBRID_ARCH,
                                                    {"ssd": 54, "flash_attention": 9})
    serving[HYBRID_ARCH] = recheck_and_break_down(card, HYBRID_ARCH,
                                                  {"ssd": (0, 53), "flash_attention": (0, 8)},
                                                  {"ssd": 54, "flash_attention": 9})
    # the last two families at full size: internvl2-2b (the image prefix and
    # the text through flash_attention, causal, group 2) and seamless-m4t-medium
    # (12 non-causal encoder and 12 causal decoder launches a prefill)
    for arch, per_prefill, picks in VLM_ENCDEC_SERVED:
        start = time.perf_counter()
        paths[f"serve_batch_{arch}"] = drive_serve_batch(card, arch, per_prefill)
        serving[arch] = recheck_and_break_down(card, arch, picks, per_prefill)
        if arch == "seamless-m4t-medium":  # the encoder's calls non-causal, the decoder's causal
            causal = {call: rec["causal"] for call, rec in
                      serving[arch]["recheck"]["flash_attention"].items()}
            check(causal == {"call0": False, "call11": False, "call12": True, "call23": True},
                  f"seamless flash calls causal {causal}")
        paths[f"serve_batch_{arch}"]["seconds"] = time.perf_counter() - start
        replay_ms = serving[arch]["decode_both_ways"]["replay_s_per_step"] * 1e3
        print(f"decode step {arch} ({card.line}): warm replay {replay_ms:.4f} ms against a "
              f"byte bound of {serving[arch]['decode_step_bound_ms']:.4f} ms "
              f"({serving[arch]['decode_step_bytes'] / 1e9:.3f} GB at "
              f"{card.bytes_per_s / 1e12} TB/s)", flush=True)
        print(f"serve_batch {arch} path: {paths[f'serve_batch_{arch}']['seconds']:.1f} s "
              f"({card.line})", flush=True)
    # the MoE decoders at published widths and cut depth: deepseek-v2 (MLA, no
    # kernel: 0 launches), qwen3-moe (8 flash_attention launches a prefill)
    for arch, layers, per_prefill, picks in MOE_SERVED:
        paths[f"serve_batch_{arch}"] = drive_serve_batch(card, arch, per_prefill, layers=layers)
        serving[arch] = recheck_and_break_down(card, arch, picks, per_prefill, layers=layers,
                                               extra=moe_checks)
    elapsed("the 2NN training paths")
    noniid = noniid_k2(algorithm="p2pl_affinity", local_steps=10)
    iid = iid_k100()
    iid_qint8 = dataclasses.replace(iid, p2p=dataclasses.replace(iid.p2p, compressor="qint8"))
    paths |= {
        "noniid_affinity": drive("noniid_affinity", noniid, NONIID_ROUNDS, data, recheck=True),
        "iid_k100": drive("iid_k100", iid, IID_ROUNDS, data, recheck=False),
        "timevarying_k8_round_robin_qint8": drive(
            "timevarying_k8_round_robin_qint8",
            timevarying_k8(schedule="round_robin", compressor="qint8"), TV_QINT8_ROUNDS, data,
            recheck=True),
        "timevarying_k8_round_robin_topk": drive(
            "timevarying_k8_round_robin_topk",
            timevarying_k8(schedule="round_robin", compressor="topk"), TV_TOPK_ROUNDS, data,
            recheck=True),
        "iid_k100_qint8": drive("iid_k100_qint8", iid_qint8, IID_QINT8_ROUNDS, data,
                                recheck=True),
        "iid_k100_pod_segment": drive("iid_k100_pod_segment", iid, IID_POD_ROUNDS, data,
                                      recheck=True, mix_mode="segment", peer_axis="pod",
                                      peers_per_device=iid.p2p.num_peers),
    }
    # push-sum: directed_k8 (K = 8, the gather design; qint8 through
    # dequant_mix) and iid_k100 with --protocol push_sum (the tile design,
    # then the one-slice segment runtime), each kernel in its mass mode
    directed = directed_k8()
    iid_push = dataclasses.replace(iid, p2p=dataclasses.replace(iid.p2p, protocol="push_sum"))
    paths |= {
        "directed_k8": drive("directed_k8", directed, DIRECTED_ROUNDS, data, recheck=True),
        "directed_k8_one_way_matching": drive(
            "directed_k8_one_way_matching", directed_k8(schedule="one_way_matching"),
            DIRECTED_ROUNDS, data, recheck=False),
        "directed_k8_link_dropout_qint8": drive(
            "directed_k8_link_dropout_qint8",
            dataclasses.replace(directed_k8(schedule="link_dropout"), p2p=dataclasses.replace(
                directed_k8(schedule="link_dropout").p2p, compressor="qint8")),
            DIRECTED_ROUNDS, data, recheck=True),
        "iid_k100_push_sum": drive("iid_k100_push_sum", iid_push, IID_ROUNDS, data,
                                   recheck=False),
        "iid_k100_push_sum_pod_segment": drive(
            "iid_k100_push_sum_pod_segment", iid_push, IID_POD_ROUNDS, data, recheck=True,
            mix_mode="segment", peer_axis="pod", peers_per_device=iid.p2p.num_peers),
    }
    # asynchronous rounds: straggler_k8 (K = 8, the snapshot mode's gather
    # design), and iid_k100 with per-peer step budgets alone (linear: the
    # synchronous consensus) and with a staleness bound (the snapshot mode's
    # tile); their both-driver runs follow
    iid_linear = dataclasses.replace(iid, p2p=dataclasses.replace(iid.p2p,
                                                                  steps_profile="linear"))
    iid_stale = dataclasses.replace(iid, p2p=dataclasses.replace(
        iid.p2p, steps_profile="straggler", staleness_bound=3))
    straggler_push = straggler_k8(schedule="round_robin", protocol="push_sum")
    paths |= {
        "iid_k100_linear": drive("iid_k100_linear", iid_linear, IID_ROUNDS, data,
                                 recheck=False),
        "straggler_k8": drive("straggler_k8", straggler_k8(), STRAGGLER_ROUNDS, data,
                              recheck=True),
        "straggler_k8_round_robin_push_sum": drive(
            "straggler_k8_round_robin_push_sum", straggler_push, STRAGGLER_ROUNDS, data,
            recheck=True),
    }
    for label in ("straggler_k8", "straggler_k8_round_robin_push_sum"):
        paths[label]["mode"] = "snapshot"
    # adaptive partner selection: each round's matching chosen on the card
    # from the previous losses, mixed through the dense operands of
    # consensus_mix (gossip; push-sum's mass mode for directed_k8) and of
    # dequant_mix (qint8); eps_greedy at eps 0.5 explores in round 0 only
    tv_adaptive = timevarying_k8(schedule="adaptive")
    tv_eps_greedy = timevarying_k8(schedule="adaptive", partner_rule="eps_greedy",
                                   adaptive_eps=0.5)
    directed_adaptive = directed_k8(schedule="adaptive")
    paths |= {
        "timevarying_k8_adaptive": drive("timevarying_k8_adaptive", tv_adaptive,
                                         ADAPTIVE_ROUNDS, data, recheck=True),
        "timevarying_k8_adaptive_eps_greedy": drive(
            "timevarying_k8_adaptive_eps_greedy", tv_eps_greedy, ADAPTIVE_ROUNDS, data,
            recheck=True),
        "directed_k8_adaptive": drive("directed_k8_adaptive", directed_adaptive,
                                      ADAPTIVE_ROUNDS, data, recheck=True),
        "timevarying_k8_adaptive_qint8": drive(
            "timevarying_k8_adaptive_qint8",
            timevarying_k8(schedule="adaptive", compressor="qint8"), ADAPTIVE_ROUNDS, data,
            recheck=True),
    }
    for label in ("timevarying_k8_adaptive", "timevarying_k8_adaptive_eps_greedy",
                  "directed_k8_adaptive", "timevarying_k8_adaptive_qint8"):
        paths[label]["mode"] = "dense"
    # RWKV6 on sequential MNIST: 31 leaves, N = 100,236, through consensus_mix
    # (gossip and mass mode) and dequant_mix (qint8)
    elapsed("seqmnist")
    seqmnist = seqmnist_phase(card, data, cases, paths)
    elapsed("both drivers")
    # both round drivers from the same seed and rounds, bit for bit
    pod = dict(peer_axis="pod", peers_per_device=iid.p2p.num_peers, mix_mode="segment")
    for label, exp, rounds, every, kernel, run_kw in (
        ("noniid_affinity", noniid, 10, 5, "consensus_mix", {}),
        ("iid_k100", iid, 10, 5, "consensus_mix", {}),
        ("iid_k100_qint8", iid_qint8, 10, 5, "dequant_mix", {}),
        ("timevarying_k8_round_robin_qint8",
         timevarying_k8(schedule="round_robin", compressor="qint8"), 9, 3, "dequant_mix", {}),
        ("directed_k8", directed, 10, 5, "consensus_mix", {}),
        ("iid_k100_pod_segment", iid, 10, 5, "segment_mix", pod),
        ("straggler_k8", straggler_k8(), 10, 5, "consensus_mix", {}),
        ("straggler_k8_round_robin_push_sum", straggler_push, 10, 5, "consensus_mix", {}),
        ("iid_k100_straggler_b3", iid_stale, 10, 5, "consensus_mix", {}),
        ("timevarying_k8_adaptive", tv_adaptive, 10, 5, "consensus_mix", {}),
        ("timevarying_k8_adaptive_eps_greedy", tv_eps_greedy, 10, 5, "consensus_mix", {}),
        ("directed_k8_adaptive", directed_adaptive, 10, 5, "consensus_mix", {}),
    ):
        result = compare_drivers(card, label, exp, rounds, every, data, kernel=kernel, **run_kw)
        result["mode"] = ("dense" if exp.p2p.schedule == "adaptive" else
                          "snapshot" if exp.p2p.staleness_bound > 0 else
                          "mass" if exp.p2p.protocol == "push_sum" else "gossip")
        paths[f"{label}_both_drivers"] = result
    for label, exp in (("noniid_affinity", noniid), ("iid_k100", iid),
                       ("iid_k100_qint8", iid_qint8), ("directed_k8", directed)):
        print(f"breakdown {label} ({card.line}): {json.dumps(phase_breakdown(exp, data))}",
              flush=True)
    elapsed("the selection profile and K = 4096")
    selection = selection_profile(card, tv_adaptive, data)
    ring = iid_k100(topology="ring")
    large_k = dataclasses.replace(ring, p2p=dataclasses.replace(ring.p2p, num_peers=LARGE_K))
    paths[f"ring_k{LARGE_K}"] = drive_large_k(large_k, LARGE_K_ROUNDS, data)
    # this slice: the hierarchical runtime over 8 slices (ranks on the card),
    # bridge at K = 64 and segment at K = 4096 (the consensus from the last
    # round's one-device post-local state above, then whole rounds), and
    # run_paper_experiment over 4 slices
    elapsed("the hierarchical runtime")
    kept = paths[f"ring_k{LARGE_K}"].pop("_kept")
    hier = drive_hier_bridge_and_consensus(card, kept)
    paths["hier_bridge_k64"] = hier["bridge"]
    paths[f"hier_k{LARGE_K}_consensus"] = hier["consensus"]
    paths[f"hier_k{LARGE_K}_rounds"] = drive_hier_large_k(card, kept)
    del kept
    paths["hier_iid_k100_run_paper_experiment"] = drive_hier_experiment(card, data)
    # this slice's paths, last: the sharded runtime, one process per peer
    # (8 ranks on the card through the cuda_ipc group, each mixing its own
    # row through consensus_mix's row range): sharded_k8's grid against the
    # vmap runtime, its run_paper_experiment, and smollm-135m's round at K = 2
    # ranks (each frees what it held; the LM phase empties the cache first)
    elapsed("the sharded runtime")
    cases["consensus_mix row range"] = row_range_cases(card)
    for c in cases["consensus_mix row range"]:
        _print_row_range_case(c)
    paths |= {"sharded_k8": drive_sharded_k8(card, data),
              "sharded_k8_run_paper_experiment": drive_sharded_experiment(card, data),
              "sharded_lm_smollm": drive_sharded_lm(card)}
    elapsed("the kernels line")

    entries = []
    for kernel, source, replaces, main_case in (
        ("consensus_mix", "consensus_mix/csrc/consensus_mix.cu",
         "consensus_mix/consensus_mix.py:72", "iid_k100"),
        ("dequant_mix", "consensus_mix/csrc/dequant_mix.cu", "consensus_mix/dequant.py:117",
         "iid_k100_qint8"),
        ("segment_mix", "consensus_mix/csrc/segment_mix.cu", "consensus_mix/segment.py:124",
         f"ring_k{LARGE_K}"),
        ("wkv6", "rwkv6/csrc/wkv6.cu", "rwkv6/rwkv6.py:94", "main_b4_t1024_bf16"),
        ("wkv6_bwd", "rwkv6/csrc/wkv6_bwd.cu", "rwkv6/rwkv6.py:94", "trained_k2_b2_t1024_bf16"),
        ("flash_attention", "flash_attention/csrc/flash_attention.cu",
         "flash_attention/flash_attention.py:124", "main_minitron"),
        ("flash_attention_bwd", "flash_attention/csrc/flash_attention_bwd.cu",
         "flash_attention/flash_attention.py:124", "lm_smollm_k4"),
        ("ssd", "mamba2/csrc/ssd.cu", "mamba2/mamba2.py:98", "main_b4_t1024_bf16"),
        ("ssd_bwd", "mamba2/csrc/ssd_bwd.cu", "mamba2/mamba2.py:98", "trained_k2_b1_t1024_bf16"),
    ):
        main = next(c for c in cases[kernel] if c["case"] == main_case)
        by_path = {name: p["launches"][kernel] for name, p in paths.items()
                   if kernel in p["launches"]}
        mass_entry = {}
        if f"{kernel} dense" in cases:
            dense = cases[f"{kernel} dense"]
            dense_main = dense[0]  # timevarying_k8's adaptive round
            dense_paths = {name: n for name, n in by_path.items()
                           if paths[name].get("mode") == "dense"}
            mass_entry["dense_operands"] = {
                "launches": sum(dense_paths.values()), "launches_by_path": dense_paths,
                "max_abs_err": max(c["max_abs_err"] for c in dense),
                **{key: dense_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms", "bound_card")},
                "shape": f"{dense_main['case']}: K={dense_main['K']} D={dense_main['D']} "
                         f"N={dense_main['N']}",
                "shapes": dense,
                **({"matching_on_card": matching, "selection": selection}
                   if kernel == "consensus_mix" else {})}
        if f"{kernel} snapshot" in cases:
            snap = cases[f"{kernel} snapshot"]
            snap_main = snap[0]  # straggler_k8's shape
            snap_paths = {name: n for name, n in by_path.items()
                          if paths[name].get("mode") == "snapshot"}
            mass_entry["snapshot_mode"] = {
                "launches": sum(snap_paths.values()), "launches_by_path": snap_paths,
                "max_abs_err": max(c["max_abs_err"] for c in snap),
                **{key: snap_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "bound_card")},
                "shape": f"{snap_main['case']}: K={snap_main['K']} D={snap_main['D']} "
                         f"N={snap_main['N']}",
                "shapes": snap}
        if f"{kernel} mass" in cases:
            mass_main = cases[f"{kernel} mass"][0]  # the push-sum main path's shape
            mass_paths = {name: n for name, n in by_path.items()
                          if paths[name].get("mode") == "mass"}
            mass_entry["mass_mode"] = {
                "launches": sum(mass_paths.values()), "launches_by_path": mass_paths,
                "max_abs_err": max(c["max_abs_err"] for c in cases[f"{kernel} mass"]),
                **{key: mass_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "bound_card")},
                "shape": f"{mass_main['case']}: K={mass_main['K']} D={mass_main['D']} "
                         f"N={mass_main['N']}",
                "shapes": cases[f"{kernel} mass"]}
        if kernel == "segment_mix":  # K = 100 beside the K = 4096 main shape, both modes
            def at_k100(kcases, what):
                c = next(x for x in kcases if x["case"] == "iid_k100")
                return {**{key: c[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "bound_card", "max_abs_err",
                                                   "route")},
                        "shape": f"{what}: K={c['K']} D={c['D']} N={c['N']}"}

            mass_entry["k100_shape"] = at_k100(cases[kernel], "iid_k100, one-slice segment runtime")
            mass_entry["mass_mode"]["k100_shape"] = at_k100(
                cases[f"{kernel} mass"], "iid_k100 --protocol push_sum, one-slice segment runtime")
        if f"{kernel} slots" in cases:  # the slot form: a rank's block of the segment mode
            slot = cases[f"{kernel} slots"]
            timed = [c for c in slot if "ms" in c]
            slot_paths = {name: n for name, n in by_path.items()
                          if paths[name].get("mode") == "slots"}
            mass_entry["slot_form"] = {
                "launches": sum(slot_paths.values()), "launches_by_path": slot_paths,
                "max_abs_err": max(c["max_abs_err"] for c in slot),
                **{key: timed[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "bound_card", "library")},
                "shape": f"{timed[0]['case']}: K={timed[0]['K']} p={timed[0]['p']} "
                         f"D={timed[0]['D']} N={timed[0]['N']}, a rank's block",
                "mass_mode": {key: timed[1][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")},
                "shapes": slot}
        if f"{kernel} row range" in cases:  # a rank's own row of the launch (sharded runtime)
            rr = cases[f"{kernel} row range"]
            rr_main = rr[0]  # sharded_k8's K = 8 ring at the 2NN's row
            rr_paths = {name: n for name, n in by_path.items()
                        if paths[name].get("mode") == "row_range"}
            mass_entry["row_range"] = {
                "launches": sum(rr_paths.values()), "launches_by_path": rr_paths,
                "max_abs_err": max(c["max_abs_err"] for c in rr),
                **{key: rr_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "bound_card", "full_launch_ms")},
                "shape": f"{rr_main['case']}: K={rr_main['K']} D={rr_main['D']} "
                         f"N={rr_main['N']}, one row of the launch",
                "shapes": rr}
        if f"{kernel} bf16 modes" in cases:  # bf16 storage in every other mode
            modes = cases[f"{kernel} bf16 modes"]
            mode_paths = {name: n for name, n in by_path.items() if paths[name].get("bf16_mode")}
            mass_entry["bf16_storage_modes"] = {
                "launches": sum(mode_paths.values()), "launches_by_path": mode_paths,
                "max_abs_err": max(c["max_abs_err"] for c in modes),
                **{key: modes[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "bound_card")},
                "shape": f"{modes[0]['case']} ({modes[0]['mode']}): K={modes[0]['K']} "
                         f"D={modes[0]['D']} N={modes[0]['N']} bfloat16",
                "shapes": modes}
        if f"{kernel} bf16" in cases:  # the LM round's bf16 parameters (gossip)
            bf16 = cases[f"{kernel} bf16"]
            bf16_main = bf16[0]  # smollm-135m's row at K = 4
            mass_entry["bf16_mode"] = {
                "launches": paths["p2p_lm_smollm_full"]["launches"][kernel],
                "max_abs_err": max(c["max_abs_err"] for c in bf16),
                **{key: bf16_main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "bound_card")},
                "shape": f"{bf16_main['case']}: K={bf16_main['K']} D={bf16_main['D']} "
                         f"N={bf16_main['N']} bfloat16",
                "shapes": bf16}
        if kernel == "wkv6":
            shape = (f"B={main['B']} T={main['T']} H={main['H']} dk={main['dk']} "
                     f"chunk={main['chunk']} {main['dtype']}")
            seq = next(c for c in cases[kernel] if c["case"] == "seqmnist_b256_t196_q49")
            mass_entry["seqmnist_shape"] = {
                **{key: seq[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "bound_card", "max_abs_err")},
                "shape": "B=256 T=196 H=4 dk=16 chunk=49 float32 (rwkv6_features, chunked)",
                "features_max_abs_diff": seqmnist["features_max_abs_diff"]}
        elif kernel == "flash_attention_bwd":
            shape = (f"B={main['B']} S={main['S']} H={main['H']} Kh={main['Kh']} D={main['D']} "
                     f"causal {main['dtype']} (the LM round: K = 4 peers x batch 4)")
            mass_entry["replaces_note"] = (
                "the Pallas kernel has no backward (the reference differentiates its jnp "
                "forms); this is the backward of the flash_attention port")
            mass_entry["lm_grad_check"] = {
                key: v for key, v in paths["p2p_lm_smollm_full"]["grad_check"].items()
                if key != "leaf_rel_norm_err"}
            zamba = next(c for c in cases[kernel] if c["case"] == "zamba2_trained_d80")
            mass_entry["zamba2_shape"] = {
                **{key: zamba[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "bound_card", "max_abs_err",
                                               "route")},
                "shape": "B=2 S=1024 H=Kh=32 D=80 causal bfloat16 (zamba2-2.7b's LM round: K "
                         "= 2 peers x batch 1, the shared block)",
                "launches": paths["p2p_lm_zamba2_2_7b"]["launches"][kernel]}
        elif kernel == "flash_attention":
            shape = (f"B={main['B']} S={main['S']} H={main['H']} Kh={main['Kh']} D={main['D']} "
                     f"causal {main['dtype']}")
            def served(case, shape, launches):
                c = next(x for x in cases[kernel] if x["case"] == case)
                return {**{key: c[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "bound_card", "max_abs_err",
                                                   "rel_norm_err")},
                        "shape": shape, "launches": launches}

            def path_launches(arch):
                return sum(n for name, n in by_path.items() if arch in name)

            mass_entry["lm_round_shape"] = served(
                "lm_smollm_k4", "B=16 S=1024 H=9 Kh=3 D=64 causal bfloat16 (the LM round: "
                "K = 4 peers x batch 4, smollm-135m's heads)", path_launches("p2p_lm_smollm"))
            mass_entry["qwen3moe_shape"] = served(
                "qwen3moe_group16", "B=4 S=1024 H=64 Kh=4 D=128 causal bfloat16 (qwen3-moe's "
                "prefill, group 16)", path_launches("qwen3-moe"))
            mass_entry["internvl2_shape"] = served(
                "internvl2_group2", "B=4 S=1024 H=16 Kh=8 D=128 causal bfloat16 (internvl2's "
                "prefill: 256 patches and 768 tokens, group 2)",
                path_launches("serve_batch_internvl2"))
            mass_entry["encdec_training"] = {
                "launches": paths["p2p_encdec_seamless_full"]["launches"][kernel],
                "launches_by_mask_a_step":
                    paths["p2p_encdec_seamless_full"]["flash_launches_by_mask_a_step"]}
            half = path_launches("serve_batch_seamless") // 2  # 12 encoder, 12 decoder a prefill
            mass_entry["seamless_shapes"] = {
                "encoder": served("seamless_encoder_noncausal", "B=4 S=256 H=Kh=16 D=64 "
                                  "non-causal bfloat16 (seamless-m4t's encoder)", half),
                "decoder": served("seamless_decoder", "B=4 S=768 H=Kh=16 D=64 causal bfloat16 "
                                  "(seamless-m4t's decoder prefill)", half)}
        elif kernel == "ssd":
            shape = (f"B={main['B']} T={main['T']} H={main['H']} G={main['G']} P={main['P']} "
                     f"N={main['N']} chunk={main['chunk']} {main['dtype']}")
        elif kernel in ("wkv6_bwd", "ssd_bwd"):
            run = "p2p_lm_rwkv6_7b" if kernel == "wkv6_bwd" else "p2p_lm_zamba2_2_7b"
            dims = (f"dk={main['dk']}" if kernel == "wkv6_bwd" else
                    f"G={main['G']} P={main['P']} N={main['N']}")
            shape = (f"B={main['B']} T={main['T']} H={main['H']} {dims} {main['dtype']} (the "
                     f"LM round: K = 2 peers folded into the batch)")
            mass_entry["replaces_note"] = (
                "the Pallas kernel has no backward (the reference differentiates its jnp "
                f"forms); this is the backward of the {kernel[:-4]} port")
            mass_entry["lm_grad_check"] = {
                key: v for key, v in paths[run]["grad_check"].items()
                if key != "leaf_rel_norm_err"}
        else:
            shape = f"K={main['K']} D={main['D']} N={main['N']}"
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in cases[kernel]),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "bound_card")},
            "shape": shape,
            # the scans' two bounds; ssd's design (tf32x2 / tf32x3) under its own
            # key: "route" is the contract's, "cuda" for every kernel
            **({key: main[key] for key in ("bound_ms_fma", "bound_by_fma", "bound_ms_tensor",
                                          "bound_by_tensor", "bound_tensor_type")}
               if kernel in ("ssd", "wkv6_bwd", "ssd_bwd") else {}),
            **({"split": main["split"], "kernel_route": main["route"]} if kernel == "ssd"
               else {}),
            "shapes": cases[kernel],
            **mass_entry,
        })
    for entry in entries:
        kernel = entry["name"]
        rechecks = {arch: out["recheck"][kernel] for arch, out in serving.items()
                    if kernel in out["recheck"]}
        if rechecks:
            entry["launches_by_phase"] = {name: p["launches_by_phase"][kernel]
                                          for name, p in paths.items()
                                          if kernel in p.get("launches_by_phase", {})}
            entry["serving_recheck"] = rechecks
    print(f"seqmnist phase: {seqmnist['seconds']:.1f} s of {time.perf_counter() - started:.1f} s "
          f"of the run ({card.line})", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
