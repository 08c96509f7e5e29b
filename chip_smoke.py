"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure raises and exits non-zero):

1. device — a CUDA device is required (no CPU fallback); prints the card's
   name and power limit; full-fp32 matmuls (TF32 off), fp16 GEMMs reduced in fp32.
2. build — compiles every CUDA source of ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) into ``build/``.
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's widths:
   * the wire scatters (4 clients x 64 public samples x vocab 50 257,
     k_cap 128 and 1024, and 8 rows x V 152 064, k_cap 1024, which takes
     more column tiles; k = 0 client rows, wire padding at index 0 beside
     a real index-0 entry, negative values), ``torch.equal``; and the
     sparse path's memory contract, the float and the int8 wire aggregated
     through these kernels and through the plain route at the reference
     test's shapes (10 clients, 64 rows, V 8 192, k_cap 256) and the main
     path's (4, 64, 50 257, 1 024): ``max_intermediate_elems`` (every op's
     output, the kernels' outputs among them) at most rows * V, below the
     (N, rows, V) dense stack;
   * the bisection top-k masks, per-row budget and static k, at 256 rows x
     V 50 257 (the shared-memory path) and 16 rows x V 152 064 (the
     global-memory path): k = 0, 1, V and > V, ties at the threshold, an
     all-negative and a constant row, a row holding a NaN (which keeps
     nothing), a row holding +inf and -inf, a row of spread 1e-3 and a row
     near 3e38 (where lo + hi overflows), ``torch.equal``;
   * the dense adaptive aggregation at (4, 64, 50 257) on a top-k-sparse
     and on a dense random stack, ``torch.equal``;
   * the distillation KL per row at (64, 50 257) (each row split over a
     cluster of C CTAs, the largest C <= 8 with at most one CTA an SM: 2 on
     an H100), (32, 50 257) (C = 4), (8, 152 064) (C = 8),
     (2 * SMs + 56, 50 257) (C = 1) and 8 rows of V 37 and 5 (fewer
     elements than C slices of one tile: some CTAs hold nothing), T
     in (1, 2, 4), with a teacher equal to its student (KL exactly 0),
     logits of +-3e4, rows with -1e30 entries and a student whose rows sit
     on another 16-byte phase than the teacher's: within rtol 1e-5 plus
     2e-6 (1 + |lse_t| + |lse_s|) per row (the KL is a difference of terms
     of the size of the log-partitions, each carried in fp32; the kernel
     sums online in another order than the plain log-sum-exp);
   * causal attention at head dims 64 and 128 (kernels of their own) and
     32, 33, 80, 96, 256 and 320 (the kernel for every other D: D padded to
     a multiple of 32, past 256 in chunks of output columns), each case at
     every one, at (96, 1024, D), (20, 128, D), (20, 64, D)
     (one key tile: only the diagonal) and (12, 96, D) (a tile past the
     sequence's end), with q and k x4 at (24, 1024, D) (where one TF32
     product per product misses the bound: the plain version with TF32
     matmuls is shown to, by > 10x), and with rows whose
     largest score arrives in a late key tile: within S * 2^-24 * max|v|
     (each output is a convex combination of at most S rows of v, summed
     in fp32 in another order), and a causality check, bitwise: changing k
     and v from a position on leaves every earlier output unchanged, and
     (B, H, S, D) bitwise (B*H, S, D), at every head dim; q, k and v as
     views one element into a buffer (a storage offset that is not a
     multiple of 16 bytes, which the wrapper copies to aligned buffers)
     give the aligned call's output bitwise; at head dims 80, 96, 256 and
     320 one call in each dtype launches the any-D kernel once (counted
     under ``flash_attention{,.bf16,.f16}.dany``: its rows'
     ``entry_launches``), and at head dim 0 each C entry point returns
     ``cudaErrorInvalidValue`` with its output untouched.  The
     build line gives every kernel's registers and spills (a spilled
     attention kernel fails), and the count of tensor-core instructions in
     the attention library's SASS (HMMA: the fp32 D 64 kernel's and the
     any-D kernel's mma.sync; HGMMA: the others' wgmma).
   Then each kernel's bf16 entry point on bf16 inputs: the wire scatter
   (also at its edges: 1 and 200 rows, N 1 and 8, k 1, 1000 and 3000, V 5
   and 37, a column that takes 1e8, 1, -1e8, 1 from clients 0-3, and a, b,
   idx as views at an offset), the top-k masks (bf16-rounded normal rows, the
   NaN/+-inf/near-3e38
   rows, rows of a few exact bf16 values whose k-th value sits in a tie
   group of ~50, ~500, ~2000 and ~17 000 values, and a row of one exponent
   bin, which the bf16 kernel's radix select histograms into one bin) and
   the dense aggregation ``torch.equal`` to their plain versions (fp32
   arithmetic on the upcast inputs, rounded to bf16 once); the KL within
   its fp32 tolerance (also at 1 and 200 rows, with the maxima in the last
   CTA's slice of the row); the attention within S * 2^-24 * max|v| plus one
   bf16 ulp (both round once from fp32; with late maxima too; at D 64 and
   128), with q, k x12 within that plus ``score_order_term`` (what the
   scores' fp32 sums in the kernel's k-step order can move the output; the
   other cases' bound has no term for it), and causal, folded and offset
   views bitwise.  Then each fp16 entry point on fp16 inputs, the same checks
   (``check_f16_kernels``) at fp16's range: the wire's order-sensitive
   column takes 32 768, 2^-14, -32 768, 2^-14 (2^-14 in order) and its b
   sums past 65 504 (inf, as the plain version's cast); the top-k also on
   rows of fp16 subnormals with +-0, of values near +-65 504 (a static k = 0
   takes lo to just under 65 505, which rounds up to +inf: nothing kept),
   of those with +inf entries (only they stay) and of subnormals of both
   signs, its one-bin row in [1, 1 + 2^-5); the KL's -1e30 entries as -6e4
   (fp16's -1e30 is -inf, and the KL NaN), and NaN where the plain version
   is NaN on rows holding +inf; the attention within S * 2^-24 * max|v|
   plus one fp16 ulp.
4. small input — the port's round on a tiny config on the card (kernels)
   and on the CPU (plain versions), ``fused_e2e`` then ``fused``, float and
   int8 uplink: identical k and bytes, accuracies within one eval sample,
   the final broadcast logits within 1e-3 of their largest magnitude (fp32
   reductions run in another order on the card, and Adam's normalised step
   carries such differences into the weights); on the int8 uplink one
   quantization step, 1/127, since a last-bit difference can move a value
   across a rounding boundary.  On ``fused_e2e`` the server-distill loss is
   held within rtol 1e-3 (off the e2e path it is NaN by definition).  Then
   ``pretrain_classifier`` and ``pretrain_lm``, 3 steps each on the tiny
   configs, on the card against the CPU: the adapters reset bitwise, the
   backbone within the CPU tests' bound (every element within 1e-4 but up
   to 0.1 % of a leaf, each within 2 * lr * steps: Adam's normalised step
   turns a last-bit difference of a near-zero gradient into a step of
   order lr).
5. main path — ``run_federated`` with AdaLD and ``use_kernels=True`` at the
   paper's widths (GPT-2 small clients, GPT-2 large server), 2 rounds each:
   ``fused_e2e`` float and int8 wire, ``fused`` float and int8 uplink,
   ``batched`` and ``sequential`` float uplink; then ``fused_e2e`` float
   wire and ``fused`` float uplink in bf16 (the models and the round body
   compute in bf16: ``compute_dtype="bfloat16"`` on both), then the same
   two in fp16 (``compute_dtype="float16"``), each held identical to its
   fp32 run on per-client k, bytes and transmitters, with the LoRA masters
   and Adam moments checked fp32 after every run.  Every launch count is set
   to 0 just before each run and read just after: the bf16 runs launch the
   bf16 entry points (``name.bf16``), the fp16 runs the fp16 ones
   (``name.f16``), the scatter kernels
   launch once a round on ``fused_e2e`` (float or int8), the per-row top-k
   once a round on ``fused``, the dense aggregation once a round with a
   transmitter on ``fused``, ``batched`` and ``sequential``, and nothing
   else launches.  The ``sequential`` run's per-client k and ledger bytes
   are held identical to the ``batched`` run's.  Three kernels have no
   engine caller (nor in the reference), so their main-path count is 0;
   each is driven on its own through its public entry point, with the
   counts set to 0 just before and read just after (``entry_launches``):
   the static top-k through ``core.topk.topk_mask_dense(use_kernel=True)``
   on each ``fused`` run's final broadcast; the KL through
   ``total_distill_loss(use_kernel=True)`` after the ``sequential`` run,
   the final broadcast as teacher and client 0's public logits as student,
   against ``use_kernel=False`` (and a student that requires grad must
   raise), and the same after the bf16 and fp16 ``fused`` runs, its kernel
   part held against the plain version of the kernel (the plain 16-bit
   loss rounds as the reference's does); the attention through
   ``kernels.ops.flash_attention`` in phase 6, in fp32, bf16 and fp16.
5b. pretrained main path — the same fleet with the reference's default
   pretraining (80 supervised steps for the clients' shared GPT-2 small
   backbone, 60 next-token steps for the GPT-2 large server, on 12 % of
   the data), 3 rounds: ``fused_e2e`` round by round, with the pretraining
   timed, its loss every 20 steps and both models' accuracy right after it
   printed, and the last round traced; ``fused_e2e`` with
   ``scan_rounds=True`` (pretraining from the cache), its block
   (``FusedE2EEngine.run_block``) run under
   ``torch.cuda.set_sync_debug_mode("error")``, so that any synchronising
   call in it raises (the guard is first shown to catch a ``.item()``),
   and held to the per-round run: identical k, bytes and transmitters,
   accuracies within 1e-6, the distill loss within rtol 1e-4; the same
   block again under ``torch.profiler`` (CUDA activity); ``fused``, whose
   last top-k input is kept for the timing phase.  Each run asserts the
   fleet store's shared layout and its launch counts (the scatter once a
   round on ``fused_e2e``; the top-k and the aggregation once a round on
   ``fused``).  ``[trace]`` lines give the device's busy share of the
   traced window and of the untraced run's time for the same work, the
   kernel count and the five longest idle gaps.
5c. scenarios, faults, checkpoints — the main path's fleet, its server
   at GPT-2 large's widths but 12 of its 36 layers (``FAULT_SERVER``: the
   smoke's time), with one
   pretraining step (the fleet shares one backbone; the server's none) on
   a Gilbert-Elliott channel of 300 MHz with ``faults="lossy"``, seed 5
   (over its 3 rounds an outage, a crash, a quarantine and a delivery
   after a HARQ retry, which needs a budget of two payload copies: a
   client whose k the vocabulary caps): ``fused_e2e`` round by round, then
   as a ``scan_rounds`` block under ``set_sync_debug_mode("error")``, held
   identical on k, attempted k, bytes and fault taps, with the block's SNR
   taps within 1e-2 dB of the host's chain and its outage flags equal,
   then the same block with no scenario and no faults (the i.i.d. channel:
   the pair of block times isolates the channel chain and the fault
   inputs); ``batched`` with ``faults="corruption"`` and round 0's first
   dense row made NaN on the card, which the server's ``validate_dense``
   gate quarantines (the payload undelivered, ``invalid_wire`` counted)
   before kernel 4 aggregates the rest, ``torch.equal`` to the plain
   aggregate of the clean rows without it; the largest round's wire, float
   and int8, with one client row corrupted, through
   ``Server.aggregate_sparse_wire(validate=True)`` (kernels 1 and 2),
   ``torch.equal`` to its plain version and to the wire without that row;
   1 round with ``ckpt_dir``, its bytes and save seconds, serving 8 tokens
   for 2 tenants from its npz (``MonolithicSource``) against the live
   store, then resumed to 3 rounds (restore seconds) and held to the
   uninterrupted run: integers identical, accuracies and distill losses
   equal, and the final fleet and server adapters and optimizer states
   ``torch.equal``.  The checkpoint directory (one step on disk at a
   time) is removed.
5d. the host fleet store and ``fed_train`` — first the store's staging on
   toy rows: 12 rounds of cohorts that overlap the round before, in the
   round loop's order (hint r+1, fetch r, commit r), every fetch
   ``torch.equal`` to a store without prefetch.  (a) Phase 5's
   ``fused_e2e`` float-wire run again with ``fleet_store="host"`` (prefetch
   on): per-client k, bytes, transmitters, accuracies and distill losses
   equal to the device store's run, and every trained tensor (fleet and
   server LoRA, Adam m, v, count) ``torch.equal``; the store's staging
   slots and commit rows pinned, its side stream not the current one; each
   round's time and the peak memory beside phase 5's; the prefetch hits,
   the host time of a staged and of a cold ``fetch``, and of each
   ``commit`` (its wait for the round and the copy, and its host-row
   write).  (b) The same engine over ``HostFleetStore.from_template``
   (one shared backbone, clients cycled over the 8 real ones) at N = 8 and
   N = 10 000, 3 rounds of cohort 4 each in the round loop's order:
   ``device_bytes()`` the backbone's bytes at both, the peak memory at
   10 000 within 256 MiB of 8's, the steady round time and the resident
   host bytes printed; then a staging thread made to fail must fail the
   fetch of its cohort.  (c) ``repro_torch.launch.fed_train.main`` at its
   own reduced widths (``--engine fused_e2e --use-kernels --fleet-size 64
   --per-round 4``): a host-store run of 2 rounds with ``--ckpt-dir``
   (``fleet_*`` shards in ``step_00000002.fleet/``, ``fleet_sharded`` in
   the step's metadata), a device-store run resuming it to 3 rounds, and a
   fresh device-store run of 3: the resumed record equals the fresh one on
   every round's mean k, uplink and downlink MB, accuracies and distill
   loss.  Every run's launches are counted (the scatter once a round).
5e. scale-out — ``shard_clients`` over ``torch.distributed``.  (a) World
   size 1 over NCCL (a one-rank group on a ``HashStore``): phase 5's
   ``fused_e2e`` float and int8 wire and ``fused`` float runs again with
   ``shard_clients=True``: per-client k, bytes, transmitters, accuracies and
   distill losses equal, and every trained tensor ``torch.equal`` (at one
   rank the split is no split and the gather a copy); launches as phase
   5's.  (b) World size 2 over gloo, two spawned processes on the one card
   (a child's failure fails the phase), ``fused_e2e`` float wire: cohorts of
   4 (2 rows a rank) and of 3 (one pad row) round by round, and the cohort of
   3 as a 2-round ``scan_rounds`` block; against the unsharded run (the
   parent's; for the cohort of 4, phase 5's, its wire masks from (a)): k,
   bytes, transmitters and every round's wire mask identical, accuracies
   within one eval sample, distill losses within rtol 1e-4, trained LoRA
   leaves within 1e-3 in relative L2 per leaf (``SHARD_NORM``); both ranks'
   records and trained tensors ``torch.equal``.  Round times, and the bytes
   each round gathers and the gather's device time (CUDA events), are
   printed at world sizes 1 and 2: on one card two ranks check correctness,
   not speed (both run the server phase on the same GPU).  (c)
   ``fed_train --shard-clients`` under ``python -m torch.distributed.run
   --standalone --nproc-per-node 1`` at its reduced widths: its JSON equals
   the unsharded CLI run's (in this process) on mean k, uplink and downlink
   MB and accuracies.  (d) The ``train`` CLI (5 steps of the GPT-2 smoke
   config) and the ``serve`` CLI (one adapter; 8 tenants in 8 slots): their
   losses, ms a step and tokens/s printed beside the card's name and power
   limit.
6. serving — a shared GPT-2 small backbone and 8 tenant adapters (A and B
   drawn from a numpy seed) in a ``DeviceFleetStore``, exported to an
   ``AdapterCache`` of 4 slots behind a ``ServeSession`` of batch 8: two
   tenant mixes (the second pages in through eviction), 32-token prompts
   prefilled, 32 tokens greedy-decoded; the cache stats held exactly; every
   request's logits at every step held within 1e-4 of their largest
   magnitude against the request run alone with its merged adapter, the
   stacked run's tokens fed to it (fp32 GEMMs of other shapes sum in
   another order).  Then ``make_prefill_step`` at (8, 1024), the chunked
   attention, and the attention kernel on layer 0's q/k/v of that prefill,
   held against the chunked attention and the plain version (and a q that
   requires grad must raise); then that q/k/v rounded to bf16 through the
   bf16 kernel, and rounded to fp16 through the fp16 kernel.  Then
   (``[prefill 32k]`` lines) yi-9b's layer-0 attention at the dry run's
   prefill_32k sequence, 32 768 (its batch of 32 cut to 1): q, k, v from
   the port's own init of one layer at the published widths (d 4 096, 32
   query heads over 4 K/V heads, D 128, RoPE), K and V repeated to the 32
   heads and passed through ``ops.flash_attention`` in fp32, bf16 and fp16
   (the D = 128 kernels, one launch each, counted under ``name.d128``),
   each held against the
   model's own chunked GQA attention of that layer (``Q_CHUNK`` 512) and
   against the plain version on head-batches 0 and 27, one at a time (its
   S x S scores are 4 GiB a head-batch), under the same bounds, and timed
   beside its bound.
6f. model families and mixed fleets (after serving, whose single timed
   prefill it would otherwise follow onto a freshly emptied allocator) —
   (a) a fleet of GPT-2 small and granite-moe-1b-a400m clients (its
   published widths: 24 layers, d 1024, GQA 16/8, RoPE, RMSNorm, SwiGLU, 32
   experts top-8; re-based onto the GPT-2 vocabulary and GPT-2 small's
   LoRA, fp32) x8, cohort 4, 2 rounds,
   one pretraining step a family (one backbone each) and a 12-layer GPT-2
   large server, through ``fused_e2e`` (float and int8 union wire),
   ``fused``, ``batched`` and ``sequential``: the four float runs identical
   on per-client k, uplink and downlink bytes and transmitters, accuracies
   within 4 of 128 eval samples of the sequential run's (``FAMILY_ACC_TOL``:
   the engines sum in other orders on the card), the int8 wire's k at
   least the float wire's with the same transmitters; each run's round
   seconds, peak memory and cohorts by family printed, its launches held
   exactly (kernel 1 or 2 once a round, kernel 3 once a bucket a round,
   kernel 4 once a round).  (b) Each dense and MoE smoke config: forward,
   prefill, and 8 decode steps within 2e-3 of the forward (MoE at capacity
   factor 8), and a sliding-window decode of 16 steps through a ring of 6
   slots; then granite at full width: the (8, 1024) prefill and a decode
   step at batch 8 timed, one step run with every synchronising call an
   error.  (c) A union wire of two buckets at k_cap 128 and 1024
   (``concat_wires``) through kernels 1 and 2, ``torch.equal`` to their
   plain versions and to the unpadded wide wire.  (d) The fleet of (a) once
   more on ``fused_e2e`` with the float wire as a ``scan_rounds`` block
   (``HeteroFusedE2EEngine.run_rounds``), its ``run_block`` with every
   synchronising call an error: per-client k, bytes and transmitters
   identical to (a)'s per-round ``fused_e2e`` run, accuracies within
   ``FAMILY_ACC_TOL``, one family tap a family a round, kernel 1 once a
   round.  (e) granite serving at (a)'s widths: a ``ServeSession`` of batch
   8 with one tenant in every row, whose stacked step routes the 8 tokens
   as one group, within 1e-5 of their largest logit against that
   tenant's own ``decode_step`` at batch 8 over 32 prompt and 16 greedy
   tokens (the first step's router choices past an expert's capacity
   counted); then 8 tenants in 4 slots: exact cache stats, a step's time
   and tokens/s.
6g. the state-space families, SSM and hybrid — (a) phase 6f's fleet with
   mamba2-130m in granite's place (its published widths: 24 layers, d 768,
   d_inner 1536, 24 SSD heads of P 64, state N 128, conv 4, chunk 256;
   the vocabulary re-based to GPT-2's, fp32; attention-free, so of GPT-2
   small's rank-8 LoRA it keeps the head adapter, which gives its eq. 8
   projection), the same five runs and checks.  (b) mamba2-130m alone in
   its published bf16 and in fp32: the (8, 1024) prefill (4 chunks), 16
   decode steps at batch 8 against the forward (``DECODE_TOL``; bf16 plus
   4 bf16 ulps of the largest logit), a decode step run with every
   synchronising call an error and then timed, and one decode step traced
   (busy share, top device ops).  (c) The SSM and the hybrid smoke configs
   (jamba-smoke: a period of SSM, SSM + MoE, attention, SSM + MoE; MoE at
   capacity factor 8): forward, prefill, 8 decode steps against the
   forward; then ``fed_train --families
   gpt2-paper,mamba2-130m,jamba-1.5-large-398b --engine fused_e2e
   --use-kernels --rounds 2`` on the card (kernel 1 once a round).  (a)
   also runs 6f (d)'s block on this fleet.  (d) A
   ``ServeSession`` of batch 8 on mamba2-130m with 8 tenants' head
   adapters in an ``AdapterCache`` of 4 slots: 32-token prompts, 32
   greedy tokens, every request's logits within 1e-5 of their largest
   magnitude against the request alone (the CPU test's bound).
6h. the VLM and the audio encoder-decoder — (a) phase 6f's fleet with
   internvl2-76b in granite's place (its published widths: d 8192, GQA
   64/8, d_ff 28 672, RoPE, RMSNorm, SwiGLU; cut to 1 of its 80 layers and
   32 of its 256 stub patches; the vocabulary re-based to GPT-2's with
   GPT-2 small's LoRA; fp32, its AdamW moments too): ``fused_e2e`` float
   wire and ``fused``, identical on per-client k, bytes and transmitters,
   launches exact.  (b) The same with seamless-m4t-large-v2 (its published
   widths and depth: 24 encoder + 24 decoder layers, d 1024, 16 heads,
   d_ff 8192; 32 of its 1024 stub frames; re-based likewise; fp32) through
   phase 6f's five runs and checks and 6f (d)'s block.  (c) Each alone at its published
   widths in bf16: internvl2 at 8 layers (256 patches, 768 text tokens as
   ``input_token_len`` gives, vocab 128 256) and seamless at its 24 + 24
   (1024 frames, vocab 256 208, GPT-2 small's LoRA): the (8, 1024)
   prefill timed beside its operations (``prefill_flops``), 16 decode
   steps at batch 8 (seamless's against its forward within
   ``DECODE_TOL`` plus 8 bf16 ulps of the largest logit; internvl2's
   finite: its decode carries no patches), a decode step run with every
   synchronising call an error, timed and traced.  (d) ``fed_train
   --families gpt2-paper,internvl2-76b,seamless-m4t-large-v2 --engine
   fused_e2e --use-kernels --rounds 2`` (kernel 1 once a round).  (e)
   seamless at its published widths in fp32: 16 decode steps within
   ``DECODE_TOL`` of its forward, then a ``ServeSession`` of batch 8 with
   8 tenants' adapters (the encoder's among them) in an ``AdapterCache``
   of 4 slots, the encoder run once a reset on the session's own
   parameters: 32-token prompts, 32 greedy tokens, every request's logits
   within 1e-5 of their largest magnitude against the request alone (on
   its own frames of the batch's stub).
7. timing — each kernel's C entry point, its wrapper, its plain version and
   one PyTorch library call where one computes the same function, at the
   main path's shapes, beside the least time the card could take (for
   the attention, its operations at the TF32 tensor-core rate, three
   products per product, as the kernel runs them).  The
   top-k's work depends on its input: it is timed on the ``fused`` float
   run's own last-round input (captured at its call), on the pretrained
   ``fused`` run's (``ms_pretrained``, fp32 rows), on random rows and on
   constant rows (its worst case).  The KL's inputs (25.7 MB) would stay
   in the 50 MB L2 between back-to-back launches, so its row's ``ms`` (and
   ``plain_ms``) take the launches in turn over ``COLD_COPIES`` copies of
   them, each read cold; ``ms_warm`` repeats one copy.  The float wire
   scatter's and the KL's rows (fp32 and bf16) add ``ms_graph``: the same
   launches captured in a CUDA graph and replayed, the host's per-call work
   out of the way (for the KL read cold; ``ms_graph_warm`` warm).  The bf16 entry
   points get rows of their own (``name.bf16``), their bounds counting
   bytes at bf16 width (and, for the attention, Q K^T as one bf16 product
   and P V as two, the two pieces of P the kernels run, which the checks
   show are enough, at every head dim; ``bound_1p3_ms`` beside it counts P
   in three pieces, the basis of the D 64 rows' records before PR 33); the bf16 top-k rows
   are timed on the bf16 ``fused`` run's input (and on one-exponent-bin
   rows, ``ms_one_bin``), and the bf16 attention's library call (bf16
   SDPA, which rounds P to bf16: not the same function) reports its error
   against the plain version beside its time.  The fp16 entry points get
   rows of their own (``name.f16``) on the same terms: bytes at 16-bit
   width, the attention's operations at the fp16 tensor-core rate (the
   bf16 rate), the top-k timed on the fp16 ``fused`` run's input (and on
   rows of one fp16 high-digit bin), the library calls ``scatter_add_``,
   ``torch.topk`` and fp16 SDPA.  The attention also has rows at head dim
   128 (``name.d128``, N(0, 1) inputs at (96, 1024, 128), each dtype, its
   SDPA in that dtype) and two at yi-9b's prefill_32k
   (``flash_attention.d128.s32k`` and ``flash_attention.bf16.d128.s32k``:
   the fp32 and bf16 q/k/v of phase 6's [prefill 32k] check at (32, 32 768,
   128), held to the plain version on the two sampled head-batches, which
   it times one head-batch at a time over all 32; few repeats, then three
   samples each beside the SM clock, ``ms_samples`` and ``sm_clock_mhz``).
   The wrapper counts the D = 128 instances apart (``name.d128``); their
   rows' ``entry_launches`` are those instances' launches in the yi-9b check
   (the 32k rows' those of their dtype's D = 128 instance).  The kernel for
   every other head dim has rows at (96, 1024, D) for D 80, 96, 256 and 320
   in each dtype (``name.dany.d<D>``, N(0, 1) inputs, SDPA in that dtype
   beside), their launches the ``name.dany`` counter's.
9. production mesh (runs after phase 6h, before the timing rows; no
   hand-written kernel).  (a) In a spawned process of its own (so that no
   state an earlier phase left reaches it), a 1x1 ``("data", "model")``
   mesh over a one-rank NCCL group: yi-9b at its published widths cut to 4 layers,
   mamba2-130m and granite-moe-1b-a400m whole (bf16, their configs), each
   train step (``make_train_step``, AdamW), prefill and 4 decode steps at
   batch 4 and 1024 tokens, once on plain tensors and once with every
   argument a DTensor placed by the spec rules and the activation rules
   installed (the one-hot embedding, the anchors, the attention and SSD
   through ``local_map``, the ring write; decode's per-slot-shard attention
   needs a cache split over ranks, and runs in (b) and in the CPU tests'
   2x2 mesh): loss, prefill and decode logits bitwise or
   within two bf16 ulps of their largest magnitude, each updated
   parameter leaf within 1e-2 of its update (``||got - want|| / ||want -
   p0||``; bitwise where the plain step leaves it unchanged).
   (b) ``python -m repro_torch.launch.dryrun`` in processes of their own,
   started before phase 6f (they take host cores, no card, and run beside
   phases 6f-6h): yi-9b x train_4k on the single- and multi-pod
   meshes (256 and 512 fake ranks), mamba2-130m x long_500k, granite x
   decode_32k; each record's per-device argument and peak GiB against the
   card's 80 GiB, its TFLOP and collective GB by kind.  (c) The dry run at
   (a)'s 1x1 mesh of (a)'s yi-9b train step (a spawned process, a fake
   world of one): its flops and argument bytes equal to the real step's,
   its peak (arguments + temp) beside ``torch.cuda.max_memory_allocated``
   above the memory held before the step's arguments; the phase fails
   below 80 %.  Every step of (a)-(c) rematerialises (the full configs set
   ``remat``).  (d) In (a)'s process after it: each of (a)'s models and a
   hybrid of one period of jamba-1.5-large-398b's layout (8 layers: its
   attention at offset 4, MoE every 2 at offset 1, SSD state 128, head 64,
   expand 2, vocab 65 536, bf16, as published; cut to d 2 048, 16 / 2
   heads, 4 experts of d_ff 6 144, each cut logged) take one train step
   with ``remat`` and two without, at (a)'s batch and tokens: the loss and
   each parameter leaf of the remat'd step held to the first plain step's
   by (a)'s bounds, the second plain step's spread beside; the gradient
   pass alone (forward and backward of the step's first microbatch, no
   update) and the whole step each read ``torch.cuda.max_memory_allocated``
   from a reset, less the memory held before the run plus the step's
   arguments (the step's is
   the functional AdamW update's wherever the optimizer state outweighs the
   activations), and the remat'd gradient pass must peak lower than both
   plain ones; ms a step each.

The last lines are the card and its power limit, the kernels record and the
device record (JSON).  In the kernels record ``launches`` is each kernel's
count summed over the ten main-path runs, the pretrained path's four,
phase 5c's runs and validated wires, phase 5d's runs, phase 5e's
(its children's included), phase 6f's six, phase 6g's six and its
``fed_train`` run and phase 6h's eight and its ``fed_train`` run,
``pct_of_bound`` its bound over its time; the static top-k's, the KL's and the attention's rows (fp32,
bf16 and fp16) add ``entry_launches``, their counts through their public
entry points.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import ckpt as ckpt_io  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import LoRAConfig, ShapeConfig  # noqa: E402
from repro_torch.configs.gpt2_paper import GPT2_LARGE, GPT2_SMALL, REDUCED_CLIENT, REDUCED_SERVER  # noqa: E402
from repro_torch.core.aggregation import (  # noqa: E402
    AggregationMode, aggregate_wire, max_intermediate_elems,
)
from repro_torch.core.channel import ChannelConfig, ChannelSimulator  # noqa: E402
from repro_torch.core.distill import total_distill_loss  # noqa: E402
from repro_torch.core.faults import FaultSimulator, corrupt_wire  # noqa: E402
from repro_torch.core.scenario import get_scenario  # noqa: E402
from repro_torch.core.topk import (  # noqa: E402
    SparseWire, _stable_topk, concat_wires, quantize_wire, sparsify_wire, topk_mask_dense,
)
from repro_torch.data import make_banking77_like  # noqa: E402
from repro_torch.fed import (  # noqa: E402
    BatchedEngine, FedConfig, FusedE2EEngine, HeteroFusedE2EEngine, Server,
)
from repro_torch.fed import pretrain as fed_pretrain  # noqa: E402
from repro_torch.fed import rounds as fed_rounds  # noqa: E402
from repro_torch.fed import steps as fed_steps  # noqa: E402
from repro_torch.fed.engines import k_cap_bucket  # noqa: E402
from repro_torch.fed.store import DeviceFleetStore, HostFleetStore  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.launch import fed_train  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import H100  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    full_grads,
    init_train_opt,
    make_serve_step,
    make_train_loss,
    make_train_step,
)
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.lora import is_lora_path, lora_template, merge_lora, split_lora  # noqa: E402
from repro_torch.models import attention, frontends, model, transformer  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.layers import apply_rope, embedding, layer_norm, norm_apply  # noqa: E402
from repro_torch.models.transformer import layer_slice  # noqa: E402
from repro_torch.serve.export import FleetStoreSource, MonolithicSource  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdapterCache,
    ServeConfig,
    ServeSession,
    export_adapters,
    make_prefill_step,
    serving_params,
)

# the H100 SXM data sheet's figures (repro_torch.launch.mesh.H100), not measurements
HBM_BYTES_PER_S = H100["hbm_bandwidth"]
FP32_OPS_PER_S = H100["peak_fp32_flops"]  # outside the tensor cores
TF32_OPS_PER_S = H100["peak_tf32_flops"]  # dense, on the tensor cores
BF16_OPS_PER_S = H100["peak_bf16_flops"]  # dense, on the tensor cores
TF32_SPLIT = 3  # the attention kernel's TF32 products per fp32 product (3xTF32)
N_CLIENTS, ROWS, VOCAB = 4, 64, GPT2_SMALL.vocab_size
WIDE_ROWS, WIDE_VOCAB = 8, 152_064  # a vocabulary beyond one block's shared memory
COLD_COPIES = 8  # copies of an input under the 50 MB L2, taken in turn to time it cold
MODES: tuple[AggregationMode, ...] = ("adaptive", "zeropad", "mean_nonzero")
_CSRC = "src/repro_torch/kernels/csrc/"
_AGG, _TOPK = _CSRC + "sparse_agg.cu", _CSRC + "topk_select.cu"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "scatter_wire_sums": (_AGG, "src/repro/kernels/sparse_agg.py:149"),
    "scatter_wire_sums_dequant": (_AGG, "src/repro/kernels/sparse_agg.py:244"),
    "topk_mask_dynamic": (_TOPK, "src/repro/kernels/topk_select.py:104"),
    "sparse_aggregate": (_AGG, "src/repro/kernels/sparse_agg.py:60"),
    "topk_mask": (_TOPK, "src/repro/kernels/topk_select.py:129"),
    "distill_kl": (_CSRC + "distill_kl.cu", "src/repro/kernels/distill_kl.py:96"),
    "flash_attention": (_CSRC + "flash_attention.cu", "src/repro/kernels/flash_attention.py:87"),
}
BF16, F16 = torch.bfloat16, torch.float16
TAG = {dt: tag for dt, (tag, _) in ops._SUFFIX.items()}  # launch-count tags: "", ".bf16", ".f16"
SUFFIX = {dt: suffix for dt, (_, suffix) in ops._SUFFIX.items()}  # C entry points: "_f32", ...
# each kernel's bf16 and fp16 entry points: the same source and TPU kernel
# (the int8 wire's scatter has no 16-bit input)
KERNELS.update({f"{name}{TAG[dt]}": KERNELS[name] for dt in (BF16, F16) for name in ops.BF16_KERNELS})
# the attention's rows at head dim 128 (the kernels' D = 128 instances, which
# the wrapper counts under these names), and fp32 and bf16 at yi-9b's prefill_32k
D128 = ".d128"
ATTN_32K = "flash_attention.bf16" + D128 + ".s32k"
ATTN_32K_F32 = "flash_attention" + D128 + ".s32k"
KERNELS.update({f"flash_attention{TAG[dt]}{D128}": KERNELS["flash_attention"]
                for dt in (torch.float32, BF16, F16)})
KERNELS[ATTN_32K] = KERNELS[ATTN_32K_F32] = KERNELS["flash_attention"]
# the any-D kernel's timing rows at (96, 1024, D), each dtype: phi-2's 80,
# Phi-3's 96, Gemma's 256 and the chunked path at 320; a row's name is its
# counter's (``.dany``), then the head dim
ANY_TIMED = (80, 96, 256, 320)


def any_suffix(d: int) -> str:
    """The any-D kernel's row suffix (after the dtype's tag) at head dim ``d``."""
    return ops.flash_instance(d) + f".d{d}"


KERNELS.update({f"flash_attention{TAG[dt]}{any_suffix(d)}": KERNELS["flash_attention"]
                for dt in (torch.float32, BF16, F16) for d in ANY_TIMED})
# the 16-bit main-path runs: the models compute in that dtype, and so does the round body
LOW_CFG = {BF16: dict(compute_dtype="bfloat16"), F16: dict(compute_dtype="float16")}
# the bf16 kernels' times before their redesign (loaders that upcast each
# tile into the fp32 kernels: PERF.md section 6, H100 80GB HBM3, 700 W; the
# KL's read cold), printed beside this run's; the kernels line keeps only
# what this run measured
EARLIER_MS = {"topk_mask_dynamic.bf16": 0.0539, "topk_mask.bf16": 0.0536,
              "flash_attention.bf16": 0.1410, "scatter_wire_sums.bf16": 0.0123,
              "distill_kl.bf16": 0.0117}
# the serving phase: tenants, slots, batch, prompt and decode lengths
TENANTS, SLOTS, SERVE_BATCH, PROMPT, GEN = 8, 4, 8, 32, 32
PREFILL_S = 1024
# yi-9b's layer-0 attention at the dry run's prefill_32k sequence (its batch
# of 32 cut to 1), and the two head-batches the plain version runs on (its
# S x S scores are 4 GiB a head-batch): head 0 of K/V group 0, head 27 of group 3
YI_S, YI_HEADS = 32_768, (0, 27)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- inputs -------------------------------------------------------------------


def make_wire(k_cap: int, seed: int, device, rows: int = ROWS, vocab: int = VOCAB,
              dtype: torch.dtype = torch.float32):
    """A cohort wire shaped as the main path shapes it, from sparsify_wire
    on random logits (in ``dtype``), with the edge cases forced in: client 2
    sends nothing (k = 0), clients 1 and 3 pad their masked entries at index
    0 (as ``pad_wire`` does) while rows of client 1 send a real index-0
    entry, and client 3's logits are all negative."""
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = torch.randn((N_CLIENTS, rows, vocab), generator=gen, device=device)
    logits[1, ::2, 0] = 10.0  # index 0 in client 1's top-k on even rows
    logits[3] -= 20.0
    ks = [k_cap, k_cap // 2, 0, 3]
    wire = sparsify_wire(logits.to(dtype), ks, k_cap)
    idx = torch.where(wire.mask, wire.indices, 0).contiguous()
    return wire._replace(indices=idx)


def float_channels(wire, mode: str):
    """The wire's two contribution channels, in its dtype, as
    ``aggregate_wire`` forms them."""
    m = wire.mask.to(wire.values.dtype)
    v = wire.values * m
    if mode == "adaptive":
        s = torch.abs(v)
        return s * v, s
    return v, m


TOPK_EDGE_ROWS = 12


def topk_rows(rows: int, vocab: int, seed: int, device):
    """(rows, V) logits and int32 budgets with the edge cases in the first
    twelve rows — k = 0, 1, V and V + 7 on random rows; a tie of 12 at the
    threshold for k = 10; an all-negative row; a constant row; a row of
    half-integers; a row holding a NaN (min and max are NaN: nothing kept);
    a row holding +inf and -inf (every mid is NaN); a row of spread 1e-3
    (the candidate set shrinks late); a row near 3e38 (lo + hi overflows:
    the kernel's full-pass fallback) — and budgets of 1..1024 on the
    random rest."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, vocab), generator=gen, device=device)
    x[4] = torch.randint(-3, 3, (vocab,), generator=gen, device=device).float()
    x[4, 5:17] = 3.0
    x[5] -= 50.0
    x[6] = 2.5
    x[7] = torch.round(x[7] * 2) / 2
    x[8, 123] = float("nan")
    x[9, 7], x[9, 9] = float("inf"), float("-inf")
    x[10] = 1.0 + 1e-3 * x[10]
    x[11] = 3e38
    x[11, :50] = 3.3e38
    ks = torch.randint(1, 1025, (rows,), generator=gen, device=device, dtype=torch.int32)
    ks[:TOPK_EDGE_ROWS] = torch.tensor([0, 1, vocab, vocab + 7, 10, 7, 3, 20, 5, 5, 300, 60],
                                       dtype=torch.int32)
    return x, ks


def dense_stack(ks, seed: int, device, sparse: bool = True):
    """An (N, 64, V) stack like the dense uplink's: each client's top-k of
    random logits at budget ``ks[n]`` (zeros off the support), or dense."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((len(ks), ROWS, VOCAB), generator=gen, device=device)
    if not sparse:
        return x
    kk = torch.tensor(ks, dtype=torch.int32, device=device)[:, None].expand(len(ks), ROWS)
    return ref.topk_mask_ref(x.reshape(-1, VOCAB), kk.reshape(-1), guard=True).reshape(x.shape)


def kl_tolerance(t, s, temp: float, plain: torch.Tensor) -> torch.Tensor:
    """Per-row bound of the KL kernel against its plain version: rtol 1e-5
    plus 2e-6 (1 + |lse_t| + |lse_s|), a few ulps of the log-partitions whose
    difference the KL is."""
    lse = lambda x: torch.logsumexp(x.double() / temp, dim=-1).float()  # noqa: E731
    return 1e-5 * plain.abs() + 2e-6 * (1.0 + lse(t).abs() + lse(s).abs())


def attention_tolerance(s: int, v: torch.Tensor) -> float:
    """The worst-case error of an fp32 sum of ``s`` terms bounded by max|v|:
    each output is a convex combination of at most ``s`` rows of v."""
    return s * 2.0**-24 * float(v.abs().max())


# significant bits, and the least exponent whose ulp the rule below gives
# (fp16's subnormals share the ulp of its least normal binade, 2^-24)
ULP_BITS = {BF16: (8, 1e-38), F16: (11, 2.0**-14)}


def ulp16(dtype: torch.dtype, *xs: torch.Tensor) -> torch.Tensor:
    """One ulp of ``dtype`` (bf16 or fp16) at the larger magnitude,
    elementwise: with p significant bits, 2^(e - p + 1) for a value in
    [2^e, 2^(e+1)) (bf16 keeps 8, fp16 11)."""
    bits, least = ULP_BITS[dtype]
    a = torch.stack([x.float().abs() for x in xs]).amax(dim=0)
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a.clamp_min(least))) - (bits - 1)),
                       torch.zeros_like(a))


def within_16(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Check a 16-bit output rounded once from an fp32 result against its
    plain version, rounded once too: within the fp32 bound ``tol`` plus one
    ulp of its dtype (two fp32 values that close can round to neighbouring
    16-bit values); returns the largest difference."""
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + ulp16(got.dtype, got, want)).all()), float(err.max())
    return float(err.max())


def bf16_tie_rows(x: torch.Tensor, ks: torch.Tensor, gen) -> None:
    """Rows 12-15 of a top-k input (in place): values drawn from 100, 25, 3
    and 1024 levels, each exact in bf16 ((1 + m / 128) 2^e), so that at
    V 50 257 the k-th value sits in a tie group of ~500, ~2000, ~17 000
    (more than the kernel's candidate buffer) and ~50 values."""
    for row, (levels, k) in enumerate(((100, 1000), (25, 3000), (3, 20000), (1024, 700)),
                                      start=TOPK_EDGE_ROWS):
        level = torch.randint(0, levels, (x.shape[1],), generator=gen, device=x.device)
        x[row] = (1.0 + (level % 128) / 128.0) * torch.exp2((level // 128).float())
        ks[row] = k


BF16_ONE_BIN_ROW = TOPK_EDGE_ROWS + 4


def bf16_one_bin_row(x: torch.Tensor, ks: torch.Tensor, gen) -> None:
    """Row 16 of a top-k input (in place): every value in [1, 2), exact in
    bf16, so that all keys share their high byte (sign and 7 exponent bits):
    the bf16 kernel's histogram puts the whole row in one bin, its worst
    case, and the k-th value ties with ~390 others."""
    level = torch.randint(0, 128, (x.shape[1],), generator=gen, device=x.device)
    x[BF16_ONE_BIN_ROW] = 1.0 + level / 128.0
    ks[BF16_ONE_BIN_ROW] = 3000


# -- timing -------------------------------------------------------------------


def time_ms(fn, calls: int = 10, reps: int = 21, warmup: int = 3) -> float:
    """Milliseconds per ``fn()``: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``reps`` such runs.  A call
    whose host work outlasts its device work measures the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(launches, calls: int = 16, reps: int = 21) -> float:
    """Milliseconds per launch with the host's work out of the way:
    ``calls`` launches (``launches``: C-entry calls taking a stream handle,
    run in turn) captured once in a CUDA graph, whose replays are timed.
    Each is first called off the capture (first-call attributes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for launch in launches:
            assert launch(side.cuda_stream) == 0
    torch.cuda.current_stream().wait_stream(side)
    graph, turn = torch.cuda.CUDAGraph(), itertools.cycle(launches)
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(calls):
            assert next(turn)(stream) == 0
    return time_ms(graph.replay, calls=2, reps=reps) / calls


def clocked_samples(fn, n: int = 3, least_s: float = 0.5) -> tuple[list[float], list]:
    """``n`` timings of ``fn`` (ms a call: CUDA events around enough calls to
    last ``least_s``), each beside the median SM clock (MHz) that
    ``nvidia-smi`` read every 50 ms while it ran (None where it read none)."""
    calls = max(1, math.ceil(least_s * 1e3 / time_ms(fn, calls=1, reps=1, warmup=1)))
    ms, mhz = [], []
    for _ in range(n):
        proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                                 "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        try:
            ms.append(time_ms(fn, calls=calls, reps=1, warmup=0))
        finally:
            proc.terminate()
            got, _ = proc.communicate()
        vals = [float(x) for x in got.split() if x.replace(".", "", 1).isdigit()]
        mhz.append(statistics.median(vals) if vals else None)
    return ms, mhz


def in_turn(calls):
    """One call that runs ``calls`` in turn, one a time."""
    turn = itertools.cycle(calls)
    return lambda: next(turn)()


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over the rate of the units that
    run them (fp32 outside the tensor cores unless said otherwise)."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def scatter_library_call(a, b, idx):
    """One ``scatter_add_`` over the client-folded wire into a (2, rows, V)
    buffer: the yardstick PyTorch offers for the same sums (timed only)."""
    n, rows, k = a.shape
    flat = (torch.arange(rows, device=a.device)[None, :, None] * VOCAB + idx.long()).reshape(-1)
    index = torch.cat([flat, flat + rows * VOCAB])
    src = torch.cat([a.reshape(-1), b.reshape(-1)])
    return lambda: torch.zeros(2 * rows * VOCAB, dtype=a.dtype, device=a.device).scatter_add_(
        0, index, src)


# -- phases -------------------------------------------------------------------


def exact_matmuls() -> None:
    """No TF32 in fp32 matmuls and convolutions; fp16 GEMMs reduce in fp32,
    as the reference's dots accumulate (cuBLAS may otherwise reduce split-K
    partial sums in fp16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (this script runs on the GPU only)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    exact_matmuls()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return torch.device("cuda"), card


def ptxas_report(text: str, keys: tuple[str, ...]) -> list[str]:
    """Registers, shared memory and spills per kernel from ``nvcc -Xptxas
    -v`` output, for the entry functions whose name holds one of ``keys``."""
    out, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
            continue
        if "spill stores" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name and any(key in name for key in keys):
            key = next(key for key in keys if key in name)
            args = [a for a, tag in (("FloatWire", "FloatWire"), ("Int8Wire", "Int8Wire"),
                                     ("bf16", "nv_bfloat16"), ("bf16", "4Bf16"), ("f16", "6__half"),
                                     ("f16", "3F16"), ("f32", "3F32")) if tag in name]
            if key == "flash_attention_anyd_kernel":  # its padded head dim
                args += [f"DP {n}" for n in re.findall(r"Li(\d+)E", name)]
            args += [a for a, tag in (("true", "Lb1E"), ("false", "Lb0E")) if tag in name]
            out.append(f"{key}<{', '.join(args)}>: {m.group(1)} registers{m.group(2)}; {spill}")
            name = None
    return out


def sass_opcodes(lib: Path, kernel: str = "") -> dict[str, int]:
    """The opcodes (with their modifiers) of the functions of a built
    library whose mangled name holds ``kernel``, counted (``cuobjdump
    -sass`` from the toolkit that holds nvcc)."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    counts: dict[str, int] = {}
    for sec in re.split(r"\n\s*Function : ", sass)[1:]:
        if kernel not in sec.split(None, 1)[0]:
            continue
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)", sec):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


# the attention library's kernels (the any-D kernel: 9 instances a dtype)
ATTENTION_KERNELS = ("flash_attention_kernel", "flash_attention_f32_d128_kernel", "flash_attention_16_kernel",
                     "flash_attention_16_d128_kernel", "flash_attention_anyd_kernel")


def phase_build():
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"[build] {', '.join(map(str, libs.values()))} in {time.perf_counter() - t0:.1f} s")
    attention = ptxas_report(build.build_log("flash_attention"), ATTENTION_KERNELS)
    report = (ptxas_report(build.build_log("topk_select"), ("topk_mask_kernel", "topk_radix_16_kernel"))
              + ptxas_report(build.build_log("sparse_agg"), ("scatter_wire_kernel", "scatter_wire_16_kernel",
                                                             "sparse_aggregate"))
              + ptxas_report(build.build_log("distill_kl"), ("distill_kl_kernel", "distill_kl_16_kernel"))
              + attention)
    log(f"[build] ptxas -v: {' | '.join(report) or 'no log (library built earlier)'}")
    # a spilled attention kernel (each instance of the any-D kernel among them) fails the smoke
    spilled = [line for line in attention if "0 bytes spill stores, 0 bytes spill loads" not in line]
    assert not spilled, f"attention kernels spill: {spilled}"
    logs = {name: build.build_log(name) for name in libs}
    warned = [line.strip() for text in logs.values() for line in text.splitlines()
              if "Performance Loss" in line or "wgmma" in line.lower()]
    unlogged = [name for name, text in logs.items() if not text]
    log(f"[build] ptxas warnings on wgmma (serialised products): {warned or 'none'}"
        + (f"; no log for {', '.join(unlogged)} (built earlier)" if unlogged else ""))
    # a serialised wgmma runs every product of its kernel one after another
    assert not warned, f"ptxas serialised wgmma products: {warned}"
    count = lambda ops, kind: sum(n for op, n in ops.items() if op.split(".")[0] == kind)  # noqa: E731
    every = sass_opcodes(libs["flash_attention"])
    hmma, hgmma = count(every, "HMMA"), count(every, "HGMMA")
    assert hmma > 0 and hgmma > 0, "an attention kernel runs no tensor-core instruction"
    # the any-D kernel: mma.sync in every instance
    anyd = sass_opcodes(libs["flash_attention"], "flash_attention_anyd_kernel")
    anyd_hmma = count(anyd, "HMMA")
    assert anyd_hmma > 0 and count(anyd, "HGMMA") == 0, anyd
    # the fp32 kernel at D 128: TF32 warpgroup products only
    f32_d128 = sass_opcodes(libs["flash_attention"], "flash_attention_f32_d128_kernel")
    tf32_hgmma = sum(n for op, n in f32_d128.items() if op.startswith("HGMMA") and op.endswith(".TF32"))
    f32_hmma = count(f32_d128, "HMMA")
    assert tf32_hgmma > 0 and f32_hmma == 0, f32_d128
    log(f"[build] flash_attention SASS: {hmma - anyd_hmma} HMMA instructions (mma.sync) in its fp32 kernel "
        f"at D 64, {anyd_hmma} in the 27 instances of flash_attention_anyd_kernel, {hgmma} HGMMA (wgmma) in "
        f"the others, of which {tf32_hgmma} TF32 ones and {f32_hmma} HMMA in "
        f"flash_attention_f32_d128_kernel: their products on the tensor cores")


def check_scatter_kernels(device):
    for k_cap, rows, vocab in ((128, ROWS, VOCAB), (1024, ROWS, VOCAB), (1024, WIDE_ROWS, WIDE_VOCAB)):
        wire = make_wire(k_cap, seed=k_cap, device=device, rows=rows, vocab=vocab)
        for mode in MODES:
            a, b = float_channels(wire, mode)
            got = ops.scatter_wire_sums(a, b, wire.indices, vocab)
            want = ref.scatter_wire_sums_ref(a, b, wire.indices, vocab)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), ("scatter_wire_sums", k_cap, mode)
        qw = quantize_wire(wire)
        for mode in MODES:
            got = ops.scatter_wire_sums_dequant(qw.values, qw.scale, qw.mask, qw.indices, vocab, mode)
            want = ref.scatter_wire_sums_dequant_ref(qw.values, qw.scale, qw.mask, qw.indices, vocab, mode)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), ("dequant", k_cap, mode)
        # the edge cases really are in the data
        assert not wire.mask[2].any() and bool(((wire.indices[1] == 0) & wire.mask[1]).any())
        assert bool((wire.values[3][wire.mask[3]] < 0).all())
        log(f"[kernels] k_cap={k_cap}: both wire scatters torch.equal to their plain versions "
            f"in all 3 modes at N={N_CLIENTS} rows={rows} V={vocab}")
    check_wire_memory_contract(device)


# the sparse path's memory contract, (N, rows, V, k_cap): the reference test's shapes
# (tests/test_engine.py) and the main path's
CONTRACT_SHAPES = ((10, 64, 8192, 256), (N_CLIENTS, ROWS, VOCAB, 1024))


def contract_wire(n: int, rows: int, vocab: int, k_cap: int, seed: int, device) -> SparseWire:
    """A random float wire of ``n`` clients, a tenth of its entries masked
    (their index 0, as ``pad_wire`` pads)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (n, rows, k_cap)
    values = torch.randn(shape, generator=gen, device=device)
    idx = torch.randint(0, vocab, shape, generator=gen, device=device, dtype=torch.int32)
    mask = torch.rand(shape, generator=gen, device=device) < 0.9
    return SparseWire(values=values, indices=torch.where(mask, idx, 0), mask=mask, vocab=vocab)


def check_wire_memory_contract(device):
    """Aggregating straight from the float and the int8 wire, through the
    wire kernels and through the plain route, never holds anything larger
    than the ``(rows, V)`` sums (``max_intermediate_elems``: every op's
    output; the kernels' outputs are allocated through torch), far below the
    ``(N, rows, V)`` dense stack."""
    for n, rows, vocab, k_cap in CONTRACT_SHAPES:
        wire = contract_wire(n, rows, vocab, k_cap, seed=n, device=device)
        worst = {}
        for label, w in (("float", wire), ("int8", quantize_wire(wire))):
            for route, use_kernel in (("kernel", True), ("plain", False)):
                count = max_intermediate_elems(aggregate_wire, w, "adaptive",
                                               num_transmitters=n, use_kernel=use_kernel)
                assert count <= rows * vocab < n * rows * vocab, (label, route, n, count)
                worst[f"{label} {route}"] = count
        log(f"[kernels] memory contract at N={n} rows={rows} V={vocab} k_cap={k_cap}: the largest "
            f"intermediate of the wire aggregation " + ", ".join(
                f"{k} {v}" for k, v in worst.items())
            + f" elements, <= rows*V {rows * vocab} < N*rows*V {n * rows * vocab}")


def check_topk_kernels(device):
    smem_max = ops.smem_max_vocab(device.index or 0)
    # V 50 257 takes the shared-memory path, V 152 064 the device-memory one
    assert VOCAB <= smem_max < WIDE_VOCAB, (smem_max, VOCAB, WIDE_VOCAB)
    for rows, vocab in ((N_CLIENTS * ROWS, VOCAB), (2 * WIDE_ROWS, WIDE_VOCAB)):
        x, ks = topk_rows(rows, vocab, seed=vocab, device=device)
        got = ops.topk_mask_dynamic(x, ks)
        want = ref.topk_mask_ref(x, torch.clamp(ks, 0, vocab), guard=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), ("topk_mask_dynamic", rows, vocab)
        kept = (want != 0).sum(dim=1).tolist()
        assert kept[:4] == [0, 1, vocab, vocab] and kept[4] == 12 and kept[6] == vocab, kept[:12]
        assert kept[8] == 0 and kept[9] == vocab, kept[:12]  # a NaN row keeps nothing
        for k in (0, 1, 517, vocab, vocab + 5):
            got = ops.topk_mask(x, k)
            want = ref.topk_mask_ref(x, torch.full((rows,), min(k, vocab), dtype=torch.int32,
                                                   device=device), guard=False)
            torch.cuda.synchronize()
            assert torch.equal(got, want), ("topk_mask", rows, vocab, k)
        path = "shared-memory" if vocab <= smem_max else "global-memory"
        log(f"[kernels] rows={rows} V={vocab} ({path} path): top-k masks torch.equal to their "
            f"plain versions, per-row k (0, 1, V, V+7, ties, all-negative, constant, NaN row "
            f"kept {kept[8]}, +-inf, spread 1e-3, near 3e38) and static k in (0, 1, 517, V, V+5)")


def check_sparse_aggregate(device):
    ks = [1024, 517, 1, VOCAB]
    for sparse in (True, False):
        stack = dense_stack(ks, seed=11, device=device, sparse=sparse)
        got, want = ops.sparse_aggregate(stack), ref.sparse_aggregate_ref(stack)
        torch.cuda.synchronize()
        assert torch.equal(got, want), ("sparse_aggregate", sparse)
    log(f"[kernels] dense adaptive aggregation torch.equal to its plain version at "
        f"({len(ks)}, {ROWS}, {VOCAB}), top-k-sparse (k {ks}) and dense stacks")


def check_distill_kl(device):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ones = 2 * sms + 56  # enough rows for one CTA a row (C = 1)
    # on an H100's 132 SMs the launch splits a row over C = 2, 4, 8, 1, 8 and 8 CTAs
    for rows, vocab in ((ROWS, VOCAB), (32, VOCAB), (WIDE_ROWS, WIDE_VOCAB), (ones, VOCAB),
                        (WIDE_ROWS, 37), (WIDE_ROWS, 5)):
        t, s = kl_logits(rows, vocab, seed=vocab, device=device)
        # the student one float into a buffer: another 16-byte phase than the teacher's
        s_off = torch.empty(rows * vocab + 1, device=device)[1:].view(rows, vocab)
        s_off.copy_(s)
        worst = 0.0
        for temp in (1.0, 2.0, 4.0):
            want = ref.distill_kl_ref(t, s, temp)
            tol = kl_tolerance(t, s, temp, want)
            for student in (s, s_off):
                got = ops.distill_kl_rows(t, student, temp)
                torch.cuda.synchronize()
                err = (got - want).abs()
                assert bool((err <= tol).all()), ("distill_kl", rows, vocab, temp, float(err.max()))
                assert float(got[0]) == 0.0 and bool((got >= -tol).all()), got[:4]
                worst = max(worst, float(err.max()))
            whole = float(ops.distill_kl(t, s, temp))
            assert abs(whole - float(want.mean()) * temp**2) <= temp**2 * float(tol.mean())
        c = max(c for c in (1, 2, 4, 8) if c == 1 or rows * c <= sms)
        log(f"[kernels] distill_kl at ({rows}, {vocab}) (C = {c} CTAs a row by the launch's rule), T in "
            f"(1, 2, 4): within rtol 1e-5 + "
            f"2e-6 (1 + |lse_t| + |lse_s|) of its plain version per row (max |diff| {worst:.3e}), "
            f"KL exactly 0 for teacher == student, +-3e4 logits and -1e30 entries, student on "
            f"another 16-byte phase")


# the head dims the attention checks run each case at: 64 and 128, each with
# kernels of its own, then D's of the kernel for every other head dim
# (``.dany``): under its widest padded width, odd, phi-2's 80, Phi-3's 96,
# Gemma's 256 and one past 256 (output columns in chunks)
ANY_HEAD_DIMS = (32, 33, 80, 96, 256, 320)
HEAD_DIMS = (64, 128) + ANY_HEAD_DIMS


def late_key(q_row: torch.Tensor, d: int) -> torch.Tensor:
    """A key whose score with ``q_row`` (N(0, 1) entries) outweighs every
    other key of a 1 024-key row: 2 q_row, a score of ~2 D^0.5; below D 64
    scaled up by 64 / D (at D 32 that score, ~11, falls to ~6 on a row of
    small norm, which the row's other keys then outweigh)."""
    return 2.0 * max(1.0, 64 / d) * q_row


def check_flash_attention(device):
    cases = ((96, 1024, 1.0, "q, k ~ N(0, 1)"), (20, 128, 1.0, "q, k ~ N(0, 1)"),
             (20, 64, 1.0, "one key tile, only the diagonal"),
             (12, 96, 1.0, "a key tile past the sequence's end"),
             (24, 1024, 4.0, "q, k x4"), (8, 1024, 1.0, "late maxima"))
    for (bh, seq, qk_scale, what), d in itertools.product(cases, HEAD_DIMS):
        gen = torch.Generator(device=device).manual_seed(seq + d)
        q, k, v = (torch.randn((bh, seq, d), generator=gen, device=device) for _ in range(3))
        q, k = q * qk_scale, k * qk_scale
        if what == "late maxima":  # row 1000's largest score at key 900, key tile 14 of 16
            k[:, 900] = late_key(q[:, 1000], d)
        got = ops.flash_attention(q, k, v)
        want = ref.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err, tol = float((got - want).abs().max()), attention_tolerance(seq, v)
        assert err <= tol, ("flash_attention", bh, seq, d, what, err, tol)
        if what == "late maxima":
            assert float((got[:, 1000] - v[:, 900]).abs().max()) < 0.05 * float(v.abs().max())
        one = ""
        if qk_scale > 1:  # the same plain version with one TF32 product per product misses
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = ref.flash_attention_ref(q, k, v)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            err_one = float((tf32 - want).abs().max())
            assert err_one > 10 * tol, (err_one, tol)
            one = (f"; with TF32 matmuls (one TF32 product per product) the plain version is off "
                   f"by {err_one:.3e}, {err_one / tol:.0f}x the bound")
        log(f"[kernels] flash_attention at ({bh}, {seq}, {d}), {what}: max |diff| {err:.3e} "
            f"against its plain version (bound S * 2^-24 * max|v| = {tol:.3e}){one}")
    check_attention_causal(device, torch.float32)
    check_attention_offset_views(device, torch.float32)


def check_attention_any_head_dim(device) -> dict:
    """Every head dim runs on the card: at D 96 (a head dim the kernels
    refused before the any-D kernel) and at each timed D, one call through
    ``ops.flash_attention`` in each dtype launches one kernel, counted under
    ``flash_attention{tag}.dany``, within the check of its dtype; each C
    entry point returns ``cudaErrorInvalidValue`` (1) for head dim 0 and
    leaves the output it was handed as it was.  Returns the launches by
    timing row (``entry_launches``)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    entry = {}
    for dtype in (torch.float32, BF16, F16):
        name = "flash_attention" + TAG[dtype] + ".dany"
        for d in sorted({96, *ANY_TIMED}):
            q, k, v = attention_inputs((1, 4, 128, d), dtype, device)
            ops.reset_launches()
            got = ops.flash_attention(q, k, v)
            torch.cuda.synchronize()
            assert ops.LAUNCHES[name] == 1 and sum(ops.LAUNCHES.values()) == 1, ops.LAUNCHES
            attention_err(got, ref.flash_attention_ref(*(x.reshape(4, 128, d) for x in (q, k, v))).reshape(
                got.shape), attention_tolerance(128, v))
            entry["flash_attention" + TAG[dtype] + any_suffix(d)] = 1
        q, k, v = (torch.randn((4, 128, 1), device=device).to(dtype) for _ in range(3))
        out = torch.full_like(q, 7.0)
        fn = ops._fn("flash_attention", "flash_attention" + SUFFIX[dtype], 4, 3, 1)
        rc = fn(*(t.data_ptr() for t in (q, k, v, out)), 4, 128, 0, 1.0, stream)
        torch.cuda.synchronize()
        assert rc == 1 and bool((out == 7.0).all()), (dtype, rc)
    log(f"[kernels] flash_attention at head dims {sorted({96, *ANY_TIMED})}: one launch a call, counted "
        f"under flash_attention{{,.bf16,.f16}}.dany, within the check; flash_attention_f32, _bf16 and "
        f"_f16 return cudaErrorInvalidValue at head dim 0 with their output untouched")
    return entry


def check_attention_offset_views(device, dtype: torch.dtype) -> None:
    """q, k and v as contiguous views one element into a buffer
    (``buf[1:].view(B*H, S, D)``: a 4- or 2-byte storage offset) give the
    aligned call's output bitwise at each head dim: the wrapper copies them
    to aligned buffers, and the kernel runs on those (one launch a call)."""
    for d in HEAD_DIMS:
        gen = torch.Generator(device=device).manual_seed(9 + d)
        q, k, v = (torch.randn((12, 256, d), generator=gen, device=device).to(dtype) for _ in range(3))
        views = [at_offset(x, 1) for x in (q, k, v)]
        assert all(x.data_ptr() % 16 for x in views), [x.data_ptr() % 16 for x in views]
        ops.reset_launches()
        got, want = ops.flash_attention(*views), ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        name = "flash_attention" + TAG[dtype] + ops.flash_instance(d)
        assert ops.LAUNCHES[name] == 2 and sum(ops.LAUNCHES.values()) == 2, ops.LAUNCHES
        assert torch.equal(got, want), ("offset views", dtype, d)
    log(f"[kernels{TAG[dtype].replace('.', ' ')}] flash_attention on q, k, v at a "
        f"{torch.finfo(dtype).bits // 8}-byte storage offset == the aligned call bitwise at D {HEAD_DIMS}")


def check_attention_causal(device, dtype: torch.dtype) -> None:
    """Causality, bitwise, at each head dim: k and v from position 700 on
    must not reach rows 0..699; and (B, H, S, D) is (B*H, S, D) bitwise."""
    for d in HEAD_DIMS:
        gen = torch.Generator(device=device).manual_seed(5 + d)
        q, k, v = (torch.randn((2, 12, 1024, d), generator=gen, device=device).to(dtype)
                   for _ in range(3))
        base = ops.flash_attention(q, k, v)
        k2, v2 = k.clone(), v.clone()
        k2[:, :, 700:] = 99.0
        v2[:, :, 700:] = -99.0
        pert = ops.flash_attention(q, k2, v2)
        folded = ops.flash_attention(*(x.reshape(24, 1024, d) for x in (q, k, v)))
        torch.cuda.synchronize()
        assert torch.equal(base[:, :, :700], pert[:, :, :700]), ("not causal", dtype, d)
        assert not torch.equal(base[:, :, 700:], pert[:, :, 700:])
        assert torch.equal(folded.reshape(base.shape), base), ("folded heads", dtype, d)
    log(f"[kernels{TAG[dtype].replace('.', ' ')}] flash_attention causal bitwise at D {HEAD_DIMS} "
        f"(rows before 700 unchanged when k, v change from 700 on), (B, H, S, D) == (B*H, S, D) "
        f"bitwise")


def check_16bit_kernels(device, dtype: torch.dtype):
    """Each kernel's bf16 or fp16 entry point against its plain version on
    inputs of that dtype: the wire scatter, the top-k masks and the dense
    aggregation ``torch.equal`` (fp32 sums rounded once, as their plain
    versions round them), the KL within its fp32 tolerance (fp32 math on
    exactly upcast inputs), the attention within its fp32 bound plus one ulp
    of the dtype, and causal bitwise."""
    check_scatter_16(device, dtype)
    check_topk_16(device, dtype)
    tag = TAG[dtype]
    for sparse in (True, False):
        stack = dense_stack([1024, 517, 1, VOCAB], seed=11, device=device, sparse=sparse).to(dtype)
        got, want = ops.sparse_aggregate(stack), ref.sparse_aggregate_ref(stack).to(dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want), ("sparse_aggregate" + tag, sparse)
    log(f"[kernels {tag[1:]}] dense aggregation torch.equal to its plain version (fp32 result "
        f"rounded to {dtype}), top-k-sparse and dense stacks")
    check_kl_16(device, dtype)
    check_attention_16(device, dtype)


def check_bf16_kernels(device):
    check_16bit_kernels(device, BF16)


def check_f16_kernels(device):
    """The fp16 entry points as ``check_bf16_kernels`` holds the bf16 ones,
    on inputs in fp16's range (its order-sensitive wire column, its
    subnormals, values near 65 504 and sums past it, which round to inf)."""
    check_16bit_kernels(device, F16)


ORDER_COL = 777  # takes 1e8, 1, -1e8, 1 from clients 0-3: 1 summed in order, 0 in reverse
# the order-sensitive column's values in each dtype, and its sum in order
# (in reverse it is 0): fp16's range holds no 1e8, but 2^-14 vanishes beside
# 32 768 in fp32 as 1 does beside 1e8
ORDER_VALUES = {BF16: ((1e8, 1.0, -1e8, 1.0), 1.0),
                F16: ((32768.0, 2.0**-14, -32768.0, 2.0**-14), 2.0**-14)}


def at_offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of ``x`` as a contiguous view ``offset`` elements into a
    buffer: another 16-byte phase than a fresh tensor's."""
    view = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)[offset:].view(x.shape)
    return view.copy_(x)


def edge_wire(n: int, rows: int, k: int, vocab: int, seed: int, device, dtype: torch.dtype = BF16):
    """A bf16 or fp16 wire of ``n`` clients with distinct indices per
    (client, row), drawn from a seed: values of N(0, 9) (b = |a|), client 1
    padding its last entry at index 0 with zeros, and, for n >= 4 and V >
    777, the order-sensitive column first in clients 0-3 (in fp16 its b
    sums past 65 504: inf)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    score = torch.rand((n, rows, vocab), generator=gen, device=device)
    order = n >= 4 and vocab > ORDER_COL
    if order:  # first in clients 0-3's top-k, in no other client's
        score[:4, :, ORDER_COL], score[4:, :, ORDER_COL] = 2.0, -1.0
    idx = torch.topk(score, k, dim=-1).indices.to(torch.int32)
    a = 3.0 * torch.randn((n, rows, k), generator=gen, device=device)
    if order:
        a[:4, :, 0] = torch.tensor(ORDER_VALUES[dtype][0], device=device)[:, None]
    if n > 1 and k > 1:
        idx[1, :, -1], a[1, :, -1] = 0, 0.0
    a = a.to(dtype)
    del score
    return a, a.abs(), idx.contiguous()


def check_scatter_16(device, dtype: torch.dtype):
    """The 16-bit wire scatter ``torch.equal`` to its plain version (fp32
    sums rounded to the dtype once) on the main path's wires, and on wires
    at its edges: 1 and 200 rows, N 1 and 8, k 1, 1000 and 3000, V 5, 37
    and 152 064, the order-sensitive column, and a, b and idx as views at an
    offset (another 16-byte phase: the bulk copies' head and tail granules)."""
    tag = TAG[dtype]
    for k_cap, rows, vocab in ((128, ROWS, VOCAB), (1024, ROWS, VOCAB), (1024, WIDE_ROWS, WIDE_VOCAB)):
        wire = make_wire(k_cap, seed=k_cap, device=device, rows=rows, vocab=vocab, dtype=dtype)
        for mode in MODES:
            a, b = float_channels(wire, mode)
            got = ops.scatter_wire_sums(a, b, wire.indices, vocab)
            want = [x.to(dtype) for x in ref.scatter_wire_sums_ref(a, b, wire.indices, vocab)]
            torch.cuda.synchronize()
            assert got[0].dtype == dtype and all(torch.equal(g, w) for g, w in zip(got, want)), (
                "scatter_wire_sums" + tag, k_cap, mode)
    log(f"[kernels {tag[1:]}] wire scatter torch.equal to its plain version (fp32 sums rounded to "
        f"{dtype}) in all 3 modes, k_cap 128 and 1024, V 50 257 and 152 064")
    cases = ((1, 1, 1, VOCAB, (0, 0, 0)), (8, 200, 1000, VOCAB, (3, 5, 1)), (4, ROWS, 1024, VOCAB, (1, 7, 3)),
             (8, 3, 3, VOCAB, (0, 1, 2)), (2, 5, 3000, VOCAB, (3, 1, 3)), (4, 1, 1000, WIDE_VOCAB, (5, 0, 1)),
             (8, 3, 37, 37, (2, 0, 1)),
             (2, 2, 5, 5, (1, 1, 1)))
    for n, rows, k, vocab, offsets in cases:
        a, b, idx = edge_wire(n, rows, k, vocab, seed=n * rows + k, device=device, dtype=dtype)
        want = [x.to(dtype) for x in ref.scatter_wire_sums_ref(a, b, idx, vocab)]
        for placed in ((a, b, idx), tuple(at_offset(x, o) for x, o in zip((a, b, idx), offsets))):
            got = ops.scatter_wire_sums(*placed, vocab)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), ("scatter_wire_sums" + tag, n, rows,
                                                                       k, vocab, placed[0].data_ptr() % 16)
        if n >= 4 and vocab > ORDER_COL:  # the clients were summed in order
            assert bool((want[0][:, ORDER_COL] == ORDER_VALUES[dtype][1]).all())
            if dtype == F16:  # b's sum past 65 504 rounds to inf, as the plain version's cast
                assert bool(torch.isinf(want[1][:, ORDER_COL]).all())
    values, total = ORDER_VALUES[dtype]
    log(f"[kernels {tag[1:]}] wire scatter torch.equal to its plain version at (N, rows, k, V) "
        f"{[c[:4] for c in cases]}, each also with a, b, idx at offsets {[c[4] for c in cases]} "
        f"elements; the column taking {values} from clients 0-3 sums to {total}"
        + ("; its b, past 65 504, to inf" if dtype == F16 else ""))


def kl_logits(rows: int, vocab: int, seed: int, device, floor: float = -1e30):
    """Teacher and student logits of N(0, 2) with the edge cases in the first
    rows: row 0 the teacher equal to its student, row 1 logits of +-3e4 (the
    online rescale), row 2 ``floor`` on both sides every third entry, row 3
    ``floor`` on the teacher only every fourth entry (-1e30, or -6e4 for
    fp16, where -1e30 is -inf and the KL of such a row NaN)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = 2.0 * torch.randn((rows, vocab), generator=gen, device=device)
    s = 2.0 * torch.randn((rows, vocab), generator=gen, device=device)
    s[0] = t[0]
    t[1] = torch.rand(vocab, generator=gen, device=device) * 6e4 - 3e4
    s[1] = t[1] + torch.randn(vocab, generator=gen, device=device)
    t[2, ::3] = floor
    s[2, ::3] = floor
    t[3, 1::4] = floor
    return t, s


def check_kl_16(device, dtype: torch.dtype):
    """The 16-bit KL within its fp32 tolerance of its plain version, exactly
    0 for teacher == student; in fp16 also NaN wherever the plain version is
    NaN (a row holding +inf: exp(inf - inf))."""
    tag = TAG[dtype]
    floor = -6e4 if dtype == F16 else -1e30
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for rows, vocab in ((ROWS, VOCAB), (32, VOCAB), (WIDE_ROWS, WIDE_VOCAB), (2 * sms + 56, VOCAB),
                        (WIDE_ROWS, 37), (WIDE_ROWS, 5), (1, VOCAB), (200, VOCAB)):
        t, s = kl_logits(max(rows, 5), vocab, seed=vocab + 1, device=device, floor=floor)
        # row 4: the teacher's and the student's maxima in the last CTA's slice of the row
        t[4, vocab - min(9, vocab)], s[4, vocab - min(20, vocab)] = 40.0, 30.0
        t, s = t[:rows].to(dtype), s[:rows].to(dtype)
        s_off = torch.empty(rows * vocab + 1, dtype=dtype, device=device)[1:].view(rows, vocab)
        s_off.copy_(s)  # another 16-byte phase than the teacher's
        worst = 0.0
        for temp in (1.0, 2.0, 4.0):
            want = ref.distill_kl_ref(t, s, temp)
            tol = kl_tolerance(t, s, temp, want)
            for student in (s, s_off):
                got = ops.distill_kl_rows(t, student, temp)
                torch.cuda.synchronize()
                err = (got - want).abs()
                assert bool((err <= tol).all()), ("distill_kl" + tag, rows, vocab, temp, float(err.max()))
                assert float(got[0]) == 0.0, got[:4]
                worst = max(worst, float(err.max()))
        c = max(c for c in (1, 2, 4, 8) if c == 1 or rows * c <= sms)
        log(f"[kernels {tag[1:]}] distill_kl at ({rows}, {vocab}) (C = {c}), T in (1, 2, 4): within "
            f"rtol 1e-5 + 2e-6 (1 + |lse_t| + |lse_s|) per row (max |diff| {worst:.3e}), exactly 0 for "
            f"teacher == student, maxima in the last CTA's slice, student on another 16-byte phase")
    if dtype == F16:  # +inf in the teacher (row 0) or the student (row 1): NaN, as the plain version
        t, s = kl_logits(4, VOCAB, seed=3, device=device, floor=floor)
        t[0, 100], s[1, 20000] = float("inf"), float("inf")
        t, s = t.to(dtype), s.to(dtype)
        got, want = ops.distill_kl_rows(t, s, 2.0), ref.distill_kl_ref(t, s, 2.0)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(want[:2]).all()), (
            got, want)
        log(f"[kernels {tag[1:]}] distill_kl NaN where its plain version is NaN: rows holding +inf "
            f"{got.tolist()}")


F16_EDGE_ROWS = BF16_ONE_BIN_ROW + 1  # the first of four rows at fp16's range edges


def f16_edge_rows(x: torch.Tensor, ks: torch.Tensor, gen) -> None:
    """Rows 17-20 of a top-k input (in place), at fp16's range edges: fp16
    subnormals (2^-24 .. 2^-14, normal in fp32) with +-0 beside them; values
    within 64 ulps of 65 504 of both signs (a static k = 0 replays every step
    to lo just under max + 1 = 65 505, which rounds up to +inf: nothing kept,
    as in the plain version); that row's magnitudes with 9 +inf entries
    (there every step's mid is +inf and only the +inf values stay); and
    subnormals of both signs, whose k-th value is negative."""
    vocab = x.shape[1]
    sub = torch.randint(0, 1024, (vocab,), generator=gen, device=x.device).float() * 2.0**-24
    x[F16_EDGE_ROWS] = sub
    x[F16_EDGE_ROWS, :40] = 0.0
    x[F16_EDGE_ROWS, 40:80] = -0.0
    big = 65504.0 - 32.0 * torch.randint(0, 64, (vocab,), generator=gen, device=x.device).float()
    sign = torch.where(torch.rand(vocab, generator=gen, device=x.device) < 0.5, -1.0, 1.0)
    x[F16_EDGE_ROWS + 1] = big * sign
    x[F16_EDGE_ROWS + 2] = big
    x[F16_EDGE_ROWS + 2, 11:20] = float("inf")
    x[F16_EDGE_ROWS + 3] = -sub
    x[F16_EDGE_ROWS + 3, : vocab // 2] *= -1.0
    ks[F16_EDGE_ROWS:F16_EDGE_ROWS + 4] = torch.tensor([3000, 700, 12, vocab // 2 + 5], dtype=torch.int32)


def one_bin_row(x: torch.Tensor, ks: torch.Tensor, gen, dtype: torch.dtype) -> None:
    """The one-bin row of a top-k input for ``dtype``: bf16's
    (``bf16_one_bin_row``) or fp16's, every value in [1, 1 + 2^-5), whose
    keys share sign, exponent and their top 5 mantissa bits, the high digit
    of fp16's radix select (32 values, ~1 570 tied at each)."""
    if dtype == BF16:
        bf16_one_bin_row(x, ks, gen)
        return
    level = torch.randint(0, 32, (x.shape[1],), generator=gen, device=x.device)
    x[BF16_ONE_BIN_ROW] = 1.0 + level / 1024.0
    ks[BF16_ONE_BIN_ROW] = 3000


def check_topk_16(device, dtype: torch.dtype):
    """The 16-bit top-k masks ``torch.equal`` to their plain versions at
    both widths: the edge rows of ``topk_rows`` rounded to the dtype (NaN,
    +-inf, near 3e38 -- inf in fp16 --, constant), tie groups of ~50 to
    ~17 000 values at the k-th value, and a row whose values all share one
    bin of the radix select's high digit; in fp16 also subnormals, +-0 and
    values near +-65 504 (``f16_edge_rows``); per-row and static k."""
    tag = TAG[dtype]
    for rows, vocab in ((N_CLIENTS * ROWS, VOCAB), (3 * WIDE_ROWS, WIDE_VOCAB)):
        x, ks = topk_rows(rows, vocab, seed=vocab + 1, device=device)
        gen = torch.Generator(device=device).manual_seed(vocab)
        bf16_tie_rows(x, ks, gen)
        one_bin_row(x, ks, gen, dtype)
        if dtype == F16:
            f16_edge_rows(x, ks, gen)
        x = x.to(dtype)  # the normal rows rounded: ties of a few values a step at X_k
        got = ops.topk_mask_dynamic(x, ks)
        want = ref.topk_mask_ref(x, torch.clamp(ks, 0, vocab), guard=True)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want), ("topk_mask_dynamic" + tag, rows, vocab)
        kept = (want != 0).sum(dim=1).tolist()
        assert kept[8] == 0 and kept[9] == vocab, kept[:12]  # a NaN row keeps nothing
        xf = x.float()
        ties = [int((xf[r] == torch.topk(xf[r], int(ks[r])).values[-1]).sum())
                for r in range(TOPK_EDGE_ROWS, BF16_ONE_BIN_ROW + 1)]
        assert min(ties) > 32 and max(ties) > 8192, ties  # past the warp and the buffer
        one_bin = xf[BF16_ONE_BIN_ROW]
        assert bool(((one_bin >= 1.0) & (one_bin < (2.0 if dtype == BF16 else 1.0 + 2.0**-5))).all())
        edges = ""
        if dtype == F16:
            sub = xf[F16_EDGE_ROWS]
            assert bool((sub[80:] < 2.0**-14).all()) and bool((sub[80:] > 0).any())
            assert bool((xf[F16_EDGE_ROWS + 1].abs() >= 65504.0 - 32 * 63).all())
            edges = (f", fp16 subnormals with +-0 (kept {kept[F16_EDGE_ROWS]}), values near +-65 504, "
                     f"with +-inf, subnormals of both signs (kept {kept[F16_EDGE_ROWS + 3]})")
        for k in (0, 1, 517, vocab, vocab + 5):
            got = ops.topk_mask(x, k)
            want = ref.topk_mask_ref(x, torch.full((rows,), min(k, vocab), dtype=torch.int32,
                                                   device=device), guard=False)
            torch.cuda.synchronize()
            assert torch.equal(got, want), ("topk_mask" + tag, rows, vocab, k)
            if dtype == F16 and k == 0:  # lo above 65 504 rounds up to +inf: only +inf kept
                near = (want[F16_EDGE_ROWS + 1:F16_EDGE_ROWS + 3] != 0).sum(dim=1).tolist()
                assert near == [0, 9], near
        path = "shared-memory" if vocab <= ops.smem_max_vocab(device.index or 0, dtype) else "global-memory"
        log(f"[kernels {tag[1:]}] rows={rows} V={vocab} ({path} path): top-k masks torch.equal to their "
            f"plain versions on {dtype}-rounded rows (NaN, +-inf, near 3e38, constant), tie groups of "
            f"{ties[:4]} values at the k-th value and a one-bin row ({ties[4]} tied){edges}, "
            f"per-row and static k")


def kstep_scores(qf: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """Q K^T (``kt``: K transposed) in the 16-bit kernels' order over D:
    fp32 sums of 16-wide k-steps, in order (the wgmma or mma.sync chain;
    the last one narrower where D is not a multiple of 16, the any-D
    kernel's zero-padded step)."""
    sc = torch.zeros(qf.shape[:-1] + kt.shape[-1:], device=qf.device)
    for c in range(0, qf.shape[-1], 16):
        sc = sc + qf[..., c:c + 16] @ kt[..., c:c + 16, :]
    return sc


def score_order_term(q, k, v) -> float:
    """The most that Q K^T summed in the kernel's k-step order can move the
    output from the plain version's: with every score within Delta of the
    plain one (measured here), each softmax weight moves by a factor within
    e^(+-2 Delta D^-0.5), so each output by at most (e^(2 Delta D^-0.5) - 1)
    max|v| (tests/test_torch_fp16_designs.py's term)."""
    qf, kt = q.float(), k.float().transpose(1, 2)
    delta = float((kstep_scores(qf, kt) - qf @ kt).abs().max())
    return math.expm1(2.0 * q.shape[-1] ** -0.5 * delta) * float(v.float().abs().max())


def check_attention_16(device, dtype: torch.dtype):
    """The 16-bit attention within S * 2^-24 * max|v| plus one ulp of the
    dtype of its plain version (both round once from fp32), with q, k x4,
    one key tile, a tile past the end and late maxima, at each head dim;
    with q, k x12 within that plus ``score_order_term`` (the scores'
    rounding in the kernel's order, which the other cases' bound has no
    term for; 16-bit SDPA, P in one piece, is printed against that bound
    too); causal bitwise, heads folded bitwise, offset views bitwise."""
    tag = TAG[dtype]
    cases = ((96, 1024, "q, k ~ N(0, 1)"), (20, 128, "q, k ~ N(0, 1)"), (20, 64, "one key tile"),
             (12, 96, "a tile past the end"), (24, 1024, "q, k x4"), (8, 1024, "late maxima"),
             (24, 1024, "q, k x12"))
    for (bh, seq, what), d in itertools.product(cases, HEAD_DIMS):
        gen = torch.Generator(device=device).manual_seed(seq + d + 1)
        q, k, v = (torch.randn((bh, seq, d), generator=gen, device=device) for _ in range(3))
        if what.startswith("q, k x"):
            scale = float(what.removeprefix("q, k x"))
            q, k = scale * q, scale * k
        if what == "late maxima":  # row 1000's largest score at key 900, key tile 14 of 16
            k[:, 900] = late_key(q[:, 1000], d)
        q, k, v = (z.to(dtype) for z in (q, k, v))
        got, want = ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        term = score_order_term(q, k, v) if what == "q, k x12" else 0.0
        err = within_16(got, want, attention_tolerance(seq, v) + term)
        if what == "late maxima":
            assert float((got[:, 1000].float() - v[:, 900].float()).abs().max()) < 0.05 * float(
                v.float().abs().max())
        extra = f" + the scores' order term {term:.3e}" if term else ""
        if term:  # does this bound tell P in one piece (as SDPA rounds it) from two?
            one = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
            gap = (one.float() - want.float()).abs()
            inside = bool((gap <= attention_tolerance(seq, v) + term + ulp16(dtype, one, want)).all())
            extra += (f"; {tag[1:]} SDPA (P in one piece) max |diff| {float(gap.max()):.3e}, "
                      f"{'within' if inside else 'outside'} the same bound")
        log(f"[kernels {tag[1:]}] flash_attention at ({bh}, {seq}, {d}), {what}: max |diff| {err:.3e} "
            f"against its plain version (bound S * 2^-24 * max|v| + one {tag[1:]} ulp{extra})")
    check_attention_causal(device, dtype)
    check_attention_offset_views(device, dtype)


def _drive(client_cfg, server_cfg, dataset, fed, device, patches=None, **run_kw):
    """run_federated, also returning the engine (built through
    ``make_engine``, whatever its kind) and the Server it built.
    ``patches``: ``{(owner, name): wrap}``, each ``owner.name`` replaced by
    ``wrap(original)`` for the run (a module, or a class for a method);
    ``run_kw``: ``ckpt_dir``, ``resume``."""
    built, saved = {}, {}
    for name in ("make_engine", "Server"):
        saved[(fed_rounds, name)] = make = getattr(fed_rounds, name)

        def capture(*args, _make=make, _name=name, **kwargs):
            built[_name] = _make(*args, **kwargs)
            return built[_name]

        setattr(fed_rounds, name, capture)
    for (owner, name), wrap in (patches or {}).items():
        saved.setdefault((owner, name), getattr(owner, name))
        setattr(owner, name, wrap(getattr(owner, name)))
    try:
        run = fed_rounds.run_federated(client_cfg, server_cfg, dataset, fed, device=device,
                                       **run_kw)
    finally:
        for (owner, name), orig in saved.items():
            setattr(owner, name, orig)
    return run, built["make_engine"], built["Server"]


def final_broadcast(engine, server, tokens: torch.Tensor) -> torch.Tensor:
    """The broadcast logits after the last round: the e2e engine computed
    them in its round; a dense-uplink server answers on ``tokens``."""
    if getattr(engine, "handles_server", False):
        return engine._b_logits
    return server.broadcast(tokens.to(server.params["embed"].device))[0]


def small_configs():
    """The tiny client and server configs of the CPU tests, and their data."""
    lora = LoRAConfig(rank=4, alpha=32.0, dropout=0.0, targets=("q", "v", "head"))
    client = REDUCED_CLIENT.with_overrides(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
                                           d_ff=128, vocab_size=256, max_seq_len=32, lora=lora)
    server = REDUCED_SERVER.with_overrides(num_layers=2, d_model=96, num_heads=2, num_kv_heads=2,
                                           d_ff=192, vocab_size=256, max_seq_len=32, lora=lora)
    return client, server, make_banking77_like(vocab_size=256, seq_len=12, total=500, seed=0)


def phase_small_input(device):
    client, server, ds = small_configs()
    tokens = torch.as_tensor(ds.tokens[:16])
    for engine in ("fused_e2e", "fused"):
        for quant in (False, True):
            fed = FedConfig(method="adald", engine=engine, use_kernels=True, pretrain_steps=0,
                            num_clients=4, clients_per_round=2, rounds=2, public_size=64,
                            public_batch=16, eval_size=64, local_steps=2, distill_steps=1,
                            server_distill_steps=2, quantize_wire=quant,
                            channel=ChannelConfig(bandwidth_hz=2e5, mean_snr_db=2.0))
            ops.reset_launches()
            gpu, gpu_eng, gpu_srv = _drive(client, server, ds, fed, device)
            assert sum(ops.LAUNCHES.values()) > 0, ops.LAUNCHES  # the card ran the kernels
            cpu, cpu_eng, cpu_srv = _drive(client, server, ds, fed, "cpu")
            assert gpu.per_client_k == cpu.per_client_k
            for key in ("uplink_bytes", "downlink_bytes", "num_transmitters"):
                assert [getattr(r, key) for r in gpu.ledger.rounds] == [getattr(r, key) for r in cpu.ledger.rounds]
            np.testing.assert_allclose(gpu.server_acc, cpu.server_acc, rtol=0, atol=1 / 64 + 1e-9)
            np.testing.assert_allclose(gpu.client_acc, cpu.client_acc, rtol=0, atol=1 / 64 + 1e-9)
            np.testing.assert_allclose(gpu.distill_loss, cpu.distill_loss, rtol=1e-3, equal_nan=True)
            assert math.isnan(gpu.distill_loss[-1]) == (engine != "fused_e2e")
            g_b = final_broadcast(gpu_eng, gpu_srv, tokens).cpu().numpy()
            c_b = final_broadcast(cpu_eng, cpu_srv, tokens).numpy()
            err = float(np.abs(g_b - c_b).max() / np.abs(c_b).max())
            assert err < (1 / 127 if quant else 1e-3), err
            log(f"[small input] {engine} {'int8' if quant else 'float'} uplink: card == CPU on k and "
                f"bytes, broadcast max |diff|/max|logit| = {err:.2e}, "
                f"distill_loss {gpu.distill_loss} vs {cpu.distill_loss}")


def capture_topk(captured: dict):
    """A wrapper for ``ops.topk_mask_dynamic`` that keeps a copy of its
    input, the fused client phase's logits and budgets (the last call's)."""
    def wrap(topk):
        def capture(logits, ks):
            captured["x"], captured["ks"] = logits.clone(), ks.clone()
            return topk(logits, ks)

        return capture

    return wrap


def capture_sums(captured: list):
    """A wrapper for ``ops.scatter_wire_sums`` that keeps each call's
    ``(num, den)``: the wire aggregate's two channels."""
    def wrap(sums):
        def capture(*args, **kwargs):
            captured.append(sums(*args, **kwargs))
            return captured[-1]

        return capture

    return wrap


def check_f16_wire_teacher(sums: list) -> int:
    """The fp16 ``fused_e2e`` round's teacher is the reference's: ``num /
    (den + 1e-12)`` in fp16, where 1e-12 rounds to 0, so every column no
    client sent is 0 / 0 = NaN (``src/repro/core/aggregation.py:259``
    gives the same) and, in round 0 (whose clients distil on no broadcast),
    every other column is finite; from round 1 the clients distil on the
    NaN broadcast.  Returns round 0's NaN columns."""
    num, den = sums[0]
    teacher = num / (den + 1e-12)
    empty = (den == 0) & (num == 0)
    assert teacher.dtype == F16 and torch.equal(torch.isnan(teacher), empty)
    assert bool(torch.isfinite(teacher[~empty]).all()) and bool(torch.isfinite(num).all())
    assert all(bool(torch.isnan(n / (d + 1e-12)).any()) for n, d in sums[1:])
    return int(empty.sum())


def main_fed(engine: str, quantize: bool, low: torch.dtype | None = None, **change) -> FedConfig:
    """The main path's FedConfig: GPT-2 small clients x8, cohort 4, 2 rounds
    (the round body in ``low``, bf16 or fp16, when given)."""
    return FedConfig(**{**dict(method="adald", engine=engine, use_kernels=True, pretrain_steps=0,
                               num_clients=8, clients_per_round=4, rounds=2, public_batch=64,
                               local_steps=2, distill_steps=1, server_distill_steps=2,
                               eval_size=128, quantize_wire=quantize),
                        **(LOW_CFG[low] if low else {}), **change})


def phase_main_path(device, engine: str, quantize: bool, low: torch.dtype | None = None) -> dict:
    """One main-path run; returns its launch counts, its per-client k and,
    for ``fused``, the launch counts of the static top-k's public entry
    point driven on its own after the run (and of the KL's, in bf16 and
    fp16); for the fp32 ``fused_e2e`` float-wire run also its record, round
    times, peak memory and trained state on the host (what phase 5d holds
    the host store to).  ``low`` (bf16 or fp16): the models compute in it
    (``ModelConfig.compute_dtype``) and so does the round body
    (``FedConfig.compute_dtype``)."""
    fed = main_fed(engine, quantize, low)
    client_cfg, server_cfg = GPT2_SMALL, GPT2_LARGE
    if low:
        client_cfg, server_cfg = (c.with_overrides(**LOW_CFG[low]) for c in (GPT2_SMALL, GPT2_LARGE))
    dt = TAG[low] if low else ""
    ds = make_banking77_like(vocab_size=GPT2_SMALL.vocab_size, seq_len=32)
    tokens = torch.as_tensor(ds.tokens[: fed.public_batch], device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    captured, sums = {}, []
    patches = ({(ops, "topk_mask_dynamic"): capture_topk(captured)}
               if engine == "fused" and not quantize else None)
    # fp16 wire aggregates hold NaN where no client sent, as the reference's (check_f16_wire_teacher)
    nan_teacher = low == F16 and engine == "fused_e2e" and not quantize
    if nan_teacher:
        patches = {(ops, "scatter_wire_sums"): capture_sums(sums)}
    ops.reset_launches()  # this path's launches only, from here
    run, eng, srv = _drive(client_cfg, server_cfg, ds, fed, device, patches)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    wall = time.perf_counter() - t0
    tag = f"{engine}/{'int8' if quantize else 'float'}{'/' + dt[1:] if low else ''}"
    log(f"[main path {tag}] GPT-2 small clients x{fed.num_clients} (cohort {fed.clients_per_round}), "
        f"GPT-2 large server, {fed.rounds} rounds in {wall:.1f} s (setup included)")
    log(f"[main path {tag}] per_client_k={run.per_client_k}")
    log(f"[main path {tag}] uplink_bytes={[r.uplink_bytes for r in run.ledger.rounds]} "
        f"downlink_bytes={[r.downlink_bytes for r in run.ledger.rounds]}")
    log(f"[main path {tag}] server_acc={run.server_acc} client_acc={run.client_acc} "
        f"distill_loss={run.distill_loss}")
    log(f"[main path {tag}] round_seconds={[round(s, 3) for s in run.round_seconds]} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[main path {tag}] kernel launches {launches}")
    if engine == "sequential":
        log(f"[main path {tag}] KL kernel launches on the path: {launches['distill_kl']} (no engine "
            f"sets use_kernel, as in the reference)")

    rounds, tx_rounds = fed.rounds, sum(1 for r in run.ledger.rounds if r.num_transmitters > 0)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    if engine == "fused_e2e":
        want["scatter_wire_sums_dequant" if quantize else "scatter_wire_sums" + dt] = rounds
    else:
        want["sparse_aggregate" + dt] = tx_rounds
        want["topk_mask_dynamic" + dt] = rounds if engine == "fused" else 0
    assert launches == want, (tag, launches, want)
    b = final_broadcast(eng, srv, tokens)
    assert tuple(b.shape) == (fed.public_batch, GPT2_LARGE.vocab_size)
    assert b.dtype == (low or torch.float32), b.dtype
    if nan_teacher:  # the server distils on the NaN columns: its loss and broadcast are NaN too
        empty = check_f16_wire_teacher(sums)
        assert len(sums) == rounds and all(math.isnan(x) for x in run.distill_loss), run.distill_loss
        log(f"[main path {tag}] the wire aggregate num / (den + 1e-12) in fp16 is NaN exactly at the "
            f"{empty} of {sums[0][0].numel()} columns no client sent in round 0 (1e-12 is 0 in fp16), "
            f"finite elsewhere, as the reference's aggregate_wire gives it; the server distils on it: "
            f"distill_loss {run.distill_loss}, broadcast NaN {int(torch.isnan(b).sum())} of {b.numel()}")
    else:
        assert bool(torch.isfinite(b).all())
    # the LoRA masters and the Adam moments stay fp32, whatever the round's dtype
    if engine == "sequential":  # the clients keep their own state
        states = [t for c in eng.clients for t in (split_lora(c.params)[0], c.opt.m, c.opt.v)]
    else:
        states = [eng._store.lora, eng._store.opt.m, eng._store.opt.v]
    states += ([eng._s_lora, eng._s_opt.m, eng._s_opt.v] if engine == "fused_e2e"
               else [split_lora(srv.params)[0], srv.opt.m, srv.opt.v])
    assert all(v.dtype == torch.float32 for tree in states for v in tree.values())
    assert all(math.isfinite(x) for x in run.server_acc + run.client_acc)
    if engine == "fused_e2e" and not nan_teacher:  # NaN off the e2e path, by the reference's definition
        assert all(math.isfinite(x) for x in run.distill_loss)
    assert all(k > 0 for ks in run.per_client_k for k in ks)  # default channel: everyone transmits
    peak = torch.cuda.max_memory_allocated()
    out = {"launches": launches, "per_client_k": run.per_client_k, "entry_launches": {},
           "bytes": [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters) for r in run.ledger.rounds]}
    if not low and (engine, quantize) in SHARD_RUNS:  # what phases 5d and 5e hold to it
        out.update(record=main_record(run), round_seconds=list(run.round_seconds), peak=peak,
                   trained=trained_state(eng, None if engine == "fused_e2e" else srv))
    if captured:
        x, ks = captured["x"], captured["ks"]
        out["topk_input"] = (x.reshape(-1, x.shape[-1]), ks.reshape(-1))
    if engine == "sequential":
        out["entry_launches"] = kl_entry(eng, srv, tokens, fed.temperature, client_cfg)
    if engine == "fused":
        # the static top-k's public entry point, on what the server broadcast
        k = max(max(ks) for ks in run.per_client_k)
        ops.reset_launches()
        kept = topk_mask_dense(b.contiguous(), k, use_kernel=True)
        torch.cuda.synchronize()
        out["entry_launches"] = dict(ops.LAUNCHES)
        assert ops.LAUNCHES["topk_mask" + dt] == 1 and sum(ops.LAUNCHES.values()) == 1, ops.LAUNCHES
        # the k-th value from torch.topk: every value at or above it kept, ties included
        kth = torch.topk(b.float(), k, dim=-1).values[:, -1:]
        assert torch.equal(kept, torch.where(b.float() >= kth, b, torch.zeros_like(b)))
        log(f"[entry {tag}] topk_mask_dense(use_kernel=True) on the final broadcast at k={k}: "
            f"kernel launches {ops.LAUNCHES}")
        if low:  # the KL's public entry point on the 16-bit run's logits
            kl = kl_entry(eng, srv, tokens, fed.temperature, client_cfg)
            out["entry_launches"] = {**out["entry_launches"], "distill_kl" + dt: kl["distill_kl" + dt]}
    del run, eng, srv, b
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- the pretrained main path -------------------------------------------------

# The reference's default pretraining (FedConfig's defaults, spelled out)
# on the main path's fleet, 3 rounds.
PRETRAINED_FED = dict(method="adald", use_kernels=True, num_clients=8, clients_per_round=4,
                      rounds=3, public_batch=64, local_steps=2, distill_steps=1,
                      server_distill_steps=2, eval_size=128, pretrain_steps=80,
                      server_pretrain="lm", server_pretrain_steps=60, pretrain_frac=0.12,
                      pretrain_lr=2e-3)
LOSS_EVERY = 20  # pretraining steps between the printed losses


def recording_steps(losses: list):
    """A wrapper for a pretraining step factory whose steps append their
    loss (a device tensor: nothing waits for the card) and a CUDA event
    recorded at their end to ``losses``."""
    def wrap(make):
        def factory(*args, **kwargs):
            step = make(*args, **kwargs)

            def recorded(params, opt, batch):
                params, opt, metrics = step(params, opt, batch)
                done = torch.cuda.Event(enable_timing=True)
                done.record()
                losses.append((metrics["loss"], done))
                return params, opt, metrics

            return recorded

        return factory

    return wrap


def timed(into: list):
    """A wrapper that appends each call's seconds, from a synchronised card
    to a synchronised card, to ``into``."""
    def wrap(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out

        return call

    return wrap


TRACE_ACTIVITIES = [torch.profiler.ProfilerActivity.CUDA]  # the card's work and the CUDA API


def warm_profiler() -> None:
    """Start and stop the tracer once, so that its set-up (seconds on the
    first start) falls outside the traced windows."""
    with torch.profiler.profile(activities=TRACE_ACTIVITIES):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def trace_summary(prof, label: str, untraced_s: float) -> dict:
    """The device's busy share of a traced window: the union of the
    intervals of its device work (kernels, copies, fills) over the window,
    from the first recorded event's start (a CUDA API call on the host) to
    the last one's end; beside it, the same busy time over ``untraced_s``,
    the same work's wall time in a run without the tracer, whose per-call
    cost stretches the host's side.  Also the count of kernels and the five
    longest idle gaps, each with the host's CUDA call that spans most of
    it (or the work that follows it)."""
    events = [e for e in prof.profiler.kineto_results.events() if not e.is_user_annotation()]
    dev = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                 if e.device_type() == torch.autograd.DeviceType.CUDA)
    host = [(e.start_ns(), e.end_ns(), e.name()) for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA]
    start = min(e.start_ns() for e in events)
    end = max(e.end_ns() for e in events)
    busy, gaps, cursor = 0, [], start
    for a, b, name in dev + [(end, end, "the window's end")]:
        if a > cursor:
            gaps.append((a - cursor, cursor, a, name))
        busy += max(0, b - max(a, cursor))
        cursor = max(cursor, b)
    longest = []
    for length, a, b, name in sorted(gaps, reverse=True)[:5]:
        spans = [(min(hb, b) - max(ha, a), hn) for ha, hb, hn in host
                 if min(hb, b) - max(ha, a) > length / 2]
        longest.append((length / 1e3, f"host in {max(spans)[1]}" if spans else f"before {name}"))
    kernels = [d for d in dev if not d[2].startswith(("Memcpy", "Memset"))]
    out = {"window_ms": (end - start) / 1e6, "busy_ms": busy / 1e6,
           "busy_share": busy / max(end - start, 1), "busy_share_untraced": busy / 1e9 / untraced_s,
           "kernels": len(kernels), "copies_fills": len(dev) - len(kernels), "gaps_us": longest}
    log(f"[trace] {label}: window {out['window_ms']:.2f} ms, device busy {out['busy_ms']:.2f} ms "
        f"({100 * out['busy_share']:.1f} % of the window, {100 * out['busy_share_untraced']:.1f} % of "
        f"the untraced {untraced_s * 1e3:.1f} ms), {out['kernels']} kernels and "
        f"{out['copies_fills']} copies/fills; longest idle gaps (us): "
        + "; ".join(f"{g:.1f} {why[:70]}" for g, why in out["gaps_us"]))
    return out


def pretrained_run(device, engine: str, scan: bool, patches=None) -> tuple:
    """One run of the pretrained main path; returns the run, its engine and
    Server, its launch counts and its peak memory (GiB)."""
    fed = FedConfig(engine=engine, scan_rounds=scan, **PRETRAINED_FED)
    ds = make_banking77_like(vocab_size=GPT2_SMALL.vocab_size, seq_len=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launches()  # this path's launches only, from here
    run, eng, srv = _drive(GPT2_SMALL, GPT2_LARGE, ds, fed, device, patches)
    torch.cuda.synchronize()
    launches, peak = dict(ops.LAUNCHES), torch.cuda.max_memory_allocated() / 2**30
    tag = f"{engine}{'/scan' if scan else ''}"
    log(f"[pretrained {tag}] {fed.rounds} rounds in {time.perf_counter() - t0:.1f} s (setup and any "
        f"pretraining included), round_seconds={[round(x, 3) for x in run.round_seconds]}, "
        f"max_memory_allocated={peak:.2f} GiB")
    log(f"[pretrained {tag}] per_client_k={run.per_client_k}")
    log(f"[pretrained {tag}] uplink_bytes={[r.uplink_bytes for r in run.ledger.rounds]} "
        f"downlink_bytes={[r.downlink_bytes for r in run.ledger.rounds]} "
        f"transmitters={[r.num_transmitters for r in run.ledger.rounds]}")
    log(f"[pretrained {tag}] server_acc={run.server_acc} client_acc={run.client_acc} "
        f"distill_loss={run.distill_loss}; kernel launches {launches}")
    assert eng._store.shared, "the pretrained fleet does not share its backbone"
    assert all(math.isfinite(x) for x in run.server_acc + run.client_acc)
    tx_rounds = sum(1 for r in run.ledger.rounds if r.num_transmitters > 0)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    if engine == "fused_e2e":
        want["scatter_wire_sums"] = fed.rounds
        assert all(math.isfinite(x) for x in run.distill_loss)
    else:
        want["sparse_aggregate"], want["topk_mask_dynamic"] = tx_rounds, fed.rounds
    assert launches == want, (tag, launches, want)
    return run, eng, srv, launches, peak


def guarded_block(block: dict):
    """A wrapper for ``FusedE2EEngine.run_block`` that runs the block with
    every synchronising call an error and keeps its seconds in
    ``block["seconds"]``."""
    def wrap(run_block):
        def call(self, staged):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                taps = run_block(self, staged)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            block["seconds"] = time.perf_counter() - t0
            return taps

        return call

    return wrap


def phase_pretrained(device) -> dict:
    """The pretrained main path (see the module docstring, phase 5b);
    returns its launch counts and the top-k input of the ``fused`` run."""
    losses = {"pretrain_classifier": [], "pretrain_lm": []}
    seconds = {"pretrain_classifier": [], "pretrain_lm": []}
    pre, evals, traces, block = {}, {}, {}, {}

    def before_engine(make):  # the pretrained models, as the engine receives them
        def call(kind, clients, cfg, **kwargs):
            pre["client"], pre["server"] = dict(clients[0].params), dict(kwargs["server"].params)
            return make(kind, clients, cfg, **kwargs)

        return call

    def eval_split(make):  # the run's eval split, from the evaluator's first call
        def call(*args, **kwargs):
            evaluate = make(*args, **kwargs)

            def recorded(params, tokens, labels):
                evals.setdefault("split", (tokens, labels))
                return evaluate(params, tokens, labels)

            return recorded

        return call

    def profiled_round(run_round):  # the last round of the per-round run, traced
        calls = []

        def call(self, *args, **kwargs):
            calls.append(1)
            if len(calls) == PRETRAINED_FED["rounds"]:
                torch.cuda.synchronize()
                traces["prof"] = prof = torch.profiler.profile(activities=TRACE_ACTIVITIES)
                prof.start()
            return run_round(self, *args, **kwargs)

        return call

    patches = {(fed_rounds, "make_engine"): before_engine, (fed_rounds, "make_eval_fn"): eval_split,
               (FusedE2EEngine, "run_round"): profiled_round}
    for name in losses:
        patches[(fed_rounds, name)] = timed(seconds[name])
    patches[(fed_pretrain, "_supervised_step")] = recording_steps(losses["pretrain_classifier"])
    patches[(fed_pretrain, "make_train_step")] = recording_steps(losses["pretrain_lm"])
    fed_pretrain._CACHE.clear()
    warm_profiler()
    loop, loop_eng, _, loop_launches, loop_peak = pretrained_run(device, "fused_e2e", False, patches)
    torch.cuda.synchronize()
    traces["prof"].stop()
    traces["round"] = trace_summary(
        traces["prof"], "fused_e2e, one steady per-round round (the run's last: its round body, "
        "broadcast, server sync and two evals)", loop.round_seconds[1])
    for name, cfg, steps in (("pretrain_classifier", GPT2_SMALL, PRETRAINED_FED["pretrain_steps"]),
                             ("pretrain_lm", GPT2_LARGE, PRETRAINED_FED["server_pretrain_steps"])):
        vals = [float(loss) for loss, _ in losses[name]]
        assert len(vals) == steps and all(math.isfinite(x) for x in vals), (name, vals)
        first, last = losses[name][0][1], losses[name][-1][1]
        step_ms = first.elapsed_time(last) / (steps - 1)
        shown = ", ".join(f"{i + 1}: {vals[i]:.4f}" for i in range(0, steps, LOSS_EVERY))
        log(f"[pretrain] {name} {cfg.name}: {steps} steps in {seconds[name][0]:.2f} s (the inits "
            f"for the model and the LoRA reset, drawn on the host, included); {step_ms:.1f} ms a "
            f"step on the card's clock after the first; loss by step {shown}, {steps}: {vals[-1]:.4f}")
    tokens, labels = evals["split"]
    acc = {who: fed_steps.make_eval_fn(cfg, loop_eng._num_classes)(pre[who], tokens, labels)
           for who, cfg in (("client", GPT2_SMALL), ("server", GPT2_LARGE))}
    log(f"[pretrain] right after pretraining, on the run's eval split ({len(labels)} samples): "
        f"client accuracy {acc['client']:.4f}, server accuracy {acc['server']:.4f}")

    check_sync_guard(device)
    scan, scan_eng, _, scan_launches, scan_peak = pretrained_run(
        device, "fused_e2e", True, {(FusedE2EEngine, "run_block"): guarded_block(block)})
    rounds = PRETRAINED_FED["rounds"]
    log(f"[pretrained fused_e2e/scan] the block's {rounds} rounds: {block['seconds']:.3f} s, "
        f"{block['seconds'] / rounds:.3f} s a round, from its first launch to its last round's "
        f"end, with no synchronising call (torch.cuda.set_sync_debug_mode('error') around it); "
        f"the per-round run's rounds {[round(x, 3) for x in loop.round_seconds]} s (round 0 cold, "
        f"round {rounds - 1} traced)")
    assert scan.per_client_k == loop.per_client_k
    for a, b in zip(scan.ledger.rounds, loop.ledger.rounds):
        assert (a.uplink_bytes, a.downlink_bytes, a.num_transmitters) == (
            b.uplink_bytes, b.downlink_bytes, b.num_transmitters)
    np.testing.assert_allclose(scan.server_acc, loop.server_acc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(scan.client_acc, loop.client_acc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(scan.distill_loss, loop.distill_loss, rtol=1e-4)
    log("[pretrained] scan_rounds == per-round: identical k, bytes and transmitters, accuracies "
        "within 1e-6, distill loss within rtol 1e-4")
    del scan_eng, loop_eng

    def profiled_block(run_block):
        def call(self, staged):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=TRACE_ACTIVITIES) as prof:
                taps = run_block(self, staged)
                torch.cuda.synchronize()
            traces["block"] = trace_summary(prof, f"fused_e2e, the {rounds}-round block",
                                            block["seconds"])
            return taps

        return call

    traced, _, _, traced_launches, _ = pretrained_run(
        device, "fused_e2e", True, {(FusedE2EEngine, "run_block"): profiled_block})
    assert traced.per_client_k == scan.per_client_k

    captured = {}
    fused, _, _, fused_launches, _ = pretrained_run(
        device, "fused", False, {(ops, "topk_mask_dynamic"): capture_topk(captured)})
    assert fused.per_client_k == loop.per_client_k
    x, ks = captured["x"], captured["ks"]
    fed_pretrain._CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    runs = (loop_launches, scan_launches, traced_launches, fused_launches)
    return {"launches": {k: sum(r[k] for r in runs) for k in ops.LAUNCHES},
            "topk_input": (x.reshape(-1, x.shape[-1]), ks.reshape(-1)),
            "peak": (loop_peak, scan_peak), "block_s": block["seconds"]}


def check_sync_guard(device):
    """The guard that holds the block to no synchronising call catches one:
    a value read back to the host, and a blocking copy from the host."""
    caught = {}
    for name, sync in (("a .item()", lambda: torch.ones(1, device=device).item()),
                       ("torch.tensor(list, device=cuda)", lambda: torch.tensor([1, 2], device=device))):
        torch.cuda.set_sync_debug_mode("error")
        try:
            sync()
            caught[name] = False
        except RuntimeError:
            caught[name] = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert caught["a .item()"], "set_sync_debug_mode('error') let a .item() through"
    # AdamW's bias correction, with the scalar in the kernel: bitwise the
    # earlier form with a host-made tensor, and no synchronising call
    count = torch.arange(1, 20001, dtype=torch.int32, device=device).float()
    for b in (0.9, 0.999):
        torch.cuda.set_sync_debug_mode("error")
        try:
            new = 1.0 - b**count
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(new, 1.0 - torch.pow(torch.tensor(b, dtype=torch.float32, device=device),
                                                count))
    log(f"[sync guard] raised under set_sync_debug_mode('error'): {caught}; AdamW's 1 - b**count "
        f"runs under it, bitwise the earlier torch.pow(torch.tensor(b)) form on counts 1..20000")


# -- scenarios, faults and checkpoints -----------------------------------------

# The main path's fleet on a Gilbert-Elliott channel with faults="lossy", 3
# rounds.  A HARQ retry needs a budget of two copies of a payload, which
# only a client whose k the vocabulary caps has: a 300 MHz channel, where
# most budgets reach it.  At seed 5 the rounds hold an outage, a crash, a
# quarantine and a retry (the draws are the host's: the same on any
# device).  One pretraining step (the server's none) makes the fleet share
# one backbone, which serving from the checkpoint needs.
FAULT_FED = dict(method="adald", use_kernels=True, num_clients=8, clients_per_round=4, rounds=3,
                 public_batch=64, local_steps=2, distill_steps=1, server_distill_steps=2,
                 eval_size=128, seed=5, pretrain_steps=1, server_pretrain="none",
                 scenario="gilbert_elliott", faults="lossy")
FAULT_BANDWIDTH_HZ = 3e8
# the phase's server: GPT-2 large's widths at a third of its depth, which keeps the
# whole smoke near half its time limit (the phase checks events, gates and resumes,
# none of which depends on the server's depth)
FAULT_SERVER = GPT2_LARGE.with_overrides(num_layers=12)
SERVE_TOKENS, SERVE_PROMPT = 8, 16  # decoded from the checkpoint for two tenants


def fault_fed(**change) -> FedConfig:
    return FedConfig(channel=ChannelConfig(bandwidth_hz=FAULT_BANDWIDTH_HZ),
                     **{**FAULT_FED, **change})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def recording(into: list, keep=lambda args, out: out):
    """A wrapper that appends ``keep(args, result)`` of each call to ``into``."""
    def wrap(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            into.append(keep(args, out))
            return out

        return call

    return wrap


def newest_step_only(into: list, on_card: bool):
    """A wrapper for ``ckpt_io.save_step`` that times each save (from a
    synchronised card to a synchronised card) into ``into`` and then removes
    the steps before the one just written: one step on disk at a time."""
    def wrap(save_step):
        save = timed(into)(save_step) if on_card else recording(into)(save_step)

        def call(ckpt_dir, step, tree, **meta):
            path = save(ckpt_dir, step, tree, **meta)
            for name in os.listdir(ckpt_dir):
                m = re.match(r"step_(\d+)\.npz(\.meta\.json)?$", name)
                if m and int(m.group(1)) < step:
                    os.remove(os.path.join(ckpt_dir, name))
            return path

        return call

    return wrap


def fault_integers(run) -> tuple:
    """What a faulted run must reproduce exactly."""
    return (run.per_client_k, run.attempted_k, run.num_quarantined, run.num_crashed,
            run.retrans_bytes, [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters,
                                 r.fault_counts) for r in run.ledger.rounds])


def trained_state(eng, srv=None) -> dict[str, torch.Tensor]:
    """What the rounds train, on the CPU: the fleet's and the server's
    adapters and optimizer states (the frozen backbones are not trained).
    The server's are the engine's on ``fused_e2e``, else ``srv``'s."""
    flat = {}

    def walk(prefix, tree):
        if isinstance(tree, torch.Tensor):
            flat[prefix] = tree.detach().cpu()
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}", v)
        elif tree is not None:  # an AdamWState
            for name, v in zip(tree._fields, tree):
                walk(f"{prefix}/{name}", v)

    fleet = eng.fleet_state()
    walk("fleet", {k: fleet[k] for k in ("lora", "opt")})
    if srv is None:
        server = eng.server_state()
        walk("server", {k: server[k] for k in ("s_lora", "s_opt")})
    else:
        walk("server", {"s_lora": split_lora(srv.params)[0], "s_opt": srv.opt})
    return flat


def poisoned_dense(poisoned: dict):
    """A wrapper for ``BatchedEngine.run_round`` that makes its first
    round's first dense row NaN, as an upload that decodes to non-finite
    values; keeps the clean stack and that row's manifest in ``poisoned``."""
    def wrap(run_round):
        def call(self, *args, **kwargs):
            phase = run_round(self, *args, **kwargs)
            if not poisoned and phase.dense is not None:
                poisoned.update(clean=phase.dense, payload=phase.payloads[0])
                phase.dense = phase.dense.clone()
                phase.dense[0] = float("nan")
            return phase

        return call

    return wrap


def fault_run(device, cfgs, fed, label, patches=None, **run_kw):
    """One run of the phase; returns the run, its engine and Server, and its
    launch counts."""
    client_cfg, server_cfg, ds = cfgs
    on_card = torch.device(device).type == "cuda"
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launches()  # this run's launches only, from here
    run, eng, srv = _drive(client_cfg, server_cfg, ds, fed, device, patches, **run_kw)
    sync(device)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    log(f"[faults {label}] {fed.engine}, {fed.rounds} rounds in {time.perf_counter() - t0:.1f} s "
        f"(setup included), round_seconds={[round(x, 3) for x in run.round_seconds]}, "
        f"max_memory_allocated={peak:.2f} GiB; kernel launches {launches}")
    log(f"[faults {label}] per_client_k={run.per_client_k} attempted_k={run.attempted_k} "
        f"quarantined={run.num_quarantined} crashed={run.num_crashed} "
        f"retrans_bytes={run.retrans_bytes}")
    log(f"[faults {label}] uplink_bytes={[r.uplink_bytes for r in run.ledger.rounds]} "
        f"fault_counts={[r.fault_counts for r in run.ledger.rounds]} server_acc={run.server_acc} "
        f"client_acc={run.client_acc} distill_loss={run.distill_loss}")
    return run, eng, srv, launches


def check_wire_gate(srv, wire, device) -> dict:
    """A real round's wire, float and int8, with client row 1 corrupted
    (a NaN value; a NaN scale): ``Server.aggregate_sparse_wire(validate=
    True)`` through kernel 1 or 2 is ``torch.equal`` to its plain version
    and to the kernel's aggregate of the wire without that row.  Returns
    the launches of the validated calls."""
    launches = {}
    keep = torch.as_tensor([i for i in range(wire.values.shape[0]) if i != 1], device=wire.mask.device)
    for name, w in (("float", wire), ("int8", quantize_wire(wire))):
        bad = corrupt_wire(w, [1], mode="nan")
        ops.reset_launches()
        k_g, _ = srv.aggregate_sparse_wire(bad, validate=True)
        sync(device)
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        for kname, n in got.items():
            launches[kname] = launches.get(kname, 0) + n
        srv.use_kernels = False
        plain, _ = srv.aggregate_sparse_wire(bad, validate=True)
        srv.use_kernels = True
        without = type(w)(vocab=w.vocab, **{f: getattr(w, f)[keep] for f in w._fields if f != "vocab"})
        whole, _ = srv.aggregate_sparse_wire(without)
        assert bool(torch.isfinite(k_g).all()), name
        assert torch.equal(k_g, plain) and torch.equal(k_g, whole), name
        log(f"[faults wire] {name} wire {tuple(w.values.shape)} with row 1 corrupted: "
            f"aggregate_sparse_wire(validate=True) == its plain version == the wire without "
            f"row 1 (torch.equal); the validated call's kernel launches {got}")
    return launches


def serve_tokens(source, cfg, device) -> np.ndarray:
    """Greedy tokens of two tenants served from ``source``."""
    params = serving_params(source, model.init(cfg, 3, device))
    cache = AdapterCache(source, like=lora_template(params), slots=2, device=device)
    sess = ServeSession(ServeConfig(model=cfg, batch=2, cache_len=SERVE_PROMPT + SERVE_TOKENS),
                        params, adapters=cache, device=device)
    sess.attach([5, 2])
    sess.prefill(np.random.default_rng(29).integers(0, cfg.vocab_size, (2, SERVE_PROMPT))
                 .astype(np.int32))
    return sess.decode(SERVE_TOKENS)[0]


def phase_faults(device, cfgs=None) -> dict:
    """Channel scenarios, fault injection and checkpoints at the main path's
    widths (``cfgs``: client config, server config, dataset; the tiny
    configs of a rehearsal on the CPU otherwise).  Returns the phase's
    launch counts."""
    cfgs = cfgs or (GPT2_SMALL, FAULT_SERVER,
                    make_banking77_like(vocab_size=GPT2_SMALL.vocab_size, seq_len=32))
    on_card = torch.device(device).type == "cuda"
    total: dict[str, int] = {}

    def count(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # 1. fused_e2e, float wire: round by round, then as a block
    resolutions, rounds_seen = [], []
    keep_round = recording(rounds_seen, lambda args, phase: (args[1], phase.sparse))
    loop, loop_eng, loop_srv, launches = fault_run(
        device, cfgs, fault_fed(engine="fused_e2e"), "fused_e2e/loop",
        {(FaultSimulator, "resolve_round"): recording(resolutions, lambda args, res: res),
         (FusedE2EEngine, "run_round"): keep_round})
    count(launches)
    rounds = FAULT_FED["rounds"]
    if on_card:
        assert launches == {"scatter_wire_sums": rounds}, launches
    retries = sum(1 for res in resolutions for d, a in zip(res.delivered, res.attempts) if d and a > 1)
    events = dict(crash=sum(loop.num_crashed), quarantine=sum(loop.num_quarantined), retry=retries)
    sels = [sel for sel, _ in rounds_seen]
    wire = max((w for _, w in rounds_seen if w is not None), key=lambda w: w.values.shape[0])
    del rounds_seen
    loop_trained = trained_state(loop_eng)
    del loop_eng
    block = {}
    scan, _, _, launches = fault_run(
        device, cfgs, fault_fed(engine="fused_e2e", scan_rounds=True), "fused_e2e/block",
        {(FusedE2EEngine, "run_block"): guarded_block(block)} if on_card else None)
    count(launches)
    if on_card:
        assert launches == {"scatter_wire_sums": rounds}, launches
    assert fault_integers(scan) == fault_integers(loop)
    np.testing.assert_allclose(scan.server_acc, loop.server_acc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(scan.client_acc, loop.client_acc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(scan.distill_loss, loop.distill_loss, rtol=1e-4)
    # the block's channel taps against the host's f64 chain of the same seed
    chan = ChannelSimulator(FAULT_FED["num_clients"], dataclasses.replace(
        ChannelConfig(bandwidth_hz=FAULT_BANDWIDTH_HZ),
        scenario=get_scenario(FAULT_FED["scenario"])), seed=FAULT_FED["seed"])
    worst = 0.0
    for r, sel in enumerate(sels):
        for i, st in enumerate(chan.states(r, sel)):
            assert scan.outage[r][i] == (st.snr_db == -math.inf), (r, i)
            if not scan.outage[r][i]:
                worst = max(worst, abs(scan.snr_db[r][i] - st.snr_db))
    assert worst <= 1e-2, worst
    events["outage"] = sum(o for row in scan.outage for o in row)
    log(f"[faults] block == per-round on k, attempted k, bytes, transmitters and fault taps; "
        f"accuracies within 1e-6, distill loss within rtol 1e-4; the block's SNR taps within "
        f"{worst:.2e} dB of the host chain (bound 1e-2), outage flags equal; block "
        f"{block.get('seconds', float('nan')):.3f} s for {rounds} rounds under "
        f"set_sync_debug_mode('error'); events at seed {FAULT_FED['seed']}: {events}")
    assert all(events.values()), events
    # the same block on the i.i.d. channel with no faults: the pair isolates
    # what the channel chain and the fault inputs cost the block
    iid_block = {}
    _, _, _, launches = fault_run(
        device, cfgs, fault_fed(engine="fused_e2e", scan_rounds=True, scenario=None, faults=None),
        "fused_e2e/block, i.i.d., no faults",
        {(FusedE2EEngine, "run_block"): guarded_block(iid_block)} if on_card else None)
    count(launches)
    if on_card:
        assert launches == {"scatter_wire_sums": rounds}, launches
        log(f"[faults] the block with the Gilbert-Elliott chain and lossy faults "
            f"{block['seconds'] / rounds:.4f} s a round, the same configuration's block on the "
            f"i.i.d. channel with no faults {iid_block['seconds'] / rounds:.4f} s a round "
            f"(ratio {block['seconds'] / iid_block['seconds']:.4f})")

    # 2. batched with corruption, round 0's first dense row made NaN on the
    # device: the server's validate_dense gate drops it before kernel 4
    poisoned, aggs = {}, []
    batched, _, batched_srv, launches = fault_run(
        device, cfgs, fault_fed(engine="batched", faults="corruption", rounds=2),
        "batched/corruption",
        {(BatchedEngine, "run_round"): poisoned_dense(poisoned),
         (Server, "aggregate_dense"): recording(aggs, lambda args, out: (args[1], out[0]))})
    count(launches)
    tx_rounds = sum(1 for r in batched.ledger.rounds if r.num_transmitters > 0)
    if on_card:
        assert launches == {"sparse_aggregate": tx_rounds}, launches
    clean = poisoned["clean"]
    assert not poisoned["payload"].delivered
    assert batched.ledger.rounds[0].fault_counts.get("invalid_wire") == 1, batched.ledger.rounds[0]
    stack, k_g = aggs[0]
    assert torch.equal(stack, clean[1:]), "the gate's stack is not the clean rows without row 0"
    assert batched_srv.aggregation == "adaptive"
    assert torch.equal(k_g, ref.sparse_aggregate_ref(clean[1:]))
    log(f"[faults batched/corruption] round 0's dense row 0 of {tuple(clean.shape)} made NaN: "
        f"its payload undelivered, invalid_wire counted; kernel 4's aggregate of the "
        f"{clean.shape[0] - 1} rows left == its plain version on the clean rows without it "
        f"(torch.equal)")
    del clean, stack, k_g, aggs, poisoned, batched_srv

    # 3. a real round's wire through the server's gate, kernels 1 and 2
    count(check_wire_gate(loop_srv, wire, device))
    del wire, loop_srv

    # 4. checkpoints: 1 round with ckpt_dir, then resume to 3
    ckpt_dir = tempfile.mkdtemp(prefix="fed_ckpt_")
    try:
        free = shutil.disk_usage(ckpt_dir).free
        saves, restores, loads = [], [], []
        save_timer = {(ckpt_io, "save_step"): newest_step_only(saves, on_card)}
        _, first_eng, _, launches = fault_run(
            device, cfgs, fault_fed(engine="fused_e2e", rounds=1), "ckpt/1 round", save_timer,
            ckpt_dir=ckpt_dir)
        count(launches)
        step1 = os.path.join(ckpt_dir, "step_00000001.npz")
        nbytes = os.path.getsize(step1)
        live = serve_tokens(FleetStoreSource(first_eng._store), cfgs[0], device)
        stored = serve_tokens(MonolithicSource(step1), cfgs[0], device)
        assert np.array_equal(stored, live), (stored, live)
        del first_eng
        resumed, resumed_eng, _, launches = fault_run(
            device, cfgs, fault_fed(engine="fused_e2e"), "ckpt/resumed",
            {**save_timer,
             **{(owner, name): timed(into) if on_card else recording(into)
                for owner, name, into in ((ckpt_io, "restore_step", restores),
                                          (FusedE2EEngine, "load_fleet_state", loads),
                                          (FusedE2EEngine, "load_server_state", loads))}},
            ckpt_dir=ckpt_dir, resume=True)
        count(launches)
        if on_card:
            assert launches == {"scatter_wire_sums": rounds - 1}, launches
        assert fault_integers(resumed) == fault_integers(loop)
        for name in ("server_acc", "client_acc", "distill_loss"):
            np.testing.assert_array_equal(getattr(resumed, name), getattr(loop, name), err_msg=name)
        resumed_trained = trained_state(resumed_eng)
        del resumed_eng
        assert resumed_trained.keys() == loop_trained.keys()
        unequal = [k for k, v in loop_trained.items() if not torch.equal(resumed_trained[k], v)]
        assert not unequal, unequal
        seconds = (f"save {[round(x, 2) for x in saves]} s, restore "
                   f"{[round(x, 2) for x in restores]} s to the host and {sum(loads):.2f} s onto "
                   f"the card" if on_card else "not timed off the card")
        log(f"[checkpoint] step 1: {nbytes} bytes ({nbytes / 2**30:.2f} GiB; {free / 2**30:.0f} GiB "
            f"free in the directory before), {seconds}; resumed to {rounds} rounds: k, attempted k, "
            f"bytes and fault taps identical to the uninterrupted run, accuracies and distill "
            f"losses equal, the final fleet and server adapters and optimizer states "
            f"torch.equal ({len(loop_trained)} tensors); serving from step 1's npz "
            f"(MonolithicSource): {SERVE_TOKENS} tokens x 2 tenants "
            f"equal to the live store's")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert not os.path.exists(ckpt_dir)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"launches": total}


# -- phase 5d: the host fleet store and the fed_train entry point ----------------

SCALE_N = 10_000  # phase 5d (b): a fleet no device store of GPT-2 small rows fits beside the run
SCALE_ROUNDS = 3
PEAK_SLACK = 256 * 2**20  # (b)'s peak at N = 10 000 against N = 8


def same_record(a: dict, b: dict) -> bool:
    """Two records equal, a NaN (no server-distill loss off the e2e path)
    equal to a NaN: compared through their JSON text, every float exact."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def main_record(run) -> dict:
    """What two runs of one configuration must give alike, whatever the store."""
    return {"per_client_k": run.per_client_k,
            "bytes": [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters)
                      for r in run.ledger.rounds],
            "server_acc": run.server_acc, "client_acc": run.client_acc,
            "distill_loss": run.distill_loss}


def timed_calls(into: list, label=lambda self, args: None):
    """A wrapper for a method that appends ``(label(self, args) taken before
    the call, host seconds of the call)`` to ``into``; on the card the
    clock stops after a synchronise of the calling thread's stream only if
    the method itself waits (``fetch`` does not: its copies are queued)."""
    def wrap(method):
        def call(self, *args, **kwargs):
            tag = label(self, args)
            t0 = time.perf_counter()
            out = method(self, *args, **kwargs)
            into.append((tag, time.perf_counter() - t0))
            return out

        return call

    return wrap


class CyclingClients:
    """A fleet of any size over a few real clients: client ``i`` is
    ``clients[i % len(clients)]`` (data streams and manifests are the
    small fleet's; the store holds N rows)."""

    def __init__(self, clients):
        self.clients = list(clients)

    def __getitem__(self, i):
        return self.clients[int(i) % len(self.clients)]

    def __len__(self):
        return len(self.clients)


def nbytes(tree: dict) -> int:
    return sum(t.numel() * t.element_size() for t in tree.values())


def drive_rounds(eng, sels, pub, chan, device) -> list[float]:
    """Rounds of ``eng`` in the round loop's order (hint round r+1, then run
    round r), each timed to a synchronised card; returns the round times."""
    bcast, times = eng.broadcast_state(pub), []
    for r, sel in enumerate(sels):
        t0 = time.perf_counter()
        if r + 1 < len(sels):
            eng.prefetch_cohort(sels[r + 1])
        eng.run_round(sel, pub, bcast, chan.states_batched(r, sel), adaptive_k=True, send_h=True)
        bcast = eng.broadcast_state(pub)
        sync(device)
        times.append(time.perf_counter() - t0)
    return times


def staging_failure_raises(store, sel) -> str:
    """A staging thread that raises makes the fetch of its cohort raise."""
    stage = HostFleetStore._stage

    def broken(self, ids, keys, stream):
        if threading.current_thread() is not threading.main_thread():  # a staging thread
            raise OSError("injected staging failure")
        return stage(self, ids, keys, stream)

    HostFleetStore._stage = broken
    try:
        store.prefetch(sel)
        try:
            store.fetch(sel)
        except RuntimeError as e:
            assert isinstance(e.__cause__, OSError), e
            return str(e)
        raise AssertionError("a failed staging thread did not fail the fetch")
    finally:
        HostFleetStore._stage = stage


def check_host_store_staging(device, rounds: int = 12) -> int:
    """The host store's staging on toy rows: ``rounds`` rounds of cohorts
    that overlap the round before, in the round loop's order (hint r+1,
    fetch r, commit r), each fetch ``torch.equal`` to a store without
    prefetch; returns the fetches that found their cohort staged."""
    gen = torch.Generator().manual_seed(3)
    rows = [{"a": torch.randn(64, 8, generator=gen), "b": torch.randn(8, 64, generator=gen)}
            for _ in range(16)]
    frozen = {"w": torch.randn(64, 64, generator=gen).to(device)}
    loras = [{k: v.to(device) for k, v in r.items()} for r in rows]
    staged, plain = (HostFleetStore(loras, [frozen] * 16, shared=True, prefetch=p) for p in (True, False))
    rng = np.random.default_rng(4)
    sels = [[int(x) for x in rng.choice(16, 4, replace=False)] for _ in range(rounds)]
    hits = 0
    for r, sel in enumerate(sels):
        if r + 1 < rounds:
            staged.prefetch(sels[r + 1])
        hits += tuple(sel) in staged._pf
        got, want = staged.fetch(sel), plain.fetch(sel)
        for x, y in zip(_store_leaves({"lora": got[1], "opt": got[3]}),
                        _store_leaves({"lora": want[1], "opt": want[3]})):
            assert x.device.type == torch.device(device).type and torch.equal(x, y)
        for st, (idx, lora, _, opt) in ((staged, got), (plain, want)):
            st.commit(idx, {k: v * 1.5 + r for k, v in lora.items()},
                      opt._replace(m={k: v + r for k, v in opt.m.items()}, count=opt.count + 1))
    assert hits == rounds - 1, hits
    return hits


def phase_host_store(device, main: dict | None = None, cfgs=None,
                     cli_argv: tuple = ()) -> dict:
    """Phase 5d (see the module docstring).  ``main``: phase 5's fp32
    ``fused_e2e`` float-wire run (``phase_main_path``'s output); without it
    (a rehearsal on the CPU, ``cfgs`` the tiny configs) the device-store run
    is made here.  ``cli_argv``: arguments added to every ``fed_train``
    call.  Returns the phase's launch counts."""
    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    client_cfg, server_cfg, ds = cfgs or (
        GPT2_SMALL, GPT2_LARGE, make_banking77_like(vocab_size=GPT2_SMALL.vocab_size, seq_len=32))
    total: dict[str, int] = {}

    def count(launches, rounds, label):
        if on_card:
            assert launches == {"scatter_wire_sums": rounds}, (label, launches)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def measured(fn):
        sync(device)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        out = fn()
        sync(device)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        return out, launches, torch.cuda.max_memory_allocated() if on_card else 0

    hits = check_host_store_staging(device)
    log(f"[host store] staging on toy rows: {hits} staged fetches of cohorts overlapping the round "
        f"before, each torch.equal to a store without prefetch")
    if main is None:  # the rehearsal: the device store's run first
        (run, eng, _), _, peak = measured(lambda: _drive(client_cfg, server_cfg, ds,
                                                         main_fed("fused_e2e", False), device))
        main = dict(record=main_record(run), round_seconds=list(run.round_seconds), peak=peak,
                    trained=trained_state(eng))
        del run, eng

    # (a) the main path's fused_e2e float-wire run with the host store
    fetches, commits, writes = [], [], []
    patches = {
        (HostFleetStore, "fetch"): timed_calls(fetches, lambda self, args: tuple(
            int(i) for i in args[0]) in self._pf),
        (HostFleetStore, "commit"): timed_calls(commits),
        (HostFleetStore, "_write_rows"): timed_calls(writes),
    }
    fed = main_fed("fused_e2e", False, fleet_store="host")
    (run, eng, _), launches, peak = measured(lambda: _drive(client_cfg, server_cfg, ds, fed,
                                                            device, patches))
    count(launches, fed.rounds, "host store")
    store = eng._store
    assert isinstance(store, HostFleetStore) and eng.store_kind == "host"
    assert main_record(run) == main["record"], (main_record(run), main["record"])
    got = trained_state(eng)
    assert got.keys() == main["trained"].keys()
    unequal = [k for k, v in main["trained"].items() if not torch.equal(got[k], v)]
    assert not unequal, unequal
    hits = [t for staged, t in fetches if staged]
    colds = [t for staged, t in fetches if not staged]
    assert len(hits) >= 1 and len(colds) >= 1, fetches
    if on_card:  # pinned slots, a side stream, pinned commit rows
        assert store._side is not None and store._side != torch.cuda.current_stream()
        slots = [t for group in store._slots.values() for slot in group
                 for t in _store_leaves(slot["host"])]
        bufs = [t for b in store._commit_bufs.values() for t in _store_leaves(b)]
        assert slots and bufs and all(t.is_pinned() for t in slots + bufs)
    stall = [t - w for (_, t), (_, w) in zip(commits, writes)]
    log(f"[host store (a)] fused_e2e float wire, GPT-2 small x{fed.num_clients} (cohort "
        f"{fed.clients_per_round}) in host memory: per-client k, bytes, transmitters, server_acc, "
        f"client_acc, distill_loss equal to phase 5's device-store run; {len(got)} trained tensors "
        f"(fleet LoRA, Adam m/v/count; server LoRA and Adam) torch.equal")
    log(f"[host store (a)] round_seconds={[round(x, 3) for x in run.round_seconds]} (device store "
        f"{[round(x, 3) for x in main['round_seconds']]}), max_memory_allocated="
        f"{peak / 2**30:.2f} GiB (device store {main['peak'] / 2**30:.2f} GiB)")
    log(f"[host store (a)] prefetch hits {len(hits)} of {len(fetches)} fetches; fetch host ms: "
        f"staged {[round(t * 1e3, 2) for t in hits]}, cold {[round(t * 1e3, 2) for t in colds]}; "
        f"commit host ms {[round(t * 1e3, 2) for _, t in commits]}, of which waiting for the round "
        f"and the copy {[round(t * 1e3, 2) for t in stall]} and writing the host rows "
        f"{[round(t * 1e3, 2) for _, t in writes]}")
    a_steady = run.round_seconds[-1]

    # (b) the same engine over a lazy fleet of N rows: N = 8, then N = SCALE_N
    lora0, frozen0 = store.client_row(0)
    frozen0 = {k: v.clone() for k, v in frozen0.items()}  # the shared backbone of (b)
    pub = torch.as_tensor(ds.tokens[: fed.public_batch], device=device)
    eng.clients = CyclingClients(eng.clients)
    del run, store
    scale = {}
    for n in (fed.num_clients, SCALE_N):
        eng._store = HostFleetStore.from_template(lora0, frozen0, num_clients=n)
        rng = np.random.default_rng(1)
        sels = [sorted(int(x) for x in rng.choice(n, fed.clients_per_round, replace=False))
                for _ in range(SCALE_ROUNDS)]
        chan = ChannelSimulator(n, ChannelConfig(), seed=0)
        times, launches, peak = measured(lambda: drive_rounds(eng, sels, pub, chan, device))
        count(launches, SCALE_ROUNDS, f"N={n}")
        assert eng._store.device_bytes() == nbytes(frozen0), (eng._store.device_bytes(),
                                                              nbytes(frozen0))
        scale[n] = dict(times=times, peak=peak, host=eng._store.host_bytes())
    small, big = scale[fed.num_clients], scale[SCALE_N]
    if on_card:
        assert abs(big["peak"] - small["peak"]) <= PEAK_SLACK, (big["peak"], small["peak"])
    row = nbytes(lora0) * 3  # a LoRA row with Adam's m and v (fp32)
    failure = staging_failure_raises(eng._store, sels[0])
    log(f"[host store (b)] HostFleetStore.from_template, shared GPT-2 small backbone, "
        f"{SCALE_ROUNDS} rounds of cohort {fed.clients_per_round} (hint r+1, then round r): "
        f"device_bytes() = the backbone's {nbytes(frozen0)} bytes at N = {fed.num_clients} and "
        f"N = {SCALE_N}; round_seconds {[round(x, 3) for x in small['times']]} / "
        f"{[round(x, 3) for x in big['times']]}, steady {big['times'][-1]:.3f} s (a: "
        f"{a_steady:.3f} s); max_memory_allocated {small['peak'] / 2**30:.3f} / "
        f"{big['peak'] / 2**30:.3f} GiB (within {PEAK_SLACK >> 20} MiB; (a) "
        f"{main['peak'] / 2**30:.2f} GiB on the device store); resident host bytes "
        f"{big['host']} at N = {SCALE_N} (the template and the committed rows; the device store "
        f"would hold {SCALE_N * row / 1e9:.1f} GB of LoRA and Adam rows); a staging failure "
        f"raised at the fetch: {failure!r}")
    del eng
    gc.collect()

    # (c) the entry point: a host-store checkpoint resumed under the device store
    tmp = tempfile.mkdtemp(prefix="fed_train_")
    try:
        ckpt, records = os.path.join(tmp, "ckpt"), {}
        common = ["--engine", "fused_e2e", "--use-kernels", "--fleet-size", "64", "--per-round",
                  "4", "--device", str(device), *cli_argv]
        for name, extra, rounds in (
            ("host", ["--fleet-store", "host", "--rounds", "2", "--ckpt-dir", ckpt], 2),
            ("resumed", ["--fleet-store", "device", "--rounds", "3", "--ckpt-dir", ckpt,
                         "--resume"], 1),
            ("fresh", ["--fleet-store", "device", "--rounds", "3"], 3),
        ):
            out = os.path.join(tmp, name)
            code, launches, _ = measured(lambda: fed_train.main(common + extra + ["--out", out]))
            assert code == 0, (name, code)
            count(launches, rounds, f"fed_train {name}")
            (record,) = os.listdir(out)
            with open(os.path.join(out, record)) as f:
                records[name] = json.load(f)
        shard_dir = ckpt_io.fleet_shard_dir(ckpt, 2)
        shards = sorted(os.listdir(shard_dir))
        assert shards and all(f.startswith("fleet_") for f in shards), shards
        assert ckpt_io.step_metadata(ckpt, 2)["fleet_sharded"] is True
        keys = ("mean_k", "uplink_mb_per_round", "downlink_mb_per_round", "server_acc",
                "client_acc", "distill_loss")
        for key in keys:
            assert records["resumed"][key] == records["fresh"][key], key
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[fed_train] python -m repro_torch.launch.fed_train {' '.join(common)}: a host-store run "
        f"of 2 rounds wrote {shards} and fleet_sharded in step 2's metadata; the device store "
        f"resumed it to 3 rounds equal to a fresh device-store run on {', '.join(keys)} "
        f"(server_acc {records['fresh']['server_acc']})")
    log(f"[host store] phase 5d in {time.perf_counter() - t_phase:.1f} s; kernel launches {total}")
    return {"launches": total}


# -- phase 5e: scale-out ------------------------------------------------------

SHARD_RUNS = (("fused_e2e", False), ("fused_e2e", True), ("fused", False))  # (a), with phase 5's
# (b): the fused_e2e float-wire runs two ranks split, against the same unsharded
SCALE_OUT_B = {"cohort 4": dict(), "cohort 3": dict(clients_per_round=3),
               "cohort 3 block": dict(clients_per_round=3, scan_rounds=True)}
# relative L2 per trained LoRA leaf, two ranks' split against the unsharded run:
# tests/test_torch_rounds_block.py's bound for B factors after two rounds.  They start
# at zero and hold a few Adam steps, each normalised, so a last-bit gradient difference
# on a near-zero-gradient element moves it by up to lr; on the card a rank's block of
# 2 clients runs other GEMM shapes than the cohort of 4 (the server's q B factor sat
# 1.5e-4 from the unsharded run's on the first run here)
SHARD_NORM = 1e-3


def scale_out_run(fed: FedConfig, device, cfgs=None) -> dict:
    """One run of ``fed`` for phase 5e: its record, trained tensors (host),
    round times, launches, peak memory, every round's wire mask (copied to
    the host after the run: the block makes no synchronising call) and, when
    sharded, each gather's bytes and device time (CUDA events)."""
    client_cfg, server_cfg, ds = cfgs or (
        GPT2_SMALL, GPT2_LARGE, make_banking77_like(vocab_size=GPT2_SMALL.vocab_size, seq_len=32))
    on_card = torch.device(device).type == "cuda"
    masks, gathers = [], []

    def keep_mask(make):
        def made(*args, **kwargs):
            fn = make(*args, **kwargs)

            def call(*a, **kw):
                out = fn(*a, **kw)
                masks.append(out[4].mask.clone())
                return out

            return call

        return made

    def timed_gather(gather):
        def call(tree, group=None):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else []
            if events:
                events[0].record()
            out = gather(tree, group)
            if events:
                events[1].record()
            moved = sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor))
            gathers.append((moved, events))
            return out

        return call

    patches = {(fed_steps, "make_fused_e2e_round_fn"): keep_mask,
               (sharding, "gather_cohort"): timed_gather}
    sync(device)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run, eng, srv = _drive(client_cfg, server_cfg, ds, fed, device, patches)
    sync(device)
    out = dict(record=main_record(run), round_seconds=list(run.round_seconds),
               launches={k: v for k, v in ops.LAUNCHES.items() if v},
               peak=torch.cuda.max_memory_allocated() if on_card else 0,
               trained=trained_state(eng, None if fed.engine == "fused_e2e" else srv),
               masks=[m.cpu() for m in masks],
               gathers=[(n, ev[0].elapsed_time(ev[1]) if ev else float("nan"))
                        for n, ev in gathers])
    del run, eng, srv
    gc.collect()
    return out


def _scale_out_rank(rank: int, rdzv: str, out_dir: str, device: str, cfgs) -> None:
    """Phase 5e (b)'s child: rank ``rank`` of a gloo group of two on the one
    card (or the CPU), running every :data:`SCALE_OUT_B` run split."""
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=2)
    try:
        res = {name: scale_out_run(main_fed("fused_e2e", False, shard_clients=True, **change),
                                   device, cfgs)
               for name, change in SCALE_OUT_B.items()}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _gathered(run: dict) -> str:
    if not run["gathers"]:
        return "no gather"
    n = [b for b, _ in run["gathers"]]
    return (f"{len(n)} gathers of {statistics.mean(n) / 1e6:.3f} MB, "
            f"{statistics.mean(ms for _, ms in run['gathers']):.3f} ms each on the device")


def _within_norm(got: dict, want: dict) -> tuple[float, str]:
    """The largest relative L2 distance over the trained LoRA leaves, and
    its leaf (the Adam moments follow their parameters, as in the CPU
    tests; Adam's step counts must be equal)."""
    assert got.keys() == want.keys()
    worst = (0.0, "")
    for k, v in want.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v), k
        elif "/m/" not in k and "/v/" not in k:
            ref = float(torch.linalg.vector_norm(v.double()))
            worst = max(worst, (float(torch.linalg.vector_norm((got[k] - v).double()))
                                / max(ref, 1e-30), k))
    return worst


def phase_scale_out(device, card: str, runs: dict | None = None, cfgs=None,
                    cli_argv: tuple = ()) -> dict:
    """Phase 5e (see the module docstring).  ``runs``: phase 5's runs by
    ``(engine, quantize, 16-bit dtype or None)``; without them (a rehearsal on the CPU,
    ``cfgs`` the tiny configs) the unsharded runs are made here.
    ``cli_argv``: arguments added to every ``fed_train`` call.  Returns the
    phase's launch counts."""
    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    total: dict[str, int] = {}

    def count(launches: dict) -> None:
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def expect(engine: str, quant: bool, run: dict, rounds: int) -> None:
        if not on_card:
            return
        tx = sum(1 for _, _, n in run["record"]["bytes"] if n > 0)
        want = ({"scatter_wire_sums_dequant" if quant else "scatter_wire_sums": rounds}
                if engine == "fused_e2e" else {"topk_mask_dynamic": rounds, "sparse_aggregate": tx})
        assert run["launches"] == want, (engine, quant, run["launches"], want)

    # (a) world size 1 over NCCL (gloo on the CPU): a one-rank group on a HashStore
    plain_group = not dist.is_initialized()
    a_masks = None
    for engine, quant in SHARD_RUNS:
        fed = main_fed(engine, quant)
        want = (runs or {}).get((engine, quant, None)) or scale_out_run(fed, device, cfgs)
        got = scale_out_run(dataclasses.replace(fed, shard_clients=True), device, cfgs)
        expect(engine, quant, got, fed.rounds)
        count(got["launches"])
        assert dist.get_world_size() == 1 and dist.get_backend() == ("nccl" if on_card else "gloo")
        assert same_record(got["record"], want["record"]), (engine, quant, got["record"],
                                                            want["record"])
        unequal = [k for k, v in want["trained"].items() if not torch.equal(got["trained"][k], v)]
        assert not unequal and got["trained"].keys() == want["trained"].keys(), unequal
        if engine == "fused_e2e" and not quant:
            a_masks = got["masks"]
        tag = f"{engine}/{'int8' if quant else 'float'}"
        log(f"[scale-out (a) {tag}] shard_clients=True at world size 1 ({dist.get_backend()}): "
            f"per-client k, bytes, transmitters, accuracies, distill losses equal to the unsharded "
            f"run, {len(want['trained'])} trained tensors torch.equal; round_seconds "
            f"{[round(x, 3) for x in got['round_seconds']]} (unsharded "
            f"{[round(x, 3) for x in want['round_seconds']]}), {_gathered(got)}, launches "
            f"{got['launches']}; {card}")
    if plain_group:
        dist.destroy_process_group()

    # (b) world size 2 over gloo: two processes on the one card
    wants = {"cohort 4": (runs or {}).get(("fused_e2e", False, None))}
    for name, change in SCALE_OUT_B.items():
        if wants.get(name) is None:
            wants[name] = scale_out_run(main_fed("fused_e2e", False, **change), device, cfgs)
    if wants["cohort 4"].get("masks") is None:
        wants["cohort 4"] = dict(wants["cohort 4"], masks=a_masks)  # (a)'s run equals phase 5's
    sync(device)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="scale_out_")
    try:
        t0 = time.perf_counter()
        torch_mp.spawn(_scale_out_rank, args=(os.path.join(tmp, "rdzv"), tmp, str(device), cfgs),
                       nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    one_sample = 1.0 / main_fed("fused_e2e", False).eval_size + 1e-9
    for name, change in SCALE_OUT_B.items():
        want, r0, r1 = wants[name], ranks[0][name], ranks[1][name]
        for got in (r0, r1):
            assert got["record"]["per_client_k"] == want["record"]["per_client_k"], name
            assert got["record"]["bytes"] == want["record"]["bytes"], name
            assert len(got["masks"]) == len(want["masks"]) and all(
                torch.equal(g, w) for g, w in zip(got["masks"], want["masks"])), name
            np.testing.assert_allclose(got["record"]["server_acc"], want["record"]["server_acc"],
                                       rtol=0, atol=one_sample)
            np.testing.assert_allclose(got["record"]["client_acc"], want["record"]["client_acc"],
                                       rtol=0, atol=one_sample)
            np.testing.assert_allclose(got["record"]["distill_loss"],
                                       want["record"]["distill_loss"], rtol=1e-4)
        worst, leaf = _within_norm(r0["trained"], want["trained"])
        assert worst <= SHARD_NORM, (name, worst, leaf)
        assert r0["record"] == r1["record"], name
        unequal = [k for k, v in r0["trained"].items() if not torch.equal(r1["trained"][k], v)]
        assert not unequal, (name, unequal)
        if on_card:
            rounds = len(want["record"]["per_client_k"])
            for got in (r0, r1):
                assert got["launches"] == {"scatter_wire_sums": rounds}, (name, got["launches"])
        count(r0["launches"])
        count(r1["launches"])
        log(f"[scale-out (b) {name}] 2 ranks over gloo on one device: k, bytes, transmitters and "
            f"{len(want['masks'])} wire masks identical to the unsharded run, accuracies within one "
            f"eval sample, trained LoRA leaves within {worst:.2e} (relative L2, bound "
            f"{SHARD_NORM}; {leaf}), "
            f"both ranks' records and {len(r0['trained'])} trained tensors torch.equal; "
            f"round_seconds rank 0 {[round(x, 3) for x in r0['round_seconds']]}, rank 1 "
            f"{[round(x, 3) for x in r1['round_seconds']]} (unsharded "
            f"{[round(x, 3) for x in want['round_seconds']]}), {_gathered(r0)}; peak "
            f"{r0['peak'] / 2**30:.2f} / {r1['peak'] / 2**30:.2f} GiB; {card}")
    log(f"[scale-out (b)] the two processes ran in {spawn_s:.1f} s (start-up included)")

    # (c) fed_train --shard-clients under torch.distributed.run, against the same run unsharded
    tmp = tempfile.mkdtemp(prefix="fed_train_shard_")
    try:
        common = ["--engine", "fused_e2e", "--use-kernels", "--fleet-size", "8", "--per-round", "4",
                  "--rounds", "2", *cli_argv]
        records = {}
        for name in ("plain", "sharded"):
            out = os.path.join(tmp, name)
            sync(device)
            ops.reset_launches()
            t0 = time.perf_counter()
            if name == "plain":
                assert fed_train.main(common + ["--device", str(device), "--out", out]) == 0
                sync(device)
                count({k: v for k, v in ops.LAUNCHES.items() if v})
            else:
                # the child's intra-op threads as this process's: CPU sums in one order
                env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"),
                           OMP_NUM_THREADS=str(torch.get_num_threads()))
                cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc-per-node", "1", "-m", "repro_torch.launch.fed_train",
                       "--shard-clients", *common, "--out", out]
                if not on_card:
                    cmd.append("--device=cpu")
                proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
                assert proc.returncode == 0, (proc.returncode, proc.stdout[-4000:],
                                              proc.stderr[-4000:])
            seconds = time.perf_counter() - t0
            (record,) = os.listdir(out)
            with open(os.path.join(out, record)) as f:
                records[name] = json.load(f)
            log(f"[scale-out (c)] fed_train {name}: {seconds:.1f} s (start-up and pretraining "
                f"included), server_acc {records[name]['server_acc']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert records["sharded"]["fed"]["shard_clients"] is True
    keys = ("mean_k", "uplink_mb_per_round", "downlink_mb_per_round", "server_acc", "client_acc")
    for key in keys:
        assert records["sharded"][key] == records["plain"][key], (key, records)
    log(f"[scale-out (c)] python -m torch.distributed.run --standalone --nproc-per-node 1 -m "
        f"repro_torch.launch.fed_train --shard-clients {' '.join(common)}: its JSON equals the "
        f"unsharded CLI run's on {', '.join(keys)} (distill_loss "
        f"{records['sharded']['distill_loss']} vs {records['plain']['distill_loss']})")

    # (d) the train and serve CLIs
    for name, cli, argv in (
        ("train", train_cli, ["--steps", "5", "--batch", "8", "--seq", "128"]),
        ("serve", serve_cli, ["--batch", "8", "--tokens", "32"]),
        ("serve", serve_cli, ["--batch", "8", "--tokens", "32", "--adapters", "8", "--slots", "8"]),
    ):
        printed = StringIO()
        ops.reset_launches()
        with redirect_stdout(printed):
            assert cli.main(argv + ["--device", str(device)]) == 0
        assert sum(ops.LAUNCHES.values()) == 0, ops.LAUNCHES  # no kernel on either path
        for line in printed.getvalue().splitlines():
            log(f"[scale-out (d) {name} {' '.join(argv)}] {line} ({card})")
    log(f"[scale-out] phase 5e in {time.perf_counter() - t_phase:.1f} s; kernel launches {total}")
    return {"launches": total}


def _store_leaves(trees: dict) -> list:
    out = []
    for tree in trees.values():
        if isinstance(tree, dict):
            out += list(tree.values())
        else:  # an AdamWState
            out += [t for f in tree if f is not None
                    for t in (f.values() if isinstance(f, dict) else [f])]
    return out


def _pretrain_bound(got: dict, want: dict, lr: float, steps: int) -> tuple[float, int]:
    """``tests/test_torch_pretrain.py``'s bound for parameters after training
    steps (every element within 1e-4 but up to 0.1 % of a leaf, rounded
    up, each within 2 * lr * steps; the key bias, whose gradient is zero in
    exact arithmetic, within that alone); returns the largest difference
    and the most strays of a leaf."""
    worst, most = 0.0, 0
    for key, g in got.items():
        diff = (g.detach().cpu() - want[key]).abs()
        worst = max(worst, float(diff.max()))
        assert float(diff.max()) <= 2 * lr * steps, (key, float(diff.max()))
        if key != "stack/pos0/attn/wk/b":
            strays = int((diff > 1e-4).sum())
            most = max(most, strays)
            assert strays <= math.ceil(1e-3 * diff.numel()), (key, strays)
    return worst, most


def phase_small_pretrain(device):
    """Pretraining on the card against the CPU at the tiny configs, 3 steps
    each: the same parameters within the bound of the CPU tests, the
    adapters reset bitwise (the same init, drawn on the CPU)."""
    client, server, ds = small_configs()
    data = ds.subset(np.arange(100))
    kw = dict(steps=3, lr=2e-3, batch_size=32, seed=3)
    for name, run in (("pretrain_classifier", lambda dev: fed_pretrain.pretrain_classifier(
                          client, data, num_classes=ds.num_classes, device=dev, **kw)),
                      ("pretrain_lm", lambda dev: fed_pretrain.pretrain_lm(server, data, device=dev,
                                                                          **kw))):
        gpu, cpu = run(device), run("cpu")
        lora = [k for k in cpu if is_lora_path(k)]
        assert lora and all(torch.equal(gpu[k].cpu(), cpu[k]) for k in lora)
        frozen = {k: v for k, v in gpu.items() if k not in lora}
        worst, most = _pretrain_bound(frozen, cpu, kw["lr"], kw["steps"])
        log(f"[small input] {name} on the card == CPU: adapters bitwise, backbone max |diff| "
            f"{worst:.2e} (key bias included), at most {most} elements of a leaf beyond 1e-4")
    fed_pretrain._CACHE.clear()


def kl_entry(eng, srv, tokens, temp: float, client_cfg=GPT2_SMALL) -> dict:
    """The KL kernel through its public entry point on the run's real
    tensors: the final broadcast (teacher) and client 0's public logits
    (student), with their LoRA projections; returns the entry's launches.
    On bf16 or fp16 logits the plain loss computes in that dtype, as the
    reference's does, so the kernel's part is held against the plain
    version of the kernel (fp32 math on the upcast logits) instead."""
    student, s_h = fed_steps.public_logits(eng.client_params(0), client_cfg, tokens)
    teacher, t_h, _ = srv.broadcast(tokens)
    dt = TAG[teacher.dtype]
    ops.reset_launches()
    loss, parts = total_distill_loss(teacher, student, t_h, s_h, temperature=temp, use_kernel=True)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    assert launches["distill_kl" + dt] == 1 and sum(launches.values()) == 1, launches
    plain, plain_parts = total_distill_loss(teacher, student, t_h, s_h, temperature=temp)
    per_row = ref.distill_kl_ref(teacher, student, temp)
    tol = temp**2 * float(kl_tolerance(teacher, student, temp, per_row).mean())
    if dt:
        err = abs(float(parts["logits"]) - float(per_row.mean()) * temp**2)
        assert err <= tol and math.isfinite(float(loss)), (float(parts["logits"]), tol)
        assert torch.equal(parts["lora"], plain_parts["lora"])
    else:
        err = abs(float(parts["logits"]) - float(plain_parts["logits"]))
        assert err <= tol and abs(float(loss) - float(plain)) <= tol, (float(loss), float(plain), tol)
    try:
        total_distill_loss(teacher, student.clone().requires_grad_(True), use_kernel=True)
    except RuntimeError as e:
        assert "forward only" in str(e)
    else:
        raise AssertionError("the forward-only KL kernel accepted a student that requires grad")
    log(f"[entry {'fused/' + dt[1:] if dt else 'sequential'}] total_distill_loss(use_kernel=True) on the "
        f"final broadcast "
        f"{tuple(teacher.shape)} and client 0's public logits: {float(loss):.6f} against "
        f"{float(plain):.6f} (use_kernel=False), |diff| {err:.3e} <= {tol:.3e}; kernel launches "
        f"{launches}; a student that requires grad raises")
    return launches


def tenant_rows(lora: dict, n: int, seed: int, device) -> list[dict]:
    """``n`` tenants' adapters with A and B both drawn from a numpy seed (a
    fresh init has B = 0, which would make every tenant the backbone)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        rows.append({
            k: torch.as_tensor((rng.normal(size=tuple(v.shape))
                                * (v.shape[-2] ** -0.5 if k.endswith("/A") else 0.02)
                                ).astype(np.float32), device=device)
            for k, v in lora.items()
        })
    return rows


# -- phase 6f: the dense and MoE families, mixed fleets ---------------------------

# granite-moe-1b-a400m at its published widths, re-based as fed_train's
# family_configs re-bases a family (the GPT-2 exchange vocabulary, GPT-2
# small's LoRA), in the main path's fp32
GRANITE = get_config("granite-moe-1b-a400m").with_overrides(
    name="fam-granite-moe-1b-a400m", vocab_size=GPT2_SMALL.vocab_size, lora=GPT2_SMALL.lora,
    param_dtype="float32", compute_dtype="float32", remat=False)
FAMILY_RUNS = (("fused_e2e", False), ("fused_e2e", True), ("fused", False), ("batched", False),
               ("sequential", False))
FAMILY_ARCHS = ("stablelm-1.6b", "llama4-scout-17b-a16e", "yi-9b", "moonshot-v1-16b-a3b",
                "command-r-35b", "granite-moe-1b-a400m")
FAMILY_ACC_TOL = 4 / 128  # four eval samples of 128: see phase_families
DECODE_TOL = 2e-3  # the reference's decode-vs-forward bound (tests/test_models_smoke.py)


def family_cohorts(into: dict):
    """A wrapper for ``ChannelSimulator.states_batched`` that keeps each
    round's cohort, ``into[round] = sel``."""
    def wrap(states_batched):
        def call(self, rnd, sel):
            into[int(rnd)] = [int(i) for i in sel]
            return states_batched(self, rnd, sel)

        return call

    return wrap


def family_runs(device, cfgs, card: str = "", runs=FAMILY_RUNS, label: str = "families") -> dict:
    """(a): the mixed fleet through the engine ``runs`` (the five by
    default); returns their launches and, with a ``sequential`` run,
    client 1's merged parameters (the second family's, for (b)).  ``card``
    (the card's name and power limit) follows each line with a time;
    ``label`` opens each line."""
    families, server_cfg, ds = cfgs
    on_card = torch.device(device).type == "cuda"
    out, launches = {}, {}
    for engine, quantize in runs:
        fed = main_fed(engine, quantize, pretrain_steps=1, server_pretrain="none")
        tag = f"{engine}/{'int8' if quantize else 'float'}"
        cohorts: dict = {}
        sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ops.reset_launches()  # this run's launches only, from here
        run, eng, srv = _drive(families, server_cfg, ds, fed, device,
                               {(ChannelSimulator, "states_batched"): family_cohorts(cohorts)})
        sync(device)
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
        make_up = [[sum(1 for i in cohorts[r] if i % len(families) == fi)
                    for fi in range(len(families))] for r in range(fed.rounds)]
        log(f"[{label} {tag}] {' + '.join(f.name for f in families)} clients "
            f"x{fed.num_clients} (cohort {fed.clients_per_round}), server {server_cfg.name} "
            f"{server_cfg.num_layers} layers, {fed.rounds} rounds in "
            f"{time.perf_counter() - t0:.1f} s (setup included), "
            f"round_seconds={[round(x, 3) for x in run.round_seconds]}, "
            f"max_memory_allocated={peak:.2f} GiB ({card})")
        log(f"[{label} {tag}] cohorts {[cohorts[r] for r in range(fed.rounds)]}, clients of each "
            f"family a round {make_up}; per_client_k={run.per_client_k}")
        log(f"[{label} {tag}] uplink_bytes={[r.uplink_bytes for r in run.ledger.rounds]} "
            f"server_acc={run.server_acc} client_acc={run.client_acc} "
            f"distill_loss={run.distill_loss}; kernel launches {got}")
        # the families bucket as they should: granite at its published widths
        if engine != "sequential":
            assert [b.cfg for b in eng.buckets] == list(families), [b.cfg.name for b in eng.buckets]
        assert all(math.isfinite(x) for x in run.server_acc + run.client_acc)
        if engine == "fused_e2e":
            assert all(math.isfinite(x) for x in run.distill_loss)
        b = final_broadcast(eng, srv, torch.as_tensor(ds.tokens[:fed.public_batch], device=device))
        assert tuple(b.shape) == (fed.public_batch, server_cfg.vocab_size)
        assert bool(torch.isfinite(b).all())
        if on_card:  # each bucket's call is a launch of the per-row top-k on `fused`
            buckets = sum(len({i % len(families) for i in cohorts[r]}) for r in range(fed.rounds))
            tx = sum(1 for r in run.ledger.rounds if r.num_transmitters > 0)
            want = {"scatter_wire_sums_dequant" if quantize else "scatter_wire_sums": fed.rounds}
            if engine != "fused_e2e":
                want = {"sparse_aggregate": tx, **({"topk_mask_dynamic": buckets}
                                                     if engine == "fused" else {})}
            assert got == want, (tag, got, want)
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        out[tag] = dict(ints=(run.per_client_k, [(r.uplink_bytes, r.downlink_bytes,
                                                  r.num_transmitters) for r in run.ledger.rounds]),
                        server_acc=run.server_acc, client_acc=run.client_acc,
                        round_seconds=list(run.round_seconds), peak=peak, make_up=make_up)
        if engine == "sequential":  # client 1's merged parameters (the second family's), for (b)
            out["client1"] = eng.client_params(1)
        del run, eng, srv, b
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    float_tags = [f"{e}/float" for e, q in runs if not q]
    seq = out.get("sequential/float", out[float_tags[0]])
    for tag in float_tags:  # the reference's contract (tests/test_hetero.py)
        assert out[tag]["ints"] == seq["ints"], (tag, out[tag]["ints"], seq["ints"])
        for key in ("server_acc", "client_acc"):
            np.testing.assert_allclose(out[tag][key], seq[key], rtol=0, atol=FAMILY_ACC_TOL + 1e-9)
    said = ""
    if "fused_e2e/int8" in out:
        e2e8 = out["fused_e2e/int8"]["ints"]
        # int8 entries cost 8 value bits: every budget affords at least the float wire's k
        assert all(k8 >= k for r8, r in zip(e2e8[0], seq["ints"][0]) for k8, k in zip(r8, r))
        assert [x[2] for x in e2e8[1]] == [x[2] for x in seq["ints"][1]]
        said = "; the int8 wire's k at least the float wire's, the same transmitters"
    log(f"[{label}] {', '.join(t.split('/')[0] for t in float_tags)}: identical per-client k, "
        f"uplink and downlink bytes and transmitters, accuracies within {FAMILY_ACC_TOL:.4f}"
        f"{said}; launches {launches}")
    return dict(runs=out, launches=launches)


def family_block(device, cfgs, per_round: dict, card: str = "",
                 label: str = "families") -> dict:
    """(d): the fleet of ``cfgs`` on ``fused_e2e`` with the float wire as a
    ``scan_rounds`` block (``HeteroFusedE2EEngine.run_rounds``), with the
    per-round runs' ``FedConfig``; on the card its ``run_block`` runs with
    every synchronising call an error.  Held to ``per_round`` (the
    ``fused_e2e`` float run of :func:`family_runs`): per-client k, bytes
    and transmitters identical, accuracies within ``FAMILY_ACC_TOL``; one
    finite family tap a family a round, kernel 1 once a round."""
    families, server_cfg, ds = cfgs
    on_card = torch.device(device).type == "cuda"
    fed = main_fed("fused_e2e", False, pretrain_steps=1, server_pretrain="none", scan_rounds=True)
    block: dict = {}
    patches = {(HeteroFusedE2EEngine, "run_block"): guarded_block(block)} if on_card else None
    sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launches()  # this run's launches only, from here
    run, eng, _srv = _drive(families, server_cfg, ds, fed, device, patches)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    fam = run.family_client_acc
    log(f"[{label} block] fused_e2e/float scan_rounds: {fed.rounds} rounds as one block in "
        f"{seconds:.1f} s (setup and pretraining included), round_seconds="
        f"{[round(x, 3) for x in run.round_seconds]}, "
        + (f"run_block {block['seconds']:.3f} s with every synchronising call an error"
           if on_card else "run_block unguarded (no card)")
        + f", max_memory_allocated={peak:.2f} GiB ({card})")
    log(f"[{label} block] per_client_k={run.per_client_k} server_acc={run.server_acc} "
        f"client_acc={run.client_acc} family_client_acc={fam} distill_loss={run.distill_loss}; "
        f"kernel launches {launches}")
    assert isinstance(eng, HeteroFusedE2EEngine), type(eng)
    want = per_round["fused_e2e/float"]
    ints = (run.per_client_k, [(r.uplink_bytes, r.downlink_bytes, r.num_transmitters)
                               for r in run.ledger.rounds])
    assert ints == want["ints"], (ints, want["ints"])
    for key in ("server_acc", "client_acc"):
        np.testing.assert_allclose(getattr(run, key), want[key], rtol=0,
                                   atol=FAMILY_ACC_TOL + 1e-9, err_msg=key)
    assert [len(row) for row in fam] == [len(families)] * fed.rounds, fam
    assert all(math.isfinite(x) for x in [a for row in fam for a in row] + run.distill_loss)
    assert all(c in row for c, row in zip(run.client_acc, fam))
    if on_card:
        assert launches == {"scatter_wire_sums": fed.rounds}, launches
    log(f"[{label} block] identical per-client k, uplink and downlink bytes and transmitters "
        f"to the per-round fused_e2e run, accuracies within {FAMILY_ACC_TOL:.4f}")
    del run, eng, _srv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return dict(launches=launches, seconds=seconds, block_seconds=block.get("seconds"),
                peak=peak, family_client_acc=fam)


def check_family_models(device, archs=FAMILY_ARCHS + ("yi-9b/window",)) -> None:
    """(b) part 1: each smoke config of ``archs`` on the card: the forward,
    the prefill (its last position), and 8 decode steps against the
    forward's logits (MoE at capacity factor 8, as the reference's test
    holds it: a full sequence's groups then drop nothing); ``yi-9b/window``
    a sliding-window decode of 16 steps through a ring of 6 slots."""
    gen = np.random.default_rng(11)
    for arch in archs:
        cfg = get_smoke_config(arch.split("/")[0])
        if cfg.moe is not None:
            cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
        steps, window = (16, 6) if arch.endswith("/window") else (8, None)
        cfg = cfg.with_overrides(sliding_window=window)
        params = model.init(cfg, 0, device)
        tokens = torch.as_tensor(gen.integers(0, cfg.vocab_size, (2, steps)), device=device)
        with torch.no_grad():
            full, aux = model.forward(params, cfg, tokens[None])
            last, _ = model.prefill(params, cfg, {"tokens": tokens})
            cache = model.init_cache(cfg, 2, 64, device=device)
            if window is not None:
                assert cache["layers"]["pos0"].k.shape[2] == window
            errs = []
            for t in range(steps):
                logits, cache = model.decode_step(params, cfg, cache, tokens[:, t])
                errs.append(float((logits - full[0, :, t]).abs().max()))
        assert bool(torch.isfinite(full).all()) and bool(torch.isfinite(aux.moe_aux).all())
        assert float((last - full[0, :, -1]).abs().max()) <= 1e-5
        assert max(errs) <= DECODE_TOL, (arch, errs)
        log(f"[families model {arch}] forward {tuple(full.shape[1:])}, moe_aux "
            f"{float(aux.moe_aux[0]):.4f}, {steps} decode steps within {max(errs):.2e} of the "
            f"forward")
        del params, cache
    sync(device)


def median_ms(fn, reps=5) -> float:
    """The median of ``reps`` calls of ``fn`` after one warm-up, each timed
    alone with CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def guarded(fn):
    """``fn()`` with every synchronising call an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def time_granite(device, params, card: str) -> dict:
    """(b) part 2: granite at full width (its 24 layers, d 1024, 32 experts
    top-8): the (8, 1024) prefill and a decode step at batch 8, each timed
    with CUDA events (the median of 5 and 9 calls after a warm-up); the
    first decode step runs with every synchronising call an error."""
    tokens = torch.as_tensor(np.random.default_rng(12).integers(0, GRANITE.vocab_size,
                                                                (SERVE_BATCH, PREFILL_S)),
                             device=device)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        prefill_ms = median_ms(lambda: model.prefill(params, GRANITE, {"tokens": tokens}))
        prefill_peak = torch.cuda.max_memory_allocated() / 2**30
        cache = model.init_cache(GRANITE, SERVE_BATCH, 64, device=device)
        # a decode step waits for nothing
        guarded(lambda: model.decode_step(params, GRANITE, cache, tokens[:, 0]))
        step = iter(range(1, 10**6))
        decode_ms = median_ms(lambda: model.decode_step(params, GRANITE, cache,
                                                        tokens[:, next(step) % PREFILL_S]), reps=9)
        logits, _ = model.prefill(params, GRANITE, {"tokens": tokens})
    assert bool(torch.isfinite(logits).all())
    log(f"[families granite] {GRANITE.num_layers} layers, d {GRANITE.d_model}, "
        f"{GRANITE.moe.num_experts} experts top-{GRANITE.moe.top_k}, fp32 (TF32 off): prefill "
        f"({SERVE_BATCH}, {PREFILL_S}) {prefill_ms:.1f} ms (peak {prefill_peak:.2f} GiB), decode "
        f"step at batch {SERVE_BATCH} {decode_ms:.2f} ms ({card})")
    return dict(prefill_ms=prefill_ms, decode_ms=decode_ms, prefill_peak=prefill_peak)


def check_union_wire(device) -> None:
    """(c): the union of two buckets' wires with different k_cap
    (``concat_wires``: the narrower padded with masked zeros at index 0)
    through kernels 1 and 2, ``torch.equal`` to their plain versions and to
    the kernels' sums of the same rows sparsified at the wide k_cap."""
    gen = torch.Generator(device=device).manual_seed(13)
    logits = [torch.randn((2, ROWS, VOCAB), generator=gen, device=device) for _ in range(2)]
    ks = [torch.tensor([100, 0], device=device), torch.tensor([1000, 37], device=device)]
    for quantize in (False, True):
        union = concat_wires([sparsify_wire(x, k, cap, quantize=quantize)
                              for x, k, cap in zip(logits, ks, (128, 1024))])
        wide = concat_wires([sparsify_wire(x, k, 1024, quantize=quantize)
                             for x, k in zip(logits, ks)])
        assert union.k_cap == 1024 and not torch.equal(union.indices, wide.indices)
        for mode in MODES:
            got = aggregate_wire(union, mode, use_kernel=True)
            assert torch.equal(got, aggregate_wire(union, mode, use_kernel=False)), mode
            assert torch.equal(got, aggregate_wire(wide, mode, use_kernel=True)), mode
    log("[families union wire] k_cap 128 and 1024 buckets, float and int8: kernels 1 and 2 "
        "torch.equal to their plain versions and to the unpadded wide wire, every mode")


def moe_overflow(into: list):
    """A wrapper for ``moe_apply`` that appends, for every call, how many
    (token, slot) router choices landed past an expert's capacity, routed
    as the call routes them (a device scalar, read after the run)."""
    def wrap(moe_apply):
        def call(lp, x, cfg, *, pool_clients=False):
            moe = cfg.moe
            tokens = x.reshape((1 if pool_clients else x.shape[0], -1, x.shape[-1]))
            tg = moe_lib.group_size(tokens.shape[1])
            tokens = tokens.reshape(tokens.shape[0], -1, tg, tokens.shape[-1])
            probs = torch.softmax((tokens.float() @ lp["mlp/router/w"].float()), dim=-1)
            _, idx = _stable_topk(probs, moe.top_k)
            per_expert = (idx[..., None] == torch.arange(moe.num_experts, device=x.device)).sum(
                dim=(2, 3))
            into.append(torch.clamp(per_expert - moe_lib.moe_capacity(cfg, tg), min=0).sum())
            return moe_apply(lp, x, cfg, pool_clients=pool_clients)

        return call

    return wrap


MOE_GEN = 16  # greedy tokens after the prompt in (e)'s one-tenant check


def serve_moe(device, card: str, cfg, backbone, label: str = "families serving") -> dict:
    """(e): MoE serving.  A ``ServeSession`` of batch 8 on ``backbone``
    with 8 tenants' adapters in an ``AdapterCache`` of 4 slots.  With one
    tenant in every row the stacked step routes the 8 requests' tokens as
    one group, as that tenant's own ``decode_step`` at batch 8 does: every
    step's logits over 32 prompt and ``MOE_GEN`` greedy tokens within
    ``SERVE_TOL`` of their largest against a session on the tenant's merged
    parameters, fed the same tokens; the first step's router choices past
    an expert's capacity counted.  (With pooled routing a request's logits
    depend on its batch, in the reference too, so the stacked-versus-solo
    check of :func:`serve_tenants` does not apply.)  Then 8 tenants in the 4
    slots: exact cache stats, a step's time and tokens/s."""
    lora, frozen = split_lora(backbone)
    rows = tenant_rows(lora, TENANTS, seed=37, device=device)
    src = export_adapters(DeviceFleetStore(rows, [frozen] * TENANTS, shared=True))
    cache = AdapterCache(src, like=lora_template(backbone), slots=SLOTS, device=device)
    sess = ServeSession(ServeConfig(model=cfg, batch=SERVE_BATCH, cache_len=128),
                        serving_params(src, backbone), adapters=cache, device=device)
    prompts = np.random.default_rng(43).integers(0, cfg.vocab_size,
                                                 (SERVE_BATCH, PROMPT)).astype(np.int32)
    tenant = 3
    ops.reset_launches()
    sess.attach([tenant] * SERVE_BATCH)
    assert cache.stats.as_dict() == dict(hits=0, misses=1, evictions=0, lookups=1)
    drops: list = []
    saved = transformer.moe_apply
    transformer.moe_apply = moe_overflow(drops)(saved)
    try:
        sess.reset()
        stacked = [sess.step(prompts[:, 0])]
    finally:
        transformer.moe_apply = saved
    first_drops = [int(n) for n in torch.stack(drops).tolist()]
    for t in range(1, PROMPT):
        stacked.append(sess.step(prompts[:, t]))
    toks = []
    for _ in range(MOE_GEN):
        toks.append(torch.argmax(stacked[-1], dim=-1))
        stacked.append(sess.step(toks[-1]))
    solo = ServeSession(ServeConfig(model=cfg, batch=SERVE_BATCH, cache_len=128),
                        merge_lora(rows[tenant], frozen), device=device)
    own = [solo.step(prompts[:, t]) for t in range(PROMPT)] + [solo.step(t) for t in toks]
    worst = 0.0
    for i, (a, b) in enumerate(zip(stacked, own)):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= SERVE_TOL, ("one tenant stacked vs its decode_step", i, err)
        worst = max(worst, err)
    ids = [0, 1, 1, 2, 3, 3, 0, 2]
    cache.reset_stats()  # the 8-tenant mix alone: tenant 3 resident, 3 slots free
    sess.attach(ids)
    stats = cache.stats.as_dict()
    assert stats == dict(hits=1, misses=3, evictions=0, lookups=1), stats
    sess.prefill(prompts)
    sync(device)
    t0 = time.perf_counter()
    sess.decode(GEN)  # every step ends in a device sync
    step_s = (time.perf_counter() - t0) / GEN
    assert sum(ops.LAUNCHES.values()) == 0, ops.LAUNCHES  # no kernel on the serving path
    cap = moe_lib.moe_capacity(cfg, moe_lib.group_size(SERVE_BATCH))
    log(f"[{label}] {cfg.name} at batch {SERVE_BATCH}, tenant {tenant} in every row: stacked "
        f"decode vs its own decode_step over {len(stacked)} steps max |diff|/max|logit| "
        f"{worst:.3e} (bound {SERVE_TOL}); the first step's top-{cfg.moe.top_k} choices past "
        f"an expert's capacity of {cap}, by layer: {first_drops} ({sum(first_drops)} in all)")
    log(f"[{label}] {TENANTS} tenants {ids} in {SLOTS} slots: cache stats {stats}, decode step "
        f"{step_s * 1e3:.3f} ms over {GEN} greedy steps (host clock), {SERVE_BATCH / step_s:.1f} "
        f"tokens/s ({card})")
    return dict(decode_step_ms=step_s * 1e3, one_tenant_vs_own=worst, first_step_drops=first_drops,
                stats=stats)


def phase_families(device, card: str = "", cfgs=None) -> dict:
    """Phase 6f: the dense and MoE families and a mixed fleet (module
    docstring).  ``cfgs`` = ``(families, server, dataset)`` replaces the
    full-width fleet (a rehearsal at small widths on the CPU runs (a) and
    the smoke configs of (b))."""
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    cached = set(fed_pretrain._CACHE)
    if cfgs is None:
        cfgs = ([GPT2_SMALL, GRANITE], FAULT_SERVER,
                make_banking77_like(vocab_size=GPT2_SMALL.vocab_size, seq_len=32))
    out = family_runs(device, cfgs, card)
    granite = out["runs"].pop("client1")
    out["block"] = family_block(device, cfgs, out["runs"], card)
    for name, n in out["block"]["launches"].items():
        out["launches"][name] = out["launches"].get(name, 0) + n
    for key in set(fed_pretrain._CACHE) - cached:  # the phase's backbones
        del fed_pretrain._CACHE[key]
    check_family_models(device)
    out["serving"] = serve_moe(device, card, cfgs[0][1], granite)
    if on_card:
        out["granite"] = time_granite(device, granite, card)
        del granite
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launches()
        check_union_wire(device)
        ops.reset_launches()  # the comparisons' launches do not count
    log(f"[families] phase 6f passed in {time.perf_counter() - t0:.1f} s ({card})")
    return out


# -- phase 6g: the state-space families, SSM and hybrid -------------------------

# mamba2-130m at its published widths (24 layers, d 768, d_inner 1536, 24 SSD
# heads of P 64, state N 128, conv 4, chunk 256), re-based as fed_train's
# family_configs re-bases a family (the GPT-2 exchange vocabulary).  It has no
# attention, so of GPT-2 small's LoRA (rank 8) it keeps the head adapter,
# which gives its eq. 8 projection.  MAMBA_BF16 keeps the published config's
# bf16 parameters and compute; MAMBA is fp32, as the main path.
MAMBA_BF16 = get_config("mamba2-130m").with_overrides(
    name="fam-mamba2-130m", vocab_size=GPT2_SMALL.vocab_size,
    lora=dataclasses.replace(GPT2_SMALL.lora, targets=("q", "v", "head")), remat=False)
MAMBA = MAMBA_BF16.with_overrides(param_dtype="float32", compute_dtype="float32")
SSM_ARCHS = ("mamba2-130m", "jamba-1.5-large-398b")
DECODE_STEPS = 16  # decode steps held against the forward, at batch 8
# in bf16 the decode and the chunked forward round at the same points but sum
# in other orders (GEMMs of other shapes, the recurrence against the chunked
# SSD), so a rounding may land a bf16 ulp away: DECODE_TOL plus this many bf16
# ulps (2^-8 relative each) of the largest logit
BF16_DECODE_ULPS = 4
SERVE_TOL = 1e-5  # of the largest logit: tests/test_torch_serve.py's bound
FAMILIES_CLI = "gpt2-paper,mamba2-130m,jamba-1.5-large-398b"


def top_device_ops(prof, n: int = 5) -> list[tuple[str, float, int]]:
    """The ``n`` device ops of a trace with the most device time: (name,
    microseconds, calls)."""
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            acc = by_name.setdefault(e.name(), [0.0, 0])
            acc[0] += (e.end_ns() - e.start_ns()) / 1e3
            acc[1] += 1
    return sorted(((k, v[0], v[1]) for k, v in by_name.items()), key=lambda x: -x[1])[:n]


def decode_steps(params, cfg, tokens, frontend, device, against_forward: bool = True):
    """Decode ``tokens (B, T)`` one step at a time from a fresh cache (an
    audio model's ``enc_out`` encoded from ``frontend``), every step's
    logits finite.  Returns the cache, each step's largest |logit - the
    forward's logit| and the forward's largest |logit| (with
    ``against_forward=False``: ``[]`` and NaN)."""
    full = None
    if against_forward:
        full = model.forward(params, cfg, tokens[None], frontend=frontend)[0][0]
    enc_out = model._run_encoder(params, cfg, frontend[None])[0] if cfg.family == "audio" else None
    cache = model.init_cache(cfg, tokens.shape[0], 64, enc_out=enc_out, device=device)
    errs = []
    for t in range(tokens.shape[1]):
        logits, cache = model.decode_step(params, cfg, cache, tokens[:, t])
        assert bool(torch.isfinite(logits).all()), (cfg.name, t)
        if full is not None:
            errs.append(float((logits.float() - full[:, t].float()).abs().max()))
    return cache, errs, float("nan") if full is None else float(full.float().abs().max())


def time_model(device, cfg, params, card: str, label: str, ulps: int | None = 0,
               flops: float | None = None) -> dict:
    """A model alone at full width in its dtype: the (8, 1024) prefill (a
    VLM's 1024 positions its ``frontend_len`` patches and the text tokens
    ``input_token_len`` gives; an audio model's tokens over its frames)
    timed with CUDA events (the median of 5 after a warm-up), beside its
    ``flops`` when given; 16 decode steps at batch 8 against the forward
    within ``DECODE_TOL`` plus ``ulps`` bf16 ulps of its largest logit
    (``ulps=None``: finite logits only, for a VLM, whose decode carries no
    patches and so matches no forward); a decode step run with every
    synchronising call an error, then timed (the median of 9); and one
    decode step traced."""
    dtype = "fp32 (TF32 off)" if cfg.compute_dtype == "float32" else "bf16"
    s_text = model.input_token_len(cfg, PREFILL_S)
    tokens = torch.as_tensor(np.random.default_rng(31).integers(0, cfg.vocab_size,
                                                                (SERVE_BATCH, s_text)),
                             device=device)
    frontend = None
    batch = {"tokens": tokens}
    if cfg.frontend != "none":
        frontend = batch["frontend"] = frontends.synth_frontend_embeddings(cfg, SERVE_BATCH,
                                                                           device=device)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        prefill_ms = median_ms(lambda: model.prefill(params, cfg, batch))
        prefill_peak = torch.cuda.max_memory_allocated() / 2**30
        last, aux = model.prefill(params, cfg, batch)
        assert tuple(last.shape) == (SERVE_BATCH, cfg.vocab_size)
        assert bool(torch.isfinite(last).all())
        if cfg.lora is not None:  # the pooled projection (an SSM's from its head adapter)
            assert tuple(aux.lora_h.shape) == (SERVE_BATCH, cfg.lora.rank)
        cache, errs, scale = decode_steps(params, cfg, tokens[:, :DECODE_STEPS], frontend, device,
                                          against_forward=ulps is not None)
        held = f"{DECODE_STEPS} decode steps' logits finite"
        if ulps is not None:
            tol = DECODE_TOL + ulps * 2**-8 * scale
            assert max(errs) <= tol, (cfg.name, dtype, errs, tol)
            held = (f"{DECODE_STEPS} decode steps within {max(errs):.3e} of the forward (bound "
                    f"{tol:.3e}, largest logit {scale:.3f})")
        at = iter(range(DECODE_STEPS, 10**6))

        def step():
            return model.decode_step(params, cfg, cache, tokens[:, next(at) % s_text])

        guarded(step)  # a decode step waits for nothing
        decode_ms = median_ms(step, reps=9)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        untraced_s = time.perf_counter() - t0
        warm_profiler()
        with torch.profiler.profile(activities=TRACE_ACTIVITIES) as prof:
            step()
            torch.cuda.synchronize()
    trace = trace_summary(prof, f"{cfg.name} {dtype} decode step, batch {SERVE_BATCH}", untraced_s)
    top = top_device_ops(prof)
    shape = f"{cfg.num_layers} layers"
    if cfg.encoder_layers:
        shape += f" + {cfg.encoder_layers} encoder layers"
    shape += f", d {cfg.d_model}"
    if cfg.ssm is not None:
        shape += f", state {cfg.ssm.state_dim}, chunk {cfg.ssm.chunk_size}"
    if frontend is not None:
        shape += f", {cfg.frontend_len} {'frames' if cfg.family == 'audio' else 'patches'}"
    rate = "" if flops is None else (f" ({flops / 1e12:.1f} TFLOP, "
                                     f"{flops / prefill_ms / 1e9:.0f} TFLOP/s)")
    log(f"[{label} {dtype}] {shape}, vocab {cfg.vocab_size}: prefill ({SERVE_BATCH}, {s_text} "
        f"tokens) {prefill_ms:.1f} ms{rate} (peak {prefill_peak:.2f} GiB); {held}; decode step at "
        f"batch {SERVE_BATCH} {decode_ms:.2f} ms, none synchronising ({card})")
    log(f"[{label} {dtype}] the traced decode step's top device ops (us, calls): "
        + "; ".join(f"{name[:60]} {us:.1f} x{n}" for name, us, n in top))
    return dict(prefill_ms=prefill_ms, prefill_peak=prefill_peak, decode_ms=decode_ms,
                decode_err=max(errs, default=None), busy_share=trace["busy_share"], top_ops=top)


def serve_tenants(device, card: str, cfg=MAMBA, backbone=None,
                  label: str = "ssm serving") -> dict:
    """(d) of 6g, (e) of 6h: a ``ServeSession`` of batch 8 on a shared ``cfg``
    backbone (``model.init(cfg, 0)`` unless given) with 8 tenants' adapters
    (A and B drawn from a numpy seed) exported from a ``DeviceFleetStore``
    into an ``AdapterCache`` of 4 slots: 32-token prompts, 32 greedy
    tokens; every request's logits at every step within ``SERVE_TOL`` of
    their largest magnitude against the request run alone with its merged
    adapter, the stacked run's tokens fed to it.  An audio model's encoder
    runs once a reset, on the session's own parameters, so the request run
    alone keeps the backbone's encoder adapters and encodes its own frames
    of the batch's stub."""
    if backbone is None:
        backbone = model.init(cfg, 0, device)
    lora, frozen = split_lora(backbone)
    rows = tenant_rows(lora, TENANTS, seed=37, device=device)
    src = export_adapters(DeviceFleetStore(rows, [frozen] * TENANTS, shared=True))
    cache = AdapterCache(src, like=lora_template(backbone), slots=SLOTS, device=device)
    sess = ServeSession(ServeConfig(model=cfg, batch=SERVE_BATCH, cache_len=128),
                        serving_params(src, backbone), adapters=cache, device=device)
    prompts = np.random.default_rng(41).integers(0, cfg.vocab_size,
                                                 (SERVE_BATCH, PROMPT)).astype(np.int32)
    audio = cfg.family == "audio"
    frames = frontends.synth_frontend_embeddings(cfg, SERVE_BATCH, device=device) if audio else None
    ids = [0, 1, 1, 2, 3, 3, 0, 2]
    ops.reset_launches()
    sess.attach(ids)
    assert cache.stats.as_dict() == dict(hits=0, misses=4, evictions=0, lookups=1)
    sync(device)
    t0 = time.perf_counter()
    sess.reset()  # an audio model's encoder pass over the batch's frames
    sync(device)
    reset_s = time.perf_counter() - t0
    sess.prefill(prompts)
    sync(device)
    t0 = time.perf_counter()
    toks, _ = sess.decode(GEN)  # every step ends in a device sync
    step_s = (time.perf_counter() - t0) / GEN
    stacked = [sess.prefill(prompts)] + [sess.step(toks[:, i]) for i in range(GEN)]
    worst = 0.0
    for b, cid in enumerate(ids):
        own = {k: (backbone[k] if k.startswith("encoder/") else v) for k, v in rows[cid].items()}
        solo = ServeSession(ServeConfig(model=cfg, batch=1, cache_len=128),
                            merge_lora(own, frozen), device=device)
        solo.reset(frontend=None if frames is None else frames[b:b + 1])
        logits = [[solo.step(prompts[b:b + 1, t]) for t in range(PROMPT)][-1]]
        logits += [solo.step(toks[b:b + 1, i]) for i in range(GEN)]
        for i, (lo, st) in enumerate(zip(logits, stacked)):
            err = float((lo[0] - st[b]).abs().max() / st[b].abs().max())
            assert err <= SERVE_TOL, ("stacked vs solo", b, i, err)
            worst = max(worst, err)
    assert sum(ops.LAUNCHES.values()) == 0, ops.LAUNCHES  # no kernel on the serving path
    log(f"[{label}] {cfg.name} backbone + {TENANTS} tenants' adapters ({len(lora)} leaves a "
        f"tenant), AdapterCache of {SLOTS} slots, batch {SERVE_BATCH}, tenants {ids}: stacked "
        f"decode vs each request alone over {GEN + 1} steps max |diff|/max|logit| {worst:.3e} "
        f"(bound {SERVE_TOL}); a reset {reset_s * 1e3:.1f} ms"
        f"{' (the encoder pass)' if audio else ''}, decode step {step_s * 1e3:.3f} ms over {GEN} "
        f"greedy steps (host clock), {SERVE_BATCH / step_s:.1f} tokens/s ({card})")
    return dict(decode_step_ms=step_s * 1e3, reset_ms=reset_s * 1e3, stacked_vs_solo=worst)


def families_cli(device, families: str = FAMILIES_CLI, label: str = "ssm") -> dict:
    """(c) part 2: ``fed_train --families gpt2-paper,mamba2-130m,jamba-...``
    (or ``families``) on ``fused_e2e`` with the kernels, 2 rounds at the
    CLI's own sizes (each smoke config re-based onto the reduced
    experiment's vocabulary and LoRA), in a temp directory it removes;
    returns its launches."""
    tmp = tempfile.mkdtemp(prefix="fed_train_families_")
    argv = ["--families", families, "--engine", "fused_e2e", "--use-kernels", "--rounds", "2",
            "--device", str(device), "--out", tmp]
    try:
        sync(device)
        ops.reset_launches()
        t0 = time.perf_counter()
        assert fed_train.main(argv) == 0
        sync(device)
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as f:
            rec = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert rec["families"] == families and len(rec["server_acc"]) == 2
    assert all(x is not None and math.isfinite(x) for x in rec["distill_loss"])
    if torch.device(device).type == "cuda":
        assert launches == {"scatter_wire_sums": 2}, launches
    log(f"[{label} fed_train] python -m repro_torch.launch.fed_train {' '.join(argv[:-2])}: "
        f"{seconds:.1f} s (pretraining included), mean_k {rec['mean_k']}, uplink MB "
        f"{rec['uplink_mb_per_round']}, server_acc {rec['server_acc']}, distill_loss "
        f"{rec['distill_loss']}; kernel launches {launches}")
    return launches


def phase_ssm(device, card: str = "", cfgs=None) -> dict:
    """Phase 6g: the SSM and hybrid families (module docstring).  ``cfgs`` =
    ``(families, server, dataset)`` replaces the full-width fleet of (a): a
    rehearsal at small widths on the CPU runs (a), the smoke configs of (c)
    and the CLI run."""
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    cached = set(fed_pretrain._CACHE)
    if cfgs is None:
        cfgs = ([GPT2_SMALL, MAMBA], FAULT_SERVER,
                make_banking77_like(vocab_size=GPT2_SMALL.vocab_size, seq_len=32))
    out = family_runs(device, cfgs, card)
    del out["runs"]["client1"]
    out["block"] = family_block(device, cfgs, out["runs"], card, label="ssm")
    for name, n in out["block"]["launches"].items():
        out["launches"][name] = out["launches"].get(name, 0) + n
    for key in set(fed_pretrain._CACHE) - cached:  # the phase's backbones
        del fed_pretrain._CACHE[key]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        out["mamba"] = {}
        for cfg, ulps in ((MAMBA_BF16, BF16_DECODE_ULPS), (MAMBA, 0)):
            params = model.init(cfg, 0, device)
            out["mamba"][cfg.compute_dtype] = time_model(device, cfg, params, card,
                                                         "ssm mamba2-130m", ulps)
            del params
    check_family_models(device, SSM_ARCHS)
    for name, n in families_cli(device).items():
        out["launches"][name] = out["launches"].get(name, 0) + n
    for key in set(fed_pretrain._CACHE) - cached:
        del fed_pretrain._CACHE[key]
    if on_card:
        backbone = model.init(MAMBA, 0, device)
        assert {k for k in backbone if is_lora_path(k)} == {"lora_head/A", "lora_head/B"}
        out["serving"] = serve_tenants(device, card, MAMBA, backbone)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[ssm] phase 6g passed in {time.perf_counter() - t0:.1f} s; kernel launches "
        f"{out['launches']} ({card})")
    return out


# -- phase 6h: the VLM and the audio encoder-decoder --------------------------------

# internvl2-76b at its published widths (d 8192, GQA 64/8, d_ff 28 672, RoPE,
# RMSNorm, SwiGLU), its decoder cut to 1 of 80 layers and its stub patches to
# 32 of 256, re-based as fed_train's family_configs re-bases a family (the
# GPT-2 exchange vocabulary, GPT-2 small's LoRA), in the main path's fp32 (its
# AdamW moments too, which the published config keeps in bf16).  At 2 layers
# its pretraining step ran out of the card's 80 GB: at its peak the
# functional AdamW holds the parameters, the gradients and their clipped copy,
# the old and the new moments and the new parameters, 8 fp32 copies of the
# model (81 GB at 2.53 B parameters; 54 GB at 1 layer's 1.68 B).
INTERNVL2 = get_config("internvl2-76b").with_overrides(
    name="fam-internvl2-76b", num_layers=1, frontend_len=32, vocab_size=GPT2_SMALL.vocab_size,
    lora=GPT2_SMALL.lora, param_dtype="float32", compute_dtype="float32",
    optimizer_state_dtype="float32", remat=False)
# seamless-m4t-large-v2 at its published widths and depth (24 + 24 layers, d
# 1024, 16 heads, d_ff 8192), its stub frames cut to 32 of 1024, re-based alike
SEAMLESS = get_config("seamless-m4t-large-v2").with_overrides(
    name="fam-seamless-m4t-large-v2", frontend_len=32, vocab_size=GPT2_SMALL.vocab_size,
    lora=GPT2_SMALL.lora, param_dtype="float32", compute_dtype="float32", remat=False)
# (c) and (e): each family alone at its published widths and vocabulary.
# seamless carries GPT-2 small's LoRA, whose adapters the tenants of (e)
# replace; init draws in fp32 whatever the dtype, so its bf16 parameters are
# its fp32 ones rounded.  internvl2 is cut to 8 of its 80 layers (18 GB).
SEAMLESS_ALONE = get_config("seamless-m4t-large-v2").with_overrides(lora=GPT2_SMALL.lora,
                                                                   remat=False)
SEAMLESS_ALONE_FP32 = SEAMLESS_ALONE.with_overrides(param_dtype="float32", compute_dtype="float32")
INTERNVL2_ALONE = get_config("internvl2-76b").with_overrides(num_layers=8, remat=False)
MODAL_RUNS = (("fused_e2e", False), ("fused", False))
# seamless's bf16 decode against its bf16 forward: DECODE_TOL plus this many
# bf16 ulps of the largest logit.  Each of its 24 decoder layers rounds three
# residual adds to bf16, and its cross-attention sums 1 024 frames in GEMMs of
# other shapes in the forward (16 queries) and in decode (1); on an H100 80GB
# HBM3 two sets of prompts measured 4.0 and 4.6 ulps, at and over mamba's
# bound of 4.  The fp32 decode of (e) is held within DECODE_TOL itself.
BF16_AUDIO_DECODE_ULPS = 8
FAMILIES_MODAL_CLI = "gpt2-paper,internvl2-76b,seamless-m4t-large-v2"


def prefill_flops(cfg, batch: int, tokens: int) -> float:
    """The floating-point operations of a prefill of ``tokens`` text
    positions a sequence: 2 per multiply-add of every projection over the
    positions that run it (a VLM's patches too, an audio model's frames
    through the encoder and the decoder's cross K/V), 4 · S_q · S_k · H ·
    Dh a layer for the scores and their product with V (every pair, as the
    plain attention computes them before it masks), and the head on the
    last position only."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
    mlp = d * cfg.d_ff * (3 if cfg.activation == "swiglu" else 2)
    pairs = lambda q, k: 4 * q * k * cfg.num_heads * hd  # noqa: E731
    f = cfg.frontend_len if cfg.frontend != "none" else 0
    dec = tokens + (f if cfg.family == "vlm" else 0)
    ops = cfg.num_layers * (2 * (attn + mlp) * dec + pairs(dec, dec))
    if cfg.family == "audio":
        ops += cfg.encoder_layers * (2 * (attn + mlp) * f + pairs(f, f))
        ops += cfg.num_layers * (2 * d * cfg.num_heads * hd * 2 * tokens
                                 + 2 * d * cfg.num_kv_heads * hd * 2 * f + pairs(tokens, f))
    return batch * (ops + 2 * d * cfg.vocab_size)


def audio_decode_fp32(device, cfg, backbone) -> float:
    """(e) part 1: seamless at its published widths in fp32, 16 decode steps
    at batch 8 over its 1 024 frames against its forward, within
    ``DECODE_TOL``."""
    tokens = torch.as_tensor(np.random.default_rng(53).integers(
        0, cfg.vocab_size, (SERVE_BATCH, DECODE_STEPS)), device=device)
    frames = frontends.synth_frontend_embeddings(cfg, SERVE_BATCH, device=device)
    with torch.no_grad():
        _, errs, scale = decode_steps(backbone, cfg, tokens, frames, device)
    assert max(errs) <= DECODE_TOL, (errs, DECODE_TOL)
    log(f"[modal decode] {cfg.name} fp32 (TF32 off), {cfg.frontend_len} frames: "
        f"{DECODE_STEPS} decode steps within {max(errs):.3e} of the forward (bound "
        f"{DECODE_TOL}, largest logit {scale:.3f})")
    return max(errs)


def phase_modal(device, card: str = "", cfgs=None) -> dict:
    """Phase 6h: the VLM and the audio encoder-decoder (module docstring).
    ``cfgs`` = ``(vlm fleet, audio fleet, server, dataset, audio alone)``
    replaces the full-width models: a rehearsal at small widths on the CPU
    runs (a), (b), the CLI run of (d) and the serving of (e)."""
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    cached = set(fed_pretrain._CACHE)
    if cfgs is None:
        ds = make_banking77_like(vocab_size=GPT2_SMALL.vocab_size, seq_len=32)
        cfgs = ([GPT2_SMALL, INTERNVL2], [GPT2_SMALL, SEAMLESS], FAULT_SERVER, ds,
                SEAMLESS_ALONE_FP32)
    vlm, audio, server_cfg, ds, alone = cfgs
    out = family_runs(device, (vlm, server_cfg, ds), card, runs=MODAL_RUNS, label="modal vlm")
    out["audio"] = family_runs(device, (audio, server_cfg, ds), card, label="modal audio")
    del out["audio"]["runs"]["client1"]
    out["block"] = family_block(device, (audio, server_cfg, ds), out["audio"]["runs"], card,
                                label="modal audio")
    for name, n in out["block"]["launches"].items():
        out["audio"]["launches"][name] = out["audio"]["launches"].get(name, 0) + n
    for name, n in out.pop("audio")["launches"].items():
        out["launches"][name] = out["launches"].get(name, 0) + n
    for key in set(fed_pretrain._CACHE) - cached:  # the phase's backbones
        del fed_pretrain._CACHE[key]
    gc.collect()
    backbone = None
    if on_card:
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        params = model.init(INTERNVL2_ALONE, 0, device)
        log(f"[modal] {INTERNVL2_ALONE.name} at {INTERNVL2_ALONE.num_layers} layers drawn in "
            f"{time.perf_counter() - t1:.1f} s ({INTERNVL2_ALONE.param_count() / 1e9:.2f} B "
            f"parameters, bf16)")
        text = model.input_token_len(INTERNVL2_ALONE, PREFILL_S)  # its patches take the rest
        out["alone"] = {"internvl2": time_model(
            device, INTERNVL2_ALONE, params, card, "modal internvl2-76b", None,
            prefill_flops(INTERNVL2_ALONE, SERVE_BATCH, text))}
        del params
        gc.collect()
        torch.cuda.empty_cache()
        backbone = model.init(alone, 0, device)
        rounded = {k: v.to(torch.bfloat16) for k, v in backbone.items()}
        out["alone"]["seamless"] = time_model(
            device, SEAMLESS_ALONE, rounded, card, "modal seamless-m4t-large-v2",
            BF16_AUDIO_DECODE_ULPS, prefill_flops(SEAMLESS_ALONE, SERVE_BATCH, PREFILL_S))
        del rounded
        gc.collect()
        torch.cuda.empty_cache()
    for name, n in families_cli(device, FAMILIES_MODAL_CLI, "modal").items():
        out["launches"][name] = out["launches"].get(name, 0) + n
    for key in set(fed_pretrain._CACHE) - cached:
        del fed_pretrain._CACHE[key]
    if backbone is None:
        backbone = model.init(alone, 0, device)
    out["decode_fp32"] = audio_decode_fp32(device, alone, backbone)
    out["serving"] = serve_tenants(device, card, alone, backbone, "modal serving")
    del backbone
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    log(f"[modal] phase 6h passed in {time.perf_counter() - t0:.1f} s; kernel launches "
        f"{out['launches']} ({card})")
    return out


# -- phase 9: the production mesh ---------------------------------------------------

# (a)'s models on a 1x1 mesh: yi-9b at its published widths cut to MESH_YI_LAYERS
# layers, mamba2-130m and granite-moe-1b-a400m whole; each train step, prefill and
# MESH_DECODE decode steps at (MESH_BATCH, MESH_SEQ): the chunked attention
# (S >= 1024) and two cross-entropy chunks, each recomputed in the backward pass
MESH_YI_LAYERS, MESH_BATCH, MESH_SEQ, MESH_DECODE = 4, 4, 1024, 4
# (b): the dry run's combos on the card machine, each in a process of its own
MESH_DRYRUNS = (("yi-9b", "train_4k", False), ("yi-9b", "train_4k", True),
                ("mamba2-130m", "long_500k", False), ("granite-moe-1b-a400m", "decode_32k", False))
# (a)'s tolerances against the plain steps' values: on one rank the DTensor
# steps run the plain op sequence but for the one-hot embedding, whose
# backward sums in another order than the gather's; each value is reported
# bitwise where it is.  Losses and logits are held within two bf16 ulps of
# their largest magnitude; each parameter leaf after one AdamW step within
# MESH_UPDATE_RTOL of its update, ||got - want|| / ||want - p0|| (as
# tests/test_torch_mesh_step.py holds the 2x2 steps): a missing update, or
# one wrong in sign, reads ~1.  A leaf the plain step leaves unchanged (bf16
# values an update of lr = 3e-4 does not move) is held bitwise
MESH_BF16_ULP = 2.0**-8
MESH_UPDATE_RTOL = 1e-2


# (d), in (a)'s process: each model's train step with cfg.remat and without (the
# latter twice, for its run-to-run spread), at (a)'s batch and tokens: (a)'s models
# and a hybrid of ONE period of jamba-1.5-large-398b's layout (attention every 8 at
# offset 4, MoE every 2 at offset 1, SSD state 128, head 64, expand 2, vocab 65 536,
# bf16, as published), cut in depth, width and experts; the loss and each
# parameter leaf held to the plain step's by (a)'s bounds
REMAT_HYBRID = dict(num_layers=8, d_model=2048, num_heads=16, num_kv_heads=2, d_ff=6144)
REMAT_HYBRID_EXPERTS = 4


def mesh_models() -> dict:
    return {"yi-9b": get_config("yi-9b").with_overrides(num_layers=MESH_YI_LAYERS),
            "mamba2-130m": get_config("mamba2-130m"),
            "granite-moe-1b-a400m": get_config("granite-moe-1b-a400m")}


def remat_models() -> dict:
    jamba = get_config("jamba-1.5-large-398b")
    hybrid = jamba.with_overrides(**REMAT_HYBRID, moe=dataclasses.replace(
        jamba.moe, num_experts=REMAT_HYBRID_EXPERTS, d_ff=REMAT_HYBRID["d_ff"]))
    return {**mesh_models(), "jamba-1.5-large-398b": hybrid}


def config_cuts(arch: str, cfg) -> str:
    """Every field of ``cfg`` that differs from ``arch``'s published config,
    ``field published -> here``."""
    def flat(c, pre=""):
        out = {}
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            out.update(flat(v, f"{pre}{f.name}.") if dataclasses.is_dataclass(v)
                       else {pre + f.name: v})
        return out

    pub, got = flat(get_config(arch)), flat(cfg)
    return ", ".join(f"{k} {pub.get(k)} -> {v}" for k, v in got.items()
                     if v != pub.get(k)) or "none"


def mesh_shape() -> ShapeConfig:
    return ShapeConfig("mesh_train", MESH_SEQ, MESH_BATCH, "train")


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def mesh_run(cfg, device, mesh=None) -> dict:
    """``cfg``'s train step (``make_train_step``), prefill and
    ``MESH_DECODE`` decode steps from an empty cache on ``init(cfg, 0)``:
    plain, or every argument placed on ``mesh`` by the spec rules with the
    activation rules installed.  Returns the loss, the updated parameters,
    the prefill and decode logits (plain tensors) and, for the train step,
    its argument bytes, its peak above the memory held before its
    arguments, and what ``StepAccounting`` counted."""
    from repro_torch.launch.dryrun import StepAccounting

    base = torch.cuda.memory_allocated() if device.type == "cuda" else 0
    params = model.init(cfg, 0, device)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MESH_BATCH, MESH_SEQ)).astype(np.int32), device=device)
    opt = init_train_opt(params, cfg)
    batch = {"tokens": tokens}
    cache = model.init_cache(cfg, MESH_BATCH, MESH_SEQ, device=device)
    if mesh is not None:
        pspecs = sharding.param_specs(params, mesh)
        params = sharding.distribute_tree(params, pspecs, mesh)
        opt = sharding.distribute_tree(opt, sharding.opt_state_specs(pspecs), mesh)
        batch = sharding.distribute_tree(batch, sharding.batch_specs(mesh, with_labels=False),
                                         mesh)
        cache = sharding.distribute_tree(cache, sharding.cache_specs(cache, mesh), mesh)
    out = {"arg_bytes": sharding.local_bytes((params, opt, batch))}
    if mesh is None:
        out["init"] = params  # the step is functional: its inputs stay as they are
    ctx = sharding.on_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with StepAccounting() as acc:
            new_p, _, metrics = make_train_step(cfg)(params, opt, batch)
            out["loss"] = _full(metrics["loss"]).float()
        sync(device)
        out["peak"] = (torch.cuda.max_memory_allocated() - base) if device.type == "cuda" else 0
        out["flops"], out["collectives"] = acc.flops, acc.record()[1]
        out["params"] = {k: _full(v) for k, v in new_p.items()}
        del new_p, opt
        out["prefill"] = _full(make_prefill_step(cfg)(params, batch))
        decode = make_serve_step(cfg)
        logits = []
        for t in range(MESH_DECODE):
            tok = tokens[:, t]
            if mesh is not None:
                tok = sharding.distribute_tree(tok, (sharding.batch_axes(mesh),), mesh)
            step_logits, cache = decode(params, cache, tok)
            logits.append(_full(step_logits))
        out["decode"] = torch.stack(logits)
    return out


def mesh_diff(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, float]:
    """(bitwise equal, max |got - want|) in fp32."""
    return torch.equal(got, want), float((got.float() - want.float()).abs().max())


def update_rel(got: torch.Tensor, want: torch.Tensor, p0: torch.Tensor) -> float:
    """``||got - want|| / ||want - p0||`` in fp32: a parameter's distance
    from the plain step's over the plain step's update (0 where both are
    equal, inf where the plain step moved nothing and ``got`` moved)."""
    err = float(torch.linalg.vector_norm(got.float() - want.float()))
    step = float(torch.linalg.vector_norm(want.float() - p0.float()))
    return err / step if step else (0.0 if err == 0 else math.inf)


def remat_run(cfg, params, opt, tokens, device) -> dict:
    """``cfg``'s gradient pass alone (``full_grads`` of the train loss on
    the step's first microbatch), then its train step (``make_train_step``),
    each from ``torch.cuda.reset_peak_memory_stats()``: the loss, the
    updated parameters, the step's ms (host clock ending in a sync) and each
    one's peak, ``max_memory_allocated`` less the memory held before the
    run plus the step's arguments (what an earlier run left on the card
    does not count)."""
    cuda = device.type == "cuda"
    m = cfg.microbatches if tokens.shape[0] % cfg.microbatches == 0 else 1
    args = sharding.local_bytes((params, opt, tokens))
    sync(device)
    base = torch.cuda.memory_allocated() if cuda else 0

    def peak() -> int:
        return torch.cuda.max_memory_allocated() - base + args if cuda else 0

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _, grads = full_grads(make_train_loss(cfg), params, tokens[:tokens.shape[0] // m])
    sync(device)
    grad_peak = peak()
    del grads
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new_p, _, metrics = make_train_step(cfg)(params, opt, {"tokens": tokens})
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0)
    return {"loss": metrics["loss"].float(), "ms": ms, "grad_peak": grad_peak, "peak": peak(),
            "rows": tokens.shape[0] // m, "params": new_p}


def remat_check(models: dict, device, card: str) -> None:
    """(d): each model's train step with remat against it without; fails
    where a loss or a parameter leaf leaves (a)'s bounds, or where the
    remat'd gradient pass does not peak lower on the card."""
    gib = 1024**3
    for arch, cfg in models.items():
        t_model = time.perf_counter()
        params = model.init(cfg, 0, device)
        opt = init_train_opt(params, cfg)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (MESH_BATCH, MESH_SEQ)).astype(np.int32), device=device)
        off, on = cfg.with_overrides(remat=False), cfg.with_overrides(remat=True)
        plain = remat_run(off, params, opt, tokens, device)
        n, runs, report = len(plain["params"]), {}, {}
        for name, c in (("remat", on), ("again", off)):  # held to the first plain step's
            run = remat_run(c, params, opt, tokens, device)
            equal, err = mesh_diff(run["loss"], plain["loss"])
            tol = 2 * MESH_BF16_ULP * float(plain["loss"].abs())
            assert name == "again" or err <= tol, (arch, "loss", err, tol)
            worst, worst_key, unequal = 0.0, "", 0
            for k, w in plain["params"].items():
                rel = update_rel(run["params"][k], w, params[k])
                assert name == "again" or rel <= MESH_UPDATE_RTOL, (arch, k, rel)
                unequal += not torch.equal(run["params"][k], w)
                if rel > worst:
                    worst, worst_key = rel, k
            report[name] = ("loss bitwise" if equal else f"loss off by {err:.3g} (bound {tol:.3g})"
                            ) + ", " + (f"{n} leaves bitwise" if not unequal else
                                        f"{unequal} of {n} leaves not bitwise, the largest off "
                                        f"by {worst:.3g} of its update ({worst_key})")
            del run["params"]
            runs[name] = run
        remat, again = runs["remat"], runs["again"]
        if device.type == "cuda":
            assert remat["grad_peak"] < min(plain["grad_peak"], again["grad_peak"]), (
                arch, remat["grad_peak"], plain["grad_peak"], again["grad_peak"])
        log(f"[production mesh (d) {arch}] {cfg.num_layers} layers, d {cfg.d_model}, batch "
            f"{MESH_BATCH}, seq {MESH_SEQ}, one train step with remat against without (twice); "
            f"cuts from the published config: {config_cuts(arch, cfg)}; remat: "
            f"{report['remat']} (bound {MESH_UPDATE_RTOL:g} of the update); plain twice: "
            f"{report['again']}; max_memory_allocated GiB, step: remat "
            f"{remat['peak'] / gib:.3f}, plain {plain['peak'] / gib:.3f} / "
            f"{again['peak'] / gib:.3f}; gradient pass (a microbatch of {remat['rows']} rows): "
            f"remat {remat['grad_peak'] / gib:.3f}, "
            f"plain {plain['grad_peak'] / gib:.3f} / {again['grad_peak'] / gib:.3f}; ms a step: "
            f"remat {remat['ms']:.1f}, plain {plain['ms']:.1f} / {again['ms']:.1f}; "
            f"{time.perf_counter() - t_model:.1f} s; {card}")
        del plain, runs, remat, again, params, opt
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def _dryrun_at_one(out: str, cfg, shape, device_type: str) -> None:
    """The dry run of ``cfg``'s train step at ``shape`` on a 1x1 mesh over a
    fake world of one rank (a process of its own): its record's parts."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    dryrun.start_fake_world(1)
    rec = dryrun.trace_combo(cfg.name, shape, make_host_mesh((1, 1), device=device_type),
                             cfg_override=cfg)
    with open(out, "w") as f:
        json.dump({k: rec[k] for k in ("memory", "cost", "collectives", "lower_s")}, f)


def _mesh_steps_at_one(out: str, models: dict, remat: dict, device_type: str, card: str,
                       seq: int) -> None:
    """(a) in a process of its own, on a one-rank group of its own (NCCL on
    the card), so that no state an earlier phase left reaches it: each
    model's steps on a 1x1 mesh against its plain steps.  Writes the first
    model's train-step flops, argument bytes and peak to ``out`` for (c).
    Then (d), the ``remat`` models' train steps with remat and without."""
    global MESH_SEQ
    from repro_torch.launch.mesh import make_host_mesh

    MESH_SEQ = seq
    device = torch.device(device_type)
    if device.type == "cuda":
        exact_matmuls()
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_host_mesh((1, 1), device=device.type)
        first, real = next(iter(models)), None
        for name, cfg in models.items():
            t_model = time.perf_counter()
            want = mesh_run(cfg, device)
            got = mesh_run(cfg, device, mesh)
            report = {}
            for key in ("loss", "prefill", "decode"):
                equal, err = mesh_diff(got[key], want[key])
                tol = 2 * MESH_BF16_ULP * float(want[key].float().abs().max())
                assert err <= tol, (name, key, err, tol)
                report[key] = "bitwise" if equal else f"{err:.3g} (bound {tol:.3g})"
            worst, worst_key, unequal = 0.0, "", 0
            for k, w in want["params"].items():
                rel = update_rel(got["params"][k], w, want["init"][k])
                assert rel <= MESH_UPDATE_RTOL, (name, k, rel)
                unequal += not torch.equal(got["params"][k], w)
                if rel > worst:
                    worst, worst_key = rel, k
            report["params"] = (f"{len(want['params'])} leaves bitwise" if not unequal else
                                f"{unequal} of {len(want['params'])} leaves not bitwise, the "
                                f"largest off by {worst:.3g} of its update ({worst_key}; "
                                f"bound {MESH_UPDATE_RTOL:g})")
            log(f"[production mesh (a) {name}] {cfg.num_layers} layers, d {cfg.d_model}, batch "
                f"{MESH_BATCH}, seq {MESH_SEQ}, {MESH_DECODE} decode steps, on a 1x1 mesh "
                f"({dist.get_backend()}) against the plain steps: loss {float(got['loss']):.6f} "
                f"({report['loss']}), updated parameters {report['params']}, prefill logits "
                f"{report['prefill']}, decode logits {report['decode']}; train step "
                f"{got['flops'] / 1e12:.3f} TFLOP, collectives {got['collectives']['count']}; "
                f"{time.perf_counter() - t_model:.1f} s; {card}")
            if name == first:
                real = {k: got[k] for k in ("flops", "arg_bytes", "peak")}
            del want, got
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        with open(out, "w") as f:
            json.dump(real, f)
        remat_check(remat, device, card)
    finally:
        dist.destroy_process_group()


def start_mesh_dryruns(device_type: str, dryruns=MESH_DRYRUNS) -> tuple[str, dict]:
    """(b)'s dry runs, each ``python -m repro_torch.launch.dryrun`` in a
    process of its own writing its record and its output to a new temp
    directory: ``(the directory, {combo: process})``.  They take host cores
    and no card, so the smoke starts them ahead of phase 9, beside phases
    6f-6h; :func:`stop_mesh_dryruns` ends them."""
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    dry = {}
    for arch, shape, multi in dryruns:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--out", tmp, "--device", device_type] + (["--multi-pod"] if multi else [])
        with open(os.path.join(tmp, f"{arch}__{shape}__{multi}.log"), "w") as out:
            dry[(arch, shape, multi)] = subprocess.Popen(cmd, env=env, stdout=out,
                                                         stderr=subprocess.STDOUT)
    return tmp, dry


def stop_mesh_dryruns(tmp: str, dry: dict) -> None:
    for proc in dry.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def phase_production_mesh(device, card: str = "", models: dict | None = None,
                          dryruns=MESH_DRYRUNS, remat: dict | None = None,
                          started: tuple[str, dict] | None = None) -> None:
    """Phase 9 (see the module docstring).  ``models`` replaces (a)'s
    (``mesh_models()``; the first is the one (c) holds), ``dryruns``
    (b)'s combos and ``remat`` (d)'s models (``remat_models()``): a
    rehearsal on the CPU at tiny widths.  ``started``: (b)'s dry runs from
    :func:`start_mesh_dryruns`, else the phase starts them."""
    t0 = time.perf_counter()
    device = torch.device(device)
    models = models or mesh_models()
    remat = remat or remat_models()
    first = next(iter(models))
    tmp, dry = started if started is not None else start_mesh_dryruns(device.type, dryruns)
    spawn = torch_mp.get_context("spawn")
    one = spawn.Process(
        target=_dryrun_at_one,
        args=(os.path.join(tmp, "one.json"), models[first], mesh_shape(), device.type))
    one.start()
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the card's memory this process holds idle goes to (a)
    steps = spawn.Process(target=_mesh_steps_at_one,
                          args=(os.path.join(tmp, "steps.json"), models, remat, device.type,
                                card, MESH_SEQ))
    steps.start()
    try:
        # (a) the 1x1 mesh over NCCL: each model's steps on DTensors against the plain steps
        steps.join(timeout=900)
        assert steps.exitcode == 0, ("(a)", steps.exitcode)
        with open(os.path.join(tmp, "steps.json")) as f:
            yi_real = json.load(f)

        # (b) the dry runs of the production meshes
        gib = 1024**3
        for (arch, shape, multi), proc in dry.items():
            proc.wait(timeout=900)
            with open(os.path.join(tmp, f"{arch}__{shape}__{multi}.log")) as f:
                assert proc.returncode == 0, (arch, shape, multi, f.read()[-3000:])
            mesh_name = "multi_pod" if multi else "single_pod"
            with open(os.path.join(tmp, f"{arch}__{shape}__{mesh_name}.json")) as f:
                rec = json.load(f)
            mem, coll = rec["memory"], rec["collectives"]
            args_b = mem["argument_size_in_bytes"]
            peak_b = args_b + mem["temp_size_in_bytes"]
            log(f"[production mesh (b) {arch} x {shape} x {mesh_name}] {rec['chips']} ranks: "
                f"per device arguments {args_b / gib:.3f} GiB, peak {peak_b / gib:.3f} GiB of the "
                f"card's {H100['hbm_bytes'] / gib:.0f} GiB, {rec['cost']['flops'] / 1e12:.3f} "
                f"TFLOP, collectives GB " + ", ".join(
                    f"{k} {v / 1e9:.3f}" for k, v in coll.items() if k != "count")
                + f" ({coll['count']} ops), trace {rec['lower_s']:.1f} s")

        # (c) the dry run at (a)'s 1x1 mesh against (a)'s real yi-9b train step
        one.join(timeout=900)
        assert one.exitcode == 0, one.exitcode
        with open(os.path.join(tmp, "one.json")) as f:
            est = json.load(f)
        args_b = est["memory"]["argument_size_in_bytes"]
        peak_est = args_b + est["memory"]["temp_size_in_bytes"]
        assert est["cost"]["flops"] == yi_real["flops"], (est["cost"]["flops"], yi_real["flops"])
        assert args_b == yi_real["arg_bytes"], (args_b, yi_real["arg_bytes"])
        ratio = peak_est / yi_real["peak"] if device.type == "cuda" else float("nan")
        log(f"[production mesh (c) {first} train step, 1x1] the dry run's flops "
            f"{est['cost']['flops'] / 1e12:.3f} TFLOP and argument bytes {args_b} equal the real "
            f"step's; its peak {peak_est / gib:.3f} GiB beside torch.cuda.max_memory_allocated "
            f"{yi_real['peak'] / gib:.3f} GiB: ratio {ratio:.3f} (trace {est['lower_s']:.1f} s); "
            f"{card}")
        assert ratio >= 0.8 or device.type != "cuda", ratio
    finally:
        for proc in (one, steps):
            if proc.is_alive():
                proc.kill()
                proc.join()
        stop_mesh_dryruns(tmp, dry)
    log(f"[production mesh] phase 9 passed in {time.perf_counter() - t0:.1f} s ({card})")


def phase_serving(device, card: str) -> dict:
    """Multi-tenant serving at GPT-2 small width, then the prefill at
    S = 1024 and the attention kernel on its layer-0 q/k/v; returns the
    kernel's entry launches and those q/k/v for the timing phase."""
    t0 = time.perf_counter()
    backbone = model.init(GPT2_SMALL, 0, device)
    lora, frozen = split_lora(backbone)
    rows = tenant_rows(lora, TENANTS, seed=17, device=device)
    store = DeviceFleetStore(rows, [frozen] * TENANTS, shared=True)
    src = export_adapters(store)
    params = serving_params(src, model.init(GPT2_SMALL, 1, device))
    cache = AdapterCache(src, like=lora_template(params), slots=SLOTS, device=device)
    sess = ServeSession(ServeConfig(model=GPT2_SMALL, batch=SERVE_BATCH, cache_len=128), params,
                        adapters=cache, device=device)
    prompts = np.random.default_rng(23).integers(0, VOCAB, (SERVE_BATCH, PROMPT)).astype(np.int32)
    log(f"[serving] GPT-2 small backbone + {TENANTS} tenant adapters in a DeviceFleetStore, "
        f"AdapterCache of {SLOTS} slots, batch {SERVE_BATCH}: set up in "
        f"{time.perf_counter() - t0:.1f} s")
    # the reference's LRU rules: duplicates count once a batch, the LRU unpinned slot goes
    mixes = [([0, 1, 1, 2, 3, 3, 0, 2], dict(hits=0, misses=4, evictions=0, lookups=1)),
             ([4, 2, 4, 5, 2, 6, 5, 6], dict(hits=1, misses=7, evictions=3, lookups=2))]
    ops.reset_launches()
    for ids, want in mixes:
        sess.attach(ids)
        assert cache.stats.as_dict() == want, (cache.stats.as_dict(), want)
        assert set(cache.resident()) == set(ids)
        sess.prefill(prompts)
        t0 = time.perf_counter()
        toks, _ = sess.decode(GEN)  # every step ends in a device sync
        step_s = (time.perf_counter() - t0) / GEN
        # the stacked run again on its own tokens, its logits at every step
        sess.reset()
        stacked = [sess.prefill(prompts)] + [sess.step(toks[:, i]) for i in range(GEN)]
        worst, agree = 0.0, 0
        for b, cid in enumerate(ids):
            solo = ServeSession(ServeConfig(model=GPT2_SMALL, batch=1, cache_len=128),
                                merge_lora(rows[cid], frozen), device=device)
            logits = [solo.prefill(prompts[b:b + 1])] + [solo.step(toks[b:b + 1, i])
                                                          for i in range(GEN)]
            for i, (lo, st) in enumerate(zip(logits, stacked)):
                err = float((lo[0] - st[b]).abs().max() / st[b].abs().max())
                assert err <= 1e-4, ("stacked vs solo", ids, b, i, err)
                worst = max(worst, err)
                agree += int(i < GEN and int(torch.argmax(lo[0])) == int(toks[b, i]))
        log(f"[serving] tenants {ids}: cache stats {cache.stats.as_dict()}, resident "
            f"{list(cache.resident())}; stacked decode vs each request alone with its merged "
            f"adapter over {GEN + 1} steps: max |diff|/max|logit| {worst:.3e}; solo greedy tokens "
            f"agreeing with the stacked run {agree}/{SERVE_BATCH * GEN}")
        log(f"[serving] decode step {step_s * 1e3:.3f} ms over {GEN} greedy steps (host clock), "
            f"{SERVE_BATCH / step_s:.1f} tokens/s (batch {SERVE_BATCH}, {card})")
    assert sum(ops.LAUNCHES.values()) == 0, ops.LAUNCHES  # no kernel on the serving path

    tokens = torch.as_tensor(
        np.random.default_rng(29).integers(0, VOCAB, (SERVE_BATCH, PREFILL_S)), device=device)
    prefill = make_prefill_step(GPT2_SMALL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert tuple(logits.shape) == (SERVE_BATCH, VOCAB) and bool(torch.isfinite(logits).all())
    assert sum(ops.LAUNCHES.values()) == 0, ops.LAUNCHES
    with torch.no_grad():  # layer 0's q, k, v of that prefill, and its chunked attention
        x = embedding(params["embed"], tokens[None]) + params["pos_embed"][:PREFILL_S]
        lp = layer_slice(params, 0, 0)
        q, k, v, _ = attention.qkv(lp, layer_norm(x, lp["norm1/scale"], lp["norm1/bias"]),
                                   GPT2_SMALL)
        chunked = attention._chunked_attention(q, k, v)
    heads = lambda t: t.permute(0, 2, 1, 3).contiguous()  # noqa: E731  (B, H, S, D)
    qh, kh, vh = heads(q), heads(k), heads(v)
    ops.reset_launches()
    got = ops.flash_attention(qh, kh, vh)
    torch.cuda.synchronize()
    entry = dict(ops.LAUNCHES)
    assert entry["flash_attention"] == 1 and sum(entry.values()) == 1, entry
    try:
        ops.flash_attention(qh.clone().requires_grad_(True), kh, vh)
    except RuntimeError as e:
        assert "forward only" in str(e)
    else:
        raise AssertionError("the forward-only attention kernel accepted a q that requires grad")
    want = heads(chunked.reshape(q.shape))
    plain = ref.flash_attention_ref(*(t.reshape(-1, PREFILL_S, q.shape[-1]) for t in (qh, kh, vh)))
    tol = attention_tolerance(PREFILL_S, vh)
    err_chunked = float((got - want).abs().max())
    err_plain = float((got - plain.reshape(got.shape)).abs().max())
    assert err_chunked <= tol and err_plain <= tol, (err_chunked, err_plain, tol)
    log(f"[prefill] make_prefill_step at ({SERVE_BATCH}, {PREFILL_S}) (chunked attention, "
        f"Q_CHUNK {attention.Q_CHUNK}) in {dt * 1e3:.1f} ms; flash_attention on layer 0's q/k/v "
        f"{tuple(qh.shape)}: max |diff| {err_chunked:.3e} against the chunked attention, "
        f"{err_plain:.3e} against its plain version (bound {tol:.3e}); kernel launches {entry}; "
        f"a q that requires grad raises")
    # the bf16 and fp16 kernels through the same entry point, on that q/k/v rounded
    out = {"entry_launches": entry, "qkv": (qh, kh, vh)}
    for dtype in (BF16, F16):
        name = "flash_attention" + TAG[dtype]
        qb, kb, vb = (t.to(dtype) for t in (qh, kh, vh))
        ops.reset_launches()
        got = ops.flash_attention(qb, kb, vb)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == 1 and sum(ops.LAUNCHES.values()) == 1
        entry[name] = 1
        plain_16 = ref.flash_attention_ref(*(t.reshape(-1, PREFILL_S, q.shape[-1]) for t in (qb, kb, vb)))
        err_16 = within_16(got, plain_16.reshape(got.shape), attention_tolerance(PREFILL_S, vb))
        log(f"[prefill] flash_attention on that q/k/v in {dtype}: max |diff| {err_16:.3e} against its "
            f"plain version (bound S * 2^-24 * max|v| + one ulp); kernel launches {dict(ops.LAUNCHES)}")
        out["qkv" + TAG[dtype].replace(".", "_")] = (qb, kb, vb)
    del sess, cache, store, src, params, backbone
    gc.collect()
    torch.cuda.empty_cache()
    out.update(check_yi_prefill_attention(device, card))
    return out


def yi_layer0_qkv(device, seq: int = YI_S, cfg=None):
    """yi-9b's layer-0 q, k, v (after RoPE) on ``seq`` random tokens, from
    the port's own init of one layer at the published widths, in fp32:
    ``(1, seq, 32, 128)`` q, ``(1, seq, 4, 128)`` k and v."""
    cfg = cfg or get_config("yi-9b").with_overrides(num_layers=1, param_dtype="float32",
                                                    compute_dtype="float32")
    params = model.init(cfg, 31, device)
    tokens = torch.as_tensor(np.random.default_rng(37).integers(0, cfg.vocab_size, (1, seq)),
                             device=device)
    with torch.no_grad():
        lp = layer_slice(params, 0, 0)
        x = norm_apply(lp, "norm1", embedding(params["embed"], tokens[None]), cfg.norm)
        q, k, v, _ = attention.qkv(lp, x, cfg)
        pos = torch.arange(seq, device=device)
        return apply_rope(q, pos, theta=cfg.rope_theta), apply_rope(k, pos, theta=cfg.rope_theta), v


def attention_work(bh: int, seq: int, d: int, dtype: torch.dtype,
                   pieces: int = 2) -> tuple[int, int, float]:
    """The attention's bytes (q, k, v read once, out written once), its
    operations on the tensor cores and their rate.  The causal half of
    q k^T and of p v is S^2 * D operations each a head-batch.  fp32: each
    product at fp32 grade is three TF32 products.  bf16 (fp16): q k^T is
    one 16-bit product (exact in fp32) and p v ``pieces``, p split into that
    many 16-bit pieces (the kernels' two unless said), at the 16-bit rate."""
    ops_done = 2 * seq * seq * d * bh
    io_bytes = 4 * bh * seq * d * torch.finfo(dtype).bits // 8
    if dtype == torch.float32:
        return io_bytes, TF32_SPLIT * ops_done, TF32_OPS_PER_S
    return io_bytes, (1 + pieces) * ops_done // 2, BF16_OPS_PER_S


def attention_bound_ms(bh: int, seq: int, d: int, dtype: torch.dtype) -> float:
    """The attention's least time on the card, as its timing row counts it."""
    return bound(*attention_work(bh, seq, d, dtype))[0]


def check_yi_prefill_attention(device, card: str, seq: int = YI_S, cfg=None,
                               heads=YI_HEADS) -> dict:
    """yi-9b's layer-0 attention at (1, ``seq``), 32 query heads over 4 K/V
    heads, D 128: K and V repeated to the 32 heads and passed through
    ``ops.flash_attention`` in fp32, bf16 and fp16 (the D = 128 kernels,
    one launch each), each held against the model's own chunked GQA
    attention of that layer (on the q/k/v rounded to the dtype; fp32 math,
    rounded once) and against the plain version on the sampled head-batches
    ``heads``, one at a time, under the same bounds; each kernel timed
    beside its bound.  Returns the launches (``entry_d128``) and the fp32
    and bf16 q/k/v for the timing phase, on the host."""
    t0 = time.perf_counter()
    q, k, v = yi_layer0_qkv(device, seq, cfg)
    h_q, group = q.shape[2], q.shape[2] // k.shape[2]
    heads_first = lambda t: t.permute(0, 2, 1, 3).contiguous()  # noqa: E731  (B, H, S, D)
    qh = heads_first(q)
    kh, vh = (heads_first(t.repeat_interleave(group, dim=2)) for t in (k, v))
    log(f"[prefill 32k] yi-9b layer 0 at its published widths (d {q.shape[2] * q.shape[3]}, "
        f"{h_q} query heads over {k.shape[2]} K/V heads, D {q.shape[3]}, RoPE): q/k/v at (1, {seq}) "
        f"in {time.perf_counter() - t0:.1f} s (the dry run's prefill_32k batch of 32 cut to 1)")
    out, entry = {}, {}
    for dtype in (torch.float32, BF16, F16):
        name = "flash_attention" + TAG[dtype] + D128
        qd, kd, vd = (t.to(dtype) for t in (qh, kh, vh))
        ops.reset_launches()
        got = ops.flash_attention(qd, kd, vd)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == 1 and sum(ops.LAUNCHES.values()) == 1, ops.LAUNCHES
        entry[name] = 1
        launched = {key: n for key, n in ops.LAUNCHES.items() if n}
        assert got.dtype == dtype and tuple(got.shape) == tuple(qh.shape)
        tol = attention_tolerance(seq, vd)
        with torch.no_grad():
            chunked = attention._chunked_attention(q.to(dtype), k.to(dtype), v.to(dtype))
        err_chunked = attention_err(got, heads_first(chunked.reshape(q.shape)).to(dtype), tol)
        del chunked
        err_plain = max(attention_err(got[:, h], ref.flash_attention_ref(qd[:, h], kd[:, h], vd[:, h]), tol)
                        for h in heads)
        ms = time_ms(lambda: ops.flash_attention(qd, kd, vd), calls=2, reps=5, warmup=1)
        bound_ms = attention_bound_ms(h_q, seq, q.shape[3], dtype)
        log(f"[prefill 32k] {name} at (1, {h_q}, {seq}, {q.shape[3]}): max "
            f"|diff| {err_chunked:.3e} against the chunked GQA attention (Q_CHUNK "
            f"{attention.Q_CHUNK}), {err_plain:.3e} against its plain version on head-batches "
            f"{heads} (bound {tol:.3e}{'' if dtype == torch.float32 else ' + one ulp'}); "
            f"{ms:.3f} ms (wrapper call), bound {bound_ms:.3f} ms, {100.0 * bound_ms / ms:.1f} % "
            f"of it ({card}); kernel launches before the timing {launched}")
        if dtype in (torch.float32, BF16):  # kept on the host through phases 6f-9 (1.5 GiB, 768 MiB)
            out["qkv_32k" + ("_f32" if dtype == torch.float32 else "")] = tuple(t.cpu() for t in (qd, kd, vd))
        del got
    del q, k, v, qh, kh, vh
    gc.collect()
    torch.cuda.empty_cache()
    return {"entry_d128": entry, **out}


def attention_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """The attention's largest difference from ``want``, asserted within
    ``tol`` (plus one ulp of a 16-bit dtype: ``within_16``)."""
    if got.dtype != torch.float32:
        return within_16(got, want, tol)
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)
    return err


def _row(name: str, raw, wrapper, plain, library, check, bytes_moved: float, ops_done: float,
         desc: str, ops_per_s: float = FP32_OPS_PER_S, graph=None, timing=None) -> dict:
    """Time one kernel: its C entry point (``raw``, preallocated outputs,
    so the device and not the wrapper's host checks sets the pace), its
    wrapper, its plain version and the library call; ``check`` compares the
    raw launch's output with the plain version's.  ``graph``: the same
    launches as functions of a stream, for ``ms_graph`` (``graph_ms``);
    ``timing``: ``time_ms``'s calls and reps for calls of many ms."""
    assert raw() == 0
    torch.cuda.synchronize()
    err = check()
    bound_ms, bound_by = bound(bytes_moved, ops_done, ops_per_s)
    source, replaces = KERNELS[name]
    timed_ms = lambda fn: time_ms(fn, **(timing or {}))  # noqa: E731
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "max_abs_err": err, "ms": timed_ms(raw), "plain_ms": timed_ms(plain),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None if library is None else timed_ms(library),
    }
    row["pct_of_bound"] = 100.0 * bound_ms / row["ms"]
    if graph is not None:
        row["ms_graph"] = graph_ms(graph)
        log(f"[timing] {name}: {row['ms_graph']:.4f} ms a launch replayed from a CUDA graph "
            f"(back-to-back C calls {row['ms']:.4f} ms), {100.0 * bound_ms / row['ms_graph']:.0f} % of "
            f"its bound")
    lib = "-" if library is None else f"{row['library_ms']:.4f} ms"
    log(f"[timing] {name} {desc}: kernel {row['ms']:.4f} ms (wrapper call {timed_ms(wrapper):.4f} ms), "
        f"plain {row['plain_ms']:.4f} ms, library {lib}, bound {bound_ms * 1e3:.2f} us by {bound_by} "
        f"({bytes_moved:.0f} B, {ops_done:.0f} ops), max_abs_err {err}")
    return row


def time_scatter(name: str, k_cap: int, device) -> dict:
    dtype = next((dt for dt in (BF16, F16) if name.endswith(TAG[dt])), torch.float32)
    width = dtype.itemsize
    wire = make_wire(k_cap, seed=7, device=device, dtype=dtype)
    n, rows, k = wire.values.shape
    num = torch.empty((rows, VOCAB), dtype=dtype, device=device)
    den = torch.empty_like(num)
    stream = torch.cuda.current_stream(device).cuda_stream
    if name.startswith("scatter_wire_sums") and "dequant" not in name:
        a, b = float_channels(wire, "adaptive")
        wrapper = lambda: ops.scatter_wire_sums(a, b, wire.indices, VOCAB)  # noqa: E731
        plain = lambda: tuple(x.to(dtype) for x in ref.scatter_wire_sums_ref(  # noqa: E731
            a, b, wire.indices, VOCAB))
        fn = ops._fn("sparse_agg", "scatter_wire_sums" + SUFFIX[dtype], 5, 4)
        ptrs = [t.data_ptr() for t in (a, b, wire.indices, num, den)]
        graph = [lambda st: fn(*ptrs, n, rows, k, VOCAB, st)]
        raw = lambda: fn(*ptrs, n, rows, k, VOCAB, stream)  # noqa: E731
        in_bytes = n * rows * k * (width + width + 4)
    else:
        qw = quantize_wire(wire)
        a, b = ref.dequant_channels(qw.values, qw.scale, qw.mask, "adaptive")
        wrapper = lambda: ops.scatter_wire_sums_dequant(  # noqa: E731
            qw.values, qw.scale, qw.mask, qw.indices, VOCAB, "adaptive")
        plain = lambda: ref.scatter_wire_sums_dequant_ref(  # noqa: E731
            qw.values, qw.scale, qw.mask, qw.indices, VOCAB, "adaptive")
        fn = ops._fn("sparse_agg", "scatter_wire_sums_dequant_i8", 6, 5)
        ptrs = [t.data_ptr() for t in (qw.values, qw.scale, qw.mask.view(torch.uint8), qw.indices, num, den)]
        raw = lambda: fn(*ptrs, n, rows, k, VOCAB, 0, stream)  # noqa: E731  mode 0: adaptive
        graph = None
        in_bytes = n * rows * k * (1 + 1 + 4) + n * rows * 4
    want = plain()

    def check():
        assert torch.equal(num, want[0]) and torch.equal(den, want[1])
        return max(float((g - w).abs().max()) for g, w in zip((num, den), want))

    row = _row(name, raw, wrapper, plain, scatter_library_call(a, b, wire.indices), check,
               in_bytes + 2 * rows * VOCAB * width, 2 * n * rows * k,
               f"N={n} rows={rows} k_cap={k} V={VOCAB} ({dtype})", graph=graph)
    if name in EARLIER_MS:
        log(f"[timing] {name}: the earlier upcasting design took {EARLIER_MS[name]} ms (H100 80GB "
            f"HBM3, 700 W; PERF.md section 6), not measured in this run")
    return row


def time_topk(name: str, real, device, pretrained=None) -> dict:
    """The top-k masks at the fused main path's shape, (C·64, V) rows, on
    three inputs, since the fp32 candidate bisection's work depends on the
    data: the ``fused`` run's real input of its last round (the row's
    ``ms``), random normal rows with those budgets (``ms_random``, the input
    earlier PRs timed) and constant rows (``ms_constant``: the fp32 kernel's
    candidate set never shrinks, every step is a full pass, its worst case);
    in bf16 and fp16 also rows of one bin of the radix select's high digit
    (``ms_one_bin``: the histogram puts every value in one bin, its worst case); with
    ``pretrained``, the pretrained ``fused`` run's input of its last round
    (``ms_pretrained``: a trained model's logits).  The static k is the
    largest budget."""
    x_real, kk = real
    rows, dtype = x_real.shape[0], x_real.dtype
    gen = torch.Generator(device=device).manual_seed(5)
    inputs = {"real": x_real,
              "random": torch.randn((rows, VOCAB), generator=gen, device=device).to(dtype),
              "constant": torch.full((rows, VOCAB), 0.5, dtype=dtype, device=device)}
    if pretrained is not None:  # the pretrained fused run's own input, with the budgets above
        assert pretrained[0].shape == x_real.shape and pretrained[0].dtype == dtype
        inputs["pretrained"] = pretrained[0]
    if dtype != torch.float32:  # one high-digit bin: [1, 2) in bf16, [1, 1 + 2^-5) in fp16
        levels = 128 if dtype == BF16 else 32
        inputs["one_bin"] = 1.0 + torch.randint(0, levels, (rows, VOCAB), generator=gen,
                                                device=device).to(dtype) / (128 if dtype == BF16 else 1024)
    k_max = int(kk.max())
    out = torch.empty_like(x_real)
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = ops._fn("topk_select", "topk_mask" + SUFFIX[dtype], 3, 5)
    use_smem = int(VOCAB <= ops.smem_max_vocab(device.index or 0, dtype))
    k_all = torch.full((rows,), k_max, dtype=torch.int32, device=device)
    dynamic = name.startswith("topk_mask_dynamic")

    def calls(x):
        if dynamic:
            ptrs = (x.data_ptr(), kk.data_ptr(), out.data_ptr())
            raw = lambda: fn(*ptrs, rows, VOCAB, 0, 1, use_smem, stream)  # noqa: E731
            return (raw, lambda: ops.topk_mask_dynamic(x, kk),
                    lambda: ref.topk_mask_ref(x, kk, guard=True))
        ptrs = (x.data_ptr(), None, out.data_ptr())
        raw = lambda: fn(*ptrs, rows, VOCAB, k_max, 0, use_smem, stream)  # noqa: E731
        return raw, lambda: ops.topk_mask(x, k_max), lambda: ref.topk_mask_ref(x, k_all, guard=False)

    extra = {}
    for label in [name for name in inputs if name != "real"]:
        raw, _, plain = calls(inputs[label])
        want = plain()
        assert raw() == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want), (name, label)
        extra[f"ms_{label}"] = time_ms(raw)
    raw, wrapper, plain = calls(x_real)
    want = plain()

    def check():
        assert torch.equal(out, want)
        return float((out - want).abs().max())

    library = lambda: torch.topk(x_real, k_max, dim=-1)  # noqa: E731  (the selection, not the mask)
    in_bytes = rows * VOCAB * dtype.itemsize + (rows * 4 if dynamic else 0)
    # the least work of any bisection on these inputs: min and max, one
    # counting pass, the masked select (the kernel's passes depend on the data)
    ops_done = 4 * rows * VOCAB
    desc = (f"rows={rows} V={VOCAB} k={sorted(set(kk.tolist())) if dynamic else k_max} (real input, "
            f"{dtype})")
    row = _row(name, raw, wrapper, plain, library, check, in_bytes + rows * VOCAB * dtype.itemsize,
               ops_done, desc)
    one_bin = f", on one-exponent-bin rows {extra['ms_one_bin']:.4f} ms" if "ms_one_bin" in extra else ""
    pre = (f", on the pretrained run's input {extra['ms_pretrained']:.4f} ms"
           if "ms_pretrained" in extra else "")
    log(f"[timing] {name} on random rows {extra['ms_random']:.4f} ms, on constant rows "
        f"{extra['ms_constant']:.4f} ms{one_bin}{pre} (torch.equal to the plain version on each)")
    if name in EARLIER_MS:
        log(f"[timing] {name}: the earlier upcasting design took {EARLIER_MS[name]} ms on the real "
            f"input (H100 80GB HBM3, 700 W; PERF.md section 6), not measured in this run")
    return {**row, **extra}


def time_sparse_aggregate(ks: list[int], device, dtype: torch.dtype = torch.float32) -> dict:
    """The dense adaptive aggregation at the fused main path's shape: the
    transmitters' (N, 64, V) top-k stack with the run's budgets."""
    stack = dense_stack(ks, seed=13, device=device).to(dtype)
    n = stack.shape[0]
    out = torch.empty((ROWS, VOCAB), dtype=dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = ops._fn("sparse_agg", "sparse_aggregate" + SUFFIX[dtype], 2, 3)
    raw = lambda: fn(stack.data_ptr(), out.data_ptr(), n, ROWS, VOCAB, stream)  # noqa: E731
    want = ref.sparse_aggregate_ref(stack).to(dtype)

    def check():
        assert torch.equal(out, want)
        return float((out - want).abs().max())

    elems = ROWS * VOCAB
    return _row("sparse_aggregate" + TAG[dtype], raw,
                lambda: ops.sparse_aggregate(stack), lambda: ref.sparse_aggregate_ref(stack).to(dtype),
                None, check, (n + 1) * elems * dtype.itemsize, (4 * n + 2) * elems,
                f"N={n} rows={ROWS} V={VOCAB} k={ks} ({dtype})")


def time_distill_kl(device, dtype: torch.dtype = torch.float32) -> dict:
    """The KL kernel at the distillation's shape: 64 public rows x V 50 257,
    timed cold (launches in turn over ``COLD_COPIES`` copies of the inputs,
    so that each finds its 25.7 MB (fp32) evicted from the L2 by the
    others') and warm (one copy, ``ms_warm``)."""
    gen = torch.Generator(device=device).manual_seed(31)
    t, s = ((2.0 * torch.randn((ROWS, VOCAB), generator=gen, device=device)).to(dtype)
            for _ in range(2))
    copies = [(t, s)] + [(t.clone(), s.clone()) for _ in range(COLD_COPIES - 1)]
    out = torch.empty(ROWS, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = ops._fn("distill_kl", "distill_kl" + SUFFIX[dtype], 3, 2, 1)
    launches = [lambda st, a=a, b=b: fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), ROWS, VOCAB, 0.5, st)
                for a, b in copies]
    raws = [lambda launch=launch: launch(stream) for launch in launches]
    want = ref.distill_kl_ref(t, s, 2.0)
    tol = kl_tolerance(t, s, 2.0, want)

    def check():
        err = (out - want).abs()
        assert bool((err <= tol).all())
        return float(err.max())

    # per element pair: two scalings, a difference, two exps and the rescaled sums
    name = "distill_kl" + TAG[dtype]
    row = _row(name, in_turn(raws), lambda: ops.distill_kl(t, s, 2.0),
               in_turn([lambda a=a, b=b: ref.distill_kl_ref(a, b, 2.0) for a, b in copies]), None, check,
               2 * ROWS * VOCAB * dtype.itemsize + ROWS * 4, 12 * ROWS * VOCAB,
               f"rows={ROWS} V={VOCAB} T=2 ({dtype}; cold: in turn over {COLD_COPIES} copies of "
               f"the inputs)", graph=launches)
    row["ms_warm"] = time_ms(raws[0])
    row["ms_graph_warm"] = graph_ms(launches[:1])
    log(f"[timing] {name} warm (the same inputs each launch, in the L2) {row['ms_warm']:.4f} ms "
        f"(from a CUDA graph {row['ms_graph_warm']:.4f} ms); cold {row['ms']:.4f} ms is "
        f"{row['bound_ms'] / row['ms']:.0%} of its bound")
    if name in EARLIER_MS:
        log(f"[timing] {name}: the earlier upcasting design took {EARLIER_MS[name]} ms cold (H100 "
            f"80GB HBM3, 700 W; PERF.md section 6), not measured in this run")
    return row


def attention_inputs(shape, dtype: torch.dtype, device):
    """N(0, 1) q, k, v of ``shape`` (B, H, S, D) in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(sum(shape))
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3))


def time_flash_attention(qkv, device, suffix: str = "", heads=None, timing: dict | None = None) -> dict:
    """The attention kernel on ``qkv`` (B, H, S, D) in its dtype: the
    serving prefill's layer-0 q/k/v (D 64), N(0, 1) inputs at D 128
    (``suffix`` ".d128") and at other D (``suffix`` ".dany.d<D>"), yi-9b's
    at 32k.  ``heads``: the head-batches the plain version is held on (all
    when None), and the plain version then timed one head-batch at a time,
    as it fits; ``timing``: ``time_ms``'s repeats, where not its own.  In bf16 (fp16) the library
    call, bf16 (fp16) SDPA, rounds P to that dtype before P V, so it is not
    the same function: its max error against the plain version is logged
    and kept beside its time."""
    b, h, seq, d = qkv[0].shape
    q, k, v = (x.reshape(b * h, seq, d) for x in qkv)
    low = q.dtype != torch.float32
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(device).cuda_stream
    fn = ops._fn("flash_attention", "flash_attention" + SUFFIX[q.dtype], 4, 3, 1)
    ptrs = [x.data_ptr() for x in (q, k, v, out)]
    raw = lambda: fn(*ptrs, b * h, seq, d, d**-0.5, stream)  # noqa: E731
    sample = list(range(b * h)) if heads is None else list(heads)
    plain = (lambda: ref.flash_attention_ref(q, k, v)) if heads is None else (  # noqa: E731
        lambda: [ref.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in range(b * h)])
    want = ref.flash_attention_ref(q, k, v) if heads is None else torch.cat(
        [ref.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in sample])
    tol = attention_tolerance(seq, v)

    def check():
        return attention_err(out[sample], want, tol)

    # the library call on (B, H, S, D), the layout its fused kernels take
    q4, k4, v4 = qkv
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, is_causal=True)
    ops_done = 2 * seq * seq * d * b * h
    io_bytes, tc_ops, tc_rate = attention_work(b * h, seq, d, q.dtype)
    fp32_ms, _ = bound(io_bytes, ops_done)
    basis = f"1+2 {q.dtype} products" if low else "3+3 TF32 products"
    row = _row("flash_attention" + TAG[q.dtype] + suffix, raw, lambda: ops.flash_attention(q, k, v),
               plain, library, check, io_bytes, tc_ops,
               f"B*H={b * h} S={seq} D={d} ({q.dtype}; {basis} on the tensor cores; the fp32 "
               f"CUDA-core bound would be {fp32_ms * 1e3:.2f} us)", tc_rate,
               timing=timing if heads is None else dict(calls=1, reps=3, warmup=1))
    if low:  # the three-piece basis beside it: the D 64 rows' records before PR 33
        row["bound_1p3_ms"] = bound(*attention_work(b * h, seq, d, q.dtype, 3))[0]
        log(f"[timing] {row['name']}: P V in three 16-bit pieces (the D 64 rows' earlier basis) would "
            f"bound it at {row['bound_1p3_ms'] * 1e3:.2f} us, {row['bound_1p3_ms'] / row['ms']:.1%} of "
            f"its time; its bound_ms counts the two pieces the kernels run")
    if heads is not None:  # calls of many ms, at the card's power limit: each sample beside its SM clock
        row["ms_samples"], row["sm_clock_mhz"] = clocked_samples(raw)
        log(f"[timing] {row['name']}: {len(row['ms_samples'])} samples " + ", ".join(
            f"{t:.4f} ms ({'-' if c is None else f'{c:.0f}'} MHz)" for t, c in zip(row["ms_samples"],
                                                                                   row["sm_clock_mhz"])))
    if row["name"] in EARLIER_MS:
        log(f"[timing] {row['name']}: the earlier upcasting design took {EARLIER_MS[row['name']]} ms "
            f"(H100 80GB HBM3, 700 W; PERF.md section 6), not measured in this run")
    row["library_max_abs_err"] = float((library().reshape(q.shape)[sample].float() - want.float()).abs().max())
    log(f"[timing] {row['name']}: SDPA on (B, H, S, D) {row['library_ms']:.4f} ms, off the plain "
        f"version by {row['library_max_abs_err']:.3e} (the kernel by {row['max_abs_err']:.3e})")
    return row


def main() -> int:
    t0 = time.perf_counter()
    device, card = phase_device()
    phase_build()
    check_scatter_kernels(device)
    check_topk_kernels(device)
    check_sparse_aggregate(device)
    check_distill_kl(device)
    check_flash_attention(device)
    check_bf16_kernels(device)
    check_f16_kernels(device)
    any_entry = check_attention_any_head_dim(device)
    phase_small_input(device)
    phase_small_pretrain(device)

    runs = {}
    for engine, quantize, low in (("fused_e2e", False, None), ("fused_e2e", True, None),
                                  ("fused", False, None), ("fused", True, None),
                                  ("batched", False, None), ("sequential", False, None),
                                  ("fused_e2e", False, BF16), ("fused", False, BF16),
                                  ("fused_e2e", False, F16), ("fused", False, F16)):
        runs[(engine, quantize, low)] = phase_main_path(device, engine, quantize, low)
    seq, bat = runs[("sequential", False, None)], runs[("batched", False, None)]
    assert seq["per_client_k"] == bat["per_client_k"] and seq["bytes"] == bat["bytes"], (seq, bat)
    log("[main path] sequential == batched on per-client k, uplink and downlink bytes and "
        "transmitters")
    for low in (BF16, F16):
        for engine in ("fused_e2e", "fused"):  # the budgets depend on the channel only
            f32, lo = runs[(engine, False, None)], runs[(engine, False, low)]
            assert lo["per_client_k"] == f32["per_client_k"] and lo["bytes"] == f32["bytes"], (
                engine, low, f32, lo)
        log(f"[main path] {TAG[low][1:]} == fp32 on per-client k, uplink and downlink bytes and "
            f"transmitters, fused_e2e and fused")
    pretrained = phase_pretrained(device)
    faults = phase_faults(device)
    host_store = phase_host_store(device, runs[("fused_e2e", False, None)])
    scale_out = phase_scale_out(device, card, runs)
    serving = phase_serving(device, card)
    started = start_mesh_dryruns(device.type)  # phase 9 (b), on host cores beside 6f-6h
    try:
        families = phase_families(device, card)
        ssm = phase_ssm(device, card)
        modal = phase_modal(device, card)
    except BaseException:
        stop_mesh_dryruns(*started)
        raise
    phase_production_mesh(device, card, started=started)
    launches = {name: sum(r["launches"].get(name, 0) for r in runs.values()) + pretrained["launches"][name]
                + faults["launches"].get(name, 0) + host_store["launches"].get(name, 0)
                + scale_out["launches"].get(name, 0) + families["launches"].get(name, 0)
                + ssm["launches"].get(name, 0) + modal["launches"].get(name, 0) for name in ops.LAUNCHES}
    entry_names = ("topk_mask", "distill_kl", "topk_mask.bf16", "distill_kl.bf16", "topk_mask.f16",
                   "distill_kl.f16")
    entry = {name: sum(r["entry_launches"].get(name, 0) for r in runs.values()) for name in entry_names}
    for name in ("flash_attention", "flash_attention.bf16", "flash_attention.f16"):
        entry[name] = serving["entry_launches"][name]  # GPT-2's layer 0, D 64
        entry[name + D128] = serving["entry_d128"][name + D128]  # yi-9b's layer 0 at 32k, D 128
    entry[ATTN_32K] = entry["flash_attention.bf16" + D128]
    entry[ATTN_32K_F32] = entry["flash_attention" + D128]
    entry.update(any_entry)  # the any-D kernel's calls through ops.flash_attention
    log(f"[main path] kernel launches over the ten runs, the pretrained phase's four, the "
        f"faults phase's, the host store phase's, the scale-out phase's, the families phase's, "
        f"the state-space phase's and the modal phase's {launches} (the faults "
        f"phase's alone {faults['launches']}, the host store phase's {host_store['launches']}, "
        f"the scale-out phase's {scale_out['launches']}, the families phase's "
        f"{families['launches']}, the state-space phase's {ssm['launches']}, the modal phase's "
        f"{modal['launches']})")
    log(f"[entry] launches through the public entry points {entry}")

    k_caps = {
        name: max(k_cap_bucket(ks, VOCAB) for ks in runs[("fused_e2e", quant, low)]["per_client_k"])
        for name, quant, low in (("scatter_wire_sums", False, None),
                                 ("scatter_wire_sums_dequant", True, None),
                                 ("scatter_wire_sums.bf16", False, BF16),
                                 ("scatter_wire_sums.f16", False, F16))
    }
    fused_ks = runs[("fused", False, None)]["per_client_k"][-1]
    topk_input = runs[("fused", False, None)]["topk_input"]
    rows = [time_scatter(name, k_cap, device) for name, k_cap in k_caps.items()]
    rows += [time_topk("topk_mask_dynamic", topk_input, device, pretrained["topk_input"]),
             time_sparse_aggregate(fused_ks, device),
             time_topk("topk_mask", topk_input, device, pretrained["topk_input"]), time_distill_kl(device),
             time_flash_attention(serving["qkv"], device)]
    for low in (BF16, F16):
        topk_low = runs[("fused", False, low)]["topk_input"]
        assert topk_low[0].dtype == low
        rows += [time_topk("topk_mask_dynamic" + TAG[low], topk_low, device),
                 time_sparse_aggregate(runs[("fused", False, low)]["per_client_k"][-1], device, low),
                 time_topk("topk_mask" + TAG[low], topk_low, device), time_distill_kl(device, low),
                 time_flash_attention(serving["qkv" + TAG[low].replace(".", "_")], device)]
    for dtype in (torch.float32, BF16, F16):  # head dim 128 at the GPT-2 rows' (96, 1024)
        rows.append(time_flash_attention(attention_inputs((8, 12, 1024, 128), dtype, device), device,
                                         D128))
    rows.append(time_flash_attention(tuple(t.to(device) for t in serving["qkv_32k_f32"]), device,
                                     D128 + ".s32k", heads=YI_HEADS))
    del serving["qkv_32k_f32"]
    rows.append(time_flash_attention(tuple(t.to(device) for t in serving["qkv_32k"]), device,
                                     D128 + ".s32k", heads=YI_HEADS))
    for dtype in (torch.float32, BF16, F16):  # the any-D kernel at the GPT-2 rows' (96, 1024)
        for d in ANY_TIMED:
            rows.append(time_flash_attention(attention_inputs((8, 12, 1024, d), dtype, device), device,
                                             any_suffix(d), timing=dict(calls=4, reps=9, warmup=2)))
    # a row's main-path count is its kernel's (a 32k row's its dtype's D = 128 one's, a
    # .dany.d<D> row's the any-D kernel's)
    rows = [{**row, "launches": launches[re.sub(r"(\.dany)\.d\d+$", r"\1", row["name"].removesuffix(".s32k"))],
             **({"entry_launches": entry[row["name"]]} if row["name"] in entry else {})}
            for row in rows]
    log(f"[smoke] every phase passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
