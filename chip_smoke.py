"""Run the PyTorch/CUDA port (accl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from accl_tpu_torch/ops/csrc with nvcc, one
     nvcc per source, all started together; the build line carries
     ptxas's register and spill lines, each matmul kernel's registers,
     spill bytes, shared memory and blocks per SM as the runtime reports
     them, and the tensor-core instructions in the matmul kernels' SASS
     (must be 0) and in each flash forward and backward kernel's (0 in
     every fp32 instantiation, more than 0 in every bf16-MXU one, HGMMA
     and HMMA counted apart); the flash forward and backward kernels'
     registers, shared memory and CTAs per SM;
  3. each kernel against its plain PyTorch version on the card, at every
     shape the main path gives it:
     - the ring kernels at one 1 MiB segment (P=8 ranks, n =
       DEFAULT_SEG_ELEMS / 8) and at a ragged size: fp32 SUM and MAX,
       int32 SUM and fp32 all-gather bitwise, fp16 SUM within one ulp;
       the segmented allreduce (one launch per phase over every segment)
       at whole segments of many tiles, odd N with a ragged tail, many
       small segments and fewer elements than ranks, in all five kernel
       dtypes, SUM and MAX with NaN present, out of place and in place,
       bitwise against the plain composition; both kernels at one tile
       and many in all five dtypes, bitwise; the all-gather also at the
       tensor-parallel path's n = (M / 8) N;
     - the matmul kernel (accl_matmul, at M and M / (8 CHUNKS) rows) and
       the fused matmul reduce-scatter kernel (accl_fused_matmul_rs, P=8,
       m = M / 8) on f32 and bf16 at Llama-3-8B's TP=8 MLP-down and
       attention-out shapes and at a ragged shape: bitwise on
       integer-valued inputs; on N(0, 1) inputs within the dot-product
       bound |err| <= 2 K 2^-24 (|x| @ |w|) of a float64 product, and
       within the fp32 spread sqrt(K) 2^-24 (|x| @ |w|) of the plain
       version (K = P * K for the fused kernel, whose sum runs over P
       ranks' partials).  A control computes the plain version on
       bf16-rounded operands, which must fall outside the spread, and on
       TF32, printed beside;
     - the flash-attention kernels (flash_fwd_resident, flash_fwd_grid)
       at the serving path's per-rank shapes, at one sp member's hop
       shapes of sp_path (SP_HOP_CALLS: the contiguous ring's causal and
       unmasked hops at 4096, zigzag's half-chunk pairs at 2048, the
       windowed local block and the sp = 1 references over 32768 tokens,
       causal and windowed; f32 and bf16), a windowed, two cross-length,
       two ragged calls and one at head size 64, in f32 with f32 and
       bf16 MXU dtypes and in bf16: out and lse within
       FLASH_BOUND of the plain version and bitwise equal over two
       launches, and a bf16-operand control outside the f32 bound;
     - the flash backward kernels (flash_bwd_dq, flash_bwd_dkv) at the
       training path's per-rank shape (q and dO [8, 4096, 128], K/V
       [2, 4096, 128], causal) with the lse cotangent zero and nonzero,
       at one member's hop shapes of sp_train (q [16, 2048, 128], K/V
       [4, 2048, 128], causal and unmasked, the lse cotangent nonzero),
       and at a windowed, a cross-length and a ragged call with halved
       blocks, in f32 with f32 and bf16 MXU dtypes and in bf16: dq, dk
       and dv within BWD_BOUND of the plain version and bitwise equal
       over two launches, and a bf16-operand control outside the f32
       bound; each call's launch plan (dq CTAs, dK/dV items, the heaviest
       item against the average work per SM, which must stay within
       BWD_ITEM_SHARE_MAX at the training shape, CTAs per SM);
     - the plugin kernels: the combine kernel (accl_combine) on all
       12 lanes (fp32, fp64, int32, int64, fp16, bf16 by sum and by max)
       at the bench shape (64 Mi elements) and at 4099, with donate,
       bitwise against a + b and torch.maximum; the cast kernel
       (accl_cast) both ways for fp16 and bf16, at the bench shape and at
       a ragged length holding NaN, inf, overflow and fp16 subnormals,
       bitwise against Tensor.to, and at every geometry of phase 4f's
       tuning grid (4 cols x 2 block_rows) the same way; its stochastic
       rounding to bf16, e5m2 and e4m3fn bitwise against the plain
       version, and unbiased at 1 + 2^-12; the stochastic edges (NaN,
       fp32 subnormals, +-FLT_MAX, inf, the fp8 range thresholds, values
       below 2^-24) bitwise, with the widening cast after them; a tile of
       15 elements; every lane on views one element off 16-byte
       alignment; each stochastic target bitwise equal over two
       launches of one seed and different for the next seed;
     - flash_fwd_resident_skew at the serving path's per-rank shape in
       the three flash dtype pairs: bitwise equal to flash_fwd_resident,
       and within FLASH_BOUND of its plain version;
  4. the main path, in twelve parts, each driven with every launch count
     set to 0 just before it and read just after (parts l and h-k run
     first, before part a's driver holds its rank buffers):
     a. the driver: CudaWorld(8) on the card, ACCL calls on 8 rank
        threads — fp32 SUM allreduce at 4, 16, 64 and 256 MiB per rank,
        MAX allreduce, allgather and reduce-scatter at 64 MiB per rank,
        and bcast / gather / scatter / alltoall / a small allreduce below
        the ring threshold.  Every result is held against the plain
        composition on the card (bitwise on the ring lane) and a float64
        reference (rtol 1e-5, atol 1e-5); each ring call must launch
        one kernel per phase (an allreduce one reduce-scatter and one
        all-gather, at every size);
     b. the fused tensor-parallel matmul at Llama-3-8B's widths (hidden
        4096, intermediate 14336, 32 query heads of 128; Meta's
        config.json for meta-llama/Meta-Llama-3-8B) at TP=8 and 4096
        tokens: fused_matmul_allreduce_pallas and
        fused_matmul_allreduce(chunks=CHUNKS, use_pallas=True) over 8
        rank lists at the MLP-down and attention-out shapes, each held to
        the float64 sum_r x_r @ w_r within the dot-product bound and to
        the same form built from the plain versions within the fp32
        spread; the matmul, fused and ring all-gather kernels must launch;
     c. the fused and int8 driver lanes on the same CudaWorld(8) at 64
        MiB per rank: fused=True allreduce, reduce_scatter and allgather
        (bitwise equal to the ring lane: its driver results for
        reduce_scatter and allgather, its fold at one segment for
        allreduce, whose driver run folds per 1 MiB segment), and fp32
        allreduce with compress_dtype=DataType.int8 without and with
        error feedback (bitwise equal to the plain int8 composition, its
        error against float64 printed beside the bound P (2 5 sqrt(P) /
        127) of tests/test_quantized.py);
     d. the model's serving path (accl_tpu_torch.models) at Llama-3-8B
        width, cut to 4 layers, TP=8 over rank lists, fp32, random
        weights from a seed (LLAMA3_8B): the scoring forward on 2 x 4096
        tokens (flash_fwd_resident must launch), with fused=True, with
        attn="dense" and at TP=1, each held to it within LOGIT_BOUND; the
        forward on 1 x 8192 tokens (flash_fwd_grid must launch); the 2 x
        4096 forward in bfloat16 (ModelConfig(dtype="bfloat16"), the
        weights cast to bf16:
        flash_fwd_resident must launch once per layer and rank, every
        launch on the tensor-core mainloop, the logits finite; its s per
        forward, warm, printed beside the fp32 forward's); generate
        for 4 requests of 128-token prompts and 32 new tokens, greedy,
        held to forward's argmax; teacher-forced prefill and decode held
        to forward's logits.  The graph arm (serving_graph_arm): generate
        with its decode step captured in one CUDA graph and replayed (the
        card's default) against the eager loop (graph=False), unfused and
        fused=True, tokens equal; ms per decode step replayed and eager
        over GRAPH_STEPS teacher-forced steps, logits bitwise (else held
        within LOGIT_BOUND beside a control that must exceed it); and
        fused_matmul_allreduce_pallas at the decode step's MLP-down shape
        captured and replayed 31 times, bitwise its eager launches (the
        model's fused lane multiplies with torch.matmul, as the JAX
        package's, so its graph holds no hand kernel).  Prints first-call
        seconds, launches, prefill tokens/s, ms per decode step and peak
        memory;
     e. the model's training path at the same width and depth, fp32:
        make_train_step on make_mesh(dp=2, tp=4) (8 rank slots), 1 x 4096
        tokens per dp member, 3 SGD steps at TRAIN_LR on a repeated
        batch; the loss must be finite and fall, and flash_fwd_resident,
        flash_bwd_dq and flash_bwd_dkv must each launch 32 times a step.
        The first step is held three ways: to the same step with
        attn="dense" and remat (loss within TRAIN_LOSS_BOUND, each
        leaf's gradient, recovered as (p - p') / lr, within
        TRAIN_GRAD_BOUND plus the update's fp32 rounding floor), to the
        same step with remat (within REMAT_BOUND), and to one step
        synced by sync_gradients(compress="int8", error_feedback=True)
        over the dp list (the loss after it within TRACK_TOL of the
        fp32 run's).  Prints seconds per step, tokens/s and peak memory.
        The AdamW arm (phase train_adamw): the same mesh, width, depth
        and tokens with optimizer=adamw(ADAMW_LR), 3 steps, losses
        falling, each flash kernel 32 launches a step; the first step
        held to the single-device AdamW step (loss within
        TRAIN_LOSS_BOUND, moments within ADAMW_MOMENT_BOUND, updates
        within ADAMW_UPDATE_BOUND, relative L2 per leaf); prints s per
        step and its peak memory beside the SGD step's;
     f. the plugin lanes, as bench.py and the tuning tools run
        them, in four parts: the reduce lane (pallas_add with donate on
        [524288, 128] fp32, block_rows 512 and 2048, chained, beside
        torch.add in place, GB/s = 3 x bytes / time); the bf16
        compression roundtrip of 64 Mi fp32 (nearest, and stochastic with
        the seed stepped per call) beside the Tensor.to pair (12 bytes an
        element); a short tune_compress grid (4 cols x 2 block_rows) and
        its best geometry; the flash schedule sweep's distinct card
        candidates at [16, 2048, 128] causal (resident, resident_skew,
        grid, static_max, bf16 inputs; the other candidates are aliases),
        each held within FLASH_BOUND of the plain version of its kernel
        before it is timed (outside the counted parts).
        The combine kernel, the cast kernel (in the lanes and in the
        tuning grid) and the skew kernel must each launch;
     g. persistent plans, batched dispatch and the sanitizer on the same
        CudaWorld(8) (phase plan_path): an allreduce at 1024 elements
        (below the threshold) and at 2^20 fp32 per rank (4 MiB, the ring
        lane), a reduce-scatter and an all-gather at 4 MiB, each run
        eagerly, captured (capture_plan, validate=True) and replayed 20
        times on new operands from a torch.Generator: every replay
        bitwise the eager call on the same operands and the plain
        version, with the eager call's launches (1 per ring phase), and
        engine_stats counting the replays and live plans; a window of 64
        async allreduces at 1024 elements per rank must form batches
        (run again behind a parked executor if the free-running window
        formed none), bitwise the same window under profile_sync (one
        gang at a time); under the sanitizer a mismatched gang must
        raise on all 8 ranks within 5 s;
     h. sequence parallelism, serving side (phase sp_path): forward at
        sp = 8 over 1 x 32768 tokens (4096 a member) at Llama-3-8B width,
        4 layers, attn="dense" (the ring owns attention and runs the flash
        kernels per hop), fp32 and bf16, contiguous and zigzag schedules,
        and a windowed fp32 forward at Mistral-7B's sliding window 4096;
        each held within SP_BOUND to the sp = 1 flash forward of the same
        tokens and weights (zigzag un-permuted, in row chunks), its flash
        launches equal to the schedule's (contiguous 8 a layer, the live
        members of a hop stacked into one launch; zigzag 9; windowed one
        grid launch); prints s per forward (first and warm), tokens/s and
        each run's peak memory;
     i. sequence parallelism, training (phase sp_train): make_train_step
        on make_mesh(sp=4, tp=2), the same width, 1 x 8192 tokens, 2 SGD
        steps at TRAIN_LR, each held to the same step on make_mesh(tp=2)
        (sp = 1, flash) from the same weights (loss within
        TRAIN_LOSS_BOUND, each leaf's gradient within TRAIN_GRAD_BOUND);
        the backward kernels take the merges' live lse cotangent; each
        flash kernel launches 32 times a step;
     j. Ulysses (phase ulysses): ulysses_attention over 8 members, q [1,
        4096, 32, 128] and K/V [1, 4096, 8, 128] a member, fp32 and bf16,
        bitwise one flash_attention over the 32768 tokens, one grid
        launch each;
     k. the MoE family (phase moe_path) at Switch-Base-8 width (4
        layers), 8 x 2048 tokens on make_mesh(ep=8): the ep forward held
        to the dense run-every-expert forward at a drop-free capacity,
        the fused forward within MOE_BOUND of the unfused one at capacity
        factor 1.25 (cuBLAS picks its kernel by the row count; the same
        forward with the last block's expert banks rounded to bf16 must
        fall outside the bound) and the fused lane's routing bitwise, 3 train steps
        (losses finite and falling), one step held
        to the dense full-batch step, and ep prefill plus 16
        teacher-forced decode steps held to the dense forward; prints s
        per forward and per step;
     l. the ring kernels' self-ring mode (phase selfring, first): at the
        bench's shapes (V = 8, chunks of 4096 x 128 fp32) the
        reduce-scatter by sum and max, the all-gather and the allreduce
        bitwise their plain versions and the closed forms, then
        bench/selfring.py's stage (correctness first, then
        ring_selfring_ag_gbps and ring_selfring_ar_gbps), both kernels
        launched in the self-ring mode only;
  5. times with CUDA events after warm-up (median of 5 runs): each kernel
     per launch, at the shape the main path launches it most, beside its
     plain version, a library yardstick and its bound (bytes read once +
     written once over 3.35 TB/s, or operations over the peak for their
     type, 67 TFLOP/s fp32 or 989 TFLOP/s bf16, whichever is larger),
     with its times at the path's other shape as an extra field (the
     flash backward kernels beside SDPA's backward by autograd, its
     forward time subtracted; the plugin kernels at the bench shapes,
     the cast kernel also at phase 4f's tuned geometry, its fp8 widening
     and stochastic lanes and the bf16 combine beside, each with GB/s and
     its share of the byte bound; the skew beside
     flash_fwd_resident and SDPA; the self-ring all-gather and
     reduce-scatter at the bench's shapes beside x.expand(V, n).clone()
     and torch.sum(x, 0)); the
     driver's allreduce algbw / busbw per size; the ring and matmul
     kernels (with each matmul shape's launch plan) also with the stream
     held behind torch.cuda._sleep until every launch is enqueued
     (device time) and on the host clock around the enqueues
     (accl_tpu_torch/bench/timing.py, split_ms), and the segmented
     allreduce's two launches at each driver size the same way; and at
     64 MiB per rank
     the busbw of the fused and int8 lanes beside the lossless ring's.

  6. observability on the driver (phase observed_path): the allreduce at
     4 and 256 MiB per rank with the flight recorder and metrics on (the
     defaults) and off (as under ACCL_METRICS=0 ACCL_FLIGHT=0), s per
     call for each, in alternating rounds of bench/driver_split.py's
     measure; with ACCL_TRACE on, the spans' mean
     submit -> queue -> gang_ready -> dispatch -> device_begin ->
     device_end -> complete split of a 4 MiB call (the engine syncs the
     stream before device_end); the registry's call and byte counts held
     to the calls made; each rank's flight dump read back by
     merge_flight_dumps;
  7. the ring kernels' device-trace stamp mode (phase device_trace): the
     driver's allreduce at 4 and 256 MiB with ACCL_DEVICE_TRACE on, the
     rows ring_kernel<T, KIND, true> wrote (landed by the ring wrapper
     after each launch) bitwise equal to the plain composition's, the
     results bitwise the gate-off results; the segmented allreduce's
     device ms with the gate off and on, both instantiations' registers;
     the stamp kernels per launch in the kernels line, their results
     held to the plain versions';
  7b. the rest of observability (phase observatory) on the same world:
     tenant communicators "train" (64 MiB per rank x6, ring lane) and
     "serve" (64 KiB x40, a decode step's TP allreduce at 4 requests x
     hidden 4096), results bitwise; a TelemetrySampler at 100 ms, the
     train slice of link_matrix exactly the ring's bytes and the slices
     summing to the matrix over both tenants; Baseline.from_snapshot of
     the clean window and an SLO spec at 3 x each tenant's clean p99, then
     rank 2 sleeping before each of 40 serve calls (5 ms, or the largest
     bucket bound at or below the serve ceiling where longer): serve burns,
     train stays ok, the sentinel finds drift, accl_health reads slow,
     /slo (ACCL_METRICS_PORT=0) reports both tenants, attribute names
     rank 2 (share > 0.9, coverage 0.95-1.05), slowest_link points at it;
     device_overlap of the 64 MiB allreduce's stamp rows, sequential
     (>= 0.95 exposed) against fused=True (lower); run_fused_overlap_sweep
     at its defaults and at 2^24 elements; µs per call at 4 MiB and 1024
     elements with the sampler, sentinel, SLO tracker and tenant labels
     on against off, in alternating rounds.  Its ring launches join the
     kernels line;
  7c. resilience on the card (phase resilience_path), on a fresh
     CudaWorld(8) at 64 MiB per rank: a comm of ranks 0-6 (P = 7) runs an
     allreduce and a reduce-scatter of 16,777,216 elements through the
     ring kernels, bitwise their plain composition and within the fp32
     summation bound (P - 1) 2^-24 sum|x| of float64; a partial gang and
     a pending receive drained by rebuild_gang_tables, then by
     abort(RANK_FAILED) (the ms from the abort to the last woken
     waiter); the captured plan's replay raises and launches nothing;
     rank 7 joins and the survivors grow the comm to P = 8, whose
     allreduce launches both kernels bitwise (the ms from the abort to
     its completion); reset_errors, a 4 MiB allreduce on comm 0, and an
     allreduce on the comm shrink_communicator(0) mints; the device ms
     of the P = 7 and P = 8 rings.  Its launches join the kernels line;
  7d. the native emulator (phase emu_world): native/libacclemu.so built
     on this machine beside the nvcc builds, EmuWorld(4) against
     CudaWorld(4) on the card at 1 and 8 MiB per rank (allreduce,
     allgather, reduce_scatter; int32 and the fp32 gather bitwise, each
     fp32 sum within (P - 1) 2^-24 sum|x| of float64); CudaWorld's ring
     launches at
     8 MiB join the kernels line;
  7e. the device API and kernel streams (phase device_api), on a fresh
     CudaWorld(8) at 64 MiB fp32 per rank: each rank pushes its operand
     (ACCLData.push) and issues ACCLCommand.start_call(allreduce,
     OP0_STREAM | RES_STREAM, tag 9), pulling the result: bitwise the
     buffer-sourced allreduce, within (P - 1) 2^-24 sum|x| of float64,
     both ring kernels launched once; the same for reduce_scatter and
     allgather; vadd_put (push x + 1, stream_put to the next rank, pull);
     a kernel-issued allreduce by raw device addresses; copy_to_stream /
     copy_from_stream round trips and the rooted reduce with OP0_STREAM
     and with RES_STREAM, bitwise the buffer-sourced reduce;
     DeviceCollectives over 8 member tensors against the torch ops; then
     events ms of the 64 MiB allreduce stream-sourced (push, call, pull),
     host-staged and resident, the push's and the pull's ms, and the
     device ms of the stream-sourced and the resident call by split_ms.
     Its ring launches join the kernels line;
  7f. offline tuning (phase tuning): tune through the CLI's tune_sizes
     on a fresh CudaWorld(8), allreduce / reduce_scatter / allgather at
     1, 4, 16 and 64 MiB payload, over the cuda lanes, best of 3; each
     cell's winner and busbw; compare's never-slower check against
     static; the table armed through ACCL_TUNE_TABLE on a fresh world,
     each cell served there bitwise the same call with the served lane
     forced directly on a second world with the same registers; the 64
     MiB allreduce cell hot-swapped to the hierarchical lane, its routed
     int32 allreduce bitwise flat and its fp32 one within the bound.  Its
     ring launches join the kernels line;
  7g. the online tuner (phase online_tuning), ACCL_FABRIC=8 (one axis):
     ACCL_TUNE_ONLINE=1 makes a fresh CudaWorld(8) build the tuner and
     start its loop, close() stops it (with a 50 ms loop on an idle
     world), and unset builds none; then the cuda drill of
     accl_tpu_torch/scripts/retune_smoke.py on 4 MiB fp32 allreduces
     (host-staged, rank 2 sleeping 3 x the warm p50 before each call,
     ONLINE_CALLS calls a p50) with
     the world's own tuner at an hour's loop interval: the sentinel fires,
     step() closes episodes with decisions in DECISIONS (each A/B's busbw
     pair printed), an install clears the hysteresis, the p50 after the
     decisions is within ONLINE_HYSTERESIS of the degraded p50, the two
     read in ONLINE_ROUNDS interleaved rounds (never_slower); then a
     scripted episode installs compress_fp16 on the 16 MiB cell every run
     (a plan captured before it raises on replay, a re-capture replays
     bitwise, its p50 within 1.5 x the p50 before it), and every installed
     cell's served allreduce is bitwise its lane forced on a second world;
     /retunes from the exporter equals history_doc() and passes
     perf_doctor --ci --retunes.  Its ring launches join the kernels line;
  7h. utils (phase utils): traced_window("allreduce", xla_logdir=) around
     a 64 MiB allreduce on a fresh CudaWorld(8), run right after the
     build as the process's first torch.profiler session, writes a trace
     with >= 2 ring_kernel device events (the window's seconds with and
     without the capture); the 4-layer serving model's parameters through
     save_pytree / load_pytree on the card, bitwise; time_fn of the main
     world's 64 MiB allreduce beside its launches' device ms (5a); the
     same traced_window late in the process, where the profiler can drop
     the kernels' device records: each ring launch is in the trace or
     counted by xla_trace's warning;
  7i. the graft entry (phase graft_entry): accl_tpu_torch/scripts/
     graft_entry.py's entry() forward on the card and dryrun_multichip(8)
     (dp 2 x tp 2 x sp 2 step through the flash forward and backward
     kernels, the MoE step, a pipeline, zigzag and windowed sp attention,
     the driver collectives on CudaWorld(8) through the ring kernels),
     losses finite; its ring and flash launches join the kernels line;
  7j. ranks on several cards (phase multi_card): the cards, their
     peer-access matrix and `nvidia-smi topo -m`; on one card, always,
     the ring kernels' per-rank-table form (ring.rank_tables: the
     cross-card mode's tables, .sys flags and entry handshake in one
     launch) over a ragged segmented allreduce in the five kernel
     dtypes, SUM and MAX with NaN, three calls back to back, and at the
     driver's segment shape, bitwise against the one-launch form and the
     plain composition; with two or more cards, the cross-card ring lane
     through CudaWorld(P, devices=), one rank a card at 4-256 MiB per
     rank and two a card at 4 and 64 MiB, each rank's result on its own
     card and bitwise the plain composition, and every small lane
     (allreduce SUM and MAX, reduce, reduce_scatter, allgather, bcast,
     scatter, gather, alltoall, fused, int8, send/recv) bitwise the same
     calls on one card; with one card it prints that the cross-card part
     did not run.  The fused and int8 lanes as rings across the cards
     (lane_cards lines): on one card, always, CudaWorld(8, devices=
     ["cuda:0"] * 8) (the per-hop path, every move on one card) against
     CudaWorld(8) at LANE_CARDS_MIB a rank: the fused allreduce,
     reduce-scatter and all-gather, the fused allreduce over the int8
     wire and the int8 ring allreduce (threshold 0), then
     sync_gradients(compress="int8", devices=) over a Llama-3-8B
     MLP-down leaf ([4096, 14336] fp32, error feedback off and on,
     stochastic), each result bitwise, with its crossings and bytes a
     call; with two or more cards the same one rank a card, and the
     driver's four lanes (bench/multicard.py driver_rows: ring, fused,
     int8, fused_int8) at LANE_CARDS_MIB, bitwise, with their MiB
     between cards a call (lane_cards_driver lines).  Its ring launches
     join rows 1-2 of the kernels line, and rows ring_*_tables
     (ring_*_cross with two or more cards) time the mode
     (bench/multicard.py);
  7k. model meshes over several cards (phase model_cards, run after
     moe_path, before part a's world): with two or more cards, over
     min(4, count) of them: Llama-3-8B at full width and all 32 layers,
     bf16, tp = 4 (one shard a card; parallel.make_mesh(devices=),
     models.place_params): the 2 x 4096 forward and greedy generate of
     MC_NEW tokens from MC_PROMPT-token prompts; a dp 2 x tp 2 AdamW step
     at 2 layers, fp32; ring attention at sp = 4 over MC_SP_TOKENS tokens
     at Llama's heads, bf16, contiguous and zigzag; Switch-Base-8 at ep =
     8, two experts a card; and the TP contraction
     fused_matmul_allreduce_pallas at Llama's TP = 4 MLP-down, fp32, one
     rank a card (the fused kernel's cross-card mode) and on card 0 in
     its per-rank-table form (ring.rank_tables).  Each is held bitwise
     against the same mesh with every slot on card 0.  On one card the
     same meshes run with every slot on card 0, the model cut to 2
     layers, each held bitwise against the one-card forms (shard_params,
     the one-card ring, the one-launch kernels), and the phase prints
     that the cross-card part did not run.  The counts are set to 0 just
     before the per-card meshes are driven and read just after: the
     flash forward and backward kernels, the ring all-gather and the
     fused kernel's per-rank-table form (and, across cards, its
     cross-card mode) must launch, and across cards a counted move must
     cross.  Every card's stream runs its own backward: the AdamW step's
     crossings of the stream between cards (the spread, fan_out's fold
     down the cards and back, the exit's gradient to every card) are
     recorded and held to stream_schedule, card 0 receiving one a fold;
     with one card the phase prints that this cross-card backward did
     not run.  A Switch-Base-8 ep = 8 SGD step (each member's rows on its
     card from the embedding to the loss) is held bitwise to the same
     mesh on card 0, with one card to the one-card ep step (each leaf's
     update within MOE_UPDATE_BOUND, the loss within TRAIN_LOSS_BOUND),
     and the MoE forward is bitwise the same mesh on card 0, with one
     card the one-card ep forward.  Rows
     fused_matmul_reduce_scatter_tables (and _cross with two or more
     cards) time the mode (bench/model_cards.py).  Then the
     model's sp axis over the same slots (phase model_cards_sp,
     MC_SP_MESH = tp 2 x sp 2, 2 layers, attn="dense"): the bf16 forward
     over MC_SP_TOKENS tokens and one fp32 AdamW step over SP_TRAIN_TOKENS,
     each counted on its own (flash forward, backward and cross-card ring
     all-gather launches against sp_mesh_schedule) and held to the
     one-card sp forms (the forward bitwise, the step's moments and
     updates by relative L2 per leaf, adamw_readings), and across cards
     bitwise to the same mesh on card 0, the step's stream crossings
     held to stream_schedule (with one card: reported as not run);
  7l. cross-card launches under CUDA graph capture (phase cross_capture,
     after model_cards_sp, on card 0 in the per-rank-table form,
     ring.rank_tables, which launches the cross-card kernels): one graph
     captures a ring_reduce_scatter by sum and by max (P=8 x [8, n] fp32,
     n = DEFAULT_SEG_ELEMS / 8), a ring_all_gather ([n] a rank) and
     fused_matmul_allreduce_pallas at Llama-3-8B's TP = 4 MLP-down (fp32
     integers: the fused kernel, then the all-gather); the counts are
     set to 0 just before the capture and read just after (2, 2 and 1
     launches).  After an eager warm-up that makes the tables on the
     capture stream, the graph is replayed CAPTURE_REPLAYS times with
     eager launches on the same tables after each replay; every replay
     and every eager launch is bitwise its plain version and the first
     eager launch.  ms per replay and per eager run of the four, and of
     each alone in its own graph (rows ring_*_tables and
     fused_matmul_reduce_scatter_tables gain these launches and ms).
     Then generate on the card-0 Llama-3-8B bf16 tp = 4 placed mesh
     (MC_LAYERS["one"] layers, model_cards' slots) under rank_tables:
     its decode step captured once (DecodeGraph over the placement's
     cards) and replayed, its tokens those of graph=False; GRAPH_STEPS
     teacher-forced steps replayed and eager, ms per step, logits
     bitwise (or within LOGIT_BOUND, with a control that moves the last
     block's w2 by a bf16 ulp outside it);
  7m. a mesh over two processes on card 0 (phase multi_process, after
     cross_capture): the parent makes its one-process references (the
     dp 2 x tp 2 AdamW step at Llama-3-8B width, MC_LAYERS["one"]
     layers, MP_STEPS steps; the per-rank-table ring allreduce's times
     at MP_MIB MiB a rank), frees them, then starts two children of
     accl_tpu_torch/scripts/run_multihost_rank.py (--mode ring,step,
     MP_RANKS ranks each, make_hybrid_mesh's dcn axis over the
     processes).  Each child runs the ring allreduce across the
     processes at MP_MIB (ring_kernel_cross over CUDA IPC tables), each
     bitwise its one-process per-rank-table form, its counts set to 0
     just before and read just after (launches_procs must be > 0 in
     each; rows ring_*_procs carry their sum), hierarchical_all_reduce
     bitwise, each kernel alone at [8, n] beside its plain version
     across the processes, and the dp step, whose losses and every
     leaf's fingerprint must be bitwise the parent's.  A child's failure
     fails the phase, its output on the lines before;
  8. bench/sweep.py (phase sweep): run_sweep at SWEEP_WIDTHS and
     run_compression_sweep's allreduce at 2^24 elements, one JSON line a
     row (host-staged calls, not the resident driver numbers);
  9. bench/callrate.py (phase callrate) at 1024 elements and at 2^20 (the
     4 MiB ring lane): calls a second per lane (the plan_sync and
     plan_async replay lanes among them) and each lane's ratio to raw,
     with the async lane's batches and batched gangs.

The card-only tests run beside it with

    python -m pytest --noconftest -m cuda tests/test_torch_card.py

(--noconftest: tests/conftest.py imports JAX); among them a stacked ring
hop bitwise against per-member launches, the card's flash ring against
its plain version with gradients, and the MoE fused lane bitwise.

TF32 is off throughout (torch.backends.cuda.matmul.allow_tf32 = False):
the plain versions and yardsticks multiply in full fp32, as the kernels
do.  It prints one JSON line per measurement, a {"kernels": [...]}
line, the card's name and power limit, and last {"ok": true, "device":
{...}}.  Without CUDA it exits 2 and prints no result.
"""
import argparse
import copy
import importlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from accl_tpu_torch.bench.timing import events_ms as cuda_ms, split_ms

P = 8
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
SEED = 1234
#: Llama-3-8B at TP=8 and 4096 tokens: (M, K per rank, N) of the two
#: row-parallel projections.  MLP-down: intermediate 14336 / 8 = 1792;
#: attention-out: 32 heads x 128 / 8 = 512; hidden 4096.
TOKENS = 4096
TP_SHAPES = {"mlp_down": (TOKENS, 14336 // P, 4096),
             "attn_out": (TOKENS, 32 * 128 // P, 4096)}
RAGGED_MKN = (1000, 333, 777)
#: the flash kernels' wrappers in accl_tpu_torch/ops/flash.py
FLASH_KERNELS = ("flash_fwd_resident", "flash_fwd_grid", "flash_bwd_dq",
                 "flash_bwd_dkv", "flash_fwd_resident_skew")
#: chunks of the pipelined form fused_matmul_allreduce(chunks=...): its
#: matmuls run on M / (P CHUNKS)-row blocks
CHUNKS = 4
#: elements per rank of the ring all-gather in fused_matmul_allreduce_pallas
#: (a [M / P, N] block; N = 4096 at both shapes)
TP_GATHER_N = TOKENS // P * 4096
#: payload per rank of the fused and int8 driver lanes
LANE_MIB = 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rand(shape, dtype, gen) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    if dtype in (torch.int32, torch.int64):
        return (x * 1000).to(dtype)
    return x.to(dtype)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check_kernels(ring) -> dict:
    """Phase 3: each kernel against its plain version, bitwise (fp16
    within 1 ulp).  Returns the largest error per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"ring_reduce_scatter": 0.0, "ring_all_gather": 0.0}
    n_main = ring.DEFAULT_SEG_ELEMS // P
    for n in (n_main, 4099):
        for dtype, op in ((torch.float32, "sum"), (torch.float32, "max"),
                          (torch.float16, "sum"), (torch.int32, "sum")):
            xs = [rand((P, n), dtype, gen) for _ in range(P)]
            got = ring.ring_reduce_scatter(xs, op)
            torch.cuda.synchronize()
            want = ring.ring_reduce_scatter_plain(xs, op)
            for g, w in zip(got, want):
                e = max_err(g, w)
                errs["ring_reduce_scatter"] = max(errs["ring_reduce_scatter"],
                                                  e)
                if dtype == torch.float16:
                    ulp = (w.float().abs() * 2.0 ** -10).clamp_min(2.0 ** -24)
                    if ((g.float() - w.float()).abs() > ulp).any():
                        fail(f"ring_reduce_scatter fp16 {op} n={n}: more than "
                             f"1 ulp off (max abs err {e})")
                elif not torch.equal(g, w):
                    fail(f"ring_reduce_scatter {dtype} {op} n={n}: not "
                         f"bitwise equal to the plain version "
                         f"(max abs err {e})")
        for dt in (torch.float32, torch.float16, torch.int32):
            src = [rand((n,), dt, gen) for _ in range(P)]
            got_ag = ring.ring_all_gather(src)
            torch.cuda.synchronize()
            for g, w in zip(got_ag, ring.ring_all_gather_plain(src)):
                if not torch.equal(g, w):
                    fail(f"ring_all_gather {dt} n={n}: not bitwise equal "
                         f"to the plain version")
                errs["ring_all_gather"] = max(errs["ring_all_gather"],
                                              max_err(g, w))
    errs_walk = check_segment_walk(ring)
    for k in errs:
        errs[k] = max(errs[k], errs_walk)
    # the tensor-parallel path's all-gather: one reduced [M / P, N] f32
    # block per rank
    src = [rand((TP_GATHER_N,), torch.float32, gen) for _ in range(P)]
    got_ag = ring.ring_all_gather(src)
    torch.cuda.synchronize()
    for g, w in zip(got_ag, ring.ring_all_gather_plain(src)):
        if not torch.equal(g, w):
            fail(f"ring_all_gather fp32 n={TP_GATHER_N}: not bitwise equal "
                 f"to the plain version")
    del src, got_ag
    emit({"phase": "kernel_vs_plain", "ok": True, "max_abs_err": errs})
    return errs


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality that holds NaN to its payload."""
    if a.dtype.is_floating_point:
        iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(iv), b.view(iv))
    return torch.equal(a, b)


#: (N per rank, seg_elems) of the segment-walking checks: whole segments
#: of many tiles; a ragged tail at odd N; a ragged tail of chunk width 1;
#: and fewer elements than ranks
WALK_SHAPES = ((8 * 4 * 32768, 8 * 32768), (3 * 8 * 4099 + 13, 8 * 4099),
               (8 * 1000 + 5, 8 * 1000), (5, 1 << 18))


def check_segment_walk(ring) -> float:
    """Phase 3: the segment-walking launches (one per phase over every
    segment of an allreduce) against the plain composition, bitwise, in
    every kernel dtype, SUM and MAX (MAX with NaN present), out of place
    and in place; and the one-segment forms at 1 and many tiles."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = 0.0
    for (N, seg), dtype, op in itertools.product(
            WALK_SHAPES, ring.KERNEL_DTYPES, ("sum", "max")):
        xs = [rand((N,), dtype, gen) for _ in range(P)]
        if op == "max" and dtype.is_floating_point:
            for r, x in enumerate(xs):
                x[r::97] = float("nan")
        want = ring.ring_all_reduce_segmented(xs, op, seg, plain=True)
        got = ring.ring_all_reduce_segmented(xs, op, seg)
        same = [x.clone() for x in xs]
        ring.ring_all_reduce_segmented(same, op, seg, out=same)
        torch.cuda.synchronize()
        for r in range(P):
            for what, g in (("out of place", got[r]), ("in place", same[r])):
                if not same_bits(g, want[r]):
                    fail(f"segment walk {dtype} {op} N={N} seg={seg} "
                         f"{what} rank {r}: not bitwise equal to the plain "
                         f"composition")
            if op == "sum":
                worst = max(worst, max_err(got[r], want[r]))
    for n, dtype in itertools.product((256, 4099, 3 * 32768 + 7),
                                      ring.KERNEL_DTYPES):
        xs = [rand((P, n), dtype, gen) for _ in range(P)]
        got = ring.ring_reduce_scatter(xs, "sum")
        gathered = ring.ring_all_gather(got)
        torch.cuda.synchronize()
        for g, w in zip(got, ring.ring_reduce_scatter_plain(xs, "sum")):
            if not same_bits(g, w):
                fail(f"ring_reduce_scatter {dtype} n={n}: not bitwise equal "
                     f"to the plain version")
        for g, w in zip(gathered, ring.ring_all_gather_plain(got)):
            if not same_bits(g, w):
                fail(f"ring_all_gather {dtype} n={n}: not bitwise equal to "
                     f"the plain version")
    emit({"phase": "segment_walk_vs_plain", "ok": True,
          "shapes": [list(s) for s in WALK_SHAPES],
          "dtypes": [str(d) for d in ring.KERNEL_DTYPES]})
    return worst


def ints(shape, dtype, gen) -> torch.Tensor:
    """Integer values in [-3, 3]: every product and partial sum of the
    matmuls here is exact in fp32 (and in bf16 inputs)."""
    return torch.randint(-3, 4, shape, generator=gen, device="cuda").to(dtype)


def ref64(xs, ws):
    """float64 sum_r xs[r] @ ws[r] and two bounds on an fp32 result's
    error, from a = sum_r |xs[r]| @ |ws[r]| and K_total, the length of
    the whole sum:
    - worst case: 2 K_total 2^-24 a, which no fp32 order can exceed;
    - spread: sqrt(K_total) 2^-24 a, the reach of rounding errors that
      add as a random walk.  An fp32 product stays far inside it, one
      that rounds its operands to TF32 or bf16 does not (the controls
      of check_fused_kernels measure both).
    xs[r] may carry leading batch dimensions."""
    ref = absref = None
    for x, w in zip(xs, ws):
        xd, wd = x.double(), w.double()
        p, a = xd @ wd, xd.abs() @ wd.abs()
        ref = p if ref is None else ref + p
        absref = a if absref is None else absref + a
    k_total = len(xs) * xs[0].shape[-1]
    return (ref, 2 * k_total * 2.0 ** -24 * absref,
            np.sqrt(k_total) * 2.0 ** -24 * absref)


def within_bound(got, ref, bound) -> bool:
    return bool(((got.double() - ref).abs() <= bound).all())


def spread_ratio(got, want, spread) -> float:
    """max |got - want| / spread, elementwise."""
    return float(((got.double() - want.double()).abs() / spread).max())


def hold(what, got, plain, ref, worst, spread) -> float:
    """An fp32-accumulating result on N(0, 1) inputs: within the worst
    case of float64, and within the fp32 spread of its plain version.
    Returns max |got - plain|."""
    if not within_bound(got, ref, worst):
        fail(f"{what}: outside the dot-product bound of float64 (max abs "
             f"err {max_err(got, ref)})")
    if not within_bound(got, plain.double(), spread):
        fail(f"{what}: off its plain version by more than the fp32 spread "
             f"sqrt(K) 2^-24 (|x|@|w|) (max abs err {max_err(got, plain)}, "
             f"{spread_ratio(got, plain, spread)} of the spread): does it "
             f"round its operands?")
    return max_err(got, plain)


def controls(plain_fn, xs, ws, plain, spread) -> dict:
    """What the spread check reads on the plain version computed with
    reduced-precision operands, the faults it is there to catch: bf16
    operands, which must read above 1 (outside the spread) or the check
    proves nothing, and TF32 (cuBLAS with allow_tf32), printed beside."""
    got = {}
    bf = plain_fn([x.bfloat16() for x in xs], [w.bfloat16() for w in ws])
    got["bf16_operands"] = max(spread_ratio(b, p, s)
                               for b, p, s in zip(bf, plain, spread))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf = plain_fn(xs, ws)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    got["tf32"] = max(spread_ratio(t, p, s)
                      for t, p, s in zip(tf, plain, spread))
    if not got["bf16_operands"] > 1:
        fail(f"the spread check does not catch bf16 operands: they read "
             f"{got['bf16_operands']} of the spread")
    return got


def check_fused_kernels(F) -> dict:
    """Phase 3, matmul kernels: accl_matmul and accl_fused_matmul_rs
    against their plain versions at every shape the tensor-parallel path
    gives them (A: M and M / (P C) rows; B: m = M / P) and a ragged one,
    f32 and bf16: bitwise on integer-valued inputs; on N(0, 1) inputs
    within the worst case of float64 and the fp32 spread of the plain
    version (``hold``).  Returns the largest |kernel - plain| per kernel
    on the random inputs, the spread ratios per kernel and those of the
    reduced-precision controls."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    errs = {"pallas_matmul": 0.0, "fused_matmul_reduce_scatter": 0.0}
    ratios = {"pallas_matmul": 0.0, "fused_matmul_reduce_scatter": 0.0}
    ctl = {}

    def a_plain(xs, ws):
        return [F.pallas_matmul_plain(xs[0], ws[0])]

    for M, K, N in (*TP_SHAPES.values(), RAGGED_MKN):
        a_rows = (M, M // (P * CHUNKS)) if (M, K, N) != RAGGED_MKN else (M,)
        m = M // P
        for dt in (torch.float32, torch.bfloat16):
            for rows in a_rows:
                tag = f"pallas_matmul [{rows},{K}]@[{K},{N}] {dt}"
                x, w = ints((rows, K), dt, gen), ints((K, N), dt, gen)
                got = F.pallas_matmul(x, w)
                torch.cuda.synchronize()
                if not torch.equal(got, F.pallas_matmul_plain(x, w)):
                    fail(f"{tag}: integer inputs not bitwise equal to the "
                         f"plain version")
                x, w = rand((rows, K), dt, gen), rand((K, N), dt, gen)
                got = F.pallas_matmul(x, w)
                torch.cuda.synchronize()
                plain = F.pallas_matmul_plain(x, w)
                ref, worst, spread = ref64([x], [w])
                errs["pallas_matmul"] = max(errs["pallas_matmul"], hold(
                    tag, got, plain, ref, worst, spread))
                ratios["pallas_matmul"] = max(ratios["pallas_matmul"],
                                              spread_ratio(got, plain, spread))
                if dt == torch.float32 and rows == M:
                    ctl[f"pallas_matmul [{M},{K}]@[{K},{N}]"] = controls(
                        a_plain, [x], [w], [plain], [spread])
                del x, w, got, plain, ref, worst, spread

            tag = (f"fused_matmul_reduce_scatter P={P} x [{P},{m},{K}] @ "
                   f"[{K},{N}] {dt}")
            xs = [ints((P, m, K), dt, gen) for _ in range(P)]
            ws = [ints((K, N), dt, gen) for _ in range(P)]
            got = F.fused_matmul_reduce_scatter(xs, ws)
            torch.cuda.synchronize()
            want = F.fused_matmul_reduce_scatter_plain(xs, ws)
            if not all(torch.equal(g, v) for g, v in zip(got, want)):
                fail(f"{tag}: integer inputs not bitwise equal to the plain "
                     f"version")
            xs = [rand((P, m, K), dt, gen) for _ in range(P)]
            ws = [rand((K, N), dt, gen) for _ in range(P)]
            got = F.fused_matmul_reduce_scatter(xs, ws)
            torch.cuda.synchronize()
            want = F.fused_matmul_reduce_scatter_plain(xs, ws)
            ref, worst, spread = ref64(xs, ws)  # [P, m, N]: block r is rank r's
            for r in range(P):
                errs["fused_matmul_reduce_scatter"] = max(
                    errs["fused_matmul_reduce_scatter"],
                    hold(f"{tag} rank {r}", got[r], want[r], ref[r], worst[r],
                         spread[r]))
                ratios["fused_matmul_reduce_scatter"] = max(
                    ratios["fused_matmul_reduce_scatter"],
                    spread_ratio(got[r], want[r], spread[r]))
            if dt == torch.float32 and (M, K, N) != RAGGED_MKN:
                ctl[f"fused_matmul_reduce_scatter [{P},{m},{K}]@[{K},{N}]"] = \
                    controls(F.fused_matmul_reduce_scatter_plain, xs, ws,
                             want, list(spread))
            del xs, ws, got, want, ref, worst, spread
    torch.cuda.empty_cache()
    emit({"phase": "matmul_kernels_vs_plain", "ok": True,
          "max_abs_err_vs_plain": errs, "max_spread_ratio": ratios,
          "control_spread_ratios": ctl})
    return errs


def tensor_core_ops(lib_path) -> int:
    """Tensor-core instructions (HMMA, HGMMA, IMMA) in a built library's
    SASS: the matmul kernels must multiply in full fp32."""
    from accl_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or "Function" not in out.stdout:
        fail(f"cuobjdump -sass {lib_path}: {out.stderr.strip()[:500]}")
    return len(re.findall(r"\b(?:HMMA|HGMMA|IMMA)\b", out.stdout))


#: a flash kernel's mangled symbol: name, element type, D
KERNEL_SYMBOL = (r"(flash_bwd_(?:dq|dkv)_[fm]ma|flash_fwd_(?:fma|wgmma))"
                 r"I(f|13__nv_bfloat16)Li(\d+)E")
TENSOR_CORE_OPS = ("HGMMA", "HMMA", "IMMA")


def tensor_core_ops_by_function(lib_path) -> dict:
    """Tensor-core instructions (HGMMA, HMMA, IMMA, counted apart) per
    kernel of a built library's SASS, by the kernel's name as it appears
    in the mangled symbol, with its template arguments:
    flash_bwd_dq_mma<float, 128>, flash_fwd_wgmma<bf16, 64>."""
    from accl_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or "Function" not in out.stdout:
        fail(f"cuobjdump -sass {lib_path}: {out.stderr.strip()[:500]}")
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        m = re.search(KERNEL_SYMBOL, part.split()[0])
        name = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}, "
                f"{m.group(3)}>") if m else part.split()[0]
        counts[name] = {op: len(re.findall(rf"\b{op}\b", part))
                        for op in TENSOR_CORE_OPS}
    return counts


def check_flash_sass(lib_path, prefix, fp32, tc, n) -> dict:
    """The tensor-core instructions of one flash library's kernels per
    instantiation: the fp32 mainloop (``fp32``, the float32 MXU dtype)
    must hold none, the bf16 one (``tc``) some, ``n`` instantiations
    each.  Returns the counts, HGMMA and HMMA apart."""
    counts = {k: v for k, v in tensor_core_ops_by_function(lib_path).items()
              if k.startswith(prefix)}
    fma = {k: sum(v.values()) for k, v in counts.items() if f"{fp32}<" in k}
    mma = {k: sum(v.values()) for k, v in counts.items() if f"{tc}<" in k}
    if len(fma) != n or len(mma) != n:
        fail(f"{prefix} SASS: expected {n} fp32 and {n} bf16-MXU kernels, "
             f"found {sorted(counts)}")
    if any(fma.values()) or not all(mma.values()):
        fail(f"{prefix} SASS: the fp32 kernels must hold no tensor-core "
             f"instruction and the bf16-MXU ones some: {counts}")
    return counts


def check_flash_bwd_sass(lib_path) -> dict:
    """The flash backward kernels: ``*_fma`` none, ``*_mma`` some, 12
    instantiations each."""
    return check_flash_sass(lib_path, "flash_bwd_", "_fma", "_mma", 12)


def check_flash_fwd_sass(lib_path) -> dict:
    """The flash forward kernels (every schedule): ``flash_fwd_fma``
    none, ``flash_fwd_wgmma`` some, 6 instantiations each (2 input dtypes
    x 3 head sizes)."""
    return check_flash_sass(lib_path, "flash_fwd_", "_fma", "_wgmma", 6)


#: the kernels of csrc/fused.cu in the order accl_fused_kernel_info numbers
#: them
FUSED_KERNEL_NAMES = ("matmul_kernel<float, 128>", "matmul_kernel<float, 64>",
                      "matmul_kernel<bf16, 128>", "matmul_kernel<bf16, 64>",
                      "fused_matmul_rs_kernel<float>",
                      "fused_matmul_rs_kernel<bf16>",
                      "fused_matmul_rs_cross_kernel<float>",
                      "fused_matmul_rs_cross_kernel<bf16>")


def fused_kernel_info(F) -> dict:
    """Registers, spill (local) bytes, static and dynamic shared memory and
    resident blocks per SM of each matmul kernel, as the runtime reports
    them at the footprint it is launched with."""
    import ctypes

    from accl_tpu_torch.ops import _build

    lib = _build.load("fused")
    info = {}
    for which, name in enumerate(FUSED_KERNEL_NAMES):
        out = (ctypes.c_int * 5)()
        rc = lib.accl_fused_kernel_info(which, torch.cuda.current_device(),
                                        out)
        if rc:
            F._raise_on(lib, rc, f"accl_fused_kernel_info {name}")
        info[name] = dict(zip(("registers", "local_bytes", "static_smem",
                               "dynamic_smem", "blocks_per_sm"), out))
        if info[name]["blocks_per_sm"] < 1:
            fail(f"{name} does not fit on an SM: {info[name]}")
    return info


def reset_counts(ring, F, FL=None, PL=None) -> None:
    """Every launch count to 0: the ring and matmul wrappers, the flash
    wrappers (FL) and the plugin wrappers (PL, name -> wrapper)."""
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather,
               F.pallas_matmul, F.fused_matmul_reduce_scatter):
        fn.launches = 0
    if FL is not None:
        for fn in FLASH_KERNELS:
            getattr(FL, fn).launches = 0
    for fn in (PL or {}).values():
        fn.launches = 0


def read_counts(ring, F, FL=None, PL=None) -> dict:
    counts = {"ring_reduce_scatter": ring.ring_reduce_scatter.launches,
              "ring_all_gather": ring.ring_all_gather.launches,
              "pallas_matmul": F.pallas_matmul.launches,
              "fused_matmul_reduce_scatter":
                  F.fused_matmul_reduce_scatter.launches}
    if FL is not None:
        counts.update({fn: getattr(FL, fn).launches for fn in FLASH_KERNELS})
    counts.update({name: fn.launches for name, fn in (PL or {}).items()})
    return counts


def tp_path(ring, F) -> dict:
    """Phase 4b: the fused tensor-parallel matmul at Llama-3-8B's TP=8
    widths, 8 rank lists.  Each form's result is held to the float64 sum
    and to the same form built from the plain versions (``hold``).
    Returns the launches of the run and those of one
    fused_matmul_allreduce_pallas call at the MLP-down shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    inputs = {}
    for name, (M, K, N) in TP_SHAPES.items():
        inputs[name] = ([rand((M, K), torch.float32, gen) for _ in range(P)],
                        [rand((K, N), torch.float32, gen) for _ in range(P)])
    torch.cuda.synchronize()

    def pallas_plain(xs, ws):
        M, K = xs[0].shape
        mine = F.fused_matmul_reduce_scatter_plain(
            [x.view(P, M // P, K) for x in xs], ws)
        return [g.view(M, -1) for g in
                ring.ring_all_gather_plain([b.view(-1) for b in mine])]

    forms = {
        "fused_matmul_allreduce_pallas": (
            F.fused_matmul_allreduce_pallas, pallas_plain),
        f"fused_matmul_allreduce_chunks{CHUNKS}": (
            lambda xs, ws: F.fused_matmul_allreduce(
                xs, ws, use_pallas=True, chunks=CHUNKS),
            lambda xs, ws: F.fused_matmul_allreduce(
                xs, ws, use_pallas=False, chunks=CHUNKS))}
    per_call = {}
    reset_counts(ring, F)
    for name, (xs, ws) in inputs.items():
        ref, worst, spread = ref64(xs, ws)
        for form, (run, run_plain) in forms.items():
            before = read_counts(ring, F)
            t0 = time.perf_counter()
            outs = run(xs, ws)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            after = read_counts(ring, F)
            launched = {k: after[k] - before[k] for k in after}
            if name == "mlp_down" and form == "fused_matmul_allreduce_pallas":
                per_call = launched
            plain = run_plain(xs, ws)
            err_plain = 0.0
            for r, o in enumerate(outs):
                if tuple(o.shape) != tuple(ref.shape) or \
                        not torch.isfinite(o).all():
                    fail(f"{form} {name} rank {r}: shape {tuple(o.shape)} or "
                         f"non-finite values")
                err_plain = max(err_plain, hold(f"{form} {name} rank {r}", o,
                                                plain[r], ref, worst, spread))
                if not torch.equal(o, outs[0]):
                    fail(f"{form} {name}: rank {r} differs from rank 0")
            emit({"phase": "tp_path", "shape": name, "form": form,
                  "M_K_N_per_rank": list(TP_SHAPES[name]), "ranks": P,
                  "max_abs_err_vs_f64": max_err(outs[0], ref),
                  "max_abs_err_vs_plain": err_plain,
                  "max_spread_ratio_vs_plain": spread_ratio(outs[0], plain[0],
                                                            spread),
                  "launches": launched, "first_call_s": first_s, "ok": True})
            del outs, plain
        del ref, worst, spread
    launches = read_counts(ring, F)
    for k in ("pallas_matmul", "fused_matmul_reduce_scatter",
              "ring_all_gather"):
        if launches[k] < 1:
            fail(f"the tensor-parallel path did not launch {k}: {launches}")
    del inputs
    torch.cuda.empty_cache()
    return {"launches": launches, "per_call_mlp_down": per_call}


def lane_bufs(world, in_len, out_len, gen):
    sends = [world.accls[r].create_buffer(in_len, np.float32)
             for r in range(P)]
    recvs = [world.accls[r].create_buffer(out_len, np.float32)
             for r in range(P)]
    fill(sends, gen)
    return sends, recvs


def driver_lanes(world, ring, F, q_ops, DataType, CompressionPolicy) -> dict:
    """Phase 4c: the fused and int8 driver lanes at LANE_MIB per rank on
    the same world, each checked against the lossless ring lane (fused)
    or the plain int8 composition (int8).  Returns, per lane, the call
    that runs it and its busbw factor, for phase 5."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    count = LANE_MIB * MIB // 4
    n = count // P
    ar_s, ar_r = lane_bufs(world, count, count, gen)
    rs_s, rs_r = lane_bufs(world, count, n, gen)
    ag_s, ag_r = lane_bufs(world, n, count, gen)
    outs = {}
    torch.cuda.synchronize()
    reset_counts(ring, F)

    def caller(kind, sends, recvs, cnt, **kw):
        def call(accl, rank):
            getattr(accl, kind)(sends[rank], recvs[rank], cnt,
                                from_fpga=True, to_fpga=True, **kw)
        return call

    def ef_policy(on):
        pol = CompressionPolicy(dtype=DataType.int8, error_feedback=True)
        for a in world.accls:
            a.set_compression(pol if on else None)

    i8 = DataType.int8
    lanes = {
        "ring_allreduce": (caller("allreduce", ar_s, ar_r, count), ar_r,
                           2 * (P - 1) / P, False),
        "fused_allreduce": (caller("allreduce", ar_s, ar_r, count,
                                   fused=True), ar_r, 2 * (P - 1) / P, False),
        "int8_allreduce": (caller("allreduce", ar_s, ar_r, count,
                                  compress_dtype=i8), ar_r, 2 * (P - 1) / P,
                           False),
        "int8_ef_allreduce": (caller("allreduce", ar_s, ar_r, count,
                                     compress_dtype=i8), ar_r,
                              2 * (P - 1) / P, True),
        "ring_reduce_scatter": (caller("reduce_scatter", rs_s, rs_r, n),
                                rs_r, (P - 1) / P, False),
        "fused_reduce_scatter": (caller("reduce_scatter", rs_s, rs_r, n,
                                        fused=True), rs_r, (P - 1) / P, False),
        "ring_allgather": (caller("allgather", ag_s, ag_r, n), ag_r,
                           (P - 1) / P, False),
        "fused_allgather": (caller("allgather", ag_s, ag_r, n, fused=True),
                            ag_r, (P - 1) / P, False),
    }
    for name, (call, recvs, _bus, ef) in lanes.items():
        ef_policy(ef)
        before = read_counts(ring, F)
        t0 = time.perf_counter()
        world.run(call)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        after = read_counts(ring, F)
        ef_policy(False)
        outs[name] = [r.dev.clone() for r in recvs]
        emit({"phase": "driver_lane_run", "lane": name,
              "mib_per_rank": LANE_MIB, "first_call_s": first_s,
              "launches": {k: after[k] - before[k] for k in after}})
    launches = read_counts(ring, F)

    xs = [b.dev for b in ar_s]
    one_segment = ring.ring_all_reduce_segmented(xs, "sum",
                                                 seg_elems=count, plain=True)
    full = torch.stack([x.double() for x in xs]).sum(0)
    checks = (("fused_allreduce", one_segment),
              ("fused_reduce_scatter", outs["ring_reduce_scatter"]),
              ("fused_allgather", outs["ring_allgather"]))
    for name, want in checks:
        for r in range(P):
            if not torch.equal(outs[name][r], want[r]):
                fail(f"{name} rank {r}: not bitwise equal to the ring lane "
                     f"(max abs err {max_err(outs[name][r], want[r])})")
    for r in range(P):
        if not torch.allclose(outs["fused_allreduce"][r].double(), full,
                              rtol=1e-5, atol=1e-5):
            fail(f"fused_allreduce rank {r}: off the float64 reference")
    del one_segment
    bound = P * (2 * 5 * np.sqrt(P) / 127)
    errs = {}
    for name, ef in (("int8_allreduce", False), ("int8_ef_allreduce", True)):
        want = q_ops.quantized_all_reduce(xs, q_ops.DEFAULT_BLOCK, ef)
        for r in range(P):
            if not torch.equal(outs[name][r], want[r]):
                fail(f"{name} rank {r}: not bitwise equal to the plain int8 "
                     f"composition")
        errs[name] = max_err(outs[name][0], full)
        if errs[name] > bound or not torch.isfinite(outs[name][0]).all():
            fail(f"{name}: max abs err {errs[name]} against float64 over "
                 f"the bound {bound}")
        del want
    if torch.equal(outs["int8_allreduce"][0], outs["int8_ef_allreduce"][0]):
        fail("error feedback left the int8 result unchanged")
    emit({"phase": "driver_lanes", "mib_per_rank": LANE_MIB, "ranks": P,
          "int8_max_abs_err_vs_f64": errs, "int8_err_bound": bound,
          "launches": launches, "ok": True})
    del outs, full
    torch.cuda.empty_cache()
    return {"lanes": {k: (v[0], v[2], v[3]) for k, v in lanes.items()},
            "set_ef": ef_policy, "launches": launches}


def time_lanes(world, lanes, set_ef) -> list:
    """Phase 5c: seconds per call and busbw of each lane at LANE_MIB per
    rank, host clock around calls that end in a synchronize."""
    rows = []
    for name, (call, bus, ef) in lanes.items():
        set_ef(ef)
        world.run(call)
        torch.cuda.synchronize()
        samples = []
        for _ in range(3):
            t = time.perf_counter()
            for _ in range(3):
                world.run(call)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t) / 3)
        set_ef(False)
        s = statistics.median(samples)
        algbw = LANE_MIB * MIB / s / 1e9
        row = {"phase": "driver_lane_time", "lane": name,
               "mib_per_rank": LANE_MIB, "ranks": P, "s_per_call": s,
               "algbw_GBps": algbw, "busbw_GBps": algbw * bus}
        emit(row)
        rows.append(row)
    return rows


def matmul_bound(ops, nbytes, dt) -> tuple:
    """(bound ms, "operations" or "bytes") for ops on dt inputs moving
    nbytes."""
    peak = FP32_FLOPS if dt == torch.float32 else BF16_FLOPS
    ops_ms = ops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def time_matmul(F, rows, K, N, dt, gen, iters) -> dict:
    """accl_matmul on [rows, K] @ [K, N] per launch, interleaved with its
    plain version (kernel, plain, plain, kernel), beside torch.matmul and
    the bound."""
    x, w = rand((rows, K), dt, gen), rand((K, N), dt, gen)
    out = torch.empty(rows, N, device="cuda")
    ms = [cuda_ms(lambda: F.pallas_matmul(x, w, out=out), iters)]
    plain = [cuda_ms(lambda: F.pallas_matmul_plain(x, w), iters)]
    plain.append(cuda_ms(lambda: F.pallas_matmul_plain(x, w), iters))
    ms.append(cuda_ms(lambda: F.pallas_matmul(x, w, out=out), iters))
    # device time with the stream held, apart from the host's enqueue
    split = split_ms(lambda: F.pallas_matmul(x, w, out=out), iters)
    lib = cuda_ms(lambda: torch.matmul(x, w), iters)
    el = torch.finfo(dt).bits // 8
    ops = 2 * rows * K * N
    bound, by = matmul_bound(ops, (rows * K + K * N) * el + rows * N * 4, dt)
    return {"shape": f"[{rows},{K}] @ [{K},{N}] {dt}",
            "ms": statistics.median(ms), "plain_ms": statistics.median(plain),
            "library_ms": lib, "bound_ms": bound, "bound_by": by,
            "tflops": ops / (statistics.median(ms) * 1e-3) / 1e12,
            "device_ms": split["device_ms"],
            "host_enqueue_ms": split["host_enqueue_ms"],
            "plan": list(F._plan(rows, N, K, torch.cuda.current_device()))}


def time_fused_kernels(ring, F, errs, launches, per_call) -> list:
    """Phase 5b: the matmul kernels per launch at the MLP-down shapes the
    tensor-parallel path launches them at, f32 as there: accl_matmul on
    M / (P CHUNKS) = 128-row blocks (fused_matmul_allreduce(chunks=...)),
    with its time at M rows beside; accl_fused_matmul_rs at m = M / P.
    Each beside its plain version, its library yardstick and its bound;
    bf16 times are printed beside."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    M, K, N = TP_SHAPES["mlp_down"]
    m = M // P
    counts0 = read_counts(ring, F)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        el = torch.finfo(dt).bits // 8
        a_row = time_matmul(F, M // (P * CHUNKS), K, N, dt, gen, 20)
        a_full = time_matmul(F, M, K, N, dt, gen, 5)
        xs = [rand((P, m, K), dt, gen) for _ in range(P)]
        ws = [rand((K, N), dt, gen) for _ in range(P)]
        outs = [torch.empty(m, N, device="cuda") for _ in range(P)]
        # interleaved: kernel, plain, plain, kernel
        b_ms = [cuda_ms(lambda: F.fused_matmul_reduce_scatter(xs, ws, outs),
                        2, runs=3)]
        b_plain = [cuda_ms(lambda: F.fused_matmul_reduce_scatter_plain(
            xs, ws), 2, runs=3)]
        b_plain.append(cuda_ms(lambda: F.fused_matmul_reduce_scatter_plain(
            xs, ws), 2, runs=3))
        b_ms.append(cuda_ms(lambda: F.fused_matmul_reduce_scatter(
            xs, ws, outs), 2, runs=3))
        b_split = split_ms(lambda: F.fused_matmul_reduce_scatter(
            xs, ws, outs), 2, runs=3)

        def library_b():
            # each rank's P partials in one matmul, then the sum over ranks
            parts = torch.stack([torch.matmul(x.view(P * m, K), w)
                                 for x, w in zip(xs, ws)])
            return torch.sum(parts, dim=0).view(P, m, N)

        b_lib = cuda_ms(library_b, 2, runs=3)
        del xs, ws, outs
        torch.cuda.empty_cache()
        b_ops = 2 * P * P * m * K * N
        b_bound, b_by = matmul_bound(
            b_ops, (P * P * m * K + P * K * N) * el + P * m * N * 4, dt)
        lib_tag = " (bf16 out, tensor cores)" if dt == torch.bfloat16 else ""
        a_extra = {f"at_M{M}": {k: a_full[k] for k in
                                ("shape", "ms", "plain_ms", "library_ms",
                                 "bound_ms", "tflops", "device_ms",
                                 "host_enqueue_ms", "plan")},
                   "device_ms": a_row["device_ms"],
                   "host_enqueue_ms": a_row["host_enqueue_ms"],
                   "plan": a_row["plan"]}
        b_row = {"shape": f"P={P} x [{P},{m},{K}] @ [{K},{N}] {dt}",
                 "ms": statistics.median(b_ms),
                 "plain_ms": statistics.median(b_plain), "library_ms": b_lib,
                 "bound_ms": b_bound, "bound_by": b_by,
                 "tflops": b_ops / (statistics.median(b_ms) * 1e-3) / 1e12}
        b_extra = {k: b_split[k] for k in ("device_ms", "host_enqueue_ms")}
        for name, t, kernel, fn_line, lib_call, extra in (
                ("pallas_matmul", a_row, "accl_matmul",
                 "accl_tpu/ops/fused.py:341", "torch.matmul", a_extra),
                ("fused_matmul_reduce_scatter", b_row,
                 "accl_fused_matmul_rs", "accl_tpu/ops/fused.py:476",
                 "torch.matmul per rank + torch.sum over ranks", b_extra)):
            row = {"name": name, "route": "cuda",
                   "source": "accl_tpu_torch/ops/csrc/fused.cu",
                   "kernel": kernel, "replaces": fn_line,
                   "launches": launches[name],
                   "max_abs_err": errs[name], "ms": t["ms"],
                   "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                   "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                   "library_call": lib_call + lib_tag, "checked": True,
                   "shape": t["shape"], "tflops": t["tflops"],
                   "launches_per_fused_matmul_allreduce_pallas_mlp_down":
                       per_call.get(name, 0), **extra}
            if dt == torch.bfloat16:
                emit({"phase": "kernel_time_bf16", **row})
            else:
                emit({"phase": "kernel_time", **row})
                rows.append(row)
    for fn, k in ((ring.ring_reduce_scatter, "ring_reduce_scatter"),
                  (ring.ring_all_gather, "ring_all_gather"),
                  (F.pallas_matmul, "pallas_matmul"),
                  (F.fused_matmul_reduce_scatter,
                   "fused_matmul_reduce_scatter")):
        fn.launches = counts0[k]  # the timing launches are not main-path
    return rows


def fill(bufs, gen):
    for b in bufs:
        b.dev.copy_(torch.randn(b.dev.shape[0], generator=gen, device="cuda"))


def main_path(ring, F, CudaWorld, ReduceFunction, sizes) -> dict:
    """Phase 4a: the driver's main path through ACCL on 8 rank threads."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    world = CudaWorld(P)  # the card, by default
    reset_counts(ring, F)
    per_size = {}
    try:
        # -- below the ring threshold: host-synced calls -----------------
        n = 4096
        host_in = [np.random.default_rng(SEED + r).standard_normal(
            n * P).astype(np.float32) for r in range(P)]

        def small(accl, rank):
            x = accl.create_buffer_like(host_in[rank])
            out = {}
            b = accl.create_buffer(n, np.float32)
            if rank == 3:
                b.host[:] = x.host[:n]
            accl.bcast(b, n, root=3)
            out["bcast"] = b.host.copy()
            g = accl.create_buffer(n * P, np.float32)
            accl.gather(x, g, n, root=0)
            out["gather"] = g.host.copy()
            s = accl.create_buffer(n, np.float32)
            accl.scatter(x, s, n, root=5)
            out["scatter"] = s.host.copy()
            a2a = accl.create_buffer(n * P, np.float32)
            accl.alltoall(x, a2a, n)
            out["alltoall"] = a2a.host.copy()
            ar = accl.create_buffer(n * P, np.float32)
            accl.allreduce(x, ar, n * P)
            out["allreduce"] = ar.host.copy()
            return out

        res = world.run(small)
        total = np.sum(np.stack(host_in).astype(np.float64), axis=0)
        for r in range(P):
            ok = (np.array_equal(res[r]["bcast"], host_in[3][:n])
                  and np.array_equal(res[r]["scatter"],
                                     host_in[5][r * n:(r + 1) * n])
                  and np.array_equal(res[r]["alltoall"], np.concatenate(
                      [host_in[s][r * n:(r + 1) * n] for s in range(P)]))
                  and np.allclose(res[r]["allreduce"], total, rtol=1e-5,
                                  atol=1e-5))
            if not ok:
                fail(f"small collectives: rank {r} result wrong")
        if not np.array_equal(res[0]["gather"], np.concatenate(
                [host_in[s][:n] for s in range(P)])):
            fail("small collectives: gather result wrong")
        small_launches = (ring.ring_reduce_scatter.launches,
                          ring.ring_all_gather.launches)
        if small_launches != (0, 0):
            fail(f"a payload below the threshold launched ring kernels "
                 f"{small_launches}")
        emit({"phase": "below_threshold", "ok": True})

        # -- the ring lane: device-resident calls ------------------------
        def ring_case(kind, nbytes, func=ReduceFunction.SUM):
            count = nbytes // 4
            m = count // P
            in_len = count
            out_len = count if kind == "allreduce" else (
                count * P if kind == "allgather" else m)
            cnt = m if kind == "reduce_scatter" else count
            sends = [world.accls[r].create_buffer(in_len, np.float32)
                     for r in range(P)]
            recvs = [world.accls[r].create_buffer(out_len, np.float32)
                     for r in range(P)]
            fill(sends, gen)
            torch.cuda.synchronize()
            before = (ring.ring_reduce_scatter.launches,
                      ring.ring_all_gather.launches)

            def call(accl, rank):
                fn = getattr(accl, kind)
                kw = {"from_fpga": True, "to_fpga": True}
                if kind != "allgather":
                    kw["function"] = func
                fn(sends[rank], recvs[rank], cnt, **kw)

            t0 = time.perf_counter()
            world.run(call)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launched = (ring.ring_reduce_scatter.launches - before[0],
                        ring.ring_all_gather.launches - before[1])
            # one launch per phase per call, whatever the segment count
            expect = {"allreduce": (1, 1), "allgather": (0, 1),
                      "reduce_scatter": (1, 0)}[kind]
            if launched != expect:
                fail(f"{kind} {nbytes // MIB} MiB launched (reduce-scatter, "
                     f"all-gather) = {launched}, not {expect}")
            xs = [b.dev for b in sends]
            red = "max" if func == ReduceFunction.MAX else "sum"
            if kind == "allreduce":
                want = ring.ring_all_reduce_segmented(xs, red, plain=True)
                stacked = torch.stack([x.double() for x in xs])
                ref = [stacked.amax(0) if red == "max" else stacked.sum(0)] * P
            elif kind == "allgather":
                want = ring.ring_all_gather_segmented(xs, plain=True)
                ref = [torch.cat(xs).double()] * P
            else:
                want = ring.ring_reduce_scatter_segmented(xs, red, plain=True)
                full = torch.stack([x.double() for x in xs]).sum(0)
                ref = [full[r * m:(r + 1) * m] for r in range(P)]
            for r in range(P):
                got = recvs[r].dev
                if not torch.equal(got, want[r]):
                    fail(f"{kind} {nbytes // MIB} MiB rank {r}: not bitwise "
                         f"equal to the plain composition "
                         f"(max abs err {max_err(got, want[r])})")
                if not torch.allclose(got.double(), ref[r], rtol=1e-5,
                                      atol=1e-5):
                    fail(f"{kind} {nbytes // MIB} MiB rank {r}: off the "
                         f"float64 reference")
                if not torch.isfinite(got).all():
                    fail(f"{kind}: non-finite output")
            del want, ref
            emit({"phase": "main_path", "collective": kind,
                  "func": red, "mib_per_rank": nbytes // MIB,
                  "launches": {"ring_reduce_scatter": launched[0],
                               "ring_all_gather": launched[1]},
                  "first_call_s": first_s, "ok": True})
            return sends, recvs, call, launched

        for mib in sizes:
            per_size[mib] = ring_case("allreduce", mib * MIB)
        other = 64 if 64 in sizes else sizes[0]
        ring_case("allreduce", other * MIB, ReduceFunction.MAX)
        ring_case("allgather", other * MIB)
        ring_case("reduce_scatter", other * MIB)
        launches = read_counts(ring, F)
        if min(launches["ring_reduce_scatter"],
               launches["ring_all_gather"]) < 1:
            fail(f"the main path did not launch every kernel: {launches}")
        return {"world": world, "launches": launches, "per_size": per_size}
    except BaseException:
        world.close()
        raise


def time_kernels(ring, errs, launches, per_big, big_mib, sizes) -> tuple:
    """Phase 5a: each ring kernel per launch at the main path's shapes,
    three ways: ``ms``, CUDA events around back-to-back launches (the
    slower of the device and the host); ``device_ms``, the same with the
    stream held until every launch is enqueued; ``host_enqueue_ms``, the
    host clock around the enqueues.  Then the device time of the
    segmented allreduce (one launch per phase) at each driver size.
    Returns (rows, allreduce device ms by MiB per rank)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n = ring.DEFAULT_SEG_ELEMS // P
    xs = [rand((P, n), torch.float32, gen) for _ in range(P)]
    outs = [torch.empty(n, device="cuda") for _ in range(P)]
    stacked = torch.stack(xs)  # [rank, chunk, n]
    ag_in = [rand((n,), torch.float32, gen) for _ in range(P)]
    ag_out = [torch.empty(P, n, device="cuda") for _ in range(P)]
    rs_count0 = ring.ring_reduce_scatter.launches
    ag_count0 = ring.ring_all_gather.launches

    def gather_all(src, dst):
        # the all-gather of every rank: P gathers of the P blocks
        for r in range(P):
            torch.cat(src, out=dst[r].view(-1))

    def rs_call():
        ring.ring_reduce_scatter(xs, out=outs)

    def ag_call():
        ring.ring_all_gather(ag_in, out=ag_out)

    # interleaved: kernel, plain, plain, kernel
    rs_ms = [cuda_ms(rs_call, 50)]
    rs_plain = [cuda_ms(lambda: ring.ring_reduce_scatter_plain(xs), 20)]
    rs_plain.append(cuda_ms(lambda: ring.ring_reduce_scatter_plain(xs), 20))
    rs_ms.append(cuda_ms(rs_call, 50))
    rs_lib = cuda_ms(lambda: torch.sum(stacked, dim=0), 50)
    ag_ms = [cuda_ms(ag_call, 50)]
    ag_plain = [cuda_ms(lambda: ring.ring_all_gather_plain(ag_in), 20)]
    ag_plain.append(cuda_ms(lambda: ring.ring_all_gather_plain(ag_in), 20))
    ag_ms.append(cuda_ms(ag_call, 50))
    ag_lib = cuda_ms(lambda: gather_all(ag_in, ag_out), 50)
    ag_lib_one = cuda_ms(lambda: torch.cat(ag_in), 50)
    split = {"ring_reduce_scatter": split_ms(rs_call, 50),
             "ring_all_gather": split_ms(ag_call, 50)}
    # the per-launch floor: the same hops at 256 elements per chunk, where
    # the bytes are negligible and the flag handshakes are all that is left
    tiny = [rand((P, 256), torch.float32, gen) for _ in range(P)]
    tiny_ag = [rand((256,), torch.float32, gen) for _ in range(P)]
    floor_fns = {"ring_reduce_scatter": lambda: ring.ring_reduce_scatter(tiny),
                 "ring_all_gather": lambda: ring.ring_all_gather(tiny_ag)}
    floor = {k: {"ms": cuda_ms(fn, 50), **split_ms(fn, 50)}
             for k, fn in floor_fns.items()}
    # the all-gather of fused_matmul_allreduce_pallas: [M / P, N] per rank
    tp_in = [rand((TP_GATHER_N,), torch.float32, gen) for _ in range(P)]
    tp_out = [torch.empty(P, TP_GATHER_N, device="cuda") for _ in range(P)]

    def tp_call():
        ring.ring_all_gather(tp_in, out=tp_out)

    tp_ms = [cuda_ms(tp_call, 5)]
    tp_plain = [cuda_ms(lambda: ring.ring_all_gather_plain(tp_in), 5)]
    tp_plain.append(cuda_ms(lambda: ring.ring_all_gather_plain(tp_in), 5))
    tp_ms.append(cuda_ms(tp_call, 5))
    tp_lib = cuda_ms(lambda: gather_all(tp_in, tp_out), 5)
    tp_lib_one = cuda_ms(lambda: torch.cat(tp_in), 5)
    tp_split = split_ms(tp_call, 5)
    tp_bytes = (P + P * P) * TP_GATHER_N * 4
    at_tp = {"ring_reduce_scatter": {}, "ring_all_gather": {
        f"at_n{TP_GATHER_N}": {
            "shape": f"P={P} x [{TP_GATHER_N}] fp32 per launch",
            "ms": statistics.median(tp_ms),
            "device_ms": tp_split["device_ms"],
            "host_enqueue_ms": tp_split["host_enqueue_ms"],
            "plain_ms": statistics.median(tp_plain), "library_ms": tp_lib,
            "library_ms_one_rank": tp_lib_one,
            "bound_ms": tp_bytes / HBM_BYTES_PER_S * 1e3}}}
    del tp_in, tp_out
    # the driver's allreduce, kernels alone: both launches of one call
    ar_device = {}
    for mib in sizes:
        count = mib * MIB // 4
        ar_in = [rand((count,), torch.float32, gen) for _ in range(P)]
        ar_out = [torch.empty_like(x) for x in ar_in]

        def ar_call():
            ring.ring_all_reduce_segmented(ar_in, "sum", out=ar_out)

        before = (ring.ring_reduce_scatter.launches,
                  ring.ring_all_gather.launches)
        ar_call()
        per_call = [ring.ring_reduce_scatter.launches - before[0],
                    ring.ring_all_gather.launches - before[1]]
        t = split_ms(ar_call, 3, 3)
        ar_device[mib] = t["device_ms"]
        emit({"phase": "allreduce_kernels", "mib_per_rank": mib, "ranks": P,
              "launches_per_call": per_call,
              "device_ms": t["device_ms"],
              "host_enqueue_ms": t["host_enqueue_ms"],
              "bound_ms": 2 * (P + 1) * count * 4 / HBM_BYTES_PER_S * 1e3})
        del ar_in, ar_out
        torch.cuda.empty_cache()
    # the timing launches are not main-path launches
    ring.ring_reduce_scatter.launches = rs_count0
    ring.ring_all_gather.launches = ag_count0
    el = 4
    rs_bytes = P * P * n * el + P * n * el      # read operands, write chunks
    ag_bytes = P * n * el + P * P * n * el      # read blocks, write gathers
    rows = []
    for name, ms, plain, lib, lib_one, nbytes, src_line, lib_call in (
            ("ring_reduce_scatter", rs_ms, rs_plain, rs_lib, None, rs_bytes,
             "accl_tpu/ops/ring.py:274",
             "torch.sum(stack, dim=0): every rank's chunk"),
            ("ring_all_gather", ag_ms, ag_plain, ag_lib, ag_lib_one, ag_bytes,
             "accl_tpu/ops/ring.py:151",
             f"torch.cat(blocks, out=gather[r]) for each of the {P} ranks")):
        row = {"name": name, "route": "cuda",
               "source": "accl_tpu_torch/ops/csrc/ring.cu",
               "replaces": src_line, "launches": launches[name],
               "max_abs_err": errs[name], "ms": statistics.median(ms),
               "device_ms": split[name]["device_ms"],
               "host_enqueue_ms": split[name]["host_enqueue_ms"],
               "plain_ms": statistics.median(plain),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": lib,
               "library_call": lib_call, "checked": True,
               "shape": f"P={P} x [{P},{n}] fp32 per launch",
               "floor_at_n256": floor[name],
               f"launches_per_{big_mib}MiB_allreduce": per_big[name],
               **at_tp[name]}
        if lib_one is not None:
            row["library_ms_one_rank"] = lib_one
        emit({"phase": "kernel_time", **row})
        rows.append(row)
    return rows, ar_device


#: Llama-3-8B at full width (Meta's config.json for meta-llama/Meta-Llama-3-8B:
#: hidden 4096, intermediate 14336, 32 query and 8 K/V heads of 128,
#: vocabulary 128256, RoPE theta 500000), depth cut from 32 layers to 4
#: (no kernel shape depends on depth; 5.6 GB of fp32 weights)
LLAMA3_8B = dict(vocab=128256, d_model=4096, n_layers=4, n_heads=32,
                 n_kv_heads=8, d_head=128, d_ff=14336, mlp="swiglu",
                 rope=True, rope_theta=500000.0, attn="flash",
                 dtype="float32")
#: one rank's flash launch at TP=8 (4 q heads over 1 K/V head): (q rows
#: N, K/V rows Nk, T) on 2 x 4096 tokens (resident) and 1 x 8192 (grid)
FLASH_RESIDENT = (8, 2, 4096)
FLASH_GRID = (4, 1, 8192)
D_HEAD = 128
#: (input dtype, MXU dtype) of the flash checks
FLASH_DTYPES = ((torch.float32, torch.float32),
                (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16))
#: max |kernel - plain| allowed on out and on lse, per MXU dtype, set from
#: the readings of the first card run (NVIDIA H100 80GB HBM3, 700 W): the
#: two fold in different orders and rescale their running max at other
#: columns (64 against the resolver's block_k).  float32: readings up to
#: 6.9e-7 (out) and 9.5e-7 (lse); the bf16-operand control read 9.0e-3
#: and above.  bfloat16: readings up to 3.9e-3 (one bf16 ulp of a bf16
#: output), the bound two ulps at |out| < 2
FLASH_BOUND = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
#: max |logits - TP=8 flash forward's| of the serving path's other runs
#: (fused, dense, TP=1, teacher-forced prefill and decode), fp32 at
#: Llama-3-8B width (|logits| ~ 1), set from the first card run's
#: readings (2.7e-5 to 7.2e-5; NVIDIA H100 80GB HBM3, 700 W): the runs
#: sum the same products in other orders (per-rank partials, chunked
#: ring, other cuBLAS kernels at other row counts)
LOGIT_BOUND = 4e-4


def flash_cfg(FL, N, Nk, T, Tk, dt, mxu, kernel, causal, window=None,
              D=D_HEAD):
    """The resolved schedule the packed entry would hand the kernels."""
    return FL._resolve_schedule(T, Tk, D, dt, causal, 256, 512, mxu,
                                kernel, None, False, None, None,
                                window) + (N // Nk,)


#: one sp member's flash launches on the sp paths at Llama-3-8B width (32
#: q heads over 8 K/V heads a member; the kernel as the path resolves it):
#: the contiguous ring's hops at T_local = 4096 (hop 0 causal, the later
#: hops unmasked), zigzag's half-chunk pairs at 2048 (the diagonal causal,
#: the others unmasked), the windowed ring's local block, and the sp = 1
#: references over 32768 tokens (causal; windowed).  A stacked hop's
#: launch is bitwise its members' own launches (the card test of stacked
#: hops), so one member's launch stands for the hop
SP_HOP_CALLS = (("hop_diag", 32, 8, 4096, 4096, True, None),
                ("hop_past", 32, 8, 4096, 4096, False, None),
                ("hop_half_diag", 32, 8, 2048, 2048, True, None),
                ("hop_half_past", 32, 8, 2048, 2048, False, None),
                ("hop_window_local", 32, 8, 4096, 4096, True, 4096),
                ("sp1_causal", 32, 8, 32768, 32768, True, None),
                ("sp1_window", 32, 8, 32768, 32768, True, 4096))


def check_flash_kernels(FL) -> dict:
    """Phase 3c: flash_fwd_resident and flash_fwd_grid against their plain
    versions at the model path's per-rank shapes (resident: q [8, 4096,
    128], k/v [2, 4096, 128]; grid: q [4, 8192, 128], k/v [1, 8192, 128]),
    at one sp member's hop shapes (SP_HOP_CALLS, in the sp paths' float32
    and bfloat16), a windowed grid call, non-causal cross-length calls, a
    ragged call (T = 1200: the resolver's blocks halve to 16, the kernel's
    last 64-row tile is partial) and a call at head size 64, in float32
    with float32 and bfloat16 MXU dtypes and in bfloat16.  out and lse
    within FLASH_BOUND of the plain version and bitwise equal over two
    launches; a control (the plain version with bf16-rounded operands
    against the float32 one, at the model and hop shapes) must fall
    outside the float32 bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    errs = {"flash_fwd_resident": 0.0, "flash_fwd_grid": 0.0}
    readings, controls_ = [], {}
    calls = (("model_resident", *FLASH_RESIDENT, FLASH_RESIDENT[2], True,
              None, "resident", FLASH_DTYPES, D_HEAD),
             ("model_grid", *FLASH_GRID, FLASH_GRID[2], True, None, "grid",
              FLASH_DTYPES, D_HEAD),
             ("window_1000", 4, 1, 2048, 2048, True, 1000, "grid",
              FLASH_DTYPES[::2], D_HEAD),
             ("cross_length", 8, 2, 1024, 1536, False, None, "resident",
              FLASH_DTYPES[::2], D_HEAD),
             ("cross_length", 8, 2, 1024, 1536, False, None, "grid",
              FLASH_DTYPES[::2], D_HEAD),
             ("ragged_1200", 8, 2, 1200, 1200, True, None, "resident",
              FLASH_DTYPES[:1], D_HEAD),
             ("ragged_1200", 8, 2, 1200, 1200, True, None, "grid",
              FLASH_DTYPES[:1], D_HEAD),
             ("head_64", 8, 2, 2048, 2048, True, None, "resident",
              FLASH_DTYPES, 64))
    calls += tuple((*hop, "auto", FLASH_DTYPES[::2], D_HEAD)
                   for hop in SP_HOP_CALLS)
    for tag, N, Nk, T, Tk, causal, window, kernel, dtypes, D in calls:
        for dt, mxu in dtypes:
            q = rand((N, T, D), dt, gen)
            k, v = rand((Nk, Tk, D), dt, gen), rand((Nk, Tk, D), dt, gen)
            cfg = flash_cfg(FL, N, Nk, T, Tk, dt, mxu, kernel, causal, window,
                            D)
            name = f"flash_fwd_{cfg[5]}"
            fn, plain = getattr(FL, name), getattr(FL, name + "_plain")
            out, lse = fn(q, k, v, cfg)
            again, again_lse = fn(q, k, v, cfg)
            torch.cuda.synchronize()
            repeat = same_bits(out, again) and same_bits(lse, again_lse)
            del again, again_lse
            want, want_lse = plain(q, k, v, cfg)
            e_out, e_lse = max_err(out, want), max_err(lse, want_lse)
            finite = bool(torch.isfinite(out).all() and
                          torch.isfinite(lse).all())
            row = {"call": tag, "kernel": name, "q": [N, T, D],
                   "kv": [Nk, Tk, D], "causal": causal,
                   "window": window, "dtype": str(dt), "mxu": str(mxu),
                   "blocks": list(cfg[1:4]),
                   "ctas": FL.kernel_ctas(N, T, N // Nk, mxu),
                   "max_abs_err_out": e_out, "max_abs_err_lse": e_lse,
                   "repeat_bitwise": repeat}
            readings.append(row)
            bound = FLASH_BOUND[mxu]
            if not finite or e_out > bound or e_lse > bound or not repeat:
                fail(f"{name} {tag} {dt}/{mxu}: off its plain version or "
                     f"not bitwise over two launches (out {e_out}, lse "
                     f"{e_lse}, bound {bound}, finite {finite}, repeat "
                     f"{repeat})")
            errs[name] = max(errs[name], e_out)
            if tag.startswith(("model", "hop", "sp1")) and \
                    mxu == torch.float32:
                ctl_cfg = flash_cfg(FL, N, Nk, T, Tk, dt, torch.bfloat16,
                                    kernel, causal, window)
                c_out, c_lse = plain(q, k, v, ctl_cfg)
                controls_[f"{name} {tag}"] = {
                    "out": max_err(c_out, want), "lse": max_err(c_lse,
                                                                want_lse)}
                if not controls_[f"{name} {tag}"]["out"] > bound:
                    fail(f"the float32 bound {bound} does not catch bf16 "
                         f"operands: {controls_[f'{name} {tag}']}")
                del c_out, c_lse
            del q, k, v, out, lse, want, want_lse
    torch.cuda.empty_cache()
    emit({"phase": "flash_kernels_vs_plain", "ok": True, "bound": {
        str(k): b for k, b in FLASH_BOUND.items()}, "readings": readings,
          "bf16_operand_control": controls_})
    return errs


#: one rank's flash backward launch on the training path (dp 2 x tp 4,
#: 1 x 4096 tokens per dp member: 8 q heads over 2 K/V heads): (N, Nk, T)
FLASH_TRAIN = (8, 2, 4096)
#: max |kernel - plain| / max |plain| allowed on dq, dk and dv, per MXU
#: dtype.  float32: both sum the same fp32 products in other orders
#: (64-row tiles with FMAs against the plain version's blocks through
#: cuBLAS).  dk and dv sum G T = 16384 terms per element at the training
#: shape, whose rounding errors add as a random walk to ~sqrt(16384)
#: 2^-24 = 7.6e-6 of the largest partial sum; the bound is 4 times that,
#: 3e-5 (readings up to 6.7e-6 on the first card run, NVIDIA H100 80GB
#: HBM3, 700 W; the bf16-operand control read 2.5e-3 and above).
#: bfloat16: a P or dS entry whose fp32 value rounds to the other bf16
#: neighbour moves by one bf16 ulp (2^-8), and bf16 outputs round once
#: more: two bf16 ulps of the largest value, as FLASH_BOUND (readings up
#: to 2.7e-3)
BWD_BOUND = {torch.float32: 3e-5, torch.bfloat16: 1.6e-2}


#: the most a dK/dV item may hold of one SM's average work at FLASH_TRAIN
BWD_ITEM_SHARE_MAX = 1 / 3


def bwd_plan_reading(FL, N, Nk, T, Tk, causal, window, dt, mxu) -> dict:
    """What one backward launch pair runs: dq's CTAs, dK/dV's plan items,
    the heaviest item's steps against the average per SM, the split
    tiles, and the resident CTAs per SM of both kernels."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = FL.bwd_plan(N, Nk, T, Tk, causal, window or 0, sms, mxu)
    info = FL.bwd_kernel_info(D_HEAD, dt, mxu)
    per_sm = {k: v["ctas_per_sm"] for k, v in info.items()}
    return {"dq_ctas": plan.dq_ctas, "dkv_items": len(plan.items),
            "heaviest_item_steps": plan.heaviest,
            "steps_per_sm": plan.per_sm,
            "heaviest_share": plan.heaviest / plan.per_sm,
            "split_tiles": sum(p > 1 for p, _ in plan.tiles),
            "tiles": len(plan.tiles), "ctas_per_sm": per_sm,
            "dkv_waves": len(plan.items) / (sms * per_sm["flash_bwd_dkv"])}


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def bwd_operands(FL, N, Nk, T, Tk, dt, mxu, causal, window, g_lse, gen):
    """The backward kernels' operands as _FlashPacked.backward prepares
    them: a forward through the kernels on N(0, 1) q, k, v, an N(0, 1)
    dO and, with g_lse, an N(0, 1) lse cotangent."""
    q = rand((N, T, D_HEAD), dt, gen)
    k, v = rand((Nk, Tk, D_HEAD), dt, gen), rand((Nk, Tk, D_HEAD), dt, gen)
    cfg = flash_cfg(FL, N, Nk, T, Tk, dt, mxu, "auto", causal, window)
    out, lse = FL._flash_forward_impl(q, k, v, cfg)
    do = rand((N, T, D_HEAD), dt, gen)
    a = 1.0 / D_HEAD ** 0.5
    q2 = (q.float() * (a * FL._LOG2E)).to(dt)
    dvec = torch.sum(do.float() * out.float(), dim=-1)
    if g_lse:
        dvec = dvec - rand((N, T), torch.float32, gen)
    return (q2, k, v, do, (lse * FL._LOG2E).contiguous(),
            dvec.contiguous()), cfg


def check_flash_bwd_kernels(FL) -> dict:
    """Phase 3d: flash_bwd_dq and flash_bwd_dkv against their plain
    versions at the training path's per-rank shape (FLASH_TRAIN, causal,
    GQA group 4) with the lse cotangent zero and nonzero, at one sp
    member's hop shapes of sp_train (causal and unmasked, the lse
    cotangent nonzero), a windowed call,
    a non-causal cross-length call and a ragged call (T = 1200: the
    resolver's blocks halve to 16, the kernels' last 64-row tile is
    partial), in float32 with float32 and bfloat16 MXU dtypes and in
    bfloat16.  dq, dk and dv finite and within BWD_BOUND of the plain
    version; a control (the plain version with bf16-rounded operands
    against the float32 one) must fall outside the float32 bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    errs = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    readings, controls_ = [], {}
    N, Nk, T = FLASH_TRAIN
    calls = [("train", N, Nk, T, T, True, None, g, FLASH_DTYPES)
             for g in (False, True)]
    # one sp member's hops in sp_train (sp 4 x tp 2 over 8192 tokens: 16
    # q heads over 4 K/V heads a tp rank, T_local 2048), the lse cotangent
    # live as the merges give it: the diagonal hop and an unmasked one
    calls += [("hop_diag", 16, 4, 2048, 2048, True, None, True,
               FLASH_DTYPES[::2]),
              ("hop_past", 16, 4, 2048, 2048, False, None, True,
               FLASH_DTYPES[::2])]
    calls += [("window_1000", 4, 1, 2048, 2048, True, 1000, True,
               FLASH_DTYPES[::2]),
              ("cross_length", 8, 2, 1024, 1536, False, None, True,
               FLASH_DTYPES[::2]),
              ("ragged_1200", 8, 2, 1200, 1200, True, None, True,
               FLASH_DTYPES[:1])]
    for tag, N, Nk, T, Tk, causal, window, g_lse, dtypes in calls:
        for dt, mxu in dtypes:
            ops, cfg = bwd_operands(FL, N, Nk, T, Tk, dt, mxu, causal,
                                    window, g_lse, gen)
            plan = bwd_plan_reading(FL, N, Nk, T, Tk, causal, window, dt,
                                    mxu)
            if tag == "train" and plan["heaviest_share"] > BWD_ITEM_SHARE_MAX:
                fail(f"flash_bwd_dkv plan at {FLASH_TRAIN}: the heaviest "
                     f"item holds {plan['heaviest_share']:.3f} of an SM's "
                     f"average work (at most {BWD_ITEM_SHARE_MAX:.3f})")
            dq = FL.flash_bwd_dq(*ops, cfg)
            dk, dv = FL.flash_bwd_dkv(*ops, cfg)
            again = (FL.flash_bwd_dq(*ops, cfg), *FL.flash_bwd_dkv(*ops, cfg))
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip((dq, dk, dv), again)):
                fail(f"flash backward {tag} {dt}/{mxu}: two launches differ")
            del again
            want_dq = FL.flash_bwd_dq_plain(*ops, cfg)
            want_dk, want_dv = FL.flash_bwd_dkv_plain(*ops, cfg)
            e = {"dq": rel_err(dq, want_dq), "dk": rel_err(dk, want_dk),
                 "dv": rel_err(dv, want_dv)}
            finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
            readings.append({"call": tag, "q": [N, T, D_HEAD],
                             "kv": [Nk, Tk, D_HEAD], "causal": causal,
                             "window": window, "g_lse": g_lse,
                             "dtype": str(dt), "mxu": str(mxu),
                             "blocks": list(cfg[1:4]),
                             "plan": plan, "bitwise_repeat": True,
                             "rel_err": e,
                             "max_abs": {"dq": float(want_dq.abs().max()),
                                         "dk": float(want_dk.abs().max()),
                                         "dv": float(want_dv.abs().max())}})
            bound = BWD_BOUND[mxu]
            if not finite or max(e.values()) > bound:
                fail(f"flash backward {tag} {dt}/{mxu} g_lse={g_lse}: off "
                     f"the plain version ({e}, bound {bound}, finite "
                     f"{finite})")
            errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"],
                                       max_err(dq, want_dq))
            errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"],
                                        max_err(dk, want_dk),
                                        max_err(dv, want_dv))
            if tag in ("train", "hop_diag", "hop_past") and \
                    mxu == torch.float32:
                ctl_cfg = cfg[:4] + (torch.bfloat16,) + cfg[5:]
                c_dq = FL.flash_bwd_dq_plain(*ops, ctl_cfg)
                c_dk, c_dv = FL.flash_bwd_dkv_plain(*ops, ctl_cfg)
                ctl = {"dq": rel_err(c_dq, want_dq),
                       "dk": rel_err(c_dk, want_dk),
                       "dv": rel_err(c_dv, want_dv)}
                controls_[f"{tag} g_lse={g_lse}"] = ctl
                if not min(ctl.values()) > bound:
                    fail(f"the float32 bound {bound} does not catch bf16 "
                         f"operands: {ctl}")
                del c_dq, c_dk, c_dv
            del ops, dq, dk, dv, want_dq, want_dk, want_dv
    torch.cuda.empty_cache()
    emit({"phase": "flash_bwd_kernels_vs_plain", "ok": True,
          "bound_rel_to_max": {str(k): b for k, b in BWD_BOUND.items()},
          "readings": readings, "bf16_operand_control": controls_})
    return errs


def serving_path(ring, F, FL, M, T_) -> dict:
    """Phase 4d: the model's serving path at Llama-3-8B width (LLAMA3_8B,
    4 layers), TP=8 over rank lists, fp32, weights from a seed on the
    card.  Runs, each with every launch count set to 0 just before and
    read just after: the scoring forward on 2 x 4096 tokens (resident
    kernel), again with fused=True, with attn="dense", and at TP=1 on the
    same weights; the forward on 1 x 8192 tokens (grid kernel); and
    serving: generate for 4 requests of 128-token prompts, 32 new tokens,
    greedy, with prefill and decode_step timed alone.  Logits must be
    finite and within LOGIT_BOUND of the TP=8 flash forward (fused, dense,
    TP=1), teacher-forced decode within it of forward's, and every
    generated token the argmax of forward's logits where the top-2 margin
    exceeds it."""
    cfg = M.ModelConfig(**LLAMA3_8B)
    dense_cfg = M.ModelConfig(**{**LLAMA3_8B, "attn": "dense"})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p1 = M.init_params(gen, cfg, tp=1)
    p8 = M.shard_params(p1, cfg, P)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok4k = torch.randint(0, cfg.vocab, (2, 4096), generator=gen,
                          device="cuda")
    tok8k = torch.randint(0, cfg.vocab, (1, 8192), generator=gen,
                          device="cuda")
    total = {}
    runs = {}

    def run(name, fn):
        reset_counts(ring, F, FL)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = read_counts(ring, F, FL)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        runs[name] = {"first_call_s": secs, "launches": counts}
        return out

    def logit_err(got, ref):
        # float32 difference: a float64 copy of 4 GB logits would set the
        # phase's peak memory
        return float((got - ref).abs().max())

    def check(name, got, ref, bound):
        e = logit_err(got, ref)
        runs[name]["max_abs_err_vs_tp8_flash"] = e
        if tuple(got.shape) != tuple(ref.shape) or \
                not torch.isfinite(got).all() or e > bound:
            fail(f"{name}: logits {tuple(got.shape)} off the TP=8 flash "
                 f"forward by {e} (bound {bound}) or not finite")

    ref = run("forward_4096_tp8", lambda: M.forward(p8, tok4k, cfg))
    if not torch.isfinite(ref).all() or \
            tuple(ref.shape) != (*tok4k.shape, cfg.vocab):
        fail(f"forward_4096_tp8: logits {tuple(ref.shape)} not finite")
    check("forward_4096_tp8_fused", run(
        "forward_4096_tp8_fused", lambda: M.forward(p8, tok4k, cfg,
                                                    fused=True)),
          ref, LOGIT_BOUND)
    check("forward_4096_tp8_dense", run(
        "forward_4096_tp8_dense", lambda: M.forward(p8, tok4k, dense_cfg)),
          ref, LOGIT_BOUND)
    check("forward_4096_tp1", run(
        "forward_4096_tp1", lambda: M.forward(p1, tok4k, cfg)),
          ref, LOGIT_BOUND)
    # the same model in bfloat16, its weights held in bf16 (with float32
    # norm scales both packages promote the activations back to float32
    # at the first norm): the flash forward on the tensor cores
    cfg16 = M.ModelConfig(**{**LLAMA3_8B, "dtype": "bfloat16"})
    p16 = T_.tree_map(lambda t: t.to(torch.bfloat16), p8)
    FL.flash_fwd_resident.launches_tc = 0
    lg16 = run("forward_4096_tp8_bf16", lambda: M.forward(p16, tok4k, cfg16))
    tc = FL.flash_fwd_resident.launches_tc
    bf16_run = runs["forward_4096_tp8_bf16"]
    bf16_run["flash_fwd_resident_tensor_core_launches"] = tc
    if not torch.isfinite(lg16).all() or \
            tuple(lg16.shape) != (*tok4k.shape, cfg.vocab):
        fail(f"forward_4096_tp8_bf16: logits {tuple(lg16.shape)} not "
             f"finite or of the wrong shape")
    if bf16_run["launches"]["flash_fwd_resident"] != cfg.n_layers * P or \
            tc != cfg.n_layers * P:
        fail(f"the bf16 forward must launch flash_fwd_resident once per "
             f"layer and rank on the tensor cores: {bf16_run}, {tc}")
    bf16_run["max_abs_diff_vs_fp32"] = logit_err(lg16.float(), ref)
    del lg16, ref
    torch.cuda.empty_cache()
    # s per forward, warm, fp32 and bf16 side by side (not counted)
    for name, w, c in (("forward_4096_tp8", p8, cfg),
                       ("forward_4096_tp8_bf16", p16, cfg16)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        M.forward(w, tok4k, c)
        torch.cuda.synchronize()
        runs[name]["warm_s"] = time.perf_counter() - t
    del p16
    torch.cuda.empty_cache()
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    lg8k = run("forward_8192_tp8", lambda: M.forward(p8, tok8k, cfg))
    fwd_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    if not torch.isfinite(lg8k).all() or \
            tuple(lg8k.shape) != (*tok8k.shape, cfg.vocab):
        fail("forward_8192_tp8: logits not finite or of the wrong shape")
    del lg8k
    torch.cuda.empty_cache()
    per_forward = {"flash_fwd_resident":
                   runs["forward_4096_tp8"]["launches"]["flash_fwd_resident"],
                   "flash_fwd_grid":
                   runs["forward_8192_tp8"]["launches"]["flash_fwd_grid"]}
    if per_forward != {"flash_fwd_resident": cfg.n_layers * P,
                       "flash_fwd_grid": cfg.n_layers * P}:
        fail(f"the 4096-token forward must launch flash_fwd_resident and "
             f"the 8192-token one flash_fwd_grid once per layer and rank: "
             f"{per_forward}")
    if runs["forward_4096_tp8"]["launches"]["flash_fwd_grid"] or \
            runs["forward_8192_tp8"]["launches"]["flash_fwd_resident"]:
        fail(f"a forward launched the other flash kernel: {runs}")

    # -- serving: 4 requests, 128-token prompts, 32 new tokens ------------
    B, Tp, new = 4, 128, 32
    prompt = torch.randint(0, cfg.vocab, (B, Tp), generator=gen,
                           device="cuda")
    Tp = prompt.shape[1]
    cont = torch.randint(0, cfg.vocab, (B, 8), generator=gen, device="cuda")
    generated = run("generate", lambda: M.generate(p8, prompt, cfg, new))
    if tuple(generated.shape) != (B, new) or int(generated.min()) < 0 or \
            int(generated.max()) >= cfg.vocab:
        fail(f"generate: tokens {tuple(generated.shape)} out of range")
    graph_arm = serving_graph_arm(ring, F, M, p8, cfg, prompt, generated,
                                  new, run, runs, gen)

    def serve_prefill():
        cache = M.init_kv_cache(cfg, B, Tp + cont.shape[1], tp=P)
        return M.prefill(p8, prompt, cache, cfg)

    lg_pre, cache = run("prefill", serve_prefill)
    steps = []
    for t in range(cont.shape[1]):
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        lg, cache = M.decode_step(p8, cont[:, t], cache, cfg)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t_step, lg))
    teacher = torch.cat([prompt, cont], dim=1)
    want = run("forward_teacher", lambda: M.forward(p8, teacher, cfg))
    e_pre = logit_err(lg_pre, want[:, :Tp])
    e_dec = max(logit_err(lg, want[:, Tp + t]) for t, (_s, lg) in
                enumerate(steps))
    if e_pre > LOGIT_BOUND or e_dec > LOGIT_BOUND:
        fail(f"teacher-forced prefill/decode off forward's logits: "
             f"{e_pre}, {e_dec} (bound {LOGIT_BOUND})")
    seq = torch.cat([prompt, generated[:, :-1]], dim=1)
    lg_seq = run("forward_generated", lambda: M.forward(p8, seq, cfg))[
        :, Tp - 1:]
    top2 = torch.topk(lg_seq, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > LOGIT_BOUND
    agree = lg_seq.argmax(-1) == generated
    if not bool(agree[decided].all()):
        fail("generate: a greedy token differs from forward's argmax where "
             "the top-2 margin exceeds the logit bound")
    ms_step = statistics.median(s for s, _lg in steps) * 1e3
    emit({"phase": "serving_path", "ok": True, "config": LLAMA3_8B,
          "reduced": "n_layers 32 -> 4", "tp": P, "init_s": init_s,
          "runs": runs, "launches": total, "per_forward": per_forward,
          "prefill_tokens_per_s": B * Tp / runs["prefill"]["first_call_s"],
          "ms_per_decode_step": ms_step,
          "generate_s": runs["generate"]["first_call_s"],
          "teacher_forced_max_abs_err": {"prefill": e_pre, "decode": e_dec},
          "graph": graph_arm,
          "greedy_tokens_checked": int(decided.sum()),
          "weights_gb": sum(t.numel() * 4 for t in (
              p1["embed"], *(w for blk in p1["blocks"] for leaf in
                             blk.values() for w in (leaf if isinstance(
                                 leaf, list) else [leaf])))) / 1e9,
          "forward_8192_peak_gb_above_held": fwd_peak,
          "peak_mem_gb": max(peak_before,
                             torch.cuda.max_memory_allocated()) / 1e9})
    del p1, p8, want, lg_seq, steps, cache
    torch.cuda.empty_cache()
    return {"launches": total, "per_forward": per_forward}


#: decode steps of the graph arm's teacher-forced comparison
GRAPH_STEPS = 8


def profile_kernels(fn) -> dict:
    """The CUDA kernels torch.profiler sees in one call of ``fn`` (after a
    warm-up call): their count, the sum of their durations and the span
    from the first one's start to the last one's end, in ms; None where
    the profiler shows no device time, with the reason."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as e:  # noqa: BLE001 - a diagnostic, not a check
        return {"kernels": None, "error": f"{type(e).__name__}: {e}"}
    if not kern:
        return {"kernels": 0, "device_ms": None,
                "note": "the profiler showed no device time"}
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern)) / 1e3
    return {"kernels": len(kern), "device_ms": busy, "span_ms": span,
            "idle_share_of_span": 1 - busy / span if span > 0 else None}


def serving_graph_arm(ring, F, M, p8, cfg, prompt, generated, new, run,
                      runs, gen) -> dict:
    """Phase 4d's graph arm: ``generate`` with its decode step captured in
    one CUDA graph and replayed (the default on the card; ``generated``
    is its output) against the eager loop (graph=False), greedy, and the
    same with fused=True: tokens equal.  Then ms per decode step,
    replayed and eager, unfused and fused, over GRAPH_STEPS
    teacher-forced steps, whose logits must be bitwise the eager ones;
    if they are not (cuBLAS may pick another GEMM under capture), the arm
    says so and holds them within LOGIT_BOUND, with a control (the last
    block's w2 rounded to bf16, eagerly) that must fall outside it.  The
    model's fused lane multiplies with torch.matmul (use_pallas=False, as
    the JAX package's), so no hand kernel runs in the decode graph; the
    arm also captures fused_matmul_allreduce_pallas (the fused matmul
    reduce-scatter kernel, then the ring all-gather kernel) at the decode
    step's MLP-down shape, 8 rows (the 4 requests padded to the ring
    size), replays it new - 1 times and holds the last replay bitwise to
    the eager launches on the same operands.  Kernel wrappers count at
    capture only: replayed launches are the captured ones times the
    replays."""
    B, Tp = prompt.shape
    out = {}
    eager = run("generate_eager", lambda: M.generate(p8, prompt, cfg, new,
                                                     graph=False))
    if not torch.equal(generated, eager):
        fail("generate: the replayed graph's greedy tokens differ from the "
             "eager loop's")
    fused_graph = run("generate_fused", lambda: M.generate(
        p8, prompt, cfg, new, fused=True))
    fused_eager = run("generate_fused_eager", lambda: M.generate(
        p8, prompt, cfg, new, fused=True, graph=False))
    if not torch.equal(fused_graph, fused_eager):
        fail("generate(fused=True): the replayed graph's greedy tokens "
             "differ from the eager loop's")
    out["tokens_equal"] = {"unfused": True, "fused": True,
                           "fused_vs_unfused": bool(torch.equal(
                               fused_graph, generated))}
    for name in ("generate", "generate_fused"):
        out[f"{name}_s"] = runs[name]["first_call_s"]
        out[f"{name}_eager_s"] = runs[f"{name}_eager"]["first_call_s"]
    cont = torch.randint(0, cfg.vocab, (B, GRAPH_STEPS), generator=gen,
                         device="cuda")

    def teacher(fused, graph, params=p8):
        cache = M.init_kv_cache(cfg, B, Tp + GRAPH_STEPS, tp=P)
        _, cache = M.prefill(params, prompt, cache, cfg, fused=fused)
        stepper = None
        if graph:
            stepper = M.DecodeGraph(params, cache, cfg, cont[:, 0],
                                    fused=fused).capture()
        times, logits = [], []
        for t in range(GRAPH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if graph:
                stepper.token.copy_(cont[:, t])
                lg = stepper.replay()
            else:
                lg, cache = M.decode_step(params, cont[:, t], cache, cfg,
                                          fused=fused)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            logits.append(lg.clone())
        return statistics.median(times) * 1e3, torch.stack(logits)

    def profiled(fused):
        # one decode step's kernels, eager and replayed (not counted)
        cache = M.init_kv_cache(cfg, B, Tp + 2, tp=P)
        _, cache = M.prefill(p8, prompt, cache, cfg, fused=fused)
        stepper = M.DecodeGraph(p8, cache, cfg, cont[:, 0], fused=fused)
        eager = profile_kernels(stepper.step)
        stepper.cache["pos"].sub_(2)
        stepper.capture()
        replay = profile_kernels(stepper.replay)
        return {"eager_step": eager, "replayed_step": replay}

    for fused in (False, True):
        key = "fused" if fused else "unfused"
        ms_graph, lg_graph = teacher(fused, True)
        ms_eager, lg_eager = teacher(fused, False)
        res = {"ms_per_decode_step_replayed": ms_graph,
               "ms_per_decode_step_eager": ms_eager,
               "logits_bitwise": bool(torch.equal(lg_graph, lg_eager)),
               "profile": profiled(fused)}
        if not res["logits_bitwise"]:
            err = float((lg_graph - lg_eager).abs().max())
            blk = p8["blocks"][-1]
            ctl = {**p8, "blocks": p8["blocks"][:-1] + [{
                **blk, "w2": [w.to(torch.bfloat16).float()
                              for w in blk["w2"]]}]}
            _ms, lg_ctl = teacher(fused, False, ctl)
            ctl_err = float((lg_ctl - lg_eager).abs().max())
            res.update({"note": "cuBLAS ran other GEMM kernels under "
                                "capture: logits held within LOGIT_BOUND",
                        "max_abs_err": err, "bound": LOGIT_BOUND,
                        "control_max_abs_err": ctl_err})
            if err > LOGIT_BOUND or ctl_err <= LOGIT_BOUND:
                fail(f"decode graph ({key}): logits {err} off the eager "
                     f"step's (bound {LOGIT_BOUND}; control {ctl_err} must "
                     f"exceed it)")
        out[key] = res
        emit({"phase": "serving_graph", "lane": key, **res})

    # the hand kernels in a replayed graph, at the decode step's MLP-down
    # shape (the model's fused lane itself runs none)
    K, N = cfg.d_ff // P, cfg.d_model
    xs = [torch.randn(P, K, generator=gen, device="cuda") for _ in range(P)]
    ws = [w.contiguous() for w in p8["blocks"][0]["w2"]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        F.fused_matmul_allreduce_pallas(xs, ws)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph, stream=side):
            res = F.fused_matmul_allreduce_pallas(xs, ws)[0]
        torch.cuda.current_stream().wait_stream(side)
        return res

    captured_out = run("graph_tp_capture", capture)
    captured = runs["graph_tp_capture"]["launches"]
    replays = new - 1
    t0 = time.perf_counter()
    for _ in range(replays):
        graph.replay()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3 / replays
    want = F.fused_matmul_allreduce_pallas(xs, ws)[0]
    if not torch.equal(captured_out, want):
        fail("fused_matmul_allreduce_pallas replayed in a CUDA graph is not "
             "bitwise its eager launches")
    if captured["fused_matmul_reduce_scatter"] != 1 or \
            captured["ring_all_gather"] != 1:
        fail(f"the captured TP contraction must hold one fused and one "
             f"all-gather launch: {captured}")
    out["tp_kernels_in_graph"] = {
        "shape": f"P={P} x [{P}, {K}] @ [{K}, {N}] fp32",
        "captured_launches": {k: v for k, v in captured.items() if v},
        "replays": replays,
        "replayed_launches": {k: v * replays for k, v in captured.items()
                              if v},
        "ms_per_replay": replay_ms, "bitwise_eager": True}
    del xs, ws, graph, captured_out, want, side
    return out


#: the training path's learning rate: large enough that each leaf's
#: update stands well above the fp32 rounding of the parameter it is
#: added to (so the gradient can be recovered from it), small enough that
#: plain SGD on a repeated batch still descends
TRAIN_LR = 1.0
TRAIN_STEPS = 3
#: relative bound on the first step's loss against the same step with
#: attn="dense" (fp32 both; the two sum the attention in other orders)
TRAIN_LOSS_BOUND = 1e-5
#: relative L2 bound on each leaf's gradient against the dense step's,
#: recovered as (p - p') / lr; a wrong dQ or dK/dV gives O(1) there.  The
#: fp32 rounding of each update p - lr g is added on top per leaf:
#: 2 ||ulp(p) / 2|| / ||p - p'|| (two independent roundings)
TRAIN_GRAD_BOUND = 1e-3
#: the same step with remat=True: the same kernels on the same values
REMAT_BOUND = 1e-6


def update_diffs(params, other, p0, T_) -> list:
    """Per leaf (d, floor, ||Delta||): d = ||Delta - Delta'|| / ||Delta||,
    Delta = p0 - p after one step and Delta' = p0 - other after the step
    it is held to, both exact fp32 differences of nearby values; floor =
    2 ||ulp(p0) / 2|| / ||Delta||.  Squares are summed in float64 over
    chunks, so no float64 copy of a 2 GB leaf is made."""
    out = []
    for a, b, z in zip(T_.tree_leaves(params), T_.tree_leaves(other),
                       T_.tree_leaves(p0)):
        a, b, z = a.reshape(-1), b.reshape(-1), z.reshape(-1)
        sums = np.zeros(3)
        for i in range(0, z.numel(), 1 << 26):
            za, aa, bb = (t[i:i + (1 << 26)] for t in (z, a, b))
            ulp = torch.nextafter(za, torch.full_like(za, np.inf)) - za
            sums += [float(((za - aa).double() ** 2).sum()),
                     float(((aa - bb).double() ** 2).sum()),
                     float(((ulp / 2).double() ** 2).sum())]
        nd, diff, half_ulp = np.sqrt(sums)
        out.append((diff / max(nd, 1e-300), 2 * half_ulp / max(nd, 1e-300),
                    nd))
    return out


def train_path(ring, F, FL, M, S, TE, T_) -> dict:
    """Phase 4e: the model's training path at Llama-3-8B width (LLAMA3_8B,
    4 layers), make_train_step on make_mesh(dp=2, tp=4), fp32, 1 x 4096
    tokens per dp member, weights from a seed on the card.  Runs, each
    with every launch count set to 0 just before and read just after:
    TRAIN_STEPS flash steps on one repeated batch, the first of them also
    as a dense + remat step, a flash + remat step and an int8 + EF synced
    step from the same weights."""
    cfg = M.ModelConfig(**LLAMA3_8B)
    mesh = S.make_mesh(dp=2, tp=4)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    torch.cuda.empty_cache()
    p0 = M.init_params(gen, cfg, tp=tp)
    tokens = torch.randint(0, cfg.vocab, (dp, 4096), generator=gen,
                           device="cuda")
    n_tok = tokens.numel()
    torch.cuda.synchronize()
    total, runs = {}, {}

    def run(name, fn):
        reset_counts(ring, F, FL)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = read_counts(ring, F, FL)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        runs[name] = {"s": secs, "launches": counts}
        return out

    def stepper(c):
        return M.make_train_step(mesh, c, lr=TRAIN_LR)[0]

    # -- the first flash step, from a copy of p0 -------------------------
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = T_.tree_map(torch.clone, p0)
    step = stepper(cfg)
    params, loss = run("step_1", lambda: step(params, tokens))
    peak_step = (torch.cuda.max_memory_allocated() - held) / 1e9
    losses = [float(loss)]

    # -- the same step with attn="dense" and remat -----------------------
    dense_cfg = M.ModelConfig(**{**LLAMA3_8B, "attn": "dense",
                                 "remat": True})
    other = T_.tree_map(torch.clone, p0)
    dstep = stepper(dense_cfg)
    other, dloss = run("step_1_dense_remat", lambda: dstep(other, tokens))
    dense_cmp = update_diffs(params, other, p0, T_)
    loss_err = abs(float(dloss) - losses[0]) / abs(losses[0])
    worst = max(d - (TRAIN_GRAD_BOUND + f) for d, f, _n in dense_cmp)
    if loss_err > TRAIN_LOSS_BOUND or worst > 0:
        fail(f"the flash train step is off the dense one: loss {loss_err} "
             f"(bound {TRAIN_LOSS_BOUND}), per-leaf gradient "
             f"{[(d, TRAIN_GRAD_BOUND + f) for d, f, _n in dense_cmp]}")
    del other
    torch.cuda.empty_cache()

    # -- the same step with remat ----------------------------------------
    remat_cfg = M.ModelConfig(**{**LLAMA3_8B, "remat": True})
    other = T_.tree_map(torch.clone, p0)
    rstep = stepper(remat_cfg)
    other, rloss = run("step_1_remat", lambda: rstep(other, tokens))
    remat_cmp = update_diffs(params, other, p0, T_)
    remat_loss_err = abs(float(rloss) - losses[0]) / abs(losses[0])
    if remat_loss_err > REMAT_BOUND or \
            max(d for d, _f, _n in remat_cmp) > REMAT_BOUND:
        fail(f"the remat train step is off the plain one: loss "
             f"{remat_loss_err}, per-leaf {[d for d, _f, _n in remat_cmp]} "
             f"(bound {REMAT_BOUND})")
    del other
    torch.cuda.empty_cache()

    # -- one int8 + EF synced step ---------------------------------------
    other = T_.tree_map(torch.clone, p0)
    qstep = TE._make_step(cfg, "int8_ef", TRAIN_LR, dp)
    other, qloss0 = run("step_1_int8_ef",
                        lambda: qstep(other, tokens.view(dp, 1, -1)))
    with torch.no_grad():
        s_, c_ = M.loss_fn(other, tokens, cfg)
    int8_loss_after = float(s_ / c_)
    del other, s_, c_
    torch.cuda.empty_cache()

    # -- the rest of the run ---------------------------------------------
    for i in range(2, TRAIN_STEPS + 1):
        params, loss = run(f"step_{i}", lambda: step(params, tokens))
        losses.append(float(loss))
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    if not all(np.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"training: losses {losses} not finite or not falling")
    int8_dev = abs(int8_loss_after - losses[1])
    if abs(float(qloss0) - losses[0]) > TE.TRACK_TOL or \
            int8_dev > TE.TRACK_TOL:
        fail(f"the int8 + EF step: loss after it {int8_loss_after} against "
             f"the fp32 run's {losses[1]} (TRACK_TOL {TE.TRACK_TOL})")
    per_step = {k: runs["step_1"]["launches"][k] for k in
                ("flash_fwd_resident", "flash_bwd_dq", "flash_bwd_dkv")}
    want = cfg.n_layers * dp * tp
    for i in range(1, TRAIN_STEPS + 1):
        got = {k: runs[f"step_{i}"]["launches"][k] for k in per_step}
        if got != dict.fromkeys(per_step, want):
            fail(f"training step {i} must launch each flash kernel {want} "
                 f"times (layers x dp x tp): {got}")
    step_s = [runs[f"step_{i}"]["s"] for i in range(1, TRAIN_STEPS + 1)]
    emit({"phase": "train_path", "ok": True, "config": LLAMA3_8B,
          "reduced": "n_layers 32 -> 4", "mesh": mesh.shape,
          "tokens_per_step": n_tok, "lr": TRAIN_LR, "losses": losses,
          "s_per_step": step_s,
          "tokens_per_s": n_tok / statistics.median(step_s[1:]),
          "launches_per_step": per_step, "runs": runs, "launches": total,
          "dense_remat": {"loss_rel_err": loss_err,
                          "grad_rel_l2_max": max(d for d, _f, _n in
                                                 dense_cmp),
                          "rounding_floor_max": max(f for _d, f, _n in
                                                    dense_cmp),
                          "per_leaf": [[d, f] for d, f, _n in dense_cmp],
                          "bound": TRAIN_GRAD_BOUND},
          "remat": {"loss_rel_err": remat_loss_err,
                    "grad_rel_l2_max": max(d for d, _f, _n in remat_cmp),
                    "bound": REMAT_BOUND},
          "int8_ef": {"loss_after": int8_loss_after,
                      "fp32_loss_after": losses[1], "abs_dev": int8_dev,
                      "track_tol": TE.TRACK_TOL},
          "first_step_peak_gb_above_held": peak_step,
          "phase_peak_gb_above_held": peak, "held_gb": held / 1e9,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del params, p0
    torch.cuda.empty_cache()
    return {"launches": total, "per_step": per_step,
            "first_step_peak_gb_above_held": peak_step,
            "s_per_step": step_s}


#: the AdamW path's learning rate and its bounds against the
#: single-device AdamW step (fp32 flash both): the moments are the
#: gradient's, held per leaf by relative L2 as TRAIN_GRAD_BOUND holds
#: gradients (nu: its square, twice the relative error; readings up to
#: 2.1e-5 and 2.4e-5 on an H100); each leaf's update by relative L2 on
#: top of its fp32 rounding floor (an AdamW update is lr times about +-1
#: per element, so a gradient element whose sign the other summation
#: order flips moves it by 2 lr; readings up to 2.1e-3, floors up to
#: 1.2e-3)
ADAMW_LR = 1e-4
ADAMW_MOMENT_BOUND = {"mu": TRAIN_GRAD_BOUND, "nu": 2 * TRAIN_GRAD_BOUND}
ADAMW_UPDATE_BOUND = 1e-2


def leaf_norms(a_tree, b_tree, T_) -> list:
    """Per leaf (||a - b||, ||b||, ||ulp(b) / 2||), squares summed in
    float64 over chunks (no float64 copy of a 2 GB leaf)."""
    out = []
    for a, b in zip(T_.tree_leaves(a_tree), T_.tree_leaves(b_tree)):
        a, b = a.reshape(-1), b.reshape(-1)
        sums = np.zeros(3)
        for i in range(0, b.numel(), 1 << 26):
            aa, bb = a[i:i + (1 << 26)], b[i:i + (1 << 26)]
            ulp = torch.nextafter(bb, torch.full_like(bb, np.inf)) - bb
            sums += [float(((aa - bb).double() ** 2).sum()),
                     float((bb.double() ** 2).sum()),
                     float(((ulp / 2).double() ** 2).sum())]
        out.append(tuple(np.sqrt(sums)))
    return out


def update_floors(ref, p0, T_) -> list:
    """Per leaf the reference step's update ||p' - p0|| and the fp32
    rounding floor of an update, 2 ||ulp(p0) / 2|| / ||p' - p0||."""
    return [(d, 2 * u / max(d, 1e-300)) for d, _n, u in leaf_norms(ref, p0,
                                                                   T_)]


def adamw_readings(params, state, ref, ref_state, floors, T_) -> tuple:
    """An AdamW step held to a reference step from the same start: per
    leaf (||p - p_ref|| / the reference's update, its floor from
    update_floors), each moment's relative L2 error per leaf, and whether
    an update is past ADAMW_UPDATE_BOUND plus its floor or a moment past
    its ADAMW_MOMENT_BOUND."""
    upd = [(d / max(nd, 1e-300), floor) for (d, _n, _u), (nd, floor) in
           zip(leaf_norms(params, ref, T_), floors)]
    moments = {k: [d / max(n, 1e-300) for d, n, _u in leaf_norms(
        getattr(state, k), getattr(ref_state, k), T_)] for k in ("mu", "nu")}
    off = max(d - (ADAMW_UPDATE_BOUND + f) for d, f in upd) > 0 or any(
        max(v) > ADAMW_MOMENT_BOUND[k] for k, v in moments.items())
    return upd, moments, off


def train_adamw(ring, F, FL, M, S, T_, OPT, sgd) -> dict:
    """Phase 4e's AdamW arm (phase train_adamw): make_train_step with
    optimizer=adamw(ADAMW_LR) on make_mesh(dp=2, tp=4) at the training
    path's width, depth and tokens, TRAIN_STEPS steps, each run with every
    launch count set to 0 just before and read just after.  The first step
    is held to the port's single-device AdamW step (make_mesh() with no
    axes, tp = 1, the whole batch on one member) from the same weights:
    loss within TRAIN_LOSS_BOUND, each leaf's moments within
    ADAMW_MOMENT_BOUND and its update within ADAMW_UPDATE_BOUND (plus the
    fp32 rounding floor of update_diffs).  The losses must be finite and
    fall; each flash kernel launches layers x dp x tp times a step.
    Prints s per step, tokens/s and the step's peak memory beside the SGD
    step's (``sgd``, train_path's)."""
    cfg = M.ModelConfig(**LLAMA3_8B)
    mesh = S.make_mesh(dp=2, tp=4)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    torch.cuda.empty_cache()
    p0 = M.init_params(gen, cfg, tp=tp)
    tokens = torch.randint(0, cfg.vocab, (dp, 4096), generator=gen,
                           device="cuda")
    n_tok = tokens.numel()
    total, runs = {}, {}

    def run(name, fn):
        reset_counts(ring, F, FL)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = read_counts(ring, F, FL)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        runs[name] = {"s": secs, "launches": counts}
        return out

    # -- the single-device AdamW step, the reference ----------------------
    shared = {id(t) for t in T_.tree_leaves(p0)}
    ref = T_.tree_map(lambda t: t.clone() if id(t) in shared else t,
                      M.shard_params(p0, cfg, 1))
    ref_step, _specs, ref_init = M.make_train_step(
        S.make_mesh(), cfg, optimizer=OPT.adamw(ADAMW_LR), params=ref)
    ref_state = ref_init(ref)
    ref, ref_state, ref_loss = run("single_device_step_1", lambda: ref_step(
        ref, ref_state, tokens))
    ref = M.shard_params(ref, cfg, tp)
    ref_state = ref_state._replace(mu=M.shard_params(ref_state.mu, cfg, tp),
                                   nu=M.shard_params(ref_state.nu, cfg, tp))
    # before p0 is stepped
    ref_upd = update_floors(ref, p0, T_)
    torch.cuda.empty_cache()

    # -- the dp x tp AdamW run, in place on p0 ----------------------------
    params = p0
    step, (_ps, st_specs, tok_spec), init_opt = M.make_train_step(
        mesh, cfg, optimizer=OPT.adamw(ADAMW_LR), params=params)
    state = init_opt(params)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params, state, loss = run("step_1", lambda: step(params, state, tokens))
    peak_step = (torch.cuda.max_memory_allocated() - held) / 1e9
    losses = [float(loss)]
    loss_err = abs(losses[0] - float(ref_loss)) / abs(float(ref_loss))
    upd, moments, off = adamw_readings(params, state, ref, ref_state,
                                       ref_upd, T_)
    if loss_err > TRAIN_LOSS_BOUND or off:
        fail(f"the dp x tp AdamW step is off the single-device one: loss "
             f"{loss_err} (bound {TRAIN_LOSS_BOUND}), updates "
             f"{[d for d, _f in upd]} (bound {ADAMW_UPDATE_BOUND}), "
             f"moments {moments} (bounds {ADAMW_MOMENT_BOUND})")
    if int(state.count) != 1:
        fail(f"AdamW count {int(state.count)} after one step")
    del ref, ref_state
    torch.cuda.empty_cache()
    for i in range(2, TRAIN_STEPS + 1):
        params, state, loss = run(f"step_{i}", lambda: step(params, state,
                                                            tokens))
        losses.append(float(loss))
    if not all(np.isfinite(v) for v in losses) or \
            not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"AdamW training: losses {losses} not finite or not falling")
    want = cfg.n_layers * dp * tp
    per_step = {k: runs["step_1"]["launches"][k] for k in
                ("flash_fwd_resident", "flash_bwd_dq", "flash_bwd_dkv")}
    for i in range(1, TRAIN_STEPS + 1):
        got = {k: runs[f"step_{i}"]["launches"][k] for k in per_step}
        if got != dict.fromkeys(per_step, want):
            fail(f"AdamW step {i} must launch each flash kernel {want} "
                 f"times (layers x dp x tp): {got}")
    step_s = [runs[f"step_{i}"]["s"] for i in range(1, TRAIN_STEPS + 1)]
    emit({"phase": "train_adamw", "ok": True, "config": LLAMA3_8B,
          "reduced": "n_layers 32 -> 4", "mesh": mesh.shape,
          "optimizer": dict(OPT.adamw(ADAMW_LR)._asdict()),
          "tokens_per_step": n_tok, "losses": losses,
          "single_device_loss": float(ref_loss), "loss_rel_err": loss_err,
          "update_rel_l2_max": max(d for d, _f in upd),
          "rounding_floor_max": max(f for _d, f in upd),
          "update_bound": ADAMW_UPDATE_BOUND,
          "update_per_leaf": [d for d, _f in upd],
          "moment_rel_l2_max": {k: max(v) for k, v in moments.items()},
          "moment_bounds": ADAMW_MOMENT_BOUND,
          "s_per_step": step_s,
          "tokens_per_s": n_tok / statistics.median(step_s[1:]),
          "sgd_s_per_step": sgd["s_per_step"],
          "launches_per_step": per_step, "runs": runs, "launches": total,
          "first_step_peak_gb_above_held": peak_step,
          "sgd_first_step_peak_gb_above_held":
              sgd["first_step_peak_gb_above_held"],
          "held_gb": held / 1e9,
          "opt_state_specs_count": st_specs.count,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del params, state, p0
    torch.cuda.empty_cache()
    return {"launches": total, "per_step": per_step}


def selfring_phase(ring, SR) -> dict:
    """Phase 4l (selfring): the ring kernels' self-ring mode.  First each
    self-ring call at the bench's shapes against its plain version and
    the closed forms, bitwise (not counted): the reduce-scatter by sum and
    by max, the all-gather, the allreduce.  Then the bench entry
    (bench/selfring.py ``selfring_stage``: its own closed-form checks,
    then the GB/s of the all-gather and the allreduce) with the ring
    counts set to 0 just before and read just after; both kernels must
    launch, all of them in the self-ring mode."""
    V, n = SR.V, SR.ROWS * SR.COLS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x = rand((V, n), torch.float32, gen)
    errs = {}
    for op in ("sum", "max"):
        (got,) = ring.ring_reduce_scatter([x], op, ring_size=V)
        (plain,) = ring.ring_reduce_scatter_plain([x], op, ring_size=V)
        errs[f"reduce_scatter_{op}"] = max_err(got, plain)
        if not (same_bits(got, plain)
                and same_bits(got, SR.fold_closed_form(x, op))):
            fail(f"self-ring reduce-scatter ({op}, V={V}): not bitwise its "
                 f"plain version and the fold x[0] + (x[1] + ...)")
    row0 = x[0].contiguous()
    (ag,) = ring.ring_all_gather([row0], ring_size=V)
    (ag_plain,) = ring.ring_all_gather_plain([row0], ring_size=V)
    errs["all_gather"] = max_err(ag, ag_plain)
    if not (same_bits(ag, ag_plain) and same_bits(ag, row0.expand(V, n))):
        fail("self-ring all-gather: not bitwise its plain version and the "
             "operand tiled V times")
    (ar,) = ring.ring_all_reduce([x.reshape(-1)], ring_size=V)
    (ar_plain,) = ring.ring_all_reduce([x.reshape(-1)], plain=True,
                                       ring_size=V)
    errs["all_reduce"] = max_err(ar, ar_plain)
    if not same_bits(ar, ar_plain):
        fail("self-ring allreduce: not bitwise its plain composition")
    del x, ag, ag_plain, ar, ar_plain
    counters = (ring.ring_reduce_scatter, ring.ring_all_gather)
    for fn in counters:
        fn.launches = fn.launches_self = 0
    t0 = time.perf_counter()
    res = SR.selfring_stage()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    self_launches = {fn.__name__: fn.launches_self for fn in counters}
    if launches != self_launches or 0 in launches.values():
        fail(f"the self-ring stage must launch both ring kernels, in the "
             f"self-ring mode only: {launches}, {self_launches}")
    emit({"phase": "selfring", "ok": True, "s": secs, **res,
          "launches": launches, "max_abs_err": errs})
    return {"launches": launches, "res": res}


def time_selfring_kernels(ring, SR, launches) -> list:
    """Phase 5 rows of the self-ring mode at the bench's shapes: ms per
    launch (CUDA events, kernel, plain, plain, kernel), the plain
    version's, the library call's (x.expand(V, n).clone() for the
    all-gather, torch.sum(x, 0) for the reduce-scatter) and the byte
    bound: each operand read once and each result written once over
    3.35 TB/s, and max |kernel - plain| on these inputs.  The timing
    launches are not main-path launches."""
    V, n = SR.V, SR.ROWS * SR.COLS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    x = rand((V, n), torch.float32, gen)
    row0 = x[0].contiguous()
    ag_out, rs_out = [torch.empty(V, n, device="cuda")], \
        [torch.empty(n, device="cuda")]
    counts0 = {fn: (fn.launches, fn.launches_self) for fn in (
        ring.ring_reduce_scatter, ring.ring_all_gather)}
    calls = {
        "ring_all_gather_selfring": (
            lambda: ring.ring_all_gather([row0], out=ag_out, ring_size=V),
            lambda: ring.ring_all_gather_plain([row0], ring_size=V),
            lambda: row0.expand(V, n).clone(), "x.expand(V, n).clone()",
            (1 + V) * n * 4, "accl_tpu/ops/ring.py:151"),
        "ring_reduce_scatter_selfring": (
            lambda: ring.ring_reduce_scatter([x], out=rs_out, ring_size=V),
            lambda: ring.ring_reduce_scatter_plain([x], ring_size=V),
            lambda: torch.sum(x, 0), "torch.sum(x, 0)",
            (V + 1) * n * 4, "accl_tpu/ops/ring.py:274")}
    rows = []
    for name, (kern, plain, lib, lib_call, nbytes, src) in calls.items():
        err = max_err(kern()[0], plain()[0])
        ms = [cuda_ms(kern, 50)]
        plain_ms = [cuda_ms(plain, 20), cuda_ms(plain, 20)]
        ms.append(cuda_ms(kern, 50))
        split = split_ms(kern, 50)
        base = name.replace("_selfring", "")
        row = {"name": name, "route": "cuda",
               "source": "accl_tpu_torch/ops/csrc/ring.cu",
               "replaces": src, "launches": launches[base],
               "max_abs_err": err, "ms": statistics.median(ms),
               "device_ms": split["device_ms"],
               "host_enqueue_ms": split["host_enqueue_ms"],
               "plain_ms": statistics.median(plain_ms),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": cuda_ms(lib, 50),
               "library_call": lib_call, "checked": True,
               "shape": f"ring_size={V}, chunk [{n}] fp32 "
                        f"({SR.ROWS} x {SR.COLS})"}
        emit({"phase": "kernel_time", **row})
        rows.append(row)
    for fn, (a, b) in counts0.items():
        fn.launches, fn.launches_self = a, b
    return rows


#: sequence parallelism on the serving side: SP members over SP_TOKENS
#: global tokens (4096 a member) at Llama-3-8B width, and a sliding window
#: of Mistral-7B's 4096 (mistralai/Mistral-7B-v0.1 config.json
#: sliding_window)
SP = 8
SP_TOKENS = 32768
SP_WINDOW = 4096
#: max |logits - the sp = 1 flash forward's| of each sp forward, per
#: dtype, at Llama-3-8B width cut to 4 layers, set from the first card
#: run's readings (NVIDIA H100 80GB HBM3, 700 W): the ring folds the same
#: flash tiles by lse at shard edges, in other orders.  float32: readings
#: 6.2e-5 to 7.7e-5, the bound LOGIT_BOUND's; bfloat16 (the weights and
#: activations in bf16, the lse carry in fp32, each hop's output rounded
#: to bf16 before the merge): readings 0.133 and 0.141, the bound below
#: the bf16 forward's own distance from the fp32 one (0.27 at 2 x 4096
#: tokens, phase serving_path)
SP_BOUND = {torch.float32: 4e-4, torch.bfloat16: 0.25}
#: the sp train step: make_mesh(sp=4, tp=2) on 1 x SP_TRAIN_TOKENS
SP_TRAIN_MESH = {"sp": 4, "tp": 2}
SP_TRAIN_TOKENS = 8192
SP_TRAIN_STEPS = 2
#: Ulysses: q [1, 4096, 32, 128] and K/V [1, 4096, 8, 128] a member
ULYSSES_SHAPE = (SP, 4096, 32, 8, 128)


def sp_path(ring, F, FL, M, RA, T_) -> dict:
    """Phase sp_path: forward at sp = SP over 1 x SP_TOKENS tokens at
    Llama-3-8B width (4 layers, attn="dense": the ring owns attention and
    runs the flash kernels per hop), fp32 and bf16 (weights cast), the
    contiguous and the zigzag schedule, and a windowed forward
    (attn_window=SP_WINDOW, fp32), each held within SP_BOUND to the sp = 1
    flash forward of the same tokens and weights (zigzag un-permuted,
    compared in row chunks), each with its flash launches counted against
    the schedule's: contiguous SP per layer (hop s stacks the SP - s live
    members), zigzag SP + 1, windowed one grid launch."""
    cfg = M.ModelConfig(**{**LLAMA3_8B, "attn": "dense"})
    ref_cfg = M.ModelConfig(**LLAMA3_8B)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    torch.cuda.empty_cache()
    p32 = M.init_params(gen, cfg, tp=1)
    tokens = torch.randint(0, cfg.vocab, (1, SP_TOKENS), generator=gen,
                           device="cuda")
    perm = RA.zigzag_indices(SP_TOKENS, SP).cuda()
    L = cfg.n_layers
    peak = [0]  # the largest run's peak: weights, held logits, forward
    want = {"contiguous": {"flash_fwd_resident": SP * L},
            "zigzag": {"flash_fwd_resident": (SP + 1) * L},
            "window": {"flash_fwd_grid": L}}
    total, runs = {}, {}

    def run(name, fn):
        reset_counts(ring, F, FL)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = read_counts(ring, F, FL)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        runs[name] = {"s": secs, "tokens_per_s": SP_TOKENS / secs,
                      "launches": {k: v for k, v in counts.items() if v},
                      "held_gb": held / 1e9,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        return out

    def err_vs(lg, ref, rows=None):
        """max |lg - ref[:, rows]| over row chunks (rows: the zigzag
        permutation, lg in its layout)."""
        e = 0.0
        for i in range(0, SP_TOKENS, 4096):
            r = ref[:, i:i + 4096] if rows is None else ref[:, rows[i:i + 4096]]
            e = max(e, float((lg[:, i:i + 4096].float() - r.float()).abs().max()))
        return e

    def launches_ok(name, expect):
        got = {k: v for k, v in runs[name]["launches"].items()
               if k.startswith("flash_")}
        if got != expect:
            fail(f"{name}: flash launches {got}, the schedule's {expect}")

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        w = p32 if dt == torch.float32 else T_.tree_map(
            lambda t: t.to(torch.bfloat16), p32)
        tag = "fp32" if dt == torch.float32 else "bf16"
        c = cfg if dt == torch.float32 else M.ModelConfig(
            **{**LLAMA3_8B, "attn": "dense", "dtype": "bfloat16"})
        rc = ref_cfg if dt == torch.float32 else M.ModelConfig(
            **{**LLAMA3_8B, "dtype": "bfloat16"})
        ref = run(f"sp1_flash_{tag}", lambda: M.forward(w, tokens, rc))
        if tuple(ref.shape) != (1, SP_TOKENS, cfg.vocab) or \
                not torch.isfinite(ref).all():
            fail(f"sp1_flash_{tag}: logits {tuple(ref.shape)} not finite")
        launches_ok(f"sp1_flash_{tag}", {"flash_fwd_grid": L})
        for sched in ("contiguous", "zigzag"):
            name = f"sp{SP}_{sched}_{tag}"
            cs = M.ModelConfig(**{**vars(c), "sp_schedule": sched})
            tok = tokens if sched == "contiguous" else tokens[:, perm]
            lg = run(name, lambda: M.forward(w, tok, cs, sp=SP))
            if tuple(lg.shape) != tuple(ref.shape) or \
                    not torch.isfinite(lg).all():
                fail(f"{name}: logits {tuple(lg.shape)} not finite")
            e = err_vs(lg, ref, None if sched == "contiguous" else perm)
            runs[name]["max_abs_err_vs_sp1"] = e
            cases.append((name, e, SP_BOUND[dt]))
            launches_ok(name, want[sched])
            del lg
            torch.cuda.empty_cache()
        del ref
        torch.cuda.empty_cache()
        # s per forward, warm: sp = 1 and both schedules, in turns
        for name, fn in (
                (f"sp1_flash_{tag}", lambda: M.forward(w, tokens, rc)),
                (f"sp{SP}_contiguous_{tag}",
                 lambda: M.forward(w, tokens, c, sp=SP)),
                (f"sp{SP}_zigzag_{tag}", lambda: M.forward(
                    w, tokens[:, perm],
                    M.ModelConfig(**{**vars(c), "sp_schedule": "zigzag"}),
                    sp=SP))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            runs[name]["warm_s"] = time.perf_counter() - t
            del out
            torch.cuda.empty_cache()
        if dt == torch.bfloat16:
            del w
    # -- windowed (Mistral-7B's sliding window), fp32 ---------------------
    wc = M.ModelConfig(**{**LLAMA3_8B, "attn": "dense",
                          "attn_window": SP_WINDOW})
    wref_cfg = M.ModelConfig(**{**LLAMA3_8B, "attn_window": SP_WINDOW})
    ref = run("sp1_flash_window_fp32", lambda: M.forward(p32, tokens,
                                                         wref_cfg))
    launches_ok("sp1_flash_window_fp32", {"flash_fwd_grid": L})
    lg = run(f"sp{SP}_window_fp32", lambda: M.forward(p32, tokens, wc,
                                                      sp=SP))
    if not torch.isfinite(lg).all():
        fail("the windowed sp forward: logits not finite")
    e = err_vs(lg, ref)
    runs[f"sp{SP}_window_fp32"]["max_abs_err_vs_sp1"] = e
    cases.append((f"sp{SP}_window_fp32", e, SP_BOUND[torch.float32]))
    launches_ok(f"sp{SP}_window_fp32", want["window"])
    del lg, ref, p32
    torch.cuda.empty_cache()
    for name, e, bound in cases:
        if e > bound:
            fail(f"{name}: logits off the sp = 1 flash forward by {e} "
                 f"(bound {bound})")
    emit({"phase": "sp_path", "ok": True, "config": LLAMA3_8B,
          "reduced": "n_layers 32 -> 4", "sp": SP, "tokens": SP_TOKENS,
          "window": SP_WINDOW, "bounds": {str(k): v for k, v in
                                          SP_BOUND.items()},
          "runs": runs, "launches": total,
          "launches_per_layer": {"contiguous": SP, "zigzag": SP + 1,
                                 "window": 1},
          "forward_peak_mem_gb": peak[0] / 1e9})
    return {"launches": total}


def sp_train(ring, F, FL, M, S, T_) -> dict:
    """Phase sp_train: make_train_step on make_mesh(sp=4, tp=2) at
    Llama-3-8B width (4 layers, attn="dense", the ring's flash hops and
    their backward with the lse cotangent of the merges), fp32, 1 x
    SP_TRAIN_TOKENS tokens, SP_TRAIN_STEPS SGD steps at TRAIN_LR, each held
    to the same step on make_mesh(tp=2) (sp = 1, attn="flash") from the
    same weights: loss within TRAIN_LOSS_BOUND, each leaf's gradient within
    TRAIN_GRAD_BOUND plus the update's rounding floor.  Every flash kernel
    launches 4 hops x tp x layers a step."""
    cfg = M.ModelConfig(**{**LLAMA3_8B, "attn": "dense"})
    ref_cfg = M.ModelConfig(**LLAMA3_8B)
    mesh = S.make_mesh(**SP_TRAIN_MESH)
    ref_mesh = S.make_mesh(tp=SP_TRAIN_MESH["tp"])
    sp, tp = mesh.shape["sp"], mesh.shape["tp"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prev = M.init_params(gen, cfg, tp=tp)
    tokens = torch.randint(0, cfg.vocab, (1, SP_TRAIN_TOKENS),
                           generator=gen, device="cuda")
    step = M.make_train_step(mesh, cfg, lr=TRAIN_LR)[0]
    ref_step = M.make_train_step(ref_mesh, ref_cfg, lr=TRAIN_LR)[0]
    total, runs, held = {}, {}, []

    def run(name, fn):
        reset_counts(ring, F, FL)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = read_counts(ring, F, FL)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        runs[name] = {"s": secs, "launches": {k: v for k, v in
                                              counts.items() if v}}
        return out

    per = cfg.n_layers * tp * sp
    losses = []
    for i in range(1, SP_TRAIN_STEPS + 1):
        params = T_.tree_map(torch.clone, prev)
        params, loss = run(f"step_{i}", lambda: step(params, tokens))
        other = T_.tree_map(torch.clone, prev)
        other, rloss = run(f"step_{i}_sp1_flash",
                           lambda: ref_step(other, tokens))
        cmp = update_diffs(params, other, prev, T_)
        loss_err = abs(float(loss) - float(rloss)) / abs(float(rloss))
        held.append({"loss": float(loss), "sp1_loss": float(rloss),
                     "loss_rel_err": loss_err,
                     "grad_rel_l2_max": max(d for d, _f, _n in cmp),
                     "rounding_floor_max": max(f for _d, f, _n in cmp)})
        if loss_err > TRAIN_LOSS_BOUND or \
                max(d - (TRAIN_GRAD_BOUND + f) for d, f, _n in cmp) > 0:
            fail(f"sp step {i} off the sp = 1 flash step: loss {loss_err} "
                 f"(bound {TRAIN_LOSS_BOUND}), per-leaf gradient "
                 f"{[(d, TRAIN_GRAD_BOUND + f) for d, f, _n in cmp]}")
        got = {k: runs[f"step_{i}"]["launches"].get(k, 0) for k in
               ("flash_fwd_resident", "flash_bwd_dq", "flash_bwd_dkv")}
        if got != dict.fromkeys(got, per) or \
                runs[f"step_{i}"]["launches"].get("flash_fwd_grid"):
            fail(f"sp step {i} must launch each flash kernel {per} times "
                 f"(hops x tp x layers): {runs[f'step_{i}']['launches']}")
        losses.append(float(loss))
        del other, prev
        prev = params
        torch.cuda.empty_cache()
    if not all(np.isfinite(v) for v in losses):
        fail(f"sp training: losses {losses} not finite")
    emit({"phase": "sp_train", "ok": True, "config": LLAMA3_8B,
          "reduced": "n_layers 32 -> 4", "mesh": mesh.shape,
          "tokens_per_step": SP_TRAIN_TOKENS, "lr": TRAIN_LR,
          "losses": losses, "held_to_sp1_flash": held,
          "bounds": {"loss": TRAIN_LOSS_BOUND, "grad": TRAIN_GRAD_BOUND},
          "s_per_step": [runs[f"step_{i}"]["s"] for i in
                         range(1, SP_TRAIN_STEPS + 1)],
          "sp1_s_per_step": [runs[f"step_{i}_sp1_flash"]["s"] for i in
                             range(1, SP_TRAIN_STEPS + 1)],
          "launches_per_step": per, "runs": runs, "launches": total,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del prev
    torch.cuda.empty_cache()
    return {"launches": total}


def ulysses_phase(ring, F, FL, RA) -> dict:
    """Phase ulysses: ulysses_attention over SP members, q [1, 4096, 32,
    128] and K/V [1, 4096, 8, 128] a member (GQA, G % SP = 0), fp32 and
    bf16, held bitwise to one flash_attention over the 32768 tokens (each
    member's heads are rows of the same kernel at the same lengths and
    group, stacked along the batch axis): one grid launch each."""
    P_, Tl, H, G, D = ULYSSES_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    total, runs = {}, {}

    def run(name, fn):
        reset_counts(ring, F, FL)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs[name] = {"s": time.perf_counter() - t}
        counts = read_counts(ring, F, FL)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        runs[name]["launches"] = {k: v for k, v in counts.items() if v}
        return out

    for dt in (torch.float32, torch.bfloat16):
        tag = "fp32" if dt == torch.float32 else "bf16"
        q = rand((1, P_ * Tl, H, D), dt, gen)
        k, v = rand((1, P_ * Tl, G, D), dt, gen), rand((1, P_ * Tl, G, D),
                                                         dt, gen)
        out = run(f"ulysses_{tag}", lambda: RA.ulysses_attention(
            list(q.chunk(P_, 1)), list(k.chunk(P_, 1)), list(v.chunk(P_, 1)),
            causal=True))
        ref = run(f"flash_{tag}", lambda: FL.flash_attention(
            q, k, v, causal=True, mxu_dtype=dt))
        got = torch.cat(out, dim=1)
        runs[f"ulysses_{tag}"]["bitwise"] = torch.equal(got, ref)
        runs[f"ulysses_{tag}"]["max_abs_err"] = max_err(got, ref)
        if not torch.equal(got, ref):
            fail(f"ulysses {tag}: not bitwise equal to one flash_attention "
                 f"(max abs err {max_err(got, ref)})")
        for name in (f"ulysses_{tag}", f"flash_{tag}"):
            if runs[name]["launches"] != {"flash_fwd_grid": 1}:
                fail(f"{name}: launches {runs[name]['launches']}, one "
                     f"grid launch expected")
        del q, k, v, out, ref, got
    torch.cuda.empty_cache()
    emit({"phase": "ulysses", "ok": True, "members": P_,
          "per_member": {"q": [1, Tl, H, D], "kv": [1, Tl, G, D]},
          "runs": runs, "launches": total})
    return {"launches": total}


#: Switch-Base-8 at full width (google/switch-base-8 config.json: d_model
#: 768, d_ff 3072, 12 heads of d_kv 64, 8 experts, vocabulary 32128; top-1
#: routing at capacity factor 1.25), depth cut to 4 layers
SWITCH_BASE_8 = dict(vocab=32128, d_model=768, n_layers=4, n_heads=12,
                     d_head=64, d_ff=3072, n_experts=8,
                     capacity_factor=1.25, dtype="float32")
MOE_TOKENS = (8, 2048)
MOE_STEPS = 3
#: prompt and teacher-forced decode steps of the MoE serving check
MOE_DECODE = (256, 16)
#: max |logits - the dense forward's| of the ep forward and of decode,
#: and |fused - unfused| of the ep forward, fp32 at Switch-Base-8 width
#: (|logits| ~ 0.5): the expert products run on other row counts, and
#: cuBLAS picks its GEMM kernel, and so its order of summation over K, by
#: the row count (the fused lane's chunk of P ck rows against the whole
#: capacity's P cap).  Card readings (NVIDIA H100 80GB HBM3, 700 W): ep
#: against dense 3.8e-6, fused against unfused 3.9e-6, decode 4.3e-6; the
#: bound is 10 times the largest and must fail the control (the fused
#: forward with the last block's expert banks rounded to bf16 against the
#: unfused one)
MOE_BOUND = 4e-5


def bf16_experts(params):
    """``params`` with the last block's expert banks rounded to bfloat16
    and kept in float32: the control a bound on float32 expert products
    must fail.  Only the last block's, so that every router sees the
    inputs it saw and routes each token as before: the control moves the
    logits by the products' precision alone, not by a token changing
    expert."""
    *rest, last = params["blocks"]
    return {**params, "blocks": rest + [
        {**last, **{w: [x.bfloat16().float() for x in last[w]]
                    for w in ("we1", "we2")}}]}


def moe_path(ring, F, FL, MM, MD, S, T_) -> dict:
    """Phase moe_path: the MoE model at Switch-Base-8 width (4 layers),
    fp32, 8 x 2048 tokens on make_mesh(ep=8) (one expert a member, 2048
    tokens a member).  The ep forward is held to the dense
    run-every-expert forward at a drop-free capacity (capacity factor 8,
    as the JAX tests compare them) within MOE_BOUND; at the published
    capacity factor 1.25 the fused forward (fused_expert_ffn) within
    MOE_BOUND of the unfused one (cuBLAS rounds the chunk's products
    otherwise) while the control with the last block's expert banks
    rounded to bf16 falls outside it, and the fused lane's routing bitwise dispatch -> FFN ->
    combine with a row-wise expert; MOE_STEPS train steps at TRAIN_LR on
    the ep mesh at 1.25, losses finite and falling; one drop-free ep step held to the
    dense full-batch step over the same 8 data members (make_mesh(dp=8),
    the aux per member as each ep member's) within TRAIN_LOSS_BOUND and
    TRAIN_GRAD_BOUND; ep decode (8 requests, MOE_DECODE prompt and steps)
    held to the dense forward within MOE_BOUND."""
    cfg = MM.MoEConfig(**SWITCH_BASE_8)
    free = MM.MoEConfig(**{**SWITCH_BASE_8,
                           "capacity_factor": float(cfg.n_experts)})
    E = cfg.n_experts
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p0 = MM.init_params(gen, cfg, ep=E)
    tokens = torch.randint(0, cfg.vocab, MOE_TOKENS, generator=gen,
                           device="cuda")
    total, runs = {}, {}

    def run(name, fn):
        reset_counts(ring, F, FL)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs[name] = {"s": time.perf_counter() - t}
        for key, val in read_counts(ring, F, FL).items():
            total[key] = total.get(key, 0) + val
        return out

    dense, _aux = run("forward_dense", lambda: MM.forward(p0, tokens, free))
    ep_lg, ep_aux = run("forward_ep", lambda: MM.forward(p0, tokens, free,
                                                         ep=E))
    e_ep = max_err(ep_lg, dense)
    if not torch.isfinite(ep_lg).all() or e_ep > MOE_BOUND:
        fail(f"the ep forward is off the dense one by {e_ep} (bound "
             f"{MOE_BOUND}) or not finite")
    del ep_lg
    a, _ = run("forward_ep_cf1.25", lambda: MM.forward(p0, tokens, cfg,
                                                       ep=E))
    b, _ = run("forward_ep_cf1.25_fused", lambda: MM.forward(
        p0, tokens, cfg, ep=E, fused=True))
    e_fused = max_err(a, b)
    if e_fused > MOE_BOUND:
        fail(f"the fused ep forward is off the unfused one by {e_fused} "
             f"(bound {MOE_BOUND})")
    del b
    c, _ = MM.forward(bf16_experts(p0), tokens, cfg, ep=E, fused=True)
    e_control = max_err(a, c)
    if not e_control > MOE_BOUND:
        fail(f"MOE_BOUND {MOE_BOUND} does not catch bf16 expert banks: "
             f"{e_control}")
    dropped_rows = int(((a - dense).abs().amax(-1) > MOE_BOUND).sum())
    del a, c
    # the fused lane's routing at the model's shapes (2048 tokens of 768 a
    # member, capacity 320 in 4 chunks of 80), bitwise dispatch -> FFN ->
    # combine with an expert FFN that computes each row alone
    xs = [rand((MOE_TOKENS[1], cfg.d_model), torch.float32, gen)
          for _ in range(E)]
    idxs = [torch.randint(0, E, (MOE_TOKENS[1],), generator=gen,
                          device="cuda") for _ in range(E)]
    cap = int(np.ceil(MOE_TOKENS[1] * cfg.capacity_factor / E))
    ffns = [lambda t, r=r: torch.nn.functional.gelu(
        t, approximate="tanh") * (r + 1) for r in range(E)]
    got = F.fused_expert_ffn(xs, idxs, ffns, capacity=cap)
    inp, info = S.expert_dispatch(xs, idxs, capacity=cap)
    routed = S.expert_combine([f(t) for f, t in zip(ffns, inp)], info)
    routing_bitwise = all(torch.equal(x, y) for x, y in zip(got, routed))
    if not routing_bitwise:
        fail("fused_expert_ffn's routing is not bitwise dispatch -> FFN -> "
             "combine")
    del xs, idxs, got, inp, info, routed
    # -- one drop-free step against the dense full-batch step -------------
    ep_mesh, dp_mesh = S.make_mesh(ep=E), S.make_mesh(dp=E)
    p_ep = T_.tree_map(torch.clone, p0)
    p_ep, l_ep = run("step_ep_dropfree", lambda: MM.make_train_step(
        ep_mesh, free, lr=TRAIN_LR)[0](p_ep, tokens))
    p_d = MM.shard_params(T_.tree_map(torch.clone, p0), cfg, 1)
    p_d, l_d = run("step_dense_full_batch", lambda: MM.make_train_step(
        dp_mesh, free, lr=TRAIN_LR)[0](p_d, tokens))
    cmp = update_diffs(MM.shard_params(p_ep, cfg, 1), p_d,
                       MM.shard_params(p0, cfg, 1), T_)
    loss_err = abs(float(l_ep) - float(l_d)) / abs(float(l_d))
    if loss_err > TRAIN_LOSS_BOUND or \
            max(d - (TRAIN_GRAD_BOUND + f) for d, f, _n in cmp) > 0:
        fail(f"the ep step is off the dense full-batch step: loss "
             f"{loss_err}, per-leaf gradient "
             f"{[(d, TRAIN_GRAD_BOUND + f) for d, f, _n in cmp]}")
    del p_ep, p_d
    # -- training at the published capacity ------------------------------
    step = MM.make_train_step(ep_mesh, cfg, lr=TRAIN_LR)[0]
    params = T_.tree_map(torch.clone, p0)
    losses = []
    for i in range(1, MOE_STEPS + 1):
        params, loss = run(f"step_{i}", lambda: step(params, tokens))
        losses.append(float(loss))
    if not all(np.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"MoE training: losses {losses} not finite or not falling")
    del params
    # -- expert-parallel decode, teacher-forced ---------------------------
    Tp, n_dec = MOE_DECODE
    B = MOE_TOKENS[0]
    seq = tokens[:, :Tp + n_dec]
    cache = MD.init_kv_cache(cfg, B, Tp + n_dec)
    lg_pre, _a, cache = run("prefill_ep", lambda: MD.prefill(
        p0, seq[:, :Tp], cache, cfg, ep=E))
    steps, step_s = [], []
    for t in range(n_dec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = MD.decode_step(p0, seq[:, Tp + t], cache, cfg, ep=E)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        steps.append(lg)
    want, _ = run("forward_dense_decode_ref", lambda: MM.forward(
        p0, seq, cfg))
    e_pre = max_err(lg_pre, want[:, :Tp])
    e_dec = max(max_err(lg, want[:, Tp + t]) for t, lg in enumerate(steps))
    if e_pre > MOE_BOUND or e_dec > MOE_BOUND:
        fail(f"MoE ep prefill/decode off the dense forward: {e_pre}, "
             f"{e_dec} (bound {MOE_BOUND})")
    emit({"phase": "moe_path", "ok": True, "config": SWITCH_BASE_8,
          "reduced": "12 encoder + 12 decoder layers -> 4 decoder-only "
                     "layers", "mesh": {"ep": E}, "tokens": list(MOE_TOKENS),
          "forward_ep_max_abs_err_vs_dense": e_ep,
          "fused_max_abs_err_vs_unfused": e_fused,
          "bf16_expert_control": e_control,
          "fused_routing_bitwise": routing_bitwise,
          "rows_off_dense_at_cf1.25": dropped_rows,
          "aux_per_member": [float(x) for x in ep_aux],
          "held_step": {"loss_rel_err": loss_err,
                        "grad_rel_l2_max": max(d for d, _f, _n in cmp),
                        "rounding_floor_max": max(f for _d, f, _n in cmp)},
          "losses": losses, "lr": TRAIN_LR,
          "s_per_forward": {k: runs[k]["s"] for k in (
              "forward_dense", "forward_ep", "forward_ep_cf1.25",
              "forward_ep_cf1.25_fused")},
          "s_per_step": [runs[f"step_{i}"]["s"] for i in
                         range(1, MOE_STEPS + 1)],
          "tokens_per_s": MOE_TOKENS[0] * MOE_TOKENS[1] / statistics.median(
              runs[f"step_{i}"]["s"] for i in range(1, MOE_STEPS + 1)),
          "decode": {"prefill_s": runs["prefill_ep"]["s"],
                     "ms_per_step": statistics.median(step_s) * 1e3,
                     "max_abs_err": {"prefill": e_pre, "decode": e_dec}},
          "bound": MOE_BOUND, "launches": total,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del p0, dense, want, steps, cache
    torch.cuda.empty_cache()
    return {"launches": total}


def attention_bound(N, T, Tk, causal, dt) -> tuple:
    """(bound ms, "operations" or "bytes") of one forward: QK^T and PV over
    the cells the mask keeps (T (T + 1) / 2 per head when causal), 2
    operations per multiply-add; q, k, v read and out, lse written once."""
    cells = T * (T + 1) // 2 if causal else T * Tk
    el = torch.finfo(dt).bits // 8
    ops = 2 * 2 * D_HEAD * cells * N
    nbytes = (2 * N * T * D_HEAD + 2 * N * Tk * D_HEAD) * el + N * T * 4
    return matmul_bound(ops, nbytes, dt) + (ops,)


def time_flash_kernels(FL, errs, launches, per_forward) -> list:
    """Phase 5d: each flash kernel per launch at the model path's per-rank
    shape, fp32 with the fp32 MXU dtype as there, interleaved with its
    plain version (kernel, plain, plain, kernel), beside SDPA with GQA
    (torch.nn.functional.scaled_dot_product_attention, a yardstick only)
    and the bound; bf16 inputs are printed beside."""
    import torch.nn.functional as tnf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = []
    for name, (N, Nk, T), kernel in (("flash_fwd_resident", FLASH_RESIDENT,
                                      "resident"),
                                     ("flash_fwd_grid", FLASH_GRID, "grid")):
        fn, plain = getattr(FL, name), getattr(FL, name + "_plain")
        for dt in (torch.float32, torch.bfloat16):
            q = rand((N, T, D_HEAD), dt, gen)
            k, v = rand((Nk, T, D_HEAD), dt, gen), rand((Nk, T, D_HEAD), dt,
                                                         gen)
            cfg = flash_cfg(FL, N, Nk, T, T, dt, dt, kernel, True)
            ms = [cuda_ms(lambda: fn(q, k, v, cfg), 5, runs=3)]
            p_ms = [cuda_ms(lambda: plain(q, k, v, cfg), 1, runs=3)]
            p_ms.append(cuda_ms(lambda: plain(q, k, v, cfg), 1, runs=3))
            ms.append(cuda_ms(lambda: fn(q, k, v, cfg), 5, runs=3))
            qs = q.view(Nk, N // Nk, T, D_HEAD)
            ks, vs = k.view(Nk, 1, T, D_HEAD), v.view(Nk, 1, T, D_HEAD)
            lib = cuda_ms(lambda: tnf.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), 5, runs=3)
            bound, by, ops = attention_bound(N, T, T, True, dt)
            t = statistics.median(ms)
            row = {"name": name, "route": "cuda",
                   "source": "accl_tpu_torch/ops/csrc/flash.cu",
                   "kernel": name, "replaces": (
                       "accl_tpu/ops/flash.py:288" if kernel == "resident"
                       else "accl_tpu/ops/flash.py:188"),
                   "launches": launches[name], "max_abs_err": errs[name],
                   "ms": t, "plain_ms": statistics.median(p_ms),
                   "bound_ms": bound, "bound_by": by, "library_ms": lib,
                   "library_call": "scaled_dot_product_attention(is_causal, "
                                   "enable_gqa)", "checked": True,
                   "shape": f"q [{N},{T},{D_HEAD}] k/v [{Nk},{T},{D_HEAD}] "
                            f"causal {dt} mxu {dt}",
                   "ctas": FL.kernel_ctas(N, T, N // Nk, dt),
                   "tflops": ops / (t * 1e-3) / 1e12,
                   "launches_per_forward": per_forward[name]}
            del q, k, v, qs, ks, vs
            if dt == torch.bfloat16:
                emit({"phase": "kernel_time_bf16", **row})
            else:
                emit({"phase": "kernel_time", **row})
                rows.append(row)
    torch.cuda.empty_cache()
    FL.flash_fwd_resident.launches = launches["flash_fwd_resident"]
    FL.flash_fwd_grid.launches = launches["flash_fwd_grid"]
    return rows


def bwd_bound(which, N, Nk, T, dt) -> tuple:
    """(bound ms, "operations" or "bytes", operations) of one causal
    backward launch: dq's three products (S, dP, dS K) or dkv's four (S,
    dP, P^T dO, dS^T q) over the T (T + 1) / 2 kept cells per q head, 2
    operations per multiply-add; q2, dO, K, V, l2 and dvec read once, the
    gradients written once."""
    cells = T * (T + 1) // 2
    el = torch.finfo(dt).bits // 8
    ops = (3 if which == "dq" else 4) * 2 * D_HEAD * cells * N
    reads = (2 * N * T * D_HEAD + 2 * Nk * T * D_HEAD) * el + 2 * N * T * 4
    writes = (N if which == "dq" else 2 * Nk) * T * D_HEAD * el
    return matmul_bound(ops, reads + writes, dt) + (ops,)


def time_flash_bwd_kernels(FL, errs, launches, per_step) -> list:
    """Phase 5e: each flash backward kernel per launch at the training
    path's per-rank shape (FLASH_TRAIN, causal), fp32 with the fp32 MXU
    dtype as there, interleaved with its plain version (kernel, plain,
    plain, kernel), beside SDPA's backward by autograd with GQA
    (torch.nn.functional.scaled_dot_product_attention, a yardstick only;
    its forward time subtracted; it computes dq, dk and dv in one) and the
    bound; bf16 inputs are printed beside."""
    import torch.nn.functional as tnf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    N, Nk, T = FLASH_TRAIN
    counts0 = {k: getattr(FL, k).launches for k in FLASH_KERNELS}
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        ops, cfg = bwd_operands(FL, N, Nk, T, T, dt, dt, True, None, False,
                                gen)
        q = rand((Nk, N // Nk, T, D_HEAD), dt, gen).requires_grad_(True)
        k = rand((Nk, 1, T, D_HEAD), dt, gen).requires_grad_(True)
        v = rand((Nk, 1, T, D_HEAD), dt, gen).requires_grad_(True)
        do = rand((Nk, N // Nk, T, D_HEAD), dt, gen)

        def sdpa():
            return tnf.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    enable_gqa=True)

        def sdpa_fwd():
            with torch.no_grad():
                sdpa()

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (q, k, v), do)

        lib = (cuda_ms(sdpa_fwd_bwd, 3, runs=3)
               - cuda_ms(sdpa_fwd, 3, runs=3))
        for name, fn, plain in (
                ("flash_bwd_dq", FL.flash_bwd_dq, FL.flash_bwd_dq_plain),
                ("flash_bwd_dkv", FL.flash_bwd_dkv, FL.flash_bwd_dkv_plain)):
            ms = [cuda_ms(lambda: fn(*ops, cfg), 3, runs=3)]
            p_ms = [cuda_ms(lambda: plain(*ops, cfg), 1, runs=3)]
            p_ms.append(cuda_ms(lambda: plain(*ops, cfg), 1, runs=3))
            ms.append(cuda_ms(lambda: fn(*ops, cfg), 3, runs=3))
            which = name.split("_")[-1]
            bound, by, n_ops = bwd_bound(which, N, Nk, T, dt)
            t = statistics.median(ms)
            sp = split_ms(lambda: fn(*ops, cfg), 10, runs=3)
            row = {"name": name, "route": "cuda",
                   "source": "accl_tpu_torch/ops/csrc/flash_bwd.cu",
                   "device_ms": sp["device_ms"],
                   "host_enqueue_ms": sp["host_enqueue_ms"],
                   "kernel": name, "replaces": (
                       "accl_tpu/ops/flash.py:873" if which == "dq"
                       else "accl_tpu/ops/flash.py:939"),
                   "launches": launches[name], "max_abs_err": errs[name],
                   "ms": t, "plain_ms": statistics.median(p_ms),
                   "bound_ms": bound, "bound_by": by, "library_ms": lib,
                   "library_call": "scaled_dot_product_attention(is_causal, "
                                   "enable_gqa) backward by autograd (dq, "
                                   "dk and dv together), forward time "
                                   "subtracted", "checked": True,
                   "shape": f"q, dO [{N},{T},{D_HEAD}] k/v "
                            f"[{Nk},{T},{D_HEAD}] causal {dt} mxu {dt}",
                   "plan": bwd_plan_reading(FL, N, Nk, T, T, True, None,
                                            dt, dt),
                   "tflops": n_ops / (t * 1e-3) / 1e12,
                   "launches_per_train_step": per_step[name]}
            if dt == torch.bfloat16:
                emit({"phase": "kernel_time_bf16", **row})
            else:
                emit({"phase": "kernel_time", **row})
                rows.append(row)
        del ops, q, k, v, do
    torch.cuda.empty_cache()
    for key, val in counts0.items():  # the timing launches are not main-path
        getattr(FL, key).launches = val
    return rows


#: the plugin lanes' bench shapes (bench.py): the reduce lane on 64 Mi
#: fp32 elements as [524288, 128] over the block_rows ladder, the
#: compression roundtrip on 64 Mi fp32 elements as [131072, 512]
PLUGIN_N = 64 << 20
COMBINE_LADDER = (512, 2048)
#: the combine kernel's dtypes: with sum and max, the 12 ARITH_LANE lanes
COMBINE_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
                  torch.float16, torch.bfloat16)
#: phase 4f's short tuning grid: the 4 column counts x 2 tile depths
TUNE_COLS = (128, 512, 1024, 4096)
TUNE_BLOCK_ROWS = (256, 1024)


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, for comparisons that see -0.0 and NaN payloads."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def plugin_kernel_info(R, C) -> dict:
    """accl_combine_kernel_info and accl_cast_kernel_info of every
    instantiation the lanes launch: registers, local bytes and CTAs per
    SM."""
    dev = torch.cuda.current_device()
    combine, cast = {}, {}
    for dt in COMBINE_DTYPES:
        for is_max in (False, True):
            for vec in (True, False):
                combine[f"{dt} {'max' if is_max else 'sum'} "
                        f"{'vec' if vec else 'elem'}"] = \
                    R.combine_kernel_info(R.KERNEL_DTYPES[dt], is_max, vec,
                                          dev)
    pairs = ([(torch.float32, d, False) for d in C.NEAREST_TARGETS]
             + [(s, torch.float32, False) for s in C.WIDEN_SOURCES]
             + [(torch.float32, d, True) for d in C.STOCHASTIC_TARGETS])
    for src, dst, sr in pairs:
        for vec in (True, False):
            cast[f"{src} -> {dst} {'stochastic' if sr else 'nearest'} "
                 f"{'vec' if vec else 'elem'}"] = \
                C.cast_kernel_info(src, dst, sr, vec, dev)
    return {"accl_combine_kernel_info": combine,
            "accl_cast_kernel_info": cast}


#: stochastic rounding's edge inputs: NaN, fp32 subnormals, +-FLT_MAX, inf,
#: zeros, the fp8 range thresholds (e5m2 57344-65536, e4m3fn 448-480), the
#: bottoms of their normal ranges, and values below 2^-24 / 2^-17, where
#: the kernel takes its 64-bit add
SR_EDGES = (float("nan"), -float("nan"), 1e-40, -1e-40, 1.4e-45,
            3.4028235e38, -3.4028235e38, float("inf"), -float("inf"), 0.0,
            -0.0, 57344.0, 61440.0, 65504.0, 65520.0, 65535.0, 65536.0,
            -65536.0, 448.0, 464.0, 479.0, 480.0, -480.0, 2.0 ** -14,
            2.0 ** -15, 2.0 ** -6, 2.0 ** -7, 2.0 ** -16, 2.0 ** -9,
            2.0 ** -17, 2.0 ** -18, 2.0 ** -24, 2.0 ** -25, 3e-8, 1e-10,
            -1e-10, 1e-30, 1.0 + 2.0 ** -12)


def same_bits_or_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal where neither is NaN, and NaN in the same places:
    the widening cast keeps cvt's NaN payload, which Tensor.to's software
    fp8 conversion does not share."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(bits(a)[~na], bits(b)[~nb])


def check_plugin_edges(R, C, gen) -> dict:
    """Phase 3e's edge cases: the stochastic edges (SR_EDGES scattered over
    a [4096, 512] input with tiny and subnormal-range rows) bitwise against
    the plain version, and the widening cast after them; a tile of 15
    elements ([40, 5], block_rows 3); every lane on views one element off
    16-byte alignment (the kernels' element path) against the plain
    versions; two launches of each stochastic target bitwise equal for
    one seed, different for the next."""
    out = {}
    x = rand((4096, 512), torch.float32, gen) * 30
    x[1] = rand((512,), torch.float32, gen) * 1e-9   # below 2^-24
    x[2] = rand((512,), torch.float32, gen) * 1e-5   # fp8 subnormal range
    x[3] = rand((512,), torch.float32, gen) * 1e-39  # fp32 subnormals
    edges = torch.tensor(SR_EDGES, device="cuda")
    pos = torch.randperm(x.numel(), generator=gen, device="cuda")[:4096]
    x.view(-1)[pos] = edges.repeat(-(-4096 // edges.numel()))[:4096]
    x[0, :edges.numel()] = edges
    tile15 = rand((40, 5), torch.float32, gen) * 30
    tile15.view(-1)[:edges.numel()] = edges[:tile15.numel()]
    for dt in C.STOCHASTIC_TARGETS:
        for name, xv, br in (("edges", x, C._BLOCK_ROWS), ("tile15", tile15,
                                                           3)):
            got = C._cast_2d(xv, SEED, dt, True, br)
            z = C.decompress_cast(got)
            torch.cuda.synchronize()
            want = C._cast_2d_plain(xv, SEED, dt, True, br)
            if not torch.equal(bits(got), bits(want)):
                fail(f"stochastic cast {dt} {name}: not bitwise equal to the "
                     f"plain version ({int((bits(got) != bits(want)).sum())} "
                     f"differ)")
            if not same_bits_or_nan(z, got.float()):
                fail(f"decompress_cast {dt} after the {name}: not Tensor.to")
        again = C._cast_2d(x, SEED, dt, True, C._BLOCK_ROWS)
        first = C._cast_2d(x, SEED, dt, True, C._BLOCK_ROWS)
        other = C._cast_2d(x, SEED + 1, dt, True, C._BLOCK_ROWS)
        torch.cuda.synchronize()
        if not torch.equal(bits(again), bits(first)) or \
                torch.equal(bits(other), bits(first)):
            fail(f"stochastic cast {dt}: not repeatable for one seed, or "
                 f"the same for the next seed")
        out[str(dt)] = {"changed_by_next_seed":
                        int((bits(other) != bits(first)).sum())}
        del got, z, want, again, first, other
    # one element off 16-byte alignment: the element path of both kernels
    rows = 4099
    for dt in COMBINE_DTYPES:
        buf_a = rand((rows * 128 + 1,), dt, gen)
        buf_b = rand((rows * 128 + 1,), dt, gen)
        a, b = buf_a[1:].view(rows, 128), buf_b[1:].view(rows, 128)
        if a.data_ptr() % 16 == 0 or b.data_ptr() % 16 == 0:
            fail("the unaligned combine operands are aligned")
        for is_max in (False, True):
            got = R._pallas_combine_2d(a, b, is_max)
            torch.cuda.synchronize()
            if not torch.equal(bits(got), bits(R._combine_2d_plain(a, b,
                                                                   is_max))):
                fail(f"combine {dt} max={is_max} unaligned: not the plain "
                     f"version")
        want = a + b
        if R._pallas_combine_2d(a, b, False, 0, True) is not a or \
                not torch.equal(bits(a), bits(want)):
            fail(f"combine {dt} donate unaligned: not a + b in a's storage")
        del buf_a, buf_b, a, b, got, want
    buf = rand((4099 * 512 + 1,), torch.float32, gen) * 4
    buf[1:1 + len(SR_EDGES)] = torch.tensor(SR_EDGES, device="cuda")
    xu = buf[1:].view(4099, 512)
    pairs = ([(dt, False) for dt in C.NEAREST_TARGETS]
             + [(dt, True) for dt in C.STOCHASTIC_TARGETS])
    for dt, stochastic in pairs:
        got = C._cast_2d(xu, SEED, dt, stochastic, 7)
        torch.cuda.synchronize()
        want = C._cast_2d_plain(xu, SEED, dt, stochastic, 7)
        if not torch.equal(bits(got), bits(want)):
            fail(f"cast {dt} stochastic={stochastic} unaligned: not the "
                 f"plain version")
    for src in C.WIDEN_SOURCES:
        hb = xu.to(src).view(-1)
        hbuf = torch.empty(hb.numel() + 1, dtype=src, device="cuda")
        hbuf[1:] = hb
        hu = hbuf[1:].view(4099, 512)
        got = C._cast_2d(hu, 0, torch.float32, False, 7)
        torch.cuda.synchronize()
        if not same_bits_or_nan(got, hu.float()) or (
                src in (torch.float16, torch.bfloat16)
                and not torch.equal(bits(got), bits(hu.float()))):
            fail(f"cast {src} -> float32 unaligned: not Tensor.to")
        del hb, hbuf, hu, got
    del x, tile15, buf, xu
    torch.cuda.empty_cache()
    return out


def check_plugin_kernels(R, C) -> dict:
    """Phase 3e: the combine kernel on all 12 lanes (6 dtypes x sum, max)
    at the bench shape (PLUGIN_N elements) and at 4099, bitwise against
    its plain version (a + b, torch.maximum), and with donate; the cast
    kernel both ways for both half types at the bench shape and at a
    ragged length holding NaN, inf, overflow and fp16 subnormals, bitwise
    against its plain version, which is Tensor.to; the same kernel at every
    geometry of phase 4f's tuning grid (TUNE_COLS x TUNE_BLOCK_ROWS), both
    ways for both half types, bitwise against Tensor.to; the stochastic
    cast to bf16, e5m2 and e4m3fn bitwise against its plain version (the
    same hash and rounding in integer torch ops) at two tile depths, and
    unbiased at 1 + 2^-12.  Returns the largest |kernel - plain| read per
    kernel-line row on the bench-shape inputs (finite by construction)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    errs = {"combine_2d": 0.0, "cast_2d": 0.0, "cast2d": 0.0}
    for n in (PLUGIN_N, 4099):
        for dt in COMBINE_DTYPES:
            a, b = rand((n,), dt, gen), rand((n,), dt, gen)
            b[:7] = a[:7]  # ties
            for op in ("sum", "max"):
                got = R.reduce_lane(a, b, op)
                torch.cuda.synchronize()
                want = R._combine_2d_plain(a, b, op == "max")
                if not torch.equal(bits(got), bits(want)):
                    fail(f"combine {dt} {op} n={n}: not bitwise equal to the "
                         f"plain version")
                errs["combine_2d"] = max(errs["combine_2d"],
                                         max_err(got, want))
                del got, want
            want = a + b
            got = R.pallas_add(a, b, donate=True)
            torch.cuda.synchronize()
            if got is not a or not torch.equal(bits(a), bits(want)):
                fail(f"combine {dt} donate n={n}: not a + b in a's storage")
            del a, b, got, want
    torch.cuda.empty_cache()
    ragged = rand((3 * 512 * 7 + 5,), torch.float32, gen) * 4
    ragged[:9] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                               70000.0, -0.0, 1e-6, 3e-8, 6e-5, 65520.0],
                              device="cuda")
    big = rand((PLUGIN_N,), torch.float32, gen) * 4
    for x in (big, ragged):
        for dt in (torch.float16, torch.bfloat16):
            y = C.compress_cast(x, dt)
            z = C.decompress_cast(y)
            torch.cuda.synchronize()
            want_y, want_z = x.to(dt), y.float()
            if not torch.equal(bits(y), bits(want_y)):
                fail(f"compress_cast {dt} n={x.numel()}: not bitwise equal "
                     f"to Tensor.to")
            if not torch.equal(bits(z), bits(want_z)):
                fail(f"decompress_cast {dt} n={x.numel()}: not bitwise "
                     f"equal to Tensor.to")
            if x is big:
                errs["cast_2d"] = max(errs["cast_2d"], max_err(y, want_y),
                                      max_err(z, want_z))
            del y, z, want_y, want_z
    geometries = []
    for cols in TUNE_COLS:
        for br in TUNE_BLOCK_ROWS:
            xv = big.view(-1, cols)
            for dt in (torch.float16, torch.bfloat16):
                y = C._cast_2d(xv, 0, dt, False, br)
                z = C._cast_2d(y, 0, torch.float32, False, br)
                torch.cuda.synchronize()
                want_y, want_z = xv.to(dt), y.float()
                if not (torch.equal(bits(y), bits(want_y))
                        and torch.equal(bits(z), bits(want_z))):
                    fail(f"cast at [{xv.shape[0]}, {cols}] block_rows {br} "
                         f"{dt}: not bitwise equal to Tensor.to")
                errs["cast2d"] = max(errs["cast2d"], max_err(y, want_y),
                                     max_err(z, want_z))
                del y, z, want_y, want_z
            geometries.append([cols, br])
    del big, ragged, xv
    xs = rand((PLUGIN_N // 512, 512), torch.float32, gen) * 30
    xs[0, :6] = torch.tensor([float("inf"), -float("inf"), 1e6, -1e6, 1e-30,
                              -0.0], device="cuda")
    sr = {}
    for dt in C.STOCHASTIC_TARGETS:
        for x, br in ((xs, C._BLOCK_ROWS), (xs[:40], 3)):
            got = C._cast_2d(x, SEED, dt, True, br)
            torch.cuda.synchronize()
            want = C._cast_2d_plain(x, SEED, dt, True, br)
            if not torch.equal(bits(got), bits(want)):
                fail(f"stochastic cast {dt} block_rows {br}: not bitwise "
                     f"equal to the plain version ("
                     f"{int((bits(got) != bits(want)).sum())} differ)")
            if not torch.equal(C.decompress_cast(got), got.float()):
                fail(f"decompress_cast {dt}: not Tensor.to")
            del got, want
    x0 = 1 + 2.0 ** -12
    one = torch.full((1 << 20,), x0, device="cuda")
    y = C.compress_cast(one, torch.bfloat16, stochastic=True, seed=SEED)
    frac = float((y.float() > 1).double().mean())
    sigma = np.sqrt((1 / 32) * (31 / 32) / one.numel())
    sr["bf16_1+2^-12"] = {"frac_up": frac, "want": 1 / 32, "sigma": sigma,
                          "values": torch.unique(y.float()).tolist()}
    if abs(frac - 1 / 32) > 4 * sigma or \
            sr["bf16_1+2^-12"]["values"] != [1.0, 1.0 + 2.0 ** -7]:
        fail(f"stochastic rounding of 1 + 2^-12 is biased: {sr}")
    del xs, one, y
    torch.cuda.empty_cache()
    edges = check_plugin_edges(R, C, gen)
    emit({"phase": "plugin_kernels_vs_plain", "ok": True,
          "combine_lanes": 2 * len(COMBINE_DTYPES), "bitwise": True,
          "cast_geometries": geometries, "max_abs_err": errs,
          "stochastic": sr, "edges": edges})
    return errs


def check_skew_kernel(FL) -> dict:
    """Phase 3f: flash_fwd_resident_skew at the serving path's per-rank
    shape (FLASH_RESIDENT, causal) in float32 with float32 and bfloat16
    MXU dtypes and in bfloat16: out and lse bitwise equal to
    flash_fwd_resident's, and within FLASH_BOUND of its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    N, Nk, T = FLASH_RESIDENT
    err, readings = 0.0, []
    for dt, mxu in FLASH_DTYPES:
        q = rand((N, T, D_HEAD), dt, gen)
        k, v = rand((Nk, T, D_HEAD), dt, gen), rand((Nk, T, D_HEAD), dt, gen)
        cfg = flash_cfg(FL, N, Nk, T, T, dt, mxu, "resident_skew", True)
        out, lse = FL.flash_fwd_resident_skew(q, k, v, cfg)
        r_out, r_lse = FL.flash_fwd_resident(
            q, k, v, flash_cfg(FL, N, Nk, T, T, dt, mxu, "resident", True))
        torch.cuda.synchronize()
        if not (torch.equal(bits(out), bits(r_out))
                and torch.equal(bits(lse), bits(r_lse))):
            fail(f"flash_fwd_resident_skew {dt}/{mxu}: not bitwise equal to "
                 f"flash_fwd_resident (out {max_err(out, r_out)}, lse "
                 f"{max_err(lse, r_lse)})")
        want, want_lse = FL.flash_fwd_resident_skew_plain(q, k, v, cfg)
        e_out, e_lse = max_err(out, want), max_err(lse, want_lse)
        bound = FLASH_BOUND[mxu]
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        if not finite or e_out > bound or e_lse > bound:
            fail(f"flash_fwd_resident_skew {dt}/{mxu}: off its plain version "
                 f"(out {e_out}, lse {e_lse}, bound {bound})")
        readings.append({"dtype": str(dt), "mxu": str(mxu),
                         "max_abs_err_out": e_out, "max_abs_err_lse": e_lse})
        err = max(err, e_out)
        del q, k, v, out, lse, r_out, r_lse, want, want_lse
    torch.cuda.empty_cache()
    emit({"phase": "flash_skew_vs_resident_and_plain", "ok": True,
          "q": [N, T, D_HEAD], "kv": [Nk, T, D_HEAD], "causal": True,
          "bitwise_vs_flash_fwd_resident": True, "readings": readings})
    return {"flash_fwd_resident_skew": err}


def plugin_path(ring, F, FL, R, C, PL) -> dict:
    """Phase 4f: the plugin lanes as the bench of record and the tuning
    tools run them, in four parts, each with every launch count set to 0
    just before it and read just after: the reduce lane (pallas_add with
    donate on [524288, 128] fp32 over the block_rows ladder, chained,
    beside torch.add in place, 3 x bytes / time); the bf16 compression
    roundtrip on 64 Mi fp32 (nearest even, and stochastic with the seed
    stepped per call) beside the Tensor.to pair, 12 bytes an element; the
    short tune_compress grid (TUNE_COLS x TUNE_BLOCK_ROWS) and its best
    geometry; and the flash schedule sweep's distinct card candidates at
    the shape of record (resident, resident_skew, grid, static_max, bf16
    inputs), each held to the plain version of its kernel before it is
    timed."""
    from accl_tpu_torch.bench import flash_sweep as FS
    from accl_tpu_torch.bench import kernel_tune as KT
    from accl_tpu_torch.bench import timing

    timed_chain, timed_chain_ab = timing.make_harness()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    parts, total = {}, {}

    def part(name, fn):
        reset_counts(ring, F, FL, PL)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts(ring, F, FL, PL)
        for key, val in counts.items():
            total[key] = total.get(key, 0) + val
        parts[name] = {"s": time.perf_counter() - t,
                       "launches": {k: v for k, v in counts.items() if v}}
        return out

    def reduce_lane():
        a = rand((PLUGIN_N // 128, 128), torch.float32, gen)
        b = rand((PLUGIN_N // 128, 128), torch.float32, gen)
        if not torch.equal(R.pallas_add(a, b), a + b):
            fail("the reduce lane's sum is not a + b")
        fns = {f"pallas_add_block_rows{br}": (
            lambda v, w, br=br: R.pallas_add(v, w, block_rows=br,
                                             donate=True))
            for br in COMBINE_LADDER}
        fns["torch.add"] = lambda v, w: torch.add(v, w, out=v)
        best = timed_chain_ab(fns, a, iters=20, trials=3, consts=(b,))
        if not torch.isfinite(a).all():
            fail("the chained reduce lane left non-finite values")
        return {k: {"s": t, "GBps": 3 * PLUGIN_N * 4 / t / 1e9}
                for k, t in best.items()}

    def compression():
        x = rand((PLUGIN_N,), torch.float32, gen)
        bf = torch.bfloat16
        if not torch.equal(C.decompress_cast(C.compress_cast(x, bf)),
                           x.to(bf).float()):
            fail("the compression roundtrip is not the Tensor.to pair")
        seeds = iter(range(1 << 30))
        fns = {"cast_roundtrip": lambda v: C.decompress_cast(
                   C.compress_cast(v, bf)),
               "cast_roundtrip_stochastic": lambda v: C.decompress_cast(
                   C.compress_cast(v, bf, stochastic=True, seed=next(seeds))),
               "Tensor.to": lambda v: v.to(bf).to(torch.float32)}
        best = timed_chain_ab(fns, x, iters=20, trials=3)
        return {k: {"s": t, "GBps": 12 * PLUGIN_N / t / 1e9}
                for k, t in best.items()}

    def sweep_checks(cands, groups):
        """Each distinct card candidate at the sweep shape against the
        plain version of the kernel it runs, within FLASH_BOUND of its
        MXU dtype, before it is timed (outside the counted parts: these
        launches are comparisons)."""
        q, k, v = FS.make_inputs()
        readings = {}
        for rep in groups:
            dt = cands[rep].opts["dtype"]
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            cfg = FS.schedule(cands[rep])
            out = cands[rep](qd, kd, vd)
            plain = getattr(FL, FS.KERNEL_OF[cfg[5]] + "_plain")
            want, _lse = plain(qd, kd, vd, cfg)
            err, bound = max_err(out, want), FLASH_BOUND[cfg[4]]
            if not (torch.isfinite(out).all() and out.shape == q.shape
                    and err <= bound):
                fail(f"flash sweep candidate {rep} ({FS.KERNEL_OF[cfg[5]]}"
                     f"): off its plain version ({err}, bound {bound})")
            readings[rep] = {"kernel": FS.KERNEL_OF[cfg[5]],
                             "max_abs_err": err, "bound": bound}
            del qd, kd, vd, out, want, _lse
        del q, k, v
        return readings

    def sweep(cands, groups):
        best, best_mm, aliases = FS.run_sweep(timed_chain, cands, rounds=2,
                                              iters=16, log=lambda m: None)
        rep = FS.report(best, best_mm, aliases)
        dead = {n: r for n, r in rep["schedules"].items() if "error" in r}
        if dead:
            fail(f"flash sweep candidates failed: {dead}")
        rep["distinct"] = {r: groups[r] for r in groups}
        return rep

    lanes = {"reduce_lane": part("reduce_lane", reduce_lane),
             "compression": part("compression", compression)}
    tune = part("tune_compress", lambda: KT.tune_compress(
        n=PLUGIN_N, cols=TUNE_COLS, block_rows=TUNE_BLOCK_ROWS, rounds=2,
        iters=8, log=lambda m: None))
    cands = FS.build(FS.D128_SPECS)
    groups, _refused = FS.collapse(cands)
    sweep_errs = sweep_checks(cands, groups)
    rep = part("flash_sweep", lambda: sweep(cands, groups))
    rep["vs_plain"] = sweep_errs
    torch.cuda.empty_cache()
    for name, key in (("reduce_lane", "combine_2d"),
                      ("compression", "cast_2d"), ("tune_compress", "cast_2d"),
                      ("flash_sweep", "flash_fwd_resident_skew")):
        if parts[name]["launches"].get(key, 0) < 1:
            fail(f"the plugin path's {name} did not launch {key}: {parts}")
    best = tune["best"]
    emit({"phase": "plugin_path", "ok": True, "n": PLUGIN_N,
          "lanes": lanes, "tune_compress": tune,
          "tuned_geometry": [best["cols"], best["block_rows"]],
          "flash_sweep": rep, "parts": parts, "launches": total})
    return {"launches": total, "parts": parts,
            "tuned": (best["cols"], best["block_rows"])}


def time_plugin_kernels(R, C, FL, errs, plugin, PL) -> list:
    """Phase 5f: the plugin kernels per launch at the bench shapes,
    interleaved with their plain versions (kernel, plain, plain, kernel),
    beside one PyTorch call computing the same function and the byte
    bound: combine_2d (fp32 sum, block_rows 512; 2048 and max beside);
    cast_2d (f32 -> bf16 nearest at [131072, 512], block_rows 1024;
    decompress and stochastic beside); cast2d, the same kernel at the
    tuned geometry of phase 4f; flash_fwd_resident_skew at the serving
    shape, fp32 with the fp32 MXU dtype, beside flash_fwd_resident and
    SDPA."""
    import torch.nn.functional as tnf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    counts0 = {k: fn.launches for k, fn in PL.items()}
    skew0 = FL.flash_fwd_resident_skew.launches
    launches, parts = plugin["launches"], plugin["parts"]

    def interleaved(kernel, plain, iters, plain_iters=None):
        p_it = plain_iters or iters
        ms = [cuda_ms(kernel, iters)]
        p_ms = [cuda_ms(plain, p_it, runs=3), cuda_ms(plain, p_it, runs=3)]
        ms.append(cuda_ms(kernel, iters))
        return statistics.median(ms), statistics.median(p_ms)

    def lane_time(kernel, nbytes, library=None):
        """One more lane of a kernel: ms, GB/s, share of its byte bound,
        beside the PyTorch call computing it where there is one."""
        t = cuda_ms(kernel, 20)
        b = nbytes / HBM_BYTES_PER_S * 1e3
        return {"ms": t, "bound_ms": b, "GBps": nbytes / t / 1e6,
                "share_of_bound": b / t,
                "library_ms": cuda_ms(library, 20) if library else None}

    rows = []
    a = rand((PLUGIN_N // 128, 128), torch.float32, gen)
    b = rand((PLUGIN_N // 128, 128), torch.float32, gen)
    out = torch.empty_like(a)
    ms, p_ms = interleaved(lambda: R._pallas_combine_2d(a, b),
                           lambda: R._combine_2d_plain(a, b, False), 20)
    lib = cuda_ms(lambda: torch.add(a, b, out=out), 20)
    bound = 3 * PLUGIN_N * 4 / HBM_BYTES_PER_S * 1e3
    extra = {"at_block_rows2048_ms": cuda_ms(
                 lambda: R._pallas_combine_2d(a, b, block_rows=2048), 20),
             "max": {"ms": cuda_ms(lambda: R._pallas_combine_2d(a, b, True),
                                   20),
                     "library_ms": cuda_ms(
                         lambda: torch.maximum(a, b, out=out), 20)}}
    ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16)
    oh = torch.empty_like(ah)
    extra["bf16_sum"] = lane_time(
        lambda: R._pallas_combine_2d(ah, bh), 3 * PLUGIN_N * 2,
        lambda: torch.add(ah, bh, out=oh))
    del ah, bh, oh
    rows.append({"name": "combine_2d", "route": "cuda",
                 "share_of_bound": bound / ms,
                 "source": "accl_tpu_torch/ops/csrc/reduce_ops.cu",
                 "kernel": "accl_combine",
                 "replaces": "accl_tpu/ops/reduce_ops.py:39",
                 "launches": launches["combine_2d"],
                 "max_abs_err": errs["combine_2d"], "ms": ms,
                 "plain_ms": p_ms, "bound_ms": bound, "bound_by": "bytes",
                 "library_ms": lib, "library_call": "torch.add(a, b, out=)",
                 "checked": True, "shape": "[524288, 128] fp32 sum, "
                                           "block_rows 512",
                 "GBps": 3 * PLUGIN_N * 4 / ms / 1e6,
                 "launches_per_pallas_add": 1, **extra})
    del a, b, out
    x = rand((PLUGIN_N // 512, 512), torch.float32, gen)
    h = x.to(torch.bfloat16)
    bf, f32 = torch.bfloat16, torch.float32
    bound = 6 * PLUGIN_N / HBM_BYTES_PER_S * 1e3  # 4 + 2 bytes an element
    ms, p_ms = interleaved(lambda: C._cast_2d(x, 0, bf, False),
                           lambda: C._cast_2d_plain(x, 0, bf, False, 1024), 20)
    lib = cuda_ms(lambda: x.to(bf), 20)
    d_ms, d_p = interleaved(lambda: C._cast_2d(h, 0, f32, False),
                            lambda: C._cast_2d_plain(h, 0, f32, False, 1024),
                            20)
    d_lib = cuda_ms(lambda: h.to(f32), 20)
    s_ms, s_p = interleaved(lambda: C._cast_2d(x, 7, bf, True),
                            lambda: C._cast_2d_plain(x, 7, bf, True, 1024),
                            20, plain_iters=2)
    fp8 = {}
    for dt in (torch.float8_e5m2, torch.float8_e4m3fn):
        name = str(dt).replace("torch.float8_", "")
        fp8[f"stochastic_{name}"] = lane_time(
            lambda dt=dt: C._cast_2d(x, 7, dt, True), 5 * PLUGIN_N)
        q = x.to(dt)
        fp8[f"widen_{name}"] = lane_time(
            lambda q=q: C._cast_2d(q, 0, f32, False), 5 * PLUGIN_N,
            lambda q=q: q.to(f32))
        del q
    rows.append({"name": "cast_2d", "route": "cuda",
                 "source": "accl_tpu_torch/ops/csrc/compression.cu",
                 "kernel": "accl_cast",
                 "replaces": "accl_tpu/ops/compression.py:54",
                 "launches": parts["compression"]["launches"]["cast_2d"],
                 "max_abs_err": errs["cast_2d"], "ms": ms, "plain_ms": p_ms,
                 "bound_ms": bound, "bound_by": "bytes", "library_ms": lib,
                 "library_call": "Tensor.to(torch.bfloat16)", "checked": True,
                 "shape": "[131072, 512] fp32 -> bf16 nearest, block_rows "
                          "1024",
                 "GBps": 6 * PLUGIN_N / ms / 1e6,
                 "share_of_bound": bound / ms,
                 "launches_per_roundtrip": 2,
                 "decompress": {"ms": d_ms, "plain_ms": d_p,
                                "library_ms": d_lib, "bound_ms": bound,
                                "share_of_bound": bound / d_ms,
                                "shape": "[131072, 512] bf16 -> fp32"},
                 "stochastic": {"ms": s_ms, "plain_ms": s_p,
                                "library_ms": None, "bound_ms": bound,
                                "share_of_bound": bound / s_ms,
                                "shape": "[131072, 512] fp32 -> bf16 "
                                         "stochastic"},
                 **fp8})
    cols, br = plugin["tuned"]
    xv, hv = x.view(-1, cols), h.view(-1, cols)
    t_ms, t_p = interleaved(lambda: C._cast_2d(xv, 0, bf, False, br),
                            lambda: C._cast_2d_plain(xv, 0, bf, False, br),
                            20)
    t_lib = cuda_ms(lambda: xv.to(bf), 20)
    t_d = cuda_ms(lambda: C._cast_2d(hv, 0, f32, False, br), 20)
    rows.append({"name": "cast2d", "route": "cuda",
                 "source": "accl_tpu_torch/ops/csrc/compression.cu",
                 "kernel": "accl_cast (tuned geometry)",
                 "replaces": "scripts/kernel_tune.py:96",
                 "launches": parts["tune_compress"]["launches"]["cast_2d"],
                 "max_abs_err": errs["cast2d"], "ms": t_ms, "plain_ms": t_p,
                 "bound_ms": bound, "bound_by": "bytes", "library_ms": t_lib,
                 "library_call": "Tensor.to(torch.bfloat16)", "checked": True,
                 "shape": f"[{PLUGIN_N // cols}, {cols}] fp32 -> bf16 "
                          f"nearest, block_rows {br}",
                 "geometry": [cols, br], "decompress_ms": t_d,
                 "launches_per_roundtrip": 2})
    del x, h, xv, hv
    torch.cuda.empty_cache()
    N, Nk, T = FLASH_RESIDENT
    dt = torch.float32
    q = rand((N, T, D_HEAD), dt, gen)
    k, v = rand((Nk, T, D_HEAD), dt, gen), rand((Nk, T, D_HEAD), dt, gen)
    cfg = flash_cfg(FL, N, Nk, T, T, dt, dt, "resident_skew", True)
    r_cfg = flash_cfg(FL, N, Nk, T, T, dt, dt, "resident", True)
    ms, p_ms = interleaved(
        lambda: FL.flash_fwd_resident_skew(q, k, v, cfg),
        lambda: FL.flash_fwd_resident_skew_plain(q, k, v, cfg), 5,
        plain_iters=1)
    res_ms = cuda_ms(lambda: FL.flash_fwd_resident(q, k, v, r_cfg), 5,
                     runs=3)
    qs = q.view(Nk, N // Nk, T, D_HEAD)
    ks, vs = k.view(Nk, 1, T, D_HEAD), v.view(Nk, 1, T, D_HEAD)
    lib = cuda_ms(lambda: tnf.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), 5, runs=3)
    bound, by, ops = attention_bound(N, T, T, True, dt)
    rows.append({"name": "flash_fwd_resident_skew", "route": "cuda",
                 "source": "accl_tpu_torch/ops/csrc/flash.cu",
                 "kernel": "flash_fwd_resident_skew",
                 "replaces": "accl_tpu/ops/flash.py:403",
                 "launches": launches["flash_fwd_resident_skew"],
                 "max_abs_err": errs["flash_fwd_resident_skew"], "ms": ms,
                 "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                 "library_ms": lib,
                 "library_call": "scaled_dot_product_attention(is_causal, "
                                 "enable_gqa)", "checked": True,
                 "shape": f"q [{N},{T},{D_HEAD}] k/v [{Nk},{T},{D_HEAD}] "
                          f"causal {dt} mxu {dt}",
                 "flash_fwd_resident_ms": res_ms,
                 "tflops": ops / (ms * 1e-3) / 1e12,
                 "launches_per_forward": 1})
    del q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    for row in rows:
        emit({"phase": "kernel_time", **row})
    for key, n in counts0.items():  # the timing launches are not main-path
        PL[key].launches = n
    FL.flash_fwd_resident_skew.launches = skew0
    return rows


# ---------------------------------------------------------------------------
# phases 6-9: observability on the driver, the ring's device-trace stamp
# mode, the sweep and the call rate
# ---------------------------------------------------------------------------
#: MiB per rank of the observed-path and device-trace phases
OBS_MIB = (4, 256)
#: a span's stages in order; the split of a call is the time between
#: consecutive ones
SPAN_STAGES = ("submit", "queue", "gang_ready", "dispatch", "device_begin",
               "device_end", "complete")
#: the sweep's widths: (collectives, count exponents).  allreduce and
#: bcast to 2^26 elements (256 MiB per rank), reduce_scatter to 2^23 (its
#: per-rank payload, count x P, is then 256 MiB), the collectives whose
#: result grows by P to 2^24, the rest to 2^22; one untimed warm-up and
#: one timed call a size, and two sizes a collective (the smallest and
#: the widest), so the warm widest rows fit the phase's time
SWEEP_WIDTHS = ((("allreduce", "bcast"), (10, 26)),
                (("reduce_scatter",), (10, 23)),
                (("allgather", "gather", "alltoall"), (10, 24)),
                (("sendrecv", "scatter", "reduce"), (10, 22)))
#: call-rate counts: below ACCL_RING_THRESHOLD, and the 4 MiB ring lane
CALLRATE_COUNTS = (1024, 1 << 20)


def observed_path(world, mp) -> dict:
    """Phase 6: the driver's resident allreduce with the observability
    defaults on (flight recorder and metrics) and off (as under
    ACCL_METRICS=0 ACCL_FLIGHT=0: no recorder, no metrics), timed by
    bench/driver_split.py's ``measure`` in alternating rounds; the spans'
    split of a 4 MiB call; the registry's counts against the calls made;
    one flight dump read back by merge_flight_dumps."""
    import tempfile

    from accl_tpu_torch.bench import driver_split as DS
    from accl_tpu_torch.observability import flight as OF
    from accl_tpu_torch.observability import metrics as OM
    from accl_tpu_torch.observability import trace as OT

    if any(a.flight_recorder is None for a in world.accls) \
            or not OM.enabled():
        fail("observed_path: the observability defaults are not on")
    out = {}
    ds = DS.measure("observed_path", rounds=10, world=world,
                    counts=tuple(mib * MIB // 4 for mib in OBS_MIB))
    for mib in OBS_MIB:
        on, off = (next(r for r in ds if r["mib_per_rank"] == mib
                        and r["lane"] == lane)
                   for lane in ("defaults", "observability_off"))
        row = {"phase": "observed_path", "mib_per_rank": mib, "ranks": P,
               "iters": on["iters"],
               "s_per_call_defaults_on": on["us_per_call"] / 1e6,
               "s_per_call_defaults_off": off["us_per_call"] / 1e6,
               "samples_on_us": on["rounds_us"],
               "samples_off_us": off["rounds_us"],
               "on_minus_off_us": on["us_per_call"] - off["us_per_call"]}
        emit(row)
        out[mib] = row
    if any(a.flight_recorder is None for a in world.accls) \
            or not (OM.enabled() and OF.enabled()):
        fail("observed_path: the defaults were not restored")
    # the spans' split and the registry, at 4 MiB per rank
    mib, calls = OBS_MIB[0], 40
    call = mp["per_size"][mib][2]
    reg = OM.default_registry()
    world.run(call)
    torch.cuda.synchronize()
    reg.reset()
    col = OT.enable()
    col.clear()
    try:
        for _ in range(calls):
            world.run(call)
        torch.cuda.synchronize()
        spans = [sp for sp in col.spans() if sp.name == "allreduce"]
    finally:
        OT.disable()
        col.clear()
    if len(spans) != calls * P:
        fail(f"observed_path: {len(spans)} spans for {calls * P} calls")
    split = {}
    for a, b in zip(SPAN_STAGES, SPAN_STAGES[1:]):
        d = [getattr(sp, "t_" + b) - getattr(sp, "t_" + a) for sp in spans]
        if min(d) < 0:
            fail(f"observed_path: span stage {b} before {a}")
        split[f"{a}->{b}"] = statistics.mean(d) / 1e3
    lanes = {}
    for sp in spans:
        lanes[sp.lane] = lanes.get(sp.lane, 0) + 1
    snap = reg.snapshot()
    rows = [c for c in snap["calls"].values()
            if c["collective"] == "allreduce"]
    want_bytes = calls * P * mp["per_size"][mib][0][0].length * 4
    if len(rows) != 1 or rows[0]["calls"] != calls * P \
            or rows[0]["bytes"] != want_bytes or rows[0]["errors"]:
        fail(f"observed_path: the registry's allreduce rows {rows} do not "
             f"count {calls * P} calls of {want_bytes} bytes")
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for a in world.accls:
            paths.append(os.path.join(d, f"flight{a.rank}.json"))
            a.dump_flight_recorder(path=paths[-1])
        merged = OF.merge_flight_dumps(paths)
    if merged["nranks"] != P or not merged["analysis"]["ok"]:
        fail(f"observed_path: merge_flight_dumps read back "
             f"{merged['nranks']} ranks, analysis {merged['analysis']}")
    row = {"phase": "observed_path_spans", "mib_per_rank": mib, "ranks": P,
           "calls": calls, "mean_us_per_stage": split,
           "submit_to_complete_us": sum(split.values()), "lanes": lanes,
           "registry": {k: rows[0][k] for k in ("calls", "bytes", "errors",
                                                "size_bucket")},
           "registry_latency_us": rows[0]["latency_us"],
           "flight_dump": {"nranks": merged["nranks"],
                           "records": sum(len(r["records"])
                                          for r in merged["ranks"]),
                           "analysis_ok": merged["analysis"]["ok"]}}
    emit(row)
    out["spans"] = row
    return out


def _records(col):
    counts = {}
    for r in col.device_records():
        key = (r["collective"], tuple(map(tuple, r["rows"])))
        counts[key] = counts.get(key, 0) + 1
    return counts


def device_trace(world, mp, ring) -> dict:
    """Phase 7: ACCL_DEVICE_TRACE.  The driver's allreduce at 4 and 256
    MiB per rank with the gate on: the stamp rows the kernels wrote, as
    the engine lands them, against the rows the plain composition records
    (bitwise, as multisets of per-(segment, rank) records), the results
    bitwise equal to the gate-off results; every stamp launch counted.
    Then the device ms of the segmented allreduce's two launches with
    the gate off and on (the stamp rows left on the card unlanded, so
    the window holds the kernels alone), and both instantiations'
    registers."""
    from accl_tpu_torch.observability import trace as OT

    col = OT.collector()

    def gate(on):
        ring._DEVICE_TRACE = on
        col.clear()

    launches = {"ring_reduce_scatter": 0, "ring_all_gather": 0}
    try:
        for mib in OBS_MIB:
            sends, recvs, call, _ = mp["per_size"][mib]
            gate(False)
            world.run(call)
            torch.cuda.synchronize()
            off = [r.dev.clone() for r in recvs]
            gate(True)
            ring.ring_all_reduce_segmented([b.dev for b in sends], "sum",
                                           plain=True)
            plain = _records(col)
            col.clear()
            ring.ring_reduce_scatter.launches_stamp = 0
            ring.ring_all_gather.launches_stamp = 0
            world.run(call)
            torch.cuda.synchronize()
            got = _records(col)
            n = {"ring_reduce_scatter": ring.ring_reduce_scatter
                 .launches_stamp, "ring_all_gather": ring.ring_all_gather
                 .launches_stamp}
            for k in launches:
                launches[k] += n[k]
            if got != plain:
                fail(f"device_trace {mib} MiB: the kernels' stamp rows "
                     f"({sum(got.values())} records) differ from the plain "
                     f"version's ({sum(plain.values())})")
            for r in range(P):
                if not same_bits(recvs[r].dev, off[r]):
                    fail(f"device_trace {mib} MiB rank {r}: the result with "
                         f"the gate on is not bitwise the gate-off result")
            emit({"phase": "device_trace", "mib_per_rank": mib, "ranks": P,
                  "records": sum(got.values()),
                  "rows": sum(len(k[1]) * v for k, v in got.items()),
                  "stamp_launches": n, "rows_equal_plain": True,
                  "bitwise_equal_gate_off": True})
            del off
        if min(launches.values()) < 1:
            fail(f"device_trace: a stamp instantiation never launched "
                 f"{launches}")
        # device ms of both instantiations
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        times = {}
        for mib in OBS_MIB:
            count = mib * MIB // 4
            xs = [rand((count,), torch.float32, gen) for _ in range(P)]
            outs = [torch.empty_like(x) for x in xs]
            parts = ring.allreduce_parts(count, P, ring.DEFAULT_SEG_ELEMS)

            def ar_call():
                # the segmented allreduce's two launches, the stamp rows
                # left on the card, so the stream is never synchronized
                ring._launch("rs", xs, outs, parts, None, "sum", land=False)
                ring._launch("ag", outs, outs, parts, None, land=False)

            t = {}
            for on in (False, True, True, False):
                gate(on)
                t.setdefault(on, []).append(split_ms(ar_call, 3, 3))
            times[mib] = {("stamp" if on else "plain_kernel"): {
                "device_ms": [v["device_ms"] for v in vs],
                "host_enqueue_ms": [v["host_enqueue_ms"] for v in vs]}
                for on, vs in t.items()}
            del xs, outs
            torch.cuda.empty_cache()
    finally:
        gate(False)
    info = {f"kind{k}_{'stamp' if st else 'off'}":
            ring.kernel_info(k, torch.float32, st)
            for k in (0, 1, 2) for st in (False, True)}
    emit({"phase": "device_trace_time", "ranks": P,
          "allreduce_kernels_ms": times, "kernel_info": info})
    return {"launches": launches, "times": times, "info": info}


def time_stamp_kernels(ring, launches, info) -> list:
    """Phase 7's rows of the kernels line: each stamp instantiation at the
    main path's one-segment shape (P=8 x [8, 32768] fp32).  First one
    call of the public wrapper with the gate on: its results against the
    plain version's (max abs err, which must be 0) and its landed rows
    against ``stamp_rows``, bitwise.  Then CUDA events: ``ms`` the
    instantiation per launch, its rows left on the card; ``landed_ms``
    the wrapper per call, with its synchronize and the rows' landing;
    beside its plain version (the plain kernel composition and the stamp
    rows computed from the schedule) and the unstamped rows' library
    yardstick; bound = its bytes (the unstamped kernel's and its rows')
    over 3.35 TB/s."""
    from accl_tpu_torch.observability import trace as OT

    col = OT.collector()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    n = ring.DEFAULT_SEG_ELEMS // P
    xs = [rand((P, n), torch.float32, gen) for _ in range(P)]
    outs = [torch.empty(n, device="cuda") for _ in range(P)]
    stacked = torch.stack(xs)
    ag_in = [rand((n,), torch.float32, gen) for _ in range(P)]
    ag_out = [torch.empty(P, n, device="cuda") for _ in range(P)]
    # the wrappers' one part over the whole [P, n] (rows n apart)
    rs_part = [ring.Part(1, n, 0, 0, n, 0, 0, 0)]
    ag_part = [ring.Part(1, n, 0, 0, 0, 0, 0, n)]
    counts0 = (ring.ring_reduce_scatter.launches,
               ring.ring_all_gather.launches,
               ring.ring_reduce_scatter.launches_stamp,
               ring.ring_all_gather.launches_stamp)
    rows = []
    ring._DEVICE_TRACE = True
    try:
        for name, call, launch, plain, got_of, lib, lib_call, kind in (
                ("ring_reduce_scatter",
                 lambda: ring.ring_reduce_scatter(xs, out=outs),
                 lambda: ring._launch("rs", xs, outs, rs_part, None,
                                      land=False),
                 lambda: ring.ring_reduce_scatter_plain(xs),
                 lambda: outs,
                 lambda: torch.sum(stacked, dim=0),
                 "torch.sum(stack, dim=0): every rank's chunk", 0),
                ("ring_all_gather",
                 lambda: ring.ring_all_gather(ag_in, out=ag_out),
                 lambda: ring._launch("ag", ag_in, ag_out, ag_part, None,
                                      land=False),
                 lambda: ring.ring_all_gather_plain(ag_in),
                 lambda: ag_out,
                 lambda: [torch.cat(ag_in, out=ag_out[r].view(-1))
                          for r in range(P)],
                 f"torch.cat(blocks, out=gather[r]) for each of the {P} "
                 f"ranks", 2)):
            col.clear()
            call()
            got = _records(col)
            coll = "reduce_scatter" if kind == 0 else "all_gather"
            want = {(coll, tuple(map(tuple, rr.tolist()))): 1
                    for rr in ring.stamp_rows(P, n * 4)}
            if got != want:
                fail(f"{name} stamp rows at one segment differ from "
                     f"stamp_rows")
            ref = plain()
            err = max(max_err(g, w) for g, w in zip(got_of(), ref))
            if err != 0.0 or not all(same_bits(g, w)
                                     for g, w in zip(got_of(), ref)):
                fail(f"{name} stamp instantiation: not bitwise its plain "
                     f"version (max abs err {err})")
            del ref
            col.clear()
            ms = [cuda_ms(launch, 50)]
            pl = [cuda_ms(lambda: (plain(), ring.stamp_rows(P, n * 4)), 20)]
            landed = [cuda_ms(call, 50)]
            pl.append(cuda_ms(lambda: (plain(), ring.stamp_rows(P, n * 4)),
                              20))
            landed.append(cuda_ms(call, 50))
            ms.append(cuda_ms(launch, 50))
            col.clear()
            # operands read once, results and stamp rows written once
            nbytes = (P * P * n + P * n) * 4 + P * (P - 1) * 9 * 4
            rows.append({
                "name": f"{name}_stamp", "route": "cuda",
                "source": "accl_tpu_torch/ops/csrc/ring.cu",
                "replaces": ("accl_tpu/ops/ring.py:274" if kind == 0
                             else "accl_tpu/ops/ring.py:151"),
                "launches": launches[name], "max_abs_err": err,
                "ms": statistics.median(ms),
                "landed_ms": statistics.median(landed),
                "plain_ms": statistics.median(pl),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": cuda_ms(lib, 50),
                "library_call": lib_call, "checked": True,
                "shape": f"P={P} x [{P},{n}] fp32 per launch, "
                         f"ACCL_DEVICE_TRACE rows",
                "kernel_info": {"stamp": info[f"kind{kind}_stamp"],
                                "off": info[f"kind{kind}_off"]}})
    finally:
        ring._DEVICE_TRACE = False
        col.clear()
    (ring.ring_reduce_scatter.launches, ring.ring_all_gather.launches,
     ring.ring_reduce_scatter.launches_stamp,
     ring.ring_all_gather.launches_stamp) = counts0
    for row in rows:
        emit({"phase": "kernel_time", **row})
    return rows


#: the observatory's two tenants, each a communicator over the 8 ranks:
#: (elements per rank, calls in the clean window).  "train" is a dp
#: gradient bucket, a fp32 SUM allreduce of 64 MiB per rank on the ring
#: lane; "serve" the TP allreduce of a decode step at 4 requests x
#: Llama-3-8B's hidden 4096 (16,384 fp32, 64 KiB), below the threshold
OBS_TENANTS = {"train": (64 * MIB // 4, 6), "serve": (4 * 4096, 40)}
#: serve calls before the clean window (out of its histograms)
OBS_WARM_CALLS = 160
#: the straggler: rank 2 sleeps at least 5 ms before each of 40 more
#: serve calls (longer where a bucket bound below the serve ceiling is:
#: ``_late_sleep_s``)
OBS_LATE_RANK, OBS_LATE_S, OBS_LATE_CALLS = 2, 0.005, 40
#: SLO sweeps over the straggled calls (fast window: the tracker's 4)
OBS_SLO_SWEEPS = 4
#: the serve and train p99 ceilings: this many times the clean window's
OBS_P99_X = 3.0
#: the sampler's period
OBS_SAMPLE_S = 0.1
#: µs-per-call arms: (elements per rank, calls per rank a round)
OBS_OVERHEAD = ((1 << 20, 50), (1024, 200))
OBS_OVERHEAD_ROUNDS = 8
#: the fused-overlap sweep's extra size and the matmul chain's probe
OBS_SWEEP_POW = 24
OBS_MM_PROBE = 4096
#: the observability knobs this phase sets, restored at its end
OBS_ENV = ("ACCL_SLO", "ACCL_SLO_INTERVAL_MS", "ACCL_SENTINEL",
           "ACCL_SENTINEL_INTERVAL_MS", "ACCL_METRICS_PORT")


def _ring_counts(ring) -> dict:
    rs, ag = ring.ring_reduce_scatter, ring.ring_all_gather
    return {"ring_reduce_scatter": rs.launches - rs.launches_stamp,
            "ring_all_gather": ag.launches - ag.launches_stamp,
            "ring_reduce_scatter_stamp": rs.launches_stamp,
            "ring_all_gather_stamp": ag.launches_stamp}


def _p99(snap, tenant, OM, OS) -> float:
    """The p99 µs of a tenant's calls in a registry snapshot (the
    histogram estimate the sentinel and the SLO tracker read)."""
    (doc,) = [c for c in snap["tenant_calls"].values()
              if c["tenant"] == tenant]
    hist = [doc["hist_us"][f"le_{ub}"] for ub in OM.LATENCY_BUCKETS_US]
    hist.append(doc["hist_us"]["inf"])
    return OS.quantile_us(hist, 0.99)


def _late_sleep_s(ceiling_us: float, OM) -> float:
    """The straggler's sleep: at least OBS_LATE_S, and at least the
    largest latency bucket bound at or below the serve ceiling.  The
    tracker counts a call bad when its bucket's upper bound exceeds the
    ceiling; a waiting rank's call that lasts past that bound lands in the
    next bucket, whose bound does, however long the clean window's tail
    made the ceiling (a clean p99 above 16384 / 3 µs puts a 5 ms straggle
    in a bucket counted good)."""
    bounds = [ub for ub in OM.LATENCY_BUCKETS_US if ub <= ceiling_us]
    return max(OBS_LATE_S, bounds[-1] * 1e-6 if bounds else 0.0)


def observatory(world, ring, F) -> dict:
    """Phase 7b: the rest of observability on the main path's 8-rank
    world (telemetry, sentinel, SLO tracker, attribution, tenants), in
    five steps, each fatal:
    1. two tenant communicators, "train" (64 MiB per rank, ring lane, x6)
       and "serve" (64 KiB, x40), every result bitwise its plain fold and
       within rtol 1e-5 of float64;
    2. a TelemetrySampler at 100 ms on the world's sources over the
       train traffic (serve's clean window follows 160 warm-up calls);
       the train slice of ``link_matrix`` holds exactly the ring's bytes
       (rank r to r + 1: 2 (P - 1) / P x 64 MiB x 6), the two slices sum
       to the matrix over both tenants' communicators, and the sampler
       publishes engine/* and link/* families;
    3. Baseline.from_snapshot of the clean window, an SLO spec with
       serve and train p99 ceilings of 3 x their clean p99 (the
       tracker counts a call bad when its histogram bucket's upper
       bound is above the ceiling), the sentinel and tracker armed from the
       environment; rank 2 then sleeps before each of 40 serve calls
       (5 ms, or the largest bucket bound at or below the serve
       ceiling where that is longer): serve reaches fast_burn or exhausted while train stays ok,
       the sentinel finds drift and accl_health reads slow (once the
       degraded minute an earlier phase's failed calls leave has
       lapsed: slow never masks a stronger verdict), /slo on an
       exporter at ACCL_METRICS_PORT=0 reports both tenants, attribute
       over the straggled window's flight records names rank 2 with share
       > 0.9 and phase coverage in 0.95-1.05, and slowest_link of the
       serve slice's seek_wait_ns points at rank 2;
    4. under ACCL_TRACE and ACCL_DEVICE_TRACE the 64 MiB train allreduce
       sequential (ring kernels' stamp rows) and fused=True (the chunked
       lane's overlapped host rows), each bitwise its plain version:
       device_overlap's exposed fraction >= 0.95 sequential, lower fused;
       then (the device-trace gate off) run_fused_overlap_sweep at its
       defaults and at 2^24 elements (one timed repetition) with a
       matmul chain sized to take about as long as that allreduce;
    5. µs per driver call at 4 MiB and 1024 elements in alternating
       rounds: sampler, sentinel and SLO threads (100 ms) and a tenant
       communicator (arm on) against none of them and comm 0 (arm off).
    Its ring launches are counted from 0 at its start; everything it
    started is stopped, and the knobs restored, at its end."""
    import gc
    import tempfile
    import urllib.request

    from accl_tpu_torch import ReduceFunction
    from accl_tpu_torch.bench import sweep as SW
    from accl_tpu_torch.observability import attribution as OA
    from accl_tpu_torch.observability import health as OH
    from accl_tpu_torch.observability import metrics as OM
    from accl_tpu_torch.observability import sentinel as OS
    from accl_tpu_torch.observability import slo as OSLO
    from accl_tpu_torch.observability import telemetry as OTL
    from accl_tpu_torch.observability import trace as OT

    t_phase = time.perf_counter()
    dev = world.engine.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # closed worlds' recorders must not join this world's flight marks
    gc.collect()
    env0 = {k: os.environ.get(k) for k in OBS_ENV}
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather):
        fn.launches = fn.launches_stamp = 0
    reg = OM.default_registry()
    reg.reset()
    col = OT.collector()
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    out = {}
    sampler = None
    tmp = tempfile.TemporaryDirectory()
    try:
        # -- 1. two tenants -----------------------------------------------
        ids_all = world.run(lambda a, r: tuple(
            a.create_communicator(list(range(P)), tenant=t)
            for t in OBS_TENANTS))
        if len(set(ids_all)) != 1:
            fail(f"observatory: tenant ids differ across ranks {ids_all}")
        ids = dict(zip(OBS_TENANTS, ids_all[0]))
        bufs = {}
        for t, (count, _calls) in OBS_TENANTS.items():
            sends = [world.accls[r].create_buffer(count, np.float32)
                     for r in range(P)]
            recvs = [world.accls[r].create_buffer(count, np.float32)
                     for r in range(P)]
            for b in sends:
                b.dev.copy_(torch.randn(count, generator=gen, device=dev))
            bufs[t] = (sends, recvs)

        def traffic(tenant, calls, late=0.0, fused=False):
            sends, recvs = bufs[tenant]
            count, cid = OBS_TENANTS[tenant][0], ids[tenant]

            def body(accl, rank):
                for _ in range(calls):
                    if late and rank == OBS_LATE_RANK:
                        time.sleep(late)
                    accl.allreduce(sends[rank], recvs[rank], count,
                                   ReduceFunction.SUM, comm_id=cid,
                                   from_fpga=True, to_fpga=True,
                                   fused=fused)

            world.run(body)
            sync()

        def hold(tenant, fused=False):
            """Each rank's result bitwise its plain fold (the ring's
            composition on the ring lane, the chunked lane's fold on the
            fused lane, the engine's stacked sum below the threshold) and
            within rtol 1e-5 of the float64 sum."""
            sends, recvs = bufs[tenant]
            xs = [b.dev for b in sends]
            if fused:
                want = F.chunked_ring_all_reduce(xs, "sum")
            elif OBS_TENANTS[tenant][0] * 4 >= world.engine \
                    .ring_threshold_bytes:
                want = ring.ring_all_reduce_segmented(xs, "sum", plain=True)
            else:
                want = [torch.stack(xs).sum(0)] * P
            ref = torch.stack([x.double() for x in xs]).sum(0)
            for r in range(P):
                got = recvs[r].dev
                if not same_bits(got, want[r]):
                    fail(f"observatory {tenant} rank {r}"
                         f"{' fused' if fused else ''}: not bitwise the "
                         f"plain fold (max abs err "
                         f"{max_err(got, want[r])})")
                if not torch.allclose(got.double(), ref, rtol=1e-5,
                                      atol=1e-5):
                    fail(f"observatory {tenant} rank {r}: off the float64 "
                         f"sum")
            del want, ref

        # -- 2. telemetry, over the clean window ---------------------------
        def new_sampler():
            return OTL.TelemetrySampler(
                [world.devices[0].engine_stats], registry=reg,
                interval_s=OBS_SAMPLE_S, name="observatory",
                link_sources=[(r, d.link_stats)
                              for r, d in enumerate(world.devices)]).start()

        # serve's first windows on its fresh communicator have the long
        # tail of a cold path, and a sampler poll holds the interpreter
        # while it folds the link rows: the warm-up runs before the clean
        # window, out of the histograms the baseline and the SLO ceilings
        # are read from, and the sampler watches the train traffic only,
        # so the serve windows, clean and straggled, run alike
        traffic("serve", OBS_WARM_CALLS)
        reg.reset()
        sampler = new_sampler()
        t0 = time.perf_counter()
        traffic("train", OBS_TENANTS["train"][1])
        clean_s = {"train": time.perf_counter() - t0}
        sampler.stop()
        sampler.sample()  # the window's last poll, on this thread
        hold("train")
        # a full collection of the long-lived heap stalls every rank at
        # once, 8 of the window's observations: each serve window starts
        # from a fresh collection, so none falls inside it
        gc.collect()
        t0 = time.perf_counter()
        traffic("serve", OBS_TENANTS["serve"][1])
        clean_s["serve"] = time.perf_counter() - t0
        hold("serve")
        counters = reg.counters()
        gauges = reg.snapshot()["gauges"]
        if sampler.samples < 2 or not any(k.startswith("link/tx_bytes/r")
                                          for k in counters) \
                or "engine/link_rows" not in gauges \
                or "engine/leader_dispatches" not in counters:
            fail(f"observatory: the sampler ({sampler.samples} samples) "
                 f"did not publish engine/* and link/* families: "
                 f"{sorted(counters)[:8]} {sorted(gauges)[:8]}")
        if sampler.last_link_matrix != world.link_matrix():
            fail("observatory: the sampler's last matrix is not the "
                 "world's comm-0 matrix")
        count, calls = OBS_TENANTS["train"]
        per_link = calls * (count * 4 * 2 * (P - 1) // P)
        tx = world.link_matrix(tenant="train")["fields"]["tx_bytes"]
        want_tx = [[per_link if d == (s + 1) % P else 0 for d in range(P)]
                   for s in range(P)]
        if tx != want_tx:
            fail(f"observatory: the train slice's tx_bytes {tx} are not "
                 f"the ring's {per_link} bytes to the right neighbour")
        emit({"phase": "observatory_tenants", "ranks": P,
              "tenants": {t: {"comm": ids[t], "elements": c, "calls": k}
                          for t, (c, k) in OBS_TENANTS.items()},
              "clean_window_s": clean_s, "bitwise": True,
              "train_tx_bytes_per_link": per_link,
              "sampler_samples": sampler.samples,
              "engine_families": sorted(k for k in {**counters, **gauges}
                                        if k.startswith("engine/")),
              "link_families": len([k for k in counters
                                    if k.startswith("link/")])})
        sampler = None

        # -- 3. baseline, then a straggler ---------------------------------
        snap = reg.snapshot()
        base = OS.Baseline.from_snapshot(snap)
        p99 = {t: _p99(snap, t, OM, OS) for t in OBS_TENANTS}
        spec_path = os.path.join(tmp.name, "slo.json")
        with open(spec_path, "w") as f:
            json.dump({"format": OSLO.SLO_SPEC_FORMAT,
                       "version": OSLO.SLO_SPEC_VERSION,
                       "slos": [{"tenant": t, "collective": "allreduce",
                                 "p99_us": OBS_P99_X * p99[t]}
                                for t in OBS_TENANTS]}, f)
        os.environ.update({
            "ACCL_SLO": spec_path, "ACCL_SLO_INTERVAL_MS": "0",
            "ACCL_SENTINEL": base.save(os.path.join(tmp.name, "base.json")),
            "ACCL_SENTINEL_INTERVAL_MS": "60000", "ACCL_METRICS_PORT": "0"})
        sen = OS.ensure_sentinel_from_env()
        tracker = OSLO.ensure_slo_from_env()
        if sen is None or tracker is None:
            fail("observatory: ACCL_SENTINEL / ACCL_SLO armed nothing")
        tracker.check()  # the clean window: one sweep
        clean = {o["tenant"]: o["verdict"] for o in tracker.objectives}
        if sen.check():
            fail(f"observatory: the sentinel finds drift in its own "
                 f"baseline window {sen.findings}")
        mine = [a.flight_recorder for a in world.accls]
        marks = {k: v for k, v in SW._flight_marks().items()
                 if v[0] in mine}
        late_sleep_s = _late_sleep_s(OBS_P99_X * p99["serve"], OM)
        gc.collect()
        t0 = time.perf_counter()
        for _ in range(OBS_SLO_SWEEPS):
            traffic("serve", OBS_LATE_CALLS // OBS_SLO_SWEEPS,
                    late=late_sleep_s)
            tracker.check()
        late_s = time.perf_counter() - t0
        hold("serve")
        verdicts = {o["tenant"]: o for o in tracker.objectives}
        # slow never masks a stronger verdict, and an earlier phase's
        # failed calls (plan_path's sanitizer drill) hold the world at
        # degraded for DEGRADED_WINDOW_NS after the last of them: the
        # health read waits for that window to lapse, and the watchdog
        # rescans before the sentinel's check publishes its verdict
        last_err = max(a.flight_recorder.last_error_ns for a in world.accls)
        health_wait_s = max(0.0, (last_err + OH.DEGRADED_WINDOW_NS
                                  - OT.now_ns()) / 1e9) if last_err else 0.0
        time.sleep(health_wait_s)
        if world.engine._watchdog is not None:
            world.engine._watchdog.check()
        findings = sen.check()
        health = reg.snapshot()["gauges"].get("accl_health")
        if verdicts["serve"]["verdict"] not in ("fast_burn", "exhausted") \
                or verdicts["train"]["verdict"] != "ok":
            fail(f"observatory: SLO verdicts {verdicts} (serve must burn, "
                 f"train stay ok)")
        if not findings or health != OH.HEALTH_SLOW:
            fail(f"observatory: sentinel findings {findings}, accl_health "
                 f"{health} (want drift and slow)")
        exporter = OH.ensure_exporter_from_env()
        if exporter is None:
            fail("observatory: ACCL_METRICS_PORT=0 started no exporter")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{exporter.port}/slo",
                    timeout=10) as resp:
                slo_doc = json.loads(resp.read())
        finally:
            OH.stop_exporter()
        if set(slo_doc.get("tenants", {})) != set(OBS_TENANTS) \
                or slo_doc["format"] != OSLO.SLO_REPORT_FORMAT:
            fail(f"observatory: /slo answered {slo_doc}")
        report = OA.attribute(SW._dumps_since(marks))
        rows = list(report["collectives"].values())
        dom = rows[0]["dominant_straggler"] if len(rows) == 1 else None
        if dom is None or dom["rank"] != OBS_LATE_RANK \
                or dom["share"] <= 0.9 \
                or rows[0]["episodes"] != OBS_LATE_CALLS \
                or not all(0.95 <= r["phase_coverage"] <= 1.05
                           for r in rows):
            fail(f"observatory: attribution {report['collectives']} does "
                 f"not name rank {OBS_LATE_RANK} (share > 0.9, coverage "
                 f"0.95-1.05)")
        m = world.link_matrix(tenant="serve")
        slow = OTL.slowest_link(m, "seek_wait_ns")
        if slow is None or slow[1] != OBS_LATE_RANK:
            fail(f"observatory: slowest serve link {slow}, not toward rank "
                 f"{OBS_LATE_RANK}")
        both = OTL.link_matrix(world.link_stats(), nranks=P,
                               comms=set(ids.values()))
        parts = [world.link_matrix(tenant=t)["fields"] for t in OBS_TENANTS]
        for fld, cells in both["fields"].items():
            if cells != [[sum(p[fld][s][d] for p in parts)
                          for d in range(P)] for s in range(P)]:
                fail(f"observatory: the tenant slices' {fld} do not sum to "
                     f"the matrix over both tenants' communicators")
        emit({"phase": "observatory_straggler", "ranks": P,
              "late_rank": OBS_LATE_RANK, "late_ms": late_sleep_s * 1e3,
              "late_calls": OBS_LATE_CALLS, "late_window_s": late_s,
              "clean_p99_us": p99,
              "clean_hist_us": {c["tenant"]: {k: v for k, v in
                                              c["hist_us"].items() if v}
                                for c in snap["tenant_calls"].values()},
              "p99_ceiling_us": {t: OBS_P99_X * v for t, v in p99.items()},
              "clean_verdicts": clean,
              "slo": {t: {k: o[k] for k in ("verdict", "burn_fast",
                                             "burn_slow", "budget_remaining",
                                             "calls_fast", "bad_fast",
                                             "p99_fast_us")}
                      for t, o in verdicts.items()},
              "sentinel_findings": [{k: f[k] for k in (
                  "size_bucket", "axis", "live", "baseline", "ratio")}
                  for f in findings],
              "accl_health": health, "health_wait_s": health_wait_s,
              "slo_endpoint_checks": slo_doc["checks"],
              "attribution": {k: rows[0][k] for k in (
                  "collective", "size_bucket", "episodes", "span_us",
                  "phases_us", "phase_coverage", "dominant_straggler")},
              "clock_skew_ns": report["clock_skew_ns"],
              "slowest_link": list(slow),
              "seek_wait_ms_to_late_rank": [
                  m["fields"]["seek_wait_ns"][s][OBS_LATE_RANK] / 1e6
                  for s in range(P)]})
        OS.stop_sentinel()
        OSLO.stop_slo()
        OH.note_slow(reg, False)

        # -- 4. device overlap and the fused-overlap sweep -----------------
        OT.enable()
        col.clear()
        ring._DEVICE_TRACE = True
        try:
            traffic("train", 1)
            hold("train")
            traffic("train", 1, fused=True)
            doc = col.to_perfetto()
        finally:
            ring._DEVICE_TRACE = False
        hold("train", fused=True)
        dov = OA.device_overlap(doc)["collectives"]
        seq = min(dov[c]["exposed_fraction"]
                  for c in ("reduce_scatter", "all_gather"))
        fused = dov.get("fused_allreduce", {}).get("exposed_fraction")
        if seq < 0.95 or fused is None or not fused < seq:
            fail(f"observatory: device_overlap {dov} (sequential >= 0.95, "
                 f"fused lower)")
        emit({"phase": "observatory_device_overlap", "ranks": P,
              "mib_per_rank": OBS_TENANTS["train"][0] * 4 / MIB,
              "collectives": dov, "sequential_exposed": seq,
              "fused_exposed": fused})
        col.clear()
        # the sweep's matmul chain, sized to the 2^24 allreduce: the
        # allreduce host-staged as the sweep calls it, and the chain at a
        # probe dimension on the 8 rank threads, scaled by the cube root
        SW._run_once(world, "allreduce", 1 << OBS_SWEEP_POW, np.float32, 0)
        t_ar = SW._run_once(world, "allreduce", 1 << OBS_SWEEP_POW,
                            np.float32, 0)

        def chain(d):
            def body(accl, rank):
                a = torch.full((d, d), (rank + 1) / d, device=dev)
                for _ in range(2):
                    a = torch.matmul(a, a) * (1.0 / d)
                sync()
            world.run(body)
            t = time.perf_counter()
            world.run(body)
            return time.perf_counter() - t

        t_probe = chain(OBS_MM_PROBE)
        mm_dim = int(min(max(round(OBS_MM_PROBE * (t_ar / t_probe)
                                   ** (1 / 3) / 256) * 256, 256), 12288))
        t_mm = chain(mm_dim)
        col.clear()
        sweep_rows = SW.run_fused_overlap_sweep(world)
        sweep_rows += SW.run_fused_overlap_sweep(
            world, collectives=("allreduce",), count_pows=(OBS_SWEEP_POW,),
            repetitions=1, mm_dim=mm_dim)
        OT.disable()
        col.clear()
        for row in sweep_rows:
            ex = row["exposed_wire_fraction"]
            if not (row["duration_us"] > 0 and ex is not None
                    and 0.0 <= ex <= 1.0):
                fail(f"observatory: fused-overlap row {row}")
            emit({"phase": "observatory_fused_sweep", "ranks": P, **row,
                  **({"mm_dim": mm_dim} if row["count"]
                     == 1 << OBS_SWEEP_POW else {})})
        emit({"phase": "observatory_mm_dim", "mm_dim": mm_dim,
              "allreduce_2_24_staged_s": t_ar,
              f"chain_{OBS_MM_PROBE}_s": t_probe, "chain_s": t_mm})

        # -- 5. the cost of it all, per driver call -------------------------
        # a fresh registry: the armed sentinel and tracker sweep it every
        # 100 ms, and re-armed each round they would log the straggled
        # window's findings again
        reg.reset()
        os.environ.update({"ACCL_SLO_INTERVAL_MS": "100",
                           "ACCL_SENTINEL_INTERVAL_MS": "100"})

        def arm(on):
            nonlocal sampler
            if not on:
                if sampler is not None:
                    sampler.stop()
                    sampler = None
                OS.stop_sentinel()
                OSLO.stop_slo()
                return
            if sampler is None:
                sampler = new_sampler()
            if OS.ensure_sentinel_from_env() is None \
                    or OSLO.ensure_slo_from_env() is None:
                fail("observatory: the overhead arm armed nothing")

        over = {}
        for count, iters in OBS_OVERHEAD:
            pair = [(world.accls[r].create_buffer(count, np.float32),
                     world.accls[r].create_buffer(count, np.float32))
                    for r in range(P)]
            for s, _o in pair:
                s.dev.normal_(generator=gen)

            def calls(accl, rank, cid):
                s, o = pair[rank]
                for _ in range(iters):
                    accl.allreduce(s, o, count, ReduceFunction.SUM,
                                   comm_id=cid, from_fpga=True, to_fpga=True)

            us = {"on": [], "off": []}
            for cid in (0, ids["serve"]):
                world.run(calls, cid)
            sync()
            for i in range(OBS_OVERHEAD_ROUNDS):
                for lane in (("on", "off") if i % 2 == 0 else ("off", "on")):
                    arm(lane == "on")
                    cid = ids["serve"] if lane == "on" else 0
                    t = time.perf_counter()
                    world.run(calls, cid)
                    sync()
                    us[lane].append((time.perf_counter() - t) / iters * 1e6)
            arm(False)
            row = {"phase": "observatory_overhead", "ranks": P,
                   "count": count, "mib_per_rank": count * 4 / MIB,
                   "iters": iters,
                   "us_per_call_on": statistics.median(us["on"]),
                   "us_per_call_off": statistics.median(us["off"]),
                   "rounds_us_on": us["on"], "rounds_us_off": us["off"],
                   "spread_us_on": max(us["on"]) - min(us["on"]),
                   "spread_us_off": max(us["off"]) - min(us["off"])}
            row["on_minus_off_us"] = row["us_per_call_on"] \
                - row["us_per_call_off"]
            emit(row)
            over[count] = row
            del pair
        out = {"overhead": over, "sweep": sweep_rows, "mm_dim": mm_dim}
    finally:
        if sampler is not None:
            sampler.stop()
        OS.stop_sentinel()
        OSLO.stop_slo()
        OH.stop_exporter()
        OH.note_slow(reg, False)
        ring._DEVICE_TRACE = False
        OT.disable()
        col.clear()
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tmp.cleanup()
    out["launches"] = _ring_counts(ring)
    out["seconds"] = time.perf_counter() - t_phase
    if min(out["launches"].values()) < 1:
        fail(f"observatory: a ring instantiation never launched "
             f"{out['launches']}")
    emit({"phase": "observatory_done", "seconds": out["seconds"],
          "launches": out["launches"], "mm_dim": out["mm_dim"]})
    return out


#: the resilience phase's payload per rank: the main path's large
#: allreduce, 64 MiB of fp32 (a count 7 does not divide), and the 4 MiB
#: allreduce on comm 0 after reset_errors
RES_N = 16_777_216
RES_SMALL = 1 << 20


def sum_ref_bound(xs, P_):
    """float64 sum over the ranks' operands and the fp32 summation bound
    (P - 1) 2^-24 sum_r |x_r| that every fold order stays within."""
    ref = absum = None
    for x in xs:
        xd = x.double()
        ref = xd.clone() if ref is None else ref.add_(xd)
        absum = xd.abs() if absum is None else absum.add_(xd.abs())
    return ref, absum.mul_((P_ - 1) * 2.0 ** -24)


def _launched(ring, before) -> tuple:
    return (ring.ring_reduce_scatter.launches - before[0],
            ring.ring_all_gather.launches - before[1])


def _counts(ring) -> tuple:
    return ring.ring_reduce_scatter.launches, ring.ring_all_gather.launches


def resilience_path(ring, CudaWorld) -> dict:
    """Phase 7c: resilience on the card, on a fresh CudaWorld(8) at the
    main path's 64 MiB per rank, each step fatal:
    1. ranks 0-6 make comm 1 (P = 7): an allreduce and a reduce-scatter
       of RES_N elements (7 does not divide it) on the ring lane, bitwise
       the plain ring composition and within the fp32 summation bound of
       float64; a plan of the allreduce captured;
    2. rank 1's allreduce on comm 1 alone (a partial gang) and rank 2's
       receive nobody sends: export_join_state(1), then
       rebuild_gang_tables(1) drains them (both wake aborted); the same
       pair again, then rank 0 aborts comm 1 with RANK_FAILED: both wake
       aborted, the abort-to-last-wake ms printed;
    3. every rank's plan replay raises COMM_ABORTED and the ring kernels
       launch nothing;
    4. rank 7 joins (join_sync, _pad_communicators), ranks 0-6 grow comm
       1 into comm 2 (P = 8), whose RES_N allreduce launches both ring
       kernels, bitwise its plain version: the abort-to-recovered-
       allreduce ms printed;
    5. reset_errors on every rank, a 4 MiB allreduce on comm 0, then
       shrink_communicator(0) (every rank alive: CudaWorld has no
       liveness plane) and a RES_N allreduce on the shrunk comm, bitwise;
    6. the launch counts of 1-5, set to 0 just before and read just
       after, which join rows 1 and 2 of the kernels line.
    The device ms of the P = 7 and P = 8 rings at RES_N come after, by
    split_ms, outside the counts."""
    import threading

    from accl_tpu_torch import ACCLError, ReduceFunction
    from accl_tpu_torch.communicator import Communicator, Rank
    from accl_tpu_torch.constants import ErrorCode

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    aborted = int(ErrorCode.COMM_ABORTED)
    members = list(range(P - 1))
    joiner = P - 1
    barrier = threading.Barrier(P, timeout=60)
    out = {}
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather):
        fn.launches = fn.launches_stamp = 0
    with CudaWorld(P) as world:
        accls = world.accls

        def bufs(ranks, n):
            return {r: accls[r].create_buffer(n, np.float32) for r in ranks}

        def check(what, outs, want, ranks):
            for r in ranks:
                if not torch.equal(outs[r].dev, want[r]):
                    fail(f"resilience: {what}: rank {r} is not bitwise the "
                         f"plain ring (max abs err "
                         f"{max_err(outs[r].dev, want[r])})")
                if not torch.isfinite(outs[r].dev).all():
                    fail(f"resilience: {what}: non-finite output")

        # -- 1. the ring of 7 --------------------------------------------
        ids = world.run(lambda a, r: a.create_communicator(members)
                        if r in members else None)
        if ids[:-1] != [1] * (P - 1):
            fail(f"resilience: comm ids {ids}")
        sends, ar_out = bufs(members, RES_N), bufs(members, RES_N)
        rs_cnt = RES_N // (P - 1)
        rs_out = bufs(members, rs_cnt)
        fill(sends.values(), gen)
        xs = [sends[r].dev for r in members]

        def ar7(a, r):
            a.allreduce(sends[r], ar_out[r], RES_N, comm_id=1,
                        from_fpga=True, to_fpga=True)

        before = _counts(ring)
        world.run(lambda a, r: ar7(a, r) if r in members else None)
        torch.cuda.synchronize()
        ar7_launches = _launched(ring, before)
        check("P = 7 allreduce", ar_out,
              ring.ring_all_reduce_segmented(xs, "sum", plain=True), members)
        ref, bound = sum_ref_bound(xs, P - 1)
        for r in members:
            if not within_bound(ar_out[r].dev, ref, bound):
                fail(f"resilience: P = 7 allreduce rank {r} outside the "
                     f"fp32 summation bound (max abs err "
                     f"{max_err(ar_out[r].dev, ref)})")
        before = _counts(ring)
        world.run(lambda a, r: a.reduce_scatter(
            sends[r], rs_out[r], rs_cnt, ReduceFunction.SUM, comm_id=1,
            from_fpga=True, to_fpga=True) if r in members else None)
        torch.cuda.synchronize()
        rs7_launches = _launched(ring, before)
        head = [x[:rs_cnt * (P - 1)] for x in xs]
        want_rs = ring.ring_reduce_scatter_segmented(head, "sum", plain=True)
        check("P = 7 reduce-scatter", rs_out, want_rs, members)
        rs_err = 0.0
        for r in members:
            lo = r * rs_cnt
            if not within_bound(rs_out[r].dev, ref[lo:lo + rs_cnt],
                                bound[lo:lo + rs_cnt]):
                fail(f"resilience: P = 7 reduce-scatter rank {r} outside "
                     f"the fp32 summation bound")
            rs_err = max(rs_err, max_err(rs_out[r].dev, ref[lo:lo + rs_cnt]))
        ar_err = max(max_err(ar_out[r].dev, ref) for r in members)
        del ref, bound, want_rs
        if ar7_launches != (1, 1) or rs7_launches != (1, 0):
            fail(f"resilience: P = 7 launches {ar7_launches} (allreduce), "
                 f"{rs7_launches} (reduce-scatter)")
        plans = world.run(lambda a, r: a.capture_plan(
            lambda a2: ar7(a2, r), validate=True, timeout_s=60)
            if r in members else None)
        torch.cuda.synchronize()
        # the grown comm's operands exist before the failure, as an
        # application's buffers would
        g_send, g_out = bufs(range(P), RES_N), bufs(range(P), RES_N)
        fill(g_send.values(), gen)
        torch.cuda.synchronize()

        # -- 2. partial gang and pending receive: rebuild, then abort -----
        st = world.devices[0].export_join_state(1)
        if st["comm_count"] != 2 or st["members"] != members:
            fail(f"resilience: export_join_state(1) = {st}")
        rbuf = accls[2].create_buffer(1024, np.float32)

        def strand(a, r):
            if r == 1:
                return a.allreduce(sends[1], ar_out[1], RES_N, comm_id=1,
                                   from_fpga=True, to_fpga=True,
                                   run_async=True)
            if r == 2:
                return a.recv(rbuf, 1024, 0, tag=77, comm_id=1,
                              run_async=True, to_fpga=True)
            return None

        before = _counts(ring)
        reqs = world.run(strand)
        evicted = world.devices[0].rebuild_gang_tables(1)
        for r in (1, 2):
            if not reqs[r].wait(30) or not reqs[r].aborted:
                fail(f"resilience: rank {r}'s request did not wake aborted "
                     f"after rebuild_gang_tables")
        if evicted < 2:
            fail(f"resilience: rebuild_gang_tables(1) evicted {evicted}")
        ready = threading.Barrier(3, timeout=60)

        def abort_round(a, r):
            if r in (1, 2):
                req = strand(a, r)
                ready.wait()
                ok = req.wait(30)
                return time.perf_counter(), ok and req.aborted, req.retcode
            if r == 0:
                ready.wait()
                time.sleep(0.05)  # both waiters are parked in wait()
                t = time.perf_counter()
                a.abort(1, error=int(ErrorCode.RANK_FAILED))
                return t
            return None

        woke = world.run(abort_round)
        t_abort = woke[0]
        for r in (1, 2):
            if not woke[r][1] or not woke[r][2] & int(ErrorCode.RANK_FAILED):
                fail(f"resilience: rank {r} did not wake aborted with "
                     f"RANK_FAILED (retcode {woke[r][2]:#x})")
        wake_ms = (max(woke[1][0], woke[2][0]) - t_abort) * 1e3

        # -- 3. the fenced plan ------------------------------------------
        def replay(a, r):
            if r not in members:
                return True
            try:
                plans[r].replay()
            except ACCLError as e:
                return bool(e.code & aborted)
            return False

        if not all(world.run(replay)):
            fail("resilience: a plan replay after the abort did not raise "
                 "COMM_ABORTED")
        if _launched(ring, before) != (0, 0):
            fail(f"resilience: the fenced replays and stranded calls "
                 f"launched {_launched(ring, before)}")

        # -- 4. join and grow to P = 8 -----------------------------------
        new_row = Rank(ip="127.0.0.1", port=0, session=joiner)

        def join_grow(a, r):
            if r == joiner:
                if a.device.join_sync(0) != 0:
                    fail("resilience: join_sync")
                a._pad_communicators(a.device.comm_count())
            barrier.wait()
            if r != joiner:
                gid = a.grow_communicator([new_row], comm_id=1,
                                          window_s=0.1)
            else:
                rows = [Rank(ip="127.0.0.1", port=0, session=i)
                        for i in members] + [new_row]
                gid = a._install_communicator(
                    Communicator(rows, joiner, comm_id=2))
            a.allreduce(g_send[r], g_out[r], RES_N, comm_id=gid,
                        from_fpga=True, to_fpga=True)
            return gid

        before = _counts(ring)
        gids = world.run(join_grow)
        torch.cuda.synchronize()
        recover_ms = (time.perf_counter() - t_abort) * 1e3
        grow_launches = _launched(ring, before)
        if gids != [2] * P or grow_launches != (1, 1):
            fail(f"resilience: grown comm ids {gids}, launches "
                 f"{grow_launches}")
        xs8 = [g_send[r].dev for r in range(P)]
        check("grown P = 8 allreduce", g_out,
              ring.ring_all_reduce_segmented(xs8, "sum", plain=True),
              range(P))

        # -- 5. reset_errors, comm 0, shrink -----------------------------
        world.run(lambda a, r: a.reset_errors())
        small_s, small_o = bufs(range(P), RES_SMALL), bufs(range(P),
                                                           RES_SMALL)
        fill(small_s.values(), gen)
        before = _counts(ring)
        world.run(lambda a, r: a.allreduce(small_s[r], small_o[r], RES_SMALL,
                                           from_fpga=True, to_fpga=True))
        torch.cuda.synchronize()
        reset_launches = _launched(ring, before)
        check("4 MiB allreduce after reset_errors", small_o,
              ring.ring_all_reduce_segmented([small_s[r].dev
                                              for r in range(P)], "sum",
                                             plain=True), range(P))
        fill(g_send.values(), gen)
        before = _counts(ring)

        def shrink(a, r):
            sid = a.shrink_communicator(0, window_s=0.1)
            a.allreduce(g_send[r], g_out[r], RES_N, comm_id=sid,
                        from_fpga=True, to_fpga=True)
            return sid, a.communicator(sid).size

        sids = world.run(shrink)
        torch.cuda.synchronize()
        shrink_launches = _launched(ring, before)
        if sids != [(3, P)] * P or reset_launches != (1, 1) \
                or shrink_launches != (1, 1):
            fail(f"resilience: shrunk comms {sids}, launches "
                 f"{reset_launches} (reset) {shrink_launches} (shrink)")
        check("shrunk comm allreduce", g_out,
              ring.ring_all_reduce_segmented(xs8, "sum", plain=True),
              range(P))
        out["launches"] = {"ring_reduce_scatter":
                           ring.ring_reduce_scatter.launches,
                           "ring_all_gather": ring.ring_all_gather.launches}
        # -- the rings of 7 and 8 on the card (outside the counts) -------
        ms7 = split_ms(lambda: ring.ring_all_reduce_segmented(
            xs, "sum", out=[ar_out[r].dev for r in members]), iters=5)
        ms8 = split_ms(lambda: ring.ring_all_reduce_segmented(
            xs8, "sum", out=[g_out[r].dev for r in range(P)]), iters=5)
        del plans
    out.update(abort_wake_ms=wake_ms, abort_to_recovered_ms=recover_ms,
               p7_device_ms=ms7["device_ms"], p8_device_ms=ms8["device_ms"],
               seconds=time.perf_counter() - t_phase)
    emit({"phase": "resilience_path", "ranks": P, "count": RES_N,
          "mib_per_rank": RES_N * 4 / MIB, "card": card_line(),
          "p7_allreduce_launches": list(ar7_launches),
          "p7_reduce_scatter_launches": list(rs7_launches),
          "p7_allreduce_max_abs_err_vs_f64": ar_err,
          "p7_reduce_scatter_max_abs_err_vs_f64": rs_err,
          "rebuild_evicted": evicted, "abort_wake_ms": wake_ms,
          "abort_to_recovered_allreduce_ms": recover_ms,
          "grown_allreduce_launches": list(grow_launches),
          "after_reset_launches": list(reset_launches),
          "shrunk_allreduce_launches": list(shrink_launches),
          "p7_ring_device_ms": ms7["device_ms"],
          "p7_ring_host_enqueue_ms": ms7["host_enqueue_ms"],
          "p8_ring_device_ms": ms8["device_ms"],
          "p8_ring_host_enqueue_ms": ms8["host_enqueue_ms"],
          "launches": out["launches"], "seconds": out["seconds"]})
    return out


#: the emulator phase: ranks, and MiB per rank of each collective
EMU_RANKS = 4
EMU_MIB = (1, 8)


def native_build_thread():
    """Build (or find fresh) native/libacclemu.so on a thread of its own,
    beside the kernels' nvcc builds; emu_world joins it and fails on its
    error."""
    import threading

    from accl_tpu_torch.backends import emu as EMU

    state = {"error": None, "seconds": None}

    def run():
        t = time.perf_counter()
        try:
            EMU.load_lib()
        except Exception as e:  # noqa: BLE001 — emu_world fails on it
            state["error"] = e
        state["seconds"] = time.perf_counter() - t

    th = threading.Thread(target=run, name="native-build", daemon=True)
    th.start()
    state["thread"] = th
    return state


def emu_world(ring, CudaWorld, native) -> dict:
    """Phase 7d: the port's EmuWorld(4) on the native engine (built from
    native/ on this machine) against CudaWorld(4) on the card: allreduce,
    allgather and reduce_scatter at 1 and 8 MiB per rank, int32 and fp32
    SUM, from one numpy seed.  int32 results and the fp32 all-gather are
    bitwise; fp32 sums differ by fold order: each is held within
    (P - 1) 2^-24 sum_r |x_r| of float64, so the two within twice that of
    each other.  At 8 MiB the
    card's world launches the ring kernels (the counts join rows 1 and 2).
    A failed build or load fails the run."""
    from accl_tpu_torch import ReduceFunction
    from accl_tpu_torch.backends import emu as EMU

    t_phase = time.perf_counter()
    native["thread"].join(timeout=600)
    if native["thread"].is_alive() or native["error"] is not None:
        fail(f"emu_world: the native engine did not build or load: "
             f"{native['error']}")
    Pe = EMU_RANKS
    rng = np.random.default_rng(SEED + 17)
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather):
        fn.launches = fn.launches_stamp = 0
    cases = []

    def program(kind, n, dtype, data):
        def fn(accl, rank):
            src = accl.create_buffer_like(data[rank])
            out_n = {"allreduce": n, "allgather": n * Pe,
                     "reduce_scatter": n // Pe}[kind]
            dst = accl.create_buffer(out_n, dtype)
            if kind == "allreduce":
                accl.allreduce(src, dst, n, ReduceFunction.SUM)
            elif kind == "allgather":
                accl.allgather(src, dst, n)
            else:
                accl.reduce_scatter(src, dst, n // Pe, ReduceFunction.SUM)
            res = dst.host.copy()
            for b in (src, dst):
                b.free()
            return res
        return fn

    with EMU.EmuWorld(Pe, devmem_bytes=256 << 20,
                      max_rendezvous_size=64 << 20) as ew, \
            CudaWorld(Pe) as cw:
        for dtype in (np.int32, np.float32):
            for mib in EMU_MIB:
                n = mib * MIB // 4
                if dtype == np.int32:
                    data = [rng.integers(-1 << 20, 1 << 20, n,
                                         dtype=np.int32) for _ in range(Pe)]
                else:
                    data = [rng.standard_normal(n).astype(np.float32)
                            for _ in range(Pe)]
                absum = np.sum([np.abs(x.astype(np.float64)) for x in data],
                               axis=0)
                ref = np.sum([x.astype(np.float64) for x in data], axis=0)
                bound = (Pe - 1) * 2.0 ** -24 * absum
                for kind in ("allreduce", "allgather", "reduce_scatter"):
                    t = time.perf_counter()
                    emu = ew.run(program(kind, n, dtype, data), timeout=120)
                    emu_s = time.perf_counter() - t
                    before = _counts(ring)
                    t = time.perf_counter()
                    card = cw.run(program(kind, n, dtype, data), timeout=120)
                    card_s = time.perf_counter() - t
                    launched = _launched(ring, before)
                    want_launch = {"allreduce": (1, 1), "allgather": (0, 1),
                                   "reduce_scatter": (1, 0)}[kind]
                    if mib * MIB >= cw.engine.ring_threshold_bytes \
                            and launched != want_launch:
                        fail(f"emu_world: CudaWorld's {kind} at {mib} MiB "
                             f"launched {launched}")
                    err = 0.0
                    for r in range(Pe):
                        e, c = emu[r], card[r]
                        if dtype == np.int32 or kind == "allgather":
                            if e.tobytes() != c.tobytes():
                                fail(f"emu_world: {kind} {dtype.__name__} "
                                     f"{mib} MiB rank {r}: the emulator is "
                                     f"not bitwise CudaWorld")
                            continue
                        lo = r * (n // Pe) if kind == "reduce_scatter" else 0
                        hi = lo + e.shape[0]
                        b = bound[lo:hi]
                        for who, got in (("the emulator", e), ("the card", c)):
                            if not (np.abs(got - ref[lo:hi]) <= b).all():
                                fail(f"emu_world: {kind} float32 {mib} MiB "
                                     f"rank {r}: {who}'s sum is outside (P - "
                                     f"1) 2^-24 sum|x| of float64")
                        # two folds, each within the bound of the exact
                        # sum, are within twice it of each other
                        d = np.abs(e.astype(np.float64) - c)
                        if not (d <= 2 * b).all():
                            fail(f"emu_world: {kind} float32 {mib} MiB rank "
                                 f"{r}: the two sums differ by more than 2 "
                                 f"(P - 1) 2^-24 sum|x| (max abs diff "
                                 f"{d.max()})")
                        err = max(err, float(d.max()))
                    cases.append({"kind": kind, "dtype": dtype.__name__,
                                  "mib_per_rank": mib,
                                  "max_abs_diff": err, "emu_s": emu_s,
                                  "card_s": card_s,
                                  "card_launches": list(launched)})
    out = {"launches": {"ring_reduce_scatter":
                        ring.ring_reduce_scatter.launches,
                        "ring_all_gather": ring.ring_all_gather.launches},
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "emu_world", "ranks": Pe, "native_lib": EMU.lib_path(),
          "native_build_s": native["seconds"], "cases": cases,
          "launches": out["launches"], "seconds": out["seconds"]})
    return out


#: the device-API phase: elements per rank (64 MiB of fp32)
DAPI_N = 16_777_216


def _pushed_call(accl, rank, kind, n, data, flags, tag=9):
    """Rank ``rank`` issues one raw descriptor by the device API: push its
    operand (OP0_STREAM), start the call, finalize; the result is left in
    kernel stream ``tag`` (RES_STREAM)."""
    from accl_tpu_torch import Operation
    from accl_tpu_torch.constants import DataType
    from accl_tpu_torch.device_api import ACCLCommand, ACCLData

    if data is not None:
        ACCLData(accl.device).push(data[rank])
    cmd = ACCLCommand(accl.device,
                      arithcfg=accl._arith_ids[(DataType.float32,
                                                DataType.float32)])
    cmd.start_call(Operation[kind], n, function=0, tag=tag,
                   stream_flags=flags)
    return cmd.finalize_call()


def device_api_phase(ring, CudaWorld) -> dict:
    """Phase 7e: the device API and kernel streams on a fresh
    CudaWorld(8) at DAPI_N fp32 per rank (64 MiB), each step fatal:
    a. every rank ACCLData.push-es its operand and issues
       ACCLCommand.start_call(allreduce, OP0_STREAM | RES_STREAM, tag 9);
       ACCLData.pull reads the result: bitwise the buffer-sourced
       allreduce of the same data and within (P - 1) 2^-24 sum|x| of
       float64; both ring kernels launch once;
    b. the same for reduce_scatter (rank r's 8 MiB chunk) and allgather
       (512 MiB a rank), bitwise their buffer-sourced results;
    c. vadd_put (examples/device_vadd_put.py): push x + 1, stream_put to
       the next rank, pull: bitwise the previous rank's x + 1;
    d. a kernel-issued allreduce by raw device addresses
       (ACCLCommand.allreduce), bitwise a;
    e. copy_to_stream and copy_from_stream round trips, and the rooted
       reduce with OP0_STREAM, then with RES_STREAM (stream 11), bitwise
       the buffer-sourced reduce;
    f. DeviceCollectives over 8 member tensors on the card against the
       same collectives written out with torch ops.
    The launch counts of a-e (set to 0 just before, read just after) join
    rows 1 and 2.  Then, outside the counts: events ms of the 64 MiB
    allreduce stream-sourced (push, call, pull), host-staged from buffers,
    and resident; the push's and the pull's ms; and the device ms of the
    stream-sourced and the resident call by split_ms."""
    import threading

    from accl_tpu_torch import DataType, ReduceFunction, StreamFlags
    from accl_tpu_torch.device_api import ACCLCommand, ACCLData, \
        DeviceCollectives

    t_phase = time.perf_counter()
    n = DAPI_N
    both = StreamFlags.OP0_STREAM | StreamFlags.RES_STREAM
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    xs = [rand((n,), torch.float32, gen) for _ in range(P)]
    host = [x.cpu().numpy() for x in xs]
    ref, bound = sum_ref_bound(xs, P)
    out = {"checks": {}}
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather):
        fn.launches = fn.launches_stamp = 0

    def bitwise(what, got, want):
        if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
            fail(f"device_api: {what}: not bitwise the buffer-sourced "
                 f"result (max abs err "
                 f"{float(np.abs(got - want).max())})")

    with CudaWorld(P) as world:
        accls = world.accls
        send = {r: accls[r].create_buffer(n, np.float32) for r in range(P)}
        for r in range(P):
            send[r].dev.copy_(xs[r])
            send[r].host[:] = host[r]

        def buffered(kind):
            def fn(a, r):
                cnt = n // P if kind == "reduce_scatter" else n
                o = a.create_buffer(
                    n * P if kind == "allgather" else cnt, np.float32)
                getattr(a, kind)(send[r], o, cnt, *(
                    () if kind == "allgather" else (ReduceFunction.SUM,)),
                    from_fpga=True, to_fpga=True)
                torch.cuda.synchronize()
                res = o.dev.cpu().numpy()
                o.free()
                return res
            return fn

        # -- a, b: stream-sourced collectives ----------------------------
        for kind in ("allreduce", "reduce_scatter", "allgather"):
            cnt = n // P if kind == "reduce_scatter" else n
            out_n = n * P if kind == "allgather" else cnt
            want = world.run(buffered(kind), timeout=300)
            before = _counts(ring)
            t = time.perf_counter()
            got = world.run(lambda a, r: (
                _pushed_call(a, r, kind, cnt, host, both),
                ACCLData(a.device).pull(out_n, np.float32, 9,
                                        timeout=120))[1], timeout=300)
            s = time.perf_counter() - t
            launched = _launched(ring, before)
            want_l = {"allreduce": (1, 1), "reduce_scatter": (1, 0),
                      "allgather": (0, 1)}[kind]
            if launched != want_l:
                fail(f"device_api: stream-sourced {kind} launched "
                     f"{launched}, want {want_l}")
            for r in range(P):
                bitwise(f"stream {kind} rank {r}", got[r], want[r])
            err = None
            if kind != "allgather":
                lo = [r * cnt if kind == "reduce_scatter" else 0
                      for r in range(P)]
                err = 0.0
                for r in range(P):
                    g = torch.from_numpy(got[r]).cuda()
                    if not within_bound(g, ref[lo[r]:lo[r] + cnt],
                                        bound[lo[r]:lo[r] + cnt]):
                        fail(f"device_api: stream {kind} rank {r} outside "
                             f"(P - 1) 2^-24 sum|x| of float64")
                    err = max(err, max_err(g, ref[lo[r]:lo[r] + cnt]))
            out["checks"][f"stream_{kind}"] = {
                "launches": list(launched), "s": s,
                "max_abs_err_vs_f64": err}
            del want, got
        ar_want = world.run(buffered("allreduce"), timeout=300)

        # -- c: vadd_put --------------------------------------------------
        def vadd_put(a, r):
            d = ACCLData(a.device)
            d.push(host[r] + np.float32(1.0))
            ACCLCommand(a.device).stream_put(n, stream_id=9,
                                             dst=(r + 1) % P)
            return d.pull(n, np.float32, 9, timeout=120)

        before = _counts(ring)
        for r, got in enumerate(world.run(vadd_put, timeout=300)):
            bitwise(f"vadd_put rank {r}", got,
                    host[(r - 1) % P] + np.float32(1.0))
        if _launched(ring, before) != (0, 0):
            fail("device_api: vadd_put launched a ring kernel")

        # -- d: kernel-issued allreduce by raw addresses --------------------
        dst = {r: accls[r].create_buffer(n, np.float32) for r in range(P)}
        before = _counts(ring)
        world.run(lambda a, r: ACCLCommand(
            a.device, arithcfg=a._arith_ids[(DataType.float32,
                                             DataType.float32)]).allreduce(
            n, int(ReduceFunction.SUM), send[r].address, dst[r].address),
            timeout=300)
        torch.cuda.synchronize()
        raw_launched = _launched(ring, before)
        if raw_launched != (1, 1):
            fail(f"device_api: kernel-issued allreduce launched "
                 f"{raw_launched}")
        for r in range(P):
            bitwise(f"kernel-issued allreduce rank {r}",
                    dst[r].dev.cpu().numpy(), ar_want[r])

        # -- e: copy_to/from_stream, reduce with stream operands ----------
        root = 3

        def streams_and_reduce(a, r):
            a.copy_to_stream(send[r], n, stream_id=10, from_fpga=True)
            raw = a.device.pop_stream(10, n * 4, 120)
            a.device.push_krnl(np.frombuffer(raw, np.float32))
            back = a.create_buffer(n, np.float32)
            a.copy_from_stream(back, n, to_fpga=True)
            torch.cuda.synchronize()
            if not torch.equal(back.dev, xs[r]):
                fail(f"device_api: copy_to/from_stream rank {r} round "
                     f"trip differs")
            back.free()
            rb = a.create_buffer(n, np.float32)
            a.reduce(send[r], rb, n, root, from_fpga=True, to_fpga=True)
            torch.cuda.synchronize()
            flat = rb.dev.cpu().numpy()
            a.device.push_krnl(host[r])
            a.reduce(None, rb, n, root, stream_flags=StreamFlags.OP0_STREAM,
                     to_fpga=True)
            torch.cuda.synchronize()
            from_stream = rb.dev.cpu().numpy()
            a.reduce(send[r], None, n, root, from_fpga=True,
                     stream_flags=StreamFlags.RES_STREAM, stream_id=11)
            to_stream = (np.frombuffer(a.device.pop_stream(11, n * 4, 120),
                                       np.float32) if r == root else None)
            rb.free()
            return flat, from_stream, to_stream

        before = _counts(ring)
        res = world.run(streams_and_reduce, timeout=300)
        if _launched(ring, before) != (0, 0):
            fail("device_api: the copies and rooted reduces launched a ring "
                 "kernel")
        flat, from_stream, to_stream = res[root]
        bitwise("reduce OP0_STREAM", from_stream, flat)
        bitwise("reduce RES_STREAM", to_stream, flat)
        out["launches"] = {"ring_reduce_scatter":
                           ring.ring_reduce_scatter.launches,
                           "ring_all_gather": ring.ring_all_gather.launches}

        # -- f: DeviceCollectives over member tensors -----------------------
        dc = DeviceCollectives()
        small = [x[:1 << 20].reshape(P, -1) for x in xs]
        total = small[0]
        for x in small[1:]:
            total = total + x
        checks = {
            "allreduce": (dc.allreduce(small), [total] * P),
            "reduce": (dc.reduce(small, 2), [total] * P),
            "allgather": (dc.allgather(small), [torch.cat(small)] * P),
            "reduce_scatter": (dc.reduce_scatter(small),
                               [total[r:r + 1] for r in range(P)]),
            "alltoall": (dc.alltoall(small),
                         [torch.cat([x[r:r + 1] for x in small])
                          for r in range(P)]),
            "bcast": (dc.bcast(small, 5), [small[5]] * P),
            "scatter": (dc.scatter(small, 1), [small[1][r] for r in range(P)]),
            "gather": (dc.gather(small, 6), [torch.stack(small)] * P),
            "send_recv": (dc.send_recv(small, 2, 7),
                          [small[2] if r == 7 else torch.zeros_like(small[r])
                           for r in range(P)]),
        }
        for name, (got, want) in checks.items():
            if len(got) != P or not all(torch.equal(g, w)
                                        for g, w in zip(got, want)):
                fail(f"device_api: DeviceCollectives.{name} differs from "
                     f"the torch ops")
        if int(dc.barrier(small)[0]) != P:
            fail("device_api: DeviceCollectives.barrier")

        # -- times (outside the counts) -------------------------------------
        recv = {r: accls[r].create_buffer(n, np.float32) for r in range(P)}

        def stream_cycle(a, r):
            _pushed_call(a, r, "allreduce", n, host, both)
            ACCLData(a.device).pull(n, np.float32, 9, timeout=120)

        def staged(a, r):
            a.allreduce(send[r], recv[r], n)

        def resident(a, r):
            a.allreduce(send[r], recv[r], n, from_fpga=True, to_fpga=True)

        times = {
            "stream_push_call_pull_events_ms": cuda_ms(
                lambda: world.run(stream_cycle, timeout=300), 1, runs=3),
            "buffer_staged_events_ms": cuda_ms(
                lambda: world.run(staged, timeout=300), 1, runs=3),
            "buffer_resident_events_ms": cuda_ms(
                lambda: world.run(resident, timeout=300), 1, runs=3),
        }
        barrier = threading.Barrier(P, timeout=60)

        def push_pull(a, r):
            d = ACCLData(a.device)
            barrier.wait()
            t0 = time.perf_counter()
            d.push(host[r])
            barrier.wait()
            t1 = time.perf_counter()
            _pushed_call(a, r, "allreduce", n, None, both)
            torch.cuda.synchronize()
            barrier.wait()
            t2 = time.perf_counter()
            d.pull(n, np.float32, 9, timeout=120)
            barrier.wait()
            return t1 - t0, time.perf_counter() - t2

        pp = world.run(push_pull, timeout=300)
        times["push_ms"] = max(p[0] for p in pp) * 1e3
        times["pull_ms"] = max(p[1] for p in pp) * 1e3
        # device ms: the stream-sourced call (operands pushed before the
        # window, results popped after) beside the resident buffer call
        pending = 8  # split_ms's calls: warm-up, guess, 3 runs, retries
        world.run(lambda a, r: [ACCLData(a.device).push(host[r])
                                for _ in range(pending)], timeout=300)
        torch.cuda.synchronize()
        calls = [0]

        def stream_call():
            calls[0] += 1
            world.run(lambda a, r: _pushed_call(a, r, "allreduce", n, None,
                                                both), timeout=300)

        dev_stream = split_ms(stream_call, 1, runs=3)
        if calls[0] > pending:
            fail(f"device_api: split_ms made {calls[0]} stream calls, "
                 f"{pending} operands pushed")
        def drain(a, r):
            for _ in range(calls[0]):
                ACCLData(a.device).pull(n, np.float32, 9, timeout=120)
            for _ in range(pending - calls[0]):
                a.copy_from_stream(recv[r], n, to_fpga=True)

        world.run(drain, timeout=300)
        dev_res = split_ms(lambda: world.run(resident, timeout=300), 1,
                           runs=3)
        times.update(stream_device_ms=dev_stream["device_ms"],
                     stream_host_enqueue_ms=dev_stream["host_enqueue_ms"],
                     resident_device_ms=dev_res["device_ms"],
                     resident_host_enqueue_ms=dev_res["host_enqueue_ms"])
    out.update(times=times, seconds=time.perf_counter() - t_phase)
    emit({"phase": "device_api", "ranks": P, "count": n,
          "mib_per_rank": n * 4 / MIB, "card": card_line(),
          "checks": out["checks"],
          "kernel_issued_allreduce_launches": list(raw_launched),
          "launches": out["launches"], **times, "seconds": out["seconds"]})
    return out


#: the tuning phase: payload MiB of each cell (the table's bytes)
TUNE_MIB = (1, 4, 16, 64)
TUNE_COLLS = ("allreduce", "reduce_scatter", "allgather")


def served_lane(accl, coll, count, table_lane, thr) -> str:
    """The lane a driver with an armed selection policy dispatches a
    float32 cell by: the fused descriptor; else the compression the armed
    policy selects; else the composer; else the installed ring threshold
    ``thr`` (a flat win above it is served by the ring, as in the JAX
    package)."""
    from accl_tpu_torch import DataType, Operation

    if table_lane == "fused":
        return "fused"
    comp = accl.compression_policy
    sel = comp.select(Operation[coll], count, 0, DataType.float32) \
        if comp else None
    if sel is not None:
        return {DataType.int8: "compress_int8",
                DataType.float16: "compress_fp16"}[sel]
    if table_lane == "hierarchical":
        return "hierarchical"
    in_len = count * (P if coll == "reduce_scatter" else 1)
    return "ring" if in_len * 4 >= thr else "flat"


def tuning_phase(ring, CudaWorld) -> dict:
    """Phase 7f: offline tuning on the card.  tune (through the CLI's
    tune_sizes) on a fresh CudaWorld(8) over TUNE_COLLS at TUNE_MIB
    payload MiB, over the cuda lanes (static, flat, ring, hierarchical,
    fused, compress_int8, compress_fp16), best of 3; each cell's winner
    and busbw; compare's never-slower verification against static (its
    prune leaves no cell below 1/1.05).  The table is armed through
    ACCL_TUNE_TABLE on a fresh world, and each cell is served there
    (host-staged, as the tuner measured it): bitwise the same call on a
    second world with the same registers and the served lane forced
    directly (fused=True, compress_dtype, HierarchicalComm; the register
    lanes by apply_algorithm).  Then, with compression disarmed on both
    worlds, the 64 MiB allreduce cell is hot-swapped to the hierarchical
    lane: the routed composition on int32 data bitwise the flat
    allreduce, on fp32 within (P - 1) 2^-24 sum|x| of float64.  Every part's ring launches
    (set to 0 before the phase, read after) join rows 1 and 2."""
    import tempfile

    from accl_tpu_torch import ReduceFunction
    from accl_tpu_torch.constants import TuningKey
    from accl_tpu_torch.observability import metrics as OM
    from accl_tpu_torch.tuning import HierarchicalComm, SelectionTable, \
        TuneConfig, autotune
    from accl_tpu_torch.tuning import cli as TC

    t_phase = time.perf_counter()
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather):
        fn.launches = fn.launches_stamp = 0
    cfg = TuneConfig(collectives=TUNE_COLLS, dtype="float32",
                     repetitions=3)
    with CudaWorld(P) as world:
        t = time.perf_counter()
        table = TC.tune_sizes(world, cfg, list(TUNE_MIB), log=None)
        tune_s = time.perf_counter() - t
        t = time.perf_counter()
        rows = autotune.compare(world, table, cfg)
        compare_s = time.perf_counter() - t
    for key, e in sorted(table.entries.items()):
        coll, _dt, bucket, _n = key.split("|")
        emit({"phase": "tuning_cell", "collective": coll, "bucket": bucket,
              "bytes": e["bytes"], "winner": e["algorithm"],
              "busbw_GBps": e["busbw_GBps"],
              "static_busbw_GBps": e["static_busbw_GBps"],
              "pruned_from": e.get("pruned_from")})
    slow = [r for r in rows if r["ratio"] < 1.0 / 1.05]
    for r in rows:
        emit({"phase": "tuning_compare", **r})
    if not rows or slow:
        fail(f"tuning: compare left {len(slow)} cells slower than static "
             f"(of {len(rows)})")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "table.json")
        table.save(path)
        loaded = SelectionTable.load(path)
        if loaded.entries != table.entries:
            fail("tuning: the saved table does not read back")
        os.environ["ACCL_TUNE_TABLE"] = path
        try:
            served_world = CudaWorld(P)
        finally:
            del os.environ["ACCL_TUNE_TABLE"]
    served = []
    try:
        with CudaWorld(P) as forced_world:
            A, B = served_world, forced_world
            policy = A.accls[0]._tune_policy
            if policy is None:
                fail("tuning: ACCL_TUNE_TABLE armed no policy")
            thr = A.engine.ring_threshold_bytes
            comp = A.accls[0].compression_policy
            for a in B.accls:
                a.set_tuning(int(TuningKey.RING_THRESHOLD_BYTES), thr)
                a.set_compression(comp)
            fabric = autotune.fabric_of_table(policy.table, P)
            hier = [HierarchicalComm(a, fabric) for a in B.accls]
            rng = np.random.default_rng(SEED + 19)

            def program(coll, count, data, lane, accl_side):
                def fn(a, r):
                    made = []

                    def mk(factory, *args):
                        made.append(factory(*args))
                        return made[-1]

                    n_in = count * (P if coll == "reduce_scatter" else 1)
                    n_out = count * (P if coll == "allgather" else 1)
                    s = mk(a.create_buffer_like, data[r][:n_in])
                    o = mk(a.create_buffer, n_out, data[r].dtype)
                    kw = {}
                    if accl_side == "forced":
                        if lane == "fused":
                            kw["fused"] = True
                        elif lane in autotune.COMPRESSION_ALGS:
                            kw["compress_dtype"] = \
                                autotune._compress_dtype_of(lane)
                    if accl_side == "forced" and lane == "hierarchical":
                        h = hier[r]
                        if coll == "allgather":
                            h.allgather(s, o, count)
                        else:
                            getattr(h, coll)(s, o, count,
                                             ReduceFunction.SUM)
                    elif coll == "allgather":
                        a.allgather(s, o, count, **kw)
                    else:
                        getattr(a, coll)(s, o, count, ReduceFunction.SUM,
                                         **kw)
                    res = o.host.copy()
                    for b in made:
                        b.free()
                    return res
                return fn

            for key, e in sorted(policy.table.entries.items()):
                coll, _dt, bucket, _n = key.split("|")
                count = e["bytes"] // (OM.payload_factor(coll, P) * 4)
                lane = served_lane(A.accls[0], coll, count, e["algorithm"],
                                   thr)
                n_in = count * (P if coll == "reduce_scatter" else 1)
                data = [rng.standard_normal(n_in, dtype=np.float32)
                        for _ in range(P)]
                before = _counts(ring)
                got = A.run(program(coll, count, data, lane, "served"),
                            timeout=300)
                launched = _launched(ring, before)
                if lane in ("ring", "flat"):
                    autotune.apply_algorithm(B, lane)
                want = B.run(program(coll, count, data, lane, "forced"),
                             timeout=300)
                for a in B.accls:
                    a.set_tuning(int(TuningKey.RING_THRESHOLD_BYTES), thr)
                for r in range(P):
                    if got[r].tobytes() != want[r].tobytes():
                        fail(f"tuning: served {coll} {bucket} ({lane}) rank "
                             f"{r} is not bitwise the lane forced directly")
                served.append({"collective": coll, "bucket": bucket,
                               "table_lane": e["algorithm"],
                               "served_lane": lane,
                               "served_launches": list(launched)})

            # -- the hierarchical route on the card ------------------------
            n = 64 * MIB // 4
            key = autotune.cell_key("allreduce", "float32",
                                    OM.size_bucket(n * 4), P)
            for a in A.accls:
                a._tune_policy.hot_swap(a, key, {
                    "algorithm": "hierarchical", "busbw_GBps": 0.0,
                    "static_busbw_GBps": 0.0, "bytes": n * 4})
            # the composer's staged calls would ride the compression policy
            # the swap re-installs (as in the JAX package): this check
            # holds the route alone to the fp32 bound, uncompressed
            for a in (*A.accls, *B.accls):
                a.set_compression(None)
            ints = [rng.integers(-1 << 20, 1 << 20, n, dtype=np.int32)
                    for _ in range(P)]
            flts = [rng.standard_normal(n, dtype=np.float32)
                    for _ in range(P)]
            hier_routed = {}
            for name, data in (("int32", ints), ("float32", flts)):
                before = _counts(ring)
                got = A.run(program("allreduce", n, data, "hierarchical",
                                    "served"), timeout=300)
                hier_routed[name] = list(_launched(ring, before))
                want = B.run(program("allreduce", n, data, "flat",
                                     "forced"), timeout=300)
                if name == "int32":
                    for r in range(P):
                        if got[r].tobytes() != want[r].tobytes():
                            fail(f"tuning: the hierarchical route's int32 "
                                 f"allreduce rank {r} is not bitwise flat")
                else:
                    ref = np.sum([x.astype(np.float64) for x in data], 0)
                    bnd = (P - 1) * 2.0 ** -24 * np.sum(
                        [np.abs(x.astype(np.float64)) for x in data], 0)
                    for r in range(P):
                        if not (np.abs(got[r] - ref) <= bnd).all():
                            fail(f"tuning: the hierarchical route's fp32 "
                                 f"allreduce rank {r} is outside (P - 1) "
                                 f"2^-24 sum|x| of float64")
            if not any(h for h in A.accls[0]._hier_comms.values()):
                fail("tuning: the hierarchical cell was not routed through "
                     "a composer")
    finally:
        served_world.close()
    out = {"launches": {"ring_reduce_scatter":
                        ring.ring_reduce_scatter.launches,
                        "ring_all_gather": ring.ring_all_gather.launches},
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "tuning", "ranks": P, "card": card_line(),
          "cells": len(table.entries),
          "winners": {k: e["algorithm"] for k, e in
                      sorted(table.entries.items())},
          "ring_threshold_installed": thr, "served": served,
          "hier_route_launches": hier_routed,
          "tune_s": tune_s, "compare_s": compare_s,
          "launches": out["launches"], "seconds": out["seconds"]})
    return out


#: the online tuner's drill on the card: elements per rank of its fp32
#: allreduce (4 MiB, the static ring threshold: the ring lane)
ONLINE_COUNT = 1 << 20
#: the online phase's A/B margin (the tuner's default hysteresis)
ONLINE_HYSTERESIS = 1.05
#: calls behind each of the drill's p50s (warm, degraded, after): with 16
#: the after/degraded ratio of an unchanged dispatch spread 0.98-1.07 on
#: the card, past the hysteresis it is held to (PERF.md section 6)
ONLINE_CALLS = 48
#: the never-slower gate's rounds: ONLINE_CALLS calls a side, the
#: degraded dispatch and the one after the decisions alternating over
#: this many rounds (bench/online_spread.py interleaved_p50s), so drift
#: over the phase falls on both sides alike; two p50s one after the other
#: read an unchanged dispatch 1.063 x apart once (PERF.md section 6)
ONLINE_ROUNDS = 6


def _tuner_threads() -> list:
    import threading

    return [t for t in threading.enumerate()
            if t.name == "accl-online-tuner"]


#: the scripted episode of the online phase: its cell (16 MiB fp32
#: allreduce, above the static ring threshold: the ring lane) and the lane
#: the script makes win
SCRIPTED_BUCKET = "<=16MiB"
SCRIPTED_LANE = "compress_fp16"


def scripted_install(ring, world, tuner) -> dict:
    """Phase 7g's install that happens on every run.  The drill's A/B
    times host-staged calls, whose lanes tie on one card, so an install
    there is a coin flip (PERF.md section 7).  Here the shortlist and
    the A/B are scripted (SCRIPTED_LANE at twice the incumbent's busbw),
    and the rest is the tuner's own path on the drill's world: a finding
    on the SCRIPTED_BUCKET cell, step(), the install and its fence on
    every rank.  A plan captured before the install raises on replay
    and launches no ring kernel; one captured after it replays bitwise
    its eager call; the cell's p50 (rank 2 still sleeping) over
    ONLINE_CALLS // 3 calls before and after the install, the after p50
    within the drill's never-slower bound (1.5 x)."""
    from accl_tpu_torch import ACCLError, ReduceFunction
    from accl_tpu_torch.bench import sweep as _sweep
    from accl_tpu_torch.tuning import autotune, online

    count = autotune.bucket_bytes(SCRIPTED_BUCKET) // 4
    f32 = np.dtype(np.float32)
    n = ONLINE_CALLS // 3
    rng = np.random.default_rng(SEED + 37)
    data = [rng.standard_normal(count, dtype=np.float32) for _ in range(P)]
    bufs, plans = {}, {}

    def capture(a, r):
        s = a.create_buffer_like(data[r])
        o = a.create_buffer(count, np.float32)
        bufs[r] = (s, o)
        plans[r] = a.capture_plan(
            lambda acc: acc.allreduce(s, o, count, ReduceFunction.SUM),
            timeout_s=120)
        return o.host.copy()

    def p50_us():
        return statistics.median(
            _sweep._run_once(world, "allreduce", count, f32, 0)
            for _ in range(n)) * 1e6

    world.run(capture, timeout=300)
    p50_before = p50_us()
    real = (online.cell_candidates, online.ab_cell)
    online.cell_candidates = lambda *a, **k: [(SCRIPTED_LANE, 2.0)]
    online.ab_cell = lambda *a, **k: (1.0, 2.0)
    try:
        tuner.on_findings([{
            "collective": "allreduce", "dtype": "float32",
            "size_bucket": SCRIPTED_BUCKET, "axis": "p50_us", "ratio": 2.0,
            "kind": "latency", "live": 2 * p50_before, "baseline": p50_before,
            "threshold": 1.5, "baseline_source": "chip_smoke scripted"}])
        ep = tuner.step()
    finally:
        online.cell_candidates, online.ab_cell = real
    if ep is None or ep["decision"] != "installed":
        fail(f"online_tuning: the scripted episode did not install: {ep}")
    before = _counts(ring)

    def stale(a, r):
        try:
            plans[r].replay()
        except ACCLError:
            return True
        return False

    if not all(world.run(stale, timeout=300)) or _counts(ring) != before:
        fail("online_tuning: a plan captured before the install replayed "
             f"(ring launches {_launched(ring, before)})")
    eager = world.run(capture, timeout=300)

    def replay(a, r):
        plans[r].replay()
        return bufs[r][1].host.copy()

    for r, (e, g) in enumerate(zip(eager, world.run(replay, timeout=300))):
        if e.tobytes() != g.tobytes():
            fail(f"online_tuning: rank {r}'s plan re-captured after the "
                 f"install is not bitwise its eager call")
    for s_, o in bufs.values():
        s_.free()
        o.free()
    p50_after = p50_us()
    if p50_after > 1.5 * p50_before:
        fail(f"online_tuning: the scripted install's p50 {p50_after:.0f} "
             f"us is more than 1.5 x the {p50_before:.0f} us before it")
    return {"episode": ep["seq"], "cell": ep["cell"],
            "lane": SCRIPTED_LANE, "p50_before_us": p50_before,
            "p50_after_us": p50_after, "stale_replay_raised": True,
            "recaptured_bitwise": True}


def never_slower(world, tuner, before: dict) -> dict:
    """The online phase's gate reading: the p50s of the degraded dispatch
    (every cell whose entry differs from ``before`` set back to it) and
    of the dispatch after the decisions, over ONLINE_ROUNDS alternating
    rounds of ONLINE_CALLS calls a side (the drill's call), the cells
    left as the decisions set them.  Nothing to set when no cell
    changed."""
    from accl_tpu_torch.bench import online_spread as OSP
    from accl_tpu_torch.observability import flight as FLT

    after = copy.deepcopy(tuner.table.entries)
    changed = sorted(k for k in set(before) | set(after)
                     if before.get(k) != after.get(k))

    def setter(entries):
        if not changed:
            return None
        return lambda: [tuner._apply_swap(k, entries.get(k),
                                          event=FLT.RETUNE_EVENT)
                        for k in changed]

    try:
        deg, post = OSP.interleaved_p50s(
            world, ONLINE_CALLS, ONLINE_ROUNDS, setter(before),
            setter(after), count=ONLINE_COUNT)
    finally:
        if changed:
            setter(after)()
    return {"p50_degraded_us": deg, "p50_post_us": post,
            "ratio": post / deg, "rounds": ONLINE_ROUNDS,
            "calls_a_side": ONLINE_CALLS, "cells_toggled": changed}


def online_tuning_phase(ring, CudaWorld) -> dict:
    """Phase 7g: the online tuner on the card, with ACCL_FABRIC=8 (one
    axis: no composed lane).  (a) ACCL_TUNE_ONLINE=1 makes a fresh
    CudaWorld(8) build the tuner and start its loop, and close() stops
    it (also with a 50 ms interval on an idle world); unset, no tuner is
    built.  (b) The cuda drill of accl_tpu_torch/scripts/retune_smoke.py
    on 4 MiB fp32 allreduces (rank 2 sleeping before each call; each p50
    over ONLINE_CALLS calls), with the world's own tuner at a loop
    interval of an hour, so only the drill steps it: the sentinel fires
    and step() closes episodes whose decisions are in DECISIONS; an
    installed challenger beat its incumbent by ONLINE_HYSTERESIS in the
    A/B; the p50 after the decisions is within ONLINE_HYSTERESIS of the
    degraded p50, both read in ONLINE_ROUNDS interleaved rounds
    (never_slower; when nothing installed, the dispatch is unchanged and
    this guards only against noise).  Then scripted_install's episode
    installs SCRIPTED_LANE on the SCRIPTED_BUCKET cell (its fenced
    replay, re-capture and p50 checked there), and each installed cell's
    allreduce is bitwise its served lane (served_lane; the scripted
    cell's must be SCRIPTED_LANE) forced directly on a second world.  (c) /retunes from start_exporter on a free port equals
    history_doc(), and perf_doctor --ci --retunes exits 0 on it.  The
    ring launches of the phase (set to 0 before it, read after) join
    rows 1 and 2 and must be above 0."""
    import tempfile
    import urllib.request

    from accl_tpu_torch import ReduceFunction
    from accl_tpu_torch.observability import health as OH
    from accl_tpu_torch.observability import metrics as OM
    from accl_tpu_torch.observability import sentinel as OS
    from accl_tpu_torch.observability import slo as OSLO
    from accl_tpu_torch.scripts import retune_smoke as RS
    from accl_tpu_torch.tuning import autotune, online

    t_phase = time.perf_counter()
    OS.stop_sentinel()
    OSLO.stop_slo()
    env = {"ACCL_TUNE_ONLINE": "1", "ACCL_FABRIC": str(P),
           "ACCL_TUNE_ONLINE_REPS": "2",
           "ACCL_TUNE_ONLINE_HYSTERESIS": str(ONLINE_HYSTERESIS),
           "ACCL_TUNE_ONLINE_INTERVAL_MS": "50"}
    saved = {k: os.environ.get(k) for k in env}
    saved_registry = OM._default
    os.environ.update(env)
    try:
        # (a) the env gate, with a short loop interval on an idle world
        w = CudaWorld(P)
        armed = w.online_tuner is not None \
            and online.online_tuner() is w.online_tuner \
            and len(_tuner_threads()) == 1
        time.sleep(0.3)  # a few idle loop turns
        t = time.perf_counter()
        w.close()
        close_s = time.perf_counter() - t
        if not armed or online.online_tuner() is not None \
                or _tuner_threads() or close_s > 10:
            fail(f"online_tuning: ACCL_TUNE_ONLINE=1 armed {armed}, close() "
                 f"took {close_s:.2f} s and left "
                 f"{len(_tuner_threads())} loop thread(s)")
        del os.environ["ACCL_TUNE_ONLINE"]
        with CudaWorld(P) as w:
            if w.online_tuner is not None or online.online_tuner() is not None:
                fail("online_tuning: a world built a tuner with "
                     "ACCL_TUNE_ONLINE unset")

        # (b) the drill, on the world's own tuner
        OM._default = OM.MetricsRegistry()  # the drill's calls alone
        os.environ["ACCL_TUNE_ONLINE"] = "1"
        os.environ["ACCL_TUNE_ONLINE_INTERVAL_MS"] = "3600000"
        for fn in (ring.ring_reduce_scatter, ring.ring_all_gather):
            fn.launches = fn.launches_stamp = 0
        world = CudaWorld(P)
        forced = None
        try:
            tuner = world.online_tuner
            before = copy.deepcopy(tuner.table.entries)
            lines = []
            t = time.perf_counter()
            try:
                out = RS.drill(world, "cuda", count=ONLINE_COUNT,
                               warm=ONLINE_CALLS, degraded=ONLINE_CALLS,
                               seed=SEED,
                               hysteresis=ONLINE_HYSTERESIS,
                               registry=OM._default, tuner=tuner,
                               log=lines.append)
            except RS.DrillFailed as e:
                fail(f"online_tuning: drill: {e} ({lines})")
            drill_s = time.perf_counter() - t
            drill_launches = [ring.ring_reduce_scatter.launches,
                              ring.ring_all_gather.launches]
            episodes = out["episodes"]
            for ep in episodes:
                emit({"phase": "online_episode", "seq": ep["seq"],
                      "cell": ep.get("cell"), "decision": ep["decision"],
                      "reason": ep.get("reason"),
                      "shortlist": (ep.get("hypothesis") or {}).get(
                          "shortlist"),
                      "ab": ep.get("ab"), "card": card_line()})
            installed = [ep for ep in episodes
                         if ep["decision"] == "installed"]
            for ep in installed:
                ab = ep["ab"]
                if ab["challenger_busbw_GBps"] < \
                        ab["incumbent_busbw_GBps"] * ONLINE_HYSTERESIS:
                    fail(f"online_tuning: episode {ep['seq']} installed "
                         f"without clearing the hysteresis: {ab}")
            # never-slower, in interleaved rounds: the cells the
            # decisions changed set back to their entries before the drill
            # (the degraded dispatch) and to those after, in turns, the
            # straggler still applied; with no change, one dispatch
            gate = never_slower(world, tuner, before)
            if gate["p50_post_us"] > gate["p50_degraded_us"] * \
                    ONLINE_HYSTERESIS:
                fail(f"online_tuning: p50 after the decisions "
                     f"{gate['p50_post_us']:.0f} us is more than "
                     f"{ONLINE_HYSTERESIS} x the degraded "
                     f"{gate['p50_degraded_us']:.0f} us (interleaved "
                     f"rounds: {gate})")

            # an install on every run, its fence and its p50
            scripted = scripted_install(ring, world, tuner)
            emit({"phase": "online_scripted_episode", **scripted,
                  "card": card_line()})

            # an installed cell, served, is bitwise its served lane forced
            # directly (a flat win at the static ring threshold is served
            # by the ring, as in the JAX package: served_lane)
            del os.environ["ACCL_TUNE_ONLINE"]
            forced = CudaWorld(P)
            rng = np.random.default_rng(SEED + 23)
            served = []
            thr = world.engine.ring_threshold_bytes
            for cell, entry in sorted(tuner.table.entries.items()):
                count = entry["bytes"] // 4
                data = [rng.standard_normal(count, dtype=np.float32)
                        for _ in range(P)]
                lane = served_lane(world.accls[0], "allreduce",
                                   count, entry["algorithm"], thr)
                kw = {}
                if lane == "fused":
                    kw["fused"] = True
                elif lane in autotune.COMPRESSION_ALGS:
                    kw["compress_dtype"] = autotune._compress_dtype_of(lane)
                autotune.apply_algorithm(
                    forced, lane if lane in ("flat", "ring") else "static")

                def program(extra, count=count, data=data):
                    def fn(a, r):
                        s = a.create_buffer_like(data[r])
                        o = a.create_buffer(count, np.float32)
                        a.allreduce(s, o, count, ReduceFunction.SUM,
                                    **extra)
                        res = o.host.copy()
                        s.free()
                        o.free()
                        return res
                    return fn

                got = world.run(program({}), timeout=300)
                want = forced.run(program(kw), timeout=300)
                autotune.apply_algorithm(forced, "static")
                for r in range(P):
                    if got[r].tobytes() != want[r].tobytes():
                        fail(f"online_tuning: cell {cell} (table lane "
                             f"{entry['algorithm']}) served by {lane}: "
                             f"rank {r} is not bitwise {lane} forced "
                             f"directly")
                served.append({"cell": cell,
                               "table_lane": entry["algorithm"],
                               "served_lane": lane})
            if not any(x["cell"] == scripted["cell"]
                       and x["served_lane"] == SCRIPTED_LANE
                       for x in served):
                fail(f"online_tuning: the scripted install is not served "
                     f"by {SCRIPTED_LANE}: {served}")

            # (c) /retunes through the exporter and perf_doctor --ci
            exporter = OH.start_exporter(0)
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{exporter.port}/retunes",
                        timeout=30) as resp:
                    doc = json.loads(resp.read())
            finally:
                OH.stop_exporter()
            if doc != json.loads(json.dumps(online.history_doc())) \
                    or len(doc["episodes"]) != len(episodes) + 1:
                fail("online_tuning: /retunes is not history_doc()")
            with tempfile.TemporaryDirectory() as tmp:
                hist = os.path.join(tmp, "retune_history.json")
                snap = os.path.join(tmp, "retune_metrics.json")
                with open(hist, "w") as f:
                    json.dump(doc, f)
                with open(snap, "w") as f:
                    json.dump(OM._default.snapshot(), f)
                try:
                    RS.doctor(hist, snap, os.path.join(tmp, "report.json"),
                              log=lambda *_: None)
                except RS.DrillFailed as e:
                    fail(f"online_tuning: {e}")
        finally:
            world.close()
            if forced is not None:
                forced.close()
        if online.online_tuner() is not None or _tuner_threads():
            fail("online_tuning: close() left the tuner running")
    finally:
        OM._default = saved_registry
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = {"ring_reduce_scatter": ring.ring_reduce_scatter.launches
                - ring.ring_reduce_scatter.launches_stamp,
                "ring_all_gather": ring.ring_all_gather.launches
                - ring.ring_all_gather.launches_stamp}
    if min(drill_launches) < 1:
        fail(f"online_tuning: the drill launched the ring kernels "
             f"{drill_launches} times")
    out_doc = {"launches": launches,
               "seconds": time.perf_counter() - t_phase}
    emit({"phase": "online_tuning", "ranks": P, "card": card_line(),
          "close_s_idle_50ms_loop": close_s,
          "p50_warm_us": out["p50_warm_us"],
          "p50_degraded_us": out["p50_degraded_us"],
          "p50_post_us": out["p50_post_us"],
          "drill_post_over_degraded": out["p50_post_us"]
          / out["p50_degraded_us"],
          "never_slower_gate": gate,
          "drift": out["summary"]["drift"],
          "episodes": len(episodes),
          "decisions": [ep["decision"] for ep in episodes],
          "ab_busbw_GBps": [
              [ep["ab"]["incumbent_busbw_GBps"],
               ep["ab"]["challenger_busbw_GBps"]]
              for ep in episodes if ep.get("ab")],
          "installed_served_bitwise": served,
          "retune_counters": out["summary"]["retune_counters"],
          "drill_ring_launches": drill_launches,
          "drill_s": drill_s, "launches": launches,
          "seconds": out_doc["seconds"]})
    return out_doc


def _trace_kernels(logdir) -> list:
    """The names of the device kernel events of the Chrome traces in
    ``logdir``."""
    names = []
    for name in os.listdir(logdir):
        with open(os.path.join(logdir, name)) as f:
            doc = json.load(f)
        names += [e.get("name", "") for e in doc.get("traceEvents", [])
                  if e.get("cat") == "kernel"]
    return names


def traced_window_phase(ring, CudaWorld, ReduceFunction) -> dict:
    """Phase 7h, its first part, run right after the build (the first
    torch.profiler session of the process: on the card machine a later
    session in a long process can lose the records of its last kernels,
    PERF.md section 7): traced_window("allreduce", xla_logdir=) around one
    64 MiB allreduce on a fresh CudaWorld(8) writes a torch.profiler trace
    with at least two ring_kernel device events, after one untimed
    capture that pays the profiler's start-up; the window's seconds with
    and without the capture, 3 of each, alternating.  Its ring launches
    join rows 1 and 2."""
    import tempfile

    from accl_tpu_torch.observability.trace import traced_window

    t_phase = time.perf_counter()
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather):
        fn.launches = fn.launches_stamp = 0
    count = 64 * MIB // 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    with CudaWorld(P) as world, tempfile.TemporaryDirectory() as tmp:
        sends = [world.accls[r].create_buffer(count, np.float32)
                 for r in range(P)]
        recvs = [world.accls[r].create_buffer(count, np.float32)
                 for r in range(P)]
        fill(sends, gen)

        def call(accl, rank):
            accl.allreduce(sends[rank], recvs[rank], count,
                           function=ReduceFunction.SUM, from_fpga=True,
                           to_fpga=True)

        launched = []

        def window(logdir):
            before = _counts(ring)
            t = time.perf_counter()
            with traced_window("allreduce", xla_logdir=logdir):
                world.run(call)
                torch.cuda.synchronize()
            took = time.perf_counter() - t
            launched.append(_launched(ring, before))
            return took

        world.run(call)
        torch.cuda.synchronize()
        first_capture_s = window(os.path.join(tmp, "warm"))  # profiler init
        off, on = [], []
        for i in range(3):
            off.append(window(None))
            on.append(window(os.path.join(tmp, f"t{i}")))
        names = [_trace_kernels(os.path.join(tmp, d))
                 for d in ("warm", "t0", "t1", "t2")]
        kernels = [sum("ring_kernel" in n for n in k) for k in names]
        if min(kernels) < 2:
            fail(f"utils: the traced_window traces hold {kernels} "
                 f"ring_kernel device events (want >= 2 each); ring "
                 f"launches per window {launched}; kernel events "
                 f"{[len(k) for k in names]}")
        for b in sends + recvs:
            b.free()
    launches = {"ring_reduce_scatter": ring.ring_reduce_scatter.launches,
                "ring_all_gather": ring.ring_all_gather.launches}
    return {"launches": launches,
            "seconds": time.perf_counter() - t_phase,
            "trace_ring_kernel_events": kernels,
            "first_capture_s": first_capture_s,
            "window_s_without_capture": off,
            "window_s_with_capture": on,
            "window_s_median": [statistics.median(off),
                                statistics.median(on)]}


def utils_phase(world, mp, ring, M, ar_device, trace) -> dict:
    """Phase 7h: utils on the card.  The traced_window part (``trace``,
    traced_window_phase, run after the build) is emitted here.  The
    4-layer serving model's parameters (LLAMA3_8B, TP=8, from a seed)
    through save_pytree / load_pytree and back on the card, bitwise;
    time_fn on the main world's 64 MiB allreduce beside the device ms of
    its two launches (phase 5a, split_ms); late_traced_window."""
    import tempfile

    from accl_tpu_torch.utils.checkpoint import load_pytree, save_pytree
    from accl_tpu_torch.utils.profiling import time_fn
    from accl_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather):
        fn.launches = fn.launches_stamp = 0
    mib = 64
    _s, recvs, call, _l = mp["per_size"][mib]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = M.ModelConfig(**LLAMA3_8B)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
        params = M.init_params(gen, cfg, tp=P)
        torch.cuda.synchronize()
        path = os.path.join(tmp, "serving")
        t = time.perf_counter()
        save_pytree(path, params)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        back = load_pytree(path, params)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        ckpt_bytes = os.path.getsize(path + ".npz")
        for a, b in zip(tree_leaves(params), tree_leaves(back)):
            if b.device != a.device or not same_bits(a, b):
                fail("utils: a checkpointed serving parameter did not come "
                     "back bitwise on its device")
        n_leaves = len(tree_leaves(params))
        del params, back

    ms = time_fn(lambda: (world.run(call), recvs[0].dev)[1], iters=5,
                 warmup=1) * 1e3
    late = late_traced_window(world, ring, call)
    launches = {k: v + trace["launches"][k] for k, v in (
        ("ring_reduce_scatter", ring.ring_reduce_scatter.launches),
        ("ring_all_gather", ring.ring_all_gather.launches))}
    out = {"launches": launches,
           "seconds": time.perf_counter() - t_phase + trace["seconds"]}
    emit({"phase": "utils", "card": card_line(),
          **{k: v for k, v in trace.items()
             if k not in ("launches", "seconds")},
          "trace_s": trace["seconds"],
          "checkpoint_leaves": n_leaves, "checkpoint_bytes": ckpt_bytes,
          "save_s": save_s, "load_s": load_s,
          "time_fn_ms_64MiB_allreduce": ms,
          "split_ms_device_ms_64MiB": ar_device.get(mib),
          **late, "launches": launches, "seconds": out["seconds"]})
    return out


def late_traced_window(world, ring, call) -> dict:
    """The utils phase's traced_window late in the process, where
    torch.profiler on the card can drop the device records of the
    window's kernels (PERF.md section 7): every ring launch of the
    window is either a ring_kernel device event of the trace or counted
    in xla_trace's warning of launches with no device record.  Its
    launches join the phase's."""
    import tempfile
    import warnings

    from accl_tpu_torch.observability.trace import traced_window

    before = _counts(ring)
    with tempfile.TemporaryDirectory() as tmp, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with traced_window("allreduce", xla_logdir=tmp):
            world.run(call)
            torch.cuda.synchronize()
        kernels = sum("ring_kernel" in n for n in _trace_kernels(tmp))
    launched = sum(_launched(ring, before))
    reported = [int(m.group(1)) for w in caught for m in [re.match(
        r"xla_trace: (\d+) of \d+ kernel launches", str(w.message))] if m]
    if launched < 2 or kernels + sum(reported) < launched:
        fail(f"utils: a late traced_window lost ring kernel records "
             f"without a warning: {launched} ring launches, {kernels} in "
             f"the trace, {reported} reported missing")
    return {"late_trace_ring_launches": launched,
            "late_trace_ring_kernel_events": kernels,
            "late_trace_missing_reported": sum(reported)}


def graft_phase(ring, FL) -> dict:
    """Phase 7i: accl_tpu_torch/scripts/graft_entry.py on the card:
    entry()'s forward (finite logits of the expected shape) and
    dryrun_multichip(8) (dp 2 x tp 2 x sp 2 train step with finite loss,
    the MoE step, a pipeline, zigzag and windowed sp ring attention
    against dense, the driver collectives on CudaWorld(8) with the ring
    threshold at 0).  Its ring and flash launches (set to 0 before the
    phase, read after) must each be above 0 and join rows 1-2 and
    8a-11."""
    from accl_tpu_torch.scripts import graft_entry as G

    t_phase = time.perf_counter()
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather):
        fn.launches = fn.launches_stamp = 0
    for name in FLASH_KERNELS:
        getattr(FL, name).launches = 0
    fn, args = G.entry()
    logits = fn(*args)
    torch.cuda.synchronize()
    if logits.device.type != "cuda" or tuple(logits.shape) != (2, 64, 128) \
            or not torch.isfinite(logits).all():
        fail(f"graft_entry: entry() forward gave {tuple(logits.shape)} on "
             f"{logits.device}")
    losses = G.dryrun_multichip(P)
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"graft_entry: dryrun_multichip losses {losses}")
    launches = {"ring_reduce_scatter": ring.ring_reduce_scatter.launches,
                "ring_all_gather": ring.ring_all_gather.launches,
                **{name: getattr(FL, name).launches
                   for name in FLASH_KERNELS}}
    fwd = launches["flash_fwd_resident"] + launches["flash_fwd_grid"]
    if min(launches["ring_reduce_scatter"], launches["ring_all_gather"],
           fwd, launches["flash_bwd_dq"], launches["flash_bwd_dkv"]) < 1:
        fail(f"graft_entry: a kernel of the dry run never launched: "
             f"{launches}")
    out = {"launches": launches, "seconds": time.perf_counter() - t_phase}
    emit({"phase": "graft_entry", "card": card_line(), **losses,
          "entry_logits_shape": list(logits.shape),
          "launches": launches, "seconds": out["seconds"]})
    return out


#: the plan phase's collectives: (kind, elements per rank of the operand)
PLAN_CASES = (("allreduce", 1024), ("allreduce", 1 << 20),
              ("reduce_scatter", 1 << 20), ("allgather", 1 << 20))
PLAN_REPLAYS = 20
#: the async window of the batching check: calls per rank, elements each
BATCH_WINDOW = (64, 1024)


def plan_path(world, ring, F) -> dict:
    """Phase 4g: persistent plans, batched dispatch and the sanitizer on
    the 8-rank world, driven with every launch count set to 0 just
    before it and read just after.  Each case runs eagerly, is captured
    with validate=True, then replayed PLAN_REPLAYS times on new operands
    from a torch.Generator; every replay is held bitwise to an eager call
    on the same operands and to the plain version (the ring's plain
    composition on the ring lane, the rank-axis sum below it), and must
    make the eager call's launches.  A window of async allreduces must
    form batches whose results equal the same window under profile_sync
    (no batching), bitwise; a mismatched gang under the sanitizer must
    raise on every rank within 5 s."""
    from accl_tpu_torch import ACCLError
    from accl_tpu_torch.analysis import sanitizer

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    eng = world.engine
    reset_counts(ring, F)
    per_case = []
    plans_kept = []
    stats0 = world.devices[0].engine_stats()
    for kind, n in PLAN_CASES:
        m = n // P
        out_len = {"allreduce": n, "allgather": n * P,
                   "reduce_scatter": m}[kind]
        cnt = m if kind == "reduce_scatter" else n
        sends = [world.accls[r].create_buffer(n, np.float32)
                 for r in range(P)]
        outs = [world.accls[r].create_buffer(out_len, np.float32)
                for r in range(P)]
        eager = [world.accls[r].create_buffer(out_len, np.float32)
                 for r in range(P)]
        ring_lane = n * 4 >= eng.ring_threshold_bytes

        def call(a, rank, res, kind=kind, cnt=cnt, sends=sends):
            getattr(a, kind)(sends[rank], res[rank], cnt, from_fpga=True,
                             to_fpga=True)

        def launches():
            return (ring.ring_reduce_scatter.launches,
                    ring.ring_all_gather.launches)

        fill(sends, gen)
        before = launches()
        world.run(lambda a, r: call(a, r, eager))
        eager_launches = tuple(b - a for a, b in zip(before, launches()))
        t0 = time.perf_counter()
        plans = world.run(lambda a, r: a.capture_plan(
            lambda a2: call(a2, r, outs), validate=True))
        capture_s = time.perf_counter() - t0
        plans_kept.append(plans)
        replay_launches = set()
        for _ in range(PLAN_REPLAYS):
            fill(sends, gen)
            before = launches()
            world.run(lambda a, r: plans[r].replay())
            replay_launches.add(tuple(b - a for a, b in
                                      zip(before, launches())))
            world.run(lambda a, r: call(a, r, eager))
            torch.cuda.synchronize()
            xs = [b.dev for b in sends]
            if not ring_lane:
                want = [torch.stack(xs).sum(0)] * P
            elif kind == "allreduce":
                want = ring.ring_all_reduce_segmented(xs, "sum", plain=True)
            elif kind == "allgather":
                want = ring.ring_all_gather_segmented(xs, plain=True)
            else:
                want = ring.ring_reduce_scatter_segmented(xs, "sum",
                                                          plain=True)
            for r in range(P):
                got = outs[r].dev
                if not torch.equal(got, eager[r].dev):
                    fail(f"plan {kind} {n}: rank {r}'s replay is not bitwise "
                         f"the eager call (max abs err "
                         f"{max_err(got, eager[r].dev)})")
                if not torch.equal(got, want[r]):
                    fail(f"plan {kind} {n}: rank {r}'s replay is not bitwise "
                         f"the plain version")
                if not torch.isfinite(got).all():
                    fail(f"plan {kind} {n}: non-finite output")
            del want
        if replay_launches != {eager_launches}:
            fail(f"plan {kind} {n}: replays launched {replay_launches}, the "
                 f"eager call {eager_launches}")
        if ring_lane and eager_launches != {
                "allreduce": (1, 1), "allgather": (0, 1),
                "reduce_scatter": (1, 0)}[kind]:
            fail(f"plan {kind} {n}: {eager_launches} launches a call")
        row = {"kind": kind, "count": n, "mib_per_rank": n * 4 / MIB,
               "ring_lane": ring_lane, "replays": PLAN_REPLAYS,
               "launches_per_replay": {"ring_reduce_scatter":
                                       eager_launches[0],
                                       "ring_all_gather": eager_launches[1]},
               "capture_s": capture_s, "bitwise_eager": True,
               "bitwise_plain": True}
        emit({"phase": "plan_path", **row})
        per_case.append(row)
    stats = world.devices[0].engine_stats()
    replays = stats["plan_replays"] - stats0["plan_replays"]
    if replays != PLAN_REPLAYS * len(PLAN_CASES) \
            or stats["plans_live"] - stats0["plans_live"] != len(PLAN_CASES):
        fail(f"plan engine stats: {stats}")

    # -- batched dispatch: an async window, against profile_sync ----------
    K, bn = BATCH_WINDOW
    src = [world.accls[r].create_buffer(K * bn, np.float32)
           for r in range(P)]
    fill(src, gen)
    batch = {}
    for mode in ("window", "held", "single"):
        if mode == "held" and batch["window"]["batches"] > 0:
            continue  # the free-running window batched by itself
        eng.profile_sync = mode == "single"
        dst = [world.accls[r].create_buffer(K * bn, np.float32)
               for r in range(P)]
        s0 = dict(eng.stats)

        def post(a, r, dst=dst):
            return [a.allreduce(src[r].slice(i * bn, (i + 1) * bn),
                                dst[r].slice(i * bn, (i + 1) * bn), bn,
                                from_fpga=True, to_fpga=True, run_async=True)
                    for i in range(K)]

        if mode == "held":
            # the executor parked on a claimed slot while the window
            # queues, as behind a long-running gang
            with eng._ready_cv:
                eng._inline_busy = True
            try:
                reqs = world.run(post)
            finally:
                with eng._ready_cv:
                    eng._inline_busy = False
                    eng._ready_cv.notify_all()
        else:
            reqs = world.run(post)
        for rs in reqs:
            for q in rs:
                if not q.wait(60):
                    fail(f"batch window ({mode}): a call never completed")
                q.check()
        torch.cuda.synchronize()
        s1 = dict(eng.stats)
        batch[mode] = {"batches": s1["batches"] - s0["batches"],
                       "batched_gangs": s1["batched_gangs"]
                       - s0["batched_gangs"],
                       "executor_dispatches": s1["executor_dispatches"]
                       - s0["executor_dispatches"],
                       "out": [d.dev.clone() for d in dst]}
    eng.profile_sync = False
    formed = "window" if batch["window"]["batches"] > 0 else "held"
    if batch[formed]["batches"] <= 0 or batch["single"]["batches"] != 0:
        fail(f"batching: {({k: v['batches'] for k, v in batch.items()})}")
    for mode in ("window", formed):
        for a, b in zip(batch[mode]["out"], batch["single"]["out"]):
            if not torch.equal(a, b):
                fail(f"batched window ({mode}) not bitwise the single "
                     f"dispatch")
    emit({"phase": "plan_batching", "calls_per_rank": K, "count": bn,
          "formed_in": formed,
          **{mode: {k: v for k, v in row.items() if k != "out"}
             for mode, row in batch.items()}})

    # -- the sanitizer: a mismatched gang raises on every rank ------------
    sanitizer._reset_exchange()
    sanitizer.set_enabled(True)
    try:
        probe = [(world.accls[r].create_buffer(1024, np.float32),
                  world.accls[r].create_buffer(1024, np.float32))
                 for r in range(P)]

        def mismatched(a, r):
            s, d = probe[r]
            try:
                a.allreduce(s, d, 512 if r == 0 else 1024, from_fpga=True,
                            to_fpga=True)
            except ACCLError as e:
                return "call mismatch" in str(e)
            return False

        t0 = time.perf_counter()
        raised = world.run(mismatched, timeout=5)
        san_s = time.perf_counter() - t0
    finally:
        sanitizer.set_enabled(False)
        sanitizer._reset_exchange()
    if not all(raised) or san_s >= 5:
        fail(f"sanitizer: raised on {sum(raised)} of {P} ranks in {san_s} s")
    if eng.gang_assembly_snapshot():
        fail("sanitizer: a refused gang was left assembling")
    counts = read_counts(ring, F)
    out = {"launches": counts, "cases": per_case,
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "plan_sanitizer", "raised_on_ranks": sum(raised),
          "seconds": san_s})
    emit({"phase": "plan_path_done", "launches": counts,
          "engine_stats": world.devices[0].engine_stats(),
          "seconds": out["seconds"]})
    for plans in plans_kept:
        for plan in plans:
            plan.close()
    return out


def multi_card_phase(ring, CudaWorld, DataType) -> dict:
    """Phase 7j (multi_card): see the module docstring.  The ring counts
    are set to 0 just before and read just after; the per-rank-table
    form (and, with two or more cards, the cross-card mode) must
    launch."""
    from accl_tpu_torch.bench import multicard as MC

    t0 = time.perf_counter()
    report = MC.card_report()
    C = report["count"]
    emit({"phase": "multi_card_cards", "count": C, "names": report["names"],
          "peer_access": report["peer"]})
    print(report["topo"].rstrip(), flush=True)
    counters = (ring.ring_reduce_scatter, ring.ring_all_gather)
    for fn in counters:
        fn.launches = fn.launches_cross = 0
    errs = {}
    seg, N = 8 * 4099, 3 * 8 * 4099 + 13
    for dtype in ring.KERNEL_DTYPES:
        for op in ("sum", "max"):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
            xs = []
            for r in range(P):
                x = (torch.randn(N, generator=gen, device="cuda") * 1000
                     ).to(dtype)
                if op == "max" and dtype.is_floating_point:
                    x[r::97] = float("nan")
                xs.append(x)
            want = ring.ring_all_reduce_segmented(xs, op, seg, plain=True)
            one = ring.ring_all_reduce_segmented(xs, op, seg)
            with ring.rank_tables():
                calls = [ring.ring_all_reduce_segmented(xs, op, seg)
                         for _ in range(3)]
            key = f"tables_{str(dtype).split('.')[-1]}_{op}"
            errs[key] = max(max_err(c[r], want[r]) for c in calls
                            for r in range(P))
            if not all(same_bits(c[r], want[r]) and same_bits(one[r], want[r])
                       for c in calls for r in range(P)):
                fail(f"per-rank-table form ({dtype}, {op}): not bitwise the "
                     f"one-launch form and the plain composition")
    n = ring.DEFAULT_SEG_ELEMS // P
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    xs = [rand((P, n), torch.float32, gen) for _ in range(P)]
    with ring.rank_tables():
        rs = ring.ring_reduce_scatter(xs)
        ag = ring.ring_all_gather(rs)
    if not (all(same_bits(a, b) for a, b in zip(
            rs, ring.ring_reduce_scatter_plain(xs)))
            and all(same_bits(a, b) for a, b in zip(
                ag, ring.ring_all_gather_plain(rs)))):
        fail("per-rank-table form at the segment shape: not bitwise the "
             "plain versions")
    del xs, rs, ag
    lane_cards(CudaWorld, DataType, ["cuda:0"] * P)
    cross = {}
    if C >= 2:
        cross = multi_card_cross(ring, CudaWorld, DataType, C, errs)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    tables = {fn.__name__: fn.launches_cross for fn in counters}
    if 0 in tables.values():
        fail(f"multi_card: the per-rank-table form did not launch both ring "
             f"kernels: {tables}")
    emit({"phase": "multi_card", "ok": True, "cards": C,
          "seconds": time.perf_counter() - t0,
          "cross_card": ("ran" if C >= 2 else
                         "not run: this machine has one card"),
          **cross, "launches": launches, "launches_tables": tables,
          "max_abs_err": errs})
    return {"launches": launches, "launches_tables": tables, "cards": C}


def multi_card_cross(ring, CudaWorld, DataType, C, errs) -> dict:
    """The cross-card part of phase multi_card (two or more cards)."""
    from accl_tpu_torch.bench import multicard as MC

    one_a_card = [f"cuda:{c}" for c in range(C)]
    two_a_card = [f"cuda:{c}" for c in range(C) for _ in range(2)]
    out = {"ring_lane": [], "small_lanes": {}}
    for label, devices, sizes in (("one_a_card", one_a_card, (4, 16, 64, 256)),
                                  ("two_a_card", two_a_card, (4, 64))):
        Pc = len(devices)
        with CudaWorld(Pc, devices=devices) as w:
            for mib in sizes:
                count = mib * MIB // 4
                gen = torch.Generator().manual_seed(SEED + mib)
                bufs = [w.accls[r].create_buffer(count, np.float32)
                        for r in range(Pc)]
                res = [w.accls[r].create_buffer(count, np.float32)
                       for r in range(Pc)]
                for b in bufs:
                    b.dev.copy_(torch.randn(count, generator=gen))
                before = ring.ring_reduce_scatter.launches_cross
                w.run(lambda a, r: a.allreduce(bufs[r], res[r], count,
                                               from_fpga=True, to_fpga=True))
                launched = ring.ring_reduce_scatter.launches_cross - before
                want = ring.ring_all_reduce_segmented(
                    [b.dev for b in bufs], "sum", plain=True)
                for r in range(Pc):
                    if res[r].dev.device != torch.device(devices[r]) or \
                            not same_bits(res[r].dev, want[r]):
                        fail(f"cross-card allreduce ({label}, {mib} MiB): "
                             f"rank {r}'s result is not bitwise the plain "
                             f"composition on its own card")
                errs[f"cross_{label}_{mib}MiB"] = 0.0
                if launched != C:
                    fail(f"cross-card allreduce ({label}, {mib} MiB): "
                         f"{launched} reduce-scatter launches, not one per "
                         f"card ({C})")
                out["ring_lane"].append({"layout": label, "mib_per_rank": mib,
                                         "ranks": Pc,
                                         "launches_per_phase": launched})
                for b in bufs + res:
                    b.free()
                del bufs, res, want
        out["small_lanes"][label] = multi_card_lanes(CudaWorld, DataType,
                                                     devices)
    lane_cards(CudaWorld, DataType, one_a_card)
    out["lane_rows"] = []
    for lane in MC.DRIVER_LANES:
        for row in MC.driver_rows(one_a_card, [LANE_CARDS_MIB], lane=lane):
            if row["bitwise"] is not True:
                fail(f"driver lane {lane} across {C} cards: not bitwise")
            emit({"phase": "lane_cards_driver", **row})
            out["lane_rows"].append({k: row[k] for k in (
                "lane", "s_per_call", "busbw_GBps", "moves_per_call",
                "card_MiB_per_call")})
    return out


def multi_card_lanes(CudaWorld, DataType, devices) -> list:
    """Every small lane on CudaWorld(P, devices=) bitwise the same calls
    on CudaWorld(P) on one card; returns the lanes checked."""
    from accl_tpu_torch import ReduceFunction

    Pc, n = len(devices), 4096

    def lanes(accl, rank):
        rng = np.random.default_rng(SEED + rank)
        x = accl.create_buffer(n * Pc, np.float32)
        x.host[:] = rng.standard_normal(n * Pc).astype(np.float32)
        x.sync_to_device()
        y = accl.create_buffer(n * Pc, np.float32)
        got = {}
        for name, kw in (("allreduce", {}),
                         ("allreduce_max",
                          {"function": ReduceFunction.MAX}),
                         ("fused", {"fused": True}),
                         ("int8", {"compress_dtype": DataType.int8})):
            accl.allreduce(x, y, n * Pc, **kw)
            got[name] = y.host.copy()
        accl.reduce(x, y, n * Pc, root=1)
        got["reduce"] = y.host.copy() if rank == 1 else None
        accl.reduce_scatter(x, y, n)
        got["reduce_scatter"] = y.host[:n].copy()
        accl.allgather(x, y, n)
        got["allgather"] = y.host.copy()
        accl.scatter(x, y, n, root=2)
        got["scatter"] = y.host[:n].copy()
        accl.gather(x, y, n, root=0)
        got["gather"] = y.host.copy() if rank == 0 else None
        accl.alltoall(x, y, n)
        got["alltoall"] = y.host.copy()
        accl.bcast(x, n, root=1)
        got["bcast"] = x.host[:n].copy()
        accl.send(x, n, (rank + 1) % Pc, tag=5)
        accl.recv(y, n, (rank - 1) % Pc, tag=5)
        got["send_recv"] = y.host[:n].copy()
        return got

    with CudaWorld(Pc, devices=devices) as w:
        got = w.run(lanes)
        moves = w.engine.peer_moves
    with CudaWorld(Pc) as w:
        want = w.run(lanes)
    for r in range(Pc):
        for k, v in want[r].items():
            g = got[r][k]
            if (v is None) != (g is None) or (
                    v is not None and g.tobytes() != v.tobytes()):
                fail(f"multi_card small lane {k} (rank {r}, {Pc} ranks on "
                     f"{devices}): not bitwise the one-card world's")
    if not moves:
        fail("multi_card small lanes: no peer move")
    return sorted(want[0])


#: the lane_cards part of phase multi_card: MiB a rank, and the leaf of
#: its sync_gradients (Llama-3-8B's MLP-down weight, [hidden, ffn])
LANE_CARDS_MIB = 64
LANE_CARDS_LEAF = (4096, 14336)


def lane_cards(CudaWorld, DataType, devices) -> dict:
    """The fused and int8 lanes with each rank on ``devices[r]`` (phase
    multi_card): the fused allreduce, reduce-scatter and all-gather, the
    fused allreduce over the int8 wire and the int8 ring allreduce
    (threshold 0) at LANE_CARDS_MIB a rank on CudaWorld(P, devices=),
    each rank's result bitwise the same call's on CudaWorld(P) on one
    card, with the crossings and bytes a call through the engine's
    ``_move``; then sync_gradients(compress="int8", devices=) over one
    LANE_CARDS_LEAF leaf a member, error feedback off and on and
    stochastic, bitwise the one-card call, with its collectives.move
    crossings.  Emits one lane_cards line."""
    from accl_tpu_torch import parallel as S
    from accl_tpu_torch.bench import multicard as MC

    t0 = time.perf_counter()
    Pc = len(devices)
    count = LANE_CARDS_MIB * MIB // 4
    lanes = {"fused_allreduce": ("allreduce", {"fused": True}),
             "fused_reduce_scatter": ("reduce_scatter", {"fused": True}),
             "fused_allgather": ("allgather", {"fused": True}),
             "fused_int8_allreduce": ("allreduce", {
                 "fused": True, "compress_dtype": DataType.int8}),
             "int8_ring_allreduce": ("allreduce", {
                 "compress_dtype": DataType.int8})}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    data = [torch.randn(count, generator=gen, device="cuda")
            for _ in range(Pc)]
    rows = {}
    with CudaWorld(Pc, devices=devices) as w, CudaWorld(Pc) as one:
        spy = MC.MoveCount(w.engine)
        for world in (w, one):
            world.engine.ring_threshold_bytes = 0
        for name, (kind, kw) in lanes.items():
            n_in = count // Pc if kind == "allgather" else count
            n_out = count // Pc if kind == "reduce_scatter" else count
            res = {}
            for label, world in (("cards", w), ("one", one)):
                ins = [world.accls[r].create_buffer(n_in, np.float32)
                       for r in range(Pc)]
                outs = [world.accls[r].create_buffer(n_out, np.float32)
                        for r in range(Pc)]
                for b, x in zip(ins, data):
                    b.dev.copy_(x[:n_in])

                def call(accl, r):
                    arg = n_out if kind == "reduce_scatter" else n_in
                    getattr(accl, kind)(ins[r], outs[r], arg, from_fpga=True,
                                        to_fpga=True, **kw)

                before = (spy.crossings, spy.bytes, spy.card_bytes)
                samples = []
                for _ in range(3):
                    t = time.perf_counter()
                    world.run(call)
                    for d in world.engine.cards():
                        torch.cuda.synchronize(d)
                    samples.append(time.perf_counter() - t)
                if label == "cards":
                    rows[name] = {
                        "moves_per_call": (spy.crossings - before[0]) // 3,
                        "bytes_per_call": (spy.bytes - before[1]) // 3,
                        "card_bytes_per_call":
                            (spy.card_bytes - before[2]) // 3,
                        "s_per_call": statistics.median(samples)}
                else:
                    rows[name]["one_card_s_per_call"] = \
                        statistics.median(samples)
                res[label] = outs
                for b in ins:
                    b.free()
            for r in range(Pc):
                got, want = res["cards"][r].dev, res["one"][r].dev
                if got.device != torch.device(devices[r]) or \
                        not same_bits(got.to(want.device), want):
                    fail(f"lane_cards {name} (rank {r} of {Pc} on "
                         f"{sorted(set(devices))}): not bitwise the one-card "
                         f"world's, or not on its own card")
            for b in res["cards"] + res["one"]:
                b.free()
    del data
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    leaves = [torch.randn(LANE_CARDS_LEAF, generator=gen, device="cuda")
              for _ in range(Pc)]
    placed = [{"w": g.to(d)} for g, d in zip(leaves, devices)]
    for name, kw in (("sync_int8", {}),
                     ("sync_int8_ef", {"error_feedback": True}),
                     ("sync_int8_stochastic", {"stochastic": True,
                                               "seed": 7})):
        S.collectives.reset_moves()
        t = time.perf_counter()
        got = S.sync_gradients(placed, compress="int8", devices=devices, **kw)
        for d in set(devices):
            torch.cuda.synchronize(d)
        s_cards = time.perf_counter() - t
        moves = S.collectives.moves()
        want = S.sync_gradients([{"w": g} for g in leaves],
                                compress="int8", **kw)
        for r in range(Pc):
            if got[r]["w"].device != torch.device(devices[r]) or \
                    not same_bits(got[r]["w"].to(want[r]["w"].device),
                                  want[r]["w"]):
                fail(f"lane_cards {name} (member {r} of {Pc}): not bitwise "
                     f"the one-card sync_gradients")
        rows[name] = {"moves_per_call": moves, "s_per_call": s_cards}
        del got, want
    del leaves, placed
    out = {"ranks": Pc, "cards": len(set(devices)),
           "mib_per_rank": LANE_CARDS_MIB, "leaf": list(LANE_CARDS_LEAF),
           "lanes": rows, "seconds": time.perf_counter() - t0}
    emit({"phase": "lane_cards", **out})
    return out


def time_table_kernels(ring, launches_tables, C) -> list:
    """Rows of the cross-card mode (bench/multicard.py ring_launch_rows):
    on one card the per-rank-table form of 8 ranks at the driver's
    segment shape, [8, 32768] fp32 per rank; with two or more cards also
    the mode across them, one rank a card (its ms the slowest card's;
    the nccl yardstick beside).  Launches: the multi_card phase's."""
    from accl_tpu_torch.bench import multicard as MC

    counts0 = {fn: (fn.launches, fn.launches_cross) for fn in (
        ring.ring_reduce_scatter, ring.ring_all_gather)}
    n = ring.DEFAULT_SEG_ELEMS // P
    sets = [("_tables", ["cuda:0"] * P, True)]
    if C >= 2:
        sets.append(("_cross", [f"cuda:{c}" for c in range(C)], False))
    rows = []
    for suffix, devices, tables in sets:
        for r in MC.ring_launch_rows(devices, n, 50, tables):
            src = ("accl_tpu/ops/ring.py:274"
                   if r["name"] == "ring_reduce_scatter" else
                   "accl_tpu/ops/ring.py:151")
            row = {"name": r["name"] + suffix, "route": "cuda",
                   "source": "accl_tpu_torch/ops/csrc/ring.cu",
                   "replaces": src,
                   "launches": launches_tables[r["name"]],
                   "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                   "ms_per_card": r["ms_per_card"],
                   "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                   "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                   "library_call": r["library_call"],
                   "library_note": r["library_note"], "checked": True,
                   "shape": f"P={r['ranks']} on {r['cards']} card(s) x "
                            f"[{r['n']}] fp32 chunks, {r['form']} form"}
            if not r["bitwise"]:
                fail(f"{row['name']}: not bitwise its plain version")
            emit({"phase": "kernel_time", **row})
            rows.append(row)
    for fn, (a, b) in counts0.items():
        fn.launches, fn.launches_cross = a, b
    return rows


#: phase model_cards: the Llama-3-8B model's depth over several cards (all
#: 32 layers) and on one card's per-card list (cut to 2); the prompt and
#: new tokens of its greedy generate; the sp members' tokens; the AdamW
#: step's tokens (a dp member's rows x length)
MC_LAYERS = {"cards": 32, "one": 2}
MC_PROMPT = 128
MC_NEW = 4
MC_SP_TOKENS = 32768
MC_STEP_TOKENS = (2, 1024)


def _sync_all(C: int) -> None:
    for c in range(C):
        torch.cuda.synchronize(c)


#: the MoE step of phase model_cards: SGD at an lr of 1, so that the
#: update p' - p is the mean gradient itself; held to the one-card ep
#: step (one card) by relative L2 per leaf of the update within
#: MOE_UPDATE_BOUND (each ep member multiplies its own rows: another
#: summation of the replicated leaves' gradients), the loss within
#: TRAIN_LOSS_BOUND; its forward's logits bitwise
MOE_STEP_LR = 1.0
MOE_UPDATE_BOUND = 1e-3


def card_crossings(S):
    """A recorder of the crossings between cards that the model's stream
    makes (``collectives._cross`` calls with card indices: the spread,
    ``fan_out``'s fold and ``collect``), and a function that stops it and
    returns them as (source card, destination card) pairs."""
    C = S.collectives
    real, log = C._cross, []

    def cross(t, device, src, dst):
        if isinstance(src, int):
            log.append((src, dst))
        return real(t, device, src, dst)

    C._cross = cross

    def stop():
        C._cross = real
        return list(log)

    return stop


def stream_schedule(trees, layers: int) -> dict:
    """The stream's crossings a train step makes over the placed
    ``trees`` (one per data member, or per (data, sp) member) by the
    schedule: forward, the spread from each tree's hub to its other cards
    (cards - 1); backward, the exit's gradient from the hub to every
    other card (cards - 1) and, each layer, ``fan_out``'s two folds
    down the cards and back (2 (cards - 1) each; the ranks of a tp group
    on contiguous cards in rank order).  Nothing on one card."""
    fwd = back = 0
    for t in trees:
        k = len(t.places.cards) - 1
        fwd += k
        back += k + layers * 2 * 2 * k
    return {"forward": fwd, "backward": back}


def moe_update_readings(got, p0, ref, r0, T_) -> list:
    """Relative L2 per leaf of the update got - p0 against ref - r0,
    float64."""
    out = []
    for a, a0, b, b0 in zip(T_.tree_leaves(got), T_.tree_leaves(p0),
                            T_.tree_leaves(ref), T_.tree_leaves(r0)):
        du = a.double().to(b.device) - a0.double().to(b.device)
        dw = b.double() - b0.double()
        out.append(float((du - dw).norm() / max(float(dw.norm()), 1e-30)))
    return out


def model_cards_phase(ring, F, FL, M, MM, S, RA, T_) -> dict:
    """Phase 7k (model_cards): see the module docstring.  Every count is
    set to 0 just before the per-card meshes are driven and read just
    after; the references run after that."""
    from accl_tpu_torch.bench import model_cards as MCB
    from accl_tpu_torch.optim import adamw

    C = torch.cuda.device_count()
    n = min(4, C)
    cross = n >= 2
    t0 = time.perf_counter()
    slot4, slot8 = MCB._slots(n, 4), MCB._slots(n, 8)
    layers = MC_LAYERS["cards" if cross else "one"]
    cfg = M.ModelConfig(**{**LLAMA3_8B, "n_layers": layers,
                           "dtype": "bfloat16"})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    torch.cuda.empty_cache()
    full = MCB.llama_bf16(M, cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (2, TOKENS), generator=gen,
                           device="cuda")
    scfg = M.ModelConfig(**{**LLAMA3_8B, "n_layers": 2})
    base = M.init_params(gen, scfg, tp=1)
    stoks = torch.randint(0, scfg.vocab,
                          (2 * MC_STEP_TOKENS[0], MC_STEP_TOKENS[1]),
                          generator=gen, device="cuda")
    G, H, D = LLAMA3_8B["n_kv_heads"], LLAMA3_8B["n_heads"], D_HEAD
    Tl = MC_SP_TOKENS // 4
    qkv = [torch.randn(1, MC_SP_TOKENS, h, D, generator=gen, device="cuda"
                       ).to(torch.bfloat16) for h in (H, G, G)]
    mcfg = MM.MoEConfig(**SWITCH_BASE_8)
    mfull = MM.init_params(gen, mcfg, ep=1)
    mtoks = torch.randint(0, mcfg.vocab, MOE_TOKENS, generator=gen,
                          device="cuda")
    m_, K_, N_ = MCB.tp_shapes(4)["mlp_down"]
    tp_x = [torch.randn(4 * m_, K_, generator=gen, device="cuda")
            for _ in range(4)]
    tp_w = [torch.randn(K_, N_, generator=gen, device="cuda") * 0.02
            for _ in range(4)]

    def shards(t, devs):
        return [c.to(d) for c, d in zip(t.chunk(4, dim=1), devs)]

    def tp_operands(devs):
        return ([x.to(d) for x, d in zip(tp_x, devs)],
                [w.to(d) for w, d in zip(tp_w, devs)])

    placed = M.place_params(full, cfg, S.make_mesh(tp=4, devices=slot4))
    del full  # the references are placed from `placed` (peak memory)
    smesh = S.make_mesh(dp=2, tp=2, devices=slot4)
    reps = M.place_params(base, scfg, smesh)
    step, _specs, init = M.make_train_step(
        smesh, scfg, optimizer=adamw(ADAMW_LR), params=reps)
    state = init(reps)
    sp_args = [shards(t, slot4) for t in qkv]
    zz = RA.zigzag_indices(MC_SP_TOKENS, 4).cuda()
    zz_args = [shards(t[:, zz], slot4) for t in qkv]
    mplaced = MM.place_params(mfull, mcfg, S.make_mesh(ep=8, devices=slot8))
    tp_cards = tp_operands(slot4)
    tp_card0 = tp_operands(["cuda:0"] * 4)
    _sync_all(C)

    # the per-card meshes, counted
    reset_counts(ring, F, FL)
    for fn in (ring.ring_reduce_scatter, ring.ring_all_gather,
               F.fused_matmul_reduce_scatter):
        fn.launches_cross = 0
    S.reset_moves()
    runs = {}

    def run(name, fn):
        _sync_all(C)
        t = time.perf_counter()
        out = fn()
        _sync_all(C)
        runs[name] = time.perf_counter() - t
        return out

    with torch.no_grad():
        logits = run("forward", lambda: M.forward(placed, tokens, cfg))
        gen_out = run("generate", lambda: M.generate(
            placed, tokens[:, :MC_PROMPT], cfg, MC_NEW))
        sp_out = run("sp_contiguous", lambda: RA.ring_attention(
            *sp_args, causal=True, devices=slot4))
        zz_out = run("sp_zigzag", lambda: RA.ring_attention(
            *zz_args, causal=True, schedule="zigzag", devices=slot4))
        moe_lg, _aux = run("moe_forward", lambda: MM.forward(
            mplaced, mtoks, mcfg, ep=8))
    stop = card_crossings(S)
    _p, state, loss = run("adamw_step", lambda: step(reps, state, stoks))
    crossings = stop()
    crossings_want = stream_schedule(M.placed_trees(reps),
                                     scfg.n_layers)
    mstep_mesh = S.make_mesh(ep=8, devices=slot8)
    mstep_p = MM.place_params(mfull, mcfg, mstep_mesh)
    mstep_p0 = T_.tree_map(torch.clone, MM.shard_params(mstep_p, mcfg, 8))
    mstep, _ms = MM.make_train_step(mstep_mesh, mcfg, lr=MOE_STEP_LR)
    _p, mloss = run("moe_step", lambda: mstep(mstep_p, mtoks))
    tables_before = F.fused_matmul_reduce_scatter.launches_cross
    with ring.rank_tables():
        tp_tab = run("tp_tables", lambda: F.fused_matmul_allreduce_pallas(
            *tp_card0))
    tables = F.fused_matmul_reduce_scatter.launches_cross - tables_before
    tp_cross = None
    if cross:
        tp_cross = run("tp_cross", lambda: F.fused_matmul_allreduce_pallas(
            *tp_cards))
    launches = read_counts(ring, F, FL)
    moves = S.moves()
    cross_launches = {fn.__name__: fn.launches_cross for fn in (
        ring.ring_all_gather, F.fused_matmul_reduce_scatter)}
    # row 7 counts the one-launch kernel; the mode has rows of its own
    launches["fused_matmul_reduce_scatter"] -= \
        cross_launches["fused_matmul_reduce_scatter"]
    need = ("flash_fwd_resident", "flash_bwd_dq", "flash_bwd_dkv",
            "ring_all_gather")
    missing = [k for k in need if not launches.get(k)]
    if missing or not tables or 0 in cross_launches.values():
        fail(f"model_cards: kernels of the path not launched: {missing}, "
             f"per-rank-table launches {tables}, cross {cross_launches}")
    if cross and not moves:
        fail("model_cards: no counted move across the cards")
    if len(crossings) != sum(crossings_want.values()) or (
            crossings and sum(dst == 0 for _src, dst in crossings)
            != 2 * scfg.n_layers * sum(len(t.places.cards) > 1
                                       for t in M.placed_trees(reps))):
        fail(f"model_cards: the step's stream crossings {crossings} are "
             f"not the schedule's {crossings_want}")

    # the references: the same meshes with every slot on card 0 (with one
    # card: the one-card forms); bitwise
    card0 = ["cuda:0"] * 4
    ref_params = (M.place_params(placed, cfg, S.make_mesh(tp=4, devices=card0))
                  if cross else M.shard_params(placed, cfg, 4))
    del placed
    torch.cuda.empty_cache()
    with torch.no_grad():
        checks = {
            "forward": torch.equal(logits, M.forward(ref_params, tokens,
                                                     cfg)),
            "generate": torch.equal(gen_out, M.generate(
                ref_params, tokens[:, :MC_PROMPT], cfg, MC_NEW)),
            "finite_logits": bool(torch.isfinite(logits).all())}
    del ref_params, logits
    torch.cuda.empty_cache()
    ref_devs = card0 if cross else None
    with torch.no_grad():
        for name, got, args, kw in (
                ("sp_contiguous", sp_out, [shards(t, card0) for t in qkv],
                 {}),
                ("sp_zigzag", zz_out, [shards(t[:, zz], card0) for t in qkv],
                 {"schedule": "zigzag"})):
            want = RA.ring_attention(*args, causal=True, devices=ref_devs,
                                     **kw)
            checks[name] = all(torch.equal(a.to("cuda:0"), b)
                               for a, b in zip(got, want))
        mref = (MM.place_params(mfull, mcfg, S.make_mesh(
            ep=8, devices=["cuda:0"] * 8)) if cross else
            MM.shard_params(mfull, mcfg, 8))
        want = MM.forward(mref, mtoks, mcfg, ep=8)[0]
        moe_err = float((moe_lg.to("cuda:0") - want).abs().max())
        # across cards: bitwise the card-0 mesh; on one card bitwise the
        # one-card ep forward
        moe_bitwise = torch.equal(moe_lg.to("cuda:0"), want)
        checks["moe_forward"] = moe_bitwise
        del want
    del mref, mplaced, sp_out, zz_out
    # the MoE step against the same mesh on card 0 (one card: the
    # one-card ep step, within MOE_UPDATE_BOUND a leaf)
    if cross:
        r0 = MM.place_params(mfull, mcfg, S.make_mesh(
            ep=8, devices=["cuda:0"] * 8))
        rstep, _s = MM.make_train_step(S.make_mesh(
            ep=8, devices=["cuda:0"] * 8), mcfg, lr=MOE_STEP_LR)
    else:
        r0 = T_.tree_map(torch.clone, MM.shard_params(mfull, mcfg, 8))
        rstep, _s = MM.make_train_step(S.make_mesh(ep=8), mcfg,
                                       lr=MOE_STEP_LR)
    rp0 = T_.tree_map(torch.clone, MM.shard_params(r0, mcfg, 8))
    _r, rmloss = rstep(r0, mtoks)
    got_m, want_m = MM.shard_params(mstep_p, mcfg, 8), MM.shard_params(
        r0, mcfg, 8)
    moe_upd = moe_update_readings(got_m, mstep_p0, want_m, rp0, T_)
    moe_loss_rel = abs(float(mloss) - float(rmloss)) / abs(float(rmloss))
    moe_step_bitwise = torch.equal(mloss.to("cuda:0"), rmloss) and all(
        torch.equal(a.to("cuda:0"), b) for a, b in zip(
            T_.tree_leaves(got_m), T_.tree_leaves(want_m)))
    checks["moe_step"] = moe_step_bitwise or (
        not cross and max(moe_upd) <= MOE_UPDATE_BOUND
        and moe_loss_rel <= TRAIN_LOSS_BOUND)
    del r0, rp0, got_m, want_m, mstep_p, mstep_p0, _r
    if cross:
        rmesh = S.make_mesh(dp=2, tp=2, devices=card0)
        rreps = M.place_params(base, scfg, rmesh)
        rstep, _s, rinit = M.make_train_step(
            rmesh, scfg, optimizer=adamw(ADAMW_LR), params=rreps)
        _r, _rs, rloss = rstep(rreps, rinit(rreps), stoks)
        got_leaves = [M.shard_params(r, scfg, 2) for r in reps]
        want_leaves = [M.shard_params(r, scfg, 2) for r in rreps]
    else:
        ref = M.shard_params(base, scfg, 2)
        rstep, _s, rinit = M.make_train_step(
            S.make_mesh(dp=2, tp=2), scfg, optimizer=adamw(ADAMW_LR),
            params=ref)
        _r, _rs, rloss = rstep(ref, rinit(ref), stoks)
        got_leaves = [M.shard_params(r, scfg, 2) for r in reps]
        want_leaves = [ref, ref]
    checks["adamw_step"] = torch.equal(loss, rloss) and all(
        torch.equal(a.to("cuda:0"), b)
        for g, w in zip(got_leaves, want_leaves)
        for a, b in zip(T_.tree_leaves(g), T_.tree_leaves(w)))
    _r = _rs = rreps = ref = rstep = None  # the reference's replicas, states
    one = F.fused_matmul_allreduce_pallas(*tp_card0)
    checks["tp_tables"] = all(torch.equal(a, b) for a, b in zip(tp_tab, one))
    if cross:
        checks["tp_cross"] = all(torch.equal(a.to("cuda:0"), b)
                                 for a, b in zip(tp_cross, one))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"model_cards: not bitwise the same mesh on card 0 (one card: "
             f"the one-card forms): {bad}")
    # nothing of this phase stays in the allocator's cache for the phases
    # after it
    del reps, state, base, mfull, mtoks, stoks, tokens, qkv, sp_args, \
        zz_args, tp_x, tp_w, tp_cards, tp_card0, tp_tab, tp_cross, gen_out, \
        moe_lg, one, got_leaves, want_leaves
    torch.cuda.empty_cache()
    out = {"launches": launches, "tables": tables,
           "cross": cross_launches["fused_matmul_reduce_scatter"] - tables,
           "cards": n}
    emit({"phase": "model_cards", "ok": True, "cards": n,
          "seconds": time.perf_counter() - t0, "layers": layers,
          "slots": {"tp4": slot4, "ep8": slot8},
          "cross_card": ("ran" if cross else
                         "not run: this machine has one card (the "
                         "per-card lists ran with every slot on card 0, "
                         "against the one-card forms)"),
          "cross_card_backward": (
              {"crossings": len(crossings), "schedule": crossings_want,
               "into_card0": sum(d == 0 for _s, d in crossings)}
              if cross else "not run: this machine has one card (every "
              "slot on card 0: each tree's Places.cards is (0,), the "
              "stream crosses nothing)"),
          "moe": {"forward_bitwise": moe_bitwise,
                  "forward_max_abs_err": moe_err,
                  "step_bitwise": moe_step_bitwise,
                  "step_loss_rel": moe_loss_rel,
                  "step_update_rel_l2_max": max(moe_upd),
                  "bounds": {"update": MOE_UPDATE_BOUND,
                             "loss": TRAIN_LOSS_BOUND}},
          "s": runs, "checks": sorted(checks), "moves": moves,
          "launches": launches, "launches_cross": cross_launches,
          "launches_tables": tables, "loss": float(loss)})
    return out


#: phase model_cards_sp: the model's sp axis over the phase's slots, a
#: tp 2 x sp 2 mesh (slot (t, s) = 2 t + s: with four cards each tp
#: group and each sp group spans two)
MC_SP_MESH = {"tp": 2, "sp": 2}


def sp_mesh_schedule(trees, layers: int) -> dict:
    """The launches one pass over the sp mesh of placed ``trees`` (an
    SpReplicas) makes by the schedule: the contiguous causal ring of each
    tp rank launches the flash forward once a hop for each card of its
    live members (hop 0 every member, hop h the members h..), and where
    autograd records the hop (the step) once for each live member, on
    its card, whichever share it; a step's backward launches dQ and
    dK/dV once for each of its forward launches; each block's two
    row-parallel combines launch the ring all-gather's cross-card mode
    once a card of every tp group spread over several cards (a group on
    one card sums in place, no launch)."""
    S, tp = len(trees), len(trees[0].places.devices)

    def hops(key) -> int:
        return layers * sum(len({key(s, r) for s in range(h, S)})
                            for r in range(tp) for h in range(S))

    spread = sum(len(t.places.cards) for t in trees
                 if len(t.places.cards) > 1)
    return {"flash_fwd": hops(lambda s, r: str(trees[s].places.devices[r])),
            "flash_step": hops(lambda s, r: s),
            "ring_all_gather_cross": 2 * layers * spread}


def model_cards_sp(ring, F, FL, M, S, T_) -> dict:
    """Phase model_cards_sp: the model's sp axis over the model_cards
    slots (MC_SP_MESH, every slot on card 0 with one card), Llama-3-8B
    width cut to 2 layers, attn="dense" (the ring owns attention and
    runs the flash kernels per hop): the bf16 forward over 1 x
    MC_SP_TOKENS tokens and one fp32 AdamW step over 1 x SP_TRAIN_TOKENS,
    each driven with the counts set to 0 just before it and read just
    after, its flash forward (and backward) launches and cross-card ring
    all-gathers held to sp_mesh_schedule.  Each is held to the one-card
    sp form of the same weights: the forward bitwise forward(sp=2) on the
    tp = 2 split (its max abs error reported, within SP_BOUND); the step
    against make_train_step on the one-card tp 2 x sp 2 mesh, its loss
    within TRAIN_LOSS_BOUND, each leaf's moments within
    ADAMW_MOMENT_BOUND and its update within ADAMW_UPDATE_BOUND
    (adamw_readings; the per-shard gradient fold is another summation).
    With two or more cards both are bitwise the same mesh with every slot
    on card 0."""
    from accl_tpu_torch.bench import model_cards as MCB
    from accl_tpu_torch.optim import adamw

    C = torch.cuda.device_count()
    n = min(4, C)
    cross = n >= 2
    t0 = time.perf_counter()
    slots = MCB._slots(n, 4)
    L = MC_LAYERS["one"]
    cfg = M.ModelConfig(**{**LLAMA3_8B, "n_layers": L, "attn": "dense",
                           "dtype": "bfloat16"})
    scfg = M.ModelConfig(**{**LLAMA3_8B, "n_layers": L, "attn": "dense"})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    torch.cuda.empty_cache()
    mesh = S.make_mesh(devices=slots, **MC_SP_MESH)
    one_mesh = S.make_mesh(**MC_SP_MESH)
    card0 = S.make_mesh(devices=["cuda:0"] * 4, **MC_SP_MESH)
    tp, sp = MC_SP_MESH["tp"], MC_SP_MESH["sp"]
    full = MCB.llama_bf16(M, cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (1, MC_SP_TOKENS), generator=gen,
                           device="cuda")
    placed = M.place_params(full, cfg, mesh)
    want = sp_mesh_schedule(placed, L)
    runs, launches, checks, errs = {}, {}, {}, {}

    def counted(name, fn):
        """fn() with the counts set to 0 just before and read just
        after; its flash and cross-card all-gather launches."""
        _sync_all(C)
        reset_counts(ring, F, FL)
        ring.ring_all_gather.launches_cross = 0
        t = time.perf_counter()
        out = fn()
        _sync_all(C)
        runs[name] = time.perf_counter() - t
        got = read_counts(ring, F, FL)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        runs[name + "_launches"] = {k: v for k, v in got.items() if v}
        runs[name + "_cross"] = ring.ring_all_gather.launches_cross
        return out, got

    def err_vs(a, b):
        e = 0.0
        for i in range(0, a.shape[1], 4096):
            e = max(e, float((a[:, i:i + 4096].float()
                              - b[:, i:i + 4096].float()).abs().max()))
        return e

    with torch.no_grad():
        logits, got = counted("forward", lambda: M.forward(placed, tokens,
                                                           cfg, sp=sp))
    fwd = got["flash_fwd_resident"] + got["flash_fwd_grid"]
    if fwd != want["flash_fwd"] or \
            runs["forward_cross"] != want["ring_all_gather_cross"]:
        fail(f"model_cards_sp forward: flash forward launches {fwd}, cross "
             f"all-gathers {runs['forward_cross']}, the schedule's {want}")
    if tuple(logits.shape) != (1, MC_SP_TOKENS, cfg.vocab) or \
            not torch.isfinite(logits).all():
        fail(f"model_cards_sp forward: logits {tuple(logits.shape)} not "
             f"finite")
    with torch.no_grad():
        ref = M.forward(M.shard_params(full, cfg, tp), tokens, cfg, sp=sp)
        errs["forward"] = err_vs(logits, ref)
        checks["forward_bitwise_one_card"] = torch.equal(logits, ref)
        del ref
        if cross:
            ref = M.forward(M.place_params(full, cfg, card0), tokens, cfg,
                            sp=sp)
            checks["forward_bitwise_card0"] = torch.equal(
                logits.to("cuda:0"), ref)
            del ref
    del logits, placed, full
    torch.cuda.empty_cache()

    base = M.init_params(gen, scfg, tp=1)
    stoks = torch.randint(0, scfg.vocab, (1, SP_TRAIN_TOKENS), generator=gen,
                          device="cuda")

    def adamw_step(m, params):
        step, _specs, init = M.make_train_step(
            m, scfg, optimizer=adamw(ADAMW_LR), params=params)
        state = init(params)
        _p, state, loss = step(params, state, stoks)
        return loss, state

    def on_card0(tree):
        return [t.to("cuda:0") for t in T_.tree_leaves(
            M.shard_params(tree, scfg, tp))]

    reps = M.place_params(base, scfg, mesh)
    stop = card_crossings(S)
    (loss, state), got = counted("adamw_step",
                                 lambda: adamw_step(mesh, reps))
    crossings = stop()
    crossings_want = stream_schedule(M.placed_trees(reps), L)
    if len(crossings) != sum(crossings_want.values()):
        fail(f"model_cards_sp step: the stream's crossings {crossings} are "
             f"not the schedule's {crossings_want}")
    for k in ("flash_bwd_dq", "flash_bwd_dkv"):
        if got[k] != want["flash_step"]:
            fail(f"model_cards_sp step: {k} launched {got[k]} times, the "
                 f"schedule's {want['flash_step']}")
    if got["flash_fwd_resident"] + got["flash_fwd_grid"] != \
            want["flash_step"] or \
            runs["adamw_step_cross"] != want["ring_all_gather_cross"]:
        fail(f"model_cards_sp step: launches {runs['adamw_step_launches']}, "
             f"cross {runs['adamw_step_cross']}, the schedule's {want}")
    trees = [on_card0(r) for r in reps]
    if any(not all(torch.equal(a, b) for a, b in zip(t, trees[0]))
           for t in trees[1:]):
        fail("model_cards_sp step: the sp trees took different updates")
    st = M.placed_trees(state)[0]
    st = st._replace(mu=on_card0(st.mu), nu=on_card0(st.nu))
    del reps, state
    torch.cuda.empty_cache()
    # a copy: shard_params keeps the leaves it need not split (an
    # in-place step on them would move `base`, the card-0 mesh's start)
    ref = M.shard_params(T_.tree_map(torch.clone, base), scfg, tp)
    rloss, rstate = adamw_step(one_mesh, ref)
    upd, moments, off = adamw_readings(trees[0], st, ref, rstate,
                                       update_floors(ref, M.shard_params(
                                           base, scfg, tp), T_), T_)
    errs["update_rel_l2_max"] = max(d for d, _f in upd)
    errs["rounding_floor_max"] = max(f for _d, f in upd)
    errs["moment_rel_l2_max"] = {k: max(v) for k, v in moments.items()}
    errs["adamw_loss_rel"] = abs(float(loss) - float(rloss)) / abs(
        float(rloss))
    checks["step_bitwise_one_card"] = torch.equal(loss, rloss) and all(
        torch.equal(a, b) for a, b in zip(trees[0], T_.tree_leaves(ref)))
    del ref, rstate
    if cross:
        rreps = M.place_params(base, scfg, card0)
        closs, cstate = adamw_step(card0, rreps)
        cst = M.placed_trees(cstate)[0]
        checks["step_bitwise_card0"] = torch.equal(
            loss.to("cuda:0"), closs) and all(
            torch.equal(a, b) for a, b in zip(
                trees[0] + st.mu + st.nu,
                on_card0(rreps) + on_card0(cst.mu) + on_card0(cst.nu)))
        del rreps, cstate, cst
    del base, trees, st
    torch.cuda.empty_cache()
    bounds = {"forward": SP_BOUND[torch.bfloat16],
              "adamw_loss_rel": TRAIN_LOSS_BOUND,
              "update": ADAMW_UPDATE_BOUND, "moments": ADAMW_MOMENT_BOUND}
    if off or not errs["forward"] <= bounds["forward"] or \
            not errs["adamw_loss_rel"] <= bounds["adamw_loss_rel"]:
        fail(f"model_cards_sp: off the one-card sp forms: {errs}, updates "
             f"{upd}, moments {moments}, bounds {bounds}")
    if not checks["forward_bitwise_one_card"]:
        fail(f"model_cards_sp: the forward is not bitwise the one-card "
             f"forward(sp={sp}): max abs err {errs['forward']}")
    if cross and not (checks["forward_bitwise_card0"]
                      and checks["step_bitwise_card0"]):
        fail(f"model_cards_sp: not bitwise the same mesh on card 0: {checks}")
    emit({"phase": "model_cards_sp", "ok": True, "cards": n,
          "mesh": MC_SP_MESH, "slots": slots, "layers": L,
          "reduced": "n_layers 32 -> 2",
          "tokens": {"forward": [1, MC_SP_TOKENS],
                     "adamw_step": [1, SP_TRAIN_TOKENS]},
          "dtype": {"forward": "bfloat16", "adamw_step": "float32"},
          "cross_card_backward": (
              {"crossings": len(crossings), "schedule": crossings_want}
              if cross else "not run: this machine has one card (every "
              "slot on card 0: each tree's Places.cards is (0,), the "
              "stream crosses nothing)"),
          "s": runs, "schedule": want, "errors": errs,
          "update_per_leaf": [d for d, _f in upd],
          "bounds": bounds, "checks": checks, "loss": float(loss),
          "seconds": time.perf_counter() - t0})
    return {"launches": launches}


#: phase cross_capture: the replays of the captured per-rank-table
#: launches (eager launches on the same tables before, between and after
#: them), the timing windows, and the teacher-forced decode steps
CAPTURE_REPLAYS = 3
CAPTURE_ITERS = 10


def cross_capture_phase(ring, F, M, S) -> dict:
    """Phase 7l (cross_capture): see the module docstring.  The launch
    counts are set to 0 just before the capture and read just after (a
    wrapper counts a launch at capture; a replay launches the captured
    ones again)."""
    from accl_tpu_torch.bench import model_cards as MCB

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    n = ring.DEFAULT_SEG_ELEMS // P
    xs = [rand((P, n), torch.float32, gen) for _ in range(P)]
    ys = [rand((n,), torch.float32, gen) for _ in range(P)]
    m_, K_, N_ = MCB.tp_shapes(4)["mlp_down"]
    tx = [ints((4 * m_, K_), torch.float32, gen) for _ in range(4)]
    tw = [ints((K_, N_), torch.float32, gen) for _ in range(4)]
    ops = {"ring_reduce_scatter_sum": lambda: ring.ring_reduce_scatter(xs),
           "ring_reduce_scatter_max": lambda: ring.ring_reduce_scatter(
               xs, "max"),
           "ring_all_gather": lambda: ring.ring_all_gather(ys),
           "fused_matmul_allreduce_pallas":
               lambda: F.fused_matmul_allreduce_pallas(tx, tw)}
    mine = F.fused_matmul_reduce_scatter_plain(
        [x.view(4, m_, K_) for x in tx], tw)
    want = {"ring_reduce_scatter_sum": ring.ring_reduce_scatter_plain(xs),
            "ring_reduce_scatter_max": ring.ring_reduce_scatter_plain(
                xs, "max"),
            "ring_all_gather": ring.ring_all_gather_plain(ys),
            "fused_matmul_allreduce_pallas": [
                g.view(4 * m_, N_) for g in ring.ring_all_gather_plain(
                    [b.view(-1) for b in mine])]}
    del mine
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())

    def eager(which=ops):
        with ring.rank_tables(), torch.cuda.stream(side):
            out = {k: f() for k, f in which.items()}
        side.synchronize()
        return out

    def capture(which):
        graph = torch.cuda.CUDAGraph()
        with ring.rank_tables():
            with torch.cuda.graph(graph, stream=side):
                out = {k: f() for k, f in which.items()}
        return graph, out

    def replay(graph, out):
        with torch.cuda.stream(side):
            for ts in out.values():
                for t in ts:
                    t.zero_()  # a replay that ran nothing shows
            graph.replay()
        side.synchronize()
        return out

    def held(got, first, what):
        for k, ts in got.items():
            if not all(same_bits(a, b) and same_bits(a, c)
                       for a, b, c in zip(ts, want[k], first[k])):
                fail(f"cross_capture: {k} ({what}) is not bitwise its "
                     f"plain version and the eager launch")

    first = eager()  # the warm-up: makes the per-rank tables on `side`
    held(first, first, "eager, before the capture")
    counters = (ring.ring_reduce_scatter, ring.ring_all_gather,
                F.fused_matmul_reduce_scatter)
    saved = {fn: (fn.launches, fn.launches_cross) for fn in counters}
    for fn in counters:
        fn.launches = fn.launches_cross = 0
    graph, static = capture(ops)
    captured = {fn.__name__: fn.launches_cross for fn in counters}
    if captured != {"ring_reduce_scatter": 2, "ring_all_gather": 2,
                    "fused_matmul_reduce_scatter": 1} or any(
            fn.launches != fn.launches_cross for fn in counters):
        fail(f"cross_capture: the graph must hold the per-rank-table "
             f"launches 2 reduce-scatters, 2 all-gathers and 1 fused: "
             f"{captured}")
    order = ["eager"]
    for i in range(CAPTURE_REPLAYS):
        held(replay(graph, static), first, f"replay {i + 1}")
        held(eager(), first, f"eager, after replay {i + 1}")
        order += [f"replay {i + 1}", "eager"]
    with torch.cuda.stream(side):
        ms_replay = cuda_ms(graph.replay, CAPTURE_ITERS)
        with ring.rank_tables():
            ms_eager = cuda_ms(lambda: [f() for f in ops.values()],
                               CAPTURE_ITERS)
    side.synchronize()
    held(eager(), first, "eager, after the timed replays")
    per_op = {}
    for name, f in ops.items():
        g1, out1 = capture({name: f})
        with torch.cuda.stream(side):
            r_ms = cuda_ms(g1.replay, CAPTURE_ITERS)
            with ring.rank_tables():
                e_ms = cuda_ms(f, CAPTURE_ITERS)
        side.synchronize()
        held(replay(g1, out1), first, "its own graph, after timing")
        per_op[name] = {"ms_replayed": r_ms, "ms_eager": e_ms}
        del g1, out1
    for fn, (a, b) in saved.items():
        fn.launches, fn.launches_cross = a, b
    del graph, static, first, xs, ys, tx, tw, want
    torch.cuda.empty_cache()
    emit({"phase": "cross_capture_kernels", "ok": True,
          "form": "per-rank tables on one card (ring.rank_tables)",
          "shapes": {"ring": f"P={P} x [{P}, {n}] fp32 (reduce-scatter), "
                             f"[{n}] (all-gather)",
                     "fused": f"P=4 x [4 x {m_}, {K_}] @ [{K_}, {N_}] fp32 "
                              f"integers, then the all-gather"},
          "captured_launches": captured, "replays": CAPTURE_REPLAYS,
          "order": order, "bitwise_plain_and_eager": True,
          "ms_per_replay": ms_replay, "ms_per_eager": ms_eager,
          "per_op": per_op, "seconds": time.perf_counter() - t0})

    # (b) the decode step of the card-0 placed mesh, with the graph
    t1 = time.perf_counter()
    cfg = M.ModelConfig(**{**LLAMA3_8B, "n_layers": MC_LAYERS["one"],
                           "dtype": "bfloat16"})
    full = MCB.llama_bf16(M, cfg, gen)
    placed = M.place_params(full, cfg, S.make_mesh(
        tp=4, devices=MCB._slots(1, 4)))
    del full
    prompt = torch.randint(0, cfg.vocab, (2, MC_PROMPT), generator=gen,
                           device="cuda")
    cont = torch.randint(0, cfg.vocab, (2, GRAPH_STEPS), generator=gen,
                         device="cuda")
    captures = []
    capture_fn = M.DecodeGraph.capture

    def counted(self):
        captures.append(self.params is placed)
        return capture_fn(self)

    M.DecodeGraph.capture = counted
    try:
        with torch.no_grad(), ring.rank_tables():
            toks = M.generate(placed, prompt, cfg, MC_NEW)
    finally:
        M.DecodeGraph.capture = capture_fn
    with torch.no_grad(), ring.rank_tables():
        toks_eager = M.generate(placed, prompt, cfg, MC_NEW, graph=False)
    if captures != [True] or not torch.equal(toks, toks_eager):
        fail(f"cross_capture: generate on the placed mesh must capture its "
             f"step once ({captures}) and give graph=False's tokens")
    with torch.no_grad(), ring.rank_tables():
        ms_g, samples_g, lg_g, _x = MCB.decode_steps(
            M, placed, cfg, prompt, cont, True, [0])
        ms_e, samples_e, lg_e, _x = MCB.decode_steps(
            M, placed, cfg, prompt, cont, False, [0])
    res = {"ms_per_decode_step_replayed": ms_g,
           "ms_per_decode_step_eager": ms_e,
           "samples_replayed": samples_g, "samples_eager": samples_e,
           "logits_bitwise": bool(torch.equal(lg_g, lg_e))}
    if not res["logits_bitwise"]:
        # the weights are bf16 already: the control moves the last block's
        # w2 by about one bf16 ulp
        err = float((lg_g.float() - lg_e.float()).abs().max())
        blk = placed["blocks"][-1]
        ctl = copy.copy(placed)
        ctl["blocks"] = placed["blocks"][:-1] + [{
            **blk, "w2": [(w.float() * (1 + 2 ** -7)).to(w.dtype)
                          for w in blk["w2"]]}]
        with torch.no_grad():
            _ms, _s, lg_c, _x = MCB.decode_steps(M, ctl, cfg, prompt,
                                                 cont, False, [0])
        ctl_err = float((lg_c.float() - lg_e.float()).abs().max())
        res.update({"note": "other kernels ran under capture: logits held "
                            "within LOGIT_BOUND",
                    "max_abs_err": err, "bound": LOGIT_BOUND,
                    "control_max_abs_err": ctl_err})
        if err > LOGIT_BOUND or ctl_err <= LOGIT_BOUND:
            fail(f"cross_capture: the replayed decode step's logits are "
                 f"{err} off the eager step's (bound {LOGIT_BOUND}; the "
                 f"control {ctl_err} must exceed it)")
    del placed, lg_g, lg_e
    torch.cuda.empty_cache()
    emit({"phase": "cross_capture_decode", "ok": True,
          "config": "Llama-3-8B", "layers": MC_LAYERS["one"],
          "dtype": "bfloat16", "tp": 4, "slots": MCB._slots(1, 4),
          "prompt": MC_PROMPT, "new": MC_NEW, "steps": GRAPH_STEPS,
          "tokens_equal_graph_false": True,
          "ring_launches": "none: on one card each tp group of the "
                           "card-0 mesh sums in place",
          **res, "seconds": time.perf_counter() - t1})
    return {"captured": captured, "per_op": per_op,
            "replays": CAPTURE_REPLAYS}


def captured_rows(rows, ccap) -> None:
    """Rows ring_*_tables and fused_matmul_reduce_scatter_tables gain the
    launches phase cross_capture captured (each replayed
    CAPTURE_REPLAYS times) and the ms a launch replayed from its own
    graph beside the eager ms at the same shape."""
    ops = {"ring_reduce_scatter": ("ring_reduce_scatter_sum",
                                   "ring_reduce_scatter_max"),
           "ring_all_gather": ("ring_all_gather",),
           "fused_matmul_reduce_scatter": ("fused_matmul_allreduce_pallas",)}
    for row in rows:
        name = row["name"][:-len("_tables")]
        if not row["name"].endswith("_tables") or name not in ops:
            continue
        row["launches"] += ccap["captured"][name]
        row["captured"] = {
            "launches": ccap["captured"][name], "replays": ccap["replays"],
            **{op: ccap["per_op"][op] for op in ops[name]}}
        if name == "fused_matmul_reduce_scatter":
            row["captured"]["note"] = ("ms of the graph of "
                                       "fused_matmul_allreduce_pallas: the "
                                       "fused launch and the all-gather")
        emit({"phase": "kernel_time_captured", "name": row["name"],
              **row["captured"]})


#: phase multi_process: ranks a process (two processes on card 0), the
#: ring allreduce's MiB a rank, the AdamW steps of the dp 2 x tp 2 step
#: (dp over the processes), and the children's time limit
MP_RANKS = 4
MP_MIB = (4, 64)
MP_STEPS = 2
MP_TIMEOUT_S = 420


def _allreduce_ms(call, reps: int) -> tuple:
    """(host ms, device ms) of one call: medians over ``reps`` calls after
    one warm-up, the device's between CUDA events on the current stream,
    each call ending in a synchronize."""
    call()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        dev.append(a.elapsed_time(b))
    return statistics.median(host), statistics.median(dev)


def multi_process_phase(ring, M, S) -> dict:
    """Phase 7m (multi_process): see the module docstring.  The parent
    makes its one-process references first (the dp 2 x tp 2 AdamW step
    on card 0, the per-rank-table allreduce's times), frees them, then
    starts the two children of scripts/run_multihost_rank.py on card 0;
    each sets the ring counts to 0 just before its counted allreduces and
    reads them just after.  A child's failure fails the phase, with its
    output on the lines before."""
    import gc

    from accl_tpu_torch.bench import multicard as MC
    from accl_tpu_torch.bench import multiprocess as MPB
    from accl_tpu_torch.scripts import run_multihost_rank as RUN

    t0 = time.perf_counter()
    P2 = 2 * MP_RANKS
    n = ring.DEFAULT_SEG_ELEMS // P2
    cfg = RUN.step_config(M, "llama3-8b", MC_LAYERS["one"])
    params, tokens = RUN.step_inputs(M, cfg, "llama3-8b", "cuda:0")
    mesh = S.make_mesh(dp=2, tp=2, devices=["cuda:0"] * 4)
    ref = RUN.run_steps(M, mesh, cfg, params, tokens, MP_STEPS, ("adamw",))
    ref = ref["adamw"]
    ref_prints = [{k: RUN.fingerprint(t) for k, t in RUN.step_leaves(
        M, cfg, ref["trees"][d], ref["state"][d]).items()} for d in range(2)]
    ref_bits = [int(v.view(torch.int32)) for v in ref["losses"]]
    ref_s = ref["s_per_step"]
    del ref, params, tokens, mesh
    one = {}
    for mib in MP_MIB:
        xs = [torch.randn(mib * MIB // 4, device="cuda") for _ in range(P2)]

        def tables(xs=xs):
            with ring.rank_tables():
                return ring.ring_all_reduce(xs)

        one[mib] = _allreduce_ms(tables, 5 if mib <= 16 else 3)
        del xs, tables
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_children = time.perf_counter()
    try:
        results = MPB.children(2, [
            "--device", "cuda:0", "--ranks", str(MP_RANKS),
            "--mode", "ring,step", "--mib", ",".join(map(str, MP_MIB)),
            "--kernel-n", str(n), "--config", "llama3-8b",
            "--layers", str(MC_LAYERS["one"]), "--steps", str(MP_STEPS),
            "--opts", "adamw"], MP_TIMEOUT_S)
    except RuntimeError as e:
        print(e, flush=True)
        fail("multi_process: a child failed (its output above)")
    children_s = time.perf_counter() - t_children
    names = ("ring_reduce_scatter", "ring_all_gather")
    for p, r in enumerate(results):
        rr = r["ring"]
        if min(rr["launches_cross"][k] for k in names) <= 0 or \
                min(rr["launches_procs"][k] for k in names) <= 0:
            fail(f"multi_process: child {p} launched no cross-process ring "
                 f"kernel: {rr['launches_procs']}")
        if not rr["hierarchical_all_reduce"]["bitwise"]:
            fail(f"multi_process: child {p}'s hierarchical_all_reduce")
        st = r["step"]["adamw"]
        if st["loss_bits"] != ref_bits:
            fail(f"multi_process: child {p}'s losses {st['losses']} are not "
                 f"bitwise the one-process step's")
        want = ref_prints[st["member"]]
        bad = [k for k in want if st["fingerprints"].get(k) != want[k]]
        if bad or len(st["fingerprints"]) != len(want):
            fail(f"multi_process: child {p}'s dp member {st['member']} is not "
                 f"bitwise the one-process step's: leaves {bad[:8]}")
    sizes = []
    for i, mib in enumerate(MP_MIB):
        row = {"mib_per_rank": mib, "ranks": P2,
               "one_process_host_ms": one[mib][0],
               "one_process_device_ms": one[mib][1]}
        for p, r in enumerate(results):
            got = r["ring"]["sizes"][i]
            row[f"child{p}_host_ms"] = got["host_ms"]
            row[f"child{p}_device_ms"] = got["device_ms"]
        sizes.append(row)
        emit({"phase": "multi_process_allreduce", **row})
    launches = {k: sum(r["ring"]["launches_procs"][k] for r in results)
                for k in names}
    rows = []
    for k in names:
        got = [next(x for x in r["ring"]["kernels"] if x["name"] == k)
               for r in results]
        if not all(g["bitwise"] for g in got):
            fail(f"multi_process: {k} across processes is not bitwise its "
                 f"plain version")
        b_ms, b_by = MC.bound_ms(P2, n, P2, 1)
        row = {"name": k + "_procs", "route": "cuda",
               "source": "accl_tpu_torch/ops/csrc/ring.cu",
               "replaces": ("accl_tpu/ops/ring.py:274"
                            if k == "ring_reduce_scatter" else
                            "accl_tpu/ops/ring.py:151"),
               "launches": launches[k],
               "launches_per_call": {"per_process": 1, "processes": 2},
               "max_abs_err": max(g["max_abs_err"] for g in got),
               "ms": max(g["ms"] for g in got),
               "host_ms": max(g["host_ms"] for g in got),
               "plain_ms": max(g["plain_ms"] for g in got),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "library_note": ("torch.cuda.nccl runs inside one process; "
                                "across processes NCCL takes one rank a "
                                "card, and these 8 ranks share one card"),
               "checked": True,
               "shape": f"P={P2} in 2 processes on 1 card x [{n}] fp32 "
                        f"chunks, cross-process form"}
        emit({"phase": "kernel_time", **row})
        rows.append(row)
    emit({"phase": "multi_process", "ok": True,
          "seconds": time.perf_counter() - t0, "children_s": children_s,
          "processes": 2, "ranks": P2,
          "launches_cross": [r["ring"]["launches_cross"] for r in results],
          "launches_procs": [r["ring"]["launches_procs"] for r in results],
          "hierarchical_all_reduce": "bitwise",
          "step": {"config": "Llama-3-8B", "layers": MC_LAYERS["one"],
                   "mesh": "dp 2 (over the processes) x tp 2",
                   "optimizer": "adamw", "bitwise": True,
                   "losses": results[0]["step"]["adamw"]["losses"],
                   "one_process_s_per_step": ref_s,
                   "children_s_per_step": [
                       r["step"]["adamw"]["s_per_step"] for r in results]},
          "process_crossings": [r["process_crossings"] for r in results]})
    return {"rows": rows, "launches": launches}


def time_model_card_kernels(F, mc) -> list:
    """Rows of the fused kernel's cross-card mode (bench/model_cards.py
    fused_rows) at Llama-3-8B's MLP-down at TP = 4, fp32: its
    per-rank-table form of 4 ranks on card 0, and with two or more cards
    the mode across them, one rank a card (its ms the slowest card's; the
    nccl yardstick beside).  Launches: the model_cards phase's."""
    from accl_tpu_torch.bench import model_cards as MCB

    counts0 = (F.fused_matmul_reduce_scatter.launches,
               F.fused_matmul_reduce_scatter.launches_cross)
    sets = [("_tables", MCB._slots(1, 4), mc["tables"])]
    if mc["cards"] >= 2:
        sets.append(("_cross", [f"cuda:{c}" for c in range(mc["cards"])],
                     mc["cross"]))
    rows = []
    for suffix, devices, launched in sets:
        r = MCB.fused_rows(devices, "mlp_down", torch.float32, 5)
        row = {"name": r["name"] + suffix, "route": "cuda",
               "source": "accl_tpu_torch/ops/csrc/fused.cu",
               "kernel": "accl_fused_matmul_rs_cross",
               "replaces": "accl_tpu/ops/fused.py:476",
               "launches": launched, "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "ms_per_card": r["ms_per_card"],
               "one_launch_ms": r["one_launch_ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "library_call": r["library_call"],
               "library_note": r["library_note"], "checked": True,
               "shape": f"P={r['ranks']} on {r['cards']} card(s) x "
                        f"[{r['ranks']},{r['m']},{r['K']}] @ "
                        f"[{r['K']},{r['N']}] fp32, {r['form']} form"}
        if not (r["bitwise_integers"] and r["bitwise_one_launch"]):
            fail(f"{row['name']}: not bitwise its plain version on integers "
                 f"and the one-launch form")
        emit({"phase": "kernel_time", **row})
        rows.append(row)
    (F.fused_matmul_reduce_scatter.launches,
     F.fused_matmul_reduce_scatter.launches_cross) = counts0
    return rows


def sweep_phase(world) -> dict:
    """Phase 8: bench/sweep.py's rows at SWEEP_WIDTHS on the 8-rank world
    (host-staged calls: each row includes the copies between host and
    card, so it is no resident driver number), and the compression lanes'
    allreduce at 2^24 elements."""
    from accl_tpu_torch.bench import sweep as SW

    t0 = time.perf_counter()
    n = 0
    for colls, pows in SWEEP_WIDTHS:
        rows = SW.run_sweep(world, SW.SweepConfig(
            collectives=colls, count_pows=pows, repetitions=1))
        for row in sorted(rows, key=lambda r: (colls.index(r["collective"]),
                                               r["count"])):
            if not (row["duration_us"] > 0
                    and np.isfinite(row["busbw_GBps"])):
                fail(f"sweep row {row}")
            emit({"phase": "sweep", "ranks": P, **row})
            n += 1
    for row in SW.run_compression_sweep(world, collectives=("allreduce",),
                                        count_pows=(24,), repetitions=1):
        # lossy lanes: the bound P (2 5 sqrt(P) / 127) of
        # tests/test_quantized.py on N(0, 1) operands
        bound = 1e-4 if row["lane"] == "lossless" else \
            P * 2 * 5 * P ** 0.5 / 127
        if not (row["duration_us"] > 0 and row["max_abs_err"] <= bound):
            fail(f"compression sweep row {row}")
        emit({"phase": "sweep_compression", "ranks": P, **row})
        n += 1
    out = {"rows": n, "seconds": time.perf_counter() - t0}
    emit({"phase": "sweep_done", **out})
    return out


def callrate_phase() -> dict:
    """Phase 9: bench/callrate.py's lanes on CudaWorld(8) at
    CALLRATE_COUNTS elements, calls a second and the ratio to raw."""
    from accl_tpu_torch.bench import callrate as CR

    out = {}
    for count in CALLRATE_COUNTS:
        res = CR.run(nranks=P, count=count, iters=80, device="cuda",
                     rounds=2)
        lanes = res["lanes"]
        if min(v["calls_per_s"] for v in lanes.values()) <= 0:
            fail(f"callrate count {count}: {lanes}")
        raw_us = lanes["raw_shardmap"]["latency_us"]
        batched = lanes["driver_async"]["dispatch"]
        emit({"phase": "callrate", "ranks": P, "count": count,
              "mib_per_rank": count * 4 / MIB, "ring_lane": res["ring_lane"],
              "async_batches": batched["batches"],
              "async_batched_gangs": batched["batched_gangs"],
              "plan_vs_resident_x": res["plan_vs_resident_x"],
              "lanes": lanes,
              "host_overhead_us_vs_raw": {k: v["latency_us"] - raw_us
                                          for k, v in lanes.items()},
              "round_latencies_us": res["round_latencies_us"]})
        out[count] = res
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="4,16,64,256",
                    help="allreduce MiB per rank, comma-separated; the "
                         "largest is the one whose launches are counted")
    ap.add_argument("--no-timing", action="store_true",
                    help="build, check and drive the main path only")
    args = ap.parse_args()
    sizes = sorted(int(v) for v in args.sizes.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from accl_tpu_torch import CudaWorld, DataType, ReduceFunction
    from accl_tpu_torch.arithconfig import CompressionPolicy
    from accl_tpu_torch.ops import _build
    from accl_tpu_torch import models as M
    from accl_tpu_torch.models import moe as MM
    from accl_tpu_torch.models import moe_decode as MD
    from accl_tpu_torch import parallel as S
    from accl_tpu_torch.bench import ef_convergence as TE
    from accl_tpu_torch.bench import selfring as SR
    from accl_tpu_torch import optim as OPT
    from accl_tpu_torch.utils import tree as T_
    from accl_tpu_torch.ops import flash as FL
    from accl_tpu_torch.ops import fused as F
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.ops import quantized as q_ops
    from accl_tpu_torch.ops import reduce_ops as R
    from accl_tpu_torch.ops import ring
    RA = importlib.import_module("accl_tpu_torch.parallel.ring_attention")
    PL = {"combine_2d": R._pallas_combine_2d, "cast_2d": C._cast_2d}

    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    native = native_build_thread()  # beside nvcc; emu_world joins it
    _build.build_all()
    tc_ops = tensor_core_ops(_build._target("fused"))
    if tc_ops:
        fail(f"the matmul kernels' SASS holds {tc_ops} tensor-core "
             f"instructions: the fp32 path must not use TF32")
    bwd_tc = check_flash_bwd_sass(_build._target("flash_bwd"))
    fwd_tc = check_flash_fwd_sass(_build._target("flash"))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": _build.build_seconds,
          "fused_sass_tensor_core_ops": tc_ops,
          "flash_bwd_sass_tensor_core_ops": bwd_tc,
          "flash_fwd_sass_tensor_core_ops": fwd_tc,
          "fused_kernels": fused_kernel_info(F),
          "flash_fwd_kernels": {
              f"{dt} in, {mxu} MXU, D {d}": FL.fwd_kernel_info(d, dt, mxu)
              for dt, mxu in FLASH_DTYPES for d in FL.KERNEL_HEAD_DIMS},
          "flash_bwd_kernels": {
              f"{dt} in, {mxu} MXU": FL.bwd_kernel_info(D_HEAD, dt, mxu)
              for dt, mxu in FLASH_DTYPES},
          **plugin_kernel_info(R, C),
          "ptxas": [ln.strip() for log in _build.build_log.values()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    # the first torch.profiler session of the process (PERF.md section 7)
    trace = traced_window_phase(ring, CudaWorld, ReduceFunction)
    errs = check_kernels(ring)
    errs.update(check_fused_kernels(F))
    errs.update(check_flash_kernels(FL))
    errs.update(check_flash_bwd_kernels(FL))
    errs.update(check_plugin_kernels(R, C))
    errs.update(check_skew_kernel(FL))
    selfring = selfring_phase(ring, SR)
    # the sequence-parallel and MoE parts run before the driver's world
    # holds its rank buffers: the sp forwards hold two 16.8 GB logit tensors
    sp = sp_path(ring, F, FL, M, RA, T_)
    spt = sp_train(ring, F, FL, M, S, T_)
    uly = ulysses_phase(ring, F, FL, RA)
    moe = moe_path(ring, F, FL, MM, MD, S, T_)
    mcp = model_cards_phase(ring, F, FL, M, MM, S, RA, T_)
    mcs = model_cards_sp(ring, F, FL, M, S, T_)
    ccap = cross_capture_phase(ring, F, M, S)
    mpp = multi_process_phase(ring, M, S)
    mp = main_path(ring, F, CudaWorld, ReduceFunction, sizes)
    world = mp["world"]
    try:
        tp = tp_path(ring, F)
        lanes = driver_lanes(world, ring, F, q_ops, DataType,
                             CompressionPolicy)
        serve = serving_path(ring, F, FL, M, T_)
        train = train_path(ring, F, FL, M, S, TE, T_)
        adamw = train_adamw(ring, F, FL, M, S, T_, OPT, train)
        plugin = plugin_path(ring, F, FL, R, C, PL)
        plan = plan_path(world, ring, F)
        # the main path's launches: the sum over its parts (the self-ring
        # launches have rows of their own)
        parts = (mp, tp, lanes, serve, train, adamw, sp, spt, uly, moe,
                 plugin, plan, mcp, mcs)
        launches = {k: sum(part["launches"].get(k, 0) for part in parts)
                    for k in mp["launches"]}
        launches.update({k: sum(part["launches"].get(k, 0) for part in (
            serve, train, adamw, sp, spt, uly, moe, plugin, mcp, mcs))
            for k in FLASH_KERNELS})
        launches.update({k: plugin["launches"][k] for k in PL})
        if args.no_timing:
            emit({"phase": "main_path_done", "launches": launches})
            return 0
        per_big = dict(zip(("ring_reduce_scatter", "ring_all_gather"),
                           mp["per_size"][sizes[-1]][3]))
        rows, ar_device = time_kernels(ring, errs, launches, per_big,
                                       sizes[-1], sizes)
        rows += time_fused_kernels(ring, F, errs, launches,
                                   tp["per_call_mlp_down"])
        rows += time_model_card_kernels(F, mcp)
        rows += time_flash_kernels(FL, errs, launches, serve["per_forward"])
        rows += time_flash_bwd_kernels(FL, errs, launches, train["per_step"])
        rows += time_selfring_kernels(ring, SR, selfring["launches"])
        rows += time_plugin_kernels(R, C, FL, errs, {**plugin,
                                                     "launches": launches},
                                    PL)
        for mib, (_s, _r, call, launched) in sorted(mp["per_size"].items()):
            iters = 5
            world.run(call)
            torch.cuda.synchronize()
            samples = []
            for _ in range(3):
                t = time.perf_counter()
                for _ in range(iters):
                    world.run(call)
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t) / iters)
            s = statistics.median(samples)
            algbw = mib * MIB / s / 1e9
            # device share of the call: the device time of its two
            # launches (phase 5a, stream held), over the call's wall time
            kern_s = ar_device[mib] / 1e3
            emit({"phase": "driver_allreduce", "mib_per_rank": mib,
                  "ranks": P, "s_per_call": s, "algbw_GBps": algbw,
                  "busbw_GBps": algbw * 2 * (P - 1) / P,
                  "launches": list(launched),
                  "kernel_s_est": kern_s, "kernel_share_est": kern_s / s})
        time_lanes(world, lanes["lanes"], lanes["set_ef"])
        observed_path(world, mp)
        dtr = device_trace(world, mp, ring)
        rows += time_stamp_kernels(ring, dtr["launches"], dtr["info"])
        obs = observatory(world, ring, F)
        res = resilience_path(ring, CudaWorld)
        emu = emu_world(ring, CudaWorld, native)
        dapi = device_api_phase(ring, CudaWorld)
        tun = tuning_phase(ring, CudaWorld)
        onl = online_tuning_phase(ring, CudaWorld)
        utl = utils_phase(world, mp, ring, M, ar_device, trace)
        gft = graft_phase(ring, FL)
        mc = multi_card_phase(ring, CudaWorld, DataType)
        for row in rows:
            row["launches"] += sum(part["launches"].get(row["name"], 0)
                                   for part in (obs, res, emu, dapi, tun,
                                                onl, utl, gft, mc))
        rows += time_table_kernels(ring, mc["launches_tables"], mc["cards"])
        captured_rows(rows, ccap)
        rows += mpp["rows"]
        sweep_phase(world)
        callrate_phase()
    finally:
        world.close()
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    # the run drives one card, whatever else the host holds
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
