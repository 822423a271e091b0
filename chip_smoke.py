#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (and so exits non-zero, with no result line)
when it fails:

 1. print the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels of src/repro_torch/kernels/csrc with nvcc, one
    process per source, into build/kernels (listed in .gitignore); print the
    window-attention body's name and count the TF32 HMMAs (and FFMAs) in
    the SASS of each B1/B7 instantiation, f32 and bf16 (cuobjdump), failing
    on one with none, with each one's registers; count the 128-bit global loads of each B2 instantiation and of
    B4a and the 128-bit global stores of each B3 one and of B4b, failing
    on one with none, and print each codec-library kernel's registers;
    count the HGMMAs, TMA loads (UTMALDG) and HMMAs of each B5 forward
    instantiation (fwd_build_facts), failing unless every bf16 one runs
    wgmma fed by TMA with no mma.sync, with no spill and no wgmma that
    ptxas serialised, and print each one's registers and spills;
 3. hold every kernel against its plain PyTorch version on the card at the
    main path's shapes: window attention at the four full-width Swin-T stage
    shapes, unshifted with and without the pad-strip mask and shifted by 3,
    within ATTN_TOL, two launches on the same inputs bitwise equal, and the
    same twelve cases on bf16 qkv, each output row within BF16_TOL of its
    max |x|, two launches bitwise equal; the
    codec pair, delta on and off, bitwise, two launches bitwise equal, on
    the split-1..4 payload streams, on the codec's edge blocks
    (kernels.codec.codec_edge_blocks) at blocks 128, 256, 1024, 8192, 8320
    and 49152, and at the LM handoff's length; the quant pair (B4a/B4b),
    bitwise, two launches bitwise equal, on each full-width payload leaf, a
    length that is not a multiple of the block, an empty leaf, a bf16 leaf,
    and at blocks 8192, 49280 and 65536 the edge blocks cut a third of a
    block into the last, a view 4 bytes into its storage and one followed
    by 1e30 in its storage; flash attention (B5) at the full-width
    qwen3-1.7b prefill shape in bf16 and f32, in both dtypes with Sq < Skv
    (200 / 520), a ragged length (333 / 333) and 15 heads over 5 at head
    dim 64, at granite-moe-3b-a800m's prefill shape (24 heads over 8 at head
    dim 64), and in bf16 at head dims 16 and 32 and without the causal
    mask; B5 with a sliding window at hymba-1.5b's heads (25 over 5 at hd
    64) in bf16 and f32: its prefill shape at its window of 1024, a ragged
    1100 and Sq < Skv (200 / 1300) at that window, w = 1 (each row its own
    v row) and w >= Skv (bitwise the call without a window); flash decode
    (B6) at the full-width decode shapes of qwen3-1.7b
    and of granite in bf16 and f32 with kv_len 0, 1, one chunk of its split,
    one chunk + 1, the prompt, the full cache and a ragged 777, and on
    Hymba's ring (4, 5, 1024, 64) at kv_len 1, 1023 and 1024; B5 with a
    logit soft-cap in bf16 and f32 at qwen3-1.7b's prefill shape and at
    internvl2-26b's heads (48 over 8, hd 128), each at a binding cap of 1.0
    (which must move the plain output by more than the tolerance) and at
    Gemma 2's 50.0, windowed and capped at Hymba's shape, and at
    musicgen-medium's one query head per kv head (24 over 24, hd 64); B6
    capped on qwen3-1.7b's and InternVL's global caches and on Hymba's ring,
    and at musicgen's G = 1; a cap of 0 bitwise the call without one; each
    output row (one head's hd values at one position) within F32_TOL /
    BF16_TOL of that row's max |x|, two launches on the
    same inputs bitwise equal; B6's partial mode (out in f32 and each
    row's log-sum-exp) on each half of the full-width decode cache (two
    halves of 1040 rows, live rows B6_LENS: full, partial and none) in
    bf16 and f32, out and lse within ATTN_TOL of the plain version, -inf
    and zeros on a half with no live row, two launches bitwise equal, the
    halves merged as the ranks merge them within F32_TOL / BF16_TOL of each
    row's max of the whole default launch; per-window attention (B7) through its entry
    point, ops.window_attention, at the four Swin-T stage partitions of 4 images
    with the shifted-region mask and without one (B7's own path: its launch
    counter at 0 before, read after), then at w2 64 with hd 64, w2 81
    without a mask, w2 144 with hd 128, on rows whose keys are all masked
    (each must equal sum(v) / W2P, the TPU op's padded average) within
    ATTN_TOL, and at stage 0 in bf16 within BF16_TOL of each row's max;
    B7 at stage 0 and on the fully masked rows launched again, bitwise
    equal;
 4. the main path, once, with every launch counter at 0 before and read
    after: full-width Swin-T (544x800, random weights from a seeded
    generator, random rel_bias) for splits 1-4, four UEs each through
    SwinSplitPlan.head_jitted + ActivationCodec.compress_head
    (int8_delta_zlib), then decompress_group and tail_batched(pad_to=4);
    detections must have the expected shapes, be finite, and every kernel
    must have launched exactly as often as the path calls it.  Then the same
    path on the bf16 Swin-T (the same weights rounded to bf16, rel_bias
    f32), its counters at 0 before and read after: the same launches (B1
    132, B2 16, B3 4), bf16 payload leaves of half the f32 raw bytes, f32
    detections;
 5. one frame at split 2 on the port's CPU path at the same width: the head
    output and the tail's detections (from the card's own payload) against
    the card's within CPU_TOL, and the CPU decode of the card's payload
    bitwise equal to the card's; then the bf16 frame the same way within
    BF16_CPU_TOL, f32's gap printed beside it;
 6. time each kernel (CUDA events), its plain version and, for window
    attention, one library call over the same windows (scaled dot-product
    attention with a float mask, never called by the port), beside the
    least time the card could take: B1 per frame (its 12 calls) at batch 1
    and N_UES, f32 and bf16 (SDPA in the same dtype, its float mask too),
    back to back and with a cold L2 (kernel and SDPA), and the host time of
    one wrapper call; B7 at the stage-0 partition; B2 and B3
    at CODEC_LENGTHS (a split-1 stream, the LM handoff, an 8-UE split2
    group) back to back, each launch alone after a cold L2 and by the
    wrapper's host time a call; B4a/B4b over the split-1 payload's two
    leaves the same three ways and cold with the card held (HOLD_CYCLES)
    after the flush, their plain versions read first; then the per-split head+encode, decode and batched-tail times, f32 and bf16; B5 and
    B6 at the full-width serving shapes with scaled dot-product attention as
    their yardstick, B6 and its yardstick also with a cold L2 (L2_FLUSH_BYTES
    written before each launch); B5 at Hymba's prefill shape, windowed and
    global, beside SDPA with the same boolean mask and its bound (the live
    pairs' operations); B5 and B6 soft-capped at 50.0 at the serving shapes
    (no single PyTorch call takes a cap), and B5 at InternVL's and
    musicgen's prefill shapes beside SDPA; B6's partial mode on half the
    cache beside the default mode on the whole, back to back, with its
    plain version and bound (no PyTorch call returns a masked cache's
    log-sum-exp);
 7. the codec's modes at full width: for splits 1-4, one frame's head
    payload through raw, zlib, int8, int8_zlib and int8_delta_zlib, each
    int8 mode fused and legacy (per-tensor, the quant pair).  Every payload
    round-trips (raw and zlib to the input's bits, int8 within half a
    quantisation step) and the legacy decode is bitwise the fused decode;
    raw and compressed bytes are printed per mode and split;
 8. the paper's adaptive single-UE loop on the card: calibrate (the
    full-width head and codec measure the payloads into a cache under
    build/), train the throughput estimator (1500 samples, 250 steps), and
    run SplitInferencePipeline.run_trace over the 24-frame jammer sweep of
    examples/adaptive_split_video.py with Objective(w_privacy=3.0), once
    with the fused codec and once with the legacy one, then one run_frame
    per fixed split 1-4 with the legacy codec.  Each run starts with every
    launch counter at 0 and must launch each kernel exactly as often as the
    options in its logs imply; per frame it prints the option, delay,
    compressed bytes and the host wall time of run_frame;
 9. LM serving through its entry point, repro_torch.launch.serve.serve, at
    the full width of qwen3-1.7b (28 layers, bf16, random weights from a
    seeded generator): batch 4, prompt 2048, 32 greedy decode steps, the
    split handoff at half depth through the int8 codec.  Every launch
    counter starts at 0 and must read what the config implies (B5 once per
    layer in the prefill and once per layer across the split's head and
    tail, B6 once per layer per decode step, the codec pair once each, no
    other kernel); no logit may be non-finite; prints prefill ms, decode ms
    per token and the split's bytes and one-shot ms, then the split's parts.
    On serve's weights and prompt, prefill to S-1 plus one decode step must
    give the logits of a prefill to S: in f32 within HANDOFF_F32_TOL of the
    max |logit|, in bf16 within HANDOFF_BF16_TOL of it (bf16 rounding alone
    moves full-width logits by more than an absolute 3e-2; the bf16-vs-f32
    gap is printed);
10. the serving path on the card against the port's CPU path at full width
    and cut depth: qwen3-1.7b widths in f32 with 4 layers, batch 2, prompt
    256, prefill, 2 decode steps and the split at layer 2; every logit within
    CPU_TOL of the card's max |logit|, and the CPU decode of the card's
    split payload bitwise equal to the card's.  Then the same weights in
    bf16: the prefill -> decode gap on the card and on the CPU, each within
    HANDOFF_BF16_TOL of the max |logit|, at the size tools/lm_handoff_gap.py
    measures the JAX package's gap;
11. the multi-UE cell at the full width of Swin-T: 8 UEs on phase 4's
    weights and phase 8's calibration, the default tail buckets.  (a)
    CellSimulator.run, lock-step, fixed split2, 3 slots; (b) the same with
    fused_head=True, whose compressed bytes per UE-frame must equal (a)'s;
    (c) run_stream on RanCell(edf, tti 5 ms) with the adaptive controllers
    of examples/cell_video.py (fps 0.5, jitter 0.05 s, inflight 2, 6
    frames, budget 2.5 s).  Each run starts with every launch counter at 0
    and must launch B1, B2 and B3 exactly as often as its logs and batches
    imply, with finite detections of the expected shapes; per slot it
    prints the host wall time, the encode ms and the bytes, and per run the
    batched tail ms by bucket size;
12. the vectorized MAC (core/ran_vec.py, core/engine_vec.py) on the card
    at the sizes benchmarks/bench_scale.py calls city scale, every field
    bitwise equal to the port's CPU path or its oracle (core/ran.py):
    (a) a drain of MAC_FLOWS synthetic flows (fixed offered load,
    RanConfig(tti_s=1e-3)) per policy, against the CPU path at that size
    and the oracle at MAC_ORACLE_FLOWS (and at MAC_FLOWS for edf); it
    prints the TTIs executed, the steps run and the card's drain ms
    (median of 3 after a warm-up) beside the CPU path's and the oracle's;
    (b) MultiCellVecMac over synthetic_city(CITY_UES, CITY_CELLS), two
    slots per policy, against the oracle cell by cell, ms per slot; (c)
    phase 11(a)'s lock-step cell with a PF RanCell (tti 5 ms) and (d)
    phase 11(c)'s run_stream, both with engine="vectorized": executed,
    with phase 11's launch and detection checks, and as accounting runs,
    whose FrameLogs and CellStats must equal the python engine's.  It
    prints the wall time of the phase and of each of (a)-(d);
13. the MoE family at full width (models/layers.py: moe_apply, mla_apply),
    each part timed: (a) granite-moe-3b-a800m (32 layers, d 1536, 40
    experts top-8, GQA 24 over 8 heads, bf16) served as phase 9 serves
    qwen3-1.7b, split at layer 16: every launch counter starts at 0 and
    must read B5 32 in the prefill and 32 across the split, B6 32 x 32, the
    codec pair once each and no other kernel; no non-finite logit; prints
    prefill ms, decode ms per step, the split's bytes and one-shot ms and
    the share of routed assignments the prefill dropped at capacity factor
    1.25; (b) prefill to S-1 plus one decode step against a prefill to S on
    drop-free copies (capacity factor MOE_DROP_FREE): granite at full depth
    and deepseek at 4 layers in bf16 with every expert chosen (k = E, so a
    near-tied expert cannot swap between the two paths) within
    HANDOFF_BF16_TOL, and each at 4 layers in f32 with its own top-k within
    HANDOFF_F32_TOL; (c) phase 10's check for both models (f32, 4 layers,
    batch 2, prompt 256, prefill, 2 decode steps, the split tail at layer
    2): every MoE layer routes every token to the same experts on the card
    and the CPU, logits within CPU_TOL, the CPU decode of the card's payload
    bitwise equal; (d) deepseek-v2-lite-16b (27 layers, d 2048, MLA rank
    512, 64 experts top-6 and 2 shared, a dense layer 0, bf16) served the
    same way, split at layer 13: the codec pair once each and no other
    kernel (MLA runs none);
14. the recurrent and hybrid families at full width (models/ssm.py; the
    window and ring of models/layers.py), each part timed: (a) hymba-1.5b
    (32 layers, d 1600, 25 heads over 5 at hd 64 beside mamba heads of
    d_inner 3200 and state 16, a window of 1024 on all layers but 0, 15 and
    31, bf16) served as phase 9 serves qwen3-1.7b, split at layer 16: every
    launch counter starts at 0 and must read B5 32 in the prefill and 32
    across the split, B6 32 x 32, the codec pair once each and no other
    kernel; no non-finite logit; prints prefill ms, decode ms per step, the
    split's bytes and one-shot ms and the peak device memory; (b)
    xlstm-350m (24 layers, mLSTM but sLSTM at 8 and 16, d 1024, bf16) the
    same way, split at layer 12 (mid-run): the codec pair once each and no
    other kernel, and the sLSTM time loop's share of the prefill; (c)
    prefill to S-1 plus one decode step against a prefill to S at S =
    RECURRENT_PROMPT (1100, past the window): Hymba at full depth in bf16
    within HANDOFF_BF16_TOL, both cut to 4 layers keeping every block kind
    (RECURRENT_CUTS) in f32 within SSM_HANDOFF_F32_TOL; (d) phase 10's
    check for both cuts (f32, batch 2, prompt 1100, prefill, 2 decode
    steps, the split tail at layer 2): logits within CPU_TOL, the CPU
    decode of the card's payload bitwise equal;
15. the frontends and logit soft-capping at full width, each part timed:
    (a) musicgen-medium (48 layers, d 1536, 24 heads over 24 at hd 64, four
    codebook heads of 2048, bf16; 2048 precomputed frames in, codebook
    tokens fed back) served as phase 9 serves qwen3-1.7b, split at layer
    24: every launch counter starts at 0 and must read B5 48 in the prefill
    and 48 across the split, B6 48 x 32, the codec pair once each and no
    other kernel; no non-finite logit; a raw boundary of 25,165,824 B;
    prefill ms, decode ms per step, the split's bytes and one-shot ms, peak
    device memory; (b) internvl2-26b (48 layers, d 6144, 48 heads over 8,
    vocab 92,553, bf16; 256 precomputed patches before 1,792 text tokens)
    the same way: a raw boundary of 100,663,296 B; (c) prefill to S-1 plus
    one decode step against a prefill to S: musicgen at full depth in bf16
    decoding a frame and decoding codebook tokens (their summed embeddings
    the full prompt's last frame), InternVL decoding its last text token
    after the patches, qwen3-1.7b soft-capped at 50.0 and at 1.0, all
    within HANDOFF_BF16_TOL; each cut to 4 layers in f32 within
    HANDOFF_F32_TOL; (d) phase 10's check (f32, prefill, 2 decode steps,
    the split tail) for musicgen and the capped qwen3-1.7b cut to 4 layers
    and InternVL cut to 2 layers at batch 1 and a prompt of 264;
16. a profiler trace of phase 6's head model and batched tail at each
    split, and of the bf16 head model: the card's busy time and B1's part
    of it; then of one
    compress_head, its device encode and copy alone, and one
    decompress_group at split 1: B2/B3 beside the copies and the eager
    kernels around them (pack, delta epilogue); then of one MAC drain of
    phase 12 (a) under edf: device busy ms (and the sorts' part), idle
    share, kernels, memsets and copies per executed TTI and the host time
    of the stop-code reads; then a decode step of each MoE model of phase
    13 and of each model of phases 14 and 15 (batch 4, cache of 2048):
    device busy ms, device events and the idle share against its host-clock
    time, and Hymba's prefill with B5's part of it.  It runs last: after a
    profiler session, host-clock times later in the same process can read
    higher, and phases 6-15 and 17 time on the host clock;
17. training, run before 16: (a) B5's backward build: each
    instantiation's HGMMAs, UTMALDGs, HMMAs and atomics in its SASS and,
    when this run built it, its ptxas registers and spills (a bf16 dK/dV or
    dQ kernel without HGMMA or UTMALDG or with an HMMA, a ptxas note that
    one serialised its wgmma, any atomic, or a bf16 spill at hd <= 64
    fails); its kernels against
    flash_attention_bwd_plain on the kernel's own forward output and
    log-sum-exp, in bf16 and f32 (the f32 cases at batch 2 at most), at
    smollm-360m's train shape (8, 2048, 15 over 5, hd 64), qwen3-1.7b's
    heads at hd 128, hymba-1.5b's window of 1024 (2048 and a ragged 1100),
    caps of 1.0 and 50.0, musicgen's G = 1 and a ragged 333: dQ, dK and dV
    within F32_TOL / BF16_TOL of each (batch row, head) slice's max |x|, two
    launches bitwise equal; B5's forward at the serving shape bitwise the
    same with and without its log-sum-exp, which must match the plain
    logsumexp; (b) smollm-360m trained at full width (random weights from a
    seeded generator, the synthetic TokenStream) through its entry point,
    repro_torch.launch.train.main, with --seq 2048 --batch 8 --grad-accum 2
    --steps 20: every launch counter starts at 0 and must read, per step,
    B5's forward 2 x 64 (32 layers and their recompute under remat, per
    micro-batch) and each backward kernel 2 x 32, and no other kernel;
    finite losses and gradient norms, the last loss below the first; the
    step ms, tok/s and the run's peak memory above what was allocated
    before it; (c) smollm-360m's widths in f32 cut to 2
    layers, batch 2, seq 256: the loss and every gradient leaf on the card
    within TRAIN_CPU_TOL of the port's CPU path; (d) a restart at full
    width cut to 2 layers: four steps, a checkpoint after the second under
    build/ restored bitwise, steps 3-4 from it within RESUME_TOL of the
    straight run, the files deleted; (e) B5's backward timed (its three
    kernels back to back) beside its plain version, its bound (10 flops a
    live pair per hd at 989 TFLOP/s) and SDPA's backward through autograd
    at the same shape (never called by the port), and a profiler trace of
    one full-width train step: device busy, idle share against that
    step's own host-clock time, B5's forward and backward parts.
18. The mesh, sharding, gradient compression and the dry-run (phase 18,
    after 17): (a) ``optim.compress.compressed_psum`` on the one-rank NCCL
    group over smollm-360m's full-width gradient tree (one micro-batch of
    4 x 2048), mean and error buffers bitwise the same call on the CPU
    over a gloo group, its ms beside an fp32 all-reduce of the same
    elements and both wire byte counts; (b) MESH_STEPS steps of phase
    17's shape through ``build_train_step(mesh=make_host_mesh())`` beside
    the mesh-free step on the same weights and batches, deterministic
    algorithms on: loss, gradient norm, every parameter and moment bitwise
    equal, B5's launches per step phase 17's, each step's host ms; (c)
    ``MultiCellVecMac(mesh=...)`` over phase 12 (b)'s city, bitwise its
    reports; (d) ``launch.dryrun`` over every (arch x shape) cell at full
    size on the meta device over the 16 x 16 production mesh (DRYRUN_MESH:
    each the mesh step on rank 0's view of a stand-in group of 256 ranks,
    its collectives counted; decode on the rank's cache chunks as
    ``cache_shardings`` places them, B6's partial mode counted on its
    rows, every decode cell with all-gathers; every train cell the
    default, sequence-parallel step, ``seq_shard`` logged, with the
    all-gathers and reduce-scatters of its layers), started before phase 13 in
    DRYRUN_JOBS single-thread
    processes niced to 19 (so it takes cores the card's phases leave
    idle), its wall time; every cell OK or SKIP by the JAX dry-run's rule,
    each cell's collective bytes, smollm-360m's and qwen3-1.7b's train_4k
    per-device peak at 16 x 16; smollm-360m's train step at 8 x 2048 and
    qwen3-1.7b's prefill at 4 x 2048 estimated at 1 x 1 beside the peaks
    phases 17 (b) and 9 measured; B5's counted operations in that prefill
    equal to the bound's formula.
19. Tensor parallelism over a "model" axis (after 18): (a) B5 on head
    shards at full width: each half of qwen3-1.7b's prefill heads (8 q
    over 4 kv, bf16) bitwise the whole launch's columns; at smollm-360m's
    train shape two q slices that share kv head 0, outputs and dQ bitwise
    the whole launch's, dK/dV summed over the slices within BF16_TOL;
    (b) two ranks spawned on the one card over gloo (NCCL refuses two ranks
    on one device; both take card 0 as LOCAL_RANK 0), each first holding
    every collective the mesh code issues on CUDA tensors in f32 and bf16
    (the reduce-scatter of sequence parallelism too),
    then qwen3-1.7b's prefill at (data, model) = (1, 2), full width, batch
    4, prompt 2048, bf16, through ``build_prefill(mesh=)`` into caches of
    2080 rows: the gathered last-position logits within HANDOFF_BF16_TOL
    of max |logit| of the (1, 1) prefill on the same weights and prompt,
    B5 once a layer on 8 q over 4 kv heads, each rank's KV cache chunk
    (28, 4, 8, 1040, 128), the rows of every kv head as
    ``cache_shardings`` places them; (c) the same two
    ranks, TP_STEPS train steps of smollm-360m at (1, 2), full width in
    f32, phase 17's shape, through the default step, sequence-parallel
    (``seq_shard=True``: the residual stream each rank's half of the
    sequence between layers; its 15 heads do not split over two ranks, so
    attention runs whole on each over the gathered sequence and its
    output is cut), against the mesh-free steps on the
    same weights and batches: loss and gradient norm within TRAIN_CPU_TOL
    relative, AdamW's moments within TRAIN_CPU_TOL of each leaf's max,
    every parameter leaf within TRAIN_CPU_TOL of its max where the
    one-process |g| is at least TP_FLAT_GRAD (the CPU tests' rule; there
    within the first step's learning rate), B5's forward and backward
    launches per step phase 17's; (d) the same two ranks, TP_STEPS train
    steps of qwen3-1.7b in bf16 at full width cut to TP_BF16_LAYERS
    layers, its heads split (8 q over 4 kv a rank), once sequence-parallel
    and once with ``seq_shard=False`` (Megatron-TP alone), each: loss and
    gradient norm within BF16_TOL relative of the mesh-free steps, the
    first step's gradient (AdamW's first moment) within TP_BF16_TOL of each
    leaf's max, the launches the mesh-free step's and B5's counted
    operations and bytes, forward and backward, half of its; (e) the same
    two ranks
    decode (b)'s caches LM_GEN steps through ``build_decode_step(mesh=)``,
    teacher-forced on the greedy tokens of the (1, 1) decode: each step's
    gathered logits within HANDOFF_BF16_TOL of max |logit| of the (1, 1)
    step, both ranks' bitwise equal, B6 in its partial mode 28 times a
    step a rank and never in its default mode; then qwen3-1.7b cut to 4
    layers in f32 the same way within HANDOFF_F32_TOL; (f) hymba-1.5b cut
    to 4 layers (RECURRENT_CUTS) in f32, batch 2, prompt RECURRENT_PROMPT
    (past the window), 8 steps within HANDOFF_F32_TOL, its rings and
    global caches cut on their rows and its mamba states on their
    channels (TP_DECODE_CUTS); host ms of (b)-(f), which are not TP
    speeds (gloo stages every collective through the host and the two
    ranks share one card).
20. The examples (src/repro_torch/examples) through their entry points at
    full width, after phase 15 and before 17, beside 18 (d)'s niced pool,
    on phase 8's calibration and random weights from their seeded
    generators: (a) quickstart (split2 head, fused codec, tail, the drift
    against forward_full, the estimator trained, the controller's three
    decisions); (b) adaptive_split_video over its 40-frame jammer sweep;
    (c) cell_video at its defaults (6 UEs, 12 frames, lock-step,
    adaptive), then with --fixed split2 at 3 frames (every UE's head, the
    codec and the split tails); (d) cell_video on the event engine with
    every engine flag (--fps 0.5 --jitter 0.05 --inflight 2 --policy edf
    --mobility --chaos --trace) at 6 frames.  Each of (a)-(d) starts with
    every launch counter at 0 and must launch B1, B2 and B3 exactly as
    often as its logs and batches imply (phase 8's rule for run_frame,
    phase 11's for the cell, its tail batches recorded), with finite
    detections of the expected shapes; (d)'s trace must load and hold
    spans.  (e) split_serve_lm (launch.serve for qwen3-1.7b and hymba-1.5b
    split at half depth, prompt 32, 8 steps, batch 2) and (f) train_lm
    (``python -m repro_torch.examples.train_lm --device cuda`` in a
    process group of its own beside (a)-(e), killed with its trainers if
    the phase fails: launch.train on smollm-360m, 100 steps with a checkpoint
    every 40, then a restart with --resume to 200) run in subprocesses
    with --device cuda within EXAMPLES_TIMEOUT_S, and each serve or train
    run reports its own launches: B5 on every layer of the split and the
    prefill, B6 on every layer of each decode step and one codec pair a
    serve; B5 twice and each backward kernel once a layer and step.  Every
    logit finite and the split's bytes printed for both archs; the restart
    resumed at step 100 from the checkpoint the first run left, its loss
    at step 199 finite and below step 0's.  Each run's host wall time and
    the phase's are printed; the kernels line gives each kernel's
    launches in (a)-(f) as ``examples_launches``.

Every profiler session starts after a synchronize and idles a pad,
TRACE_PAD_S unless said otherwise, before and after its work: the profiler
keeps only the device events whose time stamps fall inside the session on
the host's clock, and the card's time stamps lag it at times, by up to 33
ms in the profiler's own warnings during this script's train step
(tools/trace_probe.py counts the events it drops).  A session that comes
back with no device event is taken again once with pads of
TRACE_RETRY_PAD_S; phase 16's codec sessions, the shortest and the ones
seen to come back empty, pad that from the first.  The script logs how
many sessions it opened and how many came back with no device event, and,
for each of the others, how long after its first launch call its first
device event starts on the profiler's time line.  It reads each session's
records as Kineto returns them, without building the profiler's event
tree.

Weights everywhere are random, from a seeded generator: payload sizes and
compression ratios are those of random weights, not of a trained detector.
The last three lines are the card's name and power limit, a JSON object
with one entry per kernel, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
N_UES = 4
N_FRAMES = 24                      # the example's jammer sweep
SPLITS = (1, 2, 3, 4)
CPU_SPLIT = 2
MODE = "int8_delta_zlib"
# kernel vs plain version on the card: both fp32, sums in other orders
ATTN_TOL = 1e-4
# card vs CPU at full width: fp32 through up to 12 blocks and the FPN, with
# cuBLAS/cuDNN against oneDNN/MKL sum orders; relative to the map's max |x|
CPU_TOL = 1e-3
# attention kernels vs plain versions on the card, relative to each output
# row's max |x|: f32 differs by sum order only; bf16 by one rounding of the
# output
F32_TOL = 1e-5
BF16_TOL = 1e-2
# the bf16 Swin-T, card vs CPU at full width, relative to each map's max |x|
# (at least 1): the two round to bf16 after products summed in other orders
# (cuBLAS/cuDNN against oneDNN), and a value that rounds the other way moves
# everything computed from it, through up to 12 blocks and the FPN.  The
# CPU test of the same model against the JAX package
# (tests/test_torch_swin_bf16.py) holds 5e-2 of each leaf's max; 1.2% seen
BF16_CPU_TOL = 5e-2
# prefill -> decode consistency, relative to the max |logit|.  f32: sum
# order only (readings 3.6e-6 at full width on the card, 1.9e-6 for the JAX
# package at 4 layers), so a cache row written or read amiss shows.  bf16:
# the JAX package's test tolerance (3e-2, tests/test_models_smoke.py) taken
# relative, since bf16 rounding alone moves the logits of a full-width model
# by more than an absolute 3e-2 (tools/lm_handoff_gap.py; PERF.md)
HANDOFF_F32_TOL = 1e-4
HANDOFF_BF16_TOL = 3e-2
LM_ARCH = "qwen3-1.7b"
LM_BATCH, LM_PROMPT, LM_GEN, LM_SPLIT = 4, 2048, 32, 0.5
# phase 13: the MoE family, each model served as phase 9 serves LM_ARCH
# (granite: GQA through B5/B6, split at layer 16; deepseek: MLA, which runs
# no kernel, split at layer 13); the consistency checks take a drop-free
# copy of each config (capacity dropping depends on the sequence length)
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
MOE_DROP_FREE = 16.0
# phase 14: the recurrent and hybrid families, each served as phase 9 serves
# LM_ARCH (hymba: B5 in every layer, windowed in 29, B6 on 3 global caches
# and 29 rings, split at layer 16; xlstm: no attention, split at layer 12,
# mid-run).  The handoff and card-vs-CPU checks take RECURRENT_PROMPT, past
# the window of 1024: the windowed B5 masks, the ring wraps and the prefill
# merge rolls (by 76); they cut each model to 4 layers keeping every block
# kind (RECURRENT_CUTS, as tools/lm_handoff_gap.py cuts them)
RECURRENT_ARCHS = ("hymba-1.5b", "xlstm-350m")
RECURRENT_CUTS = {"hymba-1.5b": dict(n_layers=4, global_attn_positions=(0, 3)),
                  "xlstm-350m": dict(n_layers=4, slstm_positions=(2,))}
RECURRENT_PROMPT = 1100
# the f32 prefill -> decode gap of a 4-layer cut at RECURRENT_PROMPT,
# relative to the max |logit|.  The JAX package's own gap at that size on
# the CPU (tools/lm_handoff_gap.py --prompt 1100 --dtypes float32, batch 2,
# seed 0): xlstm-350m 3.10e-6 of 3.154 (9.8e-7), hymba-1.5b 4.29e-6 of
# 4.130 (1.04e-6); the port's CPU path 7.2e-7 and 9.4e-7.  The limit is ten
# times the larger JAX reading: the chunkwise mLSTM, the scan and the ring
# differ from the step forms by sum order only, while a state or ring row
# written amiss moves the logits by orders of magnitude more
SSM_HANDOFF_F32_TOL = 1e-5
# phase 15: the frontends, each served as phase 9 serves LM_ARCH, split at
# layer 24 (musicgen-medium: 2048 precomputed frames in, four codebook heads
# out, 24 heads over 24, G = 1; internvl2-26b: 256 precomputed patches
# before 1,792 text tokens, 48 heads over 8, 36.99 GiB of bf16 weights), and
# logit soft-capping on LM_ARCH at Gemma 2's attn_logit_softcapping (50.0,
# which seldom binds) and at 1.0 (which binds on most scores).  (d) cuts
# InternVL to 2 layers at batch 1 and 256 patches + 8 tokens, so that its
# f32 weights on the host stay near 7.7 GB (the embedding and heads 4.55 GB)
FRONTEND_ARCHS = ("musicgen-medium", "internvl2-26b")
GEMMA2_SOFTCAP, BINDING_SOFTCAP = 50.0, 1.0
SOFTCAPS = (GEMMA2_SOFTCAP, BINDING_SOFTCAP)
INTERNVL_CPU_LAYERS = 2
INTERNVL_CPU_B, INTERNVL_CPU_S = 1, 264
# phase 17: training.  (a) B5's backward kernels against their plain version
# at TRAIN_ARCH's train shape and the other families' heads (TRAIN_BWD_CASES:
# B, S, H, KV, hd, window, cap), the f32 cases at batch 2 at most (the plain
# version holds five (B, H, S, S) f32 tensors); (b) the full-width trainer
# through repro_torch.launch.train.main with TRAIN_ARGV; (c) TRAIN_ARCH's
# widths in f32 cut to TRAIN_CPU_LAYERS, batch 2, seq 256, card vs CPU;
# (d) a restart at full width cut to TRAIN_CPU_LAYERS layers; (e) timing
TRAIN_ARCH = "smollm-360m"
TRAIN_B, TRAIN_S, TRAIN_ACCUM, TRAIN_STEPS = 8, 2048, 2, 20
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--seq", str(TRAIN_S), "--batch",
              str(TRAIN_B), "--grad-accum", str(TRAIN_ACCUM), "--steps",
              str(TRAIN_STEPS), "--log-every", "5"]
TRAIN_BWD_CASES = (
    (TRAIN_B, TRAIN_S, 15, 5, 64, 0, 0.0),    # smollm-360m's train shape
    (2, TRAIN_S, 16, 8, 128, 0, 0.0),         # qwen3-1.7b's heads
    (2, TRAIN_S, 25, 5, 64, 1024, 0.0),       # hymba-1.5b's window
    (2, 1100, 25, 5, 64, 1024, 0.0),          # ragged, past the window
    (2, 1024, 15, 5, 64, 0, 1.0),             # a binding cap
    (2, 1024, 15, 5, 64, 0, 50.0),            # Gemma 2's cap
    (2, 1024, 24, 24, 64, 0, 0.0),            # musicgen-medium's G = 1
    (2, 333, 15, 5, 64, 0, 0.0),              # ragged
)
TRAIN_CPU_LAYERS = 2
# card vs CPU in f32 (c): every gradient leaf within TRAIN_CPU_TOL of its max
# |g| and the loss within it relative; both are f32 with sums in other
# orders (cuBLAS and B5's kernels against oneDNN and the plain versions)
TRAIN_CPU_TOL = 1e-4
# a resumed run's losses against the straight run's (d), relative: the
# embedding's backward accumulates with atomics on the card, so two runs of
# one step need not give the same bits
RESUME_TOL = 1e-3

CELL_UES, CELL_FRAMES, STREAM_FRAMES = 8, 3, 6
# phase 20: the time limit of each serve subprocess, and of train_lm's pair
EXAMPLES_TIMEOUT_S = 300.0
# the vectorized MAC at the sizes benchmarks/bench_scale.py calls city scale:
# its 10,240-flow headline drain at TOTAL_BYTES of offered load (the oracle
# beside it at 1,024 flows, and at 10,240 for edf), and 4,096 UEs over 8
# cells; RanConfig(tti_s=1e-3)
MAC_FLOWS, MAC_ORACLE_FLOWS, MAC_TOTAL_BYTES = 10_240, 1_024, 2_625_000
MAC_POLICIES = ("rr", "pf", "edf")
MAC_WARM_S = 0.05                  # a warm-up advance: the first 50 TTIs
CITY_UES, CITY_CELLS, CITY_SLOTS = 4096, 8, 2
# phase 18: train steps of the mesh step beside the mesh-free one, and the
# dry-run's worker processes
MESH_STEPS = 3
DRYRUN_JOBS = 4
DRYRUN_MESH = (16, 16)             # the train and prefill cells' (data, model)
# phase 19: tensor parallelism at (data, model) = (1, 2) on two gloo ranks
# sharing the card: train steps; (c) the CPU tests' flat gradient, below
# which AdamW's update of an element may turn with a rounding (100 x its
# eps, tests/test_torch_tp_steps.py's FLAT_GRAD); (d) LM_ARCH in bf16 cut to
# TP_BF16_LAYERS layers at TP_BF16_B x TRAIN_S tokens, each leaf of its
# first gradient within TP_BF16_TOL of its max (bf16 keeps 8 bits: 5e-2 is
# 13 roundings of the max, through two layers forward and back in two sum
# orders) and the loss and gradient norm within BF16_TOL relative; the two
# ranks' time limit
TP_STEPS = 3
TP_FLAT_GRAD = 1e-6
TP_BF16_LAYERS, TP_BF16_B = 2, 4
TP_BF16_TOL = 5e-2
TP_TIMEOUT_S = 420
# phase 19 (e), (f): decode at (1, 2) of cuts in f32 against the (1, 1)
# decode, (arch, config changes, batch, prompt, decode steps): LM_ARCH at 4
# layers (every cache cut on its rows) and hymba-1.5b at RECURRENT_CUTS'
# 4 layers, a prompt past its window of 1024 (its rings of 1024 rows and
# its global caches cut on their rows, its mamba states on their channels)
TP_DECODE_CUTS = {
    "qwen_f32": (LM_ARCH, dict(n_layers=4), LM_BATCH, LM_PROMPT, LM_GEN),
    "hymba_f32": ("hymba-1.5b", RECURRENT_CUTS["hymba-1.5b"], 2,
                  RECURRENT_PROMPT, 8)}
# B6's partial mode (phases 3 and 6): the live rows of phase 6's cache per
# batch row, live in both halves, in the second in part, in the first only,
# and none
B6_LENS = [2080, 1500, 700, 0]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 on the tensor cores
L2_FLUSH_BYTES = 128 * 2**20       # written before a cold-L2 timing (L2 is 50 MB)
TRACE_TRIES = 2                    # profiler sessions before an empty trace fails
TRACE_PAD_S = 0.1                  # idle host time at each end of a session
TRACE_RETRY_PAD_S = 1.0            # the same, in a session after an empty one
TRACE_COUNT = collections.Counter()  # profiler sessions opened, and empty
# per session with a device event: (s since import, ms from the first launch
# call to the first device event's start on the profiler's time line)
TRACE_LAGS: list = []
TRACE_T0 = time.monotonic()
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
# cycles the card spins (torch.cuda._sleep, no memory traffic) after the
# flush in a "held" cold timing: about 0.2 ms at the H100's 1.98 GHz, longer
# than a wrapper's host time, so the launch is queued before the start event
# fires and the figure is the card's alone
HOLD_CYCLES = 400_000
# the card's clock as torch.cuda._sleep counts it, at the H100's boost:
# sizes the spin that cuda_ms(queued=True) puts before the calls
SPIN_HZ = 1.98e9
# B2/B3 are timed at three lengths of f32 stream: one split-1 UE frame
# (phase 4), the qwen3-1.7b split handoff (4 x 2048 x 2048, phase 9) and an
# 8-UE split2 group of the cell (phase 11(a))
CODEC_LENGTHS = {"split-1 stream": 3_923_968, "LM handoff": 16_777_216,
                 "cell group": 36_634_624}
# B4a/B4b are timed on the split-1 payload's two leaves: the stage-1 output
# and the merged tokens the head ships with it
SPLIT1_LEAVES = ((1, 136, 200, 96), (1, 68, 100, 192))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def b1_frame(cfg, dev) -> list:
    """B1's calls in one Swin-T forward, by kind: (stage, Hp, Wp, C, nh,
    shift, mask, calls a frame).  Even blocks of a stage are unshifted (the
    pad mask where the map is padded, else none), odd ones shifted by
    window // 2 with the shifted mask."""
    import torch
    from repro_torch.models import swin as SW
    w = cfg.window
    out = []
    for s in range(cfg.n_stages):
        H, W = cfg.stage_hw(s)
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        C, nh = cfg.stage_dim(s), cfg.num_heads[s]
        pad = (torch.as_tensor(SW.pad_region_mask(Hp, Wp, H, W, w), device=dev)
               if (Hp, Wp) != (H, W) else None)
        shifted = torch.as_tensor(SW.shift_attn_mask(Hp, Wp, w, w // 2),
                                  device=dev)
        out.append((s, Hp, Wp, C, nh, 0, pad, cfg.depths[s] - cfg.depths[s] // 2))
        out.append((s, Hp, Wp, C, nh, w // 2, shifted, cfg.depths[s] // 2))
    return out


def cuda_ms(fn, reps: int = 10, runs: int = 7, before=None,
            queued: bool = False) -> float:
    """Median over ``runs`` of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after a warm-up.  With ``before``, each call is timed
    alone, after ``before()`` (untimed) has run on the same stream.  With
    ``queued``, each run's calls are enqueued while the card spins
    (``torch.cuda._sleep``, no memory traffic), so they run back to back
    with no host time between them, the device's time alone: the spin is
    twice the host time of ``reps`` calls as the warm-up's last two took
    it, and a run whose enqueueing outlasted its spin on the card is taken
    again with the spin doubled."""
    import torch
    fn()
    t0 = time.perf_counter()
    fn()
    fn()
    spin = int(reps * (time.perf_counter() - t0) * SPIN_HZ)
    times = []
    while len(times) < runs:
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(2 * reps if before else 2 + queued)]
        if before is None:
            if queued:
                events[2].record()
                torch.cuda._sleep(spin)
            events[0].record()
            h0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host_ms = (time.perf_counter() - h0) * 1e3
            events[1].record()
        else:
            for i in range(reps):
                before()
                events[2 * i].record()
                fn()
                events[2 * i + 1].record()
        torch.cuda.synchronize()
        if queued and host_ms >= events[2].elapsed_time(events[0]):
            spin *= 2
            continue
        times.append(sum(a.elapsed_time(b) for a, b in
                         zip(events[:2 * reps:2], events[1:2 * reps:2])) / reps)
    return statistics.median(times)


def host_us(fn, calls: int = 100) -> float:
    """Host time of one call of ``fn`` in us: ``calls`` calls enqueued back
    to back with no synchronize inside (after a warm-up), the wrapper's own
    cost when the card keeps up."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def codec_times(ck, flat, block: int, flush) -> dict:
    """B2 and B3 on one stream, delta off (the default layout's launches):
    {"encode" | "decode": {"ms": back to back, "cold_ms": each launch alone
    after ``flush()`` (a cold L2), "host_us": the wrapper's host time a
    call}}.  ``ck`` is a checkout's ``repro_torch.kernels.codec``.  Both
    back-to-back figures are read before the first flush."""
    q, sc = ck.codec_encode_cuda(flat, block, False)
    fns = {"encode": lambda: ck.codec_encode_cuda(flat, block, False),
           "decode": lambda: ck.codec_decode_cuda(q, sc, block, False)}
    t = {name: dict(ms=cuda_ms(fn)) for name, fn in fns.items()}
    for name, fn in fns.items():
        t[name].update(cold_ms=cuda_ms(fn, before=flush), host_us=host_us(fn))
    return t


def quant_times(qk, leaves, block: int, flush) -> dict:
    """B4a and B4b over a payload's leaves, one launch per leaf as the legacy
    codec does: {"quant" | "dequant": {"ms": the launches back to back,
    "cold_ms": the sum of each launch alone after ``flush()``, "held_ms":
    the same with the card held for HOLD_CYCLES after the flush, "host_us":
    the wrappers' host time for the leaves}}.  A launch of B4 is shorter
    than its wrapper's host time, so "cold_ms" can take in host time that
    the flush did not cover; "held_ms" cannot.  ``qk`` is a checkout's
    ``repro_torch.kernels.quant``.  Both back-to-back figures are read
    before the first flush."""
    import torch

    def held():
        flush()
        torch.cuda._sleep(HOLD_CYCLES)

    quantised = [qk.quant_cuda(x, block) for x in leaves]
    calls = {"quant": [functools.partial(qk.quant_cuda, x, block)
                       for x in leaves],
             "dequant": [functools.partial(qk.dequant_cuda, q, sc, n,
                                           tuple(x.shape))
                         for x, (q, sc, n) in zip(leaves, quantised)]}
    t = {name: dict(ms=cuda_ms(lambda fns=fns: [f() for f in fns]))
         for name, fns in calls.items()}
    for name, fns in calls.items():
        t[name].update(cold_ms=sum(cuda_ms(f, before=flush) for f in fns),
                       held_ms=sum(cuda_ms(f, before=held) for f in fns),
                       host_us=host_us(lambda fns=fns: [f() for f in fns]))
    return t


def quant_bytes(leaves, block: int) -> int:
    """Bytes B4a or B4b must move over a payload's leaves, by the cost
    function ``ops.COSTS`` counts them with: 4 B a value of the leaf, 1 B
    an element of the padded (nb, block) q and 4 B a block's scale."""
    from repro_torch.kernels import quant as qk
    return sum(qk.cost(x.numel(), block)[1] for x in leaves)


def codec_bytes(total: int, block: int) -> int:
    """Bytes B2 or B3 must move for a stream of ``total`` f32 (4 B and 1 B
    an element, 4 B a block's scale), by the kernels' cost function."""
    from repro_torch.kernels import codec as ck
    return ck.cost(total, block)[1]


def sass_ops(lib: Path, ops: tuple) -> dict:
    """{kernel: {op: count}} over the SASS of a built library (cuobjdump,
    from the toolkit beside nvcc): how often each kernel's code holds each
    opcode prefix in ``ops``."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = collections.Counter()
        elif fn is not None:
            for op in ops:
                if f" {op} " in line or f" {op}." in line:
                    counts[fn][op] += 1
    return counts


def ptxas_usage(report: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from nvcc's
    ``-Xptxas -v`` report of a build: each "Used N registers" line belongs
    to the entry function compiled last before it, and each spill line to
    the function whose properties it follows (None where none was seen)."""
    usage, spills, fn, props = {}, {}, None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props is not None:
            spills[props] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            usage[fn] = (int(m.group(1)),) + spills.get(fn, (None, None))
    return usage


def host_ms(fn, runs: int = 3) -> float:
    """Median wall time of ``fn`` ending in a synchronize (after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def padded_profile(pad_s: float = TRACE_PAD_S):
    """A torch.profiler session (host and card) opened after a synchronize,
    idling ``pad_s`` before its body and, after a synchronize, after it:
    device events whose card time stamps stray from the host clock by less
    than the pad stay inside the session (module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(pad_s)


def session_events(prof):
    """(device events, host events) of a closed profiler session, Kineto's
    records as they come (name(), start_ns(), duration_ns()): ``prof.events()``
    would first build the profiler's event tree, which costs tens of us a
    record, most of a session that holds a few hundred thousand.  Hidden
    records are left out, as ``prof.events()`` leaves them out."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        (dev if e.device_type() == DeviceType.CUDA else host).append(e)
    return dev, host


def count_session(dev, host) -> None:
    """Count a session, and whether it came back with no device event; of
    one that did not, keep how far its first device event started after its
    first launch call (TRACE_LAGS)."""
    TRACE_COUNT["sessions"] += 1
    TRACE_COUNT["empty"] += not dev
    calls = [e.start_ns() for e in host if e.name().startswith(LAUNCH_CALLS)]
    if dev and calls:
        TRACE_LAGS.append((time.monotonic() - TRACE_T0,
                           (min(e.start_ns() for e in dev) - min(calls)) / 1e6))


def device_busy_ms(fn, pad_s: float = TRACE_PAD_S):
    """Time on the card while ``fn`` runs, from a torch.profiler (CUPTI)
    trace: the durations of its device events (kernels, copies, fills) summed
    by name.  Returns (total ms, number of device events, a Counter of ms by
    name)."""
    with padded_profile(pad_s) as prof:
        fn()
    dev, host = session_events(prof)
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name()] += e.duration_ns() / 1e6
    count_session(dev, host)
    return sum(by_name.values()), len(dev), by_name


def traced_busy_ms(what: str, fn, pad_s: float = TRACE_PAD_S):
    """``device_busy_ms`` of a ``fn`` that launches work on the card and can
    run again, with ``pad_s`` pads: an empty session is taken again with
    pads of at least TRACE_RETRY_PAD_S, up to TRACE_TRIES sessions, and
    fails if every one is empty."""
    for attempt in range(1, TRACE_TRIES + 1):
        if attempt > 1:
            pad_s = max(pad_s, TRACE_RETRY_PAD_S)
        busy, n_ev, by_name = device_busy_ms(fn, pad_s)
        if n_ev:
            return busy, n_ev, by_name
        log(f"trace {what}: the profiler recorded no device event in session "
            f"{attempt} of {TRACE_TRIES} ({pad_s} s pads)")
    raise AssertionError(f"trace {what}: no device event recorded in "
                         f"{TRACE_TRIES} sessions")


def handoff_logits(cfg, params, batch, last=None):
    """(logits of a prefill to S, of a prefill to S-1 + decode of position
    S-1), float32 (B, 1, V) or (B, 1, ncb, V), on the inputs' device.
    ``batch``: the prompt to S, token ids, frames, or patches and tokens
    (the patches stay whole, the text loses its last token); ``last``: the
    decode input of position S-1, the batch's own last position unless
    given (musicgen's codebook tokens whose summed embeddings are the
    batch's last frame)."""
    import torch
    import repro_torch.models.transformer as T
    pre = {k: v if k == "patches" else v[:, :-1] for k, v in batch.items()}
    if last is None:
        last = {k: v[:, -1:] for k, v in batch.items() if k != "patches"}
    S = sum(v.shape[1] for v in batch.values())
    with torch.no_grad():
        full, _ = T.prefill(cfg, params, batch, S)
        _, caches = T.prefill(cfg, params, pre, S)
        dec, _ = T.decode_step(cfg, params, caches, last, S - 1)
    return full, dec


def handoff_gap(full, dec):
    """(max |dec - full|, max |full|); raises on a non-finite logit."""
    import torch
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
        raise AssertionError("non-finite logits in the handoff check")
    return float((dec - full).abs().max()), float(full.abs().max())


def cell_expected_launches(logs, tails, head_blocks, n_blocks, fused_head,
                           lockstep):
    """B1, B2, B3 launches a cell run implies: the blocks of every executed
    head (every log but the window drops, whose option is "dropped") and of
    every batched tail (``tails``: (option, size, padded, ms) per
    tail_batched call), and one codec pair per split option per capture
    round (a lock-step slot, or one absolute capture instant of the event
    engine) on the group path, or one pair per split frame with the fused
    head."""
    ran = [lg for lg in logs if lg.option in head_blocks]
    split = [lg for lg in ran if lg.option.startswith("split")]
    rounds = {(lg.frame_idx if lockstep else lg.capture_s, lg.option)
              for lg in split}
    pairs = len(split) if fused_head else len(rounds)
    return {"fused_window_attention":
            sum(head_blocks[lg.option] for lg in ran)
            + sum(n_blocks - head_blocks[o] for o, _, _, _ in tails),
            "codec_encode": pairs, "codec_decode": pairs}


def check_detections(cfg, levels, what: str) -> int:
    """One image's detections: every level's cls, box and ctr maps finite,
    of shape (1, H, W, channels) at their stage's size.  Returns 1."""
    import torch
    for lv, s in zip(levels, range(cfg.n_stages)):
        H, W = cfg.stage_hw(s)
        for key, ch in (("cls", cfg.num_classes), ("box", 4), ("ctr", 1)):
            t = lv[key]
            if tuple(t.shape) != (1, H, W, ch) or not torch.isfinite(t).all():
                raise AssertionError(f"{what}: {key} level {s} "
                                     f"{tuple(t.shape)}")
    return 1


def phase11(ctx) -> dict:
    """The paper's multi-UE cell on the card at the full width of Swin-T:
    CELL_UES UEs on random weights, three runs, each with every launch
    counter at 0 before and read after.  (a) lock-step
    ``CellSimulator.run`` at a fixed split, (b) the same with the fused
    head, whose bytes must equal (a)'s, (c) the event engine ``run_stream``
    on an EDF-scheduled RanCell with adaptive controllers.  Returns what
    phase 12 reruns on the vectorized MAC: the plan, frames, traces,
    controller and the run checker."""
    import numpy as np
    import torch
    from repro_torch.core.adaptive import Objective
    from repro_torch.core.cell import CellSimulator, cell_interference_traces
    from repro_torch.core.compression import ActivationCodec
    from repro_torch.core.pipeline import build_controller
    from repro_torch.core.ran import RanCell, RanConfig, make_policy
    from repro_torch.core.splitting import SERVER_ONLY, UE_ONLY, SwinSplitPlan
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves

    cfg, params, dev = ctx["cfg"], ctx["params"], ctx["dev"]
    system, n_blocks = ctx["system"], ctx["n_blocks"]
    t_phase = time.perf_counter()
    plan = SwinSplitPlan(cfg, params, device=dev)
    imgs = list(torch.from_numpy(ctx["video"].frames(CELL_UES)).to(dev)[:, None])
    head_blocks = {o: (n_blocks if o == UE_ONLY else 0 if o == SERVER_ONLY
                       else sum(cfg.depths[:int(o.removeprefix("split"))]))
                   for o in plan.options}
    tails = []                     # (option, size, padded, host ms)
    tail_batched = plan.tail_batched

    def timed_tail(payloads, option, pad_to=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = tail_batched(payloads, option, pad_to=pad_to)
        torch.cuda.synchronize()
        tails.append((option, len(payloads), pad_to,
                      (time.perf_counter() - t) * 1e3))
        return out
    plan.tail_batched = timed_tail

    def run(what, fn, fused_head, lockstep):
        del tails[:]
        ops.LAUNCHES.clear()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
        want = cell_expected_launches(res.logs, tails, head_blocks, n_blocks,
                                      fused_head, lockstep)
        log(f"cell {what}: launches {got} (expected from its logs and "
            f"{len(tails)} batches {want}); {wall:.2f} s host wall")
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"cell {what}: launches do not match the "
                                 "logs and batches")
        if (res.stats.n_batches != len(tails)
                or res.stats.n_requests != sum(n for _, n, _, _ in tails)):
            raise AssertionError(f"cell {what}: batches {res.stats}")
        n_out = sum(check_detections(cfg, out, f"cell {what}")
                    for slot in res.outputs for out in slot.values())
        by_bucket = collections.defaultdict(list)
        for o, n, padded, ms in tails:
            by_bucket[padded].append(ms)
        log(f"cell {what}: {n_out} finite detections; batched tail ms by "
            f"bucket: " + ", ".join(
                f"{b}: median {statistics.median(v):.2f} over {len(v)}"
                for b, v in sorted(by_bucket.items())))
        return res

    trace = cell_interference_traces(CELL_FRAMES, CELL_UES, seed=SEED)
    lock = {}
    for fused_head in (False, True):
        what = f"({'b' if fused_head else 'a'}) lock-step split2" + (
            " fused head" if fused_head else "")
        sim = CellSimulator(plan=plan, system=system, n_ues=CELL_UES,
                            seed=SEED, execute_model=True,
                            fused_head=fused_head, device=dev,
                            codec=ActivationCodec(device=dev))
        step, walls = sim.step, []

        def timed_step(*a, step=step, walls=walls, **kw):
            t = time.perf_counter()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            return out
        sim.step = timed_step
        res = run(what, lambda: sim.run(trace, imgs=imgs, option="split2",
                                        keep_outputs=True), fused_head, True)
        lock[fused_head] = res
        for t_ in range(CELL_FRAMES):
            slot = [lg for lg in res.logs if lg.frame_idx == t_]
            enc_ms = sum(lg.quant_s for lg in slot) * 1e3
            log(f"cell {what} slot {t_}: host wall {walls[t_]:.2f} ms, "
                f"{'head+encode' if fused_head else 'group encode'} "
                f"{enc_ms:.2f} ms over {len(slot)} UEs, bytes "
                f"{[lg.compressed_bytes for lg in slot]}")
    bytes_a = [(lg.frame_idx, lg.ue_id, lg.raw_bytes, lg.compressed_bytes)
               for lg in lock[False].logs]
    if bytes_a != [(lg.frame_idx, lg.ue_id, lg.raw_bytes, lg.compressed_bytes)
                   for lg in lock[True].logs]:
        raise AssertionError("cell: fused-head bytes differ from the group "
                             "path's")
    log(f"cell (a) vs (b): the {len(bytes_a)} UE-frames' raw and compressed "
        f"bytes are equal")

    ctrl = build_controller(system, objective=Objective(
        w_delay=1.0, w_energy=0.15, w_privacy=0.05), seed=SEED, device=dev)
    sim = CellSimulator(plan=plan, system=system, n_ues=CELL_UES, seed=SEED,
                        execute_model=True, controller=ctrl, device=dev,
                        ran=RanCell(make_policy("edf"), RanConfig(tti_s=0.005)),
                        frame_budget_s=2.5, codec=ActivationCodec(device=dev))
    stream_trace = cell_interference_traces(STREAM_FRAMES, CELL_UES, seed=1)
    res = run("(c) run_stream, EDF RanCell, adaptive",
              lambda: sim.run_stream(stream_trace, imgs=imgs, fps=0.5,
                                     jitter_s=0.05, inflight=2, budget_s=2.5,
                                     keep_outputs=True), False, False)
    st = res.stats
    opts = collections.Counter(lg.option for lg in res.logs)
    log(f"cell (c): options {dict(opts)}; completed {st.n_completed}, dropped "
        f"{st.n_dropped}; mean age {st.mean_age_s:.3f} s, deadline miss rate "
        f"{res.deadline_miss_rate:.3f}, edge utilization "
        f"{st.edge_utilization:.3f}, mean batch {st.mean_batch_size:.2f} "
        f"(simulated clock); encode ms per split frame "
        + ", ".join(f"{lg.quant_s * 1e3:.1f}" for lg in res.logs
                    if lg.option.startswith("split")))
    if not np.isfinite([lg.delay_s for lg in res.logs]).all():
        raise AssertionError("cell (c): non-finite delay")
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return dict(plan=plan, imgs=imgs, system=system, dev=dev, run=run,
                ctrl=ctrl, trace=trace, stream_trace=stream_trace)


def hexed(v):
    """``v`` with dataclasses as dicts, numpy scalars as Python ones and
    every float as its hex form, so that == is bitwise (NaN equals NaN)."""
    import numpy as np
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        v = dataclasses.asdict(v)
    if isinstance(v, dict):
        return {k: hexed(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [hexed(x) for x in v]
    if isinstance(v, (float, np.floating)):
        return float(v).hex()
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return v


def mac_stream(n: int, pol: str, device):
    """``benchmarks/bench_scale.py``'s ``_build`` on the port: ``n``
    synthetic flows (seed 5) at a fixed offered load in a VecRanStream on
    ``device``, or with ``device=None`` in the port's oracle RanStream."""
    from repro_torch.core.engine_vec import synthetic_flows
    from repro_torch.core.ran import (RanCell, RanConfig, RanStream,
                                      UplinkRequest, make_policy)
    from repro_torch.core.ran_vec import VecRanStream
    cell = RanCell(policy=make_policy(pol), cfg=RanConfig(tti_s=1e-3))
    s = RanStream(cell) if device is None else VecRanStream(cell, n,
                                                           device=device)
    w = synthetic_flows(n, 5, mean_bytes=max(64, MAC_TOTAL_BYTES // n))
    for i in range(n):
        s.enqueue(UplinkRequest(
            ue_id=int(w["ue"][i]), n_bytes=int(w["n_bytes"][i]),
            enqueue_s=float(w["enq"][i]), deadline_s=float(w["dead"][i]),
            link_rate_bps=float(w["link_rate_bps"][i])), int(w["cohort"][i]))
    return s


def mac_drain(s):
    """Drain ``s`` with a fresh Generator(5): (stream, finished flows,
    generator, host wall ms ending in a synchronize)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = s.advance(math.inf, rng)
    torch.cuda.synchronize()
    return s, done, rng, (time.perf_counter() - t0) * 1e3


def mac_same(a, b, what: str) -> None:
    """Two drains (``mac_drain``'s tuples) agree bit for bit: every
    StreamFlow field and GrantReport of the finished flows, in order, and
    the HARQ stream's next draws (a vectorized stream's unconsumed tape,
    then its Generator's next value)."""
    import numpy as np
    for s, done, _, _ in (a, b):
        if len(done) != len(a[1]):
            raise AssertionError(f"{what}: {len(a[1])} vs {len(done)} flows")
    rec = [hexed([[f, s.report(f)] for f in done]) for s, done, _, _ in (a, b)]
    if rec[0] != rec[1]:
        bad = next(i for i, (x, y) in enumerate(zip(*rec)) if x != y)
        raise AssertionError(f"{what}: flow {bad} differs: {rec[0][bad]} vs "
                             f"{rec[1][bad]}")
    tapes = [getattr(getattr(s, "cell", None), "_tape", None)
             for s, _, _, _ in (a, b)]
    k = 1 + max(t.buf.size for t in tapes if t is not None)
    # copies of the Generators: a drain can be compared more than once
    draws = [np.concatenate([t.buf, copy.deepcopy(rng).random(k - t.buf.size)])
             if t is not None else copy.deepcopy(rng).random(k)
             for t, (_, _, rng, _) in zip(tapes, (a, b))]
    if draws[0].tobytes() != draws[1].tobytes():
        raise AssertionError(f"{what}: the HARQ streams are not paired")


def mac_trace(fn, pad_s: float = TRACE_PAD_S):
    """``fn`` under torch.profiler: a Counter of the card's busy ms
    (``busy``), of it the sorts' (``sort``), the kernel launches
    (``kernels``), copies (``copies``: host to card, card to host and on
    the card) and memsets (``memsets``), and the host ms spent reading a
    device value (``reads``: the stop code after each step, which waits for
    the card); and ``fn``'s own result.  ``pad_s``: padded_profile's."""
    with padded_profile(pad_s) as prof:
        out = fn()
    dev, host = session_events(prof)
    c = collections.Counter()
    for e in dev:
        ms = e.duration_ns() / 1e6
        c["events"] += 1
        c["busy"] += ms
        kind = ("copies" if e.name().startswith("Memcpy") else
                "memsets" if e.name().startswith("Memset") else "kernels")
        c[kind] += 1
        if "Sort" in e.name() or "sort" in e.name():
            c["sort"] += ms
    c["reads"] = sum(e.duration_ns() for e in host
                     if e.name() == "aten::_local_scalar_dense") / 1e6
    count_session(dev, host)
    return c, out


def phase12(cell) -> tuple:
    """The vectorized MAC (core/ran_vec.py, core/engine_vec.py) on the card
    at the sizes ``benchmarks/bench_scale.py`` calls city scale, held bit
    for bit to the port's CPU path and its oracle (core/ran.py): (a)
    ``mac_streams``, (b) ``mac_city``, (c) ``mac_lockstep``, (d)
    ``mac_event``, each with its wall time.  Returns the profiler phase's
    MAC drain (what, fn): edf at MAC_FLOWS flows, and (b)'s reports (for
    phase 18 (c))."""
    t_phase = time.perf_counter()
    dev = cell["dev"]
    secs = {}
    city = {}
    for part, fn in (("a", lambda: mac_streams(dev)),
                     ("b", lambda: city.update(mac_city(dev))),
                     ("c", lambda: mac_lockstep(cell)),
                     ("d", lambda: mac_event(cell))):
        t0 = time.perf_counter()
        fn()
        secs[part] = time.perf_counter() - t0
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()) + ")")
    streams = iter([mac_stream(MAC_FLOWS, "edf", dev) for _ in range(2)])
    return (f"MAC drain, edf, {MAC_FLOWS} flows",
            lambda: mac_drain(next(streams)), city)


def mac_streams(dev) -> None:
    """Phase 12 (a): per policy, a warm-up (the first MAC_WARM_S of a
    drain: every shape and kernel of the full drain) and three timed drains
    of MAC_FLOWS flows on the card; the port's CPU path at the same size;
    the oracle at MAC_ORACLE_FLOWS (and at MAC_FLOWS for edf)."""
    import numpy as np
    for pol in MAC_POLICIES:
        mac_stream(MAC_FLOWS, pol, dev).advance(MAC_WARM_S,
                                                np.random.default_rng(5))
        runs = [mac_drain(mac_stream(MAC_FLOWS, pol, dev)) for _ in range(3)]
        card = runs[0]
        cpu = mac_drain(mac_stream(MAC_FLOWS, pol, "cpu"))
        mac_same(card, cpu, f"MAC (a) {pol}: card vs CPU at {MAC_FLOWS}")
        small = mac_drain(mac_stream(MAC_ORACLE_FLOWS, pol, dev))
        oracle_small = mac_drain(mac_stream(MAC_ORACLE_FLOWS, pol, None))
        mac_same(small, oracle_small, f"MAC (a) {pol}: card vs oracle at "
                 f"{MAC_ORACLE_FLOWS}")
        line = (f"MAC (a) {pol}: {MAC_FLOWS} flows, {card[0].n_ttis} TTIs "
                f"executed in {card[0].n_steps} steps; card drain "
                f"{statistics.median(r[3] for r in runs):.1f} ms (median of "
                f"3: {', '.join(f'{r[3]:.1f}' for r in runs)}), CPU path "
                f"{cpu[3]:.1f} ms; at {MAC_ORACLE_FLOWS} flows card "
                f"{small[3]:.1f} ms ({small[0].n_ttis} TTIs, "
                f"{small[0].n_steps} steps), oracle {oracle_small[3]:.1f} ms")
        if pol == "edf":
            oracle = mac_drain(mac_stream(MAC_FLOWS, pol, None))
            mac_same(card, oracle, f"MAC (a) {pol}: card vs oracle at "
                     f"{MAC_FLOWS}")
            line += f"; oracle at {MAC_FLOWS} flows {oracle[3]:.1f} ms"
        log(line + "; every flow and report bitwise equal, HARQ streams "
            "paired")


def city_requests():
    """Phase 12 (b)'s synthetic city as one ``UplinkRequest`` list a
    cell."""
    from repro_torch.core.engine_vec import synthetic_city
    from repro_torch.core.ran import UplinkRequest
    batches = synthetic_city(CITY_UES, CITY_CELLS, seed=0)
    return [[UplinkRequest(ue_id=int(b["ue"][i]), n_bytes=int(b["n_bytes"][i]),
                           enqueue_s=float(b["enq"][i]),
                           deadline_s=float(b["dead"][i]),
                           link_rate_bps=float(b["link_rate_bps"][i]))
             for i in range(len(b["ue"]))] for b in batches]


def mac_city(dev) -> dict:
    """Phase 12 (b): ``MultiCellVecMac`` over one synthetic city, CITY_SLOTS
    slots per policy, against the oracle cell by cell.  Returns each
    policy's slot reports (``hexed``)."""
    import numpy as np
    import torch
    from repro_torch.core.engine_vec import MultiCellVecMac
    from repro_torch.core.ran import RanCell, RanConfig, make_policy
    reqs = city_requests()
    city = {}
    for pol in MAC_POLICIES:
        mk = lambda: [RanCell(policy=make_policy(pol),
                              cfg=RanConfig(tti_s=1e-3))
                      for _ in range(CITY_CELLS)]
        oracle, mac = mk(), MultiCellVecMac(mk(), device=dev)
        kids = np.random.SeedSequence(SEED).spawn(CITY_CELLS)
        r_card, r_py = ([np.random.default_rng(k) for k in kids]
                        for _ in range(2))
        ms, oracle_ms = [], []
        for slot in range(CITY_SLOTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = mac.serve_slot(reqs, r_card)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            want = [c.serve_slot(r, g) for c, r, g in zip(oracle, reqs, r_py)]
            oracle_ms.append((time.perf_counter() - t0) * 1e3)
            city.setdefault(pol, []).append(hexed(got))
            if city[pol][-1] != hexed(want):
                raise AssertionError(f"MAC (b) {pol}: slot {slot} reports "
                                     "differ from the oracle's")
        last = max(max(r.finish_s for r in w.values()) for w in want)
        log(f"MAC (b) {pol}: {CITY_UES} UEs over {CITY_CELLS} cells, "
            f"{CITY_SLOTS} slots; card ms per slot "
            f"{', '.join(f'{t:.1f}' for t in ms)}, oracle ({CITY_CELLS} cells "
            f"in turn) "
            f"{', '.join(f'{t:.1f}' for t in oracle_ms)}; the last slot "
            f"drains at {last:.3f} s (simulated); every report bitwise "
            "equal")
    return city


def mac_sim(cell, policy, **kw):
    """Phase 11's cell (``cell`` is ``phase11``'s context) on a RanCell of
    ``policy`` (tti 5 ms)."""
    from repro_torch.core.cell import CellSimulator
    from repro_torch.core.compression import ActivationCodec
    from repro_torch.core.ran import RanCell, RanConfig, make_policy
    dev = cell["dev"]
    return CellSimulator(plan=cell["plan"], system=cell["system"],
                         n_ues=CELL_UES, seed=SEED, device=dev,
                         codec=ActivationCodec(device=dev),
                         ran=RanCell(make_policy(policy),
                                     RanConfig(tti_s=0.005)), **kw)


def mac_same_run(a, b, what) -> int:
    """Two CellResults agree bit for bit in every FrameLog and CellStats
    field; returns the number of logs."""
    if hexed(a.logs) != hexed(b.logs) or hexed(a.stats) != hexed(b.stats):
        raise AssertionError(f"MAC {what}: the engines' logs or stats differ")
    return len(a.logs)


# Phase 12 (c), (d): executed runs time the codec on the host clock, which
# moves every later enqueue instant of the MAC, so the engines are held
# field-exact on accounting runs (execute_model=False) of the same
# configurations; the executed runs get phase 11's launch and detection
# checks.

def mac_lockstep(cell) -> None:
    """Phase 12 (c): phase 11(a)'s lock-step cell with a PF RanCell and
    ``engine="vectorized"``."""
    import numpy as np
    res = cell["run"]("(c) lock-step split2, PF RanCell, vectorized MAC",
                      lambda: mac_sim(cell, "pf", execute_model=True,
                                      engine="vectorized").run(
                          cell["trace"], imgs=cell["imgs"], option="split2",
                          keep_outputs=True), False, True)
    acc = {e: mac_sim(cell, "pf", execute_model=False, engine=e).run(
        cell["trace"], option="split2") for e in ("python", "vectorized")}
    n = mac_same_run(acc["python"], acc["vectorized"], "(c)")
    log(f"MAC (c): executed, mean prb share "
        f"{np.mean([lg.prb_share for lg in res.logs]):.3f}, HARQ retx "
        f"{sum(lg.harq_retx for lg in res.logs)}; accounting, {n} FrameLogs "
        "and CellStats of the two engines bitwise equal")


def mac_event(cell) -> None:
    """Phase 12 (d): phase 11(c)'s event engine (``run_stream``) with
    ``engine="vectorized"``."""
    stream_kw = dict(controller=cell["ctrl"], frame_budget_s=2.5)
    run_kw = dict(fps=0.5, jitter_s=0.05, inflight=2, budget_s=2.5)
    res = cell["run"]("(d) run_stream, EDF RanCell, adaptive, vectorized MAC",
                      lambda: mac_sim(cell, "edf", execute_model=True,
                                      engine="vectorized", **stream_kw
                                      ).run_stream(cell["stream_trace"],
                                                   imgs=cell["imgs"],
                                                   keep_outputs=True,
                                                   **run_kw), False, False)
    acc = {e: mac_sim(cell, "edf", execute_model=False, engine=e, **stream_kw
                      ).run_stream(cell["stream_trace"], **run_kw)
           for e in ("python", "vectorized")}
    n = mac_same_run(acc["python"], acc["vectorized"], "(d)")
    log(f"MAC (d): executed, completed {res.stats.n_completed}, dropped "
        f"{res.stats.n_dropped}; accounting, {n} FrameLogs and CellStats of "
        "the two engines bitwise equal")


def serve_launches(cfg, gen: int) -> dict:
    """The launches ``launch.serve`` with ``--split`` implies: one codec pair
    for the handoff, and where the model has GQA layers, B5 on every layer
    of the split's forward and of the prefill and B6 on every layer of each
    of ``gen`` decode steps."""
    want = {"codec_encode": 1, "codec_decode": 1}
    if not cfg.use_mla and cfg.family != "ssm":
        want.update(flash_attention=2 * cfg.n_layers,
                    decode_attention=cfg.n_layers * gen)
    return want


def train_launches(n_layers: int, micro_steps: int) -> dict:
    """The launches ``launch.train`` implies over ``micro_steps`` micro-
    batches: B5's forward twice a layer (remat recomputes it) and each of
    its backward kernels once."""
    from repro_torch.kernels import flash_attention as fa
    return {"flash_attention": micro_steps * 2 * n_layers,
            **{k: micro_steps * n_layers for k in fa.BWD_KERNELS}}


def serve_checked(arch: str) -> tuple:
    """``serve`` at the full width of ``arch`` as phase 9 serves LM_ARCH,
    every launch counter at 0 before and read after.  A GQA model (dense,
    MoE, hybrid, audio or vision) launches B5 once per layer in the prefill
    and once across the split's head and tail, B6 once per layer and decode
    step;
    MLA and xLSTM launch neither; the codec pair once each.  No logit may be
    non-finite, and the split's payload is the (B, S, d) stream.  Returns
    (the config, the status histograms, the log line's common part)."""
    import argparse
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as SV

    cfg = get_config(arch)
    n = cfg.n_layers
    want = serve_launches(cfg, LM_GEN)
    args = argparse.Namespace(arch=arch, reduced=False,
                              prompt_len=LM_PROMPT, gen=LM_GEN,
                              batch=LM_BATCH, split=LM_SPLIT, device="cuda",
                              status_out=None)
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    st = SV.serve(args)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    log(f"serve {cfg.name} launches: {got} (expected from the config {want})")
    if got != want:
        raise AssertionError(f"serving {cfg.name} did not launch the kernels "
                             "as often as its config implies")
    snap = json.loads(json.dumps(st))["metrics"]
    ctr, hist = snap["counters"], snap["histograms"]
    if (ctr["nonfinite_logits_total"] != 0
            or ctr["tokens_generated_total"] != LM_BATCH * LM_GEN
            or hist["decode_step_s"]["count"] != LM_GEN):
        raise AssertionError(f"serve {cfg.name} status: {ctr}")
    raw_b = int(ctr["boundary_raw_bytes_total"])
    if raw_b != (LM_BATCH * LM_PROMPT * cfg.d_model
                 * getattr(torch, cfg.dtype).itemsize):
        raise AssertionError(f"split payload of {raw_b} B")
    line = (f"serve {cfg.name} full width, batch {LM_BATCH}, prompt "
            f"{LM_PROMPT}, {LM_GEN} decode steps, split at layer "
            f"{max(1, int(n * LM_SPLIT))}/{n} ({t_serve:.1f} s with init): "
            f"prefill {hist['prefill_s']['sum'] * 1e3:.2f} ms; decode "
            f"{hist['decode_step_s']['sum'] / LM_GEN * 1e3:.3f} ms per step "
            f"of {LM_BATCH} tokens; split one-shot "
            f"{hist['split_s']['sum'] * 1e3:.2f} ms, boundary {raw_b} B -> "
            f"{int(ctr['boundary_compressed_bytes_total'])} B; no non-finite "
            f"logit; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return cfg, hist, line


def moe_serve(arch: str) -> None:
    """Phase 13 (a), (d): ``serve_checked`` with the routing of every MoE
    layer recorded: the share of routed assignments the prefill dropped at
    capacity and the busiest expert's load."""
    import torch
    from repro_torch.models import layers as L

    with L.record_routing() as routing:
        cfg, _, line = serve_checked(arch)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    # the split's head and tail, the prefill, then the decode steps: each a
    # pass over every MoE layer
    if len(routing) != n_moe * (2 + LM_GEN):
        raise AssertionError(f"{len(routing)} MoE layer calls recorded")
    prefill = routing[n_moe:2 * n_moe]
    kept = sum(int(r["keep"].sum()) for r in prefill)
    total = sum(r["keep"].numel() for r in prefill)
    # the busiest expert's load over its fair share (S k / E) per layer
    fair = total / len(prefill) / cfg.n_experts / LM_BATCH
    busiest = sorted(float(torch.stack([torch.bincount(
        row.flatten(), minlength=cfg.n_experts) for row in r["idx"]]).max())
        / fair for r in prefill)
    if not all(bool(r["keep"].all()) for r in routing[2 * n_moe:]):
        raise AssertionError("a decode step dropped an assignment")
    log(f"{line}; the prefill dropped {total - kept} of {total} routed "
        f"assignments ({(total - kept) / total:.4%}) at capacity factor "
        f"{cfg.moe_capacity_factor} ({L.moe_capacity(cfg, LM_PROMPT)} rows "
        f"per expert and batch row; the busiest expert of a batch row takes "
        f"{busiest[len(busiest) // 2]:.2f}x its fair share in the median "
        f"layer, {busiest[-1]:.2f}x at most)")


def moe_handoffs(dev) -> None:
    """Phase 13 (b): prefill to S-1 plus one decode step against a prefill
    to S, on drop-free copies of the configs (MOE_DROP_FREE): granite at
    full depth in bf16 on serve's weights and prompt, deepseek at 4 layers
    (the dense layer and three MoE layers) in bf16, then each at 4 layers in
    f32 on the same weights upcast.  In bf16 the last token's router input
    differs between the two paths by bf16 rounding, enough to swap a
    near-tied expert (a change of O(gate), no fault), so the bf16 runs route
    every token to every expert (k = E: no discrete choice left) and differ
    by rounding only; f32 keeps the config's top-k."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import serve as SV
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_map

    def cases():
        granite = get_config(MOE_ARCHS[0]).replace(
            moe_capacity_factor=MOE_DROP_FREE)
        model = get_model(granite, dev)
        gen = torch.Generator(device=dev).manual_seed(SV.SEED)
        params = model.init(gen)
        tokens = model.concrete(model.prefill_inputs(InputShape(
            "cli", seq_len=LM_PROMPT, global_batch=LM_BATCH, kind="prefill")),
            gen)["tokens"]
        yield (granite.replace(moe_top_k=granite.n_experts), params, tokens,
               HANDOFF_BF16_TOL)
        del params
        for arch in MOE_ARCHS:
            cut = get_config(arch).replace(n_layers=4,
                                           moe_capacity_factor=MOE_DROP_FREE)
            p16 = T.init(cut, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
            toks = tokens % cut.vocab_size
            if arch != MOE_ARCHS[0]:
                yield (cut.replace(moe_top_k=cut.n_experts), p16, toks,
                       HANDOFF_BF16_TOL)
            yield (cut.replace(dtype="float32"),
                   tree_map(lambda a: a.float(), p16), toks, HANDOFF_F32_TOL)

    for cfg, params, toks, tol in cases():
        gap, top = handoff_gap(*handoff_logits(cfg, params, {"tokens": toks}))
        del params
        log(f"{cfg.name} drop-free (capacity factor {MOE_DROP_FREE}), top-"
            f"{cfg.moe_top_k} of {cfg.n_experts}, {cfg.n_layers} layers, "
            f"{cfg.dtype}: prefill to {LM_PROMPT - 1} + decode vs prefill to "
            f"{LM_PROMPT}: max |diff| {gap:.4g} = {gap / top:.3g} of max "
            f"|logit| {top:.4g} (tol {tol})")
        if not gap <= tol * top:
            raise AssertionError(f"{cfg.name} {cfg.dtype}: prefill -> decode "
                                 "logits disagree")


FWD_SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")
# B5's forward kernels by name: the bf16 body on wgmma and the f32 body;
# a trace's device time of B5's forward is the sum over both
B5_FWD_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_kernel")


def fwd_build_facts(report: str) -> dict:
    """Phase 2's build facts of B5's forward: for every instantiation its
    SASS counts of FWD_SASS_OPS (cuobjdump) and, where this run built the
    library, its ptxas registers (the launch's bound: setmaxnreg moves the
    consumers to 240 and the producer to 24 at run time) and spills.  Fails
    unless every bf16 instantiation (the wgmma body, hd 16-128, capped and
    not) holds HGMMA and UTMALDG and no HMMA, on a spill in it, and on a
    ptxas note that it serialised its wgmma.  Returns {name: counts}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    usage = ptxas_usage(report)
    serialised = set(re.findall(r"wgmma\.mma_async instructions are serialized"
                                r".*?function '([^']+)'", report))
    counts = sass_ops(_build.target("flash_attention"), FWD_SASS_OPS)
    seen = set()
    for fn, n in sorted(counts.items()):
        args = fn.split("kernelI", 1)[1]
        hd = int(re.search(r"Li(\d+)E", args).group(1))
        capped = "Lb1E" in args
        bf16 = B5_FWD_KERNELS[0] in fn
        regs, st, ld = usage.get(fn, (None, None, None))
        log(f"  SASS B5 fwd <{'bf16' if bf16 else 'f32'}, hd {hd}"
            f"{', cap' if capped else ''}>: {n['HGMMA']} HGMMA, "
            f"{n['UTMALDG']} UTMALDG, {n['HMMA']} HMMA; "
            + (f"{regs} registers, {st} B spill stores, {ld} B spill loads"
               + (", wgmma serialised" if fn in serialised else "")
               if regs is not None else "ptxas report not in this run"))
        if not bf16:
            continue
        seen.add((hd, capped))
        if not (n["HGMMA"] and n["UTMALDG"]) or n["HMMA"]:
            raise AssertionError(f"{fn}: B5's bf16 body without wgmma or TMA")
        if st or ld or fn in serialised:
            raise AssertionError(f"{fn}: spills {st} / {ld} B or serialised "
                                 "wgmma")
    missing = {(hd, c) for hd in fa.SUPPORTED_HEAD_DIMS
               for c in (False, True)} - seen
    if missing:
        raise AssertionError(f"B5's bf16 body has no instantiation for "
                             f"(hd, capped) {sorted(missing)}")
    return counts


WINDOW_SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "HMMA.1688.F32.TF32", "FFMA")
# B1's wgmma body by name; B1's mma.sync body (windows 9-12) and B7's are
# the other window-attention kernels
B1_WGMMA_KERNEL = "fused_window_attention_wgmma_kernel"


def b1_build_facts(report: str) -> dict:
    """Phase 2's build facts of the window-attention library: for every
    instantiation its SASS counts of WINDOW_SASS_OPS (cuobjdump) and, where
    this run built the library, its ptxas registers and spills.  Fails
    unless every instantiation of B1's wgmma body (hd 16 and 32; f32 keys
    56 and 64, bf16 64) holds HGMMA and UTMALDG and no HMMA, on a spill in
    it, and on a ptxas note that it serialised its wgmma; fails unless every
    other instantiation (B1 at windows 9-12, B7) holds TF32 HMMAs.  Returns
    {name: counts}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import window_attention as wa
    tf32 = "HMMA.1688.F32.TF32"
    usage = ptxas_usage(report)
    serialised = set(re.findall(r"wgmma\.mma_async instructions are serialized"
                                r".*?function '([^']+)'", report))
    counts = sass_ops(_build.target("window_attention"), WINDOW_SASS_OPS)
    seen = set()
    for fn, n in sorted(counts.items()):
        wgmma = B1_WGMMA_KERNEL in fn
        kernel = ("B1 wgmma" if wgmma else
                  "B1" if "fused_window" in fn else "B7")
        targs = fn.split("kernelI", 1)[-1]
        ints = [int(x) for x in re.findall(r"Li(\d+)E", targs)]
        dt = "bf16" if "bfloat16" in targs else "f32"
        regs, st, ld = usage.get(fn, (None, None, None))
        log(f"  SASS {kernel}<{','.join(map(str, ints))},{dt}>: "
            f"{n['HGMMA']} HGMMA, {n['UTMALDG']} UTMALDG, {n['HMMA']} HMMA "
            f"({n[tf32]} {tf32}), {n['FFMA']} FFMA; "
            + (f"{regs} registers, {st} B spill stores, {ld} B spill loads"
               + (", wgmma serialised" if fn in serialised else "")
               if regs is not None else "ptxas report not in this run"))
        if not wgmma:
            if not n[tf32]:
                raise AssertionError(f"{fn}: no {tf32} in its SASS")
            continue
        seen.add((ints[0], ints[1], dt))
        if not (n["HGMMA"] and n["UTMALDG"]) or n["HMMA"]:
            raise AssertionError(f"{fn}: B1's wgmma body without wgmma or TMA, "
                                 "or with an HMMA")
        if st or ld or fn in serialised:
            raise AssertionError(f"{fn}: spills {st} / {ld} B or serialised "
                                 "wgmma")
    want = {(hd, n, dt) for hd in wa.SUPPORTED_HEAD_DIMS
            for n, dt in ((56, "f32"), (64, "f32"), (64, "bf16"))}
    if want - seen:
        raise AssertionError(f"B1's wgmma body has no instantiation for "
                             f"(hd, keys, dtype) {sorted(want - seen)}")
    return counts


# B6's SASS: its bulk copies (cp.async.bulk), and the atomics its one-launch
# body must not hold
DECODE_SASS_OPS = ("UBLKCP", "ATOM", "ATOMG", "ATOMS", "RED")


def b6_build_facts(report: str) -> dict:
    """Phase 2's build facts of B6: for every instantiation of its one-launch
    body (f32 and bf16, hd 16-128, up to 1, 2, 3, 4, 6, 8 or 16 query heads
    a kv head, capped and not) its SASS counts of DECODE_SASS_OPS
    (cuobjdump) and, where this run built the library, its ptxas registers
    and spills.  Fails unless every instantiation holds the bulk copies, on
    an atomic or a spill in any of them, and unless all 112 are there.
    Returns {name: counts}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    usage = ptxas_usage(report)
    counts = sass_ops(_build.target("decode_attention"), DECODE_SASS_OPS)
    seen = set()
    for fn, n in sorted(counts.items()):
        args = fn.split("decode_attention_kernelI", 1)[-1]
        hd, gm = (int(x) for x in re.findall(r"Li(\d+)E", args)[:2])
        dtype = "bf16" if "bfloat16" in args else "f32"
        capped = "Lb1E" in args
        regs, st, ld = usage.get(fn, (None, None, None))
        atomics = sum(n[op] for op in DECODE_SASS_OPS[1:])
        log(f"  SASS B6 <{dtype}, hd {hd}, G <= {gm}{', cap' if capped else ''}>"
            f": {n['UBLKCP']} UBLKCP, {atomics} ATOM/RED; "
            + (f"{regs} registers, {st} B spill stores, {ld} B spill loads"
               if regs is not None else "ptxas report not in this run"))
        if not n["UBLKCP"] or atomics or st or ld:
            raise AssertionError(f"{fn}: B6 without its bulk copies, or with "
                                 f"atomics or spills ({st} / {ld} B)")
        seen.add((dtype, hd, gm, capped))
    missing = {(dt, hd, gm, c) for dt in ("f32", "bf16")
               for hd in fa.SUPPORTED_HEAD_DIMS for gm in (1, 2, 3, 4, 6, 8, 16)
               for c in (False, True)} - seen
    if missing:
        raise AssertionError(f"B6 has no instantiation for (dtype, hd, G, "
                             f"capped) {sorted(missing)}")
    return counts


BWD_SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "ATOM", "ATOMG", "ATOMS", "RED")


def bwd_instantiation(fn: str) -> tuple:
    """(entry, dtype, hd, capped) of a backward kernel's mangled name: the
    bf16 dK/dV and dQ kernels are the wgmma body's, the D pass is one
    template over both dtypes."""
    entry = next(e for e in ("delta", "dkdv", "dq")
                 if f"flash_attention_bwd_{e}" in fn)
    args = fn.split("kernelI", 1)[1]
    dtype = ("bf16" if "_wgmma_kernel" in fn
             or args.startswith("13__nv_bfloat16") else "f32")
    hd = int(re.search(r"Li(\d+)E", args).group(1))
    return entry, dtype, hd, "Lb1E" in args


def bwd_build_facts(report: str) -> dict:
    """Phase 17 (a)'s build facts of B5's backward: for every instantiation
    its SASS counts of BWD_SASS_OPS (cuobjdump) and, where this run built
    the library, its ptxas registers (the launch's bound for the wgmma
    body: setmaxnreg moves its consumers to 232 and its producer to 40 at
    run time) and spills.  Fails unless every bf16 dK/dV and dQ
    instantiation (the wgmma body, hd 16-128, capped and not) holds HGMMA
    and UTMALDG and no HMMA, on a ptxas note that one serialised its wgmma,
    on an atomic in any backward kernel, and on a bf16 spill at hd <= 64.
    Returns {name: counts}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    usage = ptxas_usage(report)
    serialised = set(re.findall(r"wgmma\.mma_async instructions are serialized"
                                r".*?function '([^']+)'", report))
    counts = sass_ops(_build.target("flash_attention_bwd"), BWD_SASS_OPS)
    seen = set()
    for fn, n in sorted(counts.items(), key=lambda kv: bwd_instantiation(kv[0])):
        entry, dtype, hd, capped = bwd_instantiation(fn)
        regs, st, ld = usage.get(fn, (None, None, None))
        atomics = sum(n[op] for op in BWD_SASS_OPS[3:])
        log(f"  SASS B5 bwd {entry}<{dtype}, hd {hd}{', cap' if capped else ''}>:"
            f" {n['HGMMA']} HGMMA, {n['UTMALDG']} UTMALDG, {n['HMMA']} HMMA, "
            f"{atomics} ATOM/RED; "
            + (f"{regs} registers, {st} B spill stores, {ld} B spill loads"
               + (", wgmma serialised" if fn in serialised else "")
               if regs is not None else "ptxas report not in this run"))
        if atomics:
            raise AssertionError(f"{fn}: atomics in B5's backward")
        if dtype != "bf16" or entry == "delta":
            continue
        seen.add((entry, hd, capped))
        if not (n["HGMMA"] and n["UTMALDG"]) or n["HMMA"]:
            raise AssertionError(f"{fn}: B5's bf16 backward without wgmma or "
                                 "TMA, or with mma.sync")
        if fn in serialised:
            raise AssertionError(f"{fn}: ptxas serialised its wgmma")
        if hd <= 64 and (st or ld):
            raise AssertionError(f"{fn}: spills {st} / {ld} B at hd {hd}")
    missing = {(e, hd, c) for e in ("dkdv", "dq") for hd in fa.SUPPORTED_HEAD_DIMS
               for c in (False, True)} - seen
    if missing:
        raise AssertionError(f"B5's bf16 backward has no wgmma instantiation "
                             f"for (entry, hd, capped) {sorted(missing)}")
    return counts


def train_bwd_checks(dev, report: str = "") -> float:
    """Phase 17 (a): B5's backward on the card against
    ``flash_attention_bwd_plain`` on the kernel's own forward output and
    log-sum-exp, dQ, dK and dV each within F32_TOL / BF16_TOL of the max |x|
    of each (batch row, head) slice (not of each row: a query's dQ sums dS =
    P (dP - D), which cancels exactly for a row that sees one key), two
    launches bitwise equal; then B5's forward at the serving shape: the
    output bitwise equal with and without the log-sum-exp, and the
    log-sum-exp against the plain version's.  Returns the largest
    |kernel - plain| of any gradient."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    bwd_build_facts(report)
    g = torch.Generator().manual_seed(SEED)

    def slice_err(out, ref):
        d = (out.double() - ref.double()).abs().amax(dim=(1, 3))
        top = ref.double().abs().amax(dim=(1, 3)).clamp_min(1e-30)
        return float((d / top).max())

    worst = 0.0
    for B, S, H, KV, hd, w, cap in TRAIN_BWD_CASES:
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            b = B if dt == torch.bfloat16 else min(B, 2)
            q, dout = (torch.randn((b, S, H, hd), generator=g).to(dev, dt)
                       for _ in range(2))
            k, v = (torch.randn((b, S, KV, hd), generator=g).to(dev, dt)
                    for _ in range(2))
            out, lse = fa.flash_attention_cuda(q, k, v, True, w, cap,
                                               with_lse=True)
            got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, True,
                                              w, cap)
            again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, True,
                                                w, cap)
            ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, True,
                                               w, cap)
            errs = [slice_err(a, r) for a, r in zip(got, ref)]
            abs_err = max(float((a.double() - r.double()).abs().max())
                          for a, r in zip(got, ref))
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            what = (f"B5 backward q {(b, S, H, hd)} kv {(b, S, KV, hd)} {dt} "
                    f"window {w} cap {cap}")
            if not (max(errs) <= tol and same):
                raise AssertionError(f"{what}: dq/dk/dv slice errors {errs} "
                                     f"(tol {tol}), two launches equal: {same}")
            worst = max(worst, abs_err)
            tops = "/".join(f"{float(r.abs().max()):.3g}" for r in ref)
            log(f"check {what}: max|kernel-plain| {abs_err:.3g} (max |dq|/|dk|"
                f"/|dv| {tops}); dq/dk/dv within {errs[0]:.3g} / {errs[1]:.3g} "
                f"/ {errs[2]:.3g} of each (batch, head) slice's max (tol {tol}); "
                f"two launches bitwise equal")
            del q, k, v, dout, out, lse, got, again, ref
    torch.cuda.empty_cache()
    # B5's forward at the serving shape: the log-sum-exp leaves O bitwise
    q = torch.randn((LM_BATCH, LM_PROMPT, 16, 128), generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn((LM_BATCH, LM_PROMPT, 8, 128), generator=g).to(
        dev, torch.bfloat16) for _ in range(2))
    out, lse = fa.flash_attention_cuda(q, k, v, True, with_lse=True)
    _, ref = fa.flash_attention_plain(q, k, v, True, with_lse=True)
    lse_err = float(((lse - ref).abs() / ref.abs().clamp_min(1.0)).max())
    if not (torch.equal(out, fa.flash_attention_cuda(q, k, v, True))
            and lse_err <= F32_TOL):
        raise AssertionError(f"B5 forward with the log-sum-exp: output "
                             f"changed or lse off by {lse_err}")
    log(f"check B5 forward q {tuple(q.shape)} bf16 with the log-sum-exp: output "
        f"bitwise equal to the call without it; lse within {lse_err:.3g} of the "
        f"plain logsumexp (relative, at least 1; tol {F32_TOL})")
    return worst


def train_full_width() -> dict:
    """Phase 17 (b): ``launch.train.main`` at TRAIN_ARGV with every launch
    counter at 0: per step B5's forward 2 x 2 n_layers (remat recomputes
    it), each backward kernel 2 x n_layers, no other kernel; every loss and
    gradient norm finite, the last loss below the first.  Returns the run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TR

    want = train_launches(get_config(TRAIN_ARCH).n_layers,
                          TRAIN_STEPS * TRAIN_ACCUM)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()     # earlier phases' tensors
    ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    run = TR.main(TRAIN_ARGV)
    wall = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    log(f"train {TRAIN_ARCH} launches: {got} (expected {want})")
    if got != want:
        raise AssertionError("training did not go through B5's forward and "
                             "backward kernels as often as its config implies")
    losses = [m["loss"] for m in run["steps"]]
    norms = [m["grad_norm"] for m in run["steps"]]
    if not (all(map(math.isfinite, losses + norms)) and losses[-1] < losses[0]):
        raise AssertionError(f"train losses {losses}, norms {norms}")
    ms = [m["ms"] for m in run["steps"]]
    run["step_ms"] = statistics.median(ms[1:])
    run["peak_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
    run["launches"] = got
    log(f"train {TRAIN_ARCH} full width ({' '.join(TRAIN_ARGV)}; {wall:.1f} s "
        f"with init): loss {losses[0]:.4f} -> {losses[-1]:.4f}, gnorm "
        f"{norms[0]:.3f} -> {norms[-1]:.3f}; step {run['step_ms']:.1f} ms "
        f"(median of steps 1-{TRAIN_STEPS - 1}; step 0 {ms[0]:.1f} ms), "
        f"{TRAIN_B * TRAIN_S / run['step_ms'] * 1e3:.0f} tok/s by that median, "
        f"{run['tok_s']:.0f} tok/s over the run; peak device memory "
        f"{run['peak_gib']:.2f} GiB above the {before / 2**30:.2f} GiB "
        f"allocated before it")
    return run


def train_against_cpu(dev) -> None:
    """Phase 17 (c): TRAIN_ARCH's widths in f32 cut to TRAIN_CPU_LAYERS,
    batch 2, seq 256: the loss and every gradient leaf on the card against
    the port's CPU path on the same weights and batch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map, tree_paths, tree_leaves

    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_CPU_LAYERS,
                                         dtype="float32")
    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = next(TokenStream(cfg, seq_len=256, batch=2, seed=SEED))
    got = {}
    for d in (dev, torch.device("cpu")):
        got[d.type] = value_and_grad(
            cfg, tree_map(lambda a: a.to(d), params),
            {k: torch.from_numpy(v).to(d) for k, v in batch.items()})
    (lc, gc), (lh, gh) = got["cuda"], got["cpu"]
    loss_err = abs(float(lc) - float(lh)) / abs(float(lh))
    worst, where = 0.0, ""
    for name, a, b in zip(tree_paths(gh), tree_leaves(gc), tree_leaves(gh)):
        err = float((a.cpu() - b).abs().max()) / float(b.abs().max())
        if err > worst:
            worst, where = err, name
    if not (loss_err <= TRAIN_CPU_TOL and worst <= TRAIN_CPU_TOL):
        raise AssertionError(f"train card vs CPU: loss {loss_err}, grads "
                             f"{worst} at {where}")
    log(f"train card vs CPU, {TRAIN_ARCH} widths, f32, {TRAIN_CPU_LAYERS} "
        f"layers, batch 2, seq 256 ({time.perf_counter() - t0:.1f} s): loss "
        f"{float(lh):.6f}, within {loss_err:.3g}; every gradient leaf within "
        f"{worst:.3g} of its max (worst {where}; tol {TRAIN_CPU_TOL})")


def train_restart(dev) -> None:
    """Phase 17 (d): TRAIN_ARCH at full width cut to TRAIN_CPU_LAYERS layers,
    bf16, TRAIN_B x TRAIN_S, grad_accum TRAIN_ACCUM: four steps, a
    checkpoint after the second under build/ (deleted afterwards), restored
    bitwise, and steps 3-4 from it within RESUME_TOL of the straight run."""
    import shutil

    import torch
    from repro_torch.checkpoint import store as CK
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_CPU_LAYERS)
    opt = AdamW(lr=3e-3, warmup_steps=5, total_steps=4)
    step = build_train_step(cfg, InputShape("restart", TRAIN_S, TRAIN_B,
                                            "train"),
                            opt=opt, grad_accum=TRAIN_ACCUM)
    params = get_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    state = opt.init(params)
    stream = TokenStream(cfg, seq_len=TRAIN_S, batch=TRAIN_B, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
               for _ in range(4)]
    where = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(where, ignore_errors=True)
    straight = []
    try:
        for i, b in enumerate(batches):
            params, state, m = step(params, state, b)
            straight.append(float(m["loss"]))
            if i == 1:
                CK.save((params, state), str(where), 2)
                saved = tree_map(lambda a: a.clone(), (params, state))
        restored = CK.restore(str(where), 2, saved, dev)
    finally:
        shutil.rmtree(where, ignore_errors=True)
    for a, b in zip(tree_leaves(restored), tree_leaves(saved)):
        if not (a.dtype == b.dtype and torch.equal(a, b)):
            raise AssertionError("the restored state differs from the saved")
    params, state = restored
    resumed = []
    for b in batches[2:]:
        params, state, m = step(params, state, b)
        resumed.append(float(m["loss"]))
    gaps = [abs(a - b) / abs(b) for a, b in zip(resumed, straight[2:])]
    if not max(gaps) <= RESUME_TOL:
        raise AssertionError(f"resumed losses {resumed} against {straight}")
    log(f"train restart, {TRAIN_ARCH} full width, {TRAIN_CPU_LAYERS} layers: "
        f"losses {straight}; the checkpoint after step 2 "
        f"({len(tree_leaves(saved))} leaves) restored bitwise; steps 3-4 "
        f"resumed {resumed}, within {max(gaps):.3g} of the straight run "
        f"(tol {RESUME_TOL}); checkpoint deleted")


def train_timing(dev, run) -> dict:
    """Phase 17 (e): B5's backward (its three kernels back to back) at
    TRAIN_ARCH's train shape, its plain version, its bound and SDPA's
    backward through autograd at the same shape (the forward outside the
    timed window); then a profiler trace of one full-width train step on
    (b)'s weights and state.  Returns the kernels-line row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.adamw import AdamW

    B, S, H, KV, hd = TRAIN_B, TRAIN_S, 15, 5, 64
    g = torch.Generator().manual_seed(SEED)
    bf16 = torch.bfloat16
    q, dout = (torch.randn((B, S, H, hd), generator=g).to(dev, bf16)
               for _ in range(2))
    k, v = (torch.randn((B, S, KV, hd), generator=g).to(dev, bf16)
            for _ in range(2))
    out, lse = fa.flash_attention_cuda(q, k, v, True, with_lse=True)
    # 10 hd flop a live pair (the recomputed S, dP, dV, dK, dQ); q, o, dO,
    # k, v and the log-sum-exp read, dq, dk, dv written (ops.COSTS's count)
    flops, nbytes = fa.backward_cost(q.shape, k.shape, q.element_size())
    bwd = lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, True)
    row = dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention_flash.py:32",
        ms=cuda_ms(bwd),
        plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, dout, True), reps=3),
        bound_ms=max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by=("operations" if flops / BF16_FLOP_PER_S
                  >= nbytes / HBM_BYTES_PER_S else "bytes"))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
    go = dout.transpose(1, 2)
    row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), go, retain_graph=True))
    log(f"time B5 backward q {tuple(q.shape)} kv {tuple(k.shape)} bf16 causal "
        f"(3 kernels): {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"SDPA backward (autograd, is_causal, enable_gqa) "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({flops} "
        f"flop at {BF16_FLOP_PER_S:.3g}/s, {nbytes} B); launches per train "
        f"step {TRAIN_ACCUM * get_config(TRAIN_ARCH).n_layers} of each kernel")
    del q, k, v, dout, out, lse, qt, kt, vt, o_sdpa, go

    cfg = get_config(TRAIN_ARCH)
    opt = AdamW(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    step = build_train_step(cfg, InputShape("trace", TRAIN_S, TRAIN_B, "train"),
                            opt=opt, grad_accum=TRAIN_ACCUM)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(TokenStream(
        cfg, seq_len=TRAIN_S, batch=TRAIN_B, seed=SEED)).items()}
    params, state = run["params"], run["opt_state"]
    walls = []

    def traced_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    busy, n_ev, by_name = traced_busy_ms("train step", traced_step)
    b5f = sum(t for name, t in by_name.items()
              if any(k in name for k in B5_FWD_KERNELS))
    b5b = sum(t for name, t in by_name.items() if "flash_attention_bwd" in name)
    row["train_step_busy_ms"] = busy
    row["train_step_traced_ms"] = walls[-1]
    row["train_step_idle_share"] = 1.0 - busy / walls[-1]
    log(f"trace train step {TRAIN_ARCH} full width ({TRAIN_B} x {TRAIN_S}, "
        f"grad_accum {TRAIN_ACCUM}): device busy {busy:.2f} ms, {n_ev} device "
        f"events; idle share {row['train_step_idle_share']:.3f} against the "
        f"traced step's {walls[-1]:.1f} ms (host clock, under the profiler; "
        f"(b)'s median step {run['step_ms']:.1f} ms); B5 forward "
        f"{b5f:.2f} ms, B5 backward {b5b:.2f} ms; largest: "
        + ", ".join(f"{name[:60]} {t:.2f} ms"
                    for name, t in by_name.most_common(5)))
    return row


def phase17(dev, report: str = "") -> tuple:
    """Training on the card (module docstring, phase 17), each part timed;
    ``report``: nvcc's report of the backward's build, if this run built it.
    Returns (B5 backward's kernels-line row, the launch counts of (b)'s
    run)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    t_phase = time.perf_counter()
    secs = {}
    t0 = time.perf_counter()
    err = train_bwd_checks(dev, report)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = train_full_width()
    secs["b"] = time.perf_counter() - t0
    for part, fn in (("c", lambda: train_against_cpu(dev)),
                     ("d", lambda: train_restart(dev))):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fn()
        secs[part] = time.perf_counter() - t0
    t0 = time.perf_counter()
    row = train_timing(dev, run)
    secs["e"] = time.perf_counter() - t0
    row["max_abs_err"] = err
    row["launches_by_kernel"] = {k: run["launches"][k] for k in fa.BWD_KERNELS}
    row["train_step_ms"] = run["step_ms"]
    row["train_tok_s"] = TRAIN_B * TRAIN_S / run["step_ms"] * 1e3
    row["train_peak_gib"] = run["peak_gib"]
    launches = run["launches"]
    del run
    torch.cuda.empty_cache()
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()) + ")")
    return row, launches


def compress_check(dev) -> None:
    """Phase 18 (a): ``compressed_psum`` over one full-width TRAIN_ARCH
    gradient tree (one micro-batch of phase 17's step, bf16) on the
    one-rank NCCL group, bitwise against the same call on the CPU over a
    gloo group on the same gradients; its time by CUDA events beside an
    fp32 all-reduce of the same elements, and the bytes each puts on the
    wire."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.registry import get_model
    from repro_torch.optim import compress as GC
    from repro_torch.tree import tree_leaves, tree_map

    make_host_mesh()                       # the one-rank NCCL group
    cfg = get_config(TRAIN_ARCH)
    params = get_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    batch = next(TokenStream(cfg, seq_len=TRAIN_S,
                             batch=TRAIN_B // TRAIN_ACCUM, seed=SEED))
    _, grads = value_and_grad(cfg, params, {
        k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    del params
    err = GC.init_error_state(grads)
    n = sum(g.numel() for g in tree_leaves(grads))
    mean, new_err = GC.compressed_psum(grads, err)
    cpu_mean, cpu_err = GC.compressed_psum(
        tree_map(lambda g: g.cpu(), grads), tree_map(lambda e: e.cpu(), err),
        group=dist.new_group(backend="gloo"))
    bad = [i for i, (a, b) in enumerate(zip(
        tree_leaves((mean, new_err)), tree_leaves((cpu_mean, cpu_err))))
        if not torch.equal(a.cpu(), b)]
    if bad:
        raise AssertionError(f"compressed_psum card vs CPU: leaves {bad} "
                             "differ")
    del cpu_mean, cpu_err, mean, new_err
    ms = cuda_ms(lambda: GC.compressed_psum(grads, err), reps=3, runs=3)
    flat = torch.cat([g.float().reshape(-1) for g in tree_leaves(grads)])
    fp32_ms = cuda_ms(lambda: dist.all_reduce(flat), reps=3, runs=3)
    nb = sum(-(-g.numel() // GC.BLOCK) for g in tree_leaves(grads))
    log(f"compressed_psum: {TRAIN_ARCH} gradients ({len(tree_leaves(grads))} "
        f"leaves, {n} elements, bf16, one micro-batch of {TRAIN_B // TRAIN_ACCUM}"
        f" x {TRAIN_S}), one-rank NCCL group: mean and error buffers bitwise "
        f"the CPU's (gloo); {ms:.3f} ms a call (CUDA events, median of 3 x "
        f"3) beside an fp32 all-reduce of the same elements {fp32_ms:.3f} ms; "
        f"wire bytes {n * GC.wire_bytes_per_element():.0f} (int8 and a "
        f"scale per {GC.BLOCK}, wire_bytes_per_element) against fp32's "
        f"{4 * n}; the all-reduces as called move {4 * nb * GC.BLOCK + 4 * nb}"
        f" B (an int32 payload of the padded blocks, the scales)")


def mesh_train_check(dev, per_step: dict) -> None:
    """Phase 18 (b): TRAIN_ARCH at phase 17's shape, MESH_STEPS steps of
    ``build_train_step(mesh=make_host_mesh())`` beside the mesh-free step
    on the same weights and batches, deterministic algorithms on (the
    embedding's backward otherwise accumulates with atomics): loss,
    gradient norm, learning rate, every parameter and moment bitwise equal;
    B5's launches per step those of phase 17 (``per_step``); each step's
    host ms."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import ShardingRules, gather
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import tree_leaves

    cfg = get_config(TRAIN_ARCH)
    shape = InputShape("t", TRAIN_S, TRAIN_B, "train")
    opt = AdamW(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    mesh = make_host_mesh()
    free = build_train_step(cfg, shape, opt=opt, grad_accum=TRAIN_ACCUM)
    meshed = build_train_step(cfg, shape, mesh=mesh, opt=opt,
                              grad_accum=TRAIN_ACCUM, rules=ShardingRules())
    p = get_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(SEED))
    st = opt.init(p)
    pm, sm = meshed.place(p, st)
    stream = TokenStream(cfg, seq_len=TRAIN_S, batch=TRAIN_B, seed=SEED)
    ms_free, ms_mesh = [], []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i in range(MESH_STEPS):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(stream).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, st, m0 = free(p, st, b)
            torch.cuda.synchronize()
            ms_free.append((time.perf_counter() - t0) * 1e3)
            ops.LAUNCHES.clear()
            t0 = time.perf_counter()
            pm, sm, m1 = meshed(pm, sm, b)
            torch.cuda.synchronize()
            ms_mesh.append((time.perf_counter() - t0) * 1e3)
            got = dict(ops.LAUNCHES)
            if got != per_step:
                raise AssertionError(f"mesh step {i} launches {got}, phase "
                                     f"17 a step {per_step}")
            if any(not torch.equal(m0[k], m1[k]) for k in m0):
                raise AssertionError(f"mesh step {i}: {m1} vs mesh-free {m0}")
            if not all(torch.equal(a, c) for a, c in zip(
                    tree_leaves((p, st)), tree_leaves(gather((pm, sm))))):
                raise AssertionError(f"mesh step {i}: parameters or moments "
                                     "differ from the mesh-free step's")
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"mesh train step: {TRAIN_ARCH} full width, {TRAIN_B} x {TRAIN_S} in "
        f"{TRAIN_ACCUM} micro-batches, {MESH_STEPS} steps on the 1 x 1 mesh "
        f"(one-rank NCCL group) beside the mesh-free step: loss "
        f"{float(m1['loss']):.6f}, grad norm {float(m1['grad_norm']):.6f}, "
        f"every parameter and moment bitwise equal; launches a step {got} "
        f"(phase 17's); step ms (host clock, deterministic algorithms) mesh "
        f"{', '.join(f'{t:.1f}' for t in ms_mesh)}, mesh-free "
        f"{', '.join(f'{t:.1f}' for t in ms_free)}")
    del p, st, pm, sm


def mac_mesh_check(dev, city: dict) -> None:
    """Phase 18 (c): ``MultiCellVecMac(mesh=make_host_mesh())`` over phase
    12 (b)'s city, CITY_SLOTS slots per policy, bitwise phase 12's
    reports (on one card the cells split into one part: the mesh path, a
    flag all-reduced a chunk and the reports gathered)."""
    import numpy as np
    import torch
    from repro_torch.core.engine_vec import MultiCellVecMac
    from repro_torch.core.ran import RanCell, RanConfig, make_policy
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()
    reqs = city_requests()
    for pol in MAC_POLICIES:
        mac = MultiCellVecMac([RanCell(policy=make_policy(pol),
                                       cfg=RanConfig(tti_s=1e-3))
                               for _ in range(CITY_CELLS)], device=dev,
                              mesh=mesh)
        gens = [np.random.default_rng(k)
                for k in np.random.SeedSequence(SEED).spawn(CITY_CELLS)]
        ms = []
        for slot in range(CITY_SLOTS):
            t0 = time.perf_counter()
            got = hexed(mac.serve_slot(reqs, gens))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if got != city[pol][slot]:
                raise AssertionError(f"MAC over the mesh, {pol}: slot {slot} "
                                     "differs from phase 12 (b)")
        log(f"MAC over the mesh, {pol}: {CITY_UES} UEs over {CITY_CELLS} "
            f"cells, {CITY_SLOTS} slots bitwise phase 12 (b)'s; ms per slot "
            f"{', '.join(f'{t:.1f}' for t in ms)}")


def dryrun_report(records, t_wall: float, peaks: dict) -> None:
    """Phase 18 (d): every dry-run cell OK or SKIP (SKIP only for
    ``long_500k`` of a family that is not sub-quadratic); the estimated
    peaks of phase 17's train step and phase 9's prefill beside the peaks
    the card measured; B5's counted operations in phase 9's prefill equal
    to the bound's formula; every train cell over the mesh the
    sequence-parallel step (``seq_shard``), with all-gathers and
    reduce-scatters over "model"."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    bad = [r for r in records if r["status"] == "FAIL" or (
        r["status"] == "SKIP") != (r["shape"] == "long_500k"
                                   and not get_config(r["arch"]).sub_quadratic())]
    if bad:
        raise AssertionError(f"dry-run cells: {bad}")
    for r in records:
        if r["status"] == "OK":
            log(f"dry-run {r['arch']} {r['shape']} {r['mesh']}: "
                f"{r['flops']:.4e} flop a device "
                f"(kernels {r['kernel_flops']:.4e}), arguments "
                f"{r['memory']['argument_bytes'] / 2**30:.2f} GiB, peak "
                f"{r['memory']['peak_bytes'] / 2**30:.2f} GiB, fits the card "
                f"{r['fits_card']}, collectives "
                f"{r['total_collective_bytes']:.4e} B ("
                + ", ".join(f"{k} {r['collective_count'][k]} x, {v:.4e} B"
                            for k, v in r["collective_bytes"].items() if v)
                + f"), seq_shard {r['seq_shard']}, {r['seconds']:.1f} s")
    mesh = "x".join(map(str, DRYRUN_MESH))
    tp = records[:-2]
    if not all(r["mesh"] == mesh for r in tp) or not all(
            r["total_collective_bytes"] > 0 for r in tp if r["status"] == "OK"):
        raise AssertionError(f"dry-run cells not over {mesh} with "
                             f"collectives")
    dec = [r for r in tp if r["kind"] == "decode" and r["status"] == "OK"]
    if not all(r["collective_count"]["all-gather"] > 0 for r in dec):
        raise AssertionError("a decode cell over "
                             f"{mesh} without its all-gathers")
    train = [r for r in tp if r["kind"] == "train" and r["status"] == "OK"]
    if not all(r["seq_shard"] and r["collective_count"]["reduce-scatter"] > 0
               and r["collective_count"]["all-gather"] > 0 for r in train):
        raise AssertionError(
            f"a train cell over {mesh} not sequence-parallel: "
            f"{[(r['arch'], r['seq_shard']) for r in train]}")
    log(f"dry-run decode cells over {mesh}: {len(dec)} OK, each on the "
        f"rank's chunks of the caches as cache_shardings places them; B6's "
        f"partial mode counted in "
        + ", ".join(f"{r['arch']} {r['shape']} "
                    f"({r['kernels']['decode_attention_lse']['flop']:.4e} "
                    f"flop a device)" for r in dec
                    if "decode_attention_lse" in r["kernels"]))
    for arch in (TRAIN_ARCH, LM_ARCH):
        r = next(r for r in tp if r["arch"] == arch and r["kind"] == "train")
        log(f"dry-run {arch} {r['shape']} over {mesh}, seq_shard "
            f"{r['seq_shard']}: per-device peak "
            f"{r['memory']['peak_bytes'] / 2**30:.2f} GiB, "
            f"{r['total_collective_bytes']:.4e} collective bytes a device "
            f"a step (the JAX package's units: "
            + ", ".join(f"{k} {v:.4e}" for k, v in
                        r["collective_bytes"].items() if v) + ")")
    n = collections.Counter(r["status"] for r in records)
    log(f"dry-run: {n['OK']} OK, {n['SKIP']} SKIP of {len(records)} cells at "
        f"full size on the meta device, {t_wall:.1f} s wall from its start "
        f"before phase 13 ({DRYRUN_JOBS} niced processes beside phases "
        f"13-18), {sum(r.get('seconds', 0) for r in records):.1f} s of cell "
        f"time")
    train, prefill = records[-2], records[-1]
    log(f"dry-run estimate vs the card: {TRAIN_ARCH} train {TRAIN_B} x "
        f"{TRAIN_S} ({TRAIN_ACCUM} micro-batches) peak "
        f"{train['memory']['peak_bytes'] / 2**30:.2f} GiB estimated, phase 17 "
        f"(b) measured {peaks['train']:.2f} GiB above what was allocated "
        f"before it; {LM_ARCH} prefill {LM_BATCH} x {LM_PROMPT} "
        f"{prefill['memory']['peak_bytes'] / 2**30:.2f} GiB estimated (the "
        f"prefill alone), phase 9's serve measured {peaks['serve']:.2f} GiB "
        f"(split, prefill and decode)")
    cfg = get_config(LM_ARCH)
    want = cfg.n_layers * fa.forward_cost(
        (LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.head_dim),
        (LM_BATCH, LM_PROMPT, cfg.n_kv_heads, cfg.head_dim), 2)[0]
    pairs = LM_PROMPT * (LM_PROMPT + 1) // 2
    formula = (cfg.n_layers * LM_BATCH * cfg.n_heads * pairs * 4
               * cfg.head_dim)
    got = prefill["kernels"]["flash_attention"]["flop"]
    if not got == want == formula:
        raise AssertionError(f"B5 counted {got} flop in the prefill, the "
                             f"bound formula {formula}")
    log(f"dry-run {LM_ARCH} prefill: B5 counted {got} flop over "
        f"{cfg.n_layers} launches = {cfg.n_layers} x {LM_BATCH} x "
        f"{cfg.n_heads} heads x {pairs} live pairs x 4 x {cfg.head_dim}, the "
        f"bound formula's")


def dryrun_start():
    """Phase 18 (d), started before phase 13: every dry-run cell at full
    size over DRYRUN_MESH (the production 16 x 16 layout, each on rank 0's
    view of a stand-in group of 256; decode on the rank's cache chunks),
    and phase 17's train step and phase 9's prefill at 1 x 1, counted
    on the meta device by DRYRUN_JOBS single-thread processes niced to 19,
    so that they take cores the card's phases leave idle.  Returns (pool,
    futures, start time)."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as DR
    todo = [(a, n, {"mesh_shape": DRYRUN_MESH})
            for a, n in DR.cells(ARCH_IDS)] + [
        (TRAIN_ARCH, InputShape("train", TRAIN_S, TRAIN_B, "train"),
         {"grad_accum": TRAIN_ACCUM}),
        (LM_ARCH, InputShape("prefill", LM_PROMPT, LM_BATCH, "prefill"))]
    t0 = time.perf_counter()
    pool, futs = DR.submit_cells(todo, DRYRUN_JOBS, nice=19)
    return pool, futs, t0


def phase18(dev, per_step: dict, city: dict, peaks: dict, dry) -> None:
    """The mesh, sharding and launch slice (module docstring, phase 18);
    ``dry`` is ``dryrun_start``'s."""
    t_phase = time.perf_counter()
    pool, futs, t_dry = dry
    with pool:
        secs = {}
        for part, fn in (("a", lambda: compress_check(dev)),
                         ("b", lambda: mesh_train_check(dev, per_step)),
                         ("c", lambda: mac_mesh_check(dev, city))):
            t0 = time.perf_counter()
            fn()
            secs[part] = time.perf_counter() - t0
        t0 = time.perf_counter()
        records = [f.result() for f in futs]
        t_wall = time.perf_counter() - t_dry
    secs["d"] = time.perf_counter() - t0
    dryrun_report(records, t_wall, peaks)
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items())
        + "; (d) the wait for the dry-run after (c))")


def tp_shard_checks(dev) -> dict:
    """Phase 19 (a): B5 on head shards at full width, as the tensor-parallel
    layers call it.  At LM_ARCH's prefill shape (16 q heads over 8 kv heads,
    bf16) each half of the heads (8 q over 4 kv) is bitwise the matching
    columns of the whole launch.  At TRAIN_ARCH's train shape (15 over 5,
    bf16) two q slices that share kv head 0 (q heads 0 and 1-2, as ranks
    that split a kv group read it): each slice's output bitwise the whole
    launch's columns, its backward's dQ bitwise the whole backward's, and
    dK and dV of the shared head, summed over the slices, within BF16_TOL
    of each (batch row, head) slice's max of the whole backward's (each
    slice rounds its own sum to bf16).  Returns the largest relative error
    of the summed dK/dV."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(SEED)
    bf16 = torch.bfloat16
    q = torch.randn((LM_BATCH, LM_PROMPT, 16, 128), generator=g).to(dev, bf16)
    k, v = (torch.randn((LM_BATCH, LM_PROMPT, 8, 128), generator=g).to(
        dev, bf16) for _ in range(2))
    whole = fa.flash_attention_cuda(q, k, v, True)
    for h in range(2):
        part = fa.flash_attention_cuda(
            q[:, :, 8 * h:8 * h + 8].contiguous(),
            k[:, :, 4 * h:4 * h + 4].contiguous(),
            v[:, :, 4 * h:4 * h + 4].contiguous(), True)
        if not torch.equal(part, whole[:, :, 8 * h:8 * h + 8]):
            raise AssertionError(f"B5 on heads {8 * h}-{8 * h + 7} of "
                                 f"{LM_ARCH}'s prefill differs from the "
                                 "whole launch's columns")
    log(f"check B5 on head shards, q {tuple(q.shape)} kv {tuple(k.shape)} "
        f"bf16: each half (8 q over 4 kv heads) bitwise the whole launch's "
        f"columns")
    del q, k, v, whole
    q, dout = (torch.randn((TRAIN_B, TRAIN_S, 15, 64), generator=g).to(
        dev, bf16) for _ in range(2))
    k, v = (torch.randn((TRAIN_B, TRAIN_S, 5, 64), generator=g).to(dev, bf16)
            for _ in range(2))
    out, lse = fa.flash_attention_cuda(q, k, v, True, with_lse=True)
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, True)
    dk_sum = torch.zeros_like(dk[:, :, :1], dtype=torch.float32)
    dv_sum = torch.zeros_like(dk_sum)
    k0, v0 = k[:, :, :1].contiguous(), v[:, :, :1].contiguous()
    for lo, hi in ((0, 1), (1, 3)):
        qs, ds = q[:, :, lo:hi].contiguous(), dout[:, :, lo:hi].contiguous()
        o_s, l_s = fa.flash_attention_cuda(qs, k0, v0, True, with_lse=True)
        dq_s, dk_s, dv_s = fa.flash_attention_bwd_cuda(qs, k0, v0, o_s, l_s,
                                                       ds, True)
        if not (torch.equal(o_s, out[:, :, lo:hi])
                and torch.equal(dq_s, dq[:, :, lo:hi])):
            raise AssertionError(f"B5 on q heads {lo}-{hi - 1} over kv head "
                                 "0: output or dQ differs from the whole "
                                 "launch's columns")
        dk_sum += dk_s.float()
        dv_sum += dv_s.float()

    def slice_err(a, ref):
        d = (a.double() - ref.double()).abs().amax(dim=(1, 3))
        return float((d / ref.double().abs().amax(dim=(1, 3)).clamp_min(
            1e-30)).max())
    errs = (slice_err(dk_sum, dk[:, :, :1]), slice_err(dv_sum, dv[:, :, :1]))
    if not max(errs) <= BF16_TOL:
        raise AssertionError(f"B5 backward on q slices sharing kv head 0: "
                             f"summed dK/dV off by {errs} (tol {BF16_TOL})")
    log(f"check B5 forward and backward on q slices that share a kv head, "
        f"q {tuple(q.shape)} kv {tuple(k.shape)} bf16, q heads 0 and 1-2 "
        f"over kv head 0: outputs and dQ bitwise the whole launch's columns; "
        f"dK, dV summed over the slices within {errs[0]:.3g} / {errs[1]:.3g} "
        f"of each (batch row, head) slice's max of the whole backward's (tol "
        f"{BF16_TOL})")
    return max(errs)


def b6_partial_inputs(dev, dt):
    """Phase 6's B6 shape (LM_ARCH's heads, a cache of LM_PROMPT + LM_GEN
    rows) in dtype ``dt``, cut into two halves of its rows as two ranks of
    a (1, 2) mesh hold it: q, K, V, the whole cache's live rows B6_LENS (a
    row live in both halves, one live in part of the second, one in the
    first only, one with none) and each half's (start, its live rows)."""
    import torch
    cfg = __import__("repro_torch.configs", fromlist=["get_config"]
                     ).get_config(LM_ARCH)
    g = torch.Generator().manual_seed(SEED + 6)
    S = LM_PROMPT + LM_GEN
    q = torch.randn((LM_BATCH, 1, cfg.n_heads, cfg.head_dim),
                    generator=g).to(dev, dt)
    ck, cv = (torch.randn((LM_BATCH, cfg.n_kv_heads, S, cfg.head_dim),
                          generator=g).to(dev, dt) for _ in range(2))
    lens = torch.tensor(B6_LENS, dtype=torch.int32, device=dev)
    half = S // 2
    halves = [(h * half, (lens - h * half).clamp(0, half).to(torch.int32))
              for h in range(2)]
    return q, ck, cv, lens, halves


def b6_partial_check(dev) -> float:
    """Phase 3: B6's partial mode (``return_lse``) on each half of phase
    6's cache, in bf16 and f32: out (float32) and lse against the plain
    version within ATTN_TOL, -inf and zeros where a half holds no live row,
    two launches bitwise equal; the halves merged
    (``collectives.merge_partials``, rounded once to q's dtype) against
    the whole default launch, each output row within F32_TOL / BF16_TOL of
    its max.  Returns the largest |kernel - plain|."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.collectives import merge_partials
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        q, ck, cv, lens, halves = b6_partial_inputs(dev, dt)
        whole = da.decode_attention_cuda(q, ck, cv, lens)
        outs, lses, errs = [], [], []
        for start, live in halves:
            n = ck.shape[2] // 2
            k_, v_ = (c[:, :, start:start + n].contiguous() for c in (ck, cv))
            out, lse = da.decode_attention_cuda(q, k_, v_, live, 0.0, True)
            again = da.decode_attention_cuda(q, k_, v_, live, 0.0, True)
            ref, ref_lse = da.decode_attention_plain(q, k_, v_, live, 0.0,
                                                     True)
            torch.cuda.synchronize()
            empty = live == 0
            fin = ~empty
            err = max(float((out - ref).abs().max()),
                      float((lse[fin] - ref_lse[fin]).abs().max()))
            if not (out.dtype == lse.dtype == torch.float32
                    and err <= ATTN_TOL and torch.equal(out, again[0])
                    and torch.equal(lse, again[1])
                    and bool(torch.isneginf(lse[empty]).all())
                    and not out[empty].any()
                    and bool(torch.isfinite(lse[fin]).all())):
                raise AssertionError(f"B6 partial mode {dt} rows {start}+: "
                                     f"err {err}, -inf/zeros on empty rows, "
                                     "or two launches differ")
            worst = max(worst, err)
            errs.append(err)
            outs.append(out)
            lses.append(lse[:, None])
        merged = merge_partials(torch.stack(outs), torch.stack(lses), dt)
        d = (merged.double() - whole.double()).abs().amax(-1)
        rel = float((d / whole.double().abs().amax(-1).clamp_min(
            1e-30)).max())
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        if not (merged.dtype == dt and rel <= tol):
            raise AssertionError(f"B6 partial halves merged {dt}: worst row "
                                 f"{rel} of its max (tol {tol})")
        log(f"check B6 partial mode q {tuple(q.shape)} on two halves of "
            f"{tuple(ck.shape)} ({ck.shape[2] // 2} rows each), kv_len "
            f"{B6_LENS} -> halves {[h[1].tolist() for h in halves]} "
            f"{str(dt).removeprefix('torch.')}: out and lse max|kernel-plain| "
            f"{errs[0]:.3g} / {errs[1]:.3g} (tol {ATTN_TOL}), -inf and zeros "
            f"where a half holds no live row, two launches bitwise equal; the "
            f"halves merged within {rel:.3g} of each row's max of the whole "
            f"launch (tol {tol})")
    return worst


def b6_partial_times(dev, err: float) -> dict:
    """Phase 6: B6's partial mode on one half of phase 6's bf16 cache (the
    first, live rows B6_LENS' share) beside the default mode on the whole
    cache, back to back; its plain version; its bound (K and V of each
    batch row's live rows, q, the float32 out and lse); no single PyTorch
    call returns a log-sum-exp over a masked cache, so no library time."""
    import torch
    from repro_torch.kernels import decode_attention as da
    q, ck, cv, lens, halves = b6_partial_inputs(dev, torch.bfloat16)
    n = ck.shape[2] // 2
    start, live = halves[0]
    k_, v_ = (c[:, :, start:start + n].contiguous() for c in (ck, cv))
    flops, nbytes = da.cost(q.shape, k_.shape, q.element_size(),
                            live.tolist(), True)
    r = dict(source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:64",
             max_abs_err=err,
             ms=cuda_ms(lambda: da.decode_attention_cuda(q, k_, v_, live, 0.0,
                                                         True)),
             plain_ms=cuda_ms(lambda: da.decode_attention_plain(
                 q, k_, v_, live, 0.0, True)),
             bound_ms=max(flops / BF16_FLOP_PER_S,
                          nbytes / HBM_BYTES_PER_S) * 1e3,
             bound_by=("operations" if flops / BF16_FLOP_PER_S
                       >= nbytes / HBM_BYTES_PER_S else "bytes"),
             library_ms=None,
             tp_default_whole_ms=cuda_ms(lambda: da.decode_attention_cuda(
                 q, ck, cv, lens)))
    log(f"time B6 partial mode q {tuple(q.shape)} on the first half "
        f"{tuple(k_.shape)} of the cache, live rows {live.tolist()} bf16: "
        f"kernel {r['ms']:.4f} ms b2b, plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({nbytes} B, {r['bound_by']}); the default "
        f"mode on the whole cache, live rows {lens.tolist()}: "
        f"{r['tp_default_whole_ms']:.4f} ms b2b")
    return r


def tp_rank(rank: int, world: int, tmp: str, port: int, ins: dict):
    """A rank of phase 19 (b)-(f), spawned: joins a gloo group of ``world``
    ranks as ``torchrun`` would start it (``env://`` on localhost:``port``),
    every rank on card 0 (``LOCAL_RANK`` 0: NCCL refuses two ranks on one
    device, gloo takes them), probes the collectives the mesh code issues
    on CUDA tensors, serves LM_ARCH (prefill, then decode teacher-forced on
    ``ins``' tokens), runs TRAIN_ARCH's f32 train steps (sequence-parallel)
    and LM_ARCH's bf16 train steps at cut depth (sequence-parallel, then
    Megatron-TP alone), then the f32 decode cuts, over a (1, world) mesh,
    and saves what the parent checks to ``tmp``."""
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import ensure_process_group
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0")
    ensure_process_group("cuda", backend="gloo")
    try:
        out = {"probe": tp_probe(world)}
        out["serve"] = tp_serve(tp_serve_cfg(None), *ins[None])
        out["train"] = tp_train(rank)
        runs = {sq: tp_train_bf16(sq) for sq in (True, False)}
        if rank == 0:
            one = tp_bf16_one()
            for run in runs.values():
                run["compare"] = tp_bf16_compare(run, one)
            del one
        for run in runs.values():
            del run["m"]
        out["train_bf16"], out["train_bf16_tp"] = runs[True], runs[False]
        for name in TP_DECODE_CUTS:
            out[name] = tp_serve(tp_serve_cfg(name), *ins[name])
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_probe(world: int) -> dict:
    """Each collective ``launch/collectives.py`` issues, once on a CUDA
    tensor of each model dtype over the gloo group: "ok" where the values
    came back right, else the error."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import collectives as C
    got = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((4, 3), float(dist.get_rank() + 1), dtype=dt,
                       device="cuda")
        for what, fn, want in (
                ("all_reduce sum", lambda: C.all_reduce(x.clone(),
                                                        dist.group.WORLD),
                 world * (world + 1) / 2),
                ("all_reduce max", lambda: C.all_reduce(
                    x.clone(), dist.group.WORLD, "max"), float(world)),
                ("reduce_scatter", lambda: C.reduce_scatter(
                    x.clone(), dist.group.WORLD), world * (world + 1) / 2),
                ("all_gather", lambda: C.all_gather(
                    x, dist.group.WORLD)[::4], None)):
            try:
                y = fn().float().cpu()
                ok = (torch.equal(y, torch.full_like(y, want)) if want
                      else torch.equal(y[:, 0], torch.arange(
                          1.0, world + 1)))
                got[f"{what} {dt}"] = "ok" if ok else f"wrong values {y}"
            except Exception as e:      # the probe's finding, logged
                got[f"{what} {dt}"] = f"{type(e).__name__}: {e}"[:200]
    return got


def tp_serve_cfg(name):
    """LM_ARCH's config (None), or one of TP_DECODE_CUTS: cut and in
    f32."""
    from repro_torch.configs import get_config
    if name is None:
        return get_config(LM_ARCH)
    arch, over = TP_DECODE_CUTS[name][:2]
    return get_config(arch).replace(**over, dtype="float32")


def tp_decode_sizes(name):
    """(batch, prompt, decode steps) of LM_ARCH's serving (None) or a
    cut of TP_DECODE_CUTS."""
    if name is None:
        return LM_BATCH, LM_PROMPT, LM_GEN
    return TP_DECODE_CUTS[name][2:]


def tp_serve(cfg, tokens, dec) -> dict:
    """Phase 19 (b), (e), (f) on a rank: ``cfg`` at full width (or cut),
    weights from SEED on the card, through ``build_prefill(mesh=)`` of
    ``tokens`` into caches of prompt + len(``dec``) rows over (1, 2), then
    one ``build_decode_step(mesh=)`` per token of ``dec`` (teacher-forced):
    the gathered logits of the prefill and of each step, each part's
    launches (counters at 0 before), the shapes of this rank's cache
    chunks and the host ms."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import local
    from repro_torch.launch.steps import build_decode_step, build_prefill
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_map
    dev = torch.device("cuda", 0)
    mesh = make_host_mesh(model_parallel=2, device=dev)
    B, S = tokens.shape
    max_len = S + len(dec)
    pre = build_prefill(cfg, InputShape("p", S, B, "prefill"), mesh=mesh,
                        max_len=max_len)
    step = build_decode_step(cfg, InputShape("d", max_len, B, "decode"),
                             mesh=mesh)
    placed = pre.place(get_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"ms": [], "logits": []}
    t_part = time.perf_counter()
    with torch.no_grad():
        ops.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = pre(placed, {"tokens": tokens.to(dev)})
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["prefill_launches"] = dict(ops.LAUNCHES)
        out["prefill"] = logits.float().cpu()
        out["chunks"] = tree_map(lambda c: tuple(c.shape), local(caches))
        ops.LAUNCHES.clear()
        for i, tok in enumerate(dec):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = step(placed, caches, {"tokens": tok.to(dev)},
                                  S + i)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["logits"].append(logits.float().cpu())
        out["launches"] = dict(ops.LAUNCHES)
    out["seconds"] = time.perf_counter() - t_part
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del placed, caches
    torch.cuda.empty_cache()
    return out


def tp_cfg():
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH).replace(dtype="float32")


def tp_bf16_cfg():
    from repro_torch.configs import get_config
    return get_config(LM_ARCH).replace(n_layers=TP_BF16_LAYERS)


def tp_opt():
    from repro_torch.optim.adamw import AdamW
    return AdamW(lr=3e-3, warmup_steps=5, total_steps=TRAIN_STEPS)


def tp_train(rank: int) -> dict:
    """Phase 19 (c) on a rank: TP_STEPS train steps of TRAIN_ARCH at full
    width in f32 (phase 17's shape and micro-batches) through
    ``build_train_step(mesh=)`` over (1, 2), its default
    ``seq_shard=True`` (whether the step cut the sequence in "seq"),
    weights from SEED; then rank 0 runs the mesh-free steps on the same
    weights and batches and holds the gathered parameters and AdamW
    moments to them (``tp_train_compare``)."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import gather
    from repro_torch.launch.steps import build_train_step, seq_cut
    from repro_torch.models.registry import get_model
    dev = torch.device("cuda", 0)
    cfg, opt = tp_cfg(), tp_opt()
    mesh = make_host_mesh(model_parallel=2, device=dev)
    shape = InputShape("t", TRAIN_S, TRAIN_B, "train")
    step = build_train_step(cfg, shape, mesh=mesh, opt=opt,
                            grad_accum=TRAIN_ACCUM)
    p = get_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(SEED))
    placed, st = step.place(p, opt.init(p))
    del p
    torch.cuda.empty_cache()
    stream = TokenStream(cfg, seq_len=TRAIN_S, batch=TRAIN_B, seed=SEED)
    metrics, ms, launches = [], [], []
    for _ in range(TP_STEPS):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
        ops.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed, st, m = step(placed, st, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(ops.LAUNCHES))
        metrics.append({k: float(v) for k, v in m.items()})
    full = gather(placed)
    moments = gather({"m": st.m, "v": st.v})
    del placed, st
    torch.cuda.empty_cache()
    out = {"metrics": metrics, "ms": ms, "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "seq": seq_cut(mesh, cfg, shape, TRAIN_ACCUM)}
    if rank == 0:
        out["compare"] = tp_train_compare(full, moments, metrics)
    return out


def tp_train_compare(tp_params, tp_moments, tp_metrics) -> dict:
    """The mesh-free steps (``_loss_and_grads`` then ``opt.update``, what
    ``build_train_step`` without a mesh runs) on the same weights and
    batches, held as the CPU tests hold the mesh step
    (``tests/test_torch_tp_steps.py``) but within TRAIN_CPU_TOL: each
    step's loss and gradient norm relative; AdamW's moments after the last
    step, every leaf within TRAIN_CPU_TOL of its max (m and v are sums of
    the steps' gradients and their squares, so this holds every element's
    gradient); every parameter leaf within TRAIN_CPU_TOL of its max where
    the one-process gradient was at least TP_FLAT_GRAD at every step, and
    elsewhere (flat: AdamW's update of such an element may turn with a
    rounding of its gradient, by up to 2 lr a step, which the CPU tests
    allow) within the first step's learning rate, so that no flat
    element's update turned."""
    import torch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.steps import _loss_and_grads
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_leaves, tree_paths
    dev = torch.device("cuda", 0)
    cfg, opt = tp_cfg(), tp_opt()
    p = get_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(SEED))
    st = opt.init(p)
    stream = TokenStream(cfg, seq_len=TRAIN_S, batch=TRAIN_B, seed=SEED)
    flat, lrs, errs = None, [], {"loss": 0.0, "grad_norm": 0.0}
    for i in range(TP_STEPS):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
        loss, grads = _loss_and_grads(cfg, p, b, TRAIN_ACCUM)
        f = [g.abs() < TP_FLAT_GRAD for g in tree_leaves(grads)]
        flat = f if flat is None else [a | c for a, c in zip(flat, f)]
        del f
        p, st, m = opt.update(grads, st, p)
        del grads
        lrs.append(float(m["lr"]))
        for k, want in (("loss", float(loss)),
                        ("grad_norm", float(m["grad_norm"]))):
            errs[k] = max(errs[k], abs(tp_metrics[i][k] - want) / abs(want))
    worst = {"leaf": 0.0, "flat": 0.0, "m": 0.0, "v": 0.0, "path": ""}
    bad, n_flat, n = [], 0, 0
    for path, a, c, fl in zip(tree_paths(p), tree_leaves(p),
                              tree_leaves(tp_params), flat):
        d = (a - c).abs()
        e = (float(d[~fl].max()) / float(a.abs().max())
             if bool((~fl).any()) else 0.0)
        ef = float(d[fl].max()) if bool(fl.any()) else 0.0
        if e > worst["leaf"]:
            worst["leaf"], worst["path"] = e, path
        worst["flat"] = max(worst["flat"], ef)
        n_flat += int(fl.sum())
        n += d.numel()
        if not (e <= TRAIN_CPU_TOL and ef <= lrs[0]):
            bad.append((path, e, ef))
    for k in ("m", "v"):
        mine = getattr(st, k)
        for path, a, c in zip(tree_paths(mine), tree_leaves(mine),
                              tree_leaves(tp_moments[k])):
            e = float((a - c).abs().max()) / max(float(a.abs().max()), 1e-30)
            worst[k] = max(worst[k], e)
            if not e <= TRAIN_CPU_TOL:
                bad.append((k + path, e))
    return {"errs": errs, "worst": worst, "flat_share": n_flat / n,
            "lr1": lrs[0], "bad": bad[:8]}


def tp_bf16_steps(step, params, st, first_m) -> dict:
    """TP_STEPS steps of ``step`` from (``params``, ``st``) on
    TokenStream's batches for ``tp_bf16_cfg``: each step's metrics, host
    ms, launches and B5's counted operations and bytes (forward and
    backward), and ``first_m(st)`` after the first step."""
    import torch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    stream = TokenStream(tp_bf16_cfg(), seq_len=TRAIN_S, batch=TP_BF16_B,
                         seed=SEED)
    out = {"metrics": [], "ms": [], "launches": [], "costs": []}
    for i in range(TP_STEPS):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
        ops.LAUNCHES.clear()
        ops.COSTS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, st, m = step(params, st, b)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(dict(ops.LAUNCHES))
        out["costs"].append({k: ops.COSTS[k] for k in ops.COSTS
                             if k[0].startswith("flash_attention")})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["m"] = first_m(st)
    return out


def tp_train_bf16(seq_shard: bool) -> dict:
    """Phase 19 (d) on a rank: TP_STEPS train steps of LM_ARCH in bf16 (its
    config's dtype) at full width cut to TP_BF16_LAYERS layers, TP_BF16_B x
    TRAIN_S tokens in TRAIN_ACCUM micro-batches, through
    ``build_train_step(mesh=, seq_shard=)`` over (1, 2), weights from SEED:
    its 16 q heads over 8 kv heads split, 8 over 4 a rank.  AdamW's first
    moment after the first step is (1 - b1) times the clipped gradient,
    gathered whole ("m"); "seq" whether the step cut the sequence."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import gather
    from repro_torch.launch.steps import build_train_step, seq_cut
    from repro_torch.models.registry import get_model
    dev = torch.device("cuda", 0)
    cfg, opt = tp_bf16_cfg(), tp_opt()
    shape = InputShape("t", TRAIN_S, TP_BF16_B, "train")
    mesh = make_host_mesh(model_parallel=2, device=dev)
    step = build_train_step(cfg, shape, opt=opt, grad_accum=TRAIN_ACCUM,
                            mesh=mesh, seq_shard=seq_shard)
    p = get_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(SEED))
    placed, st = step.place(p, opt.init(p))
    del p
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = tp_bf16_steps(step, placed, st, lambda s: gather(s.m))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seq"] = seq_cut(mesh, cfg, shape, TRAIN_ACCUM, seq_shard)
    del placed, st
    torch.cuda.empty_cache()
    return out


def tp_bf16_one() -> dict:
    """The mesh-free bf16 steps (``build_train_step`` without a mesh) on
    ``tp_train_bf16``'s weights and batches (``tp_bf16_steps``)."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.registry import get_model
    dev = torch.device("cuda", 0)
    cfg, opt = tp_bf16_cfg(), tp_opt()
    step = build_train_step(cfg, InputShape("t", TRAIN_S, TP_BF16_B, "train"),
                            opt=opt, grad_accum=TRAIN_ACCUM)
    p = get_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(SEED))
    out = tp_bf16_steps(step, p, opt.init(p), lambda s: s.m)
    del p
    torch.cuda.empty_cache()
    return out


def tp_bf16_compare(tp: dict, one: dict) -> dict:
    """A mesh run of ``tp_train_bf16`` against the mesh-free run ``one``
    (``tp_bf16_one``): each step's loss and gradient norm, relative; the
    first step's first moment, each leaf's largest difference over its
    max; the mesh-free run's metrics, launches, B5's counted operations
    and bytes and host ms."""
    from repro_torch.tree import tree_leaves, tree_paths
    errs = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
                   zip(tp["metrics"], one["metrics"]))
            for k in ("loss", "grad_norm")}
    grad = {path: float((a - c).abs().max()) / max(float(c.abs().max()),
                                                   1e-30)
            for path, a, c in zip(tree_paths(one["m"]), tree_leaves(tp["m"]),
                                  tree_leaves(one["m"]))}
    return {"errs": errs, "grad": grad, "metrics": one["metrics"],
            "launches": one["launches"], "costs": one["costs"],
            "ms": one["ms"]}


def tp_two_ranks(dev, ins: dict) -> dict:
    """Phase 19 (b)-(d): two ranks spawned on the one card over gloo
    (NCCL refuses two ranks on one device; ``ensure_process_group``'s
    ``backend``), each running ``tp_rank``;
    their saved results, rank 0 first.  Fails, and ends the ranks, after
    TP_TIMEOUT_S."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp
    (ROOT / "build").mkdir(exist_ok=True)
    with socket.socket() as sock:          # a free port on this machine
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        ctx = mp.spawn(tp_rank, args=(2, tmp, port, ins), nprocs=2,
                       join=False)
        deadline = time.monotonic() + TP_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"phase 19 ranks did not finish in "
                                   f"{TP_TIMEOUT_S} s")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(2)]


def tp_decode_refs(dev, name) -> tuple:
    """The (1, 1) run that phase 19 (b), (e) or (f) holds the (1, 2) run
    to: ``tp_serve_cfg(name)`` on the same weights (SEED), a prompt from
    SEED + 19, ``T.prefill`` into prompt + steps rows, then greedy
    ``T.decode_step``s.  Returns (the ranks' inputs: prompt and the decode
    tokens, on the host; the prefill's logits and each step's)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    cfg = tp_serve_cfg(name)
    B, S, n = tp_decode_sizes(name)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev, dtype=torch.int32)
    with torch.no_grad():
        params = get_model(cfg, dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        logits, caches = T.prefill(cfg, params, {"tokens": tokens}, S + n)
        want, dec = [logits.float().cpu()], []
        for i in range(n):
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            dec.append(tok.cpu())
            logits, caches = T.decode_step(cfg, params, caches,
                                           {"tokens": tok}, S + i)
            want.append(logits.float().cpu())
    del params, caches
    torch.cuda.empty_cache()
    return (tokens.cpu(), dec), want


def tp_decode_check(name, ranks, want, tol) -> dict:
    """Phase 19 (b), (e), (f): each rank's prefill and decode steps
    (``tp_serve``) against the (1, 1) run's logits, each within ``tol`` of
    that step's max |logit|; B6 in its partial mode only, once a global
    attention layer a step a rank; both ranks' logits bitwise equal (the
    combine merges in rank order on every rank).  Returns the figures."""
    cfg = tp_serve_cfg(name)
    key = "serve" if name is None else name
    n_attn = cfg.n_layers          # every layer's cache is cut on its rows
    errs = []
    for r, got in enumerate(ranks):
        run = got[key]
        steps = [run["prefill"]] + run["logits"]
        errs.append([float((a - b).abs().max()) / float(b.abs().max())
                     for a, b in zip(steps, want)])
        lse = run["launches"].get("decode_attention_lse", 0)
        if not (len(steps) == len(want) and max(errs[-1]) <= tol
                and lse == n_attn * len(run["logits"])
                and run["launches"].get("decode_attention", 0) == 0):
            raise AssertionError(
                f"TP decode {key} rank {r}: logits off by up to "
                f"{max(errs[-1])} of max |logit| (tol {tol}), launches "
                f"{run['launches']}")
    for a, b in zip([ranks[0][key]["prefill"]] + ranks[0][key]["logits"],
                    [ranks[1][key]["prefill"]] + ranks[1][key]["logits"]):
        if not bool((a == b).all()):
            raise AssertionError(f"TP decode {key}: the ranks' logits differ")
    return {"errs": errs[0], "worst": max(max(e) for e in errs)}


def phase19(dev, rows: dict) -> int:
    """Tensor parallelism over a "model" axis (module docstring, phase
    19): (a) B5 on head shards; (b) LM_ARCH's prefill and (e) its decode,
    (c) TRAIN_ARCH's f32 train steps (sequence-parallel), (d) LM_ARCH's
    bf16 train steps at cut depth (with and without ``seq_shard``) and
    (e)-(f) f32 decode cuts, at (1, 2) on two gloo ranks
    sharing the card, against the one-process runs; B5's launches on the
    TP path into ``rows``.  Returns B6's partial-mode launches in (e)'s
    full-width decode on rank 0."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    secs = {}
    t0 = time.perf_counter()
    tp_shard_checks(dev)
    secs["a"] = time.perf_counter() - t0
    # the (1, 1) runs the ranks are held to, on the same weights and
    # prompts; their greedy tokens feed the ranks' decode steps
    t0 = time.perf_counter()
    ins, refs = {}, {}
    for name in (None,) + tuple(TP_DECODE_CUTS):
        ins[name], refs[name] = tp_decode_refs(dev, name)
    secs["refs"] = time.perf_counter() - t0
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    ranks = tp_two_ranks(dev, ins)
    secs["b-f"] = time.perf_counter() - t0
    for k, v in ranks[0]["probe"].items():
        log(f"gloo on CUDA tensors, two ranks on one card: {k}: {v}")
    if any(v != "ok" for r in ranks for v in r["probe"].values()):
        raise AssertionError("a collective of the mesh code failed on CUDA "
                             "tensors over gloo")
    # (b): the prefill, its caches placed by cache_shardings (the rows of
    # every kv head, half a rank)
    want = refs[None][0]
    top = float(want.abs().max())
    max_len = LM_PROMPT + LM_GEN
    kv_want = (cfg.n_layers, LM_BATCH, cfg.n_kv_heads, max_len // 2,
               cfg.head_dim)
    for r, got in enumerate(ranks):
        pre = got["serve"]
        rel = float((pre["prefill"] - want).abs().max()) / top
        n_b5 = pre["prefill_launches"].get("flash_attention", 0)
        kv = pre["chunks"][0]["attn"]["k"]
        if not (rel <= HANDOFF_BF16_TOL and n_b5 == cfg.n_layers
                and kv == kv_want):
            raise AssertionError(f"TP prefill rank {r}: logits off by {rel} "
                                 f"of max |logit| (tol {HANDOFF_BF16_TOL}), "
                                 f"launches {pre['prefill_launches']}, KV "
                                 f"cache chunk {kv} (want {kv_want})")
        log(f"TP prefill {LM_ARCH} full width bf16, batch {LM_BATCH}, prompt "
            f"{LM_PROMPT} into {max_len} rows, (data, model) = (1, 2), rank "
            f"{r} of two gloo ranks on one card: gathered last-position "
            f"logits within {rel:.3g} of max |logit| {top:.4g} of the (1, 1) "
            f"prefill (tol {HANDOFF_BF16_TOL}); B5 launches {n_b5} (one a "
            f"layer, {cfg.n_heads // 2} q over {cfg.n_kv_heads // 2} kv "
            f"heads), KV cache chunk {kv} (cache_shardings: the rows of every "
            f"kv head, half a rank); host ms {pre['prefill_ms']:.1f} (gloo "
            f"stages every collective through the host: not a TP speed); "
            f"peak {pre['peak_gib']:.2f} GiB")
    rows["flash_attention"]["tp_prefill_launches"] = \
        ranks[0]["serve"]["prefill_launches"].get("flash_attention", 0)
    # (e), (f): decode at (1, 2) against the (1, 1) decode
    for name, tol in ((None, HANDOFF_BF16_TOL), ("qwen_f32", HANDOFF_F32_TOL),
                      ("hymba_f32", HANDOFF_F32_TOL)):
        c = tp_decode_check(name, ranks, refs[name], tol)
        run = ranks[0]["serve" if name is None else name]
        ccfg = tp_serve_cfg(name)
        B, S, n = tp_decode_sizes(name)
        chunks = run["chunks"]
        if name == "hymba_f32":
            ring = next(ch["attn"]["k"] for ch in chunks
                        if ch["attn"]["k"][3] == ccfg.sliding_window // 2)
            glob = chunks[0]["attn"]["k"]
            mamba = chunks[0]["mamba"]["state"]
            inner = ccfg.ssm_expand * ccfg.d_model
            if not (glob[3] == (S + n) // 2 and mamba[2] == inner // 2):
                raise AssertionError(f"TP decode hymba chunks {chunks}")
            shapes = (f"ring chunk {ring} (its {ccfg.sliding_window} rows, "
                      f"half a rank), global cache chunk {glob}, mamba state "
                      f"chunk {mamba} (its {inner} channels, half a rank)")
        else:
            shapes = f"KV cache chunk {chunks[0]['attn']['k']}"
        label = ("(e) " + LM_ARCH + " full width bf16" if name is None else
                 f"({'e' if name == 'qwen_f32' else 'f'}) "
                 f"{TP_DECODE_CUTS[name][0]} cut to {ccfg.n_layers} layers "
                 f"in f32")
        ms = run["ms"]
        log(f"TP decode {label}, batch {B}, prompt {S}, {n} steps "
            f"teacher-forced on the (1, 1) run's greedy tokens, (data, "
            f"model) = (1, 2) on two gloo ranks on one card: each step's "
            f"gathered logits within {max(c['errs'][1:]):.3g} of max |logit| "
            f"of the (1, 1) decode at worst (tol {tol}; by step "
            f"{', '.join(f'{e:.2g}' for e in c['errs'][1:])}), both ranks' "
            f"bitwise equal; B6 partial mode "
            f"{run['launches'].get('decode_attention_lse', 0)} launches a "
            f"rank ({run['launches'].get('decode_attention_lse', 0) // n} a "
            f"step), the default mode none; {shapes}; host ms a step median "
            f"{statistics.median(ms):.1f} (min {min(ms):.1f}, max "
            f"{max(ms):.1f}; "
            f"gloo through the host, two ranks sharing one card: not a TP "
            f"speed); {run['seconds']:.1f} s for the prefill and the steps")
    lse_launches = ranks[0]["serve"]["launches"].get("decode_attention_lse", 0)
    rows["decode_attention_lse"]["tp_decode_ms"] = \
        statistics.median(ranks[0]["serve"]["ms"])
    # (c)
    tr = [r["train"] for r in ranks]
    cmp_ = tr[0]["compare"]
    for i in range(TP_STEPS):
        if tr[0]["metrics"][i] != tr[1]["metrics"][i]:
            raise AssertionError(f"SP step {i}: the ranks' metrics differ")
    per_step = tr[0]["launches"][-1]
    want_launch = {"flash_attention": 2 * 2 * get_config(TRAIN_ARCH).n_layers,
                   **{k: 2 * get_config(TRAIN_ARCH).n_layers
                      for k in ("flash_attention_bwd_delta",
                                "flash_attention_bwd_dkdv",
                                "flash_attention_bwd_dq")}}
    if not (max(cmp_["errs"].values()) <= TRAIN_CPU_TOL and not cmp_["bad"]
            and all(r["seq"] for r in tr)
            and all(lc == want_launch for lc in tr[0]["launches"])):
        raise AssertionError(f"SP train steps against the (1, 1) steps: "
                             f"{cmp_}, sequence cut {[r['seq'] for r in tr]}, "
                             f"launches {tr[0]['launches']}")
    w = cmp_["worst"]
    log(f"SP train {TRAIN_ARCH} full width in f32, {TRAIN_B} x {TRAIN_S} in "
        f"{TRAIN_ACCUM} micro-batches, {TP_STEPS} steps at (1, 2) on two gloo "
        f"ranks on one card, seq_shard=True (each rank's {TRAIN_S // 2} "
        f"positions between layers; attention whole on the gathered "
        f"sequence), against the mesh-free steps on the same weights "
        f"and batches: loss and gradient norm within "
        f"{cmp_['errs']['loss']:.3g} / {cmp_['errs']['grad_norm']:.3g} "
        f"relative (tol {TRAIN_CPU_TOL}); AdamW's m and v within "
        f"{w['m']:.3g} / {w['v']:.3g} of each leaf's max (tol "
        f"{TRAIN_CPU_TOL}); every parameter leaf within {w['leaf']:.3g} of its "
        f"max ({w['path']}; tol {TRAIN_CPU_TOL}) where the one-process |g| "
        f"was at least "
        f"{TP_FLAT_GRAD} at every step; below it at some step "
        f"({100 * cmp_['flat_share']:.3f} % of the elements) within "
        f"{w['flat']:.3g} (tol the first step's learning rate "
        f"{cmp_['lr1']:.4g}); losses "
        f"{', '.join(f'{m['loss']:.6f}' for m in tr[0]['metrics'])}; launches "
        f"a step {per_step}; step ms rank 0 "
        f"{', '.join(f'{t:.1f}' for t in tr[0]['ms'])}, rank 1 "
        f"{', '.join(f'{t:.1f}' for t in tr[1]['ms'])} (gloo through the host"
        f", two ranks sharing one card: not a TP speed); peak "
        f"{tr[0]['peak_gib']:.2f} GiB")
    rows["flash_attention"]["sp_train_f32_launches"] = \
        per_step["flash_attention"]
    rows["flash_attention_bwd"]["sp_train_f32_launches"] = \
        per_step["flash_attention_bwd_dkdv"]
    # (d): the heads split, in bf16, sequence-parallel and Megatron-TP alone
    for key, sq in (("train_bf16", True), ("train_bf16_tp", False)):
        per_step = tp_bf16_check([r[key] for r in ranks], sq)
        name = "sp_train_launches" if sq else "tp_train_launches"
        rows["flash_attention"][name] = per_step["flash_attention"]
        rows["flash_attention_bwd"][name] = \
            per_step["flash_attention_bwd_dkdv"]
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()) + ")")
    ops.LAUNCHES.clear()
    return lse_launches


def tp_bf16_check(tb, seq_shard: bool) -> dict:
    """Phase 19 (d): both ranks' ``tp_train_bf16`` run with ``seq_shard``
    against the mesh-free steps (rank 0's "compare"): the ranks' metrics
    equal, loss and gradient norm within BF16_TOL, the first gradient
    within TP_BF16_TOL of each leaf's max, the launches the mesh-free
    step's and B5's counted operations and bytes half of its; the
    sequence cut where ``seq_shard`` asks for it.  Logs the figures and
    returns the launches of the last step."""
    cmp_ = tb[0]["compare"]
    bcfg = tp_bf16_cfg()
    worst_path = max(cmp_["grad"], key=cmp_["grad"].get)
    half = all({k: 2 * v for k, v in c.items()} == o for c, o in
               zip(tb[0]["costs"], cmp_["costs"]))
    what = "SP" if seq_shard else "TP"
    if not (all(tb[0]["metrics"][i] == tb[1]["metrics"][i]
                for i in range(TP_STEPS))
            and all(r["seq"] == seq_shard for r in tb)
            and max(cmp_["errs"].values()) <= BF16_TOL
            and cmp_["grad"][worst_path] <= TP_BF16_TOL
            and tb[0]["launches"] == cmp_["launches"]
            and all(lc.get("flash_attention", 0) > 0
                    and lc.get("flash_attention_bwd_dkdv", 0) > 0
                    for lc in tb[0]["launches"]) and half):
        raise AssertionError(f"bf16 {what} train steps against the (1, 1) "
                             f"steps: errs {cmp_['errs']}, worst gradient "
                             f"leaf {worst_path} {cmp_['grad'][worst_path]}, "
                             f"sequence cut {[r['seq'] for r in tb]}, "
                             f"launches {tb[0]['launches']} vs "
                             f"{cmp_['launches']}, B5 costs {tb[0]['costs']} "
                             f"vs {cmp_['costs']}")
    per_step = tb[0]["launches"][-1]
    log(f"{what} train {LM_ARCH} full width in bf16 cut to {bcfg.n_layers} "
        f"layers, {TP_BF16_B} x {TRAIN_S} in {TRAIN_ACCUM} micro-batches, "
        f"{TP_STEPS} steps at (1, 2) on two gloo ranks on one card, "
        f"seq_shard={seq_shard}, against "
        f"the mesh-free steps on the same weights and batches: loss and "
        f"gradient norm within {cmp_['errs']['loss']:.3g} / "
        f"{cmp_['errs']['grad_norm']:.3g} relative (tol {BF16_TOL}); the "
        f"first step's gradient (AdamW's m) within "
        f"{cmp_['grad'][worst_path]:.3g} of its leaf's max at worst "
        f"({worst_path}; tol {TP_BF16_TOL}); losses "
        f"{', '.join(f'{m['loss']:.6f}' for m in tb[0]['metrics'])} (mesh-"
        f"free {', '.join(f'{m['loss']:.6f}' for m in cmp_['metrics'])}); "
        f"launches a step {per_step}, the mesh-free step's too; B5's counted "
        f"operations and bytes, forward and backward, half the mesh-free "
        f"step's ({bcfg.n_heads // 2} q over {bcfg.n_kv_heads // 2} kv heads "
        f"a rank); step ms rank 0 "
        f"{', '.join(f'{t:.1f}' for t in tb[0]['ms'])}, rank 1 "
        f"{', '.join(f'{t:.1f}' for t in tb[1]['ms'])} (not a TP speed), "
        f"mesh-free {', '.join(f'{t:.1f}' for t in cmp_['ms'])}; peak "
        f"{tb[0]['peak_gib']:.2f} GiB")
    return per_step


def lm_against_cpu(cut, dev, S: int = 256, B: int = 2) -> None:
    """Phase 13 (c), 14 (d), 15 (d): phase 10's check on ``cut``, a cut-depth
    f32 config: batch B, prompt S (token ids, or the frontend's frames or
    patches and tokens, drawn as ``serve`` draws them), prefill, two greedy
    decode steps (codebook tokens for musicgen) and the split tail at layer
    2 on the card and on the port's CPU path.  A MoE config's every MoE
    layer must route every token to the same experts on both; logits within
    CPU_TOL of the card's max |logit|; the CPU decode of the card's split
    payload bitwise equal to the card's."""
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.core.compression import ActivationCodec
    from repro_torch.core.splitting import LMSplitPlan, Workload, split_option
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    from repro_torch.tree import tree_map

    cfg = cut
    steps, split = 2, min(2, cut.n_layers - 1)
    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p_gpu = T.init(cut, gen, dev)
    p_cpu = tree_map(lambda a: a.to(cpu), p_gpu)
    model = get_model(cut, dev)
    prompt = model.concrete(model.prefill_inputs(InputShape(
        "cli", seq_len=S, global_batch=B, kind="prefill")), gen)
    t0 = time.perf_counter()
    logits, routes = {}, {}
    opt = split_option(split)
    with torch.no_grad():
        payload, _ = LMSplitPlan(cut, p_gpu, candidates=(split,),
                                 workload=Workload(n_tokens=S),
                                 device=dev).head(prompt, opt)
        comp = ActivationCodec(device=dev).compress(payload)
        dec = {}
        for where, params_, d in (("card", p_gpu, dev), ("cpu", p_cpu, cpu)):
            with L.record_routing() as rec:
                lg, caches = T.prefill(cut, params_, {
                    k: v.to(d) for k, v in prompt.items()}, S + steps)
                logits.setdefault("prefill", []).append(lg)
                tok = logits["prefill"][0][:, -1:].argmax(-1).to(torch.int32)
                for i in range(steps):
                    lg, caches = T.decode_step(cut, params_, caches,
                                               {"tokens": tok.to(d)}, S + i)
                    logits.setdefault(f"decode {i}", []).append(lg)
                    tok = logits[f"decode {i}"][0].argmax(-1).to(torch.int32)
                dec[where] = ActivationCodec(device=d).decompress(comp)
                plan = LMSplitPlan(cut, params_, candidates=(split,),
                                   workload=Workload(n_tokens=S), device=d)
                logits.setdefault("split tail", []).append(
                    plan.tail(dec[where], opt))
            routes[where] = rec
    if not torch.equal(dec["cpu"]["h"].view(torch.int32),
                       dec["card"]["h"].cpu().view(torch.int32)):
        raise AssertionError("CPU decode of the card's split payload differs")
    n_moe = (cut.n_layers - cut.first_dense_layers) if cut.n_experts else 0
    want_calls = n_moe * (1 + steps) + (cut.n_layers - split) * bool(n_moe)
    card, host = routes["card"], routes["cpu"]
    if not len(card) == len(host) == want_calls:
        raise AssertionError(f"{len(card)} / {len(host)} MoE layer calls "
                             f"recorded, {want_calls} expected")
    # a token's k experts are a set: their order (by probability) decides
    # only the order of the k-sum, so two probabilities a few ulps apart may
    # come in either order; the set, and each (token, expert)'s keep and
    # slot, must be equal
    n_assign = n_swapped = 0
    for a, b in zip(card, host):
        a = {k: v.cpu() for k, v in a.items()}
        (ea, oa), (eb, ob) = a["idx"].sort(-1), b["idx"].sort(-1)
        if not (torch.equal(ea, eb)
                and all(torch.equal(a[n].gather(-1, oa), b[n].gather(-1, ob))
                        for n in ("keep", "slot"))):
            raise AssertionError(f"{cut.name}: the card and the CPU route a "
                                 "token to different experts")
        n_assign += b["idx"].numel()
        n_swapped += int((a["idx"] != b["idx"]).any(-1).sum())
    worst = 0.0
    for name, (a, b) in logits.items():
        a = a.cpu()
        rel = float((a - b).abs().max()) / float(a.abs().max())
        worst = max(worst, rel)
        log(f"card vs CPU, {cut.name} {name} logits {tuple(a.shape)}: max "
            f"|diff| / max |logit| = {rel:.3g}")
    if not worst <= CPU_TOL:
        raise AssertionError(f"{cut.name} card vs CPU: {worst}")
    routing = (f"{len(card)} MoE layer calls, {n_assign} routed "
               f"assignments, the same experts, slots and drops on both "
               f"({n_swapped} tokens with two experts in the other order); "
               if n_moe else "")
    what = ", ".join(f"{k} {tuple(v.shape)}" for k, v in prompt.items())
    log(f"CPU path, {cfg.name} widths, f32, {cut.n_layers} layers, batch {B}, "
        f"prompt {S}: {what} ({time.perf_counter() - t0:.1f} s): prefill, {steps} "
        f"decode steps and the split tail at layer {split} within {worst:.3g} "
        f"of the card (rel. tol {CPU_TOL}); {routing}the CPU decode of the "
        f"card's payload ({comp.raw_bytes} B -> {comp.compressed_bytes} B) "
        f"bitwise equal")


def decode_trace(arch: str, dev, prefill: bool = False) -> None:
    """Phase 16: one model's decode step on serve's weights and prompt
    (batch 4, the cache after a 2048-position prefill): the host-clock ms of
    three steps before the trace, then the card's busy ms and device events
    of three steps under the profiler, and the idle share between them.
    With ``prefill``, the prefill too, and B5's part of its busy time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import serve as SV
    from repro_torch.models.registry import get_model

    model = get_model(get_config(arch), dev)
    gen = torch.Generator(device=dev).manual_seed(SV.SEED)
    params = model.init(gen)
    shape = InputShape("cli", seq_len=LM_PROMPT, global_batch=LM_BATCH,
                       kind="prefill")
    batch = model.concrete(model.prefill_inputs(shape), gen)
    # the prompt's last token again, or musicgen's codebook tokens
    step_in = ({"tokens": batch["tokens"][:, -1:]} if "tokens" in batch
               else model.concrete(model.decode_inputs(shape), gen))
    at = [LM_PROMPT]

    def steps():
        for _ in range(3):
            model.decode_step(params, caches, step_in, at[0])
            at[0] += 1

    def prefill_fn():
        return model.prefill(params, batch, LM_PROMPT + 32)

    with torch.no_grad():
        _, caches = prefill_fn()
        if prefill:
            wall = host_ms(prefill_fn, runs=1)
            busy, n_ev, by_name = traced_busy_ms(f"{arch} prefill", prefill_fn)
            b5 = sum(t for name, t in by_name.items()
                     if "flash_attention" in name)
            log(f"trace {arch} prefill (batch {LM_BATCH}, prompt {LM_PROMPT}): "
                f"device busy {busy:.2f} ms of {wall:.2f} ms host-clock time, "
                f"idle share {max(0.0, 1 - busy / wall):.3f}, {n_ev} device "
                f"events, of which B5 {b5:.3f} ms; largest: "
                + ", ".join(f"{name[:48]} {t:.3f} ms"
                            for name, t in by_name.most_common(4)))
        wall = host_ms(steps, runs=1) / 3               # after a warm-up
        busy, n_ev, by_name = traced_busy_ms(f"{arch} decode", steps)
    log(f"trace {arch} decode step (batch {LM_BATCH}, cache of {LM_PROMPT}): "
        f"device busy {busy / 3:.2f} ms of {wall:.2f} ms host-clock time, "
        f"idle share {max(0.0, 1 - busy / 3 / wall):.3f}, {n_ev // 3} device "
        f"events a step; largest: "
        + ", ".join(f"{name[:48]} {t / 3:.3f} ms"
                    for name, t in by_name.most_common(4)))
    del params, caches
    torch.cuda.empty_cache()


def phase13(dev) -> None:
    """The MoE family at full width (module docstring, phase 13), each part
    timed."""
    import torch
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    granite, deepseek = MOE_ARCHS
    secs = {}
    for part, fn in (("a", lambda: moe_serve(granite)),
                     ("b", lambda: moe_handoffs(dev)),
                     ("c", lambda: [lm_against_cpu(get_config(a).replace(
                         n_layers=4, dtype="float32"), dev)
                                    for a in MOE_ARCHS]),
                     ("d", lambda: moe_serve(deepseek))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        secs[part] = time.perf_counter() - t0
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()) + ")")


def recurrent_serve(arch: str) -> None:
    """Phase 14 (a), (b): ``serve_checked``; for xLSTM the host-bound sLSTM
    time loop is also timed alone on one layer at the prompt's shape, and
    its share of the prefill printed."""
    import torch
    from repro_torch.models import ssm as SSM

    cfg, hist, line = serve_checked(arch)
    if cfg.slstm_positions:
        layer = SSM.slstm_block_init(cfg, torch.Generator(
            device="cuda").manual_seed(SEED))
        x = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), device="cuda",
                        dtype=getattr(torch, cfg.dtype))
        with torch.no_grad():
            one = host_ms(lambda: SSM.slstm_block_apply(cfg, layer, x), runs=1)
        k = len(cfg.slstm_positions)
        share = k * one / (hist["prefill_s"]["sum"] * 1e3)
        line += (f"; the sLSTM time loop {one:.1f} ms a layer on the host "
                 f"clock, {k} layers {share:.1%} of the prefill")
    log(line)


def recurrent_handoffs(dev) -> None:
    """Phase 14 (c): prefill to S-1 plus one decode step against a prefill
    to S at S = RECURRENT_PROMPT, batch LM_BATCH: Hymba at full depth in
    bf16 (the windowed layers' prefill merge rolls its ring, the decode step
    writes slot (S-1) % 1024 and reads all 1024 rows) within
    HANDOFF_BF16_TOL; then both models cut (RECURRENT_CUTS) at batch 2 in
    f32 on their bf16 weights upcast, within SSM_HANDOFF_F32_TOL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    def cases():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        hymba = get_config(RECURRENT_ARCHS[0])
        params = T.init(hymba, gen, dev)
        tokens = torch.randint(0, hymba.vocab_size,
                               (LM_BATCH, RECURRENT_PROMPT), generator=gen,
                               device=dev, dtype=torch.int32)
        yield hymba, params, tokens, HANDOFF_BF16_TOL
        del params
        for arch in RECURRENT_ARCHS:
            cut = get_config(arch).replace(**RECURRENT_CUTS[arch])
            p16 = T.init(cut, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
            yield (cut.replace(dtype="float32"),
                   tree_map(lambda a: a.float(), p16),
                   tokens[:2] % cut.vocab_size, SSM_HANDOFF_F32_TOL)

    for cfg, params, toks, tol in cases():
        gap, top = handoff_gap(*handoff_logits(cfg, params, {"tokens": toks}))
        del params
        log(f"{cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, batch "
            f"{toks.shape[0]}: prefill to {RECURRENT_PROMPT - 1} + decode vs "
            f"prefill to {RECURRENT_PROMPT}: max |diff| {gap:.4g} = "
            f"{gap / top:.3g} of max |logit| {top:.4g} (tol {tol})")
        if not gap <= tol * top:
            raise AssertionError(f"{cfg.name} {cfg.dtype}: prefill -> decode "
                                 "logits disagree")


def phase14(dev) -> None:
    """The recurrent and hybrid families at full width (module docstring,
    phase 14), each part timed."""
    import torch
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    hymba, xlstm = RECURRENT_ARCHS
    secs = {}
    for part, fn in (("a", lambda: recurrent_serve(hymba)),
                     ("b", lambda: recurrent_serve(xlstm)),
                     ("c", lambda: recurrent_handoffs(dev)),
                     ("d", lambda: [lm_against_cpu(get_config(a).replace(
                         dtype="float32", **RECURRENT_CUTS[a]), dev,
                         RECURRENT_PROMPT) for a in RECURRENT_ARCHS])):
        t0 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        secs[part] = time.perf_counter() - t0
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()) + ")")


def frontend_handoffs(dev) -> None:
    """Phase 15 (c): prefill to S-1 plus one decode step against a prefill
    to S at batch LM_BATCH, S = LM_PROMPT, at full depth in bf16 within
    HANDOFF_BF16_TOL: musicgen decoding its last frame, and decoding
    codebook tokens whose summed embeddings are the full prompt's last frame;
    InternVL decoding its last text token after the patches; LM_ARCH with
    each of SOFTCAPS.  Then each cut to 4 layers in f32 at batch 2 within
    HANDOFF_F32_TOL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model

    def prompt(cfg, gen, B):
        model = get_model(cfg, dev)
        return model.concrete(model.prefill_inputs(InputShape(
            "cli", seq_len=LM_PROMPT, global_batch=B, kind="prefill")), gen)

    def runs(cfg, params, gen, B):
        """(what, config, batch, last) of each check on one model."""
        batch = prompt(cfg, gen, B)
        if cfg.frontend == "none":
            for cap in SOFTCAPS:
                yield (f"capped at {cap}",
                       cfg.replace(attn_logit_softcap=cap), batch, None)
            return
        yield "", cfg, batch, None
        if cfg.n_codebooks:
            tok = torch.randint(0, cfg.vocab_size, (B, 1, cfg.n_codebooks),
                                generator=gen, device=dev, dtype=torch.int32)
            frame = T.embed_inputs(cfg, params, {"tokens": tok}).float()
            yield ("codebook tokens decoded", cfg,
                   {"frames": torch.cat([batch["frames"][:, :-1], frame], 1)},
                   {"tokens": tok})

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for arch in FRONTEND_ARCHS + (LM_ARCH,):
        for cfg, B, tol in ((get_config(arch), LM_BATCH, HANDOFF_BF16_TOL),
                            (get_config(arch).replace(n_layers=4,
                                                      dtype="float32"),
                             2, HANDOFF_F32_TOL)):
            params = T.init(cfg, gen, dev)
            for what, c, batch, last in runs(cfg, params, gen, B):
                gap, top = handoff_gap(*handoff_logits(c, params, batch,
                                                       last))
                log(f"{c.name}{', ' + what if what else ''}, {c.n_layers} "
                    f"layers, {c.dtype}, batch {B}: prefill to "
                    f"{LM_PROMPT - 1} + decode vs prefill to {LM_PROMPT}: "
                    f"max |diff| {gap:.4g} = {gap / top:.3g} of max |logit| "
                    f"{top:.4g} (tol {tol})")
                if not gap <= tol * top:
                    raise AssertionError(f"{c.name} {what} {c.dtype}: "
                                         "prefill -> decode logits disagree")
            del params
            torch.cuda.empty_cache()


def phase15(dev) -> None:
    """The frontends and soft-capping at full width (module docstring,
    phase 15), each part timed."""
    import torch
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    musicgen, internvl = FRONTEND_ARCHS
    secs = {}
    for part, fn in (("a", lambda: log(serve_checked(musicgen)[2])),
                     ("b", lambda: log(serve_checked(internvl)[2])),
                     ("c", lambda: frontend_handoffs(dev)),
                     ("d", lambda: [
                         lm_against_cpu(get_config(musicgen).replace(
                             n_layers=4, dtype="float32"), dev),
                         lm_against_cpu(get_config(LM_ARCH).replace(
                             n_layers=4, dtype="float32",
                             attn_logit_softcap=BINDING_SOFTCAP), dev),
                         lm_against_cpu(get_config(internvl).replace(
                             n_layers=INTERNVL_CPU_LAYERS, dtype="float32"),
                             dev, INTERNVL_CPU_S, INTERNVL_CPU_B)])):
        t0 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        secs[part] = time.perf_counter() - t0
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items()) + ")")


def frame_launches(logs, n_blocks: int) -> dict:
    """B1, B2, B3 launches that ``run_frame`` calls imply, fused codec:
    every block of the model a frame, one codec pair a split frame."""
    pairs = sum(lg.option.startswith("split") for lg in logs)
    return {"fused_window_attention": n_blocks * len(logs),
            "codec_encode": pairs, "codec_decode": pairs}


@contextlib.contextmanager
def recorded_tails(tails: list):
    """Record (option, size, padded, 0.0) of every ``tail_batched`` call of
    any ``SwinSplitPlan`` (an example builds its own plan)."""
    from repro_torch.core.splitting import SwinSplitPlan
    tail_batched = SwinSplitPlan.tail_batched

    def recorded(self, payloads, option, pad_to=None):
        tails.append((option, len(payloads), pad_to, 0.0))
        return tail_batched(self, payloads, option, pad_to=pad_to)
    SwinSplitPlan.tail_batched = recorded
    try:
        yield
    finally:
        SwinSplitPlan.tail_batched = tail_batched


def phase20(dev, system) -> dict:
    """The five examples through their entry points at full width (module
    docstring, phase 20), on ``system`` (phase 8's calibration).  Returns
    the phase's launches by kernel row."""
    import os
    import shutil
    import signal

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.swin_t_detection import CONFIG as cfg
    from repro_torch.core.splitting import SERVER_ONLY, UE_ONLY, SwinSplitPlan
    from repro_torch.examples import adaptive_split_video as ASV
    from repro_torch.examples import cell_video as CV
    from repro_torch.examples import quickstart as QS
    from repro_torch.examples import split_serve_lm as SSL
    from repro_torch.examples import train_lm as TLM
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    flags = ["--device", "cuda"]
    n_blocks = sum(cfg.depths)
    head_blocks = {o: (n_blocks if o == UE_ONLY else 0 if o == SERVER_ONLY
                       else sum(cfg.depths[:int(o.removeprefix("split"))]))
                   for o in SwinSplitPlan(cfg, None, device=dev).options}
    out_dir = ROOT / "build" / "examples"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    total = collections.Counter()
    walls = {}

    def counted(part: str, fn, expected):
        """Run ``fn`` with every launch counter at 0; the launches must be
        ``expected(result)``'s."""
        ops.LAUNCHES.clear()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls[part] = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
        want = {k: v for k, v in expected(res).items() if v}
        log(f"examples ({part}): launches {got} (expected {want}); "
            f"{walls[part]:.1f} s host wall")
        if got != want:
            raise AssertionError(f"examples ({part}): the launches do not "
                                 "match its logs and batches")
        total.update(got)
        return res

    # (f) train_lm (two trainers in subprocesses, mostly eager dispatch and
    # checkpoint writes on the host) runs beside (a)-(e): the example's CLI
    # in a process group of its own, killed with its trainers if the phase
    # fails; out_dir is its temporary directory, so its checkpoints land
    # there
    train_log = out_dir / "train_lm.log"
    t_train = time.time()
    with open(train_log, "w") as f:
        trainer = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.examples.train_lm"] + flags,
            stdout=f, cwd=ROOT, start_new_session=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     TMPDIR=str(out_dir)))
    try:
        # (a) quickstart: head, fused codec, tail, the drift, the controller
        qs = counted("a quickstart",
                     lambda: QS.run(QS.parse_args(flags), system=system),
                     lambda r: {"fused_window_attention": 2 * n_blocks,
                                "codec_encode": 1, "codec_decode": 1})
        check_detections(cfg, qs["out"], "quickstart tail")
        check_detections(cfg, qs["full"], "quickstart forward_full")
        if not (np.isfinite(qs["drift"])
                and qs["raw_bytes"] > qs["compressed_bytes"] > 0):
            raise AssertionError(f"quickstart: {qs['drift']}, "
                                 f"{qs['raw_bytes']} -> "
                                 f"{qs['compressed_bytes']} B")
        log(f"quickstart: split2 boundary {qs['n_tensors']} tensors, "
            f"{qs['raw_bytes']} -> {qs['compressed_bytes']} B, drift "
            f"{qs['drift']:.4f}; " + ", ".join(
                f"{lvl:+d} dB {d.option} ({d.delay_s * 1e3:.0f} ms)"
                for lvl, d in zip(QS.LEVELS, qs["decisions"])))

        # (b) adaptive_split_video over its default jammer sweep
        asv = counted("b adaptive_split_video",
                      lambda: ASV.run(ASV.parse_args(flags), system=system),
                      lambda r: frame_launches(r["logs"], n_blocks))
        delays = np.asarray([lg.delay_s for lg in asv["logs"]])
        opts = [lg.option for lg in asv["logs"]]
        if len(opts) != 40 or not np.isfinite(delays).all():
            raise AssertionError("adaptive_split_video: frames or delays")
        log(f"adaptive_split_video: {len(opts)} frames, mean delay "
            f"{delays.mean() * 1e3:.0f} ms, p95 "
            f"{np.quantile(delays, .95) * 1e3:.0f} ms, split usage "
            f"{dict(collections.Counter(opts))}, adaptation events "
            f"{sum(a != b for a, b in zip(opts, opts[1:]))}")

        # (c), (d) cell_video: its defaults, then at a fixed split (the
        # heads, the codec and the split tails on the examples' path), then
        # the event engine with every engine flag and a trace
        trace_path = out_dir / "cell_trace.json"
        for part, argv, lockstep in (
                ("c cell_video", [], True),
                ("c cell_video --fixed split2",
                 ["--fixed", "split2", "--frames", "3"], True),
                ("d cell_video --fps --chaos --mobility --trace",
                 ["--fps", "0.5", "--jitter", "0.05", "--inflight", "2",
                  "--policy", "edf", "--mobility", "--chaos", "--frames",
                  "6", "--trace", str(trace_path)], False)):
            args = CV.parse_args(flags + argv)
            tails = []

            def cell_run(args=args, tails=tails):
                with recorded_tails(tails):
                    return CV.run(args, system=system)
            got = counted(part, cell_run,
                          lambda r, tails=tails, lockstep=lockstep:
                          cell_expected_launches(r["res"].logs, tails,
                                                 head_blocks, n_blocks, False,
                                                 lockstep))
            res = got["res"]
            if (res.stats.n_batches != len(tails)
                    or res.stats.n_requests != sum(n for _, n, _, _ in tails)):
                raise AssertionError(f"{part}: batches {res.stats}")
            if args.fixed and not (
                    {lg.option for lg in res.logs} == {args.fixed}
                    and ops.LAUNCHES["codec_encode"] > 0):
                raise AssertionError(f"{part}: a frame did not run "
                                     f"{args.fixed}")
            n_out = sum(check_detections(cfg, o, part)  # None: frame lost
                        for slot in res.outputs for o in slot.values()
                        if o is not None)
            st = res.stats
            log(f"{part}: {len(res.logs)} UE-frames, options "
                f"{dict(collections.Counter(lg.option for lg in res.logs))}, "
                f"{st.n_requests} tail requests in {st.n_batches} batches, "
                f"{n_out} finite detections, mean delay "
                f"{res.mean_delay_s:.3f} s (simulated clock)")
        with open(trace_path) as f:
            spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
        if not spans:
            raise AssertionError("cell_video --trace: no span in the trace")
        log(f"cell_video --trace: {len(spans)} spans in {trace_path.name}, "
            f"{len({e['name'] for e in spans})} names; chaos: "
            f"{res.stats.n_outages} outages, availability "
            f"{res.stats.availability:.3f}, {len(res.recovery)} recoveries")

        # (e) split_serve_lm: launch.serve in a subprocess per arch, each
        # reporting its launches in its status payload
        t = time.perf_counter()
        ssl = SSL.run(SSL.parse_args(flags), status_dir=str(out_dir),
                      timeout=EXAMPLES_TIMEOUT_S)
        walls["e split_serve_lm"] = time.perf_counter() - t
        for arch, got in ssl.items():
            c = got["status"]["metrics"]["counters"]
            launched = got["status"]["launches"]
            want = serve_launches(get_config(arch), 8)
            log(f"split_serve_lm {arch}: launches {launched} (expected "
                f"{want}); boundary {int(c['boundary_raw_bytes_total'])} -> "
                f"{int(c['boundary_compressed_bytes_total'])} B, "
                f"{int(c['nonfinite_logits_total'])} non-finite logits; "
                + " | ".join(got["stdout"].strip().splitlines()))
            if (c["nonfinite_logits_total"] or not
                    c["boundary_raw_bytes_total"]
                    > c["boundary_compressed_bytes_total"] > 0):
                raise AssertionError(f"split_serve_lm {arch}: {c}")
            if launched != want:
                raise AssertionError(f"split_serve_lm {arch}: the launches "
                                     "do not match its config")
            total.update(launched)
        log(f"examples (e split_serve_lm): {walls['e split_serve_lm']:.1f} s "
            f"host wall, two subprocesses")

        rc = trainer.wait(timeout=EXAMPLES_TIMEOUT_S)
    finally:
        if trainer.poll() is None:
            os.killpg(trainer.pid, signal.SIGKILL)
            trainer.wait()

    # (f) train_lm: 100 steps checkpointing every 40, a restart to 200; each
    # trainer prints its launches on its last line
    walls["f train_lm"] = train_log.stat().st_mtime - t_train
    text = train_log.read_text()
    for line in text.splitlines():
        log(f"train_lm: {line}")
    if rc:
        raise AssertionError(f"train_lm exited {rc}")
    first, _, resumed = text.partition("== simulated node failure")
    l1, l2 = TLM.losses(first), TLM.losses(resumed)
    m = TLM.RESUMED.search(resumed)
    launched = TLM.launches(text)
    want = train_launches(get_config("smollm-360m").n_layers, 200)
    log(f"train_lm launches: {launched} (expected {want})")
    if (not re.search(r"^final checkpoint: \S*step_0*100$", first, re.M)
            or not m or int(m.group(1)) != 100 or min(l2) != 100
            or not np.isfinite(l2[199]) or not l2[199] < l1[0]):
        raise AssertionError(f"train_lm: losses {l1} then {l2}")
    if launched != want:
        raise AssertionError("train_lm: the launches do not match its config")
    total.update(launched)
    ckpts = sorted(os.listdir(out_dir / Path(TLM.CKPT).name))
    log(f"train_lm: loss {l1[0]:.4f} at step 0, {l1[99]:.4f} at 99; resumed "
        f"from step {m.group(1)}, {l2[100]:.4f} at 100, {l2[199]:.4f} at "
        f"199; checkpoints {ckpts}; {walls['f train_lm']:.1f} s host wall to "
        f"its last line, two subprocesses beside (a)-(e)")
    shutil.rmtree(out_dir)
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in walls.items()) + ")")
    total["flash_attention_bwd"] = total["flash_attention_bwd_dkdv"]
    return dict(total)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2

    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.swin_t_detection import CONFIG as cfg
    from repro_torch.core.adaptive import (DEFAULT_PRIVACY_PROFILE,
                                           AdaptiveController, Objective)
    from repro_torch.core.calibration import calibrate
    from repro_torch.core.channel import dupf_path
    from repro_torch.core.compression import ActivationCodec, _to_host
    from repro_torch.core.pipeline import SplitInferencePipeline
    from repro_torch.core.splitting import (SERVER_ONLY, UE_ONLY, LMSplitPlan,
                                            SwinSplitPlan, Workload,
                                            split_option)
    from repro_torch.core.throughput import train_estimator
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.data.video import SyntheticVideo, VideoConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import codec as ck
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant as qk
    from repro_torch.kernels import window_attention as wa
    from repro_torch.launch import serve as SV
    from repro_torch.models import swin as SW
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. the card ---------------------------------------------------------
    card = gpu_name_and_limit()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports)} "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    # both window-attention kernels take their products on the tensor cores:
    # B1's wgmma body (windows up to 8) holds HGMMA and TMA loads and no
    # HMMA, with no spill and no wgmma serialised; B1's body for windows
    # 9-12 and B7's hold TF32 HMMAs (the FFMAs left are expf's and the
    # reciprocal's, not product loops)
    log(f"window attention body: {wa.BODY}")
    b1_build_facts(reports.get("window_attention", ""))
    # the codec library's kernels move 16 bytes a thread where they move
    # f32: the loads of encode (B2) and quant (B4a), the stores of decode
    # (B3) and dequant (B4b)
    ldg, stg = "LDG.E.128", "STG.E.128"
    usage = ptxas_usage(reports.get("codec", ""))
    for fn_name, n in sass_ops(_build.target("codec"), (ldg, stg)).items():
        kernel, op = (("B4b", stg) if "dequant_kernel" in fn_name else
                      ("B4a", ldg) if "quant_kernel" in fn_name else
                      ("B2", ldg) if "codec_encode" in fn_name else ("B3", stg))
        if kernel in ("B2", "B3"):
            kernel += f"<delta {'true' if 'ILb1' in fn_name else 'false'}>"
        regs = usage.get(fn_name)
        log(f"  SASS {kernel}: {n[ldg]} {ldg}, {n[stg]} {stg}, "
            + (f"{regs[0]} registers" if regs else "registers not reported"))
        if not n[op]:
            raise AssertionError(f"{fn_name}: no {op} in its SASS")
    # B5's bf16 body runs wgmma fed by TMA and no mma.sync
    fwd_build_facts(reports.get("flash_attention", ""))
    # B6's one-launch body: bulk copies in every instantiation, no atomics,
    # no spills
    b6_build_facts(reports.get("decode_attention", ""))

    # -- set-up: model, frames, plan, codec ----------------------------------
    g = torch.Generator().manual_seed(SEED)
    params = SW.init(cfg, g, device=dev)
    for stage in params["stages"]:
        for bp in stage["blocks"]:
            bp["rel_bias"] = (torch.randn(bp["rel_bias"].shape, generator=g)
                              * 0.5).to(dev)
    video = SyntheticVideo(VideoConfig(h=cfg.img_h, w=cfg.img_w, seed=SEED))
    frames = torch.from_numpy(video.frames(N_UES)).to(dev)      # (4, 544, 800, 3)
    plan = SwinSplitPlan(cfg, params, device=dev)
    codec = ActivationCodec(mode=MODE, device=dev)
    block = codec.quant_block

    # -- 3. every kernel against its plain version, main-path shapes ---------
    def rel_err(out, ref):
        """(max |out - ref|, the worst row's max |out - ref| over that row's
        max |ref|), in float64; a row is one head's hd values at one
        position, so a row that averages many keys is held to its own size
        and not to the largest output of the tensor."""
        d = (out.double() - ref.double()).abs().amax(-1)
        top = ref.double().abs().amax(-1).clamp_min(1e-30)
        return float(d.max()), float((d / top).max())

    attn_cases = []              # (stage, B, Hp, Wp, C, nh, shift, mask)
    for s in range(cfg.n_stages):
        H, W = cfg.stage_hw(s)
        w = cfg.window
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        C, nh = cfg.stage_dim(s), cfg.num_heads[s]
        pad = torch.as_tensor(SW.pad_region_mask(Hp, Wp, H, W, w), device=dev)
        shifted = torch.as_tensor(SW.shift_attn_mask(Hp, Wp, w, w // 2),
                                  device=dev)
        for shift, mask in ((0, None), (0, pad), (w // 2, shifted)):
            attn_cases.append((s, Hp, Wp, C, nh, shift, mask))
    attn_err = 0.0
    for s, Hp, Wp, C, nh, shift, mask in attn_cases:
        qkv = torch.randn((N_UES, Hp, Wp, 3 * C), generator=g).to(dev)
        bias = torch.randn((nh, 49, 49), generator=g).to(dev)
        kw = dict(window=cfg.window, shift=shift, n_heads=nh)
        # plain version first, so the kernel's output cannot reuse its buffer
        ref = wa.fused_window_attention_plain(qkv, bias, mask, **kw)
        out = wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
        again = wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not (torch.isfinite(out).all() and err <= ATTN_TOL
                and torch.equal(out, again)):
            raise AssertionError(f"window attention stage {s} shift {shift} "
                                 f"mask {mask is not None}: err {err}, or two "
                                 "launches differ")
        attn_err = max(attn_err, err)
        log(f"check B1 stage {s} ({N_UES},{Hp},{Wp},{C}) nh {nh} shift {shift} "
            f"mask {'none' if mask is None else 'yes'}: max|kernel-plain| "
            f"{err:.3g} (tol {ATTN_TOL}), max|out| {float(out.abs().max()):.3g}; "
            f"two launches bitwise equal")
    # the smallest stage also against the plain version on the host
    s, Hp, Wp, C, nh, shift, mask = attn_cases[-1]
    qkv = torch.randn((1, Hp, Wp, 3 * C), generator=g)
    bias = torch.randn((nh, 49, 49), generator=g)
    kw = dict(window=cfg.window, shift=shift, n_heads=nh)
    host_err = float((wa.fused_window_attention_cuda(
        qkv.to(dev), bias.to(dev), mask, **kw).cpu()
        - wa.fused_window_attention_plain(qkv, bias, mask.cpu(), **kw))
        .abs().max())
    if host_err > ATTN_TOL:
        raise AssertionError(f"window attention vs host plain: {host_err}")
    log(f"check B1 stage 3 shifted vs plain on the host: {host_err:.3g}")
    # B1 on bf16 qkv (the bf16 Swin-T's): f32 inside and one rounding at the
    # store, against the plain version's one rounding of its f32 result;
    # each output row (one head's hd values at one pixel) within BF16_TOL of
    # its max |x|, and two launches bitwise equal
    attn_err16 = 0.0
    for s, Hp, Wp, C, nh, shift, mask in attn_cases:
        qkv = torch.randn((N_UES, Hp, Wp, 3 * C), generator=g).to(
            device=dev, dtype=torch.bfloat16)
        bias = torch.randn((nh, 49, 49), generator=g).to(dev)
        kw = dict(window=cfg.window, shift=shift, n_heads=nh)
        ref = wa.fused_window_attention_plain(qkv, bias, mask, **kw)
        out = wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
        again = wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
        torch.cuda.synchronize()
        err, rel = rel_err(out.unflatten(-1, (nh, C // nh)),
                           ref.unflatten(-1, (nh, C // nh)))
        if not (out.dtype == torch.bfloat16 and torch.isfinite(out).all()
                and rel <= BF16_TOL and torch.equal(out, again)):
            raise AssertionError(f"B1 bf16 stage {s} shift {shift} mask "
                                 f"{mask is not None}: {out.dtype}, err {err}, "
                                 f"rel {rel}, or two launches differ")
        attn_err16 = max(attn_err16, err)
        log(f"check B1 bf16 stage {s} ({N_UES},{Hp},{Wp},{C}) nh {nh} shift "
            f"{shift} mask {'none' if mask is None else 'yes'}: max|kernel-"
            f"plain| {err:.3g}, worst row {rel:.3g} of its max|out| (tol "
            f"{BF16_TOL}); two launches bitwise equal")

    streams, head_trees = {}, {}
    for split in SPLITS:
        with torch.no_grad():
            tree = plan.head_jitted(split_option(split))(params, frames[:1])
        head_trees[split] = tree
        segs = [F.pad(x.reshape(-1), (0, (-x.numel()) % block))
                for x in tree_leaves(tree)]
        streams[split] = torch.cat(segs)
    def abs_err(a, b):
        """Largest |a - b| in float64; 0 for empty tensors."""
        if a.numel() == 0:
            return 0.0
        return float((a.double() - b.double()).abs().max())

    def bits(t):
        return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])

    def check_codec(flat, blk, delta, what):
        """B2/B3 against their plain versions on one stream, bitwise, and a
        second launch of each bitwise equal to the first.  Returns the
        largest |kernel - plain| of the encode and of the decode."""
        q, sc = ck.codec_encode_cuda(flat, blk, delta)
        q_again, sc_again = ck.codec_encode_cuda(flat, blk, delta)
        q2, sc2 = ck.codec_encode_plain(flat, blk, delta)
        y = ck.codec_decode_cuda(q, sc, blk, delta)
        y_again = ck.codec_decode_cuda(q, sc, blk, delta)
        y2 = ck.codec_decode_plain(q, sc, blk, delta)
        torch.cuda.synchronize()
        same = (torch.equal(bits(q), bits(q2)) and torch.equal(bits(sc), bits(sc2))
                and torch.equal(bits(y), bits(y2)) and torch.equal(q, q_again)
                and torch.equal(bits(sc), bits(sc_again))
                and torch.equal(bits(y), bits(y_again)))
        if not same:
            raise AssertionError(f"codec {what}, block {blk}, delta {delta}: "
                                 "kernel and plain version differ, or two "
                                 "launches do")
        log(f"check B2/B3 {what}: {flat.numel()} f32 = {flat.numel() // blk} "
            f"blocks of {blk}, delta {delta}: bitwise equal to plain, two "
            f"launches bitwise equal")
        return max(abs_err(q, q2), abs_err(sc, sc2)), abs_err(y, y2)

    codec_cases = [(f"split {split}", flat, block)
                   for split, flat in streams.items()]
    codec_cases += [
        ("edge blocks", torch.from_numpy(ck.codec_edge_blocks(blk)).reshape(-1).to(dev),
         blk) for blk in (128, 256, 1024, 8192, 8320, ck.MAX_CUDA_BLOCK)]
    lm_len = CODEC_LENGTHS["LM handoff"]
    codec_cases.append(("LM handoff length",
                        (torch.randn((lm_len,), generator=g) * 3).to(dev), block))
    enc_err = dec_err = quant_err = dequant_err = 0.0
    for what, flat, blk in codec_cases:
        for delta in (False, True):
            e, d = check_codec(flat, blk, delta, what)
            enc_err, dec_err = max(enc_err, e), max(dec_err, d)
    del codec_cases

    # B4a/B4b: every full-width leaf shape (split 4 ships the four stage
    # outputs), a ragged length, an empty leaf and a bf16 leaf; then, at
    # the codec's block and at two above MAX_CUDA_BLOCK, the edge blocks cut
    # a third of a block into the last (the subnormal-scale one), a view 4
    # bytes into its storage (the wrapper copies it) and a 16-byte-aligned
    # view followed by 1e30 in its storage (read in place: a value read past
    # the leaf would raise its last block's scale)
    quant_cases = [("payload leaf", x.contiguous(), block)
                   for x in tree_leaves(head_trees[4])]
    quant_cases += [
        ("ragged length", torch.randn((3 * block + 4321,), generator=g).to(dev) * 3,
         block),
        ("empty leaf", torch.zeros((0, 4), device=dev), block),
        ("bf16 leaf", quant_cases[1][1].to(torch.bfloat16), block)]
    for blk in (block, ck.MAX_CUDA_BLOCK + 128, 65536):
        edge = ck.codec_edge_blocks(blk).reshape(-1)[:7 * blk + blk // 3]
        n_edge = edge.size
        buf = torch.zeros((n_edge + 1,), device=dev)
        buf[1:].copy_(torch.from_numpy(edge))
        poisoned = torch.full((n_edge + 1024,), 1e30, device=dev)
        poisoned[:n_edge].copy_(torch.from_numpy(edge))
        quant_cases += [("edge blocks, ragged", buf[1:].clone(), blk),
                        ("view 4 B into its storage", buf[1:], blk),
                        ("view before 1e30", poisoned[:n_edge], blk)]
    for what, x, blk in quant_cases:
        q, sc, n = qk.quant_cuda(x, blk)
        q_again, sc_again, _ = qk.quant_cuda(x, blk)
        q2, sc2, n2 = qk.quant_plain(x, blk)
        y = qk.dequant_cuda(q, sc, n, tuple(x.shape), x.dtype)
        y_again = qk.dequant_cuda(q, sc, n, tuple(x.shape), x.dtype)
        y2 = qk.dequant_plain(q, sc, n, tuple(x.shape), x.dtype)
        torch.cuda.synchronize()
        same = (n == n2 and torch.equal(q, q2)
                and torch.equal(bits(sc), bits(sc2)) and y.dtype == x.dtype
                and torch.equal(bits(y), bits(y2)) and torch.equal(q, q_again)
                and torch.equal(bits(sc), bits(sc_again))
                and torch.equal(bits(y), bits(y_again)))
        quant_err = max(quant_err, abs_err(q, q2), abs_err(sc, sc2))
        dequant_err = max(dequant_err, abs_err(y, y2))
        if not same:
            raise AssertionError(f"quant {what} {tuple(x.shape)} {x.dtype}, "
                                 f"block {blk}: kernel and plain version "
                                 "differ, or two launches do")
        log(f"check B4a/B4b {what} {tuple(x.shape)} "
            f"{str(x.dtype).removeprefix('torch.')}: {q.shape[0]} blocks of "
            f"{blk}, quant and dequant bitwise equal to plain, two launches "
            f"bitwise equal")
    del quant_cases

    # the attention kernels at the serving shapes of the LM: full-width
    # qwen3-1.7b (16 heads over 8 kv heads, hd 128) prefill and decode
    lm_cfg = get_config(LM_ARCH)
    lm_H, lm_KV, lm_hd = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.head_dim
    bf16, f32 = torch.bfloat16, torch.float32

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g).to(device=dev, dtype=dtype)

    attn_errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    flash_cases = [  # (B, Sq, Skv, H, KV, hd, dtype, causal)
        (LM_BATCH, LM_PROMPT, LM_PROMPT, lm_H, lm_KV, lm_hd, bf16, True),
        (LM_BATCH, LM_PROMPT, LM_PROMPT, lm_H, lm_KV, lm_hd, f32, True)]
    for dt in (bf16, f32):       # Sq < Skv, ragged, G 3 at hd 64
        flash_cases += [(2, 200, 520, lm_H, lm_KV, lm_hd, dt, True),
                        (2, 333, 333, lm_H, lm_KV, lm_hd, dt, True),
                        (2, 300, 300, 15, 5, 64, dt, True)]
    moe_cfg = get_config(MOE_ARCHS[0])          # granite: G 3 at hd 64
    moe_H, moe_KV, moe_hd = moe_cfg.n_heads, moe_cfg.n_kv_heads, moe_cfg.head_dim
    flash_cases += [(LM_BATCH, LM_PROMPT, LM_PROMPT, moe_H, moe_KV, moe_hd, dt,
                     True) for dt in (bf16, f32)]
    flash_cases += [(2, 150, 150, 4, 2, 16, bf16, True),   # the small heads
                    (2, 150, 190, 4, 2, 32, bf16, True),
                    (2, 200, 130, lm_H, lm_KV, lm_hd, bf16, False)]
    for B, Sq, Skv, h_, kv_, hd_, dt, causal in flash_cases:
        q = rnd((B, Sq, h_, hd_), dt)
        k, v = rnd((B, Skv, kv_, hd_), dt), rnd((B, Skv, kv_, hd_), dt)
        ref = fa.flash_attention_plain(q, k, v, causal)
        out = fa.flash_attention_cuda(q, k, v, causal)
        again = fa.flash_attention_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = BF16_TOL if dt == bf16 else F32_TOL
        if not (torch.isfinite(out).all() and rel <= tol
                and torch.equal(out, again)):
            raise AssertionError(f"B5 {(B, Sq, Skv, h_, kv_, hd_)} {dt} causal "
                                 f"{causal}: rel err {rel}, or two launches "
                                 "differ")
        attn_errs["flash_attention"] = max(attn_errs["flash_attention"], err)
        log(f"check B5 q {(B, Sq, h_, hd_)} kv {(B, Skv, kv_, hd_)} "
            f"{str(dt).removeprefix('torch.')} causal {causal}: max|kernel-"
            f"plain| {err:.3g}; worst row {rel:.3g} of its max|out| (tol "
            f"{tol}); two launches bitwise equal")
    # B5 with a sliding window at Hymba's heads (25 over 5 at hd 64) and its
    # window of 1024: the prefill shape, a ragged 1100, Sq < Skv; w = 1,
    # where each row is its own v row; w >= Skv, bitwise the call without
    hy_cfg = get_config(RECURRENT_ARCHS[0])
    hy_H, hy_KV, hy_hd = hy_cfg.n_heads, hy_cfg.n_kv_heads, hy_cfg.head_dim
    hy_w = hy_cfg.sliding_window
    window_cases = []              # (B, Sq, Skv, dtype, window)
    for dt in (bf16, f32):
        window_cases += [(LM_BATCH, LM_PROMPT, LM_PROMPT, dt, hy_w),
                         (2, RECURRENT_PROMPT, RECURRENT_PROMPT, dt, hy_w),
                         (2, 200, 1300, dt, hy_w), (2, 300, 300, dt, 1),
                         (2, 300, 300, dt, 300), (2, 200, 520, dt, 4096)]
    for B, Sq, Skv, dt, w in window_cases:
        q = rnd((B, Sq, hy_H, hy_hd), dt)
        k, v = rnd((B, Skv, hy_KV, hy_hd), dt), rnd((B, Skv, hy_KV, hy_hd), dt)
        ref = fa.flash_attention_plain(q, k, v, True, w)
        out = fa.flash_attention_cuda(q, k, v, True, w)
        again = fa.flash_attention_cuda(q, k, v, True, w)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = BF16_TOL if dt == bf16 else F32_TOL
        ok = (bool(torch.isfinite(out).all()) and rel <= tol
              and torch.equal(out, again))
        what = ""
        if w == 1:
            own = v.repeat_interleave(hy_H // hy_KV, dim=2)[:, Skv - Sq:]
            rel_v = rel_err(out, own)[1]
            ok = ok and rel_v <= tol
            what = f"; each row its own v row within {rel_v:.3g}"
        if w >= Skv:
            ok = ok and torch.equal(out, fa.flash_attention_cuda(q, k, v, True))
            what = "; bitwise the call without a window"
        if not ok:
            raise AssertionError(f"B5 {(B, Sq, Skv, hy_H, hy_KV, hy_hd)} {dt} "
                                 f"window {w}: rel err {rel}, or two launches "
                                 f"differ{what and ', or' + what}")
        attn_errs["flash_attention"] = max(attn_errs["flash_attention"], err)
        log(f"check B5 q {(B, Sq, hy_H, hy_hd)} kv {(B, Skv, hy_KV, hy_hd)} "
            f"{str(dt).removeprefix('torch.')} causal, window {w}: "
            f"max|kernel-plain| {err:.3g}; worst row {rel:.3g} of its max|out| "
            f"(tol {tol}); two launches bitwise equal{what}")
    cache_len = LM_PROMPT + LM_GEN

    def b6_edges(hd_):
        """kv_len at the edges of B6's bf16 sub-tiles: 0, 1, T - 1, T,
        T + 1 and one row into the last sub-tile of a rank's turn"""
        T_ = da.SUBTILE_BYTES // (2 * hd_)
        return [0, 1, T_ - 1, T_, T_ + 1, 5 * T_ + 1]
    b6_cases = [  # (H, KV, hd, cache rows, kv_len per batch row)
        (lm_H, lm_KV, lm_hd, cache_len,
         b6_edges(lm_hd) + [LM_PROMPT, cache_len, 777]),
        (moe_H, moe_KV, moe_hd, cache_len,
         b6_edges(moe_hd) + [LM_PROMPT, cache_len, 777]),
        # Hymba's ring of the window's rows: filling, one short, full
        (hy_H, hy_KV, hy_hd, hy_w, [1, hy_w - 1, hy_w, hy_w])]
    for H_, KV_, hd_, rows_, lens in b6_cases:
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dt in (bf16, f32):
            C_, T_ = da.cluster_plan(len(lens), KV_, rows_, hd_,
                                     torch.empty((), dtype=dt).element_size())
            q = rnd((len(lens), 1, H_, hd_), dt)
            ck_, cv_ = (rnd((len(lens), KV_, rows_, hd_), dt)
                        for _ in range(2))
            ref = da.decode_attention_plain(q, ck_, cv_, lens)
            out = da.decode_attention_cuda(q, ck_, cv_, lens)
            again = da.decode_attention_cuda(q, ck_, cv_, lens)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            tol = BF16_TOL if dt == bf16 else F32_TOL
            if not (torch.isfinite(out).all() and rel <= tol
                    and (lens[0] > 0 or not out[0].any())
                    and torch.equal(out, again)):
                raise AssertionError(f"B6 {tuple(q.shape)} {dt}: rel err {rel}, "
                                     "or kv_len 0 is not zeros, or two "
                                     "launches differ")
            attn_errs["decode_attention"] = max(attn_errs["decode_attention"],
                                                err)
            log(f"check B6 q {tuple(q.shape)} cache {tuple(ck_.shape)} kv_len "
                f"{lens.tolist()} (clusters of {C_}, sub-tiles of {T_} rows) "
                f"{str(dt).removeprefix('torch.')}: max|kernel-plain| "
                f"{err:.3g}; worst row {rel:.3g} of its max|out| (tol {tol}); "
                f"{'kv_len 0 gives zeros; ' if lens[0] == 0 else ''}two "
                f"launches bitwise equal")

    # B6 at each of its cluster sizes (C = 16, 8, 4, 2, 1 by the wrapper's
    # plan from B and KV), on caches whose ranks wrap the ring (C = 16: 4500
    # rows in bf16 sub-tiles of 32, 8-9 a rank), kv_len 0, 1, one that ends
    # inside a sub-tile and the full cache
    mg_cfg_ = get_config(FRONTEND_ARCHS[0])     # musicgen-medium, G = 1
    for B_, H_, KV_, hd_, rows_ in ((1, lm_H, lm_KV, lm_hd, 4500),
                                    (4, lm_H, lm_KV, lm_hd, 4500),
                                    (8, lm_H, lm_KV, lm_hd, cache_len),
                                    (16, lm_H, lm_KV, lm_hd, cache_len),
                                    (9, mg_cfg_.n_heads, mg_cfg_.n_kv_heads,
                                     mg_cfg_.head_dim, cache_len)):
        T_ = da.SUBTILE_BYTES // (2 * hd_)
        lens = torch.tensor(([0, 1, 5 * T_ + T_ // 3, rows_] * 4)[:B_][::-1],
                            dtype=torch.int32, device=dev)
        C_ = da.cluster_plan(B_, KV_, rows_, hd_, 2)[0]
        for dt in (bf16, f32):
            q = rnd((B_, 1, H_, hd_), dt)
            ck_, cv_ = (rnd((B_, KV_, rows_, hd_), dt) for _ in range(2))
            ref = da.decode_attention_plain(q, ck_, cv_, lens)
            out = da.decode_attention_cuda(q, ck_, cv_, lens)
            again = da.decode_attention_cuda(q, ck_, cv_, lens)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            tol = BF16_TOL if dt == bf16 else F32_TOL
            empty = lens == 0
            if not (torch.isfinite(out).all() and rel <= tol
                    and not out[empty].any() and torch.equal(out, again)):
                raise AssertionError(f"B6 {tuple(q.shape)} {dt} (bf16 clusters "
                                     f"of {C_}): rel err {rel}, or kv_len 0 is "
                                     "not zeros, or two launches differ")
            attn_errs["decode_attention"] = max(attn_errs["decode_attention"],
                                                err)
        log(f"check B6 q {tuple(q.shape)} cache {tuple(ck_.shape)} kv_len "
            f"{lens.tolist()}, bf16 clusters of {C_}, and f32: worst row "
            f"within tol, kv_len 0 gives zeros, two launches bitwise equal")

    # B6's partial mode, the rows of phase 6's cache cut in halves as two
    # ranks hold them
    t0 = time.perf_counter()
    b6_lse_err = b6_partial_check(dev)
    log(f"B6 partial mode checks: {time.perf_counter() - t0:.1f} s")

    # B5 with a logit soft-cap, in both bodies: qwen3-1.7b's prefill shape
    # and InternVL's heads (48 over 8, hd 128) at each of SOFTCAPS (a cap of
    # 1.0 binds on most scores, so a cap taken in the bf16 body's base-2
    # units would miss; 50.0 seldom binds), windowed and capped at Hymba's
    # shape, musicgen's G = 1 (24 over 24 at hd 64); a cap of 0 bitwise the
    # call without the argument
    mg_cfg, iv_cfg = (get_config(a) for a in FRONTEND_ARCHS)
    iv_H, iv_KV, iv_hd = iv_cfg.n_heads, iv_cfg.n_kv_heads, iv_cfg.head_dim
    mg_H, mg_KV, mg_hd = mg_cfg.n_heads, mg_cfg.n_kv_heads, mg_cfg.head_dim
    full = (LM_BATCH, LM_PROMPT, LM_PROMPT)
    cap_cases = []              # (B, Sq, Skv, H, KV, hd, dtype, window, cap)
    for dt in (bf16, f32):
        for cap in SOFTCAPS:
            cap_cases += [full + (lm_H, lm_KV, lm_hd, dt, 0, cap),
                          full + (iv_H, iv_KV, iv_hd, dt, 0, cap)]
        cap_cases += [full + (hy_H, hy_KV, hy_hd, dt, hy_w, BINDING_SOFTCAP),
                      full + (mg_H, mg_KV, mg_hd, dt, 0, 0.0),
                      (2, 333, 333, mg_H, mg_KV, mg_hd, dt, 0,
                       BINDING_SOFTCAP),
                      (2, 300, 300, iv_H, iv_KV, iv_hd, dt, hy_w, 0.0)]
    for B, Sq, Skv, h_, kv_, hd_, dt, w, cap in cap_cases:
        q = rnd((B, Sq, h_, hd_), dt)
        k, v = rnd((B, Skv, kv_, hd_), dt), rnd((B, Skv, kv_, hd_), dt)
        ref = fa.flash_attention_plain(q, k, v, True, w, cap)
        out = fa.flash_attention_cuda(q, k, v, True, w, cap)
        again = fa.flash_attention_cuda(q, k, v, True, w, cap)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        tol = BF16_TOL if dt == bf16 else F32_TOL
        ok = (bool(torch.isfinite(out).all()) and rel <= tol
              and torch.equal(out, again))
        if cap:
            moved = rel_err(fa.flash_attention_plain(q, k, v, True, w), ref)[1]
            what = f"; the cap moves the plain output by {moved:.3g}"
            ok = ok and (cap != BINDING_SOFTCAP or moved > tol)
        else:
            ok = ok and torch.equal(out, fa.flash_attention_cuda(q, k, v,
                                                                 True, w))
            what = "; bitwise the call without a cap"
        if not ok:
            raise AssertionError(f"B5 {(B, Sq, Skv, h_, kv_, hd_)} {dt} window "
                                 f"{w} cap {cap}: rel err {rel}, or two "
                                 f"launches differ{what and ', or' + what}")
        attn_errs["flash_attention"] = max(attn_errs["flash_attention"], err)
        log(f"check B5 q {(B, Sq, h_, hd_)} kv {(B, Skv, kv_, hd_)} "
            f"{str(dt).removeprefix('torch.')} causal, window {w}, soft-cap "
            f"{cap}: max|kernel-plain| {err:.3g}; worst row {rel:.3g} of its "
            f"max|out| (tol {tol}); two launches bitwise equal{what}")
    del q, k, v, ref, out, again
    # B6 with a logit soft-cap on a global cache (qwen3-1.7b's, InternVL's
    # G = 6) and on Hymba's ring, at G = 1 (musicgen's) capped and not; a
    # cap of 0 bitwise the call without the argument
    b6_cap_cases = [  # (H, KV, hd, cache rows, kv_len per batch row, cap)
        (lm_H, lm_KV, lm_hd, cache_len, [1, 129, LM_PROMPT, cache_len], 1.0),
        (lm_H, lm_KV, lm_hd, cache_len, [0, 777, LM_PROMPT, cache_len], 50.0),
        (iv_H, iv_KV, iv_hd, cache_len, [1, 777, LM_PROMPT, cache_len], 1.0),
        (hy_H, hy_KV, hy_hd, hy_w, [1, hy_w - 1, hy_w, hy_w], 1.0),
        (mg_H, mg_KV, mg_hd, cache_len, [0, 1, LM_PROMPT, cache_len], 0.0),
        (mg_H, mg_KV, mg_hd, cache_len, [1, 777, LM_PROMPT, cache_len], 1.0)]
    for H_, KV_, hd_, rows_, lens, cap in b6_cap_cases:
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dt in (bf16, f32):
            q = rnd((len(lens), 1, H_, hd_), dt)
            ck_, cv_ = (rnd((len(lens), KV_, rows_, hd_), dt)
                        for _ in range(2))
            ref = da.decode_attention_plain(q, ck_, cv_, lens, cap)
            out = da.decode_attention_cuda(q, ck_, cv_, lens, cap)
            again = da.decode_attention_cuda(q, ck_, cv_, lens, cap)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            tol = BF16_TOL if dt == bf16 else F32_TOL
            ok = (bool(torch.isfinite(out).all()) and rel <= tol
                  and bool(lens[0] > 0 or not out[0].any())
                  and torch.equal(out, again))
            if not cap:
                ok = ok and torch.equal(out, da.decode_attention_cuda(
                    q, ck_, cv_, lens))
            if not ok:
                raise AssertionError(f"B6 {tuple(q.shape)} {dt} cap {cap}: "
                                     f"rel err {rel}, or kv_len 0 is not "
                                     "zeros, or two launches differ, or cap "
                                     "0 is not the call without one")
            attn_errs["decode_attention"] = max(attn_errs["decode_attention"],
                                                err)
            log(f"check B6 q {tuple(q.shape)} cache {tuple(ck_.shape)} kv_len "
                f"{lens.tolist()} {str(dt).removeprefix('torch.')}, soft-cap "
                f"{cap}: max|kernel-plain| {err:.3g}; worst row {rel:.3g} of "
                f"its max|out| (tol {tol}); two launches bitwise equal"
                f"{'' if cap else '; bitwise the call without a cap'}")

    # B7 through its entry point, ops.window_attention, at the four Swin-T
    # stage partitions of N_UES images, with the shifted-region mask of each
    # stage broadcast per image and with no mask: that run is B7's path, its
    # counters set to 0 before and read after.  Then the op's other shapes:
    # w2 64 with hd 64, w2 81 without a mask, w2 144 with hd 128 (query rows
    # staged in runs, over 48 KB of shared memory), bf16, and rows whose keys
    # are all masked, which average v over the TPU op's W2P padded rows
    w = cfg.window
    w2 = w * w
    win_cases = []                       # (label, q, k, v, bias, mask)
    for s in range(cfg.n_stages):
        H, W = cfg.stage_hw(s)
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        nh = cfg.num_heads[s]
        hd = cfg.stage_dim(s) // nh
        nB = N_UES * (Hp // w) * (Wp // w)
        shifted = torch.as_tensor(SW.shift_attn_mask(Hp, Wp, w, w // 2),
                                  device=dev).repeat(N_UES, 1, 1)
        q, k, v = (rnd((nB, w2, nh, hd), f32) for _ in range(3))
        bias = rnd((nh, w2, w2), f32)
        for mask in (shifted, None):
            win_cases.append((f"stage {s} ({nB},{w2},{nh},{hd}) mask "
                              f"{'shifted' if mask is not None else 'none'}",
                              q, k, v, bias, mask))
    ops.LAUNCHES.clear()
    win_outs = [ops.window_attention(q, k, v, bias, mask)
                for _, q, k, v, bias, mask in win_cases]
    torch.cuda.synchronize()
    win_launches = dict(ops.LAUNCHES)
    log(f"B7 path, ops.window_attention at the Swin-T stage partitions: "
        f"launches {win_launches}")
    if win_launches != {"window_attention": len(win_cases)}:
        raise AssertionError("ops.window_attention did not launch B7 once "
                             "per call")

    def window_mask(nB, w2_, dead_rows=()):
        m = torch.rand((nB, w2_, w2_), generator=g) < 0.7
        m |= torch.eye(w2_, dtype=torch.bool)[None]
        for n, t in dead_rows:
            m[n, t] = False
        return m.to(dev)

    dead = ((0, 3), (5, 48), (11, 0), (15, 20))
    for nB, w2_, nh, hd, dt, mask in (
            (64, 64, 4, 64, f32, window_mask(64, 64)),
            (32, 81, 2, 32, f32, None),
            (8, 144, 2, 128, f32, window_mask(8, 144, ((3, 100),))),
            (16, w2, 3, 32, f32, window_mask(16, w2, dead))):
        q, k, v = (rnd((nB, w2_, nh, hd), dt) for _ in range(3))
        bias = rnd((nh, w2_, w2_), f32)
        win_cases.append((f"({nB},{w2_},{nh},{hd}) mask "
                          f"{'none' if mask is None else 'random'}",
                          q, k, v, bias, mask))
        win_outs.append(ops.window_attention(q, k, v, bias, mask))
    _, q, k, v, bias, mask = win_cases[0]                # stage 0 in bf16
    q16, k16, v16 = (x.to(bf16) for x in (q, k, v))
    win_cases.append((win_cases[0][0] + " bf16", q16, k16, v16, bias, mask))
    win_outs.append(ops.window_attention(q16, k16, v16, bias, mask))
    win_err = 0.0
    for (label, q, k, v, bias, mask), out in zip(win_cases, win_outs):
        ref = wa.window_attention_plain(q, k, v, bias, mask)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        ok = torch.isfinite(out).all() and out.dtype == q.dtype
        if q.dtype == bf16:
            ok = ok and rel <= BF16_TOL
            limit = f"worst row {rel:.3g} of its max|out| (tol {BF16_TOL})"
        else:
            ok = ok and err <= ATTN_TOL
            limit = f"tol {ATTN_TOL}"
        if not ok:
            raise AssertionError(f"B7 {label}: err {err}, rel {rel}")
        win_err = max(win_err, err)
        log(f"check B7 {label} {str(q.dtype).removeprefix('torch.')}: "
            f"max|kernel-plain| {err:.3g} ({limit})")
    _, q, k, v, bias, mask = win_cases[2 * cfg.n_stages + 3]
    w2p = -(-w2 // 64) * 64
    dead_err = max(float((win_outs[2 * cfg.n_stages + 3][n, t]
                          - v[n].sum(0) / w2p).abs().max()) for n, t in dead)
    if not dead_err <= ATTN_TOL:
        raise AssertionError(f"B7 fully masked rows: {dead_err} from sum(v)/W2P")
    log(f"check B7 fully masked rows {list(dead)}: within {dead_err:.3g} of "
        f"sum(v)/{w2p} (tol {ATTN_TOL})")
    for i in (0, 2 * cfg.n_stages + 3):     # stage 0; the fully masked rows
        label, q, k, v, bias, mask = win_cases[i]
        if not torch.equal(wa.window_attention_cuda(q, k, v, bias, mask),
                           win_outs[i]):
            raise AssertionError(f"B7 {label}: two launches differ")
        log(f"check B7 {label}: two launches bitwise equal")

    # -- 4. the main path, once, with the launch counters --------------------
    expected = {"fused_window_attention": 0, "codec_encode": 0,
                "codec_decode": 0}
    n_blocks = sum(cfg.depths)
    for split in SPLITS:
        head_blocks = sum(cfg.depths[:split])
        expected["fused_window_attention"] += (N_UES * head_blocks
                                               + n_blocks - head_blocks)
        expected["codec_encode"] += N_UES
        expected["codec_decode"] += 1

    def main_path(plan_, params_):
        """Splits 1-4, N_UES UEs each through the head producer and
        compress_head, then decompress_group and one tail_batched, with
        every launch counter at 0 before.  Returns ({split: (payloads,
        heads, outs)}, the launch counts)."""
        kept_ = {}
        ops.LAUNCHES.clear()
        with torch.no_grad():
            for split in SPLITS:
                opt = split_option(split)
                producer = plan_.head_jitted(opt)
                payloads, heads = [], []
                for i in range(N_UES):
                    comp, tree = codec.compress_head(producer, params_,
                                                     frames[i:i + 1])
                    payloads.append(comp)
                    heads.append(tree)
                trees = codec.decompress_group(payloads)
                outs = plan_.tail_batched(trees, opt, pad_to=N_UES)
                kept_[split] = (payloads, heads, outs)
        torch.cuda.synchronize()
        return kept_, dict(ops.LAUNCHES)

    def check_main_path(kept_, plan_, what):
        """Finite f32 detections of the expected shapes for every UE, and
        each payload's raw bytes the plan's."""
        for split, (payloads, _, outs) in kept_.items():
            assert len(outs) == N_UES
            for out in outs:
                for lv, s in zip(out, range(cfg.n_stages)):
                    H, W = cfg.stage_hw(s)
                    for key, ch in (("cls", cfg.num_classes), ("box", 4),
                                    ("ctr", 1)):
                        t = lv[key]
                        if (tuple(t.shape) != (1, H, W, ch)
                                or t.dtype != torch.float32
                                or not torch.isfinite(t).all()):
                            raise AssertionError(
                                f"{what} split {split} {key} level {s}: shape "
                                f"{tuple(t.shape)}, {t.dtype} or not finite")
            raw = payloads[0].raw_bytes
            if raw != plan_.raw_payload_bytes(split_option(split)):
                raise AssertionError(f"{what} split {split}: raw bytes {raw}")

    kept, launches = main_path(plan, params)
    log(f"main path launches: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("the main path did not go through every kernel "
                             "as often as it calls it")
    launches["window_attention"] = win_launches["window_attention"]
    check_main_path(kept, plan, "f32")
    for split, (payloads, _, _) in kept.items():
        log(f"split {split}: detections ok for {N_UES} UEs; payload raw "
            f"{payloads[0].raw_bytes} B, compressed "
            f"{[p.compressed_bytes for p in payloads]} B")

    # the same path on the bf16 Swin-T: phase 4's weights rounded to bf16
    # (rel_bias kept f32), B1 on bf16 q/k/v, bf16 payload leaves (the codec
    # quantises them upcast to f32), f32 detections
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params16 = SW.cast_params(params, torch.bfloat16)
    plan16 = SwinSplitPlan(cfg16, params16, device=dev)
    kept16, launches16 = main_path(plan16, params16)
    log(f"main path bf16 launches: {launches16} (expected {expected})")
    if launches16 != expected:
        raise AssertionError("the bf16 main path did not go through every "
                             "kernel as often as it calls it")
    check_main_path(kept16, plan16, "bf16")
    for split, (payloads, heads, _) in kept16.items():
        leaves = [x for h in heads for x in tree_leaves(h)]
        if not (all(x.dtype == torch.bfloat16 for x in leaves)
                and all(m.dtype == "bfloat16" for p in payloads
                        for m in p.meta)):
            raise AssertionError(f"bf16 split {split}: a payload leaf is not "
                                 "bf16")
        raw32 = kept[split][0][0].raw_bytes
        if 2 * payloads[0].raw_bytes != raw32:
            raise AssertionError(f"bf16 split {split}: raw bytes "
                                 f"{payloads[0].raw_bytes}, f32's {raw32}")
        log(f"split {split} bf16: detections ok for {N_UES} UEs; payload "
            f"leaves bf16, raw {payloads[0].raw_bytes} B (f32 {raw32} B), "
            f"compressed {[p.compressed_bytes for p in payloads]} B (f32 "
            f"{[p.compressed_bytes for p in kept[split][0]]} B)")

    # -- 5. the port's CPU path against the card, one frame ------------------
    cpu = torch.device("cpu")
    params_cpu = tree_map(lambda a: a.to(cpu), params)
    plan_cpu = SwinSplitPlan(cfg, params_cpu, device=cpu)
    codec_cpu = ActivationCodec(mode=MODE, device=cpu)
    payloads, heads, outs = kept[CPU_SPLIT]
    opt = split_option(CPU_SPLIT)
    t0 = time.perf_counter()
    with torch.no_grad():
        head_cpu = plan_cpu.head_jitted(opt)(params_cpu, frames[:1].cpu())
        dec_cpu = codec_cpu.decompress(payloads[0])
        dec_gpu = codec.decompress(payloads[0])
        out_cpu = plan_cpu.tail(dec_cpu, opt)
    for a, b in zip(tree_leaves(dec_cpu), tree_leaves(dec_gpu)):
        if not torch.equal(a.view(torch.int32), b.cpu().view(torch.int32)):
            raise AssertionError("CPU decode of the card's payload differs")
    cpu_err = 0.0
    pairs = list(zip(tree_leaves(head_cpu), tree_leaves(heads[0])))
    pairs += list(zip(tree_leaves(out_cpu), tree_leaves(outs[0])))
    for a, b in pairs:
        b = b.cpu()
        rel = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        cpu_err = max(cpu_err, rel)
    if not cpu_err <= CPU_TOL:
        raise AssertionError(f"card vs CPU at split {CPU_SPLIT}: {cpu_err}")
    comp_cpu, _ = codec_cpu.compress_head(plan_cpu.head_jitted(opt),
                                          params_cpu, frames[:1].cpu())
    s_gpu = np.frombuffer(ActivationCodec._fused_stream(payloads[0]), np.uint8)
    s_cpu = np.frombuffer(ActivationCodec._fused_stream(comp_cpu), np.uint8)
    log(f"CPU path, split {CPU_SPLIT}, one frame ({time.perf_counter() - t0:.1f} s): "
        f"head and detections within {cpu_err:.3g} of the card (rel. tol "
        f"{CPU_TOL}); CPU decode of the card's payload bitwise equal; "
        f"CPU-encoded stream differs in {int((s_gpu != s_cpu).sum())} of "
        f"{s_gpu.size} bytes")
    # the bf16 frame the same way: phase 4's bf16 payload and detections of
    # UE 0 against the port's CPU path on the same bf16 weights
    params16_cpu = SW.cast_params(params_cpu, torch.bfloat16)
    plan16_cpu = SwinSplitPlan(cfg16, params16_cpu, device=cpu)
    payloads, heads, outs = kept16[CPU_SPLIT]
    t0 = time.perf_counter()
    with torch.no_grad():
        head_cpu = plan16_cpu.head_jitted(opt)(params16_cpu, frames[:1].cpu())
        dec_cpu = codec_cpu.decompress(payloads[0])
        dec_gpu = codec.decompress(payloads[0])
        out_cpu = plan16_cpu.tail(dec_cpu, opt)
    for a, b in zip(tree_leaves(dec_cpu), tree_leaves(dec_gpu)):
        if not (a.dtype == b.dtype == torch.bfloat16
                and torch.equal(a.view(torch.int16), b.cpu().view(torch.int16))):
            raise AssertionError("CPU decode of the card's bf16 payload differs")
    cpu_err16 = 0.0
    pairs = list(zip(tree_leaves(head_cpu), tree_leaves(heads[0])))
    pairs += list(zip(tree_leaves(out_cpu), tree_leaves(outs[0])))
    for a, b in pairs:
        a, b = a.double(), b.double().cpu()
        rel = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        cpu_err16 = max(cpu_err16, rel)
    if not cpu_err16 <= BF16_CPU_TOL:
        raise AssertionError(f"bf16 card vs CPU at split {CPU_SPLIT}: {cpu_err16}")
    log(f"CPU path bf16, split {CPU_SPLIT}, one frame "
        f"({time.perf_counter() - t0:.1f} s): head and detections within "
        f"{cpu_err16:.3g} of the card (rel. tol {BF16_CPU_TOL}; f32's gap "
        f"{cpu_err:.3g}); CPU decode of the card's bf16 payload bitwise equal")

    # -- 6. times ------------------------------------------------------------
    rows = {}
    w = cfg.window
    w2 = w * w
    # B1 per frame: the 12 calls of one forward at batch 1 (a UE's head) and
    # at N_UES (a batched tail), back to back and each alone after
    # L2_FLUSH_BYTES written (stage 0's qkv, 32.7 MB a frame, fits in the
    # 50 MB L2, so back-to-back calls can beat the HBM bound); the JSON line
    # keeps batch 1 back to back
    l2_flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush = lambda: l2_flush.fill_(1.0)
    cold = dict(before=flush)
    b1_rows = {}                # f32 last: the host time below is f32's
    for dt, B in itertools.product((torch.bfloat16, torch.float32),
                                   (1, N_UES)):
        name = str(dt).removeprefix("torch.")
        # the operations at the peak rate of the inputs' type: f32 on the
        # CUDA cores, bf16 on the tensor cores
        rate = FP32_FLOP_PER_S if dt == torch.float32 else BF16_FLOP_PER_S
        t = collections.Counter()
        flops_total = bytes_total = 0
        frame_calls = []            # the 12 calls of one forward
        for s, Hp, Wp, C, nh, shift, mask in attn_cases:
            padded = (Hp, Wp) != cfg.stage_hw(s)
            if shift == 0 and (mask is None) == padded:
                continue                   # not the mask this stage's blocks use
            # blocks of this kind in one forward: even unshifted, odd shifted
            per_frame = (cfg.depths[s] // 2 if shift
                         else cfg.depths[s] - cfg.depths[s] // 2)
            qkv = torch.randn((B, Hp, Wp, 3 * C), generator=g).to(device=dev,
                                                                  dtype=dt)
            bias = torch.randn((nh, w2, w2), generator=g).to(dev)
            kw = dict(window=w, shift=shift, n_heads=nh)

            def b1():
                return wa.fused_window_attention_cuda(qkv, bias, mask, **kw)
            # library yardstick: SDPA over the same windows with a float mask
            # in the query's dtype
            hd = C // nh
            nW = (Hp // w) * (Wp // w)
            x = torch.roll(qkv, (-shift, -shift), dims=(1, 2)) if shift else qkv
            x = x.reshape(B, Hp // w, w, Wp // w, w, 3, nh, hd)
            x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, B * nW, nh, w2, hd)
            q, k, v = (x[i].contiguous() for i in range(3))
            fmask = bias[None].expand(nW, nh, w2, w2).clone()
            if mask is not None:
                fmask = fmask.masked_fill(~mask[:, None], -1e9)
            fmask = fmask.repeat(B, 1, 1, 1).to(dt)

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=fmask)
            flops, nbytes = wa.fused_cost(qkv.shape, qkv.element_size(), nh,
                                          w, mask is not None)
            ts = dict(
                kernel=cuda_ms(b1), kernel_cold=cuda_ms(b1, **cold),
                plain=cuda_ms(lambda: wa.fused_window_attention_plain(
                    qkv, bias, mask, **kw)),
                sdpa=cuda_ms(sdpa), sdpa_cold=cuda_ms(sdpa, **cold),
                bound=max(nbytes / HBM_BYTES_PER_S, flops / rate) * 1e3)
            del fmask, q, k, v, x
            log(f"time B1 {name} stage {s} ({B},{Hp},{Wp},{C}) shift {shift}: "
                f"kernel {ts['kernel']:.4f} ms, {ts['kernel_cold']:.4f} cold "
                f"L2; plain {ts['plain']:.4f} ms; sdpa {ts['sdpa']:.4f} ms, "
                f"{ts['sdpa_cold']:.4f} cold L2; bound {ts['bound']:.4f} ms "
                f"({nbytes} B, {flops} flop), x{per_frame} per frame")
            for key, val in ts.items():
                t[key] += per_frame * val
            bytes_total += per_frame * nbytes
            flops_total += per_frame * flops
            frame_calls += [functools.partial(wa.fused_window_attention_cuda,
                                              qkv, bias, mask, **kw)] * per_frame
        # the frame's calls with no host time between them
        t["kernel_queued"] = cuda_ms(lambda: [f() for f in frame_calls],
                                     queued=True)
        log(f"time B1 {name} per frame ({n_blocks} calls, batch {B}): kernel "
            f"{t['kernel']:.4f} ms, {t['kernel_queued']:.4f} queued behind a "
            f"spin (device alone), {t['kernel_cold']:.4f} cold L2; plain "
            f"{t['plain']:.4f} ms; sdpa {t['sdpa']:.4f} ms, {t['sdpa_cold']:.4f} "
            f"cold L2; bound {t['bound']:.4f} ms ({bytes_total} B, "
            f"{flops_total} flop); launches per UE frame {n_blocks}")
        b1_rows[name, B] = dict(
            ms=t["kernel"], queued_ms=t["kernel_queued"],
            cold_ms=t["kernel_cold"], plain_ms=t["plain"],
            library_ms=t["sdpa"], library_cold_ms=t["sdpa_cold"],
            bound_ms=t["bound"],
            bound_by=("bytes" if bytes_total / HBM_BYTES_PER_S
                      >= flops_total / rate else "operations"))
    r = b1_rows["float32", 1]
    rows["fused_window_attention"] = dict(
        source="src/repro_torch/kernels/csrc/window_attention.cu",
        replaces="src/repro/kernels/window_attention.py:156",
        max_abs_err=attn_err, ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"])
    # the bf16 frame's figures beside them: batch 1 under bf16_, batch
    # N_UES under bf16_batch4_; its launches are phase 4's bf16 run's
    for B, prefix in ((1, "bf16_"), (N_UES, f"bf16_batch{N_UES}_")):
        rows["fused_window_attention"].update(
            {prefix + key: val for key, val in b1_rows["bfloat16", B].items()})
    rows["fused_window_attention"].update(
        bf16_launches=launches16["fused_window_attention"],
        bf16_max_abs_err=attn_err16)
    # back to back, a short call is held to the wrapper's host time: the
    # enqueue time of one call at stage 3 (no synchronize inside)
    log(f"time B1 wrapper on the host: {host_us(b1):.1f} us a call (stage 3, "
        f"batch {N_UES}, 100 calls enqueued)")

    # B7 at the stage-0 partition of N_UES images with the shifted mask;
    # the yardstick is SDPA over the same windows with bias and mask folded
    # into one float mask, built outside the timing
    _, q, k, v, bias, mask = win_cases[0]
    nB, _, nh, hd = q.shape
    fmask = bias[None].expand(nB, nh, w2, w2).masked_fill(~mask[:, None], -1e9)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    flops, nbytes = wa.windows_cost(q.shape, q.element_size(), True)
    rows["window_attention"] = dict(
        source="src/repro_torch/kernels/csrc/window_attention.cu",
        replaces="src/repro/kernels/window_attention.py:57",
        max_abs_err=win_err,
        ms=cuda_ms(lambda: wa.window_attention_cuda(q, k, v, bias, mask)),
        plain_ms=cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, mask)),
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S
                  else "operations"),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=fmask)))
    del fmask, qt, kt, vt, win_outs
    r = rows["window_attention"]
    log(f"time B7 q {tuple(q.shape)} f32, shifted mask: kernel {r['ms']:.4f} "
        f"ms, plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms ({nbytes} B, {flops} flop); launches "
        f"0 on the system's paths, {launches['window_attention']} on its own "
        f"(ops.window_attention, phase 3)")

    # B2/B3's plain versions on the split-1 stream and B4a/B4b's on the
    # split-1 payload's leaves first, under the same conditions as before
    # the cold-L2 loops below (128 MB written each)
    flat1 = streams[1]
    q, sc = ck.codec_encode_cuda(flat1, block, False)
    plain1 = {"encode": cuda_ms(lambda: ck.codec_encode_plain(flat1, block, False)),
              "decode": cuda_ms(lambda: ck.codec_decode_plain(q, sc, block, False))}
    leaves1 = [x.contiguous() for x in tree_leaves(head_trees[1])]
    if tuple(tuple(x.shape) for x in leaves1) != SPLIT1_LEAVES:
        raise AssertionError(f"split-1 leaves {[x.shape for x in leaves1]}, "
                             f"not {SPLIT1_LEAVES}")
    quantised = [qk.quant_cuda(x, block) for x in leaves1]
    plain1["quant"] = cuda_ms(lambda: [qk.quant_plain(x, block) for x in leaves1])
    plain1["dequant"] = cuda_ms(lambda: [
        qk.dequant_plain(q, sc, n, tuple(x.shape))
        for x, (q, sc, n) in zip(leaves1, quantised)])
    del quantised
    # B2/B3 at the three lengths: the split-1 stream and the cell group
    # (eight split2 streams) of real head outputs, the LM handoff on normals;
    # back to back (the JSON line keeps the split-1 figure, as before), each
    # launch alone after a cold L2, and the wrapper's host time a call
    codec_streams = {
        "split-1 stream": streams[1],
        "LM handoff": (torch.randn((CODEC_LENGTHS["LM handoff"],), generator=g)
                       * 3).to(dev),
        "cell group": torch.cat([streams[2]] * CELL_UES)}
    for what, flat in codec_streams.items():
        total = flat.numel()
        if total != CODEC_LENGTHS[what]:
            raise AssertionError(f"{what}: {total} f32, not {CODEC_LENGTHS[what]}")
        nbytes = codec_bytes(total, block)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        t = codec_times(ck, flat, block, flush)
        for name, r in t.items():
            log(f"time B{2 if name == 'encode' else 3} {what} ({total} f32, "
                f"{total // block} blocks): {r['ms']:.4f} ms back to back, "
                f"{r['cold_ms']:.4f} ms cold L2 ({r['cold_ms'] / bound:.2f}x "
                f"the bound), wrapper {r['host_us']:.1f} us a call on the "
                f"host; bound {bound:.4f} ms ({nbytes} B)")
        if what == "split-1 stream":
            t1, bound1 = t, bound
    del codec_streams
    rows["codec_encode"] = dict(
        source="src/repro_torch/kernels/csrc/codec.cu",
        replaces="src/repro/kernels/codec.py:71", max_abs_err=enc_err,
        ms=t1["encode"]["ms"], plain_ms=plain1["encode"],
        bound_ms=bound1, bound_by="bytes", library_ms=None)
    rows["codec_decode"] = dict(
        source="src/repro_torch/kernels/csrc/codec.cu",
        replaces="src/repro/kernels/codec.py:102", max_abs_err=dec_err,
        ms=t1["decode"]["ms"], plain_ms=plain1["decode"],
        bound_ms=bound1, bound_by="bytes", library_ms=None)
    per_frame = {"codec_encode": "1 per UE frame",
                 "codec_decode": f"1 per {N_UES}-UE group"}
    for name in ("codec_encode", "codec_decode"):
        r = rows[name]
        log(f"time {name} split-1 stream ({flat1.numel()} f32): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms; launches {per_frame[name]}")

    # B4a/B4b over the split-1 payload's leaves, one launch per leaf, the
    # three ways B2/B3 are timed
    n_el = sum(x.numel() for x in leaves1)
    nb1 = sum(-(-x.numel() // block) for x in leaves1)
    q_bytes = quant_bytes(leaves1, block)
    t4 = quant_times(qk, leaves1, block, flush)
    for name, replaces in (("quant", 47), ("dequant", 79)):
        rows[name] = dict(
            source="src/repro_torch/kernels/csrc/codec.cu",
            replaces=f"src/repro/kernels/quant.py:{replaces}",
            max_abs_err=quant_err if name == "quant" else dequant_err,
            ms=t4[name]["ms"], plain_ms=plain1[name],
            bound_ms=q_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None)
        r = rows[name]
        log(f"time {name} split-1 leaves ({len(leaves1)} launches, {n_el} f32, "
            f"{nb1} blocks): kernel {r['ms']:.4f} ms back to back, "
            f"{t4[name]['cold_ms']:.4f} ms cold L2 (each launch alone), "
            f"{t4[name]['held_ms']:.4f} ms cold and held "
            f"({t4[name]['held_ms'] / r['bound_ms']:.2f}x the bound), wrapper "
            f"{t4[name]['host_us']:.1f} us on the host for the leaves, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({q_bytes} B); launches 1 per leaf of a legacy split frame")

    # B5 at the full-width prefill shape, B6 at the full-width decode shape
    # (kv_len = the prompt, as in the first decode step), both bf16
    q = rnd((LM_BATCH, LM_PROMPT, lm_H, lm_hd), bf16)
    k, v = rnd((LM_BATCH, LM_PROMPT, lm_KV, lm_hd), bf16), rnd((LM_BATCH, LM_PROMPT, lm_KV, lm_hd), bf16)
    # 4 hd flop a live (q, k) pair (Q.K^T and P.V); q, k, v in, out
    flops, nbytes = fa.forward_cost(q.shape, k.shape, q.element_size())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows["flash_attention"] = dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:78",
        max_abs_err=attn_errs["flash_attention"],
        ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, True)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, True), reps=3),
        bound_ms=max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by=("operations" if flops / BF16_FLOP_PER_S
                  >= nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)))
    r = rows["flash_attention"]
    log(f"time B5 q {tuple(q.shape)} kv {tuple(k.shape)} bf16 causal: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({flops} flop "
        f"at {BF16_FLOP_PER_S:.3g}/s, {nbytes} B); launches {lm_cfg.n_layers} "
        f"per prefill")
    # B5 at Hymba's prefill shape, windowed (29 of its 32 layers) and global,
    # beside SDPA with the same boolean mask (causal band) and enable_gqa
    q = rnd((LM_BATCH, LM_PROMPT, hy_H, hy_hd), bf16)
    k, v = (rnd((LM_BATCH, LM_PROMPT, hy_KV, hy_hd), bf16) for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pos = torch.arange(LM_PROMPT, device=dev)
    for w in (hy_w, 0):
        live = pos[None, :] <= pos[:, None]
        if w:
            live &= pos[None, :] > pos[:, None] - w
        pairs = fa.live_pairs(LM_PROMPT, LM_PROMPT, True, w)   # a head
        flops, nbytes = fa.forward_cost(q.shape, k.shape, q.element_size(),
                                        True, w)
        t = dict(ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, True, w)),
                 library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=live, enable_gqa=True)),
                 bound_ms=max(flops / BF16_FLOP_PER_S,
                              nbytes / HBM_BYTES_PER_S) * 1e3)
        name = "window" if w else "global"
        rows["flash_attention"].update({f"{name}_{key}": val
                                        for key, val in t.items()})
        log(f"time B5 q {tuple(q.shape)} kv {tuple(k.shape)} bf16 causal, "
            f"{f'window {w}' if w else 'global'} (Hymba's prefill): kernel "
            f"{t['ms']:.4f} ms, sdpa with the boolean mask "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({pairs} "
            f"live pairs a head, {flops} flop, {nbytes} B)")
    del live
    # B5 soft-capped (Gemma 2's 50.0; tanhf runs on every score the kernel
    # computes, whatever the cap) at qwen3-1.7b's prefill shape, with no
    # single PyTorch call that takes a cap beside it; then B5 at InternVL's
    # (48 heads over 8, hd 128) and musicgen's (24 over 24, hd 64) prefill
    # shapes beside SDPA; bounds by the live pairs' operations
    for name, (h_, kv_, hd_), cap in (
            ("capped", (lm_H, lm_KV, lm_hd), GEMMA2_SOFTCAP),
            ("internvl", (iv_H, iv_KV, iv_hd), 0.0),
            ("musicgen", (mg_H, mg_KV, mg_hd), 0.0)):
        q = rnd((LM_BATCH, LM_PROMPT, h_, hd_), bf16)
        k, v = (rnd((LM_BATCH, LM_PROMPT, kv_, hd_), bf16) for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        flops, nbytes = fa.forward_cost(q.shape, k.shape, q.element_size())
        t = dict(ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, True, 0,
                                                            cap)),
                 bound_ms=max(flops / BF16_FLOP_PER_S,
                              nbytes / HBM_BYTES_PER_S) * 1e3,
                 library_ms=None if cap else cuda_ms(
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True, enable_gqa=True)))
        if cap:
            t["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, True, 0, cap), reps=3)
        rows["flash_attention"].update({f"{name}_{key}": val
                                        for key, val in t.items()})
        beside = (f"plain {t['plain_ms']:.4f} ms, no single PyTorch call "
                  f"takes a cap" if cap else
                  f"sdpa {t['library_ms']:.4f} ms")
        log(f"time B5 q {tuple(q.shape)} kv {tuple(k.shape)} bf16 causal"
            f"{f', soft-cap {cap}' if cap else ''} ({name}): kernel "
            f"{t['ms']:.4f} ms, {beside}, bound {t['bound_ms']:.4f} ms "
            f"({flops} flop, {nbytes} B)")
    del qt, kt, vt
    q = rnd((LM_BATCH, 1, lm_H, lm_hd), bf16)
    ck_, cv_ = (rnd((LM_BATCH, lm_KV, cache_len, lm_hd), bf16) for _ in range(2))
    lens = torch.full((LM_BATCH,), LM_PROMPT, dtype=torch.int32, device=dev)
    live = torch.arange(cache_len, device=dev)[None, :] < lens[:, None]
    bool_mask = live[:, None, None, :]                      # (B, 1, 1, S)
    # the live rows (kv_len = the prompt) of K and V, q, out and kv_len
    flops, nbytes = da.cost(q.shape, ck_.shape, q.element_size(), LM_PROMPT)
    def b6():
        return da.decode_attention_cuda(q, ck_, cv_, lens)

    def b6_sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), ck_, cv_, attn_mask=bool_mask, enable_gqa=True)

    rows["decode_attention"] = dict(
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:64",
        max_abs_err=attn_errs["decode_attention"],
        ms=cuda_ms(b6),
        plain_ms=cuda_ms(lambda: da.decode_attention_plain(q, ck_, cv_, lens)),
        bound_ms=max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by=("operations" if flops / BF16_FLOP_PER_S
                  >= nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=cuda_ms(b6_sdpa))
    r = rows["decode_attention"]
    # soft-capped (Gemma 2's 50.0): no single PyTorch call takes a cap
    r.update(capped_ms=cuda_ms(lambda: da.decode_attention_cuda(
        q, ck_, cv_, lens, GEMMA2_SOFTCAP)), capped_plain_ms=cuda_ms(
        lambda: da.decode_attention_plain(q, ck_, cv_, lens, GEMMA2_SOFTCAP)),
        capped_bound_ms=r["bound_ms"], capped_library_ms=None)
    log(f"time B6 q {tuple(q.shape)} cache {tuple(ck_.shape)} kv_len "
        f"{LM_PROMPT} bf16, soft-cap {GEMMA2_SOFTCAP}: kernel "
        f"{r['capped_ms']:.4f} ms warm, plain {r['capped_plain_ms']:.4f} ms, "
        f"no single PyTorch call takes a cap; bound {r['bound_ms']:.4f} ms")
    # K and V (33.5 MB) fit in the 50 MB L2, so back-to-back launches read
    # them from L2; a decode step reads every layer's cache in turn and
    # finds it cold: time each launch alone after writing L2_FLUSH_BYTES
    cold, cold_sdpa = (cuda_ms(fn, before=flush) for fn in (b6, b6_sdpa))
    del l2_flush
    log(f"time B6 q {tuple(q.shape)} cache {tuple(ck_.shape)} kv_len "
        f"{LM_PROMPT} bf16: kernel {r['ms']:.4f} ms warm, {cold:.4f} ms cold "
        f"L2; plain {r['plain_ms']:.4f} ms; sdpa with a bool mask "
        f"{r['library_ms']:.4f} ms warm, {cold_sdpa:.4f} ms cold L2; bound "
        f"{r['bound_ms']:.4f} ms ({nbytes} B); launches {lm_cfg.n_layers} per "
        f"decode step")
    rows["decode_attention_lse"] = b6_partial_times(dev, b6_lse_err)

    swin_traces = []                       # traced in phase 16
    split_ms = {}                          # f32's, beside bf16's below
    with torch.no_grad():
        for split in SPLITS:
            opt = split_option(split)
            producer = plan.head_jitted(opt)
            payloads = kept[split][0]
            trees = codec.decompress_group(payloads)
            t_head = host_ms(lambda: codec.compress_head(producer, params,
                                                         frames[:1]))
            t_dec = host_ms(lambda: codec.decompress_group(payloads))
            t_tail = host_ms(lambda: plan.tail_batched(trees, opt,
                                                       pad_to=N_UES))
            log(f"time split {split}: head+encode {t_head:.2f} ms per UE frame, "
                f"decode {t_dec:.2f} ms per {N_UES}-UE group, batched tail "
                f"{t_tail:.2f} ms per {N_UES}-UE group (host clock)")
            swin_traces += [
                (f"split {split} head model",
                 functools.partial(producer, params, frames[:1])),
                (f"split {split} batched tail",
                 functools.partial(plan.tail_batched, trees, opt,
                                   pad_to=N_UES))]
            # where head+encode and decode go: the model, the device encode
            # with its one copy down, the host zlib (level 1, as the codec);
            # the host unzip, and one payload's upload with the device decode
            tree = producer(params, frames[:1])
            leaves, _ = codec._leaves(tree)
            if split == 1:                 # the codec's part, traced in phase 16
                codec_traces = [
                    ("split 1 compress_head", functools.partial(
                        codec.compress_head, producer, params, frames[:1])),
                    ("split 1 device encode + copy down", functools.partial(
                        lambda enc, ls: _to_host(*enc(ls)), codec._encode,
                        leaves)),
                    (f"split 1 decompress_group of {N_UES}", functools.partial(
                        codec.decompress_group, payloads))]
            p0 = payloads[0]
            stream0 = ActivationCodec._fused_stream(p0)
            segs0 = tuple((tuple(m.shape), m.dtype, m.n, m.block_start,
                           m.delta_axis) for m in p0.meta)
            t_model = host_ms(lambda: producer(params, frames[:1]))
            t_enc = host_ms(lambda: _to_host(*codec._encode(leaves)))
            t_zip = host_ms(lambda: zlib.compress(stream0.tobytes(), codec.level))
            t_unzip = host_ms(lambda: [zlib.decompress(p.blobs[0])
                                       for p in payloads])
            t_dec0 = host_ms(lambda: codec._decode(
                stream0, p0.scales[0], segs0, block, p0.mode, p0.delta_layout))
            log(f"time split {split} parts: head model {t_model:.2f} ms, "
                f"device encode + copy {t_enc:.2f} ms, host zlib {t_zip:.2f} ms "
                f"({stream0.size} B) per UE frame; host unzip {t_unzip:.2f} ms "
                f"per {N_UES}-UE group; upload + device decode {t_dec0:.2f} ms "
                f"per UE payload")
            split_ms[split] = (t_head, t_model, t_dec, t_tail)
    # the bf16 frame (phase 4's bf16 run): the same host-clock times, and
    # its head model traced in phase 16
    with torch.no_grad():
        for split in SPLITS:
            opt = split_option(split)
            producer = plan16.head_jitted(opt)
            payloads = kept16[split][0]
            trees = codec.decompress_group(payloads)
            t16 = (host_ms(lambda: codec.compress_head(producer, params16,
                                                       frames[:1])),
                   host_ms(lambda: producer(params16, frames[:1])),
                   host_ms(lambda: codec.decompress_group(payloads)),
                   host_ms(lambda: plan16.tail_batched(trees, opt,
                                                       pad_to=N_UES)))
            log(f"time split {split} bf16 (f32): head+encode {t16[0]:.2f} "
                f"({split_ms[split][0]:.2f}) ms, of which the head model "
                f"{t16[1]:.2f} ({split_ms[split][1]:.2f}) ms, per UE frame; "
                f"decode {t16[2]:.2f} ({split_ms[split][2]:.2f}) ms and "
                f"batched tail {t16[3]:.2f} ({split_ms[split][3]:.2f}) ms per "
                f"{N_UES}-UE group (host clock)")
            swin_traces.append(
                (f"split {split} bf16 head model",
                 functools.partial(producer, params16, frames[:1])))

    # -- 7. the codec's modes at full width --------------------------------
    log("phase 7: payloads of random weights on synthetic frames; bytes are "
        "not those of a trained detector")
    int8_modes = ("int8", "int8_zlib", "int8_delta_zlib")
    with torch.no_grad():
        for split in SPLITS:
            tree = head_trees[split]
            xs = tree_leaves(tree)
            sizes = []
            for mode in ("raw", "zlib") + int8_modes:
                decoded = {}
                for fused in ((True, False) if mode in int8_modes else (False,)):
                    c = ActivationCodec(mode=mode, fused=fused, device=dev)
                    p = c.compress(tree)
                    if p.fused != fused or p.raw_bytes != plan.raw_payload_bytes(
                            split_option(split)):
                        raise AssertionError(f"split {split} {mode}: payload "
                                             f"layout or raw bytes wrong")
                    decoded[fused] = tree_leaves(c.decompress(p))
                    tag = ("/fused" if fused else "/legacy") if mode in int8_modes else ""
                    sizes.append(f"{mode}{tag} {p.compressed_bytes}")
                for y, x in zip(decoded[False], xs):
                    if mode in ("raw", "zlib"):
                        ok = torch.equal(bits(y), bits(x))
                    else:
                        step = float(x.abs().max()) / 127.0
                        ok = float((y - x).abs().max()) <= 0.5 * step * (1 + 1e-6)
                    if not ok:
                        raise AssertionError(f"split {split} {mode}: the "
                                             "payload does not round-trip")
                if mode in int8_modes:
                    for a, b in zip(decoded[True], decoded[False]):
                        if not torch.equal(bits(a), bits(b)):
                            raise AssertionError(f"split {split} {mode}: legacy "
                                                 "and fused decodes differ")
            torch.cuda.synchronize()
            log(f"codec modes split {split}: raw {plan.raw_payload_bytes(split_option(split))} B; "
                f"compressed B: {', '.join(sizes)}; all round-trip, legacy == "
                f"fused decode bitwise")

    # -- 8. the adaptive single-UE loop on the card -----------------------
    t0 = time.perf_counter()
    cache = ROOT / "build" / "calibration_cache.json"
    cache.parent.mkdir(parents=True, exist_ok=True)
    system = calibrate(force=True, cache_path=str(cache), device=dev)
    t_cal = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = train_estimator(system.channel, "kpm+spec", n_train=1500, steps=250,
                          device=dev)
    t_est = time.perf_counter() - t0
    log(f"calibrate on the card ({t_cal:.1f} s): payload bytes "
        f"{system.compressed_bytes}; estimator trained in {t_est:.1f} s")
    sweep = -40 + 35 * np.exp(-((np.linspace(0, 1, N_FRAMES) - 0.55) / 0.18) ** 2)
    loop_frames = torch.from_numpy(video.frames(N_FRAMES)).to(dev)[:, None]
    n_leaves = {split_option(s): len(tree_leaves(head_trees[s])) for s in SPLITS}

    def loop_pipeline(fused: bool):
        ctrl = AdaptiveController(
            system=system, estimator=est, objective=Objective(w_privacy=3.0),
            path=dupf_path(), privacy_profile=dict(DEFAULT_PRIVACY_PROFILE))
        pipe = SplitInferencePipeline(
            plan=plan, system=system, codec=ActivationCodec(fused=fused, device=dev),
            controller=ctrl, path=dupf_path(), execute_model=True, seed=SEED)
        walls = []
        run_frame = pipe.run_frame

        def timed(*a, **kw):                    # host wall time per frame
            t = time.perf_counter()
            out = run_frame(*a, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            return out
        pipe.run_frame = timed
        return pipe, walls

    def expected_launches(logs, fused: bool):
        exp = {"fused_window_attention": n_blocks * len(logs)}
        for lg in logs:
            if lg.option in (UE_ONLY, SERVER_ONLY):
                continue
            for name, k in ((("codec_encode", 1), ("codec_decode", 1)) if fused
                            else (("quant", n_leaves[lg.option]),
                                  ("dequant", n_leaves[lg.option]))):
                exp[name] = exp.get(name, 0) + k
        return exp

    loop_launches = {}
    for fused in (True, False):
        name = "fused" if fused else "legacy"
        pipe, walls = loop_pipeline(fused)
        ops.LAUNCHES.clear()
        logs = pipe.run_trace(loop_frames, sweep)
        if not fused:                           # every payload shape meets B4
            logs += [pipe.run_frame(loop_frames[0], -20.0, split_option(s))
                     for s in SPLITS]
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        want = expected_launches(logs, fused)
        log(f"loop {name}: launches {got} (expected from the logged options "
            f"{want})")
        if got != want:
            raise AssertionError(f"loop {name}: the launches do not match the "
                                 "options the frames ran")
        loop_launches[name] = got
        for i, (lg, wall) in enumerate(zip(logs, walls)):
            if not (np.isfinite(lg.delay_s) and lg.raw_bytes >= lg.compressed_bytes >= 0):
                raise AssertionError(f"loop {name} frame {i}: bad log {lg}")
            fixed = "" if i < N_FRAMES else " (fixed)"
            log(f"loop {name} frame {i:2d} {lg.interference_db:6.1f} dB "
                f"{lg.option:11s} delay {lg.delay_s * 1e3:8.2f} ms, compressed "
                f"{lg.compressed_bytes} B, quant_s {lg.quant_s * 1e3:7.2f} ms, "
                f"run_frame {wall * 1e3:7.2f} ms{fixed}")
        opts = [lg.option for lg in logs[:N_FRAMES]]
        by_opt = collections.defaultdict(list)
        for opt, wall in zip(opts, walls):
            by_opt[opt].append(wall)
        medians = ", ".join(f"{o} {statistics.median(w) * 1e3:.2f} ms "
                            f"({len(w)} frames)" for o, w in by_opt.items())
        log(f"loop {name}: options {dict(collections.Counter(opts))}, "
            f"adaptation events {sum(a != b for a, b in zip(opts, opts[1:]))}, "
            f"run_frame median by option over the {N_FRAMES} adaptive frames: "
            f"{medians}")
    # B1-B3 report their phase-4 counts, the quant pair its legacy-loop run
    for name in ("quant", "dequant"):
        launches[name] = loop_launches["legacy"].get(name, 0)
        if launches[name] == 0:
            raise AssertionError(f"the legacy loop never launched {name}")

    # -- 9. LM serving at full width through its entry point -----------------
    import argparse
    args = argparse.Namespace(arch=LM_ARCH, reduced=False, prompt_len=LM_PROMPT,
                              gen=LM_GEN, batch=LM_BATCH, split=LM_SPLIT,
                              device="cuda", status_out=None)
    n_layers = lm_cfg.n_layers
    head_layers = max(1, int(n_layers * LM_SPLIT))
    want = {"flash_attention": n_layers + head_layers + (n_layers - head_layers),
            "decode_attention": n_layers * LM_GEN,
            "codec_encode": 1, "codec_decode": 1}
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES.clear()
    t0 = time.perf_counter()
    st = SV.serve(args)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    log(f"serve {LM_ARCH} launches: {got} (expected from the config {want})")
    if got != want:
        raise AssertionError("serving did not go through B5, B6 and the codec "
                             "pair as often as its config implies")
    launches["flash_attention"] = got["flash_attention"]
    launches["decode_attention"] = got["decode_attention"]
    snap = json.loads(json.dumps(st))["metrics"]
    ctr, hist = snap["counters"], snap["histograms"]
    if (ctr["nonfinite_logits_total"] != 0
            or ctr["tokens_generated_total"] != LM_BATCH * LM_GEN
            or hist["decode_step_s"]["count"] != LM_GEN):
        raise AssertionError(f"serve status: {ctr}")
    raw_b = int(ctr["boundary_raw_bytes_total"])
    if raw_b != LM_BATCH * LM_PROMPT * lm_cfg.d_model * 2:
        raise AssertionError(f"split payload of {raw_b} B")
    lm_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve {LM_ARCH} full width, batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_GEN} decode steps, split at layer {head_layers}/{n_layers} "
        f"({t_serve:.1f} s with init): prefill "
        f"{hist['prefill_s']['sum'] * 1e3:.2f} ms; decode "
        f"{hist['decode_step_s']['sum'] / LM_GEN * 1e3:.3f} ms per token "
        f"(step of {LM_BATCH} tokens); split one-shot "
        f"{hist['split_s']['sum'] * 1e3:.2f} ms, boundary {raw_b} B -> "
        f"{int(ctr['boundary_compressed_bytes_total'])} B; no non-finite "
        f"logit; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # where the split's one-shot goes: head, encode (device int8 + host
    # zlib), decode, tail; one run each after serve's own, host clock
    model = get_model(lm_cfg, dev)
    gen_ = torch.Generator(device=dev).manual_seed(SV.SEED)
    lm_params = model.init(gen_)               # serve's weights and prompt
    tokens = model.concrete(model.prefill_inputs(InputShape(
        "cli", seq_len=LM_PROMPT, global_batch=LM_BATCH, kind="prefill")),
        gen_)["tokens"]
    plan = LMSplitPlan(lm_cfg, lm_params, candidates=(head_layers,),
                       workload=Workload(n_tokens=LM_PROMPT), device=dev)
    codec = ActivationCodec(device=dev)
    opt = split_option(head_layers)
    with torch.no_grad():
        t_head = host_ms(lambda: plan.head({"tokens": tokens}, opt), runs=1)
        payload, _ = plan.head({"tokens": tokens}, opt)
        t_enc = host_ms(lambda: codec.compress(payload), runs=1)
        comp = codec.compress(payload)
        t_dec = host_ms(lambda: codec.decompress(comp), runs=1)
        dec_payload = codec.decompress(comp)
        t_tail = host_ms(lambda: plan.tail(dec_payload, opt), runs=1)
    log(f"split one-shot parts (host clock, one run after a warm-up): head "
        f"{t_head:.2f} ms ({head_layers} layers), encode {t_enc:.2f} ms "
        f"(device int8 + copy + host zlib), decode {t_dec:.2f} ms (host "
        f"unzip + upload + device), tail {t_tail:.2f} ms "
        f"({n_layers - head_layers} layers + unembed)")
    del plan, payload, dec_payload

    # prefill to S-1 + one decode step against a prefill to S, at full width:
    # in bf16, the serving dtype, and in f32 on the same weights upcast
    full_by = {}
    for dt_name, c in (("bf16", lm_cfg), ("f32", lm_cfg.replace(dtype="float32"))):
        p_ = lm_params if c is lm_cfg else tree_map(lambda a: a.float(), lm_params)
        full, dec = handoff_logits(c, p_, {"tokens": tokens})
        torch.cuda.synchronize()
        del p_
        tol = HANDOFF_BF16_TOL if dt_name == "bf16" else HANDOFF_F32_TOL
        gap, top = handoff_gap(full, dec)
        log(f"prefill to {LM_PROMPT - 1} + decode vs prefill to {LM_PROMPT}, "
            f"{dt_name}, full width: max |diff| {gap:.4g} = {gap / top:.3g} of "
            f"max |logit| {top:.4g} (tol {tol})")
        if not gap <= tol * top:
            raise AssertionError(f"prefill -> decode logits disagree at full "
                                 f"width in {dt_name}")
        full_by[dt_name] = full
    log(f"bf16 rounding noise at full width: max |bf16 - f32| prefill logits "
        f"on the same weights {float((full_by['bf16'] - full_by['f32']).abs().max()):.4g}")
    del full_by, full, dec

    # device busy time and idle share: a prefill and three decode steps under
    # the profiler, against serve's host-clock times for the same work
    with torch.no_grad():
        _, caches = T.prefill(lm_cfg, lm_params, {"tokens": tokens},
                              LM_PROMPT + 4)
        tok = tokens[:, -1:]
        T.decode_step(lm_cfg, lm_params, caches, {"tokens": tok}, LM_PROMPT)
        busy = {"prefill": device_busy_ms(lambda: T.prefill(
            lm_cfg, lm_params, {"tokens": tokens}, LM_PROMPT)),
            "decode step": device_busy_ms(lambda: [T.decode_step(
                lm_cfg, lm_params, caches, {"tokens": tok}, LM_PROMPT + 1 + i)
                for i in range(3)])}
    wall = {"prefill": hist["prefill_s"]["sum"] * 1e3,
            "decode step": hist["decode_step_s"]["sum"] / LM_GEN * 1e3}
    for what, (ms, n_events, by_name) in busy.items():
        per = 3 if what == "decode step" else 1
        if ms == 0:
            log(f"trace {what}: the profiler recorded no device time")
            continue
        log(f"trace {what}: device busy {ms / per:.2f} ms of serve's "
            f"{wall[what]:.2f} ms host-clock time, idle share "
            f"{max(0.0, 1 - ms / per / wall[what]):.3f}, {n_events // per} "
            f"device events; largest: "
            + ", ".join(f"{name[:48]} {t / per:.2f} ms"
                        for name, t in by_name.most_common(4)))
    del lm_params, caches

    # -- 10. the serving path on the card against the CPU, full width --------
    cut = lm_cfg.replace(n_layers=4, dtype="float32")
    B10, S10, steps10, split10 = 2, 256, 2, 2
    cpu = torch.device("cpu")
    gen_ = torch.Generator(device=dev).manual_seed(SEED)
    p_gpu = T.init(cut, gen_, dev)
    p_cpu = tree_map(lambda a: a.to(cpu), p_gpu)
    tokens = torch.randint(0, cut.vocab_size, (B10, S10), generator=gen_,
                           device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    logits = {}                                  # name -> (card, cpu)
    with torch.no_grad():
        for where, params_, toks in (("card", p_gpu, tokens),
                                     ("cpu", p_cpu, tokens.cpu())):
            lg, caches = T.prefill(cut, params_, {"tokens": toks},
                                   S10 + steps10)
            logits.setdefault("prefill", []).append(lg)
            tok = logits["prefill"][0][:, -1:].argmax(-1).to(torch.int32)
            for i in range(steps10):
                lg, caches = T.decode_step(cut, params_, caches,
                                           {"tokens": tok.to(toks.device)},
                                           S10 + i)
                logits.setdefault(f"decode {i}", []).append(lg)
                tok = logits[f"decode {i}"][0].argmax(-1).to(torch.int32)
        opt = split_option(split10)
        plan_gpu = LMSplitPlan(cut, p_gpu, candidates=(split10,),
                               workload=Workload(n_tokens=S10), device=dev)
        plan_cpu = LMSplitPlan(cut, p_cpu, candidates=(split10,),
                               workload=Workload(n_tokens=S10), device=cpu)
        payload, _ = plan_gpu.head({"tokens": tokens}, opt)
        comp = ActivationCodec(device=dev).compress(payload)
        dec_gpu = ActivationCodec(device=dev).decompress(comp)
        dec_cpu = ActivationCodec(device=cpu).decompress(comp)
        logits["split tail"] = [plan_gpu.tail(dec_gpu, opt),
                                plan_cpu.tail(dec_cpu, opt)]
    if not torch.equal(dec_cpu["h"].view(torch.int32),
                       dec_gpu["h"].cpu().view(torch.int32)):
        raise AssertionError("CPU decode of the card's split payload differs")
    worst = 0.0
    for name, (a, b) in logits.items():
        a = a.cpu()
        rel = float((a - b).abs().max()) / float(a.abs().max())
        worst = max(worst, rel)
        log(f"card vs CPU, {name} logits {tuple(a.shape)}: max |diff| / max "
            f"|logit| = {rel:.3g}")
    if not worst <= CPU_TOL:
        raise AssertionError(f"card vs CPU at full width: {worst}")
    log(f"CPU path, {LM_ARCH} widths, f32, {cut.n_layers} layers, batch {B10}, "
        f"prompt {S10} ({time.perf_counter() - t0:.1f} s): prefill, "
        f"{steps10} decode steps and the split tail at layer {split10} within "
        f"{worst:.3g} of the card (rel. tol {CPU_TOL}); the CPU decode of the "
        f"card's payload ({comp.raw_bytes} B -> {comp.compressed_bytes} B) "
        f"bitwise equal")
    # the bf16 handoff at the size of tools/lm_handoff_gap.py, on the card
    # and on the CPU path, same weights and prompt
    cut16 = cut.replace(dtype="bfloat16")
    for where, params_, toks in (("card", p_gpu, tokens),
                                 ("cpu", p_cpu, tokens.cpu())):
        params_ = tree_map(lambda a: a.to(torch.bfloat16), params_)
        gap, top = handoff_gap(*handoff_logits(cut16, params_,
                                                   {"tokens": toks}))
        log(f"bf16 prefill to {S10 - 1} + decode vs prefill to {S10} on the "
            f"{where}, {cut.n_layers} layers, batch {B10}: max |diff| "
            f"{gap:.4g} = {gap / top:.3g} of max |logit| {top:.4g} (tol "
            f"{HANDOFF_BF16_TOL})")
        if not gap <= HANDOFF_BF16_TOL * top:
            raise AssertionError(f"bf16 prefill -> decode on the {where}")
    del p_gpu, p_cpu

    # -- 11. the multi-UE cell at full width --------------------------------
    cell = phase11(dict(cfg=cfg, params=params, video=video, system=system,
                        dev=dev, n_blocks=n_blocks))

    # -- 12. the vectorized MAC ---------------------------------------------
    mac_what, mac_fn, city = phase12(cell)
    del cell

    # -- 18 (d) starts here: the dry-run counts on idle host cores ----------
    dry = dryrun_start()

    # -- 13. the MoE family at full width ------------------------------------
    phase13(dev)

    # -- 14. the recurrent and hybrid families at full width -----------------
    phase14(dev)

    # -- 15. the frontends and soft-capping at full width --------------------
    phase15(dev)

    # -- 20. the examples at full width (beside 18 (d)'s niced pool) ---------
    examples = phase20(dev, system)

    # -- 17. training at full width (before 16: its host timings) ----------
    rows["flash_attention_bwd"], train_launches = phase17(
        dev, reports.get("flash_attention_bwd", ""))
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd_dkdv"]
    rows["flash_attention"]["train_launches"] = train_launches["flash_attention"]

    # -- 18. the mesh, sharding, compression and the dry-run ----------------
    phase18(dev, {k: v // TRAIN_STEPS for k, v in train_launches.items()},
            city, {"train": rows["flash_attention_bwd"]["train_peak_gib"],
                   "serve": lm_peak_gib}, dry)
    del city

    # -- 19. tensor parallelism over a model axis of two ranks --------------
    launches["decode_attention_lse"] = phase19(dev, rows)

    # -- 16. the Swin path's device time, and B1's part of it ---------------
    with torch.no_grad():
        for what, fn in swin_traces:
            busy, n_ev, by_name = traced_busy_ms(what, fn)
            b1_ms = sum(t for name, t in by_name.items()
                        if "fused_window_attention" in name)
            log(f"trace {what}: device busy {busy:.2f} ms, {n_ev} device "
                f"events, of which B1 {b1_ms:.3f} ms")
    del swin_traces
    # the codec at split 1 (int8_delta_zlib, 'spatial' layout: B2/B3 run with
    # delta off, the delta is an epilogue of eager ops): B2/B3 beside the
    # copies between host and card, B1 (in compress_head's head model) and
    # the other kernels: the pack (F.pad, torch.cat), the delta epilogue
    # (_spatial_delta_apply / _invert) and, in compress_head, the model
    # (the shortest sessions of the script, and the ones that have come
    # back empty with TRACE_PAD_S pads: each pads TRACE_RETRY_PAD_S)
    with torch.no_grad():
        for what, fn in codec_traces:
            busy, n_ev, by_name = traced_busy_ms(what, fn, TRACE_RETRY_PAD_S)
            part = collections.Counter()
            other = collections.Counter()
            for name, t in by_name.items():
                key = ("B2" if "codec_encode" in name else
                       "B3" if "codec_decode" in name else
                       "B1" if "fused_window_attention" in name else
                       "memcpy" if name.startswith("Memcpy") else None)
                if key:
                    part[key] += t
                else:
                    other[name] += t
            log(f"trace {what}: device busy {busy:.4f} ms, {n_ev} device "
                f"events; B2 {part['B2']:.4f} ms, B3 {part['B3']:.4f} ms, "
                f"copies {part['memcpy']:.4f} ms, B1 {part['B1']:.4f} ms, "
                f"other kernels {sum(other.values()):.4f} ms, largest: "
                + ", ".join(f"{name[:60]} {t:.4f} ms"
                            for name, t in other.most_common(4)))
    del codec_traces
    # a stream drain of phase 12 (a): the card's busy time beside the
    # drain's host wall time, and what a TTI launches
    c, (strm, _, _, wall) = mac_trace(mac_fn)
    if c["kernels"] == 0:
        log(f"trace {mac_what}: the profiler recorded no kernel; tracing "
            f"again with {TRACE_RETRY_PAD_S} s pads")
        c, (strm, _, _, wall) = mac_trace(mac_fn, TRACE_RETRY_PAD_S)
        if c["kernels"] == 0:
            raise AssertionError(f"trace {mac_what}: no kernel recorded twice")
    per = lambda k: c[k] / strm.n_ttis
    log(f"trace {mac_what}: device busy {c['busy']:.2f} ms (sorts "
        f"{c['sort']:.2f}) in a {wall:.1f} ms drain (host clock, under the "
        f"profiler): idle share {1.0 - c['busy'] / wall:.3f}; per executed "
        f"TTI ({strm.n_ttis} in {strm.n_steps} steps) "
        f"{per('kernels'):.1f} kernels, {per('memsets'):.1f} memsets, "
        f"{per('copies'):.1f} copies; reads of the stop code and other "
        f"device values {c['reads']:.1f} ms of host time")

    # the decode step of the MoE family (phase 13's models), of the
    # recurrent and hybrid families (phase 14's) and of the frontends (phase
    # 15's), serve's weights; Hymba's prefill too, and B5's part of it
    for arch in MOE_ARCHS + RECURRENT_ARCHS + FRONTEND_ARCHS:
        decode_trace(arch, dev, prefill=arch == RECURRENT_ARCHS[0])
    log(f"profiler sessions: {TRACE_COUNT['sessions']}, of which "
        f"{TRACE_COUNT['empty']} recorded no device event")
    if TRACE_LAGS:
        t_max, lag_max = max(TRACE_LAGS, key=lambda tl: tl[1])
        log("first device event after the first launch call, by session (s "
            "since start: ms): " + ", ".join(f"{t:.0f}: {lag:.3f}"
                                             for t, lag in TRACE_LAGS)
            + f"; the largest {lag_max:.3f} ms at {t_max:.0f} s")

    kernels = []
    for name, r in rows.items():
        kernels.append({"name": name, "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "examples_launches": examples.get(name, 0),
                        **{k: v for k, v in r.items()
                           if k.startswith(("window_", "global_", "capped_",
                                            "internvl_", "musicgen_", "train_",
                                            "launches_by_", "bf16_", "tp_",
                                            "sp_"))}})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
