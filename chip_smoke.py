#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`distributed_pytorch_from_scratch_tpu_torch`).

    python3 chip_smoke.py [--phases build,bwd_check]

Needs one NVIDIA card (Hopper: the kernels build for sm_90a) and the CUDA
toolkit's nvcc; run it from the root of a checkout. Phases, each raising on
failure (nothing is caught, so any failure exits non-zero before the
result line):

1. device: nvidia-smi's name and power limit, torch's device name and count;
2. build: every CUDA source of the port with nvcc, in parallel, with the
   compiler's per-kernel registers / shared memory / spills; the wgmma
   kernels of the bf16 routes of K1 (flash_fwd_sm90, flash_bwd_sm90), K2
   (block_attn_sm90) and K3's chunks (paged_chunk_sm90) must show HGMMA
   instructions in their SASS (cuobjdump) and no spill at head_dim 64 (the
   paged chunk kernel: at any head_dim), nor may K3's decode kernel
   (paged_decode);
3. kernel vs plain: the flash-attention forward against its plain PyTorch
   version on the card, bf16 (the wgmma kernel, per element: one bf16 step
   + `flash_attention.rounding_slack` + 1e-5 of the row's max; one key
   tile of grid values with no slack) and f32 (the SIMT kernel), at the
   45m prefill shapes and the tile edges t 1, 63, 64, 65, 127, 129, 1000,
   head_dim 32/64/128, GQA groups 2 and 4, the tp=2 prefill's 4 local
   heads over 4 kv heads, pad rows exactly zero, one launch per call;
4. kernel times at the largest 45m prefill shape: bare launches (CUDA
   events) and device time (torch.profiler), achieved TFLOP/s, beside the
   plain version, SDPA as a yardstick, and the bound;
5. serve: the port's `serve.main` at the 45m preset, full width, bf16,
   random weights, the decode step a CUDA graph (`--decode_graph auto`)
   — every request completes, every token is in the vocab, the forward
   kernel ran exactly 12 times (once per layer) per prefill dispatch and
   the backward kernels not at all;
6. card vs CPU: 45m prefill logits at f32 from the same weights, the
   kernel on the card against the plain path on the CPU;
7. profile: where the time goes in the 45m bf16 prefill and decode steps
   (host wall vs device busy from torch.profiler, kernels per step; the
   decode step graphed);
8. bwd_check: the flash-attention backward kernels (dq, dk/dv) against
   their plain version, in the cases that on the TPU took each of its four
   backward launches (one block, GQA, multi-block) and at the tile edges,
   bf16 per element (rounding slack; one key tile with none) and f32, pad
   rows and pad keys exactly zero, a second call bit-equal, each launch
   counted once;
9. bwd_times: at the 45m training shape q (32, 8, 1000, 64) bf16, the
   shape the train path launches, the forward and both backward kernels
   held against their plain versions per element, then timed by bare
   launches and device time: each backward kernel, the pair, and the
   forward, beside the plain version, SDPA (its device kernel time) and
   the bound;
10. train: the port's `train.main` at the 45m preset, full width, bf16,
    b 32 x t 1000, 20 steps on a seeded bigram corpus — finite, falling
    losses, the checkpoint written, the kernels launched 12 (backward) and
    2 x 12 (forward, remat) times per step — then `--resume` for 2 steps;
11. train_card_vs_cpu: 45m f32 loss and every gradient, kernels on the card
    against the plain path on the CPU from the same weights, and one Adam
    update on both devices from the same inputs; then the step-1 loss at
    the train shape through the bf16 route against the f32 route on the
    card, same weights and batch, within 1e-2 of the loss;
12. train_profile: one 45m bf16 train step under torch.profiler (wall vs
    device busy, kernels per step, the wgmma flash kernels' launches and
    shares; no SIMT flash kernel may run);
13. paged_check: the paged-attention kernels (decode route paged_decode.cu
    at cw = 1; chunk route at cw > 1: the wgmma paged_chunk_sm90.cu in
    bf16, the SIMT paged_attn.cu in f32) against their plain version, bf16
    and f32: decode at page_size 64 with cursors at 0,
    mid-page, a page end and the last position; GQA g 4 at page_size 8 and
    16; the chunk shape with per-row start/qlen; cw 128; head_dim 32 and
    128; int8 pools; pos_offset with return_lse (dead rows exactly -1e30
    and 0); then the decode route's edges: one live key, keys ending on a
    sub-tile and a page end, rows too short to reach every warp, a full
    table, ps 8 (sub-tiles across pages), GQA g 4 and g 8, head_dim 32 and
    128 with int8 pools, b 1; then the chunk route's edges: cw 64 and 65
    (a ragged row tile), cw 128 from start 61, ps 8 and ps 16 (key tiles
    across pages), ps 128 (a page across key tiles), GQA g 4 at cw 32 (row
    tiles span heads), head_dim 32 and 128 with int8 pools, pos_offset with
    a row that sees nothing, a full table, pad columns (qlen < cw); the
    tp=2 engine's shapes, 4 local heads over 4 kv heads: decode q (16, 4,
    1, 64) and chunk q (1, 4, 128, 64), native and int8 pools; the gpt2
    engine's, 12 heads over 12 kv heads: decode q (16, 12, 1, 64) and
    chunk q (1, 12, 128, 64), native and int8 pools; one launch per call, on the route its width names and the kernel
    `kernel_route` names for its dtype; two decode calls bit-equal, two
    bf16 chunk calls bit-equal (native and int8 pools);
14. paged_times: each paged route at the 45m decode shape q (16, 8, 1, 64)
    and the chunk shape q (1, 8, 128, 64), bf16 and int8 pools, beside its
    plain version, the gather impl, one PyTorch library call (SDPA over the
    pre-gathered dense view) and the bound; and, recorded only, the decode
    route at `decode_long`, one row at cursor 703 (8 blocks), and the chunk
    route at `chunk_late`, the chunk shape at start 512 (a 640-key walk);
15. paged_serve: `serve.main --paged` at the 45m preset, bf16, 32 requests
    of mixed traffic (interleaved 64/512-token prompts behind a shared
    64-token prefix, two tenants, three SLO classes) on 16 slots over an
    80-page pool, then 8 requests with int8 pages — every request
    completes with in-vocab tokens, prefix hits, a drained pool, the paged
    kernels launched 12 times per decode step and per one-position chunk
    (decode route, cw = 1) and per other chunk dispatch (chunk route: the
    wgmma kernel every time, the SIMT one never), and no flash kernel —
    the decode steps' launches counted through the graph's replays;
16. paged_card_vs_cpu: 45m f32 chunks and decode steps through the kernel
    on the card against the plain path on the CPU, then an 8-request f32
    burst served with `--paged_attn kernel` and `gather` on the card:
    identical greedy tokens;
17. paged_profile: one decode step and one chunk dispatch of the paged
    engine at the paged_serve shape under torch.profiler; the decode step
    runs the decode kernel (paged_decode_kernel) 12 times and no chunk
    kernel, the chunk dispatch the wgmma chunk kernel
    (paged_chunk_sm90_kernel), no decode kernel and no SIMT one
    (paged_attn_kernel); its paged share of device busy is printed;
18. ring_check: the positional block kernels of ring attention (forward,
    dq, dk/dv) against their plain versions, f32 (the SIMT block_attn.cu)
    and bf16 (the wgmma block_attn_sm90.cu), with random (do, dlse):
    zig-zag halves (250, 250) fully visible and diagonal, ragged (100, 377)
    and (1, 64), the edges of 64-row tiles (tq, tk in 1, 63, 64, 65, 127,
    129, 250), a block where every row is dead (o exactly 0, lse exactly
    -1e30, dq exactly 0), a block whose positions give dead, fully visible
    and mixed tiles, GQA groups 2 and 4, head_dim 32 and 128; one launch of
    each kernel per call;
19. ring_times: each block kernel at the cp=2 path's shape, q and k halves
    (8, 8, 250, 64) bf16, a fully visible and a diagonal block, by bare
    launches and device time, beside the plain versions, a library
    yardstick (memory-efficient SDPA with a position bias) and the bound;
20. cp_train: `train.main` at cp=2 (two ranks sharing the card over gloo),
    the 45m widths at 4 of its 12 layers (`CP_LAYERS`), bf16, b 8 x t
    1000 with remat: zig-zag 4 steps, a
    checkpoint and a 2-step `--resume`; contiguous 2 steps; Ulysses 2
    steps — finite losses, falling under zig-zag, the step-1 loss of each
    and of a cp=1 run on the same batch within 1e-2, and each rank's kernel
    launches equal to the ring schedule's (read from the counters);
21. cp_tiny: `train --model tiny --cp_size 2 --cp_impl ring`, 2 steps
    on the card at f32 (the CLI default) and with --bf16: head_dim 32 on both
    routes of the block kernels, finite losses, launches per the ring
    schedule;
22. cp_card_vs_cpu: cp=2 zig-zag at the 45m widths, 2 layers, f32, b 2 x t
    256: loss and every gradient, the kernels on the card against the plain
    versions on the CPU, one gloo group;
23. cp_profile: one cp=2 zig-zag step of the 45m bf16 cell under
    torch.profiler in each rank: wall, device busy (the kernels apart from
    the hops' copies to and from the host), the card's idle share,
    kernels, the block kernels' share (no SIMT block kernel may run), and
    the time in the ring's hops;
24. tp_train: `train.main` at tp=2 (two ranks sharing the card over gloo),
    the 45m widths at 4 layers (`CP_LAYERS`), bf16, b 8 x t 1000 with
    remat: 4 steps, one
    checkpoint file per tp rank and a 2-step `--resume`, then that
    checkpoint resumed at tp=1 for a step; tp 2 x dp 2 (four ranks) 2
    steps (tp=2 with `--sequence_parallel` is phase 58's `off` run) —
    finite losses, falling at tp=2, the step-1 loss of each and of a tp=1
    run on the same batch within 1e-2, each rank's flash launches 2 x 4
    (forward) and 4 (dq, dk/dv) per step and no other attention kernel;
25. tp_tiny: `train --model tiny --tp_size 2 --cp_size 2 --cp_impl
    ring`, four ranks, 2 steps at f32 and with --bf16: head_dim
    32 with 2 local heads on both routes of the block kernels, launches
    per the ring schedule of each rank's cp index;
26. tp_card_vs_cpu: tp=2 with sequence parallelism at the 45m widths, 2
    layers, f32, b 2 x t 256: the loss and every rank's gradient shard,
    the kernels on the card against the plain versions on the CPU, one
    gloo group;
27. tp_profile: one tp=2 step of the 45m bf16 cell under torch.profiler in
    each rank: wall, device busy (the kernels apart from the hops'
    copies), the card's idle share, kernels, the flash kernels' share (no
    SIMT flash kernel may run), and the tp hops' host time and bytes;
28. tp_serve: the serve CLI at `--tp_size 2 --dist_backend gloo` (two
    ranks on the card; rank 0 decides each dispatch and broadcasts it) at
    the 45m
    preset, bf16: the slot engine on 4 requests (prompts 64-512, 16 new
    tokens, 8 slots), then the paged engine on 4 requests behind a
    96-token shared prefix (page 64, chunk 128, COW, no preemption), bf16
    and int8 pages — every request served in-vocab, both ranks' dispatches
    equal by kind and shape, on each rank K1 forward 12 times per prefill
    dispatch, K3 12 times per decode step and per chunk (the decode
    kernel at one position, the wgmma chunk kernel above; no SIMT route),
    2 x 12 + 2 tp hops per dispatch (the dispatch broadcasts apart); TPOT,
    TTFT, tokens/s and the cost per hop printed;
29. tp_serve_card_vs_cpu: the 45m widths at 2 layers, f32, 4 requests
    through each engine: tp=2 on the card gives the greedy tokens of tp=1
    on the card and on the CPU's plain path, and the first prefill's
    gathered logits are within 1e-4 (of the largest |logit|, at least 1)
    of tp=1's;
30. tp_serve_profile: one tp=2 decode step of each engine (45m bf16, 8
    live requests) under torch.profiler in each rank: wall, device busy
    (kernels apart from the hops' copies), the tp hops' host time, the
    card's idle share, the paged decode kernel 12 times;
31. graph_check: both engines on the first 8 requests of the phase-5 and
    phase-15 traffic (its deadlines x 1000, so the schedule does not
    follow the clock) with
    the decode step graphed (`--decode_graph auto`) and eager (`off`), at
    bf16: identical tokens, the graph run on every decode step;
    a replayed decode step's logits and tokens bitwise the eager step's
    on the live rows (bf16 and f32, both engines); per engine (bf16, 8 and
    16 live) the decode step's wall, device busy and idle share both ways;
32. train_remat: the train cell (45m bf16, b 32 x t 1000) 6 steps at
    `--remat true`, `dots`, `false` and `auto` (its pick printed): losses
    equal true's within 1e-6 relative, K1's forward 12 launches per step
    under dots and false (24 under true), dq and dk/dv 12; step p50,
    tokens/s, MFU and peak memory;
33. train_spd: the train cell 6 steps at `--steps_per_dispatch 4`
    (dispatches of 4 and 2) against 1: identical losses, final
    parameters and moments (max abs diff 0) and launches; the Adam update
    from device scalars bitwise the host-float one on the card; a profiled
    dispatch of 4 steps against 4 eager steps (wall, busy, idle share);
34. eval: the source repo's workflow after training — 20 steps of the
    train cell on a seeded bigram corpus with 32 validation documents of
    200-999 tokens (checkpoints at 10 and 20), then `evaluate.main
    --batch_size 8` with the shipped tokenizer in this process: bf16 with
    the slot engine's KV decoder (its decode step
    graphed), f32 with it and f32 with `--no_kv_cache` — every val loss
    finite, the newest bf16 one within EVAL_LOSS_TOL of a
    one-document-at-a-time mean of `Transformer.loss`, the tokenizer
    backend's ids of the eight prompts those of HF, K1 forward 12 times
    per batch per checkpoint plus 12 per prefill dispatch (or per full
    forward) and no other kernel, identical f32 tokens from both decoders;
    the sweep's tokens/s and ms per checkpoint, the decode wall of each
    decoder and the share of greedy next tokens that are the corpus's
    bigram successor are printed, and which of tokenizers, pandas, pyarrow
    and tensorboardX the machine has;
35. eval_pth: the newest checkpoint exported by the interop CLI as the
    source repo's .pth files at tp 2, imported back and evaluated: its val
    loss bit for bit the npz run's;
36. eval_tp: `evaluate --tp_size 2 --dist_backend gloo` (two ranks on the
    card) at f32 on the same checkpoints: val losses within EVAL_TP_TOL of
    tp=1's, tp=1's greedy tokens, each rank's launches per batch and
    prefill dispatch at 4 local heads;
37. gpt2_kernels: K1's forward and backward pair at the gpt2 train shape
    q (8, 12, 1024, 64) bf16 held against their plain versions per
    element (`flash_attention.bf16_limit`), then timed as phase 9 does,
    with the bound and the SDPA yardstick;
38. gpt2_train: `train --family gpt2 --model gpt2-124m` (d 768, 12 heads,
    ffn 3072, 12 layers, maxlen 1024) at b 8 x t 1024, bf16, remat, on a
    seeded bigram corpus at vocab 50257 (the tied head at GPT-2's width;
    the rule over ids < 1024), 60 steps at lr 6e-4: finite losses, the
    last 5's mean 1 nat below the first 5's and 0.5 nat below the unigram
    floor ln 1021 (the bigram learned through the blocks), K1 forward 2 x
    12 x 60 and dq, dk/dv 12 x 60 launches, nothing else; step p50,
    tokens/s, MFU (N from the real parameters) and peak memory; then an
    8-step `--resume` from step 60, and the same resume at
    `--steps_per_dispatch 4`: bitwise the same losses and launches;
39. gpt2_serve: `serve --family gpt2 --random_init --vocab_size 50257`
    at that width, bf16, the decode step graphed: the slot engine on the
    first 8 requests of phase 5's traffic, the paged engine on the first 8
    of phase 15's (bf16, then int8 pages), 32 new tokens per request, each
    greedy and sampled (temperature 0.8, top-k 50, top-p
    0.95): in-vocab tokens, exact launches (K1 12 per prefill dispatch;
    K3 12 per decode step and per chunk), a drained pool; sampled slot
    tokens identical with the decode step eager and with
    `--debug_host_sampler`, sampled paged tokens (deadlines x 1000) with
    the host sampler;
40. gpt2_card_vs_cpu: GPT-2 small's widths at 2 layers, f32: logits, the
    first step's loss and gradients on the card against the CPU's plain
    path; both engines' greedy and sampled tokens for 4 seeded requests
    identical on the card and the CPU; tp=2 over gloo on the card: loss
    within 1e-5 of tp=1's, identical tokens;
41. sampler_check: 20,000 sampled draws (seeds 0..19,999) on the card
    from one seeded row of 50257 logits at top-k 50, top-p 0.95 against
    the filtered softmax by a chi-square at p = 1e-3; the first 500 draws
    identical on the CPU.
42. train_async_preempt: the train cell 6 steps with a checkpoint every
    3 steps written in the background (a device snapshot, then a writer
    thread) and with none: identical losses, the loop's host time per
    save, the prefetch thread's wait, step p50 of each, beside one
    synchronous save of the same state timed alone; the idle share of a
    5-step loop with saves every 3, profiled on the device, from step 3
    on; then `python -m ...train` in a process of its own
    gets SIGTERM after its step-3 line: exit 0, the shutdown line, a
    checkpoint at the step it reached, and a 2-step `--resume` from it;
    K1's launches per the schedule in every run of this process;
43. serve_int8_weights: the first 8 requests of phase 5's and 15's
    traffic with
    `--decode_weight_dtype int8`, the decode step graphed, each after a
    run with native weights (TPOT, TTFT and tokens/s of both), checked:
    weight bytes about a quarter,
    in-vocab tokens, K1 12 per prefill dispatch, K3 12 per decode step
    and chunk on its routes; then the 45m widths at 2 layers,
    f32: both engines' greedy and sampled int8 tokens on the card those of
    the CPU's plain path;
44. serve_replay: a seeded poisson trace of 8 slot-cell requests written
    to the workdir, served with `--tokenizer_path tokenizer/tokenizer.json
    --arrival replay --replay <trace>`: submitted in arrival order, every
    request served in-vocab, K1 12 per prefill dispatch;
45. spec_check: K3 at the speculative path's shapes against its plain
    version under phase 13's limits — the verify's chunk launches over 16
    slot rows (8 heads, hd 64, cw 2, 3, 5, 9; per-row start over several
    pages, qlen 0..cw) and the tiny drafter's decode steps (hd 32), bf16
    and f32, native and int8 pools, one launch each on its route, two
    verify calls bit-equal; then the verify shape q (16, 8, 5, 64): kernel,
    plain, SDPA over the gathered view, bound;
46. spec_serve: `serve --paged --speculate 4` at 45m bf16 on the first 8
    requests of phase 15's mix with the tiny drafter, greedy and sampled: every request served
    in-vocab, both pools
    drained, K3's launches exactly the rounds' and chunks' per route
    (counted through the draft and verify graphs' replays); at f32 the
    speculative greedy tokens of an 8-request burst the plain engine's;
    drafter = target accepting >= 0.95 of its drafts at f32; one
    captured round bitwise the eager round;
47. cp_serve_check: K3 at the cp engine's shapes against its plain version
    under phase 13's limits — cp rank 1's local slab of a 45m buffer
    (pos_offset 512, return_lse): decode over 8 slots, the chunk at cw
    128 and the verify width 6 (k 4), rows that see nothing there (o
    exactly 0, lse exactly -1e30) and rows that see part of it, native and
    int8 pools, bf16 and f32; then the 45m widths at 2 layers, f32, in one
    gloo group of two ranks on the card and then on the CPU: the paged
    engine at cp 2 gives the greedy tokens of cp 1 on the card and of cp 2
    on the CPU's plain path, and a chunk dispatch's logits at every
    position are within 1e-4 of cp 1's;
48. cp_serve: `serve --paged --cp 2 --dist_backend gloo` (two ranks on the
    card, each holding half the KV pages) at the 45m preset, bf16: 4
    burst requests of
    512-880 tokens behind a 96-token shared prefix, 16 new tokens, with
    bf16 and int8 pages — every request served in-vocab, the ranks in
    lockstep, COW copies and prefix hits, the pool drained, each rank's
    pool bytes those of its slab, K3 exactly 12 per decode step (decode
    kernel) and per chunk (the wgmma chunk kernel) and 12 cp hops per
    dispatch on each rank; TTFT, TPOT and the hops' host time printed; and
    a request of 880 + 16 tokens (14 pages of 64) refused at submit by cp 1
    over 12 pages and served by cp 2 over 24 (12 per rank);
49. fleet_check: the 45m widths at 2 layers, f32, on the card and then on
    the CPU's plain path: a 2-replica `FleetRouter` fleet gives the greedy
    tokens of one paged engine, and `run_disaggregated` (a prefill-only
    engine in a thread of its own, the KV page stream, a decode engine)
    the tokens of the colocated engine with native and with int8 pages;
    the card's tokens are the CPU's; `export_pages` -> `import_pages` ->
    `export_pages` bitwise on bf16 and int8 pools on the card, and a bf16
    frame read back bitwise;
50. fleet_serve: `serve_fleet` at the 45m preset, bf16, random weights,
    phase 15's mix (burst requests, 64/512-token prompts behind the
    96-token shared prefix, two tenants, three classes, page 64, chunk
    128): `--replicas 2` with 8 slots on 40 pages each on its first 16
    requests, then `--disagg` with 8 + 8 slots on 40 + 40 pages on the
    first 8, native
    and int8 pages — every request served in-vocab, every pool drained, each tenant on one
    replica, the router's predicted hits at least the first admissions'
    actual hits (both printed with the resumes' hits), the pages and bytes
    transferred those of the handoffs' prompts, K3 exactly 12 per decode
    step (decode kernel) and per chunk (the wgmma chunk kernel) over the
    engines and never on the decode route in the prefill-only engine;
    fleet tokens/s, TTFT, TPOT, dispatch and transfer ms printed beside
    phase 15's one engine;
51. moe_check: the MoE family at the tiny widths (d 128, 4 heads of 32,
    2 layers, vocab 1024) with 4 SwiGLU experts, top 2, capacity factor
    1.0 (choices drop) and a seeded normal router, f32: the router's
    choices under all-tied logits (the zero router's) equal on the card
    and the CPU; the logits, the loss, the routing's drops and every
    gradient of one batch, the kernels on the card against the plain path
    on the CPU; both engines' greedy tokens for 8 seeded requests (the
    decode step graphed on the card) identical on the card and the CPU;
52. moe_train: `train --model 45m-moe8` (the 45m widths with 8 experts of
    ffn 2048, top 2, capacity factor 2.0) at b 32 x t 1000, bf16, remat,
    10 steps on the bigram corpus and a 2-step `--resume`: finite, falling
    losses, K1 forward 2 x 12 and dq, dk/dv 12 launches per step and
    nothing else, in both runs; step p50, tokens/s, MFU by active parameters, peak
    memory, the share of dropped routings and the expert load (max over
    mean); then one step of the same cell profiled beside one MoE layer's
    forward and backward at its input shape: the MoE layers' share of
    device busy;
53. moe_serve: the slot engine at 45m-moe8 on the first 8 requests of
    phase 5's traffic, then the
    paged engine on 8 requests of phase 15's mix, bf16, the decode step
    graphed: every request in-vocab, K1 12 per prefill dispatch, K3 12
    per decode step and per chunk on its routes, a drained pool; TTFT,
    TPOT and tokens/s beside the dense 45m figures of phases 5 and 15;
    then phase 17's profile of a decode step and a chunk dispatch at
    45m-moe8, beside phase 17's;
54. moe_ep2_train: first the exchange at moe_check's tiny MoE shape, f32,
    two gloo ranks at ep 2: on the card against the same ranks on the CPU
    at cf 1.0 (tokens drop; logits, loss, routing and every rank's
    gradient shard) and against one card at ep 1 at cf 2.0, where nothing
    drops at either and the two agree to f32 rounding (both: loss and
    logits 1e-5, gradients 1e-4 of their max); then `train --model 45m-moe8
    --ep_size 2 --dist_backend gloo` (two ranks on the card, 4 experts
    each) at 4 of its 12 layers (`CP_LAYERS`), b 8 x t 1000, bf16, 3
    steps: finite losses, the step-1 loss within 1e-2 of an ep 1
    model's on the same batch from the same seed, each rank's K1 launches
    per step as at ep 1, and its ep
    hops: 6 all_to_alls per layer per step (forward, the remat replay,
    backward) and one all-reduce of the experts' squares, then the
    checkpoint's expert gathers; step p50 and the hops' calls, bytes and
    host ms per step printed.
55. zero_train: `train --dp_size 2 --dist_backend gloo` (two ranks on the
    card) at the 45m widths at 4 of its 12 layers (`CP_LAYERS`), b 8 x t
    1000, bf16, remat, 3 steps each at
    `--zero 0, 1 --dp_reduce_bucket_mb 25, 2, 3` and `--zero 2
    --dp_reduce_dtype bf16 | int8`: finite losses, every run's step-1 loss
    within 1e-3 relative of stage 0's, each rank's K1 launches exactly 2 x
    12 forward and 12 + 12 backward per step and nothing else, each rank's
    held bytes of params, grads and moments those
    `memory.zero_state_bytes_per_param` counts (leaf by leaf), lower stage
    by stage; peak memory, step p50, the dp and batch hops per step with
    their calls, bytes and ring bytes printed beside the card's name and
    power limit; the stage-2 checkpoint resumed at stage 0 for one step
    (K1's launches checked there too);
    then at the tiny widths, f32, in the kept group of four ranks on the
    card and then on the CPU: dp 2 x tp 2 with SP at stage 3 (loss within
    1e-5, every reduced gradient within 1e-4 of its leaf's max) and at
    stage 2 with the int8 wire (loss within 1e-5, gradients within the
    wire's 2^-4 of their max: a code can flip where card and CPU round
    the same value on either side of a half step), and the int8 ring over
    dp 4 on the same inputs bitwise on both.
56. moe_paths: 45m-moe8 on the paths phase 53 does not take. First
    moe_check's tiny MoE shape (f32, cf 1.0), card against CPU: the int8
    codes and scales of the router and the experts byte for byte, the
    speculative engine's greedy tokens (drafter = target, the round
    graphed on the card) and the cp 2 paged engine's (two gloo ranks)
    identical. Then at full width, bf16, random weights with a seeded
    normal router (`_moe_routed`; the init's zero router ties every
    token on two experts): (a)
    phase 53's slot traffic with `--decode_weight_dtype int8`, the decode
    step
    graphed: weight bytes about a quarter of phase 53's native run, K1 12
    per prefill dispatch; (b) `--paged --speculate 4` with the tiny
    drafter on phase 53's paged mix (`_check_spec_run`); (c) the router
    fleet of two replicas of 8 slots on 40 pages over 8 of phase 50's
    requests: every pool drained, K3 per decode step and chunk on its
    routes, tokens/s, dispatch ms, prefix hits and the dropped share; (d)
    `--paged --cp 2 --dist_backend gloo` at 4 of the 12 layers, 4 of
    phase 48's long requests: each rank's K3, cp hops and pool bytes
    (`_check_cp_serve_rank`); (e) `evaluate --cp_size 2` on phase 52's
    newest checkpoint (each rank's K2 launches those of the ring schedule of the
    sweep, K3 12 per decode step and chunk) and `generate --cp_size 2`.
57. pp_train: `train --pp_size 2 --pp_microbatches 4 --dist_backend gloo`
    (two ranks on the card, 6 layers each) at the 45m preset, full depth,
    b 8 x t 1000, bf16, remat, 4 steps with the gpipe schedule, 4 with
    `--pp_schedule interleaved --pp_virtual 2` (blocks of 3 layers) and 2
    with `--pp_remat_steps`, against 4 steps of pp 1 on the same batches:
    finite losses, every step's loss within 1e-2 of pp 1's, each rank's
    K1 launches exactly 2 x 6 x 4 forward (under `--pp_remat_steps` (2 x
    6 + 5) x 4: the stage step's replay runs all but its last layer) and
    6 x 4 dq and dk/dv per step and nothing else; step p50, tokens/s, the
    pp hops per step (calls, bytes, host ms) and each rank's peak and held
    bytes printed beside the card's name and power limit. Then at the tiny widths (4 layers), f32,
    b 4 x t 64: pp 2 gpipe and interleaved (the kept group of two) and pp
    2 x tp 2 (the group of four) on the card against the same ranks on
    the CPU and against pp 1 on the card: losses within 1e-5, every
    gradient within 1e-4 of its leaf's max. Then the pp 2 checkpoint
    resumed at pp 1 for 2 steps through the reshard planner (its
    `reshard_event` printed, the metered staging peak within the largest
    leaf, K1 per the schedule) and resharded by the offline CLI
    (`reshard/reshard_ckpt.py`) into a tp 2 set: two files, bytes moved,
    the metered staging peak within the largest leaf.
58. tp_overlap_train: `train --tp_size 2 --sequence_parallel --tp_overlap
    off | ring | ring_q --dist_backend gloo` (two ranks on the card) at
    the 45m widths, CP_LAYERS (4) of its 12 layers, b 8 x t 1000, bf16,
    remat, 3 steps each on the same batches: finite losses, ring's within
    1e-3 (relative) of off's at every step and ring_q's within 1e-2, each
    rank's K1 launches exactly 2 x 4 forward and 4 + 4 backward per step and
    nothing else, and each rank's tp hops per step exactly the calls and
    bytes `ring_hops_want` derives from the same rank's `off` counts (the
    rule the CPU tests hold against the port's CPU runs; ring_q's ring
    hops carry about half of ring's bytes); step p50, tokens/s, the tp
    hops' calls, bytes and host ms and each rank's peak memory printed
    beside the card's name and power limit. Then at the tiny widths (4
    layers), f32, b 4 x t 64, with SP: tp 2 ring and tp 2 ring_q (the kept
    group of two), tp 2 x cp 2 ring and pp 2 x tp 2 ring (the group of
    four), on the card against the same ranks on the CPU: losses within
    1e-5, every gradient within 1e-4 of its leaf's max (ring_q's within
    the int8 wire's 2^-4, as phase 55's: a code flips where the two
    devices round one value on either side of a half step), and ring_q's
    payload of one chunk byte-equal on both.
59. greedy_decoder: `GreedyDecoder` (`models/decode.make_generate`: one
    prefill, then one decode step per position with its state on the
    card, the step a CUDA graph) at the 45m preset, full width and depth,
    random weights, on 8 prompts of 64-512 tokens with 64 new tokens each
    (per-row limits), bf16 and f32: the f32 greedy tokens equal to the
    slot engine's on the same weights and prompts; in bf16, where a row's
    tokens part from the engine's, the two tokens' logits at the shared
    prefix within GD_TIE of the row's largest (a near tie: the two
    programs' matmuls run at other shapes, so their caches differ in the
    last bits); K1's forward 12
    times per generation (the prefill) and nothing else, the host syncs
    per generation printed with the prefill ms, the decode ms per step
    and the slot engine's TPOT p50. Then at the tiny widths, f32, on the
    kept pair at cp 2 (the ring prefill): the tokens of cp 1 on the card,
    each rank's K2 forward launches exactly the ring schedule's (layers x
    its blocks) and nothing else.
60. fleet_tp: the serving fleet at tp > 1 over the kept pair (gloo).
    First at the tiny preset, f32, 6 requests behind one shared page, on
    the card and then on the CPU (`runtime/fleet_checks.fleet_runs`): the
    router fleet of two tp 2 replicas, disaggregated prefill -> decode at
    tp (2, 1), (1, 2), (2, 2) with native pages and (2, 1) with int8
    pages, and a replica restarted tp 2 -> 1 and 1 -> 2 between two waves
    — the card's tokens the CPU's, every native run's the router fleet's,
    every pool drained. Then `serve_fleet` at the 45m preset, full width
    and depth, bf16, random weights, phase 15's mix cut to 8 requests
    (8 slots on 40 pages per engine): `--replicas 2 --tp_size 2`,
    `--disagg --prefill_tp 2` into a decode engine at tp 1, and
    `--replicas 2 --tp_size 2 --restart_tp 1` (r0 restarted after the
    first wave, its live weights moved leaf by leaf) — every request
    served in-vocab, every pool drained, each rank's K3 exactly 12 per
    decode step and per chunk of the engines it holds, on the routes the
    widths name; TTFT / TPOT p50 and p95, tokens/s, each rank's page
    gather / scatter, reshard and tp hops (calls, bytes, host ms), the
    transfer ms, and the restart's planned bytes beside the bytes its
    hops carried and its wall ms printed;
61. serve_obs: phase 15's mix on the paged engine with `--trace_requests
    --flight_records --metrics_port 0 --control act`: a scrape of
    /metrics.json and /metrics from another thread mid-run answers,
    every line of `metrics.jsonl` validates under the port's schema,
    every request's span sum equals its wall, K3 as phase 15's; TPOT p50
    beside phase 15's run with obs off (the ratio printed, not gated),
    the controller's decisions, the flight dumps. Then phase 5's slot
    engine on 4 requests with `--trace_requests --flight_records`: K1's
    forward 12 per prefill dispatch, a valid timeline per request; and
    the controller's speculation knob on the card (the 45m widths at 2
    layers, f32, drafter = target, the round graphed): greedy tokens the
    plain paged engine's through every change of k, each width captured
    once.

Every phase also prints, for each call it made on a kept group of rank
processes, each rank's card memory allocated before the call, at its
return and the call's peak, and fails when a call leaves more than
KEPT_LIMIT_GIB allocated at its return.

The last two lines are a `{"kernels": [...]}` record and
`{"ok": true, "device": {...}}`. `--phases` runs a subset (for debugging;
a subset prints no result lines). The cp and tp phases run their ranks
as processes of their own (`runtime/launch.spawn`), on one kept group of
each size for the whole script (`launch.kept_groups`: each rank process
starts, imports and reaches the card once, not once per run); the build
phase has built every kernel before they start.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

PALLAS = "distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py"
REPLACES = f"{PALLAS}:87"
# the bf16 route of K1, the model's: wgmma kernels (the f32 route keeps the
# SIMT flash_fwd.cu / flash_bwd.cu)
SOURCE = ("distributed_pytorch_from_scratch_tpu_torch/ops/cuda/csrc/"
          "flash_fwd_sm90.cu")
BWD_SOURCE = ("distributed_pytorch_from_scratch_tpu_torch/ops/cuda/csrc/"
              "flash_bwd_sm90.cu")
SM90_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
                "flash_bwd_dkv_sm90_kernel")
# K2's bf16 route, block_attn_sm90.cu (the f32 route keeps the SIMT
# block_attn.cu: block_attn_{fwd,dq,dkv}_kernel)
BLOCK_SM90_KERNELS = ("block_attn_fwd_sm90_kernel", "block_attn_dq_sm90_kernel",
                      "block_attn_dkv_sm90_kernel")
BLOCK_SIMT_KERNELS = ("block_attn_fwd_kernel", "block_attn_dq_kernel",
                      "block_attn_dkv_kernel")
WGMMA_KERNELS = (SM90_KERNELS + BLOCK_SM90_KERNELS
                 + ("paged_chunk_sm90_kernel",))   # + K3's bf16 chunk route
# rows 2-5 of PERF.md's kernel table: _bwd_fused_kernel, _bwd_fused_gqa_kernel,
# _dq_kernel, _dkv_kernel
BWD_REPLACES = f"{PALLAS}:306,343,210,255"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense bf16 tensor cores
              "float32": 67e12}    # float32 outside the tensor cores
# (b, h, t, d): the 45m training step's attention
TRAIN_SHAPE = (32, 8, 1000, 64)
TRAIN_STEPS = 20
TRAIN_ARGS = ["--model", "45m", "--bf16", "--batch_size", "32",
              "--maxlen", "1000", "--max_steps", str(TRAIN_STEPS),
              "--warmup_steps", "2", "--lr", "1e-3", "--log_interval", "5",
              "--save_interval", "20", "--device", "cuda"]
SERVE_ARGS = ["--model", "45m", "--random_init", "--vocab_size", "1024",
              "--num_requests", "16", "--arrival", "burst",
              "--prompt_len_min", "64", "--prompt_len_max", "512",
              "--max_new_tokens", "64", "--slots", "8",
              "--max_prefill_batch", "4"]
# K3's sources by route (`paged_attention.kernel_route`): decode steps
# (cw = 1, either dtype), bf16 prefill chunks (cw > 1; every served chunk)
# and f32 chunks, and the kernels' names
PAGED_SOURCES = {"decode": ("distributed_pytorch_from_scratch_tpu_torch/ops/"
                            "cuda/csrc/paged_decode.cu"),
                 "chunk": ("distributed_pytorch_from_scratch_tpu_torch/ops/"
                           "cuda/csrc/paged_chunk_sm90.cu"),
                 "chunk_f32": ("distributed_pytorch_from_scratch_tpu_torch/"
                               "ops/cuda/csrc/paged_attn.cu")}
PAGED_KERNELS = {"decode": "paged_decode_kernel",
                 "chunk": "paged_chunk_sm90_kernel"}
PAGED_SIMT_KERNEL = "paged_attn_kernel"   # the f32 chunk route's
PAGED_REPLACES = "distributed_pytorch_from_scratch_tpu/ops/pallas/paged_attention.py:95"
# mixed traffic: three SLO classes, two tenants, short and long prompts
# interleaved behind a 96-token shared prefix, which ends half-way into its
# second page, so a sharer copies that page before it writes (COW); 80 pages
# against the 16 x 11 the slots could use, so pages run short and
# preemption can happen
PAGED_SERVE_ARGS = ["--model", "45m", "--random_init", "--vocab_size", "1024",
                    "--bf16", "--paged", "--page_size", "64",
                    "--prefill_chunk", "128", "--num_requests", "32",
                    "--arrival", "burst", "--prompt_len_min", "64",
                    "--prompt_len_max", "512", "--interleave",
                    "--shared_prefix_len", "96", "--tenants", "2",
                    "--class_mix", "interactive=1,standard=1,batch=1",
                    "--max_new_tokens", "64", "--slots", "16",
                    "--num_pages", "80"]
PAGED_INT8_REQUESTS = 8
# the gpt2 family at GPT-2 small's published widths (d 768, 12 heads of 64,
# ffn 3072, 12 layers, maxlen 1024) and vocab 50257, so the tied head runs
# at full width: the train cell b 8 x t 1024 bf16 and its attention shape
GPT2_SHAPE = (8, 12, 1024, 64)
GPT2_VOCAB = 50257
GPT2_STEPS = 60
GPT2_DOCS = 1200         # 60 steps of b 8 use 480 documents; the resume 16
# the corpus's rule runs over ids below 1024 (the head and the CE still run
# at 50257), so a model that learns only the unigram stops at ln(1021) and
# a loss below it needs the bigram, which the tied head cannot hold without
# the blocks: a rule over all 50257 ids gave a loss that rose at lr 1e-3
# over 20 steps (its cause not checked). lr 6e-4 is GPT-2 small's
# published rate
GPT2_RULE_VOCAB = 1024
GPT2_LEARNED = 0.5       # gpt2_train: the last 5 losses' mean this far
                         # (nats) below ln(GPT2_RULE_VOCAB - 3)
GPT2_SPD = 4             # gpt2_train: its resume again, 4 steps per dispatch
GPT2_RESUME = 8          # gpt2_train: the resume's steps
GPT2_MODEL = ["--family", "gpt2", "--model", "gpt2-124m"]
GPT2_TRAIN_ARGS = GPT2_MODEL + [
    "--bf16", "--batch_size", "8", "--maxlen", "1024", "--max_steps",
    str(GPT2_STEPS), "--warmup_steps", "5", "--lr", "6e-4",
    "--log_interval", "5", "--save_interval", str(GPT2_STEPS), "--device",
    "cuda"]
# the serve cells: phase 5's and phase 15's traffic at the gpt2 widths
GPT2_SERVE_ARGS = (GPT2_MODEL + ["--vocab_size", str(GPT2_VOCAB)]
                   + SERVE_ARGS[SERVE_ARGS.index("--random_init"):
                                SERVE_ARGS.index("--vocab_size")]
                   + SERVE_ARGS[SERVE_ARGS.index("--vocab_size") + 2:])
GPT2_PAGED_ARGS = (GPT2_MODEL + ["--vocab_size", str(GPT2_VOCAB)]
                   + PAGED_SERVE_ARGS[PAGED_SERVE_ARGS.index("--random_init"):
                                      PAGED_SERVE_ARGS.index("--vocab_size")]
                   + PAGED_SERVE_ARGS[PAGED_SERVE_ARGS.index("--vocab_size")
                                      + 2:])
# with 32 new tokens each, on the first 8 requests of each mix
for _args in (GPT2_SERVE_ARGS, GPT2_PAGED_ARGS):
    _args[_args.index("--max_new_tokens") + 1] = "32"
    _args[_args.index("--num_requests") + 1] = "8"
SAMPLED_ARGS = ["--temperature", "0.8", "--decode_top_k", "50",
                "--decode_top_p", "0.95"]
SAMPLER_DRAWS = 20000    # sampler_check: seeds 0..19999 on one row
SAMPLER_P = 1e-3         # its chi-square's significance level


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip())
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"device: torch sees {count} card(s); cuda:0 is {kind}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return {"platform": "gpu", "kind": kind, "count": count}


def _spills(ptxas_log: str) -> dict:
    """{mangled kernel name: (spill store bytes, spill load bytes)} from
    nvcc's -Xptxas -v report."""
    import re
    out, name = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = (int(m.group(1)), int(m.group(2)))
    return out


def _hgmma_counts(so_path) -> dict:
    """{mangled kernel name: HGMMA instructions} in a built library's SASS
    (cuobjdump from nvcc's toolkit)."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.build import (
        nvcc_path)
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = 0
        elif name and "HGMMA" in line:
            out[name] += 1
    return out


def phase_build() -> None:
    """Every source built; each kernel's registers / smem / spills printed.
    Every wgmma kernel (`WGMMA_KERNELS`) must be found, hold HGMMA
    instructions (cuobjdump) and, at head_dim 64 (the model's), spill
    nothing; nor may any instantiation of the decode kernel at head_dim 64,
    nor the paged chunk kernel at any head_dim or pool dtype."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.build import (
        all_sources, build)
    t0 = time.perf_counter()
    results = build(all_sources())
    log(f"build: {len(results)} source(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    found = set()
    for r in results:
        log(f"build: {r.name}.cu -> {r.path.name} ({r.seconds:.1f} s)")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  {line.strip()}")
        if r.name == "paged_decode":
            decode = {n: sl for n, sl in _spills(r.log).items()
                      if PAGED_KERNELS["decode"] in n and "Li64E" in n}
            if not decode:
                raise AssertionError("no head_dim 64 decode kernel in the "
                                     "ptxas report")
            for name, (st, ld) in decode.items():
                if st or ld:
                    raise AssertionError(f"{name} spills at head_dim 64: "
                                         f"{st} bytes stored, {ld} loaded")
        if not r.name.endswith("_sm90"):
            continue
        for name, n in sorted(_hgmma_counts(r.path).items()):
            kernel = next((k for k in WGMMA_KERNELS if k in name), None)
            if kernel:
                found.add(kernel)
                log(f"build: {name}: {n} HGMMA instructions")
                if n == 0:
                    raise AssertionError(f"{name} has no HGMMA instruction")
        for name, (st, ld) in _spills(r.log).items():
            if any(k in name for k in WGMMA_KERNELS) and (
                    "ILi64E" in name or PAGED_KERNELS["chunk"] in name) \
                    and (st or ld):
                raise AssertionError(f"{name} spills: {st} bytes stored, "
                                     f"{ld} loaded")
    if found != set(WGMMA_KERNELS):
        raise AssertionError(f"wgmma kernels not found in the SASS: "
                             f"{sorted(set(WGMMA_KERNELS) - found)}")


def _inputs(torch, shape, hkv, dtype, seed):
    b, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda heads: torch.randn((b, heads, t, d), generator=g,
                                   device="cuda").to(dtype)
    return mk(h), mk(hkv), mk(hkv)


def _grid_halves(torch, x):
    """x on the grid {-1.5, -1, ..., 1.5}: products and their sums are exact
    in f32 in any order."""
    return torch.round(2 * x).clamp(-3, 3) / 2


# forward kernel vs its plain version. f32: within 1e-4 (sum order). bf16:
# o per element within `flash_attention.bf16_limit` -- one bf16 step + what
# rounding p against the running max can move it (`rounding_slack`) + 1e-5
# of its row's max; the "exact" case (one key tile, grid values: p the same
# bits on both sides) with no slack. lse is f32 in both.
FWD_O_TOL = {"float32": 1e-4}
FWD_LSE_TOL = {"bfloat16": 1e-3, "float32": 1e-4}
FWD_LIMIT = {"bfloat16": "1 bf16 step + rounding_slack + 1e-5 of the row's "
                         "max |o|",
             "bfloat16 exact": "1 bf16 step + 1e-5 of the row's max |o|, no "
                               "slack"}
# ((b, h, t, d), hkv, t_real, opts): the 45m prefill shapes, one key tile
# and its edges (t 1, 63, 64, 65, 127, 129, 1000), head_dim 32/64/128, MHA
# and GQA group 2 and 4, t_real < t
FWD_CASES = [((4, 8, 64, 64), 8, None, ()), ((4, 8, 300, 64), 8, None, ()),
             ((4, 8, 512, 64), 8, None, ()), ((2, 8, 256, 64), 4, 200, ()),
             # the slot prefill at tp 2: 4 local heads, 4 local kv heads
             ((4, 4, 512, 64), 4, None, ()), ((2, 4, 192, 64), 4, None, ()),
             ((2, 4, 256, 128), 4, None, ()), ((2, 4, 192, 32), 2, 150, ()),
             ((1, 8, 1, 64), 2, None, ()), ((2, 4, 63, 32), 1, None, ()),
             ((1, 4, 65, 128), 2, 60, ()), ((2, 8, 127, 64), 2, 100, ()),
             ((1, 8, 129, 128), 8, None, ()), ((1, 8, 1000, 64), 2, 999, ()),
             ((2, 8, 60, 64), 8, None, ("exact",))]


def _fwd_err(torch, o, ro, name, slack) -> tuple:
    """(max abs err, worst err / limit) of the forward output o against the
    plain ro; a ratio <= 1 passes."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        bf16_limit)
    d = (o.float() - ro.float()).abs()
    limit = (torch.full_like(d, FWD_O_TOL[name]) if name == "float32"
             else bf16_limit(ro, slack))
    return d.max().item(), (d / limit.clamp_min(1e-30)).max().item()


def phase_kernel_vs_plain(torch) -> float:
    """Returns the largest bf16 output error (the served dtype)."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        MASK, flash_attention_fwd, flash_attention_fwd_plain, rounding_slack)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for i, (shape, hkv, t_real, opts) in enumerate(FWD_CASES):
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            q, k, v = _inputs(torch, shape, hkv, torch.float32, seed=i)
            if "exact" in opts:
                q, k, v = (_grid_halves(torch, x) for x in (q, k, v))
            q, k, v = (x.to(dtype) for x in (q, k, v))
            before = flash_attention_fwd.launches
            o, lse = flash_attention_fwd(q, k, v, t_real=t_real)
            torch.cuda.synchronize()
            launched = flash_attention_fwd.launches - before
            ro, rlse = flash_attention_fwd_plain(q, k, v, t_real=t_real)
            slack = 0.0
            if name == "bfloat16" and "exact" not in opts:
                slack = rounding_slack(q, k, v, ro, rlse, torch.zeros_like(q),
                                       t_real)["o"]
            o_err, ratio = _fwd_err(torch, o, ro, name, slack)
            live = t_real or shape[2]
            lse_err = (lse - rlse)[..., :live].abs().max().item()
            pad_ok = t_real is None or (
                bool((o[:, :, t_real:] == 0).all())
                and bool((lse[:, :, t_real:] == MASK).all()))
            limit = (f"{FWD_O_TOL[name]:g}" if name == "float32" else
                     FWD_LIMIT["bfloat16 exact" if "exact" in opts
                               else "bfloat16"])
            log(f"kernel vs plain: q{shape} hkv {hkv} t_real {t_real} {name}"
                f"{' exact' if opts else ''}: o max abs err {o_err:.3e}, "
                f"err/limit {ratio:.3f} (limit {limit}), lse {lse_err:.3e} "
                f"(tol {FWD_LSE_TOL[name]:g}), pad rows exact {pad_ok}, "
                f"launches {launched}")
            if not (ratio <= 1.0 and lse_err <= FWD_LSE_TOL[name] and pad_ok
                    and launched == 1):
                raise AssertionError(f"flash kernel disagrees with its plain "
                                     f"version at q{shape} {name}")
            worst[name] = max(worst[name], o_err)
    return worst["bfloat16"]


def _time_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
    """Host time per call of `fn`, by the host's clock over `iters` calls
    that are only enqueued (no synchronisation between them): what a
    launch costs the host, whatever the kernel takes on the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host


def _device_ms(torch, fns, iters: int = 20, warmup: int = 3,
               tries: int = 3) -> tuple:
    """([ms per fn], how): mean device time of the kernels each of `fns`
    launches per call, from torch.profiler, one session each — what a
    library call costs the card, without the host time of its autograd
    machinery (which event timing includes wherever the host cannot keep
    the stream full). The profiler now and then returns no device events
    for a session; then all are profiled again, and after `tries` rounds
    all are timed by CUDA events instead, which `how` says."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA

    def profiled(fn):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == cuda) / iters / 1e3

    for _ in range(tries):
        ms = [profiled(fn) for fn in fns]
        if all(x > 0 for x in ms):
            return ms, f"device kernel time of {iters} calls (torch.profiler)"
        log("torch.profiler saw no device kernels in a session; again")
    return ([_time_ms(torch, fn, iters=iters) for fn in fns],
            f"CUDA events over {iters} calls, host included (the profiler "
            f"saw no device kernels in {tries} rounds)")


def bound(b, h, hkv, t, d, t_real, dtype_name) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes the function must move
    over the memory rate and the operations this data needs over the peak
    rate for its dtype. Bytes: q, k, v read once, o and the f32 lse written
    once. Operations: 2 products of 2*d flops for each (row, key) pair the
    causal mask leaves live, t_real*(t_real+1)/2 per head."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = item * (2 * b * h * t * d + 2 * b * hkv * t * d) + 4 * b * h * t
    flops = 4 * d * b * h * t_real * (t_real + 1) // 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def causal_flops(b, h, t, d, products) -> int:
    """2*d flops per product on each live (row, key) pair of every head."""
    return products * 2 * d * b * h * t * (t + 1) // 2


def _fwd_times(torch, shape, seed) -> dict:
    """The forward at `shape` (bf16, MHA): through the wrapper and by bare
    launches (CUDA events over 100), the bare launch's device time
    (torch.profiler), achieved TFLOP/s of the live pairs, the plain version,
    SDPA (causal) and the bound."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        _launch_fwd, flash_attention_fwd, flash_attention_fwd_plain)
    b, h, t, d = shape
    q, k, v = _inputs(torch, shape, h, torch.bfloat16, seed=seed)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bare = lambda: _launch_fwd(q, k, v, o, lse, t, stream)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q, k, v, is_causal=True)
    with torch.no_grad():
        wrapper_ms = _time_ms(torch, lambda: flash_attention_fwd(q, k, v))
        ms = _time_ms(torch, bare)
        plain_ms = _time_ms(torch, lambda: flash_attention_fwd_plain(q, k, v),
                            iters=10, warmup=2)
        lib_event_ms = _time_ms(torch, lib)
        (dev_ms, lib_ms), how = _device_ms(torch, [bare, lib])
        again = _time_ms(torch, bare)
    bound_ms, bound_by = bound(b, h, h, t, d, t, "bfloat16")
    tflops = causal_flops(b, h, t, d, 2) / (dev_ms * 1e-3) / 1e12
    log(f"forward times at q{shape} bf16 (flash_fwd_sm90), warm L2: bare "
        f"launches {ms:.5f} ms (again {again:.5f}), through the wrapper "
        f"{wrapper_ms:.5f} ms (CUDA events over 100); device time "
        f"{dev_ms:.5f} ms ({how}) = {tflops:.1f} TFLOP/s of the live pairs; "
        f"plain {plain_ms:.5f} ms; library (scaled_dot_product_attention, "
        f"is_causal) {lib_ms:.5f} ms device, {lib_event_ms:.5f} ms events; "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    return {"ms": ms, "device_ms": dev_ms, "wrapper_ms": wrapper_ms,
            "tflops": tflops, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_event_ms": lib_event_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_times(torch) -> dict:
    """The forward at the largest 45m prefill shape (the kernels line's)."""
    return _fwd_times(torch, (4, 8, 512, 64), seed=99)


def phase_serve(torch) -> dict:
    """Returns the served run's launches {fwd, dq, dkv} and its tokens/s,
    TTFT and TPOT (`one_engine`)."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    _reset_launches()
    out = serve.main(SERVE_ARGS)
    counts = _read_launches()
    launches = counts["flash_attention_fwd"]
    torch.cuda.synchronize()
    layers = model_preset("45m").num_layers
    log(f"serve: {out['completed']}/{out['requests']} requests, "
        f"{out['generated_tokens']} tokens in {out['wall_s']} s -> "
        f"{out['tokens_per_sec']} tok/s; TTFT p50/p95 {out['ttft_ms_p50']}/"
        f"{out['ttft_ms_p95']} ms; TPOT p50/p95 {out['tpot_ms_p50']}/"
        f"{out['tpot_ms_p95']} ms; {out['decode_steps']} decode steps, "
        f"{out['prefill_dispatches']} prefill dispatches, kernel launches "
        f"{counts}; device {out['device']}")
    if out["completed"] != out["requests"]:
        raise AssertionError(f"served {out['completed']} of "
                             f"{out['requests']} requests")
    toks = [t for ts in out["outputs"].values() for t in ts]
    if not toks or not all(0 <= t < 1024 for t in toks):
        raise AssertionError("generated tokens missing or outside the vocab")
    if launches == 0:
        raise AssertionError("slot serving launched no flash kernel")
    _only(counts, {"flash_attention_fwd": layers * out["prefill_dispatches"]},
          f"slot serving ({layers} per prefill dispatch)")
    return {**counts, "one_engine": {k: out[k] for k in (
        "tokens_per_sec", "ttft_ms_p50", "ttft_ms_p95", "tpot_ms_p50",
        "tpot_ms_p95")}}


def phase_card_vs_cpu(torch) -> None:
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.models.decode import _prefill
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.ops.rope import rope_tables
    cfg = model_preset("45m", compute_dtype="float32")
    cpu = Transformer(cfg).init_weights(seed=5)
    card = Transformer(cfg)
    card.load_state_dict(cpu.state_dict())
    card.to("cuda")
    rng = np.random.default_rng(5)
    lens = [200, 117]
    buf = np.ones((2, 256), np.int64)            # EOS-padded, one bucket
    for i, n in enumerate(lens):
        buf[i, :n] = rng.integers(3, cfg.vocab_size, size=n)
    logits = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        cos, sin = rope_tables(cfg.maxlen, cfg.head_dim, cfg.rope_theta, dev)
        with torch.inference_mode():
            _, _, lg = _prefill(model, torch.from_numpy(buf).to(dev),
                                torch.tensor(lens, device=dev), cos, sin,
                                torch.float32)
        logits.append(lg.float().cpu())
    diff = (logits[0] - logits[1]).abs().max().item()
    scale = logits[1].abs().max().item()
    agree = int((logits[0].argmax(-1) == logits[1].argmax(-1)).sum())
    log(f"card vs cpu: 45m f32 prefill logits of {len(lens)} prompts, max abs "
        f"diff {diff:.3e} vs max |logit| {scale:.3e} (tol 1e-3 x), greedy "
        f"first tokens agree {agree}/{len(lens)}")
    if not diff <= 1e-3 * scale:
        raise AssertionError("card and CPU prefill logits disagree")


def _device_busy(prof, torch) -> tuple:
    """(kernel ms, kernel count, flash kernel ms, flash count) from a
    torch.profiler run: the device-side kernel events (one stream, so
    their durations do not overlap)."""
    cuda = torch.autograd.DeviceType.CUDA
    busy = flash = 0.0
    n = n_flash = 0
    for e in prof.events():
        if e.device_type != cuda:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        n += 1
        if "flash_fwd_sm90_kernel" in e.name:
            flash += us
            n_flash += 1
    return busy / 1e3, n, flash / 1e3, n_flash


def _profiled(torch, fn, what: str, agree=lambda seen: seen) -> list:
    """(name, us) of each device kernel that torch.profiler records over
    fn() and a synchronize. A run that records none is profiled once more;
    a second such run raises. `agree(seen)` turns this process's "recorded
    some" into the decision every rank of a group takes (a collective), so
    ranks repeat their collectives together."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == cuda]
        if agree(bool(events)):
            return events
    raise AssertionError(f"{what}: torch.profiler recorded no device kernel "
                         f"in two profiled runs")


def profile_engine(torch, cfg, device: str, prompt_len: int = 512,
                   steps: int = 10) -> dict:
    """Where the time goes in the two device programs at `cfg`, on fresh
    engines with 8 slots: the admission step of 4 prompts of
    `prompt_len` (one prefill dispatch + one decode step), then `steps`
    decode steps with 8 live slots. Wall times are host clock around steps
    that end in a host copy (so they include the device work), taken
    without the profiler; device busy time and kernel counts come from a
    profiled repeat of the same work."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from distributed_pytorch_from_scratch_tpu_torch.config import MeshConfig
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        ContinuousBatchingEngine, Request)
    mesh = make_mesh(MeshConfig(), device=device)
    model = Transformer(cfg).init_weights(seed=1).to(mesh.device)
    activities = [ProfilerActivity.CPU]
    if mesh.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda: None))
    rng = np.random.default_rng(0)
    prompts = [[int(x) for x in rng.integers(3, cfg.vocab_size, prompt_len)]
               for _ in range(8)]
    new = steps + 4

    def fresh():
        # eos_id = vocab_size: an id greedy decoding never picks, so every
        # request stays live through the window
        return ContinuousBatchingEngine(
            model, mesh, num_slots=8, buf_len=prompt_len + new + 2,
            eos_id=cfg.vocab_size, max_prefill_batch=4)

    def admit(eng, first):
        for i in range(first, first + 4):
            eng.submit(Request(rid=i, prompt=prompts[i], max_new=new))
        eng.step()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    admit(fresh(), 0)                               # warm-up
    eng = fresh()
    admit_ms = timed(lambda: admit(eng, 0))
    admit(eng, 4)
    decode_ms = timed(lambda: [eng.step() for _ in range(steps)]) / steps
    eng = fresh()
    with profile(activities=activities) as prof_admit:
        admit(eng, 0)
        sync()
    admit(eng, 4)
    with profile(activities=activities) as prof_decode:
        for _ in range(steps):
            eng.step()
        sync()
    a_busy, a_n, a_flash, a_nflash = _device_busy(prof_admit, torch)
    d_busy, d_n, _, _ = _device_busy(prof_decode, torch)
    return {"admit_ms": admit_ms, "admit_busy_ms": a_busy,
            "admit_kernels": a_n, "admit_flash_ms": a_flash,
            "admit_flash_launches": a_nflash, "decode_ms": decode_ms,
            "decode_busy_ms": d_busy / steps,
            "decode_kernels": d_n / steps, "live": eng.live_requests}


def phase_profile(torch) -> None:
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    for _ in range(2):   # fresh engines each time: a second try if needed
        p = profile_engine(torch, model_preset("45m", compute_dtype="bfloat16"),
                           "cuda")
        if p["admit_kernels"] and p["decode_kernels"]:
            break
    else:
        raise AssertionError("profile: torch.profiler recorded no device "
                             "kernel in two profiled runs")
    log(f"profile (45m bf16, 8 slots): decode step with {p['live']} live: "
        f"wall {p['decode_ms']:.3f} ms, device busy "
        f"{p['decode_busy_ms']:.3f} ms, idle share "
        f"{1 - p['decode_busy_ms'] / p['decode_ms']:.3f}, "
        f"{p['decode_kernels']:.0f} kernels/step; admission step (prefill "
        f"4 x 512 + 1 decode): wall {p['admit_ms']:.3f} ms, device busy "
        f"{p['admit_busy_ms']:.3f} ms, {p['admit_kernels']} kernels, flash "
        f"{p['admit_flash_ms']:.3f} ms over {p['admit_flash_launches']} "
        f"launches ({p['admit_flash_ms'] / p['admit_busy_ms']:.3f} of busy)")


def bound_bwd(b, h, hkv, t, d, t_real, dtype_name, part="pair") -> tuple:
    """(bound_ms, bound_by) of the attention backward, worked out from the
    kernels: bytes = q, k, v, do read and the part's outputs written (dq;
    dk, dv; or all three) in the input dtype, plus the f32 lse and delta
    read; operations = 2*d flops for each product on each (row, key) pair
    the causal mask leaves live — 3 products for dq (s, dp, dq), 4 for
    dk/dv (s, dp, dv, dk), 5 for the pair (s and dp are shared)."""
    item = 2 if dtype_name == "bfloat16" else 4
    q_elems, kv_elems = b * h * t * d, b * hkv * t * d
    out_elems = {"dq": q_elems, "dkv": 2 * kv_elems,
                 "pair": q_elems + 2 * kv_elems}[part]
    products = {"dq": 3, "dkv": 4, "pair": 5}[part]
    nbytes = item * (2 * q_elems + 2 * kv_elems + out_elems) + 8 * b * h * t
    flops = products * 2 * d * b * h * t_real * (t_real + 1) // 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


BWD_CASES = [  # (b, h, hkv, t, d, t_real), what it stands for, options
    ((4, 8, 8, 1000, 64, None), "row 2: one block, group 1", ()),
    ((2, 8, 4, 256, 64, 200), "row 3: one block, GQA, pad rows", ()),
    ((1, 4, 2, 1300, 64, 1250), "rows 4-5: t > 1024, multi-block", ()),
    ((2, 4, 4, 192, 32, 150), "head_dim 32, pad rows", ()),
    ((2, 4, 4, 256, 128, None), "head_dim 128", ()),
    ((1, 8, 2, 1, 64, None), "t 1, GQA group 4", ()),
    ((2, 4, 1, 63, 32, None), "t 63, head_dim 32, group 4", ()),
    ((2, 4, 2, 64, 64, None), "t 64: one tile", ()),
    ((1, 4, 2, 65, 128, 60), "t 65, head_dim 128, pad rows", ()),
    ((2, 8, 2, 127, 64, 100), "t 127, group 4, pad rows", ()),
    ((1, 8, 8, 129, 128, None), "t 129, head_dim 128", ()),
    ((2, 8, 8, 60, 64, None), "one key tile, grid values, no slack",
     ("exact",)),
]
# f32: within 1e-4 of the plain version's largest |gradient| plus, per
# element, the sum order of dp carried through ds (`rounding_slack` of f32
# inputs: where ds cancels, as in a row that sees one key, every value is
# sum-order noise). bf16: per element, `flash_attention.bf16_limit` with the
# rounding slack of p and ds. The "exact" case: no slack
BWD_TOL = {"float32": 1e-4}
BWD_LIMIT = {"bfloat16": "1 bf16 step + rounding_slack + 1e-5 of the row's "
                         "max |grad|",
             "bfloat16 exact": "1 bf16 step + 1e-5 of the row's max |grad|, "
                               "no slack"}


def _bwd_inputs(torch, case, dtype, seed, exact=False):
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_fwd_plain)
    b, h, hkv, t, d, t_real = case
    q, k, v = _inputs(torch, (b, h, t, d), hkv, torch.float32, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn((b, h, t, d), generator=g, device="cuda")
    if exact:
        q, k, v, do = (_grid_halves(torch, x) for x in (q, k, v, do))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    o, lse = flash_attention_fwd_plain(q, k, v, t_real=t_real)
    return q, k, v, o, lse, do


def _bwd_errs(torch, got, ref, name, slack) -> tuple:
    """({dq, dk, dv: max abs err}, {...: worst err / limit}); a ratio <= 1
    passes. f32: relative to the tensor's max |plain|; bf16 per element."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        bf16_limit)
    errs, ratios = {}, {}
    for label, x, r in zip(("dq", "dk", "dv"), got, ref):
        d = (x.float() - r.float()).abs()
        if name == "float32":
            limit = slack[label] + torch.full_like(d, BWD_TOL[name] * max(
                r.float().abs().max().item(), 1e-30))
        else:
            limit = bf16_limit(r, slack[label])
        errs[label] = d.max().item() if d.numel() else 0.0
        ratio = d / limit.clamp_min(1e-30)
        ratios[label] = ratio.max().item() if d.numel() else 0.0
        if x.dtype != r.dtype:
            ratios[label] = float("inf")
        if ratios[label] > 1.0:   # where, for the failure's log
            at = [int(i) for i in torch.unravel_index(ratio.argmax(),
                                                       ratio.shape)]
            log(f"  {label} worst at (b, h, row, col) {at}: kernel "
                f"{x.float()[tuple(at)].item():.6e}, plain "
                f"{r.float()[tuple(at)].item():.6e}, limit "
                f"{limit[tuple(at)].item():.3e}")
    return errs, ratios


def phase_bwd_check(torch) -> dict:
    """Returns the largest bf16 abs error of each kernel's outputs. Each
    case: the pair through the wrapper (one launch of each kernel), again
    (bit-equal: no atomics), against the plain backward."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, rounding_slack)
    worst = {"dq": 0.0, "dkv": 0.0}
    for i, (case, what, opts) in enumerate(BWD_CASES):
        b, h, hkv, t, d, t_real = case
        exact = "exact" in opts
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            args = _bwd_inputs(torch, case, dtype, seed=10 + i, exact=exact)
            n_dq = flash_attention_bwd.launches_dq
            n_dkv = flash_attention_bwd.launches_dkv
            got = flash_attention_bwd(*args, t_real=t_real)
            torch.cuda.synchronize()
            launched = (flash_attention_bwd.launches_dq - n_dq,
                        flash_attention_bwd.launches_dkv - n_dkv)
            again = flash_attention_bwd(*args, t_real=t_real)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            ref = flash_attention_bwd_plain(*args, t_real=t_real)
            slack = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
            if not exact:
                slack = rounding_slack(*args, t_real=t_real)
            errs, ratios = _bwd_errs(torch, got, ref, name, slack)
            torch.cuda.synchronize()
            if name == "bfloat16":
                worst["dq"] = max(worst["dq"], errs["dq"])
                worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"])
            pad_ok = t_real is None or all(
                bool((x[:, :, t_real:] == 0).all()) for x in got)
            limit = (f"rel {BWD_TOL[name]:g} of max |grad| + dp sum order"
                     if name == "float32" else
                     BWD_LIMIT["bfloat16 exact" if exact else "bfloat16"])
            log(f"bwd vs plain: {what}: q({b}, {h}, {t}, {d}) hkv {hkv} "
                f"t_real {t_real} {name}: max abs err "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + "; err/limit "
                + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items())
                + f" (limit {limit}); pad rows/keys exact {pad_ok}; second "
                f"call bit-equal {same}; launches dq/dkv {launched}")
            if not (max(ratios.values()) <= 1.0 and pad_ok and same
                    and launched == (1, 1)):
                raise AssertionError(f"flash backward kernels disagree with "
                                     f"their plain version at {case} {name}")
    return worst


def phase_bwd_times(torch) -> dict:
    """At the 45m training shape, the shape the train path launches: see
    `_flash_times_at`."""
    return _flash_times_at(torch, TRAIN_SHAPE, seed=7)


def _flash_times_at(torch, shape, seed: int) -> dict:
    """At a train path's `shape` (b, h, t, d): the forward and both
    backward kernels held against their plain versions on the same inputs
    (bf16 per element, with their rounding slack), then timed by bare
    launches (CUDA events) and device time (torch.profiler). Returns the
    kernels-line fields of flash_attention_bwd_dq / _dkv, the forward's
    times and the errors."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        _bwd_args, _delta, _launch_dkv, _launch_dq, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain, rounding_slack)
    b, h, t, d = shape
    q, k, v = _inputs(torch, shape, h, torch.bfloat16, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v)
    ro, rlse = flash_attention_fwd_plain(q, k, v)
    slack = rounding_slack(q, k, v, ro, rlse, do)
    errs, ratios = {}, {}
    errs["o"], ratios["o"] = _fwd_err(torch, o, ro, "bfloat16", slack["o"])
    errs["lse"] = (lse - rlse).abs().max().item()
    got = flash_attention_bwd(q, k, v, ro, rlse, do)
    ref = flash_attention_bwd_plain(q, k, v, ro, rlse, do)
    e, r = _bwd_errs(torch, got, ref, "bfloat16", slack)
    errs.update(e)
    ratios.update(r)
    del ro, rlse, got, ref, slack
    torch.cuda.empty_cache()   # the plain versions' t x t temporaries
    log(f"kernels vs plain at q{shape} bf16 (the train path's shape): "
        f"max abs err " + ", ".join(f"{x} {errs[x]:.3e}" for x in errs)
        + "; err/limit " + ", ".join(f"{x} {ratios[x]:.3f}" for x in ratios)
        + f" (limit {BWD_LIMIT['bfloat16']}; lse tol "
        f"{FWD_LSE_TOL['bfloat16']:g})")
    if not (max(ratios.values()) <= 1.0
            and errs["lse"] <= FWD_LSE_TOL["bfloat16"]):
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions at q{shape} bf16")
    fwd = _fwd_times(torch, shape, seed=seed)
    # bare launches of each backward kernel (not counted), to time it alone
    delta = _delta(o, do)
    args = _bwd_args(q, k, v, lse, delta, do, t)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    stream = torch.cuda.current_stream().cuda_stream
    run_dq = lambda: _launch_dq(args, dq, stream)
    run_dkv = lambda: _launch_dkv(args, dk, dv, stream)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, is_causal=True), (qg, kg, vg),
                            do)

    with torch.no_grad():
        dq_ms = _time_ms(torch, run_dq)
        dkv_ms = _time_ms(torch, run_dkv)
        pair_ms = _time_ms(torch, lambda: flash_attention_bwd(q, k, v, o, lse,
                                                              do))
        plain_ms = _time_ms(torch, lambda: flash_attention_bwd_plain(
            q, k, v, o, lse, do), iters=10, warmup=2)
    (dq_dev, dkv_dev, sdpa_fwd_ms, sdpa_both_ms), how = _device_ms(
        torch, [run_dq, run_dkv, lambda: sdpa(q, k, v, is_causal=True),
                sdpa_fwd_bwd])
    library_ms = sdpa_both_ms - sdpa_fwd_ms
    sdpa_both_event_ms = _time_ms(torch, sdpa_fwd_bwd)
    pair_again_ms = _time_ms(torch, lambda: flash_attention_bwd(
        q, k, v, o, lse, do))
    bounds = {part: bound_bwd(b, h, h, t, d, t, "bfloat16", part)
              for part in ("dq", "dkv", "pair")}
    # products each kernel computes: dq 3 (s, dp, dq), dk/dv 4 (s, dp, dv,
    # dk): 7 for the pair
    tflops = {"dq": causal_flops(b, h, t, d, 3) / (dq_dev * 1e-3) / 1e12,
              "dkv": causal_flops(b, h, t, d, 4) / (dkv_dev * 1e-3) / 1e12}
    log(f"bwd times at q{shape} bf16 (flash_bwd_sm90), bare launches, "
        f"CUDA events over 100 (plain: 10): dq {dq_ms:.5f} ms, device "
        f"{dq_dev:.5f} ms = {tflops['dq']:.1f} TFLOP/s (bound "
        f"{bounds['dq'][0]:.5f} ms, {bounds['dq'][1]}); dk/dv {dkv_ms:.5f} "
        f"ms, device {dkv_dev:.5f} ms = {tflops['dkv']:.1f} TFLOP/s (bound "
        f"{bounds['dkv'][0]:.5f} ms, {bounds['dkv'][1]}); pair through the "
        f"wrapper (incl. delta) {pair_ms:.5f} ms (again {pair_again_ms:.5f};"
        f" bound {bounds['pair'][0]:.5f} ms, {bounds['pair'][1]}); plain "
        f"backward {plain_ms:.5f} ms; library: scaled_dot_product_attention "
        f"(is_causal), {how}: forward+backward {sdpa_both_ms:.5f} minus "
        f"forward {sdpa_fwd_ms:.5f} = {library_ms:.5f} ms (forward+backward "
        f"by CUDA events, host included: {sdpa_both_event_ms:.5f} ms)")
    del qg, kg, vg
    torch.cuda.empty_cache()
    common = {"plain_ms": plain_ms, "plain_for": "the pair (dq, dk, dv)",
              "library_ms": library_ms,
              "library_for": "the pair: scaled_dot_product_attention "
                             f"backward minus its forward, {how}",
              "pair_ms": pair_ms}
    return {"dq": {"ms": dq_ms, "device_ms": dq_dev, "tflops": tflops["dq"],
                   "bound_ms": bounds["dq"][0], "bound_by": bounds["dq"][1],
                   **common},
            "dkv": {"ms": dkv_ms, "device_ms": dkv_dev,
                    "tflops": tflops["dkv"], "bound_ms": bounds["dkv"][0],
                    "bound_by": bounds["dkv"][1], **common},
            "fwd": fwd, "errs": errs}


def _bigram_rule(rng, vocab: int):
    """The successor table next[prev] (a permutation of ids 3..vocab-1),
    the seed's first draw."""
    import numpy as np
    nxt = np.zeros(vocab, np.int64)
    nxt[3:] = rng.permutation(np.arange(3, vocab))
    return nxt


def _bigram_docs(rng, nxt, docs: int) -> list:
    """`docs` chains of 200-999 tokens under the rule, each from a random
    first token."""
    import numpy as np
    lens = rng.integers(200, 1000, size=docs)
    chains = np.empty((docs, int(lens.max())), np.int64)
    chains[:, 0] = rng.integers(3, len(nxt), size=docs)
    for i in range(1, chains.shape[1]):
        chains[:, i] = nxt[chains[:, i - 1]]
    return [row[:n].tolist() for row, n in zip(chains, lens)]


def write_bigram_corpus(path: str, vocab: int = 1024, docs: int = 3000,
                        seed: int = 0, val_docs: int = 0,
                        rule_vocab: int = 0) -> None:
    """Token JSON in TokenDataset's schema: `docs` documents of 200-999
    tokens, each following one bigram rule drawn from the seed (next =
    perm[prev]) from a random first token, so the loss has something to
    learn. Ids 0-2 are the special tokens. The validation split is the
    first 8 training documents, or with `val_docs` that many documents
    drawn after the training ones (the same rule; the training split is
    the same either way). The rule runs over ids below `rule_vocab` (0:
    the whole vocab); the file declares `vocab` either way."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nxt = _bigram_rule(rng, rule_vocab or vocab)
    train = _bigram_docs(rng, nxt, docs)
    val = _bigram_docs(rng, nxt, val_docs) if val_docs else train[:8]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": val,
                   "special_ids": {"<BOS>": 0, "<EOS>": 1, "<UNK>": 2},
                   "vocab_size": vocab}, f)


def _reset_launches():
    """Every kernel wrapper's launch count set to 0."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.block_attention import (
        block_attention_bwd, block_attention_fwd)
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        paged_attention)
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches_dq = 0
    flash_attention_bwd.launches_dkv = 0
    paged_attention.launches = 0
    paged_attention.launches_by_route = {"decode": 0, "chunk": 0}
    paged_attention.launches_by_kernel = {
        k: 0 for k in paged_attention.launches_by_kernel}
    block_attention_fwd.launches = 0
    block_attention_bwd.launches_dq = 0
    block_attention_bwd.launches_dkv = 0


def _read_launches() -> dict:
    """Every kernel's launches since the last reset, by kernel name."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda import (
        launch_counts)
    return launch_counts()


def _only(counts: dict, want: dict, what: str) -> None:
    """Raise unless the kernels in `want` ran exactly so often and no other
    kernel ran at all."""
    got = {k: v for k, v in counts.items() if v or k in want}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want} and no other kernel")


def _corpus(workdir: str) -> str:
    """The seeded bigram corpus in `workdir`, written on first use."""
    data = os.path.join(workdir, "bigram.json")
    if not os.path.exists(data):
        t0 = time.perf_counter()
        write_bigram_corpus(data)
        log(f"bigram corpus written in {time.perf_counter() - t0:.1f} s")
    return data


def phase_train(torch, workdir: str) -> dict:
    """Returns the train path's launches by kernel and its summary."""
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    data = _corpus(workdir)
    save_dir = os.path.join(workdir, "ckpt")
    args = TRAIN_ARGS + ["--data_path", data, "--save_dir", save_dir]
    _reset_launches()
    out = train.main(args)
    counts = _read_launches()
    fwd, dq, dkv = (counts[f"flash_attention_{k}"]
                    for k in ("fwd", "bwd_dq", "bwd_dkv"))
    layers = model_preset("45m").num_layers
    losses = out["losses"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"train: {out['steps']} steps of b32 x t1000 bf16 on "
        f"{out['device']}: losses {[round(x, 4) for x in losses]}; mean of "
        f"first/last 5 {first:.4f}/{last:.4f}; step p50 "
        f"{out['step_ms_p50']:.3f} ms, {out['tokens_per_sec']:.1f} tok/s, "
        f"MFU {out['mfu']:.4f}, peak memory {out['peak_mem_gib']:.3f} GiB; "
        f"launches fwd {fwd}, dq {dq}, dkv {dkv}; checkpoint "
        f"{out['checkpoints']}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"train losses not finite or not {TRAIN_STEPS}")
    # the bigram rule takes the loss from ~ln(1024) = 6.93 towards 0; an
    # untrained model's mean CE over a batch's ~20k valid tokens varies by
    # ~0.01 from batch to batch (a per-token spread of ~1.5 nats / sqrt(2e4)),
    # so a drop of 1 nat is learning, not noise
    if not last <= first - 1.0:
        raise AssertionError(f"train loss did not fall: {first} -> {last}")
    _only(counts, {"flash_attention_fwd": 2 * layers * TRAIN_STEPS,
                   "flash_attention_bwd_dq": layers * TRAIN_STEPS,
                   "flash_attention_bwd_dkv": layers * TRAIN_STEPS},
          "train (remat: forward twice per layer)")
    ckpt = os.path.join(save_dir, f"tprank-0_iter-{TRAIN_STEPS}_loss-")
    if not any(p.startswith(ckpt) for p in out["checkpoints"]):
        raise AssertionError(f"no checkpoint at iter {TRAIN_STEPS}")
    resumed = train.main(args[:args.index("--max_steps") + 1]
                         + [str(TRAIN_STEPS + 2)]
                         + args[args.index("--max_steps") + 2:]
                         + ["--resume"])
    log(f"train --resume: started at step {resumed['start_step']}, ran to "
        f"{resumed['steps']}, losses {resumed['losses']}")
    if (resumed["start_step"] != TRAIN_STEPS
            or resumed["steps"] != TRAIN_STEPS + 2
            or not all(math.isfinite(x) for x in resumed["losses"])):
        raise AssertionError("resume did not continue from the checkpoint")
    return {**counts, "summary": out}


def phase_train_card_vs_cpu(torch) -> None:
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        IGNORE_INDEX, OptimizerConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
        adam_update, init_adam_state)
    cfg = model_preset("45m", compute_dtype="float32")
    cpu = Transformer(cfg, remat=False).init_weights(seed=3)
    card = Transformer(cfg, remat=True)
    card.load_state_dict(cpu.state_dict())
    card.to("cuda")
    rng = np.random.default_rng(3)
    b, t = 2, 256
    ids = rng.integers(3, cfg.vocab_size, size=(b, t + 1))
    tgt = ids[:, 1:].copy()
    tgt[1, 200:] = IGNORE_INDEX            # a padded tail
    batch = [torch.from_numpy(a) for a in
             (ids[:, :-1], tgt, np.tile(np.arange(t), (b, 1)))]
    res = {}
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        loss = model.loss(*(x.to(dev) for x in batch))
        loss.backward()
        res[dev] = (loss.item(), {k: p.grad.cpu() for k, p in
                                  model.named_parameters()})
    (l_card, g_card), (l_cpu, g_cpu) = res["cuda"], res["cpu"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst, worst_key = 0.0, None
    for k, gc in g_cpu.items():
        ratio = ((g_card[k] - gc).abs().max() / gc.abs().max()).item()
        if ratio > worst:
            worst, worst_key = ratio, k
    # One Adam update on each device, from the SAME params, grads and
    # moments (the CPU's: the update's arithmetic on the card against the
    # CPU's), and from each device's OWN grads. The first Adam step moves a
    # weight by ~lr * g / |g|, so a weight whose two gradients straddle 0
    # would move by up to 2 * lr (8e-5 here) apart; measured, none does.
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, max_steps=20)

    def updated(grads_by_dev):
        params = {dev: {k: p.detach().clone().to(dev) for k, p in
                        cpu.named_parameters()} for dev in ("cuda", "cpu")}
        for dev, ps in params.items():
            adam_update(ocfg, ps, {k: g.to(dev) for k, g in
                                   grads_by_dev[dev].items()},
                        init_adam_state(ps))
        return max((params["cuda"][k].cpu() - v).abs().max().item()
                   for k, v in params["cpu"].items())

    p_diff = updated({"cuda": g_cpu, "cpu": g_cpu})
    own_diff = updated({"cuda": g_card, "cpu": g_cpu})
    log(f"train card vs cpu: 45m f32 b{b} x t{t}: loss {l_card:.7f} (card, "
        f"kernels) vs {l_cpu:.7f} (cpu, plain), rel diff {rel:.3e} (tol "
        f"1e-5); worst grad leaf {worst_key}: max abs diff {worst:.3e} of its "
        f"max |grad| (tol 1e-3); one adam_update from the same inputs: max "
        f"param diff {p_diff:.3e}, from each device's own grads "
        f"{own_diff:.3e} (tol 1e-5 each)")
    if not (rel <= 1e-5 and worst <= 1e-3 and p_diff <= 1e-5
            and own_diff <= 1e-5):
        raise AssertionError("card and CPU training disagree")
    _train_bf16_vs_f32(torch)


# bf16 against f32 on one 45m train batch: the bf16 model rounds every
# activation to 2^-8 of its value; the mean cross-entropy over the batch's
# 32k tokens averages those roundings, so the two losses agree far inside
# 1e-2 of the loss unless a kernel is wrong (a wrong attention moves it by
# whole units)
BF16_LOSS_TOL = 1e-2


def _train_bf16_vs_f32(torch) -> None:
    """The step-1 loss of the 45m model at the train shape (b 32 x t 1000,
    remat, random ids from a seed) through the bf16 route (the wgmma
    kernels) against the same weights and batch through the f32 route (the
    SIMT kernels), both on the card."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    b, t = TRAIN_SHAPE[0], TRAIN_SHAPE[2]
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(3, 1024, (b, t + 1))).cuda()
    pos = torch.arange(t, device="cuda").expand(b, t)
    losses, launches = {}, {}
    state = None
    for dtype in ("float32", "bfloat16"):
        model = Transformer(model_preset("45m", compute_dtype=dtype),
                            remat=True)
        if state is None:
            model.init_weights(seed=4)
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        model.to("cuda")
        _reset_launches()
        with torch.no_grad():
            losses[dtype] = model.loss(ids[:, :-1], ids[:, 1:], pos).item()
        launches[dtype] = _read_launches()["flash_attention_fwd"]
        del model
    diff = abs(losses["bfloat16"] - losses["float32"])
    log(f"train bf16 vs f32 (45m, b{b} x t{t}, same weights and batch, on "
        f"the card): step-1 loss {losses['bfloat16']:.6f} (bf16, wgmma "
        f"kernels) vs {losses['float32']:.6f} (f32, SIMT kernels), diff "
        f"{diff:.3e} (tol {BF16_LOSS_TOL:g} x |f32 loss|); forward launches "
        f"{launches}")
    if not (diff <= BF16_LOSS_TOL * abs(losses["float32"])
            and all(n == model_preset("45m").num_layers
                    for n in launches.values())):
        raise AssertionError("bf16 and f32 train losses disagree")


def phase_train_profile(torch) -> dict:
    """One 45m bf16 train step (b 32 x t 1000, remat) under torch.profiler,
    after two warm-up steps on the same batch."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        OptimizerConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
        init_adam_state)
    from distributed_pytorch_from_scratch_tpu_torch.training.train_step import (
        build_train_step)
    cfg = model_preset("45m", compute_dtype="bfloat16")
    model = Transformer(cfg, remat=True).init_weights(seed=2).to("cuda")
    step = build_train_step(model, OptimizerConfig(lr=1e-4))
    state = init_adam_state(dict(model.named_parameters()))
    b, t = TRAIN_SHAPE[0], TRAIN_SHAPE[2]
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, t))).cuda()
    pos = torch.arange(t, device="cuda").expand(b, t)
    for _ in range(2):
        _, _, state = step(state, ids, ids, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, state = step(state, ids, ids, pos)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def one_step():
        nonlocal state
        _, _, state = step(state, ids, ids, pos)

    flash = SM90_KERNELS
    simt = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    busy, n, by_name, counts = 0.0, 0, {}, {}
    for name, us in _profiled(torch, one_step, "train profile"):
        busy += us
        n += 1
        if any(k in name for k in simt):
            raise AssertionError(f"the bf16 train step ran a SIMT flash "
                                 f"kernel: {name}")
        key = next((k for k in flash if k in name), name)
        by_name[key] = by_name.get(key, 0.0) + us
        counts[key] = counts.get(key, 0) + 1
    layers = cfg.num_layers
    want = {flash[0]: 2 * layers, flash[1]: layers, flash[2]: layers}
    if {k: counts.get(k, 0) for k in flash} != want:
        raise AssertionError(f"train profile: wgmma flash kernels "
                             f"{ {k: counts.get(k, 0) for k in flash} }, "
                             f"expected {want}")
    shares = {k: by_name.get(k, 0.0) / busy for k in flash}
    others = sorted((k for k in by_name if k not in flash),
                    key=by_name.get, reverse=True)[:8]
    log(f"train profile (45m bf16, b32 x t1000, remat): step wall "
        f"{wall_ms:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / 1e3 / wall_ms:.3f}, {n} kernels; shares of busy: "
        + ", ".join(f"{k} {v:.3f} ({by_name.get(k, 0.0) / 1e3:.3f} ms, "
                    f"{counts.get(k, 0)} launches)"
                    for k, v in shares.items())
        + f"; all three {sum(shares.values()):.3f}")
    for k in others:   # where the rest of the step goes
        log(f"  {by_name[k] / busy:.3f} of busy ({by_name[k] / 1e3:.3f} ms, "
            f"{counts[k]} launches): {k[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy / 1e3, "kernels": n,
            "shares": shares}


def _paged_inputs(torch, b, h, kvh, cw, hd, ps, mp, dtype, int8, seed):
    """q (b, h, cw, hd), one layer's k/v pools (b*mp pages + scratch,
    native in `dtype` or int8 codes with f32 scales) and a scattered
    (b, mp) int32 table, on the card from `seed`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = b * mp
    shape = (n_pages + 1, kvh, ps, hd)
    if int8:
        pool = lambda: (torch.randint(-127, 128, shape, generator=g,
                                      device="cuda", dtype=torch.int8),
                        0.01 + 0.04 * torch.rand(shape[:3], generator=g,
                                                 device="cuda"))
    else:
        pool = lambda: torch.randn(shape, generator=g, device="cuda").to(dtype)
    q = torch.randn((b, h, cw, hd), generator=g, device="cuda").to(dtype)
    tbl = torch.randperm(n_pages, generator=g, device="cuda")
    return q, pool(), pool(), tbl.reshape(b, mp).to(torch.int32)


# kernel vs plain, element by element over the valid columns. f32: 1e-5 of
# max(1, the largest |o|), the sum order only. bf16: both keep p and v in f32
# and round o once, so an element may differ by one bf16 step of the plain
# value, plus 1e-5 of its row's largest |o| for the f32 sum order
PAGED_LIMIT = {"float32": "1e-5 x max(1, max |o|)",
               "bfloat16": "1 bf16 step of each element + 1e-5 x its row's "
                           "max |o|"}


def _paged_err(torch, o, ro, valid, name) -> tuple:
    """(max abs err, worst err / limit) of kernel output o against the plain
    ro over each batch row's first `valid[r]` columns; a ratio <= 1 passes."""
    err = worst = 0.0
    for r, n in enumerate(valid):
        if not n:                        # a row with no valid column
            continue
        a, x = o[r, :, :n].float(), ro[r, :, :n].float()
        d = (a - x).abs()
        if name == "float32":
            limit = torch.full_like(
                x, 1e-5 * max(1.0, ro.float().abs().max().item()))
        else:
            _, e = torch.frexp(x.abs())   # |x| in [2^(e-1), 2^e)
            step = torch.where(x == 0, 0.0, torch.exp2((e - 8).float()))
            limit = step + 1e-5 * x.abs().amax(-1, keepdim=True)
        err = max(err, d.max().item())
        worst = max(worst, (d / limit.clamp_min(1e-30)).max().item())
    return err, worst


PAGED_CASES = [  # (what, b, h, kvh, cw, hd, ps, mp, int8, starts, qlens, off)
    ("decode ps 64, cursors 0 / mid-page / page end / last", 4, 8, 8, 1, 64,
     64, 11, False, [0, 100, 127, 703], None, 0),
    ("GQA g 4, ps 8, cw 4, per-row qlen", 3, 16, 4, 4, 64, 8, 9, False,
     [0, 13, 64], [4, 2, 3], 0),
    ("GQA g 4, ps 16, decode", 3, 16, 4, 1, 64, 16, 6, False, [5, 16, 95],
     None, 0),
    ("chunk cw 4, per-row start/qlen", 3, 8, 8, 4, 64, 64, 3, False,
     [0, 61, 130], [4, 3, 1], 0),
    ("chunk cw 128, ps 64", 2, 8, 8, 128, 64, 64, 6, False, [256, 0],
     [128, 77], 0),
    ("head_dim 32", 3, 4, 2, 4, 32, 16, 4, False, [0, 9, 40], [4, 4, 2], 0),
    ("head_dim 128", 3, 4, 4, 1, 128, 32, 4, False, [0, 31, 127], None, 0),
    ("int8 pools, decode", 4, 8, 8, 1, 64, 64, 11, True, [0, 100, 127, 703],
     None, 0),
    ("int8 pools, chunk cw 128", 2, 8, 8, 128, 64, 64, 6, True, [256, 0],
     [128, 77], 0),
    ("pos_offset 128 + lse, row 0 sees nothing", 3, 8, 8, 1, 64, 64, 4,
     False, [50, 128, 380], None, 128),
    # the decode route's edges: its warps split each row's keys into
    # sub-tiles (16 keys at bf16 head_dim 64, 8 at f32) and combine once
    ("decode, one live key (cursor 0)", 2, 8, 8, 1, 64, 64, 4, False,
     [0, 0], None, 0),
    ("decode, keys end on a sub-tile and a page end", 4, 8, 8, 1, 64, 64, 5,
     False, [31, 63, 127, 255], None, 0),
    ("decode, rows too short to reach every warp", 3, 8, 8, 1, 64, 64, 3,
     False, [5, 40, 100], None, 0),
    ("decode, full table (cursor mp * ps - 1)", 2, 8, 8, 1, 64, 64, 11,
     False, [703, 703], None, 0),
    ("decode, ps 8: sub-tiles across pages", 3, 8, 8, 1, 64, 8, 40, False,
     [37, 100, 319], None, 0),
    ("decode, GQA g 4", 3, 16, 4, 1, 64, 16, 12, False, [0, 77, 191], None,
     0),
    ("decode, GQA g 8 (two row chunks)", 2, 32, 4, 1, 64, 32, 8, False,
     [130, 255], None, 0),
    ("decode, head_dim 32, int8 pools, ps 8: loads across pages", 3, 8, 8,
     1, 32, 8, 48, True, [0, 200, 383], None, 0),
    ("decode, head_dim 128, int8 pools", 3, 8, 8, 1, 128, 32, 8, True,
     [0, 100, 255], None, 0),
    ("decode, b 1", 1, 8, 8, 1, 64, 64, 11, False, [450], None, 0),
    # the chunk route's edges: bf16 chunks run in 64-row tiles of the g * cw
    # stacked rows and 64-key tiles of the walk (f32 chunks: the SIMT kernel)
    ("chunk cw 64, one full row tile", 2, 8, 8, 64, 64, 64, 4, False,
     [0, 100], None, 0),
    ("chunk cw 65, a ragged row tile", 2, 8, 8, 65, 64, 64, 4, False,
     [0, 130], None, 0),
    ("chunk cw 128 at start 61: the chunk starts mid-page", 1, 8, 8, 128,
     64, 64, 4, False, [61], None, 0),
    ("chunk ps 8: key tiles across pages", 2, 8, 8, 64, 64, 8, 40, False,
     [37, 200], None, 0),
    ("chunk ps 16, cw 100, per-row qlen", 2, 8, 8, 100, 64, 16, 20, False,
     [3, 150], [100, 77], 0),
    ("chunk ps 128: a page across key tiles", 2, 8, 8, 128, 64, 128, 4,
     False, [100, 300], None, 0),
    ("chunk GQA g 4, cw 32: row tiles span heads", 2, 16, 4, 32, 64, 16, 10,
     False, [5, 100], [32, 20], 0),
    ("chunk head_dim 32, int8 pools, GQA g 2", 2, 8, 4, 64, 32, 16, 10, True,
     [0, 77], [64, 50], 0),
    ("chunk head_dim 128, int8 pools", 2, 4, 4, 96, 128, 32, 8, True,
     [10, 150], None, 0),
    ("chunk pos_offset 128 + lse, row 0 sees nothing", 3, 8, 8, 64, 64, 64,
     4, False, [50, 128, 300], None, 128),
    ("chunk full table (start + cw = mp * ps)", 2, 8, 8, 128, 64, 64, 4,
     False, [128, 128], None, 0),
    ("chunk qlen < cw: pad columns", 3, 8, 8, 128, 64, 64, 6, False,
     [0, 64, 200], [1, 50, 128], 0),
    # the paged engine at tp 2: 4 local heads over 4 local kv heads
    ("tp 2 decode, 4 local heads", 16, 4, 4, 1, 64, 64, 11, False,
     [40 + 44 * i for i in range(16)], None, 0),
    ("tp 2 decode, 4 local heads, int8 pools", 16, 4, 4, 1, 64, 64, 11, True,
     [40 + 44 * i for i in range(16)], None, 0),
    ("tp 2 chunk, 4 local heads", 1, 4, 4, 128, 64, 64, 6, False, [256],
     None, 0),
    ("tp 2 chunk, 4 local heads, int8 pools", 1, 4, 4, 128, 64, 64, 6, True,
     [256], None, 0),
    # the gpt2 paged engine: 12 heads over 12 kv heads (MHA), its decode
    # batch of 16 and its 128-wide chunks
    ("gpt2 decode, 12 heads", 16, 12, 12, 1, 64, 64, 11, False,
     [40 + 44 * i for i in range(16)], None, 0),
    ("gpt2 decode, 12 heads, int8 pools", 16, 12, 12, 1, 64, 64, 11, True,
     [40 + 44 * i for i in range(16)], None, 0),
    ("gpt2 chunk, 12 heads", 1, 12, 12, 128, 64, 64, 6, False, [256], None,
     0),
    ("gpt2 chunk, 12 heads, int8 pools", 1, 12, 12, 128, 64, 64, 6, True,
     [256], None, 0),
]


def _paged_cases(torch, cases, seed: int) -> dict:
    """Each case of `cases` (PAGED_CASES' tuples) at bf16 and f32: the
    kernel's o and lse against the plain version's under PAGED_LIMIT, dead
    rows exactly 0 and -1e30, one launch on the route its width names and
    the entry `kernel_route` names. Returns the largest bf16 output error
    (the served dtype) of each route, {"decode": x, "chunk": y}."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        MASK, kernel_route, paged_attention, paged_attention_plain)
    by_route = paged_attention.launches_by_route
    by_kernel = paged_attention.launches_by_kernel
    worst = {"decode": 0.0, "chunk": 0.0}
    for i, (what, b, h, kvh, cw, hd, ps, mp, int8, starts, qlens,
            off) in enumerate(cases):
        for name in ("bfloat16", "float32"):
            q, kp, vp, tbl = _paged_inputs(torch, b, h, kvh, cw, hd, ps, mp,
                                           getattr(torch, name), int8,
                                           seed + i)
            start = torch.tensor(starts, dtype=torch.int32, device="cuda")
            kw = dict(page_size=ps, pos_offset=off, return_lse=True,
                      qlen=None if qlens is None else torch.tensor(
                          qlens, dtype=torch.int32, device="cuda"))
            route = "decode" if cw == 1 else "chunk"
            entry = kernel_route(cw, q.dtype, hd)[1]
            n, n_route = paged_attention.launches, by_route[route]
            n_entry = by_kernel[entry]
            o, lse = paged_attention(q, kp, vp, tbl, start, **kw)
            torch.cuda.synchronize()
            launched = paged_attention.launches - n
            on_route = by_route[route] - n_route
            on_entry = by_kernel[entry] - n_entry
            ro, rlse = paged_attention_plain(q, kp, vp, tbl, start, **kw)
            valid = [cw if qlens is None else qlens[r] for r in range(b)]
            err, ratio = _paged_err(torch, o, ro, valid, name)
            lse_err = max((lse[r, :, :n] - rlse[r, :, :n]).abs().max().item()
                          for r, n in enumerate(valid) if n)
            dead = [r for r in range(b) if starts[r] + cw - 1 < off]
            dead_ok = all(bool((o[r] == 0).all()) and bool((lse[r] == MASK)
                                                           .all())
                          for r in dead)
            finite = bool(torch.isfinite(o.float()).all())
            log(f"paged vs plain: {what}: q({b}, {h}, {cw}, {hd}) kvh {kvh} "
                f"{name}: o max abs err {err:.3e}, worst err/limit "
                f"{ratio:.3e} (limit {PAGED_LIMIT[name]}), lse "
                f"{lse_err:.3e} (limit 1e-4); dead rows {dead} exact "
                f"{dead_ok}; finite {finite}; launches {launched}, "
                f"{on_route} on the {route} route, {on_entry} of {entry}")
            if not (ratio <= 1.0 and lse_err <= 1e-4 and dead_ok and finite
                    and launched == on_route == on_entry == 1):
                raise AssertionError(f"paged kernel disagrees with its plain "
                                     f"version: {what} {name}")
            if name == "bfloat16":
                worst[route] = max(worst[route], err)
    return worst


def phase_paged_check(torch) -> dict:
    """Returns the largest bf16 output error (the served dtype) of each
    route, {"decode": x, "chunk": y}."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        paged_attention)
    worst = _paged_cases(torch, PAGED_CASES, 200)
    # no atomics, a fixed combine order: two decode calls, the same bits
    for name in ("bfloat16", "float32"):
        q, kp, vp, tbl = _paged_inputs(torch, 16, 8, 8, 1, 64, 64, 11,
                                       getattr(torch, name), False, 250)
        start = 40 + 44 * torch.arange(16, dtype=torch.int32, device="cuda")
        kw = dict(page_size=64, return_lse=True)
        first = paged_attention(q, kp, vp, tbl, start, **kw)
        again = paged_attention(q, kp, vp, tbl, start, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(first, again))
        log(f"paged decode twice, q(16, 8, 1, 64) {name}: bit-equal {same}")
        if not same:
            raise AssertionError(f"two decode calls differ ({name})")
    # nor in the chunk kernel's: two bf16 chunk calls, the same bits
    for kv in ("bf16", "int8"):
        q, kp, vp, tbl = _paged_inputs(torch, 2, 8, 8, 128, 64, 64, 11,
                                       torch.bfloat16, kv == "int8", 251)
        start = torch.tensor([256, 61], dtype=torch.int32, device="cuda")
        kw = dict(page_size=64, return_lse=True)
        first = paged_attention(q, kp, vp, tbl, start, **kw)
        again = paged_attention(q, kp, vp, tbl, start, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(first, again))
        log(f"paged chunk twice, q(2, 8, 128, 64) bf16, {kv} pool: bit-equal "
            f"{same}")
        if not same:
            raise AssertionError(f"two chunk calls differ ({kv} pool)")
    return worst


def paged_work(b, h, kvh, cw, hd, ps, mp, starts, qlens, itemsize, int8,
               pos_offset=0) -> tuple:
    """(bytes, operations) one paged-attention call needs on this data:
    bytes = the K and V of the keys some query of the row sees (pos_offset
    .. vmax, at most mp * ps; int8 adds a 4-byte scale per head-vector) read
    once, the valid columns' q read and o written once; operations = 4 * hd
    per (query, visible key) pair. Pad columns (>= qlen) need nothing."""
    kv_vec = hd * (1 if int8 else itemsize) + (4 if int8 else 0)
    seen = lambda qpos: min(max(qpos - pos_offset + 1, 0), mp * ps)
    nbytes = flops = 0
    for r in range(b):
        valid = cw if qlens is None else qlens[r]
        vmax = starts[r] + max(valid, 1) - 1
        nbytes += (2 * kvh * seen(vmax) * kv_vec
                   + 2 * h * valid * hd * itemsize)
        flops += 4 * hd * h * sum(seen(starts[r] + i) for i in range(valid))
    return nbytes, flops


def bound_paged(*args, **kw) -> tuple:
    """(bound_ms, bound_by) of one paged-attention call on this data: the
    larger of `paged_work`'s bytes over the memory rate and its operations
    over the bf16 peak."""
    nbytes, flops = paged_work(*args, **kw)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_paged_times(torch) -> dict:
    """Kernel, plain, gather-impl and library times at the 45m decode and
    chunk shapes (the decode and chunk routes), bf16 and int8 pools, at
    `decode_long` (one row at cursor 703: 8 blocks, where the split inside a
    block stops filling the card) and at `chunk_late` (the chunk shape at
    start 512: a 640-key walk, how the chunk route's time grows with the
    walk); the last two are recorded only. Returns the kernels-line fields of
    each route (the decode and chunk shapes in bf16, the main path's calls)
    and every shape's numbers under `by_shape`."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.models.decode import (
        _gather_attend, _gather_page_view)
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        _prepare, paged_attention, paged_attention_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(11)
    shapes = {  # name: (b, cw, starts, qlens)
        "decode": (16, 1, [int(x) for x in rng.integers(64, 576, 16)], None),
        "chunk": (1, 128, [256], [128]),
        "decode_long": (1, 1, [703], None),
        "chunk_late": (1, 128, [512], [128]),
    }
    h, hd, ps, mp = 8, 64, 64, 11
    by_shape = {}
    for shape, (b, cw, starts, qlens) in shapes.items():
        for kv in ("bf16", "int8"):
            q, kp, vp, tbl = _paged_inputs(torch, b, h, h, cw, hd, ps, mp,
                                           torch.bfloat16, kv == "int8", 300)
            start = torch.tensor(starts, dtype=torch.int32, device="cuda")
            qlen = (None if qlens is None else
                    torch.tensor(qlens, dtype=torch.int32, device="cuda"))
            pos = start[:, None] + torch.arange(cw, device="cuda")[None, :]
            kw = dict(page_size=ps, qlen=qlen)
            o = paged_attention(q, kp, vp, tbl, start, **kw)
            ro = paged_attention_plain(q, kp, vp, tbl, start, **kw)
            err, ratio = _paged_err(torch, o, ro, [cw if qlens is None else
                                                   qlens[r] for r in range(b)],
                                    "bfloat16")
            if not ratio <= 1.0:
                raise AssertionError(f"paged kernel disagrees with its plain "
                                     f"version at the {shape} shape ({kv})")
            kview = _gather_page_view(kp, tbl, torch.bfloat16)
            vview = _gather_page_view(vp, tbl, torch.bfloat16)
            mask = (torch.arange(mp * ps, device="cuda")[None, None, :]
                    <= pos[:, :, None])[:, None]          # (b, 1, cw, T)
            _, _, launch = _prepare(q, kp, vp, tbl, start, **kw)
            stream = torch.cuda.current_stream().cuda_stream
            kernel_ms = _time_ms(torch, lambda: launch(stream))
            wrapper_ms = _time_ms(torch, lambda: paged_attention(
                q, kp, vp, tbl, start, **kw))
            plain_ms = _time_ms(torch, lambda: paged_attention_plain(
                q, kp, vp, tbl, start, **kw), iters=20)
            gather_ms = _time_ms(torch, lambda: _gather_attend(
                q, kp, vp, tbl, pos, torch.bfloat16))
            library_event_ms = _time_ms(torch, lambda: sdpa(
                q, kview, vview, attn_mask=mask))
            (device_ms, library_ms), how = _device_ms(
                torch, [lambda: launch(stream),
                        lambda: sdpa(q, kview, vview, attn_mask=mask)])
            kernel_again = _time_ms(torch, lambda: launch(stream))
            work = (b, h, h, cw, hd, ps, mp, starts, qlens, 2, kv == "int8")
            bound_ms, bound_by = bound_paged(*work)
            tflops = paged_work(*work)[1] / (device_ms * 1e-3) / 1e12
            by_shape[f"{shape}_{kv}"] = {
                "route": "decode" if cw == 1 else "chunk",
                "ms": kernel_ms, "ms_again": kernel_again,
                "device_ms": device_ms, "wrapper_ms": wrapper_ms,
                "plain_ms": plain_ms, "gather_ms": gather_ms,
                "library_ms": library_ms,
                "library_event_ms": library_event_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "tflops": tflops, "max_abs_err": err}
            log(f"paged times, {shape} ({by_shape[f'{shape}_{kv}']['route']} "
                f"route) q({b}, {h}, {cw}, {hd}) ps {ps} "
                f"max_pages {mp}, {kv} pool, bf16 q: kernel_ms {kernel_ms:.5f} "
                f"(again {kernel_again:.5f}; bare launches, CUDA events over "
                f"100), device_ms {device_ms:.5f} ({how}), {tflops:.2f} "
                f"TFLOP/s of the visible pairs, through the "
                f"wrapper {wrapper_ms:.5f} (events, host included), plain_ms "
                f"{plain_ms:.5f} (events over 20), gather_ms {gather_ms:.5f} "
                f"(the gather impl, events), library_ms {library_ms:.5f} "
                f"(scaled_dot_product_attention over the pre-gathered dense "
                f"view with the visibility mask, gather excluded; {how}; by "
                f"events {library_event_ms:.5f}), bound_us "
                f"{bound_ms * 1e3:.3f} ({bound_by}); max abs err vs plain "
                f"{err:.3e}; cursors {starts}")
    fields = lambda head, shape: {
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"], "gather_ms": head["gather_ms"],
        "library_ms": head["library_ms"],
        "library_for": "scaled_dot_product_attention over the pre-gathered "
                       "dense view with the visibility mask, device kernel "
                       "time (torch.profiler)",
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "shape": shape}
    return {"decode": {**fields(by_shape["decode_bf16"],
                                "decode q (16, 8, 1, 64), page_size 64, "
                                "bf16"), "by_shape": by_shape},
            "chunk": fields(by_shape["chunk_bf16"],
                            "chunk q (1, 8, 128, 64) at start 256, "
                            "page_size 64, bf16")}


def _check_paged_run(out, stats, counts, by_route, by_kernel, widths, layers,
                     vocab) -> None:
    """`by_route`: the paged launches per route; `by_kernel`: per C entry
    point; `widths`: the valid positions of each chunk dispatch. A
    one-position chunk is decode-shaped (cw = 1), so `kernel_route` sends it
    to the decode kernel; every other chunk is bf16, so the wgmma chunk
    kernel takes it and the SIMT one never runs."""
    if out["completed"] != out["requests"]:
        raise AssertionError(f"served {out['completed']} of "
                             f"{out['requests']} requests")
    toks = [t for ts in out["outputs"].values() for t in ts]
    if not toks or not all(0 <= t < vocab for t in toks):
        raise AssertionError("generated tokens missing or outside the vocab")
    if (stats["prefix_hit_tokens"] <= 0 or stats["cow_copies"] <= 0
            or stats["pages_in_use"] != 0):
        raise AssertionError(f"prefix hits {stats['prefix_hit_tokens']}, "
                             f"COW copies {stats['cow_copies']}, pages in "
                             f"use after the drain {stats['pages_in_use']}")
    if counts["paged_attention"] == 0:
        raise AssertionError("paged serving launched no paged kernel")
    _only(counts, {"paged_attention": layers * (stats["decode_steps"]
                                                + out["prefill_dispatches"])},
          f"paged serving ({layers} x (decode steps + chunks))")
    if len(widths) != out["prefill_dispatches"]:
        raise AssertionError(f"{len(widths)} chunk dispatches seen, "
                             f"{out['prefill_dispatches']} counted")
    one = widths.count(1)
    want = {"decode": layers * (stats["decode_steps"] + one),
            "chunk": layers * (out["prefill_dispatches"] - one)}
    if by_route != want:
        raise AssertionError(f"paged launches by route {by_route}, expected "
                             f"{want} ({layers} x (decode steps + {one} "
                             f"one-position chunks), {layers} x the other "
                             f"chunk dispatches)")
    want = {"paged_decode": want["decode"], "paged_chunk_sm90": want["chunk"],
            "paged_attn": 0}
    if by_kernel != want:
        raise AssertionError(f"paged launches by kernel {by_kernel}, "
                             f"expected {want}")


def phase_paged_serve(torch) -> dict:
    """Returns the bf16 run's launches {fwd, dq, dkv, paged}, the int8 run's
    paged launches, both runs' paged launches by route and by kernel, and
    the bf16 run's tokens/s, TTFT and TPOT (`one_engine`)."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    layers = model_preset("45m").num_layers
    n = PAGED_SERVE_ARGS.index("--num_requests") + 1
    runs = {"bf16": PAGED_SERVE_ARGS,
            "int8": PAGED_SERVE_ARGS[:n] + [str(PAGED_INT8_REQUESTS)]
            + PAGED_SERVE_ARGS[n + 1:] + ["--kv_dtype", "int8"]}
    by_kv = {}
    for kv, args in runs.items():
        out, counts, by_route, by_kernel, widths = _serve_with_widths(
            serve, args)
        paged = counts["paged_attention"]
        torch.cuda.synchronize()
        st = out["engine_stats"]
        att = out.get("slo_attainment") or {}
        log(f"paged serve ({kv} pages): {out['completed']}/{out['requests']} "
            f"requests, {out['generated_tokens']} tokens in {out['wall_s']} "
            f"s -> {out['tokens_per_sec']} tok/s; TTFT p50/p95 "
            f"{out['ttft_ms_p50']}/{out['ttft_ms_p95']} ms; TPOT p50/p95 "
            f"{out['tpot_ms_p50']}/{out['tpot_ms_p95']} ms; "
            f"{st['decode_steps']} decode steps, {out['prefill_dispatches']} "
            f"chunk dispatches, preemptions {st['preemptions']}, COW copies "
            f"{st['cow_copies']}, prefix hit tokens "
            f"{st['prefix_hit_tokens']} (rate {st['prefix_hit_rate']}), "
            f"kv_util {st['kv_util_mean']}, max live {st['max_live']}, "
            f"pages in use after drain {st['pages_in_use']}; SLO attainment "
            + ", ".join(f"{c} {v['attained']} of {v['completed']}"
                        for c, v in att.items())
            + f"; paged kernel launches {paged} (by route {by_route}, by "
            f"kernel {by_kernel}; one-position chunks {widths.count(1)}), all "
            f"kernels {counts}; device {out['device']}")
        _check_paged_run(out, st, counts, by_route, by_kernel, widths, layers,
                         1024)
        by_kv[kv] = {**counts, "paged_by_route": by_route,
                     "paged_by_kernel": by_kernel,
                     "one_engine": {k: out[k] for k in (
                         "tokens_per_sec", "ttft_ms_p50", "ttft_ms_p95",
                         "tpot_ms_p50", "tpot_ms_p95")}}
    return {**by_kv["bf16"], "paged_int8": by_kv["int8"]["paged_attention"],
            "paged_int8_by_route": by_kv["int8"]["paged_by_route"],
            "paged_int8_by_kernel": by_kv["int8"]["paged_by_kernel"]}


def phase_paged_card_vs_cpu(torch) -> None:
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.models.decode import (
        _paged_decode_one, _paged_prefill_chunk)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.ops.rope import rope_tables
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        _chunk_maps)
    cfg = model_preset("45m", compute_dtype="float32")
    cpu = Transformer(cfg).init_weights(seed=6)
    card = Transformer(cfg)
    card.load_state_dict(cpu.state_dict())
    card.to("cuda")
    b, ps, mp, cw = 4, 64, 6, 128
    n_pages = b * mp
    rng = np.random.default_rng(6)
    tbl = rng.permutation(n_pages).reshape(b, mp).astype(np.int32)
    shape = (cfg.num_layers, n_pages + 1, cfg.kv_heads, ps, cfg.head_dim)
    pools = {dev: (torch.zeros(shape, device=dev),
                   torch.zeros(shape, device=dev)) for dev in ("cuda", "cpu")}
    tabs = {dev: rope_tables(cfg.maxlen, cfg.head_dim, cfg.rope_theta, dev)
            for dev in ("cuda", "cpu")}
    ids = rng.integers(3, cfg.vocab_size, (b, 2 * cw)).tolist()
    cur = np.zeros(b, np.int32)
    calls = []
    for qlen in ([128, 128, 128, 100], [128, 90, 128, 128]):
        qlen = np.array(qlen, np.int32)
        # the engine's own chunk maps, one row each (pad columns: EOS)
        maps = [_chunk_maps(ids[r], int(cur[r]), int(qlen[r]), cw, ps, 1,
                            n_pages, tbl[r]) for r in range(b)]
        chunk, dstp, dsto = (np.concatenate(m) for m in zip(*maps))
        calls.append(("chunk", (chunk, cur.copy(), qlen, tbl, dstp, dsto)))
        cur = cur + qlen
    for _ in range(4):
        calls.append(("decode", (rng.integers(3, cfg.vocab_size, b)
                                 .astype(np.int32), cur.copy(), tbl)))
        cur = cur + 1
    worst = 0.0
    for kind, args in calls:
        lg = {}
        for model, dev in ((card, "cuda"), (cpu, "cpu")):
            t = [torch.from_numpy(a).to(dev) for a in args]
            lower = _paged_prefill_chunk if kind == "chunk" else \
                _paged_decode_one
            with torch.inference_mode():
                lg[dev] = lower(model, *pools[dev], *t, ps, *tabs[dev],
                                torch.float32, attn_impl="kernel").cpu()
        ratio = ((lg["cuda"] - lg["cpu"]).abs().max()
                 / lg["cpu"].abs().max()).item()
        worst = max(worst, ratio)
    pool_ratio = max(((pools["cuda"][i].cpu() - pools["cpu"][i]).abs().max()
                      / pools["cpu"][i].abs().max()).item() for i in (0, 1))
    log(f"paged card vs cpu: 45m f32, {b} rows, chunks at start 0 and 128 "
        f"(cw {cw}, per-row qlen) then 4 decode steps, kernel on the card vs "
        f"plain on the CPU: worst logits max abs diff {worst:.3e} of max "
        f"|logit| (tol 1e-4), pools {pool_ratio:.3e} of max |value| "
        f"(tol 1e-5)")
    if not (worst <= 1e-4 and pool_ratio <= 1e-5):
        raise AssertionError("card and CPU paged lowerings disagree")
    base = ["--model", "45m", "--random_init", "--vocab_size", "1024",
            "--no-bf16", "--paged", "--page_size", "64", "--prefill_chunk",
            "128", "--num_requests", "8", "--arrival", "burst",
            "--prompt_len_min", "64", "--prompt_len_max", "512",
            "--interleave", "--shared_prefix_len", "96",
            "--max_new_tokens", "32", "--slots", "16"]
    outs = {impl: serve.main(base + ["--paged_attn", impl])["outputs"]
            for impl in ("kernel", "gather")}
    same = sum(outs["kernel"][r] == outs["gather"][r] for r in outs["gather"])
    log(f"paged kernel vs gather, 45m f32 on the card, 8-request burst, 32 "
        f"new tokens: {same}/{len(outs['gather'])} requests token-identical")
    if outs["kernel"] != outs["gather"]:
        raise AssertionError("kernel and gather impls give different greedy "
                             "tokens at f32")


def phase_paged_profile(torch) -> dict:
    """One decode step (16 live slots) and one 128-position chunk dispatch
    of the paged engine at the paged_serve shape (45m bf16, page_size 64,
    prefill_chunk 128), host wall from the clock around each (they end in
    the token copy), device busy from a profiled repeat."""
    return _paged_profile(torch, "45m")


def _paged_profile(torch, preset: str) -> dict:
    """`phase_paged_profile` on the model of `preset`."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        PagedEngine, Request)
    cfg = model_preset(preset, compute_dtype="bfloat16")
    mesh = make_mesh(MeshConfig(), device="cuda")
    model = Transformer(cfg).init_weights(seed=1).to(mesh.device)
    rng = np.random.default_rng(1)
    prompt = lambda: [int(x) for x in rng.integers(3, cfg.vocab_size, 512)]
    # eos_id = vocab_size: never picked, so every request stays live
    eng = PagedEngine(model, mesh, num_slots=17, buf_len=642,
                      eos_id=cfg.vocab_size, page_size=64, prefill_chunk=128)
    for i in range(16):
        eng.submit(Request(rid=i, prompt=prompt(), max_new=120))
    while eng._prefilling or eng.scheduler.pending:
        eng.step()
    for _ in range(3):
        eng.step()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def pump():
        before = eng.prefill_dispatches
        with torch.inference_mode():
            eng._pump_prefill([])
        if eng.prefill_dispatches - before != 1:
            raise AssertionError("a pump did not dispatch exactly one chunk")

    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        paged_attention)
    kernels = {**PAGED_KERNELS, "chunk_f32": PAGED_SIMT_KERNEL}

    def profiled(fn, what):
        """(busy ms, kernels, paged ms, paged events, {route: events}, the
        wrapper's launches by C entry point in the profiled run): the
        events over every route's kernel, matched by name; the launches
        from the wrapper's counters (a profile of ~1400 kernels has
        recorded one event fewer than the kernels launched)"""
        launched = []

        def counted():
            before = dict(paged_attention.launches_by_kernel)
            fn()
            launched.append({k: v - before[k] for k, v in
                             paged_attention.launches_by_kernel.items()})

        busy = paged = 0.0
        n = n_paged = 0
        by_route = {route: 0 for route in kernels}
        for name, us in _profiled(torch, counted, f"paged profile, {what}"):
            busy += us
            n += 1
            for route, kernel in kernels.items():
                if kernel in name:
                    paged += us
                    n_paged += 1
                    by_route[route] += 1
        return busy / 1e3, n, paged / 1e3, n_paged, by_route, launched[-1]

    decode_ms = timed(eng.step)
    d = profiled(eng.step, "decode step")
    # a 512-position prompt: four chunks, for the timed pump and at most
    # two profiled ones
    eng.submit(Request(rid=99, prompt=prompt(), max_new=8))
    with torch.inference_mode():
        eng._admit([])
    chunk_ms = timed(pump)
    c = profiled(pump, "chunk dispatch")
    for what, wall, (busy, n, paged, n_paged, by_route, launched) in (
            ("decode step, 16 live", decode_ms, d),
            ("chunk dispatch, 128 positions", chunk_ms, c)):
        log(f"paged profile ({preset} bf16, ps 64): {what}: wall {wall:.3f} "
            f"ms, "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
            f"{n} kernels; paged kernel {paged:.3f} ms over {n_paged} "
            f"recorded events ({paged / busy:.3f} of busy), by route "
            f"{by_route}; launched {launched}")
    layers = cfg.num_layers
    if (d[5] != {"paged_decode": layers, "paged_chunk_sm90": 0,
                 "paged_attn": 0} or d[4]["chunk"] or d[4]["chunk_f32"]
            or not d[4]["decode"]):
        raise AssertionError(f"a decode step launched paged kernels {d[5]} "
                             f"(recorded {d[4]}), expected the decode "
                             f"kernel {layers} times and no chunk kernel")
    if (c[5]["paged_decode"] or c[5]["paged_attn"]
            or not c[5]["paged_chunk_sm90"] or c[4]["decode"]
            or c[4]["chunk_f32"] or not c[4]["chunk"]):
        raise AssertionError(f"a chunk dispatch launched paged kernels "
                             f"{c[5]} (recorded {c[4]}), expected the wgmma "
                             f"chunk kernel and no other")
    return {"decode_wall_ms": decode_ms, "decode": d, "chunk_wall_ms":
            chunk_ms, "chunk": c}


# ---- slice 4: ring attention (cp) and its positional block kernels ----

# K2's sources by route: bf16 (the cp model's path) and f32
BLOCK_SOURCES = {"bfloat16": ("distributed_pytorch_from_scratch_tpu_torch/ops/"
                              "cuda/csrc/block_attn_sm90.cu"),
                 "float32": ("distributed_pytorch_from_scratch_tpu_torch/ops/"
                             "cuda/csrc/block_attn.cu")}
# rows 6-8 of PERF.md's kernel table
BLOCK_REPLACES = {"fwd": f"{PALLAS}:810", "dq": f"{PALLAS}:850",
                  "dkv": f"{PALLAS}:878"}
# (what, b, h, hkv, tq, tk, d, q positions, kv positions): the positions are
# built by `_ring_positions` from these specs
RING_CASES = [
    ("zigzag halves (250, 250), fully visible", 2, 8, 8, 250, 250, 64,
     ("range", 750), ("range", 0)),
    ("zigzag halves (250, 250), diagonal", 2, 8, 8, 250, 250, 64,
     ("range", 750), ("range", 750)),
    ("ragged (100, 377), random positions", 2, 8, 8, 100, 377, 64,
     ("random", 0, 600), ("random", 0, 600)),
    ("ragged (1, 64)", 3, 8, 8, 1, 64, 64, ("random", 0, 64),
     ("random", 0, 64)),
    ("every row dead", 2, 8, 8, 96, 80, 64, ("range", 0), ("range", 500)),
    ("GQA h 8 / hkv 2, some dead rows", 2, 8, 2, 96, 160, 64,
     ("random", 0, 400), ("random", 100, 500)),
    ("head_dim 128", 1, 4, 4, 130, 100, 128, ("random", 0, 300),
     ("random", 0, 300)),
    ("head_dim 32, GQA h 8 / hkv 4", 2, 8, 4, 90, 200, 32, ("random", 0, 400),
     ("random", 50, 450)),
    # the edges of the wgmma kernels' 64-row tiles, in q and in k
    ("tile edges (63, 65), head_dim 32", 2, 8, 8, 63, 65, 32,
     ("random", 0, 150), ("random", 0, 150)),
    ("tile edges (64, 127)", 1, 8, 2, 64, 127, 64, ("random", 0, 200),
     ("random", 0, 200)),
    ("tile edges (65, 129), head_dim 128", 1, 4, 4, 65, 129, 128,
     ("random", 0, 200), ("random", 0, 200)),
    ("tile edges (127, 64), head_dim 32, GQA h 8 / hkv 2", 2, 8, 2, 127, 64,
     32, ("random", 0, 200), ("random", 0, 200)),
    ("tile edges (129, 1)", 2, 8, 8, 129, 1, 64, ("random", 0, 100),
     ("random", 0, 100)),
    ("tile edges (250, 63)", 2, 8, 8, 250, 63, 64, ("range", 200),
     ("random", 150, 400)),
    # position bands per 64-row tile: q tile 0 sees nothing, tile 2 every
    # key of k tiles 0-1, tile 1 a mix; k tile 2 no row. Each kernel meets
    # dead, fully visible and mixed tiles in one block
    ("dead, fully visible and mixed tiles in one block", 2, 8, 4, 192, 180,
     64, ("bands", (0, 64), (500, 600), (1000, 1100)),
     ("bands", (100, 200), (300, 700), (2000, 2100))),
    # one key tile (tk 20 <= the bf16 kernels' 64-key tile): the running max
    # is the final max, so the kernel rounds p where the plain version does;
    # q, k, v and do on a grid of halves make every score and dp exact in
    # f32 (any sum order), so p and ds are the same bits on both sides and
    # bf16 is held with no rounding slack: a kernel that skipped rounding p
    # (or ds) to bf16 fails here
    ("one key tile (100, 20), grid values, no slack", 2, 8, 8, 100, 20, 64,
     ("range", 10), ("range", 0), "exact"),
]
RING_LIMIT = {"float32": "1e-5 x max(1, max |plain|) of the tensor",
              "bfloat16": "1 bf16 step of each element + its rounding slack "
                          "(block_attention.rounding_slack) + 1e-5 of its "
                          "row's max |plain|",
              "bfloat16 exact": "1 bf16 step of each element + 1e-5 of its "
                                "row's max |plain|, no slack"}


def _ring_positions(torch, spec, b, t, g):
    """(b, t) int32 positions: ("range", start) start, start + 1, ...;
    ("random", lo, hi) uniform in [lo, hi); ("bands", (lo, hi), ...) the
    i-th 64 positions uniform in the i-th band."""
    if spec[0] == "range":
        return (spec[1] + torch.arange(t, device="cuda")).expand(b, t) \
            .to(torch.int32).contiguous()
    if spec[0] == "bands":
        return torch.cat([torch.randint(lo, hi, (b, min(64, t - 64 * i)),
                                        generator=g, device="cuda",
                                        dtype=torch.int32)
                          for i, (lo, hi) in enumerate(spec[1:])], dim=1)
    return torch.randint(spec[1], spec[2], (b, t), generator=g,
                         device="cuda", dtype=torch.int32)


def _ring_inputs(torch, case, dtype, seed):
    """q, k, v, q_pos, kv_pos, do, dlse on the card from `seed`; an
    "exact" case puts q, k, v and do on the grid {-1.5, -1, ..., 1.5}."""
    _, b, h, hkv, tq, tk, d, qspec, kspec, *opts = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    q, k, v = mk(b, h, tq, d), mk(b, hkv, tk, d), mk(b, hkv, tk, d)
    do, dlse = mk(b, h, tq, d), mk(b, h, tq)
    if "exact" in opts:
        q, k, v, do = (torch.round(2 * x).clamp(-3, 3) / 2
                       for x in (q, k, v, do))
    qp = _ring_positions(torch, qspec, b, tq, g)
    kp = _ring_positions(torch, kspec, b, tk, g)
    return ([x.to(dtype) for x in (q, k, v)] + [qp, kp, do.to(dtype), dlse])


def _ring_err(torch, x, r, name, slack) -> tuple:
    """(max abs err, worst err / limit) of kernel output x against plain r;
    a ratio <= 1 passes. Rows are the last axis."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        bf16_limit)
    x, r = x.float(), r.float()
    d = (x - r).abs()
    if name == "float32":
        limit = torch.full_like(r, 1e-5 * max(1.0, r.abs().max().item()))
    else:
        limit = bf16_limit(r, slack)
    return d.max().item(), (d / limit.clamp_min(1e-30)).max().item()


def _ring_case(torch, what, case, name, inputs) -> dict:
    """The three block kernels (through their wrappers, one launch each)
    against their plain versions on `inputs` (`_ring_inputs`); logs each
    output's error beside its limit and raises on a miss. Returns the max
    abs errors of o, dq, dk and dv."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.block_attention import (
        MASK, block_attention_bwd, block_attention_bwd_plain,
        block_attention_fwd, block_attention_plain, rounding_slack)
    q, k, v, qp, kp, do, dlse = inputs
    before = (block_attention_fwd.launches, block_attention_bwd.launches_dq,
              block_attention_bwd.launches_dkv)
    o, lse = block_attention_fwd(q, k, v, qp, kp)
    ro, rlse = block_attention_plain(q, k, v, qp, kp)
    # the backward pair from the plain forward's (o, lse): one input
    got = block_attention_bwd(q, k, v, qp, kp, ro, rlse, do, dlse)
    torch.cuda.synchronize()
    launched = (block_attention_fwd.launches - before[0],
                block_attention_bwd.launches_dq - before[1],
                block_attention_bwd.launches_dkv - before[2])
    ref = block_attention_bwd_plain(q, k, v, qp, kp, ro, rlse, do, dlse)
    exact = "exact" in case[9:]
    slack = rounding_slack(q, k, v, qp, kp, ro, rlse, do, dlse)
    if exact:
        slack = {label: torch.zeros_like(x) for label, x in slack.items()}
    limit = RING_LIMIT[f"{name} exact" if exact and name == "bfloat16"
                       else name]
    errs, ratios = {}, {}
    for label, x, r in (("o", o, ro), ("dq", got[0], ref[0]),
                        ("dk", got[1], ref[1]), ("dv", got[2], ref[2])):
        errs[label], ratios[label] = _ring_err(torch, x, r, name, slack[label])
    dead = rlse <= MASK / 2
    lse_err = (lse - rlse)[~dead].abs().max().item() if (~dead).any() else 0.0
    dead_ok = (bool((lse[dead] == MASK).all())
               and bool((o.float()[dead] == 0).all())
               and bool((got[0].float()[dead] == 0).all()))
    finite = all(bool(torch.isfinite(x.float()).all()) for x in (o, lse, *got))
    log(f"ring_check: {what}: q({case[1]}, {case[2]}, {case[4]}, {case[6]}) "
        f"kv({case[1]}, {case[3]}, {case[5]}) {name}: max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + "; err/limit " + ", ".join(f"{k} {v:.3e}" for k, v in ratios.items())
        + f" (limit {limit}); lse {lse_err:.3e} (limit 1e-5 x max(1, |lse|)); "
        f"dead rows {int(dead.sum())} exact {dead_ok}; finite {finite}; "
        f"launches fwd/dq/dkv {launched}")
    lse_lim = 1e-5 * max(1.0, rlse[~dead].abs().max().item()) \
        if (~dead).any() else 0.0
    if not (max(ratios.values()) <= 1.0 and lse_err <= lse_lim and dead_ok
            and finite and launched == (1, 1, 1)):
        raise AssertionError(f"block kernels disagree with their plain "
                             f"versions: {what} {name}")
    return errs


def _worst(errs: dict) -> dict:
    """Per kernel, the largest abs error of its outputs."""
    return {"fwd": errs["o"], "dq": errs["dq"],
            "dkv": max(errs["dk"], errs["dv"])}


def phase_ring_check(torch) -> dict:
    """The three block kernels against their plain versions; returns the
    largest abs error of each kernel's outputs over every case and dtype."""
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for i, case in enumerate(RING_CASES):
        for name in ("bfloat16", "float32"):
            inputs = _ring_inputs(torch, case, getattr(torch, name), 400 + i)
            errs = _worst(_ring_case(torch, case[0], case, name, inputs))
            worst = {part: max(worst[part], errs[part]) for part in worst}
    return worst


def bound_block(b, h, hkv, tq, tk, d, pairs, dtype_name, part) -> tuple:
    """(bound_ms, bound_by) of one block call on this data: bytes = q, k, v
    read, the part's outputs written (fwd: o and the f32 lse; dq; dk, dv;
    pair: all three) in the input dtype, the backward's do read and f32 lse,
    delta, dlse read, the int32 positions read; operations = 2*d flops per
    product on each visible (q, k) pair of every head — 2 products forward
    (s, pv), 3 for dq, 4 for dk/dv, 5 for the pair (as `bound_bwd`)."""
    item = 2 if dtype_name == "bfloat16" else 4
    q_el, kv_el = b * h * tq * d, b * hkv * tk * d
    rows = b * h * tq
    out_el = {"fwd": q_el, "dq": q_el, "dkv": 2 * kv_el,
              "pair": q_el + 2 * kv_el}[part]
    nbytes = item * (q_el + 2 * kv_el + out_el) + 4 * b * (tq + tk)
    nbytes += 4 * rows if part == "fwd" else item * q_el + 12 * rows
    products = {"fwd": 2, "dq": 3, "dkv": 4, "pair": 5}[part]
    flops = products * 2 * d * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_ring_times(torch) -> dict:
    """At the cp=2 path's shape, q and k halves (8, 8, 250, 64) bf16 (the
    wgmma route): a fully visible block and a diagonal one. Each kernel
    against its plain version (ring_check's limits), then 100 bare launches
    by CUDA events (the kernels line's `ms`, host launch cost included), the
    host's time per launch, its device time from torch.profiler and its
    TFLOP/s on the visible pairs, the plain versions, the library yardstick
    and the bound; returns the kernels-line fields (the fully visible
    block) and every case under `by_block`."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.block_attention import (
        _launch_dkv, _launch_dq, _launch_fwd, block_attention_bwd_plain,
        block_attention_plain, prepare_bwd, prepare_fwd)
    b, h, t, d = 8, 8, 250, 64
    efficient = torch.ops.aten._scaled_dot_product_efficient_attention
    stream = torch.cuda.current_stream().cuda_stream
    by_block = {}
    for block, qstart, kstart in (("full", 750, 0), ("diagonal", 750, 750)):
        case = ("", b, h, h, t, t, d, ("range", qstart), ("range", kstart))
        inputs = _ring_inputs(torch, case, torch.bfloat16, 500)
        q, k, v, qp, kp, do, dlse = inputs
        # the kernels against their plain versions at the path's own shape,
        # with ring_check's limits, before they are timed
        errs = _worst(_ring_case(torch, f"path shape, {block} block", case,
                                 "bfloat16", inputs))
        live = qp[:, :, None] >= kp[:, None, :]               # (b, tq, tk)
        pairs = int(live.sum()) * h
        fwd_args, keep_fwd = prepare_fwd(q, k, v, qp, kp)
        args, keep = prepare_bwd(q, k, v, qp, kp, *block_attention_plain(
            q, k, v, qp, kp), do, dlse)
        o, lse = torch.empty_like(q), torch.empty_like(dlse)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        run = {"fwd": lambda: _launch_fwd(fwd_args, o, lse, stream),
               "dq": lambda: _launch_dq(args, dq, stream),
               "dkv": lambda: _launch_dkv(args, dk, dv, stream)}
        ms = {part: _time_ms(torch, fn) for part, fn in run.items()}
        host = {part: _host_ms(torch, fn) for part, fn in run.items()}
        dev, how = _device_ms(torch, list(run.values()))
        ro, rlse = block_attention_plain(q, k, v, qp, kp)
        plain = {"fwd": _time_ms(torch, lambda: block_attention_plain(
                     q, k, v, qp, kp), iters=20),
                 "bwd": _time_ms(torch, lambda: block_attention_bwd_plain(
                     q, k, v, qp, kp, ro, rlse, do, dlse), iters=20)}
        # the library yardstick: memory-efficient SDPA with an additive bias
        # from the positions (last dim padded to 256 so its rows are 16-byte
        # aligned, as SDPA pads it) and compute_log_sumexp=True: one call for
        # the same (o, lse); its backward as forward+backward minus forward
        bias_buf = torch.zeros((b, h, t, 256), dtype=torch.bfloat16,
                               device="cuda")
        bias = bias_buf[..., :t]
        bias.copy_(torch.where(live, 0.0, float("-inf"))[:, None].expand(
            b, h, t, t))
        qg, kg, vg = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))

        def lib_fwd():
            efficient(q, k, v, bias, True)

        def lib_both():
            out = efficient(qg, kg, vg, bias, True)[0]
            torch.autograd.grad(out, (qg, kg, vg), do)

        (lib_fwd_ms, lib_both_ms), lib_how = _device_ms(
            torch, [lib_fwd, lib_both])
        bounds = {part: bound_block(b, h, h, t, t, d, pairs, "bfloat16", part)
                  for part in ("fwd", "dq", "dkv", "pair")}
        again = _time_ms(torch, run["fwd"])
        products = {"fwd": 2, "dq": 3, "dkv": 4}
        tflops = {p: products[p] * 2 * d * pairs / (x * 1e-3) / 1e12
                  for p, x in zip(run, dev)}
        by_block[block] = {"errs": errs, "ms": ms, "fwd_ms_again": again,
                           "device_ms": dict(zip(run, dev)), "tflops": tflops,
                           "host_ms": host,
                           "plain_ms": plain, "library_fwd_ms": lib_fwd_ms,
                           "library_bwd_ms": lib_both_ms - lib_fwd_ms,
                           "bounds": bounds, "pairs": pairs}
        log(f"ring_times, {block} block q({b}, {h}, {t}, {d}) bf16 "
            f"(block_attn_sm90), {pairs} visible (q, k) pairs: bare launches, "
            f"CUDA events over 100: fwd {ms['fwd']:.5f} ms (again "
            f"{again:.5f}), dq {ms['dq']:.5f}, dk/dv {ms['dkv']:.5f}; device "
            f"time ({how}): "
            + ", ".join(f"{p} {x:.5f} ({tflops[p]:.1f} TFLOP/s)"
                        for p, x in zip(run, dev))
            + "; host per launch (perf_counter over 100 enqueued): "
            + ", ".join(f"{p} {x:.5f}" for p, x in host.items())
            + f"; plain (events over 20): fwd {plain['fwd']:.5f}, backward "
            f"{plain['bwd']:.5f}; library (_scaled_dot_product_efficient_"
            f"attention with a position bias, {lib_how}): fwd "
            f"{lib_fwd_ms:.5f}, backward (fwd+bwd minus fwd) "
            f"{lib_both_ms - lib_fwd_ms:.5f}; bounds: "
            + ", ".join(f"{p} {x[0] * 1e3:.3f} us ({x[1]})"
                        for p, x in bounds.items()))
        del keep, keep_fwd, qg, kg, vg, bias_buf
    full = by_block["full"]
    common = {"plain_for": "plain forward resp. plain backward pair",
              "library_for": "_scaled_dot_product_efficient_attention with "
                             "an additive position bias: forward, resp. its "
                             "backward (fwd+bwd minus fwd); device time",
              "shape": "q, k halves (8, 8, 250, 64) bf16, fully visible",
              "by_block": by_block}
    fields = lambda part, plain, lib: {
        "max_abs_err_path_shape": max(x["errs"][part]
                                      for x in by_block.values()),
        "ms": full["ms"][part], "device_ms": full["device_ms"][part],
        "tflops": full["tflops"][part], "host_ms": full["host_ms"][part],
        "plain_ms": full["plain_ms"][plain], "library_ms": lib,
        "bound_ms": full["bounds"][part][0],
        "bound_by": full["bounds"][part][1], **common}
    return {"fwd": fields("fwd", "fwd", full["library_fwd_ms"]),
            "dq": fields("dq", "bwd", full["library_bwd_ms"]),
            "dkv": fields("dkv", "bwd", full["library_bwd_ms"])}



# the cp=2 cell-to-be: the 45m preset at b 8 x t 1000 bf16 with remat, two
# ranks on the one card over gloo, the bigram corpus of the train phase
CP_B, CP_T = 8, 1000
CP_ARGS = ["--model", "45m", "--bf16", "--batch_size", str(CP_B), "--maxlen",
           str(CP_T), "--warmup_steps", "2", "--lr", "1e-3", "--log_interval",
           "5", "--save_interval", "1000", "--device", "cuda"]
CP2 = ["--cp_size", "2", "--dist_backend", "gloo"]
# zigzag and tp2 run 4 steps to keep the whole script near its budget; in
# 4 the loss still falls by about 3 nats on the corpus. cp_train and
# tp_train run the 45m widths at 4 of its 12 layers (a run's fixed cost,
# its model init and final checkpoint, and its hops all scale with depth)
CP_LAYERS = 4
CP_RUNS = {  # name: (flags, steps)
    "zigzag": (["--cp_layout", "zigzag"], 4),
    "contiguous": (["--cp_layout", "contiguous"], 2),
    "ulysses": (["--cp_impl", "ulysses"], 2),
}


def _cp_want(layers: int, steps: int, name: str, t: int, b: int) -> list:
    """Per rank, the launches the run's schedule implies: the ring's blocks
    from `block_schedule` over the batch's positions (docs mode: 0..t-1 in
    every row, cut by the layout), forward twice per layer under remat;
    Ulysses runs the flash kernels once per layer over the whole sequence."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.ops.ring_attention import (
        block_schedule, cp_chunk_index)
    if name == "ulysses":
        return [{"flash_attention_fwd": 2 * layers * steps,
                 "flash_attention_bwd_dq": layers * steps,
                 "flash_attention_bwd_dkv": layers * steps}] * 2
    pos = np.stack([np.tile(cp_chunk_index(t, 2, r, name), (b, 1))
                    for r in range(2)])
    blocks = [sum(len(s) for s in rank) for rank in block_schedule(pos)]
    return [{"block_attention_fwd": 2 * layers * n * steps,
             "block_attention_bwd_dq": layers * n * steps,
             "block_attention_bwd_dkv": layers * n * steps} for n in blocks]


def _one_step_loss(workdir: str) -> float:
    """The step-1 loss of a one-rank run of phases 20's and 24's flags
    (CP_ARGS at CP_LAYERS, one step) on the workdir's corpus: the
    reference both phases hold their step-1 losses against, run once per
    workdir (the runs were the same program on the same batch)."""
    path = os.path.join(workdir, "one_step_loss.json")
    if not os.path.exists(path):
        from distributed_pytorch_from_scratch_tpu_torch import train
        res = train.main(CP_ARGS + ["--num_layers", str(CP_LAYERS),
                                    "--data_path", _corpus(workdir),
                                    "--max_steps", "1", "--save_dir",
                                    os.path.join(workdir, "one_step")])
        with open(path, "w") as f:
            json.dump(res["losses"][0], f)
    with open(path) as f:
        return json.load(f)


def phase_cp_train(torch, workdir: str) -> dict:
    """train.main at cp=2 in each layout and the cp=1 step on the same
    batch; returns each run's launches summed over ranks and the zigzag
    run's summary."""
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    data = _corpus(workdir)
    layers = CP_LAYERS
    base = CP_ARGS + ["--num_layers", str(layers), "--data_path", data]
    first = {"cp1": _one_step_loss(workdir)}
    out = {}
    for name, (flags, steps) in CP_RUNS.items():
        save = os.path.join(workdir, f"cp2_{name}")
        res = train.main(base + CP2 + flags + ["--max_steps", str(steps),
                                               "--save_dir", save])
        losses = res["losses"]
        first[name] = losses[0]
        want = _cp_want(layers, steps, name, CP_T, CP_B)
        summed = {}
        for rank, w in zip(res["ranks"], want):
            _only(rank["launches"], w, f"cp2 {name} rank {rank['rank']} "
                                       f"({steps} steps)")
            for k, v in rank["launches"].items():
                summed[k] = summed.get(k, 0) + v
        per_step = [{k: v // steps for k, v in w.items()} for w in want]
        ranks = "; ".join(_rank_hops(r) for r in res["ranks"])
        log(f"cp_train {name}: {res['steps']} steps of b{CP_B} x t{CP_T} "
            f"bf16 at {layers} layers, cp {res['cp']} ({res['cp_impl']}, {res['cp_layout']}) over "
            f"{res['dist_backend']} on {res['cards']} card(s): losses "
            f"{[round(x, 4) for x in losses]}; step p50 "
            f"{res['step_ms_p50']:.3f} ms, {res['tokens_per_sec']:.1f} "
            f"tok/s, MFU {res['mfu']:.4f}; {ranks}; launches per rank per "
            f"step {per_step} (checked against the schedule)")
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"cp2 {name}: losses not finite or not "
                                 f"{steps}")
        out[name] = summed
        if name == "zigzag":
            out["summary"] = res
            # an untrained model's mean CE over a b8 batch's ~5k valid tokens
            # varies by ~0.01 from batch to batch: a drop of 0.1 is learning
            if not sum(losses[-3:]) / 3 <= sum(losses[:3]) / 3 - 0.1:
                raise AssertionError(f"cp2 zigzag loss did not fall: {losses}")
            resumed = train.main(base + CP2 + flags + [
                "--max_steps", str(steps + 2), "--save_dir", save, "--resume"])
            log(f"cp_train zigzag --resume: started at step "
                f"{resumed['start_step']}, ran to {resumed['steps']}, losses "
                f"{resumed['losses']}")
            if (resumed["start_step"] != steps
                    or resumed["steps"] != steps + 2
                    or not all(math.isfinite(x) for x in resumed["losses"])):
                raise AssertionError("cp2 resume did not continue from the "
                                     "checkpoint")
    spread = max(first.values()) - min(first.values())
    log(f"cp_train: step-1 losses on the same batch {first}: spread "
        f"{spread:.3e} (limit 1e-2 absolute)")
    if not spread <= 1e-2:
        raise AssertionError("cp=2 step-1 losses disagree with cp=1")
    return out


def phase_cp_tiny(torch, workdir: str) -> dict:
    """`train --model tiny --cp_size 2 --cp_impl ring`, 2 steps on the card,
    at f32 (the CLI default: block_attn.cu) and with --bf16
    (block_attn_sm90.cu): the tiny preset's head_dim is 32. Finite losses,
    each rank's launches per the ring schedule; returns the launches summed
    over ranks, by dtype."""
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    cfg = model_preset("tiny")
    b, steps = 4, 2
    base = ["--model", "tiny", "--cp_size", "2", "--cp_impl", "ring",
            "--dist_backend", "gloo", "--batch_size", str(b), "--max_steps",
            str(steps), "--warmup_steps", "1", "--log_interval", "1",
            "--device", "cuda", "--data_path", _corpus(workdir)]
    want = _cp_want(cfg.num_layers, steps, "contiguous", cfg.maxlen, b)
    out = {}
    runs = (("float32", []), ("bfloat16", ["--bf16"]))
    results = [train.main(base + flags + ["--save_dir", os.path.join(
        workdir, f"cp_tiny_{name}")]) for name, flags in runs]
    for (name, _), res in zip(runs, results):
        summed = {}
        for rank, w in zip(res["ranks"], want):
            _only(rank["launches"], w, f"cp_tiny {name} rank {rank['rank']}")
            for k, v in rank["launches"].items():
                summed[k] = summed.get(k, 0) + v
        log(f"cp_tiny {name}: tiny preset (head_dim {cfg.head_dim}), cp 2 "
            f"ring over gloo on the card, b{b} x t{cfg.maxlen}: losses "
            f"{res['losses']}; block launches summed over ranks "
            f"{ {k: v for k, v in summed.items() if v} } (checked per rank "
            f"against the schedule)")
        if len(res["losses"]) != steps or not all(
                math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"cp_tiny {name}: losses not finite or not "
                                 f"{steps}")
        out[name] = summed
    return out


def phase_cp_card_vs_cpu(torch) -> None:
    """cp=2 zigzag at the 45m widths, 2 layers, f32, b 2 x t 256: the block
    kernels on the card against the plain versions on the CPU, one gloo
    group, the same weights and batch."""
    import dataclasses
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        IGNORE_INDEX, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        cp_checks, launch)
    cfg = model_preset("45m", num_layers=2, compute_dtype="float32")
    sd = Transformer(cfg).init_weights(seed=7).state_dict()
    rng = np.random.default_rng(7)
    b, t = 2, 256
    ids = rng.integers(3, cfg.vocab_size, size=(b, t + 1))
    tgt = ids[:, 1:].copy()
    tgt[1, 180:] = IGNORE_INDEX                 # a padded tail, one chunk
    run = dict(impl="ring", layout="zigzag",
               batch=(ids[:, :-1], tgt, np.tile(np.arange(t), (b, 1))))
    res = launch.spawn(cp_checks.model_runs, 2, dataclasses.asdict(cfg), sd,
                       [run], ("cuda", "cpu"), "gloo")
    card, cpu = res[0]
    rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    worst, worst_key = 0.0, None
    for k, g in cpu["grads"].items():
        ratio = float(np.abs(card["grads"][k] - g).max() / np.abs(g).max())
        if ratio > worst:
            worst, worst_key = ratio, k
    log(f"cp card vs cpu: 45m widths, 2 layers, f32, b{b} x t{t}, cp=2 "
        f"zigzag: loss {card['loss']:.7f} (card, kernels) vs "
        f"{cpu['loss']:.7f} (cpu, plain), rel diff {rel:.3e} (tol 1e-5); "
        f"worst grad leaf {worst_key}: max abs diff {worst:.3e} of its max "
        f"|grad| (tol 1e-5)")
    if not (rel <= 1e-5 and worst <= 1e-5):
        raise AssertionError("cp=2 on the card and on the CPU disagree")


def _cp_profile_rank(rank: int, nprocs: int, init_method: str) -> dict:
    """One rank of the profiled cp=2 zigzag step (runtime/launch.spawn)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, OptimizerConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.ops import collectives
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
    from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
        init_adam_state)
    from distributed_pytorch_from_scratch_tpu_torch.training.train_step import (
        build_train_step)
    mesh = make_mesh(MeshConfig(cp=nprocs), device="cuda", rank=rank,
                     backend="gloo", init_method=init_method)
    cfg = model_preset("45m", compute_dtype="bfloat16")
    model = Transformer(cfg, remat=True, cp_size=nprocs, cp_layout="zigzag",
                        mesh=mesh).init_weights(seed=2).to(mesh.device)
    step = build_train_step(model, OptimizerConfig(lr=1e-4))
    state = init_adam_state(dict(model.named_parameters()))
    b, t = 8, 1000
    rng = np.random.default_rng(2)
    ids, pos = (torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)
                for x in model.cp_shard(rng.integers(3, cfg.vocab_size, (b, t)),
                                        np.tile(np.arange(t), (b, 1))))
    for _ in range(2):
        _, _, state = step(state, ids, ids, pos)
    torch.cuda.synchronize()
    dist.barrier()
    collectives.reset_stats()
    t0 = time.perf_counter()
    _, _, state = step(state, ids, ids, pos)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    hops = collectives.total_stats()
    dist.barrier()

    def one_step():
        nonlocal state
        _, _, state = step(state, ids, ids, pos)

    def every_rank(seen: bool) -> bool:
        # a rank that profiles again runs the step's collectives again: the
        # other rank must too
        flag = torch.tensor([int(seen)])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    k2 = BLOCK_SM90_KERNELS   # the bf16 route's; the SIMT ones are f32's
    busy, n, copies, by_name = 0.0, 0, 0, {}
    for name, us in _profiled(torch, one_step, f"cp profile, rank {rank}",
                              every_rank):
        busy += us
        n += 1
        if any(k in name for k in BLOCK_SIMT_KERNELS):
            raise AssertionError(f"the bf16 cp step ran a SIMT block kernel: "
                                 f"{name}")
        # the staged hops' copies to and from the host are device events
        # too: counted apart from the kernels
        key = ("copies" if "memcpy" in name.lower() else
               next((k for k in k2 if k in name), "other"))
        by_name[key] = by_name.get(key, 0.0) + us
        copies += key == "copies"
    return {"rank": rank, "wall_ms": wall_ms, "busy_ms": busy / 1e3,
            "events": n, "copies": copies,
            "copy_ms": by_name.get("copies", 0.0) / 1e3,
            "k2_ms": {k: by_name.get(k, 0.0) / 1e3 for k in k2},
            "hops": hops}


def phase_cp_profile(torch) -> dict:
    from distributed_pytorch_from_scratch_tpu_torch.runtime import launch
    ranks = launch.spawn(_cp_profile_rank, 2)
    r0 = ranks[0]
    card_busy = sum(r["busy_ms"] for r in ranks)
    kern = lambda r: r["busy_ms"] - r["copy_ms"]
    k2 = sum(r0["k2_ms"].values())
    hop = r0["hops"]
    log(f"cp profile (45m bf16, cp=2 zigzag over gloo on one card, b8 x "
        f"t1000, remat), rank 0's step: wall {r0['wall_ms']:.3f} ms, device "
        f"busy {r0['busy_ms']:.3f} ms over {r0['events']} events: kernels "
        f"{kern(r0):.3f} ms ({r0['events'] - r0['copies']}), the hops' "
        f"copies to and from the host {r0['copy_ms']:.3f} ms "
        f"({r0['copies']}) (rank 1: kernels {kern(ranks[1]):.3f} ms, copies "
        f"{ranks[1]['copy_ms']:.3f} ms); the card's idle share 1 - (both "
        f"ranks' busy) / wall {1 - card_busy / r0['wall_ms']:.3f} (rank 0's "
        f"alone {1 - r0['busy_ms'] / r0['wall_ms']:.3f}); K2 kernels "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in r0["k2_ms"].items())
        + f" ({k2 / kern(r0):.3f} of rank 0's kernel time); ring hops "
        f"{hop['calls']} calls, {hop['bytes'] / 1e9:.3f} GB: wait for the "
        f"device {hop['wait_s'] * 1e3:.3f} ms + staged copies and transfer "
        f"{hop['hop_s'] * 1e3:.3f} ms ({hop['hop_s'] * 1e3 / r0['wall_ms']:.3f}"
        f" of the wall)")
    return {"ranks": ranks}


# the tp=2 cell-to-be: the 45m preset at b 8 x t 1000 bf16 with remat, the
# ranks sharing the one card over gloo, the cp cell's flags and corpus
TP2 = ["--tp_size", "2", "--dist_backend", "gloo"]
TP_RUNS = {  # name: (flags, steps; tp2 as CP_RUNS' zigzag); tp=2 with
    # --sequence_parallel is phase 58's `off` run
    "tp2": ([], 4),
    "tp2_dp2": (["--dp_size", "2"], 2),
}


def _flash_want(layers: int, steps: int, forwards: int = 2) -> dict:
    """A rank's flash launches over `steps`: the forward `forwards` times
    per layer (2 under remat true, 1 where (o, lse) are kept)."""
    return {"flash_attention_fwd": forwards * layers * steps,
            "flash_attention_bwd_dq": layers * steps,
            "flash_attention_bwd_dkv": layers * steps}


def _rank_hops(r: dict) -> str:
    """One rank's summary line: coordinates, peak memory, and its hops per
    axis."""
    axes = "; ".join(
        f"{a}: {s['calls']} calls, {s['bytes'] / 1e9:.3f} GB, wait "
        f"{s['wait_s']:.3f} s + hop {s['hop_s']:.3f} s"
        for a, s in r["collectives"].items() if s["calls"])
    hop = sum(s["hop_s"] for s in r["collectives"].values())
    return (f"rank {r['rank']} (dp {r['dp']}, cp {r['cp']}, ep "
            f"{r.get('ep', 0)}, tp {r['tp']}): "
            f"peak {r['peak_mem_gib']:.3f} GiB, {axes} of {r['wall_s']:.3f} "
            f"s wall (hop share {hop / r['wall_s']:.3f})")


def phase_tp_train(torch, workdir: str) -> dict:
    """train.main at tp=2 (4 steps, a checkpoint and a 2-step --resume),
    tp 2 x dp 2 (2 steps), the tp checkpoint resumed at tp=1 (1 step), and
    a tp=1 step on the same first batch; returns each tp run's launches
    summed over ranks and the tp=2 run's summary."""
    import glob
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    data = _corpus(workdir)
    layers = CP_LAYERS
    base = CP_ARGS + ["--num_layers", str(layers), "--data_path", data]
    first = {"tp1": _one_step_loss(workdir)}
    out = {}
    for name, (flags, steps) in TP_RUNS.items():
        save = os.path.join(workdir, name)
        res = train.main(base + TP2 + flags + ["--max_steps", str(steps),
                                               "--save_dir", save])
        losses = res["losses"]
        first[name] = losses[0]
        summed = {}
        for rank in res["ranks"]:
            _only(rank["launches"], _flash_want(layers, steps),
                  f"{name} rank {rank['rank']} ({steps} steps)")
            for k, v in rank["launches"].items():
                summed[k] = summed.get(k, 0) + v
        log(f"tp_train {name}: {res['steps']} steps of b{CP_B} x t{CP_T} "
            f"bf16 at {layers} layers, dp {res['dp']} x cp {res['cp']} x tp {res['tp']} "
            f"(sequence_parallel={res['sequence_parallel']}) over "
            f"{res['dist_backend']} on {res['cards']} card(s): losses "
            f"{[round(x, 4) for x in losses]}; step p50 "
            f"{res['step_ms_p50']:.3f} ms, {res['tokens_per_sec']:.1f} tok/s,"
            f" MFU {res['mfu']:.4f} (per card); "
            + "; ".join(_rank_hops(r) for r in res["ranks"])
            + f"; flash launches per rank per step fwd {2 * layers}, dq "
            f"{layers}, dk/dv {layers} (checked)")
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: losses not finite or not {steps}")
        out[name] = summed
        if name != "tp2":
            continue
        out["summary"] = res
        # as cp_train's: a drop of 0.1 over a b8 batch's ~5k tokens is
        # learning, not noise
        if not sum(losses[-3:]) / 3 <= sum(losses[:3]) / 3 - 0.1:
            raise AssertionError(f"tp2 loss did not fall: {losses}")
        files = sorted(glob.glob(os.path.join(save, f"tprank-*_iter-{steps}_"
                                                    f"loss-*.npz")))
        log(f"tp_train tp2 checkpoint: {[os.path.basename(f) for f in files]}")
        if [os.path.basename(f).split("_")[0] for f in files] != [
                "tprank-0", "tprank-1"]:
            raise AssertionError("tp2 did not write one file per tp rank")
        resumed = train.main(base + TP2 + ["--max_steps", str(steps + 2),
                                           "--save_dir", save, "--resume"])
        log(f"tp_train tp2 --resume: started at step "
            f"{resumed['start_step']}, ran to {resumed['steps']}, losses "
            f"{resumed['losses']}")
        if (resumed["start_step"] != steps or resumed["steps"] != steps + 2
                or not all(math.isfinite(x) for x in resumed["losses"])):
            raise AssertionError("tp2 resume did not continue from the "
                                 "checkpoint")
        at_tp1 = train.main(base + ["--max_steps", str(steps + 3),
                                    "--save_dir", save, "--resume"])
        log(f"tp_train: the tp2 checkpoint resumed at tp=1 from step "
            f"{at_tp1['start_step']}: losses {at_tp1['losses']}")
        if (at_tp1["start_step"] != steps + 2
                or not all(math.isfinite(x) for x in at_tp1["losses"])):
            raise AssertionError("the tp2 checkpoint did not resume at tp=1")
    spread = max(first.values()) - min(first.values())
    log(f"tp_train: step-1 losses on the same batch {first}: spread "
        f"{spread:.3e} (limit 1e-2 absolute)")
    if not spread <= 1e-2:
        raise AssertionError("tp step-1 losses disagree with tp=1")
    return out


def phase_tp_tiny(torch, workdir: str) -> dict:
    """`train --model tiny --tp_size 2 --cp_size 2 --cp_impl ring`, four
    ranks, 2 steps on the card at f32 (block_attn.cu) and with --bf16
    (block_attn_sm90.cu): head_dim 32 with 2 local heads. Finite losses,
    each rank's block launches per the ring schedule of its cp index;
    returns the launches summed over ranks, by dtype."""
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    cfg = model_preset("tiny")
    b, steps = 4, 2
    base = ["--model", "tiny", "--tp_size", "2", "--cp_size", "2",
            "--cp_impl", "ring", "--dist_backend", "gloo", "--batch_size",
            str(b), "--max_steps", str(steps), "--warmup_steps", "1",
            "--log_interval", "1", "--device", "cuda", "--data_path",
            _corpus(workdir)]
    want = _cp_want(cfg.num_layers, steps, "contiguous", cfg.maxlen, b)
    out = {}
    runs = (("float32", []), ("bfloat16", ["--bf16"]))
    results = [train.main(base + flags + ["--save_dir", os.path.join(
        workdir, f"tp_tiny_{name}")]) for name, flags in runs]
    for (name, _), res in zip(runs, results):
        summed = {}
        for rank in res["ranks"]:
            _only(rank["launches"], want[rank["cp"]],
                  f"tp_tiny {name} rank {rank['rank']} (cp {rank['cp']})")
            for k, v in rank["launches"].items():
                summed[k] = summed.get(k, 0) + v
        log(f"tp_tiny {name}: tiny preset (head_dim {cfg.head_dim}, "
            f"{cfg.num_heads // 2} local heads), tp 2 x cp 2 ring over gloo "
            f"on the card, b{b} x t{cfg.maxlen}: losses {res['losses']}; "
            f"block launches summed over ranks "
            f"{ {k: v for k, v in summed.items() if v} } (checked per rank "
            f"against its cp index's schedule)")
        if len(res["losses"]) != steps or not all(
                math.isfinite(x) for x in res["losses"]):
            raise AssertionError(f"tp_tiny {name}: losses not finite or not "
                                 f"{steps}")
        out[name] = summed
    return out


def phase_tp_card_vs_cpu(torch) -> None:
    """tp=2 with sequence parallelism at the 45m widths, 2 layers, f32, b 2
    x t 256: the loss and every rank's gradient shard, the kernels on the
    card against the plain versions on the CPU, one gloo group, the same
    weights and batch."""
    import dataclasses
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        IGNORE_INDEX, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.interop import (
        params_to_jax)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        launch, tp_checks)
    cfg = model_preset("45m", num_layers=2, compute_dtype="float32")
    tree = params_to_jax(Transformer(cfg).init_weights(seed=8).state_dict())
    rng = np.random.default_rng(8)
    b, t = 2, 256
    ids = rng.integers(3, cfg.vocab_size, size=(b, t + 1))
    tgt = ids[:, 1:].copy()
    tgt[1, 180:] = IGNORE_INDEX                 # a padded tail
    run = dict(sp=True, batch=(ids[:, :-1], tgt, np.tile(np.arange(t),
                                                         (b, 1))))
    todo = [("model_runs", {"tp": 2},
             dict(cfg=dataclasses.asdict(cfg), tree=tree, runs=[run]))]
    res = launch.spawn(tp_checks.jobs, 2, todo, ("cuda", "cpu"), "gloo")
    worst, worst_key, rel = 0.0, None, 0.0
    for r, (card, cpu) in enumerate(res):
        card, cpu = card[0], cpu[0]
        rel = max(rel, abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]))
        for k, g in cpu["grads"].items():
            ratio = float(np.abs(card["grads"][k] - g).max()
                          / max(np.abs(g).max(), 1e-30))
            if ratio > worst:
                worst, worst_key = ratio, f"rank {r} {k}"
    log(f"tp card vs cpu: 45m widths, 2 layers, f32, b{b} x t{t}, tp=2 with "
        f"sequence parallelism: loss {res[0][0][0]['loss']:.7f} (card, "
        f"kernels) vs {res[0][1][0]['loss']:.7f} (cpu, plain), worst rel "
        f"diff over ranks {rel:.3e} (tol 1e-5); worst grad shard {worst_key}:"
        f" max abs diff {worst:.3e} of its max |grad| (tol 1e-5)")
    if not (rel <= 1e-5 and worst <= 1e-5):
        raise AssertionError("tp=2 on the card and on the CPU disagree")


def _tp_profile_rank(rank: int, nprocs: int, init_method: str) -> dict:
    """One rank of the profiled tp=2 step (runtime/launch.spawn)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, OptimizerConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.ops import collectives
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
    from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
        init_adam_state)
    from distributed_pytorch_from_scratch_tpu_torch.training.train_step import (
        build_train_step)
    mesh = make_mesh(MeshConfig(tp=nprocs), device="cuda", rank=rank,
                     backend="gloo", init_method=init_method)
    cfg = model_preset("45m", compute_dtype="bfloat16")
    model = Transformer(cfg, remat=True, mesh=mesh).init_weights(
        seed=2).to(mesh.device)
    step = build_train_step(model, OptimizerConfig(lr=1e-4))
    state = init_adam_state(dict(model.named_parameters()))
    b, t = CP_B, CP_T
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, t))).to(
        mesh.device)
    pos = torch.arange(t, device=mesh.device).expand(b, t)
    for _ in range(2):
        _, _, state = step(state, ids, ids, pos)
    torch.cuda.synchronize()
    dist.barrier()
    collectives.reset_stats()
    t0 = time.perf_counter()
    _, _, state = step(state, ids, ids, pos)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    hops = dict(collectives.stats["tp"])
    dist.barrier()

    def one_step():
        nonlocal state
        _, _, state = step(state, ids, ids, pos)

    def every_rank(seen: bool) -> bool:
        # a rank that profiles again runs the step's collectives again: the
        # other rank must too
        flag = torch.tensor([int(seen)])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    simt = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    busy, n, by_name, counts = 0.0, 0, {}, {}
    for name, us in _profiled(torch, one_step, f"tp profile, rank {rank}",
                              every_rank):
        busy += us
        n += 1
        if any(k in name for k in simt):
            raise AssertionError(f"the bf16 tp step ran a SIMT flash kernel: "
                                 f"{name}")
        # the staged hops' copies to and from the host are device events
        # too: counted apart from the kernels
        key = ("copies" if "memcpy" in name.lower() else
               next((k for k in SM90_KERNELS if k in name), "other"))
        by_name[key] = by_name.get(key, 0.0) + us
        counts[key] = counts.get(key, 0) + 1
    layers = cfg.num_layers
    want = {SM90_KERNELS[0]: 2 * layers, SM90_KERNELS[1]: layers,
            SM90_KERNELS[2]: layers}
    if {k: counts.get(k, 0) for k in SM90_KERNELS} != want:
        raise AssertionError(f"tp profile rank {rank}: flash kernels "
                             f"{ {k: counts.get(k, 0) for k in SM90_KERNELS} }"
                             f", expected {want}")
    return {"rank": rank, "wall_ms": wall_ms, "busy_ms": busy / 1e3,
            "events": n, "copies": counts.get("copies", 0),
            "copy_ms": by_name.get("copies", 0.0) / 1e3,
            "flash_ms": sum(by_name.get(k, 0.0) for k in SM90_KERNELS) / 1e3,
            "hops": hops}


def phase_tp_profile(torch) -> dict:
    from distributed_pytorch_from_scratch_tpu_torch.runtime import launch
    ranks = launch.spawn(_tp_profile_rank, 2)
    r0 = ranks[0]
    kern = lambda r: r["busy_ms"] - r["copy_ms"]
    card_busy = sum(r["busy_ms"] for r in ranks)
    hop = r0["hops"]
    log(f"tp profile (45m bf16, tp=2 over gloo on one card, b{CP_B} x "
        f"t{CP_T}, remat), rank 0's step: wall {r0['wall_ms']:.3f} ms, "
        f"device busy {r0['busy_ms']:.3f} ms over {r0['events']} events: "
        f"kernels {kern(r0):.3f} ms ({r0['events'] - r0['copies']}), the "
        f"hops' copies to and from the host {r0['copy_ms']:.3f} ms "
        f"({r0['copies']}) (rank 1: kernels {kern(ranks[1]):.3f} ms, copies "
        f"{ranks[1]['copy_ms']:.3f} ms); the card's idle share 1 - (both "
        f"ranks' busy) / wall {1 - card_busy / r0['wall_ms']:.3f} (rank 0's "
        f"alone {1 - r0['busy_ms'] / r0['wall_ms']:.3f}); flash kernels "
        f"{r0['flash_ms']:.3f} ms ({r0['flash_ms'] / kern(r0):.3f} of rank "
        f"0's kernel time); tp hops {hop['calls']} calls, "
        f"{hop['bytes'] / 1e9:.3f} GB: wait for the device "
        f"{hop['wait_s'] * 1e3:.3f} ms + staged copies and transfer "
        f"{hop['hop_s'] * 1e3:.3f} ms ({hop['hop_s'] * 1e3 / r0['wall_ms']:.3f}"
        f" of the wall)")
    return {"ranks": ranks}

# ---- slice 11: serving at tp > 1 ----

# the tp=2 serve runs: the 45m preset, bf16, two ranks sharing the one card
# over gloo. The slot engine takes a burst of 4 prompts of 64-512 tokens;
# the paged engine 4 behind a 96-token shared prefix (it ends mid-page, so
# sharers copy that page: COW) on the default pool, slots x pages per
# slot, so no request is preempted; then the same with int8 pages. 16 new
# tokens each (8 requests of 32 until the speculative phases needed the
# room)
TP_SERVE_BASE = ["--model", "45m", "--random_init", "--vocab_size", "1024",
                 "--tp_size", "2", "--dist_backend", "gloo",
                 "--num_requests", "4", "--arrival", "burst",
                 "--prompt_len_min", "64", "--prompt_len_max", "512",
                 "--max_new_tokens", "16", "--slots", "8"]
TP_SERVE_RUNS = {  # name: flags
    "serve_tp2": ["--max_prefill_batch", "4"],
    "serve_paged_tp2": ["--paged", "--page_size", "64", "--prefill_chunk",
                        "128", "--shared_prefix_len", "96"],
    "serve_paged_tp2_int8": ["--paged", "--page_size", "64",
                             "--prefill_chunk", "128", "--shared_prefix_len",
                             "96", "--kv_dtype", "int8"],
}


def _check_tp_serve_rank(name, r, layers) -> None:
    """One rank of a tp=2 serve run: its kernels per dispatch, its tp hops
    per dispatch (the dispatch broadcasts apart), no SIMT route."""
    d = r["dispatches"]
    model_dispatches = sum(n for k, n in d.items() if k != "cow_copy")
    what = f"{name} rank {r['rank']}"
    if r["tp_hops"]["calls"] != (2 * layers + 2) * model_dispatches:
        raise AssertionError(
            f"{what}: {r['tp_hops']['calls']} tp hops over "
            f"{model_dispatches} dispatches, expected {2 * layers + 2} each "
            f"(wo and down_proj all-reduces, the embedding's, the logits "
            f"gather)")
    if name == "serve_tp2":
        _only(r["launches"], {"flash_attention_fwd":
                              layers * d["slot_prefill"]},
              f"{what} ({layers} per prefill dispatch)")
        return
    one = sum(n for kind, shape, n in r["dispatch_shapes"]
              if kind == "paged_chunk" and shape[0] == 1)
    chunks = d["paged_chunk"]
    _only(r["launches"], {"paged_attention": layers * (d["paged_decode"]
                                                      + chunks)},
          f"{what} ({layers} x (decode steps + chunks))")
    # a one-position chunk is decode-shaped: the decode kernel takes it
    want = {"paged_decode": layers * (d["paged_decode"] + one),
            "paged_chunk_sm90": layers * (chunks - one), "paged_attn": 0}
    if r["paged_launches_by_kernel"] != want:
        raise AssertionError(f"{what}: paged launches by kernel "
                             f"{r['paged_launches_by_kernel']}, expected "
                             f"{want} (no SIMT route)")


def phase_tp_serve(torch) -> dict:
    """The serve CLI at tp=2 over gloo on the one card, the slot engine and
    the paged engine (bf16 and int8 pages): every request served with in-vocab
    tokens, both ranks in lockstep, K1 forward 12 times per prefill
    dispatch and K3 12 times per decode step (decode kernel) and per chunk
    (the wgmma chunk kernel above one position) on each rank, 2L + 2 tp
    hops per dispatch. Returns each run's launches summed over the ranks and
    its summary."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    layers = model_preset("45m").num_layers
    res = {}
    outs = [serve.main(TP_SERVE_BASE + f) for f in TP_SERVE_RUNS.values()]
    for name, out in zip(TP_SERVE_RUNS, outs):
        ranks, st = out["ranks"], out["engine_stats"]
        if out["completed"] != out["requests"]:
            raise AssertionError(f"{name}: served {out['completed']} of "
                                 f"{out['requests']} requests")
        toks = [t for ts in out["outputs"].values() for t in ts]
        if not toks or not all(0 <= t < 1024 for t in toks):
            raise AssertionError(f"{name}: tokens missing or outside the "
                                 f"vocab")
        if not all(r["dispatches"] == ranks[0]["dispatches"] and
                   r["dispatch_shapes"] == ranks[0]["dispatch_shapes"]
                   for r in ranks):
            raise AssertionError(f"{name}: the ranks ran different "
                                 f"dispatches: "
                                 f"{[r['dispatches'] for r in ranks]}")
        for r in ranks:
            _check_tp_serve_rank(name, r, layers)
        if "paged" in name and (st["cow_copies"] <= 0 or st["preemptions"]
                                or st["prefix_hit_tokens"] <= 0
                                or st["pages_in_use"]):
            raise AssertionError(f"{name}: COW copies {st['cow_copies']}, "
                                 f"preemptions {st['preemptions']}, prefix "
                                 f"hits {st['prefix_hit_tokens']}, pages in "
                                 f"use {st['pages_in_use']}")
        summed = {}
        for r in ranks:
            for k, v in list(r["launches"].items()) + [
                    (f"paged_{k}", v) for k, v in
                    r["paged_launches_by_kernel"].items()]:
                summed[k] = summed.get(k, 0) + v
        d = ranks[0]["dispatches"]
        hops = ranks[0]["tp_hops"]
        host_s = hops["wait_s"] + hops["hop_s"]
        bc = ranks[0]["dispatch_broadcasts"]
        model_dispatches = sum(n for k, n in d.items() if k != "cow_copy")
        log(f"tp_serve {name} (45m bf16, tp=2 over gloo on one card): "
            f"{out['completed']}/{out['requests']} requests, "
            f"{out['generated_tokens']} tokens in {out['wall_s']} s -> "
            f"{out['tokens_per_sec']} tok/s; TTFT p50/p95 "
            f"{out['ttft_ms_p50']}/{out['ttft_ms_p95']} ms; TPOT p50/p95 "
            f"{out['tpot_ms_p50']}/{out['tpot_ms_p95']} ms; dispatches per "
            f"rank {d} (lockstep checked); tp hops per dispatch "
            f"{hops['calls'] / model_dispatches:.1f} (= 2 x {layers} + 2, "
            f"checked), rank 0 {hops['calls']} hops, "
            f"{hops['bytes'] / max(hops['calls'], 1) / 1e3:.3f} KB each on "
            f"average, host {host_s:.3f} s (wait {hops['wait_s']:.3f}"
            f" + hop {hops['hop_s']:.3f}) = "
            f"{host_s / max(hops['calls'], 1) * 1e3:.3f} ms per hop, "
            f"{host_s / ranks[0]['wall_s']:.3f} of rank 0's "
            f"{ranks[0]['wall_s']:.3f} s; dispatch broadcasts "
            f"{bc['calls']} calls, {bc['bytes']} bytes, host "
            f"{bc['hop_s'] * 1e3:.3f} ms; "
            + ("" if "paged" not in name else
               f"COW copies {st['cow_copies']}, prefix hit tokens "
               f"{st['prefix_hit_tokens']}, preemptions "
               f"{st['preemptions']}; ")
            + f"kernel launches summed over ranks "
            f"{ {k: v for k, v in summed.items() if v} }")
        res[name] = {"launches": summed, "summary": out}
    return res


def _tp_serve_cases(cfg, seed: int) -> list:
    """serve_runs' runs for the card-vs-CPU check: 4 requests of 64-200
    tokens (the paged ones behind a 96-token shared prefix), 16 new tokens,
    through each engine."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [64, 200, 131, 97]
    prompts = [[int(x) for x in rng.integers(3, cfg.vocab_size, n)]
               for n in lens]
    prefix = [int(x) for x in rng.integers(3, cfg.vocab_size, 96)]
    req = lambda ps: [(p, 16, "default", None) for p in ps]
    buf = 96 + max(lens) + 18
    return [dict(engine="slot", kw=dict(num_slots=4, buf_len=buf, eos_id=1,
                                        prefill_bucket=64,
                                        max_prefill_batch=2),
                 requests=req(prompts), stagger=1, tick=0.02),
            dict(engine="paged", kw=dict(num_slots=4, buf_len=buf, eos_id=1,
                                         page_size=64, prefill_chunk=128),
                 requests=req([prefix + p for p in prompts]), stagger=1,
                 tick=0.02)]


def phase_tp_serve_card_vs_cpu(torch) -> None:
    """The 45m widths at 2 layers, f32: both engines at tp=2 on the card
    (one gloo group) give the greedy tokens of tp=1 on the card and of tp=1
    on the CPU's plain path, and the first prefill's gathered logits are
    within 1e-4 of tp=1's on the card (of the largest |logit|, at least
    1)."""
    import dataclasses
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.interop import (
        params_to_jax)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        launch, tp_checks)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
    cfg = model_preset("45m", num_layers=2, compute_dtype="float32")
    tree = params_to_jax(Transformer(cfg).init_weights(seed=9).state_dict())
    runs = _tp_serve_cases(cfg, 9)
    rng = np.random.default_rng(9)
    buf = np.ones((2, 256), np.int32)              # EOS-padded, one bucket
    buf[0, :200] = rng.integers(3, cfg.vocab_size, 200)
    buf[1, :117] = rng.integers(3, cfg.vocab_size, 117)
    calls = [dict(kind="prefill", args=(buf, np.array([200, 117], np.int32)),
                  page_size=None)]
    kw = dict(cfg=dataclasses.asdict(cfg), tree=tree)
    todo = [("serve_runs", {"tp": 2}, dict(kw, runs=runs)),
            ("decode_logits", {"tp": 2}, dict(kw, calls=calls))]
    tp2 = launch.spawn(tp_checks.jobs, 2, todo, ("cuda",), "gloo")
    one = {}
    for dev in ("cuda", "cpu"):
        mesh = make_mesh(MeshConfig(), device=dev)
        one[dev] = (tp_checks.serve_runs(mesh, kw["cfg"], tree, runs),
                    tp_checks.decode_logits(mesh, kw["cfg"], tree, calls))
    for i, run in enumerate(runs):
        toks = tp2[0][0][i]["tokens"]
        same = {dev: sum(toks[r] == one[dev][0][i]["tokens"][r]
                         for r in toks) for dev in one}
        log(f"tp serve card vs cpu ({run['engine']} engine, 45m widths, 2 "
            f"layers, f32, {len(toks)} requests x 16 new tokens): tp=2 on "
            f"the card token-identical to tp=1 on the card for "
            f"{same['cuda']}, to tp=1 on the CPU for {same['cpu']} of "
            f"{len(toks)} requests; rank dispatches "
            f"{tp2[0][0][i]['dispatches']} / {tp2[1][0][i]['dispatches']}")
        if not (toks == one["cuda"][0][i]["tokens"] ==
                one["cpu"][0][i]["tokens"]):
            raise AssertionError(f"tp=2 {run['engine']} tokens differ from "
                                 f"tp=1's")
        if tp2[0][0][i]["dispatches"] != tp2[1][0][i]["dispatches"]:
            raise AssertionError("the tp=2 ranks ran different dispatches")
    lg2, lg1, lgc = tp2[0][1][0], one["cuda"][1][0], one["cpu"][1][0]
    scale = max(1.0, float(np.abs(lg1).max()))
    diff = float(np.abs(lg2 - lg1).max())
    log(f"tp serve card vs cpu: the first prefill's gathered logits (2 "
        f"prompts, 200 and 117 tokens) at tp=2 vs tp=1 on the card: max abs "
        f"diff {diff:.3e} (limit 1e-4 x {scale:.3f}); tp=1 card vs cpu "
        f"{float(np.abs(lg1 - lgc).max()):.3e}; the ranks' gathered logits "
        f"equal: {bool(np.array_equal(tp2[0][1][0], tp2[1][1][0]))}")
    if not (diff <= 1e-4 * scale
            and np.array_equal(tp2[0][1][0], tp2[1][1][0])):
        raise AssertionError("tp=2 prefill logits disagree with tp=1's")


def _tp_serve_profile_rank(rank: int, nprocs: int, init_method: str) -> dict:
    """One rank of the profiled tp=2 decode steps (runtime/launch.spawn):
    each engine at the 45m bf16 preset with 8 live requests, then one
    timed decode step and one under torch.profiler."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.ops import collectives
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        ContinuousBatchingEngine, PagedEngine, Request)
    mesh = make_mesh(MeshConfig(tp=nprocs), device="cuda", rank=rank,
                     backend="gloo", init_method=init_method)
    cfg = model_preset("45m", compute_dtype="bfloat16")
    model = Transformer(cfg, mesh=mesh).init_weights(seed=1).to(mesh.device)
    rng = np.random.default_rng(1)

    def every_rank(seen: bool) -> bool:
        flag = torch.tensor([int(seen)])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    out = {"rank": rank}
    for kind, plen in (("slot", 512), ("paged", 128)):
        # eos_id = vocab_size: never picked, so every request stays live
        if kind == "slot":
            eng = ContinuousBatchingEngine(
                model, mesh, num_slots=8, buf_len=plen + 64,
                eos_id=cfg.vocab_size, max_prefill_batch=4)
        else:
            eng = PagedEngine(model, mesh, num_slots=8, buf_len=plen + 64,
                              eos_id=cfg.vocab_size, page_size=64,
                              prefill_chunk=128)
        leader = eng.dispatch.leader
        if leader:
            for i in range(8):
                eng.submit(Request(rid=i, prompt=[int(x) for x in rng.integers(
                    3, cfg.vocab_size, plen)], max_new=40))
            while eng.scheduler.pending or getattr(eng, "_prefilling", {}):
                eng.step()
            for _ in range(3):
                eng.step()
            eng.dispatch.stop()
        else:
            eng.dispatch.serve()
        # from here on a leader's step is one decode dispatch
        one_step = eng.step if leader else (lambda: eng.dispatch.serve(1))
        torch.cuda.synchronize()
        dist.barrier()
        collectives.reset_stats()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        hops = dict(collectives.stats["tp"])
        bcast = dict(collectives.stats["dispatch"])
        dist.barrier()
        busy = copy = 0.0
        n = n_copy = 0
        counts = {}
        for name, us in _profiled(torch, one_step,
                                  f"tp serve profile {kind}, rank {rank}",
                                  every_rank):
            busy += us
            n += 1
            if "memcpy" in name.lower():
                copy += us
                n_copy += 1
            for k in (PAGED_KERNELS["decode"], PAGED_KERNELS["chunk"],
                      PAGED_SIMT_KERNEL) + SM90_KERNELS:
                if k in name:
                    counts[k] = counts.get(k, 0) + 1
        want = ({PAGED_KERNELS["decode"]: cfg.num_layers} if kind == "paged"
                else {})
        if counts != want:
            raise AssertionError(f"tp serve profile {kind} rank {rank}: a "
                                 f"decode step ran attention kernels "
                                 f"{counts}, expected {want}")
        out[kind] = {"wall_ms": wall_ms, "busy_ms": busy / 1e3,
                     "events": n, "copy_ms": copy / 1e3, "copies": n_copy,
                     "hops": hops, "bcast": bcast, "attn": counts}
    return out


def phase_tp_serve_profile(torch) -> dict:
    """One tp=2 decode step of each engine (45m bf16, 8 live requests)
    under torch.profiler in each rank: wall, device busy (kernels apart
    from the hops' copies), the tp hops' host time and the card's idle
    share."""
    from distributed_pytorch_from_scratch_tpu_torch.runtime import launch
    ranks = launch.spawn(_tp_serve_profile_rank, 2)
    for kind in ("slot", "paged"):
        r0, r1 = ranks[0][kind], ranks[1][kind]
        kern = lambda r: r["busy_ms"] - r["copy_ms"]
        hop = r0["hops"]
        log(f"tp serve profile ({kind} engine, 45m bf16, tp=2 over gloo on "
            f"one card, 8 live requests): rank 0's decode step: wall "
            f"{r0['wall_ms']:.3f} ms, device busy {r0['busy_ms']:.3f} ms "
            f"over {r0['events']} events: kernels {kern(r0):.3f} ms, the "
            f"hops' copies {r0['copy_ms']:.3f} ms ({r0['copies']}) (rank 1: "
            f"kernels {kern(r1):.3f} ms, copies {r1['copy_ms']:.3f} ms); the "
            f"card's idle share 1 - (both ranks' busy) / wall "
            f"{1 - (r0['busy_ms'] + r1['busy_ms']) / r0['wall_ms']:.3f}; tp "
            f"hops {hop['calls']} calls, {hop['bytes'] / 1e3:.3f} KB: wait "
            f"{hop['wait_s'] * 1e3:.3f} ms + staged copies and transfer "
            f"{hop['hop_s'] * 1e3:.3f} ms ("
            f"{(hop['wait_s'] + hop['hop_s']) * 1e3 / r0['wall_ms']:.3f} of "
            f"the wall, {(hop['wait_s'] + hop['hop_s']) * 1e3 / max(hop['calls'], 1):.3f}"
            f" ms per hop); dispatch broadcast {r0['bcast']['calls']} calls,"
            f" {r0['bcast']['bytes']} bytes, host "
            f"{r0['bcast']['hop_s'] * 1e3:.3f} ms; attention kernels "
            f"{r0['attn']}")
    return {"ranks": ranks}

# ---- slice 12: one dispatch per step (CUDA graphs), the remat policies ----

REMAT_STEPS = 6        # train_remat and train_spd: 6 steps of the train cell
SPD = 4                # train_spd: dispatches of 4 and 2 steps


def _replace_flag(args: list, flag: str, value: str) -> list:
    i = args.index(flag)
    return args[:i + 1] + [value] + args[i + 2:]


def _train_run(workdir: str, name: str, extra: list) -> tuple:
    """`train.main` on the train cell (45m bf16, b 32 x t 1000) for
    REMAT_STEPS steps, one checkpoint at the end under `workdir/name`;
    returns (summary, kernel launches)."""
    from distributed_pytorch_from_scratch_tpu_torch import train
    args = _replace_flag(_replace_flag(TRAIN_ARGS, "--max_steps",
                                       str(REMAT_STEPS)),
                         "--save_interval", str(REMAT_STEPS))
    _reset_launches()
    out = train.main(args + ["--data_path", _corpus(workdir), "--save_dir",
                             os.path.join(workdir, name)] + extra)
    counts = _read_launches()
    log(f"{name}: remat {out['remat']}, {out['steps']} steps at "
        f"{out['steps_per_dispatch']} per dispatch: losses "
        f"{[round(x, 6) for x in out['losses']]}; step p50 "
        f"{out['step_ms_p50']:.3f} ms, {out['tokens_per_sec']:.1f} tok/s, "
        f"MFU {out['mfu']:.4f}, peak memory {out['peak_mem_gib']:.3f} GiB; "
        f"launches {counts}")
    return out, counts


def phase_train_remat(torch, workdir: str) -> dict:
    """The train cell at --remat true, dots, false and auto, and dots at 4
    steps per dispatch: the losses of each equal true's (1e-6 relative;
    the same kernels on the same values, so bitwise is expected), and K1's
    forward launches 12 times per step where the policy keeps (o, lse)
    (dots, false), 24 where it recomputes them (true). Returns each run's
    launches."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    layers = model_preset("45m").num_layers
    runs = {p: _train_run(workdir, f"train_remat_{p}", ["--remat", p])
            for p in ("true", "dots", "false", "auto")}
    # dots with its step captured: the selective policy's dispatch mode
    # costs the host per op, a replay does not
    runs["dots_spd4"] = _train_run(workdir, "train_remat_dots_spd4",
                                   ["--remat", "dots",
                                    "--steps_per_dispatch", str(SPD)])
    ref = runs["true"][0]["losses"]
    log(f"train_remat: --remat auto picked {runs['auto'][0]['remat']!r}")
    for policy, (out, counts) in runs.items():
        picked = out["remat"]
        _only(counts, _flash_want(layers, REMAT_STEPS,
                                  2 if picked == "true" else 1),
              f"train at --remat {policy} ({picked})")
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], ref))
        log(f"train_remat {policy}: losses against true's: max relative "
            f"diff {rel:.3e} (tol 1e-6), bitwise "
            f"{out['losses'] == ref}")
        if len(out["losses"]) != REMAT_STEPS or not rel <= 1e-6:
            raise AssertionError(f"--remat {policy} trains otherwise than "
                                 f"--remat true")
    return {p: counts for p, (_, counts) in runs.items()}


def phase_train_spd(torch, workdir: str) -> dict:
    """--steps_per_dispatch 4 on the train cell for REMAT_STEPS steps
    (dispatches of 4 and 2) against 1: identical losses, identical final
    parameters and moments (max abs diff 0), identical kernel launches; the
    Adam update from device scalars bitwise the host-scalar one on the
    card; then a profiled dispatch of 4 steps beside 4 eager steps."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        OptimizerConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.training.checkpoint import (
        load_checkpoint)
    from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
        adam_scalars, adam_update, init_adam_state)
    from distributed_pytorch_from_scratch_tpu_torch.training.train_step import (
        build_train_step, build_train_step_multi)
    cfg_layers = model_preset("45m").num_layers
    runs = {n: _train_run(workdir, f"train_spd{n}",
                          ["--steps_per_dispatch", str(n)])
            for n in (1, SPD)}
    (one, c1), (multi, cn) = runs[1], runs[SPD]
    states = {n: load_checkpoint(os.path.join(workdir, f"train_spd{n}"),
                                 REMAT_STEPS, with_opt=True)
              for n in (1, SPD)}
    (p1, o1, _), (pn, on, _) = states[1], states[SPD]
    diff = max([(pn[k] - v).abs().max().item() for k, v in p1.items()]
               + [(on.mu[k] - v).abs().max().item() for k, v in o1.mu.items()]
               + [(on.nu[k] - v).abs().max().item() for k, v in o1.nu.items()])
    log(f"train_spd: {SPD} steps per dispatch against 1, {REMAT_STEPS} "
        f"steps: losses identical {multi['losses'] == one['losses']}, final "
        f"parameters and moments max abs diff {diff:.3e}, launches "
        f"identical {cn == c1}; step p50 {multi['step_ms_p50']:.3f} ms vs "
        f"{one['step_ms_p50']:.3f} ms")
    if (multi["losses"] != one["losses"] or diff != 0.0 or cn != c1
            or multi["steps"] != REMAT_STEPS):
        raise AssertionError("several steps per dispatch train otherwise "
                             "than one")
    _only(cn, _flash_want(cfg_layers, REMAT_STEPS),
          "train --steps_per_dispatch")

    # the Adam update's scalars from the card, against host floats
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=2, max_steps=5,
                           clip_grad_norm=0.5, weight_decay=0.1)
    g = torch.Generator(device="cuda").manual_seed(12)
    init = {k: torch.randn(s, generator=g, device="cuda")
            for k, s in (("w", (512, 2048)), ("b", (2048,)))}
    host = {k: v.clone() for k, v in init.items()}
    dev = {k: v.clone() for k, v in init.items()}
    sh, sd = init_adam_state(host), init_adam_state(dev)
    for _ in range(5):
        grads = {k: torch.randn(v.shape, generator=g, device="cuda")
                 for k, v in init.items()}
        sh = adam_update(ocfg, host, grads, sh)
        sd = adam_update(ocfg, dev, grads, sd, scalars=torch.from_numpy(
            adam_scalars(ocfg, sd.step)).cuda())
    same = all(torch.equal(host[k], dev[k]) and torch.equal(sh.nu[k], sd.nu[k])
               for k in init)
    log(f"train_spd: 5 Adam updates (clip, weight decay) from device "
        f"scalars vs host floats on the card: bitwise {same}")
    if not same:
        raise AssertionError("adam_update from device scalars differs")

    # one profiled dispatch of SPD steps, beside SPD eager steps
    cfg = model_preset("45m", compute_dtype="bfloat16")
    b, t = TRAIN_SHAPE[0], TRAIN_SHAPE[2]
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                        (SPD, b, t))).cuda()
    pos = torch.arange(t, device="cuda").expand(SPD, b, t)
    res = {}
    for name, build in (("eager", build_train_step),
                        ("graph", build_train_step_multi)):
        model = Transformer(cfg, remat=True).init_weights(seed=2).to("cuda")
        step = build(model, OptimizerConfig(lr=1e-4))
        state = init_adam_state(dict(model.named_parameters()))

        def dispatch():
            nonlocal state
            if name == "graph":
                _, _, state = step(state, ids, ids, pos)
            else:
                for i in range(SPD):
                    _, _, state = step(state, ids[i], ids[i], pos[i])

        dispatch()                       # build, warm (and capture)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        busy = sum(us for _, us in _profiled(torch, dispatch,
                                             f"train_spd {name}")) / 1e3
        res[name] = {"wall_ms": wall / SPD, "busy_ms": busy / SPD,
                     "idle": 1 - busy / wall}
        log(f"train_spd profile ({name}, {SPD} steps of 45m bf16 b{b} x "
            f"t{t}, remat): wall {wall / SPD:.3f} ms per step, device busy "
            f"{busy / SPD:.3f} ms, idle share {1 - busy / wall:.3f}")
        del model, step, state
    return {**cn, "profile": res}


def _live_engine(torch, kind: str, model, mesh, mode: str):
    """A slot (8 slots) or paged (16 slots, page 64, chunk 128) engine at
    the profile phases' shape with every slot live on a 512-token prompt,
    its decode step graphed or not (`mode`), a few steps in."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        ContinuousBatchingEngine, PagedEngine, Request)
    vocab = model.cfg.vocab_size
    if kind == "slot":
        n, eng = 8, ContinuousBatchingEngine(
            model, mesh, num_slots=8, buf_len=642, eos_id=vocab,
            max_prefill_batch=4, decode_graph=mode)
    else:
        n, eng = 16, PagedEngine(
            model, mesh, num_slots=16, buf_len=642, eos_id=vocab,
            page_size=64, prefill_chunk=128, decode_graph=mode)
    rng = np.random.default_rng(1)
    # eos_id = vocab: never picked, so every request stays live
    for i in range(n):
        eng.submit(Request(rid=i, prompt=[int(x) for x in rng.integers(
            3, vocab, 512)], max_new=120))
    while eng.scheduler.pending or getattr(eng, "_prefilling", None):
        eng.step()
    for _ in range(3):
        eng.step()
    return eng


def _decode_window(torch, eng, steps: int = 10) -> dict:
    """Wall per decode step (host clock around `steps` engine steps, each
    ending in its token copy) and, from a profiled repeat, device busy and
    kernels per step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    events = _profiled(torch, lambda: [eng.step() for _ in range(steps)],
                       "graph_check decode window")
    busy = sum(us for _, us in events) / 1e3 / steps
    return {"wall_ms": wall, "busy_ms": busy, "kernels": len(events) / steps,
            "idle": 1 - busy / wall}


def _replay_vs_eager(torch, eng) -> tuple:
    """The next decode dispatch run eagerly and by the graph's replay (a
    step writes the same K/V at the same places each time, so the two see
    the same pool): (live rows' logits and tokens bitwise equal, max abs
    logit diff, live rows)."""
    payload = eng._decode_payload()
    live = sorted(eng._slot_req)
    with torch.inference_mode():
        tok, logits = (x.clone() for x in eng._decode_body(
            torch.from_numpy(payload).to(eng.device)))
        gtok, glogits = eng._decode_graph(payload)
    same = (torch.equal(glogits[live], logits[live])
            and torch.equal(gtok[live], tok[live]))
    diff = (glogits[live].float() - logits[live].float()).abs().max().item()
    return same, diff, len(live)


# graph_check's paged traffic: phase 15's three classes with their TTFT
# deadlines x 1000, so that no admission or preemption depends on the clock.
# At the real deadlines a faster decode step changes which requests are
# overdue and which are preempted, and a preempted request's tokens are
# re-prefilled by the chunk kernel, whose bf16 roundings are not the decode
# step's: the two runs would serve other schedules, not the same requests.
GRAPH_CHECK_SLO = ["--slo_classes", "interactive=250,standard=1000,batch=8000"]
# graph_check's served runs take the first 8 requests of each mix
GRAPH_CHECK_PAGED = 8


def phase_graph_check(torch) -> dict:
    """Both engines with the decode step graphed (`--decode_graph auto`)
    against eager (`off`): the phase-5 and phase-15 traffic (its deadlines
    scaled, `GRAPH_CHECK_SLO`) served both ways at bf16 gives identical
    tokens; a replayed decode step's
    logits are bitwise the eager step's (bf16 and f32); and per engine the
    decode step's wall, device busy and idle share both ways (profiled, as
    phases 7 and 17), with the served TPOT p50 and tokens/s."""
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    res = {}
    for kind, args in (("slot", _replace_flag(SERVE_ARGS, "--num_requests",
                                              str(GRAPH_CHECK_PAGED))),
                       ("paged", _replace_flag(
                           PAGED_SERVE_ARGS, "--num_requests",
                           str(GRAPH_CHECK_PAGED)) + GRAPH_CHECK_SLO)):
        # served at bf16 only: f32's graph against eager is held bitwise
        # on a live engine below (the served f32 runs repeated that)
        for dtype, flag in (("bfloat16", "--bf16"),):
            outs = {m: serve.main(args + [flag, "--decode_graph", m])
                    for m in ("off", "auto")}
            for m, out in outs.items():
                log(f"graph_check {kind} {dtype} decode {m}: "
                    f"{out['completed']}/{out['requests']} requests, "
                    f"{out['generated_tokens']} tokens, TPOT p50 "
                    f"{out['tpot_ms_p50']:.3f} ms, TTFT p50 "
                    f"{out['ttft_ms_p50']:.3f} ms, {out['tokens_per_sec']:.1f}"
                    f" tok/s, decode graph {out['decode_graph']} "
                    f"({out['decode_graph_replays']} replays of "
                    f"{out['decode_graph_launches']} kernel launches each)")
            if outs["auto"]["outputs"] != outs["off"]["outputs"]:
                raise AssertionError(f"{kind} {dtype}: the graphed decode "
                                     f"gives other tokens than eager")
            if (outs["auto"]["decode_graph"] is not True
                    or outs["off"]["decode_graph"] is not False
                    or outs["auto"]["decode_graph_replays"]
                    != outs["auto"]["engine_stats"]["decode_steps"]):
                raise AssertionError(f"{kind} {dtype}: the decode graph did "
                                     f"not run on every decode step")
            res[(kind, dtype)] = {m: {k: outs[m][k] for k in (
                "tpot_ms_p50", "ttft_ms_p50", "tokens_per_sec")}
                for m in outs}
    mesh = make_mesh(MeshConfig(), device="cuda")
    for dtype in ("bfloat16", "float32"):
        model = Transformer(model_preset("45m", compute_dtype=dtype)
                            ).init_weights(seed=1).to(mesh.device)
        for kind in ("slot", "paged"):
            eng = _live_engine(torch, kind, model, mesh, "auto")
            same, diff, live = _replay_vs_eager(torch, eng)
            log(f"graph_check {kind} {dtype}: replayed decode step vs eager "
                f"on {live} live rows: logits and tokens bitwise {same} "
                f"(max abs logit diff {diff:.3e})")
            if not same:
                raise AssertionError(f"{kind} {dtype}: a replayed decode "
                                     f"step differs from the eager step")
            if dtype != "bfloat16":
                continue
            win = {"auto": _decode_window(torch, eng)}
            del eng
            win["off"] = _decode_window(torch, _live_engine(
                torch, kind, model, mesh, "off"))
            for m, w in win.items():
                log(f"graph_check {kind} bf16 decode step ({m}): wall "
                    f"{w['wall_ms']:.3f} ms, device busy {w['busy_ms']:.3f} "
                    f"ms, idle share {w['idle']:.3f}, {w['kernels']:.0f} "
                    f"kernels per step")
            res[(kind, "window")] = win
        del model
    return res


ROOT = os.path.dirname(os.path.abspath(__file__))
TOKENIZER = os.path.join(ROOT, "tokenizer", "tokenizer.json")
EVAL_STEPS = 20        # eval: 20 steps of the train cell, a checkpoint every 10
EVAL_VAL_DOCS = 32     # the validation split: 4 batches of 8 at t <= 1000
EVAL_F32_LEN = 32      # the f32 decodes' --max_decode_len (token checks)
EVAL_LOSS_TOL = 1e-2   # bf16 sweep vs one document at a time (absolute)
EVAL_TP_TOL = 1e-4     # f32 tp=2 sweep vs tp=1 (absolute)
# evaluate.DECODE_PROMPTS (stripped, as evaluate encodes them) under the
# shipped tokenizer, by HF `tokenizers`
PROMPT_IDS = [
    [331, 75, 175, 423, 169, 71, 284, 525, 81, 87, 14, 545, 433],
    [676, 153, 145, 219, 199, 75, 153, 727, 321, 167, 260, 85, 14, 545, 829],
    [119, 59, 81, 251, 169, 67, 76, 209, 91, 14, 545, 433, 169, 91, 197, 176,
     91],
    [649, 271, 260, 677, 227, 189, 70],
    [119, 57, 74, 145, 172, 227, 78, 683, 423],
    [474, 74, 471, 292, 186, 217, 71, 67, 77, 14, 545, 433],
    [632, 174, 161, 286, 169, 257, 727],
    [305, 81, 158, 193, 930, 169, 257, 14, 545, 433],
]


def _eval_files(workdir: str) -> tuple:
    """(token JSON, checkpoint dir) of the eval phases."""
    return (os.path.join(workdir, "eval_tokens.json"),
            os.path.join(workdir, "eval_ckpt"))


def _eval_run(workdir: str, name: str, ckpt_dir: str, extra: list) -> dict:
    """`evaluate` at the 45m preset, batch 8, the shipped tokenizer, through
    its `main` in this process; returns its --summary_json plus the wall
    `run_s`."""
    from distributed_pytorch_from_scratch_tpu_torch import evaluate
    data, _ = _eval_files(workdir)
    out = os.path.join(workdir, f"{name}.json")
    t0 = time.perf_counter()
    evaluate.main(["--model", "45m", "--batch_size", "8", "--data_path", data,
                   "--tokenizer_path", TOKENIZER, "--ckpt_dir", ckpt_dir,
                   "--summary_json", out] + extra)
    wall = time.perf_counter() - t0
    with open(out) as f:
        summary = json.load(f)
    summary["run_s"] = wall
    log(f"{name}: evaluate {' '.join(extra)} took {wall:.1f} s")
    return summary


def _check_eval_run(name: str, s: dict, layers: int, ckpts: int) -> dict:
    """Finite losses for every checkpoint, the tokenizer's prompt ids,
    every rank's launches exactly 12 per layer per batch per checkpoint
    plus 12 per prefill dispatch (KV) or per full forward (--no_kv_cache)
    and no other kernel; returns the sweep's numbers."""
    import math
    losses = s["val_losses"]
    if len(losses) != ckpts or not all(math.isfinite(v)
                                       for v in losses.values()):
        raise AssertionError(f"{name}: val losses {losses} (expected "
                             f"{ckpts} finite)")
    if s["prompt_ids"] != PROMPT_IDS:
        raise AssertionError(f"{name}: the {s['tokenizer_backend']} "
                             f"tokenizer encodes the prompts to "
                             f"{s['prompt_ids']}, HF to {PROMPT_IDS}")
    batches = sum(n // (8 * 1000) for n in s["sweep_tokens"].values())
    decode = s.get("prefill_dispatches", s.get("forwards"))
    for r in s["ranks"]:
        _only(r["launches"],
              {"flash_attention_fwd": layers * (batches + decode)},
              f"{name} rank {r['rank']} ({layers} per layer per batch, "
              f"{batches} batches, + {layers} x {decode} "
              + ("prefill dispatches)" if "prefill_dispatches" in s
                 else "full forwards)"))
    per = {it: {"ms": 1e3 * s["sweep_s"][it],
                "tokens_per_s": s["sweep_tokens"][it] / s["sweep_s"][it]}
           for it in sorted(losses, key=int)}
    log(f"{name}: val losses {losses}; sweep per checkpoint "
        + ", ".join(f"iter {it}: {v['ms']:.1f} ms, {v['tokens_per_s']:.1f} "
                    f"tokens/s" for it, v in per.items())
        + f"; decode wall {s['decode_s']:.3f} s ("
        + (f"{s['prefill_dispatches']} prefill dispatches, "
           f"{s['decode_steps']} decode steps, graph {s['decode_graph']}"
           if "prefill_dispatches" in s else
           f"{s['forwards']} full forwards") + f"); tokenizer "
        f"{s['tokenizer_backend']}; launches "
        f"{[r['launches']['flash_attention_fwd'] for r in s['ranks']]}")
    return per


def phase_eval(torch, workdir: str) -> dict:
    """The reference's workflow after training: 20 steps of the train cell
    into a fresh save dir (checkpoints at 10 and 20), then `evaluate` on
    them in this process: bf16 with the KV decoder, f32 with it and f32
    with --no_kv_cache. Checks the losses (finite; the newest bf16 one against
    a one-document-at-a-time mean of `Transformer.loss`), the prompts'
    ids, the launches, and identical f32 tokens from both decoders.
    Returns each run's summary."""
    import importlib.util
    import shutil
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.data.dataset import (
        collate)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.training.checkpoint import (
        load_checkpoint)
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("tokenizers", "pandas", "pyarrow", "tensorboardX")}
    log(f"eval: installed here {have}; g++ {shutil.which('g++')}")
    data, ckpt = _eval_files(workdir)
    t0 = time.perf_counter()
    write_bigram_corpus(data, val_docs=EVAL_VAL_DOCS)
    log(f"eval: corpus with {EVAL_VAL_DOCS} validation documents written in "
        f"{time.perf_counter() - t0:.1f} s")
    args = _replace_flag(_replace_flag(TRAIN_ARGS, "--max_steps",
                                       str(EVAL_STEPS)),
                         "--save_interval", str(EVAL_STEPS // 2))
    trained = train.main(args + ["--data_path", data, "--save_dir", ckpt])
    log(f"eval: trained {trained['steps']} steps, losses "
        f"{[round(x, 4) for x in trained['losses']]}; checkpoints "
        f"{trained['checkpoints']}")
    layers = model_preset("45m").num_layers
    runs = {"bf16": _eval_run(workdir, "eval_bf16", ckpt, []),
            "kv_f32": _eval_run(workdir, "eval_kv_f32", ckpt,
                                ["--no-bf16", "--max_decode_len",
                                 str(EVAL_F32_LEN)]),
            "no_kv_f32": _eval_run(workdir, "eval_no_kv_f32", ckpt,
                                   ["--no-bf16", "--no_kv_cache",
                                    "--max_decode_len", str(EVAL_F32_LEN)])}
    for name, s in runs.items():
        s["per_ckpt"] = _check_eval_run(f"eval {name}", s, layers, 2)
    kv, full = runs["kv_f32"], runs["no_kv_f32"]
    log(f"eval: f32 decoders, KV vs full recompute: tokens identical "
        f"{kv['generated_ids'] == full['generated_ids']}; decode wall "
        f"{kv['decode_s']:.3f} s vs {full['decode_s']:.3f} s")
    if kv["generated_ids"] != full["generated_ids"]:
        raise AssertionError("the KV and full-recompute decoders disagree "
                             "at f32")

    # the newest bf16 loss against one document at a time
    newest = max(int(k) for k in runs["bf16"]["val_losses"])
    swept = runs["bf16"]["val_losses"][str(newest)]
    model = Transformer(model_preset("45m", compute_dtype="bfloat16"))
    model.load_state_dict(load_checkpoint(ckpt, newest)[0])
    model.to("cuda")
    with open(data) as f:
        docs = json.load(f)["validation"]
    per_doc = []
    with torch.no_grad():
        for doc in docs:
            b = collate([doc], 0, 1, -1, pad_to=1000)
            ids, tgt, pos = (torch.from_numpy(b[k]).cuda().long() for k in
                             ("input_ids", "target_ids", "position_ids"))
            per_doc.append(float(model.loss(ids, tgt, pos)))
    one_by_one = sum(per_doc) / len(per_doc)
    log(f"eval: iter {newest} sweep loss {swept!r} vs the mean of "
        f"{len(per_doc)} one-document Transformer.loss {one_by_one!r}: "
        f"|diff| {abs(swept - one_by_one):.3e} (tol {EVAL_LOSS_TOL})")
    if not abs(swept - one_by_one) <= EVAL_LOSS_TOL:
        raise AssertionError("the sweep's loss is not the mean of "
                             "per-document means")
    del model

    # how often the greedy next token is the corpus's bigram successor
    nxt = _bigram_rule(np.random.default_rng(0), 1024)
    hits = total = 0
    for prompt, gen in zip(runs["bf16"]["prompt_ids"],
                           runs["bf16"]["generated_ids"]):
        seq = prompt[-1:] + gen
        hits += sum(int(nxt[a] == b) for a, b in zip(seq, seq[1:]))
        total += len(seq) - 1
    runs["bigram_share"] = hits / max(total, 1)
    log(f"eval: {hits} of {total} greedy next tokens (bf16, KV) are the "
        f"bigram successor: share {runs['bigram_share']:.4f}")
    return runs


def _eval_result(workdir: str, name: str) -> dict:
    path = os.path.join(workdir, f"{name}.json")
    if not os.path.exists(path):
        raise RuntimeError(f"{name}.json missing: run the eval phase first")
    with open(path) as f:
        return json.load(f)


def phase_eval_pth(torch, workdir: str) -> dict:
    """The newest eval checkpoint exported by the interop CLI as the source
    repo's .pth files at tp 2, imported back, and evaluated (bf16, KV,
    in this process):
    its val loss equals the npz run's bit for bit (the same f32 bytes
    through the same program). Returns the run's summary."""
    from distributed_pytorch_from_scratch_tpu_torch import interop
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    ref = _eval_result(workdir, "eval_bf16")
    _, ckpt = _eval_files(workdir)
    newest = max(int(k) for k in ref["val_losses"])
    cfg = model_preset("45m")
    shape = ["--attn_dim", str(cfg.attn_dim), "--ffn_dim", str(cfg.ffn_dim),
             "--num_heads", str(cfg.num_heads), "--num_layers",
             str(cfg.num_layers), "--vocab_size", str(cfg.vocab_size),
             "--maxlen", str(cfg.maxlen)]
    pth, back = os.path.join(workdir, "eval_pth"), os.path.join(
        workdir, "eval_pth_ckpt")
    t0 = time.perf_counter()
    interop.main(["--direction", "export", "--our_ckpt_dir", ckpt,
                  "--export_tp", "2", "--out_dir", pth] + shape)
    t1 = time.perf_counter()
    interop.main(["--ref_ckpt_dir", pth, "--out_dir", back] + shape)
    log(f"eval_pth: export to 2 .pth rank files {t1 - t0:.1f} s, import "
        f"{time.perf_counter() - t1:.1f} s: "
        f"{sorted(os.listdir(pth))} -> {sorted(os.listdir(back))}")
    s = _eval_run(workdir, "eval_pth", back, [])
    _check_eval_run("eval_pth", s, cfg.num_layers, 1)
    got, want = s["val_losses"][str(newest)], ref["val_losses"][str(newest)]
    log(f"eval_pth: iter {newest} val loss {got!r} through .pth vs "
        f"{want!r} from the npz: bitwise {got == want}")
    if got != want:
        raise AssertionError("the .pth round trip changed the val loss")
    return s


def phase_eval_tp(torch, workdir: str) -> dict:
    """`evaluate --tp_size 2 --dist_backend gloo` (two ranks on the card)
    at f32 on the eval checkpoints: val losses within EVAL_TP_TOL of
    tp=1's, the greedy tokens tp=1's, each rank's launches per batch and
    prefill dispatch at 4 local heads. Returns the run's summary."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    ref = _eval_result(workdir, "eval_kv_f32")
    _, ckpt = _eval_files(workdir)
    s = _eval_run(workdir, "eval_tp2", ckpt,
                  ["--no-bf16", "--max_decode_len", str(EVAL_F32_LEN),
                   "--tp_size", "2", "--dist_backend", "gloo"])
    s["per_ckpt"] = _check_eval_run("eval_tp2", s,
                                    model_preset("45m").num_layers, 2)
    diff = max(abs(s["val_losses"][k] - v)
               for k, v in ref["val_losses"].items())
    log(f"eval_tp2: val losses {s['val_losses']} vs tp=1 "
        f"{ref['val_losses']}: max |diff| {diff:.3e} (tol {EVAL_TP_TOL}); "
        f"tokens identical {s['generated_ids'] == ref['generated_ids']}")
    if not diff <= EVAL_TP_TOL or len(s["ranks"]) != 2:
        raise AssertionError("tp=2 evaluates otherwise than tp=1")
    if s["generated_ids"] != ref["generated_ids"]:
        raise AssertionError("tp=2 decodes otherwise than tp=1 at f32")
    return s


def phase_gpt2_kernels(torch) -> dict:
    """K1's forward and backward pair at the gpt2 train shape (8, 12, 1024,
    64) bf16: held against their plain versions per element, then timed
    with the bound and the SDPA yardstick (`_flash_times_at`)."""
    return _flash_times_at(torch, GPT2_SHAPE, seed=17)


def _gpt2_corpus(workdir: str) -> str:
    """The seeded bigram corpus at vocab 50257, written on first use."""
    data = os.path.join(workdir, "bigram_gpt2.json")
    if not os.path.exists(data):
        t0 = time.perf_counter()
        write_bigram_corpus(data, vocab=GPT2_VOCAB, docs=GPT2_DOCS,
                            rule_vocab=GPT2_RULE_VOCAB)
        log(f"gpt2 bigram corpus (vocab {GPT2_VOCAB}, the rule over ids < "
            f"{GPT2_RULE_VOCAB}, {GPT2_DOCS} documents) written in "
            f"{time.perf_counter() - t0:.1f} s")
    return data


def phase_gpt2_train(torch, workdir: str) -> dict:
    """`train --family gpt2 --model gpt2-124m` at b 8 x t 1024 bf16 with
    remat, 60 steps on the seeded bigram corpus at vocab 50257 (its rule
    over ids below 1024): finite, falling losses (the mean of the last 5
    at least 1 nat below the first 5's and GPT2_LEARNED below the unigram
    floor ln 1021), K1 forward 2 x 12 x 60 and dq, dk/dv 12 x 60 launches
    and no other kernel; step p50, tokens/s, MFU (N counted from the real
    parameters) and peak memory printed. Then a GPT2_RESUME-step
    `--resume` from step 60, and the same resume at `--steps_per_dispatch
    GPT2_SPD` from the same checkpoint: bitwise the same losses and
    launches. Returns the launches and the summary."""
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    data = _gpt2_corpus(workdir)
    save_dir = os.path.join(workdir, "ckpt_gpt2")
    args = GPT2_TRAIN_ARGS + ["--data_path", data, "--save_dir", save_dir]
    _reset_launches()
    out = train.main(args)
    counts = _read_launches()
    layers = model_preset("gpt2-124m").num_layers
    losses = out["losses"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    log(f"gpt2_train: {out['steps']} steps of b8 x t1024 bf16 (GPT-2 small, "
        f"vocab {GPT2_VOCAB}, tied head) on {out['device']}: losses "
        f"{[round(x, 4) for x in losses]}; mean of first/last 5 "
        f"{first:.4f}/{last:.4f}; step p50 {out['step_ms_p50']:.3f} ms, "
        f"{out['tokens_per_sec']:.1f} tok/s, MFU {out['mfu']:.4f} (N "
        f"{out['params']:,} from the real parameters), peak memory "
        f"{out['peak_mem_gib']:.3f} GiB; launches {counts}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != GPT2_STEPS:
        raise AssertionError(f"gpt2 train losses not finite or not "
                             f"{GPT2_STEPS}")
    # as the 45m cell's check: a drop of 1 nat is learning, not noise; and
    # below the unigram floor the blocks have learned the bigram
    floor = math.log(GPT2_RULE_VOCAB - 3)
    log(f"gpt2_train: last 5 mean {last:.4f} against the unigram floor "
        f"ln({GPT2_RULE_VOCAB - 3}) = {floor:.4f} (must be <= "
        f"{floor - GPT2_LEARNED:.4f})")
    if not (last <= first - 1.0 and last <= floor - GPT2_LEARNED):
        raise AssertionError(f"gpt2 train loss did not fall below the "
                             f"unigram floor: {first} -> {last}")
    counts_want = {"flash_attention_fwd": 2 * layers * GPT2_STEPS,
                   "flash_attention_bwd_dq": layers * GPT2_STEPS,
                   "flash_attention_bwd_dkv": layers * GPT2_STEPS}
    _only(counts, counts_want, "gpt2 train (remat: forward twice per layer)")
    # the step-60 checkpoint, linked alone into the captured resume's dir
    # (the eager resume writes its own final one beside it)
    from distributed_pytorch_from_scratch_tpu_torch.training.checkpoint import (
        list_checkpoints)
    spd_dir = save_dir + "_spd"
    os.makedirs(spd_dir, exist_ok=True)
    for _, path in list_checkpoints(save_dir):
        os.link(path, os.path.join(spd_dir, os.path.basename(path)))
    resume = _replace_flag(args, "--max_steps",
                           str(GPT2_STEPS + GPT2_RESUME)) + ["--resume"]
    _reset_launches()
    resumed = train.main(resume)
    rcounts = _read_launches()
    log(f"gpt2_train --resume: started at step {resumed['start_step']}, ran "
        f"to {resumed['steps']}, losses {resumed['losses']}; launches "
        f"{rcounts}")
    if (resumed["start_step"] != GPT2_STEPS
            or resumed["steps"] != GPT2_STEPS + GPT2_RESUME
            or not all(math.isfinite(x) for x in resumed["losses"])):
        raise AssertionError("gpt2 resume did not continue from the "
                             "checkpoint")
    # the same resume, GPT2_SPD steps to each captured dispatch: bitwise
    # the same losses, the launches counted through the replays
    _reset_launches()
    spd = train.main(_replace_flag(resume, "--save_dir", spd_dir)
                     + ["--steps_per_dispatch", str(GPT2_SPD)])
    spd_counts = _read_launches()
    log(f"gpt2_train --resume --steps_per_dispatch {GPT2_SPD}: step p50 "
        f"{spd['step_ms_p50']:.3f} ms (one step a dispatch "
        f"{resumed['step_ms_p50']:.3f}), losses bitwise the one-step "
        f"resume's: {spd['losses'] == resumed['losses']}; launches "
        f"{spd_counts}")
    if spd["start_step"] != GPT2_STEPS or spd["losses"] != resumed["losses"]:
        raise AssertionError("gpt2 --steps_per_dispatch changed the losses")
    _only(spd_counts, {k: v * GPT2_RESUME // GPT2_STEPS
                       for k, v in counts_want.items()},
          f"gpt2 train, {GPT2_SPD} steps per dispatch")
    if spd_counts != rcounts:
        raise AssertionError(f"gpt2 --steps_per_dispatch launches "
                             f"{spd_counts}, one step a dispatch {rcounts}")
    return {**counts, "summary": out, "spd": spd_counts}


def _serve_line(name: str, out: dict, counts: dict) -> None:
    st = out["engine_stats"]
    log(f"gpt2_serve {name}: {out['completed']}/{out['requests']} requests, "
        f"{out['generated_tokens']} tokens in {out['wall_s']} s -> "
        f"{out['tokens_per_sec']} tok/s; TTFT p50/p95 {out['ttft_ms_p50']}/"
        f"{out['ttft_ms_p95']} ms; TPOT p50/p95 {out['tpot_ms_p50']}/"
        f"{out['tpot_ms_p95']} ms; {st['decode_steps']} decode steps, "
        f"{out['prefill_dispatches']} prefill dispatches, decode graph "
        f"{out['decode_graph']} ({out['decode_graph_replays']} replays)"
        + (f", preemptions {st['preemptions']}, COW copies "
           f"{st['cow_copies']}, pages in use after the drain "
           f"{st['pages_in_use']}" if "pages_in_use" in st else "")
        + f"; launches {counts}")


def phase_gpt2_serve(torch) -> dict:
    """`serve --family gpt2 --random_init --vocab_size 50257` at GPT-2
    small's widths, bf16, the decode step graphed: the slot engine on
    phase 5's traffic and the paged engine on phase 15's (bf16, then int8
    pages), each greedy and then sampled (temperature 0.8, top-k 50,
    top-p 0.95). Checks: every request served with in-vocab tokens; K1
    forward 12 per prefill dispatch (slot), K3 12 per decode step and per
    chunk, on the routes `_check_paged_run` names, and the pool drained
    (paged); the sampled slot run's tokens identical with the decode step
    eager (`--decode_graph off`) and with `--debug_host_sampler`, and the
    sampled paged run's (its deadlines scaled, `GRAPH_CHECK_SLO`) with
    `--debug_host_sampler`; sampled tokens differ from greedy. Returns each
    run's numbers and launches."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        paged_attention)
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        PagedEngine)
    layers = model_preset("gpt2-124m").num_layers
    dispatch = PagedEngine._dispatch_chunk
    widths = []

    def seen(self, slot, st, n, done):   # records each chunk's width
        widths.append(n)
        return dispatch(self, slot, st, n, done)

    def run(name, args):
        _reset_launches()
        widths.clear()
        PagedEngine._dispatch_chunk = seen
        try:
            out = serve.main(args)
        finally:
            PagedEngine._dispatch_chunk = dispatch
        counts = _read_launches()
        by_route = dict(paged_attention.launches_by_route)
        by_kernel = dict(paged_attention.launches_by_kernel)
        torch.cuda.synchronize()
        _serve_line(name, out, counts)
        if "--paged" in args:
            _check_paged_run(out, out["engine_stats"], counts, by_route,
                             by_kernel, widths, layers, GPT2_VOCAB)
        else:
            if out["completed"] != out["requests"]:
                raise AssertionError(f"{name}: served {out['completed']} of "
                                     f"{out['requests']} requests")
            toks = [t for ts in out["outputs"].values() for t in ts]
            if not toks or not all(0 <= t < GPT2_VOCAB for t in toks):
                raise AssertionError(f"{name}: tokens missing or outside "
                                     f"the vocab")
            _only(counts, {"flash_attention_fwd":
                           layers * out["prefill_dispatches"]},
                  f"{name} ({layers} per prefill dispatch)")
        if "--decode_graph" not in args and (
                out["decode_graph_replays"]
                != out["engine_stats"]["decode_steps"]):
            raise AssertionError(f"{name}: the decode graph did not run on "
                                 f"every decode step")
        return {"out": out, "launches": counts, "paged_by_route": by_route,
                "paged_by_kernel": by_kernel}

    n = GPT2_PAGED_ARGS.index("--num_requests") + 1
    int8 = (GPT2_PAGED_ARGS[:n] + [str(PAGED_INT8_REQUESTS)]
            + GPT2_PAGED_ARGS[n + 1:] + ["--kv_dtype", "int8"])
    runs = {
        "slot": run("slot greedy", GPT2_SERVE_ARGS),
        "slot_sampled": run("slot sampled", GPT2_SERVE_ARGS + SAMPLED_ARGS),
        "slot_sampled_eager": run("slot sampled, eager decode",
                                  GPT2_SERVE_ARGS + SAMPLED_ARGS
                                  + ["--decode_graph", "off"]),
        "slot_sampled_host": run("slot sampled, host sampler",
                                 GPT2_SERVE_ARGS + SAMPLED_ARGS
                                 + ["--debug_host_sampler"]),
        "paged": run("paged greedy (bf16 pages)", GPT2_PAGED_ARGS),
        "paged_sampled": run("paged sampled (bf16 pages, deadlines x 1000)",
                             GPT2_PAGED_ARGS + SAMPLED_ARGS
                             + GRAPH_CHECK_SLO),
        "paged_sampled_host": run(
            "paged sampled, host sampler (bf16 pages, deadlines x 1000)",
            GPT2_PAGED_ARGS + SAMPLED_ARGS + GRAPH_CHECK_SLO
            + ["--debug_host_sampler"]),
        "paged_int8": run("paged greedy (int8 pages)", int8),
        "paged_int8_sampled": run("paged sampled (int8 pages)",
                                  int8 + SAMPLED_ARGS),
    }
    toks = lambda name: runs[name]["out"]["outputs"]
    checks = {
        "sampled slot: graph == eager": toks("slot_sampled")
        == toks("slot_sampled_eager"),
        "sampled slot: fused == host": toks("slot_sampled")
        == toks("slot_sampled_host"),
        "sampled paged: fused == host": toks("paged_sampled")
        == toks("paged_sampled_host"),
        "slot: sampled != greedy": toks("slot_sampled") != toks("slot"),
        "paged: sampled != greedy": toks("paged_sampled") != toks("paged"),
    }
    log(f"gpt2_serve checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"gpt2_serve: {checks}")
    return runs


def _gpt2_serve_cases(cfg, seed: int) -> list:
    """serve_runs' runs for the card-vs-CPU and tp checks: 4 requests of
    64-200 tokens, 8 new tokens (16 until the speculative phases needed
    the room), through each engine, greedy and sampled (request seeds
    40..43)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [64, 200, 131, 97]
    prompts = [[int(x) for x in rng.integers(3, cfg.vocab_size, n)]
               for n in lens]
    reqs = [(p, 8, "default", None, 40 + i) for i, p in enumerate(prompts)]
    buf = max(lens) + 10
    slot = dict(num_slots=4, buf_len=buf, eos_id=1, prefill_bucket=64,
                max_prefill_batch=2)
    paged = dict(num_slots=4, buf_len=buf, eos_id=1, page_size=64,
                 prefill_chunk=128)
    sampled = dict(temperature=0.8, top_k=50, top_p=0.95)
    return [dict(engine=eng, kw=dict(kw, **extra), requests=reqs, stagger=1,
                 tick=0.02)
            for eng, kw in (("slot", slot), ("paged", paged))
            for extra in ({}, sampled)]


def phase_gpt2_card_vs_cpu(torch) -> None:
    """GPT-2 small's widths at 2 layers, f32, the same weights: (1) the
    forward logits (b 2 x t 256) on the card against the CPU's plain path
    within 1e-4 of the largest |logit|; (2) the first step's loss (rel
    1e-5) and every gradient (1e-3 of its max |grad| + 1e-6 of the
    largest |grad| of any leaf); (3) both engines'
    greedy and sampled tokens for 4 seeded requests identical on the card
    and on the CPU; (4) tp=2 over gloo (two ranks on the card): the loss
    within 1e-5 (relative) of tp=1's on the card and the engines' greedy
    and sampled tokens identical to tp=1's."""
    import dataclasses
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        IGNORE_INDEX, MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.interop import (
        params_to_jax)
    from distributed_pytorch_from_scratch_tpu_torch.models.gpt2 import (
        GPT2Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        launch, tp_checks)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
    cfg = model_preset("gpt2-124m", num_layers=2, compute_dtype="float32")
    cpu = GPT2Transformer(cfg, remat=False).init_weights(seed=12)
    card = GPT2Transformer(cfg, remat=True)
    card.load_state_dict(cpu.state_dict())
    card.to("cuda")
    rng = np.random.default_rng(12)
    b, t = 2, 256
    ids = rng.integers(3, cfg.vocab_size, size=(b, t + 1))
    tgt = ids[:, 1:].copy()
    tgt[1, 200:] = IGNORE_INDEX            # a padded tail
    pos = np.tile(np.arange(t), (b, 1))
    batch = [torch.from_numpy(a) for a in (ids[:, :-1], tgt, pos)]
    res = {}
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        with torch.no_grad():
            logits = model(batch[0].to(dev), batch[2].to(dev)).float().cpu()
        loss = model.loss(*(x.to(dev) for x in batch))
        loss.backward()
        res[dev] = (logits, loss.item(), {k: p.grad.cpu() for k, p in
                                          model.named_parameters()})
    (lg_card, l_card, g_card), (lg_cpu, l_cpu, g_cpu) = (res["cuda"],
                                                         res["cpu"])
    scale = max(1.0, lg_cpu.abs().max().item())
    lg_diff = (lg_card - lg_cpu).abs().max().item()
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    # each leaf within 1e-3 of its max |grad|, plus 1e-6 of the largest
    # |grad| of any leaf: without RoPE the wk bias's gradient is zero in
    # exact arithmetic (a bias on every key of a query shifts all its
    # scores alike, which the softmax ignores), so both devices hold
    # rounding noise there (PR 14, call 2: 3.8 x that leaf's own max)
    gmax = max(gc.abs().max().item() for gc in g_cpu.values())
    worst, worst_key = 0.0, None
    for k, gc in g_cpu.items():
        diff = (g_card[k] - gc).abs().max().item()
        leaf = gc.abs().max().item()
        ratio = diff / (1e-3 * leaf + 1e-6 * gmax)
        if ratio > worst:
            worst = ratio
            worst_key = (f"{k} (max abs diff {diff:.3e}, max |grad| "
                         f"{leaf:.3e})")
    log(f"gpt2 card vs cpu: GPT-2 small widths, 2 layers, f32, b{b} x t{t}: "
        f"logits max abs diff {lg_diff:.3e} (limit 1e-4 x {scale:.3f}); loss "
        f"{l_card:.7f} (card, kernels) vs {l_cpu:.7f} (cpu, plain), rel diff "
        f"{rel:.3e} (tol 1e-5); worst grad leaf {worst_key}: err/limit "
        f"{worst:.3f} (limit 1e-3 of its max |grad| + 1e-6 of the largest, "
        f"{gmax:.3e})")
    if not (lg_diff <= 1e-4 * scale and rel <= 1e-5 and worst <= 1.0):
        raise AssertionError("gpt2 on the card and on the CPU disagree")
    del card, res
    tree = params_to_jax(cpu.state_dict())
    kw = dict(cfg=dataclasses.asdict(cfg), tree=tree)
    runs = _gpt2_serve_cases(cfg, 12)
    one = {dev: tp_checks.serve_runs(make_mesh(MeshConfig(), device=dev),
                                     kw["cfg"], tree, runs)
           for dev in ("cuda", "cpu")}
    card_loss = tp_checks.model_runs(
        make_mesh(MeshConfig(), device="cuda"), kw["cfg"], tree,
        [dict(batch=(ids[:, :-1], tgt, pos))])[0]["loss"]
    todo = [("model_runs", {"tp": 2}, dict(kw, runs=[dict(
                sp=True, batch=(ids[:, :-1], tgt, pos))])),
            ("serve_runs", {"tp": 2}, dict(kw, runs=runs))]
    tp2 = launch.spawn(tp_checks.jobs, 2, todo, ("cuda",), "gloo")
    tp2_loss = tp2[0][0][0]["loss"]
    tp_rel = abs(tp2_loss - card_loss) / abs(card_loss)
    for i, r in enumerate(runs):
        what = (f"{r['engine']} "
                f"{'sampled' if r['kw'].get('temperature') else 'greedy'}")
        toks = one["cuda"][i]["tokens"]
        same = {"cpu": toks == one["cpu"][i]["tokens"],
                "tp2": toks == tp2[0][1][i]["tokens"],
                "ranks": (tp2[0][1][i]["dispatches"]
                          == tp2[1][1][i]["dispatches"])}
        log(f"gpt2 card vs cpu tokens ({what}, {len(toks)} requests x 8 "
            f"new): card tp=1 == cpu {same['cpu']}, == card tp=2 "
            f"{same['tp2']}; the tp=2 ranks' dispatches equal "
            f"{same['ranks']}")
        if not all(same.values()):
            raise AssertionError(f"gpt2 {what}: tokens differ ({same})")
    log(f"gpt2 tp=2 (SP, gloo, two ranks on the card) loss {tp2_loss:.7f} vs "
        f"tp=1 {card_loss:.7f}: rel diff {tp_rel:.3e} (tol 1e-5)")
    if not tp_rel <= 1e-5:
        raise AssertionError("gpt2 tp=2 loss disagrees with tp=1's")


def phase_sampler_check(torch) -> dict:
    """The sampler on the card: 20,000 draws (request seeds 0..19,999, one
    position) from one seeded row of 50257 logits at temperature 0.8, top-k
    50, top-p 0.95, against the exact filtered softmax by a one-sample
    chi-square (tokens expected >= 5 times are bins of their own, the rest
    one bin) at p = 1e-3 with its fixed critical value; the draws are
    deterministic, so the test is too. The first 500 draws also on the
    CPU: identical tokens. Returns the statistic and its limit."""
    import numpy as np
    from scipy.stats import chi2
    from distributed_pytorch_from_scratch_tpu_torch.models.decode import (
        _filter_logits, sample_from_full)
    temperature, top_k, top_p, pos = 0.8, 50, 0.95, 17
    row = torch.from_numpy((np.random.default_rng(5).standard_normal(
        GPT2_VOCAB) * 2).astype(np.float32))

    def draws(dev, lo, hi):
        n = hi - lo
        full = row.to(dev)[None].expand(n, -1)
        seeds = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        return sample_from_full(full, seeds, torch.full((n,), pos,
                                                        device=dev),
                                temperature, top_k, top_p).cpu().numpy()

    t0 = time.perf_counter()
    card = np.concatenate([draws("cuda", lo, lo + 2000)
                           for lo in range(0, SAMPLER_DRAWS, 2000)])
    card_s = time.perf_counter() - t0
    cpu = draws("cpu", 0, 500)
    probs = torch.softmax(_filter_logits(row[None] / temperature, top_k,
                                         top_p)[0].double(), -1).numpy()
    counts = np.bincount(card, minlength=GPT2_VOCAB).astype(float)
    exp = probs * SAMPLER_DRAWS
    keep = exp >= 5
    obs = np.append(counts[keep], counts[~keep].sum())
    want = np.append(exp[keep], exp[~keep].sum())
    if want[-1] == 0:
        obs, want = obs[:-1], want[:-1]
    stat = float(((obs - want) ** 2 / want).sum())
    crit = float(chi2.ppf(1 - SAMPLER_P, len(obs) - 1))
    outside = int(counts[probs == 0].sum())
    log(f"sampler_check: {SAMPLER_DRAWS} draws on the card in {card_s:.2f} s "
        f"(temperature {temperature}, top-k {top_k}, top-p {top_p}; "
        f"{int((probs > 0).sum())} tokens survive the filter): chi-square "
        f"{stat:.3f} over {len(obs) - 1} dof, critical {crit:.3f} at p = "
        f"{SAMPLER_P:g}; draws outside the filter {outside}; the first 500 "
        f"identical on the CPU: {bool((cpu == card[:500]).all())}")
    if not (stat < crit and outside == 0 and (cpu == card[:500]).all()):
        raise AssertionError("the sampler's draws do not follow the filtered "
                             "softmax, or the card and the CPU draw apart")
    return {"chi2": stat, "critical": crit, "dof": len(obs) - 1}


# train_async_preempt: the train cell with a checkpoint every ASYNC_EVERY
# steps (written in the background) and with none; a profiled loop of
# ASYNC_PROFILE_STEPS with saves; then a process of its own that gets
# SIGTERM after its PREEMPT_AFTER-th step line, and a --resume
ASYNC_STEPS = 6
ASYNC_EVERY = 3
ASYNC_PROFILE_STEPS = 5
PREEMPT_AFTER = 3
# serve_replay: a seeded poisson trace of the slot cell's requests
REPLAY_REQUESTS = 8
REPLAY_RATE = 8.0
TOKENIZER = "tokenizer/tokenizer.json"


def _loop_busy(prof, torch, first_fwd: int, steps: int) -> float:
    """Device busy ms per step of a train loop profiled on the device: the
    kernels (copies apart: the checkpoint writer's run on a stream of their
    own) from the start of the `first_fwd`-th flash forward kernel on,
    over the `steps` steps from there (the snapshot kernels of a save in
    them included)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                    for e in prof.events() if e.device_type == cuda)
    t0 = [s for s, _, name in events
          if "flash_fwd_sm90_kernel" in name][first_fwd]
    return sum(us for s, us, name in events if s >= t0
               and not name.startswith(("Memcpy", "Memset"))) / 1e3 / steps


def _preempted_run(args: list, after: int) -> tuple:
    """`python -m ...train args` in a process of its own, SIGTERM sent once
    it prints the step `after` line: (exit code, output, seconds from the
    signal to the exit)."""
    import signal
    import threading
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_pytorch_from_scratch_tpu_torch"
         ".train", *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, bufsize=1, env=env)
    lines, seen = [], threading.Event()

    def pump():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith(f"step {after}/"):
                seen.set()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        if not seen.wait(timeout=300):
            raise AssertionError("train_async_preempt: no step line within "
                                 "300 s:\n" + "".join(lines[-20:]))
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        react = time.perf_counter() - t0
    finally:
        proc.kill()
        proc.wait()
    reader.join(timeout=10)
    return rc, "".join(lines), react


def phase_train_async_preempt(torch, workdir: str) -> dict:
    """The preemption-safe loop on the train cell (45m bf16, b 32 x t 1000,
    remat): ASYNC_STEPS steps with a checkpoint every ASYNC_EVERY (the
    writer thread) and with none — identical losses, the loop's host time
    per save, the prefetch thread's wait, step p50 of both — beside one
    synchronous save of the same state timed alone; a profiled loop's idle
    share; then a train process that gets SIGTERM: exit 0, the shutdown
    line, its checkpoint at the step it reached, and a 2-step --resume from
    it. K1's launches are held to the schedule in every in-process run.
    Returns their launches and numbers."""
    import math
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.training.checkpoint import (
        latest_step, save_checkpoint)
    from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
        init_adam_state)
    layers = model_preset("45m").num_layers
    base = (_replace_flag(TRAIN_ARGS, "--max_steps", str(ASYNC_STEPS))
            + ["--data_path", _corpus(workdir)])
    runs = {}
    for name, every in (("saves", ASYNC_EVERY), ("no_saves", 10 ** 6)):
        _reset_launches()
        out = train.main(_replace_flag(base, "--save_interval", str(every))
                         + ["--save_dir", os.path.join(workdir,
                                                       f"async_{name}")])
        counts = _read_launches()
        _only(counts, _flash_want(layers, ASYNC_STEPS),
              f"train_async_preempt ({name})")
        runs[name] = (out, counts)
        log(f"train_async_preempt {name}: step p50 {out['step_ms_p50']:.3f} "
            f"ms, {out['tokens_per_sec']:.1f} tok/s; loop host ms per save "
            f"{[round(x, 3) for x in out['save_stall_ms']]}; prefetch wait "
            f"ms per window: first {out['prefetch_wait_ms'][0]:.3f}, then "
            f"p50 {np.median(out['prefetch_wait_ms'][1:]):.4f}, max "
            f"{max(out['prefetch_wait_ms'][1:]):.4f}; "
            f"checkpoints {len(out['checkpoints'])}; launches {counts}")
    saves, none = (runs[k][0] for k in ("saves", "no_saves"))
    if not saves["losses"] == none["losses"]:
        raise AssertionError("checkpoints written in the background changed "
                             "the losses")
    if len(saves["checkpoints"]) != ASYNC_STEPS // ASYNC_EVERY:
        raise AssertionError(f"{len(saves['checkpoints'])} checkpoints "
                             f"written, {ASYNC_STEPS // ASYNC_EVERY} due")
    # one synchronous save of the same state (params and both moments on
    # the card), timed alone, beside the call that schedules a background
    # one (the device snapshot) and its join
    model = Transformer(model_preset("45m"), remat=True).init_weights(1)
    model.to("cuda")
    params = dict(model.named_parameters())
    state = init_adam_state(params)
    sd = model.state_dict()
    times = {}
    for name in ("sync", "async"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = save_checkpoint(os.path.join(workdir, f"save_{name}"), 1, 1.0, sd,
                            state, async_write=name == "async")
        times[name] = (time.perf_counter() - t0) * 1e3
        if name == "async":
            torch.cuda.synchronize()
            times["async_snapshot"] = (time.perf_counter() - t0) * 1e3
            h.join()
            times["async_join"] = (time.perf_counter() - t0) * 1e3
    state_gb = 3 * sum(p.numel() * 4 for p in params.values()) / 1e9
    del model, params, state, sd
    torch.cuda.empty_cache()
    log(f"train_async_preempt saves: one synchronous save of the 45m state "
        f"({state_gb:.3f} GB of params and moments) {times['sync']:.3f} ms; "
        f"the background save's call {times['async']:.3f} ms (snapshot done "
        f"{times['async_snapshot']:.3f} ms, written {times['async_join']:.3f}"
        f" ms); step p50 with a save every {ASYNC_EVERY} steps "
        f"{saves['step_ms_p50']:.3f} ms, none {none['step_ms_p50']:.3f} ms "
        f"(ratio {saves['step_ms_p50'] / none['step_ms_p50']:.4f})")
    # the idle share of the loop with saves, as phase 12's of a step: 1 -
    # device busy per step (a loop profiled on the device, from step 3 on)
    # / the step p50 of the same loop unprofiled (above)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train.main(_replace_flag(_replace_flag(
            base, "--max_steps", str(ASYNC_PROFILE_STEPS)),
            "--save_interval", str(ASYNC_EVERY))
            + ["--save_dir", os.path.join(workdir, "prof_saves")])
        torch.cuda.synchronize()
    busy = _loop_busy(prof, torch, 2 * 2 * layers, ASYNC_PROFILE_STEPS - 2)
    idle = 1 - busy / saves["step_ms_p50"]
    log(f"train_async_preempt profile (saves, {ASYNC_PROFILE_STEPS} steps): "
        f"device busy {busy:.3f} ms per step from step 3 (the kernels), "
        f"step p50 {saves['step_ms_p50']:.3f} ms unprofiled: idle share "
        f"{idle:.4f}")
    del prof
    # SIGTERM to a train process of its own, then --resume
    save = os.path.join(workdir, "preempt")
    sig_args = (_replace_flag(_replace_flag(_replace_flag(
        base, "--max_steps", "100000"), "--log_interval", "1"),
        "--save_interval", "100000") + ["--save_dir", save])
    rc, text, react = _preempted_run(sig_args, PREEMPT_AFTER)
    stopped = latest_step(save)
    line = [x for x in text.splitlines() if x.startswith("shutdown")]
    log(f"train_async_preempt SIGTERM after the step {PREEMPT_AFTER} line: "
        f"exit {rc} {react:.3f} s after the signal; {line}; checkpoint at "
        f"step {stopped}")
    if (rc != 0 or stopped is None or stopped < PREEMPT_AFTER or line != [
            f"shutdown requested: checkpointed at step {stopped}; restart "
            f"with --resume to continue"]):
        raise AssertionError("SIGTERM did not checkpoint and exit 0:\n"
                             + "\n".join(text.splitlines()[-20:]))
    _reset_launches()
    resumed = train.main(_replace_flag(sig_args, "--max_steps",
                                       str(stopped + 2)) + ["--resume"])
    rcounts = _read_launches()
    log(f"train_async_preempt --resume: from step {resumed['start_step']} "
        f"to {resumed['steps']}, losses {resumed['losses']}; launches "
        f"{rcounts}")
    if (resumed["start_step"] != stopped or resumed["steps"] != stopped + 2
            or not all(math.isfinite(x) for x in resumed["losses"])):
        raise AssertionError("--resume did not continue from the SIGTERM "
                             "checkpoint")
    _only(rcounts, _flash_want(layers, 2), "train_async_preempt --resume")
    return {**runs["saves"][1], "resume": rcounts,
            "save_ms": {"sync": times["sync"], "async": times["async"],
                        "loop": saves["save_stall_ms"]},
            "step_ms_p50": {"saves": saves["step_ms_p50"],
                            "no_saves": none["step_ms_p50"]},
            "prefetch_wait_ms": saves["prefetch_wait_ms"], "idle": idle,
            "stopped_at": stopped, "exit_s": react}


def _serve_with_widths(serve, args: list) -> tuple:
    """`serve.main(args)` with each paged chunk dispatch's width recorded;
    returns (summary, launches, paged launches by route, by kernel,
    widths)."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        paged_attention)
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        PagedEngine)
    dispatch = PagedEngine._dispatch_chunk
    widths = []

    def seen(self, slot, st, n, done):
        widths.append(n)
        return dispatch(self, slot, st, n, done)

    _reset_launches()
    PagedEngine._dispatch_chunk = seen
    try:
        out = serve.main(args)
    finally:
        PagedEngine._dispatch_chunk = dispatch
    return (out, _read_launches(), dict(paged_attention.launches_by_route),
            dict(paged_attention.launches_by_kernel), widths)


INT8W_REQUESTS = "8"   # serve_int8_weights: the first 8 of each cell's mix


def _int8_line(name: str, out: dict, native: dict, counts: dict) -> None:
    st, nst = out["engine_stats"], native["engine_stats"]
    log(f"serve_int8_weights {name}: weight bytes {st['weight_bytes']} vs "
        f"native {nst['weight_bytes']} (ratio "
        f"{st['weight_bytes'] / nst['weight_bytes']:.4f}); TPOT p50/p95 "
        f"{out['tpot_ms_p50']}/{out['tpot_ms_p95']} ms vs "
        f"{native['tpot_ms_p50']}/{native['tpot_ms_p95']}; TTFT p50/p95 "
        f"{out['ttft_ms_p50']}/{out['ttft_ms_p95']} ms vs "
        f"{native['ttft_ms_p50']}/{native['ttft_ms_p95']}; "
        f"{out['tokens_per_sec']} vs {native['tokens_per_sec']} tok/s; "
        f"{st['decode_steps']} decode steps, decode graph "
        f"{out['decode_graph']} ({out['decode_graph_replays']} replays); "
        f"launches {counts}")
    if not (out["decode_graph"]
            and out["decode_graph_replays"] == st["decode_steps"]):
        raise AssertionError(f"{name}: the int8 decode step did not run as "
                             f"a graph")
    if not 0.2 < st["weight_bytes"] / nst["weight_bytes"] < 0.3:
        raise AssertionError(f"{name}: int8 weights hold "
                             f"{st['weight_bytes']} bytes against "
                             f"{nst['weight_bytes']} native")


def phase_serve_int8_weights(torch) -> dict:
    """Phase 5's and phase 15's traffic (bf16 pages) with
    `--decode_weight_dtype int8`, the decode step graphed, each after a
    run with the native weights: every request served in-vocab, the
    resident weights about a quarter of the f32 ones, K1 12 launches per
    prefill dispatch (slot) and K3 12 per decode step and per chunk, on the
    routes their widths name (paged); then the 45m widths at 2 layers in
    f32, both engines greedy and sampled with int8 weights: the card's
    tokens those of the CPU's plain path. Returns the runs' launches."""
    import dataclasses
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.interop import (
        params_to_jax)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import tp_checks
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    layers = model_preset("45m").num_layers
    int8 = ["--decode_weight_dtype", "int8"]
    # one native run of each cell beside the int8 one, warm (phases 5 and
    # 15 ran first in the process), on the first INT8W_REQUESTS requests
    cells = {kind: _replace_flag(args, "--num_requests", INT8W_REQUESTS)
             for kind, args in (("slot", SERVE_ARGS),
                                ("paged", PAGED_SERVE_ARGS))}
    native = {kind: serve.main(args) for kind, args in cells.items()}
    _reset_launches()
    slot = serve.main(cells["slot"] + int8)
    counts = _read_launches()
    _int8_line("slot", slot, native["slot"], counts)
    if slot["completed"] != slot["requests"] or not all(
            0 <= t < 1024 for ts in slot["outputs"].values() for t in ts):
        raise AssertionError("int8 slot serving: requests unserved or "
                             "tokens outside the vocab")
    _only(counts, {"flash_attention_fwd": layers * slot["prefill_dispatches"]},
          f"int8 slot serving ({layers} per prefill dispatch)")
    out, pcounts, by_route, by_kernel, widths = _serve_with_widths(
        serve, cells["paged"] + int8)
    _int8_line("paged", out, native["paged"], pcounts)
    _check_paged_run(out, out["engine_stats"], pcounts, by_route, by_kernel,
                     widths, layers, 1024)
    # the card against the CPU's plain path: 2 layers, f32, int8 weights
    cfg = model_preset("45m", num_layers=2)
    tree = params_to_jax(Transformer(cfg).init_weights(4).state_dict())
    runs = [dict(r, kw=dict(r["kw"], decode_weight_dtype="int8"))
            for r in _gpt2_serve_cases(cfg, 14)]
    got = {dev: tp_checks.serve_runs(make_mesh(MeshConfig(), device=dev),
                                     dataclasses.asdict(cfg), tree, runs)
           for dev in ("cuda", "cpu")}
    for i, r in enumerate(runs):
        what = (f"{r['engine']} "
                f"{'sampled' if r['kw'].get('temperature') else 'greedy'}")
        same = got["cuda"][i]["tokens"] == got["cpu"][i]["tokens"]
        log(f"serve_int8_weights card vs cpu ({what}, 45m widths, 2 layers, "
            f"f32, 4 requests x 8 new): identical tokens {same}")
        if not same:
            raise AssertionError(f"int8 weights, {what}: the card's tokens "
                                 f"are not the CPU's")
    return {"slot": counts, "paged": pcounts, "paged_by_route": by_route,
            "paged_by_kernel": by_kernel,
            "weight_bytes": {k: (o["engine_stats"]["weight_bytes"],
                                 native[k]["engine_stats"]["weight_bytes"])
                             for k, o in (("slot", slot), ("paged", out))}}


def phase_serve_replay(torch, workdir: str) -> dict:
    """A trace of REPLAY_REQUESTS seeded poisson requests of the slot cell
    (prompts 64-512, 64 new tokens), written to the workdir in reverse
    arrival order, served with `--tokenizer_path tokenizer/tokenizer.json
    --arrival replay --replay <trace>`: submitted in arrival order, every
    request served in-vocab, K1 12 launches per prefill dispatch. Returns
    the launches."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        ContinuousBatchingEngine)
    from distributed_pytorch_from_scratch_tpu_torch.serving.loadgen import (
        synthetic_requests)
    layers = model_preset("45m").num_layers
    reqs = synthetic_requests(REPLAY_REQUESTS, 64, 512, 64, 1024, seed=5,
                              rate=REPLAY_RATE, arrival="poisson")
    path = os.path.join(workdir, "trace.jsonl")
    with open(path, "w") as f:
        for r in reversed(reqs):
            f.write(json.dumps({"rid": r.rid, "prompt": r.prompt,
                                "max_new": r.max_new, "seed": r.seed,
                                "arrival": r.arrival}) + "\n")
    order = []
    submit = ContinuousBatchingEngine.submit

    def seen(self, req):
        order.append(req.rid)
        return submit(self, req)

    args = (_replace_flag(SERVE_ARGS, "--arrival", "replay")
            + ["--replay", path, "--tokenizer_path", TOKENIZER])
    _reset_launches()
    ContinuousBatchingEngine.submit = seen
    try:
        out = serve.main(args)
    finally:
        ContinuousBatchingEngine.submit = submit
    counts = _read_launches()
    want = [r.rid for r in sorted(reqs, key=lambda r: r.arrival)]
    log(f"serve_replay: {out['completed']}/{out['requests']} requests of the "
        f"trace in {out['wall_s']} s, submitted in arrival order "
        f"{order == want}; {out['tokens_per_sec']} tok/s; TTFT p50/p95 "
        f"{out['ttft_ms_p50']}/{out['ttft_ms_p95']} ms; TPOT p50/p95 "
        f"{out['tpot_ms_p50']}/{out['tpot_ms_p95']} ms; queue p50/p95 "
        f"{out['queue_wait_ms_p50']}/{out['queue_wait_ms_p95']} ms; launches "
        f"{counts}")
    if (order != want or out["completed"] != REPLAY_REQUESTS
            or out["requests"] != REPLAY_REQUESTS):
        raise AssertionError("the trace was not served whole in arrival "
                             "order")
    if not all(0 <= t < 1024 for ts in out["outputs"].values() for t in ts):
        raise AssertionError("replayed tokens outside the tokenizer's vocab")
    _only(counts, {"flash_attention_fwd": layers * out["prefill_dispatches"]},
          f"replayed slot serving ({layers} per prefill dispatch)")
    return counts


# speculative decoding (slice 16): k = 4 drafts per round, so the verify
# launches K3's chunk route at (16 slot rows, 8 heads, k + 1 = 5, 64) with
# each row's own start and valid length (0 for a row not decoding); the
# drafter is the `tiny` preset (head_dim 32) reshaped to the target's vocab
SPEC_K = 4
SPEC_WIDTHS = (2, 3, 5, 9)           # k + 1 for k = 1, 2, 4, 8
# the speculative runs serve the paged mix's first 8 requests
SPEC_SERVE_ARGS = _replace_flag(PAGED_SERVE_ARGS, "--num_requests",
                                "8") + ["--speculate", str(SPEC_K)]
SPEC_F32_REQUESTS = 8                # spec_serve's f32 identity burst
SPEC_MIN_SELF_ACCEPT = 0.95          # drafter = target, f32


def _spec_cases(torch) -> list:
    """(what, b, h, kvh, cw, hd, ps, mp, int8, starts, qlens): the verify's
    launches at every width of SPEC_WIDTHS, each row's window anywhere in
    its 11-page table (several pages in) and qlen cycling 0..cw over the 16
    rows, native and int8 pools; then the drafter's decode steps at head_dim
    32 (4 heads), 16 rows."""
    import numpy as np
    rng = np.random.default_rng(16)
    cases = []
    for cw in SPEC_WIDTHS:
        for int8 in (False, True):
            starts = [int(x) for x in rng.integers(0, 11 * 64 - cw + 1, 16)]
            cases.append((f"verify cw {cw}, qlen 0..{cw} by row", 16, 8, 8,
                          cw, 64, 64, 11, int8, starts,
                          [r % (cw + 1) for r in range(16)]))
    for int8 in (False, True):
        starts = [int(x) for x in rng.integers(0, 11 * 64, 16)]
        cases.append(("drafter decode, head_dim 32", 16, 4, 4, 1, 32, 64, 11,
                      int8, starts, None))
    return cases


def _spec_verify_times(torch, int8: bool) -> dict:
    """K3 at the verify's shape q (16, 8, 5, 64) bf16, every row live at
    qlen 5 from a cursor in [64, 576): bare launches (events), device
    time, the plain version, SDPA over the gathered view with the mask
    (device time) and the bound; held against the plain version first."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.models.decode import (
        _gather_page_view)
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        _prepare, paged_attention, paged_attention_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, cw, hd, ps, mp = 16, 8, SPEC_K + 1, 64, 64, 11
    starts = [int(x) for x in np.random.default_rng(11).integers(64, 576, b)]
    qlens = [cw] * b
    q, kp, vp, tbl = _paged_inputs(torch, b, h, h, cw, hd, ps, mp,
                                   torch.bfloat16, int8, 316)
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    kw = dict(page_size=ps, qlen=torch.tensor(qlens, dtype=torch.int32,
                                              device="cuda"))
    o = paged_attention(q, kp, vp, tbl, start, **kw)
    ro = paged_attention_plain(q, kp, vp, tbl, start, **kw)
    err, ratio = _paged_err(torch, o, ro, qlens, "bfloat16")
    if not ratio <= 1.0:
        raise AssertionError(f"paged kernel disagrees with its plain version "
                             f"at the verify shape (int8 {int8})")
    pos = start[:, None] + torch.arange(cw, device="cuda")[None, :]
    kview = _gather_page_view(kp, tbl, torch.bfloat16)
    vview = _gather_page_view(vp, tbl, torch.bfloat16)
    mask = (torch.arange(mp * ps, device="cuda")[None, None, :]
            <= pos[:, :, None])[:, None]
    _, _, launch = _prepare(q, kp, vp, tbl, start, **kw)
    stream = torch.cuda.current_stream().cuda_stream
    kernel_ms = _time_ms(torch, lambda: launch(stream))
    plain_ms = _time_ms(torch, lambda: paged_attention_plain(
        q, kp, vp, tbl, start, **kw), iters=20)
    library = lambda: sdpa(q, kview, vview, attn_mask=mask)
    (device_ms, library_ms), how = _device_ms(
        torch, [lambda: launch(stream), library])
    # the library call by events too (host included): a second reading of
    # its time that no profiler session can miss
    library_events_ms = _time_ms(torch, library)
    work = (b, h, h, cw, hd, ps, mp, starts, qlens, 2, int8)
    bound_ms, bound_by = bound_paged(*work)
    tflops = paged_work(*work)[1] / (device_ms * 1e-3) / 1e12
    log(f"spec_check verify shape q({b}, {h}, {cw}, {hd}) bf16, "
        f"{'int8' if int8 else 'bf16'} pool, every row qlen {cw}: kernel_ms "
        f"{kernel_ms:.5f} (bare launches, CUDA events over 100), device_ms "
        f"{device_ms:.5f} ({how}), {tflops:.2f} TFLOP/s of the visible "
        f"pairs, plain_ms {plain_ms:.5f} (events over 20), library_ms "
        f"{library_ms:.5f} (scaled_dot_product_attention over the "
        f"pre-gathered view with the mask, {how}; by CUDA events over 100 "
        f"calls {library_events_ms:.5f}), bound_us "
        f"{bound_ms * 1e3:.3f} ({bound_by}); max abs err vs plain {err:.3e}; "
        f"cursors {starts}")
    return {"ms": kernel_ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_events_ms": library_events_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "shape": f"verify q ({b}, {h}, {cw}, {hd}), page_size {ps}, "
                     f"bf16, {'int8' if int8 else 'bf16'} pool"}


def phase_spec_check(torch) -> dict:
    """K3 at the speculative path's shapes against its plain version: the
    verify's multi-row chunk launches (16 rows, 8 heads, hd 64, cw 2, 3, 5
    and 9, per-row start over several pages and qlen 0..cw) and the tiny
    drafter's decode steps (hd 32), bf16 and f32, native and int8 pools,
    under phase 13's limits (rows of qlen 0: finite, not compared); one
    launch per call on the route and kernel `kernel_route` names; two bf16
    verify calls bit-equal; then the verify shape's times. Returns the
    largest bf16 error per route and the times."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        kernel_route, paged_attention, paged_attention_plain)
    by_route = paged_attention.launches_by_route
    by_kernel = paged_attention.launches_by_kernel
    worst = {"decode": 0.0, "chunk": 0.0}
    for i, (what, b, h, kvh, cw, hd, ps, mp, int8, starts,
            qlens) in enumerate(_spec_cases(torch)):
        for name in ("bfloat16", "float32"):
            q, kp, vp, tbl = _paged_inputs(torch, b, h, kvh, cw, hd, ps, mp,
                                           getattr(torch, name), int8, 400 + i)
            start = torch.tensor(starts, dtype=torch.int32, device="cuda")
            kw = dict(page_size=ps, return_lse=True,
                      qlen=None if qlens is None else torch.tensor(
                          qlens, dtype=torch.int32, device="cuda"))
            route = "decode" if cw == 1 else "chunk"
            entry = kernel_route(cw, q.dtype, hd)[1]
            n, n_route, n_entry = (paged_attention.launches, by_route[route],
                                   by_kernel[entry])
            o, lse = paged_attention(q, kp, vp, tbl, start, **kw)
            torch.cuda.synchronize()
            launched = (paged_attention.launches - n, by_route[route] - n_route,
                        by_kernel[entry] - n_entry)
            ro, rlse = paged_attention_plain(q, kp, vp, tbl, start, **kw)
            valid = [cw if qlens is None else qlens[r] for r in range(b)]
            rows = [r for r in range(b) if valid[r]]
            err, ratio = _paged_err(torch, o[rows], ro[rows],
                                    [valid[r] for r in rows], name)
            lse_err = max((lse[r, :, :valid[r]] - rlse[r, :, :valid[r]])
                          .abs().max().item() for r in rows)
            finite = bool(torch.isfinite(o.float()).all())
            log(f"spec_check: {what}: q({b}, {h}, {cw}, {hd}) kvh {kvh} "
                f"{name}, {'int8' if int8 else 'native'} pool: o max abs err "
                f"{err:.3e}, worst err/limit {ratio:.3e} (limit "
                f"{PAGED_LIMIT[name]}), lse {lse_err:.3e} (limit 1e-4) over "
                f"{len(rows)} rows with columns; finite {finite}; launches "
                f"{launched[0]}, {launched[1]} on the {route} route, "
                f"{launched[2]} of {entry}")
            if not (ratio <= 1.0 and lse_err <= 1e-4 and finite
                    and launched == (1, 1, 1)):
                raise AssertionError(f"paged kernel disagrees with its plain "
                                     f"version at the speculative shape: "
                                     f"{what} {name} int8 {int8}")
            if name == "bfloat16":
                worst[route] = max(worst[route], err)
    # a captured verify replays the same launch: two calls, the same bits
    what, b, h, kvh, cw, hd, ps, mp, int8, starts, qlens = _spec_cases(
        torch)[2 * SPEC_WIDTHS.index(SPEC_K + 1)]
    q, kp, vp, tbl = _paged_inputs(torch, b, h, kvh, cw, hd, ps, mp,
                                   torch.bfloat16, int8, 450)
    args = (q, kp, vp, tbl, torch.tensor(starts, dtype=torch.int32,
                                         device="cuda"))
    kw = dict(page_size=ps, return_lse=True, qlen=torch.tensor(
        qlens, dtype=torch.int32, device="cuda"))
    first, again = paged_attention(*args, **kw), paged_attention(*args, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(first, again))
    log(f"spec_check: verify twice, q({b}, {h}, {cw}, {hd}) bf16: bit-equal "
        f"{same}")
    if not same:
        raise AssertionError("two verify-shape chunk calls differ")
    return {"worst": worst, "verify": _spec_verify_times(torch, False),
            "verify_int8": _spec_verify_times(torch, True)}


def _spec_launches(out: dict, layers: int, dlayers: int) -> dict:
    """K3's launches a speculative run implies, by route, from its
    dispatches: per round (k+1) drafter decode steps (decode route) and one
    verify (chunk route, width k+1); per chunk dispatch, target or drafter,
    its layers on the route its width names (a one-position chunk is
    decode-shaped)."""
    shapes = out["ranks"][0]["dispatch_shapes"]
    count = lambda kind, one: sum(n for k, s, n in shapes
                                  if k == kind and (s[0] == 1) == one)
    rounds = out["engine_stats"]["spec_rounds"]
    return {"decode": (dlayers * (SPEC_K + 1) * rounds
                       + dlayers * count("drafter_chunk", True)
                       + layers * count("paged_chunk", True)),
            "chunk": (layers * rounds
                      + dlayers * count("drafter_chunk", False)
                      + layers * count("paged_chunk", False))}


def _spec_line(name: str, out: dict, by_route: dict) -> None:
    st = out["engine_stats"]
    log(f"spec_serve {name}: {out['completed']}/{out['requests']} requests, "
        f"{out['generated_tokens']} tokens in {out['wall_s']} s -> "
        f"{out['tokens_per_sec']} tok/s; TTFT p50/p95 {out['ttft_ms_p50']}/"
        f"{out['ttft_ms_p95']} ms; TPOT p50/p95 {out['tpot_ms_p50']}/"
        f"{out['tpot_ms_p95']} ms; "
        + (f"k {st['speculate_k']}, {st['spec_rounds']} rounds, accepted "
           f"tokens per dispatch {st['accepted_tokens_per_dispatch']}, "
           f"acceptance {st['acceptance_rate']} by position "
           f"{st['acceptance_rate_by_position']}, drafter/target ms "
           f"{st['drafter_ms_total']}/{st['target_ms_total']}, drafter pages "
           f"{st['drafter_num_pages']} (in use after the drain "
           f"{st['drafter_pages_in_use']}); " if "speculate_k" in st else
           f"{st['decode_steps']} decode steps; ")
        + f"preemptions {st['preemptions']}, COW copies {st['cow_copies']}, "
        f"pages in use after the drain {st['pages_in_use']}; decode graph "
        f"{out['decode_graph']} ({out['decode_graph_replays']} replays); K3 "
        f"launches by route {by_route}")


def _check_spec_run(name, out, counts, by_route, by_kernel, layers,
                    dlayers) -> None:
    """A speculative serve run: every request served in-vocab, both pools
    drained, prefix hits and COW, no plain decode step, the round's two
    graphs replayed once per round, and K3's launches exactly
    `_spec_launches`' on the routes and kernels they name (bf16: the wgmma
    chunk kernel, never the SIMT one), no other kernel."""
    st, disp = out["engine_stats"], out["ranks"][0]["dispatches"]
    toks = [t for ts in out["outputs"].values() for t in ts]
    if (out["completed"] != out["requests"] or not toks
            or not all(0 <= t < 1024 for t in toks)):
        raise AssertionError(f"spec {name}: requests unserved or tokens "
                             f"outside the vocab")
    if (st["pages_in_use"] or st["drafter_pages_in_use"]
            or st["prefix_hit_tokens"] <= 0 or st["cow_copies"] <= 0):
        raise AssertionError(f"spec {name}: pools not drained or no prefix "
                             f"sharing: {st}")
    if (disp["paged_decode"] or disp["spec_draft"] != st["spec_rounds"]
            or disp["spec_verify"] != st["spec_rounds"]
            or not out["decode_graph"]
            or out["decode_graph_replays"] != st["spec_rounds"]):
        raise AssertionError(f"spec {name}: dispatches {disp}, graph "
                             f"{out['decode_graph']} x "
                             f"{out['decode_graph_replays']}, rounds "
                             f"{st['spec_rounds']}")
    want = _spec_launches(out, layers, dlayers)
    if by_route != want or by_kernel != {
            "paged_decode": want["decode"], "paged_chunk_sm90": want["chunk"],
            "paged_attn": 0}:
        raise AssertionError(f"spec {name}: K3 launches by route {by_route}, "
                             f"by kernel {by_kernel}, expected {want}")
    _only(counts, {"paged_attention": want["decode"] + want["chunk"]},
          f"speculative serving {name}")


def _spec_engine_run(torch, model, drafter, argv: list) -> tuple:
    """The serve CLI's `--speculate 4` run of `argv` at tp = 1 with the
    given target and drafter modules: the same requests, buffer and engine
    knobs, through the loadgen. Returns (summary, engine)."""
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    from distributed_pytorch_from_scratch_tpu_torch.config import MeshConfig
    from distributed_pytorch_from_scratch_tpu_torch.serving import (
        loadgen, serve)
    from distributed_pytorch_from_scratch_tpu_torch.serving.scheduler import (
        parse_slo_classes)
    from distributed_pytorch_from_scratch_tpu_torch.serving.speculative import (
        SpeculativeEngine)
    args = serve.get_serve_args(argv)
    requests = loadgen.synthetic_requests(
        args.num_requests, args.prompt_len_min, args.prompt_len_max,
        args.max_new_tokens, args.vocab_size, seed=args.seed,
        arrival=args.arrival, class_mix=parse_slo_classes(args.class_mix)
        if args.class_mix else None, tenants=args.tenants,
        shared_prefix_len=args.shared_prefix_len, interleave=args.interleave)
    eng = SpeculativeEngine(
        model, make_mesh(MeshConfig(), device="cuda"), drafter,
        speculate_k=SPEC_K, num_slots=args.slots,
        buf_len=max(len(r.prompt) for r in requests) + args.max_new_tokens
        + 2, eos_id=1, page_size=args.page_size, num_pages=args.num_pages,
        prefill_chunk=args.prefill_chunk,
        slo_classes=parse_slo_classes(args.slo_classes))
    return loadgen.run_loadgen(eng, requests), eng


def _live_spec_engine(torch, model, drafter, sampled: bool):
    """A speculative engine at phase 15's engine shape (16 slots, page 64,
    chunk 128, k 4), its round graphed, every slot live on a 512-token
    prompt that EOS never ends, a few rounds in."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import MeshConfig
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        Request)
    from distributed_pytorch_from_scratch_tpu_torch.serving.speculative import (
        SpeculativeEngine)
    vocab = model.cfg.vocab_size
    eng = SpeculativeEngine(
        model, make_mesh(MeshConfig(), device="cuda"), drafter,
        num_slots=16, buf_len=642, eos_id=vocab, page_size=64,
        prefill_chunk=128, speculate_k=SPEC_K,
        **(dict(temperature=0.8, top_k=50, top_p=0.95) if sampled else {}))
    rng = np.random.default_rng(1)
    for i in range(16):
        eng.submit(Request(rid=i, prompt=[int(x) for x in rng.integers(
            3, vocab, 512)], max_new=120, seed=i))
    while eng.scheduler.pending or eng._prefilling:
        eng.step()
    for _ in range(3):
        eng.step()
    return eng


def _round_vs_eager(torch, eng) -> tuple:
    """The next round run eagerly and by the two graphs' replays (a round
    writes the same K/V at the same places each time, so both see the same
    pools): ({drafts, q, verdicts: bitwise equal on the live rows}, live
    rows)."""
    draft, verify, _ = eng._round_payloads()
    live = sorted(eng._slot_req)
    dev = lambda a: torch.from_numpy(a).to(eng.device)
    graphed = eng._draft_out
    with torch.inference_mode():
        eng._draft_out = [x.clone() for x in eng._draft_body(dev(draft))]
        eager = eng._draft_out + [eng._verify_body(dev(verify)).clone()]
        eng._draft_out = graphed
        eng._round_graphs[0](draft)
        got = [x.clone() for x in graphed] + [eng._round_graphs[1](
            verify).clone()]
    names = ("drafts", "q", "verdicts") if len(got) == 3 else ("drafts",
                                                               "verdicts")
    return ({n: torch.equal(a[live], b[live])
             for n, a, b in zip(names, eager, got)}, len(live))


def phase_spec_serve(torch) -> dict:
    """`serve --paged --speculate 4` at the 45m preset, bf16, on phase 15's
    mix with the `tiny` drafter (random, vocab 1024), greedy and then
    sampled (`_check_spec_run`; K3 launches counted per route); at f32
    the speculative and plain paged greedy tokens
    of an 8-request burst identical; then, engine level on the card:
    drafter = target at f32 accepting >= 0.95 of its drafts; one round of
    a live engine,
    greedy and sampled, by the draft and verify graphs bitwise the eager
    round. Returns the runs' K3 launches and numbers."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        paged_attention)
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    layers = model_preset("45m").num_layers
    dlayers = model_preset("tiny").num_layers
    res = {}
    for name, extra in (("greedy", []), ("sampled", SAMPLED_ARGS)):
        _reset_launches()
        out = serve.main(SPEC_SERVE_ARGS + extra)
        counts = _read_launches()
        by_route = dict(paged_attention.launches_by_route)
        by_kernel = dict(paged_attention.launches_by_kernel)
        _spec_line(name, out, by_route)
        _check_spec_run(name, out, counts, by_route, by_kernel, layers,
                        dlayers)
        res[name] = {"by_route": by_route, "by_kernel": by_kernel,
                     "launches": counts["paged_attention"],
                     "stats": out["engine_stats"],
                     "tpot_ms_p50": out["tpot_ms_p50"]}
    # f32: the speculative engine's greedy tokens are the plain engine's
    f32 = (_replace_flag(PAGED_SERVE_ARGS, "--num_requests",
                         str(SPEC_F32_REQUESTS)) + ["--no-bf16"])
    outs = {n: serve.main(f32 + extra)
            for n, extra in (("plain", []), ("spec", ["--speculate",
                                                      str(SPEC_K)]))}
    same = outs["spec"]["outputs"] == outs["plain"]["outputs"]
    log(f"spec_serve f32 burst of {SPEC_F32_REQUESTS}: speculative tokens "
        f"identical to the plain paged engine's {same} (acceptance "
        f"{outs['spec']['engine_stats']['acceptance_rate']})")
    if not same:
        raise AssertionError("f32 speculative tokens differ from the plain "
                             "paged engine's")
    # drafter = target at f32
    model = Transformer(model_preset("45m", compute_dtype="float32")
                        ).init_weights(seed=0).cuda()
    out, eng = _spec_engine_run(torch, model, model, f32)
    st = eng.stats()
    log(f"spec_serve drafter = target (float32, {out['requests']} "
        f"requests): acceptance {st['acceptance_rate']} by position "
        f"{st['acceptance_rate_by_position']}, accepted tokens per dispatch "
        f"{st['accepted_tokens_per_dispatch']}, TPOT p50/p95 "
        f"{out['tpot_ms_p50']}/{out['tpot_ms_p95']} ms, TTFT p50 "
        f"{out['ttft_ms_p50']} ms, drafter/target ms "
        f"{st['drafter_ms_total']}/{st['target_ms_total']}")
    if out["completed"] != out["requests"]:
        raise AssertionError("drafter = target f32: requests unserved")
    if st["acceptance_rate"] < SPEC_MIN_SELF_ACCEPT:
        raise AssertionError(f"drafter = target at f32 accepted "
                             f"{st['acceptance_rate']} of its drafts, under "
                             f"{SPEC_MIN_SELF_ACCEPT}")
    res["self_float32"] = {"acceptance_rate": st["acceptance_rate"],
                           "tpot_ms_p50": out["tpot_ms_p50"]}
    del model, eng
    # the round's two graphs against the eager round: one round of a live
    # engine both ways, greedy and sampled
    model = Transformer(model_preset("45m", compute_dtype="bfloat16")
                        ).init_weights(seed=0).cuda()
    drafter = Transformer(model_preset("tiny", compute_dtype="bfloat16")
                          ).init_weights(seed=1).cuda()
    for sampled in (False, True):
        same, live = _round_vs_eager(torch, _live_spec_engine(
            torch, model, drafter, sampled))
        log(f"spec_serve one round ({'sampled' if sampled else 'greedy'}, "
            f"bf16, {live} live rows): the graphs' drafts, q and verdicts "
            f"bitwise the eager round's {same}")
        if not all(same.values()):
            raise AssertionError(f"the captured round differs from the "
                                 f"eager round: {same}")
    return res


# K3 at the cp engine's shapes (phase 13's tuple): cp rank 1 of a 45m
# buffer of ~1000 positions, a 16-column table of 64-position pages, so its
# 8 local columns start at position 512 (`pos_offset`); the ranks before it
# (rows 0-2) see nothing there and must give o = 0 and lse = -1e30 exactly
CP_PAGED_CASES = [
    ("cp 2 rank 1 decode, 8 slots: rows dead before 512, partly visible "
     "past it", 8, 8, 8, 1, 64, 64, 8, False,
     [0, 300, 511, 512, 513, 700, 900, 1023], None, 512),
    ("cp 2 rank 1 decode, int8 pools", 8, 8, 8, 1, 64, 64, 8, True,
     [0, 300, 511, 512, 513, 700, 900, 1023], None, 512),
    ("cp 2 rank 1 chunk cw 128: a dead row, a row across 512, a visible "
     "row", 3, 8, 8, 128, 64, 64, 8, False, [384, 448, 600], None, 512),
    ("cp 2 rank 1 chunk cw 128, int8 pools", 3, 8, 8, 128, 64, 64, 8, True,
     [384, 448, 600], None, 512),
    ("cp 2 rank 1 verify width 6 (k 4), 8 slots, qlen 0..5", 8, 8, 8, 6, 64,
     64, 8, False, [0, 100, 505, 509, 512, 700, 890, 1017],
     [5, 5, 5, 5, 3, 5, 0, 5], 512),
    ("cp 2 rank 1 verify width 6, int8 pools", 8, 8, 8, 6, 64, 64, 8, True,
     [0, 100, 505, 509, 512, 700, 890, 1017], [5, 5, 5, 5, 3, 5, 0, 5],
     512),
]
CP_ONE_BASE = ["--model", "45m", "--random_init", "--vocab_size", "1024",
               "--bf16", "--paged", "--page_size", "64", "--prefill_chunk",
               "128"]
CP_SERVE_BASE = CP_ONE_BASE + ["--cp", "2", "--dist_backend", "gloo"]
# 4 burst requests of 512-880 tokens (a 96-token shared prefix ending
# mid-page + 416-784 of their own), 16 new tokens each, 8 slots
CP_SERVE_RUNS = {
    "serve_paged_cp2": ["--shared_prefix_len", "96", "--num_requests", "4",
                        "--arrival", "burst", "--prompt_len_min", "416",
                        "--prompt_len_max", "784", "--max_new_tokens", "16",
                        "--slots", "8"],
}
CP_SERVE_RUNS["serve_paged_cp2_int8"] = (CP_SERVE_RUNS["serve_paged_cp2"]
                                         + ["--kv_dtype", "int8"])
# the equal-bytes request: 880 + 16 tokens = 14 pages of 64. cp 1 holding
# 12 pages refuses it at submit; cp 2 holding 24 (12 per rank: the same
# bytes per rank) serves it
CP_EQUAL = ["--num_requests", "1", "--arrival", "burst", "--prompt_len_min",
            "880", "--prompt_len_max", "880", "--max_new_tokens", "16",
            "--slots", "1"]


def _cp_card_vs_cpu_calls(cfg, seed: int) -> list:
    """decode_logits' calls: one chunk dispatch of two rows over a whole
    pool of 8 random pages — the first chunk of a prompt (positions
    0-127) and a chunk at 128-227 that crosses into cp rank 1's columns
    over a random 128-position prefix on rank 0's — every position's
    logits."""
    import numpy as np
    rng = np.random.default_rng(seed)
    L, ps, pages = cfg.num_layers, 64, 8
    shape = (L, pages + 1, cfg.kv_heads, ps, cfg.head_dim)
    pool = lambda: rng.standard_normal(shape).astype(np.float32)
    # columns 0-1 belong to rank 0 (pages 0-3), 2-3 to rank 1 (pages 4-7)
    tbl = np.array([[0, 1, 4, 5], [2, 3, 6, 7]], np.int32)
    start = np.array([0, 128], np.int32)
    qlen = np.array([128, 100], np.int32)
    dstp = np.full((2, 128), pages, np.int32)
    dsto = np.tile(np.arange(128, dtype=np.int32) % ps, (2, 1))
    for r in range(2):
        for i in range(qlen[r]):
            dstp[r, i] = tbl[r, (start[r] + i) // ps]
            dsto[r, i] = (start[r] + i) % ps
    chunk = rng.integers(3, cfg.vocab_size, (2, 128)).astype(np.int32)
    return [dict(kind="paged_chunk", page_size=ps, all_logits=True,
                 args=(pool(), pool(), chunk, start, qlen, tbl, dstp, dsto))]


def phase_cp_serve_check(torch) -> dict:
    """K3 at the cp engine's shapes (CP_PAGED_CASES: rank 1's local slab
    at pos_offset 512 with return_lse, dead and partly visible rows,
    int8 pools, the verify width 6) against its plain version under phase
    13's limits; then the 45m widths at 2 layers, f32, in one gloo group
    of two ranks on the card and on the CPU: the paged engine at cp 2 on
    the card gives the greedy tokens of cp 1 on the card and of cp 2 on
    the CPU's plain path, and a chunk dispatch's logits at every position
    (the first chunk of a prompt, and one across the ranks' columns) are
    within 1e-4 (of the largest |logit|, at least 1) of cp 1's on the
    card. Returns the worst bf16 K3 error per route."""
    import dataclasses
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.interop import (
        params_to_jax)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        launch, tp_checks)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
    worst = _paged_cases(torch, CP_PAGED_CASES, 300)
    cfg = model_preset("45m", num_layers=2, compute_dtype="float32")
    tree = params_to_jax(Transformer(cfg).init_weights(seed=9).state_dict())
    runs = [_tp_serve_cases(cfg, 9)[1]]          # the paged engine's run
    calls = _cp_card_vs_cpu_calls(cfg, 9)
    kw = dict(cfg=dataclasses.asdict(cfg), tree=tree)
    todo = [("serve_runs", {"cp": 2}, dict(kw, runs=runs)),
            ("decode_logits", {"cp": 2}, dict(kw, calls=calls))]
    cp2 = launch.spawn(tp_checks.jobs, 2, todo, ("cuda", "cpu"), "gloo")
    mesh = make_mesh(MeshConfig(), device="cuda")
    one = (tp_checks.serve_runs(mesh, kw["cfg"], tree, runs),
           tp_checks.decode_logits(mesh, kw["cfg"], tree, calls))
    card, cpu = (cp2[0][0][0], cp2[1][0][0]), (cp2[0][2][0], cp2[1][2][0])
    toks = card[0]["tokens"]
    same = lambda other: sum(toks[r] == other[r] for r in toks)
    keys = ("cp", "pages_per_rank", "cow_copies", "prefix_hit_tokens",
            "preemptions")
    log(f"cp serve card vs cpu (paged engine, 45m widths, 2 layers, f32, "
        f"{len(toks)} requests of 160-296 tokens x 16 new, pages of 64 over "
        f"cp 2): cp=2 on the card token-identical to cp=1 on the card for "
        f"{same(one[0][0]['tokens'])}, to cp=2 on the CPU for "
        f"{same(cpu[0]['tokens'])} of {len(toks)} requests; stats "
        f"{ {k: card[0]['stats'][k] for k in keys} }; "
        f"rank dispatches {card[0]['dispatches']} / {card[1]['dispatches']}"
        f", cp hops per rank {card[0]['cp_hops']} / {card[1]['cp_hops']}")
    if not toks == one[0][0]["tokens"] == cpu[0]["tokens"]:
        raise AssertionError("cp=2 paged tokens differ from cp=1's or the "
                             "CPU's")
    if not (card[0]["dispatches"] == card[1]["dispatches"]
            and card[0]["drained"] and card[0]["stats"]["cp"] == 2):
        raise AssertionError("the cp=2 ranks ran different dispatches or "
                             "the pool did not drain")
    lg2, lg1 = cp2[0][1][0], one[1][0]
    lgc, valid = cp2[0][3][0], calls[0]["args"][4]
    scale = max(1.0, float(np.abs(lg1).max()))
    diff = lambda a: max(float(np.abs(a[r, :n] - lg1[r, :n]).max())
                         for r, n in enumerate(valid))
    equal = bool(np.array_equal(lg2, cp2[1][1][0]))
    log(f"cp serve card vs cpu: a chunk dispatch's logits at every position "
        f"(the first chunk, 128 positions; one of 100 across the ranks' "
        f"columns) at cp=2 vs cp=1 on the card: max abs diff "
        f"{diff(lg2):.3e} (limit 1e-4 x {scale:.3f}); cp=2 on the CPU vs "
        f"cp=1 on the card {diff(lgc):.3e}; the ranks' logits equal: "
        f"{equal}")
    if not (diff(lg2) <= 1e-4 * scale and diff(lgc) <= 1e-4 * scale
            and equal):
        raise AssertionError("cp=2 chunk logits disagree with cp=1's")
    return worst


def _check_cp_serve_rank(name, r, layers) -> None:
    """One rank of a cp=2 serve run: K3 exactly L per decode step on the
    decode kernel and L per chunk dispatch on the wgmma chunk kernel (at cp
    2 every chunk is at least 2 wide), nothing else; L cp hops per model
    dispatch, no tp hop; two dispatch broadcasts per dispatch and the
    stop."""
    d, what = r["dispatches"], f"{name} rank {r['rank']}"
    steps, chunks = d["paged_decode"], d["paged_chunk"]
    _only(r["launches"], {"paged_attention": layers * (steps + chunks)},
          f"{what} ({layers} x (decode steps + chunks))")
    want = {"paged_decode": layers * steps,
            "paged_chunk_sm90": layers * chunks, "paged_attn": 0}
    if r["paged_launches_by_kernel"] != want:
        raise AssertionError(f"{what}: paged launches by kernel "
                             f"{r['paged_launches_by_kernel']}, expected "
                             f"{want}")
    if (r["cp_hops"]["calls"], r["tp_hops"]["calls"]) != (
            layers * (steps + chunks), 0):
        raise AssertionError(f"{what}: {r['cp_hops']['calls']} cp hops and "
                             f"{r['tp_hops']['calls']} tp hops over "
                             f"{steps + chunks} model dispatches, expected "
                             f"{layers} cp hops each and no tp hop")
    if r["dispatch_broadcasts"]["calls"] != 2 * sum(d.values()) + 1:
        raise AssertionError(f"{what}: {r['dispatch_broadcasts']['calls']} "
                             f"dispatch broadcasts for {sum(d.values())} "
                             f"dispatches")


def phase_cp_serve(torch) -> dict:
    """`serve --paged --cp 2 --dist_backend gloo` at the 45m preset, bf16,
    two ranks on the card, each holding half the KV pages: 8 burst
    requests of 512-880 tokens behind a 96-token shared prefix, 16 new
    tokens, with bf16 and with int8 pages; then the equal-bytes request
    (880 + 16 tokens, 14 pages of 64) refused at submit by cp=1 over 12
    pages and served by cp=2 over 24 (12 per rank). Checks: every request served in-vocab, the ranks in
    lockstep (dispatches by kind and shape), COW copies and prefix hits,
    no page left in use, each rank's pool bytes (page bytes x (pages per
    rank + its scratch page)), exact K3 launches and cp hops per rank
    (`_check_cp_serve_rank`). Returns each run's launches summed over the
    ranks."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    from distributed_pytorch_from_scratch_tpu_torch.serving.kv_manager import (
        page_bytes)
    cfg = model_preset("45m", compute_dtype="bfloat16")
    layers = cfg.num_layers
    one = serve.main(CP_ONE_BASE + CP_EQUAL + ["--num_pages", "12"])
    if (one["completed"], one["invalid"]) != (0, 1):
        raise AssertionError(f"cp=1 over 12 pages: {one['completed']} "
                             f"served, {one['invalid']} refused; expected "
                             f"the 14-page request refused")
    names = list(CP_SERVE_RUNS) + ["serve_paged_cp2_equal_bytes"]
    argvs = [CP_SERVE_BASE + f for f in CP_SERVE_RUNS.values()] + [
        CP_SERVE_BASE + CP_EQUAL + ["--num_pages", "24"]]
    res = {}
    for name, out in zip(names, [serve.main(a) for a in argvs]):
        ranks, st = out["ranks"], out["engine_stats"]
        toks = [t for ts in out["outputs"].values() for t in ts]
        if out["completed"] != out["requests"] or not toks or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{name}: served {out['completed']} of "
                                 f"{out['requests']}, tokens in the vocab "
                                 f"{bool(toks)}")
        if not all(r["dispatches"] == ranks[0]["dispatches"] and
                   r["dispatch_shapes"] == ranks[0]["dispatch_shapes"]
                   for r in ranks):
            raise AssertionError(f"{name}: the ranks ran different "
                                 f"dispatches")
        for r in ranks:
            _check_cp_serve_rank(name, r, layers)
        kv = st["kv_dtype"]
        each = page_bytes(cfg, 64, None if kv == "native" else kv)
        want_bytes = each * (st["pages_per_rank"] + 1)
        if any(r["pool_bytes"] != want_bytes for r in ranks) or (
                st["cp"], st["pages_per_rank"] * 2) != (2, st["num_pages"]):
            raise AssertionError(f"{name}: pool bytes "
                                 f"{[r['pool_bytes'] for r in ranks]}, "
                                 f"expected {want_bytes} on each rank")
        if st["pages_in_use"] or st["preemptions"] or (
                "equal" not in name and (st["cow_copies"] <= 0
                                         or st["prefix_hit_tokens"] <= 0)):
            raise AssertionError(f"{name}: COW copies {st['cow_copies']}, "
                                 f"prefix hits {st['prefix_hit_tokens']}, "
                                 f"preemptions {st['preemptions']}, pages "
                                 f"in use {st['pages_in_use']}")
        d = ranks[0]["dispatches"]
        hops = ranks[0]["cp_hops"]
        host_s = hops["wait_s"] + hops["hop_s"]
        log(f"cp serve {name} (45m bf16, {kv} pages, cp=2 over gloo on one "
            f"card): {out['completed']}/{out['requests']} requests, "
            f"{out['generated_tokens']} tokens in {out['wall_s']} s -> "
            f"{out['tokens_per_sec']} tok/s; TTFT p50/p95 "
            f"{out['ttft_ms_p50']}/{out['ttft_ms_p95']} ms; TPOT p50/p95 "
            f"{out['tpot_ms_p50']}/{out['tpot_ms_p95']} ms; dispatches per "
            f"rank {d} (lockstep checked); pages_per_rank "
            f"{st['pages_per_rank']} of {st['num_pages']}; pool bytes per "
            f"rank {[r['pool_bytes'] for r in ranks]} (one pool of "
            f"{st['num_pages']} pages: {each * (st['num_pages'] + 1)}); cp "
            f"hops per model "
            f"dispatch {layers} (checked), rank 0 {hops['calls']} hops, "
            f"{hops['bytes'] / max(hops['calls'], 1) / 1e3:.3f} KB each on "
            f"average, host {host_s:.3f} s (wait {hops['wait_s']:.3f} + hop "
            f"{hops['hop_s']:.3f}) = "
            f"{host_s / max(hops['calls'], 1) * 1e3:.3f} ms per hop, "
            f"{host_s / ranks[0]['wall_s']:.3f} of rank 0's "
            f"{ranks[0]['wall_s']:.3f} s; COW copies {st['cow_copies']}, "
            f"prefix hit tokens {st['prefix_hit_tokens']}; K3 launches per "
            f"rank by kernel {ranks[0]['paged_launches_by_kernel']}")
        summed = {}
        for r in ranks:
            for k, v in r["paged_launches_by_kernel"].items():
                summed[k] = summed.get(k, 0) + v
        res[name] = {"paged_by_kernel": summed, "summary": out}
    log(f"cp serve equal bytes: a request of 880 + 16 tokens (14 pages of "
        f"64) refused at submit by cp=1 over 12 pages, served by cp=2 over "
        f"24 (12 per rank, the same page bytes per rank): "
        f"{res['serve_paged_cp2_equal_bytes']['summary']['completed']} "
        f"completed")
    return res


FLEET_SEED = 17
FLEET_NEW = 12            # fleet_check: new tokens per request
FLEET_TAILS = (40, 150, 7, 90, 64, 130)   # fleet_check: prompt tails
# phase 15's mix over two replicas of half its slots and pages each; the
# router's prefix weight at 0.5 (the JAX fleet test's): at the default 4 a
# burst behind one shared prefix goes wholly to the replica that took the
# first request, and the second replica would idle
FLEET_ARGS = (PAGED_SERVE_ARGS[:PAGED_SERVE_ARGS.index("--slots")]
              + ["--slots", "8", "--num_pages", "40", "--prefix_weight",
                 "0.5"])
FLEET_ARGS.remove("--paged")
# the router fleet serves the mix's first 16 requests, --disagg its first 8,
# with native and int8 pages
FLEET_RUNS = {"fleet_x2": ["--replicas", "2", "--num_requests", "16"],
              "disagg": ["--disagg", "--num_requests", "8"],
              "disagg_int8": ["--disagg", "--kv_dtype", "int8",
                              "--num_requests", "8"]}


class _Tape:
    """A socket stand-in for one frame: `sendall` appends, `recv` reads
    back in order."""

    def __init__(self):
        self.buf, self.pos = bytearray(), 0

    def sendall(self, b):
        self.buf.extend(bytes(b))

    def recv(self, n):
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += len(out)
        return out


def _drained(eng, name: str) -> None:
    pool = eng.pool
    if (pool.free_pages != pool.num_pages or (pool.refcount != 0).any()
            or pool._children or pool._page_keys
            or getattr(eng, "handoffs", None)):
        raise AssertionError(f"{name}: pool not drained ({pool.free_pages} "
                             f"of {pool.num_pages} pages free, refcounts "
                             f"{int(pool.refcount.sum())}, index "
                             f"{len(pool._page_keys)} pages)")


def _fleet_tokens(torch, device: str) -> dict:
    """fleet_check's runs on `device`: {run: {rid: tokens}}."""
    import dataclasses

    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models import build_model
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        PagedEngine, Request)
    from distributed_pytorch_from_scratch_tpu_torch.serving.router import (
        FleetRouter)
    from distributed_pytorch_from_scratch_tpu_torch.serving.transfer import (
        run_disaggregated)
    cfg = dataclasses.replace(model_preset("45m"), num_layers=2,
                              compute_dtype="float32")
    mesh = make_mesh(MeshConfig(), device=device)
    model = build_model("llama", cfg).init_weights(FLEET_SEED).to(
        mesh.device)
    rng = np.random.default_rng(FLEET_SEED)
    prefix = rng.integers(3, cfg.vocab_size, 96).tolist()
    prompts = [prefix + rng.integers(3, cfg.vocab_size, n).tolist()
               for n in FLEET_TAILS]
    buf = max(map(len, prompts)) + FLEET_NEW + 2
    reqs = lambda: [Request(rid=i, prompt=list(p), max_new=FLEET_NEW)
                    for i, p in enumerate(prompts)]
    eng = lambda **kw: PagedEngine(model, mesh, buf_len=buf, eos_id=1,
                                   page_size=64, prefill_chunk=128,
                                   **{"num_slots": 4, **kw})
    toks = lambda done: {r.rid: list(r.tokens) for r in done}
    out = {}
    for kv in (None, "int8"):
        single = eng(kv_dtype=kv)
        for r in reqs():
            single.submit(r)
        out[f"single_{kv}"] = toks(single.run_to_completion())
        pre, dec = eng(kv_dtype=kv, prefill_only=True), eng(kv_dtype=kv)
        res = run_disaggregated(pre, dec, reqs())
        out[f"disagg_{kv}"] = toks(res["completed"])
        for name, e in (("single", single), ("prefill", pre),
                        ("decode", dec)):
            _drained(e, f"fleet_check {device} {kv} {name}")
    router = FleetRouter([eng(num_slots=2), eng(num_slots=2)],
                         prefix_weight=0.5)
    for r in reqs():
        router.submit(r)
    out["fleet"] = toks(router.run_to_completion())
    if min(router.dispatched.values()) < 1:
        raise AssertionError(f"fleet_check: a replica took nothing "
                             f"{router.dispatched}")
    for name, e in router.replicas:
        _drained(e, f"fleet_check {device} {name}")
    return out


def _pool_roundtrip(torch) -> None:
    """export -> import -> export bitwise on bf16 and int8 pools on the
    card, and a bf16 frame read back bitwise."""
    import dataclasses
    from types import SimpleNamespace
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    from distributed_pytorch_from_scratch_tpu_torch.serving.kv_manager import (
        PagedKVPool)
    from distributed_pytorch_from_scratch_tpu_torch.serving.transfer import (
        _NAMES, recv_frame, send_frame)
    cfg = dataclasses.replace(model_preset("45m"), compute_dtype="bfloat16")
    ns = SimpleNamespace(cfg=cfg, cp_size=1, num_local_kv_heads=cfg.kv_heads)
    mesh = make_mesh(MeshConfig(), device="cuda")
    g = torch.Generator().manual_seed(FLEET_SEED)
    shape = (cfg.num_layers, 3, cfg.kv_heads, 64, cfg.head_dim)
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    for kv in (None, "int8"):
        if kv:
            one = lambda: (torch.randint(-127, 128, shape, generator=g,
                                         dtype=torch.int8),
                           torch.rand(shape[:-1], generator=g) + 0.01)
        else:
            one = lambda: torch.randn(shape, generator=g).to(torch.bfloat16)
        k, v = one(), one()
        flat = lambda a, b: [t for x in (a, b)
                             for t in (x if isinstance(x, tuple) else (x,))]
        a = PagedKVPool(ns, mesh, 8, 64, kv_dtype=kv)
        b = PagedKVPool(ns, mesh, 8, 64, kv_dtype=kv)
        got = a.export_pages(a.import_pages(k, v))
        again = b.export_pages(b.import_pages(*got))
        for x, y, z in zip(flat(k, v), flat(*got), flat(*again)):
            if not (torch.equal(bits(x), bits(y))
                    and torch.equal(bits(x), bits(z))):
                raise AssertionError(f"fleet_check: {kv or 'bf16'} pages "
                                     f"changed across export/import")
        if kv is None:
            tape = _Tape()
            send_frame(tape, {"blobs": [{"dtype": _NAMES[t.dtype],
                                         "shape": list(t.shape)}
                                        for t in got]}, list(got))
            _, blobs = recv_frame(tape)
            if not all(torch.equal(bits(x), bits(y))
                       for x, y in zip(blobs, got)):
                raise AssertionError("fleet_check: a bf16 frame read back "
                                     "differs from what was sent")
    log(f"fleet_check: export -> import -> export bitwise on bf16 and int8 "
        f"pools on the card ({shape[1]} pages of the 45m shape), a bf16 "
        f"frame of {2 * shape[1]} pages read back bitwise")


def phase_fleet_check(torch) -> None:
    card = _fleet_tokens(torch, "cuda")
    torch.cuda.synchronize()
    cpu = _fleet_tokens(torch, "cpu")
    for kv in (None, "int8"):
        for run in ("disagg", "single"):
            if card[f"{run}_{kv}"] != card[f"single_{kv}"]:
                raise AssertionError(f"fleet_check: {run} {kv} tokens "
                                     f"differ from the single engine's")
    if card["fleet"] != card["single_None"]:
        raise AssertionError("fleet_check: the 2-replica fleet's tokens "
                             "differ from one engine's")
    if card != cpu:
        bad = [k for k in card if card[k] != cpu[k]]
        raise AssertionError(f"fleet_check: card tokens differ from the "
                             f"CPU's in {bad}")
    if not any(card["single_None"].values()):
        raise AssertionError("fleet_check: no tokens generated")
    log(f"fleet_check: 45m widths, 2 layers, f32, {len(FLEET_TAILS)} "
        f"requests behind a 96-token prefix: the 2-replica fleet, "
        f"disaggregated native and int8 (prefill thread -> page stream -> "
        f"decode) equal the single engine's greedy tokens on the card, and "
        f"every run's tokens the CPU's")
    _pool_roundtrip(torch)


def _fleet_want(engines, layers: int) -> dict:
    """K3's launches by route over `engines`: 12 per decode step and per
    one-position chunk (decode-shaped) on the decode route, 12 per other
    chunk on the chunk route."""
    steps = sum(e.decode_steps for e in engines)
    one = sum(n for e in engines for (kind, shape), n
              in e.dispatch.shapes.items() if kind == "paged_chunk"
              and shape[0] == 1)
    chunks = sum(e.prefill_dispatches for e in engines)
    return {"decode": layers * (steps + one),
            "chunk": layers * (chunks - one)}


def phase_fleet_serve(torch, workdir: str, one_engine) -> dict:
    """`serve_fleet` at the 45m preset, bf16, on phase 15's mix: the router
    fleet, then disaggregated with native and int8 pages. Returns each
    run's K3 launches by kernel."""
    import dataclasses

    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        paged_attention)
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve_fleet
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        PagedEngine, graph_stats)
    from distributed_pytorch_from_scratch_tpu_torch.serving.kv_manager import (
        page_bytes)
    cfg = model_preset("45m")
    layers = cfg.num_layers
    share = PagedEngine._try_share
    first_hits = {}          # id(engine) -> hits at first admissions

    def counted(self, slot, st):
        before = self.prefix_hit_tokens
        share(self, slot, st)
        if st.req.preemptions == 0:
            first_hits[id(self)] = (first_hits.get(id(self), 0)
                                    + self.prefix_hit_tokens - before)

    res = {}
    for name, extra in FLEET_RUNS.items():
        args = serve_fleet.parse_args(
            FLEET_ARGS + extra + ["--log_dir", os.path.join(workdir, name)])
        _reset_launches()
        PagedEngine._try_share = counted
        try:
            out, fleet = serve_fleet.run(args)
        finally:
            PagedEngine._try_share = share
        torch.cuda.synchronize()
        counts = _read_launches()
        by_route = dict(paged_attention.launches_by_route)
        by_kernel = dict(paged_attention.launches_by_kernel)
        engines = {k: e for k, e in fleet.items() if isinstance(e, PagedEngine)}
        done = ([r for e in engines.values() for r in e.completed]
                if "router" in fleet else fleet["done"])
        if not (out["completed"] == len(done) == args.num_requests):
            raise AssertionError(f"fleet_serve {name}: served "
                                 f"{out['completed']} of "
                                 f"{args.num_requests}")
        toks = [t for r in done for t in r.tokens]
        if not toks or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"fleet_serve {name}: tokens missing or "
                                 f"outside the vocab")
        for ename, e in engines.items():
            _drained(e, f"fleet_serve {name} {ename}")
        want = _fleet_want(engines.values(), layers)
        total = want["decode"] + want["chunk"]
        _only(counts, {"paged_attention": total},
              f"fleet_serve {name} ({layers} x (decode steps + chunks))")
        kern = {"paged_decode": want["decode"],
                "paged_chunk_sm90": want["chunk"], "paged_attn": 0}
        if by_route != want or by_kernel != kern:
            raise AssertionError(f"fleet_serve {name}: K3 launches by route "
                                 f"{by_route}, by kernel {by_kernel}; "
                                 f"expected {want}, {kern}")
        st = {k: e.stats() for k, e in engines.items()}
        steps = {k: s["decode_steps"] for k, s in st.items()}
        preempt = {k: s["preemptions"] for k, s in st.items()}
        graphs = {k: graph_stats(e)["decode_graph_replays"]
                  for k, e in engines.items()}
        line = (f"fleet_serve {name}: {out['completed']}/"
                f"{args.num_requests} requests, "
                f"{out['generated_tokens']} tokens; TTFT p50/p95 "
                f"{out['ttft_ms_p50']}/{out['ttft_ms_p95']} ms; TPOT "
                f"p50/p95 {out['tpot_ms_p50']}/{out['tpot_ms_p95']} ms; "
                f"decode steps {steps}, graph replays {graphs}, "
                f"preemptions {preempt}; K3 by route {by_route}, by kernel "
                f"{by_kernel}")
        if "router" in fleet:
            router = fleet["router"]
            if min(router.dispatched.values()) < 1:
                raise AssertionError(f"fleet_serve {name}: a replica took "
                                     f"nothing {router.dispatched}")
            tenants = {}
            for ename, e in engines.items():
                for r in e.completed:
                    tenants.setdefault(r.tenant, set()).add(ename)
            if any(len(v) != 1 for v in tenants.values()) or out[
                    "session_spills"]:
                raise AssertionError(f"fleet_serve {name}: tenants on "
                                     f"replicas {tenants}, spills "
                                     f"{out['session_spills']}")
            predicted = {}
            for ename, hit in router.predicted.values():
                predicted[ename] = predicted.get(ename, 0) + hit
            hits = {k: s["prefix_hit_tokens"] for k, s in st.items()}
            first = {k: first_hits.get(id(e), 0) for k, e in engines.items()}
            for k in engines:
                if predicted.get(k, 0) < first[k] or (
                        not preempt[k] and predicted.get(k, 0) < hits[k]):
                    raise AssertionError(
                        f"fleet_serve {name}: {k} predicted "
                        f"{predicted.get(k, 0)} hit tokens, its first "
                        f"admissions hit {first[k]} (all {hits[k]})")
            line += (f"; fleet {out['fleet_tokens_per_sec']} tok/s, "
                     f"dispatched {router.dispatched}, tenants {tenants}, "
                     f"dispatch ms p50/p95 {out['dispatch_ms_p50']}/"
                     f"{out['dispatch_ms_p95']}; predicted hit tokens "
                     f"{sum(predicted.values())} {predicted} >= first "
                     f"admissions' {sum(first.values())} {first}; all "
                     f"prefix_hit_tokens {sum(hits.values())} {hits} "
                     f"(resumes' {sum(hits.values()) - sum(first.values())})"
                     f"; SLO {out.get('fleet_slo_attainment')}")
        else:
            pre = fleet["prefill"]
            if any(kind == "paged_decode" or shape[0] == 1
                   for kind, shape in pre.dispatch.shapes):
                raise AssertionError(f"fleet_serve {name}: the prefill-only "
                                     f"engine ran the decode route "
                                     f"{dict(pre.dispatch.shapes)}")
            kv = "int8" if "int8" in name else None
            pb = page_bytes(dataclasses.replace(
                cfg, compute_dtype="bfloat16"), 64, kv)
            want_pb = 835_584 if kv else 1_572_864
            pages = sum(-(-len(r.prompt) // 64) for r in done)
            heads = [t["bytes"] - t["pages"] * pb for t in out["transfers"]]
            if not (pb == out["page_bytes"] == want_pb
                    and out["transferred_pages"] == pages
                    == st["prefill"]["pages_exported"]
                    == st["decode"]["pages_imported"]
                    and len(heads) == len(done) and 0 < min(heads)
                    and max(heads) < 16384):
                raise AssertionError(
                    f"fleet_serve {name}: {out['transferred_pages']} pages "
                    f"({pages} from the prompts), page bytes {pb} (want "
                    f"{want_pb}), headers {min(heads)}..{max(heads)} B")
            line += (f"; {out['transferred_pages']} pages, "
                     f"{out['transferred_bytes']} B ({pb} B a page + a "
                     f"{min(heads)}..{max(heads)} B header), "
                     f"{out['bytes_per_request']:.1f} B per request; "
                     f"transfer ms p50/p95 {out['transfer_ms_p50']}/"
                     f"{out['transfer_ms_p95']}; wall {out['wall_s']:.3f} s "
                     f"-> {out['generated_tokens'] / out['wall_s']:.2f} tok/s")
        log(line + f"; device {out['device']}")
        res[name] = by_kernel
    if one_engine:
        log(f"fleet_serve: phase 15's one engine (16 slots, 80 pages) in "
            f"this run: {one_engine['one_engine']}")
    else:
        log("fleet_serve: phase 15 did not run in this call")
    return res


# the MoE family at 45m-moe8's widths: d 512, 8 heads of 64, 12 layers,
# vocab 1024, 8 SwiGLU experts of ffn 2048, top 2, capacity factor 2.0
MOE = "45m-moe8"
MOE_STEPS = 10
MOE_TRAIN_ARGS = _replace_flag(_replace_flag(_replace_flag(
    TRAIN_ARGS, "--model", MOE), "--max_steps", str(MOE_STEPS)),
    "--save_interval", str(MOE_STEPS))
MOE_SERVE_ARGS = _replace_flag(_replace_flag(SERVE_ARGS, "--model", MOE),
                               "--num_requests", "8")
MOE_PAGED_ARGS = _replace_flag(_replace_flag(
    PAGED_SERVE_ARGS, "--model", MOE), "--num_requests", "8")
MOE_EP2_STEPS = 3
MOE_EP2_ARGS = _replace_flag(CP_ARGS, "--model", MOE) + [
    "--max_steps", str(MOE_EP2_STEPS), "--num_layers", str(CP_LAYERS)]
# moe_check: the tiny widths with 4 experts and a capacity that drops
MOE_TINY = dict(num_experts=4, moe_capacity_factor=1.0,
                compute_dtype="float32")
MOE_PROMPT_LENS = (5, 40, 17, 3, 28, 9, 33, 12)


def _moe_tiny(torch, seed: int):
    """The moe_check model on the CPU: the tiny preset with MOE_TINY, its
    zero router replaced by a seeded normal one (the init's routes every
    token alike)."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.models import build_model
    cfg = model_preset("tiny", **MOE_TINY)
    model = build_model("llama", cfg, remat=False).init_weights(seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for lp in model.layers:
            lp["moe"].router.normal_(0.0, 1.0, generator=gen)
    return cfg, model


def _moe_engine_tokens(torch, model, device: str, kind: str) -> dict:
    """Greedy tokens of the 8 seeded moe_check requests through one engine
    of `kind` (slot or paged) on `device`, the decode step graphed on the
    card."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import MeshConfig
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        ContinuousBatchingEngine, PagedEngine, Request)
    mesh = make_mesh(MeshConfig(), device=device)
    kw = dict(num_slots=6, buf_len=64, eos_id=1)
    eng = (ContinuousBatchingEngine(model, mesh, prefill_bucket=16,
                                    max_prefill_batch=2, **kw)
           if kind == "slot" else
           PagedEngine(model, mesh, page_size=16, prefill_chunk=16, **kw))
    rng = np.random.default_rng(21)
    for i, n in enumerate(MOE_PROMPT_LENS):
        eng.submit(Request(rid=i, prompt=rng.integers(
            3, model.cfg.vocab_size, size=n).tolist(), max_new=16))
    eng.run_to_completion()
    return {r.rid: list(r.tokens) for r in eng.completed}


def phase_moe_check(torch) -> dict:
    """Card against CPU at the tiny MoE shape (phase 51)."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import IGNORE_INDEX
    from distributed_pytorch_from_scratch_tpu_torch.models import build_model
    from distributed_pytorch_from_scratch_tpu_torch.parallel.moe import route
    # every expert ties (the zero router's logits), and ties on half of
    # them: the stable sort gives both devices the lowest index first
    ties = torch.zeros(1000, 8)
    ties[::2, 5:] = 1.0
    got = [route(ties.to(dev), 2, 1.0) for dev in ("cuda", "cpu")]
    if not (torch.equal(got[0][0].cpu(), got[1][0])
            and torch.equal(got[0][1].cpu(), got[1][1])):
        raise AssertionError("the router's choices under tied logits "
                             "differ between the card and the CPU")
    cfg, cpu = _moe_tiny(torch, seed=11)
    card = build_model("llama", cfg, remat=True)
    card.load_state_dict(cpu.state_dict())
    card.to("cuda")
    rng = np.random.default_rng(11)
    b, t = 4, 256
    ids = rng.integers(3, cfg.vocab_size, size=(b, t + 1))
    tgt = ids[:, 1:].copy()
    tgt[1, 200:] = IGNORE_INDEX
    batch = [torch.from_numpy(a) for a in
             (ids[:, :-1], tgt, np.tile(np.arange(t), (b, 1)))]
    res = {}
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        ids_d, tgt_d, pos_d = (x.to(dev) for x in batch)
        with torch.no_grad():
            logits = model(ids_d, pos_d).float().cpu()
        loss = model.loss(ids_d, tgt_d, pos_d)
        loss.backward()
        res[dev] = (logits, loss.item(), model.moe_summary(),
                    {k: p.grad.cpu() for k, p in model.named_parameters()})
    (lg_card, l_card, moe_card, g_card) = res["cuda"]
    (lg_cpu, l_cpu, moe_cpu, g_cpu) = res["cpu"]
    lg_diff = ((lg_card - lg_cpu).abs().max() / lg_cpu.abs().max()).item()
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst, worst_key = 0.0, None
    for k, gc in g_cpu.items():
        ratio = ((g_card[k] - gc).abs().max()
                 / gc.abs().max().clamp(min=1e-12)).item()
        if ratio > worst:
            worst, worst_key = ratio, k
    log(f"moe_check: tiny x 4 experts (cf 1.0) f32 b{b} x t{t}: logits max "
        f"abs diff {lg_diff:.3e} of max |logit| (tol 1e-3); loss "
        f"{l_card:.7f} (card) vs {l_cpu:.7f} (cpu), rel diff {rel:.3e} (tol "
        f"1e-5); routing card {moe_card} vs cpu {moe_cpu}; worst grad leaf "
        f"{worst_key}: {worst:.3e} of its max |grad| (tol 1e-3)")
    if not (lg_diff <= 1e-3 and rel <= 1e-5 and worst <= 1e-3):
        raise AssertionError("card and CPU disagree on the MoE model")
    if moe_card != moe_cpu or not moe_cpu["dropped_frac"] > 0:
        raise AssertionError(f"routing differs or nothing dropped: "
                             f"{moe_card} vs {moe_cpu}")
    out = {}
    for kind in ("slot", "paged"):
        on_card = _moe_engine_tokens(torch, card, "cuda", kind)
        on_cpu = _moe_engine_tokens(torch, cpu, "cpu", kind)
        log(f"moe_check {kind} engine: {sum(map(len, on_card.values()))} "
            f"greedy tokens on the card, identical on the CPU: "
            f"{on_card == on_cpu}")
        if on_card != on_cpu:
            raise AssertionError(f"moe {kind} engine tokens differ between "
                                 f"the card and the CPU")
        out[kind] = on_card
    return {"logits_rel": lg_diff, "loss_rel": rel, "grad_worst": worst}


def _moe_layer_ms(torch, layer, x) -> tuple:
    """Device ms of one MoE layer's forward, and of its forward and
    backward, at x's shape (torch.profiler, after a warm-up); the
    forward and backward's kernels are logged by name, the costliest
    first."""
    dtype = x.dtype

    def fwd():
        with torch.no_grad():
            layer(x, dtype)

    def fwd_bwd():
        y, aux = layer(x, dtype)
        (y.float().sum() + aux["z_sum"]).backward()

    fwd_bwd()
    ms = []
    for fn in (fwd, fwd_bwd):
        by_name = {}
        for name, us in _profiled(torch, fn, "moe layer"):
            n, t = by_name.get(name[:90], (0, 0.0))
            by_name[name[:90]] = (n + 1, t + us)
        ms.append(sum(t for _, t in by_name.values()) / 1e3)
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :12]:
        log(f"  moe layer fwd+bwd: {us / 1e3:.3f} ms over {n} launches: "
            f"{name}")
    return tuple(ms)


def phase_moe_train(torch, workdir: str) -> dict:
    """45m-moe8 train (phase 52); returns the launches and the summary."""
    import math
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        OptimizerConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models import build_model
    from distributed_pytorch_from_scratch_tpu_torch.training.optim import (
        init_adam_state)
    from distributed_pytorch_from_scratch_tpu_torch.training.train_step import (
        build_train_step)
    save_dir = os.path.join(workdir, "moe")
    args = MOE_TRAIN_ARGS + ["--data_path", _corpus(workdir), "--save_dir",
                             save_dir]
    _reset_launches()
    out = train.main(args)
    counts = _read_launches()
    cfg = model_preset(MOE, compute_dtype="bfloat16")
    layers = cfg.num_layers
    losses = out["losses"]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    log(f"moe_train: {out['steps']} steps of {MOE} b32 x t1000 bf16 on "
        f"{out['device']} ({out['params'] / 1e6:.2f}M params): losses "
        f"{[round(x, 4) for x in losses]}; step p50 "
        f"{out['step_ms_p50']:.3f} ms, {out['tokens_per_sec']:.1f} tok/s, "
        f"MFU {out['mfu']:.4f} (active parameters), peak memory "
        f"{out['peak_mem_gib']:.3f} GiB; last step's routing {out['moe']}; "
        f"launches {counts}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != MOE_STEPS:
        raise AssertionError(f"moe losses not finite or not {MOE_STEPS}")
    # a b32 batch holds ~20k valid tokens: its mean CE varies by ~0.01, so
    # a drop of 0.1 is learning, not noise
    if not last <= first - 0.1:
        raise AssertionError(f"moe train loss did not fall: {losses}")
    _only(counts, _flash_want(layers, MOE_STEPS), "moe train (remat)")
    _reset_launches()
    resumed = train.main(_replace_flag(args, "--max_steps",
                                       str(MOE_STEPS + 2)) + ["--resume"])
    resumed_counts = _read_launches()
    log(f"moe_train --resume: started at step {resumed['start_step']}, ran "
        f"to {resumed['steps']}, losses {resumed['losses']}; launches "
        f"{resumed_counts}")
    _only(resumed_counts, _flash_want(layers, 2), "moe train --resume "
          "(2 steps, remat)")
    if (resumed["start_step"] != MOE_STEPS
            or resumed["steps"] != MOE_STEPS + 2
            or not all(math.isfinite(x) for x in resumed["losses"])):
        raise AssertionError("moe resume did not continue from the "
                             "checkpoint")
    # where the step's device time goes: one profiled step of the cell,
    # beside one MoE layer's forward and forward + backward at its input
    # (static shapes: the work does not depend on the routing); under remat
    # a layer runs its forward twice and its backward once
    # the weights drawn on the card (the timing needs shapes, not a seed's
    # init: the shapes are static, whatever the routing)
    model = build_model("llama", cfg, remat=True).to("cuda")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02)
    step = build_train_step(model, OptimizerConfig(lr=1e-4))
    state = init_adam_state(dict(model.named_parameters()))
    b, t = TRAIN_SHAPE[0], TRAIN_SHAPE[2]
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, t))).cuda()
    pos = torch.arange(t, device="cuda").expand(b, t)
    for _ in range(2):
        _, _, state = step(state, ids, ids, pos)

    def one_step():
        nonlocal state
        _, _, state = step(state, ids, ids, pos)

    busy = sum(us for _, us in _profiled(torch, one_step, "moe train step"))
    busy /= 1e3
    x = torch.randn(b, t, cfg.attn_dim, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    fwd_ms, fwd_bwd_ms = _moe_layer_ms(torch, model.layers[0]["moe"], x)
    moe_ms = layers * (fwd_ms + fwd_bwd_ms)
    log(f"moe_train profile: one step's device busy {busy:.3f} ms; one MoE "
        f"layer's forward {fwd_ms:.3f} ms, forward + backward "
        f"{fwd_bwd_ms:.3f} ms at ({b}, {t}, {cfg.attn_dim}) bf16; the "
        f"{layers} MoE layers (2 forwards + 1 backward each) "
        f"{moe_ms:.3f} ms = {moe_ms / busy:.3f} of device busy")
    del model, step, state
    torch.cuda.empty_cache()
    return {**counts, "summary": out, "moe_share": moe_ms / busy,
            "resume": resumed_counts}


def phase_moe_serve(torch, dense_slot: dict, dense_paged: dict,
                    dense_profile: dict) -> dict:
    """45m-moe8 in both engines (phase 53); returns each run's launches."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    layers = model_preset(MOE).num_layers
    fmt = lambda o: (f"{o['tokens_per_sec']} tok/s, TTFT p50/p95 "
                     f"{o['ttft_ms_p50']}/{o['ttft_ms_p95']} ms, TPOT "
                     f"p50/p95 {o['tpot_ms_p50']}/{o['tpot_ms_p95']} ms")
    _reset_launches()
    out = serve.main(MOE_SERVE_ARGS)
    counts = _read_launches()
    torch.cuda.synchronize()
    dense = (dense_slot or {}).get("one_engine")
    log(f"moe_serve slot: {out['completed']}/{out['requests']} requests, "
        f"{out['generated_tokens']} tokens in {out['wall_s']} s: "
        f"{fmt(out)}; {out['decode_steps']} decode steps "
        f"(graph {out['decode_graph']}), {out['prefill_dispatches']} "
        f"prefill dispatches; launches {counts}"
        + (f"; dense 45m, phase 5 of this run: {fmt(dense)}" if dense
           else ""))
    toks = [t for ts in out["outputs"].values() for t in ts]
    if out["completed"] != out["requests"] or not toks or not all(
            0 <= t < 1024 for t in toks):
        raise AssertionError("moe slot serving: requests or tokens wrong")
    _only(counts, {"flash_attention_fwd": layers * out["prefill_dispatches"]},
          f"moe slot serving ({layers} per prefill dispatch)")
    slot = counts
    slot_out = {k: out[k] for k in ("ttft_ms_p50", "tpot_ms_p50")}
    slot_out["weight_bytes"] = out["engine_stats"]["weight_bytes"]
    out, counts, by_route, by_kernel, widths = _serve_with_widths(
        serve, MOE_PAGED_ARGS)
    torch.cuda.synchronize()
    st = out["engine_stats"]
    dense = (dense_paged or {}).get("one_engine")
    log(f"moe_serve paged: {out['completed']}/{out['requests']} requests, "
        f"{out['generated_tokens']} tokens in {out['wall_s']} s: "
        f"{fmt(out)}; {st['decode_steps']} decode steps, "
        f"{out['prefill_dispatches']} chunk dispatches, preemptions "
        f"{st['preemptions']}, COW copies {st['cow_copies']}, prefix hit "
        f"tokens {st['prefix_hit_tokens']}; paged launches by route "
        f"{by_route}, by kernel {by_kernel}; all {counts}"
        + (f"; dense 45m, phase 15 of this run (32 requests): {fmt(dense)}"
           if dense else ""))
    _check_paged_run(out, st, counts, by_route, by_kernel, widths, layers,
                     1024)
    prof = _paged_profile(torch, MOE)
    if dense_profile:
        log(f"moe_serve: a paged decode step's wall / device busy "
            f"{prof['decode_wall_ms']:.3f} / {prof['decode'][0]:.3f} ms and "
            f"a 128-position chunk's {prof['chunk_wall_ms']:.3f} / "
            f"{prof['chunk'][0]:.3f} ms; dense 45m, phase 17 of this run: "
            f"{dense_profile['decode_wall_ms']:.3f} / "
            f"{dense_profile['decode'][0]:.3f} and "
            f"{dense_profile['chunk_wall_ms']:.3f} / "
            f"{dense_profile['chunk'][0]:.3f} ms")
    return {"slot": slot, "paged": counts, "paged_by_route": by_route,
            "paged_by_kernel": by_kernel, "profile": prof,
            "slot_out": slot_out}


def _grad_ratio(got: dict, want: dict) -> tuple:
    """(worst max |got - want| over max |want| of any leaf, its key)."""
    import numpy as np
    worst, key = 0.0, None
    for k, w in want.items():
        ratio = float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
        if ratio > worst:
            worst, key = ratio, k
    return worst, key


def _moe_ep2_exchange(torch) -> dict:
    """The ep 2 exchange itself at moe_check's tiny MoE shape (f32, a
    seeded normal router): two gloo ranks on the card against the same two
    ranks on the CPU at cf 1.0, where tokens drop (logits, loss, routing
    and every rank's gradient shard), and against one card at ep 1 at cf
    2.0, where nothing drops at either (C = S at ep 1 and S/2 at ep 2, as
    each token picks an expert once), so the two must agree to f32
    rounding: a wrong peer order, a wrong backward of the all_to_all or a
    wrong sum of the expert gradients fails either."""
    import dataclasses
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        IGNORE_INDEX, MeshConfig)
    from distributed_pytorch_from_scratch_tpu_torch.interop import (
        params_to_jax)
    from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import (
        is_expert)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        launch, tp_checks)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    drops, model = _moe_tiny(torch, seed=13)
    tree = params_to_jax(model.state_dict())
    ample = dataclasses.replace(drops, moe_capacity_factor=2.0)
    rng = np.random.default_rng(13)
    b, t = 4, 256
    ids = rng.integers(3, drops.vocab_size, size=(b, t + 1))
    tgt = ids[:, 1:].copy()
    tgt[2, 150:] = IGNORE_INDEX
    run = dict(logits=True, batch=(ids[:, :-1], tgt,
                                   np.tile(np.arange(t), (b, 1))))
    job = lambda cfg: ("model_runs", {"ep": 2}, dict(
        cfg=dataclasses.asdict(cfg), tree=tree, runs=[run]))
    # per rank: [card cf 1.0, card cf 2.0, cpu cf 1.0, cpu cf 2.0]
    ranks = launch.spawn(tp_checks.jobs, 2, [job(drops), job(ample)],
                         ("cuda", "cpu"), "gloo")
    one = tp_checks.model_runs(make_mesh(MeshConfig(), device="cuda"),
                               dataclasses.asdict(ample), tree, [run])[0]
    half = b // 2
    out = {"cpu_loss": 0.0, "cpu_logits": 0.0, "cpu_grad": 0.0,
           "ep1_loss": 0.0, "ep1_logits": 0.0, "ep1_grad": 0.0}
    worst_keys = {}
    for r, (card_d, card_a, cpu_d, cpu_a) in enumerate(ranks):
        card_d, card_a, cpu_d, cpu_a = (x[0] for x in (card_d, card_a,
                                                        cpu_d, cpu_a))
        if card_d["moe"] != cpu_d["moe"] or not cpu_d["moe"]["dropped_frac"]:
            raise AssertionError(f"moe ep2 rank {r}: routing differs between"
                                 f" the card and the CPU or nothing dropped:"
                                 f" {card_d['moe']} vs {cpu_d['moe']}")
        if card_a["moe"]["dropped_frac"] or one["moe"]["dropped_frac"]:
            raise AssertionError(f"moe ep2 rank {r}: tokens dropped at cf "
                                 f"2.0: {card_a['moe']}, ep 1 {one['moe']}")
        out["cpu_loss"] = max(out["cpu_loss"], abs(
            card_d["loss"] - cpu_d["loss"]) / abs(cpu_d["loss"]))
        out["cpu_logits"] = max(out["cpu_logits"], float(
            np.abs(card_d["logits"] - cpu_d["logits"]).max()
            / np.abs(cpu_d["logits"]).max()))
        ratio, key = _grad_ratio(card_d["grads"], cpu_d["grads"])
        if ratio >= out["cpu_grad"]:
            out["cpu_grad"], worst_keys["cpu"] = ratio, f"rank {r} {key}"
        # ep 1 at cf 2.0: this rank's rows of its logits, its experts'
        # gradients (dim 0 chunk r), every other gradient whole
        out["ep1_loss"] = max(out["ep1_loss"], abs(
            card_a["loss"] - one["loss"]) / abs(one["loss"]))
        mine = one["logits"][r * half:(r + 1) * half]
        out["ep1_logits"] = max(out["ep1_logits"], float(
            np.abs(card_a["logits"] - mine).max() / np.abs(mine).max()))
        want = {k: (np.split(g, 2, axis=0)[r] if is_expert(k) else g)
                for k, g in one["grads"].items()}
        ratio, key = _grad_ratio(card_a["grads"], want)
        if ratio >= out["ep1_grad"]:
            out["ep1_grad"], worst_keys["ep1"] = ratio, f"rank {r} {key}"
    log(f"moe_ep2_train exchange: tiny x 4 experts f32 b{b} x t{t}, ep 2 "
        f"over gloo; card vs CPU at cf 1.0 (dropped "
        f"{ranks[0][0][0]['moe']['dropped_frac']:.4f}): loss rel "
        f"{out['cpu_loss']:.3e} (tol 1e-5), logits {out['cpu_logits']:.3e} "
        f"of max (tol 1e-5), worst grad {worst_keys['cpu']} "
        f"{out['cpu_grad']:.3e} of its max (tol 1e-4); against ep 1 on the "
        f"card at cf 2.0 (nothing dropped): loss rel {out['ep1_loss']:.3e} "
        f"(tol 1e-5), logits {out['ep1_logits']:.3e} of max (tol 1e-5), "
        f"worst grad {worst_keys['ep1']} {out['ep1_grad']:.3e} of its max "
        f"(tol 1e-4)")
    if not (max(out["cpu_loss"], out["cpu_logits"], out["ep1_loss"],
                out["ep1_logits"]) <= 1e-5
            and max(out["cpu_grad"], out["ep1_grad"]) <= 1e-4):
        raise AssertionError(f"moe ep2 exchange disagrees: {out}")
    return out


def phase_moe_ep2_train(torch, workdir: str) -> dict:
    """45m-moe8 at ep 2 over gloo (phase 54), after the exchange's checks
    at the tiny shape; returns the launches summed over the ranks."""
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        IGNORE_INDEX, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.data.dataset import (
        get_dataloader)
    from distributed_pytorch_from_scratch_tpu_torch.models import build_model
    cfg = model_preset(MOE, compute_dtype="bfloat16", num_layers=CP_LAYERS)
    layers = cfg.num_layers
    steps = MOE_EP2_STEPS
    _moe_ep2_exchange(torch)
    data = _corpus(workdir)
    base = MOE_EP2_ARGS + ["--data_path", data]
    res = train.main(base + ["--ep_size", "2", "--dist_backend", "gloo",
                             "--save_dir", os.path.join(workdir, "moe_ep2")])
    # ep 1's loss on the CLI's first batch (its seeded loader's first, the
    # CLI's random_seed 0), the same weights, in this process
    loader = get_dataloader(data, CP_B, IGNORE_INDEX, split="train",
                            maxlen=CP_T, shuffle=True, seed=0)
    first = next(iter(loader.epoch(0)))
    model = build_model("llama", cfg).init_weights(0).to("cuda")
    with torch.no_grad():
        one = model.loss(*(torch.from_numpy(first[k]).cuda().long() for k in
                           ("input_ids", "target_ids", "position_ids")))
    one = one.item()
    del model
    torch.cuda.empty_cache()
    losses = res["losses"]
    summed = {}
    # per step: 2 all_to_alls per layer forward, 2 in the remat replay, 2
    # backward, and the norm's all-reduce of the experts' squares; then the
    # checkpoint's 3 expert gathers (params and both moments)
    want_ep = steps * (6 * layers + 1) + 3
    for rank in res["ranks"]:
        _only(rank["launches"], _flash_want(layers, steps),
              f"moe ep2 rank {rank['rank']} ({steps} steps)")
        ep = rank["collectives"]["ep"]
        if ep["calls"] != want_ep:
            raise AssertionError(f"moe ep2 rank {rank['rank']}: {ep['calls']}"
                                 f" ep hops, expected {want_ep}")
        for k, v in rank["launches"].items():
            summed[k] = summed.get(k, 0) + v
    hops = lambda r: r["collectives_steps"]["ep"]
    log(f"moe_ep2_train: {res['steps']} steps of {MOE} b{CP_B} x t{CP_T} "
        f"bf16, ep {res['ep']} over {res['dist_backend']} on {res['cards']} "
        f"card(s): losses {[round(x, 4) for x in losses]} (ep 1 on the "
        f"first batch {one:.4f}); step p50 {res['step_ms_p50']:.3f} ms, "
        f"{res['tokens_per_sec']:.1f} tok/s; routing {res['moe']}; "
        + "; ".join(_rank_hops(r) for r in res["ranks"])
        + "; the steps' ep hops per step: " + "; ".join(
            f"rank {r['rank']} {hops(r)['calls'] / steps:.0f} calls, "
            f"{hops(r)['bytes'] / steps / 1e9:.4f} GB, host "
            f"{1e3 * (hops(r)['wait_s'] + hops(r)['hop_s']) / steps:.1f} ms "
            f"({1e3 * hops(r)['hop_s'] / steps:.1f} in the hops)"
            for r in res["ranks"]))
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"moe ep2: losses not finite or not {steps}")
    if not abs(losses[0] - one) <= 1e-2:
        raise AssertionError(f"moe ep2 step-1 loss {losses[0]} vs ep 1 "
                             f"{one}")
    return summed


# moe_paths: the serving and evaluation paths at 45m-moe8 beyond the two
# engines of phase 53. (d) phase 48's long requests cut to 4 and the
# model to CP_LAYERS, as phases 20 and 24 are cut
MOE_INT8 = ["--decode_weight_dtype", "int8"]
MOE_SPEC_ARGS = MOE_PAGED_ARGS + ["--speculate", str(SPEC_K)]
MOE_FLEET_ARGS = _replace_flag(_replace_flag(FLEET_ARGS, "--model", MOE),
                               "--num_requests", "8") + ["--replicas", "2"]
MOE_CP_ARGS = (_replace_flag(CP_SERVE_BASE, "--model", MOE)
               + ["--num_layers", str(CP_LAYERS)]
               + _replace_flag(_replace_flag(
                   CP_SERVE_RUNS["serve_paged_cp2"], "--num_requests", "4"),
                   "--slots", "4"))
MOE_EVAL_ARGS = ["--model", MOE, "--batch_size", "8", "--tokenizer_path",
                 TOKENIZER, "--max_decode_len", "32", "--cp_size", "2",
                 "--dist_backend", "gloo"]
MOE_GEN_PROMPTS = ["Nice to meet you", "The brave man"]
# (a)-(d) serve the init's weights (seed 0) with its zero router, which
# ties every token on experts 0 and 1, replaced by a normal one of std
# d^-1/2 drawn from MOE_ROUTER_SEED, through a checkpoint the phase writes
MOE_ROUTER_SEED = 7
MOE_ROUTED_DROPS = 0.1   # the most of the choices a routed run may drop
                         # (the zero router drops about half at cf 2.0)


def _routed_drops(name: str, share: float) -> None:
    if not 0 <= share < MOE_ROUTED_DROPS:
        raise AssertionError(f"{name}: dropped share {share}, not under "
                             f"{MOE_ROUTED_DROPS}: the router routes every "
                             f"token alike")


def _moe_routed(torch, workdir: str, layers: int) -> str:
    """A checkpoint dir of 45m-moe8 at `layers` layers: the init's weights
    from seed 0, each layer's router drawn N(0, 1/d) from
    MOE_ROUTER_SEED."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.models import build_model
    from distributed_pytorch_from_scratch_tpu_torch.training.checkpoint import (
        save_checkpoint)
    cfg = model_preset(MOE, num_layers=layers)
    model = build_model("llama", cfg).init_weights(0)
    gen = torch.Generator().manual_seed(MOE_ROUTER_SEED)
    with torch.no_grad():
        for lp in model.layers:
            lp["moe"].router.normal_(0.0, cfg.attn_dim ** -0.5,
                                     generator=gen)
    path = os.path.join(workdir, f"moe_routed_{layers}")
    save_checkpoint(path, 0, 0.0, model.state_dict())
    return path


def _from_ckpt(args: list, ckpt: str) -> list:
    """`args` with `--random_init` swapped for `--ckpt_dir ckpt`."""
    return [a for a in args if a != "--random_init"] + ["--ckpt_dir", ckpt]


def _moe_paths_card_vs_cpu(torch) -> None:
    """Card against CPU at moe_check's tiny MoE shape (f32, cf 1.0: choices
    drop): the int8 codes and scales of the router and the experts byte
    for byte, the speculative engine's greedy tokens (a MoE target and
    drafter, its round graphed on the card) and the cp 2 paged engine's
    (two gloo ranks) identical."""
    import dataclasses
    from distributed_pytorch_from_scratch_tpu_torch.config import MeshConfig
    from distributed_pytorch_from_scratch_tpu_torch.interop import (
        params_to_jax)
    from distributed_pytorch_from_scratch_tpu_torch.ops.quant import (
        quantize_decode_params)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        launch, tp_checks)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    cfg, model = _moe_tiny(torch, seed=23)
    sd = model.state_dict()
    q = {dev: quantize_decode_params({k: v.to(dev) for k, v in sd.items()})
         for dev in ("cuda", "cpu")}
    moe_keys = [k for k in sd if ".moe." in k]
    same = all(torch.equal(q["cuda"][k][part].cpu(), q["cpu"][k][part])
               for k in moe_keys for part in ("qweight", "scale"))
    log(f"moe_paths card vs cpu: int8 codes and scales of {len(moe_keys)} "
        f"router and expert leaves byte-equal {same}")
    if not same:
        raise AssertionError("the int8 expert codes or scales differ "
                             "between the card and the CPU")
    tree, cfgd = params_to_jax(sd), dataclasses.asdict(cfg)
    reqs = [(list(range(3, 3 + n)), 12, "default", None)
            for n in MOE_PROMPT_LENS]
    kw = dict(num_slots=6, buf_len=64, eos_id=1, page_size=16,
              prefill_chunk=16, paged_attn_impl="kernel")
    spec = dict(engine="speculative", kw=dict(kw, speculate_k=SPEC_K),
                drafter=(cfgd, tree), requests=reqs, stagger=2, tick=0.02)
    paged = dict(engine="paged", kw=kw, requests=reqs, stagger=2, tick=0.02)
    got = {dev: tp_checks.serve_runs(make_mesh(MeshConfig(), device=dev),
                                     cfgd, tree, [spec])[0]
           for dev in ("cuda", "cpu")}
    cp2 = launch.spawn(tp_checks.jobs, 2, [("serve_runs", {"cp": 2}, dict(
        cfg=cfgd, tree=tree, runs=[paged]))], ("cuda", "cpu"), "gloo")
    for what, card, cpu in (
            ("speculative (k 4, drafter = target)", got["cuda"],
             got["cpu"]),
            ("cp 2 paged", cp2[0][0][0], cp2[0][1][0])):
        n = sum(map(len, card["tokens"].values()))
        # the dropped share counts the free rows too, which all write the
        # scratch page, in no fixed order: it may differ where tokens agree
        counts = lambda st: {k: v for k, v in st.items()
                             if "_ms" not in k and k != "moe_dropped_share"}
        log(f"moe_paths card vs cpu: {what} greedy, {n} tokens, identical "
            f"{card['tokens'] == cpu['tokens']}, stats (times and the "
            f"dropped share aside) identical "
            f"{counts(card['stats']) == counts(cpu['stats'])}; dropped share "
            f"card {card['stats']['moe_dropped_share']:.4f}, cpu "
            f"{cpu['stats']['moe_dropped_share']:.4f}")
        if card["tokens"] != cpu["tokens"] or not n:
            raise AssertionError(f"{what}: the card's tokens are not the "
                                 f"CPU's")


def _moe_eval_want(layers: int, s: dict) -> list:
    """Per rank, evaluate --cp_size 2's launches: the sweep's ring blocks
    (`block_schedule` over 0..t-1 cut contiguously, one forward per layer
    per batch per checkpoint) and K3 per decode step and prefill chunk of
    the cp paged engine."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.ops.ring_attention import (
        block_schedule, cp_chunk_index)
    pos = np.stack([np.tile(cp_chunk_index(CP_T, 2, r, "contiguous"),
                            (8, 1)) for r in range(2)])
    blocks = [sum(len(x) for x in rank) for rank in block_schedule(pos)]
    batches = sum(n // (8 * CP_T) for n in s["sweep_tokens"].values())
    decode = s["decode_steps"] + s["prefill_dispatches"]
    return [{"block_attention_fwd": layers * batches * n,
             "paged_attention": layers * decode} for n in blocks]


def phase_moe_paths(torch, workdir: str, moe_served: dict) -> dict:
    """45m-moe8 on the paths phase 53 does not take: card
    against CPU at the tiny MoE shape (`_moe_paths_card_vs_cpu`), then at
    full width, bf16, from `_moe_routed`'s checkpoints (a seeded normal
    router): (a) phase 5's traffic with int8 decode weights, the
    decode step graphed (weight bytes against phase 53's native run, K1
    12 per prefill dispatch); (b) `--paged --speculate 4` with the tiny
    drafter on phase 53's paged mix (`_check_spec_run`: K3 per round split
    into drafter steps and verifies); (c) the router fleet of two replicas
    (8 slots, 40 pages each) on phase 50's traffic, its dropped share; (d)
    `--paged --cp 2` over gloo at CP_LAYERS, 4 long requests
    (`_check_cp_serve_rank`); (e) evaluate and generate at --cp_size 2 on
    phase 52's newest checkpoint (K2 and K3 per rank exactly
    `_moe_eval_want`).
    Returns each run's launches."""
    import dataclasses
    import math
    from distributed_pytorch_from_scratch_tpu_torch import (evaluate,
                                                            generate, train)
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        paged_attention)
    from distributed_pytorch_from_scratch_tpu_torch.serving import (
        serve, serve_fleet)
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        PagedEngine)
    from distributed_pytorch_from_scratch_tpu_torch.serving.kv_manager import (
        page_bytes)
    cfg = model_preset(MOE, compute_dtype="bfloat16")
    layers, vocab = cfg.num_layers, cfg.vocab_size
    in_vocab = lambda outs: bool(outs) and all(
        0 <= t < vocab for ts in outs for t in ts)
    _moe_paths_card_vs_cpu(torch)
    res = {}
    t0 = time.perf_counter()
    routed = {n: _moe_routed(torch, workdir, n) for n in (layers, CP_LAYERS)}
    log(f"moe_paths: the routed checkpoints at {layers} and {CP_LAYERS} "
        f"layers written in {time.perf_counter() - t0:.1f} s")

    # (a) int8 decode weights, slot engine
    _reset_launches()
    out = serve.main(_from_ckpt(MOE_SERVE_ARGS, routed[layers]) + MOE_INT8)
    counts = _read_launches()
    st = out["engine_stats"]
    native = (moe_served or {}).get("slot_out")
    experts = layers * cfg.num_experts * 3 * cfg.attn_dim * cfg.ffn_dim
    log(f"moe_paths a (slot, int8 weights): {out['completed']}/"
        f"{out['requests']} requests, {out['generated_tokens']} tokens: "
        f"TTFT p50 {out['ttft_ms_p50']} ms, TPOT p50 {out['tpot_ms_p50']} "
        f"ms, {out['tokens_per_sec']} tok/s; weight bytes "
        f"{st['weight_bytes']} ({experts} expert parameters at 1 B + "
        f"scales + the rest)"
        + (f" vs native {native['weight_bytes']} (ratio "
           f"{st['weight_bytes'] / native['weight_bytes']:.4f}), native "
           f"TTFT p50 {native['ttft_ms_p50']} ms, TPOT p50 "
           f"{native['tpot_ms_p50']} ms (phase 53 of this run)" if native
           else "; phase 53 did not run in this call")
        + f"; dropped share {st['moe_dropped_share']:.4f}; decode graph "
        f"{out['decode_graph']} ({out['decode_graph_replays']} replays); "
        f"launches {counts}")
    if out["completed"] != out["requests"] or not in_vocab(
            out["outputs"].values()):
        raise AssertionError("moe int8 slot serving: requests or tokens "
                             "wrong")
    _routed_drops("moe int8 slot serving", st["moe_dropped_share"])
    if not (out["decode_graph"]
            and out["decode_graph_replays"] == st["decode_steps"]):
        raise AssertionError("moe int8: the decode step did not run as a "
                             "graph")
    if native and not 0.2 < st["weight_bytes"] / native["weight_bytes"] < 0.3:
        raise AssertionError(f"moe int8 weights hold {st['weight_bytes']} "
                             f"bytes against {native['weight_bytes']}")
    _only(counts, {"flash_attention_fwd": layers * out["prefill_dispatches"]},
          f"moe int8 slot serving ({layers} per prefill dispatch)")
    res["int8"] = counts

    # (b) speculative decoding, the tiny drafter
    _reset_launches()
    out = serve.main(_from_ckpt(MOE_SPEC_ARGS, routed[layers]))
    counts = _read_launches()
    by_route = dict(paged_attention.launches_by_route)
    by_kernel = dict(paged_attention.launches_by_kernel)
    dlayers = model_preset("tiny").num_layers
    _check_spec_run("moe", out, counts, by_route, by_kernel, layers, dlayers)
    st = out["engine_stats"]
    _routed_drops("moe speculative", st["moe_dropped_share"])
    rounds = st["spec_rounds"]
    log(f"moe_paths b (--paged --speculate {SPEC_K}, tiny drafter): "
        f"{out['completed']}/{out['requests']} requests, TTFT p50 "
        f"{out['ttft_ms_p50']} ms, TPOT p50/p95 {out['tpot_ms_p50']}/"
        f"{out['tpot_ms_p95']} ms; {rounds} rounds, accepted tokens per "
        f"dispatch {st['accepted_tokens_per_dispatch']}, acceptance "
        f"{st['acceptance_rate']}; dropped share "
        f"{st['moe_dropped_share']:.4f}; K3 per round: drafter steps "
        f"{dlayers * (SPEC_K + 1)} (decode route), verify {layers} (chunk "
        f"route), over the rounds {dlayers * (SPEC_K + 1) * rounds} + "
        f"{layers * rounds}; K3 in all by route {by_route}, by kernel "
        f"{by_kernel} (checked); graph replays {out['decode_graph_replays']}")
    res["spec"] = by_kernel

    # (c) the router fleet
    args = serve_fleet.parse_args(_from_ckpt(MOE_FLEET_ARGS, routed[layers])
                                  + ["--log_dir",
                                     os.path.join(workdir, "moe_fleet")])
    _reset_launches()
    out, fleet = serve_fleet.run(args)
    torch.cuda.synchronize()
    counts = _read_launches()
    by_route = dict(paged_attention.launches_by_route)
    by_kernel = dict(paged_attention.launches_by_kernel)
    engines = [e for e in fleet.values() if isinstance(e, PagedEngine)]
    if out["completed"] != args.num_requests or not in_vocab(
            [r.tokens for e in engines for r in e.completed]):
        raise AssertionError(f"moe fleet: served {out['completed']} of "
                             f"{args.num_requests}, or tokens wrong")
    for i, e in enumerate(engines):
        _drained(e, f"moe fleet r{i}")
    _routed_drops("moe fleet", out["moe_dropped_share"])
    want = _fleet_want(engines, layers)
    _only(counts, {"paged_attention": want["decode"] + want["chunk"]},
          "moe fleet")
    if by_route != want:
        raise AssertionError(f"moe fleet: K3 by route {by_route}, expected "
                             f"{want}")
    hits = [e.stats()["prefix_hit_tokens"] for e in engines]
    log(f"moe_paths c (fleet of 2 x 8 slots, 40 pages): {out['completed']}/"
        f"{args.num_requests} requests, {out['fleet_tokens_per_sec']} tok/s, "
        f"dispatch ms p50/p95 {out['dispatch_ms_p50']}/"
        f"{out['dispatch_ms_p95']}, TPOT p50 {out['tpot_ms_p50']} ms, "
        f"dispatched {fleet['router'].dispatched}, prefix hit tokens {hits}; "
        f"dropped share {out['moe_dropped_share']:.4f}; K3 by route "
        f"{by_route}, by kernel {by_kernel} (checked)")
    res["fleet"] = by_kernel
    del fleet, engines

    # (d) cp-sharded pages over two gloo ranks
    out = serve.main(_from_ckpt(MOE_CP_ARGS, routed[CP_LAYERS]))
    ranks, st = out["ranks"], out["engine_stats"]
    if out["completed"] != out["requests"] or not in_vocab(
            out["outputs"].values()):
        raise AssertionError("moe cp 2 serving: requests or tokens wrong")
    _routed_drops("moe cp 2", st["moe_dropped_share"])
    each = page_bytes(dataclasses.replace(cfg, num_layers=CP_LAYERS), 64)
    for r in ranks:
        if (r["dispatches"], r["dispatch_shapes"]) != (
                ranks[0]["dispatches"], ranks[0]["dispatch_shapes"]):
            raise AssertionError("moe cp 2: the ranks ran different "
                                 "dispatches")
        _check_cp_serve_rank("moe cp 2", r, CP_LAYERS)
        if r["pool_bytes"] != each * (st["pages_per_rank"] + 1):
            raise AssertionError(f"moe cp 2: rank {r['rank']} pool bytes "
                                 f"{r['pool_bytes']}")
    log(f"moe_paths d (--paged --cp 2, {CP_LAYERS} layers, gloo): "
        f"{out['completed']}/{out['requests']} requests, TTFT p50 "
        f"{out['ttft_ms_p50']} ms, TPOT p50/p95 {out['tpot_ms_p50']}/"
        f"{out['tpot_ms_p95']} ms; pool bytes per rank "
        f"{[r['pool_bytes'] for r in ranks]} ({st['pages_per_rank']} pages "
        f"+ scratch each); dropped share {st['moe_dropped_share']:.4f}; K3 "
        f"per rank {[r['paged_launches_by_kernel'] for r in ranks]} "
        f"(checked)")
    res["cp2"] = [r["paged_launches_by_kernel"] for r in ranks]

    # (e) evaluate and generate at --cp_size 2 on phase 52's newest
    # checkpoint (linked alone into a directory of its own)
    from distributed_pytorch_from_scratch_tpu_torch.training.checkpoint import (
        latest_step, list_checkpoints)
    src = os.path.join(workdir, "moe")
    ckpt = os.path.join(workdir, "moe_newest")
    os.makedirs(ckpt, exist_ok=True)
    if latest_step(src) is None:
        log("moe_paths e: phase 52 did not run in this call; 2 steps of its "
            "cell write the checkpoint")
        train.main(_replace_flag(_replace_flag(
            MOE_TRAIN_ARGS, "--max_steps", "2"), "--save_interval", "2")
            + ["--data_path", _corpus(workdir), "--save_dir", src])
    newest = latest_step(src)
    for it, path in list_checkpoints(src):
        if it == newest:
            os.link(path, os.path.join(ckpt, os.path.basename(path)))
    summary = os.path.join(workdir, "moe_eval_cp2.json")
    t0 = time.perf_counter()
    evaluate.main(MOE_EVAL_ARGS + ["--data_path", _corpus(workdir),
                                   "--ckpt_dir", ckpt, "--summary_json",
                                   summary])
    wall = time.perf_counter() - t0
    with open(summary) as f:
        s = json.load(f)
    want = _moe_eval_want(layers, s)
    for r, w in zip(s["ranks"], want):
        _only(r["launches"], w, f"moe evaluate cp 2 rank {r['rank']}")
    losses = s["val_losses"]
    if not losses or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"moe evaluate cp 2: losses {losses}")
    texts = generate.main(["--ckpt_dir", ckpt, "-t", TOKENIZER, "--model",
                           MOE, "--max_new_tokens", "16", "--cp_size", "2",
                           "--dist_backend", "gloo"]
                          + [a for p in MOE_GEN_PROMPTS
                             for a in ("--prompt", p)])
    if len(texts) != len(MOE_GEN_PROMPTS) or not all(
            t.startswith(p) for t, p in zip(texts, MOE_GEN_PROMPTS)):
        raise AssertionError(f"moe generate cp 2: {texts}")
    log(f"moe_paths e (evaluate --cp_size 2 on phase 52's iteration "
        f"{newest}, "
        f"{wall:.1f} s): val losses {losses}; sweep tokens/s "
        + ", ".join(f"iter {it}: {s['sweep_tokens'][it] / s['sweep_s'][it]:.1f}"
                    for it in sorted(losses, key=int))
        + f"; decode {s['prefill_dispatches']} chunks + {s['decode_steps']} "
        f"steps; K2 and K3 per rank {[r['launches'] for r in s['ranks']]} "
        f"(checked); generate --cp_size 2: {texts}")
    res["eval_cp2"] = [r["launches"] for r in s["ranks"]]
    return res


ZERO_STEPS = 3
ZERO_ARGS = CP_ARGS + ["--dp_size", "2", "--dist_backend", "gloo",
                       "--max_steps", str(ZERO_STEPS), "--num_layers",
                       str(CP_LAYERS)]
ZERO_RUNS = {  # name: flags
    "zero0": ["--zero", "0"],
    "zero1": ["--zero", "1", "--dp_reduce_bucket_mb", "25"],
    "zero2": ["--zero", "2"], "zero3": ["--zero", "3"],
    "zero2_bf16": ["--zero", "2", "--dp_reduce_dtype", "bf16"],
    "zero2_int8": ["--zero", "2", "--dp_reduce_dtype", "int8"],
}
ZERO_STATE = ("params", "grads", "moments")


def _smi() -> str:
    """nvidia-smi's name and power limit of card 0."""
    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _zero_rank_line(r: dict) -> str:
    """One rank's held bytes, peak and dp/batch hops per step."""
    held = r["state_bytes"]
    hops = "; ".join(
        f"{a} {h['calls']:g} calls, {h['bytes'] / 1e6:.1f} MB, ring "
        f"{h['ring_bytes'] / 1e6:.1f} MB" for a, h in
        r["hops_per_step"].items() if a in ("dp", "batch"))
    return (f"rank {r['rank']}: held params {held['params'] / 1e9:.4f} GB, "
            f"grads {held['grads'] / 1e9:.4f} GB, moments "
            f"{held['moments'] / 1e9:.4f} GB (sum "
            f"{sum(held.values()) / 1e9:.4f}, by the count "
            f"{r['expected_state_bytes'] / 1e9:.4f}); peak of the steps "
            f"{r['peak_mem_steps_gib']:.3f} GiB (with the final save "
            f"{r['peak_mem_gib']:.3f}); per step {hops}")


def _zero_card_vs_cpu(torch) -> None:
    """Tiny widths, f32, dp 2 x tp 2 with SP in the kept group of four: the
    stage-3 and the int8-wired stage-2 gradients on the card against the
    CPU, and the int8 ring over dp 4 on the same inputs."""
    import dataclasses
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        IGNORE_INDEX, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.interop import (
        params_to_jax)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        launch, tp_checks)
    cfg = model_preset("tiny", maxlen=128, compute_dtype="float32")
    tree = params_to_jax(Transformer(cfg).init_weights(seed=9).state_dict())
    rng = np.random.default_rng(9)
    b, t = 4, 128
    ids = rng.integers(3, cfg.vocab_size, size=(b, t + 1))
    tgt = ids[:, 1:].copy()
    tgt[1, 90:] = IGNORE_INDEX
    batch = (ids[:, :-1], tgt, np.tile(np.arange(t), (b, 1)))
    runs = [dict(stage=3, sp=True, batch=batch, grads=True),
            dict(stage=2, wire="int8", bucket_mb=0.25, sp=True, batch=batch,
                 grads=True)]
    x = rng.standard_normal((4, 5000)).astype(np.float32)
    blocks = rng.standard_normal((4, 4, 2048)).astype(np.float32)
    todo = [("zero_runs", {"dp": 2, "tp": 2},
             dict(cfg=dataclasses.asdict(cfg), tree=tree, runs=runs)),
            ("int8_ring", {"dp": 4}, dict(x=x, blocks=blocks))]
    res = launch.spawn(tp_checks.jobs, 4, todo, ("cuda", "cpu"), "gloo")
    for i, (what, bound) in enumerate((("stage 3", 1e-4),
                                       ("stage 2, int8 wire", 2.0 ** -4))):
        rel, worst, worst_key, off = 0.0, 0.0, None, 0
        for r, (card_z, _, cpu_z, _) in enumerate(res):
            card, cpu = card_z[i], cpu_z[i]
            rel = max(rel, abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]))
            for k, g in cpu["grads"].items():
                top = max(float(np.abs(g).max()), 1e-30)
                diff = np.abs(card["grads"][k] - g)
                off += int((diff > 1e-4 * top).sum())
                if diff.max() / top > worst:
                    worst, worst_key = float(diff.max() / top), f"rank {r} {k}"
        log(f"zero card vs cpu, {what}: tiny widths, f32, dp 2 x tp 2 with "
            f"SP, b{b} x t{t}: loss rel diff {rel:.3e} (tol 1e-5); worst "
            f"reduced gradient {worst_key}: {worst:.3e} of its max (tol "
            f"{bound:g}); {off} elements beyond 1e-4 of their leaf's max")
        if not (rel <= 1e-5 and worst <= bound):
            raise AssertionError(f"zero {what}: the card and the CPU "
                                 f"disagree")
    for r, (_, card, _, cpu) in enumerate(res):
        for k in ("allreduce", "reduce_scatter"):
            if card[k].tobytes() != cpu[k].tobytes():
                raise AssertionError(f"int8 ring {k} on rank {r}: the card "
                                     f"and the CPU differ")
    log("zero card vs cpu: the int8 ring over dp 4 (all-reduce of 5000 "
        "and reduce-scatter of 4 x 2048 values) bitwise the same on the "
        "card and the CPU, every rank")


def phase_zero_train(torch, workdir: str) -> dict:
    """ZeRO 0-3 and the dp wires at 45m dp 2 (phase 55); returns each run's
    K1 launches summed over its ranks."""
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    layers = CP_LAYERS
    base = ZERO_ARGS + ["--data_path", _corpus(workdir)]
    card = _smi()
    out, held, first = {}, {}, None
    for name, flags in ZERO_RUNS.items():
        save = os.path.join(workdir, f"zero_{name}")
        t0 = time.perf_counter()
        res = train.main(base + flags + ["--save_dir", save])
        wall = time.perf_counter() - t0
        losses = res["losses"]
        if len(losses) != ZERO_STEPS or not all(math.isfinite(x)
                                                for x in losses):
            raise AssertionError(f"zero {name}: losses not finite or not "
                                 f"{ZERO_STEPS}: {losses}")
        first = losses[0] if first is None else first
        if not abs(losses[0] - first) <= 1e-3 * abs(first):
            raise AssertionError(f"zero {name}: step-1 loss {losses[0]} vs "
                                 f"stage 0's {first}")
        summed = {}
        for r in res["ranks"]:
            _only(r["launches"], _flash_want(layers, ZERO_STEPS),
                  f"zero {name} rank {r['rank']} ({ZERO_STEPS} steps)")
            for k, v in r["launches"].items():
                summed[k] = summed.get(k, 0) + v
            got = sum(r["state_bytes"].values())
            want = r["expected_state_bytes"]
            if got != want:
                raise AssertionError(f"zero {name} rank {r['rank']}: holds "
                                     f"{r['state_bytes']}, the count is "
                                     f"{want}")
        held[name] = res["ranks"][0]["state_bytes"]
        out[name] = summed
        log(f"zero_train {name} ({card}): {ZERO_STEPS} steps of 45m b{CP_B} x "
            f"t{CP_T} bf16 at dp {res['dp']} over {res['dist_backend']} on "
            f"{res['cards']} card(s), stage {res['zero_stage']}, wire "
            f"{res['dp_reduce_dtype']}, {res['buckets']} bucket(s) of <= "
            f"{res['dp_reduce_bucket_mb']:g} MiB, {wall:.1f} s of run, "
            f"{sum(r['wall_s'] for r in res['ranks'][:1]):.1f} of steps: "
            f"losses {[round(x, 4) for x in losses]}; step p50 "
            f"{res['step_ms_p50']:.3f} ms, {res['tokens_per_sec']:.1f} "
            f"tok/s; " + "; ".join(_zero_rank_line(r) for r in res["ranks"])
            + f"; K1 per rank per step fwd {2 * layers}, dq {layers}, dk/dv "
            f"{layers} (checked)")
    total = {k: sum(v.values()) for k, v in held.items()}
    if not total["zero0"] > total["zero1"] > total["zero2"] > total["zero3"]:
        raise AssertionError(f"zero: held bytes do not fall stage by stage: "
                             f"{total}")
    if total["zero0"] - total["zero1"] != (held["zero0"]["moments"]
                                          - held["zero1"]["moments"]):
        raise AssertionError("zero 1 saved more than moments")
    log(f"zero_train: rank 0's held bytes by stage {total}: stage 1 saves "
        f"{(total['zero0'] - total['zero1']) / 1e9:.4f} GB (of moments "
        f"{held['zero0']['moments'] / 1e9:.4f}), stage 2 "
        f"{(total['zero1'] - total['zero2']) / 1e9:.4f} more, stage 3 "
        f"{(total['zero2'] - total['zero3']) / 1e9:.4f} more")
    save = os.path.join(workdir, "zero_zero2")
    resumed = train.main(_replace_flag(base, "--max_steps",
                                       str(ZERO_STEPS + 1))
                         + ["--zero", "0", "--resume", "--save_dir", save])
    summed = {}
    for r in resumed["ranks"]:
        _only(r["launches"], _flash_want(layers, 1),
              f"zero2 resumed at stage 0, rank {r['rank']} (1 step)")
        for k, v in r["launches"].items():
            summed[k] = summed.get(k, 0) + v
    out["zero2_resumed_zero0"] = summed
    log(f"zero_train: the stage-2 checkpoint resumed at stage 0 from step "
        f"{resumed['start_step']}: losses {resumed['losses']}; K1 launches "
        f"summed over the ranks {summed} (checked per rank)")
    if (resumed["start_step"] != ZERO_STEPS
            or resumed["steps"] != ZERO_STEPS + 1
            or not all(math.isfinite(x) for x in resumed["losses"])):
        raise AssertionError("the stage-2 checkpoint did not resume at "
                             "stage 0")
    _zero_card_vs_cpu(torch)
    return out


# pp_train: the 45m preset at full width and depth (12 layers, 6 per
# stage), b 8 x t 1000 bf16 with remat, two ranks on the card over gloo
PP_M = 4               # microbatches of 2 rows
PP_STEPS = 4
PP_ARGS = CP_ARGS + ["--pp_size", "2", "--dist_backend", "gloo",
                     "--pp_microbatches", str(PP_M)]
PP_RUNS = {  # name: (flags, steps)
    "pp2": ([], PP_STEPS),
    "pp2_interleaved": (["--pp_schedule", "interleaved", "--pp_virtual",
                         "2"], PP_STEPS),
    "pp2_remat_steps": (["--pp_remat_steps"], 2),
}


def _pp_fwd(per_block: int, remat_steps: bool) -> int:
    """K1 forwards per microbatch through a block of `per_block` layers
    under remat: two per layer, and under `--pp_remat_steps` the stage
    step's replay as well, which stops once it has the input of the last
    layer's own checkpoint (torch's early stop): per_block - 1 more."""
    return 2 * per_block + (per_block - 1 if remat_steps else 0)
# the card-vs-CPU check's tiny shape: 4 layers (one per interleaved block),
# f32, b 4 x t 64
PP_TINY = dict(num_layers=4, maxlen=64, compute_dtype="float32")


def _pp_tiny_tree(seed: int = 0):
    """A JAX-layout numpy tree of the tiny pp shape, from the port's seeded
    init (`tp_checks.model_runs` loads JAX-layout trees)."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.interop import (
        params_to_jax)
    from distributed_pytorch_from_scratch_tpu_torch.models import build_model
    model = build_model("llama", model_preset("tiny", **PP_TINY))
    return params_to_jax(model.init_weights(seed).state_dict())


def _pp_card_vs_cpu(torch) -> None:
    """pp 2 (gpipe, interleaved) and pp 2 x tp 2 at the tiny shape, f32:
    the loss within 1e-5 and every gradient within 1e-4 of its leaf's
    max, on the card against the same ranks on the CPU and against one
    rank on the card at pp 1."""
    import dataclasses
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.parallel.layout import (
        shard_params)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        launch, tp_checks)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    cfg = dataclasses.asdict(model_preset("tiny", **PP_TINY))
    tree = _pp_tiny_tree()
    rng = np.random.default_rng(7)
    ids = rng.integers(0, cfg["vocab_size"], size=(4, 65))
    batch = [np.ascontiguousarray(a, dtype=np.int32) for a in (
        ids[:, :-1], ids[:, 1:], np.broadcast_to(np.arange(64), (4, 64)))]
    runs = {"pp2": {}, "pp2_interleaved": dict(pp_schedule="interleaved")}
    job = lambda axes, run: ("model_runs", axes, dict(
        cfg=cfg, tree=tree, runs=[dict(run, batch=batch)]))
    one = tp_checks.model_runs(make_mesh(MeshConfig(), device="cuda"), cfg,
                               tree, [dict(batch=batch)])[0]
    two = launch.spawn(tp_checks.jobs, 2, [job({"pp": 2}, r)
                                           for r in runs.values()],
                       ("cuda", "cpu"))
    four = launch.spawn(tp_checks.jobs, 4, [job({"pp": 2, "tp": 2}, {})],
                        ("cuda", "cpu"))
    worst = {}

    def held(name, card, ref, tp):
        loss_err = abs(card["loss"] - ref["loss"]) / abs(ref["loss"])
        want = shard_params({k: torch.from_numpy(v)
                             for k, v in ref["grads"].items()}, tp,
                            card["coords"]["tp"]) if tp > 1 else None
        grad_err = 0.0
        for k, g in card["grads"].items():
            r = ref["grads"][k] if want is None else want[k].numpy()
            top = max(float(np.abs(r).max()), 1e-30)
            grad_err = max(grad_err, float(np.abs(g - r).max()) / top)
        worst[name] = max(worst.get(name, 0.0), grad_err)
        if not (loss_err <= 1e-5 and grad_err <= 1e-4):
            raise AssertionError(f"pp card vs cpu {name}: loss err "
                                 f"{loss_err:.3e}, grad err/max "
                                 f"{grad_err:.3e}")

    for i, name in enumerate(runs):
        for rank in two:
            card, cpu = rank[i][0], rank[len(runs) + i][0]
            held(f"{name} card vs cpu", card, cpu, 1)
            held(f"{name} vs pp 1", card, one, 1)
    for rank in four:
        held("pp2 x tp2 card vs cpu", rank[0][0], rank[1][0], 1)
        held("pp2 x tp2 vs pp 1", rank[0][0], one, 2)
    log(f"pp_train card vs cpu (tiny, f32, b 4 x t 64, 4 layers): worst "
        f"gradient err / max {worst} (limit 1e-4; losses within 1e-5)")


def phase_pp_train(torch, workdir: str) -> dict:
    """`train --pp_size 2` at the 45m preset (phase 57): gpipe and
    interleaved, the card against the CPU at the tiny shape, the pp 2
    checkpoint resumed at pp 1 through the planner and resharded by the
    offline CLI into a tp 2 set. Returns each run's K1 launches summed
    over its ranks."""
    import glob
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.reshard import (
        reshard_ckpt)
    layers = 12
    per_stage = layers // 2
    card = _smi()
    base = PP_ARGS + ["--data_path", _corpus(workdir), "--max_steps",
                      str(PP_STEPS)]
    # pp 1 on the same batches: the reference trajectory of every pp run
    ref = train.main(CP_ARGS + ["--data_path", _corpus(workdir),
                                "--max_steps", str(PP_STEPS), "--save_dir",
                                os.path.join(workdir, "pp1")])["losses"]
    out, worst = {}, {}
    for name, (flags, steps) in PP_RUNS.items():
        save = os.path.join(workdir, name)
        res = train.main(base + flags + ["--max_steps", str(steps),
                                         "--save_dir", save])
        losses = res["losses"]
        if len(losses) != steps or not all(math.isfinite(x)
                                           for x in losses):
            raise AssertionError(f"{name}: losses not finite or not "
                                 f"{steps}: {losses}")
        blocks = res["pp_virtual"]
        per = per_stage // blocks
        fwd = blocks * _pp_fwd(per, res["pp_remat_steps"])
        # OneCycle's warmup does not depend on --max_steps, so a 2-step
        # run's losses are the pp 1 run's first two
        worst[name] = max(abs(a - b) for a, b in zip(losses, ref))
        summed = {}
        for r in res["ranks"]:
            # every microbatch through each of the stage's layers
            _only(r["launches"], dict(
                _flash_want(per_stage, steps * PP_M),
                flash_attention_fwd=fwd * steps * PP_M),
                f"{name} rank {r['rank']} ({steps} steps of {PP_M} "
                f"microbatches)")
            for k, v in r["launches"].items():
                summed[k] = summed.get(k, 0) + v
        out[name] = summed
        pp = lambda r: r["hops_per_step"]["pp"]
        log(f"pp_train {name} ({card}): {steps} steps of 45m b{CP_B} x "
            f"t{CP_T} bf16, {layers} layers over pp {res['pp']} "
            f"({res['pp_schedule']}, {res['pp_microbatches']} microbatches"
            f", {res['pp_virtual']} block(s) per stage, remat steps "
            f"{res['pp_remat_steps']}) over "
            f"{res['dist_backend']} on {res['cards']} card(s): losses "
            f"{[round(x, 4) for x in losses]}; step p50 "
            f"{res['step_ms_p50']:.3f} ms, {res['tokens_per_sec']:.1f} "
            f"tok/s; pp hops per step " + "; ".join(
                f"rank {r['rank']} {pp(r)['calls']:g} calls, "
                f"{pp(r)['bytes'] / 1e6:.2f} MB, host {pp(r)['host_ms']:.1f}"
                f" ms" for r in res["ranks"]) + "; " + "; ".join(
                f"rank {r['rank']} peak {r['peak_mem_gib']:.3f} GiB, held "
                f"{sum(r['state_bytes'].values())} B" for r in res["ranks"])
            + f"; K1 per rank per step fwd {fwd * PP_M}, dq "
            f"{per_stage * PP_M}, dk/dv {per_stage * PP_M} (checked)")
    log(f"pp_train: pp 1 on the same batches: losses "
        f"{[round(x, 4) for x in ref]}; worst |pp 2 - pp 1| per run "
        f"{worst} (limit 1e-2 absolute)")
    if not all(w <= 1e-2 for w in worst.values()):
        raise AssertionError(f"pp 2 losses disagree with pp 1: {worst}")
    _pp_card_vs_cpu(torch)
    # the pp 2 checkpoint resumed at pp 1 (another layout: the planner)
    save = os.path.join(workdir, "pp2")
    resumed = train.main(CP_ARGS + ["--data_path", _corpus(workdir),
                                    "--max_steps", str(PP_STEPS + 2),
                                    "--save_dir", save, "--resume"])
    info = resumed["reshard"]
    _only(resumed["ranks"][0]["launches"], _flash_want(layers, 2),
          "pp2 resumed at pp 1 (2 steps)")
    out["pp2_resumed_pp1"] = dict(resumed["ranks"][0]["launches"])
    log(f"pp_train: the pp 2 checkpoint resumed at pp 1 from step "
        f"{resumed['start_step']}: losses {resumed['losses']}; "
        f"reshard_event {info}")
    if (resumed["start_step"] != PP_STEPS or info is None
            or info["src"] != "pp2 zero0"
            or info["peak_host_bytes"] > info["max_leaf_bytes"]
            or not all(math.isfinite(x) for x in resumed["losses"])):
        raise AssertionError("the pp 2 checkpoint did not resume at pp 1 "
                             "through the planner")
    dst = os.path.join(workdir, "pp2_as_tp2")
    rec = reshard_ckpt.main(["--src", save, "--dst", dst, "--tp", "2",
                             "--iter", str(PP_STEPS)])
    files = sorted(glob.glob(os.path.join(dst, "tprank-*.npz")))
    log(f"pp_train: the pp 2 checkpoint resharded to tp 2 by the CLI: "
        f"{len(files)} files, {rec['bytes_moved']} bytes moved, ops "
        f"{rec['ops']}, peak host {rec['peak_host_bytes']} B (largest leaf "
        f"{rec['max_leaf_bytes']} B), {rec['wall_ms']} ms")
    if len(files) != 2 or rec["peak_host_bytes"] > rec["max_leaf_bytes"]:
        raise AssertionError("the reshard CLI did not write a tp 2 set "
                             "within one leaf of host memory")
    return out


# phase 58: the tp ring collective matmuls at the 45m preset, all 12 layers
OV_STEPS = 3
OV_ARGS = CP_ARGS + TP2 + ["--sequence_parallel", "--max_steps",
                           str(OV_STEPS), "--num_layers", str(CP_LAYERS)]
OV_MODES = ("off", "ring", "ring_q")
OV_TOL = {"ring": 1e-3, "ring_q": 1e-2}   # step losses vs off's, relative
# the tiny card-vs-CPU cases: (mesh axes, tp_overlap)
OV_TINY = {"tp2_ring": ({"tp": 2}, "ring"),
           "tp2_ring_q": ({"tp": 2}, "ring_q"),
           "tp2_cp2_ring": ({"cp": 2, "tp": 2}, "ring"),
           "pp2_tp2_ring": ({"pp": 2, "tp": 2}, "ring")}


def ring_hops_want(off: dict, layers: int, rows: int, d: int, item: int,
                   tp: int, mode: str) -> tuple:
    """(calls, bytes) of one rank's tp hops per train step at `mode`, from
    the same rank's per-step counts at 'off' (`off`: {calls, bytes}), under
    sequence parallelism and `--remat true`: the monolithic path's 11
    collectives per layer (the gathers before qkv and gate/up and the wo
    and down_proj reduce-scatters, their backwards, and the remat replay's,
    which stops before down_proj's reduce-scatter) and the head's 2 give
    way to the rings' hops, 14 (tp - 1) per layer (ag_matmul: forward,
    replay, the re-gather and dx rings; matmul_rs: forward, replay, the
    cotangent ring; each ring n - 1 hops) and 3 (tp - 1) for the head's
    ag_matmul. A gather carries the rank's (rows, d) chunk, a
    reduce-scatter the whole (tp rows, d); every ring hop a (rows, d)
    chunk: d x item bytes a row at 'ring', d int8 codes + one f32 scale at
    'ring_q'. Everything else (the embedding, the loss, the gradient
    reductions) is the same at every mode."""
    if mode == "off":
        return off["calls"], off["bytes"]
    chunk = rows * d * item
    hops = (14 * layers + 3) * (tp - 1)
    row = d * item if mode == "ring" else d + 4
    return (off["calls"] - 11 * layers - 2 + hops,
            off["bytes"] - (6 + 5 * tp) * layers * chunk - (1 + tp) * chunk
            + hops * rows * row)


def phase_tp_overlap_train(torch, workdir: str) -> dict:
    """`train --tp_size 2 --sequence_parallel --tp_overlap off | ring |
    ring_q` at the 45m widths, CP_LAYERS of its 12 layers (phase 58), then
    the tiny card-vs-CPU cases; returns each run's launches summed over its
    ranks."""
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    cfg = model_preset("45m")
    layers, card = CP_LAYERS, _smi()
    base = OV_ARGS + ["--data_path", _corpus(workdir)]
    res, out = {}, {}
    for mode in OV_MODES:
        r = res[mode] = train.main(base + ["--tp_overlap", mode,
                                           "--save_dir", os.path.join(
                                               workdir, f"ov_{mode}")])
        if len(r["losses"]) != OV_STEPS or not all(
                math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"tp_overlap {mode}: losses not finite or "
                                 f"not {OV_STEPS}: {r['losses']}")
        summed = {}
        for rank in r["ranks"]:
            _only(rank["launches"], _flash_want(layers, OV_STEPS),
                  f"tp_overlap {mode} rank {rank['rank']} ({OV_STEPS} "
                  f"steps)")
            for k, v in rank["launches"].items():
                summed[k] = summed.get(k, 0) + v
        out[mode] = summed
    rows = CP_B * CP_T // 2
    for mode in OV_MODES:
        r = res[mode]
        hops = [rank["hops_per_step"]["tp"] for rank in r["ranks"]]
        log(f"tp_overlap_train {mode} ({card}): {OV_STEPS} steps of 45m "
            f"b{CP_B} x t{CP_T} bf16, {layers} layers, tp 2 with sequence "
            f"parallelism over {r['dist_backend']} on {r['cards']} card(s):"
            f" losses {r['losses']}; step p50 {r['step_ms_p50']:.3f} ms, "
            f"{r['tokens_per_sec']:.1f} tok/s; tp hops per step "
            + "; ".join(f"rank {i} {h['calls']:g} calls, "
                        f"{h['bytes'] / 1e6:.3f} MB, host {h['host_ms']:.1f}"
                        f" ms" for i, h in enumerate(hops))
            + "; " + "; ".join(f"rank {rank['rank']} peak "
                               f"{rank['peak_mem_gib']:.3f} GiB"
                               for rank in r["ranks"])
            + f"; K1 per rank per step fwd {2 * layers}, dq {layers}, "
            f"dk/dv {layers} (checked)")
        if mode == "off":
            continue
        worst = max(abs(a - b) / abs(b) for a, b in zip(
            r["losses"], res["off"]["losses"]))
        log(f"tp_overlap_train {mode}: worst step loss vs off {worst:.3e} "
            f"relative (limit {OV_TOL[mode]})")
        if not worst <= OV_TOL[mode]:
            raise AssertionError(f"tp_overlap {mode}: losses disagree with "
                                 f"off's ({worst:.3e})")
        for rank, off_rank in zip(r["ranks"], res["off"]["ranks"]):
            got = rank["hops_per_step"]["tp"]
            want = ring_hops_want(off_rank["hops_per_step"]["tp"], layers,
                                  rows, cfg.attn_dim, 2, 2, mode)
            if (got["calls"], got["bytes"]) != want:
                raise AssertionError(
                    f"tp_overlap {mode} rank {rank['rank']}: tp hops per "
                    f"step {got['calls']} calls, {got['bytes']} B; "
                    f"expected {want}")
    hop_bytes = {m: rows * (cfg.attn_dim * 2 if m == "ring"
                            else cfg.attn_dim + 4) for m in OV_TOL}
    log(f"tp_overlap_train: one ring hop carries {hop_bytes['ring'] / 1e6:.3f}"
        f" MB at ring, {hop_bytes['ring_q'] / 1e6:.3f} MB at ring_q "
        f"({hop_bytes['ring_q'] / hop_bytes['ring']:.4f}); tp hops per step "
        f"(calls, bytes) as `ring_hops_want` derives them from off's "
        f"(checked on every rank)")
    _ov_card_vs_cpu(torch)
    return out


# card vs CPU gradient bound per tiny case, of the leaf's max: ring_q's
# int8 payloads flip a code where the card and the CPU round one value on
# either side of a half step (their partial products differ in the last
# bit), so it is held within the wire's 2^-4, as phase 55's int8 wire;
# its payload from the same input is byte-equal on both devices
OV_GRAD_TOL = {"tp2_ring_q": 2.0 ** -4}


def _ov_card_vs_cpu(torch) -> None:
    """The OV_TINY cases at the tiny shape (4 layers), f32, b 4 x t 64, with
    SP: the loss within 1e-5 and every gradient within 1e-4 of its leaf's
    max (ring_q: `OV_GRAD_TOL`), on the card against the same ranks on the
    CPU; ring_q's payload of one input byte-equal on the card and the
    CPU."""
    import dataclasses
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.ops import overlap
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        launch, tp_checks)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(8, 500, 512, generator=torch.Generator().manual_seed(
            58)).to(dtype)
        card = overlap._encode(x.cuda(), True)[0].cpu()
        if not torch.equal(card, overlap._encode(x, True)[0]):
            raise AssertionError(f"ring_q payload ({dtype}) differs between "
                                 f"the card and the CPU")
    log("tp_overlap_train: ring_q's payload of one (8, 500, 512) chunk "
        "byte-equal on the card and the CPU (f32 and bf16)")
    cfg = dataclasses.asdict(model_preset("tiny", **PP_TINY))
    tree = _pp_tiny_tree()
    rng = np.random.default_rng(11)
    ids = rng.integers(0, cfg["vocab_size"], size=(4, 65))
    batch = [np.ascontiguousarray(a, dtype=np.int32) for a in (
        ids[:, :-1], ids[:, 1:], np.broadcast_to(np.arange(64), (4, 64)))]
    job = lambda axes, mode: ("model_runs", axes, dict(
        cfg=cfg, tree=tree, runs=[dict(batch=batch, sp=True,
                                       tp_overlap=mode)]))
    worst = {}
    for n in (2, 4):
        names = [k for k, (axes, _) in OV_TINY.items()
                 if int(np.prod(list(axes.values()))) == n]
        res = launch.spawn(tp_checks.jobs, n, [job(*OV_TINY[k])
                                               for k in names],
                           ("cuda", "cpu"))
        for i, name in enumerate(names):
            for rank in res:
                card, cpu = rank[i][0], rank[len(names) + i][0]
                loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
                errs = {k: np.abs(g - cpu["grads"][k])
                        / max(float(np.abs(cpu["grads"][k]).max()), 1e-30)
                        for k, g in card["grads"].items()}
                grad_err = max(float(e.max()) for e in errs.values())
                w = worst.setdefault(name, [0.0, 0.0, 0])
                w[0], w[1] = max(w[0], loss_err), max(w[1], grad_err)
                w[2] += sum(int((e > 1e-4).sum()) for e in errs.values())
                if not (loss_err <= 1e-5
                        and grad_err <= OV_GRAD_TOL.get(name, 1e-4)):
                    raise AssertionError(
                        f"tp_overlap card vs cpu {name}: loss err "
                        f"{loss_err:.3e}, grad err/max {grad_err:.3e}")
    log(f"tp_overlap_train card vs cpu (tiny, f32, b 4 x t 64, 4 layers, "
        f"SP): worst (loss rel err, gradient err / max, gradient elements "
        f"beyond 1e-4 of their max over the ranks) per case {worst} "
        f"(limits 1e-5, 1e-4; ring_q's gradients {OV_GRAD_TOL})")


# phase 59: the one-shot decoder at the 45m preset
GD_LENS = (64, 128, 192, 256, 320, 384, 448, 512)
GD_NEW = 64
GD_EOS = 1
# bf16: the decoder's prefill and catch-up steps run their matmuls at
# other shapes than the slot engine's bucketed prefills, so the caches
# differ in the last bits and a near-tied argmax can flip; where a row's
# tokens part, the two tokens' logits at the shared prefix (a bf16
# forward of it) must lie within this share of the row's largest |logit|
GD_TIE = 2.0 ** -5


def _tie_gaps(torch, model, prompts, tokens, slot) -> list:
    """(row, first differing index, |logit a - logit b| / max |logit|) of
    every row where the decoder's tokens and the slot engine's part, the
    logits of the last position of a bf16 prefill of the shared prefix."""
    from distributed_pytorch_from_scratch_tpu_torch.models import decode
    gaps = []
    dev = model.embedding.weight.device
    tables = decode.decode_tables(model, model.cfg.maxlen, dev)
    for i, (x, y) in enumerate(zip(tokens, slot)):
        j = next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                 min(len(x), len(y)))
        if x == y:
            continue
        pick = lambda t: t[j] if j < len(t) else GD_EOS   # stopped: EOS
        prefix = list(prompts[i]) + x[:j]
        with torch.inference_mode():
            logits = decode._prefill(
                model, torch.tensor([prefix], device=dev),
                torch.tensor([len(prefix)], device=dev), *tables,
                torch.bfloat16)[2][0].float()
        gaps.append((i, j, float((logits[pick(x)] - logits[pick(y)]).abs()
                                 / logits.abs().max())))
    return gaps


def _slot_tokens(model, mesh, prompts, buf_len: int) -> tuple:
    """The slot engine's greedy tokens for `prompts` (GD_NEW new tokens
    each, 8 slots) on `model`, and its TPOT p50 in ms."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        ContinuousBatchingEngine, Request)
    eng = ContinuousBatchingEngine(model, mesh, num_slots=len(prompts),
                                   buf_len=buf_len, eos_id=GD_EOS,
                                   max_prefill_batch=4)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=list(p), max_new=GD_NEW))
    while eng.has_work():
        eng.step()
    done = sorted(eng.completed, key=lambda r: r.rid)
    tpot = [(r.finish_t - r.first_token_t) * 1e3 / (len(r.tokens) - 1)
            for r in done if len(r.tokens) > 1]
    return [list(r.tokens) for r in done], float(np.median(tpot))


def phase_greedy_decoder(torch) -> dict:
    """`GreedyDecoder` at the 45m preset, bf16 and f32, against the slot
    engine (phase 59), then the cp 2 ring prefill at the tiny widths;
    returns the launches of one bf16 generation and of the cp 2 one,
    summed over its ranks."""
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.decode import (
        GreedyDecoder)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    card = _smi()
    mesh = make_mesh(MeshConfig(), device="cuda")
    rng = np.random.default_rng(59)
    buf_len = max(GD_LENS) + GD_NEW
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = model_preset("45m", compute_dtype=dtype)
        prompts = [[int(x) for x in rng.integers(3, cfg.vocab_size, n)]
                   for n in GD_LENS]
        limits = [len(p) + GD_NEW for p in prompts]
        model = Transformer(cfg).init_weights(seed=59).to(mesh.device)
        dec = GreedyDecoder(model, mesh, buf_len)
        if dtype == "bfloat16":     # capture first: the timed call replays
            dec.decode_batch(prompts, GD_EOS, limits)
        _reset_launches()
        tokens = dec.decode_batch(prompts, GD_EOS, limits)
        launches = _read_launches()
        _only(launches, {"flash_attention_fwd": cfg.num_layers},
              f"greedy_decoder {dtype}: one generation")
        timing, syncs = dict(dec.timing), dec.host_syncs
        slot, tpot = _slot_tokens(model, mesh, prompts, buf_len)
        same = sum(a == b for a, b in zip(tokens, slot))
        log(f"greedy_decoder {dtype} ({card}): 45m, {cfg.num_layers} "
            f"layers, 8 prompts of {GD_LENS[0]}-{GD_LENS[-1]} tokens + "
            f"{GD_NEW} new, buf_len {buf_len}: {sum(map(len, tokens))} "
            f"tokens, {same}/8 rows equal to the slot engine's; prefill "
            f"{timing['prefill_ms']:.3f} ms (f32: with the step's capture), "
            f"{timing['steps']} decode steps"
            f" in {timing['loop_ms']:.3f} ms ("
            f"{timing['loop_ms'] / max(timing['steps'], 1):.3f} ms per "
            f"step, the step a CUDA graph) against the slot engine's TPOT "
            f"p50 {tpot:.3f} ms; {syncs} host syncs per generation; K1 "
            f"forward {launches['flash_attention_fwd']} launches per "
            f"generation (12: the prefill)")
        if dtype == "float32" and same != len(prompts):
            raise AssertionError("greedy_decoder f32: tokens differ from "
                                 "the slot engine's")
        if dtype == "bfloat16":
            gaps = _tie_gaps(torch, model, prompts, tokens, slot)
            log(f"greedy_decoder bf16: rows parting from the slot engine's "
                f"(row, first differing token, logit gap / max |logit| "
                f"there): {gaps} (limit {GD_TIE})")
            if any(g > GD_TIE for _, _, g in gaps):
                raise AssertionError("greedy_decoder bf16: a row parts from "
                                     "the slot engine's where the argmax is "
                                     "not a near tie")
        if dtype == "bfloat16":
            out["greedy_decoder"] = launches
        del model, dec
    out["greedy_decoder_cp2"] = _gd_cp2(torch)
    return out


def _gd_cp2(torch) -> dict:
    """The tiny widths, f32, on the kept pair at cp 2 (the ring prefill)
    against cp 1 on the card; returns the K2 launches summed over the
    ranks."""
    import dataclasses
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.ops.ring_attention import (
        block_schedule)
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        launch, tp_checks)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    cfg = dataclasses.asdict(model_preset("tiny", **PP_TINY))
    tree = _pp_tiny_tree(seed=5)
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(3, cfg["vocab_size"], n)]
               for n in (5, 17, 30, 44)]
    buf = 64
    run = dict(prompts=prompts, eos=GD_EOS, max_total_len=buf, buf_len=buf)
    one = tp_checks.generate_runs(make_mesh(MeshConfig(), device="cuda"),
                                  cfg, tree, [run])[0]
    two = launch.spawn(tp_checks.jobs, 2, [("generate_runs", {"cp": 2},
                                            dict(cfg=cfg, tree=tree,
                                                 runs=[run]))], ("cuda",))
    tl = buf // 2
    pos = np.stack([np.tile(np.arange(r * tl, (r + 1) * tl), (len(prompts),
                                                              1))
                    for r in range(2)])
    blocks = [sum(len(s) for s in rank) for rank in block_schedule(pos)]
    summed = {}
    for r, rank in enumerate(two):
        got = rank[0][0]
        _only(got["launches"], {"block_attention_fwd":
                                cfg["num_layers"] * blocks[r]},
              f"greedy_decoder cp 2 rank {r}")
        if got["tokens"] != one["tokens"]:
            raise AssertionError(f"greedy_decoder cp 2 rank {r}: tokens "
                                 f"differ from cp 1's")
        for k, v in got["launches"].items():
            summed[k] = summed.get(k, 0) + v
    log(f"greedy_decoder cp 2 (tiny, f32, {cfg['num_layers']} layers, 4 "
        f"prompts of 5-44 tokens, buf_len {buf}): tokens equal cp 1's on "
        f"the card on both ranks; K2 forward per rank "
        f"{[cfg['num_layers'] * n for n in blocks]} (the ring schedule's "
        f"blocks {blocks} per layer; checked), cp hops "
        f"{[rank[0][0]['cp_hops'] for rank in two]}, host syncs "
        f"{[rank[0][0]['host_syncs'] for rank in two]}")
    return summed


# fleet_tp: the tiny preset's f32 card-vs-CPU checks of every tp path,
# then the 45m runs (phase 15's mix, 8 requests, over gloo)
FLEET_TP_SEED = 23
FLEET_TP_PROMPTS = [[0, 5, 17, 33, 60, 2, 4, 6] + t for t in
                    ([7], [9, 11], [3, 5, 7, 11], [13], [21, 23], [25])]
FLEET_TP_ENGINE = dict(num_slots=4, buf_len=32, eos_id=1, page_size=8,
                       prefill_chunk=8)
FLEET_TP_TINY = ([dict(kind="fleet", tp=2)]
                 + [dict(kind="disagg", prefill_tp=p, decode_tp=d, kv=kv)
                    for p, d, kv in ((2, 1, None), (1, 2, None),
                                     (2, 2, None), (2, 1, "int8"))]
                 + [dict(kind="restart", tp=s, restart_tp=d,
                         prefix_weight=0.0) for s, d in ((2, 1), (1, 2))])
FLEET_TP_GLOO = ["--dist_backend", "gloo", "--num_requests", "8"]
FLEET_TP_RUNS = {"fleet_x2_tp2": ["--replicas", "2", "--tp_size", "2"],
                 "disagg_p2d1": ["--disagg", "--prefill_tp", "2"],
                 "restart_tp2_to_1": ["--replicas", "2", "--tp_size", "2",
                                      "--restart_tp", "1"]}


def _fleet_tp_tiny(torch) -> None:
    """Every tp path of the fleet at the tiny preset, f32, on the kept pair:
    the card's tokens the CPU's; each native run's the router fleet's."""
    import dataclasses

    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.runtime import (
        fleet_checks, launch)
    cfg = dataclasses.asdict(dataclasses.replace(
        model_preset("tiny"), compute_dtype="float32"))
    reqs = [(p, 6) for p in FLEET_TP_PROMPTS]
    runs = [dict(run, requests=reqs, requests2=reqs) for run in FLEET_TP_TINY]
    todo = [("fleet_runs", dict(cfg=cfg, tree=None, runs=runs,
                                engine_kw=FLEET_TP_ENGINE,
                                seed=FLEET_TP_SEED))]
    got = {dev: launch.spawn(fleet_checks.jobs, 2, todo, dev)[0][0]
           for dev in ("cuda", "cpu")}
    torch.cuda.synchronize()
    names = [f"{r['kind']}" + (f" p{r['prefill_tp']}d{r['decode_tp']} "
                               f"{r.get('kv') or 'native'}"
                               if r["kind"] == "disagg" else
                               f" tp{r['tp']}" + (f"->{r['restart_tp']}"
                                                  if "restart_tp" in r
                                                  else ""))
             for r in runs]
    ref = got["cpu"][0]["tokens"]
    for name, card, cpu in zip(names, got["cuda"], got["cpu"]):
        if card["tokens"] != cpu["tokens"]:
            raise AssertionError(f"fleet_tp {name}: the card's tokens "
                                 f"differ from the CPU's")
        if not all(card["drained"]):
            raise AssertionError(f"fleet_tp {name}: a pool did not drain")
        native = "int8" not in name
        want = ({**ref, **{k + 100: v for k, v in ref.items()}}
                if "restart" in name else ref)
        if native and cpu["tokens"] != want:
            raise AssertionError(f"fleet_tp {name}: tokens differ from the "
                                 f"tp 2 router fleet's")
    if not any(ref.values()):
        raise AssertionError("fleet_tp: no tokens generated")
    log(f"fleet_tp: the tiny preset, f32, 6 requests behind one shared "
        f"page, on the kept pair: {', '.join(names)} give the CPU's tokens "
        f"on the card, every native run the tp 2 router fleet's, every pool "
        f"drained")


def _fleet_tp_want(rank: dict, layers: int) -> dict:
    """K3's launches a rank's dispatches imply, by route, over every engine
    it held (each rank of an engine runs each of its dispatches)."""
    decode = chunk = 0
    for shapes in rank["dispatch_shapes"].values():
        for kind, shape, n in shapes:
            if kind == "paged_decode":
                decode += n
            elif kind == "paged_chunk":
                if shape[0] == 1:
                    decode += n
                else:
                    chunk += n
    return {"decode": layers * decode, "chunk": layers * chunk}


def _hops_line(rank: dict) -> str:
    return ", ".join(
        f"{k} {rank[k]['calls']} calls {rank[k]['bytes']} B "
        f"{rank[k]['hop_s'] * 1e3:.1f} host ms"
        for k in ("kv_gather", "kv_scatter", "reshard", "tp_hops"))


def phase_fleet_tp(torch, workdir: str) -> dict:
    """The fleet at tp > 1: the tiny card-vs-CPU checks, then `serve_fleet`
    at the 45m preset, bf16, over gloo on phase 15's mix cut to 8
    requests: the router fleet x2 at tp 2, `--disagg --prefill_tp 2` into
    decode tp 1, and a restart of r0 from tp 2 to tp 1 between two waves.
    Returns each run's K3 launches by kernel, summed over the ranks."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve_fleet
    _fleet_tp_tiny(torch)
    layers = model_preset("45m").num_layers
    res = {}
    for name, extra in FLEET_TP_RUNS.items():
        args = serve_fleet.parse_args(
            FLEET_ARGS + FLEET_TP_GLOO + extra
            + ["--log_dir", os.path.join(workdir, name)])
        out, fleet = serve_fleet.run(args)
        torch.cuda.synchronize()
        ranks = out["ranks"]
        if out["completed"] != args.num_requests:
            raise AssertionError(f"fleet_tp {name}: served "
                                 f"{out['completed']} of {args.num_requests}")
        toks = [t for ts in fleet["outputs"].values() for t in ts]
        if not toks or not all(0 <= t < 1024 for t in toks):
            raise AssertionError(f"fleet_tp {name}: tokens missing or "
                                 f"outside the vocab")
        if not all(ranks[0]["drained"].values()):
            raise AssertionError(f"fleet_tp {name}: pools not drained "
                                 f"{ranks[0]['drained']}")
        for r in ranks:
            want = _fleet_tp_want(r, layers)
            _only(r["launches"], {"paged_attention": sum(want.values())},
                  f"fleet_tp {name} rank {r['rank']}")
            kern = {"paged_decode": want["decode"],
                    "paged_chunk_sm90": want["chunk"], "paged_attn": 0}
            if r["paged_by_route"] != want or r["paged_by_kernel"] != kern:
                raise AssertionError(
                    f"fleet_tp {name} rank {r['rank']}: K3 by route "
                    f"{r['paged_by_route']}, by kernel "
                    f"{r['paged_by_kernel']}; expected {want}, {kern}")
        line = (f"fleet_tp {name}: {out['completed']}/{args.num_requests} "
                f"requests, {out['generated_tokens']} tokens; TTFT p50/p95 "
                f"{out['ttft_ms_p50']}/{out['ttft_ms_p95']} ms; TPOT p50/p95 "
                f"{out['tpot_ms_p50']}/{out['tpot_ms_p95']} ms")
        if "fleet_tokens_per_sec" in out:
            line += (f"; {out['fleet_tokens_per_sec']} tok/s, dispatched "
                     f"{ {k: v['dispatched'] for k, v in out['per_replica'].items()} }")
        if args.disagg:
            if out["transferred_pages"] <= 0 or not ranks[0]["kv_gather"][
                    "calls"]:
                raise AssertionError(f"fleet_tp {name}: no pages streamed "
                                     f"through the tp 2 gather")
            line += (f"; {out['transferred_pages']} pages, "
                     f"{out['transferred_bytes']} B transferred, transfer "
                     f"ms p50/p95 {out['transfer_ms_p50']}/"
                     f"{out['transfer_ms_p95']}")
        if args.restart_tp:
            rs = out["restart"]
            if not (rs["hops"]["hop_bytes"] > 0 and out["wave_a_completed"]):
                raise AssertionError(f"fleet_tp {name}: the restart moved "
                                     f"nothing {rs}")
            line += (f"; restart {rs['src']} -> {rs['dst']}: plan "
                     f"{rs['bytes_moved']} B moved ({rs['ops']}), hops "
                     f"{rs['hops']['hop_calls']} calls "
                     f"{rs['hops']['hop_bytes']} B "
                     f"{rs['hops']['hop_ms']} host ms, wall {rs['wall_ms']} "
                     f"ms, staging peak {rs['hops']['peak_host_bytes']} B")
        for r in ranks:
            line += (f"; rank {r['rank']}: {_hops_line(r)}, K3 by kernel "
                     f"{r['paged_by_kernel']}")
        log(line)
        res[name] = {k: sum(r["paged_by_kernel"][k] for r in ranks)
                     for k in ranks[0]["paged_by_kernel"]}
    return res


# serve_obs: phase 15's mix with every obs flag and the controller acting
SERVE_OBS_FLAGS = ["--trace_requests", "--flight_records", "--metrics_port",
                   "0", "--control", "act"]
SERVE_OBS_SLOT_REQUESTS = "4"


def _scraper(port_box: dict, got: dict):
    """A thread that scrapes the exporter's endpoint once it reports two
    decode steps (the port from the patched `start`)."""
    import urllib.request

    def run():
        deadline = time.time() + 300
        while time.time() < deadline and "json" not in got:
            port = port_box.get("port")
            if port is not None:
                base = f"http://127.0.0.1:{port}"
                try:
                    with urllib.request.urlopen(base + "/metrics.json",
                                                timeout=5) as r:
                        snap = json.loads(r.read().decode())
                    if snap["counters"].get("serve/decode_steps", 0) >= 2:
                        with urllib.request.urlopen(base + "/metrics",
                                                    timeout=5) as r:
                            got["prom"] = r.read().decode()
                        got["json"] = snap
                        return
                except OSError:
                    pass
            time.sleep(0.05)

    import threading
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _traced_records(log_dir: str) -> list:
    from distributed_pytorch_from_scratch_tpu_torch.obs import validate_jsonl
    path = os.path.join(log_dir, "metrics.jsonl")
    bad = validate_jsonl(path)
    if bad:
        raise AssertionError(f"serve_obs: {path} fails the schema: {bad}")
    recs = [json.loads(line) for line in open(path)]
    traces = [r for r in recs if r["tag"] == "request_trace"]
    for r in traces:
        total = sum(s["dur_ms"] for s in r["spans"])
        wall = r["ttft_ms"] + (r["tpot_ms"] or 0.0) * max(
            r["generated"] - 1, 0)
        if abs(total - r["total_ms"]) > 0.002 * len(r["spans"]) + 0.01 or \
                abs(wall - r["total_ms"]) > 0.01 + 0.001 * r["generated"]:
            raise AssertionError(f"serve_obs: request {r['rid']}: span sum "
                                 f"{total}, total {r['total_ms']}, wall "
                                 f"{wall} ms")
    return recs


def _spec_k_on_the_card(torch) -> None:
    """The controller's speculation knob on the card: the 45m widths at 2
    layers, f32, drafter = target (every draft accepted, so act mode
    raises k), the round graphed: greedy tokens the plain paged engine's
    through every change of k, each new width's round captured once."""
    import dataclasses

    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models import build_model
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import (
        make_mesh)
    from distributed_pytorch_from_scratch_tpu_torch.serving.controller import (
        SLOController)
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        PagedEngine, Request)
    from distributed_pytorch_from_scratch_tpu_torch.serving.speculative import (
        SpeculativeEngine)
    cfg = dataclasses.replace(model_preset("45m"), num_layers=2,
                              compute_dtype="float32")
    model = build_model("llama", cfg).init_weights(FLEET_TP_SEED).to("cuda")
    mesh = make_mesh(MeshConfig(), device="cuda")
    kw = dict(num_slots=4, buf_len=48, eos_id=1, page_size=16,
              prefill_chunk=16)
    reqs = lambda: [Request(rid=i, prompt=list(p), max_new=20)
                    for i, p in enumerate(FLEET_TP_PROMPTS)]
    toks = lambda done: {r.rid: list(r.tokens) for r in done}
    plain = PagedEngine(model, mesh, **kw)
    for r in reqs():
        plain.submit(r)
    want = toks(plain.run_to_completion())
    eng = SpeculativeEngine(model, mesh, model, speculate_k=2, **kw)
    ctl = SLOController(eng, "act", interval=2)
    eng.controller = ctl
    for r in reqs():
        eng.submit(r)
    got = toks(eng.run_to_completion())
    torch.cuda.synchronize()
    ks = [d["new"] for d in ctl.decisions
          if d["knob"] == "speculate_k" and d["applied"]]
    st = eng.stats()
    if got != want or not ks or st["round_captures"] != 1 + len(set(ks)):
        raise AssertionError(f"serve_obs spec k: tokens equal {got == want}, "
                             f"k moved {ks}, round captures "
                             f"{st['round_captures']}")
    log(f"serve_obs spec k (45m widths, 2 layers, f32, drafter = target): "
        f"the controller moved k 2 -> {ks} in act mode, {st['spec_rounds']} "
        f"rounds, {st['round_captures']} round captures, greedy tokens the "
        f"plain paged engine's")


def phase_serve_obs(torch, workdir: str, one_engine) -> dict:
    """Phase 15's mix on the paged engine with `--trace_requests
    --flight_records --metrics_port 0 --control act`: a scrape from another
    thread mid-run answers, every `metrics.jsonl` line validates under
    the port's schema, every request's span sum equals its wall, K3 as
    phase 15's rule; TPOT p50 beside phase 15's run with obs off (the
    ratio reported, not gated). Then phase 5's slot engine, traced, on 8
    requests: K1's forward 12 per prefill dispatch. Returns both runs'
    launches."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.obs.telemetry import (
        TelemetryExporter)
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    layers = model_preset("45m").num_layers
    log_dir = os.path.join(workdir, "serve_obs")
    port_box, scraped = {}, {}
    start = TelemetryExporter.start

    def started(self, port):
        port_box["port"] = start(self, port)
        return port_box["port"]

    TelemetryExporter.start = started
    scraper = _scraper(port_box, scraped)
    try:
        out, counts, by_route, by_kernel, widths = _serve_with_widths(
            serve, PAGED_SERVE_ARGS + SERVE_OBS_FLAGS
            + ["--log_dir", log_dir])
    finally:
        TelemetryExporter.start = start
    scraper.join(timeout=10)
    torch.cuda.synchronize()
    st = out["engine_stats"]
    _check_paged_run(out, st, counts, by_route, by_kernel, widths, layers,
                     1024)
    if "json" not in scraped or "# TYPE serve_live gauge" not in scraped[
            "prom"]:
        raise AssertionError("serve_obs: the mid-run scrape got no answer")
    recs = _traced_records(log_dir)
    traces = [r for r in recs if r["tag"] == "request_trace"]
    if len(traces) != out["completed"]:
        raise AssertionError(f"serve_obs: {len(traces)} request_trace "
                             f"events for {out['completed']} requests")
    ctl = out["controller"]
    ratio = (out["tpot_ms_p50"] / one_engine["tpot_ms_p50"]
             if one_engine else None)
    log(f"serve_obs (paged, phase 15's mix, every obs flag, control act): "
        f"{out['completed']}/{out['requests']} requests, "
        f"{out['tokens_per_sec']} tok/s; TTFT p50/p95 {out['ttft_ms_p50']}/"
        f"{out['ttft_ms_p95']} ms; TPOT p50/p95 {out['tpot_ms_p50']}/"
        f"{out['tpot_ms_p95']} ms against phase 15's obs-off TPOT p50 "
        f"{one_engine and one_engine['tpot_ms_p50']} ms (ratio {ratio}); "
        f"{len(recs)} metrics lines valid, {len(traces)} request timelines "
        f"with span sum == wall; mid-run scrape at decode step "
        f"{scraped['json']['counters']['serve/decode_steps']:.0f} "
        f"({len(scraped['json']['gauges'])} gauges); telemetry snapshots "
        f"{out['telemetry_snapshots']}; controller {ctl['decisions']} "
        f"decisions ({ctl['applied']} applied, last {ctl['last_knob']}); "
        f"flight dumps {len(out['flight_dumps'])}; K3 by route {by_route}")
    slot_dir = os.path.join(workdir, "serve_obs_slot")
    _reset_launches()
    n = SERVE_ARGS.index("--num_requests") + 1
    slot = serve.main(SERVE_ARGS[:n] + [SERVE_OBS_SLOT_REQUESTS]
                      + SERVE_ARGS[n + 1:]
                      + ["--trace_requests", "--flight_records",
                         "--log_dir", slot_dir])
    slot_counts = _read_launches()
    torch.cuda.synchronize()
    _only(slot_counts, {"flash_attention_fwd": layers
                        * slot["prefill_dispatches"]},
          f"serve_obs slot ({layers} per prefill dispatch)")
    slot_traces = [r for r in _traced_records(slot_dir)
                   if r["tag"] == "request_trace"]
    if len(slot_traces) != slot["completed"] or slot["completed"] != int(
            SERVE_OBS_SLOT_REQUESTS):
        raise AssertionError(f"serve_obs slot: {len(slot_traces)} timelines "
                             f"for {slot['completed']} requests")
    _spec_k_on_the_card(torch)
    log(f"serve_obs (slot, traced, {slot['completed']} requests): TPOT "
        f"p50/p95 {slot['tpot_ms_p50']}/{slot['tpot_ms_p95']} ms, TTFT "
        f"p50/p95 {slot['ttft_ms_p50']}/{slot['ttft_ms_p95']} ms; K1 "
        f"{slot_counts['flash_attention_fwd']} launches "
        f"({slot['prefill_dispatches']} prefill dispatches)")
    return {"paged_by_kernel": by_kernel, "paged_by_route": by_route,
            "slot": slot_counts}


PHASES = ("build", "kernel_vs_plain", "times", "serve", "card_vs_cpu",
          "profile", "bwd_check", "bwd_times", "train", "train_card_vs_cpu",
          "train_profile", "paged_check", "paged_times", "paged_serve",
          "paged_card_vs_cpu", "paged_profile", "ring_check", "ring_times",
          "cp_train", "cp_tiny", "cp_card_vs_cpu", "cp_profile", "tp_train",
          "tp_tiny", "tp_card_vs_cpu", "tp_profile", "tp_serve",
          "tp_serve_card_vs_cpu", "tp_serve_profile", "graph_check",
          "train_remat", "train_spd", "eval", "eval_pth", "eval_tp",
          "gpt2_kernels", "gpt2_train", "gpt2_serve", "gpt2_card_vs_cpu",
          "sampler_check", "train_async_preempt", "serve_int8_weights",
          "serve_replay", "spec_check", "spec_serve", "cp_serve_check",
          "cp_serve", "fleet_check", "fleet_serve", "moe_check",
          "moe_train", "moe_serve", "moe_ep2_train", "zero_train",
          "moe_paths", "pp_train", "tp_overlap_train", "greedy_decoder",
          "fleet_tp", "serve_obs")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help=f"comma-separated subset of {','.join(PHASES)}")
    phases = set(p.parse_args().phases.split(","))
    if not phases <= set(PHASES):
        p.error(f"unknown phases {sorted(phases - set(PHASES))}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch; this script "
              "measures the port on the card only", file=sys.stderr)
        sys.exit(1)
    try:
        import distributed_pytorch_from_scratch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout: {e}",
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as workdir:
        lines = run(torch, phases, workdir)
    for line in lines:
        print(json.dumps(line))


KEPT_LIMIT_GIB = 0.5   # card memory a kept rank may hold between calls


def _kept_calls(name: str, calls: list) -> None:
    """Log the card memory of each kept-group call `calls` of phase `name`
    made, per rank: allocated at the call's start, at its return (what the
    rank keeps into the next call) and the call's peak; fails the phase
    when a call left more than KEPT_LIMIT_GIB allocated."""
    gib = lambda b: f"{b / 2**30:.3f}"
    bad = []
    for c in calls:
        for r, m in enumerate(c["ranks"]):
            log(f"{name}: kept call {c['fn']} ({c['nprocs']} ranks) rank "
                f"{r}: allocated {gib(m['before'])} GiB before, "
                f"{gib(m['live'])} at return, peak {gib(m['peak'])} GiB")
            if m["live"] > KEPT_LIMIT_GIB * 2**30:
                bad.append(f"{c['fn']} rank {r} ({gib(m['live'])} GiB)")
    if bad:
        raise AssertionError(f"{name}: kept calls left more than "
                             f"{KEPT_LIMIT_GIB} GiB allocated: {bad}")


def run(torch, phases: set, workdir: str) -> list:
    """Run the phases in order; returns the result lines (none for a subset
    of the phases)."""
    t0 = time.perf_counter()
    device = phase_device(torch)
    with_dir = ("train", "cp_train", "cp_tiny", "tp_train", "tp_tiny",
                "train_remat", "train_spd", "eval", "eval_pth", "eval_tp",
                "gpt2_train", "train_async_preempt", "serve_replay",
                "moe_train", "moe_ep2_train", "zero_train", "pp_train",
                "tp_overlap_train", "fleet_tp")
    res = {}
    from distributed_pytorch_from_scratch_tpu_torch.runtime import launch
    with launch.kept_groups():
        for name in PHASES:
            if name not in phases:
                continue
            t1 = time.perf_counter()
            kept = len(launch.calls)
            fn = globals()[f"phase_{name}"]
            res[name] = (fn() if name == "build" else
                         fn(torch, workdir, res.get("paged_serve"))
                         if name == "fleet_serve" else
                         fn(torch, res.get("serve"), res.get("paged_serve"),
                            res.get("paged_profile"))
                         if name == "moe_serve" else
                         fn(torch, workdir, res.get("moe_serve"))
                         if name == "moe_paths" else
                         fn(torch, workdir, (res.get("paged_serve") or {})
                            .get("one_engine"))
                         if name == "serve_obs" else
                         fn(torch, workdir) if name in with_dir else fn(torch))
            _kept_calls(name, launch.calls[kept:])
            log(f"chip_smoke: phase {name} took "
                f"{time.perf_counter() - t1:.1f} s")
    (max_err, times, served, bwd_err, bwd_times, trained, paged_err,
     paged_times, paged_served, ring_err, ring_times, cp_runs, cp_tiny,
     tp_runs, tp_tiny, tp_served, remat_runs, spd_run, evals, eval_pth,
     eval_tp, gpt2_times, gpt2_trained, gpt2_served, preempted, int8_served,
     replayed, spec_err, spec_served, cp_err, cp_served, fleet_served,
     moe_trained, moe_served, moe_ep2, moe_paths, zero_runs, pp_runs,
     ov_runs, decoded, fleet_tp, served_obs) = (
         res.get(k) for k in (
             "kernel_vs_plain", "times", "serve", "bwd_check", "bwd_times",
             "train", "paged_check", "paged_times", "paged_serve",
             "ring_check", "ring_times", "cp_train", "cp_tiny", "tp_train",
             "tp_tiny", "tp_serve", "train_remat", "train_spd", "eval",
             "eval_pth", "eval_tp", "gpt2_kernels", "gpt2_train",
             "gpt2_serve", "train_async_preempt", "serve_int8_weights",
             "serve_replay", "spec_check", "spec_serve", "cp_serve_check",
             "cp_serve", "fleet_serve", "moe_train", "moe_serve",
             "moe_ep2_train", "moe_paths", "zero_train", "pp_train",
             "tp_overlap_train", "greedy_decoder", "fleet_tp", "serve_obs"))
    log(f"chip_smoke: phases {','.join(p for p in PHASES if p in phases)} "
        f"passed in {time.perf_counter() - t0:.1f} s")
    if phases != set(PHASES):
        return []
    by_path = lambda k: {"serve": served[k], "train": trained[k],
                         "serve_paged": paged_served[k],
                         "train_cp2": cp_runs["zigzag"][k],
                         "train_cp2_contiguous": cp_runs["contiguous"][k],
                         "train_cp2_ulysses": cp_runs["ulysses"][k],
                         "train_cp2_tiny_f32": cp_tiny["float32"].get(k, 0),
                         "train_cp2_tiny_bf16": cp_tiny["bfloat16"].get(k, 0),
                         "train_tp2": tp_runs["tp2"].get(k, 0),
                         "train_tp2_sp": ov_runs["off"].get(k, 0),
                         "train_tp2_sp_ring": ov_runs["ring"].get(k, 0),
                         "train_tp2_sp_ring_q": ov_runs["ring_q"].get(k, 0),
                         **{name: run.get(k, 0)
                            for name, run in decoded.items()},
                         "train_tp2_dp2": tp_runs["tp2_dp2"].get(k, 0),
                         "train_tp2_cp2_tiny_f32": tp_tiny["float32"].get(k, 0),
                         "train_tp2_cp2_tiny_bf16":
                             tp_tiny["bfloat16"].get(k, 0),
                         "train_dots": remat_runs["dots"][k],
                         "train_false": remat_runs["false"][k],
                         "train_spd4": spd_run[k],
                         **{name: run["launches"].get(k, 0)
                            for name, run in tp_served.items()},
                         **{f"eval_{name}": evals[name]["ranks"][0][
                             "launches"].get(k, 0)
                            for name in ("bf16", "kv_f32", "no_kv_f32")},
                         "eval_pth": eval_pth["ranks"][0]["launches"].get(
                             k, 0),
                         "eval_tp2": sum(r["launches"].get(k, 0)
                                         for r in eval_tp["ranks"]),
                         "train_gpt2": gpt2_trained[k],
                         **{f"serve_gpt2_{name}": run["launches"].get(k, 0)
                            for name, run in gpt2_served.items()},
                         "train_async_saves": preempted.get(k, 0),
                         "train_async_resume": preempted["resume"].get(k, 0),
                         "serve_int8_weights": int8_served["slot"].get(k, 0),
                         "serve_paged_int8_weights":
                             int8_served["paged"].get(k, 0),
                         "serve_replay": replayed.get(k, 0),
                         "serve_obs_slot": served_obs["slot"].get(k, 0),
                         "train_moe": moe_trained[k],
                         "train_moe_resume": moe_trained["resume"].get(k, 0),
                         "train_moe_ep2": moe_ep2.get(k, 0),
                         "serve_moe": moe_served["slot"].get(k, 0),
                         "serve_moe_paged": moe_served["paged"].get(k, 0),
                         "serve_moe_int8_weights": moe_paths["int8"].get(
                             k, 0),
                         "eval_moe_cp2": sum(r.get(k, 0) for r in
                                             moe_paths["eval_cp2"]),
                         **{f"train_dp2_{name}": run.get(k, 0)
                            for name, run in zero_runs.items()},
                         **{f"train_{name}": run.get(k, 0)
                            for name, run in pp_runs.items()}}
    at_path, at_gpt2 = bwd_times["errs"], gpt2_times["errs"]
    # K3's launches on the gpt2 paged runs, by C entry point
    gpt2_paged = lambda kernel: {
        f"serve_gpt2_{name}": run["paged_by_kernel"][kernel]
        for name, run in gpt2_served.items() if name.startswith("paged")}
    # K3's launches on the speculative runs, by C entry point
    spec_paged = lambda kernel: {
        f"serve_paged_spec_{name}": spec_served[name]["by_kernel"][kernel]
        for name in ("greedy", "sampled")}
    # K3's launches on the cp=2 runs (summed over the ranks), by C entry
    cp_paged = lambda kernel: {
        name: run["paged_by_kernel"][kernel]
        for name, run in cp_served.items()}
    # K3's launches on the serve_fleet runs (every engine), by C entry
    fleet_paged = lambda kernel: {
        f"serve_{name}": by_kernel[kernel]
        for name, by_kernel in fleet_served.items()}
    # K3's launches on the tp fleet runs (summed over the ranks) and the
    # traced paged run, by C entry point
    obs_paged = lambda kernel: {
        **{f"serve_{name}": by_kernel[kernel]
           for name, by_kernel in fleet_tp.items()},
        "serve_obs_paged": served_obs["paged_by_kernel"][kernel]}
    # K3's launches on moe_paths' paged runs (cp 2: summed over the ranks)
    moe_paged = lambda kernel: {
        "serve_moe_paged_spec": moe_paths["spec"][kernel],
        "serve_moe_fleet_x2": moe_paths["fleet"][kernel],
        "serve_moe_paged_cp2": sum(r[kernel] for r in moe_paths["cp2"])}
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": served["flash_attention_fwd"],
         "max_abs_err": max(max_err, at_path["o"], at_gpt2["o"]),
         "max_abs_err_train_shape": at_path["o"],
         "max_abs_err_gpt2_shape": at_gpt2["o"], **times,
         "train_shape": bwd_times["fwd"],
         "gpt2_train_shape": gpt2_times["fwd"],
         "launches_by_path": by_path("flash_attention_fwd")},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": BWD_SOURCE, "replaces": BWD_REPLACES,
         "launches": trained["flash_attention_bwd_dq"],
         "max_abs_err": max(bwd_err["dq"], at_path["dq"], at_gpt2["dq"]),
         "max_abs_err_train_shape": at_path["dq"],
         "max_abs_err_gpt2_shape": at_gpt2["dq"], **bwd_times["dq"],
         "gpt2_train_shape": gpt2_times["dq"],
         "launches_by_path": by_path("flash_attention_bwd_dq")},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": BWD_SOURCE, "replaces": BWD_REPLACES,
         "launches": trained["flash_attention_bwd_dkv"],
         "max_abs_err": max(bwd_err["dkv"], at_path["dk"], at_path["dv"],
                            at_gpt2["dk"], at_gpt2["dv"]),
         "max_abs_err_train_shape": max(at_path["dk"], at_path["dv"]),
         "max_abs_err_gpt2_shape": max(at_gpt2["dk"], at_gpt2["dv"]),
         **bwd_times["dkv"], "gpt2_train_shape": gpt2_times["dkv"],
         "launches_by_path": by_path("flash_attention_bwd_dkv")},
        # K3's wrapper runs two kernels on the bf16 path, an entry each:
        # `launches` counts the entry's kernel; `launches_by_route` and
        # `launches_by_path` count the wrapper's launches, every route
        {"name": "paged_attention", "route": "cuda",
         "source": PAGED_SOURCES["decode"], "source_by_route": PAGED_SOURCES,
         "replaces": PAGED_REPLACES,
         "launches": paged_served["paged_by_kernel"]["paged_decode"],
         "launches_by_route": paged_served["paged_by_route"],
         "max_abs_err": max(paged_err["decode"], paged_times["decode"][
             "by_shape"]["decode_bf16"]["max_abs_err"],
                            spec_err["worst"]["decode"], cp_err["decode"]),
         **paged_times["decode"],
         "launches_by_path": {**by_path("paged_attention"),
                              "serve_paged_int8": paged_served["paged_int8"],
                              "serve_paged_int8_by_route":
                                  paged_served["paged_int8_by_route"],
                              "gpt2_paged_decode_kernel":
                                  gpt2_paged("paged_decode"),
                              "serve_paged_int8_weights_decode_kernel":
                                  int8_served["paged_by_kernel"][
                                      "paged_decode"],
                              **{f"{k}_decode_kernel": v for k, v in
                                 spec_paged("paged_decode").items()},
                              **{f"{k}_decode_kernel": v for k, v in
                                 cp_paged("paged_decode").items()},
                              **{f"{k}_decode_kernel": v for k, v in
                                 fleet_paged("paged_decode").items()},
                              "serve_moe_paged_decode_kernel":
                                  moe_served["paged_by_kernel"][
                                      "paged_decode"],
                              **{f"{k}_decode_kernel": v for k, v in
                                 moe_paged("paged_decode").items()},
                              **{f"{k}_decode_kernel": v for k, v in
                                 obs_paged("paged_decode").items()}}},
        {"name": "paged_attention_chunk", "route": "cuda",
         "source": PAGED_SOURCES["chunk"], "replaces": PAGED_REPLACES,
         "launches": paged_served["paged_by_kernel"]["paged_chunk_sm90"],
         "max_abs_err": max(paged_err["chunk"], paged_times["decode"][
             "by_shape"]["chunk_bf16"]["max_abs_err"],
                            spec_err["worst"]["chunk"],
                            spec_err["verify"]["max_abs_err"],
                            cp_err["chunk"]),
         **paged_times["chunk"],
         "verify_shape": spec_err["verify"],
         "verify_shape_int8": spec_err["verify_int8"],
         "launches_by_path": {
             "serve_paged": paged_served["paged_by_kernel"][
                 "paged_chunk_sm90"],
             "serve_paged_int8": paged_served["paged_int8_by_kernel"][
                 "paged_chunk_sm90"],
             **{name: run["launches"]["paged_paged_chunk_sm90"]
                for name, run in tp_served.items()},
             **gpt2_paged("paged_chunk_sm90"),
             "serve_paged_int8_weights": int8_served["paged_by_kernel"][
                 "paged_chunk_sm90"],
             **spec_paged("paged_chunk_sm90"),
             **cp_paged("paged_chunk_sm90"),
             **fleet_paged("paged_chunk_sm90"),
             "serve_moe_paged": moe_served["paged_by_kernel"][
                 "paged_chunk_sm90"],
             **moe_paged("paged_chunk_sm90"),
             **obs_paged("paged_chunk_sm90")}},
    ]
    for part, name in (("fwd", "block_attention_fwd"),
                       ("dq", "block_attention_bwd_dq"),
                       ("dkv", "block_attention_bwd_dkv")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": BLOCK_SOURCES["bfloat16"],
            "source_by_route": BLOCK_SOURCES,
            "replaces": BLOCK_REPLACES[part],
            "launches": cp_runs["zigzag"][name],
            "max_abs_err": max(ring_err[part],
                               ring_times[part]["max_abs_err_path_shape"]),
            **ring_times[part],
            "launches_by_path": by_path(name)})
    return [{"kernels": kernels}, {"ok": True, "device": device}]


if __name__ == "__main__":
    main()
