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
    80-page pool, then 16 requests with int8 pages — every request
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
    the 45m preset, bf16, b 8 x t 1000 with remat: zig-zag 6 steps, a
    checkpoint and a 2-step `--resume`; contiguous 3 steps; Ulysses 2
    steps — finite losses, falling under zig-zag, the step-1 loss of each
    and of a cp=1 run on the same batch within 1e-2, and each rank's kernel
    launches equal to the ring schedule's (read from the counters);
21. cp_tiny: `train.main --model tiny --cp_size 2 --cp_impl ring`, 2 steps
    on the card at f32 (the CLI default) and with --bf16: head_dim 32 on
    both routes of the block kernels, finite losses, launches per the ring
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
    the 45m preset, bf16, b 8 x t 1000 with remat: 6 steps, one
    checkpoint file per tp rank and a 2-step `--resume`, then that
    checkpoint resumed at tp=1 for a step; tp=2 with
    `--sequence_parallel` 3 steps; tp 2 x dp 2 (four ranks) 2 steps —
    finite losses, falling at tp=2, the step-1 loss of each and of a tp=1
    run on the same batch within 1e-2, each rank's flash launches 2 x 12
    (forward) and 12 (dq, dk/dv) per step and no other attention kernel;
25. tp_tiny: `train.main --model tiny --tp_size 2 --cp_size 2 --cp_impl
    ring`, four ranks, 2 steps at f32 and with --bf16: head_dim 32 with 2
    local heads on both routes of the block kernels, launches per the
    ring schedule of each rank's cp index;
26. tp_card_vs_cpu: tp=2 with sequence parallelism at the 45m widths, 2
    layers, f32, b 2 x t 256: the loss and every rank's gradient shard,
    the kernels on the card against the plain versions on the CPU, one
    gloo group;
27. tp_profile: one tp=2 step of the 45m bf16 cell under torch.profiler in
    each rank: wall, device busy (the kernels apart from the hops'
    copies), the card's idle share, kernels, the flash kernels' share (no
    SIMT flash kernel may run), and the tp hops' host time and bytes;
28. tp_serve: `serve.main --tp_size 2 --dist_backend gloo` (two ranks on
    the card; rank 0 decides each dispatch and broadcasts it) at the 45m
    preset, bf16: the slot engine on 8 requests (prompts 64-512, 32 new
    tokens, 8 slots), then the paged engine on 8 requests behind a
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
31. graph_check: both engines at the phase-5 and phase-15 traffic (its
    deadlines x 1000, so the schedule does not follow the clock) with
    the decode step graphed (`--decode_graph auto`) and eager (`off`), at
    bf16 and f32: identical tokens, the graph run on every decode step;
    a replayed decode step's logits and tokens bitwise the eager step's
    on the live rows (bf16 and f32, both engines); per engine (bf16, 8 and
    16 live) the decode step's wall, device busy and idle share both ways;
32. train_remat: the train cell (45m bf16, b 32 x t 1000) 10 steps at
    `--remat true`, `dots`, `false` and `auto` (its pick printed): losses
    equal true's within 1e-6 relative, K1's forward 12 launches per step
    under dots and false (24 under true), dq and dk/dv 12; step p50,
    tokens/s, MFU and peak memory;
33. train_spd: the train cell 10 steps at `--steps_per_dispatch 4`
    (dispatches of 4, 4 and 2) against 1: identical losses, final
    parameters and moments (max abs diff 0) and launches; the Adam update
    from device scalars bitwise the host-float one on the card; a profiled
    dispatch of 4 steps against 4 eager steps (wall, busy, idle share);
34. eval: the source repo's workflow after training — 20 steps of the
    train cell on a seeded bigram corpus with 64 validation documents of
    200-999 tokens (checkpoints at 10 and 20), then `python -m
    ...evaluate --batch_size 8` with the shipped tokenizer as a CLI in its
    own process: bf16 with the slot engine's KV decoder (its decode step
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
    the rule over ids < 1024), 60 steps at lr 6e-4 and a 2-step
    `--resume`: finite losses, the last 5's mean 1 nat below the first 5's
    and 0.5 nat below the unigram floor ln 1021 (the bigram learned
    through the blocks), K1 forward 2 x 12 x 60 and dq, dk/dv 12 x 60
    launches, nothing else; step p50, tokens/s, MFU (N from the real
    parameters) and peak memory; the 60 steps again at
    `--steps_per_dispatch 4`: bitwise the same losses and launches;
39. gpt2_serve: `serve --family gpt2 --random_init --vocab_size 50257`
    at that width, bf16, the decode step graphed: the slot engine on
    phase 5's traffic, the paged engine on phase 15's (bf16, then int8
    pages), each greedy and sampled (temperature 0.8, top-k 50, top-p
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
42. train_async_preempt: the train cell 20 steps with a checkpoint every
    5 and every 10 steps written in the background (a device snapshot,
    then a writer thread) and with none: identical losses, the loop's
    host time per save, the prefetch thread's wait, step p50 of each,
    beside one synchronous save of the same state timed alone; the idle
    share of a 10-step loop profiled on the device, with saves every 5
    and without, from step 3 on; then `python -m ...train` in a process of its own
    gets SIGTERM after its step-3 line: exit 0, the shutdown line, a
    checkpoint at the step it reached, and a 2-step `--resume` from it;
    K1's launches per the schedule in every run of this process;
43. serve_int8_weights: phase 5's and 15's traffic with
    `--decode_weight_dtype int8`, the decode step graphed, in turns with
    native weights (native, int8, int8, native: TPOT, TTFT and tokens/s
    of each), then once more, checked: weight bytes about a quarter,
    in-vocab tokens, K1 12 per prefill dispatch, K3 12 per decode step
    and chunk on its routes; then the 45m widths at 2 layers,
    f32: both engines' greedy and sampled int8 tokens on the card those of
    the CPU's plain path;
44. serve_replay: a seeded poisson trace of 16 slot-cell requests written
    to the workdir, served with `--tokenizer_path tokenizer/tokenizer.json
    --arrival replay --replay <trace>`: submitted in arrival order, every
    request served in-vocab, K1 12 per prefill dispatch.

The last two lines are a `{"kernels": [...]}` record and
`{"ok": true, "device": {...}}`. `--phases` runs a subset (for debugging;
a subset prints no result lines). The cp and tp phases start their ranks
as processes of their own (`runtime/launch.spawn`); the build phase has
built every kernel before they start.
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
PAGED_INT8_REQUESTS = 16
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
GPT2_SPD = 4             # gpt2_train: its steps again, 4 per dispatch
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
    """Returns the served run's launches {fwd, dq, dkv}."""
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
    return counts


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


def phase_paged_check(torch) -> dict:
    """Returns the largest bf16 output error (the served dtype) of each
    route, {"decode": x, "chunk": y}."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        MASK, kernel_route, paged_attention, paged_attention_plain)
    by_route = paged_attention.launches_by_route
    by_kernel = paged_attention.launches_by_kernel
    worst = {"decode": 0.0, "chunk": 0.0}
    for i, (what, b, h, kvh, cw, hd, ps, mp, int8, starts, qlens,
            off) in enumerate(PAGED_CASES):
        for name in ("bfloat16", "float32"):
            q, kp, vp, tbl = _paged_inputs(torch, b, h, kvh, cw, hd, ps, mp,
                                           getattr(torch, name), int8, 200 + i)
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
                          for r, n in enumerate(valid))
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
    paged launches and both runs' paged launches by route and by kernel."""
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
                     "paged_by_kernel": by_kernel}
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
    import numpy as np
    from distributed_pytorch_from_scratch_tpu_torch.config import (
        MeshConfig, model_preset)
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        PagedEngine, Request)
    cfg = model_preset("45m", compute_dtype="bfloat16")
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

    kernels = {**PAGED_KERNELS, "chunk_f32": PAGED_SIMT_KERNEL}

    def profiled(fn, what):
        """(busy ms, kernels, paged ms, paged launches, {route: launches})
        over every route's kernel, matched by name"""
        busy = paged = 0.0
        n = n_paged = 0
        by_route = {route: 0 for route in kernels}
        for name, us in _profiled(torch, fn, f"paged profile, {what}"):
            busy += us
            n += 1
            for route, kernel in kernels.items():
                if kernel in name:
                    paged += us
                    n_paged += 1
                    by_route[route] += 1
        return busy / 1e3, n, paged / 1e3, n_paged, by_route

    decode_ms = timed(eng.step)
    d = profiled(eng.step, "decode step")
    # a 512-position prompt: four chunks, for the timed pump and at most
    # two profiled ones
    eng.submit(Request(rid=99, prompt=prompt(), max_new=8))
    with torch.inference_mode():
        eng._admit([])
    chunk_ms = timed(pump)
    c = profiled(pump, "chunk dispatch")
    for what, wall, (busy, n, paged, n_paged, by_route) in (
            ("decode step, 16 live", decode_ms, d),
            ("chunk dispatch, 128 positions", chunk_ms, c)):
        log(f"paged profile (45m bf16, ps 64): {what}: wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
            f"{n} kernels; paged kernel {paged:.3f} ms over {n_paged} "
            f"launches ({paged / busy:.3f} of busy), by route {by_route}")
    layers = cfg.num_layers
    if d[4] != {"decode": layers, "chunk": 0, "chunk_f32": 0}:
        raise AssertionError(f"a decode step ran paged kernels {d[4]}, "
                             f"expected the decode kernel {layers} times "
                             f"and no chunk kernel")
    if c[4]["decode"] != 0 or c[4]["chunk"] == 0 or c[4]["chunk_f32"] != 0:
        raise AssertionError(f"a chunk dispatch ran paged kernels {c[4]}, "
                             f"expected the wgmma chunk kernel and no other")
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
# zigzag and tp2 run 6 steps (10 once) to keep the whole script near
# 1050 s; in 6 the loss still falls by more than 4 nats on the corpus
CP_RUNS = {  # name: (flags, steps)
    "zigzag": (["--cp_layout", "zigzag"], 6),
    "contiguous": (["--cp_layout", "contiguous"], 3),
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


def phase_cp_train(torch, workdir: str) -> dict:
    """train.main at cp=2 in each layout and the cp=1 step on the same
    batch; returns each run's launches summed over ranks and the zigzag
    run's summary."""
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    data = _corpus(workdir)
    layers = model_preset("45m").num_layers
    base = CP_ARGS + ["--data_path", data]
    cp1 = train.main(base + ["--max_steps", "1", "--save_dir",
                             os.path.join(workdir, "cp1")])
    first = {"cp1": cp1["losses"][0]}
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
            f"bf16, cp {res['cp']} ({res['cp_impl']}, {res['cp_layout']}) over "
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
    for name, flags in (("float32", []), ("bfloat16", ["--bf16"])):
        res = train.main(base + flags + ["--save_dir", os.path.join(
            workdir, f"cp_tiny_{name}")])
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
TP_RUNS = {  # name: (flags, steps; tp2 as CP_RUNS' zigzag)
    "tp2": ([], 6),
    "tp2_sp": (["--sequence_parallel"], 3),
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
    return (f"rank {r['rank']} (dp {r['dp']}, cp {r['cp']}, tp {r['tp']}): "
            f"peak {r['peak_mem_gib']:.3f} GiB, {axes} of {r['wall_s']:.3f} "
            f"s wall (hop share {hop / r['wall_s']:.3f})")


def phase_tp_train(torch, workdir: str) -> dict:
    """train.main at tp=2 (6 steps, a checkpoint and a 2-step --resume),
    tp=2 with sequence parallelism (3 steps), tp 2 x dp 2 (2 steps), the tp
    checkpoint resumed at tp=1 (1 step), and a tp=1 step on the same first
    batch; returns each tp run's launches summed over ranks and the tp=2
    run's summary."""
    import glob
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    data = _corpus(workdir)
    layers = model_preset("45m").num_layers
    base = CP_ARGS + ["--data_path", data]
    first = {"tp1": train.main(base + ["--max_steps", "1", "--save_dir",
                                       os.path.join(workdir, "tp1")])[
        "losses"][0]}
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
            f"bf16, dp {res['dp']} x cp {res['cp']} x tp {res['tp']} "
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
    for name, flags in (("float32", []), ("bfloat16", ["--bf16"])):
        res = train.main(base + flags + ["--save_dir", os.path.join(
            workdir, f"tp_tiny_{name}")])
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
# over gloo. The slot engine takes a burst of 8 prompts of 64-512 tokens;
# the paged engine 8 behind a 96-token shared prefix (it ends mid-page, so
# sharers copy that page: COW) on the default pool, slots x pages per
# slot, so no request is preempted; then the same with int8 pages
TP_SERVE_BASE = ["--model", "45m", "--random_init", "--vocab_size", "1024",
                 "--tp_size", "2", "--dist_backend", "gloo",
                 "--num_requests", "8", "--arrival", "burst",
                 "--prompt_len_min", "64", "--prompt_len_max", "512",
                 "--max_new_tokens", "32", "--slots", "8"]
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
    """serve.main at tp=2 over gloo on the one card, the slot engine and the
    paged engine (bf16 and int8 pages): every request served with in-vocab
    tokens, both ranks in lockstep, K1 forward 12 times per prefill
    dispatch and K3 12 times per decode step (decode kernel) and per chunk
    (the wgmma chunk kernel above one position) on each rank, 2L + 2 tp
    hops per dispatch. Returns each run's launches summed over the ranks
    and its summary."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    layers = model_preset("45m").num_layers
    res = {}
    for name, flags in TP_SERVE_RUNS.items():
        out = serve.main(TP_SERVE_BASE + flags)
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

REMAT_STEPS = 10       # train_remat and train_spd: 10 steps of the train cell
SPD = 4                # train_spd: dispatches of 4, 4 and 2 steps


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
    (dispatches of 4, 4 and 2) against 1: identical losses, identical final
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


def phase_graph_check(torch) -> dict:
    """Both engines with the decode step graphed (`--decode_graph auto`)
    against eager (`off`): the phase-5 and phase-15 traffic (its deadlines
    scaled, `GRAPH_CHECK_SLO`) served both ways at bf16 and f32 gives
    identical tokens; a replayed decode step's
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
    for kind, args in (("slot", SERVE_ARGS),
                       ("paged", PAGED_SERVE_ARGS + GRAPH_CHECK_SLO)):
        for dtype, flag in (("bfloat16", "--bf16"), ("float32", "--no-bf16")):
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
EVAL_VAL_DOCS = 64     # the validation split: 8 batches of 8 at t <= 1000
EVAL_F32_LEN = 64      # the f32 decodes' --max_decode_len (token checks)
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


def _eval_run(workdir: str, name: str, ckpt_dir: str, extra: list,
              own_process: bool = False) -> dict:
    """`evaluate` at the 45m preset, batch 8, the shipped tokenizer, as
    `python -m ...evaluate` in a process of its own or through its `main`
    in this one (warm: no process start, no first-use cost of the card's
    libraries); returns its --summary_json plus the wall `run_s`."""
    from distributed_pytorch_from_scratch_tpu_torch import evaluate
    data, _ = _eval_files(workdir)
    out = os.path.join(workdir, f"{name}.json")
    args = ["--model", "45m", "--batch_size", "8", "--data_path", data,
            "--tokenizer_path", TOKENIZER, "--ckpt_dir", ckpt_dir,
            "--summary_json", out] + extra
    t0 = time.perf_counter()
    if own_process:
        proc = subprocess.run(
            [sys.executable, "-m",
             "distributed_pytorch_from_scratch_tpu_torch.evaluate"] + args,
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        log(f"{name}: evaluate CLI {' '.join(extra)} -> rc "
            f"{proc.returncode}; stdout ({len(lines)} lines): "
            + " | ".join(lines[:3] + ["..."] + lines[-9:]))
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: evaluate failed: "
                               f"{proc.stderr.strip()[-3000:]}")
    else:
        evaluate.main(args)
    wall = time.perf_counter() - t0
    with open(out) as f:
        summary = json.load(f)
    summary["run_s"] = wall
    log(f"{name}: evaluate {' '.join(extra)} took {wall:.1f} s"
        + (" in its own process" if own_process else " in this process"))
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
    them: bf16 with the KV decoder as a CLI in its own process, then in
    this process f32 with it and f32 with --no_kv_cache. Checks the losses (finite; the newest bf16 one against
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
    runs = {"bf16": _eval_run(workdir, "eval_bf16", ckpt, [],
                              own_process=True),
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
    over ids below 1024), then a 2-step `--resume`: finite, falling losses
    (the mean of the last 5 at least 1 nat below the first 5's and
    GPT2_LEARNED below the unigram floor ln 1021), K1 forward 2 x 12 x 60
    and dq, dk/dv 12 x 60 launches and no other kernel; step p50,
    tokens/s, MFU (N counted from the real parameters) and peak memory
    printed; then the 60 steps at `--steps_per_dispatch 4`: bitwise the
    same losses and launches.
    Returns the launches and the summary."""
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
    resumed = train.main(_replace_flag(args, "--max_steps",
                                       str(GPT2_STEPS + 2)) + ["--resume"])
    log(f"gpt2_train --resume: started at step {resumed['start_step']}, ran "
        f"to {resumed['steps']}, losses {resumed['losses']}")
    if (resumed["start_step"] != GPT2_STEPS
            or resumed["steps"] != GPT2_STEPS + 2
            or not all(math.isfinite(x) for x in resumed["losses"])):
        raise AssertionError("gpt2 resume did not continue from the "
                             "checkpoint")
    # the same steps, GPT2_SPD to each captured dispatch: bitwise the
    # same losses, the launches counted through the replays
    _reset_launches()
    spd = train.main(_replace_flag(args, "--save_dir", save_dir + "_spd")
                     + ["--steps_per_dispatch", str(GPT2_SPD)])
    spd_counts = _read_launches()
    log(f"gpt2_train --steps_per_dispatch {GPT2_SPD}: step p50 "
        f"{spd['step_ms_p50']:.3f} ms, losses bitwise the one-step run's: "
        f"{spd['losses'] == losses}; launches {spd_counts}")
    if spd["losses"] != losses:
        raise AssertionError("gpt2 --steps_per_dispatch changed the losses")
    _only(spd_counts, counts_want, f"gpt2 train, {GPT2_SPD} steps per "
                                   f"dispatch")
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
    64-200 tokens, 16 new tokens, through each engine, greedy and sampled
    (request seeds 40..43)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [64, 200, 131, 97]
    prompts = [[int(x) for x in rng.integers(3, cfg.vocab_size, n)]
               for n in lens]
    reqs = [(p, 16, "default", None, 40 + i) for i, p in enumerate(prompts)]
    buf = max(lens) + 18
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
        log(f"gpt2 card vs cpu tokens ({what}, {len(toks)} requests x 16 "
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
# steps (written in the background), every ASYNC_SPARSE (further apart than
# one write at 45m) and none; a profiled loop of ASYNC_PROFILE_STEPS with
# saves and without; then a process of its own that gets SIGTERM after its
# PREEMPT_AFTER-th step line, and a --resume
ASYNC_STEPS = 20
ASYNC_EVERY = 5
ASYNC_SPARSE = 10
ASYNC_PROFILE_STEPS = 10
PREEMPT_AFTER = 3
# serve_replay: a seeded poisson trace of the slot cell's requests
REPLAY_REQUESTS = 16
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
    for name, every in (("saves", ASYNC_EVERY), ("sparse", ASYNC_SPARSE),
                        ("no_saves", 10 ** 6)):
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
    saves, sparse, none = (runs[k][0] for k in ("saves", "sparse",
                                                  "no_saves"))
    if not saves["losses"] == sparse["losses"] == none["losses"]:
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
        f"{saves['step_ms_p50']:.3f} ms, every {ASYNC_SPARSE} "
        f"{sparse['step_ms_p50']:.3f} ms, none {none['step_ms_p50']:.3f} ms "
        f"(ratios {saves['step_ms_p50'] / none['step_ms_p50']:.4f}, "
        f"{sparse['step_ms_p50'] / none['step_ms_p50']:.4f})")
    # the idle share of the loop, as phase 12's of a step: 1 - device busy
    # per step (a loop profiled on the device, from step 3 on) / the step
    # p50 of the same loop unprofiled (above)
    idle = {}
    for name, every, p50 in (("saves", ASYNC_EVERY, saves["step_ms_p50"]),
                             ("no_saves", 10 ** 6, none["step_ms_p50"])):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            train.main(_replace_flag(_replace_flag(
                base, "--max_steps", str(ASYNC_PROFILE_STEPS)),
                "--save_interval", str(every))
                + ["--save_dir", os.path.join(workdir, f"prof_{name}")])
            torch.cuda.synchronize()
        busy = _loop_busy(prof, torch, 2 * 2 * layers,
                          ASYNC_PROFILE_STEPS - 2)
        idle[name] = 1 - busy / p50
        log(f"train_async_preempt profile ({name}, {ASYNC_PROFILE_STEPS} "
            f"steps): device busy {busy:.3f} ms per step from step 3 (the "
            f"kernels), step p50 {p50:.3f} ms unprofiled: idle share "
            f"{idle[name]:.4f}")
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
                        "loop": saves["save_stall_ms"],
                        "loop_sparse": sparse["save_stall_ms"]},
            "step_ms_p50": {"saves": saves["step_ms_p50"],
                            "sparse": sparse["step_ms_p50"],
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
    `--decode_weight_dtype int8`, the decode step graphed, in turns with
    the native weights (native, int8, int8, native): every request served
    in-vocab, the
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
    # native, int8, int8, native on each cell, warm (phases 5 and 15 ran
    # first in the process); the checked runs are the first int8 ones
    native, turns = {}, {}
    for kind, args in (("slot", SERVE_ARGS), ("paged", PAGED_SERVE_ARGS)):
        runs = [serve.main(args + extra)
                for extra in ([], int8, int8, [])]
        native[kind] = runs[0]
        turns[kind] = [(("native", "int8")[i in (1, 2)], r["tpot_ms_p50"],
                        r["ttft_ms_p50"], r["tokens_per_sec"])
                       for i, r in enumerate(runs)]
        log(f"serve_int8_weights {kind} turns (weights, TPOT p50 ms, TTFT "
            f"p50 ms, tok/s): {turns[kind]}")
    _reset_launches()
    slot = serve.main(SERVE_ARGS + int8)
    counts = _read_launches()
    _int8_line("slot", slot, native["slot"], counts)
    if slot["completed"] != slot["requests"] or not all(
            0 <= t < 1024 for ts in slot["outputs"].values() for t in ts):
        raise AssertionError("int8 slot serving: requests unserved or "
                             "tokens outside the vocab")
    _only(counts, {"flash_attention_fwd": layers * slot["prefill_dispatches"]},
          f"int8 slot serving ({layers} per prefill dispatch)")
    out, pcounts, by_route, by_kernel, widths = _serve_with_widths(
        serve, PAGED_SERVE_ARGS + int8)
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
            f"f32, 4 requests x 16 new): identical tokens {same}")
        if not same:
            raise AssertionError(f"int8 weights, {what}: the card's tokens "
                                 f"are not the CPU's")
    return {"slot": counts, "paged": pcounts, "paged_by_route": by_route,
            "paged_by_kernel": by_kernel,
            "weight_bytes": {k: (o["engine_stats"]["weight_bytes"],
                                 native[k]["engine_stats"]["weight_bytes"])
                             for k, o in (("slot", slot), ("paged", out))},
            "turns": turns}


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
          "serve_replay")


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


def run(torch, phases: set, workdir: str) -> list:
    """Run the phases in order; returns the result lines (none for a subset
    of the phases)."""
    t0 = time.perf_counter()
    device = phase_device(torch)
    with_dir = ("train", "cp_train", "cp_tiny", "tp_train", "tp_tiny",
                "train_remat", "train_spd", "eval", "eval_pth", "eval_tp",
                "gpt2_train", "train_async_preempt", "serve_replay")
    res = {}
    for name in PHASES:
        if name not in phases:
            continue
        t1 = time.perf_counter()
        fn = globals()[f"phase_{name}"]
        res[name] = (fn() if name == "build" else
                     fn(torch, workdir) if name in with_dir else fn(torch))
        log(f"chip_smoke: phase {name} took "
            f"{time.perf_counter() - t1:.1f} s")
    (max_err, times, served, bwd_err, bwd_times, trained, paged_err,
     paged_times, paged_served, ring_err, ring_times, cp_runs, cp_tiny,
     tp_runs, tp_tiny, tp_served, remat_runs, spd_run, evals, eval_pth,
     eval_tp, gpt2_times, gpt2_trained, gpt2_served, preempted, int8_served,
     replayed) = (
         res.get(k) for k in (
             "kernel_vs_plain", "times", "serve", "bwd_check", "bwd_times",
             "train", "paged_check", "paged_times", "paged_serve",
             "ring_check", "ring_times", "cp_train", "cp_tiny", "tp_train",
             "tp_tiny", "tp_serve", "train_remat", "train_spd", "eval",
             "eval_pth", "eval_tp", "gpt2_kernels", "gpt2_train",
             "gpt2_serve", "train_async_preempt", "serve_int8_weights",
             "serve_replay"))
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
                         "train_tp2_sp": tp_runs["tp2_sp"].get(k, 0),
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
                         "serve_replay": replayed.get(k, 0)}
    at_path, at_gpt2 = bwd_times["errs"], gpt2_times["errs"]
    # K3's launches on the gpt2 paged runs, by C entry point
    gpt2_paged = lambda kernel: {
        f"serve_gpt2_{name}": run["paged_by_kernel"][kernel]
        for name, run in gpt2_served.items() if name.startswith("paged")}
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
             "by_shape"]["decode_bf16"]["max_abs_err"]),
         **paged_times["decode"],
         "launches_by_path": {**by_path("paged_attention"),
                              "serve_paged_int8": paged_served["paged_int8"],
                              "serve_paged_int8_by_route":
                                  paged_served["paged_int8_by_route"],
                              "gpt2_paged_decode_kernel":
                                  gpt2_paged("paged_decode"),
                              "serve_paged_int8_weights_decode_kernel":
                                  int8_served["paged_by_kernel"][
                                      "paged_decode"]}},
        {"name": "paged_attention_chunk", "route": "cuda",
         "source": PAGED_SOURCES["chunk"], "replaces": PAGED_REPLACES,
         "launches": paged_served["paged_by_kernel"]["paged_chunk_sm90"],
         "max_abs_err": max(paged_err["chunk"], paged_times["decode"][
             "by_shape"]["chunk_bf16"]["max_abs_err"]),
         **paged_times["chunk"],
         "launches_by_path": {
             "serve_paged": paged_served["paged_by_kernel"][
                 "paged_chunk_sm90"],
             "serve_paged_int8": paged_served["paged_int8_by_kernel"][
                 "paged_chunk_sm90"],
             **{name: run["launches"]["paged_paged_chunk_sm90"]
                for name, run in tp_served.items()},
             **gpt2_paged("paged_chunk_sm90"),
             "serve_paged_int8_weights": int8_served["paged_by_kernel"][
                 "paged_chunk_sm90"]}},
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
