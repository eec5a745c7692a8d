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
   head_dim 32/64/128, GQA groups 2 and 4, pad rows exactly zero, one
   launch per call;
4. kernel times at the largest 45m prefill shape: bare launches (CUDA
   events) and device time (torch.profiler), achieved TFLOP/s, beside the
   plain version, SDPA as a yardstick, and the bound;
5. serve: the port's `serve.main` at the 45m preset, full width, bf16,
   random weights — every request completes, every token is in the vocab,
   the forward kernel ran exactly 12 times (once per layer) per prefill
   dispatch and the backward kernels not at all;
6. card vs CPU: 45m prefill logits at f32 from the same weights, the
   kernel on the card against the plain path on the CPU;
7. profile: where the time goes in the 45m bf16 prefill and decode steps
   (host wall vs device busy from torch.profiler, kernels per step);
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
    a row that sees nothing, a full table, pad columns (qlen < cw); one
    launch per call, on the route its width names and the kernel
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
    wgmma kernel every time, the SIMT one never), and no flash kernel;
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
    the 45m preset, bf16, b 8 x t 1000 with remat: zig-zag 10 steps, a
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
    torch.profiler in each rank: wall, device busy, the card's idle share,
    kernels, the block kernels' share (no SIMT block kernel may run), and
    the time in the ring's hops.

The last two lines are a `{"kernels": [...]}` record and
`{"ok": true, "device": {...}}`. `--phases` runs a subset (for debugging;
a subset prints no result lines). The cp phases start their ranks as
processes of their own (`runtime/launch.spawn`); the build phase has built
every kernel before they start.
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
    """At the training shape, the shape the train path launches: the
    forward and both backward kernels held against their plain versions on
    the same inputs (bf16 per element, with their rounding slack), then
    timed by bare launches (CUDA events) and device time (torch.profiler).
    Returns the kernels-line fields of flash_attention_bwd_dq / _dkv, the
    forward's times and the errors."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        _bwd_args, _delta, _launch_dkv, _launch_dq, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain, rounding_slack)
    b, h, t, d = TRAIN_SHAPE
    q, k, v = _inputs(torch, TRAIN_SHAPE, h, torch.bfloat16, seed=7)
    g = torch.Generator(device="cuda").manual_seed(8)
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
    log(f"kernels vs plain at q{TRAIN_SHAPE} bf16 (the train path's shape): "
        f"max abs err " + ", ".join(f"{x} {errs[x]:.3e}" for x in errs)
        + "; err/limit " + ", ".join(f"{x} {ratios[x]:.3f}" for x in ratios)
        + f" (limit {BWD_LIMIT['bfloat16']}; lse tol "
        f"{FWD_LSE_TOL['bfloat16']:g})")
    if not (max(ratios.values()) <= 1.0
            and errs["lse"] <= FWD_LSE_TOL["bfloat16"]):
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions at q{TRAIN_SHAPE} bf16")
    fwd = _fwd_times(torch, TRAIN_SHAPE, seed=7)
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
    log(f"bwd times at q{TRAIN_SHAPE} bf16 (flash_bwd_sm90), bare launches, "
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


def write_bigram_corpus(path: str, vocab: int = 1024, docs: int = 3000,
                        seed: int = 0) -> None:
    """Token JSON in TokenDataset's schema: `docs` documents of 200-999
    tokens, each following one bigram rule drawn from the seed (next =
    perm[prev]) from a random first token, so the loss has something to
    learn. Ids 0-2 are the special tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nxt = np.zeros(vocab, np.int64)
    nxt[3:] = rng.permutation(np.arange(3, vocab))
    lens = rng.integers(200, 1000, size=docs)
    chains = np.empty((docs, int(lens.max())), np.int64)
    chains[:, 0] = rng.integers(3, vocab, size=docs)
    for i in range(1, chains.shape[1]):
        chains[:, i] = nxt[chains[:, i - 1]]
    train = [row[:n].tolist() for row, n in zip(chains, lens)]
    with open(path, "w") as f:
        json.dump({"train": train, "validation": train[:8],
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
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
        paged_attention)
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
        PagedEngine)
    layers = model_preset("45m").num_layers
    dispatch = PagedEngine._dispatch_chunk
    widths = []

    def seen(self, slot, st, n, done):   # records each chunk's width
        widths.append(n)
        return dispatch(self, slot, st, n, done)

    n = PAGED_SERVE_ARGS.index("--num_requests") + 1
    runs = {"bf16": PAGED_SERVE_ARGS,
            "int8": PAGED_SERVE_ARGS[:n] + [str(PAGED_INT8_REQUESTS)]
            + PAGED_SERVE_ARGS[n + 1:] + ["--kv_dtype", "int8"]}
    by_kv = {}
    for kv, args in runs.items():
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
CP_RUNS = {  # name: (flags, steps)
    "zigzag": (["--cp_layout", "zigzag"], 10),
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
        ranks = "; ".join(
            f"rank {r['rank']}: peak {r['peak_mem_gib']:.3f} GiB, hops "
            f"{r['collectives']['calls']} calls, "
            f"{r['collectives']['bytes'] / 1e9:.3f} GB, wait "
            f"{r['collectives']['wait_s']:.3f} s + hop "
            f"{r['collectives']['hop_s']:.3f} s of {r['wall_s']:.3f} s wall "
            f"(hop share {r['collectives']['hop_s'] / r['wall_s']:.3f})"
            for r in res["ranks"])
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
    hops = dict(collectives.stats)
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
    busy, n, by_name = 0.0, 0, {}
    for name, us in _profiled(torch, one_step, f"cp profile, rank {rank}",
                              every_rank):
        busy += us
        n += 1
        if any(k in name for k in BLOCK_SIMT_KERNELS):
            raise AssertionError(f"the bf16 cp step ran a SIMT block kernel: "
                                 f"{name}")
        key = next((k for k in k2 if k in name), "other")
        by_name[key] = by_name.get(key, 0.0) + us
    return {"rank": rank, "wall_ms": wall_ms, "busy_ms": busy / 1e3,
            "kernels": n, "k2_ms": {k: by_name.get(k, 0.0) / 1e3 for k in k2},
            "hops": hops}


def phase_cp_profile(torch) -> dict:
    from distributed_pytorch_from_scratch_tpu_torch.runtime import launch
    ranks = launch.spawn(_cp_profile_rank, 2)
    r0 = ranks[0]
    card_busy = sum(r["busy_ms"] for r in ranks)
    k2 = sum(r0["k2_ms"].values())
    hop = r0["hops"]
    log(f"cp profile (45m bf16, cp=2 zigzag over gloo on one card, b8 x "
        f"t1000, remat), rank 0's step: wall {r0['wall_ms']:.3f} ms, device "
        f"busy {r0['busy_ms']:.3f} ms over {r0['kernels']} kernels (rank 1: "
        f"{ranks[1]['busy_ms']:.3f} ms, {ranks[1]['kernels']}); the card's "
        f"idle share 1 - (both ranks' busy) / wall "
        f"{1 - card_busy / r0['wall_ms']:.3f} (rank 0's alone "
        f"{1 - r0['busy_ms'] / r0['wall_ms']:.3f}); K2 kernels "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in r0["k2_ms"].items())
        + f" ({k2 / r0['busy_ms']:.3f} of rank 0's busy); ring hops "
        f"{hop['calls']} calls, {hop['bytes'] / 1e9:.3f} GB: wait for the "
        f"device {hop['wait_s'] * 1e3:.3f} ms + staged copies and transfer "
        f"{hop['hop_s'] * 1e3:.3f} ms ({hop['hop_s'] * 1e3 / r0['wall_ms']:.3f}"
        f" of the wall)")
    return {"ranks": ranks}


PHASES = ("build", "kernel_vs_plain", "times", "serve", "card_vs_cpu",
          "profile", "bwd_check", "bwd_times", "train", "train_card_vs_cpu",
          "train_profile", "paged_check", "paged_times", "paged_serve",
          "paged_card_vs_cpu", "paged_profile", "ring_check", "ring_times",
          "cp_train", "cp_tiny", "cp_card_vs_cpu", "cp_profile")


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
    if "build" in phases:
        phase_build()
    if "kernel_vs_plain" in phases:
        max_err = phase_kernel_vs_plain(torch)
    if "times" in phases:
        times = phase_times(torch)
    if "serve" in phases:
        served = phase_serve(torch)
    if "card_vs_cpu" in phases:
        phase_card_vs_cpu(torch)
    if "profile" in phases:
        phase_profile(torch)
    if "bwd_check" in phases:
        bwd_err = phase_bwd_check(torch)
    if "bwd_times" in phases:
        bwd_times = phase_bwd_times(torch)
    if "train" in phases:
        trained = phase_train(torch, workdir)
    if "train_card_vs_cpu" in phases:
        phase_train_card_vs_cpu(torch)
    if "train_profile" in phases:
        phase_train_profile(torch)
    if "paged_check" in phases:
        paged_err = phase_paged_check(torch)
    if "paged_times" in phases:
        paged_times = phase_paged_times(torch)
    if "paged_serve" in phases:
        paged_served = phase_paged_serve(torch)
    if "paged_card_vs_cpu" in phases:
        phase_paged_card_vs_cpu(torch)
    if "paged_profile" in phases:
        phase_paged_profile(torch)
    if "ring_check" in phases:
        ring_err = phase_ring_check(torch)
    if "ring_times" in phases:
        ring_times = phase_ring_times(torch)
    if "cp_train" in phases:
        cp_runs = phase_cp_train(torch, workdir)
    if "cp_tiny" in phases:
        cp_tiny = phase_cp_tiny(torch, workdir)
    if "cp_card_vs_cpu" in phases:
        phase_cp_card_vs_cpu(torch)
    if "cp_profile" in phases:
        phase_cp_profile(torch)
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
                         "train_cp2_tiny_bf16": cp_tiny["bfloat16"].get(k, 0)}
    at_path = bwd_times["errs"]
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": served["flash_attention_fwd"],
         "max_abs_err": max(max_err, at_path["o"]),
         "max_abs_err_train_shape": at_path["o"], **times,
         "train_shape": bwd_times["fwd"],
         "launches_by_path": by_path("flash_attention_fwd")},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": BWD_SOURCE, "replaces": BWD_REPLACES,
         "launches": trained["flash_attention_bwd_dq"],
         "max_abs_err": max(bwd_err["dq"], at_path["dq"]),
         "max_abs_err_train_shape": at_path["dq"], **bwd_times["dq"],
         "launches_by_path": by_path("flash_attention_bwd_dq")},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": BWD_SOURCE, "replaces": BWD_REPLACES,
         "launches": trained["flash_attention_bwd_dkv"],
         "max_abs_err": max(bwd_err["dkv"], at_path["dk"], at_path["dv"]),
         "max_abs_err_train_shape": max(at_path["dk"], at_path["dv"]),
         **bwd_times["dkv"],
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
                                  paged_served["paged_int8_by_route"]}},
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
