#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`distributed_pytorch_from_scratch_tpu_torch`).

    python3 chip_smoke.py [--phases build,bwd_check]

Needs one NVIDIA card (Hopper: the kernels build for sm_90a) and the CUDA
toolkit's nvcc; run it from the root of a checkout. Phases, each raising on
failure (nothing is caught, so any failure exits non-zero before the
result line):

1. device: nvidia-smi's name and power limit, torch's device name and count;
2. build: every CUDA source of the port with nvcc, in parallel, with the
   compiler's per-kernel registers / shared memory / spills;
3. kernel vs plain: the flash-attention forward kernel against its plain
   PyTorch version on the card, at the 45m prefill shapes and a GQA,
   head_dim 32 and head_dim 128 case, bf16 and f32, pad rows exactly zero;
4. kernel times (CUDA events) at the largest 45m prefill shape, beside the
   plain version, one PyTorch library call as a yardstick, and the bound;
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
   backward launches (one block, GQA, multi-block), bf16 and f32, pad rows
   and pad keys exactly zero, each launch counted once;
9. bwd_times: at the 45m training shape q (32, 8, 1000, 64) bf16, the
   shape the train path launches, the forward and both backward kernels
   held against their plain versions on the same inputs, then timed: each
   backward kernel, the pair, and the forward, beside the plain version,
   one PyTorch library call as a yardstick (its device kernel time, from
   torch.profiler), and the bound;
10. train: the port's `train.main` at the 45m preset, full width, bf16,
    b 32 x t 1000, 20 steps on a seeded bigram corpus — finite, falling
    losses, the checkpoint written, the kernels launched 12 (backward) and
    2 x 12 (forward, remat) times per step — then `--resume` for 2 steps;
11. train_card_vs_cpu: 45m f32 loss and every gradient, kernels on the card
    against the plain path on the CPU from the same weights, and one Adam
    update on both devices from the same inputs;
12. train_profile: one 45m bf16 train step under torch.profiler (wall vs
    device busy, kernels per step, the flash kernels' shares).

The last two lines are a `{"kernels": [...]}` record and
`{"ok": true, "device": {...}}`. `--phases` runs a subset (for debugging;
a subset prints no result lines).
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
SOURCE = "distributed_pytorch_from_scratch_tpu_torch/ops/cuda/csrc/flash_fwd.cu"
BWD_SOURCE = "distributed_pytorch_from_scratch_tpu_torch/ops/cuda/csrc/flash_bwd.cu"
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


def phase_build() -> None:
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.build import (
        all_sources, build)
    t0 = time.perf_counter()
    results = build(all_sources())
    log(f"build: {len(results)} source(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    for r in results:
        log(f"build: {r.name}.cu -> {r.path.name} ({r.seconds:.1f} s)")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  {line.strip()}")


def _inputs(torch, shape, hkv, dtype, seed):
    b, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda heads: torch.randn((b, heads, t, d), generator=g,
                                   device="cuda").to(dtype)
    return mk(h), mk(hkv), mk(hkv)


# forward kernel vs its plain version: bf16 o differs by a rounding of p
# before p @ v and of o itself; lse is f32 in both
FWD_O_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
FWD_LSE_TOL = {"bfloat16": 1e-3, "float32": 1e-4}


def phase_kernel_vs_plain(torch) -> float:
    """Returns the largest bf16 output error (the served dtype)."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        MASK, flash_attention_fwd, flash_attention_fwd_plain)
    cases = [((4, 8, t, 64), 8, None) for t in (64, 300, 512)]
    cases += [((2, 8, 256, 64), 4, 200),     # GQA with padding rows
              ((2, 4, 256, 128), 4, None),   # head_dim 128
              ((2, 4, 192, 32), 2, 150)]     # head_dim 32, GQA, padding
    o_tol, lse_tol = FWD_O_TOL, FWD_LSE_TOL
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for i, (shape, hkv, t_real) in enumerate(cases):
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            q, k, v = _inputs(torch, shape, hkv, dtype, seed=i)
            o, lse = flash_attention_fwd(q, k, v, t_real=t_real)
            torch.cuda.synchronize()
            ro, rlse = flash_attention_fwd_plain(q, k, v, t_real=t_real)
            torch.cuda.synchronize()
            live = t_real or shape[2]
            o_err = (o.float() - ro.float()).abs().max().item()
            lse_err = (lse - rlse)[..., :live].abs().max().item()
            pad_ok = t_real is None or (
                bool((o[:, :, t_real:] == 0).all())
                and bool((lse[:, :, t_real:] == MASK).all()))
            log(f"kernel vs plain: q{shape} hkv {hkv} t_real {t_real} {name}: "
                f"o max abs err {o_err:.3e} (tol {o_tol[name]:g}), lse "
                f"{lse_err:.3e} (tol {lse_tol[name]:g}), pad rows exact "
                f"{pad_ok}")
            if not (o_err <= o_tol[name] and lse_err <= lse_tol[name]
                    and pad_ok):
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


def phase_times(torch) -> dict:
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    b, h, t, d = 4, 8, 512, 64
    q, k, v = _inputs(torch, (b, h, t, d), h, torch.bfloat16, seed=99)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel_ms = _time_ms(torch, lambda: flash_attention_fwd(q, k, v))
    plain_ms = _time_ms(torch, lambda: flash_attention_fwd_plain(q, k, v))
    library_ms = _time_ms(torch, lambda: sdpa(q, k, v, is_causal=True))
    kernel_ms_again = _time_ms(torch, lambda: flash_attention_fwd(q, k, v))
    bound_ms, bound_by = bound(b, h, h, t, d, t, "bfloat16")
    log(f"kernel times at q({b}, {h}, {t}, {d}) bf16, warm L2, mean of 100 "
        f"launches: kernel_ms {kernel_ms:.5f} (again {kernel_ms_again:.5f}), "
        f"plain_ms {plain_ms:.5f}, library_ms {library_ms:.5f} "
        f"(scaled_dot_product_attention, is_causal), bound_us "
        f"{bound_ms * 1e3:.3f} ({bound_by})")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_serve(torch) -> dict:
    """Returns the served run's launches {fwd, dq, dkv}."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    _reset_launches()
    out = serve.main(SERVE_ARGS)
    launches, dq, dkv = _read_launches()
    torch.cuda.synchronize()
    layers = model_preset("45m").num_layers
    log(f"serve: {out['completed']}/{out['requests']} requests, "
        f"{out['generated_tokens']} tokens in {out['wall_s']} s -> "
        f"{out['tokens_per_sec']} tok/s; TTFT p50/p95 {out['ttft_ms_p50']}/"
        f"{out['ttft_ms_p95']} ms; TPOT p50/p95 {out['tpot_ms_p50']}/"
        f"{out['tpot_ms_p95']} ms; {out['decode_steps']} decode steps, "
        f"{out['prefill_dispatches']} prefill dispatches, flash kernel "
        f"launches {launches} (backward dq/dkv {dq}/{dkv}); device "
        f"{out['device']}")
    if out["completed"] != out["requests"]:
        raise AssertionError(f"served {out['completed']} of "
                             f"{out['requests']} requests")
    toks = [t for ts in out["outputs"].values() for t in ts]
    if not toks or not all(0 <= t < 1024 for t in toks):
        raise AssertionError("generated tokens missing or outside the vocab")
    if launches != layers * out["prefill_dispatches"] or launches == 0:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {layers} x "
                             f"{out['prefill_dispatches']} prefill dispatches")
    if (dq, dkv) != (0, 0):
        raise AssertionError(f"serving launched the backward kernels "
                             f"(dq {dq}, dkv {dkv})")
    return {"fwd": launches, "dq": dq, "dkv": dkv}


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
        if "flash_fwd_kernel" in e.name:
            flash += us
            n_flash += 1
    return busy / 1e3, n, flash / 1e3, n_flash


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
    p = profile_engine(torch, model_preset("45m", compute_dtype="bfloat16"),
                       "cuda")
    if p["admit_kernels"] == 0 or p["decode_kernels"] == 0:
        log("profile: torch.profiler saw no device kernels; device busy "
            "time not measured")
        return
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


BWD_CASES = [  # (b, h, hkv, t, d, t_real) and the TPU launch it stands for
    ((4, 8, 8, 1000, 64, None), "row 2: one block, group 1"),
    ((2, 8, 4, 256, 64, 200), "row 3: one block, GQA, pad rows"),
    ((1, 4, 2, 1300, 64, 1250), "rows 4-5: t > 1024, multi-block"),
    ((2, 4, 4, 192, 32, 150), "head_dim 32, pad rows"),
    ((2, 4, 4, 256, 128, None), "head_dim 128"),
]
# error relative to the plain version's largest |gradient|: f32 differs
# only by summation order; bf16 also by the output's rounding, one bf16
# step (2^-8 of the largest value) where the two f32 sums straddle a step,
# and rarely by a p or ds value rounded the other way
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _bwd_inputs(torch, case, dtype, seed):
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_fwd_plain)
    b, h, hkv, t, d, t_real = case
    q, k, v = _inputs(torch, (b, h, t, d), hkv, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn((b, h, t, d), generator=g, device="cuda").to(dtype)
    o, lse = flash_attention_fwd_plain(q, k, v, t_real=t_real)
    return q, k, v, o, lse, do


def phase_bwd_check(torch) -> dict:
    """Returns the largest bf16 abs error of each kernel's outputs."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)
    worst = {"dq": 0.0, "dkv": 0.0}
    for i, (case, what) in enumerate(BWD_CASES):
        b, h, hkv, t, d, t_real = case
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            args = _bwd_inputs(torch, case, dtype, seed=10 + i)
            n_dq = flash_attention_bwd.launches_dq
            n_dkv = flash_attention_bwd.launches_dkv
            got = flash_attention_bwd(*args, t_real=t_real)
            torch.cuda.synchronize()
            launched = (flash_attention_bwd.launches_dq - n_dq,
                        flash_attention_bwd.launches_dkv - n_dkv)
            ref = flash_attention_bwd_plain(*args, t_real=t_real)
            torch.cuda.synchronize()
            errs, ok = [], launched == (1, 1)
            for label, x, r in zip(("dq", "dk", "dv"), got, ref):
                err = (x.float() - r.float()).abs().max().item()
                scale = r.float().abs().max().item()
                rel = err / max(scale, 1e-30)
                ok &= x.dtype == r.dtype and rel <= BWD_TOL[name]
                errs.append(f"{label} {err:.3e} (rel {rel:.2e})")
                if name == "bfloat16":
                    key = "dq" if label == "dq" else "dkv"
                    worst[key] = max(worst[key], err)
            pad_ok = t_real is None or all(
                bool((x[:, :, t_real:] == 0).all()) for x in got)
            log(f"bwd vs plain: {what}: q({b}, {h}, {t}, {d}) hkv {hkv} "
                f"t_real {t_real} {name}: max abs err {', '.join(errs)} "
                f"(tol rel {BWD_TOL[name]:g} of max |grad|); pad rows/keys "
                f"exact {pad_ok}; launches dq/dkv {launched}")
            if not (ok and pad_ok):
                raise AssertionError(f"flash backward kernels disagree with "
                                     f"their plain version at {case} {name}")
    return worst


def phase_bwd_times(torch) -> dict:
    """At the training shape, the shape the train path launches: the
    forward and both backward kernels held against their plain versions on
    the same inputs, then timed. Returns the kernels-line fields of
    flash_attention_bwd_dq / _dkv, the forward's time and the errors."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        _bwd_args, _delta, _launch_dkv, _launch_dq, flash_attention_bwd,
        flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    b, h, t, d = TRAIN_SHAPE
    q, k, v = _inputs(torch, TRAIN_SHAPE, h, torch.bfloat16, seed=7)
    g = torch.Generator(device="cuda").manual_seed(8)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v)
    ro, rlse = flash_attention_fwd_plain(q, k, v)
    errs = {"o": (o.float() - ro.float()).abs().max().item(),
            "lse": (lse - rlse).abs().max().item()}
    del ro, rlse
    got = flash_attention_bwd(q, k, v, o, lse, do)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do)
    rels = {}
    for label, x, r in zip(("dq", "dk", "dv"), got, ref):
        errs[label] = (x.float() - r.float()).abs().max().item()
        rels[label] = errs[label] / max(r.float().abs().max().item(), 1e-30)
    del got, ref
    torch.cuda.empty_cache()   # the plain version's t x t temporaries
    log(f"kernels vs plain at q{TRAIN_SHAPE} bf16 (the train path's shape): "
        f"forward o max abs err {errs['o']:.3e} (tol {FWD_O_TOL['bfloat16']:g}"
        f"), lse {errs['lse']:.3e} (tol {FWD_LSE_TOL['bfloat16']:g}); "
        + ", ".join(f"{x} {errs[x]:.3e} (rel {rels[x]:.2e})" for x in rels)
        + f" (tol rel {BWD_TOL['bfloat16']:g} of max |grad|)")
    if not (errs["o"] <= FWD_O_TOL["bfloat16"]
            and errs["lse"] <= FWD_LSE_TOL["bfloat16"]
            and all(r <= BWD_TOL["bfloat16"] for r in rels.values())):
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions at q{TRAIN_SHAPE} bf16")
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
        fwd_ms = _time_ms(torch, lambda: flash_attention_fwd(q, k, v))
        dq_ms = _time_ms(torch, run_dq)
        dkv_ms = _time_ms(torch, run_dkv)
        pair_ms = _time_ms(torch, lambda: flash_attention_bwd(q, k, v, o, lse,
                                                              do))
        plain_ms = _time_ms(torch, lambda: flash_attention_bwd_plain(
            q, k, v, o, lse, do), iters=10, warmup=2)
        fwd_plain_ms = _time_ms(torch, lambda: flash_attention_fwd_plain(
            q, k, v), iters=10, warmup=2)
    (sdpa_fwd_ms, sdpa_both_ms), how = _device_ms(
        torch, [lambda: sdpa(q, k, v, is_causal=True), sdpa_fwd_bwd])
    library_ms = sdpa_both_ms - sdpa_fwd_ms
    sdpa_both_event_ms = _time_ms(torch, sdpa_fwd_bwd)
    pair_again_ms = _time_ms(torch, lambda: flash_attention_bwd(
        q, k, v, o, lse, do))
    bounds = {part: bound_bwd(b, h, h, t, d, t, "bfloat16", part)
              for part in ("dq", "dkv", "pair")}
    fwd_bound = bound(b, h, h, t, d, t, "bfloat16")
    log(f"bwd times at q{TRAIN_SHAPE} bf16, mean of 100 launches (plain: "
        f"of 10), CUDA events: dq kernel {dq_ms:.5f} ms (bound "
        f"{bounds['dq'][0]:.5f} ms, {bounds['dq'][1]}); dk/dv kernel "
        f"{dkv_ms:.5f} ms (bound {bounds['dkv'][0]:.5f} ms, "
        f"{bounds['dkv'][1]}); pair through the wrapper (incl. delta) "
        f"{pair_ms:.5f} ms (again {pair_again_ms:.5f}; bound "
        f"{bounds['pair'][0]:.5f} ms, {bounds['pair'][1]}); plain backward "
        f"{plain_ms:.5f} ms; library: scaled_dot_product_attention "
        f"(is_causal), {how}: forward+backward {sdpa_both_ms:.5f} minus forward "
        f"{sdpa_fwd_ms:.5f} = {library_ms:.5f} ms (forward+backward by "
        f"CUDA events, host included: {sdpa_both_event_ms:.5f} ms); "
        f"forward kernel at this "
        f"shape {fwd_ms:.5f} ms (plain {fwd_plain_ms:.5f} ms, library "
        f"{sdpa_fwd_ms:.5f} ms, bound {fwd_bound[0]:.5f} ms, "
        f"{fwd_bound[1]})")
    del qg, kg, vg
    torch.cuda.empty_cache()
    common = {"plain_ms": plain_ms, "plain_for": "the pair (dq, dk, dv)",
              "library_ms": library_ms,
              "library_for": "the pair: scaled_dot_product_attention "
                             f"backward minus its forward, {how}"}
    return {"dq": {"ms": dq_ms, "bound_ms": bounds["dq"][0],
                   "bound_by": bounds["dq"][1], **common},
            "dkv": {"ms": dkv_ms, "bound_ms": bounds["dkv"][0],
                    "bound_by": bounds["dkv"][1], **common},
            "pair_ms": pair_ms, "fwd_ms": fwd_ms, "errs": errs}


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
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches_dq = 0
    flash_attention_bwd.launches_dkv = 0


def _read_launches():
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    return (flash_attention_fwd.launches, flash_attention_bwd.launches_dq,
            flash_attention_bwd.launches_dkv)


def phase_train(torch, workdir: str) -> dict:
    """Returns the train path's launches {fwd, dq, dkv} and its summary."""
    import math
    from distributed_pytorch_from_scratch_tpu_torch import train
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    data = os.path.join(workdir, "bigram.json")
    t0 = time.perf_counter()
    write_bigram_corpus(data)
    log(f"train: bigram corpus written in {time.perf_counter() - t0:.1f} s")
    save_dir = os.path.join(workdir, "ckpt")
    args = TRAIN_ARGS + ["--data_path", data, "--save_dir", save_dir]
    _reset_launches()
    out = train.main(args)
    fwd, dq, dkv = _read_launches()
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
    want = (2 * layers * TRAIN_STEPS, layers * TRAIN_STEPS,
            layers * TRAIN_STEPS)
    if (fwd, dq, dkv) != want:
        raise AssertionError(f"launches fwd/dq/dkv {(fwd, dq, dkv)}, expected "
                             f"{want} (remat: forward twice per layer)")
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
    return {"fwd": fwd, "dq": dq, "dkv": dkv, "summary": out}


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


def phase_train_profile(torch) -> dict:
    """One 45m bf16 train step (b 32 x t 1000, remat) under torch.profiler,
    after two warm-up steps on the same batch."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, state = step(state, ids, ids, pos)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    flash = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    busy, n, by_name, counts = 0.0, 0, {}, {}
    for e in prof.events():
        if e.device_type != cuda:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        n += 1
        key = next((k for k in flash if k in e.name), e.name)
        by_name[key] = by_name.get(key, 0.0) + us
        counts[key] = counts.get(key, 0) + 1
    if n == 0:
        log("train profile: torch.profiler saw no device kernels; device "
            "busy time not measured")
        return {}
    shares = {k: by_name.get(k, 0.0) / busy for k in flash}
    others = sorted((k for k in by_name if k not in flash),
                    key=by_name.get, reverse=True)[:8]
    log(f"train profile (45m bf16, b32 x t1000, remat): step wall "
        f"{wall_ms:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / 1e3 / wall_ms:.3f}, {n} kernels; shares of busy: "
        + ", ".join(f"{k} {v:.3f} ({by_name.get(k, 0.0) / 1e3:.3f} ms)"
                    for k, v in shares.items()))
    for k in others:   # where the rest of the step goes
        log(f"  {by_name[k] / busy:.3f} of busy ({by_name[k] / 1e3:.3f} ms, "
            f"{counts[k]} launches): {k[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy / 1e3, "kernels": n,
            "shares": shares}


PHASES = ("build", "kernel_vs_plain", "times", "serve", "card_vs_cpu",
          "profile", "bwd_check", "bwd_times", "train", "train_card_vs_cpu",
          "train_profile")


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
        with tempfile.TemporaryDirectory() as workdir:
            trained = phase_train(torch, workdir)
    if "train_card_vs_cpu" in phases:
        phase_train_card_vs_cpu(torch)
    if "train_profile" in phases:
        phase_train_profile(torch)
    log(f"chip_smoke: phases {','.join(p for p in PHASES if p in phases)} "
        f"passed in {time.perf_counter() - t0:.1f} s")
    if phases != set(PHASES):
        return
    by_path = lambda k: {"serve": served[k], "train": trained[k]}
    at_path = bwd_times["errs"]
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": served["fwd"],
         "max_abs_err": max(max_err, at_path["o"]),
         "max_abs_err_train_shape": at_path["o"], **times,
         "launches_by_path": by_path("fwd")},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": BWD_SOURCE, "replaces": BWD_REPLACES,
         "launches": trained["dq"],
         "max_abs_err": max(bwd_err["dq"], at_path["dq"]),
         "max_abs_err_train_shape": at_path["dq"], **bwd_times["dq"],
         "launches_by_path": by_path("dq")},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": BWD_SOURCE, "replaces": BWD_REPLACES,
         "launches": trained["dkv"],
         "max_abs_err": max(bwd_err["dkv"], at_path["dk"], at_path["dv"]),
         "max_abs_err_train_shape": max(at_path["dk"], at_path["dv"]),
         **bwd_times["dkv"], "launches_by_path": by_path("dkv")},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
