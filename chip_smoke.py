#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`distributed_pytorch_from_scratch_tpu_torch`).

    python3 chip_smoke.py

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
   and the kernel ran exactly 12 times (once per layer) per prefill dispatch;
6. card vs CPU: 45m prefill logits at f32 from the same weights, the
   kernel on the card against the plain path on the CPU;
7. profile: where the time goes in the 45m bf16 prefill and decode steps
   (host wall vs device busy from torch.profiler, kernels per step).

The last two lines are a `{"kernels": [...]}` record and
`{"ok": true, "device": {...}}`.
"""

import json
import subprocess
import sys
import time

REPLACES = "distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py:87"
SOURCE = "distributed_pytorch_from_scratch_tpu_torch/ops/cuda/csrc/flash_fwd.cu"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,  # dense bf16 tensor cores
              "float32": 67e12}    # float32 outside the tensor cores
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


def phase_kernel_vs_plain(torch) -> float:
    """Returns the largest bf16 output error (the served dtype)."""
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        MASK, flash_attention_fwd, flash_attention_fwd_plain)
    cases = [((4, 8, t, 64), 8, None) for t in (64, 300, 512)]
    cases += [((2, 8, 256, 64), 4, 200),     # GQA with padding rows
              ((2, 4, 256, 128), 4, None),   # head_dim 128
              ((2, 4, 192, 32), 2, 150)]     # head_dim 32, GQA, padding
    o_tol = {"bfloat16": 3e-2, "float32": 1e-4}
    lse_tol = {"bfloat16": 1e-3, "float32": 1e-4}
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


def phase_serve(torch) -> int:
    """Returns the kernel launches of the served run."""
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_fwd)
    from distributed_pytorch_from_scratch_tpu_torch.serving import serve
    flash_attention_fwd.launches = 0
    out = serve.main(SERVE_ARGS)
    launches = flash_attention_fwd.launches
    torch.cuda.synchronize()
    layers = model_preset("45m").num_layers
    log(f"serve: {out['completed']}/{out['requests']} requests, "
        f"{out['generated_tokens']} tokens in {out['wall_s']} s -> "
        f"{out['tokens_per_sec']} tok/s; TTFT p50/p95 {out['ttft_ms_p50']}/"
        f"{out['ttft_ms_p95']} ms; TPOT p50/p95 {out['tpot_ms_p50']}/"
        f"{out['tpot_ms_p95']} ms; {out['decode_steps']} decode steps, "
        f"{out['prefill_dispatches']} prefill dispatches, flash kernel "
        f"launches {launches}; device {out['device']}")
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
    return launches


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


def main() -> None:
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
    phase_build()
    max_err = phase_kernel_vs_plain(torch)
    times = phase_times(torch)
    launches = phase_serve(torch)
    phase_card_vs_cpu(torch)
    phase_profile(torch)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    kernel = {"name": "flash_attention_fwd", "route": "cuda",
              "source": SOURCE, "replaces": REPLACES, "launches": launches,
              "max_abs_err": max_err, **times}
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
