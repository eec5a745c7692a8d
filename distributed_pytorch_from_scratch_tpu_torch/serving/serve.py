"""Offline serving benchmark CLI: loadgen -> continuous-batching engine.

    python -m distributed_pytorch_from_scratch_tpu_torch.serving.serve \\
        --model 45m --random_init --num_requests 16 --arrival burst
    python -m distributed_pytorch_from_scratch_tpu_torch.serving.serve \\
        --model 45m --random_init --paged --page_size 64 --num_pages 80

Drives the slot engine, or with `--paged` the paged engine (page-table KV
cache with copy-on-write prefix reuse, chunked prefill, the SLO scheduler
and preemption; serving/engine.py), with a synthetic Poisson or burst
arrival stream, and prints ONE JSON record on stdout with the serving
metrics — TTFT / TPOT / queue-wait p50/p95, slot occupancy, tokens/s, and
for the paged engine the page, prefix-cache, preemption and SLO-attainment
numbers — and the device that ran them. Runs on `cuda:0` unless `--device
cpu` is given; with no card and no `--device cpu` it exits non-zero. The
paged engine attends through the CUDA paged-attention kernel unless
`--paged_attn gather` asks for the dense page view.

Weights: `--random_init` (fresh random weights from `--seed`, the
checkpoint-free benchmark), or `--ckpt_dir` with a tp=1 checkpoint written
by the JAX package's trainer. `--dry_run` shrinks everything to a tiny
smoke run.

Not ported yet, refused with a message: tp > 1, cp > 1, sampled decoding
(temperature > 0), speculative decoding, int8 decode weights. The JAX
CLI's gpt2 family, trace replay and observability/control flags do not
exist here yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..cli import add_model_shape_args, build_model_config
from ..config import MeshConfig, ModelConfig
from ..interop import params_from_jax
from ..models.transformer import Transformer
from ..runtime.mesh import make_mesh
from ..training.checkpoint import latest_step, load_params
from .engine import ContinuousBatchingEngine, PagedEngine
from .loadgen import run_loadgen, synthetic_requests
from .scheduler import parse_slo_classes

# head_dim 32, so the dry run also fits the CUDA kernel's head dims
_DRY_CFG = ModelConfig(attn_dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                       vocab_size=64, maxlen=64)

# JAX CLI flags kept so its command lines parse: any value but the default
# is refused, naming what is not ported yet (ROADMAP.md)
NOT_PORTED = [  # (flag dest, default, what the flag would turn on)
    ("tp_size", 1, "tensor parallelism"),
    ("cp", 1, "the cp-sharded page pool"),
    ("speculate", 0, "speculative decoding"),
    ("decode_weight_dtype", "native", "int8 decode weights"),
]


def get_serve_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    g = p.add_argument_group("model")
    g.add_argument("--ckpt_dir", default=None,
                   help="serve this tp=1 checkpoint (the JAX trainer's npz "
                        "shards); omit with --random_init/--dry_run")
    g.add_argument("--iter", type=int, default=None,
                   help="checkpoint iteration (default: latest)")
    g.add_argument("--random_init", action="store_true",
                   help="serve fresh random weights at the flag shape")
    g.add_argument("--vocab_size", type=int, default=1024,
                   help="vocab size (EOS id is 1, the shipped tokenizer's)")
    g.add_argument("--tp_size", type=int, default=1, help="1 only, so far")
    add_model_shape_args(g)

    g = p.add_argument_group("engine")
    g.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    g.add_argument("--slots", type=int, default=8,
                   help="KV-pool slots = max concurrently decoding requests")
    g.add_argument("--buf_len", type=int, default=0,
                   help="per-slot cache length (0 = longest prompt + "
                        "--max_new_tokens + 2)")
    g.add_argument("--max_new_tokens", type=int, default=64)
    g.add_argument("--prefill_bucket", type=int, default=64,
                   help="prefill width bucket (prompts pad to a multiple "
                        "of this, not to the full buffer); 0 = off")
    g.add_argument("--max_prefill_batch", type=int, default=4,
                   help="max prompts per prefill dispatch")
    g.add_argument("--queue_limit", type=int, default=0,
                   help="backpressure: max waiting requests; 0 = unbounded")
    g.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy (the only mode ported so far)")
    g.add_argument("--decode_weight_dtype", choices=["native", "int8"],
                   default="native", help="native only, so far")

    g = p.add_argument_group("paged engine")
    g.add_argument("--paged", action="store_true",
                   help="serve through the PAGED engine: page-table KV "
                        "cache with COW prefix reuse, chunked prefill, and "
                        "the SLO-aware scheduler")
    g.add_argument("--page_size", type=int, default=64,
                   help="--paged: tokens per KV page")
    g.add_argument("--kv_dtype", choices=["native", "int8"],
                   default="native",
                   help="--paged: KV-page storage dtype; 'int8' stores "
                        "codes + one f32 scale per head-vector")
    g.add_argument("--paged_attn", choices=["gather", "kernel", "pallas"],
                   default=None,
                   help="--paged: the attend over the page table. 'kernel' "
                        "(the default; 'pallas' is another name for it) "
                        "walks the table in place in the CUDA paged-"
                        "attention kernels (ops/cuda/paged_attention.py), "
                        "int8 dequant fused; 'gather' materializes the "
                        "dense page view per layer (the oracle). Token-"
                        "identical greedy output at float32")
    g.add_argument("--num_pages", type=int, default=0,
                   help="--paged: page-pool budget in pages (0 = slots x "
                        "ceil(buf_len/page_size), no oversubscription)")
    g.add_argument("--cp", type=int, default=1, help="1 only, so far")
    g.add_argument("--prefill_chunk", type=int, default=128,
                   help="--paged: prefill positions per chunk; a live "
                        "stream's decode never stalls by more than one "
                        "chunk")
    g.add_argument("--slo_classes", default="interactive=0.25,standard=1.0,"
                                            "batch=8.0",
                   help="--paged: TTFT deadline classes, name=seconds "
                        "pairs (scheduler.parse_slo_classes)")
    g.add_argument("--default_class", default="standard",
                   help="--paged: class for requests that name none")
    g.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="0 only, so far")

    g = p.add_argument_group("loadgen")
    g.add_argument("--class_mix", default="",
                   help="draw request classes by weight, e.g. "
                        "'interactive=1,batch=1' (empty = default class)")
    g.add_argument("--tenants", type=int, default=1,
                   help="spread requests over N tenants (the fair-queuing "
                        "axis)")
    g.add_argument("--shared_prefix_len", type=int, default=0,
                   help="prepend one common random prefix of N tokens to "
                        "every prompt (feeds the COW prefix cache)")
    g.add_argument("--interleave", action="store_true",
                   help="alternate short/long prompts (prompt_len_min / "
                        "prompt_len_max) instead of uniform lengths")
    g.add_argument("--num_requests", type=int, default=32)
    g.add_argument("--rate", type=float, default=4.0,
                   help="poisson arrival rate, requests/second")
    g.add_argument("--arrival", choices=["poisson", "burst"],
                   default="poisson")
    g.add_argument("--prompt_len_min", type=int, default=8)
    g.add_argument("--prompt_len_max", type=int, default=64)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--dry_run", action="store_true",
                   help="tiny random-init model + a 6-request burst; "
                        "ignores --ckpt_dir")
    args = p.parse_args(argv)
    for dest, default, what in NOT_PORTED:
        if getattr(args, dest) != default:
            p.error(f"--{dest} {getattr(args, dest)}: not ported yet "
                    f"({what}; see ROADMAP)")
    if args.temperature > 0:
        p.error("--temperature > 0: sampled decoding is not ported yet (see "
                "ROADMAP)")
    if args.temperature < 0:
        p.error(f"--temperature must be >= 0, got {args.temperature}")
    # the page and SLO knobs only matter to the paged engine; a silent
    # no-op would misreport what the run measured
    if not args.paged:
        if args.paged_attn is not None:
            p.error("--paged_attn is a --paged knob (the slot engine has "
                    "no page table to walk)")
        if args.num_pages:
            p.error("--num_pages is a --paged knob")
        if args.kv_dtype != "native":
            p.error("--kv_dtype is a --paged knob (the slot pool stores "
                    "the compute dtype; only the page pool quantizes)")
        if args.class_mix:
            p.error("--class_mix needs --paged (the FIFO engine has no "
                    "SLO classes)")
        if args.tenants != 1:
            p.error("--tenants needs --paged (the FIFO engine ignores "
                    "tenants)")
    # 'pallas' is the JAX CLI's name for the kernel impl
    args.paged_attn = {None: "kernel", "pallas": "kernel"}.get(
        args.paged_attn, args.paged_attn)
    if not args.dry_run and not args.random_init and not args.ckpt_dir:
        p.error("pick a weight source: --ckpt_dir, --random_init, or "
                "--dry_run")
    return args


def _load_model(args, cfg: ModelConfig, device) -> Transformer:
    model = Transformer(cfg)
    if args.random_init or args.dry_run or not args.ckpt_dir:
        model.init_weights(args.seed)
    else:
        step = args.iter if args.iter is not None else latest_step(args.ckpt_dir)
        if step is None:
            raise SystemExit(f"no checkpoints found in {args.ckpt_dir}")
        model.load_state_dict(params_from_jax(load_params(args.ckpt_dir, step)))
        print(f"serving checkpoint iter {step} from {args.ckpt_dir}",
              file=sys.stderr)
    return model.to(device)


def serve(args: argparse.Namespace) -> dict:
    """Run the benchmark; prints the JSON record and returns the loadgen
    summary plus `device`, `prefill_dispatches` (prefill or chunk
    dispatches), `engine_stats` (the engine's `stats()` after the drain)
    and `outputs` ({rid: generated ids})."""
    try:
        mesh = make_mesh(MeshConfig(tp=args.tp_size), device=args.device)
    except RuntimeError as e:
        raise SystemExit(f"serve: {e}")
    eos_id = 1  # the shipped tokenizer's EOS (tokenizer/tokenizer.json)
    vocab_size = args.vocab_size
    if args.dry_run:
        cfg = _DRY_CFG
        vocab_size = cfg.vocab_size
        args.slots, args.max_prefill_batch = 4, 2
        args.num_requests, args.arrival = 6, "burst"
        args.prompt_len_min, args.prompt_len_max = 4, 12
        args.max_new_tokens = min(args.max_new_tokens, 8)
        args.buf_len, args.prefill_bucket = 24, 8
        if args.paged:       # tiny pages so the smoke crosses boundaries
            args.page_size, args.prefill_chunk = 8, 8
            args.num_pages = 0
            if not args.class_mix:
                args.class_mix = "interactive=1,standard=1"
            args.shared_prefix_len = max(args.shared_prefix_len, 4)
    else:
        cfg = build_model_config(args, vocab_size)
    model = _load_model(args, cfg, mesh.device)

    mix = parse_slo_classes(args.class_mix) if args.class_mix else None
    requests = synthetic_requests(
        args.num_requests, args.prompt_len_min, args.prompt_len_max,
        args.max_new_tokens, vocab_size, seed=args.seed, rate=args.rate,
        arrival=args.arrival, class_mix=mix, tenants=args.tenants,
        shared_prefix_len=args.shared_prefix_len, interleave=args.interleave)
    longest = max(len(r.prompt) for r in requests)
    buf_len = args.buf_len or (longest + args.max_new_tokens + 2)
    if args.paged:
        engine = PagedEngine(
            model, mesh, num_slots=args.slots, buf_len=buf_len,
            eos_id=eos_id, page_size=args.page_size,
            num_pages=args.num_pages, prefill_chunk=args.prefill_chunk,
            temperature=args.temperature,
            slo_classes=parse_slo_classes(args.slo_classes),
            default_class=args.default_class, max_queue=args.queue_limit,
            kv_dtype=None if args.kv_dtype == "native" else args.kv_dtype,
            paged_attn_impl=args.paged_attn)
    else:
        engine = ContinuousBatchingEngine(
            model, mesh, num_slots=args.slots, buf_len=buf_len,
            eos_id=eos_id, temperature=args.temperature,
            prefill_bucket=args.prefill_bucket,
            max_prefill_batch=args.max_prefill_batch,
            max_queue=args.queue_limit)
    summary = run_loadgen(engine, requests)
    device_name = (torch.cuda.get_device_name(mesh.device)
                   if mesh.device.type == "cuda" else "cpu")
    fmt = lambda v: "-" if v is None else f"{v:.1f}"
    print(f"serve[llama tp{args.tp_size} on {device_name}]: "
          f"{summary['completed']}/{summary['requests']} requests "
          f"({summary['rejected']} rejected) in {summary['wall_s']:.1f}s — "
          f"{summary['tokens_per_sec']:.0f} tok/s, occupancy "
          f"{summary['slot_occupancy_mean']:.2f}, TTFT p50/p95 "
          f"{fmt(summary['ttft_ms_p50'])}/{fmt(summary['ttft_ms_p95'])}ms, "
          f"TPOT p50/p95 {fmt(summary['tpot_ms_p50'])}/"
          f"{fmt(summary['tpot_ms_p95'])}ms, queue p50/p95 "
          f"{fmt(summary['queue_wait_ms_p50'])}/"
          f"{fmt(summary['queue_wait_ms_p95'])}ms"
          + (f"; kv util {summary['kv_util_mean']:.2f}, prefix hits "
             f"{100 * summary['prefix_hit_rate']:.0f}%, "
             f"{summary['preemptions']} preempted, paged attn "
             f"{summary['paged_attn']}"
             if "kv_util_mean" in summary else ""), file=sys.stderr)
    rec = {
        "metric": (f"serving tokens/sec (llama, tp={args.tp_size}, "
                   + ("paged, " if args.paged else "")
                   + f"slots={args.slots}, {args.arrival} arrivals"
                   + (f" @{args.rate:g}/s" if args.arrival == "poisson"
                      else "") + ")"),
        "value": summary["tokens_per_sec"],
        "unit": "tokens/sec (serving)",
        **{k: summary[k] for k in (
            "requests", "completed", "rejected", "invalid", "wall_s",
            "slot_occupancy_mean", "ttft_ms_p50", "ttft_ms_p95",
            "tpot_ms_p50", "tpot_ms_p95", "queue_wait_ms_p50",
            "queue_wait_ms_p95", "prefill_pad_waste_eliminated")},
        "device": device_name,
    }
    for k in ("kv_dtype", "paged_attn", "cp", "pages_per_rank", "num_pages",
              "kv_util_mean", "kv_fragmentation_mean", "prefix_hit_rate",
              "cow_copies", "preemptions", "max_live",
              "max_interleaved_prefill_positions", "slo_attainment"):
        if k in summary:
            rec[k] = summary[k]
    print(json.dumps(rec))
    return {**summary, "device": device_name,
            "prefill_dispatches": engine.prefill_dispatches,
            "engine_stats": engine.stats(),
            "outputs": {r.rid: list(r.tokens) for r in engine.completed}}


def main(argv=None) -> dict:
    return serve(get_serve_args(argv))


if __name__ == "__main__":
    main()
