"""Offline serving benchmark CLI: loadgen -> continuous-batching engine.

    python -m distributed_pytorch_from_scratch_tpu_torch.serving.serve \\
        --model 45m --random_init --num_requests 16 --arrival burst

Drives the slot engine (serving/engine.py) with a synthetic Poisson or
burst arrival stream and prints ONE JSON record on stdout with the serving
metrics — TTFT / TPOT / queue-wait p50/p95, slot occupancy, tokens/s — and
the device that ran them. Runs on `cuda:0` unless `--device cpu` is given;
with no card and no `--device cpu` it exits non-zero.

Weights: `--random_init` (fresh random weights from `--seed`, the
checkpoint-free benchmark), or `--ckpt_dir` with a tp=1 checkpoint written
by the JAX package's trainer. `--dry_run` shrinks everything to a tiny
smoke run.

Not ported yet: tp > 1 and sampled decoding (temperature > 0) are refused
with a message; the JAX CLI's paged engine, speculative decoding, gpt2
family, int8 decode weights and observability/control flags do not exist
here yet (ROADMAP.md).
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
from .engine import ContinuousBatchingEngine
from .loadgen import run_loadgen, synthetic_requests

# head_dim 32, so the dry run also fits the CUDA kernel's head dims
_DRY_CFG = ModelConfig(attn_dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                       vocab_size=64, maxlen=64)


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
    g.add_argument("--tp_size", type=int, default=1,
                   help="tensor-parallel width (1 only, so far)")
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

    g = p.add_argument_group("loadgen")
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
    if args.tp_size != 1:
        p.error(f"--tp_size {args.tp_size}: tensor parallelism is not ported "
                f"yet (see ROADMAP)")
    if args.temperature > 0:
        p.error("--temperature > 0: sampled decoding is not ported yet (see "
                "ROADMAP)")
    if args.temperature < 0:
        p.error(f"--temperature must be >= 0, got {args.temperature}")
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
    summary plus `device`, `prefill_dispatches` and `outputs` ({rid:
    generated ids})."""
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
    else:
        cfg = build_model_config(args, vocab_size)
    model = _load_model(args, cfg, mesh.device)

    requests = synthetic_requests(
        args.num_requests, args.prompt_len_min, args.prompt_len_max,
        args.max_new_tokens, vocab_size, seed=args.seed, rate=args.rate,
        arrival=args.arrival)
    longest = max(len(r.prompt) for r in requests)
    buf_len = args.buf_len or (longest + args.max_new_tokens + 2)
    engine = ContinuousBatchingEngine(
        model, mesh, num_slots=args.slots, buf_len=buf_len, eos_id=eos_id,
        temperature=args.temperature, prefill_bucket=args.prefill_bucket,
        max_prefill_batch=args.max_prefill_batch, max_queue=args.queue_limit)
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
          f"{fmt(summary['queue_wait_ms_p95'])}ms", file=sys.stderr)
    rec = {
        "metric": (f"serving tokens/sec (llama, tp={args.tp_size}, "
                   f"slots={args.slots}, {args.arrival} arrivals"
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
    print(json.dumps(rec))
    return {**summary, "device": device_name,
            "prefill_dispatches": engine.prefill_dispatches,
            "outputs": {r.rid: list(r.tokens) for r in engine.completed}}


def main(argv=None) -> dict:
    return serve(get_serve_args(argv))


if __name__ == "__main__":
    main()
