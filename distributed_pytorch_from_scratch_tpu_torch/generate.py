"""Generation entry point: prompts in, text out — the port's counterpart of
the JAX `generate.py`.

    python -m distributed_pytorch_from_scratch_tpu_torch.generate \\
        --ckpt_dir ckpt --tokenizer_path tokenizer/tokenizer.json \\
        --model 45m --prompt "Once upon a time" [--prompt ...] \\
        [--tp_size 2 --dist_backend gloo]

Loads the newest checkpoint in `--ckpt_dir` (or `--iter`; either
package's npz shards, written at any tp its vocab divides) and decodes
every `--prompt` through the slot engine (`ContinuousBatchingEngine` +
`decode_prompts`, either `--family`): greedily, or at `--temperature > 0`
sampled (`--decode_top_k`, `--decode_top_p`), prompt i drawing from seed
`--seed` + i. A gpt2 buffer is clamped to its learned position table. On a
card at tp = 1 the decode step is a CUDA graph; at `--tp_size N` one
process per tp rank (`runtime/launch.spawn`), rank 0 drives the engine
and broadcasts each dispatch (`serving/tp_dispatch.py`). At `--cp_size C`
(times `--tp_size`, one process per rank) the prompts decode through the
paged engine with its pages sharded over the cp ranks (`PagedEngine`), as
JAX's CLI does: its greedy tokens are cp = 1's. The tokenizer is
`data/tokenizer.load_tokenizer` (`--tokenizer_backend auto | hf |
native`). Runs on the card unless `--device cpu` is given; with no card it
exits non-zero.

A MoE model (`--model 45m-moe8`, or `--num_experts`) decodes through the
slot engine at ep = 1 (every rank holds every expert) and any tp; at
`--cp_size > 1` it is refused with NotImplementedError naming ROADMAP
Queue 1 item 7, as evaluate.py refuses it. The JAX CLI's ulysses refusal
stays, with its message.
"""

from __future__ import annotations

import argparse

from .cli import add_model_shape_args, build_model_config
from .config import BOS_TOKEN, EOS_TOKEN, MeshConfig
from .data.tokenizer import BACKENDS, load_tokenizer
from .models import build_model
from .models.transformer import validate_tp
from .runtime import launch
from .runtime.mesh import dist_backend, make_mesh, resolve_device
from .serving.engine import (ContinuousBatchingEngine, PagedEngine,
                             decode_prompts)
from .training.checkpoint import latest_step, load_checkpoint


def get_generate_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--tokenizer_path", "-t", required=True)
    p.add_argument("--tokenizer_backend", choices=list(BACKENDS),
                   default="auto")
    p.add_argument("--prompt", action="append", required=True,
                   help="repeatable; the prompts decode together")
    p.add_argument("--iter", type=int, default=None,
                   help="checkpoint iteration (default: latest)")
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--tp_size", type=int, default=1)
    p.add_argument("--cp_size", type=int, default=1,
                   help="context-parallel ranks, one process each: the "
                        "prompts decode through the paged engine with its "
                        "pages sharded over cp")
    p.add_argument("--cp_impl", choices=["ring", "ulysses"], default="ring")
    p.add_argument("--family", choices=["llama", "gpt2"], default="llama")
    add_model_shape_args(p.add_argument_group("model shape"))
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; > 0 samples softmax(logits/T)")
    p.add_argument("--decode_top_k", type=int, default=0)
    p.add_argument("--decode_top_p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prefill_bucket", type=int, default=64,
                   help="slot-engine prefill width bucket: each prompt "
                        "prefills over a buffer padded to a multiple of "
                        "this (identical tokens); 0 pads to the full buffer")
    p.add_argument("--slots", type=int, default=8,
                   help="KV slots (concurrent decodes; the paged engine's "
                        "at --cp_size > 1); prompts beyond this queue FIFO")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="--tp_size > 1: the ranks' transport (default: "
                        "nccl on cuda, gloo on cpu)")
    args = p.parse_args(argv)
    if (args.decode_top_k or args.decode_top_p) and not args.temperature:
        p.error("--decode_top_k/--decode_top_p need --temperature > 0")
    if not 0.0 <= args.decode_top_p <= 1.0:
        p.error(f"--decode_top_p must be in [0, 1], got {args.decode_top_p}")
    return args


def _refuse(args: argparse.Namespace) -> None:
    if args.cp_size > 1 and args.cp_impl == "ulysses":
        raise SystemExit(
            f"--cp_impl ulysses has no decode path (cp decoding is "
            f"ring-only: cp serving rings the prefill queries over "
            f"cp-local pages). A "
            f"ulysses-trained checkpoint is layout-identical to a ring one "
            f"— cp_impl only changes the attention schedule, not the "
            f"weights — so rerun with --cp_impl ring or --cp_size 1 (got "
            f"--cp_size {args.cp_size})")


def generate(args: argparse.Namespace) -> list:
    """The decoded texts (prompt + completion, stripped), in prompt
    order."""
    _refuse(args)
    world = args.tp_size * args.cp_size
    if world == 1:
        return _generate(args)
    try:
        dist_backend(args.dist_backend, resolve_device(args.device), world)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"generate: {e}")
    return launch.spawn(_rank_main, world, args)[0]


def _rank_main(rank: int, nprocs: int, init_method: str,
               args: argparse.Namespace) -> list:
    """One rank (`runtime/launch.spawn`)."""
    return _generate(args, rank, init_method)


def _generate(args: argparse.Namespace, rank: int = 0,
              init_method: str = None) -> list:
    try:
        mesh = make_mesh(MeshConfig(tp=args.tp_size, cp=args.cp_size),
                         device=args.device,
                         rank=rank, backend=args.dist_backend,
                         init_method=init_method)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"generate: {e}")
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    tokenizer = load_tokenizer(args.tokenizer_path, args.tokenizer_backend,
                               verbose=mesh.rank == 0)
    bos_id = tokenizer.token_to_id(BOS_TOKEN)
    eos_id = tokenizer.token_to_id(EOS_TOKEN)
    if bos_id is None or eos_id is None:
        raise SystemExit(f"tokenizer {args.tokenizer_path} lacks the "
                         f"{BOS_TOKEN}/{EOS_TOKEN} specials")
    cfg = build_model_config(args, tokenizer.get_vocab_size())
    try:
        validate_tp(cfg, args.tp_size)
    except ValueError as e:
        raise SystemExit(f"generate: {e}")
    step = args.iter if args.iter is not None else latest_step(args.ckpt_dir)
    if step is None:
        raise SystemExit(f"no checkpoints found in {args.ckpt_dir}")
    model = build_model(args.family, cfg, cp_size=args.cp_size, mesh=mesh)
    state, _, _ = load_checkpoint(args.ckpt_dir, step, tp_size=mesh.tp,
                                  tp_rank=mesh.tp_rank)
    model.load_state_dict(state)
    model.to(mesh.device)
    say(f"loaded checkpoint iter {step} from {args.ckpt_dir}")

    encoded = [tokenizer.encode(t) for t in args.prompt]
    longest = max(len(e) for e in encoded)
    buf_len = longest + args.max_new_tokens + 2
    cap = getattr(model, "max_decode_positions", None)
    if cap is not None:
        buf_len = min(buf_len, cap)
        if buf_len < longest + 2:
            raise SystemExit(f"prompt needs {longest + 2} positions but the "
                             f"model's position table has {cap}")
    prompts = [[bos_id] + e for e in encoded]
    if args.cp_size > 1:
        # the long-context path: the paged engine's cp-sharded page pool
        engine = PagedEngine(
            model, mesh, num_slots=min(len(prompts), args.slots),
            buf_len=buf_len, eos_id=eos_id, temperature=args.temperature,
            top_k=args.decode_top_k, top_p=args.decode_top_p)
    else:
        engine = ContinuousBatchingEngine(
            model, mesh, num_slots=min(len(prompts), args.slots),
            buf_len=buf_len, eos_id=eos_id, temperature=args.temperature,
            top_k=args.decode_top_k, top_p=args.decode_top_p,
            prefill_bucket=args.prefill_bucket)
    if not engine.dispatch.leader:
        engine.dispatch.serve()
        return []
    gens = decode_prompts(engine, prompts, args.max_new_tokens,
                          base_seed=args.seed)
    engine.dispatch.stop()
    waste = engine.stats().get("prefill_pad_waste_eliminated", 0)
    if waste > 0:
        say(f"prefill pad waste eliminated by length bucketing: "
            f"{100 * waste:.0f}% ({engine.prefill_positions} bucketed "
            f"positions vs {engine.prefill_positions_monolithic} at the "
            f"full-buffer padding)")
    outs = []
    for text, ids, gen in zip(args.prompt, encoded, gens):
        full = tokenizer.decode(ids + gen).strip()
        outs.append(full)
        say(f"{text!r} -> {full!r}")
    return outs


def main(argv=None) -> list:
    return generate(get_generate_args(argv))


if __name__ == "__main__":
    main()
