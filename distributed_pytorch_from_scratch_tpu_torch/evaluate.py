"""Evaluation entry point — the port's counterpart of the JAX `evaluate.py`:
the validation loss of every checkpoint in a directory, then greedy
decoding of eight fixed prompts with the newest one (the source repo's
`test.py`, with its defects fixed as the JAX CLI fixes them).

    python -m distributed_pytorch_from_scratch_tpu_torch.evaluate \\
        --ckpt_dir ckpt --data_path tokens.json \\
        --tokenizer_path tokenizer/tokenizer.json --model 45m \\
        [--tp_size 2 --dist_backend gloo] [--dp_size 2] [--cp_size 2 ...]

Parses the JAX CLI's flags, plus `--device` (default `cuda`; with no card
it exits non-zero rather than run on the CPU — pass `--device cpu`),
`--dist_backend` (as train.py), `--tokenizer_backend` (`auto | hf |
native`, `data/tokenizer.load_tokenizer`) and `--summary_json` (a file for
the run's numbers: losses, decoded ids, times, kernel launches per rank).

* **The sweep.** Every checkpoint in `--ckpt_dir` (either package's npz
  shards, written at any tp its vocab divides), the validation split in
  batches of `--batch_size` padded to maxlen, a ragged final batch padded
  with IGNORE_INDEX rows. The loss is the mean of per-document means (the
  source repo's batch-size-1 semantics at any batch size), through the
  same vocab-parallel CE as training (`Transformer.doc_loss`: no (b, t, V)
  gather). `--dp_size M --cp_size C --tp_size N` run M·C·N ranks, one
  process each (`runtime/launch.spawn`): dp shards the batch rows, cp the
  sequence (ring or Ulysses, contiguous or zig-zag; the ring launches the
  block kernels), tp the weights.
* **Decoding.** The newest checkpoint decodes the prompts through the
  slot engine (`ContinuousBatchingEngine` + `decode_prompts`), its decode
  step a CUDA graph on a card at tp = 1 and broadcast by rank 0 on more
  than one rank (`serving/tp_dispatch.py`); `--no_kv_cache` instead runs
  the full forward over a buffer padded with EOS once per token (the
  source repo's decoder), eager. At cp > 1 with the contiguous layout the
  KV decoder is the paged engine with its pages sharded over cp
  (`PagedEngine`: each cp rank holds 1/cp of them), as JAX's; the zig-zag
  layout and `--no_kv_cache` decode on the cp = 1 path, as in JAX. Every
  rank follows rank 0's dispatches: the dp replicas (and, on the cp = 1
  path, the cp ones) decode the same prompts.
* **Output.** Global rank 0 alone prints and writes: `val/val.txt` and
  the `val/loss` scalars (`training/metrics.MetricsWriter`) under
  `--ckpt_dir`.

`--family gpt2` evaluates the GPT-2 family (`models/gpt2.py`) the same
way; its decode buffer is clamped to the learned position table (the JAX
CLI's warning, and its refusal when the prompts do not fit).
`--temperature > 0` (with `--decode_top_k` / `--decode_top_p`) samples
through the slot engine, prompt i drawing from seed `--random_seed` + i.

A MoE model (`--model 45m-moe8`, or `--num_experts`) runs the sweep and
the KV decoder at ep = 1 (every rank holds every expert) and any dp and
tp, and at `--cp_size > 1`. Refused with NotImplementedError, naming the
ROADMAP item: the multi-host flags (item 2). The JAX CLI's own refusals
stay, with its messages. Not ported: the JAX CLI's span tracer (`val/trace.json`,
ROADMAP item 8).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .cli import add_model_shape_args, build_model_config
from .config import (BOS_TOKEN, EOS_TOKEN, IGNORE_INDEX, MeshConfig,
                     ModelConfig, model_preset)
from .data.dataset import dp_rows, get_dataloader
from .data.tokenizer import BACKENDS, load_tokenizer
from .models.decode import _full_vocab_logits
from .models import build_model
from .models.transformer import Transformer, validate_cp, validate_tp
from .ops.collectives import all_gather
from .ops.cuda import launch_counts
from .runtime import launch
from .runtime.mesh import dist_backend, make_mesh, resolve_device
from .serving.engine import (ContinuousBatchingEngine, PagedEngine,
                             decode_prompts, graph_stats)
from .training.checkpoint import list_checkpoints, load_checkpoint
from .training.metrics import MetricsWriter

# The source repo's eight fixed decode prompts (its `test.py`).
DECODE_PROMPTS = [
    "Nice to meet you, it's",
    "Great empire never falls, it only",
    "Your majesty, it's my duty ",
    "I shall be glad ",
    "What a glory to ",
    "Shame for the weak, it's",
    "The brave man ne",
    "Poor old man, it's",
]

_MULTI = "ROADMAP Queue 1 item 2: the multi-host flags"


def get_eval_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    g = p.add_argument_group("distributed")
    g.add_argument("--tp_size", type=int, default=1)
    g.add_argument("--dp_size", type=int, default=1,
                   help="shard validation batches over the dp ranks "
                        "(ragged final batches are padded with IGNORE_INDEX "
                        "rows, which the per-document means drop exactly)")
    g.add_argument("--cp_size", type=int, default=1,
                   help="context-parallel ranks: the validation forward "
                        "shards the sequence over cp (ring or Ulysses); "
                        "KV decoding with the contiguous layout runs the "
                        "paged engine with its pages sharded over cp; "
                        "the zig-zag layout and --no_kv_cache decode on "
                        "the cp=1 path")
    g.add_argument("--cp_layout", choices=["contiguous", "zigzag"],
                   default="contiguous",
                   help="sequence layout over the cp ring (see train.py)")
    g.add_argument("--cp_impl", choices=["ring", "ulysses"], default="ring",
                   help="attention schedule for the cp-sharded validation "
                        "forward")
    g.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    g.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="the process groups' transport (default: nccl on "
                        "cuda, gloo on cpu); nccl needs one card per rank")

    g = p.add_argument_group("data")
    g.add_argument("--data_path", "-d", required=True)
    g.add_argument("--tokenizer_path", "-t", required=True)
    g.add_argument("--tokenizer_backend", choices=list(BACKENDS),
                   default="auto",
                   help="'hf' (the tokenizers library), 'native' (the C++ "
                        "BPE + a byte-level decode in Python), or 'auto': "
                        "native when it builds and passes its check")

    g = p.add_argument_group("model")
    g.add_argument("--family", choices=["llama", "gpt2"], default="llama",
                   help="must match the trained model family; both decode "
                        "via the KV-cache decoder (gpt2's buffer is capped "
                        "at its learned position table)")
    g.add_argument("--ckpt_dir", required=True)
    add_model_shape_args(g)

    g = p.add_argument_group("decode")
    g.add_argument("--max_decode_len", type=int, default=128)
    g.add_argument("--no_kv_cache", action="store_true",
                   help="decode by the full forward over the whole buffer "
                        "once per token (the source repo's decoder) "
                        "instead of the slot engine's KV cache")
    g.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy argmax; > 0 samples (KV decoder only), "
                        "prompt i seeded by --random_seed + i")
    g.add_argument("--decode_top_k", type=int, default=0)
    g.add_argument("--decode_top_p", type=float, default=0.0)

    g = p.add_argument_group("other")
    g.add_argument("--random_seed", type=int, default=0)
    g.add_argument("--coordinator", type=str, default=None)
    g.add_argument("--num_processes", type=int, default=None)
    g.add_argument("--process_id", type=int, default=None)
    g.add_argument("--batch_size", type=int, default=8,
                   help="validation batch size (the reported loss is the "
                        "mean of per-document means: batch-size "
                        "independent)")
    g.add_argument("--summary_json", default=None,
                   help="also write the run's numbers to this JSON file")
    args = p.parse_args(argv)
    if args.temperature and args.no_kv_cache:
        p.error("--temperature requires the KV-cache decoder "
                "(drop --no_kv_cache)")
    if (args.decode_top_k or args.decode_top_p) and not args.temperature:
        p.error("--decode_top_k/--decode_top_p only shape SAMPLED decoding; "
                "set --temperature > 0 (greedy ignores them)")
    if not 0.0 <= args.decode_top_p <= 1.0:
        p.error(f"--decode_top_p must be in [0, 1], got "
                f"{args.decode_top_p}")
    return args


def refuse_unported(args: argparse.Namespace) -> None:
    """NotImplementedError for a flag this port cannot run yet, naming its
    ROADMAP item."""
    for dest, item in (("coordinator", _MULTI), ("num_processes", _MULTI),
                       ("process_id", _MULTI)):
        if getattr(args, dest) is not None:
            raise NotImplementedError(
                f"--{dest} {getattr(args, dest)}: not ported yet, see {item}")


def _pad_batch(batch, rows: int):
    """A ragged final batch (drop_last=False) padded up to `rows` rows, so
    its leading dim still divides over the dp ranks. Padding rows carry
    IGNORE_INDEX targets: they count zero documents."""
    have = batch["input_ids"].shape[0]
    if have == rows:
        return batch
    pad = rows - have
    return {
        "input_ids": np.concatenate(
            [batch["input_ids"],
             np.zeros((pad, batch["input_ids"].shape[1]), np.int32)]),
        "target_ids": np.concatenate(
            [batch["target_ids"],
             np.full((pad, batch["target_ids"].shape[1]), IGNORE_INDEX,
                     np.int32)]),
        "position_ids": np.concatenate(
            [batch["position_ids"],
             np.tile(batch["position_ids"][:1], (pad, 1))]),
    }


def calc_val_loss(model: Transformer, mesh, dataloader,
                  batch_rows: int) -> Tuple[float, int]:
    """(mean of per-document CE means, batches swept). Each rank takes its
    dp rows and cp chunk of every batch; the per-document means come back
    over the dp ranks in row order, and the sum runs on the host as the
    JAX `calc_val_loss` does."""
    total, docs, batches = 0.0, 0, 0
    for batch in dataloader.epoch(0):
        batch = _pad_batch(batch, batch_rows)
        rows = [dp_rows(batch[k], mesh.dp, mesh.dp_rank)
                for k in ("input_ids", "target_ids", "position_ids")]
        ids, tgt, pos = (torch.from_numpy(np.ascontiguousarray(x))
                         .to(mesh.device).long()
                         for x in model.cp_shard(*rows))
        means, real = model.doc_loss(ids, tgt, pos)
        both = torch.stack([means, real.float()])
        if mesh.dp > 1:         # (dp, 2, b/dp) -> (2, b) in row order
            both = torch.cat(all_gather(both, mesh, "dp").unbind(0), dim=1)
        means, real = both.cpu().numpy()
        real = real > 0
        total += float(means[real].sum())
        docs += int(real.sum())
        batches += 1
    return total / max(docs, 1), batches


@torch.no_grad()
def _argmax_at(model: Transformer, buf: np.ndarray, cur: int) -> int:
    """The step of the JAX `make_greedy_decoder`: the greedy next token
    after `cur` positions of `buf`, by the full forward over the whole
    (1, buf_len) buffer, the logits at position cur - 1 over the real
    vocab (tp shards gathered), their argmax."""
    dev = model.embedding.weight.device
    ids = torch.from_numpy(buf).to(dev).long()
    pos = torch.arange(buf.shape[1], device=dev)[None, :]
    logits = model.forward(ids, pos)[:, cur - 1]
    return int(_full_vocab_logits(model, logits)[0].argmax())


def greedy_decode(model: Transformer, mesh, tokenizer, prompts: List[str],
                  bos_id: int, eos_id: int, max_decode_len: int = 128,
                  use_kv_cache: bool = True,
                  stats: Optional[dict] = None, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 0.0, seed: int = 0
                  ) -> Optional[List[Tuple[str, str]]]:
    """(prompt, completion) pairs, the JAX `greedy_decode`'s. The buffer of
    a model with learned positions (gpt2) is clamped to its table, with
    the JAX warning, or refused when the prompts do not fit. At
    `temperature > 0` the KV path samples, prompt i from seed `seed` + i.
    The KV path decodes through the slot engine, or at a model's cp_size >
    1 through the paged engine over its cp-sharded pages (JAX's choice):
    rank 0 drives it and returns the pairs, the other ranks serve its
    dispatches and return None. The full-recompute path runs on every tp
    rank in lockstep (the gathered logits agree) and returns the pairs
    everywhere. `stats`, when given, receives the generated ids, the
    prefill dispatches or full forwards run and the decode's wall
    time."""
    texts = [t.strip() for t in prompts]
    encoded = {t: tokenizer.encode(t) for t in texts}
    # one buffer for every prompt; room for BOS and at least one new token
    buf_len = max(max_decode_len + 1,
                  max(len(i) for i in encoded.values()) + 2)
    # learned positions (gpt2) cap the buffer at the table: positions past
    # it would clip to its last row and degrade the generations
    cap = getattr(model, "max_decode_positions", None)
    if cap is not None and buf_len > cap:
        longest = max(len(i) for i in encoded.values())
        if cap < longest + 2:
            raise SystemExit(
                f"prompts need {longest + 2} positions but the model's "
                f"learned position table has only {cap}")
        if mesh.rank == 0:
            print(f"Warning: clamping decode buffer {buf_len} -> {cap} "
                  f"(learned position table size); reduce --max_decode_len "
                  f"to silence")
        buf_len = cap
    stats = {} if stats is None else stats
    t0 = time.perf_counter()
    if use_kv_cache:
        prompt_ids = [[bos_id] + encoded[t] for t in texts]
        engine_cls = (PagedEngine if getattr(model, "cp_size", 1) > 1
                      else ContinuousBatchingEngine)
        engine = engine_cls(
            model, mesh, num_slots=min(len(prompt_ids), 8), buf_len=buf_len,
            eos_id=eos_id, temperature=temperature, top_k=top_k,
            top_p=top_p)
        if not engine.dispatch.leader:
            engine.dispatch.serve()
            stats["decode_s"] = time.perf_counter() - t0
            return None
        # the same TOTAL-length budget as the full-recompute path's
        gens = decode_prompts(
            engine, prompt_ids,
            [max(0, max_decode_len + 1 - len(pr)) for pr in prompt_ids],
            base_seed=seed)
        engine.dispatch.stop()
        stats.update(prefill_dispatches=engine.prefill_dispatches,
                     decode_steps=engine.decode_steps,
                     decode_graph=graph_stats(engine)["decode_graph"])
    else:
        gens, forwards = [], 0
        for text in texts:
            ids = encoded[text]
            buf = np.full((1, buf_len), eos_id, dtype=np.int32)
            buf[0, 0] = bos_id
            buf[0, 1:len(ids) + 1] = ids
            cur = len(ids) + 1
            # stop when the total length (BOS included) passes
            # max_decode_len, as the source repo's loop does, or the
            # buffer fills
            while cur < buf_len and cur <= max_decode_len:
                nxt = _argmax_at(model, buf, cur)
                forwards += 1
                if nxt == eos_id:
                    break
                buf[0, cur] = nxt
                cur += 1
            gens.append(buf[0, len(ids) + 1:cur].tolist())
        stats["forwards"] = forwards
    stats["decode_s"] = time.perf_counter() - t0
    stats["generated_ids"] = [list(map(int, g)) for g in gens]
    stats["prompt_ids"] = [encoded[t] for t in texts]

    decoded_texts = [tokenizer.decode(encoded[t] + gen).strip()
                     for t, gen in zip(texts, gens)]
    out = []
    for text, decoded in zip(texts, decoded_texts):
        # the decode must extend the prompt; a tokenizer that cannot
        # round-trip a prompt byte splits on the round-tripped prompt
        roundtrip = tokenizer.decode(encoded[text]).strip()
        if text in decoded:
            out.append((text, decoded[len(text):]))
        elif roundtrip and roundtrip in decoded:
            print(f"Warning: tokenizer cannot round-trip prompt {text!r} "
                  f"(becomes {roundtrip!r}); splitting on the round-trip")
            out.append((text,
                        decoded[decoded.index(roundtrip) + len(roundtrip):]))
        else:
            raise AssertionError(
                f"decode must extend the prompt: {text!r} not in {decoded!r}")
    return out


def _world(args: argparse.Namespace) -> int:
    return args.dp_size * args.cp_size * args.tp_size


def _check(args: argparse.Namespace) -> int:
    """The JAX CLI's checks and this port's refusals, before any rank
    starts; returns maxlen."""
    refuse_unported(args)
    preset = model_preset(args.model) if args.model else ModelConfig()
    maxlen = preset.maxlen if args.maxlen is None else args.maxlen
    if args.batch_size % args.dp_size != 0:
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible "
                         f"by --dp_size {args.dp_size}")
    if maxlen % args.cp_size != 0:
        raise SystemExit(f"--maxlen {maxlen} must be divisible by "
                         f"--cp_size {args.cp_size}")
    if args.cp_layout == "zigzag" and maxlen % (2 * args.cp_size):
        raise SystemExit(f"--cp_layout zigzag needs --maxlen {maxlen} "
                         f"divisible by 2*cp ({2 * args.cp_size})")
    if args.cp_size > 1 and args.cp_impl == "ulysses" \
            and not args.no_kv_cache:
        raise SystemExit(
            f"--cp_impl ulysses has no KV-decode path (cp decoding is "
            f"ring-only: cp serving rings the prefill queries over "
            f"cp-local pages). "
            f"A ulysses-trained checkpoint is layout-identical to a ring "
            f"one — cp_impl only changes the attention schedule — so rerun "
            f"with --cp_impl ring, or --no_kv_cache, or --cp_size 1 (got "
            f"--cp_size {args.cp_size})")
    return maxlen


def evaluate(args: argparse.Namespace) -> dict:
    """Sweep and decode; returns global rank 0's summary: `val_losses`
    ({iter: loss}), `decoded` ((prompt, completion) pairs), and
    `tokenizer_backend`, `prompt_ids`, `generated_ids`, `sweep_s` and
    `sweep_tokens` ({iter: ...}: the sweep's wall and the padded
    positions it ran), `decode_s`, `prefill_dispatches` (KV) or
    `forwards` (full recompute), `device`, and `ranks`: per rank its
    coordinates and kernel launches."""
    maxlen = _check(args)
    if _world(args) == 1:
        return _evaluate(args, maxlen)
    try:
        dist_backend(args.dist_backend, resolve_device(args.device),
                     _world(args))
        cfg = build_model_config(args, ModelConfig().vocab_size)
        validate_tp(cfg, args.tp_size)
        validate_cp(cfg, args.tp_size, args.cp_size, args.cp_impl,
                    args.cp_layout)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"evaluate: {e}")
    outs = launch.spawn(_rank_main, _world(args), args, maxlen)
    return dict(outs[0], ranks=[o["ranks"][0] for o in outs])


def _rank_main(rank: int, nprocs: int, init_method: str,
               args: argparse.Namespace, maxlen: int) -> dict:
    """One rank of a run of more than one (`runtime/launch.spawn`)."""
    return _evaluate(args, maxlen, rank, init_method)


def _evaluate(args: argparse.Namespace, maxlen: int, rank: int = 0,
              init_method: str = None) -> dict:
    """The sweep and the decode on one rank; see `evaluate`."""
    try:
        mesh = make_mesh(MeshConfig(dp=args.dp_size, cp=args.cp_size,
                                    tp=args.tp_size),
                         device=args.device, rank=rank,
                         backend=args.dist_backend, init_method=init_method)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"evaluate: {e}")
    is_main = mesh.rank == 0
    say = print if is_main else (lambda *a, **k: None)
    dataloader = get_dataloader(args.data_path, args.batch_size, IGNORE_INDEX,
                                split="validation", maxlen=maxlen,
                                shuffle=False, drop_last=False)
    ds = dataloader.dataset
    cfg = build_model_config(args, ds.vocab_size)
    model_val = build_model(args.family, cfg, cp_size=args.cp_size,
                            cp_impl=args.cp_impl, cp_layout=args.cp_layout,
                            mesh=mesh)
    model_val.to(mesh.device)
    # KV decoding with the contiguous layout runs the cp-sharded paged
    # engine on the sweep's model; the zig-zag layout and the
    # full-recompute path decode on the cp = 1 path, as JAX's
    dec_cp = (args.cp_size if args.cp_layout == "contiguous"
              and not args.no_kv_cache else 1)
    model = (model_val if dec_cp == args.cp_size else
             build_model(args.family, cfg, mesh=mesh).to(mesh.device))
    ckpts = list_checkpoints(args.ckpt_dir, rank=0)
    if not ckpts:
        raise SystemExit(f"no checkpoints found in {args.ckpt_dir}")
    say(f"found {len(ckpts)} checkpoints")

    launches0 = launch_counts()
    writer = (MetricsWriter(os.path.join(args.ckpt_dir, "val"),
                            process_index=0) if is_main else None)
    report_path = os.path.join(args.ckpt_dir, "val", "val.txt")
    results, sweep_s, sweep_tokens = {}, {}, {}
    stats: dict = {}
    try:
        with open(report_path if is_main else os.devnull, "a") as f:
            f.write("Ckpt -> Validation loss\n")
            for it, path in ckpts:
                state, _, _ = load_checkpoint(args.ckpt_dir, it,
                                              tp_size=mesh.tp,
                                              tp_rank=mesh.tp_rank)
                model_val.load_state_dict(state)
                if model is not model_val:
                    model.load_state_dict(state)
                t0 = time.perf_counter()
                avg, batches = calc_val_loss(model_val, mesh, dataloader,
                                             args.batch_size)
                sweep_s[it] = time.perf_counter() - t0
                sweep_tokens[it] = batches * args.batch_size * maxlen
                say(f"iter {it}: val loss {avg:.4f}")
                if is_main:
                    f.write(f"{path} -> {avg:.4f}\n")
                    writer.scalar("val/loss", avg, it)
                results[it] = avg

        # the model now holds the NEWEST checkpoint
        tokenizer = load_tokenizer(args.tokenizer_path,
                                   args.tokenizer_backend, verbose=is_main)
        bos_id, eos_id = ds.bos, ds.eos
        if (tokenizer.token_to_id(BOS_TOKEN) != bos_id
                or tokenizer.token_to_id(EOS_TOKEN) != eos_id):
            raise SystemExit(
                f"the tokenizer's {BOS_TOKEN}/{EOS_TOKEN} ids "
                f"{tokenizer.token_to_id(BOS_TOKEN)}/"
                f"{tokenizer.token_to_id(EOS_TOKEN)} differ from the data's "
                f"{bos_id}/{eos_id}")
        decoded = greedy_decode(model, mesh, tokenizer, DECODE_PROMPTS,
                                bos_id, eos_id, args.max_decode_len,
                                use_kv_cache=not args.no_kv_cache,
                                stats=stats, temperature=args.temperature,
                                top_k=args.decode_top_k,
                                top_p=args.decode_top_p,
                                seed=args.random_seed)
        with open(report_path if is_main else os.devnull, "a") as f:
            f.write("\n\nInput texts -> Decoded texts\n")
            for prompt, completion in decoded or []:
                say(f"{prompt} -> {completion}")
                f.write(f"{prompt} -> {completion}\n")
    finally:
        if writer is not None:
            writer.close()
    now = launch_counts()
    summary = {
        "val_losses": results, "decoded": decoded,
        "tokenizer_backend": tokenizer.backend,
        "sweep_s": sweep_s, "sweep_tokens": sweep_tokens,
        "device": (torch.cuda.get_device_name(mesh.device)
                   if mesh.device.type == "cuda" else "cpu"),
        **stats,
        "ranks": [{"rank": mesh.rank, **mesh.coords,
                   "launches": {k: v - launches0[k]
                                for k, v in now.items()}}],
    }
    return summary


def main(argv=None) -> dict:
    args = get_eval_args(argv)
    out = evaluate(args)
    if args.summary_json:
        with open(args.summary_json, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
