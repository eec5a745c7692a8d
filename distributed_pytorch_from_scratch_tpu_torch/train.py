"""Training entry point — the port's counterpart of the JAX `train.py`.

    python -m distributed_pytorch_from_scratch_tpu_torch.train \\
        --model 45m --bf16 --data_path tokens.json --save_dir ckpt \\
        [--cp_size 2 [--cp_impl ring|ulysses] [--cp_layout contiguous|zigzag]]

Parses the same flags as the JAX CLI, plus two of its own: `--device`
(default `cuda`; with no card the CLI exits non-zero rather than run on the
CPU — pass `--device cpu` for the plain PyTorch path) and `--dist_backend`
(the cp group's transport: nccl, the default on a card, needs one card per
rank and is refused with fewer; gloo runs anywhere, a card's tensors staged
through host memory). The loop: epochs over the seeded data loader,
host-to-device copy, one train step (forward, backward through the
attention kernels, Adam/OneCycle in place), a log line every
`--log_interval` steps (the one host sync of the interval), a checkpoint
every `--save_interval` steps and at the end, in the JAX npz format, and
`--resume` from the newest checkpoint in `--save_dir` (either package's).

Context parallelism (`--cp_size N > 1`): N ranks, one process each
(`runtime/launch.spawn`), rank r on card r % device_count. Every rank draws
the same seeded batch and takes its chunk of the sequence (zig-zag order
first under `--cp_layout zigzag`); attention is the ring (the block kernels)
or Ulysses (the flash kernels) over the group. Rank 0 alone prints and
writes checkpoints (the ranks meet at a barrier around each save; every
rank loads on `--resume`); parameters are replicated, so a cp checkpoint is
the tp=1 file. A rank that fails fails the run.

A flag that takes the run off the ported slices (tp/dp/ep/pp > 1, sequence
parallelism, tp overlap, ZeRO, the bucketed dp reducer, MoE, the gpt2
family, `--remat dots|auto`, `--seq_bucket`, `--steps_per_dispatch > 1`,
the observability/control and multi-host flags) raises NotImplementedError
at any non-default value, naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict, Iterator, List

import numpy as np
import torch
import torch.distributed as dist

from .config import (IGNORE_INDEX, MODEL_PRESETS, MeshConfig, ModelConfig,
                     OptimizerConfig, model_preset)
from .data.dataset import get_dataloader
from .models.transformer import Transformer, validate_cp
from .ops import collectives
from .ops.cuda import launch_counts
from .runtime import launch
from .runtime.mesh import cp_backend, make_mesh, resolve_device
from .training.checkpoint import latest_step, load_checkpoint, save_checkpoint
from .training.metrics import device_peak_flops, model_flops_per_step
from .training.optim import AdamState, init_adam_state, schedule_lr
from .training.train_step import build_grad_accum_step, build_train_step

REMAT_CHOICES = {"true": True, "false": False}

_MULTI = "ROADMAP Queue 1 (b): tp>1 and the dp axis through torch.distributed"
_LATER = "ROADMAP Queue 1 (d): pipeline, MoE, perf layers"
_OBS = "ROADMAP Queue 1 item 5: the obs hooks of train.py"
_LEFT = "ROADMAP Queue 1 (a): left out of the training slice"
# (flag dest, default, the ROADMAP item that brings it)
OFF_SLICE = [
    ("tp_size", 1, _MULTI), ("dp_size", 1, _MULTI),
    ("sequence_parallel", False, _MULTI), ("zero", None, _LATER),
    ("zero1", False, _LATER), ("dp_reduce_bucket_mb", 0.0, _LATER),
    ("dp_reduce_dtype", "f32", _LATER), ("tp_overlap", "off", _LATER),
    ("ep_size", 1, _LATER),
    ("pp_size", 1, _LATER), ("pp_microbatches", 0, _LATER),
    ("pp_remat_steps", False, _LATER), ("pp_schedule", "gpipe", _LATER),
    ("pp_virtual", 2, _LATER), ("num_experts", None, _LATER),
    ("moe_top_k", None, _LATER), ("moe_capacity_factor", None, _LATER),
    ("family", "llama", "ROADMAP Queue 1 item 5: the gpt2 family"),
    ("seq_bucket", 0, _LEFT),
    ("steps_per_dispatch", 1, _LEFT + " (CUDA graphs)"),
    ("no_trace", False, _OBS), ("no_sentinel", False, _OBS),
    ("sentinel_spike_factor", 3.0, _OBS), ("watchdog_secs", 300.0, _OBS),
    ("flight_ring", 256, _OBS), ("metrics_port", None, _OBS),
    ("rollup_interval", 5.0, _OBS), ("profile_on_anomaly", 0, _OBS),
    ("profile_every", 0, _OBS), ("profile_window", 4, _OBS),
    ("profile_budget_mb", 64.0, _OBS), ("control", "off", _OBS),
    ("profile_steps", 0, _OBS), ("debug_nans", False, _OBS),
    ("coordinator", None, _MULTI), ("num_processes", None, _MULTI),
    ("process_id", None, _MULTI),
]


def get_train_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)

    g = p.add_argument_group("distributed (cp through torch.distributed; "
                             "the other axes at 1 in this port so far)")
    g.add_argument("--tp_size", type=int, default=1)
    g.add_argument("--dp_size", type=int, default=1)
    g.add_argument("--cp_size", type=int, default=1)
    g.add_argument("--cp_impl", choices=["ring", "ulysses"], default="ring")
    g.add_argument("--cp_layout", choices=["contiguous", "zigzag"],
                   default="contiguous")
    g.add_argument("--sequence_parallel", action="store_true")
    g.add_argument("--tp_overlap", choices=["off", "ring", "ring_q"],
                   default="off")
    g.add_argument("--zero", type=int, choices=[0, 1, 2, 3], default=None)
    g.add_argument("--zero1", action="store_true")
    g.add_argument("--dp_reduce_bucket_mb", type=float, default=0.0)
    g.add_argument("--dp_reduce_dtype", choices=["f32", "bf16", "int8"],
                   default="f32")
    g.add_argument("--ep_size", type=int, default=1)
    g.add_argument("--pp_size", type=int, default=1)
    g.add_argument("--pp_microbatches", type=int, default=0)
    g.add_argument("--pp_remat_steps", action="store_true")
    g.add_argument("--pp_schedule", choices=["gpipe", "interleaved"],
                   default="gpipe")
    g.add_argument("--pp_virtual", type=int, default=2)

    g = p.add_argument_group("training")
    g.add_argument("--lr", type=float, default=3e-4)
    g.add_argument("--clip_grad_norm", type=float, default=None,
                   help="global-norm gradient clipping (torch "
                        "clip_grad_norm_ semantics); off by default")
    g.add_argument("--warmup_steps", type=int, default=2000)
    g.add_argument("--weight_decay", type=float, default=0.0,
                   help="decoupled weight decay (AdamW); 0 = plain Adam")
    g.add_argument("--lr_schedule", choices=["onecycle", "cosine"],
                   default="onecycle",
                   help="'onecycle' = torch OneCycleLR incl. beta1 cycling; "
                        "'cosine' = linear warmup + cosine decay to "
                        "--cosine_min_ratio x lr, beta1 fixed")
    g.add_argument("--cosine_min_ratio", type=float, default=0.1)
    g.add_argument("--max_steps", type=int, default=20000)
    g.add_argument("--log_interval", type=int, default=100)
    g.add_argument("--save_interval", type=int, default=1000)
    g.add_argument("--save_dir", type=str, default="./checkpoints")
    g.add_argument("--reserve_last_n_ckpts", "--reserv_last_n_ckpts",
                   type=int, default=-1)
    g.add_argument("--batch_size", "-b", type=int, default=32)
    g.add_argument("--bf16", action="store_true",
                   help="bf16 matmuls/activations (params and loss stay f32)")
    g.add_argument("--loss_mode", choices=["vocab_parallel", "gather"],
                   default="vocab_parallel")
    g.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --save_dir")
    g.add_argument("--steps_per_dispatch", type=int, default=1)
    g.add_argument("--grad_accum", type=int, default=1,
                   help="each optimizer step averages the grads of N "
                        "microbatches")

    g = p.add_argument_group("model")
    g.add_argument("--family", choices=["llama", "gpt2"], default="llama")
    g.add_argument("--model", choices=sorted(MODEL_PRESETS), default=None,
                   help="named shape preset; explicit dim flags override "
                        "preset fields")
    g.add_argument("--attn_dim", type=int, default=None)
    g.add_argument("--ffn_dim", type=int, default=None)
    g.add_argument("--num_heads", type=int, default=None)
    g.add_argument("--num_kv_heads", type=int, default=None,
                   help="grouped-query attention: K/V heads")
    g.add_argument("--num_layers", type=int, default=None)
    g.add_argument("--maxlen", type=int, default=None)
    g.add_argument("--num_experts", type=int, default=None)
    g.add_argument("--moe_top_k", type=int, default=None)
    g.add_argument("--moe_capacity_factor", type=float, default=None)
    g.add_argument("--remat", choices=["auto", "dots", "false", "true"],
                   default="true",
                   help="per-layer rematerialisation: 'true' recomputes "
                        "each layer in the backward, 'false' saves every "
                        "activation")
    g.add_argument("--seq_bucket", type=int, default=0)

    g = p.add_argument_group("data")
    g.add_argument("--data_path", "-d", type=str, required=True)
    g.add_argument("--data_mode", choices=["docs", "packed"], default="docs",
                   help="'docs' = one document per row, padded to maxlen; "
                        "'packed' = shuffled BOS/EOS-framed documents cut "
                        "into fixed (batch, maxlen) chunks")

    g = p.add_argument_group("observability (not ported yet)")
    g.add_argument("--no_trace", action="store_true")
    g.add_argument("--no_sentinel", action="store_true")
    g.add_argument("--sentinel_spike_factor", type=float, default=3.0)
    g.add_argument("--watchdog_secs", type=float, default=300.0)
    g.add_argument("--flight_ring", type=int, default=256)
    g.add_argument("--metrics_port", type=int, default=None)
    g.add_argument("--rollup_interval", type=float, default=5.0)
    g.add_argument("--profile_on_anomaly", type=int, default=0,
                   metavar="STEPS")
    g.add_argument("--profile_every", type=int, default=0, metavar="N")
    g.add_argument("--profile_window", type=int, default=4, metavar="W")
    g.add_argument("--profile_budget_mb", type=float, default=64.0)
    g.add_argument("--control", choices=["off", "advise", "act"],
                   default="off")

    g = p.add_argument_group("other")
    g.add_argument("--random_seed", type=int, default=0)
    g.add_argument("--profile_steps", type=int, default=0)
    g.add_argument("--debug_nans", action="store_true")
    g.add_argument("--coordinator", type=str, default=None)
    g.add_argument("--num_processes", type=int, default=None)
    g.add_argument("--process_id", type=int, default=None)
    g.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    g.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="the cp group's transport (default: nccl on cuda, "
                        "gloo on cpu); nccl needs one card per rank, gloo "
                        "stages a card's tensors through host memory")
    return p.parse_args(argv)


def refuse_off_slice(args: argparse.Namespace) -> None:
    """NotImplementedError for any flag at a value this slice cannot run."""
    for dest, default, item in OFF_SLICE:
        val = getattr(args, dest)
        if val != default:
            raise NotImplementedError(
                f"--{dest} {val}: not ported yet, see {item}")
    if args.remat not in REMAT_CHOICES:
        raise NotImplementedError(
            f"--remat {args.remat}: the selective remat policies are not "
            f"ported yet, see {_LEFT}; use true or false")


def _windows(batches: Iterator[Dict[str, np.ndarray]], size: int,
             skip: int) -> Iterator[Dict[str, np.ndarray]]:
    """Batches grouped `size` at a time and stacked on a leading axis
    (size 1: the batches themselves), after skipping `skip` batches."""
    buf: List[Dict[str, np.ndarray]] = []
    for i, batch in enumerate(batches):
        if i < skip:
            continue
        if size == 1:
            yield batch
            continue
        buf.append(batch)
        if len(buf) == size:
            yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
            buf = []
    if buf:
        yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}


class _StepClock:
    """Per-step times without a host sync: CUDA events recorded between
    steps on the card (read once, at the end), the host clock on the CPU
    (whose ops finish before they return)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.tick()

    def tick(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> List[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _model_config(args: argparse.Namespace, vocab_size: int) -> ModelConfig:
    """The model shape: preset fields, overridden by any explicit dim flag."""
    preset = model_preset(args.model) if args.model else ModelConfig()
    pick = lambda flag, dflt: dflt if flag is None else flag
    return ModelConfig(attn_dim=pick(args.attn_dim, preset.attn_dim),
                       ffn_dim=pick(args.ffn_dim, preset.ffn_dim),
                       num_heads=pick(args.num_heads, preset.num_heads),
                       num_kv_heads=pick(args.num_kv_heads,
                                         preset.num_kv_heads),
                       num_layers=pick(args.num_layers, preset.num_layers),
                       vocab_size=vocab_size,
                       maxlen=pick(args.maxlen, preset.maxlen),
                       compute_dtype="bfloat16" if args.bf16 else "float32")


def _check_cp(args: argparse.Namespace) -> None:
    """The cp run's refusals, before any rank starts: no card, a transport
    that cannot run, and the JAX package's checks and messages."""
    try:
        device = resolve_device(args.device)
        cp_backend(args.dist_backend, device, args.cp_size)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"train: {e}")
    cfg = _model_config(args, vocab_size=ModelConfig().vocab_size)
    validate_cp(cfg, 1, args.cp_size, args.cp_impl, args.cp_layout)
    if cfg.maxlen % args.cp_size != 0:
        raise SystemExit(f"--maxlen {cfg.maxlen} must be divisible by "
                         f"--cp_size {args.cp_size} (sequence is sharded "
                         f"over the 'cp' mesh axis)")
    if args.cp_layout == "zigzag" and cfg.maxlen % (2 * args.cp_size):
        raise SystemExit(f"--cp_layout zigzag needs --maxlen {cfg.maxlen} "
                         f"divisible by 2*cp ({2 * args.cp_size})")


def train(args: argparse.Namespace) -> dict:
    """Run the loop; returns the summary: steps, start_step, final_loss,
    avg_loss, losses (per step of this run), grad_norm (last step),
    tokens_per_sec and mfu (None without a known peak) over all steps
    after the first two and their whole time, step_ms_p50 (their median),
    peak_mem_gib (None on the CPU), device, checkpoints (paths written),
    cp, cp_impl, cp_layout, dist_backend, cards, and `ranks`: per rank its
    kernel launches, peak memory and time in the cp collectives.

    At cp > 1 the ranks run in processes of their own; the summary is rank
    0's (the loss is global, so every rank's agrees), with every rank's
    `ranks` entry."""
    refuse_off_slice(args)
    if args.cp_size == 1:
        return _train(args)
    _check_cp(args)
    summaries = launch.spawn(_cp_rank, args.cp_size, args)
    return dict(summaries[0], ranks=[s["ranks"][0] for s in summaries])


def _cp_rank(rank: int, nprocs: int, init_method: str,
             args: argparse.Namespace) -> dict:
    """One rank of a cp run (`runtime/launch.spawn` calls it)."""
    return _train(args, rank, init_method)


def _train(args: argparse.Namespace, rank: int = 0,
           init_method: str = None) -> dict:
    """The loop on one rank; see `train`."""
    try:
        mesh = make_mesh(MeshConfig(cp=args.cp_size), device=args.device,
                         rank=rank, backend=args.dist_backend,
                         init_method=init_method)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"train: {e}")
    device, cp = mesh.device, mesh.cp
    is_main = mesh.cp_rank == 0
    say = print if is_main else (lambda *a, **k: None)
    maxlen = _model_config(args, 0).maxlen
    dataloader = get_dataloader(args.data_path, args.batch_size,
                                IGNORE_INDEX, split="train", maxlen=maxlen,
                                shuffle=True, seed=args.random_seed,
                                data_mode=args.data_mode)
    vocab_size = dataloader.dataset.vocab_size
    cfg = _model_config(args, vocab_size)
    model = Transformer(cfg, remat=REMAT_CHOICES[args.remat], cp_size=cp,
                        cp_impl=args.cp_impl, cp_layout=args.cp_layout,
                        mesh=mesh if cp > 1 else None)
    model.init_weights(args.random_seed).to(device)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                           max_steps=args.max_steps,
                           clip_grad_norm=args.clip_grad_norm,
                           weight_decay=args.weight_decay,
                           lr_schedule=args.lr_schedule,
                           cosine_min_ratio=args.cosine_min_ratio)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    cards = (len({r % torch.cuda.device_count() for r in range(cp)})
             if device.type == "cuda" else 0)
    cp_desc = ("" if cp == 1 else f", cp_impl={args.cp_impl}, cp_layout="
               f"{args.cp_layout}, dist_backend={mesh.backend}, {cp} ranks "
               f"on {cards or 'no'} card(s)")
    say(f"model[llama]: {n_params / 1e6:.2f}M params, vocab={vocab_size}, "
        f"mesh=dp1 x pp1 x cp{cp} x ep1 x tp1, compute={cfg.compute_dtype}, "
        f"remat={args.remat}, device={_device_name(device)}{cp_desc}")
    opt_state = init_adam_state(params)
    start_step = 0
    if args.resume:
        last = latest_step(args.save_dir)
        if last is not None:
            state_dict, ck_opt, start_step = load_checkpoint(
                args.save_dir, last, with_opt=True)
            model.load_state_dict(state_dict)
            if ck_opt is not None:
                to_dev = lambda t: {k: v.to(device) for k, v in t.items()}
                opt_state = AdamState(step=ck_opt.step, mu=to_dev(ck_opt.mu),
                                      nu=to_dev(ck_opt.nu))
            say(f"resumed from iter {start_step} in {args.save_dir}")

    accum = max(1, args.grad_accum)
    build = build_grad_accum_step if accum > 1 else build_train_step
    step_fn = build(model, ocfg, args.loss_mode)
    flops_step = model_flops_per_step(cfg, args.batch_size, maxlen) * accum
    peak_flops = device_peak_flops(device)
    if peak_flops is not None:
        peak_flops *= max(cards, 1)   # MFU against the cards the run uses

    # with accumulation one optimizer step consumes `accum` batches
    steps_per_epoch = len(dataloader) // accum
    if steps_per_epoch == 0:
        raise SystemExit(
            f"the loader yields {len(dataloader)} batches per epoch but one "
            f"optimizer step needs {accum} (grad_accum): zero steps per "
            f"epoch — reduce --batch_size/--maxlen/--grad_accum")
    max_epoch = math.ceil(args.max_steps / steps_per_epoch)
    # resume continues the data stream too: same seeded per-epoch order,
    # skipping the batches already consumed
    start_epoch = start_step // steps_per_epoch
    skip_batches = (start_step % steps_per_epoch) * accum
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = launch_counts()
    collectives.reset_stats()

    # losses stay on the device; the host reads them at log intervals only
    accum_loss = torch.zeros((), dtype=torch.float32, device=device)
    losses: List[torch.Tensor] = []
    n = last_saved = start_step
    last_cum, last_log_n = 0.0, start_step
    t_start, tokens_since, useful_since = time.time(), 0, 0
    gnorm = None
    saved: List[str] = []
    clock = _StepClock(device)

    def save(step: int) -> None:
        # parameters are replicated over cp: rank 0 writes the tp=1 file,
        # and no rank goes on (or reads it back) before it is published
        nonlocal last_saved
        avg = float(accum_loss) / max(step - start_step, 1)
        if cp > 1:
            dist.barrier()
        if is_main:
            saved.extend(save_checkpoint(
                args.save_dir, step, avg, model.state_dict(), opt_state,
                reserve_last_n=args.reserve_last_n_ckpts))
            say(f"saved checkpoint iter {step}: {saved[-1]}")
        if cp > 1:
            dist.barrier()
        last_saved = step

    done = n >= args.max_steps
    for epoch in range(start_epoch, max_epoch):
        if done:
            break
        for window in _windows(dataloader.epoch(epoch), accum,
                               skip_batches if epoch == start_epoch else 0):
            if accum > 1 and window["input_ids"].shape[0] < accum:
                continue  # partial accumulation group at the epoch end
            prev_n = n
            chunks = model.cp_shard(*(window[k] for k in (
                "input_ids", "target_ids", "position_ids")))
            ids, tgt, pos = (torch.from_numpy(np.ascontiguousarray(x))
                             .to(device).long() for x in chunks)
            loss, gnorm, opt_state = step_fn(opt_state, ids, tgt, pos)
            clock.tick()
            n += 1
            losses.append(loss)
            accum_loss += loss
            tokens_since += window["input_ids"].size
            useful_since += int((window["target_ids"] != IGNORE_INDEX).sum())
            if n // args.log_interval > prev_n // args.log_interval:
                lr, _ = schedule_lr(ocfg, n - 1)
                cum = float(accum_loss)  # the interval's one host sync
                dt = time.time() - t_start
                tps = tokens_since / max(dt, 1e-9)
                mfu_s = ("n/a" if peak_flops is None else
                         f"{100 * flops_step * (n - last_log_n) / dt / peak_flops:.1f}%")
                mem_s = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                         if device.type == "cuda" else "n/a (cpu)")
                say(f"step {n}/{args.max_steps} -> avg loss "
                    f"{cum / (n - start_step):.4f}, interval loss "
                    f"{(cum - last_cum) / (n - last_log_n):.4f}, lr "
                    f"{float(lr):.8f}, {tps / 1e3:.1f}k tok/s "
                    f"({100 * useful_since / max(tokens_since, 1):.0f}% "
                    f"useful), MFU {mfu_s}, grad norm {float(gnorm):.4f}, "
                    f"mem {mem_s}")
                last_cum, last_log_n = cum, n
                t_start, tokens_since, useful_since = time.time(), 0, 0
            if n // args.save_interval > prev_n // args.save_interval:
                save(n)
            if n >= args.max_steps:
                done = True
                break
        say(f"epoch {epoch + 1}/{max_epoch} finished")
    if n > last_saved:
        save(n)

    step_ms = clock.step_ms()
    # the first steps build the kernels and warm the allocator. The rates
    # divide the steady window's work by its whole time, stalls (logging,
    # checkpoint writes) included; the median is a separate statistic
    steady = step_ms[min(2, len(step_ms) - 1):] if step_ms else []
    step_ms_p50 = float(np.median(steady)) if steady else None
    window_s = sum(steady) / 1e3
    tokens_step = args.batch_size * maxlen * accum
    loss_vals = ([float(x) for x in torch.stack(losses).cpu()]
                 if losses else [])
    avg_loss = float(accum_loss) / max(n - start_step, 1)
    say(f"training finished at step {n}, avg loss {avg_loss:.4f}")
    launches = launch_counts()
    peak_mem = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else None)
    return {
        "steps": n, "start_step": start_step,
        "final_loss": loss_vals[-1] if loss_vals else None,
        "avg_loss": avg_loss, "losses": loss_vals,
        "grad_norm": None if gnorm is None else float(gnorm),
        "step_ms_p50": step_ms_p50,
        "tokens_per_sec": (tokens_step * len(steady) / window_s
                           if window_s > 0 else None),
        "mfu": (flops_step * len(steady) / window_s / peak_flops
                if window_s > 0 and peak_flops else None),
        "peak_mem_gib": peak_mem,
        "device": _device_name(device), "checkpoints": saved,
        "cp": cp, "cp_impl": args.cp_impl, "cp_layout": args.cp_layout,
        "dist_backend": mesh.backend, "cards": cards,
        "ranks": [{"rank": mesh.cp_rank, "device": str(device),
                   "peak_mem_gib": peak_mem, "step_ms_p50": step_ms_p50,
                   "wall_s": sum(step_ms) / 1e3,
                   "launches": {k: v - launches0[k]
                                for k, v in launches.items()},
                   "collectives": dict(collectives.stats)}],
    }


def main(argv=None) -> dict:
    return train(get_train_args(argv))


if __name__ == "__main__":
    main()
