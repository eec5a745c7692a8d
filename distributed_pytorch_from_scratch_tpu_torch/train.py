"""Training entry point — the port's counterpart of the JAX `train.py`.

    python -m distributed_pytorch_from_scratch_tpu_torch.train \\
        --model 45m --bf16 --data_path tokens.json --save_dir ckpt \\
        [--tp_size 2 [--sequence_parallel]] [--dp_size 2] \\
        [--cp_size 2 [--cp_impl ring|ulysses] [--cp_layout contiguous|zigzag]]
        [--model 45m-moe8 [--ep_size 2]]
        [--pp_size 2 [--pp_microbatches 4] [--pp_schedule interleaved
         [--pp_virtual 2]] [--pp_remat_steps]]

Parses the same flags as the JAX CLI, plus two of its own: `--device`
(default `cuda`; with no card the CLI exits non-zero rather than run on the
CPU — pass `--device cpu` for the plain PyTorch path) and `--dist_backend`
(the process groups' transport: nccl, the default on a card, needs one card
per rank and is refused with fewer; gloo runs anywhere, a card's tensors
staged through host memory). The loop: epochs over the seeded data loader,
host-to-device copy, one train step (forward, backward through the
attention kernels, Adam/OneCycle in place), a log line every
`--log_interval` steps (the one host sync of the interval), with the
JAX trainer's scalars (`train/ce_loss`, `train/lr`, `train/tokens_per_sec`,
`train/useful_token_frac`, `train/mfu`, `device_memory_gib`,
`train/grad_norm`) written to `save_dir/logs` (`training/metrics
.MetricsWriter`: `metrics.jsonl`, and TensorBoard when `tensorboardX`
imports) by the ranks at dp = cp = 0, a checkpoint every
`--save_interval` steps and at the end, in the JAX npz format with the
JAX trainer's `__layout__` stamp, and `--resume` from the newest
checkpoint in `--save_dir` (either package's).

The loop is the JAX trainer's preemption-safe one. A daemon thread
(`data/prefetch.Prefetcher`) collates and stacks the next window on the
host while the card runs the current one; the host-to-device copy stays
on the loop's thread. Checkpoints are written in the background
(`save_checkpoint(..., async_write=True)`: a device snapshot, then a
writer thread), at most one in flight. SIGTERM or SIGINT sets a flag that
the loop reads once per window (at more than one rank: once per
`--log_interval` steps, as the MAX of every rank's flag, so a signal that
reaches one rank stops them all): the loop stops, checkpoints the step it
reached, prints `shutdown requested: checkpointed at step N; restart with
--resume to continue` and returns, and the process exits 0. A second
signal kills the process at once. At more than one rank the launching
process forwards the signals to every rank (`runtime/launch.spawn`).

Parallelism: `--dp_size M --cp_size C --ep_size E --tp_size N` run
M·C·E·N ranks, one process each (`runtime/launch.spawn`), rank r on card
r % device_count, at the coordinates of the JAX device order
(`runtime/mesh.py`, tp innermost). Every rank draws the same seeded batch;
its (dp, ep) index takes b/(M·E) of the rows (dp major), its cp index its
chunk of the sequence (zig-zag order first under
`--cp_layout zigzag`), and its tp index its shard of every tp-sharded
weight (Megatron's column/row layers, the vocab-parallel embedding and
head; `--sequence_parallel` shards the activations between sublayers over
the sequence too). Attention is the flash kernels on the rank's local
heads, or at cp > 1 the ring (the block kernels) or Ulysses over the cp
group. Global rank 0 alone prints. The ranks at dp = cp = ep = 0 write
one checkpoint file per tp rank, in the JAX shard format, between
barriers (at ep > 1 every rank first gathers the experts over its ep
group: the files hold all of them); every rank loads on `--resume`, from
files written at any tp its vocab divides. A rank that fails fails the
run.

`--num_experts E` (or `--model 45m-moe8`) trains the MoE family: every
layer's FFN is E top-k routed SwiGLU experts (`parallel/moe.py`,
`--moe_top_k`, `--moe_capacity_factor`), in either family, with the
router's aux losses in the loss; `--ep_size` shards the experts over the
ep axis (E/ep per rank, two `all_to_all`s per layer over ep, staged
through host memory under gloo). Its MFU counts the active parameters
(the top-k experts of each token).

`--remat` takes the JAX policies: true, false, dots, and auto, which
`training/memory.select_remat` resolves against the card's memory (printed
with its estimates). `--steps_per_dispatch N` runs N optimizer steps per
host dispatch (`training/train_step.build_train_step_multi`: the one-step
graph replayed N times on a card), the same training bitwise; logs and
saves land on dispatch boundaries and the last dispatch shrinks to end on
`--max_steps`. It takes one rank and no `--grad_accum`.

`--family gpt2` trains the GPT-2 family (`models/gpt2.py`: LayerNorm,
tanh-GELU MLP, learned positions, a tied vocab-parallel head) on every
path the llama family runs: any dp x cp x tp, SP, remat and
`--steps_per_dispatch`; its MFU counts N from the real parameters
(`training/metrics.model_flops_per_step(..., params)`).

`--zero N` (`--zero1`: stage 1) shards the weight-update state over the
dp axis (`training/zero.py`): 1 the Adam moments, 2 the grads too (a
bucketed reduce-scatter, then one all-gather of the fresh params), 3 the
params too (gathered per layer in the forward and its remat replay).
`--dp_reduce_bucket_mb M` sends the dp gradient sum in buckets of <= M
MiB, `--dp_reduce_dtype bf16|int8` compresses their wire (int8: the
block-scaled ring); the JAX CLI's refusals of these flags come first, in
its words (`refuse_zero`). The first rank prints the stage, the wire and
the buckets once; the summary holds each rank's held bytes and its hops
per step.

`--pp_size P` pipelines the layers over P stages (`models/pipeline.py`):
each stage holds num_layers/P of them, and every step runs the batch
through the gpipe schedule in `--pp_microbatches` microbatches (default
P), or the interleaved one (`--pp_schedule interleaved`, `--pp_virtual`
round-robin blocks per stage), each stage step's layers replayed in the
backward with `--pp_remat_steps`. Both families, any dp x cp x ep x tp,
ZeRO 1 (stages 2 and 3 and the bucketed reducer are refused at pp > 1, in
the JAX CLI's words). The summary's `hops_per_step` gives each axis's
hops per step, their bytes and their host time (`host_ms`), and
`state_bytes` each rank's held bytes. The checkpoint holds every stage's
layers, in the canonical order.

`--resume` reads the newest checkpoint's `__layout__` stamp. Written on
this run's layout (the same mesh axes and ZeRO stage), it loads as
before; written on another (another tp, dp, pp or ZeRO stage), each rank
streams its own part of it one leaf at a time through the reshard planner
(`reshard/apply.stream_load`), and the run writes JAX's `reshard_event`
record into `metrics.jsonl`. Under `--pp_schedule interleaved` a resume
across meshes is refused, with JAX's message.

A flag that takes the run off the ported slices (tp overlap,
`--seq_bucket`, the observability/control
and multi-host flags) raises NotImplementedError at any non-default value,
naming its ROADMAP item; for a MoE model they stay refused with the rest
(the JAX CLI refuses each of them with MoE too).
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import threading
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from .config import (IGNORE_INDEX, MODEL_PRESETS, MeshConfig, ModelConfig,
                     OptimizerConfig, model_preset)
from .data.dataset import dp_rows, get_dataloader
from .data.prefetch import Prefetcher, stack_window, window_stream
from .models import build_model, num_params
from .models.pipeline import from_canonical, to_canonical, validate_pp
from .models.transformer import (Transformer, validate_cp, validate_ep,
                                 validate_tp)
from .ops import collectives
from .ops.cuda import launch_counts
from .runtime import launch
from .runtime.mesh import dist_backend, make_mesh, resolve_device
from .parallel.moe import validate_moe
from .reshard import (layouts_equal, make_layout, resolve_source_layout,
                      stream_load)
from .reshard.layout import canonical_specs, mesh_axes_of
from .training.checkpoint import (gather_experts, gather_stages,
                                  latest_step, load_checkpoint,
                                  save_checkpoint)
from .training.memory import hbm_budget_gib, select_remat
from .training.metrics import (MetricsWriter, device_peak_flops,
                               model_flops_per_step)
from .training.optim import AdamState, init_adam_state, schedule_lr
from .training.train_step import (build_grad_accum_step, build_train_step,
                                  build_train_step_multi)
from .training.zero import (build_plan, expected_state_bytes,
                             resolve_zero_stage)

# CLI flag-string -> Transformer.remat value ('auto' resolves to a key)
REMAT_CHOICES = {"true": True, "dots": "dots", "false": False}

_MULTI = "ROADMAP Queue 1 item 2: the multi-host flags"
_LATER = "ROADMAP Queue 1 item 7 (d): --tp_overlap"
_OBS = "ROADMAP Queue 1 item 5: the obs hooks of train.py"
# (flag dest, default, the ROADMAP item that brings it)
OFF_SLICE = [
    ("tp_overlap", "off", _LATER),
    ("seq_bucket", 0, "ROADMAP Queue 1 item 3: --seq_bucket"),
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

    g = p.add_argument_group("distributed (dp, pp, cp, ep and tp through "
                             "torch.distributed)")
    g.add_argument("--tp_size", type=int, default=1)
    g.add_argument("--dp_size", type=int, default=1)
    g.add_argument("--cp_size", type=int, default=1)
    g.add_argument("--cp_impl", choices=["ring", "ulysses"], default="ring")
    g.add_argument("--cp_layout", choices=["contiguous", "zigzag"],
                   default="contiguous")
    g.add_argument("--sequence_parallel", action="store_true")
    g.add_argument("--tp_overlap", choices=["off", "ring", "ring_q"],
                   default="off")
    g.add_argument("--zero", type=int, choices=[0, 1, 2, 3], default=None,
                   help="ZeRO stage over the dp axis (training/zero.py): 1 "
                        "shards the Adam moments, 2 also reduce-scatters "
                        "the grads in buckets (25 MiB unless "
                        "--dp_reduce_bucket_mb) and all-gathers the fresh "
                        "params, 3 also shards the params, gathered per "
                        "layer in the forward and its replay. Stages 2/3: "
                        "dense models and --sequence_parallel whenever tp "
                        "> 1; stage 3 needs remat and an f32 wire")
    g.add_argument("--zero1", action="store_true",
                   help="alias for --zero 1")
    g.add_argument("--dp_reduce_bucket_mb", type=float, default=0.0,
                   help="bucketed dp gradient reduction: one collective per "
                        "<= N-MiB bucket instead of one flat buffer; 0 = "
                        "off. Dense models")
    g.add_argument("--dp_reduce_dtype", choices=["f32", "bf16", "int8"],
                   default="f32",
                   help="wire dtype of the bucketed dp reduction: bf16 "
                        "halves the bytes, int8 quarters them through the "
                        "block-scaled int8 ring (f32 accumulate either "
                        "way). Needs --dp_reduce_bucket_mb > 0, or --zero "
                        "2")
    g.add_argument("--ep_size", type=int, default=1,
                   help="expert-parallel axis size (MoE: experts shard over "
                        "'ep'; requires --num_experts; 'ep' also shards the "
                        "batch, like dp)")
    g.add_argument("--pp_size", type=int, default=1,
                   help="pipeline-parallel axis size: layers shard into "
                        "pp stages, microbatches flow through a GPipe "
                        "schedule (both model families)")
    g.add_argument("--pp_microbatches", type=int, default=0,
                   help="microbatches per pipeline step (default pp_size; "
                        "more microbatches = smaller bubble fraction "
                        "(pp-1)/(m+pp-1) but smaller per-microbatch work)")
    g.add_argument("--pp_remat_steps", action="store_true",
                   help="rematerialise each pipeline step: backward "
                        "residuals shrink to the (mb, t, d) step carries "
                        "for ~33%% recompute")
    g.add_argument("--pp_schedule", choices=["gpipe", "interleaved"],
                   default="gpipe",
                   help="'interleaved' = Megatron-style virtual stages: "
                        "each device owns pp_virtual round-robin layer "
                        "blocks and microbatches circulate the ring "
                        "pp_virtual times — bubble drops from "
                        "(pp-1)/(m+pp-1) to (pp-1)/(pp_virtual*m+pp-1) at "
                        "the cost of pp_virtual x more hops")
    g.add_argument("--pp_virtual", type=int, default=2,
                   help="virtual stages per device for "
                        "--pp_schedule interleaved (num_layers must "
                        "divide by pp_size*pp_virtual)")

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
    g.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="run N optimizer steps per host dispatch (the "
                        "one-step CUDA graph replayed N times on a card): "
                        "bitwise the same training; logs/saves land on "
                        "dispatch boundaries")
    g.add_argument("--grad_accum", type=int, default=1,
                   help="each optimizer step averages the grads of N "
                        "microbatches; exclusive with --steps_per_dispatch "
                        "> 1")

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
    g.add_argument("--num_experts", type=int, default=None,
                   help="MoE: swap every layer's FFN for this many top-k "
                        "routed experts (both families; default 0 = dense "
                        "FFN)")
    g.add_argument("--moe_top_k", type=int, default=None,
                   help="experts activated per token (default 2)")
    g.add_argument("--moe_capacity_factor", type=float, default=None,
                   help="per-expert slot headroom; overflow tokens fall "
                        "through the residual (default 2.0)")
    g.add_argument("--remat", choices=["auto", "dots", "false", "true"],
                   default="true",
                   help="per-layer rematerialisation: 'true' recomputes "
                        "each layer in the backward, 'false' saves every "
                        "activation, 'dots' saves the matmul and flash "
                        "outputs, 'auto' picks the fastest that fits the "
                        "card (training/memory.select_remat)")
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
                   help="the process groups' transport (default: nccl on "
                        "cuda, gloo on cpu); nccl needs one card per rank, "
                        "gloo stages a card's tensors through host memory")
    return p.parse_args(argv)


def refuse_zero(args: argparse.Namespace) -> None:
    """The JAX CLI's refusals of the ZeRO and dp-reducer flags, in its
    order and its words (SystemExit)."""
    zero_stage = resolve_zero_stage(args.zero, args.zero1)
    num_experts = _model_config(args, ModelConfig().vocab_size).num_experts
    if zero_stage == 3 and args.dp_reduce_dtype != "f32":
        raise SystemExit(
            f"--dp_reduce_dtype {args.dp_reduce_dtype} with --zero 3: "
            f"the ZeRO-3 grad reduce-scatter rides the parameter "
            f"all-gather's transpose (an f32 ppermute ring), so the "
            f"compressed wire would silently not apply — use it with "
            f"--zero 2, whose bucketed reduce-scatter carries the "
            f"{args.dp_reduce_dtype} payload")
    if (args.dp_reduce_dtype != "f32" and not args.dp_reduce_bucket_mb
            and zero_stage != 2):
        raise SystemExit(f"--dp_reduce_dtype {args.dp_reduce_dtype} "
                         f"needs --dp_reduce_bucket_mb > 0 (the "
                         f"compressed wire is a property of the "
                         f"bucketed reducer; --zero 2 implies it)")
    if args.dp_reduce_bucket_mb and args.pp_size > 1:
        raise SystemExit("--dp_reduce_bucket_mb needs --pp_size 1 "
                         "(pp-replicated leaves' reduction axes depend "
                         "on the pipeline head layout)")
    if args.dp_reduce_bucket_mb and num_experts:
        raise SystemExit("--dp_reduce_bucket_mb does not compose with "
                         "MoE (expert grads are ep-sharded, not "
                         "batch-replicated)")
    if zero_stage >= 2:
        if num_experts:
            raise SystemExit(
                f"--zero {zero_stage} does not compose with MoE: expert "
                f"grads are ep-sharded, not batch-replicated — use "
                f"--zero 1 (moment sharding only) for MoE runs")
        if args.pp_size > 1:
            raise SystemExit(
                f"--zero {zero_stage} needs --pp_size 1: non-layer "
                f"params are pp-replicated and their reduction axes "
                f"depend on the pipeline head layout — use --zero 1 "
                f"under pp")
        if args.tp_size > 1 and not args.sequence_parallel:
            raise SystemExit(
                f"--zero {zero_stage} with --tp_size {args.tp_size} "
                f"needs --sequence_parallel: the non-SP path "
                f"all-reduces inside every row-parallel layer, so "
                f"per-shard cotangent bookkeeping is depth-dependent "
                f"(turn SP on, or drop to --zero 1)")
    # 'auto' never resolves to 'false' at stage 3 (`select_remat`)
    if zero_stage == 3 and args.remat == "false":
        raise SystemExit(
            "--zero 3 needs rematerialisation (--remat dots/true/"
            "auto): without remat, autodiff saves every layer's "
            "GATHERED weights as backward residuals, recreating the "
            "full param replica the stage exists to eliminate")


def refuse_off_slice(args: argparse.Namespace) -> None:
    """The JAX CLI's ZeRO refusals first (`refuse_zero`), then
    NotImplementedError for any flag at a value this slice cannot run;
    SystemExit for --grad_accum with several steps per dispatch (the JAX
    CLI's refusal)."""
    refuse_zero(args)
    for dest, default, item in OFF_SLICE:
        val = getattr(args, dest)
        if val != default:
            raise NotImplementedError(
                f"--{dest} {val}: not ported yet, see {item}")
    if args.steps_per_dispatch > 1:
        if args.grad_accum > 1:
            raise SystemExit("--grad_accum and --steps_per_dispatch > 1 "
                             "are mutually exclusive")
        if _world(args) > 1:
            raise NotImplementedError(
                f"--steps_per_dispatch {args.steps_per_dispatch} at "
                f"{_world(args)} ranks: the hops between ranks are staged "
                f"through host memory (gloo) and cannot be captured in a "
                f"CUDA graph, and NCCL is unrun, see ROADMAP Queue 1 item 2")


class _ShutdownFlag:
    """Preemption-safe shutdown (the JAX trainer's): SIGTERM and SIGINT set
    a flag that the loop polls, so it checkpoints and exits cleanly. The
    handlers go in on the main thread only (signal.signal raises elsewhere)
    and the previous ones come back at the first signal, so a second one
    force-quits, and when the loop ends, so an embedding caller keeps its
    own."""

    def __init__(self):
        self.requested = False
        self._installed = []
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._installed.append((sig, signal.signal(sig,
                                                           self._handle)))

    def _handle(self, signum, frame) -> None:
        self.requested = True
        self.restore()

    def restore(self) -> None:
        while self._installed:
            sig, prev = self._installed.pop()
            signal.signal(sig, prev)


class _StepClock:
    """Per-dispatch times without a host sync: CUDA events recorded between
    dispatches on the card (read once, at the end), the host clock on the
    CPU (whose ops finish before they return)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.steps = []    # optimizer steps of each dispatch
        self.tick(0)

    def tick(self, steps: int) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        self.steps.append(steps)

    def step_ms(self) -> List[float]:
        """Per optimizer step: a dispatch of n steps gives n times, each
        its time over n."""
        if self.cuda:
            self.marks[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(self.marks,
                                                    self.marks[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [t / n for t, n in zip(ms, self.steps[1:]) for _ in range(n)]

    def steady_from(self, skip: int) -> int:
        """The first step of the dispatch after the one that completes step
        `skip`: the steady window starts on a dispatch boundary."""
        done = 0
        for n in self.steps[1:]:
            if done >= skip:
                break
            done += n
        return done


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
                       num_experts=pick(args.num_experts, preset.num_experts),
                       moe_top_k=pick(args.moe_top_k, preset.moe_top_k),
                       moe_capacity_factor=pick(args.moe_capacity_factor,
                                                preset.moe_capacity_factor),
                       compute_dtype="bfloat16" if args.bf16 else "float32")


def _world(args: argparse.Namespace) -> int:
    return (args.dp_size * args.pp_size * args.cp_size * args.ep_size
            * args.tp_size)


def _check_dist(args: argparse.Namespace) -> None:
    """A run of more than one rank's refusals, before any rank starts: no
    card, a transport that cannot run, the JAX package's checks and
    messages, and shapes that do not shard."""
    try:
        device = resolve_device(args.device)
        dist_backend(args.dist_backend, device, _world(args))
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"train: {e}")
    cfg = _model_config(args, vocab_size=ModelConfig().vocab_size)
    validate_tp(cfg, args.tp_size)
    validate_cp(cfg, args.tp_size, args.cp_size, args.cp_impl,
                args.cp_layout)
    validate_ep(cfg, args.ep_size)
    validate_pp(cfg.num_layers, args.pp_size, args.pp_microbatches,
                args.pp_schedule, args.pp_virtual)
    if cfg.num_experts:
        validate_moe(cfg.ffn_dim, cfg.num_experts, cfg.moe_top_k,
                     args.ep_size, args.tp_size)
    if cfg.maxlen % args.cp_size != 0:
        raise SystemExit(f"--maxlen {cfg.maxlen} must be divisible by "
                         f"--cp_size {args.cp_size} (sequence is sharded "
                         f"over the 'cp' mesh axis)")
    if args.cp_layout == "zigzag" and cfg.maxlen % (2 * args.cp_size):
        raise SystemExit(f"--cp_layout zigzag needs --maxlen {cfg.maxlen} "
                         f"divisible by 2*cp ({2 * args.cp_size})")
    if args.sequence_parallel and (cfg.maxlen // args.cp_size) % args.tp_size:
        raise SystemExit(f"--sequence_parallel needs the cp-local sequence "
                         f"length {cfg.maxlen // args.cp_size} divisible by "
                         f"--tp_size {args.tp_size}")
    if args.ep_size > 1 and args.batch_size % (args.dp_size * args.ep_size):
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible "
                         f"by dp_size*ep_size "
                         f"{args.dp_size * args.ep_size} (the batch shards "
                         f"over both axes)")
    if args.batch_size % args.dp_size:
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible "
                         f"by --dp_size {args.dp_size} (each dp rank takes "
                         f"b/dp rows of the batch)")


def train(args: argparse.Namespace) -> dict:
    """Run the loop; returns the summary: steps, start_step, final_loss,
    avg_loss, losses (per step of this run), grad_norm (last step),
    tokens_per_sec and mfu (per card; None without a known peak; N from
    the real parameters for gpt2) over the steps of the dispatches after
    the one that completes step 2, and their whole time, step_ms_p50
    (their median; a dispatch of n steps counts n times its time / n),
    peak_mem_gib (None on the CPU), device, checkpoints (paths written,
    every tp rank's), family, params (the global count), the mesh (dp, pp,
    cp, ep, tp, sequence_parallel, cp_impl, cp_layout, pp_schedule,
    pp_microbatches, pp_virtual, pp_remat_steps), reshard (an elastic
    resume's plan summary, wall ms and peak host bytes; None when the
    checkpoint was this run's layout or there was none), moe (a MoE model's last
    step's routing: `Transformer.moe_summary`; None for a dense one),
    dist_backend, cards, remat (the
    policy run, `auto` resolved), steps_per_dispatch, zero_stage,
    dp_reduce_dtype, dp_reduce_bucket_mb and buckets (the dp reducer's
    buckets per step; 0 for the flat buffer), shutdown (whether a
    signal stopped the run), save_stall_ms (the loop's host time per save:
    the loss sync, the join of the write before and the snapshot),
    prefetch_wait_ms (the ms the loop waited for each window from the
    prefetch thread),
    and `ranks`: per rank
    its coordinates, kernel launches, peak memory (and `peak_mem_steps_gib`,
    the steps' before the last save; None on the CPU) and time in the
    collectives per axis (`collectives`, the whole run's;
    `collectives_steps`, before the last save's; `hops_per_step`, those
    over the steps run, per axis: calls, bytes, ring bytes and the host
    ms of their waits and hops),
    `state_bytes` (the params, the grads Adam took and the moments as the
    rank holds them after its last step) and `expected_state_bytes` (their
    sum by `memory.zero_state_bytes_per_param`, leaf by leaf).

    With more than one rank the ranks run in processes of their own; the
    summary is global rank 0's (the loss is global, so every rank's
    agrees), with every rank's `ranks` entry."""
    refuse_off_slice(args)
    if _world(args) == 1:
        return _train(args)
    _check_dist(args)
    summaries = launch.spawn(_rank_main, _world(args), args)
    return dict(summaries[0], ranks=[s["ranks"][0] for s in summaries],
                checkpoints=sorted({p for s in summaries
                                    for p in s["checkpoints"]}))


def _rank_main(rank: int, nprocs: int, init_method: str,
               args: argparse.Namespace) -> dict:
    """One rank of a run of more than one (`runtime/launch.spawn` calls
    it)."""
    return _train(args, rank, init_method)


def _load_into(model: Transformer, state_dict: Dict[str, torch.Tensor],
               where: str) -> None:
    """`model.load_state_dict`, refusing a checkpoint whose padded shapes do
    not map onto this run's with a message (not torch's size mismatch)."""
    own = model.state_dict()
    for key, x in state_dict.items():
        if key in own and own[key].shape != x.shape:
            raise SystemExit(
                f"train: the checkpoint in {where} does not map onto this "
                f"run: {key} is {tuple(x.shape)} there, "
                f"{tuple(own[key].shape)} here (tp={model.tp_size}, vocab "
                f"{model.cfg.vocab_size} padded to {model.vocab_padded}); "
                f"resume at the tp it was written at")
    model.load_state_dict(state_dict)


def _train(args: argparse.Namespace, rank: int = 0,
           init_method: str = None) -> dict:
    """The loop on one rank; see `train`."""
    try:
        mesh = make_mesh(MeshConfig(dp=args.dp_size, pp=args.pp_size,
                                    cp=args.cp_size, ep=args.ep_size,
                                    tp=args.tp_size),
                         device=args.device, rank=rank,
                         backend=args.dist_backend, init_method=init_method)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"train: {e}")
    device, cp, tp, world = mesh.device, mesh.cp, mesh.tp, mesh.world
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    # the ranks at dp = pp = cp = ep = 0 write the checkpoint, one file per
    # tp rank
    is_writer = (mesh.dp_rank == 0 and mesh.pp_rank == 0
                 and mesh.cp_rank == 0 and mesh.ep_rank == 0)
    maxlen = _model_config(args, 0).maxlen
    dataloader = get_dataloader(args.data_path, args.batch_size,
                                IGNORE_INDEX, split="train", maxlen=maxlen,
                                shuffle=True, seed=args.random_seed,
                                data_mode=args.data_mode)
    vocab_size = dataloader.dataset.vocab_size
    cfg = _model_config(args, vocab_size)
    zero_stage = resolve_zero_stage(args.zero, args.zero1)
    remat = args.remat
    if remat == "auto":      # the JAX train.py's resolution
        remat = select_remat(cfg, args.batch_size, maxlen, tp=tp,
                             world=world, zero_stage=zero_stage, dp=mesh.dp,
                             budget_gib=hbm_budget_gib(device=device),
                             verbose=mesh.rank == 0)
    if zero_stage == 2 and not args.dp_reduce_bucket_mb:
        say("zero 2: grads reduce-scatter in 25 MiB buckets "
            "(--dp_reduce_bucket_mb to tune)")
    model = build_model(args.family, cfg, remat=REMAT_CHOICES[remat],
                        cp_size=cp, cp_impl=args.cp_impl,
                        cp_layout=args.cp_layout,
                        mesh=mesh if world > 1 else None,
                        sequence_parallel=args.sequence_parallel,
                        pp_microbatches=args.pp_microbatches,
                        pp_schedule=args.pp_schedule,
                        pp_virtual=args.pp_virtual,
                        pp_remat_steps=args.pp_remat_steps)
    model.init_weights(args.random_seed).to(device)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                           max_steps=args.max_steps,
                           clip_grad_norm=args.clip_grad_norm,
                           weight_decay=args.weight_decay,
                           lr_schedule=args.lr_schedule,
                           cosine_min_ratio=args.cosine_min_ratio)
    params = dict(model.named_parameters())
    # the global count: tp-sharded leaves hold 1/tp of theirs on each rank
    n_params = num_params(model)
    cards = (len({r % torch.cuda.device_count() for r in range(world)})
             if device.type == "cuda" else 0)
    dist_desc = ("" if world == 1 else
                 f", sequence_parallel={model.sequence_parallel}, cp_impl="
                 f"{args.cp_impl}, cp_layout={args.cp_layout}, dist_backend="
                 f"{mesh.backend}, {world} ranks on {cards or 'no'} card(s)")
    moe_note = (f", {cfg.num_experts} experts (top-{cfg.moe_top_k})"
                if cfg.num_experts else "")
    pp_note = ("" if mesh.pp == 1 else
               f", pipeline {args.pp_schedule} over {mesh.pp} stages ("
               f"{len(model.layers)} layers each"
               + (f" in {args.pp_virtual} blocks" if model.interleaved
                  else "")
               + f"), {args.pp_microbatches or mesh.pp} microbatches"
               + (", remat per step" if args.pp_remat_steps else ""))
    say(f"model[{args.family}]: {n_params / 1e6:.2f}M params{moe_note}, "
        f"vocab={vocab_size}, mesh=dp{mesh.dp} x pp{mesh.pp} x cp{cp} x "
        f"ep{mesh.ep} x tp{tp}, compute="
        f"{cfg.compute_dtype}, remat={remat}"
        + (" (auto)" if args.remat == "auto" else "") + ", device="
        f"{_device_name(device)}{dist_desc}{pp_note}")
    ck_opt = None
    start_step = 0
    reshard_info = None
    # the mesh axes and canonical specs the stamp of this run's checkpoints
    # names (every stage's layers under one stacked key)
    mesh_axes = mesh_axes_of(mesh)
    specs = canonical_specs({k: v.shape for k, v in to_canonical(
        model.state_dict(), model.layer_ids).items()}, pp=mesh.pp)
    if args.resume:
        last = latest_step(args.save_dir)
        if last is not None:
            try:
                src_layout, _ = resolve_source_layout(
                    args.save_dir, last, specs=specs, echo=say)
                dst_layout = make_layout(mesh_axes, specs,
                                         zero_stage=zero_stage)
                if layouts_equal(src_layout, dst_layout):
                    state_dict, ck_opt, start_step = load_checkpoint(
                        args.save_dir, last, with_opt=True, tp_size=tp,
                        tp_rank=mesh.tp_rank, ep_size=mesh.ep,
                        ep_rank=mesh.ep_rank)
                    state_dict = from_canonical(state_dict, model.layer_ids)
                    if ck_opt is not None:
                        ck_opt = AdamState(
                            step=ck_opt.step,
                            mu=from_canonical(ck_opt.mu, model.layer_ids),
                            nu=from_canonical(ck_opt.nu, model.layer_ids))
                    _load_into(model, state_dict, args.save_dir)
                    say(f"resumed from iter {start_step} in "
                        f"{args.save_dir}")
                else:
                    if model.interleaved:
                        raise SystemExit(
                            "--resume across meshes with interleaved "
                            "pipeline stages is not supported: the "
                            "on-device tree is a permutation of the "
                            "canonical checkpoint tree (from_canonical "
                            "is layout-dependent) — resume on the "
                            "saving mesh, or use a non-interleaved "
                            "schedule")
                    state_dict, ck_opt, start_step, reshard_info = (
                        stream_load(args.save_dir, last, model, dst_layout,
                                    with_opt=True, specs=specs, echo=say))
                    model.load_state_dict(state_dict)
                    say(f"elastic resume: iter {start_step} resharded "
                        f"{reshard_info['src']} -> {reshard_info['dst']} "
                        f"({reshard_info['bytes_moved']} bytes moved, "
                        f"{reshard_info['wall_ms']} ms)")
            except ValueError as e:
                raise SystemExit(f"train: {e}")
    # ZeRO: the plan of the whole model (None: stage 0's flat reducer); at
    # stage 3 the parameters then rest as this rank's dp shards
    shapes = {k: tuple(p.shape) for k, p in params.items()}
    try:
        plan = build_plan(model, zero_stage, args.dp_reduce_bucket_mb,
                          args.dp_reduce_dtype)
    except ValueError as e:
        raise SystemExit(f"train: {e}")
    n_buckets = 0 if plan is None else plan.buckets(shapes)
    if plan is not None:
        plan.install(model)
        params = dict(model.named_parameters())
        say(f"zero: stage {zero_stage} over dp {mesh.dp}, wire "
            f"{args.dp_reduce_dtype}, "
            + (f"{n_buckets} bucket(s) of <= {plan.bucket_mb:g} MiB"
               if plan.bucket_mb else "one flat buffer")
            + (", each layer gathered in its forward and its replay"
               if zero_stage == 3 else "")
            + f"; {sum(plan.sharded(k) for k in shapes)} of {len(shapes)} "
            f"leaves dp-sharded")
    if ck_opt is not None:
        to_dev = lambda t: {k: v.to(device) for k, v in t.items()}
        opt_state = AdamState(step=ck_opt.step, mu=to_dev(ck_opt.mu),
                              nu=to_dev(ck_opt.nu))
        if plan is not None:
            opt_state = plan.shard_state(opt_state)
    else:
        opt_state = (init_adam_state(params) if plan is None
                     else plan.init_state(params))

    accum = max(1, args.grad_accum)
    spd = max(1, args.steps_per_dispatch)
    build = (build_grad_accum_step if accum > 1 else
             build_train_step_multi if spd > 1 else build_train_step)
    step_fn = build(model, ocfg, args.loss_mode, plan)
    # gpt2's N from its real parameters (the llama formula overcounts its
    # two-matmul MLP and counts a head it ties), as the JAX trainer
    flops_step = model_flops_per_step(
        cfg, args.batch_size, maxlen,
        params=n_params if args.family == "gpt2" else None) * accum
    peak_flops = device_peak_flops(device)
    if peak_flops is not None:
        peak_flops *= max(cards, 1)   # MFU per card: against those it uses

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
    # the JAX trainer's scalars, one file per writing process (the ranks at
    # dp = cp = 0, as for the checkpoints)
    writer = (MetricsWriter(os.path.join(args.save_dir, "logs"),
                            process_index=mesh.rank) if is_writer else None)
    if writer is not None and reshard_info is not None:
        writer.event("reshard_event", src_layout=reshard_info["src"],
                     dst_layout=reshard_info["dst"],
                     bytes_moved=reshard_info["bytes_moved"],
                     plan_ops=reshard_info["ops"],
                     wall_ms=reshard_info["wall_ms"], step=start_step,
                     peak_host_bytes=reshard_info["peak_host_bytes"])

    shutdown = _ShutdownFlag()
    # the flag's all-reduce runs on the default group: NCCL reduces device
    # tensors, gloo host ones
    flag_device = device if mesh.backend == "nccl" else torch.device("cpu")
    last_poll = None
    pending = None        # the checkpoint write in flight (at most one)
    save_stall_ms: List[float] = []   # the loop's host time per save
    prefetch_wait_ms: List[float] = []   # the loop's wait per window

    def shutdown_agreed(step: int = None) -> bool:
        """The shutdown decision every rank takes: the MAX of the ranks'
        flags, so a signal that reaches one rank stops all of them. Inside
        the loop (`step` given) the all-reduce, a host sync, runs once per
        --log_interval steps; every rank counts the same steps, so all of
        them reach it together."""
        nonlocal last_poll
        if world == 1:
            return shutdown.requested
        if step is not None:
            if last_poll is not None and step - last_poll < args.log_interval:
                return False
            last_poll = step
        flag = torch.tensor([int(shutdown.requested)], dtype=torch.int32,
                            device=flag_device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def join_save(barrier: bool = True) -> None:
        """Wait for the write in flight; with `barrier`, at more than one
        rank, every rank's file of it is published before any rank goes
        on."""
        nonlocal pending
        if pending is not None:
            paths = pending.join()
            saved.extend(paths)
            say(f"saved checkpoint iter {pending.step}: {paths[0]}")
            pending = None
        if barrier and world > 1:
            dist.barrier()

    def schedule_save(step: int) -> None:
        # parameters are replicated over dp and cp (and, but for the
        # experts, ep; but for the layers, pp): the ranks at dp = pp = cp =
        # ep = 0 write one file per tp rank, from a snapshot taken now, on
        # a thread; at ep > 1 every rank gathers the experts first, at pp >
        # 1 every stage's layers (collectives, on this thread)
        nonlocal pending, last_saved
        t0 = time.perf_counter()
        avg = float(accum_loss) / max(step - start_step, 1)
        join_save()
        params_sd = gather_experts(model.state_dict(), mesh)
        opt_sd = opt_state
        if plan is not None:
            # whole leaves in the files: every dp rank gathers its shards
            # here, on the loop's thread, before the writer thread starts
            params_sd = plan.full_params(params_sd)
            opt_sd = plan.full_state(opt_sd)
        if mesh.ep > 1:
            opt_sd = AdamState(step=opt_sd.step,
                               mu=gather_experts(opt_sd.mu, mesh),
                               nu=gather_experts(opt_sd.nu, mesh))
        if mesh.pp > 1:
            params_sd = gather_stages(params_sd, model)
            opt_sd = AdamState(step=opt_sd.step,
                               mu=gather_stages(opt_sd.mu, model),
                               nu=gather_stages(opt_sd.nu, model))
        if is_writer:
            pending = save_checkpoint(
                args.save_dir, step, avg, params_sd, opt_sd,
                reserve_last_n=args.reserve_last_n_ckpts, tp_size=tp,
                tp_rank=mesh.tp_rank, mesh_axes=mesh_axes,
                async_write=True, zero_stage=zero_stage)
        last_saved = step
        save_stall_ms.append((time.perf_counter() - t0) * 1e3)

    def shutdown_save(step: int) -> None:
        if step > last_saved:
            schedule_save(step)
        say(f"shutdown requested: checkpointed at step {step}; restart with "
            f"--resume to continue")

    # one window per dispatch: `accum` microbatches of one step, or `spd`
    # steps (the epoch's last window may hold fewer: it dispatches smaller,
    # as the JAX loop's), collated and stacked on the prefetch thread
    multi = accum > 1 or spd > 1
    prefetcher = None
    stopped = False
    try:
        done = n >= args.max_steps
        for epoch in range(start_epoch, max_epoch):
            if done:
                break
            prefetcher = Prefetcher(
                window_stream(dataloader.epoch(epoch), accum * spd,
                              skip_batches if epoch == start_epoch else 0),
                depth=2,
                transform=stack_window if multi else (lambda bufs: bufs[0]))
            waited = 0.0
            for window in prefetcher:
                prefetch_wait_ms.append((prefetcher.wait_time - waited) * 1e3)
                waited = prefetcher.wait_time
                # polled once per window: the windows prefetched and not
                # trained on are read again on --resume
                if shutdown_agreed(n):
                    prefetcher.close()
                    shutdown_save(n)
                    stopped = done = True
                    break
                if accum > 1 and window["input_ids"].shape[0] < accum:
                    continue  # partial accumulation group at the epoch end
                if (spd > 1 and window["input_ids"].shape[0]
                        > args.max_steps - n):
                    # the last dispatch shrinks to end exactly on max_steps
                    window = {k: v[:args.max_steps - n]
                              for k, v in window.items()}
                steps_in = window["input_ids"].shape[0] if spd > 1 else 1
                prev_n = n
                chunks = model.cp_shard(*(
                    dp_rows(window[k], *mesh.row_shard)
                    for k in ("input_ids", "target_ids", "position_ids")))
                ids, tgt, pos = (torch.from_numpy(np.ascontiguousarray(x))
                                 .to(device).long() for x in chunks)
                loss, gnorm, opt_state = step_fn(opt_state, ids, tgt, pos)
                clock.tick(steps_in)
                n += steps_in
                losses.append(loss.reshape(-1))
                accum_loss += loss.sum() if spd > 1 else loss
                tokens_since += window["input_ids"].size
                useful_since += int((window["target_ids"]
                                     != IGNORE_INDEX).sum())
                if n // args.log_interval > prev_n // args.log_interval:
                    lr, _ = schedule_lr(ocfg, n - 1)
                    cum = float(accum_loss)  # the interval's one host sync
                    dt = time.time() - t_start
                    tps = tokens_since / max(dt, 1e-9)
                    avg = cum / (n - start_step)
                    useful = useful_since / max(tokens_since, 1)
                    mfu = (None if peak_flops is None else
                           flops_step * (n - last_log_n) / dt / peak_flops)
                    mem = (torch.cuda.max_memory_allocated(device) / 2**30
                           if device.type == "cuda" else None)
                    say(f"step {n}/{args.max_steps} -> avg loss {avg:.4f}, "
                        f"interval loss "
                        f"{(cum - last_cum) / (n - last_log_n):.4f}, lr "
                        f"{float(lr):.8f}, {tps / 1e3:.1f}k tok/s "
                        f"({100 * useful:.0f}% useful), MFU "
                        + ("n/a" if mfu is None else f"{100 * mfu:.1f}%")
                        + f", grad norm {float(gnorm):.4f}, mem "
                        + ("n/a (cpu)" if mem is None else f"{mem:.2f} GiB"))
                    if writer is not None:
                        writer.scalar("train/ce_loss", avg, n)
                        writer.scalar("train/lr", float(lr), n)
                        writer.scalar("train/tokens_per_sec", tps, n)
                        writer.scalar("train/useful_token_frac", useful, n)
                        if mfu is not None:  # no peak known: no fake number
                            writer.scalar("train/mfu", mfu, n)
                        if mem is not None:
                            writer.scalar("device_memory_gib", mem, n)
                        writer.scalar("train/grad_norm", float(gnorm), n)
                    last_cum, last_log_n = cum, n
                    t_start, tokens_since, useful_since = time.time(), 0, 0
                if n // args.save_interval > prev_n // args.save_interval:
                    schedule_save(n)
                if n >= args.max_steps:
                    done = True
                    break
            prefetcher.close()
            say(f"epoch {epoch + 1}/{max_epoch} finished")
        # the hops and the peak of the steps alone, before the last save's
        loop_hops = {a: dict(v) for a, v in collectives.stats.items()}
        steps_peak = (torch.cuda.max_memory_allocated(device) / 2**30
                      if device.type == "cuda" else None)
        if n > last_saved:
            # a signal during the last dispatch ends the loop on max_steps
            # without passing the poll: it still reports the shutdown
            if shutdown_agreed():
                shutdown_save(n)
                stopped = True
            else:
                schedule_save(n)
        join_save()
    finally:
        # on any exit: stop the prefetch thread, put the signal handlers
        # back, and let the write in flight finish (no truncated file); no
        # barrier, which a failed rank would never reach
        if prefetcher is not None:
            prefetcher.close()
        shutdown.restore()
        join_save(barrier=False)
        if writer is not None:
            writer.close()

    step_ms = clock.step_ms()
    # the first steps build the kernels and warm the allocator (and, with
    # several steps per dispatch, capture the step): the steady window
    # starts at the first dispatch after step 2. The rates divide its work
    # by its whole time, stalls (logging, checkpoint writes) included; the
    # median is a separate statistic
    steady = (step_ms[min(clock.steady_from(2), len(step_ms) - 1):]
              if step_ms else [])
    step_ms_p50 = float(np.median(steady)) if steady else None
    window_s = sum(steady) / 1e3
    tokens_step = args.batch_size * maxlen * accum
    loss_vals = ([float(x) for x in torch.cat(losses).cpu()]
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
        "family": args.family, "params": n_params,
        "dp": mesh.dp, "pp": mesh.pp, "cp": cp, "ep": mesh.ep, "tp": tp,
        "pp_schedule": args.pp_schedule,
        "pp_microbatches": (args.pp_microbatches or mesh.pp
                            if mesh.pp > 1 else 0),
        "pp_virtual": args.pp_virtual if model.interleaved else 1,
        "pp_remat_steps": args.pp_remat_steps,
        "reshard": reshard_info,
        "moe": model.moe_summary(),
        "sequence_parallel": model.sequence_parallel,
        "cp_impl": args.cp_impl, "cp_layout": args.cp_layout,
        "dist_backend": mesh.backend, "cards": cards,
        "remat": remat, "steps_per_dispatch": spd,
        "zero_stage": zero_stage, "dp_reduce_dtype": args.dp_reduce_dtype,
        "dp_reduce_bucket_mb": 0.0 if plan is None else plan.bucket_mb,
        "buckets": n_buckets,
        "shutdown": stopped, "save_stall_ms": save_stall_ms,
        "prefetch_wait_ms": prefetch_wait_ms,
        "ranks": [{"rank": mesh.rank, **mesh.coords, "device": str(device),
                   "peak_mem_gib": peak_mem,
                   "peak_mem_steps_gib": steps_peak,
                   "step_ms_p50": step_ms_p50,
                   "wall_s": sum(step_ms) / 1e3,
                   "launches": {k: v - launches0[k]
                                for k, v in launches.items()},
                   "collectives": {a: dict(v) for a, v in
                                   collectives.stats.items()},
                   "collectives_steps": loop_hops,
                   "hops_per_step": {
                       a: {**{k: v[k] / max(n - start_step, 1)
                              for k in ("calls", "bytes", "ring_bytes")},
                           "host_ms": (v["hop_s"] + v["wait_s"]) * 1e3
                           / max(n - start_step, 1)}
                       for a, v in loop_hops.items() if v["calls"]},
                   "state_bytes": dict(getattr(step_fn, "held_bytes", {})),
                   "expected_state_bytes": expected_state_bytes(shapes,
                                                                plan)}],
    }


def main(argv=None) -> dict:
    return train(get_train_args(argv))


if __name__ == "__main__":
    main()
