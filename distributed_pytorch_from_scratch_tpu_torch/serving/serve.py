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
`--paged_attn gather` asks for the dense page view. On a card at tp = 1
both engines run their decode step as a CUDA graph (`--decode_graph auto`,
the default; `off` runs the eager step, the graph's oracle and the A/B;
`on` demands the graph and is refused on the CPU and at tp > 1); the
summary says which, with the graph's replays and the kernel launches one
replay holds.

`--tp_size N` serves over N tensor-parallel ranks, one process each
(`runtime/launch.spawn`; the transport is `--dist_backend`, nccl by default
on a card: one card per rank; two ranks sharing one card need gloo): each
rank holds its shard of the weights and of the KV pool, tp rank 0 runs the
loadgen and the engine's host loop and broadcasts each device dispatch
(`serving/tp_dispatch.py`), and every rank computes the same greedy tokens
as tp=1. Rank 0's record is printed, with every rank's tp hops and
dispatch counts under `ranks` in the returned summary.

`--paged --cp N` shards the page pool over N context-parallel ranks (one
process each, alone or times `--tp_size`; mesh order tp innermost, as
JAX's `MeshConfig(tp, cp)`): each rank holds 1/N of the KV pages, so a
request N times longer fits the same per-rank page bytes; every layer
attends each rank's own pages and combines the ranks' partials in one cp
hop (`models/decode.cp_combine`), with the tokens of cp = 1. Global rank 0
runs the loadgen and the host loop for every rank. The record adds `cp`,
`pages_per_rank` and `num_pages`, and `ranks` each rank's cp hops. The
speculative drafter stays at cp = 1.

`--family llama|gpt2` picks the model (`models/gpt2.py`: LayerNorm,
tanh-GELU, learned positions, tied head); a gpt2 buffer is clamped to its
position table, as the JAX CLI clamps it. `--temperature > 0` samples
(with `--decode_top_k` / `--decode_top_p`), each request drawing from its
own seed (`--seed` + its index); `--debug_host_sampler` samples on the
host from the decode step's full-vocab logits (the fused sampler's
oracle and the JAX ablation).

Weights: `--random_init` (fresh random weights from `--seed`, the same
model at any tp), or `--ckpt_dir` with a checkpoint written by either
package's trainer, at any tp. `--decode_weight_dtype int8` serves them as
int8 codes with per-output-channel scales, dequantized at use (both
engines, any tp; `serving/engine.py`). `--dry_run` shrinks everything to
a tiny smoke run.

A MoE model (`--model 45m-moe8`, or `--num_experts`) serves in both
engines at ep = 1 (every rank holds every expert) and any tp, its decode
step a CUDA graph at tp = 1; `--dry_run` keeps its experts on the dry
shape. It takes every serving path a dense model takes: int8 decode
weights (its router and experts quantized per output channel too),
`--speculate` (a dense or MoE drafter) and `--paged --cp`.

`--tokenizer_path` (a `tokenizer.json`, read by `data/tokenizer
.load_tokenizer`) sets the vocab size and the EOS id; without it the
vocab is `--vocab_size` and EOS is 1, the shipped tokenizer's.
`--arrival replay --replay trace.jsonl` serves a captured trace
(`loadgen.replay_requests`: one JSON record per line, `prompt` and
optional `rid`, `max_new`, `seed`, `arrival`) in arrival order.

`--paged --speculate K` serves through the speculative engine
(`serving/speculative.py`): a drafter (`--drafter_model`, the `tiny`
preset by default, reshaped to the target's vocab and family, in bf16
unless the run is f32 or a dry run) proposes K tokens per round over its
own page pool (`--drafter_pages`) and the target verifies K+1 positions of
every live row in one dispatch, greedy tokens identical to `--paged`'s,
sampled ones distributed as its. The drafter's weights come from
`--drafter_ckpt_dir` (`--drafter_iter`; either package's checkpoint, any
tp) or from a random init at `--seed` + 1. The report adds the engine's
acceptance numbers and the drafter/target wall split.

Observability and control (JAX's flags, rank 0 only; with every flag off
nothing is written and the record gains no field): `--trace_requests`
(each request's span timeline as a `request_trace` event in `--log_dir`'s
`metrics.jsonl` and a track in its Chrome `trace.json`, the record's
`worst_ttft_rids` / `worst_tpot_rids` and a `request_exemplars` event),
`--flight_records` / `--flight_ring` (the anomaly flight recorder: a
`flightdump_*.json` on a PoolExhausted preemption or an SLO collapse),
`--metrics_port` (the live exporter at http://127.0.0.1:PORT/metrics.json
and /metrics; 0 = ephemeral, the bound port in the record) with
`--rollup_interval` (its `telemetry_snapshot` events), `--metrics_max_mb`
(the stream's rotation), and `--control advise|act` with
`--control_interval` (the SLO controller, `serving/controller.py`: its
`controller_decision` ledger and, in act mode, the moved knobs). Refused:
`--control_force` (it guards the JAX pages_per_block autotuner's cache,
TPU tuning the port leaves out) and the profiler flags (`--profile_*`,
ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from ..cli import add_model_shape_args, build_model_config
from ..config import (BOS_TOKEN, EOS_TOKEN, MODEL_PRESETS, MeshConfig,
                      ModelConfig, model_preset)
from ..models import build_model
from ..models.transformer import Transformer, validate_tp
from ..ops import collectives
from ..ops.cuda import launch_counts
from ..ops.cuda.paged_attention import paged_attention
from ..runtime import launch
from ..runtime.graphs import DECODE_GRAPH_MODES, use_decode_graph
from ..runtime.mesh import dist_backend, make_mesh, resolve_device
from ..training.checkpoint import latest_step, load_checkpoint
from ..training.metrics import MetricsWriter
from .engine import ContinuousBatchingEngine, PagedEngine, graph_stats
from .kv_manager import device_bytes
from .loadgen import replay_requests, run_loadgen, synthetic_requests
from .scheduler import parse_slo_classes
from .speculative import SpeculativeEngine

# head_dim 32, so the dry run also fits the CUDA kernel's head dims
_DRY_CFG = ModelConfig(attn_dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                       vocab_size=64, maxlen=64)
# the dry run's drafter: smaller than the dry target in every dimension but
# head_dim (32, which the kernels are built for); at tp > 1 it takes one
# head per rank (`_drafter_config`)
_DRY_DRAFTER_CFG = ModelConfig(attn_dim=32, ffn_dim=64, num_heads=1,
                               num_layers=1, vocab_size=64, maxlen=64)


def get_serve_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    g = p.add_argument_group("model")
    g.add_argument("--ckpt_dir", default=None,
                   help="serve this checkpoint (either trainer's npz "
                        "shards, written at any tp); omit with "
                        "--random_init/--dry_run")
    g.add_argument("--iter", type=int, default=None,
                   help="checkpoint iteration (default: latest)")
    g.add_argument("--random_init", action="store_true",
                   help="serve fresh random weights at the flag shape")
    g.add_argument("--tokenizer_path", "-t", default=None,
                   help="supplies vocab_size and the real EOS id; omit to "
                        "use --vocab_size and EOS id 1 (the shipped "
                        "tokenizer's convention)")
    g.add_argument("--vocab_size", type=int, default=1024,
                   help="vocab for --random_init without a tokenizer")
    g.add_argument("--family", choices=["llama", "gpt2"], default="llama")
    g.add_argument("--tp_size", type=int, default=1,
                   help="tensor-parallel ranks, one process each")
    add_model_shape_args(g)

    g = p.add_argument_group("engine")
    g.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    g.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="more than one rank (--tp_size, --cp): the "
                        "ranks' transport (default: "
                        "nccl on cuda, gloo on cpu); nccl needs one card "
                        "per rank, gloo stages a card's tensors through "
                        "host memory")
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
                   help="0 = greedy; > 0 samples with per-request seeds")
    g.add_argument("--decode_top_k", type=int, default=0)
    g.add_argument("--decode_top_p", type=float, default=0.0)
    g.add_argument("--debug_host_sampler", action="store_true",
                   help="ABLATION: sample on the host from the decode "
                        "step's full-vocab logits (moves b x vocab floats "
                        "per step) instead of in the step; the fused "
                        "sampler's oracle")
    g.add_argument("--decode_weight_dtype", choices=["native", "int8"],
                   default="native",
                   help="'int8' stores every weight of two dims or more as "
                        "int8 codes + one f32 scale per output channel, "
                        "dequantized at use in both engines")
    g.add_argument("--decode_graph", choices=DECODE_GRAPH_MODES,
                   default="auto",
                   help="run the decode step as a CUDA graph: 'auto' on a "
                        "card at tp=1 (eager on the CPU and at tp>1), 'off' "
                        "the eager step (the graph's oracle), 'on' demands "
                        "the graph")

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
    g.add_argument("--cp", type=int, default=1,
                   help="--paged: context-parallel ranks, one process each "
                        "(times --tp_size): the page pool shards over cp "
                        "(each rank holds 1/cp of the pages) and every "
                        "layer combines the ranks' partial attention; "
                        "token-identical to cp=1. The speculative drafter "
                        "stays cp=1")
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

    g = p.add_argument_group("speculative decoding (--paged only)")
    g.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="draft K tokens per round with the drafter model "
                        "and verify them in ONE target dispatch (exact "
                        "rejection sampling: greedy output is token-"
                        "identical to the plain paged engine); 0 = off")
    g.add_argument("--drafter_model", choices=sorted(MODEL_PRESETS),
                   default="tiny",
                   help="drafter shape preset (its vocab and family are "
                        "the target's)")
    g.add_argument("--drafter_ckpt_dir", default=None,
                   help="load drafter weights from this checkpoint (either "
                        "trainer's, any tp; default: random init at --seed "
                        "+ 1)")
    g.add_argument("--drafter_iter", type=int, default=None,
                   help="drafter checkpoint iteration (default: latest)")
    g.add_argument("--drafter_pages", type=int, default=0,
                   help="drafter page-pool budget in pages (0 = every slot "
                        "can hold its whole drafter row)")

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
    g.add_argument("--arrival", choices=["poisson", "burst", "replay"],
                   default="poisson")
    g.add_argument("--replay", default=None,
                   help="jsonl trace for --arrival replay (loadgen.py "
                        "schema)")
    g.add_argument("--prompt_len_min", type=int, default=8)
    g.add_argument("--prompt_len_max", type=int, default=64)
    g.add_argument("--seed", type=int, default=0)

    g = p.add_argument_group("observability")
    g.add_argument("--trace_requests", action="store_true",
                   help="per-request span timelines (obs/reqtrace.py): "
                        "every request emits a request_trace event + a "
                        "Chrome-trace track under --log_dir, and the "
                        "summary carries the k-worst-TTFT/TPOT exemplars "
                        "WITH their timelines")
    g.add_argument("--flight_records", action="store_true",
                   help="anomaly flight recorder (obs/flight.py): pool "
                        "stats + scheduler decisions ring-buffered; "
                        "PoolExhausted preemptions and SLO-attainment "
                        "collapses dump flightdump_*.json to --log_dir")
    g.add_argument("--flight_ring", type=int, default=512,
                   help="--flight_records: ring capacity (events); "
                        "0 disables the recorder")
    g.add_argument("--metrics_port", type=int, default=None,
                   help="live telemetry exporter (obs/telemetry.py): "
                        "serve gauges/counters at http://127.0.0.1:PORT"
                        "/metrics.json (JSON) and /metrics (Prometheus "
                        "text); 0 = ephemeral (the bound port is printed "
                        "and lands in the summary record). A busy port "
                        "refuses loudly up front")
    g.add_argument("--rollup_interval", type=float, default=1.0,
                   help="--metrics_port: seconds between "
                        "telemetry_snapshot events mirrored into "
                        "metrics.jsonl")
    for flag, kw in (("--profile_on_anomaly", dict(type=int, default=0)),
                     ("--profile_every", dict(type=int, default=0)),
                     ("--profile_window", dict(type=int, default=4)),
                     ("--profile_budget_mb", dict(type=float,
                                                  default=64.0))):
        g.add_argument(flag, **kw,
                       help="the JAX CLI's device-profiler flags: refused "
                            "(the profilers are ROADMAP Queue 1 item 8)")
    g.add_argument("--metrics_max_mb", type=float, default=0.0,
                   help="rotate metrics.jsonl past N MiB (-> "
                        "metrics.001.jsonl ... via schema-valid "
                        "'rotated' continuation events); 0 = unbounded")
    g.add_argument("--control", choices=["off", "advise", "act"],
                   default="off",
                   help="the control plane (obs/control.py, serving/"
                        "controller.py): 'advise' computes SLO/admission "
                        "decisions and lands them in the decision ledger "
                        "with applied=false (nothing mutates); 'act' "
                        "additionally moves the knobs (prefill chunk, "
                        "admission limit, speculation K) at the decode "
                        "step's safe point. 'off' (default) is zero-cost: "
                        "no controller, no events, no record fields")
    g.add_argument("--control_interval", type=int, default=32,
                   help="--control: decode steps between SLO-controller "
                        "evaluations (the adaptation + cooldown window)")
    g.add_argument("--control_force", action="store_true",
                   help="the JAX CLI's guard of its pages_per_block "
                        "autotuner's cache: refused")
    g.add_argument("--log_dir", default="serve_logs",
                   help="obs output: trace.jsonl/trace.json spans + "
                        "metrics.jsonl events + flight dumps")
    g = p.add_argument_group("other")
    g.add_argument("--dry_run", action="store_true",
                   help="tiny random-init model + a 6-request burst; "
                        "ignores --ckpt_dir")
    args = p.parse_args(argv)
    if args.cp < 1:
        p.error(f"--cp must be >= 1, got {args.cp}")
    if args.speculate:
        if not args.paged:
            p.error("--speculate runs over the paged cache; add --paged")
        if args.debug_host_sampler:
            p.error("--debug_host_sampler is the NON-speculative ablation "
                    "knob (a speculative round never materialises host "
                    "logits); drop --speculate to measure it")
        if args.drafter_iter is not None and not args.drafter_ckpt_dir:
            p.error("--drafter_iter needs --drafter_ckpt_dir (without one "
                    "the drafter is random-init and the iter is ignored)")
    elif (args.drafter_ckpt_dir or args.drafter_pages
          or args.drafter_iter is not None):
        p.error("--drafter_ckpt_dir/--drafter_iter/--drafter_pages need "
                "--speculate K")
    if args.temperature < 0:
        p.error(f"--temperature must be >= 0, got {args.temperature}")
    if (args.decode_top_k or args.decode_top_p) and not args.temperature:
        p.error("--decode_top_k/--decode_top_p need --temperature > 0")
    if args.arrival == "replay" and not args.replay and not args.dry_run:
        p.error("--arrival replay needs --replay PATH")
    try:
        use_decode_graph(args.decode_graph, args.device, args.tp_size,
                         args.cp)
    except ValueError as e:
        p.error(f"--decode_graph: {e}")
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
        if args.cp != 1:
            p.error("--cp is a --paged knob (only the page pool shards "
                    "over cp; the slot engine replicates its caches — "
                    "add --paged for long-context cp serving)")
        if args.class_mix:
            p.error("--class_mix needs --paged (the FIFO engine has no "
                    "SLO classes)")
        if args.tenants != 1:
            p.error("--tenants needs --paged (the FIFO engine ignores "
                    "tenants)")
    if (args.profile_on_anomaly or args.profile_every
            or args.profile_window != 4 or args.profile_budget_mb != 64.0):
        p.error("--profile_on_anomaly/--profile_every/--profile_window/"
                "--profile_budget_mb: the device profilers are not ported "
                "yet, see ROADMAP Queue 1 item 8")
    if args.control != "off":
        if not args.paged:
            p.error("--control drives the paged engine's scheduler "
                    "admission and prefill chunking (the slot engine has "
                    "none of those knobs); add --paged")
        if args.control_interval < 1:
            p.error(f"--control_interval must be >= 1, got "
                    f"{args.control_interval}")
    if args.control_force:
        if args.control != "act":
            p.error("--control_force needs --control act (only act mode "
                    "writes the block cache; nothing can shadow a swept "
                    "entry otherwise)")
        p.error("--control_force guards the JAX pages_per_block "
                "autotuner's swept block cache, TPU tuning the port "
                "leaves out (ROADMAP): there is no cache to force")
    if args.metrics_port is not None and args.metrics_port < 0:
        p.error(f"--metrics_port must be >= 0 (0 = ephemeral), got "
                f"{args.metrics_port}")
    if args.metrics_port is not None and args.rollup_interval <= 0:
        p.error("--rollup_interval must be > 0 (seconds between "
                "telemetry_snapshot events)")
    # 'pallas' is the JAX CLI's name for the kernel impl
    args.paged_attn = {None: "kernel", "pallas": "kernel"}.get(
        args.paged_attn, args.paged_attn)
    if not args.dry_run and not args.random_init and not args.ckpt_dir:
        p.error("pick a weight source: --ckpt_dir, --random_init, or "
                "--dry_run")
    return args


def require_writable_dir(path: str, why: str) -> None:
    """Loud up-front refusal when an obs output dir cannot take writes: a
    traced run that silently drops its timelines is worse than no run."""
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, ".obs_write_probe")
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
    except OSError as e:
        raise SystemExit(
            f"{why}: trace output dir {path!r} is not writable "
            f"({type(e).__name__}: {e}) — point --log_dir at a writable "
            f"directory or drop the flag")


def obs_wanted(args: argparse.Namespace) -> bool:
    """Whether any obs or control flag is on (all off: no obs object, no
    file, no record field)."""
    return bool(args.trace_requests or args.flight_records
                or args.metrics_port is not None or args.control != "off")


class ServeObs:
    """Rank 0's obs objects for one serve run, made as the JAX CLI makes
    them: the span tracer and the metrics writer on `--log_dir`, the
    exporter (started before the engine, so a hung prefill is still
    scrapeable; headless under `--control` alone: the controller's
    decisions cross-link its snapshots), the flight recorder and the
    request tracer."""

    def __init__(self, args: argparse.Namespace):
        from ..obs import (FlightRecorder, RequestTracer, SpanTracer,
                           TelemetryExporter)
        self.args = args
        self.tracer = SpanTracer(args.log_dir, process_name="serve")
        self.writer = MetricsWriter(args.log_dir, process_index=0,
                                    max_bytes=int(args.metrics_max_mb
                                                  * 2 ** 20))
        self.telemetry = None
        if args.metrics_port is not None:
            self.telemetry = TelemetryExporter(
                writer=self.writer, rollup_interval=args.rollup_interval)
            port = self.telemetry.start(args.metrics_port)
            print(f"telemetry exporter: http://127.0.0.1:{port}/metrics.json"
                  f" (Prometheus text at /metrics)", file=sys.stderr)
        elif args.control != "off":
            self.telemetry = TelemetryExporter(writer=self.writer)
        self.flight = (FlightRecorder(args.log_dir, maxlen=args.flight_ring)
                       if args.flight_records and args.flight_ring > 0
                       else None)
        self.rt = (RequestTracer(writer=self.writer, tracer=self.tracer,
                                 flight=self.flight, clock=time.monotonic)
                   if args.trace_requests else None)
        self.controller = None

    def engine_kw(self) -> dict:
        return dict(tracer=self.tracer, writer=self.writer,
                    request_tracer=self.rt, flight=self.flight,
                    telemetry=self.telemetry)

    def attach(self, engine) -> None:
        """The SLO controller on `engine` under `--control advise|act`."""
        if self.args.control != "off":
            from .controller import SLOController
            self.controller = SLOController(
                engine, self.args.control, writer=self.writer,
                telemetry=self.telemetry,
                interval=self.args.control_interval)
            engine.controller = self.controller

    def close(self) -> None:
        """The controller's unapplied decisions, the exporter's last
        snapshot, then the streams (in JAX's order)."""
        if self.controller is not None:
            self.controller.close()
        if self.telemetry is not None:
            self.telemetry.close()
        self.trace_path = self.tracer.close()
        self.writer.close()

    def record(self) -> dict:
        """The record's obs fields."""
        out = {}
        if self.args.trace_requests:
            out["trace_requests"] = True
        tel = self.telemetry
        if tel is not None and tel.port is not None:
            out["metrics_port"] = tel.port
        if tel is not None:
            out["telemetry_snapshots"] = tel.snapshots
        if self.controller is not None:
            out["control"] = self.args.control
            out["controller"] = self.controller.summary()
        if self.flight is not None:
            out["flight_dumps"] = list(self.flight.dumps)
        return out


def _read_tokenizer(args: argparse.Namespace) -> None:
    """`args.eos_id`, and with `--tokenizer_path` the vocab size, from the
    tokenizer (the JAX CLI's check of its specials)."""
    args.eos_id = 1  # the shipped tokenizer's EOS (tokenizer/tokenizer.json)
    if not args.tokenizer_path:
        return
    from ..data.tokenizer import load_tokenizer
    tok = load_tokenizer(args.tokenizer_path, verbose=False)
    eos_id = tok.token_to_id(EOS_TOKEN)
    if eos_id is None or tok.token_to_id(BOS_TOKEN) is None:
        raise SystemExit(f"tokenizer {args.tokenizer_path} lacks the "
                         f"{BOS_TOKEN}/{EOS_TOKEN} specials")
    args.eos_id, args.vocab_size = eos_id, tok.get_vocab_size()


def _model_config(args: argparse.Namespace) -> ModelConfig:
    """The model shape; `--dry_run` also shrinks the run (in `args`)."""
    _read_tokenizer(args)
    if not args.dry_run:
        return build_model_config(args, args.vocab_size)
    args.vocab_size = _DRY_CFG.vocab_size
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
    # a MoE model (its preset or --num_experts) keeps its routing, on the
    # dry run's shape
    moe = build_model_config(args, args.vocab_size)
    return dataclasses.replace(_DRY_CFG, num_experts=moe.num_experts,
                               moe_top_k=moe.moe_top_k,
                               moe_capacity_factor=moe.moe_capacity_factor)


def _load_weights(model, mesh, seed: int, ckpt_dir, step, what: str):
    """`model` (this rank's shard of the `what` model) on its device, its
    weights drawn from `seed` (the full tree drawn, the shard kept: the
    same model at any tp) or, with `ckpt_dir`, read from a checkpoint of
    any tp at `step` (default: the latest)."""
    if not ckpt_dir:
        model.init_weights(seed)
    else:
        step = step if step is not None else latest_step(ckpt_dir)
        if step is None:
            raise SystemExit(f"no {what} checkpoints found in {ckpt_dir}")
        state, _, _ = load_checkpoint(ckpt_dir, step, tp_size=mesh.tp,
                                      tp_rank=mesh.tp_rank)
        model.load_state_dict(state)
        if mesh.rank == 0:
            print(f"{what}: checkpoint iter {step} from {ckpt_dir}",
                  file=sys.stderr)
    return model.to(mesh.device)


def _load_model(args, cfg: ModelConfig, mesh) -> Transformer:
    """This rank's shard of the `--family` model at cp `--cp`, on its
    device, from `--seed` or `--ckpt_dir`."""
    fresh = args.random_init or args.dry_run
    return _load_weights(build_model(args.family, cfg, cp_size=args.cp,
                                     mesh=mesh), mesh,
                         args.seed, None if fresh else args.ckpt_dir,
                         args.iter, "target")


def _drafter_config(args, cfg: ModelConfig) -> ModelConfig:
    """The `--speculate` drafter's shape: the `--drafter_model` preset (the
    dry run's own under `--dry_run`, one head of 32 per tp rank) with the
    target's vocab, in bf16 unless the run is f32 or a dry run."""
    if args.dry_run:
        dcfg = dataclasses.replace(_DRY_DRAFTER_CFG,
                                   num_heads=args.tp_size,
                                   attn_dim=32 * args.tp_size)
    else:
        dcfg = model_preset(args.drafter_model)
    return dataclasses.replace(
        dcfg, vocab_size=cfg.vocab_size,
        compute_dtype="bfloat16" if args.bf16 and not args.dry_run
        else "float32")


def _build_drafter(args, cfg: ModelConfig, mesh) -> Transformer:
    """This rank's shard of the drafter (`_drafter_config`, the target's
    family, at cp = 1: its pool whole on every cp rank), weights from
    `--drafter_ckpt_dir` or drawn from `--seed` + 1."""
    return _load_weights(
        build_model(args.family, _drafter_config(args, cfg), mesh=mesh),
        mesh, args.seed + 1, args.drafter_ckpt_dir, args.drafter_iter,
        "drafter")


def _serve(args: argparse.Namespace, cfg: ModelConfig, rank: int = 0,
           init_method: str = None) -> dict:
    """One rank's run: rank 0 drives the loadgen and returns its summary,
    the other ranks serve its dispatches; each adds its `ranks` entry."""
    try:
        mesh = make_mesh(MeshConfig(tp=args.tp_size, cp=args.cp),
                         device=args.device,
                         rank=rank, backend=args.dist_backend,
                         init_method=init_method)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"serve: {e}")
    model = _load_model(args, cfg, mesh)

    # every rank reads (or draws, seeded) the stream: its longest prompt
    # sizes the pool
    if args.arrival == "replay" and args.replay:
        requests = replay_requests(args.replay)
    else:
        mix = parse_slo_classes(args.class_mix) if args.class_mix else None
        requests = synthetic_requests(
            args.num_requests, args.prompt_len_min, args.prompt_len_max,
            args.max_new_tokens, args.vocab_size, seed=args.seed,
            rate=args.rate, arrival=args.arrival, class_mix=mix,
            tenants=args.tenants, shared_prefix_len=args.shared_prefix_len,
            interleave=args.interleave)
    longest = max(len(r.prompt) for r in requests)
    buf_len = args.buf_len or (longest + args.max_new_tokens + 2)
    cap = getattr(model, "max_decode_positions", None)
    if cap is not None and buf_len > cap:
        if cap < longest + 2:
            raise SystemExit(f"prompts need {longest + 2} positions but the "
                             f"model's position table has {cap}")
        if mesh.rank == 0:
            print(f"Warning: clamping serve buffer {buf_len} -> {cap} "
                  f"(learned position table size)", file=sys.stderr)
        buf_len = cap
    obs = ServeObs(args) if mesh.rank == 0 and obs_wanted(args) else None
    sampling = dict(temperature=args.temperature, top_k=args.decode_top_k,
                    top_p=args.decode_top_p,
                    debug_host_sampler=args.debug_host_sampler,
                    decode_weight_dtype=args.decode_weight_dtype,
                    **(obs.engine_kw() if obs is not None else {}))
    if args.paged:
        paged_kw = dict(
            num_slots=args.slots, buf_len=buf_len,
            eos_id=args.eos_id, page_size=args.page_size,
            num_pages=args.num_pages, prefill_chunk=args.prefill_chunk,
            slo_classes=parse_slo_classes(args.slo_classes),
            default_class=args.default_class, max_queue=args.queue_limit,
            kv_dtype=None if args.kv_dtype == "native" else args.kv_dtype,
            paged_attn_impl=args.paged_attn, decode_graph=args.decode_graph,
            **sampling)
        if args.speculate:
            engine = SpeculativeEngine(
                model, mesh, _build_drafter(args, cfg, mesh),
                speculate_k=args.speculate, drafter_pages=args.drafter_pages,
                **paged_kw)
        else:
            engine = PagedEngine(model, mesh, **paged_kw)
    else:
        engine = ContinuousBatchingEngine(
            model, mesh, num_slots=args.slots, buf_len=buf_len,
            eos_id=args.eos_id, prefill_bucket=args.prefill_bucket,
            max_prefill_batch=args.max_prefill_batch,
            max_queue=args.queue_limit, decode_graph=args.decode_graph,
            **sampling)
    if obs is not None:
        obs.attach(engine)
    launches0 = launch_counts()
    kernels0 = dict(paged_attention.launches_by_kernel)
    collectives.reset_stats()
    t0 = time.perf_counter()
    if engine.dispatch.leader:
        try:
            out = run_loadgen(engine, requests)
        finally:
            engine.dispatch.stop()
            if obs is not None:
                obs.close()
        if obs is not None:
            out.update(obs.record())
    else:
        engine.dispatch.serve()
        out = {}
    wall = time.perf_counter() - t0
    delta = lambda now, then: {k: v - then[k] for k, v in now.items()}
    ranked = {
        "rank": mesh.rank, "tp": mesh.tp_rank, "cp": mesh.cp_rank,
        "device": str(mesh.device),
        "wall_s": wall,
        "dispatches": engine.dispatch.counts,
        "dispatch_shapes": sorted([kind, list(shape), n] for (kind, shape), n
                                  in engine.dispatch.shapes.items()),
        # host seconds: wait_s (for the device) + hop_s (copies, transfer)
        "tp_hops": dict(collectives.stats["tp"]),
        "cp_hops": dict(collectives.stats["cp"]),
        # this rank's KV pool on the device (at cp > 1: its slab)
        "pool_bytes": device_bytes(engine.pool),
        "dispatch_broadcasts": dict(collectives.stats["dispatch"]),
        "launches": delta(launch_counts(), launches0),
        "paged_launches_by_kernel": delta(paged_attention.launches_by_kernel,
                                          kernels0),
        **graph_stats(engine),
    }
    if not engine.dispatch.leader:
        return {"ranks": [ranked]}
    device_name = (torch.cuda.get_device_name(mesh.device)
                   if mesh.device.type == "cuda" else "cpu")
    return {**out, "device": device_name, **graph_stats(engine),
            "prefill_dispatches": engine.prefill_dispatches,
            "engine_stats": {**engine.stats(),
                             "decode_weight_dtype": engine.decode_weight_dtype,
                             "weight_bytes": engine.weight_bytes},
            "outputs": {r.rid: list(r.tokens) for r in engine.completed},
            "ranks": [ranked]}


def _rank_main(rank: int, nprocs: int, init_method: str,
               args: argparse.Namespace, cfg: ModelConfig) -> dict:
    """One rank of a run (`runtime/launch.spawn` calls it)."""
    return _serve(args, cfg, rank, init_method)


def merge_ranks(outs: list) -> dict:
    """The run's summary from every rank's `_serve` result, in rank order:
    rank 0's, with every rank's `ranks` entry."""
    return dict(outs[0], ranks=[o["ranks"][0] for o in outs])


def _report(args: argparse.Namespace, summary: dict) -> None:
    """The stderr line and the JSON record on stdout."""
    fmt = lambda v: "-" if v is None else f"{v:.1f}"
    print(f"serve[{args.family} tp{args.tp_size}"
          + (f" cp{args.cp}" if args.cp > 1 else "")
          + f" on {summary['device']}]: "
          f"{summary['completed']}/{summary['requests']} requests "
          f"({summary['rejected']} rejected) in {summary['wall_s']:.1f}s — "
          f"{summary['tokens_per_sec']:.0f} tok/s, occupancy "
          f"{summary['slot_occupancy_mean']:.2f}, TTFT p50/p95 "
          f"{fmt(summary['ttft_ms_p50'])}/{fmt(summary['ttft_ms_p95'])}ms, "
          f"TPOT p50/p95 {fmt(summary['tpot_ms_p50'])}/"
          f"{fmt(summary['tpot_ms_p95'])}ms, queue p50/p95 "
          f"{fmt(summary['queue_wait_ms_p50'])}/"
          f"{fmt(summary['queue_wait_ms_p95'])}ms, decode "
          f"{'graph' if summary['decode_graph'] else 'eager'}"
          + (f"; kv util {summary['kv_util_mean']:.2f}, prefix hits "
             f"{100 * summary['prefix_hit_rate']:.0f}%, "
             f"{summary['preemptions']} preempted, paged attn "
             f"{summary['paged_attn']}"
             if "kv_util_mean" in summary else "")
          + (f"; spec k={summary['speculate_k']}: "
             f"{summary['accepted_tokens_per_dispatch']:.2f} tok/dispatch, "
             f"acceptance {100 * summary['acceptance_rate']:.0f}%"
             if "speculate_k" in summary else ""), file=sys.stderr)
    rec = {
        "metric": (f"serving tokens/sec ({args.family}, tp={args.tp_size}, "
                   + (f"cp={args.cp}, " if args.cp > 1 else "")
                   + ("paged, " if args.paged else "")
                   + (f"speculate k={args.speculate} "
                      f"({args.drafter_model} drafter), "
                      if args.speculate else "")
                   + ("HOST-sampler ablation, "
                      if args.debug_host_sampler else "")
                   + f"slots={args.slots}, {args.arrival} arrivals"
                   + (f" @{args.rate:g}/s" if args.arrival == "poisson"
                      else "") + ")"),
        "value": summary["tokens_per_sec"],
        "unit": "tokens/sec (serving)",
        **{k: summary[k] for k in (
            "requests", "completed", "rejected", "invalid", "wall_s",
            "slot_occupancy_mean", "ttft_ms_p50", "ttft_ms_p95",
            "tpot_ms_p50", "tpot_ms_p95", "queue_wait_ms_p50",
            "queue_wait_ms_p95", "prefill_pad_waste_eliminated",
            "decode_graph", "decode_graph_replays")},
        "device": summary["device"],
    }
    for k in ("kv_dtype", "paged_attn", "cp", "pages_per_rank", "num_pages",
              "kv_util_mean", "kv_fragmentation_mean", "prefix_hit_rate",
              "cow_copies", "preemptions", "max_live",
              "max_interleaved_prefill_positions", "slo_attainment",
              "speculate_k", "spec_rounds", "accepted_tokens_per_dispatch",
              "acceptance_rate", "acceptance_rate_by_position",
              "rounds_per_request", "drafter_ms_total", "target_ms_total"):
        if k in summary:
            rec[k] = summary[k]
    if args.debug_host_sampler:
        rec["debug_host_sampler"] = True
    if args.decode_weight_dtype != "native":
        rec["decode_weight_dtype"] = args.decode_weight_dtype
    if "moe_dropped_share" in summary["engine_stats"]:
        rec["moe_dropped_share"] = summary["engine_stats"]["moe_dropped_share"]
    for k in ("worst_ttft_rids", "worst_tpot_rids", "trace_requests",
              "metrics_port", "telemetry_snapshots", "control",
              "controller", "flight_dumps"):
        if k in summary:
            rec[k] = summary[k]
    for d in summary.get("flight_dumps", ()):
        print(f"flight dump written: {d}", file=sys.stderr)
    print(json.dumps(rec))


def serve(args: argparse.Namespace) -> dict:
    """Run the benchmark; prints the JSON record and returns the loadgen
    summary plus `device`, `decode_graph` (whether the decode step ran as
    a graph), `decode_graph_replays`, `decode_graph_launches` (the kernel
    launches one replay holds), `prefill_dispatches` (prefill or chunk
    dispatches), `engine_stats` (the engine's `stats()` after the drain),
    `outputs` ({rid: generated ids}) and `ranks`: per rank its tp and cp
    hops (calls, bytes, host seconds), its dispatch broadcasts, its
    dispatches by kind (and by shape) and its kernel launches. At tp or cp
    > 1 the ranks run in processes of their own and the summary is rank
    0's."""
    if (args.trace_requests or args.flight_records
            or args.metrics_port is not None):
        require_writable_dir(
            args.log_dir,
            "--trace_requests/--flight_records/--metrics_port")
    cfg = _model_config(args)
    world = args.tp_size * args.cp
    if world == 1:
        out = _serve(args, cfg)
    else:
        try:
            dist_backend(args.dist_backend, resolve_device(args.device),
                         world)
            validate_tp(cfg, args.tp_size)
            if args.speculate:
                validate_tp(_drafter_config(args, cfg), args.tp_size)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"serve: {e}")
        out = merge_ranks(launch.spawn(_rank_main, world, args, cfg))
    _report(args, out)
    return out


def main(argv=None) -> dict:
    return serve(get_serve_args(argv))


if __name__ == "__main__":
    main()
