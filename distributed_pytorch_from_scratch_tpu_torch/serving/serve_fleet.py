"""serve_fleet: the serving fleet's front door (the port's counterpart of the
JAX `scripts/serve_fleet.py`).

    python -m distributed_pytorch_from_scratch_tpu_torch.serving.serve_fleet \\
        --dry_run --device cpu                   # a tiny smoke run
    python -m distributed_pytorch_from_scratch_tpu_torch.serving.serve_fleet \\
        --dry_run --device cpu --disagg
    python -m distributed_pytorch_from_scratch_tpu_torch.serving.serve_fleet \\
        --model 45m --random_init --replicas 2 --num_requests 64

Builds N `PagedEngine` replicas of one llama model in this process, on one
device, behind a `FleetRouter` (prefix-cache-aware scored dispatch, session
affinity by tenant, a loud spill) and drives them with the loadgen's
arrival stream (`loadgen.run_fleet_loadgen`); or, with `--disagg`, a
prefill-only engine and a decode engine joined by the KV page stream
(`serving/transfer.py`: the prefill side in a thread of its own, every
finished prompt's pages exported, framed, read back and imported by the
decode side, which decodes on as it would colocated). Every engine runs at
tp = cp = 1 and attends through the CUDA paged-attention kernels; the
engines' weights come from `--random_init` (drawn from `--seed`, the same
in every engine) or `--ckpt_dir` (either package's trainer, any tp),
through `serve.py`'s loader. Runs on `cuda:0` unless `--device cpu` is
given; with no card and no `--device cpu` it exits non-zero.

Prints one JSON record on stdout and a human summary on stderr. The
fleet's record: fleet tokens/s, TTFT / TPOT / queue wait p50 and p95, the
router's dispatch ms, session spills, `per_replica` and
`fleet_slo_attainment` (the replicas' live per-class counters folded,
completion-weighted). `--disagg`'s: the pages and bytes transferred, bytes
per request, transfer ms p50 and p95 (send start -> decode-side admit) and
each handoff under `transfers`. `--log_dir` receives the router's
`metrics.jsonl` (its `session_spill` events and the fleet summary).

Not ported yet, and refused: `--tp_size` > 1 and `--prefill_tp` (a replica
over a tp group, with the global-head payload: ROADMAP Queue 1 item 6),
`--restart_tp` (the reshard planner: item 7) and `--trace_requests`
(item 8). The JAX record's `transfer_pricing` (a TPU interconnect's price
of the bytes) and run stamp are left out: the record carries the bytes and
milliseconds this run measured.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Tuple

import torch

from ..cli import add_model_shape_args
from ..config import MeshConfig
from ..parallel.moe import dropped_share
from ..runtime.mesh import make_mesh
from ..training.metrics import MetricsWriter
from .engine import PagedEngine
from .kv_manager import page_bytes
from .loadgen import _pctl, run_fleet_loadgen, synthetic_requests
from .router import FleetRouter
from .scheduler import parse_slo_classes
from .serve import _load_model, _model_config
from .transfer import run_disaggregated


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    g = p.add_argument_group("fleet")
    g.add_argument("--replicas", type=int, default=2,
                   help="PagedEngine replicas behind the router")
    g.add_argument("--prefix_weight", type=float, default=4.0,
                   help="dispatch-score weight on predicted prefix hit")
    g.add_argument("--load_weight", type=float, default=1.0,
                   help="dispatch-score weight on live+queued load")
    g.add_argument("--pool_weight", type=float, default=1.0,
                   help="dispatch-score weight on pool pressure")
    g.add_argument("--disagg", action="store_true",
                   help="disaggregate: prefill engine -> KV page stream "
                        "-> decode engine (replaces the router fleet)")
    g.add_argument("--prefill_tp", type=int, default=0,
                   help="tp width of the --disagg prefill engine (not "
                        "ported: refused)")
    g.add_argument("--restart_tp", type=int, default=0,
                   help="restart one replica mid-run at this tp width "
                        "(not ported: refused)")
    g.add_argument("--restart_replica", default="r0",
                   help="replica name --restart_tp restarts")
    g = p.add_argument_group("model")
    g.add_argument("--ckpt_dir", default=None,
                   help="checkpoint every replica serves (either "
                        "trainer's, any tp); omit with --random_init/"
                        "--dry_run")
    g.add_argument("--iter", type=int, default=None,
                   help="checkpoint step (default: latest)")
    g.add_argument("--random_init", action="store_true",
                   help="serve random weights drawn from --seed")
    g.add_argument("--tp_size", type=int, default=1,
                   help="tensor-parallel width per replica (only 1 is "
                        "ported)")
    g.add_argument("--tokenizer_path", "-t", default=None,
                   help="supplies vocab_size and the real EOS id; omit to "
                        "use --vocab_size and EOS id 1")
    g.add_argument("--vocab_size", type=int, default=1024,
                   help="vocab for --random_init without a tokenizer")
    add_model_shape_args(g)
    g = p.add_argument_group("engine")
    g.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    g.add_argument("--slots", type=int, default=8,
                   help="decode slots per replica")
    g.add_argument("--buf_len", type=int, default=0,
                   help="per-request token buffer (0 = fit the workload)")
    g.add_argument("--page_size", type=int, default=64,
                   help="tokens per KV page")
    g.add_argument("--num_pages", type=int, default=0,
                   help="pool pages per replica (0 = slots * max_pages)")
    g.add_argument("--prefill_chunk", type=int, default=128,
                   help="max prefill positions interleaved per step")
    g.add_argument("--kv_dtype", choices=["native", "int8"],
                   default="native", help="KV page storage dtype")
    g.add_argument("--class_mix", default=None,
                   help="SLO classes, name=weight pairs: each request's "
                        "class is drawn by weight, and the same numbers "
                        "are the classes' TTFT deadlines in seconds (the "
                        "JAX CLI's rule), e.g. interactive=2,standard=6")
    g.add_argument("--max_queue", type=int, default=0,
                   help="per-replica queue bound (0 = unbounded; bounded "
                        "queues exercise affinity spill)")
    g = p.add_argument_group("loadgen")
    g.add_argument("--num_requests", type=int, default=32,
                   help="synthetic request count")
    g.add_argument("--arrival", choices=["poisson", "burst"],
                   default="poisson", help="arrival process")
    g.add_argument("--rate", type=float, default=8.0,
                   help="mean arrivals/sec (poisson)")
    g.add_argument("--prompt_len_min", type=int, default=8,
                   help="min synthetic prompt length")
    g.add_argument("--prompt_len_max", type=int, default=64,
                   help="max synthetic prompt length")
    g.add_argument("--interleave", action="store_true",
                   help="alternate short/long prompts (prompt_len_min / "
                        "prompt_len_max) instead of uniform lengths")
    g.add_argument("--max_new_tokens", type=int, default=32,
                   help="generation budget per request")
    g.add_argument("--tenants", type=int, default=2,
                   help="tenant count (tenant = session affinity key)")
    g.add_argument("--shared_prefix_len", type=int, default=16,
                   help="tokens of shared system prefix (prefix-cache "
                        "routing needs shared pages to find)")
    g.add_argument("--seed", type=int, default=0,
                   help="workload + init seed")
    g = p.add_argument_group("observability")
    g.add_argument("--log_dir", default="serve_logs",
                   help="the router's metrics.jsonl goes here")
    g.add_argument("--trace_requests", action="store_true",
                   help="per-request timelines (not ported: refused)")
    g = p.add_argument_group("other")
    g.add_argument("--dry_run", action="store_true",
                   help="tiny config + tiny workload smoke run")
    args = p.parse_args(argv)
    if args.replicas < 1:
        p.error("--replicas must be >= 1")
    if args.tp_size != 1 or args.prefill_tp:
        p.error("--tp_size > 1 / --prefill_tp: fleet replicas over tp "
                "ranks (and the page stream's head reshard) are not ported "
                "yet, see ROADMAP Queue 1 item 6")
    if args.restart_tp:
        p.error("--restart_tp: restarting a replica at another width needs "
                "the reshard planner, not ported yet, see ROADMAP Queue 1 "
                "item 7")
    if args.trace_requests:
        p.error("--trace_requests: request tracing is not ported yet, see "
                "ROADMAP Queue 1 item 8")
    if not args.dry_run and not args.random_init and not args.ckpt_dir:
        p.error("need --ckpt_dir, or --random_init, or --dry_run")
    # what serve.py's model loader reads: the llama family, cp 1
    args.family, args.cp, args.paged = "llama", 1, False
    return args


def _engine(args, cfg, mesh, buf_len: int, prefill_only=False) -> PagedEngine:
    """One replica: its own copy of the model (from `--seed` or the
    checkpoint) and its own page pool."""
    classes = parse_slo_classes(args.class_mix) if args.class_mix else None
    return PagedEngine(
        _load_model(args, cfg, mesh), mesh, num_slots=args.slots,
        buf_len=buf_len, eos_id=args.eos_id, page_size=args.page_size,
        num_pages=args.num_pages, prefill_chunk=args.prefill_chunk,
        kv_dtype=None if args.kv_dtype == "native" else args.kv_dtype,
        slo_classes=classes, max_queue=args.max_queue,
        prefill_only=prefill_only)


def run(args: argparse.Namespace) -> Tuple[dict, dict]:
    """Build the fleet and serve the workload: (summary, fleet), where
    `fleet` holds the engines by name and, for the router fleet, the
    router; for `--disagg`, `done` (every completed request)."""
    cfg = _model_config(args)
    if args.dry_run:
        args.replicas = min(args.replicas, 2)
        args.num_requests, args.arrival = 8, "burst"
        args.prompt_len_min, args.prompt_len_max = 4, 12
        args.max_new_tokens = min(args.max_new_tokens, 8)
        args.slots, args.buf_len = 4, 0        # buf_len fits the workload
        args.page_size, args.prefill_chunk = 8, 8
        args.shared_prefix_len = 8             # one full shared page
        if not args.class_mix:
            args.class_mix = "interactive=1,standard=1"
    mix = parse_slo_classes(args.class_mix) if args.class_mix else None
    requests = synthetic_requests(
        args.num_requests, args.prompt_len_min, args.prompt_len_max,
        args.max_new_tokens, cfg.vocab_size, seed=args.seed,
        rate=args.rate, arrival=args.arrival, class_mix=mix,
        tenants=args.tenants, shared_prefix_len=args.shared_prefix_len,
        interleave=args.interleave)
    longest = max(len(r.prompt) for r in requests)
    buf_len = args.buf_len or (longest + args.max_new_tokens + 2)
    try:
        mesh = make_mesh(MeshConfig(), device=args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"serve_fleet: {e}")
    device = (torch.cuda.get_device_name(mesh.device)
              if mesh.device.type == "cuda" else "cpu")
    if args.disagg:
        pre = _engine(args, cfg, mesh, buf_len, prefill_only=True)
        dec = _engine(args, cfg, mesh, buf_len)
        engines = [pre, dec]
        summary = run_disaggregated(pre, dec, requests)
        done = summary.pop("completed")
        ms = lambda vals, q: _pctl([v and v * 1e3 for v in vals], q)
        summary.update({
            "mode": "disagg", "prefill_tp": 1, "decode_tp": 1,
            "completed": len(done),
            "generated_tokens": sum(len(r.tokens) for r in done),
            "page_bytes": page_bytes(
                cfg, args.page_size,
                None if args.kv_dtype == "native" else args.kv_dtype),
            "ttft_ms_p50": ms([r.ttft_s for r in done], 50),
            "ttft_ms_p95": ms([r.ttft_s for r in done], 95),
            "tpot_ms_p50": ms([r.tpot_s for r in done], 50),
            "tpot_ms_p95": ms([r.tpot_s for r in done], 95),
        })
        fleet = {"prefill": pre, "decode": dec, "done": done}
    else:
        replicas = [(f"r{i}", _engine(args, cfg, mesh, buf_len))
                    for i in range(args.replicas)]
        engines = [e for _, e in replicas]
        with MetricsWriter(args.log_dir, process_index=0) as writer:
            router = FleetRouter(replicas, prefix_weight=args.prefix_weight,
                                 load_weight=args.load_weight,
                                 pool_weight=args.pool_weight, writer=writer)
            summary = run_fleet_loadgen(router, requests)
        summary["mode"] = "fleet"
        fleet = {**dict(replicas), "router": router}
    summary["device"] = device
    share = dropped_share(e.model for e in engines)
    if share is not None:
        summary["moe_dropped_share"] = share
    return summary, fleet


def _report(args: argparse.Namespace, summary: dict) -> None:
    """The JSON record on stdout and the human line on stderr."""
    if args.disagg:
        metric, unit = "serve_fleet --disagg", "pages transferred"
        value = summary["transferred_pages"]
    else:
        metric, unit = (f"serve_fleet x{args.replicas}",
                        "tokens/sec (fleet)")
        value = summary["fleet_tokens_per_sec"]
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      **summary}))
    keys = ("completed", "rejected", "fleet_tokens_per_sec",
            "dispatch_ms_p50", "session_spills", "ttft_ms_p95",
            "tpot_ms_p95", "transfer_ms_p95", "bytes_per_request")
    human = ", ".join(f"{k}={summary[k]}" for k in keys if k in summary)
    print(f"serve_fleet [{summary['mode']} on {summary['device']}]: {human}",
          file=sys.stderr)


def main(argv=None) -> dict:
    args = parse_args(argv)
    summary, _ = run(args)
    _report(args, summary)
    return summary


if __name__ == "__main__":
    main()
