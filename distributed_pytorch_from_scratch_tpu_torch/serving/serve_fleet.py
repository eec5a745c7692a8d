"""serve_fleet: the serving fleet's front door (the port's counterpart of the
JAX `scripts/serve_fleet.py`).

    python -m distributed_pytorch_from_scratch_tpu_torch.serving.serve_fleet \\
        --dry_run --device cpu                   # a tiny smoke run
    python -m distributed_pytorch_from_scratch_tpu_torch.serving.serve_fleet \\
        --dry_run --device cpu --disagg
    python -m distributed_pytorch_from_scratch_tpu_torch.serving.serve_fleet \\
        --dry_run --device cpu --dist_backend gloo --tp_size 2 \\
        [--restart_tp 1 | --disagg --prefill_tp 1]
    python -m distributed_pytorch_from_scratch_tpu_torch.serving.serve_fleet \\
        --model 45m --random_init --replicas 2 --num_requests 64

Builds N `PagedEngine` replicas of one llama model behind a `FleetRouter`
(prefix-cache-aware scored dispatch, session affinity by tenant, a loud
spill) and drives them with the loadgen's arrival stream
(`loadgen.run_fleet_loadgen`); or, with `--disagg`, a prefill-only engine
and a decode engine joined by the KV page stream (`serving/transfer.py`:
the prefill side in a thread of its own, every finished prompt's pages
exported, framed, read back and imported by the decode side, which decodes
on as it would colocated). The engines' weights come from `--random_init`
(drawn from `--seed`, the same in every engine at any tp) or `--ckpt_dir`
(either package's trainer, any tp), through `serve.py`'s loader; they
attend through the CUDA paged-attention kernels. Runs on `cuda:0` unless
`--device cpu` is given; with no card and no `--device cpu` it exits
non-zero.

Tensor parallelism: each replica runs at `--tp_size` (`--disagg`: the
prefill engine at `--prefill_tp`, default `--tp_size`, the decode engine
at `--tp_size`). The run spawns as many rank processes as the widest
engine needs (`runtime/launch.spawn`, transport `--dist_backend`); an
engine of width w holds its w shards on ranks 0 .. w - 1, with a process
group of its own (`runtime/mesh.tp_submesh`) over which rank 0 broadcasts
its dispatches (`serving/tp_dispatch.py`). Rank 0 runs the router, the
loadgen and every engine's host loop; every other rank runs one serving
thread per engine it holds a shard of, so two engines that dispatch at
once (the disaggregated prefill thread and decode loop) never wait on
each other's group. The page stream's payload is JAX's, the global heads:
the exporting engine gathers every rank's heads to rank 0, the importing
one broadcasts them and each rank keeps its own (`PagedKVPool`).

`--restart_tp W` serves the workload in two waves: after the first, the
replica `--restart_replica` restarts at tp W. Its live weights move to the
new width leaf by leaf (`reshard/apply.reshard_params`, planned by
`reshard/plan.plan_reshard`), a new engine is built on them and attached
under the old name (`FleetRouter.replace_replica`, whose `replica_restart`
event carries the plan's summary), and the second wave runs against the
fleet of two widths. Refused where the padded vocab differs between the
widths (JAX's message).

Prints one JSON record on stdout and a human summary on stderr. The
fleet's record: fleet tokens/s, TTFT / TPOT / queue wait p50 and p95, the
router's dispatch ms, session spills, `per_replica` and
`fleet_slo_attainment` (the replicas' live per-class counters folded,
completion-weighted); with `--restart_tp`, `restart` (the plan's summary,
its wall ms and the bytes the reshard hops carried) and `mode:
fleet+restart`. `--disagg`'s: the pages and bytes transferred, bytes per
request, transfer ms p50 and p95 (send start -> decode-side admit),
`prefill_tp` and `decode_tp`, and each handoff under `transfers`. Past one
rank the summary adds `ranks`: each rank's dispatches per engine, its
page-stream and reshard hops and its kernel launches.

Observability, as JAX's: `--log_dir` receives one metrics stream per hop
(the router's `metrics.jsonl`, replica i's `metrics.proc<i+1>.jsonl`; the
disaggregated prefill and decode engines' `proc1` and `proc2`), each with
a headless telemetry exporter whose last snapshot lands at the end;
`--trace_requests` gives every hop a request tracer, so each request's
timeline runs router -> replica (`route`), or prefill -> decode
(`handoff`, `kv_import`), across the streams (`obs/reqtrace.merge_traces`
joins them). Only rank 0 writes. The JAX record's `transfer_pricing` (a
TPU interconnect's price of the bytes) and run stamp are left out: the
record carries the bytes and milliseconds this run measured.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..cli import add_model_shape_args
from ..config import MeshConfig
from ..models import build_model
from ..models.transformer import validate_tp
from ..obs.reqtrace import RequestTracer
from ..obs.telemetry import TelemetryExporter
from ..ops import collectives
from ..ops.collectives import RESHARD, broadcast_ints
from ..ops.cuda import launch_counts
from ..ops.cuda.paged_attention import paged_attention
from ..parallel.moe import dropped_share
from ..reshard.apply import HostMeter, live_plan, reshard_params
from ..runtime import launch
from ..runtime.mesh import (dist_backend, make_mesh, resolve_device,
                            tp_submesh)
from ..training.metrics import MetricsWriter
from .engine import PagedEngine
from .kv_manager import page_bytes
from .loadgen import _pctl, run_fleet_loadgen, synthetic_requests
from .router import FleetRouter
from .scheduler import parse_slo_classes
from .serve import _load_model, _model_config
from .transfer import run_disaggregated

# the fleet's control messages from rank 0 to the other ranks' main threads
_DONE, _RESTART = 0, 1


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
                   help="tp width of the --disagg prefill engine "
                        "(0 = same as --tp_size; the page stream "
                        "reshards heads)")
    g.add_argument("--restart_tp", type=int, default=0,
                   help="mid-run, restart one replica at this tp width: "
                        "half the workload runs, the replica's live "
                        "weights reshard to the new width, and the rest "
                        "runs against the fleet of two widths (0 = off)")
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
                   help="tensor-parallel width per replica")
    g.add_argument("--tokenizer_path", "-t", default=None,
                   help="supplies vocab_size and the real EOS id; omit to "
                        "use --vocab_size and EOS id 1")
    g.add_argument("--vocab_size", type=int, default=1024,
                   help="vocab for --random_init without a tokenizer")
    add_model_shape_args(g)
    g = p.add_argument_group("engine")
    g.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    g.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="past one rank: the ranks' transport (default: "
                        "nccl on cuda, gloo on cpu); nccl needs one card "
                        "per rank, gloo stages a card's tensors through "
                        "host memory")
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
                   help="metrics output dir (one stream per hop)")
    g.add_argument("--trace_requests", action="store_true",
                   help="per-request timelines on every hop (router + "
                        "replicas; request_trace events)")
    g = p.add_argument_group("other")
    g.add_argument("--dry_run", action="store_true",
                   help="tiny config + tiny workload smoke run")
    args = p.parse_args(argv)
    if args.replicas < 1:
        p.error("--replicas must be >= 1")
    if args.prefill_tp and not args.disagg:
        p.error("--prefill_tp is a --disagg knob (the router fleet's "
                "replicas share --tp_size)")
    if args.restart_tp and args.disagg:
        p.error("--restart_tp restarts a router-fleet replica; it does "
                "not compose with --disagg")
    if args.restart_tp < 0:
        p.error("--restart_tp must be >= 0")
    if not args.dry_run and not args.random_init and not args.ckpt_dir:
        p.error("need --ckpt_dir, or --random_init, or --dry_run")
    # what serve.py's model loader reads: the llama family, cp 1
    args.family, args.cp, args.paged = "llama", 1, False
    return args


def widths(args) -> Dict[str, int]:
    """Every engine's tp width, by name, in the one order every rank
    builds them (the restart slot last)."""
    if args.disagg:
        return {"prefill": args.prefill_tp or args.tp_size,
                "decode": args.tp_size}
    out = {f"r{i}": args.tp_size for i in range(args.replicas)}
    if args.restart_tp:
        out["restart"] = args.restart_tp
    return out


def _shrink_dry(args) -> None:
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


def _workload(args, cfg):
    """(requests, buf_len): the same on every rank (drawn from --seed)."""
    mix = parse_slo_classes(args.class_mix) if args.class_mix else None
    requests = synthetic_requests(
        args.num_requests, args.prompt_len_min, args.prompt_len_max,
        args.max_new_tokens, cfg.vocab_size, seed=args.seed,
        rate=args.rate, arrival=args.arrival, class_mix=mix,
        tenants=args.tenants, shared_prefix_len=args.shared_prefix_len,
        interleave=args.interleave)
    longest = max(len(r.prompt) for r in requests)
    return requests, args.buf_len or (longest + args.max_new_tokens + 2)


def _engine(args, model, mesh, buf_len: int, prefill_only=False,
            **obs) -> PagedEngine:
    """One replica over `model` (this rank's shard) and its own pool."""
    classes = parse_slo_classes(args.class_mix) if args.class_mix else None
    return PagedEngine(
        model, mesh, num_slots=args.slots, buf_len=buf_len,
        eos_id=args.eos_id, page_size=args.page_size,
        num_pages=args.num_pages, prefill_chunk=args.prefill_chunk,
        kv_dtype=None if args.kv_dtype == "native" else args.kv_dtype,
        slo_classes=classes, max_queue=args.max_queue,
        prefill_only=prefill_only, **obs)


class _FleetObs:
    """JAX's per-hop obs: one MetricsWriter per process index (the router
    0, the replicas 1..), each with a headless TelemetryExporter and, with
    `--trace_requests`, a RequestTracer. Rank 0 only."""

    def __init__(self, args):
        self.args = args
        self.writers, self.exporters = [], []

    def hooks(self, process_index: int) -> dict:
        w = MetricsWriter(self.args.log_dir, process_index=process_index)
        self.writers.append(w)
        tel = TelemetryExporter(writer=w, process_index=process_index)
        self.exporters.append(tel)
        rt = (RequestTracer(writer=w, process_index=process_index)
              if self.args.trace_requests else None)
        return {"writer": w, "telemetry": tel, "request_tracer": rt}

    def close(self) -> None:
        for tel in self.exporters:
            tel.close()
        for w in self.writers:
            w.close()


class FleetRanks:
    """The fleet's engines over the ranks of `base` (one rank: all on rank
    0's one-rank meshes). `add` builds an engine of a width on its ranks;
    the other ranks serve its dispatches from a thread each (`serve` runs
    their main thread until rank 0's `close`); `restart` re-lays a live
    engine's weights at another width (every rank runs it: rank 0 asks
    the others through a control message first).

    `make_model(mesh)`: this rank's shard of the model on `mesh` with its
    weights; `shell(mesh)`: the same model's shard without them (a
    restart's target); `build(model, mesh, name, **hooks)`: the engine
    (`hooks`: rank 0's obs objects for it, none elsewhere)."""

    def __init__(self, base, make_model: Callable, shell: Callable,
                 build: Callable, obs: Optional[_FleetObs] = None):
        self.base = base
        self.leader = base.rank == 0
        self.make_model, self.shell, self.build = make_model, shell, build
        self.obs = obs
        self.engines: Dict[str, Optional[PagedEngine]] = {}
        self.meshes: Dict[str, object] = {}
        self.widths: Dict[str, int] = {}
        self.threads: Dict[str, threading.Thread] = {}
        self.errors: list = []
        self.retired: list = []            # engines a restart replaced

    def _hooks(self, index: int) -> dict:
        return self.obs.hooks(index) if self.obs and self.leader else {}

    def mesh(self, name: str, width: int) -> None:
        """The engine slot `name`'s mesh (a collective: every rank, one
        order), built now, its engine later."""
        self.meshes[name] = tp_submesh(self.base, width)
        self.widths[name] = width

    def add(self, name: str, index: int, model=None,
            prefill_only: bool = False) -> Optional[PagedEngine]:
        mesh = self.meshes[name]
        if mesh is None:
            self.engines[name] = None
            return None
        model = model if model is not None else self.make_model(mesh)
        eng = self.build(model, mesh, name, prefill_only=prefill_only,
                         **self._hooks(index))
        self.engines[name] = eng
        if not self.leader:
            t = threading.Thread(target=self._serve_one, args=(eng,),
                                 name=f"fleet-{name}", daemon=True)
            self.threads[name] = t
            t.start()
        return eng

    def _serve_one(self, eng) -> None:
        try:
            eng.dispatch.serve()
        except BaseException as e:          # raised again by `serve`
            self.errors.append(e)

    def _control(self, kind: int = 0, width: int = 0, slot: int = 0):
        msg = torch.tensor([kind, width, slot], dtype=torch.int32)
        return broadcast_ints(msg, self.base, "world").tolist()

    def serve(self) -> None:
        """A worker's main thread: follow rank 0's control messages until
        it closes the fleet; then join the serving threads."""
        names = list(self.engines)
        while True:
            kind, width, slot = self._control()
            if kind == _DONE:
                break
            self.restart(names[slot], width)
        for t in self.threads.values():
            t.join()
        if self.errors:
            raise self.errors[0]

    def restart(self, name: str, width: int,
                index: int = 0) -> Optional[dict]:
        """Re-lay engine `name`'s live weights at tp `width` on the restart
        slot's ranks, stop the old engine and build the new one there.
        Returns (rank 0) the plan's summary with the wall ms, and the
        hops' calls, bytes and host ms."""
        old = self.engines[name]
        if self.leader:
            self._control(_RESTART, width, list(self.engines).index(name))
        src_tp = self.widths[name]
        mesh = self.meshes["restart"]
        t0 = time.perf_counter()
        hops0 = dict(collectives.stats[RESHARD])
        new = self.shell(mesh) if mesh is not None else None
        state = old.model.state_dict() if old is not None else None
        keys = sorted((new.state_dict() if new is not None
                       else state).keys())
        meter = HostMeter()
        dev = (mesh or self.meshes[name]).device
        new_state = reshard_params(state, keys, self.base, src_tp, width,
                                   dev, meter)
        if new is not None:
            new.load_state_dict(new_state)
            new = new.to(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        if old is not None:
            if self.leader:
                old.dispatch.stop()
            else:
                self.threads.pop(name).join()
            self.retired.append(old)
        del old, state, new_state
        self.meshes[name], self.widths[name] = mesh, width
        eng = self.add(name, index, model=new)
        if not self.leader:
            return None
        hops = {k: collectives.stats[RESHARD][k] - hops0[k]
                for k in ("calls", "bytes", "hop_s")}
        return {"wall_ms": round(wall_ms, 3), "peak_host_bytes": meter.peak,
                "hop_calls": hops["calls"], "hop_bytes": hops["bytes"],
                "hop_ms": round(hops["hop_s"] * 1e3, 3), "engine": eng}

    def close(self) -> None:
        """Rank 0: end every engine's serving threads and the workers'
        control loop."""
        if not self.leader:
            return
        for eng in self.engines.values():
            if eng is not None:
                eng.dispatch.stop()
        if self.base.world > 1:
            self._control(_DONE)


def _restart(args, cfg, fleet: FleetRanks, router) -> dict:
    """Rank 0's side of `--restart_tp`: plan, re-lay, attach. Returns the
    `restart` record: the plan's summary and wall ms (the JAX record),
    plus `hops` (the reshard hops' calls, bytes, host ms, and the host
    staging peak)."""
    name, new_tp = args.restart_replica, args.restart_tp
    old = router._engine(name)
    plan = live_plan(old.model.state_dict(), old.model.tp_size, new_tp)
    got = fleet.restart(name, new_tp, index=args.replicas + 1)
    eng = got.pop("engine")
    info = dict(plan.summary(), wall_ms=got.pop("wall_ms"))
    router.replace_replica(name, eng, reshard=info)
    print(f"replica {name} restarted at tp{new_tp}: {info['src']} -> "
          f"{info['dst']}, {info['bytes_moved']} bytes planned, "
          f"{got['hop_bytes']} bytes on the hops, {info['wall_ms']} ms",
          file=sys.stderr)
    return dict(info, hops=got)


def _serve_ranks(args, cfg, base) -> Tuple[dict, dict]:
    """One rank of the fleet over `base` (see the module docstring): rank 0
    returns (summary, fleet), the others ({}, the engines they served)
    once rank 0 is done. `fleet` holds the engines by name (the retired
    ones under `retired`), the router or, for `--disagg`, `done` (every
    completed request)."""
    requests, buf_len = _workload(args, cfg)
    obs = _FleetObs(args)
    fleet = FleetRanks(
        base, lambda mesh: _load_model(args, cfg, mesh),
        lambda mesh: build_model(args.family, cfg, mesh=mesh),
        lambda model, mesh, name, **kw: _engine(args, model, mesh, buf_len,
                                                **kw), obs)
    try:
        for name, width in widths(args).items():
            fleet.mesh(name, width)
        hooks = obs.hooks(0) if fleet.leader and not args.disagg else {}
        if args.disagg:
            pre = fleet.add("prefill", 1, prefill_only=True)
            dec = fleet.add("decode", 2)
        else:
            for i in range(args.replicas):
                fleet.add(f"r{i}", i + 1)
        if not fleet.leader:
            fleet.serve()
            return {}, {**{k: e for k, e in fleet.engines.items() if e},
                        "retired": fleet.retired}
        try:
            summary, out = _lead(args, cfg, fleet, requests, hooks,
                                 pre if args.disagg else None,
                                 dec if args.disagg else None)
        finally:
            fleet.close()
    finally:
        obs.close()
    return summary, out


def _lead(args, cfg, fleet, requests, hooks, pre, dec):
    engines = fleet.engines
    if args.disagg:
        summary = run_disaggregated(pre, dec, requests)
        done = summary.pop("completed")
        ms = lambda vals, q: _pctl([v and v * 1e3 for v in vals], q)
        summary.update({
            "mode": "disagg", "prefill_tp": widths(args)["prefill"],
            "decode_tp": args.tp_size,
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
        out = {"prefill": pre, "decode": dec, "done": done}
    else:
        replicas = [(f"r{i}", engines[f"r{i}"]) for i in range(args.replicas)]
        router = FleetRouter(replicas, prefix_weight=args.prefix_weight,
                             load_weight=args.load_weight,
                             pool_weight=args.pool_weight,
                             writer=hooks["writer"],
                             telemetry=hooks["telemetry"],
                             request_tracer=hooks["request_tracer"])
        if args.restart_tp:
            # two waves around the restart: the second runs against a
            # fleet whose restarted replica is another width
            half = max(1, len(requests) // 2)
            wave_a = run_fleet_loadgen(router, requests[:half])
            restart = _restart(args, cfg, fleet, router)
            summary = run_fleet_loadgen(router, requests[half:])
            summary["completed"] = (summary.get("completed", 0)
                                    + wave_a.get("completed", 0))
            summary["wave_a_completed"] = wave_a.get("completed", 0)
            summary["restart"] = restart
            summary["mode"] = "fleet+restart"
        else:
            summary = run_fleet_loadgen(router, requests)
            summary["mode"] = "fleet"
        out = {**dict(router.replicas), "router": router,
               "retired": fleet.retired}
    live = [e for e in engines.values() if e is not None]
    share = dropped_share(e.model for e in live + fleet.retired)
    if share is not None:
        summary["moe_dropped_share"] = share
    return summary, out


def _engines(fleet_out: dict) -> Dict[str, PagedEngine]:
    """The engines a rank held, by name (a restart's replaced ones as
    `retired<i>`)."""
    engines = {k: e for k, e in fleet_out.items()
               if isinstance(e, PagedEngine)}
    for i, e in enumerate(fleet_out.get("retired", ())):
        engines[f"retired{i}"] = e
    return engines


def drained(eng: PagedEngine) -> bool:
    """Every page of the engine's pool free, no reference or index entry
    left, no handoff staged."""
    pool = eng.pool
    return bool(pool.free_pages == pool.num_pages and not pool.refcount.any()
                and not pool._page_keys and not eng.handoffs)


def _rank_record(base, fleet_out: dict, launches0, paged0) -> dict:
    """One rank's hops, dispatches per engine and kernel launches (K3's by
    route and by kernel too); rank 0's also whether each engine's pool
    drained."""
    engines = _engines(fleet_out)
    delta = lambda now, then: {k: v - then.get(k, 0) for k, v in now.items()}
    rec = {"rank": base.rank,
            "dispatches": {k: e.dispatch.counts for k, e in engines.items()},
            "dispatch_shapes": {
                k: sorted([kind, list(shape), n] for (kind, shape), n
                          in e.dispatch.shapes.items())
                for k, e in engines.items()},
            "tp_hops": dict(collectives.stats["tp"]),
            "kv_gather": dict(collectives.stats["kv_gather"]),
            "kv_scatter": dict(collectives.stats["kv_scatter"]),
            "reshard": dict(collectives.stats["reshard"]),
            "dispatch_broadcasts": dict(collectives.stats["dispatch"]),
            "launches": delta(launch_counts(), launches0),
            "paged_by_route": delta(paged_attention.launches_by_route,
                                    paged0[0]),
            "paged_by_kernel": delta(paged_attention.launches_by_kernel,
                                     paged0[1])}
    if base.rank == 0:
        rec["drained"] = {k: drained(e) for k, e in engines.items()}
    return rec


def _rank_main(rank: int, nprocs: int, init_method: str,
               args: argparse.Namespace, cfg) -> dict:
    """One rank of a multi-rank fleet (`runtime/launch.spawn` calls it):
    rank 0's summary and every rank's record; rank 0's also `outputs`
    ({rid: generated ids})."""
    base = make_mesh(MeshConfig(tp=nprocs), device=args.device, rank=rank,
                     backend=args.dist_backend, init_method=init_method)
    collectives.reset_stats()
    launches0 = launch_counts()
    paged0 = (dict(paged_attention.launches_by_route),
              dict(paged_attention.launches_by_kernel))
    summary, out = _serve_ranks(args, cfg, base)
    rec = _rank_record(base, out, launches0, paged0)
    if rank != 0:
        return {"rank": rec}
    done = (out["done"] if "done" in out else
            [r for e in _engines(out).values() for r in e.completed])
    return {"summary": summary, "rank": rec,
            "outputs": {r.rid: list(r.tokens) for r in done}}


def run(args: argparse.Namespace) -> Tuple[dict, dict]:
    """Build the fleet and serve the workload: (summary, fleet). On one
    rank `fleet` holds the engines by name and, for the router fleet, the
    router (and `retired`: the engines a restart replaced); for `--disagg`,
    `done` (every completed request). Past one rank the engines live in
    the rank processes: `fleet` holds `outputs` ({rid: tokens}) and
    `ranks`, and the summary `ranks` too."""
    cfg = _model_config(args)
    _shrink_dry(args)
    world = max(widths(args).values())
    if args.restart_tp:
        old, new = args.tp_size, args.restart_tp
        if cfg.padded_vocab_size(old) != cfg.padded_vocab_size(new):
            raise SystemExit(
                f"--restart_tp {new}: vocab padding differs between tp"
                f"{old} ({cfg.padded_vocab_size(old)}) and tp{new} "
                f"({cfg.padded_vocab_size(new)}) — the live trees have "
                f"different shapes; restart from a checkpoint instead")
    try:
        dev = resolve_device(args.device)
        for w in set(widths(args).values()):
            validate_tp(cfg, w)
        if world > 1:
            dist_backend(args.dist_backend, dev, world)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"serve_fleet: {e}")
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if world == 1:
        summary, fleet = _serve_ranks(args, cfg,
                                      make_mesh(MeshConfig(), device=dev))
    else:
        outs = launch.spawn(_rank_main, world, args, cfg)
        summary = dict(outs[0]["summary"], ranks=[o["rank"] for o in outs])
        fleet = {"outputs": outs[0]["outputs"], "ranks": summary["ranks"]}
    summary["device"] = device
    return summary, fleet


def _report(args: argparse.Namespace, summary: dict) -> None:
    """The JSON record on stdout and the human line on stderr."""
    if args.disagg:
        metric, unit = "serve_fleet --disagg", "pages transferred"
        value = summary["transferred_pages"]
    else:
        metric = f"serve_fleet x{args.replicas}" + (
            f" restart@tp{args.restart_tp}" if args.restart_tp else "")
        unit, value = "tokens/sec (fleet)", summary["fleet_tokens_per_sec"]
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
