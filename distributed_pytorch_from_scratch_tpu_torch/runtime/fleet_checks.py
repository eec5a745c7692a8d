"""Rank programs of the serving fleet's checks at tp > 1 (run by
`runtime/launch.spawn` from the tests and from `chip_smoke.py`; they import
no jax). Each job takes the group's base mesh (`make_mesh(MeshConfig(tp=
nprocs))`) and returns, on rank 0, what the caller compares; the other
ranks return what they ran.

* `pool_cases`: `PagedKVPool.import_pages` then `export_pages` on pools
  sharded over tp or cp, every rank in lockstep (the exports' payloads,
  the pages leased, a rollback on PoolExhausted).
* `fleet_runs`: the router fleet, the disaggregated pair at (prefill tp,
  decode tp) and the router fleet with a replica restarted at another
  width, through `serve_fleet.FleetRanks`, on weights from a JAX tree.
* `reshard_leaves`: `reshard/apply.reshard_params` of a tree's model from
  one tp width to another: each rank's new shards.
"""

from __future__ import annotations

import json
import os
import tempfile
from types import SimpleNamespace
from typing import Dict, List, Sequence

from ..config import MeshConfig, ModelConfig
from ..interop import params_from_jax, tree_family
from ..models import build_model
from ..ops import collectives
from ..reshard.apply import live_plan, reshard_params
from ..serving import transfer
from ..serving.engine import PagedEngine, Request
from ..serving.kv_manager import PagedKVPool, PoolExhausted
from ..serving.router import FleetRouter
from ..serving.serve_fleet import FleetRanks, drained
from ..training.metrics import MetricsWriter
from .mesh import make_mesh, tp_submesh


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(t) for t in x)
    return x.numpy()


def pool_cases(base, cfg: Dict, cases: Sequence[Dict]) -> List:
    """Each case {tp, cp, kv, num_pages, page_size, k, v, owners, big}:
    the pool at tp x cp on the first ranks (a tp-only pool on its tp
    submesh, a cp pool on a cp mesh of the whole group), every rank
    importing the payload (k, v) with `owners` and exporting the pages it
    got; with `big`, a payload too large for the pool afterwards. Rank 0
    returns {pages, export, free, free_after_big, raised}."""
    out = []
    for case in cases:
        tp, cp = case["tp"], case["cp"]
        mesh = (make_mesh(MeshConfig(cp=cp), device=base.device,
                          rank=base.rank, backend=base.backend)
                if cp > 1 else tp_submesh(base, tp))
        if mesh is None:
            out.append(None)
            continue
        mcfg = ModelConfig(**cfg)
        model = SimpleNamespace(cfg=mcfg, cp_size=cp,
                                num_local_kv_heads=mcfg.kv_heads // tp)
        pool = PagedKVPool(model, mesh, case["num_pages"], case["page_size"],
                           kv_dtype=case["kv"])
        pages = pool.import_pages(case["k"], case["v"], case["owners"])
        got = pool.export_pages(pages)
        res = {"pages": pages, "free": pool.free_pages,
               "export": None if got is None else _np(got)}
        if case.get("big") is not None:
            try:
                pool.import_pages(*case["big"])
                res["raised"] = False
            except PoolExhausted:
                res["raised"] = True
            res["free_after_big"] = pool.free_pages
        out.append(res if base.rank == 0 else {"pages": pages})
    return out


def _model_from(tree, cfg: Dict, seed: int = 0):
    """`make_model(mesh)`: the model of the JAX `tree` (None: the llama
    model drawn from `seed`, the same at any tp), this rank's shard, on
    the mesh's device."""
    def make(mesh):
        model = build_model(tree_family(tree) if tree else "llama",
                            ModelConfig(**cfg), mesh=mesh)
        if tree is None:
            model.init_weights(seed)
        else:
            model.load_state_dict(params_from_jax(tree, mesh.tp,
                                                  mesh.tp_rank))
        return model.to(mesh.device)
    return make


def _requests(run) -> List[Request]:
    return [Request(rid=run.get("rid0", 0) + i, prompt=list(p), max_new=m)
            for i, (p, m) in enumerate(run["requests"])]


def _tokens(reqs) -> Dict[int, List[int]]:
    return {r.rid: list(r.tokens) for r in reqs}


def _ranks_record(fleet: FleetRanks) -> Dict:
    engines = {n: e for n, e in fleet.engines.items() if e is not None}
    for i, e in enumerate(fleet.retired):
        engines[f"retired{i}"] = e
    return {n: {"counts": e.dispatch.counts,
                "shapes": sorted((k, list(s), c) for (k, s), c
                                 in e.dispatch.shapes.items())}
            for n, e in engines.items()}


def _taped_disagg(pre, dec, reqs):
    """`run_disaggregated` with every frame's blobs recorded as sent:
    [(dtype, shape, nbytes) per blob] per frame."""
    frames = []
    send = transfer.send_frame

    def taped(sock, header, blobs):
        frames.append([(str(b.dtype).replace("torch.", ""),
                        list(b.shape), b.numel() * b.element_size())
                       for b in blobs])
        return send(sock, header, blobs)

    transfer.send_frame = taped
    try:
        res = transfer.run_disaggregated(pre, dec, reqs)
    finally:
        transfer.send_frame = send
    return res, frames


def fleet_runs(base, cfg: Dict, tree, runs: Sequence[Dict],
               engine_kw: Dict, seed: int = 0) -> List[Dict]:
    """Each run {kind: fleet | disagg | restart, requests: [(prompt,
    max_new)], and per kind: tp (fleet), prefill_tp / decode_tp / kv
    (disagg), tp / restart_tp / requests2 (restart)}: the engines built
    by `FleetRanks` on `tree`'s weights (None: drawn from `seed`) with
    `engine_kw`, rank 0 driving.
    Rank 0 returns tokens, the router's dispatches or the transfer
    accounting and the taped frames, whether every engine drained, the
    ranks' dispatch counts per engine, and for a restart the
    `replica_restart` event and the hop bytes; the other ranks their
    dispatch counts."""
    out = []
    make = _model_from(tree, cfg, seed)
    shell = lambda mesh: build_model(tree_family(tree) if tree else "llama",
                                     ModelConfig(**cfg), mesh=mesh)
    for run in runs:
        kind = run["kind"]
        kw = dict(engine_kw, kv_dtype=run.get("kv"))
        fleet = FleetRanks(base, make, shell,
                           lambda model, mesh, name, **more: PagedEngine(
                               model, mesh, **kw, **more))
        if kind == "disagg":
            fleet.mesh("prefill", run["prefill_tp"])
            fleet.mesh("decode", run["decode_tp"])
            pre = fleet.add("prefill", 1, prefill_only=True)
            dec = fleet.add("decode", 2)
        else:
            names = ("r0", "r1")
            for n in names:
                fleet.mesh(n, run["tp"])
            if kind == "restart":
                fleet.mesh("restart", run["restart_tp"])
            for i, n in enumerate(names):
                fleet.add(n, i + 1)
        if not fleet.leader:
            fleet.serve()
            out.append({"ranks": _ranks_record(fleet)})
            continue
        res = {}
        try:
            if kind == "disagg":
                summary, frames = _taped_disagg(pre, dec, _requests(run))
                res.update(tokens=_tokens(summary["completed"]),
                           frames=frames,
                           pages=summary["transferred_pages"],
                           transfers=[t["pages"]
                                      for t in summary["transfers"]],
                           drained=[drained(pre), drained(dec)])
            else:
                res.update(_route(fleet, run))
        finally:
            fleet.close()
        res["ranks"] = _ranks_record(fleet)
        out.append(res)
    return out


def _route(fleet: FleetRanks, run: Dict) -> Dict:
    """Rank 0's router fleet: the requests submitted at once and served
    to the end; for a restart, r1 restarted at `restart_tp` through the
    planner, then `requests2`."""
    with tempfile.TemporaryDirectory() as logs:
        writer = MetricsWriter(logs, process_index=0)
        router = FleetRouter([(n, fleet.engines[n]) for n in ("r0", "r1")],
                             prefix_weight=run.get("prefix_weight", 0.5),
                             writer=writer)
        reqs = _requests(run)
        for r in reqs:
            router.submit(r)
        router.run_to_completion()
        res = {"tokens": _tokens(reqs), "dispatched": dict(router.dispatched)}
        if run["kind"] == "restart":
            old = fleet.engines["r1"]
            plan = live_plan(old.model.state_dict(), old.model.tp_size,
                             run["restart_tp"])
            hops0 = collectives.stats["reshard"]["bytes"]
            got = fleet.restart("r1", run["restart_tp"], index=3)
            info = dict(plan.summary(), wall_ms=got["wall_ms"])
            router.replace_replica("r1", got["engine"], reshard=info)
            before = dict(router.dispatched)
            reqs2 = _requests(dict(run, requests=run["requests2"],
                                   rid0=100))
            for r in reqs2:
                router.submit(r)
            router.run_to_completion()
            res["tokens"].update(_tokens(reqs2))
            res["served_after"] = (router.dispatched["r1"]
                                   - before["r1"])
            res["hop_bytes"] = (collectives.stats["reshard"]["bytes"]
                                - hops0)
        writer.close()
        events = [json.loads(line) for line in
                  open(os.path.join(logs, "metrics.jsonl"))]
    res["events"] = [e for e in events if e["tag"] == "replica_restart"]
    res["drained"] = [drained(e) for _, e in router.replicas]
    return res


def reshard_leaves(base, cfg: Dict, tree, src_tp: int,
                   dst_tp: int) -> Dict:
    """`reshard_params` of `tree`'s model from tp `src_tp` to `dst_tp`
    over the group: this rank's new state dict (numpy), or None past
    `dst_tp`."""
    src = tp_submesh(base, src_tp)
    state = (_model_from(tree, cfg)(src).state_dict() if src is not None
             else None)
    keys = sorted(build_model(tree_family(tree), ModelConfig(**cfg))
                  .state_dict())
    got = reshard_params(state, keys, base, src_tp, dst_tp, base.device)
    return None if got is None else {k: v.numpy() for k, v in got.items()}


def jobs(rank: int, nprocs: int, init_method: str, todo: Sequence,
         device: str = "cpu") -> List:
    """Run `todo`, a list of (job name, kwargs), on this rank of an
    nprocs group over gloo on `device`, each on the group's base mesh."""
    fns = {"pool_cases": pool_cases, "fleet_runs": fleet_runs,
           "reshard_leaves": reshard_leaves}
    out = []
    for name, kwargs in todo:
        base = make_mesh(MeshConfig(tp=nprocs), device=device, rank=rank,
                         backend="gloo", init_method=init_method)
        out.append(fns[name](base, **kwargs))
    return out
