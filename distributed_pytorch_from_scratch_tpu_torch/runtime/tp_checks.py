"""Rank programs that hold the tp, dp and sequence-parallel paths against a
reference, run through `runtime.launch.spawn` — by the tests (against the
JAX package, on the CPU) and by chip_smoke.py (the card's kernels against
the CPU's plain versions), as `runtime/cp_checks.py` serves the cp paths:
training (`collective_pairs`, `layer_cases`, `model_runs`,
`seed_identity`), serving at tp > 1 (`serve_runs`, `decode_logits`,
`quantized_params`) and the evaluation loss on any mesh (`doc_losses`).

`jobs(rank, nprocs, init_method, todo)` runs a list of `(name, axes,
kwargs)` jobs in one process group, one after the other, each on the mesh
its axes name over the group's nprocs ranks, and returns their results in
order.
Every job takes numpy inputs made by the caller and returns numpy results;
a model job's family is its JAX tree's (`interop.tree_family`: llama or
gpt2);
gradients come back per rank, as that rank's shard, for the caller to
assemble (`interop.assemble_params`).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import MeshConfig, ModelConfig, OptimizerConfig, resolve_dtype_on
from ..data.dataset import dp_rows
from ..interop import params_from_jax, tree_family
from ..models import decode
from ..models import build_model
from ..models.transformer import Transformer
from ..ops import collectives as C
from ..ops.quant import quantize_decode_params
from ..serving.engine import (ContinuousBatchingEngine, PagedEngine, Request,
                              quantize_model)
from ..parallel.embedding import VocabParallelEmbedding
from ..parallel.linear import ColumnParallelLinear, RowParallelLinear
from ..training.optim import init_adam_state
from ..training.train_step import build_train_step, reduce_grads
from .mesh import make_mesh

_np = lambda x: x.detach().float().cpu().numpy()
_t = lambda x, dev="cpu": torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _local(x: np.ndarray, dim, n: int, r: int) -> np.ndarray:
    """Rank r's chunk of x along `dim` of n (x itself when dim is None)."""
    return x if dim is None else np.array_split(x, n, axis=dim)[r]


def collective_pairs(mesh, cases: Sequence[Dict]) -> List[Dict]:
    """Each case {op, x, w, dim}: the op on this tp rank, inside a scalar
    loss every rank holds (the pattern of the JAX collective tests): the
    loss, the op's output and the gradient of the loss in this rank's x.

    x and w are stacked over the ranks on a leading axis where the rank's
    value is its own (varying), else whole (replicated):
    * copy_to: x replicated, loss = reduce_from(sum(copy_to(x) * w_r));
    * reduce_from: x varying, loss = sum(reduce_from(x_r) * w), w
      replicated;
    * split_to: x replicated, loss = reduce_from(sum(split_to(x) * w_r));
    * gather_from: x varying, loss = reduce_from(sum(gather_from(x_r) *
      w_r)) / tp, the mean of the ranks' differing copies (so the
      backward's reduce-scatter sums different cotangents);
    * reduce_scatter: x varying, loss = reduce_from(sum(rs(x_r) * w_r));
    * all_max: x varying, the max only."""
    r = mesh.tp_rank
    out = []
    for case in cases:
        op, dim = case["op"], case.get("dim", -1)
        varying_x = op in ("reduce_from", "gather_from", "reduce_scatter",
                           "all_max")
        x = _t(case["x"][r] if varying_x else case["x"]).requires_grad_(True)
        if op == "all_max":
            out.append({"y": _np(C.all_max(x, mesh))})
            continue
        w = _t(case["w"] if op == "reduce_from" else case["w"][r])
        if op == "copy_to":
            y = C.copy_to(x, mesh)
        elif op == "reduce_from":
            y = C.reduce_from(x, mesh)
        elif op == "split_to":
            y = C.split_to(x, mesh, dim=dim)
        elif op == "gather_from":
            y = C.gather_from(x, mesh, dim=dim)
        else:
            y = C.reduce_scatter(x, mesh, dim=dim)
        s = (y * w).sum()
        if op == "reduce_from":
            loss = s
        elif op == "gather_from":
            loss = C.reduce_from(s, mesh) / mesh.tp
        else:
            loss = C.reduce_from(s, mesh)
        loss.backward()
        out.append({"loss": loss.item(), "y": _np(y), "dx": _np(x.grad)})
    return out


def layer_cases(mesh, cases: Sequence[Dict]) -> List[Dict]:
    """Each case {kind: column|row|embedding, options, params (the JAX
    layer's global params), x, w, x_dim (the tp-sharded dim of x, or None:
    replicated), w_dim (of the output)}: the port's layer at this tp rank
    with its shard of the params; the loss sum(y_r * w_r) backward (the
    cotangent of a replicated output is the same on every rank). Returns
    y, the rank's parameter gradients (its shard) and x's gradient. The
    options name the layer's layouts; `pre_gather` all-gathers a
    sequence-sharded x before a 'gathered' column layer, as the model's
    sublayers share one gather."""
    n, r = mesh.tp, mesh.tp_rank
    out = []
    for case in cases:
        kind, opts, p = case["kind"], case["options"], case["params"]
        if kind == "embedding":
            layer = VocabParallelEmbedding(case["vocab_size"],
                                           p["weight"].shape[1], mesh)
            sd = {"weight": _t(_local(p["weight"], 0, n, r))}
        else:
            idim, odim = p["weight"].shape
            cls = ColumnParallelLinear if kind == "column" else \
                RowParallelLinear
            extra = {k: opts[k] for k in ("gather_output", "split_input")
                     if k in opts}
            layer = cls(idim, odim, mesh, **extra)
            wt = p["weight"].T          # torch (odim, idim)
            sd = {"weight": _t(_local(wt, 0 if kind == "column" else 1, n,
                                      r)),
                  "bias": _t(_local(p["bias"], 0 if kind == "column" else
                                    None, n, r))}
        layer.load_state_dict(sd)
        x = _t(_local(case["x"], case["x_dim"], n, r))
        if kind == "embedding":
            y = layer(x, opts.get("output_layout", "replicated"))
        else:
            x = x.requires_grad_(True)
            if opts.get("pre_gather"):      # the model's shared gather
                xin = C.gather_from(x, mesh, dim=-2)
            else:
                xin = x
            if kind == "column":
                y = layer(xin, torch.float32, opts["input_layout"])
            else:
                y = layer(xin, torch.float32, opts["output_layout"])
        loss = (y * _t(_local(case["w"], case["w_dim"], n, r))).sum()
        if opts.get("gather_output"):
            # a replicated output that a gather made: the mean of the tp
            # copies, as the model's gather-mode CE takes it (the gather's
            # backward sums the copies' cotangents)
            loss = C.reduce_from(loss, mesh) / n
        loss.backward()
        out.append({"y": _np(y),
                    "grads": {k: _np(v.grad)
                              for k, v in layer.named_parameters()},
                    "dx": None if kind == "embedding" else _np(x.grad)})
    return out


def _model(mesh, run: Dict, cfg: Dict, tree) -> Transformer:
    model = build_model(tree_family(tree), ModelConfig(**cfg),
                        remat=run.get("remat", True), cp_size=mesh.cp,
                        cp_impl=run.get("impl", "ring"),
                        cp_layout=run.get("layout", "contiguous"),
                        mesh=mesh, sequence_parallel=run.get("sp", False))
    model.load_state_dict(params_from_jax(tree, mesh.tp, mesh.tp_rank))
    return model.to(mesh.device)


def _batch(model, mesh, arrays) -> List[torch.Tensor]:
    """This rank's rows (dp) and sequence chunk (cp) of full (..., b, t)
    arrays, on its device."""
    rows = [dp_rows(np.asarray(x), mesh.dp, mesh.dp_rank) for x in arrays]
    return [_t(x, mesh.device).long() for x in model.cp_shard(*rows)]


def model_runs(mesh, cfg: Dict, tree, runs: Sequence[Dict]) -> List[Dict]:
    """The model on this rank from the JAX param tree `tree` (ModelConfig
    fields `cfg`), for each run {sp, mode, impl, layout, remat, batch:
    (ids, targets, positions) (b, t)}: the loss and this rank's gradient
    shard after the train step's reductions (`reduce_grads`); a run with
    `steps` and `optim` (OptimizerConfig fields) and batches stacked
    (steps, b, t) returns each train step's loss and grad norm instead.
    Every result carries the rank's coordinates."""
    out = []
    for run in runs:
        model = _model(mesh, run, cfg, tree)
        mode = run.get("mode", "vocab_parallel")
        batch = _batch(model, mesh, run["batch"])
        res = {"coords": mesh.coords}
        if "steps" in run:
            step = build_train_step(model, OptimizerConfig(**run["optim"]),
                                    mode)
            state = init_adam_state(dict(model.named_parameters()))
            res["losses"], res["gnorms"] = [], []
            for i in range(run["steps"]):
                loss, gnorm, state = step(state, *(x[i] for x in batch))
                res["losses"].append(loss.item())
                res["gnorms"].append(gnorm.item())
            out.append(res)
            continue
        loss = model.loss(*batch, mode=mode)
        loss.backward()
        params = dict(model.named_parameters())
        reduce_grads(model, {k: p.grad for k, p in params.items()})
        res.update(loss=loss.item(),
                   grads={k: _np(p.grad) for k, p in params.items()})
        out.append(res)
    return out


def doc_losses(mesh, cfg: Dict, tree, runs: Sequence[Dict]) -> List[Dict]:
    """For each run {layout, impl, batch: (ids, targets, positions) (b,
    t)}: `Transformer.doc_loss` on this rank's rows and chunk — the
    per-document means and real-row mask of its dp rows, with its
    coordinates."""
    out = []
    for run in runs:
        model = _model(mesh, run, cfg, tree)
        means, real = model.doc_loss(*_batch(model, mesh, run["batch"]))
        out.append({"coords": mesh.coords, "means": _np(means),
                    "real": real.cpu().numpy()})
    return out


def seed_identity(mesh, cfg: Dict, seed: int, batch,
                  family: str = "llama") -> Dict:
    """The loss of this tp mesh's `family` model from `seed`
    (`init_weights` draws the full tree and keeps the rank's slice) and of
    a tp = 1 model from the same seed, on one batch."""
    model = build_model(family, ModelConfig(**cfg), mesh=mesh,
                        sequence_parallel=True).init_weights(seed)
    one = build_model(family, ModelConfig(**cfg)).init_weights(seed)
    with torch.no_grad():
        loss = model.loss(*_batch(model, mesh, batch)).item()
        loss1 = one.loss(*(_t(x).long() for x in batch)).item()
    return {"tp": loss, "tp1": loss1}


def _serving_model(mesh, cfg: Dict, tree) -> Transformer:
    """This rank's shard of the JAX param tree `tree` on its device."""
    model = build_model(tree_family(tree), ModelConfig(**cfg), mesh=mesh)
    model.load_state_dict(params_from_jax(tree, mesh.tp, mesh.tp_rank))
    return model.to(mesh.device)


def counting_clock(tick: float):
    """A scripted engine clock: 0, tick, 2 tick, ... one step per call."""
    count = itertools.count()
    return lambda: next(count) * tick


def drive(eng, requests: Sequence, stagger: int):
    """The JAX engine tests' drive, for an engine of either package: submit
    the first two requests, step `stagger` times, submit the rest in
    reverse order, step to the end. Returns ({rid: tokens}, the page table
    after every step: the paged engines')."""
    tables = []

    def step():
        eng.step()
        if hasattr(eng, "_tbl"):
            tables.append(np.array(eng._tbl))

    for r in requests[:2]:
        eng.submit(r)
    for _ in range(stagger):
        step()
    for r in reversed(requests[2:]):
        eng.submit(r)
    while eng.has_work():
        step()
    return {r.rid: list(r.tokens) for r in eng.completed}, tables


def serve_runs(mesh, cfg: Dict, tree, runs: Sequence[Dict]) -> List[Dict]:
    """Each run {engine: slot | paged, kw: the engine's kwargs, requests:
    [(prompt, max_new, tenant, slo_class[, seed])], stagger, tick}: one
    engine on every tp rank of `mesh`, with this rank's shard of `tree`. tp
    rank 0 runs `drive`, the paged engine on a scripted clock that
    advances `tick` per call, then stops the workers, which serve its
    dispatches meanwhile. A run with int8 decode weights
    (`decode_weight_dtype` in kw) gets a model of its own: its engine
    quantizes the model in place.
    Every rank returns its dispatches by kind and by shape; tp rank 0 also
    {rid: tokens}, the stats and the paged engine's page table after every
    step."""
    model = _serving_model(mesh, cfg, tree)
    out = []
    for run in runs:
        kw = dict(run["kw"])
        m = (_serving_model(mesh, cfg, tree)
             if kw.get("decode_weight_dtype") == "int8" else model)
        if run["engine"] == "paged":
            kw["clock"] = counting_clock(run["tick"])
            eng = PagedEngine(m, mesh, **kw)
        else:
            eng = ContinuousBatchingEngine(m, mesh, **kw)
        res = {}
        if eng.dispatch.leader:
            reqs = [Request(rid=i, prompt=list(p), max_new=m, tenant=t,
                            slo_class=c, seed=seed[0] if seed else 0)
                    for i, (p, m, t, c, *seed) in enumerate(run["requests"])]
            tokens, tables = drive(eng, reqs, run["stagger"])
            eng.dispatch.stop()
            res = {"tokens": tokens, "stats": eng.stats(), "tables": tables}
        else:
            eng.dispatch.serve()
        res.update(dispatches=eng.dispatch.counts,
                   shapes=sorted((k, list(s), n) for (k, s), n in
                                 eng.dispatch.shapes.items()))
        out.append(res)
    return out


def quantized_params(mesh, cfg: Dict, tree) -> Dict:
    """This rank's `quantize_decode_params` of its shard of `tree`: {state
    dict key: array, or {"qweight", "scale"} arrays}."""
    model = _serving_model(mesh, cfg, tree)
    q = quantize_decode_params(model.state_dict(), mesh)
    return {k: ({n: v.cpu().numpy() for n, v in leaf.items()}
                if isinstance(leaf, dict) else _np(leaf))
            for k, leaf in q.items()}


def decode_logits(mesh, cfg: Dict, tree, calls: Sequence[Dict],
                  decode_weight_dtype=None) -> List[np.ndarray]:
    """Each call {kind, args}: 'prefill' (buf, prompt_len), 'decode'
    (cache_k, cache_v, token, cur) or 'paged_decode' (pool_k, pool_v,
    token, cur, page_tbl, with `page_size`), the caches and pools given
    whole (every kv head: this rank takes a copy of its own), through the
    lowering on this rank's shard of `tree`. Returns
    each call's full-vocab f32 logits after the sampler's gather (the same
    on every rank). With `decode_weight_dtype='int8'` the model holds int8
    decode weights (`serving.engine.quantize_model`)."""
    model = _serving_model(mesh, cfg, tree)
    if decode_weight_dtype == "int8":
        quantize_model(model, mesh)
    dev, n, r = mesh.device, mesh.tp, mesh.tp_rank
    dtype = resolve_dtype_on(model.cfg.compute_dtype, dev)
    heads = lambda x: _t(_local(x, 2, n, r), dev)
    out = []
    for call in calls:
        kind, args = call["kind"], call["args"]
        t_len = max(model.cfg.maxlen,
                    args[0].shape[3] if kind == "decode" else 0)
        cos, sin = decode.decode_tables(model, t_len, dev)
        with torch.inference_mode():
            if kind == "prefill":
                logits = decode._prefill(model, _t(args[0], dev),
                                         _t(args[1], dev), cos, sin,
                                         dtype)[2]
            elif kind == "decode":
                logits = decode._decode_one(
                    model, heads(args[0]), heads(args[1]), _t(args[2], dev),
                    _t(args[3], dev), args[0].shape[3], cos, sin, dtype)
            else:
                logits = decode._paged_decode_one(
                    model, heads(args[0]), heads(args[1]),
                    *(_t(a, dev) for a in args[2:]), call["page_size"], cos,
                    sin, dtype, attn_impl="kernel")
            out.append(_np(decode._full_vocab_logits(model, logits)))
    return out


def jobs(rank: int, nprocs: int, init_method: str, todo: Sequence,
         devices: Sequence[str] = ("cpu",), backend: str = "gloo") -> List:
    """Run `todo`, a list of (job name, mesh axes {dp, cp, tp}, kwargs), on
    this rank of an nprocs group: each job on the mesh its axes name (their
    product is nprocs), on each of `devices` in turn, one group for all.
    Returns the jobs' results, device by device, each in `todo`'s order."""
    fns = {"collective_pairs": collective_pairs, "layer_cases": layer_cases,
           "model_runs": model_runs, "seed_identity": seed_identity,
           "serve_runs": serve_runs, "decode_logits": decode_logits,
           "doc_losses": doc_losses, "quantized_params": quantized_params}
    out = []
    for device in devices:
        for name, axes, kwargs in todo:
            mesh = make_mesh(MeshConfig(**axes), device=device, rank=rank,
                             backend=backend, init_method=init_method)
            out.append(fns[name](mesh, **kwargs))
    return out
