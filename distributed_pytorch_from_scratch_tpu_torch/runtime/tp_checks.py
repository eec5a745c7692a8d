"""Rank programs that hold the tp, dp and sequence-parallel paths against a
reference, run through `runtime.launch.spawn` — by the tests (against the
JAX package, on the CPU) and by chip_smoke.py (the card's kernels against
the CPU's plain versions), as `runtime/cp_checks.py` serves the cp paths:
training (`collective_pairs`, `layer_cases`, `ring_ops`, `model_runs`,
`seed_identity`, `checkpoint_steps`; the ZeRO stages' `zero_runs` and
`int8_ring` live in `runtime/zero_checks.py`), serving at tp > 1 and on cp-sharded pages at cp or cp
x tp (`serve_runs`, `decode_logits`, `quantized_params`, `combine`),
the evaluation loss on any mesh (`doc_losses`), the one-shot decoder at
tp or cp > 1 (`generate_runs`), the tensors a rank
process still holds after its earlier calls (`hold_garbage`,
`live_tensors`) and a rank's place on its mesh (`mesh_axes`).

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

import gc
import itertools
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import MeshConfig, ModelConfig, OptimizerConfig, resolve_dtype_on
from ..data.dataset import dp_rows
from ..interop import params_from_jax, tree_family
from ..models import decode
from ..models import build_model
from ..models.pipeline import from_canonical, to_canonical
from ..models.transformer import Transformer
from ..ops import collectives as C
from ..ops.quant import quantize_decode_params
from ..serving.engine import (ContinuousBatchingEngine, PagedEngine, Request,
                              quantize_model)
from ..serving.speculative import SpeculativeEngine
from ..parallel.embedding import VocabParallelEmbedding
from ..parallel.layout import shard_params
from ..parallel.linear import ColumnParallelLinear, RowParallelLinear
from ..training.checkpoint import (gather_experts, load_checkpoint,
                                   save_checkpoint)
from ..training.optim import AdamState, init_adam_state
from ..training.train_step import (build_train_step, param_grads,
                                   reduce_grads)
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


def ring_ops(mesh, cases: Sequence[Dict]) -> List[Dict]:
    """Each case {op: ag | rs, x, ws, dys, quantized}, every array stacked
    over the tp ranks on a leading axis (weights in torch's (o, i)
    layout): `ops/overlap.ag_matmul(x_r, ws_r)` or `matmul_rs(x_r, ws_r[0])`
    on this rank, then the backward of sum_j sum(y_j * dys_j,r). Returns
    the outputs, x's and the weights' gradients, and the tp hops the case
    made (calls, bytes)."""
    from ..ops.overlap import ag_matmul, matmul_rs
    r, dev = mesh.tp_rank, mesh.device
    out = []
    for case in cases:
        x = _t(case["x"][r], dev).requires_grad_(True)
        ws = [_t(w[r], dev).requires_grad_(True) for w in case["ws"]]
        C.reset_stats()
        if case["op"] == "ag":
            ys = ag_matmul(x, tuple(ws), mesh, case["quantized"])
        else:
            ys = (matmul_rs(x, ws[0], mesh, case["quantized"]),)
        sum((y * _t(d[r], dev)).sum()
            for y, d in zip(ys, case["dys"])).backward()
        out.append({"ys": [_np(y) for y in ys], "dx": _np(x.grad),
                    "dws": [_np(w.grad) for w in ws],
                    "calls": C.stats["tp"]["calls"],
                    "bytes": C.stats["tp"]["bytes"]})
    return out


PP_OPTIONS = ("pp_microbatches", "pp_schedule", "pp_virtual",
              "pp_remat_steps")


def _model(mesh, run: Dict, cfg: Dict, tree) -> Transformer:
    """The model of `run` on this rank, its shard (and pp stage's layers)
    of the JAX tree `tree` loaded."""
    model = build_model(tree_family(tree), ModelConfig(**cfg),
                        remat=run.get("remat", True), cp_size=mesh.cp,
                        cp_impl=run.get("impl", "ring"),
                        cp_layout=run.get("layout", "contiguous"),
                        mesh=mesh, sequence_parallel=run.get("sp", False),
                        tp_overlap=run.get("tp_overlap", "off"),
                        **{k: run[k] for k in PP_OPTIONS if k in run})
    model.load_state_dict(shard_params(
        from_canonical(params_from_jax(tree), model.layer_ids), mesh.tp,
        mesh.tp_rank, mesh.ep, mesh.ep_rank))
    return model.to(mesh.device)


def _batch(model, mesh, arrays) -> List[torch.Tensor]:
    """This rank's rows (dp x ep) and sequence chunk (cp) of full (..., b,
    t) arrays, on its device."""
    rows = [dp_rows(np.asarray(x), *mesh.row_shard) for x in arrays]
    return [_t(x, mesh.device).long() for x in model.cp_shard(*rows)]


def model_runs(mesh, cfg: Dict, tree, runs: Sequence[Dict]) -> List[Dict]:
    """The model on this rank from the JAX param tree `tree` (ModelConfig
    fields `cfg`), for each run {sp, mode, impl, layout, remat, the
    `PP_OPTIONS`, batch:
    (ids, targets, positions) (b, t)}: the loss and this rank's gradient
    shard after the train step's reductions (`reduce_grads`; a pp stage's
    layers under their canonical indices) and a MoE
    model's routing (`moe_summary`), and with
    `logits` the forward's logits of this rank's rows and chunk, every
    vocab column (the tp shards gathered); a run with `steps` and `optim`
    (OptimizerConfig fields) and batches stacked (steps, b, t) returns each
    train step's loss and grad norm instead. Every result carries the
    rank's coordinates."""
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
        if run.get("logits"):
            with torch.no_grad():
                lg = model(batch[0], batch[2])
                res["logits"] = _np(torch.cat(
                    C.all_gather(lg, mesh, "tp").unbind(0), dim=-1))
        loss = model.loss(*batch, mode=mode)
        loss.backward()
        params = dict(model.named_parameters())
        grads = reduce_grads(model, param_grads(params))
        res.update(loss=loss.item(), moe=model.moe_summary(),
                   grads=to_canonical({k: _np(g) for k, g in grads.items()},
                                      model.layer_ids))
        out.append(res)
    return out


def checkpoint_steps(mesh, cfg: Dict, family: str, load_dir: str, step: int,
                     save_dir: str, batches, optim: Dict) -> Dict:
    """Resume iteration `step` of `load_dir` (params and moments, either
    package's files) at this rank's (tp, ep) shard, take one train step on
    `batches[0]`, save the state as iteration step + 1 in `save_dir` as
    the trainer does (the experts gathered over ep, the ranks at dp = cp =
    ep = 0 writing, the mesh in the stamp), then take one more on
    `batches[1]`: the two losses, with the rank's coordinates."""
    model = build_model(family, ModelConfig(**cfg), mesh=mesh)
    sd, opt, _ = load_checkpoint(load_dir, step, with_opt=True,
                                 tp_size=mesh.tp, tp_rank=mesh.tp_rank,
                                 ep_size=mesh.ep, ep_rank=mesh.ep_rank)
    model.load_state_dict(sd)
    model.to(mesh.device)
    state = AdamState(step=opt.step, mu=opt.mu, nu=opt.nu)
    train = build_train_step(model, OptimizerConfig(**optim))
    batch = lambda i: _batch(model, mesh, [x[i] for x in batches])
    loss1, _, state = train(state, *batch(0))
    params = gather_experts(model.state_dict(), mesh)
    moments = AdamState(step=state.step,
                        mu=gather_experts(state.mu, mesh),
                        nu=gather_experts(state.nu, mesh))
    if mesh.dp_rank == mesh.cp_rank == mesh.ep_rank == 0:
        save_checkpoint(save_dir, step + 1, float(loss1), params, moments,
                        tp_size=mesh.tp, tp_rank=mesh.tp_rank,
                        mesh_axes=(("dp", mesh.dp), ("cp", mesh.cp),
                                   ("ep", mesh.ep), ("tp", mesh.tp)))
    loss2, _, _ = train(state, *batch(1))
    return {"coords": mesh.coords, "losses": [loss1.item(), loss2.item()]}


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


def generate_runs(mesh, cfg: Dict, tree, runs: Sequence[Dict]) -> List[Dict]:
    """For each run {prompts, eos, max_total_len, buf_len, and optionally
    seed, temperature, top_k, top_p, impl, layout}: `GreedyDecoder
    .decode_batch` on this rank's shard of the JAX tree `tree`, the model
    at the mesh's cp (`impl` / `layout` its cp_impl / cp_layout). Returns
    the tokens, the host syncs, the cp hops and the kernel launches of
    the generation, or {"error": the message} where the decoder refuses
    the run."""
    from ..ops.cuda import launch_counts
    out = []
    for run in runs:
        model = build_model(tree_family(tree), ModelConfig(**cfg), mesh=mesh,
                            cp_size=mesh.cp, cp_impl=run.get("impl", "ring"),
                            cp_layout=run.get("layout", "contiguous"))
        model.load_state_dict(params_from_jax(tree, mesh.tp, mesh.tp_rank))
        model.to(mesh.device)
        try:
            dec = decode.GreedyDecoder(
                model, mesh, run["buf_len"],
                temperature=run.get("temperature", 0.0),
                top_k=run.get("top_k", 0), top_p=run.get("top_p", 0.0))
        except ValueError as e:
            out.append({"error": str(e)})
            continue
        C.reset_stats()
        before = launch_counts()
        tokens = dec.decode_batch(run["prompts"], run["eos"],
                                  run["max_total_len"],
                                  seed=run.get("seed", 0))
        after = launch_counts()
        out.append({"coords": mesh.coords, "tokens": tokens,
                    "host_syncs": dec.host_syncs,
                    "cp_hops": C.stats["cp"]["calls"],
                    "launches": {k: after[k] - before[k] for k in after}})
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


def _serving_model(mesh, cfg: Dict, tree,
                   cp_size: int = None) -> Transformer:
    """This rank's shard of the JAX param tree `tree` on its device, the
    model at cp `cp_size` (default: the mesh's; a paged engine's pages
    shard over it)."""
    model = build_model(tree_family(tree), ModelConfig(**cfg), mesh=mesh,
                        cp_size=mesh.cp if cp_size is None else cp_size)
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


def _drained(eng) -> bool:
    """Every page of a paged engine's pool (and of a speculative engine's
    drafter pool, its table back on the scratch page) on its free list, no
    reference left."""
    pools = [eng.pool] + ([eng.dpool] if hasattr(eng, "dpool") else [])
    tables = ([eng._dtbl == eng.dpool.scratch_page]
              if hasattr(eng, "dpool") else [])
    return (all(p.free_pages == p.num_pages and not p.refcount.any()
                for p in pools) and all(t.all() for t in tables))


def serve_runs(mesh, cfg: Dict, tree, runs: Sequence[Dict]) -> List[Dict]:
    """Each run {engine: slot | paged | speculative, kw: the engine's
    kwargs, requests: [(prompt, max_new, tenant, slo_class[, seed])],
    stagger, tick}: one engine on every rank of `mesh`, with this rank's
    shard of `tree` (the model at the mesh's cp: a paged engine's pages
    shard over it; a speculative run's `drafter`: (its ModelConfig
    fields, its JAX tree), at cp 1). Rank 0 runs `drive`, the paged
    engines on a scripted clock that advances `tick` per call, then stops
    the workers, which serve its dispatches meanwhile. A run with int8
    decode weights (`decode_weight_dtype` in kw) gets a model of its own:
    its engine quantizes the model in place.
    Every rank returns its dispatches by kind and by shape, its cp hops
    (a speculative run also each verify's (n_acc, out) as this rank
    computed it); rank 0 also {rid: tokens}, the stats, the paged engine's
    page table after every step and whether its pools drained."""
    model = _serving_model(mesh, cfg, tree)
    out = []
    for run in runs:
        kw = dict(run["kw"])
        m = (_serving_model(mesh, cfg, tree)
             if kw.get("decode_weight_dtype") == "int8" else model)
        rounds = []
        if run["engine"] == "speculative":
            kw["clock"] = counting_clock(run["tick"])
            eng = SpeculativeEngine(m, mesh,
                                    _serving_model(mesh, *run["drafter"],
                                                   cp_size=1), **kw)
            verify = eng.dispatch.lowerings["spec_verify"]
            eng.dispatch.lowerings["spec_verify"] = (
                lambda shape, p: rounds.append(verify(shape, p))
                or rounds[-1])
        elif run["engine"] == "paged":
            kw["clock"] = counting_clock(run["tick"])
            eng = PagedEngine(m, mesh, **kw)
        else:
            eng = ContinuousBatchingEngine(m, mesh, **kw)
        res = {"rounds": rounds} if run["engine"] == "speculative" else {}
        C.reset_stats()
        if eng.dispatch.leader:
            reqs = [Request(rid=i, prompt=list(p), max_new=m, tenant=t,
                            slo_class=c, seed=seed[0] if seed else 0)
                    for i, (p, m, t, c, *seed) in enumerate(run["requests"])]
            tokens, tables = drive(eng, reqs, run["stagger"])
            eng.dispatch.stop()
            res.update(tokens=tokens, stats=eng.stats(), tables=tables)
            if run["engine"] != "slot":
                res["drained"] = _drained(eng)
        else:
            eng.dispatch.serve()
        res.update(cp_hops=C.stats["cp"]["calls"],
                   dispatches=eng.dispatch.counts,
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


def _rank_pool(x, mesh, dev):
    """This rank's part of a whole page pool array (layers, P + 1, kv heads,
    page_size[, hd]), or of an int8 (codes, scales) pair: its tp heads and,
    at cp > 1, its slab of P / cp pages followed by the scratch page."""
    if isinstance(x, tuple):
        return tuple(_rank_pool(a, mesh, dev) for a in x)
    x = _local(x, 2, mesh.tp, mesh.tp_rank)
    if mesh.cp > 1:
        ppr, r = (x.shape[1] - 1) // mesh.cp, mesh.cp_rank
        x = np.concatenate([x[:, r * ppr:(r + 1) * ppr], x[:, -1:]], axis=1)
    return _t(x, dev)


def decode_logits(mesh, cfg: Dict, tree, calls: Sequence[Dict],
                  decode_weight_dtype=None) -> List[np.ndarray]:
    """Each call {kind, args}: 'prefill' (buf, prompt_len), 'decode'
    (cache_k, cache_v, token, cur), 'paged_decode' (pool_k, pool_v, token,
    cur, page_tbl) or 'paged_chunk' (pool_k, pool_v, chunk, start, qlen,
    page_tbl, dst_page, dst_off), the paged ones with `page_size` and
    optionally `attn_impl` (default 'kernel') and `all_logits`; the
    caches and pools given whole (every kv head and, for a paged pool,
    every page: this rank takes its heads and, at cp > 1, its slab),
    through the lowering on this rank's shard of `tree` at the mesh's cp.
    Returns each call's full-vocab f32 logits after the sampler's gather
    (the same on every rank). With `decode_weight_dtype='int8'` the model
    holds int8 decode weights (`serving.engine.quantize_model`)."""
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
        paged = dict(attn_impl=call.get("attn_impl", "kernel"), cp=mesh.cp)
        with torch.inference_mode():
            if kind == "prefill":
                logits = decode._prefill(model, _t(args[0], dev),
                                         _t(args[1], dev), cos, sin,
                                         dtype)[2]
            elif kind == "decode":
                logits = decode._decode_one(
                    model, heads(args[0]), heads(args[1]), _t(args[2], dev),
                    _t(args[3], dev), args[0].shape[3], cos, sin, dtype)
            elif kind == "paged_decode":
                logits = decode._paged_decode_one(
                    model, _rank_pool(args[0], mesh, dev),
                    _rank_pool(args[1], mesh, dev),
                    *(_t(a, dev) for a in args[2:]), call["page_size"], cos,
                    sin, dtype, **paged)
            else:
                logits = decode._paged_prefill_chunk(
                    model, _rank_pool(args[0], mesh, dev),
                    _rank_pool(args[1], mesh, dev),
                    *(_t(a, dev) for a in args[2:]), call["page_size"], cos,
                    sin, dtype, all_logits=call.get("all_logits", False),
                    **paged)
            out.append(_np(decode._full_vocab_logits(model, logits)))
    return out


def combine(mesh, o: np.ndarray, lse: np.ndarray) -> np.ndarray:
    """`models/decode.cp_combine` on this cp rank's partial: o (cp, ...,
    hd) and lse (cp, ...) stacked over the cp ranks, each rank taking its
    own entry."""
    r = mesh.cp_rank
    return _np(decode.cp_combine(_t(o[r], mesh.device),
                                 _t(lse[r], mesh.device), mesh))


def mesh_axes(mesh) -> Dict:
    """This rank's coordinates, the world size and the members of each of
    its axis groups."""
    return {"coords": mesh.coords, "world": mesh.world,
            "axes": {a: list(ax.members) for a, ax in mesh.axes.items()
                     if a != "world"}}


def hold_garbage(mesh) -> int:
    """Collect garbage once, then stop the collector in this rank's
    process, so that a later `live_tensors` also counts the tensors that
    only a reference cycle keeps."""
    gc.collect()
    gc.disable()
    return 0


def live_tensors(mesh) -> int:
    """How many tensors this rank's process holds, those of uncollected
    reference cycles included (a kept rank should hold none between
    calls); starts the collector again."""
    n = sum(issubclass(type(o), torch.Tensor) for o in gc.get_objects())
    gc.enable()
    return n


def jobs(rank: int, nprocs: int, init_method: str, todo: Sequence,
         devices: Sequence[str] = ("cpu",), backend: str = "gloo") -> List:
    """Run `todo`, a list of (job name, mesh axes {dp, cp, ep, tp}, kwargs), on
    this rank of an nprocs group: each job on the mesh its axes name (their
    product is nprocs), on each of `devices` in turn, one group for all.
    Returns the jobs' results, device by device, each in `todo`'s order."""
    from .zero_checks import int8_ring, zero_runs
    fns = {"collective_pairs": collective_pairs, "layer_cases": layer_cases,
           "model_runs": model_runs, "seed_identity": seed_identity,
           "serve_runs": serve_runs, "decode_logits": decode_logits,
           "doc_losses": doc_losses, "quantized_params": quantized_params,
           "combine": combine, "checkpoint_steps": checkpoint_steps,
           "zero_runs": zero_runs, "int8_ring": int8_ring,
           "ring_ops": ring_ops, "generate_runs": generate_runs,
           "hold_garbage": hold_garbage, "live_tensors": live_tensors,
           "mesh_axes": mesh_axes}
    out = []
    for device in devices:
        for name, axes, kwargs in todo:
            mesh = make_mesh(MeshConfig(**axes), device=device, rank=rank,
                             backend=backend, init_method=init_method)
            out.append(fns[name](mesh, **kwargs))
    return out
