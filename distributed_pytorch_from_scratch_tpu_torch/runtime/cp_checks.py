"""Rank programs that hold the cp paths against a reference, run through
`runtime.launch.spawn` — by the tests (against the JAX package, on the CPU)
and by chip_smoke.py (the card's kernels against the CPU's plain versions).

Each takes full, natural-order numpy inputs made by the caller, runs this
rank's chunk of the sequence, and returns numpy results: the caller puts the
chunks back in order with `ring_attention.cp_chunk_index`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import MeshConfig, ModelConfig, OptimizerConfig
from ..models.transformer import Transformer
from ..ops.collectives import all_reduce_sum_
from ..ops.ring_attention import (cp_chunk_index, ring_attention,
                                  ring_schedule, ulysses_attention)
from ..training.optim import init_adam_state
from ..training.train_step import build_train_step
from .mesh import make_mesh

_np = lambda x: x.detach().float().cpu().numpy()


def attention_grads(rank: int, nprocs: int, init_method: str,
                    cases: Sequence[Dict], device: str = "cpu",
                    backend: str = "gloo") -> List[Dict]:
    """For each case {impl: 'ring'|'ulysses', layout, q, k, v, pos, w} (q,
    w (b, h, t, d), k, v (b, hkv, t, d), pos (b, t)): this rank's chunk of
    the attention output o and of the gradients of sum(o * w) in q, k, v,
    with the chunk's indices `idx`."""
    mesh = make_mesh(MeshConfig(cp=nprocs), device=device, rank=rank,
                     backend=backend, init_method=init_method)
    out = []
    for case in cases:
        idx = cp_chunk_index(case["q"].shape[2], nprocs, rank, case["layout"])
        chunk = lambda x: np.ascontiguousarray(case[x][:, :, idx])
        q, k, v, w = (torch.from_numpy(chunk(x)).to(mesh.device)
                      for x in "qkvw")
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        pos = torch.from_numpy(case["pos"][:, idx]).to(mesh.device)
        if case["impl"] == "ring":
            o = ring_attention(q, k, v, ring_schedule(pos, mesh), mesh)
        else:
            o = ulysses_attention(q, k, v, mesh)
        o.backward(w)
        out.append({"idx": idx, "o": _np(o), "dq": _np(q.grad),
                    "dk": _np(k.grad), "dv": _np(v.grad)})
    return out


def model_runs(rank: int, nprocs: int, init_method: str, cfg: Dict,
               state_dict: Dict[str, torch.Tensor], runs: Sequence[Dict],
               devices: Sequence[str] = ("cpu",),
               backend: str = "gloo") -> List[Dict]:
    """The model at cp = nprocs from `state_dict` (ModelConfig fields `cfg`),
    on each of `devices` in turn, one group for all. Each run {impl, layout,
    remat, batch: (ids, targets, positions) (b, t) arrays} returns the loss,
    every parameter's gradient summed over the group (the train step's
    gradient) and the full batch's logits in natural order; a run with
    `steps` and `optim` (OptimizerConfig fields) and batches stacked
    (steps, b, t) returns the losses of that many train steps instead.
    Results are listed by device, then run."""
    out = []
    for device in devices:
        mesh = make_mesh(MeshConfig(cp=nprocs), device=device, rank=rank,
                         backend=backend, init_method=init_method)
        for run in runs:
            model = Transformer(ModelConfig(**cfg),
                                remat=run.get("remat", True), cp_size=nprocs,
                                cp_impl=run["impl"], cp_layout=run["layout"],
                                mesh=mesh)
            model.load_state_dict(state_dict)
            model.to(mesh.device)
            batch = [torch.from_numpy(np.ascontiguousarray(x)).long()
                     .to(mesh.device) for x in model.cp_shard(*run["batch"])]
            if "steps" in run:
                step = build_train_step(model, OptimizerConfig(**run["optim"]))
                state = init_adam_state(dict(model.named_parameters()))
                losses = []
                for i in range(run["steps"]):
                    loss, _, state = step(state, *(x[i] for x in batch))
                    losses.append(loss.item())
                out.append({"losses": losses})
                continue
            loss = model.loss(*batch)
            loss.backward()
            params = dict(model.named_parameters())
            all_reduce_sum_([p.grad for p in params.values()], mesh)
            ids, _, pos = (torch.from_numpy(np.ascontiguousarray(x)).long()
                           .to(mesh.device) for x in run["batch"])
            out.append({"loss": loss.item(),
                        "grads": {k: _np(p.grad) for k, p in params.items()},
                        "logits": _np(model.full_logits(ids, pos))})
    return out
