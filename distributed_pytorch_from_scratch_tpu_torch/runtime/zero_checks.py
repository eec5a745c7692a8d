"""Rank programs that hold the ZeRO stages and the dp gradient wires against
a reference, run through `runtime.launch.spawn` with `tp_checks.jobs` — by
the tests (against the JAX package, on the CPU) and by chip_smoke.py (the
card against the CPU): `zero_runs` (train steps at a stage, or one
reduced gradient) and `int8_ring` (the quantized ring all-reduce and
reduce-scatter over dp). Inputs are numpy arrays made by the caller and
results come back as numpy, each with the rank's coordinates.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import OptimizerConfig
from ..ops import overlap
from ..training.optim import init_adam_state
from ..training.train_step import build_train_step, reduce_grads
from ..training.zero import build_plan, expected_state_bytes

_np = lambda x: x.detach().float().cpu().numpy()


def zero_runs(mesh, cfg: Dict, tree, runs: Sequence[Dict]) -> List[Dict]:
    """The model on this rank from the JAX tree `tree` (as
    `tp_checks.model_runs`), for each run {stage, bucket_mb, wire, sp,
    remat, batch, and either steps + optim, or grads}: with `steps`, the
    train step under the run's ZeRO plan on batches stacked (steps, b, t):
    each step's loss and grad norm, this rank's held bytes after the last
    step and their count (`zero.expected_state_bytes`), the dp
    dims, and the parameters after the steps, whole (every rank's dp
    shards gathered; its tp shard); with `grads`, one backward on the
    (b, t) batch and the reduced gradients, whole, with their dtypes."""
    from .tp_checks import _batch, _model
    out = []
    for run in runs:
        model = _model(mesh, run, cfg, tree)
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        plan = build_plan(model, run.get("stage", 0),
                          run.get("bucket_mb", 0.0), run.get("wire", "f32"))
        if plan is not None:
            plan.install(model)
        params = dict(model.named_parameters())
        batch = _batch(model, mesh, run["batch"])
        res = {"coords": mesh.coords}
        if "steps" in run:
            step = build_train_step(model, OptimizerConfig(**run["optim"]),
                                    plan=plan)
            state = (init_adam_state(params) if plan is None
                     else plan.init_state(params))
            res["losses"], res["gnorms"] = [], []
            for i in range(run["steps"]):
                loss, gnorm, state = step(state, *(x[i] for x in batch))
                res["losses"].append(loss.item())
                res["gnorms"].append(gnorm.item())
            full = model.state_dict() if plan is None else plan.full_params(
                model.state_dict())
            res.update(params={k: _np(v) for k, v in full.items()},
                       held=dict(step.held_bytes),
                       expected=expected_state_bytes(shapes, plan),
                       dims=None if plan is None else dict(plan.dims))
        else:
            loss = model.loss(*batch)
            loss.backward()
            grads = reduce_grads(model, {k: p.grad for k, p in
                                         params.items()}, plan)
            res["dtypes"] = sorted({str(g.dtype) for g in grads.values()})
            if plan is not None and plan.stage >= 2:
                keys = [k for k in grads if plan.sharded(k)]
                whole = overlap.gather_full([grads[k] for k in keys],
                                            [plan.dims[k] for k in keys],
                                            mesh)
                grads = {**grads, **dict(zip(keys, whole))}
            res.update(loss=loss.item(),
                       grads={k: _np(g) for k, g in grads.items()})
        out.append(res)
    return out


def int8_ring(mesh, x: np.ndarray, blocks: np.ndarray) -> Dict:
    """The int8 ring over dp: `x` (dp, n) — this rank's row all-reduced —
    and `blocks` (dp, dp, P) — this rank's (dp, P) reduce-scattered."""
    dev = mesh.device
    r = mesh.dp_rank
    mine = torch.from_numpy(np.ascontiguousarray(x[r])).to(dev)
    allreduced = overlap._quantized_allreduce_axis(mine, mesh, "dp")
    rs = overlap.quantized_reduce_scatter(
        torch.from_numpy(np.ascontiguousarray(blocks[r])).to(dev), mesh,
        "dp")
    return {"coords": mesh.coords, "allreduce": _np(allreduced),
            "reduce_scatter": _np(rs)}
