"""The training step: loss + grads + Adam/OneCycle update — the port's
counterpart of the JAX `training/train_step.py`.

Where JAX jits one donated program per step, torch runs eagerly: the step
zeroes the grads, runs the forward and `backward()`, takes the global grad
norm and updates the parameters and moments in place. It returns
`(loss, grad_norm)` as device tensors and reads nothing back to the host,
so the caller decides when to sync (the train loop does so once per log
interval).

On a mesh of more than one rank (dp, cp, tp) every rank runs the step on
its part of the batch and its shard of the parameters, and after the
backward:
(a) under sequence parallelism, the gradients of the parameters that are
    replicated over tp (the norms' scales, the row layers' biases) are
    summed over the tp group: each tp rank saw only its chunk of the
    sequence (Megatron SP's rule; JAX's shard_map transpose does it
    implicitly). Without SP those gradients are already the same on every
    tp rank and are not summed;
(b) every gradient is summed over the batch group (the dp x cp x ep
    ranks of this tp index) in one flat buffer: each rank's loss is its
    local sum over the global count, so the sum is the global loss's
    gradient. At ep > 1 the experts' gradients are the exception: each ep
    rank holds its own experts, whose gradient already counts every ep
    rank's tokens (the all_to_all's backward brought their cotangents
    back), so they are summed over the dp x cp ranks of this (ep, tp)
    pair, the 'expert_batch' group, in a second buffer;
(c) then the norm (the tp-sharded squares summed over tp, the experts'
    over ep too), the clip and Adam — every rank of a (tp, ep) index then
    holds the same parameters.

Under a ZeRO stage or `--dp_reduce_bucket_mb` a `training/zero.ZeroPlan`
picks the reducer of (b) (`reduce_grads`): the flat buffer above (stage
0, and stage 1 without buckets), the bucketed all-reduce (stages 0 and 1
with buckets), the bucketed reduce-scatter (stage 2), or, at stage 3,
what the gathers' backward left (the cp and tp sums, and the leaves that
do not shard). Adam then runs on the part of each leaf this rank owns,
and at stages 1 and 2 the fresh shards are all-gathered over dp.

`build_train_step_multi` runs N steps per host dispatch, the JAX
`lax.scan` variant. On a card it captures the ONE-step body once as a CUDA
graph (`runtime/graphs.CapturedStep`) and replays that graph N times; it
does not capture N steps in one graph. One capture then serves every N,
the shorter tail dispatch included, and the capture's time and memory do
not grow with N. Between replays the next step's batch and Adam scalars
(`optim.adam_scalars`: one (N, k) table copied to the card per dispatch)
are copied into the graph's static inputs on the card, so the N steps run
with no host sync between them, and each costs the host one graph launch
and a few copies instead of the eager step's ~2000 launches.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..config import OptimizerConfig
from ..ops.collectives import all_reduce_sum_
from ..parallel.layout import is_expert, tp_dim
from ..runtime.graphs import CapturedStep
from .optim import AdamState, adam_scalars, adam_update, global_norm
from .zero import held_bytes

StepFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, AdamState]]


@torch.no_grad()
def reduce_grads(model, grads, plan=None):
    """Steps (a) and (b) of the module docstring on `grads` (keyed like
    the model's parameters); returns the gradients Adam takes. Without a
    bucketed or stage >= 2 `plan`, in place: the tp sum of the replicated
    parameters' gradients under sequence parallelism, then the batch
    group's sum of every gradient in one flat buffer (at ep > 1 the
    experts' over the expert batch group). Otherwise the plan's reducer
    (`ZeroPlan.reduce_grads`): in place at stages 0 and 1, at stages 2
    and 3 new f32 tensors, this rank's dp shards of the sharded leaves."""
    mesh = model.mesh
    if mesh is None:
        return grads
    if plan is not None and (plan.bucket_mb or plan.stage >= 2):
        red = plan.reduce_grads(grads)
        if plan.stage >= 2:
            return red
        # whole gradients: back into the buffers they came from
        torch._foreach_copy_(list(grads.values()), [red[k] for k in grads])
        return grads
    if model.sequence_parallel:
        all_reduce_sum_([g for k, g in grads.items() if tp_dim(k) is None],
                        mesh, "tp")
    if mesh.ep == 1:
        all_reduce_sum_(list(grads.values()), mesh, "batch")
        return grads
    all_reduce_sum_([g for k, g in grads.items() if not is_expert(k)],
                    mesh, "batch")
    all_reduce_sum_([g for k, g in grads.items() if is_expert(k)], mesh,
                    "expert_batch")
    return grads


def build_train_step(model, ocfg: OptimizerConfig,
                     loss_mode: str = "vocab_parallel", plan=None) -> StepFn:
    """Returns `step(opt_state, input_ids, target_ids, position_ids) ->
    (loss, grad_norm, opt_state)`; the model's parameters are updated in
    place. `grad_norm` is the norm of the unclipped gradient, the JAX
    step's logged value. It is the accumulating step with one microbatch
    (its `held_bytes` too)."""
    accum_step = build_grad_accum_step(model, ocfg, loss_mode, plan)

    def step(opt_state: AdamState, input_ids, target_ids, position_ids):
        return accum_step(opt_state, input_ids[None], target_ids[None],
                          position_ids[None])

    step.held_bytes = accum_step.held_bytes
    return step


def build_grad_accum_step(model, ocfg: OptimizerConfig,
                          loss_mode: str = "vocab_parallel",
                          plan=None) -> StepFn:
    """Gradient accumulation: ONE optimizer step from the MEAN of the
    microbatch gradients. `step(opt_state, input_ids(A,B,T),
    target_ids(A,B,T), position_ids(A,B,T)) -> (mean_loss, grad_norm,
    opt_state)`: each microbatch's masked token-mean CE and its gradient get
    equal weight (mean of means, as the JAX step); peak activation memory
    stays that of one microbatch. `scalars`, when given, is this step's
    `optim.adam_scalars` on the card (the captured step's Adam input).

    `plan` (`training/zero.ZeroPlan`, or None for stage 0's flat reducer)
    picks the reducer, the part of each leaf Adam updates (the moments in
    `opt_state` are at those shapes: `plan.init_state`) and, at stages 1
    and 2, the all-gather of the fresh shards. After each call
    `step.held_bytes` holds this rank's bytes of params, of the grads Adam
    took and of the moments (`zero.held_bytes`)."""
    params = dict(model.named_parameters())
    held = {}

    def step(opt_state: AdamState, input_ids, target_ids, position_ids,
             scalars=None):
        for p in params.values():
            p.grad = None
        a = input_ids.shape[0]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=input_ids.device)
        for i in range(a):
            loss = model.loss(input_ids[i], target_ids[i], position_ids[i],
                              mode=loss_mode)
            loss.backward()  # sums into .grad
            loss_sum = loss_sum + loss.detach()
        grads = reduce_grads(model, {k: p.grad for k, p in params.items()},
                             plan)
        stage = 0 if plan is None else plan.stage
        if stage == 2:
            for p in params.values():    # the shards replace them
                p.grad = None
        if a > 1:
            torch._foreach_div_(list(grads.values()), a)
        # of the MEAN gradient, what Adam sees
        sharded = ([k for k in grads if plan.sharded(k)] if stage >= 2
                   else ())
        gnorm = global_norm(grads, model.mesh, sharded)
        owned = params if plan is None else plan.owned(params)
        opt_state = adam_update(
            ocfg, owned, grads if stage != 1 else plan.owned(grads),
            opt_state, model.mesh, gnorm, scalars)
        if plan is not None:
            plan.gather_params(params)
        held.update(held_bytes(params, grads, opt_state))
        return loss_sum / a, gnorm, opt_state

    step.held_bytes = held
    return step


def build_train_step_multi(model, ocfg: OptimizerConfig,
                           loss_mode: str = "vocab_parallel",
                           plan=None) -> StepFn:
    """N optimizer steps per dispatch (the JAX `build_train_step_multi`):
    `step(opt_state, input_ids(N,B,T), target_ids(N,B,T),
    position_ids(N,B,T)) -> (losses(N), grad_norm, opt_state)`, the same
    training as N calls of `build_train_step`, bitwise; `grad_norm` is the
    last step's. On a card the one-step body is captured at the first call
    and replayed N times (module docstring); on the CPU the same body runs
    N times. The steps' Adam scalars come from one device table, so the
    capture holds no host value of a step. The captured step holds the
    parameters and the moments of the first call's state: later calls pass
    that state on. One rank only: at more than one, the hops between ranks
    are staged through host memory (gloo), which a capture cannot hold."""
    if model.mesh is not None and model.mesh.world > 1:
        raise NotImplementedError(
            "several steps per dispatch at more than one rank: the "
            "host-staged hops cannot be captured, and NCCL is unrun, see "
            "ROADMAP Queue 1 item 2")
    body = build_grad_accum_step(model, ocfg, loss_mode, plan)
    params = dict(model.named_parameters())
    graph = held = None   # the captured step, the moments it holds

    def one(opt_state, ids, tgt, pos, scalars):
        loss, gnorm, _ = body(opt_state, ids[None], tgt[None], pos[None],
                              scalars)
        return loss, gnorm

    def capture(opt_state, examples) -> CapturedStep:
        # the warm-up runs real steps: the parameters and moments it moves
        # are put back before the first replay
        state = [*params.values(), *opt_state.mu.values(),
                 *opt_state.nu.values()]
        kept = [t.detach().clone() for t in state]
        captured = CapturedStep(lambda *x: one(opt_state, *x), examples)
        with torch.no_grad():
            torch._foreach_copy_(state, kept)
        return captured

    def step(opt_state: AdamState, input_ids, target_ids, position_ids):
        nonlocal graph, held
        n = input_ids.shape[0]
        table = torch.from_numpy(np.stack(
            [adam_scalars(ocfg, opt_state.step + i) for i in range(n)]
        )).to(input_ids.device)
        batches = [(input_ids[i], target_ids[i], position_ids[i], table[i])
                   for i in range(n)]
        if input_ids.device.type == "cpu":
            outs = [one(opt_state, *x) for x in batches]
            losses, gnorm = torch.stack([l for l, _ in outs]), outs[-1][1]
        else:
            if graph is None:
                graph, held = capture(opt_state, batches[0]), opt_state.mu
            elif opt_state.mu is not held:
                raise ValueError("the captured step holds the moments of "
                                 "its first call's state; pass that state on")
            losses = torch.empty(n, dtype=torch.float32,
                                 device=input_ids.device)
            for i, x in enumerate(batches):
                loss, gnorm = graph(*x)
                losses[i].copy_(loss)
            gnorm = gnorm.clone()
        return losses, gnorm, AdamState(step=opt_state.step + n,
                                        mu=opt_state.mu, nu=opt_state.nu)

    step.held_bytes = body.held_bytes
    return step
