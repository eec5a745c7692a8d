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
(b) every gradient is summed over the batch group (the dp x cp ranks of
    this tp index) in one flat buffer: each rank's loss is its local sum
    over the global count, so the sum is the global loss's gradient;
(c) then the norm (the tp-sharded squares summed over tp), the clip and
    Adam — every rank of a tp index then holds the same parameters.

Not ported: the multi-step-per-dispatch variant (`lax.scan` over N steps
in one program), whose eager counterpart would be a CUDA graph (ROADMAP),
and the ZeRO / bucketed dp reducers (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..config import OptimizerConfig
from ..ops.collectives import all_reduce_sum_
from ..parallel.layout import tp_dim
from .optim import AdamState, adam_update, global_norm

StepFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, AdamState]]


@torch.no_grad()
def reduce_grads(model, grads) -> None:
    """Steps (a) and (b) of the module docstring, in place on `grads`
    (keyed like the model's parameters): the tp sum of the replicated
    parameters' gradients under sequence parallelism, then the batch
    group's sum of every gradient."""
    mesh = model.mesh
    if mesh is None:
        return
    if model.sequence_parallel:
        all_reduce_sum_([g for k, g in grads.items() if tp_dim(k) is None],
                        mesh, "tp")
    all_reduce_sum_(list(grads.values()), mesh, "batch")


def build_train_step(model, ocfg: OptimizerConfig,
                     loss_mode: str = "vocab_parallel") -> StepFn:
    """Returns `step(opt_state, input_ids, target_ids, position_ids) ->
    (loss, grad_norm, opt_state)`; the model's parameters are updated in
    place. `grad_norm` is the norm of the unclipped gradient, the JAX
    step's logged value. It is the accumulating step with one microbatch."""
    accum_step = build_grad_accum_step(model, ocfg, loss_mode)

    def step(opt_state: AdamState, input_ids, target_ids, position_ids):
        return accum_step(opt_state, input_ids[None], target_ids[None],
                          position_ids[None])

    return step


def build_grad_accum_step(model, ocfg: OptimizerConfig,
                          loss_mode: str = "vocab_parallel") -> StepFn:
    """Gradient accumulation: ONE optimizer step from the MEAN of the
    microbatch gradients. `step(opt_state, input_ids(A,B,T),
    target_ids(A,B,T), position_ids(A,B,T)) -> (mean_loss, grad_norm,
    opt_state)`: each microbatch's masked token-mean CE and its gradient get
    equal weight (mean of means, as the JAX step); peak activation memory
    stays that of one microbatch."""
    params = dict(model.named_parameters())

    def step(opt_state: AdamState, input_ids, target_ids, position_ids):
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
        grads = {k: p.grad for k, p in params.items()}
        reduce_grads(model, grads)
        if a > 1:
            torch._foreach_div_(list(grads.values()), a)
        # of the MEAN gradient, what Adam sees
        gnorm = global_norm(grads, model.mesh)
        opt_state = adam_update(ocfg, params, grads, opt_state, model.mesh,
                                gnorm)
        return loss_sum / a, gnorm, opt_state

    return step
