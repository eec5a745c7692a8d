"""The training step: loss + grads + Adam/OneCycle update — the port's
counterpart of the JAX `training/train_step.py` at tp=1.

Where JAX jits one donated program per step, torch runs eagerly: the step
zeroes the grads, runs the forward and `backward()`, takes the global grad
norm and updates the parameters and moments in place. It returns
`(loss, grad_norm)` as device tensors and reads nothing back to the host,
so the caller decides when to sync (the train loop does so once per log
interval).

At cp > 1 every rank runs the step on its chunk of the batch; after the
backward the gradients are summed over the cp group in one flat buffer
(each rank's loss is its local sum over the global count, so the sum is the
global loss's gradient), and only then are the norm, the clip and Adam
taken — every rank then holds the same parameters.

Not ported: the multi-step-per-dispatch variant (`lax.scan` over N steps
in one program), whose eager counterpart would be a CUDA graph (ROADMAP),
and the ZeRO / bucketed dp reducers (multi-device work).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..config import OptimizerConfig
from ..ops.collectives import all_reduce_sum_
from .optim import AdamState, adam_update, global_norm

StepFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, AdamState]]


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
        if model.cp_size > 1:
            all_reduce_sum_(list(grads.values()), model.mesh)
        if a > 1:
            torch._foreach_div_(list(grads.values()), a)
        gnorm = global_norm(grads)  # of the MEAN gradient, what Adam sees
        opt_state = adam_update(ocfg, params, grads, opt_state)
        return loss_sum / a, gnorm, opt_state

    return step
