"""Adam(W) + OneCycle/cosine LR schedule, written by hand — the port's copy
of the JAX `training/optim.py`, line for line on torch tensors.

* Adam: bias-corrected moments, eps outside the sqrt (torch defaults,
  betas=(0.9, 0.999), eps=1e-8). With `weight_decay > 0` the update is
  torch.optim.AdamW's: decoupled decay `p *= 1 - lr*wd` before the moment
  update.
* OneCycleLR (torch defaults): cosine warmup `lr/div_factor -> lr` over
  pct_start, cosine anneal to `initial_lr/final_div_factor`; beta1 is
  cycled too (max_momentum -> base_momentum -> max_momentum), and the bias
  correction uses the CURRENT beta1, as torch does once the scheduler has
  rewritten the param groups.

The schedule runs on the host in float32 (numpy), as the JAX package
evaluates it in float32 on the device; the step count is a host integer, so
computing (lr, beta1) needs no device sync. Parameters and moments are
updated IN PLACE (torch's idiom; the JAX function returns new trees, and
its jit donates the old buffers for the same effect). `params`, `grads`,
`mu` and `nu` are dicts keyed like `Transformer.state_dict()`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..config import OptimizerConfig

Tensors = Dict[str, torch.Tensor]
_f32 = np.float32


class AdamState(NamedTuple):
    step: int    # completed optimizer steps
    mu: Tensors  # first moment, keyed like the params
    nu: Tensors  # second moment


def init_adam_state(params: Tensors) -> AdamState:
    zeros = {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
             for k, p in params.items()}
    return AdamState(step=0, mu=zeros,
                     nu={k: torch.zeros_like(z) for k, z in zeros.items()})


def _anneal_cos(start: float, end: float, pct: np.float32) -> np.float32:
    # (start - end) / 2 in double, then float32 — the JAX expression's
    # rounding points (Python floats meet a float32 array)
    return _f32(end) + _f32((start - end) / 2.0) * (
        _f32(1.0) + np.cos(_f32(np.pi) * pct, dtype=_f32))


def onecycle_lr(cfg: OptimizerConfig, step: int) -> Tuple[np.float32,
                                                          np.float32]:
    """(lr, beta1) at optimizer step `step` (0-based: the schedule value
    used by the (step+1)-th update)."""
    total = cfg.max_steps
    pct_start = cfg.warmup_steps / cfg.max_steps
    # torch's phase boundaries: warmup ends at pct_start*total - 1,
    # annealing at total - 1 (OneCycleLR._schedule_phases)
    up_end = float(pct_start * total) - 1.0
    down_end = float(total) - 1.0
    initial_lr = cfg.lr / cfg.div_factor
    min_lr = initial_lr / cfg.final_div_factor

    stepf = _f32(step)
    up_pct = np.clip(stepf / _f32(max(up_end, 1e-9)), _f32(0), _f32(1))
    down_pct = np.clip((stepf - _f32(up_end))
                       / _f32(max(down_end - up_end, 1e-9)), _f32(0), _f32(1))
    in_warmup = stepf <= _f32(up_end)
    lr = (_anneal_cos(initial_lr, cfg.lr, up_pct) if in_warmup
          else _anneal_cos(cfg.lr, min_lr, down_pct))
    if cfg.cycle_momentum:
        beta1 = (_anneal_cos(cfg.max_momentum, cfg.base_momentum, up_pct)
                 if in_warmup
                 else _anneal_cos(cfg.base_momentum, cfg.max_momentum,
                                  down_pct))
    else:
        beta1 = _f32(cfg.betas[0])
    return _f32(lr), _f32(beta1)


def cosine_lr(cfg: OptimizerConfig, step: int) -> Tuple[np.float32,
                                                        np.float32]:
    """Linear warmup over warmup_steps -> cosine decay to
    cosine_min_ratio * lr at max_steps; beta1 fixed."""
    stepf = _f32(step)
    warm = _f32(max(cfg.warmup_steps, 1))
    total = _f32(max(cfg.max_steps - cfg.warmup_steps, 1))
    min_lr = cfg.lr * cfg.cosine_min_ratio
    if stepf < _f32(cfg.warmup_steps):
        lr = _f32(cfg.lr) * min(_f32(1.0), (stepf + _f32(1.0)) / warm)
    else:
        pct = np.clip((stepf - _f32(cfg.warmup_steps)) / total,
                      _f32(0), _f32(1))
        lr = _anneal_cos(cfg.lr, min_lr, pct)
    return _f32(lr), _f32(cfg.betas[0])


def schedule_lr(cfg: OptimizerConfig, step: int) -> Tuple[np.float32,
                                                          np.float32]:
    """(lr, beta1) for this step under cfg.lr_schedule."""
    if cfg.lr_schedule == "cosine":
        return cosine_lr(cfg, step)
    if cfg.lr_schedule != "onecycle":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                         "(choices: 'onecycle', 'cosine')")
    return onecycle_lr(cfg, step)


def global_norm(grads: Tensors) -> torch.Tensor:
    """Global L2 norm over every gradient, reduced in float32 — shared by
    the clipper and the train step's logged grad norm. A device tensor: no
    host sync."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tensors:
    """torch `clip_grad_norm_` semantics: one L2 norm over every gradient,
    scaled by max_norm/(norm + 1e-6) only when the norm exceeds max_norm."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-6), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


@torch.no_grad()
def adam_update(cfg: OptimizerConfig, params: Tensors, grads: Tensors,
                state: AdamState) -> AdamState:
    """One Adam(W) step with this step's scheduled (lr, beta1), in place on
    `params` and the moments; returns the state with step + 1.

        mu <- b1*mu + (1-b1)*g
        nu <- b2*nu + (1-b2)*g^2
        p  <- p - lr * (mu/(1-b1^t)) / (sqrt(nu/(1-b2^t)) + eps)

    and with cfg.weight_decay > 0, p *= 1 - lr*wd first (AdamW)."""
    if cfg.clip_grad_norm is not None:
        grads = clip_by_global_norm(grads, cfg.clip_grad_norm)
    lr, beta1 = schedule_lr(cfg, state.step)
    beta2 = cfg.betas[1]
    t = _f32(state.step + 1)
    bc1 = _f32(1.0) - np.power(beta1, t, dtype=_f32)
    bc2 = _f32(1.0) - np.power(_f32(beta2), t, dtype=_f32)

    keys = list(params)
    p = [params[k] for k in keys]
    g = [grads[k].to(params[k].dtype) for k in keys]
    m = [state.mu[k] for k in keys]
    v = [state.nu[k] for k in keys]
    if cfg.weight_decay:
        torch._foreach_mul_(p, float(_f32(1.0) - lr * _f32(cfg.weight_decay)))
    # m <- beta1*m + (1-beta1)*g
    torch._foreach_mul_(m, float(beta1))
    torch._foreach_add_(m, torch._foreach_mul(g, float(_f32(1.0) - beta1)))
    # v <- beta2*v + (1-beta2)*g^2
    torch._foreach_mul_(v, beta2)
    gg = torch._foreach_mul(g, g)
    torch._foreach_mul_(gg, 1.0 - beta2)
    torch._foreach_add_(v, gg)
    # p <- p - lr * m_hat / (sqrt(v_hat) + eps)
    step = torch._foreach_div(m, float(bc1))
    denom = torch._foreach_div(v, float(bc2))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    torch._foreach_mul_(step, float(lr))
    torch._foreach_div_(step, denom)
    torch._foreach_sub_(p, step)
    return AdamState(step=state.step + 1, mu=state.mu, nu=state.nu)
