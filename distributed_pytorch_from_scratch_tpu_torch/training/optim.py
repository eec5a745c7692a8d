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
from ..ops.collectives import all_reduce_sum
from ..parallel.layout import is_expert, tp_dim

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


def global_norm(grads: Tensors, mesh=None, dp_sharded=()) -> torch.Tensor:
    """Global L2 norm over every gradient, reduced in float32 — shared by
    the clipper and the train step's logged grad norm. A device tensor: no
    host sync.

    On a mesh each rank holds its shard of the tp-sharded gradients, its
    ep rank's experts and a whole copy of the replicated ones: the squares
    of the experts are summed over the ep group, those of every tp-sharded
    leaf (the experts' included) over the tp group, and the replicated
    ones are counted once. Under ZeRO 2 and 3 the leaves `dp_sharded`
    names are this rank's dp shards: their squares are summed over dp too
    (no MoE there)."""
    def sq(keys):
        out = torch.zeros((), dtype=torch.float32,
                          device=next(iter(grads.values())).device)
        for k in keys:
            out = out + torch.sum(torch.square(grads[k].float()))
        return out

    if mesh is not None and mesh.dp > 1 and dp_sharded:
        on_dp = set(dp_sharded)
        by = lambda tp_sh, dp_sh: [k for k in grads
                                   if (tp_dim(k) is not None) == tp_sh
                                   and (k in on_dp) == dp_sh]
        over_dp = all_reduce_sum(torch.stack([sq(by(True, True)),
                                              sq(by(False, True))]),
                                 mesh, "dp")
        tp_sum = all_reduce_sum(over_dp[0] + sq(by(True, False)), mesh,
                                "tp")
        return torch.sqrt(tp_sum + over_dp[1] + sq(by(False, False)))
    if mesh is None or (mesh.tp == 1 and mesh.ep == 1):
        return torch.sqrt(sq(grads))
    experts = [k for k in grads if is_expert(k)]
    sharded = [k for k in grads
               if tp_dim(k) is not None and not is_expert(k)]
    replicated = [k for k in grads if tp_dim(k) is None]
    local = sq(sharded)
    if experts:
        local = local + all_reduce_sum(sq(experts), mesh, "ep")
    return torch.sqrt(all_reduce_sum(local, mesh, "tp") + sq(replicated))


def clip_by_global_norm(grads: Tensors, max_norm: float, mesh=None,
                        norm=None) -> Tensors:
    """torch `clip_grad_norm_` semantics: one L2 norm over every gradient
    (`norm`, when the caller has it), scaled by max_norm/(norm + 1e-6) only
    when the norm exceeds max_norm."""
    norm = global_norm(grads, mesh) if norm is None else norm
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


# the per-step scalars of one Adam(W) update, in `adam_scalars` order
ADAM_SCALARS = ("decay", "beta1", "one_minus_beta1", "inv_bc1", "inv_bc2",
                "lr")


def adam_scalars(cfg: OptimizerConfig, step: int) -> np.ndarray:
    """The `ADAM_SCALARS` of the update that completes step `step` + 1, as
    float32: the decoupled decay factor 1 - lr*wd, beta1, 1 - beta1, the
    reciprocals of the two bias corrections 1 - beta^t, and lr, from this
    step's scheduled (lr, beta1). Each is the float32 value the host-scalar
    update hands the kernels, so an update from a device copy of them is
    bitwise the same.

    The bias corrections are applied as products with their float32
    reciprocals. On the card that is what dividing by a host float
    computes (PyTorch multiplies by the reciprocal there), while a device
    tensor would be divided by exactly; the product is the same on every
    device, whichever side the scalar lives on."""
    lr, beta1 = schedule_lr(cfg, step)
    t = _f32(step + 1)
    bc1 = _f32(1.0) - np.power(beta1, t, dtype=_f32)
    bc2 = _f32(1.0) - np.power(_f32(cfg.betas[1]), t, dtype=_f32)
    return np.array([_f32(1.0) - lr * _f32(cfg.weight_decay), beta1,
                     _f32(1.0) - beta1, _f32(1.0) / bc1, _f32(1.0) / bc2,
                     lr], dtype=_f32)


@torch.no_grad()
def adam_update(cfg: OptimizerConfig, params: Tensors, grads: Tensors,
                state: AdamState, mesh=None, norm=None,
                scalars: torch.Tensor = None) -> AdamState:
    """One Adam(W) step with this step's scheduled (lr, beta1), in place on
    `params` and the moments; returns the state with step + 1.

        mu <- b1*mu + (1-b1)*g
        nu <- b2*nu + (1-b2)*g^2
        p  <- p - lr * (mu/(1-b1^t)) / (sqrt(nu/(1-b2^t)) + eps)

    and with cfg.weight_decay > 0, p *= 1 - lr*wd first (AdamW). The clip
    takes the global norm of a tp-sharded gradient over `mesh`; `norm` is
    that norm when the caller has taken it already.

    `scalars`, when given, is this step's `adam_scalars` as a float32
    tensor on the parameters' device, read there by the kernels (the
    Tensor-scalar overloads of `torch._foreach_*`) in place of host floats
    from `state.step`: a captured step (`train_step.build_train_step_multi`)
    replays with new values in it, where host floats would stay frozen at
    the capture's. The arithmetic is the same (products only, see
    `adam_scalars`), so the result is bitwise that of the host-scalar
    update."""
    if cfg.clip_grad_norm is not None:
        grads = clip_by_global_norm(grads, cfg.clip_grad_norm, mesh, norm)
    if scalars is None:
        decay, beta1, one_minus_beta1, inv_bc1, inv_bc2, lr = (
            float(x) for x in adam_scalars(cfg, state.step))
    else:
        decay, beta1, one_minus_beta1, inv_bc1, inv_bc2, lr = (
            scalars.unbind(0))
    beta2 = cfg.betas[1]

    keys = list(params)
    p = [params[k] for k in keys]
    g = [grads[k].to(params[k].dtype) for k in keys]
    m = [state.mu[k] for k in keys]
    v = [state.nu[k] for k in keys]
    if cfg.weight_decay:
        torch._foreach_mul_(p, decay)
    # m <- beta1*m + (1-beta1)*g
    torch._foreach_mul_(m, beta1)
    torch._foreach_add_(m, torch._foreach_mul(g, one_minus_beta1))
    # v <- beta2*v + (1-beta2)*g^2
    torch._foreach_mul_(v, beta2)
    gg = torch._foreach_mul(g, g)
    torch._foreach_mul_(gg, 1.0 - beta2)
    torch._foreach_add_(v, gg)
    # p <- p - lr * m_hat / (sqrt(v_hat) + eps)
    step = torch._foreach_mul(m, inv_bc1)
    denom = torch._foreach_mul(v, inv_bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    torch._foreach_mul_(step, lr)
    torch._foreach_div_(step, denom)
    torch._foreach_sub_(p, step)
    return AdamState(step=state.step + 1, mu=state.mu, nu=state.nu)
