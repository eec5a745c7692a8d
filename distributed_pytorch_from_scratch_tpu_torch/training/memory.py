"""Activation-memory estimates + the per-config remat policy selector: the
port's copy of the JAX `training/memory.py`, with the same numbers and
messages.

The remat ladder ('false' fastest, 'dots' bounded residuals, 'true' lowest
memory — models/transformer.py) is picked by `select_remat` from an
itemised activation-memory estimate against the card's memory, so `--remat
auto` (train.py) runs the fastest policy that fits and steps down only when
the numbers say so. The estimate is the JAX package's, itemised for its
XLA step: a `margin` of headroom covers what it cannot see (here the
caching allocator's blocks and cuBLAS workspaces). `hbm_budget_gib` reads
the card's total memory through torch; with no card it assumes the JAX
default, loudly.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

# itemised per-layer residual footprint, in units of (b * t * dtype_bytes):
#   'false' — everything autodiff saves on the flash path: layer input,
#             2 norm outputs, q/k/v (k/v at the kv width), rope'd q/k,
#             flash o + attn-proj input, wo output, gate/up/silu*up, down
#             output  ->  ~9d + 4kd + 3f per token
#   'dots'  — matmul outputs + the pinned flash o/lse only: q/k/v, o,
#             wo out, gate/up, down out  ->  ~4d + 2kd + 2f
#   'true'  — the layer-boundary carry only  ->  d
_LAYER_UNITS = {
    "false": lambda d, kd, f: 9 * d + 4 * kd + 3 * f,
    "dots": lambda d, kd, f: 4 * d + 2 * kd + 2 * f,
    "true": lambda d, kd, f: d,
}


def zero_state_bytes_per_param(zero_stage: int, dp: int,
                               cfg=None) -> float:
    """f32 bytes of RESIDENT train-state per parameter per dp rank under
    the ZeRO ladder (params + grads + 2 Adam moments; training/zero.py, the
    JAX package's ladder):

        stage 0:  4 + 4 + 8            = 16
        stage 1:  4 + 4 + 8/dp         (moments dp-sharded)
        stage 2:  4 + 4/dp + 8/dp      (grads reduce-scattered too)
        stage 3:  (4 + 4 + 8)/dp + transient gathered working set

    Stage 3's transient term (one gathered layer + the gathered non-layer
    leaves that live through the step) needs `cfg` for the layer split;
    it is charged as 4 bytes x (per-layer params + embed/head params) on
    top of the 16/dp resident floor. tests/test_torch_dispatch.py holds
    this copy to the JAX one; `zero.expected_state_bytes` counts a
    rank's resident bytes with it, leaf by leaf (without `cfg`).
    """
    dp = max(dp, 1)
    if zero_stage <= 0 or dp == 1:
        return 16.0
    if zero_stage == 1:
        return 8.0 + 8.0 / dp
    if zero_stage == 2:
        return 4.0 + 12.0 / dp
    # stage 3: everything resident is sharded; the gather working set is
    # one layer (the scan bound) plus the embedding/head/final-norm leaves
    # gathered at their use sites and saved as backward residuals
    extra = 0.0
    if cfg is not None:
        P = cfg.num_params()
        nonlayer = (2 * cfg.vocab_size * cfg.attn_dim + cfg.vocab_size
                    + cfg.attn_dim)
        per_layer = max((P - nonlayer) / max(cfg.num_layers, 1), 0.0)
        extra = 4.0 * (per_layer + nonlayer) / max(P, 1)
    return 16.0 / dp + extra


def estimate_step_gib(cfg, batch: int, seqlen: int, remat: str,
                      tp: int = 1, world: int = 1,
                      dtype_bytes: int = 2, zero_stage: int = 0,
                      dp: int = 1) -> float:
    """Peak-HBM estimate (GiB, per device) for one fwd+bwd+adam train step.

    Fixed state: params + grads (f32) + 2 Adam moments (f32) — 16 bytes
    per parameter un-sharded, shrunk by the ZeRO ladder per
    `zero_state_bytes_per_param` (stage 1 moments/dp, stage 2 +grads/dp,
    stage 3 everything/dp + the gathered working set) — replicated over tp
    for the norm/embed parts but sharded for the big matrices:
    approximated as P * state_bytes / max(tp, 1) + 10% for the replicated
    remainder. Activations shard over tp (the t or head dim); the batch shards over
    dp/ep, folded into `world / tp`.
    """
    remat = str(remat).lower()
    if remat not in _LAYER_UNITS:
        raise ValueError(f"remat must be one of {sorted(_LAYER_UNITS)}, "
                         f"got {remat!r}")
    d, f, L = cfg.attn_dim, cfg.ffn_dim, cfg.num_layers
    kd = cfg.kv_dim
    if cfg.num_experts:
        # each token's residuals touch top_k expert FFNs plus the dispatch
        # buffers (~capacity_factor x the dense width)
        f = int(f * max(cfg.moe_top_k, 1) * cfg.moe_capacity_factor / 2)
    P = cfg.num_params()
    dp_like = max(world // max(tp, 1), 1)
    b_local = max(batch // dp_like, 1)
    tok = b_local * seqlen

    state = zero_state_bytes_per_param(zero_stage, dp, cfg)
    fixed = P * state / max(tp, 1) * 1.10
    acts = L * tok * _LAYER_UNITS[remat](d, kd, f) * dtype_bytes / max(tp, 1)
    # flash lse rows (f32) are saved on every policy that keeps o/lse
    if remat != "true":
        acts += L * b_local * cfg.num_heads * seqlen * 4 / max(tp, 1)
    # the head: logits in f32 for the CE (vocab-parallel: sharded over tp)
    # appear twice at the bwd peak (value + cotangent)
    logits = 2 * tok * cfg.padded_vocab_size(tp) * 4 / max(tp, 1)
    # transient optimizer update working set ~ one f32 param tree at the
    # optimizer's RESIDENT layout (fully dp-local under ZeRO-3)
    opt_scratch = P * 4 / max(tp, 1)
    if zero_stage >= 3:
        opt_scratch /= max(dp, 1)
    return (fixed + acts + logits + opt_scratch) / 1024 ** 3


_warned_assumed_budget = []


def hbm_budget_gib(default: float = 16.0, device=None) -> float:
    """Per-card memory in GiB: the total memory of `device` (default: the
    current CUDA card, when there is one) as torch reports it. With no card
    (a CPU device, or none visible) it falls back to `default` (the JAX
    package's v5e figure) — LOUDLY, once per process: a silently assumed
    budget would pass for the card's, and `--remat auto` decisions made on
    it must be attributable to the assumption."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 1024 ** 3
    if not _warned_assumed_budget:
        _warned_assumed_budget.append(True)
        print(f"note: no CUDA card — HBM budget UNAVAILABLE, assuming "
              f"{default:g} GiB (v5e); remat/memory decisions sized against "
              f"the assumption, not the chip", file=sys.stderr)
    return default


def select_remat(cfg, batch: int, seqlen: int, tp: int = 1, world: int = 1,
                 budget_gib: Optional[float] = None,
                 margin: float = 0.75, verbose: bool = True,
                 zero_stage: int = 0, dp: int = 1) -> str:
    """The fastest remat policy whose estimated peak fits margin * budget.

    Returns a REMAT_CHOICES key ('false' | 'dots' | 'true'). margin=0.75
    leaves a quarter of HBM for XLA temps, fusion scratch, and the
    donation-transition double-buffering the estimate cannot see.

    `zero_stage`/`dp` size the train state per the ZeRO ladder (see
    `estimate_step_gib`) so `--remat auto` picks against the budget the
    stage actually leaves. Stage 3 never picks 'false': without remat,
    autodiff saves every layer's GATHERED weights as backward residuals —
    the full replica the stage exists to eliminate (the train CLI refuses
    the explicit combination with the same rationale).
    """
    budget = budget_gib if budget_gib is not None else hbm_budget_gib()
    usable = budget * margin
    picked = "true"
    sizes = {}
    policies = ("false", "dots", "true")
    if zero_stage >= 3:
        policies = ("dots", "true")
    for policy in policies:
        sizes[policy] = estimate_step_gib(cfg, batch, seqlen, policy,
                                          tp=tp, world=world,
                                          zero_stage=zero_stage, dp=dp)
        if sizes[policy] <= usable:
            picked = policy
            break
    if verbose:
        est = ", ".join(f"{p}={v:.2f}GiB" for p, v in sizes.items())
        zn = f", zero{zero_stage} dp{dp}" if zero_stage else ""
        print(f"remat auto: picked '{picked}' (estimates {est}; budget "
              f"{budget:.1f} GiB x margin {margin}{zn})", file=sys.stderr)
    return picked
