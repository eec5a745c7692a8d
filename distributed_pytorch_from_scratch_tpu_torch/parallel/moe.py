"""Mixture-of-Experts FFN with expert parallelism — the port of the JAX
`parallel/moe.py`: top-k routed SwiGLU experts under a capacity limit, the
experts sharded over the mesh axis 'ep' and each expert's hidden dim over
'tp'.

One layer's forward, on this rank's tokens (S = every token of the call):

* the router (d, E), float32 and zero-initialised, gives (S, E) logits
  from the float32 input; `_route` turns them into a flat slot id per
  (token, choice) in an (E * C) buffer, C = max(4, ceil(cf * S * k / E)),
  and the combine weight of each. The top k are picked by a stable
  descending sort, so ties (every expert ties under the zero router) go
  to the lowest index, as `lax.top_k` takes them, on every device.
  Priority is slot-major: every first choice beats every second choice,
  in token order within a choice (a cumsum over the (k, S)-flattened
  one-hots). A choice past its expert's capacity is dropped: its slot is
  the trash row E * C and its weight 0, and the token falls through the
  residual.
* dispatch: every kept (token, choice) copy is added into its slot of an
  (E * C + 1, d) buffer in the compute dtype (each slot receives at most
  one token, so the sum is deterministic; the trash row takes the rest
  and is cut off);
* at ep > 1 one `all_to_all` over ep takes (E, C, d) to (E/ep, ep * C, d):
  this rank's experts' slots from every peer, in peer order;
* the batched SwiGLU over the local experts, three `torch.bmm`s in the
  compute dtype: gate and up column-sharded over tp (E/ep, d, f/tp), down
  row-sharded (E/ep, f/tp, d), its partial sums all-reduced over tp;
* the reverse `all_to_all`, then the combine: each (token, choice) gathers
  its slot's output (the trash row reads zeros) and the k are summed,
  weighted.

Static shapes throughout: no boolean indexing, no `.item()`, so a decode
step that runs the layer stays capturable as a CUDA graph.

The tp pairs depend on the layer's input layout (`forward`'s
`sequence_parallel`): without it the input is the same on every tp rank,
`copy_to` goes on the dispatched buffer (the JAX `copy_to(expert_in)`) and
the combine is the same on every rank; under sequence parallelism the
caller passes the tp-gathered sequence (whose backward reduce-scatters the
input's gradient), so there is no `copy_to` on the buffer, and the
experts' output takes one (its cotangent is summed over the tp ranks, each
of which keeps only its chunk of the combine: JAX's pvary of the psum'd
output).

`forward` returns (y, aux): aux holds this call's LOCAL sums (the routed
count per expert, the router's probability mass per expert, the sum of
squared logsumexps, the token count and the dropped choices); the model's
loss sums them over the batch group and `aux_losses` turns them into the
Switch load-balance loss and the router z-loss.

Serving discards aux; there `count_drops` gives each layer a device tally
of (dropped choices, choices) that every forward adds to, inside a
captured decode step too, and `dropped_share` reads it: the share of
(token, choice) copies the capacity limit dropped, over every row of the
dispatches (padded and free rows included, as the capacity counts them).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from ..ops.collectives import all_to_all, copy_to, reduce_from

Aux = Dict[str, torch.Tensor]
# a layer's aux sums, in `aux_zeros` order
AUX_KEYS = ("tokens_per_expert", "prob_sum", "z_sum", "tokens", "dropped")


def validate_moe(f: int, num_experts: int, top_k: int, ep_size: int = 1,
                 tp_size: int = 1) -> None:
    """The JAX `MoEFFN.__post_init__` checks, with its messages."""
    if num_experts % ep_size != 0:
        raise ValueError(f"num_experts {num_experts} not divisible "
                         f"by ep_size {ep_size}")
    if f % tp_size != 0:
        raise ValueError(f"expert ffn dim {f} not divisible by "
                         f"tp_size {tp_size}")
    if not (1 <= top_k <= num_experts):
        raise ValueError(f"top_k {top_k} out of range for "
                         f"{num_experts} experts")


def capacity(tokens: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert for a call of `tokens` tokens (the JAX
    `_capacity`)."""
    return max(4, math.ceil(capacity_factor * tokens * top_k / num_experts))


def route(logits: torch.Tensor, top_k: int, capacity_factor: float
          ) -> Tuple[torch.Tensor, torch.Tensor, Aux]:
    """(S, E) float32 router logits -> (slots (S, k) int64 flat ids into
    the (E * C) buffer, E * C for a drop; weights (S, k) float32, the top k
    probabilities renormalised to sum to 1, 0 for a drop; the aux local
    sums) — the JAX `_route`."""
    S, E = logits.shape
    C = capacity(S, E, top_k, capacity_factor)
    probs = torch.softmax(logits, dim=-1)
    # stable: equal probabilities keep index order (lax.top_k's ties)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / topv.sum(dim=-1, keepdim=True)
    # (S, k, E) one-hots by comparison (F.one_hot may read the card)
    onehot = (topi[..., None] == torch.arange(E, device=topi.device)).to(
        torch.int32)
    # each expert's running count over the (k, S)-flattened choices, as one
    # scan per expert along a contiguous row (E, k * S)
    flat = onehot.permute(2, 1, 0).reshape(E, top_k * S)
    pos_flat = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = pos_flat.reshape(E, top_k, S).permute(2, 1, 0)             # (S,k,E)
    pos_tok = (pos * onehot).sum(dim=-1)                             # (S,k)
    keep = (pos_tok < C) & (topv > 0)
    slots = torch.where(keep, topi * C + pos_tok, E * C)
    weights = torch.where(keep, topv, torch.zeros((), dtype=topv.dtype,
                                                  device=topv.device))
    aux = {
        "tokens_per_expert": onehot.sum(dim=(0, 1)).float(),
        "prob_sum": probs.sum(dim=0),
        "z_sum": torch.logsumexp(logits, dim=-1).square().sum(),
        "tokens": torch.full((), float(S), dtype=torch.float32,
                             device=logits.device),
        "dropped": (1.0 - keep.float()).sum(),
    }
    return slots, weights, aux


def aux_zeros(num_experts: int, device=None) -> Aux:
    """Zero aux sums of `route`'s structure."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"tokens_per_expert": z(num_experts), "prob_sum": z(num_experts),
            "z_sum": z(), "tokens": z(), "dropped": z()}


def add_aux(a: Aux, b: Aux) -> Aux:
    return {k: a[k] + b[k] for k in AUX_KEYS}


def aux_losses(aux: Aux, num_experts: int, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(load-balance loss, z-loss) from GLOBALLY summed aux sums (the JAX
    `aux_losses`): E * sum_e(f_e * P_e), f_e the share of routed choices
    that went to expert e and P_e its mean router probability (1 under
    uniform routing), and the mean squared logsumexp."""
    tokens = torch.clamp(aux["tokens"], min=1.0)
    f = aux["tokens_per_expert"] / (tokens * top_k)
    p = aux["prob_sum"] / tokens
    return num_experts * torch.sum(f * p), aux["z_sum"] / tokens


class MoEFFN(nn.Module):
    """Top-k routed SwiGLU experts, the dense FFN's drop-in (module
    docstring). Parameters: `router` (d, E) float32, and this rank's
    experts `gate`, `up` (E/ep, d, f/tp) and `down` (E/ep, f/tp, d) — the
    JAX leaves' layout, no transpose."""

    def __init__(self, d: int, f: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 2.0, mesh=None):
        super().__init__()
        tp, ep_size = (1, 1) if mesh is None else (mesh.tp, mesh.ep)
        validate_moe(f, num_experts, top_k, ep_size, tp)
        self.d, self.f = d, f
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.mesh, self.ep_size, self.tp_size = mesh, ep_size, tp
        e, fl = num_experts // ep_size, f // tp
        w = lambda *s: nn.Parameter(torch.empty(*s, dtype=torch.float32))
        self.router = nn.Parameter(torch.zeros(d, num_experts,
                                               dtype=torch.float32))
        self.gate, self.up, self.down = w(e, d, fl), w(e, d, fl), w(e, fl, d)
        self.drop_tally: Optional[torch.Tensor] = None   # `count_drops`

    def reset_parameters(self, generator: torch.Generator) -> None:
        # the JAX init's distributions: a zero router (uniform routing at
        # step 0), experts uniform(+-1/sqrt(idim))
        with torch.no_grad():
            self.router.zero_()
            for p, idim in ((self.gate, self.d), (self.up, self.d),
                            (self.down, self.f)):
                bound = 1.0 / math.sqrt(idim)
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, dtype,
                sequence_parallel: bool = False) -> Tuple[torch.Tensor, Aux]:
        """x (b, t, d) -> (y (b, t, d) in `dtype`, aux local sums). x is
        this rank's tokens, the same on every tp rank (under sequence
        parallelism: the tp-gathered sequence)."""
        b, t, d = x.shape
        S, E, k = b * t, self.num_experts, self.top_k
        xf = x.reshape(S, d)
        logits = xf.float() @ self.router
        slots, weights, aux = route(logits, k, self.capacity_factor)
        if self.drop_tally is not None:
            self.drop_tally += torch.stack((aux["dropped"],
                                            aux["tokens"] * k))
        C = capacity(S, E, k, self.capacity_factor)
        xk = xf.to(dtype).repeat_interleave(k, dim=0)          # (S*k, d)
        buf = torch.zeros(E * C + 1, d, dtype=dtype, device=x.device)
        expert_in = buf.index_add(0, slots.reshape(-1), xk)[:E * C]
        expert_in = all_to_all(expert_in.reshape(E, C, d), self.mesh, 0, 1,
                               "ep") if self.ep_size > 1 else \
            expert_in.reshape(E, C, d)
        mesh = self.mesh
        tp = mesh is not None and self.tp_size > 1
        h_in = copy_to(expert_in, mesh) if tp and not sequence_parallel \
            else expert_in
        g = torch.bmm(h_in, self.gate.to(dtype))
        u = torch.bmm(h_in, self.up.to(dtype))
        out = torch.bmm(torch.nn.functional.silu(g) * u, self.down.to(dtype))
        if tp:
            out = reduce_from(out, mesh)
            if sequence_parallel:
                out = copy_to(out, mesh)
        if self.ep_size > 1:
            out = all_to_all(out, mesh, 1, 0, "ep")
        out_flat = torch.cat([out.reshape(E * C, d),
                              out.new_zeros(1, d)])
        picked = out_flat.index_select(0, slots.reshape(-1)).reshape(S, k, d)
        y = (picked * weights[..., None].to(dtype)).sum(dim=1)
        return y.reshape(b, t, d), aux


def count_drops(model: nn.Module, device) -> None:
    """Start (or restart, from zero) the drop tally of every MoE layer of
    `model` on `device`. A tally is zeroed in place, so a captured step
    that adds to it goes on doing so."""
    for m in model.modules():
        if isinstance(m, MoEFFN):
            if m.drop_tally is None:
                # a normal tensor, so an engine built under inference mode
                # still adds to it under no_grad (a graph's capture)
                with torch.inference_mode(False):
                    m.drop_tally = torch.zeros(2, dtype=torch.float32,
                                               device=device)
            else:
                m.drop_tally.zero_()


def dropped_share(models: Iterable[nn.Module]) -> Optional[float]:
    """The share of routed choices the capacity limit dropped since
    `count_drops`, over every MoE layer of `models` (one host copy); None
    where no layer counts."""
    tallies = [m.drop_tally for model in models for m in model.modules()
               if isinstance(m, MoEFFN) and m.drop_tally is not None]
    if not tallies:
        return None
    dropped, choices = torch.stack(tallies).sum(dim=0).tolist()
    return dropped / choices if choices else 0.0
