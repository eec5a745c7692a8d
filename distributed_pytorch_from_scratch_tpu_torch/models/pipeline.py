"""Pipeline parallelism over the mesh's 'pp' axis — the port of the JAX
`Transformer._pipeline_layers` and `_pipeline_interleaved`, shared by both
model families.

Each pp stage holds its own layers (`stage_layer_ids`): under 'gpipe' the
contiguous block of num_layers/pp, under 'interleaved' the V round-robin
blocks v*pp + p (v < V) of Lv = num_layers/(V*pp) layers each. The
model's `layers` ModuleList holds them in that order; `to_canonical` and
`from_canonical` map its state-dict keys to the canonical layer order
(the one the checkpoints hold, whatever the schedule) and back.

The schedules run a local batch as M microbatches, stage by stage, one
pipeline step at a time, as JAX's `lax.scan` does:
* gpipe: M + pp - 1 steps; at step s stage p runs microbatch s - p;
* interleaved: V*M + pp - 1 steps; with r = s - p, stage p runs its block
  (r // pp) % V on microbatch (r // (V*pp))*pp + r % pp, so each
  microbatch goes V times round the ring.
A bubble step (no microbatch for this stage) runs no layer, as JAX's
`lax.cond` skip; every member of a tp, cp, ep or dp group shares its
stage, so all of them skip together and the collectives inside the layers
stay matched (pp x ring cp needs no live gate here). The same holds for
the tp ring collective matmuls (`--tp_overlap ring | ring_q`): JAX runs
the dense segments even on bubble steps under ring overlap, because its
`ppermute` lowers with a global participant list and a stage-divergent
`lax.cond` around it would deadlock; here a tp ring's hops stay inside
one stage's tp group (`collectives.start_hop` over 'tp'), every tp rank of
a stage shares that stage's bubble schedule, so a bubble step still runs
no layer and no hop. Between steps every stage hands its activation on
(`ops/collectives.stage_hop`).

The backward is autograd's, through one graph per rank. Its transfers are
the hops' backwards, so every stage must run every hop's backward, in the
same order: each hop's output stays in the graph on every stage (stage 0
picks its injected microbatch with `torch.where`, as JAX's `jnp.where`,
so the hop it drops still takes a zero cotangent, and the last step's
activation joins the output through `_Tie` where no later step reads it).
The hops form one chain per stage, so autograd runs them in reverse step
order on every stage: the schedule's transpose, JAX's reverse pipeline.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.collectives import reduce_from, reduce_scatter, stage_hop
from ..parallel.moe import add_aux

SCHEDULES = ("gpipe", "interleaved")


def validate_pp(num_layers: int, pp_size: int, pp_microbatches: int,
                pp_schedule: str = "gpipe", pp_virtual: int = 2) -> None:
    """The JAX `validate_pp`, with its messages."""
    if pp_size > 1 and num_layers % pp_size != 0:
        raise ValueError(
            f"num_layers {num_layers} not divisible by pp_size "
            f"{pp_size} (stages hold equal layer counts)")
    if pp_microbatches and pp_size == 1:
        raise ValueError(
            "pp_microbatches requires pp_size > 1 (a non-pipelined model "
            "runs no microbatch schedule; the setting would be silently "
            "ignored)")
    if pp_microbatches and pp_microbatches < pp_size:
        raise ValueError(
            f"pp_microbatches {pp_microbatches} < pp_size "
            f"{pp_size} would leave permanent pipeline bubbles")
    if pp_schedule not in SCHEDULES:
        raise ValueError(f"pp_schedule must be 'gpipe' or 'interleaved', "
                         f"got {pp_schedule!r}")
    if pp_schedule == "interleaved":
        if pp_size == 1:
            raise ValueError("pp_schedule='interleaved' requires pp_size > 1")
        if pp_virtual < 2:
            raise ValueError(
                f"pp_virtual {pp_virtual} < 2: one virtual stage per device "
                f"IS the gpipe schedule; use pp_schedule='gpipe'")
        if num_layers % (pp_size * pp_virtual) != 0:
            raise ValueError(
                f"num_layers {num_layers} not divisible by "
                f"pp_size*pp_virtual {pp_size * pp_virtual} (each device "
                f"holds pp_virtual equal round-robin layer blocks)")
        M = pp_microbatches or pp_size
        if M % pp_size != 0:
            raise ValueError(
                f"interleaved schedule needs pp_microbatches {M} divisible "
                f"by pp_size {pp_size} (microbatches circulate the ring in "
                f"groups of pp_size)")


def stage_layer_ids(num_layers: int, pp: int, stage: int,
                    schedule: str = "gpipe",
                    virtual: int = 2) -> List[int]:
    """The canonical indices of the layers stage `stage` holds, in its
    ModuleList's order (block by block)."""
    if pp == 1:
        return list(range(num_layers))
    if schedule == "interleaved":
        lv = num_layers // (virtual * pp)
        return [(v * pp + stage) * lv + i for v in range(virtual)
                for i in range(lv)]
    per = num_layers // pp
    return list(range(stage * per, (stage + 1) * per))


def _layer_key(key: str):
    parts = key.split(".", 2)
    if parts[0] != "layers":
        return None
    return int(parts[1]), parts[2]


def to_canonical(tree: Dict[str, torch.Tensor],
                 layer_ids: Sequence[int]) -> Dict[str, torch.Tensor]:
    """A stage's state dict (or a moment tree keyed like it) with its layer
    keys renamed from ModuleList positions to canonical layer indices."""
    out = {}
    for key, val in tree.items():
        lk = _layer_key(key)
        out[key if lk is None else
            f"layers.{layer_ids[lk[0]]}.{lk[1]}"] = val
    return out


def from_canonical(tree: Dict[str, torch.Tensor],
                   layer_ids: Sequence[int]) -> Dict[str, torch.Tensor]:
    """The inverse of `to_canonical` on a tree of every layer: this stage's
    layers, renamed to its ModuleList positions, and every other leaf."""
    local = {c: i for i, c in enumerate(layer_ids)}
    out = {}
    for key, val in tree.items():
        lk = _layer_key(key)
        if lk is None:
            out[key] = val
        elif lk[0] in local:
            out[f"layers.{local[lk[0]]}.{lk[1]}"] = val
    return out


class _Tie(torch.autograd.Function):
    """x, made to depend on y with a zero cotangent: y's backward (and the
    hops behind it) then runs on a stage whose output does not read y."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.y = (y.shape, y.dtype, y.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.y
        return g, torch.zeros(shape, dtype=dtype, device=device)


# block(z, v, m) -> (z', aux or None): this stage's block v on microbatch m
Block = Callable[[torch.Tensor, int, int],
                 Tuple[torch.Tensor, Optional[dict]]]


def _inject(stage: int, s: int, use: bool, fresh: torch.Tensor,
            z_prev: torch.Tensor) -> torch.Tensor:
    """Stage 0's input at step s: the fresh microbatch where `use`, else
    the hop's output; the hop's output stays in the graph either way."""
    if stage != 0:
        return z_prev
    if s == 0:
        return fresh
    return torch.where(torch.tensor(use, device=fresh.device), fresh, z_prev)


def run(mesh, x: torch.Tensor, microbatches: int, block: Block,
        schedule: str = "gpipe", virtual: int = 2, aux=None,
        head_layout: str = "replicated"):
    """The pipeline over `mesh`'s pp axis on this stage's (b, t, d) input
    (the embedding, which every stage computes; only stage 0's enters):
    returns (x_final, aux). `aux` is a MoE model's zero aux sums (None for
    a dense one), summed here over this stage's live steps.

    x_final, as JAX's: under 'pp_scatter' (b divisible by pp) this stage's
    b/pp rows of the last stage's output (a reduce-scatter over pp; its
    backward all-gathers the cotangents); under 'replicated' the whole
    (b, t, d) output on every stage (an all-reduce whose backward passes
    the cotangent through: the loss counts only the last stage's copy)."""
    pp, stage = mesh.pp, mesh.pp_rank
    last = pp - 1
    b = x.shape[0]
    M = microbatches or pp
    if b % M != 0:
        raise ValueError(f"local batch {b} not divisible by "
                         f"pp_microbatches {M}")
    xs = x.chunk(M, dim=0)
    interleaved = schedule == "interleaved"
    V = virtual if interleaved else 1
    steps = V * M + pp - 1
    outs: List[Optional[torch.Tensor]] = [None] * M
    # the first carry takes a gradient too: a stage's early bubble steps
    # hand it on, and a hop whose input takes none would have no backward
    # on this stage while its neighbour's waits for it
    z_prev = torch.zeros_like(xs[0]).requires_grad_(xs[0].requires_grad)
    y = z_prev
    for s in range(steps):
        r = s - stage
        live = 0 <= r <= V * M - 1
        if interleaved:
            v = min(max((r // pp) % V, 0), V - 1)
            m = min(max((r // (V * pp)) * pp + r % pp, 0), M - 1)
        else:
            v, m = 0, min(max(r, 0), M - 1)
        fresh = xs[m] if interleaved else xs[min(s, M - 1)]
        z = _inject(stage, s, v == 0, fresh, z_prev)
        if live:
            y, a = block(z, v, m)
            if a is not None:
                aux = add_aux(aux, a)
        else:
            y = z
        if live and stage == last and v == V - 1:
            outs[m] = y
        if s < steps - 1:
            z_prev = stage_hop(y, mesh, wrap=interleaved)
    if stage == last:
        x_final = torch.cat(outs, dim=0)
    else:
        x_final = _Tie.apply(torch.zeros_like(x), y)
    if head_layout == "pp_scatter":
        return reduce_scatter(x_final, mesh, "pp", dim=0), aux
    return reduce_from(x_final, mesh, "pp"), aux
