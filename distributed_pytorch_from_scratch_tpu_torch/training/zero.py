"""ZeRO 1/2/3 and the bucketed dp gradient reducer — the port's counterpart
of the JAX `training/zero.py` and of the reducer choice in its
`training/train_step.py`.

Every stage computes the update of plain data-parallel Adam; what it
changes is what each dp rank holds and which collectives run. A
`ZeroPlan` says, for one model on one mesh:

* stage 0 — every rank holds the f32 params, grads and both Adam moments.
  The grads are summed over the batch group (dp x cp x ep) in one flat
  all-reduce (`train_step.reduce_grads`), or with `--dp_reduce_bucket_mb`
  in buckets (`ops/overlap.bucketed_psum`, f32, bf16 or int8 on the wire);
* stage 1 — the moments are dp-sharded: each rank runs Adam on its shard
  of each leaf (a view of the full parameter) and the fresh shards are
  all-gathered over dp (one flat all-gather);
* stage 2 — the grads too: the dp sum is a reduce-scatter per bucket
  (`bucketed_reduce_scatter`, 25 MiB buckets unless given; f32, bf16 or
  the int8 ring's reduce-scatter half on the wire), so each rank receives
  only the shard it updates, and the full grads are released;
* stage 3 — the parameters too: each sharded leaf rests as this rank's
  shard (`install` swaps the module's Parameter for it). The model gathers
  a layer's shards inside the function that `torch.utils.checkpoint`
  wraps (`Transformer.forward_with_aux`; the gathered weights are not
  saved, the backward's replay gathers them again) and the non-layer
  leaves once per forward; the gather's backward is a reduce-scatter over
  dp (`ops/overlap.gather_shards`), so the grads arrive as dp-summed
  shards. What remains is summed in f32: cp, and tp for the leaves
  sequence parallelism leaves replicated over tp (both stages 2 and 3),
  and the leaves that do not shard (over the whole batch group).

The dp dim of a leaf is the ONE rule of the JAX `_zero_dim`, shared by
every stage (or a grad shard would land on a moment it does not own): the
first dimension of the JAX leaf that the tp spec leaves free and whose
size dp divides (`zero_dim`, on the tp-local shapes; a tp-sharded dim, an
expert's ep dim and a column bias's only dim are never taken, whatever
the tp size). The port's layers are a `ModuleList`, so a layer leaf takes
JAX's stacked `zero3_dims` less the layer axis at every stage.

Scope (stages 2 and 3, and the buckets at any stage): dense models, and
sequence parallelism whenever tp > 1 — JAX's refusals, with its words
(`check_scope`). `--zero 1` composes with MoE: the expert moments shard
over dp by the same rule. Checkpoints keep JAX's format (full moments, and
at stage 3 full params, per tp rank): `full_params` / `full_state` gather
the dp shards before a save, `shard_state` cuts this rank's from a load.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.overlap import (WIRES, bucket_partition, bucketed_psum,
                           bucketed_reduce_scatter, gather_full,
                           gather_shards)
from ..parallel.layout import tp_dim
from ..reshard.layout import canonical_specs, jax_key, transposed
from .memory import zero_state_bytes_per_param
from .optim import AdamState

DP_AXIS = "dp"
# stages 2 and 3 ride the bucketed reducer; JAX's default bucket
DEFAULT_BUCKET_MB = 25.0

Tensors = Dict[str, torch.Tensor]


def resolve_zero_stage(zero, zero1: bool = False) -> int:
    """The ZeRO stage from `--zero` / `--zero1`: an explicit stage wins;
    `zero1` is the alias of stage 1 (the JAX rule)."""
    if zero is not None:
        stage = int(zero)
        if stage not in (0, 1, 2, 3):
            raise ValueError(f"zero stage must be 0..3, got {zero!r}")
        return stage
    return 1 if zero1 else 0


def zero_dim(key: str, shape: Sequence[int], dp: int) -> int:
    """The torch dim of state-dict leaf `key` (its tp-local `shape`) that
    shards over dp, or -1 (the leaf stays whole on every dp rank): the
    first dim of the JAX leaf that its spec leaves free and whose size dp
    divides (the JAX `_zero_dim`; a layer leaf without the stacked layer
    axis, as JAX's `zero3_dims` - 1)."""
    if dp == 1:
        return -1
    shape = tuple(shape)
    jkey, stacked = jax_key(key)
    spec = canonical_specs({key: shape})[jkey][1 if stacked else 0:]
    flip = transposed(key)
    jshape = shape[::-1] if flip else shape
    for i, (s, d) in enumerate(zip(spec, jshape)):
        if s is None and d > 0 and d % dp == 0:
            return len(shape) - 1 - i if flip else i
    return -1


def check_scope(model, what: str) -> None:
    """The JAX `_check_bucketed_scope` refusals (pp is 1 in the port)."""
    if model.is_moe:
        raise ValueError(
            f"{what} does not compose with MoE: expert grads are "
            f"ep-sharded, not batch-replicated — use the default reducer")
    if model.tp_size > 1 and not model.sequence_parallel:
        raise ValueError(
            f"{what} with tp > 1 requires sequence_parallel: the non-SP "
            f"path all-reduces inside every row-parallel layer, so "
            f"per-shard cotangent bookkeeping is depth-dependent — use "
            f"the default reducer (or turn SP on)")


def _chunk(t: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size)


@contextlib.contextmanager
def _bound(module: nn.Module, names: Sequence[str],
           tensors: Sequence[torch.Tensor]):
    """`module`'s parameters `names` (dotted, below it) replaced by
    `tensors` inside the block, put back on leaving."""
    slots = []
    for name, t in zip(names, tensors):
        path, _, leaf = name.rpartition(".")
        mod = module.get_submodule(path)
        slots.append((mod, leaf, mod._parameters[leaf]))
        mod._parameters[leaf] = t
    try:
        yield
    finally:
        for mod, leaf, p in slots:
            mod._parameters[leaf] = p


@dataclass
class ZeroPlan:
    """Where each leaf's dp shard lies and which reducer runs (module
    docstring). `dims` maps every state-dict key to its dp dim (-1: whole
    on every dp rank; all -1 at stage 0 or dp 1)."""

    stage: int
    mesh: object
    dims: Dict[str, int]
    bucket_mb: float = 0.0
    wire: str = "f32"
    sequence_parallel: bool = False
    # stage 3: per layer, its sharded leaves (names below the layer) and
    # dims; the same for the non-layer leaves
    layer_leaves: List[List[Tuple[str, int]]] = field(default_factory=list)
    top_leaves: List[Tuple[str, int]] = field(default_factory=list)

    @classmethod
    def build(cls, model, stage: int, bucket_mb: float = 0.0,
              wire: str = "f32") -> "ZeroPlan":
        """The plan of `model` (whole, before `install`) on its mesh,
        refusing what JAX's builders refuse."""
        if wire not in WIRES:
            raise ValueError(f"dp reduce dtype {wire!r}; expected one of "
                             f"{WIRES}")
        if stage >= 3 and wire != "f32":
            raise ValueError(
                "dp_reduce_dtype with zero stage 3: the ZeRO-3 grad "
                "reduce-scatter rides the parameter all-gather's "
                "transpose (an f32 ppermute ring), so a compressed wire "
                "would silently not apply — use stage 2, whose bucketed "
                "reduce-scatter carries the compressed payload")
        if wire != "f32" and not bucket_mb and stage != 2:
            raise ValueError(f"dp reduce dtype {wire} needs a bucket size "
                             f"(the compressed wire is a property of the "
                             f"bucketed reducer; stage 2 implies it)")
        if stage == 3:
            check_scope(model, "ZeRO-3 (gather-on-demand params)")
            if model.remat is False:
                raise ValueError(
                    "ZeRO-3 requires a rematerialising model (remat=True or "
                    "'dots'): without remat, autodiff saves every layer's "
                    "GATHERED weights as backward residuals, recreating the "
                    "full param replica the stage exists to eliminate")
        elif stage == 2 or bucket_mb:
            check_scope(model, "bucketed DP grad reduction")
        if stage >= 2 and not bucket_mb:
            bucket_mb = DEFAULT_BUCKET_MB
        mesh = model.mesh
        dp = mesh.dp if mesh is not None and stage else 1
        dims = {k: zero_dim(k, p.shape, dp)
                for k, p in model.named_parameters()}
        return cls(stage, mesh, dims, bucket_mb, wire,
                   model.sequence_parallel)

    # -- layout --

    @property
    def dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.dp

    def sharded(self, key: str) -> bool:
        return self.dims[key] >= 0

    def shard(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """This dp rank's shard of a whole leaf (a view; `t` itself for a
        leaf that does not shard)."""
        d = self.dims[key]
        return t if d < 0 else _chunk(t, d, self.dp, self.mesh.dp_rank)

    def owned(self, tree: Tensors) -> Tensors:
        """What Adam updates on this rank: at stages 1 and 2 the shard
        views of the whole tensors of `tree`; at stage 3 `tree` (the
        parameters are the shards already)."""
        if self.stage in (1, 2):
            return {k: self.shard(k, t) for k, t in tree.items()}
        return tree

    def init_state(self, params: Tensors) -> AdamState:
        """Zero moments at the owned shapes."""
        zeros = {k: torch.zeros_like(t, memory_format=torch.contiguous_format)
                 for k, t in self.owned(params).items()}
        return AdamState(step=0, mu=zeros,
                         nu={k: torch.zeros_like(z) for k, z in zeros.items()})

    def shard_state(self, state: AdamState) -> AdamState:
        """Whole moments (a loaded checkpoint's) -> this rank's."""
        if not self.stage:
            return state
        own = lambda t: {k: (self.shard(k, v).contiguous()
                             if self.sharded(k) else v)
                         for k, v in t.items()}
        return AdamState(step=state.step, mu=own(state.mu), nu=own(state.nu))

    def _gathered(self, tree: Tensors) -> Tensors:
        keys = [k for k in tree if self.sharded(k)]
        if not keys or self.dp == 1:
            return tree
        full = gather_full([tree[k] for k in keys],
                           [self.dims[k] for k in keys], self.mesh, DP_AXIS)
        return {**tree, **dict(zip(keys, full))}

    def full_state(self, state: AdamState) -> AdamState:
        """This rank's moments -> the whole ones (a collective over dp:
        every dp rank calls it)."""
        if not self.stage:
            return state
        return AdamState(step=state.step, mu=self._gathered(state.mu),
                         nu=self._gathered(state.nu))

    def full_params(self, state_dict: Tensors) -> Tensors:
        """The model's state dict, whole (stage 3 gathers its shards; a
        collective over dp)."""
        return self._gathered(state_dict) if self.stage == 3 else state_dict

    @torch.no_grad()
    def gather_params(self, params: Tensors) -> None:
        """Stages 1 and 2, after Adam: every rank's fresh shards written
        into the whole parameters (one flat all-gather over dp)."""
        if self.stage not in (1, 2) or self.dp == 1:
            return
        keys = [k for k in params if self.sharded(k)]
        full = gather_full([self.shard(k, params[k]) for k in keys],
                           [self.dims[k] for k in keys], self.mesh, DP_AXIS)
        torch._foreach_copy_([params[k] for k in keys], full)

    # -- stage 3 --

    def install(self, model) -> None:
        """Stage 3: each sharded parameter of `model` swapped for this
        rank's shard, and `model.zero3` set, which makes the forward
        gather them (no-op at other stages or at dp 1)."""
        if self.stage != 3 or self.dp == 1:
            return
        for key, p in list(model.named_parameters()):
            if self.sharded(key):
                path, _, leaf = key.rpartition(".")
                model.get_submodule(path)._parameters[leaf] = nn.Parameter(
                    self.shard(key, p.detach()).clone())
        n = len(model.layers)
        self.layer_leaves = [[] for _ in range(n)]
        self.top_leaves = []
        for key, d in self.dims.items():
            if d < 0:
                continue
            parts = key.split(".")
            if parts[0] == "layers":
                self.layer_leaves[int(parts[1])].append(
                    (".".join(parts[2:]), d))
            else:
                self.top_leaves.append((key, d))
        model.zero3 = self

    def layer_shards(self, i: int, layer: nn.Module) -> List[torch.Tensor]:
        """Layer i's resting shards, the inputs of its gather."""
        return [layer.get_parameter(n) for n, _ in self.layer_leaves[i]]

    def bind_layer(self, i: int, layer: nn.Module,
                   shards: Sequence[torch.Tensor]):
        """A context in which layer i holds the gathered whole leaves of
        `shards` (one all-gather over dp; its backward reduce-scatters)."""
        names = [n for n, _ in self.layer_leaves[i]]
        full = gather_shards(shards, [d for _, d in self.layer_leaves[i]],
                             self.mesh, DP_AXIS)
        return _bound(layer, names, full)

    def bind_top(self, model):
        """A context in which the model holds its gathered non-layer
        leaves (one all-gather per forward)."""
        names = [n for n, _ in self.top_leaves]
        full = gather_shards([model.get_parameter(n) for n in names],
                             [d for _, d in self.top_leaves], self.mesh,
                             DP_AXIS)
        return _bound(model, names, full)

    # -- gradients --

    def _reductions(self, keys: Sequence[str]):
        """(keys, kind, axes) of each reduction the reducer runs: "rs", the
        bucketed reduce-scatter over dp then the sum over `axes` (stage 2's
        sharded leaves); "sum", the bucketed sum over `axes` (stage 3's
        sharded leaves, whose dp sum the gathers' backward did, over the
        residual axes; every other leaf over the batch group). The leaves
        that sequence parallelism left replicated over tp are summed over
        tp too."""
        out = []
        for extra in ((), ("tp",)):
            group = [k for k in keys if (self.sequence_parallel
                                         and tp_dim(k) is None) == bool(extra)]
            scat = ([k for k in group if self.sharded(k)] if self.stage >= 2
                    else [])
            whole = [k for k in group if k not in set(scat)]
            if scat:
                out.append((scat, "rs" if self.stage == 2 else "sum",
                            ("cp",) + extra))
            if whole:
                out.append((whole, "sum", ("batch",) + extra))
        return out

    def buckets(self, shapes: Dict[str, Sequence[int]]) -> int:
        """How many buckets the dp reducer of this plan sends per step
        (0 for the flat stage 0/1 reducer; at stage 3 those of the leaves
        that do not shard, the rest being scattered by the gathers'
        backward)."""
        if not self.bucket_mb:
            return 0
        return sum(len(bucket_partition(
            [int(torch.Size(shapes[k]).numel()) for k in keys],
            int(self.bucket_mb * 2**20)))
            for keys, _, axes in self._reductions(list(shapes))
            if self.stage != 3 or "batch" in axes)

    @torch.no_grad()
    def reduce_grads(self, grads: Tensors) -> Tensors:
        """The bucketed reducers (stage 0/1 with buckets, stage 2) and
        stage 3's remainder: `grads` (keyed like the parameters; whole, or
        at stage 3 the dp-summed shards of the sharded leaves) -> the
        gradients Adam takes, f32: whole at stages 0 and 1, this rank's
        shard of every sharded leaf at stages 2 and 3."""
        out = {}
        for keys, kind, axes in self._reductions(list(grads)):
            leaves = [grads[k] for k in keys]
            if kind == "rs":
                red = bucketed_reduce_scatter(
                    leaves, [self.dims[k] for k in keys], self.mesh,
                    DP_AXIS, axes, self.bucket_mb, self.wire)
            else:
                red = bucketed_psum(leaves, self.mesh, axes, self.bucket_mb,
                                    self.wire)
            out.update(zip(keys, red))
        return {k: out[k] for k in grads}


def expected_state_bytes(shapes: Dict[str, Sequence[int]],
                         plan: Optional[ZeroPlan] = None) -> int:
    """This rank's resident state bytes (params, grads, both moments) by
    `memory.zero_state_bytes_per_param`, leaf by leaf: a leaf that the
    plan shards at dp, any other at dp 1 (16 bytes a parameter; every leaf
    without a plan). `shapes`: the whole leaves' tp-local shapes."""
    total = 0.0
    for k, shape in shapes.items():
        sharded = plan is not None and plan.sharded(k)
        total += int(torch.Size(shape).numel()) * zero_state_bytes_per_param(
            0 if plan is None else plan.stage, plan.dp if sharded else 1)
    return int(round(total))


def held_bytes(params: Tensors, grads: Tensors,
               state: AdamState) -> Dict[str, int]:
    """The bytes of the params, the grads Adam took and the moments, as
    this rank holds them."""
    size = lambda t: sum(x.numel() * x.element_size() for x in t.values())
    return {"params": size(params), "grads": size(grads),
            "moments": size(state.mu) + size(state.nu)}


def build_plan(model, stage: int = 0, bucket_mb: float = 0.0,
               wire: str = "f32") -> Optional[ZeroPlan]:
    """The plan of `model`, or None where the stage-0 flat reducer runs
    (no stage, no buckets)."""
    if not stage and not bucket_mb and wire == "f32":
        return None
    return ZeroPlan.build(model, stage, bucket_mb, wire)
