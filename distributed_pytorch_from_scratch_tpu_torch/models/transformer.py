"""Dense LLaMA-style decoder (RoPE + RMSNorm + SwiGLU) — counterpart of
the JAX `models/transformer.py`, with tensor, sequence, context and data
parallelism.

The module holds its weights (float32, like the JAX param tree): per layer
`wq/wk/wv/wo/norm1/norm2/gate_proj/up_proj/down_proj`, then the final
`norm` and a biased `lm_head`. With `cfg.num_experts > 0` each layer's
SwiGLU projections are one `moe` module instead (`parallel/moe.MoEFFN`:
a float32 router and E top-k routed SwiGLU experts). `interop
.params_from_jax` maps a JAX param tree onto this module's `state_dict`
(one rank's shard of it at tp or ep > 1).

`forward` is the full-sequence training forward (the JAX `_layer_body`
stack), `loss` the f32 masked-mean cross-entropy of `loss_shard` and
`doc_loss` the per-document means of `doc_loss_shard` (evaluation). The
decoding lowerings live in `models/decode.py`, as in the JAX package; both
share its layer block. `remat` is the JAX `remat_wrap` policy (`True`,
`False` or `'dots'`; `'auto'` is resolved by the train CLI through
`training/memory.select_remat`): `True` recomputes each layer in the
backward (`torch.utils.checkpoint`), `False` saves every activation, and
`'dots'` saves the outputs of the matrix products and of the flash forward
(o and lse) and recomputes only the elementwise ops between them
(selective activation checkpointing, `DOTS_SAVED`), so the backward never
launches the attention forward again.

The model runs on one rank of a `runtime.mesh.Mesh`:
* at `tp_size > 1` the rank holds its tp shard: wq/wk/wv/gate/up are
  column-parallel (local heads num_heads/tp and kv_heads/tp), wo/down row-
  parallel, the embedding and the head vocab-parallel over a vocab padded
  to a multiple of tp (padded logits masked to NEG_INF); with
  `sequence_parallel` the activations between sublayers are this rank's
  t/tp chunk of the sequence (one all-gather of the normed input per
  sublayer, the row layers reduce-scatter);
* at `cp_size > 1` `forward` and `loss` take this rank's chunk of the
  sequence (`cp_shard` cuts it from a full batch: the zig-zag order first
  under `cp_layout='zigzag'`, then the rank's contiguous slice), and
  attention is `ring_attention` or `ulysses_attention` over the cp group;
* the dp axis takes rows of the batch (the train loop cuts them);
* at `ep_size > 1` (a MoE model; the mesh's ep) the ep axis takes rows of
  the batch too, dp major, and each ep rank holds E/ep experts: every MoE
  layer sends its dispatched tokens to the experts' ranks and back with
  two `all_to_all`s over ep;
* the loss sums its numerator and count over the batch group (dp x cp x
  ep) before it divides; the train step sums the gradients over it (the
  experts' over dp x cp);
* under ZeRO-3 (`training/zero.py`) the dp-sharded parameters rest as
  this rank's shards: the forward gathers the non-layer ones once (the
  JAX `build_zero3_grad_fn`'s use-site gathers) and each layer's inside
  the function `torch.utils.checkpoint` wraps, from the shards passed in
  as its inputs (the JAX `_layer_body` hook), so remat replays the gather
  instead of saving the whole weights; the gathers' backward
  reduce-scatters the gradients over dp.

A MoE model's loss adds the router's auxiliary losses, `moe_aux_coef *
load_balance + moe_z_coef * z`, from the layers' aux sums summed over the
batch group (the JAX `loss_shard`).

At `mesh.pp > 1` the model is one pipeline stage (`models/pipeline.py`):
its `layers` are this stage's (`layer_ids`, in the canonical order's
terms), the embedding, final norm and head are held whole on every stage,
and the forward runs the local batch through the gpipe or interleaved
schedule in `pp_microbatches` microbatches, each stage step's layers under
one more checkpoint with `pp_remat_steps`. The loss takes JAX's head
layout: with a local batch that divides by pp each stage runs the norm,
head and CE on its b/pp rows of the last stage's output (`pp_scatter`),
else every stage on all of them, counted on the last stage only; its sums
(and a MoE model's aux sums, each stage's layers') are summed over the
batch group and then over pp.

Not ported: tp overlap.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import IGNORE_INDEX, ModelConfig, resolve_dtype_on
from ..ops.attention import causal_attention
from ..ops.cuda.flash_attention import flash_attention
from ..ops.collectives import (all_gather, all_max, all_reduce_sum,
                               gather_from, reduce_from)
from ..ops.ring_attention import (cp_chunk_index, ring_attention,
                                  ring_schedule, ulysses_attention)
from ..parallel.embedding import VocabParallelEmbedding
from ..parallel.layout import shard_params
from ..parallel.linear import ColumnParallelLinear, RowParallelLinear
from ..parallel.moe import AUX_KEYS, MoEFFN, add_aux, aux_losses, aux_zeros
from ..parallel.norm import RMSNorm
from . import pipeline
from .decode import (_block, _embed, _logits_tokens, _positions,
                     decode_tables)
from .pipeline import stage_layer_ids, validate_pp


def validate_cp(cfg: ModelConfig, tp: int, cp_size: int, cp_impl: str,
                cp_layout: str) -> None:
    """The JAX `validate_cp`, with its messages: cp_impl/cp_layout
    membership, Ulysses head divisibility (q AND kv local heads),
    zigzag-requires-ring."""
    if cp_impl not in ("ring", "ulysses"):
        raise ValueError(f"cp_impl must be 'ring' or 'ulysses', got "
                         f"{cp_impl!r}")
    if (cp_size > 1 and cp_impl == "ulysses"
            and ((cfg.num_heads // tp) % cp_size != 0
                 or (cfg.kv_heads // tp) % cp_size != 0)):
        raise ValueError(
            f"ulysses needs local q heads {cfg.num_heads // tp} and kv "
            f"heads {cfg.kv_heads // tp} divisible by cp_size {cp_size}; "
            f"use cp_impl='ring'")
    if cp_layout not in ("contiguous", "zigzag"):
        raise ValueError(f"cp_layout must be 'contiguous' or 'zigzag', "
                         f"got {cp_layout!r}")
    if cp_layout == "zigzag" and cp_impl != "ring":
        raise ValueError("cp_layout='zigzag' requires cp_impl='ring' "
                         "(Ulysses assumes rank-order contiguous chunks)")


def validate_tp(cfg: ModelConfig, tp: int) -> None:
    """The JAX `Transformer.__post_init__` divisibility checks, with its
    messages."""
    if cfg.num_heads % tp != 0:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by "
                         f"tp_size {tp}")
    if cfg.attn_dim % tp != 0 or cfg.ffn_dim % tp != 0:
        raise ValueError(
            f"attn_dim {cfg.attn_dim} and ffn_dim {cfg.ffn_dim} must be "
            f"divisible by tp_size {tp}")
    if cfg.num_heads % cfg.kv_heads != 0:
        raise ValueError(f"num_heads {cfg.num_heads} must be a multiple "
                         f"of num_kv_heads {cfg.kv_heads}")
    if cfg.kv_heads % tp != 0:
        raise ValueError(f"num_kv_heads {cfg.kv_heads} not divisible by "
                         f"tp_size {tp}")


# remat='dots': the ops whose outputs a layer keeps for its backward — every
# matrix product (the JAX `checkpoint_dots`) and the flash forward's (o,
# lse) (the JAX kernel's `flash_out`/`flash_lse` names). On the CPU the
# attention is the plain einsums, whose products (bmm) are kept, as JAX's
# XLA path keeps its dots where the flash names do not exist.
DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.bmm.default, flash_attention._opoverload]


def _remat_kwargs(remat) -> dict:
    """`torch.utils.checkpoint` arguments of a remat policy. The model draws
    no random numbers, so no RNG state is stashed for the replay (which
    also keeps a captured step free of host reads of the RNG)."""
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            DOTS_SAVED)
    return kw


def moe_ffn(cfg: ModelConfig, mesh) -> MoEFFN:
    """A layer's routed-expert FFN of `cfg`'s MoE shape (both families)."""
    return MoEFFN(cfg.attn_dim, cfg.ffn_dim, cfg.num_experts,
                  top_k=cfg.moe_top_k,
                  capacity_factor=cfg.moe_capacity_factor, mesh=mesh)


def validate_ep(cfg: ModelConfig, ep_size: int) -> None:
    """The JAX model's ep checks, with its messages (the experts' own
    divisibility is `MoEFFN`'s)."""
    if not cfg.num_experts and ep_size > 1:
        raise ValueError("ep_size > 1 requires cfg.num_experts > 0 "
                         "(a dense model has nothing to shard over 'ep'; "
                         "use dp for a pure data axis)")


def _layer(cfg: ModelConfig, mesh) -> nn.ModuleDict:
    d, f, kd = cfg.attn_dim, cfg.ffn_dim, cfg.kv_dim
    mods = {
        "wq": ColumnParallelLinear(d, d, mesh),
        "wk": ColumnParallelLinear(d, kd, mesh),
        "wv": ColumnParallelLinear(d, kd, mesh),
        "wo": RowParallelLinear(d, d, mesh),
        "norm1": RMSNorm(d),
        "norm2": RMSNorm(d),
    }
    if cfg.num_experts:
        mods["moe"] = moe_ffn(cfg, mesh)
    else:
        mods.update({"gate_proj": ColumnParallelLinear(d, f, mesh),
                     "up_proj": ColumnParallelLinear(d, f, mesh),
                     "down_proj": RowParallelLinear(f, d, mesh)})
    return nn.ModuleDict(mods)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times `scale` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class Transformer(nn.Module):
    # family hooks the generic KV decoder consults (models/decode.py)
    uses_rope = True
    attn_norm_key = "norm1"
    ffn_norm_key = "norm2"
    # ZeRO-3 (`training/zero.ZeroPlan.install`): the plan whose dp shards
    # the sharded parameters are; the forward gathers them
    zero3 = None

    def __init__(self, cfg: ModelConfig, remat: bool = True,
                 cp_size: int = 1, cp_impl: str = "ring",
                 cp_layout: str = "contiguous", mesh=None,
                 sequence_parallel: bool = False, pp_microbatches: int = 0,
                 pp_schedule: str = "gpipe", pp_virtual: int = 2,
                 pp_remat_steps: bool = False):
        super().__init__()
        if remat not in (True, False, "dots"):
            raise ValueError(
                f"remat must be True, False or 'dots', got {remat!r}")
        if mesh is not None:    # the device is known: refuse before weights
            resolve_dtype_on(cfg.compute_dtype, mesh.device)
        tp_size = 1 if mesh is None else mesh.tp
        ep_size = 1 if mesh is None else mesh.ep
        validate_tp(cfg, tp_size)
        validate_cp(cfg, tp_size, cp_size, cp_impl, cp_layout)
        validate_ep(cfg, ep_size)
        pp_size = 1 if mesh is None else mesh.pp
        validate_pp(cfg.num_layers, pp_size, pp_microbatches, pp_schedule,
                    pp_virtual)
        if cp_size > 1 and (mesh is None or mesh.cp != cp_size):
            raise ValueError(f"cp_size {cp_size} needs the Mesh of its "
                             f"group (runtime.mesh.make_mesh), got {mesh}")
        self.cfg = cfg
        self.ep_size = ep_size
        self.remat = remat
        self.cp_size = cp_size
        self.cp_impl, self.cp_layout = cp_impl, cp_layout
        self.tp_size = tp_size
        self.sequence_parallel = sequence_parallel and tp_size > 1
        self.mesh = mesh
        self.num_local_heads = cfg.num_heads // tp_size
        self.num_local_kv_heads = cfg.kv_heads // tp_size
        self.vocab_padded = cfg.padded_vocab_size(tp_size)
        self.pp_size = pp_size
        self.pp_microbatches, self.pp_schedule = pp_microbatches, pp_schedule
        self.pp_virtual, self.pp_remat_steps = pp_virtual, pp_remat_steps
        # the canonical indices of this stage's layers, in ModuleList order
        self.layer_ids = stage_layer_ids(
            cfg.num_layers, pp_size, 0 if mesh is None else mesh.pp_rank,
            pp_schedule, pp_virtual)
        self._build(cfg, mesh if tp_size > 1 or ep_size > 1 else None)

    @property
    def is_moe(self) -> bool:
        return self.cfg.num_experts > 0

    @property
    def interleaved(self) -> bool:
        return self.pp_size > 1 and self.pp_schedule == "interleaved"

    def _build(self, cfg: ModelConfig, tp_mesh) -> None:
        """The family's modules (`tp_mesh`: the mesh at tp or ep > 1, else
        None)."""
        self.embedding = VocabParallelEmbedding(cfg.vocab_size, cfg.attn_dim,
                                                tp_mesh)
        self.layers = nn.ModuleList(_layer(cfg, tp_mesh)
                                    for _ in self.layer_ids)
        self.norm = RMSNorm(cfg.attn_dim)
        self.lm_head = ColumnParallelLinear(cfg.attn_dim, self.vocab_padded,
                                            tp_mesh)

    def init_weights(self, seed: int) -> "Transformer":
        """Random init from `seed` with the JAX package's distributions
        (same distributions, not the same bits): normal(0, 1) embedding,
        uniform(+-1/sqrt(idim)) linear weights, zero biases, unit norms.
        Draws on the CPU, so a seed gives the same weights on any device.

        At tp, ep or pp > 1 the full tree is drawn exactly as at one rank
        and this rank keeps its slice (its stage's layers); the padded
        embedding rows and head columns are zero. So a model of any mesh
        from seed s is the same function as a one-rank model from seed
        s."""
        device = self.embedding.weight.device
        if self.tp_size > 1 or self.ep_size > 1 or self.pp_size > 1:
            full = type(self)(self.cfg).init_weights(seed).state_dict()
            self.load_state_dict(shard_params(
                pipeline.from_canonical(full, self.layer_ids),
                self.tp_size, self.mesh.tp_rank, self.ep_size,
                self.mesh.ep_rank))
            return self
        gen = torch.Generator(device="cpu").manual_seed(seed)
        self.to("cpu")
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(gen)
        return self.to(device)

    def cp_shard(self, *arrays):
        """This rank's chunk of each (..., t) array (numpy or torch; the
        sequence is the last axis): the zig-zag order first under
        cp_layout='zigzag' (the JAX `make_loss` permutation), then the
        rank's contiguous slice (the shard_map of P(..., 'cp')). At cp = 1
        the arrays themselves."""
        if self.cp_size == 1:
            return arrays
        t = arrays[0].shape[-1]
        if t % self.cp_size:
            raise ValueError(f"sequence length {t} is not divisible by "
                             f"cp_size {self.cp_size}")
        idx = cp_chunk_index(t, self.cp_size, self.mesh.cp_rank,
                             self.cp_layout)
        return tuple(x[..., torch.from_numpy(idx).to(x.device)]
                     if isinstance(x, torch.Tensor) else x[..., idx]
                     for x in arrays)

    def _attend(self, position_ids: torch.Tensor):
        """The layers' attention over this rank's chunk: `causal_attention`
        at cp = 1, else ring (with the batch's ring schedule, computed once
        here and shared by every layer and its remat replay) or Ulysses."""
        if self.cp_size == 1:
            return causal_attention
        if self.cp_impl == "ulysses":
            return lambda q, k, v: ulysses_attention(q, k, v, self.mesh)
        schedule = ring_schedule(position_ids, self.mesh)
        return lambda q, k, v: ring_attention(q, k, v, schedule, self.mesh)

    def forward(self, input_ids: torch.Tensor,
                position_ids: torch.Tensor) -> torch.Tensor:
        """(b, t) ids and positions -> (b, t, vocab_padded / tp) logits in
        the compute dtype, this tp rank's vocab columns; at cp > 1 this
        rank's chunk in, its chunk's logits out. Positions outside the RoPE
        (or learned position) table clamp to its last row (JAX
        mode='clip')."""
        return self.forward_with_aux(input_ids, position_ids)[0]

    def forward_with_aux(self, input_ids: torch.Tensor,
                         position_ids: torch.Tensor,
                         head_layout: str = "replicated"):
        """`forward`'s logits and, for a MoE model, the layers' aux sums
        summed over the layers (this rank's local sums; None for a dense
        model). At pp > 1 `head_layout` 'pp_scatter' gives the logits of
        this stage's b/pp rows (`pipeline.run`)."""
        if (self.sequence_parallel
                and input_ids.shape[-1] % self.tp_size != 0):
            raise ValueError(
                f"sequence_parallel needs the (cp-local) sequence length "
                f"{input_ids.shape[-1]} divisible by tp_size {self.tp_size}")
        z3 = self.zero3
        with z3.bind_top(self) if z3 else contextlib.nullcontext():
            dtype = resolve_dtype_on(self.cfg.compute_dtype,
                                     input_ids.device)
            x = _embed(self, input_ids, position_ids, dtype)
            cos, sin = _positions(*decode_tables(self, self.cfg.maxlen,
                                                 x.device), position_ids)
            aux = (aux_zeros(self.cfg.num_experts, x.device) if self.is_moe
                   else None)
            if self.pp_size > 1:
                x, aux = self._pipeline(x, cos, sin, position_ids, dtype,
                                        aux, head_layout)
            else:
                x, aux = self._run_layers(
                    x, range(len(self.layers)), cos, sin,
                    self._attend(position_ids), dtype, aux)
            return _logits_tokens(self, x, dtype), aux

    def _run_layers(self, x, idx, cos, sin, attend, dtype, aux):
        """The layers at ModuleList positions `idx` on x, each under the
        remat policy; returns (x', aux + their aux sums)."""
        z3 = self.zero3

        def layer(x, i, lp, cos, sin, *shards):
            # ZeRO-3: the layer's weights are gathered HERE, inside the
            # checkpointed function, from its resting shards: the gathered
            # weights are not saved, the backward's replay gathers them
            # again
            with (z3.bind_layer(i, lp, shards) if z3
                  else contextlib.nullcontext()):
                x, _, _, aux = _block(self, lp, x, cos, sin, dtype, attend)
            return x if aux is None else (x, aux)

        for i in idx:
            lp = self.layers[i]
            shards = z3.layer_shards(i, lp) if z3 else ()
            if self.remat and torch.is_grad_enabled():
                out = checkpoint(layer, x, i, lp, cos, sin, *shards,
                                 **_remat_kwargs(self.remat))
            else:
                out = layer(x, i, lp, cos, sin, *shards)
            if self.is_moe:
                x, layer_aux = out
                aux = add_aux(aux, layer_aux)
            else:
                x = out
        return x, aux

    def _pipeline(self, x, cos, sin, position_ids, dtype, aux, head_layout):
        """This stage's part of the pipeline (`pipeline.run`): its blocks of
        layers on each microbatch, with that microbatch's rows of the
        positions (and its ring schedule at cp > 1, made once)."""
        M = self.pp_microbatches or self.pp_size
        V = self.pp_virtual if self.interleaved else 1
        per = len(self.layers) // V
        mb = x.shape[0] // M      # `pipeline.run` refuses a remainder
        attends = {}

        def block(z, v, m):
            rows = slice(m * mb, (m + 1) * mb)
            if m not in attends:
                attends[m] = self._attend(position_ids[rows])
            pick = lambda a: None if a is None else a[rows]

            def step(z):
                return self._run_layers(
                    z, range(v * per, (v + 1) * per), pick(cos), pick(sin),
                    attends[m], dtype,
                    aux_zeros(self.cfg.num_experts, z.device)
                    if self.is_moe else None)

            if self.pp_remat_steps and torch.is_grad_enabled():
                return checkpoint(step, z, **_remat_kwargs(True))
            return step(z)

        return pipeline.run(self.mesh, x, M, block, self.pp_schedule,
                            self.pp_virtual, aux, head_layout)

    @torch.no_grad()
    def full_logits(self, input_ids: torch.Tensor,
                    position_ids: torch.Tensor) -> torch.Tensor:
        """The JAX `make_forward`: a FULL (b, t) batch in natural token
        order -> its (b, t, vocab_padded) logits in natural order, on every
        rank (each rank runs its chunk; the chunks and the tp vocab shards
        are gathered and, under the zig-zag layout, put back in order)."""
        ids, pos = self.cp_shard(input_ids, position_ids)
        logits = self.forward(ids, pos)
        if self.tp_size > 1:
            logits = torch.cat(all_gather(logits, self.mesh, "tp").unbind(0),
                               dim=-1)
        if self.cp_size == 1:
            return logits
        t = input_ids.shape[-1]
        chunks = all_gather(logits, self.mesh)          # (cp, b, tl, vocab)
        order = np.concatenate([cp_chunk_index(t, self.cp_size, r,
                                               self.cp_layout)
                                for r in range(self.cp_size)])
        full = torch.cat(chunks.unbind(0), dim=1)
        inv = torch.from_numpy(np.argsort(order)).to(full.device)
        return full[:, inv]

    def _token_ce(self, logits: torch.Tensor, tgt: torch.Tensor,
                  mode: str) -> torch.Tensor:
        """Per-token f32 CE (..., t) from this rank's vocab columns (the JAX
        `_token_ce`); tgt holds valid ids (ignored targets set to 0).

        At tp = 1 both modes are one logsumexp over the whole vocab. At tp >
        1, 'gather' all-gathers the logits over the vocab, computes the CE
        on every rank and averages the tp-identical copies (/ tp: the value
        is tp-invariant, and the gather's reduce-scatter backward sums the
        copies' cotangents); 'vocab_parallel' never forms the full logits:
        a stop-gradient global max, the summed sumexp, and the target logit
        taken on the rank that owns it."""
        if self.tp_size == 1:
            lse = torch.logsumexp(logits, dim=-1)
            return lse - torch.gather(logits, -1, tgt[..., None])[..., 0]
        if mode == "gather":
            full = gather_from(logits, self.mesh)
            lse = torch.logsumexp(full, dim=-1)
            tgt_logit = torch.gather(full, -1, tgt[..., None])[..., 0]
            return reduce_from(lse - tgt_logit, self.mesh) / self.tp_size
        local_v = logits.shape[-1]
        gmax = all_max(logits.detach().amax(dim=-1), self.mesh)
        sumexp = reduce_from(torch.exp(logits - gmax[..., None]).sum(dim=-1),
                             self.mesh)
        lse = torch.log(sumexp) + gmax
        local = tgt - self.mesh.tp_rank * local_v
        owned = (local >= 0) & (local < local_v)
        tgt_logit = torch.gather(logits, -1,
                                 torch.where(owned, local, 0)[..., None])
        tgt_logit = reduce_from(torch.where(owned, tgt_logit[..., 0], 0.0),
                                self.mesh)
        return lse - tgt_logit

    def loss(self, input_ids: torch.Tensor, target_ids: torch.Tensor,
             position_ids: torch.Tensor,
             mode: str = "vocab_parallel") -> torch.Tensor:
        """Mean f32 cross-entropy over the targets that are not
        IGNORE_INDEX (denominator max(count, 1)), the JAX `loss_shard`, in
        either of its modes (`_token_ce`; at tp = 1 they compute the same
        value), plus a MoE model's auxiliary losses.

        On a mesh the arguments are this rank's rows and chunk; the masked
        sum and the count (and the aux sums) are summed over the batch
        group (dp x cp x ep) first, in one all-reduce (then over pp),
        so every rank returns the global loss. The sum's backward passes
        its cotangent through, so a rank's gradient is that of local_sum /
        global_count, and the batch group's sum of the ranks' gradients
        (the train step) is the global loss's."""
        if mode not in ("vocab_parallel", "gather"):
            raise ValueError(f"unknown loss mode {mode!r}")
        pp = self.pp_size
        pp_scatter = pp > 1 and input_ids.shape[0] % pp == 0
        logits, aux = self.forward_with_aux(
            input_ids, position_ids,
            head_layout="pp_scatter" if pp_scatter else "replicated")
        if pp_scatter:      # this stage's rows of the batch
            chunk = input_ids.shape[0] // pp
            stage = self.mesh.pp_rank
            target_ids = target_ids[stage * chunk:(stage + 1) * chunk]
        logits = logits.float()
        valid = target_ids != IGNORE_INDEX
        tgt = torch.where(valid, target_ids, 0).long()
        token_loss = self._token_ce(logits, tgt, mode)
        sums = [torch.where(valid, token_loss, 0.0).sum()[None],
                valid.float().sum()[None]]
        if pp > 1 and not pp_scatter:
            # every stage computed the CE of the whole batch: counted on
            # the last stage only (which also zeroes the other stages'
            # cotangents of the head, the norm and the embedding)
            is_last = float(self.mesh.pp_rank == pp - 1)
            sums = [v * is_last for v in sums]
        if self.is_moe:
            if self.sequence_parallel:
                # the router saw the tp-gathered tokens: every tp rank holds
                # the same sums, and each takes 1/tp of their cotangent
                # (JAX's pmean over tp), which the tp sum of the router's
                # gradient adds back up
                aux = {k: _ScaleGrad.apply(v, 1.0 / self.tp_size)
                       for k, v in aux.items()}
            sums += [aux[k].reshape(-1) for k in AUX_KEYS]
        flat = torch.cat(sums)
        if self.mesh is not None and self.mesh.axis("batch").size > 1:
            flat = all_reduce_sum(flat, self.mesh, "batch")
        if pp > 1:
            flat = all_reduce_sum(flat, self.mesh, "pp")
        loss = flat[0] / torch.clamp(flat[1], min=1.0)
        if self.is_moe:
            E = self.cfg.num_experts
            self._moe_sums = flat[2:].detach()   # read by `moe_summary`
            parts = flat[2:].split([E, E, 1, 1, 1])
            lb, z = aux_losses({k: p.reshape(()) if p.numel() == 1 else p
                                for k, p in zip(AUX_KEYS, parts)},
                               E, self.cfg.moe_top_k)
            loss = (loss + self.cfg.moe_aux_coef * lb
                    + self.cfg.moe_z_coef * z)
        return loss

    def moe_summary(self):
        """The routing of the last `loss` call (global over the batch
        group, summed over the layers): the share of the routed choices
        that were dropped for capacity, and the busiest expert's routed
        choices over the mean expert's. None for a dense model or before a
        loss; reads the card once."""
        sums = getattr(self, "_moe_sums", None)
        if sums is None:
            return None
        E, k = self.cfg.num_experts, self.cfg.moe_top_k
        per_expert, rest = sums[:E].cpu(), sums[2 * E:].cpu()
        tokens, dropped = float(rest[1]), float(rest[2])
        return {"dropped_frac": dropped / max(tokens * k, 1.0),
                "load_max_over_mean": float(per_expert.max()
                                            / per_expert.mean().clamp(
                                                min=1e-12))}

    @torch.no_grad()
    def doc_loss(self, input_ids: torch.Tensor, target_ids: torch.Tensor,
                 position_ids: torch.Tensor, mode: str = "vocab_parallel"):
        """Per-DOCUMENT mean f32 CE, the JAX `doc_loss_shard` behind
        `make_doc_loss`: ((b,) means, (b,) real-row mask) for this rank's
        rows. The same vocab-parallel CE as training (`_token_ce`: no
        gather of the (b, t, V) logits); each row's masked sum and count
        are summed over the cp group before the division, so at cp > 1
        every rank of a row's group returns that row's document mean. A
        padding row (every target IGNORE_INDEX) has mask False.

        At cp > 1 the arguments are this rank's chunk (`cp_shard`; under
        the zig-zag layout the tokens are permuted first, which no
        per-document mean depends on)."""
        if mode not in ("vocab_parallel", "gather"):
            raise ValueError(f"unknown loss mode {mode!r}")
        logits = self.forward(input_ids, position_ids).float()
        valid = target_ids != IGNORE_INDEX
        tgt = torch.where(valid, target_ids, 0).long()
        token_loss = self._token_ce(logits, tgt, mode)
        row_sum = torch.where(valid, token_loss, 0.0).sum(dim=-1)
        row_cnt = valid.float().sum(dim=-1)
        if self.cp_size > 1:
            row_sum, row_cnt = all_reduce_sum(
                torch.stack([row_sum, row_cnt]), self.mesh, "cp").unbind()
        return row_sum / torch.clamp(row_cnt, min=1.0), row_cnt > 0
