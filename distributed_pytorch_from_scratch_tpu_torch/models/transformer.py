"""Dense LLaMA-style decoder (RoPE + RMSNorm + SwiGLU) — counterpart of
the JAX `models/transformer.py`, with tensor, sequence, context and data
parallelism.

The module holds its weights (float32, like the JAX param tree): per layer
`wq/wk/wv/wo/norm1/norm2/gate_proj/up_proj/down_proj`, then the final
`norm` and a biased `lm_head`. `interop.params_from_jax` maps a JAX param
tree onto this module's `state_dict` (one tp rank's shard of it at tp > 1).

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
* the loss sums its numerator and count over the batch group (dp x cp)
  before it divides; the train step sums the gradients over it.

Not ported: MoE, pipeline and tp overlap.
"""

from __future__ import annotations

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
from ..parallel.norm import RMSNorm
from .decode import (_block, _embed, _logits_tokens, _positions,
                     decode_tables)


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


def _layer(cfg: ModelConfig, mesh) -> nn.ModuleDict:
    d, f, kd = cfg.attn_dim, cfg.ffn_dim, cfg.kv_dim
    return nn.ModuleDict({
        "wq": ColumnParallelLinear(d, d, mesh),
        "wk": ColumnParallelLinear(d, kd, mesh),
        "wv": ColumnParallelLinear(d, kd, mesh),
        "wo": RowParallelLinear(d, d, mesh),
        "norm1": RMSNorm(d),
        "norm2": RMSNorm(d),
        "gate_proj": ColumnParallelLinear(d, f, mesh),
        "up_proj": ColumnParallelLinear(d, f, mesh),
        "down_proj": RowParallelLinear(f, d, mesh),
    })


class Transformer(nn.Module):
    # family hooks the generic KV decoder consults (models/decode.py)
    uses_rope = True
    attn_norm_key = "norm1"
    ffn_norm_key = "norm2"

    def __init__(self, cfg: ModelConfig, remat: bool = True,
                 cp_size: int = 1, cp_impl: str = "ring",
                 cp_layout: str = "contiguous", mesh=None,
                 sequence_parallel: bool = False):
        super().__init__()
        if remat not in (True, False, "dots"):
            raise ValueError(
                f"remat must be True, False or 'dots', got {remat!r}")
        if cfg.num_experts:
            raise NotImplementedError(
                "num_experts > 0: MoE is not ported yet, see ROADMAP")
        if mesh is not None:    # the device is known: refuse before weights
            resolve_dtype_on(cfg.compute_dtype, mesh.device)
        tp_size = 1 if mesh is None else mesh.tp
        validate_tp(cfg, tp_size)
        validate_cp(cfg, tp_size, cp_size, cp_impl, cp_layout)
        if cp_size > 1 and (mesh is None or mesh.cp != cp_size):
            raise ValueError(f"cp_size {cp_size} needs the Mesh of its "
                             f"group (runtime.mesh.make_mesh), got {mesh}")
        self.cfg = cfg
        self.remat = remat
        self.cp_size = cp_size
        self.cp_impl, self.cp_layout = cp_impl, cp_layout
        self.tp_size = tp_size
        self.sequence_parallel = sequence_parallel and tp_size > 1
        self.mesh = mesh
        self.num_local_heads = cfg.num_heads // tp_size
        self.num_local_kv_heads = cfg.kv_heads // tp_size
        self.vocab_padded = cfg.padded_vocab_size(tp_size)
        self._build(cfg, mesh if tp_size > 1 else None)

    def _build(self, cfg: ModelConfig, tp_mesh) -> None:
        """The family's modules (`tp_mesh`: the mesh at tp > 1, else
        None)."""
        self.embedding = VocabParallelEmbedding(cfg.vocab_size, cfg.attn_dim,
                                                tp_mesh)
        self.layers = nn.ModuleList(_layer(cfg, tp_mesh)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.attn_dim)
        self.lm_head = ColumnParallelLinear(cfg.attn_dim, self.vocab_padded,
                                            tp_mesh)

    def init_weights(self, seed: int) -> "Transformer":
        """Random init from `seed` with the JAX package's distributions
        (same distributions, not the same bits): normal(0, 1) embedding,
        uniform(+-1/sqrt(idim)) linear weights, zero biases, unit norms.
        Draws on the CPU, so a seed gives the same weights on any device.

        At tp > 1 the full tree is drawn exactly as at tp = 1 and this rank
        keeps its slice; the padded embedding rows and head columns are
        zero. So a tp model from seed s is the same function as a tp = 1
        model from seed s."""
        device = self.embedding.weight.device
        if self.tp_size > 1:
            full = type(self)(self.cfg).init_weights(seed).state_dict()
            self.load_state_dict(shard_params(full, self.tp_size,
                                              self.mesh.tp_rank))
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
        if (self.sequence_parallel
                and input_ids.shape[-1] % self.tp_size != 0):
            raise ValueError(
                f"sequence_parallel needs the (cp-local) sequence length "
                f"{input_ids.shape[-1]} divisible by tp_size {self.tp_size}")
        dtype = resolve_dtype_on(self.cfg.compute_dtype, input_ids.device)
        x = _embed(self, input_ids, position_ids, dtype)
        cos, sin = _positions(*decode_tables(self, self.cfg.maxlen, x.device),
                              position_ids)
        attend = self._attend(position_ids)

        def layer(x, lp):
            return _block(self, lp, x, cos, sin, dtype, attend)[0]

        for lp in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, lp, **_remat_kwargs(self.remat))
            else:
                x = layer(x, lp)
        return _logits_tokens(self, x, dtype)

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
        value).

        On a mesh the arguments are this rank's rows and chunk; the masked
        sum and the count are summed over the batch group (dp x cp) first,
        so every rank returns the global loss. The sum's backward passes
        its cotangent through, so a rank's gradient is that of local_sum /
        global_count, and the batch group's sum of the ranks' gradients
        (the train step) is the global loss's."""
        if mode not in ("vocab_parallel", "gather"):
            raise ValueError(f"unknown loss mode {mode!r}")
        logits = self.forward(input_ids, position_ids).float()
        valid = target_ids != IGNORE_INDEX
        tgt = torch.where(valid, target_ids, 0).long()
        token_loss = self._token_ce(logits, tgt, mode)
        loss_sum = torch.where(valid, token_loss, 0.0).sum()
        count = valid.float().sum()
        if self.mesh is not None and self.mesh.dp * self.mesh.cp > 1:
            loss_sum, count = all_reduce_sum(torch.stack([loss_sum, count]),
                                             self.mesh, "batch").unbind()
        return loss_sum / torch.clamp(count, min=1.0)

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
