"""Dense LLaMA-style decoder (RoPE + RMSNorm + SwiGLU) — counterpart of
the JAX `models/transformer.py` at tp=1, with context parallelism.

The module holds its weights (float32, like the JAX param tree): per layer
`wq/wk/wv/wo/norm1/norm2/gate_proj/up_proj/down_proj`, then the final
`norm` and a biased `lm_head`. `interop.params_from_jax` maps a JAX param
tree onto this module's `state_dict`.

`forward` is the full-sequence training forward (the JAX `_layer_body`
stack at tp=1) and `loss` the f32 masked-mean cross-entropy of
`loss_shard`. The decoding lowerings live in `models/decode.py`, as in the
JAX package; both share its layer block. `remat=True` recomputes each layer
in the backward (`torch.utils.checkpoint`, the JAX `remat_wrap`); `False`
saves every activation.

At `cp_size > 1` the model runs on one rank of the cp group (`mesh`):
`forward` and `loss` take this rank's chunk of the sequence (`cp_shard`
cuts it from a full batch: the zig-zag order first under
`cp_layout='zigzag'`, then the rank's contiguous slice), attention is
`ring_attention` or `ulysses_attention` over the group, and the loss sums
its numerator and count over the group before it divides. Parameters are
replicated; the train step sums their gradients over the group.

Not ported (multi-device work): tp > 1, MoE, pipeline, sequence
parallelism, tp overlap, and the 'dots'/'auto' remat policies.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import IGNORE_INDEX, ModelConfig, resolve_dtype_on
from ..ops.attention import causal_attention
from ..ops.collectives import all_gather, all_reduce_sum
from ..ops.ring_attention import (cp_chunk_index, ring_attention,
                                  ring_schedule, ulysses_attention)
from ..ops.rope import rope_tables
from ..parallel.embedding import VocabParallelEmbedding
from ..parallel.linear import ColumnParallelLinear, RowParallelLinear
from ..parallel.norm import RMSNorm
from .decode import _block, _embed, _logits_tokens, _positions


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


def _layer(cfg: ModelConfig) -> nn.ModuleDict:
    d, f, kd = cfg.attn_dim, cfg.ffn_dim, cfg.kv_dim
    return nn.ModuleDict({
        "wq": ColumnParallelLinear(d, d),
        "wk": ColumnParallelLinear(d, kd),
        "wv": ColumnParallelLinear(d, kd),
        "wo": RowParallelLinear(d, d),
        "norm1": RMSNorm(d),
        "norm2": RMSNorm(d),
        "gate_proj": ColumnParallelLinear(d, f),
        "up_proj": ColumnParallelLinear(d, f),
        "down_proj": RowParallelLinear(f, d),
    })


class Transformer(nn.Module):
    # family hooks the generic KV decoder consults (models/decode.py)
    uses_rope = True
    attn_norm_key = "norm1"
    ffn_norm_key = "norm2"

    def __init__(self, cfg: ModelConfig, remat: bool = True,
                 cp_size: int = 1, cp_impl: str = "ring",
                 cp_layout: str = "contiguous", mesh=None):
        super().__init__()
        if remat in ("dots", "auto"):
            raise NotImplementedError(
                f"remat={remat!r}: the selective remat policies are not "
                f"ported yet, see ROADMAP Queue 1 (a); use True or False")
        if remat not in (True, False):
            raise ValueError(f"remat must be True or False, got {remat!r}")
        if cfg.num_experts:
            raise NotImplementedError(
                "num_experts > 0: MoE is not ported yet, see ROADMAP")
        if cfg.num_heads % cfg.kv_heads != 0:
            raise ValueError(f"num_heads {cfg.num_heads} must be a multiple "
                             f"of num_kv_heads {cfg.kv_heads}")
        validate_cp(cfg, 1, cp_size, cp_impl, cp_layout)
        if cp_size > 1 and (mesh is None or mesh.cp != cp_size):
            raise ValueError(f"cp_size {cp_size} needs the Mesh of its cp "
                             f"group (runtime.mesh.make_mesh), got {mesh}")
        if mesh is not None:    # the device is known: refuse before weights
            resolve_dtype_on(cfg.compute_dtype, mesh.device)
        self.cfg = cfg
        self.remat = remat
        self.cp_size = cp_size
        self.cp_impl, self.cp_layout = cp_impl, cp_layout
        self.mesh = mesh
        self.embedding = VocabParallelEmbedding(cfg.vocab_size, cfg.attn_dim)
        self.layers = nn.ModuleList(_layer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.attn_dim)
        # at tp=1 the vocab needs no padding, so the head is vocab wide
        self.lm_head = ColumnParallelLinear(cfg.attn_dim, cfg.vocab_size)

    def init_weights(self, seed: int) -> "Transformer":
        """Random init from `seed` with the JAX package's distributions
        (same distributions, not the same bits): normal(0, 1) embedding,
        uniform(+-1/sqrt(idim)) linear weights, zero biases, unit norms.
        Draws on the CPU, so a seed gives the same weights on any device."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        device = self.embedding.weight.device
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
        """(b, t) ids and positions -> (b, t, vocab) logits in the compute
        dtype; at cp > 1 this rank's chunk in, its chunk's logits out.
        Positions outside the RoPE table clamp to its last row (JAX
        mode='clip')."""
        dtype = resolve_dtype_on(self.cfg.compute_dtype, input_ids.device)
        x = _embed(self, input_ids, dtype)
        cos_t, sin_t = rope_tables(self.cfg.maxlen, self.cfg.head_dim,
                                   self.cfg.rope_theta, x.device)
        cos, sin = _positions(cos_t, sin_t, position_ids)
        attend = self._attend(position_ids)

        def layer(x, lp):
            return _block(self, lp, x, cos, sin, dtype, attend)[0]

        for lp in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, lp, use_reentrant=False)
            else:
                x = layer(x, lp)
        return _logits_tokens(self, x, dtype)

    @torch.no_grad()
    def full_logits(self, input_ids: torch.Tensor,
                    position_ids: torch.Tensor) -> torch.Tensor:
        """The JAX `make_forward`: a FULL (b, t) batch in natural token
        order -> its (b, t, vocab) logits in natural order, on every rank
        (each rank runs its chunk; the chunks are gathered and, under the
        zig-zag layout, put back in order)."""
        ids, pos = self.cp_shard(input_ids, position_ids)
        logits = self.forward(ids, pos)
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

    def loss(self, input_ids: torch.Tensor, target_ids: torch.Tensor,
             position_ids: torch.Tensor,
             mode: str = "vocab_parallel") -> torch.Tensor:
        """Mean f32 cross-entropy over the targets that are not
        IGNORE_INDEX (denominator max(count, 1)), the JAX `loss_shard`. At
        tp=1 the 'vocab_parallel' and 'gather' modes compute the same
        value; both names are accepted.

        At cp > 1 the arguments are this rank's chunk; the masked sum and
        the count are summed over the group first, so every rank returns the
        global loss. The sum's backward passes its cotangent through, so a
        rank's gradient is that of local_sum / global_count, and the cp sum
        of the ranks' gradients (the train step) is the global loss's."""
        if mode not in ("vocab_parallel", "gather"):
            raise ValueError(f"unknown loss mode {mode!r}")
        logits = self.forward(input_ids, position_ids).float()
        valid = target_ids != IGNORE_INDEX
        tgt = torch.where(valid, target_ids, 0).long()
        lse = torch.logsumexp(logits, dim=-1)
        tgt_logit = torch.gather(logits, -1, tgt[..., None])[..., 0]
        loss_sum = torch.where(valid, lse - tgt_logit, 0.0).sum()
        count = valid.float().sum()
        if self.cp_size > 1:
            loss_sum, count = all_reduce_sum(torch.stack([loss_sum, count]),
                                             self.mesh).unbind()
        return loss_sum / torch.clamp(count, min=1.0)
