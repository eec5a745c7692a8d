"""Dense LLaMA-style decoder (RoPE + RMSNorm + SwiGLU) — counterpart of
the JAX `models/transformer.py` at tp=1.

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

Not ported in this slice (multi-device work): tp > 1, MoE, pipeline,
context/sequence parallelism, tp overlap, and the 'dots'/'auto' remat
policies.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import IGNORE_INDEX, ModelConfig, resolve_dtype
from ..ops.rope import rope_tables
from ..parallel.embedding import VocabParallelEmbedding
from ..parallel.linear import ColumnParallelLinear, RowParallelLinear
from ..parallel.norm import RMSNorm
from .decode import _block, _embed, _logits_tokens, _positions


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

    def __init__(self, cfg: ModelConfig, remat: bool = True):
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
        self.cfg = cfg
        self.remat = remat
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

    def forward(self, input_ids: torch.Tensor,
                position_ids: torch.Tensor) -> torch.Tensor:
        """(b, t) ids and positions -> (b, t, vocab) logits in the compute
        dtype. Positions outside the RoPE table clamp to its last row (JAX
        mode='clip')."""
        dtype = resolve_dtype(self.cfg.compute_dtype)
        x = _embed(self, input_ids, dtype)
        cos_t, sin_t = rope_tables(self.cfg.maxlen, self.cfg.head_dim,
                                   self.cfg.rope_theta, x.device)
        cos, sin = _positions(cos_t, sin_t, position_ids)

        def layer(x, lp):
            return _block(self, lp, x, cos, sin, dtype)[0]

        for lp in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, lp, use_reentrant=False)
            else:
                x = layer(x, lp)
        return _logits_tokens(self, x, dtype)

    def loss(self, input_ids: torch.Tensor, target_ids: torch.Tensor,
             position_ids: torch.Tensor,
             mode: str = "vocab_parallel") -> torch.Tensor:
        """Mean f32 cross-entropy over the targets that are not
        IGNORE_INDEX (denominator max(count, 1)), the JAX `loss_shard`. At
        tp=1 the 'vocab_parallel' and 'gather' modes compute the same
        value; both names are accepted."""
        if mode not in ("vocab_parallel", "gather"):
            raise ValueError(f"unknown loss mode {mode!r}")
        logits = self.forward(input_ids, position_ids).float()
        valid = target_ids != IGNORE_INDEX
        tgt = torch.where(valid, target_ids, 0).long()
        lse = torch.logsumexp(logits, dim=-1)
        tgt_logit = torch.gather(logits, -1, tgt[..., None])[..., 0]
        loss_sum = torch.where(valid, lse - tgt_logit, 0.0).sum()
        count = valid.float().sum()
        return loss_sum / torch.clamp(count, min=1.0)
