"""Dense LLaMA-style decoder (RoPE + RMSNorm + SwiGLU) for decoding —
counterpart of the JAX `models/transformer.py` at tp=1.

The module holds its weights (float32, like the JAX param tree): per layer
`wq/wk/wv/wo/norm1/norm2/gate_proj/up_proj/down_proj`, then the final
`norm` and a biased `lm_head`. The forward passes live in
`models/decode.py`, as in the JAX package. `interop.params_from_jax` maps a
JAX param tree onto this module's `state_dict`.

Not ported in this slice (training or multi-device work): tp > 1, MoE,
pipeline, context/sequence parallelism, tp overlap, remat.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..parallel.embedding import VocabParallelEmbedding
from ..parallel.linear import ColumnParallelLinear, RowParallelLinear
from ..parallel.norm import RMSNorm


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

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.num_experts:
            raise NotImplementedError(
                "num_experts > 0: MoE is not ported yet, see ROADMAP")
        if cfg.num_heads % cfg.kv_heads != 0:
            raise ValueError(f"num_heads {cfg.num_heads} must be a multiple "
                             f"of num_kv_heads {cfg.kv_heads}")
        self.cfg = cfg
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
