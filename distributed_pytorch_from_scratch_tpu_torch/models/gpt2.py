"""GPT-2 family: LayerNorm + tanh-GELU MLP + learned position embeddings
+ a head TIED to the vocab-parallel token embedding — counterpart of the
JAX `models/gpt2.py`, at dp x cp x tp with sequence parallelism.

The module holds its weights (float32, the JAX tree's leaves): the token
`embedding` and `pos_embedding` (maxlen, d), per layer
`ln1/wq/wk/wv/wo/ln2/fc/proj`, then the final `norm`; there is no
`lm_head`. `interop.params_from_jax` maps a JAX gpt2 tree onto its
`state_dict`, whole or one tp rank's shard.

Everything but the modules is the llama `Transformer`'s, as JAX borrows
it: the forward (`models/decode.py` lowerings, generic over the family
through the `uses_rope` / `attn_norm_key` / `ffn_norm_key` hooks and the
module dict), `loss`, `doc_loss`, `_token_ce`, `full_logits`, `cp_shard`,
remat (`true | dots | false`) and `init_weights` (the same seed gives the
same function at any tp). So:
* wq/wk/wv and fc are column-parallel, wo and proj row-parallel — one
  all-reduce per sublayer per direction, as the llama layers;
* the position rows enter at the embedding, clamped into the table (JAX
  mode='clip'); under sequence parallelism this rank's slice of them is
  taken before the add, and under cp each rank indexes its own chunk's
  positions (no RoPE);
* the tied head is `x @ embedding.weight.T` on this rank's vocab rows, the
  padded columns masked to NEG_INF — the local-vocab logits the
  vocab-parallel CE consumes — and the embedding weight takes both its
  gradients (lookup and head) through autograd.

With `cfg.num_experts > 0` each layer's `fc`/`proj` MLP is the llama
family's routed-expert `moe` module instead (SwiGLU experts, as in the JAX
family: the trunk stays GPT-2), with its aux losses and expert
parallelism.

Under a pp axis the family pipelines as the llama one (`models/
pipeline.py`). The tied head is the point there: stage 0 reads the
embedding for its input and every stage for its head rows, so the
embedding's gradient is the pp sum of both uses (the train step's
all-reduce over pp of the leaves every stage holds).

The JAX family's MHA-only rule stands (num_kv_heads must equal
num_heads). Not ported: tp overlap (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..parallel.embedding import VocabParallelEmbedding
from ..parallel.linear import ColumnParallelLinear, RowParallelLinear
from ..parallel.norm import LayerNorm
from .transformer import Transformer, moe_ffn

INIT_STD = 0.02  # GPT-2's embedding and position-table init scale


class PositionTable(nn.Module):
    """The learned (maxlen, d) position rows, replicated over tp; read by
    `decode._embed`."""

    def __init__(self, maxlen: int, hdim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(maxlen, hdim,
                                               dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, INIT_STD, generator=generator)


def _layer(cfg: ModelConfig, mesh) -> nn.ModuleDict:
    d, f = cfg.attn_dim, cfg.ffn_dim
    mods = {
        "ln1": LayerNorm(d),
        "wq": ColumnParallelLinear(d, d, mesh),
        "wk": ColumnParallelLinear(d, d, mesh),
        "wv": ColumnParallelLinear(d, d, mesh),
        "wo": RowParallelLinear(d, d, mesh),
        "ln2": LayerNorm(d),
    }
    if cfg.num_experts:
        mods["moe"] = moe_ffn(cfg, mesh)
    else:
        mods.update({"fc": ColumnParallelLinear(d, f, mesh),
                     "proj": RowParallelLinear(f, d, mesh)})
    return nn.ModuleDict(mods)


class GPT2Transformer(Transformer):
    # family hooks for the generic KV decoder (models/decode.py): learned
    # positions instead of RoPE, LayerNorm module keys
    uses_rope = False
    attn_norm_key = "ln1"
    ffn_norm_key = "ln2"

    def __init__(self, cfg: ModelConfig, remat=True, **kw):
        if cfg.kv_heads != cfg.num_heads:
            raise ValueError("grouped-query attention (num_kv_heads) is a "
                             "llama-family feature; the gpt2 family is MHA "
                             "(real GPT-2 has none — documented choice)")
        super().__init__(cfg, remat=remat, **kw)

    def _build(self, cfg: ModelConfig, tp_mesh) -> None:
        self.embedding = VocabParallelEmbedding(cfg.vocab_size, cfg.attn_dim,
                                                tp_mesh, init_std=INIT_STD)
        self.pos_embedding = PositionTable(cfg.maxlen, cfg.attn_dim)
        self.layers = nn.ModuleList(_layer(cfg, tp_mesh)
                                    for _ in self.layer_ids)
        self.norm = LayerNorm(cfg.attn_dim)

    @property
    def max_decode_positions(self) -> int:
        """Learned positions cap a sequence at maxlen: there is no table to
        extend, so the decode CLIs clamp their buffers to it."""
        return self.cfg.maxlen

