"""The model families and their builder: `Transformer` (llama) and
`GPT2Transformer` (gpt2)."""

from __future__ import annotations

from ..config import ModelConfig
from ..parallel.layout import is_expert, tp_dim
from .gpt2 import GPT2Transformer
from .transformer import Transformer


def build_model(family: str, cfg: ModelConfig, **kw) -> Transformer:
    """The model of `family` ('llama' or 'gpt2'), `Transformer`'s keyword
    arguments passed on."""
    if family == "llama":
        return Transformer(cfg, **kw)
    if family == "gpt2":
        return GPT2Transformer(cfg, **kw)
    raise ValueError(f"unknown model family {family!r}; expected 'llama' or "
                     f"'gpt2'")


def num_params(model: Transformer) -> int:
    """The model's global parameter count, the tp- and ep-sharded leaves
    counted whole (with the vocab padded to a multiple of tp, as the JAX
    tree holds it)."""
    return sum(p.numel() * (1 if tp_dim(k) is None else model.tp_size)
               * (model.ep_size if is_expert(k) else 1)
               for k, p in model.named_parameters())
