"""Typed configuration: the port's own copy of the JAX package's
`config.py` model shapes, presets and special-token conventions, with
`resolve_dtype` mapping to torch dtypes."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# Special-token conventions, byte-compatible with the shipped tokenizer.
BOS_TOKEN = "<BOS>"
EOS_TOKEN = "<EOS>"
UNK_TOKEN = "<UNK>"

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"Unknown dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    """LLaMA-style decoder-only transformer shape (defaults: the ~45M
    reference model)."""

    attn_dim: int = 512
    ffn_dim: int = 2048
    num_heads: int = 8
    num_layers: int = 12
    vocab_size: int = 1024
    maxlen: int = 1000
    rope_theta: float = 10000.0
    # Grouped-query attention: number of K/V heads. None = num_heads.
    num_kv_heads: "int | None" = None
    # Dtype of matmuls/activations in the forward pass; parameters stay f32.
    compute_dtype: str = "float32"
    # Mixture-of-Experts shape fields (kept so checkpoint-consuming CLIs
    # parse the same flags; the port refuses num_experts > 0 for now).
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0

    @property
    def head_dim(self) -> int:
        assert self.attn_dim % self.num_heads == 0
        return self.attn_dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads if self.num_kv_heads is not None else self.num_heads

    @property
    def kv_dim(self) -> int:
        """Output width of wk/wv: kv_heads * head_dim (== attn_dim for MHA)."""
        return self.kv_heads * self.head_dim


# Named model presets: "45m" is the reference shape, "tiny" the CPU smoke.
MODEL_PRESETS = {
    "45m": ModelConfig(),
    "gpt2-124m": ModelConfig(attn_dim=768, ffn_dim=3072, num_heads=12,
                             num_layers=12, vocab_size=50257, maxlen=1024),
    "tiny": ModelConfig(attn_dim=128, ffn_dim=512, num_heads=4,
                        num_layers=2, vocab_size=1024, maxlen=256),
    "45m-moe8": ModelConfig(num_experts=8, moe_top_k=2),
    "gpt2-355m": ModelConfig(attn_dim=1024, ffn_dim=4096, num_heads=16,
                             num_layers=24, vocab_size=50257, maxlen=1024),
}


def model_preset(name: str, **overrides) -> ModelConfig:
    if name not in MODEL_PRESETS:
        raise ValueError(
            f"unknown model preset {name!r}; expected one of "
            f"{sorted(MODEL_PRESETS)}")
    return dataclasses.replace(MODEL_PRESETS[name], **overrides)


@dataclass(frozen=True)
class MeshConfig:
    """Mesh axes ('dp', 'pp', 'cp', 'ep', 'tp'); the port runs the
    1-device case only (runtime/mesh.py refuses any axis > 1)."""

    dp: int = 1
    tp: int = 1
    cp: int = 1
    ep: int = 1
    pp: int = 1

