"""Typed configuration: the port's own copy of the JAX package's
`config.py` model shapes, presets, optimizer settings and special-token
conventions, with `resolve_dtype` mapping to torch dtypes (and
`resolve_dtype_on` refusing, on a card, what the port's kernels do not
take)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# Special-token conventions, byte-compatible with the shipped tokenizer.
BOS_TOKEN = "<BOS>"
EOS_TOKEN = "<EOS>"
UNK_TOKEN = "<UNK>"
IGNORE_INDEX = -1

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


# the compute dtypes the port's CUDA kernels take
KERNEL_DTYPES = ("float32", "bfloat16")


def padded_vocab_size(vocab_size: int, tp_size: int) -> int:
    """Vocab size rounded up to a multiple of tp_size: the embedding's rows
    and the head's columns shard evenly over tp, the padded rows and
    columns are zero and the padded logits are masked."""
    return -(-vocab_size // tp_size) * tp_size


def resolve_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"Unknown dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def resolve_dtype_on(name: str, device) -> torch.dtype:
    """`resolve_dtype` for a model or engine whose tensors live on `device`.
    On a CUDA device only `KERNEL_DTYPES` are taken: float16 has no kernel
    there and is refused here, before anything is built on the card, rather
    than deep inside the first attention call. The CPU takes every dtype,
    as the JAX package does."""
    dtype = resolve_dtype(name)
    if torch.device(device).type == "cuda" and name not in KERNEL_DTYPES:
        raise ValueError(
            f"compute_dtype {name!r} is not supported on a CUDA device: the "
            f"port's kernels take float32 and bfloat16 (run {name} on the "
            f"CPU, or pick one of those)")
    return dtype


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
    # Mixture-of-Experts: 0 = the dense SwiGLU FFN; > 0 swaps every layer's
    # FFN for top-k routed SwiGLU experts (parallel/moe.py), sharded over
    # the mesh axis 'ep' in training.
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_coef: float = 0.01   # load-balance loss weight (Switch: 0.01)
    moe_z_coef: float = 1e-3     # router z-loss weight (ST-MoE: 1e-3)

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

    def padded_vocab_size(self, tp_size: int) -> int:
        return padded_vocab_size(self.vocab_size, tp_size)

    def num_params(self) -> int:
        d, f, v, L = self.attn_dim, self.ffn_dim, self.vocab_size, self.num_layers
        kd = self.kv_dim
        attn = 2 * d * d + 2 * d * kd + 2 * d + 2 * kd  # wq/wo + wk/wv (+ biases)
        if self.num_experts:
            ffn = self.num_experts * 3 * d * f + d * self.num_experts  # experts + router
        else:
            ffn = 3 * d * f + 2 * f + d          # gate/up/down weights + biases
        norms = 2 * d
        return v * d + L * (attn + ffn + norms) + d + v * d + v  # emb + layers + final norm + lm_head


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
    """Mesh axes ('dp', 'pp', 'cp', 'ep', 'tp'), each run through
    torch.distributed (runtime/mesh.py)."""

    dp: int = 1
    tp: int = 1
    cp: int = 1
    ep: int = 1
    pp: int = 1


@dataclass(frozen=True)
class OptimizerConfig:
    """Adam + OneCycle with torch's OneCycleLR defaults (div_factor=25,
    final_div_factor=1e4, cosine annealing, beta1 cycled between 0.85 and
    0.95), field for field the JAX package's `OptimizerConfig`."""

    lr: float = 3e-4
    warmup_steps: int = 2000
    max_steps: int = 20000
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    # OneCycle details (torch defaults)
    div_factor: float = 25.0
    final_div_factor: float = 1e4
    cycle_momentum: bool = True
    base_momentum: float = 0.85
    max_momentum: float = 0.95
    # Global-norm gradient clipping (torch clip_grad_norm_ semantics: one
    # norm over ALL grads, scale = max_norm / (norm + 1e-6) when exceeded).
    # None = off.
    clip_grad_norm: "float | None" = None
    # Decoupled weight decay (torch.optim.AdamW semantics: params shrink by
    # lr*wd BEFORE the Adam step). 0.0 = plain Adam.
    weight_decay: float = 0.0
    # 'onecycle', or 'cosine' (linear warmup over warmup_steps -> cosine
    # decay to cosine_min_ratio * lr; beta1 fixed).
    lr_schedule: str = "onecycle"
    cosine_min_ratio: float = 0.1
