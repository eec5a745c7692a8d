"""Causal self-attention (counterpart of the JAX `ops/attention.py`).

`causal_attention_plain` mirrors `causal_attention_xla`: q @ k^T / sqrt(d)
in the input dtype, masked positions set to -10000, softmax in f32,
probabilities cast back to the input dtype, @ v. `causal_attention`
dispatches like the JAX `impl="auto"`: the hand-written CUDA flash kernels
(forward, and backward through an autograd Function) for a CUDA tensor,
the plain path for a CPU tensor."""

from __future__ import annotations

import math

import torch

MASK_VALUE = -10000.0  # the reference's mask value


def repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Expand grouped-query k/v (b, kv_heads, t, d) to q's head count."""
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    return k, v


def causal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           t_real: int = None) -> torch.Tensor:
    """q: (b, heads, t, head_dim) -> (b, heads, t, head_dim); k/v may carry
    fewer (grouped-query) heads. `t_real` < t marks the trailing rows as
    padding: they are sliced off before the scores form and the output
    pads back with exact zeros (the flash kernel's `t_real` contract)."""
    *_, t, head_dim = q.shape
    if t_real is not None and t_real < t:
        out = causal_attention_plain(q[..., :t_real, :], k[..., :t_real, :],
                                     v[..., :t_real, :])
        return torch.nn.functional.pad(out, (0, 0, 0, t - t_real))
    k, v = repeat_kv(q, k, v)
    scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    mask = torch.triu(torch.ones(t, t, dtype=torch.bool, device=q.device),
                      diagonal=1)
    scores = scores.masked_fill(mask, MASK_VALUE)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     t_real: int = None) -> torch.Tensor:
    """The flash kernels on a CUDA tensor (they raise rather than fall back),
    `causal_attention_plain` with torch autograd on a CPU tensor — JAX
    `impl="auto"`. The CUDA path goes through `FlashAttention`, whose
    backward launches the backward kernels; under no_grad/inference_mode
    its output has no grad_fn, so the saved tensors go with the context and
    serving keeps nothing for a backward."""
    if q.is_cuda:
        from .cuda.flash_attention import FlashAttention
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), t_real)
    return causal_attention_plain(q, k, v, t_real=t_real)
