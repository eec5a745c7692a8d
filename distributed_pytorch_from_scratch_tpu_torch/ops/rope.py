"""Rotary position embeddings (counterpart of the JAX `ops/rope.py`):
half-rotation layout, f32 tables of shape (maxlen, head_dim), cast to the
activation dtype at application time."""

from __future__ import annotations

from typing import Tuple

import torch


def rope_tables(maxlen: int, head_dim: int, base: float = 10000.0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute (cos, sin), each (maxlen, head_dim), float32."""
    assert head_dim % 2 == 0
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    # the base made on the device (no host copy: a captured step builds the
    # tables inside its graph)
    theta = 1.0 / torch.pow(torch.full((), base, dtype=torch.float32,
                                       device=device), exponent)
    pos = torch.arange(maxlen, dtype=torch.float32, device=device)[:, None]
    ang = pos * theta[None, :]                    # (maxlen, head_dim/2)
    ang = torch.cat([ang, ang], dim=-1)           # repeat(1, 2) layout
    return torch.cos(ang), torch.sin(ang)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply RoPE to q, k of shape (b, heads, t, head_dim); cos/sin are
    (b, t, head_dim), already indexed by position."""
    cos = cos[:, None, :, :].to(q.dtype)
    sin = sin[:, None, :, :].to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
