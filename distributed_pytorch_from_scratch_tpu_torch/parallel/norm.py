"""RMSNorm, computed in f32 (counterpart of the JAX `parallel/norm.py`).

`scale * x * rsqrt(mean(x^2) + eps)`: the normalisation runs in f32, then
both the normalised activations and the scale are cast to x's dtype
BEFORE the product — the JAX rounding point, which matters in bf16."""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    def __init__(self, hdim: int, eps: float = 1e-5):
        super().__init__()
        self.hdim = hdim
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(hdim, dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return self.scale.to(x.dtype) * normed.to(x.dtype)
