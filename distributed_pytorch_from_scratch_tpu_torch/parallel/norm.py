"""RMSNorm and LayerNorm, computed in f32 (counterparts of the JAX
`parallel/norm.py`).

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


class LayerNorm(nn.Module):
    """`scale * (x - mean) * rsqrt(var + eps) + bias` (the gpt2 family's
    norm, the JAX `LayerNorm`): mean and biased variance in f32, the
    normalised activations cast to x's dtype, then scale and bias, both
    cast to x's dtype, applied there — JAX's rounding points.
    `F.layer_norm` would round elsewhere in bf16."""

    def __init__(self, hdim: int, eps: float = 1e-5):
        super().__init__()
        self.hdim = hdim
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(hdim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(hdim, dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        normed = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return self.scale.to(x.dtype) * normed + self.bias.to(x.dtype)
