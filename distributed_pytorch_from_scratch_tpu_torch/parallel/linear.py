"""Column- and row-parallel linear layers at tp=1 (counterpart of the JAX
`parallel/linear.py`).

At tp=1 both reduce to `y = x @ W^T + b`; the two classes stay distinct so
the model's module names and the tp>1 slice keep their shape. Weights are
stored in torch's (odim, idim) layout (`interop.params_from_jax`
transposes the JAX (idim, odim) weights) and stay float32; they are cast to
the compute dtype at use, and the bias is added after the product is
rounded to that dtype, as in the JAX layer. The per-use cast is inside the
autograd graph, so the gradient reaches the float32 parameter."""

from __future__ import annotations

import math

import torch
from torch import nn


class _Linear(nn.Module):
    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.idim = idim
        self.odim = odim
        self.weight = nn.Parameter(
            torch.empty(odim, idim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(odim, dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # Uniform(-1/sqrt(idim), 1/sqrt(idim)): the distribution of torch's
        # kaiming_uniform_(a=sqrt(5)) on an (odim, idim) weight; zero bias
        bound = 1.0 / math.sqrt(self.idim)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        y = torch.matmul(x.to(compute_dtype), self.weight.to(compute_dtype).t())
        return y + self.bias.to(compute_dtype)


class ColumnParallelLinear(_Linear):
    """Y = X @ W + b with W's output dim sharded over tp (tp=1 here)."""


class RowParallelLinear(_Linear):
    """Y = X @ W + b with W's input dim sharded over tp (tp=1 here)."""
