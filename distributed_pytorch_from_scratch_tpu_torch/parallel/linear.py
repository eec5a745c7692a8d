"""Column- and row-parallel linear layers (counterpart of the JAX
`parallel/linear.py`), Megatron's 1D tensor parallelism over the mesh's tp
axis.

Weights are stored in torch's (odim, idim) layout (`interop.params_from_jax`
transposes the JAX (idim, odim) weights), so the tp dim of a column weight
is torch dim 0 and that of a row weight dim 1. Each rank holds its slice:
a column layer (odim/tp, idim) and a sharded bias (odim/tp,), added before
any gather; a row layer (odim, idim/tp) and the full bias (odim,), added
after the reduce — the JAX (and reference) bias placement. Weights stay
float32 and are cast to the compute dtype at use, inside the autograd
graph, so the gradient reaches the float32 parameter; the bias is added
after the product is rounded to that dtype, as in the JAX layer.

Layouts (the JAX names):
* column input: 'replicated' (`copy_to`: the backward all-reduces the
  input's gradient), 'seq_sharded' (sequence parallelism: x is (b, t/tp,
  d) and is all-gathered over the sequence, whose backward reduce-scatters)
  or 'gathered' (the caller shared one `copy_to` or gather among several
  projections of one input); `gather_output` all-gathers the output dim;
* row output: 'replicated' (`reduce_from`, an all-reduce of the partial
  sums) or 'seq_sharded' (a reduce-scatter over the sequence);
  `split_input` slices a replicated input first.
At tp = 1 every collective is the identity and both classes compute
`y = x @ W^T + b`.

`overlap` (the model's `tp_overlap`, JAX's `OVERLAP_MODES`): 'ring' runs
a column layer's 'seq_sharded' input through the ring all-gather-matmul
(`ops/overlap.ag_matmul`) and a row layer's 'seq_sharded' output through
the ring matmul-reduce-scatter (`matmul_rs`), 'ring_q' the same rings
with int8 payloads; every other layout, and 'off', is the monolithic
path above. `apply_column_ring_fused` runs several column projections of
one sequence-sharded input (wq/wk/wv, gate/up) on one shared ring."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.collectives import (copy_to, gather_from, reduce_from,
                               reduce_scatter, split_to)
from ..ops.overlap import ag_matmul, matmul_rs

OVERLAP_MODES = ("off", "ring", "ring_q")


def _check_overlap(overlap: str) -> None:
    if overlap not in OVERLAP_MODES:
        raise ValueError(f"overlap must be one of {OVERLAP_MODES}, "
                         f"got {overlap!r}")


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


class _Linear(nn.Module):
    """The shared parameters: a (odim_local, idim_local) weight and a
    bias of `bias_dim`."""

    def __init__(self, idim: int, odim: int, weight_shape, bias_dim: int,
                 mesh=None, overlap: str = "off"):
        super().__init__()
        _check_overlap(overlap)
        self.idim = idim
        self.odim = odim
        self.mesh = mesh
        self.overlap = overlap
        self.weight = nn.Parameter(
            torch.empty(*weight_shape, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(bias_dim, dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # Uniform(-1/sqrt(idim), 1/sqrt(idim)): the distribution of torch's
        # kaiming_uniform_(a=sqrt(5)) on an (odim, idim) weight; zero bias
        bound = 1.0 / math.sqrt(self.idim)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def _matmul(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return torch.matmul(x.to(dtype), self.weight.to(dtype).t())


class ColumnParallelLinear(_Linear):
    """Y = X @ W + b with W's output dim sharded over tp."""

    def __init__(self, idim: int, odim: int, mesh=None,
                 gather_output: bool = False, overlap: str = "off"):
        tp = _tp(mesh)
        if odim % tp:
            raise ValueError(f"output dim {odim} is not divisible by tp "
                             f"{tp}")
        super().__init__(idim, odim, (odim // tp, idim), odim // tp, mesh,
                         overlap)
        self.gather_output = gather_output

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                input_layout: str = "replicated") -> torch.Tensor:
        mesh = self.mesh
        if (_tp(mesh) > 1 and input_layout == "seq_sharded"
                and self.overlap != "off"):
            y = apply_column_ring_fused([self], x, compute_dtype,
                                        self.overlap == "ring_q")[0]
            return gather_from(y, mesh) if self.gather_output else y
        if _tp(mesh) > 1:
            if input_layout == "replicated":
                x = copy_to(x, mesh)
            elif input_layout == "seq_sharded":
                x = gather_from(x, mesh, dim=-2)
            elif input_layout != "gathered":
                raise ValueError(f"unknown input_layout {input_layout!r}")
        y = self._matmul(x, compute_dtype) + self.bias.to(compute_dtype)
        if self.gather_output and _tp(mesh) > 1:
            y = gather_from(y, mesh)
        return y


class RowParallelLinear(_Linear):
    """Y = X @ W + b with W's input dim sharded over tp."""

    def __init__(self, idim: int, odim: int, mesh=None,
                 split_input: bool = False, overlap: str = "off"):
        tp = _tp(mesh)
        if idim % tp:
            raise ValueError(f"input dim {idim} is not divisible by tp {tp}")
        super().__init__(idim, odim, (odim, idim // tp), odim, mesh, overlap)
        self.split_input = split_input

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                output_layout: str = "replicated") -> torch.Tensor:
        mesh = self.mesh
        if _tp(mesh) == 1:
            return self._matmul(x, compute_dtype) + self.bias.to(compute_dtype)
        if self.split_input:
            x = split_to(x, mesh)
        if output_layout == "seq_sharded" and self.overlap != "off":
            y = matmul_rs(x.to(compute_dtype),
                          self.weight.to(compute_dtype), mesh,
                          self.overlap == "ring_q")
            return y + self.bias.to(compute_dtype)
        y = self._matmul(x, compute_dtype)
        if output_layout == "replicated":
            y = reduce_from(y, mesh)
        elif output_layout == "seq_sharded":
            y = reduce_scatter(y, mesh, dim=-2)
        else:
            raise ValueError(f"unknown output_layout {output_layout!r}")
        return y + self.bias.to(compute_dtype)


def apply_column_ring_fused(layers, x: torch.Tensor, compute_dtype,
                            quantized: bool = False):
    """Several column-parallel projections of ONE sequence-sharded input x
    (b, t/tp, d) on one shared ring (wq/wk/wv, gate/up; JAX's
    `apply_column_ring_fused`): one `ag_matmul` over their weights, so the
    ring moves the bytes of the one all-gather it replaces and its
    backward sums the projections' input cotangents on one reduce ring.
    Returns each layer's (b, t, odim/tp) output, its bias added after the
    ring in the compute dtype."""
    ys = ag_matmul(x.to(compute_dtype),
                   tuple(m.weight.to(compute_dtype) for m in layers),
                   layers[0].mesh, quantized)
    return [y + m.bias.to(compute_dtype) for m, y in zip(layers, ys)]
