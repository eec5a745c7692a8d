"""Vocabulary-parallel embedding at tp=1 (counterpart of the JAX
`parallel/embedding.py`).

The JAX layer masks ids outside its shard's row range and emits ZERO rows
for them. At tp=1 the shard is the whole table, so an id < 0 or >= vocab
gives a zero row instead of an error; torch indexing would raise, so the
ids are clamped for the gather and the rows masked afterwards."""

from __future__ import annotations

import torch
from torch import nn


class VocabParallelEmbedding(nn.Module):
    def __init__(self, vocab_size: int, hdim: int):
        super().__init__()
        self.vocab_size = vocab_size
        self.hdim = hdim
        self.weight = nn.Parameter(
            torch.empty(vocab_size, hdim, dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # normal(0, 1): nn.Embedding's default, the reference's init
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids: (b, t) integer -> (b, t, hdim) float32."""
        rows = self.weight.shape[0]
        in_range = (ids >= 0) & (ids < rows)
        out = self.weight[ids.clamp(0, rows - 1)]
        return torch.where(in_range[..., None], out, out.new_zeros(()))
