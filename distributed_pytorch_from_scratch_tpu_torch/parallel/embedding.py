"""Vocabulary-parallel embedding (counterpart of the JAX
`parallel/embedding.py`).

The table is padded to `vocab_padded` rows, a multiple of tp (the padded
rows are zero and no valid id reaches them), and each tp rank holds a
contiguous range of vocab_padded/tp rows. Ids outside the rank's range —
other ranks' rows, and ids < 0 or >= vocab_padded — give ZERO rows; the
partial embeddings are then summed over tp (`reduce_from`), or, under
sequence parallelism, reduce-scattered over the sequence so each rank
keeps its (b, t/tp, d) chunk. Torch indexing would raise on an id outside
the table, so the local ids are clamped for the gather and the rows masked
afterwards. At tp = 1 the shard is the whole table."""

from __future__ import annotations

import torch
from torch import nn

from ..config import padded_vocab_size
from ..ops.collectives import reduce_from, reduce_scatter


class VocabParallelEmbedding(nn.Module):
    def __init__(self, vocab_size: int, hdim: int, mesh=None,
                 init_std: float = 1.0):
        super().__init__()
        self.init_std = init_std
        tp = 1 if mesh is None else mesh.tp
        self.vocab_size = vocab_size
        self.vocab_padded = padded_vocab_size(vocab_size, tp)
        self.hdim = hdim
        self.mesh = mesh
        self.weight = nn.Parameter(
            torch.empty(self.vocab_padded // tp, hdim, dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # normal(0, init_std): 1 is nn.Embedding's default, the reference's
        # init; the gpt2 family draws with 0.02
        with torch.no_grad():
            self.weight.normal_(0.0, self.init_std, generator=generator)

    def forward(self, ids: torch.Tensor,
                output_layout: str = "replicated") -> torch.Tensor:
        """ids: (b, t) integer -> (b, t, hdim) float32, or (b, t/tp, hdim)
        under output_layout='seq_sharded'."""
        rows = self.weight.shape[0]
        tp = 1 if self.mesh is None else self.mesh.tp
        start = 0 if tp == 1 else self.mesh.tp_rank * rows
        local = ids - start
        in_range = (local >= 0) & (local < rows)
        out = self.weight[local.clamp(0, rows - 1)]
        out = torch.where(in_range[..., None], out, out.new_zeros(()))
        if tp == 1:
            return out
        if output_layout == "seq_sharded":
            return reduce_scatter(out, self.mesh, dim=-2)
        if output_layout != "replicated":
            raise ValueError(f"unknown output_layout {output_layout!r}")
        return reduce_from(out, self.mesh)
