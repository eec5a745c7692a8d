"""Which dim of each state-dict leaf shards over tp: the JAX
`Transformer.specs()` seen in torch's (odim, idim) weight layout.

Column weights (JAX P(None, 'tp')) and their biases, the lm_head's included,
shard on torch dim 0; row weights (JAX P('tp', None)) on torch dim 1; the
embedding table (JAX P('tp', None)) on dim 0. Norms, row biases and the
gpt2 family's learned position table are replicated over tp. The leaves of
both families: llama's SwiGLU projections, gpt2's `fc` (column) and `proj`
(row); a tied gpt2 head has no `lm_head` leaves, its vocab dim is the
embedding's. `shard_params` cuts one tp rank's shard from a global
state dict, `assemble_params` joins every rank's shard back into it."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..config import padded_vocab_size

Tensors = Dict[str, torch.Tensor]

COLUMNS = ("wq", "wk", "wv", "gate_proj", "up_proj", "fc")
ROWS = ("wo", "down_proj", "proj")
# the leaves with a vocab dim (torch dim 0), padded to a multiple of tp
# (the lm_head's only in the llama family: gpt2 ties its head)
VOCAB_KEYS = ("embedding.weight", "lm_head.weight", "lm_head.bias")


def tp_dim(key: str) -> Optional[int]:
    """The torch dim of state-dict leaf `key` that shards over tp, or None
    for a leaf replicated over tp."""
    if key in VOCAB_KEYS:
        return 0
    name, leaf = key.split(".")[-2:]
    if name in COLUMNS:
        return 0
    if name in ROWS and leaf == "weight":
        return 1
    return None


def pad_vocab(sd: Tensors, vocab_padded: int) -> Tensors:
    """sd with its vocab leaves zero-padded to `vocab_padded` rows."""
    out = dict(sd)
    for key in VOCAB_KEYS:
        if key not in sd:
            continue
        x = sd[key]
        if x.shape[0] < vocab_padded:
            pad = x.new_zeros((vocab_padded - x.shape[0],) + x.shape[1:])
            out[key] = torch.cat([x, pad])
    return out


def shard_params(sd: Tensors, tp_size: int, tp_rank: int) -> Tensors:
    """Tp rank `tp_rank`'s shard of a global state dict (its vocab padded to
    a multiple of tp_size first)."""
    if tp_size == 1:
        return sd
    rows = sd["embedding.weight"].shape[0]
    sd = pad_vocab(sd, padded_vocab_size(rows, tp_size))
    out = {}
    for key, x in sd.items():
        dim = tp_dim(key)
        if dim is None:
            out[key] = x
            continue
        if x.shape[dim] % tp_size:
            raise ValueError(f"{key} {tuple(x.shape)}: dim {dim} does not "
                             f"shard over tp {tp_size}")
        out[key] = x.chunk(tp_size, dim)[tp_rank].contiguous()
    return out


def assemble_params(shards: List[Tensors]) -> Tensors:
    """Every tp rank's shard, in rank order -> the global state dict (vocab
    leaves still padded to the shards' multiple of tp)."""
    if len(shards) == 1:
        return shards[0]
    return {key: (x if tp_dim(key) is None
                  else torch.cat([s[key] for s in shards], tp_dim(key)))
            for key, x in shards[0].items()}
