"""Which dim of each state-dict leaf shards over tp: the JAX
`Transformer.specs()` seen in torch's (odim, idim) weight layout.

Column weights (JAX P(None, 'tp')) and their biases, the lm_head's included,
shard on torch dim 0; row weights (JAX P('tp', None)) on torch dim 1; the
embedding table (JAX P('tp', None)) on dim 0. Norms, row biases and the
gpt2 family's learned position table are replicated over tp. The leaves of
both families: llama's SwiGLU projections, gpt2's `fc` (column) and `proj`
(row); a tied gpt2 head has no `lm_head` leaves, its vocab dim is the
embedding's. A MoE layer's `moe` leaves keep the JAX layout: its experts
`gate`/`up` (E, d, f) shard over tp on dim 2 and `down` (E, f, d) on dim
1, and all three over ep on dim 0 (the JAX P('ep', None, 'tp') and P('ep',
'tp', None)); its router (d, E) is replicated. `shard_params` cuts one
(tp, ep) rank's shard from a global state dict, `assemble_params` joins
every rank's shard back into it."""

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
# a MoE layer's expert leaves -> their tp dim
EXPERT_TP_DIMS = {"gate": 2, "up": 2, "down": 1}


def tp_dim(key: str) -> Optional[int]:
    """The torch dim of state-dict leaf `key` that shards over tp, or None
    for a leaf replicated over tp."""
    if key in VOCAB_KEYS:
        return 0
    name, leaf = key.split(".")[-2:]
    if name == "moe":
        return EXPERT_TP_DIMS.get(leaf)
    if name in COLUMNS:
        return 0
    if name in ROWS and leaf == "weight":
        return 1
    return None


def is_expert(key: str) -> bool:
    """Whether state-dict leaf `key` holds experts (sharded over ep on dim
    0)."""
    name, leaf = key.split(".")[-2:]
    return name == "moe" and leaf in EXPERT_TP_DIMS


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


def shard_params(sd: Tensors, tp_size: int, tp_rank: int,
                 ep_size: int = 1, ep_rank: int = 0) -> Tensors:
    """The shard of rank (tp_rank of tp_size, ep_rank of ep_size) of a
    global state dict (its vocab padded to a multiple of tp_size first):
    every tp-sharded leaf's tp slice, and of the expert leaves this ep
    rank's E/ep experts."""
    if tp_size == 1 and ep_size == 1:
        return sd
    if tp_size > 1:
        rows = sd["embedding.weight"].shape[0]
        sd = pad_vocab(sd, padded_vocab_size(rows, tp_size))
    out = {}
    for key, x in sd.items():
        if ep_size > 1 and is_expert(key):
            if x.shape[0] % ep_size:
                raise ValueError(f"{key} {tuple(x.shape)}: {x.shape[0]} "
                                 f"experts do not shard over ep {ep_size}")
            x = x.chunk(ep_size, 0)[ep_rank]
        dim = tp_dim(key)
        if dim is not None and tp_size > 1:
            if x.shape[dim] % tp_size:
                raise ValueError(f"{key} {tuple(x.shape)}: dim {dim} does "
                                 f"not shard over tp {tp_size}")
            x = x.chunk(tp_size, dim)[tp_rank]
        out[key] = x.contiguous()
    return out


def assemble_params(shards: List[Tensors], ep_size: int = 1) -> Tensors:
    """Every rank's shard, ep major and tp minor (rank ep_rank * tp +
    tp_rank, the mesh's order) -> the global state dict (vocab leaves still
    padded to the shards' multiple of tp). The leaves replicated over ep
    are taken from ep rank 0's shards."""
    tp = len(shards) // ep_size

    def over_tp(group: List[Tensors]) -> Tensors:
        if len(group) == 1:
            return group[0]
        return {key: (x if tp_dim(key) is None
                      else torch.cat([s[key] for s in group], tp_dim(key)))
                for key, x in group[0].items()}

    by_ep = [over_tp(shards[e * tp:(e + 1) * tp]) for e in range(ep_size)]
    if ep_size == 1:
        return by_ep[0]
    return {key: (torch.cat([s[key] for s in by_ep]) if is_expert(key)
                  else x) for key, x in by_ep[0].items()}
