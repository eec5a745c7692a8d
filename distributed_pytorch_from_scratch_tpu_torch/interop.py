"""Weight exchange with the JAX package.

`params_from_jax` maps a JAX llama param tree (as numpy arrays: the tree
`Transformer.init` returns, or a checkpoint's params) onto the port's
`Transformer.state_dict()`, whole or one tp rank's shard of it;
`params_to_jax` is its inverse, and `shards_to_jax` assembles every tp
rank's shard into the global tree. The JAX tree stacks every per-layer
leaf on a leading num_layers axis and keeps linear weights as (idim,
odim); the port has one module per layer and torch's (odim, idim) layout,
so layers are unstacked and linear weights transposed. This is what lets
the tests feed both packages the same weights. `adam_state_from_jax`/
`adam_state_to_jax` carry the Adam moments the same way: they are trees of
the param layout.

Each leaf shards over tp on the dim its JAX spec (`Transformer.specs()`)
marks as 'tp', seen in torch's layout (`parallel.layout`, which also pads
a vocab that does not divide by tp with zero rows and columns, as the JAX
init pads its table and head).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .parallel.layout import Tensors, assemble_params, shard_params
from .training.optim import AdamState

# per-layer modules whose "weight" is a linear (idim, odim) matrix in JAX
_LINEARS = ("wq", "wk", "wv", "wo", "gate_proj", "up_proj", "down_proj")


def params_from_jax(tree: Dict[str, Any], tp_size: int = 1,
                    tp_rank: int = 0) -> Tensors:
    """JAX param tree (nested dicts of numpy arrays) -> torch state_dict:
    the whole of it at tp_size 1, else rank tp_rank's shard."""
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    sd = {"embedding.weight": t(tree["embedding"]["weight"]),
          "norm.scale": t(tree["norm"]["scale"]),
          "lm_head.weight": t(tree["lm_head"]["weight"]).T.contiguous(),
          "lm_head.bias": t(tree["lm_head"]["bias"])}
    layers = tree["layers"]
    num_layers = np.shape(layers["wq"]["weight"])[0]
    for i in range(num_layers):
        for name, leaves in layers.items():
            for leaf, arr in leaves.items():
                val = t(np.asarray(arr)[i])
                if name in _LINEARS and leaf == "weight":
                    val = val.T.contiguous()
                sd[f"layers.{i}.{name}.{leaf}"] = val
    return shard_params(sd, tp_size, tp_rank)


def params_to_jax(state_dict: Tensors) -> Dict[str, Any]:
    """Inverse of `params_from_jax` at tp 1: torch state_dict -> JAX param
    tree of numpy float32 arrays, layers stacked on a leading axis. Given
    one tp rank's shard, it gives that rank's slice of every JAX leaf (the
    leaves of a JAX shard file)."""
    n = lambda x: x.detach().cpu().float().numpy()
    tree: Dict[str, Any] = {
        "embedding": {"weight": n(state_dict["embedding.weight"])},
        "norm": {"scale": n(state_dict["norm.scale"])},
        "lm_head": {"weight": n(state_dict["lm_head.weight"]).T.copy(),
                    "bias": n(state_dict["lm_head.bias"])},
    }
    per_layer: Dict[str, Dict[str, Dict[int, np.ndarray]]] = {}
    for key, val in state_dict.items():
        if not key.startswith("layers."):
            continue
        _, i, name, leaf = key.split(".")
        arr = n(val)
        if name in _LINEARS and leaf == "weight":
            arr = arr.T.copy()
        per_layer.setdefault(name, {}).setdefault(leaf, {})[int(i)] = arr
    tree["layers"] = {
        name: {leaf: np.stack([by_i[i] for i in sorted(by_i)])
               for leaf, by_i in leaves.items()}
        for name, leaves in per_layer.items()}
    return tree


def shards_to_jax(shards: List[Tensors]) -> Dict[str, Any]:
    """Every tp rank's shard, in rank order -> the global JAX param tree."""
    return params_to_jax(assemble_params(shards))


def adam_state_from_jax(state: Any) -> AdamState:
    """A JAX `AdamState` (anything with `step`, `mu`, `nu`; trees of numpy
    arrays) -> the port's AdamState."""
    return AdamState(step=int(np.asarray(state.step)),
                     mu=params_from_jax(state.mu),
                     nu=params_from_jax(state.nu))


def adam_state_to_jax(state: AdamState) -> Dict[str, Any]:
    """The port's AdamState -> {"step", "mu", "nu"} in the JAX layout
    (`AdamState(**adam_state_to_jax(s))` on the JAX side)."""
    return {"step": np.asarray(state.step, np.int32),
            "mu": params_to_jax(state.mu), "nu": params_to_jax(state.nu)}
