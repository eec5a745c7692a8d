"""Symmetric int8 quantization: the port's copy of the JAX `ops/quant.py`
row rule (`QMAX`, `_safe_scale`, `quantize_rows`, `dequantize_rows`), used
by the int8 KV pages, of its wire rule (`WIRE_GROUP`, `quantize_groups`,
`dequantize_groups`), used by the int8 dp gradient wire
(`ops/overlap.py`), and of its decode-weight rule (`quantize_weight`,
`dequantize_weight`, `quantize_decode_params`,
`dequantize_decode_params`), used by the engines' int8 decode weights.

    scale = max(|x|) / 127   per block (all-zero blocks take scale 1)
    q     = round(x / scale) in [-127, 127]   (int8; -128 never produced)
    x~    = q * scale

The arithmetic is f32 in the same order as the JAX version, and
`torch.round` rounds half to even like `jnp.round`, so both packages give
the same codes and scales byte for byte.

Decode weights take one scale per output channel, over the JAX leaf's
axis -2, of every JAX leaf with two dims or more. The JAX tree stacks each
per-layer leaf on a leading num_layers axis and keeps linear weights as
(idim, odim), so in the port's (odim, idim) modules: a linear weight (and
the llama head) reduces over torch dim -1, the token and position tables
over dim -2 (vocab, position), and a per-layer bias or norm gain, 1-D here
but (num_layers, d) in JAX, over the LAYERS: one scale per column shared
by every layer. A MoE layer's leaves keep the JAX layout with the
layers' axis dropped, so their axis -2 is torch dim -2 too: the router (d,
E) and the experts' `gate`/`up` (E, d, f) reduce over d, `down` (E, f, d)
over f, whose tp shards take the all-reduce MAX as a row weight's do. Only
the top-level 1-D leaves (the final norm, the head's bias) stay f32.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..parallel.layout import tp_dim
from ..reshard.layout import transposed

# int8 code range: symmetric +-127 (never -128, so negation round-trips)
QMAX = 127.0


def _safe_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax -> f32 scale; all-zero rows take 1.0 (q = 0 exactly). The
    divisor is a tensor: on a card PyTorch divides by a Python float as a
    product with its reciprocal, which can differ from the quotient in the
    last bit, and the codes would then differ from the CPU's and JAX's."""
    return torch.where(amax > 0, amax / torch.full_like(amax, QMAX),
                       torch.ones_like(amax)).to(torch.float32)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) -> (codes int8 (..., d), scales f32 (...,)): one scale per
    row of the last dim (per head-vector for KV pages)."""
    xf = x.to(torch.float32)
    scale = _safe_scale(xf.abs().amax(dim=-1))
    q = torch.clamp(torch.round(xf / scale[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `quantize_rows`."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


# elements per scale on the int8 dp gradient wire: one outlier spoils at
# most 512 elements, and the f32 scales add 4/512 < 1% to the codes
WIRE_GROUP = 512


def quantize_groups(x: torch.Tensor, group: int = WIRE_GROUP
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat 1-D x -> (codes int8 (n,), scales f32 (ceil(n / group),)): one
    scale per `group` consecutive elements, the last group zero-padded
    (the caller keeps n)."""
    n = x.shape[0]
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, (-n) % group))
    q, scale = quantize_rows(xp.reshape(-1, group))
    return q.reshape(-1)[:n], scale


def dequantize_groups(q: torch.Tensor, scale: torch.Tensor, n: int,
                      group: int = WIRE_GROUP,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of `quantize_groups` (n: the original length)."""
    qp = torch.nn.functional.pad(q, (0, (-q.shape[0]) % group))
    return dequantize_rows(qp.reshape(-1, group), scale, dtype).reshape(-1)[:n]


# ------------------------------------------------- decode-weight quant --

def quantize_weight(w: torch.Tensor, dim: int) -> Dict[str, torch.Tensor]:
    """One int8 code per element and one f32 scale per slice across `dim`
    (the JAX `quantize_weight`'s axis -2, in the port's layout): {"qweight":
    int8 of w's shape, "scale": f32 with `dim` of size 1}."""
    wf = w.to(torch.float32)
    return _quantize(wf, wf.abs().amax(dim=dim, keepdim=True))


def _quantize(wf: torch.Tensor, amax: torch.Tensor) -> Dict[str, torch.Tensor]:
    scale = _safe_scale(amax)
    q = torch.clamp(torch.round(wf / scale), -QMAX, QMAX)
    return {"qweight": q.to(torch.int8), "scale": scale}


def dequantize_weight(leaf: Dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(codes as f32 * scale) cast to `dtype`: the JAX order."""
    return (leaf["qweight"].to(torch.float32) * leaf["scale"]).to(dtype)


def _reduce_dim(key: str, ndim: int) -> int:
    """The torch dim of leaf `key` (of two dims or more) that the JAX axis
    -2 is."""
    return ndim - 1 if transposed(key) else ndim - 2


def quantize_decode_params(state_dict: Dict[str, torch.Tensor],
                           mesh=None) -> Dict[str, Any]:
    """The JAX `quantize_decode_params` on a port state dict: every leaf
    whose JAX leaf has two dims or more becomes {"qweight", "scale"} (a
    per-layer 1-D leaf's scale is the (d,) row its layers share), every
    other leaf passes through untouched.

    Given this tp rank's shard and its `mesh`, the result is this rank's
    shard of the JAX function's output on the assembled tree: the codes and
    scales JAX computes globally and then shards (codes like the weight,
    scales like the weight without its contraction dim). Where the
    contraction dim is the tp-sharded one (row weights, the token table),
    the scale's amax is the MAX of the ranks' local ones (one all-reduce
    over tp), which is the assembled tree's amax exactly."""
    from .collectives import all_max
    out: Dict[str, Any] = {}
    shared: Dict[str, list] = {}     # per-layer 1-D leaves, by module/leaf
    for key, w in state_dict.items():
        if w.ndim >= 2:
            dim = _reduce_dim(key, w.ndim)
            wf = w.detach().to(torch.float32)
            amax = wf.abs().amax(dim=dim, keepdim=True)
            if mesh is not None and mesh.tp > 1 and tp_dim(key) == dim:
                amax = all_max(amax, mesh)
            out[key] = _quantize(wf, amax)
        elif key.startswith("layers."):
            shared.setdefault(key.split(".", 2)[2], []).append(key)
        else:
            out[key] = w
    for keys in shared.values():
        # the JAX leaf is (num_layers, d): its scale runs over the layers
        q = quantize_weight(torch.stack([state_dict[k].detach()
                                         for k in keys]), 0)
        for i, key in enumerate(keys):
            out[key] = {"qweight": q["qweight"][i].clone(),
                        "scale": q["scale"][0].clone()}
    return {k: out[k] for k in state_dict}


def dequantize_decode_params(qparams: Dict[str, Any],
                             dtype: torch.dtype = torch.float32
                             ) -> Dict[str, torch.Tensor]:
    """The inverse: {"qweight", "scale"} leaves -> dense weights at
    `dtype`, the rest as they are."""
    return {k: dequantize_weight(v, dtype) if isinstance(v, dict) else v
            for k, v in qparams.items()}
