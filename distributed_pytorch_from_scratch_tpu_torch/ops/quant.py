"""Symmetric int8 quantization over the last dim: the port's copy of the
row rule of the JAX `ops/quant.py` (`QMAX`, `_safe_scale`,
`quantize_rows`, `dequantize_rows`), used by the int8 KV pages.

    scale = max(|x|) / 127   per row (all-zero rows take scale 1)
    q     = round(x / scale) in [-127, 127]   (int8; -128 never produced)
    x~    = q * scale

The arithmetic is f32 in the same order as the JAX version, and
`torch.round` rounds half to even like `jnp.round`, so both packages give
the same codes and scales byte for byte.
"""

from __future__ import annotations

from typing import Tuple

import torch

# int8 code range: symmetric +-127 (never -128, so negation round-trips)
QMAX = 127.0


def _safe_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax -> f32 scale; all-zero rows take 1.0 (q = 0 exactly)."""
    return torch.where(amax > 0, amax / QMAX,
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
