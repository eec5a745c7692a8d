"""Causal flash-attention forward: the CUDA kernel `csrc/flash_fwd.cu` and
its plain PyTorch version.

Counterpart of the JAX TPU kernel `_fwd_kernel` (via `_fwd_call`) in
`distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py`.
`flash_attention_fwd(q, k, v, t_real)` returns `(o, lse)`:

* q (b, h, t, d); k, v (b, hkv, t, d) with hkv dividing h (grouped-query
  attention is routed inside the kernel, K/V are never repeated);
* o (b, h, t, d) in q's dtype; lse (b, h, t) float32, the row logsumexp;
* rows >= t_real are padding: exact-zero output, lse = -1e30.

On a CUDA tensor the wrapper launches the kernel (built on first use) or
raises; on a CPU tensor it computes `flash_attention_fwd_plain`, the same
math step by step. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

MASK = -1e30  # hard mask, as the TPU kernel's
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

# flash_fwd(q, k, v, o, lse, b, hq, hkv, t, t_real, head_dim, is_bf16,
#           scale, stream)
_C_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
           + [ctypes.c_float, ctypes.c_void_p])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           t_real: Optional[int]) -> int:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (b, heads, t, head_dim), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, t, d = q.shape
    hkv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (t, d):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {hkv}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if t_real is None:
        return t
    if not 1 <= t_real <= t:
        raise ValueError(f"t_real {t_real} must be in [1, t={t}]")
    return t_real


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, t_real: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in step-by-step torch, over one tile that spans
    every key: f32 scores from the input-dtype values, the -1e30 mask with
    the MASK/2 clamp, p rounded to v's dtype before p @ v, l == 0 -> 1."""
    t_real = _check(q, k, v, t_real)
    b, h, t, d = q.shape
    group = h // k.shape[1]
    qf = q.float()
    kf = torch.repeat_interleave(k, group, dim=1).float()
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    row = torch.arange(t, device=q.device)[:, None]
    col = torch.arange(t, device=q.device)[None, :]
    dead = (col > row) | (col >= t_real) | (row >= t_real)
    s = s.masked_fill(dead, MASK)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=MASK / 2)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vv.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (acc / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe))[..., 0]
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        t_real: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention; see the module docstring."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, t_real)
    t_real = _check(q, k, v, t_real)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built; the kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not built; the kernel takes {DTYPES}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if b * h > 65535:
        raise ValueError(f"b*heads {b * h} exceeds the grid's y limit 65535")
    from .build import load
    lib = load("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, k.shape[1], t, t_real, d,
                 int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0  # kernel launches (not plain-version calls)
