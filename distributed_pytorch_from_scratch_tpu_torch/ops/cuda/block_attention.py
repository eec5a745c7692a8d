"""Positional block attention, the building block of ring attention: the
CUDA kernels (forward; backward dq and dk/dv), their plain PyTorch versions,
and `BlockAttention`, the autograd Function that joins them.

Counterparts of the JAX TPU kernels `_pos_fwd_kernel`, `_pos_dq_kernel` and
`_pos_dkv_kernel` behind `block_attention` in
`distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py`.
`block_attention(q, k, v, q_pos, kv_pos)` returns `(o, lse)` for ONE
(Q-chunk, KV-chunk) pair, differentiable in q, k, v through both outputs
(`BlockAttention`; `block_attention_fwd` is the forward alone):

* q (b, h, tq, d); k, v (b, hkv, tk, d) with hkv dividing h (grouped-query
  heads are routed inside the kernels, K/V are never repeated);
* q_pos (b, tq), kv_pos (b, tk) integer global positions: a query sees
  every key with kv_pos <= q_pos;
* o (b, h, tq, d) in q's dtype, normalized within the block; lse (b, h, tq)
  float32, the row logsumexp, -1e30 on rows that see no key here (their o
  is exactly 0).

The backward takes both cotangents, `do` and `dlse`: the ring combines
blocks through (o, lse), so lse carries a gradient (d lse / d s = p enters
ds as p * dlse). `block_attention_bwd(q, k, v, q_pos, kv_pos, o, lse, do,
dlse)` returns (dq, dk, dv) in the dtypes of q, k, v.

On a CUDA tensor each wrapper launches its kernel(s) (built on first use) or
raises; on a CPU tensor it computes the plain version, the same math step by
step. There is no fallback from one to the other. The dtype picks the
kernels, by dispatch, not fallback (`kernel_route`):

* bfloat16 (the cp model's path): `csrc/block_attn_sm90.cu`, wgmma kernels
  fed by TMA through an mbarrier ring, with a per-tile skip by position;
* float32: `csrc/block_attn.cu`, SIMT kernels with f32 FMAs.

The launch counters count either route.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from .flash_attention import _c_function, _delta

MASK = -1e30  # hard mask and dead-row lse, as the TPU kernels'
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
# block_attn_fwd[_sm90](q, k, v, q_pos, kv_pos, o, lse, b, hq, hkv, tq, tk,
#                       head_dim, scale, stream)
_C_FWD = [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P]
# block_attn_dq[_sm90](q, k, v, q_pos, kv_pos, do, lse, delta, dlse, dq,
#                      <sizes>); block_attn_dkv[_sm90] has dk, dv for dq
_C_DQ = [_P] * 10 + [_I] * 6 + [ctypes.c_float, _P]
_C_DKV = [_P] * 11 + [_I] * 6 + [ctypes.c_float, _P]
# dtype -> (source, C-name suffix) of all three kernels
_ROUTE = {torch.float32: ("block_attn", ""),
          torch.bfloat16: ("block_attn_sm90", "_sm90")}


def kernel_route(dtype: torch.dtype, head_dim: int) -> Tuple[str, str]:
    """(source under `csrc/`, C-name suffix) of the kernels that take this
    dtype and head_dim; raises on what is not built."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not built; the kernels take "
                         f"{HEAD_DIMS}")
    if dtype not in _ROUTE:
        raise ValueError(f"dtype {dtype} not built; the kernels take "
                         f"{DTYPES}")
    return _ROUTE[dtype]


def _check(q, k, v, q_pos, kv_pos) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (b, heads, t, head_dim), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {hkv}")
    if q_pos.shape != (b, tq) or kv_pos.shape != (b, tk):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / kv_pos "
                         f"{tuple(kv_pos.shape)} must be (b, tq) = {(b, tq)} "
                         f"/ (b, tk) = {(b, tk)}")
    if q_pos.is_floating_point() or kv_pos.is_floating_point():
        raise ValueError("positions must be integers")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if any(x.device != q.device for x in (k, v, q_pos, kv_pos)):
        raise ValueError("q, k, v and the positions must lie on one device")


def _check_kernel_inputs(q: torch.Tensor, *others: torch.Tensor
                         ) -> Tuple[str, str]:
    """What the CUDA kernels take; raises on anything else. Returns the
    route (`kernel_route`)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, _, d = q.shape
    route = kernel_route(q.dtype, d)
    if not all(x.is_contiguous() for x in (q, *others)):
        raise ValueError("kernel inputs must be contiguous")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (q, *others)):
        raise ValueError("bf16 kernel inputs must be 16-byte aligned (TMA)")
    if b * h > 65535:
        raise ValueError(f"b*heads {b * h} exceeds the grid's y limit 65535")
    return route


def _positions(q_pos, kv_pos):
    """int32, contiguous: what the kernels read (no copy when already so)."""
    return (q_pos.to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous())


def _live(q_pos, kv_pos) -> torch.Tensor:
    """(b, 1, tq, tk): query row sees key column."""
    return q_pos[:, None, :, None] >= kv_pos[:, None, None, :]


def block_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, kv_pos: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's math in step-by-step torch, over one tile that
    spans every key — at f32 the JAX `_block_attn_xla`: f32 scores from the
    input-dtype values, the -1e30 mask by position with the MASK/2 clamp, p
    hard-zeroed where not live and rounded to v's dtype before p @ v,
    l == 0 -> o = 0 and lse = -1e30."""
    _check(q, k, v, q_pos, kv_pos)
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    kf = torch.repeat_interleave(k, group, dim=1).float()
    vv = torch.repeat_interleave(v, group, dim=1)
    live = _live(q_pos, kv_pos)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    s = s.masked_fill(~live, MASK)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - torch.clamp(m, min=MASK / 2)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vv.float())
    dead = l == 0.0
    l_safe = torch.where(dead, torch.ones_like(l), l)
    o = (acc / l_safe).to(q.dtype)
    lse = torch.where(dead, MASK, m + torch.log(l_safe))[..., 0]
    return o, lse


def prepare_fwd(q, k, v, q_pos, kv_pos) -> tuple:
    """Checked kernel arguments of the forward on the card, positions int32.
    Returns the `_launch_fwd` args (the route, then pointers and sizes) and
    the tensors they point into (keep them alive while launching)."""
    _check(q, k, v, q_pos, kv_pos)
    q_pos, kv_pos = _positions(q_pos, kv_pos)
    route = _check_kernel_inputs(q, k, v)
    b, h, tq, d = q.shape
    args = (route,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr()),
            (b, h, k.shape[1], tq, k.shape[2], d, 1.0 / math.sqrt(d)))
    return args, (q_pos, kv_pos)


def _launch_fwd(args: tuple, o: torch.Tensor, lse: torch.Tensor,
                stream: int) -> None:
    """One launch of the forward kernel of the args' route into `o` (q's
    shape and dtype) and `lse` ((b, h, tq) float32); not counted (the
    wrapper counts its own)."""
    (source, suffix), ptrs, sizes = args
    fn = _c_function(source, f"block_attn_fwd{suffix}", _C_FWD)
    err = fn(*ptrs, o.data_ptr(), lse.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"block_attn_fwd{suffix} launch failed: CUDA "
                           f"error {err}")


def block_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, kv_pos: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of one position-masked block; see the module docstring. On
    a CUDA tensor: one launch of the dtype's forward kernel."""
    if q.device.type == "cpu":
        return block_attention_plain(q, k, v, q_pos, kv_pos)
    args, _keep = prepare_fwd(q, k, v, q_pos, kv_pos)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch_fwd(args, o, lse,
                    torch.cuda.current_stream(q.device).cuda_stream)
    block_attention_fwd.launches += 1
    return o, lse


block_attention_fwd.launches = 0  # kernel launches (not plain-version calls)


def _check_bwd(q, k, v, q_pos, kv_pos, o, lse, do, dlse) -> None:
    _check(q, k, v, q_pos, kv_pos)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    for name, x in (("lse", lse), ("dlse", dlse)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])}, "
                             f"got {x.dtype} {tuple(x.shape)}")
    if not (o.dtype == do.dtype == q.dtype):
        raise ValueError(f"o, do dtypes {o.dtype}, {do.dtype} differ from "
                         f"q's {q.dtype}")
    if any(x.device != q.device for x in (o, lse, do, dlse)):
        raise ValueError("every input must lie on q's device")


def block_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_pos: torch.Tensor,
                              kv_pos: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              dlse: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' math in step-by-step torch (the explicit
    formulas of the TPU custom VJP, not autograd), over one tile that spans
    every key: p = exp(s - lse) where live and 0 elsewhere (never
    exp(MASK - MASK) = 1 on a dead row), delta = rowsum(f32(do) * f32(o)),
    ds = p (dp - delta + dlse) scale rounded to q's dtype, p rounded to do's
    dtype before p^T do; dk, dv summed over each kv head's group of query
    heads, f32 sums cast once."""
    _check_bwd(q, k, v, q_pos, kv_pos, o, lse, do, dlse)
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    kf = torch.repeat_interleave(k, group, dim=1).float()
    vf = torch.repeat_interleave(v, group, dim=1).float()
    dof = do.float()
    live = _live(q_pos, kv_pos)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s.masked_fill(~live, MASK)
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - _delta(o, do)[..., None] + dlse[..., None]) * scale)
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    per_kv = lambda x: x.reshape(b, hkv, group, tk, d).sum(dim=2)
    return dq.to(q.dtype), per_kv(dk).to(k.dtype), per_kv(dv).to(v.dtype)


def rounding_slack(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   dlse: torch.Tensor) -> dict:
    """How far rounding p and ds to a bf16 operand can move each element of
    o, dq, dk and dv between two right implementations (the kernels and the
    plain versions), given the plain forward's (o, lse); f32 tensors shaped
    like each output. A bf16 rounding errs by at most 2^-8 of the value, so
    two roundings of one term differ by at most 2^-7 of it:

    * o: the kernel rounds each p against its running row max, the plain
      version against the final one, so every term p_j v_j may differ:
      2^-7 sum_j p_j |v_j|, p normalized;
    * dq, dk, dv: p and ds are the same f32 formula on both sides, but
      their last bits differ (sum order), so a value on a rounding edge may
      round either way: 2^-7 |ds| @ |k|, |ds|^T @ |q|, |p|^T @ |do|, summed
      over each kv head's group.

    The output's own rounding (one bf16 step) comes on top. For the bf16
    comparison of the kernels with their plain versions; not used on the
    model's path."""
    _check_bwd(q, k, v, q_pos, kv_pos, o, lse, do, dlse)
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = h // hkv
    rep = lambda x: torch.repeat_interleave(x, group, dim=1).float()
    qf, kf, vf, dof = q.float(), rep(k), rep(v), do.float()
    live = _live(q_pos, kv_pos)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    p = torch.where(live, torch.exp(s.masked_fill(~live, MASK)
                                    - lse[..., None]), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - _delta(o, do)[..., None] + dlse[..., None])
          / math.sqrt(d)).abs()
    per_kv = lambda x: x.reshape(b, hkv, group, tk, d).sum(dim=2)
    edge = 2.0 ** -7
    return {"o": edge * torch.matmul(p, vf.abs()),
            "dq": edge * torch.matmul(ds, kf.abs()),
            "dk": edge * per_kv(torch.matmul(ds.transpose(-1, -2), qf.abs())),
            "dv": edge * per_kv(torch.matmul(p.transpose(-1, -2), dof.abs()))}


def _bwd_args(route, q, k, v, q_pos, kv_pos, lse, delta, do, dlse) -> tuple:
    """The route, then the inputs and sizes both backward C functions take,
    in their order (inputs checked by the caller; the tensors must outlive
    the launch)."""
    b, h, tq, d = q.shape
    return (route,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dlse.data_ptr()),
            (b, h, k.shape[1], tq, k.shape[2], d, 1.0 / math.sqrt(d)))


def _launch_dq(args: tuple, dq: torch.Tensor, stream: int) -> None:
    """One launch of the dq kernel of the args' route into `dq`; not
    counted (the wrapper counts its own)."""
    (source, suffix), ptrs, sizes = args
    fn = _c_function(source, f"block_attn_dq{suffix}", _C_DQ)
    err = fn(*ptrs, dq.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"block_attn_dq{suffix} launch failed: CUDA "
                           f"error {err}")


def _launch_dkv(args: tuple, dk: torch.Tensor, dv: torch.Tensor,
                stream: int) -> None:
    """One launch of the dk/dv kernel of the args' route into `dk`, `dv`;
    not counted."""
    (source, suffix), ptrs, sizes = args
    fn = _c_function(source, f"block_attn_dkv{suffix}", _C_DKV)
    err = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"block_attn_dkv{suffix} launch failed: CUDA "
                           f"error {err}")


def prepare_bwd(q, k, v, q_pos, kv_pos, o, lse, do, dlse) -> tuple:
    """Checked kernel arguments of the backward pair on the card: delta
    computed, positions int32, dlse float32 contiguous. Returns the
    `_launch_dq`/`_launch_dkv` args and the tensors they point into (keep
    them alive while launching)."""
    _check_bwd(q, k, v, q_pos, kv_pos, o, lse, do, dlse)
    q_pos, kv_pos = _positions(q_pos, kv_pos)
    dlse = dlse.contiguous()
    route = _check_kernel_inputs(q, k, v, o, lse, do, dlse)
    delta = _delta(o, do)
    keep = (q_pos, kv_pos, delta, dlse)
    return (_bwd_args(route, q, k, v, q_pos, kv_pos, lse, delta, do, dlse),
            keep)


def block_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, kv_pos: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        dlse: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of one block given the forward's (o, lse) and both
    cotangents; see the module docstring. On a CUDA tensor: one launch of
    the dtype's dq kernel and one of its dk/dv kernel."""
    if q.device.type == "cpu":
        return block_attention_bwd_plain(q, k, v, q_pos, kv_pos, o, lse, do,
                                         dlse)
    args, _keep = prepare_bwd(q, k, v, q_pos, kv_pos, o, lse, do, dlse)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch_dq(args, dq, stream)
        block_attention_bwd.launches_dq += 1
        _launch_dkv(args, dk, dv, stream)
        block_attention_bwd.launches_dkv += 1
    return dq, dk, dv


# kernel launches (not plain-version calls)
block_attention_bwd.launches_dq = 0
block_attention_bwd.launches_dkv = 0


class BlockAttention(torch.autograd.Function):
    """(o, lse) = block_attention_fwd(q, k, v, q_pos, kv_pos): the forward
    kernel, saving (q, k, v, q_pos, kv_pos, o, lse); the backward kernels
    for (dq, dk, dv) from BOTH cotangents (do, dlse) — torch hands in zeros
    for an output the caller did not use. On CPU tensors both sides are the
    plain versions. The positions get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos):
        o, lse = block_attention_fwd(q, k, v, q_pos, kv_pos)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, o, lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, q_pos, kv_pos, o, lse = ctx.saved_tensors
        dq, dk, dv = block_attention_bwd(q, k, v, q_pos, kv_pos, o, lse,
                                         do.contiguous(), dlse.contiguous())
        return dq, dk, dv, None, None


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX `block_attention`: (o, lse) of one block, differentiable in
    q, k, v through both outputs."""
    return BlockAttention.apply(q, k, v, q_pos, kv_pos)
