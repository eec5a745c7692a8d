"""Causal flash attention: the CUDA kernels (forward; backward as dq and
dk/dv), their plain PyTorch versions, and `flash_attention`, the
dispatcher op with a gradient that joins them.

Counterparts of the JAX TPU kernels in
`distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py`:
`_fwd_kernel` (via `_fwd_call`) and the backward launches of `_bwd_call`.
`flash_attention_fwd(q, k, v, t_real)` returns `(o, lse)`:

* q (b, h, t, d); k, v (b, hkv, t, d) with hkv dividing h (grouped-query
  attention is routed inside the kernels, K/V are never repeated);
* o (b, h, t, d) in q's dtype; lse (b, h, t) float32, the row logsumexp;
* rows >= t_real are padding: exact-zero output, lse = -1e30.

`flash_attention_bwd(q, k, v, o, lse, do, t_real)` returns `(dq, dk, dv)`
in the dtypes of q, k, v; pad rows and pad keys get exact-zero gradients.

On a CUDA tensor each wrapper launches its kernel(s) (built on first use)
or raises; on a CPU tensor it computes the plain version, the same math
step by step. There is no fallback from one to the other. The dtype picks
the kernels, by dispatch, not fallback:

* bfloat16 (every path of the model: training, the slot engine's prefill,
  Ulysses): `csrc/flash_fwd_sm90.cu` and `csrc/flash_bwd_sm90.cu`, wgmma
  kernels fed by TMA through an mbarrier ring;
* float32: `csrc/flash_fwd.cu` and `csrc/flash_bwd.cu`, SIMT kernels with
  f32 FMAs (tensor cores would mean TF32, which changes the numbers).

The launch counters count either route.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

MASK = -1e30  # hard mask, as the TPU kernel's
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

# flash_fwd[_sm90](q, k, v, o, lse, b, hq, hkv, t, t_real, head_dim, scale,
#                 stream)
_C_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
           + [ctypes.c_float, ctypes.c_void_p])
# flash_bwd_dq[_sm90](q, k, v, do, lse, delta, dq, b, hq, hkv, t, t_real,
#                     head_dim, scale, stream); _dkv has dk, dv for dq
_C_ARGS_DQ = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
              + [ctypes.c_float, ctypes.c_void_p])
_C_ARGS_DKV = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
               + [ctypes.c_float, ctypes.c_void_p])
# dtype -> (source, C-name suffix) of the forward and of the backward pair
_FWD_ROUTE = {torch.float32: ("flash_fwd", ""),
              torch.bfloat16: ("flash_fwd_sm90", "_sm90")}
_BWD_ROUTE = {torch.float32: ("flash_bwd", ""),
              torch.bfloat16: ("flash_bwd_sm90", "_sm90")}


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


def _check_kernel_inputs(q: torch.Tensor, *others: torch.Tensor) -> None:
    """What the CUDA kernels take; raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built; the kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not built; the kernel takes {DTYPES}")
    if not all(x.is_contiguous() for x in (q, *others)):
        raise ValueError("kernel inputs must be contiguous")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (q, *others)):
        raise ValueError("bf16 kernel inputs must be 16-byte aligned (TMA)")
    if b * h > 65535:
        raise ValueError(f"b*heads {b * h} exceeds the grid's y limit 65535")


def _c_function(source: str, name: str, argtypes):
    """The C entry point `name` of `csrc/{source}.cu`, built if needed."""
    from .build import load
    fn = getattr(load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


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


def _launch_fwd(q, k, v, o, lse, t_real: int, stream: int) -> None:
    """One launch of the forward kernel of q's dtype into `o`, `lse` (inputs
    checked by the caller); not counted (the wrapper counts its own)."""
    b, h, t, d = q.shape
    source, suffix = _FWD_ROUTE[q.dtype]
    fn = _c_function(source, f"flash_fwd{suffix}", _C_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, h, k.shape[1], t, t_real, d,
             1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd{suffix} launch failed: CUDA error "
                           f"{err}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        t_real: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention; see the module docstring."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, t_real)
    t_real = _check(q, k, v, t_real)
    _check_kernel_inputs(q, k, v)
    b, h, t, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch_fwd(q, k, v, o, lse, t_real,
                    torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0  # kernel launches (not plain-version calls)


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(f32(do) * f32(o)), (b, h, t) — plain torch on every device,
    as JAX computes it in XLA outside the kernels."""
    return (do.float() * o.float()).sum(dim=-1)


def _check_bwd(q, k, v, o, lse, do, t_real) -> int:
    t_real = _check(q, k, v, t_real)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not (o.dtype == do.dtype == q.dtype):
        raise ValueError(f"o, do dtypes {o.dtype}, {do.dtype} differ from "
                         f"q's {q.dtype}")
    if not (o.device == do.device == lse.device == q.device):
        raise ValueError("q, k, v, o, lse, do must lie on one device")
    return t_real


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              t_real: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' math in step-by-step torch, over one tile that
    spans every key: f32 scores from the input-dtype values, dead entries
    hard-zeroed, p rounded to do's dtype before p^T do, ds rounded to q's
    dtype before ds k and ds^T q, f32 sums cast once; dk, dv summed over
    each kv head's group of query heads."""
    t_real = _check_bwd(q, k, v, o, lse, do, t_real)
    b, h, t, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    kf = torch.repeat_interleave(k, group, dim=1).float()
    vf = torch.repeat_interleave(v, group, dim=1).float()
    dof = do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    row = torch.arange(t, device=q.device)[:, None]
    col = torch.arange(t, device=q.device)[None, :]
    live = (col <= row) & (col < t_real) & (row < t_real)
    s = s.masked_fill(~live, MASK)
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - _delta(o, do)[..., None]) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    per_kv = lambda x: x.reshape(b, hkv, group, t, d).sum(dim=2)
    return (dq.to(q.dtype), per_kv(dk).to(k.dtype), per_kv(dv).to(v.dtype))


def rounding_slack(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   t_real: Optional[int] = None) -> dict:
    """How far rounding p and ds to a bf16 operand can move each element of
    o, dq, dk and dv between two right implementations (the kernels and the
    plain versions), given the plain forward's (o, lse); f32 tensors shaped
    like each output. A bf16 rounding errs by at most 2^-8 of the value, so
    two roundings of one term differ by at most 2^-7 of it:

    * o: the kernel rounds each p against its running row max (one max per
      64-key tile), the plain version against the final one, so every term
      p_j v_j may differ: 2^-7 sum_j p_j |v_j|, p normalized;
    * dq, dk, dv: p and ds are the same f32 formula on both sides, but
      their last bits differ (sum order), so a value on a rounding edge may
      round either way: 2^-7 |ds| @ |k|, |ds|^T @ |q|, |p|^T @ |do|, summed
      over each kv head's group;
    * dq, dk: ds = p (dp - delta) scale, and dp = do v^T is a sum of d
      products that the two sides add in other orders (the tensor cores'
      f32 accumulation does not round to nearest): up to d 2^-22 sum |do||v|
      apart. Where dp - delta cancels (a row that sees one key has o = v,
      so dp = delta) that difference is all of ds: p d 2^-22 (|do| @ |v|^T)
      scale joins |ds| above, without the 2^-7.

    The output's own rounding (one bf16 step) comes on top. f32 inputs
    round nothing to bf16, so their slack is the sum-order term alone (o,
    dv: 0). For the comparison of the kernels with their plain versions;
    not used on the model's path."""
    t_real = _check_bwd(q, k, v, o, lse, do, t_real)
    b, h, t, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    rep = lambda x: torch.repeat_interleave(x, group, dim=1).float()
    qf, kf, vf, dof = q.float(), rep(k), rep(v), do.float()
    row = torch.arange(t, device=q.device)[:, None]
    col = torch.arange(t, device=q.device)[None, :]
    live = (col <= row) & (col < t_real) & (row < t_real)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    p = torch.where(live, torch.exp(s.masked_fill(~live, MASK)
                                    - lse[..., None]), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - _delta(o, do)[..., None]) / math.sqrt(d)).abs()
    dp_order = d * 2.0 ** -22 * torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
    per_kv = lambda x: x.reshape(b, hkv, group, t, d).sum(dim=2)
    edge = 2.0 ** -7 if q.dtype == torch.bfloat16 else 0.0
    ds = edge * ds + p * dp_order / math.sqrt(d)
    return {"o": edge * torch.matmul(p, vf.abs()),
            "dq": torch.matmul(ds, kf.abs()),
            "dk": per_kv(torch.matmul(ds.transpose(-1, -2), qf.abs())),
            "dv": edge * per_kv(torch.matmul(p.transpose(-1, -2), dof.abs()))}


def bf16_limit(r: torch.Tensor, slack) -> torch.Tensor:
    """The per-element rule for a bf16 kernel output against its plain
    value r: one bf16 step of each element + its rounding slack (this
    module's or `block_attention.rounding_slack`, or 0 where none applies)
    + 1e-5 of its row's largest |value| (f32 sum order)."""
    r = r.float()
    _, e = torch.frexp(r.abs())   # |r| in [2^(e-1), 2^e)
    step = torch.where(r == 0, 0.0, torch.exp2((e - 8).float()))
    return step + slack + 1e-5 * r.abs().amax(-1, keepdim=True)


def _bwd_args(q, k, v, lse, delta, do, t_real: int) -> tuple:
    """The route (`_BWD_ROUTE`), then the inputs and sizes both backward C
    functions take, in their order (inputs checked by the caller; the
    tensors must outlive the launch)."""
    b, h, t, d = q.shape
    return (_BWD_ROUTE[q.dtype],
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (b, h, k.shape[1], t, t_real, d, 1.0 / math.sqrt(d)))


def _launch_dq(args: tuple, dq: torch.Tensor, stream: int) -> None:
    """One launch of the dq kernel of the args' route into `dq`; not
    counted (the wrapper counts its own)."""
    (source, suffix), ptrs, sizes = args
    fn = _c_function(source, f"flash_bwd_dq{suffix}", _C_ARGS_DQ)
    err = fn(*ptrs, dq.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq{suffix} launch failed: CUDA error "
                           f"{err}")


def _launch_dkv(args: tuple, dk: torch.Tensor, dv: torch.Tensor,
                stream: int) -> None:
    """One launch of the dk/dv kernel of the args' route into `dk`, `dv`;
    not counted."""
    (source, suffix), ptrs, sizes = args
    fn = _c_function(source, f"flash_bwd_dkv{suffix}", _C_ARGS_DKV)
    err = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv{suffix} launch failed: CUDA error "
                           f"{err}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        t_real: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of causal attention given the forward's (o, lse) and the
    output cotangent `do`; see the module docstring. On a CUDA tensor: one
    launch of the dtype's dq kernel and one of its dk/dv kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, t_real)
    t_real = _check_bwd(q, k, v, o, lse, do, t_real)
    _check_kernel_inputs(q, k, v, o, lse, do)
    delta = _delta(o, do)
    args = _bwd_args(q, k, v, lse, delta, do, t_real)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch_dq(args, dq, stream)
        flash_attention_bwd.launches_dq += 1
        _launch_dkv(args, dk, dv, stream)
        flash_attention_bwd.launches_dkv += 1
    return dq, dk, dv


# kernel launches (not plain-version calls)
flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0


@torch.library.custom_op("distributed_pytorch_from_scratch_tpu_torch::flash_attention",
                         mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    t_real: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention, `flash_attention_fwd` as a dispatcher
    op with its gradient: the backward launches the backward kernels from
    the saved (q, k, v, o, lse). Being an op of the dispatcher, it can be
    named by a selective-checkpoint policy, which keeps its outputs rather
    than launching the forward again in the recompute (the 'dots' remat
    policy, `models/transformer.py`; the JAX kernel's `flash_out` and
    `flash_lse` tags). On CPU tensors both sides are the plain versions.
    `t_real` gets no gradient, nor does lse (the model reads only o)."""
    return flash_attention_fwd(q, k, v, t_real=t_real)


def _setup_context(ctx, inputs, output) -> None:
    q, k, v, t_real = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.t_real = t_real
    ctx.mark_non_differentiable(lse)
    ctx.set_materialize_grads(False)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                     t_real=ctx.t_real)
    return dq, dk, dv, None


flash_attention.register_autograd(_backward, setup_context=_setup_context)
