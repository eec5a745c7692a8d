"""Paged attention: the CUDA kernels `csrc/paged_decode.cu`,
`csrc/paged_chunk_sm90.cu` and `csrc/paged_attn.cu`, their plain PyTorch
version, and the wrapper the paged serving lowerings call.

Counterpart of the JAX TPU kernel `_paged_kernel` via `paged_attention` in
`distributed_pytorch_from_scratch_tpu/ops/pallas/paged_attention.py`, with
its signature:

    paged_attention(q, k_pool, v_pool, page_tbl, start, *, page_size,
                    qlen=None, pages_per_block=None, pos_offset=0,
                    return_lse=False)

* q (b, h, cw, hd) in the compute dtype: cw = 1 is a decode step, cw > 1 a
  prefill chunk;
* k_pool, v_pool: ONE layer of the page pool, (P+1, kvh, page_size, hd) in
  q's dtype, or (codes int8, scales f32 (P+1, kvh, page_size)) tuples; index
  P is the scratch page;
* page_tbl (b, max_pages) page ids; start, qlen: ints or (b,) — the absolute
  position of q column 0 and the per-row count of valid columns (columns
  >= qlen are pad: garbage in, finite garbage out);
* returns o (b, h, cw, hd) in q's dtype and, with `return_lse`, the f32
  logsumexp (b, h, cw) of each row's visible scores, -1e30 where a row sees
  nothing (its o is then exactly 0).

`pages_per_block` is taken for signature parity: the TPU kernel's block of
pages per grid step, which changes nothing in the result.

Three kernels compute the function, by query width and dtype (dispatch, not
fallback; `kernel_route`): a decode step (cw = 1, either dtype) goes to
`csrc/paged_decode.cu`, whose block splits the row's page walk across its
warps; a bf16 prefill chunk (cw > 1) to `csrc/paged_chunk_sm90.cu`, whose
64-row tiles run both products on the tensor cores (wgmma) with p split into
two bf16 terms, so nothing is rounded before p . v; an f32 chunk to the SIMT
`csrc/paged_attn.cu`. All take one C argument list. On a CUDA tensor the
wrapper launches the route's kernel (built on first use) or raises; on a CPU
tensor it computes the plain version, the kernels' math step by step. There
is no fallback from one to another. `paged_attention.launches` counts the
launches of every route, `paged_attention.launches_by_route` those of decode
steps and of chunks, and `paged_attention.launches_by_kernel` those of each
C entry point.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import counter_lock
from .flash_attention import _c_function

MASK = -1e30  # hard mask and dead-row lse, as the TPU kernel's
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

# paged_decode / paged_chunk_sm90 / paged_attn(q, k, v, k_scale, v_scale,
#     tbl, start, qlen, o, lse, b, kvh, R, cw, head_dim, ps, mp, n_pool_pages,
#     pos_offset, is_bf16, quantized, scale, stream)
_C_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
           + [ctypes.c_float, ctypes.c_void_p])


def kernel_route(cw: int, dtype: torch.dtype, head_dim: int) -> Tuple[str, str]:
    """(source under `csrc/`, C entry point) of the kernel that takes this
    query width, q dtype and head_dim (native or int8 pools alike): cw = 1
    -> `paged_decode`; cw > 1 -> `paged_chunk_sm90` in bfloat16,
    `paged_attn` in float32; raises on what is not built."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not built; the kernels take "
                         f"{HEAD_DIMS}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype} not built; the kernels take "
                         f"{DTYPES}")
    if cw < 1:
        raise ValueError(f"query width {cw} < 1")
    if cw == 1:
        return ("paged_decode",) * 2
    if dtype == torch.bfloat16:
        return ("paged_chunk_sm90",) * 2
    return ("paged_attn",) * 2


def _parts(pool):
    """(data, scales or None) of a native or (codes, scales) pool."""
    return pool if isinstance(pool, tuple) else (pool, None)


def _check(q, k_pool, v_pool, page_tbl, page_size: int) -> tuple:
    """Shapes and types both versions take; returns (kvh, quantized)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (b, heads, cw, head_dim), got "
                         f"{tuple(q.shape)}")
    b, h, cw, hd = q.shape
    if isinstance(k_pool, tuple) != isinstance(v_pool, tuple):
        raise ValueError("k_pool and v_pool must both be tensors or both "
                         "(codes, scales) tuples")
    quantized = isinstance(k_pool, tuple)
    kd, ks = _parts(k_pool)
    vd, vs = _parts(v_pool)
    if kd.dim() != 4 or kd.shape != vd.shape:
        raise ValueError(f"pools must be (pages, kv_heads, page_size, "
                         f"head_dim), got {tuple(kd.shape)} / "
                         f"{tuple(vd.shape)}")
    kvh = kd.shape[1]
    if kd.shape[2:] != (page_size, hd):
        raise ValueError(f"pool pages {tuple(kd.shape[2:])} do not match "
                         f"page_size {page_size} and head_dim {hd}")
    if h % kvh:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {kvh}")
    if quantized:
        if kd.dtype != torch.int8 or vd.dtype != torch.int8:
            raise ValueError("quantized pools hold int8 codes")
        for sc in (ks, vs):
            if sc.dtype != torch.float32 or sc.shape != kd.shape[:3]:
                raise ValueError(f"pool scales must be float32 "
                                 f"{tuple(kd.shape[:3])}")
    elif not (kd.dtype == vd.dtype == q.dtype):
        raise ValueError(f"pool dtype {kd.dtype}/{vd.dtype} differs from q's "
                         f"{q.dtype}")
    if page_tbl.dim() != 2 or page_tbl.shape[0] != b:
        raise ValueError(f"page_tbl must be (b={b}, max_pages), got "
                         f"{tuple(page_tbl.shape)}")
    tensors = [q, kd, vd, page_tbl] + ([ks, vs] if quantized else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, pools and page_tbl must lie on one device")
    return kvh, quantized


def _rows(x, b: int, device) -> torch.Tensor:
    """A scalar or (b,) value as a contiguous (b,) int32 tensor on `device`
    (no copy when it already is one)."""
    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    return t.expand(b).contiguous()


def paged_attention_plain(q: torch.Tensor, k_pool, v_pool,
                          page_tbl: torch.Tensor, start, *, page_size: int,
                          qlen=None, pages_per_block: Optional[int] = None,
                          pos_offset: int = 0, return_lse: bool = False):
    """The kernel's math in step-by-step torch, over one tile that spans
    every key: each row's pages gathered into a dense f32 view (int8 codes
    times their scales), f32 scores, the -1e30 mask on keys past the row's
    position and on pages past the batch row's vmax, the MASK/2 clamp, p and
    v in f32 for p @ v, l == 0 -> 1."""
    kvh, _ = _check(q, k_pool, v_pool, page_tbl, page_size)
    b, h, cw, hd = q.shape
    g = h // kvh
    rows = g * cw
    dev = q.device
    ps, mp = page_size, page_tbl.shape[1]
    start = _rows(start, b, dev).long()
    span = (torch.clamp(_rows(qlen, b, dev).long(), min=1)
            if qlen is not None else cw)
    vmax = start + span - 1
    n_pool = _parts(k_pool)[0].shape[0]
    tbl = page_tbl.long().clamp(0, n_pool - 1)   # as the kernel clamps

    def view(pool):
        data, sc = _parts(pool)
        x = data[tbl].float()                    # (b, mp, kvh, ps, hd)
        if sc is not None:
            x = x * sc[tbl][..., None]
        return x.transpose(1, 2).reshape(b, kvh, mp * ps, hd)

    k, v = view(k_pool), view(v_pool)
    key = torch.arange(mp * ps, device=dev)
    s = torch.matmul(q.reshape(b, kvh, rows, hd).float(),
                     k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    page_live = (pos_offset + (key // ps) * ps)[None, :] <= vmax[:, None]
    qpos = start[:, None] + torch.arange(rows, device=dev)[None, :] % cw
    live = ((pos_offset + key)[None, None, :] <= qpos[:, :, None]) \
        & page_live[:, None, :]
    live = live[:, None]                         # (b, 1, R, T)
    s = s.masked_fill(~live, MASK)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=MASK / 2)
    p = torch.where(live, torch.exp(s - m_safe), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p, v)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (acc / l_safe).to(q.dtype).reshape(b, h, cw, hd)
    if not return_lse:
        return o
    lse = torch.where(l == 0.0, torch.full_like(l, MASK),
                      m + torch.log(l_safe))
    return o, lse[..., 0].reshape(b, h, cw)


def _check_kernel_inputs(q, k_pool, v_pool, page_tbl) -> None:
    """The head dims, dtypes and layouts the CUDA kernels take; raises on
    anything else."""
    source, _ = kernel_route(q.shape[2], q.dtype, q.shape[3])
    if page_tbl.dtype != torch.int32:
        raise ValueError(f"page_tbl must be int32, got {page_tbl.dtype}")
    parts = [x for pool in (k_pool, v_pool) for x in _parts(pool)
             if x is not None]
    if not all(x.is_contiguous() for x in (q, page_tbl, *parts)):
        raise ValueError("kernel inputs must be contiguous")
    # K/V data are read in 16-byte vectors; int8 scales one float at a time
    if any(_parts(pool)[0].data_ptr() % 16 for pool in (k_pool, v_pool)):
        raise ValueError("pool data must start on a 16-byte boundary (the "
                         "kernel reads it in 16-byte vectors)")
    if source == "paged_chunk_sm90" and q.data_ptr() % 16:
        raise ValueError("q must start on a 16-byte boundary (the chunk "
                         "kernel reads it in 16-byte vectors)")
    if q.shape[0] > 65535:
        raise ValueError(f"batch {q.shape[0]} exceeds the grid's z limit "
                         f"65535")


def _prepare(q, k_pool, v_pool, page_tbl, start, *, page_size: int,
             qlen=None, pos_offset: int = 0, return_lse: bool = False):
    """Check the inputs, allocate (o, lse) and return (o, lse, launch):
    `launch(stream)` enqueues one uncounted launch of the kernel that
    `kernel_route` names into o and lse (it holds the tensors it points at,
    so they outlive the launch)."""
    kvh, quantized = _check(q, k_pool, v_pool, page_tbl, page_size)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel_inputs(q, k_pool, v_pool, page_tbl)
    b, h, cw, hd = q.shape
    start = _rows(start, b, q.device)
    qlen = _rows(qlen, b, q.device) if qlen is not None else None
    kd, ks = _parts(k_pool)
    vd, vs = _parts(v_pool)
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, cw), dtype=torch.float32, device=q.device)
           if return_lse else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (q.data_ptr(), kd.data_ptr(), vd.data_ptr(), ptr(ks), ptr(vs),
            page_tbl.data_ptr(), start.data_ptr(), ptr(qlen), o.data_ptr(),
            ptr(lse), b, kvh, (h // kvh) * cw, cw, hd, page_size,
            page_tbl.shape[1], kd.shape[0], int(pos_offset),
            int(q.dtype == torch.bfloat16), int(quantized),
            1.0 / math.sqrt(hd))
    source, entry = kernel_route(cw, q.dtype, hd)
    fn = _c_function(source, entry, _C_ARGS)

    def launch(stream: int,
               _held=(q, k_pool, v_pool, page_tbl, start, qlen)) -> None:
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {err}")

    return o, lse, launch


def paged_attention(q: torch.Tensor, k_pool, v_pool, page_tbl: torch.Tensor,
                    start, *, page_size: int, qlen=None,
                    pages_per_block: Optional[int] = None,
                    pos_offset: int = 0, return_lse: bool = False):
    """Attention of q over the paged pool through the page table; see the
    module docstring. One launch of the `kernel_route` kernel on a CUDA
    tensor."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pool, v_pool, page_tbl, start, page_size=page_size,
            qlen=qlen, pages_per_block=pages_per_block,
            pos_offset=pos_offset, return_lse=return_lse)
    o, lse, launch = _prepare(q, k_pool, v_pool, page_tbl, start,
                              page_size=page_size, qlen=qlen,
                              pos_offset=pos_offset, return_lse=return_lse)
    with torch.cuda.device(q.device):
        launch(torch.cuda.current_stream(q.device).cuda_stream)
    with counter_lock:
        paged_attention.launches += 1
        paged_attention.launches_by_route["decode" if q.shape[2] == 1
                                          else "chunk"] += 1
        paged_attention.launches_by_kernel[
            kernel_route(q.shape[2], q.dtype, q.shape[3])[1]] += 1
    return (o, lse) if return_lse else o


paged_attention.launches = 0  # kernel launches (not plain-version calls)
paged_attention.launches_by_route = {"decode": 0, "chunk": 0}
paged_attention.launches_by_kernel = {"paged_decode": 0, "paged_chunk_sm90": 0,
                                      "paged_attn": 0}
