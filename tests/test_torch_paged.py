"""The port's paged serving slice (PyTorch) against the JAX package's.

Inputs come from numpy seeds and go to both packages; the model is the
tiny shape of tests/test_paged_kernel.py (d 32, 8 heads, 2 layers, vocab
96) at float32, with one exported init (`interop.params_from_jax`).

* `paged_attention_plain` (what the CUDA wrapper computes on a CPU tensor)
  against the JAX `paged_attention(..., interpret=True)` within 1e-5:
  decode over page sizes, pages_per_block and GQA groups, the chunk shape
  with per-row start/qlen on native and int8 pools, `pos_offset`, and
  `return_lse` on a row that sees nothing.
* `quantize_rows`: codes and scales equal to JAX's byte for byte.
* `_paged_decode_one` / `_paged_prefill_chunk` at both attend impls against
  the JAX gather lowering: logits and updated pools within 1e-5.
* `PagedEngine` (kernel impl = its plain version here, and gather) against
  the JAX `PagedEngine(gather)` under one scripted clock: identical greedy
  tokens per request, identical page tables after every step, identical
  stats, refcounts drained — native, int8 KV, GQA, an oversubscribed pool
  (preemption + COW resume) and SLO-class preemption.
* `SLOScheduler` and `synthetic_requests` (all four knobs) as JAX's.
* The serve CLI's `--paged` dry runs on the CPU and its refusals.
"""

import itertools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_pytorch_from_scratch_tpu.config import (
    MeshConfig as JMeshConfig, ModelConfig as JModelConfig)
from distributed_pytorch_from_scratch_tpu.models import decode as jdecode
from distributed_pytorch_from_scratch_tpu.models.transformer import (
    Transformer as JTransformer)
from distributed_pytorch_from_scratch_tpu.ops import quant as jquant
from distributed_pytorch_from_scratch_tpu.ops.pallas import (
    paged_attention as jpa)
from distributed_pytorch_from_scratch_tpu.runtime.mesh import (
    make_mesh as jmake_mesh)
from distributed_pytorch_from_scratch_tpu.serving import engine as jengine
from distributed_pytorch_from_scratch_tpu.serving import (
    kv_manager as jkv_manager)
from distributed_pytorch_from_scratch_tpu.serving import (
    scheduler as jscheduler)
from distributed_pytorch_from_scratch_tpu.serving.loadgen import (
    synthetic_requests as jsynthetic_requests)
from distributed_pytorch_from_scratch_tpu_torch.config import (
    MeshConfig, ModelConfig)
from distributed_pytorch_from_scratch_tpu_torch.interop import params_from_jax
from distributed_pytorch_from_scratch_tpu_torch.models import decode
from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
    Transformer)
from distributed_pytorch_from_scratch_tpu_torch.ops import quant
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda import build
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
    MASK, _check_kernel_inputs, kernel_route, paged_attention,
    paged_attention_plain)
from distributed_pytorch_from_scratch_tpu_torch.ops.rope import rope_tables
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving import (
    kv_manager, scheduler, serve)
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    PagedEngine, Request)
from distributed_pytorch_from_scratch_tpu_torch.serving.loadgen import (
    synthetic_requests)

SHAPE = dict(attn_dim=32, ffn_dim=64, num_heads=8, num_layers=2,
             vocab_size=96, maxlen=64)
BUF, EOS = 32, 1
PROMPTS = [
    [0, 5, 17, 33, 60],
    [0, 95],
    [0, 2, 4, 6, 8, 10, 12, 14],    # page-boundary prompt at ps=8
    [0, 7],
    [0, 9, 11],
    [0, 3, 5, 7, 11, 13, 17],
]
POOL_SPEC = P(None, None, "tp", None, None)
SCALE_SPEC = P(None, None, "tp", None)


# ---------------------------------------------- (a) the kernel's oracle --

def _pool(rng, pages, kvh, ps, hd, int8=False):
    """(k, v) pools as numpy: normal f32, or (codes, scales) tuples."""
    if int8:
        return tuple((rng.integers(-127, 128, (pages + 1, kvh, ps, hd))
                      .astype(np.int8),
                      rng.uniform(0.01, 0.05, (pages + 1, kvh, ps))
                      .astype(np.float32)) for _ in range(2))
    return tuple(rng.normal(size=(pages + 1, kvh, ps, hd)).astype(np.float32)
                 for _ in range(2))


def _to(fn, pool):
    return tuple(fn(x) for x in pool) if isinstance(pool, tuple) else fn(pool)


def _both(q, kp, vp, tbl, start, ps, **kw):
    """(JAX kernel in interpret mode, port plain) on the same inputs."""
    j = jpa.paged_attention(
        jnp.asarray(q), _to(jnp.asarray, kp), _to(jnp.asarray, vp),
        jnp.asarray(tbl), jnp.asarray(start), page_size=ps, interpret=True,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    kw.pop("pages_per_block", None)
    t = paged_attention_plain(
        torch.from_numpy(q), _to(torch.from_numpy, kp),
        _to(torch.from_numpy, vp), torch.from_numpy(tbl),
        torch.from_numpy(start), page_size=ps,
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    if isinstance(j, tuple):
        return [np.asarray(x) for x in j], [x.numpy() for x in t]
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("ps,n_blk,g", [(8, 1, 1), (8, 2, 4), (16, 3, 2)])
def test_plain_decode_matches_jax_kernel(ps, n_blk, g):
    """cw = 1 over a scattered page walk, cursors at a page end, a page
    start, the last position and 0 (a free slot's garbage row)."""
    rng = np.random.default_rng(ps * 10 + n_blk + g)
    kvh, hd, mp, b = 2, 16, 4, 4
    kp, vp = _pool(rng, 10, kvh, ps, hd)
    tbl = rng.integers(0, 10, (b, mp)).astype(np.int32)
    cur = np.array([ps - 1, 2 * ps, mp * ps - 1, 0], np.int32)
    q = rng.normal(size=(b, kvh * g, 1, hd)).astype(np.float32)
    o, r = _both(q, kp, vp, tbl, cur, ps, pages_per_block=n_blk)
    np.testing.assert_allclose(r, o, atol=1e-5)
    assert np.isfinite(r).all()


@pytest.mark.parametrize("int8", [False, True])
def test_plain_chunk_matches_jax_kernel(int8):
    """cw = 4 with GQA g = 2 and per-row start/qlen: valid columns match;
    pad columns (>= qlen) are finite garbage."""
    rng = np.random.default_rng(7 if int8 else 3)
    ps, mp, b, kvh, g, hd, cw = 8, 4, 3, 2, 2, 16, 4
    kp, vp = _pool(rng, 10, kvh, ps, hd, int8=int8)
    tbl = rng.integers(0, 10, (b, mp)).astype(np.int32)
    start = np.array([2, 9, 0], np.int32)
    qlen = np.array([4, 2, 1], np.int32)
    q = rng.normal(size=(b, kvh * g, cw, hd)).astype(np.float32)
    o, r = _both(q, kp, vp, tbl, start, ps, qlen=qlen, pages_per_block=2)
    for i in range(b):
        n = int(qlen[i])
        np.testing.assert_allclose(r[i, :, :n], o[i, :, :n], atol=1e-5,
                                   err_msg=f"row {i}")
    assert np.isfinite(r).all()


def test_plain_gqa_row_stacking_at_g4_cw4():
    """g = 4 with cw = 4: a row order qi*g + gi instead of gi*cw + qi would
    pass at g = 1 or cw = 1 and fail here."""
    rng = np.random.default_rng(21)
    ps, mp, b, kvh, g, hd, cw = 8, 3, 2, 2, 4, 16, 4
    kp, vp = _pool(rng, 8, kvh, ps, hd)
    tbl = rng.integers(0, 8, (b, mp)).astype(np.int32)
    start = np.array([5, 12], np.int32)
    q = rng.normal(size=(b, kvh * g, cw, hd)).astype(np.float32)
    o, r = _both(q, kp, vp, tbl, start, ps, pages_per_block=1)
    np.testing.assert_allclose(r, o, atol=1e-5)


def test_plain_pos_offset_and_dead_row_lse():
    """The cp hook: over the table's second half with pos_offset = half the
    span, a row whose cursor lies before the offset sees nothing: o exactly
    0 and lse exactly -1e30 (in JAX too)."""
    rng = np.random.default_rng(11)
    ps, mp, b, kvh, hd = 8, 4, 3, 2, 16
    kp, vp = _pool(rng, 10, kvh, ps, hd)
    tbl = rng.integers(0, 10, (b, mp)).astype(np.int32)
    cur = np.array([mp * ps - 1, 3 * ps, 5], np.int32)
    q = rng.normal(size=(b, kvh, 1, hd)).astype(np.float32)
    half = np.ascontiguousarray(tbl[:, mp // 2:])
    (o, lse), (ro, rlse) = _both(q, kp, vp, half, cur, ps,
                                 pos_offset=(mp // 2) * ps, return_lse=True)
    np.testing.assert_allclose(ro, o, atol=1e-5)
    np.testing.assert_allclose(rlse[:2], lse[:2], atol=1e-5)
    assert (ro[2] == 0).all() and (rlse[2] == MASK).all()
    assert (lse[2] == MASK).all()


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    kp, vp = _pool(rng, 4, 2, 8, 16, int8=True)
    args = (torch.from_numpy(rng.normal(size=(2, 4, 2, 16))
                             .astype(np.float32)),
            _to(torch.from_numpy, kp), _to(torch.from_numpy, vp),
            torch.tensor([[0, 3], [2, 1]], dtype=torch.int32))
    before = paged_attention.launches
    got = paged_attention(*args, 7, page_size=8, qlen=torch.tensor([2, 1]))
    ref = paged_attention_plain(*args, 7, page_size=8,
                                qlen=torch.tensor([2, 1]))
    assert torch.equal(got, ref) and paged_attention.launches == before
    with pytest.raises(ValueError, match="page_size"):
        paged_attention(*args, 7, page_size=4)


def test_kernel_input_check_takes_every_layer_of_an_int8_pool():
    """MQA with page_size 1 and an odd page count: layer 1's scale view
    starts 12 bytes in. The kernel reads scales one float at a time, so the
    check takes it; only K/V data, read as 16-byte vectors, must start on a
    16-byte boundary."""
    layers, pages, kvh, ps, hd = 2, 3, 1, 1, 64
    codes = torch.zeros((layers, pages, kvh, ps, hd), dtype=torch.int8)
    scales = torch.ones((layers, pages, kvh, ps))
    q = torch.zeros((2, 4, 1, hd))
    tbl = torch.zeros((2, 1), dtype=torch.int32)
    pool = (codes[1], scales[1])
    assert scales[1].data_ptr() % 16 == 12
    _check_kernel_inputs(q, pool, pool, tbl)
    shifted = torch.zeros(codes[1].numel() + 1, dtype=torch.int8)[1:]
    bad = (shifted.view(codes[1].shape), scales[1])
    with pytest.raises(ValueError, match="16-byte"):
        _check_kernel_inputs(q, bad, pool, tbl)


def test_kernel_input_check_wants_q_aligned_for_the_chunk_kernel():
    """The bf16 chunk kernel reads q in 16-byte vectors, so a q view that
    starts off a 16-byte boundary is refused on that route; the decode and
    f32 chunk kernels read q element by element and take it."""
    pool = torch.zeros((3, 2, 8, 64), dtype=torch.bfloat16)
    tbl = torch.zeros((1, 2), dtype=torch.int32)
    cases = ((4, torch.bfloat16, False), (1, torch.bfloat16, True),
             (4, torch.float32, True))
    for cw, dtype, ok in cases:
        flat = torch.zeros(4 * cw * 64 + 1, dtype=dtype)
        q = flat[1:].view(1, 4, cw, 64)
        assert q.data_ptr() % 16 and q.is_contiguous()
        pools = (pool.to(dtype),) * 2
        if ok:
            _check_kernel_inputs(q, *pools, tbl)
        else:
            with pytest.raises(ValueError, match="q must start on a 16-byte"):
                _check_kernel_inputs(q, *pools, tbl)


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_paged_kernel_route(head_dim):
    """K3's kernels by query width and dtype, dispatch and not fallback: a
    decode step (cw = 1) to `paged_decode` at both built dtypes; a chunk
    (cw > 1) to the wgmma `paged_chunk_sm90` in bfloat16 and to the SIMT
    `paged_attn` in float32; anything else raises before a launch. The CPU
    wrapper counts no launch on any route."""
    for dtype in (torch.float32, torch.bfloat16):
        assert kernel_route(1, dtype, head_dim) == ("paged_decode",
                                                    "paged_decode")
    for cw in (2, 128):
        assert kernel_route(cw, torch.bfloat16, head_dim) == (
            "paged_chunk_sm90", "paged_chunk_sm90")
        assert kernel_route(cw, torch.float32, head_dim) == ("paged_attn",
                                                             "paged_attn")
    with pytest.raises(ValueError, match="dtype torch.float16 not built"):
        kernel_route(1, torch.float16, head_dim)
    with pytest.raises(ValueError, match="head_dim 48 not built"):
        kernel_route(1, torch.bfloat16, 48)
    with pytest.raises(ValueError, match="head_dim 48 not built"):
        kernel_route(4, torch.float32, 48)
    assert {"paged_decode", "paged_chunk_sm90", "paged_attn"} <= set(
        build.all_sources())
    before = (dict(paged_attention.launches_by_route),
              dict(paged_attention.launches_by_kernel))
    for dtype in (torch.float32, torch.bfloat16):
        for cw in (1, 4):
            q = torch.zeros((1, 2, cw, head_dim), dtype=dtype)
            pool = torch.zeros((2, 2, 8, head_dim), dtype=dtype)
            paged_attention(q, pool, pool,
                            torch.zeros((1, 1), dtype=torch.int32), 3,
                            page_size=8)
    assert (paged_attention.launches_by_route,
            paged_attention.launches_by_kernel) == before


# The bf16 chunk kernel's rounding scheme (csrc/paged_chunk_sm90.cu), step
# by step in torch: 64-row tiles of the stacked rows, each walking its keys
# in tiles of 64 up to its own last visible key; bf16 q and k (int8 codes
# are exact in bf16) multiplied in f32, k's scale on the scores' columns;
# an online softmax; p times v's scale split into bf16 p_hi + p_lo, both
# multiplied by v. It guards the precision argument where no card is: held
# against the plain version under PAGED_LIMIT (chip_smoke.py) — one bf16
# step of each plain element + 1e-5 of its row's max |o| — it must pass,
# and with p rounded once (no p_lo) it must not.
CHUNK_CASES = [  # (b, h, kvh, cw, hd, ps, mp, int8, starts, qlens, off)
    (2, 8, 8, 64, 64, 64, 4, False, [0, 100], None, 0),
    (2, 8, 8, 65, 64, 64, 4, False, [0, 130], None, 0),
    (1, 8, 8, 128, 64, 64, 4, False, [61], None, 0),
    (2, 4, 4, 64, 64, 8, 40, False, [37, 200], None, 0),
    (2, 4, 4, 100, 64, 16, 20, False, [3, 150], [100, 77], 0),
    (2, 4, 4, 128, 64, 128, 4, False, [100, 300], None, 0),
    (2, 16, 4, 32, 64, 16, 10, False, [5, 100], [32, 20], 0),
    (2, 8, 4, 64, 32, 16, 10, True, [0, 77], [64, 50], 0),
    (2, 4, 4, 96, 128, 32, 8, True, [10, 150], None, 0),
    (3, 8, 8, 64, 64, 64, 4, False, [50, 128, 300], None, 128),
    (2, 8, 8, 128, 64, 64, 4, False, [128, 128], None, 0),
    (3, 4, 4, 128, 64, 64, 6, True, [0, 64, 200], [1, 50, 128], 0),
]
CHUNK_IDS = ["cw64", "cw65", "start61", "ps8", "ps16-qlen", "ps128",
             "gqa4-cw32", "hd32-int8", "hd128-int8", "pos_offset-dead-row",
             "full-table", "pad-columns-int8"]


def _chunk_kernel_emulation(q, k_pool, v_pool, page_tbl, start, *,
                            page_size, qlen=None, pos_offset=0, p_lo=True):
    """(o bf16, lse f32) as paged_chunk_sm90.cu computes them."""
    kd, ks = k_pool if isinstance(k_pool, tuple) else (k_pool, None)
    vd, vs = v_pool if isinstance(v_pool, tuple) else (v_pool, None)
    b, h, cw, hd = q.shape
    kvh = kd.shape[1]
    R, ps, mp = (h // kvh) * cw, page_size, page_tbl.shape[1]
    qs = q.to(torch.bfloat16).float().reshape(b, kvh, R, hd)
    o = torch.zeros((b, kvh, R, hd))
    lse = torch.full((b, kvh, R), MASK)
    bf16 = lambda x: x.to(torch.bfloat16).float()
    for bi in range(b):
        st = int(start[bi])
        vmax = st + (max(int(qlen[bi]), 1) if qlen is not None else cw) - 1
        n_live = (0 if vmax < pos_offset
                  else min(mp, (vmax - pos_offset) // ps + 1))
        walk_end = n_live * ps
        keys = torch.arange(walk_end)
        page = page_tbl[bi].long().clamp(0, kd.shape[0] - 1)[keys // ps]
        k = kd[page, :, keys % ps].float().transpose(0, 1)   # (kvh, T, hd)
        v = vd[page, :, keys % ps].float().transpose(0, 1)
        k_sc = (ks[page, :, keys % ps].T if ks is not None
                else torch.ones((kvh, walk_end)))
        v_sc = (vs[page, :, keys % ps].T if vs is not None
                else torch.ones((kvh, walk_end)))
        for r0 in range(0, R, 64):
            rows = torch.arange(r0, min(r0 + 64, R))
            qpos = st + rows % cw
            key_end = max(0, min(walk_end, int(qpos.max()) - pos_offset + 1))
            m = torch.full((kvh, len(rows)), MASK)
            l = torch.zeros((kvh, len(rows)))
            acc = torch.zeros((kvh, len(rows), hd))
            for k0 in range(0, key_end, 64):
                kk = torch.arange(k0, min(k0 + 64, key_end))
                s = (torch.matmul(qs[bi][:, rows], k[:, kk].transpose(1, 2))
                     * k_sc[:, None, kk] * (1.0 / math.sqrt(hd)))
                live = (pos_offset + kk)[None, :] <= qpos[:, None]
                s = torch.where(live, s, MASK)
                mx = torch.maximum(m, s.amax(-1))
                m_safe = mx.clamp(min=MASK / 2)
                alpha = torch.exp(m - m_safe)
                p = torch.where(live, torch.exp(s - m_safe[..., None]), 0.0)
                l = alpha * l + p.sum(-1)
                m = mx
                pv = p * v_sc[:, None, kk]
                hi = bf16(pv)
                lo = bf16(pv - hi) if p_lo else torch.zeros_like(pv)
                acc = (acc * alpha[..., None] + torch.matmul(hi, v[:, kk])
                       + torch.matmul(lo, v[:, kk]))
            l_safe = torch.where(l == 0, 1.0, l)
            o[bi][:, rows] = acc / l_safe[..., None]
            lse[bi][:, rows] = torch.where(l == 0, MASK, m + torch.log(l_safe))
    return (o.to(torch.bfloat16).reshape(b, h, cw, hd),
            lse.reshape(b, h, cw))


def _paged_limit_ratio(o, ref, valid):
    """Worst |o - ref| / (one bf16 step of the ref element + 1e-5 x its
    row's max |ref|) over each batch row's valid columns: PAGED_LIMIT's
    bf16 rule in chip_smoke.py, which holds the chunk kernel on the card."""
    worst = 0.0
    for r, n in enumerate(valid):
        a, x = o[r, :, :n].float(), ref[r, :, :n].float()
        _, e = torch.frexp(x.abs())               # |x| in [2^(e-1), 2^e)
        step = torch.where(x == 0, 0.0, torch.exp2((e - 8).float()))
        limit = step + 1e-5 * x.abs().amax(-1, keepdim=True)
        worst = max(worst, ((a - x).abs() / limit.clamp_min(1e-30))
                    .max().item())
    return worst


def _chunk_inputs(case, seed):
    b, h, kvh, cw, hd, ps, mp, int8, starts, qlens, off = case
    rng = np.random.default_rng(seed)
    n_pages = b * mp
    kp, vp = _pool(rng, n_pages, kvh, ps, hd, int8=int8)
    if not int8:
        kp, vp = (torch.from_numpy(x).to(torch.bfloat16) for x in (kp, vp))
    else:
        kp, vp = _to(torch.from_numpy, kp), _to(torch.from_numpy, vp)
    q = torch.from_numpy(rng.normal(size=(b, h, cw, hd)).astype(np.float32))
    tbl = torch.from_numpy(rng.permutation(n_pages).reshape(b, mp)
                           .astype(np.int32))
    kw = dict(page_size=ps, pos_offset=off,
              qlen=None if qlens is None else torch.tensor(qlens))
    return (q.to(torch.bfloat16), kp, vp, tbl, torch.tensor(starts)), kw


@pytest.mark.parametrize("case", CHUNK_CASES, ids=CHUNK_IDS)
def test_chunk_kernel_rounding_within_paged_limit(case):
    """The bf16 chunk kernel's scheme against the plain version: within
    PAGED_LIMIT over the valid columns, lse within 1e-4, a row that sees
    nothing exactly 0 / -1e30, finite pad columns. Rounding p once instead
    breaks the limit on the native-pool cases of many keys."""
    b, h, kvh, cw, hd, ps, mp, int8, starts, qlens, off = case
    args, kw = _chunk_inputs(case, seed=sum(starts) + cw)
    ro, rlse = paged_attention_plain(*args, return_lse=True, **kw)
    o, lse = _chunk_kernel_emulation(*args, **kw)
    valid = [cw if qlens is None else qlens[r] for r in range(b)]
    assert _paged_limit_ratio(o, ro, valid) <= 1.0
    for r, n in enumerate(valid):
        assert (lse[r, :, :n] - rlse[r, :, :n]).abs().max() <= 1e-4
    for r in range(b):
        if starts[r] + cw - 1 < off:
            assert (o[r] == 0).all() and (lse[r] == MASK).all()
            assert (ro[r] == 0).all() and (rlse[r] == MASK).all()
    assert torch.isfinite(o.float()).all()
    if not int8 and off == 0 and mp * ps >= 256:
        once, _ = _chunk_kernel_emulation(*args, p_lo=False, **kw)
        assert _paged_limit_ratio(once, ro, valid) > 1.0


def test_chunk_kernel_rounding_matches_jax_kernel():
    """One chunk case through the JAX kernel (interpret mode, bf16 q and
    pools) and the chunk kernel's scheme: two row tiles, the first spanning
    heads (GQA g 2, cw 40), a walk of several key tiles across pages of
    16, per-row qlen; within PAGED_LIMIT, lse within 1e-4."""
    case = (2, 4, 2, 40, 32, 16, 10, False, [30, 97], [40, 23], 0)
    args, kw = _chunk_inputs(case, seed=5)
    q, kp, vp, tbl, start = args
    (jo, jlse) = jpa.paged_attention(
        jnp.asarray(q.float().numpy(), jnp.bfloat16),
        jnp.asarray(kp.float().numpy(), jnp.bfloat16),
        jnp.asarray(vp.float().numpy(), jnp.bfloat16), jnp.asarray(tbl),
        jnp.asarray(start.numpy().astype(np.int32)), page_size=16,
        qlen=jnp.asarray(np.array([40, 23], np.int32)), pages_per_block=2,
        return_lse=True, interpret=True)
    o, lse = _chunk_kernel_emulation(*args, **kw)
    jo = torch.from_numpy(np.asarray(jo.astype(jnp.float32)))
    jlse = torch.from_numpy(np.asarray(jlse))
    assert _paged_limit_ratio(o, jo, [40, 23]) <= 1.0
    for r, n in enumerate([40, 23]):
        assert (lse[r, :, :n] - jlse[r, :, :n]).abs().max() <= 1e-4


# ------------------------------------------------------ (b) int8 codes --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 3, 16)).astype(np.float32) * 3
    x[1, 2] = 0.0                                  # all-zero row: scale 1
    x[2, 0, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]     # halves round to even
    x[2, 0, 5:] = 0.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jquant.quantize_rows(jx)
    tq, ts = quant.quantize_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert tq[2, 0, :5].tolist() == [127, 0, 2, 2, 0]
    back = quant.dequantize_rows(tq, ts, torch.float32)
    jback = jquant.dequantize_rows(jq, js, jnp.float32)
    assert np.array_equal(back.numpy(), np.asarray(jback))


def test_kv_bytes_match_jax():
    for cd in ("float32", "bfloat16"):
        for kvd in (None, "int8"):
            t = ModelConfig(**SHAPE, compute_dtype=cd, num_kv_heads=2)
            j = JModelConfig(**SHAPE, compute_dtype=cd, num_kv_heads=2)
            assert (kv_manager.kv_token_bytes(t, kvd)
                    == jkv_manager.kv_token_bytes(j, kvd))
            assert (kv_manager.page_bytes(t, 16, kvd)
                    == jkv_manager.page_bytes(j, 16, kvd))


# -------------------------------------------- (c) the paged lowerings --

def _models(cfg_kw, seed):
    jmodel = JTransformer(JModelConfig(**cfg_kw), tp_size=1)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(seed)))
    model = Transformer(ModelConfig(**cfg_kw))
    model.load_state_dict(params_from_jax(tree))
    return jmodel, tree, model


def _jax_fns(jmodel, quantized):
    """The JAX `_paged_prefill_chunk` and `_paged_decode_one` (gather
    impl), jitted under shard_map on a tp=1 mesh: {chunk?: fn}."""
    mesh = jmake_mesh(JMeshConfig(tp=1))
    spec = (POOL_SPEC, SCALE_SPEC) if quantized else POOL_SPEC

    def build(chunk):
        def fn(params, pk, pv, *a):
            cos, sin = jdecode.rope_tables(SHAPE["maxlen"],
                                           jmodel.cfg.head_dim)
            if chunk:
                return jdecode._paged_prefill_chunk(
                    jmodel, params, pk, pv, *a, 8, cos, sin, jnp.float32,
                    all_logits=True)
            return jdecode._paged_decode_one(jmodel, params, pk, pv, *a, 8,
                                             cos, sin, jnp.float32)

        return jax.jit(jax.shard_map(
            fn, mesh=mesh,
            in_specs=(jmodel.specs(), spec, spec) + (P(),) * (6 if chunk
                                                               else 3),
            out_specs=(spec, spec, P(None, None, "tp") if chunk
                       else P(None, "tp"))))

    return {True: build(True), False: build(False)}


@pytest.fixture(scope="module", params=[None, "int8"])
def lowering_case(request):
    """Two chunks (start 0, then each row's cursor, per-row qlen) and three
    decode steps for two rows with scattered page tables, through the JAX
    gather lowering: [(chunk?, args, pools after, logits)], a chunk's
    logits at every position (`all_logits`)."""
    kv_dtype = request.param
    jmodel, tree, model = _models(SHAPE, seed=2)
    cfg = model.cfg
    ps, pages = 8, 10
    shape = (cfg.num_layers, pages + 1, cfg.kv_heads, ps, cfg.head_dim)
    if kv_dtype:
        pools = tuple((np.zeros(shape, np.int8),
                       np.ones(shape[:-1], np.float32)) for _ in range(2))
    else:
        pools = tuple(np.zeros(shape, np.float32) for _ in range(2))
    init = pools
    fns = _jax_fns(jmodel, bool(kv_dtype))
    tbl = np.array([[3, 7, 1, pages], [5, 2, 9, pages]], np.int32)
    rng = np.random.default_rng(5)
    cur = np.zeros(2, np.int32)
    calls = []
    for qlen in ([8, 5], [6, 8], None, None, None):
        if qlen is None:                                  # a decode step
            args = (rng.integers(3, 96, 2).astype(np.int32), cur.copy(),
                    tbl)
            cur = cur + 1
        else:
            qlen = np.array(qlen, np.int32)
            dstp = np.full((2, 8), pages, np.int32)
            dsto = np.tile(np.arange(8, dtype=np.int32), (2, 1))
            for r in range(2):
                for i in range(qlen[r]):
                    dstp[r, i] = tbl[r, (cur[r] + i) // ps]
                    dsto[r, i] = (cur[r] + i) % ps
            args = (rng.integers(3, 96, (2, 8)).astype(np.int32),
                    cur.copy(), qlen, tbl, dstp, dsto)
            cur = cur + qlen
        pk, pv, logits = fns[qlen is not None](tree, *pools, *args)
        pools = (_to(np.asarray, pk), _to(np.asarray, pv))
        calls.append((qlen is not None, args, pools, np.asarray(logits)))
    return tree, init, calls


def _pool_diff(a, b) -> float:
    if isinstance(a, tuple):
        return max(_pool_diff(x, y) for x, y in zip(a, b))
    return float(np.abs(a.astype(np.float64) - b).max())


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_paged_lowerings_match_jax(lowering_case, impl):
    """Logits and the pools (written in place) after every call against
    the JAX gather lowering, within 1e-5; int8 codes exactly."""
    tree, init, calls = lowering_case
    model = Transformer(ModelConfig(**SHAPE))
    model.load_state_dict(params_from_jax(tree))
    tpools = _to(lambda p: _to(lambda x: torch.from_numpy(x.copy()), p),
                 init)
    cos, sin = rope_tables(SHAPE["maxlen"], model.cfg.head_dim)
    for chunk, args, jpools, jlog in calls:
        targs = [torch.from_numpy(a) for a in args]
        with torch.inference_mode():
            if chunk:
                # the writes are idempotent, so the chunk runs twice: every
                # position's logits (valid columns; pad columns differ by
                # impl), then the default last-position logits
                full = decode._paged_prefill_chunk(
                    model, *tpools, *targs, 8, cos, sin, torch.float32,
                    all_logits=True, attn_impl=impl).numpy()
                qlen = args[2]
                for r, n in enumerate(qlen):
                    assert np.abs(full[r, :n] - jlog[r, :n]).max() < 1e-5
                jlog = jlog[np.arange(len(qlen)), qlen - 1]
                log = decode._paged_prefill_chunk(
                    model, *tpools, *targs, 8, cos, sin, torch.float32,
                    attn_impl=impl)
            else:
                log = decode._paged_decode_one(
                    model, *tpools, *targs, 8, cos, sin, torch.float32,
                    attn_impl=impl)
        assert np.abs(log.numpy() - jlog).max() < 1e-5
        got = _to(lambda p: _to(lambda x: x.numpy(), p), tpools)
        assert _pool_diff(got, jpools) < 1e-5
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode._paged_decode_one(model, *tpools, *(torch.from_numpy(a)
                                 for a in args), 8, cos, sin,
                                 torch.float32, attn_impl=impl, cp=2)


# ---------------------------------------------- (d) engine identity ----

def _counting_clock(tick=0.02):
    c = itertools.count()
    return lambda: next(c) * tick


def _drive(eng, reqs, stagger):
    """Submit, step, record the page table after every step; returns
    ({rid: tokens}, [tables])."""
    tables = []

    def step():
        eng.step()
        tables.append(eng._tbl.copy())

    eng.submit(reqs[0])
    eng.submit(reqs[1])
    for _ in range(stagger):
        step()
    for r in reversed(reqs[2:]):
        eng.submit(r)
    while eng.has_work():
        step()
    return {r.rid: r.tokens for r in eng.completed}, tables


GQA = {**SHAPE, "num_kv_heads": 2}
SLO_PROMPTS = [[0, 5, 9, 60, 2, 8, 33], [0, 11, 4, 7, 21, 35, 2],
               [0, 44, 17, 8, 52, 3, 71], [0, 9, 11, 13]]
ENGINE_CASES = {
    # (model shape, init seed, engine kwargs, prompts, request fields,
    #  max_new, steps before the late submissions)
    "native": (SHAPE, 7, dict(num_slots=2, page_size=8, prefill_chunk=4),
               PROMPTS, None, 10, 3),
    "int8": (SHAPE, 7, dict(num_slots=2, page_size=8, prefill_chunk=4,
                            kv_dtype="int8"), PROMPTS, None, 10, 3),
    "gqa": (GQA, 5, dict(num_slots=2, page_size=8, prefill_chunk=4),
            PROMPTS, None, 10, 3),
    "preempt": (SHAPE, 3, dict(num_slots=3, page_size=8, num_pages=4,
                               prefill_chunk=8), SLO_PROMPTS[:3], None, 12,
                0),
    "slo_preempt": (SHAPE, 3, dict(num_slots=2, page_size=8, num_pages=6,
                                   prefill_chunk=4),
                    SLO_PROMPTS, [("t0", "batch"), ("t1", "batch"),
                                  ("t0", "interactive"), ("t1", None)],
                    12, 4),
}


@pytest.fixture(scope="module", params=sorted(ENGINE_CASES))
def engine_case(request):
    """The JAX PagedEngine(gather) run of one case: tokens, tables, stats."""
    cfg_kw, seed, kw, prompts, fields, max_new, stagger = \
        ENGINE_CASES[request.param]
    jmodel, tree, _ = _models(cfg_kw, seed)
    mesh = jmake_mesh(JMeshConfig(tp=1))
    eng = jengine.PagedEngine(
        jmodel, mesh, jax.device_put(tree, jmodel.shardings(mesh)),
        buf_len=BUF, eos_id=EOS, paged_attn_impl="gather",
        clock=_counting_clock(), **kw)
    reqs = _requests(jengine.Request, prompts, fields, max_new)
    toks, tables = _drive(eng, reqs, stagger)
    return request.param, tree, toks, tables, eng.stats()


def _requests(cls, prompts, fields, max_new):
    fields = fields or [("default", None)] * len(prompts)
    return [cls(rid=i, prompt=list(p), max_new=max_new, tenant=t,
                slo_class=c) for i, (p, (t, c)) in
            enumerate(zip(prompts, fields))]


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_paged_engine_matches_jax(engine_case, impl):
    name, tree, ref, ref_tables, ref_stats = engine_case
    cfg_kw, _, kw, prompts, fields, max_new, stagger = ENGINE_CASES[name]
    model = Transformer(ModelConfig(**cfg_kw))
    model.load_state_dict(params_from_jax(tree))
    eng = PagedEngine(model, make_mesh(MeshConfig(), device="cpu"),
                      buf_len=BUF, eos_id=EOS, paged_attn_impl=impl,
                      clock=_counting_clock(), **kw)
    before = paged_attention.launches
    got, tables = _drive(eng, _requests(Request, prompts, fields, max_new),
                         stagger)
    assert paged_attention.launches == before      # CPU: the plain path
    assert sorted(got) == sorted(ref) == list(range(len(prompts)))
    for rid in ref:
        assert got[rid] == ref[rid], (name, impl, rid, got[rid], ref[rid])
    assert len(tables) == len(ref_tables)
    for i, (a, b) in enumerate(zip(tables, ref_tables)):
        assert np.array_equal(a, b), (name, impl, "step", i)
    stats = eng.stats()
    assert stats["paged_attn"] == impl
    assert stats == {k: (impl if k == "paged_attn" else ref_stats[k])
                     for k in stats}
    assert (eng.pool.refcount == 0).all() and stats["pages_in_use"] == 0
    if name == "native":
        assert stats["cow_copies"] > 0 and stats["prefix_hit_tokens"] > 0
    if "preempt" in name:
        assert stats["preemptions"] >= 1


# ------------------------------------------ (e) the SLO scheduler ------

def _scheduler_script(sched_mod, req_cls):
    """Submit/peek/take/requeue under a scripted clock; returns the trace
    of admissions, deadlines, service and refusals."""
    now = [0.0]
    s = sched_mod.SLOScheduler(64, classes=sched_mod.parse_slo_classes(
        "interactive=0.5,standard=2,batch=8"), max_queue=6,
        clock=lambda: now[0])
    mk = lambda rid, tenant, cls, n=4: req_cls(
        rid=rid, prompt=[3] * n, max_new=8, tenant=tenant, slo_class=cls)
    for r in (mk(0, "a", "batch"), mk(1, "a", "interactive", 20),
              mk(2, "b", "interactive"), mk(3, "b", "standard"),
              mk(4, "a", None), mk(5, "b", "interactive")):
        s.submit(r)
    trace = []
    try:
        s.submit(mk(6, "a", "batch"))
    except sched_mod.QueueFull:
        trace.append(("full", s.rejected))
    take = lambda: (lambda r: r and (r.rid, r.deadline_t))(s.take())
    trace += [take(), take()]               # class order, tenant fairness
    now[0] = 1.0
    first = s.take()
    trace.append((first.rid, dict(s.service)))
    s.requeue(first)                        # front of its lane, no recharge
    now[0] = 2.5                            # standard heads overdue: EDF
    trace += [take(), take()]
    now[0] = 9.0                            # the batch head overdue
    trace += [take() for _ in range(3)]
    trace.append((s.pending, dict(s.service), take()))
    with pytest.raises(ValueError, match="unknown SLO class"):
        s.submit(mk(9, "a", "gold"))
    return trace


def test_slo_scheduler_matches_jax():
    got = _scheduler_script(scheduler, Request)
    ref = _scheduler_script(jscheduler, jengine.Request)
    assert got == ref
    assert [t[0] for t in got[1:3]] == [1, 2]
    assert scheduler.parse_slo_classes("a=1, b=2.5") == {"a": 1.0, "b": 2.5}
    with pytest.raises(ValueError):
        scheduler.parse_slo_classes("a=0")


# ---------------------------------------------- (f) synthetic requests --

def test_synthetic_requests_with_knobs_match_jax():
    for arrival in ("burst", "poisson"):
        kw = dict(num=9, prompt_len_min=4, prompt_len_max=12, max_new=8,
                  vocab_size=96, seed=3, arrival=arrival,
                  class_mix={"interactive": 1, "standard": 2, "batch": 1},
                  tenants=3, shared_prefix_len=5, interleave=True)
        a, b = synthetic_requests(**kw), jsynthetic_requests(**kw)
        key = lambda r: (r.rid, r.prompt, r.max_new, r.seed, r.arrival,
                         r.tenant, r.slo_class)
        assert [key(r) for r in a] == [key(r) for r in b]
        assert all(r.prompt[:5] == a[0].prompt[:5] for r in a)


# ------------------------------------------------------ (g) the CLI ----

def test_serve_paged_dry_run_cpu(capsys):
    for extra, kv in (([], "native"), (["--kv_dtype", "int8",
                                        "--paged_attn", "pallas"], "int8")):
        out = serve.main(["--paged", "--dry_run", "--device", "cpu", *extra])
        assert out["completed"] == out["requests"] == 6
        stats = out["engine_stats"]
        assert stats["pages_in_use"] == 0 and stats["prefix_hit_tokens"] > 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["paged_attn"] == "kernel" and rec["kv_dtype"] == kv
        for key in ("kv_util_mean", "prefix_hit_rate", "cow_copies",
                    "preemptions", "slo_attainment", "num_pages"):
            assert key in rec
    out = serve.main(["--paged", "--dry_run", "--device", "cpu",
                      "--paged_attn", "gather"])
    assert out["engine_stats"]["paged_attn"] == "gather"


@pytest.mark.parametrize("flags", [
    ["--paged", "--cp", "2"], ["--paged", "--speculate", "2"],
    ["--paged_attn", "gather"], ["--kv_dtype", "int8"]])
def test_serve_paged_refusals(flags):
    with pytest.raises(SystemExit) as e:
        serve.main(["--dry_run", "--device", "cpu", *flags])
    assert e.value.code == 2


def test_serve_paged_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        serve.main(["--paged", "--dry_run"])
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code)


def _int8_dry_run(capsys, extra):
    """`serve --dry_run --decode_weight_dtype int8` against the native dry
    run: every request served, about a quarter of the resident weight
    bytes, the dtype in the JSON record."""
    capsys.readouterr()
    out = serve.main(["--dry_run", "--device", "cpu", "--decode_weight_dtype",
                      "int8", *extra])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    native = serve.main(["--dry_run", "--device", "cpu", *extra])
    assert out["completed"] == out["requests"] == 6
    assert rec["decode_weight_dtype"] == "int8"
    st, ref = out["engine_stats"], native["engine_stats"]
    assert (st["decode_weight_dtype"], ref["decode_weight_dtype"]) == (
        "int8", "native")
    assert 0.25 < st["weight_bytes"] / ref["weight_bytes"] < 0.3
    return out


def test_serve_paged_int8_decode_weights_cpu(capsys):
    """--paged --decode_weight_dtype int8, once refused, serves the paged
    engine."""
    out = _int8_dry_run(capsys, ["--paged"])
    assert out["engine_stats"]["pages_in_use"] == 0
