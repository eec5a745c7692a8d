"""The port's CUDA kernels: build plumbing (CPU) and the kernels themselves
— the flash-attention forward, the backward pair (dq, dk/dv), paged
attention and the positional block kernels of ring attention (forward, dq,
dk/dv) — against their plain versions (marker `cuda`, needs a card).

This file imports torch and the port only — no jax — so the card tests run
on a machine without jax:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu_torch.ops.cuda import build
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.block_attention import (
    BlockAttention, block_attention_bwd, block_attention_bwd_plain,
    block_attention_fwd, block_attention_plain, rounding_slack)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
    MASK, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
    paged_attention, paged_attention_plain)

# (b, h, hkv, t, d, t_real): MHA, GQA with padding rows, t not a multiple of
# 64, the 45m prefill shape, head_dim 128
CASES = [(2, 4, 4, 128, 32, None), (1, 4, 2, 200, 32, 150),
         (2, 2, 1, 77, 64, None), (4, 8, 8, 512, 64, None),
         (1, 2, 2, 130, 128, 100)]


def test_sources_and_build_targets():
    assert "flash_fwd" in build.all_sources()
    assert "flash_bwd" in build.all_sources()
    assert "paged_attn" in build.all_sources()
    assert "block_attn" in build.all_sources()
    a = build._target("flash_fwd")
    assert a == build._target("flash_fwd")        # content-addressed
    assert a.parent == build.BUILD_DIR and a.name.startswith("flash_fwd-")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype):
    torch_dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 3e-2
    for b, h, hkv, t, d, t_real in CASES:
        rng = np.random.default_rng(t)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, n, t, d),
                                                        dtype=np.float32))
                   .to(cuda_device, torch_dtype) for n in (h, hkv, hkv))
        before = flash_attention_fwd.launches
        o, lse = flash_attention_fwd(q, k, v, t_real=t_real)
        torch.cuda.synchronize()
        assert flash_attention_fwd.launches == before + 1
        ro, rlse = flash_attention_fwd_plain(q, k, v, t_real=t_real)
        assert (o.float() - ro.float()).abs().max().item() < tol
        live = t_real or t
        assert (lse - rlse)[..., :live].abs().max().item() < 1e-3
        if t_real is not None:
            assert (o[:, :, t_real:] == 0).all()
            assert (lse[:, :, t_real:] == MASK).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, dtype):
    """Both backward kernels against the plain backward: error relative to
    the largest |gradient| within 1e-4 (f32: summation order) or 1e-2
    (bf16: also one rounding step of the outputs); pad rows and pad keys
    exactly zero; one launch of each kernel per call."""
    torch_dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 1e-2
    for b, h, hkv, t, d, t_real in CASES:
        rng = np.random.default_rng(t + 1)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (b, n, t, d), dtype=np.float32)).to(cuda_device, torch_dtype)
            for n in (h, hkv, hkv, h))
        o, lse = flash_attention_fwd_plain(q, k, v, t_real=t_real)
        before = (flash_attention_bwd.launches_dq,
                  flash_attention_bwd.launches_dkv)
        got = flash_attention_bwd(q, k, v, o, lse, do, t_real=t_real)
        torch.cuda.synchronize()
        assert (flash_attention_bwd.launches_dq,
                flash_attention_bwd.launches_dkv) == (before[0] + 1,
                                                      before[1] + 1)
        ref = flash_attention_bwd_plain(q, k, v, o, lse, do, t_real=t_real)
        for x, r in zip(got, ref):
            assert x.dtype == r.dtype and x.shape == r.shape
            err = (x.float() - r.float()).abs().max().item()
            assert err <= tol * r.float().abs().max().item()
            if t_real is not None:
                assert (x[:, :, t_real:] == 0).all()


# (b, heads, kv_heads, cw, hd, page_size, max_pages, int8, with qlen):
# decode (MHA, the 45m shape's head_dim), GQA decode with small pages, the
# chunk shape with GQA and per-row qlen, int8 pools, head_dim 32 and 128
PAGED_CASES = [(4, 8, 8, 1, 64, 64, 6, False, False),
               (3, 8, 2, 1, 32, 8, 9, False, False),
               (3, 8, 2, 4, 64, 16, 5, False, True),
               (2, 4, 4, 8, 128, 16, 4, True, True),
               (4, 8, 8, 1, 64, 64, 6, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_matches_plain_on_card(cuda_device, dtype):
    """The paged kernel against its plain version, element by element: f32
    within 1e-5 of max(1, the largest |o|) (sum order); bf16 within one bf16
    step of the plain element plus 1e-5 of its row's largest |o| (both keep
    p and v in f32 and round o once); valid columns only where qlen is
    given; one launch per call."""
    torch_dtype = getattr(torch, dtype)
    for i, (b, h, kvh, cw, hd, ps, mp, int8, with_qlen) in enumerate(
            PAGED_CASES):
        rng = np.random.default_rng(100 + i)
        n_pages = b * mp
        shape = (n_pages + 1, kvh, ps, hd)
        if int8:
            pools = [(torch.from_numpy(rng.integers(-127, 128, shape)
                                       .astype(np.int8)).to(cuda_device),
                      torch.from_numpy(rng.uniform(0.01, 0.05, shape[:3])
                                       .astype(np.float32)).to(cuda_device))
                     for _ in range(2)]
        else:
            pools = [torch.from_numpy(rng.standard_normal(shape,
                                                          dtype=np.float32))
                     .to(cuda_device, torch_dtype) for _ in range(2)]
        tbl = torch.from_numpy(rng.permutation(n_pages)[:b * mp]
                               .reshape(b, mp).astype(np.int32))
        start = rng.integers(0, mp * ps - cw + 1, b).astype(np.int32)
        start[0] = 0
        qlen = (rng.integers(1, cw + 1, b).astype(np.int32) if with_qlen
                else None)
        q = torch.from_numpy(rng.standard_normal((b, h, cw, hd),
                                                 dtype=np.float32))
        args = (q.to(cuda_device, torch_dtype), *pools, tbl.to(cuda_device),
                torch.from_numpy(start).to(cuda_device))
        kw = dict(page_size=ps, qlen=None if qlen is None
                  else torch.from_numpy(qlen).to(cuda_device))
        before = paged_attention.launches
        o = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        r = paged_attention_plain(*args, **kw)
        for row in range(b):
            n = cw if qlen is None else int(qlen[row])
            x = r[row, :, :n].float()
            err = (o[row, :, :n].float() - x).abs()
            if dtype == "float32":
                tol = 1e-5 * max(1.0, r.float().abs().max().item())
            else:
                _, e = torch.frexp(x.abs())   # |x| in [2^(e-1), 2^e)
                tol = (torch.where(x == 0, 0.0, torch.exp2((e - 8).float()))
                       + 1e-5 * x.abs().amax(-1, keepdim=True))
            assert (err <= tol).all(), (i, row, err.max().item())
        assert torch.isfinite(o.float()).all()


def _bf16_limit(r: torch.Tensor, slack: torch.Tensor) -> torch.Tensor:
    """One bf16 step of each plain element + its rounding slack + 1e-5 of
    its row's largest |value|."""
    _, e = torch.frexp(r.abs())   # |r| in [2^(e-1), 2^e)
    step = torch.where(r == 0, 0.0, torch.exp2((e - 8).float()))
    return step + slack + 1e-5 * r.abs().amax(-1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_kernels_match_plain_on_card(cuda_device, dtype):
    """The three block kernels against their plain versions on one ragged
    GQA block (tq 90, tk 200, h 8 / hkv 2) whose first rows see nothing,
    with random (do, dlse): f32 within 1e-5 of max(1, the tensor's largest
    |value|) (sum order); bf16 per element within one bf16 step of the plain
    value plus what rounding p and ds can move it by (`rounding_slack`) plus
    1e-5 of its row's largest |value|; dead rows exactly o = 0,
    lse = -1e30, dq = 0; one launch of each kernel per call, and
    `BlockAttention` runs the same kernels."""
    torch_dtype = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    b, h, hkv, tq, tk, d = 2, 8, 2, 90, 200, 64
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    q, k, v, do = (x.to(cuda_device, torch_dtype) for x in (
        f(b, h, tq, d), f(b, hkv, tk, d), f(b, hkv, tk, d), f(b, h, tq, d)))
    dlse = f(b, h, tq).to(cuda_device)
    qp = torch.from_numpy(rng.integers(0, 400, (b, tq)).astype(np.int32))
    qp[:, :5] = 0
    kp = torch.from_numpy(rng.integers(50, 450, (b, tk)).astype(np.int32))
    qp, kp = qp.to(cuda_device), kp.to(cuda_device)
    before = (block_attention_fwd.launches, block_attention_bwd.launches_dq,
              block_attention_bwd.launches_dkv)
    o, lse = block_attention_fwd(q, k, v, qp, kp)
    ro, rlse = block_attention_plain(q, k, v, qp, kp)
    got = block_attention_bwd(q, k, v, qp, kp, ro, rlse, do, dlse)
    torch.cuda.synchronize()
    assert (block_attention_fwd.launches, block_attention_bwd.launches_dq,
            block_attention_bwd.launches_dkv) == tuple(n + 1 for n in before)
    ref = block_attention_bwd_plain(q, k, v, qp, kp, ro, rlse, do, dlse)
    slack = rounding_slack(q, k, v, qp, kp, ro, rlse, do, dlse)
    for name, x, r in zip(("o", "dq", "dk", "dv"), (o, *got), (ro, *ref)):
        assert x.dtype == r.dtype and x.shape == r.shape
        x, r = x.float(), r.float()
        if dtype == "float32":
            tol = 1e-5 * max(1.0, r.abs().max().item())
        else:
            tol = _bf16_limit(r, slack[name])
        assert ((x - r).abs() <= tol).all(), name
    dead = rlse <= -1e30 / 2
    assert dead[:, :, :5].all()
    assert (lse[dead] == -1e30).all() and (o.float()[dead] == 0).all()
    assert (got[0].float()[dead] == 0).all()
    live = ~dead
    assert (lse - rlse)[live].abs().max().item() <= 1e-5 * max(
        1.0, rlse[live].abs().max().item())
    # the autograd Function launches the same kernels, forward and backward
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fo, flse = BlockAttention.apply(*leaves, qp, kp)
    torch.autograd.backward([fo, flse], [do, dlse])
    assert torch.equal(fo, o) and torch.equal(flse, lse)
    assert block_attention_fwd.launches == before[0] + 2
    assert block_attention_bwd.launches_dq == before[1] + 2


@pytest.mark.cuda
def test_block_kernels_round_p_as_plain_on_one_key_tile(cuda_device):
    """bf16 on one key tile (tk 20; the kernels' tile is 32 keys): the
    running row max is the final one, so the kernel rounds p where the plain
    version does. q, k, v and do on a grid of halves make every score and
    dp exact in any sum order, so p and ds are the same bits on both sides:
    o, dq, dk and dv within one bf16 step of each element plus 1e-5 of its
    row's largest |value|, with no rounding slack. A kernel that skipped
    rounding p (or ds) to bf16 would miss this by far more."""
    rng = np.random.default_rng(11)
    b, h, tq, tk, d = 2, 8, 100, 20, 64
    grid = lambda *s: torch.from_numpy(np.clip(np.round(
        2 * rng.standard_normal(s)), -3, 3).astype(np.float32) / 2)
    q, k, v, do = (x.to(cuda_device, torch.bfloat16) for x in (
        grid(b, h, tq, d), grid(b, h, tk, d), grid(b, h, tk, d),
        grid(b, h, tq, d)))
    dlse = torch.from_numpy(rng.standard_normal((b, h, tq)).astype(
        np.float32)).to(cuda_device)
    qp = (10 + torch.arange(tq, device=cuda_device, dtype=torch.int32)
          ).expand(b, tq).contiguous()
    kp = torch.arange(tk, device=cuda_device, dtype=torch.int32
                      ).expand(b, tk).contiguous()
    o, _ = block_attention_fwd(q, k, v, qp, kp)
    ro, rlse = block_attention_plain(q, k, v, qp, kp)
    got = block_attention_bwd(q, k, v, qp, kp, ro, rlse, do, dlse)
    ref = block_attention_bwd_plain(q, k, v, qp, kp, ro, rlse, do, dlse)
    for name, x, r in zip(("o", "dq", "dk", "dv"), (o, *got), (ro, *ref)):
        x, r = x.float(), r.float()
        assert ((x - r).abs() <= _bf16_limit(r, 0.0)).all(), name


def test_one_key_tile_limit_catches_unrounded_p():
    """The no-slack limit of the one-key-tile card test (CPU: the plain
    forward stands for a right kernel) separates the two roundings: a
    forward that sums the same bf16-rounded p in another order stays within
    it, one that skips rounding p to bf16 misses it."""
    rng = np.random.default_rng(11)
    b, h, tq, tk, d = 2, 8, 100, 20, 64
    grid = lambda *s: torch.from_numpy(np.clip(np.round(
        2 * rng.standard_normal(s)), -3, 3).astype(np.float32) / 2)
    q, k, v = (x.to(torch.bfloat16) for x in (
        grid(b, h, tq, d), grid(b, h, tk, d), grid(b, h, tk, d)))
    qp = (10 + torch.arange(tq, dtype=torch.int32)).expand(b, tq)
    kp = torch.arange(tk, dtype=torch.int32).expand(b, tk)
    ro, _ = block_attention_plain(q, k, v, qp, kp)
    r = ro.float()
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / d ** 0.5
    live = qp[:, None, :, None] >= kp[:, None, None, :]
    s = s.masked_fill(~live, MASK)
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)

    def forward(pv):   # keys summed last to first, one at a time
        acc = torch.zeros(b, h, tq, d)
        for j in reversed(range(tk)):
            acc = acc + pv[..., j:j + 1] * v.float()[:, :, j:j + 1]
        return (acc / l).to(torch.bfloat16).float()

    limit = _bf16_limit(r, 0.0)
    assert ((forward(p.to(torch.bfloat16).float()) - r).abs() <= limit).all()
    assert not ((forward(p) - r).abs() <= limit).all()
