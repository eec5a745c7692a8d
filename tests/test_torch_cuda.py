"""The port's CUDA kernels: build plumbing (CPU) and the kernels themselves
— the flash-attention forward and the backward pair (dq, dk/dv) — against
their plain versions (marker `cuda`, needs a card).

This file imports torch and the port only — no jax — so the card tests run
on a machine without jax:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu_torch.ops.cuda import build
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
    MASK, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)

# (b, h, hkv, t, d, t_real): MHA, GQA with padding rows, t not a multiple of
# 64, the 45m prefill shape, head_dim 128
CASES = [(2, 4, 4, 128, 32, None), (1, 4, 2, 200, 32, 150),
         (2, 2, 1, 77, 64, None), (4, 8, 8, 512, 64, None),
         (1, 2, 2, 130, 128, 100)]


def test_sources_and_build_targets():
    assert "flash_fwd" in build.all_sources()
    assert "flash_bwd" in build.all_sources()
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
