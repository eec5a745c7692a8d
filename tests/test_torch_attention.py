"""The port's attention (PyTorch) against the JAX package's.

* `flash_attention_fwd_plain` — the plain version of the CUDA flash kernel —
  against the JAX Pallas `flash_attention` run in interpret mode on the CPU
  (as tests/test_flash_attention.py runs it), and its lse against
  `_fwd_call`'s;
* `causal_attention_plain` against `causal_attention_xla`;
* the kernel wrapper on a CPU tensor is its plain version and launches
  nothing (tests/test_torch_cuda.py holds the kernel itself on the card).

Tolerance 1e-5 at f32 (the JAX suite's flash-vs-XLA bound); 3e-2 at bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu.ops.attention import (
    causal_attention_xla)
from distributed_pytorch_from_scratch_tpu.ops.pallas.flash_attention import (
    _fwd_call, flash_attention)
from distributed_pytorch_from_scratch_tpu_torch.ops.attention import (
    causal_attention, causal_attention_plain)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
    MASK, flash_attention_fwd, flash_attention_fwd_plain)
from _torch_threads import two_torch_threads  # noqa: F401


# (b, h, hkv, t, d, t_real): MHA, GQA with padding rows, t not a multiple of 64
CASES = [(2, 4, 4, 128, 32, None), (1, 4, 2, 200, 32, 150),
         (2, 2, 1, 77, 64, None)]


def _inputs(b, h, hkv, t, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t, d)).astype(dtype)
    k = rng.standard_normal((b, hkv, t, d)).astype(dtype)
    v = rng.standard_normal((b, hkv, t, d)).astype(dtype)
    return q, k, v


def _jax_lse(q, k, v, t_real):
    """Row logsumexp from the TPU kernel's own call (interpreted)."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    t_pad = -(-t // 128) * 128
    prep = lambda x: jnp.pad(jnp.asarray(x).reshape(-1, t, d),
                             ((0, 0), (0, t_pad - t), (0, 0)))
    _, lse = _fwd_call(prep(q), prep(k), prep(v), t_real=t_real or t,
                       block_q=128, block_k=128, hq=h, hkv=hkv)
    return np.asarray(lse)[:, :t, 0].reshape(b, h, t)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_plain_matches_jax_flash_f32(case):
    b, h, hkv, t, d, t_real = case
    q, k, v = _inputs(b, h, hkv, t, d, seed=t)
    ref = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), t_real=t_real))
    o, lse = flash_attention_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), t_real=t_real)
    assert o.dtype == torch.float32 and o.shape == (b, h, t, d)
    assert np.abs(o.numpy() - ref).max() < 1e-5
    ref_lse = _jax_lse(q, k, v, t_real)
    live = t_real or t
    assert np.abs(lse.numpy()[..., :live] - ref_lse[..., :live]).max() < 1e-5
    if t_real is not None:
        # pad rows: exact zeros, lse = MASK, in both packages
        assert (o[:, :, t_real:] == 0).all()
        assert (lse[:, :, t_real:] == MASK).all()
        assert (ref[:, :, t_real:] == 0).all()
        assert (ref_lse[:, :, t_real:] == MASK).all()


def test_flash_plain_matches_jax_flash_bf16():
    b, h, hkv, t, d = 1, 4, 2, 192, 64
    q, k, v = _inputs(b, h, hkv, t, d, seed=5)
    to_jax = lambda x: jnp.asarray(x, jnp.bfloat16)
    to_torch = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    ref = flash_attention(to_jax(q), to_jax(k), to_jax(v), t_real=160)
    o, _ = flash_attention_fwd_plain(to_torch(q), to_torch(k), to_torch(v),
                                     t_real=160)
    assert o.dtype == torch.bfloat16
    err = np.abs(o.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert err.max() < 3e-2


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_causal_attention_plain_matches_xla_f32(case):
    b, h, hkv, t, d, t_real = case
    q, k, v = _inputs(b, h, hkv, t, d, seed=t + 1)
    ref = np.asarray(causal_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), t_real=t_real))
    out = causal_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), t_real=t_real)
    assert np.abs(out.numpy() - ref).max() < 1e-5
    # the flash plain version computes the same attention (hard mask vs
    # -10000: both give probability exactly 0 to masked keys)
    o, _ = flash_attention_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), t_real=t_real)
    assert np.abs(o.numpy() - ref).max() < 1e-5


def test_wrapper_on_cpu_is_plain_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 96, 32, seed=3))
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, t_real=70)
    ro, rlse = flash_attention_fwd_plain(q, k, v, t_real=70)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert flash_attention_fwd.launches == before
    # causal_attention's auto dispatch takes the plain path on a CPU tensor
    assert torch.equal(causal_attention(q, k, v),
                       causal_attention_plain(q, k, v))
    assert flash_attention_fwd.launches == before


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 3, 16, 32)
    kv = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention_fwd(q, kv, kv)
    with pytest.raises(ValueError, match="t_real"):
        flash_attention_fwd(torch.zeros(1, 2, 16, 32), kv, kv, t_real=17)
