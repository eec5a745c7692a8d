"""The port's CUDA kernels: build plumbing (CPU) and the kernels themselves
— the flash-attention forward and backward pair (dq, dk/dv) on both routes
(bf16: the wgmma kernels; f32: the SIMT ones), paged attention and the
positional block kernels of ring attention (forward, dq, dk/dv) — against
their plain versions (marker `cuda`, needs a card).

This file imports torch and the port only — no jax — so the card tests run
on a machine without jax:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distributed_pytorch_from_scratch_tpu_torch.config import (
    resolve_dtype_on)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda import build
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.block_attention import (
    BlockAttention, block_attention_bwd, block_attention_bwd_plain,
    block_attention_fwd, block_attention_plain, kernel_route, rounding_slack)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
    MASK, bf16_limit, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.flash_attention import (
    rounding_slack as flash_rounding_slack)
from distributed_pytorch_from_scratch_tpu_torch.ops.cuda.paged_attention import (
    kernel_route as paged_kernel_route, paged_attention, paged_attention_plain)

# (b, h, hkv, t, d, t_real): MHA, GQA with padding rows, t not a multiple of
# 64, the 45m prefill shape, head_dim 128; then the edges of the wgmma
# kernels' 64-row tiles (t 1, 63, 64, 65, 127, 129, 1000) at head_dim 32, 64
# and 128, GQA groups 2 and 4, t_real < t
CASES = [(2, 4, 4, 128, 32, None), (1, 4, 2, 200, 32, 150),
         (2, 2, 1, 77, 64, None), (4, 8, 8, 512, 64, None),
         (1, 2, 2, 130, 128, 100),
         (1, 8, 2, 1, 64, None), (2, 4, 1, 63, 32, None),
         (2, 4, 2, 64, 64, 50), (1, 4, 4, 65, 128, None),
         (2, 8, 2, 127, 64, 100), (1, 4, 2, 129, 128, 128),
         (1, 8, 4, 1000, 64, 999)]


def test_sources_and_build_targets():
    assert build.all_sources() == ["block_attn", "block_attn_sm90",
                                   "flash_bwd", "flash_bwd_sm90",
                                   "flash_fwd", "flash_fwd_sm90",
                                   "paged_attn", "paged_chunk_sm90",
                                   "paged_decode"]
    assert (build.CSRC / "sm90.cuh").is_file()
    a = build._target("flash_fwd")
    assert a == build._target("flash_fwd")        # content-addressed
    assert a.parent == build.BUILD_DIR and a.name.startswith("flash_fwd-")
    assert build._target("flash_fwd_sm90").name.startswith("flash_fwd_sm90-")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_block_kernel_route_by_dtype(head_dim):
    """K2's kernels by dtype, dispatch and not fallback: bf16 to the wgmma
    source, f32 to the SIMT one, at every built head_dim; anything else
    raises before a launch."""
    assert kernel_route(torch.bfloat16, head_dim) == ("block_attn_sm90",
                                                      "_sm90")
    assert kernel_route(torch.float32, head_dim) == ("block_attn", "")
    with pytest.raises(ValueError, match="dtype torch.float16 not built"):
        kernel_route(torch.float16, head_dim)
    with pytest.raises(ValueError, match="head_dim 48 not built"):
        kernel_route(torch.bfloat16, 48)
    for source, _ in (kernel_route(torch.bfloat16, head_dim),
                      kernel_route(torch.float32, head_dim)):
        assert source in build.all_sources()


def test_float16_refused_on_a_card_only():
    """float16 has no kernel on the card: the dtype is refused for a CUDA
    device (string or torch.device, before a model builds any weights when
    it is given its mesh) and taken on the CPU, as in JAX."""
    from types import SimpleNamespace
    from distributed_pytorch_from_scratch_tpu_torch.config import model_preset
    from distributed_pytorch_from_scratch_tpu_torch.models.transformer import (
        Transformer)
    msg = "the port's kernels take float32 and bfloat16"
    for device in ("cuda", "cuda:0", torch.device("cuda", 1)):
        with pytest.raises(ValueError, match=msg):
            resolve_dtype_on("float16", device)
        assert resolve_dtype_on("bfloat16", device) == torch.bfloat16
        assert resolve_dtype_on("float32", device) == torch.float32
    assert resolve_dtype_on("float16", "cpu") == torch.float16
    assert resolve_dtype_on("float16", torch.device("cpu")) == torch.float16
    cfg = model_preset("tiny", compute_dtype="float16")
    card = SimpleNamespace(device=torch.device("cuda"), cp=1)
    with pytest.raises(ValueError, match=msg):
        Transformer(cfg, mesh=card)
    model = Transformer(cfg, remat=False).init_weights(seed=0)
    ids = torch.zeros((1, 4), dtype=torch.long)
    logits = model(ids, torch.arange(4)[None])
    assert logits.dtype == torch.float16 and logits.shape == (1, 4, 1024)


def test_editing_a_header_changes_every_target(monkeypatch, tmp_path):
    """A source includes the shared headers, so each target's name hashes
    them too: editing a `.cuh` rebuilds, and a stale `.so` is never
    reused."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    before = build._target("a")
    assert build._target("a") == before
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert build._target("a") != before
    (tmp_path / "h.cuh").write_text("// v1\n")
    assert build._target("a") == before
    (tmp_path / "g.cuh").write_text("// new header\n")
    assert build._target("a") != before


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


def _flash_inputs(seed, shapes, device, dtype, grid=False):
    """Standard normal tensors from a numpy seed (on the grid of halves
    {-1.5, ..., 1.5} with `grid`), cast to dtype on device."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = rng.standard_normal(shape, dtype=np.float32)
        if grid:
            x = np.clip(np.round(2 * x), -3, 3).astype(np.float32) / 2
        out.append(torch.from_numpy(x).to(device, dtype))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype):
    """The forward kernel of the dtype's route against the plain forward:
    f32 within 1e-4 (sum order); bf16 per element within one bf16 step +
    what rounding p against the running max can move it (`rounding_slack`)
    + 1e-5 of its row's max; lse within 1e-3; pad rows exactly o = 0,
    lse = -1e30; one launch per call."""
    torch_dtype = getattr(torch, dtype)
    for b, h, hkv, t, d, t_real in CASES:
        q, k, v = _flash_inputs(t, [(b, n, t, d) for n in (h, hkv, hkv)],
                                cuda_device, torch_dtype)
        before = flash_attention_fwd.launches
        o, lse = flash_attention_fwd(q, k, v, t_real=t_real)
        torch.cuda.synchronize()
        assert flash_attention_fwd.launches == before + 1
        ro, rlse = flash_attention_fwd_plain(q, k, v, t_real=t_real)
        err = (o.float() - ro.float()).abs()
        if dtype == "float32":
            assert err.max().item() < 1e-4
        else:
            slack = flash_rounding_slack(q, k, v, ro, rlse,
                                         torch.zeros_like(q), t_real)["o"]
            assert (err <= bf16_limit(ro, slack)).all(), (t, d, t_real)
        live = t_real or t
        assert (lse - rlse)[..., :live].abs().max().item() < 1e-3
        if t_real is not None:
            assert (o[:, :, t_real:] == 0).all()
            assert (lse[:, :, t_real:] == MASK).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, dtype):
    """Both backward kernels of the dtype's route against the plain
    backward: f32 within 1e-4 of the largest |gradient| plus the sum order
    of dp carried through ds (`rounding_slack` of f32 inputs; at t 1 every
    dq and dk value is that noise); bf16 per element within one bf16 step +
    what rounding p and ds can move it (`rounding_slack`) + 1e-5 of its
    row's max; pad rows and pad keys exactly zero; one launch of each
    kernel per call; a second call gives the same bits (no atomics)."""
    torch_dtype = getattr(torch, dtype)
    for b, h, hkv, t, d, t_real in CASES:
        q, k, v, do = _flash_inputs(
            t + 1, [(b, n, t, d) for n in (h, hkv, hkv, h)], cuda_device,
            torch_dtype)
        o, lse = flash_attention_fwd_plain(q, k, v, t_real=t_real)
        before = (flash_attention_bwd.launches_dq,
                  flash_attention_bwd.launches_dkv)
        got = flash_attention_bwd(q, k, v, o, lse, do, t_real=t_real)
        torch.cuda.synchronize()
        assert (flash_attention_bwd.launches_dq,
                flash_attention_bwd.launches_dkv) == (before[0] + 1,
                                                      before[1] + 1)
        again = flash_attention_bwd(q, k, v, o, lse, do, t_real=t_real)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        ref = flash_attention_bwd_plain(q, k, v, o, lse, do, t_real=t_real)
        slack = flash_rounding_slack(q, k, v, o, lse, do, t_real)
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            assert x.dtype == r.dtype and x.shape == r.shape
            err = (x.float() - r.float()).abs()
            if dtype == "float32":
                assert (err <= slack[name] + 1e-4 * r.float().abs().max()
                        ).all(), (t, name)
            else:
                assert (err <= bf16_limit(r, slack[name])).all(), (t, name)
            if t_real is not None:
                assert (x[:, :, t_real:] == 0).all()


@pytest.mark.cuda
def test_flash_kernels_round_p_as_plain_on_one_key_tile(cuda_device):
    """bf16, t 60 <= the wgmma kernels' 64-key tile: the running row max is
    the final one, so the forward rounds p where the plain version does. q,
    k, v and do on a grid of halves make every score and dp exact in any
    sum order, so p and ds are the same bits on both sides: o, dq, dk and
    dv within one bf16 step of each element plus 1e-5 of its row's largest
    |value|, with no rounding slack. A kernel that skipped rounding p (or
    ds) to bf16 would miss this by far more."""
    b, h, t, d = 2, 8, 60, 64
    q, k, v, do = _flash_inputs(11, [(b, h, t, d)] * 4, cuda_device,
                                torch.bfloat16, grid=True)
    o, _ = flash_attention_fwd(q, k, v)
    ro, rlse = flash_attention_fwd_plain(q, k, v)
    got = flash_attention_bwd(q, k, v, ro, rlse, do)
    ref = flash_attention_bwd_plain(q, k, v, ro, rlse, do)
    for name, x, r in zip(("o", "dq", "dk", "dv"), (o, *got), (ro, *ref)):
        assert ((x.float() - r.float()).abs() <= bf16_limit(r, 0.0)).all(), \
            name


def test_flash_one_key_tile_limit_catches_unrounded_p():
    """The no-slack limit of the one-key-tile card test (CPU: the plain
    forward stands for a right kernel) separates the two roundings: a
    forward that sums the same bf16-rounded p in another order stays within
    it, one that skips rounding p to bf16 misses it."""
    b, h, t, d = 2, 8, 60, 64
    q, k, v = _flash_inputs(11, [(b, h, t, d)] * 3, "cpu", torch.bfloat16,
                            grid=True)
    ro, _ = flash_attention_fwd_plain(q, k, v)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / d ** 0.5
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    s = s.masked_fill(~causal, MASK)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)

    def forward(pv):   # keys summed last to first, one at a time
        acc = torch.zeros(b, h, t, d)
        for j in reversed(range(t)):
            acc = acc + pv[..., j:j + 1] * v.float()[:, :, j:j + 1]
        return (acc / l).to(torch.bfloat16).float()

    limit = bf16_limit(ro, 0.0)
    assert ((forward(p.to(torch.bfloat16).float()) - ro.float()).abs()
            <= limit).all()
    assert not ((forward(p) - ro.float()).abs() <= limit).all()


def test_flash_rounding_slack_is_the_block_rule_on_causal_positions():
    """K1's rounding slack is K2's (`block_attention.rounding_slack`) with
    positions 0..t-1 on both sides, no dlse, and the pad rows and keys of
    t_real dead, plus, for dq and dk, the f32 sum order of dp carried
    through ds: p d 2^-22 (|do| @ |v|^T) scale, times |k| and |q|. It is
    what holds a row that sees one key, where ds cancels to 0."""
    b, h, hkv, t, d, t_real = 2, 4, 2, 70, 32, 57
    q, k, v, do = (x.to(torch.bfloat16) for x in _flash_inputs(
        5, [(b, n, t, d) for n in (h, hkv, hkv, h)], "cpu", torch.float32))
    o, lse = flash_attention_fwd_plain(q, k, v, t_real=t_real)
    got = flash_rounding_slack(q, k, v, o, lse, do, t_real)
    pos = torch.arange(t, dtype=torch.int32).expand(b, t).clone()
    kv_pos = pos.clone()
    kv_pos[:, t_real:] = 10 ** 6              # pad keys: seen by no row
    q_pos = pos.clone()
    q_pos[:, t_real:] = -1                    # pad rows: see no key
    want = rounding_slack(q, k, v, q_pos, kv_pos, o, lse, do,
                          torch.zeros(b, h, t))
    rep = lambda x: torch.repeat_interleave(x, h // hkv, dim=1).float()
    s = torch.matmul(q.float(), rep(k).transpose(-1, -2)) / d ** 0.5
    live = ((pos[0, None, :] <= pos[0, :, None]) & (pos[0, :, None] < t_real)
            & (pos[0, None, :] < t_real))
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    extra = p * d * 2.0 ** -22 * torch.matmul(
        do.float().abs(), rep(v).abs().transpose(-1, -2)) / d ** 0.5
    per_kv = lambda x: x.reshape(b, hkv, h // hkv, t, d).sum(dim=2)
    want["dq"] = want["dq"] + torch.matmul(extra, rep(k).abs())
    want["dk"] = want["dk"] + per_kv(torch.matmul(extra.transpose(-1, -2),
                                                  q.float().abs()))
    for name in ("o", "dv"):
        assert torch.equal(got[name], want[name]), name
    for name in ("dq", "dk"):
        assert torch.allclose(got[name], want[name], rtol=1e-6, atol=0), name
    assert (got["o"][:, :, t_real:] == 0).all()
    assert (got["dq"][:, :, 0] > 0).all()     # row 0 sees one key: ds = 0


# (b, heads, kv_heads, cw, hd, page_size, max_pages, int8, with qlen):
# decode (MHA, the 45m shape's head_dim), GQA decode with small pages, the
# chunk shape with GQA and per-row qlen, int8 pools, head_dim 32 and 128;
# then decode at b 1, whose one row (cursor 0) sees one key, and GQA g 8
# decode at page_size 8 (two blocks of rows, sub-tiles across pages); then
# the bf16 chunk kernel's edges: a ragged 64-row tile (cw 65), row tiles
# spanning heads (GQA g 4, cw 32), int8 pools at head_dim 128 and at head_dim
# 32 with key tiles across pages of 8
PAGED_CASES = [(4, 8, 8, 1, 64, 64, 6, False, False),
               (3, 8, 2, 1, 32, 8, 9, False, False),
               (3, 8, 2, 4, 64, 16, 5, False, True),
               (2, 4, 4, 8, 128, 16, 4, True, True),
               (4, 8, 8, 1, 64, 64, 6, True, False),
               (1, 8, 8, 1, 64, 64, 4, False, False),
               (3, 16, 2, 1, 64, 8, 30, False, False),
               (2, 8, 8, 65, 64, 64, 4, False, True),
               (2, 16, 4, 32, 64, 16, 10, False, True),
               (2, 4, 4, 96, 128, 32, 8, True, False),
               (2, 8, 8, 128, 32, 8, 40, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_matches_plain_on_card(cuda_device, dtype):
    """The paged kernel against its plain version, element by element: f32
    within 1e-5 of max(1, the largest |o|) (sum order); bf16 within one bf16
    step of the plain element plus 1e-5 of its row's largest |o| (both keep
    p and v in f32 and round o once; the bf16 chunk kernel splits p into two
    bf16 terms for that); valid columns only where qlen is given; one launch
    per call, of the kernel `kernel_route` names."""
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
        route = "decode" if cw == 1 else "chunk"
        before_route = paged_attention.launches_by_route[route]
        entry = paged_kernel_route(cw, torch_dtype, hd)[1]
        before_entry = paged_attention.launches_by_kernel[entry]
        o = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        assert paged_attention.launches_by_route[route] == before_route + 1
        assert paged_attention.launches_by_kernel[entry] == before_entry + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_is_bit_equal_from_call_to_call(cuda_device, dtype):
    """The decode kernel's warps combine their shares of the walk in a fixed
    order, with no atomics: two calls on the same inputs give the same bits
    (o and lse), at the 45m decode shape."""
    rng = np.random.default_rng(12)
    b, h, hd, ps, mp = 16, 8, 64, 64, 11
    torch_dtype = getattr(torch, dtype)
    pools = [torch.from_numpy(rng.standard_normal((b * mp + 1, h, ps, hd),
                                                  dtype=np.float32))
             .to(cuda_device, torch_dtype) for _ in range(2)]
    tbl = torch.from_numpy(rng.permutation(b * mp).reshape(b, mp)
                           .astype(np.int32)).to(cuda_device)
    start = torch.from_numpy(rng.integers(0, mp * ps, b).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((b, h, 1, hd), dtype=np.float32))
    args = (q.to(cuda_device, torch_dtype), *pools, tbl, start.to(cuda_device))
    first = paged_attention(*args, page_size=ps, return_lse=True)
    again = paged_attention(*args, page_size=ps, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_paged_chunk_is_bit_equal_from_call_to_call(cuda_device, int8):
    """The bf16 chunk kernel walks each row tile's keys in one fixed order,
    with no atomics: two calls on the same inputs give the same bits (o and
    lse), at the chunk shape with a second row starting mid-page."""
    rng = np.random.default_rng(13)
    b, h, cw, hd, ps, mp = 2, 8, 128, 64, 64, 11
    shape = (b * mp + 1, h, ps, hd)
    if int8:
        pools = [(torch.from_numpy(rng.integers(-127, 128, shape)
                                   .astype(np.int8)).to(cuda_device),
                  torch.from_numpy(rng.uniform(0.01, 0.05, shape[:3])
                                   .astype(np.float32)).to(cuda_device))
                 for _ in range(2)]
    else:
        pools = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 .to(cuda_device, torch.bfloat16) for _ in range(2)]
    tbl = torch.from_numpy(rng.permutation(b * mp).reshape(b, mp)
                           .astype(np.int32)).to(cuda_device)
    start = torch.tensor([256, 61], dtype=torch.int32, device=cuda_device)
    q = torch.from_numpy(rng.standard_normal((b, h, cw, hd), dtype=np.float32))
    args = (q.to(cuda_device, torch.bfloat16), *pools, tbl, start)
    before = paged_attention.launches_by_kernel["paged_chunk_sm90"]
    first = paged_attention(*args, page_size=ps, return_lse=True)
    again = paged_attention(*args, page_size=ps, return_lse=True)
    torch.cuda.synchronize()
    assert paged_attention.launches_by_kernel["paged_chunk_sm90"] == before + 2
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


# (b, h, hkv, tq, tk, d): a ragged GQA block (group 4) at head_dim 64, 32
# and 128 (MHA), and the edges of the bf16 kernels' 64-row tiles (tq 129,
# tk 63, group 2)
BLOCK_CARD_CASES = [(2, 8, 2, 90, 200, 64), (2, 8, 2, 90, 200, 32),
                    (1, 4, 4, 90, 200, 128), (2, 8, 4, 129, 63, 64)]


def _block_card_inputs(case, device, dtype, seed=7):
    """q, k, v, do in dtype, dlse f32 and int32 positions from a numpy seed;
    the first 5 rows of every batch row see no key."""
    b, h, hkv, tq, tk, d = case
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    q, k, v, do = (x.to(device, dtype) for x in (
        f(b, h, tq, d), f(b, hkv, tk, d), f(b, hkv, tk, d), f(b, h, tq, d)))
    dlse = f(b, h, tq).to(device)
    qp = torch.from_numpy(rng.integers(0, 400, (b, tq)).astype(np.int32))
    qp[:, :5] = 0
    kp = torch.from_numpy(rng.integers(50, 450, (b, tk)).astype(np.int32))
    return q, k, v, qp.to(device), kp.to(device), do, dlse


@pytest.mark.cuda
@pytest.mark.parametrize("case", BLOCK_CARD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_kernels_match_plain_on_card(cuda_device, dtype, case):
    """The three block kernels of the dtype's route against their plain
    versions on a ragged GQA block whose first rows see nothing, with
    random (do, dlse): f32 within 1e-5 of max(1, the tensor's largest
    |value|) (sum order); bf16 per element within one bf16 step of the plain
    value plus what rounding p and ds can move it by (`rounding_slack`) plus
    1e-5 of its row's largest |value|; dead rows exactly o = 0,
    lse = -1e30, dq = 0; one launch of each kernel per call, and
    `BlockAttention` runs the same kernels."""
    q, k, v, qp, kp, do, dlse = _block_card_inputs(case, cuda_device,
                                                   getattr(torch, dtype))
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
            tol = bf16_limit(r, slack[name])
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_backward_is_bit_equal_from_call_to_call(cuda_device, dtype):
    """dk/dv of a kv head sum over its query group inside one block, with no
    atomics: two backward calls on the same inputs give the same bits, on
    either route."""
    q, k, v, qp, kp, do, dlse = _block_card_inputs(
        (2, 8, 2, 129, 250, 64), cuda_device, getattr(torch, dtype), seed=9)
    o, lse = block_attention_plain(q, k, v, qp, kp)
    first = block_attention_bwd(q, k, v, qp, kp, o, lse, do, dlse)
    again = block_attention_bwd(q, k, v, qp, kp, o, lse, do, dlse)
    torch.cuda.synchronize()
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_block_kernels_round_p_as_plain_on_one_key_tile(cuda_device):
    """bf16 on one key tile (tk 20 <= the bf16 kernels' 64-key tile): the
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
        assert ((x - r).abs() <= bf16_limit(r, 0.0)).all(), name


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

    limit = bf16_limit(r, 0.0)
    assert ((forward(p.to(torch.bfloat16).float()) - r).abs() <= limit).all()
    assert not ((forward(p) - r).abs() <= limit).all()
