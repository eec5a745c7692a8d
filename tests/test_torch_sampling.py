"""The port's sampled decoding (`models/decode.py`: `_filter_logits`,
`gumbel_noise`, `make_token_sampler`, `host_sample_tokens`; the engines'
per-request seeds) against the JAX package's sampler, on the CPU.

(a) `_filter_logits` gives JAX's mask element for element (top-k alone,
    top-p alone, both composed, rows full of ties at the thresholds);
(b) the hash behind the draw keeps every intermediate in [0, 2^32): its
    products and finalizer equal Python's integer arithmetic mod 2^32;
(c) a request's sampled tokens are a function of its seed only: the same
    alone, in a full batch, after slot reuse, admitted late, through the
    slot and the paged engine, and in both model families;
(d) the fused sampler (in the decode step) and the debug host sampler
    (the step's full-vocab logits sampled on the host) draw the same
    tokens, in the sampler alone and through both engines;
(e) the draws' distribution: a two-sample chi-square of the port's draws
    against JAX's `host_sample_tokens` draws on the same filtered logits
    (the same statistic rejects a different filter: the test has power),
    and a one-sample chi-square against the exact filtered softmax, both
    at p = 1e-3 (the draws are deterministic: seeds 0.., so the outcome
    is fixed).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from distributed_pytorch_from_scratch_tpu.models import decode as jdecode
from distributed_pytorch_from_scratch_tpu_torch.config import (
    MeshConfig, ModelConfig)
from distributed_pytorch_from_scratch_tpu_torch.models import decode
from distributed_pytorch_from_scratch_tpu_torch.models import build_model
from distributed_pytorch_from_scratch_tpu_torch.runtime.mesh import make_mesh
from distributed_pytorch_from_scratch_tpu_torch.serving.engine import (
    ContinuousBatchingEngine, PagedEngine, Request)

CFG = ModelConfig(attn_dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                  vocab_size=64, maxlen=64)
SAMPLING = dict(temperature=0.9, top_k=24, top_p=0.92)
EOS = 1
P_CRIT = 1e-3


def _logits(seed, b=6, v=97):
    """Random rows, then rows of ties: values on a 0.5 grid (ties at the
    top-k and top-p thresholds), a constant row, a row of two values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v)).astype(np.float32) * 2
    ties = np.round(rng.standard_normal((3, v)) * 2).astype(np.float32) / 2
    ties[1] = 0.25
    ties[2] = np.where(np.arange(v) % 3 == 0, 1.0, -1.0)
    return np.concatenate([x, ties])


# ---- (a) ----

@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.9), (7, 0.6),
                                         (1, 0.0), (0, 0.3), (40, 0.99),
                                         (97, 0.5)])
def test_filter_logits_equals_jax_mask(top_k, top_p):
    x = _logits(top_k * 100 + int(top_p * 100)) / 0.7
    ours = decode._filter_logits(torch.from_numpy(x), top_k, top_p).numpy()
    theirs = np.asarray(jdecode._filter_logits(jnp.asarray(x), top_k, top_p))
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(theirs))
    np.testing.assert_array_equal(ours, theirs)
    kept = np.isfinite(ours).sum(axis=1)
    assert (kept >= 1).all()
    if top_k and not top_p:
        assert (kept >= top_k).all()          # ties at the k-th survive


# ---- (b) ----

def test_hash_stays_in_32_bits_and_equals_integer_arithmetic():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.integers(0, 2**32, 4000, dtype=np.int64),
                           [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]])
    x = torch.from_numpy(vals)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0xFFFFFFFF):
        got = decode._mul32(x, c).tolist()
        assert got == [(int(v) * c) % 2**32 for v in vals]

    def fmix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) % 2**32
        h ^= h >> 13
        h = (h * 0xC2B2AE35) % 2**32
        return h ^ (h >> 16)

    assert decode._fmix32(x).tolist() == [fmix(int(v)) for v in vals]
    seeds = torch.tensor([0, 2**32 - 1, -1, 12345], dtype=torch.int64)
    g = decode.gumbel_noise(seeds, torch.tensor([0, 5, 5, 2**31 - 1]), 50)
    assert g.dtype == torch.float64 and torch.isfinite(g).all()
    # a seed's int32 bits (-1) and its uint32 value (2^32 - 1) draw alike
    assert torch.equal(g[1], g[2])
    assert not torch.equal(g[0], g[3])


# ---- (c), (d) ----

def _engine(kind, model, mesh, slots, **kw):
    if kind == "slot":
        return ContinuousBatchingEngine(model, mesh, num_slots=slots,
                                        buf_len=40, eos_id=EOS,
                                        prefill_bucket=8, **SAMPLING, **kw)
    return PagedEngine(model, mesh, num_slots=slots, buf_len=40, eos_id=EOS,
                       page_size=8, prefill_chunk=8, **SAMPLING, **kw)


def _run(eng, reqs, stagger=0):
    """Submit the first request, step `stagger` times, submit the rest, and
    drain: {rid: tokens}."""
    eng.submit(reqs[0])
    for _ in range(stagger):
        eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.run_to_completion()
    return {r.rid: list(r.tokens) for r in eng.completed}


PROMPTS = [[0, 5, 9, 13], [0, 7, 2, 44, 3, 8, 21], [0, 3], [0, 60, 61],
           [0, 9, 9, 9, 9], [0, 12, 30, 2, 6]]


def _reqs(order, seed_of=lambda i: 1000 + 7 * i):
    return [Request(rid=i, prompt=list(PROMPTS[i]), max_new=14,
                    seed=seed_of(i)) for i in order]


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def family_model(request):
    torch.manual_seed(0)
    model = build_model(request.param, CFG).init_weights(11)
    return model, make_mesh(MeshConfig(), device="cpu")


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_sampled_tokens_follow_the_seed_only(family_model, kind):
    model, mesh = family_model
    n = len(PROMPTS)
    alone = {i: _run(_engine(kind, model, mesh, 1), _reqs([i]))[i]
             for i in (0, 3)}
    batch = _run(_engine(kind, model, mesh, n), _reqs(range(n)))
    # reversed arrival, late admission, two slots reused by the queue
    reused = _run(_engine(kind, model, mesh, 2), _reqs(range(n)[::-1]),
                  stagger=3)
    for i in alone:
        assert alone[i] == batch[i] == reused[i], i
    assert batch == reused
    assert sum(len(t) for t in batch.values()) > 3 * n   # real decoding
    # another seed draws otherwise
    other = _run(_engine(kind, model, mesh, n),
                 _reqs(range(n), seed_of=lambda i: 5 + i))
    assert other != batch


def test_slot_and_paged_engines_draw_alike(family_model):
    model, mesh = family_model
    reqs = lambda: _reqs(range(len(PROMPTS)))
    assert (_run(_engine("slot", model, mesh, 3), reqs())
            == _run(_engine("paged", model, mesh, 3), reqs()))


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_fused_sampler_equals_host_sampler_in_the_engines(family_model,
                                                          kind):
    model, mesh = family_model
    reqs = lambda: _reqs(range(len(PROMPTS)))
    fused = _run(_engine(kind, model, mesh, 3), reqs(), stagger=2)
    host = _run(_engine(kind, model, mesh, 3, debug_host_sampler=True),
                reqs(), stagger=2)
    assert fused == host


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 0.0), (1.0, 0, 0.0), (0.7, 10, 0.0), (1.3, 0, 0.8),
    (0.5, 5, 0.9)])
def test_fused_sampler_equals_host_sampler(temperature, top_k, top_p):
    model = SimpleNamespace(cfg=SimpleNamespace(vocab_size=90), tp_size=1)
    rng = np.random.default_rng(3)
    padded = rng.standard_normal((8, 92)).astype(np.float32) * 3
    padded[:, 90:] = decode.NEG_INF       # padded vocab columns
    seeds = rng.integers(0, 2**32, 8, dtype=np.int64).astype(np.uint32)
    pos = rng.integers(0, 500, 8).astype(np.int32)
    fused = decode.make_token_sampler(model, temperature, top_k, top_p)(
        torch.from_numpy(padded), torch.from_numpy(seeds.view(np.int32)),
        torch.from_numpy(pos))
    host = decode.host_sample_tokens(model, padded, seeds, pos,
                                     temperature, top_k, top_p)
    assert fused.tolist() == host.tolist()
    assert all(0 <= t < 90 for t in host.tolist())


# ---- (e) ----

def _pool_bins(*counts, least=10.0):
    """Per-token counts -> bins whose combined count is >= `least`, the
    rest pooled into one (the JAX speculative test's pooling)."""
    comb = sum(counts)
    keep = np.flatnonzero(comb >= least)
    rest = np.flatnonzero((comb > 0) & (comb < least))
    return [np.concatenate([c[keep], [c[rest].sum()] if len(rest) else []])
            for c in counts]


def _chi2_two_sample(a_tokens, b_tokens, vocab):
    a, b = _pool_bins(np.bincount(a_tokens, minlength=vocab).astype(float),
                      np.bincount(b_tokens, minlength=vocab).astype(float))
    ra, rb = np.sqrt(b.sum() / a.sum()), np.sqrt(a.sum() / b.sum())
    stat = float((((a * ra - b * rb) ** 2) / (a + b)).sum())
    return stat, float(chi2.ppf(1 - P_CRIT, len(a) - 1))


def _draws(row, n, temperature, top_k, top_p, pos=17):
    full = torch.from_numpy(np.tile(row, (n, 1)))
    seeds = torch.arange(n, dtype=torch.int64)
    return decode.sample_from_full(full, seeds, torch.full((n,), pos),
                                   temperature, top_k, top_p).numpy()


def test_draws_match_jax_two_sample_chi_square():
    v, n = 64, 4000
    row = (np.random.default_rng(9).standard_normal(v) * 1.5).astype(
        np.float32)
    model = SimpleNamespace(cfg=SimpleNamespace(vocab_size=v))
    jax_draws = lambda k, p: jdecode.host_sample_tokens(
        model, np.tile(row, (n, 1)), np.arange(n, dtype=np.uint32),
        np.full(n, 17, np.int32), 0.8, k, p)
    ours = _draws(row, n, 0.8, 20, 0.95)
    stat, crit = _chi2_two_sample(ours, jax_draws(20, 0.95), v)
    assert stat < crit, (stat, crit)
    # power: the same statistic rejects a different filter
    stat, crit = _chi2_two_sample(ours, jax_draws(5, 0.95), v)
    assert stat > crit, (stat, crit)


def test_draws_match_the_filtered_softmax_one_sample_chi_square():
    v, n, temperature, top_k, top_p = 500, 20000, 0.8, 50, 0.95
    row = (np.random.default_rng(21).standard_normal(v) * 2).astype(
        np.float32)
    draws = _draws(row, n, temperature, top_k, top_p)
    scaled = decode._filter_logits(torch.from_numpy(row[None]) / temperature,
                                   top_k, top_p)[0].double()
    probs = torch.softmax(scaled, dim=-1).numpy()
    assert set(np.unique(draws)) <= set(np.flatnonzero(probs > 0))
    counts = np.bincount(draws, minlength=v).astype(float)
    exp = probs * n
    # tokens expected >= 5 times are bins of their own, the rest one bin
    keep = exp >= 5
    obs = np.append(counts[keep], counts[~keep].sum())
    want = np.append(exp[keep], exp[~keep].sum())
    if want[-1] == 0:
        obs, want = obs[:-1], want[:-1]
    stat = float(((obs - want) ** 2 / want).sum())
    crit = float(chi2.ppf(1 - P_CRIT, len(obs) - 1))
    assert len(obs) > 10
    assert stat < crit, (stat, crit)
    # the nearby positions are independent draws of the same law
    other = _draws(row, n, temperature, top_k, top_p, pos=18)
    assert (other != draws).mean() > 0.5
