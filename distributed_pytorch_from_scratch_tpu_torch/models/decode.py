"""KV-cache decoding lowerings shared by the serving engine — counterpart of
the JAX `models/decode.py` (`_prefill`, `_decode_one`, the sampler).

Caches are (num_layers, b, kv_heads, buf_len, head_dim) in the compute
dtype. Under grouped-query attention they hold kv_heads entries and query
head i reads kv head i // (num_heads / kv_heads).

Where JAX returns updated caches from a pure function, `_decode_one` here
writes the caches IN PLACE (torch runs eagerly; the JAX engine gets the
same effect from buffer donation).
"""

from __future__ import annotations

import math

import torch

from ..ops.attention import MASK_VALUE, causal_attention
from ..ops.rope import apply_rotary


def _qkv(model, lp, y: torch.Tensor, dtype):
    """Project y (b, t, d) -> q (b, heads, t, hd) and k, v at
    (b, kv_heads, t, hd)."""
    b, t, _ = y.shape
    h = model.cfg.head_dim
    split = lambda z, nh: z.reshape(b, t, nh, h).transpose(1, 2)
    q = split(lp["wq"](y, dtype), model.cfg.num_heads)
    k = split(lp["wk"](y, dtype), model.cfg.kv_heads)
    v = split(lp["wv"](y, dtype), model.cfg.kv_heads)
    return q, k, v


def _embed(model, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Token embedding (the llama family has no learned positions)."""
    return model.embedding(ids).to(dtype)


def _finish_block(model, lp, x: torch.Tensor, o: torch.Tensor,
                  dtype) -> torch.Tensor:
    """Residual + wo, then the SwiGLU FFN sublayer (shared by prefill and
    decode)."""
    b, t = x.shape[0], x.shape[1]
    o = o.transpose(1, 2).reshape(b, t, model.cfg.num_heads * model.cfg.head_dim)
    x = x + lp["wo"](o, dtype)
    y = lp[model.ffn_norm_key](x)
    g = lp["gate_proj"](y, dtype)
    u = lp["up_proj"](y, dtype)
    return x + lp["down_proj"](torch.nn.functional.silu(g) * u, dtype)


def _block(model, lp, x: torch.Tensor, cos, sin, dtype):
    """One full-sequence decoder layer (the JAX `_layer_body` at tp=1):
    returns (x', k, v), the layer's output and its post-RoPE k and v. The
    attention is `causal_attention`: the flash kernels on the card."""
    y = lp[model.attn_norm_key](x)
    q, k, v = _qkv(model, lp, y, dtype)
    q, k = apply_rotary(q, k, cos, sin)
    o = causal_attention(q, k, v)
    return _finish_block(model, lp, x, o, dtype), k, v


def _logits_tokens(model, x: torch.Tensor, dtype) -> torch.Tensor:
    """Final norm + head on (b, t, d) -> (b, t, vocab). At tp=1 the vocab
    is unpadded, so no column needs masking."""
    return model.lm_head(model.norm(x), dtype)


def _logits_last(model, x_last: torch.Tensor, dtype) -> torch.Tensor:
    """`_logits_tokens` at t = 1: (b, 1, d) -> (b, vocab)."""
    return _logits_tokens(model, x_last, dtype)[:, 0, :]


def _positions(cos_t, sin_t, pos: torch.Tensor):
    """cos/sin rows at `pos`, clamped into the table (JAX mode='clip')."""
    pos = pos.clamp(0, cos_t.shape[0] - 1)
    return cos_t[pos], sin_t[pos]


def _prefill(model, buf: torch.Tensor, prompt_len: torch.Tensor,
             cos_t, sin_t, dtype):
    """Causal full-buffer forward over buf (b, t): returns (ks, vs) stacked
    per layer, (L, b, kv_heads, t, hd), and the per-row logits at position
    prompt_len[i]-1, (b, vocab). The attention is `causal_attention`: the
    flash kernel on the card."""
    b, t = buf.shape
    pos = torch.arange(t, device=buf.device)[None, :].expand(b, t)
    x = _embed(model, buf, dtype)
    cos, sin = _positions(cos_t, sin_t, pos)
    ks, vs = [], []
    for lp in model.layers:
        x, k, v = _block(model, lp, x, cos, sin, dtype)
        ks.append(k)
        vs.append(v)
    idx = (prompt_len.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
    last = torch.gather(x, 1, idx)
    return (torch.stack(ks).to(dtype), torch.stack(vs).to(dtype),
            _logits_last(model, last, dtype))


def _decode_one(model, cache_k: torch.Tensor, cache_v: torch.Tensor,
                token: torch.Tensor, cur: torch.Tensor, buf_len: int,
                cos_t, sin_t, dtype) -> torch.Tensor:
    """One single-token step for every row: row i writes its token's K/V at
    position cur[i] of the caches (in place), attends over positions
    0..cur[i], and the (b, vocab) logits are returned.

    The attention is plain torch, as the JAX step's einsums are: f32
    scores, -10000 outside the visible prefix, f32 softmax, probabilities
    cast to the compute dtype BEFORE the p @ v product."""
    b = token.shape[0]
    cur = torch.as_tensor(cur, device=token.device).long().expand(b)
    p1 = cur[:, None]
    x = _embed(model, token[:, None], dtype)
    cos, sin = _positions(cos_t, sin_t, p1)
    visible = (torch.arange(buf_len, device=token.device)[None, :]
               <= cur[:, None])[:, None, None, :]
    rows = torch.arange(b, device=token.device)
    # a freed slot's stale cursor can sit at buf_len: JAX drops that
    # out-of-bounds scatter, here it lands on the free row's own last
    # position — garbage into a row nothing reads before rewriting it
    wcur = cur.clamp(max=buf_len - 1)
    kvh = model.cfg.kv_heads
    g = model.cfg.num_heads // kvh
    hd = model.cfg.head_dim
    for li, lp in enumerate(model.layers):
        y = lp[model.attn_norm_key](x)
        q, k, v = _qkv(model, lp, y, dtype)       # q: (b, h, 1, hd); kv: kvh
        q, k = apply_rotary(q, k, cos, sin)
        k_cache, v_cache = cache_k[li], cache_v[li]
        # advanced indices split by a slice: the indexed view is (b, kvh, hd)
        k_cache[rows, :, wcur, :] = k[:, :, 0, :].to(k_cache.dtype)
        v_cache[rows, :, wcur, :] = v[:, :, 0, :].to(v_cache.dtype)
        qg = q[:, :, 0, :].reshape(b, kvh, g, hd)
        s = torch.einsum("bkgd,bktd->bkgt", qg.float(), k_cache.float())
        s = s / math.sqrt(hd)
        s = s.masked_fill(~visible, MASK_VALUE)
        p = torch.softmax(s, dim=-1).to(dtype)
        o = torch.einsum("bkgt,bktd->bkgd", p, v_cache)
        o = o.reshape(b, kvh * g, hd)[:, :, None, :]   # (b, h, 1, hd)
        x = _finish_block(model, lp, x, o, dtype)
    return _logits_last(model, x, dtype)


def validate_sampling(cfg, temperature: float, top_k: int,
                      top_p: float) -> None:
    """Build-time sampling-knob validation (the JAX contract and text)."""
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k < 0 or top_k > cfg.vocab_size:
        raise ValueError(f"top_k must be in [0, vocab_size], got {top_k}")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1] (0 = off), got {top_p}")


def make_token_sampler(model, temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 0.0):
    """`sample(logits, seeds, positions)` -> (b,) token ids. Greedy only:
    argmax over the full-vocab f32 logits, first maximal index on ties (as
    jnp.argmax). Sampled decoding is not ported: jax.random draws cannot be
    replayed in torch, so it needs its own distributional tests."""
    validate_sampling(model.cfg, temperature, top_k, top_p)
    if temperature > 0.0:
        raise NotImplementedError(
            "sampled decoding (temperature > 0) is not ported yet, see "
            "ROADMAP; use temperature 0 (greedy)")

    def sample(logits: torch.Tensor, seeds=None, positions=None) -> torch.Tensor:
        return torch.argmax(logits.float(), dim=-1)

    return sample
