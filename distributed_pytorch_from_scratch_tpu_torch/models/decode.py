"""KV-cache decoding lowerings shared by the serving engines — counterpart
of the JAX `models/decode.py` (`_prefill`, `_decode_one`, the paged
`_paged_decode_one` / `_paged_prefill_chunk`, the sampler).

Slot caches are (num_layers, b, kv_heads, buf_len, head_dim) in the compute
dtype. Paged pools are (num_layers, num_pages + 1, kv_heads, page_size,
head_dim), or (codes int8, scales f32 (num_layers, num_pages + 1, kv_heads,
page_size)) tuples for int8 pages (serving/kv_manager.py). Under
grouped-query attention they hold kv_heads entries and query head i reads kv
head i // (num_heads / kv_heads).

Where JAX returns updated caches from a pure function, the lowerings here
write the caches IN PLACE (torch runs eagerly; the JAX engine gets the same
effect from buffer donation) and return only the logits.
"""

from __future__ import annotations

import math

import torch

from ..ops.attention import MASK_VALUE, causal_attention
from ..ops.cuda.paged_attention import paged_attention
from ..ops.quant import quantize_rows
from ..ops.rope import apply_rotary

# the paged attends: the dense page view + einsum block (the oracle), or
# `paged_attention` (the CUDA kernel on the card, its plain version on CPU)
PAGED_ATTN_IMPLS = ("gather", "kernel")


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


def _check_paged(attn_impl: str, cp: int) -> None:
    if cp > 1:
        raise NotImplementedError(
            f"cp={cp}: the cp-sharded page pool is not ported yet, see "
            f"ROADMAP Queue 1 (d); the port serves pages at cp=1")
    if attn_impl not in PAGED_ATTN_IMPLS:
        raise ValueError(f"paged attn impl must be one of "
                         f"{PAGED_ATTN_IMPLS}, got {attn_impl!r}")


def _layer_pool(pool, li: int):
    """Layer li of a pool: a tensor, or a (codes, scales) tuple."""
    if isinstance(pool, tuple):
        return pool[0][li], pool[1][li]
    return pool[li]


def _paged_cache_write(cache, zi: torch.Tensor, dst_page: torch.Tensor,
                       dst_off: torch.Tensor) -> None:
    """Scatter head-vectors into one layer of the page pool, IN PLACE. `zi`
    is shaped like the advanced-index result of `cache[dst_page, :,
    dst_off]`: (b, kvh, hd) for the single-token step, (b, cw, kvh, hd) for
    a chunk. A quantized (codes, scales) pool codes each vector on the way
    in (one symmetric scale per head-vector, `ops.quant.quantize_rows`).

    Free rows and pad columns aim at the scratch page, several at one
    offset at times: which duplicate write lands there does not matter,
    since no live row attends to the scratch page."""
    if isinstance(cache, tuple):
        codes, sc = cache
        q, s = quantize_rows(zi)
        codes[dst_page, :, dst_off, :] = q
        sc[dst_page, :, dst_off] = s
    else:
        cache[dst_page, :, dst_off, :] = zi.to(cache.dtype)


def _gather_page_view(cache, page_tbl: torch.Tensor,
                      dtype) -> torch.Tensor:
    """One pool layer (pages, kvh, ps, hd) + per-row page lists (b,
    max_pages) -> the dense logical cache view (b, kvh, max_pages * ps, hd)
    the gather impl's einsums consume; an int8 pool dequantizes into the
    compute dtype here. Positions past a row's cursor hold whatever the
    mapped page holds (zeros, the scratch page, a COW donor's later tokens):
    finite, and masked before anything reads them."""
    b, mp = page_tbl.shape
    if isinstance(cache, tuple):
        codes, sc = cache
        view = (codes[page_tbl].float() * sc[page_tbl][..., None]).to(dtype)
    else:
        view = cache[page_tbl]                   # (b, mp, kvh, ps, hd)
    _, _, kvh, ps, hd = view.shape
    return view.transpose(1, 2).reshape(b, kvh, mp * ps, hd)


def _gather_attend(q: torch.Tensor, k_cache, v_cache,
                   page_tbl: torch.Tensor, pos: torch.Tensor,
                   dtype) -> torch.Tensor:
    """The gather impl (the oracle): q (b, h, cw, hd) at absolute positions
    pos (b, cw) over the gathered page views, with `_decode_one`'s attend
    block — f32 scores, -10000 on keys past the query's position, f32
    softmax, probabilities cast to the compute dtype before p @ v."""
    b, h, cw, hd = q.shape
    k_view = _gather_page_view(k_cache, page_tbl, dtype)
    v_view = _gather_page_view(v_cache, page_tbl, dtype)
    kvh, t = k_view.shape[1], k_view.shape[2]
    visible = (torch.arange(t, device=q.device)[None, None, :]
               <= pos[:, :, None])[:, None, None]    # (b, 1, 1, cw, t)
    qg = q.reshape(b, kvh, h // kvh, cw, hd)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg.float(), k_view.float())
    s = s / math.sqrt(hd)
    s = s.masked_fill(~visible, MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(dtype)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v_view)
    return o.reshape(b, h, cw, hd)


def _paged_attend(q, k_cache, v_cache, page_tbl, start, pos, page_size: int,
                  dtype, attn_impl: str, qlen=None) -> torch.Tensor:
    """One layer's attend over the page pool; the layer's K/V writes are
    already in the pool, so each query sees its own position."""
    if attn_impl == "kernel":
        return paged_attention(q.contiguous(), k_cache, v_cache, page_tbl,
                               start, page_size=page_size,
                               qlen=qlen).to(dtype)
    return _gather_attend(q, k_cache, v_cache, page_tbl, pos, dtype)


def _paged_decode_one(model, pool_k, pool_v, token: torch.Tensor,
                      cur: torch.Tensor, page_tbl: torch.Tensor,
                      page_size: int, cos_t, sin_t, dtype,
                      attn_impl: str = "gather", cp: int = 1) -> torch.Tensor:
    """`_decode_one` through a page table: row i writes its token's K/V (in
    place) into the page its table maps for position cur[i], at offset
    cur[i] % page_size, then attends over its page list; returns the (b,
    vocab) logits. Every layer writes before it attends, as in JAX.

    token, cur (b,) and page_tbl (b, max_pages) hold int32 ids; free rows'
    tables aim every entry at the scratch page, so their position-0 write
    lands there. `attn_impl`: 'gather' (the dense page view, the oracle) or
    'kernel' (`ops.cuda.paged_attention`)."""
    _check_paged(attn_impl, cp)
    b = token.shape[0]
    p1 = cur[:, None]
    x = _embed(model, token[:, None], dtype)
    cos, sin = _positions(cos_t, sin_t, p1)
    rows = torch.arange(b, device=token.device)
    dst_page = page_tbl[rows, cur // page_size]        # (b,)
    dst_off = cur % page_size                          # (b,)
    for li, lp in enumerate(model.layers):
        y = lp[model.attn_norm_key](x)
        q, k, v = _qkv(model, lp, y, dtype)       # q: (b, h, 1, hd); kv: kvh
        q, k = apply_rotary(q, k, cos, sin)
        k_cache = _layer_pool(pool_k, li)
        v_cache = _layer_pool(pool_v, li)
        _paged_cache_write(k_cache, k[:, :, 0, :], dst_page, dst_off)
        _paged_cache_write(v_cache, v[:, :, 0, :], dst_page, dst_off)
        o = _paged_attend(q, k_cache, v_cache, page_tbl, cur, p1, page_size,
                          dtype, attn_impl)
        x = _finish_block(model, lp, x, o, dtype)
    return _logits_last(model, x, dtype)


def _paged_prefill_chunk(model, pool_k, pool_v, chunk: torch.Tensor,
                         start: torch.Tensor, qlen: torch.Tensor,
                         page_tbl: torch.Tensor, dst_page: torch.Tensor,
                         dst_off: torch.Tensor, page_size: int, cos_t, sin_t,
                         dtype, all_logits: bool = False,
                         attn_impl: str = "gather",
                         cp: int = 1) -> torch.Tensor:
    """One CHUNK of an incremental prefill: `chunk` (b, cw) tokens at
    absolute positions start..start+qlen-1 (columns >= qlen are pad) write
    their K/V (in place) into the pages dst_page/dst_off (b, cw) map (pad
    columns aim at the scratch page), and each chunk query attends over the
    row's whole page list — earlier chunks, a shared prefix another request
    prefilled, and the chunk's own earlier positions. Returns the logits at
    the last real position qlen-1, (b, vocab), or with `all_logits` at every
    chunk position, (b, cw, vocab). Causality makes chunked prefill
    value-identical to the whole-buffer `_prefill`."""
    _check_paged(attn_impl, cp)
    b, cw = chunk.shape
    pos = start[:, None] + torch.arange(cw, device=chunk.device,
                                        dtype=start.dtype)[None, :]
    x = _embed(model, chunk, dtype)
    cos, sin = _positions(cos_t, sin_t, pos)
    for li, lp in enumerate(model.layers):
        y = lp[model.attn_norm_key](x)
        q, k, v = _qkv(model, lp, y, dtype)       # q: (b, h, cw, hd)
        q, k = apply_rotary(q, k, cos, sin)
        k_cache = _layer_pool(pool_k, li)
        v_cache = _layer_pool(pool_v, li)
        _paged_cache_write(k_cache, k.transpose(1, 2), dst_page, dst_off)
        _paged_cache_write(v_cache, v.transpose(1, 2), dst_page, dst_off)
        o = _paged_attend(q, k_cache, v_cache, page_tbl, start, pos,
                          page_size, dtype, attn_impl, qlen=qlen)
        x = _finish_block(model, lp, x, o, dtype)
    if all_logits:
        return _logits_tokens(model, x, dtype)
    idx = torch.clamp(qlen.long() - 1, min=0)[:, None, None]
    last = torch.gather(x, 1, idx.expand(b, 1, x.shape[-1]))
    return _logits_last(model, last, dtype)


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
