"""KV-cache decoding lowerings shared by the serving engines — counterpart
of the JAX `models/decode.py` (`_prefill`, `_decode_one`, the paged
`_paged_decode_one` / `_paged_prefill_chunk`, the sampler).

Slot caches are (num_layers, b, kv_heads, buf_len, head_dim) in the compute
dtype. Paged pools are (num_layers, num_pages + 1, kv_heads, page_size,
head_dim), or (codes int8, scales f32 (num_layers, num_pages + 1, kv_heads,
page_size)) tuples for int8 pages (serving/kv_manager.py). Under
grouped-query attention they hold kv_heads entries and query head i reads kv
head i // (num_heads / kv_heads). At tp > 1 a rank's caches hold its
kv_heads / tp local heads, its q its num_heads / tp, and the lowerings
return its vocab columns of the logits; the sampler gathers them.

Where JAX returns updated caches from a pure function, the lowerings here
write the caches IN PLACE (torch runs eagerly; the JAX engine gets the same
effect from buffer donation) and return only the logits.

The lowerings are generic over the model FAMILY, as the JAX decoder is:
each family class declares `uses_rope`, `attn_norm_key` and
`ffn_norm_key`, and the module dict says the rest. The gpt2 family
(`models/gpt2.py`) adds learned position rows at the input (`_embed`),
runs a tanh-GELU MLP (`"fc"` among the layer's modules) and ties its head
to the token embedding (no `lm_head`).

The sampler (`make_token_sampler`, `host_sample_tokens`) is greedy at
temperature 0; above it, top-k then top-p filtering (`_filter_logits`, the
JAX mask) and a Gumbel-max draw whose noise is a counter-based hash of
(request seed, absolute position, column) in integer tensor ops
(`gumbel_noise`): a request's tokens depend on nothing else, every tp rank
draws the same token from the gathered logits, the draw runs inside a
captured CUDA graph, and the fused and host samplers agree bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.attention import MASK_VALUE, causal_attention
from ..ops.collectives import copy_to, gather_from
from ..ops.cuda.paged_attention import paged_attention
from ..ops.quant import quantize_rows
from ..ops.rope import apply_rotary, rope_tables

# the paged attends: the dense page view + einsum block (the oracle), or
# `paged_attention` (the CUDA kernel on the card, its plain version on CPU)
PAGED_ATTN_IMPLS = ("gather", "kernel")
# the padded vocab columns' logit (JAX `models/transformer.py` NEG_INF)
NEG_INF = -1e9


def _qkv(model, lp, y: torch.Tensor, dtype):
    """Project y (b, t, d) -> q (b, local heads, t, hd) and k, v at (b,
    local kv heads, t, hd); y is the sublayer's shared input (`_tp_in`), so
    the projections take it as 'gathered'."""
    b, t, _ = y.shape
    h = model.cfg.head_dim
    split = lambda z, nh: z.reshape(b, t, nh, h).transpose(1, 2)
    q = split(lp["wq"](y, dtype, "gathered"), model.num_local_heads)
    k = split(lp["wk"](y, dtype, "gathered"), model.num_local_kv_heads)
    v = split(lp["wv"](y, dtype, "gathered"), model.num_local_kv_heads)
    return q, k, v


def _tp_in(model, y: torch.Tensor) -> torch.Tensor:
    """A sublayer's normed input, shared by its column projections: at tp >
    1 one `copy_to` (whose backward all-reduces the projections' summed
    input gradient), or under sequence parallelism one all-gather of the
    sequence (the JAX `maybe_gather`: its backward is one reduce-scatter)."""
    if model.tp_size == 1:
        return y
    if model.sequence_parallel:
        return gather_from(y, model.mesh, dim=-2)
    return copy_to(y, model.mesh)


def _act_layout(model) -> str:
    """The layout of the activations between sublayers — the embedding's
    and the row layers' output, the head's input: this rank's chunk of the
    sequence under sequence parallelism, else the whole sequence."""
    return "seq_sharded" if model.sequence_parallel else "replicated"


def _embed(model, ids: torch.Tensor, pos: torch.Tensor,
           dtype) -> torch.Tensor:
    """Token embedding, plus the learned position rows at `pos` (clamped
    into the table, JAX mode='clip') for a family without RoPE (gpt2),
    added in f32 before the cast; under sequence parallelism this rank's
    chunk of the sequence, the position rows sliced to it before the
    add."""
    x = model.embedding(ids, _act_layout(model))
    if not model.uses_rope:
        table = model.pos_embedding.weight
        rows = table[pos.long().clamp(0, table.shape[0] - 1)]
        if model.sequence_parallel:
            tl = rows.shape[-2] // model.tp_size
            r = model.mesh.tp_rank
            rows = rows[..., r * tl:(r + 1) * tl, :]
        x = x + rows
    return x.to(dtype)


def _finish_block(model, lp, x: torch.Tensor, o: torch.Tensor,
                  dtype) -> torch.Tensor:
    """Residual + wo, then the FFN sublayer (shared by prefill and decode):
    gpt2's tanh-GELU MLP where the layer has an `fc`, else SwiGLU."""
    b, t = o.shape[0], o.shape[2]
    o = o.transpose(1, 2).reshape(b, t,
                                  model.num_local_heads * model.cfg.head_dim)
    x = x + lp["wo"](o, dtype, _act_layout(model))
    y = _tp_in(model, lp[model.ffn_norm_key](x))
    if "fc" in lp:
        h = torch.nn.functional.gelu(lp["fc"](y, dtype, "gathered"),
                                     approximate="tanh")
        return x + lp["proj"](h, dtype, _act_layout(model))
    g = lp["gate_proj"](y, dtype, "gathered")
    u = lp["up_proj"](y, dtype, "gathered")
    return x + lp["down_proj"](torch.nn.functional.silu(g) * u, dtype,
                               _act_layout(model))


def _block(model, lp, x: torch.Tensor, cos, sin, dtype,
           attend=causal_attention):
    """One full-sequence decoder layer (the JAX `_layer_body`): returns (x',
    k, v), the layer's output and its post-RoPE k and v (local heads). The
    attention is `attend(q, k, v)`: by default `causal_attention`, the flash
    kernels on the card; the cp training forward passes the ring or Ulysses
    attention over its chunk. Under sequence parallelism x and x' are this
    rank's chunk of the sequence and q, k, v cover the whole of it."""
    y = _tp_in(model, lp[model.attn_norm_key](x))
    q, k, v = _qkv(model, lp, y, dtype)
    q, k = _rotate(model, q, k, cos, sin)
    o = attend(q, k, v)
    return _finish_block(model, lp, x, o, dtype), k, v


def _logits_tokens(model, x: torch.Tensor, dtype) -> torch.Tensor:
    """Final norm + head on (b, t, d) -> (b, t, vocab_padded / tp), this
    rank's vocab columns (under sequence parallelism x is the sequence
    chunk and the head all-gathers it); padded vocab columns are masked to
    NEG_INF (JAX `models/transformer.py`), so they carry no probability.
    A family without an `lm_head` (gpt2) ties the head to this rank's rows
    of the token embedding: `x @ embedding.weight.T`, the same local-vocab
    layout, and the embedding weight takes both gradients."""
    y = model.norm(x)
    if hasattr(model, "lm_head"):
        logits = model.lm_head(y, dtype, _act_layout(model))
    else:
        if model.tp_size > 1:       # the column layer's input layouts
            y = (gather_from(y, model.mesh, dim=-2)
                 if model.sequence_parallel else copy_to(y, model.mesh))
        logits = torch.matmul(y.to(dtype),
                              model.embedding.weight.to(dtype).t())
    if model.vocab_padded == model.cfg.vocab_size:
        return logits
    local_v = logits.shape[-1]
    col = model.mesh.tp_rank * local_v + torch.arange(local_v,
                                                      device=logits.device)
    return logits.masked_fill(col >= model.cfg.vocab_size, NEG_INF)


def _logits_last(model, x_last: torch.Tensor, dtype) -> torch.Tensor:
    """`_logits_tokens` at t = 1: (b, 1, d) -> (b, vocab_padded / tp)."""
    return _logits_tokens(model, x_last, dtype)[:, 0, :]


def _full_vocab_logits(model, logits: torch.Tensor) -> torch.Tensor:
    """This rank's vocab columns (..., vocab_padded / tp) -> the full (...,
    vocab_size) f32 logits, the same on every rank: the tp shards gathered
    on the last dim (the one tp hop of a dispatch past the model's), the
    padded columns dropped."""
    full = logits.float()
    if model.tp_size > 1:
        full = gather_from(full, model.mesh)
    return full[..., :model.cfg.vocab_size]


def _positions(cos_t, sin_t, pos: torch.Tensor):
    """cos/sin rows at `pos`, clamped into the table (JAX mode='clip');
    (None, None) without tables (a family without RoPE)."""
    if cos_t is None:
        return None, None
    pos = pos.clamp(0, cos_t.shape[0] - 1)
    return cos_t[pos], sin_t[pos]


def _rotate(model, q: torch.Tensor, k: torch.Tensor, cos, sin):
    """RoPE on q and k for a family that uses it; else q and k as they
    are (gpt2's positions entered at the embedding)."""
    if not model.uses_rope:
        return q, k
    return apply_rotary(q, k, cos, sin)


def decode_tables(model, length: int, device):
    """The RoPE (cos, sin) tables the lowerings take, `length` rows; (None,
    None) for a family without RoPE."""
    if not model.uses_rope:
        return None, None
    return rope_tables(length, model.cfg.head_dim, model.cfg.rope_theta,
                       device)


def _prefill(model, buf: torch.Tensor, prompt_len: torch.Tensor,
             cos_t, sin_t, dtype):
    """Causal full-buffer forward over buf (b, t): returns (ks, vs) stacked
    per layer, (L, b, kv_heads, t, hd), and the per-row logits at position
    prompt_len[i]-1, (b, vocab). The attention is `causal_attention`: the
    flash kernel on the card."""
    b, t = buf.shape
    pos = torch.arange(t, device=buf.device)[None, :].expand(b, t)
    x = _embed(model, buf, pos, dtype)
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
    x = _embed(model, token[:, None], p1, dtype)
    cos, sin = _positions(cos_t, sin_t, p1)
    visible = (torch.arange(buf_len, device=token.device)[None, :]
               <= cur[:, None])[:, None, None, :]
    rows = torch.arange(b, device=token.device)
    # a freed slot's stale cursor can sit at buf_len: JAX drops that
    # out-of-bounds scatter, here it lands on the free row's own last
    # position — garbage into a row nothing reads before rewriting it
    wcur = cur.clamp(max=buf_len - 1)
    kvh = model.num_local_kv_heads
    g = model.num_local_heads // kvh
    hd = model.cfg.head_dim
    for li, lp in enumerate(model.layers):
        y = lp[model.attn_norm_key](x)
        q, k, v = _qkv(model, lp, y, dtype)       # q: (b, h, 1, hd); kv: kvh
        q, k = _rotate(model, q, k, cos, sin)
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
    x = _embed(model, token[:, None], p1, dtype)
    cos, sin = _positions(cos_t, sin_t, p1)
    rows = torch.arange(b, device=token.device)
    dst_page = page_tbl[rows, cur // page_size]        # (b,)
    dst_off = cur % page_size                          # (b,)
    for li, lp in enumerate(model.layers):
        y = lp[model.attn_norm_key](x)
        q, k, v = _qkv(model, lp, y, dtype)       # q: (b, h, 1, hd); kv: kvh
        q, k = _rotate(model, q, k, cos, sin)
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
    x = _embed(model, chunk, pos, dtype)
    cos, sin = _positions(cos_t, sin_t, pos)
    for li, lp in enumerate(model.layers):
        y = lp[model.attn_norm_key](x)
        q, k, v = _qkv(model, lp, y, dtype)       # q: (b, h, cw, hd)
        q, k = _rotate(model, q, k, cos, sin)
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


def _filter_logits(scaled: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """Top-k then top-p (nucleus) filtering of temperature-scaled (b, V)
    f32 logits, the JAX `_filter_logits`: filtered-out entries become
    -inf. Top-k keeps every entry at or above the k-th largest value (ties
    at the threshold all survive); top-p keeps the smallest descending
    prefix whose mass reaches top_p (the exclusive cumsum of the sorted
    softmax below top_p; the top token always survives), its threshold
    mapped back to the unsorted layout by value, so ties survive there
    too."""
    if top_k:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= kth, scaled, -math.inf)
    if top_p and top_p < 1.0:
        sorted_l = torch.sort(scaled, dim=-1, descending=True).values
        e = torch.exp(sorted_l - sorted_l[:, :1])
        probs = e / e.sum(dim=-1, keepdim=True)
        cum = torch.cumsum(probs, dim=-1) - probs      # exclusive
        thresh = torch.where(cum < top_p, sorted_l, math.inf).amin(
            dim=-1, keepdim=True)
        scaled = torch.where(scaled >= thresh, scaled, -math.inf)
    return scaled


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    by 16-bit halves, so no intermediate leaves [0, 2^63)."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 values in [0, 2^32): every
    shift acts on a non-negative value, so it is the logical shift."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(b, vocab) float64 Gumbel noise, a pure function of each row's
    (seed, absolute position) and the column: a counter-based hash (two
    MurmurHash3 finalizer rounds over a per-row key) gives 32 bits per
    entry, u = (h + 1/2) / 2^32 lies in (0, 1), and the noise is
    -log(-log u). Seeds are the requests' uint32 seeds (any int dtype; the
    low 32 bits count), positions int. The counterpart of JAX's
    `fold_in(fold_in(key(0), seed), pos)` stream, not its bits."""
    seed = seeds.long() & _M32
    pos = positions.long() & _M32
    key = _fmix32(_fmix32((seed + 0x9E3779B9) & _M32) ^ pos)[:, None]
    col = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    h = _fmix32(key ^ _mul32(col + 1, 0x27D4EB2F))
    h = _fmix32((h + _fmix32(key ^ 0x165667B1)) & _M32)
    u = (h.double() + 0.5) * 2.0 ** -32
    return -torch.log(-torch.log(u))


def sample_from_full(full: torch.Tensor, seeds: torch.Tensor,
                     positions: torch.Tensor, temperature: float,
                     top_k: int, top_p: float) -> torch.Tensor:
    """(b,) int64 token ids from full-vocab (b, V) f32 logits: the argmax
    at temperature 0, else the filtered, temperature-scaled logits plus
    `gumbel_noise` of each row's (seed, position), their argmax (first
    index on ties, as jnp.argmax)."""
    if temperature == 0.0:
        return torch.argmax(full, dim=-1)
    scaled = _filter_logits(full / temperature, top_k, top_p)
    noise = gumbel_noise(seeds, positions, full.shape[-1])
    return torch.argmax(scaled.double() + noise, dim=-1)


def make_token_sampler(model, temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 0.0):
    """`sample(logits, seeds, positions)` -> (b,) token ids from this
    rank's vocab columns: `sample_from_full` over the gathered full-vocab
    f32 logits (`_full_vocab_logits`), so every tp rank picks the same
    tokens. Greedy (temperature 0) ignores seeds and positions; a sampled
    row draws from the request's seed and the absolute position the token
    will occupy, whatever slot, batch or arrival it has (the JAX
    `make_token_sampler` contract). Runs in tensor ops only: it is
    captured with the decode step."""
    validate_sampling(model.cfg, temperature, top_k, top_p)

    def sample(logits: torch.Tensor, seeds=None,
               positions=None) -> torch.Tensor:
        return sample_from_full(_full_vocab_logits(model, logits), seeds,
                                positions, temperature, top_k, top_p)

    return sample


def host_sample_tokens(model, full_logits, seeds, positions,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 0.0) -> np.ndarray:
    """The debug host sampler (the JAX `host_sample_tokens`): the same
    `sample_from_full` on a host copy of the (b, >= vocab) full-vocab
    logits, on the CPU. The engines take it only behind
    `debug_host_sampler`, so tests and chip_smoke can hold the fused
    sampler's tokens against it; it moves b x vocab floats to the host per
    step where the fused path moves b ids."""
    full = torch.as_tensor(np.asarray(full_logits),
                           dtype=torch.float32)[:, :model.cfg.vocab_size]
    tok = sample_from_full(full, torch.as_tensor(np.asarray(seeds,
                                                            np.int64)),
                           torch.as_tensor(np.asarray(positions, np.int64)),
                           temperature, top_k, top_p)
    return tok.numpy().astype(np.int32)
