"""KV-cache decoding lowerings shared by the serving engines — counterpart
of the JAX `models/decode.py` (`_prefill`, `_prefill_cp`, `_decode_one`,
the paged `_paged_decode_one` / `_paged_prefill_chunk`, the sampler) — and
the one-shot decoder (`make_generate`, `GreedyDecoder`).

Slot caches are (num_layers, b, kv_heads, buf_len, head_dim) in the compute
dtype. Paged pools are (num_layers, num_pages + 1, kv_heads, page_size,
head_dim), or (codes int8, scales f32 (num_layers, num_pages + 1, kv_heads,
page_size)) tuples for int8 pages (serving/kv_manager.py); at cp > 1 a
rank's pool holds its slab of num_pages / cp pages + its own scratch page,
and the paged lowerings combine the ranks' partial attention
(`_cp_attend`). Under grouped-query attention they hold kv_heads entries and query head i reads kv
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
The hash takes a stream number, so the speculative engine's proposal,
accept and resample draws (`hash_uniform`) are streams of their own.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..ops.attention import MASK_VALUE, causal_attention
from ..config import resolve_dtype_on
from ..ops.collectives import all_gather, all_reduce_sum, copy_to, gather_from
from ..ops.cuda.block_attention import block_attention_plain
from ..ops.cuda.paged_attention import paged_attention
from ..ops.overlap import ag_matmul
from ..ops.quant import quantize_rows
from ..ops.ring_attention import ring_attention, ring_schedule
from ..ops.rope import apply_rotary, rope_tables
from ..parallel.linear import apply_column_ring_fused
from ..runtime.graphs import CapturedStep, use_decode_graph
from ..serving.kv_manager import local_page_ids

# the paged attends: the dense page view + einsum block (the oracle), or
# `paged_attention` (the CUDA kernel on the card, its plain version on CPU)
PAGED_ATTN_IMPLS = ("gather", "kernel")
# the padded vocab columns' logit (JAX `models/transformer.py` NEG_INF)
NEG_INF = -1e9


def _ring(model) -> bool:
    """Whether the layers run the tp ring collective matmuls (`tp_overlap`
    ring or ring_q, under sequence parallelism; JAX's `ring_ov`)."""
    return model.sequence_parallel and model.tp_overlap != "off"


def _qkv(model, lp, y: torch.Tensor, dtype):
    """Project y (b, t, d) -> q (b, local heads, t, hd) and k, v at (b,
    local kv heads, t, hd); y is the sublayer's shared input (`_tp_in`), so
    the projections take it as 'gathered'. Under the ring (`_ring`) y is
    this rank's (b, t/tp, d) chunk and wq/wk/wv share one ring
    (`apply_column_ring_fused`)."""
    b, t, _ = y.shape
    h = model.cfg.head_dim
    if _ring(model):
        t *= model.tp_size
        q, k, v = apply_column_ring_fused(
            [lp["wq"], lp["wk"], lp["wv"]], y, dtype,
            model.tp_overlap == "ring_q")
    else:
        q, k, v = (lp[w](y, dtype, "gathered") for w in ("wq", "wk", "wv"))
    split = lambda z, nh: z.reshape(b, t, nh, h).transpose(1, 2)
    return (split(q, model.num_local_heads),
            split(k, model.num_local_kv_heads),
            split(v, model.num_local_kv_heads))


def _tp_in(model, y: torch.Tensor) -> torch.Tensor:
    """A sublayer's normed input, shared by its column projections: at tp >
    1 one `copy_to` (whose backward all-reduces the projections' summed
    input gradient), or under sequence parallelism one all-gather of the
    sequence (the JAX `maybe_gather`: its backward is one reduce-scatter).
    Under the ring nothing is gathered: the projections' ring consumes the
    chunk."""
    if model.tp_size == 1 or _ring(model):
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


def _moe_ffn(model, lp, x: torch.Tensor, dtype):
    """x + the routed experts of norm(x), and the layer's aux sums (the JAX
    MoE branch of `_layer_body`, and of the decoder's `_finish_block`,
    where the aux sums go unused). Under sequence parallelism the router
    and the experts see the tp-gathered sequence (the same routing on
    every tp rank) and each rank keeps its chunk of the output."""
    y = lp[model.ffn_norm_key](x)
    sp = model.sequence_parallel
    if sp:
        y = gather_from(y, model.mesh, dim=-2)
    ff, aux = lp["moe"](y, dtype, sequence_parallel=sp)
    if sp:
        tl = ff.shape[1] // model.tp_size
        ff = ff[:, model.mesh.tp_rank * tl:(model.mesh.tp_rank + 1) * tl]
    return x + ff, aux


def _finish_block_aux(model, lp, x: torch.Tensor, o: torch.Tensor, dtype):
    """`_finish_block`, and the aux sums of a MoE layer (None for a dense
    one)."""
    b, t = o.shape[0], o.shape[2]
    o = o.transpose(1, 2).reshape(b, t,
                                  model.num_local_heads * model.cfg.head_dim)
    x = x + lp["wo"](o, dtype, _act_layout(model))
    if "moe" in lp:
        return _moe_ffn(model, lp, x, dtype)
    return _dense_ffn(model, lp, x, dtype), None


def _finish_block(model, lp, x: torch.Tensor, o: torch.Tensor,
                  dtype) -> torch.Tensor:
    """Residual + wo, then the FFN sublayer (shared by prefill and decode):
    the routed experts where the layer has a `moe` (inference runs them at
    ep = 1: every rank holds every expert), else the dense FFN."""
    return _finish_block_aux(model, lp, x, o, dtype)[0]


def _dense_ffn(model, lp, x: torch.Tensor, dtype) -> torch.Tensor:
    """x + the dense FFN of norm(x): gpt2's tanh-GELU MLP where the layer
    has an `fc`, else SwiGLU."""
    y = _tp_in(model, lp[model.ffn_norm_key](x))
    ring = _ring(model)
    if "fc" in lp:      # under the ring, fc's own (its overlap)
        h = torch.nn.functional.gelu(
            lp["fc"](y, dtype, "seq_sharded" if ring else "gathered"),
            approximate="tanh")
        return x + lp["proj"](h, dtype, _act_layout(model))
    if ring:
        g, u = apply_column_ring_fused([lp["gate_proj"], lp["up_proj"]], y,
                                       dtype, model.tp_overlap == "ring_q")
    else:
        g = lp["gate_proj"](y, dtype, "gathered")
        u = lp["up_proj"](y, dtype, "gathered")
    return x + lp["down_proj"](torch.nn.functional.silu(g) * u, dtype,
                               _act_layout(model))


def _block(model, lp, x: torch.Tensor, cos, sin, dtype,
           attend=causal_attention):
    """One full-sequence decoder layer (the JAX `_layer_body`): returns (x',
    k, v, aux), the layer's output, its post-RoPE k and v (local heads) and
    a MoE layer's aux sums (None for a dense layer). The
    attention is `attend(q, k, v)`: by default `causal_attention`, the flash
    kernels on the card; the cp training forward passes the ring or Ulysses
    attention over its chunk. Under sequence parallelism x and x' are this
    rank's chunk of the sequence and q, k, v cover the whole of it."""
    y = _tp_in(model, lp[model.attn_norm_key](x))
    q, k, v = _qkv(model, lp, y, dtype)
    q, k = _rotate(model, q, k, cos, sin)
    o = attend(q, k, v)
    x, aux = _finish_block_aux(model, lp, x, o, dtype)
    return x, k, v, aux


def _logits_tokens(model, x: torch.Tensor, dtype) -> torch.Tensor:
    """Final norm + head on (b, t, d) -> (b, t, vocab_padded / tp), this
    rank's vocab columns (under sequence parallelism x is the sequence
    chunk and the head all-gathers it); padded vocab columns are masked to
    NEG_INF (JAX `models/transformer.py`), so they carry no probability.
    A family without an `lm_head` (gpt2) ties the head to this rank's rows
    of the token embedding: `x @ embedding.weight.T`, the same local-vocab
    layout, and the embedding weight takes both gradients."""
    y = model.norm(x)
    if hasattr(model, "lm_head"):    # under the ring, lm_head's overlap
        logits = model.lm_head(y, dtype, _act_layout(model))
    elif _ring(model):
        logits = ag_matmul(y.to(dtype), (model.embedding.weight.to(dtype),),
                           model.mesh, model.tp_overlap == "ring_q")[0]
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
        x, k, v, _ = _block(model, lp, x, cos, sin, dtype)
        ks.append(k)
        vs.append(v)
    idx = (prompt_len.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
    last = torch.gather(x, 1, idx)
    return (torch.stack(ks).to(dtype), torch.stack(vs).to(dtype),
            _logits_last(model, last, dtype))


def _prefill_cp(model, buf: torch.Tensor, prompt_len: torch.Tensor,
                cos_t, sin_t, dtype):
    """The context-parallel `_prefill` (JAX `_prefill_cp`): buf (b, t) is
    the whole buffer on every rank; this cp rank takes its contiguous
    chunk of t / cp positions, every layer's attention is the ring
    (`ring_attention`: the block kernels on the card), and the layers'
    K/V chunks are all-gathered over cp in one collective, so the decode
    loop runs on the full caches, replicated over cp. The logits need one
    position per row (prompt_len - 1): the rank whose chunk holds it
    contributes its (b, 1, d) row and a sum over cp picks it (every other
    rank adds zeros, so the sum is exact). Returns what `_prefill`
    returns, the same on every cp rank."""
    mesh = model.mesh
    b, t = buf.shape
    i, tl = mesh.cp_rank, t // mesh.cp
    pos = (i * tl + torch.arange(tl, device=buf.device))[None, :].expand(b,
                                                                         tl)
    x = _embed(model, buf[:, i * tl:(i + 1) * tl], pos, dtype)
    cos, sin = _positions(cos_t, sin_t, pos)
    schedule = ring_schedule(pos, mesh)
    attend = lambda q, k, v: ring_attention(q, k, v, schedule, mesh)
    ks, vs = [], []
    for lp in model.layers:
        x, k, v, _ = _block(model, lp, x, cos, sin, dtype, attend)
        ks.append(k)
        vs.append(v)
    chunks = all_gather(torch.stack([torch.stack(ks), torch.stack(vs)]).to(
        dtype), mesh, "cp")                 # (cp, 2, L, b, kvh, tl, hd)
    kv = torch.cat(chunks.unbind(0), dim=-2)
    idx = prompt_len.long() - 1
    mine = (idx >= i * tl) & (idx < (i + 1) * tl)
    sel = torch.gather(x, 1, (idx - i * tl).clamp(0, tl - 1)[
        :, None, None].expand(b, 1, x.shape[-1]))
    last = all_reduce_sum(torch.where(mine[:, None, None], sel,
                                      torch.zeros_like(sel)), mesh, "cp")
    return kv[0], kv[1], _logits_last(model, last, dtype)


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


def _check_paged(attn_impl: str) -> None:
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


def _cp_pool_view(model, pool_k, page_tbl: torch.Tensor, page_size: int,
                  cp: int):
    """This cp rank's slice of the paged world (the JAX `_cp_pool_view`):
    its max_pages / cp page-table columns translated to LOCAL pool indices,
    the global position of its first column (`pos_offset`), and the
    global -> local translation for write destinations. Column j belongs
    to rank j // (max_pages / cp), and rank r's slab holds global pages [r
    * ppr, (r + 1) * ppr) plus one local scratch page at index ppr; an id
    the rank does not own translates to that scratch."""
    mpp = page_tbl.shape[1] // cp          # page-table columns per rank
    ppr = (pool_k[0] if isinstance(pool_k, tuple)
           else pool_k).shape[1] - 1        # local real pages (+1 scratch)
    r = model.mesh.cp_rank
    to_local = lambda ids: local_page_ids(ids, ppr, r)
    return (to_local(page_tbl[:, r * mpp:(r + 1) * mpp]), r * mpp * page_size,
            to_local)


def cp_combine(o: torch.Tensor, lse: torch.Tensor, mesh) -> torch.Tensor:
    """Merge the cp ranks' partial attention (o f32, normalised within the
    rank; lse over the rank's visible scores, -1e30 where it sees nothing)
    into the exact softmax over every rank's keys, the value of the JAX
    `_cp_combine` (one pmax and two psums) through ONE collective: o and
    lse packed into one f32 buffer, all-gathered over cp, and combined the
    same way on every rank, in rank order: m = max lse, w = exp(lse - m),
    o = sum o w / sum w. A dead rank's weight underflows to exactly 0; a
    row dead on every rank (a free row) gets w = 1 everywhere and o = 0, as
    at cp = 1. Every rank gets the same bits."""
    packed = torch.cat([o.float(), lse.float()[..., None]], dim=-1)
    every = all_gather(packed, mesh, "cp")          # (cp, ..., hd + 1)
    lses = every[..., -1]
    w = torch.exp(lses - lses.amax(dim=0))
    num, den = every[0, ..., :-1] * w[0, ..., None], w[0]
    for r in range(1, every.shape[0]):
        num = num + every[r, ..., :-1] * w[r, ..., None]
        den = den + w[r]
    return num / den[..., None]


def _cp_attend(model, q, k_cache, v_cache, tbl_cp, base: int, start, pos,
               page_size: int, dtype, attn_impl: str,
               qlen=None) -> torch.Tensor:
    """One layer's attend at cp > 1: every query of the dispatch over this
    rank's local pages, positioned at `base` — K3 with `pos_offset` and
    `return_lse` ('kernel'), or the dense local view through the block
    attend (`block_attention_plain` in f32, the JAX gather arm's
    `_block_attn_xla`) — then `cp_combine`: one cp hop per layer."""
    if attn_impl == "kernel":
        o, lse = paged_attention(q.contiguous(), k_cache, v_cache, tbl_cp,
                                 start, page_size=page_size, qlen=qlen,
                                 pos_offset=base, return_lse=True)
    else:
        k_view = _gather_page_view(k_cache, tbl_cp, dtype)
        v_view = _gather_page_view(v_cache, tbl_cp, dtype)
        t = k_view.shape[2]
        kv_pos = (base + torch.arange(t, device=q.device))[None, :].expand(
            q.shape[0], t)
        o, lse = block_attention_plain(q.float(), k_view.float(),
                                       v_view.float(), pos, kv_pos)
    return cp_combine(o, lse, model.mesh).to(dtype)


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
    'kernel' (`ops.cuda.paged_attention`).

    At `cp > 1` the pool is this rank's slab: a row writes its token's K/V
    only on the rank that owns the cursor's page (the others write their
    local scratch), attends over the rank's own page-table columns and the
    ranks' partials merge in `cp_combine` — the step's one cp hop per
    layer; pages never move."""
    _check_paged(attn_impl)
    b = token.shape[0]
    p1 = cur[:, None]
    x = _embed(model, token[:, None], p1, dtype)
    cos, sin = _positions(cos_t, sin_t, p1)
    rows = torch.arange(b, device=token.device)
    dst_page = page_tbl[rows, cur // page_size]        # (b,)
    dst_off = cur % page_size                          # (b,)
    if cp > 1:
        tbl_cp, base, to_local = _cp_pool_view(model, pool_k, page_tbl,
                                               page_size, cp)
        dst_page = to_local(dst_page)
    for li, lp in enumerate(model.layers):
        y = lp[model.attn_norm_key](x)
        q, k, v = _qkv(model, lp, y, dtype)       # q: (b, h, 1, hd); kv: kvh
        q, k = _rotate(model, q, k, cos, sin)
        k_cache = _layer_pool(pool_k, li)
        v_cache = _layer_pool(pool_v, li)
        _paged_cache_write(k_cache, k[:, :, 0, :], dst_page, dst_off)
        _paged_cache_write(v_cache, v[:, :, 0, :], dst_page, dst_off)
        if cp > 1:
            o = _cp_attend(model, q, k_cache, v_cache, tbl_cp, base, cur, p1,
                           page_size, dtype, attn_impl)
        else:
            o = _paged_attend(q, k_cache, v_cache, page_tbl, cur, p1,
                              page_size, dtype, attn_impl)
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
    value-identical to the whole-buffer `_prefill`.

    At `cp > 1` the pool is this rank's slab: every rank runs the chunk's
    projections and MLP (replicated), writes the K/V of the columns whose
    pages it owns (the rest aim at its local scratch), attends EVERY chunk
    query over its own pages and the ranks' partials merge in `cp_combine`
    (one cp hop per layer, where the JAX ring of queries takes cp); each
    rank's attend covers cw queries x T / cp keys, as over the ring."""
    _check_paged(attn_impl)
    b, cw = chunk.shape
    pos = start[:, None] + torch.arange(cw, device=chunk.device,
                                        dtype=start.dtype)[None, :]
    x = _embed(model, chunk, pos, dtype)
    cos, sin = _positions(cos_t, sin_t, pos)
    if cp > 1:
        tbl_cp, base, to_local = _cp_pool_view(model, pool_k, page_tbl,
                                               page_size, cp)
        dst_page = to_local(dst_page)       # non-owned columns -> scratch
    for li, lp in enumerate(model.layers):
        y = lp[model.attn_norm_key](x)
        q, k, v = _qkv(model, lp, y, dtype)       # q: (b, h, cw, hd)
        q, k = _rotate(model, q, k, cos, sin)
        k_cache = _layer_pool(pool_k, li)
        v_cache = _layer_pool(pool_v, li)
        _paged_cache_write(k_cache, k.transpose(1, 2), dst_page, dst_off)
        _paged_cache_write(v_cache, v.transpose(1, 2), dst_page, dst_off)
        if cp > 1:
            o = _cp_attend(model, q, k_cache, v_cache, tbl_cp, base, start,
                           pos, page_size, dtype, attn_impl, qlen=qlen)
        else:
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


def _row_keys(seeds: torch.Tensor, positions: torch.Tensor,
              stream: int = 0) -> torch.Tensor:
    """The hash's per-row key of (seed, absolute position) in stream
    `stream` (seeds and positions broadcast together): stream 0 is the
    plain sampler's, and any other stream mixes its number in through one
    more finalizer round, so the streams are independent of each other."""
    seed = seeds.long() & _M32
    pos = positions.long() & _M32
    key = _fmix32(_fmix32((seed + 0x9E3779B9) & _M32) ^ pos)
    if stream:
        key = _fmix32(key ^ ((stream * 0x2545F491) & _M32))
    return key


def hash_uniform(seeds: torch.Tensor, positions: torch.Tensor, cols: int,
                 stream: int = 0) -> torch.Tensor:
    """(..., cols) float64 uniforms in (0, 1), a pure function of each
    row's (seed, absolute position), the stream and the column: a
    counter-based hash (two MurmurHash3 finalizer rounds over the row's
    key, `_row_keys`) gives 32 bits per entry and u = (h + 1/2) / 2^32.
    Seeds are the requests' uint32 seeds (any int dtype; the low 32 bits
    count), positions int; the two broadcast together."""
    key = _row_keys(seeds, positions, stream)[..., None]
    col = torch.arange(cols, device=key.device, dtype=torch.int64)
    h = _fmix32(key ^ _mul32(col + 1, 0x27D4EB2F))
    h = _fmix32((h + _fmix32(key ^ 0x165667B1)) & _M32)
    return (h.double() + 0.5) * 2.0 ** -32


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor,
                 vocab: int, stream: int = 0) -> torch.Tensor:
    """(b, vocab) float64 Gumbel noise -log(-log u) of `hash_uniform`'s u:
    a pure function of each row's (seed, absolute position), the stream
    and the column. Stream 0 is the plain sampler's; the speculative
    engine draws its proposals and resamples in streams of their own
    (`serving/speculative.py`). The counterpart of JAX's
    `fold_in(fold_in(key(0), seed), pos)` stream, not its bits."""
    return -torch.log(-torch.log(hash_uniform(seeds, positions, vocab,
                                              stream)))


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


# ------------------------------------------------------ one-shot decoding --

# decode steps between two reads of the done mask: the loop's only host
# syncs besides the final read of the buffer
DONE_CHECK_EVERY = 32


class _Generate:
    """The whole-generation program of `make_generate` for one model: the
    prefill, then one decode step per position, each step's state on the
    card (see `make_generate`)."""

    def __init__(self, model, buf_len: int, temperature: float, top_k: int,
                 top_p: float):
        cfg = model.cfg
        self.model, self.buf_len = model, buf_len
        self.device = model.embedding.weight.device
        self.dtype = resolve_dtype_on(cfg.compute_dtype, self.device)
        # RoPE tables over the whole buffer, past the trained maxlen too
        self.tables = decode_tables(model, max(cfg.maxlen, buf_len),
                                    self.device)
        self.sample = make_token_sampler(model, temperature, top_k, top_p)
        self.graph = use_decode_graph("auto", self.device, model.tp_size,
                                      model.cp_size)
        self._graphs = {}       # batch rows -> CapturedStep
        self.host_syncs = 0     # of the last call
        # the last call's prefill and loop times and its decode steps
        self.timing = {"prefill_ms": 0.0, "loop_ms": 0.0, "steps": 0}

    def _mark(self):
        """A time mark that costs no host sync: a CUDA event on a card (read
        after the final sync), the host clock on the CPU."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _ms(self, a, b) -> float:
        return (a.elapsed_time(b) if self.device.type == "cuda"
                else (b - a) * 1e3)

    def _step(self, buf, ck, cv, nxt, done, gen, cur, plen, limit, eos,
              seeds):
        """One position of every row, IN PLACE (the JAX loop body): a row
        still inside its prompt re-feeds its own token, a done row writes
        eos, the others the token sampled last; then the step's candidate
        for position cur + 1, which a row counts once it is past its
        prompt."""
        in_prompt = cur < plen
        tok = torch.where(in_prompt, buf.gather(1, cur[:, None])[:, 0],
                          torch.where(done, eos, nxt))
        gen.add_((~(in_prompt | done)).long())
        buf.scatter_(1, cur[:, None], tok[:, None])
        logits = _decode_one(self.model, ck, cv, tok, cur, self.buf_len,
                             *self.tables, self.dtype)
        cand = self.sample(logits, seeds, cur + 1)
        done |= ((cur + 1) >= plen) & (cand == eos)
        done |= plen + gen >= limit
        nxt.copy_(cand)
        cur.add_(1)

    def __call__(self, buf, prompt_len, eos_id: int, max_total_len,
                 seed: int = 0):
        dev, L = self.device, self.buf_len
        buf_h = np.asarray(buf, dtype=np.int64)
        b = buf_h.shape[0]
        if buf_h.shape[1] != L:
            raise ValueError(f"buf has {buf_h.shape[1]} columns; the "
                             f"decoder's buf_len is {L}")
        plen_h = np.broadcast_to(np.asarray(prompt_len, np.int64), (b,))
        limit_h = np.minimum(np.broadcast_to(
            np.asarray(max_total_len, np.int64), (b,)), L)
        cur0 = int(plen_h.min())
        with torch.inference_mode():
            marks = [self._mark()]
            t = lambda a: torch.from_numpy(np.array(a)).to(dev)
            buf, plen, limit = t(buf_h), t(plen_h), t(limit_h)
            eos = torch.full((b,), eos_id, dtype=torch.long, device=dev)
            seeds = t(np.broadcast_to(np.asarray(seed, np.int64), (b,)))
            prefill = _prefill_cp if self.model.cp_size > 1 else _prefill
            ks, vs, logits = prefill(self.model, buf, plen, *self.tables,
                                     self.dtype)
            cur = torch.full((b,), cur0, dtype=torch.long, device=dev)
            nxt = self.sample(logits, seeds, cur)
            done = ((plen == cur0) & (nxt == eos)) | (plen >= limit)
            gen = torch.zeros(b, dtype=torch.long, device=dev)
            state = [buf, ks, vs, nxt, done, gen, cur, plen, limit, eos,
                     seeds]
            step = self._step
            if self.graph:
                if b not in self._graphs:
                    self._graphs[b] = CapturedStep(self._step, state)
                graph = self._graphs[b]
                # the warm-up ran real steps on the graph's buffers
                for dst, src in zip(graph.inputs, state):
                    dst.copy_(src)
                state, step = graph.inputs, lambda *_: graph()
            marks.append(self._mark())
            syncs = steps = 0
            for i in range(max(0, int(limit_h.max()) - cur0)):
                if i and i % DONE_CHECK_EVERY == 0:
                    syncs += 1
                    if bool(state[4].all()):
                        break
                step(*state)
                steps += 1
            marks.append(self._mark())
            out = torch.cat([state[0], (state[7] + state[5])[:, None]],
                            dim=1).cpu().numpy()
            self.host_syncs = syncs + 1
            self.timing = {"prefill_ms": self._ms(*marks[:2]),
                           "loop_ms": self._ms(*marks[1:]), "steps": steps}
        return out[:, :L].astype(np.int32), out[:, L].astype(np.int32)


def make_generate(model, mesh, buf_len: int, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 0.0):
    """The whole-generation program (JAX `make_generate`): `generate(buf
    (b, buf_len), prompt_len, eos_id, max_total_len, seed=0) -> (buf with
    the generated tokens written, each row's total length (b,))`, numpy
    int32, on the model's weights (`mesh` is the model's; the model holds
    its shard of the weights).

    `prompt_len`, `max_total_len` and `seed` may be scalars or (b,)
    vectors: mixed
    prompt lengths decode in one call and each row stops at its own EOS or
    total-length limit. The cursor is shared by the rows ("teacher-forced
    catch-up"): it starts at min(prompt_len), and a row whose prompt runs
    past it re-feeds its own prompt tokens (recomputing the K/V the
    prefill wrote, to the same values under causal attention) until it
    clears its prompt. Temperature 0 is greedy; above it the port's hash
    sampler (`make_token_sampler`: top-k, then top-p, then a Gumbel-max
    draw keyed by (seed, absolute position)), so a sampled row's tokens
    depend on `seed` and nothing else.

    The prefill is `_prefill` (K1 on the card) or, at cp > 1, the ring
    prefill `_prefill_cp` (K2); the decode loop then runs one step per
    position with every piece of its state on the card: the buffer, the
    caches, the last candidates, the done mask and the counts. No step
    reads the card: at tp = cp = 1 on a card the step is one captured CUDA
    graph (`runtime/graphs.CapturedStep`, one per batch size, where the
    engines' 'auto' captures: `use_decode_graph`), and the
    host knows from the prompt lengths and limits how many steps it can
    take at most. It reads the done mask once every `DONE_CHECK_EVERY`
    steps, to stop once every row is done, and the buffer and lengths
    once at the end: 1 + floor((steps - 1) / DONE_CHECK_EVERY) host syncs
    a generation (`host_syncs`). Steps past a row's end write eos where no
    result reads, so the result does not depend on where the loop stops.
    At tp or cp > 1 the step runs eagerly (its gloo hops are staged
    through the host) and every rank decodes the same tokens."""
    validate_sampling(model.cfg, temperature, top_k, top_p)
    return _Generate(model, buf_len, temperature, top_k, top_p)


class GreedyDecoder:
    """The KV-cache decoder of the JAX package: `make_generate` built once
    for a buffer length and reused across prompts. Greedy by default (the
    name is the reference's contract); `temperature` / `top_k` / `top_p`
    sample, and `seed` makes the draws reproducible.

    At cp > 1 the prefill runs the ring over the cp group (the training
    path's long-context attention), so a prompt longer than one card's
    attention budget prefills across the group; it needs
    cp_impl='ring' with the contiguous layout and a buffer that splits
    into cp equal chunks. A family with learned positions (gpt2) caps the
    buffer at its position table. The refusals are JAX's, word for
    word."""

    def __init__(self, model, mesh, buf_len: int, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0):
        if model.cp_size > 1:
            if model.cp_impl != "ring" or model.cp_layout != "contiguous":
                raise ValueError(
                    "cp decode supports cp_impl='ring' with the contiguous "
                    f"layout (got impl={model.cp_impl!r}, "
                    f"layout={model.cp_layout!r})")
            if buf_len % model.cp_size:
                raise ValueError(f"buf_len {buf_len} must be divisible by "
                                 f"cp_size {model.cp_size} (contiguous "
                                 f"chunks)")
        cap = getattr(model, "max_decode_positions", None)
        if cap is not None and buf_len > cap:
            raise ValueError(
                f"buf_len {buf_len} exceeds the model's learned position "
                f"table ({cap}); clamp the buffer (evaluate.greedy_decode "
                f"does) or retrain with a larger maxlen")
        self.model = model
        self.mesh = mesh
        self.buf_len = buf_len
        self.generate = make_generate(model, mesh, buf_len,
                                      temperature=temperature, top_k=top_k,
                                      top_p=top_p)

    @property
    def host_syncs(self) -> int:
        """The host syncs of the last generation (`make_generate`)."""
        return self.generate.host_syncs

    @property
    def timing(self) -> dict:
        """The last generation's prefill and decode-loop ms (CUDA events on
        a card) and its decode steps."""
        return self.generate.timing

    def decode(self, prompt_ids, eos_id: int, max_total_len: int,
               seed: int = 0) -> list:
        """One prompt (ids with BOS) -> its generated ids (prompt
        excluded), stopping at EOS or `max_total_len` tokens in all."""
        return self.decode_batch([prompt_ids], eos_id, max_total_len,
                                 seed=seed)[0]

    def decode_batch(self, prompts, eos_id: int, max_total_len,
                     seed: int = 0) -> list:
        """A list of prompts of any lengths, in one generation: one list
        of generated ids per prompt. `max_total_len` and `seed` are shared
        or one per prompt."""
        b = len(prompts)
        for p in prompts:
            if len(p) >= self.buf_len:
                raise ValueError(f"prompt length {len(p)} must leave room "
                                 f"in buf_len {self.buf_len}")
        buf = np.full((b, self.buf_len), eos_id, dtype=np.int32)
        for i, p in enumerate(prompts):
            buf[i, :len(p)] = p
        plens = np.asarray([len(p) for p in prompts], np.int32)
        buf, flen = self.generate(buf, plens, eos_id, max_total_len, seed)
        return [buf[i, len(prompts[i]):int(flen[i])].tolist()
                for i in range(b)]
