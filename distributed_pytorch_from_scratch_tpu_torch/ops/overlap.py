"""The communication-overlap ops of the JAX `ops/overlap.py`: the ring
collective matmuls of tensor parallelism, and the data-parallel gradient
wires (bucketed reduction, its bf16 and int8 wires, and the gather of
dp-sharded leaves whose backward is a reduce-scatter).

The ring collective matmuls (`--tp_overlap ring | ring_q`; "On
Optimizing the Communication of Model Parallelism", arXiv:2211.05322)
decompose sequence parallelism's monolithic all-gather before a column
layer and reduce-scatter after a row layer into n steps over the tp ring,
each step's hop started before the partial product of the chunk in hand
(`collectives.start_hop`), so the transfer runs while the card computes:

* `ag_matmul(x, ws, mesh, quantized)` — the all-gather of x (..., t/n, d)
  over the sequence, then x @ w^T for each w of `ws` (several weights share
  one ring: wq/wk/wv, gate/up), as (..., t, o_j) outputs. At step s the
  chunk in hand came from rank (r - s) mod n and fills those output rows.
  Its backward (JAX `_ag_matmul_bwd`) runs two rings at once: the
  re-gather of x for the weight gradients and the dx reduce ring, whose
  step s adds the partial for rank (r + n-1-s) mod n;
* `matmul_rs(x, w, mesh, quantized)` — x (..., t, f) @ w^T reduced over
  the ranks and scattered over the sequence: this rank's (..., t/n, o).
  Step s computes the partial for rank (r + n-1-s) mod n and adds it to
  the accumulator that arrives; its backward (JAX `_matmul_rs_bwd`) is one
  gather ring of the cotangent.

Weights are in torch's (odim, idim) layout, so a partial is chunk @ w^T.
The rings add the ranks' partials in a fixed rank order, not in the
monolithic reduce-scatter's: they agree with it to float tolerance, not
bitwise. Under `quantized` (ring_q) the gather rings (ag's forward and both
backward re-gathers) quantize each chunk once, at its origin, with
`quant.quantize_rows` (one f32 scale per row), and every rank, the origin
too, dequantizes before its product; the reduce rings (rs's forward, ag's
dx ring) requantize the accumulator before each hop (JAX `_ring_hop_q`).
The codes and their scales travel in one message. A sequence the ring
cannot split evenly is refused; at n = 1 the ring makes no hop.

* `bucket_partition(sizes, bucket_bytes)` — the JAX rule: leaves in list
  order, consecutive, <= bucket_bytes each (a larger leaf alone).
* `bucketed_psum(leaves, mesh, axes, bucket_mb, wire)` — the sum of each
  leaf over `axes` (mesh group names, reduced one after the other), one
  flat all-reduce per bucket: the stage 0/1 reducer under
  `--dp_reduce_bucket_mb`.
* `bucketed_reduce_scatter(leaves, dims, mesh, axis, other_axes, ...)` —
  ZeRO-2's wire: each leaf summed over `axis` (dp) and only this rank's
  1/n shard along `dims[i]` returned. The layout is JAX's: each leaf's
  scatter dim moves to the front as an (n, size/n) matrix whose row r is
  rank r's shard, a bucket's matrices are concatenated by column, and one
  reduce-scatter runs per bucket. `other_axes` (cp, and tp for the leaves
  sequence parallelism leaves replicated over tp) are then summed in f32
  on the 1/n shard.
* The wire dtype compresses the wire only: `"bf16"` casts a bucket to
  bfloat16 for the collective and back to f32 after it; `"int8"` runs the
  block-scaled int8 ring (EQuARX, arXiv:2506.17615; the JAX
  `_quantized_rs_blocks`, `quantized_reduce_scatter`,
  `_quantized_allreduce_axis` and `quantized_allreduce`): the partial sum
  of block j starts at rank j+1 and walks the +1 ring, each rank
  dequantizing the arriving int8 codes (one f32 scale per
  `quant.WIRE_GROUP` elements, packed behind the codes in one message),
  adding its own f32 block and requantizing for the next hop; the gather
  half quantizes each owned block once, at its owner, and every rank (the
  owner too) dequantizes the same codes, so the result is bitwise the same
  on every rank. Each leaf is padded to a WIRE_GROUP multiple so no scale
  spans two leaves. Gradients are f32 before and after.
* `gather_shards(shards, dims, mesh, axis)` — ZeRO-3's parameter gather:
  every rank's shard of each leaf, concatenated along its dim, through one
  flat all-gather; its backward hands each rank the axis-summed cotangent
  of its own shard through one flat reduce-scatter (the transpose of JAX's
  `ring_all_gather`). `gather_full` is the same gather with no autograd
  (the stage 1/2 parameter gather after Adam, and checkpoints).

All hops go through `ops/collectives` (staged through host memory under
gloo, counted in its `stats`: the rings' under 'tp').
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .collectives import (_all_reduce, _gather, _permute, _scatter,
                          all_gather, start_hop)
from .quant import (WIRE_GROUP, dequantize_groups, dequantize_rows,
                    quantize_groups, quantize_rows)

WIRES = ("f32", "bf16", "int8")


def bucket_partition(sizes: Sequence[int], bucket_bytes: int,
                     itemsize: int = 4) -> List[List[int]]:
    """Leaf indices grouped into consecutive buckets of <= bucket_bytes each
    (a single leaf larger than the bound gets its own bucket), in list
    order, so every rank builds the same schedule."""
    buckets, cur, cur_bytes = [], [], 0
    for i, size in enumerate(sizes):
        nbytes = size * itemsize
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _check_wire(wire: str) -> None:
    if wire not in WIRES:
        raise ValueError(f"wire dtype {wire!r}; expected one of {WIRES}")


def _pack(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes and their f32 scales as one int8 message."""
    return torch.cat([q, scale.contiguous().view(torch.int8)])


def _unpack(msg: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return msg[:n], msg[n:].contiguous().view(torch.float32)


def _quantized_rs_blocks(blocks: torch.Tensor, mesh, axis: str,
                         group: int = WIRE_GROUP) -> torch.Tensor:
    """The reduce-scatter phase of the int8 ring over `axis`: `blocks` is
    (n, P) f32, P a multiple of `group`, row j this rank's part of the
    block rank j owns. Returns this rank's block summed over the axis, in
    f32 (n - 1 requantized hops)."""
    ax = mesh.axis(axis)
    n, idx = ax.size, ax.rank
    chunk = blocks.shape[1]
    send = blocks[(idx - 1) % n]
    for s in range(1, n):
        msg = _permute(_pack(*quantize_groups(send, group)), mesh, 1, axis)
        send = (dequantize_groups(*_unpack(msg, chunk), chunk, group)
                + blocks[(idx - 1 - s) % n])
    return send


def quantized_reduce_scatter(blocks: torch.Tensor, mesh, axis: str,
                             group: int = WIRE_GROUP) -> torch.Tensor:
    """The block-scaled int8 ring reduce-scatter over `axis`: `blocks` is
    (n, P), n the axis size, P a multiple of `group`; returns this rank's
    (P,) f32 sum. Half the wire of `quantized_allreduce`."""
    n = mesh.axis(axis).size
    if blocks.ndim != 2 or blocks.shape[0] != n:
        raise ValueError(
            f"quantized_reduce_scatter needs (axis_size, P) blocks; got "
            f"shape {tuple(blocks.shape)} on axis {axis!r} of size {n}")
    if blocks.shape[1] % group:
        raise ValueError(
            f"quantized_reduce_scatter needs P % group == 0 so no scale "
            f"group straddles a block boundary; got P={blocks.shape[1]}, "
            f"group={group}")
    if n == 1:
        return blocks[0]
    return _quantized_rs_blocks(blocks.float(), mesh, axis, group)


def _quantized_allreduce_axis(x: torch.Tensor, mesh, axis: str,
                              group: int = WIRE_GROUP) -> torch.Tensor:
    """The block-scaled int8 ring all-reduce of a flat f32 vector over
    `axis`: the reduce-scatter phase, then each owner's block quantized
    once and all-gathered; bitwise the same on every rank."""
    ax = mesh.axis(axis)
    n = ax.size
    if n == 1:
        return x
    size = x.shape[0]
    chunk = -(-size // n)
    chunk = -(-chunk // group) * group      # scale groups never straddle
    blocks = F.pad(x.float(), (0, n * chunk - size)).reshape(n, chunk)
    own = _quantized_rs_blocks(blocks, mesh, axis, group)
    msgs = all_gather(_pack(*quantize_groups(own, group)), mesh, axis)
    out = torch.cat([dequantize_groups(*_unpack(m, chunk), chunk, group)
                     for m in msgs.unbind(0)])
    return out[:size]


def quantized_allreduce(x: torch.Tensor, mesh, axes,
                        group: int = WIRE_GROUP) -> torch.Tensor:
    """The int8 ring all-reduce over each of `axes` in turn (the sum over
    their product); axes of size 1 are free."""
    for axis in ((axes,) if isinstance(axes, str) else axes):
        x = _quantized_allreduce_axis(x, mesh, axis, group)
    return x


def bucketed_psum(leaves: Sequence[torch.Tensor], mesh, axes,
                  bucket_mb: float = 25.0,
                  wire: str = "f32") -> List[torch.Tensor]:
    """Each leaf summed over `axes` (mesh group names, one after the
    other), as new f32 tensors: one flat collective per axis per <=
    bucket_mb bucket (`bucket_partition` on the leaves' f32 bytes), the
    wire in `wire`'s dtype."""
    _check_wire(wire)
    axes = [a for a in ((axes,) if isinstance(axes, str) else axes)
            if mesh.axis(a).size > 1]
    leaves = list(leaves)
    if not axes or not leaves:
        return [t.float() for t in leaves]
    pad = lambda t: (-t.numel()) % WIRE_GROUP if wire == "int8" else 0
    out: List[torch.Tensor] = [None] * len(leaves)
    for idxs in bucket_partition([t.numel() for t in leaves],
                                 int(bucket_mb * 2**20)):
        flat = torch.cat([F.pad(leaves[i].reshape(-1).float(),
                                (0, pad(leaves[i]))) for i in idxs])
        if wire == "int8":
            flat = quantized_allreduce(flat, mesh, axes)
        else:
            if wire == "bf16":
                flat = flat.to(torch.bfloat16)
            for a in axes:
                flat = _all_reduce(flat, mesh, a, owned=True)
            flat = flat.float()
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view(leaves[i].shape)
            off += n + pad(leaves[i])
    return out


def _rows(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """t as an (n, numel/n) matrix whose row r is rank r's chunk along
    `dim`."""
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"{n} ranks")
    return t.movedim(dim, 0).reshape(n, -1)


def _from_row(row: torch.Tensor, like: Sequence[int], dim: int,
              n: int) -> torch.Tensor:
    """The inverse of one row of `_rows`: a flat chunk back to the shard's
    shape (`like` the full shape, `dim` split n ways)."""
    moved = [like[dim] // n] + [s for i, s in enumerate(like) if i != dim]
    return row.reshape(moved).movedim(0, dim)


def bucketed_reduce_scatter(leaves: Sequence[torch.Tensor],
                            dims: Sequence[int], mesh, axis: str = "dp",
                            other_axes=(), bucket_mb: float = 25.0,
                            wire: str = "f32") -> List[torch.Tensor]:
    """Each leaf summed over `axis` and `other_axes`, this rank's shard of
    it along `dims[i]` returned (f32; see the module docstring): one
    reduce-scatter per bucket, the buckets those of `bucketed_psum` on the
    full leaves' bytes."""
    _check_wire(wire)
    n = mesh.axis(axis).size
    other = [a for a in other_axes if mesh.axis(a).size > 1]

    def rows(i):      # built per bucket: one bucket's copies at a time
        m = _rows(leaves[i].float(), dims[i], n)
        return (F.pad(m, (0, (-m.shape[1]) % WIRE_GROUP)) if wire == "int8"
                else m)

    out: List[torch.Tensor] = [None] * len(leaves)
    for idxs in bucket_partition([t.numel() for t in leaves],
                                 int(bucket_mb * 2**20)):
        parts = [rows(i) for i in idxs]
        flat = torch.cat(parts, dim=1)
        if n == 1:
            own = flat[0]
        elif wire == "int8":
            own = quantized_reduce_scatter(flat, mesh, axis)
        elif wire == "bf16":
            own = _scatter(flat.to(torch.bfloat16).reshape(-1), mesh, axis,
                           0).float()
        else:
            own = _scatter(flat.reshape(-1), mesh, axis, 0)
        for a in other:
            own = _all_reduce(own, mesh, a, owned=True)
        off = 0
        for i, part in zip(idxs, parts):
            per = leaves[i].numel() // n
            out[i] = _from_row(own[off:off + per], leaves[i].shape, dims[i],
                               n)
            off += part.shape[1]
    return out


def _full_shape(shape: Sequence[int], dim: int, n: int) -> List[int]:
    """A shard's shape with `dim` n times as long: the leaf's."""
    return [x * n if i == dim else x for i, x in enumerate(shape)]


def gather_full(shards: Sequence[torch.Tensor], dims: Sequence[int], mesh,
                axis: str = "dp") -> List[torch.Tensor]:
    """Every rank's shard of each leaf, concatenated along `dims[i]` in
    axis order, through one flat all-gather (no autograd)."""
    n = mesh.axis(axis).size
    if n == 1 or not shards:
        return list(shards)
    flat = torch.cat([s.detach().movedim(d, 0).reshape(-1)
                      for s, d in zip(shards, dims)])
    rows = _gather(flat, mesh, axis, 0).view(n, -1)
    out, off = [], 0
    for s, d in zip(shards, dims):
        part = rows[:, off:off + s.numel()]
        moved = [n * s.shape[d]] + [x for i, x in enumerate(s.shape)
                                    if i != d]
        out.append(part.reshape(moved).movedim(0, d).contiguous())
        off += s.numel()
    return out


class _GatherShards(torch.autograd.Function):
    """`gather_full` forward; backward, one flat reduce-scatter of the
    cotangents: each rank gets the axis-summed cotangent of its shard."""

    @staticmethod
    def forward(ctx, mesh, axis, dims, *shards):
        ctx.args = (mesh, axis, dims, [s.shape for s in shards],
                    shards[0].device)
        return tuple(gather_full(shards, dims, mesh, axis))

    @staticmethod
    def backward(ctx, *grads):
        mesh, axis, dims, shapes, device = ctx.args
        n = mesh.axis(axis).size
        full = [_full_shape(shape, d, n) for shape, d in zip(shapes, dims)]
        rows = [_rows(torch.zeros(f, device=device) if g is None
                      else g.float(), d, n)
                for g, d, f in zip(grads, dims, full)]
        own = _scatter(torch.cat(rows, dim=1).reshape(-1), mesh, axis, 0)
        outs, off = [], 0
        for row, d, f in zip(rows, dims, full):
            outs.append(_from_row(own[off:off + row.shape[1]], f, d, n))
            off += row.shape[1]
        return (None, None, None, *outs)


def gather_shards(shards: Sequence[torch.Tensor], dims: Sequence[int], mesh,
                  axis: str = "dp") -> List[torch.Tensor]:
    """`gather_full` with autograd: the backward reduce-scatters the
    cotangents over `axis` (ZeRO-3's gradient wire)."""
    if mesh.axis(axis).size == 1 or not shards:
        return list(shards)
    return list(_GatherShards.apply(mesh, axis, tuple(dims), *shards))


# ----------------------------------------------- ring collective matmuls --

# tags of the two rings ag_matmul's backward keeps in flight at once
_TAG_GATHER, _TAG_REDUCE = 1, 2


def _encode(x: torch.Tensor, quantized: bool):
    """(message, chunk): what a hop carries and what this rank's product
    takes — x and x, or under `quantized` one int8 message of its f32 row
    scales' bytes (first, so they stay 4-byte aligned) and its int8 row
    codes, and their dequantized x~."""
    if not quantized:
        return x, x
    q, sc = quantize_rows(x)
    return (torch.cat([sc.reshape(-1).view(torch.int8), q.reshape(-1)]),
            dequantize_rows(q, sc, x.dtype))


def _unpack_rows(msg: torch.Tensor, like: torch.Tensor):
    """A quantized message -> (codes, scales) of `like`'s rows."""
    m = like.numel() // like.shape[-1]
    return (msg[4 * m:].view(like.shape),
            msg[:4 * m].view(torch.float32).view(like.shape[:-1]))


def _decode(msg: torch.Tensor, like: torch.Tensor,
            quantized: bool) -> torch.Tensor:
    """A message back to a tensor of `like`'s shape and dtype."""
    if not quantized:
        return msg
    return dequantize_rows(*_unpack_rows(msg, like), like.dtype)


def _seq_rows(a: torch.Tensor, slot: int, tl: int) -> torch.Tensor:
    return a[..., slot * tl:(slot + 1) * tl, :]


def _weight_grad(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum over the batch and sequence of dy^T x: (o, d) from (..., o) and
    (..., d)."""
    return dy.reshape(-1, dy.shape[-1]).t() @ x.reshape(-1, x.shape[-1])


def _ag_forward(x, ws, mesh, quantized):
    ax = mesh.axis("tp")
    n, r, tl = ax.size, ax.rank, x.shape[-2]
    outs = [x.new_empty(*x.shape[:-2], tl * n, w.shape[0]) for w in ws]
    msg, chunk = _encode(x, quantized)
    for s in range(n):
        # the hop first: it does not wait on this step's products
        hop = start_hop(msg, mesh, "tp", _TAG_GATHER) if s < n - 1 else None
        slot = (r - s) % n          # the origin of the chunk in hand
        for out, w in zip(outs, ws):
            _seq_rows(out, slot, tl).copy_(torch.matmul(chunk, w.t()))
        if hop is not None:
            msg = hop.wait()
            chunk = _decode(msg, x, quantized)
    return outs


def _ag_backward(x, ws, dys, mesh, quantized):
    ax = mesh.axis("tp")
    n, r, tl = ax.size, ax.rank, x.shape[-2]
    dws = [torch.zeros_like(w) for w in ws]
    msg, chunk = _encode(x, quantized)
    dx_acc = dx_hop = None
    for s in range(n):
        gather = (start_hop(msg, mesh, "tp", _TAG_GATHER) if s < n - 1
                  else None)
        # the re-gather ring: the chunk in hand pairs with the cotangent
        # rows of its origin; the dx ring: this step's partial is for the
        # rank whose accumulator arrives next
        slot, dest = (r - s) % n, (r + n - 1 - s) % n
        part = None
        for j, (w, dy) in enumerate(zip(ws, dys)):
            dws[j] = dws[j] + _weight_grad(_seq_rows(dy, slot, tl), chunk)
            p = torch.matmul(_seq_rows(dy, dest, tl), w)
            part = p if part is None else part + p
        dx_acc = (part if s == 0
                  else _decode(dx_hop.wait(), part, quantized) + part)
        if s < n - 1:
            dx_hop = start_hop(_encode(dx_acc, quantized)[0], mesh, "tp",
                               _TAG_REDUCE)
        if gather is not None:
            msg = gather.wait()
            chunk = _decode(msg, x, quantized)
    return dx_acc.to(x.dtype), [dw.to(w.dtype) for dw, w in zip(dws, ws)]


def _rs_forward(x, w, mesh, quantized):
    ax = mesh.axis("tp")
    n, r = ax.size, ax.rank
    tl = x.shape[-2] // n
    acc = hop = None
    for s in range(n):
        # this step's product runs while the accumulator travels
        part = torch.matmul(_seq_rows(x, (r + n - 1 - s) % n, tl), w.t())
        acc = part if s == 0 else _decode(hop.wait(), part, quantized) + part
        if s < n - 1:
            hop = start_hop(_encode(acc, quantized)[0], mesh, "tp",
                            _TAG_REDUCE)
    return acc


def _rs_backward(x, w, dy, mesh, quantized):
    ax = mesh.axis("tp")
    n, r = ax.size, ax.rank
    tl = x.shape[-2] // n
    dx = torch.empty_like(x)
    dw = torch.zeros_like(w)
    msg, chunk = _encode(dy, quantized)
    for s in range(n):
        hop = start_hop(msg, mesh, "tp", _TAG_GATHER) if s < n - 1 else None
        slot = (r - s) % n
        _seq_rows(dx, slot, tl).copy_(torch.matmul(chunk, w))
        dw = dw + _weight_grad(chunk, _seq_rows(x, slot, tl))
        if hop is not None:
            msg = hop.wait()
            chunk = _decode(msg, dy, quantized)
    return dx, dw.to(w.dtype)


class _AgMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, quantized, *ws):
        ctx.args = (mesh, quantized)
        ctx.save_for_backward(x, *ws)
        return tuple(_ag_forward(x, ws, mesh, quantized))

    @staticmethod
    def backward(ctx, *dys):
        x, *ws = ctx.saved_tensors
        dx, dws = _ag_backward(x, ws, dys, *ctx.args)
        return (dx, None, None, *dws)


class _MatmulRs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh, quantized):
        ctx.args = (mesh, quantized)
        ctx.save_for_backward(x, w)
        return _rs_forward(x, w, mesh, quantized)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _rs_backward(x, w, dy, *ctx.args)
        return dx, dw, None, None


def _check_2d(name: str, x: torch.Tensor) -> None:
    if x.ndim < 2:
        raise ValueError(f"{name} needs a (..., seq, feature) operand, got "
                         f"shape {tuple(x.shape)}")


def ag_matmul(x: torch.Tensor, ws: Sequence[torch.Tensor], mesh,
              quantized: bool = False) -> Tuple[torch.Tensor, ...]:
    """The ring all-gather-matmul over 'tp': x is this rank's (..., t/n,
    d) chunk of the sequence, `ws` a non-empty tuple of local (o_j, d)
    weights sharing one ring; returns each (..., t, o_j) = all_gather(x)
    @ w_j^T. `quantized` (ring_q) puts int8 codes and row scales on every
    hop of the forward and of the backward's re-gather ring, and
    requantizes the backward's dx accumulator per hop."""
    _check_2d("ag_matmul", x)
    if not isinstance(ws, (tuple, list)) or not ws:
        raise ValueError("ag_matmul takes a non-empty tuple of weights "
                         "(one ring shared by all of them)")
    for w in ws:
        if w.ndim != 2 or w.shape[1] != x.shape[-1]:
            raise ValueError(
                f"ag_matmul weight shape {tuple(w.shape)} does not contract "
                f"with x feature dim {x.shape[-1]}")
    return _AgMatmul.apply(x, mesh, quantized, *ws)


def matmul_rs(x: torch.Tensor, w: torch.Tensor, mesh,
              quantized: bool = False) -> torch.Tensor:
    """The ring matmul-reduce-scatter over 'tp': x (..., t, f) this rank's
    partial-product input over the whole sequence, w its local (o, f)
    weight; returns this rank's (..., t/n, o) chunk of the sum over the
    ranks of x @ w^T. `quantized` (ring_q) requantizes the accumulator
    before each hop of the forward and quantizes the backward's cotangent
    chunks once, at their origin."""
    _check_2d("matmul_rs", x)
    n = mesh.axis("tp").size
    if x.shape[-2] % n != 0:
        raise ValueError(
            f"matmul_rs: sequence length {x.shape[-2]} not divisible by "
            f"axis 'tp' size {n} — the ring needs even chunks")
    if w.ndim != 2 or w.shape[1] != x.shape[-1]:
        raise ValueError(
            f"matmul_rs weight shape {tuple(w.shape)} does not contract "
            f"with x feature dim {x.shape[-1]}")
    return _MatmulRs.apply(x, w, mesh, quantized)
