"""Collectives over one axis of the mesh — the port of the JAX
`ops/collectives.py`, as `torch.autograd.Function` conjugate pairs. Every
op takes the `Mesh` and the name of the axis it runs over ('tp', 'cp',
'ep', 'dp', 'pp', 'batch' — the dp x cp x ep ranks that share a (pp, tp)
pair — or 'expert_batch', the dp x cp ranks that share a (pp, ep, tp)
triple); at axis size 1 each is the identity.

Tensor parallelism's ring hop, split in two so the caller can compute
while it travels (the ring collective matmuls of `ops/overlap.py`):
`start_hop(x, mesh, axis, tag)` sends x to the next rank of the ring and
posts the receive from the previous one; `Hop.wait()` returns what
arrived. Two hops may be in flight at once between the same two ranks
(ag_matmul's backward runs its re-gather ring and its dx ring together):
each ring passes a tag of its own, and every rank starts and waits on its
hops in one fixed order, so a receive never takes the other ring's
message. No autograd: the rings' Functions run their own backward hops.

Pipeline parallelism's: `stage_hop(x, mesh, wrap)`, the ring permute over
'pp', passes a stage's activation to the next pp stage (JAX's `ppermute`
over 'pp'), its backward the cotangent to the previous one.

Megatron's tensor-parallel pairs (the JAX primitive in brackets):

* `copy_to`: identity forward, all-reduce backward (`pvary`);
* `reduce_from`: all-reduce forward, identity backward (`psum`);
* `split_to(dim)`: this rank's slice forward, all-gather backward;
* `gather_from(dim)`: all-gather forward, reduce-scatter backward
  (`all_gather`, whose transpose is `psum_scatter`: the cotangents of every
  rank's copy are summed, not sliced from one);
* `reduce_scatter(dim)`: reduce-scatter forward, all-gather backward
  (`psum_scatter`);
* `all_max`: the max over the axis, no gradient (`pmax` under
  `stop_gradient`).

Context parallelism's:

* `ring_permute(x, mesh, shift)`: send to rank+shift, receive from
  rank-shift, in one `batch_isend_irecv`; its backward permutes the
  cotangent the other way (the transpose of JAX's `ppermute`);
* `all_to_all(x, mesh, split_axis, concat_axis, axis)` (JAX's tiled
  `lax.all_to_all`), over cp (Ulysses) or ep (the MoE dispatch and
  combine); its backward is the inverse all-to-all;
* `all_reduce_sum(x, mesh, axis)`: the loss's sum and count. Its backward
  passes the cotangent through: the sum is replicated, every rank
  differentiates its own copy of the one global loss, and the train step
  sums the ranks' gradients (`all_reduce_sum_`, in place, one flat buffer,
  no autograd);
* `all_gather(x, mesh)`: every rank's x, stacked (positions, logits; no
  autograd).

Serving's: `broadcast_ints(x, mesh, axis)` sends a host int tensor from
index 0 of `axis` to its other ranks (a serving engine's dispatch, over the
'world' axis of every rank: rank 0 decides, every rank computes;
`serving/tp_dispatch.py`). It is no autograd Function and is counted apart
from the model's hops, under `stats["dispatch"]`. The serving fleet's own
hops, counted apart too: `broadcast(x, mesh, axis, stat)` of a tensor of
any dtype and `all_gather(..., stat=)`, the KV pages' gather to an
exporting engine's rank 0 and broadcast to an importing engine's ranks
(`stats["kv_gather"]`, `["kv_scatter"]`) and a live replica's weights
moved to another tp width (`stats["reshard"]`).

Transport: under gloo a CUDA tensor is copied to the host, sent, received
and copied back, in these functions and nowhere else — gloo takes CPU
tensors only, and NCCL refuses two ranks on one card, so ranks that share
one card run over gloo. Under NCCL the tensors go as they are. `stats`
counts per axis what the staging costs on the host: `wait_s`, the wait for
the device work queued before a staged call (the copy to the host must see
it finished), and `hop_s`, the copies and the transfer themselves (a
host tensor's transfer alone; NCCL's enqueue is not timed); `calls` and
`bytes` count every call, `bytes` the payload handed to it, and
`ring_bytes` what one rank sends for it under a ring schedule (n ranks, B
the payload: all-reduce 2(n-1)/n B, reduce-scatter and all-to-all
(n-1)/n B, all-gather (n-1) B of its shard, a permute or a broadcast B),
the measure of a wire that does not depend on how the transport moves
it.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch
import torch.distributed as dist

STAT_AXES = ("tp", "cp", "ep", "dp", "pp", "batch", "expert_batch")
# the serving dispatch broadcasts' entry in `stats`, apart from the axes
DISPATCH = "dispatch"
# the serving fleet's own hops, apart from the model's: the KV pages'
# gather to an exporting leader and broadcast to an importing engine's
# ranks (`serving/kv_manager.py`), and a live replica's weights moved to
# another tp width (`reshard/apply.reshard_params`)
KV_GATHER, KV_SCATTER, RESHARD = "kv_gather", "kv_scatter", "reshard"


def _zero() -> Dict[str, float]:
    return {"calls": 0, "bytes": 0, "ring_bytes": 0.0, "wait_s": 0.0,
            "hop_s": 0.0}


stats: Dict[str, Dict[str, float]] = {
    a: _zero() for a in STAT_AXES + (DISPATCH, KV_GATHER, KV_SCATTER,
                                     RESHARD)}


def reset_stats() -> None:
    for a in stats:
        stats[a] = _zero()


def total_stats() -> Dict[str, float]:
    """`stats` summed over the axes, and under "dispatch" the dispatch
    broadcasts' own counts (not in the sums)."""
    out = _zero()
    for a in STAT_AXES:
        for k in out:
            out[k] += stats[a][k]
    return {**out, DISPATCH: dict(stats[DISPATCH])}


def _collective(mesh, axis: str, x: torch.Tensor, run,
                stat: str = None, ring: float = 1.0) -> torch.Tensor:
    """`run(x_on_the_wire) -> result on the wire` over `axis`, with x staged
    through the host under gloo and the result copied back to x's device;
    counted under `stat` (default: the axis), `ring` times x's bytes as
    its ring bytes."""
    st = stats[stat or axis]
    st["calls"] += 1
    nbytes = x.numel() * x.element_size()
    st["bytes"] += nbytes
    st["ring_bytes"] += ring * nbytes
    if x.is_cuda and mesh.backend != "gloo":
        return run(x.contiguous())      # NCCL: enqueued, not timed here
    t0 = time.perf_counter()
    if not x.is_cuda:                   # a host tensor: gloo blocks
        out = run(x.contiguous())
        st["hop_s"] += time.perf_counter() - t0
        return out
    torch.cuda.current_stream(x.device).synchronize()
    t1 = time.perf_counter()
    # contiguous before the copy: `cpu()` keeps a view's strides, and gloo
    # receives only into contiguous tensors (a sequence-parallel reduce-
    # scatter's output is a permuted view, and residual adds keep it)
    out = run(x.contiguous().cpu()).to(x.device)
    st["wait_s"] += t1 - t0
    st["hop_s"] += time.perf_counter() - t1
    return out


def _all_reduce(x: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM,
                owned: bool = False) -> torch.Tensor:
    """The reduction of x over `axis`: in a new tensor, or written into x
    where the caller `owned` it and it was not staged."""
    ax = mesh.axis(axis)

    def run(buf):
        buf = buf if owned or buf.data_ptr() != x.data_ptr() else buf.clone()
        dist.all_reduce(buf, op=op, group=ax.group)
        return buf

    return _collective(mesh, axis, x, run,
                       ring=2 * (ax.size - 1) / ax.size)


def _gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim`, in axis order."""
    ax = mesh.axis(axis)
    moved = x.movedim(dim, 0)

    def run(send):
        recv = send.new_empty((ax.size * send.shape[0],) + send.shape[1:])
        dist.all_gather_into_tensor(recv, send, group=ax.group)
        return recv

    return _collective(mesh, axis, moved, run,
                       ring=ax.size - 1).movedim(0, dim)


def _scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum over `axis` of x, this rank's 1/size chunk along `dim`."""
    ax = mesh.axis(axis)
    if x.shape[dim] % ax.size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {ax.size} ranks")
    moved = x.movedim(dim, 0)

    def run(send):
        recv = send.new_empty((send.shape[0] // ax.size,) + send.shape[1:])
        dist.reduce_scatter_tensor(recv, send, group=ax.group)
        return recv

    return _collective(mesh, axis, moved, run,
                       ring=(ax.size - 1) / ax.size).movedim(0, dim)


def _slice(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    ax = mesh.axis(axis)
    if x.shape[dim] % ax.size:
        raise ValueError(f"split_to: dim {dim} of {tuple(x.shape)} does not "
                         f"split over {ax.size} ranks")
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, *ctx.args), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _slice(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


def copy_to(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """Identity forward; the all-reduce of the cotangent backward (Megatron's
    f: the input of column-parallel work that every rank shares)."""
    if mesh.axis(axis).size == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """The all-reduce (sum) forward; identity backward (Megatron's g: the
    partial sums of row-parallel work)."""
    if mesh.axis(axis).size == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def split_to(x: torch.Tensor, mesh, axis: str = "tp",
             dim: int = -1) -> torch.Tensor:
    """This rank's chunk of a replicated x along `dim` forward; the
    all-gather of the cotangent backward."""
    if mesh.axis(axis).size == 1:
        return x
    return _SplitTo.apply(x, mesh, axis, dim)


def gather_from(x: torch.Tensor, mesh, axis: str = "tp",
                dim: int = -1) -> torch.Tensor:
    """Every rank's x concatenated along `dim` forward; backward, the
    cotangents of every rank summed and this rank's chunk kept (a
    reduce-scatter, the transpose JAX derives)."""
    if mesh.axis(axis).size == 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim)


def reduce_scatter(x: torch.Tensor, mesh, axis: str = "tp",
                   dim: int = -1) -> torch.Tensor:
    """The sum over the axis, this rank's chunk along `dim`, forward; the
    all-gather of the cotangent backward."""
    if mesh.axis(axis).size == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axis, dim)


@torch.no_grad()
def all_max(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """The elementwise max over the axis; carries no gradient."""
    if mesh.axis(axis).size == 1:
        return x.detach()
    return _all_reduce(x.detach(), mesh, axis, op=dist.ReduceOp.MAX)


def _permute(x: torch.Tensor, mesh, shift: int, axis: str = "cp",
             wrap: bool = True) -> torch.Tensor:
    """x sent to the rank `shift` places on along `axis`, what the rank
    `shift` places back sent returned (no autograd). Without `wrap` the
    ends do not join: the last ranks send nothing and the first receive
    zeros."""
    ax = mesh.axis(axis)
    n, r = ax.size, ax.rank
    dst, src = r + shift, r - shift
    if wrap:
        dst, src = dst % n, src % n

    def run(send):
        recv = (torch.empty_like(send) if 0 <= src < n
                else torch.zeros_like(send))
        ops = []
        if 0 <= dst < n:
            ops.append(dist.P2POp(dist.isend, send, ax.members[dst],
                                  ax.group))
        if 0 <= src < n:
            ops.append(dist.P2POp(dist.irecv, recv, ax.members[src],
                                  ax.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    return _collective(mesh, axis, x, run, ring=1.0 if 0 <= dst < n else 0.0)


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, shift, axis, wrap):
        ctx.args = (mesh, -shift, axis, wrap)
        return _permute(x, mesh, shift, axis, wrap)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, *ctx.args), None, None, None, None


def ring_permute(x: torch.Tensor, mesh, shift: int = 1) -> torch.Tensor:
    """One ring hop over the cp axis in an explicit direction: rank r sends
    x to r+shift and returns what r-shift sent, so after s hops of shift=+1
    rank r holds the value of rank r-s (the JAX convention). With 2 ranks
    "next" and "previous" are one peer: both transfers go in one
    `batch_isend_irecv`, never a blocking send before a blocking receive."""
    if shift % mesh.cp == 0:
        raise ValueError("ring_permute needs a shift that is not a multiple "
                         f"of the group size {mesh.cp}; it would self-send")
    return _RingPermute.apply(x, mesh, shift, "cp", True)


def stage_hop(x: torch.Tensor, mesh, wrap: bool = False) -> torch.Tensor:
    """One pipeline hop over 'pp', the ring permute on that axis: stage p
    sends x to stage p + 1 and returns what stage p - 1 sent (JAX's
    `ppermute` of the pipeline step carry); the backward sends the
    cotangent back. With `wrap` the last stage sends to stage 0 (the
    interleaved schedule's ring); without it the last stage sends nothing
    and stage 0 gets zeros, which the gpipe schedule overwrites with its
    injected microbatch (JAX's wrapped hop carries a value stage 0 drops).
    Every stage must call it, at every step, and keep its output in the
    graph: its backward is a transfer with both neighbours."""
    if mesh.axis("pp").size == 1:
        raise ValueError("stage_hop needs a pp axis of size > 1")
    return _RingPermute.apply(x, mesh, 1, "pp", wrap)


class Hop:
    """One ring hop in flight (`start_hop`); `wait()` returns the tensor
    the previous rank sent, on the sender's device type."""

    def __init__(self, works, send, recv, device, st, timed: bool):
        self._works, self._send, self._recv = works, send, recv
        self._device, self._st, self._timed = device, st, timed

    def wait(self) -> torch.Tensor:
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        out = self._recv if self._device is None else self._recv.to(
            self._device)
        if self._timed:
            self._st["hop_s"] += time.perf_counter() - t0
        self._works = self._send = self._recv = None
        return out


def start_hop(x: torch.Tensor, mesh, axis: str = "tp",
              tag: int = 0) -> Hop:
    """Start one hop of the +1 ring over `axis`: x goes to rank r + 1 and
    the receive from rank r - 1 is posted, in one `batch_isend_irecv`
    (NCCL's group call: both ends of a 2-rank ring post both transfers at
    once), under `tag`. Under gloo a card's x is copied to the host here
    (after the work queued before it), the transfer runs in gloo's own
    threads while the caller computes, and the copy back to the card
    happens in `wait`. Counted in `stats[axis]` as one call of x's bytes,
    ring bytes the same; `wait_s` the wait for the queued work, `hop_s`
    the copies, the posting and the wait in `Hop.wait` (NCCL's enqueue is
    not timed)."""
    ax = mesh.axis(axis)
    n, r = ax.size, ax.rank
    st = stats[axis]
    nbytes = x.numel() * x.element_size()
    st["calls"] += 1
    st["bytes"] += nbytes
    st["ring_bytes"] += nbytes
    x = x.contiguous()
    staged = x.is_cuda and mesh.backend == "gloo"
    timed = not (x.is_cuda and mesh.backend != "gloo")
    t0 = time.perf_counter()
    if staged:
        torch.cuda.current_stream(x.device).synchronize()
        t1 = time.perf_counter()
        st["wait_s"] += t1 - t0
        send = x.cpu()
    else:
        t1, send = t0, x
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, ax.members[(r + 1) % n], ax.group,
                   tag),
        dist.P2POp(dist.irecv, recv, ax.members[(r - 1) % n], ax.group,
                   tag)])
    if timed:
        st["hop_s"] += time.perf_counter() - t1
    return Hop(works, send, recv, x.device if staged else None, st, timed)


def _a2a(x: torch.Tensor, mesh, axis: str, split_axis: int,
         concat_axis: int) -> torch.Tensor:
    ax = mesh.axis(axis)
    parts = torch.stack(torch.chunk(x, ax.size, dim=split_axis))

    def run(send):
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=ax.group)
        return recv

    return torch.cat(_collective(mesh, axis, parts, run,
                                 ring=(ax.size - 1) / ax.size).unbind(0),
                     dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, concat_axis, split_axis)
        return _a2a(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, split_axis: int, concat_axis: int,
               axis: str = "cp") -> torch.Tensor:
    """JAX's tiled `all_to_all` over `axis`: x splits into size equal
    chunks along `split_axis`, chunk j goes to rank j, and the chunks
    received are concatenated along `concat_axis` in rank order. Over ep,
    (E, C, d) with split 0 / concat 1 becomes (E/ep, ep*C, d): each rank
    gets its own experts' slots from every peer, in peer order; split 1 /
    concat 0 takes them back."""
    size = mesh.axis(axis).size
    if size == 1:
        return x
    if x.shape[split_axis] % size:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {size} ranks")
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of x over `axis` on every rank; the cotangent passes
    through."""
    if mesh.axis(axis).size == 1:
        return x
    return _AllReduceSum.apply(x, mesh, axis)


@torch.no_grad()
def all_reduce_sum_(tensors: List[torch.Tensor], mesh, axis: str) -> None:
    """Sum every tensor over `axis` IN PLACE, through ONE flat f32 buffer
    (one collective, not one per tensor)."""
    if mesh.axis(axis).size == 1 or not tensors:
        return
    flat = _all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]),
                       mesh, axis, owned=True)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


@torch.no_grad()
def all_gather(x: torch.Tensor, mesh, axis: str = "cp",
               stat: str = None) -> torch.Tensor:
    """(size, *x.shape): every rank's x on `axis` in rank order (no
    gradient); counted under `stat` (default: the axis)."""
    ax = mesh.axis(axis)
    if ax.size == 1:
        return x[None]

    def run(send):
        recv = [torch.empty_like(send) for _ in range(ax.size)]
        dist.all_gather(recv, send, group=ax.group)
        return torch.stack(recv)

    return _collective(mesh, axis, x, run, stat, ring=ax.size - 1)


@torch.no_grad()
def broadcast(x: torch.Tensor, mesh, axis: str, stat: str,
              src: int = 0) -> torch.Tensor:
    """x as the rank at index `src` of `axis` holds it, on every rank of
    the axis, any dtype (every other rank passes a tensor of x's shape and
    dtype); counted under `stat`."""
    ax = mesh.axis(axis)
    if ax.size == 1:
        return x

    def run(buf):
        dist.broadcast(buf, src=ax.members[src], group=ax.group)
        return buf

    return _collective(mesh, axis, x, run, stat)


@torch.no_grad()
def broadcast_ints(x: torch.Tensor, mesh, axis: str = "tp") -> torch.Tensor:
    """x, a contiguous host int tensor, as the rank at index 0 of `axis`
    holds it: that rank sends its x, every other rank passes a tensor of
    the same shape and dtype and gets the sender's values. Under gloo the
    host tensor goes as it is (received in place); NCCL moves it through
    the card."""
    if mesh.axis(axis).size == 1:
        return x
    if mesh.backend == "nccl":
        return broadcast(x.to(mesh.device), mesh, axis, DISPATCH).cpu()
    return broadcast(x, mesh, axis, DISPATCH)
