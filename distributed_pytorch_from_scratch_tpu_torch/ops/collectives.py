"""Collectives over the cp group — the part of the JAX `ops/collectives.py`
that context parallelism needs, as `torch.autograd.Function` conjugate pairs:

* `ring_permute(x, mesh, shift)`: send to rank+shift, receive from
  rank-shift, in one `batch_isend_irecv`; its backward permutes the
  cotangent the other way (the transpose of JAX's `ppermute`);
* `all_to_all(x, mesh, split_axis, concat_axis)` (JAX's tiled
  `lax.all_to_all`); its backward is the inverse all-to-all;
* `all_reduce_sum(x, mesh)`: the loss's sum and count. Its backward passes
  the cotangent through: the sum is replicated, every rank differentiates
  its own copy of the one global loss, and the train step sums the ranks'
  gradients (`all_reduce_sum_`, in place, one flat buffer, no autograd);
* `all_gather(x, mesh)`: every rank's x, stacked (positions, logits; no
  autograd).

Transport: under gloo a CUDA tensor is copied to the host, sent, received
and copied back, in these functions and nowhere else — gloo's point-to-point
and all-to-all take CPU tensors only, and NCCL refuses two ranks on one card,
so a cp group that shares one card runs over gloo. Under NCCL the tensors go
as they are. `stats` counts what the staging costs on the host: `wait_s`, the
wait for the device work queued before a staged call (the copy to the host
must see it finished), and `hop_s`, the copies and the transfer themselves.
"""

from __future__ import annotations

import time
from typing import List

import torch
import torch.distributed as dist

stats = {"calls": 0, "bytes": 0, "wait_s": 0.0, "hop_s": 0.0}


def reset_stats() -> None:
    stats.update(calls=0, bytes=0, wait_s=0.0, hop_s=0.0)


def _staged(mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def _collective(mesh, x: torch.Tensor, run) -> torch.Tensor:
    """`run(x_on_the_wire) -> result on the wire`, with x staged through the
    host under gloo and the result copied back to x's device."""
    stats["calls"] += 1
    stats["bytes"] += x.numel() * x.element_size()
    if not _staged(mesh, x):
        return run(x.contiguous())
    t0 = time.perf_counter()
    torch.cuda.current_stream(x.device).synchronize()
    t1 = time.perf_counter()
    out = run(x.cpu()).to(x.device)
    stats["wait_s"] += t1 - t0
    stats["hop_s"] += time.perf_counter() - t1
    return out


def _permute(x: torch.Tensor, mesh, shift: int) -> torch.Tensor:
    n, r = mesh.cp, mesh.cp_rank

    def run(send):
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (r + shift) % n, mesh.group),
               dist.P2POp(dist.irecv, recv, (r - shift) % n, mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    return _collective(mesh, x, run)


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, shift):
        ctx.mesh, ctx.shift = mesh, shift
        return _permute(x, mesh, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.mesh, -ctx.shift), None, None


def ring_permute(x: torch.Tensor, mesh, shift: int = 1) -> torch.Tensor:
    """One ring hop in an explicit direction: rank r sends x to r+shift and
    returns what r-shift sent, so after s hops of shift=+1 rank r holds the
    value of rank r-s (the JAX convention). With 2 ranks "next" and
    "previous" are one peer: both transfers go in one `batch_isend_irecv`,
    never a blocking send before a blocking receive."""
    if shift % mesh.cp == 0:
        raise ValueError("ring_permute needs a shift that is not a multiple "
                         f"of the group size {mesh.cp}; it would self-send")
    return _RingPermute.apply(x, mesh, shift)


def _a2a(x: torch.Tensor, mesh, split_axis: int, concat_axis: int
         ) -> torch.Tensor:
    parts = torch.stack(torch.chunk(x, mesh.cp, dim=split_axis))

    def run(send):
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group)
        return recv

    return torch.cat(_collective(mesh, parts, run).unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, split_axis, concat_axis):
        ctx.args = (mesh, concat_axis, split_axis)
        return _a2a(x, mesh, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, mesh, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """JAX's tiled `all_to_all`: x splits into cp equal chunks along
    `split_axis`, chunk j goes to rank j, and the chunks received are
    concatenated along `concat_axis` in rank order."""
    if x.shape[split_axis] % mesh.cp:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {mesh.cp} ranks")
    return _AllToAll.apply(x, mesh, split_axis, concat_axis)


def _sum_(x: torch.Tensor, mesh) -> torch.Tensor:
    """The cp sum of x, written into x where x is not staged: callers pass
    a tensor of their own."""
    def run(buf):
        dist.all_reduce(buf, group=mesh.group)
        return buf

    return _collective(mesh, x, run)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The cp sum of x on every rank; the cotangent passes through."""
    if mesh.cp == 1:
        return x
    return _AllReduceSum.apply(x, mesh)


@torch.no_grad()
def all_reduce_sum_(tensors: List[torch.Tensor], mesh) -> None:
    """Sum every tensor over the cp group IN PLACE, through ONE flat f32
    buffer (one collective, not one per tensor)."""
    if mesh.cp == 1 or not tensors:
        return
    flat = _sum_(torch.cat([t.reshape(-1).float() for t in tensors]), mesh)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


@torch.no_grad()
def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """(cp, *x.shape): every rank's x in rank order (no gradient)."""
    if mesh.cp == 1:
        return x[None]

    def run(send):
        recv = [torch.empty_like(send) for _ in range(mesh.cp)]
        dist.all_gather(recv, send, group=mesh.group)
        return torch.stack(recv)

    return _collective(mesh, x, run)
