"""Context-parallel causal attention over the cp group: ring + Ulysses — the
port of the JAX `ops/ring_attention.py`.

The sequence is sharded over the cp ranks (`runtime/mesh.py`); each rank
holds the chunk of q, k, v of its tokens and their global positions.

* **Ring attention** (`ring_attention`): each rank keeps its Q chunk and the
  K/V chunks rotate around the ring (`ring_permute`, one hop per step),
  combining per-block (o, lse) with the online-softmax recurrence in f32.
  Each (Q-half, KV-half) block is `block_attention`: the hand-written block
  kernels on the card, their plain versions on the CPU. Causal masks come
  from the global positions, so any position layout is exact.
* **Ulysses** (`ulysses_attention`): two all-to-alls swap the head sharding
  for the sequence sharding around the single-device `causal_attention`
  (the flash kernels on the card), then swap back.

Both differentiate through torch autograd: `ring_permute`'s backward is the
reverse hop, the all-to-all's the inverse all-to-all, and the block's
(`BlockAttention`) takes both cotangents (do, dlse) of the combine.

Where JAX decides each block's skip on the device (`lax.cond`), eager torch
would stall the host once per block to read the decision. Here the skip
table is computed up front on the host (`ring_schedule`): every rank's
positions are gathered once per forward, and every layer, and the remat
replay of every layer, takes the same decisions from the same table. The
gathered table also gives each step's K/V positions (rank r holds rank
r-s's chunk at step s), the values the JAX ring carries with K and V.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from .attention import causal_attention
from .collectives import all_gather, all_to_all, ring_permute
from .cuda.block_attention import block_attention

_BIG_NEG = -1e30  # f32 online-softmax fill; exp() of it underflows to 0


def zigzag_perm(t: int, n: int) -> np.ndarray:
    """Token permutation of the zig-zag cp layout (the JAX `zigzag_perm`):
    the sequence splits into 2n sub-chunks and rank r owns sub-chunks r and
    2n-1-r, so every rank holds an equally early and late slice of the
    causal triangle. `x[:, zigzag_perm(t, n)]` orders a batch so that rank
    r's contiguous chunk is its zig-zag pair."""
    if t % (2 * n):
        raise ValueError(f"zigzag layout needs sequence length {t} divisible "
                         f"by 2*cp ({2 * n})")
    c = t // (2 * n)
    idx = []
    for r in range(n):
        idx.extend(range(r * c, (r + 1) * c))
        idx.extend(range((2 * n - 1 - r) * c, (2 * n - r) * c))
    return np.asarray(idx)


def cp_chunk_index(t: int, n: int, rank: int, layout: str) -> np.ndarray:
    """The sequence indices, in a length-t batch, of rank `rank`'s chunk
    under `layout`: its contiguous slice of the natural order, or of the
    zig-zag order ('zigzag')."""
    tl = t // n
    order = zigzag_perm(t, n) if layout == "zigzag" else np.arange(t)
    return order[rank * tl:(rank + 1) * tl]


def block_schedule(positions: np.ndarray) -> List[List[List[Tuple[int, int]]]]:
    """The ring's work, from every rank's positions (cp, b, t_local): for
    each rank r and step s (rank r then holds the K/V of rank r-s), the
    (q half, kv half) blocks it computes. The local chunk splits into two
    halves when t_local is even (else one); a block is skipped when every
    kv position comes after every q position, max(q half) < min(kv half)
    over the batch — the JAX rule."""
    n, _, tl = positions.shape
    halves = 2 if tl % 2 == 0 else 1
    th = tl // halves
    part = lambda r, i: positions[r][:, i * th:(i + 1) * th]
    return [[[(i, j) for i in range(halves) for j in range(halves)
              if not part(r, i).max() < part((r - s) % n, j).min()]
             for s in range(n)] for r in range(n)]


@dataclass(frozen=True)
class RingSchedule:
    """One rank's ring schedule for one batch: `blocks[s]`, the (i, j)
    half-blocks it computes at step s; `q_pos[i]` the positions of its q
    half i and `kv_pos[s][j]` those of the kv half j it holds at step s,
    (b, th) int32 on the device."""

    th: int
    blocks: List[List[Tuple[int, int]]]
    q_pos: List[torch.Tensor]
    kv_pos: List[List[torch.Tensor]]


def ring_schedule(q_pos: torch.Tensor, mesh) -> RingSchedule:
    """This rank's `RingSchedule` from its positions (b, t_local): one
    all-gather of every rank's positions, read on the host."""
    every = all_gather(q_pos.to(torch.int32), mesh)     # (cp, b, t_local)
    n, r = mesh.cp, mesh.cp_rank
    blocks = block_schedule(every.cpu().numpy())[r]
    halves = 2 if every.shape[-1] % 2 == 0 else 1
    th = every.shape[-1] // halves
    cut = lambda x: [x[:, j * th:(j + 1) * th].contiguous()
                     for j in range(halves)]
    return RingSchedule(th=th, blocks=blocks, q_pos=cut(every[r]),
                        kv_pos=[cut(every[(r - s) % n]) for s in range(n)])


def _block_attn(q, k, v, q_pos, kv_pos):
    """One block through `block_attention` — the kernels on CUDA tensors (q
    in the compute dtype, as the JAX flash impl), the plain versions on CPU
    tensors (in f32, as the JAX xla impl); returns (o, lse), both f32."""
    if not q.is_cuda:
        q, k, v = q.float(), k.float(), v.float()
    o, lse = block_attention(q, k, v, q_pos, kv_pos)
    return o.float(), lse


class _AfterHops(torch.autograd.Function):
    """x, made to depend on the ring's last K/V: every hop's backward must
    run on every rank, or a neighbour's matching transfer waits forever. A
    rank whose last steps compute no block would otherwise leave those hops
    out of its backward graph; this gives them a zero cotangent."""

    @staticmethod
    def forward(ctx, x, kv):
        ctx.kv = (kv.shape, kv.dtype, kv.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv
        return g, torch.zeros(shape, dtype=dtype, device=device)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   schedule: RingSchedule, mesh) -> torch.Tensor:
    """Causal attention with the sequence sharded over the cp group.

    q: (b, heads, t_local, head_dim), this rank's chunk; k, v may carry
    fewer (grouped-query) heads. `schedule` is `ring_schedule(q_pos, mesh)`
    of the chunk's global positions q_pos (b, t_local), the one positions
    input: a caller running many layers on one batch computes it once.
    Returns (b, heads, t_local, head_dim) in q's dtype.

    Work skipping is at half-chunk granularity: each of the cp steps runs
    the (q half, kv half) blocks the schedule keeps. With the contiguous
    layout the last rank computes every block and the first about a
    quarter; the zig-zag layout balances them. n-1 hops rotate K and V
    (stacked, one transfer per hop), and the last step computes with no hop
    after it."""
    th = schedule.th
    half = lambda x, i: x[:, :, i * th:(i + 1) * th].contiguous()
    halves = q.shape[2] // th
    qc = q if q.is_cuda else q.float()
    q_halves = [half(qc, i) for i in range(halves)]
    o = [torch.zeros(q_halves[i].shape, dtype=torch.float32, device=q.device)
         for i in range(halves)]
    lse = [torch.full(q_halves[i].shape[:3], _BIG_NEG, dtype=torch.float32,
                      device=q.device) for i in range(halves)]
    kv = torch.stack([k, v])
    for s in range(mesh.cp):
        kv_halves = {j: (half(kv[0], j), half(kv[1], j))
                     for j in sorted({j for _, j in schedule.blocks[s]})}
        for i, j in schedule.blocks[s]:
            bo, blse = _block_attn(q_halves[i], *kv_halves[j],
                                   schedule.q_pos[i], schedule.kv_pos[s][j])
            lse_new = torch.logaddexp(lse[i], blse)
            # combine weights; exp(_BIG_NEG - lse_new) underflows to exactly 0
            o[i] = (o[i] * torch.exp(lse[i] - lse_new)[..., None]
                    + bo * torch.exp(blse - lse_new)[..., None])
            lse[i] = lse_new
        if s < mesh.cp - 1:
            kv = ring_permute(kv, mesh)
    out = torch.cat(o, dim=2)
    if mesh.cp > 1 and not schedule.blocks[-1]:
        out = _AfterHops.apply(out, kv)
    # every query attends at least to itself, so its o is fully normalized
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style): q (b,
    heads, t_local, head_dim) in contiguous rank-order chunks, k, v may
    carry fewer heads. Swaps to (b, heads/cp, t, head_dim), runs
    `causal_attention` over the whole sequence, swaps back. Both head
    counts must divide by cp."""
    n = mesh.cp
    h, hkv = q.shape[1], k.shape[1]
    if h % n != 0 or hkv % n != 0:
        raise ValueError(
            f"ulysses needs local q heads ({h}) and kv heads ({hkv}) "
            f"divisible by cp axis size ({n})")
    swap = lambda x: all_to_all(x, mesh, split_axis=1, concat_axis=2)
    o = causal_attention(swap(q), swap(k), swap(v))
    return all_to_all(o, mesh, split_axis=2, concat_axis=1)
