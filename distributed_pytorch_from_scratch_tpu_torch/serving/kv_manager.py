"""Slot-granular KV-cache pool for the continuous-batching engine
(counterpart of `KVCachePool` in the JAX `serving/kv_manager.py`).

One device tensor per K/V with a `slots` axis,

    (num_layers, num_slots + 1, kv_heads, buf_len, head_dim)

in the compute dtype. `alloc()` leases a free slot to a request; prefill
writes the prompt's K/V into that slot's rows; every decode step advances
all slots; `free()` returns the slot. The LAST slot (index `num_slots`) is
a scratch row that is never leased: prefill batches padded up to a bucket
size aim their pad rows at it, so pad work lands somewhere harmless.

The engine writes these tensors in place (index assignment under
`torch.inference_mode`), which takes the place of the JAX engine's buffer
donation: a refill never reallocates the pool.
"""

from __future__ import annotations

from collections import deque
from typing import List

import torch

from ..config import resolve_dtype


class KVCachePool:
    """Device-resident K/V pool + host-side slot free-list."""

    def __init__(self, model, mesh, num_slots: int, buf_len: int):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        cfg = model.cfg
        self.num_slots = num_slots
        self.buf_len = buf_len
        self.scratch_slot = num_slots          # never leased; pad-row target
        self.dtype = resolve_dtype(cfg.compute_dtype)
        shape = (cfg.num_layers, num_slots + 1, cfg.kv_heads, buf_len,
                 cfg.head_dim)
        self.ks = torch.zeros(shape, dtype=self.dtype, device=mesh.device)
        self.vs = torch.zeros(shape, dtype=self.dtype, device=mesh.device)
        self._free = deque(range(num_slots))

    # -- slot leasing ----------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def live_slots(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.live_slots / self.num_slots

    def alloc_many(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(f"KV pool exhausted: asked for {n} slots, "
                               f"{len(self._free)} free")
        return [self._free.popleft() for _ in range(n)]

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.num_slots})")
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)
