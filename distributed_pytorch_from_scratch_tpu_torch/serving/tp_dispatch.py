"""One rank decides, every rank computes: a serving engine's device
dispatches across its tp ranks.

The JAX engine is one controller: its host loop decides each dispatch once
and GSPMD runs it on every device. Here every tp rank is a process, so tp
index 0 (the leader) runs the engine's host loop (the loadgen, the
scheduler, slots, page tables, refcounts, the prefix index, preemption and
the clock) and, before each device dispatch, broadcasts it over the tp
group: a header of HEADER int32s (the kind, the payload's length and up to
HEADER - 2 shape numbers) and the payload, the dispatch's int32 arrays
packed into one (uint32 request seeds ride as their int32 bits). The
other ranks (workers) run `serve`: receive a dispatch, run the same
lowering on their own shard of the weights and of the KV pool, join its
collectives, and wait for the next. A worker holds
no scheduler and reads no clock, so the ranks cannot diverge; a `stop`
message ends the loop.

Every device-side effect of an engine is a dispatch of one of `KINDS`, so
each worker's pool stays identical to the leader's in layout. At tp = 1
`__call__` runs the lowering directly: no broadcast, no copy.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..ops.collectives import broadcast_ints

KINDS = ("slot_prefill", "slot_decode", "paged_chunk", "paged_decode",
         "cow_copy")
STOP = len(KINDS)          # the header kind that ends a worker's loop
HEADER = 8


class Dispatcher:
    """`dispatcher(kind, shape, payload)` runs `lowerings[kind](shape,
    payload)` on every tp rank of `mesh` and returns this rank's result;
    `shape` is a tuple of ints, `payload` an int32 numpy array. `shapes`
    counts this rank's dispatches per (kind, shape) and `counts` per kind,
    so the ranks' lockstep can be checked."""

    def __init__(self, mesh, lowerings: Dict[str, Callable]):
        self.tp = mesh.tp
        self.mesh = mesh
        self.leader = mesh.tp_rank == 0
        self.lowerings = lowerings
        self.shapes: Counter = Counter()

    @property
    def counts(self) -> Dict[str, int]:
        out = {k: 0 for k in KINDS if k in self.lowerings}
        for (kind, _), n in self.shapes.items():
            out[kind] += n
        return out

    def _run(self, kind: str, shape: tuple, payload: np.ndarray):
        self.shapes[(kind, shape)] += 1
        return self.lowerings[kind](shape, payload)

    def _send(self, kind: int, shape: tuple, payload: np.ndarray) -> None:
        head = np.array([kind, payload.size, *shape], np.int32)
        broadcast_ints(torch.from_numpy(head), self.mesh)
        if payload.size:
            broadcast_ints(torch.from_numpy(payload), self.mesh)

    def __call__(self, kind: str, shape: Sequence[int], payload: np.ndarray):
        if not self.leader:
            raise RuntimeError("a tp worker runs the dispatches tp rank 0 "
                               "broadcasts (`serve`); it decides none")
        if len(shape) > HEADER - 2:
            raise ValueError(f"a dispatch shape of {len(shape)} numbers; "
                             f"the header holds {HEADER - 2}")
        # padded as a worker receives it, so the ranks' `shapes` compare
        shape = tuple(shape) + (0,) * (HEADER - 2 - len(shape))
        payload = np.ascontiguousarray(payload, np.int32).ravel()
        if self.tp > 1:
            self._send(KINDS.index(kind), shape, payload)
        return self._run(kind, shape, payload)

    def stop(self) -> None:
        """Ends the workers' `serve` loops (the leader's last message)."""
        if self.leader and self.tp > 1:
            self._send(STOP, (0,) * (HEADER - 2), np.zeros(0, np.int32))

    def serve(self, max_dispatches: int = None) -> Dict[str, int]:
        """A worker's loop: run each dispatch the leader broadcasts until a
        stop (or `max_dispatches` of them); returns `counts`."""
        if self.leader:
            raise RuntimeError("tp rank 0 decides the dispatches; `serve` "
                               "runs on the other tp ranks")
        done = 0
        while max_dispatches is None or done < max_dispatches:
            head = broadcast_ints(torch.zeros(HEADER, dtype=torch.int32),
                                  self.mesh).numpy()
            kind, n = int(head[0]), int(head[1])
            if kind == STOP:
                break
            payload = np.zeros(n, np.int32)
            if n:
                payload = broadcast_ints(torch.from_numpy(payload),
                                         self.mesh).numpy()
            self._run(KINDS[kind], tuple(int(x) for x in head[2:]), payload)
            done += 1
        return self.counts
