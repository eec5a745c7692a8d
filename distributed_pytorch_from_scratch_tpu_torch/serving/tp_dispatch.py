"""One rank decides, every rank computes: a serving engine's device
dispatches across its ranks (tp, cp, or cp x tp).

The JAX engine is one controller: its host loop decides each dispatch once
and GSPMD runs it on every device. Here every rank is a process, so global
rank 0 (the leader) runs the engine's host loop (the loadgen, the
scheduler, slots, page tables, refcounts, the prefix index, preemption and
the clock) and, before each device dispatch, broadcasts it to every rank
of the mesh (its 'world' axis): a header of HEADER int32s (the kind, the
payload's length and up to HEADER - 2 shape numbers) and the payload, the dispatch's int32 arrays
packed into one (uint32 request seeds ride as their int32 bits). The
other ranks (workers) run `serve`: receive a dispatch, run the same
lowering on their own shard of the weights and of the KV pool (their tp
heads, their cp slab of pages), join its collectives, and wait for the
next. One leader for the whole mesh keeps the cp ranks, which each hold a
tp group of their own, on one schedule; ranks of other dp indices (the
evaluation CLI's replicas) follow it too. A worker holds
no scheduler and reads no clock, so the ranks cannot diverge; a `stop`
message ends the loop.

Every device-side effect of an engine is a dispatch of one of its kinds
(the engines' `slot_prefill`, `slot_decode`, `paged_chunk`,
`paged_decode` and `cow_copy`, and the kinds a subclass `register`s, as
the speculative engine's draft, verify and drafter chunks), so each
worker's pool stays identical to the leader's in layout. A kind goes on
the wire as its index in registration order, which every rank shares:
each builds the same engine. On one rank `__call__` runs the lowering
directly: no broadcast, no copy.

The dispatcher holds an engine's bound lowerings weakly: the engine holds
the dispatcher, so strong references would make a cycle that keeps the
engine (its KV pool and weights on the card) alive after its last user
drops it, until Python's collector happens to run.
"""

from __future__ import annotations

import inspect
import weakref
from collections import Counter
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..ops.collectives import broadcast_ints

STOP = -1                  # the header kind that ends a worker's loop
HEADER = 8


class _WeakLowering:
    """A bound method held through a `weakref.WeakMethod` (see the module
    docstring), called as the method is."""

    __slots__ = ("_ref",)

    def __init__(self, method: Callable):
        self._ref = weakref.WeakMethod(method)

    def __call__(self, *args):
        return self._ref()(*args)


def _weak(fn: Callable) -> Callable:
    """A bound method as a `_WeakLowering`; any other callable as it is."""
    return _WeakLowering(fn) if inspect.ismethod(fn) else fn


class Dispatcher:
    """`dispatcher(kind, shape, payload)` runs `lowerings[kind](shape,
    payload)` on every rank of `mesh` and returns this rank's result;
    `shape` is a tuple of ints, `payload` an int32 numpy array. `shapes`
    counts this rank's dispatches per (kind, shape) and `counts` per kind,
    so the ranks' lockstep can be checked."""

    def __init__(self, mesh, lowerings: Dict[str, Callable]):
        self.world = mesh.world
        self.mesh = mesh
        self.leader = mesh.rank == 0
        self.lowerings = {k: _weak(fn) for k, fn in lowerings.items()}
        self.shapes: Counter = Counter()

    def register(self, kind: str, lowering: Callable) -> None:
        """Adds a dispatch kind after construction (every rank registers
        the same kinds in the same order)."""
        if kind in self.lowerings:
            raise ValueError(f"dispatch kind {kind!r} is already registered")
        self.lowerings[kind] = _weak(lowering)

    @property
    def counts(self) -> Dict[str, int]:
        out = {k: 0 for k in self.lowerings}
        for (kind, _), n in self.shapes.items():
            out[kind] += n
        return out

    def _run(self, kind: str, shape: tuple, payload: np.ndarray):
        self.shapes[(kind, shape)] += 1
        # the leader's engine steps run under inference mode, and so must
        # a worker's: with autograd on, a lowering's in-place cache writes
        # tie the caches and the weights into a graph that Python's garbage
        # collector cannot see, so a worker kept every engine it ran
        with torch.inference_mode():
            return self.lowerings[kind](shape, payload)

    def _send(self, kind: int, shape: tuple, payload: np.ndarray) -> None:
        head = np.array([kind, payload.size, *shape], np.int32)
        broadcast_ints(torch.from_numpy(head), self.mesh, "world")
        if payload.size:
            broadcast_ints(torch.from_numpy(payload), self.mesh, "world")

    def __call__(self, kind: str, shape: Sequence[int], payload: np.ndarray):
        if not self.leader:
            raise RuntimeError("a worker runs the dispatches rank 0 "
                               "broadcasts (`serve`); it decides none")
        if len(shape) > HEADER - 2:
            raise ValueError(f"a dispatch shape of {len(shape)} numbers; "
                             f"the header holds {HEADER - 2}")
        # padded as a worker receives it, so the ranks' `shapes` compare
        shape = tuple(shape) + (0,) * (HEADER - 2 - len(shape))
        payload = np.ascontiguousarray(payload, np.int32).ravel()
        if self.world > 1:
            self._send(list(self.lowerings).index(kind), shape, payload)
        return self._run(kind, shape, payload)

    def stop(self) -> None:
        """Ends the workers' `serve` loops (the leader's last message)."""
        if self.leader and self.world > 1:
            self._send(STOP, (0,) * (HEADER - 2), np.zeros(0, np.int32))

    def serve(self, max_dispatches: int = None) -> Dict[str, int]:
        """A worker's loop: run each dispatch the leader broadcasts until a
        stop (or `max_dispatches` of them); returns `counts`."""
        if self.leader:
            raise RuntimeError("rank 0 decides the dispatches; `serve` "
                               "runs on the other ranks")
        done = 0
        while max_dispatches is None or done < max_dispatches:
            head = broadcast_ints(torch.zeros(HEADER, dtype=torch.int32),
                                  self.mesh, "world").numpy()
            kind, n = int(head[0]), int(head[1])
            if kind == STOP:
                break
            payload = np.zeros(n, np.int32)
            if n:
                payload = broadcast_ints(torch.from_numpy(payload),
                                         self.mesh, "world").numpy()
            self._run(list(self.lowerings)[kind],
                      tuple(int(x) for x in head[2:]), payload)
            done += 1
        return self.counts
