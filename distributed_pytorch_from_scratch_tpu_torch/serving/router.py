"""Prefix-cache-aware router over paged-engine replicas (the port's copy of
the JAX `serving/router.py`).

The front door for N `PagedEngine` replicas of one model, each opaque
behind submit / step. A request goes to the replica of the best score,

    score(r) = w_prefix * predicted_hit(r) / len(prompt)
             - w_load   * (live(r) + queued(r)) / slots(r)
             - w_pool   * (1 - free_pages(r) / num_pages(r))

ties broken by replica order. The predicted hit needs no round trip: the
router keeps a SHADOW of each replica's hash-chain prefix index
(`PagedKVPool.chain_key`: key = (parent, page_tokens)), fed by its own
dispatches and completions, and walks it exactly as
`PagedEngine._try_share` walks the pool's (page-aligned, lead-matching,
capped at len(prompt) - 1, a partial match ends the walk). On a burst whose
requests are all live at once the predicted hits equal the replica's
`prefix_hit_tokens`. Elsewhere the shadow is an upper bound for a request's
first admission: it holds a prompt from submission until the completion is
folded, while the pool holds a page only from its prefill until its last
reference goes (a preempted request's resume shares pages again, which the
router does not predict).

Session affinity: `submit(req, session=...)` pins a session to the replica
that took it last (its KV prefix lives there); when that replica refuses
(QueueFull) the request SPILLS to the next best with a loud
`session_spill` writer event, never a silent drop. Only a fleet-wide
QueueFull reaches the caller.

With a `request_tracer` the router is the first hop of each request's
trace: it opens the timeline at submit, closes it as a `route` span when
it hands the request to a replica (`export_context`: the replica's
tracer continues the trace from the request's `trace_ctx`) and retires
its own record. A `telemetry` exporter gets the `fleet/session_spills`
counter.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

from .engine import Request
from .kv_manager import PagedKVPool
from .loadgen import nearest_rank
from .scheduler import QueueFull


class _ShadowIndex:
    """One replica's prefix index, mirrored on the router. Runs are keyed as
    the pool's chain and REFCOUNTED per registered request: a page leaves
    the pool's index when its last referencing request lets go of it."""

    def __init__(self, page_size: int):
        self.ps = int(page_size)
        # chain_key(parent) -> {page_tokens: refcount}
        self._runs: Dict[object, Dict[tuple, int]] = {}

    def _chain(self, ids) -> List[Tuple[object, tuple]]:
        ps, out, parent = self.ps, [], None
        for j in range(-(-len(ids) // ps)):
            toks = tuple(int(t) for t in ids[j * ps:(j + 1) * ps])
            out.append((parent, toks))
            parent = PagedKVPool.chain_key(parent, toks)
        return out

    def register(self, ids) -> None:
        for parent, toks in self._chain(ids):
            d = self._runs.setdefault(parent, {})
            d[toks] = d.get(toks, 0) + 1

    def retire(self, ids) -> None:
        for parent, toks in self._chain(ids):
            d = self._runs.get(parent)
            if not d or toks not in d:
                continue
            d[toks] -= 1
            if d[toks] <= 0:
                del d[toks]
                if not d:
                    del self._runs[parent]

    def predict(self, ids) -> int:
        """Prompt positions the replica would serve from shared pages: the
        walk of `PagedEngine._try_share`."""
        ps = self.ps
        s, parent, hits = 0, None, 0
        while s % ps == 0:
            cap = len(ids) - 1 - s
            if cap <= 0:
                break
            window = tuple(int(t) for t in ids[s:s + min(ps, cap)])
            best_toks, best = None, 0
            for toks in self._runs.get(parent, ()):
                n = 0
                for a, b in zip(toks, window):
                    if a != b:
                        break
                    n += 1
                if n > best:
                    best_toks, best = toks, n
            if best == 0:
                break
            hits += best
            s += best
            if best < ps:
                break                       # a partial match ends the walk
            parent = PagedKVPool.chain_key(parent, best_toks)
        return hits


class FleetRouter:
    """Dispatch and fold for an in-process fleet of `PagedEngine` replicas.

    `replicas`: engines, or (name, engine) pairs; names default to r0, r1,
    ... and outlive a restart (`replace_replica` puts a new engine behind a
    name and resets its shadow: the new pool is empty). `writer`: a
    `training.metrics.MetricsWriter` for the `session_spill` and
    `replica_restart` events."""

    def __init__(self, replicas, prefix_weight: float = 4.0,
                 load_weight: float = 1.0, pool_weight: float = 1.0,
                 writer=None, telemetry=None, request_tracer=None,
                 clock=time.monotonic):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.replicas: List[Tuple[str, object]] = [
            r if isinstance(r, tuple) else (f"r{i}", r)
            for i, r in enumerate(replicas)]
        names = [n for n, _ in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.prefix_weight = float(prefix_weight)
        self.load_weight = float(load_weight)
        self.pool_weight = float(pool_weight)
        self.writer = writer
        self.telemetry = telemetry
        self.rt = request_tracer            # the router's own hop
        self._clock = clock
        self._shadow: Dict[str, _ShadowIndex] = {
            n: _ShadowIndex(e.page_size) for n, e in self.replicas}
        self._sessions: Dict[object, str] = {}
        self._live: Dict[int, Tuple[str, list]] = {}   # rid -> (name, ids)
        self.predicted: Dict[int, Tuple[str, int]] = {}
        self.dispatch_ms: List[float] = []
        self.dispatched: Dict[str, int] = {n: 0 for n, _ in self.replicas}
        self.spills = 0
        self.rejected = 0

    # -- scoring ----------------------------------------------------------
    def _engine(self, name: str):
        for n, e in self.replicas:
            if n == name:
                return e
        raise KeyError(name)

    def predict(self, name: str, prompt) -> int:
        return self._shadow[name].predict(prompt)

    def _score(self, name: str, eng, prompt) -> Tuple[float, int]:
        hit = self._shadow[name].predict(prompt)
        load = (eng.live_requests + eng.scheduler.pending) / eng.num_slots
        pool = eng.pool
        pressure = 1.0 - pool.free_pages / pool.num_pages
        score = (self.prefix_weight * hit / max(len(prompt), 1)
                 - self.load_weight * load
                 - self.pool_weight * pressure)
        return score, hit

    # -- dispatch ---------------------------------------------------------
    def submit(self, req: Request, session=None) -> str:
        """Route and enqueue one request; returns the replica's name.
        Raises QueueFull only when EVERY replica refused."""
        t0 = time.perf_counter()
        scored = []                          # (-score, order, name, hit)
        for i, (name, eng) in enumerate(self.replicas):
            score, hit = self._score(name, eng, req.prompt)
            scored.append((-score, i, name, hit))
        scored.sort()
        order = [(name, hit) for _, _, name, hit in scored]
        pinned = (self._sessions.get(session) if session is not None
                  else None)
        if pinned is not None:
            order = ([(n, h) for n, h in order if n == pinned]
                     + [(n, h) for n, h in order if n != pinned])
        if self.rt is not None:
            self.rt.begin(req)
        last_err = None
        for name, hit in order:
            eng = self._engine(name)
            if self.rt is not None:
                # closes the routing span; the replica's tracer continues
                # the trace from here (its submit adopts trace_ctx)
                ctx = self.rt.export_context(req, "route")
                req.trace_ctx = ctx.to_wire() if ctx is not None else None
            try:
                eng.submit(req)
            except QueueFull as e:
                last_err = e
                if pinned == name:
                    # affinity spill: loud, never a silent drop
                    self.spills += 1
                    if self.writer is not None:
                        self.writer.event("session_spill", session=session,
                                          rid=req.rid, pinned=name,
                                          queued=eng.scheduler.pending)
                    if self.telemetry is not None:
                        self.telemetry.counter("fleet/session_spills",
                                               self.spills)
                continue
            ids = list(req.prompt)
            self._shadow[name].register(ids)
            self._live[req.rid] = (name, ids)
            self.predicted[req.rid] = (name, hit)
            self.dispatched[name] += 1
            if session is not None:
                self._sessions[session] = name
            if self.rt is not None:
                self.rt.retire(req, t=self._clock())
            self.dispatch_ms.append((time.perf_counter() - t0) * 1e3)
            return name
        self.rejected += 1
        if self.rt is not None:
            self.rt.retire(req, t=self._clock())
        raise last_err if last_err is not None else QueueFull(
            "no replica accepted the request")

    def replace_replica(self, name: str, engine, reshard=None) -> None:
        """Attach a RESTARTED replica under an existing name: its shadow
        resets (a new engine holds no pages) and sessions keep their pin
        (the name is the address). Requests in flight on the old engine are
        the caller's to submit again. `reshard` (a dict describing a change
        of layout) rides on the `replica_restart` event."""
        for i, (n, _) in enumerate(self.replicas):
            if n == name:
                self.replicas[i] = (name, engine)
                break
        else:
            raise KeyError(f"no replica named {name!r}")
        self._shadow[name] = _ShadowIndex(engine.page_size)
        for rid, (rname, _) in list(self._live.items()):
            if rname == name:
                del self._live[rid]
        if self.writer is not None:
            extra = {"reshard": reshard} if reshard else {}
            self.writer.event("replica_restart", replica=name, **extra)

    # -- the fleet loop ---------------------------------------------------
    def step(self) -> List[Request]:
        """One engine step of every replica; fold the completions and drop
        their shadow registrations (as `_release_slot` drops the pool's
        references)."""
        done: List[Request] = []
        for name, eng in self.replicas:
            for req in eng.step():
                ent = self._live.pop(req.rid, None)
                if ent is not None:
                    self._shadow[ent[0]].retire(ent[1])
                done.append(req)
        return done

    def has_work(self) -> bool:
        return any(e.has_work() for _, e in self.replicas)

    def run_to_completion(self) -> List[Request]:
        out: List[Request] = []
        while self.has_work():
            out.extend(self.step())
        return out

    # -- aggregate view ---------------------------------------------------
    def stats(self) -> dict:
        ms = sorted(self.dispatch_ms)
        return {
            "replicas": [n for n, _ in self.replicas],
            "dispatched": dict(self.dispatched),
            "spills": self.spills,
            "rejected": self.rejected,
            "dispatch_ms_p50": round(nearest_rank(ms, 0.50), 4),
            "dispatch_ms_p95": round(nearest_rank(ms, 0.95), 4),
            "sessions": len(self._sessions),
        }
