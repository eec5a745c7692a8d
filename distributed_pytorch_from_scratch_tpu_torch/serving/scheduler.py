"""Admission for the serving engines (the port's copy of the JAX
`serving/scheduler.py`).

`FIFOScheduler` (slot engine): `take_batch` peels requests off the HEAD of
the queue and stops at the first one whose bucket-padded prefill width
differs from the head's, so nothing ever jumps the queue. A prompt of
length p prefills over a buffer of width `ceil(p / prefill_bucket) *
prefill_bucket`, clamped to buf_len; under causal attention the width
changes cost only, never values.

`SLOScheduler` (paged engine): TTFT deadline classes, overdue-EDF rescue
and per-tenant fairness; see its docstring.

`max_queue` bounds the waiting requests of both: `submit()` past it raises
`QueueFull`. With a `flight` recorder (`obs/flight.py`) each decision goes
into its ring: `sched_submit`, `sched_reject`, and the SLO scheduler's
`sched_admit` and `sched_requeue`.
"""

from __future__ import annotations

import time
from collections import deque
from typing import TYPE_CHECKING, List, Optional

if TYPE_CHECKING:  # engine imports the scheduler; keep the cycle type-only
    from .engine import Request


class QueueFull(RuntimeError):
    """Raised by submit() when the admission queue is at max_queue."""


def bucket_width(prompt_len: int, prefill_bucket: int, buf_len: int) -> int:
    """Smallest multiple of `prefill_bucket` >= prompt_len, clamped to
    buf_len; `prefill_bucket` 0 disables bucketing (full buffer)."""
    if prefill_bucket <= 0:
        return buf_len
    w = -(-prompt_len // prefill_bucket) * prefill_bucket
    return min(w, buf_len)


class FIFOScheduler:
    def __init__(self, buf_len: int, prefill_bucket: int = 64,
                 max_queue: int = 0, clock=time.monotonic, flight=None):
        self.buf_len = buf_len
        self.prefill_bucket = prefill_bucket
        self.max_queue = max_queue
        self._clock = clock
        self.flight = flight  # obs.flight.FlightRecorder: decision ring
        self._queue: "deque[Request]" = deque()
        self.rejected = 0

    @property
    def pending(self) -> int:
        return len(self._queue)

    def submit(self, req: "Request") -> None:
        """Enqueue a request (FIFO). Raises QueueFull past `max_queue`;
        validates the prompt fits the decode buffer now, not at admission."""
        if not req.prompt:
            raise ValueError(f"request {req.rid}: prompt must be non-empty "
                             f"(a width-0 prefill has no position to sample "
                             f"the first token from)")
        if len(req.prompt) >= self.buf_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} must "
                f"leave room in buf_len {self.buf_len}")
        if req.max_new < 0:
            raise ValueError(f"request {req.rid}: max_new must be >= 0, "
                             f"got {req.max_new}")
        if self.max_queue and len(self._queue) >= self.max_queue:
            self.rejected += 1
            if self.flight is not None:
                self.flight.record("sched_reject", rid=req.rid,
                                   pending=len(self._queue))
            raise QueueFull(
                f"admission queue full ({self.max_queue} waiting); request "
                f"{req.rid} refused — retry later or raise --queue_limit")
        if req.submit_t is None:
            req.submit_t = self._clock()
        if self.flight is not None:
            self.flight.record("sched_submit", rid=req.rid,
                               prompt_len=len(req.prompt),
                               pending=len(self._queue))
        self._queue.append(req)

    def take_batch(self, max_requests: int) -> List["Request"]:
        """Pop the next prefill group: up to `max_requests` requests from
        the queue head that share the head's bucket-padded width."""
        if not self._queue or max_requests <= 0:
            return []
        width = lambda r: bucket_width(len(r.prompt), self.prefill_bucket,
                                       self.buf_len)
        head_w = width(self._queue[0])
        group: List["Request"] = []
        while (self._queue and len(group) < max_requests
               and width(self._queue[0]) == head_w):
            group.append(self._queue.popleft())
        return group

    def group_width(self, group: List["Request"]) -> int:
        return bucket_width(max(len(r.prompt) for r in group),
                            self.prefill_bucket, self.buf_len)


# -- SLO-aware admission (the paged engine) -------------------------------

# TTFT deadline classes: name -> seconds from submit to the first token.
# The names are wire-stable (requests carry them, metrics aggregate by
# them); the budgets are per-deployment knobs (serve.py --slo_classes).
DEFAULT_SLO_CLASSES = {"interactive": 0.25, "standard": 1.0, "batch": 8.0}


def parse_slo_classes(spec: str) -> dict:
    """'interactive=0.25,standard=1,batch=8' -> {name: deadline_s}."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"SLO class {part!r} must be name=deadline_s")
        name, val = part.split("=", 1)
        d = float(val)
        if d <= 0:
            raise ValueError(f"SLO class {name!r}: deadline must be > 0, "
                             f"got {d}")
        out[name.strip()] = d
    if not out:
        raise ValueError("empty SLO class spec")
    return out


class SLOScheduler:
    """Deadline-class + per-tenant-fair admission for the paged engine.

    Three rules, applied in order each time the engine asks for the next
    request (`peek` / `take`):

    1. **Overdue rescue (EDF)**: if any queue head is past its TTFT
       deadline, the earliest deadline goes first — also the
       anti-starvation bound: a `batch` request waits at most its deadline
       before it outranks any fresh `interactive` arrival.
    2. **Deadline class**: otherwise tighter-deadline classes go first.
    3. **Per-tenant fairness**: within a class, the tenant with the LEAST
       accumulated service (admitted prompt + budget tokens) goes first;
       ties break FIFO.

    Preemption victims re-enter through `requeue`: the FRONT of their own
    (tenant, class) lane, a fresh deadline, and no second service charge.
    Queues are keyed (tenant, class), so every class a tenant has pending
    is visible as a head (a requeued victim with a fresh deadline cannot
    hide an overdue request of a tighter class, which would livelock the
    engine's admit loop). `clock` is injectable (tests script it)."""

    def __init__(self, buf_len: int, classes: Optional[dict] = None,
                 default_class: str = "standard", max_queue: int = 0,
                 clock=time.monotonic, flight=None):
        self.buf_len = buf_len
        self.classes = dict(classes or DEFAULT_SLO_CLASSES)
        if default_class not in self.classes:
            raise ValueError(f"default SLO class {default_class!r} not in "
                             f"{sorted(self.classes)}")
        self.default_class = default_class
        self.max_queue = max_queue
        self._clock = clock
        self.flight = flight  # obs.flight.FlightRecorder: decision ring
        self._queues: dict = {}          # (tenant, class) -> deque[Request]
        self.service: dict = {}          # tenant -> tokens admitted
        self.rejected = 0
        self._seq = 0                    # global FIFO tie-break

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def pending(self) -> int:
        return len(self)

    def _validate(self, req) -> None:
        if not req.prompt:
            raise ValueError(f"request {req.rid}: prompt must be non-empty "
                             f"(a width-0 prefill has no position to sample "
                             f"the first token from)")
        if len(req.prompt) >= self.buf_len:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} must "
                f"leave room in buf_len {self.buf_len}")
        if req.max_new < 0:
            raise ValueError(f"request {req.rid}: max_new must be >= 0, "
                             f"got {req.max_new}")
        if req.slo_class is not None and req.slo_class not in self.classes:
            raise ValueError(f"request {req.rid}: unknown SLO class "
                             f"{req.slo_class!r} (have "
                             f"{sorted(self.classes)})")

    def submit(self, req) -> None:
        self._validate(req)
        if self.max_queue and len(self) >= self.max_queue:
            self.rejected += 1
            if self.flight is not None:
                self.flight.record("sched_reject", rid=req.rid,
                                   pending=len(self))
            raise QueueFull(
                f"admission queue full ({self.max_queue} waiting); request "
                f"{req.rid} refused — retry later or raise --queue_limit")
        if req.slo_class is None:
            req.slo_class = self.default_class
        if req.submit_t is None:
            req.submit_t = self._clock()
        req.deadline_t = req.submit_t + self.classes[req.slo_class]
        req._sched_seq = self._seq
        self._seq += 1
        if self.flight is not None:
            self.flight.record("sched_submit", rid=req.rid,
                               tenant=req.tenant, slo_class=req.slo_class,
                               prompt_len=len(req.prompt),
                               pending=len(self))
        self._queues.setdefault((req.tenant, req.slo_class),
                                deque()).append(req)

    def requeue(self, req) -> None:
        """Re-admit a preemption victim: front of its (tenant, class) lane,
        fresh deadline budget, no second service charge, never a QueueFull
        (the engine already owns this work)."""
        req.deadline_t = self._clock() + self.classes[req.slo_class]
        if self.flight is not None:
            self.flight.record("sched_requeue", rid=req.rid,
                               slo_class=req.slo_class,
                               generated=len(req.tokens))
        self._queues.setdefault((req.tenant, req.slo_class),
                                deque()).appendleft(req)

    def _heads(self):
        return [(t, q[0]) for (t, _c), q in self._queues.items() if q]

    def peek(self):
        """The request `take` would hand out next (None when empty)."""
        heads = self._heads()
        if not heads:
            return None
        now = self._clock()
        overdue = [(t, r) for t, r in heads if now >= r.deadline_t]
        if overdue:
            t, r = min(overdue,
                       key=lambda tr: (tr[1].deadline_t, tr[1]._sched_seq))
            return r
        t, r = min(heads, key=lambda tr: (
            self.classes[tr[1].slo_class],
            self.service.get(tr[0], 0),
            tr[1]._sched_seq))
        return r

    def take(self):
        """Pop the next admission (None when empty) and charge its tenant's
        service ledger."""
        req = self.peek()
        if req is None:
            return None
        q = self._queues[(req.tenant, req.slo_class)]
        assert q[0] is req
        q.popleft()
        if not getattr(req, "_service_charged", False):
            self.service[req.tenant] = (self.service.get(req.tenant, 0)
                                        + len(req.prompt) + req.max_new)
            req._service_charged = True
        if self.flight is not None:
            self.flight.record(
                "sched_admit", rid=req.rid, tenant=req.tenant,
                slo_class=req.slo_class,
                overdue=bool(req.deadline_t is not None
                             and self._clock() >= req.deadline_t))
        return req
