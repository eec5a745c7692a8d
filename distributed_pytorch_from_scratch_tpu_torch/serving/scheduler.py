"""FIFO admission queue with length-bucketed prefill batching (the port's
copy of the JAX `serving/scheduler.py` slot-engine part).

`take_batch` peels requests off the HEAD of the queue and stops at the
first one whose bucket-padded prefill width differs from the head's, so
nothing ever jumps the queue. A prompt of length p prefills over a buffer
of width `ceil(p / prefill_bucket) * prefill_bucket`, clamped to buf_len;
under causal attention the width changes cost only, never values.
`max_queue` bounds the waiting requests: `submit()` past it raises
`QueueFull`. The SLO scheduler of the paged engine is not ported yet.
"""

from __future__ import annotations

import time
from collections import deque
from typing import TYPE_CHECKING, List

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
                 max_queue: int = 0):
        self.buf_len = buf_len
        self.prefill_bucket = prefill_bucket
        self.max_queue = max_queue
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
            raise QueueFull(
                f"admission queue full ({self.max_queue} waiting); request "
                f"{req.rid} refused — retry later or raise --queue_limit")
        if req.submit_t is None:
            req.submit_t = time.monotonic()
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
