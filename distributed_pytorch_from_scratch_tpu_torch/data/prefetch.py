"""Host-side input prefetching — the port's copy of the JAX
`data/prefetch.py`: one background thread assembles the next dispatch's
window (the collate, and the `--steps_per_dispatch` / `--grad_accum` stack)
while the card runs the current one, so the train loop's per-dispatch host
work is a queue pop.

The thread makes HOST (numpy) windows only. The host-to-device copy of a
window stays on the train loop's thread and stream: under
`--steps_per_dispatch` the captured graph reads static input buffers
(`runtime/graphs.CapturedStep`), and a producer that wrote them would race
the replay.

Double buffering (depth 2) is enough: the consumer is never more than one
window ahead, and a deeper queue only holds more memory.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

BATCH_KEYS = ("input_ids", "target_ids", "position_ids")


def window_stream(batches: Iterable[dict], size: int,
                  skip: int = 0) -> Iterator[list]:
    """An epoch's batches in lists of `size` (one dispatch window each),
    after skipping the first `skip` batches (resume). The last, partial
    window is yielded too: the caller decides its fate (the train loop drops
    a partial accumulation group and dispatches a partial spd window)."""
    buf = []
    for i, b in enumerate(batches):
        if i < skip:
            continue
        buf.append(b)
        if len(buf) == size:
            yield buf
            buf = []
    if buf:
        yield buf


def stack_window(bufs: list) -> dict:
    """One (w, b, t) megabatch from w collated batches: the host half of a
    `--steps_per_dispatch` / `--grad_accum` dispatch."""
    return {k: np.stack([b[k] for b in bufs]) for k in BATCH_KEYS}


class Prefetcher:
    """Iterates `src` on a daemon thread, `transform` applied there, with a
    bounded queue between the producer and the consumer.

    An exception from the source or the transform re-raises at the
    consumer's next pull. `close()` (also called on exhaustion) stops the
    thread promptly: the producer polls a stop flag around its bounded puts,
    so an abandoned epoch leaks no blocked thread. `wait_time` is the
    seconds the CONSUMER spent blocked, `pulls` its pulls (the end
    sentinel's included)."""

    _DONE = object()

    def __init__(self, src: Iterable, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self.wait_time = 0.0
        self.pulls = 0

        def worker():
            try:
                for item in src:
                    if transform is not None:
                        item = transform(item)
                    self._put_until_stopped(item)
                    if self._stop.is_set():
                        return
                self._put_until_stopped(self._DONE)
            except BaseException as e:  # re-raised at the consumer
                self._put_until_stopped(e)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="input-prefetch")
        self._thread.start()

    def _put_until_stopped(self, item) -> None:
        """A bounded put that gives up once close() is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_time += time.perf_counter() - t0
        self.pulls += 1
        if item is self._DONE:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
