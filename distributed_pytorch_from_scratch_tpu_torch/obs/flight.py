"""Anomaly flight recorder: a bounded ring of recent telemetry that every
anomaly path dumps as one self-contained JSON file (the port's copy of the
JAX `obs/flight.py`).

Producers `record()` cheap dict events (pool stats, scheduler decisions,
preemptions, copy-on-write copies, retired requests) into a lock-protected
`deque(maxlen=N)` — O(1) memory forever — and an anomaly path (a
PoolExhausted preemption, an SLO-attainment collapse) calls
`dump(trigger)` to freeze the ring plus the triggering event into
`flightdump_<tag>_<seq>.json`. One recorder is shared by every producer of
a process (a serving engine, its scheduler and its KV pool), so a dump is
their interleaved recent history in arrival order. `max_dumps` caps the
files a preemption storm can write; the skipped count is reported in every
dump's metadata. A dump's `profile` field is the JAX recorder's link to an
anomaly-armed device capture; the port arms none, so it is null.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from .schema import EVENT_SCHEMA_VERSION


class FlightRecorder:
    def __init__(self, dump_dir: str, maxlen: int = 512, max_dumps: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        if maxlen < 1:
            raise ValueError(f"flight ring maxlen must be >= 1, got {maxlen}")
        self.dump_dir = dump_dir
        self.maxlen = maxlen
        self.max_dumps = max_dumps
        self._clock = clock
        self._ring: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.recorded = 0          # total record() calls (ring may be full)
        self.dumps: List[str] = []  # paths actually WRITTEN, trigger order
        self.dumps_skipped = 0     # triggers past the max_dumps cap
        self.dump_failures = 0     # writes that failed (disk full, ...)
        self._dump_seq = 0         # filename sequence (failed writes too)
        self._dumps_inflight = 0   # reserved slots with writes pending

    def record(self, kind: str, **fields) -> None:
        """Append one event to the ring; the deque evicts the oldest entry
        at capacity, so memory is bounded whatever the rate."""
        ev = {"ts": round(self._clock(), 6), "kind": kind, **fields}
        with self._lock:
            self._ring.append(ev)
            self.recorded += 1

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self, trigger: dict, tag: str = "anomaly") -> Optional[str]:
        """Freeze the ring + `trigger` into a self-contained JSON file and
        return its path. Returns None once `max_dumps` files exist (counted
        in `dumps_skipped`), and None on a FAILED write (disk full, dump
        dir removed): a diagnostic artifact never kills the run it
        diagnoses, and a failed write takes no `max_dumps` slot."""
        with self._lock:
            if len(self.dumps) + self._dumps_inflight >= self.max_dumps:
                self.dumps_skipped += 1
                return None
            ring = list(self._ring)
            # reserve a cap slot and a distinct file name under the lock
            # (concurrent triggers); `dumps` gains the path once written
            self._dumps_inflight += 1
            seq = self._dump_seq
            self._dump_seq += 1
            path = os.path.join(
                self.dump_dir, f"flightdump_{tag}_{seq:03d}.json")
        doc = {
            "schema_version": EVENT_SCHEMA_VERSION,
            "tag": tag,
            "trigger": {"ts": round(self._clock(), 6), **trigger},
            "profile": None,
            "ring": ring,
            "ring_maxlen": self.maxlen,
            "recorded_total": self.recorded,
            "dumps_skipped": self.dumps_skipped,
            "wall_time": time.time(),
        }
        tmp = path + ".tmp"
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            with self._lock:
                self._dumps_inflight -= 1
                self.dump_failures += 1
            return None
        with self._lock:
            self._dumps_inflight -= 1
            self.dumps.append(path)
        return path
