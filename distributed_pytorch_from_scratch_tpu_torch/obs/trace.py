"""Span-based host-timeline tracer emitting Chrome trace-event JSON (the
port's copy of the JAX `obs/trace.py`).

Every span becomes one complete ("ph": "X") trace event streamed to
`trace.jsonl` (one JSON object per line — crash-safe, grep-able) and, at
`close()`, collected into a Perfetto/chrome://tracing-loadable `trace.json`
(`{"traceEvents": [...]}`, events sorted by timestamp).

This is the HOST timeline — what a loop's wall clock was spent on (the
serving engines' prefill, chunk, decode and speculative draft / verify
dispatches) — complementary to `torch.profiler`, which captures the DEVICE
timeline for a short window. The host view is cheap enough to leave on for
a whole run; the device view is not.

Threads map to separate `tid` tracks (the prefetch thread and the async
checkpoint writer show up alongside the main loop); multi-host processes map
to `pid`, so traces from several hosts can be concatenated into one viewer.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional


class SpanTracer:
    """Thread-safe span recorder. `enabled=False` turns every method into a
    cheap no-op so call sites need no guards."""

    def __init__(self, log_dir: str, enabled: bool = True, pid: int = 0,
                 process_name: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self.pid = pid
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._jsonl = None
        self._closed = False
        self.log_dir = log_dir
        self._jsonl_path = os.path.join(log_dir, "trace.jsonl")
        self._process_name = process_name
        # File creation is LAZY (first emitted event): an invocation that
        # dies in argument/data validation emits nothing and therefore
        # must not touch — let alone rotate away — the previous run's
        # post-mortem timeline.

    def _open_locked(self) -> None:
        """First event: rotate the previous run's files one generation
        back (a --resume or relaunch into the same dir must not truncate
        the preempted run's timeline; ts epochs restart per run, so the
        generations stay separate files) and start the stream. Events go
        straight to disk; close() re-reads the file to build trace.json,
        so host memory stays O(1) over arbitrarily long runs."""
        os.makedirs(self.log_dir, exist_ok=True)
        for name in ("trace.jsonl", "trace.json"):
            old = os.path.join(self.log_dir, name)
            if os.path.exists(old):
                os.replace(old, os.path.join(self.log_dir, name + ".prev"))
        self._jsonl = open(self._jsonl_path, "w")
        if self._process_name:
            self._jsonl.write(json.dumps(
                {"name": "process_name", "ph": "M", "pid": self.pid,
                 "tid": 0, "args": {"name": self._process_name}}) + "\n")

    def now(self) -> float:
        """Clock sample for `complete()` (perf_counter seconds)."""
        return self._clock()

    def _ts_us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _emit(self, ev: dict) -> None:
        with self._lock:
            if self._closed:
                return
            if self._jsonl is None:
                self._open_locked()
            self._jsonl.write(json.dumps(ev) + "\n")
            self._jsonl.flush()

    @contextmanager
    def span(self, name: str, cat: Optional[str] = None, **args):
        """Record a complete event covering the with-block."""
        if not self.enabled:
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            self.complete(name, t0, cat=cat, **args)

    def complete(self, name: str, start: float, cat: Optional[str] = None,
                 **args) -> None:
        """Record a complete event from an explicit `now()` start sample —
        for call sites where a with-block does not fit (producer loops)."""
        if not self.enabled:
            return
        end = self._clock()
        ev = {"name": name, "ph": "X", "ts": self._ts_us(start),
              "dur": (end - start) * 1e6, "pid": self.pid,
              "tid": threading.get_ident()}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._emit(ev)

    def complete_span(self, name: str, start: float, end: float,
                      cat: Optional[str] = None, tid: Optional[int] = None,
                      **args) -> None:
        """Complete event from two explicit clock samples (same clock as
        `now()`). `tid` overrides the thread id — synthetic per-request
        tracks (obs/reqtrace.py) use it so a request's whole timeline
        renders as one row instead of scattering over host threads."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "ts": self._ts_us(start),
              "dur": max(end - start, 0.0) * 1e6, "pid": self.pid,
              "tid": threading.get_ident() if tid is None else tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self._emit(ev)

    def flow(self, name: str, phase: str, flow_id: int, t: float,
             tid: Optional[int] = None) -> None:
        """Flow event (`ph` in {"s","t","f"}): draws an arrow between
        tracks in the viewer. The request tracer binds a request's
        enqueue to its retire so a cross-track timeline is followable."""
        if not self.enabled:
            return
        assert phase in ("s", "t", "f"), phase
        ev = {"name": name, "ph": phase, "id": int(flow_id),
              "cat": "request", "ts": self._ts_us(t), "pid": self.pid,
              "tid": threading.get_ident() if tid is None else tid}
        if phase == "f":
            ev["bp"] = "e"  # bind to the enclosing slice
        self._emit(ev)

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "p",
              "ts": self._ts_us(self._clock()), "pid": self.pid,
              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "C",
                    "ts": self._ts_us(self._clock()), "pid": self.pid,
                    "tid": 0, "args": {"value": float(value)}})

    def close(self) -> Optional[str]:
        """Finalise: close the jsonl stream, re-read it, and write the
        events as `trace.json` (sorted by ts). Returns the trace.json
        path, or None when disabled or no event was ever emitted (nothing
        was written OR rotated in that case). Idempotent."""
        if not self.enabled:
            return None
        with self._lock:
            if self._closed:
                return (os.path.join(self.log_dir, "trace.json")
                        if self._jsonl is not None else None)
            self._closed = True
            if self._jsonl is None:  # no events: leave prior runs alone
                return None
            self._jsonl.close()
        # Sort by ts (spans are recorded at END time, so raw order is not
        # monotonic) while keeping memory lean: hold (ts, raw_line) pairs,
        # not parsed event dicts — close() peaks at ~2x the jsonl size
        # instead of the ~10x that a list of dicts would cost.
        events = []
        with open(self._jsonl_path) as f:
            for line in f:
                line = line.strip()
                try:
                    ev = json.loads(line)
                except ValueError:  # torn final line from a hard kill
                    continue
                events.append((ev.get("ts", -1.0), line))
        events.sort(key=lambda p: p[0])
        path = os.path.join(self.log_dir, "trace.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write('{"traceEvents": [')
            f.write(",".join(line for _, line in events))
            f.write('], "displayTimeUnit": "ms"}')
        os.replace(tmp, path)
        return path
