"""Live telemetry exporter: in-process gauges/counters over local HTTP (the
port's copy of the JAX `obs/telemetry.py`).

The live view of a serving run: is a replica's queue growing, did the
interactive class's attainment collapse, how many pages are left.
Producers (the serving engines, the router, the SLO controller) publish
gauges and counters into a lock-protected registry, and one exporter
thread serves them at `http://127.0.0.1:<port>/metrics.json` (machine
JSON) and `/metrics` (Prometheus text exposition), plus mirrors a periodic
`telemetry_snapshot` event into the MetricsWriter jsonl, so a collector
can follow a run live or afterwards through one stream.

Overhead discipline (the "live never costs the hot path" budget):
* a producer update is one lock acquire + one dict store — no I/O, no
  string formatting, no collectives (the watchdog rule: a stalled
  process must never be asked to gather liveness over the fabric that
  stalled it);
* rendering (JSON/Prometheus text) happens on the EXPORTER thread per
  scrape, against a snapshot taken under the lock;
* `rate()` turns a monotone counter into a smoothed per-second gauge
  with two floats of state — producers never compute rates themselves.

Lock discipline: every mutation of the
registry dicts and the closed flag holds `_lock`; server/thread handles
are touched only by the owning start()/close() caller thread.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Callable, Dict, Optional

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_name(name: str) -> str:
    """`serve/tokens_per_sec` -> `serve_tokens_per_sec` (the exposition
    format forbids '/' and friends); a leading digit gets a '_' prefix."""
    n = _PROM_BAD.sub("_", name)
    return ("_" + n) if n[:1].isdigit() else n


class TelemetryExporter:
    """Thread-safe gauge/counter registry + local HTTP endpoint.

    `writer`/`rollup_interval`: when both are set, a snapshot thread
    mirrors the registry into a `telemetry_snapshot` MetricsWriter event
    every `rollup_interval` seconds (the collector's jsonl food). The
    HTTP server starts only on `start(port)` — the registry alone works
    headless (the fleet's replicas, the controller's snapshots)."""

    def __init__(self, writer=None, process_index: int = 0,
                 rollup_interval: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        self.writer = writer
        self.process_index = process_index
        self.rollup_interval = rollup_interval
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self._gauges: Dict[str, float] = {}
        self._counters: Dict[str, float] = {}
        self._rate_state: Dict[str, tuple] = {}  # name -> (value, t, ewma)
        self._closed = False
        self._stop = threading.Event()
        self._server = None
        self._server_thread = None
        self._snap_thread = None
        self.port: Optional[int] = None
        self.scrapes = 0
        self.snapshots = 0

    # -- producer API (hot path: one lock + one store) --------------------
    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            if not self._closed:
                self._gauges[name] = float(value)

    def counter(self, name: str, value: float) -> None:
        """Set a monotone cumulative counter to its CURRENT total (the
        engines already keep the totals; re-deriving increments would add
        state for nothing)."""
        with self._lock:
            if not self._closed:
                self._counters[name] = float(value)

    def count(self, name: str, inc: float = 1.0) -> None:
        with self._lock:
            if not self._closed:
                self._counters[name] = self._counters.get(name, 0.0) + inc

    def rate(self, name: str, cumulative: float,
             decay: float = 0.7) -> None:
        """Publish `name` as a smoothed per-second rate of a monotone
        cumulative total (EWMA over successive calls; the first call just
        seeds the state). Gauge + counter in one: `<name>` is the rate,
        the raw total rides as `<name>_total`."""
        now = self._clock()
        with self._lock:
            if self._closed:
                return
            prev = self._rate_state.get(name)
            if prev is not None:
                last_v, last_t, ewma = prev
                dt = now - last_t
                if dt > 1e-6:
                    inst = max(cumulative - last_v, 0.0) / dt
                    ewma = (inst if ewma is None
                            else decay * ewma + (1 - decay) * inst)
                    self._gauges[name] = ewma
                    self._rate_state[name] = (cumulative, now, ewma)
            else:
                self._rate_state[name] = (cumulative, now, None)
            self._counters[name + "_total"] = float(cumulative)

    # -- consumer API -----------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {"ts_wall": self._wall(),
                    "process": self.process_index,
                    "gauges": dict(self._gauges),
                    "counters": dict(self._counters)}

    def prometheus(self) -> str:
        """Prometheus text exposition v0.0.4 of the current registry."""
        snap = self.snapshot()
        lines = []
        for name, v in sorted(snap["gauges"].items()):
            n = prometheus_name(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f'{n}{{process="{snap["process"]}"}} {v:g}')
        for name, v in sorted(snap["counters"].items()):
            n = prometheus_name(name)
            lines.append(f"# TYPE {n} counter")
            lines.append(f'{n}{{process="{snap["process"]}"}} {v:g}')
        return "\n".join(lines) + "\n"

    # -- the exporter thread ----------------------------------------------
    def start(self, port: int) -> int:
        """Bind 127.0.0.1:`port` (0 = ephemeral; the bound port is
        returned and kept in `self.port`) and serve /metrics.json +
        /metrics from a daemon thread. A busy/forbidden port refuses
        LOUDLY up front — a run whose scrapes silently 404 is worse than
        no run (the require_writable_dir convention)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib casing)
                with exporter._lock:   # handler threads are concurrent
                    exporter.scrapes += 1
                if self.path.startswith("/metrics.json"):
                    body = json.dumps(exporter.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = exporter.prometheus().encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_error(404, "try /metrics or /metrics.json")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stdout
                pass

        try:
            self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        except OSError as e:
            raise SystemExit(
                f"--metrics_port {port}: cannot bind 127.0.0.1:{port} "
                f"({type(e).__name__}: {e}) — the port is busy or "
                f"forbidden; pick a free port (0 = ephemeral) or drop "
                f"the flag")
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="telemetry-exporter")
        self._server_thread.start()
        if self.writer is not None and self.rollup_interval > 0:
            self._snap_thread = threading.Thread(
                target=self._snapshot_loop, daemon=True,
                name="telemetry-snapshots")
            self._snap_thread.start()
        return self.port

    def _snapshot_loop(self) -> None:
        while not self._stop.wait(self.rollup_interval):
            self._emit_snapshot()

    def _emit_snapshot(self) -> None:
        snap = self.snapshot()
        with self._lock:
            self.snapshots += 1
        self.writer.event("telemetry_snapshot", gauges=snap["gauges"],
                          counters=snap["counters"],
                          process=snap["process"])

    def emit_snapshot(self) -> int:
        """Land ONE snapshot event now and return its 1-based sequence
        number (how many this process has emitted, in stream order) —
        the control plane's cross-link: a `controller_decision` stores
        this as `snapshot_seq`, so the post-hoc ledger joins the
        decision to the exact registry state that triggered it. 0 when
        there is no writer to land the event in."""
        if self.writer is None:
            return 0
        self._emit_snapshot()
        return self.snapshots

    def close(self) -> None:
        """Stop the threads, then land ONE final snapshot event (a run's
        last registry state is the one the post-hoc reader wants — the
        snapshot thread is joined first so it cannot race a duplicate),
        then the registry refuses further writes. Idempotent."""
        with self._lock:
            if self._closed:
                return
        self._stop.set()
        if self._snap_thread is not None:
            self._snap_thread.join(timeout=5.0)
        if self.writer is not None:
            self._emit_snapshot()
        with self._lock:
            self._closed = True
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._server_thread is not None:
            self._server_thread.join(timeout=5.0)

    def __enter__(self) -> "TelemetryExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def fleet_slo_attainment(per_proc_counts) -> dict:
    """Fold per-process SLO counters into FLEET attainment: given an
    iterable of `{class: (completed, hit)}` dicts (one per process), the
    completion-weighted attainment per class — 100% of 2 requests on one
    replica must not mask 40% of 2000 on another. Pure math, shared by
    the collector rollup and the tests' hand-computed check."""
    agg: Dict[str, list] = {}
    for proc in per_proc_counts:
        for cls, (completed, hit) in proc.items():
            a = agg.setdefault(cls, [0, 0])
            a[0] += int(completed)
            a[1] += int(hit)
    return {cls: {"completed": c, "attained": round(h / c, 4) if c else 0.0}
            for cls, (c, h) in sorted(agg.items())}
