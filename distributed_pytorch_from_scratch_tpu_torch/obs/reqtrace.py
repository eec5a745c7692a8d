"""Per-request span timelines for the serving stack (the port's copy of the
JAX `obs/reqtrace.py`).

`loadgen` has always reported TTFT/TPOT percentiles — COUNTS of SLO
misses. This module makes each miss EXPLAINABLE: every request carries a
trace id from submit to retire, and the engines mark phase transitions
(`queued`, `prefill_chunk`, `decode`, `spec_round`, `preempted`, ...) on
its timeline as they happen. The timeline is CONTIGUOUS by construction —
each mark closes the span that started at the previous mark — so the span
sum always equals the request's wall time (submit -> finish = TTFT +
decode wall), and a gap can never hide: whatever the engine was doing from
this request's point of view has a named span.

Memory stays bounded two ways: adjacent same-phase marks COALESCE (a
64-token decode is one span with count=64, its numeric args summed — the
waterfall needs phase totals, not per-token rows), and the retired-record
store is a ring (`max_completed`).

On retire the timeline is emitted three ways:
* a `request_trace` MetricsWriter event (jsonl — the machine-readable
  record a waterfall and the k-worst exemplars read),
* Chrome-trace spans on a synthetic per-request track in the existing
  `SpanTracer` file, with a flow arrow binding enqueue to retire, so a
  request's life renders alongside the engine's dispatch spans,
* `completed[rid]` for in-process consumers (loadgen's k-worst picker).

Cross-process propagation: a request that is prefilled in one
process and decoded in another (the router -> prefill replica -> decode
replica shape the fleet PR needs) carries a serializable `TraceContext`
across the boundary. The context holds the trace id plus a CLOCK-OFFSET
HANDSHAKE: the exporter stamps its wall clock at export, the adopter
stamps its own at adoption, and the difference translates the adopter's
timestamps into the ROOT process's wall timebase. (A one-way handshake
cannot separate transfer latency from clock skew; the merge therefore
keeps every measured span duration intact and renders any root-timebase
gap as an explicit `handoff` span.) Each process still retires its own
`request_trace`
record; `merge_traces` joins records sharing a trace id into ONE
contiguous waterfall whose span sum equals the cross-process wall, even
under a deliberately skewed clock.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional

# synthetic Chrome-trace track ids for request timelines: far above any
# real thread id is impossible (they are huge), so instead requests map
# onto a small band of dedicated tracks by rid
REQ_TRACK_BASE = 1_000_000
REQ_TRACKS = 64


@dataclass
class TraceContext:
    """The wire form of an in-flight request's trace: everything the
    next process needs to CONTINUE the timeline rather than start a new
    one. `handoff_wall` is the exporter's wall clock at export,
    expressed in the ROOT process's timebase (offsets compose across
    multi-hop chains: router -> prefill -> decode)."""

    trace_id: str
    rid: int
    parent_span: str          # the phase the origin closed at export
    origin_process: int
    handoff_wall: float       # root-timebase wall seconds at export

    def to_wire(self) -> dict:
        return asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "TraceContext":
        return cls(trace_id=str(d["trace_id"]), rid=int(d["rid"]),
                   parent_span=str(d.get("parent_span", "handoff")),
                   origin_process=int(d.get("origin_process", 0)),
                   handoff_wall=float(d["handoff_wall"]))


@dataclass
class _Timeline:
    rid: int
    trace_id: str
    t0: float
    last: float
    t0_wall: float = 0.0      # local wall clock at begin
    offset_s: float = 0.0     # local wall + offset_s = ROOT wall
    origin: Optional[dict] = None  # adopted-from link (None for root)
    spans: List[dict] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)


class RequestTracer:
    """Thread-unsafe by design: all marks come from the engine's host
    loop (one thread). `clock` must be the ENGINE's clock (the Request
    timestamps' clock), so span sums agree with `ttft_s`/`tpot_s`."""

    def __init__(self, writer=None, tracer=None, flight=None,
                 clock: Callable[[], float] = time.monotonic,
                 max_completed: int = 8192, process_index: int = 0,
                 wall: Callable[[], float] = time.time):
        self.writer = writer
        self.tracer = tracer
        self.flight = flight
        self._clock = clock
        # wall clock for the cross-process handshake ONLY: span durations
        # stay on the monotonic engine clock; `wall` anchors this proc's
        # timeline to a timebase another proc can translate into
        self.process_index = process_index
        self._wall = wall
        # engine-clock -> tracer-clock translation, sampled once so the
        # request tracks land at the right offsets among the host spans
        self._off = (tracer.now() - clock()) if tracer is not None else 0.0
        self._live: Dict[int, _Timeline] = {}
        self.completed: "OrderedDict[int, dict]" = OrderedDict()
        self.max_completed = max_completed
        self._seq = 0

    # -- lifecycle --------------------------------------------------------
    def begin(self, req, t: Optional[float] = None,
              ctx: Optional[TraceContext] = None) -> str:
        """Open a timeline at submit time (use the request's `submit_t` —
        loadgen backdates it to the planned arrival, and TTFT is measured
        from there). Assigns `req.trace_id`. Re-begin of a live rid is a
        no-op returning the existing id (a preempted request re-enters
        through `requeue`, never through a second submit).

        `ctx`: a TraceContext exported by ANOTHER process — the timeline
        CONTINUES that trace (same id) and the adoption-time wall sample
        completes the clock-offset handshake: this proc's wall clock plus
        `offset_s` is the root proc's wall clock, so the two processes'
        retired records merge into one waterfall (merge_traces)."""
        tl = self._live.get(req.rid)
        if tl is not None:
            return tl.trace_id
        self._seq += 1
        if ctx is not None:
            trace_id = ctx.trace_id
        else:
            trace_id = f"r{req.rid}.{self._seq}"
        req.trace_id = trace_id
        # a CONTINUED trace starts its local segment at adoption time —
        # the origin's record already covers [submit_t, export], and an
        # in-process chain reuses the same Request object, so defaulting
        # to its (stale) submit_t would overlap the two hops' records
        # and break the merged span-sum == wall contract (merge_traces)
        t = (req.submit_t if ctx is None else None) if t is None else t
        if t is None:
            t = self._clock()
        # anchor the wall timebase at t0 even when submit_t was backdated
        # (loadgen stamps the PLANNED arrival): wall-now minus the mono
        # elapsed since t0 is the wall clock AT t0
        tl = _Timeline(rid=req.rid, trace_id=trace_id, t0=t, last=t,
                       t0_wall=self._wall() - (self._clock() - t))
        if ctx is not None:
            # handshake close: the export stamp (root timebase) minus the
            # adoption stamp (local wall) — transfer latency lands in the
            # merged waterfall's handoff gap, not inside any phase
            tl.offset_s = ctx.handoff_wall - tl.t0_wall
            tl.origin = {"parent_span": ctx.parent_span,
                         "origin_process": ctx.origin_process}
        self._live[req.rid] = tl
        return trace_id

    def export_context(self, req,
                       parent_span: str = "handoff") -> Optional[TraceContext]:
        """The wire context for handing `req` to another process. Closes
        the running span as `parent_span` first, so the origin-side
        timeline ends exactly where the receiving side's begins (modulo
        transfer time, which the merge renders as the handoff gap). The
        caller retires the request on this side after the send; the
        receiving engine passes the context to `submit`/`begin`."""
        tl = self._live.get(req.rid)
        if tl is None:
            return None
        self.mark(req, parent_span)
        return TraceContext(trace_id=tl.trace_id, rid=req.rid,
                            parent_span=parent_span,
                            origin_process=self.process_index,
                            handoff_wall=self._wall() + tl.offset_s)

    def mark(self, req, phase: str, t: Optional[float] = None,
             **num_args) -> None:
        """Close the span running since the last mark and label it
        `phase`. Numeric kwargs accumulate across coalesced marks
        (`positions`, `cow`, `accepted`, ...)."""
        tl = self._live.get(req.rid)
        if tl is None:
            return
        t = self._clock() if t is None else t
        if t < tl.last:          # monotonic clocks only; clamp regardless
            t = tl.last
        last = tl.spans[-1] if tl.spans else None
        if last is not None and last["name"] == phase:
            last["end"] = t
            last["count"] += 1
            for k, v in num_args.items():
                last[k] = last.get(k, 0) + v
        else:
            tl.spans.append({"name": phase, "start": tl.last, "end": t,
                             "count": 1, **num_args})
        tl.last = t

    def note(self, req, **counters) -> None:
        """Accumulate request-scoped counters (page leases/frees, COW
        copies) reported once in the retire record, not per span."""
        tl = self._live.get(req.rid)
        if tl is None:
            return
        for k, v in counters.items():
            tl.counters[k] = tl.counters.get(k, 0) + v

    def retire(self, req, t: Optional[float] = None) -> Optional[dict]:
        """Finalize + emit. Residual time between the last mark and the
        finish stamp becomes a closing `retire` span, so the span sum
        equals finish - submit EXACTLY."""
        tl = self._live.pop(req.rid, None)
        if tl is None:
            return None
        t = (req.finish_t if req.finish_t is not None else self._clock()) \
            if t is None else t
        if t > tl.last + 1e-9:
            tl.spans.append({"name": "retire", "start": tl.last, "end": t,
                             "count": 1})
            tl.last = t
        ms = lambda s: round(s * 1e3, 3)
        spans = [{"name": s["name"],
                  "start_ms": ms(s["start"] - tl.t0),
                  "dur_ms": ms(s["end"] - s["start"]),
                  **{k: v for k, v in s.items()
                     if k not in ("name", "start", "end")}}
                 for s in tl.spans]
        rec = {
            "rid": req.rid,
            "trace_id": tl.trace_id,
            "spans": spans,
            "total_ms": ms(tl.last - tl.t0),
            # -- cross-process merge anchors: this record's t0
            # in the ROOT process's wall timebase, the handshake offset
            # that produced it, and the adopted-from link (None = root)
            "process": self.process_index,
            "t0_wall": round(tl.t0_wall + tl.offset_s, 6),
            "clock_offset_ms": ms(tl.offset_s),
            "origin": tl.origin,
            "ttft_ms": None if req.ttft_s is None else ms(req.ttft_s),
            "tpot_ms": None if req.tpot_s is None else ms(req.tpot_s),
            "prompt_len": req.prompt_len or len(req.prompt),
            "generated": len(req.tokens),
            "preemptions": req.preemptions,
            "tenant": req.tenant,
            "slo_class": req.slo_class,
            **tl.counters,
        }
        if self.writer is not None:
            self.writer.event("request_trace", **rec)
        if self.tracer is not None:
            tid = REQ_TRACK_BASE + (req.rid % REQ_TRACKS)
            off = self._off
            for s in tl.spans:
                args = {k: v for k, v in s.items()
                        if k not in ("name", "start", "end")}
                self.tracer.complete_span(
                    f"req{req.rid}:{s['name']}", s["start"] + off,
                    s["end"] + off, cat="request", tid=tid,
                    trace_id=tl.trace_id, **args)
            # flow arrow: submit -> retire, id'd by the tracer sequence so
            # rid reuse across runs cannot cross-link
            self.tracer.flow(f"req{req.rid}", "s", self._seq_of(tl),
                             tl.t0 + off, tid=tid)
            self.tracer.flow(f"req{req.rid}", "f", self._seq_of(tl),
                             tl.last + off, tid=tid)
        if self.flight is not None:
            self.flight.record("request_retired", rid=req.rid,
                               total_ms=rec["total_ms"],
                               ttft_ms=rec["ttft_ms"],
                               preemptions=req.preemptions)
        self.completed[req.rid] = rec
        while len(self.completed) > self.max_completed:
            self.completed.popitem(last=False)
        return rec

    @staticmethod
    def _seq_of(tl: _Timeline) -> int:
        return int(tl.trace_id.rsplit(".", 1)[1])

    # -- accessors --------------------------------------------------------
    @property
    def live(self) -> int:
        return len(self._live)

    def timeline(self, rid: int) -> Optional[dict]:
        """The retired record for `rid` (None while live / evicted)."""
        return self.completed.get(rid)


def merge_traces(records: List[dict], gap_name: str = "handoff") -> dict:
    """Join `request_trace` records sharing one trace id (each retired in
    a different process) into ONE contiguous waterfall in the root
    process's wall timebase.

    Every record's spans are placed at `t0_wall + start_ms` (t0_wall is
    already root-timebase: the adopter folded its handshake offset in at
    retire). Gaps between consecutive spans become explicit `gap_name`
    spans; overlaps — the one-way handshake cannot separate transfer
    latency from clock skew, so an origin's post-export residual can
    land on top of the adopter's first activity — SHIFT the later span
    forward with its duration intact (a measured phase duration is
    ground truth; the placement is only as good as the handshake). The
    merged span sum therefore equals the merged `total_ms` EXACTLY (the
    single-process contiguity contract, now across processes), with
    every process's measured activity accounted contiguously."""
    if not records:
        raise ValueError("merge_traces needs at least one record")
    segs = []
    for r in records:
        base_ms = float(r.get("t0_wall", 0.0)) * 1e3
        for s in r["spans"]:
            segs.append((base_ms + s["start_ms"], r.get("process", 0), s))
    segs.sort(key=lambda e: e[0])
    t0 = segs[0][0]
    cursor = t0
    spans: List[dict] = []
    for abs_ms, proc, s in segs:
        if abs_ms > cursor + 1e-6:
            spans.append({"name": gap_name,
                          "start_ms": round(cursor - t0, 3),
                          "dur_ms": round(abs_ms - cursor, 3),
                          "count": 1, "process": proc})
            cursor = abs_ms
        # abs_ms <= cursor: overlap — the span starts at the cursor with
        # its full measured duration
        spans.append({**{k: v for k, v in s.items()
                         if k not in ("start_ms", "dur_ms")},
                      "start_ms": round(cursor - t0, 3),
                      "dur_ms": round(s["dur_ms"], 3), "process": proc})
        cursor += s["dur_ms"]
    by_t0 = sorted(records, key=lambda r: float(r.get("t0_wall", 0.0)))
    return {
        "trace_id": records[0].get("trace_id"),
        "rid": by_t0[0].get("rid"),
        "spans": spans,
        "total_ms": round(cursor - t0, 3),
        "processes": sorted({r.get("process", 0) for r in records}),
        "records": len(records),
        # generated tokens accumulate across the hops
        "generated": sum(int(r.get("generated") or 0) for r in records),
    }
