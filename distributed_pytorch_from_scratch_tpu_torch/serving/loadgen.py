"""Synthetic arrival stream, trace replay and the offline serving benchmark
loops (the port's copy of the JAX `serving/loadgen.py`).

`synthetic_requests` is numpy-only and draws exactly as the JAX version
does, so one seed gives the same requests in both packages;
`replay_requests` reads a captured trace with the JAX schema. `run_loadgen`
drives either engine against the wall clock: a request is submitted once
its arrival offset has elapsed, the engine steps whenever it has live work,
and the loop sleeps only when idle before the next arrival.
`run_fleet_loadgen` drives a `router.FleetRouter` the same way.
"""

from __future__ import annotations

import json
import sys
import time
from typing import List, Optional

import numpy as np

from ..obs.telemetry import fleet_slo_attainment
from .engine import Request
from .scheduler import QueueFull


def synthetic_requests(num: int, prompt_len_min: int, prompt_len_max: int,
                       max_new: int, vocab_size: int, seed: int = 0,
                       rate: float = 4.0, arrival: str = "poisson",
                       class_mix: Optional[dict] = None, tenants: int = 1,
                       shared_prefix_len: int = 0,
                       interleave: bool = False) -> List[Request]:
    """`num` requests with random-id prompts and arrival offsets (seconds
    from t=0, sorted). Token ids avoid 0/1/2 (the BOS/EOS/UNK convention)
    so a random prompt cannot start with a spurious EOS. `poisson`: gaps
    exponential at `rate` req/s; `burst`: everything at t=0.

    Paged-engine knobs (all deterministic under `seed`): `class_mix` draws
    each request's SLO class by weight ({name: w}); `tenants` spreads
    requests round-robin over t0..tN-1; `shared_prefix_len` > 0 prepends
    ONE common random prefix to every prompt (a system-prompt stand-in, the
    COW prefix cache's food); `interleave` alternates short
    (prompt_len_min) and long (prompt_len_max) prompts instead of drawing
    uniformly."""
    if arrival not in ("poisson", "burst"):
        raise ValueError(f"arrival must be poisson|burst, got {arrival!r}")
    if not 3 <= prompt_len_min <= prompt_len_max:
        raise ValueError(f"need 3 <= prompt_len_min <= prompt_len_max, got "
                         f"[{prompt_len_min}, {prompt_len_max}]")
    if tenants < 1:
        raise ValueError(f"tenants must be >= 1, got {tenants}")
    rng = np.random.default_rng(seed)
    if arrival == "burst":
        at = np.zeros(num)
    else:
        if rate <= 0:
            raise ValueError(f"poisson arrivals need rate > 0, got {rate}")
        at = np.cumsum(rng.exponential(1.0 / rate, size=num))
    names, weights = None, None
    if class_mix:
        names = sorted(class_mix)
        w = np.asarray([float(class_mix[n]) for n in names], np.float64)
        if (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"class_mix weights must be >= 0 and sum > 0, "
                             f"got {class_mix}")
        weights = w / w.sum()
    shared = [int(t) for t in
              rng.integers(3, vocab_size, size=shared_prefix_len)]
    out = []
    for i in range(num):
        if interleave:
            plen = prompt_len_min if i % 2 == 0 else prompt_len_max
        else:
            plen = int(rng.integers(prompt_len_min, prompt_len_max + 1))
        prompt = shared + [int(t) for t in
                           rng.integers(3, vocab_size, size=plen)]
        cls = (str(names[int(rng.choice(len(names), p=weights))])
               if names else None)
        out.append(Request(rid=i, prompt=prompt, max_new=max_new,
                           seed=seed + i, arrival=float(at[i]),
                           tenant=f"t{i % tenants}", slo_class=cls))
    return out


def replay_requests(path: str) -> List[Request]:
    """A captured request trace (jsonl, one record per request: `prompt`,
    and `rid`, `max_new`, `seed`, `arrival` with the JAX defaults: the
    line's index, 64, the line's index, 0), sorted by arrival."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out.append(Request(
                rid=rec.get("rid", i), prompt=list(rec["prompt"]),
                max_new=int(rec.get("max_new", 64)),
                seed=int(rec.get("seed", i)),
                arrival=float(rec.get("arrival", 0.0))))
    return sorted(out, key=lambda r: r.arrival)


def nearest_rank(vals: List[float], q: float) -> float:
    """The JAX fleet's percentile of a SORTED list: the element at rank
    int(q * (n - 1)), 0.0 when empty (router dispatch and transfer ms)."""
    return vals[min(len(vals) - 1, int(q * (len(vals) - 1)))] if vals else 0.0


def _pctl(vals: List[Optional[float]], q: float) -> Optional[float]:
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


def worst_request_exemplars(engine, done, k: int = 3) -> Optional[dict]:
    """The k worst TTFT and TPOT requests WITH their span timelines (from
    the engine's request tracer): what explains an SLO miss, not only
    counts it. None when tracing is off."""
    rt = engine.rt
    if rt is None:
        return None
    ms = 1e3

    def exemplars(key):
        ranked = sorted((r for r in done if key(r) is not None),
                        key=key, reverse=True)[:k]
        out = []
        for r in ranked:
            rec = rt.timeline(r.rid)
            out.append({
                "rid": r.rid, "trace_id": r.trace_id,
                "ttft_ms": None if r.ttft_s is None
                else round(r.ttft_s * ms, 3),
                "tpot_ms": None if r.tpot_s is None
                else round(r.tpot_s * ms, 3),
                "preemptions": r.preemptions,
                "slo_class": r.slo_class,
                "timeline": rec["spans"] if rec else None,
            })
        return out

    return {"k": k,
            "worst_ttft": exemplars(lambda r: r.ttft_s),
            "worst_tpot": exemplars(lambda r: r.tpot_s)}


def run_loadgen(engine, requests: List[Request], k_worst: int = 3) -> dict:
    """Drive `engine` through the arrival stream; returns the summary dict
    (percentiles in ms; throughput over the wall window). Backpressure
    (QueueFull) counts as `rejected`, a malformed request as `invalid`;
    neither stops the run. With the engine's obs hooks: the k worst
    requests' timelines (`worst_ttft_rids` / `worst_tpot_rids`), a flight
    dump for a class whose attainment collapsed (unless the engine dumped
    it in the run), and the `request_exemplars`, `serving_summary`,
    `paged_kv_stats` and `spec_decode_stats` events."""
    pending = sorted(requests, key=lambda r: r.arrival)
    t0 = time.monotonic()
    i = 0
    invalid = 0
    while i < len(pending) or engine.has_work():
        now = time.monotonic() - t0
        while i < len(pending) and pending[i].arrival <= now:
            try:
                # stamp the PLANNED arrival as the submit time, so queue
                # wait and TTFT include time spent waiting for the loop
                pending[i].submit_t = t0 + pending[i].arrival
                engine.submit(pending[i])
            except QueueFull:
                pass  # counted by the scheduler (engine.stats()["rejected"])
            except ValueError as e:
                invalid += 1
                print(f"loadgen: request {pending[i].rid} invalid: {e}",
                      file=sys.stderr)
            i += 1
        if engine.has_work():
            engine.step()
        elif i < len(pending):
            wait = pending[i].arrival - (time.monotonic() - t0)
            time.sleep(min(0.05, max(0.0, wait)))
    wall = max(time.monotonic() - t0, 1e-9)
    done = engine.completed
    stats = engine.stats()
    ms = 1e3
    summary = {
        "requests": len(requests),
        "completed": len(done),
        "rejected": stats["rejected"],
        "invalid": invalid,
        "wall_s": round(wall, 4),
        "generated_tokens": stats["generated_tokens"],
        "tokens_per_sec": round(stats["generated_tokens"] / wall, 2),
        "decode_steps": stats["decode_steps"],
        "slot_occupancy_mean": stats["slot_occupancy_mean"],
        "prefill_pad_waste_eliminated":
            stats.get("prefill_pad_waste_eliminated", 0.0),
        "ttft_ms_p50": _pctl([r.ttft_s and r.ttft_s * ms for r in done], 50),
        "ttft_ms_p95": _pctl([r.ttft_s and r.ttft_s * ms for r in done], 95),
        "tpot_ms_p50": _pctl([r.tpot_s and r.tpot_s * ms for r in done], 50),
        "tpot_ms_p95": _pctl([r.tpot_s and r.tpot_s * ms for r in done], 95),
        "queue_wait_ms_p50": _pctl(
            [r.queue_wait_s and r.queue_wait_s * ms for r in done], 50),
        "queue_wait_ms_p95": _pctl(
            [r.queue_wait_s and r.queue_wait_s * ms for r in done], 95),
    }
    if "kv_util_mean" in stats:        # the paged engine's extra telemetry
        summary.update({k: stats[k] for k in (
            "kv_dtype", "paged_attn", "cp", "pages_per_rank", "num_pages",
            "kv_util_mean", "kv_fragmentation_mean", "pages_in_use_mean",
            "prefix_hit_rate", "cow_copies", "preemptions", "max_live",
            "max_interleaved_prefill_positions")})
    if "speculate_k" in stats:         # the speculative engine's telemetry
        summary.update({k: stats[k] for k in (
            "speculate_k", "spec_rounds", "accepted_tokens_per_dispatch",
            "acceptance_rate", "acceptance_rate_by_position",
            "rounds_per_request", "drafter_ms_total", "target_ms_total")})
    att = slo_attainment(engine, done)
    if att is not None:
        summary["slo_attainment"] = att
        if engine.flight is not None:
            dumped = getattr(engine, "slo_collapsed", set())
            for name, c in sorted(att.items()):
                if (c["completed"] >= 4 and c["attained"] < 0.5
                        and name not in dumped):
                    engine.flight.dump(
                        {"kind": "slo_attainment_collapse",
                         "slo_class": name, **c},
                        tag="slo_collapse")
    exemplars = worst_request_exemplars(engine, done, k=k_worst)
    if exemplars is not None:
        summary["worst_ttft_rids"] = [e["rid"]
                                      for e in exemplars["worst_ttft"]]
        summary["worst_tpot_rids"] = [e["rid"]
                                      for e in exemplars["worst_tpot"]]
    if engine.writer is not None:
        if exemplars is not None:
            engine.writer.event("request_exemplars", **exemplars)
        engine.writer.event("serving_summary", **summary)
        if "kv_util_mean" in stats:
            engine.writer.event("paged_kv_stats", **{k: stats[k] for k in (
                "page_size", "kv_dtype", "cp", "pages_per_rank",
                "num_pages", "pages_in_use_mean",
                "kv_util_mean", "kv_fragmentation_mean", "prefix_hit_rate",
                "prefix_hit_tokens", "cow_copies", "preemptions",
                "max_live", "max_interleaved_prefill_positions")})
        if "speculate_k" in stats:
            engine.writer.event("spec_decode_stats", **{k: stats[k] for k in (
                "speculate_k", "spec_rounds",
                "accepted_tokens_per_dispatch", "acceptance_rate",
                "acceptance_rate_by_position", "rounds_per_request",
                "drafter_ms_total", "target_ms_total",
                "drafter_num_pages", "drafter_pages_in_use",
                "drafter_page_bytes", "target_page_bytes")})
    return summary


def slo_attainment(engine, done) -> Optional[dict]:
    """Per-deadline-class TTFT attainment: of the requests that COMPLETED
    in each class, the fraction whose TTFT met the class budget (plus the
    class sizes, so 100% of 2 requests reads differently from 100% of
    2000). None for engines without SLO classes (the FIFO slot engine)."""
    classes = getattr(engine.scheduler, "classes", None)
    if not classes:
        return None
    out = {}
    for name, deadline in sorted(classes.items()):
        reqs = [r for r in done if r.slo_class == name]
        if not reqs:
            continue
        hit = sum(1 for r in reqs
                  if r.ttft_s is not None and r.ttft_s <= deadline)
        out[name] = {"deadline_s": deadline, "completed": len(reqs),
                     "attained": round(hit / len(reqs), 4)}
    return out or None


def run_fleet_loadgen(router, requests: List[Request],
                      session_key=None) -> dict:
    """`run_loadgen` over a `router.FleetRouter`: each arrival submits
    through the router (scored dispatch, session affinity keyed by
    `session_key(req)`, the request's tenant by default) and every step
    advances the whole fleet. The summary is the fleet's: throughput sums
    the replicas, the latency percentiles pool every completion,
    `fleet_slo_attainment` folds the replicas' live per-class counters,
    and `per_replica` holds each engine's dispatched, completed and
    prefix-hit numbers, so a skewed router shows in one read. The router's
    dispatch time rides along (`dispatch_ms_p50` / `_p95`)."""
    if session_key is None:
        session_key = lambda r: r.tenant
    pending = sorted(requests, key=lambda r: r.arrival)
    t0 = time.monotonic()
    i = 0
    invalid = 0
    done: List[Request] = []
    while i < len(pending) or router.has_work():
        now = time.monotonic() - t0
        while i < len(pending) and pending[i].arrival <= now:
            try:
                pending[i].submit_t = t0 + pending[i].arrival
                router.submit(pending[i], session=session_key(pending[i]))
            except QueueFull:
                pass  # counted by the router (a fleet-wide refusal)
            except ValueError as e:
                invalid += 1
                print(f"fleet loadgen: request {pending[i].rid} invalid: "
                      f"{e}", file=sys.stderr)
            i += 1
        if router.has_work():
            done.extend(router.step())
        elif i < len(pending):
            wait = pending[i].arrival - (time.monotonic() - t0)
            time.sleep(min(0.05, max(0.0, wait)))
    wall = max(time.monotonic() - t0, 1e-9)
    ms = 1e3
    rstats = router.stats()
    engines = list(router.replicas)
    generated = sum(e.generated_tokens for _, e in engines)
    per_replica = {}
    for name, eng in engines:
        st = eng.stats()
        per_replica[name] = {
            "dispatched": rstats["dispatched"].get(name, 0),
            "completed": st["completed"],
            "generated_tokens": st["generated_tokens"],
            "rejected": st["rejected"],
            "prefix_hit_rate": st.get("prefix_hit_rate", 0.0),
            "preemptions": st.get("preemptions", 0),
            "num_pages": st.get("num_pages"),
            "pages_in_use_mean": st.get("pages_in_use_mean"),
        }
    summary = {
        "requests": len(requests),
        "completed": len(done),
        "rejected": rstats["rejected"],
        "invalid": invalid,
        "wall_s": round(wall, 4),
        "generated_tokens": generated,
        "fleet_tokens_per_sec": round(generated / wall, 2),
        "replicas": rstats["replicas"],
        "dispatch_ms_p50": rstats["dispatch_ms_p50"],
        "dispatch_ms_p95": rstats["dispatch_ms_p95"],
        "session_spills": rstats["spills"],
        "ttft_ms_p50": _pctl([r.ttft_s and r.ttft_s * ms for r in done], 50),
        "ttft_ms_p95": _pctl([r.ttft_s and r.ttft_s * ms for r in done], 95),
        "tpot_ms_p50": _pctl([r.tpot_s and r.tpot_s * ms for r in done], 50),
        "tpot_ms_p95": _pctl([r.tpot_s and r.tpot_s * ms for r in done], 95),
        "queue_wait_ms_p50": _pctl(
            [r.queue_wait_s and r.queue_wait_s * ms for r in done], 50),
        "queue_wait_ms_p95": _pctl(
            [r.queue_wait_s and r.queue_wait_s * ms for r in done], 95),
        "per_replica": per_replica,
    }
    slo_inputs = [{cls: (c[0], c[1]) for cls, c in eng._slo_counts.items()}
                  for _, eng in engines if eng._slo_counts]
    if slo_inputs:
        summary["fleet_slo_attainment"] = fleet_slo_attainment(slo_inputs)
    if router.writer is not None:
        router.writer.event("fleet_serving_summary", **summary)
    return summary
