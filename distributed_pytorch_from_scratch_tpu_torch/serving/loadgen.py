"""Synthetic arrival stream, trace replay and the offline serving benchmark
loop (the port's copy of the JAX `serving/loadgen.py`, without the fleet
loop).

`synthetic_requests` is numpy-only and draws exactly as the JAX version
does, so one seed gives the same requests in both packages;
`replay_requests` reads a captured trace with the JAX schema. `run_loadgen`
drives either engine against the wall clock: a request is submitted once
its arrival offset has elapsed, the engine steps whenever it has live work,
and the loop sleeps only when idle before the next arrival.
"""

from __future__ import annotations

import json
import sys
import time
from typing import List, Optional

import numpy as np

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


def _pctl(vals: List[Optional[float]], q: float) -> Optional[float]:
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


def run_loadgen(engine, requests: List[Request]) -> dict:
    """Drive `engine` through the arrival stream; returns the summary dict
    (percentiles in ms; throughput over the wall window). Backpressure
    (QueueFull) counts as `rejected`, a malformed request as `invalid`;
    neither stops the run."""
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
    att = slo_attainment(engine, done)
    if att is not None:
        summary["slo_attainment"] = att
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
