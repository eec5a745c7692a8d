"""Synthetic arrival stream + offline serving benchmark loop (the port's
copy of the slot-engine part of the JAX `serving/loadgen.py`).

`synthetic_requests` is numpy-only and draws exactly as the JAX version
does, so one seed gives the same requests in both packages. `run_loadgen`
drives the engine against the wall clock: a request is submitted once its
arrival offset has elapsed, the engine steps whenever it has live work, and
the loop sleeps only when idle before the next arrival.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np

from .engine import ContinuousBatchingEngine, Request
from .scheduler import QueueFull


def synthetic_requests(num: int, prompt_len_min: int, prompt_len_max: int,
                       max_new: int, vocab_size: int, seed: int = 0,
                       rate: float = 4.0, arrival: str = "poisson"
                       ) -> List[Request]:
    """`num` requests with random-id prompts and arrival offsets (seconds
    from t=0, sorted). Token ids avoid 0/1/2 (the BOS/EOS/UNK convention)
    so a random prompt cannot start with a spurious EOS. `poisson`: gaps
    exponential at `rate` req/s; `burst`: everything at t=0."""
    if arrival not in ("poisson", "burst"):
        raise ValueError(f"arrival must be poisson|burst, got {arrival!r}")
    if not 3 <= prompt_len_min <= prompt_len_max:
        raise ValueError(f"need 3 <= prompt_len_min <= prompt_len_max, got "
                         f"[{prompt_len_min}, {prompt_len_max}]")
    rng = np.random.default_rng(seed)
    if arrival == "burst":
        at = np.zeros(num)
    else:
        if rate <= 0:
            raise ValueError(f"poisson arrivals need rate > 0, got {rate}")
        at = np.cumsum(rng.exponential(1.0 / rate, size=num))
    out = []
    for i in range(num):
        plen = int(rng.integers(prompt_len_min, prompt_len_max + 1))
        prompt = [int(t) for t in rng.integers(3, vocab_size, size=plen)]
        out.append(Request(rid=i, prompt=prompt, max_new=max_new,
                           seed=seed + i, arrival=float(at[i])))
    return out


def _pctl(vals: List[Optional[float]], q: float) -> Optional[float]:
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, np.float64), q))


def run_loadgen(engine: ContinuousBatchingEngine,
                requests: List[Request]) -> dict:
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
    return {
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
