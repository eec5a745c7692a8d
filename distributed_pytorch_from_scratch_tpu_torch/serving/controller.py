"""Online SLO/admission controller (the port's copy of the JAX
`serving/controller.py`).

The serving half of the control plane: per-class TTFT attainment and the
pool and queue numbers the telemetry plane exports drive chunk-size,
speculation-K and admission adaptation under shifting traffic. Every
adaptation lands as a `controller_decision` ledger event cross-linked
(`snapshot_seq`) to the telemetry snapshot that triggered it: the
controller emits one `telemetry_snapshot` at decision time, so the trigger
state is IN the stream the ledger's reader follows.

Control discipline: `tick()` only observes and proposes; knobs move
exclusively inside `apply_decisions()`, which the engine invokes from its
`@control_safe_point` decode tick (`PagedEngine._control_tick`: the step's
device work is on the host, nothing is being captured). At tp > 1 the
controller lives on rank 0 with the host loop: a new `prefill_chunk` or
`max_queue` changes only rank 0's decisions, and every dispatch's header
carries the shapes they give, so the other ranks follow; a new
speculation k rides in the speculative dispatches' headers the same way
(`SpeculativeEngine.k`).

The rules, deliberately small and directional:

* attainment < `target` with a deep queue (pending > 2x live) ->
  clamp admission: halve `max_queue` (an unlimited queue clamps to
  half the current depth) — shedding load beats missing every SLO;
* attainment < `target` with a shallow queue -> halve `prefill_chunk`:
  decode interleaves sooner, TTFT head-of-line blocking shrinks;
* attainment >= `recover_target` across the window -> relax: restore
  `max_queue` toward its configured value (x2 per window), then
  `prefill_chunk` toward its configured value;
* speculative acceptance < 0.5 -> K-1 (draft work is being thrown
  away); acceptance > 0.9 -> K+1 (the draft is under-used), up to twice
  the configured K and the largest K the drafter's page rows hold.

Per-knob cooldown (`cooldown` evaluation windows) keeps one shift from
thrashing a knob before its effect is measurable.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

from ..obs.control import MODE_INDEX, CONTROL_MODES


def _pctl_ms(vals: List[Optional[float]], q: float) -> Optional[float]:
    vals = sorted(v for v in vals if v is not None)
    if not vals:
        return None
    i = min(len(vals) - 1, int(round(q / 100.0 * (len(vals) - 1))))
    return round(vals[i] * 1e3, 3)


class SLOController:
    """Observe-propose-actuate over a live PagedEngine. `tick(step)` is
    called once per decode step from the engine's safe point; it
    evaluates every `interval` steps and queues decisions; the engine
    then calls `apply_decisions()` (act mode) from the same decorated
    safe point."""

    def __init__(self, engine, mode: str, writer=None, telemetry=None,
                 interval: int = 32, target: float = 0.90,
                 recover_target: float = 0.98, min_completed: int = 4,
                 cooldown: int = 2, clock=time.monotonic):
        if mode not in CONTROL_MODES:
            raise ValueError(f"control mode must be one of "
                             f"{CONTROL_MODES}, got {mode!r}")
        if interval < 1:
            raise ValueError(f"control interval must be >= 1, got "
                             f"{interval}")
        self.engine = engine
        self.mode = mode
        self.writer = writer
        self.telemetry = telemetry
        self.interval = interval
        self.target = target
        self.recover_target = recover_target
        self.min_completed = min_completed
        self.cooldown = cooldown
        self.clock = clock
        self.decisions: List[dict] = []
        self._pending: List[dict] = []
        self._cool: Dict[str, int] = {}
        self._done_seen = 0
        self._seq = 0
        self._t_start = clock()
        self._first_applied_t: Optional[float] = None
        # the configured values are the recovery ceiling: the controller
        # degrades under pressure and restores toward them, never past
        self._init_prefill = int(getattr(engine, "prefill_chunk", 1))
        self._init_max_queue = int(getattr(engine.scheduler, "max_queue",
                                           0))
        self._init_k = int(getattr(engine, "k", 0))
        if telemetry is not None and mode != "off":
            telemetry.gauge("ctl/mode", MODE_INDEX[mode])

    # -- observe + propose ---------------------------------------------
    def tick(self, step: int) -> None:
        if self.mode == "off" or step == 0 or step % self.interval:
            return
        for k in list(self._cool):
            self._cool[k] -= 1
            if self._cool[k] <= 0:
                del self._cool[k]
        done = self.engine.completed
        window = done[self._done_seen:]
        self._done_seen = len(done)
        pending = self.engine.scheduler.pending
        live = len(self.engine._slot_req)
        att = self._attainment(window)
        evidence = {"step": step, "queue_depth": pending, "live": live,
                    "window_completed": len(window),
                    "attainment": att}
        worst = min((c["attained"] for c in att.values()), default=None) \
            if att else None
        if worst is not None and len(window) >= self.min_completed:
            if worst < self.target:
                if pending > max(2 * live, 4):
                    self._propose_admission_clamp(pending, evidence)
                else:
                    self._propose("prefill_chunk", "slo_miss_ttft",
                                  lambda old: max(1, old // 2), evidence)
            elif worst >= self.recover_target:
                self._propose_recovery(evidence)
        self._propose_speculation(evidence)

    def _attainment(self, window) -> dict:
        classes = getattr(self.engine.scheduler, "classes", None) or {}
        out = {}
        for name, deadline in sorted(classes.items()):
            reqs = [r for r in window if r.slo_class == name]
            if not reqs:
                continue
            hit = sum(1 for r in reqs
                      if r.ttft_s is not None and r.ttft_s <= deadline)
            out[name] = {"completed": len(reqs),
                         "attained": round(hit / len(reqs), 4)}
        return out

    def _propose_admission_clamp(self, pending: int, evidence: dict):
        def clamp(old):
            return max(2, (pending if old == 0 else old) // 2)
        self._propose("max_queue", "slo_miss_queue", clamp, evidence)

    def _propose_recovery(self, evidence: dict):
        mq = self.engine.scheduler.max_queue
        if mq != self._init_max_queue and mq != 0:
            def relax(old):
                new = old * 2
                # doubling past the configured value restores it exactly
                # (0 = unlimited has no "past": any clamp restores to 0)
                if self._init_max_queue == 0 \
                        or new >= self._init_max_queue:
                    return self._init_max_queue
                return new
            self._propose("max_queue", "recovered", relax, evidence)
        elif self.engine.prefill_chunk < self._init_prefill:
            self._propose("prefill_chunk", "recovered",
                          lambda old: min(self._init_prefill, old * 2),
                          evidence)

    def _propose_speculation(self, evidence: dict):
        if not hasattr(self.engine, "k"):
            return
        stats = self.engine.stats()
        acc = stats.get("acceptance_rate")
        if acc is None or not stats.get("spec_rounds"):
            return
        ev = dict(evidence, acceptance_rate=acc)
        if acc < 0.5:
            self._propose("speculate_k", "spec_acceptance_low",
                          lambda old: max(1, old - 1), ev)
        elif acc > 0.9:
            top = min(self._init_k * 2, self.engine.k_max)
            self._propose("speculate_k", "spec_acceptance_high",
                          lambda old: min(top, old + 1), ev)

    # -- the ledger ----------------------------------------------------
    def _get(self, knob: str) -> int:
        if knob == "max_queue":
            return int(self.engine.scheduler.max_queue)
        return int(getattr(self.engine, {"prefill_chunk": "prefill_chunk",
                                         "speculate_k": "k"}[knob]))

    def _set(self, knob: str, value: int) -> None:
        if knob == "max_queue":
            self.engine.scheduler.max_queue = int(value)
        elif knob == "prefill_chunk":
            self.engine.prefill_chunk = int(value)
        else:
            self.engine.k = int(value)

    def _propose(self, knob: str, trigger: str, fn, evidence: dict):
        if knob in self._cool:
            return
        old = self._get(knob)
        new = int(fn(old))
        if new == old:
            return
        self._cool[knob] = self.cooldown
        self._seq += 1
        # the triggering telemetry snapshot lands IN the stream now, so
        # the ledger's cross-link resolves post-hoc (seq = how many
        # snapshot events this process has emitted, 1-based)
        snap_seq = (self.telemetry.emit_snapshot()
                    if self.telemetry is not None else 0)
        d = {"knob": knob, "old": old, "new": new, "trigger": trigger,
             "evidence": evidence, "mode": self.mode, "seq": self._seq,
             "snapshot_seq": snap_seq, "t": round(self.clock(), 4)}
        if self.mode == "act":
            self._pending.append(d)
        else:
            d["applied"] = False
            self._emit(d)

    def _emit(self, d: dict) -> None:
        self.decisions.append(d)
        if self.writer is not None:
            self.writer.event("controller_decision", **d)
        if self.telemetry is not None:
            self.telemetry.gauge("ctl/decisions", len(self.decisions))
        print(f"controller[{self.mode}]: {d['knob']} {d['old']} -> "
              f"{d['new']} ({d['trigger']}"
              + ("" if d["applied"] else "; not applied") + ")",
              file=sys.stderr)

    def apply_decisions(self) -> int:
        """Actuate queued act-mode decisions. Called only from a
        `@control_safe_point` function."""
        applied = 0
        while self._pending:
            d = self._pending.pop(0)
            self._set(d["knob"], d["new"])
            d["applied"] = True
            d["t"] = round(self.clock(), 4)
            if self._first_applied_t is None:
                self._first_applied_t = self.clock()
            applied += 1
            self._emit(d)
        return applied

    def close(self) -> None:
        while self._pending:
            d = self._pending.pop(0)
            d["applied"] = False
            d["note"] = "unapplied at run end (no safe point reached)"
            self._emit(d)

    # -- the measured effect --------------------------------------------
    def windows(self, done=None) -> Optional[dict]:
        """Pre- vs post-first-actuation windows over the completed
        requests: the measured effect of the first actuation. None until a
        decision has actually been applied."""
        if self._first_applied_t is None:
            return None
        done = self.engine.completed if done is None else done
        t1 = self._first_applied_t

        def metrics(reqs, t_lo, t_hi):
            dur = max(t_hi - t_lo, 1e-9)
            toks = sum(len(r.tokens) for r in reqs)
            return {"completed": len(reqs), "generated_tokens": toks,
                    "tokens_per_sec": round(toks / dur, 2),
                    "wall_s": round(dur, 4),
                    "ttft_ms_p95": _pctl_ms([r.ttft_s for r in reqs], 95),
                    "tpot_ms_p95": _pctl_ms([r.tpot_s for r in reqs], 95)}

        fin = [r for r in done if r.finish_t is not None]
        pre = [r for r in fin if r.finish_t <= t1]
        post = [r for r in fin if r.finish_t > t1]
        t_end = max((r.finish_t for r in fin), default=self.clock())
        return {"pre": metrics(pre, self._t_start, t1),
                "post": metrics(post, t1, t_end)}

    def summary(self) -> dict:
        last = self.decisions[-1] if self.decisions else None
        out = {"mode": self.mode, "decisions": len(self.decisions),
               "applied": sum(1 for d in self.decisions if d["applied"]),
               "last_knob": last["knob"] if last else None}
        w = self.windows()
        if w is not None:
            out["windows"] = w
        return out
