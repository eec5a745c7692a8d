"""The control plane's ladder (the port's copy of the JAX `obs/control.py`,
its first part): the `--control {off,advise,act}` modes, the safe-point
registration and the `Knob` record.

* `off`    — the plane does not exist: no controller, no events, no record
  fields;
* `advise` — decisions are computed and land in the ledger
  (`controller_decision` events) with `applied: false`; nothing mutates;
* `act`    — decisions queue at proposal time and mutate ONLY inside
  `apply_decisions()`, which callers invoke from a function decorated with
  `@control_safe_point` (the engines' host-side decode tick: the step's
  device work is already on the host, nothing is captured mid-flight).

The JAX module's `RetuneAdvisor` (drift-driven retuning from the duty
profiler's reconciles) is not here: it rides the profilers, which the
port does not have yet.
"""

from __future__ import annotations

from typing import Callable, Optional

CONTROL_MODES = ("off", "advise", "act")
MODE_INDEX = {m: i for i, m in enumerate(CONTROL_MODES)}


def control_safe_point(fn):
    """Mark `fn` as a registered control-plane safe point: a call site
    allowed to invoke `apply_decisions()`. The decoration is the
    registration; identity at runtime (no wrapper: safe points sit on host
    hot paths)."""
    fn.__control_safe_point__ = True
    return fn


class Knob:
    """One tunable the control plane may move: a getter, an optional setter
    (None = an init-boundary knob, whose decisions are recorded but land
    only at the next engine init), and clamp bounds."""

    def __init__(self, name: str, getter: Callable[[], float],
                 setter: Optional[Callable[[float], None]] = None,
                 lo: Optional[float] = None, hi: Optional[float] = None,
                 integer: bool = True):
        self.name = name
        self.getter = getter
        self.setter = setter
        self.lo = lo
        self.hi = hi
        self.integer = integer

    def clamp(self, v: float) -> float:
        if self.lo is not None:
            v = max(self.lo, v)
        if self.hi is not None:
            v = min(self.hi, v)
        return int(round(v)) if self.integer else float(v)
