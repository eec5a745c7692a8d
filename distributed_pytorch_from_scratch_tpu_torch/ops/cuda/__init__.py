"""The port's hand-written CUDA kernels, their plain versions and wrappers.

`counter_lock` guards the paged-attention wrapper's increments and
`add_to_counters`: the disaggregated prefill thread launches K3 beside the
decode loop's graph replays, and an increment lost between them would
break the exact counts."""

import threading

counter_lock = threading.Lock()


def _counters() -> list:
    """(wrapper, attribute) of every launch counter: an int, or a dict of
    ints (by route or by C entry point)."""
    from .block_attention import block_attention_bwd, block_attention_fwd
    from .flash_attention import flash_attention_bwd, flash_attention_fwd
    from .paged_attention import paged_attention
    return [(flash_attention_fwd, "launches"),
            (flash_attention_bwd, "launches_dq"),
            (flash_attention_bwd, "launches_dkv"),
            (paged_attention, "launches"),
            (paged_attention, "launches_by_route"),
            (paged_attention, "launches_by_kernel"),
            (block_attention_fwd, "launches"),
            (block_attention_bwd, "launches_dq"),
            (block_attention_bwd, "launches_dkv")]


def launch_counts() -> dict:
    """Every kernel wrapper's launch count so far in this process, by kernel
    name (the names of chip_smoke.py's kernels line)."""
    from .block_attention import block_attention_bwd, block_attention_fwd
    from .flash_attention import flash_attention_bwd, flash_attention_fwd
    from .paged_attention import paged_attention
    return {"flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_bwd_dq": flash_attention_bwd.launches_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd.launches_dkv,
            "paged_attention": paged_attention.launches,
            "block_attention_fwd": block_attention_fwd.launches,
            "block_attention_bwd_dq": block_attention_bwd.launches_dq,
            "block_attention_bwd_dkv": block_attention_bwd.launches_dkv}


def counter_state() -> list:
    """A copy of every launch counter, in `_counters` order."""
    return [dict(v) if isinstance(v, dict) else v
            for v in (getattr(fn, attr) for fn, attr in _counters())]


def set_counters(state: list) -> None:
    """Put every launch counter back to `state` (a `counter_state`)."""
    for (fn, attr), v in zip(_counters(), state):
        setattr(fn, attr, dict(v) if isinstance(v, dict) else v)


def counter_delta(after: list, before: list) -> list:
    """What the counters rose by from `before` to `after`."""
    return [{k: n - b.get(k, 0) for k, n in a.items()}
            if isinstance(a, dict) else a - b
            for a, b in zip(after, before)]


def add_to_counters(delta: list, times: int = 1) -> None:
    """Raise every launch counter by `times` x `delta` (a `counter_delta`),
    in the counters that are current (a dict counter replaced since the
    delta was taken is updated, not put back)."""
    with counter_lock:
        for (fn, attr), d in zip(_counters(), delta):
            if isinstance(d, dict):
                cur = getattr(fn, attr)
                for k, n in d.items():
                    cur[k] = cur.get(k, 0) + times * n
            else:
                setattr(fn, attr, getattr(fn, attr) + times * d)
