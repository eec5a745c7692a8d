"""The metrics stream's event schema: the port's copy of the JAX
`obs/schema.py`, so either package's readers take the other's files.

Every `MetricsWriter.event(...)` record carries `schema_version`, and
`EVENT_REQUIRED` maps each event tag to the fields a consumer may key on.
A consumer validates a stream (`validate_jsonl`) before it renders it, so
a producer that drifted (a renamed field, a tag written without its
contract) fails loudly. Dependency-free: `training/metrics.py` takes its
version from here.

The versions: 1, any record from before versioning; 2, versioned events
and the request-trace / flight / skew family; 3, the live-telemetry
family (`telemetry_snapshot`, `fleet_rollup`, `rotated`) and the
cross-process `request_trace` fields (`process`, `t0_wall`,
`clock_offset_ms`); 4, the measured-attribution family
(`profile_attribution`, `hbm_watermark`); 5, the decision ledger
(`tuning_decision`, `controller_decision`); 6, the run-forensics family
(`run_card`, `run_diff`); 7, `reshard_event`.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

EVENT_SCHEMA_VERSION = 7

# tag -> fields a consumer may key on (presence contract, not types).
# Only EVENT tags appear here — scalar ({"tag", "value", "step"}) and text
# records are TensorBoard-shaped and stay unversioned.
EVENT_REQUIRED: Dict[str, Tuple[str, ...]] = {
    "goodput_summary": ("wall_s", "buckets_s", "goodput", "steps"),
    "cost_analysis": ("flops",),
    "serving_summary": ("requests", "completed", "tokens_per_sec"),
    "paged_kv_stats": ("page_size", "num_pages", "kv_util_mean"),
    "spec_decode_stats": ("speculate_k", "spec_rounds"),
    "serve_request": ("rid", "generated"),
    # -- the request-scoped / rank-scoped family -------------------------
    "request_trace": ("rid", "trace_id", "spans", "total_ms"),
    "request_exemplars": ("k", "worst_ttft", "worst_tpot"),
    "rank_phase_stats": ("process", "phases_s", "steps"),
    "sentinel/nonfinite": ("reason",),
    "watchdog/stall": ("process", "stalled_for"),
    # -- the live-telemetry family ---------------------------------------
    # periodic exporter registry mirror (obs/telemetry.py); the fleet
    # collector keys on both maps and the producing process index
    "telemetry_snapshot": ("gauges", "counters", "process"),
    # fleet-level aggregation (obs/collector.py); consumers key on the
    # proc count and the cross-proc attainment map
    "fleet_rollup": ("procs", "slo_attainment"),
    # size-based MetricsWriter rotation: the LAST record of a rotated-out
    # file names its continuation; tailers follow `next`
    "rotated": ("next",),
    # -- the measured-attribution family ---------------------------------
    # one parsed jax.profiler capture (training/metrics.py sampler paths
    # via obs/profparse): consumers key on the capture dir, what armed it
    # (duty / anomaly:<tag> / breakdown), and the measured phase-ms map
    # (empty + `error` when the capture failed to parse — still an event,
    # never a silent drop)
    "profile_attribution": ("capture", "trigger", "phases"),
    # live HBM watermark snapshot: `devices` is the per-device
    # memory_stats list, EMPTY with available=false on a statless
    # backend — the silent-zero fix exports 'unavailable' loudly instead
    # of a fake 0-byte watermark
    "hbm_watermark": ("devices", "available"),
    # -- the control-plane / decision-ledger family ----------------------
    # one RetuneAdvisor proposal (obs/control.py): which knob, old->new,
    # the evidence that justified it (per-phase drift ms, HBM headroom,
    # capture id), whether the run was allowed to act on it, and whether
    # it actually did (applied=false under --control advise)
    "tuning_decision": ("knob", "old", "new", "evidence", "mode",
                        "applied"),
    # one online SLO/admission adaptation (serving/controller.py):
    # cross-linked to the telemetry snapshot that triggered it via
    # `snapshot_seq`, so the ledger can replay trigger -> action
    "controller_decision": ("knob", "old", "new", "trigger", "mode",
                            "applied", "snapshot_seq"),
    # -- the run-forensics family ----------------------------------------
    # one normalized run from the archive index (obs/runindex.py):
    # consumers key on which run it is, what shape it came from
    # (bench / multichip / session), and the outage classification —
    # `outage` true means the card can NEVER be a baseline, and
    # baseline_eligible makes that machine-checkable
    "run_card": ("run", "kind", "outage", "baseline_eligible"),
    # one pairwise forensic report (obs/rundiff.py): the config delta
    # joined to its measured consequences, with the ranked suspects list
    "run_diff": ("run_a", "run_b", "config_delta", "suspects"),
    # -- the elastic-reshard family --------------------------------------
    # one layout redistribution (reshard/): the source and target layout
    # signatures, the bytes the plan actually moved, the per-op schedule
    # counts, and the wall time — forensics joins this into run lineage
    # ("this run's params came from THAT layout")
    "reshard_event": ("src_layout", "dst_layout", "bytes_moved",
                      "plan_ops", "wall_ms"),
}


def is_event_record(rec: dict) -> bool:
    """Structured event vs a scalar/text record: events have a tag but
    neither a scalar `value` nor a `text` payload."""
    return ("tag" in rec and "value" not in rec and "text" not in rec)


def validate_record(rec: dict) -> List[str]:
    """Problems with one parsed record (empty list = fine). Scalar/text
    records always pass; unknown event tags only need a sane version."""
    if not isinstance(rec, dict):
        return ["record is not a JSON object"]
    if "tag" not in rec:
        return ["record has no 'tag'"]
    if not is_event_record(rec):
        return []
    tag = rec["tag"]
    problems = []
    v = rec.get("schema_version")
    if v is None:
        problems.append(f"{tag}: missing schema_version (pre-v"
                        f"{EVENT_SCHEMA_VERSION} writer? regenerate, or "
                        f"treat fields as best-effort)")
    elif not isinstance(v, int) or v < 1:
        problems.append(f"{tag}: schema_version {v!r} is not a positive int")
    elif v > EVENT_SCHEMA_VERSION:
        problems.append(f"{tag}: schema_version {v} is NEWER than this "
                        f"reader ({EVENT_SCHEMA_VERSION}) — update the "
                        f"consumer before trusting its rendering")
    for field in EVENT_REQUIRED.get(tag, ()):
        if field not in rec:
            problems.append(f"{tag}: missing required field {field!r}")
    return problems


def validate_jsonl(path: str, max_problems: int = 20) -> List[str]:
    """Validate every line of a metrics*.jsonl file; returns problem
    strings prefixed with the line number (capped at `max_problems` so a
    wholly drifted file does not flood the summary)."""
    problems: List[str] = []
    with open(path, errors="replace") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                problems.append(f"line {lineno}: unparseable JSON")
                continue
            problems.extend(f"line {lineno}: {p}"
                            for p in validate_record(rec))
            if len(problems) >= max_problems:
                problems.append(f"... (stopped at {max_problems} problems)")
                return problems
    return problems
