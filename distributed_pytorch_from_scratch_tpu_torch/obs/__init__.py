"""Observability for serving (the port of the serving half of the JAX
`obs` package): the event schema, the host-span tracer, per-request
timelines across processes, the anomaly flight recorder, the live
telemetry exporter and the control plane's ladder. The training half (the
sentinel, watchdog and observer, the profilers and their parser, the
retune advisor) and the forensics tools are not ported yet (ROADMAP)."""

from .control import CONTROL_MODES, MODE_INDEX, Knob, control_safe_point
from .flight import FlightRecorder
from .reqtrace import RequestTracer, TraceContext, merge_traces
from .schema import (EVENT_REQUIRED, EVENT_SCHEMA_VERSION, validate_jsonl,
                     validate_record)
from .telemetry import (TelemetryExporter, fleet_slo_attainment,
                        prometheus_name)
from .trace import SpanTracer

__all__ = [
    "CONTROL_MODES", "EVENT_REQUIRED", "EVENT_SCHEMA_VERSION",
    "FlightRecorder", "Knob", "MODE_INDEX", "RequestTracer", "SpanTracer",
    "TelemetryExporter", "TraceContext", "control_safe_point",
    "fleet_slo_attainment", "merge_traces", "prometheus_name",
    "validate_jsonl", "validate_record",
]
