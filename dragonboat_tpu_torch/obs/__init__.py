"""Observability: end-to-end request tracing + per-shard flight
recorder (docs/OBSERVABILITY.md).

* :mod:`.trace` — the span model threaded through the proposal/read
  path with trace context carried in wire messages, plus the
  Chrome/Perfetto ``trace_event`` exporter;
* :mod:`.recorder` — the per-shard flight recorder ring buffers,
  dumped on demand (``NodeHost.dump_timeline``) and automatically when
  ``assert_recovery_sla`` trips, an audit gate fails, or the gateway
  sheds sustainedly (``gateway/admission.py``: overload is a state
  transition too — the moment the front door starts refusing work
  there must be a cross-host record of why).

* :mod:`.fleetscope` — the cross-process telemetry plane: the
  ``RPC_OP_OBS`` server side plus the :class:`FleetScope` collector
  merging every fleet process's recorder/span tails into one timeline;
* :mod:`.slo` — declarative objectives evaluated from fleet metric
  deltas into burn-rate rows (``FleetScope.slo_report``).

Both are off by default (``NodeHostConfig.enable_tracing`` /
``enable_flight_recorder``); the disabled hot paths cost one attribute
load.
"""
from .fleetscope import FleetScope, ObsService, ObsUnsupported
from .recorder import (
    FlightRecorder,
    attach_timeline,
    format_timeline,
    hosts_timeline,
    merged_timeline,
    record_all,
)
from .slo import DEFAULT_OBJECTIVES, Objective, evaluate as evaluate_slo
from .trace import (
    Span,
    Tracer,
    UNSAMPLED,
    export_merged_json,
    spans_to_trace_events,
    stitched_traces,
)

__all__ = [
    "DEFAULT_OBJECTIVES",
    "FleetScope",
    "FlightRecorder",
    "Objective",
    "ObsService",
    "ObsUnsupported",
    "Span",
    "Tracer",
    "UNSAMPLED",
    "attach_timeline",
    "evaluate_slo",
    "export_merged_json",
    "format_timeline",
    "hosts_timeline",
    "merged_timeline",
    "record_all",
    "spans_to_trace_events",
    "stitched_traces",
]
