"""Observability for the port: request tracing (:mod:`.trace`) and the
per-shard flight recorder (:mod:`.recorder`), carried over from the
reference package.  The cross-process plane (``fleetscope``, ``slo``)
is not carried yet."""
from .recorder import FlightRecorder
from .trace import UNSAMPLED, Tracer

__all__ = ["FlightRecorder", "Tracer", "UNSAMPLED"]
