"""Observability: metrics, tracing, logging, the device-cost ledger and
the flight recorder (``pilosa_tpu.obs``'s)."""

from pilosa_tpu_torch.obs.flight import (NULL_FLIGHT, FlightRecorder,
                                         NullFlightRecorder)
from pilosa_tpu_torch.obs.ledger import NULL_LEDGER, CostLedger, NullLedger
from pilosa_tpu_torch.obs.logging import get_logger
from pilosa_tpu_torch.obs.metrics import (NopStats, StageTimer, Stats,
                                          StatsdStats)
from pilosa_tpu_torch.obs.tracing import (GLOBAL_TRACER, NULL_TRACER,
                                          LiteTracer, NullTracer,
                                          SlowQueryLog, Tracer,
                                          fast_span_id, fast_trace_id,
                                          parse_traceparent)

__all__ = ["Stats", "NopStats", "StageTimer", "StatsdStats",
           "get_logger", "Tracer", "GLOBAL_TRACER", "SlowQueryLog",
           "LiteTracer", "NullTracer", "NULL_TRACER",
           "fast_trace_id", "fast_span_id", "parse_traceparent",
           "FlightRecorder", "NullFlightRecorder", "NULL_FLIGHT",
           "CostLedger", "NullLedger", "NULL_LEDGER"]
