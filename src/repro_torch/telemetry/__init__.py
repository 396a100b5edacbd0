"""Runtime telemetry: spans, counters and gauges (stdlib only).

A copy of the JAX package's ``telemetry.core``; the span and counter
names match the reference so traces of both read alike.
"""

from repro_torch.telemetry.core import (DEFAULT_MAX_EVENTS, MetricsRegistry,
                                        NOOP_SPAN, Span, Tracer, count,
                                        counter_value, disable, enable, gauge,
                                        get_tracer, is_enabled, reset,
                                        snapshot, span)

__all__ = [
    "DEFAULT_MAX_EVENTS", "MetricsRegistry", "NOOP_SPAN", "Span", "Tracer",
    "count", "counter_value", "disable", "enable", "gauge", "get_tracer",
    "is_enabled", "reset", "snapshot", "span",
]
