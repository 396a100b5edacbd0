"""Runtime telemetry: spans, counters and gauges (stdlib only), and their
sinks.

A copy of the JAX package's ``telemetry``; the span and counter names
match the reference, and a Chrome trace or JSONL event log written by
either package loads with the other's ``load_trace``.
"""

from repro_torch.telemetry.core import (DEFAULT_MAX_EVENTS, MetricsRegistry,
                                        NOOP_SPAN, Span, Tracer, count,
                                        counter_value, disable, enable, gauge,
                                        get_tracer, is_enabled, reset,
                                        snapshot, span)
from repro_torch.telemetry.sinks import (load_trace, read_chrome_trace,
                                         read_jsonl, summarize, trace_to,
                                         write_chrome_trace, write_jsonl)

__all__ = [
    "DEFAULT_MAX_EVENTS", "MetricsRegistry", "NOOP_SPAN", "Span", "Tracer",
    "count", "counter_value", "disable", "enable", "gauge", "get_tracer",
    "is_enabled", "load_trace", "read_chrome_trace", "read_jsonl", "reset",
    "snapshot", "span", "summarize", "trace_to", "write_chrome_trace",
    "write_jsonl",
]
