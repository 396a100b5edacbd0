"""Zero-dependency runtime telemetry: spans, counters, and gauges.

DreamShard's pitch is cost transparency, so the stack instruments its
own hot paths the same way: every oracle query, search round, bucket
decode, and trainer stage can emit a wall-clock **span** (nested,
thread-aware) and bump **counters**/**gauges** in a process-global
``MetricsRegistry``.  The subsystem is stdlib-only and *disabled by
default*: with no tracer installed, ``span()`` returns a shared no-op
context manager and ``count()``/``gauge()`` early-out after one global
read -- the off path is a boolean check plus (for spans) one kwargs
dict.  Span and counter names are those of the JAX reference package
(``session.decode``, ``session.bucket_compiles``, ...), so one trace
reader serves both.

Usage::

    from repro_torch import telemetry as tele

    tele.enable()
    with tele.span("search.round", strategy="lns") as sp:
        ...
        sp.set(incumbent_ms=12.5)       # attrs may be added mid-span
    tele.count("oracle.cache.hits", 3)
    tele.snapshot()                      # counters + gauges + span aggs
"""

from __future__ import annotations

import itertools
import threading
import time

# spans kept in memory before the tracer starts dropping (long-running
# services must export + reset periodically; ``dropped`` reports losses)
DEFAULT_MAX_EVENTS = 1_000_000


class MetricsRegistry:
    """Process-global monotonic counters and last-value gauges.

    One lock serializes writers, so concurrent ``count`` calls from
    worker threads never lose increments.  Reads (``snapshot``) copy under the
    same lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}

    def count(self, name: str, value=1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict:
        with self._lock:
            return dict(self._gauges)

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


class Span:
    """One live wall-clock span; records itself on ``__exit__``.

    ``set(**attrs)`` merges attributes any time before exit -- round
    spans use it to attach results (incumbent cost, rows scored) that
    only exist once the round ran.
    """

    __slots__ = ("_tracer", "name", "args", "id", "parent", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.id = next(tracer._ids)
        self.parent = None
        self._t0 = 0.0

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record(self, self._t0, t1)
        return False


class _NoopSpan:
    """The disabled-path singleton: enter/exit/set all do nothing."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Thread-safe span recorder.

    Spans nest per thread (a ``threading.local`` stack provides the
    parent id) and finished spans are appended to one bounded in-memory
    event list as ``(name, ts_us, dur_us, tid, span_id, parent_id,
    args)`` tuples -- microseconds since the tracer's epoch, the unit
    Chrome's ``trace_event`` format wants natively.
    """

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self.max_events = max_events
        self.epoch = time.perf_counter()
        self.epoch_unix = time.time()
        self.events: list[tuple] = []
        self.dropped = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: dict[int, int] = {}

    def span(self, name: str, args: dict) -> Span:
        return Span(self, name, args)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _tid(self) -> int:
        """Small stable per-thread id (0 = the first thread seen)."""
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _record(self, span: Span, t0: float, t1: float) -> None:
        event = (span.name,
                 (t0 - self.epoch) * 1e6,       # ts (us)
                 (t1 - t0) * 1e6,               # dur (us)
                 self._tid(), span.id, span.parent, span.args)
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
            else:
                self.events.append(event)

    def snapshot_events(self) -> list[tuple]:
        with self._lock:
            return list(self.events)

    def span_aggregates(self) -> dict:
        """Per-name ``{count, total_ms, max_ms}`` over recorded spans."""
        aggs: dict[str, dict] = {}
        for name, _ts, dur, *_rest in self.snapshot_events():
            a = aggs.get(name)
            if a is None:
                a = aggs[name] = {"count": 0, "total_ms": 0.0, "max_ms": 0.0}
            a["count"] += 1
            a["total_ms"] += dur / 1e3
            a["max_ms"] = max(a["max_ms"], dur / 1e3)
        for a in aggs.values():
            a["total_ms"] = round(a["total_ms"], 6)
            a["max_ms"] = round(a["max_ms"], 6)
        return aggs

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0


# ---- module-global state -----------------------------------------------------

# ONE registry for the process (survives enable/disable cycles so a
# snapshot taken after disable still sees the run's counters) and an
# optional tracer; ``_TRACER is None`` IS the disabled fast path.
_REGISTRY = MetricsRegistry()
_TRACER: Tracer | None = None


def enable(max_events: int = DEFAULT_MAX_EVENTS) -> Tracer:
    """Install the process tracer (idempotent); returns it."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer(max_events=max_events)
    return _TRACER


def disable() -> None:
    """Remove the tracer: instrumentation reverts to the no-op path.

    Recorded events and counters are kept (export-after-run works);
    ``reset()`` clears them.
    """
    global _TRACER
    _TRACER = None


def is_enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Tracer | None:
    return _TRACER


def span(name: str, /, **attrs):
    """A wall-clock span context manager (no-op singleton when off).

    ``name`` is positional-only so an attribute may itself be called
    ``name`` without colliding."""
    tracer = _TRACER
    if tracer is None:
        return NOOP_SPAN
    return Span(tracer, name, attrs)


def count(name: str, value=1) -> None:
    """Bump a monotonic counter (no-op when telemetry is off)."""
    if _TRACER is None:
        return
    _REGISTRY.count(name, value)


def gauge(name: str, value) -> None:
    """Set a last-value gauge (no-op when telemetry is off)."""
    if _TRACER is None:
        return
    _REGISTRY.gauge(name, value)


def counter_value(name: str, default=0):
    """Current value of one counter (0 when never bumped)."""
    return _REGISTRY.counters().get(name, default)


def snapshot() -> dict:
    """The unified introspection surface: counters, gauges, and span
    aggregates in one dict (the ``CachedOracle.info()``-style views now
    all live here)."""
    tracer = _TRACER
    return {
        "enabled": tracer is not None,
        "counters": _REGISTRY.counters(),
        "gauges": _REGISTRY.gauges(),
        "spans": tracer.span_aggregates() if tracer is not None else {},
        "dropped_events": tracer.dropped if tracer is not None else 0,
    }


def reset() -> None:
    """Clear counters, gauges, and recorded spans (keeps enabled state)."""
    _REGISTRY.clear()
    if _TRACER is not None:
        _TRACER.clear()
