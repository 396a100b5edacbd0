"""Telemetry sinks: Chrome ``trace_event`` JSON, JSONL, text summary.

Three ways out of the in-memory tracer:

* ``write_chrome_trace(path)`` -- the Trace Event Format (``ph: "X"``
  complete events, microsecond timestamps) that ``chrome://tracing``
  and Perfetto load directly; span attributes land in ``args``;
* ``write_jsonl(path)`` / ``read_jsonl(path)`` -- a structured
  line-per-record event log (spans + final counter/gauge values) that
  round-trips losslessly;
* ``summarize(...)`` -- the plain-text per-span-name table behind
  ``python -m repro_torch.telemetry.report``.

``trace_to(path)`` is the one-liner CLI integration: a context manager
that enables telemetry, runs the body, and exports on exit (``.jsonl``
suffix selects the JSONL sink, anything else the Chrome sink).
"""

from __future__ import annotations

import contextlib
import json
import os

from repro_torch.telemetry import core

JSONL_SCHEMA = 1


def _chrome_payload(tracer: core.Tracer) -> dict:
    events = []
    for name, ts, dur, tid, sid, parent, args in tracer.snapshot_events():
        events.append({
            "name": name, "cat": "repro", "ph": "X",
            "ts": round(ts, 3), "dur": round(dur, 3),
            "pid": os.getpid(), "tid": tid,
            "args": {**args, "span_id": sid, "parent_id": parent},
        })
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "repro_torch.telemetry",
            "counters": core._REGISTRY.counters(),
            "gauges": core._REGISTRY.gauges(),
            "dropped_events": tracer.dropped,
        },
    }


def write_chrome_trace(path: str, tracer: core.Tracer | None = None) -> str:
    """Export recorded spans as Chrome/Perfetto trace JSON."""
    tracer = tracer if tracer is not None else core.get_tracer()
    if tracer is None:
        raise RuntimeError("telemetry is not enabled; nothing to export")
    with open(path, "w") as f:
        json.dump(_chrome_payload(tracer), f, indent=1, default=str)
        f.write("\n")
    return path


def write_jsonl(path: str, tracer: core.Tracer | None = None) -> str:
    """Export spans + counters + gauges as one JSON object per line."""
    tracer = tracer if tracer is not None else core.get_tracer()
    if tracer is None:
        raise RuntimeError("telemetry is not enabled; nothing to export")
    with open(path, "w") as f:
        meta = {"type": "meta", "schema": JSONL_SCHEMA,
                "epoch_unix": tracer.epoch_unix, "pid": os.getpid(),
                "dropped_events": tracer.dropped}
        f.write(json.dumps(meta, default=str) + "\n")
        for name, ts, dur, tid, sid, parent, args in tracer.snapshot_events():
            rec = {"type": "span", "name": name, "ts_us": round(ts, 3),
                   "dur_us": round(dur, 3), "tid": tid, "id": sid,
                   "parent": parent, "args": args}
            f.write(json.dumps(rec, default=str) + "\n")
        for name, value in sorted(core._REGISTRY.counters().items()):
            f.write(json.dumps({"type": "counter", "name": name,
                                "value": value}) + "\n")
        for name, value in sorted(core._REGISTRY.gauges().items()):
            f.write(json.dumps({"type": "gauge", "name": name,
                                "value": value}, default=str) + "\n")
    return path


def read_jsonl(path: str) -> dict:
    """Parse a JSONL event log back into
    ``{meta, spans: [..], counters: {..}, gauges: {..}}``."""
    out = {"meta": {}, "spans": [], "counters": {}, "gauges": {}}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("type")
            if kind == "span":
                out["spans"].append(rec)
            elif kind == "counter":
                out["counters"][rec["name"]] = rec["value"]
            elif kind == "gauge":
                out["gauges"][rec["name"]] = rec["value"]
            elif kind == "meta":
                out["meta"] = rec
    return out


def read_chrome_trace(path: str) -> dict:
    """Parse a Chrome trace JSON into the same shape as ``read_jsonl``."""
    with open(path) as f:
        payload = json.load(f)
    other = payload.get("otherData", {})
    spans = [{"type": "span", "name": e["name"], "ts_us": e["ts"],
              "dur_us": e["dur"], "tid": e.get("tid", 0),
              "id": e.get("args", {}).get("span_id"),
              "parent": e.get("args", {}).get("parent_id"),
              "args": e.get("args", {})}
             for e in payload.get("traceEvents", [])
             if e.get("ph") == "X"]
    return {"meta": {"dropped_events": other.get("dropped_events", 0)},
            "spans": spans, "counters": other.get("counters", {}),
            "gauges": other.get("gauges", {})}


def load_trace(path: str) -> dict:
    """Load either sink format (sniffs the first character)."""
    with open(path) as f:
        head = f.read(1)
    if head == "{":
        with open(path) as f:
            first = f.readline()
        try:
            rec = json.loads(first)
        except json.JSONDecodeError:
            rec = None
        if isinstance(rec, dict) and rec.get("type") == "meta":
            return read_jsonl(path)
        return read_chrome_trace(path)
    return read_jsonl(path)


def summarize(trace: dict, top: int = 30) -> str:
    """Plain-text report over a loaded trace: per-span-name aggregates
    (calls, total/mean/max ms) plus counters and gauges."""
    aggs: dict[str, dict] = {}
    for s in trace["spans"]:
        a = aggs.setdefault(s["name"],
                            {"count": 0, "total_us": 0.0, "max_us": 0.0})
        a["count"] += 1
        a["total_us"] += s["dur_us"]
        a["max_us"] = max(a["max_us"], s["dur_us"])
    lines = []
    lines.append(f"{'span':<32} {'calls':>8} {'total ms':>12} "
                 f"{'mean ms':>10} {'max ms':>10}")
    lines.append("-" * 76)
    ordered = sorted(aggs.items(), key=lambda kv: -kv[1]["total_us"])
    for name, a in ordered[:top]:
        lines.append(
            f"{name:<32} {a['count']:>8} {a['total_us'] / 1e3:>12.3f} "
            f"{a['total_us'] / 1e3 / a['count']:>10.4f} "
            f"{a['max_us'] / 1e3:>10.3f}")
    if len(ordered) > top:
        lines.append(f"... {len(ordered) - top} more span name(s)")
    if trace["counters"]:
        lines.append("")
        lines.append("counters:")
        for name, value in sorted(trace["counters"].items()):
            lines.append(f"  {name:<40} {value}")
    if trace["gauges"]:
        lines.append("")
        lines.append("gauges:")
        for name, value in sorted(trace["gauges"].items()):
            lines.append(f"  {name:<40} {value}")
    dropped = trace.get("meta", {}).get("dropped_events", 0)
    if dropped:
        lines.append(f"\nWARNING: {dropped} span(s) dropped "
                     "(tracer event cap hit)")
    return "\n".join(lines)


@contextlib.contextmanager
def trace_to(path: str | None, quiet: bool = False):
    """Enable telemetry for the body and export to ``path`` on exit.

    ``path=None`` is a transparent no-op (benchmarks pass their
    ``--trace`` argument straight through).  A pre-existing enabled
    state is preserved; a ``.jsonl`` suffix selects the JSONL sink,
    anything else the Chrome-trace sink.
    """
    if path is None:
        yield None
        return
    was_enabled = core.is_enabled()
    tracer = core.enable()
    try:
        yield tracer
    finally:
        writer = write_jsonl if path.endswith(".jsonl") \
            else write_chrome_trace
        out = writer(path, tracer)
        if not quiet:
            n = len(tracer.snapshot_events())
            print(f"[telemetry] wrote {n} span(s) -> {out}", flush=True)
        if not was_enabled:
            core.disable()
